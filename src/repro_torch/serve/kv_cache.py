"""KV-cache residency for continuous batching: slots behind an insert
connector (counterpart of ``repro/serve/kv_cache.py``).

The scheduler never touches cache tensors directly: it talks to a
:class:`KVConnectorBase`, shaped like vLLM's ``KVConnectorBase``.
``allocate`` / ``free`` manage slot residency and ``insert`` commits a
prefilled single-request cache into a slot. The JAX package's ``lookup``
prefix-reuse hook is left out until a connector serves prefixes.

:class:`SlotKVCache` is the default connector: one static super-batch cache
(``model.init_cache(n_slots, max_seq)``) and a free-list slot allocator.
The slot axis of every leaf is found from the structure, as the JAX package
finds it: the cache is built at two widths on the ``meta`` device, which
allocates nothing, and the one dimension that differs is the leaf's slot
axis. So attention caches (L, B, W, K, hd), the Mamba2 states, the xLSTM
states with their batch on axis 2 and the hybrid caches all insert without
code of their own; ``insert`` writes the slot's slice in place.
"""
from __future__ import annotations

from typing import Any, List, Optional

from repro_torch import obs
from repro_torch.core.butterfly import tree_map


class KVConnectorBase:
    """Residency interface between the scheduler and KV storage: the
    scheduler asks for a slot, inserts a prefilled cache, and frees the slot
    on retirement."""

    #: the live super-batch cache the decode step threads through
    cache: Any

    def allocate(self) -> Optional[int]:
        """Claim a free slot id, or ``None`` when the batch is full."""
        raise NotImplementedError

    def free(self, slot: int) -> None:
        """Return a slot to the free list (called on retirement)."""
        raise NotImplementedError

    def insert(self, slot: int, subcache) -> None:
        """Commit a single-request cache (batch-1 leaves) into ``slot``."""
        raise NotImplementedError

    def swap(self, cache) -> None:
        """Adopt the cache returned by a decode step."""
        raise NotImplementedError


def _batch_axes(build):
    """The slot axis of every leaf, a tree of ints: the one dimension in
    which ``build(2)`` and ``build(3)``, built on ``meta``, differ."""
    def one(a, b):
        diff = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if len(diff) != 1:
            raise ValueError(
                f"cache leaf {tuple(a.shape)} vs {tuple(b.shape)}: expected "
                f"exactly one batch-dependent dimension, found {len(diff)}")
        return diff[0]

    return tree_map(one, build(2, "meta"), build(3, "meta"))


class SlotKVCache(KVConnectorBase):
    """Static super-batch KV residency: ``n_slots`` rows of
    ``model.init_cache(n_slots, max_seq, device=device)`` behind a free-list
    allocator."""

    def __init__(self, model, n_slots: int, max_seq: int, device="cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        build = lambda b, dev: model.init_cache(b, self.max_seq, device=dev)
        self.axes = _batch_axes(build)
        self.cache = build(self.n_slots, device)
        self._free: List[int] = list(range(self.n_slots))

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def live_slots(self) -> int:
        return self.n_slots - len(self._free)

    def allocate(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop(0)
        obs.gauge("serve.kv_free", len(self._free))
        return slot

    def free(self, slot: int) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} outside [0, {self.n_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} double-freed")
        self._free.append(slot)
        self._free.sort()            # prefer low slots: stable, debuggable
        obs.gauge("serve.kv_free", len(self._free))

    def insert(self, slot: int, subcache) -> None:
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} outside [0, {self.n_slots})")
        tree_map(lambda leaf, sub, ax: leaf.narrow(ax, slot, 1).copy_(sub),
                 self.cache, subcache, self.axes)

    def swap(self, cache) -> None:
        self.cache = cache
