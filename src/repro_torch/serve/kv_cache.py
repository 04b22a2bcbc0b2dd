"""KV-cache residency for continuous batching: slots behind an insert
connector (counterpart of ``repro/serve/kv_cache.py``).

The scheduler never touches cache tensors directly: it talks to a
:class:`KVConnectorBase`, shaped like vLLM's ``KVConnectorBase``.
``allocate`` / ``free`` manage slot residency and ``insert`` commits a
prefilled single-request cache into a slot. The JAX package's ``lookup``
prefix-reuse hook is left out until a connector serves prefixes.

:class:`SlotKVCache` is the default connector: one static super-batch cache
(``model.init_cache(n_slots, max_seq)``) and a free-list slot allocator.
The slot axis is the model's ``cache_batch_axis``, the same for every leaf
of its cache (axis 1 of the decoder's (L, B, W, K, hd) caches), where the
JAX package finds it by building two caches; ``insert`` writes the slot's
slice in place.
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


class SlotKVCache(KVConnectorBase):
    """Static super-batch KV residency: ``n_slots`` rows of
    ``model.init_cache(n_slots, max_seq, device=device)`` behind a free-list
    allocator."""

    def __init__(self, model, n_slots: int, max_seq: int, device="cuda"):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = int(n_slots)
        self.max_seq = int(max_seq)
        self.axis = int(model.cache_batch_axis)
        self.cache = model.init_cache(self.n_slots, self.max_seq,
                                      device=device)
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
        tree_map(lambda leaf, sub: leaf.narrow(self.axis, slot, 1).copy_(sub),
                 self.cache, subcache)

    def swap(self, cache) -> None:
        self.cache = cache
