"""Fault-tolerant checkpointing: atomic, async, device-agnostic
(counterpart of ``repro/checkpoint/manager.py``, on the same disk layout).

- Atomic: write to ``step_N.tmp`` then rename; a crash mid-save never
  corrupts the latest checkpoint.
- Async: ``save`` copies every leaf to the host (the only part the train
  loop waits for) and a background thread writes them; one save is in
  flight at most.
- Layout: ``arrays.npz`` (``a0``, ``a1``, ... in tree order) and
  ``meta.json`` with ``step``, ``names`` (the leaves' paths as the JAX
  package writes them: dict keys in sorted order, list / tuple indices,
  ``.field`` for a NamedTuple's) and ``extra``. numpy has no bfloat16, so
  a bf16 leaf is stored as its ``uint16`` bits, and ``meta.json`` also
  holds every leaf's torch dtype name under ``dtypes``. A directory the
  JAX manager wrote (no ``dtypes``) restores too.
- ``restore(step, like)`` puts each leaf on the device and in the dtype of
  ``like``'s leaf; a tree whose paths differ raises ``AssertionError``.
- Elastic, on a mesh (every rank calls): ``save(step, tree, extra,
  shardings)`` takes a tree of this rank's blocks and the tree of their
  ``parallel.sharding.NamedSharding``; each leaf is gathered whole and
  rank 0 writes it, so the directory is the unsharded layout above.
  ``restore(step, like, shardings)`` returns this rank's blocks under
  ``shardings``, whatever mesh wrote the checkpoint (or the JAX manager).
  ``wait`` then also waits for every rank.
- Retention: keeps the newest ``keep`` checkpoints.
- Robust restore: construction sweeps stale ``step_N.tmp`` debris, and
  ``restore`` skips directories whose ``meta.json`` is missing or
  unparsable or whose ``arrays.npz`` is missing, with a warning, falling
  back to the next-newest intact step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import warnings
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["CheckpointManager"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(path name, leaf)`` pairs in the JAX package's flattening order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], prefix + (str(k),))]
    if _is_namedtuple(tree):
        return [kv for f in tree._fields
                for kv in _flatten(getattr(tree, f), prefix + ("." + f,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _flatten(t, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}          # the caller's key order
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, leaves) for t in like)
    return next(leaves)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy (never a view of a tensor the train loop may update in
    place); bf16 as its uint16 bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype_name: Optional[str], like):
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()                     # keeps a 0-d leaf 0-d
    t = torch.from_numpy(a)
    if dtype_name == "bfloat16":
        t = t.view(torch.int16).view(torch.bfloat16)
    return t.to(device=like.device, dtype=like.dtype)


class _Box:
    """A leaf with its sharding, so that ``_flatten`` stops at it."""

    def __init__(self, leaf, sharding):
        self.leaf, self.sharding = leaf, sharding


def _with_shardings(tree, shardings):
    """``(name, leaf, sharding)`` in ``_flatten``'s order; ``shardings`` is
    a tree of ``tree``'s structure down to its leaves, or None."""
    if shardings is None:
        return [(n, x, None) for n, x in _flatten(tree)]
    from repro_torch.parallel.sharding import tree_map_like
    boxed = tree_map_like(_Box, tree, shardings)
    return [(n, b.leaf, b.sharding) for n, b in _flatten(boxed)]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None
        os.makedirs(directory, exist_ok=True)
        # a crash mid-save leaves step_N.tmp behind; the rename never
        # happened, so the debris is safe to sweep
        for d in os.listdir(directory):
            if d.startswith("step_") and d.endswith(".tmp"):
                warnings.warn(f"checkpoint: sweeping stale partial save "
                              f"{d} (crash mid-save)")
                shutil.rmtree(os.path.join(directory, d),
                              ignore_errors=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             shardings: Any = None):
        """Write ``tree`` as step ``step`` (async unless the manager was
        made with ``async_save=False``). On a mesh ``tree`` holds this
        rank's blocks and ``shardings`` their ``NamedSharding``s: every
        rank calls, each leaf is gathered, rank 0 writes."""
        self.wait()                                   # one in-flight save max
        flat = _with_shardings(tree, shardings)
        names = [n for n, _, _ in flat]
        dtypes = [str(x.dtype).replace("torch.", "") for _, x, _ in flat]
        host = []
        writer = True
        for _, x, sh in flat:
            if sh is not None:
                from repro_torch.parallel.sharding import gather_leaf
                self._mesh = sh.mesh
                writer = sh.mesh.rank == 0
                x = gather_leaf(x, sh.spec, sh.mesh)
            if writer:
                host.append(_to_host(x))
            del x
        if not writer:
            return

        def write():
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"a{i}": a for i, a in enumerate(host)})
            meta = {"step": step, "names": names, "dtypes": dtypes,
                    "extra": extra or {}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if self.async_save:
            def guarded():
                try:
                    write()
                except BaseException as e:     # surfaced by wait()
                    self._error = e
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            write()

    def wait(self):
        """Block until the save in flight is written; re-raise its error.
        After a save on a mesh, every rank waits here for rank 0's."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None:
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _load_step(self, step: int):
        """Open one checkpoint dir; ``None`` if it is corrupt (missing or
        unparsable ``meta.json``, missing ``arrays.npz``)."""
        path = os.path.join(self.dir, f"step_{step}")
        try:
            with open(os.path.join(path, "meta.json")) as f:
                meta = json.load(f)
            data = np.load(os.path.join(path, "arrays.npz"))
        except (OSError, ValueError, json.JSONDecodeError):
            return None
        return meta, data

    def restore(self, step: int, like: Any, shardings: Any = None):
        """Restore into the structure of ``like``, each leaf on the device
        and in the dtype of ``like``'s. Returns ``(tree, extra)``. With
        ``shardings`` (a tree of ``NamedSharding`` of ``like``'s structure)
        each leaf is this rank's block of the saved one: the elastic
        reshard onto whatever mesh the shardings name.

        A corrupt checkpoint dir at ``step`` is skipped with a warning and
        the next-newest intact step restores instead;
        ``FileNotFoundError`` only when no intact checkpoint survives."""
        candidates = [step] + [s for s in reversed(self.all_steps())
                               if s < step]
        loaded = None
        for s in candidates:
            loaded = self._load_step(s)
            if loaded is not None:
                if s != step:
                    warnings.warn(
                        f"checkpoint: step_{step} is corrupt "
                        "(missing/unparsable meta.json or arrays.npz); "
                        f"falling back to intact step_{s}")
                break
            warnings.warn(f"checkpoint: skipping corrupt step_{s}")
        if loaded is None:
            raise FileNotFoundError(
                f"no intact checkpoint at or below step {step} in "
                f"{self.dir}")
        meta, data = loaded
        flat = _with_shardings(like, shardings)
        if [n for n, _, _ in flat] != meta["names"]:
            raise AssertionError("checkpoint tree does not match target tree")
        dtypes = meta.get("dtypes", [None] * len(flat))
        out = []
        for i, (_, leaf, sh) in enumerate(flat):
            a = data[f"a{i}"]
            if sh is not None:
                from repro_torch.parallel.sharding import block_slices
                if a.ndim:
                    a = a[block_slices(a.shape, sh.spec, sh.mesh)]
            out.append(_from_host(a, dtypes[i], leaf))
        return _unflatten(like, iter(out)), meta["extra"]
