"""K1: bitonic sort of fixed-width chunks (paper §8.2's sort-in-chunks).

Counterpart of ``repro/kernels/bitonic_sort.py``. Every row of an (m, c)
tile, c a power of two, goes through the full static bitonic network:
key-only rows descending with XLA's max/min, (key, rank) rows by the
compound order in either direction. ``sort_chunks`` / ``sort_chunks_kv``
launch ``csrc/bitonic_sort.cu`` for a CUDA tensor and run the plain version
(the same network, vectorised over rows) for a CPU tensor.
``sort_chunks_plain`` / ``sort_chunks_kv_plain`` run the plain version on any
device (how ``chip_smoke.py`` holds the kernel against it).

The CUDA kernel runs the same network in registers: a warp holds 256 keys
(8 a thread), rows up to 256 wide sort within one warp with shuffles and
no barrier, wider rows span a CTA and take their stages at d >= 256
through shared memory (:func:`rows_smem`, :func:`resident_ctas`). Rows
wider than ``ROW_TILE`` sort in tiles of ``ROW_TILE`` keys a CTA, with the
network's stages at d >= ``ROW_TILE`` as passes over device memory: the
same network, so any power-of-two width runs, as in the JAX kernel.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.flims_merge import xla_max, xla_min

#: rows up to this width sort a row a CTA (1024 threads of 16 keys); wider
#: rows in tiles of it, their wider stages over device memory
ROW_TILE = 16384


def _stage_masks(c: int, k: int, d: int, device):
    first = torch.arange(c, device=device).reshape(c // (2 * d), 2, d)[:, 0, :]
    return (first // k) % 2 == 1                 # odd k-blocks ascend


def _bitonic_rows_desc(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of (m, c) descending with the static network."""
    m, c = x.shape
    k = 2
    while k <= c:
        d = k // 2
        while d >= 1:
            y = x.reshape(m, c // (2 * d), 2, d)
            top, bot = y[:, :, 0, :], y[:, :, 1, :]
            asc = _stage_masks(c, k, d, x.device)
            mx, mn = xla_max(top, bot), xla_min(top, bot)
            x = torch.stack([torch.where(asc, mn, mx),
                             torch.where(asc, mx, mn)], dim=2).reshape(m, c)
            d //= 2
        k *= 2
    return x


def _bitonic_rows_kv(k: torch.Tensor, r: torch.Tensor,
                     descending: bool = True):
    """Stable row sort of (key, rank) pairs: (key desc-or-asc, rank asc)."""
    m, c = k.shape
    kk = 2
    while kk <= c:
        d = kk // 2
        while d >= 1:
            ks = k.reshape(m, c // (2 * d), 2, d)
            rs = r.reshape(m, c // (2 * d), 2, d)
            kt, kb = ks[:, :, 0, :], ks[:, :, 1, :]
            rt, rb = rs[:, :, 0, :], rs[:, :, 1, :]
            asc = _stage_masks(c, kk, d, k.device)
            key_first = (kt > kb) if descending else (kt < kb)
            keep = (key_first | ((kt == kb) & (rt < rb))) ^ asc
            k = torch.stack([torch.where(keep, kt, kb),
                             torch.where(keep, kb, kt)], dim=2).reshape(m, c)
            r = torch.stack([torch.where(keep, rt, rb),
                             torch.where(keep, rb, rt)], dim=2).reshape(m, c)
            d //= 2
        kk *= 2
    return k, r


def _check(name: str, x: torch.Tensor) -> None:
    if x.ndim != 2:
        raise ValueError(f"{name}: expected an (m, c) tile, got {x.shape}")
    c = x.shape[1]
    if c & (c - 1) or c == 0:
        raise ValueError(f"{name}: chunk width must be a power of two")


def _launch(name, k, r, descending):
    m, c = k.shape
    _build.check_cuda(name, k, r)
    code = _build.dtype_code(name, k.dtype)
    ok = torch.empty_like(k)
    orr = None if r is None else torch.empty_like(r)
    P = _build.ptr
    _build.launch(name, "flims_bitonic_rows", code, int(r is not None),
                  int(descending), P(k), P(r), P(ok), P(orr), m, c,
                  _build.stream(k.device))
    return ok, orr


def rows_smem(dtype, kv: bool, descending: bool, c: int) -> int:
    """Shared-memory bytes of one CTA of the CUDA kernel for rows of ``c``
    keys, read from the compiled kernel on the card: 0 up to c = 256, the
    row (4 bytes a key, 8 with ranks) above, the ``ROW_TILE`` tile past
    it."""
    code = _build.dtype_code("sort_chunks", dtype)
    nbytes = _build.library().flims_bitonic_rows_smem(
        code, int(kv), int(descending), c)
    if nbytes < 0:
        raise _build.KernelError(
            f"sort_chunks: footprint query failed ({nbytes}) at c={c}")
    return nbytes


def resident_ctas(dtype, kv: bool, descending: bool, c: int,
                  device) -> int:
    """CTAs the card holds at once for rows of ``c`` keys: SMs times the
    kernel's occupancy query."""
    code = _build.dtype_code("sort_chunks", dtype)
    per_sm = _build.library().flims_bitonic_rows_occupancy(
        code, int(kv), int(descending), c)
    if per_sm <= 0:
        raise _build.KernelError(
            f"sort_chunks: occupancy query failed ({per_sm}) at c={c}")
    return per_sm * torch.cuda.get_device_properties(
        device).multi_processor_count


def _sort_chunks(x, cuda: bool):
    _check("sort_chunks", x)
    if x.shape[0] == 0:
        return x.clone()
    dt, x = x.dtype, _build.widen(x)
    out = _launch("sort_chunks", x, None, True)[0] if cuda \
        else _bitonic_rows_desc(x)
    return _build.narrow(out, dt)


def _sort_chunks_kv(k, r, descending: bool, cuda: bool):
    _check("sort_chunks_kv", k)
    if r.shape != k.shape or r.dtype != torch.int32:
        raise ValueError("sort_chunks_kv: int32 ranks shaped like the keys")
    if k.shape[0] == 0:
        return k.clone(), r.clone()
    dt, k = k.dtype, _build.widen(k)
    out = _launch("sort_chunks_kv", k, r, descending) if cuda \
        else _bitonic_rows_kv(k, r, descending)
    return _build.narrow_keys(out, dt)


@obs.scoped("kernels.sort_chunks")
def sort_chunks(x: torch.Tensor) -> torch.Tensor:
    """Sort each row of an (m, c) tensor descending (counterpart of
    ``sort_chunks_pallas``)."""
    return _sort_chunks(x, x.is_cuda)


def sort_chunks_plain(x: torch.Tensor) -> torch.Tensor:
    """``sort_chunks``' plain version, on any device."""
    return _sort_chunks(x, False)


@obs.scoped("kernels.sort_chunks_kv")
def sort_chunks_kv(k: torch.Tensor, r: torch.Tensor, *,
                   descending: bool = True):
    """Stable row-wise sort of (key, int32 rank) rows (counterpart of
    ``sort_chunks_kv_pallas``). Returns ``(keys, ranks)``."""
    return _sort_chunks_kv(k, r, descending, k.is_cuda)


def sort_chunks_kv_plain(k: torch.Tensor, r: torch.Tensor, *,
                         descending: bool = True):
    """``sort_chunks_kv``' plain version, on any device."""
    return _sort_chunks_kv(k, r, descending, False)
