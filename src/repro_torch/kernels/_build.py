"""Build, load and launch the port's CUDA kernels.

The sources in ``repro_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface and loaded with
``ctypes``. The build runs at the first launch, never at import, into
``build/repro_torch/<hash>/`` under the repository root; the hash covers the
sources and the flags, so an edited source rebuilds. Each ``.cu`` compiles
in its own ``nvcc`` process, all started together.

Every wrapper launches through :func:`launch`, which adds one to the
wrapper's count in :data:`LAUNCHES` and raises :class:`KernelError` when the
C function returns a CUDA error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: launches per wrapper name, counted where each wrapper launches its kernel
LAUNCHES: Dict[str, int] = {}

DTYPE_CODES = {torch.int32: 0, torch.float32: 1}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    "flims_bitonic_rows": (_I, [_I, _I, _I, _P, _P, _P, _P, _I, _I, _P]),
    "flims_bitonic_rows_smem": (_LL, [_I, _I, _I, _I]),
    "flims_bitonic_rows_occupancy": (_I, [_I, _I, _I, _I]),
    "flims_merge_blocks": (_I, [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                                _I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                _I, _P]),
    "flims_merge_blocks_occupancy": (_I, [_I, _I, _I, _I]),
    "flims_merge_tree": (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _P, _P, _LL, _P, _I,
                              _P]),
    "flims_merge_tree_smem": (_LL, [_I, _I, _I, _I, _I]),
    "flims_merge_tree_occupancy": (_I, [_I, _I, _I, _I, _I]),
    "flims_segment_sort": (_I, [_I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _P,
                                _P, _P]),
    "flims_lane_merge": (_I, [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _I, _P, _LL, _P, _P, _P]),
    "flims_lane_merge_occupancy": (_I, [_I, _I, _I, _I]),
    "flims_moe_route": (_I, [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P, _P]),
    "flims_stream_merge": (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _LL, _LL, _I,
                                _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _I,
                                _P]),
    "flims_stream_merge_smem": (_LL, [_I, _I, _I, _I, _I]),
    "flims_stream_merge_occupancy": (_I, [_I, _I, _I, _I, _I]),
    "flims_wide_tree": (_I, [_I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _P, _P,
                             _I, _I, _I, _I, _I, _P, _P, _P, _LL, _P, _I, _P,
                             _P, _P]),
    "flims_wide_tree_scratch": (_LL, [_I, _I, _I, _I]),
    "flims_wide_tree_occupancy": (_I, [_I, _I, _I, _I, _I]),
    "flims_lane_wide": (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                             _P, _I, _I, _P, _I, _P, _P, _P]),
    "flims_lane_wide_scratch": (_LL, [_I, _I]),
}

_lib: Optional[ctypes.CDLL] = None


class KernelError(RuntimeError):
    """A CUDA kernel failed to build, or a launch returned a CUDA error."""


def reset_launches() -> None:
    LAUNCHES.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + \
            [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise KernelError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (if this source hash has not been built) and
    return the shared library's path."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / "libflims.so"
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu, _ = _sources()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        t0 = time.perf_counter()
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            log = tempfile.TemporaryFile("w+", dir=tmp)
            procs.append((src, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, text=True)))
        # each source's seconds: the build is as slow as its slowest
        secs = {}
        while len(secs) < len(procs):
            for src, _, _, p in procs:
                if src.name not in secs and p.poll() is not None:
                    secs[src.name] = time.perf_counter() - t0
            time.sleep(0.05)
        logs, failed = [], []
        for src, _, log, p in procs:
            log.seek(0)
            logs.append(f"== {src.name} ({secs[src.name]:.1f} s)\n"
                        f"{log.read()}")
            log.close()
            if p.returncode:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(logs))
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / "libflims.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib)] + [str(o) for _, o, _, _
                                                     in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise KernelError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at the first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (res, args) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
    return _lib


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def narrow_keys(out: tuple, dt: torch.dtype) -> tuple:
    """``out`` with its first entry, the keys, narrowed back to ``dt``."""
    return (narrow(out[0], dt),) + tuple(out[1:])


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype :func:`widen` gives keys of ``dtype``."""
    if dtype in (torch.float16, torch.bfloat16):
        return torch.float32
    return torch.int32 if dtype in _NARROW_INT else dtype


def dtype_code(op: str, dtype: torch.dtype) -> int:
    """The kernels' code of ``dtype``'s widened keys; 64-bit keys raise."""
    dtype = wide_dtype(dtype)
    if dtype not in DTYPE_CODES:
        raise KernelError(f"{op}: the CUDA kernels take keys of at most 32 "
                          f"bits, got {dtype}")
    return DTYPE_CODES[dtype]


#: narrow integer keys, each with its signed view and its bit width
_NARROW_INT = {torch.int8: (torch.int8, 8), torch.uint8: (torch.int8, 8),
               torch.int16: (torch.int16, 16),
               torch.uint16: (torch.int16, 16), torch.uint32: (torch.int32, 32)}
#: every key dtype the kernels take, through :func:`widen`
KEY_DTYPES = (torch.int32, torch.float32, torch.float16, torch.bfloat16,
              *_NARROW_INT)


def widen(x: torch.Tensor) -> torch.Tensor:
    """Keys of a dtype of at most 32 bits as the int32 or float32 keys the
    kernels take, in the same order, bit for bit reversible by
    :func:`narrow`. int32 and float32 pass as they are (no copy).

    - Integers: a monotone map onto int32 that sends the dtype's min and max
      to int32's (unsigned keys first have their top bit flipped, which
      orders them as signed): ``v << s``, with the low ``s = 32 - bits``
      bits set where ``v >= 0``. So the kernels' int32 sentinels and bounds
      narrow back to the dtype's own.
    - bfloat16: its bits ``<< 16``, the float32 of the same value.
    - float16: the float32 of the same value, built from the bits where the
      key is a NaN (its sign and payload, the quiet bit untouched), so no
      value conversion quiets a signalling NaN.
    Float keys stay floats: +0 and -0 still tie and NaNs stay NaNs, so
    XLA's max / min and the selectors see what they see at 32 bits."""
    dt = x.dtype
    if dt in (torch.int32, torch.float32) or dt not in KEY_DTYPES:
        return x
    if dt == torch.bfloat16:
        return (x.view(torch.int16).to(torch.int32) << 16).view(
            torch.float32)
    if dt == torch.float16:
        b = x.view(torch.int16).to(torch.int32)
        nan_bits = ((b & 0x8000) << 16) | 0x7F800000 | ((b & 0x3FF) << 13)
        return torch.where(torch.isnan(x), nan_bits.view(torch.float32),
                           x.to(torch.float32))
    signed, n = _NARROW_INT[dt]
    v = x.view(signed)
    if dt != signed:                     # unsigned: flip the top bit
        v = v ^ torch.iinfo(signed).min
    if n == 32:
        return v
    s = 32 - n
    v = v.to(torch.int32)
    return (v << s) | torch.where(v >= 0, (1 << s) - 1, 0).to(torch.int32)


def narrow(y: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """The inverse of :func:`widen` for keys of dtype ``dt``. A bfloat16
    NaN comes back as the quiet NaN of its sign (``0x7fc0`` / ``0xffc0``),
    as XLA's bfloat16 arithmetic leaves every NaN it passes through (XLA
    computes bfloat16 in float32 and rounds back); every other key comes
    back bit for bit."""
    if y.dtype == dt or dt not in KEY_DTYPES:
        return y
    if dt == torch.bfloat16:
        b = y.view(torch.int32) >> 16
        b = torch.where(torch.isnan(y), (b & -0x8000) | 0x7FC0, b)
        return b.to(torch.int16).view(torch.bfloat16)
    if dt == torch.float16:
        b = y.view(torch.int32)
        nan_bits = (((b >> 16) & -0x8000) | 0x7C00 | ((b >> 13) & 0x3FF))
        return torch.where(torch.isnan(y),
                           nan_bits.to(torch.int16).view(torch.float16),
                           y.to(torch.float16))
    signed, n = _NARROW_INT[dt]
    v = y if n == 32 else (y >> (32 - n)).to(signed)
    if dt != signed:
        v = v ^ torch.iinfo(signed).min
    return v.view(dt)


def check_cuda(op: str, *tensors: Optional[torch.Tensor]) -> None:
    """Device and contiguity checks before pointers go to a kernel."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if not t.is_cuda:
            raise KernelError(f"{op}: expected CUDA tensors, got {t.device}")
        if not t.is_contiguous():
            raise KernelError(f"{op}: expected contiguous tensors")
        if dev is not None and t.device != dev:
            raise KernelError(f"{op}: tensors on {dev} and {t.device}")
        dev = t.device


def launch(name: str, fn_name: str, *args) -> None:
    """Call one C entry point, count the launch, raise on a CUDA error."""
    rc = getattr(library(), fn_name)(*args)
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1
    if rc != 0:
        raise KernelError(f"{name}: {fn_name} returned CUDA error {rc}")
