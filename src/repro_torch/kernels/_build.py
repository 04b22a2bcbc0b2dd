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
                              _I, _I, _I, _I, _I, _P]),
    "flims_merge_tree_smem": (_LL, [_I, _I, _I, _I, _I]),
    "flims_merge_tree_occupancy": (_I, [_I, _I, _I, _I, _I]),
    "flims_segment_sort": (_I, [_I, _I, _I, _P, _P, _P, _P, _I, _I, _P]),
    "flims_lane_merge": (_I, [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _I, _I, _I, _P, _LL, _P, _P, _P]),
    "flims_lane_merge_occupancy": (_I, [_I, _I, _I, _I]),
    "flims_moe_route": (_I, [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P, _P]),
    "flims_stream_merge": (_I, [_I, _I, _I, _I, _P, _P, _P, _P, _LL, _LL, _I,
                                _I, _I, _I, _I, _I, _P]),
    "flims_stream_merge_smem": (_LL, [_I, _I, _I, _I, _I]),
    "flims_stream_merge_occupancy": (_I, [_I, _I, _I, _I, _I]),
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
        for src in cu:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, p in procs:
            out, _ = p.communicate()
            logs.append(f"== {src.name}\n{out}")
            if p.returncode:
                failed.append(src.name)
        (out_dir / "build.log").write_text("\n".join(logs))
        if failed:
            raise KernelError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / "libflims.so"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_lib)] + [str(o) for _, o, _ in
                                                     procs],
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


def dtype_code(op: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise KernelError(f"{op}: the CUDA kernel takes int32 or float32 "
                          f"keys, got {dtype}")
    return DTYPE_CODES[dtype]


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
