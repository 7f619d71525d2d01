"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` into ONE
shared library with a plain C interface, loaded with :mod:`ctypes`.  The
build runs at first use (never at import time: the CPU tests import every
module) into ``build/vanerf_tpu_torch/`` at the repository root, keyed on
a hash of the sources and flags, so a fresh checkout builds once and
reuses the library afterwards.  A build or load failure raises; nothing
falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[2] / "build"
             / "vanerf_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of the entry points (all return cudaGetLastError() as int)
_SIGNATURES = {
    "vt_knn": [_P, _I, _P, _I, _P, _P, _P],
    "vt_raster": [_P, _I, _I, _I, _P, _P, _P],
    "vt_mesh_query": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "vt_interp": [_P, _I, _I, _I, _P, _I, _P, _P],
    "vt_onehot_scatter": [_P, _P, _I, _I, _I, _P, _P, _L, _P, _L, _P],
}

_lib = None
_lock = threading.Lock()


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = pathlib.Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvanerf_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> pathlib.Path:
    """Compile the library if it is not built yet; return its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ([_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
           + ["-I", str(CSRC), "-o", tmp]
           + [str(s) for s in _sources() if s.suffix == ".cu"])
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, shape=None, device=None) -> None:
    """Wrapper-side argument checks for a kernel launch."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
