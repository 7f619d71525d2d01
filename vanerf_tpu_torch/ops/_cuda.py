"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc -c`` per source, all started together, then one link) into ONE
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
# -fmad=false: kernels A-D, 5-8 and 14 equal their plain versions bit for bit
# only if every product and sum rounds on its own; the fused MLP kernels,
# which cannot be bit-equal, call fmaf explicitly instead of taking other
# flags.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
# C signatures of the entry points (all return cudaGetLastError() as int)
# (kernels B / 8, A / 7, D and 10 take a batch: element counts B and the
# stacked vertex sets / meshes / maps / tables Bm that element e reads at
# e % Bm)
_SIGNATURES = {
    "vt_knn": [_P, _I, _I, _P, _I, _I, _P, _P, _P],
    "vt_knn_T": [_P, _I, _I, _P, _I, _I, _P, _P, _P],
    "vt_knn_culled": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    "vt_knn_T_culled": [_P, _I, _P, _I, _P, _I, _P, _P, _P, _P],
    "vt_knn_chunk_boxes": [_P, _I, _P, _I, _P],
    "vt_raster": [_P, _I, _I, _I, _P, _P, _P],
    "vt_empty": [_P],
    "vt_mesh_query": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "vt_mesh_query_T": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
    "vt_mesh_query_culled": [_P, _I, _I, _P, _P, _I, _I, _L, _P, _I, _P,
                             _F, _IP, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                             _P],
    "vt_mesh_query_culled_T": [_P, _I, _I, _P, _P, _I, _I, _L, _P, _I, _P,
                               _F, _IP, _I, _I, _I, _P, _P, _P, _P, _P, _P,
                               _P],
    "vt_mesh_query_brute": [_P, _I, _P, _I, _I, _P, _P, _P, _P],
    "vt_mesh_query_vis_brute": [_P, _I, _P, _I, _I, _P, _P, _P, _P, _P],
    "vt_interp": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P],
    "vt_bilinear": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P],
    "vt_onehot_scatter": [_P, _P, _I, _I, _I, _P, _P, _L, _P, _L, _P],
    "vt_row_gather": [_P, _I, _I, _I, _P, _I, _I, _P, _P],
    "vt_fused_geo_mlp": [_P, _P, _P, _P, _L, _P, _I, _I, _I, _F, _F, _IP,
                         _P, _P, _P],
    "vt_fused_query_mlp": [_P, _P, _P, _P, _P, _L, _P, _I, _I, _I, _F, _F,
                           _IP, _P, _P],
}
# the bfloat16 instantiations of kernels D, 10, 12, 11, 13 and 14 take the
# arguments of their float32 entry points (bfloat16 data behind the
# pointers; the weight stream's length in elements; kernel 13's float32
# workspace)
_SIGNATURES.update({name + "_bf16": _SIGNATURES[name] for name in (
    "vt_interp", "vt_row_gather", "vt_fused_geo_mlp", "vt_fused_query_mlp",
    "vt_onehot_scatter", "vt_bilinear")})
# kernels 12 / 11's bfloat16 body for any width (csrc/fused_mlp.cu, BF =
# true): the arguments of the float32 entry points
_SIGNATURES.update({name + "_bf16_mma": _SIGNATURES[name] for name in (
    "vt_fused_geo_mlp", "vt_fused_query_mlp")})
# kernels 11 / 12's bfloat16 activations on every input, and their
# occupancy (shared bytes, blocks an SM, threads) at K keypoints
_SIGNATURES.update({"vt_fm_act_bf16_all": [_I, _P, _P],
                    "vt_fused_mlp_bf16_occupancy": [_I, _I, _IP]})

_lib = None
_lock = threading.Lock()
# nvcc's output of the last build made in this process (with verbose=True:
# ptxas' registers, shared memory and spills per function), else ""
build_log = ""


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
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        procs = []
        for src in _sources():
            if src.suffix != ".cu":
                continue
            obj = os.path.join(work, src.stem + ".o")
            cmd = ([nvcc] + NVCC_FLAGS + extra
                   + ["-I", str(CSRC), "-c", str(src), "-o", obj])
            procs.append((obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], False
        for _obj, proc in procs:        # every compile runs to its end
            logs.append(proc.communicate()[0])
            failed |= proc.returncode != 0
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        link = subprocess.run(
            [nvcc, "-shared", "-o", tmp] + [obj for obj, _ in procs],
            capture_output=True, text=True)
        if link.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
    build_log = "\n".join(logs)
    if verbose:
        print(build_log)
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


def dtype_suffix(dtype, name: str) -> str:
    """The entry-point suffix of the instantiation of a kernel built for
    ``dtype``: "" for float32, "_bf16" for bfloat16 (kernels D, 10, 11, 12,
    13 and 14 have both); any other dtype has no kernel and raises, so nothing
    is cast to reach one."""
    import torch
    suffix = {torch.float32: "", torch.bfloat16: "_bf16"}.get(dtype)
    if suffix is None:
        raise ValueError(f"{name}: no kernel for {dtype} (float32 or "
                         "bfloat16)")
    return suffix


def batch_index(B: int, Bm: int, device=None):
    """(B,) long: the stacked set (vertex set, mesh, map or table) that each
    of B batch elements reads, e % Bm, as the batched kernels read it."""
    import torch
    return torch.arange(B, device=device) % Bm


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
