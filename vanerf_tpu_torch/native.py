"""ctypes bindings for the native CPU geometry library, port of
``vanerf_tpu/native.py``.

Used by the offline preprocessor and as a fast independent oracle in tests.
The library is compiled lazily on first use from ``native/vanerf_geom.cpp``
(``g++ -O3 -fPIC -shared -std=c++17``) into ``build/vanerf_tpu_torch/`` at
the repository root, keyed on a hash of the source: the tracked
``native/libvanerf_geom.so`` is neither read nor written.  This is a CPU
helper, not a kernel: every caller must handle ``available() == False``
(no compiler, or a build that failed).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SOURCE = ROOT / "native" / "vanerf_geom.cpp"
BUILD_DIR = ROOT / "build" / "vanerf_tpu_torch"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_LIB: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvanerf_geom_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library if it is not built yet; return its path.  A
    failed compile raises ``RuntimeError``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [os.environ.get("CXX", "g++")] + CXX_FLAGS
            + ["-o", tmp, str(SOURCE)], capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"no C++ compiler: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _LIB
    with _lock:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError):
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.point_mesh_query.argtypes = [
            f32p, ctypes.c_int64, f32p, ctypes.c_int64, f32p, i32p, f32p]
        lib.point_mesh_query.restype = None
        lib.rasterize.argtypes = [
            f32p, f32p, ctypes.c_int64, i32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, i32p, f32p, f32p]
        lib.rasterize.restype = None
        _LIB = lib
        return lib


def available() -> bool:
    return _load() is not None


def _fp(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _require_lib() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable (see "
                           "vanerf_tpu_torch.native.build)")
    return lib


def point_mesh_query_native(points: np.ndarray, triangles: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(N,3) points x (F,3,3) triangles -> (d2, face_idx, winding)."""
    lib = _require_lib()
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    tri = np.ascontiguousarray(triangles, np.float32).reshape(-1, 9)
    n, f = len(pts), len(tri)
    d2 = np.empty(n, np.float32)
    idx = np.empty(n, np.int32)
    wind = np.empty(n, np.float32)
    lib.point_mesh_query(_fp(pts), n, _fp(tri), f, _fp(d2), _ip(idx),
                         _fp(wind))
    return d2, idx, wind


def rasterize_native(verts_xy: np.ndarray, verts_z: np.ndarray,
                     faces: np.ndarray, H: int, W: int):
    """Z-buffer rasterization -> (pix_to_face (H*W,), bary (H*W,3),
    zbuf (H*W,))."""
    lib = _require_lib()
    vxy = np.ascontiguousarray(verts_xy, np.float32).reshape(-1, 2)
    vz = np.ascontiguousarray(verts_z, np.float32).reshape(-1)
    fc = np.ascontiguousarray(faces, np.int32).reshape(-1, 3)
    if len(vz) != len(vxy):
        raise ValueError(f"{len(vxy)} vertex positions, {len(vz)} depths")
    if len(fc) and (fc.min() < 0 or fc.max() >= len(vxy)):
        raise ValueError("face index out of range")
    n_pix = H * W
    face = np.empty(n_pix, np.int32)
    z = np.empty(n_pix, np.float32)
    bary = np.empty((n_pix, 3), np.float32)
    lib.rasterize(_fp(vxy), _fp(vz), len(vxy), _ip(fc), len(fc),
                  H, W, _ip(face), _fp(z), _fp(bary))
    return face, bary, z
