"""Kernel wrappers of the port: device dispatch, launch counters, the
package's import boundary, and (on a CUDA machine) each CUDA kernel
against its plain-PyTorch twin.

On the CPU every wrapper takes its plain twin and its launch counter stays
0.  The tests marked ``cuda`` build the kernels with nvcc and run them on
the card; they skip where there is no CUDA device.  They need neither
jax nor the JAX package; run them on a GPU machine with
``python -m pytest tests/test_torch_kernels.py -m cuda --noconftest``
(``tests/conftest.py`` imports jax).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as h
from vanerf_tpu_torch import ops
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.data.synthetic import two_hand_mesh
from vanerf_tpu_torch.ops import (interp_mxu, knn, mesh_query, onehot_gather,
                                  rasterize)


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_package_imports_no_jax():
    """Every vanerf_tpu_torch module imports without jax, flax, yaml or
    vanerf_tpu (the machine with the card has none of them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vanerf_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'yaml', 'vanerf_tpu')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = h.ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=h.ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 18


def test_cpu_tensors_take_the_plain_path():
    """A CPU render runs every kernel's plain twin: no counter moves and
    nothing is built."""
    ops.reset_launches()
    out = tr.render_patch(h.port_model(), h.torch_batch(
        h.synthetic_batch()[0]), grids=T(h.center_grid()), out_h=4, out_w=4,
        sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)
    assert torch.isfinite(out["tex_fg_fine"]).all()
    assert ops.launch_counts() == {"mesh_query": 0, "knn": 0,
                                   "rasterize": 0, "interp_mxu": 0,
                                   "onehot_scatter": 0}


def test_kernel_library_is_keyed_on_sources():
    from vanerf_tpu_torch.ops import _cuda
    path = _cuda.library_path()
    assert path.parent == _cuda.BUILD_DIR
    assert path.name.startswith("libvanerf_kernels_")
    srcs = {p.name for p in _cuda._sources()}
    assert {"knn.cu", "rasterize.cu", "mesh_query.cu", "interp.cu",
            "onehot_scatter.cu", "common.cuh"} <= srcs
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain twin on the same CUDA inputs
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_knn_kernel_matches_plain(cuda):
    q = T(h.two_hand_points(4096, seed=1)).to(cuda)
    v = T(two_hand_mesh(0, 2)[0]).to(cuda)
    n0 = knn.launches
    idx, d2 = knn.nearest_vertex_d2(q, v)
    torch.cuda.synchronize()
    assert knn.launches == n0 + 1
    idx_p, d2_p = knn.nearest_vertex_d2_plain(q, v)
    assert torch.equal(d2, d2_p)
    assert torch.equal(idx, idx_p)


@pytest.mark.cuda
def test_raster_kernel_matches_plain(cuda):
    verts, faces, _ = two_hand_mesh(0, 2)
    xy = T(np.random.RandomState(2).rand(len(verts), 2)
           .astype(np.float32) * 63).to(cuda)
    z = T(verts[:, 2].copy()).to(cuda)
    tri = rasterize._packed_faces(xy, z, T(faces).to(cuda))
    face, zbuf = rasterize.raster_cuda(tri, 64, 64)
    torch.cuda.synchronize()
    face_p, zbuf_p = rasterize.raster_plain(tri, 64, 64)
    assert torch.equal(face, face_p)
    assert torch.equal(zbuf, zbuf_p)


@pytest.mark.cuda
def test_mesh_query_kernel_matches_plain(cuda):
    verts, faces, _ = two_hand_mesh(0, 2)
    verts = T(verts).to(cuda)
    vis = (torch.rand(len(verts), 1, generator=torch.Generator()
                      .manual_seed(0)) > 0.4).float().to(cuda)
    mesh = mesh_query.prepare_culled_mesh(verts, T(faces).long().to(cuda),
                                          vis)
    pts = (T(h.two_hand_points(2048, seed=3)).to(cuda)
           - mesh["center"]).contiguous()
    _, ub = knn.nearest_vertex_d2(pts + mesh["center"], verts)
    far = torch.arange(2048, device=cuda) % 3 == 0
    for f in (None, far):
        got = mesh_query.point_mesh_query_vis_cuda(pts, mesh["table"], ub, f)
        want = mesh_query.point_mesh_query_vis_plain(pts, mesh["table"], ub,
                                                     f)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_interp_kernel_matches_plain(cuda):
    rs = np.random.RandomState(4)
    for (H, W, C) in ((32, 32, 64), (64, 64, 16)):
        feat = T(rs.randn(H, W, C).astype(np.float32)).to(cuda)
        uv = T(rs.uniform(-1.1, 1.1, (5000, 2)).astype(np.float32)).to(cuda)
        got = interp_mxu.interp_cuda(feat, uv)
        want = interp_mxu.interp_plain(feat, uv)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_onehot_scatter_kernel_matches_plain(cuda):
    """Kernel 13 against index_add_ (other summation order: rtol 1e-5 of
    the row's absolute sum), bit-equal across runs, through take_rows'
    backward, and zeros for rows that no point reads."""
    rs = np.random.RandomState(5)
    for n, t, c in ((262144, 1284, 204), (5000, 37, 12), (1, 3, 5)):
        idx = np.minimum(rs.geometric(0.01, n) - 1, t - 2).astype(np.int32)
        g = T(rs.randn(n, c).astype(np.float32)).to(cuda)
        i = T(idx).to(cuda)
        n0 = onehot_gather.launches
        got = onehot_gather.onehot_scatter_cuda(g, i, t)
        again = onehot_gather.onehot_scatter_cuda(g, i, t)
        torch.cuda.synchronize()
        assert onehot_gather.launches == n0 + 2
        assert torch.equal(got, again)
        want = onehot_gather.onehot_scatter_plain(g, i, t)
        bound = onehot_gather.onehot_scatter_plain(g.abs(), i, t)
        assert ((got - want).abs() <= 1e-5 * bound + 1e-30).all()
        assert torch.equal(got[t - 1], torch.zeros_like(got[t - 1]))
    table = torch.randn(50, 8, device=cuda, requires_grad=True)
    i = torch.randint(0, 50, (3000,), device=cuda)
    w = torch.randn(3000, 8, device=cuda)
    (onehot_gather.take_rows(table, i) * w).sum().backward()
    assert torch.allclose(table.grad,
                          onehot_gather.onehot_scatter_plain(w, i, 50),
                          rtol=1e-5, atol=1e-5)
