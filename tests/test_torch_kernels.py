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
    vanerf_tpu (the machine with the card has none of them), and none
    imports PIL or tensorboard when it is imported (the modules that use
    them import them where they do)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import vanerf_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, p.__name__ + '.')]\n"
        "for name in mods:\n"
        "    importlib.import_module(name)\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'yaml', 'vanerf_tpu', 'PIL', "
        "'tensorboard', 'tensorflow')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = h.ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=h.ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[0]) >= 30


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    """A CPU render (pixel-major and coordinate-major, with the culled
    nearest-vertex search of VANERF_KNN_CULL and under a serving tier) and
    the exact mesh API on CPU tensors run every kernel's plain twin: no
    counter moves and nothing is built."""
    ops.reset_launches()
    batch = h.synthetic_batch()[0]
    for soa, cull, tier in (("0", "", ""), ("1", "", ""), ("0", "1", "0.5"),
                            ("1", "1", "")):
        monkeypatch.setenv("VANERF_SOA_POINTS", soa)
        monkeypatch.setenv("VANERF_KNN_CULL", cull)
        monkeypatch.setenv("VANERF_FAR_NET", tier)
        out = tr.render_patch(h.port_model(), h.torch_batch(batch),
                              grids=T(h.center_grid()), out_h=4, out_w=4,
                              sample_per_ray_c=h.S_C, sample_per_ray_f=h.S_F)
        assert torch.isfinite(out["tex_fg_fine"]).all()
    verts, faces = T(batch["verts"][0]), T(batch["faces"])
    pts = T(h.two_hand_points(64, seed=2))
    sdf, _ = mesh_query.point_mesh_sdf(verts, faces, pts)
    sdf_f, _ = mesh_query.cal_vis_sdf_fast(verts, faces, pts,
                                           torch.ones(len(verts), 1))
    assert torch.isfinite(sdf).all() and torch.isfinite(sdf_f).all()
    assert mesh_query.unculled_launches == 0
    assert mesh_query.unculled_launches_T == 0
    assert ops.launch_counts() == {"mesh_query": 0, "knn": 0,
                                   "mesh_query_brute": 0,
                                   "mesh_query_vis_brute": 0,
                                   "mesh_query_T": 0, "knn_T": 0,
                                   "knn_culled": 0, "knn_T_culled": 0,
                                   "rasterize": 0, "interp_mxu": 0,
                                   "onehot_scatter": 0, "row_gather": 0,
                                   "fused_query_mlp": 0, "fused_geo_mlp": 0,
                                   "interp_mxu_bf16": 0,
                                   "row_gather_bf16": 0,
                                   "fused_query_mlp_bf16": 0,
                                   "fused_geo_mlp_bf16": 0,
                                   "fused_query_mlp_bf16_mma": 0,
                                   "fused_geo_mlp_bf16_mma": 0,
                                   "onehot_scatter_bf16": 0,
                                   "bilinear": 0, "bilinear_bf16": 0}


def test_kernel_library_is_keyed_on_sources():
    from vanerf_tpu_torch.ops import _cuda
    path = _cuda.library_path()
    assert path.parent == _cuda.BUILD_DIR
    assert path.name.startswith("libvanerf_kernels_")
    srcs = {p.name for p in _cuda._sources()}
    assert {"knn.cu", "rasterize.cu", "mesh_query.cu", "interp.cu",
            "onehot_scatter.cu", "row_gather.cu", "fused_mlp.cu",
            "mesh_query_brute.cu", "common.cuh", "tri_dist.cuh"} <= srcs
    assert {"vt_mesh_query_brute", "vt_mesh_query_vis_brute",
            "vt_mesh_query_T", "vt_knn_T", "vt_knn_culled", "vt_knn_T_culled",
            "vt_mesh_query_culled", "vt_mesh_query_culled_T"} \
        <= set(_cuda._SIGNATURES)
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
@pytest.mark.parametrize("n,v", [(5001, 1284), (777, 1), (3000, 4096),
                                 (130, 7)])
def test_knn_kernels_at_edge_shapes(cuda, n, v):
    """B and 8 (4 points a thread, 512 a block) at N not a multiple of a
    block's points, at one vertex, at the 4,096-vertex limit (48 KB of
    shared memory) and at a count no multiple of 4: bit-equal to the plain
    version, 8 to B; kernel 9 still equals B."""
    rs = np.random.RandomState(n + v)
    q = T(rs.randn(n, 3).astype(np.float32) * 0.1).to(cuda)
    verts = T(rs.randn(v, 3).astype(np.float32) * 0.1).to(cuda)
    idx, d2 = knn.nearest_vertex_d2(q, verts)
    idx_T, d2_T = knn.nearest_vertex_d2_T(q.t().contiguous(), verts)
    idx_9, d2_9 = knn.nearest_vertex_d2_culled(q, verts)
    torch.cuda.synchronize()
    idx_p, d2_p = knn.nearest_vertex_d2_plain(q, verts)
    for i_, d_ in ((idx, d2), (idx_T, d2_T), (idx_9, d2_9)):
        assert torch.equal(i_, idx_p) and torch.equal(d_, d2_p)
    with pytest.raises(ValueError, match="4096"):
        knn.nearest_vertex_d2(q, torch.zeros(4097, 3, device=cuda))


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


def _offset_view(x: torch.Tensor, shift: int) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts ``shift`` floats into
    its storage (so a float4 load of it is misaligned for shift % 4)."""
    flat = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    view = flat[shift:].view(x.shape)
    view.copy_(x)
    return view


def _launched(fn, kernel: str) -> str:
    """The instantiation of the CUDA kernel ``kernel`` that fn() launches,
    as torch.profiler names it (e.g. ``interp_kernel<true, false>``).  A
    short session may end before the device's records arrive: up to 5 are
    tried."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            at = e.key.find(kernel + "<")
            if at >= 0:
                return e.key[at:e.key.index(">", at) + 1]
    return "not seen"


# (H, W, C, N, layout): the main path's map (32^2 x 64), the largest map
# kernel D takes (4,096 pixels), a channel count that is not
# a multiple of 4 (scalar lanes), a slice feat[1] of a batch (aligned), a
# table and a uv that start off a 16- / 8-byte boundary (scalar lanes), and
# N not a multiple of the points of a block
INTERP_CASES = [(32, 32, 64, 5001, "plain"), (64, 64, 16, 5001, "plain"),
                (16, 16, 6, 777, "plain"), (32, 32, 64, 3000, "batch1"),
                (32, 32, 64, 3000, "feat+1"), (64, 64, 16, 999, "uv+1")]


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C,N,layout", INTERP_CASES)
def test_interp_kernel_matches_plain(cuda, H, W, C, N, layout):
    """Kernel D equals interp_plain bit for bit, in its float4 and its
    scalar-lane instantiation, with uv beyond [-1, 1] (the border clip)."""
    rs = np.random.RandomState(4)
    feat = T(rs.randn(2, H, W, C).astype(np.float32)).to(cuda)
    uv = T(rs.uniform(-1.3, 1.3, (N, 2)).astype(np.float32)).to(cuda)
    f = feat[1] if layout == "batch1" else feat[0]
    if layout == "feat+1":
        f = _offset_view(f, 1)
    if layout == "uv+1":
        uv = _offset_view(uv, 1)
    n0 = interp_mxu.launches
    got = interp_mxu.interp_cuda(f, uv)
    torch.cuda.synchronize()
    assert interp_mxu.launches == n0 + 1
    assert torch.equal(got, interp_mxu.interp_plain(f, uv))
    assert torch.equal(got, interp_mxu.interp_cuda(f, uv))
    vec = C % 4 == 0 and layout in ("plain", "batch1")
    # a single map takes the unbatched instantiation (BATCHED = false)
    assert (_launched(lambda: interp_mxu.interp_cuda(f, uv), "interp_kernel")
            == f"interp_kernel<{str(vec).lower()}, false>")


# (N, T, C, rows, layout): both sides of the one-launch threshold
# (SCATTER_SMALL_N = 4,096), the main path's four shapes, empty and
# one-point inputs, every point on one row, a scalar channel count, and a
# gradient that starts off a 16-byte boundary
SCATTER_CASES = [(0, 3, 5, "spread", "plain"), (1, 3, 5, "spread", "plain"),
                 (1284, 1024, 256, "spread", "plain"),
                 (4096, 1024, 32, "spread", "plain"),
                 (4097, 1024, 32, "spread", "plain"),
                 (4096, 3, 204, "one", "plain"),
                 (1284, 8192, 32, "spread", "plain"),
                 (262144, 1284, 204, "spread", "plain"),
                 (262144, 1024, 256, "spread", "plain"),
                 (262144, 4096, 32, "spread", "plain"),
                 (262144, 8192, 5, "spread", "plain"),
                 (262144, 8192, 32, "one", "plain"),
                 (20000, 1024, 32, "spread", "g+1")]


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,c,rows,layout", SCATTER_CASES)
def test_onehot_scatter_kernel_matches_plain(cuda, n, t, c, rows, layout):
    """Kernel 13 against index_add_ (other summation order: 1e-5 of the
    row's absolute sum), bit-equal across runs, and zeros for rows that no
    point reads."""
    rs = np.random.RandomState(5)
    if rows == "one":
        idx = np.full(n, t // 2, np.int32)
    else:
        idx = np.minimum(rs.geometric(0.01, n) - 1, t - 2).astype(np.int32)
    g = T(rs.randn(n, c).astype(np.float32)).to(cuda)
    if layout == "g+1":
        g = _offset_view(g, 1)
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
    empty = bound.sum(1) == 0
    assert empty.any() and not got[empty].any()
    vec = c % 4 == 0 and layout == "plain"
    summed = "os_small" if n <= onehot_gather.SCATTER_SMALL_N else "os_sum"
    # the lane flag, then g's and the table's element types
    assert (_launched(lambda: onehot_gather.onehot_scatter_cuda(g, i, t),
                      summed) == f"{summed}<{str(vec).lower()}, float, float>")


@pytest.mark.cuda
def test_take_rows_backward_runs_kernel_13(cuda):
    table = torch.randn(50, 8, device=cuda, requires_grad=True)
    i = torch.randint(0, 50, (3000,), device=cuda)
    w = torch.randn(3000, 8, device=cuda)
    (onehot_gather.take_rows(table, i) * w).sum().backward()
    assert torch.allclose(table.grad,
                          onehot_gather.onehot_scatter_plain(w, i, 50),
                          rtol=1e-5, atol=1e-5)
