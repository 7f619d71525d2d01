"""Kernel C's tile culling on the CPU: ``ops/rasterize.py::tile_face_keep``
(the mirror of ``csrc/rasterize.cu::rc_skip``) and ``raster_work``.

A face is dropped for a 16 x 16 tile only where it can win none of the
tile's pixels, so the walk over the kept faces of each tile in ascending
order, with the plain version's own arithmetic
(``rasterize._raster_pixels``), must equal ``raster_plain``, the sweep over
every face, bit for bit: the face index (ties to the lowest) and the depth.
The cases are ``chip_smoke.py``'s (the fixture's rasters and the places a
culled walk could go wrong), then a hypothesis property on single faces
near the certificate's margin.  The ties of ``raster_plain`` are checked
against the JAX package's XLA rasterizer on constructed equal depths.  The
test marked ``cuda`` holds kernel C to ``raster_plain`` on the same cases
on a GPU and skips without one (jax is imported only by the JAX
comparison, so ``-m cuda --noconftest`` runs on a machine without it).
"""

import functools

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
import torch_port_helpers  # noqa: F401  (two torch threads a test worker)
from vanerf_tpu_torch.ops import rasterize as t_rast


@functools.lru_cache(maxsize=1)
def _cases():
    from vanerf_tpu_torch.data import make_synthetic_batch
    b, _faces, _nv = make_synthetic_batch(batch_size=1, H=chip_smoke.H,
                                          W=chip_smoke.W,
                                          subdiv=chip_smoke.SUBDIV,
                                          device="cpu")
    return {tag: (torch.from_numpy(tri), Hh, Ww)
            for tag, tri, Hh, Ww in chip_smoke.raster_cases(b)}


def _tile_walk(tri, H, W):
    """Each tile's pixels against its kept faces only, in ascending order."""
    keep = t_rast.tile_face_keep(tri, H, W)
    rect, _ = t_rast._tiles(H, W, tri.device)
    face = torch.full((H * W,), -1, dtype=torch.int32)
    zbuf = torch.full((H * W,), float("inf"))
    for t in range(keep.shape[0]):
        x0, x1, y0, y1 = (int(v) for v in rect[t])
        ys, xs = torch.meshgrid(torch.arange(y0, y1 + 1),
                                torch.arange(x0, x1 + 1), indexing="ij")
        pix = (ys * W + xs).reshape(-1)
        kept = keep[t].nonzero()[:, 0]
        f, z = t_rast._raster_pixels(tri[kept], pix, W)
        ids = torch.cat([kept, kept.new_zeros(1)])
        face[pix] = torch.where(f >= 0, ids[f.clamp(min=0)], -1).int()
        zbuf[pix] = z
    return face, zbuf


@pytest.mark.parametrize("case", chip_smoke.RASTER_CASES)
def test_tile_walk_equals_the_sweep(case):
    tri, H, W = _cases()[case]
    face, zbuf = t_rast.raster_plain(tri, H, W)
    face_w, zbuf_w = _tile_walk(tri, H, W)
    assert torch.equal(face, face_w)
    assert torch.equal(zbuf, zbuf_w)
    work = t_rast.raster_work(tri, H, W)
    assert work["pairs"] <= H * W * tri.shape[0]


def test_culling_drops_most_faces_on_the_fixture():
    """The main path's raster: the walk evaluates under 2% of the sweep's
    (pixel, face) pairs; the distant mesh keeps every face in one tile."""
    tri, H, W = _cases()["the frame's vertex visibility, 256^2"]
    work = t_rast.raster_work(tri, H, W)
    assert work["tiles"] == 256 and work["tests"] == 256 * tri.shape[0]
    assert 0 < work["pairs"] < 0.02 * H * W * tri.shape[0]
    keep = t_rast.tile_face_keep(*_cases()["a distant mesh in one tile"])
    assert keep.sum(0).le(1).all()          # each face in one tile at most
    assert keep.any(1).sum() == 1


def test_raster_work_counts_face_by_face():
    """raster_work against the keep rule applied one (tile, face) at a time
    on a ragged raster."""
    tri, H, W = _cases()["slivers and degenerate faces"]
    H, W = 37, 45
    keep = t_rast.tile_face_keep(tri, H, W)
    tiles, pairs, kept, certified = 0, 0, 0, 0
    for y0 in range(0, H, 16):
        for x0 in range(0, W, 16):
            x1, y1 = min(x0 + 16, W) - 1, min(y0 + 16, H) - 1
            npix = (x1 - x0 + 1) * (y1 - y0 + 1)
            for f in range(tri.shape[0]):
                k = bool(keep[tiles, f])
                kept += k
                pairs += npix * k
                ax, ay, _, bx, by, _, cx, cy, _ = tri[f].tolist()
                a32 = ((tri[f, 3] - tri[f, 0]) * (tri[f, 7] - tri[f, 1])
                       - (tri[f, 4] - tri[f, 1]) * (tri[f, 6] - tri[f, 0]))
                misses = (x1 < min(ax, bx, cx) or x0 > max(ax, bx, cx)
                          or y1 < min(ay, by, cy) or y0 > max(ay, by, cy))
                certified += bool(misses and abs(a32) >= 1e-12)
            tiles += 1
    assert t_rast.raster_work(tri, H, W) == dict(
        tiles=tiles, tests=tiles * tri.shape[0], certified=certified,
        kept=kept, pairs=pairs)


def test_raster_plain_ties_take_the_lowest_face():
    """Constructed equal depths: two copies of each face and coplanar
    neighbours sharing edges through pixel centres.  The first face of
    least depth wins, as jnp.argmin does in the JAX package's rasterizer."""
    import jax.numpy as jnp
    from vanerf_tpu.ops.rasterize import rasterize_zbuffer
    xy = np.array([[2, 2], [12, 2], [12, 12], [2, 12], [7, 7]], np.float32)
    z = np.array([0.5, 0.5, 0.5, 0.5, 0.5], np.float32)
    faces = np.array([[0, 1, 4], [1, 2, 4], [0, 1, 4], [2, 3, 4], [3, 0, 4],
                      [1, 2, 4]], np.int32)
    f_t, _b, z_t = t_rast.rasterize_zbuffer(torch.from_numpy(xy),
                                            torch.from_numpy(z),
                                            torch.from_numpy(faces), 16, 16)
    f_j, _bj, z_j = rasterize_zbuffer(jnp.asarray(xy), jnp.asarray(z),
                                      jnp.asarray(faces), 16, 16)
    f_t = f_t.numpy()
    np.testing.assert_array_equal(f_t, np.asarray(f_j))
    assert not np.isin(f_t, [2, 5]).any()      # the later copies never win
    assert {0, 1, 3, 4} <= set(f_t.tolist())
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))


def test_raster_plain_depth_rules():
    """A NaN depth never wins and -inf wins (inside a face: at its corners
    0 x -inf is NaN), as kernel C's strict `<` takes them."""
    tri = torch.tensor([[0, 0, 1.0, 8, 0, 1.0, 0, 8, 1.0],
                        [0, 0, float("nan"), 8, 0, 0.0, 0, 8, 0.0],
                        [0, 0, -float("inf"), 4, 0, -float("inf"), 0, 4,
                         -float("inf")]])
    face, zbuf = t_rast.raster_plain(tri, 8, 8)
    assert face[9] == 2 and zbuf[9] == -float("inf")
    assert face[6] == 0 and zbuf[6] == 1.0    # the NaN face covers it too


_coord = st.one_of(st.floats(-40.0, 60.0, width=32),
                   st.integers(-40, 60).map(float),
                   st.sampled_from([0.5, 15.5, 16.0, 15.999999, 31.0,
                                    1e-7, -1e-30, 2.0 ** 59, -1e19]))


@settings(max_examples=500, deadline=None, database=None)
@given(corners=st.lists(_coord, min_size=6, max_size=6),
       shrink=st.sampled_from([1.0, 1e-3, 1e-6]),
       H=st.integers(1, 40), W=st.integers(1, 40))
def test_a_skipped_face_covers_no_pixel_of_its_tile(corners, shrink, H, W):
    """The certificate on single faces, slivers among them (the third
    corner pulled towards the first edge): wherever tile_face_keep drops
    the face, the plain test finds it inside at no pixel of that tile."""
    a, b, c = (np.array(corners[i:i + 2], np.float64) for i in (0, 2, 4))
    c = a + (b - a) * 0.5 + (c - (a + (b - a) * 0.5)) * shrink
    tri = torch.tensor([[a[0], a[1], 0.3, b[0], b[1], 0.2, c[0], c[1],
                         0.1]], dtype=torch.float32)
    keep = t_rast.tile_face_keep(tri, H, W)[:, 0]
    face, _ = t_rast.raster_plain(tri, H, W)
    rect, _ = t_rast._tiles(H, W, tri.device)
    for t in torch.nonzero(~keep)[:, 0].tolist():
        x0, x1, y0, y1 = (int(v) for v in rect[t])
        tile = face.reshape(H, W)[y0:y1 + 1, x0:x1 + 1]
        assert (tile < 0).all(), (t, tri)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_raster_kernel_equals_the_sweep_on_every_case(cuda):
    for tag, (tri, H, W) in _cases().items():
        tri = tri.to(cuda)
        face, zbuf = t_rast.raster_cuda(tri, H, W)
        face_p, zbuf_p = t_rast.raster_plain(tri, H, W)
        assert torch.equal(face, face_p), tag
        assert torch.equal(zbuf, zbuf_p), tag
