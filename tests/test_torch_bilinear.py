"""Kernel 14 (``csrc/bilinear.cu``), ``feat_sample_nhwc``'s sampler, and
the route ``feat_sample_nhwc`` takes to it.

On the CPU: CPU tensors, float64 and every sample whose gradient is wanted
take the plain version (``feat_sample_nhwc_plain``), unchanged, gradient
included; the route counters count each route's points while a profiler
records and nothing otherwise.  The tests marked ``cuda`` build the kernel
with nvcc and hold it to the plain version to the bit on the card, at the
main path's maps, batches and point counts, in float32 and bfloat16; they
skip where there is no CUDA device and need neither jax nor the JAX
package (run them with ``--noconftest``).
"""

import numpy as np
import pytest
import torch

from vanerf_tpu_torch import ops, profiling
from vanerf_tpu_torch import renderer as tr
from vanerf_tpu_torch.ops import grid_sample as gs

BF = torch.bfloat16
SEED = 14


def _inputs(Bm, B, H, W, C, N, dtype=torch.float32, device="cpu",
            seed=SEED):
    """(Bm, H, W, C) maps and (B, N, 2) points: most in [-1.3, 1.3], the
    first 16 of each element on the borders and corners, exactly."""
    g = torch.Generator().manual_seed(seed)
    maps = (torch.randn(Bm, H, W, C, generator=g) * 3).to(dtype)
    uv = torch.rand(B, N, 2, generator=g) * 2.6 - 1.3
    edge = torch.tensor([[-1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [1.0, -1.0],
                         [0.0, -1.0], [0.0, 1.0], [-1.0, 0.0], [1.0, 0.0],
                         [-1.3, 0.2], [1.3, 0.2], [0.2, -1.3], [0.2, 1.3],
                         [-2.0, -2.0], [2.0, 2.0], [0.0, 0.0], [1.0, 0.5]])
    k = min(N, len(edge))
    uv[:, :k] = edge[:k]
    return maps.to(device), uv.to(device)


# ---------------------------------------------------------------------------
# on the CPU: the route and the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, BF, torch.float64])
def test_cpu_tensors_take_the_plain_version(dtype):
    """CPU maps in any dtype: the plain version's rows, no launch, no
    build; float64 has no kernel on any device."""
    ops.reset_launches()
    maps, uv = _inputs(2, 4, 16, 12, 5, 300, dtype)
    if dtype == torch.float64:
        uv = uv.double()
    assert not gs.bilinear_viable(maps, uv)
    assert gs.bilinear_takes(maps, uv) == (dtype != torch.float64)
    got = gs.feat_sample_nhwc(maps, uv)
    assert got.dtype == dtype and got.shape == (4, 300, 5)
    assert torch.equal(got, gs.feat_sample_nhwc_plain(maps, uv))
    assert ops.launch_counts()["bilinear"] == 0
    assert ops.launch_counts()["bilinear_bf16"] == 0


def test_kernel_takes_no_sample_whose_gradient_is_wanted():
    """The device-independent half of the route: float32 / bfloat16 maps
    at float32 points, with no graph built through the map or the points."""
    maps, uv = _inputs(1, 2, 8, 8, 4, 50)
    assert gs.bilinear_takes(maps, uv)
    assert gs.bilinear_takes(maps.to(BF), uv)
    assert not gs.bilinear_takes(maps, uv.double())
    assert not gs.bilinear_takes(maps.half(), uv)
    leaf = maps.clone().requires_grad_()
    assert not gs.bilinear_takes(leaf, uv)
    assert not gs.bilinear_takes(maps, uv.clone().requires_grad_())
    with torch.no_grad():
        assert gs.bilinear_takes(leaf, uv)
    # shapes outside the kernel's 32-bit index math and grid
    assert not gs.bilinear_takes(maps, torch.zeros(65536, 1, 2))
    assert not gs.bilinear_takes(torch.zeros(1, 2, 2, 0), uv)


@pytest.mark.parametrize("hw,dtype", [((8, 8), torch.float32),
                                      ((128, 128), torch.float32),
                                      ((8, 8), BF)])
def test_gradient_through_the_sampler_is_unchanged(hw, dtype):
    """A map that wants a gradient, under grad mode: the differentiable
    plain version (take_rows' packed corners for the small map, the native
    gather above 8,192 texels), its rows and gradients equal to the plain
    version's to the bit, and its points counted on the gather route."""
    H, W = hw
    maps, uv = _inputs(2, 4, H, W, 4, 200, dtype)
    w = torch.randn(4, 200, 4, generator=torch.Generator().manual_seed(1))
    grads = []
    for fn in (gs.feat_sample_nhwc, gs.feat_sample_nhwc_plain):
        leaf = maps.clone().requires_grad_()
        (fn(leaf, uv).float() * w).sum().backward()
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])
    assert grads[0].abs().sum() > 0
    profiling.reset_counters()
    leaf = maps.clone().requires_grad_()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = gs.feat_sample_nhwc(leaf, uv)
    assert out.requires_grad
    counts = profiling.counters()
    assert counts["sample_gather_points"] == 4 * 200
    assert counts.get("sample_kernel_points", 0) == 0


def test_route_counters_count_only_while_a_profiler_records():
    maps, uv = _inputs(1, 3, 8, 8, 4, 70)
    profiling.reset_counters()
    assert not profiling.recording()
    gs.feat_sample_nhwc(maps, uv)
    counts = profiling.counters()
    assert counts.get("sample_gather_points", 0) == 0
    assert counts.get("sample_kernel_points", 0) == 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        gs.feat_sample_nhwc(maps, uv)
        gs.grid_sample_2d(maps[0], uv[0])
    counts = profiling.counters()
    assert counts["sample_gather_points"] == 3 * 70 + 70
    assert counts.get("sample_kernel_points", 0) == 0
    profiling.reset_counters()
    assert profiling.counters().get("sample_gather_points", 0) == 0


# ---------------------------------------------------------------------------
# on the card: kernel 14 against the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# (Bm, B, H, W, C, N): the main path's three maps (mask + image, the fine
# geometry map, the texture map) and a 64^2 x 16 map, one map for a 16-tile
# group and two (two source views) for 32 element-views, at a pass's
# 262,144 points a tile, the 1,558 vertices of two MANO hands and a count
# that leaves a ragged block
CASES = [(1, 16, 256, 256, 4, 262144), (2, 32, 128, 128, 8, 1558),
         (2, 32, 64, 64, 8, 5001), (1, 16, 64, 64, 16, 262144),
         (2, 32, 256, 256, 4, 1558), (1, 16, 128, 128, 8, 5001)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"{c[2]}x{c[3]}x{c[4]}-Bm{c[0]}-B{c[1]}-N{c[5]}"
                              for c in CASES])
def test_kernel_equals_the_plain_version(cuda, dtype, case):
    maps, uv = _inputs(*case, dtype=dtype, device=cuda)
    name = "bilinear" if dtype == torch.float32 else "bilinear_bf16"
    n0 = ops.launch_counts()[name]
    with torch.no_grad():
        got = gs.feat_sample_nhwc(maps, uv)
        again = gs.bilinear_cuda(maps, uv)
    assert ops.launch_counts()[name] == n0 + 2
    want = gs.feat_sample_nhwc_plain(maps, uv)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(got, again)
    # element e reads map e % Bm: each element alone on its map
    Bm = case[0]
    for e in (0, 1, case[1] - 1):
        one = gs.bilinear_cuda(maps[e % Bm:e % Bm + 1].contiguous(),
                               uv[e:e + 1].contiguous())
        assert torch.equal(one[0], got[e]), e


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF])
def test_kernel_scalar_lanes_and_unaligned_bases(cuda, dtype):
    """Channel counts that take no vector unit (3, 6; 4 in bfloat16 takes
    8-byte units) and a map, points or rows off their alignment: the
    scalar-lane instantiation, equal to the plain version."""
    for C in (3, 4, 6, 12):
        maps, uv = _inputs(2, 5, 33, 17, C, 3001, dtype=dtype, device=cuda)
        assert torch.equal(gs.bilinear_cuda(maps, uv),
                           gs.feat_sample_nhwc_plain(maps, uv)), C
    maps, uv = _inputs(1, 3, 64, 64, 8, 777, dtype=dtype, device=cuda)
    flat = torch.empty(maps.numel() + 1, dtype=dtype, device=cuda)
    off_map = flat[1:].view(maps.shape)
    off_map.copy_(maps)
    flat_uv = torch.empty(uv.numel() + 1, device=cuda)
    off_uv = flat_uv[1:].view(uv.shape)
    off_uv.copy_(uv)
    want = gs.feat_sample_nhwc_plain(maps, uv)
    assert torch.equal(gs.bilinear_cuda(off_map, uv), want)
    assert torch.equal(gs.bilinear_cuda(maps, off_uv), want)
    # no point, and a map of one texel
    empty = gs.bilinear_cuda(maps, uv[:, :0].contiguous())
    assert empty.shape == (3, 0, 8)
    one = maps[:, :1, :1].contiguous()
    assert torch.equal(gs.bilinear_cuda(one, uv),
                       gs.feat_sample_nhwc_plain(one, uv))


@pytest.mark.cuda
def test_card_route_follows_the_graph(cuda):
    """On the card: no graph -> the kernel; a map that wants a gradient
    under grad mode -> the plain version, whose gradient is the gather's;
    float64 -> the plain version."""
    maps, uv = _inputs(1, 4, 128, 128, 8, 2000, device=cuda)
    leaf = maps.clone().requires_grad_()
    n0 = ops.launch_counts()["bilinear"]
    with torch.no_grad():
        assert gs.bilinear_viable(leaf, uv)
        a = gs.feat_sample_nhwc(leaf, uv)
    assert ops.launch_counts()["bilinear"] == n0 + 1
    b = gs.feat_sample_nhwc(leaf, uv)
    assert ops.launch_counts()["bilinear"] == n0 + 1
    assert b.requires_grad and torch.equal(a, b.detach())
    b.sum().backward()
    assert leaf.grad is not None and leaf.grad.abs().sum() > 0
    d = gs.feat_sample_nhwc(maps.double(), uv.double())
    assert ops.launch_counts()["bilinear"] == n0 + 1
    assert d.dtype == torch.float64
    assert torch.equal(d.cpu(), gs.feat_sample_nhwc_plain(
        maps.double().cpu(), uv.double().cpu()))


def _small_model(cuda):
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    cfg = default_cfg()
    cfg["models"]["VANeRF"]["geo_args"]["n_downsample"] = 2
    batch, _faces, num_v = make_synthetic_batch(
        batch_size=1, H=32, W=32, subdiv=2, split="test", device="cpu")
    model = VANeRF.from_config(cfg, num_v=num_v, image_hw=(32, 32))
    init_like_flax(model, torch.Generator().manual_seed(0))
    return model.to(cuda), to_torch(batch, cuda)


@pytest.mark.cuda
def test_serving_frame_samples_through_the_kernel_alone(cuda):
    """A frame (no graph): every point feat_sample_nhwc samples takes the
    kernel; the frame equals the one whose samples take the plain
    version, to the bit."""
    model, batch = _small_model(cuda)
    model.eval()

    def render():
        return tr.render_full_image(model, batch, level=2,
                                    sample_per_ray_c=8, sample_per_ray_f=8,
                                    tile_group=4)
    profiling.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        on = render()
    counts = profiling.counters()
    assert counts["sample_kernel_points"] > 0
    assert counts.get("sample_gather_points", 0) == 0
    assert counts["bilinear"] > 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gs, "bilinear_viable", lambda *a: False)
        off = render()
    for k, v in on.items():
        assert torch.equal(v, off[k]), k


@pytest.mark.cuda
def test_training_render_keeps_the_gather(cuda):
    """A training render builds a graph through the feature maps: every
    sample whose map or points want a gradient takes the plain version;
    only the data maps (the source image and mask, which want none) take
    the kernel."""
    model, batch = _small_model(cuda)
    model.train()
    lo = 14
    y, x = np.meshgrid(np.arange(lo, lo + 4), np.arange(lo, lo + 4),
                       indexing="ij")
    grids = torch.from_numpy(np.stack([x, y], -1).reshape(1, -1, 2)
                             .astype(np.float32)).to(cuda)
    seen = {"kernel": [], "plain": []}
    real_k, real_p = gs.bilinear_cuda, gs.feat_sample_nhwc_plain
    profiling.reset_counters()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gs, "bilinear_cuda", lambda f, u: seen["kernel"].append(
            f.requires_grad or u.requires_grad) or real_k(f, u))
        mp.setattr(gs, "feat_sample_nhwc_plain",
                   lambda f, u: seen["plain"].append(
                       f.requires_grad or u.requires_grad) or real_p(f, u))
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            out = tr.render_patch(model, batch, grids=grids, out_h=4,
                                  out_w=4, sample_per_ray_c=8,
                                  sample_per_ray_f=8, training=True,
                                  compute_vis_map=False,
                                  generator=torch.Generator(
                                      device=cuda).manual_seed(0))
    assert out["tex_fg_fine"].requires_grad
    assert seen["plain"] and all(seen["plain"])
    assert seen["kernel"] and not any(seen["kernel"])
    counts = profiling.counters()
    assert counts["sample_gather_points"] > 0
    assert counts["sample_kernel_points"] > 0
