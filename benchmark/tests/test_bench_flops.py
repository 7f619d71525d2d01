"""``benchmark/flops.py`` against ``torch.utils.flop_counter`` over the
plain reference at a small size: the encoders, the texture fusion's global
context, the network at one and two views, VGG19 and the discriminator."""

import json
import pathlib

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops, inputs, weights
from benchmark.reference import train as ref_train
from benchmark.reference.nets import Generator
from benchmark.reference.render import Frame, query

ROOT = pathlib.Path(__file__).resolve().parents[1]


def small_model():
    cfg = json.loads((ROOT / "configs" / "vanerf-1view.json").read_text())
    m = cfg["models"]["VANeRF"]
    m["geo_args"]["n_downsample"] = 2
    return cfg, m


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@torch.no_grad()
def test_encoders_and_global_context():
    _, m = small_model()
    G = Generator(m, 779, (32, 32))
    img = torch.rand(2, 32, 32, 3)
    assert counted(lambda: G.encode(img)) == 2 * (
        flops.geo_encoder(m, 32, 32) + flops.tex_encoder(m, 32, 32))
    (_, _), tex = G.encode(img)
    assert counted(lambda: G.tex_vis_fusion.global_feature(tex, img)) \
        == 2 * flops.global_ctx(m, 32, 32)


@pytest.mark.parametrize("n_views", [1, 2])
@torch.no_grad()
def test_network_at_points(n_views):
    cfg, m = small_model()
    G = Generator(m, 779, (32, 32))
    G.load_state_dict(weights.seeded_state(G, 3, "cpu"))
    req = inputs.make_pool(5, 1, n_views, 32, 32, "cpu")[0]
    req = {k: torch.as_tensor(v) for k, v in req.items()}
    fr = Frame(G, req, n_views)
    N = 200
    pts = torch.rand(N, 3) * 0.2 - 0.1
    view = torch.nn.functional.normalize(torch.rand(N, 3), dim=-1)
    args = (pts, view, torch.ones(N, 1), torch.rand(N, 1) * 0.01,
            torch.randint(0, 1558, (N,)), torch.zeros(N, 1, dtype=torch.bool))
    # the query's count less the keypoints' projection, once a call
    kpt = 2 * n_views * m["sp_args"]["n_kpt"] * 9
    assert counted(lambda: query(G, fr, *args)) - kpt == flops.query(
        m, N, n_views)


@torch.no_grad()
def test_vgg_and_discriminator():
    vgg, D = ref_train.Vgg19(), ref_train.Discriminator()
    x = torch.rand(1, 16, 16, 3)
    assert counted(lambda: vgg.slice4(vgg.slice3(vgg.slice2(vgg.slice1(
        x.permute(0, 3, 1, 2)))))) == flops.vgg19(16, 16)
    assert counted(lambda: D(x, x, x, x)) == flops.discriminator(16, 16)


def test_frame_and_step_compose_the_units():
    _, m = small_model()
    per_ray = 64 + 64
    rays = 256 * 256
    assert flops.frame(m, 256, 256, 3, 64, 64, 1) == flops.encoders(
        m, 256, 256) + rays * per_ray * (flops.point_view(m) + flops.point(m))
    assert flops.ibr(1) == 0 and flops.ibr(2) > 0
    assert flops.train_step(m, 256, 256, 1) > 4 * flops.query(
        m, 64 * 64 * per_ray, 1)
    assert flops.peak_flops("NVIDIA H100 80GB HBM3", "float32") == 67e12
    with pytest.raises(KeyError):
        flops.peak_flops("cpu", "float32")
