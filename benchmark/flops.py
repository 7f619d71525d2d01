"""The model's floating-point operations, counted from the configuration's
widths and the cell's shapes, whatever implements the work.

A multiply-add counts 2.  Counted are the products the model defines:
the convolutions of the encoders and of the texture fusion's global
context (per source view and frame), and the per-point networks
(``GeoVisFusion``, ``MLPUNetFusion``, ``TexVisFusion``, ``gcompress``,
the IBR head at more than one view) with the query's two projections of
the points into each view.  A frame evaluates the network at every coarse
sample and at every new importance sample, (n_c + n_f) a ray: the fine
pass's merge reuses the coarse samples' values, which a per-point query
gives the same at the same point.  Compositing, sampling, the mesh priors
and the other elementwise work count nothing.

The training step is counted as forward units with multipliers (see
:func:`train_step`).  ``peaks.json`` holds the card's published peak rates.
"""

from __future__ import annotations

import json
import pathlib


def _conv(cin, cout, k, h, w):
    """MACs of a k x k convolution producing an h x w map."""
    return cin * cout * k * k * h * w


def _convblock(cin, cout, h, w):
    c = _conv(cin, cout // 2, 3, h, w) + _conv(cout // 2, cout // 4, 3, h, w) \
        + _conv(cout // 4, cout // 4, 3, h, w)
    return c + (_conv(cin, cout, 1, h, w) if cin != cout else 0)


def _hourglass(depth, ch, h, w):
    """A level: b1 at (h, w), b2 / b3 at half, the next level or b2_plus,
    and the bicubic 2x upsampling as two products."""
    h2, w2 = h // 2, w // 2
    macs = _convblock(ch, ch, h, w) + 2 * _convblock(ch, ch, h2, w2)
    macs += (_hourglass(depth - 1, ch, h2, w2) if depth > 1
             else _convblock(ch, ch, h2, w2))
    return macs + ch * (h * h2 * w2 + h * w2 * w)


def geo_encoder(m: dict, H: int, W: int) -> int:
    """FLOPs of ``HGFilter`` on one source image."""
    h, w = H >> m.get("ds_geo", 0), W >> m.get("ds_geo", 0)
    h1, w1 = h // 2, w // 2                          # conv1, stride 2
    macs = _conv(3, 64, 7, h1, w1) + _convblock(64, 128, h1, w1)
    macs += _conv(32, 128, 3, h1, w1)                # the stride-2 deconv
    macs += _conv(32, 8, 5, h, w)
    h2, w2 = h1 // 2, w1 // 2
    macs += _convblock(128, 128, h2, w2) + _convblock(128, 256, h2, w2)
    macs += _hourglass(m["geo_args"]["n_downsample"], 256, h2, w2)
    macs += _convblock(256, 256, h2, w2) + _conv(256, 256, 1, h2, w2)
    macs += _conv(256, m["geo_args"]["out_ch"], 1, h2, w2)
    return 2 * macs


def tex_encoder(m: dict, H: int, W: int) -> int:
    """FLOPs of ``ResBlkEncoder`` on one source image."""
    t = m["tex_args"]
    h, w = H >> m.get("ds_tex", 0), W >> m.get("ds_tex", 0)
    ngf, nd, nu = t["ngf"], t["n_downsample"], t["n_upsample"]
    macs = _conv(3, ngf, 7, h, w)
    for i in range(nd):
        h, w = h // 2, w // 2
        macs += _conv(ngf * 2 ** i, ngf * 2 ** (i + 1), 3, h, w)
    ch = ngf * 2 ** nd
    macs += t["n_blocks"] * 2 * _conv(ch, ch, 3, h, w)
    for i in range(nu):
        c = ngf * 2 ** (nd - i)
        macs += _conv(c // 2, c, 3, h, w)            # transposed, stride 2
        h, w = 2 * h, 2 * w
    macs += _conv(ngf * 2 ** (nd - nu), t["out_ch"], 7, h, w)
    return 2 * macs


def tex_map_hw(m: dict, H: int, W: int):
    t = m["tex_args"]
    f = lambda n: (n >> m.get("ds_tex", 0) >> t["n_downsample"]) \
        << t["n_upsample"]
    return f(H), f(W)


def global_ctx(m: dict, H: int, W: int, num_v: int = 779) -> int:
    """FLOPs of the texture fusion's global context on one view."""
    th, tw = tex_map_hw(m, H, W)
    macs = _conv(m["tex_args"]["out_ch"], 21, 3, th, tw) \
        + _conv(21, 42, 3, th, tw)
    macs += _conv(3, 21, 3, H, W) + _conv(21, 42, 3, H, W)
    macs += 18 * 3 * (42 * num_v + num_v * 2 * num_v)
    return 2 * macs


def encoders(m: dict, H: int, W: int) -> int:
    """Per source view and frame: both encoders and the global context."""
    return geo_encoder(m, H, W) + tex_encoder(m, H, W) + global_ctx(m, H, W)


def point_view(m: dict) -> int:
    """FLOPs per point and source view: the projections, ``GeoVisFusion``,
    the per-view ``MLPUNet``, ``TexVisFusion``."""
    mg, sp = m["mlp_geo_args"], m["sp_args"]
    d1 = list(mg["n_dims1"])
    d1[0] = (1 + 2 * sp["sp_level"]) * sp["n_kpt"]
    skip = dict(zip(mg["skip_layers"], mg["skip_dims"]))
    macs = 2 * 9                                     # two 3x3 projections
    macs += 196 * 10 + 10 * 3 + 196 * 64 + 64 * 64   # geometry fusion
    macs += 28 * 10 + 10 * 3 + 28 * 8 + 8 * 8
    macs += sum((d1[i] + skip.get(i, 0)) * d1[i + 1]
                for i in range(len(d1) - 1))
    macs += 96 * 96 + 96 * 6 + 96 * 96 + 96 * 40     # texture fusion
    return 2 * macs


def point(m: dict) -> int:
    """FLOPs per point once over the views: the head MLP on the pooled
    latent and ``gcompress``."""
    mg = m["mlp_geo_args"]
    d2 = [2 * mg["n_dims1"][-1]] + list(mg["n_dims2"][1:])
    macs = sum(d2[i] * d2[i + 1] for i in range(len(d2) - 1))
    return 2 * (macs + d2[0] * m["mlp_tex_args"]["gcompress"]["out_ch"])


def ibr(n_views: int) -> int:
    """FLOPs of the IBR head per point (zero at one view, which it does
    not run)."""
    if n_views == 1:
        return 0
    per_view = 4 * 16 + 16 * 40 + 120 * 64 + 64 * 32 + 32 * 32 + 32 * 33 \
        + 32 * 32 + 32 + 37 * 16 + 16 * 8 + 8
    return 2 * per_view * n_views


def query(m: dict, n_points: int, n_views: int) -> int:
    """FLOPs of the network at ``n_points`` points."""
    return n_points * (n_views * point_view(m) + point(m) + ibr(n_views))


def frame(m: dict, H: int, W: int, level: int, n_c: int, n_f: int,
          n_views: int) -> int:
    """FLOPs of one served frame."""
    s = 2 ** (level - 1)
    rays = s * s * (H // s) * (W // s)
    return n_views * encoders(m, H, W) + query(m, rays * (n_c + n_f),
                                               n_views)


def vgg19(h: int, w: int) -> int:
    """FLOPs of the VGG loss's feature stack (conv1_1 .. conv4_1) on one
    image."""
    layers = [(3, 64, 1), (64, 64, 1), (64, 128, 2), (128, 128, 2),
              (128, 256, 4), (256, 256, 4), (256, 256, 4), (256, 256, 4),
              (256, 512, 8)]
    return 2 * sum(_conv(a, b, 3, h // d, w // d) for a, b, d in layers)


def discriminator(h: int, w: int) -> int:
    """FLOPs of ``DiscriminatorVis`` on one patch."""
    macs = _conv(12, 10, 3, h, w) + _conv(10, 10, 3, h, w)
    macs += _conv(12, 20, 3, h, w) + _conv(20, 20, 3, h, w) \
        + _conv(20, 12, 3, h, w)
    macs += _conv(24, 30, 3, h, w) + _conv(30, 20, 3, h, w) \
        + _conv(20, 1, 3, h, w) + 10 * 3 + 3
    return 2 * macs


def train_step(m: dict, H: int, W: int, n_views: int) -> int:
    """FLOPs of the faithful GAN step, as forward units times the passes
    each takes: the generator's render (encoders + the network at every
    sample of the patch) forward and backward, 3x; the discriminator's
    render, 1x; the VGG loss on the coarse and fine images against the
    target, 2 x 2 forwards and 2 input-gradient backwards, 6x; the
    discriminator on the fake patch for the G loss (forward and input
    gradient, 2x), on the real and the fake patch for the D loss (forward
    and backward, 2 x 3x) and R1's gradient and its backward (3x): 11x."""
    h, w = m.get("train_out_h", 64), m.get("train_out_w", 64)
    drk = m["dr_kwargs"]
    render = n_views * encoders(m, H, W) + query(
        m, h * w * (drk["sample_per_ray_c"] + drk["sample_per_ray_f"]),
        n_views)
    return 4 * render + 6 * vgg19(h, w) + 11 * discriminator(h, w)


def peak_flops(device_name: str, dtype: str) -> float:
    """The card's published dense peak in ``dtype`` (``peaks.json``)."""
    peaks = json.loads((pathlib.Path(__file__).parent
                        / "peaks.json").read_text())
    for key, row in peaks.items():
        if key in device_name:
            return float(row[dtype])
    raise KeyError(f"no published peak for {device_name!r}")
