"""flax parameters of ``vanerf_tpu`` -> the port's reference-keyed
``state_dict``s: the generator, the discriminator and the VGG19 feature
stack.

Inverts ``tools/convert_reference_ckpt.py::convert_state_dict`` for the
generator: conv kernels HWIO -> OIHW (transposed convs HW,O,I -> I,O,HW),
dense kernels (in, out) -> (out, in), 1x1 Conv1d stacks stored as dense
layers -> (out, in, 1), weight-norm ``v``/``g`` -> ``weight_v``/``weight_g``
(``models/mlp.py:54-60``), norm ``scale`` -> ``weight``.  The result loads
into :class:`vanerf_tpu_torch.models.VANeRF` with ``strict=True``.

The ``sp_conv`` fusion modules (``models/voxel_fusion.py``) have no key in
the reference checkpoint (the JAX package replaced its spconv U-net by a
dense one), so their keys are the flax paths themselves, e.g.
``geo_vis_fusion.xyzc0.conv0.Conv_0.weight``: 3-D conv kernels (kd, kh,
kw, in, out) -> (out, in, kd, kh, kw), dense kernels (in, out) -> (out,
in), GroupNorm / LayerNorm ``scale`` -> ``weight``.  The texture branch's
global context keeps the dense branch's keys.
"""

from __future__ import annotations

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


class _Writer:
    def __init__(self):
        self.sd = {}

    def put(self, key, value):
        self.sd[key] = _t(value)

    def conv(self, p, key, bias=True):
        """flax Conv / ConvTranspose kernel (kh, kw, a, b) -> (b, a, kh, kw)."""
        self.put(f"{key}.weight", np.transpose(p["kernel"], (3, 2, 0, 1)))
        if bias and "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def conv1d(self, p, key):
        """flax Conv (k, in, out) -> torch Conv1d (out, in, k)."""
        self.put(f"{key}.weight", np.transpose(p["kernel"], (2, 1, 0)))

    def pointwise(self, p, key):
        """flax Dense (in, out) -> 1x1 Conv1d (out, in, 1)."""
        self.put(f"{key}.weight", np.transpose(p["kernel"])[..., None])

    def dense(self, p, key):
        self.put(f"{key}.weight", np.transpose(p["kernel"]))
        if "bias" in p:
            self.put(f"{key}.bias", p["bias"])

    def norm(self, p, key):
        self.put(f"{key}.weight", p["scale"])
        self.put(f"{key}.bias", p["bias"])

    def wn_linear(self, p, key):
        if "g" in p:
            self.put(f"{key}.weight_v", np.transpose(p["v"]))
            self.put(f"{key}.weight_g", np.asarray(p["g"]).reshape(-1, 1))
        else:
            self.put(f"{key}.weight", np.transpose(p["v"]))
        self.put(f"{key}.bias", p["bias"])


def _convblock(w, p, pre):
    w.norm(p["GroupNorm_0"], f"{pre}.bn1")
    w.conv(p["Conv_0"], f"{pre}.conv1", bias=False)
    w.norm(p["GroupNorm_1"], f"{pre}.bn2")
    w.conv(p["Conv_1"], f"{pre}.conv2", bias=False)
    w.norm(p["GroupNorm_2"], f"{pre}.bn3")
    w.conv(p["Conv_2"], f"{pre}.conv3", bias=False)
    if "Conv_3" in p:
        # bn4 IS downsample.0 (one module, two state-dict names)
        w.norm(p["GroupNorm_3"], f"{pre}.bn4")
        w.norm(p["GroupNorm_3"], f"{pre}.downsample.0")
        w.conv(p["Conv_3"], f"{pre}.downsample.2", bias=False)


def _hgfilter(w, p, pre):
    w.conv(p["conv1"], f"{pre}.conv1")
    w.norm(p["GroupNorm_0"], f"{pre}.bn1")
    _convblock(w, p["conv2"], f"{pre}.conv2")
    w.conv(p["unpack1"]["deconv"], f"{pre}.unpack1.conv", bias=False)
    w.norm(p["unpack1"]["GroupNorm_0"], f"{pre}.unpack1.norm")
    w.conv(p["conv_out"], f"{pre}.conv_out")
    _convblock(w, p["conv3"], f"{pre}.conv3")
    _convblock(w, p["conv4"], f"{pre}.conv4")
    i = 0
    while f"m{i}" in p:
        for blk, bp in p[f"m{i}"].items():
            _convblock(w, bp, f"{pre}.m{i}.{blk}")
        _convblock(w, p[f"top_m_{i}"], f"{pre}.top_m_{i}")
        w.conv(p[f"conv_last{i}"], f"{pre}.conv_last{i}")
        w.norm(p[f"GroupNorm_{i + 1}"], f"{pre}.bn_end{i}")
        w.conv(p[f"l{i}"], f"{pre}.l{i}")
        if f"bl{i}" in p:
            w.conv(p[f"bl{i}"], f"{pre}.bl{i}")
            w.conv(p[f"al{i}"], f"{pre}.al{i}")
        i += 1


def _resblk_encoder(w, p, pre):
    """The texture encoder; with ``norm: group`` also its GroupNorms'
    scales and biases (flax ``GroupNorm_<i>`` in call order: the first,
    the downsamplings, the upsamplings; two in each ResBlk), each under
    its norm's index in ``layers``, the slot after its convolution."""
    n_res = sum(1 for k in p if k.startswith("ResBlk_"))
    n_up = sum(1 for k in p if k.startswith("up"))
    n_conv = sum(1 for k in p if k.startswith("Conv_"))
    n_down = n_conv - 1 - (1 if n_up > 0 else 0)

    def norm(q, name, key):
        if name in q:
            w.norm(q[name], key)

    w.conv(p["Conv_0"], f"{pre}.layers.1")
    norm(p, "GroupNorm_0", f"{pre}.layers.2")
    idx = 4
    for i in range(n_down):
        w.conv(p[f"Conv_{i + 1}"], f"{pre}.layers.{idx}")
        norm(p, f"GroupNorm_{i + 1}", f"{pre}.layers.{idx + 1}")
        idx += 3
    for b in range(n_res):
        q = p[f"ResBlk_{b}"]
        w.conv(q["Conv_0"], f"{pre}.layers.{idx}.layers.1")
        norm(q, "GroupNorm_0", f"{pre}.layers.{idx}.layers.2")
        w.conv(q["Conv_1"], f"{pre}.layers.{idx}.layers.5")
        norm(q, "GroupNorm_1", f"{pre}.layers.{idx}.layers.6")
        idx += 1
    for u in range(n_up):
        w.conv(p[f"up{u}"], f"{pre}.layers.{idx}")
        norm(p, f"GroupNorm_{n_down + 1 + u}", f"{pre}.layers.{idx + 1}")
        idx += 3
    if n_up > 0:
        w.conv(p[f"Conv_{n_down + 1}"], f"{pre}.layers.{idx + 1}")


def _mlp_unet_fusion(w, p, pre):
    for part in ("layers1", "layers2"):
        for name, lp in p[part].items():
            w.wn_linear(lp, f"{pre}.{part}.layers.{int(name[1:])}.linear")


def _geo_vis_fusion(w, p, pre):
    for si, (at, ated) in enumerate([("fconv_at", "fconv_ated"),
                                     ("fconv_at1", "fconv_ated1")]):
        w.pointwise(p[f"at{si}"]["Dense_0"], f"{pre}.{at}.0")
        w.pointwise(p[f"at{si}"]["Dense_1"], f"{pre}.{at}.2")
        w.pointwise(p[f"ated{si}"]["Dense_0"], f"{pre}.{ated}.0")
        w.pointwise(p[f"ated{si}"]["Dense_1"], f"{pre}.{ated}.2")


def _flax_tree(w, p, pre):
    """A flax subtree under its own path: kernels of rank 5 (3-D convs)
    and 2 (dense) transposed to torch's layout, ``scale`` -> ``weight``."""
    for name, q in p.items():
        key = f"{pre}.{name}"
        if isinstance(q, dict):
            _flax_tree(w, q, key)
        elif name == "kernel":
            k = np.asarray(q)
            perm = {5: (4, 3, 0, 1, 2), 2: (1, 0)}[k.ndim]
            w.put(f"{pre}.weight", np.transpose(k, perm))
        else:
            w.put(f"{pre}.weight" if name == "scale" else key, q)


def _geo_vis_fusion_sp(w, p, pre):
    for name, q in p.items():
        _flax_tree(w, q, f"{pre}.{name}")


def _tex_vis_fusion(w, p, pre):
    if "xyzc" in p:                       # sp_conv: TexVisFusionSP
        for name in ("xyzc", "at", "vis_at", "fuse"):
            _flax_tree(w, p[name], f"{pre}.{name}")
    else:
        w.pointwise(p["at"]["Dense_0"], f"{pre}.fconv_at.0")
        w.pointwise(p["at"]["Dense_1"], f"{pre}.fconv_at.2")
        w.pointwise(p["fuse"]["Dense_0"], f"{pre}.fconv.0")
        w.pointwise(p["fuse"]["Dense_1"], f"{pre}.fconv.2")
    for src, conv, ln in (("gt0", 0, 1), ("gt1", 3, 4)):
        w.conv1d(p[src]["Conv_0"], f"{pre}.fconv_gt.{conv}")
        w.norm(p[src]["LayerNorm_0"], f"{pre}.fconv_gt.{ln}")
    for name in ("fconv3", "fconv4"):
        g = p[name]
        w.conv(g["Conv_0"], f"{pre}.{name}.0", bias=False)
        w.put(f"{pre}.{name}.1.weight", np.asarray(g["ln0_scale"])[..., 0])
        w.put(f"{pre}.{name}.1.bias", np.asarray(g["ln0_bias"])[..., 0])
        w.conv(g["Conv_1"], f"{pre}.{name}.3", bias=False)
        w.put(f"{pre}.{name}.4.weight", np.asarray(g["ln1_scale"])[..., 0])
        w.put(f"{pre}.{name}.4.bias", np.asarray(g["ln1_bias"])[..., 0])


def _ibr(w, p, pre):
    w.put(f"{pre}.ani_al", np.asarray(p["ani_al"]).reshape(()))
    for name, key in (("ray0", "ray_encoder.0"), ("ray1", "ray_encoder.2"),
                      ("base0", "base_layer.0"), ("base1", "base_layer.2"),
                      ("vis1a", "vis_layer1.0"), ("vis1b", "vis_layer1.2"),
                      ("vis2a", "vis_layer2.0"), ("vis2b", "vis_layer2.2"),
                      ("out0", "out_layer.0"), ("out1", "out_layer.2"),
                      ("out2", "out_layer.4")):
        w.dense(p[name], f"{pre}.{key}")


def from_jax_params(params_np: dict) -> dict:
    """flax generator params (``{"params": {...}}`` or the inner dict, numpy
    or array leaves) -> state_dict of the port's ``VANeRF``."""
    p = params_np.get("params", params_np)
    w = _Writer()
    w.put("sigmoid_beta", np.asarray(p["sigmoid_beta"]).reshape(1))
    _hgfilter(w, p["geo_encoder"], "geo_encoder")
    _resblk_encoder(w, p["tex_encoder"], "tex_encoder")
    _mlp_unet_fusion(w, p["mlp_geo"], "mlp_geo")
    geo = p["geo_vis_fusion"]
    (_geo_vis_fusion_sp if "xyzc0" in geo else _geo_vis_fusion)(
        w, geo, "geo_vis_fusion")
    _tex_vis_fusion(w, p["tex_vis_fusion"], "tex_vis_fusion")
    w.dense(p["ibr_compress_gfeat"], "ibr_compress_gfeat")
    _ibr(w, p["mlp_tex"], "mlp_tex")
    return w.sd


def disc_from_jax_params(params_np: dict) -> dict:
    """flax ``DiscriminatorVis`` params -> state_dict of the port's
    :class:`~vanerf_tpu_torch.models.discriminator.DiscriminatorVis`
    (the inverse of ``tools/convert_reference_ckpt.py::
    convert_discriminator``)."""
    p = params_np.get("params", params_np)
    w = _Writer()
    for name, key in (("g0", "fconv3.0"), ("g1", "fconv3.2"),
                      ("v0", "fconv4.0"), ("v1", "fconv4.2"),
                      ("v2", "fconv4.4"), ("p0", "fconv2.0"),
                      ("p1", "fconv2.2"), ("p2", "fconv2.4")):
        w.conv(p[name], key)
    w.dense(p["gl0"], "linear.0")
    w.dense(p["gl1"], "linear.2")
    return w.sd


def vgg_from_jax_params(params_np: dict) -> dict:
    """flax ``losses.Vgg19Features`` params (``conv1_1`` .. ``conv4_1``)
    -> state_dict of the port's
    :class:`~vanerf_tpu_torch.losses.Vgg19Features`."""
    from .losses import VGG_LAYERS, vgg_slice_key
    p = params_np.get("params", params_np)
    w = _Writer()
    for idx, name in VGG_LAYERS.items():
        w.conv(p[name], vgg_slice_key(idx))
    return w.sd
