"""The generator's networks in plain PyTorch, float32, with the reference
checkpoint's module names (reference ``src/utils.py:331-880``,
``src/networks.py:43-293``, ``src/model.py:604-1024``, ``:1572-1636``).

Maps are channels-last (n, H, W, C) at the interfaces; the convolutions
run NCHW inside.  Bilinear sampling is ``F.grid_sample`` (bilinear, border
padding, align_corners=True), the reference's ``feat_sample``.  The
supported configuration is the one the benchmark runs: ``rel_z_decay``
encoding, softplus(100) geometry MLP with weight norm and [mean, var]
pooling, instance-normed texture encoder, no ``sp_conv``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-5)


def sample(maps: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """(n, H, W, C) maps at (n, N, 2) coordinates in [-1, 1] (x, y) ->
    (n, N, C)."""
    out = F.grid_sample(maps.permute(0, 3, 1, 2), uv[:, None], mode="bilinear",
                        padding_mode="border", align_corners=True)
    return out[:, :, 0].transpose(1, 2)


def cubic_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_out, n_in) bicubic (a = -0.75) interpolation, align_corners,
    replicated borders: the encoder's 2x upsampling."""
    def k(s, a=-0.75):
        s = abs(s)
        if s <= 1:
            return (a + 2) * s ** 3 - (a + 3) * s ** 2 + 1
        return a * s ** 3 - 5 * a * s ** 2 + 8 * a * s - 4 * a if s < 2 \
            else 0.0
    m = np.zeros((n_out, n_in))
    scale = (n_in - 1) / (n_out - 1)
    for o in range(n_out):
        x = o * scale
        x0 = math.floor(x)
        for d in range(-1, 3):
            m[o, min(max(x0 + d, 0), n_in - 1)] += k(x - (x0 + d))
    return torch.tensor(m, dtype=torch.float32, device=device)


def up2(x: torch.Tensor) -> torch.Tensor:
    H, W = x.shape[-2:]
    return cubic_matrix(H, 2 * H, x.device) @ x \
        @ cubic_matrix(W, 2 * W, x.device).T


class ConvBlock(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn1, self.bn2, self.bn3 = gn(cin), gn(cout // 2), gn(cout // 4)
        self.conv1 = nn.Conv2d(cin, cout // 2, 3, padding=1, bias=False)
        self.conv2 = nn.Conv2d(cout // 2, cout // 4, 3, padding=1, bias=False)
        self.conv3 = nn.Conv2d(cout // 4, cout // 4, 3, padding=1, bias=False)
        self.downsample = None
        if cin != cout:
            self.bn4 = gn(cin)
            self.downsample = nn.Sequential(
                self.bn4, nn.ReLU(), nn.Conv2d(cin, cout, 1, bias=False))

    def forward(self, x):
        a = self.conv1(F.relu(self.bn1(x)))
        b = self.conv2(F.relu(self.bn2(a)))
        c = self.conv3(F.relu(self.bn3(b)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.cat([a, b, c], 1) + res


class HourGlass(nn.Module):
    def __init__(self, depth: int, ch: int):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlock(ch, ch))
            self.add_module(f"b2_{lv}", ConvBlock(ch, ch))
            if lv == 1:
                self.add_module(f"b2_plus_{lv}", ConvBlock(ch, ch))
            self.add_module(f"b3_{lv}", ConvBlock(ch, ch))

    def level(self, lv, x):
        up = self._modules[f"b1_{lv}"](x)
        low = self._modules[f"b2_{lv}"](F.avg_pool2d(x, 2))
        low = (self.level(lv - 1, low) if lv > 1
               else self._modules[f"b2_plus_{lv}"](low))
        return up + up2(self._modules[f"b3_{lv}"](low))

    def forward(self, x):
        return self.level(self.depth, x)


class Unpack(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.norm = gn(cout)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class HGFilter(nn.Module):
    """Geometry encoder: (n, H, W, 3) in [-1, 1] -> [(n, H/4, W/4, 64),
    (n, H, W, 8)]."""

    def __init__(self, n_downsample: int, out_ch: int):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = gn(64)
        self.conv2 = ConvBlock(64, 128)
        self.unpack1 = Unpack(128, 32)
        self.conv_out = nn.Conv2d(32, 8, 5, padding=2)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        self.m0 = HourGlass(n_downsample, 256)
        self.top_m_0 = ConvBlock(256, 256)
        self.conv_last0 = nn.Conv2d(256, 256, 1)
        self.bn_end0 = gn(256)
        self.l0 = nn.Conv2d(256, out_ch, 1)

    def forward(self, x):
        x = self.conv2(F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2)))))
        hd = self.conv_out(self.unpack1(x))
        x = self.conv4(self.conv3(F.avg_pool2d(x, 2)))
        x = self.top_m_0(self.m0(x))
        x = self.l0(F.relu(self.bn_end0(self.conv_last0(x))))
        return [x.permute(0, 2, 3, 1), hd.permute(0, 2, 3, 1)]


class Pad(nn.Module):
    def __init__(self, p: int):
        super().__init__()
        self.p = p

    def forward(self, x):
        return F.pad(x, (self.p,) * 4, mode="replicate")


def inorm(ch: int) -> nn.Module:
    return nn.InstanceNorm2d(ch, eps=1e-5)


class ResBlk(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.layers = nn.Sequential(Pad(1), nn.Conv2d(ch, ch, 3), inorm(ch),
                                    nn.ReLU(), Pad(1), nn.Conv2d(ch, ch, 3),
                                    inorm(ch))

    def forward(self, x):
        return x + self.layers(x)


class ResBlkEncoder(nn.Module):
    """Texture encoder: (n, H, W, 3) -> (n, H', W', out_ch)."""

    def __init__(self, out_ch: int, ngf: int, n_down: int, n_blocks: int,
                 n_up: int):
        super().__init__()
        L = [Pad(3), nn.Conv2d(3, ngf, 7), inorm(ngf), nn.ReLU()]
        for i in range(n_down):
            m = 2 ** i
            L += [nn.Conv2d(ngf * m, ngf * m * 2, 3, stride=2, padding=1),
                  inorm(ngf * m * 2), nn.ReLU()]
        m = 2 ** n_down
        L += [ResBlk(ngf * m) for _ in range(n_blocks)]
        for i in range(n_up):
            m = 2 ** (n_down - i)
            L += [nn.ConvTranspose2d(ngf * m, ngf * m // 2, 3, stride=2,
                                     padding=1, output_padding=1),
                  inorm(ngf * m // 2), nn.ReLU()]
        L += [Pad(3), nn.Conv2d(ngf * m // 2, out_ch, 7)]
        self.layers = nn.Sequential(*L)

    def forward(self, x):
        return self.layers(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class WNLinear(nn.Module):
    """Weight-normalised dense layer: W = g v / |v| per output unit."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.zeros(cout, cin))
        self.weight_g = nn.Parameter(torch.ones(cout, 1))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        w = self.weight_g * self.weight_v / self.weight_v.norm(dim=1,
                                                               keepdim=True)
        return F.linear(x, w, self.bias)


class Layer(nn.Module):
    def __init__(self, cin: int, cout: int, wn: bool):
        super().__init__()
        self.linear = WNLinear(cin, cout) if wn else nn.Linear(cin, cout)

    def forward(self, x):
        return self.linear(x)


def softplus100(x):
    return F.softplus(x, beta=100.0, threshold=20.0)


class MLPStack(nn.Module):
    """``MLP`` / ``MLPUNet``: layers with image-feature skip inputs
    concatenated before the layers named in ``skips``."""

    def __init__(self, dims, skips=None):
        super().__init__()
        self.skips = dict(skips or {})
        n = len(dims) - 1
        self.layers = nn.ModuleList(
            Layer(dims[i] + self.skips.get(i, (0, 0))[1], dims[i + 1],
                  i != n - 1) for i in range(n))

    def forward(self, x, feats=()):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            if i in self.skips:
                x = torch.cat([x, feats[self.skips[i][0]]], -1)
            x = layer(x)
            if i != n - 1:
                x = softplus100(x)
        return x


class MLPUNetFusion(nn.Module):
    """Per-view MLP with skips, weighted [mean, var] pooling over the views,
    head MLP.  Returns (out (n, N, 2), valid (n, N, 1), pooled latent)."""

    def __init__(self, dims1, dims2, skip_dims, skip_layers):
        super().__init__()
        self.layers1 = MLPStack(dims1, {l: (i, d) for i, (l, d) in
                                        enumerate(zip(skip_layers,
                                                      skip_dims))})
        self.layers2 = MLPStack([2 * dims1[-1]] + list(dims2[1:]))

    def forward(self, x, feats, mask, w):
        xv = self.layers1(x, feats)                       # (n, V, N, C)
        mean = (w * xv).sum(1)
        var = (w * (xv - mean[:, None]) ** 2).sum(1)
        pooled = torch.cat([mean, var], -1)
        return self.layers2(pooled), mask.sum(1) > 0, pooled


def pointwise(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A stack of 1x1 Conv1d layers (and activations) on (..., C) rows."""
    for m in seq:
        x = F.linear(x, m.weight[..., 0], m.bias) if isinstance(m, nn.Conv1d) \
            else m(x)
    return x


def gate(cin, hidden, out):
    return nn.Sequential(nn.Conv1d(cin, hidden, 1, bias=False), nn.ReLU(),
                         nn.Conv1d(hidden, out, 1, bias=False), nn.Sigmoid())


def fuse(cin, hidden, out):
    return nn.Sequential(nn.Conv1d(cin, hidden, 1, bias=False), nn.ReLU(),
                         nn.Conv1d(hidden, out, 1, bias=False))


class GeoVisFusion(nn.Module):
    def __init__(self):
        super().__init__()
        self.fconv_at, self.fconv_ated = gate(196, 10, 3), fuse(196, 64, 64)
        self.fconv_at1, self.fconv_ated1 = gate(28, 10, 3), fuse(28, 8, 8)

    def forward(self, sampled, knn, knn_toh, ctx):
        """sampled / knn / knn_toh: [(.., 64), (.., 8)] at the two scales;
        ctx (.., 4) = [sdf, vis, vis_this, vis_other]."""
        out = []
        for s, (at, ated) in enumerate(((self.fconv_at, self.fconv_ated),
                                        (self.fconv_at1, self.fconv_ated1))):
            parts = [sampled[s], knn[s], knn_toh[s]]
            g = pointwise(at, torch.cat(parts + [ctx], -1))
            out.append(pointwise(ated, torch.cat(
                [p * g[..., i:i + 1] for i, p in enumerate(parts)] + [ctx],
                -1)))
        return out


class Pool3(nn.Module):
    """Adaptive average pool to 3 x 3 (torch's bins)."""

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, 3)


def global_ctx(cin, hw):
    return nn.Sequential(
        nn.Conv2d(cin, 21, 3, padding=1, bias=False),
        nn.LayerNorm(list(hw), eps=1e-6), nn.ReLU(),
        nn.Conv2d(21, 42, 3, padding=1, bias=False),
        nn.LayerNorm(list(hw), eps=1e-6), nn.ReLU(), Pool3())


class TexVisFusion(nn.Module):
    def __init__(self, num_v: int, hw3, hw4):
        super().__init__()
        self.fconv = fuse(96, 96, 40)
        self.fconv_at = gate(96, 96, 6)
        self.fconv_gt = nn.Sequential(
            nn.Conv1d(42, num_v, 3, padding=1, bias=False),
            nn.LayerNorm(18, eps=1e-6), nn.ReLU(),
            nn.Conv1d(num_v, 2 * num_v, 3, padding=1, bias=False),
            nn.LayerNorm(18, eps=1e-6), nn.ReLU())
        self.fconv3 = global_ctx(8, hw3)
        self.fconv4 = global_ctx(3, hw4)

    def global_feature(self, tex, img):
        """(n, 2 num_v, 18) global context of the texture map and image."""
        g = torch.cat([self.fconv4(img.permute(0, 3, 1, 2)).flatten(2),
                       self.fconv3(tex.permute(0, 3, 1, 2)).flatten(2)], -1)
        return self.fconv_gt(g)

    def forward(self, q, k, k_toh, kg, kg_toh, latent, vis_ctx):
        parts = [q, k, k_toh, kg, kg_toh, latent]
        g = pointwise(self.fconv_at, torch.cat(parts + [vis_ctx], -1))
        return pointwise(self.fconv, torch.cat(
            [p * g[..., i:i + 1] for i, p in enumerate(parts)] + [vis_ctx],
            -1))


class IBRHead(nn.Module):
    """IBRNet-style colour blend over the source views."""

    def __init__(self, cin: int = 37):
        super().__init__()
        ch = cin + 3
        self.ani_al = nn.Parameter(torch.tensor(0.2))
        self.ray_encoder = nn.Sequential(nn.Linear(4, 16), nn.ELU(),
                                         nn.Linear(16, ch), nn.ELU())
        self.base_layer = nn.Sequential(nn.Linear(ch * 3, 64), nn.ELU(),
                                        nn.Linear(64, 32), nn.ELU())
        self.vis_layer1 = nn.Sequential(nn.Linear(32, 32), nn.ELU(),
                                        nn.Linear(32, 33), nn.ELU())
        self.vis_layer2 = nn.Sequential(nn.Linear(32, 32), nn.ELU(),
                                        nn.Linear(32, 1), nn.Sigmoid())
        self.out_layer = nn.Sequential(nn.Linear(37, 16), nn.ELU(),
                                       nn.Linear(16, 8), nn.ELU(),
                                       nn.Linear(8, 1))

    def forward(self, feats, dirs, mask):
        """feats (R, V, C), dirs (R, V, 4), mask (R, V, 1) -> (R, 3)."""
        d = self.ray_encoder(dirs)
        ch = d.shape[-1]
        rgb = feats[..., :3]
        feats = torch.cat([feats[..., :ch] + d, feats[..., ch:]], -1)
        e = torch.exp(self.ani_al.abs() * (dirs[..., 3:4] - 1.0))
        w = (e - e.amin(1, keepdim=True)) * mask
        w = w / (w.sum(1, keepdim=True) + 1e-8)
        mean = (feats * w).sum(1, keepdim=True)
        var = (w * (feats - mean) ** 2).sum(1, keepdim=True)
        x = torch.cat([torch.cat([mean, var], -1).expand(-1, feats.shape[1],
                                                         -1), feats], -1)
        x = self.base_layer(x)
        pv = self.vis_layer1(x * w)
        x = x + pv[..., :-1]
        vis = self.vis_layer2(x * torch.sigmoid(pv[..., -1:]) * mask) * mask
        o = self.out_layer(torch.cat([x, vis, dirs], -1))
        o = o.masked_fill(mask == 0, -1e4)
        return (rgb * torch.softmax(o, 1)).sum(1)


class Generator(nn.Module):
    """VANeRF's parameters under the reference checkpoint's names."""

    def __init__(self, m: dict, num_v: int = 779, hw=(256, 256)):
        super().__init__()
        sp, g, t = m["sp_args"], m["geo_args"], m["tex_args"]
        mg = m["mlp_geo_args"]
        if (sp["sp_type"] != "rel_z_decay" or m.get("sp_conv")
                or mg.get("nl_layer") != "softplus"
                or list(mg.get("pool_types")) != ["mean", "var"]
                or t.get("norm") != "instance" or g.get("n_stack", 1) != 1
                or g.get("hd") or m.get("compute_dtype", "float32")
                != "float32"):
            raise NotImplementedError("the reference holds the shipped "
                                      "VANeRF configuration only")
        self.sp = sp
        self.num_v = num_v
        self.ds_geo, self.ds_tex = m.get("ds_geo", 0), m.get("ds_tex", 0)
        self.sigmoid_beta = nn.Parameter(torch.full((1,), 0.1))
        self.geo_encoder = HGFilter(g["n_downsample"], g["out_ch"])
        self.tex_encoder = ResBlkEncoder(t["out_ch"], t["ngf"],
                                         t["n_downsample"], t["n_blocks"],
                                         t["n_upsample"])
        d1 = list(mg["n_dims1"])
        d1[0] = (1 + 2 * sp["sp_level"]) * sp["n_kpt"]
        self.mlp_geo = MLPUNetFusion(d1, mg["n_dims2"], mg["skip_dims"],
                                     mg["skip_layers"])
        self.geo_vis_fusion = GeoVisFusion()
        th = (hw[0] >> self.ds_tex >> t["n_downsample"]) << t["n_upsample"]
        tw = (hw[1] >> self.ds_tex >> t["n_downsample"]) << t["n_upsample"]
        self.tex_vis_fusion = TexVisFusion(num_v, (th, tw), hw)
        gc = m["mlp_tex_args"]["gcompress"]
        self.ibr_compress_gfeat = nn.Linear(2 * d1[-1], gc["out_ch"])
        self.mlp_tex = IBRHead()

    def encode(self, im: torch.Tensor):
        """(n, H, W, 3) in [0, 1] -> [coarse, fine] geometry maps, texture
        map."""
        g, t = im, im
        for _ in range(self.ds_geo):
            g = F.avg_pool2d(g.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        for _ in range(self.ds_tex):
            t = F.avg_pool2d(t.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return self.geo_encoder(2 * g - 1), self.tex_encoder(2 * t - 1)
