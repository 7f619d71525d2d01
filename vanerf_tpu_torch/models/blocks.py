"""Convolutional encoders (port of ``vanerf_tpu/models/blocks.py``).

Module trees and attribute names follow the reference checkpoint
(``HGFilterV2`` / ``HourGlass`` / ``ConvBlock`` / ``ResBlkEncoder``,
reference ``src/utils.py:331-607``), so ``state_dict()`` keys are the
reference's.  Inside, convolutions run NCHW; the encoders' public
``forward`` takes and returns channels-last (B, H, W, C) tensors like the
JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(min(32, ch), ch, eps=1e-5)


def instance_norm(ch: int) -> nn.InstanceNorm2d:
    """Per-sample, per-channel norm without affine (torch default)."""
    return nn.InstanceNorm2d(ch, eps=1e-5)


def get_norm(norm: str, ch: int) -> nn.Module:
    """The JAX package's ``get_norm`` (``vanerf_tpu/models/blocks.py:
    36-43``): ``group`` (min(32, ch) groups, eps 1e-5, a scale and a bias
    a channel), ``instance`` or ``none`` (the identity, holding the norm's
    place in the module tree)."""
    if norm == "group":
        return group_norm(ch)
    if norm == "instance":
        return instance_norm(ch)
    if norm in (None, "none"):
        return nn.Identity()
    raise NotImplementedError(f"norm {norm}")


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool of an NHWC tensor."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


def _cubic_kernel(s, a=-0.75):
    s = abs(s)
    if s <= 1:
        return (a + 2) * s ** 3 - (a + 3) * s ** 2 + 1
    if s < 2:
        return a * s ** 3 - 5 * a * s ** 2 + 8 * a * s - 4 * a
    return 0.0


@functools.lru_cache(maxsize=32)
def _bicubic_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) align-corners cubic interpolation matrix (kernel
    a=-0.75, replicated borders) — the JAX package's matrix
    (``blocks.py:68-82``)."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    for o in range(n_out):
        x = o * scale
        x0 = int(np.floor(x))
        for k in range(-1, 3):
            idx = min(max(x0 + k, 0), n_in - 1)
            m[o, idx] += _cubic_kernel(x - (x0 + k))
    return m


def upsample2_bicubic(x: torch.Tensor) -> torch.Tensor:
    """2x bicubic upsampling, align_corners=True, of an NCHW tensor as two
    small matrix products (the exact separable form; torch's own bicubic
    kernel deviates by ~0.3%)."""
    _, _, H, W = x.shape
    mh = torch.as_tensor(_bicubic_matrix_np(H, 2 * H), dtype=x.dtype,
                         device=x.device)
    mw = torch.as_tensor(_bicubic_matrix_np(W, 2 * W), dtype=x.dtype,
                         device=x.device)
    return torch.matmul(torch.matmul(mh, x), mw.t())


class ConvBlock(nn.Module):
    """Pre-activation multi-scale residual block (utils.py:549-607), NCHW."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn1 = group_norm(in_planes)
        self.conv1 = nn.Conv2d(in_planes, out_planes // 2, 3, padding=1,
                               bias=False)
        self.bn2 = group_norm(out_planes // 2)
        self.conv2 = nn.Conv2d(out_planes // 2, out_planes // 4, 3,
                               padding=1, bias=False)
        self.bn3 = group_norm(out_planes // 4)
        self.conv3 = nn.Conv2d(out_planes // 4, out_planes // 4, 3,
                               padding=1, bias=False)
        if in_planes != out_planes:
            self.bn4 = group_norm(in_planes)
            self.downsample = nn.Sequential(
                self.bn4, nn.ReLU(),
                nn.Conv2d(in_planes, out_planes, 1, bias=False))
        else:
            self.downsample = None

    def forward(self, x):
        o1 = self.conv1(F.relu(self.bn1(x)))
        o2 = self.conv2(F.relu(self.bn2(o1)))
        o3 = self.conv3(F.relu(self.bn3(o2)))
        out = torch.cat([o1, o2, o3], 1)
        res = x if self.downsample is None else self.downsample(x)
        return out + res


class HourGlass(nn.Module):
    """Recursive encoder-decoder at constant width (utils.py:393-442)."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.depth = depth
        for lv in range(depth, 0, -1):
            self.add_module(f"b1_{lv}", ConvBlock(features, features))
            self.add_module(f"b2_{lv}", ConvBlock(features, features))
            if lv == 1:
                self.add_module(f"b2_plus_{lv}",
                                ConvBlock(features, features))
            self.add_module(f"b3_{lv}", ConvBlock(features, features))

    def _level(self, lv, inp):
        up1 = self._modules[f"b1_{lv}"](inp)
        low1 = self._modules[f"b2_{lv}"](F.avg_pool2d(inp, 2, 2))
        if lv > 1:
            low2 = self._level(lv - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{lv}"](low1)
        low3 = self._modules[f"b3_{lv}"](low2)
        return up1 + upsample2_bicubic(low3)

    def forward(self, x):
        return self._level(self.depth, x)


class DeconvReLUGroup(nn.Module):
    """Stride-2 transposed conv + GroupNorm + ReLU (utils.py:444-453)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(in_ch, out_ch, 3, stride=2, padding=1,
                                       output_padding=1, bias=False)
        self.norm = group_norm(out_ch)

    def forward(self, x):
        return F.relu(self.norm(self.conv(x)))


class HGFilter(nn.Module):
    """Stacked-hourglass geometry encoder (HGFilterV2, utils.py:455-547).

    forward: (B, H, W, 3) in [-1, 1] -> [coarse (B, H/4, W/4, out_ch),
    fine (B, H, W, out_ch_hd)], channels-last.
    """

    def __init__(self, n_stack: int = 1, n_downsample: int = 4,
                 out_ch: int = 64, out_ch_hd: int = 8, hd: bool = False):
        super().__init__()
        self.n_stack = n_stack
        self.hd = hd
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.bn1 = group_norm(64)
        self.conv2 = ConvBlock(64, 128)
        self.unpack1 = DeconvReLUGroup(128, 32)
        self.conv_out = nn.Conv2d(32, out_ch_hd, 5, padding=2)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        for i in range(n_stack):
            self.add_module(f"m{i}", HourGlass(n_downsample, 256))
            self.add_module(f"top_m_{i}", ConvBlock(256, 256))
            self.add_module(f"conv_last{i}", nn.Conv2d(256, 256, 1))
            self.add_module(f"bn_end{i}", group_norm(256))
            self.add_module(f"l{i}", nn.Conv2d(256, out_ch, 1))
            if i < n_stack - 1:
                self.add_module(f"bl{i}", nn.Conv2d(256, 256, 1))
                self.add_module(f"al{i}", nn.Conv2d(out_ch, 256, 1))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        x = F.relu(self.bn1(self.conv1(x)))
        x = self.conv2(x)
        x_hd = self.conv_out(self.unpack1(x))
        if not self.hd:
            x = F.avg_pool2d(x, 2, 2)
        x = self.conv4(self.conv3(x))
        previous = x
        out = None
        for i in range(self.n_stack):
            hg = self._modules[f"m{i}"](previous)
            ll = self._modules[f"top_m_{i}"](hg)
            ll = F.relu(self._modules[f"bn_end{i}"](
                self._modules[f"conv_last{i}"](ll)))
            out = self._modules[f"l{i}"](ll)
            if i < self.n_stack - 1:
                previous = (previous + self._modules[f"bl{i}"](ll)
                            + self._modules[f"al{i}"](out))
        return [out.permute(0, 2, 3, 1), x_hd.permute(0, 2, 3, 1)]


class ReplicationPad2d(nn.Module):
    """``nn.ReplicationPad2d(p)`` as edge slices expanded and concatenated:
    the same values, and a backward without atomics (torch's
    ``replication_pad2d_backward_cuda`` adds the border gradients with
    them, so a train step did not repeat to the bit on the card)."""

    def __init__(self, p: int):
        super().__init__()
        self.p = p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.p
        x = torch.cat([x[..., :1].expand(*x.shape[:-1], p), x,
                       x[..., -1:].expand(*x.shape[:-1], p)], -1)
        rows = (*x.shape[:-2], p, x.shape[-1])
        return torch.cat([x[..., :1, :].expand(rows), x,
                          x[..., -1:, :].expand(rows)], -2)


class ResBlk(nn.Module):
    """Residual block with replication padding (utils.py:331-346)."""

    def __init__(self, ch: int, norm: str = "instance"):
        super().__init__()
        self.layers = nn.Sequential(
            ReplicationPad2d(1), nn.Conv2d(ch, ch, 3), get_norm(norm, ch),
            nn.ReLU(), ReplicationPad2d(1), nn.Conv2d(ch, ch, 3),
            get_norm(norm, ch))

    def forward(self, x):
        return x + self.layers(x)


class ResBlkEncoder(nn.Module):
    """Texture encoder: conv down -> res blocks -> deconv up
    (utils.py:348-377).  forward: (B, H, W, 3) -> (B, H', W', out_ch),
    channels-last; the shipped config maps H to H/2.  ``norm`` is
    :func:`get_norm`'s: with ``group`` the norms' scales and biases are
    parameters under the reference checkpoint's keys (``layers.<i>``)."""

    def __init__(self, in_ch: int = 3, out_ch: int = 8, ngf: int = 16,
                 n_downsample: int = 3, n_blocks: int = 4,
                 n_upsample: int = 3, norm: str = "instance"):
        super().__init__()
        layers = [ReplicationPad2d(3), nn.Conv2d(in_ch, ngf, 7),
                  get_norm(norm, ngf), nn.ReLU()]
        for i in range(n_downsample):
            m = 2 ** i
            layers += [nn.Conv2d(ngf * m, ngf * m * 2, 3, stride=2,
                                 padding=1),
                       get_norm(norm, ngf * m * 2), nn.ReLU()]
        m = 2 ** n_downsample
        layers += [ResBlk(ngf * m, norm) for _ in range(n_blocks)]
        for i in range(n_upsample):
            m = 2 ** (n_downsample - i)
            layers += [nn.ConvTranspose2d(ngf * m, ngf * m // 2, 3, stride=2,
                                          padding=1, output_padding=1),
                       get_norm(norm, ngf * m // 2), nn.ReLU()]
        if n_upsample > 0:
            layers += [ReplicationPad2d(3),
                       nn.Conv2d(ngf * m // 2, out_ch, 7)]
        self.layers = nn.Sequential(*layers)

    def forward(self, x):
        return self.layers(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
