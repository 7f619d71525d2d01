"""Losses: pixel losses, SSIM, PSNR and the VGG19 perceptual loss (port of
``vanerf_tpu/losses.py``; reference ``pix_loss`` / ``compute_error_nerf``
/ ``compute_error``, ``src/utils.py:159-328``, and ``VGGLoss``,
``utils.py:882-937``).

Images are channels-last (B, H, W, C).  The VGG19 feature stack carries
the reference's module names (``vgg_net.slice1`` .. ``slice4`` holding
torchvision's ``features`` indices); its weights load from
``VANERF_VGG19_NPZ`` (the file ``tools/convert_vgg.py`` writes) or are
given by the caller — :func:`vanerf_tpu_torch.weights.vgg_from_jax_params`
carries the JAX package's fixed-seed stand-in across.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# --------------------------------------------------------------------------
# pixel losses (utils.py:293-328)
# --------------------------------------------------------------------------


def pix_loss(src: torch.Tensor, tar: torch.Tensor,
             w_losses: Dict[str, float]) -> Dict[str, torch.Tensor]:
    """Weighted pixel losses on (B, H, W, C) images."""
    losses = {}
    for k, v in w_losses.items():
        if v <= 0.0:
            continue
        if k == "l1":
            losses[k] = v * (src - tar).abs().mean()
        elif k == "l2":
            losses[k] = v * ((src - tar) ** 2).mean()
        elif k == "lp":
            losses[k] = v * (((src - tar).abs() + 1e-4) ** 0.4).mean()
        elif k == "ssim":
            losses[k] = v * (1.0 - ssim(src, tar).mean())
        elif "l1top" in k or "l2top" in k:
            ratio = float(k[5:]) / 100.0
            d = (src - tar).abs() if "l1" in k else (src - tar) ** 2
            d = d.sum(-1).reshape(src.shape[0], -1)
            kk = max(int(d.shape[1] * ratio), 1)
            losses[k] = v * torch.topk(d, kk, dim=1).values.mean()
    return losses


# --------------------------------------------------------------------------
# SSIM and PSNR
# --------------------------------------------------------------------------

def _avg_filter(img: torch.Tensor, win: int) -> torch.Tensor:
    """Depthwise win x win box filter, valid region, on (B, H, W, C)."""
    C = img.shape[-1]
    k = torch.full((C, 1, win, win), 1.0 / (win * win), dtype=img.dtype,
                   device=img.device)
    out = F.conv2d(img.permute(0, 3, 1, 2), k, groups=C)
    return out.permute(0, 2, 3, 1)


def ssim(img0: torch.Tensor, img1: torch.Tensor, win: int = 7,
         max_val: float = 1.0) -> torch.Tensor:
    """Per-pixel SSIM map with a box window (valid region), (B, H', W', C)."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    mu0 = _avg_filter(img0, win)
    mu1 = _avg_filter(img1, win)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    s00 = _avg_filter(img0 * img0, win) - mu00
    s11 = _avg_filter(img1 * img1, win) - mu11
    s01 = _avg_filter(img0 * img1, win) - mu01
    num = (2 * mu01 + c1) * (2 * s01 + c2)
    den = (mu00 + mu11 + c1) * (s00 + s11 + c2)
    return num / den


def psnr(img0: torch.Tensor, img1: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """PSNR over the full tensor (``evaluator.py:15-19``)."""
    mse = ((img0 - img1) ** 2).mean()
    return -10.0 * torch.log(mse / (max_val ** 2)) / np.log(10.0)


# --------------------------------------------------------------------------
# VGG19 perceptual loss
# --------------------------------------------------------------------------

# torchvision vgg19 ``features`` index -> the JAX package's layer name
VGG_LAYERS = {0: "conv1_1", 2: "conv1_2", 5: "conv2_1", 7: "conv2_2",
              10: "conv3_1", 12: "conv3_2", 14: "conv3_3", 16: "conv3_4",
              19: "conv4_1"}
_VGG_CH = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128),
           10: (128, 256), 12: (256, 256), 14: (256, 256), 16: (256, 256),
           19: (256, 512)}
_VGG_SLICES = (("slice1", 0, 2), ("slice2", 2, 7), ("slice3", 7, 12),
               ("slice4", 12, 21))


def vgg_slice_key(idx: int) -> str:
    """State-dict prefix of the conv at torchvision ``features`` index."""
    for name, lo, hi in _VGG_SLICES:
        if lo <= idx < hi:
            return f"{name}.{idx}"
    raise KeyError(idx)


class Vgg19Features(nn.Module):
    """VGG19 ``features[0:21]`` split into the reference's four slices
    (relu1_1, relu2_1, relu3_1, relu4_1).  forward: NCHW -> 4 maps."""

    def __init__(self):
        super().__init__()
        for name, lo, hi in _VGG_SLICES:
            s = nn.Sequential()
            for i in range(lo, hi):
                if i in _VGG_CH:
                    s.add_module(str(i), nn.Conv2d(*_VGG_CH[i], 3, padding=1))
                elif i in (4, 9, 18):
                    s.add_module(str(i), nn.MaxPool2d(2))
                else:
                    s.add_module(str(i), nn.ReLU())
            self.add_module(name, s)

    def forward(self, x):
        outs = []
        for name, _, _ in _VGG_SLICES:
            x = getattr(self, name)(x)
            outs.append(x)
        return outs


_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def load_vgg_npz(path: str) -> Dict[str, torch.Tensor]:
    """A ``tools/convert_vgg.py`` file (``{layer}.kernel`` HWIO,
    ``{layer}.bias``) -> a :class:`Vgg19Features` state_dict."""
    raw = dict(np.load(path))
    sd = {}
    for idx, name in VGG_LAYERS.items():
        key = vgg_slice_key(idx)
        sd[f"{key}.weight"] = torch.from_numpy(np.ascontiguousarray(
            np.transpose(raw[f"{name}.kernel"], (3, 2, 0, 1)),
            dtype=np.float32))
        sd[f"{key}.bias"] = torch.from_numpy(
            np.asarray(raw[f"{name}.bias"], np.float32))
    return sd


class VGGLoss(nn.Module):
    """4-slice VGG19 L1 feature-matching loss (``utils.py:917-937``):
    ImageNet normalisation, slice weights 1/16, 1/8, 1/4, 1, and no
    gradient through the target's features.

    ``state_dict``: the feature stack's weights; without it they load from
    ``VANERF_VGG19_NPZ``, and without that the caller must load them (the
    port has no random fallback of its own: the JAX package's fixed-seed
    stand-in comes across through ``weights.vgg_from_jax_params``).
    """

    weights = (1.0 / 16, 1.0 / 8, 1.0 / 4, 1.0)

    def __init__(self, state_dict: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.vgg_net = Vgg19Features()
        self.pretrained = False
        if state_dict is None:
            path = os.environ.get("VANERF_VGG19_NPZ", "")
            if path and os.path.exists(path):
                state_dict = load_vgg_npz(path)
                self.pretrained = True
        if state_dict is not None:
            self.vgg_net.load_state_dict(state_dict, strict=True)
        self.vgg_net.requires_grad_(False)
        self.register_buffer("mean", torch.tensor(_IMAGENET_MEAN))
        self.register_buffer("std", torch.tensor(_IMAGENET_STD))

    def forward(self, x, y):
        """L1 distance between feature slices of (B, H, W, 3) images."""
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        y = ((y - self.mean) / self.std).permute(0, 3, 1, 2)
        fx = self.vgg_net(x)
        fy = self.vgg_net(y)
        loss = 0.0
        for w, a, b in zip(self.weights, fx, fy):
            loss = loss + w * (a - b.detach()).abs().mean()
        return loss


# --------------------------------------------------------------------------
# total generator reconstruction error (utils.py:219-291)
# --------------------------------------------------------------------------

def compute_error_nerf(out_nerf: Dict[str, torch.Tensor], lambdas: Dict,
                       vggloss: Optional[VGGLoss]) -> Dict[str, torch.Tensor]:
    err = {}
    l_l1_c = lambdas.get("lambda_l1_c", 10.0)
    l_aux = lambdas.get("lambda_aux", 1.0)
    l_mloss = lambdas.get("lambda_mloss", 0.0)
    pix_weights = {"l1": lambdas.get("lambda_l1", 10.0),
                   "l2": lambdas.get("lambda_l2", 0.0),
                   "lp": lambdas.get("lambda_lp", 0.0),
                   "ssim": lambdas.get("lambda_ssim", 0.0)}

    loss_pix_c = 0.0
    if "tex_cal" in out_nerf and l_l1_c > 0.0:
        loss_pix_c += pix_loss(out_nerf["tex_cal"], out_nerf["tar_img"],
                               {"l1": l_l1_c})["l1"]
    if "tex_aux_cal" in out_nerf and l_l1_c > 0.0 and l_aux > 0.0:
        loss_pix_c += l_aux * pix_loss(
            out_nerf["tex_aux_cal"], out_nerf["tar_img"], {"l1": l_l1_c})["l1"]
    if not isinstance(loss_pix_c, float):
        err["e_pix_c"] = loss_pix_c

    if "tex_cal_fine" in out_nerf:
        for k, v in pix_loss(out_nerf["tex_cal_fine"], out_nerf["tar_img"],
                             pix_weights).items():
            err[f"e_pix_{k}"] = v

    for key, mk in (("alpha", "mask_loss_c"), ("alpha_fine", "mask_loss_f")):
        if l_mloss > 0.0 and key in out_nerf and "tar_alpha" in out_nerf:
            ta = out_nerf["tar_alpha"].reshape(out_nerf[key].shape)
            err[mk] = l_mloss * ((out_nerf[key].clamp(-0.001, 1.0) - ta)
                                 ** 2).mean()

    if vggloss is not None:
        l_vgg = lambdas.get("lambda_vgg", 1.0)
        loss_vgg = 0.0
        for key in ("tex_cal", "tex_cal_fine"):
            if key in out_nerf:
                loss_vgg += l_vgg * vggloss(out_nerf[key],
                                            out_nerf["tar_img"])
        if not isinstance(loss_vgg, float):
            err["e_vgg"] = loss_vgg
    return err


def compute_error(out_nerf: Dict[str, torch.Tensor], lambdas: Dict,
                  vggloss: Optional[VGGLoss]):
    """Total loss + error dict (``utils.py:159-178``)."""
    err = compute_error_nerf(out_nerf, lambdas, vggloss)
    loss = 0.0
    for v in err.values():
        loss = loss + v
    err["e_all"] = loss
    return loss, err
