"""Visibility-aware GAN discriminator and the GAN losses (port of
``vanerf_tpu/models/discriminator.py``; reference ``Discriminator_vis``,
``d_logistic_loss``, ``d_r1_loss``, ``g_nonsaturating_loss``,
``src/networks.py:535-601``).

The module tree carries the reference checkpoint's key names
(``fconv3`` / ``fconv4`` / ``fconv2`` / ``linear``); inputs and outputs
are channels-last like the JAX package's.  The GAN losses are softplus of
the sigmoid-headed outputs, as the reference writes them.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class DiscriminatorVis(nn.Module):
    """Global real/fake score + per-pixel visibility prediction.

    forward(input_img, input_densepose, tar_densepose, pred), each
    (B, H, W, 3) -> gan_pred (B, 1) in (0, 1), vis_map (B, H, W, 1) in
    (0, 1).
    """

    def __init__(self):
        super().__init__()
        self.fconv3 = nn.Sequential(
            nn.Conv2d(12, 10, 3, padding=1), nn.ReLU(),
            nn.Conv2d(10, 10, 3, padding=1), nn.ReLU(),
            nn.AdaptiveAvgPool2d(1))
        self.fconv4 = nn.Sequential(
            nn.Conv2d(12, 20, 3, padding=1), nn.ReLU(),
            nn.Conv2d(20, 20, 3, padding=1), nn.ReLU(),
            nn.Conv2d(20, 12, 3, padding=1))
        self.fconv2 = nn.Sequential(
            nn.Conv2d(24, 30, 3, padding=1), nn.ReLU(),
            nn.Conv2d(30, 20, 3, padding=1), nn.ReLU(),
            nn.Conv2d(20, 1, 3, padding=1), nn.Sigmoid())
        self.linear = nn.Sequential(
            nn.Linear(10, 3), nn.ReLU(), nn.Linear(3, 1), nn.Sigmoid())

    def forward(self, input_img, input_densepose, tar_densepose, pred):
        img = torch.cat([input_img, input_densepose, tar_densepose, pred],
                        -1).permute(0, 3, 1, 2)
        gan = self.linear(self.fconv3(img).flatten(1))
        vis = self.fconv2(torch.cat([img, self.fconv4(img)], 1))
        return gan, vis.permute(0, 2, 3, 1)


def d_logistic_loss(real_pred, fake_pred):
    """softplus(-real) + softplus(fake) (``networks.py:584-588``)."""
    return F.softplus(-real_pred).mean() + F.softplus(fake_pred).mean()


def g_nonsaturating_loss(fake_pred):
    """softplus(-fake) (``networks.py:599-601``)."""
    return F.softplus(-fake_pred).mean()


def d_r1_loss(real_pred, real_img, create_graph: bool = True):
    """R1 penalty ||d D(real) / d real||^2, summed per sample and averaged
    (``networks.py:591-597``).  ``real_img`` must require grad and
    ``real_pred`` be computed from it."""
    (grad,) = torch.autograd.grad(real_pred.sum(), real_img,
                                  create_graph=create_graph)
    return grad.pow(2).reshape(grad.shape[0], -1).sum(1).mean()


def bce_loss(pred, target, eps: float = 1e-7):
    """Elementwise binary cross entropy on probabilities, clipped to
    [eps, 1 - eps] (``nn.BCELoss`` as used at ``model.py:399-402``)."""
    p = pred.clamp(eps, 1.0 - eps)
    return -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
