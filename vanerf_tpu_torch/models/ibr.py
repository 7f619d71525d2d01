"""IBRNet-style colour head (port of ``vanerf_tpu/models/ibr.py``;
reference ``IBRRenderingHead``, ``src/model.py:1572-1636``)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


class IBRRenderingHead(nn.Module):
    def __init__(self, in_channels: int = 37):
        super().__init__()
        ch = in_channels + 3
        self.ani_al = nn.Parameter(torch.tensor(0.2))
        self.ray_encoder = nn.Sequential(
            nn.Linear(4, 16), nn.ELU(), nn.Linear(16, ch), nn.ELU())
        self.base_layer = nn.Sequential(
            nn.Linear(ch * 3, 64), nn.ELU(), nn.Linear(64, 32), nn.ELU())
        self.vis_layer1 = nn.Sequential(
            nn.Linear(32, 32), nn.ELU(), nn.Linear(32, 33), nn.ELU())
        self.vis_layer2 = nn.Sequential(
            nn.Linear(32, 32), nn.ELU(), nn.Linear(32, 1), nn.Sigmoid())
        self.out_layer = nn.Sequential(
            nn.Linear(32 + 1 + 4, 16), nn.ELU(), nn.Linear(16, 8), nn.ELU(),
            nn.Linear(8, 1))

    def forward(self, rgb_feats, ray_diffs, proj_mask):
        """rgb_feats (R, S, V, C >= 3, rgb first); ray_diffs (R, S, V, 4);
        proj_mask (R, S, V, 1).  Returns the (R, S, 3) blended colour."""
        V = rgb_feats.shape[2]
        dir_feat = self.ray_encoder(ray_diffs)
        ch = dir_feat.shape[-1]
        src_rgb = rgb_feats[..., :3]
        rgb_feats = torch.cat([rgb_feats[..., :ch] + dir_feat,
                               rgb_feats[..., ch:]], -1)
        exp_dot = torch.exp(self.ani_al.abs() * (ray_diffs[..., 3:4] - 1.0))
        weight = (exp_dot - exp_dot.amin(2, keepdim=True)) * proj_mask
        weight = weight / (weight.sum(2, keepdim=True) + 1e-8)
        mean = (rgb_feats * weight).sum(2, keepdim=True)
        var = (weight * (rgb_feats - mean) ** 2).sum(2, keepdim=True)
        fused = torch.cat([mean, var], -1)
        x = torch.cat([fused.expand(-1, -1, V, -1), rgb_feats], -1)
        x = self.base_layer(x)
        pv = self.vis_layer1(x * weight)
        res, vis = pv[..., :-1], pv[..., -1:]
        x = x + res
        vis = self.vis_layer2(x * torch.sigmoid(vis) * proj_mask) * proj_mask
        o = self.out_layer(torch.cat([x, vis, ray_diffs], -1))
        o = torch.where(proj_mask == 0, torch.full_like(o, -1e4), o)
        blend = F.softmax(o, dim=2)
        return (src_rgb * blend).sum(2)
