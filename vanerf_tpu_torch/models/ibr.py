"""IBRNet-style colour head (port of ``vanerf_tpu/models/ibr.py``;
reference ``IBRRenderingHead``, ``src/model.py:1572-1636``).

Every layer computes in ``rgb_feats``' dtype
(``vanerf_tpu/models/ibr.py:39-79``); the anisotropy weights and the
softmax blend run in float32 and are cast back, as in the JAX package (in
float64 where the model runs in it: float32 at the least).  In
bfloat16 a layer rounds its product and then its sum with the bias, as
flax's ``Dense(dtype=bfloat16)`` does (``models/mlp.py::dense``).  The
model blends two or more source views with it; at one view the blend is
the identity on the fused rgb and the model skips the head unless
``VANERF_IBR_V1_SHORTCUT=0`` (``VANeRF._query_color``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .mlp import run_seq, sigmoid


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
        dt = rgb_feats.dtype
        wide = torch.promote_types(dt, torch.float32)
        ray_diffs, proj_mask = ray_diffs.to(dt), proj_mask.to(dt)
        dir_feat = run_seq(self.ray_encoder, ray_diffs)
        ch = dir_feat.shape[-1]
        src_rgb = rgb_feats[..., :3]
        rgb_feats = torch.cat([rgb_feats[..., :ch] + dir_feat,
                               rgb_feats[..., ch:]], -1)
        exp_dot = torch.exp(self.ani_al.abs()
                            * (ray_diffs[..., 3:4].to(wide) - 1.0))
        weight = (exp_dot - exp_dot.amin(2, keepdim=True)) * proj_mask.to(wide)
        weight = (weight / (weight.sum(2, keepdim=True) + 1e-8)).to(dt)
        mean = (rgb_feats * weight).sum(2, keepdim=True)
        var = (weight * (rgb_feats - mean) ** 2).sum(2, keepdim=True)
        fused = torch.cat([mean, var], -1)
        x = torch.cat([fused.expand(-1, -1, V, -1), rgb_feats], -1)
        x = run_seq(self.base_layer, x)
        pv = run_seq(self.vis_layer1, x * weight)
        res, vis = pv[..., :-1], pv[..., -1:]
        x = x + res
        vis = run_seq(self.vis_layer2,
                      x * sigmoid(vis) * proj_mask) * proj_mask
        o = run_seq(self.out_layer, torch.cat([x, vis, ray_diffs], -1))
        # the blend in float32: masked -1e4 logits underflow in bfloat16
        o = torch.where(proj_mask == 0, torch.full_like(o.to(wide), -1e4),
                        o.to(wide))
        blend = F.softmax(o, dim=2).to(dt)
        return (src_rgb * blend).sum(2)
