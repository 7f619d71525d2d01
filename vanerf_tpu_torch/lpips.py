"""LPIPS (AlexNet backbone), the eval-only perceptual metric (port of
``vanerf_tpu/lpips.py``).

Parity target: ``lpips.LPIPS(net='alex')`` as the reference evaluator uses
it (``src/evaluator.py:11,47-64``).  The weights are the npz that
``tools/convert_lpips.py`` writes (backbone convs + linear calibration
heads); at eval time ``VANERF_LPIPS_NPZ`` names it.  The convolutions are
``F.conv2d``, as the JAX package computes them outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

# AlexNet feature extractor: (out_ch, kernel, stride, pad) per conv
_ALEX = [(64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1),
         (256, 3, 1, 1), (256, 3, 1, 1)]
_POOL_AFTER = {0, 1}          # 3x3 / 2 max pool after convs 0 and 1

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    """LPIPS-Alex from a ``tools/convert_lpips.py`` npz; ``forward`` takes
    two (H, W, 3) images in [0, 1] and returns the distance as a float."""

    def __init__(self, npz_path: str):
        super().__init__()
        raw = dict(np.load(npz_path))

        def T(x):
            return torch.from_numpy(np.asarray(x, np.float32).copy())

        for i in range(5):
            self.register_buffer(f"conv{i}_weight", T(raw[f"conv{i}.weight"]))
            self.register_buffer(f"conv{i}_bias", T(raw[f"conv{i}.bias"]))
            self.register_buffer(f"lin{i}_weight",
                                 T(raw[f"lin{i}.weight"]).reshape(-1))
        self.register_buffer("shift", torch.tensor(_SHIFT)[None, :, None,
                                                            None])
        self.register_buffer("scale", torch.tensor(_SCALE)[None, :, None,
                                                            None])

    def _features(self, x):
        """x: (1, 3, H, W) scaled to [-1, 1]."""
        x = (x - self.shift) / self.scale
        feats = []
        for i, (_ch, _k, s, p) in enumerate(_ALEX):
            x = F.relu(F.conv2d(x, getattr(self, f"conv{i}_weight"),
                                getattr(self, f"conv{i}_bias"), stride=s,
                                padding=p))
            feats.append(x)
            if i in _POOL_AFTER:
                x = F.max_pool2d(x, 3, 2)
        return feats

    @torch.no_grad()
    def forward(self, img0, img1) -> float:
        dev = self.shift.device

        def prep(img):
            t = torch.as_tensor(np.asarray(img, np.float32), device=dev)
            return t.permute(2, 0, 1)[None] * 2.0 - 1.0

        fa, fb = self._features(prep(img0)), self._features(prep(img1))
        total = 0.0
        for i, (x, y) in enumerate(zip(fa, fb)):
            xn = x / (torch.linalg.norm(x, dim=1, keepdim=True) + 1e-10)
            yn = y / (torch.linalg.norm(y, dim=1, keepdim=True) + 1e-10)
            w = getattr(self, f"lin{i}_weight")[None, :, None, None]
            total = total + ((xn - yn) ** 2 * w).sum(1).mean()
        return float(total)
