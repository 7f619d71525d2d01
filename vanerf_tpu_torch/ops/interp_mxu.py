"""Small-map bilinear sampler (port of ``vanerf_tpu/ops/interp_mxu.py``).

:func:`mxu_grid_sample` is kernel D (``csrc/interp.cu``) on CUDA tensors
and its plain-PyTorch twin :func:`interp_plain` on CPU tensors.  Both clip
the pixel coordinates as ``interp_mxu.py:116-119`` and sum the four
corners with the hat weights max(0, 1 - |x - j|), which after the clip
are the bilinear weights of ``grid_sample_2d`` (border padding,
align_corners=True).  The name keeps the JAX package's; there is no
matrix unit in the CUDA kernel.
"""

from __future__ import annotations

import torch

from . import _cuda

COL_CHUNK = 256
MAX_ROWS = 4096

launches = 0


def interp_mxu_viable(H: int, W: int) -> bool:
    """The JAX package's viability rule for the small-map path (same maps
    take kernel D here): small, power-of-two width, chunk-aligned."""
    return (H * W <= MAX_ROWS and H * W % COL_CHUNK == 0
            and W & (W - 1) == 0 and W + 1 < COL_CHUNK
            and H * W // COL_CHUNK <= 127)


def interp_plain(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of kernel D: (H, W, C) x (N, 2) -> (N, C)."""
    H, W, C = feat.shape
    x = ((uv[:, 0].float() + 1.0) * 0.5 * (W - 1.0)).clamp(0.0, W - 1.0)
    y = ((uv[:, 1].float() + 1.0) * 0.5 * (H - 1.0)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    hx0 = (1.0 - (x - x0).abs()).clamp(min=0.0)[:, None]
    hx1 = (1.0 - (x - (x0 + 1.0)).abs()).clamp(min=0.0)[:, None]
    hy0 = (1.0 - (y - y0).abs()).clamp(min=0.0)[:, None]
    hy1 = (1.0 - (y - (y0 + 1.0)).abs()).clamp(min=0.0)[:, None]
    ix0 = x0.long()
    iy0 = y0.long()
    ix1 = (ix0 + 1).clamp(max=W - 1)
    iy1 = (iy0 + 1).clamp(max=H - 1)
    flat = feat.reshape(H * W, C)
    f00 = flat[iy0 * W + ix0]
    f01 = flat[iy0 * W + ix1]
    f10 = flat[iy1 * W + ix0]
    f11 = flat[iy1 * W + ix1]
    return ((hx0 * hy0) * f00 + (hx1 * hy0) * f01 + (hx0 * hy1) * f10
            + (hx1 * hy1) * f11)


def interp_cuda(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Kernel D; same contract as :func:`interp_plain`."""
    global launches
    H, W, C = feat.shape
    N = uv.shape[0]
    _cuda.require(feat, "feat", torch.float32, (H, W, C))
    _cuda.require(uv, "uv", torch.float32, (N, 2), feat.device)
    out = torch.empty(N, C, dtype=torch.float32, device=feat.device)
    rc = _cuda.lib().vt_interp(feat.data_ptr(), H, W, C, uv.data_ptr(), N,
                               out.data_ptr(), _cuda.stream_ptr(feat.device))
    _cuda.check(rc, "vt_interp")
    launches += 1
    return out


def mxu_grid_sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample a small (H, W, C) map at (N, 2) coords in [-1, 1]."""
    H, W, _ = feat.shape
    if not interp_mxu_viable(H, W):
        raise ValueError(f"map {H}x{W} is not viable for the sampler")
    if feat.device.type == "cpu":
        return interp_plain(feat, uv)
    return interp_cuda(feat.contiguous(), uv.float().contiguous())


def interp_sample_nhwc(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Batched: (B, H, W, C) x (B, N, 2) -> (B, N, C)."""
    return torch.stack([mxu_grid_sample(feat[b], uv[b])
                        for b in range(feat.shape[0])])
