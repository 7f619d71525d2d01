"""Small-map bilinear sampler (port of ``vanerf_tpu/ops/interp_mxu.py``).

:func:`mxu_grid_sample` is kernel D (``csrc/interp.cu``) on CUDA tensors
and its plain-PyTorch twin :func:`interp_plain` on CPU tensors.  Both clip
the pixel coordinates as ``interp_mxu.py:116-119`` and sum the four
corners with the hat weights max(0, 1 - |x - j|), which after the clip
are the bilinear weights of ``grid_sample_2d`` (border padding,
align_corners=True).  The name keeps the JAX package's; there is no
matrix unit in the CUDA kernel.

A map is float32 or bfloat16, and each dtype has its own instantiation of
kernels D and 10; any other dtype raises on the card.  On a bfloat16 map
each hat weight is made in float32 and rounded to bfloat16 before it
multiplies its corner (``interp_mxu.py:81``), the four products (exact in
float32) are summed in float32 in a fixed order and the sum is rounded to
bfloat16 once.

Both kernels take a batch in one launch, as the JAX package ``vmap``s
them: (B, N, 2) points on a (Bm, H, W, C) stack of maps and (B, N) rows of
a (Bm, V, C) stack of tables, element e reading map / table e % Bm (the G
tiles of a frame in a tile group share the frame's map and table).
"""

from __future__ import annotations

import torch

from . import _cuda
from ._cuda import batch_index

COL_CHUNK = 256
MAX_ROWS = 4096

launches = 0
row_gather_launches = 0
launches_bf16 = 0
row_gather_launches_bf16 = 0


def interp_mxu_viable(H: int, W: int) -> bool:
    """The JAX package's viability rule for the small-map path (same maps
    take kernel D here): small, power-of-two width, chunk-aligned."""
    return (H * W <= MAX_ROWS and H * W % COL_CHUNK == 0
            and W & (W - 1) == 0 and W + 1 < COL_CHUNK
            and H * W // COL_CHUNK <= 127)


def interp_plain(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of kernel D: (H, W, C) x (N, 2) -> (N, C) in the
    map's dtype, or batched (Bm, H, W, C) x (B, N, 2) -> (B, N, C), element
    e sampling map e % Bm."""
    batched = feat.dim() == 4
    f4 = feat if batched else feat[None]
    uv3 = uv if batched else uv[None]
    Bm, H, W, C = f4.shape
    cdt = f4.dtype
    x = ((uv3[..., 0].float() + 1.0) * 0.5 * (W - 1.0)).clamp(0.0, W - 1.0)
    y = ((uv3[..., 1].float() + 1.0) * 0.5 * (H - 1.0)).clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    hx0 = (1.0 - (x - x0).abs()).clamp(min=0.0)[..., None]
    hx1 = (1.0 - (x - (x0 + 1.0)).abs()).clamp(min=0.0)[..., None]
    hy0 = (1.0 - (y - y0).abs()).clamp(min=0.0)[..., None]
    hy1 = (1.0 - (y - (y0 + 1.0)).abs()).clamp(min=0.0)[..., None]
    ix0 = x0.long()
    iy0 = y0.long()
    ix1 = (ix0 + 1).clamp(max=W - 1)
    iy1 = (iy0 + 1).clamp(max=H - 1)
    flat = f4.reshape(Bm * H * W, C).float()
    base = (batch_index(uv3.shape[0], Bm, uv3.device) * (H * W))[:, None]
    f00 = flat[base + iy0 * W + ix0]
    f01 = flat[base + iy0 * W + ix1]
    f10 = flat[base + iy1 * W + ix0]
    f11 = flat[base + iy1 * W + ix1]

    def hat(a, b):        # the weight rounded to the map's dtype
        return (a * b).to(cdt).float()

    out = (hat(hx0, hy0) * f00 + hat(hx1, hy0) * f01 + hat(hx0, hy1) * f10
           + hat(hx1, hy1) * f11).to(cdt)
    return out if batched else out[0]


def interp_cuda(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Kernel D, the instantiation of the map's dtype (float32 or
    bfloat16), one launch for a batch; same contract as
    :func:`interp_plain`."""
    global launches, launches_bf16
    batched = feat.dim() == 4
    H, W, C = feat.shape[-3:]
    lead = uv.shape[:1] if batched else ()
    N = uv.shape[-2]
    sfx = _cuda.dtype_suffix(feat.dtype, "feat")
    _cuda.require(feat, "feat", feat.dtype, feat.shape[:-3] + (H, W, C))
    _cuda.require(uv, "uv", torch.float32, lead + (N, 2), feat.device)
    out = torch.empty(lead + (N, C), dtype=feat.dtype, device=feat.device)
    rc = getattr(_cuda.lib(), "vt_interp" + sfx)(
        feat.data_ptr(), H, W, C, feat.shape[0] if batched else 1,
        uv.data_ptr(), N, lead[0] if batched else 1, out.data_ptr(),
        _cuda.stream_ptr(feat.device))
    _cuda.check(rc, "vt_interp" + sfx)
    if sfx:
        launches_bf16 += 1
    else:
        launches += 1
    return out


def mxu_grid_sample(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear-sample a small (H, W, C) map at (N, 2) coords in [-1, 1];
    batched, a (Bm, H, W, C) stack at (B, N, 2), element e on map e % Bm."""
    H, W = feat.shape[-3:-1]
    if not interp_mxu_viable(H, W):
        raise ValueError(f"map {H}x{W} is not viable for the sampler")
    if feat.device.type == "cpu":
        return interp_plain(feat, uv)
    return interp_cuda(feat.contiguous(), uv.float().contiguous())


def interp_sample_nhwc(feat: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Batched: (Bm, H, W, C) x (B, N, 2) -> (B, N, C) in one launch,
    element e on map e % Bm."""
    return mxu_grid_sample(feat, uv)


# ---------------------------------------------------------------------------
# exact row gather (the KNN vertex-table lookup)
# ---------------------------------------------------------------------------

def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain-PyTorch twin of kernel 10: (V, C)[(N,)] -> (N, C), or batched
    (Bm, V, C)[(B, N)] -> (B, N, C), element e reading table e % Bm."""
    if table.dim() == 2:
        return table[idx.long()]
    sel = batch_index(idx.shape[0], table.shape[0], idx.device)
    return table[sel[:, None], idx.long()]


def row_gather_cuda(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Kernel 10, the instantiation of the table's dtype (float32 or
    bfloat16), one launch for a batch; same contract as
    :func:`row_gather_plain` for int32 indices in [0, V)."""
    global row_gather_launches, row_gather_launches_bf16
    batched = table.dim() == 3
    V, C = table.shape[-2:]
    lead = idx.shape[:1] if batched else ()
    N = idx.shape[-1]
    sfx = _cuda.dtype_suffix(table.dtype, "table")
    _cuda.require(table, "table", table.dtype, table.shape[:-2] + (V, C))
    _cuda.require(idx, "idx", torch.int32, lead + (N,), table.device)
    out = torch.empty(lead + (N, C), dtype=table.dtype, device=table.device)
    rc = getattr(_cuda.lib(), "vt_row_gather" + sfx)(
        table.data_ptr(), V, C, table.shape[0] if batched else 1,
        idx.data_ptr(), N, lead[0] if batched else 1, out.data_ptr(),
        _cuda.stream_ptr(table.device))
    _cuda.check(rc, "vt_row_gather" + sfx)
    if sfx:
        row_gather_launches_bf16 += 1
    else:
        row_gather_launches += 1
    return out


def mxu_row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a (V, C) float32 or bfloat16 table and (N,) row
    indices in [0, V), bitwise equal to the native gather; batched, a
    (Bm, V, C) stack and (B, N) indices, element e on table e % Bm (Bm = B:
    each its own).  No gradient.  The JAX package's one-hot product holds
    the table in VMEM and so takes at most 4,096 rows; the CUDA kernel
    copies rows and takes any table."""
    if table.device.type == "cpu":
        return row_gather_plain(table, idx)
    return row_gather_cuda(table.contiguous(),
                           idx.to(torch.int32).contiguous())
