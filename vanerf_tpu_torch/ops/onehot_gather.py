"""Small-table row gather whose table gradient is kernel 13 (port of
``vanerf_tpu/ops/onehot_gather.py``).

:func:`take_rows` is ``table[idx]``: the forward is the native gather, and
the backward's scatter-add ``d_table[t] = sum_n [idx[n] == t] * g[n]``
runs through :func:`onehot_scatter` — the CUDA kernel
``csrc/onehot_scatter.cu`` on CUDA tensors, its plain twin
:func:`onehot_scatter_plain` (``index_add_`` with f32 accumulation) on CPU
tensors.  The gradient goes to the table only.

A gather takes this route (:func:`take_rows_route`) whenever its table
gradient is wanted and the table fits the kernel (float32, at most
``SCATTER_MAX_T`` rows).  Unlike the JAX package, whose MXU one-hot product
costs in proportion to the table and is therefore gated by
``VANERF_ONEHOT_SCATTER`` / ``VANERF_ONEHOT_MAX_T`` / ``VANERF_ONEHOT_BN``,
the CUDA kernel reads ``g`` once whatever the table size and sums in a
fixed order (no float atomics); the port reads none of those switches.  The device of the tensors picks kernel or
twin, so the CPU tests run the same code path with the twin.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import _cuda

# csrc/onehot_scatter.cu: OS_CHUNK, OS_SEG, OS_MAX_T (the C entry point
# checks the workspace sizes computed from these)
SCATTER_CHUNK = 2048
SCATTER_SEG = 128
SCATTER_MAX_T = 8192

launches = 0


def take_rows_route(n_rows: int, src: torch.Tensor) -> bool:
    """Whether a gather from an ``n_rows`` table built from ``src`` goes
    through :func:`take_rows`: a gradient flows to ``src`` and the kernel
    holds the table (float32, at most ``SCATTER_MAX_T`` rows).  Without a
    graph :func:`take_rows` would only be the native gather."""
    return (n_rows <= SCATTER_MAX_T and src.dtype == torch.float32
            and src.requires_grad and torch.is_grad_enabled())


def onehot_scatter_plain(g: torch.Tensor, idx: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """Plain twin: (N, C) rows summed into a (n_rows, C) f32 table."""
    out = torch.zeros(n_rows, g.shape[1], dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, idx.long(), g.float())


def onehot_scatter_cuda(g: torch.Tensor, idx: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """Kernel 13 on CUDA tensors: g (N, C) f32, idx (N,) int32 in
    [0, n_rows); deterministic (no float atomics)."""
    global launches
    N, C = g.shape
    _cuda.require(g, "g", torch.float32, (N, C))
    _cuda.require(idx, "idx", torch.int32, (N,), g.device)
    if not 0 < n_rows <= SCATTER_MAX_T:
        raise ValueError(f"onehot_scatter: {n_rows} rows; the kernel takes "
                         f"1..{SCATTER_MAX_T}")
    nchunks = -(-N // SCATTER_CHUNK)
    n_int = 2 * N + (n_rows + 1) * nchunks + 3 * (n_rows + 1)
    n_float = (-(-N // SCATTER_SEG) + n_rows) * C
    out = torch.empty(n_rows, C, dtype=torch.float32, device=g.device)
    iws = torch.empty(n_int, dtype=torch.int32, device=g.device)
    fws = torch.empty(max(n_float, 1), dtype=torch.float32, device=g.device)
    rc = _cuda.lib().vt_onehot_scatter(
        g.data_ptr(), idx.data_ptr(), N, C, n_rows, out.data_ptr(),
        iws.data_ptr(), n_int, fws.data_ptr(), n_float,
        _cuda.stream_ptr(g.device))
    _cuda.check(rc, "vt_onehot_scatter")
    launches += 1
    return out


def onehot_scatter(g: torch.Tensor, idx: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """``d_table`` of a row gather: kernel on CUDA tensors, twin on CPU."""
    if g.device.type == "cpu":
        return onehot_scatter_plain(g, idx, n_rows)
    return onehot_scatter_cuda(g.float().contiguous(),
                               idx.to(torch.int32).contiguous(), n_rows)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        ctx.dtype = table.dtype
        return table.index_select(0, idx)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return onehot_scatter(g, idx, ctx.n_rows).to(ctx.dtype), None


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a (T, C) table and (N,) row indices in [0, T),
    whose table gradient runs through :func:`onehot_scatter`.  Callers
    gate on :func:`take_rows_route`."""
    return _TakeRows.apply(table, idx.to(torch.int32))
