"""Per-point MLP stacks (port of ``vanerf_tpu/models/mlp.py``; reference
``Linear``/``MLP``/``MLPUNet``/``MLPUNetFusion``, ``src/utils.py:609-880``).

Weight-normalised layers keep the reference's ``weight_v`` / ``weight_g``
parameters (torch ``weight_norm``, one gain per output unit) under
``<layer>.linear``, so the state-dict keys are the reference's.

Every layer computes in its input's dtype: the parameters stay float32 and
the weight norm is taken in float32; the weight and the bias are cast to
the input's dtype at the product (``vanerf_tpu/models/mlp.py:63-66``).  In
bfloat16 every op rounds where the JAX package's op rounds (:func:`dense`,
:func:`softplus100`); in float32 a layer is one product with its bias.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.autograd.function import once_differentiable


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None,
          parts: Optional[Sequence[int]] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` in ``x``'s dtype (the float32 parameters are
    cast to it).

    In bfloat16 it rounds where the JAX package's layer rounds: each
    product of one part of a virtual concat (``parts``, the column widths
    of ``x``; one part by default) and each sum, the bias added first as
    ``WNLinear`` adds it (``vanerf_tpu/models/mlp.py:66-70``); flax's
    ``Dense`` and ``VDense`` add it last (``vanerf_tpu/models/fusion.py:
    36-44``), which rounds alike where they use it (one part, or no
    bias).  In float32 it is one product with the bias."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    if x.dtype != torch.bfloat16:
        return F.linear(x, w, b)
    out, o = b, 0
    for c in parts or (x.shape[-1],):
        y = F.linear(x[..., o:o + c], w[:, o:o + c])
        out = y if out is None else out + y
        o += c
    return out


class _SigmoidBf16(torch.autograd.Function):
    """XLA's expansion of ``jax.nn.sigmoid`` in bfloat16, ``1 / (1 +
    exp(-x))`` with each op rounded; its gradient is JAX's rule for
    ``lax.logistic``, ``g * (s * (1 - s))``, each op rounded."""

    @staticmethod
    def forward(ctx, x):
        s = 1.0 / (1.0 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1.0 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """torch's sigmoid; in bfloat16 the JAX package's, forward and
    gradient rounded op by op as XLA rounds them (:class:`_SigmoidBf16`)."""
    if x.dtype != torch.bfloat16:
        return torch.sigmoid(x)
    return _SigmoidBf16.apply(x)


def act(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """An activation module of a stack, applied as the JAX package's."""
    return sigmoid(x) if isinstance(m, nn.Sigmoid) else m(x)


def run_seq(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A stack of ``nn.Linear`` layers and activations on (..., C) rows,
    each layer in ``x``'s dtype (:func:`dense`)."""
    for m in seq:
        x = dense(x, m.weight, m.bias) if isinstance(m, nn.Linear) \
            else act(m, x)
    return x


class _Softplus100Bf16(torch.autograd.Function):
    """The JAX package's softplus in bfloat16, each op rounded
    (``vanerf_tpu/models/mlp.py:22-25``): ``xb = 100 x`` rounded before the
    test, ``lse = logaddexp(xb, 0) = max(xb, 0) + log1p(exp(-|xb|))``, and
    the division by 100 as XLA's product by 0.01.  The gradient is the
    transpose of JAX's JVP, op by op: the select's two branches, the
    product by 0.01, ``logaddexp``'s rule ``exp(xb - lse)`` and the product
    by 100."""

    @staticmethod
    def forward(ctx, x):
        xb = x * 100.0
        lse = xb.clamp(min=0) + torch.log1p(torch.exp(-xb.abs()))
        ctx.save_for_backward(xb, lse)
        return torch.where(xb > 20.0, x, lse * 0.01)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        xb, lse = ctx.saved_tensors
        lin = xb > 20.0
        zero = torch.zeros_like(g)
        ct_lse = torch.where(lin, zero, g) * 0.01
        return torch.where(lin, g, zero) + ct_lse * torch.exp(xb - lse) * 100.0


def softplus100(x: torch.Tensor) -> torch.Tensor:
    """torch Softplus(beta=100, threshold=20), as the reference.  In
    bfloat16 it is the JAX package's form, forward and gradient op by op,
    each op rounded (:class:`_Softplus100Bf16`)."""
    if x.dtype != torch.bfloat16:
        return F.softplus(x, beta=100.0, threshold=20.0)
    return _Softplus100Bf16.apply(x)


def get_nl(name: Optional[str]):
    """A hidden nonlinearity by the JAX package's names
    (``vanerf_tpu/models/mlp.py:18-35``), or None: softplus (the shipped
    configs'; :func:`softplus100`), leakyrelu (slope 0.2), elu, tanh,
    sigmoid (:func:`sigmoid`) or relu."""
    if name == "softplus":
        return softplus100
    if name == "leakyrelu":
        return lambda x: F.leaky_relu(x, 0.2)
    if name == "elu":
        return F.elu
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return sigmoid
    if name == "relu":
        return F.relu
    if name in (None, "none", "None", ""):
        return None
    raise NotImplementedError(f"unsupported nl layer {name}")


class WNLinear(nn.Module):
    """Dense layer with weight normalisation: W = g * v / (|v| + 1e-12),
    the norm taken per output unit (torch ``weight_norm`` default dim)."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight_v = nn.Parameter(torch.empty(out_features, in_features))
        self.weight_g = nn.Parameter(torch.ones(out_features, 1))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.kaiming_uniform_(self.weight_v, a=5 ** 0.5)

    def forward(self, x, parts=None):
        v = self.weight_v
        w = v * (self.weight_g / (torch.linalg.norm(v, dim=1, keepdim=True)
                                  + 1e-12))
        return dense(x, w, self.bias, parts)


class _Layer(nn.Module):
    """One reference ``Linear`` block: ``.linear`` holds the weights."""

    def __init__(self, n_in: int, n_out: int, wn: bool):
        super().__init__()
        self.linear = WNLinear(n_in, n_out) if wn else nn.Linear(n_in, n_out)

    def forward(self, x, parts=None):
        """``parts``: the widths of ``x``'s virtual concat (:func:`dense`)."""
        lin = self.linear
        if isinstance(lin, WNLinear):
            return lin(x, parts)
        return dense(x, lin.weight, lin.bias, parts)


class MLP(nn.Module):
    """Head MLP (utils.py:687-719) without input skips, as MLPUNetFusion
    uses it."""

    def __init__(self, n_dims: Sequence[int], nl_layer: str = "softplus",
                 norm: str = "weight"):
        super().__init__()
        self.nl = get_nl(nl_layer)
        n = len(n_dims) - 1
        self.layers = nn.ModuleList(
            _Layer(n_dims[i], n_dims[i + 1], norm == "weight" and i != n - 1)
            for i in range(n))

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i != n - 1 and self.nl is not None:
                x = self.nl(x)
        return x


class MLPUNet(nn.Module):
    """MLP with multi-scale image-feature skip inputs (utils.py:781-852)."""

    def __init__(self, n_dims: Sequence[int], skip_dims: Sequence[int],
                 skip_layers: Sequence[int], nl_layer: str = "softplus",
                 norm: str = "weight"):
        super().__init__()
        self.skip_dict = {j: i for i, j in enumerate(skip_layers)}
        self.nl = get_nl(nl_layer)
        n = len(n_dims) - 1
        self.layers = nn.ModuleList(
            _Layer(n_dims[i] + (skip_dims[self.skip_dict[i]]
                                if i in self.skip_dict else 0),
                   n_dims[i + 1], norm == "weight" and i != n - 1)
            for i in range(n))

    def forward(self, x, feats):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            parts = None
            if i in self.skip_dict:
                f = feats[self.skip_dict[i]]
                # the first layer's input is the JAX package's list of
                # parts (the encoding, then the skip feature); a later
                # skip input is one concatenated part there too
                parts = (x.shape[-1], f.shape[-1]) if i == 0 else None
                x = torch.cat([x, f], -1)
            x = layer(x, parts)
            if i != n - 1 and self.nl is not None:
                x = self.nl(x)
        return x


def pool_views(x: torch.Tensor, a: torch.Tensor, w: torch.Tensor,
               pool_types: Sequence[str]):
    """Weighted pooling over the view axis (utils.py:854-880).

    x: (B, V, N, C); a: (B, V, N, 1) validity; w: (B, V, N, 1) weights.
    Returns pooled (B, N, len(pool_types)*C), valid (B, N, 1) bool: the
    parts in the order max, mean, var, as the JAX package concatenates
    them, whatever the order of ``pool_types``.
    """
    if not set(pool_types) <= {"max", "mean", "var"}:
        raise NotImplementedError(f"pool types {pool_types}")
    a_sum = a.sum(1)
    ret = []
    if "max" in pool_types:
        ret.append(x.amax(1))
    mean = (w * x).sum(1)
    if "mean" in pool_types:
        ret.append(mean)
    if "var" in pool_types:
        ret.append((w * (x - mean[:, None]) ** 2).sum(1))
    return torch.cat(ret, -1), a_sum > 0.0


class MLPUNetFusion(nn.Module):
    """Per-view MLPUNet -> view pooling -> head MLP (utils.py:609-649).
    Returns (out, valid, x_view, x_pool)."""

    def __init__(self, n_dims1, n_dims2, skip_dims, skip_layers,
                 nl_layer: str = "softplus", norm: str = "weight",
                 pool_types: Sequence[str] = ("mean",)):
        super().__init__()
        self.pool_types = tuple(pool_types)
        self.layers1 = MLPUNet(n_dims1, skip_dims, skip_layers, nl_layer,
                               norm)
        # the head's input is the pooled width, as the JAX package's Dense
        # infers it from its input
        n_dims2 = [len(self.pool_types) * n_dims1[-1]] + list(n_dims2[1:])
        self.layers2 = MLP(n_dims2, nl_layer, norm)

    def forward(self, x, feats, a, w):
        x_view = self.layers1(x, feats)
        x_pool, valid = pool_views(x_view, a, w, self.pool_types)
        return self.layers2(x_pool), valid, x_view, x_pool
