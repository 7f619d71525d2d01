"""Seeded weights for the program and the reference alike.

The benchmark makes the weights, not the program: one ``state_dict``, keyed
by the reference modules' names (the reference checkpoint's), drawn on the
device from ``--seed`` in one call and cut into the leaves.  The rule is
flax's default initialisation as the program's ``init_like_flax`` follows
it: lecun-normal kernels (fan-in over the output channels of a transposed
convolution), zero biases, unit norm scales and weight-norm gains,
``sigmoid_beta`` 0.1 and the IBR head's ``ani_al`` 0.2.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def seeded_state(module: nn.Module, seed: int, device) -> dict:
    """A ``state_dict`` for ``module``'s parameters, drawn from ``seed`` on
    ``device``."""
    params = list(module.named_parameters())
    alias = {}            # a module held under two names has both keys
    seen = {id(p): n for n, p in params}
    for n, p in module.named_parameters(remove_duplicate=False):
        if seen[id(p)] != n:
            alias[n] = seen[id(p)]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    total = sum(p.numel() for _, p in params)
    draw = torch.randn(total, generator=gen, device=device).clamp_(-2, 2)
    out, o = {}, 0
    for name, p in params:
        owner = module.get_submodule(name.rpartition(".")[0])
        leaf = name.rpartition(".")[2]
        x = draw[o:o + p.numel()].view(p.shape)
        o += p.numel()
        if leaf == "sigmoid_beta":
            x = torch.full_like(x, 0.1)
        elif leaf == "ani_al":
            x = torch.full_like(x, 0.2)
        elif leaf == "bias":
            x = torch.zeros_like(x)
        elif leaf == "weight_g" or isinstance(owner, (nn.GroupNorm,
                                                      nn.LayerNorm)):
            x = torch.ones_like(x)
        else:
            fan_in = (p.shape[1] * p[0, 0].numel()
                      if isinstance(owner, nn.ConvTranspose2d)
                      else p[0].numel())
            x = x * fan_in ** -0.5
        out[name] = x
    out.update({n: out[a] for n, a in alias.items()})
    return out
