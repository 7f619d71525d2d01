"""Key + payload sort (port of ``vanerf_tpu/ops/sorting.py``).

The JAX package gives ``lax.sort`` a permutation VJP of its own because
XLA's transpose of ``sort`` costs one scatter per payload on a TPU.  Here
the payloads are gathered by the stable sort's indices, and autograd's
gather backward routes each cotangent back to its source position: the
same permutation VJP, with no kernel.
"""

from __future__ import annotations

import torch


def sort_by_key(key: torch.Tensor, *payloads: torch.Tensor):
    """Stable ascending sort of ``key`` along the last axis, carrying the
    payloads: returns ``(key_sorted, *payloads_sorted)``."""
    key_s, perm = torch.sort(key, dim=-1, stable=True)
    return (key_s,) + tuple(torch.gather(p, -1, perm) for p in payloads)
