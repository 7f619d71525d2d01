"""The data-parallel GAN step (port of ``vanerf_tpu/parallel/train.py``).

The JAX package ``shard_map``s the per-shard step over the ``"data"``
axis: each device renders and differentiates its slice of the batch, its
draws folded with its axis index, and the gradients of G and of D, then
the logs, are ``pmean``-ed before the replicated optimizer updates
(``training/train_step.py:186-220``).  Here each rank is a process with
its slice of the batch (:func:`~.mesh.shard_batch`); the gradients are
averaged by an explicit all-reduce (a sum, then a division by the world
size) at the same three places.  ``nn.parallel.DistributedDataParallel``'s
module wrapper is not used: the step differentiates two forwards of G's
patch through the discriminator, and R1's double backward.

``faces``, ``znear`` and ``zfar`` are replicated, every other entry with a
leading dimension is split (:func:`batch_pspecs`).  A state restored or
built on its own in each process is broadcast from rank 0 before the
first step (the defect the JAX package's ``926f6c9`` fixed:
``vanerf_tpu/parallel/train.py:77-92``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from .mesh import Mesh, replicate

_REPLICATED_KEYS = ("faces", "znear", "zfar")

# fold_generator's multiplier: distinct ranks of one step never share a seed
_FOLD = 0x9E3779B97F4A7C15


def batch_pspecs(batch: dict) -> dict:
    """True for each entry split over the ranks along its leading
    dimension, False for each replicated one (``faces`` / ``znear`` /
    ``zfar``, scalars and ``None``)."""
    return {k: k not in _REPLICATED_KEYS and getattr(v, "ndim", 0) > 0
            for k, v in batch.items()}


def fold_generator(generator: Optional[torch.Generator], rank: int,
                   device) -> Optional[torch.Generator]:
    """This rank's generator for one step, as ``fold_in(rng, axis_index)``:
    one 62-bit seed drawn from ``generator`` (which every rank advances
    alike) and mixed with the rank."""
    if generator is None:
        return None
    s = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                          device=generator.device))
    seed = (s * _FOLD + rank) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(seed)


class _Reduce:
    """The step's all-reduce hooks (``make_train_step(reduce=...)``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def grads(self, grads, params) -> list:
        """The mean over the ranks of each gradient; a parameter without
        one on this rank takes zeros, as the optimizer would."""
        full = [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, params)]
        return self.mesh.all_reduce_mean(full)

    def logs(self, logs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        keys = list(logs)
        vals = self.mesh.all_reduce_mean(
            [torch.as_tensor(logs[k], device=self.mesh.device).float()
             .reshape(()) for k in keys])
        return dict(zip(keys, vals))


def _opt_tensors(opt) -> list:
    """The optimizer state's tensors (Adam's moments and step counts, the
    accumulation buffers), in a fixed order."""
    out = []
    for p in opt.params:
        st = opt.opt.state.get(p, {})
        out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    return out + list(opt.acc or [])


def replicate_state(mesh: Mesh, state) -> None:
    """Rank 0's generator, discriminator and optimizer state into every
    rank's, in place (the step count and schedule are the same integers
    on every rank: they are checked)."""
    replicate(mesh, [state.model, state.disc])
    for opt in (state.opt_g, state.opt_d):
        ts = _opt_tensors(opt)
        n = torch.tensor([len(ts), opt.mini_step, opt.sched.last_epoch,
                          int(state.step)], device=mesh.device)
        lead = n.clone()
        mesh.broadcast_([lead])
        if not torch.equal(lead, n):
            raise RuntimeError(f"rank {mesh.rank}: optimizer state "
                               f"{n.tolist()} against rank 0's "
                               f"{lead.tolist()}")
        with torch.no_grad():
            mesh.broadcast_(ts)


def make_parallel_train_step(model, disc, cfg: dict, vggloss, mesh: Mesh,
                             n_views: int = 1):
    """``step(state, batch, generator=None, draws=None) -> logs``: the GAN
    step of ``training.make_train_step`` on this rank's shard ``batch``,
    its gradients and logs averaged over the ranks (at one rank too: the
    sum of one, divided by one, leaves every bit).  The first call
    broadcasts rank 0's state.  ``generator`` is the loop's stream, which
    every rank holds alike: the step's draws come from
    :func:`fold_generator` of it; ``draws`` (a test's) are this rank's own
    and taken as they are."""
    from ..training.train_step import make_train_step
    inner = make_train_step(model, disc, cfg, vggloss, n_views=n_views,
                            reduce=_Reduce(mesh))
    done = []

    def step(state, batch: Dict[str, Any],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Dict[str, Any]]] = None):
        if not done:
            replicate_state(mesh, state)
            done.append(True)
        gen = fold_generator(generator, mesh.rank, mesh.device)
        return inner(state, batch, gen, draws)

    return step
