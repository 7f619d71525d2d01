"""GAN train step: generator render + losses, then discriminator + R1 (port
of ``vanerf_tpu/training/train_step.py``; reference
``VANeRFLightningModule.training_step``, ``src/model.py:381-459``, with the
dual-Adam / MultiStepLR [2, 5, 10, 20, 35] x 0.5 optimizers of
``model.py:61-68``).

GAN scheme (config ``training.reference_faithful_gan``, default True; env
``VANERF_FAITHFUL_GAN`` overrides): the G update differentiates the
training patch; the D update then sees a fresh patch rendered without
gradients through the just-updated generator, as the reference does.
With the flag off the D update consumes the detached G patch (one render
per step).  R1 is ``torch.autograd.grad(create_graph=True)`` through the
discriminator on the real patch.

Randomness: the grid, the stratified jitter, the radiance noise, the
importance uniforms and, with two or more source views, each pass's
view-dropout uniforms come from a ``torch.Generator``, or from a ``draws``
dict ({"g": {...}, "d": {...}}, keys of :func:`renderer.render_patch`
plus "grids") so a test can feed the JAX package's draws.  With the same
state and draws a step repeats to the bit on the card: it runs under
cuDNN's deterministic algorithms (:func:`deterministic`), and the ops
whose CUDA backward adds with atomics are written as slices, expansions
and means instead: the texture encoder's replication padding
(``models/blocks.py::ReplicationPad2d``) and the adaptive pool of the
texture fusion's global context (``models/fusion.py::AdaptiveAvgPool2d``).

A model whose ``compute_dtype`` is bfloat16 trains as the JAX package's
does: the query computes in bfloat16 and returns float32, and the
parameters, the encoders, the losses, the discriminator, the VGG loss and
Adam stay float32; the gradients reach the float32 parameters through
the query's casts.

While a ``torch.profiler`` records, a step is the span ``vanerf.step``
and its eight phases ``vanerf.{g,d}.{render,loss,backward,optimizer}``
(``profiling.span``); the renders' spans nest under the render phases.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
import torch.nn as nn

from .. import losses as L
from ..models.discriminator import (bce_loss, d_logistic_loss, d_r1_loss,
                                    g_nonsaturating_loss)
from ..profiling import span, spanned
from ..renderer import as_float_tensor, mask_centered_grid, render_patch

MILESTONES = (2, 5, 10, 20, 35)


class AdamSchedule:
    """``optax.adam`` on a step-counted MultiStepLR schedule, optionally
    inside ``optax.MultiSteps``: ``torch.optim.Adam`` (betas 0.9 / 0.999,
    eps 1e-8) whose rate halves after ``m * steps_per_epoch`` updates for
    each milestone m; with ``every_k`` > 1 the gradients of k calls are
    averaged (a running mean, as MultiSteps) and the k-th call updates.
    A parameter without a gradient gets zeros, as in JAX."""

    def __init__(self, params, lr: float, steps_per_epoch: int,
                 every_k: int = 1):
        self.params = list(params)
        self.opt = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                    eps=1e-8)
        self.sched = torch.optim.lr_scheduler.MultiStepLR(
            self.opt, [m * steps_per_epoch for m in MILESTONES], gamma=0.5)
        self.every_k = max(1, int(every_k or 1))
        self.mini_step = 0
        self.acc = None

    def step(self, grads) -> None:
        """Apply (or accumulate) one set of gradients, aligned with
        ``params``."""
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        if self.every_k > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(p) for p in self.params]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.every_k:
                return
            grads, self.acc, self.mini_step = self.acc, None, 0
        for p, g in zip(self.params, grads):
            p.grad = g
        self.opt.step()
        self.sched.step()
        for p in self.params:
            p.grad = None


@dataclass
class TrainState:
    model: nn.Module
    disc: nn.Module
    opt_g: AdamSchedule
    opt_d: AdamSchedule
    step: int = 0


def create_train_state(model: nn.Module, disc: nn.Module, cfg: dict,
                       steps_per_epoch: int = 5423) -> TrainState:
    """Optimizers for an initialised generator and discriminator."""
    lr = cfg["training"].get("lr", 1e-5)
    accum = cfg["training"].get("accumulate_grad_batches", 1)
    return TrainState(
        model, disc,
        AdamSchedule(model.parameters(), lr, steps_per_epoch, accum),
        AdamSchedule(disc.parameters(), lr, steps_per_epoch, accum))


def faithful_gan(cfg: dict) -> bool:
    env = os.environ.get("VANERF_FAITHFUL_GAN", "")
    if env != "":
        return env != "0"
    return bool(cfg["training"].get("reference_faithful_gan", True))


def generator_outputs(model, batch: Dict[str, Any], cfg: dict,
                      n_views: int = 1,
                      generator: Optional[torch.Generator] = None,
                      draws: Optional[Dict[str, Any]] = None):
    """Render the training patch (``train_step.py:91-114``); with
    ``dr_kwargs.fine=false`` the coarse pass alone, and no 'tex_cal_fine'."""
    m = cfg["models"]["VANeRF"]
    drk = m.get("dr_kwargs", {})
    out_h = m.get("train_out_h", 64)
    out_w = m.get("train_out_w", 64)
    dev = batch["src_img"].device
    if draws is not None and "grids" in draws:
        grids = as_float_tensor(draws["grids"]).to(dev)
    else:
        grids = mask_centered_grid(generator, batch["tar_mask"][..., 0],
                                   out_h, out_w)
    out = render_patch(
        model, batch, grids=grids, out_h=out_h, out_w=out_w,
        sample_per_ray_c=drk.get("sample_per_ray_c", 64),
        sample_per_ray_f=drk.get("sample_per_ray_f", 64), training=True,
        fine=drk.get("fine", True), n_views=n_views, compute_vis_map=True,
        uniform=drk.get("uniform", False),
        rand_noise_std=drk.get("rand_noise_std", 0.0), generator=generator,
        draws=draws)
    out["tex_cal"] = out["tex_fg"]
    if "tex_fg_fine" in out:
        out["tex_cal_fine"] = out["tex_fg_fine"]
    return out


def rendered_image(out: Dict[str, Any]) -> torch.Tensor:
    """The image the discriminator judges: the fine pass's, or the coarse
    pass's under ``dr_kwargs.fine=false`` (the JAX step reads
    'tex_fg_fine' there and stops with a KeyError; the port judges the only
    image it rendered)."""
    return out.get("tex_fg_fine", out["tex_fg"]).clamp(0.0, 1.0)


def generator_loss(out: Dict[str, Any], disc, vggloss, cfg: dict):
    """G loss of a rendered patch (``train_step.py:130-146``): L1 + VGG
    reconstruction, ``lambda_dis1`` x the non-saturating GAN loss and
    ``lambda_dis2`` x the visibility BCE on target-mask pixels.  Returns
    (loss, err dict)."""
    lambdas = cfg["models"]["VANeRF"].get("lambdas", {})
    dis_lambdas = cfg["models"]["Discriminator"]["lambdas"]
    loss, err = L.compute_error(out, lambdas, vggloss)
    rendered = rendered_image(out)
    fake_pred, fake_vis = disc(out["img_in"], out["input_densepose"],
                               out["tar_densepose"], rendered)
    vis_pix = bce_loss(fake_vis, torch.ones_like(fake_vis))
    vis_pix = torch.where(out["tar_alpha"] == 0, torch.zeros_like(vis_pix),
                          vis_pix).mean()
    g_gan = g_nonsaturating_loss(fake_pred)
    err["gan_loss"] = dis_lambdas.get("lambda_dis1", 0.1) * g_gan
    err["vis_pix_loss"] = dis_lambdas.get("lambda_dis2", 0.1) * vis_pix
    return loss + err["gan_loss"] + err["vis_pix_loss"], err


def discriminator_loss(out: Dict[str, Any], disc):
    """D loss of a (detached) patch (``train_step.py:148-184``): logistic
    loss, R1 = 300 x 0.5 x ||dD(real)/dreal||^2, and the masked visibility
    BCE of real and fake with x5 on invisible GT pixels.  Returns
    (loss, logs)."""
    rendered = rendered_image(out).detach()
    gt = out["tar_img"].detach().requires_grad_(True)
    vis_gt = out["vis_img"]
    msk = out["tar_alpha"]
    ipt, idp, tdp = (out["img_in"], out["input_densepose"],
                     out["tar_densepose"])
    real_pred, real_vis = disc(ipt, idp, tdp, gt)
    fake_pred, fake_vis = disc(ipt, idp, tdp, rendered)

    zero = torch.zeros_like(real_vis)
    real_vis_l = bce_loss(real_vis, torch.ones_like(real_vis))
    fake_vis_l = bce_loss(fake_vis, vis_gt)
    real_vis_l = torch.where(msk == 0, zero, real_vis_l).mean()
    fake_vis_l = torch.where(msk == 0, zero, fake_vis_l)
    fake_vis_l = torch.where(vis_gt == 0, fake_vis_l * 5.0,
                             fake_vis_l).mean()

    d_gan = d_logistic_loss(real_pred, fake_pred)
    # R1 (networks.py:591-597, weight model.py:444-445)
    r1 = 300.0 * 0.5 * d_r1_loss(real_pred, gt)
    logs = {"d": d_gan, "r1": r1, "real_score": real_pred.mean(),
            "fake_score": fake_pred.mean(), "real_vis_pix_loss": real_vis_l,
            "fake_vis_pix_loss": fake_vis_l}
    return d_gan + r1 + real_vis_l + fake_vis_l, logs


def deterministic():
    """cuDNN's deterministic algorithms for the length of a step (the
    caller's other cuDNN and TF32 settings kept): the backward of the
    encoders', D's and VGG's convolutions then repeats to the bit on the
    card, as the encode's forward does (``VANeRF.encode``)."""
    cd = torch.backends.cudnn
    return cd.flags(enabled=cd.enabled, benchmark=False, deterministic=True,
                    allow_tf32=cd.allow_tf32)


def make_train_step(model, disc, cfg: dict, vggloss, n_views: int = 1,
                    reduce=None):
    """Build ``train_step(state, batch, generator=None, draws=None) ->
    logs`` (detached scalar tensors named as the JAX package's).

    ``reduce`` (``parallel/train.py``) averages over the data-parallel
    ranks where the JAX step ``pmean``s (``train_step.py:195-196, 210-211,
    219-220``): ``reduce.grads(grads, params)`` the gradients of G and of
    D before each optimizer update, ``reduce.logs(logs)`` the logs."""
    faithful = faithful_gan(cfg)

    def train_step(state: TrainState, batch: Dict[str, Any],
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, Dict[str, Any]]] = None):
        """One GAN step: G update, then D update (see the module note),
        under :func:`deterministic`."""
        with deterministic():
            return _step(state, batch, generator, draws or {})

    @spanned("vanerf.step")
    def _step(state, batch, generator, draws):
        with span("vanerf.g.render"):
            out = generator_outputs(model, batch, cfg, n_views, generator,
                                    draws.get("g"))
        with span("vanerf.g.loss"):
            g_loss, err = generator_loss(out, disc, vggloss, cfg)
        with span("vanerf.g.backward"):
            grads_g = torch.autograd.grad(g_loss, state.opt_g.params,
                                          allow_unused=True)
            if reduce is not None:
                grads_g = reduce.grads(grads_g, state.opt_g.params)
        with span("vanerf.g.optimizer"):
            state.opt_g.step(grads_g)

        with span("vanerf.d.render"):
            if faithful:
                with torch.no_grad():
                    out_d = generator_outputs(model, batch, cfg, n_views,
                                              generator, draws.get("d"))
            else:
                out_d = {k: (v.detach() if torch.is_tensor(v) else v)
                         for k, v in out.items()}
        with span("vanerf.d.loss"):
            d_loss, d_logs = discriminator_loss(out_d, disc)
        with span("vanerf.d.backward"):
            grads_d = torch.autograd.grad(d_loss, state.opt_d.params,
                                          allow_unused=True)
            if reduce is not None:
                grads_d = reduce.grads(grads_d, state.opt_d.params)
        with span("vanerf.d.optimizer"):
            state.opt_d.step(grads_d)
        state.step += 1

        logs = {f"train/{k}": v for k, v in err.items()}
        logs.update({f"train/{k}": v for k, v in d_logs.items()})
        logs["train/g_loss"] = g_loss
        logs["train/d_loss"] = d_loss
        logs = {k: (v.detach() if torch.is_tensor(v) else torch.tensor(v))
                for k, v in logs.items()}
        return logs if reduce is None else reduce.logs(logs)

    return train_step
