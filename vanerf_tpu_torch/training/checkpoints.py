"""Checkpointing with auto-resume (port of
``vanerf_tpu/training/checkpoints.py``; the PL ModelCheckpoint
replacement, reference ``train.py:27-44`` and
``VANeRFLightningModule.load_ckpt``, ``model.py:134-138``).

A checkpoint is one directory per step, ``<ckpt_dir>/<step>/state.pt``:
``torch.save`` of the generator's and the discriminator's ``state_dict``,
both Adams and their MultiStepLR schedules, the gradient-accumulation
buffers and the step.  It is written under a temporary name and then
``os.replace``d into place, so a run cut mid-save never leaves half a
checkpoint.  Restoring puts a :class:`~.train_step.TrainState` back
exactly: parameters, moments, the schedule position and ``step``.

:func:`restore_any` also reads a reference-layout Lightning ``model.ckpt``
and the pickle of ``tools/convert_reference_ckpt.py``.
"""

from __future__ import annotations

import copy
import os
import pickle
import re
import shutil
import threading
import zipfile
from typing import Any, Optional

import torch

STATE_FILE = "state.pt"

# reference ``model.*`` keys the port's VANeRF holds no tensor for: the
# VGG19 of the reference's loss, the spatial encoders' constant centre
# buffers, and the bn4 GroupNorms of ConvBlocks without a downsample
# branch (unused upstream; ``tools/convert_reference_ckpt.py:108-110``)
_REF_ONLY = (re.compile(r"^vgg_loss\.vgg_net\."),
             re.compile(r"^sp_encoder(_[lr])?\.center$"))
_BN4 = re.compile(r"^(.*)\.bn4\.(weight|bias)$")


def _to_host(x):
    """A copy of ``x`` with every tensor detached and on the CPU."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True)
    if isinstance(x, dict):     # the same mapping type (a Counter too)
        out = copy.copy(x)
        for k, v in x.items():
            out[k] = _to_host(v)
        return out
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    return x


def _opt_state(opt) -> dict:
    return {"adam": opt.opt.state_dict(), "sched": opt.sched.state_dict(),
            "acc": opt.acc, "mini_step": opt.mini_step}


def _load_opt(opt, blob: dict) -> None:
    opt.opt.load_state_dict(blob["adam"])
    opt.sched.load_state_dict(blob["sched"])
    opt.acc = (None if blob["acc"] is None else
               [a.to(p.device) for a, p in zip(blob["acc"], opt.params)])
    opt.mini_step = int(blob["mini_step"])


def state_blob(state) -> dict:
    """Everything a run needs to go on, copied to the host."""
    return _to_host({"model": state.model.state_dict(),
                     "disc": state.disc.state_dict(),
                     "opt_g": _opt_state(state.opt_g),
                     "opt_d": _opt_state(state.opt_d),
                     "step": int(state.step)})


def load_state_blob(state, blob: dict):
    """Put :func:`state_blob`'s content back into ``state`` (in place)."""
    state.model.load_state_dict(blob["model"], strict=True)
    state.disc.load_state_dict(blob["disc"], strict=True)
    _load_opt(state.opt_g, blob["opt_g"])
    _load_opt(state.opt_d, blob["opt_d"])
    state.step = int(blob["step"])
    return state


class CheckpointManager:
    """Step-numbered checkpoints under ``ckpt_dir``, the JAX package's
    interface: ``save`` / ``wait`` / ``latest_step`` / ``restore``;
    ``max_to_keep`` None keeps every one."""

    def __init__(self, ckpt_dir: str, max_to_keep: Optional[int] = None):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer = None
        self._error = None

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             wait: bool = True):
        """Snapshot ``state`` to host memory now; write it to disk now
        (``wait``) or in a background thread (call :meth:`wait` before
        reading the directory or exiting)."""
        self.wait()
        blob = state_blob(state)
        if metrics:
            blob["metrics"] = {k: float(v) for k, v in metrics.items()}
        if wait:
            self._write(int(step), blob)
            return
        self._writer = threading.Thread(target=self._write_bg,
                                        args=(int(step), blob), daemon=True)
        self._writer.start()

    def _write_bg(self, step: int, blob: dict):
        try:
            self._write(step, blob)
        except Exception as e:          # re-raised by wait()
            self._error = e

    def _write(self, step: int, blob: dict):
        tmp = os.path.join(self.ckpt_dir, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(blob, os.path.join(tmp, STATE_FILE))
        final = os.path.join(self.ckpt_dir, str(step))
        if os.path.exists(final):       # a save of the same step replaces it
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep:
            for s in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(os.path.join(self.ckpt_dir, str(s)))

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def all_steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.ckpt_dir)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.ckpt_dir, n, STATE_FILE)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None):
        """Load step ``step`` (default: the latest) into
        ``state_template``; (state, step), or (None, None) when there is
        no checkpoint."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        blob = torch.load(os.path.join(self.ckpt_dir, str(step), STATE_FILE),
                          map_location="cpu", weights_only=False)
        return load_state_blob(state_template, blob), step


def auto_resume(ckpt_dir: str, state_template: Any,
                model_ckpt: Optional[str] = None):
    """Resume from the latest checkpoint unless an explicit path is given
    (reference ``train.py:38-44``)."""
    if model_ckpt is not None:
        return restore_any(model_ckpt, state_template)
    return CheckpointManager(ckpt_dir).restore(state_template)


def split_reference_state_dict(sd: dict, model_keys) -> tuple:
    """A reference Lightning ``state_dict`` -> (generator state_dict,
    discriminator state_dict, the reference-only keys left over).

    ``model.*`` keys go to the generator; of those the port holds no
    tensor for exactly three families, which are returned and not loaded:
    ``vgg_loss.vgg_net.*``, the ``sp_encoder*.center`` buffers and the
    ``bn4`` GroupNorms of ConvBlocks with no downsample branch.  Any other
    missing or unexpected key raises."""
    gen = {k[len("model."):]: v for k, v in sd.items()
           if k.startswith("model.")}
    disc = {k[len("discriminator."):]: v for k, v in sd.items()
            if k.startswith("discriminator.")}
    other = [k for k in sd if not k.startswith(("model.", "discriminator."))]
    model_keys = set(model_keys)

    def ref_only(k):
        if any(p.match(k) for p in _REF_ONLY):
            return True
        m = _BN4.match(k)
        return bool(m) and f"{m.group(1)}.downsample.2.weight" not in gen

    extra = sorted(k for k in gen if k not in model_keys)
    left = [k for k in extra if ref_only(k)]
    unexpected = [k for k in extra if not ref_only(k)] + other
    missing = sorted(model_keys - set(gen))
    if unexpected or missing:
        raise ValueError(
            "reference checkpoint does not match the port's VANeRF: "
            f"unexpected={unexpected[:8]} missing={missing[:8]}")
    return {k: gen[k] for k in model_keys}, disc, left


def load_reference_ckpt(blob: dict, state: Any):
    """A reference-layout Lightning checkpoint (``state_dict`` with
    ``model.`` / ``discriminator.`` prefixes, ``global_step``) into
    ``state``'s modules; the optimizers keep the template's state, as in
    the JAX package."""
    gen, disc, _left = split_reference_state_dict(
        blob["state_dict"], state.model.state_dict().keys())
    state.model.load_state_dict(gen, strict=True)
    state.disc.load_state_dict(disc, strict=True)
    state.step = int(blob.get("global_step") or 0)
    return state, state.step


def load_converted_ckpt(blob: dict, state: Any):
    """The pickle of ``tools/convert_reference_ckpt.py`` ({params_g,
    params_d, epoch, global_step}, flax trees of numpy arrays) into
    ``state``'s modules through ``weights.from_jax_params`` /
    ``disc_from_jax_params``."""
    from ..weights import disc_from_jax_params, from_jax_params
    state.model.load_state_dict(from_jax_params(blob["params_g"]),
                                strict=True)
    state.disc.load_state_dict(disc_from_jax_params(blob["params_d"]),
                               strict=True)
    state.step = int(blob.get("global_step") or 0)
    return state, state.step


def restore_any(path: str, state_template: Any):
    """``--model_ckpt``: a port checkpoint directory (the ``ckpts`` dir, its
    latest step, or one step's directory), a reference-layout Lightning
    ``model.ckpt``, or a ``tools/convert_reference_ckpt.py`` pickle.
    Returns (state, step), or (None, None) for a directory without a
    checkpoint."""
    if os.path.isdir(path):
        if os.path.isfile(os.path.join(path, STATE_FILE)):
            blob = torch.load(os.path.join(path, STATE_FILE),
                              map_location="cpu", weights_only=False)
            return load_state_blob(state_template, blob), int(blob["step"])
        return CheckpointManager(path).restore(state_template)
    if not os.path.exists(path):
        return CheckpointManager(path).restore(state_template)
    if zipfile.is_zipfile(path):
        blob = torch.load(path, map_location="cpu", weights_only=False)
        if "state_dict" not in blob:
            raise ValueError(f"{path}: a torch file without a state_dict is "
                             "not a reference checkpoint")
        return load_reference_ckpt(blob, state_template)
    with open(path, "rb") as f:
        blob = pickle.load(f)
    return load_converted_ckpt(blob, state_template)
