"""The port's benchmark entry point (the counterpart of ``bench.py``).

    python3 -m vanerf_tpu_torch.bench [--train] [--tile-group G]
                                      [--rounds N] [--device cuda|cpu]

Runs on the card unless ``--device cpu`` is given; there is no fallback.
The shapes are ``bench.py``'s: ``configs/vanerf.json`` at full width with
the seeded flax-style initialisation, the 256^2 two-hand fixture at subdiv
3, 64x64 patches, 64 + 64 samples.  Prints one JSON line, last.

Serving (the default):
  * ``ray_samples_per_sec``: a group of 16 mask-centred patches sharing one
    encode, rendered one after another (``bench.py:98-113`` maps them),
    counted as ``bench.py:128``: 64 x 64 x (64 + 64 + 64) samples a patch;
  * ``ms_per_frame``: ``render_full_image`` of the 256^2 frame with
    ``--tile-group`` G stride offsets a call.
Training (``--train``):
  * ``train_step_ms``: the faithful two-forward GAN step;
  * ``single_render_ms``: the step with ``reference_faithful_gan=false``.

Each reading is the median over ``--rounds`` after a warm-up, the readings
taken in turns, with the least and the largest beside it: both paths are
host-bound and their wall times move with the host's load.  One more round
of each runs under ``torch.profiler``, for the device's busy time (the
union of its kernels' intervals) and its number of device operations.
The peak device memory, G, the card's name and its power limit (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them) go beside the times.  No ratio to another device's figure is
printed.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import time
from dataclasses import dataclass
from typing import Optional

import torch

from .device import resolve_device

SEED = 0


@dataclass
class Shapes:
    """The benchmark's sizes (``bench.py``'s by default; the tests shrink
    them)."""
    H: int = 256
    W: int = 256
    subdiv: int = 3
    patch: int = 64
    s_c: int = 64
    s_f: int = 64
    group: int = 16          # patches sharing one encode (bench.py's G)
    level: int = 3           # the frame's stride 2^(level - 1)

    def samples_per_group(self) -> int:
        """``bench.py:128``: coarse + (coarse + fine) evaluations a ray."""
        return self.patch * self.patch * (self.s_c + self.s_c + self.s_f) \
            * self.group


def card() -> dict:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    name, _, limit = out.splitlines()[0].partition(",") if out else ("", "",
                                                                     "")
    return {"device": name.strip() or torch.cuda.get_device_name(0),
            "power_limit": limit.strip() or None}


def build(cfg: dict, shapes: Shapes, device, seed: int = SEED):
    """The seeded model in eval mode and the fixture's first frame, on
    ``device``."""
    from .data import make_synthetic_batch, to_torch
    from .models import VANeRF, init_like_flax
    batch_np, _faces, num_v = make_synthetic_batch(
        batch_size=1, H=shapes.H, W=shapes.W, subdiv=shapes.subdiv,
        device=device)
    model = VANeRF.from_config(cfg, num_v=num_v,
                               image_hw=(shapes.H, shapes.W))
    init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(device).eval(), to_torch(batch_np, device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device) -> float:
    """Host ms of ``fn()``, ending in a device synchronisation."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


def spread(ms) -> dict:
    return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}


def device_activity(prof):
    """The device operations of a ``torch.profiler`` run (its kernels,
    copies and fills, less the GPU mirrors of host annotations such as
    ``Optimizer.step``, which span gaps between kernels), the microseconds
    the device was busy (the union of their intervals) and the span from
    the first operation's start to the last one's end."""
    from torch.autograd import DeviceType
    events = prof.events()
    host = {e.name for e in events if e.device_type == DeviceType.CPU}
    ops = [e for e in events
           if e.device_type == DeviceType.CUDA and e.name not in host]
    spans = sorted((e.time_range.start, e.time_range.end) for e in ops)
    busy_us, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            busy_us += 0.0 if cur is None else cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += 0.0 if cur is None else cur[1] - cur[0]
    span_us = spans[-1][1] - spans[0][0] if spans else 0.0
    return ops, busy_us, span_us


def device_profile(fn, device) -> dict:
    """``fn()`` once under ``torch.profiler``: the device's busy ms and its
    number of operations (:func:`device_activity`); on the CPU "not
    measured" (None)."""
    if torch.device(device).type != "cuda":
        return {"device_busy_ms": None, "device_ops": None}
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(device)
    ops, busy_us, _span = device_activity(prof)
    return {"device_busy_ms": busy_us / 1e3, "device_ops": len(ops)}


def _peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device) -> Optional[int]:
    if torch.device(device).type == "cuda":
        return torch.cuda.max_memory_allocated(device)
    return None


@torch.no_grad()
def serve(model, batch, shapes: Shapes, tile_group: int = 1,
          rounds: int = 8, device="cuda") -> dict:
    """The serving readings: a group of mask-centred patches on one
    encode, and a full frame at ``tile_group``, in turns."""
    from . import renderer as tr
    gen = torch.Generator().manual_seed(SEED + 1)

    def group():
        cached = tr.encode_frame(model, batch)
        for _ in range(shapes.group):
            grids = tr.mask_centered_grid(gen, batch["tar_mask"][..., 0],
                                          shapes.patch, shapes.patch)
            out = tr.render_patch(
                model, batch, grids=grids, out_h=shapes.patch,
                out_w=shapes.patch, sample_per_ray_c=shapes.s_c,
                sample_per_ray_f=shapes.s_f, compute_vis_map=False,
                cached=cached)
        return out

    def frame():
        return tr.render_full_image(
            model, batch, level=shapes.level, sample_per_ray_c=shapes.s_c,
            sample_per_ray_f=shapes.s_f, tile_group=tile_group)

    _peak_reset(device)
    out_g, out_f = group(), frame()                      # warm-up
    for out in (out_g, out_f):
        if not torch.isfinite(out["tex_fg_fine"]).all():
            raise RuntimeError("the render is not finite")
    group_ms, frame_ms = [], []
    for _ in range(rounds):
        group_ms.append(timed(group, device))
        frame_ms.append(timed(frame, device))
    n = shapes.samples_per_group()
    rates = sorted(n / (t / 1e3) for t in group_ms)
    prof_g, prof_f = device_profile(group, device), device_profile(frame,
                                                                   device)
    return {
        "metric": "ray_samples_per_sec",
        "value": statistics.median(rates), "unit": "ray-samples/s",
        "min": rates[0], "max": rates[-1],
        "samples_per_group": n, "patches_per_group": shapes.group,
        "group_ms": spread(group_ms),
        "group_device_busy_ms": prof_g["device_busy_ms"],
        "group_device_ops": prof_g["device_ops"],
        "ms_per_frame": statistics.median(frame_ms),
        "ms_per_frame_min": min(frame_ms), "ms_per_frame_max": max(frame_ms),
        "frame_device_busy_ms": prof_f["device_busy_ms"],
        "frame_device_ops": prof_f["device_ops"],
        "tile_group": tile_group, "peak_bytes": _peak(device),
        "rounds": rounds}


@torch.enable_grad()
def train(model, batch, cfg: dict, rounds: int = 8, device="cuda") -> dict:
    """The training readings: the faithful GAN step and the single-render
    step, each on its own copy of the seeded generator and discriminator,
    stepping in turns (gradients on, whatever the caller's mode)."""
    from .losses import VGGLoss
    from .models import DiscriminatorVis, init_like_flax
    from .training import create_train_state, make_train_step

    def trainer(faithful: bool):
        c = copy.deepcopy(cfg)
        c["training"]["reference_faithful_gan"] = faithful
        gen_model = copy.deepcopy(model)
        disc = DiscriminatorVis()
        init_like_flax(disc, torch.Generator().manual_seed(SEED + 1))
        vgg = VGGLoss()
        init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
        disc, vgg = disc.to(device), vgg.to(device)
        state = create_train_state(gen_model, disc, c)
        step = make_train_step(gen_model, disc, c, vgg)
        g = torch.Generator(device=device).manual_seed(SEED + 3)
        logs = []

        def run():
            logs.append(step(state, batch, g))
        return run, logs

    _peak_reset(device)
    runs = {"faithful": trainer(True), "single": trainer(False)}
    for run, _ in runs.values():                          # warm-up
        run()
    ms = {k: [] for k in runs}
    for _ in range(rounds):
        for k, (run, _) in runs.items():
            ms[k].append(timed(run, device))
    prof = {k: device_profile(run, device) for k, (run, _) in runs.items()}
    for k, (_, logs) in runs.items():
        for lg in logs:
            for name, v in lg.items():
                if not torch.isfinite(v).all():
                    raise RuntimeError(f"{k} step: {name} = {v}")
    return {
        "metric": "train_step_ms",
        "value": statistics.median(ms["faithful"]),
        "unit": "ms/step (faithful two-forward GAN)",
        "min": min(ms["faithful"]), "max": max(ms["faithful"]),
        "single_render_ms": statistics.median(ms["single"]),
        "single_render_ms_min": min(ms["single"]),
        "single_render_ms_max": max(ms["single"]),
        "step_device_busy_ms": prof["faithful"]["device_busy_ms"],
        "step_device_ops": prof["faithful"]["device_ops"],
        "single_render_device_busy_ms": prof["single"]["device_busy_ms"],
        "single_render_device_ops": prof["single"]["device_ops"],
        "peak_bytes": _peak(device), "rounds": rounds}


def run(train_mode: bool = False, tile_group: int = 1, rounds: int = 8,
        device: str = "cuda", cfg: Optional[dict] = None,
        shapes: Optional[Shapes] = None) -> dict:
    """The JSON object the entry point prints: the readings plus the
    device they were taken on."""
    from .config import default_cfg
    if resolve_device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        where = card()
    else:
        where = {"device": "cpu", "power_limit": None}
    cfg = cfg if cfg is not None else default_cfg()
    shapes = shapes or Shapes()
    model, batch = build(cfg, shapes, device)
    res = (train(model, batch, cfg, rounds, device) if train_mode
           else serve(model, batch, shapes, tile_group, rounds, device))
    res.update(where)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train", action="store_true",
                    help="time the train step instead of serving")
    ap.add_argument("--tile-group", type=int, default=1,
                    help="stride offsets a render_full_image call")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    res = run(args.train, args.tile_group, args.rounds, args.device)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
