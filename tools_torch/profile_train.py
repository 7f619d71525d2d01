#!/usr/bin/env python3
"""Where the time of the port's GAN train step goes, on one GPU.

    python3 tools_torch/profile_train.py [--steps 16] [--out FILE]

Holds the setup of ``chip_smoke.py`` phase 5: ``configs/vanerf.json`` at
full width, the 256^2 subdiv=3 fixture, a seeded ``DiscriminatorVis``,
the seed-19 VGG19, faithful GAN steps on mask-centred 64x64 patches with
64+64 samples, TF32 off.  After two warm-up steps it measures:

  1. the take_rows route A/B: ``--steps`` steps in turns (on, off, off,
     on, ...), where "off" sends every gather through the native gather
     and its scatter backward (``onehot_gather.SCATTER_MAX_T = 0``); wall
     ms per step on the host clock ending in ``torch.cuda.synchronize()``,
     and kernel 13's launches per step in each arm;
  2. the two Adam updates alone (CUDA events, 10 repetitions);
  3. ``torch.profiler`` over two steps: device operations (kernels,
     copies, fills) per step, device busy time (the union of their
     intervals), the idle share of the profiled span, and the device time
     per kernel name.

Prints a summary and, as the last line, a JSON object of every number;
``--out`` also writes the full per-kernel table there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    from _profile import summarize, write_table
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    from vanerf_tpu_torch.ops import _cuda, onehot_gather
    from vanerf_tpu_torch.training import create_train_state, make_train_step

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    dev = torch.device("cuda")
    cfg = default_cfg()
    batch_np, _faces, num_v = make_synthetic_batch(
        batch_size=1, H=cs.H, W=cs.W, subdiv=cs.SUBDIV, device=dev)
    batch = to_torch(batch_np, dev)
    model = VANeRF.from_config(cfg, num_v=num_v, image_hw=(cs.H, cs.W))
    init_like_flax(model, torch.Generator().manual_seed(cs.SEED))
    gen_model, disc, vgg = cs.train_parts(model, dev)
    state = create_train_state(gen_model, disc, cfg)
    step = make_train_step(gen_model, disc, cfg, vgg)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    max_t = onehot_gather.SCATTER_MAX_T

    def timed_step(route: bool):
        onehot_gather.SCATTER_MAX_T = max_t if route else 0
        onehot_gather.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = step(state, batch, gen)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        onehot_gather.SCATTER_MAX_T = max_t
        for k, v in logs.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{k} = {v}")
        return ms, onehot_gather.launches

    for _ in range(2):
        timed_step(True)

    # ---- 1: route A/B in turns ----
    arms = {"on": [], "off": []}
    launches = {"on": set(), "off": set()}
    order = ("on", "off", "off", "on")
    for i in range(args.steps):
        arm = order[i % 4]
        ms, n = timed_step(arm == "on")
        arms[arm].append(ms)
        launches[arm].add(n)
    if launches["off"] != {0} or 0 in launches["on"]:
        raise AssertionError(f"route A/B did not toggle: {launches}")

    # ---- 2: the Adam updates alone ----
    adam = {}
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        grads = [torch.full_like(p, 1e-3) for p in opt.params]
        adam[tag] = cs.cuda_ms(lambda: opt.step(grads), 10)
        adam[f"{tag}_tensors"] = len(opt.params)
        adam[f"{tag}_bytes_moved"] = 7 * 4 * sum(p.numel()
                                                 for p in opt.params)

    # ---- 3: torch.profiler over two steps ----
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(state, batch, gen)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    p, table = summarize(prof, 2, prof_wall_ms)

    res = {
        "gpu": torch.cuda.get_device_name(0),
        "ms_per_step": {arm: {"median": statistics.median(v), "min": min(v),
                              "max": max(v), "all": v}
                        for arm, v in arms.items()},
        "scatter_launches_per_step": {k: sorted(v)
                                      for k, v in launches.items()},
        "adam_ms": adam,
        "profile": p,
    }
    for arm, v in res["ms_per_step"].items():
        print(f"route {arm}: median {v['median']:.2f} ms/step "
              f"({v['min']:.2f}-{v['max']:.2f}, {len(v['all'])} steps)")
    print(f"profile: {p['device_ops_per_step']:.0f} device ops/step, "
          f"device busy {p['device_busy_ms_per_step']:.2f} ms/step of "
          f"{p['wall_ms_per_step']:.2f} ms wall under the profiler, idle "
          f"share {p['idle_share_of_span']:.3f}")
    print(f"adam: G {adam['g']:.3f} ms ({adam['g_tensors']} tensors), "
          f"D {adam['d']:.3f} ms")
    for row in p["top"]:
        print(f"  {row['ms_per_step']:9.3f} ms  "
              f"{row['launches_per_step']:7.1f}  {row['name']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            write_table(f, table, 2, "step")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
