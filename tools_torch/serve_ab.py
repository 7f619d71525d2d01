#!/usr/bin/env python3
"""Serving A/B of two checkouts of the PyTorch port on one GPU.

    python3 tools_torch/serve_ab.py --base DIR [--rounds 8] [--train]

Starts one worker process per checkout (``DIR`` and the checkout holding
this script).  Each builds its own kernels and holds the setup of
``chip_smoke.py`` phase 3: ``configs/vanerf.json`` at full width with the
seeded flax-style initialisation, the 256^2 subdiv=3 two-hand fixture,
TF32 off.  The environment picks the configuration for both workers
(``VANERF_COMPUTE_DTYPE``, ``VANERF_FUSED_MLP``, ``VANERF_FUSED_TRAIN``).
After a warm-up the workers are asked in turns (base, this, this, base per
round) for one full frame (``render_full_image``, 16 64x64 tiles, 64+64
samples) and one bench-shaped group of 16 mask-centred 64x64 patches
sharing one encode, each timed on the host clock ending in
``torch.cuda.synchronize()``, then the frame once more under
``torch.profiler`` for the device's busy time (``bench.device_profile``:
the union of its kernels' intervals).  With ``--train`` a reading also
times one faithful GAN step (``make_train_step``, as ``bench.py --train``
and ``chip_smoke.py`` phase 5 step) and its busy time the same way.  Only
one worker runs at a time.  Prints every reading and, as the last line, a
JSON object with the readings and the median, minimum and maximum per
checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

THIS_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = W = 256
SUBDIV = 3
PATCH = 64
S_C = S_F = 64
SEED = 0


def worker(repo: str, train: bool) -> None:
    sys.path.insert(0, repo)
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.bench import device_profile
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    from vanerf_tpu_torch.ops import _cuda
    import vanerf_tpu_torch
    assert os.path.dirname(os.path.dirname(vanerf_tpu_torch.__file__)) == \
        os.path.abspath(repo), "imported the port from the wrong checkout"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    dev = torch.device("cuda")
    cfg = default_cfg()
    batch_np, _faces, num_v = make_synthetic_batch(
        batch_size=2, H=H, W=W, subdiv=SUBDIV, device=dev)
    frames = [to_torch({k: (v[i:i + 1] if k not in ("faces", "znear", "zfar")
                            else v) for k, v in batch_np.items()}, dev)
              for i in range(2)]
    model = VANeRF.from_config(cfg, num_v=num_v, image_hw=(H, W))
    init_like_flax(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()

    @torch.no_grad()
    def frame():
        return tr.render_full_image(model, frames[1], level=3,
                                    sample_per_ray_c=S_C,
                                    sample_per_ray_f=S_F)

    step = None
    if train:
        import copy
        from vanerf_tpu_torch.losses import VGGLoss
        from vanerf_tpu_torch.models import DiscriminatorVis
        from vanerf_tpu_torch.training import (create_train_state,
                                               make_train_step)
        gen_model = copy.deepcopy(model)
        disc = DiscriminatorVis()
        init_like_flax(disc, torch.Generator().manual_seed(SEED + 1))
        vgg = VGGLoss()
        init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
        state = create_train_state(gen_model, disc.to(dev), cfg)
        train_step = make_train_step(gen_model, disc, cfg, vgg.to(dev))
        gen = torch.Generator(device=dev).manual_seed(SEED + 3)

        def step():
            with torch.enable_grad():
                logs = train_step(state, frames[0], gen)
            if not all(bool(torch.isfinite(v).all()) for v in logs.values()):
                raise AssertionError("non-finite train step")

    def one():
        t0 = time.perf_counter()
        out = frame()
        torch.cuda.synchronize()
        frame_ms = (time.perf_counter() - t0) * 1e3
        if not bool(torch.isfinite(out["tex_fg_fine"]).all()):
            raise AssertionError("non-finite frame")
        b = frames[0]
        gen = torch.Generator().manual_seed(SEED + 1)
        t0 = time.perf_counter()
        with torch.no_grad():
            cached = tr.encode_frame(model, b)
            for _ in range(16):
                grids = tr.mask_centered_grid(gen, b["tar_mask"][..., 0],
                                              PATCH, PATCH)
                tr.render_patch(model, b, grids=grids, out_h=PATCH,
                                out_w=PATCH, sample_per_ray_c=S_C,
                                sample_per_ray_f=S_F, compute_vis_map=False,
                                cached=cached)
        torch.cuda.synchronize()
        group_ms = (time.perf_counter() - t0) * 1e3
        res = {"frame_ms": frame_ms, "group_ms": group_ms,
               "frame_busy_ms": device_profile(frame, dev)["device_busy_ms"]}
        if step is not None:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            res["step_ms"] = (time.perf_counter() - t0) * 1e3
            res["step_busy_ms"] = device_profile(step, dev)["device_busy_ms"]
        return res

    for _ in range(2):          # cuDNN and allocator warm-up
        one()
    print("ready", flush=True)
    for line in sys.stdin:
        if line.strip() != "go":
            break
        print(json.dumps(one()), flush=True)


def summary(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="checkout to compare against")
    ap.add_argument("--rounds", type=int, default=8,
                    help="rounds of base, this, this, base")
    ap.add_argument("--train", action="store_true",
                    help="also time one faithful GAN step a reading")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.train)
        return 0
    repos = {"base": os.path.abspath(args.base), "this": THIS_REPO}
    procs = {}
    try:
        for tag, repo in repos.items():     # set up one after the other
            p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                  "--worker", repo]
                                 + (["--train"] if args.train else []),
                                 stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, text=True)
            procs[tag] = p
            if p.stdout.readline().strip() != "ready":
                raise RuntimeError(f"{tag} worker failed to start")
        readings = {tag: [] for tag in repos}
        for r in range(args.rounds):
            for tag in ("base", "this", "this", "base"):
                p = procs[tag]
                p.stdin.write("go\n")
                p.stdin.flush()
                line = p.stdout.readline()
                if not line:
                    raise RuntimeError(f"{tag} worker died")
                res = json.loads(line)
                readings[tag].append(res)
                print(f"round {r} {tag}: " + ", ".join(
                    f"{k} {v:.2f}" for k, v in res.items()), flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.stdin.close()
                p.wait(timeout=120)
    out = {"repos": repos, "readings": readings}
    for tag, rs in readings.items():
        out[tag] = {k: summary([x[k] for x in rs]) for k in rs[0]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
