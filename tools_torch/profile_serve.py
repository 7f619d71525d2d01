#!/usr/bin/env python3
"""Where the time of one serving patch goes under the fused-MLP switches,
under the coordinate-major point layout, under the culled nearest-vertex
search or under a serving tier, on one GPU.

    python3 tools_torch/profile_serve.py [--rounds 8] [--out FILE]
    python3 tools_torch/profile_serve.py --soa 0 1 2 [--out FILE]
    python3 tools_torch/profile_serve.py --knn-cull \
        --tier VANERF_FAR_NET=0.5 [--out FILE]

Holds the setup of ``chip_smoke.py`` phase 3b: ``configs/vanerf.json`` at
full width, the 256^2 subdiv=3 fixture, one mask-centred 64x64 patch with
64+64 samples and the encoders cached, TF32 off, the far tier off in every
configuration (``VANERF_FUSED_MLP`` is set in all of them).  After a
warm-up patch per configuration it measures:

  1. wall ms per patch (host clock ending in ``torch.cuda.synchronize()``)
     of the unfused render, ``VANERF_FUSED_MLP=2`` and
     ``VANERF_FUSED_MLP=1``, ``--rounds`` patches each in turns;
  2. per configuration, ``torch.profiler`` over two patches: device
     operations per patch, device busy time (the union of their
     intervals), the idle share of the profiled span, and the device time
     per kernel name.

With ``--soa MODE [MODE ...]`` the configurations are instead the default
unfused render (far tier ON) under ``VANERF_SOA_POINTS=MODE``, in turns:
what kernels 7 and 8 and the second point generation cost a patch.  With
``--knn-cull`` and / or ``--tier NAME=FRAC [...]`` they are the default
render (far tier ON, the culled mesh query; the mesh prepared by the patch,
as a lone ``render_patch`` does), the same with the mesh prepared ahead (as
``render_full_image`` does once a frame for its tiles), the same under
``VANERF_KNN_CULL=1`` (kernel 9 in place of B) and under each named serving
tier (``VANERF_FAR_SKIP`` / ``VANERF_FAR_NET`` / ``VANERF_FAR_TNET``).

Prints a summary and, as the last line, a JSON object of every number;
``--out`` also writes the full per-kernel tables there.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--soa", type=int, nargs="+", choices=(0, 1, 2),
                    default=None, metavar="MODE",
                    help="profile VANERF_SOA_POINTS=MODE (far tier on) "
                         "instead of the fused-MLP levels")
    ap.add_argument("--knn-cull", action="store_true",
                    help="profile the default render beside "
                         "VANERF_KNN_CULL=1 (far tier on)")
    ap.add_argument("--tier", nargs="+", default=None, metavar="NAME=FRAC",
                    help="profile the default render beside each serving "
                         "tier, e.g. VANERF_FAR_NET=0.5")
    args = ap.parse_args()

    import torch
    import chip_smoke as cs
    from _profile import summarize, write_table
    from torch.profiler import ProfilerActivity, profile
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    from vanerf_tpu_torch.ops import _cuda

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _cuda.build()
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(gpu)
    batch_np, _faces, num_v = make_synthetic_batch(
        batch_size=1, H=cs.H, W=cs.W, subdiv=cs.SUBDIV, device=dev)
    batch = to_torch(batch_np, dev)
    model = VANeRF.from_config(default_cfg(), num_v=num_v,
                               image_hw=(cs.H, cs.W))
    init_like_flax(model, torch.Generator().manual_seed(cs.SEED))
    model = model.to(dev).eval()
    cached = tr.encode_frame(model, batch)
    grids = tr.mask_centered_grid(torch.Generator().manual_seed(cs.SEED),
                                  batch["tar_mask"][..., 0], cs.PATCH,
                                  cs.PATCH)

    # configurations that get the frame's prepared meshes with the encode
    mesh_ahead = "default, mesh prepared ahead"
    if args.knn_cull or args.tier:
        configs = {"default": {}, mesh_ahead: {}}
        if args.knn_cull:
            configs["knn_cull"] = dict(VANERF_KNN_CULL="1")
        for spec in args.tier or ():
            name, _, frac = spec.partition("=")
            if name not in ("VANERF_FAR_SKIP", "VANERF_FAR_NET",
                            "VANERF_FAR_TNET") or not frac:
                ap.error(f"--tier {spec!r}: expected "
                         "VANERF_FAR_SKIP|NET|TNET=<fraction>")
            configs[spec] = {name: frac}
    elif args.soa is not None:
        configs = {f"soa{m}": dict(VANERF_SOA_POINTS=str(m))
                   for m in args.soa}
    else:
        configs = cs.FUSED_CONFIGS

    with torch.no_grad():
        cached_ahead = tuple(cached) + (
            tr.prepare_frame_meshes(batch, cached[2]),)

    def patch(name: str) -> float:
        with cs.env(**configs[name]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tr.render_patch(model, batch, grids=grids, out_h=cs.PATCH,
                            out_w=cs.PATCH, sample_per_ray_c=cs.S_C,
                            sample_per_ray_f=cs.S_F, compute_vis_map=False,
                            cached=(cached_ahead if name == mesh_ahead
                                    else cached))
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

    names = list(configs)
    for name in names:
        patch(name)
    wall = {name: [] for name in names}
    for _ in range(args.rounds):
        for name in names:
            wall[name].append(patch(name))

    res = {"gpu": gpu, "configs": configs, "patch_ms": {
        n: {"median": statistics.median(v), "min": min(v), "max": max(v),
            "all": v} for n, v in wall.items()}, "profile": {}}
    tables = {}
    for name in names:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                patch(name)
            wall_ms = (time.perf_counter() - t0) * 1e3
        res["profile"][name], tables[name] = summarize(prof, 2, wall_ms,
                                                       unit="patch", top=12)
    for name in names:
        w, p = res["patch_ms"][name], res["profile"][name]
        print(f"{name} {configs[name]}: median {w['median']:.2f} "
              f"ms/patch ({w['min']:.2f}-{w['max']:.2f}, {len(w['all'])} "
              f"patches); profile: {p['device_ops_per_patch']:.0f} device "
              f"ops/patch, device busy {p['device_busy_ms_per_patch']:.2f} "
              f"ms/patch of {p['wall_ms_per_patch']:.2f} ms wall under the "
              f"profiler, idle share {p['idle_share_of_span']:.3f}")
        for row in p["top"]:
            print(f"  {row['ms_per_patch']:9.3f} ms  "
                  f"{row['launches_per_patch']:7.1f}  {row['name']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            for name in names:
                f.write(f"== {name} {configs[name]}\n")
                write_table(f, tables[name], 2, "patch")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
