"""The readings the output check's limits are set from.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ...

For each seed, on the cell's own frames or steps (its configuration,
traffic and tile group, as the window runs them): the program against the
plain reference of the configuration's family (the lower reading of each
number), and the control, the
reference computed with TF32 on (the nearest precision below the
configuration's float32 with TF32 off), against the same reference (the
upper reading).  A training cell's readings are over the steps the
reference follows.  One JSON line a seed; the benchmark's own runs never
run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

from . import serve
from .manifest import Manifest

ROOT = pathlib.Path(__file__).resolve().parent.parent


def tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def readings(fam, cfg: dict, traffic: dict, seed: int, device,
             n: int) -> dict:
    """The program's and the control's gaps to the reference on the first
    ``n`` requests of the seed's pool (the largest over them)."""
    H = W = traffic["image_size"]
    sh = serve.shape(cfg, traffic)
    m = cfg["models"]["VANeRF"]
    tf32(False)
    state = serve.seeded_weights(fam, cfg, (H, W), seed, device)
    pool = serve.host_pool(seed, dict(traffic, pool=n), sh["n_views"],
                           device)
    model = serve.program(cfg, state, (H, W), device)
    t0 = time.perf_counter()
    port = []
    for req in pool:
        out = serve.render(model, serve.to_device(req, device), sh)
        port.append({"rgb": out["tex_fg_fine"][0].cpu(),
                     "depth": out["depth_fine"][0].cpu()})
    t_port = time.perf_counter() - t0
    del model
    torch.cuda.empty_cache()
    G = fam.Generator(m, serve.inputs.N_VERTS + 1, (H, W)).to(device).eval()
    G.load_state_dict(state)
    kw = dict(level=sh["level"], n_c=sh["n_c"], n_f=sh["n_f"],
              n_views=sh["n_views"], far_tau=float(cfg["inference"]["far_tau"]))
    res = {"seed": seed, "program": {}, "control": {}}
    t0 = time.perf_counter()
    for k, req in enumerate(pool):
        req_d = serve.to_device(req, device)
        tf32(False)
        ref = fam.render_frame(G, req_d, **kw)
        t_ref = time.perf_counter() - t0
        tf32(True)
        low = fam.render_frame(G, req_d, **kw)
        tf32(False)
        ctl = {"rgb": low["tex_fg_fine"].cpu(), "depth": low["depth_fine"].cpu()}
        for side, got in (("program", port[k]), ("control", ctl)):
            for name, v in serve.compare(got, ref).items():
                res[side][name] = max(res[side].get(name, 0.0), v)
    res["seconds"] = {"program_frames": t_port, "reference_first_frame": t_ref,
                      "reference_and_control": time.perf_counter() - t0}
    return res


def train_readings(fam, cfg: dict, traffic: dict, seed: int,
                   device) -> dict:
    """The program's and the control's gaps to the reference over the
    steps the reference follows."""
    from . import train
    m = cfg["models"]["VANeRF"]
    V = int(cfg["dataset"].get("num_input_view", 1))
    H = W = traffic["image_size"]
    tf32(False)
    sd = train.states(fam, cfg, (H, W), seed, device)
    pool = serve.host_pool(seed, dict(traffic, pool=train.FOLLOWED), V,
                           device, targets=True)
    ts, step = train.program(cfg, sd, (H, W), device, V)
    t0 = time.perf_counter()
    port = train.first_steps(ts, train.stepper(ts, step, pool, seed, m,
                                               device), sd)
    t_port = time.perf_counter() - t0
    del ts, step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = train.follow(fam, cfg, sd, (H, W), pool, seed, device, V)
    t_ref = time.perf_counter() - t0
    tf32(True)
    ctl = train.follow(fam, cfg, sd, (H, W), pool, seed, device, V)
    tf32(False)
    half = train.follow(fam, cfg, sd, (H, W), pool, seed, device, V,
                        fault=train.half_batch)
    return {"seed": seed, "program": train.compare(port, ref),
            "control": train.compare(ctl, ref),
            "half_batch": train.compare(half, ref),
            "losses": {"program": port["loss"], "reference": ref["loss"],
                       "control": ctl["loss"]},
            "worst": {side: {key: train.worst_leaves(got, ref, key)
                             for key in ("grad", "change")}
                      for side, got in (("program", port), ("control", ctl))},
            "seconds": {"program_steps": t_port, "reference_steps": t_ref}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=None,
                    help="requests a seed (default: the traffic's 'checked')")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    mf = Manifest(ROOT / "BENCHMARK.json")
    cfg, traffic = mf.config(args.workload), mf.traffic(args.workload)
    fam = mf.family(args.workload)
    for seed in args.seeds:
        r = (readings(fam, cfg, traffic, seed, "cuda",
                      args.frames or traffic["checked"])
             if traffic["kind"] == "serve"
             else train_readings(fam, cfg, traffic, seed, "cuda"))
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
