"""Serving cells: a closed loop with one client rendering novel-view frames.

Each request is a new pose with its own source view(s) and target camera.
Its frame is ``renderer.render_full_image`` at the mix's level and tile
group, timed on the host clock from the request's host-to-device copy to
the RGB frame back on the host.  The pool of requests is made in set-up
and cycled through in the window; a sample of it, drawn from the seed, is
rendered again by the plain reference of the configuration's family
(``benchmark/families/``) once the window has closed and the program's
state is freed, and compared frame by frame.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import devtrace, inputs, weights

# the range around the family's NETWORK_MODULES (network_ms.serve reads it)
NETWORK_RANGE = "bench.network"


def to_device(req: dict, device) -> dict:
    """A request's host tensors on the device (the program's batch)."""
    return {k: v.to(device, non_blocking=True) for k, v in req.items()}


def host_pool(seed: int, traffic: dict, n_views: int, device,
              targets: bool = False) -> list:
    """The pool as pinned host tensors (faces int64, znear / zfar 0-d)."""
    H = W = traffic["image_size"]
    pool = inputs.make_pool(seed, traffic["pool"], n_views, H, W, device,
                            targets)
    pin = torch.cuda.is_available() and torch.device(device).type == "cuda"
    out = []
    for req in pool:
        t = {}
        for k, v in req.items():
            x = torch.from_numpy(v)
            if k in ("znear", "zfar"):
                x = x.reshape(())
            t[k] = x.pin_memory() if pin else x
        out.append(t)
    return out


def program(cfg: dict, state: dict, hw, device):
    """The program's generator with the benchmark's weights, for serving."""
    from vanerf_tpu_torch.models import VANeRF
    with torch.device(device):
        model = VANeRF.from_config(cfg, num_v=inputs.N_VERTS + 1,
                                   image_hw=hw)
    model.load_state_dict(state, strict=True)
    return model.eval()


def seeded_weights(fam, cfg: dict, hw, seed: int, device) -> dict:
    """The generator's weights for the program and the reference alike,
    drawn over the family's reference generator."""
    with torch.device("meta"):
        skel = fam.Generator(cfg["models"]["VANeRF"], inputs.N_VERTS + 1, hw)
    return weights.seeded_state(skel, seed, device)


def shape(cfg: dict, traffic: dict) -> dict:
    """The frame's level, samples, views and tile group."""
    drk = cfg["models"]["VANeRF"]["dr_kwargs"]
    return {"level": traffic["level"], "n_c": drk["sample_per_ray_c"],
            "n_f": drk["sample_per_ray_f"],
            "n_views": int(cfg["dataset"].get("num_input_view", 1)),
            "tile_group": int(cfg["training"].get("eval_tile_group", 1))}


def render(model, req: dict, sh: dict) -> dict:
    from vanerf_tpu_torch import renderer
    return renderer.render_full_image(
        model, req, level=sh["level"], sample_per_ray_c=sh["n_c"],
        sample_per_ray_f=sh["n_f"], n_views=sh["n_views"],
        tile_group=sh["tile_group"])


def compare(port: dict, ref: dict) -> dict:
    """The numbers the check compares: the mean absolute gap of the RGB
    frame and of the depth over every pixel."""
    return {"rgb_mae": float((port["rgb"] - ref["tex_fg_fine"].cpu()).abs()
                             .mean()),
            "depth_mae": float((port["depth"] - ref["depth_fine"].cpu())
                               .abs().mean())}


def run(fam, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, alter=None) -> dict:
    """One serving run of the configuration ``cfg`` of family ``fam``.
    ``alter(frame)`` (tests only) changes each served frame where it is
    produced."""
    m = cfg["models"]["VANeRF"]
    sh = shape(cfg, traffic)
    n_views = sh["n_views"]
    H = W = traffic["image_size"]
    far_tau = float(cfg["inference"]["far_tau"])
    state = seeded_weights(fam, cfg, (H, W), seed, device)
    pool = host_pool(seed, traffic, n_views, device)
    model = program(cfg, state, (H, W), device)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def serve(i):
        t0 = time.perf_counter()
        out = render(model, to_device(pool[i % len(pool)], device), sh)
        rgb = out["tex_fg_fine"]
        if alter is not None:
            rgb = alter(rgb)
        frame = rgb.cpu()
        return time.perf_counter() - t0, frame, out["depth_fine"]

    for i in range(traffic["warmup"]):
        serve(i)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    kept, lat, n = {}, [], 0
    w0 = time.perf_counter()
    while True:
        dt, frame, depth = serve(n)
        lat.append(dt)
        if n < len(pool):                 # each request's first frame
            kept[n] = {"rgb": frame[0], "depth": depth[0].cpu()}
        n += 1
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0

    traced = None
    if trace:
        ranges = devtrace.Ranges()
        for name in fam.NETWORK_MODULES:
            ranges.attach(getattr(model, name), NETWORK_RANGE)
        with devtrace.traced() as traced:
            t0 = time.perf_counter()
            for k in range(traffic["traced"]):
                serve(n + k)
            traced_s = time.perf_counter() - t0
        ranges.detach()
        traced["window_s"] = traced_s
        traced["items"] = traffic["traced"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    del model
    if cuda:
        torch.cuda.empty_cache()
    G = fam.Generator(m, inputs.N_VERTS + 1, (H, W)).to(device)
    G.load_state_dict(state)
    G.eval()
    # a sample, drawn from the seed, of the requests served in the window
    rng = np.random.default_rng(seed)
    sample = rng.choice(sorted(kept), min(traffic["checked"], len(kept)),
                        replace=False).tolist()
    readings = {}
    for i in sample:
        ref = fam.render_frame(G, to_device(pool[i], device),
                               level=sh["level"], n_c=sh["n_c"],
                               n_f=sh["n_f"], n_views=n_views,
                               far_tau=far_tau)
        for k, v in compare(kept[i], ref).items():
            readings[k] = max(readings.get(k, 0.0), v)

    lat_ms = [x * 1e3 for x in lat]
    flop = fam.frame_flops(m, H, W, sh["level"], sh["n_c"], sh["n_f"],
                           n_views)
    return {
        "attempted": n, "failed": 0, "setup_s": setup_s,
        "e2e": {"frames_per_s": n / window_s,
                "frame_ms_p90": float(np.percentile(lat_ms, 90))},
        "ctx": {"kind": "serve", "items_done": n, "window_s": window_s,
                "flops_per_item": flop, "trace": traced,
                "compute_dtype": m.get("compute_dtype", "float32")},
        "peak": peak, "readings": readings}
