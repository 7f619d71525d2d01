"""Training cells: the faithful GAN step, one sample a step.

Set-up builds the program's step once (generator, discriminator, VGG loss
and both Adam states, on the benchmark's seeded weights), drives it from
the seed through its first three steps, which compile and warm it up,
and hands that same object to the window.  Every step takes the next
sample of a pool made in set-up (its host-to-device copy first, as a data
loader's batch) and draws made by the benchmark from the seed: the patch
grid, the stratified jitter, the importance uniforms and the radiance
noise, for the generator's render and for the discriminator's.  The
reference of the configuration's family (``benchmark/families/``) follows
the first three steps from the same weights, samples and draws once the
window has closed and the program's state is freed.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import devtrace, inputs, serve, weights

FOLLOWED = 3          # steps the reference follows


def skeletons(fam, cfg: dict, hw):
    """The family's reference generator, discriminator and VGG19 on
    ``meta``."""
    m = cfg["models"]["VANeRF"]
    with torch.device("meta"):
        return (fam.Generator(m, inputs.N_VERTS + 1, hw),
                fam.train.Discriminator(), fam.train.Vgg19())


def states(fam, cfg: dict, hw, seed: int, device) -> tuple:
    """Seeded weights of the generator, the discriminator and VGG19."""
    return tuple(weights.seeded_state(s, seed + i, device)
                 for i, s in enumerate(skeletons(fam, cfg, hw)))


def draws(seed: int, k: int, req: dict, m: dict, device) -> dict:
    """Step ``k``'s draws for the generator's ('g') and the
    discriminator's ('d') renders: a mask-centred grid (the centre drawn
    with probability proportional to the target mask), then uniforms and
    normals on the device."""
    h, w = m["train_out_h"], m["train_out_w"]
    drk = m["dr_kwargs"]
    n_c, n_f = drk["sample_per_ray_c"], drk["sample_per_ray_f"]
    mask = req["tar_mask"][0, ..., 0].numpy().astype(np.float64)
    H, W = mask.shape
    rng = np.random.default_rng([seed, k])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    out = {}
    for tag in ("g", "d"):
        p = mask.reshape(-1) / mask.sum()
        flat = int(rng.choice(H * W, p=p))
        c = np.array([flat % W - w // 2, flat // W - h // 2], np.float32)
        grid = np.minimum(np.maximum(base + c, 0.0),
                          np.float32([W - 1, H - 1]))
        P = h * w
        out[tag] = {
            "grids": torch.from_numpy(grid[None]).to(device),
            "u_c": torch.rand((1, P, n_c), generator=gen, device=device),
            "u_f": torch.rand((1, P, n_f), generator=gen, device=device),
            "noise_c": torch.randn((1, P * n_c, 1), generator=gen,
                                   device=device),
            "noise_f": torch.randn((1, P * n_f, 1), generator=gen,
                                   device=device)}
    return out


def program(cfg: dict, sd: tuple, hw, device, n_views: int):
    """The program's step object: (train state, step function)."""
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, VANeRF
    from vanerf_tpu_torch.training import (create_train_state,
                                           make_train_step)
    with torch.device(device):
        model = VANeRF.from_config(cfg, num_v=inputs.N_VERTS + 1,
                                   image_hw=hw)
        disc = DiscriminatorVis()
    model.load_state_dict(sd[0], strict=True)
    disc.load_state_dict(sd[1], strict=True)
    vgg = VGGLoss(state_dict=sd[2]).to(device)
    ts = create_train_state(model, disc, cfg)
    return ts, make_train_step(model, disc, cfg, vgg, n_views=n_views)


def _first_grad(state: dict, p) -> float:
    """The norm of the gradient Adam took at its first step: its first
    moment is then (1 - beta1) g (zero where it has taken none)."""
    m = state.get(p, {}).get("exp_avg")
    return 0.0 if m is None else float(m.norm()) / 0.1


def compare(port: dict, ref: dict) -> dict:
    """The numbers the output check can compare (``PERF.md`` says which it
    does): the relative gap of the first step's G loss and the worst over
    every followed step's G and D losses; by the worst leaf, the gap
    between the norms of the first gradient (of G's leaves, and of all) and
    of the change after the followed steps, against the reference leaf's
    norm or the median leaf's, the larger.  Leaves whose reference gradient
    is under a thousandth of the median leaf's are left out."""
    rel = [abs(p - r) / abs(r) for p, r in zip(port["loss"], ref["loss"])]
    gmed = float(np.median(list(ref["grad"].values())))
    keep = [n for n, g in ref["grad"].items() if g >= 1e-3 * gmed]

    def gaps(key, names):
        med = float(np.median([ref[key][n] for n in keep]))
        return [abs(port[key][n] - ref[key][n]) / max(ref[key][n], med)
                for n in names]
    g_leaves = [n for n in keep if n.startswith("G.")]
    return {"loss1_gap": rel[0], "loss_gap": max(rel),
            "grad_gap_g": max(gaps("grad", g_leaves)),
            "grad_gap": max(gaps("grad", keep)),
            "change_gap": max(gaps("change", keep)),
            "grad_gap_med": float(np.median(gaps("grad", keep))),
            "change_gap_med": float(np.median(gaps("change", keep)))}


def worst_leaves(port: dict, ref: dict, key: str, top: int = 3) -> list:
    """The leaves of largest gap by :func:`compare`'s measure:
    [name, program's norm, reference's norm, gap]."""
    gmed = float(np.median(list(ref["grad"].values())))
    keep = [n for n, g in ref["grad"].items() if g >= 1e-3 * gmed]
    med = float(np.median([ref[key][n] for n in keep]))
    rows = [[n, port[key][n], ref[key][n],
             abs(port[key][n] - ref[key][n]) / max(ref[key][n], med)]
            for n in keep]
    return sorted(rows, key=lambda r: -r[3])[:top]


def half_batch(dr: dict) -> dict:
    """A fault: each render's second half of rays replaced by its first, so
    that every mean is taken over half of the batch."""
    out = {}
    for tag, d in dr.items():
        out[tag] = {}
        for k, v in d.items():
            v = v.clone()
            half = v.shape[1] // 2
            v[:, half:] = v[:, :half]
            out[tag][k] = v
    return out


def follow(fam, cfg: dict, sd: tuple, hw, pool: list, seed: int, device,
           n_views: int, fault=None) -> dict:
    """The family's reference readings over the first steps: losses, first
    gradient norms, change norms.  ``fault(draws)`` changes each step's
    draws (the faults the check has to catch)."""
    m = cfg["models"]["VANeRF"]
    ref_train = fam.train
    G, D, vgg = (s.to_empty(device=device) for s in skeletons(fam, cfg, hw))
    for mod, s in zip((G, D, vgg), sd):
        mod.load_state_dict(s)
    vgg.requires_grad_(False)
    lr = cfg["training"]["lr"]
    pg = [(n, p) for n, p in G.named_parameters()]
    pd = [(n, p) for n, p in D.named_parameters()]
    opt_g = ref_train.Adam([p for _, p in pg], lr)
    opt_d = ref_train.Adam([p for _, p in pd], lr)
    losses, grad = [], {}
    for k in range(FOLLOWED):
        req = serve.to_device(pool[k], device)
        dr = draws(seed, k, pool[k], m, device)
        lg, ld, gg, gd = ref_train.step(G, D, vgg, opt_g, opt_d, req,
                                        dr if fault is None else fault(dr),
                                        cfg, n_views)
        losses += [float(lg), float(ld)]
        if k == 0:
            grad = {**{"G." + n: float(g.norm()) if g is not None else 0.0
                       for (n, _), g in zip(pg, gg)},
                    **{"D." + n: float(g.norm()) if g is not None else 0.0
                       for (n, _), g in zip(pd, gd)}}
    with torch.no_grad():
        change = {**{"G." + n: float((p - sd[0][n]).norm()) for n, p in pg},
                  **{"D." + n: float((p - sd[1][n]).norm()) for n, p in pd}}
    return {"loss": losses, "grad": grad, "change": change}


def stepper(ts, step, pool: list, seed: int, m: dict, device, alter=None):
    """``one(k)``: step ``k`` on sample ``k`` of the pool (cycled), its
    host-to-device copy first, with its draws; returns (seconds, logs)."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))

    def one(k):
        req = pool[k % len(pool)]
        t0 = time.perf_counter()
        args = (ts, serve.to_device(req, device),
                draws(seed, k, req, m, device))
        if alter is not None:
            args = alter(*args)
        logs = step(args[0], args[1], None, args[2])
        sync()
        return time.perf_counter() - t0, logs
    return one


def first_steps(ts, one, sd: tuple) -> dict:
    """The program's readings over the followed steps, taken from the
    step's own state: losses, first gradient norms, change norms."""
    names_g = [n for n, _ in ts.model.named_parameters()]
    names_d = [n for n, _ in ts.disc.named_parameters()]
    port = {"loss": []}
    for k in range(FOLLOWED):
        _, logs = one(k)
        port["loss"] += [float(logs["train/g_loss"]),
                         float(logs["train/d_loss"])]
        if k == 0:
            st_g, st_d = ts.opt_g.opt.state, ts.opt_d.opt.state
            port["grad"] = {
                **{"G." + n: _first_grad(st_g, p)
                   for n, p in zip(names_g, ts.opt_g.params)},
                **{"D." + n: _first_grad(st_d, p)
                   for n, p in zip(names_d, ts.opt_d.params)}}
    with torch.no_grad():
        port["change"] = {
            **{"G." + n: float((p - sd[0][n]).norm())
               for n, p in ts.model.named_parameters()},
            **{"D." + n: float((p - sd[1][n]).norm())
               for n, p in ts.disc.named_parameters()}}
    return port


def run(fam, cfg: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t_start: float, alter=None) -> dict:
    """One training run of the configuration ``cfg`` of family ``fam``.
    ``alter(ts, batch, draws)`` (tests only) breaks the step where it runs:
    it returns the arguments the step takes."""
    m = cfg["models"]["VANeRF"]
    n_views = int(cfg["dataset"].get("num_input_view", 1))
    H = W = traffic["image_size"]
    sd = states(fam, cfg, (H, W), seed, device)
    pool = serve.host_pool(seed, traffic, n_views, device, targets=True)
    ts, step = program(cfg, sd, (H, W), device, n_views)
    cuda = torch.device(device).type == "cuda"
    one = stepper(ts, step, pool, seed, m, device, alter)
    port = first_steps(ts, one, sd)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    lat, n = [], 0
    w0 = time.perf_counter()
    while True:
        dt, _ = one(FOLLOWED + n)
        lat.append(dt)
        n += 1
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0

    traced = None
    if trace:
        with devtrace.traced() as traced:
            t0 = time.perf_counter()
            for k in range(traffic["traced"]):
                one(FOLLOWED + n + k)
            traced_s = time.perf_counter() - t0
        traced["window_s"] = traced_s
        traced["items"] = traffic["traced"]
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    del ts, step, one
    if cuda:
        torch.cuda.empty_cache()
    ref = follow(fam, cfg, sd, (H, W), pool, seed, device, n_views)
    return {
        "attempted": n, "failed": 0, "setup_s": setup_s,
        "e2e": {"train_step_ms": 1e3 * window_s / n},
        "ctx": {"kind": "train", "items_done": n, "window_s": window_s,
                "flops_per_item": fam.step_flops(m, H, W, n_views),
                "trace": traced,
                "compute_dtype": m.get("compute_dtype", "float32")},
        "peak": peak, "readings": compare(port, ref)}
