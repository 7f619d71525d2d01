#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``vanerf_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

Phases, each printing what it found; any failed check raises and the
script exits non-zero (there is no CPU fallback):

  1. build (or reuse) the five CUDA kernels from ``vanerf_tpu_torch/csrc``;
  2. each kernel against its plain-PyTorch twin on the card, at the shapes
     the serving path gives it (a 64x64-ray patch x 64 samples = 262,144
     points, the 256^2 subdiv=3 two-hand fixture: 2,560 faces, 1,284
     vertices), with its time beside the twin's;
  3. the serving path at full model width (``configs/vanerf.json``, seeded
     flax-style initialisation): ``render_full_image`` for 2 frames (16
     64x64 tiles each, 64+64 samples) and one bench-shaped group of 16
     mask-centred 64x64 patches; every kernel's launch counter must move;
  4. one 16x16-ray patch rendered on the card (kernels) and on the CPU
     (plain twins) with the same weights;
  5. training at full width: 3 faithful GAN steps
     (``training.make_train_step``) on mask-centred 64x64 patches with
     64+64 samples, a seeded ``DiscriminatorVis`` and a
     VGG19 with the flax-default initialisation drawn from seed 19; every
     loss and parameter must stay finite and the kernels of the training
     path (A, B, C and the scatter 13) must each launch; prints ms/step
     (steps 2-3) and the peak device memory;
  6. one G-loss gradient on a 16x16-ray training patch with the same
     draws on the card (kernels) and on the CPU (plain twins): the loss
     and each parameter's gradient norm compared.

A ``details:`` line holds every measured number; the line before the last
is a JSON object with one entry per kernel; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for matmuls and
convolutions.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H = W = 256
SUBDIV = 3
PATCH = 64
S_C = S_F = 64
SEED = 0

KERNELS = {
    "mesh_query": ("vanerf_tpu_torch/csrc/mesh_query.cu",
                   "vanerf_tpu/ops/mesh_query_pallas.py:1027"),
    "knn": ("vanerf_tpu_torch/csrc/knn.cu",
            "vanerf_tpu/ops/knn_pallas.py:49"),
    "rasterize": ("vanerf_tpu_torch/csrc/rasterize.cu",
                  "vanerf_tpu/ops/rasterize_pallas.py:73"),
    "interp_mxu": ("vanerf_tpu_torch/csrc/interp.cu",
                   "vanerf_tpu/ops/interp_mxu.py:92"),
    "onehot_scatter": ("vanerf_tpu_torch/csrc/onehot_scatter.cu",
                       "vanerf_tpu/ops/onehot_gather.py:86"),
}
TRAIN_STEPS = 3
# phase 6: card vs CPU.  The gradients sum in other orders on the two
# devices (cuDNN against CPU convolutions, atomics in index_add_ and the
# scatter backward of the plain gathers): the G loss to rtol 1e-4, and
# each parameter's gradient g to ||g_card - g_cpu|| <= 1e-3 ||g_cpu|| +
# 1e-6 ||all gradients||.  The second term covers gradients that are tiny
# next to the whole, where terms that cancel keep their rounding (the
# LayerNorm biases of the global-context convs, ~1e-5 of the total) and
# the structurally zero ones (conv biases in front of instance norms).
CARD_CPU_LOSS_RTOL = 1e-4
CARD_CPU_GRAD_RTOL = 1e-3
CARD_CPU_GRAD_ATOL = 1e-6


def say(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain twins at main-path shapes
# ---------------------------------------------------------------------------

def main_path_points(model, batch):
    """The coarse-pass points of one mask-centred 64x64 patch, plus the
    per-frame vertex visibility, mesh table and the projected (x, y) the
    sampler sees."""
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.ops import mesh_query
    gen = torch.Generator().manual_seed(SEED)
    grids = tr.mask_centered_grid(gen, batch["tar_mask"][..., 0], PATCH,
                                  PATCH)
    feat_geo, _feat_tex, vert_vis = tr.encode_frame(model, batch)
    cam_pos, cam_rays, z = tr.patch_rays(batch, grids, S_C)
    pts = (cam_pos[:, :, None] + cam_rays[:, :, None] * z[..., None])
    pts = pts.reshape(-1, 3).contiguous()
    mesh = mesh_query.prepare_culled_mesh(batch["verts"][0], batch["faces"],
                                          vert_vis[0])
    krt = batch["src_krt"][0]
    vh = pts @ krt[:3, :3].T + krt[:3, 3]
    xy = vh[:, :2] / vh[:, 2:3]
    uv = torch.stack([2.0 * xy[:, 0] / (W - 1.0) - 1.0,
                      2.0 * xy[:, 1] / (H - 1.0) - 1.0], -1).contiguous()
    return pts, mesh, feat_geo[0][0].contiguous(), uv


def phase_kernels(model, batch, dev):
    import torch
    from vanerf_tpu_torch.ops import (interp_mxu, knn, mesh_query,
                                      onehot_gather, rasterize)
    results = {}
    pts, mesh, geo_coarse, uv = main_path_points(model, batch)
    verts = batch["verts"][0].contiguous()
    check(pts.shape[0] == PATCH * PATCH * S_C, "main-path point count")

    # --- B: nearest vertex ---
    idx, d2 = knn.nearest_vertex_d2(pts, verts)
    idx_p, d2_p = knn.nearest_vertex_d2_plain(pts, verts)
    torch.cuda.synchronize()
    err_b = (d2 - d2_p).abs().max().item()
    check(err_b <= 1e-6 * d2_p.abs().max().item(), f"knn d2 err {err_b}")
    diff = idx.long() != idx_p.long()
    if diff.any():       # an index may differ only on an exact d2 tie
        alt = ((pts[diff] - verts[idx[diff].long()]) ** 2).sum(-1)
        check(torch.allclose(alt, d2_p[diff], rtol=1e-6, atol=0),
              "knn index differs off a tie")
    results["knn"] = dict(
        shape=f"{pts.shape[0]} points x {verts.shape[0]} vertices",
        max_abs_err=err_b, index_mismatch=int(diff.sum()),
        ms=cuda_ms(lambda: knn.nearest_vertex_d2(pts, verts), 20),
        plain_ms=cuda_ms(lambda: knn.nearest_vertex_d2_plain(pts, verts), 3))

    # --- A: mesh query, without and with the far tier ---
    far2 = 0.02 ** 2
    _sdf, _q, far = mesh_query.cal_vis_sdf_prepared(
        mesh, pts, d2, n_samples=S_C, far2=far2)
    p_c = (pts - mesh["center"]).contiguous()
    err_a = 0.0
    stats = {}
    for tag, f in (("exact", None), ("far", far)):
        got = mesh_query.point_mesh_query_vis_cuda(p_c, mesh["table"], d2, f)
        want = mesh_query.point_mesh_query_vis_plain(p_c, mesh["table"], d2,
                                                     f)
        torch.cuda.synchronize()
        e = (got[0] - want[0]).abs().max().item()
        check(e <= 1e-5 * want[0].abs().max().item() + 1e-12,
              f"mesh d2 err {e} ({tag})")
        check(torch.equal(got[2] > 0.5, want[2] > 0.5),
              f"mesh inside/outside differs ({tag})")
        agree = ((got[3] >= 0.1) == (want[3] >= 0.1)).float().mean().item()
        check(agree >= 0.97, f"mesh qvis agreement {agree} ({tag})")
        err_a = max(err_a, e)
        stats[tag] = dict(max_abs_err_d2=e, qvis_agree=agree,
                          idx_mismatch=int((got[1] != want[1]).sum()),
                          wind_mismatch=int((got[2] != want[2]).sum()))
    n_far = int(far.sum()) if far is not None else 0
    results["mesh_query"] = dict(
        shape=f"{p_c.shape[0]} points x {mesh['table'].shape[0]} faces, "
              f"{n_far} far",
        max_abs_err=err_a, detail=stats,
        ms=cuda_ms(lambda: mesh_query.point_mesh_query_vis_cuda(
            p_c, mesh["table"], d2, far), 5),
        plain_ms=cuda_ms(lambda: mesh_query.point_mesh_query_vis_plain(
            p_c, mesh["table"], d2, far), 2))

    # --- C: 256^2 raster of the mesh in the source view ---
    krt = batch["src_krt"][0]
    vh = verts @ krt[:3, :3].T + krt[:3, 3]
    xy_pix = vh[:, :2] / (vh[:, 2:3] + 1e-8)
    tri = rasterize._packed_faces(xy_pix, vh[:, 2], batch["faces"])
    face, zbuf = rasterize.raster_cuda(tri, H, W)
    face_p, zbuf_p = rasterize.raster_plain(tri, H, W)
    torch.cuda.synchronize()
    check(torch.equal(face >= 0, face_p >= 0), "raster coverage differs")
    hitm = face >= 0
    check(hitm.float().mean().item() > 0.01, "raster hit nothing")
    err_c = (zbuf[hitm] - zbuf_p[hitm]).abs().max().item()
    check(err_c <= 1e-6, f"raster zbuf err {err_c}")
    fd = face != face_p
    check(fd.float().mean().item() <= 1e-3, "raster face ids differ")
    results["rasterize"] = dict(
        shape=f"{H}x{W} pixels x {tri.shape[0]} faces",
        max_abs_err=err_c, face_mismatch=int(fd.sum()),
        ms=cuda_ms(lambda: rasterize.raster_cuda(tri, H, W), 20),
        plain_ms=cuda_ms(lambda: rasterize.raster_plain(tri, H, W), 3))

    # --- D: the 32^2 x 64 geo-coarse map at the patch's points, and a
    # 64^2 x 16 map ---
    g = torch.Generator(device=dev).manual_seed(SEED)
    maps = [geo_coarse,
            torch.randn(64, 64, 16, generator=g, device=dev)]
    err_d, ms_d, plain_d, shapes = 0.0, 0.0, 0.0, []
    for fm in maps:
        got = interp_mxu.interp_cuda(fm, uv)
        want = interp_mxu.interp_plain(fm, uv)
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        check(e <= 1e-6, f"sampler err {e}")
        err_d = max(err_d, e)
        ms_d += cuda_ms(lambda: interp_mxu.interp_cuda(fm, uv), 20)
        plain_d += cuda_ms(lambda: interp_mxu.interp_plain(fm, uv), 5)
        shapes.append("x".join(str(s) for s in fm.shape))
    results["interp_mxu"] = dict(
        shape=f"{uv.shape[0]} points on {' and '.join(shapes)} maps",
        max_abs_err=err_d, ms=ms_d, plain_ms=plain_d)

    # --- 13: the take_rows table gradient at the training path's tables:
    # the KNN vertex table (rows = vertices, the packed [this | toh] rows
    # of 2 x (72 + 29 + 1) channels) read at the nearest-vertex ids; the
    # packed 32^2 x 4*64 geometry coarse map and the packed 64^2 x 4*8
    # maps read at the texel of each point; the coarse map read at the
    # 1,284 projected vertices (the fusion's vertex table).  The twin on
    # the card is index_add_ with float atomics, which sums in another
    # (run-dependent) order: |kernel - twin| <= 1e-5 x the row's sum of |g|.
    def texel(uv_, hw):
        x = ((uv_[:, 0] + 1.0) * 0.5 * (hw - 1.0)).clamp(0.0, hw - 1.0)
        y = ((uv_[:, 1] + 1.0) * 0.5 * (hw - 1.0)).clamp(0.0, hw - 1.0)
        return (torch.floor(y) * hw + torch.floor(x)).to(torch.int32)

    Hc = geo_coarse.shape[0]
    v_uv = torch.stack([2.0 * xy_pix[:, 0] / (W - 1.0) - 1.0,
                        2.0 * xy_pix[:, 1] / (H - 1.0) - 1.0], -1)
    cases = [("knn table", idx, verts.shape[0], 2 * (72 + 29 + 1)),
             ("32^2 coarse map", texel(uv, Hc), Hc * Hc,
              4 * geo_coarse.shape[2]),
             ("64^2 map", texel(uv, 64), 64 * 64, 4 * 8),
             ("32^2 coarse map at the vertices", texel(v_uv, Hc), Hc * Hc,
              4 * geo_coarse.shape[2])]
    err_s, ms_s, plain_s, shapes, stats = 0.0, 0.0, 0.0, [], {}
    for tag, rows, T, C in cases:
        g = torch.randn(rows.shape[0], C, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(SEED))
        rows = rows.contiguous()
        got = onehot_gather.onehot_scatter_cuda(g, rows, T)
        again = onehot_gather.onehot_scatter_cuda(g, rows, T)
        want = onehot_gather.onehot_scatter_plain(g, rows, T)
        bound = onehot_gather.onehot_scatter_plain(g.abs(), rows, T)
        torch.cuda.synchronize()
        check(torch.equal(got, again), f"scatter not deterministic ({tag})")
        e = (got - want).abs()
        check(bool((e <= 1e-5 * bound + 1e-30).all()),
              f"scatter err {e.max().item()} ({tag})")
        err_s = max(err_s, e.max().item())
        k_ms = cuda_ms(lambda: onehot_gather.onehot_scatter_cuda(g, rows, T),
                       20)
        p_ms = cuda_ms(lambda: onehot_gather.onehot_scatter_plain(g, rows, T),
                       20)
        ms_s += k_ms
        plain_s += p_ms
        stats[tag] = dict(rows=T, channels=C, max_abs_err=e.max().item(),
                          rel_to_abs_sum=(e / bound.clamp(min=1e-30))
                          .max().item(), bit_equal_runs=True,
                          rows_read=int((bound > 0).any(1).sum()),
                          ms=k_ms, plain_ms=p_ms)
        shapes.append(f"{rows.shape[0]} rows into {T}x{C}")
    results["onehot_scatter"] = dict(
        shape=", ".join(shapes),
        max_abs_err=err_s, ms=ms_s, plain_ms=plain_s, detail=stats)
    return results


# ---------------------------------------------------------------------------
# phase 3: the serving path at full width
# ---------------------------------------------------------------------------

def phase_main_path(model, batches, dev):
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch import renderer as tr
    ops.reset_launches()
    torch.cuda.synchronize()
    frame_ms, outs = [], []
    for b in batches:
        t0 = time.perf_counter()
        out = tr.render_full_image(model, b, level=3, sample_per_ray_c=S_C,
                                   sample_per_ray_f=S_F)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    # bench-shaped group: 16 mask-centred 64x64 patches sharing one encode
    b = batches[0]
    gen = torch.Generator().manual_seed(SEED + 1)
    t0 = time.perf_counter()
    cached = tr.encode_frame(model, b)
    group = []
    for _ in range(16):
        grids = tr.mask_centered_grid(gen, b["tar_mask"][..., 0], PATCH,
                                      PATCH)
        group.append(tr.render_patch(
            model, b, grids=grids, out_h=PATCH, out_w=PATCH,
            sample_per_ray_c=S_C, sample_per_ray_f=S_F, cached=cached))
    torch.cuda.synchronize()
    group_s = time.perf_counter() - t0
    launches = ops.launch_counts()

    for out in outs + group:
        for k, v in out.items():
            if torch.is_tensor(v) and v.is_floating_point():
                check(torch.isfinite(v).all().item(), f"non-finite {k}")
    for out in outs:
        check(out["tex_fg_fine"].shape == (1, H, W, 3), "full-image shape")
        check(out["alpha_fine"].max().item() > 0.2,
              "full image: rays missed the hands")
    check(max(o["alpha_fine"].max().item() for o in group) > 0.2,
          "patch group: rays missed the hands")
    for name in ("mesh_query", "knn", "rasterize", "interp_mxu"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    samples = PATCH * PATCH * (S_C + S_C + S_F) * 16
    return dict(frame_ms=frame_ms, group_s=group_s,
                ray_samples_per_s=samples / group_s, launches=launches,
                alpha_fine_max=[o["alpha_fine"].max().item() for o in outs])


# ---------------------------------------------------------------------------
# phase 4: full chain, card (kernels) against CPU (plain twins)
# ---------------------------------------------------------------------------

def phase_card_vs_cpu(model, batch_np, dev):
    import torch
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    gen = torch.Generator().manual_seed(SEED + 2)
    b_cpu = to_torch(batch_np, "cpu")
    grids = tr.mask_centered_grid(gen, b_cpu["tar_mask"][..., 0], 16, 16)
    out_gpu = tr.render_patch(model, to_torch(batch_np, dev),
                              grids=grids.to(dev), out_h=16, out_w=16,
                              sample_per_ray_c=S_C, sample_per_ray_f=S_F)
    torch.cuda.synchronize()
    model_cpu = copy.deepcopy(model).cpu()
    out_cpu = tr.render_patch(model_cpu, b_cpu, grids=grids, out_h=16,
                              out_w=16, sample_per_ray_c=S_C,
                              sample_per_ray_f=S_F)
    errs = {}
    for k in ("tex_fg_fine", "alpha_fine"):
        a, c = out_gpu[k].cpu(), out_cpu[k]
        errs[k] = (a - c).abs().max().item()
        check(torch.allclose(a, c, rtol=1e-3, atol=1e-4),
              f"card vs CPU mismatch in {k}: {errs[k]}")
    check(out_cpu["alpha_fine"].max().item() > 0.2, "16x16 patch missed")
    return errs


# ---------------------------------------------------------------------------
# phase 5: the GAN train step at full width
# ---------------------------------------------------------------------------

def train_parts(model, dev):
    """A copy of the generator, a seeded discriminator and the seed-19 VGG,
    on ``dev``."""
    import torch
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, init_like_flax
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(SEED + 1))
    vgg = VGGLoss()
    init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
    return copy.deepcopy(model).to(dev), disc.to(dev), vgg.to(dev)


def phase_train(model, batch, cfg, dev):
    import torch
    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch.training import create_train_state, make_train_step
    gen_model, disc, vgg = train_parts(model, dev)
    state = create_train_state(gen_model, disc, cfg)
    step = make_train_step(gen_model, disc, cfg, vgg)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    step_ms, logs = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        logs.append(step(state, batch, gen))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    for i, lg in enumerate(logs):
        for k, v in lg.items():
            check(bool(torch.isfinite(v).all()), f"step {i}: {k} = {v}")
    for net in (gen_model, disc):
        for name, p in net.named_parameters():
            check(bool(torch.isfinite(p).all()), f"non-finite {name}")
    for name in ("mesh_query", "knn", "rasterize", "onehot_scatter"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the training path")
    check(launches["interp_mxu"] == 0, "kernel D ran under training")
    return dict(step_ms=step_ms, ms_per_step=sum(step_ms[1:]) /
                (len(step_ms) - 1), peak_bytes=peak, launches=launches,
                logs=[{k: v.item() for k, v in lg.items()} for lg in logs])


# ---------------------------------------------------------------------------
# phase 6: one G-loss gradient, card (kernels) against CPU (plain twins)
# ---------------------------------------------------------------------------

def phase_train_card_vs_cpu(model, batch_np, cfg, dev):
    import torch
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.training import generator_loss, generator_outputs
    cfg = copy.deepcopy(cfg)
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = 16
    P = 16 * 16
    gen = torch.Generator().manual_seed(SEED + 4)
    b_cpu = to_torch(batch_np, "cpu")
    from vanerf_tpu_torch import renderer as tr
    draws = {"grids": tr.mask_centered_grid(gen, b_cpu["tar_mask"][..., 0],
                                            16, 16),
             "u_c": torch.rand(1, P, S_C, generator=gen),
             "noise_c": torch.randn(1, P * S_C, 1, generator=gen),
             "u_f": torch.rand(1, P, S_F, generator=gen),
             "noise_f": torch.randn(1, P * S_F, 1, generator=gen)}
    res = []
    for where in (dev, torch.device("cpu")):
        g_model, disc, vgg = train_parts(model, where)
        out = generator_outputs(g_model, to_torch(batch_np, where), cfg,
                                draws=draws)
        loss, _ = generator_loss(out, disc, vgg, cfg)
        grads = torch.autograd.grad(loss, list(g_model.parameters()),
                                    allow_unused=True)
        names = [n for n, _ in g_model.named_parameters()]
        res.append((loss.item(), {
            n: (torch.zeros_like(p) if gr is None else gr).cpu()
            for n, p, gr in zip(names, g_model.parameters(), grads)}))
    (l_gpu, g_gpu), (l_cpu, g_cpu) = res
    total = sum(float(g.double().pow(2).sum()) for g in g_cpu.values()) ** .5
    rows = []
    for n, gc in g_cpu.items():
        nc = float(gc.double().norm())
        e = float((g_gpu[n].double() - gc.double()).norm())
        allowed = CARD_CPU_GRAD_RTOL * nc + CARD_CPU_GRAD_ATOL * total
        rows.append((e / allowed, e / nc if nc > 0 else 0.0, nc / total, n))
    rows.sort(reverse=True)
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    check(loss_err <= CARD_CPU_LOSS_RTOL, f"G loss card {l_gpu} cpu {l_cpu}")
    check(rows[0][0] <= 1.0, f"gradient of {rows[0][3]}: error "
          f"{rows[0][0]:.3g} x its bound")
    rel = max(rows, key=lambda r: r[1])
    return dict(loss_card=l_gpu, loss_cpu=l_cpu, loss_rel_err=loss_err,
                worst_of_bound=rows[0][0], worst_grad=rows[0][3],
                worst_grad_rel_err=rel[1], worst_rel_grad=rel[3],
                grad_norm=total,
                top5=[dict(name=r[3], of_bound=r[0], rel_err=r[1],
                           norm_share=r[2]) for r in rows[:5]])


def main() -> int:
    try:
        import torch
    except ImportError:
        say("FAIL: torch is not installed")
        return 1
    if not torch.cuda.is_available():
        say("FAIL: no CUDA device; the port's kernels need a GPU")
        return 1
    if not os.path.isdir(os.path.join(REPO, "vanerf_tpu_torch", "csrc")):
        say("FAIL: run chip_smoke.py from a checkout of the repository")
        return 1
    sys.path.insert(0, REPO)
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("tf32: off (torch.backends.cuda.matmul.allow_tf32 = False, "
        "torch.backends.cudnn.allow_tf32 = False)")

    from vanerf_tpu_torch import ops
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    from vanerf_tpu_torch.ops import _cuda

    # ---- phase 1: build ----
    t0 = time.perf_counter()
    prebuilt = _cuda.library_path().exists()
    lib_path = _cuda.build(verbose=True)
    _cuda.lib()
    build_s = time.perf_counter() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    say(f"phase 1 build: {os.path.basename(lib_path)} ready in "
        f"{build_s:.1f} s (compiled: {not prebuilt})")
    say(smi[0] if smi else "nvidia-smi: no output")

    # ---- fixture + model (seeded, full width) ----
    cfg = default_cfg()
    batch_np, _faces, num_v = make_synthetic_batch(
        batch_size=2, H=H, W=W, subdiv=SUBDIV, device=dev)
    frames = []
    for i in range(2):
        fb = {k: (v[i:i + 1] if k not in ("faces", "znear", "zfar") else v)
              for k, v in batch_np.items()}
        frames.append(fb)
    model = VANeRF.from_config(cfg, num_v=num_v, image_hw=(H, W))
    init_like_flax(model, torch.Generator().manual_seed(SEED))
    model = model.to(dev).eval()
    batches = [to_torch(fb, dev) for fb in frames]
    say(f"fixture: {H}x{W}, {batches[0]['verts'].shape[1]} vertices, "
        f"{batches[0]['faces'].shape[0]} faces; model "
        f"{sum(p.numel() for p in model.parameters())} parameters")

    # ---- phase 2 ----
    with torch.no_grad():
        kres = phase_kernels(model, batches[0], dev)
    for name, r in kres.items():
        say(f"phase 2 {name}: {r['shape']}: max_abs_err {r['max_abs_err']:.3g}"
            f", kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms")

    # ---- phase 3 ----
    with torch.no_grad():
        main = phase_main_path(model, batches, dev)
    say(f"phase 3 main path: full image {main['frame_ms'][0]:.1f} / "
        f"{main['frame_ms'][1]:.1f} ms per frame; 16-patch group "
        f"{main['group_s'] * 1e3:.1f} ms = {main['ray_samples_per_s']:.4g} "
        f"ray-samples/s; launches {main['launches']}")

    # ---- phase 4 ----
    with torch.no_grad():
        errs = phase_card_vs_cpu(model, frames[0], dev)
    say(f"phase 4 card vs CPU (16x16 rays, 64+64 samples): max abs err "
        f"{errs}")

    # ---- phase 5 ----
    train = phase_train(model, batches[0], cfg, dev)
    say(f"phase 5 training ({TRAIN_STEPS} faithful GAN steps, 64x64 rays, "
        f"64+64 samples): {train['ms_per_step']:.1f} ms/step (steps 2-"
        f"{TRAIN_STEPS}; all: {[round(t, 1) for t in train['step_ms']]}); "
        f"peak {train['peak_bytes'] / 2**30:.2f} GiB; launches "
        f"{train['launches']}; g_loss "
        f"{[round(lg['train/g_loss'], 4) for lg in train['logs']]}, d_loss "
        f"{[round(lg['train/d_loss'], 4) for lg in train['logs']]}")

    # ---- phase 6 ----
    vs_cpu = phase_train_card_vs_cpu(model, frames[0], cfg, dev)
    say(f"phase 6 G-loss gradient card vs CPU (16x16 rays, 64+64 samples): "
        f"loss {vs_cpu['loss_card']:.7g} / {vs_cpu['loss_cpu']:.7g} (rel "
        f"{vs_cpu['loss_rel_err']:.2e}); gradients within "
        f"{vs_cpu['worst_of_bound']:.2f} of their bound at worst "
        f"({vs_cpu['worst_grad']}); largest relative norm error "
        f"{vs_cpu['worst_grad_rel_err']:.2e} ({vs_cpu['worst_rel_grad']})")

    launches = dict(main["launches"],
                    onehot_scatter=train["launches"]["onehot_scatter"])
    kernels = []
    for name, (src, replaces) in KERNELS.items():
        r = kres[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces,
                        "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    say("details: " + json.dumps({"gpu": smi, "build_s": build_s,
                                  "kernels": kres, "main_path": main,
                                  "card_vs_cpu": errs, "train": train,
                                  "train_card_vs_cpu": vs_cpu}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
