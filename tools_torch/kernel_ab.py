#!/usr/bin/env python3
"""Kernel A/B of two checkouts of the PyTorch port on one GPU: kernels A
(the culled mesh query, ``mesh_query.point_mesh_query_vis_culled``), B
(``knn.nearest_vertex_d2``), C (``rasterize.raster_cuda``), D
(``interp_mxu.interp_cuda``), 10 (``interp_mxu.row_gather_cuda``, the
patch's nearest-vertex rows of a seeded 1,284 x 204 table, float32 and
bfloat16), 5 and 6 (``mesh_query._brute_cuda``, the
exact query over every face, in ray and solid-angle mode), 9
(``knn.nearest_vertex_d2_culled`` and ``_T_culled``, on the main path's
ray-major order and with points and vertices in Morton order, beside B on
the Morton-ordered inputs), 11 (``fused_mlp.fused_query_mlp_cuda``), 12
(``fused_mlp.fused_geo_mlp_cuda``), both also in bfloat16 (``11bf16``,
``12bf16``) and 13
(``onehot_gather.onehot_scatter_cuda``) at the main path's shapes.

    python3 tools_torch/kernel_ab.py --base DIR [--rounds 4] [--kernels A B]

The checkout holding this script builds the inputs once, as
``chip_smoke.py`` phase 2 does (``configs/vanerf.json`` at full width,
seeded flax-style initialisation, the 256^2 subdiv=3 two-hand fixture, the
coarse pass of one mask-centred 64x64 patch): the patch's 262,144 points,
the frame's mesh and vertex visibility and the points' nearest-vertex
bounds for A (16-ray x 8-sample tiles, far tier on, as a frame calls it)
and B and 9, the frame's uncentred faces and corner visibility for 5 and 6
(each checkout builds its own face table with its ``brute_face_table``,
outside the timing), the source view's 256^2 raster of the mesh for C,
the two maps D samples at the patch's projected points, the arguments and
weights the model's level-2 / level-1 branches hand kernels 11 / 12 for
the patch (in bfloat16 those of the same weights' bfloat16 model, made as
``chip_smoke.py`` phase 2b makes it), and the row ids of 13's four tables (the cases the kernels line
sums).  One
worker process per checkout (``DIR`` and this one) builds its own kernels,
prepares the mesh with its own ``prepare_culled_mesh``, packs 11 / 12's
weights with its own ``pack_query_weights`` / ``pack_geo_weights`` (once,
as a frame does) and times each case
with CUDA events, as called (mean of 20 calls after a warm-up, ``eager``)
and as the device runs it (20 calls captured in a CUDA graph and
replayed, ``graph``); the gradients of 13 are drawn in the worker from the
same seed.  The workers
are asked in turns, base, this, this, base per round; only one runs at a
time.  With ``--profile`` each worker then reports the device time of
every CUDA kernel each case launches (torch.profiler over 5 calls).
Each worker also hashes each case's outputs once, and the script says per
case whether the two checkouts' outputs are equal to the bit.  Prints
every reading and, as the last line, a JSON object with the readings,
profiles, that equality, and the median, minimum and maximum per checkout
and case.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import subprocess
import sys

THIS_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = os.path.join(THIS_REPO, "build", "kernel_ab_inputs.pt")
SEED = 0


def make_inputs() -> None:
    """Every case's inputs as chip_smoke.py's phase 2 makes them (of D and
    13 the cases its kernels line sums), saved to INPUTS."""
    sys.path.insert(0, THIS_REPO)
    import torch
    import chip_smoke as cs
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data import make_synthetic_batch, to_torch
    from vanerf_tpu_torch.models import VANeRF, init_like_flax
    from vanerf_tpu_torch.ops import knn, rasterize
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    batch_np, _faces, num_v = make_synthetic_batch(
        batch_size=1, H=cs.H, W=cs.W, subdiv=cs.SUBDIV, device=dev)
    batch = to_torch(batch_np, dev)
    model = VANeRF.from_config(default_cfg(), num_v=num_v,
                               image_hw=(cs.H, cs.W))
    init_like_flax(model, torch.Generator().manual_seed(cs.SEED))
    model = model.to(dev).eval()
    with torch.no_grad():
        pts, _m, geo_coarse, uv, grids, vert_vis = cs.main_path_points(
            model, batch)
        verts = batch["verts"][0].contiguous()
        idx, d2 = knn.nearest_vertex_d2(pts, verts)
        krt = batch["src_krt"][0]
        vh = verts @ krt[:3, :3].T + krt[:3, 3]
        xy = vh[:, :2] / (vh[:, 2:3] + 1e-8)
        v_uv = torch.stack([2.0 * xy[:, 0] / (cs.W - 1.0) - 1.0,
                            2.0 * xy[:, 1] / (cs.H - 1.0) - 1.0], -1)
        d = [(t, f, u) for t, main, f, u in
             cs.interp_cases(geo_coarse, uv, dev) if main]
        s = [(t, r, n, c) for t, main, r, n, c in
             cs.scatter_cases(idx, verts.shape[0], geo_coarse, uv, v_uv, dev)
             if main]
        tri = rasterize._packed_faces(xy, vh[:, 2], batch["faces"])
        fin = cs.fused_main_path_inputs(model, batch, grids)
        fin16 = cs.fused_main_path_inputs(
            cs.bf16_model(model, default_cfg(), num_v), batch, grids)

    fused = {}
    for sfx, got in (("", fin), ("_bf16", fin16)):
        for name, n_data in (("fused_query_mlp", 4), ("fused_geo_mlp", 3)):
            a, k = got[name]
            k = {key: v for key, v in k.items() if key != "packed"}
            fused[name + sfx] = (
                _to([t.contiguous() for t in a[:n_data]], "cpu"),
                _to(a[n_data], "cpu"), k)
    os.makedirs(os.path.dirname(INPUTS), exist_ok=True)
    torch.save({"interp": [(t, f.cpu(), u.cpu()) for t, f, u in d],
                "scatter": [(t, r.cpu(), n, c) for t, r, n, c in s],
                "raster": (tri.cpu(), cs.H, cs.W), "fused": fused,
                "mesh": dict(pts=pts.cpu(), verts=verts.cpu(),
                             faces=batch["faces"].cpu(),
                             vert_vis=vert_vis.cpu(), d2=d2.cpu(),
                             n_samples=cs.S_C, far2=0.02 ** 2)}, INPUTS)


def _to(x, dev):
    """A nest of dicts, lists and tuples of tensors moved to ``dev``."""
    import torch
    if torch.is_tensor(x):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: _to(v, dev) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to(v, dev) for v in x)
    return x


def worker(repo: str, kernels) -> None:
    # the timers of this checkout's chip_smoke.py, whichever port is timed
    spec = importlib.util.spec_from_file_location(
        "kernel_ab_timers", os.path.join(THIS_REPO, "chip_smoke.py"))
    timers = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timers)
    sys.path.insert(0, repo)
    import torch
    import vanerf_tpu_torch
    from vanerf_tpu_torch.ops import (_cuda, fused_mlp, interp_mxu, knn,
                                      mesh_query, onehot_gather, rasterize)
    assert os.path.dirname(os.path.dirname(vanerf_tpu_torch.__file__)) == \
        os.path.abspath(repo), "imported the port from the wrong checkout"
    _cuda.build()
    dev = torch.device("cuda")
    data = torch.load(INPUTS)
    d = [(f"D {t}", f.to(dev), u.to(dev)) for t, f, u in data["interp"]]
    s = []
    for t, r, n, c in data["scatter"]:
        r = r.to(dev)
        g = torch.randn(r.shape[0], c, device=dev,
                        generator=torch.Generator(device=dev)
                        .manual_seed(SEED))
        s.append((f"13 {t}", g, r, n))

    m = {k: v.to(dev) if torch.is_tensor(v) else v
         for k, v in data["mesh"].items()}
    mesh = mesh_query.prepare_culled_mesh(m["verts"], m["faces"],
                                          m["vert_vis"])
    p_c = (m["pts"] - mesh["center"]).contiguous()
    tiles = mesh_query.tile_geometry(p_c.shape[0], m["n_samples"])

    cases = []
    if "A" in kernels:
        cases.append(("A", lambda: mesh_query.point_mesh_query_vis_culled(
            p_c, mesh, m["d2"], tiles, m["far2"])))
    if "B" in kernels:
        cases.append(("B", lambda: knn.nearest_vertex_d2(m["pts"],
                                                         m["verts"])))
    if "9" in kernels:
        pts_T = m["pts"].t().contiguous()
        order_v = mesh_query._morton_order(m["verts"])
        p_s = m["pts"][mesh_query._morton_order(m["pts"])].contiguous()
        p_s_T = p_s.t().contiguous()
        v_s = m["verts"][order_v].contiguous()
        cases += [
            ("9 ray-major", lambda: knn.nearest_vertex_d2_culled(
                m["pts"], m["verts"])),
            ("9_T ray-major", lambda: knn.nearest_vertex_d2_T_culled(
                pts_T, m["verts"])),
            ("9 Morton", lambda: knn.nearest_vertex_d2_culled(p_s, v_s)),
            ("9_T Morton", lambda: knn.nearest_vertex_d2_T_culled(p_s_T,
                                                                  v_s)),
            ("B Morton", lambda: knn.nearest_vertex_d2(p_s, v_s))]
    for tag, vis in (("5", False), ("6", True)):
        if tag in kernels:
            tri = m["verts"][m["faces"].long()].contiguous()
            fv = m["vert_vis"][..., 0][m["faces"].long()] if vis else None
            table = mesh_query.brute_face_table(tri, fv)
            cases += [(f"{tag} {mode}",
                       lambda mode=mode, vis=vis, table=table:
                       mesh_query._brute_cuda(m["pts"], table, vis, mode))
                      for mode in ("ray", "solid_angle")]
    if "C" in kernels:
        tri, Hr, Wr = data["raster"]
        tri = tri.to(dev)
        cases.append(("C", lambda: rasterize.raster_cuda(tri, Hr, Wr)))
    if "D" in kernels:
        cases += [(t, lambda f=f, u=u: interp_mxu.interp_cuda(f, u))
                  for t, f, u in d]
    for tag, name, pack, fn in (
            ("11", "fused_query_mlp", fused_mlp.pack_query_weights,
             fused_mlp.fused_query_mlp_cuda),
            ("12", "fused_geo_mlp", fused_mlp.pack_geo_weights,
             fused_mlp.fused_geo_mlp_cuda),
            ("11 bf16", "fused_query_mlp_bf16", fused_mlp.pack_query_weights,
             fused_mlp.fused_query_mlp_cuda),
            ("12 bf16", "fused_geo_mlp_bf16", fused_mlp.pack_geo_weights,
             fused_mlp.fused_geo_mlp_cuda)):
        if tag.replace(" ", "") in kernels:
            args, wts, kw = data["fused"][name]
            args = [t.to(dev) for t in args]
            wts = _to(wts, dev)
            packed = pack(wts, args[1].shape[1], kw["sp_level"])
            cases.append((tag, lambda fn=fn, args=args, packed=packed, kw=kw:
                          fn(*args, packed, **kw)))
    if "10" in kernels:
        # the main path's rows (the patch's nearest vertices) of a seeded
        # 1,284 x 204 table, in both dtypes
        ridx = knn.nearest_vertex_d2(m["pts"], m["verts"])[0]
        tbl = torch.randn(m["verts"].shape[0], 204, device=dev,
                          generator=torch.Generator(device=dev)
                          .manual_seed(SEED))
        cases += [(f"10 {n}", lambda t=t: interp_mxu.row_gather_cuda(t, ridx))
                  for n, t in (("f32", tbl), ("bf16", tbl.to(torch.bfloat16)))]
    if "13" in kernels:
        cases += [(t, lambda g=g, r=r, n=n:
                   onehot_gather.onehot_scatter_cuda(g, r, n))
                  for t, g, r, n in s]

    def one():
        res = {}
        for tag, fn in cases:
            res[f"{tag} eager"] = timers.cuda_ms(fn, 20)
            res[f"{tag} graph"] = timers.graph_ms(fn)
        return res

    def profile():
        """Device time of each CUDA kernel a case launches (torch.profiler,
        5 calls), as {case: {kernel: us per call}}."""
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as prof
        res = {}
        for tag, fn in cases:
            torch.cuda.synchronize()
            with prof(activities=[ProfilerActivity.CUDA]) as p:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            res[tag] = {}
            for e in p.key_averages():
                t = getattr(e, "device_time_total", None)
                t = getattr(e, "cuda_time_total", 0) if t is None else t
                if t > 0:
                    res[tag][e.key] = t / 5
        return res

    one()
    # a digest of each case's outputs, to tell whether the checkouts'
    # results are equal to the bit
    print("ready " + json.dumps({tag: _digest(fn()) for tag, fn in cases}),
          flush=True)
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "go":
            print(json.dumps(one()), flush=True)
        elif cmd == "profile":
            print(json.dumps(profile()), flush=True)
        else:
            break


def _digest(out) -> str:
    """sha256 of the bytes of every tensor in a nest of outputs."""
    import hashlib
    import torch
    h = hashlib.sha256()

    def walk(x):
        if torch.is_tensor(x):
            h.update(x.detach().contiguous().view(torch.uint8).cpu()
                     .numpy().tobytes())
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(out)
    return h.hexdigest()


def summary(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--base", help="checkout to compare against")
    ap.add_argument("--rounds", type=int, default=4,
                    help="rounds of base, this, this, base")
    ap.add_argument("--profile", action="store_true",
                    help="also print each case's kernels' device time "
                         "(torch.profiler) in both checkouts")
    names = ["A", "B", "C", "D", "5", "6", "9", "10", "11", "12", "11bf16",
             "12bf16", "13"]
    ap.add_argument("--kernels", nargs="+", default=names, choices=names,
                    help="the kernels to time (default: all thirteen)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.kernels)
        return 0
    make_inputs()
    repos = {"base": os.path.abspath(args.base), "this": THIS_REPO}
    procs, digests = {}, {}
    try:
        for tag, repo in repos.items():
            p = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                  "--worker", repo, "--kernels",
                                  *args.kernels], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE, text=True)
            procs[tag] = p
            line = p.stdout.readline()
            if not line.startswith("ready "):
                raise RuntimeError(f"{tag} worker failed to start")
            digests[tag] = json.loads(line[len("ready "):])
        bit_equal = {case: digests["base"][case] == digests["this"][case]
                     for case in digests["this"]}
        print("outputs equal to the bit: " + ", ".join(
            f"{case} {eq}" for case, eq in bit_equal.items()), flush=True)
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
                    f"{k} {v:.4f} ms" for k, v in res.items()), flush=True)
        profiles = {}
        if args.profile:
            for tag, p in procs.items():
                p.stdin.write("profile\n")
                p.stdin.flush()
                profiles[tag] = json.loads(p.stdout.readline())
                for case, ks in profiles[tag].items():
                    print(f"profile {tag} {case}: " + ", ".join(
                        f"{k} {v:.2f} us" for k, v in ks.items()),
                        flush=True)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.stdin.close()
                p.wait(timeout=120)
    out = {"repos": repos, "readings": readings, "profiles": profiles,
           "bit_equal": bit_equal}
    for tag, rs in readings.items():
        out[tag] = {k: summary([x[k] for x in rs]) for k in rs[0]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
