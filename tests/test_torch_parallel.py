"""Data parallelism (``vanerf_tpu_torch/parallel/``) on the CPU: ranks are
processes that meet over gloo through a ``file://`` rendezvous under the
test's ``tmp_path`` (``tests/torch_parallel_workers.py``), on one thread
each, as the single-process references here run.

Held, with their tolerances:
  * the 2-rank GAN step on a global batch of 2 against one process that
    computes each shard's step and averages the gradients: equal to the
    bit (the gradients, the logs and every parameter after Adam; with two
    ranks the all-reduce's sum is order-free), on every rank;
  * the same step against JAX's ``make_parallel_train_step`` on a
    2-device CPU mesh with JAX's draws (each device's key folded with its
    axis index): the logs rtol 1e-4, each averaged gradient to a relative
    norm error of 1e-2, the texture path 5e-2.  That is the single-device
    step's own agreement on these draws, not the averaging's: one shard's
    step on one device against JAX's leaves ``geo_encoder.conv1.*`` at
    6.2e-3 and 3.6e-3 for the two folded keys (2.8e-3 to 6.8e-3 over
    weight and bias; ``tests/test_torch_train.py``'s key holds 1e-3), and
    a wrong shard, fold or average moves the losses themselves;
  * ``plan_tile_group`` on a mesh: JAX's rule, case by case;
  * the frame split over two ranks (``render_full_image(mesh=)``) against
    the single-device frame: equal to the bit, on both ranks;
  * a checkpoint saved by rank 0, restored in one process (equal to the
    bit), and the 2-rank step resumed from it (rank 1's copy moved off it
    and broadcast back) equal to the bit to the uninterrupted run;
  * ``python -m vanerf_tpu_torch.train --device cpu --num_gpus 2
    --synthetic_data --fast_dev_run`` on a YAML config: two gloo workers
    it starts itself, one step, rank 0's output only;
  * the same command with ``--run_val``: one report, rank 0's, equal to
    the bit to one process's.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_parallel_workers as pw
import torch_port_helpers as h

OUT = 8                       # 8x8 training rays: VGG's three pools need 8


def _train_cfg():
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = OUT
    m["dr_kwargs"]["sample_per_ray_c"] = h.S_C
    m["dr_kwargs"]["sample_per_ray_f"] = h.S_F
    m["dr_kwargs"]["rand_noise_std"] = 0.01
    cfg["training"]["reference_faithful_gan"] = False
    return cfg


def _seeded_job(batch_size=2):
    """A job of seeded weights (the port's flax-like initialisation) and
    the port's fixture batch of ``batch_size`` frames."""
    from vanerf_tpu_torch.data import make_synthetic_batch
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, VANeRF
    from vanerf_tpu_torch.models import init_like_flax
    cfg = _train_cfg()
    batch, _, num_v = make_synthetic_batch(batch_size=batch_size, H=h.H,
                                           W=h.W, subdiv=2, device="cpu")
    model = VANeRF.from_config(cfg, num_v=num_v, image_hw=(h.H, h.W))
    init_like_flax(model, torch.Generator().manual_seed(0))
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(1))
    vgg = VGGLoss()
    init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
    return dict(cfg=cfg, num_v=num_v, image_hw=(h.H, h.W),
                model=model.state_dict(), disc=disc.state_dict(),
                vgg=vgg.vgg_net.state_dict(), batch=batch)


def _shard(batch, r, n=2):
    from vanerf_tpu_torch.parallel import shard_batch
    from vanerf_tpu_torch.data import to_torch
    return shard_batch(SimpleNamespace(rank=r, size=n),
                       to_torch(batch, "cpu"))


def _draws(seed, shard):
    """One rank's draws of a step (G and D), from a seeded generator."""
    from vanerf_tpu_torch import renderer as tr
    g = torch.Generator().manual_seed(seed)
    P = OUT * OUT

    def one():
        return {"grids": tr.mask_centered_grid(
                    g, shard["tar_mask"][..., 0], OUT, OUT).numpy(),
                "u_c": torch.rand(1, P, h.S_C, generator=g).numpy(),
                "noise_c": torch.randn(1, P * h.S_C, 1, generator=g).numpy(),
                "u_f": torch.rand(1, P, h.S_F, generator=g).numpy(),
                "noise_f": torch.randn(1, P * h.S_F, 1, generator=g).numpy()}
    return {"g": one(), "d": one()}


def _run(job, fn, tmp_path, name="job"):
    d = tmp_path / name
    d.mkdir()
    torch.save(job, d / "job.pt")
    pw.run(fn, d)
    tag = "step" if fn is pw.step_worker else "render"
    return [torch.load(d / f"{tag}{r}.pt", weights_only=False)
            for r in range(2)]


def _capture_grads(job, shard, generator=None, draws=None):
    """One shard's GAN step in this process, its gradients and logs kept
    and no update applied (single render: D's gradient does not depend
    on G's update)."""
    from vanerf_tpu_torch.training import make_train_step
    model, disc, vgg, state = pw.build_state(job)
    seen = {}
    state.opt_g.step = lambda g: seen.__setitem__("g", g)
    state.opt_d.step = lambda g: seen.__setitem__("d", g)
    logs = make_train_step(model, disc, job["cfg"], vgg)(
        state, shard, generator, draws)
    return seen, logs


def _zeros_for_none(grads, params):
    return [torch.zeros_like(p) if g is None else g
            for g, p in zip(grads, params)]


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_rank_step_equals_the_shards_average(tmp_path, one_thread):
    """Two ranks, one frame each, their draws from the loop's generator
    (rank r's are ``fold_generator``'s, ``fold_in(rng, r)``, so the two
    shards' patches differ), against one process that runs each shard's
    step and averages: the applied gradients, the logs and every parameter
    after Adam equal to the bit on both ranks.  (Draws given to each rank
    are taken by the checkpoint test below and by the JAX comparison.)"""
    from vanerf_tpu_torch.parallel import fold_generator
    job = _seeded_job()
    shards = [_shard(job["batch"], r) for r in range(2)]
    job["draws"], job["seed"] = [None], 5
    refs = [_capture_grads(job, shards[r], fold_generator(
        torch.Generator().manual_seed(5), r, "cpu")) for r in range(2)]
    outs = _run(job, pw.step_worker, tmp_path)
    assert refs[0][1]["train/g_loss"] != refs[1][1]["train/g_loss"]

    model, disc, _, state = pw.build_state(job)
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        avg = [(a + b) / 2 for a, b in zip(
            *(_zeros_for_none(ref[0][tag], opt.params) for ref in refs))]
        opt.step(avg)
        for o in outs:
            got = o[0]["grads"][tag]
            assert all(torch.equal(x, y) for x, y in zip(got, avg)), tag
    for o in outs:
        for k, v in o[0]["logs"].items():
            want = (refs[0][1][k] + refs[1][1][k]) / 2
            assert torch.equal(v, want), k
        for name, mod in (("model", model), ("disc", disc)):
            for k, v in mod.state_dict().items():
                assert torch.equal(o[0][name][k], v), (name, k)


def test_one_rank_step_equals_the_plain_step(tmp_path, one_thread):
    """At world size 1 (gloo, this process) the parallel step still runs
    its all-reduces and its first-step broadcast: the sum of one divided by
    one leaves every bit, so it equals the plain step on the rank's folded
    generator, logs and parameters."""
    import torch.distributed as dist
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.parallel import (fold_generator, make_mesh,
                                           make_parallel_train_step)
    from vanerf_tpu_torch.training import make_train_step
    job = _seeded_job(1)
    batch = to_torch(job["batch"], "cpu")
    mesh = make_mesh(1, device="cpu", rank=0,
                     init_method="file://" + str(tmp_path / "rendezvous"))
    try:
        assert mesh.backend == "gloo" and mesh.lead
        model, disc, vgg, state = pw.build_state(job)
        logs = make_parallel_train_step(model, disc, job["cfg"], vgg, mesh)(
            state, batch, torch.Generator().manual_seed(7))
    finally:
        dist.destroy_process_group()
    model2, disc2, vgg2, state2 = pw.build_state(job)
    want = make_train_step(model2, disc2, job["cfg"], vgg2)(
        state2, batch, fold_generator(torch.Generator().manual_seed(7), 0,
                                      "cpu"))
    for k, v in want.items():
        assert torch.equal(logs[k], v), k
    for a, b in ((model, model2), (disc, disc2)):
        for (k, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(x, y), k


def test_plan_tile_group_matches_jax_on_meshes():
    """``plan_tile_group`` with a mesh, on the cases of
    ``tests/test_parallel.py:138`` and more: the group rounded to a
    multiple of the world size and the mesh dropped where the frame's
    tiles do not split, as JAX's rule."""
    from vanerf_tpu.parallel import make_mesh
    from vanerf_tpu.renderer import plan_tile_group as pj
    from vanerf_tpu_torch.renderer import plan_tile_group as pt
    for n in (1, 2, 4):
        mt, mj = SimpleNamespace(size=n, rank=0), make_mesh(n)
        for n_tiles in (1, 2, 4, 16):
            for tg in (0, 1, 2, 3, 4, 6, 8, 16, 64):
                g_t, m_t = pt(n_tiles, tg, mt)
                g_j, m_j = pj(n_tiles, tg, mj)
                assert g_t == g_j and (m_t is mt) == (m_j is mj), \
                    (n, n_tiles, tg)
    m4 = SimpleNamespace(size=4, rank=0)
    assert pt(16, 1, m4) == (4, m4) and pt(16, 8, m4) == (8, m4)
    assert pt(16, 6, m4)[0] % 4 == 0 and pt(1, 4, m4) == (1, None)
    assert pt(2, 1, m4) == (2, None)


@pytest.mark.parametrize("G,frames", [(2, 1), (4, 2)])
def test_sharded_full_image_equals_single_device(G, frames, tmp_path,
                                                 one_thread):
    """``render_full_image(mesh=)`` over two ranks at ``tile_group`` G
    (each rank G / 2 offsets of a group, the frame joined by one sum) on
    one frame and on two: every output equal to the bit to the
    single-device render's at the same G, on both ranks (the frames'
    vertex visibility and GT map too, which each rank holds whole)."""
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.models import VANeRF
    job = _seeded_job(frames)
    job["kw"] = dict(level=2, sample_per_ray_c=4, sample_per_ray_f=4,
                     tile_group=G, compute_vis_map=True)
    outs = _run(job, pw.render_worker, tmp_path)
    model = VANeRF.from_config(job["cfg"], num_v=job["num_v"],
                               image_hw=job["image_hw"])
    model.load_state_dict(job["model"])
    want = tr.render_full_image(model.eval(), to_torch(job["batch"], "cpu"),
                                **job["kw"])
    for o in outs:
        assert set(o) == set(want)
        for k, v in want.items():
            assert torch.equal(o[k], v), k
    assert want["alpha_fine"].max() > 0.2
    if frames == 2:
        assert not torch.equal(want["tex_fg_fine"][0],
                               want["tex_fg_fine"][1])


# the JAX 2-device step's cold compile takes minutes on one CPU worker
@pytest.mark.slow
def test_two_rank_step_matches_jax_parallel_step(tmp_path, one_thread,
                                                 monkeypatch):
    """The 2-rank step against JAX's ``make_parallel_train_step`` on a
    2-device CPU mesh, from the same weights and batch (one frame on both
    shards), each rank taking its device's draws (the key folded with the
    axis index, then split for G and D): the averaged logs and the
    averaged G and D gradients within the GAN step's bounds (module
    note)."""
    import jax
    import jax.numpy as jnp
    import optax
    from test_torch_train import (TEX_PATH, _capture, _disc_params,
                                  _jax_draws, _rel, _vgg_pair)
    from vanerf_tpu.models import DiscriminatorVis as JDisc
    from vanerf_tpu.parallel import make_mesh, make_parallel_train_step
    from vanerf_tpu.training.train_step import (TrainState,
                                                make_lr_schedule,
                                                make_train_step as j_make)
    from vanerf_tpu_torch.weights import (disc_from_jax_params,
                                          from_jax_params)
    monkeypatch.setenv("VANERF_COMPUTE_DTYPE", "float32")
    monkeypatch.setenv("VANERF_FAR_TAU", "0")
    cfg = _train_cfg()
    g, _ = h.converted_params()
    d = _disc_params()
    # the fixture's frame twice, its faces in the Morton order the port's
    # query sorts them into (tests/torch_port_helpers.py::morton_sorted:
    # one face table serves both shards, and JAX's CPU query then breaks
    # the ties of shared vertices and edges as the port does); the ranks'
    # draws differ
    one = h.morton_sorted(h.synthetic_batch()[0])
    batch = {k: (v if k in ("faces", "znear", "zfar")
                 else np.concatenate([v, v])) for k, v in one.items()}
    num_v = h.NUM_V
    jb = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
          for k, v in batch.items()}
    vgg_j, vgg_t = _vgg_pair()
    sched = make_lr_schedule(cfg["training"]["lr"], 10)
    tx_g = optax.chain(_capture(), optax.adam(sched))
    tx_d = optax.chain(_capture(), optax.adam(sched))
    state = TrainState(g, d, tx_g.init(g), tx_d.init(d),
                       jnp.zeros((), jnp.int32))
    rng = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("highest"):
        jm = h.jax_model()
        mesh = make_mesh(2)
        with mesh:
            step = make_parallel_train_step(
                j_make(jm, JDisc(), tx_g, tx_d, cfg, vgg_j), mesh, jb)
            new, logs_j = step(state, jb, rng)
            logs_j = {k: float(v) for k, v in logs_j.items()}
    draws = []
    for r in range(2):
        shard = {k: (v[r:r + 1] if k not in ("faces", "znear", "zfar")
                     else v) for k, v in jb.items()}
        rg, rd = jax.random.split(jax.random.fold_in(rng, r))
        draws.append({"g": _jax_draws(rg, shard), "d": _jax_draws(rd, shard)})
    job = dict(cfg=cfg, num_v=num_v, image_hw=(h.H, h.W),
               model=from_jax_params(g), disc=disc_from_jax_params(d),
               vgg=vgg_t.vgg_net.state_dict(), batch=batch, draws=[draws])
    outs = _run(job, pw.step_worker, tmp_path)
    for k, v in logs_j.items():
        np.testing.assert_allclose(float(outs[0][0]["logs"][k]), v,
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    np_tree = lambda t: jax.tree.map(np.asarray, t)        # noqa: E731
    for tag, conv, opt_state in (("g", from_jax_params, new.opt_g),
                                 ("d", disc_from_jax_params, new.opt_d)):
        grads_j = conv(np_tree(opt_state[0]))
        total = np.sqrt(sum(float((v.numpy() ** 2).sum())
                            for v in grads_j.values()))
        mod = pw.build_state(job)[0 if tag == "g" else 1]
        for (n, p), gt in zip(mod.named_parameters(),
                              outs[0][0]["grads"][tag]):
            gj = grads_j[n].numpy().reshape(p.shape)
            gt = gt.numpy()
            if np.linalg.norm(gj) < 1e-6 * total:
                assert np.linalg.norm(gt) < 1e-6 * total, n
                continue
            assert _rel(gt, gj) <= (5e-2 if n.startswith(TEX_PATH)
                                    else 1e-2), (tag, n, _rel(gt, gj))


def test_mesh_checkpoint_save_restore_resume(tmp_path, one_thread):
    """As ``tests/test_checkpoints.py:53``: rank 0 saves the live state
    after a 2-rank step, one process restores it equal to the bit, and
    the 2-rank step resumed from the checkpoint (rank 1's parameters moved
    off it, the first step's broadcast putting rank 0's back) equals the
    uninterrupted second step to the bit."""
    from vanerf_tpu_torch.training.checkpoints import CheckpointManager
    job = _seeded_job()
    shards = [_shard(job["batch"], r) for r in range(2)]
    d1 = [_draws(20 + r, shards[r]) for r in range(2)]
    d2 = [_draws(30 + r, shards[r]) for r in range(2)]
    ck = str(tmp_path / "ck")
    a = _run(dict(job, draws=[d1, d2], save_to=ck), pw.step_worker,
             tmp_path, "a")
    assert CheckpointManager(ck).latest_step() == 1
    model, disc, _, state = pw.build_state(job)
    restored, step = CheckpointManager(ck).restore(state)
    assert step == 1 and restored.step == 1
    for k, v in model.state_dict().items():
        assert torch.equal(v, a[0][0]["model"][k]), k
    b = _run(dict(job, draws=[d2], restore=ck), pw.step_worker, tmp_path,
             "b")
    for r in range(2):
        want, got = a[r][1], b[r][0]
        for k in want["logs"]:
            assert torch.equal(got["logs"][k], want["logs"][k]), k
        for name in ("model", "disc"):
            for k, v in want[name].items():
                assert torch.equal(got[name][k], v), (r, name, k)


def _cli_env():
    env = dict(os.environ, OMP_NUM_THREADS="1", VANERF_FAR_TAU="0")
    env["PYTHONPATH"] = os.pathsep.join(
        [h.ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                    if p])
    return env


def test_cli_num_gpus_two_on_the_cpu(tmp_path):
    """``python -m vanerf_tpu_torch.train --device cpu --num_gpus 2
    --synthetic_data --fast_dev_run`` on a YAML config: the command starts
    its two gloo workers, runs one step of a global batch of 2 and exits
    0; only rank 0 prints and writes the run's config."""
    import yaml
    from test_torch_entry import tiny_cli_cfg
    cfg = tiny_cli_cfg(str(tmp_path / "out"))
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(cfg))
    res = subprocess.run(
        [sys.executable, "-m", "vanerf_tpu_torch.train", "--config",
         str(path), "--synthetic_data", "--fast_dev_run", "--device", "cpu",
         "--num_gpus", "2"], cwd=str(tmp_path), env=_cli_env(),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("Training done at step 1") == 1, res.stdout
    assert os.path.isfile(tmp_path / "out" / cfg.get("expname", "default")
                          / "config.json")


def test_cli_run_val_num_gpus_two_on_the_cpu(tmp_path):
    """``python -m vanerf_tpu_torch.train --device cpu --num_gpus 2
    --synthetic_data --run_val`` (two gloo workers that it starts itself,
    each rendering through ``run_test(mesh=)``) writes one report, rank
    0's, whose scores equal to the bit those of the same command on one
    process, run beside it.  At the fixture's 32^2 a frame is one tile,
    which JAX's rule renders on one device (``plan_tile_group``); the split
    frame is :func:`test_sharded_full_image_equals_single_device`'s."""
    import yaml
    from test_torch_entry import tiny_cli_cfg
    cfg = tiny_cli_cfg(str(tmp_path / "out"))
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(cfg))
    cmd = [sys.executable, "-m", "vanerf_tpu_torch.train", "--config",
           str(path), "--synthetic_data", "--run_val", "--device", "cpu"]
    procs = {tag: subprocess.Popen(
        cmd + more + ["--out_dir", str(tmp_path / tag)], cwd=str(tmp_path),
        env=_cli_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for tag, more in (("two", ["--num_gpus", "2"]),
                                     ("one", []))}
    reps = []
    for tag, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, (tag, err[-4000:])
        assert out.count("Results saved in") == 1, (tag, out)
        save_dir = tmp_path / tag / cfg.get("expname", "default")
        (name,) = [n for n in os.listdir(save_dir) if n.endswith(".yml")]
        reps.append((name, yaml.safe_load((save_dir / name).read_text())))
    (n2, r2), (n1, r1) = reps
    assert n2 == n1 and set(r2) == set(r1)
    for k in ("psnr", "ssim", "mse"):
        assert np.isfinite(r1[k]) and r2[k] == r1[k], (k, r2[k], r1[k])
