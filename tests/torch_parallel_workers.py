"""The ranks of ``tests/test_torch_parallel.py``: functions that
``torch.multiprocessing`` spawns, one process a rank, meeting through a
``file://`` rendezvous under the test's ``tmp_path`` (so that xdist workers
never share a port).  Each reads its job from ``<job>/job.pt`` and writes
what it computed to ``<job>/<name><rank>.pt``.  They import the port and
torch only, and run on one CPU thread, as the single-process references
do (the CPU convolutions' gradient sums depend on the thread count).
"""

from __future__ import annotations

import os

import torch


def _setup(rank, size, init):
    torch.set_num_threads(1)
    from vanerf_tpu_torch.parallel import make_mesh
    return make_mesh(size, device="cpu", rank=rank, init_method=init)


def build_state(job):
    """(model, disc, vgg, state) of the job's config and state dicts."""
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, VANeRF
    from vanerf_tpu_torch.training import create_train_state
    cfg = job["cfg"]
    model = VANeRF.from_config(cfg, num_v=job["num_v"],
                               image_hw=job["image_hw"])
    model.load_state_dict(job["model"], strict=True)
    disc = DiscriminatorVis()
    disc.load_state_dict(job["disc"], strict=True)
    vgg = VGGLoss()
    vgg.vgg_net.load_state_dict(job["vgg"], strict=True)
    state = create_train_state(model, disc, cfg, steps_per_epoch=10)
    return model, disc, vgg, state


def _recording(state):
    """Keep the gradients each optimizer applies (after the all-reduce)."""
    seen = {}
    for tag, opt in (("g", state.opt_g), ("d", state.opt_d)):
        def hooked(grads, orig=opt.step, tag=tag):
            seen[tag] = [None if g is None else g.detach().clone()
                         for g in grads]
            orig(grads)
        opt.step = hooked
    return seen


def _snapshot(state, logs, seen):
    return {"logs": {k: v.clone() for k, v in logs.items()},
            "model": {k: v.clone() for k, v in state.model.state_dict()
                      .items()},
            "disc": {k: v.clone() for k, v in state.disc.state_dict()
                     .items()},
            "grads": seen.copy()}


def step_worker(rank, size, init, job_dir):
    """The job's parallel GAN steps on this rank's shard of its global
    batch: each step with this rank's ``draws`` where the job gives them,
    else from the loop's generator (``seed``), folded with the rank.  The
    state, logs and averaged gradients after each step go to
    ``step<rank>.pt``.  With ``save_to`` rank 0 also writes a checkpoint
    after the first step; with ``restore`` every rank starts from that
    checkpoint, rank 1's parameters moved off it (the first step's
    broadcast puts rank 0's back)."""
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.parallel import make_parallel_train_step, shard_batch
    from vanerf_tpu_torch.training.checkpoints import CheckpointManager
    mesh = _setup(rank, size, init)
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    model, disc, vgg, state = build_state(job)
    if job.get("restore"):
        CheckpointManager(job["restore"]).restore(state)
        if rank == 1:
            with torch.no_grad():
                for p in model.parameters():
                    p.add_(0.5)
    seen = _recording(state)
    step = make_parallel_train_step(model, disc, job["cfg"], vgg, mesh)
    batch = shard_batch(mesh, to_torch(job["batch"], "cpu"))
    gen = torch.Generator().manual_seed(job.get("seed", 0))
    outs = []
    for i, draws in enumerate(job["draws"]):
        logs = step(state, batch, gen,
                    draws=None if draws is None else draws[rank])
        outs.append(_snapshot(state, logs, seen))
        if i == 0 and job.get("save_to") and mesh.lead:
            CheckpointManager(job["save_to"]).save(int(state.step), state)
    torch.save(outs, os.path.join(job_dir, f"step{rank}.pt"))
    torch.distributed.destroy_process_group()


def render_worker(rank, size, init, job_dir):
    """``render_full_image(mesh=)`` of the job's frames at its tile group;
    each rank's whole frame to ``render<rank>.pt``."""
    from vanerf_tpu_torch import renderer as tr
    from vanerf_tpu_torch.data import to_torch
    from vanerf_tpu_torch.models import VANeRF
    mesh = _setup(rank, size, init)
    job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
    model = VANeRF.from_config(job["cfg"], num_v=job["num_v"],
                               image_hw=job["image_hw"])
    model.load_state_dict(job["model"], strict=True)
    model.eval()
    out = tr.render_full_image(model.eval(), to_torch(job["batch"], "cpu"),
                               mesh=mesh, **job["kw"])
    torch.save(out, os.path.join(job_dir, f"render{rank}.pt"))
    torch.distributed.destroy_process_group()


def run(fn, job_dir, size: int = 2):
    """Spawn ``size`` ranks of ``fn`` on ``job_dir``'s job."""
    import torch.multiprocessing as mp
    init = "file://" + os.path.join(str(job_dir),
                                    "rendezvous-" + os.urandom(6).hex())
    mp.start_processes(fn, args=(size, init, str(job_dir)), nprocs=size,
                       join=True, start_method="spawn")
