"""The port's training loop and checkpoints against the JAX package's.

* ``fit`` with a stub ``train_step`` on both sides: the batches in order,
  the steps at which ``val_fn`` runs, the checkpoint steps and the
  ``metrics.jsonl`` steps and keys equal JAX's, on a fresh start, a resume
  mid-run, ``fast_dev_run``, thinned saves and a dataset smaller than the
  batch (exact: these are integers and index lists);
* a real two-step port ``fit`` that saves, then a restore: parameters,
  Adam moments, the schedules and the step bit-equal, and the next step
  from each bit-equal given the same generator (CPU, exact);
* ``restore_any`` on a reference-layout ``model.ckpt``: the weights
  bit-equal to ``convert_reference_ckpt`` + ``from_jax_params``, only the
  three named key families left over, any other key refused.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch
import torch.nn as nn

import torch_port_helpers as h


class Items:
    """Index-deterministic items; those in ``broken`` are None (the
    loaders' None-dropping path)."""

    def __init__(self, n, broken=()):
        self.n, self.broken = n, set(broken)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i in self.broken:
            return None
        return {"x": np.full((3,), i, np.float32)}


def collate(items):
    return {"x": np.stack([it["x"] for it in items])}


def ckpt_steps(save_dir):
    d = os.path.join(save_dir, "ckpts")
    return sorted(int(n) for n in os.listdir(d) if n.isdigit())


def jsonl(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["step"], sorted(r)) for r in recs]


def run_jax(tmp, cfg, ds, start, **kw):
    import jax
    import jax.numpy as jnp
    from vanerf_tpu.training.loop import fit
    from vanerf_tpu.training.train_step import TrainState
    seen, vals = [], []

    def step(state, batch, rng):
        seen.append(np.asarray(batch["x"])[:, 0].astype(int).tolist())
        return (state._replace(step=state.step + 1),
                {"loss": jnp.float32(len(seen))})

    def val_fn(state, step_i, logger):
        vals.append(int(step_i))
        return {"val_total_loss": 0.5}

    state = TrainState(params_g={"w": jnp.zeros(1)},
                       params_d={"w": jnp.zeros(1)}, opt_g=None, opt_d=None,
                       step=jnp.int32(start))
    save_dir = str(tmp / "jax")
    out = fit(step, state, ds, collate, cfg=cfg, save_dir=save_dir,
              rng=jax.random.PRNGKey(0), val_fn=val_fn, **kw)
    return dict(step=int(out.step), batches=seen, vals=vals,
                ckpts=ckpt_steps(save_dir), log=jsonl(save_dir))


def tiny_state(start):
    from vanerf_tpu_torch.training import create_train_state
    torch.manual_seed(0)
    state = create_train_state(nn.Linear(2, 2), nn.Linear(2, 1),
                               {"training": {"lr": 1e-3}},
                               steps_per_epoch=4)
    state.step = start
    return state


def run_port(tmp, cfg, ds, start, **kw):
    from vanerf_tpu_torch.training.loop import fit
    seen, vals = [], []

    def step(state, batch, generator):
        seen.append(np.asarray(batch["x"])[:, 0].astype(int).tolist())
        state.step += 1
        return {"loss": torch.tensor(float(len(seen)))}

    def val_fn(state, step_i, logger):
        vals.append(int(step_i))
        return {"val_total_loss": 0.5}

    save_dir = str(tmp / "port")
    out = fit(step, tiny_state(start), ds, collate, cfg=cfg,
              save_dir=save_dir, generator=torch.Generator().manual_seed(0),
              val_fn=val_fn, **kw)
    return dict(step=int(out.step), batches=seen, vals=vals,
                ckpts=ckpt_steps(save_dir), log=jsonl(save_dir))


CASES = {
    # n, broken items, train cfg, start step, fit keywords
    "fresh": (13, (5,), {"max_epochs": 3, "train_batch_size": 2,
                         "pl_cfg": {"val_check_interval": 0.5}}, 0,
              dict(log_every=2)),
    "resume_mid_epoch": (13, (5,), {"max_epochs": 3, "train_batch_size": 2,
                                    "pl_cfg": {"val_check_interval": 0.5}},
                         9, dict(log_every=2)),
    "thinned_saves": (8, (), {"max_epochs": 5, "train_batch_size": 1,
                              "ckpt_every_epochs": 2,
                              "pl_cfg": {"val_check_interval": 0.3}}, 0,
                      dict(log_every=3)),
    "top_level_pl_cfg_ignored": (6, (), {"max_epochs": 1,
                                         "train_batch_size": 1}, 0,
                                 dict(log_every=1)),
    "smaller_than_batch": (2, (), {"max_epochs": 2, "train_batch_size": 4,
                                   "pl_cfg": {"val_check_interval": 10.0}},
                           0, {}),
    "fast_dev_run": (13, (), {"max_epochs": 3, "train_batch_size": 2}, 0,
                     dict(fast_dev_run=True)),
    "batch_size_override": (10, (0, 1), {"max_epochs": 2,
                                         "train_batch_size": 1}, 3,
                            dict(batch_size=3, log_every=1)),
    "worker_processes": (13, (5,), {"max_epochs": 2, "train_batch_size": 2,
                                    "train_num_workers": 2,
                                    "pl_cfg": {"val_check_interval": 0.5}},
                         0, dict(log_every=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fit_schedule_equals_jax(tmp_path, case):
    n, broken, tcfg, start, kw = CASES[case]
    cfg = {"training": dict(tcfg)}
    if case == "top_level_pl_cfg_ignored":
        cfg["pl_cfg"] = {"val_check_interval": 100.0}
    ds = Items(n, broken)
    got = run_port(tmp_path, cfg, ds, start, **kw)
    want = run_jax(tmp_path, cfg, ds, start, **kw)
    assert got == want
    assert got["batches"], "no step ran"
    if case == "smaller_than_batch":        # cyclic padding
        assert all(len(b) == 4 for b in got["batches"])


# ---------------------------------------------------------------------------
# a real fit, saved and restored
# ---------------------------------------------------------------------------

def small_train_cfg():
    cfg = h.small_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = 8
    m["dr_kwargs"]["sample_per_ray_c"] = h.S_C
    m["dr_kwargs"]["sample_per_ray_f"] = h.S_F
    cfg["training"].update(max_epochs=1, train_batch_size=1,
                           accumulate_grad_batches=2)
    return cfg


def fresh_state(cfg, seed):
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import (DiscriminatorVis, VANeRF,
                                         init_like_flax)
    from vanerf_tpu_torch.training import create_train_state
    model = VANeRF.from_config(cfg, num_v=h.NUM_V, image_hw=(h.H, h.W))
    init_like_flax(model, torch.Generator().manual_seed(seed))
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(seed + 1))
    vgg = VGGLoss()
    init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
    return create_train_state(model, disc, cfg, steps_per_epoch=1), vgg


def state_tensors(state):
    """Every tensor that decides the next step, by name."""
    out = {f"G.{k}": v for k, v in state.model.state_dict().items()}
    out.update({f"D.{k}": v for k, v in state.disc.state_dict().items()})
    for name in ("opt_g", "opt_d"):
        opt = getattr(state, name)
        for i, p in enumerate(opt.params):
            for k, v in opt.opt.state.get(p, {}).items():
                out[f"{name}.{i}.{k}"] = v
        for i, a in enumerate(opt.acc or []):
            out[f"{name}.acc.{i}"] = a
    return out


def opt_scalars(state):
    return [(o.mini_step, o.sched.last_epoch, o.sched.get_last_lr(),
             o.opt.param_groups[0]["lr"]) for o in (state.opt_g, state.opt_d)]


def assert_states_equal(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert set(ta) == set(tb)
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert opt_scalars(a) == opt_scalars(b)
    assert int(a.step) == int(b.step)


def test_fit_save_restore_resume_bit_exact(tmp_path):
    """Three steps of fit over a 3-item epoch with gradients accumulated
    over 2 (so one update done and one half-way: the buffers and the
    schedule position matter), a save, a restore into a fresh state from
    other weights, then the next step from each with the same generator."""
    from vanerf_tpu_torch.data import SyntheticDataset, to_torch
    from vanerf_tpu_torch.training import make_train_step
    from vanerf_tpu_torch.training.checkpoints import (CheckpointManager,
                                                       auto_resume)
    from vanerf_tpu_torch.training.loop import collate_numpy, fit
    cfg = small_train_cfg()
    ds = SyntheticDataset(n_frames=1, n_cams=3, H=h.H, W=h.W, subdiv=2,
                          device="cpu")
    state, vgg = fresh_state(cfg, 0)
    step_fn = make_train_step(state.model, state.disc, cfg, vgg)

    def coll(items):
        return to_torch(collate_numpy(items, faces=ds.faces), "cpu")

    save_dir = str(tmp_path / "run")
    state = fit(step_fn, state, ds, coll, cfg=cfg, save_dir=save_dir,
                generator=torch.Generator().manual_seed(1), log_every=1)
    assert state.step == 3 and state.opt_g.mini_step == 1
    assert CheckpointManager(os.path.join(save_dir, "ckpts")).latest_step() \
        == 3
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        assert [json.loads(x)["step"] for x in f] == [1, 2, 3, 3]

    other, vgg2 = fresh_state(cfg, 5)
    assert any(not torch.equal(x, y) for x, y in
               zip(other.model.parameters(), state.model.parameters()))
    restored, step = auto_resume(os.path.join(save_dir, "ckpts"), other)
    assert step == 3 and restored is other
    assert_states_equal(restored, state)

    # one CPU thread: the CPU convolutions' weight gradients sum in a
    # thread-dependent order (two steps from one state then differ in the
    # last bit on 2 threads); the card's step repeats under cuDNN's
    # deterministic algorithms
    batch = coll([ds[1]])
    logs = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for st, v in ((state, vgg), (restored, vgg2)):
            fn = make_train_step(st.model, st.disc, cfg, v)
            logs.append(fn(st, batch, torch.Generator().manual_seed(7)))
    finally:
        torch.set_num_threads(threads)
    assert_states_equal(restored, state)
    for k in logs[0]:
        assert torch.equal(logs[0][k], logs[1][k]), k


def test_checkpoint_manager_keeps_and_replaces(tmp_path):
    from vanerf_tpu_torch.training.checkpoints import CheckpointManager
    mngr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mngr.restore(tiny_state(0)) == (None, None)
    for s in (3, 9, 12):
        mngr.save(s, tiny_state(s), wait=(s != 9))
    mngr.wait()
    assert mngr.all_steps() == [9, 12]
    restored, step = mngr.restore(tiny_state(0))
    assert step == 12 and restored.step == 12
    restored, step = mngr.restore(tiny_state(0), step=9)
    assert step == 9 and restored.step == 9
    # a save of the same step replaces it; nothing half-written is left
    st = tiny_state(12)
    with torch.no_grad():
        next(st.model.parameters()).add_(1.0)
    mngr.save(12, st)
    assert sorted(os.listdir(mngr.ckpt_dir)) == ["12", "9"]
    again, _ = mngr.restore(tiny_state(0))
    assert torch.equal(next(again.model.parameters()),
                       next(st.model.parameters()))


# ---------------------------------------------------------------------------
# reference-layout checkpoints
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """A replica ``model.ckpt`` at the small shapes and its
    ``tools/convert_reference_ckpt.py`` pickle."""
    from convert_reference_ckpt import convert_state_dict
    from make_synthetic_assets import synthetic_reference_ckpt
    d = tmp_path_factory.mktemp("refckpt")
    cfg = h.small_cfg()
    ck = synthetic_reference_ckpt(seed=3, cfg=cfg, num_v=h.NUM_V, hw3=8,
                                  hw4=h.W)
    torch.save(ck, str(d / "model.ckpt"))
    sd = {k: v.numpy() for k, v in ck["state_dict"].items()}
    g, dd = convert_state_dict(sd, geo_cfg=cfg["models"]["VANeRF"]
                               ["geo_args"])
    with open(d / "ckpt.pkl", "wb") as f:
        pickle.dump({"params_g": g, "params_d": dd, "epoch": ck["epoch"],
                     "global_step": ck["global_step"]}, f)
    return d, ck


def test_restore_any_reference_ckpt_equals_converted(reference_ckpt):
    from vanerf_tpu_torch.training.checkpoints import (
        restore_any, split_reference_state_dict)
    d, ck = reference_ckpt
    cfg = small_train_cfg()
    a, _ = fresh_state(cfg, 0)
    b, _ = fresh_state(cfg, 1)
    ra, sa = restore_any(str(d / "model.ckpt"), a)
    rb, sb = restore_any(str(d / "ckpt.pkl"), b)
    assert sa == sb == ck["global_step"] == ra.step == rb.step
    for net in ("model", "disc"):
        x, y = (getattr(ra, net).state_dict(),
                getattr(rb, net).state_dict())
        assert set(x) == set(y)
        for k in x:
            assert torch.equal(x[k], y[k]), (net, k)
    # the keys of the reference that the port holds no tensor for: the
    # three named families and nothing else
    gen, disc, left = split_reference_state_dict(
        ck["state_dict"], a.model.state_dict().keys())
    assert len(gen) == 229 and len(disc) == 20 and len(left) == 39
    fam = {"vgg": [k for k in left if k.startswith("vgg_loss.vgg_net.")],
           "center": [k for k in left if k.endswith(".center")],
           "bn4": [k for k in left if ".bn4." in k]}
    assert {k: len(v) for k, v in fam.items()} == {"vgg": 18, "center": 3,
                                                   "bn4": 18}
    for k in fam["bn4"]:
        assert f"model.{k.rsplit('.bn4.', 1)[0]}.downsample.2.weight" \
            not in ck["state_dict"]


@pytest.mark.parametrize("edit", ["unexpected", "missing", "other_prefix",
                                  "vgg_outside_vgg_net", "no_state_dict"])
def test_reference_ckpt_refuses_other_keys(reference_ckpt, tmp_path, edit):
    from vanerf_tpu_torch.training.checkpoints import restore_any
    _d, ck = reference_ckpt
    sd = dict(ck["state_dict"])
    if edit == "unexpected":
        sd["model.mlp_tex.extra.weight"] = torch.zeros(1)
    elif edit == "missing":
        sd.pop("model.mlp_tex.out_layer.0.weight")
    elif edit == "other_prefix":
        sd["optimizer.state"] = torch.zeros(1)
    else:
        sd["model.vgg_loss.head.weight"] = torch.zeros(1)
    path = str(tmp_path / "bad.ckpt")
    torch.save({"weights" if edit == "no_state_dict" else "state_dict": sd,
                "global_step": 1}, path)
    state, _ = fresh_state(small_train_cfg(), 0)
    with pytest.raises(ValueError):
        restore_any(path, state)
