"""The port's evaluation and its entry point against the JAX package's:
the CLI parser and config helpers, LPIPS, the Evaluator with its PNG dumps,
``plan_tile_group``, the report writer, and
``python -m vanerf_tpu_torch.train`` itself: ``--run_val`` on a
reference-layout ``model.ckpt`` beside JAX's ``train.main`` on the
converted pickle (one tiny config), and ``--fast_dev_run`` / train /
resume.

Tolerances: LPIPS within 1e-5 of JAX's; the Evaluator's MSE / PSNR to
rtol 1e-6, SSIM to rtol 1e-5 / atol 1e-7 (a box filter by convolution
against JAX's cumulative one) and the PNG dumps equal pixel for pixel; the
two ``run_test`` reports with the same keys, ``psnr`` / ``ssim`` / ``mse``
within rtol 1e-4, far tier off on both sides.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as h

EXACT_ENV = {"VANERF_COMPUTE_DTYPE": "float32", "VANERF_PRECISION": "highest",
             "VANERF_FAR_TAU": "0"}


# ---------------------------------------------------------------------------
# config and CLI flags
# ---------------------------------------------------------------------------

def test_parser_flags_equal_jax():
    from vanerf_tpu import config as cj
    from vanerf_tpu_torch import config as ct
    argv = ["--config", "c.json", "--data_root", "d", "--out_dir", "o",
            "--in_the_wild", "--fast_dev_run", "--model_ckpt", "m",
            "--num_gpus", "1", "--synthetic_data", "--profile_dir", "p"]
    a, b = ct.create_parser().parse_args(argv), cj.create_parser().parse_args(
        argv)
    ct.resolve_flags(a)
    cj.resolve_flags(b)
    assert a.run_val and b.run_val          # --in_the_wild means --run_val
    got = vars(a)
    assert got.pop("device") == "cuda"      # the card unless asked
    assert got == vars(b)
    assert ct.create_parser().parse_args(["--device", "cpu"]).device == "cpu"


def test_config_helpers(tmp_path):
    from vanerf_tpu_torch import config as ct
    cfg = ct.default_cfg()
    assert ct.model_cfg(cfg) is cfg["models"]["VANeRF"]
    assert ct.disc_cfg(cfg) is cfg["models"]["Discriminator"]
    ct.save_config(str(tmp_path / "run"), cfg)
    with open(tmp_path / "run" / "config.json") as f:
        saved = json.load(f)
    assert "git_head" in saved and saved["models"] == cfg["models"]
    (tmp_path / "c.yml").write_text("a: 1\n")
    with pytest.raises(ValueError):       # YAML configs are refused
        ct.load_cfg(str(tmp_path / "c.yml"))


def test_plan_tile_group_equals_jax_on_one_device():
    from vanerf_tpu.renderer import plan_tile_group as pj
    from vanerf_tpu_torch.renderer import plan_tile_group as pt
    for n_tiles in (1, 4, 16):
        for tg in (0, 1, 2, 4, 16, 64):
            assert pt(n_tiles, tg) == pj(n_tiles, tg)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        pt(16, 4, mesh=object())


def test_flat_yaml_reads_back_with_yaml():
    import yaml
    from vanerf_tpu_torch.eval_loop import dump_flat_yaml
    m = {"psnr": 8.994054525289409, "ssim": 0.0023109171888791025,
         "mse": 1e-05, "big": 1e17, "lpips": float("nan"),
         "inf": float("inf"), "neg": -2.5, "lpips_pretrained": False,
         "vgg_random_init": True, "far_tau": 0.0, "far_net_requested": 0.5}
    text = dump_flat_yaml(m)
    assert text == yaml.dump(m)
    back = yaml.safe_load(text)
    assert set(back) == set(m)
    for k, v in m.items():
        assert (back[k] == v) or (np.isnan(v) and np.isnan(back[k])), k


# ---------------------------------------------------------------------------
# LPIPS and the Evaluator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lpips_npz(tmp_path_factory):
    from convert_lpips import convs_lins_from_state_dict, pack_lpips
    from make_synthetic_assets import synthetic_lpips_sd
    sd = {k: v.numpy() for k, v in synthetic_lpips_sd().items()}
    path = str(tmp_path_factory.mktemp("lpips") / "lpips.npz")
    np.savez(path, **pack_lpips(*convs_lins_from_state_dict(sd)))
    return path


def test_lpips_equals_jax(lpips_npz):
    from vanerf_tpu.lpips import LPIPS as LJ
    from vanerf_tpu_torch.lpips import LPIPS as LT
    rs = np.random.RandomState(0)
    lt, lj = LT(lpips_npz), LJ(lpips_npz)
    for hw in ((64, 64), (48, 72)):
        a = rs.rand(*hw, 3).astype(np.float32)
        b = np.clip(a + 0.2 * rs.randn(*hw, 3), 0, 1).astype(np.float32)
        got, want = lt(a, b), lj(a, b)
        assert want > 0 and abs(got - want) <= 1e-5, (got, want)
        assert lt(a, a) == 0.0


def test_evaluator_equals_jax(lpips_npz, tmp_path, monkeypatch):
    from PIL import Image
    from vanerf_tpu.evaluator import Evaluator as EJ
    from vanerf_tpu_torch.evaluator import Evaluator as ET
    from vanerf_tpu_torch.evaluator import read_png
    monkeypatch.setenv("VANERF_LPIPS_NPZ", lpips_npz)
    rs = np.random.RandomState(1)
    H = W = 64
    gt = rs.rand(H, W, 3).astype(np.float32)
    pred = np.clip(gt + 0.1 * rs.randn(H, W, 3), -0.1, 1.1).astype(
        np.float32)
    inputs = rs.rand(1, H, W, 3).astype(np.float32)
    mask = np.zeros((H, W), bool)
    mask[10:50, 12:58] = True
    et = ET(str(tmp_path / "port"), device="cpu")
    ej = EJ(str(tmp_path / "jax"))
    assert et.lpips_fn is not None and ej.lpips_fn is not None
    kw = dict(input_imgs=inputs, mask_at_box=mask, human_idx="3",
              frame_index="7", view_index="2")
    got, want = et.compute_score(pred, gt, **kw), ej.compute_score(pred, gt,
                                                                    **kw)
    assert set(got) == set(want)
    for k in ("mse", "psnr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-5,
                               atol=1e-7)
    assert abs(got["lpips"] - want["lpips"]) <= 1e-5
    # a crop under 7 px has no SSIM, under 32 px no LPIPS: NaN on both
    small = np.zeros((H, W), bool)
    small[5:9, 5:40] = True
    g2 = et.compute_score(pred, gt, mask_at_box=small)
    w2 = ej.compute_score(pred, gt, mask_at_box=small)
    assert np.isnan(g2["ssim"]) and np.isnan(w2["ssim"])
    assert np.isnan(g2["lpips"]) and np.isnan(w2["lpips"])
    # the dumps: the same files, the same pixels; read_png also decodes
    # the PNGs of another writer (every row filter it chose)
    names = sorted(os.path.relpath(os.path.join(r, f), tmp_path / "jax")
                   for r, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(names) == 5 and names == sorted(
        os.path.relpath(os.path.join(r, f), tmp_path / "port")
        for r, _, fs in os.walk(tmp_path / "port") for f in fs)
    for n in names:
        want_px = np.asarray(Image.open(tmp_path / "jax" / n))
        np.testing.assert_array_equal(read_png(str(tmp_path / "port" / n)),
                                      want_px)
        np.testing.assert_array_equal(np.asarray(Image.open(
            tmp_path / "port" / n)), want_px)
        np.testing.assert_array_equal(read_png(str(tmp_path / "jax" / n)),
                                      want_px)


def test_read_png_every_filter(tmp_path):
    """The decoder against PIL on 8-bit RGB images PIL writes with each row
    filter; another colour type (grey, RGBA) is refused, not misread."""
    from PIL import Image
    from vanerf_tpu_torch.evaluator import read_png, write_png
    rs = np.random.RandomState(2)
    img = rs.randint(0, 256, (9, 13, 3), dtype=np.uint8)
    img[3:] = np.minimum(img[3:], 200)   # runs that filters can use
    for filt in range(5):
        p = str(tmp_path / f"RGB{filt}.png")
        Image.fromarray(img, "RGB").save(p, optimize=False, filter_type=filt)
        np.testing.assert_array_equal(read_png(p), img)
    for mode, shape in (("L", (9, 13)), ("RGBA", (5, 7, 4))):
        p = str(tmp_path / f"{mode}.png")
        Image.fromarray(rs.randint(0, 256, shape, dtype=np.uint8),
                        mode).save(p)
        with pytest.raises(ValueError, match="RGB"):
            read_png(p)
    rgb = rs.randint(0, 256, (6, 4, 3), dtype=np.uint8)
    write_png(str(tmp_path / "w.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")),
                                  rgb)


# ---------------------------------------------------------------------------
# the entry point
# ---------------------------------------------------------------------------

def tiny_cli_cfg(out_dir: str) -> dict:
    """configs/vanerf.json at the tests' small shapes: 32^2 subdiv-1
    fixture, two cameras, 8x8 training patches with 8 + 8 samples."""
    from vanerf_tpu_torch.config import default_cfg
    cfg = default_cfg()
    m = cfg["models"]["VANeRF"]
    m["geo_args"]["n_downsample"] = 2
    m["train_out_h"] = m["train_out_w"] = 8
    m["dr_kwargs"]["sample_per_ray_c"] = m["dr_kwargs"]["sample_per_ray_f"] \
        = 8
    cfg["dataset"]["synthetic_cfg"] = {"H": h.H, "W": h.W, "subdiv": 1,
                                       "n_frames": 1, "n_cams": 2}
    cfg["training"]["max_epochs"] = 1
    cfg["training"]["pl_cfg"] = {"val_check_interval": 10.0}
    cfg["out_dir"] = out_dir
    return cfg


NUM_V_SUBDIV1 = 42


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """The tiny config, a replica ``model.ckpt`` at its shapes and its
    ``tools/convert_reference_ckpt.py`` pickle."""
    import pickle
    from convert_reference_ckpt import convert_state_dict
    from make_synthetic_assets import synthetic_reference_ckpt
    d = tmp_path_factory.mktemp("cli")
    cfg = tiny_cli_cfg(str(d / "out"))
    with open(d / "tiny.json", "w") as f:
        json.dump(cfg, f)
    ck = synthetic_reference_ckpt(seed=2, cfg=cfg, num_v=NUM_V_SUBDIV1,
                                  hw3=8, hw4=h.W)
    torch.save(ck, str(d / "model.ckpt"))
    sd = {k: v.numpy() for k, v in ck["state_dict"].items()}
    g, dd = convert_state_dict(sd, geo_cfg=cfg["models"]["VANeRF"]
                               ["geo_args"])
    with open(d / "ckpt.pkl", "wb") as f:
        pickle.dump({"params_g": g, "params_d": dd, "epoch": ck["epoch"],
                     "global_step": ck["global_step"]}, f)
    return d


# JAX's run_test sees each test frame's faces in that frame's Morton order:
# the port's mesh query sorts its faces so (as the JAX package does on a
# TPU), the JAX CPU path keeps the order it is given, and where a sample's
# closest point is a shared vertex or edge the first face in table order
# wins (tests/torch_port_helpers.py::morton_sorted).  Unsorted, such ties
# move ~140 of a 32^2 frame's pixels by up to 0.03; sorted, none by more
# than 5e-4.  run_test collates one item a frame, so each frame gets its
# own order; the port, which sorts for itself, renders the same either way.
def morton_collate(collate_numpy):
    def collate(items, faces=None):
        return h.morton_sorted({k: np.asarray(v) for k, v in
                                collate_numpy(items, faces=faces).items()})
    return collate


def port_cli(args, extra_env=None):
    env = dict(os.environ, PYTHONPATH=h.ROOT, OMP_NUM_THREADS="2",
               **(extra_env or {}))
    proc = subprocess.run([sys.executable, "-m", "vanerf_tpu_torch.train"]
                          + args, cwd=h.ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def read_yaml(path):
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def reports(save_dir):
    return sorted(n for n in os.listdir(save_dir) if n.endswith(".yml"))


@pytest.fixture(scope="module")
def jax_report(cli):
    """JAX's ``train.main([... --run_val --model_ckpt <pickle>])``."""
    if h.ROOT not in sys.path:
        sys.path.insert(0, h.ROOT)
    import train as jax_train
    from vanerf_tpu import eval_loop as jax_eval
    out = str(cli / "jax")
    old = {k: os.environ.get(k) for k in EXACT_ENV}
    os.environ.update(EXACT_ENV)
    real_collate = jax_eval.collate_numpy
    jax_eval.collate_numpy = morton_collate(real_collate)
    try:
        jax_train.main(["--config", str(cli / "tiny.json"),
                        "--synthetic_data", "--run_val", "--model_ckpt",
                        str(cli / "ckpt.pkl"), "--out_dir", out])
    finally:
        jax_eval.collate_numpy = real_collate
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    save_dir = os.path.join(out, "vanerf")
    (name,) = reports(save_dir)
    return name, read_yaml(os.path.join(save_dir, name))


def test_jax_cli_report(jax_report):
    """The reference report the next test holds the port to (its own
    test so that each stays inside a minute: the JAX compile is here)."""
    name, rep = jax_report
    assert name == "test_test_81345_162690.yml"
    assert np.isfinite(rep["psnr"]) and rep["far_tau"] == 0.0


def test_cli_run_test_equals_jax(cli, jax_report):
    """``python -m vanerf_tpu_torch.train --device cpu --synthetic_data
    --run_val --model_ckpt <replica model.ckpt>``: the same report name
    and keys as JAX's run on the converted pickle, psnr / ssim / mse within
    rtol 1e-4, and PNG dumps of every test frame (JAX's on Morton-ordered
    faces: ``morton_collate``)."""
    out = str(cli / "port")
    proc = port_cli(["--config", str(cli / "tiny.json"), "--synthetic_data",
                     "--run_val", "--model_ckpt", str(cli / "model.ckpt"),
                     "--out_dir", out, "--device", "cpu"], EXACT_ENV)
    assert "Resumed from step 162690" in proc.stdout
    save_dir = os.path.join(out, "vanerf")
    name, want = jax_report
    assert reports(save_dir) == [name]
    got = read_yaml(os.path.join(save_dir, name))
    assert set(got) == set(want)
    for k in ("psnr", "ssim", "mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)
    for k in ("lpips_pretrained", "vgg_random_init", "far_tau"):
        assert got[k] == want[k], k
    assert np.isnan(got["lpips"]) and np.isnan(want["lpips"])
    pngs = [f for _, _, fs in os.walk(os.path.join(save_dir, "images_test"))
            for f in fs]
    assert len(pngs) == 3 * 4          # pred, gt, input x 2 frames x 2 cams


def test_cli_fast_dev_run_train_resume(cli, tmp_path, capsys):
    """``--fast_dev_run`` takes one step and writes config.json and
    metrics.jsonl (no checkpoint, as in JAX), and under ``--profile_dir`` a
    Chrome trace of ``fit``; a run of the epoch saves; a
    second run prints the resume and takes no step (``main`` in process:
    the command line's own code, without three interpreter starts)."""
    from vanerf_tpu_torch import train
    args = ["--config", str(cli / "tiny.json"), "--synthetic_data",
            "--out_dir", str(tmp_path), "--device", "cpu"]
    save_dir = tmp_path / "vanerf"
    state = train.main(args + ["--fast_dev_run", "--profile_dir",
                               str(tmp_path / "prof")])
    out = capsys.readouterr().out
    assert state.step == 1 and "Training done at step 1" in out
    assert "Resumed" not in out
    with open(tmp_path / "prof" / "fit.trace.json") as f:
        assert json.load(f)["traceEvents"]       # fit under torch.profiler
    assert (save_dir / "config.json").exists()
    assert (save_dir / "metrics.jsonl").exists()
    assert not os.listdir(save_dir / "ckpts")
    train.main(args)
    assert "Training done at step 2" in capsys.readouterr().out
    with open(save_dir / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs] == [2]
    assert recs[0]["epoch"] == 0.0 and "epoch_time_s" in recs[0]
    assert os.listdir(save_dir / "ckpts") == ["2"]
    state = train.main(args)
    out = capsys.readouterr().out
    assert "Resumed from step 2" in out and "Training done at step 2" in out
    assert state.step == 2


def test_cli_refusals(cli, tmp_path):
    """--num_gpus != 1, a YAML config, and the card where there is none
    (here) each stop the run; nothing falls back to the CPU."""
    from vanerf_tpu_torch import train
    base = ["--config", str(cli / "tiny.json"), "--synthetic_data",
            "--out_dir", str(tmp_path), "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        train.main(base + ["--num_gpus", "2"])
    (tmp_path / "c.yaml").write_text("a: 1\n")
    with pytest.raises(ValueError, match="JSON"):
        train.main(["--config", str(tmp_path / "c.yaml"), "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            train.main(base[:-2])
