"""The port's free-viewpoint video entry point against the JAX package's:
``python -m vanerf_tpu_torch.render_dynamic --device cpu --synthetic_data
--model_ckpt <replica model.ckpt>`` beside ``render_dynamic.main`` on the
converted pickle, at the tiny config of ``tests/test_video.py`` (32^2
subdiv-1 fixture, two orbit frames), both under the exact settings (f32,
highest precision, far tier off) and JAX's frames on Morton-ordered faces
(``torch_port_helpers.morton_collate``).

The visibility's ties.  A sample whose closest point lies on an edge
shared by two faces is equally close to both (equal to the last bit in
float64, or within the float32 queries' rounding), and the binarised
visibility interpolated on the two faces'
planes can fall on either side of its 0.1 threshold.  Which face wins then
rests on rounding: the port centres the mesh before its query (as the JAX
package does on a TPU) and the JAX CPU path does not.  The orbit's
distant, nearly parallel rays through the coarse subdiv-1 fixture meet
~700 such samples over its four passes (``-s`` prints the count), and the
texture fusion's global-context pool spreads each to every pixel, well past
the tolerances below.  The port
runs first, in process, and records its query's decisions; the JAX
reference then takes them on the samples where the two queries disagree,
and only there: each such sample must be certified a tie
(``chip_smoke.py::certify_ties``, which phase 8 holds the card to
as well), else the test fails.  (A tie falls by rounding, so
the port's own query on JAX's samples, up to a few 1e-6 from its own,
would not repeat its decisions.)

Tolerances: the same file names; each PNG within 1 level of JAX's on at
most 0.5% of its values (the truncation to uint8 of floats that differ in
the last bits); orbit camera 0's float ``tex_fg_fine`` within atol 1e-4 of
JAX's; the GIF's frames within a mean of 4 levels of the PNGs; the mp4 with
JAX's box tree and sample count.
"""

import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as h
from chip_smoke import certify_ties

EXACT_ENV = {"VANERF_COMPUTE_DTYPE": "float32", "VANERF_PRECISION": "highest",
             "VANERF_FAR_TAU": "0"}
NUM_V_SUBDIV1 = 42
N_FRAMES = 2
NAMES = [f"{i:06d}.png" for i in range(N_FRAMES)] + ["nvs.gif", "nvs.mp4"]


def tiny_video_cfg(out_dir: str) -> dict:
    """``tests/test_video.py``'s config: 32^2 subdiv-1 fixture, 8x8
    training patches with 8 + 8 samples, two orbit frames."""
    from vanerf_tpu_torch.config import default_cfg
    cfg = default_cfg()
    m = cfg["models"]["VANeRF"]
    m["train_out_h"] = m["train_out_w"] = 8
    m["geo_args"]["n_downsample"] = 2
    m["dr_kwargs"]["sample_per_ray_c"] = 8
    m["dr_kwargs"]["sample_per_ray_f"] = 8
    cfg["dataset"]["synthetic_cfg"] = {"H": h.H, "W": h.W, "subdiv": 1}
    cfg["video_cfg"] = {"n_frames": N_FRAMES}
    cfg["out_dir"] = out_dir
    return cfg


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """The tiny config, a replica ``model.ckpt`` and its converted pickle."""
    d = tmp_path_factory.mktemp("video")
    with open(d / "tiny.json", "w") as f:
        json.dump(tiny_video_cfg(str(d / "out")), f)
    h.replica_checkpoints(d, tiny_video_cfg(str(d / "out")), NUM_V_SUBDIV1)
    return d


def video_dir(out: str) -> str:
    return os.path.join(out, "vanerf", "video_interhand")


def read_frames(d: str):
    from vanerf_tpu_torch.evaluator import read_png
    return [read_png(os.path.join(d, n)) for n in NAMES[:N_FRAMES]]


def env_set(env: dict):
    """Set ``env``; return what to restore."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    return old


def env_restore(old: dict) -> None:
    for k, v in old.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.fixture(scope="module")
def port_run(video):
    """The port's ``main`` in process on the replica ``model.ckpt``: its
    result, each camera's float ``tex_fg_fine`` and, call by call, the
    points and binarised visibility of its mesh query (a coarse and a fine
    pass a camera)."""
    from vanerf_tpu_torch import render_dynamic as rd
    from vanerf_tpu_torch import renderer
    texs, queries = [], []
    real_render, real_query = (renderer.render_full_image,
                               renderer.cal_vis_sdf_prepared)

    def render(*a, **k):
        res = real_render(*a, **k)
        texs.append(res["tex_fg_fine"].clone())
        return res

    def query(mesh, points, *a, **k):
        out = real_query(mesh, points, *a, **k)
        queries.append((points[0].numpy().copy(), out[1][0].numpy().copy()))
        return out

    old = env_set(EXACT_ENV)
    renderer.render_full_image, renderer.cal_vis_sdf_prepared = render, query
    try:
        res = rd.main(["--config", str(video / "tiny.json"),
                       "--synthetic_data", "--model_ckpt",
                       str(video / "model.ckpt"), "--out_dir",
                       str(video / "inproc"), "--device", "cpu"])
    finally:
        renderer.render_full_image = real_render
        renderer.cal_vis_sdf_prepared = real_query
        env_restore(old)
    return res, texs, queries


@pytest.fixture(scope="module")
def jax_video(video, port_run):
    """JAX's ``render_dynamic.main([... --model_ckpt <pickle>])`` with the
    port's visibility decisions on the samples where the two queries
    differ, each a certified tie (``certify_ties``, at JAX's point):
    its output directory, each camera's float ``tex_fg_fine`` and the
    counts of the samples that differ and of those not certified, and for
    each query the largest distance between a JAX sample and the port's
    and the share of the samples more than 1e-5 apart."""
    import jax
    if h.ROOT not in sys.path:
        sys.path.insert(0, h.ROOT)
    import render_dynamic as jax_rd
    from vanerf_tpu import renderer as jax_renderer
    from vanerf_tpu.training import loop as jax_loop
    out = str(video / "jax")
    port_queries = iter(port_run[2])
    texs, log = [], {"differ": 0, "uncertified": 0, "shifts": []}
    real_render, real_collate, real_query = (
        jax_renderer.render_full_image, jax_loop.collate_numpy,
        jax_renderer.cal_vis_sdf_prepared)

    def render(*a, **k):
        res = real_render(*a, **k)
        texs.append(np.asarray(res["tex_fg_fine"]))
        return res

    def take_ties(*arrays):
        # numpy only in here: a JAX op in a callback deadlocks the dispatch
        verts, faces, vert_vis, points, qvis = (np.array(a) for a in arrays)
        pts_port, qvis_port = next(port_queries)
        shift = np.abs(pts_port - points).max(1)
        log["shifts"].append((float(shift.max()),
                              float((shift > 1e-5).mean())))
        differ = np.nonzero(qvis_port[:, 0] != qvis[:, 0])[0]
        ok = certify_ties(verts, faces, vert_vis, points[differ])
        qvis[differ[ok]] = qvis_port[differ[ok]]
        log["differ"] += len(differ)
        log["uncertified"] += int((~ok).sum())
        return qvis

    def query(mesh, points, ub, **k):
        sdf, qvis, far = real_query(mesh, points, ub, **k)
        qvis = jax.pure_callback(
            take_ties, jax.ShapeDtypeStruct(qvis.shape, qvis.dtype),
            mesh["verts"], mesh["faces"], mesh["vert_vis"], points, qvis,
            vmap_method="sequential")
        return sdf, qvis, far

    old = env_set(EXACT_ENV)
    jax_renderer.render_full_image = render
    jax_renderer.cal_vis_sdf_prepared = query
    jax_loop.collate_numpy = h.morton_collate(real_collate)
    try:
        jax_rd.main(["--config", str(video / "tiny.json"), "--synthetic_data",
                     "--model_ckpt", str(video / "ckpt.pkl"),
                     "--out_dir", out])
    finally:
        jax_renderer.render_full_image = real_render
        jax_renderer.cal_vis_sdf_prepared = real_query
        jax_loop.collate_numpy = real_collate
        env_restore(old)
    assert next(port_queries, None) is None, "JAX queried less than the port"
    return video_dir(out), texs, log


def test_jax_render_dynamic_reference(jax_video):
    """The reference the next tests hold the port to (its own test so that
    each stays inside a minute: the JAX compile is here): JAX's samples
    those of the port, every sample on which the two visibility queries
    disagree a certified tie (-s prints how many: ~700 of 262,144)."""
    d, texs, log = jax_video
    print(f"visibility ties taken from the port: {log}")
    assert log["uncertified"] == 0 and log["differ"] > 0
    # the samples pair up: the coarse passes' within 1e-5, the fine ones'
    # but where an almost flat CDF of the coarse weights moves them
    coarse, fine = log["shifts"][0::2], log["shifts"][1::2]
    assert all(m < 1e-5 for m, _ in coarse)
    assert all(share < 0.01 for _, share in fine)
    assert sorted(os.listdir(d)) == NAMES
    assert len(texs) == N_FRAMES
    assert all(t.shape == (1, h.H, h.W, 3) for t in texs)
    # the orbit sees the hands: the frames are not blank
    assert all((f > 0).mean() > 0.05 for f in read_frames(d))


# the CLI with no imaging library importable: the video path needs none
NO_PIL = ("import runpy, sys; sys.modules['PIL'] = None; "
          "sys.modules['imageio'] = None; "
          "runpy.run_module('vanerf_tpu_torch.render_dynamic', "
          "run_name='__main__')")


def test_cli_equals_jax(video, port_run, jax_video):
    """``python -m vanerf_tpu_torch.render_dynamic`` on the replica
    ``model.ckpt``, PIL and imageio blocked: the frames of ``main`` in
    process; JAX's file names; each PNG
    within 1 level of JAX's on at most 0.5% of its values; the GIF's frames
    (decoded by PIL) within a mean of 4 levels of the PNGs, 10 cs each; the
    mp4 with JAX's box tree, one JPEG sample a frame."""
    from vanerf_tpu.video import parse_boxes
    out = str(video / "port")
    env = dict(os.environ, PYTHONPATH=h.ROOT, OMP_NUM_THREADS="2",
               **EXACT_ENV)
    proc = subprocess.run(
        [sys.executable, "-c", NO_PIL, "--config", str(video / "tiny.json"),
         "--synthetic_data", "--model_ckpt", str(video / "model.ckpt"),
         "--out_dir", out, "--device", "cpu"],
        cwd=h.ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "Loaded checkpoint at step" in proc.stdout
    d = jax_video[0]
    got_dir = video_dir(out)
    assert sorted(os.listdir(got_dir)) == NAMES
    for got, frame in zip(read_frames(got_dir), port_run[0]["frames"]):
        np.testing.assert_array_equal(got, frame)      # the CLI = main
    for got, want in zip(read_frames(got_dir), read_frames(d)):
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 0.005

    from PIL import Image, ImageSequence
    frames = read_frames(got_dir)
    gif = Image.open(os.path.join(got_dir, "nvs.gif"))
    dec = [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(gif)]
    assert len(dec) == N_FRAMES
    for g, f in zip(dec, frames):
        assert np.abs(g.astype(int) - f).mean() <= 4
    assert gif.info["duration"] == 100

    def tree(path):
        with open(path, "rb") as f:
            data = f.read()

        def walk(s, e):
            out = []
            for t, ps, pe in parse_boxes(data, s, e):
                if t in (b"moov", b"trak", b"mdia", b"minf", b"stbl",
                         b"dinf"):
                    out.append((t, walk(ps, pe)))
                else:
                    out.append((t, None))
            return out
        return data, walk(0, len(data))

    data, got_tree = tree(os.path.join(got_dir, "nvs.mp4"))
    _, want_tree = tree(os.path.join(d, "nvs.mp4"))
    assert got_tree == want_tree
    (mdat_s, mdat_e), = [(s, e) for t, s, e in parse_boxes(data)
                         if t == b"mdat"]
    i = data.index(b"stsz")
    n = struct.unpack(">I", data[i + 12:i + 16])[0]
    sizes = struct.unpack(f">{n}I", data[i + 16:i + 16 + 4 * n])
    assert n == N_FRAMES and sum(sizes) == mdat_e - mdat_s
    off = mdat_s
    for s in sizes:
        assert data[off:off + 2] == b"\xff\xd8"
        assert data[off + s - 2:off + s] == b"\xff\xd9"
        off += s


def test_orbit_render_equals_jax(port_run, jax_video):
    """``main`` in process on the replica ``model.ckpt``: orbit camera 0's
    float ``tex_fg_fine`` within atol 1e-4 of JAX's (-s prints it), every returned frame
    equal to its PNG, and camera 0 rendered again from the returned model,
    batch and cameras equal to the bit."""
    from vanerf_tpu_torch import render_dynamic as rd
    from vanerf_tpu_torch import renderer
    res, texs, _ = port_run
    want = jax_video[1]
    assert len(texs) == N_FRAMES
    print(f"camera 0 tex_fg_fine against JAX: "
          f"{np.abs(texs[0].numpy() - want[0]).max():.2g}")
    np.testing.assert_allclose(texs[0].numpy(), want[0], rtol=0, atol=1e-4)
    for got, frame in zip(read_frames(res["out_dir"]), res["frames"]):
        np.testing.assert_array_equal(got, frame)
    old = env_set(EXACT_ENV)
    try:
        again = renderer.render_full_image(
            res["model"], rd.camera_batch(res["batch"], res["cams"][0]),
            level=res["level"], tile_group=res["tile_group"])
    finally:
        env_restore(old)
    assert torch.equal(again["tex_fg_fine"], texs[0])
    np.testing.assert_array_equal(rd.to_uint8(again["tex_fg_fine"]),
                                  res["frames"][0])


def test_orbit_and_level_equal_jax():
    """The orbit of ``orbit_cameras`` equals the cameras JAX's CLI builds
    (the same numbers through ``vanerf_tpu.camera_path``), and the frame
    level and tile group its plan."""
    from vanerf_tpu.camera_path import get_360cameras
    from vanerf_tpu.renderer import plan_tile_group as jax_plan
    from vanerf_tpu_torch import render_dynamic as rd
    from vanerf_tpu_torch.renderer import plan_tile_group
    batch, _ = h.synthetic_batch()
    cams = rd.orbit_cameras(h.torch_batch(batch), 20)
    W = batch["src_img"].shape[2]
    headpose = np.eye(4, dtype=np.float32)
    headpose[:3, 3] = batch["kpt3d"][0, 0]
    want = get_360cameras(headpose, W * 30 + 0.01 * (W * 0.05 - W * 30),
                          10.0, 1.0, W, W, 5.0, 15.0, 20)
    assert len(cams) == 20
    for a, b in zip(cams, want):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for im_h in (32, 64, 128, 256, 512):
        level = rd.frame_level(im_h)
        assert level == max(1, int(np.log2(im_h)) - 5)
        for tg in (1, 4, 16):
            assert plan_tile_group(4 ** (level - 1), tg) == jax_plan(
                4 ** (level - 1), tg)
    b = rd.camera_batch(h.torch_batch(batch), cams[3])
    assert b["tar_k"].shape == (1, 4, 4) and b["tar_rt"].shape == (1, 4, 4)
    assert b["znear"].ndim == 0 and b["zfar"].ndim == 0
    assert b["tar_img"] is None and b["tar_mask"] is None


def test_cli_refusals(video, tmp_path):
    """The card on a machine without one stops the run before it writes
    anything, on one device and before any of --num_gpus 2's workers
    starts; nothing falls back to the CPU."""
    from vanerf_tpu_torch import render_dynamic as rd
    base = ["--config", str(video / "tiny.json"), "--synthetic_data",
            "--out_dir", str(tmp_path)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            rd.main(base)
        with pytest.raises(RuntimeError, match="--device cpu"):
            rd.main(base + ["--num_gpus", "2"])
    assert not os.path.exists(tmp_path / "vanerf")


def test_certify_ties_rejects_a_clear_nearest_face():
    """The control of ``certify_ties``: points 0.01 off each face's
    centroid along its normal have one nearest face, so none is a tie,
    whatever the visibility."""
    from vanerf_tpu_torch.data.synthetic import two_hand_mesh
    verts, faces, _ = two_hand_mesh(0, 1)
    tri = verts[faces].astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    pts = tri.mean(1) + 0.01 * n
    vis = (np.arange(len(verts)) % 2).astype(np.float32)[:, None]
    assert not certify_ties(verts, faces, vis, pts).any()
