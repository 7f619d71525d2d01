"""The port's input pipeline against the JAX package's: the MANO layer
(numpy and torch) with the conditional left-hand shapedirs flip, the
torchvision-exact colour jitter, the InterHand2.6M reader on the on-disk
fixture of ``tests/test_interhand_fixture.py`` (items bit-equal, none
``None``), ``collate_numpy`` and the sample loader's workers.

Tolerances: the numpy paths (MANO numpy forward, jitter, InterHand items,
collate) are the same arithmetic as the JAX package's and are held equal to
the bit; the torch MANO forward to 2e-6 of JAX's and 5e-5 of the
independent float64 oracle (``tests/test_mano_oracle.py``'s bounds).
"""

import os
import os.path as osp
import pickle

import numpy as np
import pytest
import torch

import torch_port_helpers as h  # noqa: F401  (sys.path, thread count)
from test_interhand_fixture import CAMS, _camera, fake_root  # noqa: F401
from test_mano_oracle import (_fake_pair_dir, oracle_mano_forward,
                              random_mano_model)


def assert_items_equal(a, b):
    assert a is not None and b is not None
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], np.ndarray) or np.ndim(a[k]) > 0:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
        else:
            assert a[k] == b[k], k


# ---------------------------------------------------------------------------
# MANO
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,is_rhand,flat", [(0, True, False),
                                                (1, False, False),
                                                (2, True, True)])
def test_mano_forward_matches_jax_and_oracle(seed, is_rhand, flat):
    """numpy forward bit-equal to JAX's numpy forward; the torch forward
    within 2e-6 of JAX's and 5e-5 of the oracle."""
    import jax.numpy as jnp
    from vanerf_tpu.mano import mano_forward as mf_j
    from vanerf_tpu.mano import mano_forward_np as mfn_j
    from vanerf_tpu_torch.mano import mano_forward, mano_forward_np
    model = random_mano_model(300 + seed, is_rhand)
    rs = np.random.RandomState(seed)
    betas = rs.randn(10).astype(np.float32)
    pose = (rs.randn(48) * 0.6).astype(np.float32)
    trans = (rs.randn(3) * 0.1).astype(np.float32)

    vn, jn = mano_forward_np(model, betas, pose, trans, flat_hand_mean=flat)
    vn_j, jn_j = mfn_j(model, betas, pose, trans, flat_hand_mean=flat)
    np.testing.assert_array_equal(vn, vn_j)
    np.testing.assert_array_equal(jn, jn_j)

    vt, jt = mano_forward(model, torch.from_numpy(betas),
                          torch.from_numpy(pose), torch.from_numpy(trans),
                          flat_hand_mean=flat)
    vj, jj = mf_j(model, jnp.asarray(betas), jnp.asarray(pose),
                  jnp.asarray(trans), flat_hand_mean=flat)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=2e-6)
    np.testing.assert_allclose(jt.numpy(), np.asarray(jj), atol=2e-6)
    ov, oj = oracle_mano_forward(model, betas, pose, trans,
                                 flat_hand_mean=flat)
    for got in (vn, vt.numpy()):
        np.testing.assert_allclose(got, ov, atol=5e-5)
    for got in (jn, jt.numpy()):
        np.testing.assert_allclose(got, oj, atol=5e-5)


def test_synthetic_mano_and_seal_match_jax():
    from vanerf_tpu.mano.layer import seal_verts_np as seal_j
    from vanerf_tpu.mano.layer import synthetic_mano_model as syn_j
    from vanerf_tpu_torch.mano.layer import (mano_forward_np, seal_verts_np,
                                             synthetic_mano_model)
    for is_rhand, hand in ((True, "right"), (False, "left")):
        m, mj = synthetic_mano_model(is_rhand), syn_j(is_rhand)
        for f in ("v_template", "shapedirs", "posedirs", "J_regressor",
                  "weights", "faces", "parents", "hands_mean"):
            np.testing.assert_array_equal(getattr(m, f), getattr(mj, f))
        rs = np.random.RandomState(5)
        v, _ = mano_forward_np(m, rs.randn(10), rs.randn(48) * 0.5,
                               rs.randn(3) * 0.1)
        for a, b in zip(seal_verts_np(v, m.faces, hand),
                        seal_j(v, mj.faces, hand)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("buggy", [True, False])
def test_left_shapedirs_flip_once(tmp_path, buggy):
    """The conditional flip: applied on the buggy release, skipped on a
    corrected pickle, never twice (a second load, and the single-file
    loader, give the same arrays), equal to JAX's loaders."""
    from vanerf_tpu.mano import load_mano_model as lmm_j
    from vanerf_tpu.mano import load_mano_pair as lmp_j
    from vanerf_tpu_torch.mano import load_mano_model, load_mano_pair
    d, right, left_on_disk = _fake_pair_dir(tmp_path, buggy=buggy)
    pair = load_mano_pair(d)
    want = left_on_disk.shapedirs.copy()
    if buggy:
        want[:, 0, :] *= -1
    np.testing.assert_array_equal(pair["left"].shapedirs, want)
    np.testing.assert_array_equal(pair["right"].shapedirs, right.shapedirs)
    np.testing.assert_array_equal(load_mano_pair(d)["left"].shapedirs, want)
    single = load_mano_model(osp.join(d, "MANO_LEFT.pkl"), False)
    np.testing.assert_array_equal(single.shapedirs, want)
    np.testing.assert_array_equal(lmp_j(d)["left"].shapedirs, want)
    np.testing.assert_array_equal(
        lmm_j(osp.join(d, "MANO_LEFT.pkl"), False).shapedirs, want)
    np.testing.assert_array_equal(pair["left"].parents, right.parents)


def test_load_mano_pair_synthetic_fallback(tmp_path):
    from vanerf_tpu_torch.mano import load_mano_pair
    pair = load_mano_pair(str(tmp_path / "nope"))
    assert pair["right"].synthetic and pair["left"].synthetic
    assert pair["right"].faces.shape == (1538, 3)


# ---------------------------------------------------------------------------
# colour jitter (the cases of tests/test_data_semantics.py)
# ---------------------------------------------------------------------------

def test_jitter_params_equal_jax():
    from vanerf_tpu.data import jitter as jj
    from vanerf_tpu_torch.data import jitter as jt
    for seed in list(range(40)) + [1234, 777, 8999999]:
        assert jt.jitter_params(seed) == jj.jitter_params(seed)
    assert (jt.BRIGHTNESS, jt.CONTRAST, jt.SATURATION, jt.HUE) == (
        jj.BRIGHTNESS, jj.CONTRAST, jj.SATURATION, jj.HUE)


@pytest.mark.parametrize("fn_idx,b,c,s,hue", [
    ([0], 0.2, 1, 1, 0), ([0], 1.8, 1, 1, 0), ([1], 1, 0.3, 1, 0),
    ([1], 1, 1.5, 1, 0), ([2], 1, 1, 0.2, 0), ([2], 1, 1, 0.0, 0),
    ([3], 1, 1, 1, 0.0), ([3], 1, 1, 1, 0.5), ([3], 1, 1, 1, -0.5),
    ([0, 1, 2, 3], 1.8, 0.5, 1.7, 0.2), ([3, 2, 1, 0], 1.8, 0.5, 1.7, 0.2)])
def test_apply_jitter_equal_jax(fn_idx, b, c, s, hue):
    from vanerf_tpu.data import jitter as jj
    from vanerf_tpu_torch.data import jitter as jt
    rs = np.random.RandomState(len(fn_idx) * 7 + int(10 * b))
    img = rs.randint(0, 256, (24, 24, 3), dtype=np.uint8)
    np.testing.assert_array_equal(jt.apply_jitter(img, fn_idx, b, c, s, hue),
                                  jj.apply_jitter(img, fn_idx, b, c, s, hue))


def test_color_jitter_ref_equal_jax_shared_seed():
    from vanerf_tpu.data import jitter as jj
    from vanerf_tpu_torch.data import jitter as jt
    rs = np.random.RandomState(0)
    for seed in (777, 778, 1234):
        for _ in range(2):      # the same seed for every view
            img = rs.randint(0, 256, (24, 24, 3), dtype=np.uint8)
            np.testing.assert_array_equal(jt.color_jitter_ref(img, seed),
                                          jj.color_jitter_ref(img, seed))


def test_erode_and_view_tables_equal_jax():
    import random
    from vanerf_tpu.data import interhand as ihj
    from vanerf_tpu_torch.data import interhand as iht
    img = np.random.RandomState(3).rand(4, 5, 3).astype(np.float32) * 0.2
    mask = np.ones((4, 5), np.uint8)
    for flag in (True, False):
        for a, b in zip(iht.erode_target_mask(img, mask, flag),
                        ihj.erode_target_mask(img, mask, flag)):
            np.testing.assert_array_equal(a, b)
    all_views = [(f"cam{i}", i) for i in range(60)]
    for mode, big, cap, nv in (("test", False, 0, 1), ("test", True, 7, 1),
                               ("test", False, 10, 1), ("train", False, 0, 2)):
        dt = iht.InterHandDataset.__new__(iht.InterHandDataset)
        dj = ihj.InterHandDataset.__new__(ihj.InterHandDataset)
        for d in (dt, dj):
            d.mode, d.big_view_variation, d.num_input_view = mode, big, nv
        for res in range(5):
            assert (dt.select_views(all_views, cap, res, random.Random(res))
                    == dj.select_views(all_views, cap, res,
                                       random.Random(res)))


# ---------------------------------------------------------------------------
# InterHand2.6M reader on the on-disk fixture
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jitter", [False, True])
def test_interhand_items_equal_jax(fake_root, jitter):  # noqa: F811
    """Every array of the port's item is bit-equal to the JAX package's,
    and neither is None (``__getitem__`` turns exceptions into None)."""
    from vanerf_tpu.data.interhand import InterHandDataset as DJ
    from vanerf_tpu_torch.data.interhand import InterHandDataset as DT
    kw = dict(split="train", data_root=fake_root,
              smplx_path=osp.join(fake_root, "nonexistent"), max_len=1,
              num_input_view=1, color_jitter=jitter)
    dt, dj = DT(**kw), DJ(**kw)
    np.testing.assert_array_equal(dt.faces, dj.faces)
    assert dt.num_v == dj.num_v == 779 and len(dt) == len(dj) == 1
    a = dt[0]
    assert a is not None, "the port's item failed to load"
    assert_items_equal(a, dj[0])
    # the dataset travels to the sample loader's workers by pickle
    assert_items_equal(pickle.loads(pickle.dumps(dt))[0], a)


def test_interhand_from_config_equal_jax(fake_root):  # noqa: F811
    from vanerf_tpu.data.interhand import InterHandDataset as DJ
    from vanerf_tpu_torch.config import default_cfg
    from vanerf_tpu_torch.data.interhand import InterHandDataset as DT
    cfg = default_cfg()
    dcfg = dict(cfg["dataset"], data_root=fake_root,
                smplx_path=osp.join(fake_root, "nonexistent"))
    dcfg["train_cfg"] = {"max_len": 1}
    for split in ("train", "val", "test"):
        dt = DT.from_config(dcfg, split, cfg)
        dj = DJ.from_config(dcfg, split, cfg)
        assert (dt.split, dt.mode, len(dt)) == (dj.split, dj.mode, len(dj))
        assert dt.if_color_jitter == dj.if_color_jitter
    dt = DT.from_config(dcfg, "train", cfg)
    assert_items_equal(dt[0], DJ.from_config(dcfg, "train", cfg)[0])


def test_interhand_use_intag_preds_equal_jax(fake_root, tmp_path):  # noqa: F811
    """The estimated-mesh input mode: the predicted camera-space vertices,
    the 21-joint regressor, sealing and the predicted bounds, against
    JAX's items (the regressor of an empty smplx dir is the vendored copy,
    byte-equal to JAX's)."""
    from vanerf_tpu.data.interhand import InterHandDataset as DJ
    from vanerf_tpu_torch.data.interhand import InterHandDataset as DT
    root = str(tmp_path / "root")
    import shutil
    shutil.copytree(fake_root, root)
    proc = osp.join(root, "processed_dataset/train")
    os.makedirs(osp.join(proc, "verts_preds"), exist_ok=True)
    rs = np.random.RandomState(11)
    vert_cam = rs.normal(scale=0.03, size=(1556, 3)).astype(np.float32)
    vert_cam[:, 2] += 1.1
    with open(osp.join(proc, "verts_preds", "0.pkl"), "wb") as f:
        pickle.dump(vert_cam, f)
    kw = dict(split="train", data_root=root,
              smplx_path=osp.join(root, "nonexistent"), max_len=1,
              num_input_view=1, use_intag_preds=True)
    dt, dj = DT(**kw), DJ(**kw)
    np.testing.assert_array_equal(dt.joint_regressor, dj.joint_regressor)
    a = dt[0]
    assert a is not None, "the port's intag item failed to load"
    assert_items_equal(a, dj[0])
    # the predicted mesh, sealed, in world space (independent recompute)
    cam = _camera(CAMS.index(str(a["cam_ind"])))
    world = (np.linalg.inv(cam["camrot"]) @ vert_cam.T
             + cam["campos"].reshape(3, 1) / 1000.0).T
    np.testing.assert_allclose(a["verts"][:778], world[:778], atol=1e-5)
    np.testing.assert_allclose(a["verts"][779:779 + 778], world[778:],
                               atol=1e-5)


def test_interhand_missing_file_is_none(tmp_path):
    """A broken sample is None through ``__getitem__`` (the loader drops
    it) and raises through ``_getitem``."""
    from vanerf_tpu_torch.data.interhand import InterHandDataset
    ds = InterHandDataset(split="train", data_root=str(tmp_path),
                          smplx_path=str(tmp_path / "none"), max_len=1)
    assert ds[0] is None
    with pytest.raises(FileNotFoundError):
        ds._getitem(0)


# ---------------------------------------------------------------------------
# collate and the sample loader
# ---------------------------------------------------------------------------

def test_collate_numpy_equal_jax(fake_root):  # noqa: F811
    from vanerf_tpu.data.synthetic import SyntheticDataset as SJ
    from vanerf_tpu.training.loop import collate_numpy as cj
    from vanerf_tpu_torch.data.interhand import InterHandDataset
    from vanerf_tpu_torch.training.loop import collate_numpy as ct
    syn = SJ(n_frames=1, n_cams=4, H=32, W=32, subdiv=1, num_input_view=2)
    ih = InterHandDataset(split="train", data_root=fake_root,
                          smplx_path=osp.join(fake_root, "nonexistent"),
                          max_len=1, num_input_view=2)
    for items, faces in (([syn[0], syn[3]], syn.faces),
                         ([ih[0]], ih.faces), ([syn[1]], None)):
        got = ct(items, faces=faces)
        want = cj(items, faces=faces)
        assert set(got) == set(want)
        for k in want:
            assert isinstance(got[k], np.ndarray), k
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)
    assert got["src_img"].shape[0] == 2         # (B * V) source views


def test_sample_loader_workers_rasterize_on_the_cpu():
    """A fixture dataset set for the card loads in the loader's worker
    processes all the same: the workers pin it to the CPU and never touch
    CUDA (here there is none), and the batches hold the CPU dataset's items
    in the order of the index lists, as inline loading does."""
    from vanerf_tpu_torch.data.synthetic import SyntheticDataset
    from vanerf_tpu_torch.training.loop import sample_loader
    kw = dict(n_frames=1, n_cams=4, H=32, W=32, subdiv=1)
    on_card = SyntheticDataset(device="cpu", **kw)
    on_card.device = torch.device("cuda")    # as built where there is one
    on_cpu = SyntheticDataset(device="cpu", **kw)
    batches = [[3, 1], [0], [2, 1]]
    pooled = list(sample_loader(on_card, batches, 2))
    inline = list(sample_loader(on_cpu, batches, 1))
    assert [len(b) for b in pooled] == [len(b) for b in inline] == [2, 1, 2]
    for idx, got, want in zip(batches, pooled, inline):
        for i, a, b in zip(idx, got, want):
            assert_items_equal(a, on_cpu[i])
            assert_items_equal(a, b)
