"""The offline preprocessor, ``python -m vanerf_tpu_torch.dataset_process``,
against the JAX package's ``data_process/dataset_process.py`` on the CPU.

The raw InterHand2.6M layout of ``tests/test_preprocess_pipeline.py``
(COCO ``*_data.json``, ``*_camera.json`` in millimetres, the MANO and joint
JSONs, four cameras of one interacting frame) at a raw size of 96 x 64,
so that the JAX package's XLA rasterizer stays fast, with a focal length of
600 px, so that the hands cover a few percent of it; MANO is the synthetic
pair (``load_mano_pair`` on a missing path).  Both preprocessors run on
the same root:

  * each view's mask and densepose before the JPEG step equal to the bit
    (the port's rasterizer is ``raster_plain`` here, kernel C's plain
    version; the colour sum rounds as numpy's);
  * every file of the two trees byte-equal (the JPEGs, the annotation and
    index pickles, ``cam_list.pth``), and the pickles equal as objects;
  * the port's ``InterHandDataset`` reads the port's tree into a batch of
    finite values.
"""

import filecmp
import json
import os
import os.path as osp
import pickle
import sys

import numpy as np
import pytest
import torch

import torch_port_helpers as h

CAPTURE = "3"
FRAME = "5"
CAMS = ["410001", "410004", "410010", "410018"]
RAW_H, RAW_W = 64, 96
FOCAL = 600.0


def write_raw_root(root: str) -> None:
    """The raw layout of tests/test_preprocess_pipeline.py::raw_root at
    RAW_H x RAW_W."""
    from PIL import Image
    ann = osp.join(root, "InterHand2.6M", "annotations", "train")
    os.makedirs(ann)
    rs = np.random.RandomState(0)
    images, annots = [], []
    cameras = {CAPTURE: {"campos": {}, "camrot": {}, "focal": {},
                         "princpt": {}}}
    for i, cam in enumerate(CAMS):
        fname = f"Capture{CAPTURE}/ROM0/cam{cam}/image{FRAME}.jpg"
        images.append({"id": 100 + i, "capture": int(CAPTURE),
                       "frame_idx": int(FRAME), "camera": cam,
                       "file_name": fname, "width": RAW_W,
                       "height": RAW_H})
        annots.append({"id": 200 + i, "image_id": 100 + i,
                       "hand_type": "interacting", "hand_type_valid": 1})
        cameras[CAPTURE]["campos"][cam] = [40.0 * i - 60.0, 10.0 * i, 0.0]
        cameras[CAPTURE]["camrot"][cam] = np.eye(3).tolist()
        cameras[CAPTURE]["focal"][cam] = [FOCAL, FOCAL]
        cameras[CAPTURE]["princpt"][cam] = [RAW_W / 2, RAW_H / 2]
        d = osp.join(root, "InterHand2.6M", "images", "train",
                     osp.dirname(fname))
        os.makedirs(d, exist_ok=True)
        img = (rs.rand(RAW_H, RAW_W, 3) * 200 + 30).astype(np.uint8)
        Image.fromarray(img).save(osp.join(root, "InterHand2.6M", "images",
                                           "train", fname))
    with open(osp.join(ann, "InterHand2.6M_train_data.json"), "w") as f:
        json.dump({"images": images, "annotations": annots}, f)
    with open(osp.join(ann, "InterHand2.6M_train_camera.json"), "w") as f:
        json.dump(cameras, f)
    manos = {CAPTURE: {FRAME: {
        hand: {"pose": np.zeros(48).tolist(), "shape": np.zeros(10).tolist(),
               "trans": [0.04 if hand == "right" else -0.04, 0.0, 1.1]}
        for hand in ("right", "left")}}}
    with open(osp.join(ann, "InterHand2.6M_train_MANO_NeuralAnnot.json"),
              "w") as f:
        json.dump(manos, f)
    joints = {CAPTURE: {FRAME: {
        "world_coord": (np.random.RandomState(1)
                        .normal(scale=40.0, size=(42, 3))
                        + [0, 0, 1100]).tolist()}}}
    with open(osp.join(ann, "InterHand2.6M_train_joint_3d.json"), "w") as f:
        json.dump(joints, f)


def _jax_preprocessor():
    if h.ROOT not in sys.path:
        sys.path.insert(0, h.ROOT)
    from data_process import dataset_process
    return dataset_process


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(raw root, the JAX tree, the port's tree): both preprocessors on one
    raw root; the port's tree is the root's processed_dataset, which its
    reader opens."""
    from vanerf_tpu_torch import dataset_process as tp
    root = str(tmp_path_factory.mktemp("ih_raw_small"))
    write_raw_root(root)
    out_j = osp.join(root, "processed_jax")
    out_t = osp.join(root, "processed_dataset")
    common = ["--data_root", root, "--split", "train",
              "--smplx_path", osp.join(root, "nonexistent")]
    _jax_preprocessor().main(common + ["--out", out_j])
    tp.main(common + ["--out", out_t, "--device", "cpu"])
    return root, out_j, out_t


def _view_inputs(root, cam):
    """One raw view's mesh, camera and decoded image as both
    preprocessors see them."""
    from PIL import Image

    from vanerf_tpu_torch import dataset_process as tp
    from vanerf_tpu_torch.mano import load_mano_pair
    ann = osp.join(root, "InterHand2.6M", "annotations", "train")
    with open(osp.join(ann, "InterHand2.6M_train_camera.json")) as f:
        cams = json.load(f)[CAPTURE]
    with open(osp.join(ann, "InterHand2.6M_train_MANO_NeuralAnnot.json")) as f:
        mano_frame = json.load(f)[CAPTURE][FRAME]
    campos = np.asarray(cams["campos"][cam], np.float32) / 1000.0
    R = np.asarray(cams["camrot"][cam], np.float32)
    t = -R @ campos
    focal = np.asarray(cams["focal"][cam], np.float32)
    pp = np.asarray(cams["princpt"][cam], np.float32)
    K = np.array([[focal[0], 0, pp[0]], [0, focal[1], pp[1]], [0, 0, 1]],
                 np.float32)
    verts, faces = tp.two_hand_mesh(
        load_mano_pair(osp.join(root, "nonexistent", "mano")), mano_frame)
    img = np.asarray(Image.open(osp.join(
        root, "InterHand2.6M", "images", "train",
        f"Capture{CAPTURE}/ROM0/cam{cam}/image{FRAME}.jpg")).convert("RGB"))
    return verts, faces, K, R, t, img


@pytest.mark.parametrize("cam", CAMS)
def test_mask_and_densepose_match_jax_to_the_bit(trees, cam):
    """The device work of one view (kernel C's plain version here) against
    JAX's ``render_mask_densepose``, before any JPEG: mask and densepose
    equal to the bit; the two-hand mesh equal to JAX's MANO layer's; the
    bbox and the crop's intrinsics equal to JAX's float32 numpy."""
    from vanerf_tpu.mano import (load_mano_pair as j_load,
                                 mano_forward_np as j_fwd,
                                 seal_verts_np as j_seal)
    from vanerf_tpu_torch import dataset_process as tp
    dp_j = _jax_preprocessor()
    root = trees[0]
    verts, faces, K, R, t, img = _view_inputs(root, cam)
    # JAX's own mesh (dataset_process.py:169-182)
    mano = j_load(osp.join(root, "nonexistent", "mano"))
    vs, fs, off = [], [], 0
    for hand, trans in (("right", 0.04), ("left", -0.04)):
        v, _ = j_fwd(mano[hand], np.zeros(10, np.float32),
                     np.zeros(48, np.float32),
                     np.array([trans, 0.0, 1.1], np.float32))
        v, f = j_seal(np.asarray(v), mano[hand].faces, hand)
        vs.append(v)
        fs.append(f + off)
        off += len(v)
    np.testing.assert_array_equal(verts, np.concatenate(vs, 0))
    np.testing.assert_array_equal(faces, np.concatenate(fs, 0))

    mask_j, dpj = dp_j.render_mask_densepose(verts, faces, K, R, t, RAW_H,
                                             RAW_W)
    view = tp.render_view(img, verts, faces, K, R, t, torch.device("cpu"))
    assert view is not None and 0.01 < (view["mask"] > 0).mean() < 0.9
    assert view["mask"].dtype == np.uint8 and view["densepose"].dtype \
        == np.uint8
    np.testing.assert_array_equal(view["mask"], mask_j)
    np.testing.assert_array_equal(view["densepose"], dpj)
    ys, xs = np.where(mask_j > 0)
    bbox = dp_j.process_bbox((xs.min(), ys.min(), xs.max() - xs.min(),
                              ys.max() - ys.min()), RAW_W, RAW_H)
    np.testing.assert_array_equal(view["bbox"], bbox)
    np.testing.assert_array_equal(view["K_c"], dp_j.adjust_K(K, bbox))


def _files(base):
    out = []
    for d, _, names in os.walk(base):
        out += [osp.relpath(osp.join(d, n), base) for n in names]
    return sorted(out)


def test_trees_byte_equal(trees):
    """Every file the JAX preprocessor writes, the port writes byte-equal:
    the image / mask / densepose JPEGs at quality 95, the annotation and
    index pickles and cam_list.pth; the pickles also equal as objects."""
    _, out_j, out_t = trees
    files = _files(out_j)
    assert files == _files(out_t)
    for sub in ("image", "mask", "densepose", "annotation"):
        assert sum(f.startswith(f"train/{sub}/") for f in files) == \
            len(CAMS), sub
    assert "train/index/0.pkl" in files and "train/cam_list.pth" in files
    for f in files:
        a, b = osp.join(out_j, f), osp.join(out_t, f)
        assert filecmp.cmp(a, b, shallow=False), f
        if f.endswith((".pkl", ".pth")):
            with open(a, "rb") as fa, open(b, "rb") as fb:
                pa, pb = pickle.load(fa), pickle.load(fb)
            assert repr(pa) == repr(pb), f


def test_processed_tree_reads_into_a_batch(trees):
    """The port's reader turns the port's tree into a batch: the item is
    not None (the reader returns None on an exception), the shapes are the
    renderer's, every float finite."""
    from vanerf_tpu_torch.data.interhand import InterHandDataset
    from vanerf_tpu_torch.training.loop import collate_numpy
    root = trees[0]
    ds = InterHandDataset(split="train", data_root=root,
                          smplx_path=osp.join(root, "nonexistent"),
                          max_len=1, num_input_view=1)
    item = ds[0]
    assert item is not None, "the reader failed on the preprocessor's tree"
    assert item["src_img"].shape == (1, 256, 256, 3)
    assert item["verts"].shape == (2 * 779, 3)
    batch = collate_numpy([item], faces=ds.faces)
    assert batch["tar_img"].shape == (1, 256, 256, 3)
    for k, v in item.items():
        if isinstance(v, np.ndarray) and v.dtype.kind == "f":
            assert np.isfinite(v).all(), k


def test_cli_refuses_a_missing_card(tmp_path, monkeypatch):
    """The entry point runs on the card unless --device cpu: without one it
    raises before reading anything (no fallback)."""
    from vanerf_tpu_torch import dataset_process as tp
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tp.main(["--data_root", str(tmp_path)])
