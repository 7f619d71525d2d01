"""InterHand2.6M dataset pipeline (port of ``vanerf_tpu/data/interhand.py``;
CPU, numpy, PIL imported where a JPEG is decoded).

Parity target: ``Dataset``/``TestDataset`` (reference ``src/dataset.py``),
consuming the on-disk layout produced by the offline preprocessor
(``processed_dataset/{split}/{image,mask,densepose,annotation,index}`` +
``cam_list.pth`` + the InterHand annotation JSONs) with the same data
semantics:

  * train view sampling: random source views + disjoint random target
    (``dataset.py:392-402``); test: fixed per-`index_res` view-pair tables,
    small vs big view variation (``dataset.py:406-420``);
  * MANO forward per hand -> seal -> concat (:mod:`..mano`), voxel
    coords/out_sh, bounds (``dataset.py:208-361``);
  * shared-seed color jitter across views (``dataset.py:113-120,455-459``);
  * target-view mask erosion rules (``dataset.py:470-475``);
  * mask-at-box + near/far from ray/AABB (``dataset.py:122-129,558-568``);
  * split sizes 5423 / 8 / 1895 x input_per_frame (``dataset.py:364-370``).

Items are the channels-last numpy dicts of the synthetic fixture's schema.
"""

from __future__ import annotations

import copy
import json
import os
import os.path as osp
import pickle
import random
from typing import Optional

import numpy as np

from ..mano import load_mano_pair, mano_forward_np, seal_verts_np
from ..ops.ray import get_rays_np, get_near_far_np
from .jitter import color_jitter_ref

# fixed test view-pair tables (dataset.py:406-411)
_INPUT_LIST_01_SMALL = {"0": [37, 44], "1": [8, 16], "2": [23, 25],
                        "3": [41, 43], "4": [55, 56]}
_INPUT_LIST_27_SMALL = {"0": [0, 3], "1": [1, 2], "2": [4, 5],
                        "3": [8, 9], "4": [16, 17]}
_INPUT_LIST_01_BIG = {"0": [0, 1], "1": [1, 2], "2": [2, 3],
                      "3": [5, 6], "4": [11, 12]}
_INPUT_LIST_27_BIG = {"0": [0, 3], "1": [0, 4], "2": [0, 6],
                      "3": [4, 8], "4": [0, 13]}


def erode_target_mask(img: np.ndarray, mask: np.ndarray,
                      if_color_jitter: bool):
    """Target-view mask erosion (ref ``dataset.py:470-475``).

    Pixels whose green channel falls at/below the threshold are pushed to
    background; the threshold depends on the ``color_jitter`` config FLAG
    (not on whether jitter was actually applied — test mode with the flag
    on still uses 0.03, exactly like the reference).

    Args:
      img: (H, W, 3) float in [0, 1], already background-masked.
      mask: (H, W) uint8/bool foreground mask.
    Returns:
      (img, mask) eroded copies.
    """
    thr = 0.03 if if_color_jitter else 0.1
    mask = mask.copy()
    mask[img[:, :, 1] <= thr] = 0
    img = img.copy()
    img[mask == 0] = 0
    return img, mask


class InterHandDataset:
    """Loader over the preprocessed InterHand2.6M layout."""

    def __init__(self, split: str, data_root: Optional[str] = None,
                 smplx_path: str = "smplx/models", **kwargs):
        self.split = split
        self.mode = "train" if split == "val" else split
        # fixed frustum unless provide_znear_zfar (model.py:58, 278-279)
        self.provide_znear_zfar = kwargs.get("provide_znear_zfar", False)
        self.input_per_frame = kwargs.get("input_per_frame_test", 1)
        self.num_input_view = kwargs.get("num_input_view", 1)
        self.if_color_jitter = kwargs.get("color_jitter", False)
        self.big_view_variation = kwargs.get("big_view_variation", False)
        self.max_len = kwargs.get("max_len", -1)
        # render-from-estimated-meshes input mode (dataset.py:99-101):
        # target-view InTagHand vertex predictions replace the MANO
        # NeuralAnnot mesh/joints
        self.use_intag_preds = kwargs.get("use_intag_preds", False)
        self.annot_path = osp.join(data_root or ".",
                                   "InterHand2.6M/annotations")
        self.processed = osp.join(data_root or ".", "processed_dataset")

        # conditional left-shapedirs fix requires the pair (dataset.py:26-32)
        self.mano = load_mano_pair(osp.join(smplx_path, "mano"))
        # 21-joint regressor (reference ships it at smplx/models/mano/;
        # a vendored copy serves as fallback so use_intag_preds works
        # out of the box)
        jr_path = osp.join(smplx_path, "mano", "J_regressor_mano_ih26m.npy")
        if not osp.exists(jr_path):
            jr_path = osp.join(osp.dirname(__file__), "assets",
                               "J_regressor_mano_ih26m.npy")
        self.joint_regressor = (np.load(jr_path) if osp.exists(jr_path)
                                else None)

        self._loaded = False
        # sealed two-hand topology: 779 verts/hand, shared across frames
        _, fr = seal_verts_np(self.mano["right"].v_template,
                              self.mano["right"].faces, "right")
        _, fl = seal_verts_np(self.mano["left"].v_template,
                              self.mano["left"].faces, "left")
        self.faces = np.concatenate([fr, fl + 779], 0).astype(np.int32)
        self.num_v = 779

    def _lazy_load(self):
        if self._loaded:
            return
        with open(osp.join(self.annot_path, self.mode,
                           f"InterHand2.6M_{self.mode}_joint_3d.json")) as f:
            self.joints = json.load(f)
        with open(osp.join(
                self.annot_path, self.mode,
                f"InterHand2.6M_{self.mode}_MANO_NeuralAnnot.json")) as f:
            self.manos = json.load(f)
        cam_list_path = osp.join(self.processed, self.mode, "cam_list.pth")
        self.cam_list = _load_torch_pickle(cam_list_path)
        self._loaded = True

    def __len__(self):
        if self.max_len and self.max_len > 0:
            return self.max_len
        if self.split == "train":
            return 5423
        if self.split == "val":
            return 8
        return 1895 * self.input_per_frame

    # ---------------- MANO / geometry -------------------------------------

    def load_mano_two_hands(self, capture_id, frame_idx):
        """MANO forward for both hands -> sealed world mesh + joints +
        voxel coords (``dataset.py:251-361``)."""
        meshes, joints = [], []
        for hand in ("right", "left"):
            ann = self.manos[str(capture_id)][str(frame_idx)][hand]
            pose = np.asarray(ann["pose"], np.float32).reshape(-1)
            shape = np.asarray(ann["shape"], np.float32).reshape(-1)
            trans = np.asarray(ann["trans"], np.float32).reshape(-1)
            verts, _ = mano_forward_np(self.mano[hand], shape, pose, trans)
            verts = np.asarray(verts)
            if self.joint_regressor is not None:
                joints.append(self.joint_regressor @ verts)
            else:
                joints.append(verts[:21])
            sealed, _ = seal_verts_np(verts, self.mano[hand].faces, hand)
            meshes.append(sealed)
        mesh = np.concatenate(meshes, 0).astype(np.float32)   # (1558, 3)
        joint_world = np.concatenate(joints, 0).astype(np.float32)  # (42, 3)

        min_xyz = mesh.min(0) - 0.05
        max_xyz = mesh.max(0) + 0.05
        bounds = np.stack([min_xyz, max_xyz], 0)

        # voxel coords for the optional sparse-conv branch
        dhw = mesh[:, [2, 1, 0]]
        min_dhw = min_xyz[[2, 1, 0]]
        voxel = 0.005
        coord = np.round((dhw - min_dhw) / voxel).astype(np.int32)
        out_sh = np.ceil((max_xyz[[2, 1, 0]] - min_dhw) / voxel).astype(
            np.int32)
        out_sh = (out_sh | 31) + 1
        return joint_world, mesh, bounds, coord, out_sh

    def load_intag_preds(self, aid, anno):
        """InTagHand-predicted two-hand mesh -> sealed world mesh + joints
        (``dataset.py:429-430,485-496``).

        Loads ``verts_preds/<aid>.pkl`` — (1556, 3) camera-space vertices
        of the TARGET view, [0:778] right / [778:] left — regresses 21
        joints per hand via the vendored ``J_regressor_mano_ih26m`` and
        transforms both to world with the view's camrot/campos
        (``transforms.py:40-42``: world = R^-1 x + t).

        Deviation (documented): the reference's own intag branch crashes
        as written — ``targets['face_world']`` reads an undefined local
        ``face`` (``dataset.py:512``), and its 1556-vert unsealed mesh
        does not match the sealed 1558-vert topology the renderer's mesh
        queries assume.  Here the predicted hands are sealed with
        ``seal_verts_np`` so every downstream consumer sees the standard
        779-vert/hand topology and ``self.faces``.
        """
        if self.joint_regressor is None:
            raise FileNotFoundError(
                "use_intag_preds needs smplx/models/mano/"
                "J_regressor_mano_ih26m.npy")
        with open(osp.join(self.processed, self.mode, "verts_preds",
                           f"{int(aid)}.pkl"), "rb") as f:
            vert_cam_pred = pickle.load(f)
        vert_cam_pred = np.asarray(vert_cam_pred, np.float32)
        vert_cam_pred = vert_cam_pred.reshape(-1, 3)
        v_r, v_l = vert_cam_pred[:778], vert_cam_pred[778:]
        jr = np.asarray(self.joint_regressor, np.float32)
        joints_cam = np.concatenate([jr @ v_r, jr @ v_l], 0)

        camrot = np.asarray(anno["camera"]["camrot"],
                            np.float32).reshape(3, 3)
        campos = np.asarray(anno["camera"]["campos"],
                            np.float32).reshape(3, 1) / 1000.0

        def c2w(x):
            return (np.linalg.inv(camrot) @ x.T + campos).T

        joint_world = c2w(joints_cam).astype(np.float32)
        sr, _ = seal_verts_np(c2w(v_r).astype(np.float32),
                              self.mano["right"].faces, "right")
        sl, _ = seal_verts_np(c2w(v_l).astype(np.float32),
                              self.mano["left"].faces, "left")
        mesh = np.concatenate([sr, sl], 0).astype(np.float32)

        # bounds from the predicted mesh, z-padded (dataset.py:131-138)
        min_xyz, max_xyz = mesh.min(0).copy(), mesh.max(0).copy()
        min_xyz[2] -= 0.05
        max_xyz[2] += 0.05
        bounds = np.stack([min_xyz, max_xyz], 0)
        return joint_world, mesh, bounds

    def load_human_bounds(self, capture_id, frame_idx):
        """AABB of the unsealed both-hand mesh, z-padded
        (``dataset.py:140-196``)."""
        meshes = []
        for hand in ("right", "left"):
            try:
                ann = self.manos[str(capture_id)][str(frame_idx)][hand]
                pose = np.asarray(ann["pose"], np.float32).reshape(-1)
                shape = np.asarray(ann["shape"], np.float32).reshape(-1)
                trans = np.asarray(ann["trans"], np.float32).reshape(-1)
                verts, _ = mano_forward_np(self.mano[hand], shape, pose, trans)
                meshes.append(np.asarray(verts))
            except Exception:
                meshes.append(np.zeros((778, 3), np.float32))
        xyz = np.concatenate(meshes, 0)
        min_xyz = xyz.min(0)
        max_xyz = xyz.max(0)
        min_xyz[2] -= 0.05
        max_xyz[2] += 0.05
        return np.stack([min_xyz, max_xyz], 0)

    # ---------------- view sampling ---------------------------------------

    def select_views(self, all_input_view, capture_id, index_res,
                     rng: random.Random):
        """Train: random disjoint src/target; test: fixed pair tables."""
        if self.mode == "train":
            input_view = list(all_input_view)
            rng.shuffle(input_view)
            input_view = input_view[:self.num_input_view]
            tar_pool = list(set(map(tuple, all_input_view))
                            - set(map(tuple, input_view)))
            tar_pool.sort()
            rng.shuffle(tar_pool)
            tar_view = tar_pool[0]
            return [tuple(tar_view)] + [tuple(v) for v in input_view]
        if not self.big_view_variation:
            t01, t27 = _INPUT_LIST_01_SMALL, _INPUT_LIST_27_SMALL
        else:
            t01, t27 = _INPUT_LIST_01_BIG, _INPUT_LIST_27_BIG
        table = (t01 if ("0" in str(capture_id) or "1" in str(capture_id))
                 else t27)
        pair = table[str(index_res)]
        views = [tuple(all_input_view[i]) for i in pair]
        return views

    # ---------------- item assembly ---------------------------------------

    def __getitem__(self, index: int):
        try:
            return self._getitem(index)
        except Exception:
            return None                     # None-tolerant loader semantics

    def _getitem(self, index: int):
        self._lazy_load()
        index_res = 0
        if self.mode == "test":
            index_res = int(index % self.input_per_frame)
            index = int((index - index_res) / self.input_per_frame)

        with open(osp.join(self.processed, self.mode, "index",
                           f"{index}.pkl"), "rb") as f:
            data = pickle.load(f)
        frame_idx = data["frame"]
        capture_id = data["capture"]

        kpt3d = np.asarray(
            self.joints[str(capture_id)][str(frame_idx)]["world_coord"],
            np.float32) / 1000.0
        all_views = self.cam_list[frame_idx][capture_id]
        rng = random.Random(index * 9973 + 7
                            if self.mode == "train" else 7)
        views = self.select_views(all_views, capture_id, index_res, rng)

        # per-item jitter seed shared across views (dataset.py:374,457)
        jitter_seed = rng.randint(0, 9000000)
        imgs, masks, Ks, Rts, dps = [], [], [], [], []
        tar_anno = None
        for vi, (cam, _aid) in enumerate(views):
            with open(osp.join(
                    self.processed, self.mode, "annotation",
                    f"capture{capture_id}/cam{cam}/frame{frame_idx}.pkl"),
                    "rb") as f:
                anno = pickle.load(f)
            if vi == 0:
                tar_anno = anno
            in_T = np.asarray(anno["camera"]["t"]).reshape(3)
            in_R = np.asarray(anno["camera"]["R"]).reshape(3, 3)
            in_K = np.asarray(anno["camera"]["in_K"])[:3, :3].astype(
                np.float32)
            from PIL import Image
            base = osp.join(self.processed, self.mode)
            rel = f"capture{capture_id}/cam{cam}/frame{frame_idx}.jpg"
            img = np.asarray(Image.open(osp.join(base, "image", rel)))
            mask = np.asarray(Image.open(osp.join(base, "mask", rel)))
            mask = (mask >= 100).astype(np.uint8)
            if mask.ndim == 3:
                mask = mask[..., 0]
            if self.mode == "train" and self.if_color_jitter:
                img = color_jitter_ref(img, jitter_seed)
            img = img.astype(np.float32) / 255.0
            img[mask == 0] = 0
            if vi == 0:
                img, mask = erode_target_mask(img, mask,
                                              self.if_color_jitter)
            dp_path = osp.join(base, "densepose", rel)
            if osp.exists(dp_path):
                dp = np.asarray(Image.open(dp_path)).astype(np.float32) / 255.
                dp[mask == 0] = 0
            else:
                dp = np.zeros_like(img)
            imgs.append(img)
            masks.append(mask.astype(np.float32)[..., None])
            Ks.append(in_K)
            Rts.append(np.concatenate(
                [in_R, in_T.reshape(3, 1)], 1).astype(np.float32))
            dps.append(dp)

        H, W = imgs[0].shape[:2]
        if self.use_intag_preds:
            # estimated-mesh input mode: target-view InTagHand verts
            # replace MANO annot mesh/joints AND kpt3d (dataset.py:492)
            joint_world, mesh, bounds = self.load_intag_preds(
                views[0][1], tar_anno)
            kpt3d = joint_world
        else:
            joint_world, mesh, _bounds_v, _coord, _out_sh = \
                self.load_mano_two_hands(capture_id, frame_idx)
            bounds = self.load_human_bounds(capture_id, frame_idx)

        ray_o, ray_d = get_rays_np(H, W, Ks[0], Rts[0][:3, :3],
                                   Rts[0][:3, 3])
        near, far, mask_at_box = get_near_far_np(
            bounds, ray_o.reshape(-1, 3).astype(np.float32),
            ray_d.reshape(-1, 3).astype(np.float32))

        def k44(K):
            o = np.eye(4, dtype=np.float32)
            o[:3, :3] = K
            return o

        def rt44(Rt):
            o = np.eye(4, dtype=np.float32)
            o[:3, :4] = Rt
            return o

        src = slice(1, None)
        src_K4 = np.stack([k44(K) for K in Ks[src]])
        src_Rt4 = np.stack([rt44(Rt) for Rt in Rts[src]])
        return {
            "src_img": np.stack(imgs[src]).astype(np.float32),
            "src_mask": np.stack(masks[src]).astype(np.float32),
            "src_krt": src_K4 @ src_Rt4,
            "src_extrin": src_Rt4,
            "tar_img": imgs[0],
            "tar_mask": masks[0],
            "tar_k": k44(Ks[0]),
            "tar_rt": rt44(Rts[0]),
            "input_densepose": dps[1] if len(dps) > 1 else dps[0],
            "tar_densepose": dps[0],
            "verts": mesh,
            "kpt3d": (joint_world if self.joint_regressor is not None
                      else kpt3d),
            "bounds": bounds.astype(np.float32),
            "znear": np.float32(near.min()
                                if (self.provide_znear_zfar and len(near))
                                else 0.71),
            "zfar": np.float32(far.max()
                               if (self.provide_znear_zfar and len(far))
                               else 1.42),
            "mask_at_box": mask_at_box.reshape(H, W).astype(np.float32),
            "frame_index": frame_idx,
            "cam_ind": views[0][0],
            "human_idx": capture_id,
        }

    @classmethod
    def from_config(cls, dataset_cfg: dict, data_split: str, cfg: dict):
        """Reference factory semantics (``dataset.py:587-607``)."""
        assert data_split in ("train", "val", "test", "test_visualize")
        dc = copy.deepcopy(dataset_cfg)
        if f"{data_split}_cfg" in dc:
            dc.update(dc[f"{data_split}_cfg"])
        split = "test" if data_split == "test_visualize" else data_split
        return cls(split=split, **{k: v for k, v in dc.items()
                                   if k not in ("val_cfg", "test_cfg")})


def _load_torch_pickle(path):
    """Load a torch-saved pickle (cam_list.pth); a plain pickle also
    reads."""
    import torch
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except Exception:
        with open(path, "rb") as f:
            return pickle.load(f)
