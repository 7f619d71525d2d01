"""Offline InterHand2.6M preprocessor: the counterpart of
``data_process/dataset_process.py``, writing the ``processed_dataset``
tree that :class:`~vanerf_tpu_torch.data.interhand.InterHandDataset`
reads.

Usage (the JAX preprocessor's flags, plus ``--device``):
  python -m vanerf_tpu_torch.dataset_process --data_root <ih26m_root> \\
      --out ./processed_dataset --split train [--smplx_path smplx/models] \\
      [--max_frames N] [--device cpu]

For every interacting annotation with MANO fits of both hands and a camera
with positive focal lengths: MANO forward, seal and concat of both hands
(``mano/layer.py``, the synthetic pair when the pickles are missing), the
silhouette mask and the densepose render in the source view
(:func:`render_view`: the z-buffer rasterizer, kernel C on the card and its
plain version on the CPU, and the barycentric colour interpolation on the
same device), the bbox of the silhouette grown to a square, the crop to
256^2 and the intrinsics rewritten for it.  It writes
``{split}/{image,mask,densepose}/capture*/cam*/frame*.jpg`` (JPEG quality
95), ``{split}/annotation/capture*/cam*/frame*.pkl``, ``{split}/index/
<i>.pkl`` over the frames seen by at least four cameras and
``{split}/cam_list.pth`` as a plain pickle: the JAX preprocessor's files,
byte for byte on the same input.

The raw read, the crop and the JPEG writes use PIL, as the JAX
preprocessor does; it is imported where they run.  Runs on the card unless
``--device cpu`` is given; there is no fallback.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle

import numpy as np
import torch

from .data.densepose import densepose_colors
from .data.synthetic import _vertex_colors
from .device import resolve_device
from .mano import load_mano_pair, mano_forward_np, seal_verts_np
from .ops.rasterize import rasterize_zbuffer

IMG_SIZE = 256


def process_bbox(bbox, img_w, img_h, ratio=1.25):
    """A bbox (x, y, w, h) grown to a square of ``ratio`` times its longer
    side about its centre, float32 (``dataset_process.py:44-49``)."""
    x, y, w, h = bbox
    cx, cy = x + w / 2, y + h / 2
    size = max(w, h) * ratio
    return np.array([cx - size / 2, cy - size / 2, size, size], np.float32)


def crop_affine(img: np.ndarray, bbox, out_size=IMG_SIZE, nearest=False):
    """The bbox's square resampled to ``out_size``^2 by PIL's affine
    transform (``dataset_process.py:52-60``)."""
    from PIL import Image
    x, y, s, _ = bbox
    pil = Image.fromarray(img)
    box = (float(x), float(y), float(x + s), float(y + s))
    res = pil.transform(
        (out_size, out_size), Image.EXTENT, box,
        Image.NEAREST if nearest else Image.BILINEAR)
    return np.asarray(res)


def adjust_K(K, bbox, out_size=IMG_SIZE):
    """The intrinsics after the crop and resize (``dataset_process.py:
    63-72``)."""
    x, y, s, _ = bbox
    scale = out_size / s
    K2 = K.copy()
    K2[0, 0] *= scale
    K2[1, 1] *= scale
    K2[0, 2] = (K2[0, 2] - x) * scale
    K2[1, 2] = (K2[1, 2] - y) * scale
    return K2


def vertex_colors(verts: np.ndarray) -> np.ndarray:
    """The densepose table for 779 / 1,558 vertices (a sealed MANO hand or
    two), else the synthetic fixture's procedural colours
    (``dataset_process.py:95-99``)."""
    if len(verts) in (779, 1558):
        return densepose_colors(len(verts))
    return _vertex_colors(verts)


def project(verts, K, R, t):
    """(xy (V, 2), z (V,)) float32 pixel coordinates and depths of world
    vertices, in the JAX preprocessor's float32 numpy order
    (``dataset_process.py:80-83``)."""
    cam = verts @ R.T + t
    z = cam[:, 2]
    xy = np.stack([cam[:, 0] / z * K[0, 0] + K[0, 2],
                   cam[:, 1] / z * K[1, 1] + K[1, 2]], -1)
    return xy.astype(np.float32), z.astype(np.float32)


def render_mask_densepose(verts, faces, K, R, t, H, W, device):
    """Silhouette mask (H, W) and densepose render (H, W, 3), uint8
    tensors on ``device``: the z-buffer rasterizer there (kernel C on the
    card), then each pixel's colour interpolated on its face, summed over
    the three corners in order, times 255 and truncated, as the JAX
    preprocessor's numpy does (``dataset_process.py:75-104``)."""
    xy, z = project(verts, K, R, t)
    fc = torch.from_numpy(np.ascontiguousarray(faces)).to(device)
    face, bary, _ = rasterize_zbuffer(torch.from_numpy(xy).to(device),
                                      torch.from_numpy(z).to(device), fc,
                                      H, W)
    hit = face >= 0
    mask = hit.to(torch.uint8) * 255
    colors = torch.from_numpy(vertex_colors(verts)).to(device)
    tric = colors[fc.long()][face.clamp(min=0).long()]     # (HW, 3, 3)
    dp = (tric[:, 0] * bary[:, 0:1] + tric[:, 1] * bary[:, 1:2]
          + tric[:, 2] * bary[:, 2:3])
    dp = (dp * hit[:, None].float() * 255).to(torch.uint8)
    return mask.reshape(H, W), dp.reshape(H, W, 3)


def render_view(img: np.ndarray, verts, faces, K, R, t, device):
    """The device work of one view: mask and densepose at the decoded
    image's size, the bbox of the silhouette grown to a square
    (:func:`process_bbox`) and the intrinsics of the 256^2 crop
    (:func:`adjust_K`).  Returns None where the mesh covers no pixel, else
    dict(mask (H, W) uint8, densepose (H, W, 3) uint8, numpy; bbox, K_c
    float32)."""
    H, W = img.shape[:2]
    mask, dp = render_mask_densepose(verts, faces, K, R, t, H, W, device)
    mask = mask.cpu().numpy()
    if mask.max() == 0:
        return None
    ys, xs = np.where(mask > 0)
    bbox = process_bbox(
        (xs.min(), ys.min(), xs.max() - xs.min(), ys.max() - ys.min()), W, H)
    return {"mask": mask, "densepose": dp.cpu().numpy(), "bbox": bbox,
            "K_c": adjust_K(K, bbox)}


def two_hand_mesh(mano: dict, mano_frame: dict):
    """Both hands' sealed MANO meshes concatenated (right, then left):
    (1,558, 3) vertices in metres and int32 faces
    (``dataset_process.py:169-182``)."""
    meshes, faces_all, off = [], [], 0
    for hand in ("right", "left"):
        a = mano_frame[hand]
        verts, _ = mano_forward_np(
            mano[hand], np.asarray(a["shape"], np.float32).reshape(-1),
            np.asarray(a["pose"], np.float32).reshape(-1),
            np.asarray(a["trans"], np.float32).reshape(-1))
        v, f = seal_verts_np(np.asarray(verts), mano[hand].faces, hand)
        meshes.append(v)
        faces_all.append(f + off)
        off += len(v)
    return (np.concatenate(meshes, 0),
            np.concatenate(faces_all, 0).astype(np.int32))


def main(argv=None):
    from PIL import Image
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", required=True)
    ap.add_argument("--out", default="./processed_dataset")
    ap.add_argument("--split", default="train",
                    choices=["train", "val", "test"])
    ap.add_argument("--smplx_path", default="smplx/models")
    ap.add_argument("--max_frames", type=int, default=-1)
    ap.add_argument("--device", default="cuda",
                    help="where the rasterizer runs (cuda or cpu)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    annot = osp.join(args.data_root, "InterHand2.6M", "annotations",
                     args.split)
    img_root = osp.join(args.data_root, "InterHand2.6M", "images",
                        args.split)
    with open(osp.join(annot, f"InterHand2.6M_{args.split}_data.json")) as f:
        coco = json.load(f)
    with open(osp.join(annot,
                       f"InterHand2.6M_{args.split}_camera.json")) as f:
        cameras = json.load(f)
    with open(osp.join(
            annot, f"InterHand2.6M_{args.split}_MANO_NeuralAnnot.json")) as f:
        manos = json.load(f)

    # the conditional left-shapedirs fix needs the pair (dataset.py:26-32)
    mano = load_mano_pair(osp.join(args.smplx_path, "mano"))

    out_base = osp.join(args.out, args.split)
    for sub in ("image", "mask", "densepose", "annotation", "index"):
        os.makedirs(osp.join(out_base, sub), exist_ok=True)

    imgs_by_id = {im["id"]: im for im in coco["images"]}
    cam_list = {}
    index_i = 0
    done = 0
    for ann in coco["annotations"]:
        im = imgs_by_id[ann["image_id"]]
        capture_id = str(im["capture"])
        frame_idx = str(im["frame_idx"])
        cam = str(im["camera"])
        # interacting frames with MANO fits of both hands only
        if ann.get("hand_type") != "interacting":
            continue
        mano_frame = manos.get(capture_id, {}).get(frame_idx, {})
        if mano_frame.get("right") is None or mano_frame.get("left") is None:
            continue

        campos = np.asarray(cameras[capture_id]["campos"][cam],
                            np.float32) / 1000.0
        camrot = np.asarray(cameras[capture_id]["camrot"][cam], np.float32)
        focal = np.asarray(cameras[capture_id]["focal"][cam], np.float32)
        princpt = np.asarray(cameras[capture_id]["princpt"][cam],
                             np.float32)
        # greyscale cameras have no positive focal lengths
        if focal.min() <= 0:
            continue
        R = camrot
        t = -R @ campos
        verts, faces = two_hand_mesh(mano, mano_frame)

        img_path = osp.join(img_root, im["file_name"])
        if not osp.exists(img_path):
            continue
        img = np.asarray(Image.open(img_path).convert("RGB"))
        H, W = img.shape[:2]
        K = np.array([[focal[0], 0, princpt[0]], [0, focal[1], princpt[1]],
                      [0, 0, 1]], np.float32)
        view = render_view(img, verts, faces, K, R, t, device)
        if view is None:
            continue
        bbox = view["bbox"]

        rel_dir = f"capture{capture_id}/cam{cam}"
        for sub, arr in (("image", crop_affine(img, bbox)),
                         ("mask", crop_affine(view["mask"], bbox,
                                              nearest=True)),
                         ("densepose", crop_affine(view["densepose"], bbox))):
            d = osp.join(out_base, sub, rel_dir)
            os.makedirs(d, exist_ok=True)
            Image.fromarray(arr).save(osp.join(d, f"frame{frame_idx}.jpg"),
                                      quality=95)
        ad = osp.join(out_base, "annotation", rel_dir)
        os.makedirs(ad, exist_ok=True)
        with open(osp.join(ad, f"frame{frame_idx}.pkl"), "wb") as f:
            pickle.dump({
                "camera": {"R": R, "t": t * 1.0, "in_K": view["K_c"],
                           "campos": campos, "camrot": camrot},
                "image_info": {"orig_size": (H, W), "bbox": bbox},
            }, f)

        fi = int(frame_idx)
        cam_list.setdefault(fi, {}).setdefault(int(capture_id), []).append(
            (cam, ann["image_id"]))
        done += 1
        if args.max_frames > 0 and done >= args.max_frames:
            break

    # the index over frames seen by at least four cameras
    # (dataset_process.py:228-238)
    for fi, caps in sorted(cam_list.items()):
        for cap, cams in sorted(caps.items()):
            if len(cams) >= 4:
                with open(osp.join(out_base, "index", f"{index_i}.pkl"),
                          "wb") as f:
                    pickle.dump({"idx": index_i, "frame": fi,
                                 "capture": cap, "cam": cams[0][0]}, f)
                index_i += 1
    with open(osp.join(out_base, "cam_list.pth"), "wb") as f:
        pickle.dump(cam_list, f)
    print(f"processed {done} views, {index_i} indexed frames -> {out_base}")


if __name__ == "__main__":
    main()
