"""Synthetic two-hand fixture (port of ``vanerf_tpu/data/synthetic.py``).

Two deformed ellipsoid "hands" with smooth procedural vertex colours,
rendered into ring cameras with the port's z-buffer rasterizer: images,
masks, denseposes and cameras in the batch schema the renderer consumes.
Deterministic per (frame, view); numpy throughout except the raster.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..device import resolve_device
from ..ops import rasterize as raster_ops


def _icosphere(subdiv=3):
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], dtype=np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
        dtype=np.int64)
    for _ in range(subdiv):
        mid = {}
        new_faces = []
        verts = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in mid:
                m = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2.0
                m /= np.linalg.norm(m)
                mid[key] = len(verts)
                verts.append(m)
            return mid[key]

        for (i, j, k) in faces:
            a, b, c = midpoint(i, j), midpoint(j, k), midpoint(k, i)
            new_faces += [[i, a, c], [j, b, a], [k, c, b], [a, b, c]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces, dtype=np.int64)
    return verts, faces.astype(np.int32)


@functools.lru_cache(maxsize=4)
def hand_template(subdiv: int = 3):
    """Unit 'hand': elongated ellipsoid with finger-ish bumps."""
    v, f = _icosphere(subdiv)
    v = v * np.array([1.6, 1.0, 0.55])
    bump = 0.15 * np.sin(4.0 * np.pi * v[:, 0:1]) * (v[:, 0:1] > 0.3)
    v = v + bump * np.array([[0.0, 1.0, 0.0]])
    return v.astype(np.float32), f


def two_hand_mesh(frame: int, subdiv: int = 3, scale: float = 0.09):
    """World-space interacting two-hand mesh of one frame: verts (2V, 3)
    float32, faces (2F, 3) int32, 42 synthetic keypoints."""
    v, f = hand_template(subdiv)
    rs = np.random.RandomState(1000 + frame)
    ang = 0.3 * rs.randn()

    def rot_z(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)

    vr = (v * scale) @ rot_z(ang).T + np.array([0.045, 0.01, 0.0], np.float32)
    vl = (v * np.array([-1, 1, 1], np.float32) * scale) @ rot_z(-ang).T \
        + np.array([-0.045, -0.01, 0.0], np.float32)
    verts = np.concatenate([vr, vl], 0).astype(np.float32)
    faces = np.concatenate([f, f + len(v)], 0).astype(np.int32)
    idx = np.linspace(0, len(v) - 1, 21).astype(np.int32)
    kpt3d = np.concatenate([vr[idx], vl[idx]], 0).astype(np.float32)
    return verts, faces, kpt3d


def ring_camera(view: int, n_views: int = 8, radius: float = 0.9,
                H: int = 256, W: int = 256, focal: float = 600.0):
    """Camera #view on a ring looking at the origin: K (3,3), Rt (3,4)."""
    a = 2.0 * np.pi * view / n_views
    eye = np.array([radius * np.sin(a), 0.25 * np.sin(2 * a),
                    radius * np.cos(a)], np.float32)
    fwd = -eye / np.linalg.norm(eye)
    up = np.array([0.0, 1.0, 0.0], np.float32)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R = np.stack([right, up2, fwd], 0).astype(np.float32)
    t = (-R @ eye).astype(np.float32)
    K = np.array([[focal * W / 256.0, 0, W / 2],
                  [0, focal * H / 256.0, H / 2],
                  [0, 0, 1]], np.float32)
    return K, np.concatenate([R, t[:, None]], 1)


def _vertex_colors(verts: np.ndarray) -> np.ndarray:
    v = verts / (np.abs(verts).max() + 1e-6)
    r = 0.5 + 0.45 * np.sin(3.0 * v[:, 0] + 1.0)
    g = 0.5 + 0.45 * np.sin(4.0 * v[:, 1] + 2.0)
    b = 0.5 + 0.45 * np.sin(5.0 * v[:, 2] + 3.0)
    return np.stack([r, g, b], -1).astype(np.float32) * 0.8 + 0.1


def render_view(verts, faces, K, Rt, H, W, device=None):
    """Render (img, mask, densepose) with the port's rasterizer on
    ``device`` (default: the card, which runs kernel C)."""
    device = resolve_device(device)
    cam = verts @ Rt[:3, :3].T + Rt[:3, 3]
    z = cam[:, 2]
    xy = np.stack([cam[:, 0] / z * K[0, 0] + K[0, 2],
                   cam[:, 1] / z * K[1, 1] + K[1, 2]], -1)
    face, bary, _ = raster_ops.rasterize_zbuffer(
        torch.as_tensor(xy, dtype=torch.float32, device=device),
        torch.as_tensor(z, dtype=torch.float32, device=device),
        torch.as_tensor(faces, device=device), H, W)
    face = face.cpu().numpy()
    bary = bary.cpu().numpy()
    colors = _vertex_colors(verts)
    tric = colors[faces]
    safe = np.maximum(face, 0)
    img = (tric[safe] * bary[..., None]).sum(1)
    mask = (face >= 0).astype(np.float32)
    img = img * mask[:, None]
    vmin, vmax = verts.min(0), verts.max(0)
    dp_col = (verts - vmin) / (vmax - vmin + 1e-6)
    trid = dp_col[faces]
    dp = (trid[safe] * bary[..., None]).sum(1) * mask[:, None]
    return (img.reshape(H, W, 3).astype(np.float32),
            mask.reshape(H, W, 1).astype(np.float32),
            dp.reshape(H, W, 3).astype(np.float32))


class SyntheticDataset:
    """Fixture dataset: each item is one target view + ``num_input_view``
    source views of one frame."""

    def __init__(self, n_frames: int = 2, n_cams: int = 8,
                 num_input_view: int = 1, H: int = 256, W: int = 256,
                 subdiv: int = 3, split: str = "train", device=None):
        self.n_frames = n_frames
        self.n_cams = n_cams
        self.num_input_view = num_input_view
        self.H, self.W = H, W
        self.subdiv = subdiv
        self.split = split
        self.device = resolve_device(device)
        _, faces, _ = two_hand_mesh(0, subdiv)
        self.faces = faces
        self.num_v = len(hand_template(subdiv)[0])
        self._cache = {}

    def __len__(self):
        return self.n_frames * self.n_cams

    def _render_cached(self, frame, view):
        key = (frame, view)
        if key not in self._cache:
            verts, faces, _ = two_hand_mesh(frame, self.subdiv)
            K, Rt = ring_camera(view, self.n_cams, H=self.H, W=self.W)
            self._cache[key] = render_view(verts, faces, K, Rt, self.H,
                                           self.W, self.device) + (K, Rt)
        return self._cache[key]

    def __getitem__(self, index: int):
        frame = index // self.n_cams
        tar_view = index % self.n_cams
        rs = np.random.RandomState(index if self.split == "train" else 7)
        src_views = [(tar_view + 1 + rs.randint(self.n_cams - 1))
                     % self.n_cams for _ in range(self.num_input_view)]

        verts, faces, kpt3d = two_hand_mesh(frame, self.subdiv)
        tar_img, tar_mask, tar_dp = self._render_cached(frame, tar_view)[:3]
        K_t, Rt_t = self._render_cached(frame, tar_view)[3:]

        src_imgs, src_masks, src_dps, src_K, src_Rt = [], [], [], [], []
        for sv in src_views:
            i, m, d, K, Rt = self._render_cached(frame, sv)
            src_imgs.append(i)
            src_masks.append(m)
            src_dps.append(d)
            src_K.append(K)
            src_Rt.append(Rt)

        bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05], 0)

        def k44(K):
            out = np.eye(4, dtype=np.float32)
            out[:3, :3] = K
            return out

        def rt44(Rt):
            out = np.eye(4, dtype=np.float32)
            out[:3, :4] = Rt
            return out

        src_K4 = np.stack([k44(K) for K in src_K])
        src_Rt4 = np.stack([rt44(Rt) for Rt in src_Rt])
        return {
            "src_img": np.stack(src_imgs),
            "src_mask": np.stack(src_masks),
            "src_krt": src_K4 @ src_Rt4,
            "src_extrin": src_Rt4,
            "tar_img": tar_img,
            "tar_mask": tar_mask,
            "tar_k": k44(K_t),
            "tar_rt": rt44(Rt_t),
            "input_densepose": src_dps[0],
            "tar_densepose": tar_dp,
            "verts": verts,
            "kpt3d": kpt3d,
            "bounds": bounds.astype(np.float32),
            "znear": np.float32(0.5),
            "zfar": np.float32(1.4),
            "frame_index": frame,
            "cam_ind": tar_view,
            "human_idx": 0,
        }


def make_synthetic_batch(batch_size: int = 1, H: int = 64, W: int = 64,
                         subdiv: int = 2, num_input_view: int = 1,
                         split: str = "train", device=None):
    """Collated batch (numpy, channels-last); source-view tensors are
    flattened to (B*V, ...).  ``device`` is where the fixture is
    rasterized: the card unless the caller asks for ``"cpu"``.  Returns
    (batch dict, faces, num_v)."""
    ds = SyntheticDataset(n_frames=max(batch_size, 1), n_cams=6,
                          num_input_view=num_input_view, H=H, W=W,
                          subdiv=subdiv, split=split, device=device)
    items = [ds[i * ds.n_cams] for i in range(batch_size)]
    batch = {}
    for k in items[0]:
        if k in ("frame_index", "cam_ind", "human_idx"):
            continue
        batch[k] = np.stack([it[k] for it in items])
    for k in ("src_img", "src_mask", "src_krt", "src_extrin"):
        v = batch[k]
        batch[k] = v.reshape((-1,) + v.shape[2:])
    batch["faces"] = ds.faces
    batch["znear"] = np.float32(0.5)
    batch["zfar"] = np.float32(1.4)
    return batch, ds.faces, ds.num_v


def to_torch(batch: dict, device) -> dict:
    """numpy batch -> torch tensors on ``device`` (faces int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v), device=device)
        out[k] = t.long() if k == "faces" else t
    return out
