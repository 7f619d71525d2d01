"""MANO-sized two-hand requests made from a seed, and the plain z-buffer
rasterizer that draws their images.

Each hand has MANO's published sizes: 778 vertices and 1,538 faces, a
16-vertex wrist opening sealed by one centre vertex and 16 faces, as the
InterHand2.6M loader seals it (reference ``dataset.py:35-52``), so a pair
has 1,558 vertices and 3,108 faces.  The template is a closed tube (the
palm and fingers as one limb) whose only opening is the wrist ring, so each
sealed hand is watertight and consistently oriented: a point's winding
number, and so the sign of its distance, does not depend on the direction
a query casts its ray in.  The skinning follows MANO's structure (16
joints: a root and five chains of three; shape and pose blend shapes;
linear blend skinning) with smooth weights.

A request is one frame: a posed pair, its 42 keypoints, its padded bounds,
one or more source views and one target view on a ring of cameras around
the pair (``vanerf_tpu_torch/data/synthetic.py``'s placement), and the
source images and masks rendered here.  A training sample adds the target
image and mask and the densepose images.  Every draw comes from one
``numpy.random.Generator`` seeded by ``--seed``; the images are rendered by
:func:`rasterize`, never by the program, so a change to the program cannot
change its inputs.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

N_VERTS = 778
N_FACES = 1538
N_JOINTS = 16
RING = 16                    # vertices of the wrist opening
N_RINGS = 48                 # rings of RING vertices along the limb
TIP_RING = 9                 # the inner ring of the fingertip cap
PARENTS = np.array([0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14])
LENGTH = 0.18                # wrist to fingertip, metres
ZNEAR, ZFAR = 0.5, 1.4
RING_VIEWS = 16              # cameras on the ring
RADIUS = 0.9
FOCAL = 880.0                # at 256 px: the pair fills the frame


def _strip(a: list, b: list) -> list:
    """Triangles joining ring ``a`` to the next ring ``b`` (both closed,
    counter-clockwise about +z), outward facing, by a merge walk over
    their angles."""
    na, nb = len(a), len(b)
    out, i, j = [], 0, 0
    while i < na or j < nb:
        # advance the ring whose next vertex comes first in angle
        if j >= nb or (i < na and (i + 1) / na <= (j + 1) / nb):
            out.append([a[i % na], a[(i + 1) % na], b[j % nb]])
            i += 1
        else:
            out.append([a[i % na], b[(j + 1) % nb], b[j % nb]])
            j += 1
    return out


@functools.lru_cache(maxsize=1)
def hand_template():
    """The right hand at rest: vertices (778, 3) float64, faces
    (1538, 3) int64 and its wrist ring (16,) ordered so that
    :func:`seal` closes it facing outward.  The limb runs along +z from the
    wrist at z = 0; x is the palm's width, y its thickness."""
    verts, rings = [], []
    for k in range(N_RINGS):
        t = k / (N_RINGS - 1)
        z = 0.97 * LENGTH * t
        # palm (wide, flat) into fingers (narrower), then the taper
        half_w = 0.030 + 0.012 * math.sin(math.pi * min(t / 0.6, 1.0)) \
            - 0.014 * max(t - 0.6, 0.0) / 0.4
        half_t = 0.013 + 0.004 * math.sin(math.pi * min(t / 0.6, 1.0)) \
            - 0.005 * max(t - 0.6, 0.0) / 0.4
        ring = []
        for j in range(RING):
            a = 2.0 * math.pi * j / RING
            ring.append(len(verts))
            verts.append([half_w * math.cos(a), half_t * math.sin(a), z])
        rings.append(ring)
    tip = []
    for j in range(TIP_RING):
        a = 2.0 * math.pi * j / TIP_RING
        tip.append(len(verts))
        verts.append([0.008 * math.cos(a), 0.004 * math.sin(a),
                      0.99 * LENGTH])
    pole = len(verts)
    verts.append([0.0, 0.0, LENGTH])
    faces = []
    for k in range(N_RINGS - 1):
        faces += _strip(rings[k], rings[k + 1])
    faces += _strip(rings[-1], tip)
    faces += [[tip[j], tip[(j + 1) % TIP_RING], pole]
              for j in range(TIP_RING)]
    v, f = np.asarray(verts), np.asarray(faces, np.int64)
    assert v.shape == (N_VERTS, 3) and f.shape == (N_FACES, 3)
    return v, f, np.asarray(rings[0][::-1], np.int64)


def seal(verts: np.ndarray, faces: np.ndarray, ring: np.ndarray):
    """Append the wrist centre and the 16 faces that close the opening
    (``vanerf_tpu_torch/mano/layer.py::seal_verts_np``)."""
    centre = verts[ring].mean(0, keepdims=True)
    out_v = np.concatenate([verts, centre], 0)
    cid = len(out_v) - 1
    new = [[ring[i - 1], ring[i], cid] for i in range(len(ring))]
    return out_v, np.concatenate([faces, np.asarray(new, np.int64)], 0)


@functools.lru_cache(maxsize=1)
def skinning():
    """Joint rest positions (16, 3), the joint regressor (16, 778), the
    skinning weights (778, 16), shape (778, 3, 10) and pose (778, 3, 135)
    blend shapes: fixed, smooth, MANO's layout."""
    v, _, _ = hand_template()
    rest = [[0.0, 0.0, 0.02]]
    for x in (-0.024, -0.012, 0.0, 0.012, 0.024):      # five chains
        rest += [[x, 0.0, 0.10], [x, 0.0, 0.13], [x, 0.0, 0.155]]
    rest = np.asarray(rest)
    d2 = ((v[:, None] - rest[None]) ** 2).sum(-1)          # (778, 16)
    reg = np.exp(-d2 / (2 * 0.012 ** 2))
    reg = (reg / reg.sum(0, keepdims=True)).T               # (16, 778)
    w = np.exp(-d2 / (2 * 0.02 ** 2)) + 1e-6
    w = w / w.sum(1, keepdims=True)
    rs = np.random.RandomState(42)
    shapedirs = v[:, :, None] * rs.randn(1, 3, 10) * 0.03
    posedirs = rs.randn(N_VERTS, 3, 135) * 1e-5
    return rest, reg, w, shapedirs, posedirs


def rodrigues(r: np.ndarray) -> np.ndarray:
    """Axis-angle (..., 3) -> rotations (..., 3, 3)."""
    theta = np.maximum(np.linalg.norm(r, axis=-1, keepdims=True), 1e-8)
    k = r / theta
    K = np.zeros(r.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -k[..., 2], k[..., 1]
    K[..., 1, 0], K[..., 1, 2] = k[..., 2], -k[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -k[..., 1], k[..., 0]
    t = theta[..., None]
    return np.eye(3) + np.sin(t) * K + (1 - np.cos(t)) * (K @ K)


def mano_forward(betas: np.ndarray, pose: np.ndarray, trans: np.ndarray,
                 right: bool):
    """Shape blend + pose blend + linear blend skinning of one hand
    (``mano/layer.py::mano_forward_np``).  pose (16, 3) axis-angle with
    the root first.  Returns the sealed hand (779, 3), its faces
    (1554, 3) and 21 keypoints (16 joints + 5 fingertip vertices)."""
    v_t, faces, ring = hand_template()
    _, reg, w, shapedirs, posedirs = skinning()
    v_shaped = v_t + shapedirs @ betas
    joints = reg @ v_shaped
    rots = rodrigues(pose)
    v_posed = v_shaped + posedirs @ (rots[1:] - np.eye(3)).reshape(-1)
    r_glob = np.empty((N_JOINTS, 3, 3))
    j_posed = np.empty((N_JOINTS, 3))
    r_glob[0], j_posed[0] = rots[0], joints[0]
    for j in range(1, N_JOINTS):
        p = PARENTS[j]
        r_glob[j] = r_glob[p] @ rots[j]
        j_posed[j] = j_posed[p] + r_glob[p] @ (joints[j] - joints[p])
    t_glob = j_posed - np.einsum("jab,jb->ja", r_glob, joints)
    verts = (np.einsum("vab,vb->va", np.einsum("vj,jab->vab", w, r_glob),
                       v_posed) + w @ t_glob)
    tips = verts[[N_VERTS - 1, N_VERTS - 2, N_VERTS - 4, N_VERTS - 6,
                  N_VERTS - 8]]
    kpt = np.concatenate([j_posed, tips], 0)
    if not right:                     # the mirror image, faces re-oriented
        verts = verts * np.array([-1.0, 1.0, 1.0])
        kpt = kpt * np.array([-1.0, 1.0, 1.0])
        faces = faces[:, ::-1]
        ring = ring[::-1]
    sv, sf = seal(verts, faces, ring)
    return sv + trans, sf, kpt + trans


def two_hands(rng: np.random.Generator):
    """A posed interacting pair: verts (1558, 3) float32, faces
    (3108, 3) int64, kpt3d (42, 3) float32, bounds (2, 3) float32 (the
    sealed mesh's box padded by 5 cm, as the InterHand loader pads it)."""
    out_v, out_f, out_k = [], [], []
    for h, right in enumerate((True, False)):
        betas = rng.normal(0.0, 1.0, 10)
        pose = np.concatenate([
            rng.normal(0.0, 1.0, (1, 3)) * np.array([[0.6, 0.6, 1.2]]),
            rng.normal(0.0, 0.12, (15, 3)) + np.array([[0.18, 0.0, 0.0]])])
        side = 1.0 if right else -1.0
        trans = np.array([0.035 * side, 0.0, -0.06]) \
            + rng.normal(0.0, 0.01, 3)
        v, f, k = mano_forward(betas, pose, trans, right)
        out_v.append(v)
        out_f.append(f + h * (N_VERTS + 1))
        out_k.append(k)
    verts = np.concatenate(out_v, 0)
    centre = 0.5 * (verts.min(0) + verts.max(0))
    verts = verts - centre
    kpt = np.concatenate(out_k, 0) - centre
    bounds = np.stack([verts.min(0) - 0.05, verts.max(0) + 0.05])
    return (verts.astype(np.float32), np.concatenate(out_f, 0),
            kpt.astype(np.float32), bounds.astype(np.float32))


def ring_camera(view: int, H: int, W: int):
    """Camera ``view`` of :data:`RING_VIEWS` on a ring looking at the
    origin (``data/synthetic.py::ring_camera``): K (4, 4), Rt (4, 4)."""
    a = 2.0 * np.pi * view / RING_VIEWS
    eye = np.array([RADIUS * np.sin(a), 0.25 * np.sin(2 * a),
                    RADIUS * np.cos(a)])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(np.array([0.0, 1.0, 0.0]), fwd)
    right /= np.linalg.norm(right)
    R = np.stack([right, np.cross(fwd, right), fwd], 0)
    K = np.eye(4)
    K[0, 0], K[1, 1] = FOCAL * W / 256.0, FOCAL * H / 256.0
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    Rt = np.eye(4)
    Rt[:3, :3], Rt[:3, 3] = R, -R @ eye
    return K.astype(np.float32), Rt.astype(np.float32)


def rasterize(verts: torch.Tensor, faces: torch.Tensor, K: torch.Tensor,
              Rt: torch.Tensor, H: int, W: int, chunk: int = 4096):
    """Plain z-buffer: the nearest face at each pixel centre (x, y) and its
    barycentrics.  verts (V, 3) world, faces (F, 3), K / Rt (4, 4) on one
    device.  Returns face (H W,) int64, -1 on the background, and bary
    (H W, 3)."""
    cam = verts @ Rt[:3, :3].T + Rt[:3, 3]
    z = cam[:, 2]
    xy = torch.stack([cam[:, 0] / z * K[0, 0] + K[0, 2],
                      cam[:, 1] / z * K[1, 1] + K[1, 2]], -1)
    a, b, c = (xy[faces[:, i]] for i in range(3))
    za, zb, zc = (z[faces[:, i]] for i in range(3))
    area = (b[:, 0] - a[:, 0]) * (c[:, 1] - a[:, 1]) \
        - (b[:, 1] - a[:, 1]) * (c[:, 0] - a[:, 0])
    ok = area.abs() > 1e-9
    area = torch.where(ok, area, torch.ones_like(area))
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    pix = torch.arange(H * W, device=verts.device)
    face_out, bary_out = [], []
    for p in torch.split(pix, chunk):
        px = (p % W).to(xy.dtype)[:, None]
        py = (p // W).to(xy.dtype)[:, None]
        l0 = ((c[:, 0] - b[:, 0]) * (py - b[:, 1])
              - (c[:, 1] - b[:, 1]) * (px - b[:, 0])) / area
        l1 = ((a[:, 0] - c[:, 0]) * (py - c[:, 1])
              - (a[:, 1] - c[:, 1]) * (px - c[:, 0])) / area
        l2 = 1.0 - l0 - l1
        inside = (ok & (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
                  & (px >= lo[:, 0]) & (px <= hi[:, 0])
                  & (py >= lo[:, 1]) & (py <= hi[:, 1]))
        depth = torch.where(inside, l0 * za + l1 * zb + l2 * zc,
                            torch.full_like(l0, float("inf")))
        zmin, f = depth.min(-1)
        hit = torch.isfinite(zmin)
        bary = torch.stack([l0.gather(1, f[:, None])[:, 0],
                            l1.gather(1, f[:, None])[:, 0],
                            l2.gather(1, f[:, None])[:, 0]], -1)
        face_out.append(torch.where(hit, f, -1))
        bary_out.append(torch.where(hit[:, None], bary,
                                    torch.zeros_like(bary)))
    return torch.cat(face_out), torch.cat(bary_out)


def shade(face: torch.Tensor, bary: torch.Tensor, faces: torch.Tensor,
          colors: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Per-vertex colours (V, C) interpolated over the raster: (H, W, C),
    zero on the background."""
    tri = colors[faces[face.clamp(min=0)]]                  # (HW, 3, C)
    img = (tri * bary[..., None]).sum(1)
    return (img * (face >= 0)[:, None]).reshape(H, W, -1)


def vertex_colors(verts: np.ndarray, tone: np.ndarray) -> np.ndarray:
    """Smooth procedural albedo (``data/synthetic.py::_vertex_colors``)
    tinted by a skin tone."""
    v = verts / (np.abs(verts).max() + 1e-6)
    pat = np.stack([0.5 + 0.45 * np.sin(3.0 * v[:, 0] + 1.0),
                    0.5 + 0.45 * np.sin(4.0 * v[:, 1] + 2.0),
                    0.5 + 0.45 * np.sin(5.0 * v[:, 2] + 3.0)], -1)
    return (0.25 * pat + 0.75 * tone[None]).clip(0.02, 0.98)


def make_request(rng: np.random.Generator, n_views: int, H: int, W: int,
                 device, targets: bool = False) -> dict:
    """One frame of the batch schema ``render_full_image`` and the train
    step read (channels-last, the Bf = 1 frame's V source views in a
    row), as numpy arrays.  ``targets`` adds 'tar_img', 'tar_mask',
    'input_densepose' and 'tar_densepose'.  The images are rendered on
    ``device``."""
    verts, faces, kpt3d, bounds = two_hands(rng)
    views = rng.permutation(RING_VIEWS)[:n_views + 1]
    tone = rng.uniform([0.55, 0.35, 0.25], [0.95, 0.75, 0.6])
    col = vertex_colors(verts, tone)
    vmin, vmax = verts.min(0), verts.max(0)
    dp = (verts - vmin) / (vmax - vmin + 1e-6)
    tv = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,
                                                     device=device)
    v_t, f_t = tv(verts), tv(faces, torch.int64)
    col_t = tv(np.concatenate([col, dp, np.ones_like(dp[:, :1])], 1))

    def draw(view):
        K, Rt = ring_camera(int(view), H, W)
        face, bary = rasterize(v_t, f_t, tv(K), tv(Rt), H, W)
        img = shade(face, bary, f_t, col_t, H, W).cpu().numpy()
        return img, K, Rt

    src = [draw(v) for v in views[1:]]
    K_t, Rt_t = ring_camera(int(views[0]), H, W)
    req = {
        "src_img": np.stack([s[0][..., :3] for s in src]),
        "src_mask": np.stack([s[0][..., 6:7] for s in src]),
        "src_krt": np.stack([s[1] @ s[2] for s in src]),
        "src_extrin": np.stack([s[2] for s in src]),
        "tar_k": K_t[None], "tar_rt": Rt_t[None],
        "verts": verts[None], "faces": faces, "kpt3d": kpt3d[None],
        "bounds": bounds[None],
        "znear": np.float32(ZNEAR), "zfar": np.float32(ZFAR)}
    if targets:
        tar = draw(views[0])[0]
        req.update({"tar_img": tar[None, ..., :3],
                    "tar_mask": tar[None, ..., 6:7],
                    "input_densepose": src[0][0][None, ..., 3:6],
                    "tar_densepose": tar[None, ..., 3:6]})
    return {k: np.asarray(v, dtype=np.int64 if k == "faces"
                          else np.float32).copy() for k, v in req.items()}


def make_pool(seed: int, n: int, n_views: int, H: int, W: int, device,
              targets: bool = False) -> list:
    """``n`` distinct requests drawn from ``seed`` (any non-negative
    integer, however large)."""
    rng = np.random.default_rng(seed)
    return [make_request(rng, n_views, H, W, device, targets)
            for _ in range(n)]
