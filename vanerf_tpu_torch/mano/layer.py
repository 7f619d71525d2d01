"""MANO layer: blend shapes + LBS (port of ``vanerf_tpu/mano/layer.py``).

The numpy path (:func:`mano_forward_np`, :func:`seal_verts_np`) is what the
InterHand2.6M loader runs per item; :func:`rodrigues` and
:func:`mano_forward` are the same math in torch.

Weight loading reads the original MANO_{RIGHT,LEFT}.pkl files (chumpy
objects are unpickled through a stub, no chumpy dependency).  When the pkls
are absent (they are license-gated downloads), a deterministic synthetic
model with the real MANO dimensions (778 verts / 1538 faces / 16 joints) is
generated so every downstream shape is exercised identically.

Includes the reference's conditional left-hand shapedirs sign fix
(``dataset.py:29-32``) and the default-pose mean addition (smplx
``flat_hand_mean=False`` semantics).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

N_VERTS = 778
N_JOINTS = 16
N_FACES = 1538

# wrist ring used to seal the mesh watertight (dataset.py:35-52)
SEAL_RING = np.array([108, 79, 78, 121, 214, 215, 279, 239, 234, 92, 38,
                      122, 118, 117, 119, 120], dtype=np.int32)


class _ChumpyStub:
    def __setstate__(self, state):
        self.__dict__.update(state)


class _ManoUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyStub
        return super().find_class(module, name)


def _to_np(x):
    if isinstance(x, _ChumpyStub):
        return np.asarray(x.__dict__.get("x"))
    if hasattr(x, "toarray"):
        return np.asarray(x.toarray())
    return np.asarray(x)


@dataclasses.dataclass
class ManoModel:
    v_template: np.ndarray    # (778, 3)
    shapedirs: np.ndarray     # (778, 3, 10)
    posedirs: np.ndarray      # (778, 3, 135)
    J_regressor: np.ndarray   # (16, 778)
    weights: np.ndarray       # (778, 16)
    faces: np.ndarray         # (1538, 3) int32
    parents: np.ndarray       # (16,) int32
    hands_mean: np.ndarray    # (45,)
    is_rhand: bool
    synthetic: bool = False


def _load_mano_pkl(path: str, is_rhand: bool) -> ManoModel:
    """Read one MANO pkl verbatim (no shapedirs fix applied)."""
    with open(path, "rb") as f:
        data = _ManoUnpickler(f, encoding="latin1").load()
    m = ManoModel(
        v_template=_to_np(data["v_template"]).astype(np.float32),
        shapedirs=_to_np(data["shapedirs"]).astype(np.float32),
        posedirs=_to_np(data["posedirs"]).astype(np.float32),
        J_regressor=_to_np(data["J_regressor"]).astype(np.float32),
        weights=_to_np(data["weights"]).astype(np.float32),
        faces=_to_np(data["f"]).astype(np.int32),
        parents=_to_np(data["kintree_table"])[0].astype(np.int32),
        hands_mean=_to_np(data["hands_mean"]).astype(np.float32),
        is_rhand=is_rhand,
    )
    m.parents[0] = 0
    return m


def _flip_left_shapedirs(left: ManoModel) -> ManoModel:
    left.shapedirs = left.shapedirs.copy()
    left.shapedirs[:, 0, :] *= -1
    return left


def _maybe_fix_left_pair(left: ManoModel, right: ManoModel) -> ManoModel:
    """The reference's CONDITIONAL smplx left-shapedirs bug fix
    (``src/dataset.py:29-32``): the official MANO release ships the left
    hand with right-hand shapedirs x-components; flip them only when the
    left/right x-shapedirs actually coincide, so an already-corrected pkl
    is not double-flipped."""
    if np.abs(left.shapedirs[:, 0, :] - right.shapedirs[:, 0, :]).sum() < 1:
        return _flip_left_shapedirs(left)
    return left


def load_mano_pair(mano_dir: str,
                   right_name: str = "MANO_RIGHT.pkl",
                   left_name: str = "MANO_LEFT.pkl") -> dict:
    """Load {'right','left'} MANO models with the reference's conditional
    left-shapedirs fix (``src/dataset.py:26-32``).  Falls back to the
    synthetic pair when either pkl is absent (license-gated downloads)."""
    rp = os.path.join(mano_dir, right_name)
    lp = os.path.join(mano_dir, left_name)
    if not (os.path.exists(rp) and os.path.exists(lp)):
        if os.path.exists(rp) != os.path.exists(lp):
            # exactly one pkl present: a real hand model silently paired
            # with a synthetic one would emit garbage meshes for the
            # missing hand in real-data preprocessing (ADVICE r4)
            import warnings
            present = right_name if os.path.exists(rp) else left_name
            missing = left_name if os.path.exists(rp) else right_name
            warnings.warn(
                f"load_mano_pair: found {present} but NOT {missing} in "
                f"{mano_dir!r}; the missing hand falls back to the "
                "SYNTHETIC model — real-data preprocessing would emit "
                "garbage meshes for it. Ship both pkls.",
                stacklevel=2)
        return {"right": load_mano_model(rp, True),
                "left": load_mano_model(lp, False)}
    right = _load_mano_pkl(rp, True)
    left = _maybe_fix_left_pair(_load_mano_pkl(lp, False), right)
    return {"right": right, "left": left}


def load_mano_model(path: str, is_rhand: bool,
                    fix_left_shapedirs: bool = True) -> ManoModel:
    """Load a single MANO pkl.  Falls back to :func:`synthetic_mano_model`
    when the file is absent.

    For the left hand the shapedirs fix is applied CONDITIONALLY per the
    reference (``src/dataset.py:29-32``) by also reading the sibling
    MANO_RIGHT.pkl from the same directory when it exists; if the sibling
    is absent the fix is applied unconditionally (the behavior with the
    official — bugged — MANO release).  Prefer :func:`load_mano_pair`."""
    if not os.path.exists(path):
        return synthetic_mano_model(is_rhand)
    m = _load_mano_pkl(path, is_rhand)
    if not is_rhand and fix_left_shapedirs:
        sib = os.path.join(os.path.dirname(path), "MANO_RIGHT.pkl")
        if os.path.exists(sib):
            m = _maybe_fix_left_pair(m, _load_mano_pkl(sib, True))
        else:
            m = _flip_left_shapedirs(m)
    return m


def synthetic_mano_model(is_rhand: bool) -> ManoModel:
    """Deterministic stand-in with true MANO dimensions."""
    rs = np.random.RandomState(42 if is_rhand else 43)
    # template: elongated ellipsoid (97 rings x 8 sectors + 2 poles = 778)
    S, R = 8, 97
    u = np.linspace(0, 2 * np.pi, S + 1)[:-1]
    rows = []
    for i in range(R):
        r = 0.5 * np.sin(np.pi * (i + 1) / (R + 1))
        zrow = (i + 1) / (R + 1) - 0.5
        for a in u:
            rows.append([r * np.cos(a), r * np.sin(a), zrow])
    v = np.asarray(rows, np.float32)
    v = np.concatenate([v, [[0, 0, -0.5], [0, 0, 0.5]]], 0).astype(np.float32)
    assert v.shape[0] == N_VERTS
    v *= np.array([[0.04, 0.025, 0.09]], np.float32)
    if not is_rhand:
        v = v * np.array([[-1, 1, 1]], np.float32)

    # faces: band strips + pole caps, truncated to the MANO face count
    faces = []
    for i in range(R - 1):
        for j in range(S):
            a = i * S + j
            b = i * S + (j + 1) % S
            c = (i + 1) * S + j
            d = (i + 1) * S + (j + 1) % S
            faces.append([a, b, c])
            faces.append([b, d, c])
    bot, top = N_VERTS - 2, N_VERTS - 1
    for j in range(S):
        faces.append([bot, (j + 1) % S, j])
        faces.append([top, (R - 1) * S + j, (R - 1) * S + (j + 1) % S])
    faces = np.asarray(faces[:N_FACES], np.int32)

    parents = np.array([0, 0, 1, 2, 0, 4, 5, 0, 7, 8, 0, 10, 11, 0, 13, 14],
                       np.int32)
    jreg = np.zeros((N_JOINTS, N_VERTS), np.float32)
    for j in range(N_JOINTS):
        idx = rs.choice(N_VERTS, 8, replace=False)
        jreg[j, idx] = 1.0 / 8
    w = rs.rand(N_VERTS, N_JOINTS).astype(np.float32) ** 4
    w /= w.sum(1, keepdims=True)
    return ManoModel(
        v_template=v,
        shapedirs=(rs.randn(N_VERTS, 3, 10) * 1e-3).astype(np.float32),
        posedirs=(rs.randn(N_VERTS, 3, 135) * 1e-4).astype(np.float32),
        J_regressor=jreg, weights=w, faces=faces, parents=parents,
        hands_mean=np.zeros(45, np.float32), is_rhand=is_rhand,
        synthetic=True,
    )


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True)
    theta = torch.clamp_min(theta, 1e-8)
    k = rvec / theta
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zero = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([zero, -kz, ky], -1),
        torch.stack([kz, zero, -kx], -1),
        torch.stack([-ky, kx, zero], -1)], -2)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    t = theta[..., None]
    return eye + torch.sin(t) * K + (1 - torch.cos(t)) * (K @ K)


def mano_forward(model: ManoModel, betas: torch.Tensor, pose: torch.Tensor,
                 trans: torch.Tensor, flat_hand_mean: bool = False):
    """MANO forward: shape blend + pose blend + LBS, on the tensors'
    device.

    Args:
      betas: (10,) shape coefficients.
      pose:  (48,) axis-angle [global_orient(3), hand_pose(45)].
      trans: (3,) translation.
      flat_hand_mean: when False (smplx default used by the reference),
        the hand mean pose is added to hand_pose.
    Returns:
      verts (778, 3), joints (16, 3).
    """
    pose = torch.as_tensor(pose)
    dt, dev = pose.dtype, pose.device

    def T(x):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    vt, sd, pd = T(model.v_template), T(model.shapedirs), T(model.posedirs)
    jreg, lbs_w = T(model.J_regressor), T(model.weights)
    betas = torch.as_tensor(betas, dtype=dt, device=dev)
    trans = torch.as_tensor(trans, dtype=dt, device=dev)
    parents = model.parents

    root = pose[:3]
    hand = pose[3:]
    if not flat_hand_mean:
        hand = hand + T(model.hands_mean)
    full_pose = torch.cat([root, hand]).reshape(N_JOINTS, 3)

    v_shaped = vt + torch.einsum("vds,s->vd", sd, betas)
    joints = jreg @ v_shaped                                  # (16, 3)

    rots = rodrigues(full_pose)                               # (16, 3, 3)
    eye = torch.eye(3, dtype=dt, device=dev)
    pose_feat = (rots[1:] - eye).reshape(-1)                  # (135,)
    v_posed = v_shaped + torch.einsum("vdp,p->vd", pd, pose_feat)

    # kinematic chain over the 16 joints
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dt, device=dev)
    transforms = [None] * N_JOINTS
    for j in range(N_JOINTS):
        t = joints[j] if j == 0 else joints[j] - joints[parents[j]]
        A = torch.cat([torch.cat([rots[j], t[:, None]], 1), bottom], 0)
        transforms[j] = A if j == 0 else transforms[parents[j]] @ A
    A = torch.stack(transforms)                               # (16, 4, 4)
    joints_posed = A[:, :3, 3]

    # remove the rest-pose joint location (standard LBS correction)
    j_h = torch.cat([joints, torch.zeros(N_JOINTS, 1, dtype=dt,
                                         device=dev)], 1)
    correction = torch.einsum("jab,jb->ja", A, j_h)           # (16, 4)
    A = torch.cat([A[:, :3, :3],
                   (A[:, :3, 3] - correction[:, :3])[..., None]], 2)
    A = torch.cat([A, bottom.expand(N_JOINTS, 1, 4)], 1)

    T_v = torch.einsum("vj,jab->vab", lbs_w, A)               # (778, 4, 4)
    v_h = torch.cat([v_posed, torch.ones(N_VERTS, 1, dtype=dt, device=dev)],
                    1)
    verts = torch.einsum("vab,vb->va", T_v, v_h)[:, :3]
    return verts + trans, joints_posed + trans


def mano_forward_np(model: ManoModel, betas, pose, trans,
                    flat_hand_mean: bool = False):
    """Pure-numpy :func:`mano_forward` (identical math, f32): the input
    pipeline's MANO, a handful of BLAS calls per hand and item
    (``vanerf_tpu/mano/layer.py:290``)."""
    betas = np.asarray(betas, np.float32)
    pose = np.asarray(pose, np.float32)
    trans = np.asarray(trans, np.float32)
    root, hand = pose[:3], pose[3:]
    if not flat_hand_mean:
        hand = hand + model.hands_mean
    full_pose = np.concatenate([root, hand]).reshape(N_JOINTS, 3)

    v_shaped = model.v_template + model.shapedirs @ betas
    joints = model.J_regressor @ v_shaped                     # (16, 3)

    # Rodrigues (vectorized)
    theta = np.maximum(np.linalg.norm(full_pose, axis=-1, keepdims=True),
                       1e-8)
    k = full_pose / theta
    K = np.zeros((N_JOINTS, 3, 3), np.float32)
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    t = theta[..., None]
    rots = (np.eye(3, dtype=np.float32) + np.sin(t) * K
            + (1 - np.cos(t)) * (K @ K))                      # (16, 3, 3)

    pose_feat = (rots[1:] - np.eye(3, dtype=np.float32)).reshape(-1)
    v_posed = v_shaped + model.posedirs @ pose_feat

    r_glob = np.empty((N_JOINTS, 3, 3), np.float32)
    j_posed = np.empty((N_JOINTS, 3), np.float32)
    r_glob[0], j_posed[0] = rots[0], joints[0]
    for j in range(1, N_JOINTS):
        p = model.parents[j]
        r_glob[j] = r_glob[p] @ rots[j]
        j_posed[j] = j_posed[p] + r_glob[p] @ (joints[j] - joints[p])

    # skinning: x -> R_glob_j (x - J_rest_j) + J_posed_j, weight-blended.
    # Blend the per-joint affine (R, t) pairs FIRST (16 joints), then
    # apply once per vertex — two small matmuls instead of 16x778 pairs.
    t_glob = j_posed - np.einsum("jab,jb->ja", r_glob, joints)  # (16, 3)
    R_v = np.einsum("vj,jab->vab", model.weights, r_glob)     # (778, 3, 3)
    t_v = model.weights @ t_glob                              # (778, 3)
    verts = np.einsum("vab,vb->va", R_v, v_posed) + t_v
    return verts + trans, j_posed + trans


def seal_verts_np(verts: np.ndarray, faces: np.ndarray, hand_type: str):
    """Append the wrist-center vertex + 16 sealing faces
    (reference ``dataset.py:35-52``).

    Args:
      verts: (778, 3); faces: (F, 3); hand_type: 'left'|'right'.
    Returns:
      verts (779, 3), faces (F+16, 3).
    """
    ring = SEAL_RING[::-1] if hand_type == "left" else SEAL_RING
    center = verts[ring].mean(0, keepdims=True)
    out_v = np.concatenate([verts, center], 0)
    cid = len(out_v) - 1
    new_faces = [[ring[i - 1], ring[i], cid] for i in range(len(ring))]
    out_f = np.concatenate([faces, np.asarray(new_faces, faces.dtype)], 0)
    return out_v, out_f
