"""Shared fixtures of the ``tests/test_torch_*.py`` parity tests.

The same numpy inputs go through the JAX package (on the CPU; Pallas
kernels in interpret mode where a test says so) and through the PyTorch
port, at small sizes: 32^2 images, ``n_downsample=2``, the subdiv=2
two-hand fixture (162 vertices per hand), 4x4 rays and 8+8 samples.
Weights come from the torch reference replica, converted to flax by
``tools/convert_reference_ckpt.py`` and back to the port by
``vanerf_tpu_torch.weights.from_jax_params``.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

torch.set_num_threads(2)          # tier-1 runs 6 xdist workers

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (os.path.join(ROOT, "tools"), HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

NUM_V = 162          # icosphere(subdiv=2) hand template
H = W = 32
OUT = 4              # 4x4 rays
S_C = S_F = 8


def small_cfg() -> dict:
    from vanerf_tpu_torch.config import default_cfg
    cfg = default_cfg()
    cfg["models"]["VANeRF"]["geo_args"]["n_downsample"] = 2
    return cfg


@functools.lru_cache(maxsize=2)
def converted_params(seed: int = 7):
    """(flax generator params, replica state_dict as numpy) of a randomly
    initialised torch reference replica at the small shapes."""
    import torch_ref_replica as R
    from convert_reference_ckpt import convert_state_dict
    cfg = small_cfg()
    torch.manual_seed(seed)
    rep = R.LightningReplicaT(cfg, num_v=NUM_V, hw3=8, hw4=W)
    sd = {k: v.detach().numpy() for k, v in rep.state_dict().items()}
    g, _d = convert_state_dict(sd, geo_cfg=cfg["models"]["VANeRF"]
                               ["geo_args"])
    return g, sd


def port_model(seed: int = 7):
    """The port's VANeRF carrying the same weights as :func:`jax_model`."""
    from vanerf_tpu_torch.models import VANeRF
    from vanerf_tpu_torch.weights import from_jax_params
    g, _ = converted_params(seed)
    model = VANeRF.from_config(small_cfg(), num_v=NUM_V, image_hw=(H, W))
    model.load_state_dict(from_jax_params(g), strict=True)
    return model.eval()


def jax_model():
    from vanerf_tpu.models import VANeRF
    return VANeRF.from_config(small_cfg(), num_v=NUM_V)


@functools.lru_cache(maxsize=1)
def synthetic_batch():
    """The JAX package's fixture batch (numpy) at the small shapes."""
    from vanerf_tpu.data.synthetic import make_synthetic_batch
    batch, faces, num_v = make_synthetic_batch(batch_size=1, H=H, W=W,
                                               subdiv=2, num_input_view=1)
    assert num_v == NUM_V
    return batch, faces


@functools.lru_cache(maxsize=2)
def synthetic_batch_views(n_views: int) -> dict:
    """The JAX package's fixture batch (numpy) with ``n_views`` source views
    a frame, their images and cameras flattened to (V, ...) (as
    ``tests/test_fullchain_parity.py`` makes it)."""
    from vanerf_tpu.data.synthetic import make_synthetic_batch
    batch, _, num_v = make_synthetic_batch(batch_size=1, H=H, W=W, subdiv=2,
                                           num_input_view=n_views)
    assert num_v == NUM_V and batch["src_img"].shape[0] == n_views
    return batch


def torch_batch(batch: dict) -> dict:
    from vanerf_tpu_torch.data import to_torch
    return to_torch(batch, "cpu")


def center_grid() -> np.ndarray:
    lo = W // 2 - OUT // 2
    y, x = np.meshgrid(np.arange(lo, lo + OUT), np.arange(lo, lo + OUT),
                       indexing="ij")
    return np.stack([x, y], -1).reshape(1, -1, 2).astype(np.float32)


def two_hand_points(n: int, seed: int = 0) -> np.ndarray:
    """Points around (and inside) the interpenetrating fixture hands
    (frame 0, subdiv=2: the vertices of :func:`synthetic_batch`)."""
    from vanerf_tpu_torch.data.synthetic import two_hand_mesh
    rs = np.random.RandomState(seed)
    verts = two_hand_mesh(0, 2)[0]
    lo, hi = verts.min(0) - 0.02, verts.max(0) + 0.02
    return (lo + rs.rand(n, 3) * (hi - lo)).astype(np.float32)


def morton_sorted(batch: dict) -> dict:
    """``batch`` (numpy, batch size 1) with its faces permuted into the
    Morton order the port's culled query sorts them into.

    Where a sample's closest point is a vertex or lies on an edge, the faces
    around it tie for the minimum to the last bit, the first in table order
    wins, and the winner's plane decides the interpolated visibility.  The
    port Morton-sorts its faces as the JAX package does on a TPU; the JAX
    CPU path, which the render tests compare with, keeps the order it is
    given.  Fed this batch, the port's stable sort is the identity, both
    packages walk one face order, and every tie falls alike: the render
    comparisons need no allowance for ties.
    """
    import torch
    from vanerf_tpu_torch.ops import mesh_query as mq
    assert batch["verts"].shape[0] == 1
    verts = torch.from_numpy(np.asarray(batch["verts"][0], np.float32))
    faces = torch.from_numpy(np.asarray(batch["faces"]).astype(np.int64))
    vis = torch.zeros(verts.shape[0], 1)
    order = mq.prepare_culled_mesh(verts, faces, vis)["order"]
    out = dict(batch)
    out["faces"] = np.ascontiguousarray(np.asarray(batch["faces"])
                                        [order.numpy()])
    again = mq.prepare_culled_mesh(
        verts, torch.from_numpy(out["faces"].astype(np.int64)), vis)["order"]
    assert torch.equal(again, torch.arange(len(again)))
    return out


# JAX's renders see each collated frame's faces in that frame's Morton order:
# the port's mesh query sorts its faces so (as the JAX package does on a
# TPU), the JAX CPU path keeps the order it is given, and where a sample's
# closest point is a shared vertex or edge the first face in table order
# wins (:func:`morton_sorted`).  Unsorted, such ties move ~140 of a 32^2
# frame's pixels by up to 0.03; sorted, none by more than 5e-4.  A JAX
# entry point that collates one item a frame gets each frame's own order;
# the port, which sorts for itself, renders the same either way.
def morton_collate(collate_numpy):
    """``collate_numpy`` with each batch's faces in Morton order."""
    def collate(items, faces=None):
        return morton_sorted({k: np.asarray(v) for k, v in
                              collate_numpy(items, faces=faces).items()})
    return collate


def replica_checkpoints(d, cfg: dict, num_v: int, seed: int = 2) -> None:
    """Write into directory ``d`` a reference-layout ``model.ckpt`` of the
    torch reference replica at ``cfg``'s small shapes (32^2 images) and its
    ``tools/convert_reference_ckpt.py`` pickle ``ckpt.pkl``."""
    import pickle
    from convert_reference_ckpt import convert_state_dict
    from make_synthetic_assets import synthetic_reference_ckpt
    ck = synthetic_reference_ckpt(seed=seed, cfg=cfg, num_v=num_v, hw3=8,
                                  hw4=W)
    torch.save(ck, os.path.join(str(d), "model.ckpt"))
    sd = {k: v.numpy() for k, v in ck["state_dict"].items()}
    g, dd = convert_state_dict(sd, geo_cfg=cfg["models"]["VANeRF"]
                               ["geo_args"])
    with open(os.path.join(str(d), "ckpt.pkl"), "wb") as f:
        pickle.dump({"params_g": g, "params_d": dd, "epoch": ck["epoch"],
                     "global_step": ck["global_step"]}, f)
