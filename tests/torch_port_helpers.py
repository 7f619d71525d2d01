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
