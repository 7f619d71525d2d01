"""Densepose vertex-color table (the reference's ``v_color.pkl``), port of
``vanerf_tpu/data/densepose.py``.

The reference renders densepose images — model inputs feeding the
discriminator and the dataset tensors — from a shipped 778x3
dense-coordinate table (``data_process/dataset_process.py:54`` /
``src/render_vis.py:101-105``), seal-expanded to 779 rows per hand with
``cat(dense, dense[-1], dense, dense[-1])``.  The port keeps its own copy
of the table (``assets/v_color.npz``, the JAX package's file).

Synthetic fixtures keep their procedural colors (``data/synthetic.py``);
real MANO meshes must use :func:`densepose_colors`.
"""

from __future__ import annotations

import functools
import os.path as osp

import numpy as np

_ASSET = osp.join(osp.dirname(__file__), "assets", "v_color.npz")


@functools.lru_cache(maxsize=1)
def dense_coor_table() -> np.ndarray:
    """The seal-expanded (1558, 3) float32 table.

    Row layout matches the reference's module-scope expansion
    (``src/render_vis.py:105``): [dense(778), dense[-1], dense(778),
    dense[-1]] — the per-hand seal vertex (index 778) reuses the last
    dense coordinate's color.
    """
    dense = np.load(_ASSET)["v_color"].astype(np.float32)   # (778, 3)
    return np.concatenate([dense, dense[-1:], dense, dense[-1:]], axis=0)


def densepose_colors(n_verts: int) -> np.ndarray:
    """Per-vertex densepose colors for a sealed MANO mesh.

    Args:
      n_verts: 779 (one sealed hand) or 1558 (two sealed hands) — the
        reference switches on ``verts.shape[0] > 800``
        (``dataset_process.py:76-79``).
    Returns:
      (n_verts, 3) float32 colors in [0, 1].
    """
    table = dense_coor_table()
    if n_verts > 800:
        if n_verts != table.shape[0]:
            raise ValueError(f"{n_verts} vertices: two sealed hands have "
                             f"{table.shape[0]}")
        return table
    if n_verts != 779:
        raise ValueError(f"{n_verts} vertices: one sealed hand has 779")
    return table[:779]
