"""vanerf_tpu_torch — the PyTorch + CUDA port of ``vanerf_tpu``.

The serving path (``renderer.render_patch`` / ``render_full_image``), the
GAN train step (``training.make_train_step``), the training and
evaluation entry point (``python -m vanerf_tpu_torch.train``: ``fit``,
checkpoints, validation, ``run_test``) and the free-viewpoint video
(``python -m vanerf_tpu_torch.render_dynamic``) run on one NVIDIA Hopper
GPU.  The TPU kernels on those paths are hand-written CUDA C++ for
``sm_90a`` under ``csrc/``:

  * A — culled point->mesh query  (``ops/mesh_query.py``)
  * B — nearest-vertex search      (``ops/knn.py``)
  * C — z-buffer rasterizer        (``ops/rasterize.py``)
  * D — small-map bilinear sampler (``ops/interp_mxu.py``, inference)
  * 13 — table gradient of the small-table gathers
    (``ops/onehot_gather.py``, training)

Each kernel has a plain-PyTorch twin in the same module; a wrapper takes
the twin only for CPU tensors.  The package imports torch, numpy and the
standard library — never jax, flax, yaml or ``vanerf_tpu`` (PIL where the
InterHand reader decodes a JPEG, tensorboard where it is installed; the
video's PNG, JPEG and GIF encoders are the port's own).

Layouts follow ``vanerf_tpu`` at every public function: channels-last
(B, H, W, C) maps and (B, N, 3) points.  Compute is float32, or bfloat16
in the per-point query under ``compute_dtype="bfloat16"``
(``models/vanerf.py``), for serving and training alike.
"""

__version__ = "0.1.0"
