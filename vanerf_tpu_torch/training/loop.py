"""Training loop: epochs, validation cadence, checkpointing, logging (port
of ``vanerf_tpu/training/loop.py``).

Parity target: the PL Trainer wiring in reference ``train.py:53-76`` +
``VANeRFLightningModule`` train/val hooks (``model.py:381-601``): dual
G/D optimizers, val every `val_check_interval` fraction of an epoch,
checkpoint per epoch (all kept + last), auto-resume, scalar logging with
the same `train/*` / `val_total_loss` names.  The epoch order, the batch
slices, the cadence of logs, validations and saves are the JAX package's;
the random stream is one ``torch.Generator`` handed to every step.

Over N data-parallel ranks (``mesh``, ``parallel/``) the batch is the
global one, N x ``train_batch_size``: every rank walks the same epoch
order, pads a short batch cyclically as the JAX package does
(``vanerf_tpu/training/loop.py:189-193``) and takes its slice of it; only
rank 0 validates, logs and writes checkpoints.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from .checkpoints import CheckpointManager


def _pin_worker_to_cpu(worker_id: int) -> None:
    """Loader worker set-up: the workers are host-side, so the synthetic
    dataset rasterizes there on the CPU (the JAX package pins its workers
    to the CPU platform, ``vanerf_tpu/training/loop.py:59-72``): a worker
    never touches CUDA."""
    from ..data.synthetic import SyntheticDataset
    dataset = torch.utils.data.get_worker_info().dataset
    if isinstance(dataset, SyntheticDataset):
        dataset.device = torch.device("cpu")
    torch.set_num_threads(1)


def _present(items: list) -> list:
    """The loader's collate: a batch's items less the ``None`` of samples
    the dataset skipped (``model.py:123-132``); the caller collates."""
    return [it for it in items if it is not None]


def sample_loader(dataset, batches: list, num_workers: int = 1):
    """``dataset[i]`` for each index list of ``batches``, in order, yielded
    as lists of the items that are not ``None`` (a torch ``DataLoader``;
    ``training.train_num_workers`` / ``val_num_workers``).

    Both datasets seed their per-item RNG from the index alone, so
    ``dataset[i]`` is a pure function and worker processes cannot change
    semantics.  ``num_workers <= 1`` loads inline, as the JAX package does;
    more start ``forkserver`` workers (the parent may hold a CUDA context,
    which a forked child must not inherit), each pinned to the CPU.
    """
    workers = num_workers if num_workers > 1 else 0
    return torch.utils.data.DataLoader(
        dataset, batch_sampler=batches, collate_fn=_present,
        num_workers=workers,
        multiprocessing_context="forkserver" if workers else None,
        worker_init_fn=_pin_worker_to_cpu if workers else None)


class MetricLogger:
    """``metrics.jsonl`` always; TensorBoard too where the ``tensorboard``
    package imports."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self.tb = None
        else:
            self.tb = SummaryWriter(log_dir)

    def log_scalars(self, step: int, scalars: dict):
        rec = {"step": int(step)}
        for k, v in scalars.items():
            rec[k] = float(v)
            if self.tb is not None:
                self.tb.add_scalar(k, float(v), step)
        self.jsonl.write(json.dumps(rec) + "\n")
        self.jsonl.flush()

    def log_image(self, step: int, name: str, img_hwc: np.ndarray):
        if self.tb is not None:
            self.tb.add_image(name, np.transpose(img_hwc, (2, 0, 1)), step)

    def close(self):
        self.jsonl.close()
        if self.tb is not None:
            self.tb.close()


def fit(train_step: Callable, state, dataset, collate: Callable, *,
        cfg: dict, save_dir: str, generator: Optional[torch.Generator] = None,
        max_epochs: Optional[int] = None, val_fn: Optional[Callable] = None,
        fast_dev_run: bool = False, log_every: int = 10,
        batch_size: Optional[int] = None, mesh=None):
    """Run the training loop (``vanerf_tpu/training/loop.py:177``).

    Args:
      train_step: (state, batch, generator) -> logs; updates ``state`` in
        place (``training.make_train_step``).
      dataset: indexable dataset of per-sample dicts.
      collate: list[dict] -> batch dict on the device.
      generator: the one random stream of every step's draws.
      val_fn: optional (state, step, logger) -> dict with 'val_total_loss'.
      batch_size: global batch size override; short batches (None-dropped
        samples, tail) are padded cyclically.
      mesh: the data-parallel :class:`~vanerf_tpu_torch.parallel.Mesh`;
        each rank collates its slice of every global batch (which divides
        over the ranks).
    Returns the final state.
    """
    tcfg = cfg["training"]
    max_epochs = max_epochs or tcfg.get("max_epochs", 30)
    batch_size = batch_size or tcfg.get("train_batch_size", 1)
    val_interval = tcfg.get("pl_cfg", {}).get("val_check_interval", 0.1)

    lead = mesh is None or mesh.lead
    n_ranks = 1 if mesh is None else mesh.size
    if batch_size % n_ranks:
        raise ValueError(f"a global batch of {batch_size} does not split "
                         f"over {n_ranks} ranks")
    per_rank = batch_size // n_ranks
    logger = MetricLogger(save_dir) if lead else None
    ckpt = (CheckpointManager(os.path.join(save_dir, "ckpts"),
                              max_to_keep=tcfg.get("keep_ckpts"))
            if lead else None)

    n = len(dataset)
    steps_per_epoch = max(n // batch_size, 1)
    val_every = max(int(steps_per_epoch * val_interval), 1)
    start_step = int(state.step)
    start_epoch = start_step // steps_per_epoch

    order_rng = np.random.default_rng(1234 + start_epoch)
    step_i = start_step
    workers = tcfg.get("train_num_workers", 1)
    try:
        for epoch in range(start_epoch, max_epochs):
            perm = order_rng.permutation(n)
            t_epoch = time.time()
            # exact per-batch index slices (the last may be short when
            # n < batch_size); cyclic padding below fills the batch
            batches = [perm[bi * batch_size:(bi + 1) * batch_size].tolist()
                       for bi in range(steps_per_epoch)]
            for items in sample_loader(dataset, batches, workers):
                if not items:   # every sample of the batch skipped
                    continue
                if len(items) < batch_size:
                    items = [items[i % len(items)]
                             for i in range(batch_size)]
                if n_ranks > 1:
                    items = items[mesh.rank * per_rank:
                                  (mesh.rank + 1) * per_rank]
                batch = collate(items)
                logs = train_step(state, batch, generator)
                step_i += 1

                if step_i % log_every == 0 and lead:
                    logger.log_scalars(step_i, logs)
                if val_fn is not None and step_i % val_every == 0 and lead:
                    val_logs = val_fn(state, step_i, logger)
                    if val_logs:
                        logger.log_scalars(step_i, val_logs)
                if fast_dev_run:
                    return state
            dt = time.time() - t_epoch
            if not lead:
                continue
            logger.log_scalars(step_i, {"epoch": epoch, "epoch_time_s": dt})
            # per-epoch save (reference parity); training.ckpt_every_epochs
            # thins it, the last epoch always saves
            every = max(1, int(tcfg.get("ckpt_every_epochs", 1)))
            if (epoch + 1) % every == 0 or epoch == max_epochs - 1:
                ckpt.save(step_i, state, wait=False)
        return state
    finally:
        if lead:
            ckpt.wait()          # flush any in-flight save
            logger.close()


def collate_numpy(items: Iterable[dict], faces=None, flatten_views=True):
    """Stack per-sample dicts into a numpy batch; flatten (B, V, ...)
    source-view arrays to (B*V, ...) as the renderer expects
    (``vanerf_tpu/training/loop.py:278``, whose arrays it returns as
    numpy: ``data.to_torch`` moves them to the device)."""
    batch = {}
    keys = [k for k in items[0]
            if k not in ("frame_index", "cam_ind", "human_idx")]
    for k in keys:
        v0 = items[0][k]
        if np.ndim(v0) == 0:
            batch[k] = np.asarray(v0)
            continue
        batch[k] = np.stack([np.asarray(it[k]) for it in items])
    if flatten_views:
        for k in ("src_img", "src_mask", "src_krt", "src_extrin"):
            if k in batch:
                v = batch[k]
                batch[k] = v.reshape((-1,) + v.shape[2:])
    if faces is not None:
        batch["faces"] = faces
    return batch

