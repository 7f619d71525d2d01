"""The data-parallel group and its helpers (port of
``vanerf_tpu/parallel/mesh.py``).

The JAX package drives N devices from one process over a 1-D ``"data"``
mesh.  The port runs one process a device over ``torch.distributed``: NCCL
on the card, gloo on the CPU, chosen by the device (a caller may name the
backend: gloo also takes CUDA tensors for ``all_reduce`` and
``broadcast``).  A :class:`Mesh` holds this process's rank, the world size,
its device and the process group.  :func:`make_mesh` sets the group up
from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``) when it is there, else from its
arguments; :func:`launch` starts N workers of an entry point itself,
rendezvousing through a file, so that one command runs N ranks as the JAX
package's ``--num_gpus N`` does.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

# the environment a worker of :func:`launch` reads its rendezvous from (a
# torchrun worker has none and uses env://)
INIT_ENV = "VANERF_DIST_INIT"


@dataclass
class Mesh:
    """This process's place in the data-parallel group."""
    rank: int
    size: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    @property
    def lead(self) -> bool:
        """Rank 0: the one that writes checkpoints, logs and files."""
        return self.rank == 0

    def all_reduce_mean(self, tensors) -> list:
        """The mean over the ranks of each tensor (a new list), as one sum
        of a flat buffer divided by the world size (``ReduceOp.AVG`` is
        NCCL's only); with two ranks the sum is order-free, so every rank
        holds the same bits."""
        if not tensors:
            return []
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        flat /= self.size
        out, o = [], 0
        for t in tensors:
            n = t.numel()
            out.append(flat[o:o + n].view(t.shape).to(t.dtype))
            o += n
        return out

    def all_reduce_sum_(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast_(self, tensors) -> None:
        """Rank 0's values into every rank's tensors, in place (a
        tensor off this rank's device, as Adam's step counts on the host,
        through a copy on it under NCCL)."""
        nccl = self.backend == "nccl"
        for t in tensors:
            if nccl and t.device != self.device:
                tmp = t.to(self.device)
                dist.broadcast(tmp, 0, group=self.group)
                t.copy_(tmp)
            else:
                dist.broadcast(t, 0, group=self.group)


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def make_mesh(n_devices: Optional[int] = None, device=None,
              rank: Optional[int] = None, init_method: Optional[str] = None,
              backend: Optional[str] = None) -> Mesh:
    """This process's :class:`Mesh` of ``n_devices`` ranks.

    An initialised default group is taken as it is.  Else the group is
    set up from ``rank`` / ``n_devices`` / ``init_method`` where given,
    then from the environment: torchrun's ``RANK`` / ``WORLD_SIZE`` with
    ``env://``, or a :func:`launch` worker's ``VANERF_DIST_INIT``.
    ``device`` (default the card) is the card ``LOCAL_RANK`` (else the
    rank) modulo the cards there are, or the CPU; the backend is NCCL on
    the card and gloo on the CPU unless ``backend`` names one.
    """
    if dist.is_initialized():
        size, r = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != size:
            raise ValueError(f"{n_devices} devices asked for, the process "
                             f"group has {size}")
    else:
        size = n_devices if n_devices is not None else (
            _env_int("WORLD_SIZE") or 1)
        r = rank if rank is not None else (_env_int("RANK") or 0)
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        local = _env_int("LOCAL_RANK")
        dev = torch.device("cuda", (r if local is None else local)
                           % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        init = init_method or os.environ.get(INIT_ENV) or "env://"
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init, world_size=size, rank=r)
    return Mesh(rank=r, size=size, device=dev)


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This rank's slice of the leading (batch) dimension of every entry
    that :func:`~.train.batch_pspecs` splits; the others (``faces``,
    ``znear``, ``zfar``, scalars, ``None``) as they are.  The source views
    of a frame stay together: a (B V, ...) entry splits into B V / N
    rows."""
    if mesh is None or mesh.size == 1:
        return batch
    from .train import batch_pspecs
    out = {}
    for k, split in batch_pspecs(batch).items():
        v = batch[k]
        if not split:
            out[k] = v
            continue
        n = v.shape[0]
        if n % mesh.size:
            raise ValueError(f"batch[{k!r}]: {n} rows do not split over "
                             f"{mesh.size} ranks")
        per = n // mesh.size
        out[k] = v[mesh.rank * per:(mesh.rank + 1) * per]
    return out


def replicate(mesh: Optional[Mesh], modules) -> None:
    """Broadcast rank 0's parameters and buffers of ``modules``
    into every rank's, in place."""
    if mesh is None:
        return
    with torch.no_grad():
        mesh.broadcast_([t for m in modules
                         for t in list(m.parameters()) + list(m.buffers())])


def _worker(rank: int, entry: str, argv: list, size: int, init: str):
    """One rank of :func:`launch`: the environment torchrun would give it,
    then ``entry(argv)``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(size),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(size))
    os.environ[INIT_ENV] = init
    module, name = entry.split(":")
    import importlib
    getattr(importlib.import_module(module), name)(argv)


def launch(entry: str, argv: list, n: int) -> bool:
    """Run ``entry`` ("module:function", called with ``argv``) on ``n``
    ranks.  Under torchrun (``WORLD_SIZE`` set) or with ``n`` = 1 this
    process is a rank itself and ``launch`` returns False: the caller goes
    on.  Else it spawns ``n`` workers that meet through a file in a fresh
    temporary directory, waits for all of them (one failing raises) and
    returns True."""
    if n == 1 or _env_int("WORLD_SIZE") is not None \
            or os.environ.get(INIT_ENV):
        return False
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="vanerf_dist_") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        mp.start_processes(_worker, args=(entry, list(argv), n, init),
                           nprocs=n, join=True, start_method="spawn")
    return True

