"""Free-viewpoint orbit video: the counterpart of ``render_dynamic.py``.

Usage (the reference's flags, plus ``--device``):
  python -m vanerf_tpu_torch.render_dynamic --config ./configs/vanerf.json \\
      --model_ckpt EXPERIMENTS/vanerf/ckpts [--synthetic_data] \\
      [--out_dir ...] [--device cpu]

Renders an orbit of ``video_cfg.n_frames`` (default 20) cameras around the
hands with ``get_360cameras`` (the reference's wobble schedule), one
``render_full_image`` a camera, and writes
``<out_dir>/<expname>/video_interhand/{000000..}.png``, ``nvs.gif`` and
``nvs.mp4`` — the reference's three outputs (``model.py:190-207``) — with
the port's own encoders (no imaging library).  Runs on the card unless
``--device cpu`` is given; there is no fallback.  ``--model_ckpt`` takes
what ``vanerf_tpu_torch.train`` takes; without it the seeded initial
weights render.  ``--num_gpus N`` splits each frame's tile group over N
ranks, one process a device (``parallel/``; the command starts them
itself, or runs under torchrun), as the JAX package shards it over its
mesh (``render_dynamic.py:87-100``, the same ``plan_tile_group``); rank 0
writes the files and returns the result.  The GIF's frames last 10 cs each, as the reference meant (the JAX
package's ``imageio.mimsave(duration=0.1)`` writes no delay).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from . import renderer
from .camera_path import get_360cameras
from .evaluator import write_png
from .image_codecs import write_gif
from .video import write_mjpeg_mp4

# the orbit (render_dynamic.py:76-87): the camera ``TRANS`` units from the
# hands' first keypoint, ``znear`` / ``zfar`` 5 units either side of it
TRANS = 10.0
GIF_DELAY_CS = 10
MP4_FPS = 10


def orbit_cameras(batch, n_frames: int):
    """The orbit of ``n_frames`` cameras around ``kpt3d[0, 0]`` at the
    batch's image size (``render_dynamic.py:76-87``)."""
    sc = 1.0
    znear, zfar = (TRANS - 5.0) * sc, (TRANS + 5.0) * sc
    im_w = im_h = int(batch["src_img"].shape[2])
    fstart, fend = im_w * 30, im_w * 0.05
    focal = fstart + 0.01 * (fend - fstart)
    center = np.asarray(torch.as_tensor(batch["kpt3d"]).cpu())[0, 0]
    headpose = np.eye(4, dtype=np.float32)
    headpose[:3, 3] = center
    return get_360cameras(headpose, focal, TRANS, sc, im_w, im_h, znear,
                          zfar, n_frames)


def camera_batch(batch, cam):
    """``batch`` seen from the orbit camera ``cam``
    (``render_dynamic.py:101-107``): (1, 4, 4) ``tar_k`` / ``tar_rt``, 0-d
    ``znear`` / ``zfar``, no target image or mask."""
    dev = batch["src_img"].device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    return dict(batch, tar_k=t(cam["intrinsics"]), tar_rt=t(cam["w2cs"][None]),
                znear=t(cam["znear"]), zfar=t(cam["zfar"]), tar_img=None,
                tar_mask=None)


def frame_level(im_h: int) -> int:
    """The full image's level (``render_dynamic.py:96``): 64x64 tiles."""
    return max(1, int(np.log2(im_h)) - 5)


def to_uint8(tex: torch.Tensor) -> np.ndarray:
    """(1, H, W, 3) render -> (H, W, 3) uint8, truncating as the reference
    does (``render_dynamic.py:111-112``)."""
    img = np.clip(tex.detach().cpu().numpy()[0], 0, 1)
    return (img * 255).astype(np.uint8)


def main(argv=None):
    """Run the CLI; returns a dict with the model, the source batch, the
    orbit cameras, the (level, tile_group) of the renders, the uint8
    frames and the output directory (on rank 0; None elsewhere and where
    it launched the ranks)."""
    from vanerf_tpu_torch import config as vconfig
    from vanerf_tpu_torch.device import resolve_device
    from vanerf_tpu_torch.parallel import launch, make_mesh

    argv = sys.argv[1:] if argv is None else list(argv)
    args = vconfig.create_parser().parse_args(argv)
    mesh = None
    if args.num_gpus != 1:
        resolve_device(args.device)      # no card: raise before spawning
        if launch("vanerf_tpu_torch.render_dynamic:main", argv,
                  args.num_gpus):
            return None
        mesh = make_mesh(args.num_gpus, device=args.device)
    try:
        return _main(args, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, mesh):
    """:func:`main` in one process (``mesh``: its rank, or None)."""
    from vanerf_tpu_torch import config as vconfig
    from vanerf_tpu_torch.data import SyntheticDataset, to_torch
    from vanerf_tpu_torch.device import resolve_device
    from vanerf_tpu_torch.models import DiscriminatorVis, VANeRF, init_like_flax
    from vanerf_tpu_torch.training import create_train_state
    from vanerf_tpu_torch.training.checkpoints import restore_any
    from vanerf_tpu_torch.training.loop import collate_numpy

    lead = mesh is None or mesh.lead
    dev = resolve_device(args.device) if mesh is None else mesh.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = vconfig.load_cfg(args.config)
    if args.out_dir is not None:
        cfg["out_dir"] = args.out_dir
    save_dir = os.path.join(cfg["out_dir"], cfg.get("expname", "default"))

    if args.synthetic_data:
        scfg = cfg["dataset"].get("synthetic_cfg", {})
        ds_kw = {k: scfg[k] for k in ("H", "W", "subdiv", "n_cams")
                 if k in scfg}
        ds = SyntheticDataset(n_frames=1, split="test", device=dev, **ds_kw)
    else:
        from vanerf_tpu_torch.data.interhand import InterHandDataset
        ds = InterHandDataset.from_config(cfg["dataset"], "test_visualize",
                                          cfg)
    batch_np = collate_numpy([ds[0]], faces=ds.faces)
    model = VANeRF.from_config(cfg, num_v=ds.num_v,
                               image_hw=batch_np["src_img"].shape[1:3])
    init_like_flax(model, torch.Generator().manual_seed(0))
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(1))
    model, disc = model.to(dev), disc.to(dev)
    if args.model_ckpt:
        state = create_train_state(model, disc, cfg, steps_per_epoch=10)
        restored, step = restore_any(args.model_ckpt, state)  # in place
        if restored is not None and lead:
            print("Loaded checkpoint at step", step)
    model.eval()
    batch = to_torch(batch_np, dev)

    n_frames = cfg.get("video_cfg", {}).get("n_frames", 20)
    cams = orbit_cameras(batch, n_frames)
    im_h = int(batch["src_img"].shape[1])
    level = frame_level(im_h)
    tg, mesh = renderer.plan_tile_group(
        4 ** (level - 1), cfg.get("training", {}).get("eval_tile_group", 1),
        mesh)

    out_dir = os.path.join(save_dir, "video_interhand")
    frames = []
    for fi, cam in enumerate(cams):
        out = renderer.render_full_image(model, camera_batch(batch, cam),
                                         level=level, tile_group=tg,
                                         mesh=mesh)
        if not lead:
            continue
        os.makedirs(out_dir, exist_ok=True)
        frame = to_uint8(out["tex_fg_fine"])
        write_png(os.path.join(out_dir, f"{fi:06d}.png"), frame)
        frames.append(frame)
        print(f"frame {fi + 1}/{n_frames}")
    if not lead:
        return None
    gif = write_gif(os.path.join(out_dir, "nvs.gif"), frames, GIF_DELAY_CS)
    print("Saved:", gif)
    mp4 = write_mjpeg_mp4(os.path.join(out_dir, "nvs.mp4"), frames,
                          fps=MP4_FPS)
    print("Saved:", mp4)
    return {"model": model, "batch": batch, "cams": cams, "level": level,
            "tile_group": tg, "frames": frames, "out_dir": out_dir}


if __name__ == "__main__":
    main()
