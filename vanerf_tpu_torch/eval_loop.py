"""Test/eval loop: full-image renders + metric aggregation + YAML report
(port of ``vanerf_tpu/eval_loop.py``).

Parity target: ``test_step``/``test_epoch_end`` (reference
``src/model.py:575-597, 110-121``): render each test frame at full
resolution with the tiled renderer, score it with the Evaluator, and
write a ``test_{name}_{epoch}_{step}.yml`` of the means.  The report is a
flat mapping of floats and bools, written in ``yaml.dump``'s form without
the ``yaml`` package.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

from . import losses as L
from .data.synthetic import to_torch
from .evaluator import Evaluator
from .models.discriminator import g_nonsaturating_loss
from .renderer import (plan_tile_group, render_full_image, resolve_tier,
                       soa_points_mode)
from .training.loop import collate_numpy, sample_loader


def _device_of(model) -> torch.device:
    return next(model.parameters()).device


def make_val_fn(model, disc, dataset, cfg: dict, vggloss, n_views: int = 1,
                max_items: int = None):
    """Validation hook: full-image renders + losses + the image strip.

    Parity with ``validation_step`` (reference ``model.py:547-573``): logs
    a horizontal strip [src | gt | render | denseposes | mask | gt-vis |
    D(real)-vis | D(fake)-vis] and aggregates ``val_total_loss`` (the
    checkpoint-selection metric) and the ``val/*`` components.
    """
    lambdas = cfg["models"]["VANeRF"].get("lambdas", {})
    n = max_items or cfg["dataset"].get("val_cfg", {}).get("max_len", 2)
    n = min(n, len(dataset))
    faces = dataset.faces

    @torch.no_grad()
    def val_fn(state, step, logger):
        dev = _device_of(model)
        losses, comps = [], []
        for i in range(n):
            item = dataset[i]
            if item is None:
                continue
            batch_np = collate_numpy([item], faces=faces)
            batch = to_torch(batch_np, dev)
            H = int(batch["src_img"].shape[1])
            level = max(1, int(math.log2(H)) - 5)
            out = render_full_image(model, batch, level=level,
                                    n_views=n_views, compute_vis_map=True)
            out["tex_cal"] = out["tex_fg"]
            out["tex_cal_fine"] = out["tex_fg_fine"]
            out["tar_img"] = batch["tar_img"]
            loss, err = L.compute_error(out, lambdas, vggloss)

            rendered = out["tex_fg_fine"].clamp(0.0, 1.0)
            fake_pred, fake_vis = disc(out["img_in"], out["input_densepose"],
                                       out["tar_densepose"], rendered)
            real_pred, real_vis = disc(out["img_in"], out["input_densepose"],
                                       out["tar_densepose"], batch["tar_img"])
            loss = loss + g_nonsaturating_loss(fake_pred)
            losses.append(float(loss))
            comps.append({k: float(v) for k, v in err.items()
                          if np.ndim(v) == 0})

            if i == 0 and logger is not None:
                def g(x):
                    x = (x.float().cpu().numpy() if torch.is_tensor(x)
                         else np.asarray(x))[0]
                    if x.shape[-1] == 1:
                        x = np.repeat(x, 3, -1)
                    return np.clip(x, 0, 1)
                strip = np.concatenate([
                    g(batch_np["src_img"][None, 0]), g(batch_np["tar_img"]),
                    g(rendered), g(out["input_densepose"]),
                    g(out["tar_densepose"]), g(batch_np["tar_mask"]),
                    g(out["vis_img"]), g(real_vis), g(fake_vis)], axis=1)
                logger.log_image(step, "val/renderings", strip)
        if not losses:
            return {}
        # per-component val losses with the reference's val/ prefix
        # (ref model.py:570-572 logs every err_dict entry)
        logs = {f"val/{k}": float(np.mean([c[k] for c in comps]))
                for k in comps[0]}
        logs["val_total_loss"] = float(np.mean(losses))
        return logs

    return val_fn


def run_test(model, state, dataset, cfg: dict, save_dir: str,
             n_views: int = 1, max_items: Optional[int] = None,
             tag: Optional[str] = None, mesh=None,
             epoch: Optional[int] = None):
    """Score ``dataset`` (or its first ``max_items``) and write the
    report; returns the report's mapping.  The metrics run on the
    model's device."""
    test_dst_name = tag or cfg.get("test_dst_name", "test")
    result_dir = os.path.join(save_dir, f"images_{test_dst_name}")
    evaluator = Evaluator(result_dir, device=_device_of(model))
    faces = dataset.faces

    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    # worker processes load items ahead of the renders where
    # training.val_num_workers > 1
    loader = sample_loader(dataset, [[i] for i in range(n)],
                           cfg["training"].get("val_num_workers", 1))
    return _run_test_inner(loader, model, state, cfg, save_dir, evaluator,
                           faces, n_views, mesh, test_dst_name, epoch or 0)


@torch.no_grad()
def _run_test_inner(loader, model, state, cfg, save_dir, evaluator,
                    faces, n_views, mesh, test_dst_name, epoch=0):
    dev = _device_of(model)
    n = len(loader)
    scores = []
    for i, items in enumerate(loader):
        if not items:
            continue
        item = items[0]
        batch_np = collate_numpy([item], faces=faces)
        batch = to_torch(batch_np, dev)
        H = int(batch["src_img"].shape[1])
        level = max(1, int(math.log2(H)) - 5)   # 256 -> 3 (model.py:581)
        n_tiles = 4 ** (level - 1)
        tg, use_mesh = plan_tile_group(
            n_tiles, cfg["training"].get("eval_tile_group", 1), mesh)
        out = render_full_image(model, batch, level=level, n_views=n_views,
                                tile_group=tg, mesh=use_mesh)
        pred = np.clip(out["tex_fg_fine"][0].float().cpu().numpy(), 0.0, 1.0)
        gt = batch_np["tar_img"][0]
        # SSIM crop region: ray-AABB mask when the dataset provides it
        # (evaluator.py:21-23), else the foreground mask
        if "mask_at_box" in batch_np:
            mask_at_box = batch_np["mask_at_box"][0] > 0
        else:
            mask_at_box = batch_np["tar_mask"][0, ..., 0] > 0
        s = evaluator.compute_score(
            pred, gt, input_imgs=batch_np["src_img"],
            mask_at_box=mask_at_box,
            human_idx=str(item.get("human_idx", 0)),
            frame_index=str(item.get("frame_index", i)),
            view_index=str(item.get("cam_ind", 0)))
        scores.append(s)
        print(f"[{i+1}/{n}]", {k: round(v, 4) for k, v in s.items()})

    results = {k: float(np.nanmean([s[k] for s in scores]))
               for k in scores[0]}
    # weight provenance: lpips is NaN until AlexNet weights are converted,
    # and a random-init VGG changes the training objective
    results["lpips_pretrained"] = evaluator.lpips_fn is not None
    results["vgg_random_init"] = not bool(
        os.environ.get("VANERF_VGG19_NPZ", ""))
    # approximate-tier provenance, gated as the renderer gates the tiers
    # (vanerf_tpu/eval_loop.py:158-190): every tier is off under the fused
    # kernels, the budget tiers also under SoA and with n_views != 1;
    # `*_requested` keeps what the environment / config asked for
    fused = bool(getattr(model, "sp_conv", False)
                 or int(os.environ.get("VANERF_FUSED_MLP", "0") or 0))
    soa = soa_points_mode() != 0

    def record(name, env, default, gated_off):
        req = resolve_tier(env, getattr(model, name, default), False)
        applied = 0.0 if gated_off else req
        if req and applied != req:
            results[f"{name}_requested"] = req
        if applied or name == "far_tau":
            results[name] = applied

    record("far_tau", "VANERF_FAR_TAU", 0.02, fused)
    record("far_skip", "VANERF_FAR_SKIP", 0.0, fused or soa)
    record("far_net", "VANERF_FAR_NET", 0.0, fused or soa or n_views != 1)
    record("far_tnet", "VANERF_FAR_TNET", 0.0, fused or soa or n_views != 1)
    step = int(state.step)
    # test_{name}_{epoch}_{step}.yml (ref model.py:110-121)
    path = os.path.join(save_dir, f"test_{test_dst_name}_{epoch}_{step}.yml")
    with open(path, "w") as f:
        f.write(dump_flat_yaml(results))
    print("Results saved in", path)
    print(results)
    return results


def _yaml_scalar(v) -> str:
    """One float / bool / int as ``yaml.dump`` writes it."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    v = float(v)
    if v != v:
        return ".nan"
    if v in (float("inf"), float("-inf")):
        return ".inf" if v > 0 else "-.inf"
    text = repr(v).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def dump_flat_yaml(mapping: dict) -> str:
    """A flat mapping of str keys to floats / bools in ``yaml.dump``'s
    block form: sorted ``key: value`` lines."""
    return "".join(f"{k}: {_yaml_scalar(mapping[k])}\n"
                   for k in sorted(mapping))
