"""Train / evaluate VANeRF on one GPU: the counterpart of ``train.py``.

Usage (the reference's flags, plus ``--device``):
  python -m vanerf_tpu_torch.train --config ./configs/vanerf.json  # train
  python -m vanerf_tpu_torch.train --config ./configs/vanerf.json \\
      --run_val --model_ckpt EXPERIMENTS/vanerf/ckpts                # eval
  python -m vanerf_tpu_torch.train --config ... --synthetic_data \\
      --device cpu                                       # on the CPU

Runs on the card unless ``--device cpu`` is given; there is no fallback.
``--synthetic_data`` runs on the built-in fixture, so the whole pipeline
runs without InterHand2.6M.  ``--model_ckpt`` takes a port checkpoint
directory, a reference-layout Lightning ``model.ckpt`` or a
``tools/convert_reference_ckpt.py`` pickle.  ``--num_gpus`` other than 1
raises: multi-GPU is not ported.
"""

from __future__ import annotations

import os


def main(argv=None):
    """Run the CLI; returns the final train state."""
    import torch

    from vanerf_tpu_torch import config as vconfig
    from vanerf_tpu_torch.data import SyntheticDataset, to_torch
    from vanerf_tpu_torch.device import resolve_device
    from vanerf_tpu_torch.losses import VGGLoss
    from vanerf_tpu_torch.models import DiscriminatorVis, VANeRF, init_like_flax
    from vanerf_tpu_torch.training import create_train_state, make_train_step
    from vanerf_tpu_torch.training.checkpoints import restore_any
    from vanerf_tpu_torch.training.loop import collate_numpy, fit

    parser = vconfig.create_parser()
    args = parser.parse_args(argv)
    vconfig.resolve_flags(args)
    if args.num_gpus != 1:
        raise NotImplementedError(
            f"--num_gpus {args.num_gpus}: multi-GPU training is not ported "
            "(ROADMAP.md queue 1 item 9)")
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = vconfig.load_cfg(args.config)
    cfg["dataset"]["data_root"] = args.data_root
    if getattr(args, "in_the_wild", False):
        # render-from-estimated-meshes eval: routes to --run_val
        # (resolve_flags) AND switches the dataset to InTagHand-predicted
        # meshes (dataset.py:485-496)
        cfg["dataset"]["use_intag_preds"] = True
    if args.out_dir is not None:
        cfg["out_dir"] = args.out_dir
    cfg["expname"] = cfg.get("expname", "default")
    save_dir = os.path.join(cfg["out_dir"], cfg["expname"])
    vconfig.save_config(save_dir, cfg)

    # ---- dataset ----
    if args.synthetic_data:
        scfg = cfg["dataset"].get("synthetic_cfg", {})
        ds_kw = {k: scfg[k] for k in ("H", "W", "subdiv", "n_cams")
                 if k in scfg}
        ds_kw["num_input_view"] = cfg["dataset"].get("num_input_view", 1)
        ds_kw["device"] = dev
        ds_train = SyntheticDataset(n_frames=scfg.get("n_frames", 4),
                                    split="train", **ds_kw)
        ds_test = SyntheticDataset(n_frames=2, split="test", **ds_kw)
    else:
        from vanerf_tpu_torch.data.interhand import InterHandDataset
        ds_train = InterHandDataset.from_config(cfg["dataset"], "train", cfg)
        ds_test = InterHandDataset.from_config(cfg["dataset"], "test", cfg)
    faces = ds_train.faces
    num_v = ds_train.num_v

    per_device_bs = cfg["training"].get("train_batch_size", 1)
    global_bs = args.num_gpus * per_device_bs

    def collate(items):
        return to_torch(collate_numpy(items, faces=faces), dev)

    sample_batch = collate_numpy([ds_train[i % len(ds_train)]
                                  for i in range(global_bs)], faces=faces)
    n_views = cfg["dataset"].get("num_input_view", 1)
    model = VANeRF.from_config(cfg, num_v=num_v,
                               image_hw=sample_batch["src_img"].shape[1:3])
    init_like_flax(model, torch.Generator().manual_seed(0))
    disc = DiscriminatorVis()
    init_like_flax(disc, torch.Generator().manual_seed(1))
    model, disc = model.to(dev), disc.to(dev)
    state = create_train_state(model, disc, cfg,
                               steps_per_epoch=len(ds_train))

    # auto-resume (train.py:38-44 semantics); --model_ckpt accepts a port
    # checkpoint dir, a reference model.ckpt or a converted pickle
    ckpt_dir = os.path.join(save_dir, "ckpts")
    restored, step = restore_any(args.model_ckpt or ckpt_dir, state)
    if restored is not None:
        state = restored
        print(f"Resumed from step {step}")

    vgg = VGGLoss()
    if not vgg.pretrained:
        # as the JAX package: fixed-seed random VGG features stand in for
        # the pretrained torchvision weights (vgg_random_init in reports)
        import logging
        logging.getLogger("vanerf_tpu_torch").warning(
            "VGGLoss: vgg_random_init=true (no VANERF_VGG19_NPZ)")
        init_like_flax(vgg.vgg_net, torch.Generator().manual_seed(19))
    vgg = vgg.to(dev)
    step_fn = make_train_step(model, disc, cfg, vgg, n_views=n_views)

    if args.run_val:
        from vanerf_tpu_torch.eval_loop import run_test
        spe = max(1, len(ds_train) // global_bs)
        run_test(model, state, ds_test, cfg, save_dir, n_views=n_views,
                 epoch=int(state.step) // spe)
        return state

    if args.synthetic_data:
        ds_val = SyntheticDataset(n_frames=1, split="test", **ds_kw)
    else:
        from vanerf_tpu_torch.data.interhand import InterHandDataset
        ds_val = InterHandDataset.from_config(cfg["dataset"], "val", cfg)
    from vanerf_tpu_torch.eval_loop import make_val_fn
    val_fn = make_val_fn(model, disc, ds_val, cfg, vgg, n_views=n_views)

    gen = torch.Generator(device=dev).manual_seed(1)
    prof = None
    if args.profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    state = fit(step_fn, state, ds_train, collate, cfg=cfg,
                save_dir=save_dir, generator=gen,
                val_fn=None if args.fast_dev_run else val_fn,
                fast_dev_run=args.fast_dev_run, batch_size=global_bs)
    if prof is not None:
        prof.stop()
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir,
                                              "fit.trace.json"))
    print("Training done at step", int(state.step))
    return state


if __name__ == "__main__":
    main()
