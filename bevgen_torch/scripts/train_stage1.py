"""Stage-1 VQ autoencoder training CLI of the PyTorch port, on one device.

    python -m bevgen_torch.scripts.train_stage1 preset=argoverse_muse \\
        model=cam|bev steps=1000 batch_size=8 base_lr=4.5e-6 \\
        ckpt_dir=ckpts [disc=true perceptual_weights=lpips.npz]

The counterpart of `bevgen_tpu/scripts/train_stage1.py`. model=cam trains
the RGB VQ-GAN (the preset's `first_stage`; with `disc=true`, the default,
against a PatchGAN discriminator, plus an LPIPS term when
`perceptual_weights` names an npz that exists; without a discriminator on
L1 + codebook loss); model=bev trains the segmentation VQ-VAE
(`cond_stage`) on BCE. The learning rate is `scaled_lr(base_lr,
batch_size)`: batch_size is the global image batch of this one-device loop.
Data: the port's `ArgoverseDataset` when ARGOVERSE_DATA_DIR is set
(per-frame for cam, multi-camera for bev, `augment` on by default), else
seeded fake batches. A cam batch is a random subset of the batch's flattened
camera images. Parameters and compute are fp32.

Options: `model`, `steps`, `batch_size`, `base_lr`, `disc`,
`perceptual_weights`, `ckpt_dir` (tags of the autoencoder's parameters and
optimizer state, on `CheckpointManager`'s interval and once at the end),
`log_every`, `image_every` (a reconstruction PNG under `run_dir`), `run_dir`,
`seed`, `augment`, `device` (default cuda; raises without one; or
`platform=cpu|gpu`, `devices=1`, `scripts/cli.py:pop_device`) and dotted
preset overrides. Prints one JSON line per logged step, with
`steps_per_sec`, then `done`. Two departures from the JAX CLI: an unknown
argument exits (it prints and ignores one), and a set ARGOVERSE_DATA_DIR
without a tree raises FileNotFoundError (it falls back to fake batches).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Iterator, List, Optional

import numpy as np


def _forever(loader) -> Iterator:
    """The loader's batches, epoch after epoch (its shuffle advances)."""
    if len(loader) == 0:
        raise SystemExit(f"the dataset has fewer than batch_size="
                         f"{loader.batch_size} samples")
    while True:
        yield from loader


def perceptual_term(metric):
    """lpips_fn(x, xrec) -> (b,) for the VQ-GAN step: the images are
    mean/std-normalised and the VGG head takes [-1, 1], so they are taken
    back to [0, 1] and scaled, without a clip (a clip would stop the
    gradients of an out-of-range reconstruction)."""
    import torch
    from bevgen_torch.data.camera_geometry import ARGOVERSE_MEAN, ARGOVERSE_STD
    dev = next(metric.model.parameters()).device
    mean = torch.as_tensor(ARGOVERSE_MEAN, device=dev)
    std = torch.as_tensor(ARGOVERSE_STD, device=dev)
    return lambda a, b: metric.model((a * std + mean) * 2 - 1,
                                     (b * std + mean) * 2 - 1)


def save_reconstruction(model, x, which: str, path: str) -> None:
    """Input and reconstruction side by side, one row per sample."""
    import torch
    from bevgen_torch.data.camera_geometry import denormalize_image
    from bevgen_torch.utils.image import Im, make_grid
    from bevgen_torch.utils.viz import viz_bev
    with torch.no_grad():
        rec = model(x)[0].float()
    xs = x.float().cpu().numpy()
    if which == "cam":
        tiles = [denormalize_image(a) for pair in zip(xs, rec.cpu().numpy())
                 for a in pair]
    else:
        labels = model.reconstruct_labels(rec).cpu().numpy()
        tiles = [viz_bev(a).np for pair in zip(xs, labels) for a in pair]
    Im(make_grid(tiles, nrow=2)).save(path)


def run(argv: List[str]):
    """Train and return the final `Stage1TrainState`."""
    import torch
    from bevgen_torch.core.device import resolve_device
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.metrics.quality import LPIPSMetric
    from bevgen_torch.models.discriminator import NLayerDiscriminator
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage1.vq import VQModel, VQSegmentationModel
    from bevgen_torch.scripts.cli import (build_config, parse_argv,
                                          pop_device, pop_flag)
    from bevgen_torch.training import stage1_trainer
    from bevgen_torch.training.checkpoints import CheckpointManager
    from bevgen_torch.training.optim import scaled_lr
    from bevgen_torch.training.preemption import PreemptionGuard

    cfg, args = build_config(parse_argv(argv), "argoverse_muse")
    which = args.pop("model", "cam")
    if which not in ("cam", "bev"):
        raise SystemExit(f"unknown model={which!r} (cam|bev)")
    steps = int(args.pop("steps", 100))
    batch_size = cfg.batch_size or 4
    use_disc = pop_flag(args, "disc", "true" if which == "cam" else "false")
    perceptual_npz = args.pop("perceptual_weights", None)
    ckpt_dir = args.pop("ckpt_dir", None)
    log_every = int(args.pop("log_every", 20))
    image_every = int(args.pop("image_every", 0))
    run_dir = args.pop("run_dir", "output/stage1")
    augment = pop_flag(args, "augment", "true")
    device = pop_device(args)
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    dev = resolve_device(device)
    seed = cfg.seed

    s1cfg = cfg.first_stage if which == "cam" else cfg.cond_stage
    lr = scaled_lr(cfg.base_lr, batch_size)
    print(f"lr = {lr:.3e} (base {cfg.base_lr} x batch {batch_size})")

    real = None
    if os.environ.get("ARGOVERSE_DATA_DIR"):
        from bevgen_torch.data.argoverse import ArgoverseDataset
        from bevgen_torch.data.datamodule import DataLoader
        ds = ArgoverseDataset(
            split="train", cam_res=s1cfg.cam_res,
            multi_camera=which != "cam",
            augment_cam_img=augment and which == "cam",
            augment_bev_img=augment and which == "bev", seed=seed)
        real = _forever(DataLoader(ds, batch_size, shuffle=True, seed=seed,
                                   drop_last=True, num_workers=2))
        print(f"training on ArgoverseDataset ({len(ds)} samples, "
              f"{'per-frame' if which == 'cam' else 'multi-camera'})")
    batch_rng = np.random.default_rng(seed)

    def get_batch(i: int) -> np.ndarray:
        fb = next(real) if real is not None else fake_batch(
            cfg, batch_size, seed=seed + i)
        if which == "bev":
            return np.asarray(fb["segmentation"], np.float32)
        img = np.asarray(fb["image"], np.float32)
        flat = img.reshape((-1,) + img.shape[2:])     # (scenes * cams, ...)
        if flat.shape[0] > batch_size:
            # a random subset, so that every camera is trained on
            flat = flat[batch_rng.choice(flat.shape[0], batch_size,
                                         replace=False)]
        return flat

    lpips_fn = None
    if perceptual_npz:
        metric = LPIPSMetric(perceptual_npz, device=dev)
        if metric.available:
            lpips_fn = perceptual_term(metric)
        else:
            print(f"LPIPS weights not found at {perceptual_npz}; "
                  "training without perceptual loss")

    model = (VQModel if which == "cam" else VQSegmentationModel)(s1cfg)
    init_weights(model, seed).to(dev)
    disc = None
    if which == "cam" and use_disc:
        disc = init_weights(NLayerDiscriminator(
            in_channels=s1cfg.in_channels), seed + 1).to(dev)
        step_fn = stage1_trainer.make_vqgan_train_step(
            lpips_fn, perceptual_weight=1.0 if lpips_fn else 0.0)
    elif which == "bev":
        step_fn = stage1_trainer.make_seg_train_step()
    else:
        step_fn = stage1_trainer.make_nodisc_train_step()
    state = stage1_trainer.create_stage1_state(model, disc, lr)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    t0 = time.perf_counter()
    with PreemptionGuard() as guard:
        for i in range(steps):
            if guard.should_stop:
                print(json.dumps({"step": state.step, "preempted": True}))
                break
            x = torch.as_tensor(get_batch(i)).to(dev)
            metrics = step_fn(state, x)
            if (i + 1) % log_every == 0 or i == 0:
                m = {k: round(float(v), 4) for k, v in metrics.items()}
                m["steps_per_sec"] = round(
                    (i + 1) / (time.perf_counter() - t0), 3)
                print(json.dumps({"step": i + 1, **m}), flush=True)
            if image_every and (i + 1) % image_every == 0:
                save_reconstruction(model, x, which,
                                    f"{run_dir}/recon_{i + 1:06d}.png")
            if mgr is not None:
                mgr.save_step(i + 1, state)
    # the final tag is the completed steps; with none there is nothing
    # worth saving (a step_00000000 tag would take LATEST from a real one)
    if mgr is not None and state.step > 0:
        mgr.save_step(state.step, state, force=True)
    print("done")
    return state


def main(argv: Optional[List[str]] = None) -> int:
    run(sys.argv[1:] if argv is None else argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
