"""Batch generation CLI for the PyTorch port (fake data only, for now).

    python -m bevgen_torch.scripts.generate preset=argoverse_muse_7cam \\
        batch_size=2 fake=2 seed=0 device=cuda out=output/torch_generate
    python -m bevgen_torch.scripts.generate pipeline=ar preset=nuscenes_ar \\
        transformer.num_layers=2 device=cpu fake=1
    python -m bevgen_torch.scripts.generate preset=argoverse_muse_7cam \\
        batch_size=2 fake=1 ckpt_path=pretrained.ckpt
    python -m bevgen_torch.scripts.generate preset=argoverse_muse_7cam \\
        fake=1 ckpt_path=ckpt/step_00001000 ema=true

Runs `fake=N` batches of the fake-batch fixture through the serving
pipeline and writes one `batch_XXXX.npz` per batch into `out` with the
decode `ids` (b, cam, h, w) and the `images` (b, cam, H, W, 3).
`pipeline=muse` (default; preset argoverse_muse_7cam) runs
`BEVGenPipeline.generate_fn`; `pipeline=ar` (default preset nuscenes_ar)
runs `ARPipeline.generate_fn` (top_k 100, temperature 1), KV-cached unless
`cached=false`. The weights are seeded random (`seed`) unless `ckpt_path`
names a checkpoint, loaded over them by
`training/checkpoints.py:load_weights` (as the reference's
`scripts/generate.py` does): one of the reference's torch checkpoints
(`.ckpt`/`.pt`/`.pth`, or a DeepSpeed ZeRO directory) or one of the port's
own tags; `ema=true` loads the tag's `-EMA` sibling (`resolve_ema_path`)
and needs `ckpt_path`. Other `key=value` arguments override the preset by
dotted path (`transformer.num_layers=2`, `muse.sample_iterations=8`).
Loading a dataset comes in a later version.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np


def parse_argv(argv: List[str]) -> Dict[str, str]:
    args = {}
    for a in argv:
        if "=" not in a:
            raise SystemExit(f"expected key=value, got {a!r}")
        k, v = a.split("=", 1)
        args[k.lstrip("-")] = v
    return args


def pop_pipeline(args: Dict[str, str]):
    """Pop `pipeline` (muse|ar) and `preset` (by default the pipeline's own)
    from `args`; returns (is_ar, preset). Exits on an unknown value."""
    from bevgen_torch.core.config import PRESETS
    pipeline = args.pop("pipeline", "muse")
    if pipeline not in ("muse", "ar"):
        raise SystemExit(f"unknown pipeline={pipeline!r} (muse|ar)")
    ar = pipeline == "ar"
    preset = args.pop("preset", "nuscenes_ar" if ar else "argoverse_muse_7cam")
    if preset not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r}; one of {sorted(PRESETS)}")
    return ar, preset


def run(argv: List[str]):
    """The CLI's work: returns the pipeline it served with and the paths of
    the batches it wrote."""
    import torch
    from bevgen_torch.core.config import PRESETS, apply_overrides
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.training.checkpoints import load_weights, resolve_ema_path

    args = parse_argv(argv)
    ar, preset = pop_pipeline(args)
    batch_size = int(args.pop("batch_size", 1))
    fake = int(args.pop("fake", 1))
    if fake < 1:
        raise SystemExit("only fake data is supported yet: pass fake=N, N >= 1")
    seed = int(args.pop("seed", 0))
    device = args.pop("device", "cuda")
    out_dir = args.pop("out", os.path.join("output", "torch_generate"))
    ckpt_path = args.pop("ckpt_path", None)
    use_ema = args.pop("ema", "false").lower() == "true"
    if use_ema and not ckpt_path:
        raise SystemExit("ema=true requires ckpt_path=")
    sample_kw = ({"cached": args.pop("cached", "true").lower() == "true"}
                 if ar else {})
    cfg = apply_overrides(PRESETS[preset](), args)

    pipe = (ARPipeline if ar else BEVGenPipeline).create(
        cfg, device=device).init_params(seed)
    if ckpt_path:
        if use_ema:
            ckpt_path = resolve_ema_path(ckpt_path)
        family = load_weights(ckpt_path, pipe)
        print(f"[generate] loaded {family} weights from {ckpt_path}",
              flush=True)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    paths = []
    for i in range(fake):
        batch = fake_batch(cfg, batch_size, seed=seed + i)
        t0 = time.perf_counter()
        images, ids = pipe.generate_fn(batch["segmentation"],
                                       batch["intrinsics_inv"],
                                       batch["extrinsics_inv"], gen,
                                       **sample_kw)
        images = images.float().cpu().numpy()
        dt = time.perf_counter() - t0
        path = os.path.join(out_dir, f"batch_{i:04d}.npz")
        np.savez(path, ids=ids.cpu().numpy(), images=images)
        paths.append(path)
        print(f"[generate] batch {i}: {images.shape[0] * images.shape[1]} "
              f"images in {dt:.3f} s -> {path}", flush=True)
    return pipe, paths


def main(argv: Optional[List[str]] = None) -> int:
    run(sys.argv[1:] if argv is None else argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
