"""Batch generation CLI for the PyTorch port (fake data only, for now).

    python -m bevgen_torch.scripts.generate preset=argoverse_muse_7cam \\
        batch_size=2 fake=2 seed=0 device=cuda out=output/torch_generate

Runs `fake=N` batches of the fake-batch fixture through
`BEVGenPipeline.generate_fn` with seeded random weights and writes one
`batch_XXXX.npz` per batch into `out` with the decode `ids`
(b, cam, h, w) and the `images` (b, cam, H, W, 3). Other `key=value`
arguments override the preset by dotted path (`transformer.num_layers=2`,
`muse.sample_iterations=8`). Loading a dataset and a checkpoint comes in a
later version.
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


def main(argv: Optional[List[str]] = None) -> int:
    import torch
    from bevgen_torch.core.config import PRESETS, apply_overrides
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.generate import BEVGenPipeline

    args = parse_argv(sys.argv[1:] if argv is None else argv)
    preset = args.pop("preset", "argoverse_muse_7cam")
    if preset not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r}; one of {sorted(PRESETS)}")
    batch_size = int(args.pop("batch_size", 1))
    fake = int(args.pop("fake", 1))
    if fake < 1:
        raise SystemExit("only fake data is supported yet: pass fake=N, N >= 1")
    seed = int(args.pop("seed", 0))
    device = args.pop("device", "cuda")
    out_dir = args.pop("out", os.path.join("output", "torch_generate"))
    cfg = apply_overrides(PRESETS[preset](), args)

    pipe = BEVGenPipeline.create(cfg, device=device).init_params(seed)
    os.makedirs(out_dir, exist_ok=True)
    gen = torch.Generator(device=pipe.device).manual_seed(seed)
    for i in range(fake):
        batch = fake_batch(cfg, batch_size, seed=seed + i)
        t0 = time.perf_counter()
        images, ids = pipe.generate_fn(batch["segmentation"],
                                       batch["intrinsics_inv"],
                                       batch["extrinsics_inv"], gen)
        images = images.float().cpu().numpy()
        dt = time.perf_counter() - t0
        path = os.path.join(out_dir, f"batch_{i:04d}.npz")
        np.savez(path, ids=ids.cpu().numpy(), images=images)
        print(f"[generate] batch {i}: {images.shape[0] * images.shape[1]} "
              f"images in {dt:.3f} s -> {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
