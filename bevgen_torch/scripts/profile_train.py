"""Where the time of one stage-2 train step goes on the card.

    python -m bevgen_torch.scripts.profile_train preset=argoverse_muse_7cam \\
        batch_size=8 seed=0 out=profile_train.json
    python -m bevgen_torch.scripts.profile_train pipeline=ar \\
        batch_size=4 out=profile_train_ar.json
    python -m bevgen_torch.scripts.profile_train transformer.use_fused_glue=true

`pipeline=muse` (default; preset argoverse_muse_7cam, batch 8) builds
MaskGit and runs `training.trainer.make_train_step` (the CLI's step);
`pipeline=ar` (default preset nuscenes_ar, batch 4) builds the SparseGPT
and runs `make_ar_train_step` (the counterpart of the JAX
`scripts/inference.py mode=ar_train`). Both keep fp32 parameters and compute
in bf16, with seeded random weights and fake token batches: two warm-up
steps, then one more traced with `torch.profiler` (CPU and CUDA
activities). Prints the step's wall time, the device's busy time and idle
share, the device time by category (`profile_generate.category`: the
attention forward and backward kernels, the block-sparse ones apart, the
glue kernels, matrix products, optimizer, the rest), the top kernels and the peak device memory of the traced step;
writes the same as JSON to `out`. Needs a CUDA device.
`config=`/`preset=`, `modes=` and dotted overrides (`batch_size=`,
`seed=`, `transformer.num_layers=2`) build the config (`scripts/cli.py`);
any other argument exits.
"""
from __future__ import annotations

import json
import sys
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bevgen_torch.core.device import resolve_device, resolve_dtype
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2.gpt import SparseGPT
    from bevgen_torch.models.stage2.maskgit import MaskGit
    from bevgen_torch.scripts import cli
    from bevgen_torch.scripts.profile_generate import (device_summary,
                                                       print_summary)
    from bevgen_torch.scripts.train_stage2 import fake_batches
    from bevgen_torch.training import optim, trainer

    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    ar = cli.pop_pipeline_kind(args)
    preset = args.get("config") or args.get("preset", cli.default_preset(ar))
    cfg, args = cli.build_config(args, cli.default_preset(ar))
    batch_size = cfg.batch_size or (4 if ar else 8)
    seed = cfg.seed
    out = args.pop("out", "profile_train.json")
    top = int(args.pop("top", 20))
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")
    tf = cfg.transformer
    dev = resolve_device("cuda")
    dtype = resolve_dtype(cfg.dtype)

    if ar:
        model = SparseGPT(tf, dtype=dtype, param_dtype=torch.float32)
    else:
        model = MaskGit(tf, cfg.muse, dtype=dtype, param_dtype=torch.float32)
    init_weights(model, seed).to(dev)
    opt = optim.maskgit_optimizer(model, 1e-4, warmup_steps=1)
    if ar:
        state = trainer.create_ar_train_state(model, opt)
        ar_step = trainer.make_ar_train_step()

        def step(state, batch, gen):  # the AR loss draws nothing
            return ar_step(state, batch)
    else:
        state = trainer.create_train_state(model, opt)
        step = trainer.make_train_step()
    batches = fake_batches(tf, batch_size, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def next_batch():
        return {k: torch.as_tensor(np.asarray(v)).to(dev)
                for k, v in next(batches).items()}

    for _ in range(2):
        step(state, next_batch(), gen)
    batch = next_batch()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    result = {"device": torch.cuda.get_device_name(0), "preset": preset,
              "pipeline": "ar" if ar else "muse", "batch_size": batch_size,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "metrics": {k: float(v) for k, v in metrics.items()},
              **device_summary(prof, wall_s, top)}
    print_summary(result, f"{preset} train step b={batch_size}")
    print(f"[profile] peak memory {result['peak_memory_gb']:.2f} GB; "
          f"metrics {json.dumps(result['metrics'])}")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
