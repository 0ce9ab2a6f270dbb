"""Where the time of one `generate_fn` goes on the card.

    python -m bevgen_torch.scripts.profile_generate preset=argoverse_muse_7cam \\
        batch_size=2 seed=0 out=profile_generate.json

Builds the pipeline with seeded random weights, runs one warm-up generate,
then traces one more with `torch.profiler` (CPU and CUDA activities).
Prints the wall time, the device's busy time (union of its kernel and copy
intervals) and idle share, the device time by category (the cosine
attention kernel, matrix products, convolutions, the rest) and the top
kernels; writes the same as JSON to `out`. Needs a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import List, Optional


def category(name: str) -> str:
    n = name.lower()
    if "cosine_attention" in n:
        return "cosine_attention kernel"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "cublas", "gemv", "nvjet")):
        return "matmul"
    if any(t in n for t in ("conv", "cudnn", "implicit_convolve", "winograd")):
        return "conv"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other (elementwise, norms, reductions, sort)"


def main(argv: Optional[List[str]] = None) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from bevgen_torch.core.config import PRESETS, apply_overrides
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.scripts.generate import parse_argv

    args = parse_argv(sys.argv[1:] if argv is None else argv)
    preset = args.pop("preset", "argoverse_muse_7cam")
    batch_size = int(args.pop("batch_size", 2))
    seed = int(args.pop("seed", 0))
    out = args.pop("out", "profile_generate.json")
    top = int(args.pop("top", 20))
    cfg = apply_overrides(PRESETS[preset](), args)

    pipe = BEVGenPipeline.create(cfg, device="cuda").init_params(seed)
    batch = fake_batch(cfg, batch_size, seed=seed)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    pipe.generate_fn(*inputs, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.generate_fn(*inputs, torch.Generator("cuda").manual_seed(seed + 1))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0

    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_cat = defaultdict(float)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_cat[category(e.name)] += e.device_time_total
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.device_time_total
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    result = {
        "device": torch.cuda.get_device_name(0), "preset": preset,
        "batch_size": batch_size, "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e3 / (wall_s * 1e3),
        "kernel_launches": len(kernels),
        "by_category_ms": {k: v / 1e3 for k, v in
                           sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "count": c, "ms": t / 1e3}
                        for n, (c, t) in rows],
    }
    print(f"[profile] {result['device']} {preset} b={batch_size}: wall "
          f"{result['wall_ms']:.1f} ms, device busy "
          f"{result['device_busy_ms']:.1f} ms, idle share "
          f"{result['device_idle_share']:.3f}, {len(kernels)} device events")
    for k, v in result["by_category_ms"].items():
        print(f"[profile]   {k:45s} {v:9.2f} ms")
    for r in result["top_kernels"]:
        print(f"[profile]   {r['count']:6d} x {r['ms']:9.2f} ms  {r['name'][:90]}")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
