"""Where the time of one `generate_fn` goes on the card.

    python -m bevgen_torch.scripts.profile_generate preset=argoverse_muse_7cam \\
        batch_size=2 seed=0 out=profile_generate.json
    python -m bevgen_torch.scripts.profile_generate pipeline=ar \\
        batch_size=2 out=profile_generate_ar.json
    python -m bevgen_torch.scripts.profile_generate transformer.use_fused_glue=true
    python -m bevgen_torch.scripts.profile_generate quant=int8

Builds the pipeline (`pipeline=muse`, default, or `pipeline=ar`, whose
default preset is nuscenes_ar and which decodes KV-cached with top_k=100)
with seeded random weights (`quant=int8`: then its `quantized()` int8 form,
whose int8 kernels are a category of their own), runs one warm-up generate,
then traces one more
with `torch.profiler` (CPU and CUDA activities for MUSE; CUDA alone for AR,
whose generate launches some 800,000 kernels).
Prints the wall time, the device's busy time (union of its kernel and copy
intervals) and idle share, the device time by category (the attention
kernels, the glue kernels, matrix products, convolutions, the rest) and
the top kernels;
writes the same as JSON to `out`. Needs a CUDA device.
`config=`/`preset=`, `modes=` and dotted overrides (`batch_size=`,
`seed=`, `transformer.num_layers=2`) build the config (`scripts/cli.py`);
any other argument exits.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from typing import List, Optional


def category(name: str) -> str:
    n = name.lower()
    if "attention_fwd_kernel" in n:
        return "attention forward kernel"
    if "block_sparse_fwd_kernel" in n:
        return "block-sparse attention forward kernel"
    if "block_sparse_bwd" in n:
        return "block-sparse attention backward kernels"
    if "decode_attention_kernel" in n:
        return "decode attention kernel"
    if "attn_bwd" in n:
        return "attention backward kernels"
    if "glue_" in n:
        return "glue kernels (residual/GEGLU + LayerNorm)"
    if any(t in n for t in ("quantize_static_kernel", "quantize_dynamic_kernel",
                            "int8_epilogue_kernel", "w8_gemv_kernel",
                            "w8_gemm_bf16_kernel")):
        return "int8 kernels (quantize, epilogue, w8_linear)"
    if any(t in n for t in ("gemm", "cutlass", "xmma", "cublas", "gemv", "nvjet")):
        if any(t in n for t in ("s8", "i8", "imma", "int8")):
            return "matmul int8 (torch._int_mm)"
        return "matmul"
    if any(t in n for t in ("conv", "cudnn", "implicit_convolve", "winograd")):
        return "conv"
    if "multi_tensor_apply" in n:
        return "optimizer (multi-tensor kernels)"
    if "memcpy" in n or "memset" in n:
        return "copy"
    return "other (elementwise, norms, reductions, sort)"


def busy_us(spans) -> float:
    """The length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy if cur_e is None else busy + cur_e - cur_s


def device_summary(prof, wall_s: float, top: int = 20) -> dict:
    """From a torch.profiler trace of a window that ends in a synchronise:
    the device's busy time (union of its kernel and copy intervals), its
    idle share of the wall time, device time by category and the top
    kernels."""
    from torch.autograd import DeviceType
    # device events, without the ranges of user annotations (such as
    # `Optimizer.step#AdamW.step`), which span kernels counted on their own
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    by_cat = defaultdict(float)
    by_name = defaultdict(lambda: [0, 0.0])
    for e in kernels:
        by_cat[category(e.name)] += e.device_time_total
        by_name[e.name][0] += 1
        by_name[e.name][1] += e.device_time_total
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_ms": wall_s * 1e3, "device_busy_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e3 / (wall_s * 1e3),
        "kernel_launches": len(kernels),
        "by_category_ms": {k: v / 1e3 for k, v in
                           sorted(by_cat.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n[:120], "count": c, "ms": t / 1e3}
                        for n, (c, t) in rows],
    }


def print_summary(result: dict, label: str) -> None:
    print(f"[profile] {result['device']} {label}: wall "
          f"{result['wall_ms']:.1f} ms, device busy "
          f"{result['device_busy_ms']:.1f} ms, idle share "
          f"{result['device_idle_share']:.3f}, {result['kernel_launches']} "
          f"device events")
    for k, v in result["by_category_ms"].items():
        print(f"[profile]   {k:45s} {v:9.2f} ms")
    for r in result["top_kernels"]:
        print(f"[profile]   {r['count']:6d} x {r['ms']:9.2f} ms  {r['name'][:90]}")


def main(argv: Optional[List[str]] = None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.scripts import cli

    args = cli.parse_argv(sys.argv[1:] if argv is None else argv)
    ar = cli.pop_pipeline_kind(args)
    preset = args.get("config") or args.get("preset", cli.default_preset(ar))
    cfg, args = cli.build_config(args, cli.default_preset(ar))
    batch_size = cfg.batch_size or 2
    seed = cfg.seed
    out = args.pop("out", "profile_generate.json")
    top = int(args.pop("top", 20))
    quant = cli.pop_quant(args)
    if args:
        raise SystemExit(f"unknown argument(s): {sorted(args)}")

    pipe = (ARPipeline if ar else BEVGenPipeline).create(
        cfg, device="cuda").init_params(seed)
    pipe = cli.apply_quant(pipe, quant, batch_size)
    batch = fake_batch(cfg, batch_size, seed=seed)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    pipe.generate_fn(*inputs, torch.Generator("cuda").manual_seed(seed))
    torch.cuda.synchronize()

    activities = ([ProfilerActivity.CUDA] if ar else
                  [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        pipe.generate_fn(*inputs, torch.Generator("cuda").manual_seed(seed + 1))
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    summary = device_summary(prof, wall_s, top)
    print(f"[profile] trace summarised in {time.perf_counter() - t0:.1f} s")

    result = {"device": torch.cuda.get_device_name(0), "preset": preset,
              "pipeline": "ar" if ar else "muse", "quant": quant,
              "batch_size": batch_size, **summary}
    print_summary(result, f"{preset} b={batch_size} quant={quant}")
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
