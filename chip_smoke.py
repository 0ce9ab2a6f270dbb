#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`bevgen_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (exit code not 0) when it fails:

  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the serving path, from `bevgen_torch/csrc`,
     with nvcc (one process per source, started together);
  3. kernel vs plain version: the cosine-attention kernel against
     `cosine_attention_reference` (fp32 on the same bf16 inputs) at the
     serving path's shapes, plus an unaligned case with a dropped row and
     a case without bias; times of the kernel, the plain version and
     PyTorch's scaled_dot_product_attention, and the bound from the shapes;
  4. end to end: `argoverse_muse_7cam` at full width (14 layers, width
     1024, 7 cameras) with seeded random weights, batch 2, through
     `BEVGenPipeline.generate_fn`; the kernel's launch count over one
     generate must be (18 + 17) * 14 * 2 = 980;
  5. one full-width transformer forward through the kernel and through the
     plain version, compared by logit cosine similarity and top-1 agreement.

Prints the kernels' JSON line, then the card's name and power limit, and
as its last line `{"ok": true, "device": {...}}`. Without a CUDA device,
or outside a checkout of the repository, it exits with an error and
prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

# Tolerances of the kernel against its plain version (fp32 on the same
# bf16 inputs). The kernel rounds q^ and the softmax weights to bf16
# (relative step 2^-8) and writes bf16 (step 2^-8 of |out| <= max |v|), so
# single outputs may differ by ~1e-2 at |v| ~ 4; the mean error stays an
# order of magnitude below.
MAX_ABS_TOL = 2e-2
MEAN_ABS_TOL = 2e-3
# Full-width transformer logits, kernel vs plain attention, both bf16: the
# difference is bf16 rounding inside attention carried through 14 layers.
LOGIT_COS_MIN = 0.99
TOP1_AGREE_MIN = 0.90

PEAK_BF16_FLOPS = 989e12    # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12        # H100 SXM HBM3 rate


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time per call. A sleep kernel keeps the card busy while the
    host queues the timed calls, so a call shorter than its host-side
    launch cost is not timed as the host's gap between launches."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)   # about 0.2 s at the H100's clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_inputs(B, H, N, M, D, with_bias, keep, seed):
    import torch
    from bevgen_torch.ops.cosine_attention import _l2n
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q_scale = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
    k_scale = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
    q = torch.randn(B, H, N, D, generator=g, device=dev).to(torch.bfloat16)
    k = (_l2n(torch.randn(B, H, M, D, generator=g, device=dev))
         * k_scale).to(torch.bfloat16)
    v = torch.randn(B, H, M, D, generator=g, device=dev).to(torch.bfloat16)
    null_kv = torch.randn(2, H, 1, D, generator=g, device=dev)
    bias = (torch.rand(N, M, generator=g, device=dev) * 2.0
            if with_bias else None)
    keep_t = (None if keep is None
              else torch.tensor(keep, dtype=torch.int32, device=dev))
    return q, k, v, null_kv, q_scale, k_scale, bias, keep_t


def bound_ms(B, H, N, M, D, with_bias, keep):
    """Least time for the work these inputs need: each input read once,
    the output written once; dropped samples attend to the null column
    only."""
    cols = [1 if (keep is not None and not keep[b]) else M + 1
            for b in range(B)]
    flops = 4.0 * H * N * D * sum(cols)
    nbytes = (2 * B * H * N * D * 2          # q in, out
              + 2 * B * H * M * D * 2        # k, v
              + (N * M * 4 if with_bias else 0)
              + (2 * H * D + 2 * D) * 4 + (4 * B if keep is not None else 0))
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def sdpa_call(q, k, v, null_kv, q_scale, k_scale, bias, sm_scale=8.0):
    """The same function as one call of PyTorch's fused attention, on
    inputs prepared outside the timed call (null column prepended)."""
    import torch
    import torch.nn.functional as F
    from bevgen_torch.ops.cosine_attention import _l2n
    B, H, N, D = q.shape
    qh = (_l2n(q) * q_scale * sm_scale).to(q.dtype)
    nk = (_l2n(null_kv[0]) * k_scale).to(q.dtype)[None].expand(B, H, 1, D)
    nv = null_kv[1].to(q.dtype)[None].expand(B, H, 1, D)
    kh = torch.cat([nk, k], 2).contiguous()
    vh = torch.cat([nv, v], 2).contiguous()
    mask = None
    if bias is not None:
        mask = F.pad(bias, (1, 0)).to(q.dtype)[None, None].expand(B, H, N, -1)
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  scale=1.0)


def check_kernel(name, B, H, N, M, D, with_bias, keep, seed):
    import torch
    from bevgen_torch.ops.cosine_attention import (cosine_attention_cuda,
                                                   cosine_attention_reference)
    args = attention_inputs(B, H, N, M, D, with_bias, keep, seed)
    q, k, v, null_kv, qs, ks, bias, keep_t = args
    out = cosine_attention_cuda(*args)
    torch.cuda.synchronize()
    ref = cosine_attention_reference(q.float(), k.float(), v.float(), null_kv,
                                     qs, ks, bias, keep_t)
    err = (out.float() - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    finite = bool(torch.isfinite(out).all())
    ms = time_ms(lambda: cosine_attention_cuda(*args))
    plain_ms = time_ms(lambda: cosine_attention_reference(
        q.float(), k.float(), v.float(), null_kv, qs, ks, bias, keep_t),
        iters=5)
    lib_ms = (time_ms(sdpa_call(q, k, v, null_kv, qs, ks, bias))
              if keep is None else None)
    bms, bound_by, flops, nbytes = bound_ms(B, H, N, M, D, with_bias, keep)
    ok = finite and max_err <= MAX_ABS_TOL and mean_err <= MEAN_ABS_TOL
    print(f"[kernel] {name}: B={B} H={H} N={N} M={M} D={D} "
          f"bias={with_bias} keep={keep} max_abs_err={max_err:.3e} "
          f"mean_abs_err={mean_err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound_ms={bms:.4f} ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version "
                         f"(max {max_err:.3e} > {MAX_ABS_TOL} or mean "
                         f"{mean_err:.3e} > {MEAN_ABS_TOL}, finite={finite})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from bevgen_torch.core.config import argoverse_muse_7cam_config
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.models.stage2.transformer import CosineAttention
    from bevgen_torch.ops import _build
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.pipelines.generate import BEVGenPipeline

    # fp32 references stay fp32 (no TF32 in matmuls or convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    card = gpu_name_and_power()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")

    # 3. kernel vs plain version at the serving path's shapes
    cfg = argoverse_muse_7cam_config()
    tf = cfg.transformer
    B, H, D = 2, tf.num_heads, tf.dim_head
    N, NC = tf.num_img_tokens, tf.num_cond_tokens
    stats = {
        "self": check_kernel("self", B, H, N, N, D, True, None, 0),
        "cross": check_kernel("cross", B, H, N, NC, D, True, None, 1),
    }
    check_kernel("unaligned+keep", 2, 4, 96, 70, D, True, [1, 0], 2)
    check_kernel("no-bias", 2, 4, 200, 130, D, False, None, 3)

    # 4. end to end: argoverse_muse_7cam, full width, batch 2
    t0 = time.perf_counter()
    pipe = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=0)
    batch = fake_batch(cfg, batch_size=B, seed=0)
    n_params = sum(p.numel() for p in pipe.parameters())
    print(f"[e2e] pipeline built and initialised in "
          f"{time.perf_counter() - t0:.1f} s ({n_params / 1e6:.1f} M params)",
          flush=True)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])

    def generate(seed):
        return pipe.generate_fn(*inputs, torch.Generator(
            device="cuda").manual_seed(seed))

    t0 = time.perf_counter()
    generate(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ca.reset_launch_counts()
    t0 = time.perf_counter()
    images, ids = generate(1)
    torch.cuda.synchronize()
    gen_s = [time.perf_counter() - t0]
    launches = ca.cosine_attention_cuda.launches
    by_shape = dict(ca.cosine_attention_cuda.launches_by_shape)
    for seed in (2, 3, 4, 5):  # four more timed runs, for the spread
        t0 = time.perf_counter()
        generate(seed)
        torch.cuda.synchronize()
        gen_s.append(time.perf_counter() - t0)
    n_img = B * tf.num_cams
    med = sorted(gen_s)[len(gen_s) // 2]
    print(f"[e2e] generate_fn b={B}: warm-up {warm_s:.3f} s, timed "
          f"{', '.join(f'{t:.4f}' for t in gen_s)} s, median {med:.4f} s = "
          f"{n_img / med:.3f} images/s; kernel launches in the first timed "
          f"run {launches} {by_shape}", flush=True)
    steps = cfg.muse.sample_iterations
    expect = (steps + steps - 1) * tf.num_layers * 2
    if launches != expect:
        raise SystemExit(f"expected {expect} kernel launches, got {launches}")
    H_img, W_img = tf.cam_res
    if tuple(images.shape) != (B, tf.num_cams, H_img, W_img, 3):
        raise SystemExit(f"bad image shape {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise SystemExit("non-finite images")
    if ids.min() < 0 or ids.max() >= tf.vocab_size:
        raise SystemExit("ids out of range")
    print(f"[e2e] images {tuple(images.shape)} {images.dtype} finite, range "
          f"[{images.min().item():.3f}, {images.max().item():.3f}]; ids "
          f"{tuple(ids.shape)} in [{ids.min().item()}, {ids.max().item()}]",
          flush=True)

    # stage breakdown of one more generate (host clock around synchronised
    # stages)
    gen = torch.Generator(device="cuda").manual_seed(6)
    with torch.inference_mode():
        seg, ii, ei = (torch.as_tensor(a, device="cuda") for a in inputs)
        t = [time.perf_counter()]
        cond_ids = pipe.encode_bev(seg)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        from bevgen_torch.models.stage2.maskgit import generate as mg_generate
        gids = mg_generate(pipe.maskgit, cond_ids, ii, ei, gen)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        pipe.decode_tokens(gids)
        torch.cuda.synchronize(); t.append(time.perf_counter())
    print(f"[e2e] stages: encode_bev {t[1] - t[0]:.4f} s, maskgit "
          f"{t[2] - t[1]:.4f} s, decode_tokens {t[3] - t[2]:.4f} s",
          flush=True)

    # 5. one full-width forward: kernel vs plain attention
    g = torch.Generator(device="cuda").manual_seed(3)
    fids = torch.randint(0, tf.vocab_size + 1, (B, tf.num_cams,
                                                tf.num_cam_tokens),
                         generator=g, device="cuda")
    with torch.inference_mode():
        cond_ids = pipe.encode_bev(seg)
        cache = pipe.maskgit.build_cache(cond_ids, ii, ei)
        attn = [m for m in pipe.modules() if isinstance(m, CosineAttention)]
        lk = pipe.maskgit(fids, cond_ids, ii, ei, cache=cache).logits.float()
        for m in attn:
            m.core = ca.cosine_attention_reference
        lp = pipe.maskgit(fids, cond_ids, ii, ei, cache=cache).logits.float()
        for m in attn:
            m.core = ca.cosine_attention
    cos = torch.nn.functional.cosine_similarity(lk.flatten(), lp.flatten(),
                                                dim=0).item()
    top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    print(f"[forward] full-width logits, kernel vs plain attention: cosine "
          f"{cos:.6f} (min {LOGIT_COS_MIN}), top-1 agreement {top1:.4f} "
          f"(min {TOP1_AGREE_MIN}), max abs diff "
          f"{(lk - lp).abs().max().item():.4f}", flush=True)
    if not (cos >= LOGIT_COS_MIN and top1 >= TOP1_AGREE_MIN):
        raise SystemExit("full-width forward disagrees between the kernel "
                         "and the plain version")

    kernels = []
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[{shape} {n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": by_shape.get((n, m), 0), **stats[shape]})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
