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
     PyTorch's scaled_dot_product_attention, the bound from the shapes and
     the L2 bytes per call from the kernel's tile sizes; then the forward
     kernel's registers, shared memory, spill bytes (none allowed) and
     blocks per SM (cosine mode, D = 64 and 32), and the serving shapes
     again on head-transposed q/k/v views, bias rows off 16 bytes (M = 257)
     with a partial last tile and a dropped sample, and D = 32;
  4. end to end: `argoverse_muse_7cam` at full width (14 layers, width
     1024, 7 cameras) with seeded random weights, batch 2, through
     `BEVGenPipeline.generate_fn`; the kernel's launch count over one
     generate must be (18 + 17) * 14 * 2 = 980;
  5. one full-width transformer forward through the kernel and through the
     plain version, compared by logit cosine similarity and top-1 agreement;
  6. the training kernels against their plain versions: the backward
     kernels' registers, shared memory, spill bytes (none allowed) and
     blocks per SM (dq, dk/dv, dbias at D = 64 and 32), then the attention
     backward (three kernels) against `attention_bwd_reference`, two calls
     bit for bit, and the forward's plain biased mode against
     `bias_attention_reference`, at the training shapes (self and cross,
     b=8), unaligned with a dropped sample, and without bias; times of the
     kernels (the backward's per kernel too, from a profiler trace), the
     plain versions and PyTorch's SDPA (its backward minus its forward), the
     bounds and the backward's L2 bytes per call reckoned from its tiles;
     the plain mode's resources (as in phase 3) and the plain mode on
     head-transposed views at M = 1793 and 257 (unaligned bias rows,
     partial last tile) and at D = 32; the backward on head-transposed qf,
     kf, vc and dO (self, cross, unaligned + keep, D = 32); the plain mode's
     b=8 times at 1792, 1793 and 1856 keys with and without a bias; then
     the `bias_attention` op entry driven once forward and backward;
  7. the cosine attention's autograd Function at the self shape, b=2, against
     autograd through the plain version: cosine of each of its 7 gradients;
  8. training end to end: `argoverse_muse_7cam` at full width, fp32
     parameters and bf16 compute, batch 8, seeded random weights, fake token
     batches, through `training.trainer.make_train_step` (the CLI's step):
     one warm-up step, five timed; exactly 56 forward and 168 backward kernel
     launches per step (14 layers x 2 attentions x 2 forwards, 3 backward
     kernels each: dq, dk/dv, dbias), finite metrics, every update applied;
  9. one loss backward at b=1 through the kernels and through the plain
     versions: cosine of the gradient of each parameter group;
 10. from the seeded init, the CE falls over 8 steps on one repeated batch
     under a fixed mask;
 11. the block-sparse attention kernel's registers, shared memory, spill
     bytes (none allowed) and blocks per SM, then the kernel against
     `block_sparse_attention_reference` (fp32 on the same bf16 inputs) at
     b=2 on the `nuscenes_ar` layout (L=2368, 16-token blocks), on the
     `nuscenes_ar_tpu` layout (L=2432, 128-token blocks), and with a random
     (L, L) bias and the logsumexp; times of the kernel, the plain version
     and PyTorch's SDPA with the expanded additive mask (and their ratio),
     the bound from the layout's kept pairs, and the full and partial
     64 x 64 tiles of the tile plan;
 12. the decode-attention kernel against `decode_attention_reference` at
     b=2, H=16, dh=64 over cache prefixes of every bucket's width (512,
     1024, 1536, 2048, 2368 columns), and at b=1, H=3, pl=70: two calls bit
     for bit, one launch per call; the cluster size, registers, shared
     memory, blocks per SM and clusters in flight; times, SDPA, the bytes
     bound (after phase 14, the times weighted by each bucket's launches in
     a generate);
 13. `nuscenes_ar` at full width (24 layers, width 1024, 16 heads, 6
     cameras), b=1, seeded random weights: the SparseGPT forward through the
     block-sparse kernel (exactly 24 launches) against the same forward with
     the plain version, then `teacher_forced_logits` through the decode
     kernel (exactly 24 x 2100 = 50,400 launches) against the full forward;
 14. `ARPipeline.generate_fn` end to end at `nuscenes_ar`, b=2, KV-cached,
     top_k=100: one warm-up, one timed; exactly 50,400 decode and 0
     block-sparse launches per generate, ids in range, images finite;
 15. greedy decoding on the card at nuScenes widths with 2 layers, b=1: the
     reference-parity sampler (`cached=False`, 2100 full forwards through
     the block-sparse kernel, exactly 4200 launches) against the KV-cached
     one, step by step on the full sampler's trajectory, and one full
     forward over that trajectory, which must replay the sampler's choices;
 16. the block-sparse backward's resources (dq and dk/dv kernels, as in
     phase 11), then the backward (two kernels, three with a bias) against
     `block_sparse_attention_bwd_reference` (fp32 on the same bf16 inputs,
     with the forward kernel's out and lse) at `nuscenes_ar` b=4 (the
     training shape), at the `nuscenes_ar_tpu` layout, with a random (L, L)
     bias (b=2) and at L=200 with condition columns and pad rows; times of
     the kernels, the plain version and autograd through PyTorch's SDPA, and
     the bound from the kept pairs; and the forward kernel with the lse at
     b=4;
 17. `BlockSparseAttentionFn` at the `nuscenes_ar` shape, b=1, without and
     with a bias, against autograd through the plain forward: cosine of
     each gradient;
 18. AR training end to end: `nuscenes_ar` at full width and depth, fp32
     parameters and bf16 compute, b=4, seeded random weights, fake token
     batches, through `training.trainer.make_ar_train_step`: one warm-up
     step, five timed; exactly 24 forward and 48 backward block-sparse
     launches and 0 decode launches per step, finite metrics;
 19. one AR loss backward at b=1, full width cut to 8 layers, through the
     kernels and through the plain versions: cosine of the gradient of
     each parameter group;
 20. from the seeded init, the AR CE falls over 8 steps on one repeated
     batch;
 21. the glue kernels against their plain twins (fp32 on the same bf16
     inputs): residual + LayerNorm (x_new bit for bit) at the b=2 and b=8
     MUSE shapes, 13 rows and an odd width; GEGLU + LayerNorm at F = 2730
     (b=2, b=8) and F = 170; the standalone LayerNorm at (2, 1792, 1024)
     and a ragged case; times of the kernels (inputs cold in L2), the twins,
     F.layer_norm (the standalone norm) or the eager chain the modules run
     without the glue, and the bytes bound; row 14's two forms (the
     register form at (2, 1792, 1024), the general form on the ragged case
     and on a (2, 1792, 1024) view 4 bytes off 16) with each instance's
     registers, shared memory, spill bytes (none allowed) and blocks per SM,
     and the form each case took;
 22. `generate_fn` with `transformer.use_fused_glue=true` on phase 4's
     weights and inputs, 10 pairs timed in turns with the switch off: exactly
     (18 + 17) x 42 = 1470 residual + LayerNorm, 35 x 14 = 490 GEGLU +
     LayerNorm and 980 attention launches per generate;
 23. one full-width forward, glue against no glue, on the same weights and
     decode cache: logit cosine and top-1 agreement;
 24. the b=8 train step with the glue on (exactly 84 and 28 glue launches,
     56 forward and 168 backward attention launches per step), and at b=1
     the gradient of each parameter group, glue against no glue;
 25. the standalone LayerNorm through `LayerNormG(use_fused=True)` at
     (2, 1792, 1024) bf16: one launch per call (the register form), the
     forward against its twin and the `LayerNormFn` gradients against
     autograd through it;
 26. the reference's torch checkpoints: a seeded `argoverse_muse_7cam`
     pipeline written as a reference Lightning `.ckpt` (the reference's key
     names and layouts, `reference_state_dict`), served back by the generate
     CLI (`scripts/generate.py`, `ckpt_path=`, another seed) at b=2: the
     parameters equal bit for bit, exactly 980 attention launches, the ids
     those of the seeded pipeline's `generate_fn` on the same batch and
     generator; the same for a pipeline with the TokenCritic and
     self-conditioning (the CLI given their overrides); then `nuscenes_ar`
     the same way through `load_weights`: the parameters bit for bit and a
     b=1 full forward (exactly 24 block-sparse launches) with the seeded
     model's logits, bit for bit;
 27. real classifier-free guidance (`muse.real_cfg`) at
     `argoverse_muse_7cam`: the cosine-attention kernel against its plain
     version at the guided b=4 shapes (self; cross with keep [1, 1, 0, 0],
     the null half seeing only the null column; self with that keep too),
     with times, SDPA's (an additive -inf mask for the dropped half), the
     bound and the L2 bytes; one decode step's mixed logits through the
     kernel and the plain version (cosine, top-1); a b=2 generate: exactly
     504 launches at batch 4 (18 guided forwards) and 476 at batch 2 (17
     SelfCritic forwards); images/s, median of five after one warm-up;
 28. the TokenCritic (`muse.token_critic`): exactly 980 launches per b=2
     generate, all at batch 2; with `force_not_use_token_critic` 18 x 28 =
     504; with real_cfg too, 980, all at batch 4; images/s of each;
 29. self-conditioning (`transformer.self_cond`): exactly 980 launches per
     generate; `return_trajectory` gives (18, 2, 7, 256) ids whose last
     entry equals the returned ids; a nonzero self_cond_embed changes one
     step's logits; images/s;
 30. the b=8 train step with the TokenCritic and self-conditioning at
     self_cond_prob 1: exactly 84 forward launches (pre-forward, generator,
     critic) and 168 backward per step, step s, peak GB under the card's
     memory; the b=1 gradients kernels vs plain per parameter group (the
     TokenCritic and the self-conditioning feed-forward as groups of their
     own); the CE falls on a repeated batch;
 31. image encode: `encode_images` at `argoverse_muse_7cam` on 8 x 7
     cameras of 256 x 256 (bf16), images/s as the median of five after one
     warm-up; the card's fp32 encode of 2 images (TF32 off) against the
     CPU's on the same seeded weights, index agreement at least 0.99,
     without and with the stage-1 geometric embedding (`VQModel.encode(x,
     ii, ei)`), and the share of indices the embedding changes;
 32. the partial decode through the generate CLI at full width (`fake=1
     batch_size=2 keep_cameras=ring_front_left,ring_front_center,
     ring_side_left save_rec=true`): exactly 980 row-1 launches, the kept
     cameras' ids equal to their encoded ground-truth tokens, no mask id
     left, `rec` finite with the shape of `image`, images/s;
 33. `argoverse_muse_rect` at full width: row 1 against its plain version
     at self 1008 x 1008 and cross 1008 x 256 (+ the null column), b=2, to
     phase 3's bounds, with times, SDPA's and the bound; a b=2 generate with
     exactly 980 launches and finite (2, 3, 256, 336, 3) images, images/s;
 34. `tokenize_dataset` over 16 fake batches of 8 at `argoverse_muse_7cam`
     through the port's DataLoader and `device_prefetch` (images/s; the
     first and last batches' shard matrices equal the host's, their tokens
     agree with a direct encode), then
     `scripts/train_stage2.py tokens_dir=<shards> steps=3 batch_size=8` at
     full width: exactly 56 row-1 forward and 168 row-8 backward launches
     per step, finite losses;
 35. the int8 serving kernels (`csrc/int8.cu`) against their plain versions
     at the int8 paths' full-width shapes: quantize_static (3584 x 1024 and
     x 2730) and quantize_dynamic (3584 x 1024, 512 x 1024) bit for bit,
     padding and row scales included; int8_epilogue bit for bit in fp32 and
     bf16 (3584 x 1024, 2048, 5460 static; 3584 x 1024 and 512 x 2048
     dynamic); w8_linear within 2^-6 of max |out| (the AR decode's M = 2 and
     prefill's M = 512 shapes); times over inputs beyond the L2, the plain
     versions' (the eager chains), F.linear with bf16 weights for w8_linear,
     the bytes bound; torch._int_mm on the padded operands exact;
 36. `BEVGenPipeline.quantized()` of the seed-0 `argoverse_muse_7cam`
     pipeline at b=2: one forward through the int8 kernels against the
     plain int8 route (the same cache), int8 against bf16 logits (cosine,
     top-1 where the bf16 top-2 gap exceeds the int8 error); generates in
     turns with bf16 (one warm-up, five timed each): images/s, MaskGit
     weight MB, peak above the resident set, exactly 2485 quantize_static,
     994 quantize_dynamic, 3479 int8_epilogue and 980 row-1 launches per
     int8 generate; the same with `use_fused_glue=true` (1470 residual +
     LayerNorm, 0 GEGLU + LayerNorm launches: the GEGLU glue is off under
     int8);
 37. `ARPipeline.quantized()` of the seed-0 `nuscenes_ar` pipeline, b=2,
     KV-cached, top_k=100, full width and depth: one timed generate
     (images/s, peak above the resident set, against phase 14's bf16),
     GPT weight MB int8 against bf16, exactly 50,400 row-11 and 153,421
     w8_linear launches and no block-sparse or W8A8 launch per generate;
     then greedy decoding cut to 8 layers: the plain int8 route's choice
     at every step of the kernels' trajectory (ties counted, >= 0.97);
 38. the generate CLI with `quant=int8` and `quant=auto` for MUSE (full
     width, b=2; `auto` with fake=2) and AR (full width cut to 2 layers,
     b=1): the mode served (`auto` follows the crossover table,
     `bevgen_torch/configs/int8_crossover.json`, whose card is printed
     beside this one), the int8 kernels launched, finite images.

Phases 39-42 run stage-1 training, which has no kernel of its own (its
convolutions are cuDNN's, its attention a plain matrix product):
 39. the RGB VQ-GAN step at full width (`argoverse_muse`'s first_stage,
     256 x 256, ch 128) at b=8 with `NLayerDiscriminator()` and LPIPS on
     seeded full-width VGG16 weights (an npz in TMPDIR read through
     `LPIPSMetric`), under PyTorch's default TF32 flags: one warm-up step,
     five timed; seconds a step, images/s, peak memory, the step's FLOPs
     (torch's FlopCounterMode) and their share of the dense TF32 peak;
     metrics finite, d_weight >= 0, both networks' parameters changed;
 40. the BEV VQ-VAE step at full width (7 channels at 256 x 256, b=8, BCE),
     the same numbers; the loss falls over 25 steps on one repeated batch;
 41. a reduced-width VQ-GAN with LPIPS, two steps on the card with TF32 off
     and cuDNN's deterministic algorithms against two on the CPU from one
     seeded init: loss terms, d_weight and the updated parameters agree;
 42. `scripts/train_stage1.py` model=cam (with LPIPS) and model=bev, three
     steps each at full width: the saved tags load back bit for bit.

Phases 43-45 run the evaluation path (`scripts/metrics_eval.py`), which
has no kernel of its own (cuDNN convolutions, torch matrix products), on
seeded weights (no checkpoint ships with the repository) and with no cv2:
 43. InceptionV3 (FID pool3) at full width: a seeded pytorch-fid `.pth`
     through `convert_inception_weights`, the model from the npz and from
     the `.pth` bit for bit; card (TF32 off) against CPU features of 8
     images at 256x256 and at 224x400 (max |diff| <= 1e-3 max |f|) and the
     FID of two sets of 64 (relative difference <= 1e-3); then
     `make_inception_features` over 512 images at batch 32 under PyTorch's
     default TF32 flags: images/s (median of five after a warm-up), peak
     memory, FLOPs per image (FlopCounterMode), their share of the dense
     TF32 peak, and the model's device time on a batch;
 44. LoFTR at the outdoor widths (`init_random_params`) on the reference's
     50-px strip (256x50, padded to 56) and a 256x256 pair: card (TF32 off)
     against CPU, the confidence matrix within 1e-4, the matches identical
     but at near-tie cells (counted; at most 1% of the matches), the fine
     keypoints within 1e-3 px; ms per matcher call (median of 20) and 4
     calls per scene;
 45. the evaluation end to end: the seed-0 `argoverse_muse_7cam` pipeline
     generates b=2 (exactly 980 row-1 launches) and again with seed 1 as the
     ground truth; `metrics_eval.evaluate` on the card with LPIPS (phase
     39's npz), FID on phase 43's weights and per_camera: the CLI's keys,
     every value finite; the LoFTR confidence sum over the Argoverse pairs
     of both sets (BT.601 gray on both sides); seconds per image.

Phase 46 runs the reference's benchmark-and-trace CLI, which adds no kernel:
 46. rows 1 and 8 against their plain versions at `argoverse_muse` b=8 and
     b=2 (3 cameras, 768 x 768 and 768 x 256), row 9 at `nuscenes_ar` b=1,
     row 11 at b=1 over every prefix bucket and w8_linear at the b=1
     decode and prefill shapes; then `scripts/inference.py` through its
     `main`, as a user runs it, under PyTorch's default TF32 flags:
     `forward` and `train` at b=8, `decode` at b=2, `stage1_recon` and
     `stage1_train` at b=8 (`argoverse_muse`, 14 layers at width 1024),
     `ar_train` at b=4 (`nuscenes_ar`, full depth), `ar_decode` and
     `ar_decode_int8` at b=1 cut to 4 layers and `ar_decode_full` at b=1
     cut to 2 layers (full width); reps 2 (1 for the AR decodes) after the
     CLI's two warm-up calls. Each last line has the JAX script's keys,
     positive times and a peak above 0 and below the card's memory; each
     kernel is launched exactly its count per call times the calls;
     `train`, `decode` and `stage1_train` run with `profile=true`: each
     Chrome trace's device time by category, and the decode's holds
     exactly one generate's row-1 launches, phase 45's count; each mode's
     best_ms, mean_ms and peak MB are printed beside the card's name and
     power limit.

Prints each phase's seconds (`[time]` lines) and their sum, the kernels'
JSON line, then the card's name and power limit, and
as its last line `{"ok": true, "device": {...}}`. Without a CUDA device,
or outside a checkout of the repository, it exits with an error and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time

import numpy as np

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


def attention_inputs(B, H, N, M, D, with_bias, keep, seed, strided=False):
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
    if strided:
        q, k, v = (heads_view(x) for x in (q, k, v))
    return q, k, v, null_kv, q_scale, k_scale, bias, keep_t


# the forward kernel's blocks: 128 query rows of 2 (b, h) pairs, 512
# threads, 64-key tiles (csrc/cosine_attention.cu)
FWD_ROWS, FWD_PAIRS, FWD_THREADS, KEY_TILE = 128, 2, 512, 64


def fwd_l2_bytes(B, H, N, M, D, with_bias, keep, cosine=True, lse=False,
                 rows=FWD_ROWS, pairs=FWD_PAIRS):
    """Bytes the forward kernel's blocks move through L2 per call, from its
    tile sizes: each block of `rows` query rows and `pairs` (b, h) pairs
    reads its q rows once, the K and V rows of every key tile its pairs
    walk and the bias tile (rows x 64 fp32, clipped to N x M) of every key
    tile the block walks; out (and lse) are written once. A dropped sample
    walks no key tile (cosine) or the first (plain). rows=64, pairs=1 is
    the design of one warpgroup per (b, h, 64 rows)."""
    all_tiles = -(-M // KEY_TILE)

    def tiles(bh):
        kept = keep is None or keep[bh // H]
        return all_tiles if kept else (0 if cosine else 1)

    def cols(n):
        return min(M, KEY_TILE * n)

    row_blocks = -(-N // rows)
    kv = bias = 0
    for first in range(0, B * H, pairs):
        walk = [tiles(bh) for bh in range(first, min(first + pairs, B * H))]
        kv += row_blocks * sum(cols(n) for n in walk) * D * 2 * 2
        if with_bias:
            bias += N * cols(max(walk)) * 4
    return kv + bias + 2 * B * H * N * D * 2 + (B * H * N * 4 if lse else 0)


def l2_note(B, H, N, M, D, with_bias, keep, cosine=True, lse=False):
    new = fwd_l2_bytes(B, H, N, M, D, with_bias, keep, cosine, lse)
    old = fwd_l2_bytes(B, H, N, M, D, with_bias, keep, cosine, lse, 64, 1)
    return f"l2_mb={new / 1e6:.1f} (64-row blocks of one pair: {old / 1e6:.1f})"


def heads_view(x):
    """A (B, H, L, D) tensor as a head-transposed view of a (B, L, H, D)
    one, as the transformer hands q, k and v to the kernel."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


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


def sdpa_call(q, k, v, null_kv, q_scale, k_scale, bias, sm_scale=8.0,
              keep=None):
    """The same function as one call of PyTorch's fused attention, on
    inputs prepared outside the timed call (null column prepended; a
    dropped sample's real columns masked with -inf in the additive mask)."""
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
    if keep is not None:
        drop = torch.zeros(B, 1, 1, kh.shape[2], dtype=q.dtype, device=q.device)
        drop[keep == 0, :, :, 1:] = float("-inf")
        drop = drop.expand(B, H, N, -1)
        mask = drop if mask is None else (mask + drop).contiguous()
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                                  scale=1.0)


def check_kernel(name, B, H, N, M, D, with_bias, keep, seed, strided=False):
    """Row 1 against cosine_attention_reference, with times, the bound and
    the L2 bytes; `strided`: q, k, v head-transposed views, out read
    through its own (B,H,N,D) view of (B,N,H,D)."""
    import torch
    from bevgen_torch.ops.cosine_attention import (cosine_attention_cuda,
                                                   cosine_attention_reference)
    args = attention_inputs(B, H, N, M, D, with_bias, keep, seed, strided)
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
    lib_ms = time_ms(sdpa_call(q, k, v, null_kv, qs, ks, bias, keep=keep_t))
    bms, bound_by, flops, nbytes = bound_ms(B, H, N, M, D, with_bias, keep)
    ok = finite and max_err <= MAX_ABS_TOL and mean_err <= MEAN_ABS_TOL
    print(f"[kernel] {name}: B={B} H={H} N={N} M={M} D={D} "
          f"bias={with_bias} keep={keep} strided={strided} "
          f"max_abs_err={max_err:.3e} "
          f"mean_abs_err={mean_err:.3e} ms={ms:.4f} "
          f"{l2_note(B, H, N, M, D, with_bias, keep)} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound_ms={bms:.4f} ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version "
                         f"(max {max_err:.3e} > {MAX_ABS_TOL} or mean "
                         f"{mean_err:.3e} > {MEAN_ABS_TOL}, finite={finite})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


# Tolerances of the backward kernels against attention_bwd_reference (fp32
# on the same bf16 inputs). The kernels round P and dS to bf16 before the
# dv, dq and dk products (relative step 2^-8, random sign) and write dq, dk,
# dv in bf16; delta comes from the bf16 forward output. Each term is off by
# at most ~0.4%, the sums by less, so 1e-2 relative L2 leaves a margin of
# about 3x over what the rounding gives; the largest single error stays
# under 5% of the largest entry. dbias sums fp32 dS over B*H (no bf16 step),
# so it is held to the same bounds with a wider margin.
BWD_REL_L2_TOL = 1e-2
BWD_MAX_REL_TOL = 5e-2
# The cosine Function's seven gradients at full width, kernels vs autograd
# through the plain version (both bf16 inputs): bf16 rounding on both sides,
# in different places, over 1793 keys.
GRAD_COS_MIN = 0.995
# Full-width model gradients (b=1), kernels vs plain attention: the same bf16
# rounding differences carried through 14 layers, twice (generator and
# critic), with random weights.
MODEL_GRAD_COS_MIN = 0.99
TRAIN_BATCH = 8
TRAIN_TIMED_STEPS = 5
CE_STEPS = 8


def bwd_inputs(B, H, N, M, D, with_bias, keep, seed, strided=False):
    """Post-prologue inputs of the backward: qf unit rows * q_scale, kf with
    the null column at 0, biasp with a zero column 0, and dO."""
    import torch
    from bevgen_torch.ops.cosine_attention import _l2n
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    scale = 1.0 + 0.1 * torch.randn(D, generator=g, device=dev)
    qf = (_l2n(torch.randn(B, H, N, D, generator=g, device=dev))
          * scale).to(torch.bfloat16)
    kf = (_l2n(torch.randn(B, H, M, D, generator=g, device=dev))
          * scale).to(torch.bfloat16)
    vc = torch.randn(B, H, M, D, generator=g, device=dev).to(torch.bfloat16)
    do = (0.1 * torch.randn(B, H, N, D, generator=g, device=dev)).to(torch.bfloat16)
    biasp = None
    if with_bias:
        biasp = torch.rand(N, M, generator=g, device=dev) * 2.0
        biasp[:, 0] = 0.0
    keep_t = (None if keep is None
              else torch.tensor(keep, dtype=torch.int32, device=dev))
    if strided:
        qf, kf, vc, do = (heads_view(x) for x in (qf, kf, vc, do))
    return qf, kf, vc, biasp, keep_t, do


def attention_cols(B, M, keep):
    """Columns each sample attends to: all M, or the null column alone."""
    return [1 if (keep is not None and not keep[b]) else M for b in range(B)]


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bwd_bound_ms(B, H, N, M, D, with_bias, keep):
    """Least time of the backward's function: 5 products (S, dP, dq, dk,
    dv) of N x cols x D multiply-adds per (b, h) over the live columns;
    q, k, v, dO, bias, keep read once, dq, dk, dv, dbias written once."""
    cols = sum(attention_cols(B, M, keep))
    flops = 2.0 * 5 * H * N * D * cols
    nbytes = (2 * B * H * N * D * 2 + B * H * N * D * 2       # q, dO; dq
              + 2 * B * H * M * D * 2 + 2 * B * H * M * D * 2  # k, v; dk, dv
              + (2 * N * M * 4 if with_bias else 0)
              + (4 * B if keep is not None else 0))
    return (*bound(flops, nbytes), flops, nbytes)


def rel_err(got, want):
    d = (got.float() - want.float())
    return (d.abs().max().item(), (d.norm() / want.float().norm().clamp_min(1e-30)).item(),
            want.float().abs().max().item())


def sdpa_bwd_ms(qf, kf, vc, biasp, keep, do, sm_scale=8.0):
    """library_ms of the backward: torch.autograd.grad through one
    F.scaled_dot_product_attention call (bias expanded, requiring grad),
    minus that call's forward. Timed only. Returns (ms, note)."""
    import torch
    import torch.nn.functional as F
    B, H, N, _ = qf.shape
    M = kf.shape[2]
    q, k, v = (t.detach().clone().requires_grad_() for t in (qf, kf, vc))
    add = torch.zeros(B, 1, 1, M, device=qf.device)
    if keep is not None:
        col = torch.arange(M, device=qf.device)
        valid = (keep[:, None] > 0) | (col[None] == 0)
        add = torch.where(valid, 0.0, float("-inf"))[:, None, None, :]
    for with_dbias in ((True, False) if biasp is not None else (False,)):
        bias = (None if biasp is None
                else biasp.detach().clone().requires_grad_(with_dbias))

        def fwd():
            mask = (add if bias is None else bias[None, None] + add)
            mask = mask.to(qf.dtype).expand(B, H, N, M)
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  scale=sm_scale)

        wrt = [q, k, v] + ([bias] if with_dbias else [])
        try:
            torch.autograd.grad(fwd(), wrt, do)
            both = time_ms(lambda: torch.autograd.grad(fwd(), wrt, do), iters=5)
            with torch.no_grad():
                only = time_ms(fwd, iters=5)
        except RuntimeError as e:  # no SDPA backend gives this gradient
            print(f"[kernel] SDPA backward with dbias={with_dbias}: {e}"[:300])
            continue
        return both - only, ("with dbias" if with_dbias else "without dbias")
    return None, "no SDPA backward ran"


# the backward kernels' blocks: two (b, h) pairs of 64 rows (dq) or 64 keys
# (dk/dv); dbias blocks of 64 rows x 128 keys (csrc/attention_bwd.cu)
BWD_PAIRS, BWD_DB_KEYS = 2, 128


def bwd_l2_bytes(B, H, N, M, D, with_bias, keep, pairs=BWD_PAIRS,
                 db_keys=BWD_DB_KEYS):
    """Bytes the backward kernels' blocks move through L2 per call, from
    their tile sizes (rows past N or M are not read). dq: each block of
    `pairs` (b, h) pairs reads its q and dO tiles, the O and dO rows for
    delta and the lse, the K and V tiles of every key tile its pairs walk
    and one bias tile per key tile; writes dq and delta. dk/dv: its K and V
    tiles, then per query tile the q, dO tiles, lse and delta of each
    active pair and one bias tile; writes dk, dv. dbias: per (b, h) a
    block walks, the q, dO, lse and delta of its 64 rows and the K, V of its
    `db_keys` keys; reads the bias and writes dbias once. A dropped sample
    walks one key tile (dq), only the first key tile's keys (dk/dv) and
    only the first dbias block. pairs=1, db_keys=64 is the design of one
    warpgroup per tile."""
    T, row = KEY_TILE, D * 2
    nq, nk = -(-N // T), -(-M // T)
    kept = [keep is None or bool(keep[b]) for b in range(B)]

    def span(r0, n, width=T):
        return max(0, min(n, r0 + width) - r0)

    total = 0
    for first in range(0, B * H, pairs):
        group = range(first, min(first + pairs, B * H))
        walk = [nk if kept[bh // H] else 1 for bh in group]
        for i in range(nq):
            r = span(i * T, N)
            total += len(group) * r * (4 * row + 8 + row)
            for j in range(max(walk)):
                c = span(j * T, M)
                total += sum(j < n for n in walk) * c * 2 * row
                total += r * c * 4 if with_bias else 0
        for j in range(nk):
            c = span(j * T, M)
            active = sum(j == 0 or kept[bh // H] for bh in group)
            total += active * c * 2 * row + len(group) * c * 2 * row
            if active:
                for i in range(nq):
                    r = span(i * T, N)
                    total += active * r * (2 * row + 8)
                    total += r * c * 4 if with_bias else 0
    if with_bias:
        for i in range(nq):
            r = span(i * T, N)
            for y in range(-(-M // db_keys)):
                c = span(y * db_keys, M, db_keys)
                walked = sum(y == 0 or kept[bh // H] for bh in range(B * H))
                total += walked * (r * (2 * row + 8) + c * 2 * row) + 2 * r * c * 4
    return total


def bwd_kernel_ms(call, iters=5):
    """Device ms per call of each backward kernel (dq, dkdv, dbias), from a
    torch.profiler trace of `iters` calls; {} when the trace shows no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            call()
        torch.cuda.synchronize()
    ms = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for key in ("dq", "dkdv", "dbias"):
            if f"attn_bwd_{key}_kernel" in e.name:
                ms[key] = ms.get(key, 0.0) + e.device_time_total / 1e3 / iters
    return ms


def attention_bwd_resources(D):
    """Phase 6: the three backward kernels' registers, shared memory, spill
    bytes (a spill fails the run) and blocks per SM at head dim D."""
    import ctypes
    from bevgen_torch.ops import _build
    report = ptxas_report("attention_bwd")
    pint = ctypes.POINTER(ctypes.c_int)
    query = _build.function("attention_bwd", "attention_bwd_resources",
                            [ctypes.c_int, ctypes.c_int, pint, pint])
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    res = {}
    for i, key in enumerate(("dq", "dkdv", "dbias")):
        kernel = f"attn_bwd_{key}_kernel<{D}>"
        err = query(i, D, ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0:
            raise SystemExit(f"resource query of {kernel} failed: CUDA error {err}")
        res[key] = print_resources(kernel, report, smem.value, blocks.value,
                                   2 * 128)
    return res


def check_bwd(name, B, H, N, M, D, with_bias, keep, seed, strided=False):
    """Row 8 against attention_bwd_reference, with times (per kernel too),
    the bound, the L2 bytes and a bit-identity check over two calls;
    `strided`: qf, kf, vc and dO head-transposed views (out is always the
    forward's (B,H,N,D) view of (B,N,H,D))."""
    import torch
    from bevgen_torch.ops.attention_bwd import (attention_bwd_cuda,
                                                attention_bwd_reference)
    from bevgen_torch.ops.bias_attention import bias_attention_cuda
    qf, kf, vc, biasp, keep_t, do = bwd_inputs(B, H, N, M, D, with_bias, keep,
                                               seed, strided)
    out, lse = bias_attention_cuda(qf, kf, vc, biasp, keep_t, 8.0,
                                   return_lse=True)
    args = (qf, kf, vc, biasp, keep_t, out, do, lse, 8.0)
    got = attention_bwd_cuda(*args)
    again = attention_bwd_cuda(*args)
    torch.cuda.synchronize()
    same = all(a is None or torch.equal(a, b) for a, b in zip(got, again))
    del again
    want = attention_bwd_reference(qf.float(), kf.float(), vc.float(), biasp,
                                   keep_t, do.float(), 8.0)
    errs, ok, max_err = {}, same, 0.0
    for key, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            continue
        finite = bool(torch.isfinite(a).all())
        mx, rl2, ref_max = rel_err(a, w)
        errs[key] = (mx, rl2)
        max_err = max(max_err, mx)
        ok = ok and finite and rl2 <= BWD_REL_L2_TOL and mx <= BWD_MAX_REL_TOL * ref_max
    del want, got
    ms = time_ms(lambda: attention_bwd_cuda(*args))
    per_kernel = bwd_kernel_ms(lambda: attention_bwd_cuda(*args))
    plain_ms = time_ms(lambda: attention_bwd_reference(
        qf.float(), kf.float(), vc.float(), biasp, keep_t, do.float(), 8.0),
        iters=3, warmup=1)
    lib_ms, lib_note = sdpa_bwd_ms(qf, kf, vc, biasp, keep_t, do)
    bms, bound_by, flops, nbytes = bwd_bound_ms(B, H, N, M, D, with_bias, keep)
    l2 = bwd_l2_bytes(B, H, N, M, D, with_bias, keep)
    l2_old = bwd_l2_bytes(B, H, N, M, D, with_bias, keep, 1, 64)
    kernel_ms = (" ".join(f"{k}={v:.4f}" for k, v in per_kernel.items())
                 or "not measured (no device time in the trace)")
    print(f"[kernel] attention_bwd {name}: B={B} H={H} N={N} M={M} D={D} "
          f"bias={with_bias} keep={keep} strided={strided} "
          + " ".join(f"{k}: max_abs_err={e[0]:.3e} rel_l2={e[1]:.3e}"
                     for k, e in errs.items())
          + f" bit_identical={same} ms={ms:.4f} (per kernel: {kernel_ms}) "
          f"l2_mb={l2 / 1e6:.1f} (one warpgroup per tile: {l2_old / 1e6:.1f}) "
          f"plain_ms={plain_ms:.4f} library_ms="
          f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ({lib_note}) "
          f"bound_ms={bms:.4f} ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"backward kernel {name} disagrees with its plain "
                         f"version (rel L2 > {BWD_REL_L2_TOL} or max > "
                         f"{BWD_MAX_REL_TOL} of the largest entry) or two "
                         f"calls differ (bit_identical={same})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


def check_bias_fwd(name, B, H, N, M, D, with_bias, keep, seed,
                   strided=False):
    """Row 7 (the forward kernel's plain mode) against
    bias_attention_reference, with times, the bound and the L2 bytes;
    `strided`: q, k, v head-transposed views."""
    import torch
    import torch.nn.functional as F
    from bevgen_torch.ops.bias_attention import (bias_attention_cuda,
                                                 bias_attention_reference)
    qf, kf, vc, biasp, keep_t, _ = bwd_inputs(B, H, N, M, D, with_bias, keep,
                                              seed, strided)
    args = (qf, kf, vc, biasp, keep_t, 8.0)
    out = bias_attention_cuda(*args)
    torch.cuda.synchronize()
    ref = bias_attention_reference(qf.float(), kf.float(), vc.float(), biasp,
                                   keep_t, 8.0)
    err = (out.float() - ref).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    ok = bool(torch.isfinite(out).all()) and max_err <= MAX_ABS_TOL \
        and mean_err <= MEAN_ABS_TOL
    ms = time_ms(lambda: bias_attention_cuda(*args))
    plain_ms = time_ms(lambda: bias_attention_reference(
        qf.float(), kf.float(), vc.float(), biasp, keep_t, 8.0), iters=5)
    lib_ms = None
    if keep is None:
        mask = (None if biasp is None
                else biasp.to(qf.dtype)[None, None].expand(B, H, N, M))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qf, kf, vc, attn_mask=mask, scale=8.0))
    cols = sum(attention_cols(B, M, keep))
    flops = 4.0 * H * N * D * cols
    nbytes = (2 * B * H * N * D * 2 + 2 * B * H * M * D * 2
              + (N * M * 4 if with_bias else 0)
              + (4 * B if keep is not None else 0))
    bms, bound_by = bound(flops, nbytes)
    print(f"[kernel] bias_attention_fwd {name}: B={B} H={H} N={N} M={M} D={D} "
          f"bias={with_bias} keep={keep} strided={strided} "
          f"max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e} ms={ms:.4f} "
          f"{l2_note(B, H, N, M, D, with_bias, keep, cosine=False)} "
          f"plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
          f"bound_ms={bms:.4f} ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"plain-mode forward {name} disagrees with its plain "
                         f"version (max {max_err:.3e}, mean {mean_err:.3e})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


def check_function_grads(B, H, N, D, seed=11):
    """The whole CosineAttentionFn (prologue, forward kernel, backward
    kernels, prologue chain) against autograd through
    cosine_attention_reference, on the same bf16 inputs at the self shape."""
    import torch
    from bevgen_torch.ops import cosine_attention as ca
    q, k, v, nkv, qs, ks, bias, _ = attention_inputs(B, H, N, N, D, True,
                                                     None, seed)
    leaves = [t.detach().clone().requires_grad_() for t in
              (q, k, v, nkv, qs, ks, bias)]
    w = torch.randn(B, H, N, D, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    out = ca.cosine_attention(*leaves)
    if out.grad_fn is None:
        raise SystemExit("CUDA cosine attention output has no grad_fn")
    got = torch.autograd.grad((out.float() * w).sum(), leaves)
    ref = ca.cosine_attention_reference(*leaves)
    want = torch.autograd.grad((ref.float() * w).sum(), leaves)
    names = ("q", "k", "v", "null_kv", "q_scale", "k_scale", "bias")
    cos = {n: torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()
        for n, a, b in zip(names, got, want)}
    worst = min(cos.values())
    print(f"[grad] CosineAttentionFn vs autograd through the plain version, "
          f"B={B} H={H} N=M={N}: cosine "
          + " ".join(f"{n}={c:.6f}" for n, c in cos.items())
          + f" (min {GRAD_COS_MIN})", flush=True)
    if not worst >= GRAD_COS_MIN:
        raise SystemExit("the cosine Function's gradients disagree with the "
                         "plain version's")
    return cos


def to_device(batch):
    import numpy as np
    import torch
    return {k: torch.as_tensor(np.asarray(v)).to("cuda") for k, v in batch.items()}


def train_phase(cfg):
    """Phases 8, 24 and 30: the b=8 full-width train step, timed, with its
    launch counts: 2 x num_layers row-1 forward launches per forward (the
    generator's and the critic's; a third, the no-grad self-conditioning
    pre-forward, with `self_cond` at self_cond_prob 1), 3 row-8 launches for
    each of the two forwards' attentions, and the glue kernels' (0 with the
    switch off, 3 x num_layers residual + LayerNorm and num_layers GEGLU +
    LayerNorm per forward with it on). Returns (model, stats)."""
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2.maskgit import MaskGit
    from bevgen_torch.ops import attention_bwd as ab
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.scripts.train_stage2 import fake_batches
    from bevgen_torch.training import optim, trainer
    tf = cfg.transformer
    B = TRAIN_BATCH
    if tf.self_cond and cfg.muse.self_cond_prob not in (0.0, 1.0):
        raise SystemExit("the launch counts need self_cond_prob 0 or 1")
    forwards = 2 + int(tf.self_cond and cfg.muse.self_cond_prob == 1.0)
    t0 = time.perf_counter()
    model = MaskGit(tf, cfg.muse, dtype=torch.bfloat16,
                    param_dtype=torch.float32)
    init_weights(model, seed=0).to("cuda")
    state = trainer.create_train_state(
        model, optim.maskgit_optimizer(model, 1e-4, warmup_steps=1))
    step = trainer.make_train_step()
    batches = fake_batches(tf, B, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] MaskGit fp32 params / bf16 compute, {n_params / 1e6:.1f} M "
          f"params, built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    step(state, to_device(next(batches)), gen)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, rows = [], []
    for i in range(TRAIN_TIMED_STEPS):
        batch = to_device(next(batches))
        torch.cuda.synchronize()
        if i == 0:
            ca.reset_launch_counts()
            ab.reset_launch_counts()
            fg.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            fwd = dict(ca.cosine_attention_cuda.launches_by_shape)
            bwd = dict(ab.attention_bwd_cuda.launches_by_shape)
            n_fwd = ca.cosine_attention_cuda.launches
            n_bwd = ab.attention_bwd_cuda.launches
            n_res = fg.residual_layernorm_cuda.launches
            n_geglu = fg.geglu_layernorm_cuda.launches
        rows.append({k: float(v) for k, v in m.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = sorted(times)[len(times) // 2]
    tokens = B * tf.num_cams * tf.num_cam_tokens
    last = rows[-1]
    glue = bool(tf.use_fused_glue)
    print(f"[train] argoverse_muse_7cam b={B} use_fused_glue={glue} "
          f"{variant_name(cfg)}: warm-up "
          f"step {warm_s:.3f} s, "
          f"timed {', '.join(f'{t:.4f}' for t in times)} s, median "
          f"{med:.4f} s = {tokens / med:.1f} image tokens/s; peak memory "
          f"{peak_gb:.2f} GB; last step loss {last['loss']:.4f} ce_loss "
          f"{last['ce_loss']:.4f} critic_loss {last['critic_loss']:.4f} "
          f"grad_norm {last['grad_norm']:.4f}", flush=True)
    print(f"[train] kernel launches in the first timed step: forward {n_fwd} "
          f"{fwd}, backward {n_bwd} {bwd}; residual + LayerNorm {n_res}, "
          f"GEGLU + LayerNorm {n_geglu}", flush=True)
    layers = tf.num_layers
    want_fwd, want_bwd = 2 * layers * forwards, 3 * 4 * layers
    if n_fwd != want_fwd or n_bwd != want_bwd:
        raise SystemExit(f"expected {want_fwd} forward and {want_bwd} "
                         f"backward kernel launches per step, got {n_fwd} "
                         f"and {n_bwd}")
    want_glue = (forwards * 3 * layers, forwards * layers) if glue else (0, 0)
    if (n_res, n_geglu) != want_glue:
        raise SystemExit(f"expected {want_glue} glue kernel launches per "
                         f"step, got {(n_res, n_geglu)}")
    for r in rows:
        if not all(math.isfinite(v) for v in r.values()) or \
                r["update_applied"] != 1.0:
            raise SystemExit(f"train step metrics not finite or update "
                             f"skipped: {r}")
    return model, {"fwd": fwd, "bwd": bwd, "step_s": med,
                   "tokens_per_s": tokens / med, "peak_gb": peak_gb,
                   "residual_ln": n_res, "geglu_ln": n_geglu}


def ce_falls_phase(model, cfg):
    """Phase 10: CE over CE_STEPS steps on one repeated batch, fixed mask
    and fixed draws, base_lr 3e-4, warm-up 1, from the seeded init (a model
    that phase 8 moved on random batches need not descend at this rate)."""
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.scripts.train_stage2 import fake_batches
    from bevgen_torch.training import optim, trainer
    tf = cfg.transformer
    init_weights(model, seed=0)
    batch = to_device(next(fake_batches(tf, TRAIN_BATCH, seed=1)))
    mask = torch.rand(batch["tokens"].shape, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(2)) < 0.5
    state = trainer.create_train_state(model, optim.maskgit_optimizer(
        model, 3e-4, warmup_steps=1, total_steps=CE_STEPS))
    step = trainer.make_train_step()
    ces = []
    for _ in range(CE_STEPS):
        m = step(state, batch, torch.Generator(device="cuda").manual_seed(3),
                 mask_override=mask)
        ces.append(float(m["ce_loss"]))
    print(f"[train] CE on one repeated batch over {CE_STEPS} steps: "
          f"{' '.join(f'{c:.4f}' for c in ces)}", flush=True)
    if not (all(math.isfinite(c) for c in ces) and ces[-1] < ces[0]):
        raise SystemExit("the CE did not fall on a repeated batch")
    return ces


def grad_group(name: str) -> str:
    parts = name.split(".")
    if parts[0] != "transformer":
        return parts[0]
    if parts[1].startswith("layers_"):
        return parts[1]
    if parts[1] in ("final_norm", "to_logits"):
        return "head"
    if parts[1] == "self_cond_to_init_embed":
        return parts[1]
    if parts[1] == "camera_bias_emb":
        return "camera_bias"
    return "embeddings"


def model_grads_phase(model, cfg):
    """Phase 9: one loss backward at b=1 through the kernels and through
    the plain versions; cosine of the gradient of each parameter group."""
    import torch
    from bevgen_torch.models.stage2.maskgit import maskgit_loss
    from bevgen_torch.models.stage2.transformer import CosineAttention
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.scripts.train_stage2 import fake_batches
    tf = cfg.transformer
    batch = to_device(next(fake_batches(tf, 1, seed=4)))
    mask = torch.rand(batch["tokens"].shape, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(5)) < 0.5
    noise = torch.zeros(tuple(batch["tokens"].shape) + (tf.vocab_size,),
                        device="cuda")
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    attn = [m for m in model.modules() if isinstance(m, CosineAttention)]

    def grads():
        out = maskgit_loss(model, batch["tokens"], batch["cond_ids"],
                           batch["intrinsics_inv"], batch["extrinsics_inv"],
                           generator=torch.Generator(device="cuda").manual_seed(6),
                           mask_override=mask, gumbel_noise=noise)
        return float(out.loss.detach()), torch.autograd.grad(out.loss, params)

    before = ca.cosine_attention_cuda.launches
    loss_k, gk = grads()
    if ca.cosine_attention_cuda.launches == before:
        raise SystemExit("the kernel path launched no kernel")
    for m in attn:
        m.core = ca.cosine_attention_reference
    try:
        loss_p, gp = grads()
    finally:
        for m in attn:
            m.core = ca.cosine_attention
    groups = {}
    for n, a, b in zip(names, gk, gp):
        groups.setdefault(grad_group(n), ([], []))
        groups[grad_group(n)][0].append(a.float().flatten())
        groups[grad_group(n)][1].append(b.float().flatten())
    cos = {k: torch.nn.functional.cosine_similarity(
        torch.cat(a), torch.cat(b), dim=0).item() for k, (a, b) in groups.items()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:4]
    print(f"[grad] full-width b=1 loss {loss_k:.5f} (kernels) vs {loss_p:.5f} "
          f"(plain); gradient cosine over {len(cos)} parameter groups: min "
          f"{worst[0][1]:.6f} (bound {MODEL_GRAD_COS_MIN}), lowest "
          + ", ".join(f"{k}={c:.6f}" for k, c in worst)
          + f", mean {sum(cos.values()) / len(cos):.6f}", flush=True)
    if not worst[0][1] >= MODEL_GRAD_COS_MIN:
        raise SystemExit("full-width gradients disagree between the kernels "
                         "and the plain versions")
    return cos


# The AR path: kernels against their plain versions (fp32 on the same bf16
# inputs). The block-sparse kernel rounds the unnormalised softmax weights
# and its output to bf16, as the forward kernels above do, so the same
# bounds hold; its logsumexp is fp32 throughout (online in log2 units), so
# 5e-3 leaves a wide margin. The decode kernel rounds the weights and the
# output to bf16, as its plain version does, so they part by about one bf16
# step (2^-8 relative) where a rounding falls the other way: its error is
# held to 2% of the largest |out| (and at most 2e-2) and its mean error to
# 1% of the mean |out|, since with unit-normal inputs a long prefix gives
# outputs of a few hundredths.
LSE_TOL = 5e-3
DECODE_TOL = 2e-2
DECODE_REL_TOL = 2e-2
DECODE_MEAN_REL_TOL = 1e-2
# Full-width AR logits at b=1: the kernels against the plain versions and
# the cached decode against the full forward, bf16 through 24 layers.
AR_COS_MIN = 0.99
AR_TOP1_MIN = 0.90
# Greedy decode, the cached decoder against the full-forward sampler: at
# every step of the full sampler's own trajectory, the token it chose must
# be among the cached decoder's best (the bound of the reference's
# kernel-path test). The logits are bf16, so ties are common, and top_k=1
# keeps every tied token and draws among them. The two free-running
# trajectories are printed too but not held to it: both samplers round in
# bf16 in different orders, so with random weights a tie or near-tie
# resolves differently somewhere in 2100 steps and the trajectories part
# there.
GREEDY_AGREE_MIN = 0.97
AR_BATCH = 2
# 8 caches of b=2, H=16, 2368 x 64 bf16 K and V: 155 MB, three times the L2
DECODE_CACHES = 8
AR_TIMED = 1


def row7_shapes(B, H, N, D):
    """Row 7 at N + 1 keys (the plain-mode self shape: a partial last tile,
    bias rows off 16 bytes, which the wrapper copies into padded rows inside
    the timed call) beside N and N + 64 keys (aligned, full tiles), with
    and without a bias."""
    from bevgen_torch.ops.bias_attention import bias_attention_cuda
    parts = []
    for M in (N, N + 1, N + 64):
        for with_bias in (False, True):
            qf, kf, vc, biasp, keep_t, _ = bwd_inputs(B, H, N, M, D,
                                                      with_bias, None, 10)
            ms = time_ms(lambda: bias_attention_cuda(qf, kf, vc, biasp,
                                                     keep_t, 8.0))
            parts.append(f"M={M} bias={with_bias}: {ms:.4f}")
    print(f"[kernel] bias_attention_fwd b={B} N={N} ms by keys: "
          + ", ".join(parts), flush=True)


def ar_layout(preset):
    from bevgen_torch.core.config import PRESETS
    from bevgen_torch.models import masks
    cfg = PRESETS[preset]().transformer
    return cfg, masks.sparse_masks(cfg).layouts


def ptxas_report(source):
    """{kernel name: (registers, static shared bytes, spill store bytes,
    spill load bytes)} from the ptxas report of `csrc/<source>.cu`'s build
    (names demangled to the function's own, with a template instance's
    integer arguments: `attention_fwd_kernel<64,1>`)."""
    import re
    from bevgen_torch.ops import _build
    lib = _build.library_path(source)
    report, name = {}, None
    for line in lib.with_name(lib.name + ".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '\w*?\d([a-z][a-z_]*_kernel)"
                      r"(?:I((?:L[a-z]+\d+E)+)E)?", line)
        if m:
            args = re.findall(r"L[a-z]+(\d+)E", m.group(2) or "")
            name = m.group(1) + (f"<{','.join(args)}>" if args else "")
            report[name] = [0, 0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report[name][2:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name][0] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            report[name][1] = int(sm.group(1)) if sm else 0
    return {k: tuple(v) for k, v in report.items()}


def print_resources(kernel, report, smem, blocks, threads):
    """One kernel's registers, shared memory (static + dynamic), spill bytes
    and resident blocks per SM; fail on a spill."""
    regs, static, spill_st, spill_ld = report[kernel]
    print(f"[kernel] {kernel}: {regs} registers, {static} + {smem} "
          f"bytes shared memory (static + dynamic), {spill_st} bytes spill "
          f"stores, {spill_ld} bytes spill loads, {blocks} blocks of "
          f"{threads} threads per SM", flush=True)
    if spill_st or spill_ld:
        raise SystemExit(f"{kernel} spills registers")
    return {"registers": regs, "smem": static + smem, "blocks_per_sm": blocks}


def attention_fwd_resources(cosine):
    """Phases 3 (cosine mode) and 6 (plain mode): the forward kernel's
    resources at D = 64 and D = 32."""
    import ctypes
    from bevgen_torch.ops import _build
    report = ptxas_report("cosine_attention")
    pint = ctypes.POINTER(ctypes.c_int)
    query = _build.function("cosine_attention", "attention_fwd_resources",
                            [ctypes.c_int, ctypes.c_int, pint, pint])
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    res = {}
    for D in (64, 32):
        kernel = f"attention_fwd_kernel<{D},{int(cosine)}>"
        err = query(D, int(cosine), ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0:
            raise SystemExit(f"resource query of {kernel} failed: CUDA error {err}")
        res[D] = print_resources(kernel, report, smem.value, blocks.value,
                                 FWD_THREADS)
    return res


def block_sparse_resources(backward):
    """Print, for the block-sparse forward kernel or the backward's dq and
    dk/dv kernels, the registers, shared memory (static + dynamic), spill
    bytes and resident blocks per SM; fail on a spill."""
    import ctypes
    from bevgen_torch.ops import _build
    source = "block_sparse_bwd" if backward else "block_sparse"
    report = ptxas_report(source)
    pint = ctypes.POINTER(ctypes.c_int)
    query = (_build.function(source, "block_sparse_bwd_resources",
                             [ctypes.c_int, pint, pint]) if backward else
             _build.function(source, "block_sparse_fwd_resources", [pint, pint]))
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    kernels = ((("block_sparse_bwd_dq_kernel", (0,)),
                ("block_sparse_bwd_dkdv_kernel", (1,)))
               if backward else (("block_sparse_fwd_kernel", ()),))
    for kernel, which in kernels:
        err = query(*which, ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0:
            raise SystemExit(f"resource query of {kernel} failed: CUDA error {err}")
        print_resources(kernel, report, smem.value, blocks.value, 128)


def tile_counts(plan):
    """(full, partial) listed 64 x 64 tiles of a device plan, all heads."""
    listed = int(plan.counts.sum())
    full = int(plan.full.sum())
    return full, listed - full


def check_block_sparse(name, preset, B, with_bias, seed, time_lse=None):
    """Row 9 against block_sparse_attention_reference, with times and the
    bound: 4 * D FLOP per (row, column) pair that the layout and the index
    rule keep, per (b, h); q, k, v, out (and the bias, the lse) moved once.
    The timed calls write the lse when `time_lse` (default: with a bias)."""
    import torch
    import torch.nn.functional as F
    from bevgen_torch.ops import block_sparse as bs
    cfg, layouts = ar_layout(preset)
    H, D = cfg.num_heads, cfg.hidden_size // cfg.num_heads
    L, blk = cfg.gpt_block_size, cfg.sparse_block_size
    nc, npad = cfg.num_cond_tokens, cfg.num_pad_tokens
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    bias = torch.randn(L, L, generator=g, device="cuda") if with_bias else None
    attn = bs.SparseAttention(layouts, blk, nc, npad)
    full, partial = tile_counts(attn.device_plan(L, q.device))
    with torch.inference_mode():
        out, lse = attn(q, k, v, bias, return_lse=True)
        torch.cuda.synchronize()
        ref, ref_lse = bs.block_sparse_attention_reference(
            q, k, v, torch.from_numpy(layouts), blk, nc, npad, bias,
            return_lse=True)
        err = (out.float() - ref.float()).abs()
        max_err, mean_err = err.max().item(), err.mean().item()
        lse_err = (lse - ref_lse).abs().max().item()
        del ref, ref_lse, err
        finite = bool(torch.isfinite(out).all())
        time_lse = with_bias if time_lse is None else time_lse
        ms = time_ms(lambda: attn(q, k, v, bias, return_lse=time_lse))
        plain_ms = time_ms(lambda: bs.block_sparse_attention_reference(
            q, k, v, torch.from_numpy(layouts), blk, nc, npad, bias),
            iters=3, warmup=1)
        scale = 1.0 / math.sqrt(D)
        keep = (bs.expand_layout_mask(torch.from_numpy(layouts).cuda(), blk, L)
                & bs.allowed_mask(L, nc, npad, "cuda")[None])
        kept = int(keep.sum())
        add = torch.zeros(L, L, device="cuda") if bias is None else bias * scale
        mask = torch.where(keep, add[None], torch.full((), bs.NEG_INF,
                                                       device="cuda"))
        mask = mask.to(q.dtype)[None].expand(B, H, L, L)
        del keep, add
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, scale=scale), iters=5)
        del mask
    flops = 4.0 * D * kept * B
    nbytes = (4 * B * H * L * D * 2 + (L * L * 4 if with_bias else 0)
              + (B * H * L * 4 if time_lse else 0) + layouts.size)
    bms, bound_by = bound(flops, nbytes)
    ok = (finite and max_err <= MAX_ABS_TOL and mean_err <= MEAN_ABS_TOL
          and lse_err <= LSE_TOL)
    print(f"[kernel] block_sparse {name}: {preset} B={B} H={H} L={L} D={D} "
          f"block={blk} kept pairs {kept} of {H * L * L}, listed tiles "
          f"{full} full + {partial} partial "
          f"bias={with_bias} lse={time_lse} max_abs_err={max_err:.3e} mean_abs_err="
          f"{mean_err:.3e} lse_err={lse_err:.3e} ms={ms:.4f} plain_ms="
          f"{plain_ms:.4f} library_ms={lib_ms:.4f} ms/library_ms="
          f"{ms / lib_ms:.3f} bound_ms={bms:.4f} "
          f"({bound_by}: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"block-sparse kernel {name} disagrees with its plain "
                         f"version (max {max_err:.3e}, mean {mean_err:.3e}, "
                         f"lse {lse_err:.3e}, finite={finite})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


def decode_resources(pl):
    """Row 11's cluster size, registers, shared memory (static + dynamic at
    prefix length pl), spill bytes (a spill fails the run), blocks per SM
    and the clusters the card holds at once."""
    import ctypes
    from bevgen_torch.ops import _build
    regs, static, spill_st, spill_ld = ptxas_report(
        "decode_attention")["decode_attention_kernel"]
    pint = ctypes.POINTER(ctypes.c_int)
    query = _build.function("decode_attention", "decode_attention_resources",
                            [ctypes.c_int, pint, pint, pint, pint])
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = query(pl, *(ctypes.byref(x) for x in vals))
    if err != 0:
        raise SystemExit(f"resource query of decode_attention_kernel failed: "
                         f"CUDA error {err}")
    if spill_st or spill_ld:
        raise SystemExit("decode_attention_kernel spills registers")
    cluster, smem, blocks, clusters = (x.value for x in vals)
    return {"cluster": cluster, "registers": regs, "smem": static + smem,
            "blocks_per_sm": blocks, "max_clusters": clusters}


def check_decode(b, H, pl, cap, seed, dh=64):
    """Row 11 against decode_attention_reference on prefix views of a
    cache of `cap` columns, with times, the bytes bound, the kernel's
    resources, a bit-identity check over two calls and the launches per
    call. In a generate each call reads another layer's cache, cold from
    memory, so the timed calls cycle through DECODE_CACHES caches, more
    than the card's L2."""
    import itertools
    import torch
    import torch.nn.functional as F
    from bevgen_torch.ops import decode_attention as da
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(b, H, dh, generator=g, device="cuda").bfloat16()
    kvs = []
    for _ in range(DECODE_CACHES):
        kc, vc = (torch.randn(b, H, cap, dh, generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        kvs.append((kc[:, :, :pl], vc[:, :, :pl]))
    k, v = kvs[0]
    # a causal row with a layout: some columns masked, the rest biased
    addend = 0.1 * torch.randn(H, pl, generator=g, device="cuda")
    drop = torch.rand(H, pl, generator=g, device="cuda") < 0.3
    drop[:, 0] = False
    addend = torch.where(drop, torch.full((), da.NEG_INF, device="cuda"), addend)
    scale = 1.0 / math.sqrt(dh)
    before = da.decode_attention_cuda.launches
    out = da.decode_attention(q, k, v, addend, scale)
    per_call = da.decode_attention_cuda.launches - before
    again = da.decode_attention(q, k, v, addend, scale)
    torch.cuda.synchronize()
    same = torch.equal(out, again)
    ref = da.decode_attention_reference(q, k, v, addend, scale)
    err = (out.float() - ref.float()).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    max_ref, mean_ref = ref.abs().max().item(), ref.abs().mean().item()
    finite = bool(torch.isfinite(out).all())
    res = decode_resources(pl)
    cycle = itertools.cycle(kvs)
    ms = time_ms(lambda: da.decode_attention(q, *next(cycle), addend, scale),
                 iters=200)
    plain_ms = time_ms(lambda: da.decode_attention_reference(
        q, *next(cycle), addend, scale), iters=50)
    mask = addend.to(q.dtype)[None, :, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], *next(cycle), attn_mask=mask, scale=scale), iters=200)
    nbytes = 2 * b * H * pl * dh * 2 + 2 * b * H * dh * 2 + H * pl * 4
    flops = 4.0 * b * H * pl * dh
    bms, bound_by = bound(flops, nbytes)
    ok = (finite and same and per_call == 1
          and max_err <= min(DECODE_TOL, DECODE_REL_TOL * max_ref)
          and mean_err <= DECODE_MEAN_REL_TOL * mean_ref)
    print(f"[kernel] decode_attention b={b} H={H} pl={pl} (cache {cap}) "
          f"dh={dh}: max_abs_err={max_err:.3e} (max |out| {max_ref:.3e}) "
          f"mean_abs_err={mean_err:.3e} (mean |out| {mean_ref:.3e}) "
          f"bit_identical={same} launches_per_call={per_call} "
          f"cluster={res['cluster']} blocks={b * H * res['cluster']} "
          f"registers={res['registers']} smem={res['smem']} "
          f"blocks_per_sm={res['blocks_per_sm']} "
          f"max_clusters={res['max_clusters']} ms={ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={lib_ms:.5f} ms/library_ms="
          f"{ms / lib_ms:.3f} bound_ms={bms:.5f} "
          f"({bound_by}: {nbytes / 1e6:.3f} MB) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"decode kernel disagrees with its plain version at "
                         f"b={b} H={H} pl={pl} (max {max_err:.3e} of "
                         f"{max_ref:.3e}, mean {mean_err:.3e} of {mean_ref:.3e}, "
                         f"bit_identical={same}, launches per call {per_call})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


def block_sparse_phase():
    """Phase 11: row 9's resources, then the kernel at both AR layouts, and
    with a bias and the lse."""
    block_sparse_resources(backward=False)
    return {
        "nuscenes_ar": check_block_sparse("layout", "nuscenes_ar", AR_BATCH,
                                          False, 20),
        "nuscenes_ar_tpu": check_block_sparse("layout", "nuscenes_ar_tpu",
                                              AR_BATCH, False, 21),
        "bias+lse": check_block_sparse("bias+lse", "nuscenes_ar", AR_BATCH,
                                       True, 22),
    }


def decode_phase(cfg):
    """Phase 12: row 11 over cache prefixes of every decode bucket's width
    (512, 1024, 1536, 2048 and the whole sequence), and at a row count that
    is not a multiple of 8."""
    tf = cfg.transformer
    L = tf.gpt_block_size
    stats = {pl: check_decode(AR_BATCH, tf.num_heads, pl, L, 30 + i)
             for i, pl in enumerate((512, 1024, 1536, 2048, L))}
    check_decode(1, 3, 70, 70, 33)
    return stats


def phase_time(phase, t0):
    """Print the seconds since `t0` as phase `phase`'s; return the time
    now."""
    now = time.perf_counter()
    print(f"[time] phase {phase}: {now - t0:.1f} s", flush=True)
    return now


def timed_phase(phase, fn, *args):
    """Run one phase, free the card's cached memory, print its time."""
    import torch
    t0 = time.perf_counter()
    result = fn(*args)
    torch.cuda.empty_cache()
    print(f"[time] phase {phase}: {time.perf_counter() - t0:.1f} s", flush=True)
    return result


def logit_agreement(a, b):
    import torch
    a, b = a.float(), b.float()
    cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(),
                                                dim=0).item()
    top1 = (a.argmax(-1) == b.argmax(-1)).float().mean().item()
    return cos, top1


def ar_inputs(cfg, B, seed):
    import numpy as np
    import torch
    from bevgen_torch.data.fake import fake_batch
    tf = cfg.transformer
    rng = np.random.default_rng(seed)
    ids = torch.as_tensor(rng.integers(0, tf.vocab_size, (
        B, tf.num_cams, tf.num_cam_tokens)), device="cuda")
    cond = torch.as_tensor(rng.integers(0, tf.cond_vocab_size, (
        B, tf.num_cond_tokens)), device="cuda")
    batch = fake_batch(cfg, B, seed=seed)
    ii, ei = (torch.as_tensor(batch[k], device="cuda")
              for k in ("intrinsics_inv", "extrinsics_inv"))
    return ids, cond, ii, ei, batch


def ar_forward_phase(cfg):
    """Phase 13: the full-width SparseGPT at b=1 through the block-sparse
    kernel, the plain version, and the cached decoder. Returns the kernel
    forward's launch counts by shape."""
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2 import ar_cached
    from bevgen_torch.models.stage2.gpt import SparseGPT
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import decode_attention as da
    tf = cfg.transformer
    t0 = time.perf_counter()
    model = init_weights(SparseGPT(tf, torch.bfloat16), seed=0).to("cuda").eval()
    ids, cond, ii, ei, _ = ar_inputs(cfg, 1, seed=7)
    layouts = torch.from_numpy(model.attn.layout)
    blk, nc, npad = tf.sparse_block_size, tf.num_cond_tokens, tf.num_pad_tokens
    with torch.inference_mode():
        bs.reset_launch_counts()
        lk = model(ids, cond, ii, ei, sampling=True)
        torch.cuda.synchronize()
        n_fwd = bs.block_sparse_attention_cuda.launches
        by_shape = dict(bs.block_sparse_attention_cuda.launches_by_shape)
        kernel_attn = model.attn
        model.attn = lambda q, k, v, bias: bs.block_sparse_attention_reference(
            q, k, v, layouts, blk, nc, npad, bias)
        try:
            lp = model(ids, cond, ii, ei, sampling=True)
        finally:
            model.attn = kernel_attn
    cos_p, top1_p = logit_agreement(lk, lp)
    print(f"[ar] full-width SparseGPT b=1 ({sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
          f"params, {time.perf_counter() - t0:.1f} s): block-sparse kernel vs "
          f"plain: cosine {cos_p:.6f} top-1 {top1_p:.4f}; {n_fwd} kernel "
          f"launches {by_shape}", flush=True)
    if n_fwd != tf.num_layers:
        raise SystemExit(f"expected {tf.num_layers} block-sparse launches per "
                         f"forward, got {n_fwd}")
    da.reset_launch_counts()
    t0 = time.perf_counter()
    lc = ar_cached.teacher_forced_logits(model, ids, cond, ii, ei)
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t0
    n_dec = da.decode_attention_cuda.launches
    cos_c, top1_c = logit_agreement(lc, lk)
    cos_cp, top1_cp = logit_agreement(lc, lp)
    print(f"[ar] teacher-forced cached decode ({tf_s:.2f} s): vs the kernel "
          f"forward cosine {cos_c:.6f} top-1 {top1_c:.4f}; vs the plain "
          f"forward cosine {cos_cp:.6f} top-1 {top1_cp:.4f}; {n_dec} decode "
          f"launches", flush=True)
    if n_dec != tf.num_layers * tf.num_img_tokens:
        raise SystemExit(f"expected {tf.num_layers * tf.num_img_tokens} decode "
                         f"launches, got {n_dec}")
    if not (min(cos_p, cos_c) >= AR_COS_MIN and min(top1_p, top1_c) >= AR_TOP1_MIN):
        raise SystemExit("full-width AR logits disagree (kernel vs plain, or "
                         "cached vs full forward)")
    return by_shape


def ar_generate_phase(cfg):
    """Phase 14: ARPipeline.generate_fn end to end at b=2."""
    import torch
    from bevgen_torch.models.stage2 import ar_cached
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import decode_attention as da
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    tf = cfg.transformer
    B = AR_BATCH
    t0 = time.perf_counter()
    pipe = ARPipeline.create(cfg, device="cuda").init_params(seed=0)
    _, _, _, _, batch = ar_inputs(cfg, B, seed=0)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    print(f"[ar-e2e] pipeline built in {time.perf_counter() - t0:.1f} s "
          f"({sum(p.numel() for p in pipe.parameters()) / 1e6:.1f} M params)",
          flush=True)

    def generate(seed):
        return pipe.generate_fn(*inputs, torch.Generator(
            device="cuda").manual_seed(seed), top_k=100)

    t0 = time.perf_counter()
    generate(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times, peak = [], 0
    for i in range(AR_TIMED):
        torch.cuda.synchronize()
        if i == 0:
            da.reset_launch_counts()
            bs.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        images, ids = generate(1 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated() - before)
        if i == 0:
            n_dec = da.decode_attention_cuda.launches
            by_pl = dict(da.decode_attention_cuda.launches_by_shape)
            n_bs = bs.block_sparse_attention_cuda.launches
    med = sorted(times)[len(times) // 2]
    n_img = B * tf.num_cams
    print(f"[ar-e2e] generate_fn b={B} cached top_k=100: warm-up {warm_s:.3f} s, "
          f"timed {', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s "
          f"= {n_img / med:.4f} images/s, peak above the resident set "
          f"{peak / 1e6:.1f} MB; launches in the first timed run: "
          f"decode {n_dec} {by_pl}, block-sparse {n_bs}", flush=True)
    if n_dec != tf.num_layers * tf.num_img_tokens or n_bs != 0:
        raise SystemExit(f"expected {tf.num_layers * tf.num_img_tokens} decode "
                         f"and 0 block-sparse launches, got {n_dec} and {n_bs}")
    H_img, W_img = tf.cam_res
    if tuple(images.shape) != (B, tf.num_cams, H_img, W_img, 3):
        raise SystemExit(f"bad image shape {tuple(images.shape)}")
    if not torch.isfinite(images).all():
        raise SystemExit("non-finite AR images")
    if ids.min() < 0 or ids.max() >= tf.vocab_size:
        raise SystemExit("AR ids out of range")
    gen = torch.Generator(device="cuda").manual_seed(9)
    with torch.inference_mode():
        seg, ii, ei = pipe.as_inputs(*inputs)
        t = [time.perf_counter()]
        cond_ids = pipe.encode_bev(seg)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        gids = ar_cached.ar_sample_cached(pipe.gpt, cond_ids, ii, ei, gen,
                                          top_k=100)
        torch.cuda.synchronize(); t.append(time.perf_counter())
        pipe.decode_tokens(gids)
        torch.cuda.synchronize(); t.append(time.perf_counter())
    print(f"[ar-e2e] images {tuple(images.shape)} finite, ids in "
          f"[{ids.min().item()}, {ids.max().item()}]; stages: encode_bev "
          f"{t[1] - t[0]:.4f} s, ar decode {t[2] - t[1]:.4f} s, "
          f"decode_tokens {t[3] - t[2]:.4f} s", flush=True)
    return {"s": med, "images_per_s": n_img / med, "by_pl": by_pl,
            "peak_mb": peak / 1e6}


def ar_greedy_phase(cfg):
    """Phase 15: greedy decoding at nuScenes widths with 2 layers, b=1, the
    full-forward sampler (block-sparse kernel) against the cached one."""
    import dataclasses
    import torch
    from bevgen_torch.models.stage2 import ar_cached
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    cfg = dataclasses.replace(cfg, transformer=cfg.transformer.replace(
        num_layers=2))
    tf = cfg.transformer
    pipe = ARPipeline.create(cfg, device="cuda").init_params(seed=1)
    _, _, _, _, batch = ar_inputs(cfg, 1, seed=1)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    gen = torch.Generator(device="cuda")
    bs.reset_launch_counts()
    t0 = time.perf_counter()
    _, ids_full = pipe.generate_fn(*inputs, gen.manual_seed(0), top_k=1,
                                   cached=False)
    torch.cuda.synchronize()
    full_s = time.perf_counter() - t0
    n_bs = bs.block_sparse_attention_cuda.launches
    t0 = time.perf_counter()
    _, ids_cached = pipe.generate_fn(*inputs, gen.manual_seed(0), top_k=1)
    torch.cuda.synchronize()
    cached_s = time.perf_counter() - t0
    same = (ids_full == ids_cached).flatten()
    agree = same.float().mean().item()
    fwd = pipe.gpt.fwd_order
    in_order = same[fwd]
    first = (int((~in_order).nonzero()[0, 0]) if not bool(in_order.all())
             else tf.num_img_tokens)
    # the cached decoder's greedy choice at every step of the full-forward
    # sampler's own trajectory (no compounding of an early flip), and one
    # full forward over that trajectory: by causality its logits at each
    # step are the ones the sampler chose from
    traj = ids_full.reshape(1, tf.num_cams, -1)
    tok = traj.reshape(1, -1)
    with torch.inference_mode():
        seg, ii, ei = pipe.as_inputs(*inputs)
        cond_ids = pipe.encode_bev(seg)
        lc = ar_cached.teacher_forced_logits(pipe.gpt, traj, cond_ids, ii, ei)
        lf = pipe.gpt(traj, cond_ids, ii, ei, sampling=True).float()
    # the logits are bf16 and tie often, and top_k=1 keeps every tied token:
    # a step agrees when the trajectory's token is among the best of it
    def best(logits):
        return logits.gather(-1, tok[..., None])[..., 0] >= logits.amax(-1)
    step_agree = best(lc).float().mean().item()
    replay = best(lf).float().mean().item()
    differ = ~best(lc)
    # where the choices differ: the full logits' gap between the token and
    # the cached decoder's choice, beside that step's largest
    # cached-vs-full logit difference
    pick = lc.argmax(-1)
    gap = (lf.gather(-1, tok[..., None]) - lf.gather(-1, pick[..., None]))[..., 0]
    noise = (lc - lf).abs().amax(-1)
    top2 = lf.topk(2, dim=-1).values
    tied = (top2[..., 0] == top2[..., 1]).float().mean().item()
    n_diff = int(differ.sum())
    print(f"[ar-greedy] 2 layers b=1 top_k=1: full-forward sampler {full_s:.2f} s "
          f"({n_bs} block-sparse launches), cached {cached_s:.2f} s; per-step "
          f"greedy agreement on the full sampler's trajectory {step_agree:.4f} "
          f"(min {GREEDY_AGREE_MIN}), the full forward replays it at "
          f"{replay:.4f}; free-running token agreement {agree:.4f}, first "
          f"differing decode step {first} of {tf.num_img_tokens}; steps whose "
          f"best two full logits tie {tied:.4f}", flush=True)
    if n_diff:
        print(f"[ar-greedy] {n_diff} steps choose differently: full-logit gap "
              f"between the token and the cached choice max "
              f"{gap[differ].max().item():.5f}, that step's largest "
              f"cached-vs-full logit difference max "
              f"{noise[differ].max().item():.5f}", flush=True)
    if n_bs != tf.num_layers * tf.num_img_tokens:
        raise SystemExit(f"expected {tf.num_layers * tf.num_img_tokens} "
                         f"block-sparse launches, got {n_bs}")
    if not min(step_agree, replay) >= GREEDY_AGREE_MIN:
        raise SystemExit("greedy decoding disagrees between the cached and "
                         "the full-forward sampler")
    return step_agree


# The AR training path. The block-sparse backward against its plain version
# (fp32 on the same bf16 inputs, with the forward kernel's out and lse) is
# held to row 8's bounds, BWD_REL_L2_TOL and BWD_MAX_REL_TOL, for the same
# reason: P and dS are rounded to bf16 before the products and dq, dk, dv
# are written in bf16; dbias sums fp32 dS. The Function's gradients and the
# model's are held to GRAD_COS_MIN and MODEL_GRAD_COS_MIN: bf16 rounding on
# both sides, in different places, through 2368 keys and (phase 19) 8
# layers of random weights.
AR_TRAIN_BATCH = 4
AR_TRAIN_TIMED = 5
# phase 19's depth cut, 8 of nuscenes_ar's 24 layers at full width: the
# plain path keeps (1, 16, 2368, 2368) fp32 scores and weights of every
# layer for its backward, about 1.5 GB a layer
AR_GRAD_LAYERS = 8


def sparse_bwd_inputs(H, L, B, with_bias, seed, D=64):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(B, H, L, D, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    do = (0.1 * torch.randn(B, H, L, D, generator=g, device="cuda")).bfloat16()
    bias = torch.randn(L, L, generator=g, device="cuda") if with_bias else None
    return q, k, v, do, bias


def sparse_sdpa_bwd_ms(q, k, v, keep, bias, do):
    """library_ms of the block-sparse backward: torch.autograd.grad of q,
    k, v through one F.scaled_dot_product_attention call with the expanded
    additive mask (a constant: no dbias), minus that call's forward. Timed
    only."""
    import torch
    import torch.nn.functional as F
    from bevgen_torch.ops import block_sparse as bs
    B, H, L, D = q.shape
    scale = 1.0 / math.sqrt(D)
    add = torch.zeros(L, L, device="cuda") if bias is None else bias * scale
    mask = torch.where(keep, add[None], torch.full((), bs.NEG_INF, device="cuda"))
    mask = mask.to(q.dtype)[None].expand(B, H, L, L)
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask, scale=scale)

    both = time_ms(lambda: torch.autograd.grad(fwd(), leaves, do), iters=5)
    with torch.no_grad():
        only = time_ms(fwd, iters=5)
    return both - only


def check_block_sparse_bwd(name, layouts, L, blk, nc, npad, B, with_bias, seed):
    """Row 10 against block_sparse_attention_bwd_reference, with times and
    the bound: 5 products of D multiply-adds (10 D FLOP) per kept (row,
    column) pair per (b, h); q, k, v, out, dO, lse (and the bias) read once,
    dq, dk, dv (and dbias) written once."""
    import torch
    from bevgen_torch.ops import block_sparse as bs
    H = layouts.shape[0]
    q, k, v, do, bias = sparse_bwd_inputs(H, L, B, with_bias, seed)
    D = q.shape[-1]
    attn = bs.SparseAttention(layouts, blk, nc, npad)
    plan = attn.device_plan(L, q.device)
    full, partial = tile_counts(plan)
    lt = torch.from_numpy(layouts)
    with torch.no_grad():
        out, lse = attn(q, k, v, bias, return_lse=True)
        args = (q, k, v, plan.layout, plan.counts, plan.indices, plan.full,
                plan.counts_t, plan.indices_t, plan.full_t, blk, nc, npad, bias,
                out, do, lse)
        got = bs.block_sparse_attention_bwd_cuda(*args)
        torch.cuda.synchronize()
        want = bs.block_sparse_attention_bwd_reference(
            q.float(), k.float(), v.float(), lt, blk, nc, npad, bias, out, do, lse)
        errs, ok, max_err = {}, True, 0.0
        for key, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
            if w is None:
                continue
            mx, rl2, ref_max = rel_err(a, w)
            errs[key] = (mx, rl2)
            max_err = max(max_err, mx)
            ok = (ok and bool(torch.isfinite(a).all()) and rl2 <= BWD_REL_L2_TOL
                  and mx <= BWD_MAX_REL_TOL * ref_max)
        del want, got
        ms = time_ms(lambda: bs.block_sparse_attention_bwd_cuda(*args))
        plain_ms = time_ms(lambda: bs.block_sparse_attention_bwd_reference(
            q.float(), k.float(), v.float(), lt, blk, nc, npad, bias, out, do,
            lse), iters=3, warmup=1)
        keep = bs.keep_mask(lt, blk, L, nc, npad, "cuda")
        kept = int(keep.sum())
    lib_ms = sparse_sdpa_bwd_ms(q, k, v, keep, bias, do)
    del keep
    flops = 10.0 * D * kept * B
    nbytes = (8 * B * H * L * D * 2 + B * H * L * 4
              + (2 * L * L * 4 if with_bias else 0) + layouts.size)
    bms, bound_by = bound(flops, nbytes)
    print(f"[kernel] block_sparse_bwd {name}: B={B} H={H} L={L} D={D} "
          f"block={blk} kept pairs {kept}, listed tiles {full} full + "
          f"{partial} partial, bias={with_bias} "
          + " ".join(f"{k_}: max_abs_err={e[0]:.3e} rel_l2={e[1]:.3e}"
                     for k_, e in errs.items())
          + f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
          f"(no dbias) ms/library_ms={ms / lib_ms:.3f} bound_ms={bms:.4f} "
          f"({bound_by}: {flops / 1e9:.2f} "
          f"GFLOP, {nbytes / 1e6:.2f} MB) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"block-sparse backward {name} disagrees with its "
                         f"plain version (rel L2 > {BWD_REL_L2_TOL} or max > "
                         f"{BWD_MAX_REL_TOL} of the largest entry)")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


def block_sparse_bwd_phase():
    """Phase 16: row 10's resources (dq and dk/dv kernels), then the
    kernels at nuscenes_ar b=4 (the training shape), at the
    nuscenes_ar_tpu layout, with an (L, L) bias, and at a small unaligned
    case with condition columns and pad rows; and row 9 with the lse at the
    training shape."""
    import numpy as np
    block_sparse_resources(backward=True)

    def preset_case(name, preset, B, with_bias, seed):
        cfg, layouts = ar_layout(preset)
        return check_block_sparse_bwd(
            name, layouts, cfg.gpt_block_size, cfg.sparse_block_size,
            cfg.num_cond_tokens, cfg.num_pad_tokens, B, with_bias, seed)

    stats = {
        "nuscenes_ar": preset_case("train", "nuscenes_ar", AR_TRAIN_BATCH,
                                   False, 50),
        "fwd+lse": check_block_sparse("train b4 +lse", "nuscenes_ar",
                                      AR_TRAIN_BATCH, False, 53, time_lse=True),
    }
    preset_case("layout", "nuscenes_ar_tpu", AR_TRAIN_BATCH, False, 51)
    preset_case("bias", "nuscenes_ar", AR_BATCH, True, 52)
    # unaligned: L = 200 (not a multiple of 64), 8-token blocks, 24
    # condition columns, 8 pad rows, a random causal layout
    L, blk, nc, npad, H = 200, 8, 24, 8, 4
    nb = -(-L // blk)
    rng = np.random.default_rng(54)
    layout = (rng.uniform(size=(H, nb, nb)) < 0.5) & np.tril(np.ones((nb, nb), bool))
    layout |= np.eye(nb, dtype=bool)
    layout[:, (L - npad) // blk:, 0] = True
    check_block_sparse_bwd("unaligned+pad", layout.astype(np.int64), L, blk,
                           nc, npad, 2, True, 55)
    return stats


def ar_function_grads_phase(cfg):
    """Phase 17: BlockSparseAttentionFn's gradients at the nuscenes_ar shape,
    b=1, against autograd through the plain forward on the same bf16
    inputs, without and with an (L, L) bias; the output carries the
    Function's grad_fn."""
    import torch
    from bevgen_torch.models import masks
    from bevgen_torch.ops import block_sparse as bs
    tf = cfg.transformer
    layouts = masks.sparse_masks(tf).layouts
    L, blk = tf.gpt_block_size, tf.sparse_block_size
    nc, npad = tf.num_cond_tokens, tf.num_pad_tokens
    attn = bs.SparseAttention(layouts, blk, nc, npad)
    lt = torch.from_numpy(layouts)
    result = {}
    for with_bias in (False, True):
        q, k, v, do, bias = sparse_bwd_inputs(tf.num_heads, L, 1, with_bias,
                                              60 + with_bias)
        leaves = [t.detach().clone().requires_grad_()
                  for t in (q, k, v, bias) if t is not None]
        b = leaves[3] if with_bias else None
        out = attn(*leaves[:3], b)
        if not isinstance(out.grad_fn, bs.BlockSparseAttentionFn._backward_cls):
            raise SystemExit("the CUDA block-sparse output has no "
                             "BlockSparseAttentionFn grad_fn")
        got = torch.autograd.grad(out, leaves, do)
        ref = bs.block_sparse_attention_reference(*leaves[:3], lt, blk, nc,
                                                  npad, b)
        want = torch.autograd.grad(ref, leaves, do)
        cos = {n: torch.nn.functional.cosine_similarity(
            a.float().flatten(), w.float().flatten(), dim=0).item()
            for n, a, w in zip(("dq", "dk", "dv", "dbias"), got, want)}
        print(f"[grad] BlockSparseAttentionFn vs autograd through the plain "
              f"forward, nuscenes_ar b=1 bias={with_bias}: cosine "
              + " ".join(f"{n}={c:.6f}" for n, c in cos.items())
              + f" (min {GRAD_COS_MIN})", flush=True)
        if not min(cos.values()) >= GRAD_COS_MIN:
            raise SystemExit("BlockSparseAttentionFn's gradients disagree "
                             "with the plain version's")
        result[with_bias] = cos
    return result


def ar_train_phase(cfg):
    """Phase 18: the full-width, full-depth nuscenes_ar train step at b=4,
    timed, with its launch counts. Returns (model, stats)."""
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2.gpt import SparseGPT
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import decode_attention as da
    from bevgen_torch.scripts.train_stage2 import fake_batches
    from bevgen_torch.training import optim, trainer
    tf = cfg.transformer
    B = AR_TRAIN_BATCH
    t0 = time.perf_counter()
    model = init_weights(SparseGPT(tf, torch.bfloat16, param_dtype=torch.float32),
                         seed=0).to("cuda")
    state = trainer.create_ar_train_state(
        model, optim.maskgit_optimizer(model, 1e-4, warmup_steps=1))
    step = trainer.make_ar_train_step()
    batches = fake_batches(tf, B, seed=0)
    print(f"[ar-train] SparseGPT fp32 params / bf16 compute, "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M params, "
          f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    step(state, to_device(next(batches)))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    times, rows = [], []
    for i in range(AR_TRAIN_TIMED):
        batch = to_device(next(batches))
        torch.cuda.synchronize()
        if i == 0:
            bs.reset_launch_counts()
            da.reset_launch_counts()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            fwd = dict(bs.block_sparse_attention_cuda.launches_by_shape)
            bwd = dict(bs.block_sparse_attention_bwd_cuda.launches_by_shape)
            n_fwd = bs.block_sparse_attention_cuda.launches
            n_bwd = bs.block_sparse_attention_bwd_cuda.launches
            n_dec = da.decode_attention_cuda.launches
        rows.append({k: float(v) for k, v in m.items()})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    med = sorted(times)[len(times) // 2]
    tokens = B * tf.num_img_tokens
    print(f"[ar-train] nuscenes_ar b={B}: warm-up step {warm_s:.3f} s, timed "
          f"{', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s = "
          f"{tokens / med:.1f} image tokens/s; peak memory {peak_gb:.2f} GB; "
          f"loss {' '.join('%.4f' % r['loss'] for r in rows)}, grad_norm "
          f"{' '.join('%.4f' % r['grad_norm'] for r in rows)}", flush=True)
    print(f"[ar-train] kernel launches in the first timed step: block-sparse "
          f"forward {n_fwd} {fwd}, backward {n_bwd} {bwd}, decode {n_dec}",
          flush=True)
    layers = tf.num_layers
    if n_fwd != layers or n_bwd != 2 * layers or n_dec != 0:
        raise SystemExit(f"expected {layers} block-sparse forward, "
                         f"{2 * layers} backward and 0 decode launches per "
                         f"step, got {n_fwd}, {n_bwd} and {n_dec}")
    if not all(math.isfinite(v) for r in rows for v in r.values()):
        raise SystemExit(f"AR train step metrics not finite: {rows}")
    return model, {"fwd": fwd, "bwd": bwd, "step_s": med,
                   "tokens_per_s": tokens / med, "peak_gb": peak_gb}


def ar_grad_group(name: str) -> str:
    head = name.split(".")[0]
    if head.startswith("block_"):
        return head
    if head in ("ln_f", "head"):
        return "head"
    return "camera_bias" if head == "camera_bias_emb" else "embeddings"


def ar_model_grads_phase(cfg):
    """Phase 19: one AR loss backward at b=1, full width and AR_GRAD_LAYERS
    layers, through the kernels and through the plain versions; cosine of
    the gradient of each parameter group."""
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2.ar import ar_loss
    from bevgen_torch.models.stage2.gpt import SparseGPT
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.scripts.train_stage2 import fake_batches
    tf = cfg.transformer.replace(num_layers=AR_GRAD_LAYERS)
    model = init_weights(SparseGPT(tf, torch.bfloat16, param_dtype=torch.float32),
                         seed=1).to("cuda")
    batch = to_device(next(fake_batches(tf, 1, seed=4)))
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    layouts = torch.from_numpy(model.attn.layout)
    blk, nc, npad = tf.sparse_block_size, tf.num_cond_tokens, tf.num_pad_tokens

    def grads():
        loss = ar_loss(model, batch["tokens"], batch["cond_ids"],
                       batch["intrinsics_inv"], batch["extrinsics_inv"],
                       deterministic=True)
        return float(loss.detach()), torch.autograd.grad(loss, params)

    before = bs.block_sparse_attention_bwd_cuda.launches
    loss_k, gk = grads()
    if bs.block_sparse_attention_bwd_cuda.launches != before + 2 * AR_GRAD_LAYERS:
        raise SystemExit("the kernel path did not launch the backward kernels")
    kernel_attn = model.attn
    model.attn = lambda q, k, v, bias: bs.block_sparse_attention_reference(
        q, k, v, layouts, blk, nc, npad, bias)
    try:
        loss_p, gp = grads()
    finally:
        model.attn = kernel_attn
    groups = {}
    for n, a, b in zip(names, gk, gp):
        ga, gb = groups.setdefault(ar_grad_group(n), ([], []))
        ga.append(a.float().flatten())
        gb.append(b.float().flatten())
    cos = {k: torch.nn.functional.cosine_similarity(
        torch.cat(a), torch.cat(b), dim=0).item() for k, (a, b) in groups.items()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:4]
    print(f"[ar-grad] {AR_GRAD_LAYERS}-layer full-width b=1 loss {loss_k:.5f} "
          f"(kernels) vs {loss_p:.5f} (plain); gradient cosine over "
          f"{len(cos)} parameter groups: min {worst[0][1]:.6f} (bound "
          f"{MODEL_GRAD_COS_MIN}), lowest "
          + ", ".join(f"{k}={c:.6f}" for k, c in worst)
          + f", mean {sum(cos.values()) / len(cos):.6f}", flush=True)
    if not worst[0][1] >= MODEL_GRAD_COS_MIN:
        raise SystemExit("AR gradients disagree between the kernels and the "
                         "plain versions")
    return cos


def ar_ce_falls_phase(model, cfg):
    """Phase 20: from the seeded init, the AR CE over CE_STEPS steps on one
    repeated b=4 batch, base_lr 3e-4, warm-up 1 (the first update has lr
    0)."""
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.scripts.train_stage2 import fake_batches
    from bevgen_torch.training import optim, trainer
    tf = cfg.transformer
    init_weights(model, seed=0)
    batch = to_device(next(fake_batches(tf, AR_TRAIN_BATCH, seed=1)))
    state = trainer.create_ar_train_state(model, optim.maskgit_optimizer(
        model, 3e-4, warmup_steps=1, total_steps=CE_STEPS))
    step = trainer.make_ar_train_step()
    ces = [float(step(state, batch)["loss"]) for _ in range(CE_STEPS)]
    print(f"[ar-train] CE on one repeated batch over {CE_STEPS} steps: "
          f"{' '.join(f'{c:.4f}' for c in ces)}", flush=True)
    if not (all(math.isfinite(c) for c in ces) and ces[-1] < ces[0]):
        raise SystemExit("the AR CE did not fall on a repeated batch")
    return ces


# The glue kernels against their plain twins (fp32 on the same bf16 inputs;
# the residual + LayerNorm's normed output against the twin on its rounded
# x_new, which must equal the twin's bit for bit). Each kernel rounds its
# output to bf16, half a step: 2^-8 of |out|, so the residual and standalone
# norms of unit-normal rows (outputs under about 5) are held to 2e-2. The
# GEGLU's h = gate * gelu(a), a product of two normals, is heavy-tailed:
# at these sizes its normed values pass 20, where half a bf16 step is 0.06,
# and the kernel rounds h to bf16 before the statistics too, (2^-8 + 2^-9)
# of |out| in all; it is held to one bf16 step, max(2e-2, 2^-7 |out|).
GLUE_MAX_ABS_TOL = 2e-2
GLUE_MEAN_ABS_TOL = 2e-3
PEAK_FP32_FLOPS = 67e12     # H100 SXM fp32 outside the tensor cores
# the timed calls cycle through enough input sets to exceed the 50 MB L2,
# as a forward finds its activations
GLUE_COLD_BYTES = 150e6
# fp32 operations per output element, erff counted as one: the residual
# add, the two sums and the normalisation; gelu and the gate product
# besides; the normalisation alone
GLUE_FLOPS = {"residual": 7, "geglu": 12, "layernorm": 6}


def glue_case(kind, rows, F, seed, offset=0):
    """Inputs of one glue kernel: (input sets, gamma, input bytes). With
    `offset`, each input is a contiguous view that starts `offset` bf16
    into its storage (off 16 bytes unless offset is a multiple of 8)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    width = 2 * F if kind == "geglu" else F
    n_in = 2 if kind == "residual" else 1
    in_bytes = n_in * rows * width * 2
    n_sets = max(1, min(16, math.ceil(GLUE_COLD_BYTES / in_bytes)))

    def one():
        buf = torch.randn(rows * width + offset, generator=g,
                          device="cuda").bfloat16()
        return buf[offset:].view(rows, width)

    sets = [tuple(one() for _ in range(n_in)) for _ in range(n_sets)]
    gamma = 1.0 + 0.1 * torch.randn(F, generator=g, device="cuda")
    return sets, gamma, in_bytes


def glue_calls(kind, gamma):
    """(kernel, fp32 twin, one PyTorch call or None, eager chain or None)
    of one glue kernel, each taking an input set."""
    import torch
    import torch.nn.functional as F_
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    F = gamma.shape[0]

    def eager_norm(v):
        # LayerNormG without the glue: fp32 layer_norm, back to bf16
        return F_.layer_norm(v.float(), (F,), gamma, None, 1e-5).bfloat16()

    if kind == "residual":
        return (lambda x, d: fg.residual_layernorm_cuda(x, d, gamma),
                lambda x, d: fg.residual_layernorm_reference(x.float(), d.float(),
                                                             gamma),
                None, lambda x, d: eager_norm(x + d))
    if kind == "geglu":
        def chain(y):
            a, gate = y.chunk(2, dim=-1)
            return eager_norm(gate * F_.gelu(a, approximate="none"))
        return (lambda y: fg.geglu_layernorm_cuda(y, gamma),
                lambda y: fg.geglu_layernorm_reference(y.float(), gamma),
                None, chain)
    # layer_norm takes no fp32 weight with a bf16 input: gamma is cast
    # outside the timed call
    gamma_bf16 = gamma.bfloat16()
    return (lambda x: ln.layernorm_cuda(x, gamma),
            lambda x: ln.layernorm_reference(x.float(), gamma),
            lambda x: F_.layer_norm(x, (F,), gamma_bf16, None, 1e-5), None)


def check_glue(name, kind, rows, F, seed, offset=0):
    """Rows 12-14 against their twins, with times and the bound: the bytes
    of the inputs read once and the outputs written once (gamma too), and
    GLUE_FLOPS fp32 operations per output element. Row 14 also reports the
    form of the kernel its first call took (`layernorm_variant`)."""
    import itertools
    import torch
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    sets, gamma, in_bytes = glue_case(kind, rows, F, seed, offset)
    kernel, twin, library, chain = glue_calls(kind, gamma)
    args = sets[0]
    before = dict(ln.layernorm_cuda.launches_by_variant)
    out = kernel(*args)
    torch.cuda.synchronize()
    took = [v for v, n in ln.layernorm_cuda.launches_by_variant.items()
            if n != before[v]]
    exact = True
    if kind == "residual":
        want_x, _ = fg.residual_layernorm_reference(*args, gamma)
        exact = torch.equal(out[0], want_x)
        got, want = out[1], ln.layernorm_reference(want_x.float(), gamma)
    else:
        got, want = out, twin(*args)
    err = (got.float() - want).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    tol = (torch.clamp(2.0 ** -7 * want.abs(), min=GLUE_MAX_ABS_TOL)
           if kind == "geglu" else torch.full_like(want, GLUE_MAX_ABS_TOL))
    within = bool((err <= tol).all())
    finite = bool(torch.isfinite(got).all())
    max_ref = want.abs().max().item()
    del err, tol, want, out, got
    cycle = itertools.cycle(sets)
    ms = time_ms(lambda: kernel(*next(cycle)), iters=50)
    plain_ms = time_ms(lambda: twin(*next(cycle)), iters=10)
    lib_ms = (time_ms(lambda: library(*next(cycle)), iters=50)
              if library is not None else None)
    chain_ms = (time_ms(lambda: chain(*next(cycle)), iters=50)
                if chain is not None else None)
    n_out = 2 if kind == "residual" else 1
    nbytes = in_bytes + n_out * rows * F * 2 + F * 4
    flops = GLUE_FLOPS[kind] * rows * F
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    bms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    ok = exact and finite and within and mean_err <= GLUE_MEAN_ABS_TOL
    print(f"[glue] {kind} {name}: rows={rows} F={F} "
          + (f"x_new bit-exact={exact} " if kind == "residual" else "")
          + (f"variant={'+'.join(took)} " if kind == "layernorm" else "")
          + f"max_abs_err={max_err:.3e} (max |out| {max_ref:.2f}) mean_abs_err="
          f"{mean_err:.3e} ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms="
          f"{lib_ms if lib_ms is None else round(lib_ms, 5)} eager_chain_ms="
          f"{chain_ms if chain_ms is None else round(chain_ms, 5)} bound_ms="
          f"{bms:.5f} ({bound_by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} "
          f"GFLOP) timed over {len(sets)} input set(s) -> "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"glue kernel {kind} {name} disagrees with its twin "
                         f"(x_new exact {exact}, max {max_err:.3e}, mean "
                         f"{mean_err:.3e}, finite {finite})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms,
            **({"variant": "+".join(took)} if kind == "layernorm" else {})}


def layernorm_resources():
    """Row 14's instances: the register form's (`layernorm_warp_kernel<NCH>`,
    NCH chunks of 8 a lane: widths up to 256 NCH) and the general form's
    (`layernorm_block_kernel<V>`, at D = 1024): registers, shared memory,
    spill bytes and resident blocks per SM; fail on a spill."""
    import ctypes
    from bevgen_torch.ops import _build
    report = ptxas_report("layernorm")
    pint = ctypes.POINTER(ctypes.c_int)
    query = _build.function("layernorm", "layernorm_resources",
                            [ctypes.c_int, ctypes.c_int, pint, pint])
    smem, blocks = ctypes.c_int(0), ctypes.c_int(0)
    res = {}
    for which, kernel, threads in (
            [(n, f"layernorm_warp_kernel<{n}>", 256) for n in (1, 2, 4, 8)]
            + [(-v, f"layernorm_block_kernel<{v}>", 256) for v in (2, 1)]):
        err = query(which, 1024, ctypes.byref(smem), ctypes.byref(blocks))
        if err != 0:
            raise SystemExit(f"resource query of {kernel} failed: CUDA error {err}")
        res[kernel] = print_resources(kernel, report, smem.value, blocks.value,
                                      threads)
    return res


def glue_kernels_phase(cfg):
    """Phase 21: rows 12-14 at the MUSE serving (b=2) and training (b=8)
    shapes, and ragged cases."""
    tf = cfg.transformer
    n = tf.num_img_tokens
    dim = tf.num_embed
    inner = int(dim * tf.ff_mult * 2 / 3)
    stats = {}
    for b in (2, TRAIN_BATCH):
        stats[("residual", b)] = check_glue(f"b{b}", "residual", b * n, dim, 70 + b)
        stats[("geglu", b)] = check_glue(f"b{b}", "geglu", b * n, inner, 80 + b)
    check_glue("ragged", "residual", 13, dim, 90)
    check_glue("odd width", "residual", 9, 1003, 91)
    check_glue("tiny_test width", "geglu", 37, 170, 92)
    # row 14: both forms, their resources, the register form at the
    # (2, 1792, 1024) shape; the general form on the ragged case and on the
    # same shape through views 4 bytes off 16
    layernorm_resources()
    stats[("layernorm", 2)] = check_glue("(2, 1792, 1024)", "layernorm", 2 * n,
                                         dim, 93)
    stats[("layernorm", "ragged")] = check_glue(
        "ragged (3, 13, 1003)", "layernorm", 39, 1003, 94)
    stats[("layernorm", "misaligned")] = check_glue(
        "(2, 1792, 1024) misaligned", "layernorm", 2 * n, dim, 96, offset=2)
    for key, want in ((2, "warp"), ("ragged", "block"),
                      ("misaligned", "block")):
        if stats[("layernorm", key)]["variant"] != want:
            raise SystemExit(f"row 14 case {key} took the "
                             f"{stats[('layernorm', key)]['variant']} form, "
                             f"expected {want}")
    return stats


def glue_pipelines(cfg):
    """The MUSE pipeline of phase 4 (seed-0 weights) and the same weights
    under use_fused_glue=True."""
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    plain = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=0)
    glue_cfg = dataclasses.replace(cfg, transformer=cfg.transformer.replace(
        use_fused_glue=True))
    glue = BEVGenPipeline.create(glue_cfg, device="cuda")
    glue.load_state_dict(plain.state_dict())
    return plain, glue


# phase 22's A/B: pairs of generates, glue on and off, in turns (which
# goes first alternates), after two warm-ups of each
GLUE_AB_PAIRS = 10


def glue_generate_phase(cfg, plain, glue, phase4_med):
    """Phase 22: generate_fn with the glue on against it off, GLUE_AB_PAIRS
    pairs in turns on the same weights, inputs and seeds; the launch counts
    of the first timed glue run."""
    import torch
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.ops import fused_glue as fg
    tf = cfg.transformer
    B = 2
    batch = fake_batch(cfg, batch_size=B, seed=0)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])

    def generate(pipe, seed):
        t0 = time.perf_counter()
        out = pipe.generate_fn(*inputs, torch.Generator(
            device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for seed in (0, 1):
        generate(glue, seed)
        generate(plain, seed)
    times = {"glue": [], "plain": []}
    for i, seed in enumerate(range(2, 2 + GLUE_AB_PAIRS)):
        order = ("glue", "plain") if i % 2 == 0 else ("plain", "glue")
        for which in order:
            if i == 0 and which == "glue":
                ca.reset_launch_counts()
                fg.reset_launch_counts()
            (images, ids), s = generate(glue if which == "glue" else plain, seed)
            times[which].append(s)
            if i == 0 and which == "glue":
                counts = (fg.residual_layernorm_cuda.launches,
                          fg.geglu_layernorm_cuda.launches,
                          ca.cosine_attention_cuda.launches)
                g_images, g_ids = images, ids
    n_img = B * tf.num_cams
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    wins = sum(g < p for g, p in zip(times["glue"], times["plain"]))
    print(f"[glue-e2e] generate_fn b={B}, {GLUE_AB_PAIRS} pairs in turns: "
          f"use_fused_glue=true {', '.join(f'{t:.4f}' for t in times['glue'])} "
          f"s, median {med['glue']:.4f} s = {n_img / med['glue']:.3f} "
          f"images/s; off {', '.join(f'{t:.4f}' for t in times['plain'])} s, "
          f"median {med['plain']:.4f} s = {n_img / med['plain']:.3f} images/s; "
          f"glue faster in {wins} of {GLUE_AB_PAIRS} pairs; phase 4 median "
          f"{phase4_med:.4f} s = {n_img / phase4_med:.3f} images/s", flush=True)
    steps = cfg.muse.sample_iterations
    forwards = steps + steps - 1
    want = (forwards * 3 * tf.num_layers, forwards * tf.num_layers,
            forwards * 2 * tf.num_layers)
    print(f"[glue-e2e] launches in the first timed glue generate: residual + "
          f"LayerNorm {counts[0]}, GEGLU + LayerNorm {counts[1]}, attention "
          f"{counts[2]} (expected {want})", flush=True)
    if counts != want:
        raise SystemExit(f"expected {want} launches per glue generate, got "
                         f"{counts}")
    H_img, W_img = tf.cam_res
    if tuple(g_images.shape) != (B, tf.num_cams, H_img, W_img, 3):
        raise SystemExit(f"bad image shape {tuple(g_images.shape)}")
    if not torch.isfinite(g_images).all():
        raise SystemExit("non-finite images with the glue on")
    if g_ids.min() < 0 or g_ids.max() >= tf.vocab_size:
        raise SystemExit("ids out of range with the glue on")
    return {"residual_ln": counts[0], "geglu_ln": counts[1], "s": med,
            "images_per_s": {k: n_img / v for k, v in med.items()}}


def glue_forward_phase(cfg, plain, glue):
    """Phase 23: one full-width forward with the glue against the same
    forward without it, on the same weights and decode cache."""
    import torch
    from bevgen_torch.data.fake import fake_batch
    tf = cfg.transformer
    B = 2
    batch = fake_batch(cfg, batch_size=B, seed=0)
    g = torch.Generator(device="cuda").manual_seed(3)
    fids = torch.randint(0, tf.vocab_size + 1, (B, tf.num_cams,
                                                tf.num_cam_tokens),
                         generator=g, device="cuda")
    with torch.inference_mode():
        seg, ii, ei = (torch.as_tensor(batch[k], device="cuda") for k in
                       ("segmentation", "intrinsics_inv", "extrinsics_inv"))
        cond_ids = plain.encode_bev(seg)
        cache = plain.maskgit.build_cache(cond_ids, ii, ei)
        lg = glue.maskgit(fids, cond_ids, ii, ei, cache=cache).logits.float()
        lp = plain.maskgit(fids, cond_ids, ii, ei, cache=cache).logits.float()
    cos, top1 = logit_agreement(lg, lp)
    print(f"[glue-forward] full-width logits, glue vs no glue: cosine "
          f"{cos:.6f} (min {LOGIT_COS_MIN}), top-1 agreement {top1:.4f} (min "
          f"{TOP1_AGREE_MIN}), max abs diff {(lg - lp).abs().max().item():.4f}",
          flush=True)
    if not (cos >= LOGIT_COS_MIN and top1 >= TOP1_AGREE_MIN):
        raise SystemExit("full-width forward disagrees between the glue and "
                         "the plain form")
    return cos, top1


def glue_grads_phase(cfg):
    """Phase 24's second half: one loss backward at b=1 with the glue and
    without it, on the same weights and draws; cosine of the gradient of
    each parameter group."""
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage2.maskgit import MaskGit, maskgit_loss
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.scripts.train_stage2 import fake_batches
    tf = cfg.transformer
    models = {}
    for glue in (False, True):
        models[glue] = MaskGit(tf.replace(use_fused_glue=glue), cfg.muse,
                               dtype=torch.bfloat16, param_dtype=torch.float32)
    init_weights(models[False], seed=0)
    models[True].load_state_dict(models[False].state_dict())
    batch = to_device(next(fake_batches(tf, 1, seed=4)))
    mask = torch.rand(batch["tokens"].shape, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(5)) < 0.5
    noise = torch.zeros(tuple(batch["tokens"].shape) + (tf.vocab_size,),
                        device="cuda")

    def grads(model):
        model.to("cuda")
        out = maskgit_loss(model, batch["tokens"], batch["cond_ids"],
                           batch["intrinsics_inv"], batch["extrinsics_inv"],
                           generator=torch.Generator(device="cuda").manual_seed(6),
                           mask_override=mask, gumbel_noise=noise)
        names = [n for n, _ in model.named_parameters()]
        g = torch.autograd.grad(out.loss, [p for _, p in model.named_parameters()])
        return float(out.loss.detach()), dict(zip(names, g))

    before = fg.residual_layernorm_cuda.launches
    loss_g, gg = grads(models[True])
    if fg.residual_layernorm_cuda.launches == before:
        raise SystemExit("the glue form launched no glue kernel")
    loss_p, gp = grads(models[False])
    groups = {}
    for n, a in gg.items():
        ga, gb = groups.setdefault(grad_group(n), ([], []))
        ga.append(a.float().flatten())
        gb.append(gp[n].float().flatten())
    cos = {k: torch.nn.functional.cosine_similarity(
        torch.cat(a), torch.cat(b), dim=0).item() for k, (a, b) in groups.items()}
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:4]
    print(f"[glue-grad] full-width b=1 loss {loss_g:.5f} (glue) vs {loss_p:.5f} "
          f"(no glue); gradient cosine over {len(cos)} parameter groups: min "
          f"{worst[0][1]:.6f} (bound {MODEL_GRAD_COS_MIN}), lowest "
          + ", ".join(f"{k}={c:.6f}" for k, c in worst)
          + f", mean {sum(cos.values()) / len(cos):.6f}", flush=True)
    if not worst[0][1] >= MODEL_GRAD_COS_MIN:
        raise SystemExit("full-width gradients disagree between the glue and "
                         "the plain form")
    return cos


# LayerNormFn's gradients against autograd through the twin, on the same bf16
# input: the backward recomputes through that very twin, so only the forward
# output differs (kernel against twin, one bf16 step apart here and there)
LN_GRAD_COS_MIN = 0.999


def layernorm_g_phase(cfg):
    """Phase 25: row 14 through LayerNormG(use_fused=True) at (2, 1792, 1024)
    bf16: one launch per call, the forward against the twin, the gradients
    of LayerNormFn against autograd through the twin."""
    import torch
    from bevgen_torch.models.stage2.transformer import LayerNormG
    from bevgen_torch.ops import layernorm as ln
    tf = cfg.transformer
    D = tf.num_embed
    g = torch.Generator(device="cuda").manual_seed(95)
    mod = LayerNormG(D, use_fused=True).to("cuda")
    with torch.no_grad():
        mod.norm.weight.copy_(1.0 + 0.1 * torch.randn(D, generator=g,
                                                      device="cuda"))
    x = torch.randn(2, tf.num_img_tokens, D, generator=g, device="cuda").bfloat16()
    ln.reset_launch_counts()
    with torch.no_grad():
        out = mod(x, torch.bfloat16)
    torch.cuda.synchronize()
    launches = ln.layernorm_cuda.launches
    want = ln.layernorm_reference(x.float(), mod.norm.weight.detach())
    err = (out.float() - want).abs()
    max_err, mean_err = err.max().item(), err.mean().item()
    xl = x.clone().requires_grad_()
    y = mod(xl, torch.bfloat16)
    if not isinstance(y.grad_fn, ln.LayerNormFn._backward_cls):
        raise SystemExit("the CUDA LayerNorm output has no LayerNormFn grad_fn")
    w = torch.randn(y.shape, generator=g, device="cuda")
    leaves = [xl, mod.norm.weight]
    got = torch.autograd.grad((y.float() * w).sum(), leaves)
    ref = ln.layernorm_reference(xl, mod.norm.weight)
    want_g = torch.autograd.grad((ref.float() * w).sum(), leaves)
    cos = {n: torch.nn.functional.cosine_similarity(
        a.float().flatten(), b.float().flatten(), dim=0).item()
        for n, a, b in zip(("x", "scale"), got, want_g)}
    per_call = ln.layernorm_cuda.launches - launches
    forms = ln.layernorm_cuda.launches_by_variant
    print(f"[layernorm] LayerNormG(use_fused=True) (2, {tf.num_img_tokens}, {D}) "
          f"bf16: {launches} launch without gradients, {per_call} with "
          f"(by form {forms}); "
          f"max_abs_err={max_err:.3e} mean_abs_err={mean_err:.3e}; "
          f"LayerNormFn gradient cosine "
          + " ".join(f"{n}={c:.6f}" for n, c in cos.items())
          + f" (min {LN_GRAD_COS_MIN})", flush=True)
    if launches != 1 or per_call != 1 or forms["warp"] != 2:
        raise SystemExit("LayerNormG(use_fused=True) did not launch its kernel "
                         "(the register form) once per call")
    if not (max_err <= GLUE_MAX_ABS_TOL and mean_err <= GLUE_MEAN_ABS_TOL
            and min(cos.values()) >= LN_GRAD_COS_MIN):
        raise SystemExit("LayerNormG(use_fused=True) disagrees with its twin")
    return launches


# Phase 26: the reference's torch checkpoints on the card. The weights of
# a seeded pipeline are written in the reference's key layout (a Lightning
# `.ckpt`: the MUSE Net2NetTransformer with its SelfCritic, or the AR one
# with its sparse GPT) and served back through the port's loader; seeds A
# and B give the writer and the reader different random weights, so a load
# that did nothing fails.
CKPT_SEED_A, CKPT_SEED_B = 0, 1


def _flat_tree(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat_tree(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _conv_to_torch(a):
    return a.transpose(3, 2, 0, 1)          # flax HWIO -> torch OIHW


def _linear_to_torch(a):
    return a.T


def _conv1x1_to_torch(a):
    return a.T[:, :, None, None]            # Dense (in, out) -> 1x1 conv


def _tril_to_torch(a):
    return a[np.tril_indices(a.shape[0])][None]   # (L, L) -> flat tril


def _same(a):
    return a


def stage1_ref_key(path):
    """(reference torch key, layout change) of a leaf of a stage-1 flax tree
    (taming's VQModel names, modules/stage1/vqgan.py)."""
    import re
    if path == ("codebook",):
        return "quantize.embedding.weight", _same
    if path[0] in ("quant_conv", "post_quant_conv"):
        return (f"{path[0]}.weight", _conv_to_torch) if path[1] == "kernel" \
            else (f"{path[0]}.bias", _same)
    mod, name, rest = path[0], path[1], path[2:]
    m = re.fullmatch(r"(down|up)_(\d+)_(block|attn)_(\d+)", name)
    m2 = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", name)
    if m:
        base = f"{mod}.{m[1]}.{m[2]}.{m[3]}.{m[4]}"
    elif m2:
        base = f"{mod}.{m2[1]}.{m2[2]}.{m2[3]}"
    elif name.startswith("mid_"):
        base = f"{mod}.mid.{name[4:]}"
    else:
        base = f"{mod}.{name}"
    torch_name = {"scale": "weight", "bias": "bias", "kernel": "weight"}
    if rest[-2:-1] == ("norm",):            # GroupNorm32: <norm>/norm/<leaf>
        owner = rest[:-2]
        return ".".join((base,) + owner + (torch_name[rest[-1]],)), _same
    fn = _conv_to_torch if rest[-1] == "kernel" else _same
    return ".".join((base,) + rest[:-1] + (torch_name[rest[-1]],)), fn


def muse_ref_key(path):
    """(reference torch key, layout change) of a leaf of the MUSE
    transformer's flax tree (muse_maskgit_pytorch's TransformerMultiView)."""
    import re
    head = path[0]
    if head in ("token_emb", "cond_token_emb", "pos_emb", "cond_pos_emb"):
        return f"{head}.weight", _same
    if head == "self_cond_to_init_embed":
        idx = {"norm_in": 0, "proj_in": 1, "norm_mid": 3, "proj_out": 4}[path[1]]
        return ((f"{head}.{idx}.gamma", _same) if path[1].startswith("norm")
                else (f"{head}.{idx}.weight", _linear_to_torch))
    if head == "to_logits":
        return "to_logits.weight", _linear_to_torch
    if head in ("img_embed", "cam_embed"):
        return f"{head}.weight", _conv1x1_to_torch
    if head == "bev_embed":
        return (("bev_embed.weight", _conv1x1_to_torch) if path[1] == "kernel"
                else ("bev_embed.bias", _same))
    if head == "camera_bias_emb":
        return head, _tril_to_torch
    if head == "bev_cam_pos_emb":
        return head, _same
    if head == "final_norm":
        return "transformer_blocks.norm.gamma", _same
    m = re.fullmatch(r"layers_(\d+)_(attn|cross_attn|ff)", head)
    base = (f"transformer_blocks.layers.{m[1]}."
            f"{ {'attn': 0, 'cross_attn': 1, 'ff': 2}[m[2]] }")
    sub = path[1]
    if m[2] == "ff":
        idx = {"norm_in": 0, "proj_in": 1, "norm_mid": 3, "proj_out": 4}[sub]
        return ((f"{base}.{idx}.gamma", _same) if sub.startswith("norm")
                else (f"{base}.{idx}.weight", _linear_to_torch))
    if sub == "norm":
        return f"{base}.norm.gamma", _same
    if sub in ("to_q", "to_kv", "to_out"):
        return f"{base}.{sub}.weight", _linear_to_torch
    return f"{base}.{sub}", _same           # q_scale, k_scale, null_kv


def gpt_ref_key(path):
    """(reference torch key, layout change) of a leaf of the sparse GPT's
    flax tree (mingpt_sparse.py's GPT)."""
    import re
    head = path[0]
    if head in ("x_tok_emb", "cond_tok_emb"):
        return f"{head}.weight", _same
    if head in ("x_pos_emb", "cond_pos_emb", "bev_cam_pos_emb"):
        return head, _same
    if head == "camera_bias_emb":
        return head, _tril_to_torch
    if head in ("img_embed", "cam_embed"):
        return f"{head}.weight", _conv1x1_to_torch
    if head == "bev_embed":
        return (("bev_embed.weight", _conv1x1_to_torch) if path[1] == "kernel"
                else ("bev_embed.bias", _same))
    if head == "ln_f":
        return f"ln_f.{ {'scale': 'weight', 'bias': 'bias'}[path[-1]] }", _same
    if head == "head":
        return "head.weight", _linear_to_torch
    i = re.fullmatch(r"block_(\d+)", head)[1]
    sub, leaf = path[1], path[-1]
    if sub in ("ln1", "ln2"):
        return (f"blocks.{i}.{sub}.{ {'scale': 'weight', 'bias': 'bias'}[leaf] }",
                _same)
    owner = (f"attention.{sub}" if sub in ("query", "key", "value") else
             f"mlp.{ {'mlp_fc': 0, 'mlp_proj': 2}[sub] }")
    return ((f"blocks.{i}.{owner}.weight", _linear_to_torch) if leaf == "kernel"
            else (f"blocks.{i}.{owner}.bias", _same))


def reference_state_dict(tree):
    """The reference's Lightning state dict (torch key -> contiguous numpy
    array in torch's layout) of a serving pipeline's flax-layout tree
    (`core/convert.py:export_jax_params`): the MUSE Net2NetTransformer,
    whose SelfCritic holds `token_critic.net.*` aliases of the transformer
    (the same arrays) and a `to_pred` head, or a separate TokenCritic
    transformer at `token_critic.*`; or the AR one, whose sparse GPT sits at
    top-level `transformer.*`. The inverse of the port's converters;
    `tests/test_torch_checkpoint.py` holds it to the JAX package's test
    oracle."""
    out = {}

    def put(key, arr, fn):
        out[key] = np.ascontiguousarray(fn(np.asarray(arr)))
        return out[key]

    for part, prefix in (("first_stage", "first_stage_model."),
                         ("cond_stage", "cond_stage_model.")):
        for path, arr in _flat_tree(tree[part]["params"]):
            key, fn = stage1_ref_key(path)
            put(prefix + key, arr, fn)
    if "maskgit" in tree:
        mg = tree["maskgit"]["params"]
        for path, arr in _flat_tree(mg["transformer"]):
            key, fn = muse_ref_key(path)
            gen = put("maskgit.transformer." + key, arr, fn)
            if "critic" in mg:
                out["maskgit.token_critic.net." + key] = gen
        if "critic" in mg:
            head = mg["critic"]["to_pred"]
            put("maskgit.token_critic.to_pred.weight", head["kernel"],
                _linear_to_torch)
            put("maskgit.token_critic.to_pred.bias", head["bias"], _same)
        else:
            for path, arr in _flat_tree(mg["token_critic"]):
                key, fn = muse_ref_key(path)
                put("maskgit.token_critic." + key, arr, fn)
    else:
        for path, arr in _flat_tree(tree["gpt"]["params"]):
            key, fn = gpt_ref_key(path)
            put("transformer." + key, arr, fn)
    return out


def write_reference_ckpt(pipe, path):
    """Write `pipe`'s weights as a reference Lightning `.ckpt` (fp32; the
    SelfCritic aliases share their tensors, as in the reference's files).
    Returns the file's bytes."""
    import os
    import torch
    from bevgen_torch.core.convert import export_jax_params
    tensors, shared = {}, {}
    for key, arr in reference_state_dict(export_jax_params(pipe)).items():
        if id(arr) not in shared:
            shared[id(arr)] = torch.from_numpy(arr)
        tensors[key] = shared[id(arr)]
    torch.save({"state_dict": tensors, "epoch": 0, "global_step": 0}, path)
    return os.path.getsize(path)


def params_equal(a, b):
    """(all parameters of pipelines a and b equal bit for bit, how many
    differ, how many there are)."""
    import torch
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    if pa.keys() != pb.keys():
        raise SystemExit("the two pipelines hold different parameters")
    diff = [n for n in pa if not torch.equal(pa[n], pb[n])]
    return not diff, len(diff), len(pa)


def checkpoint_phase(cfg, ar_cfg):
    """Phase 26: reference-format checkpoints through the port's loader at
    full width: the MUSE generate CLI fed from one (b=2, 980 row-1 launches,
    the seed-A pipeline's ids), and the AR pipeline loaded from one (a b=1
    full forward with 24 row-9 launches, the seed-A model's logits)."""
    import os
    import tempfile
    import torch
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.scripts import generate as cli
    from bevgen_torch.training.checkpoints import load_weights
    A, B = CKPT_SEED_A, CKPT_SEED_B
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        # MUSE: the generate CLI with ckpt_path=, seed B
        path = os.path.join(tmp, "muse.ckpt")
        pipe_a = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=A)
        t0 = time.perf_counter()
        size = write_reference_ckpt(pipe_a, path)
        write_s = time.perf_counter() - t0
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        pipe_b, outs = cli.run([
            "preset=argoverse_muse_7cam", f"batch_size={AR_BATCH}", "fake=1",
            f"seed={B}", "device=cuda", f"ckpt_path={path}",
            f"out={os.path.join(tmp, 'out')}"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = ca.cosine_attention_cuda.launches
        same, n_diff, n_par = params_equal(pipe_a, pipe_b)
        del pipe_b
        batch = fake_batch(cfg, AR_BATCH, seed=B)
        _, want = pipe_a.generate_fn(
            batch["segmentation"], batch["intrinsics_inv"],
            batch["extrinsics_inv"],
            torch.Generator(device="cuda").manual_seed(B))
        got = np.load(outs[0])["ids"]
        agree = float((got == want.cpu().numpy()).mean())
        tf = cfg.transformer
        steps = cfg.muse.sample_iterations
        expect = (steps + steps - 1) * tf.num_layers * 2
        print(f"[ckpt] MUSE argoverse_muse_7cam: reference .ckpt "
              f"{size / 1e6:.1f} MB written in {write_s:.1f} s; the generate "
              f"CLI (seed {B}, ckpt_path) in {cli_s:.1f} s: parameters equal "
              f"to seed {A}'s bit for bit {same} ({n_diff} of {n_par} "
              f"differ); {launches} attention launches (expected {expect}); "
              f"ids identical to the seed-{A} pipeline's generate_fn "
              f"{agree == 1.0} (agreement {agree:.6f})", flush=True)
        os.remove(path)
        del pipe_a
        torch.cuda.empty_cache()
        if not same or launches != expect or agree != 1.0:
            raise SystemExit("the checkpoint-fed MUSE generate does not serve "
                             "the checkpoint's weights")
        res["muse_launches"] = launches

        # the same with a TokenCritic and self-conditioning: the file holds
        # a second transformer and the self_cond_to_init_embed weights
        vcfg = variant_config(cfg, token_critic=True, self_cond=True)
        path = os.path.join(tmp, "muse_variant.ckpt")
        pipe_a = BEVGenPipeline.create(vcfg, device="cuda").init_params(seed=A)
        t0 = time.perf_counter()
        size = write_reference_ckpt(pipe_a, path)
        write_s = time.perf_counter() - t0
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        pipe_b, outs = cli.run([
            "preset=argoverse_muse_7cam", f"batch_size={AR_BATCH}", "fake=1",
            f"seed={B}", "device=cuda", f"ckpt_path={path}",
            f"out={os.path.join(tmp, 'out_variant')}", *VARIANT_OVERRIDES])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        launches = ca.cosine_attention_cuda.launches
        same, n_diff, n_par = params_equal(pipe_a, pipe_b)
        del pipe_b
        _, want = pipe_a.generate_fn(
            batch["segmentation"], batch["intrinsics_inv"],
            batch["extrinsics_inv"],
            torch.Generator(device="cuda").manual_seed(B))
        got = np.load(outs[0])["ids"]
        agree = float((got == want.cpu().numpy()).mean())
        print(f"[ckpt] MUSE {variant_name(vcfg)}: reference .ckpt "
              f"{size / 1e6:.1f} MB written in {write_s:.1f} s; the generate "
              f"CLI (seed {B}, ckpt_path, {' '.join(VARIANT_OVERRIDES)}) in "
              f"{cli_s:.1f} s: parameters equal to seed {A}'s bit for bit "
              f"{same} ({n_diff} of {n_par} differ); {launches} attention "
              f"launches (expected {expect}); ids identical to the seed-{A} "
              f"pipeline's generate_fn {agree == 1.0} (agreement "
              f"{agree:.6f})", flush=True)
        os.remove(path)
        del pipe_a
        torch.cuda.empty_cache()
        if not same or launches != expect or agree != 1.0:
            raise SystemExit("the checkpoint-fed TokenCritic + self_cond "
                             "generate does not serve the checkpoint's weights")
        res["variant_launches"] = launches

        # AR: load_weights at nuscenes_ar, a b=1 full forward
        path = os.path.join(tmp, "ar.ckpt")
        ar_a = ARPipeline.create(ar_cfg, device="cuda").init_params(seed=A)
        t0 = time.perf_counter()
        size = write_reference_ckpt(ar_a, path)
        write_s = time.perf_counter() - t0
        ar_b = ARPipeline.create(ar_cfg, device="cuda").init_params(seed=B)
        t0 = time.perf_counter()
        family = load_weights(path, ar_b)
        load_s = time.perf_counter() - t0
        same, n_diff, n_par = params_equal(ar_a, ar_b)
        ids, cond, ii, ei, _ = ar_inputs(ar_cfg, 1, seed=7)
        counts = []
        with torch.inference_mode():
            logits = []
            for model in (ar_a.gpt, ar_b.gpt):
                bs.reset_launch_counts()
                logits.append(model(ids, cond, ii, ei, sampling=True))
                torch.cuda.synchronize()
                counts.append(bs.block_sparse_attention_cuda.launches)
        exact = torch.equal(logits[0], logits[1])
        cos, top1 = logit_agreement(logits[0], logits[1])
        print(f"[ckpt] AR nuscenes_ar: reference .ckpt {size / 1e6:.1f} MB "
              f"written in {write_s:.1f} s, loaded as family {family!r} in "
              f"{load_s:.1f} s: parameters equal to seed {A}'s bit for bit "
              f"{same} ({n_diff} of {n_par} differ); b=1 full forward "
              f"block-sparse launches {counts[1]} (seeded model {counts[0]}); "
              f"logits identical {exact} (cosine {cos:.6f}, top-1 {top1:.4f})",
              flush=True)
        os.remove(path)
        n_layers = ar_cfg.transformer.num_layers
        if (family != "ar" or not same or counts != [n_layers, n_layers]
                or not exact):
            raise SystemExit("the checkpoint-loaded AR model does not run the "
                             "checkpoint's weights")
        res["ar_launches"] = counts[1]
    print(f"[ckpt] phase 26 in {time.perf_counter() - t_phase:.1f} s; "
          f"temporary files deleted", flush=True)
    return res


# Phases 27-30: the MUSE model variants at `argoverse_muse_7cam` full width,
# seeded weights (seed 0, as phase 4), b=2 serving and b=8 training. The
# variants' overrides, as a user passes them to the CLIs:
VARIANT_OVERRIDES = ["muse.token_critic=true", "muse.self_token_critic=false",
                     "transformer.self_cond=true"]
# each variant's generates: one warm-up, then this many timed
VARIANT_TIMED = 5


def variant_config(cfg, real_cfg=False, token_critic=False, self_cond=False,
                   **muse_kw):
    """`cfg` with real classifier-free guidance, the TokenCritic in place
    of the SelfCritic, and/or self-conditioning."""
    muse = dataclasses.replace(cfg.muse, real_cfg=real_cfg, **muse_kw)
    if token_critic:
        muse = dataclasses.replace(muse, token_critic=True,
                                   self_token_critic=False)
    return dataclasses.replace(cfg, muse=muse, transformer=(
        cfg.transformer.replace(self_cond=True) if self_cond
        else cfg.transformer))


def variant_name(cfg):
    m, tf = cfg.muse, cfg.transformer
    parts = [name for name, on in (("real_cfg", m.real_cfg),
                                   ("token_critic", m.token_critic),
                                   ("self_cond", tf.self_cond)) if on]
    return "+".join(parts) or "default"


def variant_generates(pipe, inputs, expect_by_batch, **kw):
    """Phases 27-29 and 33: one warm-up generate and VARIANT_TIMED timed ones
    (host clock around a synchronised `generate_fn`, b=2); the row-1
    launches of the first timed one, by batch, must be `expect_by_batch`
    ({batch: launches}). Returns the stats."""
    import torch
    from bevgen_torch.ops import cosine_attention as ca
    cfg, tf = pipe.config, pipe.config.transformer
    B = inputs[0].shape[0]

    def generate(seed):
        return pipe.generate_fn(*inputs, torch.Generator(
            device="cuda").manual_seed(seed), **kw)

    t0 = time.perf_counter()
    generate(0)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    times = []
    for i in range(VARIANT_TIMED):
        if i == 0:
            ca.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(i + 1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == 0:
            images, ids = out[:2]
            calls = dict(ca.cosine_attention_cuda.launches_by_batch_shape)
    by_batch = {}
    for (b, _, _), n in calls.items():
        by_batch[b] = by_batch.get(b, 0) + n
    med = sorted(times)[len(times) // 2]
    n_img = B * tf.num_cams
    flags = "".join(f" {k}={v}" for k, v in kw.items())
    print(f"[variant] {variant_name(cfg)}{flags} generate_fn b={B}: warm-up "
          f"{warm_s:.3f} s, timed {', '.join(f'{t:.4f}' for t in times)} s, "
          f"median {med:.4f} s = {n_img / med:.3f} images/s; row-1 launches "
          f"in the first timed run by batch {by_batch} (expected "
          f"{expect_by_batch}), by (batch, N, M) {calls}", flush=True)
    if by_batch != expect_by_batch:
        raise SystemExit(f"{variant_name(cfg)}: expected row-1 launches by "
                         f"batch {expect_by_batch}, got {by_batch}")
    if not torch.isfinite(images).all():
        raise SystemExit(f"{variant_name(cfg)}: non-finite images")
    if ids.min() < 0 or ids.max() >= tf.vocab_size:
        raise SystemExit(f"{variant_name(cfg)}: ids out of range")
    return {"images_per_s": n_img / med, "median_s": med, "calls": calls,
            "launches": sum(by_batch.values()), "shape": tuple(images.shape)}


def variant_inputs(cfg, B=2):
    from bevgen_torch.data.fake import fake_batch
    batch = fake_batch(cfg, batch_size=B, seed=0)
    return (batch["segmentation"], batch["intrinsics_inv"],
            batch["extrinsics_inv"])


def swap_core(pipe, core):
    from bevgen_torch.models.stage2.transformer import CosineAttention
    for m in pipe.modules():
        if isinstance(m, CosineAttention):
            m.core = core


def real_cfg_phase(cfg):
    """Phase 27: real classifier-free guidance. Row 1 against its plain
    twin at the guided b=4 shapes (self without keep, as the path runs it,
    and with keep [1, 1, 0, 0]; cross with keep [1, 1, 0, 0]); one decode
    step's mixed logits through the kernel and through the plain version;
    a full generate: 18 guided forwards at b=4 and 17 SelfCritic forwards
    at b=2, so 504 + 476 = 980 row-1 launches; images/s."""
    import torch
    from bevgen_torch.models.stage2 import maskgit as mg
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    tf = cfg.transformer
    H, D, N, NC = tf.num_heads, tf.dim_head, tf.num_img_tokens, tf.num_cond_tokens
    keep = [1, 1, 0, 0]
    stats = {
        "self": check_kernel("cfg self b4", 4, H, N, N, D, True, None, 40),
        "cross": check_kernel("cfg cross b4 keep", 4, H, N, NC, D, True, keep,
                              41),
    }
    check_kernel("cfg self b4 keep", 4, H, N, N, D, True, keep, 42)
    vcfg = variant_config(cfg, real_cfg=True)
    pipe = BEVGenPipeline.create(vcfg, device="cuda").init_params(seed=0)
    inputs = variant_inputs(vcfg)
    g = torch.Generator(device="cuda").manual_seed(3)
    ids = torch.randint(0, tf.vocab_size + 1, (2, tf.num_cams,
                                               tf.num_cam_tokens),
                        generator=g, device="cuda")
    with torch.inference_mode():
        seg, ii, ei = (torch.as_tensor(a, device="cuda") for a in inputs)
        cond_ids = pipe.encode_bev(seg)
        gen_cache, _ = mg.decode_caches(pipe.maskgit, cond_ids, ii, ei)
        ca.reset_launch_counts()
        lk, _ = mg.cfg_logits(pipe.maskgit, ids, cond_ids, ii, ei,
                              vcfg.muse.cond_scale, real_cfg=True,
                              cache=gen_cache)
        step_calls = dict(ca.cosine_attention_cuda.launches_by_batch_shape)
        swap_core(pipe, ca.cosine_attention_reference)
        try:
            lp, _ = mg.cfg_logits(pipe.maskgit, ids, cond_ids, ii, ei,
                                  vcfg.muse.cond_scale, real_cfg=True,
                                  cache=gen_cache)
        finally:
            swap_core(pipe, ca.cosine_attention)
    cos, top1 = logit_agreement(lk, lp)
    print(f"[variant] real_cfg: one decode step's mixed logits (b=2 as one "
          f"b=4 forward, launches {step_calls}), kernel vs plain attention: "
          f"cosine {cos:.6f} (min {LOGIT_COS_MIN}), top-1 agreement "
          f"{top1:.4f} (min {TOP1_AGREE_MIN}), max abs diff "
          f"{(lk - lp).abs().max().item():.4f}", flush=True)
    if not (cos >= LOGIT_COS_MIN and top1 >= TOP1_AGREE_MIN):
        raise SystemExit("real_cfg logits disagree between the kernel and "
                         "the plain version")
    del gen_cache, lk, lp
    steps, layers = vcfg.muse.sample_iterations, tf.num_layers
    e2e = variant_generates(pipe, inputs, {4: steps * 2 * layers,
                                           2: (steps - 1) * 2 * layers})
    del pipe
    return {"kernels": stats, "e2e": e2e}


def token_critic_phase(cfg):
    """Phase 28: the TokenCritic. A generate makes 18 generator and 17
    TokenCritic forwards at b=2 (980 row-1 launches); with real_cfg all 35
    run guided at b=4 (980); `force_not_use_token_critic` drops the critic
    forwards (18 x 28 = 504). Images/s of each."""
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    tf = cfg.transformer
    steps, layers = cfg.muse.sample_iterations, tf.num_layers
    total = (2 * steps - 1) * 2 * layers
    vcfg = variant_config(cfg, token_critic=True)
    pipe = BEVGenPipeline.create(vcfg, device="cuda").init_params(seed=0)
    n_params = sum(p.numel() for p in pipe.maskgit.token_critic.parameters())
    print(f"[variant] token_critic: a second transformer of "
          f"{n_params / 1e6:.1f} M params with a 1-wide head", flush=True)
    inputs = variant_inputs(vcfg)
    res = {"token_critic": variant_generates(pipe, inputs, {2: total}),
           "forced": variant_generates(pipe, inputs, {2: steps * 2 * layers},
                                       force_not_use_token_critic=True)}
    gcfg = variant_config(cfg, real_cfg=True, token_critic=True)
    guided = BEVGenPipeline.create(gcfg, device="cuda")
    guided.load_state_dict(pipe.state_dict())
    del pipe
    res["token_critic+real_cfg"] = variant_generates(guided, inputs,
                                                     {4: total})
    return res


def self_cond_phase(cfg):
    """Phase 29: self-conditioning and the trajectory. A generate makes 980
    row-1 launches; `return_trajectory` gives (18, 2, 7, 256) ids whose last
    entry equals the returned ids; one forward with a nonzero
    self_cond_embed differs from one on zeros. Images/s."""
    import torch
    from bevgen_torch.models.stage2 import maskgit as mg
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    tf = cfg.transformer
    steps, layers = cfg.muse.sample_iterations, tf.num_layers
    vcfg = variant_config(cfg, self_cond=True)
    pipe = BEVGenPipeline.create(vcfg, device="cuda").init_params(seed=0)
    inputs = variant_inputs(vcfg)
    res = variant_generates(pipe, inputs, {2: (2 * steps - 1) * 2 * layers})
    images, ids, traj = pipe.generate_fn(
        *inputs, torch.Generator(device="cuda").manual_seed(1),
        return_trajectory=True)
    want = (steps, 2, tf.num_cams, tf.num_cam_tokens)
    last_ok = torch.equal(traj[-1], ids.reshape(traj.shape[1:]))
    g = torch.Generator(device="cuda").manual_seed(3)
    fids = torch.randint(0, tf.vocab_size + 1, want[1:], generator=g,
                         device="cuda")
    sc = torch.randn(2, tf.num_img_tokens, tf.num_embed, generator=g,
                     device="cuda")
    with torch.inference_mode():
        seg, ii, ei = (torch.as_tensor(a, device="cuda") for a in inputs)
        cond_ids = pipe.encode_bev(seg)
        cache, _ = mg.decode_caches(pipe.maskgit, cond_ids, ii, ei)
        l0, _ = mg.cfg_logits(pipe.maskgit, fids, cond_ids, ii, ei,
                              vcfg.muse.cond_scale,
                              self_cond_embed=torch.zeros_like(sc),
                              cache=cache)
        l1, _ = mg.cfg_logits(pipe.maskgit, fids, cond_ids, ii, ei,
                              vcfg.muse.cond_scale, self_cond_embed=sc,
                              cache=cache)
    moved = (l1 - l0).abs().max().item()
    print(f"[variant] self_cond: trajectory {tuple(traj.shape)} (expected "
          f"{want}), last entry equal to the returned ids {last_ok}; one "
          f"step's logits with a unit-normal self_cond_embed against zeros: "
          f"max abs diff {moved:.4f}", flush=True)
    if tuple(traj.shape) != want or not last_ok:
        raise SystemExit("return_trajectory gave a wrong trajectory")
    if not moved > 1e-3:
        raise SystemExit("self-conditioning does not change the logits")
    del pipe
    return res


def variant_train_phase(cfg):
    """Phase 30: the b=8 train step with the TokenCritic and
    self-conditioning at self_cond_prob 1 (the pre-forward always runs):
    84 row-1 forward launches (28 pre-forward, 28 generator, 28 critic) and
    168 row-8 launches per step, step s and peak GB (under the card's
    memory); the b=1 gradient of each parameter group (`token_critic` and
    `self_cond_to_init_embed` their own), kernels vs plain; the CE falls on
    a repeated batch."""
    import torch
    vcfg = variant_config(cfg, token_critic=True, self_cond=True,
                          self_cond_prob=1.0)
    model, stats = train_phase(vcfg)
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    print(f"[variant] train step peak {stats['peak_gb']:.2f} GB of the card's "
          f"{card_gb:.2f} GB", flush=True)
    if not stats["peak_gb"] < card_gb:
        raise SystemExit("the variant train step does not fit the card")
    model_grads_phase(model, vcfg)
    ce_falls_phase(model, vcfg)
    del model
    return stats


# ---- phases 31-34: image encode, partial decode, the rect preset, tokenized
# training ---------------------------------------------------------------------

# phase 31: encode of b x 7 cameras, one warm-up, this many timed; the
# fp32 card-vs-CPU index agreement over this many images
ENCODE_BATCH = 8
ENCODE_TIMED = 5
ENCODE_CHECK_IMAGES = 2
# fp32 on both sides (TF32 off), convolutions summed in another order: an
# index flips only where two codes are within rounding of each other
ENCODE_AGREE_MIN = 0.99
# phase 32: the cameras kept from the ground truth (of the 7-camera ring)
KEEP_CAMERAS = ("ring_front_left", "ring_front_center", "ring_side_left")
# phase 34: fake batches tokenized, train steps from the shards
TOKENIZE_BATCHES = 16
TOKENIZED_TRAIN_STEPS = 3


def seeded_vq(s1cfg, seed, device):
    """A fp32 `VQModel` with seeded random weights on `device`."""
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage1.vq import VQModel
    return init_weights(VQModel(s1cfg), seed).to(device).eval()


def encode_phase(cfg):
    """Phase 31: `encode_images` at full width on b x 7 cameras of 256 x 256
    (bf16, as served): images/s, median of five after one warm-up. Then the
    card's fp32 encode of two images against the CPU's on the same seeded
    weights (index agreement), without and with the stage-1 geometric
    embedding (through `VQModel.encode(x, ii, ei)`), and the share of
    indices that the embedding changes."""
    import torch
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    tf = cfg.transformer
    pipe = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=0)
    batch = fake_batch(cfg, ENCODE_BATCH, seed=31)
    images = torch.as_tensor(batch["image"], device="cuda")
    pipe.encode_images(images)
    torch.cuda.synchronize()
    times = []
    for _ in range(ENCODE_TIMED):
        t0 = time.perf_counter()
        toks = pipe.encode_images(images)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = sorted(times)[len(times) // 2]
    n_img = ENCODE_BATCH * tf.num_cams
    print(f"[encode] encode_images {tuple(images.shape)} bf16 -> "
          f"{tuple(toks.shape)}: timed {', '.join(f'{t:.4f}' for t in times)} "
          f"s, median {med:.4f} s = {n_img / med:.1f} images/s "
          f"({n_img / med * tf.num_cam_tokens:.0f} tokens/s)", flush=True)
    if toks.shape != (ENCODE_BATCH, tf.num_cams, tf.num_cam_tokens) or \
            toks.min() < 0 or toks.max() >= cfg.first_stage.n_embed:
        raise SystemExit(f"bad tokens {tuple(toks.shape)}")
    del pipe, images, toks
    torch.cuda.empty_cache()

    n = ENCODE_CHECK_IMAGES
    x = torch.as_tensor(batch["image"][0, :n])
    ii = torch.as_tensor(batch["intrinsics_inv"][0, :n])
    ei = torch.as_tensor(batch["extrinsics_inv"][0, :n])
    res = {"images_per_s": n_img / med, "median_s": med}
    geo_cfg = dataclasses.replace(cfg.first_stage, geometric_embedding=True,
                                  cam_emd_dim=cfg.first_stage.z_channels)
    plain_idx = None
    for name, s1 in (("plain", cfg.first_stage), ("geometric", geo_cfg)):
        mats = () if name == "plain" else (ii, ei)
        with torch.inference_mode():
            cpu = seeded_vq(s1, 31, "cpu").encode(x, *mats).indices
            dev = seeded_vq(s1, 31, "cuda").encode(
                x.cuda(), *(m.cuda() for m in mats)).indices.cpu()
        agree = float((cpu == dev).float().mean())
        extra = ""
        if plain_idx is None:
            plain_idx = cpu
        else:
            changed = float((cpu != plain_idx).float().mean())
            res["embedding_changes"] = changed
            extra = (f"; the embedding changes {changed:.4f} of the indices "
                     f"(same weights without it)")
        print(f"[encode] {name} first stage, {n} images fp32 (TF32 off): card "
              f"vs CPU index agreement {agree:.6f} (min {ENCODE_AGREE_MIN})"
              f"{extra}", flush=True)
        if agree < ENCODE_AGREE_MIN:
            raise SystemExit(f"{name} encode disagrees between the card and "
                             f"the CPU")
        res[f"agree_{name}"] = agree
    return res


def run_cli(main, argv):
    """Run a CLI entry point, echo its standard output, return its lines."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    return result, out.strip().splitlines()


def partial_decode_phase(cfg):
    """Phase 32: the generate CLI at full width with `keep_cameras` (three
    of the seven cameras) and `save_rec`, b=2, one fake batch: exactly 980
    row-1 launches; the kept cameras' ids equal their encoded ground-truth
    tokens; no mask id left; `rec` finite with the shape of `image`;
    images/s from the CLI's last line."""
    import os
    import tempfile
    import torch
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.scripts import generate as cli
    tf = cfg.transformer
    with tempfile.TemporaryDirectory() as tmp:
        ca.reset_launch_counts()
        (pipe, paths), lines = run_cli(cli.run, [
            "preset=argoverse_muse_7cam", "fake=1", "batch_size=2",
            f"keep_cameras={','.join(KEEP_CAMERAS)}", "save_rec=true",
            f"out={os.path.join(tmp, 'out')}"])
        torch.cuda.synchronize()
        launches = ca.cosine_attention_cuda.launches
        by_shape = dict(ca.cosine_attention_cuda.launches_by_shape)
        out = dict(np.load(paths[0]))
    summary = json.loads(lines[-1])
    batch = fake_batch(cfg, 2, seed=0)
    gt = pipe.encode_images(batch["image"]).cpu().numpy()
    kept = [c for c, name in enumerate(tf.camera_names) if name in KEEP_CAMERAS]
    ids = out["ids"].reshape(2, tf.num_cams, -1)
    kept_equal = bool((ids[:, kept] == gt[:, kept]).all())
    no_mask = bool((out["ids"] != tf.mask_token_id).all())
    rec_ok = (out["rec"].shape == batch["image"].shape
              and bool(np.isfinite(out["rec"]).all()))
    steps = cfg.muse.sample_iterations
    expect = (steps + steps - 1) * tf.num_layers * 2
    print(f"[partial] keep_cameras={','.join(KEEP_CAMERAS)} (cameras {kept} "
          f"of {tf.num_cams}) save_rec=true b=2: {launches} row-1 launches "
          f"{by_shape} (expected {expect}); kept cameras equal their encoded "
          f"tokens {kept_equal}; no mask id left {no_mask}; rec "
          f"{out['rec'].shape} finite {rec_ok}; "
          f"{summary['images_per_sec']} images/s ({summary['images']} images "
          f"in {summary['seconds']} s, encode + generate + reconstruction)",
          flush=True)
    del pipe
    if launches != expect or not (kept_equal and no_mask and rec_ok):
        raise SystemExit("the partial decode failed its checks")
    return {"launches": launches, "by_shape": by_shape,
            "images_per_s": summary["images_per_sec"]}


def rect_phase():
    """Phase 33: `argoverse_muse_rect` at full width: row 1 against its plain
    version at the preset's shapes (self 1008 x 1008, cross 1008 x 256 +
    the null column, b=2), then a b=2 generate: exactly 980 launches, finite
    (2, 3, 256, 336, 3) images, images/s (median of five after a
    warm-up)."""
    from bevgen_torch.core.config import argoverse_rect_config
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    cfg = argoverse_rect_config()
    tf = cfg.transformer
    H, D, N, NC = tf.num_heads, tf.dim_head, tf.num_img_tokens, tf.num_cond_tokens
    stats = {
        "self": check_kernel("rect self", 2, H, N, N, D, True, None, 50),
        "cross": check_kernel("rect cross", 2, H, N, NC, D, True, None, 51),
    }
    pipe = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=0)
    steps, layers = cfg.muse.sample_iterations, tf.num_layers
    e2e = variant_generates(pipe, variant_inputs(cfg),
                            {2: (2 * steps - 1) * 2 * layers})
    del pipe
    print(f"[rect] argoverse_muse_rect images {e2e['shape']} (finite, ids in "
          f"range)", flush=True)
    if e2e["shape"] != (2, tf.num_cams) + tuple(tf.cam_res) + (3,):
        raise SystemExit(f"rect images of shape {e2e['shape']}")
    return {"kernels": stats, "e2e": e2e, "N": N, "NC": NC}


class FakeSamples:
    """`n` single samples of the fake-batch fixture (sample i from seed i),
    for the loader."""

    def __init__(self, cfg, n):
        self.cfg, self.n = cfg, n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from bevgen_torch.data.fake import fake_batch
        b = fake_batch(self.cfg, 1, seed=i)
        return {k: (v[0] if isinstance(v, np.ndarray) else
                    v[0] if k == "sample_token" else v)
                for k, v in b.items()}


def tokenize_train_phase(cfg):
    """Phase 34: `tokenize_dataset` over TOKENIZE_BATCHES fake batches of 8
    at `argoverse_muse_7cam` through the port's DataLoader and
    `device_prefetch` (images/s; the first and last batches' matrices in
    the shards equal the host's bit for bit, their tokens agree with a
    direct encode at >= 0.99), then `scripts/train_stage2.py
    tokens_dir=<shards>` at full width, b=8: exactly 56 row-1 forward and
    168 row-8 backward launches per step, finite losses."""
    import tempfile
    import torch
    from bevgen_torch.data import datamodule as dm
    from bevgen_torch.data.tokens import TokenDataset, tokenize_dataset
    from bevgen_torch.ops import attention_bwd as ab
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.scripts import train_stage2
    tf, B = cfg.transformer, TRAIN_BATCH
    pipe = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        loader = dm.DataLoader(FakeSamples(cfg, TOKENIZE_BATCHES * B), B,
                               shuffle=False, num_workers=4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = tokenize_dataset(pipe, dm.device_prefetch(iter(loader), "cuda"),
                             tmp, shard_size=4 * B)
        torch.cuda.synchronize()
        tok_s = time.perf_counter() - t0
        ds = TokenDataset(tmp)
        n_img = n * tf.num_cams
        print(f"[tokenize] {n} samples ({n_img} images) -> {len(ds)} in "
              f"shards in {tok_s:.3f} s = {n_img / tok_s:.1f} images/s "
              f"(fake samples made on the host by 4 loader "
              f"threads)", flush=True)
        if n != TOKENIZE_BATCHES * B or len(ds) != n:
            raise SystemExit("tokenize_dataset lost samples")
        # the prefetched copies (a side stream) against the host batches:
        # matrices bit for bit, tokens against a direct encode
        for first in (0, n - B):
            batch = dm.collate([FakeSamples(cfg, n)[i]
                                for i in range(first, first + B)])
            direct = pipe.encode_images(batch["image"]).cpu().numpy()
            agree = float((ds.tokens[first:first + B] == direct).mean())
            same = all(np.array_equal(getattr(ds, k)[first:first + B],
                                      batch[k])
                       for k in ("intrinsics_inv", "extrinsics_inv"))
            print(f"[tokenize] samples {first}-{first + B - 1}: shard "
                  f"tokens agree with a direct encode at {agree:.6f}, "
                  f"matrices equal: {same}", flush=True)
            if agree < 0.99 or not same:
                raise SystemExit("the shards differ from the host batches")
        del pipe
        torch.cuda.empty_cache()
        ca.reset_launch_counts()
        ab.reset_launch_counts()
        t0 = time.perf_counter()
        _, lines = run_cli(train_stage2.main, [
            "preset=argoverse_muse_7cam", f"tokens_dir={tmp}",
            f"steps={TOKENIZED_TRAIN_STEPS}", f"batch_size={B}",
            "log_every=1", "warmup_steps=1"])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    n_fwd = ca.cosine_attention_cuda.launches
    n_bwd = ab.attention_bwd_cuda.launches
    fwd = dict(ca.cosine_attention_cuda.launches_by_shape)
    bwd = dict(ab.attention_bwd_cuda.launches_by_shape)
    steps = [json.loads(l) for l in lines if l.startswith("{")]
    losses = [s["loss"] for s in steps]
    S = TOKENIZED_TRAIN_STEPS
    want_fwd, want_bwd = 2 * 2 * tf.num_layers, 3 * 4 * tf.num_layers
    print(f"[tokenize] train_stage2 tokens_dir b={B}, {S} steps in "
          f"{train_s:.1f} s (model build included): losses {losses}; "
          f"launches {n_fwd} forward {fwd}, {n_bwd} backward {bwd}: per step "
          f"{n_fwd / S:g} and {n_bwd / S:g} (expected {want_fwd} and "
          f"{want_bwd})", flush=True)
    if (n_fwd, n_bwd) != (S * want_fwd, S * want_bwd):
        raise SystemExit("unexpected launch counts in the tokenized training")
    if len(losses) != S or not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"train_stage2 on the shards: losses {losses}")
    return {"fwd": {k: v // S for k, v in fwd.items()},
            "bwd": {k: v // S for k, v in bwd.items()},
            "images_per_s": n_img / tok_s}


# ---- int8 serving (phases 35-38) --------------------------------------------

# The int8 kernels against their plain versions (csrc/int8.cu): the
# quantizers and the epilogue repeat the plain versions' fp32 arithmetic
# operation for operation, so they are held to equality (int8 values, zero
# padding, row scales; the epilogue's fp32 output). w8_linear rounds three
# times to bf16 (the sum, the product with the scale, the sum with the
# bias), each within 2^-8 of the value's size, and sums in another order:
# its max error against the fp32 plain version is held to 2^-6 of max |out|.
W8_TOL = 2.0 ** -6
# int8 against bf16 logits: the JAX package's cosine bound for int8 against
# the compute dtype (tests/test_quant.py:84-107, at tiny_test). Its top-1
# bound (0.9) does not carry to full width with random weights, whose 1024
# logits a position are nearly flat: there a top-1 flips wherever the bf16
# top-2 gap is below the int8 error. So the top-1 agreement is held to
# INT8_DECIDED_TOP1_MIN on the positions whose bf16 top-2 gap exceeds
# INT8_GAP_RMS times the RMS int8-vs-bf16 logit difference (a flip there
# needs a 2.8-sigma error in the difference of two logits), and the raw
# agreement is printed beside it.
INT8_COS_MIN = 0.995
INT8_GAP_RMS = 4.0
INT8_DECIDED_TOP1_MIN = 0.99
INT8_TIMED = 5          # MUSE generates per mode, in turns, after a warm-up
AR_INT8_TIMED = 1       # AR int8 generates (the first counts the launches)
AR_INT8_GREEDY_LAYERS = 8
# inputs cycled through while a kernel is timed, so that they exceed the
# 50 MB L2 (the serving path finds each layer's weights and activations cold)
INT8_COLD_BYTES = 150e6


def _cold_sets(one_bytes, make):
    return [make(i) for i in range(max(1, math.ceil(INT8_COLD_BYTES / one_bytes)))]


def check_quantize(name, rows, K, static, seed):
    """quantize_static / quantize_dynamic against their plain versions (the
    eager quantizer, then zero padding to a multiple of 8): bit for bit."""
    import itertools
    import torch
    import torch.nn.functional as F
    from bevgen_torch.ops import quant as tq
    g = torch.Generator(device="cuda").manual_seed(seed)
    Kp = tq.padded(K)
    gamma = 1.0 + 0.1 * torch.randn(K, generator=g, device="cuda")
    in_scale = (gamma.abs() * (tq.CLIP_SIGMA / 127.0)).contiguous()
    inv = 1.0 / in_scale
    sets = _cold_sets(rows * K * 2, lambda i: (torch.randn(
        rows, K, generator=g, device="cuda") * gamma).bfloat16())
    x = sets[0]
    if static:
        kernel = lambda x: tq.quantize_static_cuda(x, in_scale, Kp)
        plain = lambda x: F.pad(tq.quantize_activations_static(x, inv),
                                (0, Kp - K))
        q = kernel(x)[:rows]
        exact = torch.equal(q, plain(x))
    else:
        kernel = lambda x: tq.quantize_dynamic_cuda(x, Kp)
        plain = lambda x: tuple((F.pad(a, (0, Kp - K)), s[:, 0]) for a, s in
                                (tq.quantize_activations(x),))[0]
        q, s = kernel(x)
        wq, ws = plain(x)
        exact = torch.equal(q[:rows], wq) and torch.equal(s, ws)
    torch.cuda.synchronize()
    cycle = itertools.cycle(sets)
    ms = time_ms(lambda: kernel(next(cycle)), iters=50)
    plain_ms = time_ms(lambda: plain(next(cycle)), iters=20)
    nbytes = rows * K * 2 + rows * Kp + (K * 4 if static else rows * 4)
    bms, bound_by = bound(4.0 * rows * K, nbytes)
    kind = "quantize_static" if static else "quantize_dynamic"
    print(f"[int8] {kind} {name}: rows={rows} K={K} (padded {Kp}) bit-exact="
          f"{exact} ms={ms:.5f} plain_ms={plain_ms:.5f} (eager chain: "
          f"quantize + pad) library_ms=None (no one call) bound_ms={bms:.5f} "
          f"({bound_by}: {nbytes / 1e6:.2f} MB) timed over {len(sets)} input "
          f"set(s) -> {'ok' if exact else 'FAIL'}", flush=True)
    if not exact:
        raise SystemExit(f"{kind} {name} disagrees with its plain version")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": None}


def check_epilogue(name, rows, N, dynamic, seed):
    """int8_epilogue against its plain version: fp32 output bit for bit,
    bf16 output (the path's) bit for bit."""
    import itertools
    import torch
    from bevgen_torch.ops import quant as tq
    g = torch.Generator(device="cuda").manual_seed(seed)
    Np = tq.padded(N)
    w_scale = torch.rand(N, generator=g, device="cuda") * 1e-4 + 1e-5
    xs = (torch.rand(rows, generator=g, device="cuda") * 0.05 + 0.01
          if dynamic else None)
    sets = _cold_sets(rows * Np * 4, lambda i: torch.randint(
        -2 ** 20, 2 ** 20, (rows, Np), generator=g, device="cuda",
        dtype=torch.int32))
    acc = sets[0]
    col = None if xs is None else xs[:, None]
    exact = all(torch.equal(
        tq.int8_epilogue_cuda(acc, w_scale, xs, rows, dt),
        tq.int8_epilogue_reference(acc[:, :N], w_scale, col, dt))
        for dt in (torch.float32, torch.bfloat16))
    cycle = itertools.cycle(sets)
    ms = time_ms(lambda: tq.int8_epilogue_cuda(next(cycle), w_scale, xs, rows,
                                               torch.bfloat16), iters=50)
    plain_ms = time_ms(lambda: tq.int8_epilogue_reference(
        next(cycle)[:, :N], w_scale, col, torch.bfloat16), iters=20)
    nbytes = rows * Np * 4 + N * 4 + (rows * 4 if dynamic else 0) + rows * N * 2
    bms, bound_by = bound((3.0 if dynamic else 2.0) * rows * N, nbytes)
    print(f"[int8] int8_epilogue {name}: rows={rows} N={N} (acc {Np} wide) "
          f"{'dynamic' if dynamic else 'static'} fp32 and bf16 bit-exact="
          f"{exact} ms={ms:.5f} plain_ms={plain_ms:.5f} (eager chain) "
          f"library_ms=None (no one call) bound_ms={bms:.5f} ({bound_by}: "
          f"{nbytes / 1e6:.2f} MB) timed over {len(sets)} input set(s) -> "
          f"{'ok' if exact else 'FAIL'}", flush=True)
    if not exact:
        raise SystemExit(f"int8_epilogue {name} disagrees with its plain version")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": None}


def check_w8(name, M, N, K, seed):
    """w8_linear against its plain version in fp32 (W8_TOL), timed over
    weight sets beyond the L2; library_ms: F.linear with the bf16 weights
    cast once."""
    import itertools
    import torch
    import torch.nn.functional as F
    from bevgen_torch.ops import quant as tq
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
    sets = _cold_sets(N * K, lambda i: (
        torch.randint(-127, 128, (N, K), generator=g, device="cuda",
                      dtype=torch.int8),
        torch.rand(N, generator=g, device="cuda") * 0.03 / math.sqrt(K),
        (0.02 * torch.randn(N, generator=g, device="cuda")).bfloat16()))
    w, scale, bias = sets[0]
    got = tq.w8_linear_cuda(x, w, scale, bias)
    want = tq.w8_linear_reference(x.float(), w, scale, bias.float())
    err = (got.float() - want).abs()
    max_err, max_ref = err.max().item(), want.abs().max().item()
    ok = bool(torch.isfinite(got).all()) and max_err <= W8_TOL * max_ref
    del err, want
    bf16_sets = [(wq.bfloat16(), s.bfloat16(), b) for wq, s, b in sets]
    cycle, bcycle = itertools.cycle(sets), itertools.cycle(bf16_sets)
    ms = time_ms(lambda: tq.w8_linear_cuda(x, *next(cycle)), iters=50)
    plain_ms = time_ms(lambda: tq.w8_linear_reference(x, *next(cycle)), iters=20)

    def library():
        wb, _, b = next(bcycle)
        return F.linear(x, wb, b)
    lib_ms = time_ms(library, iters=50)
    nbytes = M * K * 2 + N * K + N * 4 + N * 2 + M * N * 2
    bms, bound_by = bound(2.0 * M * N * K, nbytes)
    print(f"[int8] w8_linear {name}: M={M} N={N} K={K} max_abs_err="
          f"{max_err:.3e} (max |out| {max_ref:.3f}, bound {W8_TOL:.4f} of it) "
          f"ms={ms:.5f} plain_ms={plain_ms:.5f} (eager: cast, matmul, scale, "
          f"bias) library_ms={lib_ms:.5f} (F.linear, bf16 weights) bound_ms="
          f"{bms:.5f} ({bound_by}: {nbytes / 1e6:.2f} MB, "
          f"{2.0 * M * N * K / 1e9:.3f} GFLOP) timed over {len(sets)} weight "
          f"set(s) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"w8_linear {name} disagrees with its plain version")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": bound_by, "library_ms": lib_ms}


def int8_shapes(cfg, ar_cfg):
    """The int8 kernels' shapes on the int8 paths: the MUSE b=2 generate's
    (rows = 2 x cameras x 256 image tokens, 2 x 256 BEV tokens for the
    cross-attention K/V) and the AR b=2 generate's (decode M = 2, prefill M
    = 2 x 256)."""
    tf, at = cfg.transformer, ar_cfg.transformer
    rows, ctx = 2 * tf.num_img_tokens, 2 * tf.num_cond_tokens
    d, inner = tf.num_embed, int(tf.num_embed * tf.ff_mult * 2 / 3)
    h = tf.num_heads * tf.dim_head
    ad, ahid, pre = at.num_embed, at.hidden_size, 2 * at.num_cond_tokens
    return {
        "static": [(rows, d), (rows, inner)],
        "dynamic": [(rows, h), (ctx, d)],
        "epilogue": [(rows, d, False), (rows, 2 * h, False),
                     (rows, 2 * inner, False), (rows, d, True),
                     (ctx, 2 * h, True)],
        "w8": [(2, 3 * ahid, ad), (2, 4 * ad, ad), (2, ad, 4 * ad),
               (2, at.vocab_size, ad), (pre, ahid, ad), (pre, 4 * ad, ad),
               (pre, ad, 4 * ad)],
    }


def int8_kernels_phase(cfg, ar_cfg):
    """Phase 35: the four int8 kernels against their plain versions at the
    int8 paths' full-width shapes, and torch._int_mm on the padded operands
    against the exact int32 product."""
    import torch
    from bevgen_torch.ops import quant as tq
    shapes = int8_shapes(cfg, ar_cfg)
    stats = {}
    for i, (rows, K) in enumerate(shapes["static"]):
        stats[("static", rows, K)] = check_quantize(f"{rows}x{K}", rows, K,
                                                    True, 40 + i)
    for i, (rows, K) in enumerate(shapes["dynamic"]):
        stats[("dynamic", rows, K)] = check_quantize(f"{rows}x{K}", rows, K,
                                                     False, 42 + i)
    for i, (rows, N, dyn) in enumerate(shapes["epilogue"]):
        stats[("epilogue", rows, N, dyn)] = check_epilogue(
            f"{rows}x{N}", rows, N, dyn, 44 + i)
    for i, (M, N, K) in enumerate(shapes["w8"]):
        stats[("w8", M, N, K)] = check_w8(f"{M}x{N}x{K}", M, N, K, 50 + i)
    # the library int8 product on the padded operands: exact
    g = torch.Generator(device="cuda").manual_seed(60)
    for rows, K, N in ((shapes["static"][0][0], 1024, 1024),
                       (shapes["static"][1][0], shapes["static"][1][1], 1024),
                       (shapes["static"][0][0], 1024,
                        shapes["epilogue"][2][1])):
        Kp, Np = tq.padded(K), tq.padded(N)
        xq = torch.zeros(rows, Kp, dtype=torch.int8, device="cuda")
        xq[:, :K] = torch.randint(-127, 128, (rows, K), generator=g,
                                  device="cuda", dtype=torch.int8)
        wp = torch.zeros(Np, Kp, dtype=torch.int8, device="cuda")
        wp[:N, :K] = torch.randint(-127, 128, (N, K), generator=g,
                                   device="cuda", dtype=torch.int8)
        acc = torch._int_mm(xq, wp.t())
        exact = torch.equal(acc, tq.int8_product(xq, wp))
        ms = time_ms(lambda: torch._int_mm(xq, wp.t()), iters=50)
        wb, xb = wp.bfloat16(), xq.bfloat16()
        bf_ms = time_ms(lambda: xb @ wb.t(), iters=50)
        print(f"[int8] torch._int_mm {rows}x{Kp} @ ({Np}x{Kp})^T (padded from "
              f"K={K}, N={N}): exact int32 {exact}; {ms:.5f} ms, the bf16 "
              f"product of the same operands {bf_ms:.5f} ms", flush=True)
        if not exact:
            raise SystemExit("torch._int_mm on the padded operands is not exact")
    return stats


def muse_int8_launches(cfg):
    """The int8 kernels' launches per b=2 generate: (quantize_static by (rows,
    K), quantize_dynamic by (rows, K), int8_epilogue by (rows, N, dynamic))."""
    tf = cfg.transformer
    L, f = tf.num_layers, 2 * cfg.muse.sample_iterations - 1
    shp = int8_shapes(cfg, cfg)
    (rs, d), (_, inner) = shp["static"]
    _, (ctx, _) = shp["dynamic"]
    e = shp["epilogue"]
    static = {(rs, d): f * (4 * L + 1), (rs, inner): f * L}
    dynamic = {(rs, d): f * 2 * L, (ctx, d): L}
    epi = {e[0]: f * (3 * L + 1), e[1]: f * L, e[2]: f * L, e[3]: f * 2 * L,
           e[4]: L}
    return static, dynamic, epi


def _generate_timed(pipe, inputs, seed):
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = pipe.generate_fn(*inputs, torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, torch.cuda.max_memory_allocated() - before


def _int8_counts():
    from bevgen_torch.ops import quant as tq
    return ({k: v for k, v in tq.quantize_static_cuda.launches_by_shape.items()},
            {k: v for k, v in tq.quantize_dynamic_cuda.launches_by_shape.items()},
            {k: v for k, v in tq.int8_epilogue_cuda.launches_by_shape.items()},
            tq.w8_linear_cuda.launches)


def muse_int8_modes(cfg, bf16, int8, label, inputs, want_counts, glue=False):
    """Generates of the bf16 and the int8 pipeline in turns (one warm-up
    each, INT8_TIMED timed): images/s, peak memory over the resident set,
    the first timed int8 run's launch counts checked against `want_counts`
    (and the glue kernels' with `glue`)."""
    import torch
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import quant as tq
    tf = cfg.transformer
    pipes = {"bf16": bf16, "int8": int8}
    for mode, p in pipes.items():
        _generate_timed(p, inputs, 0)
    times, peak = {m: [] for m in pipes}, {}
    for i in range(INT8_TIMED):
        order = ("int8", "bf16") if i % 2 == 0 else ("bf16", "int8")
        for mode in order:
            if i == 0 and mode == "int8":
                tq.reset_launch_counts()
                ca.reset_launch_counts()
                fg.reset_launch_counts()
            (images, ids), s, pk = _generate_timed(pipes[mode], inputs, 1 + i)
            times[mode].append(s)
            peak[mode] = max(peak.get(mode, 0), pk)
            if i == 0 and mode == "int8":
                counts = _int8_counts()
                row1 = ca.cosine_attention_cuda.launches
                row1_shapes = dict(ca.cosine_attention_cuda.launches_by_shape)
                glue_n = (fg.residual_layernorm_cuda.launches,
                          fg.geglu_layernorm_cuda.launches)
                q_images, q_ids = images, ids
    n_img = 2 * tf.num_cams
    med = {m: sorted(v)[len(v) // 2] for m, v in times.items()}
    wbytes = {m: tq.weight_bytes(p.maskgit) for m, p in pipes.items()}
    for mode in pipes:
        print(f"[int8-muse] {label} {mode} generate_fn b=2: timed "
              f"{', '.join(f'{t:.4f}' for t in times[mode])} s, median "
              f"{med[mode]:.4f} s = {n_img / med[mode]:.3f} images/s; MaskGit "
              f"weights {wbytes[mode] / 1e6:.1f} MB, peak above the resident "
              f"set {peak[mode] / 1e6:.1f} MB", flush=True)
    steps = cfg.muse.sample_iterations
    want_row1 = (2 * steps - 1) * tf.num_layers * 2
    want_glue = ((2 * steps - 1) * 3 * tf.num_layers, 0) if glue else (0, 0)
    static, dynamic, epi, w8 = counts
    print(f"[int8-muse] {label} launches in the first timed int8 generate: "
          f"quantize_static {static}, quantize_dynamic {dynamic}, "
          f"int8_epilogue {epi}, w8_linear {w8}, row 1 {row1} (expected "
          f"{want_row1}), residual + LayerNorm and GEGLU + LayerNorm {glue_n} "
          f"(expected {want_glue})", flush=True)
    if (static, dynamic, epi, w8) != (*want_counts, 0) or row1 != want_row1 \
            or glue_n != want_glue:
        raise SystemExit(f"int8 generate ({label}) launch counts differ from "
                         f"{want_counts} / {want_row1} / {want_glue}")
    if not torch.isfinite(q_images).all() or q_ids.min() < 0 or \
            q_ids.max() >= tf.vocab_size:
        raise SystemExit(f"int8 generate ({label}): non-finite images or ids "
                         f"out of range")
    return {"images_per_s": {m: n_img / v for m, v in med.items()},
            "peak_mb": {m: v / 1e6 for m, v in peak.items()},
            "weights_mb": {m: v / 1e6 for m, v in wbytes.items()},
            "counts": counts, "row1_shapes": row1_shapes, "glue": glue_n}


def int8_muse_phase(cfg):
    """Phase 36: `quantized()` of the seed-0 `argoverse_muse_7cam` pipeline
    at b=2: one forward through the int8 kernels against the plain int8
    route, int8 against bf16 logits, then generates in turns (bf16, int8)
    with images/s, peak memory and launch counts; the same with
    use_fused_glue=true."""
    import torch
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.ops import quant as tq
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    tf = cfg.transformer
    bf16 = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=0)
    t0 = time.perf_counter()
    int8 = bf16.quantized()
    torch.cuda.synchronize()
    print(f"[int8-muse] quantized() in {time.perf_counter() - t0:.2f} s",
          flush=True)
    batch = fake_batch(cfg, batch_size=2, seed=0)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    g = torch.Generator(device="cuda").manual_seed(3)
    fids = torch.randint(0, tf.vocab_size + 1, (2, tf.num_cams,
                                                tf.num_cam_tokens),
                         generator=g, device="cuda")
    mods = [m for m in int8.modules() if isinstance(m, tq.QuantDense)]
    with torch.inference_mode():
        seg, ii, ei = int8.as_inputs(*inputs)
        cond = int8.encode_bev(seg)
        cache = int8.maskgit.build_cache(cond, ii, ei)
        lk = int8.maskgit(fids, cond, ii, ei, cache=cache).logits.float()
        for m in mods:
            m.route = tq.int8_dense_reference
        plain_cache = int8.maskgit.build_cache(cond, ii, ei)
        lp = int8.maskgit(fids, cond, ii, ei, cache=plain_cache).logits.float()
        for m in mods:
            m.route = tq.int8_dense
        lb = bf16.maskgit(fids, cond, ii, ei).logits.float()
    cos_kp, top_kp = logit_agreement(lk, lp)
    cos_qb, top_qb = logit_agreement(lk, lb)
    same = torch.equal(lk, lp)
    rms = (lk - lb).pow(2).mean().sqrt()
    top2 = lb.topk(2, dim=-1).values
    decided = (top2[..., 0] - top2[..., 1]) > INT8_GAP_RMS * rms
    top_dec = (lk.argmax(-1) == lb.argmax(-1))[decided].float().mean().item()
    share = decided.float().mean().item()
    print(f"[int8-muse] one full-width forward, int8 kernels vs the plain "
          f"int8 route: identical {same}, cosine {cos_kp:.6f}, top-1 "
          f"{top_kp:.4f}, max abs diff {(lk - lp).abs().max().item():.4f}; "
          f"int8 vs bf16: cosine {cos_qb:.6f} (min {INT8_COS_MIN}), top-1 "
          f"{top_qb:.4f} raw, {top_dec:.4f} (min {INT8_DECIDED_TOP1_MIN}) on "
          f"the {share:.4f} of positions whose bf16 top-2 gap exceeds "
          f"{INT8_GAP_RMS} x the RMS logit difference {rms.item():.4f}",
          flush=True)
    del lk, lp, lb, cache, plain_cache
    if not (cos_kp >= LOGIT_COS_MIN and top_kp >= TOP1_AGREE_MIN):
        raise SystemExit("the int8 kernels disagree with the plain int8 route")
    if not (cos_qb >= INT8_COS_MIN and top_dec >= INT8_DECIDED_TOP1_MIN):
        raise SystemExit("int8 logits do not track bf16")
    want = muse_int8_launches(cfg)
    res = {"plain": muse_int8_modes(cfg, bf16, int8, "glue off", inputs, want)}
    glue_cfg = dataclasses.replace(cfg, transformer=tf.replace(
        use_fused_glue=True))
    gb = BEVGenPipeline.create(glue_cfg, device="cuda")
    gb.load_state_dict(bf16.state_dict())
    del bf16, int8
    torch.cuda.empty_cache()
    res["glue"] = muse_int8_modes(glue_cfg, gb, gb.quantized(), "glue on",
                                  inputs, want, glue=True)
    return res


def ar_int8_launches(cfg):
    """w8_linear launches per KV-cached AR generate: the prefill's 5
    products a layer and its head, then 3 (fused q/k/v, MLP in and out) a
    layer and the head per decode step."""
    tf = cfg.transformer
    return (5 * tf.num_layers + 1) + tf.num_img_tokens * (3 * tf.num_layers + 1)


def int8_ar_phase(cfg, bf16_e2e):
    """Phase 37: `quantized()` of the seed-0 `nuscenes_ar` pipeline, b=2,
    KV-cached, top_k=100: AR_INT8_TIMED generates (images/s, peak memory,
    launches of row 11, w8_linear and row 9), weight bytes against bf16;
    then greedy int8 decoding through the kernels against the plain int8
    route, cut to AR_INT8_GREEDY_LAYERS layers."""
    import torch
    from bevgen_torch.models.stage2 import ar_cached
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import decode_attention as da
    from bevgen_torch.ops import quant as tq
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    tf = cfg.transformer
    B = AR_BATCH
    bf16 = ARPipeline.create(cfg, device="cuda").init_params(seed=0)
    t0 = time.perf_counter()
    int8 = bf16.quantized()
    q_s = time.perf_counter() - t0
    wb = {"bf16": tq.weight_bytes(bf16.gpt), "int8": tq.weight_bytes(int8.gpt)}
    del bf16
    torch.cuda.empty_cache()
    _, _, _, _, batch = ar_inputs(cfg, B, seed=0)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    times, peak = [], 0
    for i in range(AR_INT8_TIMED):
        if i == 0:
            tq.reset_launch_counts()
            da.reset_launch_counts()
            bs.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        images, ids = int8.generate_fn(*inputs, torch.Generator(
            device="cuda").manual_seed(1 + i), top_k=100)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peak = max(peak, torch.cuda.max_memory_allocated() - before)
        if i == 0:
            n_dec = da.decode_attention_cuda.launches
            by_pl = dict(da.decode_attention_cuda.launches_by_shape)
            n_bs = bs.block_sparse_attention_cuda.launches
            n_w8 = tq.w8_linear_cuda.launches
            w8_shapes = dict(tq.w8_linear_cuda.launches_by_shape)
            other = (tq.quantize_static_cuda.launches,
                     tq.quantize_dynamic_cuda.launches,
                     tq.int8_epilogue_cuda.launches)
    med = sorted(times)[len(times) // 2]
    n_img = B * tf.num_cams
    want_w8 = ar_int8_launches(cfg)
    print(f"[int8-ar] quantized() in {q_s:.2f} s; GPT weights bf16 "
          f"{wb['bf16'] / 1e6:.1f} MB, int8 {wb['int8'] / 1e6:.1f} MB; "
          f"generate_fn b={B} cached top_k=100, {AR_INT8_TIMED} timed (no "
          f"warm-up: phase 14 warmed the path) "
          f"{', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s = "
          f"{n_img / med:.4f} images/s (bf16, phase 14: "
          f"{bf16_e2e.get('images_per_s', float('nan')):.4f}); peak above the "
          f"resident set {peak / 1e6:.1f} MB (bf16, phase 14: "
          f"{bf16_e2e.get('peak_mb', float('nan')):.1f} MB); launches in the "
          f"first: decode "
          f"{n_dec} (expected {tf.num_layers * tf.num_img_tokens}), w8_linear "
          f"{n_w8} (expected {want_w8}) {w8_shapes}, block-sparse {n_bs}, "
          f"W8A8 kernels {other}", flush=True)
    if (n_dec, n_w8, n_bs, other) != (tf.num_layers * tf.num_img_tokens,
                                      want_w8, 0, (0, 0, 0)):
        raise SystemExit("AR int8 generate launch counts differ")
    if not torch.isfinite(images).all() or ids.min() < 0 or \
            ids.max() >= tf.vocab_size:
        raise SystemExit("AR int8 generate: non-finite images or ids out of "
                         "range")
    del int8
    torch.cuda.empty_cache()

    # greedy, kernels vs the plain int8 route, at a cut depth
    gcfg = dataclasses.replace(cfg, transformer=tf.replace(
        num_layers=AR_INT8_GREEDY_LAYERS))
    gp = ARPipeline.create(gcfg, device="cuda").init_params(seed=1).quantized()
    _, _, _, _, gbatch = ar_inputs(gcfg, 1, seed=1)
    ginputs = (gbatch["segmentation"], gbatch["intrinsics_inv"],
               gbatch["extrinsics_inv"])
    mods = [m for m in gp.modules() if isinstance(m, tq.Int8WeightDense)]
    gen = torch.Generator(device="cuda")
    t0 = time.perf_counter()
    _, ids_k = gp.generate_fn(*ginputs, gen.manual_seed(0), top_k=1)
    torch.cuda.synchronize()
    k_s = time.perf_counter() - t0
    for m in mods:
        m.route = tq.w8_linear_reference
    _, ids_p = gp.generate_fn(*ginputs, gen.manual_seed(0), top_k=1)
    traj = ids_k.reshape(1, gcfg.transformer.num_cams, -1)
    tok = traj.reshape(1, -1)
    with torch.inference_mode():
        seg, ii, ei = gp.as_inputs(*ginputs)
        cond_ids = gp.encode_bev(seg)
        lp = ar_cached.teacher_forced_logits(gp.gpt, traj, cond_ids, ii, ei)
    for m in mods:
        m.route = tq.w8_linear

    def best(logits):
        return logits.gather(-1, tok[..., None])[..., 0] >= logits.amax(-1)
    step_agree = best(lp).float().mean().item()
    free = (ids_k == ids_p).float().mean().item()
    print(f"[int8-ar] greedy top_k=1 b=1, full width cut to "
          f"{AR_INT8_GREEDY_LAYERS} of {tf.num_layers} layers (time): kernels "
          f"{k_s:.2f} s; the plain int8 route's choice at every step of the "
          f"kernels' trajectory agrees at {step_agree:.4f} (min "
          f"{GREEDY_AGREE_MIN}, ties counted); free-running token agreement "
          f"{free:.4f}", flush=True)
    if not step_agree >= GREEDY_AGREE_MIN:
        raise SystemExit("AR int8 greedy decoding disagrees between the "
                         "kernels and the plain int8 route")
    return {"images_per_s": n_img / med, "s": med, "peak_mb": peak / 1e6,
            "weights_mb": {k: v / 1e6 for k, v in wb.items()},
            "w8_shapes": w8_shapes, "by_pl": by_pl}


def int8_cli_phase(cfg, ar_cfg):
    """Phase 38: the generate CLI with quant=int8 and quant=auto for both
    pipelines (MUSE at full width, b=2; AR at full width cut to 2 layers,
    b=1): the mode served, the int8 kernels launched, the crossover table's
    card beside this card."""
    import os
    import tempfile
    import torch
    from bevgen_torch.ops import quant as tq
    from bevgen_torch.pipelines.generate import BEVGenPipeline, crossover_table
    from bevgen_torch.scripts import generate as cli
    card = gpu_name_and_power()
    table = crossover_table()
    print(f"[int8-cli] crossover table (bevgen_torch/configs/"
          f"int8_crossover.json) measured on {table['chip']!r}; this card "
          f"{card!r}", flush=True)
    runs = [("muse", "int8", ["fake=1", "batch_size=2"]),
            ("muse", "auto", ["fake=2", "batch_size=2"]),
            ("ar", "int8", ["pipeline=ar", "transformer.num_layers=2",
                            "fake=1", "batch_size=1"]),
            ("ar", "auto", ["pipeline=ar", "transformer.num_layers=2",
                            "fake=1", "batch_size=1"])]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, quant, args in runs:
            tq.reset_launch_counts()
            (pipe, paths), lines = run_cli(cli.run, args + [
                f"quant={quant}", f"out={os.path.join(tmp, kind + quant)}"])
            torch.cuda.synchronize()
            counts = tq.launch_counts()
            served = pipe.config.transformer.quant
            if kind == "muse":
                want = "int8" if (quant == "int8" or BEVGenPipeline.
                                  int8_beats_bf16(2) is not False) else "none"
            else:
                want = "int8"
            arrays = [dict(np.load(p)) for p in paths]
            finite = all(np.isfinite(a["images"]).all() for a in arrays)
            launched = (counts["w8_linear"] > 0 if kind == "ar"
                        else counts["int8_epilogue"] > 0)
            ok = served == want and finite and launched == (want == "int8")
            print(f"[int8-cli] {kind} quant={quant}: served {served} "
                  f"(expected {want}), {len(paths)} batch(es), images finite "
                  f"{finite}, int8 launches {counts}; "
                  f"{json.loads(lines[-1])['images_per_sec']} images/s -> "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise SystemExit(f"generate quant={quant} ({kind}) failed")
            out[(kind, quant)] = served
            del pipe
            torch.cuda.empty_cache()
    return out



def int8_kernel_entries(cfg, ar_cfg, stats, muse, ar, row1_stats, dec_stats,
                        glue_stats):
    """The kernels line's entries of the int8 paths: the four int8 kernels at
    their shapes (phase 35's numbers, the launches of phase 36's first timed
    int8 generate and phase 37's), and rows 1, 11 and 12 with the int8 paths'
    launches (their numbers from phases 3, 12 and 21)."""
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.ops import decode_attention as da
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import quant as tq
    tf, at = cfg.transformer, ar_cfg.transformer
    shp = int8_shapes(cfg, ar_cfg)
    static_n, dynamic_n, epi_n, _ = muse["plain"]["counts"]
    out = []
    for rows, K in shp["static"]:
        out.append({"name": f"quantize_static[muse int8 b2 {rows}x{K}]",
                    "route": "cuda", "source": tq.SOURCE,
                    "replaces": tq.QUANTIZE_STATIC_REPLACES,
                    "launches": static_n.get((rows, K), 0),
                    **stats[("static", rows, K)]})
    for rows, K in shp["dynamic"]:
        out.append({"name": f"quantize_dynamic[muse int8 b2 {rows}x{K}]",
                    "route": "cuda", "source": tq.SOURCE,
                    "replaces": tq.QUANTIZE_DYNAMIC_REPLACES,
                    "launches": dynamic_n.get((rows, K), 0),
                    **stats[("dynamic", rows, K)]})
    for rows, N, dyn in shp["epilogue"]:
        out.append({"name": f"int8_epilogue[muse int8 b2 {rows}x{N} "
                            f"{'dynamic' if dyn else 'static'}]",
                    "route": "cuda", "source": tq.SOURCE,
                    "replaces": tq.EPILOGUE_REPLACES,
                    "launches": epi_n.get((rows, N, dyn), 0),
                    **stats[("epilogue", rows, N, dyn)]})
    for M, N, K in shp["w8"]:
        out.append({"name": f"w8_linear[ar int8 b2 {M}x{N}x{K}]",
                    "route": "cuda", "source": tq.SOURCE,
                    "replaces": tq.W8_LINEAR_REPLACES,
                    "launches": ar["w8_shapes"].get((M, N, K), 0),
                    **stats[("w8", M, N, K)]})
    N, NC = tf.num_img_tokens, tf.num_cond_tokens
    for label, run in (("int8", muse["plain"]), ("int8 glue", muse["glue"])):
        for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
            out.append({"name": f"cosine_attention_fwd[{label} serve {shape} "
                                f"b2 {n}x{m}]",
                        "route": "cuda", "source": ca.SOURCE,
                        "replaces": ca.REPLACES,
                        "launches": run["row1_shapes"].get((n, m), 0),
                        **row1_stats[shape]})
    out.append({"name": f"residual_layernorm[int8 glue serve b2 "
                        f"{2 * N}x{tf.num_embed}]",
                "route": "cuda", "source": fg.SOURCE,
                "replaces": fg.RES_LN_REPLACES,
                "launches": muse["glue"]["glue"][0],
                **glue_stats[("residual", 2)]})
    for pl, st in dec_stats.items():
        out.append({"name": f"decode_attention[ar int8 b{AR_BATCH} "
                            f"H{at.num_heads} pl{pl}]",
                    "route": "cuda", "source": da.SOURCE,
                    "replaces": da.REPLACES,
                    "launches": ar["by_pl"].get(pl, 0), **st})
    return out


# ---- stage-1 training (phases 39-42) ----------------------------------------

STAGE1_BATCH = 8
STAGE1_TIMED = 5
SEG_FALL_STEPS = 25
SEG_FALL_LR = 1e-3      # the JAX package's own check (tests/test_training.py)
PEAK_TF32_FLOPS = 495e12    # H100 SXM dense TF32 tensor-core rate
# Phase 41, the card (TF32 off) against the CPU, fp32 on both: the loss
# terms and d_weight (a ratio of two gradient norms) within rtol 1e-3 at each
# of two steps. Parameters after two Adam steps: Adam divides each gradient
# by its own running size, so an entry whose gradient is zero in exact
# arithmetic (the attention k biases, biases that feed a GroupNorm of one
# channel a group) takes a step of up to ~1.04 lr either way from rounding
# noise alone; every entry is held to two such steps on each side (4.2 lr),
# and all but STAGE1_PARAM_OUTLIERS of all entries to 5e-3 lr.
STAGE1_METRIC_RTOL = 1e-3
STAGE1_PARAM_OUTLIERS = 5e-3
STAGE1_CHECK_LR = 1e-4
STAGE1_CLI_STEPS = 3


@contextlib.contextmanager
def tf32_flags(cudnn, matmul):
    """Set cudnn's and the matmuls' TF32 flags inside the block, then put
    the previous ones back."""
    import torch
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@contextlib.contextmanager
def cudnn_deterministic():
    """cuDNN's deterministic algorithms inside the block, then the previous
    choice. The default choice may sum a weight gradient with atomics, whose
    order varies from run to run: two phase-41 card runs in one process then
    differed in 2% of the parameter entries (those whose gradient is at
    rounding-noise level, which Adam turns into steps of ~lr) in some calls,
    and were identical with this flag (NVIDIA H100 80GB HBM3)."""
    import torch
    old = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = old


def write_lpips_npz(path, seed=39):
    """Seeded full-width VGG16 + LPIPS heads in the npz layout that
    `models/lpips.py:load_lpips_params` reads (the converted weights'
    `vgg/conv_{stage}_{c}/...` and `lin_{i}/kernel`)."""
    from bevgen_torch.core.convert import export_jax_params
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.lpips import LPIPS
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v
    walk(export_jax_params(init_weights(LPIPS(), seed)), ())
    np.savez(path, **flat)
    return path


def timed_steps(step, state, batches):
    """Host seconds of each step (synchronised) and the metrics of each."""
    import torch
    times, metrics = [], []
    for x in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, x)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return times, metrics


def stage1_step_report(name, step, state, make_batch, card, tf32):
    """One warm-up step under torch's FlopCounterMode (the operators' FLOPs
    from their shapes: convolutions and matrix products, forward and
    backward), then STAGE1_TIMED timed steps with the peak memory. Returns
    the numbers and the timed steps' metrics."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        step(state, make_batch(0))
    torch.cuda.synchronize()
    flops = counter.get_total_flops()
    torch.cuda.reset_peak_memory_stats()
    times, metrics = timed_steps(step, state, [make_batch(i + 1)
                                               for i in range(STAGE1_TIMED)])
    med = sorted(times)[len(times) // 2]
    peak = torch.cuda.max_memory_allocated() / 1e9
    share = flops / med / PEAK_TF32_FLOPS
    print(f"[stage1] {name} b={STAGE1_BATCH}: steps "
          f"{', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s = "
          f"{STAGE1_BATCH / med:.2f} images/s; peak {peak:.2f} GB; "
          f"{flops / 1e12:.3f} TFLOP a step (FlopCounterMode) = "
          f"{flops / med / 1e12:.1f} TFLOP/s, {share:.4f} of the dense TF32 "
          f"peak ({PEAK_TF32_FLOPS / 1e12:g} TFLOP/s); cudnn.allow_tf32="
          f"{tf32[0]} cuda.matmul.allow_tf32={tf32[1]}; {card}", flush=True)
    return {"step_s": med, "steps_s": times, "images_per_s": STAGE1_BATCH / med,
            "peak_gb": peak, "tflop": flops / 1e12,
            "tf32_share": share}, metrics


def changed_share(before, module):
    """The share of `module`'s parameter tensors that differ from `before`."""
    import torch
    now = [p.detach() for p in module.parameters()]
    return sum(not torch.equal(a, b) for a, b in zip(before, now)) / len(now)


def vqgan_phase(s1cfg, base_lr, lpips_npz, tf32):
    """Phase 39: the RGB VQ-GAN step at full width (`argoverse_muse`'s
    first_stage: 256 x 256, ch 128, ch_mult (1,1,2,2,4), 2 res blocks,
    attention at 16, z 256, codebook 1024 x 256), b=8, fp32, with
    `NLayerDiscriminator()` and LPIPS on seeded full-width VGG16 weights read
    through `LPIPSMetric`, at the CLI's lr, under PyTorch's default TF32
    flags: one warm-up step (its FLOPs counted), five timed; every metric
    finite, d_weight >= 0, the autoencoder's and the discriminator's
    parameters changed. Also the forward's FLOPs per image."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from bevgen_torch.metrics.quality import LPIPSMetric
    from bevgen_torch.models.discriminator import NLayerDiscriminator
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage1.vq import VQModel
    from bevgen_torch.scripts.train_stage1 import perceptual_term
    from bevgen_torch.training import stage1_trainer
    from bevgen_torch.training.optim import scaled_lr
    card = gpu_name_and_power()
    B = STAGE1_BATCH
    with tf32_flags(*tf32):
        model = init_weights(VQModel(s1cfg), 39).cuda()
        disc = init_weights(NLayerDiscriminator(), 40).cuda()
        metric = LPIPSMetric(str(lpips_npz), device="cuda")
        if not metric.available:
            raise SystemExit(f"LPIPSMetric found no weights at {lpips_npz}")
        n_ae = sum(p.numel() for p in model.parameters())
        n_d = sum(p.numel() for p in disc.parameters())
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.zeros((1, s1cfg.resolution, s1cfg.resolution,
                               s1cfg.in_channels), device="cuda"))
        fwd = counter.get_total_flops()
        state = stage1_trainer.create_stage1_state(
            model, disc, scaled_lr(base_lr, B))
        step = stage1_trainer.make_vqgan_train_step(
            perceptual_term(metric), perceptual_weight=1.0)
        before_ae = [p.detach().clone() for p in model.parameters()]
        before_d = [p.detach().clone() for p in disc.parameters()]
        gen = torch.Generator(device="cuda").manual_seed(39)

        def batch(i):
            return torch.randn((B, s1cfg.resolution, s1cfg.resolution,
                                s1cfg.in_channels), generator=gen,
                               device="cuda")
        res, metrics = stage1_step_report("VQ-GAN step (PatchGAN + LPIPS)",
                                          step, state, batch, card, tf32)
        ae_share = changed_share(before_ae, model)
        d_share = changed_share(before_d, disc)
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    d_weights = [m["train/d_weight"] for m in metrics]
    print(f"[stage1] VQ-GAN: {n_ae / 1e6:.1f} M autoencoder and "
          f"{n_d / 1e6:.2f} M discriminator parameters; forward "
          f"{fwd / 1e12:.4f} TFLOP an image; last step "
          f"{json.dumps({k: round(v, 5) for k, v in metrics[-1].items()})}; "
          f"d_weight {d_weights}; parameter tensors changed: autoencoder "
          f"{ae_share:.3f}, discriminator {d_share:.3f}", flush=True)
    if not finite or min(d_weights) < 0:
        raise SystemExit("the VQ-GAN step gave a non-finite metric or a "
                         "negative d_weight")
    if ae_share < 0.5 or d_share < 0.5:
        raise SystemExit("the VQ-GAN step left the parameters unchanged")
    del state, model, disc, metric, before_ae, before_d
    return {**res, "fwd_tflop_per_image": fwd / 1e12}


def vqvae_phase(s1cfg, base_lr, tf32):
    """Phase 40: the BEV VQ-VAE step at full width (`cond_stage`: 7 channels
    at 256 x 256), b=8, BCE, at the CLI's lr under PyTorch's default TF32
    flags: one warm-up step (its FLOPs counted), five timed, finite; then
    from the seeded init at the JAX package's check lr, the loss falls over
    SEG_FALL_STEPS steps on one repeated batch (the least of steps 11-25
    below the first)."""
    import torch
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage1.vq import VQSegmentationModel
    from bevgen_torch.training import stage1_trainer
    from bevgen_torch.training.optim import scaled_lr
    card = gpu_name_and_power()
    B, R = STAGE1_BATCH, s1cfg.resolution
    gen = torch.Generator(device="cuda").manual_seed(40)

    def batch(i):
        return (torch.rand((B, R, R, s1cfg.in_channels), generator=gen,
                           device="cuda") < 0.2).float()
    with tf32_flags(*tf32):
        step = stage1_trainer.make_seg_train_step()
        model = init_weights(VQSegmentationModel(s1cfg), 41).cuda()
        state = stage1_trainer.create_stage1_state(model, None,
                                                   scaled_lr(base_lr, B))
        res, metrics = stage1_step_report("BEV VQ-VAE step (BCE)", step,
                                          state, batch, card, tf32)
        model = init_weights(VQSegmentationModel(s1cfg), 41).cuda()
        state = stage1_trainer.create_stage1_state(model, None, SEG_FALL_LR)
        x = batch(0)
        _, fall = timed_steps(step, state, [x] * SEG_FALL_STEPS)
    losses = [m["loss"] for m in fall]
    print(f"[stage1] BEV VQ-VAE on one repeated batch, lr {SEG_FALL_LR}: "
          f"loss {', '.join(f'{v:.4f}' for v in losses)}", flush=True)
    if not all(math.isfinite(v) for m in metrics + fall for v in m.values()):
        raise SystemExit("the BEV VQ-VAE step gave a non-finite metric")
    if not min(losses[10:]) < losses[0]:
        raise SystemExit("the BEV VQ-VAE loss did not fall on a repeated batch")
    return res


def card_cpu_phase(lpips_npz):
    """Phase 41: one reduced-width VQ-GAN (ch 32, 64 x 64, the full
    structure, codebook 256 x 64 drawn N(0, 1) so that no two codes are near
    a tie, ndf 16) with LPIPS, from one seeded init, two steps on the card
    with both TF32 flags off and cuDNN's deterministic algorithms, and two on
    the CPU on the same batches: the
    loss terms and d_weight within STAGE1_METRIC_RTOL at each step, the
    updated parameters as the constants above say."""
    import torch
    from bevgen_torch.core.config import Stage1Config
    from bevgen_torch.metrics.quality import LPIPSMetric
    from bevgen_torch.models.discriminator import NLayerDiscriminator
    from bevgen_torch.models.init import init_weights
    from bevgen_torch.models.stage1.vq import VQModel
    from bevgen_torch.scripts.train_stage1 import perceptual_term
    from bevgen_torch.training import stage1_trainer
    s1 = Stage1Config(ch=32, resolution=64, z_channels=64, embed_dim=64,
                      n_embed=256, cam_res=(64, 64), cam_latent_res=(4, 4))
    lr = STAGE1_CHECK_LR
    rng = np.random.default_rng(41)
    xs = [torch.from_numpy(rng.standard_normal((2, 64, 64, 3)).astype(
        np.float32)) for _ in range(2)]
    runs = {}
    for dev in ("cuda", "cpu"):
        model = init_weights(VQModel(s1), 41)
        with torch.no_grad():
            model.codebook.copy_(torch.randn(
                model.codebook.shape, generator=torch.Generator().manual_seed(41)))
        disc = init_weights(NLayerDiscriminator(ndf=16), 42)
        model, disc = model.to(dev), disc.to(dev)
        step = stage1_trainer.make_vqgan_train_step(
            perceptual_term(LPIPSMetric(str(lpips_npz), device=dev)))
        state = stage1_trainer.create_stage1_state(model, disc, lr)
        with tf32_flags(False, False), cudnn_deterministic():
            metrics = [{k: float(v) for k, v in step(state, x.to(dev)).items()}
                       for x in xs]
        runs[dev] = (metrics, [p.detach().cpu() for p in model.parameters()]
                     + [p.detach().cpu() for p in disc.parameters()])
    (m_card, p_card), (m_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    worst = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-6)
                for a, b in zip(m_card, m_cpu) for k in b)
    diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(p_card, p_cpu)])
    outliers = float((diffs > 5e-3 * lr).float().mean())
    print(f"[stage1] card (TF32 off, cuDNN deterministic) vs CPU, reduced "
          f"VQ-GAN b=2 64x64, two "
          f"steps: worst metric relative difference {worst:.2e} (max "
          f"{STAGE1_METRIC_RTOL}); d_weight card "
          f"{[m['train/d_weight'] for m in m_card]} CPU "
          f"{[m['train/d_weight'] for m in m_cpu]}; parameters: max |diff| "
          f"{float(diffs.max()) / lr:.3f} lr (max 4.2), share beyond 5e-3 lr "
          f"{outliers:.2e} of {diffs.numel()} (max {STAGE1_PARAM_OUTLIERS})",
          flush=True)
    if (worst > STAGE1_METRIC_RTOL or float(diffs.max()) > 4.2 * lr
            or outliers > STAGE1_PARAM_OUTLIERS):
        raise SystemExit("the card and the CPU disagree on the stage-1 steps")
    return {"worst_metric_rel": worst, "param_outliers": outliers}


def stage1_cli_phase(lpips_npz, tmp):
    """Phase 42: `scripts/train_stage1.py` on the card at `argoverse_muse`,
    model=cam (PatchGAN + LPIPS from the npz) and model=bev, three steps
    each with a checkpoint directory: finite JSON lines, `done`, and the
    saved tag loads back into a fresh VQModel / VQSegmentationModel bit for
    bit."""
    import os
    import torch
    from bevgen_torch.core.config import argoverse_muse_config
    from bevgen_torch.models.stage1.vq import VQModel, VQSegmentationModel
    from bevgen_torch.scripts import train_stage1
    cfg = argoverse_muse_config()
    out = {}
    for which, extra in (("cam", [f"perceptual_weights={lpips_npz}"]),
                         ("bev", [])):
        ckpt = os.path.join(tmp, f"ckpt_{which}")
        t0 = time.perf_counter()
        state, lines = run_cli(train_stage1.run, [
            f"model={which}", f"steps={STAGE1_CLI_STEPS}", "log_every=1",
            f"ckpt_dir={ckpt}", *extra])
        secs = time.perf_counter() - t0
        logs = [json.loads(l) for l in lines if l.startswith("{")]
        finite = all(math.isfinite(v) for m in logs for v in m.values())
        tag = os.path.join(ckpt, open(os.path.join(ckpt, "LATEST")).read().strip())
        saved = torch.load(os.path.join(tag, "state.pt"), map_location="cpu",
                           weights_only=False)
        fresh = (VQModel(cfg.first_stage) if which == "cam"
                 else VQSegmentationModel(cfg.cond_stage))
        fresh.load_state_dict(saved["params"])
        trained = dict(state.model.named_parameters())
        same = all(torch.equal(p, trained[n].detach().cpu())
                   for n, p in fresh.named_parameters())
        ok = (lines[-1] == "done" and len(logs) == STAGE1_CLI_STEPS and finite
              and saved["step"] == STAGE1_CLI_STEPS and same)
        print(f"[stage1-cli] train_stage1 model={which}: {len(logs)} logged "
              f"steps in {secs:.1f} s (build, data and save included), "
              f"finite {finite}, {os.path.basename(tag)} reloads bit for bit "
              f"{same} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"train_stage1 model={which} failed")
        out[which] = logs[-1]["steps_per_sec"]
        del state, fresh, saved
        torch.cuda.empty_cache()
    return out


# ---- the evaluation path (phases 43-45) -------------------------------------

INCEPTION_CHECK_IMAGES = 8
INCEPTION_CHECK_SHAPES = ((256, 256), (224, 400))   # MUSE images, the AR rig's
INCEPTION_FID_IMAGES = 64
INCEPTION_TIMED_IMAGES = 512
INCEPTION_BATCH = 32
INCEPTION_TIMED = 5
# Card (TF32 off) against the CPU, fp32 on both: the features within 1e-3 of
# their largest (cuDNN and the CPU sum the 94 convolutions in other orders;
# the CPU tests hold the port to the JAX package at 1e-4); FID within 1e-3
# relative (float64 statistics of those features).
INCEPTION_FEAT_TOL = 1e-3
INCEPTION_FID_RTOL = 1e-3
# LoFTR card (TF32 off) against the CPU: the confidence matrix within 1e-4;
# the matches identical but at near-tie cells (the CPU confidence within
# 1e-4 of MATCH_THR or of its row's or column's closest rival), which may be
# at most 1% of the matches; the fine keypoints within 1e-3 px.
LOFTR_CONF_TOL = 1e-4
LOFTR_TIE_TOL = 1e-4
LOFTR_TIE_SHARE = 0.01
LOFTR_DELTA_TOL = 1e-3
LOFTR_SEED = 0          # seeded weights that match noisy copies (the tests')
LOFTR_SHAPES = ((256, 50), (256, 256))  # the reference's strip; a full image
LOFTR_TIMED = 20
LOFTR_CALLS_PER_SCENE = 4   # 2 camera pairs x (generated, ground truth)
# Phase 45's grayscale, the same on both sides and with no cv2: ITU-R BT.601
# luma (the weights of cv2's RGB2GRAY) of the [0, 1] floats.
GRAY_WEIGHTS = np.array([0.299, 0.587, 0.114], np.float32)


def noisy_pair(shape, seed, noise=0.05):
    """A random gray image and a noisy copy: the seeded LoFTR weights match
    such pairs."""
    rng = np.random.default_rng(seed)
    a = rng.random(shape, dtype=np.float32)
    return a, np.clip(a + noise * rng.standard_normal(shape), 0, 1).astype(
        np.float32)


def inception_phase(tmp, tf32):
    """Phase 43: InceptionV3 at full width on seeded weights written as a
    pytorch-fid `.pth` and converted by `convert_inception_weights`; the
    model from the npz and from the `.pth` directly, bit for bit; card (TF32
    off) against CPU features of 8 images at 256x256 and at 224x400, and
    FID of two sets of 64; then `make_inception_features` over 512 images
    at batch 32 under PyTorch's default TF32 flags: images/s (median of
    five after a warm-up), peak memory, FLOPs per image (FlopCounterMode)
    and their share of the dense TF32 peak. Returns the npz path."""
    import os
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from bevgen_torch.metrics.fid import (fid_from_features,
                                          make_inception_features)
    from bevgen_torch.metrics.inception import (
        InceptionV3, convert_inception_weights, load_inception,
        random_fid_state_dict)
    card = gpu_name_and_power()
    pth = os.path.join(tmp, "pt_inception.pth")
    npz = os.path.join(tmp, "inception.npz")
    torch.save(random_fid_state_dict(43), pth)
    t0 = time.perf_counter()
    n_arrays = convert_inception_weights(pth, npz)
    conv_s = time.perf_counter() - t0
    from_npz = load_inception(npz)
    direct = InceptionV3().load_pytorch_fid(torch.load(pth))
    same = all(torch.equal(p, q) for p, q in zip(from_npz.parameters(),
                                                 direct.parameters()))
    n_params = sum(p.numel() for p in from_npz.parameters())
    print(f"[inception] seeded pytorch-fid state dict -> "
          f"convert_inception_weights: {n_arrays} arrays in {conv_s:.1f} s; "
          f"{n_params / 1e6:.2f} M parameters from the npz and from the .pth "
          f"directly equal bit for bit {same}", flush=True)
    if not same:
        raise SystemExit("the npz and the pytorch-fid state dict give "
                         "different parameters")
    del from_npz, direct
    rng = np.random.default_rng(43)
    with tf32_flags(False, False):
        on_card = make_inception_features(npz, device="cuda")
        on_cpu = make_inception_features(npz, device="cpu")
        errs = {}
        for hw in INCEPTION_CHECK_SHAPES:
            x = rng.uniform(0, 1, (INCEPTION_CHECK_IMAGES, *hw, 3)).astype(
                np.float32)
            fc, fh = on_card(x), on_cpu(x)
            errs[hw] = float(np.abs(fc - fh).max() / np.abs(fh).max())
            print(f"[inception] card (TF32 off) vs CPU, "
                  f"{INCEPTION_CHECK_IMAGES} images {hw[0]}x{hw[1]} -> "
                  f"(n, 2048): max |diff| {errs[hw]:.2e} of max |f| "
                  f"{np.abs(fh).max():.3f} (max {INCEPTION_FEAT_TOL}); "
                  f"{card}", flush=True)
        sets = [rng.uniform(0, 1, (INCEPTION_FID_IMAGES, 256, 256, 3)).astype(
            np.float32) ** p for p in (1.0, 1.5)]
        fid_card = fid_from_features(*(on_card(s) for s in sets))
        fid_cpu = fid_from_features(*(on_cpu(s) for s in sets))
    fid_rel = abs(fid_card - fid_cpu) / abs(fid_cpu)
    print(f"[inception] FID of two sets of {INCEPTION_FID_IMAGES} at 256x256: "
          f"card {fid_card:.6f}, CPU {fid_cpu:.6f}, relative difference "
          f"{fid_rel:.2e} (max {INCEPTION_FID_RTOL}); {card}", flush=True)
    if max(errs.values()) > INCEPTION_FEAT_TOL or fid_rel > INCEPTION_FID_RTOL:
        raise SystemExit("Inception features or FID disagree between the "
                         "card and the CPU")
    del on_cpu
    with tf32_flags(*tf32):
        extract = make_inception_features(npz, batch_size=INCEPTION_BATCH,
                                          device="cuda")
        model = load_inception(npz).cuda()
        with torch.no_grad(), FlopCounterMode(display=False) as counter:
            model(torch.zeros((1, 256, 256, 3), device="cuda"))
        flops = counter.get_total_flops()
        xb = torch.rand((INCEPTION_BATCH, 256, 256, 3), device="cuda")
        with torch.inference_mode():
            model_ms = time_ms(lambda: model(xb), iters=10)
        x = rng.uniform(0, 1, (INCEPTION_TIMED_IMAGES, 256, 256, 3)).astype(
            np.float32)
        extract(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(INCEPTION_TIMED):
            t0 = time.perf_counter()
            feats = extract(x)
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
    med = sorted(times)[len(times) // 2]
    ips = INCEPTION_TIMED_IMAGES / med
    share = flops * ips / PEAK_TF32_FLOPS
    model_share = flops * INCEPTION_BATCH / (model_ms / 1e3) / PEAK_TF32_FLOPS
    print(f"[inception] make_inception_features over "
          f"{INCEPTION_TIMED_IMAGES} images of 256x256 at batch "
          f"{INCEPTION_BATCH} (host arrays in, features out): "
          f"{', '.join(f'{t:.4f}' for t in times)} s, median {med:.4f} s = "
          f"{ips:.1f} images/s; peak {peak:.2f} GB; {flops / 1e9:.3f} GFLOP "
          f"({flops / 2e9:.3f} G multiply-adds) an image at 256x256 "
          f"(FlopCounterMode) = {flops * ips / 1e12:.1f} TFLOP/s, "
          f"{share:.4f} of the dense TF32 peak; the model alone on a b="
          f"{INCEPTION_BATCH} batch on the card {model_ms:.3f} ms (bound "
          f"{flops * INCEPTION_BATCH / PEAK_TF32_FLOPS * 1e3:.3f} ms: its "
          f"operations at the TF32 peak) = "
          f"{INCEPTION_BATCH / model_ms * 1e3:.1f} images/s, "
          f"{model_share:.4f} of the peak; cudnn.allow_tf32={tf32[0]} "
          f"cuda.matmul.allow_tf32={tf32[1]}; {card}", flush=True)
    if feats.shape != (INCEPTION_TIMED_IMAGES, 2048) or not np.isfinite(
            feats).all():
        raise SystemExit("bad Inception features")
    return npz


def loftr_phase(tf32):
    """Phase 44: LoFTR at the outdoor widths on seeded `init_random_params`
    weights, on the reference's 50-px strip (256x50, padded to 56) and a
    full 256x256 pair (a random image and a noisy copy): the card (TF32 off)
    against the CPU, the confidence matrix, the matches (near ties counted)
    and the fine keypoints; then ms per matcher call under PyTorch's default
    TF32 flags (host clock around the synchronous call, median of
    LOFTR_TIMED after a warm-up) and the model's device ms (CUDA events).
    Returns the weights."""
    import torch
    from bevgen_torch.metrics import loftr
    card = gpu_name_and_power()
    params = loftr.init_random_params(np.random.default_rng(LOFTR_SEED))
    for i, shape in enumerate(LOFTR_SHAPES):
        a, b = noisy_pair(shape, 44 + i)
        with tf32_flags(False, False):
            outs = {dev: loftr.LoFTRMatcher(params, device=dev).raw(a, b)[0]
                    for dev in ("cuda", "cpu")}
        oc = {k: v.cpu().numpy() for k, v in outs["cuda"].items()}
        oh = {k: v.numpy() for k, v in outs["cpu"].items()}
        conf_err = float(np.abs(oc["conf"] - oh["conf"]).max())

        def matches(o):
            return {(int(i0), int(i1)) for i0, i1, v in
                    zip(o["idx0"], o["idx1"], o["valid"]) if v}
        mc, mh = matches(oc), matches(oh)
        near = loftr.near_tie_cells(oh["conf"], LOFTR_TIE_TOL)
        n_near = int(near.sum())
        unexplained = [m for m in mc ^ mh if not near[m]]
        common = sorted(i0 for i0, _ in mc & mh)
        delta = float(max((max(abs(oc["dy"][r] - oh["dy"][r]),
                               abs(oc["dx"][r] - oh["dx"][r])) * 2
                           for r in common), default=0.0))
        with tf32_flags(*tf32):
            matcher = loftr.LoFTRMatcher(params, device="cuda")
            matcher(a, b)
            times = []
            for _ in range(LOFTR_TIMED):
                t0 = time.perf_counter()
                matcher(a, b)
                times.append(time.perf_counter() - t0)
            p0, hw0 = loftr._pad_to_mult8(a)
            p1, hw1 = loftr._pad_to_mult8(b)
            t0_, t1_ = (torch.as_tensor(p, device="cuda") for p in (p0, p1))
            with torch.inference_mode():
                dev_ms = time_ms(lambda: matcher.model(t0_, t1_, hw0, hw1),
                                 iters=LOFTR_TIMED)
        call_ms = sorted(times)[len(times) // 2] * 1e3
        ok = (conf_err <= LOFTR_CONF_TOL and not unexplained
              and n_near <= LOFTR_TIE_SHARE * max(len(mh), 1)
              and delta <= LOFTR_DELTA_TOL and len(mh) > 0)
        print(f"[loftr] {shape[0]}x{shape[1]} (padded {p0.shape[0]}x"
              f"{p0.shape[1]}), card (TF32 off) vs CPU: confidence matrix "
              f"{oh['conf'].shape} max |diff| {conf_err:.2e} (max "
              f"{LOFTR_CONF_TOL}); matches card {len(mc)} CPU {len(mh)}, "
              f"common {len(mc & mh)}, differing outside near ties "
              f"{len(unexplained)}; near-tie cells {n_near} (max "
              f"{LOFTR_TIE_SHARE:.0%} of the matches); fine keypoints max "
              f"|diff| {delta:.2e} px (max {LOFTR_DELTA_TOL}); ms per matcher "
              f"call {call_ms:.3f} (median of {LOFTR_TIMED}: host pad, copies "
              f"and numpy out included), model on the card {dev_ms:.3f} ms; "
              f"{LOFTR_CALLS_PER_SCENE} calls per scene = "
              f"{LOFTR_CALLS_PER_SCENE * call_ms:.1f} ms; "
              f"{'ok' if ok else 'FAIL'}; {card}", flush=True)
        if not ok:
            raise SystemExit(f"LoFTR disagrees between the card and the CPU "
                             f"at {shape}")
    return params


def metrics_e2e_phase(cfg, lpips_npz, inception_npz, loftr_params, tf32):
    """Phase 45: the evaluation end to end. The seed-0 `argoverse_muse_7cam`
    pipeline generates b=2 (generator seed 0: exactly 980 row-1 launches)
    and once more with seed 1 as the ground truth; `metrics_eval.evaluate`
    on the card under PyTorch's default TF32 flags with LPIPS (phase 39's
    npz), FID on phase 43's weights and per_camera: the CLI's keys, every
    value finite; the LoFTR confidence sum over ARGOVERSE_PAIRS of both
    sets (the strips through `edge_windows`, gray by GRAY_WEIGHTS on both
    sides); seconds of evaluation per generated image. Returns the generate's
    row-1 launches by shape."""
    import torch
    from bevgen_torch.data.camera_geometry import denormalize_image
    from bevgen_torch.data.fake import fake_batch
    from bevgen_torch.metrics.consistency import ARGOVERSE_PAIRS, edge_windows
    from bevgen_torch.metrics.fid import (fid_from_features,
                                          make_inception_features)
    from bevgen_torch.metrics.loftr import MATCH_THR, LoFTRMatcher
    from bevgen_torch.metrics.quality import LPIPSMetric, ssim
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.pipelines.generate import BEVGenPipeline
    from bevgen_torch.scripts.metrics_eval import evaluate
    card = gpu_name_and_power()
    tf = cfg.transformer
    B = 2
    pipe = BEVGenPipeline.create(cfg, device="cuda").init_params(seed=0)
    batch = fake_batch(cfg, batch_size=B, seed=0)
    inputs = (batch["segmentation"], batch["intrinsics_inv"],
              batch["extrinsics_inv"])
    sets = []
    for seed in (0, 1):
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        images, _ = pipe.generate_fn(*inputs, torch.Generator(
            device="cuda").manual_seed(seed))
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        if seed == 0:
            launches = ca.cosine_attention_cuda.launches
            by_shape = dict(ca.cosine_attention_cuda.launches_by_shape)
        sets.append(denormalize_image(images.float().cpu().numpy()))
    del pipe
    torch.cuda.empty_cache()
    steps = cfg.muse.sample_iterations
    expect = (steps + steps - 1) * tf.num_layers * 2
    names = tf.camera_names
    gen, gt = (s.reshape(-1, *s.shape[2:]) for s in sets)
    n_img = gen.shape[0]
    scenes = [(dict(zip(names, sets[0][b])), dict(zip(names, sets[1][b])))
              for b in range(B)]
    with tf32_flags(*tf32):
        t0 = time.perf_counter()
        results = evaluate(
            gen, gt, scenes, lpips=LPIPSMetric(lpips_npz, device="cuda"),
            feature_fn=make_inception_features(inception_npz, device="cuda"),
            per_camera=True)
        eval_s = time.perf_counter() - t0
        # the host's share: SSIM over the pairs, one FID's float64 statistics
        t0 = time.perf_counter()
        [ssim(a, b) for a, b in zip(gt, gen)]
        ssim_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        fid_from_features(*np.random.default_rng(45).standard_normal(
            (2, n_img, 2048)))
        fid_s = time.perf_counter() - t0
        matcher = LoFTRMatcher(loftr_params, device="cuda")
        t0 = time.perf_counter()
        cons = {}
        for label, imgs in (("gen", sets[0]), ("gt", sets[1])):
            total, n_match, top = 0.0, 0, 0.0
            for b in range(B):
                cams = dict(zip(names, imgs[b]))
                for left, right in ARGOVERSE_PAIRS:
                    sa, sb = edge_windows(cams[left], cams[right])
                    out, _, _ = matcher.raw(sa @ GRAY_WEIGHTS,
                                            sb @ GRAY_WEIGHTS)
                    total += float(out["mconf"][out["valid"]].sum())
                    n_match += int(out["valid"].sum())
                    top = max(top, float(out["conf"].max()))
            cons[label] = (total, n_match, top)
        loftr_s = time.perf_counter() - t0
    want_keys = ["psnr", "ssim", "lpips", "fid_inception",
                 *(f"fid/{c}" for c in sorted(names))]
    finite = all(v is not None and math.isfinite(v) for v in results.values())
    cons_finite = all(math.isfinite(x) for v in cons.values() for x in v)
    n_fid = sum(k.startswith("fid") for k in results)
    print(f"[metrics] argoverse_muse_7cam b={B} generate (seed 0): {launches} "
          f"row-1 launches {by_shape} (expected {expect}); ground truth: the "
          f"seed-1 generate ({gen_s:.3f} s); {n_img} image pairs "
          f"{gen.shape[1:]}", flush=True)
    shown = {k: v if v is None else round(v, 6) for k, v in results.items()}
    print(f"[metrics] evaluate (psnr, ssim, LPIPS, Inception FID, "
          f"per_camera) on the card: {json.dumps(shown)}; keys "
          f"the CLI's {list(results) == want_keys}, finite {finite}; "
          f"{eval_s:.2f} s = {eval_s / n_img:.4f} s per image (weights "
          f"loaded in the call); of it on the host: SSIM of the {n_img} pairs "
          f"{ssim_s:.2f} s, one FID's statistics (2048-d, float64) "
          f"{fid_s:.2f} s x {n_fid} FIDs", flush=True)
    print(f"[metrics] LoFTR over {ARGOVERSE_PAIRS} x {B} scenes, gray "
          f"0.299 R + 0.587 G + 0.114 B: confidence sum (matches; largest "
          f"dual-softmax entry, matches need > {MATCH_THR}) generated "
          f"{cons['gen'][0]:.6f} ({cons['gen'][1]}; {cons['gen'][2]:.4f}), "
          f"ground truth {cons['gt'][0]:.6f} ({cons['gt'][1]}; "
          f"{cons['gt'][2]:.4f}); {loftr_s:.2f} s; evaluation "
          f"in all {(eval_s + loftr_s) / n_img:.4f} s per image; cudnn."
          f"allow_tf32={tf32[0]} cuda.matmul.allow_tf32={tf32[1]}; {card}",
          flush=True)
    if launches != expect or list(results) != want_keys or not (
            finite and cons_finite):
        raise SystemExit("the evaluation end to end failed its checks")
    return by_shape


# ---- the benchmark-and-trace CLI (phase 46) --------------------------------

# The JAX script's keys, in its order (`profile=true` adds "trace")
INFERENCE_KEYS = ["mode", "batch_size", "best_ms", "mean_ms",
                  "bytes_in_use_mb", "peak_bytes_in_use_mb", "bytes_limit_mb"]
INFERENCE_WARMUP = 2    # profiling.benchmark's warm-up calls
INFERENCE_DECODE_LAYERS = 4
INFERENCE_FULL_DECODE_LAYERS = 2


def inference_runs(tmp):
    """Phase 46's nine runs of `scripts/inference.py`: (mode, argv, reps,
    the preset's config). MUSE and stage-1 modes at `argoverse_muse` (its
    default, 14 layers at width 1024, 3 cameras), the AR modes at
    `nuscenes_ar`: ar_train at full depth; the cached decodes (bf16 and
    int8) at full width cut to INFERENCE_DECODE_LAYERS layers (phases 14 and
    37 time them at full depth); the uncached decode, which runs a full
    forward for every token, at full width cut to
    INFERENCE_FULL_DECODE_LAYERS layers, as phase 15 runs it. (`tiny_test`,
    whose heads are 32 wide, cannot reach row 9: its kernel takes 64.)"""
    import dataclasses
    from bevgen_torch.core.config import argoverse_muse_config, nuscenes_ar_config
    muse, ar = argoverse_muse_config(), nuscenes_ar_config()

    def cut(cfg, layers):
        return dataclasses.replace(cfg, transformer=cfg.transformer.replace(
            num_layers=layers))
    runs = []
    for mode, b, reps, extra in (
            ("forward", 8, 2, []),
            ("train", 8, 2, ["profile=true", f"trace_dir={tmp}/train"]),
            ("decode", 2, 2, ["profile=true", f"trace_dir={tmp}/decode"]),
            ("stage1_recon", 8, 2, []),
            ("stage1_train", 8, 2, ["profile=true",
                                    f"trace_dir={tmp}/stage1_train"])):
        runs.append((mode, ["preset=argoverse_muse", f"mode={mode}",
                            f"batch_size={b}", f"reps={reps}", *extra],
                     reps, muse))
    runs.append(("ar_train", ["preset=nuscenes_ar", "mode=ar_train",
                              "batch_size=4", "reps=2"], 2, ar))
    for mode, layers in (("ar_decode", INFERENCE_DECODE_LAYERS),
                         ("ar_decode_int8", INFERENCE_DECODE_LAYERS),
                         ("ar_decode_full", INFERENCE_FULL_DECODE_LAYERS)):
        runs.append((mode, ["preset=nuscenes_ar", f"mode={mode}",
                            "batch_size=1", "reps=1",
                            f"transformer.num_layers={layers}"], 1,
                     cut(ar, layers)))
    return runs


def inference_launches_per_call(mode, cfg):
    """The port's kernels' launches per call of each mode: {counter: n}."""
    tf = cfg.transformer
    L, T = tf.num_layers, cfg.muse.sample_iterations
    N = tf.num_img_tokens
    return {
        "forward": {"row1": 2 * L},
        "train": {"row1": 4 * L, "row8": 12 * L},
        "decode": {"row1": (2 * T - 1) * 2 * L},
        "stage1_recon": {}, "stage1_train": {},
        "ar_train": {"row9": L, "row10": 2 * L},
        "ar_decode": {"row11": L * N},
        "ar_decode_int8": {"row11": L * N, "w8": ar_int8_launches(cfg)},
        "ar_decode_full": {"row9": L * N},
    }[mode]


def inference_counts():
    from bevgen_torch.ops import attention_bwd as ab
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.ops import decode_attention as da
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    from bevgen_torch.ops import quant as tq
    counters = {"row1": ca.cosine_attention_cuda,
                "row8": ab.attention_bwd_cuda,
                "row9": bs.block_sparse_attention_cuda,
                "row10": bs.block_sparse_attention_bwd_cuda,
                "row11": da.decode_attention_cuda,
                "row12": fg.residual_layernorm_cuda,
                "row13": fg.geglu_layernorm_cuda,
                "row14": ln.layernorm_cuda,
                "w8": tq.w8_linear_cuda,
                "quantize_static": tq.quantize_static_cuda,
                "quantize_dynamic": tq.quantize_dynamic_cuda,
                "int8_epilogue": tq.int8_epilogue_cuda}
    reset = (ca, ab, bs, da, fg, ln, tq)
    return counters, reset


def trace_summary(path, name):
    """From a Chrome trace of `utils/profiling.trace`: the device events
    (kernels, copies, sets), the device's busy ms (the union of their
    intervals) within the span from the first's start to the last's end,
    device ms by `profile_generate.category`, the count of kernels whose
    name holds `name`, and the kernel launches on the host whose device
    event the trace lacks."""
    from collections import defaultdict
    from bevgen_torch.scripts.profile_generate import busy_us, category
    with open(path) as f:
        trace = json.load(f)["traceEvents"]
    events = [e for e in trace
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    seen = {e.get("args", {}).get("correlation") for e in events}
    unmatched = sum(1 for e in trace if e.get("cat") == "cuda_runtime"
                    and "LaunchKernel" in e.get("name", "")
                    and e.get("args", {}).get("correlation") not in seen)
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in events)
    by_cat = defaultdict(float)
    for e in events:
        by_cat[category(e["name"])] += e.get("dur", 0) / 1e3
    return {"events": len(events), "busy_ms": busy_us(spans) / 1e3,
            "span_ms": (max(e for _, e in spans) - spans[0][0]) / 1e3
            if spans else 0.0,
            "by_category_ms": dict(sorted(by_cat.items(),
                                          key=lambda kv: -kv[1])),
            "named": sum(1 for e in events if e["cat"] == "kernel"
                         and name in e["name"]),
            "launches_without_kernel": unmatched}


def inference_kernel_checks(muse_cfg, ar_cfg):
    """Rows 1, 8, 9, 11 and w8_linear against their plain versions at the
    shapes phase 46's modes give them that no earlier phase checked: row 1
    at `argoverse_muse` b=8 (forward, train) and b=2 (decode), row 8 at b=8
    (train), row 9 at `nuscenes_ar` b=1 (the uncached decode), row 11 at b=1
    over every prefix bucket, w8_linear at the b=1 decode (M=1) and prefill
    (M=256) shapes. Rows 9 and 10 at b=4 (ar_train) are phase 16's."""
    tf, at = muse_cfg.transformer, ar_cfg.transformer
    H, D, N, NC = tf.num_heads, tf.dim_head, tf.num_img_tokens, tf.num_cond_tokens
    out = {"row1": {}, "row8": {}, "row11": {}, "w8": {}}
    for b in (TRAIN_BATCH, 2):
        for shape, m in (("self", N), ("cross", NC)):
            out["row1"][(b, shape)] = check_kernel(
                f"inference {shape} b{b}", b, H, N, m, D, True, None,
                60 + b + (shape == "cross"))
    for shape, m in (("self", N + 1), ("cross", NC + 1)):
        out["row8"][shape] = check_bwd(f"inference train {shape}", TRAIN_BATCH,
                                       H, N, m, D, True, None, 70)
    out["row9"] = check_block_sparse("inference b1", "nuscenes_ar", 1, False, 71)
    L = at.gpt_block_size
    for i, pl in enumerate((512, 1024, 1536, 2048, L)):
        out["row11"][pl] = check_decode(1, at.num_heads, pl, L, 72 + i)
    ad, ahid, pre = at.num_embed, at.hidden_size, at.num_cond_tokens
    for i, (M, n, k) in enumerate((
            (1, 3 * ahid, ad), (1, 4 * ad, ad), (1, ad, 4 * ad),
            (1, at.vocab_size, ad), (pre, ahid, ad), (pre, 4 * ad, ad),
            (pre, ad, 4 * ad))):
        out["w8"][(M, n, k)] = check_w8(f"inference b1 {M}x{n}x{k}", M, n, k,
                                        80 + i)
    return out


def inference_phase(tf32, row1_per_generate):
    """Phase 46: `scripts/inference.py` as a user runs it, through its
    `main`, in each of its nine modes (`inference_runs`), under PyTorch's
    default TF32 flags, after the kernel checks at its shapes
    (`inference_kernel_checks`). Each mode's last line has the JAX script's
    keys, positive times and a peak above 0 and below the card's memory;
    each port kernel is launched exactly its per-call count
    (`inference_launches_per_call`) times the calls (two warm-ups, the
    timed reps, the traced call), and no other; the decode's trace holds
    exactly one generate's row-1 launches, phase 45's count (the train and
    stage1_train traces one call's). Each trace's device time is printed
    by category. Returns the kernel checks and each mode's line and
    launches by shape."""
    import os
    import tempfile
    import torch
    from bevgen_torch.core.config import argoverse_muse_config, nuscenes_ar_config
    from bevgen_torch.scripts import inference
    card = gpu_name_and_power()
    checks = inference_kernel_checks(argoverse_muse_config(),
                                     nuscenes_ar_config())
    counters, reset = inference_counts()
    res = {"checks": checks, "modes": {}}
    with tempfile.TemporaryDirectory() as tmp, tf32_flags(*tf32):
        for mode, argv, reps, cfg in inference_runs(tmp):
            profiled = "profile=true" in argv
            calls = INFERENCE_WARMUP + reps + profiled
            for mod in reset:
                mod.reset_launch_counts()
            t0 = time.perf_counter()
            _, lines = run_cli(inference.main, argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = {k: c.launches for k, c in counters.items() if c.launches}
            shapes = {k: dict(getattr(c, "launches_by_shape", {}))
                      for k, c in counters.items() if c.launches}
            want = {k: n * calls for k, n in
                    inference_launches_per_call(mode, cfg).items()}
            line = json.loads(lines[-1])
            keys = INFERENCE_KEYS + (["trace"] if profiled else [])
            print(f"[inference] {mode} b={line['batch_size']} ({' '.join(argv)}): "
                  f"best_ms {line['best_ms']} mean_ms {line['mean_ms']} peak "
                  f"{line['peak_bytes_in_use_mb']} MB of "
                  f"{line['bytes_limit_mb']} MB; {calls} calls in {wall:.1f} s; "
                  f"launches {got} (expected {want}); {card}", flush=True)
            if list(line) != keys or line["mode"] != mode:
                raise SystemExit(f"inference {mode}: keys {list(line)}, "
                                 f"expected {keys}")
            if not (0 < line["best_ms"] <= line["mean_ms"]
                    and 0 < line["peak_bytes_in_use_mb"]
                    < line["bytes_limit_mb"]):
                raise SystemExit(f"inference {mode}: times or peak out of "
                                 f"range: {line}")
            if got != want:
                raise SystemExit(f"inference {mode}: launches {got}, "
                                 f"expected {want}")
            if profiled:
                path = os.path.join(line["trace"], "trace.json")
                summary = trace_summary(path, "attention_fwd_kernel")
                print(f"[inference] {mode} trace of one call "
                      f"({os.path.getsize(path) / 1e6:.1f} MB): "
                      f"{summary['events']} device events, busy "
                      f"{summary['busy_ms']:.2f} ms of a "
                      f"{summary['span_ms']:.2f} ms span; by category "
                      + ", ".join(f"{k} {v:.2f}" for k, v in
                                  summary["by_category_ms"].items())
                      + f"; row-1 kernel events {summary['named']}; host "
                      f"launches without a device event "
                      f"{summary['launches_without_kernel']}", flush=True)
                per_call = want.get("row1", 0) // calls
                if summary["named"] != per_call:
                    raise SystemExit(f"inference {mode}: the trace holds "
                                     f"{summary['named']} row-1 launches, "
                                     f"one call makes {per_call}")
                if mode == "decode" and per_call != row1_per_generate:
                    raise SystemExit(f"inference decode: {per_call} row-1 "
                                     f"launches a generate, phase 45's "
                                     f"generate {row1_per_generate}")
            res["modes"][mode] = {"line": line, "shapes": shapes, "cfg": cfg,
                                  "wall_s": wall}
            torch.cuda.empty_cache()
    return res


def inference_kernel_entries(res, bsb_stats):
    """The kernels line's `[inference <mode>]` entries: each kernel at each
    shape phase 46 launched it, with that mode's launches and the kernel
    check at that shape (phase 46's, or phase 16's for ar_train)."""
    from bevgen_torch.ops import attention_bwd as ab
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import cosine_attention as ca
    from bevgen_torch.ops import decode_attention as da
    from bevgen_torch.ops import quant as tq
    checks, out = res["checks"], []
    for mode, run in res["modes"].items():
        first = len(out)
        tf, shapes = run["cfg"].transformer, run["shapes"]
        b = run["line"]["batch_size"]
        N, NC = tf.num_img_tokens, tf.num_cond_tokens
        if "row1" in shapes:
            for shape, m in (("self", N), ("cross", NC)):
                out.append({
                    "name": f"cosine_attention_fwd[inference {mode} {shape} "
                            f"b{b} {N}x{m}]",
                    "route": "cuda", "source": ca.SOURCE,
                    "replaces": ca.REPLACES,
                    "launches": shapes["row1"].get((N, m), 0),
                    **checks["row1"][(b, shape)]})
        if "row8" in shapes:
            for shape, m in (("self", N + 1), ("cross", NC + 1)):
                out.append({
                    "name": f"attention_bwd[inference {mode} {shape} b{b} "
                            f"{N}x{m}, 3 kernels]",
                    "route": "cuda", "source": ab.SOURCE,
                    "replaces": ab.REPLACES,
                    "launches": shapes["row8"].get((N, m), 0),
                    **checks["row8"][shape]})
        key = (tf.gpt_block_size, tf.sparse_block_size)
        if "row9" in shapes:
            out.append({
                "name": f"block_sparse_fwd[inference {mode} b{b} L{key[0]} "
                        f"block {key[1]}"
                        f"{', with lse' if mode == 'ar_train' else ''}]",
                "route": "cuda", "source": bs.SOURCE, "replaces": bs.REPLACES,
                "launches": shapes["row9"].get(key, 0),
                **(bsb_stats["fwd+lse"] if mode == "ar_train"
                   else checks["row9"])})
        if "row10" in shapes:
            out.append({
                "name": f"block_sparse_bwd[inference {mode} b{b} L{key[0]} "
                        f"block {key[1]}, 2 kernels]",
                "route": "cuda", "source": bs.BWD_SOURCE,
                "replaces": bs.BWD_REPLACES,
                "launches": sum(shapes["row10"].values()),
                **bsb_stats["nuscenes_ar"]})
        for pl, n in sorted(shapes.get("row11", {}).items()):
            out.append({
                "name": f"decode_attention[inference {mode} b{b} "
                        f"H{tf.num_heads} pl{pl}]",
                "route": "cuda", "source": da.SOURCE, "replaces": da.REPLACES,
                "launches": n, **checks["row11"][pl]})
        for (M, n, k), count in sorted(shapes.get("w8", {}).items()):
            out.append({
                "name": f"w8_linear[inference {mode} b{b} {M}x{n}x{k}]",
                "route": "cuda", "source": tq.SOURCE,
                "replaces": tq.W8_LINEAR_REPLACES, "launches": count,
                **checks["w8"][(M, n, k)]})
        listed = sum(e["launches"] for e in out[first:])
        launched = sum(sum(v.values()) for v in shapes.values())
        if listed != launched:
            raise SystemExit(f"inference {mode}: {launched} launches, "
                             f"{listed} of them at the listed shapes: "
                             f"{shapes}")
    return out


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
    from bevgen_torch.ops import fused_glue as fg
    from bevgen_torch.ops import layernorm as ln
    from bevgen_torch.pipelines.generate import BEVGenPipeline

    # PyTorch's TF32 defaults, under which the stage-1 trainer runs (it
    # leaves the flags as it finds them): phases 39-40 time it so
    tf32_defaults = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
    # fp32 references stay fp32 (no TF32 in matmuls or convolutions)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    t_start = t_phase = time.perf_counter()
    card = gpu_name_and_power()
    print(f"[device] {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # 2. build (every source, one nvcc each, started together)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, path in libs.items():
        log = path.with_name(path.name + ".log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line or "arning" in line:
                print(f"[build] {name}: {line.strip()}")
    t_phase = phase_time("1-2", t_phase)

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
    # the forward's resources; q, k, v as the transformer's head-transposed
    # views (out read through its view); bias rows off 16 bytes (M = 257)
    # with a partial last tile and a dropped sample; D = 32
    attention_fwd_resources(cosine=True)
    check_kernel("self strided", B, H, N, N, D, True, None, 6, strided=True)
    check_kernel("cross strided", B, H, N, NC, D, True, None, 7, strided=True)
    check_kernel("M=257 partial+keep", 2, H, 300, 257, D, True, [1, 0], 8)
    check_kernel("D=32 strided+keep", 2, 8, 300, 200, 32, True, [0, 1], 9,
                 strided=True)
    check_kernel("D=32 no-bias", 1, 3, 130, 64, 32, False, None, 13)
    t_phase = phase_time(3, t_phase)

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
    fg.reset_launch_counts()
    ln.reset_launch_counts()
    t0 = time.perf_counter()
    images, ids = generate(1)
    torch.cuda.synchronize()
    gen_s = [time.perf_counter() - t0]
    launches = ca.cosine_attention_cuda.launches
    by_shape = dict(ca.cosine_attention_cuda.launches_by_shape)
    glue_off = (fg.residual_layernorm_cuda.launches,
                fg.geglu_layernorm_cuda.launches, ln.layernorm_cuda.launches)
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
          f"run {launches} {by_shape}, glue kernels {glue_off}", flush=True)
    steps = cfg.muse.sample_iterations
    expect = (steps + steps - 1) * tf.num_layers * 2
    if launches != expect:
        raise SystemExit(f"expected {expect} kernel launches, got {launches}")
    if glue_off != (0, 0, 0):
        raise SystemExit(f"glue kernels launched with use_fused_glue off: "
                         f"{glue_off}")
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
    t_phase = phase_time(4, t_phase)

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

    del pipe, images, ids, cache, lk, lp
    torch.cuda.empty_cache()
    t_phase = phase_time(5, t_phase)

    # 6. the training kernels against their plain versions
    TB = TRAIN_BATCH
    train_fwd_stats = {
        "self": check_kernel("train self", TB, H, N, N, D, True, None, 4),
        "cross": check_kernel("train cross", TB, H, N, NC, D, True, None, 5),
    }
    for d in (64, 32):  # the backward kernels' resources
        attention_bwd_resources(d)
    bwd_stats = {}
    for name, (n, m, bias, keep, b) in {
            "self": (N, N + 1, True, None, TB), "cross": (N, NC + 1, True, None, TB),
            "unaligned+keep": (96, 70, True, [1, 0], 2),
            "no-bias": (200, 130, False, None, 2)}.items():
        bwd_stats[name] = check_bwd(name, b, H if b == TB else 4, n, m, D,
                                    bias, keep, 10)
        fstat = check_bias_fwd(name, b, H if b == TB else 4, n, m, D, bias,
                               keep, 10)
        if name == "self":
            row7_stats = fstat
    attention_fwd_resources(cosine=False)
    check_bias_fwd("strided M=1793 partial", 2, H, 300, N + 1, D, True, None,
                   14, strided=True)
    check_bias_fwd("strided M=257+keep", 2, 4, 200, NC + 1, D, True, [1, 0],
                   15, strided=True)
    check_bias_fwd("D=32", 2, 4, 130, 33, 32, True, [0, 1], 16)
    # row 8 on head-transposed qf, kf, vc and dO: self and cross at b=8, the
    # unaligned case with a dropped sample, and D = 32
    check_bwd("self strided", TB, H, N, N + 1, D, True, None, 17, strided=True)
    check_bwd("cross strided", TB, H, N, NC + 1, D, True, None, 18,
              strided=True)
    check_bwd("strided unaligned+keep", 2, 4, 96, 70, D, True, [1, 0], 19,
              strided=True)
    check_bwd("D=32 strided+keep", 2, 4, 130, 33, 32, True, [0, 1], 20,
              strided=True)
    row7_shapes(TB, H, N, D)
    # the bias_attention op entry, forward and backward, once
    from bevgen_torch.ops import attention_bwd as ab
    from bevgen_torch.ops import bias_attention as ba
    qf, kf, vc, biasp, _, do = bwd_inputs(TB, H, N, N + 1, D, True, None, 12)
    leaves = [t.requires_grad_() for t in (qf, kf, vc, biasp)]
    ba.reset_launch_counts()
    ab.reset_launch_counts()
    torch.autograd.grad(ba.bias_attention(*leaves, sm_scale=8.0), leaves, do)
    torch.cuda.synchronize()
    row7_launches = ba.bias_attention_cuda.launches
    print(f"[kernel] bias_attention op entry, self b={TB}, forward and "
          f"backward: {row7_launches} forward and "
          f"{ab.attention_bwd_cuda.launches} backward kernel launches",
          flush=True)
    if row7_launches != 1 or ab.attention_bwd_cuda.launches != 3:
        raise SystemExit("the bias_attention op did not run its kernels")
    del qf, kf, vc, biasp, do, leaves
    t_phase = phase_time(6, t_phase)

    # 7. the cosine attention's autograd Function at full width
    check_function_grads(B, H, N, D)
    phase_time(7, t_phase)

    # 8-10. training end to end
    model, train = timed_phase(8, train_phase, cfg)
    timed_phase(9, model_grads_phase, model, cfg)
    timed_phase(10, ce_falls_phase, model, cfg)
    del model
    torch.cuda.empty_cache()

    # 11-15. the AR path: its kernels against their plain versions, then
    # the path at full width
    from bevgen_torch.core.config import nuscenes_ar_config
    from bevgen_torch.ops import block_sparse as bs
    from bevgen_torch.ops import decode_attention as da
    ar_cfg = nuscenes_ar_config()
    L_ar = ar_cfg.transformer.gpt_block_size
    bs_stats = timed_phase(11, block_sparse_phase)
    dec_stats = timed_phase(12, decode_phase, ar_cfg)
    bs_launches = timed_phase(13, ar_forward_phase, ar_cfg)
    ar_e2e = timed_phase(14, ar_generate_phase, ar_cfg)
    # row 11 over one generate: each bucket's phase-12 times weighted by its
    # phase-14 launches
    dec_ms = sum(n * dec_stats[pl]["ms"] for pl, n in ar_e2e["by_pl"].items())
    dec_lib = sum(n * dec_stats[pl]["library_ms"]
                  for pl, n in ar_e2e["by_pl"].items())
    print(f"[kernel] decode_attention over one b={AR_BATCH} generate's "
          f"{sum(ar_e2e['by_pl'].values())} launches: kernel {dec_ms:.1f} ms, "
          f"library {dec_lib:.1f} ms, ms/library_ms {dec_ms / dec_lib:.3f}",
          flush=True)
    timed_phase(15, ar_greedy_phase, ar_cfg)

    # 16-20. AR training: the backward kernels against their plain version,
    # the autograd Function, then the train step at full width
    bsb_stats = timed_phase(16, block_sparse_bwd_phase)
    timed_phase(17, ar_function_grads_phase, ar_cfg)
    model, ar_train = timed_phase(18, ar_train_phase, ar_cfg)
    timed_phase(19, ar_model_grads_phase, ar_cfg)
    timed_phase(20, ar_ce_falls_phase, model, ar_cfg)
    del model

    # 21-25. the glue kernels against their twins, then the MUSE path with
    # use_fused_glue on: generate (in turns with it off), one forward,
    # training; and the standalone LayerNorm through LayerNormG
    glue_stats = timed_phase(21, glue_kernels_phase, cfg)
    plain_pipe, glue_pipe = glue_pipelines(cfg)
    glue_e2e = timed_phase(22, glue_generate_phase, cfg, plain_pipe, glue_pipe,
                           med)
    timed_phase(23, glue_forward_phase, cfg, plain_pipe, glue_pipe)
    del plain_pipe, glue_pipe
    glue_cfg = dataclasses.replace(cfg, transformer=tf.replace(
        use_fused_glue=True))
    model, glue_train = timed_phase(24, train_phase, glue_cfg)
    del model
    timed_phase(24, glue_grads_phase, cfg)
    row14_launches = timed_phase(25, layernorm_g_phase, cfg)

    # 26. the reference's torch checkpoints: the MUSE generate CLI and the AR
    # model fed from reference-format files
    timed_phase(26, checkpoint_phase, cfg, ar_cfg)

    # 27-30. the MUSE model variants: real classifier-free guidance, the
    # TokenCritic, self-conditioning and the trajectory, the variant train
    # step
    cfg_res = timed_phase(27, real_cfg_phase, cfg)
    timed_phase(28, token_critic_phase, cfg)
    timed_phase(29, self_cond_phase, cfg)
    variant_train = timed_phase(30, variant_train_phase, cfg)

    # 31-34. image encode, the partial decode through the CLI, the rect
    # preset, tokenize then train from the shards
    timed_phase(31, encode_phase, cfg)
    partial = timed_phase(32, partial_decode_phase, cfg)
    rect = timed_phase(33, rect_phase)
    tok_train = timed_phase(34, tokenize_train_phase, cfg)

    # 35-38. int8 serving: the int8 kernels against their plain versions,
    # the MUSE and the AR int8 generates, the generate CLI's quant=
    int8_stats = timed_phase(35, int8_kernels_phase, cfg, ar_cfg)
    int8_muse = timed_phase(36, int8_muse_phase, cfg)
    int8_ar = timed_phase(37, int8_ar_phase, ar_cfg, ar_e2e)
    timed_phase(38, int8_cli_phase, cfg, ar_cfg)

    # 39-42. stage-1 training: the VQ-GAN and VQ-VAE steps at full width,
    # the card against the CPU, the CLI; the LPIPS weights as an npz in
    # TMPDIR
    import os
    import tempfile
    from bevgen_torch.core.config import argoverse_muse_config
    s1 = argoverse_muse_config()
    with tempfile.TemporaryDirectory() as tmp:
        npz = write_lpips_npz(os.path.join(tmp, "lpips.npz"))
        timed_phase(39, vqgan_phase, s1.first_stage, s1.base_lr, npz,
                    tf32_defaults)
        timed_phase(40, vqvae_phase, s1.cond_stage, s1.base_lr, tf32_defaults)
        timed_phase(41, card_cpu_phase, npz)
        timed_phase(42, stage1_cli_phase, npz, tmp)
        # 43-45. the evaluation path: InceptionV3 and LoFTR at full width,
        # then metrics_eval's evaluate on two generates
        inception_npz = timed_phase(43, inception_phase, tmp, tf32_defaults)
        loftr_params = timed_phase(44, loftr_phase, tf32_defaults)
        metrics_launches = timed_phase(45, metrics_e2e_phase, cfg, npz,
                                       inception_npz, loftr_params,
                                       tf32_defaults)

    # 46. the benchmark-and-trace CLI, all nine modes
    inference_res = timed_phase(46, inference_phase, tf32_defaults,
                                sum(metrics_launches.values()))

    kernels = []
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[{shape} {n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": by_shape.get((n, m), 0), **stats[shape]})
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[train {shape} b{TB} {n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": train["fwd"].get((n, m), 0), **train_fwd_stats[shape]})
    for shape, (n, m) in (("self", (N, N + 1)), ("cross", (N, NC + 1))):
        kernels.append({
            "name": f"attention_bwd[train {shape} b{TB} {n}x{m}, 3 kernels]",
            "route": "cuda", "source": ab.SOURCE, "replaces": ab.REPLACES,
            "launches": train["bwd"].get((n, m), 0), **bwd_stats[shape]})
    # the variants' paths at the shapes above: the guided b=4 serving
    # forwards (phase 27's own checks), and the TokenCritic + self_cond b=8
    # train step (phase 6's checks at the same shapes)
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[real_cfg serve {shape} b4 {n}x{m}"
                    f"{' keep 1100' if shape == 'cross' else ''}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": cfg_res["e2e"]["calls"].get((4, n, m), 0),
            **cfg_res["kernels"][shape]})
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[token_critic+self_cond train "
                    f"{shape} b{TB} {n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": variant_train["fwd"].get((n, m), 0),
            **train_fwd_stats[shape]})
    for shape, (n, m) in (("self", (N, N + 1)), ("cross", (N, NC + 1))):
        kernels.append({
            "name": f"attention_bwd[token_critic+self_cond train {shape} "
                    f"b{TB} {n}x{m}, 3 kernels]",
            "route": "cuda", "source": ab.SOURCE, "replaces": ab.REPLACES,
            "launches": variant_train["bwd"].get((n, m), 0),
            **bwd_stats[shape]})
    # the partial decode (phase 32) runs row 1 at phase 3's shapes; the
    # rect preset (phase 33) at its own; the tokenized-shard train step
    # (phase 34) at phase 6's
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[partial decode serve {shape} b2 "
                    f"{n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": partial["by_shape"].get((n, m), 0), **stats[shape]})
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[metrics generate serve {shape} b2 "
                    f"{n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": metrics_launches.get((n, m), 0), **stats[shape]})
    for shape, (n, m) in (("self", (rect["N"], rect["N"])),
                          ("cross", (rect["N"], rect["NC"]))):
        kernels.append({
            "name": f"cosine_attention_fwd[rect serve {shape} b2 {n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": rect["e2e"]["calls"].get((2, n, m), 0),
            **rect["kernels"][shape]})
    for shape, (n, m) in (("self", (N, N)), ("cross", (N, NC))):
        kernels.append({
            "name": f"cosine_attention_fwd[tokenized-shard train {shape} "
                    f"b{TB} {n}x{m}]",
            "route": "cuda", "source": ca.SOURCE, "replaces": ca.REPLACES,
            "launches": tok_train["fwd"].get((n, m), 0),
            **train_fwd_stats[shape]})
    for shape, (n, m) in (("self", (N, N + 1)), ("cross", (N, NC + 1))):
        kernels.append({
            "name": f"attention_bwd[tokenized-shard train {shape} b{TB} "
                    f"{n}x{m}, 3 kernels]",
            "route": "cuda", "source": ab.SOURCE, "replaces": ab.REPLACES,
            "launches": tok_train["bwd"].get((n, m), 0), **bwd_stats[shape]})
    kernels.append({
        "name": f"bias_attention_fwd[op entry, self b{TB} {N}x{N + 1}]",
        "route": "cuda", "source": ba.SOURCE, "replaces": ba.REPLACES,
        "launches": row7_launches, **row7_stats})
    tf_ar = ar_cfg.transformer
    kernels.append({
        "name": f"block_sparse_fwd[nuscenes_ar b{AR_BATCH} L{L_ar} block "
                f"{tf_ar.sparse_block_size}]",
        "route": "cuda", "source": bs.SOURCE, "replaces": bs.REPLACES,
        "launches": bs_launches.get((L_ar, tf_ar.sparse_block_size), 0),
        **bs_stats["nuscenes_ar"]})
    TAB = AR_TRAIN_BATCH
    kernels.append({
        "name": f"block_sparse_fwd[train nuscenes_ar b{TAB} L{L_ar} block "
                f"{tf_ar.sparse_block_size}, with lse]",
        "route": "cuda", "source": bs.SOURCE, "replaces": bs.REPLACES,
        "launches": ar_train["fwd"].get((L_ar, tf_ar.sparse_block_size), 0),
        **bsb_stats["fwd+lse"]})
    # the nuscenes_ar_tpu and biased checks of phase 16 run no path: they
    # stay in their printed lines, as the forward's do
    kernels.append({
        "name": f"block_sparse_bwd[train nuscenes_ar b{TAB} L{L_ar} block "
                f"{tf_ar.sparse_block_size}, 2 kernels]",
        "route": "cuda", "source": bs.BWD_SOURCE, "replaces": bs.BWD_REPLACES,
        "launches": ar_train["bwd"].get(
            (L_ar, tf_ar.sparse_block_size, False), 0),
        **bsb_stats["nuscenes_ar"]})
    for pl, st in dec_stats.items():
        kernels.append({
            "name": f"decode_attention[b{AR_BATCH} H{tf_ar.num_heads} pl{pl}]",
            "route": "cuda", "source": da.SOURCE, "replaces": da.REPLACES,
            "launches": ar_e2e["by_pl"].get(pl, 0), **st})
    inner = int(tf.num_embed * tf.ff_mult * 2 / 3)
    for kind, src, rep, width in (
            ("residual", fg.SOURCE, fg.RES_LN_REPLACES, tf.num_embed),
            ("geglu", fg.SOURCE, fg.GEGLU_LN_REPLACES, inner)):
        op = {"residual": "residual_layernorm", "geglu": "geglu_layernorm"}[kind]
        for b, run, count in ((2, "serve", glue_e2e), (TB, "train", glue_train)):
            kernels.append({
                "name": f"{op}[{run} b{b} {b * N}x{width}]", "route": "cuda",
                "source": src, "replaces": rep,
                "launches": count[f"{kind}_ln"], **glue_stats[(kind, b)]})
    row14 = dict(glue_stats[("layernorm", 2)])
    kernels.append({
        "name": f"layernorm[LayerNormG use_fused, 2x{N}x{tf.num_embed}, "
                f"{row14.pop('variant')} form]",
        "route": "cuda", "source": ln.SOURCE, "replaces": ln.REPLACES,
        "launches": row14_launches, **row14})
    kernels.extend(int8_kernel_entries(cfg, ar_cfg, int8_stats, int8_muse,
                                       int8_ar, stats, dec_stats, glue_stats))
    kernels.extend(inference_kernel_entries(inference_res, bsb_stats))
    print(f"[time] phases 1-46: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
