"""KV-cached incremental decoding for the AR sparse GPT.

Port of `bevgen_tpu/models/stage2/ar_cached.py` (the `unrolled` decode):
prefill the BEV-condition positions once, then each step runs ONE sequence
position through all layers against cached K/V, where the full-forward
sampler (`ar.ar_sample`) runs all L positions per token. It works on the
`SparseGPT` module's own parameters; `teacher_forced_logits` equals the full
forward's logits (tests/test_torch_ar.py holds it to the JAX bound).

A position s attends the columns <= s that its head's block-layout row
allows: the row mask is built per step from the layout and the index, and
folded with the camera bias into one (H, pl) addend shared by the layers.
Each layer's attention is `ops.decode_attention.decode_attention`: the CUDA
kernel for CUDA tensors, the plain version on the CPU. The steps are
chunked by `bucket_ranges` so a step reads only a prefix of the cache
(`PREFIX_BUCKET` columns at a time), as the reference does.

The caches are per-layer (b, H, L, dh) tensors in the compute dtype; the
step writes position s into them IN PLACE (where the reference's
functional update makes a new array). The query/key/value weights are
fused into one product per layer once per generate (`fuse_qkv`).

The int8 tree (`cfg.quant == "int8"`, `ops.quant.quantize_gpt_tree`) runs
every product, the prefill's, the decode steps' and the head's, through the
weight-only int8 product (`ops.quant.w8_linear`: the `w8_linear` kernel on
the card); `fuse_qkv` concatenates kernel_q, scale and bias along the output
axis, as the reference's `_fuse_qkv_per_layer` does (under tp the rank's
kernel_q rows, scale and bias parts: q, k and v are column-split).

Under tensor parallelism (`parallel/tensor.py`) each rank holds its heads'
K/V caches and weights: the fused q|k|v product is built from its q, k and
v slices, the decode kernel runs at b x heads / tp, and the heads' outputs
and the logits are gathered (`SparseGPTBlock.merge_heads`,
`SparseGPT.logits`), so every rank samples the same token.

Not ported: the `stacked` decode variant (one scan over stacked weights,
env `BEVGEN_AR_DECODE`) and the bucket width's env `BEVGEN_AR_PREFIX_BUCKET`,
departures recorded in `ROADMAP.md` §3.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from bevgen_torch.models.stage2.ar import decode_positions, sample_logits
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.ops.decode_attention import NEG_INF, decode_attention
from bevgen_torch.ops.quant import Int8WeightDense
from bevgen_torch.parallel.sharding import BatchShard
from bevgen_torch.parallel.tensor import copy_to_tp

PREFIX_BUCKET = 512


class ARStatic(NamedTuple):
    """Token-independent per-run tensors."""
    cond_emb: torch.Tensor            # (b, nc, d) condition embeddings
    pos_ray: torch.Tensor             # (b, N, d) raw-order ray + position
    layouts: torch.Tensor             # (H, nb, nb) bool
    bias_rows: Optional[torch.Tensor]  # (L, L) fp32 additive bias or None


class FusedBlock(NamedTuple):
    """One layer with its q/k/v products fused into one."""
    block: torch.nn.Module            # the SparseGPTBlock (norms, MLP)
    qkv: Callable                     # (..., d) -> (..., 3 * hidden)


def precompute_static(model: SparseGPT, bev_indices, intrinsics_inv,
                      extrinsics_inv) -> ARStatic:
    """The embeddings that do not depend on decoded tokens."""
    cfg, dt = model.cfg, model.dtype
    b = bev_indices.shape[0]
    ray, c_embed = model.ray_embedding(intrinsics_inv, extrinsics_inv)
    pos = model.x_pos_emb.to(dt)[:, :cfg.num_img_tokens]
    pos_ray = pos if ray is None else ray.reshape(
        b, cfg.num_img_tokens, -1).to(dt) + pos
    cond = model.cond_embedding(bev_indices, c_embed)
    layouts = torch.from_numpy(model.attn.layout > 0).to(cond.device)
    return ARStatic(cond_emb=cond, pos_ray=pos_ray.expand(b, -1, -1),
                    layouts=layouts, bias_rows=model.camera_bias())


def fuse_qkv(model: SparseGPT) -> List[FusedBlock]:
    """Per-layer q/k/v weights concatenated into one product (independent
    output columns, so the same results): a Linear in the compute dtype, or
    for the int8 tree kernel_q, scale and bias concatenated along the output
    axis and run by `w8_linear` (the same route as the layers')."""
    dt = model.dtype
    out = []
    for blk in model.blocks():
        projs = (blk.query, blk.key, blk.value)
        # this rank's outputs under tp
        bias = torch.cat([p.local_bias() for p in projs])
        if isinstance(blk.query, Int8WeightDense):
            w_q = torch.cat([p.kernel_q for p in projs])
            scale = torch.cat([p.scale for p in projs])
            route = blk.query.route
            qkv = (lambda x, w_q=w_q, scale=scale, bias=bias, route=route:
                   route(x, w_q, scale, bias))
        else:
            w = torch.cat([p.weight for p in projs]).to(dt)
            qkv = (lambda x, w=w, bias=bias: F.linear(x, w, bias))
        out.append(FusedBlock(blk, qkv))
    return out


def prefill(model: SparseGPT, static: ARStatic
            ) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Run the nc condition positions: per-layer K/V caches (b, H, L, dh)
    holding them, and the fp32 logits predicting decode step 0. The masked
    attention over the condition rows is plain PyTorch, as the reference
    computes it outside any kernel."""
    cfg, dt = model.cfg, model.dtype
    b, nc, _ = static.cond_emb.shape
    L, H = cfg.gpt_block_size, model.blocks()[0].local_heads
    dh = cfg.hidden_size // cfg.num_heads
    block = cfg.sparse_block_size
    scale = 1.0 / math.sqrt(dh)
    nbc = -(-nc // block)
    sub = static.layouts[:, :nbc, :nbc]
    mask_cc = sub.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :nc, :nc]
    bias_cc = static.bias_rows[:nc, :nc] if static.bias_rows is not None else 0.0

    x = static.cond_emb
    k_cache, v_cache = [], []
    for blk in model.blocks():
        xn = blk.ln1(x, dt)
        q, k, v = blk.qkv(xn)
        s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
        s = torch.where(mask_cc[None], (s + bias_cc) * scale,
                        torch.full((), NEG_INF, device=s.device))
        probs = torch.softmax(s, dim=-1)
        attn = torch.einsum("bhij,bhjd->bhid", probs, v.float()).to(dt)
        x = xn + blk.merge_heads(attn)
        x = x + blk.mlp(x)
        kc = torch.zeros(b, H, L, dh, dtype=dt, device=x.device)
        vc = torch.zeros_like(kc)
        kc[:, :, :nc] = k
        vc[:, :, :nc] = v
        k_cache.append(kc)
        v_cache.append(vc)
    logits0 = model.logits(x[:, -1])
    return k_cache, v_cache, logits0.float()


def step_addend(model: SparseGPT, static: ARStatic, s: int, pl: int
                ) -> torch.Tensor:
    """(H, pl) fp32: bias * scale where position s may attend (its head's
    layout row and col <= s), -1e9 elsewhere."""
    cfg = model.cfg
    dh = cfg.hidden_size // cfg.num_heads
    scale = 1.0 / math.sqrt(dh)
    block = cfg.sparse_block_size
    rows = static.layouts[:, s // block]                       # (H, nb)
    lay = rows.repeat_interleave(block, dim=1)[:, :pl]         # (H, pl)
    col = torch.arange(pl, device=lay.device)
    mask = lay & (col <= s)[None]
    bias = (0.0 if static.bias_rows is None
            else static.bias_rows[s, :pl] * scale)
    return torch.where(mask, bias,
                       torch.full((), NEG_INF, device=lay.device)).float()


def decode_step_unrolled(model: SparseGPT, static: ARStatic,
                         blocks: List[FusedBlock], k_cache, v_cache, s: int,
                         x_s: torch.Tensor, prefix: Optional[int] = None
                         ) -> torch.Tensor:
    """Sequence position s through every layer: writes its K/V into the
    caches at s (in place) and returns the fp32 logits (b, vocab) that
    predict the next token. x_s: (b, d) input embedding; `prefix` (>= s+1)
    is the cache width the attention reads."""
    cfg, dt = model.cfg, model.dtype
    H = blocks[0].block.local_heads
    dh = cfg.hidden_size // cfg.num_heads
    b = x_s.shape[0]
    pl = cfg.gpt_block_size if prefix is None else prefix
    scale = 1.0 / math.sqrt(dh)
    addend = step_addend(model, static, s, pl)
    x = x_s[:, None, :]
    for fb, kc, vc in zip(blocks, k_cache, v_cache):
        blk = fb.block
        xn = blk.ln1(x, dt)
        qkv = fb.qkv(copy_to_tp(xn[:, 0], model.mesh))         # (b, 3*hidden)
        q, k, v = qkv.reshape(b, 3, H, dh).unbind(1)
        kc[:, :, s] = k
        vc[:, :, s] = v
        attn = decode_attention(q.contiguous(), kc[:, :, :pl], vc[:, :, :pl],
                                addend, scale)
        x = xn + blk.merge_heads(attn.reshape(b, H, 1, dh))
        x = x + blk.mlp(x)
    return model.logits(x[:, 0]).float()


def bucket_ranges(L: int, nc: int, N: int, bucket: int):
    """Chunk the decode steps t in [0, N) by the cache-prefix width their
    positions s = nc + t need: [(t0, t1, pl)] where every step in [t0, t1)
    attends only columns < pl, the bucket boundary above its s."""
    out = []
    t = 0
    while t < N:
        c = (nc + t) // bucket
        pl = min((c + 1) * bucket, L)
        t1 = min(N, (c + 1) * bucket - nc)
        out.append((t, t1, pl))
        t = t1
    return out


def token_embedding(model: SparseGPT, static: ARStatic, token, raw_pos: int):
    """Input embedding (b, d) of `token` (b,) at raw position raw_pos."""
    return model.x_tok_emb(token) + static.pos_ray[:, raw_pos]


def _steps(model: SparseGPT):
    """(t, pl) of every decode step, in order."""
    cfg = model.cfg
    for t0, t1, pl in bucket_ranges(cfg.gpt_block_size, cfg.num_cond_tokens,
                                    cfg.num_img_tokens, PREFIX_BUCKET):
        for t in range(t0, t1):
            yield t, pl


@torch.inference_mode()
def ar_sample_cached(model: SparseGPT, bev_indices, intrinsics_inv,
                     extrinsics_inv, generator: Optional[torch.Generator] = None,
                     temperature: float = 1.0, top_k: Optional[int] = None,
                     init_ids: Optional[torch.Tensor] = None,
                     shard: Optional[BatchShard] = None) -> torch.Tensor:
    """The same tokens as `ar.ar_sample` (same arguments) from one position
    per step. Returns (b, cam, h, w) int64."""
    cfg = model.cfg
    b = bev_indices.shape[0]
    cam, hw = cfg.num_cams, cfg.num_cam_tokens
    nc = cfg.num_cond_tokens
    dev = bev_indices.device
    static = precompute_static(model, bev_indices, intrinsics_inv,
                               extrinsics_inv)
    k_cache, v_cache, logits = prefill(model, static)
    blocks = fuse_qkv(model)
    if init_ids is None:
        ids = torch.full((b, cam, hw), cfg.vocab_size, dtype=torch.long,
                         device=dev)
        keep = None
    else:
        ids = torch.as_tensor(init_ids, device=dev).long().reshape(b, cam, hw).clone()
        keep = ids != cfg.vocab_size
    positions = decode_positions(model)
    for t, pl in _steps(model):
        c_i, p_i, raw = positions[t]
        tok = sample_logits(logits, generator, temperature, top_k, shard)
        if keep is not None:
            tok = torch.where(keep[:, c_i, p_i], ids[:, c_i, p_i], tok)
        ids[:, c_i, p_i] = tok
        x_s = token_embedding(model, static, tok, raw)
        logits = decode_step_unrolled(model, static, blocks, k_cache, v_cache,
                                      nc + t, x_s, pl)
    h, w = cfg.cam_latent_res
    return ids.reshape(b, cam, h, w)


@torch.inference_mode()
def teacher_forced_logits(model: SparseGPT, tokens, bev_indices,
                          intrinsics_inv, extrinsics_inv) -> torch.Tensor:
    """Cached-path logits for every decode step given ground-truth tokens
    (b, cam, hw): (b, N, vocab) fp32 in raw order, to compare with the
    full forward."""
    cfg = model.cfg
    b = tokens.shape[0]
    nc = cfg.num_cond_tokens
    static = precompute_static(model, bev_indices, intrinsics_inv,
                               extrinsics_inv)
    k_cache, v_cache, logits = prefill(model, static)
    blocks = fuse_qkv(model)
    flat = tokens.reshape(b, -1)
    positions = decode_positions(model)
    out = torch.zeros(b, cfg.num_img_tokens, cfg.vocab_size,
                      device=logits.device)
    for t, pl in _steps(model):
        raw = positions[t][2]
        out[:, raw] = logits
        x_s = token_embedding(model, static, flat[:, raw], raw)
        logits = decode_step_unrolled(model, static, blocks, k_cache, v_cache,
                                      nc + t, x_s, pl)
    return out
