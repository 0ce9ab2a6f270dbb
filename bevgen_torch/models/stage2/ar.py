"""Autoregressive sampling and the training objective of the sparse GPT.

Port of `bevgen_tpu/models/stage2/ar.py`: `top_k_logits`, `ar_sample` (the
reference-parity sampler, which decodes the camera tokens one at a time in
the outward decode order and runs the whole L-position forward for each,
the reference's cond_transformer_multi_view `sample`), `ar_loss` (the
teacher-forced cross-entropy) and `bbox_token_weights` (its optional
per-token weights). The KV-cached decoder in `ar_cached.py` gives the same
tokens as `ar_sample` with one position per step. Sampling and dropout
draw from an explicit `torch.Generator`; its numbers differ from JAX's
keys, so the tests compare greedy (top_k=1) trajectories and
deterministic losses. A token is drawn by inverse-CDF sampling on one
uniform a row, so a data-parallel rank can draw its rows of a draw made at
the global batch (`parallel.sharding.BatchShard`).
"""
from __future__ import annotations

from typing import Optional

import torch

from bevgen_torch.core.config import MultiViewConfig
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.parallel.sharding import BatchShard, rand_rows


def bbox_token_weights(cfg: MultiViewConfig, bboxes, weight: float) -> torch.Tensor:
    """Per-token CE weights from 2-D boxes (the reference's
    cond_transformer:281-347): latent cells whose centre lies in any box get
    `1 + weight`, the others 1.

    bboxes: (b, cam, k, 4) pixel boxes (left, top, right, bottom) in cam_res
    coordinates. Returns (b, cam * hw) float32."""
    H, W = cfg.cam_res
    h, w = cfg.cam_latent_res
    bb = torch.as_tensor(bboxes, dtype=torch.float32)
    dev = bb.device
    cy = ((torch.arange(h, dtype=torch.float32, device=dev) + 0.5)
          * (H / h)).reshape(1, 1, h, 1, 1)                     # cell centres
    cx = ((torch.arange(w, dtype=torch.float32, device=dev) + 0.5)
          * (W / w)).reshape(1, 1, 1, w, 1)
    left, top, right, bottom = (bb[..., i][:, :, None, None, :] for i in range(4))
    inside = (cx >= left) & (cx <= right) & (cy >= top) & (cy <= bottom)
    hit = inside.any(dim=-1)                                    # (b,cam,h,w)
    return (1.0 + weight * hit.float()).reshape(bb.shape[0], -1)


def ar_loss(model: SparseGPT, tokens, bev_indices, intrinsics_inv,
            extrinsics_inv, weights: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None,
            deterministic: bool = False) -> torch.Tensor:
    """Teacher-forced CE over all image tokens (the reference's
    cond_transformer:277-347): the fp32 log-softmax of the raw-order logits
    of one `sampling=False` forward, at the ground-truth tokens.

    tokens: (b, cam, hw). weights: optional (b, cam * hw) per-token
    multipliers (`bbox_token_weights`); the weighted loss is
    sum(nll * w) / tokens.numel(). generator: the dropout masks' source
    when not deterministic (JAX's `rng`)."""
    b = tokens.shape[0]
    logits = model(tokens, bev_indices, intrinsics_inv, extrinsics_inv,
                   sampling=False, deterministic=deterministic,
                   generator=generator)
    targets = tokens.reshape(b, -1).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    if weights is not None:
        return (nll * weights).sum() / targets.numel()
    return nll.mean()


def top_k_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k logits, -inf elsewhere; ties with the k-th value are
    all kept (`where(logits < kth, -inf, logits)`)."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, float("-inf")),
                       logits)


def categorical(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One category per row of `probs` (b, n) from one uniform per row `u`
    (b,): the inverse of the cumulative distribution of the categories in
    descending order of probability. Categories of probability 0 are never
    drawn. Returns (b,) int64."""
    p_sorted, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    cdf = p_sorted.cumsum(-1)
    pos = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    # the positive categories come first; u * total can round up to total
    last = (p_sorted > 0).sum(-1, keepdim=True) - 1
    return order.gather(-1, torch.minimum(pos, last))[:, 0]


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 1.0,
                  top_k: Optional[int] = None,
                  shard: Optional[BatchShard] = None) -> torch.Tensor:
    """One token per row of fp32 logits (b, vocab): temperature, top-k,
    then a categorical draw from one uniform a row (`shard`'s rows of a draw
    at the global batch). Returns (b,) int64."""
    logits = logits.float() / temperature
    if top_k is not None:
        logits = top_k_logits(logits, top_k)
    probs = torch.softmax(logits, dim=-1)
    u = rand_rows((logits.shape[0],), generator, logits.device, shard)
    return categorical(probs, u)


def decode_positions(model: SparseGPT):
    """(camera, position-in-camera, raw index) of each decode step, as
    Python ints, in the outward decode order."""
    hw = model.cfg.num_cam_tokens
    fwd = model.fwd_order.tolist()
    return [(r // hw, r % hw, r) for r in fwd]


@torch.inference_mode()
def ar_sample(model: SparseGPT, bev_indices, intrinsics_inv, extrinsics_inv,
              generator: Optional[torch.Generator] = None,
              temperature: float = 1.0, top_k: Optional[int] = None,
              init_ids: Optional[torch.Tensor] = None,
              shard: Optional[BatchShard] = None) -> torch.Tensor:
    """Decode all camera tokens autoregressively in the outward order.

    bev_indices: (b, nc). Returns (b, cam, h, w) int64. init_ids: optional
    (b, cam, hw) with `vocab_size` marking the positions to generate; the
    others are kept (partial decoding). shard: the rows are this rank's of
    a data-parallel batch (the draws are made at the global batch)."""
    cfg = model.cfg
    b = bev_indices.shape[0]
    cam, hw = cfg.num_cams, cfg.num_cam_tokens
    dev = bev_indices.device
    if init_ids is None:
        ids = torch.full((b, cam, hw), cfg.vocab_size, dtype=torch.long,
                         device=dev)
        keep = None
    else:
        ids = torch.as_tensor(init_ids, device=dev).long().reshape(b, cam, hw).clone()
        keep = ids != cfg.vocab_size
    for c_i, p_i, raw in decode_positions(model):
        logits = model(ids, bev_indices, intrinsics_inv, extrinsics_inv,
                       sampling=True)
        tok = sample_logits(logits[:, raw], generator, temperature, top_k,
                            shard)
        if keep is not None:
            tok = torch.where(keep[:, c_i, p_i], ids[:, c_i, p_i], tok)
        ids[:, c_i, p_i] = tok
    h, w = cfg.cam_latent_res
    return ids.reshape(b, cam, h, w)
