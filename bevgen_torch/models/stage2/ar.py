"""Autoregressive sampling for the sparse GPT, one full forward per token.

Port of `bevgen_tpu/models/stage2/ar.py` (`top_k_logits`, `ar_sample`): the
reference-parity sampler, which decodes the camera tokens one at a time in
the outward decode order and runs the whole L-position forward for each
(the reference's cond_transformer_multi_view `sample`). The KV-cached
decoder in `ar_cached.py` gives the same tokens with one position per step.
Sampling draws from an explicit `torch.Generator`; its numbers differ from
JAX's keys, so the tests compare greedy (top_k=1) trajectories.

The training objective (`ar_loss`, `bbox_token_weights`) is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from bevgen_torch.models.stage2.gpt import SparseGPT


def top_k_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the top-k logits, -inf elsewhere; ties with the k-th value are
    all kept (`where(logits < kth, -inf, logits)`)."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, float("-inf")),
                       logits)


def sample_logits(logits: torch.Tensor, generator: Optional[torch.Generator],
                  temperature: float = 1.0,
                  top_k: Optional[int] = None) -> torch.Tensor:
    """One token per row of fp32 logits (b, vocab): temperature, top-k,
    then a categorical draw. Returns (b,) int64."""
    logits = logits.float() / temperature
    if top_k is not None:
        logits = top_k_logits(logits, top_k)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


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
              init_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode all camera tokens autoregressively in the outward order.

    bev_indices: (b, nc). Returns (b, cam, h, w) int64. init_ids: optional
    (b, cam, hw) with `vocab_size` marking the positions to generate; the
    others are kept (partial decoding)."""
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
        tok = sample_logits(logits[:, raw], generator, temperature, top_k)
        if keep is not None:
            tok = torch.where(keep[:, c_i, p_i], ids[:, c_i, p_i], tok)
        ids[:, c_i, p_i] = tok
    h, w = cfg.cam_latent_res
    return ids.reshape(b, cam, h, w)
