"""MaskGIT: iterative masked-token generation (serving).

Port of the sampling half of `bevgen_tpu/models/stage2/maskgit.py` with
the self-critic variant. Per decode step: re-mask the k lowest-scored
tokens (rank-based, k from a static cosine schedule), one transformer
forward, top-k filter, gumbel sample, and one critic forward whose scores
select the next step's re-masking. The last step's critic forward is
skipped, since its scores feed nothing.

Serving is cond-only: the reference's classifier-free guidance cancels
exactly at inference (its null forward only drops the condition in
training mode), so `cfg_logits`/`cfg_critic` run one forward at 1x batch.
Not ported yet (raise): `real_cfg`, the separate TokenCritic transformer,
self-conditioning and the per-step trajectory.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn

from bevgen_torch.core.config import MultiViewConfig, MuseConfig
from bevgen_torch.models.stage2.transformer import (MultiViewTransformer,
                                                    SelfCriticHead,
                                                    TransformerOutput)


class MaskGit(nn.Module):
    """Transformer + self-critic head."""

    def __init__(self, cfg: MultiViewConfig, muse: MuseConfig,
                 dtype=torch.float32):
        super().__init__()
        if muse.token_critic:
            raise NotImplementedError("the TokenCritic variant is not ported yet")
        self.cfg, self.muse, self.dtype = cfg, muse, dtype
        self.transformer = MultiViewTransformer(cfg, dtype)
        if muse.self_token_critic:
            self.critic = SelfCriticHead(cfg.num_embed, dtype)

    def forward(self, ids, cond_ids, intrinsics_inv, extrinsics_inv,
                cond_keep=None, cache=None) -> TransformerOutput:
        return self.transformer(ids, cond_ids, intrinsics_inv, extrinsics_inv,
                                cond_keep, cache=cache)

    def critic_logits(self, ids, cond_ids, intrinsics_inv, extrinsics_inv,
                      cond_keep=None, cache=None) -> torch.Tensor:
        b, cam, hw = ids.shape
        out = self.transformer(ids, cond_ids, intrinsics_inv, extrinsics_inv,
                               cond_keep, cache=cache)
        return self.critic(out.embed).reshape(b, cam, hw)

    def build_cache(self, cond_ids, intrinsics_inv, extrinsics_inv) -> dict:
        return self.transformer.build_cache(cond_ids, intrinsics_inv,
                                            extrinsics_inv)


def cfg_logits(model: MaskGit, ids, cond_ids, ii, ei, cache=None):
    """Decode-step logits (fp32) and embeddings: one cond-only forward."""
    out = model(ids, cond_ids, ii, ei, cache=cache)
    return out.logits.float(), out.embed


def cfg_critic(model: MaskGit, ids, cond_ids, ii, ei, cache=None):
    """Critic scores (fp32) for re-masking: one cond-only forward."""
    return model.critic_logits(ids, cond_ids, ii, ei, cache=cache).float()


def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of element i in a descending sort of `scores`
    (last axis); rank < k <=> element is in the top-k. Stable sorts, as
    `jnp.argsort` is."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def gumbel_sample(logits: torch.Tensor, temperature: float,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """argmax(logits / max(temperature, 1e-10) + g) with g standard gumbel
    noise drawn from `generator`, or the given `noise` tensor."""
    if noise is None:
        u = torch.rand(logits.shape, generator=generator, device=logits.device)
        neg_log_u = torch.log(u.clamp_min(1e-20)).neg().clamp_min(1e-20)
        noise = torch.log(neg_log_u).neg()
    return torch.argmax(logits / max(temperature, 1e-10) + noise, dim=-1)


def top_k_filter(logits: torch.Tensor, thres: float) -> torch.Tensor:
    """Keep the top ceil((1-thres)*V) logits, -inf elsewhere."""
    v = logits.shape[-1]
    k = max(1, math.ceil((1 - thres) * v))
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, torch.full_like(logits, -math.inf), logits)


def schedules(muse: MuseConfig, hw: int, T: int):
    """Static per-step schedules: tokens to re-mask, gumbel temperature and
    critic-noise scale."""
    ts = np.linspace(0.0, 1.0, T)
    num_masked = np.maximum((np.cos(ts * np.pi / 2) * hw).astype(np.int64), 1)
    steps_until = np.arange(T - 1, -1, -1, dtype=np.float32)
    temps = muse.temperature * (steps_until / T)
    noise = muse.critic_noise_scale * (steps_until / T)
    return num_masked, temps, noise


@torch.inference_mode()
def generate(model: MaskGit, cond_ids: torch.Tensor,
             intrinsics_inv: torch.Tensor, extrinsics_inv: torch.Tensor,
             generator: Optional[torch.Generator] = None,
             init_ids: Optional[torch.Tensor] = None,
             timesteps: Optional[int] = None,
             force_not_use_token_critic: bool = False,
             can_remask_prev_masked: bool = False) -> torch.Tensor:
    """Iteratively decode image tokens for every camera.

    cond_ids: (b, num_cond) BEV tokens; intrinsics_inv / extrinsics_inv:
    (b, cam, 3, 3) / (b, cam, 4, 4); init_ids: optional (b, cam, hw) with
    the mask id at positions to generate (partial decoding);
    force_not_use_token_critic: confidence-based re-masking instead of the
    critic forward; can_remask_prev_masked: in that path, let committed
    tokens compete for re-masking. All random draws come from `generator`.
    Returns (b, cam, h, w) int64 codebook indices."""
    cfg, muse = model.cfg, model.muse
    if muse.real_cfg:
        raise NotImplementedError("real_cfg is not ported yet")
    use_critic = muse.self_token_critic and not force_not_use_token_critic
    if can_remask_prev_masked and not use_critic and muse.no_mask_token_prob <= 0.0:
        raise ValueError("can_remask_prev_masked needs a checkpoint trained "
                         "with no_mask_token_prob > 0")
    T = timesteps or muse.sample_iterations
    b = cond_ids.shape[0]
    cam, hw = cfg.num_cams, cfg.num_cam_tokens
    mask_id = cfg.mask_token_id
    dev = cond_ids.device

    ids = torch.full((b, cam, hw), mask_id, dtype=torch.long, device=dev)
    scores = torch.zeros((b, cam, hw), dtype=torch.float32, device=dev)
    keep_init = None if init_ids is None else init_ids != mask_id
    num_masked, temps, noise = schedules(muse, hw, T)

    cache = model.build_cache(cond_ids, intrinsics_inv, extrinsics_inv)
    for step in range(T):
        rank = _rank_desc(scores)
        ids = torch.where(rank < int(num_masked[step]), mask_id, ids)
        if keep_init is not None:
            ids = torch.where(keep_init, init_ids, ids)

        logits, _ = cfg_logits(model, ids, cond_ids, intrinsics_inv,
                               extrinsics_inv, cache=cache)
        filtered = top_k_filter(logits, muse.topk_filter_thres)
        pred = gumbel_sample(filtered, float(temps[step]), generator)

        is_mask = ids == mask_id
        ids = torch.where(is_mask, pred, ids)
        if step == T - 1:
            break  # the last step's scores would select nothing
        if use_critic:
            scores = cfg_critic(model, ids, cond_ids, intrinsics_inv,
                                extrinsics_inv, cache=cache)
            u = torch.rand(scores.shape, generator=generator, device=dev)
            scores = scores + (u - 0.5) * float(noise[step])
        else:
            probs = torch.softmax(logits, dim=-1)
            chosen = torch.gather(probs, -1, pred[..., None])[..., 0]
            scores = 1.0 - chosen
            if not can_remask_prev_masked:
                scores = torch.where(is_mask, scores,
                                     torch.full_like(scores, -1e5))
    h, w = cfg.cam_latent_res
    return ids.reshape(b, cam, h, w)
