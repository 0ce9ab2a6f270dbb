"""MaskGIT: iterative masked-token generation, and its training objective.

Port of `bevgen_tpu/models/stage2/maskgit.py`. Per decode step: re-mask the
k lowest-scored tokens (rank-based, k from a static cosine schedule), one
transformer forward, top-k filter, gumbel sample, and one critic forward
whose scores select the next step's re-masking. The last step's critic
forward is skipped, since its scores feed nothing.

The critic is the SelfCritic head over the generator's embeddings
(`muse.self_token_critic`, the default) or a separate TokenCritic
transformer with a 1-wide head (`muse.token_critic`); the two exclude each
other. By default serving is cond-only: the reference's classifier-free
guidance cancels exactly at inference (its null forward only drops the
condition in training mode), so `cfg_logits`/`cfg_critic` run one forward
at 1x batch. `muse.real_cfg` runs real guidance: the cond and null halves
batched into one 2x-batch forward, the null half's condition dropped to the
learned null K/V column, mixed by `cond_scale` (the TokenCritic's scores
too; the SelfCritic's stay cond-only). With `cfg.self_cond` each step's
forward takes the previous step's cond-pass embeddings (zeros at step 0).
`generate(return_trajectory=True)` also returns the ids after every step.

Training (`maskgit_loss`): cosine-schedule masking per camera image, an
optional no-grad self-conditioning pre-forward, CE on the masked positions,
and the critic's BCE on a gumbel resample.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from bevgen_torch.core.config import MultiViewConfig, MuseConfig
from bevgen_torch.models.stage2.transformer import (MultiViewTransformer,
                                                    SelfCriticHead,
                                                    TransformerOutput)
from bevgen_torch.parallel.sharding import BatchShard, rand_rows


class MaskGit(nn.Module):
    """Transformer + its critic: the SelfCritic head or the TokenCritic
    transformer."""

    def __init__(self, cfg: MultiViewConfig, muse: MuseConfig,
                 dtype=torch.float32, param_dtype=None):
        super().__init__()
        if muse.self_token_critic and muse.token_critic:
            raise ValueError("self_token_critic and token_critic are mutually "
                             "exclusive (muse_maskgit_pytorch.py:496)")
        self.cfg, self.muse, self.dtype = cfg, muse, dtype
        self.transformer = MultiViewTransformer(cfg, dtype, param_dtype)
        if muse.self_token_critic:
            self.critic = SelfCriticHead(cfg.num_embed, dtype, param_dtype)
        if muse.token_critic:
            self.token_critic = MultiViewTransformer(
                cfg, dtype, param_dtype, dim_out=1, add_mask_id=False)

    def forward(self, ids, cond_ids, intrinsics_inv, extrinsics_inv,
                cond_keep=None, self_cond_embed=None,
                cache=None) -> TransformerOutput:
        """The generator's forward; `cache` is `build_cache`'s dict."""
        return self.transformer(ids, cond_ids, intrinsics_inv, extrinsics_inv,
                                cond_keep, self_cond_embed=self_cond_embed,
                                cache=None if cache is None else cache["gen"])

    def critic_logits(self, ids, cond_ids, intrinsics_inv, extrinsics_inv,
                      cond_keep=None, cache=None) -> torch.Tensor:
        """(b, cam, hw) critic scores: the TokenCritic's 1-wide head, or the
        SelfCritic head over a generator forward."""
        b, cam, hw = ids.shape
        if self.muse.token_critic:
            out = self.token_critic(
                ids, cond_ids, intrinsics_inv, extrinsics_inv, cond_keep,
                cache=None if cache is None else cache["critic"])
            return out.logits[..., 0]
        out = self.transformer(ids, cond_ids, intrinsics_inv, extrinsics_inv,
                               cond_keep,
                               cache=None if cache is None else cache["gen"])
        return self.critic(out.embed).reshape(b, cam, hw)

    def build_cache(self, cond_ids, intrinsics_inv, extrinsics_inv) -> dict:
        """The step-invariant decode cache of each transformer: {"gen": ...,
        "critic": the TokenCritic's, or None}."""
        crit = (self.token_critic.build_cache(cond_ids, intrinsics_inv,
                                              extrinsics_inv)
                if self.muse.token_critic else None)
        return {"gen": self.transformer.build_cache(cond_ids, intrinsics_inv,
                                                    extrinsics_inv),
                "critic": crit}


# ---------------------------------------------------------------------------
# classifier-free-guided forwards (cond + null batched)
# ---------------------------------------------------------------------------

def _cfg_batch(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x], dim=0)


def _cfg_keep(b: int, device) -> torch.Tensor:
    """The cond half keeps its condition, the null half drops it."""
    return torch.arange(2 * b, device=device) < b


def cfg_batch_cache(cache: dict) -> dict:
    """`MaskGit.build_cache`'s dict for a guided forward's 2b batch: every
    tensor with a batch axis concatenated with itself once (the keep flag
    enters only at the attention call, so the cache does not depend on it);
    the camera-bias slices are shared."""
    def double(c):
        if c is None:
            return None
        return {"ray": None if c["ray"] is None else _cfg_batch(c["ray"]),
                "context": _cfg_batch(c["context"]),
                "self_bias": c["self_bias"], "cross_bias": c["cross_bias"],
                "cross_kv": tuple((_cfg_batch(k), _cfg_batch(v))
                                  for k, v in c["cross_kv"])}
    return {name: double(c) for name, c in cache.items()}


def decode_caches(model: MaskGit, cond_ids, ii, ei):
    """(cache for `cfg_logits`, cache for `cfg_critic`) of one generate:
    `build_cache`'s dict at 1x, and under real_cfg its 2x form, built once,
    for the guided forwards (the SelfCritic's stay at 1x)."""
    cache = model.build_cache(cond_ids, ii, ei)
    if not model.muse.real_cfg:
        return cache, cache
    guided = cfg_batch_cache(cache)
    return guided, (guided if model.muse.token_critic else cache)


def cfg_logits(model: MaskGit, ids, cond_ids, ii, ei, cond_scale: float,
               self_cond_embed=None, real_cfg: bool = False, cache=None):
    """Decode-step logits (fp32) and the cond pass's embeddings, which feed
    the next step's self-conditioning.

    Default: one cond-only forward. real_cfg: cond and null halves batched
    (cond first) into one 2b forward with keep = [1]*b + [0]*b, mixed as
    null + (cond - null) * cond_scale. cache: `build_cache`'s dict at the
    batch the forward runs, so doubled by `cfg_batch_cache` under real_cfg."""
    if not real_cfg:
        out = model(ids, cond_ids, ii, ei, self_cond_embed=self_cond_embed,
                    cache=cache)
        return out.logits.float(), out.embed
    b = ids.shape[0]
    sc = None if self_cond_embed is None else _cfg_batch(self_cond_embed)
    out = model(_cfg_batch(ids), _cfg_batch(cond_ids), _cfg_batch(ii),
                _cfg_batch(ei), cond_keep=_cfg_keep(b, ids.device),
                self_cond_embed=sc, cache=cache)
    logits = out.logits.float()
    cond, null = logits[:b], logits[b:]
    return null + (cond - null) * cond_scale, out.embed[:b]


def cfg_critic(model: MaskGit, ids, cond_ids, ii, ei, cond_scale: float,
               real_cfg: bool = False, cache=None):
    """Critic scores (fp32) for re-masking: one cond-only forward, except
    that under real_cfg the TokenCritic's scores are mixed as `cfg_logits`
    mixes the logits (2b batch; cache doubled then). The SelfCritic's stay
    cond-only, as in the reference."""
    if model.muse.token_critic and real_cfg:
        b = ids.shape[0]
        scores = model.critic_logits(
            _cfg_batch(ids), _cfg_batch(cond_ids), _cfg_batch(ii),
            _cfg_batch(ei), cond_keep=_cfg_keep(b, ids.device),
            cache=cache).float()
        cond, null = scores[:b], scores[b:]
        return null + (cond - null) * cond_scale
    return model.critic_logits(ids, cond_ids, ii, ei, cache=cache).float()


def _rank_desc(scores: torch.Tensor) -> torch.Tensor:
    """rank[i] = position of element i in a descending sort of `scores`
    (last axis); rank < k <=> element is in the top-k. Stable sorts, as
    `jnp.argsort` is."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    return torch.argsort(order, dim=-1, stable=True)


def gumbel_sample(logits: torch.Tensor, temperature: float,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[torch.Tensor] = None,
                  shard: Optional[BatchShard] = None) -> torch.Tensor:
    """argmax(logits / max(temperature, 1e-10) + g) with g standard gumbel
    noise drawn from `generator` (`shard`'s rows of a draw at the global
    batch), or the given `noise` tensor."""
    if noise is None:
        u = rand_rows(logits.shape, generator, logits.device, shard)
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
             can_remask_prev_masked: bool = False,
             return_trajectory: bool = False,
             shard: Optional[BatchShard] = None):
    """Iteratively decode image tokens for every camera.

    cond_ids: (b, num_cond) BEV tokens; intrinsics_inv / extrinsics_inv:
    (b, cam, 3, 3) / (b, cam, 4, 4); init_ids: optional (b, cam, hw) with
    the mask id at positions to generate (partial decoding);
    force_not_use_token_critic: confidence-based re-masking instead of the
    critic forward; can_remask_prev_masked: in that path, let committed
    tokens compete for re-masking. All random draws come from `generator`;
    with `shard` (this rank's rows of a data-parallel batch) each is drawn
    at the global batch's shape and its rows kept, so the ranks together
    decode what one process decodes for the whole batch.
    Returns (b, cam, h, w) int64 codebook indices, or (ids, trajectory)
    with return_trajectory: the (T, b, cam, hw) ids after every step, the
    last equal to the returned ids."""
    cfg, muse = model.cfg, model.muse
    use_critic = ((muse.self_token_critic or muse.token_critic)
                  and not force_not_use_token_critic)
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
    # self-conditioning carry: the previous step's cond-pass embeddings
    sc = (torch.zeros((b, cfg.num_img_tokens, cfg.num_embed),
                      dtype=torch.float32, device=dev)
          if cfg.self_cond else None)
    keep_init = None if init_ids is None else init_ids != mask_id
    num_masked, temps, noise = schedules(muse, hw, T)

    gen_cache, critic_cache = decode_caches(model, cond_ids, intrinsics_inv,
                                            extrinsics_inv)
    trajectory = []
    for step in range(T):
        rank = _rank_desc(scores)
        ids = torch.where(rank < int(num_masked[step]), mask_id, ids)
        if keep_init is not None:
            ids = torch.where(keep_init, init_ids, ids)

        logits, embed = cfg_logits(model, ids, cond_ids, intrinsics_inv,
                                   extrinsics_inv, muse.cond_scale,
                                   self_cond_embed=sc, real_cfg=muse.real_cfg,
                                   cache=gen_cache)
        if cfg.self_cond:
            sc = embed.float()
        filtered = top_k_filter(logits, muse.topk_filter_thres)
        pred = gumbel_sample(filtered, float(temps[step]), generator,
                             shard=shard)

        is_mask = ids == mask_id
        ids = torch.where(is_mask, pred, ids)
        if return_trajectory:
            trajectory.append(ids)
        if step == T - 1:
            break  # the last step's scores would select nothing
        if use_critic:
            scores = cfg_critic(model, ids, cond_ids, intrinsics_inv,
                                extrinsics_inv, muse.cond_scale,
                                real_cfg=muse.real_cfg, cache=critic_cache)
            u = rand_rows(scores.shape, generator, dev, shard)
            scores = scores + (u - 0.5) * float(noise[step])
        else:
            probs = torch.softmax(logits, dim=-1)
            chosen = torch.gather(probs, -1, pred[..., None])[..., 0]
            scores = 1.0 - chosen
            if not can_remask_prev_masked:
                scores = torch.where(is_mask, scores,
                                     torch.full_like(scores, -1e5))
    h, w = cfg.cam_latent_res
    out = ids.reshape(b, cam, h, w)
    if return_trajectory:
        return out, torch.stack(trajectory)
    return out


# ---------------------------------------------------------------------------
# training objective
# ---------------------------------------------------------------------------

class MaskGitLoss(NamedTuple):
    loss: torch.Tensor
    ce_loss: torch.Tensor
    critic_loss: torch.Tensor


def masked_nll(logits: torch.Tensor, labels: torch.Tensor,
               ignore_index: int = -1):
    """(sum of the fp32 cross entropy over the positions whose label is not
    `ignore_index`, their count)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros((), device=nll.device))
    return nll.sum(), valid.sum()


def masked_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = -1) -> torch.Tensor:
    """Mean fp32 cross entropy over the positions whose label is not
    `ignore_index`."""
    total, count = masked_nll(logits, labels, ignore_index)
    return total / count.clamp_min(1)


def maskgit_loss(model: MaskGit, tokens, cond_ids, intrinsics_inv,
                 extrinsics_inv, generator: Optional[torch.Generator] = None,
                 mask_override: Optional[torch.Tensor] = None,
                 gumbel_noise: Optional[torch.Tensor] = None,
                 shard: Optional[BatchShard] = None) -> MaskGitLoss:
    """Training loss (the reference's `maskgit_loss`, maskgit.py:376-472).

    tokens: (b, cam, hw) ground-truth codebook indices. Per camera image a
    masking ratio cos(t pi/2), t ~ U(0, 1), picks that many positions at
    random (rank of uniform noise); `no_mask_token_prob` leaves a fraction
    of them at their true token while still predicting them. The condition
    is kept per sample with probability 1 - cond_drop_prob. With
    `cfg.self_cond`, a flag drawn against self_cond_prob runs a no-grad,
    cond-only pre-forward whose fp32 embeddings self-condition the main
    forward (zeros otherwise). CE on the masked positions; with a critic,
    the masked positions are resampled (gumbel at a U(0, 1) temperature), a
    critic forward with its own cond_keep scores them through
    `critic_logits`, and the BCE against "differs from the truth" is added
    with weight critic_loss_weight.

    All draws come from `generator`. mask_override: (b, cam, hw) bool in
    place of the random mask; gumbel_noise: (b, cam, hw, vocab) in place of
    the gumbel draw (zeros make the resample an argmax). For the tests.

    shard: the batch is this rank's rows of a data-parallel batch. Each
    draw with a batch axis is then made at the global batch's shape (its
    rows kept), the CE's masked count is summed over the ranks before the
    division (the global batch's CE: ranks mask different counts, so a
    mean of their means would differ), and the BCE is divided by the
    number of ranks. The returned terms are this rank's parts: summed over
    the ranks, they and their gradients are the global batch's."""
    cfg, muse = model.cfg, model.muse
    b, cam, hw = tokens.shape
    dev = tokens.device
    tokens = tokens.long()

    def uniform(*shape):
        return rand_rows(shape, generator, dev, shard)

    t = uniform(b, cam)
    mask_prob = torch.cos(t * math.pi / 2)
    num_masked = torch.clamp(torch.round(hw * mask_prob), 1, hw)
    rank = _rank_desc(-uniform(b, cam, hw))          # a random permutation
    mask = rank < num_masked[..., None]
    if mask_override is not None:
        mask = mask_override.to(device=dev, dtype=torch.bool)
    labels = torch.where(mask, tokens, -1)

    if muse.no_mask_token_prob > 0.0:
        sub_rank = _rank_desc(torch.where(mask, uniform(b, cam, hw), -1.0))
        num_keep = mask.sum(-1, keepdim=True) * muse.no_mask_token_prob
        mask = mask & ~(sub_rank < num_keep)

    x = torch.where(mask, cfg.mask_token_id, tokens)
    sc_embed = None
    if cfg.self_cond and bool(uniform() < muse.self_cond_prob):
        # the pre-forward saves nothing for a backward
        with torch.no_grad():
            sc_embed = model(x, cond_ids, intrinsics_inv,
                             extrinsics_inv).embed.float()
    cond_keep = uniform(b) >= muse.cond_drop_prob
    out = model(x, cond_ids, intrinsics_inv, extrinsics_inv,
                cond_keep=cond_keep, self_cond_embed=sc_embed)
    nll_sum, count = masked_nll(out.logits, labels)
    if shard is not None:
        count = shard.sum(count)
    ce = nll_sum / count.clamp_min(1)
    if not (muse.self_token_critic or muse.token_critic):
        return MaskGitLoss(ce, ce, torch.zeros_like(ce))

    temp = uniform()
    sampled = gumbel_sample(out.logits.detach().float(), temp, generator,
                            noise=gumbel_noise, shard=shard)
    critic_input = torch.where(mask, sampled, x)
    critic_labels = (tokens != critic_input).float()
    cond_keep2 = uniform(b) >= muse.cond_drop_prob
    logits = model.critic_logits(critic_input, cond_ids, intrinsics_inv,
                                 extrinsics_inv, cond_keep=cond_keep2).float()
    bce = torch.mean(logits.clamp_min(0) - logits * critic_labels
                     + torch.log1p(torch.exp(-logits.abs())))
    if shard is not None:   # a mean over equal shards: each rank's part
        bce = bce / (shard.total // b)
    return MaskGitLoss(ce + muse.critic_loss_weight * bce, ce, bce)
