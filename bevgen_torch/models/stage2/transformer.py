"""Stage-2 multi-view MaskGIT transformer.

Port of `bevgen_tpu/models/stage2/transformer.py` (MUSE path):

  * per layer: cosine-similarity self-attention over the multi-camera
    image tokens (+ camera-bias additive logits), cross-attention to the
    BEV condition tokens, GEGLU feed-forward;
  * geometric embeddings: per-token camera-ray embedding from the
    intrinsics/extrinsics, BEV metric-grid embedding on condition tokens;
  * a step-invariant decode cache (`build_cache`, then `cache=`): the
    ray embedding, the BEV context, the camera-bias slices and every
    layer's cross-attention K/V do not depend on the image ids, so
    `generate` builds them once and replays them into every forward.

Numerics follow the reference: q and k are l2-normalised in fp32 and
scaled by learned per-dim q_scale/k_scale, logits by a fixed 8; a learned
null K/V column is prepended to every attention; LayerNorms are
scale-only with eps 1e-5 and run in fp32. Linear and embedding weights
are stored in the compute dtype (the reference casts its fp32 params to
it at use, which gives the same values); norms, scales, null_kv and the
camera-bias table stay fp32.

Submodule names mirror the reference's parameter tree (`layers_{i}_attn`,
`norm.norm`, `to_kv`, ...), so `core/convert.py` maps one onto the other.
The attention core is `ops.cosine_attention.cosine_attention`: the CUDA
kernel for CUDA tensors, the plain version for CPU tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bevgen_torch.core.config import MultiViewConfig
from bevgen_torch.models import geometry, masks
from bevgen_torch.ops.cosine_attention import cosine_attention


class LayerNormG(nn.Module):
    """Scale-only LayerNorm, eps 1e-5, computed in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n = self.norm
        return F.layer_norm(x.float(), n.normalized_shape, n.weight, None,
                            n.eps).to(dtype)


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    t = t.float()
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(eps)


class CosineAttention(nn.Module):
    """Cosine-sim attention with a learned null K/V column and an optional
    additive bias. `core` is the attention function
    (`ops.cosine_attention.cosine_attention` by default)."""

    def __init__(self, dim: int, dim_head: int, heads: int, dtype,
                 scale: float = 8.0):
        super().__init__()
        self.heads, self.dim_head, self.scale, self.dtype = heads, dim_head, scale, dtype
        inner = heads * dim_head
        self.norm = LayerNormG(dim)
        self.to_q = nn.Linear(dim, inner, bias=False, dtype=dtype)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False, dtype=dtype)
        self.to_out = nn.Linear(inner, dim, bias=False, dtype=dtype)
        self.null_kv = nn.Parameter(torch.empty(2, heads, 1, dim_head))
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.core: Callable = cosine_attention

    def precompute_kv(self, context: torch.Tensor):
        """Decode-cache build: (k^, v) in (b, h, m, dh), K already
        l2-normalised and k_scale-d, both contiguous."""
        b, m, _ = context.shape
        h, dh = self.heads, self.dim_head
        kv = self.to_kv(context.to(self.dtype))
        kvt = kv.reshape(b, m, 2, h, dh).permute(2, 0, 3, 1, 4)
        kf = (l2norm(kvt[0]) * self.k_scale).to(self.dtype).contiguous()
        return kf, kvt[1].contiguous()

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None,
                cached_kv=None) -> torch.Tensor:
        """x: (b, n, dim). Self-attention over x, or cross-attention to the
        context whose (k^, v) `precompute_kv` gave as `cached_kv`. keep:
        (b,) per-sample cond flag or None (all kept); attn_bias: (n, m)
        fp32 or None."""
        b, n, _ = x.shape
        h, dh = self.heads, self.dim_head
        xn = self.norm(x, self.dtype)
        q = self.to_q(xn).reshape(b, n, h, dh).transpose(1, 2)
        if cached_kv is None:
            k, v = self.to_kv(xn).chunk(2, dim=-1)
            # K norm in the projection's (b, n, h, dh) layout, before the
            # head transpose, as the reference does
            kf = (l2norm(k.reshape(b, n, h, dh)) * self.k_scale).to(self.dtype)
            k = kf.transpose(1, 2)
            v = v.reshape(b, n, h, dh).transpose(1, 2)
        else:
            k, v = cached_kv
        out = self.core(q, k, v, self.null_kv, self.q_scale, self.k_scale,
                        attn_bias, keep, sm_scale=self.scale)
        return self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))


class GEGLUFeedForward(nn.Module):
    """LN -> Linear(2*inner) -> gate*gelu(a) -> LN -> Linear(dim), with
    inner = int(dim*mult*2/3) and the exact-erf gelu."""

    def __init__(self, dim: int, mult: int, dtype):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.dtype = dtype
        self.norm_in = LayerNormG(dim)
        self.proj_in = nn.Linear(dim, inner * 2, bias=False, dtype=dtype)
        self.norm_mid = LayerNormG(inner)
        self.proj_out = nn.Linear(inner, dim, bias=False, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj_in(self.norm_in(x, self.dtype)).chunk(2, dim=-1)
        hid = gate * F.gelu(a, approximate="none")
        return self.proj_out(self.norm_mid(hid, self.dtype))


class TransformerOutput(NamedTuple):
    logits: torch.Tensor  # (b, cam, hw, vocab)
    embed: torch.Tensor   # (b, cam*hw, dim)


class MultiViewTransformer(nn.Module):
    """The full stage-2 bidirectional transformer."""

    def __init__(self, cfg: MultiViewConfig, dtype=torch.float32):
        super().__init__()
        if cfg.num_pad_tokens:
            raise ValueError("the MUSE dense path requires no pad tokens")
        if cfg.self_cond:
            raise NotImplementedError("self_cond is not ported yet")
        self.cfg, self.dtype = cfg, dtype
        dim, nc, L = cfg.num_embed, cfg.num_cond_tokens, cfg.gpt_block_size
        if cfg.image_embed:
            self.img_embed = nn.Linear(4, dim, bias=False, dtype=dtype)
            self.cam_embed = nn.Linear(4, dim, bias=False, dtype=dtype)
            self.register_buffer("plane", torch.from_numpy(
                geometry.image_plane(cfg).reshape(3, -1).copy()), persistent=False)
        self.cond_token_emb = nn.Embedding(cfg.cond_vocab_size, dim, dtype=dtype)
        if cfg.bev_embed:
            self.bev_embed = nn.Linear(2, dim, bias=True, dtype=dtype)
            self.bev_cam_pos_emb = nn.Parameter(
                torch.zeros(1, cfg.num_cams, nc, dim))
            self.register_buffer("bev_grid", torch.from_numpy(
                geometry.get_bev_grid(cfg)[:2].reshape(2, -1).T.copy()),
                persistent=False)
        self.cond_pos_emb = nn.Embedding(nc, dim, dtype=dtype)
        if cfg.camera_bias:
            # the full (L, L) table, masked by tril at use
            self.camera_bias_emb = nn.Parameter(torch.zeros(L, L))
            self.register_buffer("tril", torch.tril(torch.ones(L, L)),
                                 persistent=False)
            self.register_buffer("bias_prior", torch.from_numpy(
                masks.camera_bias_matrix(cfg)), persistent=False)
        self.token_emb = nn.Embedding(cfg.vocab_size + 1, dim, dtype=dtype)
        self.pos_emb = nn.Embedding(cfg.num_img_tokens, dim, dtype=dtype)
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}_attn", CosineAttention(
                dim, cfg.dim_head, cfg.num_heads, dtype))
            self.add_module(f"layers_{i}_cross_attn", CosineAttention(
                dim, cfg.dim_head, cfg.num_heads, dtype))
            self.add_module(f"layers_{i}_ff", GEGLUFeedForward(
                dim, cfg.ff_mult, dtype))
        self.final_norm = LayerNormG(dim)
        self.to_logits = nn.Linear(dim, cfg.vocab_size, bias=False, dtype=dtype)

    def layer(self, i: int):
        return (getattr(self, f"layers_{i}_attn"),
                getattr(self, f"layers_{i}_cross_attn"),
                getattr(self, f"layers_{i}_ff"))

    def build_cache(self, cond_ids: torch.Tensor, intrinsics_inv: torch.Tensor,
                    extrinsics_inv: torch.Tensor) -> dict:
        """The step-invariant part of a forward: ray embedding, BEV
        context, camera-bias slices and every layer's cross-attention K/V."""
        cfg, dt = self.cfg, self.dtype
        nc = cfg.num_cond_tokens
        ray = c_embed = None
        if cfg.image_embed:
            I_inv = intrinsics_inv.float()                       # (b,cam,3,3)
            E_inv = extrinsics_inv.float()                       # (b,cam,4,4)
            pts = torch.einsum("bcij,jn->bcin", I_inv, self.plane)
            pts = torch.cat([pts, torch.ones_like(pts[:, :, :1])], dim=2)
            d = torch.einsum("bcij,bcjn->bcin", E_inv, pts)      # (b,cam,4,hw)
            c = E_inv[..., -1]                                   # (b,cam,4)
            d_emb = self.img_embed(d.transpose(2, 3).to(dt))     # (b,cam,hw,dim)
            c_embed = self.cam_embed(c.to(dt))                   # (b,cam,dim)
            ray = (d_emb - c_embed[:, :, None, :]).float()
            ray = ray / (torch.linalg.vector_norm(ray, dim=-1, keepdim=True) + 1e-7)

        context = self.cond_token_emb(cond_ids)                  # (b,nc,dim)
        if cfg.bev_embed:
            grid_embed = self.bev_embed(self.bev_grid.to(dt))   # (nc,dim)
            c_exp = c_embed[:, :, None, :] if c_embed is not None else 0.0
            bev_cam = (self.bev_cam_pos_emb.to(dt) + c_exp).sum(dim=1)
            context = context + (grid_embed[None] - bev_cam)
        context = context + self.cond_pos_emb.weight[None]

        self_bias = cross_bias = None
        if cfg.camera_bias:
            bias = self.camera_bias_emb * self.tril + self.bias_prior
            self_bias = bias[nc:, nc:].contiguous()
            cross_bias = bias[nc:, :nc].contiguous()
        cross_kv = tuple(self.layer(i)[1].precompute_kv(context)
                         for i in range(cfg.num_layers))
        return {"ray": ray, "context": context, "self_bias": self_bias,
                "cross_bias": cross_bias, "cross_kv": cross_kv}

    def forward(self, ids: torch.Tensor, cond_ids: torch.Tensor,
                intrinsics_inv: torch.Tensor, extrinsics_inv: torch.Tensor,
                cond_keep: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None) -> TransformerOutput:
        """ids: (b, cam, hw); cond_ids: (b, nc); cond_keep: (b,) or None.
        `cache` (from `build_cache`) skips the step-invariant work; a
        cache is built from these very inputs when none is given."""
        cfg, dt = self.cfg, self.dtype
        b, cam, hw = ids.shape
        dim = cfg.num_embed
        if cache is None:
            cache = self.build_cache(cond_ids, intrinsics_inv, extrinsics_inv)
        x = self.token_emb(ids)                                  # (b,cam,hw,dim)
        if cache["ray"] is not None:
            x = x + cache["ray"].to(dt)
        x = x.reshape(b, cam * hw, dim) + self.pos_emb.weight[None]

        for i in range(cfg.num_layers):
            attn, cross, ff = self.layer(i)
            x = x + attn(x, attn_bias=cache["self_bias"])
            x = x + cross(x, keep=cond_keep, attn_bias=cache["cross_bias"],
                          cached_kv=cache["cross_kv"][i])
            x = x + ff(x)
        embed = self.final_norm(x, dt)
        logits = self.to_logits(embed)
        return TransformerOutput(logits=logits.reshape(b, cam, hw, -1),
                                 embed=embed)


class SelfCriticHead(nn.Module):
    """Linear real/fake head over transformer embeddings."""

    def __init__(self, dim: int, dtype):
        super().__init__()
        self.to_pred = nn.Linear(dim, 1, bias=True, dtype=dtype)

    def forward(self, embed: torch.Tensor) -> torch.Tensor:
        return self.to_pred(embed)[..., 0]
