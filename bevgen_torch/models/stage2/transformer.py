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
are stored in `param_dtype` and cast to the compute `dtype` at use, as
the reference casts its fp32 params (`x @ kernel.astype(dtype)`):
training keeps them fp32 (small AdamW steps would round away in bf16),
serving defaults `param_dtype` to `dtype`, where the cast is a no-op.
Norms, scales, null_kv and the camera-bias table are always fp32.

`cfg.self_cond` adds the `self_cond_to_init_embed` GEGLU feed-forward
(always the unfused form), whose output on the previous decode step's
embeddings (zeros when none are given) joins the stream after the position
embedding. `dim_out` and `add_mask_id` build the TokenCritic's transformer:
a 1-wide head and a token table without the mask id's row.

`cfg.use_fused_glue` (off by default, as in the reference) restructures
every block into the reference's delta-chaining form: the residual add
folds into the next norm (`ops/fused_glue.py`'s residual + LayerNorm pass)
and the GEGLU's gate*gelu and middle norm are one pass; the parameters are
the same on both forms.

`cfg.remat` (training only) runs each layer's `attn`, `cross` and `ff` as
one `torch.utils.checkpoint` region (non-reentrant) while gradients are on:
the backward recomputes the block's forward, kernels included, in place of
holding its activations, as the reference's `nn.remat` does per
`CosineAttention` and `GEGLUFeedForward`. Under `no_grad` (serving, the
self-conditioning pre-forward) the blocks run as they are. No block draws a
random number, so the recomputation repeats the forward exactly.

`cfg.quant == "int8"` (serving only) swaps the hot products for the W8A8
`ops.quant.QuantDense` (`make_dense`): `to_q`, the self-attention `to_kv`,
`proj_in`, `proj_out` and `to_logits` with static activation scales, `to_out`
and the cross-attention `to_kv` (so the decode cache's `precompute_kv`) with
dynamic ones, as `ops.quant.quantize_dense_tree` builds the tree; each
`CosineAttention` knows whether it is a cross attention. The GEGLU's glue
pass turns off under int8 (the residual + LayerNorm glue does not), and
`self_cond_to_init_embed` stays in the compute dtype.

Tensor parallelism (`parallel/tensor.py`; `shard_module_` cuts the weights
and calls each module's `tp_ready`): every attention keeps `heads / tp`
heads (`to_q`, `to_kv` and `null_kv` column-split, `to_out` row-split, its
`Dense` summing over tp); the GEGLU keeps F / tp columns of each half
of `proj_in` and rows of `proj_out`, with `norm_mid` over the whole F through
`tensor.layer_norm`; `to_logits` is column-split and followed by
`gather_from_tp`, so the logits come out whole on every rank. An axis that
tp does not divide stays whole (the TokenCritic's 1-wide head; the GEGLU at
F = 2730 and tp = 4, which then runs replicated with no collective).
Replicated parameters used inside a rank's share (q_scale, k_scale, the
norm_mid gain, the camera-bias slices) and the inputs of the column-split
products pass through `copy_to_tp`, so their gradients sum the ranks'
shares and stay equal on every rank.

The fused glue under tp: the residual + LayerNorm pass runs whole on every
rank (the stream is replicated, and the delta it adds comes from a
row-split `to_out` or `proj_out`, already summed over tp); the GEGLU +
LayerNorm pass runs split over the rank's F / tp columns
(`ops/fused_glue.py:geglu_layernorm` with the mesh: the row statistics
summed over tp between two kernels), and whole where the GEGLU is. int8
serving under tp: the int8 tree is quantized whole, then cut by the same
plan (`kernel_q` as the kernel it replaces, `scale` with the output axis,
`in_scale` whole and taken in part at use); the column-split `QuantDense`s
run as they are on the rank's outputs, and the row-split `to_out` and
`proj_out` sum their int32 accumulators over tp before the epilogue
(`to_out`'s per-row scale from the amax over every rank's columns), so
their outputs equal one process's bit for bit.

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
from torch.utils.checkpoint import checkpoint

from bevgen_torch.core.config import MultiViewConfig
from bevgen_torch.models import geometry, masks
from bevgen_torch.ops.cosine_attention import cosine_attention
from bevgen_torch.ops.fused_glue import geglu_layernorm, residual_layernorm
from bevgen_torch.ops.layernorm import layernorm
from bevgen_torch.ops.quant import QuantDense
from bevgen_torch.parallel import tensor as tpar
from bevgen_torch.parallel.tensor import (copy_to_tp, gather_from_tp,
                                          reduce_from_tp)


class Dense(nn.Linear):
    """nn.Linear stored in `param_dtype`; weight, bias and input are cast
    to the compute `dtype` at use (flax Dense with dtype/param_dtype).

    Tensor-parallel (`tp_ready` after `tensor.shard_module_` cut the
    weight): a column-split product (output axis cut) computes this rank's
    outputs with its part of the whole bias; a row-split one (input axis
    cut) sums its partial products over tp (`reduce_from_tp`) and adds the
    bias once. The caller passes the input of a column-split product
    through `copy_to_tp`."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype, param_dtype=None):
        super().__init__(in_features, out_features, bias=bias,
                         dtype=param_dtype or dtype)
        self.compute_dtype = dtype
        self.mesh = None

    def tp_ready(self, mesh) -> None:
        if tpar.is_split(self):
            self.mesh = mesh

    def local_bias(self) -> Optional[torch.Tensor]:
        """The bias of this rank's outputs (the whole bias unless the
        output axis is cut), in the compute dtype."""
        b = self.bias
        if b is None:
            return None
        if self.mesh is not None and self._tp_split["weight"][0] == 0:
            b = tpar.take_part(b, 0, self._tp_split["weight"][1],
                               self.mesh.tp, self.mesh.tp_rank)
        return b.to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.mesh is not None and self._tp_split["weight"][0] == 1:
            y = reduce_from_tp(F.linear(x.to(dt), self.weight.to(dt)),
                               self.mesh)
            return y if self.bias is None else y + self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), self.local_bias())


def make_dense(quant: str):
    """Factory of the hot products' layers, called as
    `dense(in, out, dtype, param_dtype, static)`: a bias-free `Dense`, or
    under int8 a `QuantDense` whose activation scales are static (`static`:
    the input is a scale-only LayerNorm output) or per row. The choices
    must agree with `ops.quant.quantize_dense_tree`'s."""
    if quant == "int8":
        return lambda i, o, dtype, param_dtype=None, static=False: QuantDense(
            i, o, dtype, static_input=static)
    return lambda i, o, dtype, param_dtype=None, static=False: Dense(
        i, o, False, dtype, param_dtype)


class Embed(nn.Embedding):
    """nn.Embedding stored in `param_dtype`, looked up in `dtype` (flax
    Embed casts the table)."""

    def __init__(self, num: int, dim: int, dtype, param_dtype=None):
        super().__init__(num, dim, dtype=param_dtype or dtype)
        self.compute_dtype = dtype

    def table(self) -> torch.Tensor:
        return self.weight.to(self.compute_dtype)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.table())


class LayerNormG(nn.Module):
    """Scale-only LayerNorm, eps 1e-5, computed in fp32.

    `residual`: the fused-glue form, which returns (x_new = dtype(x +
    residual), LN(x_new) * gamma) from one pass (`ops/fused_glue.py`).
    `use_fused=True` takes the standalone LayerNorm op (`ops/layernorm.py`,
    output in x's dtype) for inputs of at least 8 rows, as the reference
    does; no configuration sets it. The parameter is `norm.weight` on every
    path."""

    def __init__(self, dim: int, use_fused: Optional[bool] = None):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5, bias=False)
        self.use_fused = bool(use_fused)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                residual: Optional[torch.Tensor] = None):
        n = self.norm
        if residual is not None:
            return residual_layernorm(x.to(dtype), residual.to(dtype), n.weight)
        if self.use_fused and x.ndim >= 2 and x.shape[-2] >= 8:
            return layernorm(x, n.weight)
        return F.layer_norm(x.float(), n.normalized_shape, n.weight, None,
                            n.eps).to(dtype)


def l2norm(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    t = t.float()
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(eps)


class CosineAttention(nn.Module):
    """Cosine-sim attention with a learned null K/V column and an optional
    additive bias. `core` is the attention function
    (`ops.cosine_attention.cosine_attention` by default). `cross`: a cross
    attention, whose K/V come from the context (`precompute_kv`); under
    int8 its `to_kv` takes per-row activation scales, the self-attention's
    static ones."""

    def __init__(self, dim: int, dim_head: int, heads: int, dtype,
                 scale: float = 8.0, param_dtype=None, quant: str = "none",
                 cross: bool = False):
        super().__init__()
        self.heads, self.dim_head, self.scale, self.dtype = heads, dim_head, scale, dtype
        inner = heads * dim_head
        dense = make_dense(quant)
        self.norm = LayerNormG(dim)
        self.to_q = dense(dim, inner, dtype, param_dtype, static=True)
        self.to_kv = dense(dim, inner * 2, dtype, param_dtype, static=not cross)
        self.to_out = dense(inner, dim, dtype, param_dtype)
        self.null_kv = nn.Parameter(torch.empty(2, heads, 1, dim_head))
        self.q_scale = nn.Parameter(torch.ones(dim_head))
        self.k_scale = nn.Parameter(torch.ones(dim_head))
        self.core: Callable = cosine_attention
        self.mesh = None
        self.local_heads = heads

    def tp_ready(self, mesh) -> None:
        """After `tensor.shard_module_`: this rank's heads / tp heads."""
        if self.heads % mesh.tp or not tpar.is_split(self, "null_kv"):
            raise ValueError(f"{self.heads} heads do not split over tp="
                             f"{mesh.tp}")
        self.mesh, self.local_heads = mesh, self.heads // mesh.tp

    def precompute_kv(self, context: torch.Tensor):
        """Decode-cache build: (k^, v) in (b, h, m, dh) with this rank's h
        heads, K already l2-normalised and k_scale-d, both contiguous."""
        b, m, _ = context.shape
        h, dh = self.local_heads, self.dim_head
        kv = self.to_kv(copy_to_tp(context, self.mesh))
        kvt = kv.reshape(b, m, 2, h, dh).permute(2, 0, 3, 1, 4)
        k_scale = copy_to_tp(self.k_scale, self.mesh)
        kf = (l2norm(kvt[0]) * k_scale).to(self.dtype).contiguous()
        return kf, kvt[1].contiguous()

    def forward(self, x: torch.Tensor, keep: Optional[torch.Tensor] = None,
                attn_bias: Optional[torch.Tensor] = None,
                cached_kv=None, residual_delta: Optional[torch.Tensor] = None,
                return_residual: bool = False):
        """x: (b, n, dim). Self-attention over x, or cross-attention to the
        context whose (k^, v) `precompute_kv` gave as `cached_kv`. keep:
        (b,) per-sample cond flag or None (all kept); attn_bias: (n, m)
        fp32 or None.

        The fused-glue convention: x is the stream before the residual add
        and `residual_delta` the previous block's output, added inside the
        norm (`LayerNormG(residual=)`); `return_residual` returns (x_new,
        out), so the caller chains the deltas."""
        b, n, _ = x.shape
        h, dh, mesh = self.local_heads, self.dim_head, self.mesh
        if residual_delta is not None:
            x_new, xn = self.norm(x, self.dtype, residual=residual_delta)
        else:
            x_new, xn = x, self.norm(x, self.dtype)
        xn = copy_to_tp(xn, mesh)
        q_scale = copy_to_tp(self.q_scale, mesh)
        k_scale = copy_to_tp(self.k_scale, mesh)
        q = self.to_q(xn).reshape(b, n, h, dh).transpose(1, 2)
        if cached_kv is None:
            k, v = self.to_kv(xn).chunk(2, dim=-1)
            # K norm in the projection's (b, n, h, dh) layout, before the
            # head transpose, as the reference does
            kf = (l2norm(k.reshape(b, n, h, dh)) * k_scale).to(self.dtype)
            k = kf.transpose(1, 2)
            v = v.reshape(b, n, h, dh).transpose(1, 2)
        else:
            k, v = cached_kv
        out = self.core(q, k, v, self.null_kv, q_scale, k_scale, attn_bias,
                        keep, sm_scale=self.scale)
        # on the card `out` is a (b, h, n, dh) view of a (b, n, h, dh)
        # tensor, so the merge of the heads is a view too; a row-split
        # to_out sums the heads of every rank
        out = self.to_out(out.transpose(1, 2).reshape(b, n, h * dh))
        return (x_new, out) if return_residual else out


class GEGLUFeedForward(nn.Module):
    """LN -> Linear(2*inner) -> gate*gelu(a) -> LN -> Linear(dim), with
    inner = int(dim*mult*2/3) and the exact-erf gelu.

    `use_glue`: gate*gelu and norm_mid in one pass (`ops/fused_glue.py`)
    between the unpadded projections. `residual_delta` / `return_residual`:
    the fused-glue convention of `CosineAttention.forward`. Under int8 both
    projections are `QuantDense`s with static scales and the GEGLU pass
    stays unfused, as in the reference."""

    def __init__(self, dim: int, mult: int, dtype, param_dtype=None,
                 use_glue: bool = False, quant: str = "none"):
        super().__init__()
        inner = int(dim * mult * 2 / 3)
        self.dtype, self.use_glue = dtype, use_glue and quant == "none"
        dense = make_dense(quant)
        self.norm_in = LayerNormG(dim)
        self.proj_in = dense(dim, inner * 2, dtype, param_dtype, static=True)
        self.norm_mid = LayerNormG(inner)
        self.proj_out = dense(inner, dim, dtype, param_dtype, static=True)
        self.mesh = None

    def tp_ready(self, mesh) -> None:
        """After `tensor.shard_module_`: split when tp divides the hidden
        width (proj_in and proj_out were cut), else replicated."""
        if tpar.is_split(self.proj_in) != tpar.is_split(self.proj_out):
            raise ValueError("proj_in and proj_out split differently")
        self.mesh = mesh if tpar.is_split(self.proj_in) else None

    def _gain(self) -> torch.Tensor:
        """norm_mid's gains of this rank's hidden columns (all of them when
        the GEGLU is whole); under tp their gradient sums over the ranks."""
        w, mesh = self.norm_mid.norm.weight, self.mesh
        if mesh is None:
            return w
        return tpar.take_part(copy_to_tp(w, mesh), 0, 1, mesh.tp, mesh.tp_rank)

    def _norm_mid(self, h: torch.Tensor) -> torch.Tensor:
        """norm_mid over the whole hidden width: this rank's columns of it
        under tp (`tensor.layer_norm`, two passes, as the unfused form
        computes it)."""
        if self.mesh is None:
            return self.norm_mid(h, self.dtype)
        return tpar.layer_norm(h, self._gain(), self.norm_mid.norm.eps,
                               self.mesh).to(self.dtype)

    def forward(self, x: torch.Tensor,
                residual_delta: Optional[torch.Tensor] = None,
                return_residual: bool = False):
        if residual_delta is not None:
            x_new, h = self.norm_in(x, self.dtype, residual=residual_delta)
        else:
            x_new, h = x, self.norm_in(x, self.dtype)
        y = self.proj_in(copy_to_tp(h, self.mesh))
        if self.use_glue:   # the split form when tp cuts the hidden width
            hid = geglu_layernorm(y, self._gain(), self.mesh)
        else:
            a, gate = y.chunk(2, dim=-1)
            hid = self._norm_mid(gate * F.gelu(a, approximate="none"))
        out = self.proj_out(hid)     # summed over tp when split
        return (x_new, out) if return_residual else out


class TransformerOutput(NamedTuple):
    logits: torch.Tensor  # (b, cam, hw, vocab)
    embed: torch.Tensor   # (b, cam*hw, dim)


class MultiViewTransformer(nn.Module):
    """The full stage-2 bidirectional transformer. `dtype` is the compute
    dtype, `param_dtype` (default: `dtype`) the storage of the Linear and
    embedding weights. `dim_out`: the head's width (None: vocab_size; the
    TokenCritic's is 1). `add_mask_id`: the token table holds a row for the
    mask id (the generator's does, the TokenCritic's does not)."""

    def __init__(self, cfg: MultiViewConfig, dtype=torch.float32,
                 param_dtype=None, dim_out: Optional[int] = None,
                 add_mask_id: bool = True):
        super().__init__()
        if cfg.num_pad_tokens:
            raise ValueError("the MUSE dense path requires no pad tokens")
        self.cfg, self.dtype = cfg, dtype
        self.use_glue = bool(cfg.use_fused_glue)
        dim, nc, L = cfg.num_embed, cfg.num_cond_tokens, cfg.gpt_block_size
        pdt = param_dtype
        if cfg.image_embed:
            self.img_embed = Dense(4, dim, False, dtype, pdt)
            self.cam_embed = Dense(4, dim, False, dtype, pdt)
            self.register_buffer("plane", torch.from_numpy(
                geometry.image_plane(cfg).reshape(3, -1).copy()), persistent=False)
        self.cond_token_emb = Embed(cfg.cond_vocab_size, dim, dtype, pdt)
        if cfg.bev_embed:
            self.bev_embed = Dense(2, dim, True, dtype, pdt)
            self.bev_cam_pos_emb = nn.Parameter(
                torch.zeros(1, cfg.num_cams, nc, dim))
            self.register_buffer("bev_grid", torch.from_numpy(
                geometry.get_bev_grid(cfg)[:2].reshape(2, -1).T.copy()),
                persistent=False)
        self.cond_pos_emb = Embed(nc, dim, dtype, pdt)
        if cfg.camera_bias:
            # the full (L, L) table, masked by tril at use
            self.camera_bias_emb = nn.Parameter(torch.zeros(L, L))
            self.register_buffer("tril", torch.tril(torch.ones(L, L)),
                                 persistent=False)
            self.register_buffer("bias_prior", torch.from_numpy(
                masks.camera_bias_matrix(cfg)), persistent=False)
        self.token_emb = Embed(cfg.vocab_size + int(add_mask_id), dim, dtype,
                               pdt)
        self.pos_emb = Embed(cfg.num_img_tokens, dim, dtype, pdt)
        if cfg.self_cond:
            # the reference builds it with mult 4 and without the glue
            self.self_cond_to_init_embed = GEGLUFeedForward(dim, 4, dtype, pdt)
        q = cfg.quant
        for i in range(cfg.num_layers):
            self.add_module(f"layers_{i}_attn", CosineAttention(
                dim, cfg.dim_head, cfg.num_heads, dtype, param_dtype=pdt,
                quant=q))
            self.add_module(f"layers_{i}_cross_attn", CosineAttention(
                dim, cfg.dim_head, cfg.num_heads, dtype, param_dtype=pdt,
                quant=q, cross=True))
            self.add_module(f"layers_{i}_ff", GEGLUFeedForward(
                dim, cfg.ff_mult, dtype, pdt, use_glue=self.use_glue, quant=q))
        self.final_norm = LayerNormG(dim)
        self.to_logits = make_dense(q)(
            dim, cfg.vocab_size if dim_out is None else dim_out, dtype, pdt,
            static=True)
        self.mesh = None

    def tp_ready(self, mesh) -> None:
        """After `tensor.shard_module_`: the logits are gathered where
        `to_logits` was cut."""
        self.mesh = mesh

    def layer(self, i: int):
        return (getattr(self, f"layers_{i}_attn"),
                getattr(self, f"layers_{i}_cross_attn"),
                getattr(self, f"layers_{i}_ff"))

    def block(self, module: nn.Module, *args, **kwargs):
        """`module(*args, **kwargs)`; with `cfg.remat` and gradients on, as
        a checkpointed region whose activations the backward recomputes."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False, **kwargs)
        return module(*args, **kwargs)

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
        context = context + self.cond_pos_emb.table()[None]

        self_bias = cross_bias = None
        if cfg.camera_bias:
            # under tp every attention adds its heads' share of the gradient
            bias = copy_to_tp(self.camera_bias_emb, self.mesh) * self.tril \
                + self.bias_prior
            self_bias = bias[nc:, nc:].contiguous()
            cross_bias = bias[nc:, :nc].contiguous()
        cross_kv = tuple(self.layer(i)[1].precompute_kv(context)
                         for i in range(cfg.num_layers))
        return {"ray": ray, "context": context, "self_bias": self_bias,
                "cross_bias": cross_bias, "cross_kv": cross_kv}

    def forward(self, ids: torch.Tensor, cond_ids: torch.Tensor,
                intrinsics_inv: torch.Tensor, extrinsics_inv: torch.Tensor,
                cond_keep: Optional[torch.Tensor] = None,
                self_cond_embed: Optional[torch.Tensor] = None,
                cache: Optional[dict] = None) -> TransformerOutput:
        """ids: (b, cam, hw); cond_ids: (b, nc); cond_keep: (b,) or None;
        self_cond_embed: (b, cam*hw, dim) or None (zeros), read only with
        `cfg.self_cond`. `cache` (from `build_cache`) skips the
        step-invariant work; a cache is built from these very inputs when
        none is given."""
        cfg, dt = self.cfg, self.dtype
        b, cam, hw = ids.shape
        dim = cfg.num_embed
        if cache is None:
            cache = self.build_cache(cond_ids, intrinsics_inv, extrinsics_inv)
        x = self.token_emb(ids)                                  # (b,cam,hw,dim)
        if cache["ray"] is not None:
            x = x + cache["ray"].to(dt)
        x = x.reshape(b, cam * hw, dim) + self.pos_emb.table()[None]
        if cfg.self_cond:
            sc = (torch.zeros_like(x) if self_cond_embed is None
                  else self_cond_embed.to(dt))
            x = x + self.self_cond_to_init_embed(sc)

        if self.use_glue:
            # delta chaining: each block takes (stream, previous block's
            # output) and folds the residual add into its norm; layer 0's
            # self-attention has no delta and takes the plain norm
            d = None
            for i in range(cfg.num_layers):
                attn, cross, ff = self.layer(i)
                x, d = self.block(attn, x, attn_bias=cache["self_bias"],
                                  residual_delta=d, return_residual=True)
                x, d = self.block(cross, x, keep=cond_keep,
                                  attn_bias=cache["cross_bias"],
                                  cached_kv=cache["cross_kv"][i],
                                  residual_delta=d, return_residual=True)
                x, d = self.block(ff, x, residual_delta=d,
                                  return_residual=True)
            embed = (self.final_norm(x, dt) if d is None
                     else self.final_norm(x, dt, residual=d)[1])
        else:
            for i in range(cfg.num_layers):
                attn, cross, ff = self.layer(i)
                x = x + self.block(attn, x, attn_bias=cache["self_bias"])
                x = x + self.block(cross, x, keep=cond_keep,
                                   attn_bias=cache["cross_bias"],
                                   cached_kv=cache["cross_kv"][i])
                x = x + self.block(ff, x)
            embed = self.final_norm(x, dt)
        if tpar.is_split(self.to_logits):
            logits = gather_from_tp(self.to_logits(
                copy_to_tp(embed, self.mesh)), self.mesh)
        else:
            logits = self.to_logits(embed)
        return TransformerOutput(logits=logits.reshape(b, cam, hw, -1),
                                 embed=embed)


class SelfCriticHead(nn.Module):
    """Linear real/fake head over transformer embeddings."""

    def __init__(self, dim: int, dtype, param_dtype=None):
        super().__init__()
        self.to_pred = Dense(dim, 1, True, dtype, param_dtype)

    def forward(self, embed: torch.Tensor) -> torch.Tensor:
        return self.to_pred(embed)[..., 0]
