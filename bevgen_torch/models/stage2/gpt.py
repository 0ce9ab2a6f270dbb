"""Autoregressive sparse GPT over the multi-camera token sequence.

Port of `bevgen_tpu/models/stage2/gpt.py` (`SparseGPT`, `SparseGPTBlock`,
`TorchLayerNorm`): tokens are permuted into the cross-camera "outward"
decode order, run through pre-LN blocks whose self-attention uses the
per-head block-sparse layouts and the index rule of the sequence (and
optionally the learned camera bias), and the logits are un-permuted.

The reference's quirks, kept for checkpoint fidelity:
  * the attention has NO output projection: q/k/v Linears only, the heads
    re-concatenated raw;
  * a block's first residual adds onto the LayerNormed input
    (`x = ln1(x); x = x + attn`);
  * when not sampling, the last token of the last camera becomes the extra
    `vocab_size` id before embedding;
  * the sequence is padded to `gpt_block_size` with embeddings of the
    `vocab_size` id;
  * the camera bias is the full (L, L) parameter times the static tril plus
    `camera_bias_matrix`, added to the RAW attention scores;
  * logits shift by `[nc-1:-1]` (position p predicts token p+1), then are
    un-permuted to raw (cam, h, w) order;
  * dropout (`embd_pdrop` on the padded sequence, `resid_pdrop` on each MLP
    output) only when the forward is not deterministic.

Linear and embedding weights and the positional tables are stored in
`param_dtype` and cast to the compute `dtype` at use (the reference keeps
fp32 params and computes in `dtype`); LayerNorms and the camera-bias table
are fp32. The attention core is `ops.block_sparse.SparseAttention`: the
CUDA kernel for CUDA tensors, the dense masked version for CPU tensors.
Submodule names mirror the reference's parameter tree (`block_{i}`,
`ln1/norm`, `query`, `x_tok_emb`, ...), so `core/convert.py` maps one onto
the other.

Tensor parallelism (`parallel/tensor.py:shard_module_`, serving only: the
AR training step keeps the model whole on every rank, as the JAX package
does): each block keeps `num_heads / tp` heads, its `query`, `key`,
`value` and `mlp_fc` column-split and `mlp_proj` row-split (biases whole,
each rank using its part); the attention has no out-projection, so the
ranks' heads are gathered (`gather_from_tp`) before the residual add; the
`head` is column-split and its logits gathered. The block-sparse attention
runs on this rank's heads' layouts.

`cfg.quant == "int8"` builds the serving tree of
`ops.quant.quantize_gpt_tree`: the six dense layers (`query`, `key`,
`value`, `mlp_fc`, `mlp_proj`, `head`) become `ops.quant.Int8WeightDense`
(int8 weights, the product in the compute dtype). Only the KV-cached
decoder (`ar_cached.py`) serves that tree; the full forward raises, as the
reference's module cannot run it either. Under tp the int8 layers split as
the float ones do (`scale` with the output axis): the column-split ones
take their part of the bias, and the row-split `mlp_proj` sums its raw
products over tp before the scale and the bias.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from bevgen_torch.core.config import MultiViewConfig
from bevgen_torch.models import geometry, masks
from bevgen_torch.models.stage2.transformer import Dense, Embed
from bevgen_torch.ops.block_sparse import SparseAttention
from bevgen_torch.ops.quant import Int8WeightDense
from bevgen_torch.parallel import tensor as tpar
from bevgen_torch.parallel.tensor import copy_to_tp, gather_from_tp


def gpt_dense(cfg: MultiViewConfig, in_f: int, out_f: int, bias: bool, dtype,
              param_dtype=None) -> nn.Module:
    """One of the six dense layers: `Dense`, or under int8 the
    int8-weight `Int8WeightDense`."""
    if cfg.quant == "int8":
        return Int8WeightDense(in_f, out_f, bias, dtype, param_dtype)
    return Dense(in_f, out_f, bias, dtype, param_dtype)


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator) -> torch.Tensor:
    """flax `nn.Dropout`: keep each entry with probability 1 - rate and scale
    the kept ones by 1 / (1 - rate); the mask is drawn from `generator`."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class TorchLayerNorm(nn.Module):
    """LayerNorm with scale and bias, eps 1e-5, computed in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        n = self.norm
        return F.layer_norm(x.float(), n.normalized_shape, n.weight, n.bias,
                            n.eps).to(dtype)


class SparseGPTBlock(nn.Module):
    def __init__(self, cfg: MultiViewConfig, dtype, param_dtype=None):
        super().__init__()
        d, hid = cfg.num_embed, cfg.hidden_size
        self.cfg, self.dtype = cfg, dtype
        self.ln1 = TorchLayerNorm(d)
        self.query = gpt_dense(cfg, d, hid, True, dtype, param_dtype)
        self.key = gpt_dense(cfg, d, hid, True, dtype, param_dtype)
        self.value = gpt_dense(cfg, d, hid, True, dtype, param_dtype)
        self.ln2 = TorchLayerNorm(d)
        self.mlp_fc = gpt_dense(cfg, d, 4 * d, True, dtype, param_dtype)
        self.mlp_proj = gpt_dense(cfg, 4 * d, d, True, dtype, param_dtype)
        self.mesh = None
        self.local_heads = cfg.num_heads

    def tp_ready(self, mesh) -> None:
        """After `tensor.shard_module_`: this rank's heads / tp heads."""
        h = self.cfg.num_heads
        if h % mesh.tp or not tpar.is_split(self.query):
            raise ValueError(f"{h} heads do not split over tp={mesh.tp}")
        self.mesh, self.local_heads = mesh, h // mesh.tp

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """mlp_proj sums over tp when the MLP is split."""
        h = self.ln2(x, self.dtype)
        if tpar.is_split(self.mlp_fc):
            h = copy_to_tp(h, self.mesh)
        return self.mlp_proj(F.gelu(self.mlp_fc(h), approximate="none"))

    def qkv(self, xn: torch.Tensor):
        """(q, k, v) of this rank's heads, each (b, h, L, dh)."""
        b, L, _ = xn.shape
        h = self.local_heads
        xn = copy_to_tp(xn, self.mesh)
        return tuple(proj(xn).reshape(b, L, h, -1).transpose(1, 2)
                     for proj in (self.query, self.key, self.value))

    def merge_heads(self, attn: torch.Tensor) -> torch.Tensor:
        """(b, h, L, dh) of this rank's heads -> (b, L, hidden) of every
        head, in the compute dtype."""
        b, h, L, dh = attn.shape
        attn = attn.transpose(1, 2).reshape(b, L, h * dh).to(self.dtype)
        return gather_from_tp(attn, self.mesh)

    def forward(self, x: torch.Tensor, bias, attn_fn,
                resid_drop: Optional[Callable] = None) -> torch.Tensor:
        xn = self.ln1(x, self.dtype)
        q, k, v = self.qkv(xn)
        attn = attn_fn(q, k, v, bias)                        # (b, h, L, dh)
        # reference quirk: the residual adds onto the normalised input
        x = xn + self.merge_heads(attn)
        mh = self.mlp(x)
        if resid_drop is not None:
            mh = resid_drop(mh)
        return x + mh


class SparseGPT(nn.Module):
    """The full AR model. `dtype` is the compute dtype, `param_dtype`
    (default: `dtype`) the storage of the Linear, embedding and positional
    weights."""

    def __init__(self, cfg: MultiViewConfig, dtype=torch.float32,
                 param_dtype=None):
        super().__init__()
        if cfg.hidden_size % cfg.num_heads:
            raise ValueError("hidden_size must be a multiple of num_heads")
        self.cfg, self.dtype = cfg, dtype
        pdt = param_dtype or dtype
        d, nc, L = cfg.num_embed, cfg.num_cond_tokens, cfg.gpt_block_size
        self.x_tok_emb = Embed(cfg.vocab_size + 1, d, dtype, pdt)
        if cfg.image_embed:
            self.img_embed = Dense(4, d, False, dtype, pdt)
            self.cam_embed = Dense(4, d, False, dtype, pdt)
            self.register_buffer("plane", torch.from_numpy(
                geometry.image_plane(cfg).reshape(3, -1).copy()), persistent=False)
        self.cond_tok_emb = Embed(cfg.cond_vocab_size, d, dtype, pdt)
        if cfg.bev_embed:
            self.bev_embed = Dense(2, d, True, dtype, pdt)
            self.bev_cam_pos_emb = nn.Parameter(
                torch.zeros(1, cfg.num_cams, nc, d, dtype=pdt))
            self.register_buffer("bev_grid", torch.from_numpy(
                geometry.get_bev_grid(cfg)[:2].reshape(2, -1).T.copy()),
                persistent=False)
        self.x_pos_emb = nn.Parameter(torch.zeros(1, cfg.num_img_tokens, d,
                                                  dtype=pdt))
        self.cond_pos_emb = nn.Parameter(torch.zeros(1, nc, d, dtype=pdt))
        if cfg.camera_bias:
            self.camera_bias_emb = nn.Parameter(torch.zeros(L, L))
            self.register_buffer("tril", torch.tril(torch.ones(L, L)),
                                 persistent=False)
            self.register_buffer("bias_prior", torch.from_numpy(
                masks.camera_bias_matrix(cfg)), persistent=False)
        for i in range(cfg.num_layers):
            self.add_module(f"block_{i}", SparseGPTBlock(cfg, dtype, pdt))
        self.ln_f = TorchLayerNorm(d)
        self.head = gpt_dense(cfg, d, cfg.vocab_size, False, dtype, pdt)

        fwd, bwd = geometry.decode_order(cfg)
        self.register_buffer("fwd_order", torch.from_numpy(fwd), persistent=False)
        self.register_buffer("bwd_order", torch.from_numpy(bwd), persistent=False)
        self.attn = SparseAttention(masks.sparse_masks(cfg).layouts,
                                    cfg.sparse_block_size, nc,
                                    cfg.num_pad_tokens)
        self.mesh = None

    def tp_ready(self, mesh) -> None:
        """After `tensor.shard_module_`: the attention over this rank's
        heads' layouts; the logits gathered where `head` was cut."""
        h = self.cfg.num_heads // mesh.tp
        layouts = masks.sparse_masks(self.cfg).layouts
        self.attn = SparseAttention(
            layouts[mesh.tp_rank * h:(mesh.tp_rank + 1) * h],
            self.cfg.sparse_block_size, self.cfg.num_cond_tokens,
            self.cfg.num_pad_tokens)
        self.mesh = mesh

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head over final-normed `x`: every rank's vocabulary columns."""
        x = self.ln_f(x, self.dtype)
        if tpar.is_split(self.head):
            return gather_from_tp(self.head(copy_to_tp(x, self.mesh)),
                                  self.mesh)
        return self.head(x)

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.cfg.num_layers)]

    def camera_bias(self):
        """The (L, L) fp32 additive attention bias, or None."""
        if not self.cfg.camera_bias:
            return None
        return self.camera_bias_emb * self.tril + self.bias_prior

    def ray_embedding(self, intrinsics_inv, extrinsics_inv):
        """(ray (b, cam, hw, d) fp32 or None, c_embed (b, cam, d) or None):
        the unit camera-ray embedding of every image token."""
        if not self.cfg.image_embed:
            return None, None
        dt = self.dtype
        pts = torch.einsum("bcij,jn->bcin", intrinsics_inv.float(), self.plane)
        pts = torch.cat([pts, torch.ones_like(pts[:, :, :1])], dim=2)
        E_inv = extrinsics_inv.float()
        dirs = torch.einsum("bcij,bcjn->bcin", E_inv, pts)
        c = E_inv[..., -1]
        d_emb = self.img_embed(dirs.transpose(2, 3).to(dt))
        c_embed = self.cam_embed(c.to(dt))
        ray = (d_emb - c_embed[:, :, None, :]).float()
        ray = ray / (torch.linalg.vector_norm(ray, dim=-1, keepdim=True) + 1e-7)
        return ray, c_embed

    def cond_embedding(self, bev_indices, c_embed):
        """(b, nc, d) condition embeddings with the BEV grid and positions."""
        dt = self.dtype
        cond = self.cond_tok_emb(bev_indices)
        if self.cfg.bev_embed:
            grid_embed = self.bev_embed(self.bev_grid.to(dt))
            c_exp = c_embed[:, :, None, :] if c_embed is not None else 0.0
            bev_cam = (self.bev_cam_pos_emb.to(dt) + c_exp).sum(dim=1)
            cond = cond + (grid_embed[None] - bev_cam)
        return cond + self.cond_pos_emb.to(dt)

    def forward(self, cam_indices, bev_indices, intrinsics_inv,
                extrinsics_inv, sampling: bool = False,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """cam_indices (b, cam, hw), bev_indices (b, nc) -> logits
        (b, num_img_tokens, vocab) in raw (cam, h, w) order.
        deterministic=False applies `embd_pdrop` to the padded sequence and
        `resid_pdrop` to every MLP output, with masks drawn from
        `generator` (which it then needs, where a rate is above 0)."""
        cfg, dt = self.cfg, self.dtype
        if cfg.quant != "none":
            raise NotImplementedError(
                f"the {cfg.quant} GPT serves through the KV-cached decoder "
                f"(ar_cached.ar_sample_cached) only; its full forward takes "
                f"the unquantized tree")
        embd_drop = resid_drop = None
        if not deterministic and max(cfg.embd_pdrop, cfg.resid_pdrop) > 0:
            if generator is None:
                raise ValueError("dropout (deterministic=False) draws its "
                                 "masks from a torch.Generator: pass one")
            if cfg.embd_pdrop > 0:
                embd_drop = functools.partial(dropout, rate=cfg.embd_pdrop,
                                              generator=generator)
            if cfg.resid_pdrop > 0:
                resid_drop = functools.partial(dropout, rate=cfg.resid_pdrop,
                                               generator=generator)
        b, cam, hw = cam_indices.shape
        d, nc, L = cfg.num_embed, cfg.num_cond_tokens, cfg.gpt_block_size
        if not sampling:
            cam_indices = cam_indices.clone()
            cam_indices[:, -1, -1] = cfg.vocab_size
        x = self.x_tok_emb(cam_indices)                          # (b,cam,hw,d)
        ray, c_embed = self.ray_embedding(intrinsics_inv, extrinsics_inv)
        if ray is not None:
            x = x + ray.to(dt)
        cond = self.cond_embedding(bev_indices, c_embed)
        x = x.reshape(b, cam * hw, d) + self.x_pos_emb.to(dt)[:, :cam * hw]
        seq = torch.cat([cond, x[:, self.fwd_order]], dim=1)     # decode order
        pad_len = L - seq.shape[1]
        if pad_len > 0:
            pad_ids = torch.full((b, pad_len), cfg.vocab_size,
                                 dtype=torch.long, device=seq.device)
            seq = torch.cat([seq, self.x_tok_emb(pad_ids)], dim=1)
        bias = self.camera_bias()
        if embd_drop is not None:
            seq = embd_drop(seq)
        for blk in self.blocks():
            seq = blk(seq, bias, self.attn, resid_drop)
        logits = self.logits(seq)
        logits = logits[:, :L - pad_len]
        # logits at position p predict token p+1
        return logits[:, nc - 1:-1][:, self.bwd_order]
