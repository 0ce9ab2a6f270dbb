"""Block-sparse attention, forward and backward: the hand-written CUDA
kernels and their plain PyTorch versions.

The counterpart of `bevgen_tpu/ops/attention.py` (`make_sparse_attention`,
whose dense oracle is `dense` :62 over `expand_layout_mask` :33, and whose
custom_vjp is :91-123) and of the TPU kernels `block_sparse_attention`
(`bevgen_tpu/ops/pallas/block_sparse.py:182`, kernel body `_kernel_body`
:102) and `block_sparse_attention_bwd` (:439, kernel bodies
`_bwd_dq_kernel` :273 and `_bwd_dkv_kernel` :370). For q, k, v (B,H,L,D), a
per-head block layout (H,nb,nb) and an optional (L,L) fp32 bias:

    out = softmax(where(keep, (q k^T + bias) * scale, -1e9)) v

with the bias added to the RAW scores (DeepSpeed's add_mask) and `keep` the
layout's blocks AND the index rule of the AR sequence (`allowed_mask`):
condition columns `< nc`, causal `col <= row`, and pad rows
(`>= L - num_pad_tokens`) that see only column 0. The per-row logsumexp
(natural log) comes with it when asked for, and the backward recomputes
the softmax from it.

What bounds the kernels on an H100 and what their design does about it is
in `csrc/block_sparse.cu` and `csrc/block_sparse_bwd.cu`. The host side
here plans, once per layout and sequence length, the 64-wide key tiles each
(head, 64-row query tile) visits (`plan_tiles`): any tile that holds a block
active in the layout and allowed by the index rule, each flagged `full`
when every one of its pairs is kept, so that the kernels evaluate the mask
on the partial tiles only. The dk/dv kernel walks the transpose of that
plan, so each listed tile pair is visited once by each pass.

`SparseAttention` dispatches: CPU tensors take the plain forward (which
autograd differentiates); CUDA tensors launch the kernels or raise, through
`BlockSparseAttentionFn` when a gradient is needed and straight to the
forward kernel (no logsumexp) when not. The TPU package sends layouts that
coarsen to dense 128-tiles to XLA; there is no such switch here (a
departure with the card's times, `ROADMAP.md` §3).
"""
from __future__ import annotations

import ctypes
import math
from collections import Counter
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from bevgen_torch.ops import _build

SOURCE = "bevgen_torch/csrc/block_sparse.cu"
REPLACES = "bevgen_tpu/ops/pallas/block_sparse.py:182"
BWD_SOURCE = "bevgen_torch/csrc/block_sparse_bwd.cu"
BWD_REPLACES = "bevgen_tpu/ops/pallas/block_sparse.py:439"
NEG_INF = -1e9
TILE = 64  # the kernels' query and key tile

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def allowed_mask(L: int, num_cond_tokens: int, num_pad_tokens: int = 0,
                 device=None) -> torch.Tensor:
    """The (L, L) bool index rule: condition columns, the causal band, pad
    rows that see only column 0 (the TPU kernel's `_allowed_tile`)."""
    row = torch.arange(L, device=device)[:, None]
    col = torch.arange(L, device=device)[None, :]
    pad = row >= L - num_pad_tokens
    regular = (col < num_cond_tokens) | (col <= row)
    return (~pad & regular) | (pad & (col == 0))


def expand_layout_mask(layout: torch.Tensor, block: int, L: int) -> torch.Tensor:
    """(H, nb, nb) block layout -> (H, L, L) bool."""
    big = layout.repeat_interleave(block, 1).repeat_interleave(block, 2)
    return big[:, :L, :L] > 0


def keep_mask(layout: torch.Tensor, block: int, L: int, num_cond_tokens: int,
              num_pad_tokens: int = 0, device=None) -> torch.Tensor:
    """(H, L, L) bool: the pairs the attention keeps."""
    return (expand_layout_mask(layout.to(device), block, L)
            & allowed_mask(L, num_cond_tokens, num_pad_tokens, device)[None])


def block_sparse_attention_reference(q, k, v, layout: torch.Tensor, block: int,
                                     num_cond_tokens: int,
                                     num_pad_tokens: int = 0,
                                     bias: Optional[torch.Tensor] = None,
                                     scale: Optional[float] = None,
                                     return_lse: bool = False):
    """Dense masked attention in fp32 scores and softmax; the softmax weights
    are rounded to v's dtype before P.V, the output is in v's dtype. lse:
    (B, H, L) fp32 natural-log logsumexp of the masked scores."""
    B, H, L, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    keep = keep_mask(layout, block, L, num_cond_tokens, num_pad_tokens, q.device)
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    if bias is not None:
        s = s + bias.float()[None, None]
    s = torch.where(keep[None], s * scale, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bhjd->bhid", p.float(), v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def block_sparse_attention_bwd_reference(q, k, v, layout: torch.Tensor,
                                         block: int, num_cond_tokens: int,
                                         num_pad_tokens: int,
                                         bias: Optional[torch.Tensor], out, do,
                                         lse, scale: Optional[float] = None
                                         ) -> Grads:
    """Plain PyTorch backward of the block-sparse attention, in fp32 dense
    math, as `block_sparse_attention_bwd` computes it: P recomputed from the
    forward's lse (B, H, L), delta = rowsum(dO * out) from the given `out`,
    dS zero on every pair that is not kept. Returns dq, dk, dv in the input
    dtypes and dbias = scale * sum over (b, h) of dS in fp32 (None without
    a bias)."""
    B, H, L, D = q.shape
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    keep = keep_mask(layout, block, L, num_cond_tokens, num_pad_tokens, q.device)[None]
    qf, kf, vf, g = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhid,bhjd->bhij", qf, kf)
    if bias is not None:
        s = s + bias.float()[None, None]
    s = torch.where(keep, s * scale, torch.full((), NEG_INF, device=q.device))
    p = torch.exp(s - lse.float()[..., None])
    del s
    dp = torch.einsum("bhid,bhjd->bhij", g, vf)
    delta = (g * out.float()).sum(dim=-1, keepdim=True)
    ds = torch.where(keep, p * (dp - delta), torch.zeros((), device=q.device))
    del dp
    dq = torch.einsum("bhij,bhjd->bhid", ds, kf) * scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, qf) * scale
    dv = torch.einsum("bhij,bhid->bhjd", p, g)
    dbias = ds.sum(dim=(0, 1)) * scale if bias is not None else None
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


class TilePlan(NamedTuple):
    counts: np.ndarray   # (H, nt) int32: key tiles of each query tile
    indices: np.ndarray  # (H, nt, nt) int32: those tiles, ascending, 0-padded
    full: np.ndarray     # (H, nt, nt) uint8: 1 where every pair of the
    # listed tile is kept, in the order of `indices` (0-padded)
    # (transposed: the query tiles of each key tile)


def plan_tiles(layout: np.ndarray, block: int, L: int, num_cond_tokens: int,
               num_pad_tokens: int = 0, tile: int = TILE,
               transpose: bool = False) -> TilePlan:
    """Host side: for each (head, query tile of `tile` rows) the key tiles
    that hold a block active in the layout with at least one pair the index
    rule allows. Every pair the kernels must see lies in a listed tile.
    Each listed tile is flagged `full` when every one of its tile x tile
    pairs is kept: it lies wholly inside L, the layout keeps every block it
    touches and the index rule allows every pair (no pad row, no column
    past the causal band outside the condition columns); the kernels skip
    the mask there. transpose=True lists, for each (head, key tile), the
    query tiles whose list holds it, with the same flags: the dk/dv
    kernel's traversal, so each listed pair of tiles is visited once by
    each backward pass."""
    layout = np.asarray(layout) > 0
    H, nb, _ = layout.shape
    if nb * block < L:
        raise ValueError(f"layout of {nb} blocks of {block} does not cover L={L}")
    nbl = nb * block
    allowed = np.zeros((nbl, nbl), bool)
    allowed[:L, :L] = allowed_mask(L, num_cond_tokens, num_pad_tokens).numpy()
    block_ok = allowed.reshape(nb, block, nb, block).any(axis=(1, 3))
    active = layout & block_ok[None]                          # (H, nb, nb)
    nt = -(-L // tile)
    rows = np.zeros((H, nt * tile, nb), bool)
    rows[:, :L] = np.repeat(active, block, axis=1)[:, :L]
    rows = rows.reshape(H, nt, tile, nb)

    def per_tile(row_tiles, reduce):                          # (H, nt, nt)
        cols = np.zeros((H, nt, nt * tile), bool)
        cols[:, :, :L] = np.repeat(row_tiles, block, axis=2)[:, :, :L]
        return reduce(cols.reshape(H, nt, nt, tile), axis=3)

    coarse = per_tile(rows.any(axis=2), np.any)
    # a tile keeps every pair when every block it touches is active and the
    # rule allows every pair (an active block holds an allowed pair, so
    # all(active & rule) = all(layout & rule)); entries past L are False
    rule = np.zeros((nt * tile, nt * tile), bool)
    rule[:L, :L] = allowed[:L, :L]
    rule = rule.reshape(nt, tile, nt, tile).all(axis=(1, 3))  # (nt, nt)
    full = per_tile(rows.all(axis=2), np.all) & rule[None]
    if transpose:
        coarse, full = coarse.transpose(0, 2, 1), full.transpose(0, 2, 1)
    counts = coarse.sum(-1).astype(np.int32)
    order = np.argsort(~coarse, axis=-1, kind="stable")      # listed first
    listed = np.arange(nt) < counts[..., None]
    indices = np.where(listed, order, 0)
    flags = np.where(listed, np.take_along_axis(full, order, axis=-1), False)
    return TilePlan(counts=counts, indices=indices.astype(np.int32),
                    full=flags.astype(np.uint8))


def _fn():
    return _build.function("block_sparse", "block_sparse_fwd_bf16",
                           [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])


def _bwd_fn():
    return _build.function("block_sparse_bwd", "block_sparse_bwd_bf16",
                           [ctypes.c_void_p] * 19 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])


def _check_plan(layout, counts, indices, full, H, L, dev, suffix=""):
    nb = layout.shape[1]
    nt = -(-L // TILE)
    _build.check("layout", layout, torch.uint8, (H, nb, nb), dev)
    _build.check("counts" + suffix, counts, torch.int32, (H, nt), dev)
    _build.check("indices" + suffix, indices, torch.int32, (H, nt, nt), dev)
    _build.check("full" + suffix, full, torch.uint8, (H, nt, nt), dev)
    return nb, nt


def block_sparse_attention_cuda(q, k, v, layout, counts, indices, full,
                                block: int, num_cond_tokens: int,
                                num_pad_tokens: int = 0,
                                bias: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None,
                                return_lse: bool = False):
    """Launch the forward kernel. q, k, v: contiguous bf16 (B,H,L,D) on one
    CUDA device, D = 64; layout: uint8 (H,nb,nb); counts, indices (int32)
    and full (uint8): `plan_tiles` at tile 64; bias: fp32 (L,L) or None.
    Returns out, or (out, lse) with lse the (B,H,L) fp32 natural-log
    logsumexp. Raises on anything the kernel does not take and on a failed
    launch."""
    B, H, L, D = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check(name, t, torch.bfloat16, (B, H, L, D), dev)
    nb, nt = _check_plan(layout, counts, indices, full, H, L, dev)
    if bias is not None:
        _build.check("bias", bias, torch.float32, (L, L), dev)
    if dev.type != "cuda":
        raise ValueError(f"block_sparse_attention_cuda takes CUDA tensors, got {dev}")
    if D != 64:
        raise ValueError(f"head dim {D} not supported by the kernel (64)")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, L), dtype=torch.float32, device=dev)
           if return_lse else None)
    p = _build.ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(p(q), p(k), p(v), p(bias), p(layout), p(counts), p(indices),
                p(full), p(out), p(lse), B, H, L, D, nb, block, nt,
                num_cond_tokens, L - num_pad_tokens, float(scale),
                ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"block_sparse kernel launch failed: CUDA error "
                           f"{err} at B={B} H={H} L={L} D={D} block={block}")
    block_sparse_attention_cuda.launches += 1
    block_sparse_attention_cuda.launches_by_shape[(L, block)] += 1
    return (out, lse) if return_lse else out


def block_sparse_attention_bwd_cuda(q, k, v, layout, counts, indices, full,
                                    counts_t, indices_t, full_t, block: int,
                                    num_cond_tokens: int, num_pad_tokens: int,
                                    bias: Optional[torch.Tensor], out, do, lse,
                                    scale: Optional[float] = None,
                                    need_dbias: bool = True) -> Grads:
    """Launch the backward kernels. q, k, v, out, do: contiguous bf16
    (B,H,L,D) on one CUDA device, D = 64, with out the forward kernel's
    output; lse: its (B,H,L) fp32 logsumexp; layout, counts, indices, full
    as for the forward and counts_t, indices_t, full_t the transposed plan
    (`plan_tiles(..., transpose=True)`); bias: fp32 (L,L) or None. Returns
    dq, dk, dv (bf16) and dbias ((L,L) fp32; None without a bias or with
    need_dbias False, which skips the dbias kernel). Launch counts are kept
    per (L, block, biased). Raises on anything the kernels do not take and
    on a failed launch."""
    B, H, L, D = q.shape
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("do", do)):
        _build.check(name, t, torch.bfloat16, (B, H, L, D), dev)
    _build.check("lse", lse, torch.float32, (B, H, L), dev)
    nb, nt = _check_plan(layout, counts, indices, full, H, L, dev)
    _check_plan(layout, counts_t, indices_t, full_t, H, L, dev, "_t")
    if bias is not None:
        _build.check("bias", bias, torch.float32, (L, L), dev)
    if dev.type != "cuda":
        raise ValueError(f"block_sparse_attention_bwd_cuda takes CUDA tensors, "
                         f"got {dev}")
    if D != 64:
        raise ValueError(f"head dim {D} not supported by the kernel (64)")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, L), dtype=torch.float32, device=dev)
    dbias = (torch.empty((L, L), dtype=torch.float32, device=dev)
             if bias is not None and need_dbias else None)
    p = _build.ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _bwd_fn()(p(q), p(k), p(v), p(bias), p(layout), p(counts), p(indices),
                    p(full), p(counts_t), p(indices_t), p(full_t), p(out),
                    p(do), p(lse), p(delta), p(dq), p(dk), p(dv), p(dbias),
                    B, H, L, D, nb, block, nt,
                    num_cond_tokens, L - num_pad_tokens, float(scale),
                    ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"block_sparse backward launch failed: CUDA error "
                           f"{err} at B={B} H={H} L={L} D={D} block={block}")
    # dq, dk/dv and (when asked for) dbias: one launch each
    n = 3 if dbias is not None else 2
    block_sparse_attention_bwd_cuda.launches += n
    block_sparse_attention_bwd_cuda.launches_by_shape[
        (L, block, bias is not None)] += n
    return dq, dk, dv, dbias


for _f in (block_sparse_attention_cuda, block_sparse_attention_bwd_cuda):
    _f.launches = 0
    _f.launches_by_shape = Counter()


def reset_launch_counts() -> None:
    for f in (block_sparse_attention_cuda, block_sparse_attention_bwd_cuda):
        f.launches = 0
        f.launches_by_shape.clear()


class DevicePlan(NamedTuple):
    layout: torch.Tensor     # (H, nb, nb) uint8
    counts: torch.Tensor     # the forward's plan
    indices: torch.Tensor
    full: torch.Tensor
    counts_t: torch.Tensor   # its transpose, for the dk/dv kernel
    indices_t: torch.Tensor
    full_t: torch.Tensor


class BlockSparseAttentionFn(torch.autograd.Function):
    """Block-sparse attention with its gradient: the counterpart of
    `make_sparse_attention`'s custom_vjp. The forward launches the kernel
    with the logsumexp and saves q, k, v, bias, out and lse; the backward
    launches the backward kernels. Gradients for q, k, v and bias (None
    when the bias is None or needs no gradient: the dbias kernel is then
    skipped)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, plan: DevicePlan, block, num_cond_tokens,
                num_pad_tokens, scale):
        out, lse = block_sparse_attention_cuda(
            q, k, v, plan.layout, plan.counts, plan.indices, plan.full, block,
            num_cond_tokens, num_pad_tokens, bias, scale, return_lse=True)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.plan = plan
        ctx.args = (block, num_cond_tokens, num_pad_tokens)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, lse = ctx.saved_tensors
        plan = ctx.plan
        dq, dk, dv, dbias = block_sparse_attention_bwd_cuda(
            q, k, v, plan.layout, plan.counts, plan.indices, plan.full,
            plan.counts_t, plan.indices_t, plan.full_t, *ctx.args, bias, out,
            dout.to(q.dtype).contiguous(), lse, ctx.scale,
            need_dbias=ctx.needs_input_grad[3])
        return dq, dk, dv, dbias, None, None, None, None, None


class SparseAttention:
    """`attn(q, k, v, bias=None)` for one fixed per-head block layout (the
    counterpart of `make_sparse_attention`). The tile plans and the device
    copies of the layout are built once per (L, device) and kept."""

    def __init__(self, layout: np.ndarray, block: int, num_cond_tokens: int,
                 num_pad_tokens: int = 0, scale: Optional[float] = None):
        self.layout = np.asarray(layout, np.int64)
        self.block = int(block)
        self.num_cond_tokens = int(num_cond_tokens)
        self.num_pad_tokens = int(num_pad_tokens)
        self.scale = scale
        self._device: Dict[Tuple[int, str], DevicePlan] = {}

    def device_plan(self, L: int, device: torch.device) -> DevicePlan:
        """The layout as uint8 and both tile plans, with their full flags,
        on `device` for length L."""
        key = (L, str(device))
        if key not in self._device:
            args = (self.layout, self.block, L, self.num_cond_tokens,
                    self.num_pad_tokens)
            plan, plan_t = plan_tiles(*args), plan_tiles(*args, transpose=True)
            self._device[key] = DevicePlan(*(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.layout.astype(np.uint8), plan.counts,
                          plan.indices, plan.full, plan_t.counts,
                          plan_t.indices, plan_t.full)))
        return self._device[key]

    def __call__(self, q, k, v, bias: Optional[torch.Tensor] = None,
                 return_lse: bool = False):
        if q.device.type == "cpu":
            return block_sparse_attention_reference(
                q, k, v, torch.from_numpy(self.layout), self.block,
                self.num_cond_tokens, self.num_pad_tokens, bias, self.scale,
                return_lse)
        if q.device.type != "cuda":
            raise ValueError(f"no block-sparse attention for device {q.device}")
        plan = self.device_plan(q.shape[2], q.device)
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if bias is not None:
            bias = bias.float().contiguous()
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, bias)):
            if return_lse:
                raise ValueError("return_lse is for calls without gradients")
            return BlockSparseAttentionFn.apply(
                q, k, v, bias, plan, self.block, self.num_cond_tokens,
                self.num_pad_tokens, self.scale)
        return block_sparse_attention_cuda(
            q, k, v, plan.layout, plan.counts, plan.indices, plan.full,
            self.block, self.num_cond_tokens, self.num_pad_tokens, bias,
            self.scale, return_lse)
