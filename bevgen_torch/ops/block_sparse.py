"""Block-sparse attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

The counterpart of `bevgen_tpu/ops/attention.py` (`make_sparse_attention`,
whose dense oracle is `dense` :62 over `expand_layout_mask` :33) and of the
forward of the TPU kernel `block_sparse_attention`
(`bevgen_tpu/ops/pallas/block_sparse.py:182`, kernel body `_kernel_body`
:102). For q, k, v (B,H,L,D), a per-head block layout (H,nb,nb) and an
optional (L,L) fp32 bias:

    out = softmax(where(keep, (q k^T + bias) * scale, -1e9)) v

with the bias added to the RAW scores (DeepSpeed's add_mask) and `keep` the
layout's blocks AND the index rule of the AR sequence (`allowed_mask`):
condition columns `< nc`, causal `col <= row`, and pad rows
(`>= L - num_pad_tokens`) that see only column 0. The per-row logsumexp
(natural log) comes with it when asked for.

What bounds the kernel on an H100 and what its design does about it is in
`csrc/block_sparse.cu`. The host side here plans, once per layout and
sequence length, the 64-wide key tiles each (head, 64-row query tile)
visits (`plan_tiles`): any tile that holds a block active in the layout
and allowed by the index rule.

`SparseAttention` dispatches: CPU tensors take the plain version (which
autograd differentiates); CUDA tensors launch the kernel or raise. The
TPU package sends layouts that coarsen to dense 128-tiles to XLA; there is
no such switch here. The backward (TPU `block_sparse_attention_bwd` :439)
is not ported yet: a CUDA call that needs a gradient raises.
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
NEG_INF = -1e9
TILE = 64  # the kernel's query and key tile


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
    keep = (expand_layout_mask(layout.to(q.device), block, L)
            & allowed_mask(L, num_cond_tokens, num_pad_tokens, q.device)[None])
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float())
    if bias is not None:
        s = s + bias.float()[None, None]
    s = torch.where(keep[None], s * scale, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bhij,bhjd->bhid", p.float(), v.float()).to(v.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


class TilePlan(NamedTuple):
    counts: np.ndarray   # (H, nt) int32: key tiles each query tile visits
    indices: np.ndarray  # (H, nt, nt) int32: those tiles, ascending, 0-padded


def plan_tiles(layout: np.ndarray, block: int, L: int, num_cond_tokens: int,
               num_pad_tokens: int = 0, tile: int = TILE) -> TilePlan:
    """Host side: for each (head, query tile of `tile` rows) the key tiles
    that hold a block active in the layout with at least one pair the index
    rule allows. Every pair the kernel must see lies in a listed tile."""
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
    rows = rows.reshape(H, nt, tile, nb).any(axis=2)          # (H, nt, nb)
    cols = np.zeros((H, nt, nt * tile), bool)
    cols[:, :, :L] = np.repeat(rows, block, axis=2)[:, :, :L]
    coarse = cols.reshape(H, nt, nt, tile).any(axis=3)        # (H, nt, nt)
    counts = coarse.sum(-1).astype(np.int32)
    order = np.argsort(~coarse, axis=-1, kind="stable")      # listed first
    indices = np.where(np.arange(nt) < counts[..., None], order, 0)
    return TilePlan(counts=counts, indices=indices.astype(np.int32))


def _fn():
    return _build.function("block_sparse", "block_sparse_fwd_bf16",
                           [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                           + [ctypes.c_float, ctypes.c_void_p])


def block_sparse_attention_cuda(q, k, v, layout, counts, indices, block: int,
                                num_cond_tokens: int, num_pad_tokens: int = 0,
                                bias: Optional[torch.Tensor] = None,
                                scale: Optional[float] = None,
                                return_lse: bool = False):
    """Launch the CUDA kernel. q, k, v: contiguous bf16 (B,H,L,D) on one
    CUDA device, D = 64; layout: uint8 (H,nb,nb); counts, indices:
    int32, `plan_tiles` at tile 64; bias: fp32 (L,L) or None. Returns out,
    or (out, lse) with lse the (B,H,L) fp32 natural-log logsumexp. Raises on
    anything the kernel does not take and on a failed launch."""
    B, H, L, D = q.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"block_sparse_attention_cuda takes CUDA tensors, got {dev}")
    if D != 64:
        raise ValueError(f"head dim {D} not supported by the kernel (64)")
    nb = layout.shape[1]
    nt = -(-L // TILE)
    check = _build.check
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(name, t, torch.bfloat16, (B, H, L, D), dev)
    check("layout", layout, torch.uint8, (H, nb, nb), dev)
    check("counts", counts, torch.int32, (H, nt), dev)
    check("indices", indices, torch.int32, (H, nt, nt), dev)
    if bias is not None:
        check("bias", bias, torch.float32, (L, L), dev)
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, L), dtype=torch.float32, device=dev)
           if return_lse else None)
    p = _build.ptr
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(p(q), p(k), p(v), p(bias), p(layout), p(counts), p(indices),
                p(out), p(lse), B, H, L, D, nb, block, nt, num_cond_tokens,
                L - num_pad_tokens, float(scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"block_sparse kernel launch failed: CUDA error "
                           f"{err} at B={B} H={H} L={L} D={D} block={block}")
    block_sparse_attention_cuda.launches += 1
    block_sparse_attention_cuda.launches_by_shape[(L, block)] += 1
    return (out, lse) if return_lse else out


block_sparse_attention_cuda.launches = 0
block_sparse_attention_cuda.launches_by_shape = Counter()


def reset_launch_counts() -> None:
    block_sparse_attention_cuda.launches = 0
    block_sparse_attention_cuda.launches_by_shape.clear()


class SparseAttention:
    """`attn(q, k, v, bias=None)` for one fixed per-head block layout (the
    counterpart of `make_sparse_attention`). The tile plan and the device
    copies of the layout are built once per (L, device) and kept."""

    def __init__(self, layout: np.ndarray, block: int, num_cond_tokens: int,
                 num_pad_tokens: int = 0, scale: Optional[float] = None):
        self.layout = np.asarray(layout, np.int64)
        self.block = int(block)
        self.num_cond_tokens = int(num_cond_tokens)
        self.num_pad_tokens = int(num_pad_tokens)
        self.scale = scale
        self._device: Dict[Tuple[int, str], Tuple[torch.Tensor, ...]] = {}

    def device_plan(self, L: int, device: torch.device):
        """(layout uint8, counts, indices) on `device` for length L."""
        key = (L, str(device))
        if key not in self._device:
            plan = plan_tiles(self.layout, self.block, L, self.num_cond_tokens,
                              self.num_pad_tokens)
            self._device[key] = tuple(
                torch.from_numpy(np.ascontiguousarray(a)).to(device)
                for a in (self.layout.astype(np.uint8), plan.counts,
                          plan.indices))
        return self._device[key]

    def __call__(self, q, k, v, bias: Optional[torch.Tensor] = None,
                 return_lse: bool = False):
        kw = dict(num_pad_tokens=self.num_pad_tokens, bias=bias,
                  scale=self.scale, return_lse=return_lse)
        if q.device.type == "cpu":
            return block_sparse_attention_reference(
                q, k, v, torch.from_numpy(self.layout), self.block,
                self.num_cond_tokens, **kw)
        if q.device.type != "cuda":
            raise ValueError(f"no block-sparse attention for device {q.device}")
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad for t in (q, k, v, bias)):
            raise NotImplementedError(
                "block-sparse backward not ported yet: the CUDA forward "
                "would return an output without a gradient")
        layout, counts, indices = self.device_plan(q.shape[2], q.device)
        if bias is not None:
            bias = bias.float().contiguous()
        return block_sparse_attention_cuda(
            q.contiguous(), k.contiguous(), v.contiguous(), layout, counts,
            indices, self.block, self.num_cond_tokens, **kw)
