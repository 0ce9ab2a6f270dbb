"""Tensor parallelism: the collectives of a Megatron-style split, and the
slicing of a module's weights over the tp axis.

The JAX package lets GSPMD insert these collectives; here they are written
out as `torch.autograd.Function`s over the mesh's tp group
(`parallel/sharding.py:Mesh.tp_group`):

  copy_to_tp:     identity forward, `all_reduce` of the gradient backward.
                  On the input of every column-parallel product (and on a
                  replicated parameter used inside a rank's share of the
                  work, such as q_scale), so the gradient that reaches the
                  replicated side is the sum over the ranks' shares.
  reduce_from_tp: `all_reduce` forward, identity backward. On the output of
                  every row-parallel product.
  gather_from_tp: `all_gather` along the last axis forward, this rank's
                  slice backward. Every tp rank then computes the same loss
                  from the gathered tensor, so no sum is needed.
  sum_over_tp:    `all_reduce` forward and backward: a statistic that every
                  rank's share feeds and every rank's share reads (the row
                  sums of the split LayerNorm, `layer_norm`, and of the
                  split GEGLU + LayerNorm glue, `ops/fused_glue.py`).

Serving's int8 products (`ops/quant.py`) add two collectives without
autograd, in place: `sum_int_over_tp` (the int32 accumulators of a
row-split product, an exact sum) and `max_over_tp` (the per-row amax of a
row-split dynamic quantization).

Only `all_reduce` and `all_gather` are used, in the tensor's own dtype
(gloo runs both on CUDA tensors as well, through the host). A bf16 sum over
two ranks rounds once, as the fp32 sum of one process rounds its product
once. Without a mesh or at tp = 1 every function is the identity.

`shard_module_(module, mesh)` cuts a module's parameters, in place, to
this rank's tp slices as `sharding.tp_plan` says, by meaning (`take_part`:
a rank's heads of k then of v in `to_kv`, its columns of a then of gate in
`proj_in`), records the split on each owner module (`_tp_split`,
`tp_layout`), and hands the mesh to every module with a `tp_ready` hook.
`gather_tp` and `join_parts` put the slices back together.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn


def active(mesh) -> bool:
    """True when `mesh` splits the weights (tp > 1)."""
    return mesh is not None and mesh.tp > 1


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: `t` summed over `group`."""
    out = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out


def _all_gather(t: torch.Tensor, mesh) -> List[torch.Tensor]:
    """Every tp rank's `t`, in rank order."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.tp)]
    dist.all_gather(parts, t, group=mesh.tp_group)
    return parts


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh.tp_group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _all_reduce(x, mesh.tp_group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return torch.cat(_all_gather(x, mesh), dim=-1)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.width
        return grad[..., ctx.mesh.tp_rank * n:(ctx.mesh.tp_rank + 1) * n
                    ].contiguous(), None


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x, mesh.tp_group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.mesh.tp_group), None


def copy_to_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToTP.apply(x, mesh) if active(mesh) else x


def reduce_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _ReduceFromTP.apply(x, mesh) if active(mesh) else x


def gather_from_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherFromTP.apply(x, mesh) if active(mesh) else x


def sum_over_tp(x: torch.Tensor, mesh) -> torch.Tensor:
    return _SumOverTP.apply(x, mesh) if active(mesh) else x


def sum_int_over_tp(acc: torch.Tensor, mesh) -> torch.Tensor:
    """`acc` (int32, contiguous) summed over tp in place, no autograd: the
    partial accumulators of a row-split int8 product. Integer sums are
    exact, so every rank holds the one-process product bit for bit."""
    if active(mesh):
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.tp_group)
    return acc


def max_over_tp(t: torch.Tensor, mesh) -> torch.Tensor:
    """`t` (contiguous) as its elementwise maximum over tp, in place, no
    autograd: a row's amax over every rank's columns."""
    if active(mesh):
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.tp_group)
    return t


def layer_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
               mesh) -> torch.Tensor:
    """Scale-only LayerNorm in fp32 over a last axis split over tp: `x`
    holds this rank's columns and `weight` their gains. The row mean and
    then the variance about it are each one `sum_over_tp` of per-row
    partial sums (two passes, as a one-process norm computes them)."""
    x = x.float()
    n = x.shape[-1] * mesh.tp
    mean = sum_over_tp(x.sum(-1, keepdim=True), mesh) / n
    xc = x - mean
    var = sum_over_tp((xc * xc).sum(-1, keepdim=True), mesh) / n
    return xc * torch.rsqrt(var + eps) * weight.float()


# ---------------------------------------------------------------------------
# slices by meaning
# ---------------------------------------------------------------------------


def _index(t, axis: int, start: int, n: int):
    return t[(slice(None),) * axis + (slice(start, start + n),)]


def _cat(pieces: Sequence, axis: int):
    if isinstance(pieces[0], torch.Tensor):
        return torch.cat(list(pieces), dim=axis)
    return np.concatenate(pieces, axis=axis)


def take_part(t, axis: int, halves: int, tp: int, rank: int):
    """Rank `rank`'s tp slice of `t` (numpy array or tensor) along `axis`:
    its 1/tp of each of the `halves` equal parts of that axis, in order."""
    n = t.shape[axis] // (halves * tp)
    pieces = [_index(t, axis, (h * tp + rank) * n, n) for h in range(halves)]
    return pieces[0] if halves == 1 else _cat(pieces, axis)


def join_parts(parts: Sequence, axis: int, halves: int):
    """The inverse of `take_part` over every rank's slice, in rank order."""
    n = parts[0].shape[axis] // halves
    return _cat([_index(p, axis, h * n, n) for h in range(halves)
                 for p in parts], axis)


def tp_layout(module: nn.Module) -> Dict[str, Tuple[int, int]]:
    """Parameter name -> (port axis, halves) of every tp-sliced parameter of
    `module` (empty when it is not tensor-parallel)."""
    out = {}
    for prefix, m in module.named_modules():
        for leaf, split in getattr(m, "_tp_split", {}).items():
            out[f"{prefix}.{leaf}" if prefix else leaf] = split
    return out


@torch.no_grad()
def shard_module_(module: nn.Module, mesh) -> nn.Module:
    """Cut `module`'s parameters, in place, to this rank's tp slices
    (`sharding.tp_plan` on each parameter's flax path and whole shape;
    `take_part` by meaning), then hand `mesh` to every submodule with a
    `tp_ready(mesh)` hook. The parameters stay the same objects. At
    tp = 1 nothing changes."""
    from bevgen_torch.core.convert import flax_leaf
    from bevgen_torch.parallel.sharding import tp_axis, tp_halves
    if not active(mesh):
        return module
    if tp_layout(module):
        raise ValueError("the module is already tensor-parallel")
    for name, p in module.named_parameters():
        path, perm = flax_leaf(module, name)
        ax = tp_axis(path, [p.shape[a] for a in perm], mesh.tp)
        if ax is None:
            continue
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        split = (perm[ax], tp_halves(path))
        p.data = take_part(p.data, *split, mesh.tp, mesh.tp_rank).clone()
        owner.__dict__.setdefault("_tp_split", {})[leaf] = split
    for m in module.modules():
        if hasattr(m, "tp_ready"):
            m.tp_ready(mesh)
    return module


def is_split(module: nn.Module, leaf: Optional[str] = None) -> bool:
    """Whether `module`'s parameter `leaf` is a tp slice; by default its
    product's weight (`weight`, or the int8 modules' `kernel_q`)."""
    if leaf is None:
        return split_axis(module) is not None
    return leaf in getattr(module, "_tp_split", {})


def split_axis(module: nn.Module) -> Optional[int]:
    """The port axis along which `module`'s product weight is cut (0: the
    output axis, a column-split product; 1: the input axis, a row-split
    one), or None when it is whole."""
    splits = getattr(module, "_tp_split", {})
    for leaf in ("weight", "kernel_q"):
        if leaf in splits:
            return splits[leaf][0]
    return None


def gather_tp(tensors: Mapping[str, torch.Tensor],
              splits: Mapping[str, Optional[Tuple[int, int]]],
              mesh) -> Dict[str, torch.Tensor]:
    """The unsliced tensors: each entry whose `splits[key]` is (axis,
    halves) gathered over the tp group and joined by meaning, the others as
    they are (a collective over the tp group: every rank calls it with the
    same keys)."""
    out = dict(tensors)
    if not active(mesh):
        return out
    for key, t in tensors.items():
        split = splits.get(key)
        if split is not None:
            out[key] = join_parts(_all_gather(t, mesh), *split)
    return out


def full_state_dict(module: nn.Module, mesh) -> Dict[str, torch.Tensor]:
    """`module.state_dict()` with every tp slice gathered and joined: the
    unsliced layout a one-process run writes (a collective over the tp
    group)."""
    return gather_tp(module.state_dict(), tp_layout(module), mesh)

