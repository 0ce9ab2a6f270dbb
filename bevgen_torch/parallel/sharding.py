"""The (dcn, dp, tp) mesh, the tensor-parallel plan of the weights, ZeRO
slices of the optimizer state, and each rank's rows of a batch.

Port of `bevgen_tpu/parallel/sharding.py`: one process per device. The
batch splits over dcn x dp, the reference's own layout (DDP with DeepSpeed
ZeRO-2, SURVEY §2.8); the stage-2 transformer's heads and FFN hidden split
over tp (Megatron-style, the collectives written out in
`parallel/tensor.py`).

Mesh axes, in the JAX package's rank order (`devices.reshape(dcn, dp, tp)`:
rank = (dcn_index * dp + dp_index) * tp + tp_index, so a tp group is
consecutive ranks, on one node):
  dcn: an outer data-parallel axis across nodes; the gradient sum crosses
       it once per step.
  dp:  data parallel within a node. The optimizer moments and the EMA are
       sliced over dp only (one process group per (dcn row, tp index)),
       replicated across dcn, so their gather stays inside a node.
  tp:  tensor parallel: the ranks of a tp group hold one slice each of the
       weights `tp_plan` splits, and compute the same rows of the batch.
       The gradient sum runs over the ranks that hold the same slice (one
       group per tp index); at tp = 1 every group is the data-parallel one.

ZeRO-1 on `all_reduce` and `all_gather`: every rank sums its (tp-sliced)
gradient over its data group, clips with the global norm, updates its
slice of each parameter with its slice of the moments, and the slices are
gathered back into the parameters, so all ranks of a data group hold the
same parameters bit for bit. Each moment is sliced along the axis the JAX
package's `moment_pspec` picks for it (the largest dp-divisible axis that
no tensor-parallel rule reserves; none for the embedding tables a rule
pins replicated). The port's parameters carry the flax names, so
`_TP_RULES` apply to their flax paths (`core/convert.py:flax_leaf`).

Random draws ignore dp and tp: every rank seeds the same generator, draws
each random tensor at the global batch's shape and keeps its data row's
rows (`BatchShard.rand`), so a run over any mesh draws what one process
draws for the whole batch, and the tp ranks of a row draw alike.

The JAX `host_shard_batch` (one global array from every process's rows)
has no counterpart: a rank's local batch is its part of the global batch
as it stands. `shard_batch` cuts this rank's rows from a global batch that
every rank holds.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from bevgen_torch.parallel import distributed

# ---------------------------------------------------------------------------
# each rank's rows of a batch
# ---------------------------------------------------------------------------


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """Rows [start, start + b) of a global batch of `total` rows; `reduce`
    sums a tensor over the ranks that share the batch (the identity in one
    process)."""
    total: int
    start: int
    reduce: Callable[[torch.Tensor], torch.Tensor] = _identity

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return self.reduce(t)

    def rand(self, shape: Sequence[int], generator: Optional[torch.Generator],
             device) -> torch.Tensor:
        """This rank's rows of U[0, 1) drawn at the global batch's shape."""
        b = shape[0]
        if self.start + b > self.total:
            raise ValueError(f"rows {self.start}..{self.start + b} of a batch "
                             f"of {self.total}")
        full = torch.rand((self.total, *shape[1:]), generator=generator,
                          device=device)
        return full[self.start:self.start + b]


def rand_rows(shape: Sequence[int], generator: Optional[torch.Generator],
              device, shard: Optional[BatchShard] = None) -> torch.Tensor:
    """U[0, 1) of `shape`: drawn directly, or as `shard`'s rows of a draw at
    the global batch (shapes with a batch axis). Every random tensor of the
    losses and samplers that has a batch axis is drawn here."""
    if shard is None or len(shape) == 0:
        return torch.rand(tuple(shape), generator=generator, device=device)
    return shard.rand(shape, generator, device)


# ---------------------------------------------------------------------------
# collectives on flat buffers
# ---------------------------------------------------------------------------


def _flat_groups(tensors: Sequence[torch.Tensor]):
    """Indices of `tensors` grouped by dtype (one flat buffer each)."""
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups.values()


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]
           ) -> List[torch.Tensor]:
    out, offset = [], 0
    for t in like:
        out.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def flat_apply(tensors: Sequence[torch.Tensor],
               fn: Callable[[torch.Tensor], None]) -> List[torch.Tensor]:
    """Run the in-place collective `fn` once per dtype on one flat buffer
    holding `tensors`; returns the results as views into those buffers, in
    the order of `tensors`."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in _flat_groups(tensors):
        ts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in ts])
        fn(flat)
        for i, v in zip(idx, _split(flat, ts)):
            out[i] = v
    return out


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Mesh:
    """A (dcn, dp, tp) mesh over the processes of the default group, in
    rank order (rank = (dcn_index * dp + dp_index) * tp + tp_index).

    group: the world's group, None in one process without a group (every
    collective is then the identity); dp_group: the ranks of this rank's
    dcn row with its tp index, over which the ZeRO slices are gathered;
    device: where the collectives' own small tensors live (a CUDA device
    for nccl). tp_group: this rank's tp group (None at tp = 1);
    data_group: the ranks with this rank's tp index, over which the
    gradients and the losses' counts are summed (the world at tp = 1)."""
    dcn: int
    dp: int
    rank: int
    group: Optional[dist.ProcessGroup]
    dp_group: Optional[dist.ProcessGroup]
    device: torch.device
    owns_group: bool = False    # close() leaves the default group
    tp: int = 1
    tp_group: Optional[dist.ProcessGroup] = None
    data_group: Optional[dist.ProcessGroup] = None

    def __post_init__(self):
        if self.data_group is None and self.tp == 1:
            self.data_group = self.group

    @property
    def shape(self) -> Dict[str, int]:
        if self.dcn > 1:
            return {"dcn": self.dcn, "dp": self.dp, "tp": self.tp}
        return {"dp": self.dp, "tp": self.tp}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        """The data-parallel ways, dcn * dp."""
        return self.dcn * self.dp

    @property
    def world(self) -> int:
        return self.size * self.tp

    @property
    def data_rank(self) -> int:
        """This rank's row of the batch: dcn_index * dp + dp_index."""
        return self.rank // self.tp

    @property
    def dp_rank(self) -> int:
        return self.data_rank % self.dp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    def batch_shard(self, rows: int) -> BatchShard:
        """This rank's place in a global batch of `rows` rows per data row."""
        return BatchShard(rows * self.size, self.data_rank * rows, self.sum)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: `t` summed over the data group."""
        t = t.clone()
        if self.data_group is not None:
            dist.all_reduce(t, group=self.data_group)
        return t

    def sum_all(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """`tensors` summed over the data group, in one collective per
        dtype."""
        if self.data_group is None:
            return list(tensors)
        return flat_apply(tensors, lambda f: dist.all_reduce(
            f, group=self.data_group))

    def tp_sum(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: `t` summed over the tp group."""
        t = t.clone()
        if self.tp_group is not None:
            dist.all_reduce(t, group=self.tp_group)
        return t

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any rank."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor],
                   group: Optional[dist.ProcessGroup] = None) -> None:
        """The first rank's `tensors` into every rank's, in place: rank 0's
        over the world, or over `group` (a tp group: its first rank's)."""
        group = self.group if group is None else group
        if group is None:
            return
        tensors = [t.detach() for t in tensors]
        src = dist.get_global_rank(group, 0)
        got = flat_apply(tensors, lambda f: dist.broadcast(
            f, src=src, group=group))
        for t, v in zip(tensors, got):
            t.copy_(v)

    def broadcast_module(self, module: nn.Module) -> nn.Module:
        """Rank 0's parameters into every rank's `module`, in place."""
        self.broadcast_(list(module.parameters()))
        return module

    def close(self) -> None:
        """Leave the default group when this mesh's maker joined it."""
        if self.owns_group:
            distributed.shutdown()

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every data row's `t` (equal shapes) concatenated along axis 0 in
        row order: the global batch from each row's rows."""
        if self.data_group is None or self.size == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.data_group)
        return torch.cat(parts)


def mesh_layout(n: int, dp: Optional[int] = None, tp: int = 1,
                dcn: int = 1) -> Tuple[int, int]:
    """(dcn, dp) of a (dcn, dp, tp) mesh over all `n` processes: dp =
    n // (dcn * tp) when not given; the product must be n (every rank takes
    part)."""
    if dp is None:
        if n % (dcn * tp):
            raise ValueError(f"{n} processes do not split into dcn={dcn} x "
                             f"tp={tp}")
        dp = n // (dcn * tp)
    if dcn * dp * tp != n:
        raise ValueError(f"a dcn={dcn} x dp={dp} x tp={tp} mesh needs "
                         f"{dcn * dp * tp} processes; {n} were started")
    return dcn, dp


def multislice_layout(n: int, slice_index_of: Callable[[int], int]
                      ) -> Tuple[int, int]:
    """(dcn, ranks per node) of a mesh whose dcn rows are the nodes: ranks
    grouped by `slice_index_of(rank)`, one row per node. The ranks of a
    node must be contiguous (torchrun numbers them so) and the nodes of
    equal size."""
    groups: Dict[int, List[int]] = {}
    for r in range(n):
        groups.setdefault(slice_index_of(r), []).append(r)
    if len(groups) <= 1:
        return 1, n
    sizes = {len(v) for v in groups.values()}
    if len(sizes) != 1:
        raise ValueError(f"unequal ranks per node {sorted(sizes)}")
    ordered = [r for k in sorted(groups) for r in groups[k]]
    if ordered != list(range(n)):
        raise ValueError("the ranks of each node are not contiguous: "
                         f"{[groups[k] for k in sorted(groups)]}")
    return len(groups), sizes.pop()


def _groups(ranks: Iterable[List[int]], rank: int, world: int
            ) -> Optional[dist.ProcessGroup]:
    """One process group per list of `ranks` (every rank creates every
    group, in order); the one holding `rank`. A list of the whole world is
    the world's group."""
    mine = None
    for members in ranks:
        g = (dist.group.WORLD if len(members) == world
             else dist.new_group(members))
        if rank in members:
            mine = g
    return mine


def make_mesh(dp: Optional[int] = None, tp: int = 1, dcn: int = 1,
              device="cpu") -> Mesh:
    """The (dcn, dp, tp) mesh over every process of the default group (one
    process without a group: a mesh of one). Its groups: one tp group per
    data row, one data group per tp index, one dp group per (dcn row, tp
    index); every rank creates every group, in that order."""
    n = distributed.process_count()
    dcn, dp = mesh_layout(n, dp, tp, dcn)
    rank = distributed.process_index()
    if not dist.is_initialized():
        return Mesh(dcn, dp, rank, None, None, torch.device(device), tp=tp)
    rows = dcn * dp
    tp_group = (_groups([list(range(d * tp, (d + 1) * tp))
                         for d in range(rows)], rank, n) if tp > 1 else None)
    data_group = _groups([list(range(t, n, tp)) for t in range(tp)], rank, n)
    dp_group = data_group if dcn == 1 else _groups(
        [[(row * dp + i) * tp + t for i in range(dp)]
         for row in range(dcn) for t in range(tp)], rank, n)
    return Mesh(dcn, dp, rank, dist.group.WORLD, dp_group,
                torch.device(device), tp=tp, tp_group=tp_group,
                data_group=data_group)


def node_of_rank(rank: int) -> int:
    """The node of a torchrun rank: ranks are numbered node by node, with
    LOCAL_WORLD_SIZE of them on each."""
    per = int(os.environ.get("LOCAL_WORLD_SIZE",
                             distributed.process_count()))
    return rank // per


def make_multislice_mesh(tp: int = 1, device="cpu",
                         slice_index_of: Optional[Callable[[int], int]] = None
                         ) -> Mesh:
    """The mesh of a multi-node job (`dcn=auto`): one dcn row per node,
    `slice_index_of` (rank -> node, `node_of_rank` by default) telling
    them apart, dp = the node's ranks / tp; one node gives the plain
    (dp, tp) mesh."""
    dcn, per = multislice_layout(distributed.process_count(),
                                 slice_index_of or node_of_rank)
    if per % tp:
        raise ValueError(f"{per} ranks per node do not split into tp={tp}")
    return make_mesh(dp=per // tp, tp=tp, dcn=dcn, device=device)


def batch_axes(mesh: Mesh) -> tuple:
    """The axes the batch splits over: ('dcn', 'dp') or ('dp',)."""
    return ("dcn", "dp") if mesh.dcn > 1 else ("dp",)


def data_parallelism(mesh: Mesh) -> int:
    """Total data-parallel ways (dcn * dp)."""
    return mesh.size


def shard_batch(arrays: Iterable, mesh: Mesh, device) -> Tuple[torch.Tensor, ...]:
    """This rank's data row's rows of global batch arrays (numpy or
    tensors), as tensors on `device`; the batch must split evenly over the
    data-parallel ways."""
    out = []
    for a in arrays:
        b = len(a)
        if b % mesh.size:
            raise ValueError(f"a batch of {b} does not split over "
                             f"{mesh.size} data-parallel ranks")
        sl = distributed.host_shard_indices(b, mesh.data_rank, mesh.size)
        out.append(torch.as_tensor(np.asarray(a[sl]) if not torch.is_tensor(a)
                                   else a[sl], device=device))
    return tuple(out)


# ---------------------------------------------------------------------------
# the tensor-parallel plan of the weights, and where each optimizer moment is
# sliced (the JAX package's rules)
# ---------------------------------------------------------------------------

# flax path regex -> the weight's tensor-parallel spec (a copy of the JAX
# package's rules): column-parallel products split their output axis,
# row-parallel ones their input axis; `moment_pspec` keeps dp off the axes
# these reserve, and keeps the moments of the tables pinned fully
# replicated replicated
_TP_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r".*(to_q|to_kv)/kernel(_q)?$", (None, "tp")),
    (r".*proj_in/kernel(_q)?$", (None, "tp")),
    (r".*(to_out|proj_out)/kernel(_q)?$", ("tp", None)),
    (r".*to_logits/kernel(_q)?$", (None, "tp")),
    (r".*(to_q|to_kv|proj_in|to_logits)/scale$", ("tp",)),
    (r".*(query|key|value|mlp_fc|head)/kernel(_q)?$", (None, "tp")),
    (r".*mlp_proj/kernel(_q)?$", ("tp", None)),
    (r".*(query|key|value|mlp_fc|head)/scale$", ("tp",)),
    (r".*(token_emb|cond_token_emb|pos_emb|cond_pos_emb)/embedding$",
     (None, None)),
    (r".*null_kv$", (None, "tp", None, None)),
)

# outputs that are two tensors side by side, [k | v] and [a | gate]: a rank
# takes its share of each half
_TWO_HALVES = r".*(to_kv|proj_in)/(kernel(_q)?|scale)$"


def match_rule(path: str, ndim: int) -> Optional[Tuple[Optional[str], ...]]:
    """The first rule whose regex matches the flax `path` and whose spec
    fits `ndim` axes, or None."""
    for pat, spec in _TP_RULES:
        if re.match(pat, path) and len(spec) <= ndim:
            return spec
    return None


def tp_halves(path: str) -> int:
    """2 for a leaf whose split axis holds two tensors side by side
    (`to_kv`: k then v; `proj_in`: a then gate), else 1."""
    return 2 if re.match(_TWO_HALVES, path) else 1


def tp_plan(path: str, shape: Sequence[int], tp: int
            ) -> Tuple[Optional[str], ...]:
    """The port's `param_shardings` for the flax leaf at `path` of the full
    `shape`: "tp" on the axis a rule splits, None elsewhere (one entry per
    axis). An annotated axis that tp does not divide stays replicated, as
    in JAX; a two-halves axis must divide into 2 * tp, since a rank takes
    its share of each half. That is the one departure from JAX: at F = 2730
    and tp = 4 `proj_in` (2F columns) stays whole where JAX splits it, so
    the whole GEGLU feed-forward is replicated."""
    rule = match_rule(path, len(shape)) or ()
    dims: List[Optional[str]] = []
    for i, size in enumerate(shape):
        ax = rule[i] if i < len(rule) else None
        if ax == "tp" and int(size) % (tp * tp_halves(path)):
            ax = None
        dims.append(ax)
    return tuple(dims)


def tp_axis(path: str, shape: Sequence[int], tp: int) -> Optional[int]:
    """The flax axis `tp_plan` splits (tp > 1), or None."""
    spec = tp_plan(path, shape, tp)
    return spec.index("tp") if tp > 1 and "tp" in spec else None


def zero_pspec(shape: Sequence[int], dp: int = 1,
               base: Optional[Sequence[Optional[str]]] = None
               ) -> Tuple[Optional[str], ...]:
    """The JAX package's `zero_pspec`: dp on the largest dp-divisible axis
    that `base` (the tensor-parallel spec, already divisible) leaves free;
    () when nothing is sliced."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return ()
    dims: List[Optional[str]] = [None] * len(shape)
    for i, ax in enumerate(tuple(base or ())[:len(shape)]):
        dims[i] = ax
    for ax in np.argsort(shape)[::-1]:
        ax = int(ax)
        if dims[ax] is None and (dp <= 1 or shape[ax] % dp == 0):
            dims[ax] = "dp"
            return tuple(dims)
    return () if all(d is None for d in dims) else tuple(dims)


def moment_pspec(path: str, shape: Sequence[int], dp: int, tp: int = 1
                 ) -> Tuple[Optional[str], ...]:
    """The JAX package's `moment_pspec` on a (dp, tp) mesh for the flax
    leaf at `path` with (full) `shape`: the rule's tp annotations that tp
    divides, and dp on the largest free dp-divisible axis."""
    rule = match_rule(path, len(shape))
    if rule is not None and all(ax is None for ax in rule):
        return ()
    base = [rule[i] if rule is not None and i < len(rule) else None
            for i in range(len(shape))]
    base = [None if ax == "tp" and int(shape[i]) % tp else ax
            for i, ax in enumerate(base)]
    return zero_pspec(shape, dp, base=base)


def moment_axis(path: str, shape: Sequence[int], dp: int, tp: int = 1
                ) -> Optional[int]:
    """The flax axis a moment of that leaf is sliced along over dp, or
    None."""
    spec = moment_pspec(path, shape, dp, tp)
    return spec.index("dp") if "dp" in spec else None


class ZeroPlan:
    """This rank's slice of each parameter of `module` over the mesh's dp
    group: `axes[name]` is the port tensor's axis, None where the moments
    stay whole (a rule pins them, no axis divides by dp, or dp = 1).

    `module` may be tensor-parallel (`parallel.tensor.shard_module_`): its
    parameters are then this rank's tp slices, `tp_axes[name]` says where
    (port axis, halves) for the sliced ones, and the dp slice is cut from
    the local tensor along an axis the tp split leaves whole."""

    def __init__(self, module: nn.Module, mesh: Mesh):
        from bevgen_torch.core.convert import flax_leaf
        from bevgen_torch.parallel.tensor import tp_layout
        self.mesh = mesh
        self.tp_axes = tp_layout(module)
        self.axes: Dict[str, Optional[int]] = {}
        for name, p in module.named_parameters():
            path, perm = flax_leaf(module, name)
            shape = [p.shape[a] for a in perm]
            if name in self.tp_axes:
                ax, _ = self.tp_axes[name]
                shape[perm.index(ax)] *= mesh.tp
            ax = moment_axis(path, shape, mesh.dp, mesh.tp)
            self.axes[name] = None if ax is None or mesh.dp == 1 else perm[ax]

    def part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `t` (a view), or `t` itself."""
        ax = self.axes[name]
        if ax is None:
            return t
        n = t.shape[ax] // self.mesh.dp
        return t.narrow(ax, self.mesh.dp_rank * n, n)

    def tp_part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's tp slice of the unsliced `t`, or `t` itself."""
        from bevgen_torch.parallel.tensor import take_part
        if name not in self.tp_axes:
            return t
        return take_part(t, *self.tp_axes[name], self.mesh.tp,
                         self.mesh.tp_rank)

    def part_full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the unsliced `t`: its tp part, then its dp
        part."""
        return self.part(name, self.tp_part(name, t))

    def gather(self, parts: Dict, owners: Optional[Dict] = None) -> Dict:
        """The whole tensors from every dp rank's slices (a collective over
        the dp group: every rank calls it with the same keys). A key of
        `parts` is a parameter name, or a key that `owners` maps to one (a
        moment of that parameter). The result is still tp-sliced
        (`gather_full` merges the tp slices too)."""
        def axis(key):
            return self.axes[key if owners is None else owners[key]]
        out = dict(parts)
        names = [n for n in parts if axis(n) is not None]
        if not names:
            return out
        dp, group = self.mesh.dp, self.mesh.dp_group
        ts = [parts[n].contiguous() for n in names]
        for idx in _flat_groups(ts):
            mine = [ts[i] for i in idx]
            flat = torch.cat([t.reshape(-1) for t in mine])
            bufs = [torch.empty_like(flat) for _ in range(dp)]
            dist.all_gather(bufs, flat, group=group)
            pieces = [_split(buf, mine) for buf in bufs]
            for j, i in enumerate(idx):
                out[names[i]] = torch.cat([p[j] for p in pieces],
                                          dim=axis(names[i]))
        return out

    def gather_full(self, parts: Dict, owners: Optional[Dict] = None) -> Dict:
        """`gather`, then every tp slice merged by meaning: the unsliced
        tensors (collectives over the dp and the tp groups)."""
        from bevgen_torch.parallel.tensor import gather_tp
        out = self.gather(parts, owners)
        return gather_tp(out, {k: self.tp_axes.get(
            k if owners is None else owners[k]) for k in out}, self.mesh)
