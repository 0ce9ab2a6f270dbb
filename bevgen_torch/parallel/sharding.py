"""The data-parallel mesh, ZeRO slices of the optimizer state, and each
rank's rows of a batch.

Port of `bevgen_tpu/parallel/sharding.py` for data parallelism, the
reference's own layout (DDP with DeepSpeed ZeRO-2, SURVEY §2.8): one
process per device, parameters replicated, the batch split over the ranks.

Mesh axes:
  dcn: an outer data-parallel axis across nodes; the gradient sum crosses
       it once per step.
  dp:  data parallel within a node. The optimizer moments and the EMA are
       sliced over dp only (one process group per dcn row), replicated
       across dcn, so their gather stays inside a node.
  tp:  always 1. Tensor parallelism is not ported yet; `make_mesh` raises
       for tp > 1.

ZeRO-1 on `all_reduce` and `all_gather`: every rank sums the full
gradient, clips with the global norm, updates its slice of each parameter
with its slice of the moments, and the slices are gathered back into the
parameters, so all ranks hold the same parameters bit for bit. Each
moment is sliced along the axis the JAX package's `moment_pspec` picks
for it (the largest dp-divisible axis that no tensor-parallel rule
reserves; none for the embedding tables a rule pins replicated). The
port's parameters carry the flax names, so `_TP_RULES` apply to their
flax paths (`core/convert.py:flax_leaf`).

Random draws ignore dp: every rank seeds the same generator, draws each
random tensor at the global batch's shape and keeps its own rows
(`BatchShard.rand`), so a run over any number of ranks draws what one
process draws for the whole batch.

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
    """A (dcn, dp) data-parallel mesh over the processes of the default
    group, in rank order (rank = dcn_index * dp + dp_index).

    group: the world's group, None in one process without a group (every
    collective is then the identity); dp_group: this rank's dcn row, over
    which the ZeRO slices are gathered; device: where the collectives'
    own small tensors live (a CUDA device for nccl)."""
    dcn: int
    dp: int
    rank: int
    group: Optional[dist.ProcessGroup]
    dp_group: Optional[dist.ProcessGroup]
    device: torch.device
    owns_group: bool = False    # close() leaves the default group

    @property
    def shape(self) -> Dict[str, int]:
        if self.dcn > 1:
            return {"dcn": self.dcn, "dp": self.dp, "tp": 1}
        return {"dp": self.dp, "tp": 1}

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return self.dcn * self.dp

    @property
    def dp_rank(self) -> int:
        return self.rank % self.dp

    def batch_shard(self, rows: int) -> BatchShard:
        """This rank's place in a global batch of `rows` rows per rank."""
        return BatchShard(rows * self.size, self.rank * rows, self.sum)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """A new tensor: `t` summed over every rank."""
        t = t.clone()
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def sum_all(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """`tensors` summed over every rank, in one collective per dtype."""
        if self.group is None:
            return list(tensors)
        return flat_apply(tensors, lambda f: dist.all_reduce(f, group=self.group))

    def any(self, flag: bool) -> bool:
        """True on every rank when `flag` is true on any rank."""
        if self.group is None:
            return bool(flag)
        t = torch.tensor([int(bool(flag))], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return bool(t.item())

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor]) -> None:
        """Rank 0's `tensors` into every rank's, in place."""
        if self.group is None:
            return
        tensors = [t.detach() for t in tensors]
        src = dist.get_global_rank(self.group, 0)
        got = flat_apply(tensors, lambda f: dist.broadcast(
            f, src=src, group=self.group))
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
        """Every rank's `t` (equal shapes) concatenated along axis 0 in rank
        order: the global batch from each rank's rows."""
        if self.group is None:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)


def mesh_layout(n: int, dp: Optional[int] = None, tp: int = 1,
                dcn: int = 1) -> Tuple[int, int]:
    """(dcn, dp) of a mesh over all `n` processes: dp = n // dcn when not
    given; the product must be n (every rank takes part)."""
    if tp != 1:
        raise NotImplementedError(
            f"tp={tp}: tensor parallelism is not ported yet (dp and dcn are)")
    if dp is None:
        if n % dcn:
            raise ValueError(f"{n} processes do not split into dcn={dcn} rows")
        dp = n // dcn
    if dcn * dp != n:
        raise ValueError(f"a dcn={dcn} x dp={dp} mesh needs {dcn * dp} "
                         f"processes; {n} were started")
    return dcn, dp


def multislice_layout(n: int, slice_index_of: Callable[[int], int]
                      ) -> Tuple[int, int]:
    """(dcn, dp) of a mesh whose dcn rows are the nodes: ranks grouped by
    `slice_index_of(rank)`, one row per node. The ranks of a node must be
    contiguous (torchrun numbers them so) and the nodes of equal size."""
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


def make_mesh(dp: Optional[int] = None, tp: int = 1, dcn: int = 1,
              device="cpu") -> Mesh:
    """The (dcn, dp) mesh over every process of the default group (one
    process without a group: a mesh of one). With dcn > 1, one dp group per
    dcn row (every rank creates every row's group, in order)."""
    dcn, dp = mesh_layout(distributed.process_count(), dp, tp, dcn)
    rank = distributed.process_index()
    group = dist.group.WORLD if dist.is_initialized() else None
    dp_group = group
    if dcn > 1:
        for row in range(dcn):
            g = dist.new_group(list(range(row * dp, (row + 1) * dp)))
            if row == rank // dp:
                dp_group = g
    return Mesh(dcn, dp, rank, group, dp_group, torch.device(device))


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
    them apart; one node gives the plain (dp,) mesh."""
    dcn, dp = multislice_layout(distributed.process_count(),
                                slice_index_of or node_of_rank)
    return make_mesh(dp=dp // tp, tp=tp, dcn=dcn, device=device)


def batch_axes(mesh: Mesh) -> tuple:
    """The axes the batch splits over: ('dcn', 'dp') or ('dp',)."""
    return ("dcn", "dp") if mesh.dcn > 1 else ("dp",)


def data_parallelism(mesh: Mesh) -> int:
    """Total data-parallel ways (dcn * dp)."""
    return mesh.size


def shard_batch(arrays: Iterable, mesh: Mesh, device) -> Tuple[torch.Tensor, ...]:
    """This rank's rows of global batch arrays (numpy or tensors), as
    tensors on `device`; the batch must split evenly over the mesh."""
    out = []
    for a in arrays:
        b = len(a)
        if b % mesh.size:
            raise ValueError(f"a batch of {b} does not split over "
                             f"{mesh.size} data-parallel ranks")
        sl = distributed.host_shard_indices(b, mesh.rank, mesh.size)
        out.append(torch.as_tensor(np.asarray(a[sl]) if not torch.is_tensor(a)
                                   else a[sl], device=device))
    return tuple(out)


# ---------------------------------------------------------------------------
# where each optimizer moment is sliced (the JAX package's rules, tp = 1)
# ---------------------------------------------------------------------------

# flax path regex -> the weight's tensor-parallel spec (a copy of the JAX
# package's rules): `moment_pspec` keeps dp off the axes these reserve, and
# keeps the moments of the tables pinned fully replicated replicated
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


def match_rule(path: str, ndim: int) -> Optional[Tuple[Optional[str], ...]]:
    """The first rule whose regex matches the flax `path` and whose spec
    fits `ndim` axes, or None."""
    for pat, spec in _TP_RULES:
        if re.match(pat, path) and len(spec) <= ndim:
            return spec
    return None


def zero_pspec(shape: Sequence[int], dp: int = 1,
               base: Optional[Sequence[Optional[str]]] = None
               ) -> Tuple[Optional[str], ...]:
    """The JAX package's `zero_pspec` at tp = 1: dp on the largest
    dp-divisible axis that `base` leaves free; () when nothing is sliced."""
    shape = tuple(int(s) for s in shape)
    if not shape:
        return ()
    dims: List[Optional[str]] = [None] * len(shape)
    for i, ax in enumerate(tuple(base or ())[:len(shape)]):
        dims[i] = ax     # a tensor-parallel axis of size 1 divides every size
    for ax in np.argsort(shape)[::-1]:
        ax = int(ax)
        if dims[ax] is None and (dp <= 1 or shape[ax] % dp == 0):
            dims[ax] = "dp"
            return tuple(dims)
    return () if all(d is None for d in dims) else tuple(dims)


def moment_pspec(path: str, shape: Sequence[int], dp: int
                 ) -> Tuple[Optional[str], ...]:
    """The JAX package's `moment_pspec` on a (dp, tp=1) mesh for the flax
    leaf at `path` with `shape`."""
    rule = match_rule(path, len(shape))
    if rule is not None and all(ax is None for ax in rule):
        return ()
    return zero_pspec(shape, dp, base=rule)


def moment_axis(path: str, shape: Sequence[int], dp: int) -> Optional[int]:
    """The flax axis a moment of that leaf is sliced along, or None."""
    spec = moment_pspec(path, shape, dp)
    return spec.index("dp") if "dp" in spec else None


class ZeroPlan:
    """This rank's slice of each parameter of `module` over the mesh's dp
    group: `axes[name]` is the port tensor's axis, None where the moments
    stay whole (a rule pins them, no axis divides by dp, or dp = 1)."""

    def __init__(self, module: nn.Module, mesh: Mesh):
        from bevgen_torch.core.convert import flax_leaf
        self.mesh = mesh
        self.axes: Dict[str, Optional[int]] = {}
        for name, p in module.named_parameters():
            path, perm = flax_leaf(module, name)
            ax = moment_axis(path, [p.shape[a] for a in perm], mesh.dp)
            self.axes[name] = None if ax is None or mesh.dp == 1 else perm[ax]

    def part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of `t` (a view), or `t` itself."""
        ax = self.axes[name]
        if ax is None:
            return t
        n = t.shape[ax] // self.mesh.dp
        return t.narrow(ax, self.mesh.dp_rank * n, n)

    def gather(self, parts: Dict, owners: Optional[Dict] = None) -> Dict:
        """The whole tensors from every dp rank's slices (a collective over
        the dp group: every rank calls it with the same keys). A key of
        `parts` is a parameter name, or a key that `owners` maps to one (a
        moment of that parameter)."""
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
