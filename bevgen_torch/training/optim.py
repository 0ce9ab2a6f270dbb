"""Optimisation for training: for stage 2, AdamW with the minGPT decay
partition, warm-up + cosine learning rate, gradient accumulation, EMA; for
stage 1, Adam(0.5, 0.9) (`vqgan_optimizer`).

Port of `bevgen_tpu/training/optim.py`, whose stage-2 optax chain is

    clip_by_global_norm(1.0) -> scale_by_adam(0.9, 0.95, eps 1e-8)
    -> add_decayed_weights(0.01, mask) -> scale_by_schedule(-lr(count))

wrapped in `optax.MultiSteps` when gradients are accumulated. Here the clip
and the accumulation are written out and the rest is `torch.optim.AdamW`
with two parameter groups (decay 0.01 / 0), whose decoupled decay
p <- p - lr wd p is the same update as optax's lr * (adam + wd p). The
schedule counts applied updates from 0, as optax's does, so the first
update has lr 0 (during warm-up).

Data parallelism (`parallel/sharding.py`): `MaskGitOptimizer.shard(plan)`
keeps on each rank only its slice of every AdamW moment (ZeRO-1). The
optimizer is then handed each parameter's rank slice as a view into the
parameter, steps it with the slice of the summed gradient, and gathers the
slices back into the whole parameters; `state_dict` gathers the moments
into the unsliced layout and `load_state_dict` slices them again, so a
saved state restores at any number of ranks. `shard_ema` slices the EMA
the same way. Under tensor parallelism (`parallel/tensor.py`) the
parameters are already this rank's tp slices: the moments and the EMA are
cut from them, the unsliced layout is gathered over tp too, and the
clipping norm counts a tp-sliced gradient's squares over the tp group and
a replicated one's once, so the clip is the same on every rank.
"""
from __future__ import annotations

import math
from typing import (TYPE_CHECKING, Callable, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import torch
from torch import nn

if TYPE_CHECKING:
    from bevgen_torch.parallel.sharding import ZeroPlan

# the reference partition decays torch.nn.Linear weights only; its
# geometric embeds (convs there, Linear here) land in the no-decay group
# (cond_transformer_multi_view.py:413, 443-444)
NO_DECAY_MODULES = ("img_embed", "cam_embed", "bev_embed")


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies: Linear weights
    outside img_embed/cam_embed/bev_embed. Biases, norms, embeddings,
    null_kv, the q/k scales and the learned tables do not decay."""
    out = {}
    for name, _ in model.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        parts = name.lower().split(".")
        out[name] = (isinstance(owner, nn.Linear) and leaf == "weight"
                     and not any(p in NO_DECAY_MODULES for p in parts))
    return out


def warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 0.0) -> Callable[[int], float]:
    """Linear warm-up from 0, then cosine decay to min_lr
    (utils/scheduler.py:3 in the reference): lr(count) for count = 0, 1, ..."""
    warmup_steps = max(warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * min(step / warmup_steps, 1.0)
        t = min(max((step - warmup_steps)
                    / max(total_steps - warmup_steps, 1), 0.0), 1.0)
        return min_lr + 0.5 * (base_lr - min_lr) * (1 + math.cos(math.pi * t))
    return schedule


def global_norm(tensors: Iterable[torch.Tensor],
                sliced: Optional[Sequence[bool]] = None,
                tp_sum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32, on the device.
    With `sliced` (a flag per tensor) and `tp_sum` (a sum over the tp
    group), the flagged tensors are tp slices: their squares are summed over
    the group, the others' counted once."""
    norms = [t.float().norm() for t in tensors]
    if sliced is None or not any(sliced):
        return torch.linalg.vector_norm(torch.stack(norms))
    zero = norms[0].new_zeros(())
    rep = [n for n, s in zip(norms, sliced) if not s]
    cut = torch.linalg.vector_norm(torch.stack(
        [n for n, s in zip(norms, sliced) if s]))
    rep = torch.linalg.vector_norm(torch.stack(rep)) if rep else zero
    return torch.sqrt(rep * rep + tp_sum(cut * cut))


class MaskGitOptimizer:
    """Stage-2 optimizer (`maskgit_optimizer`): global-norm clip, AdamW
    with the decay partition, warm-up + cosine schedule, and optional
    accumulation over `accumulate_steps` micro-batches (the mean gradient
    is applied on the last of them, as optax.MultiSteps does; the schedule
    counts applied updates).

    `step(grads)` takes one micro-batch's gradients (one per parameter, in
    the order of `params`) and returns True when it applied an update."""

    def __init__(self, named_params: Iterable[Tuple[str, nn.Parameter]],
                 base_lr: float, warmup_steps: int = 500,
                 total_steps: int = 300_000, weight_decay: float = 0.01,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 grad_clip: Optional[float] = 1.0, accumulate_steps: int = 1,
                 decay: Optional[Dict[str, bool]] = None):
        named = list(named_params)
        self.names: List[str] = [n for n, _ in named]
        self.params: List[nn.Parameter] = [p for _, p in named]
        decay = decay or {}
        # AdamW's parameter groups by name, in the order its state counts them
        self._groups = [g for g in (
            ([n for n, _ in named if decay.get(n, False)], weight_decay),
            ([n for n, _ in named if not decay.get(n, False)], 0.0)) if g[0]]
        self._adam_args = dict(lr=0.0, betas=(b1, b2), eps=eps)
        self.plan: Optional["ZeroPlan"] = None
        self.adam = self._make_adam(dict(named))
        self.schedule = warmup_cosine(base_lr, warmup_steps, total_steps)
        self.grad_clip = grad_clip
        self.accumulate_steps = max(1, accumulate_steps)
        self.count = 0        # applied updates: the schedule's step
        self.mini_step = 0    # micro-batches in the current accumulation
        self.acc: Optional[List[torch.Tensor]] = None

    def _make_adam(self, tensors: Dict[str, torch.Tensor]) -> torch.optim.AdamW:
        self._targets = tensors   # what AdamW steps: parameters or slices
        return torch.optim.AdamW(
            [{"params": [tensors[n] for n in names], "weight_decay": wd}
             for names, wd in self._groups], **self._adam_args)

    def state_names(self) -> List[str]:
        """Parameter names in the index order of `state_dict()["adam"]`."""
        return [n for names, _ in self._groups for n in names]

    def shard(self, plan: "ZeroPlan", state: Optional[dict] = None) -> None:
        """Keep only this rank's slice of every moment (ZeRO-1 over the
        plan's dp group): AdamW now steps views of the parameters' slices
        and `step` gathers them. Moments already held are sliced; `state`
        (this optimizer's `state_dict()` taken before the parameters were
        cut to tp slices) is loaded in their place."""
        state = self.state_dict() if state is None else state
        self.plan = plan
        self.adam = self._make_adam({
            n: plan.part(n, p.detach()) for n, p in zip(self.names,
                                                        self.params)})
        self.load_state_dict(state)

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> bool:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for {len(self.params)} "
                             "parameters")
        if self.accumulate_steps > 1:
            if self.acc is None:
                self.acc = [g.detach().float().clone() for g in grads]
            else:
                torch._foreach_add_(self.acc, [g.float() for g in grads])
            self.mini_step += 1
            if self.mini_step < self.accumulate_steps:
                return False
            grads = torch._foreach_div(self.acc, float(self.accumulate_steps))
            self.acc, self.mini_step = None, 0
        grads = [g.to(p.dtype) for g, p in zip(grads, self.params)]
        if self.grad_clip:
            norm = self.grad_norm(grads)
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            grads = [g * scale.to(g.dtype) for g in grads]
        for n, g in zip(self.names, grads):
            self._targets[n].grad = (g if self.plan is None
                                     else self.plan.part(n, g))
        lr = self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        for t in self._targets.values():
            t.grad = None
        if self.plan is not None:
            self._gather_params()
        self.count += 1
        return True

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of one gradient per parameter: the tp slices'
        squares summed over the tp group (the same on every rank)."""
        if self.plan is None or not self.plan.tp_axes:
            return global_norm(grads)
        return global_norm(grads, [n in self.plan.tp_axes for n in self.names],
                           self.plan.mesh.tp_sum)

    def _gather_params(self) -> None:
        """Every rank's updated slices into the whole parameters."""
        full = self.plan.gather({n: t for n, t in self._targets.items()
                                 if self.plan.axes[n] is not None})
        for n, p in zip(self.names, self.params):
            if n in full:
                p.detach().copy_(full[n])

    def state_dict(self) -> dict:
        """The optimizer state in the unsliced layout (with a plan: a
        collective over the dp and tp groups, so every rank calls it
        together)."""
        adam = self.adam.state_dict()
        acc = self.acc
        if self.plan is not None:
            order = self.state_names()
            parts = {(k, i): st[k] for i, st in adam["state"].items()
                     for k in ("exp_avg", "exp_avg_sq")}
            full = self.plan.gather_full(parts, {key: order[key[1]]
                                                 for key in parts})
            adam = {"param_groups": adam["param_groups"], "state": {
                i: {**st, "exp_avg": full[("exp_avg", i)],
                    "exp_avg_sq": full[("exp_avg_sq", i)]}
                for i, st in adam["state"].items()}}
            if acc is not None:
                from bevgen_torch.parallel.tensor import gather_tp
                got = gather_tp(dict(zip(self.names, acc)), self.plan.tp_axes,
                                self.plan.mesh)
                acc = [got[n] for n in self.names]
        return {"adam": adam, "count": self.count,
                "mini_step": self.mini_step, "acc": acc}

    def load_state_dict(self, state: dict) -> None:
        """Load a state in the unsliced layout (any rank count's
        `state_dict`), sliced to this rank's part when sharded."""
        adam, acc = state["adam"], state["acc"]
        if self.plan is not None:
            order = self.state_names()
            adam = {"param_groups": adam["param_groups"], "state": {
                i: {k: (self.plan.part_full(order[int(i)], v).clone()
                        if k in ("exp_avg", "exp_avg_sq") else v)
                    for k, v in st.items()}
                for i, st in adam["state"].items()}}
            if acc is not None:
                acc = [self.plan.tp_part(n, a).clone()
                       for n, a in zip(self.names, acc)]
        self.adam.load_state_dict(adam)
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.acc = acc


def maskgit_optimizer(model: nn.Module, base_lr: float,
                      warmup_steps: int = 500, total_steps: int = 300_000,
                      weight_decay: float = 0.01, b1: float = 0.9,
                      b2: float = 0.95, grad_clip: Optional[float] = 1.0,
                      accumulate_steps: int = 1) -> MaskGitOptimizer:
    """The stage-2 optimizer over every parameter of `model`, with the
    decay partition of `decay_mask(model)`."""
    return MaskGitOptimizer(model.named_parameters(), base_lr, warmup_steps,
                            total_steps, weight_decay, b1, b2,
                            grad_clip=grad_clip,
                            accumulate_steps=accumulate_steps,
                            decay=decay_mask(model))


def vqgan_optimizer(params: Iterable[nn.Parameter],
                    lr: float) -> torch.optim.Adam:
    """The stage-1 optimizer, one for the autoencoder and one for the
    discriminator: Adam with betas (0.5, 0.9) and eps 1e-8, the update of
    `optax.adam` (eps added to the bias-corrected root), constant lr."""
    return torch.optim.Adam(params, lr=lr, betas=(0.5, 0.9), eps=1e-8)


def scaled_lr(base_lr: float, batch_size: int, num_devices: int = 1,
              accumulate_steps: int = 1) -> float:
    """The reference's rule, accumulate x devices x batch x base_lr
    (generate.py:58); pass num_devices=1 for a global batch."""
    return base_lr * batch_size * num_devices * accumulate_steps


class EmaState:
    """Exponential moving average of the parameters (fp32 copies by name)
    and the number of updates it has taken. With a `plan` (`shard_ema`)
    each entry is this rank's slice."""

    def __init__(self, params: Dict[str, torch.Tensor], count: int = 0,
                 plan: Optional["ZeroPlan"] = None):
        self.params = params
        self.count = count
        self.plan = plan

    def full(self) -> Dict[str, torch.Tensor]:
        """The whole EMA parameters by name, unsliced (with a plan:
        gathered, a collective over the dp and tp groups)."""
        return self.params if self.plan is None else self.plan.gather_full(
            self.params)

    def local(self) -> Dict[str, torch.Tensor]:
        """The EMA parameters at the shapes of this rank's model (its tp
        slices; with a plan: gathered over the dp group, a collective)."""
        return self.params if self.plan is None else self.plan.gather(
            self.params)


def shard_ema(state: EmaState, plan: "ZeroPlan") -> EmaState:
    """`state` (unsliced) keeping only this rank's slice of each entry."""
    return EmaState({n: plan.part_full(n, t).clone()
                     for n, t in state.params.items()}, state.count, plan)


def ema_init(model: nn.Module) -> EmaState:
    return EmaState({n: p.detach().float().clone()
                     for n, p in model.named_parameters()})


@torch.no_grad()
def ema_update(state: EmaState, model: nn.Module, decay: float = 0.9999,
               warmup: bool = False) -> EmaState:
    """ema <- ema * d + p * (1 - d), in place, with the fixed `decay` (the
    reference's ema.py:148-151), or with warmup=True the ramp
    d = min(decay, (1 + count) / (10 + count))."""
    d = decay
    if warmup:
        d = min(decay, (1.0 + state.count) / (10.0 + state.count))
    names = list(state.params)
    params = dict(model.named_parameters())
    if state.plan is not None:
        params = {n: state.plan.part(n, params[n]) for n in names}
    ema = [state.params[n] for n in names]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, [params[n].float() for n in names], alpha=1 - d)
    state.count += 1
    return state
