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
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry, in fp32, on the device."""
    norms = [t.float().norm() for t in tensors]
    return torch.linalg.vector_norm(torch.stack(norms))


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
        self.params: List[nn.Parameter] = [p for _, p in named]
        decay = decay or {}
        groups = [
            {"params": [p for n, p in named if decay.get(n, False)],
             "weight_decay": weight_decay},
            {"params": [p for n, p in named if not decay.get(n, False)],
             "weight_decay": 0.0},
        ]
        self.adam = torch.optim.AdamW([g for g in groups if g["params"]],
                                      lr=0.0, betas=(b1, b2), eps=eps)
        self.schedule = warmup_cosine(base_lr, warmup_steps, total_steps)
        self.grad_clip = grad_clip
        self.accumulate_steps = max(1, accumulate_steps)
        self.count = 0        # applied updates: the schedule's step
        self.mini_step = 0    # micro-batches in the current accumulation
        self.acc: Optional[List[torch.Tensor]] = None

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
            norm = global_norm(grads)
            scale = torch.where(norm < self.grad_clip, 1.0,
                                self.grad_clip / norm)
            grads = [g * scale.to(g.dtype) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.schedule(self.count)
        for group in self.adam.param_groups:
            group["lr"] = lr
        self.adam.step()
        for p in self.params:
            p.grad = None
        self.count += 1
        return True

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        self.acc = state["acc"]


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
    and the number of updates it has taken."""

    def __init__(self, params: Dict[str, torch.Tensor], count: int = 0):
        self.params = params
        self.count = count


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
    ema = [state.params[n] for n in names]
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, [params[n].float() for n in names], alpha=1 - d)
    state.count += 1
    return state
