"""Stage-2 training steps on one device.

Port of `bevgen_tpu/training/trainer.py`: `TrainState`,
`create_train_state` and `make_train_step` (:37-118) for the MaskGit, and
`ARTrainState`, `create_ar_train_state` and the body of
`make_ar_sharded_train_step` (:198-278) for the AR SparseGPT: loss and
gradients in one backward, the global gradient norm, the optimizer update
(and, for the MaskGit, the EMA). The models keep fp32 parameters and AdamW
fp32 moments and compute in bf16 (`param_dtype=float32`), as the reference
does. On the card every attention runs through the CUDA kernels, forward
and backward (`ops/cosine_attention.py:CosineAttentionFn`,
`ops/block_sparse.py:BlockSparseAttentionFn`).

`skip_nonfinite` keeps the previous parameters and optimizer state when
the loss or the gradient norm is not finite (one host sync per step reads
that flag); the AR step has no such guard, as in the reference. Sharded
training (`make_sharded_train_step`, the AR step's mesh and `pmean`) waits
for the port of the reference's mesh to `torch.distributed`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from bevgen_torch.models.stage2.ar import ar_loss
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.models.stage2.maskgit import MaskGit, maskgit_loss
from bevgen_torch.training import optim


@dataclasses.dataclass
class TrainState:
    step: int
    model: MaskGit
    optimizer: optim.MaskGitOptimizer
    ema: optim.EmaState


def create_train_state(model: MaskGit,
                       optimizer: optim.MaskGitOptimizer) -> TrainState:
    """Step 0, the EMA seeded with the initial parameters."""
    return TrainState(step=0, model=model, optimizer=optimizer,
                      ema=optim.ema_init(model))


def make_train_step(ema_decay: float = 0.9999, skip_nonfinite: bool = True,
                    ema_every: int = 1, ema_warmup: bool = False
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(state, batch, generator=None, mask_override=None,
    gumbel_noise=None) -> metrics, which advances `state` in place.

    batch: tokens (b, cam, hw), cond_ids (b, nc), intrinsics_inv
    (b, cam, 3, 3), extrinsics_inv (b, cam, 4, 4), tensors on the model's
    device. generator: the source of every random draw of the loss.
    ema_every: the accumulation factor, so the EMA advances once per
    applied update. Metrics (0-d tensors): loss, ce_loss, critic_loss,
    grad_norm, update_applied."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   mask_override: Optional[torch.Tensor] = None,
                   gumbel_noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        out = maskgit_loss(model, batch["tokens"], batch["cond_ids"],
                           batch["intrinsics_inv"], batch["extrinsics_inv"],
                           generator=generator, mask_override=mask_override,
                           gumbel_noise=gumbel_noise)
        grads = torch.autograd.grad(out.loss, opt.params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, opt.params)]
        grad_norm = optim.global_norm(grads)
        ok = bool(torch.isfinite(out.loss) & torch.isfinite(grad_norm))
        if ok or not skip_nonfinite:
            opt.step(grads)
        del grads
        if ema_every <= 1 or (state.step + 1) % ema_every == 0:
            optim.ema_update(state.ema, model, ema_decay, warmup=ema_warmup)
        state.step += 1
        return {"loss": out.loss.detach(), "ce_loss": out.ce_loss.detach(),
                "critic_loss": out.critic_loss.detach(),
                "grad_norm": grad_norm.detach(),
                "update_applied": torch.tensor(float(ok))}

    return train_step


@dataclasses.dataclass
class ARTrainState:
    step: int
    model: SparseGPT
    optimizer: optim.MaskGitOptimizer


def create_ar_train_state(model: SparseGPT,
                          optimizer: optim.MaskGitOptimizer) -> ARTrainState:
    """Step 0; the optimizer covers the model's parameters (its decay
    partition from `optim.decay_mask`)."""
    return ARTrainState(step=0, model=model, optimizer=optimizer)


def make_ar_train_step() -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(state, batch) -> metrics, which advances `state`
    in place: the deterministic teacher-forced `ar_loss`, its gradients,
    their global norm (before the optimizer's clip) and one optimizer
    update. batch: tokens (b, cam, hw), cond_ids (b, nc), intrinsics_inv
    (b, cam, 3, 3), extrinsics_inv (b, cam, 4, 4), tensors on the model's
    device. Metrics (0-d tensors): loss, grad_norm."""

    def train_step(state: ARTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        loss = ar_loss(model, batch["tokens"], batch["cond_ids"],
                       batch["intrinsics_inv"], batch["extrinsics_inv"],
                       deterministic=True)
        grads = list(torch.autograd.grad(loss, opt.params))
        grad_norm = optim.global_norm(grads)
        opt.step(grads)
        del grads
        state.step += 1
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach()}

    return train_step
