"""Stage-2 training steps, on one device or data-parallel over a mesh.

Port of `bevgen_tpu/training/trainer.py`: `TrainState`,
`create_train_state`, `make_train_step` (:37-118) and
`make_sharded_train_step` (:121) for the MaskGit, and `ARTrainState`,
`create_ar_train_state` and `make_ar_sharded_train_step` (:212) for the AR
SparseGPT: loss and gradients in one backward, the global gradient norm,
the optimizer update (and, for the MaskGit, the EMA). The models keep fp32
parameters and AdamW fp32 moments and compute in bf16
(`param_dtype=float32`), as the reference does. On the card every
attention runs through the CUDA kernels, forward and backward
(`ops/cosine_attention.py:CosineAttentionFn`,
`ops/block_sparse.py:BlockSparseAttentionFn`), each rank at its local
batch.

`skip_nonfinite` keeps the previous parameters and optimizer state when
the loss or the gradient norm is not finite (one host sync per step reads
that flag); the AR step has no such guard, as in the reference.

The sharded steps (`parallel/sharding.py`) give each rank its rows of the
global batch. The MaskGit loss sums its masked count over the ranks before
the backward (the global batch's CE), the AR loss is a mean over equal
shards; each rank's loss is its part of the global loss, the gradients are
summed over the ranks in one `all_reduce`, the norm, the clip and the
`skip_nonfinite` decision are taken on the summed gradient (the same on
every rank), each rank updates its ZeRO slice of the parameters and the
slices are gathered, so every rank holds the same parameters. At a mesh of
one process the steps compute what `make_train_step` and
`make_ar_train_step` compute.

With tp > 1 the MaskGit step cuts the model's heads and FFN hidden to this
rank's tp slices in place (`parallel/tensor.py:shard_module_`): the ranks
of a tp group compute the same rows, the loss comes out the same on each
(the logits are gathered), the gradients are summed over each tp index's
data group, and the clipping norm counts the tp slices over the tp group.
The AR step keeps its parameters whole on every rank, as the JAX package's
does (the reference's AR training is data-parallel only): the tp ranks of
a row compute the same rows, and take the first one's summed gradients,
so they cannot drift apart.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch

from bevgen_torch.models.stage2.ar import ar_loss
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.models.stage2.maskgit import MaskGit, maskgit_loss
from bevgen_torch.parallel.sharding import Mesh, ZeroPlan
from bevgen_torch.parallel.tensor import shard_module_
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


def _grads(loss: torch.Tensor, params: List[torch.Tensor],
           mesh: Optional[Mesh]) -> List[torch.Tensor]:
    """d loss / d params (zeros where unused), summed over the mesh."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, p in zip(grads, params)]
    return grads if mesh is None else mesh.sum_all(grads)


def _shard_state(model, optimizer, mesh: Mesh, state, split: bool):
    """Rank 0's parameters on every rank, cut to this rank's tp slices when
    `split`, the moments sliced."""
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("model and optimizer must be the state's own")
    unsliced = optimizer.state_dict()
    mesh.broadcast_module(model)
    if split:
        shard_module_(model, mesh)
    plan = ZeroPlan(model, mesh)
    optimizer.shard(plan, unsliced)
    return plan


def make_train_step(ema_decay: float = 0.9999, skip_nonfinite: bool = True,
                    ema_every: int = 1, ema_warmup: bool = False,
                    mesh: Optional[Mesh] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(state, batch, generator=None, mask_override=None,
    gumbel_noise=None) -> metrics, which advances `state` in place.

    batch: tokens (b, cam, hw), cond_ids (b, nc), intrinsics_inv
    (b, cam, 3, 3), extrinsics_inv (b, cam, 4, 4), tensors on the model's
    device. generator: the source of every random draw of the loss.
    ema_every: the accumulation factor, so the EMA advances once per
    applied update. Metrics (0-d tensors): loss, ce_loss, critic_loss,
    grad_norm, update_applied. mesh: the batch is this rank's rows of a
    data-parallel batch (use `make_sharded_train_step`); the metrics are
    the global batch's, the same on every rank."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None,
                   mask_override: Optional[torch.Tensor] = None,
                   gumbel_noise: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        shard = (None if mesh is None
                 else mesh.batch_shard(batch["tokens"].shape[0]))
        out = maskgit_loss(model, batch["tokens"], batch["cond_ids"],
                           batch["intrinsics_inv"], batch["extrinsics_inv"],
                           generator=generator, mask_override=mask_override,
                           gumbel_noise=gumbel_noise, shard=shard)
        grads = _grads(out.loss, opt.params, mesh)
        terms = torch.stack([out.loss, out.ce_loss, out.critic_loss]).detach()
        loss, ce, critic = terms if mesh is None else mesh.sum(terms)
        grad_norm = opt.grad_norm(grads)
        ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if ok or not skip_nonfinite:
            opt.step(grads)
        del grads
        if ema_every <= 1 or (state.step + 1) % ema_every == 0:
            optim.ema_update(state.ema, model, ema_decay, warmup=ema_warmup)
        state.step += 1
        return {"loss": loss, "ce_loss": ce, "critic_loss": critic,
                "grad_norm": grad_norm.detach(),
                "update_applied": torch.tensor(float(ok))}

    return train_step


def make_sharded_train_step(model: MaskGit, optimizer: optim.MaskGitOptimizer,
                            mesh: Mesh, state: TrainState,
                            ema_decay: float = 0.9999,
                            ema_warmup: bool = False, ema_every: int = 1):
    """The MaskGit step over `mesh`. Returns (step_fn, sharded_state): rank
    0's parameters broadcast to every rank and, with tp > 1, cut to this
    rank's tp slices (the model, in place), the AdamW moments and the EMA
    sliced over dp (ZeRO-1). step_fn(state, batch, generator,
    mask_override=None, gumbel_noise=None) takes this data row's rows of the
    global batch (and of the override tensors); every rank seeds its
    generator alike. `model` and `optimizer` are the state's own, unsliced
    (a restored state is restored before this call)."""
    plan = _shard_state(model, optimizer, mesh, state, split=True)
    mesh.broadcast_(list(state.ema.params.values()))
    state.ema = optim.shard_ema(state.ema, plan)
    step_fn = make_train_step(ema_decay, ema_every=ema_every,
                              ema_warmup=ema_warmup, mesh=mesh)
    return step_fn, state


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


def make_ar_train_step(mesh: Optional[Mesh] = None
                       ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns train_step(state, batch) -> metrics, which advances `state`
    in place: the deterministic teacher-forced `ar_loss`, its gradients,
    their global norm (before the optimizer's clip) and one optimizer
    update. batch: tokens (b, cam, hw), cond_ids (b, nc), intrinsics_inv
    (b, cam, 3, 3), extrinsics_inv (b, cam, 4, 4), tensors on the model's
    device. Metrics (0-d tensors): loss, grad_norm. mesh: the batch is this
    rank's rows of a data-parallel batch (`make_ar_sharded_train_step`);
    the loss is then the mean of the ranks' equal-sized shards."""

    def train_step(state: ARTrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        model.train()
        loss = ar_loss(model, batch["tokens"], batch["cond_ids"],
                       batch["intrinsics_inv"], batch["extrinsics_inv"],
                       deterministic=True)
        if mesh is not None:
            loss = loss / mesh.size
        grads = _grads(loss, opt.params, mesh)
        if mesh is not None and mesh.tp > 1:
            # the tp ranks of a row computed the same rows: one gradient
            mesh.broadcast_(grads, group=mesh.tp_group)
        loss = loss.detach() if mesh is None else mesh.sum(loss.detach())
        grad_norm = optim.global_norm(grads)
        opt.step(grads)
        del grads
        state.step += 1
        return {"loss": loss, "grad_norm": grad_norm.detach()}

    return train_step


def make_ar_sharded_train_step(model: SparseGPT,
                               optimizer: optim.MaskGitOptimizer, mesh: Mesh,
                               state: ARTrainState):
    """The AR step data-parallel over `mesh`, deterministic (no dropout), as
    the reference's. Returns (step_fn, sharded_state) as
    `make_sharded_train_step` does; step_fn(state, batch) takes this data
    row's rows. The parameters stay whole under tp (the JAX package's
    `make_ar_sharded_train_step`: the AR model trains data-parallel only)."""
    _shard_state(model, optimizer, mesh, state, split=False)
    return make_ar_train_step(mesh), state
