"""Stage-1 (VQ-GAN / VQ-VAE) training steps on one device.

Port of `bevgen_tpu/training/stage1_trainer.py` and of the no-discriminator
RGB step of `bevgen_tpu/scripts/train_stage1.py:146-163`. The reference's
two-optimizer setup: Adam(0.5, 0.9) over the autoencoder and another over
the PatchGAN discriminator (`optim.vqgan_optimizer`). One VQ-GAN step:

  1. the autoencoder forward, the perceptual term and the discriminator's
     logits of the reconstruction;
  2. the adaptive weight |grad nll| / (|grad g| + 1e-4), both gradients
     taken with respect to the decoder's output conv weight alone
     (`torch.autograd.grad(..., retain_graph=True)`), clipped to [0, 1e4]
     and detached;
  3. the generator loss's gradients with respect to the autoencoder's
     parameters only (the discriminator gets none from it) and the
     autoencoder's update;
  4. the discriminator's hinge loss on the real images and on the
     reconstruction of step 1 (detached, from before the update), in two
     calls, so its BatchNorm keeps per-call statistics; its update.

`disc_start` gates both losses (`losses.adopt_weight`). The BEV VQ-VAE
trains with one optimizer on BCE + codebook loss. Parameters and compute
are fp32; the steps leave PyTorch's TF32 settings as they find them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import torch
from torch import nn

from bevgen_torch.models.discriminator import NLayerDiscriminator
from bevgen_torch.models.stage1.vq import VQModel
from bevgen_torch.training import losses
from bevgen_torch.training.optim import vqgan_optimizer

Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass
class Stage1TrainState:
    """`model`, `optimizer` and `step` are what `CheckpointManager.save_step`
    writes: the autoencoder's parameters and its optimizer's state."""
    step: int
    model: VQModel
    optimizer: torch.optim.Adam
    disc: Optional[NLayerDiscriminator] = None
    disc_optimizer: Optional[torch.optim.Adam] = None


def create_stage1_state(model: VQModel, disc: Optional[NLayerDiscriminator],
                        lr: float) -> Stage1TrainState:
    """Step 0 with an optimizer over each network's parameters (as they are
    now: initialise them first)."""
    return Stage1TrainState(
        step=0, model=model,
        optimizer=vqgan_optimizer(model.parameters(), lr), disc=disc,
        disc_optimizer=(None if disc is None
                        else vqgan_optimizer(disc.parameters(), lr)))


def _update(optimizer: torch.optim.Optimizer, params: List[nn.Parameter],
            loss: torch.Tensor) -> None:
    grads = torch.autograd.grad(loss, params)
    for p, g in zip(params, grads):
        p.grad = g
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def _detached(log: Metrics) -> Metrics:
    return {k: v.detach() for k, v in log.items()}


def make_vqgan_train_step(lpips_fn: Optional[Callable] = None,
                          disc_start: int = 0,
                          perceptual_weight: float = 1.0,
                          codebook_weight: float = 1.0
                          ) -> Callable[[Stage1TrainState, torch.Tensor],
                                        Metrics]:
    """Returns train_step(state, x) -> metrics, which advances `state` (with
    a discriminator) in place. x: (b, H, W, C) on the model's device.
    `lpips_fn(x, xrec)` -> (b,) is the perceptual distance, or None.
    Metrics (0-d tensors): the generator and discriminator losses' logs,
    loss_ae and loss_disc."""
    perceptual_on = lpips_fn is not None and perceptual_weight > 0

    def train_step(state: Stage1TrainState, x: torch.Tensor) -> Metrics:
        model, disc = state.model, state.disc
        ae_params = list(model.parameters())
        xrec, qloss, _ = model(x)
        logits_fake = disc(xrec)
        if perceptual_on:
            perceptual = lpips_fn(x, xrec)
            rec = losses.l1(x, xrec) + perceptual_weight * perceptual.reshape(
                -1, 1, 1, 1)
        else:
            perceptual = torch.zeros(x.shape[0], device=x.device)
            rec = losses.l1(x, xrec)
        last = model.decoder.conv_out.weight
        nll_grad, = torch.autograd.grad(rec.mean(), last, retain_graph=True)
        g_grad, = torch.autograd.grad(-logits_fake.float().mean(), last,
                                      retain_graph=True)
        d_weight = losses.adaptive_disc_weight(
            torch.linalg.vector_norm(nll_grad), torch.linalg.vector_norm(g_grad))
        out = losses.vqgan_generator_loss(
            qloss, x, xrec, logits_fake, perceptual, state.step,
            disc_start=disc_start, disc_weight=d_weight,
            perceptual_weight=perceptual_weight,
            codebook_weight=codebook_weight)
        _update(state.optimizer, ae_params, out.loss)

        out_d = losses.vqgan_discriminator_loss(x, xrec, disc, state.step,
                                                disc_start=disc_start)
        _update(state.disc_optimizer, list(disc.parameters()), out_d.loss)
        state.step += 1
        return {**_detached(out.log), **_detached(out_d.log),
                "loss_ae": out.loss.detach(), "loss_disc": out_d.loss.detach()}

    return train_step


def _single_optimizer_step(loss_of: Callable[[VQModel, torch.Tensor],
                                             losses.Stage1LossOutput]):
    def train_step(state: Stage1TrainState, x: torch.Tensor) -> Metrics:
        out = loss_of(state.model, x)
        _update(state.optimizer, list(state.model.parameters()), out.loss)
        state.step += 1
        return {**_detached(out.log), "loss": out.loss.detach()}

    return train_step


def make_seg_train_step(codebook_weight: float = 1.0
                        ) -> Callable[[Stage1TrainState, torch.Tensor], Metrics]:
    """The BEV VQ-VAE step: one optimizer, BCE + codebook loss. Returns
    train_step(state, x) -> metrics (the loss's log and loss)."""

    def loss_of(model, x):
        logits, qloss, _ = model(x)
        return losses.bce_seg_loss(qloss, x, logits, codebook_weight)

    return _single_optimizer_step(loss_of)


def make_nodisc_train_step() -> Callable[[Stage1TrainState, torch.Tensor],
                                         Metrics]:
    """The RGB step without a discriminator: L1 + codebook loss
    (`losses.dummy_loss`). Returns train_step(state, x) -> metrics."""

    def loss_of(model, x):
        xrec, qloss, _ = model(x)
        return losses.dummy_loss(qloss, x, xrec)

    return _single_optimizer_step(loss_of)
