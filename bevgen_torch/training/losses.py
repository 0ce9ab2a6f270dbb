"""Stage-1 training losses.

Port of `bevgen_tpu/training/losses.py`, with its log keys. The shipped
reference configs train with `DummyLoss` (reconstruction + codebook loss);
the full VQ-GAN objective (L1 + LPIPS + the adaptive-weight PatchGAN hinge
loss) follows the taming-transformers lineage the reference vendors. The
BEV segmentation model uses BCE-with-logits + codebook loss. Every loss is
computed in fp32.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Union

import torch
import torch.nn.functional as F


def l1(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.abs(a.float() - b.float())


def hinge_d_loss(logits_real: torch.Tensor,
                 logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def vanilla_d_loss(logits_real: torch.Tensor,
                   logits_fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-logits_real))
                  + torch.mean(F.softplus(logits_fake)))


def adopt_weight(weight: float, global_step: int, threshold: int) -> float:
    """Zero until `threshold` steps (the discriminator's warm-up gate)."""
    return 0.0 if global_step < threshold else weight


def adaptive_disc_weight(nll_grad_norm: torch.Tensor,
                         g_grad_norm: torch.Tensor,
                         disc_weight_max: float = 1e4) -> torch.Tensor:
    """taming's balance |grad nll| / |grad g| on the decoder's last layer,
    clipped to [0, disc_weight_max] and detached."""
    w = nll_grad_norm / (g_grad_norm + 1e-4)
    return torch.clamp(w, 0.0, disc_weight_max).detach()


class Stage1LossOutput(NamedTuple):
    loss: torch.Tensor
    log: Dict[str, torch.Tensor]


def dummy_loss(qloss: torch.Tensor, x: torch.Tensor, xrec: torch.Tensor,
               split: str = "train") -> Stage1LossOutput:
    """The reference's shipped loss: reconstruction L1 + codebook loss, no
    discriminator."""
    rec = torch.mean(l1(x, xrec))
    total = rec + qloss
    return Stage1LossOutput(total, {
        f"{split}/rec_loss": rec, f"{split}/quant_loss": qloss,
        f"{split}/total_loss": total})


def bce_seg_loss(qloss: torch.Tensor, x: torch.Tensor, logits: torch.Tensor,
                 codebook_weight: float = 1.0,
                 split: str = "train") -> Stage1LossOutput:
    """BCE-with-logits (its stable form) + codebook loss, for the BEV
    VQ-VAE."""
    xf, lf = x.float(), logits.float()
    bce = torch.mean(F.relu(lf) - lf * xf + torch.log1p(torch.exp(-lf.abs())))
    total = bce + codebook_weight * qloss
    return Stage1LossOutput(total, {
        f"{split}/bce_loss": bce, f"{split}/quant_loss": qloss,
        f"{split}/total_loss": total})


def vqgan_generator_loss(qloss: torch.Tensor, x: torch.Tensor,
                         xrec: torch.Tensor, logits_fake: torch.Tensor,
                         perceptual: Union[torch.Tensor, float],
                         global_step: int, disc_start: int = 0,
                         disc_weight: Union[torch.Tensor, float] = 1.0,
                         disc_factor: float = 1.0,
                         perceptual_weight: float = 1.0,
                         codebook_weight: float = 1.0,
                         split: str = "train") -> Stage1LossOutput:
    """The generator side of the VQ-GAN objective. `perceptual` is the
    per-sample LPIPS(x, xrec) vector (or 0.0 without weights);
    `disc_weight` the adaptive weight."""
    rec = l1(x, xrec)
    if perceptual_weight > 0:
        p = torch.as_tensor(perceptual, dtype=torch.float32, device=rec.device)
        rec = rec + perceptual_weight * p.reshape((-1,) + (1,) * (rec.ndim - 1))
    nll = torch.mean(rec)
    g_loss = -torch.mean(logits_fake.float())
    factor = adopt_weight(disc_factor, global_step, disc_start)
    disc_weight = torch.as_tensor(disc_weight, dtype=torch.float32,
                                  device=rec.device)
    total = nll + disc_weight * factor * g_loss + codebook_weight * qloss
    return Stage1LossOutput(total, {
        f"{split}/nll_loss": nll, f"{split}/g_loss": g_loss,
        f"{split}/quant_loss": qloss, f"{split}/d_weight": disc_weight,
        f"{split}/total_loss": total})


def vqgan_discriminator_loss(x: torch.Tensor, xrec: torch.Tensor,
                             disc: Callable[[torch.Tensor], torch.Tensor],
                             global_step: int, disc_start: int = 0,
                             disc_factor: float = 1.0,
                             loss_type: str = "hinge",
                             split: str = "train") -> Stage1LossOutput:
    """The discriminator side: real and reconstructed images (both
    detached) go through `disc` in two separate calls, so a BatchNorm keeps
    per-call statistics."""
    logits_real = disc(x.detach())
    logits_fake = disc(xrec.detach())
    fn = hinge_d_loss if loss_type == "hinge" else vanilla_d_loss
    factor = adopt_weight(disc_factor, global_step, disc_start)
    d_loss = factor * fn(logits_real.float(), logits_fake.float())
    return Stage1LossOutput(d_loss, {
        f"{split}/disc_loss": d_loss,
        f"{split}/logits_real": torch.mean(logits_real),
        f"{split}/logits_fake": torch.mean(logits_fake)})
