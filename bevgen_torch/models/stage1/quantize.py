"""Nearest-codebook vector quantization, and the two variant quantizers.

Port of `bevgen_tpu/models/stage1/quantize.py`: the distance argmin is one
matrix product `z @ E^T` over the whole latent grid. Ties take the first
index, as `jnp.argmin` and `torch.argmin` both do. `quantize` returns the
codebook + commitment loss with the reference's `legacy` beta placement and
a straight-through estimator, `z + (z_q - z).detach()`, so the same call
serves encoding and training.

Codebook layout: (n_embed, embed_dim) fp32.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class QuantizeResult(NamedTuple):
    z_q: torch.Tensor       # quantized latents, same shape as z (..., d)
    loss: torch.Tensor      # codebook + commitment loss (0-d, fp32)
    indices: torch.Tensor   # codebook indices, shape z.shape[:-1], int64


def nearest_indices(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """argmin_j ||z - e_j||^2 over the last dim, as ||z||^2 + ||e||^2 - 2 z.e."""
    zf = z.float()
    cb = codebook.float()
    z2 = (zf * zf).sum(-1, keepdim=True)
    e2 = (cb * cb).sum(-1)
    cross = torch.einsum("...d,nd->...n", zf, cb)
    d = z2 + e2 - 2.0 * cross
    return torch.argmin(d, dim=-1)


def quantize(z: torch.Tensor, codebook: torch.Tensor, beta: float = 0.25,
             legacy: bool = True) -> QuantizeResult:
    """Quantize `z` (..., d) against `codebook` (n, d) with an STE.

    legacy=True keeps the reference's swapped beta placement:
    loss = mean((sg[zq] - z)^2) + beta * mean((zq - sg[z])^2); legacy=False
    puts beta on the first term instead."""
    idx = nearest_indices(z, codebook)
    z_q = codebook_lookup(idx, codebook).to(z.dtype)
    zf, qf = z.float(), z_q.float()
    commit = torch.mean((qf.detach() - zf) ** 2)
    embed = torch.mean((qf - zf.detach()) ** 2)
    loss = commit + beta * embed if legacy else beta * commit + embed
    return QuantizeResult(z_q=z + (z_q - z).detach(), loss=loss, indices=idx)


def codebook_lookup(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """indices (...) -> embeddings (..., d)."""
    return codebook[indices]


def codebook_stats(indices: torch.Tensor, n_embed: int) -> Dict[str, torch.Tensor]:
    """Usage histogram statistics: perplexity and the share of codes used."""
    counts = torch.bincount(indices.reshape(-1), minlength=n_embed).float()
    probs = counts / counts.sum().clamp_min(1)
    logp = torch.log(torch.where(probs > 0, probs, torch.ones_like(probs)))
    entropy = -torch.sum(probs * logp)
    return {"codebook_perplexity": torch.exp(entropy),
            "codebook_usage": (counts > 0).float().mean()}


# ---- variant quantizers (the reference's GumbelQuantize and
# EMAVectorQuantizer) ----------------------------------------------------------


def gumbel_quantize(logits: torch.Tensor, codebook: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 1.0, hard: bool = True,
                    kl_weight: float = 5e-4) -> QuantizeResult:
    """Gumbel-softmax relaxed VQ: `logits` (..., n_embed) are projected
    scores; the soft one-hot mixes the codebook, with a KL-to-uniform
    regulariser as the loss. `generator=None` zeroes the gumbel noise
    (deterministic evaluation); otherwise the noise is drawn from it."""
    n = codebook.shape[0]
    lf = logits.float()
    if generator is None:
        g = torch.zeros_like(lf)
    else:
        u = torch.rand(lf.shape, generator=generator, device=lf.device)
        g = -torch.log(-torch.log(u.clamp(torch.finfo(u.dtype).tiny, 1.0)))
    soft = torch.softmax((lf + g) / temperature, dim=-1)
    idx = torch.argmax(soft, dim=-1)
    if hard:
        onehot = F.one_hot(idx, n).to(soft.dtype)
        soft = soft + (onehot - soft).detach()
    z_q = torch.einsum("...n,nd->...d", soft, codebook.float())
    probs = torch.softmax(lf, dim=-1)
    kl = kl_weight * torch.mean(
        torch.sum(probs * torch.log(probs * n + 1e-10), dim=-1))
    return QuantizeResult(z_q=z_q, loss=kl, indices=idx)


@torch.no_grad()
def _ema_codebook(idx: torch.Tensor, zf: torch.Tensor, cluster_size, embed_avg,
                  decay: float, eps: float):
    n, d = embed_avg.shape
    onehot = F.one_hot(idx.reshape(-1), n).float()
    counts = onehot.sum(0)
    sums = onehot.T @ zf.reshape(-1, d)
    new_cluster = cluster_size * decay + counts * (1 - decay)
    new_avg = embed_avg * decay + sums * (1 - decay)
    tot = new_cluster.sum()
    smoothed = (new_cluster + eps) / (tot + n * eps) * tot
    return new_avg / smoothed[:, None], new_cluster, new_avg


def ema_quantize(z: torch.Tensor, codebook: torch.Tensor,
                 cluster_size: torch.Tensor, embed_avg: torch.Tensor,
                 beta: float = 0.25, decay: float = 0.99, eps: float = 1e-5,
                 update: bool = True
                 ) -> Tuple[QuantizeResult,
                            Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """EMA-codebook VQ: nearest lookup and an STE commitment loss, the
    codebook kept by exponential moving averages instead of gradients.

    Returns (QuantizeResult, (new_codebook, new_cluster_size, new_embed_avg));
    with update=False the three are the inputs."""
    idx = nearest_indices(z, codebook)
    z_q = codebook_lookup(idx, codebook).to(z.dtype)
    zf = z.float()
    loss = beta * torch.mean((z_q.float().detach() - zf) ** 2)
    res = QuantizeResult(z_q=z + (z_q - z).detach(), loss=loss, indices=idx)
    if not update:
        return res, (codebook, cluster_size, embed_avg)
    return res, _ema_codebook(idx, zf, cluster_size, embed_avg, decay, eps)
