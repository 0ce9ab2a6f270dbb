"""Nearest-codebook vector quantization (inference).

Port of `bevgen_tpu/models/stage1/quantize.py`: the distance argmin is one
matrix product `z @ E^T` over the whole latent grid. Ties take the first
index, as `jnp.argmin` and `torch.argmin` both do.

Codebook layout: (n_embed, embed_dim) fp32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizeResult(NamedTuple):
    z_q: torch.Tensor       # quantized latents, same shape as z (..., d)
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


def quantize(z: torch.Tensor, codebook: torch.Tensor) -> QuantizeResult:
    """Quantize `z` (..., d) against `codebook` (n, d): nearest indices and
    the codebook vectors in z's dtype (the straight-through estimator of
    training is not needed at inference)."""
    idx = nearest_indices(z, codebook)
    return QuantizeResult(z_q=codebook_lookup(idx, codebook).to(z.dtype),
                          indices=idx)


def codebook_lookup(indices: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """indices (...) -> embeddings (..., d)."""
    return codebook[indices]
