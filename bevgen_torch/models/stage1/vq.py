"""Stage-1 VQ models: RGB VQ-GAN and BEV VQ-VAE (inference).

Port of `bevgen_tpu/models/stage1/vq.py`: `encode` (indices and quantized
latents) and `decode_code`. Public tensors keep the reference's NHWC
layout; the backbone runs NCHW inside. The geometric embedding is off in
the shipped configs and not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from bevgen_torch.core.config import Stage1Config
from bevgen_torch.models.stage1 import quantize as vq
from bevgen_torch.models.stage1.backbone import Decoder, Encoder, conv1x1


class EncodeResult(NamedTuple):
    z_q: torch.Tensor       # (b, h, w, embed_dim)
    indices: torch.Tensor   # (b, h, w) int64


class VQModel(nn.Module):
    """RGB VQ-GAN autoencoder. Input/output NHWC float images."""

    def __init__(self, cfg: Stage1Config, dtype=torch.float32):
        super().__init__()
        if cfg.geometric_embedding:
            raise NotImplementedError(
                "stage-1 geometric embedding is not ported yet")
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.quant_conv = conv1x1(cfg.z_channels, cfg.embed_dim, dtype)
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels, dtype)
        self.codebook = nn.Parameter(torch.empty(cfg.n_embed, cfg.embed_dim))

    def encode(self, x: torch.Tensor) -> EncodeResult:
        """x (b, H, W, C) -> EncodeResult with (b, h, w) indices."""
        h = self.encoder(x.to(self.dtype).permute(0, 3, 1, 2))
        h = self.quant_conv(h).permute(0, 2, 3, 1)
        z_q, idx = vq.quantize(h, self.codebook)
        return EncodeResult(z_q=z_q, indices=idx)

    def decode(self, z_q: torch.Tensor) -> torch.Tensor:
        """z_q (b, h, w, embed_dim) -> image (b, H, W, out_ch)."""
        h = self.post_quant_conv(z_q.to(self.dtype).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    def decode_code(self, indices: torch.Tensor) -> torch.Tensor:
        """Codebook indices (b, h, w) -> image (b, H, W, out_ch)."""
        return self.decode(vq.codebook_lookup(indices, self.codebook))


class VQSegmentationModel(VQModel):
    """BEV VQ-VAE over n_labels-channel semantic rasters: the same
    autoencoder."""
