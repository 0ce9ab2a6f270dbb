"""Stage-1 VQ models: RGB VQ-GAN and BEV VQ-VAE (inference).

Port of `bevgen_tpu/models/stage1/vq.py`: `encode` (indices and quantized
latents, with the optional camera-ray geometric embedding added to the
encoder features) and `decode_code`. Public tensors keep the reference's
NHWC layout; the backbone runs NCHW inside.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from bevgen_torch.core.config import Stage1Config
from bevgen_torch.models import geometry
from bevgen_torch.models.stage1 import quantize as vq
from bevgen_torch.models.stage1.backbone import Decoder, Encoder, conv1x1


class EncodeResult(NamedTuple):
    z_q: torch.Tensor       # (b, h, w, embed_dim)
    indices: torch.Tensor   # (b, h, w) int64


class VQModel(nn.Module):
    """RGB VQ-GAN autoencoder. Input/output NHWC float images."""

    def __init__(self, cfg: Stage1Config, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        self.encoder = Encoder(cfg, dtype)
        self.decoder = Decoder(cfg, dtype)
        self.quant_conv = conv1x1(cfg.z_channels, cfg.embed_dim, dtype)
        self.post_quant_conv = conv1x1(cfg.embed_dim, cfg.z_channels, dtype)
        self.codebook = nn.Parameter(torch.empty(cfg.n_embed, cfg.embed_dim))
        if cfg.geometric_embedding:
            self.img_embed = conv1x1(4, cfg.cam_emd_dim, dtype, bias=False)
            self.cam_embed = conv1x1(4, cfg.cam_emd_dim, dtype, bias=False)

    def geometric_features(self, intrinsics_inv: torch.Tensor,
                           extrinsics_inv: torch.Tensor) -> torch.Tensor:
        """Normalised camera-ray embedding at latent resolution, (b, h, w,
        cam_emd_dim). intrinsics_inv (b, 3, 3), extrinsics_inv (b, 4, 4),
        already flattened over cameras. The rays are formed in fp32."""
        h, w = self.cfg.cam_latent_res
        ii = intrinsics_inv.float()
        ei = extrinsics_inv.float()
        flat = torch.as_tensor(generate_plane(self.cfg).reshape(3, -1),
                               device=ii.device)
        cam = ii @ flat                                           # (b, 3, hw)
        cam = torch.cat([cam, torch.ones_like(cam[:, :1])], 1)    # (b, 4, hw)
        d = (ei @ cam).transpose(1, 2).reshape(-1, h, w, 4)       # (b, h, w, 4)
        c = ei[:, :, -1]                                          # (b, 4)
        d_emb = F.linear(d.to(self.dtype), self.img_embed.weight[:, :, 0, 0])
        c_emb = F.linear(c.to(self.dtype), self.cam_embed.weight[:, :, 0, 0])
        emb = (d_emb - c_emb[:, None, None, :]).float()
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return (emb / (norm + 1e-7)).to(self.dtype)

    def encode(self, x: torch.Tensor,
               intrinsics_inv: Optional[torch.Tensor] = None,
               extrinsics_inv: Optional[torch.Tensor] = None) -> EncodeResult:
        """x (b, H, W, C) -> EncodeResult with (b, h, w) indices. With the
        geometric embedding on, the camera matrices of each image are
        required."""
        h = self.encoder(x.to(self.dtype).permute(0, 3, 1, 2))
        if self.cfg.geometric_embedding:
            if intrinsics_inv is None or extrinsics_inv is None:
                raise ValueError(
                    "first_stage.geometric_embedding is on: encode needs "
                    "intrinsics_inv and extrinsics_inv")
            h = h + self.geometric_features(
                intrinsics_inv, extrinsics_inv).permute(0, 3, 1, 2)
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


def generate_plane(cfg: Stage1Config) -> np.ndarray:
    """Latent-resolution pixel plane, (3, h, w) fp32: channel 0 (x) scaled by
    the image WIDTH, channel 1 (y) by its HEIGHT. Stage 1 does not have the
    stage-2 (h, w)-swap quirk of `geometry.image_plane`."""
    g = geometry.generate_grid(cfg.cam_latent_res[0],
                               cfg.cam_latent_res[1]).copy()
    g[0] *= cfg.cam_res[1]
    g[1] *= cfg.cam_res[0]
    return g
