"""End-to-end generation pipeline: BEV raster -> tokens -> images.

Port of `bevgen_tpu/pipelines/generate.py`: BEV VQ-VAE encode -> the
MaskGit decode (18 steps on the shipped presets, with the self-critic) ->
RGB VQ-GAN decode. The three models are submodules of one `nn.Module`
that holds the weights; `core/convert.py` loads a JAX parameter tree into
it and `init_params` fills it with seeded random weights.

The pipeline runs on the card unless the caller asks for the CPU
(`device="cpu"`); on the card every attention core of the transformer
goes through the hand-written CUDA kernel (`ops/cosine_attention.py`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch import nn

from bevgen_torch.core.config import PipelineConfig
from bevgen_torch.core.device import resolve_device, resolve_dtype
from bevgen_torch.models.stage1.vq import VQModel, VQSegmentationModel
from bevgen_torch.models.stage2.maskgit import MaskGit, generate as maskgit_generate


class BEVGenPipeline(nn.Module):
    """The three models + their config."""

    def __init__(self, config: PipelineConfig, dtype: torch.dtype):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.first_stage = VQModel(config.first_stage, dtype)
        self.cond_stage = VQSegmentationModel(config.cond_stage, dtype)
        self.maskgit = MaskGit(config.transformer, config.muse, dtype)

    @classmethod
    def create(cls, config: PipelineConfig,
               device: Union[str, torch.device, None] = "cuda",
               dtype: Union[str, torch.dtype, None] = None) -> "BEVGenPipeline":
        """Build the pipeline on `device` (CUDA unless asked otherwise;
        raises without a GPU) in `dtype` (default: config.dtype). Weights
        are uninitialised until `init_params` or `load_jax_params`."""
        dev = resolve_device(device)
        pipe = cls(config, resolve_dtype(dtype or config.dtype))
        return pipe.to(dev).eval()

    @property
    def device(self) -> torch.device:
        return self.first_stage.codebook.device

    @torch.no_grad()
    def init_params(self, seed: int = 0) -> "BEVGenPipeline":
        """Seeded random weights, drawn on the CPU so they do not depend on
        the device: fan-in-scaled truncated normals for linear and conv
        weights, 1/sqrt(dim)-scaled normals for embeddings, the reference's
        constants for the rest (unit norm scales and q/k scales, zero
        biases and camera-bias table, unit-normal null_kv, uniform
        +-1/n_embed codebooks)."""
        gen = torch.Generator().manual_seed(seed)

        def normal(shape, std):
            w = torch.empty(shape)
            return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                         generator=gen)

        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = self.get_submodule(name.rsplit(".", 1)[0])
            if isinstance(owner, (nn.Linear, nn.Conv2d)) and leaf == "weight":
                val = normal(p.shape, 1.0 / math.sqrt(p[0].numel()))
            elif isinstance(owner, nn.Embedding):
                val = torch.randn(p.shape, generator=gen) / math.sqrt(p.shape[1])
            elif isinstance(owner, (nn.LayerNorm, nn.GroupNorm)) and leaf == "weight":
                val = torch.ones(p.shape)
            elif leaf == "null_kv":
                val = torch.randn(p.shape, generator=gen)
            elif leaf in ("q_scale", "k_scale"):
                val = torch.ones(p.shape)
            elif leaf == "codebook":
                n = p.shape[0]
                val = (torch.rand(p.shape, generator=gen) * 2 - 1) / n
            else:  # biases, camera_bias_emb, bev_cam_pos_emb
                val = torch.zeros(p.shape)
            p.copy_(val)
        return self

    # ---- stage-1 wrappers ------------------------------------------------

    @torch.inference_mode()
    def encode_bev(self, segmentation: torch.Tensor) -> torch.Tensor:
        """(b, bev, bev, n_labels) -> (b, num_cond) int64 tokens."""
        enc = self.cond_stage.encode(segmentation)
        return enc.indices.reshape(segmentation.shape[0], -1)

    @torch.inference_mode()
    def decode_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """(b, cam, h, w) -> (b, cam, H, W, 3) images."""
        b, cam, h, w = ids.shape
        img = self.first_stage.decode_code(ids.reshape(b * cam, h, w))
        return img.reshape(b, cam, *img.shape[1:])

    # ---- the headline path ----------------------------------------------

    @torch.inference_mode()
    def generate_fn(self, segmentation, intrinsics_inv, extrinsics_inv,
                    generator: Optional[torch.Generator] = None,
                    init_ids: Optional[torch.Tensor] = None,
                    force_not_use_token_critic: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """BEV raster in, camera images out: (images (b, cam, H, W, 3),
        ids (b, cam, h, w)). Inputs may be numpy arrays or tensors; they
        are moved to the pipeline's device. `generator` (on that device)
        drives the gumbel and critic noise."""
        dev = self.device
        seg, ii, ei = (torch.as_tensor(a, device=dev).float()
                       for a in (segmentation, intrinsics_inv, extrinsics_inv))
        cond_ids = self.encode_bev(seg)
        ids = maskgit_generate(
            self.maskgit, cond_ids, ii, ei, generator, init_ids=init_ids,
            force_not_use_token_critic=force_not_use_token_critic)
        return self.decode_tokens(ids), ids
