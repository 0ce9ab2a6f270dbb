"""End-to-end generation pipeline: BEV raster -> tokens -> images.

Port of `bevgen_tpu/pipelines/generate.py`: BEV VQ-VAE encode -> the
MaskGit decode (18 steps on the shipped presets, with its critic) ->
RGB VQ-GAN decode. The three models are submodules of one `nn.Module`
that holds the weights; `core/convert.py` loads a JAX parameter tree into
it and `init_params` fills it with seeded random weights.

The pipeline runs on the card unless the caller asks for the CPU
(`device="cpu"`); on the card every attention core of the transformer
goes through the hand-written CUDA kernel (`ops/cosine_attention.py`).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from bevgen_torch.core.config import PipelineConfig
from bevgen_torch.core.device import resolve_device, resolve_dtype
from bevgen_torch.models.init import init_weights
from bevgen_torch.models.stage1.vq import VQModel, VQSegmentationModel
from bevgen_torch.models.stage2.maskgit import MaskGit, generate as maskgit_generate


class Stage1Pipeline(nn.Module):
    """The two stage-1 models, their config and the wrappers that both
    serving pipelines (MUSE here, AR in `ar_generate.py`) share."""

    def __init__(self, config: PipelineConfig, dtype: torch.dtype):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.first_stage = VQModel(config.first_stage, dtype)
        self.cond_stage = VQSegmentationModel(config.cond_stage, dtype)

    @classmethod
    def create(cls, config: PipelineConfig,
               device: Union[str, torch.device, None] = "cuda",
               dtype: Union[str, torch.dtype, None] = None):
        """Build the pipeline on `device` (CUDA unless asked otherwise;
        raises without a GPU) in `dtype` (default: config.dtype). Weights
        are uninitialised until `init_params` or `load_jax_params`."""
        dev = resolve_device(device)
        pipe = cls(config, resolve_dtype(dtype or config.dtype))
        return pipe.to(dev).eval()

    @property
    def device(self) -> torch.device:
        return self.first_stage.codebook.device

    def init_params(self, seed: int = 0):
        """Seeded random weights (`models.init.init_weights`)."""
        return init_weights(self, seed)

    def as_inputs(self, *arrays) -> Tuple[torch.Tensor, ...]:
        """Numpy arrays or tensors as fp32 tensors on the pipeline's device."""
        return tuple(torch.as_tensor(a, device=self.device).float()
                     for a in arrays)

    # ---- stage-1 wrappers ------------------------------------------------

    @torch.inference_mode()
    def encode_bev(self, segmentation: torch.Tensor) -> torch.Tensor:
        """(b, bev, bev, n_labels) -> (b, num_cond) int64 tokens."""
        enc = self.cond_stage.encode(segmentation)
        return enc.indices.reshape(segmentation.shape[0], -1)

    @torch.inference_mode()
    def encode_images(self, images) -> torch.Tensor:
        """(b, cam, H, W, 3) camera images (numpy or tensor) -> (b, cam, hw)
        int64 tokens. Like the reference, it passes no camera matrices, so a
        first stage with the geometric embedding raises here: call
        `first_stage.encode(x, intrinsics_inv, extrinsics_inv)` instead."""
        (images,) = self.as_inputs(images)
        b, cam = images.shape[:2]
        enc = self.first_stage.encode(images.reshape(b * cam,
                                                     *images.shape[2:]))
        return enc.indices.reshape(b, cam, -1)

    @torch.inference_mode()
    def decode_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """(b, cam, h, w) -> (b, cam, H, W, 3) images."""
        b, cam, h, w = ids.shape
        img = self.first_stage.decode_code(ids.reshape(b * cam, h, w))
        return img.reshape(b, cam, *img.shape[1:])


class BEVGenPipeline(Stage1Pipeline):
    """The three models of the MUSE path + their config."""

    def __init__(self, config: PipelineConfig, dtype: torch.dtype):
        super().__init__(config, dtype)
        self.maskgit = MaskGit(config.transformer, config.muse, dtype)

    # ---- the headline path ----------------------------------------------

    @torch.inference_mode()
    def generate_fn(self, segmentation, intrinsics_inv, extrinsics_inv,
                    generator: Optional[torch.Generator] = None,
                    init_ids: Optional[torch.Tensor] = None,
                    force_not_use_token_critic: bool = False,
                    return_trajectory: bool = False
                    ) -> Tuple[torch.Tensor, ...]:
        """BEV raster in, camera images out: (images (b, cam, H, W, 3),
        ids (b, cam, h, w)), and with return_trajectory the (T, b, cam, hw)
        ids after every decode step as a third entry. Inputs may be numpy
        arrays or tensors; they are moved to the pipeline's device.
        `generator` (on that device) drives the gumbel and critic noise."""
        seg, ii, ei = self.as_inputs(segmentation, intrinsics_inv,
                                     extrinsics_inv)
        cond_ids = self.encode_bev(seg)
        res = maskgit_generate(
            self.maskgit, cond_ids, ii, ei, generator, init_ids=init_ids,
            force_not_use_token_critic=force_not_use_token_critic,
            return_trajectory=return_trajectory)
        ids, traj = res if return_trajectory else (res, None)
        images = self.decode_tokens(ids)
        return (images, ids, traj) if return_trajectory else (images, ids)
