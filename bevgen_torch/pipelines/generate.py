"""End-to-end generation pipeline: BEV raster -> tokens -> images.

Port of `bevgen_tpu/pipelines/generate.py`: BEV VQ-VAE encode -> the
MaskGit decode (18 steps on the shipped presets, with its critic) ->
RGB VQ-GAN decode. The three models are submodules of one `nn.Module`
that holds the weights; `core/convert.py` loads a JAX parameter tree into
it and `init_params` fills it with seeded random weights.

The pipeline runs on the card unless the caller asks for the CPU
(`device="cpu"`); on the card every attention core of the transformer
goes through the hand-written CUDA kernel (`ops/cosine_attention.py`).

`quantized(batch_hint=)` gives the int8 W8A8 serving pipeline
(`ops/quant.py`), or keeps this one where the crossover table measured on
the card (`configs/int8_crossover.json`, written by
`scripts/crossover_sweep.py`) says bf16 serves the batch faster.

`make_sharded_generate` serves over a (dcn, dp, tp) mesh
(`parallel/sharding.py`): each data row decodes its rows of the batch, on
its own cards, with rank 0's weights; under tp the row's ranks each hold
their slice of the transformer (`parallel/tensor.py`) and decode the same
rows together.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple, Union

import torch
from torch import nn

from bevgen_torch.core.config import PipelineConfig
from bevgen_torch.core.convert import export_jax_params, load_jax_params
from bevgen_torch.core.device import resolve_device, resolve_dtype
from bevgen_torch.models.init import init_weights
from bevgen_torch.models.stage1.vq import VQModel, VQSegmentationModel
from bevgen_torch.models.stage2.maskgit import MaskGit, generate as maskgit_generate
from bevgen_torch.ops.quant import quantize_dense_tree
from bevgen_torch.parallel import sharding as shd
from bevgen_torch.parallel.tensor import shard_module_

# measured batch -> images/s of the argoverse_muse_7cam generate in bf16 and
# int8 on the card (scripts/crossover_sweep.py writes it)
CROSSOVER_TABLE = Path(__file__).resolve().parent.parent / "configs" / \
    "int8_crossover.json"


def crossover_table() -> dict:
    """The measured crossover table (`CROSSOVER_TABLE`): {"comment", "chip",
    "source", "measurements": {batch: {"bf16": images/s, "int8":
    images/s}}}. Raises OSError or ValueError where it is missing or not
    JSON."""
    with open(CROSSOVER_TABLE) as f:
        return json.load(f)


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
        with dev:   # the layers' own (discarded) default init runs there
            pipe = cls(config, resolve_dtype(dtype or config.dtype))
        return pipe.to(dev).eval()

    @property
    def device(self) -> torch.device:
        return self.first_stage.codebook.device

    def with_transformer(self, quant: str):
        """A new pipeline of this class on this device and dtype, its config's
        transformer set to `quant`, sharing this one's stage-1 models; its
        stage-2 weights are unset."""
        cfg = dataclasses.replace(self.config, transformer=self.config.
                                  transformer.replace(quant=quant))
        with self.device:
            pipe = type(self)(cfg, self.dtype)
        pipe.first_stage, pipe.cond_stage = self.first_stage, self.cond_stage
        return pipe.to(self.device).eval()

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
                    return_trajectory: bool = False,
                    shard: Optional[shd.BatchShard] = None
                    ) -> Tuple[torch.Tensor, ...]:
        """BEV raster in, camera images out: (images (b, cam, H, W, 3),
        ids (b, cam, h, w)), and with return_trajectory the (T, b, cam, hw)
        ids after every decode step as a third entry. Inputs may be numpy
        arrays or tensors; they are moved to the pipeline's device.
        `generator` (on that device) drives the gumbel and critic noise;
        with `shard` the batch is this rank's rows of a data-parallel batch
        and the noise is drawn at the global batch's shape."""
        seg, ii, ei = self.as_inputs(segmentation, intrinsics_inv,
                                     extrinsics_inv)
        cond_ids = self.encode_bev(seg)
        res = maskgit_generate(
            self.maskgit, cond_ids, ii, ei, generator, init_ids=init_ids,
            force_not_use_token_critic=force_not_use_token_critic,
            return_trajectory=return_trajectory, shard=shard)
        ids, traj = res if return_trajectory else (res, None)
        images = self.decode_tokens(ids)
        return (images, ids, traj) if return_trajectory else (images, ids)

    # ---- int8 serving ------------------------------------------------------

    # the crossover where the table is missing or unusable: int8 below this
    # batch, bf16 at or above it. From the card's table (CROSSOVER_TABLE,
    # NVIDIA H100 80GB HBM3 at 700 W): the smallest measured batch at which
    # bf16 served faster, which is the first, 1 (bf16 won at 1-16).
    INT8_CROSSOVER_BATCH = 1

    @staticmethod
    def int8_beats_bf16(batch_hint: int) -> Optional[bool]:
        """From the measured table (`crossover_table`): whether int8 served
        the nearest measured batch that has both modes faster (ties to the
        smaller batch); None when the table is missing or unusable."""
        try:
            meas = crossover_table()["measurements"]
            both = {int(b): v for b, v in meas.items()
                    if "bf16" in v and "int8" in v}
            if not both:
                return None
            nearest = min(both, key=lambda b: (abs(b - batch_hint), b))
            return both[nearest]["int8"] > both[nearest]["bf16"]
        except (OSError, ValueError, KeyError, TypeError, AttributeError):
            return None

    def quantized(self, batch_hint: Optional[int] = None) -> "BEVGenPipeline":
        """The int8 W8A8 serving pipeline: a new pipeline on this device
        whose MaskGit holds `ops.quant.quantize_dense_tree` of this one's
        weights (the JAX package's int8 tree, bit for bit) and shares the
        stage-1 models. Where the table says bf16 serves `batch_hint` faster
        it prints why and returns this pipeline itself; batch_hint=None
        quantizes whatever the batch."""
        if batch_hint is not None:
            wins = self.int8_beats_bf16(batch_hint)
            if wins is None:  # no table: the fallback threshold
                wins = batch_hint < self.INT8_CROSSOVER_BATCH
            if not wins:
                print(f"[quantized] bf16 measured faster than int8 at batch "
                      f"{batch_hint} (configs/int8_crossover.json) -- keeping "
                      f"bf16")
                return self
        pipe = self.with_transformer("int8")
        load_jax_params(pipe.maskgit,
                        quantize_dense_tree(export_jax_params(self.maskgit)))
        return pipe


def stage2_model(pipe: Stage1Pipeline) -> nn.Module:
    """The pipeline's transformer: the MaskGit, or the AR pipeline's GPT."""
    model = getattr(pipe, "maskgit", None)
    return model if isinstance(model, nn.Module) else pipe.gpt


def make_sharded_generate(pipe: Stage1Pipeline, mesh: shd.Mesh):
    """Serving over `mesh` (the counterpart of the JAX package's
    `make_sharded_generate`: batch over (dcn, dp), the transformer's heads
    and FFN hidden over tp). Returns (run, shard_params, shard_batch):

      shard_params(pipe) -> pipe, with rank 0's parameters on every rank,
        and under tp the transformer cut to this rank's slice, in place
        (`parallel.tensor.shard_module_`);
      shard_batch(*arrays) -> this data row's rows of global batch arrays;
      run(seg, ii, ei, generator, **kw) -> (images, ids) of this row's
        rows, the same on every tp rank of the row: `pipe.generate_fn` with
        the draws made at the global batch, so the rows together are what
        one process generates for the whole batch from an equally seeded
        generator.

    A quantized pipeline (`quantized()`, the whole tree quantized on each
    rank first, as the JAX package quantizes before `shard_params`) serves
    the same way: broadcast, then cut by the same plan (`kernel_q` as the
    kernel, `scale` with the output axis). So does the fused-glue form,
    its GEGLU + LayerNorm split over the rank's hidden columns. Works for
    `BEVGenPipeline` and `ar_generate.ARPipeline` alike."""

    def shard_params(p: Stage1Pipeline) -> Stage1Pipeline:
        mesh.broadcast_module(p)
        shard_module_(stage2_model(p), mesh)
        return p

    def shard_batch(*arrays):
        return shd.shard_batch(arrays, mesh, pipe.device)

    def run(segmentation, intrinsics_inv, extrinsics_inv,
            generator: Optional[torch.Generator] = None, **kw):
        return pipe.generate_fn(segmentation, intrinsics_inv, extrinsics_inv,
                                generator, shard=mesh.batch_shard(
                                    len(segmentation)), **kw)

    return run, shard_params, shard_batch
