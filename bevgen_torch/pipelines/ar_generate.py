"""End-to-end AR generation pipeline: BEV raster -> tokens -> images.

Port of `bevgen_tpu/pipelines/ar_generate.py` (`ARPipeline`), the
nuScenes counterpart of `pipelines/generate.BEVGenPipeline`: BEV VQ-VAE
encode -> the autoregressive sparse-GPT decode in the outward order
(KV-cached by default, `models/stage2/ar_cached.py`; or one full forward per
token, `models/stage2/ar.py`) -> RGB VQ-GAN decode. Partial decoding keeps
the `init_ids` cameras.

On the card the cached decode runs every layer's attention through the
decode-attention kernel (`ops/decode_attention.py`) and the full-forward
sampler through the block-sparse kernel (`ops/block_sparse.py`).
`quantized()` gives the int8-weight serving pipeline
(`ops.quant.quantize_gpt_tree`, its products through the `w8_linear`
kernel), which serves KV-cached only. `make_sharded_ar_generate` serves
over a (dcn, dp, tp) mesh, as `generate.make_sharded_generate` does: the
batch over dcn x dp, the GPT's heads and MLP over tp.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from bevgen_torch.core.config import PipelineConfig
from bevgen_torch.core.convert import export_jax_params, load_jax_params
from bevgen_torch.models.stage2 import ar, ar_cached
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.ops.quant import quantize_gpt_tree
from bevgen_torch.parallel.sharding import BatchShard, Mesh
from bevgen_torch.pipelines.generate import (Stage1Pipeline,
                                             make_sharded_generate)


class ARPipeline(Stage1Pipeline):
    """The two stage-1 models, the sparse GPT and their config."""

    def __init__(self, config: PipelineConfig, dtype: torch.dtype):
        super().__init__(config, dtype)
        self.gpt = SparseGPT(config.transformer, dtype)

    def quantized(self, batch_hint: Optional[int] = None) -> "ARPipeline":
        """The int8-weight serving pipeline: a new pipeline on this device
        whose GPT holds `ops.quant.quantize_gpt_tree` of this one's weights
        (the six dense layers as int8 weights, biases kept; the compute
        stays in the compute dtype) and shares the stage-1 models.
        `batch_hint` is taken for symmetry with `BEVGenPipeline.quantized`
        and not read: no crossover was measured on this path, so it always
        quantizes, as the reference's does."""
        del batch_hint
        pipe = self.with_transformer("int8")
        load_jax_params(pipe.gpt, quantize_gpt_tree(export_jax_params(self.gpt)))
        return pipe

    @torch.inference_mode()
    def generate_fn(self, segmentation, intrinsics_inv, extrinsics_inv,
                    generator: Optional[torch.Generator] = None,
                    temperature: float = 1.0, top_k: Optional[int] = 100,
                    init_ids: Optional[torch.Tensor] = None,
                    cached: bool = True,
                    shard: Optional[BatchShard] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """BEV raster in, camera images out: (images (b, cam, H, W, 3), ids
        (b, cam, h, w)). Inputs may be numpy arrays or tensors; they are
        moved to the pipeline's device. `generator` (on that device) drives
        the token draws (with `shard`, at the global batch's shape: the
        batch is this rank's rows). cached=False runs the reference-parity
        sampler, one full forward per token (not for the int8 tree: it
        raises)."""
        if not cached and self.config.transformer.quant != "none":
            raise ValueError("the int8 AR pipeline serves KV-cached only "
                             "(cached=True): the full forward takes the "
                             "unquantized tree")
        seg, ii, ei = self.as_inputs(segmentation, intrinsics_inv,
                                     extrinsics_inv)
        cond_ids = self.encode_bev(seg)
        sample = ar_cached.ar_sample_cached if cached else ar.ar_sample
        ids = sample(self.gpt, cond_ids, ii, ei, generator,
                     temperature=temperature, top_k=top_k, init_ids=init_ids,
                     shard=shard)
        return self.decode_tokens(ids), ids


def make_sharded_ar_generate(pipe: ARPipeline, mesh: Mesh):
    """AR serving over `mesh` (the counterpart of the JAX package's
    `make_sharded_ar_generate`: batch over dcn x dp, GPT weights over tp):
    (run, shard_params, shard_batch) as `generate.make_sharded_generate`
    returns them; run(seg, ii, ei, generator, **kw) decodes this data row's
    rows with the token draws made at the global batch."""
    return make_sharded_generate(pipe, mesh)
