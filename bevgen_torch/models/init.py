"""Seeded random weights for any module of the port (the pipeline, or a
MaskGit alone for training)."""
from __future__ import annotations

import math

import torch
from torch import nn

from bevgen_torch.ops.quant import QUANT_MODULES, init_quant_param


@torch.no_grad()
def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of `module` with seeded random values, drawn on
    the CPU so they do not depend on the device: fan-in-scaled truncated
    normals for linear and conv weights, 1/sqrt(dim)-scaled normals for
    embeddings, the reference's constants for the rest (unit norm scales
    and q/k scales, zero biases and camera-bias table, unit-normal null_kv,
    uniform +-1/n_embed codebooks; the int8 modules' kernels, scales and
    in_scales as `ops.quant.init_quant_param` draws them). Returns
    `module`."""
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        w = torch.empty(shape)
        return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                     generator=gen)

    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if isinstance(owner, QUANT_MODULES):
            val = init_quant_param(owner, leaf, p.shape, gen)
        elif isinstance(owner, (nn.Linear, nn.Conv2d)) and leaf == "weight":
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
    return module
