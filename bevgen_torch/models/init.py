"""Seeded random weights for any module of the port (the pipeline, a
MaskGit alone for training, the stage-1 models, the discriminator, LPIPS)."""
from __future__ import annotations

import contextlib
import hashlib
import math

import torch
from torch import nn

from bevgen_torch.models.discriminator import BatchNorm
from bevgen_torch.ops.quant import QUANT_MODULES, init_quant_param

_NORMS = (nn.LayerNorm, nn.GroupNorm, BatchNorm)

# While `reuse_draws` is on: {"draws": {prefix key: (the drawn value or
# None for a constant, the generator's state after it)}, "bytes": of the
# values kept, "limit": their most}
_reuse = None


@contextlib.contextmanager
def reuse_draws(max_bytes: int):
    """Within this block `init_weights` keeps each value it draws, up to
    `max_bytes` of them, by the seed and by the names, owners and shapes of
    the parameters up to that one (which decide the draw), and copies it
    instead of drawing again where a later module repeats that prefix: for
    a program that builds the same seeded models many times. The weights
    are the same as without it."""
    global _reuse
    outer = _reuse
    _reuse = outer or {"draws": {}, "bytes": 0, "limit": max_bytes}
    try:
        yield
    finally:
        _reuse = outer


def _value(owner: nn.Module, leaf: str, shape, gen) -> torch.Tensor:
    if isinstance(owner, QUANT_MODULES):
        return init_quant_param(owner, leaf, shape, gen)
    if isinstance(owner, (nn.Linear, nn.Conv2d)) and leaf == "weight":
        std = 1.0 / math.sqrt(math.prod(shape[1:]))
        return nn.init.trunc_normal_(torch.empty(shape), 0.0, std, -2 * std,
                                     2 * std, generator=gen)
    if isinstance(owner, nn.Embedding):
        return torch.randn(shape, generator=gen) / math.sqrt(shape[1])
    if isinstance(owner, _NORMS) and leaf == "weight":
        return torch.ones(shape)
    if leaf == "null_kv":
        return torch.randn(shape, generator=gen)
    if leaf in ("q_scale", "k_scale", "scale"):  # scale: ActNorm's
        return torch.ones(shape)
    if leaf == "codebook":
        return (torch.rand(shape, generator=gen) * 2 - 1) / shape[0]
    # biases, ActNorm loc, camera_bias_emb, bev_cam_pos_emb
    return torch.zeros(shape)


@torch.no_grad()
def init_weights(module: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter of `module` with seeded random values, drawn on
    the CPU so they do not depend on the device: fan-in-scaled truncated
    normals for linear and conv weights, 1/sqrt(dim)-scaled normals for
    embeddings, the reference's constants for the rest (unit norm scales
    and q/k scales, zero biases, ActNorm locs and camera-bias table,
    unit-normal null_kv, uniform +-1/n_embed codebooks; the int8 modules' kernels, scales and
    in_scales as `ops.quant.init_quant_param` draws them). Returns
    `module`."""
    gen = torch.Generator().manual_seed(seed)
    key = hashlib.sha1(repr(seed).encode())
    state = None if _reuse is None else gen.get_state()
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        if _reuse is None:
            p.copy_(_value(owner, leaf, p.shape, gen))
            continue
        cls = type(owner)
        key.update(repr((name, f"{cls.__module__}.{cls.__qualname__}",
                         tuple(p.shape))).encode())
        kept = _reuse["draws"].get(key.digest())
        if kept is None:
            gen.set_state(state)
            val = _value(owner, leaf, p.shape, gen)
            after = gen.get_state()
            drawn = not torch.equal(after, state)
            state = after
            nbytes = val.numel() * val.element_size() if drawn else 0
            if _reuse["bytes"] + nbytes <= _reuse["limit"]:
                _reuse["draws"][key.digest()] = (val if drawn else None, state)
                _reuse["bytes"] += nbytes
        else:
            val, state = kept
            if val is None:   # a constant: no draw
                val = _value(owner, leaf, p.shape, gen)
        p.copy_(val)
    return module
