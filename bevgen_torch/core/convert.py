"""Load the JAX pipeline's parameter tree into the port's modules.

`load_jax_params(pipeline, tree)` takes the reference pipeline's parameter
dict, `{"first_stage", "cond_stage", "maskgit"}` for the MUSE pipeline or
`{"first_stage", "cond_stage", "gpt"}` for the AR one (each optionally
wrapped in flax's `{"params": ...}`), or a bare model's own tree, with
every leaf a numpy array. The port's submodules carry the reference's
names, so a leaf at `maskgit/transformer/layers_0_attn/to_q/kernel` lands
in `maskgit.transformer.layers_0_attn.to_q.weight`, and one at
`gpt/block_0/ln1/norm/bias` in `gpt.block_0.ln1.norm.bias`. Leaf
conversions:

  * Dense kernel (in, out)        -> Linear weight (out, in)
  * Conv kernel HWIO              -> Conv2d weight OIHW
  * LayerNorm/GroupNorm `scale`   -> `weight`;  Embed `embedding` -> `weight`
  * `bias`, `codebook`, `null_kv`, `q_scale`, `k_scale`,
    `camera_bias_emb`, `bev_cam_pos_emb`, `x_pos_emb`, `cond_pos_emb` as
    they are.

Raises on a leaf the port has no parameter for, on a port parameter left
unset, and on a shape mismatch.

`export_jax_params(module, tensors=None)` is the inverse: the port's
parameters (or any tensors by parameter name, such as gradients) as the
reference's numpy tree, so port-trained weights load into the JAX package
and the tests compare trees leaf by leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


def pipeline_parts(module: nn.Module) -> Tuple[str, ...]:
    """The reference pipeline's top-level parts that `module` holds:
    (first_stage, cond_stage, maskgit) for the MUSE pipeline, (first_stage,
    cond_stage, gpt) for the AR one; () for a bare model."""
    parts = ("first_stage", "cond_stage", "maskgit", "gpt")
    have = tuple(p for p in parts if isinstance(getattr(module, p, None),
                                                nn.Module))
    return have if {"first_stage", "cond_stage"} <= set(have) else ()


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def _convert(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


def _unwrap(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


@torch.no_grad()
def load_jax_params(pipeline: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy every leaf of `tree` into `pipeline`'s parameters (converting
    layouts and dtypes); see the module docstring. `pipeline` is a serving
    pipeline (tree: its parts) or a bare model such as a `SparseGPT` (tree:
    that model's own tree)."""
    params: Dict[str, torch.Tensor] = dict(pipeline.named_parameters())
    unset = set(params)
    unknown = []
    parts = pipeline_parts(pipeline)
    if parts:
        for part in parts:
            if part not in tree:
                raise KeyError(f"parameter tree has no {part!r} entry")
        unknown.extend(k for k in tree if k not in parts)
        subtrees = [((part,), _unwrap(tree[part])) for part in parts]
    else:
        subtrees = [((), _unwrap(tree))]
    for prefix, sub in subtrees:
        for path, arr in _leaves(sub):
            leaf = path[-1]
            name = ".".join(prefix + path[:-1] + (_RENAME.get(leaf, leaf),))
            if name not in params:
                unknown.append("/".join(prefix + path))
                continue
            val = _convert(leaf, arr)
            p = params[name]
            if tuple(val.shape) != tuple(p.shape):
                raise ValueError(f"{name}: tree leaf {val.shape} does not fit "
                                 f"parameter {tuple(p.shape)}")
            p.copy_(torch.as_tensor(np.array(val)))
            unset.discard(name)
    if unknown:
        raise KeyError(f"parameter tree leaves with no port parameter: "
                       f"{sorted(unknown)[:10]} ({len(unknown)} in all)")
    if unset:
        raise KeyError(f"port parameters the tree left unset: "
                       f"{sorted(unset)[:10]} ({len(unset)} in all)")
    return pipeline


def _jax_leaf(owner: nn.Module, leaf: str, val: np.ndarray
              ) -> Tuple[str, np.ndarray]:
    """(flax leaf name, value in the flax layout) of one port parameter."""
    if leaf == "weight":
        if isinstance(owner, nn.Linear):
            return "kernel", val.T
        if isinstance(owner, nn.Conv2d):
            return "kernel", val.transpose(2, 3, 1, 0)
        if isinstance(owner, nn.Embedding):
            return "embedding", val
        if isinstance(owner, (nn.LayerNorm, nn.GroupNorm)):
            return "scale", val
    return leaf, val


@torch.no_grad()
def export_jax_params(module: nn.Module,
                      tensors: Optional[Mapping[str, torch.Tensor]] = None
                      ) -> Dict[str, Any]:
    """The inverse of `load_jax_params`: a nested dict of fp32 numpy arrays
    in the reference's names and layouts, from `module`'s parameters or,
    when given, from `tensors` (parameter name -> tensor of the
    parameter's shape, e.g. gradients). A pipeline's parts come out as
    {"first_stage": {"params": ...}, ...}, the reference pipeline's tree; a
    submodule (a MaskGit alone) as its bare tree."""
    tree: Dict[str, Any] = {}
    parts = pipeline_parts(module)
    for name, p in module.named_parameters():
        owner_name, _, leaf = name.rpartition(".")
        val = p if tensors is None else tensors[name]
        arr = np.asarray(val.detach().float().cpu().numpy())
        key, arr = _jax_leaf(module.get_submodule(owner_name), leaf, arr)
        path = owner_name.split(".") if owner_name else []
        if path and path[0] in parts:
            path.insert(1, "params")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(arr)
    return tree
