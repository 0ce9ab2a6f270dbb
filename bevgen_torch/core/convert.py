"""Load the JAX pipeline's parameter tree into the port's modules.

`load_jax_params(pipeline, tree)` takes the reference pipeline's parameter
dict `{"first_stage", "cond_stage", "maskgit"}` (each optionally wrapped
in flax's `{"params": ...}`), with every leaf a numpy array. The port's
submodules carry the reference's names, so a leaf at
`maskgit/transformer/layers_0_attn/to_q/kernel` lands in
`maskgit.transformer.layers_0_attn.to_q.weight`. Leaf conversions:

  * Dense kernel (in, out)        -> Linear weight (out, in)
  * Conv kernel HWIO              -> Conv2d weight OIHW
  * LayerNorm/GroupNorm `scale`   -> `weight`;  Embed `embedding` -> `weight`
  * `bias`, `codebook`, `null_kv`, `q_scale`, `k_scale`,
    `camera_bias_emb`, `bev_cam_pos_emb` as they are.

Raises on a leaf the port has no parameter for, on a port parameter left
unset, and on a shape mismatch.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn

PARTS = ("first_stage", "cond_stage", "maskgit")
_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}


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


@torch.no_grad()
def load_jax_params(pipeline: nn.Module, tree: Mapping[str, Any]) -> nn.Module:
    """Copy every leaf of `tree` into `pipeline`'s parameters (converting
    layouts and dtypes); see the module docstring."""
    params: Dict[str, torch.Tensor] = dict(pipeline.named_parameters())
    unset = set(params)
    unknown = []
    for part in PARTS:
        if part not in tree:
            raise KeyError(f"parameter tree has no {part!r} entry")
    for part, sub in tree.items():
        if part not in PARTS:
            unknown.append(part)
            continue
        if set(sub) == {"params"}:
            sub = sub["params"]
        for path, arr in _leaves(sub):
            leaf = path[-1]
            name = ".".join((part,) + path[:-1] + (_RENAME.get(leaf, leaf),))
            if name not in params:
                unknown.append("/".join((part,) + path))
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
