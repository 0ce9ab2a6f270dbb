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
  * LayerNorm/GroupNorm/BatchNorm `scale` -> `weight`;
    Embed `embedding` -> `weight`
  * ActNorm `loc` and `scale` (the discriminator's) as they are;
  * `bias`, `codebook`, `null_kv`, `q_scale`, `k_scale`,
    `camera_bias_emb`, `bev_cam_pos_emb`, `x_pos_emb`, `cond_pos_emb` as
    they are;
  * the int8 trees (`ops/quant.py`): `kernel_q` (in, out) int8 ->
    `kernel_q` (out, in); `scale` (out,) and `in_scale` (in,) as they are.

A leaf is named by the port module it lands in: `scale` is a norm's
`weight` under a LayerNorm, GroupNorm or the discriminator's BatchNorm,
stays `scale` under an ActNorm, and is the int8 scale under a `QuantDense`
or `Int8WeightDense`. A quantized leaf (`kernel_q`, `in_scale`,
or `scale` outside a norm) aimed at a module that is not quantized raises,
and so does a float `kernel` aimed at a quantized one.

Raises on a leaf the port has no parameter for, on a port parameter left
unset, and on a shape mismatch.

`export_jax_params(module, tensors=None)` is the inverse: the port's
parameters (or any tensors by parameter name, such as gradients) as the
reference's numpy tree, so port-trained weights load into the JAX package
and the tests compare trees leaf by leaf.

Tensor parallelism (`parallel/tensor.py`): `split_tp(tree, tp, rank)` is
one rank's slice of a full tree (`parallel.sharding.tp_plan`, by meaning:
a rank's heads of k then of v in `to_kv`, its columns of a then of gate in
`proj_in`), `merge_tp(slices, like)` the full tree again, and
`load_jax_params(..., mesh=)` loads a full tree into a tensor-parallel
module, each leaf cut to the rank's slice as the module was
(`parallel.tensor.shard_module_`).
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from bevgen_torch.models.discriminator import ActNorm, BatchNorm
from bevgen_torch.ops.quant import QUANT_MODULES

_RENAME = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
_NORMS = (nn.LayerNorm, nn.GroupNorm, BatchNorm)


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


def _port_leaf(owner: Optional[nn.Module], where: str, leaf: str) -> str:
    """The port's parameter name for the flax leaf `leaf` of the port module
    `owner` (None where the port has no such module: the leaf is then
    reported as unknown). Raises on a quantized leaf aimed at a module
    that is not quantized, and the other way round."""
    if isinstance(owner, QUANT_MODULES):
        if leaf not in ("kernel_q", "scale", "in_scale", "bias"):
            raise ValueError(f"{where}: leaf {leaf!r} for the int8 module "
                             f"{type(owner).__name__} (kernel_q, scale, "
                             f"in_scale, bias)")
        return leaf
    if isinstance(owner, ActNorm):
        return leaf
    quantized = leaf in ("kernel_q", "in_scale") or (
        leaf == "scale" and owner is not None and not isinstance(owner, _NORMS))
    if quantized:
        raise ValueError(f"{where}: quantized leaf {leaf!r} for "
                         f"{type(owner).__name__}, which is not an int8 "
                         f"module (quantize the pipeline first)")
    return _RENAME.get(leaf, leaf)


def _owner(module: nn.Module, path: Tuple[str, ...]) -> Optional[nn.Module]:
    try:
        return module.get_submodule(".".join(path))
    except AttributeError:
        return None


def _convert(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf in ("kernel", "kernel_q") and arr.ndim == 2:
        return arr.T
    if leaf == "kernel" and arr.ndim == 4:
        return arr.transpose(3, 2, 0, 1)
    return arr


def _unwrap(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    return tree["params"] if set(tree) == {"params"} else tree


def _tree_map(fn, trees: Sequence[Mapping[str, Any]], prefix=()):
    """fn(path, [leaf of each tree]) over the leaves of equally shaped
    nested dicts, as a nested dict."""
    out = {}
    for key, val in trees[0].items():
        path = prefix + (str(key),)
        vals = [t[key] for t in trees]
        out[key] = (_tree_map(fn, vals, path) if isinstance(val, Mapping)
                    else fn("/".join(path), vals))
    return out


def _tp_leaf(path: str, shape, tp: int):
    """(flax axis, halves) where `tp_plan` splits the leaf, else None.
    "params" levels are not part of a rule's path."""
    from bevgen_torch.parallel.sharding import tp_axis, tp_halves
    path = "/".join(p for p in path.split("/") if p != "params")
    ax = tp_axis(path, shape, tp)
    return None if ax is None else (ax, tp_halves(path))


def split_tp(tree: Mapping[str, Any], tp: int, rank: int) -> Dict[str, Any]:
    """Rank `rank`'s slice of a full numpy tree at `tp` ways: each leaf
    `parallel.sharding.tp_plan` splits cut by meaning
    (`parallel.tensor.take_part`), the others as they are."""
    from bevgen_torch.parallel.tensor import take_part

    def cut(path, leaves):
        arr = np.asarray(leaves[0])
        split = _tp_leaf(path, arr.shape, tp)
        return arr if split is None else take_part(arr, *split, tp, rank)
    return _tree_map(cut, [tree])


def merge_tp(slices: Sequence[Mapping[str, Any]],
             like: Mapping[str, Any]) -> Dict[str, Any]:
    """The full tree from every rank's `split_tp` slice, in rank order.
    `like` gives the full shapes (a tree of arrays or of anything with a
    `shape`, such as `jax.eval_shape`'s): the plan is a function of them,
    and a slice alone does not tell a split leaf from a whole one."""
    from bevgen_torch.parallel.tensor import join_parts
    tp = len(slices)

    def join(path, leaves):
        split = _tp_leaf(path, tuple(leaves[-1].shape), tp)
        parts = [np.asarray(a) for a in leaves[:-1]]
        return parts[0] if split is None else join_parts(parts, *split)
    return _tree_map(join, [*slices, like])


@torch.no_grad()
def load_jax_params(pipeline: nn.Module, tree: Mapping[str, Any],
                    mesh=None) -> nn.Module:
    """Copy every leaf of `tree` into `pipeline`'s parameters (converting
    layouts and dtypes); see the module docstring. `pipeline` is a serving
    pipeline (tree: its parts) or a bare model such as a `SparseGPT` (tree:
    that model's own tree). With a tensor-parallel `mesh`, `pipeline` holds
    this rank's tp slices (`parallel.tensor.shard_module_`) and each leaf of
    the full `tree` is cut to this rank's slice as its parameter was."""
    from bevgen_torch.parallel.tensor import take_part, tp_layout
    layout = tp_layout(pipeline) if mesh is not None else {}
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
            owner = _owner(pipeline, prefix + path[:-1])
            port_leaf = _port_leaf(owner, "/".join(prefix + path), leaf)
            name = ".".join(prefix + path[:-1] + (port_leaf,))
            if name not in params:
                unknown.append("/".join(prefix + path))
                continue
            val = _convert(leaf, arr)
            if name in layout:
                val = take_part(val, *layout[name], mesh.tp, mesh.tp_rank)
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
    if isinstance(owner, QUANT_MODULES):
        return leaf, (val.T if leaf == "kernel_q" else val)
    if leaf == "weight":
        if isinstance(owner, nn.Linear):
            return "kernel", val.T
        if isinstance(owner, nn.Conv2d):
            return "kernel", val.transpose(2, 3, 1, 0)
        if isinstance(owner, nn.Embedding):
            return "embedding", val
        if isinstance(owner, _NORMS):
            return "scale", val
    return leaf, val


def flax_leaf(module: nn.Module, name: str) -> Tuple[str, Tuple[int, ...]]:
    """The flax path (`transformer/layers_0_attn/to_q/kernel`) of `module`'s
    parameter `name`, and for each flax axis the port axis it is (a Dense
    kernel is the Linear weight transposed: (1, 0))."""
    owner_name, _, leaf = name.rpartition(".")
    owner = module.get_submodule(owner_name)
    ndim = module.get_parameter(name).ndim
    key = _jax_leaf(owner, leaf, np.empty((0,) * ndim))[0]
    path = owner_name.split(".") + [key] if owner_name else [key]
    return "/".join(path), _axis_map(owner, leaf, ndim)


def _axis_map(owner: nn.Module, leaf: str, ndim: int) -> Tuple[int, ...]:
    """For each axis of the flax leaf, the axis of the port tensor (the
    inverse of `_jax_leaf`'s transposes)."""
    if ndim == 2 and (leaf == "kernel_q" and isinstance(owner, QUANT_MODULES)
                      or leaf == "weight" and isinstance(owner, nn.Linear)):
        return (1, 0)
    if ndim == 4 and leaf == "weight" and isinstance(owner, nn.Conv2d):
        return (2, 3, 1, 0)
    return tuple(range(ndim))


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
        val = (p if tensors is None else tensors[name]).detach()
        # int8 kernels stay int8; every float leaf comes out as fp32
        arr = np.asarray((val.float() if val.is_floating_point()
                          else val).cpu().numpy())
        key, arr = _jax_leaf(module.get_submodule(owner_name), leaf, arr)
        path = owner_name.split(".") if owner_name else []
        if path and path[0] in parts:
            path.insert(1, "params")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(arr)
    return tree
