"""Shared set-up of the parity tests between the JAX reference
(`bevgen_tpu`) and the PyTorch port (`bevgen_torch`).

Both pipelines are built from the same preset at fp32 on the CPU. The
weights are one numpy tree in the JAX pipeline's layout (its shapes from
`jax.eval_shape` of its own init, its values drawn with numpy from a
seed); the JAX side runs on it directly and the port loads it with
`load_jax_params`. Inputs are made with numpy from a seed and handed to
both sides.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bevgen_tpu.core import config as jcfg
from bevgen_tpu.pipelines.generate import BEVGenPipeline as JaxPipeline
from bevgen_torch.core import config as tcfg
from bevgen_torch.core.convert import load_jax_params
from bevgen_torch.pipelines.generate import BEVGenPipeline as TorchPipeline

# greedy and deterministic on both sides with no change to the JAX code:
# temperature 0 makes the gumbel sample an argmax, critic noise scale 0
# removes the re-masking noise
GREEDY = dict(temperature=0.0, critic_noise_scale=0.0)


def tiny_configs(greedy: bool = False):
    jc, tc = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    if greedy:
        jc = dataclasses.replace(jc, muse=dataclasses.replace(jc.muse, **GREEDY))
        tc = dataclasses.replace(tc, muse=dataclasses.replace(tc.muse, **GREEDY))
    return jc, tc


def random_tree(shapes, seed: int):
    """Numpy weights for a tree of ShapeDtypeStructs: fan-in-scaled
    kernels, unit-ish norm and q/k scales, and small non-zero biases,
    camera-bias table and BEV camera embeddings (so the tril mask and
    every additive term take part)."""
    rng = np.random.default_rng(seed)

    def leaf(path, sd):
        return _leaf(path, sd).astype(np.float32)

    def _leaf(path, sd):
        name = jax.tree_util.keystr(path[-1:]).strip("[]'")
        shape = sd.shape
        n = rng.standard_normal(shape).astype(np.float32)
        if name == "kernel":
            return n / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "q_scale", "k_scale"):
            return 1.0 + 0.1 * n
        if name == "embedding":
            return n / np.sqrt(shape[-1])
        if name == "codebook":
            return 0.5 * n
        if name == "null_kv":
            return n
        return 0.1 * n  # bias, camera_bias_emb, bev_cam_pos_emb

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def tiny_tree(seed: int = 0):
    """A numpy weight tree in the layout of the JAX tiny_test pipeline."""
    jp = JaxPipeline.create(jcfg.tiny_test_config(), dtype=jnp.float32)
    return random_tree(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)),
                       seed)


@functools.lru_cache(maxsize=2)
def tiny_pipelines(greedy: bool = False, seed: int = 0):
    """(jax_pipe, jax_params, torch_pipe) at tiny_test, fp32, CPU, with the
    same weights."""
    jc, tc = tiny_configs(greedy)
    jp = JaxPipeline.create(jc, dtype=jnp.float32)
    tree = tiny_tree(seed)
    tp = TorchPipeline.create(tc, device="cpu", dtype=torch.float32)
    load_jax_params(tp, tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, params, tp
