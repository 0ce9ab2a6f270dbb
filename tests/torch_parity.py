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


def tiny_configs(greedy: bool = False, glue: bool = False):
    """(JAX, port) tiny_test configs; `glue` sets use_fused_glue on both."""
    jc, tc = jcfg.tiny_test_config(), tcfg.tiny_test_config()
    if greedy:
        jc = dataclasses.replace(jc, muse=dataclasses.replace(jc.muse, **GREEDY))
        tc = dataclasses.replace(tc, muse=dataclasses.replace(tc.muse, **GREEDY))
    if glue:
        jc = dataclasses.replace(jc, transformer=jc.transformer.replace(
            use_fused_glue=True))
        tc = dataclasses.replace(tc, transformer=tc.transformer.replace(
            use_fused_glue=True))
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


def tiny_tree(seed: int = 0, glue: bool = False):
    """A numpy weight tree in the layout of the JAX tiny_test pipeline (the
    one initialised under use_fused_glue=True with `glue`)."""
    jp = JaxPipeline.create(tiny_configs(glue=glue)[0], dtype=jnp.float32)
    return random_tree(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)),
                       seed)


@functools.lru_cache(maxsize=4)
def tiny_pipelines(greedy: bool = False, seed: int = 0, glue: bool = False):
    """(jax_pipe, jax_params, torch_pipe) at tiny_test, fp32, CPU, with the
    same weights."""
    jc, tc = tiny_configs(greedy, glue)
    jp = JaxPipeline.create(jc, dtype=jnp.float32)
    tree = tiny_tree(seed, glue)
    tp = TorchPipeline.create(tc, device="cpu", dtype=torch.float32)
    load_jax_params(tp, tree)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    return jp, params, tp


# ---- the MUSE model variants -------------------------------------------------

# (muse fields, transformer fields) of each variant beside the default
# (the SelfCritic, cond-only serving, no self-conditioning)
VARIANTS = {
    "real_cfg": ({"real_cfg": True}, {}),
    "token_critic": ({"self_token_critic": False, "token_critic": True}, {}),
    "token_critic+real_cfg": ({"self_token_critic": False,
                               "token_critic": True, "real_cfg": True}, {}),
    "self_cond": ({}, {"self_cond": True}),
    "self_cond+token_critic": ({"self_token_critic": False,
                                "token_critic": True}, {"self_cond": True}),
}


def variant_configs(variant: str, greedy: bool = False, glue: bool = False):
    """(JAX, port) tiny_test configs of one of `VARIANTS` (with
    use_fused_glue on both sides under `glue`)."""
    muse_kw, tf_kw = VARIANTS[variant]
    return tuple(dataclasses.replace(
        c, muse=dataclasses.replace(c.muse, **muse_kw),
        transformer=c.transformer.replace(**tf_kw))
        for c in tiny_configs(greedy, glue))


@functools.lru_cache(maxsize=8)
def variant_tree(variant: str, seed: int = 0, glue: bool = False):
    """A numpy weight tree in the layout of the variant's JAX pipeline."""
    jp = JaxPipeline.create(variant_configs(variant, glue=glue)[0],
                            dtype=jnp.float32)
    return random_tree(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)),
                       seed)


@functools.lru_cache(maxsize=8)
def variant_pipelines(variant: str, greedy: bool = False, seed: int = 0,
                      glue: bool = False):
    """(jax_pipe, jax_params, torch_pipe) of one of `VARIANTS` at tiny_test,
    fp32, CPU, with the same weights (and the fused glue on both sides
    under `glue`)."""
    jc, tc = variant_configs(variant, greedy, glue)
    tree = variant_tree(variant, seed, glue)
    tp = load_jax_params(TorchPipeline.create(tc, device="cpu",
                                              dtype=torch.float32), tree)
    return (JaxPipeline.create(jc, dtype=jnp.float32),
            jax.tree_util.tree_map(jnp.asarray, tree), tp)


# ---- the rectangular MUSE configuration ------------------------------------

def rect_configs(greedy: bool = False):
    """(JAX, port) tiny_test configs with rectangular 32x48 images and 4x6
    latents, as argoverse_muse_rect is to argoverse_muse."""
    out = []
    for c in tiny_configs(greedy):
        out.append(dataclasses.replace(
            c, transformer=c.transformer.replace(cam_res=(32, 48),
                                                 cam_latent_res=(4, 6)),
            first_stage=dataclasses.replace(c.first_stage, cam_res=(32, 48),
                                            cam_latent_res=(4, 6))))
    return tuple(out)


@functools.lru_cache(maxsize=2)
def rect_pipelines(greedy: bool = False, seed: int = 0):
    """(jax_pipe, jax_params, torch_pipe) at `rect_configs`, fp32, CPU, with
    the same weights."""
    jc, tc = rect_configs(greedy)
    jp = JaxPipeline.create(jc, dtype=jnp.float32)
    tree = random_tree(jax.eval_shape(jp.init_params, jax.random.PRNGKey(0)),
                       seed)
    tp = load_jax_params(TorchPipeline.create(tc, device="cpu",
                                              dtype=torch.float32), tree)
    return jp, jax.tree_util.tree_map(jnp.asarray, tree), tp


# ---- comparing parameter trees ----------------------------------------------

def assert_trees_close(got, want, rtol, atol_min=1e-6, what=""):
    g = dict(jax.tree_util.tree_leaves_with_path(got))
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert g.keys() == w.keys()
    for path, wv in w.items():
        wv = np.asarray(wv)
        atol = max(atol_min, rtol * float(np.abs(wv).max()))
        np.testing.assert_allclose(np.asarray(g[path]), wv, atol=atol, rtol=0,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


def assert_steps_close(got, want, lr, what):
    """Parameters after Adam updates of step ~lr: an entry whose gradient is
    near 0 on both sides can take any normalised step in [-lr, lr] (Adam
    divides it by its own size), so each entry is held to 2 lr, and all but
    0.1% of the entries of each leaf to 5e-3 lr."""
    g = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, wv in jax.tree_util.tree_leaves_with_path(want):
        d = np.abs(np.asarray(g[path]) - np.asarray(wv))
        name = f"{what} {jax.tree_util.keystr(path)}"
        assert d.max() <= 2 * lr, name
        assert (d > 5e-3 * lr).mean() <= 1e-3, name


# ---- the AR sparse-GPT path -------------------------------------------------

def gpt_kwargs(**kw):
    """The JAX AR tests' tiny GPT (tests/test_ar_cached.py:gpt_cfg)."""
    base = dict(num_layers=2, num_heads=2, num_embed=64, hidden_size=64,
                vocab_size=32, cond_vocab_size=32, num_cams=3,
                cam_names="ARGOVERSE_FRONT_CAMERAS", dataset="argoverse",
                cam_res=(32, 32), cam_latent_res=(4, 4), bev_latent_res=(4, 4),
                window_len=4, sparse_block_size=8, density=0.7,
                causal_order=True, camera_bias=False, image_embed=True,
                bev_embed=True, legacy_prob_matrix=False)
    base.update(kw)
    return base


# the nuScenes variant of the JAX AR tests (outward order, pad rows)
NUSCENES_GPT = dict(dataset="nuscenes", cam_names="NUSCENES_CAMERAS",
                    num_cams=6, cam_latent_res=(2, 5), sparse_block_size=8,
                    density=0.8, legacy_prob_matrix=True, bev_embed=False)


def gpt_configs(**kw):
    """(JAX MultiViewConfig, port MultiViewConfig) with the same fields."""
    kw = gpt_kwargs(**kw)
    return jcfg.MultiViewConfig(**kw), tcfg.MultiViewConfig(**kw)


def gpt_inputs(cfg, b=2, seed=0):
    """(ids, cond, intrinsics_inv, extrinsics_inv) as numpy, as the JAX
    AR tests make them."""
    from bevgen_torch.models import geometry
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size,
                       (b, cfg.num_cams, cfg.num_cam_tokens)).astype(np.int32)
    cond = rng.integers(0, cfg.cond_vocab_size,
                        (b, cfg.num_cond_tokens)).astype(np.int32)
    intr, extr = geometry.canonical_camera_rig(cfg)
    ii = np.broadcast_to(np.linalg.inv(intr)[None],
                         (b, cfg.num_cams, 3, 3)).astype(np.float32)
    ei = np.broadcast_to(np.linalg.inv(extr)[None],
                         (b, cfg.num_cams, 4, 4)).astype(np.float32)
    return ids, cond, ii, ei


@functools.lru_cache(maxsize=8)
def gpt_pair(seed: int = 0, **kw):
    """(jax model, jax params, port SparseGPT, port cfg) at fp32 on the CPU
    with one numpy weight tree."""
    from bevgen_tpu.models.stage2.gpt import SparseGPT as JaxGPT
    from bevgen_torch.models.stage2.gpt import SparseGPT
    jc, tc = gpt_configs(**kw)
    jm = JaxGPT(jc, use_pallas=False)
    ids, cond, ii, ei = (jnp.asarray(a) for a in gpt_inputs(jc, b=1))
    tree = random_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0), ids,
                                      cond, ii, ei), seed)
    tm = load_jax_params(SparseGPT(tc, dtype=torch.float32), tree).eval()
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), tm, tc


def ar_tiny_configs():
    """A tiny AR pipeline on three nuScenes cameras with rectangular 32x48
    images (4x6 latents) and 16-token blocks, so 88 tokens pad to 96:
    (JAX PipelineConfig, port PipelineConfig)."""
    tf = dict(num_layers=2, num_heads=2, num_embed=64, hidden_size=64,
              vocab_size=32, cond_vocab_size=32, num_cams=3,
              cam_names="NUSCENES_ABLATION_CAMERAS", dataset="nuscenes",
              cam_res=(32, 48), cam_latent_res=(4, 6), bev_latent_res=(4, 4),
              window_len=4, sparse_block_size=16, density=0.8,
              causal_order=True, camera_bias=True, image_embed=True,
              bev_embed=False, legacy_prob_matrix=True)
    s1 = dict(ch=16, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=16,
              n_embed=32, embed_dim=16, resolution=32, attn_resolutions=(4,))
    out = []
    for m in (jcfg, tcfg):
        out.append(m.PipelineConfig(
            transformer=m.MultiViewConfig(**tf),
            first_stage=m.Stage1Config(cam_res=(32, 48), cam_latent_res=(4, 6),
                                       **s1),
            cond_stage=m.Stage1Config(in_channels=3, out_ch=3, n_labels=3,
                                      **s1)))
    return tuple(out)


def _jax_ar_pipeline():
    from bevgen_tpu.pipelines.ar_generate import ARPipeline as JaxAR
    return JaxAR.create(ar_tiny_configs()[0], dtype=jnp.float32,
                        use_pallas=False)


def ar_tiny_tree(seed: int = 0):
    """A numpy weight tree in the layout of the JAX tiny AR pipeline
    ({first_stage, cond_stage, gpt})."""
    return random_tree(jax.eval_shape(_jax_ar_pipeline().init_params,
                                      jax.random.PRNGKey(0)), seed)


@functools.lru_cache(maxsize=1)
def ar_tiny_pipelines(seed: int = 0):
    """(jax ARPipeline, jax params, port ARPipeline) at `ar_tiny_configs`,
    fp32, CPU, with the same weights."""
    from bevgen_torch.pipelines.ar_generate import ARPipeline
    tree = ar_tiny_tree(seed)
    tp = load_jax_params(ARPipeline.create(ar_tiny_configs()[1], device="cpu",
                                           dtype=torch.float32), tree)
    return _jax_ar_pipeline(), jax.tree_util.tree_map(jnp.asarray, tree), tp
