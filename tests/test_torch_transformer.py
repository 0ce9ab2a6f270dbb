"""Stage-2 transformer of the PyTorch port against the JAX reference at
tiny_test, fp32 on the CPU, on the same weights: one forward's logits and
embeddings (with and without the decode cache, and with a dropped
condition), the decode cache itself, and the self-critic head.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2.maskgit import MaskGit as JaxMaskGit
from torch_parity import tiny_pipelines

# fp32 on both sides; 14 matmul chains summed in another order: 1e-4
# absolute on logits of magnitude ~1-5
TOL = 1e-4


def _inputs(tf, seed, b=2):
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, tf.vocab_size + 1, (b, tf.num_cams, tf.num_cam_tokens))
    cond = rng.integers(0, tf.cond_vocab_size, (b, tf.num_cond_tokens))
    ii, ei = canonical_rig_inverses(tf, b)
    return ids, cond, ii, ei


def _jax_forward(jp, params, ids, cond, ii, ei, keep=None):
    return jp.maskgit.apply(
        params["maskgit"], jnp.asarray(ids, jnp.int32),
        jnp.asarray(cond, jnp.int32), jnp.asarray(ii), jnp.asarray(ei),
        cond_keep=None if keep is None else jnp.asarray(keep, bool))


@pytest.mark.parametrize("cached", [False, True])
def test_forward_logits_and_embed(cached):
    jp, params, tp = tiny_pipelines()
    ids, cond, ii, ei = _inputs(tp.config.transformer, seed=1)
    want = _jax_forward(jp, params, ids, cond, ii, ei)
    t = [torch.from_numpy(a) for a in (ids, cond, ii, ei)]
    with torch.no_grad():
        cache = tp.maskgit.build_cache(*t[1:]) if cached else None
        got = tp.maskgit(*t, cache=cache)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got.embed.numpy(), np.asarray(want.embed),
                               atol=TOL, rtol=0)


def test_decode_cache_matches_jax():
    jp, params, tp = tiny_pipelines()
    _, cond, ii, ei = _inputs(tp.config.transformer, seed=2)
    want = jp.maskgit.apply(params["maskgit"], jnp.asarray(cond, jnp.int32),
                            jnp.asarray(ii), jnp.asarray(ei),
                            method=JaxMaskGit.build_cache)["gen"]
    with torch.no_grad():
        got = tp.maskgit.build_cache(*[torch.from_numpy(a) for a in (cond, ii, ei)])
    for key in ("ray", "context", "self_bias", "cross_bias"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, rtol=0, err_msg=key)
    for (gk, gv), (wk, wv) in zip(got["cross_kv"], want["cross_kv"]):
        np.testing.assert_allclose(gk.numpy(), np.asarray(wk), atol=1e-5)
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=1e-5)


def test_forward_with_dropped_condition():
    jp, params, tp = tiny_pipelines()
    ids, cond, ii, ei = _inputs(tp.config.transformer, seed=3)
    keep = np.array([True, False])
    want = _jax_forward(jp, params, ids, cond, ii, ei, keep)
    t = [torch.from_numpy(a) for a in (ids, cond, ii, ei)]
    with torch.no_grad():
        got = tp.maskgit(*t, cond_keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want.logits),
                               atol=TOL, rtol=0)


def test_critic_head():
    jp, params, tp = tiny_pipelines()
    ids, cond, ii, ei = _inputs(tp.config.transformer, seed=4)
    want = jp.maskgit.apply(params["maskgit"], jnp.asarray(ids, jnp.int32),
                            jnp.asarray(cond, jnp.int32), jnp.asarray(ii),
                            jnp.asarray(ei), method=JaxMaskGit.critic_logits)
    with torch.no_grad():
        got = tp.maskgit.critic_logits(*[torch.from_numpy(a)
                                         for a in (ids, cond, ii, ei)])
    assert got.shape == ids.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)
