"""MaskGit decode of the PyTorch port against the JAX reference: the
re-mask ranking, the top-k filter, the schedules, gumbel sampling with
injected noise, and `generate` end to end under a greedy config
(temperature 0, critic noise 0), which makes both sides deterministic.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_torch.models.stage2 import maskgit as tmg
from torch_parity import tiny_pipelines

# greedy decodes may still part on a near-tie of two logits (fp32 sums in
# another order); the reference check of the port asks for 99% agreement
IDS_AGREE_MIN = 0.99


def test_rank_desc_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    scores = rng.integers(0, 4, (3, 5, 40)).astype(np.float32)  # many ties
    scores[0] = 0.0
    want = np.asarray(jmg._rank_desc(jnp.asarray(scores)))
    got = tmg._rank_desc(torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thres,vocab", [(0.9, 1024), (0.9, 32), (0.5, 7),
                                         (0.999, 10)])
def test_top_k_filter_matches_jax(thres, vocab):
    logits = np.random.default_rng(vocab).standard_normal(
        (2, 3, vocab)).astype(np.float32)
    want = np.asarray(jmg.top_k_filter(jnp.asarray(logits), thres))
    got = tmg.top_k_filter(torch.from_numpy(logits), thres).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.isfinite(got).sum(-1) == max(1, math.ceil((1 - thres) * vocab))).all()


@pytest.mark.parametrize("T,hw", [(18, 256), (4, 16), (1, 16)])
def test_schedules_match_jax(T, hw):
    from bevgen_torch.core.config import MuseConfig
    muse = MuseConfig(temperature=1.3, critic_noise_scale=0.7)
    num_masked, temps, noise = tmg.schedules(muse, hw, T)
    # the reference's static schedules, bevgen_tpu/models/stage2/maskgit.py:283-287
    ts = np.linspace(0.0, 1.0, T)
    np.testing.assert_array_equal(
        num_masked, np.maximum((np.cos(ts * np.pi / 2) * hw).astype(np.int64), 1))
    steps_until = np.arange(T - 1, -1, -1, dtype=np.float32)
    np.testing.assert_array_equal(temps, 1.3 * (steps_until / T))
    np.testing.assert_array_equal(noise, 0.7 * (steps_until / T))


def test_gumbel_sample_with_injected_noise():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 3, 16)).astype(np.float32)
    g = rng.gumbel(size=logits.shape).astype(np.float32)
    got = tmg.gumbel_sample(torch.from_numpy(logits), 0.7,
                            noise=torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, np.argmax(logits / 0.7 + g, -1))
    # temperature 0: the argmax of the logits, as in the reference
    want = np.asarray(jmg.gumbel_sample(jax.random.PRNGKey(0),
                                        jnp.asarray(logits), 0.0))
    got = tmg.gumbel_sample(torch.from_numpy(logits), 0.0,
                            torch.Generator().manual_seed(0)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("force_no_critic,partial", [(False, False),
                                                     (True, False),
                                                     (False, True)])
def test_generate_greedy_matches_jax(force_no_critic, partial):
    jp, params, tp = tiny_pipelines(greedy=True)
    tf = tp.config.transformer
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(5)
    cond = rng.integers(0, tf.cond_vocab_size, (2, tf.num_cond_tokens))
    ii, ei = canonical_rig_inverses(tf, 2)
    init = None
    if partial:  # partial decoding: camera 0 keeps its tokens
        init = np.full((2, tf.num_cams, tf.num_cam_tokens), tf.mask_token_id)
        init[:, 0] = rng.integers(0, tf.vocab_size, (2, tf.num_cam_tokens))
    want = np.asarray(jax.jit(
        lambda p, c, i, e, n: jmg.generate(
            jp.maskgit, p, c, i, e, jax.random.PRNGKey(0), init_ids=n,
            force_not_use_token_critic=force_no_critic))(
        params["maskgit"], jnp.asarray(cond, jnp.int32), jnp.asarray(ii),
        jnp.asarray(ei), None if init is None else jnp.asarray(init, jnp.int32)))
    got = tmg.generate(tp.maskgit, torch.from_numpy(cond), torch.from_numpy(ii),
                       torch.from_numpy(ei), torch.Generator().manual_seed(0),
                       init_ids=None if init is None else torch.from_numpy(init),
                       force_not_use_token_critic=force_no_critic).numpy()
    assert got.shape == want.shape == (2, tf.num_cams) + tuple(tf.cam_latent_res)
    assert (got == want).mean() >= IDS_AGREE_MIN
    if partial:
        np.testing.assert_array_equal(got[:, 0].reshape(2, -1), init[:, 0])


def test_remask_prev_masked_needs_a_trained_checkpoint():
    _, _, tp = tiny_pipelines(greedy=True)
    tf = tp.config.transformer
    cond = torch.zeros(1, tf.num_cond_tokens, dtype=torch.long)
    ii, ei = torch.eye(3).expand(1, 3, 3, 3), torch.eye(4).expand(1, 3, 4, 4)
    with pytest.raises(ValueError, match="no_mask_token_prob"):
        tmg.generate(tp.maskgit, cond, ii, ei, force_not_use_token_critic=True,
                     can_remask_prev_masked=True)
