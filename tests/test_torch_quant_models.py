"""int8 serving of the PyTorch port (`bevgen_torch/ops/quant.py`) against the
JAX package's at tiny sizes, fp32 on the CPU: the whole models. The other
half of these checks (trees, quantizers, converter, crossover table, CLI)
is `tests/test_torch_quant.py`; the two were one file, split so that
neither sets the tier-1 run's wall time alone.

Held to the JAX package: the int8 MaskGit's logits (with and without the
decode cache), greedy ids and trajectories of the default model and every
variant with the fused glue off and on (two cases part from JAX after one
flipped int8 activation, pinned exactly in `INT8_GREEDY_MISMATCH`), the AR
cached sampler's greedy ids and teacher-forced logits, and the AR
pipeline's ids and images. Port-side: the int8 glue keeps the residual glue,
int8 tracks the compute dtype, and every hot product is int8.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage2 import ar_cached as jax_cached
from bevgen_tpu.models.stage2 import maskgit as jmg
from bevgen_tpu.ops import quant as jq
from bevgen_torch.core.convert import load_jax_params
from bevgen_torch.data.fake import fake_batch
from bevgen_torch.models.stage2 import ar_cached
from bevgen_torch.models.stage2 import maskgit as tmg
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.ops import quant as tq
from torch_parity import (NUSCENES_GPT, VARIANTS, JaxPipeline,
                          ar_tiny_pipelines, gpt_inputs, gpt_pair,
                          tiny_configs, tiny_pipelines, tiny_tree,
                          variant_configs, variant_pipelines, variant_tree)

B = 2
# Whole int8 models, fp32: the LayerNorm outputs of the two packages differ
# by ~1e-7, which now and then moves a static-path activation across a
# rounding boundary of the int8 grid (one step, a_k of the input's scale).
# One flipped step in one position changes that row's logits by about
# a_k * |W'|, under 1e-2 at tiny_test's scales; every other logit stays
# within the fp32 bound of the unquantized transformer tests.
INT8_LOGIT_MAX = 2e-2
INT8_LOGIT_TOL = 1e-4
INT8_LOGIT_FRAC = 0.995
# int8 against the compute dtype on the port alone, the JAX package's own
# bounds (tests/test_quant.py:84-107)
TRACK_COS_MIN = 0.995
TRACK_TOP1_MIN = 0.9
TREES = ["default"] + list(VARIANTS)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- whole models ------------------------------------------------------------

def _jax_int8(jc, tree):
    jcq = dataclasses.replace(jc, transformer=jc.transformer.replace(
        quant="int8"))
    params = {"params": jax.tree_util.tree_map(
        jnp.asarray, jq.quantize_dense_tree(tree["maskgit"]["params"]))}
    return JaxPipeline.create(jcq, dtype=jnp.float32), params


def _inputs(tf, seed):
    from bevgen_tpu.models.geometry import canonical_rig_inverses
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, tf.vocab_size + 1, (B, tf.num_cams, tf.num_cam_tokens))
    cond = rng.integers(0, tf.cond_vocab_size, (B, tf.num_cond_tokens))
    ii, ei = canonical_rig_inverses(tf, B)
    return ids, cond, np.asarray(ii), np.asarray(ei)


@pytest.mark.parametrize("cached", [False, True])
def test_int8_maskgit_logits_match_jax(cached):
    jc, _ = tiny_configs()
    jp, params = _jax_int8(jc, tiny_tree())
    tp = tiny_pipelines()[2].quantized()
    ids, cond, ii, ei = _inputs(tp.config.transformer, seed=1)
    want = np.asarray(jp.maskgit.apply(
        params, jnp.asarray(ids, jnp.int32), jnp.asarray(cond, jnp.int32),
        jnp.asarray(ii), jnp.asarray(ei)).logits)
    t = [_t(a) for a in (ids, cond, ii, ei)]
    with torch.no_grad():
        cache = tp.maskgit.build_cache(*t[1:]) if cached else None
        got = tp.maskgit(*t, cache=cache).logits.numpy()
    diff = np.abs(got - want)
    assert diff.max() <= INT8_LOGIT_MAX, diff.max()
    assert (diff <= INT8_LOGIT_TOL).mean() >= INT8_LOGIT_FRAC, \
        (diff <= INT8_LOGIT_TOL).mean()


def _jax_generate(jp, params, cond, ii, ei, **kw):
    return jax.jit(lambda p, c, i, e: jmg.generate(
        jp.maskgit, p, c, i, e, jax.random.PRNGKey(0), **kw))(
        params, jnp.asarray(cond, jnp.int32), jnp.asarray(ii),
        jnp.asarray(ei))


# The int8 greedy decodes that part from the JAX package's, by (variant,
# glue): (the first step whose ids differ, ids that differ after the last
# step, of 2 x 3 x 16). Each starts with one int8 activation that rounds the
# other way: the fp32 attention outputs (or, under self_cond, the fed-back
# embeddings) of the two packages differ by ~2e-7 relative, and with this
# tree's large attention outputs (row amax ~65, dynamic scale ~0.51) one
# flipped step of layer 0's cross-attention `to_out` input moves that row's
# output by ~0.16. Recorded in CHANGES.md; every other case is identical.
INT8_GREEDY_MISMATCH = {("real_cfg", False): (0, 2),
                        ("self_cond", False): (1, 6)}


@pytest.mark.parametrize("glue", [False, True])
@pytest.mark.parametrize("variant", TREES)
def test_int8_generate_greedy_matches_jax(variant, glue):
    """Greedy ids and trajectories, the seeds of test_torch_maskgit_variants
    (5 with the glue off, 7 on): identical, except the recorded
    `INT8_GREEDY_MISMATCH`es, which must stay exactly as recorded."""
    if variant == "default":
        jc, _ = tiny_configs(greedy=True, glue=glue)
        tree = tiny_tree(glue=glue)
        tp = tiny_pipelines(greedy=True, glue=glue)[2]
    else:
        jc, _ = variant_configs(variant, greedy=True, glue=glue)
        tree = variant_tree(variant, glue=glue)
        tp = variant_pipelines(variant, greedy=True, glue=glue)[2]
    jp, params = _jax_int8(jc, tree)
    tq_pipe = tp.quantized()
    assert tq_pipe.config.transformer.quant == "int8"
    _, cond, ii, ei = _inputs(tp.config.transformer, seed=7 if glue else 5)
    want, want_traj = _jax_generate(jp, params, cond, ii, ei,
                                    return_trajectory=True)
    got, got_traj = tmg.generate(tq_pipe.maskgit, _t(cond), _t(ii), _t(ei),
                                 torch.Generator().manual_seed(0),
                                 return_trajectory=True)
    got_traj, want_traj = got_traj.numpy(), np.asarray(want_traj)
    differ = [s for s in range(len(want_traj))
              if (got_traj[s] != want_traj[s]).any()]
    first = differ[0] if differ else None
    n_final = int((got.numpy() != np.asarray(want)).sum())
    assert (first, n_final) == INT8_GREEDY_MISMATCH.get((variant, glue),
                                                        (None, 0))


def test_int8_glue_keeps_the_residual_glue_and_drops_the_geglu_glue():
    tp = tiny_pipelines(greedy=True, glue=True)[2].quantized()
    tr = tp.maskgit.transformer
    assert tr.use_glue and not tr.layers_0_ff.use_glue


@pytest.mark.parametrize("case", ["plain", "nuscenes"])
def test_int8_ar_greedy_sampling_matches_jax(case):
    jm, jp, tm, tc = gpt_pair(**({} if case == "plain" else NUSCENES_GPT))
    qtree = jq.quantize_gpt_tree(_numpy_tree(jp)["params"])
    _, cond, ii, ei = gpt_inputs(tc, seed=4)
    want = np.asarray(jax_cached.ar_sample_cached(
        jm, {"params": jax.tree_util.tree_map(jnp.asarray, qtree)},
        *(jnp.asarray(a) for a in (cond, ii, ei)), jax.random.PRNGKey(5),
        top_k=1))
    qm = load_jax_params(SparseGPT(tc.replace(quant="int8"),
                                   dtype=torch.float32), qtree).eval()
    got = ar_cached.ar_sample_cached(qm, _t(cond), _t(ii), _t(ei),
                                     torch.Generator().manual_seed(5), top_k=1)
    np.testing.assert_array_equal(got.numpy(), want)
    # teacher-forced logits through the fused int8 q/k/v: the same decoder
    ids = _t(gpt_inputs(tc, seed=4)[0])
    want_l = jax_cached.teacher_forced_logits(
        jm, {"params": jax.tree_util.tree_map(jnp.asarray, qtree)},
        *(jnp.asarray(a) for a in (ids.numpy(), cond, ii, ei)))
    got_l = ar_cached.teacher_forced_logits(qm, ids, _t(cond), _t(ii), _t(ei))
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), atol=2e-4,
                               rtol=0)


def test_int8_ar_pipeline_matches_jax():
    jp, params, tp = ar_tiny_pipelines()
    jq_pipe, jq_params = jp.quantized(params)
    qp = tp.quantized(batch_hint=3)
    assert qp.config.transformer.quant == "int8"
    assert qp.first_stage is tp.first_stage
    batch = fake_batch(tp.config, 1, seed=2)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    want_img, want_ids = jax.jit(lambda p, s, i, e: jq_pipe.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0), top_k=1))(
        jq_params, *(jnp.asarray(a) for a in (seg, ii, ei)))
    img, ids = qp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0),
                              top_k=1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=1e-4,
                               rtol=0)
    with pytest.raises(ValueError, match="KV-cached"):
        qp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0),
                       top_k=1, cached=False)
    with pytest.raises(NotImplementedError, match="KV-cached"):
        qp.gpt(_t(np.zeros((1, 3, 24), np.int64)),
               _t(np.zeros((1, 16), np.int64)), _t(ii), _t(ei))


def test_int8_tracks_the_compute_dtype():
    """On the port alone, as tests/test_quant.py asks of the JAX package:
    the int8 MaskGit's logits against the fp32 one's."""
    tp = tiny_pipelines()[2]
    qp = tp.quantized()
    ids, cond, ii, ei = _inputs(tp.config.transformer, seed=3)
    t = [_t(a) for a in (ids, cond, ii, ei)]
    with torch.no_grad():
        a = tp.maskgit(*t).logits.double()
        b = qp.maskgit(*t).logits.double()
    cos = torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(),
                                                dim=0).item()
    top1 = (a.argmax(-1) == b.argmax(-1)).double().mean().item()
    assert cos > TRACK_COS_MIN, cos
    assert top1 > TRACK_TOP1_MIN, top1


def test_int8_model_holds_every_hot_product_as_int8():
    """8 W8A8 products a layer (to_q, to_kv, to_out twice, proj_in,
    proj_out) and to_logits, each a quarter of its fp32 kernel's bytes."""
    tp = tiny_pipelines()[2]
    qp = tp.quantized()
    q_layers = [m for m in qp.maskgit.modules() if isinstance(m, tq.QuantDense)]
    assert len(q_layers) == 8 * tp.config.transformer.num_layers + 1
    for m in q_layers:
        assert m.kernel_q.dtype == torch.int8
        assert m.kernel_q.element_size() * 4 == torch.finfo(
            torch.float32).bits // 8
    assert tq.weight_bytes(qp.maskgit) < tq.weight_bytes(tp.maskgit)
