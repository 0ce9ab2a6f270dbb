"""The AR sparse-GPT serving path of the PyTorch port against the JAX
reference at tiny sizes, fp32 on the CPU, on one numpy weight tree: the
SparseGPT forward, the KV-cached decoder (teacher-forced logits against the
full forward, the prefix buckets), greedy sampling (cached, full-forward
and JAX), partial decoding, `ARPipeline.generate_fn` end to end at a
rectangular image size, the nuScenes fake batch, and the CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.data.fake import fake_batch as jax_fake_batch
from bevgen_tpu.core import config as jcfg
from bevgen_tpu.models.stage2 import ar_cached as jax_cached
from bevgen_torch.core import config as tcfg
from bevgen_torch.data.fake import fake_batch
from bevgen_torch.models.stage2 import ar, ar_cached
from torch_parity import (NUSCENES_GPT, ar_tiny_pipelines, gpt_inputs,
                          gpt_pair)

LOGIT_TOL = 1e-4   # fp32 forward, the same arithmetic in another order
CACHED_TOL = 2e-4  # cached vs full forward: the JAX test's own bound
IMG_TOL = 1e-4     # fp32 convolutions summed in another order

GPT_CASES = {"plain": {}, "camera-bias": {"camera_bias": True},
             "nuscenes": NUSCENES_GPT}


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _jax(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("sampling", [True, False])
@pytest.mark.parametrize("case", sorted(GPT_CASES))
def test_sparse_gpt_forward_matches_jax(case, sampling):
    jm, jp, tm, tc = gpt_pair(**GPT_CASES[case])
    inputs = gpt_inputs(tc, seed=1)
    want = np.asarray(jax.jit(jm.apply, static_argnames="sampling")(
        jp, *_jax(*inputs), sampling=sampling))
    with torch.no_grad():
        got = tm(*_torch(*inputs), sampling=sampling).numpy()
    assert got.shape == (2, tc.num_img_tokens, tc.vocab_size)
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("case", sorted(GPT_CASES))
def test_teacher_forced_logits_match_jax_full_forward(case):
    jm, jp, tm, tc = gpt_pair(**GPT_CASES[case])
    inputs = gpt_inputs(tc, seed=2)
    want = np.asarray(jax.jit(jm.apply, static_argnames="sampling")(
        jp, *_jax(*inputs), sampling=True))
    got = ar_cached.teacher_forced_logits(tm, *_torch(*inputs)).numpy()
    np.testing.assert_allclose(got, want, atol=CACHED_TOL, rtol=0)


def test_prefix_buckets_leave_logits_unchanged(monkeypatch):
    """Several cache-prefix buckets read only the columns a step may see,
    so the logits equal the one-bucket run's."""
    _, _, tm, tc = gpt_pair(camera_bias=True)
    inputs = _torch(*gpt_inputs(tc, seed=3))
    full = ar_cached.teacher_forced_logits(tm, *inputs)
    monkeypatch.setattr(ar_cached, "PREFIX_BUCKET", 16)
    L, nc, N = tc.gpt_block_size, tc.num_cond_tokens, tc.num_img_tokens
    assert len(ar_cached.bucket_ranges(L, nc, N, 16)) >= 3
    got = ar_cached.teacher_forced_logits(tm, *inputs)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5, rtol=0)


def test_bucket_ranges_equal_reference():
    for L, nc, N, bucket in [(64, 16, 48, 16), (2368, 256, 2100, 512),
                             (64, 16, 48, 1 << 30), (100, 7, 93, 32)]:
        assert (ar_cached.bucket_ranges(L, nc, N, bucket)
                == jax_cached.bucket_ranges(L, nc, N, bucket))
    assert ar_cached.PREFIX_BUCKET == jax_cached.PREFIX_BUCKET == 512


@pytest.mark.parametrize("case", ["plain", "nuscenes"])
def test_greedy_sampling_matches_jax(case):
    """top_k=1: the cached and the full-forward samplers give the same
    tokens as each other and as the JAX cached sampler."""
    jm, jp, tm, tc = gpt_pair(**GPT_CASES[case])
    _, cond, ii, ei = gpt_inputs(tc, seed=4)
    want = np.asarray(jax_cached.ar_sample_cached(
        jm, jp, *_jax(cond, ii, ei), jax.random.PRNGKey(5), top_k=1))
    cached = ar_cached.ar_sample_cached(tm, *_torch(cond, ii, ei),
                                        torch.Generator().manual_seed(5), top_k=1)
    full = ar.ar_sample(tm, *_torch(cond, ii, ei),
                        torch.Generator().manual_seed(6), top_k=1)
    assert cached.shape == (2, tc.num_cams) + tuple(tc.cam_latent_res)
    np.testing.assert_array_equal(cached.numpy(), full.numpy())
    np.testing.assert_array_equal(cached.numpy(), want)


def test_partial_decode_keeps_init_cameras():
    _, _, tm, tc = gpt_pair()
    ids, cond, ii, ei = _torch(*gpt_inputs(tc, seed=5))
    init = torch.full_like(ids, tc.vocab_size)
    init[:, 0] = ids[:, 0]
    for sample in (ar_cached.ar_sample_cached, ar.ar_sample):
        out = sample(tm, cond, ii, ei, torch.Generator().manual_seed(2),
                     top_k=8, init_ids=init)
        out = out.reshape(ids.shape)
        np.testing.assert_array_equal(out[:, 0].numpy(), ids[:, 0].numpy())
        assert int(out.max()) < tc.vocab_size and int(out.min()) >= 0


def test_top_k_logits_keeps_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 2.0, 0.5]])
    got = ar.top_k_logits(logits, 2)
    assert torch.isinf(got).tolist() == [[True, False, False, True, True]]
    assert torch.equal(ar.top_k_logits(logits, 99), logits)


def test_ar_pipeline_generate_matches_jax():
    """Rectangular 32x48 images (4x6 latents) through stage 1, greedy AR
    decode: the same ids and images as the JAX ARPipeline."""
    jp, params, tp = ar_tiny_pipelines()
    batch = fake_batch(tp.config, 2, seed=0)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    want_img, want_ids = jax.jit(lambda p, s, i, e: jp.generate_fn(
        p, s, i, e, jax.random.PRNGKey(0), top_k=1))(params, *_jax(seg, ii, ei))
    got_img, got_ids = tp.generate_fn(seg, ii, ei, torch.Generator().manual_seed(0),
                                      top_k=1)
    tf = tp.config.transformer
    assert got_ids.shape == (2, tf.num_cams, 4, 6)
    assert got_img.shape == (2, tf.num_cams, 32, 48, 3)
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)
    qp = tp.quantized()
    assert qp.config.transformer.quant == "int8" and qp.device == tp.device


def test_ar_pipeline_stage1_rectangular_matches_jax():
    jp, params, tp = ar_tiny_pipelines()
    batch = fake_batch(tp.config, 2, seed=1)
    want = np.asarray(jax.jit(jp.encode_bev)(
        params, jnp.asarray(batch["segmentation"])))
    got = tp.encode_bev(torch.from_numpy(batch["segmentation"]))
    np.testing.assert_array_equal(got.numpy(), want)
    ids = np.random.default_rng(1).integers(0, 32, (2, 3, 4, 6))
    want = np.asarray(jax.jit(jp.decode_tokens)(params, jnp.asarray(ids)))
    got = tp.decode_tokens(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=IMG_TOL, rtol=0)


def test_fake_batch_nuscenes_schema_matches_reference():
    want = jax_fake_batch(jcfg.nuscenes_ar_config(), 1, seed=3)
    got = fake_batch(tcfg.nuscenes_ar_config(), 1, seed=3)
    assert set(got) == set(want)
    assert got["segmentation"].shape == (1, 256, 256, 3)
    assert got["image"].shape == (1, 6, 224, 400, 3)
    assert got["intrinsics_inv"].shape == (1, 6, 3, 3)
    assert got["cam_name"] == list(tcfg.CAMERA_SETS["NUSCENES_CAMERAS"])
    for key in ("image", "segmentation", "intrinsics", "extrinsics",
                "intrinsics_inv", "extrinsics_inv"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


TINY_AR_CLI = [
    "pipeline=ar", "transformer.num_layers=1", "transformer.num_heads=2",
    "transformer.num_embed=32", "transformer.hidden_size=32",
    "transformer.vocab_size=16", "transformer.cond_vocab_size=16",
    "transformer.cam_res=(32,48)", "transformer.cam_latent_res=(4,6)",
    "transformer.bev_latent_res=(4,4)", "transformer.window_len=4",
    "first_stage.ch=8", "first_stage.ch_mult=(1,1,2,2)",
    "first_stage.num_res_blocks=1", "first_stage.z_channels=8",
    "first_stage.n_embed=16", "first_stage.embed_dim=8",
    "first_stage.resolution=32", "first_stage.attn_resolutions=(4,)",
    "first_stage.cam_res=(32,48)", "first_stage.cam_latent_res=(4,6)",
    "cond_stage.ch=8", "cond_stage.ch_mult=(1,1,2,2)",
    "cond_stage.num_res_blocks=1", "cond_stage.z_channels=8",
    "cond_stage.n_embed=16", "cond_stage.embed_dim=8",
    "cond_stage.resolution=32", "cond_stage.attn_resolutions=(4,)"]


@pytest.mark.parametrize("cached", ["true", "false"])
def test_cli_ar_writes_ids_and_images(tmp_path, cached):
    """pipeline=ar defaults to the nuscenes_ar preset (here cut to a tiny
    width by overrides)."""
    from bevgen_torch.scripts import generate as cli
    assert cli.main(TINY_AR_CLI + ["batch_size=1", "fake=1", "device=cpu",
                                   f"cached={cached}", f"out={tmp_path}"]) == 0
    out = np.load(tmp_path / "batch_0000.npz")
    assert out["ids"].shape == (1, 6, 4, 6)
    assert out["images"].shape == (1, 6, 32, 48, 3)
    assert np.isfinite(out["images"]).all()
    assert out["ids"].min() >= 0 and out["ids"].max() < 16
    with pytest.raises(SystemExit):
        cli.main(["pipeline=nope", "device=cpu"])
