"""The serving pipeline of the PyTorch port against the JAX reference at
tiny_test, fp32 on the CPU: `generate_fn` end to end under the greedy
config, images decoded from the same ids, the fake batch, and the CLI.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.data.fake import fake_batch as jax_fake_batch
from bevgen_torch.data.fake import fake_batch
from torch_parity import tiny_pipelines

IDS_AGREE_MIN = 0.99   # greedy decode; see test_torch_maskgit.py
IMG_TOL = 1e-4         # fp32 convolutions summed in another order


def test_fake_batch_matches_reference():
    jp, _, tp = tiny_pipelines(greedy=True)
    want = jax_fake_batch(jp.config, 2, seed=3)
    got = fake_batch(tp.config, 2, seed=3)
    assert set(got) == set(want)
    for key in ("image", "segmentation", "intrinsics", "extrinsics",
                "intrinsics_inv", "extrinsics_inv"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_generate_fn_end_to_end_matches_jax():
    jp, params, tp = tiny_pipelines(greedy=True)
    batch = fake_batch(tp.config, 2, seed=0)
    seg, ii, ei = (batch[k] for k in ("segmentation", "intrinsics_inv",
                                      "extrinsics_inv"))
    want_img, want_ids = jax.jit(jp.generate_fn)(
        params, jnp.asarray(seg), jnp.asarray(ii), jnp.asarray(ei),
        jax.random.PRNGKey(0))
    got_img, got_ids = tp.generate_fn(seg, ii, ei,
                                      torch.Generator().manual_seed(0))
    tf = tp.config.transformer
    assert got_ids.shape == (2, tf.num_cams) + tuple(tf.cam_latent_res)
    assert got_img.shape == (2, tf.num_cams) + tuple(tf.cam_res) + (3,)
    assert (got_ids.numpy() == np.asarray(want_ids)).mean() >= IDS_AGREE_MIN
    # images decoded from the SAME ids agree to fp32 precision
    same = tp.decode_tokens(torch.from_numpy(np.array(want_ids)))
    np.testing.assert_allclose(same.numpy(), np.asarray(want_img),
                               atol=IMG_TOL, rtol=0)


def test_encode_bev_matches_jax():
    jp, params, tp = tiny_pipelines(greedy=True)
    seg = fake_batch(tp.config, 2, seed=4)["segmentation"]
    want = np.asarray(jp.encode_bev(params, jnp.asarray(seg)))
    with torch.no_grad():
        got = tp.encode_bev(torch.from_numpy(seg)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cli_writes_ids_and_images(tmp_path):
    from bevgen_torch.scripts import generate as cli
    assert cli.main(["preset=tiny_test", "batch_size=2", "fake=1", "seed=3",
                     "device=cpu", f"out={tmp_path}",
                     "muse.sample_iterations=2"]) == 0
    out = np.load(tmp_path / "batch_0000.npz")
    assert out["ids"].shape == (2, 3, 4, 4)
    assert out["images"].shape == (2, 3, 32, 32, 3)
    assert np.isfinite(out["images"]).all()
    with pytest.raises(SystemExit):
        cli.main(["preset=nope", "device=cpu"])
