"""Stage 1 of the PyTorch port against the JAX reference at tiny_test, fp32
on the CPU, on the same weights (load_jax_params): encode indices are
equal and decode_code images agree, for the RGB VQ-GAN and the BEV VQ-VAE.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.models.stage1.vq import VQModel as JaxVQ
from bevgen_torch.models.stage1 import quantize as tq
from torch_parity import tiny_pipelines

# fp32 convolutions on both sides, summed in another order: 1e-4 absolute
# on images of magnitude ~1
IMG_TOL = 1e-4


def _models(which):
    jp, params, tp = tiny_pipelines()
    return getattr(jp, which), params[which], getattr(tp, which)


def _input(which, cfg, seed):
    rng = np.random.default_rng(seed)
    shape = (2, cfg.resolution, cfg.resolution, cfg.in_channels)
    if which == "cond_stage":
        return (rng.uniform(size=shape) < 0.2).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("which", ["first_stage", "cond_stage"])
def test_encode_indices_equal(which):
    jm, jparams, tm = _models(which)
    x = _input(which, tm.cfg, seed=1)
    want = jm.apply(jparams, jnp.asarray(x), method=JaxVQ.encode)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.z_q.numpy(), np.asarray(want.z_q),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("which", ["first_stage", "cond_stage"])
def test_decode_code_matches(which):
    jm, jparams, tm = _models(which)
    cfg = tm.cfg
    h = cfg.resolution // cfg.downsample_factor
    ids = np.random.default_rng(2).integers(0, cfg.n_embed, (3, h, h))
    want = np.asarray(jm.apply(jparams, jnp.asarray(ids, jnp.int32),
                               method=JaxVQ.decode_code))
    with torch.no_grad():
        got = tm.decode_code(torch.from_numpy(ids)).numpy()
    assert got.shape == (3, cfg.resolution, cfg.resolution, cfg.out_ch)
    np.testing.assert_allclose(got, want, atol=IMG_TOL, rtol=0)


def test_argmin_takes_first_index_on_ties():
    codebook = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0]])
    z = torch.tensor([[[1.0, 0.0], [0.5, 0.5]]])
    idx = tq.nearest_indices(z, codebook)
    assert idx.tolist() == [[0, 0]]
    assert torch.equal(tq.quantize(z, codebook).z_q[0, 0], codebook[0])
