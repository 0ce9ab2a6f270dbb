"""Cosine attention of the PyTorch port: the plain version against the
JAX reference's dense oracle and its fb2 Pallas kernel (interpret mode),
and the dispatcher's device rules. The CUDA kernel itself is held against
the plain version on the card (tests/test_torch_guards.py, chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas import fused_attention as fa
from bevgen_torch.ops import cosine_attention as ca

# fp32 on both sides; the two differ only in summation order (and, for the
# fb2 kernel, in its fixed-bound exp2 softmax), so 1e-5 / 1e-4 absolute
# on outputs of magnitude ~1
DENSE_TOL = 1e-5
FB2_TOL = 1e-4


def _inputs(B, H, N, M, D, with_bias, keep, seed, prenorm=True):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, N, D)).astype(np.float32)
    k = rng.standard_normal((B, H, M, D)).astype(np.float32)
    v = rng.standard_normal((B, H, M, D)).astype(np.float32)
    null_kv = rng.standard_normal((2, H, 1, D)).astype(np.float32)
    qs = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ks = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    if prenorm:
        k = (k / np.linalg.norm(k, axis=-1, keepdims=True) * ks).astype(np.float32)
    bias = (rng.uniform(0, 2, (N, M)).astype(np.float32) if with_bias else None)
    keep_a = None if keep is None else np.asarray(keep, np.float32)
    return q, k, v, null_kv, qs, ks, bias, keep_a


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax(a):
    return None if a is None else jnp.asarray(a)


CASES = [
    # (B, H, N, M, D, bias, keep)
    (2, 2, 16, 16, 32, True, None),
    (2, 2, 16, 16, 32, False, None),
    (2, 2, 16, 8, 32, True, [1, 0]),
    (2, 2, 96, 70, 64, True, [1, 0]),
    (1, 3, 96, 70, 64, False, None),
]


@pytest.mark.parametrize("k_prenormed", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_dense(case, k_prenormed):
    B, H, N, M, D, with_bias, keep = case
    args = _inputs(B, H, N, M, D, with_bias, keep, seed=N + M,
                   prenorm=k_prenormed)
    dense = fa.make_cosine_attention(sm_scale=8.0, use_pallas=False,
                                     k_prenormed=k_prenormed)
    want = np.asarray(dense(*[_jax(a) for a in args]))
    got = ca.cosine_attention_reference(*[_torch(a) for a in args],
                                        sm_scale=8.0, k_prenormed=k_prenormed)
    assert got.shape == (B, H, N, D)
    np.testing.assert_allclose(got.numpy(), want, atol=DENSE_TOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_fb2_interpret(case):
    B, H, N, M, D, with_bias, keep = case
    args = _inputs(B, H, N, M, D, with_bias, keep, seed=7 * N + M)
    want = np.asarray(fa.fused_cosine_attention_fwd_fb2(
        *[_jax(a) for a in args], sm_scale=8.0, interpret=True,
        k_prenormed=True))
    got = ca.cosine_attention_reference(*[_torch(a) for a in args],
                                        sm_scale=8.0, k_prenormed=True)
    np.testing.assert_allclose(got.numpy(), want, atol=FB2_TOL, rtol=0)


def test_dropped_row_sees_only_null_column():
    q, k, v, nkv, qs, ks, bias, keep = _inputs(2, 2, 8, 5, 32, True, [1, 0], 3)
    out = ca.cosine_attention_reference(*[_torch(a) for a in
                                          (q, k, v, nkv, qs, ks, bias, keep)])
    # sample 1 dropped: every row's output is the null value vector
    np.testing.assert_allclose(out[1].numpy(),
                               np.broadcast_to(nkv[1], (2, 8, 32)), atol=1e-6)


def test_dispatcher_takes_plain_version_on_cpu():
    args = [_torch(a) for a in _inputs(1, 2, 16, 12, 32, True, None, 5)]
    before = ca.cosine_attention_cuda.launches
    got = ca.cosine_attention(*args)
    want = ca.cosine_attention_reference(*args)
    assert torch.equal(got, want)
    assert ca.cosine_attention_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    args = [_torch(a) for a in _inputs(1, 2, 16, 12, 32, True, None, 6)]
    with pytest.raises(ValueError, match="CUDA"):
        ca.cosine_attention_cuda(*args)
