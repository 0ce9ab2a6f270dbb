"""Attention backward (row 8) and plain biased attention (row 7) of the
PyTorch port against the JAX reference, fp32 on the CPU: the plain
backward against `fused_bias_attention_bwd` in interpret mode and against
`jax.grad` of `_dense_reference`; the plain biased forward against
`_dense_reference`; the seven gradients of the cosine Function against
`make_cosine_attention` with and without Pallas; the biased Function's
gradients; and the dispatchers' device rules. The CUDA kernels are held
against these plain versions on the card (`chip_smoke.py`).
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas import fused_attention as fa
from bevgen_torch.ops import attention_bwd as ab
from bevgen_torch.ops import bias_attention as ba
from bevgen_torch.ops import cosine_attention as ca

# fp32 on both sides; sums over <= 70 columns and D = 32 in another order,
# on gradients of magnitude ~1: 1e-5 absolute against XLA, 1e-4 against the
# interpret-mode Pallas kernel (its padded 128-wide tiles sum in blocks)
DENSE_TOL = 1e-5
PALLAS_TOL = 1e-4
B, H, N, M, D = 2, 2, 160, 70, 32


def _bwd_inputs(with_bias, keep, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, N, D)).astype(np.float32) * 0.3
    k = rng.standard_normal((B, H, M, D)).astype(np.float32) * 0.3
    v = rng.standard_normal((B, H, M, D)).astype(np.float32)
    do = rng.standard_normal((B, H, N, D)).astype(np.float32)
    bias = rng.uniform(-1, 1, (N, M)).astype(np.float32) if with_bias else None
    keep_a = None if keep is None else np.asarray(keep, np.float32)
    return q, k, v, bias, keep_a, do


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


CASES = [(True, [1, 0]), (False, [1, 0]), (True, None)]


@pytest.mark.parametrize("with_bias,keep", CASES)
def test_bwd_reference_matches_pallas_interpret(with_bias, keep):
    q, k, v, bias, keep_a, do = _bwd_inputs(with_bias, keep, 1)
    want = fa.fused_bias_attention_bwd(_j(q), _j(k), _j(v), _j(bias),
                                       _j(keep_a), _j(do), sm_scale=2.0,
                                       interpret=True)
    got = ab.attention_bwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                     _t(keep_a), _t(do), sm_scale=2.0)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=PALLAS_TOL,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("with_bias,keep", CASES)
def test_bwd_reference_matches_jax_grad_of_dense(with_bias, keep):
    q, k, v, bias, keep_a, do = _bwd_inputs(with_bias, keep, 2)

    def f(q, k, v, bias):
        return fa._dense_reference(q, k, v, bias, _j(keep_a), 2.0)

    _, vjp = jax.vjp(f, _j(q), _j(k), _j(v), _j(bias))
    want = vjp(_j(do))
    got = ab.attention_bwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                     _t(keep_a), _t(do), sm_scale=2.0)
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert g is None
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DENSE_TOL,
                                   rtol=0, err_msg=name)


def test_dropped_sample_gives_keys_past_the_null_column_no_gradient():
    q, k, v, bias, keep_a, do = _bwd_inputs(True, [1, 0], 3)
    dq, dk, dv, _ = ab.attention_bwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                               _t(keep_a), _t(do), 2.0)
    assert torch.count_nonzero(dk[1, :, 1:]) == 0
    assert torch.count_nonzero(dv[1, :, 1:]) == 0
    assert torch.count_nonzero(dv[1, :, 0]) > 0


@pytest.mark.parametrize("with_bias,keep", CASES)
def test_bias_attention_reference_matches_dense(with_bias, keep):
    q, k, v, bias, keep_a, _ = _bwd_inputs(with_bias, keep, 4)
    want = np.asarray(fa._dense_reference(_j(q), _j(k), _j(v), _j(bias),
                                          _j(keep_a), 2.0))
    got = ba.bias_attention_reference(_t(q), _t(k), _t(v), _t(bias),
                                      _t(keep_a), 2.0)
    np.testing.assert_allclose(got.numpy(), want, atol=DENSE_TOL, rtol=0)


def test_bias_attention_function_gradients_match_jax():
    q, k, v, bias, keep_a, do = _bwd_inputs(True, [1, 0], 5)
    attn = fa.make_fused_attention(sm_scale=2.0, use_pallas=False)
    _, vjp = jax.vjp(lambda *a: attn(*a, keep=_j(keep_a)), _j(q), _j(k),
                     _j(v), _j(bias))
    want = vjp(_j(do))
    leaves = [_t(a).requires_grad_() for a in (q, k, v, bias)]
    out = ba.bias_attention(*leaves, keep=_t(keep_a), sm_scale=2.0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, _t(do))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DENSE_TOL,
                                   rtol=0, err_msg=name)


def _cosine_inputs(with_bias, keep, seed, Bc=2, Hc=2, Nc=64, Mc=33, Dc=64):
    rng = np.random.default_rng(seed)
    ks = (1 + 0.1 * rng.standard_normal(Dc)).astype(np.float32)
    qs = (1 + 0.1 * rng.standard_normal(Dc)).astype(np.float32)
    q = rng.standard_normal((Bc, Hc, Nc, Dc)).astype(np.float32)
    k = rng.standard_normal((Bc, Hc, Mc, Dc)).astype(np.float32)
    k = (k / np.linalg.norm(k, axis=-1, keepdims=True) * ks).astype(np.float32)
    v = rng.standard_normal((Bc, Hc, Mc, Dc)).astype(np.float32)
    nkv = rng.standard_normal((2, Hc, 1, Dc)).astype(np.float32)
    bias = (rng.uniform(0, 2, (Nc, Mc)).astype(np.float32) if with_bias
            else None)
    keep_a = None if keep is None else np.asarray(keep, np.float32)
    w = rng.standard_normal((Bc, Hc, Nc, Dc)).astype(np.float32)
    return (q, k, v, nkv, qs, ks, bias), keep_a, w


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The fb2 forward and the backward in interpret mode, as
    tests/test_fused_attention.py runs them on the CPU."""
    monkeypatch.setattr(fa, "fused_cosine_attention_fwd_fb2",
                        partial(fa.fused_cosine_attention_fwd_fb2,
                                interpret=True))
    monkeypatch.setattr(fa, "fused_bias_attention_bwd",
                        partial(fa.fused_bias_attention_bwd, interpret=True))
    monkeypatch.setenv("BEVGEN_COSINE_KERNEL", "fb2")


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("with_bias,keep", [(True, [1, 0]), (False, None)])
def test_cosine_function_gradients_match_jax(use_pallas, with_bias, keep,
                                             request):
    if use_pallas:
        request.getfixturevalue("pallas_interpret")
    args, keep_a, w = _cosine_inputs(with_bias, keep, 6)
    attn = fa.make_cosine_attention(sm_scale=8.0, use_pallas=use_pallas,
                                    k_prenormed=True)
    n = 7 if with_bias else 6
    jargs = [_j(a) for a in args[:n]]

    def loss(*a):
        full = list(a) + [None] * (7 - n)
        return jnp.sum(attn(*full, keep=_j(keep_a)) * _j(w))

    want = jax.grad(loss, argnums=tuple(range(n)))(*jargs)
    leaves = [_t(a).requires_grad_() for a in args[:n]] + [None] * (7 - n)
    out = ca.cosine_attention(*leaves, keep=_t(keep_a))
    assert isinstance(out.grad_fn, ca.CosineAttentionFn._backward_cls)
    got = torch.autograd.grad((out * _t(w)).sum(), leaves[:n])
    names = ("q", "k", "v", "null_kv", "q_scale", "k_scale", "bias")
    tol = PALLAS_TOL if use_pallas else DENSE_TOL
    for name, g, wv in zip(names, got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(g.numpy(), wv,
                                   atol=tol * max(1.0, np.abs(wv).max()),
                                   rtol=0, err_msg=name)


def test_cpu_dispatch_takes_plain_versions_and_launches_nothing():
    q, k, v, bias, keep_a, do = _bwd_inputs(True, [1, 0], 7)
    before = (ab.attention_bwd_cuda.launches, ba.bias_attention_cuda.launches)
    got = ab.attention_bwd(_t(q), _t(k), _t(v), _t(bias), _t(keep_a), _t(do),
                           2.0)
    want = ab.attention_bwd_reference(_t(q), _t(k), _t(v), _t(bias),
                                      _t(keep_a), _t(do), 2.0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    out = ba.bias_attention(_t(q), _t(k), _t(v), _t(bias), _t(keep_a), 2.0)
    assert torch.equal(out, ba.bias_attention_reference(
        _t(q), _t(k), _t(v), _t(bias), _t(keep_a), 2.0))
    assert (ab.attention_bwd_cuda.launches,
            ba.bias_attention_cuda.launches) == before


def test_kernel_wrappers_refuse_other_devices():
    q, k, v, bias, keep_a, do = _bwd_inputs(True, None, 8)
    t = [_t(a) for a in (q, k, v)]
    with pytest.raises(ValueError, match="CUDA"):
        ab.attention_bwd_cuda(*t, _t(bias), None, t[0], _t(do),
                              torch.zeros(B, H, N), 2.0)
    with pytest.raises(ValueError, match="CUDA"):
        ba.bias_attention_cuda(*t, _t(bias))
    meta = torch.zeros(1, 1, 4, 32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        ab.attention_bwd(meta, meta, meta, None, None, meta)
    with pytest.raises(ValueError, match="meta"):
        ba.bias_attention(meta, meta, meta)
