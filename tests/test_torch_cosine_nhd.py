"""The (B, L, H, D) cosine-attention entry of the PyTorch port,
`make_cosine_attention_nhd`, against the JAX package's
`make_cosine_attention_nhd(use_pallas=False)` and its nhd Pallas kernel in
interpret mode, fp32 on the CPU: the forward, the gradients of all seven
inputs (as tests/test_fused_attention.py:358 takes them), the route rules,
and the wrapper's layout: the (B, H, L, D) views it hands the attention
share the inputs' memory, and its (B, N, H * D) result is a view of the
attention's (B, N, H, D) output.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas import fused_attention as fa
from bevgen_torch.ops import cosine_attention as ca

# fp32 on both sides, the same arithmetic in another order (outputs of
# magnitude ~1); the interpret-mode kernel's fixed-bound exp2 softmax 1e-4,
# as tests/test_torch_cosine_attention.py holds it
DENSE_TOL = 1e-5
KERNEL_TOL = 1e-4
GRAD_TOL = 1e-5    # of each gradient's largest entry


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch and BLAS in two threads for this module: beside the other test
    processes on the machine, more threads only contend for its cores."""
    from threadpoolctl import threadpool_limits
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(limits=2, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(old)


def _inputs(B, N, M, H, D, with_bias, keep, seed):
    """q (B, N, H, D); k, v (B, M, H, D) raw; null_kv, q_scale, k_scale,
    bias (N, M) or None, keep (B,) or None."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, H, D)).astype(np.float32)
    k = rng.standard_normal((B, M, H, D)).astype(np.float32)
    v = rng.standard_normal((B, M, H, D)).astype(np.float32)
    null_kv = rng.standard_normal((2, H, 1, D)).astype(np.float32)
    qs = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    ks = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    bias = rng.uniform(0, 2, (N, M)).astype(np.float32) if with_bias else None
    keep_a = None if keep is None else np.asarray(keep, np.float32)
    return q, k, v, null_kv, qs, ks, bias, keep_a


def _torch(a):
    return None if a is None else torch.from_numpy(a)


def _jax(a):
    return None if a is None else jnp.asarray(a)


CASES = [
    # (B, N, M, H, D, bias, keep)
    (2, 48, 48, 2, 32, True, None),
    (2, 48, 16, 2, 32, False, None),
    (2, 40, 24, 4, 64, True, [1, 0]),
    (1, 96, 70, 3, 64, True, None),
]


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_jax_dense(case):
    B, N, M, H, D, with_bias, keep = case
    args = _inputs(B, N, M, H, D, with_bias, keep, seed=N + M + H)
    want = np.asarray(fa.make_cosine_attention_nhd(sm_scale=8.0,
                                                   use_pallas=False)(
        *[_jax(a) for a in args]))
    got = ca.make_cosine_attention_nhd(sm_scale=8.0)(*[_torch(a) for a in args])
    assert got.shape == (B, N, H * D)
    np.testing.assert_allclose(got.numpy(), want, atol=DENSE_TOL, rtol=0)


def test_forward_matches_the_nhd_kernel_interpret():
    B, N, M, H, D = 2, 64, 40, 4, 64
    q, k, v, nkv, qs, ks, bias, _ = _inputs(B, N, M, H, D, True, None, 9)
    keep = np.asarray([1, 0], np.int32)
    want = np.asarray(fa.fused_cosine_attention_fwd_nhd(
        *[_jax(a) for a in (q, k, v, nkv, qs, ks, bias, keep)], sm_scale=8.0,
        head_group=2, interpret=True))
    got = ca.make_cosine_attention_nhd()(
        *[_torch(a) for a in (q, k, v, nkv, qs, ks, bias)],
        keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=KERNEL_TOL, rtol=0)


@pytest.mark.parametrize("with_bias", [True, False])
def test_gradients_of_all_seven_inputs_match_jax(with_bias):
    B, N, M, H, D = 2, 64, 40, 4, 32
    args = _inputs(B, N, M, H, D, True, None, 11)[:7]
    g = np.random.default_rng(12).standard_normal(
        (B, N, H * D)).astype(np.float32)
    jfn = fa.make_cosine_attention_nhd(sm_scale=8.0, use_pallas=False)

    def loss(q, k, v, nkv, qs, ks, bias):
        return jnp.sum(jfn(q, k, v, nkv, qs, ks, bias if with_bias else None)
                       * g)

    want = jax.grad(loss, argnums=tuple(range(7)))(*[_jax(a) for a in args])
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    out = ca.make_cosine_attention_nhd(sm_scale=8.0)(
        *leaves[:6], leaves[6] if with_bias else None)
    got = torch.autograd.grad(out, leaves if with_bias else leaves[:6],
                              torch.from_numpy(g))
    names = "q k v null_kv q_scale k_scale bias".split()
    for name, a, w in zip(names, got, want):
        w = np.asarray(w)
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), w, atol=GRAD_TOL * np.abs(w).max(),
                                   rtol=0, err_msg=name)
    if not with_bias:   # no bias, no bias gradient: JAX's is all zero
        assert not np.asarray(want[6]).any()


def test_views_in_and_out(monkeypatch):
    """The attention gets (B, H, L, D) views of q and v (and of the normed
    k) with no copy, and the entry returns its output's memory: a view of
    the (B, N, H, D) tensor that row 1's kernel writes."""
    B, N, M, H, D = 2, 24, 16, 2, 32
    q, k, v, nkv, qs, ks, bias, _ = (_torch(a) for a in _inputs(
        B, N, M, H, D, True, None, 13))
    seen = {}

    def core(qv, kv, vv, *rest):
        seen.update(q=qv, k=kv, v=vv)
        # the kernel's output layout: (B, H, N, D) over (B, N, H, D) memory
        out = torch.empty(B, N, H, D).transpose(1, 2)
        out.copy_(ca.cosine_attention_reference(qv, kv, vv, *rest[:4]))
        seen["out"] = out
        return out

    monkeypatch.setattr(ca, "cosine_attention", core)
    got = ca.make_cosine_attention_nhd()(q, k, v, nkv, qs, ks, bias)
    assert seen["q"].data_ptr() == q.data_ptr()
    assert seen["v"].data_ptr() == v.data_ptr()
    assert seen["q"].shape == (B, H, N, D) and seen["k"].shape == (B, H, M, D)
    assert seen["k"].transpose(1, 2).is_contiguous()
    assert got.data_ptr() == seen["out"].data_ptr()
    assert got.shape == (B, N, H * D)
    assert torch.equal(got.reshape(B, N, H, D), seen["out"].transpose(1, 2))


def test_route_rules_on_the_cpu():
    args = [_torch(a) for a in _inputs(1, 16, 12, 2, 32, True, None, 5)]
    before = ca.cosine_attention_cuda.launches
    auto = ca.make_cosine_attention_nhd()(*args)
    plain = ca.make_cosine_attention_nhd(use_kernel=False)(*args)
    assert torch.equal(auto, plain)
    assert ca.cosine_attention_cuda.launches == before
    with pytest.raises(ValueError, match="use_kernel=True"):
        ca.make_cosine_attention_nhd(use_kernel=True)(*args)
