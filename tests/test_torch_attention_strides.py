"""The attention forward's strided inputs: `cosine_attention` and
`bias_attention` on head-transposed views of (B, N, H, D) tensors, as the
MUSE transformer hands them over, against the same calls on contiguous
copies and against the JAX package's dense oracles on the same numpy
inputs; and the forward kernel's argument check, a plain function that runs
here. The kernel itself reads such views on the card
(tests/test_torch_guards.py, chip_smoke.py phases 3 and 6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas import fused_attention as fa
from bevgen_torch.ops import _build
from bevgen_torch.ops import bias_attention as ba
from bevgen_torch.ops import cosine_attention as ca

# fp32 on both sides, differing only in summation order (as the dense
# parity tests of tests/test_torch_cosine_attention.py)
DENSE_TOL = 1e-5

CASES = [
    # (B, H, N, M, D, bias, keep)
    (2, 4, 96, 70, 64, True, [1, 0]),
    (1, 3, 40, 257, 32, True, None),
    (2, 2, 24, 17, 32, False, None),
]


def _inputs(B, H, N, M, D, with_bias, keep, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, N, H, D)).astype(np.float32)
    k = rng.standard_normal((B, M, H, D)).astype(np.float32)
    v = rng.standard_normal((B, M, H, D)).astype(np.float32)
    ks = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    qs = (1 + 0.1 * rng.standard_normal(D)).astype(np.float32)
    k = (k / np.linalg.norm(k, axis=-1, keepdims=True) * ks).astype(np.float32)
    null_kv = rng.standard_normal((2, H, 1, D)).astype(np.float32)
    bias = rng.uniform(0, 2, (N, M)).astype(np.float32) if with_bias else None
    keep_a = None if keep is None else np.asarray(keep, np.float32)
    # (B, H, rows, D) views of the (B, rows, H, D) arrays (not contiguous),
    # as `CosineAttention.forward` makes of its projections, and numpy
    # copies of them for the JAX side
    views = [torch.from_numpy(x).transpose(1, 2) for x in (q, k, v)]
    heads = [np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v)]
    return heads, views, null_kv, qs, ks, bias, keep_a


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("case", CASES)
def test_cosine_attention_on_head_views(case):
    B, H, N, M, D, with_bias, keep = case
    heads, views, nkv, qs, ks, bias, keep_a = _inputs(*case, seed=N + M)
    assert not views[0].is_contiguous() and views[0].stride(-1) == 1
    rest = (_t(nkv), _t(qs), _t(ks), _t(bias), _t(keep_a))
    got = ca.cosine_attention(*views, *rest)
    on_copies = ca.cosine_attention(*(x.contiguous() for x in views), *rest)
    assert torch.equal(got, on_copies)
    dense = fa.make_cosine_attention(sm_scale=8.0, use_pallas=False,
                                     k_prenormed=True)
    want = np.asarray(dense(*(jnp.asarray(x) for x in heads),
                            jnp.asarray(nkv), jnp.asarray(qs),
                            jnp.asarray(ks),
                            None if bias is None else jnp.asarray(bias),
                            None if keep_a is None else jnp.asarray(keep_a)))
    np.testing.assert_allclose(got.numpy(), want, atol=DENSE_TOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_bias_attention_on_head_views(case):
    B, H, N, M, D, with_bias, keep = case
    heads, views, _, _, _, bias, keep_a = _inputs(*case, seed=3 * N + M)
    got = ba.bias_attention(*views, _t(bias), _t(keep_a), 2.0)
    on_copies = ba.bias_attention(*(x.contiguous() for x in views), _t(bias),
                                  _t(keep_a), 2.0)
    assert torch.equal(got, on_copies)
    want = np.asarray(fa._dense_reference(
        *(jnp.asarray(x) for x in heads),
        None if bias is None else jnp.asarray(bias),
        None if keep_a is None else jnp.asarray(keep_a), 2.0))
    np.testing.assert_allclose(got.numpy(), want, atol=DENSE_TOL, rtol=0)


def _bf16_case(B=2, H=4, N=24, M=20, D=64):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, N, H, D, generator=g).bfloat16().transpose(1, 2)
    k = torch.randn(B, M, H, D, generator=g).bfloat16().transpose(1, 2)
    v = torch.randn(B, M, H, D, generator=g).bfloat16().transpose(1, 2)
    rest = (torch.randn(2, H, 1, D), torch.ones(D), torch.ones(D),
            torch.rand(N, M), torch.tensor([1, 0], dtype=torch.int32))
    return q, k, v, rest


def test_kernel_arg_check_takes_head_views():
    q, k, v, rest = _bf16_case()
    assert ca.check_kernel_args(q, k, v, *rest) == (2, 4, 24, 20, 64)
    assert ba.check_kernel_args(q, k, v, rest[3], rest[4]) == (2, 4, 24, 20, 64)
    # views the kernel reads as they are: no copy
    for t in (q, k, v):
        assert _build.rows(t) is t


def test_kernel_arg_check_refuses_a_strided_last_dim():
    q, k, v, rest = _bf16_case()
    # every other element of a (.., 128) tensor: last-dim stride 2
    q2 = torch.zeros(2, 4, 24, 128, dtype=torch.bfloat16)[..., ::2]
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        ca.check_kernel_args(q2, k, v, *rest)
    with pytest.raises(ValueError, match="last dim must be contiguous"):
        ba.check_kernel_args(q, k, v.transpose(2, 3).contiguous()
                             .transpose(2, 3))
    # the dispatch copies such a tensor before the kernel sees it
    assert _build.rows(q2).is_contiguous()


def test_kernel_arg_check_refuses_misaligned_rows():
    q, k, v, rest = _bf16_case()
    # rows 68 bf16 apart: 136 bytes, not a multiple of 16
    k3 = torch.zeros(2, 4, 20, 68, dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="16 bytes"):
        ca.check_kernel_args(q, k3, v, *rest)
    assert _build.rows(k3).is_contiguous()


@pytest.mark.parametrize("bad", ["k", "v", "bias", "keep", "null_kv",
                                 "q_scale"])
def test_kernel_arg_check_refuses_mismatched_shapes(bad):
    q, k, v, (nkv, qs, ks, bias, keep) = _bf16_case()
    args = dict(k=k, v=v, null_kv=nkv, q_scale=qs, k_scale=ks, bias=bias,
                keep=keep)
    args[bad] = {"k": k[:, :3], "v": v[:, :, :19], "bias": bias[:, :19],
                 "keep": keep[:1], "null_kv": nkv[:, :3],
                 "q_scale": qs[:32]}[bad]
    with pytest.raises(ValueError, match="shape"):
        ca.check_kernel_args(q, args["k"], args["v"], args["null_kv"],
                             args["q_scale"], args["k_scale"], args["bias"],
                             args["keep"])


def test_kernel_arg_check_refuses_other_dtypes_and_head_dims():
    q, k, v, rest = _bf16_case()
    with pytest.raises(TypeError, match="dtype"):
        ca.check_kernel_args(q.float(), k, v, *rest)
    q48, k48, v48, rest48 = _bf16_case(D=48)
    with pytest.raises(ValueError, match="head dim 48"):
        ca.check_kernel_args(q48, k48, v48, *rest48)


def test_kernel_output_merges_heads_as_a_view():
    q, _, _, _ = _bf16_case()
    out = ba.new_output(q)
    assert out.shape == q.shape and out.stride(-1) == 1
    merged = out.transpose(1, 2).reshape(2, 24, 4 * 64)
    merged.fill_(1.0)  # a view: writes through to out
    assert bool((out == 1.0).all())


def test_row_strides_in_elements_with_zero_for_unit_dims():
    q, k, _, _ = _bf16_case(B=1)
    strides = list(_build.row_strides(q, k))
    # q is a (1, 4, 24, 64) view of (1, 24, 4, 64): b unit, h 64, row 256
    assert strides == [0, 64, 256, 0, 64, 256]


def test_bias_rows_pads_unaligned_rows_into_a_view():
    g = torch.Generator().manual_seed(1)
    aligned = torch.rand(6, 20, generator=g)
    assert ba.bias_rows(aligned) is aligned
    bias = torch.rand(6, 17, generator=g)
    rows = ba.bias_rows(bias)
    # rows padded to 20 floats (80 bytes), the same (6, 17) values
    assert rows.shape == (6, 17) and rows.stride() == (20, 1)
    assert torch.equal(rows, bias)
    assert ba.check_kernel_args(*_bf16_case(N=6, M=17)[:3], rows) == \
        (2, 4, 6, 17, 64)
    with pytest.raises(ValueError, match="16 bytes"):
        ba.check_kernel_args(*_bf16_case(N=6, M=17)[:3], bias)


def test_kernel_strides_end_with_the_bias_row_stride():
    q, k, v, rest = _bf16_case()
    out = ba.new_output(q)
    bias = ba.bias_rows(torch.rand(24, 21))
    strides = list(ba.kernel_strides(q, k, v, out, bias))
    assert len(strides) == 13 and strides[-1] == 24
    assert strides[9:12] == [24 * 4 * 64, 64, 4 * 64]
    assert list(ba.kernel_strides(q, k, v, out, None))[-1] == 0
