"""The decode kernel's split of a row across a cluster (table row 11,
`csrc/decode_attention.cu`), written out in plain PyTorch as
`decode_attention_split_reference`, against the unsplit plain version and
the JAX `decode_attention_reference`, fp32 on the CPU: chunk maxima and
sums combined in rank order, per-chunk P.V with the row's statistics,
partials summed in rank order. Covers prefixes shorter than the split
(empty chunks), a wholly masked chunk and row counts that are not a
multiple of 8. The kernel itself is held to the plain version on the card
(`chip_smoke.py` phase 12).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas.decode_attention import (
    decode_attention_reference as jax_decode_ref)
from bevgen_torch.ops import decode_attention as da

# fp32 on both sides: the same softmax with its sum taken per chunk and
# recombined, and P.V summed per chunk, so only the summation order differs
TOL = 1e-6
SCALE = 0.125


def _case(b, H, pl, seed, masked_chunk=None, splits=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, 64)).astype(np.float32)
    k, v = (rng.standard_normal((b, H, pl, 64)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((H, pl)) > 0.3
    mask[:, 0] = True
    addend = np.where(mask, 0.5 * rng.standard_normal((H, pl)), da.NEG_INF)
    if masked_chunk is not None:
        c = -(-pl // splits)
        addend[:, masked_chunk * c:(masked_chunk + 1) * c] = da.NEG_INF
    return q, k, v, addend.astype(np.float32)


def _check(q, k, v, addend, splits):
    t = [torch.from_numpy(a) for a in (q, k, v, addend)]
    got = da.decode_attention_split_reference(*t, SCALE, splits)
    assert torch.isfinite(got).all()
    want = da.decode_attention_reference(*t, SCALE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    jwant = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(addend)[:, :, None], SCALE)
    np.testing.assert_allclose(got.numpy(), np.asarray(jwant), atol=TOL, rtol=0)


@pytest.mark.parametrize("splits", [1, 2, 3, 8])
@pytest.mark.parametrize("pl", [1, 5, 70, 512, 513, 2368])
def test_split_matches_plain_and_jax(pl, splits):
    # b * H = 3: not a multiple of 8 (the TPU wrapper's rows)
    _check(*_case(1, 3, pl, seed=pl + splits), splits)


@pytest.mark.parametrize("pl,chunk", [(70, 3), (2368, 0), (513, 7)])
def test_split_with_a_wholly_masked_chunk(pl, chunk):
    _check(*_case(2, 5, pl, seed=pl, masked_chunk=chunk), 8)


@pytest.mark.parametrize("pl", [1, 3, 7])
def test_prefix_shorter_than_the_split_leaves_empty_chunks(pl):
    q, k, v, addend = _case(2, 4, pl, seed=pl)
    c = -(-pl // 8)
    assert sum(1 for r in range(8) if r * c < pl) < 8  # some chunks are empty
    _check(q, k, v, addend, 8)


def test_kernel_split_rule_covers_every_ar_prefix():
    """`splits_for` (the kernel's rule, mirrored) keeps every block's chunk
    within MAX_ROWS for every pl up to MAX_PL, which covers the sequence of
    every AR configuration; the split reference follows it by default."""
    from bevgen_torch.core.config import PRESETS
    for pl in range(1, da.MAX_PL + 1):
        s = da.splits_for(pl)
        assert 1 <= s <= da.MAX_SPLITS and -(-pl // s) <= da.MAX_ROWS, pl
    for name in ("nuscenes_ar", "nuscenes_ar_tpu"):
        assert PRESETS[name]().transformer.gpt_block_size <= da.MAX_PL
    q, k, v, addend = _case(1, 3, 2368, seed=5)
    t = [torch.from_numpy(a) for a in (q, k, v, addend)]
    np.testing.assert_array_equal(
        da.decode_attention_split_reference(*t, SCALE).numpy(),
        da.decode_attention_split_reference(*t, SCALE, da.splits_for(2368)).numpy())


def test_split_reference_takes_bf16_and_prefix_views():
    """bf16 caches read through prefix views, as the decode step hands them
    over: the split rounds the weights to bf16 with the row's statistics,
    as the unsplit version does, so the two agree to a bf16 step."""
    q, k, v, addend = _case(2, 16, 512, seed=9)
    wide = [torch.zeros(2, 16, 600, 64, dtype=torch.bfloat16) for _ in range(2)]
    wide[0][:, :, :512] = torch.from_numpy(k)
    wide[1][:, :, :512] = torch.from_numpy(v)
    qb, ad = torch.from_numpy(q).bfloat16(), torch.from_numpy(addend)
    got = da.decode_attention_split_reference(qb, wide[0][:, :, :512],
                                              wide[1][:, :, :512], ad, SCALE)
    want = da.decode_attention_reference(qb, wide[0][:, :, :512],
                                         wide[1][:, :, :512], ad, SCALE)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= 2e-2 * want.float().abs().max().item()
