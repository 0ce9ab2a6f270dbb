"""The AR path's static artifacts and attention ops in the PyTorch port
against the JAX reference, on the CPU: the sparse masks and layouts (exact,
also at the full nuscenes_ar and nuscenes_ar_tpu sizes), the nuScenes
decode order, the kernel's tile plan, and the plain versions of the
block-sparse attention (against the TPU kernel in interpret mode and the
dense XLA path) and of the decode attention.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.core import config as jcfg
from bevgen_tpu.models import geometry as jgeo
from bevgen_tpu.models import masks as jmasks
from bevgen_tpu.ops.attention import make_sparse_attention
from bevgen_tpu.ops.pallas.block_sparse import block_sparse_attention
from bevgen_tpu.ops.pallas.decode_attention import (
    decode_attention as jax_decode, decode_attention_reference as jax_decode_ref)
from bevgen_torch.core import config as tcfg
from bevgen_torch.models import geometry as tgeo
from bevgen_torch.models import masks as tmasks
from bevgen_torch.ops import block_sparse as bs
from bevgen_torch.ops import decode_attention as da
from torch_parity import NUSCENES_GPT, ar_tiny_configs, gpt_configs

TOL = 1e-5  # fp32 attention, the same dense arithmetic in another order


def _config_pairs():
    pairs = {
        "tiny": gpt_configs(),
        "tiny-bias": gpt_configs(camera_bias=True),
        "tiny-nuscenes": gpt_configs(**NUSCENES_GPT),
        "tiny-rect": tuple(c.transformer for c in ar_tiny_configs()),
    }
    for name in ("nuscenes_ar", "nuscenes_ar_tpu"):
        pairs[name] = (jcfg.PRESETS[name]().transformer,
                       tcfg.PRESETS[name]().transformer)
    return pairs


CONFIGS = _config_pairs()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sparse_masks_equal_reference(name):
    jc, tc = CONFIGS[name]
    want, got = jmasks.sparse_masks(jc), tmasks.sparse_masks(tc)
    for field in want._fields:
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field),
                                      err_msg=field)
    np.testing.assert_array_equal(tmasks.camera_bias_matrix(tc),
                                  jmasks.camera_bias_matrix(jc))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_index_rule_equals_allowed_mask(name):
    _, tc = CONFIGS[name]
    L = tc.gpt_block_size
    got = bs.allowed_mask(L, tc.num_cond_tokens, tc.num_pad_tokens).numpy()
    np.testing.assert_array_equal(got, tmasks.sparse_masks(tc).allowed > 0)


def test_nuscenes_presets_and_geometry_equal_reference():
    for name in ("nuscenes_ar", "nuscenes_ar_tpu"):
        jc, tc = jcfg.PRESETS[name](), tcfg.PRESETS[name]()
        for part in ("transformer", "first_stage", "cond_stage"):
            j, t = dataclasses.asdict(getattr(jc, part)), dataclasses.asdict(
                getattr(tc, part))
            assert {k: j[k] for k in t} == t, part
    jc, tc = CONFIGS["nuscenes_ar"]
    assert (tc.gpt_block_size, tc.num_pad_tokens, tc.num_img_tokens) == (2368, 12, 2100)
    for a, b in zip(tgeo.decode_order(tc), jgeo.decode_order(jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgeo.col_angles(tc), jgeo.col_angles(jc))
    fwd, bwd = tgeo.decode_order(tc)
    assert sorted(fwd.tolist()) == list(range(2100))
    np.testing.assert_array_equal(fwd[bwd], np.arange(2100))


@pytest.mark.parametrize("name", ["tiny-nuscenes", "tiny-rect", "nuscenes_ar_tpu"])
def test_tile_plan_covers_every_kept_pair(name):
    """Every (row, col) the attention keeps lies in a key tile listed for
    the row's query tile; the lists are ascending and never empty."""
    _, tc = CONFIGS[name]
    L, blk = tc.gpt_block_size, tc.sparse_block_size
    layouts = tmasks.sparse_masks(tc).layouts
    plan = bs.plan_tiles(layouts, blk, L, tc.num_cond_tokens, tc.num_pad_tokens)
    keep = (bs.expand_layout_mask(torch.from_numpy(layouts), blk, L)
            & bs.allowed_mask(L, tc.num_cond_tokens, tc.num_pad_tokens)[None])
    nt = -(-L // bs.TILE)
    pad = nt * bs.TILE - L
    kt = torch.nn.functional.pad(keep, (0, pad, 0, pad)).reshape(
        keep.shape[0], nt, bs.TILE, nt, bs.TILE).any(4).any(2).numpy()
    assert (plan.counts >= 1).all()
    for h in range(keep.shape[0]):
        for i in range(nt):
            listed = plan.indices[h, i, :plan.counts[h, i]]
            assert (np.diff(listed) > 0).all()
            assert set(np.nonzero(kt[h, i])[0]) <= set(listed.tolist())


PLAN_CASES = ["tiny-nuscenes", "tiny-rect", "nuscenes_ar_tpu", "nuscenes_ar"]


@functools.lru_cache(maxsize=None)
def _plans(name):
    """Both tile plans of a config, the (H, nt, nt) tiles they list and
    flag (scattered from their lists), and which tiles keep every pair and
    which keep any (from the dense keep mask)."""
    _, tc = CONFIGS[name]
    L, blk = tc.gpt_block_size, tc.sparse_block_size
    layouts = tmasks.sparse_masks(tc).layouts
    args = (layouts, blk, L, tc.num_cond_tokens, tc.num_pad_tokens)
    plan, plan_t = bs.plan_tiles(*args), bs.plan_tiles(*args, transpose=True)
    keep = bs.keep_mask(torch.from_numpy(layouts), *args[1:])
    H, nt = plan.counts.shape
    pad = nt * bs.TILE - L
    tiles = torch.nn.functional.pad(keep, (0, pad, 0, pad)).reshape(
        H, nt, bs.TILE, nt, bs.TILE)
    all_kept = tiles.all(4).all(2).numpy()
    any_kept = tiles.any(4).any(2).numpy()

    def scatter(p):
        listed, flagged = np.zeros((2, H, nt, nt), bool)
        for h in range(H):
            for i in range(nt):
                n = p.counts[h, i]
                listed[h, i, p.indices[h, i, :n]] = True
                flagged[h, i, p.indices[h, i, :n]] = p.full[h, i, :n] > 0
                assert not p.full[h, i, n:].any()  # 0-padded like indices
        return listed, flagged

    return plan, plan_t, scatter(plan), scatter(plan_t), all_kept, any_kept


@pytest.mark.parametrize("name", PLAN_CASES)
def test_tile_plan_full_tiles_keep_every_pair(name):
    """A listed tile flagged full keeps every pair of its 64 x 64 (so the
    kernels may skip the mask there), and every such tile is flagged."""
    plan, _, (listed, flagged), _, all_kept, _ = _plans(name)
    assert plan.full.dtype == np.uint8 and plan.full.shape == plan.indices.shape
    assert all_kept[flagged].all()
    np.testing.assert_array_equal(flagged, listed & all_kept)


@pytest.mark.parametrize("name", PLAN_CASES)
def test_tile_plan_partial_tiles_drop_a_pair(name):
    """Every listed tile that is not flagged has a pair that is not kept:
    the mask is evaluated exactly where it is needed."""
    _, _, (listed, flagged), _, all_kept, _ = _plans(name)
    assert not all_kept[listed & ~flagged].any()


@pytest.mark.parametrize("name", PLAN_CASES)
def test_transposed_tile_plan_flags_are_the_forward_flags_transposed(name):
    plan, plan_t, (listed, flagged), (listed_t, flagged_t), _, _ = _plans(name)
    assert plan_t.full.dtype == np.uint8
    np.testing.assert_array_equal(listed_t, listed.transpose(0, 2, 1))
    np.testing.assert_array_equal(flagged_t, flagged.transpose(0, 2, 1))


def test_tile_plan_full_and_partial_counts_at_nuscenes_ar():
    """Over the 16 heads of nuscenes_ar, 10,240 of the 11,344 listed tiles
    are full and 1,104 partial (the causal diagonal, the pad rows, the
    condition edge); nuscenes_ar_tpu lists 430 tiles that keep no pair
    (half of a diagonal 128-token block), which are partial."""
    plan = _plans("nuscenes_ar")[0]
    assert (int(plan.counts.sum()), int(plan.full.sum())) == (11344, 10240)
    plan, _, (listed, flagged), _, _, any_kept = _plans("nuscenes_ar_tpu")
    assert (int(plan.counts.sum()), int(plan.full.sum())) == (5248, 4132)
    assert int((listed & ~any_kept).sum()) == 430
    assert not flagged[~any_kept].any()


def _sparse_case(L, block, nc, num_pad, H=2, B=2, D=32, density=0.5, seed=0):
    """A random causal block layout with its diagonal and, for pad rows,
    block column 0; fp32 q, k, v and a bias, from numpy."""
    rng = np.random.default_rng(seed)
    nb = -(-L // block)
    layout = (rng.uniform(size=(H, nb, nb)) < density) & np.tril(
        np.ones((nb, nb), bool))
    for h in range(H):
        np.fill_diagonal(layout[h], True)
    if num_pad:
        layout[:, (L - num_pad) // block:, 0] = True
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32)
               for _ in range(3))
    bias = rng.standard_normal((L, L)).astype(np.float32)
    return layout.astype(np.int64), q, k, v, bias


SPARSE_CASES = {  # L, block, nc, num_pad: aligned, and unaligned with pad rows
    "b8": (128, 8, 16, 0), "b16": (256, 16, 32, 0),
    "b8-unaligned-pad": (200, 8, 24, 8), "b16-unaligned-pad": (190, 16, 20, 6),
}


def _walk_forward(q, k, v, keep, bias, scale, plan):
    """The forward tile by tile from the plan, as the kernel walks it: for
    each (head, query tile) only its listed key tiles, with the mask applied
    on the partial ones and none on the full ones."""
    B, H, L, D = q.shape
    T = bs.TILE
    out, lse = torch.zeros_like(q), torch.zeros(B, H, L)
    for h in range(H):
        for i in range(plan.counts.shape[1]):
            r = slice(i * T, min(i * T + T, L))
            scores, vals = [], []
            for j in range(plan.counts[h, i]):
                kt = plan.indices[h, i, j]
                c = slice(kt * T, min(kt * T + T, L))
                s = q[:, h, r] @ k[:, h, c].transpose(-1, -2)
                if bias is not None:
                    s = s + bias[r, c]
                s = s * scale
                if not plan.full[h, i, j]:
                    s = torch.where(keep[h, r, c], s, torch.tensor(bs.NEG_INF))
                scores.append(s)
                vals.append(v[:, h, c])
            s = torch.cat(scores, -1)
            lse[:, h, r] = torch.logsumexp(s, -1)
            out[:, h, r] = torch.softmax(s, -1) @ torch.cat(vals, -2)
    return out, lse


def _walk_backward(q, k, v, keep, bias, scale, out, do, lse, plan, plan_t):
    """The backward tile by tile: dq (and dbias) over the forward's plan,
    dk and dv over its transpose; P is recomputed from the lse and masked
    on partial tiles only."""
    B, H, L, D = q.shape
    T = bs.TILE
    delta = (do * out).sum(-1)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dbias = torch.zeros(L, L) if bias is not None else None

    def tile(h, qt, kt, full):
        r = slice(qt * T, min(qt * T + T, L))
        c = slice(kt * T, min(kt * T + T, L))
        s = q[:, h, r] @ k[:, h, c].transpose(-1, -2)
        if bias is not None:
            s = s + bias[r, c]
        p = torch.exp(s * scale - lse[:, h, r, None])
        if not full:
            p = torch.where(keep[h, r, c], p, torch.tensor(0.0))
        dp = do[:, h, r] @ v[:, h, c].transpose(-1, -2)
        return r, c, p, p * (dp - delta[:, h, r, None])

    nt = plan.counts.shape[1]
    for h in range(H):
        for i in range(nt):
            for j in range(plan.counts[h, i]):
                r, c, p, ds = tile(h, i, plan.indices[h, i, j], plan.full[h, i, j])
                dq[:, h, r] += ds @ k[:, h, c] * scale
                if dbias is not None:
                    dbias[r, c] += ds.sum(0) * scale
            for j in range(plan_t.counts[h, i]):
                r, c, p, ds = tile(h, plan_t.indices[h, i, j], i,
                                   plan_t.full[h, i, j])
                dk[:, h, c] += ds.transpose(-1, -2) @ q[:, h, r] * scale
                dv[:, h, c] += p.transpose(-1, -2) @ do[:, h, r]
    return dq, dk, dv, dbias


WALK_CASES = dict(SPARSE_CASES, **{
    # dense causal layouts: every tile below the diagonal is full, but for
    # the pad rows
    "dense-b16": (256, 16, 32, 0), "dense-b16-unaligned-pad": (232, 16, 40, 5),
    "tiny-nuscenes": None})


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_plan_walk_matches_plain_versions(case, with_bias):
    """The contract the kernels rely on: walking only the listed tiles, and
    masking only the partial ones, gives the plain forward (out, lse) and
    backward (dq, dk, dv, dbias), fp32 at 1e-5."""
    if case == "tiny-nuscenes":
        _, tc = CONFIGS[case]
        L, block = tc.gpt_block_size, tc.sparse_block_size
        nc, num_pad = tc.num_cond_tokens, tc.num_pad_tokens
        layout = tmasks.sparse_masks(tc).layouts.astype(np.int64)
        _, q, k, v, bias = _sparse_case(L, block, nc, num_pad, H=layout.shape[0])
    else:
        L, block, nc, num_pad = WALK_CASES[case]
        density = 1.0 if case.startswith("dense") else 0.5
        layout, q, k, v, bias = _sparse_case(L, block, nc, num_pad,
                                             density=density)
    args = (layout, block, L, nc, num_pad)
    plan, plan_t = bs.plan_tiles(*args), bs.plan_tiles(*args, transpose=True)
    if case.startswith("dense"):
        assert plan.full.any()
    rng = np.random.default_rng(7)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    q, k, v, bias = (torch.from_numpy(a) for a in (q, k, v, bias))
    bias = bias if with_bias else None
    lt = torch.from_numpy(layout)
    keep = bs.keep_mask(lt, block, L, nc, num_pad)
    scale = 1.0 / np.sqrt(q.shape[-1])
    out, lse = _walk_forward(q, k, v, keep, bias, scale, plan)
    want, want_lse = bs.block_sparse_attention_reference(
        q, k, v, lt, block, nc, num_pad, bias, return_lse=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=TOL, rtol=0)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=TOL, rtol=1e-6)
    got = _walk_backward(q, k, v, keep, bias, scale, want, do, want_lse, plan,
                         plan_t)
    ref = bs.block_sparse_attention_bwd_reference(q, k, v, lt, block, nc,
                                                  num_pad, bias, want, do,
                                                  want_lse)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, ref):
        if w is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), w.numpy(),
                                   atol=TOL * float(w.abs().max()), rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("case", sorted(SPARSE_CASES))
def test_block_sparse_reference_matches_jax(case, with_bias):
    L, block, nc, num_pad = SPARSE_CASES[case]
    layout, q, k, v, bias = _sparse_case(L, block, nc, num_pad)
    bias = bias if with_bias else None
    allowed = bs.allowed_mask(L, nc, num_pad).numpy().astype(np.float32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jb = None if bias is None else jnp.asarray(bias)
    want_k, want_lse = block_sparse_attention(
        jq, jk, jv, layout, allowed, jb, block=block, num_cond_tokens=nc,
        num_pad_tokens=num_pad, return_lse=True, interpret=True)
    want_d = make_sparse_attention(layout, allowed, block=block,
                                   use_pallas=False)(jq, jk, jv, jb)
    attn = bs.SparseAttention(layout, block, nc, num_pad)
    with torch.no_grad():
        got, lse = attn(*(torch.from_numpy(a) for a in (q, k, v)),
                        None if bias is None else torch.from_numpy(bias),
                        return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_k), atol=TOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_d), atol=TOL, rtol=0)
    want_lse = np.asarray(want_lse)[:, :L, 0].reshape(lse.shape)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=1e-6)


def test_block_sparse_reference_is_differentiable_on_cpu():
    layout, q, k, v, bias = _sparse_case(64, 8, 8, 0, seed=1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = bs.SparseAttention(layout, 8, 8)(*leaves)
    grads = torch.autograd.grad(out.square().sum(), leaves)
    assert all(torch.isfinite(g).all() and g.abs().max() > 0 for g in grads)
    assert bs.block_sparse_attention_cuda.launches == 0


def _decode_case(b, H, pl, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, H, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, H, pl, dh)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((H, pl)) > 0.3
    mask[:, 0] = True  # at least one attendable column per row
    addend = np.where(mask, rng.standard_normal((H, pl)), da.NEG_INF)
    return q, k, v, addend.astype(np.float32)


@pytest.mark.parametrize("pl", [64, 192])
def test_decode_reference_matches_jax(pl):
    q, k, v, addend = _decode_case(2, 4, pl)
    args = [jnp.asarray(a) for a in (q, k, v)] + [jnp.asarray(addend)[:, :, None]]
    got = da.decode_attention(*(torch.from_numpy(a) for a in (q, k, v, addend)),
                              0.125).numpy()
    # fp32: the same arithmetic in another summation order
    np.testing.assert_allclose(got, np.asarray(jax_decode(*args, 0.125,
                                                          interpret=True)),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jax_decode_ref(*args, 0.125)),
                               atol=TOL, rtol=0)
    # bf16 inputs: both round the weights to bf16 before P.V and write bf16,
    # so they may differ by a bf16 step of |out| (the JAX test's 2e-2)
    bq, bk, bv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_decode(bq, bk, bv, args[3], 0.125, interpret=True)
    got = da.decode_attention(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)),
                              torch.from_numpy(addend), 0.125)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2, rtol=2e-2)


def test_decode_reference_takes_any_row_count_and_prefix_views():
    """b*H = 3 (the TPU wrapper needs multiples of 8 and falls back to its
    reference) and K/V given as prefix views of wider caches."""
    q, k, v, addend = _decode_case(1, 3, 70, seed=1)
    want = np.asarray(jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v),
                                     jnp.asarray(addend)[:, :, None], 0.125))
    wide = [torch.zeros(1, 3, 96, 64) for _ in range(2)]
    wide[0][:, :, :70], wide[1][:, :, :70] = torch.from_numpy(k), torch.from_numpy(v)
    got = da.decode_attention(torch.from_numpy(q), wide[0][:, :, :70],
                              wide[1][:, :, :70], torch.from_numpy(addend), 0.125)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert da.decode_attention_cuda.launches == 0
