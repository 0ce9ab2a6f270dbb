"""The split GEGLU + LayerNorm pair under tp (table row 13's split form,
`csrc/fused_glue.cu`: `geglu_stats_bf16`, `geglu_norm_bf16`) on the CPU: a
plain emulation of the kernels' walk and of the choice of their access
width.

The walk is the contract the kernels rely on. One block of 256 threads
takes one row r of a rank's y (rows, 2 Fl): a is its elements 2 Fl r ..,
gate the Fl after them. Thread t owns the accesses at columns i = V t +
256 V k (while i < Fl), each of V consecutive bf16, V = 2 (one bf16x2) where
Fl is even and y (and the norm's out) are 4-byte aligned, else V = 1: so
every bf16x2 access, of a, of gate and of out, is 4-byte aligned and stays
in its half of the row, at any 2-byte alignment of the tensors. A thread
sums its h and h^2 access by access; each warp's xor-shuffle tree (offsets
16, 8, 4, 2, 1) and then the eight warps in order give the row's
statistics; the norm is (h - mu) * rstd * gamma with the whole width's mu
and rstd. The emulation is held to `geglu_stats_reference` and
`geglu_norm_reference` at 1e-6 (fp32 inputs; the statistics within 1e-6 of
the sum of their terms' magnitudes, the outputs within 1e-6 absolute or
relative) and, over two emulated ranks, to the Pallas `geglu_layernorm_fwd`
in interpret mode. The kernels themselves are held to the plain versions
on the card (`chip_smoke.py` phase 53; `tests/test_torch_guards.py`, marked
`cuda`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas import fused_glue as jfg
from bevgen_torch.ops import fused_glue as fg
from bevgen_torch.ops import layernorm as ln
from bevgen_torch.parallel import tensor as tten

THREADS = 256       # csrc/row_norm.cuh:THREADS, one block a row
WARPS = THREADS // 32
LANES = np.arange(32)
# fp32 on both sides: the plain versions divide by the width where the
# kernels multiply by its inverse, so outputs up to about 10 differ in the
# last bit or two: 1e-6 absolute, and relative above 1
REF_TOL = 1e-6
# the joined ranks against the Pallas kernel: the whole-row tolerance of
# tests/test_torch_tp_glue_int8.py (SPLIT_TOL), relative above 1 as REF_TOL
SPLIT_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Torch and BLAS in two threads for this module."""
    from threadpoolctl import threadpool_limits
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with threadpool_limits(limits=2, user_api="blas"):
            yield
    finally:
        torch.set_num_threads(old)


def vector_width(Fl, *addrs):
    """The access width the C entries choose (csrc/fused_glue.cu:
    geglu_stats_bf16, geglu_norm_bf16): 2 where Fl is even and every address
    (y; the norm's out too) is 4-byte aligned, else 1."""
    return 2 if Fl % 2 == 0 and all(p % 4 == 0 for p in addrs) else 1


def _h(a, g):
    """geglu_h in fp32 (exact erf, as the kernel's erff; fp32 inputs, so no
    rounding to the input dtype)."""
    a, g = torch.from_numpy(a), torch.from_numpy(g)
    return (g * (a * 0.5 * (1.0 + torch.erf(a * 2.0 ** -0.5)))).numpy()


def _accesses(Fl, V):
    """(k, THREADS) first column of thread t's k-th access, and whether the
    access is made (the loop runs while i < Fl)."""
    k = -(-Fl // (THREADS * V))
    i = V * np.arange(THREADS)[None, :] + THREADS * V * np.arange(k)[:, None]
    return i, i < Fl


def _check_access(addr, V):
    """A bf16x2 access must be 4-byte aligned."""
    assert V == 1 or (addr % 4 == 0).all(), "a bf16x2 access off 4 bytes"


def _row(y_flat, r, Fl, V, base):
    """One row's (a, gate) as the threads load them: (k, THREADS, V) each,
    zero where no access is made, after the address checks."""
    i, made = _accesses(Fl, V)
    cols = i[..., None] + np.arange(V)
    # an access stays in its half of the row
    assert (cols[made] < Fl).all(), "an access past the half row"
    cols = np.where(made[..., None], cols, 0)
    ea = 2 * Fl * r + cols
    _check_access(base + 2 * ea[..., 0][made], V)
    _check_access(base + 2 * (ea[..., 0][made] + Fl), V)
    a = np.where(made[..., None], y_flat[ea], np.float32(0))
    g = np.where(made[..., None], y_flat[ea + Fl], np.float32(0))
    return a.astype(np.float32), g.astype(np.float32), cols, made


def _row_stats(a, g, made):
    """The stats kernel's sums over one row's loads."""
    h = np.where(made[..., None], _h(a, g), np.float32(0))
    sx = np.zeros(THREADS, np.float32)
    sy = np.zeros(THREADS, np.float32)
    for k in range(h.shape[0]):
        for v in range(h.shape[2]):
            sx = np.where(made[k], sx + h[k, :, v], sx).astype(np.float32)
            # `s.y += h * h` is one fma: the product exact, one rounding
            sy = np.where(made[k], (sy.astype(np.float64)
                                    + h[k, :, v].astype(np.float64) ** 2), sy
                          ).astype(np.float32)
    red = []
    for w in range(WARPS):
        x, y = sx[32 * w:32 * (w + 1)], sy[32 * w:32 * (w + 1)]
        for o in (16, 8, 4, 2, 1):
            x = (x + x[LANES ^ o]).astype(np.float32)
            y = (y + y[LANES ^ o]).astype(np.float32)
        assert (x == x[0]).all() and (y == y[0]).all()  # every lane agrees
        red.append((x[0], y[0]))
    t = np.array(red[0], np.float32)
    for w in range(1, WARPS):
        t = (t + np.array(red[w], np.float32)).astype(np.float32)
    return t


def block_walk(y, V, base=0, out_base=0, stats_in=None, gamma=None, F=None):
    """The kernels over a rank's y (rows, 2 Fl), fp32 values laid out as the
    kernel's 2-byte elements from byte `base`, with accesses of V elements:
    the stats kernel, or with `stats_in` the norm kernel writing from byte
    `out_base`."""
    rows, two_fl = y.shape
    Fl = two_fl // 2
    flat = y.reshape(-1)
    norm = stats_in is not None
    out = (np.full((rows, Fl), np.nan, np.float32) if norm
           else np.full((rows, 2), np.nan, np.float32))
    for r in range(rows):
        a, g, cols, made = _row(flat, r, Fl, V, base)
        if not norm:
            out[r] = _row_stats(a, g, made)
            continue
        _check_access(out_base + 2 * (Fl * r + cols[..., 0][made]), V)
        inv = np.float32(1.0) / np.float32(F)
        mu = np.float32(stats_in[r, 0] * inv)
        var = np.float32(np.float32(stats_in[r, 1] * inv) - np.float32(mu * mu))
        rstd = np.float32(1.0) / np.sqrt(np.float32(var + np.float32(ln.EPS)))
        o = ((_h(a, g) - mu) * rstd * gamma[cols]).astype(np.float32)
        out[r, cols[made]] = o[made]
    return out


def _inputs(rows, F, seed):
    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((rows, 2 * F)) * 2.0).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(F)).astype(np.float32)
    return y, g


@pytest.mark.parametrize("rows,Fl,off", [
    (13, 85, 0),       # odd Fl: single elements, the gate half 2 bytes off 4
    (9, 64, 0),        # even Fl: bf16x2
    (9, 64, 2),        # even Fl on a view 2 bytes off: single elements
    (21, 910, 0),      # tp = 3 of F = 2730 (even); accesses past 512 columns
    (21, 910, 2),
    (6, 1365, 0),      # tp = 2 of F = 2730, the serving width: 6 accesses
    (6, 1365, 2),      #   a thread
    (7, 3, 0),         # fewer columns than threads
    (5, 1, 0),
])
def test_block_walk_matches_the_plain_versions(rows, Fl, off):
    y, g = _inputs(rows, 2 * Fl, rows * 1000 + Fl + off)
    y = y[:, :2 * Fl].copy()
    gl = g[:Fl].copy()
    V = vector_width(Fl, off, 0)
    assert V == (2 if Fl % 2 == 0 and off == 0 else 1)
    stats = block_walk(y, V, off)
    yt = torch.from_numpy(y)
    want = fg.geglu_stats_reference(yt).numpy()
    h = np.abs(_h(y[:, :Fl], y[:, Fl:]).astype(np.float64))
    scale = np.stack([h.sum(-1), (h * h).sum(-1)], -1)
    assert (np.abs(stats - want) <= REF_TOL * np.maximum(scale, 1.0)).all()
    # the norm on the same statistics, here one rank's as the whole width
    F = Fl * 2
    total = want * 2.0
    normed = block_walk(y, vector_width(Fl, off, 0), off, 0, total, gl, F)
    want_n = fg.geglu_norm_reference(yt, torch.from_numpy(total),
                                     torch.from_numpy(gl), F).numpy()
    np.testing.assert_allclose(normed, want_n, atol=REF_TOL, rtol=REF_TOL)


@pytest.mark.parametrize("Fl,y_off,out_off,trips", [
    (64, 2, 0, "a bf16x2 access off 4 bytes"),     # y 2 bytes off
    (64, 0, 2, "a bf16x2 access off 4 bytes"),     # out 2 bytes off
    (910, 6, 0, "a bf16x2 access off 4 bytes"),
    (85, 0, 0, "an access past the half row"),     # odd Fl
    (1365, 0, 0, "an access past the half row"),
])
def test_bf16x2_only_where_the_width_rule_allows(Fl, y_off, out_off, trips):
    """bf16x2 accesses where `vector_width` gives 1 break the walk's
    alignment; the rule's own width does not."""
    y, g = _inputs(3, Fl, Fl + y_off + out_off)
    assert vector_width(Fl, y_off, out_off) == 1
    total = fg.geglu_stats_reference(torch.from_numpy(y)).numpy() * 2.0
    with pytest.raises(AssertionError, match=trips):
        block_walk(y, 2, y_off, out_off, total, g[:Fl].copy(), 2 * Fl)
    block_walk(y, 1, y_off, out_off, total, g[:Fl].copy(), 2 * Fl)


def test_vector_width_on_real_views():
    """Contiguous views of one buffer: at its start and 2 bf16 (4 bytes) in,
    bf16x2 at an even Fl; 1 bf16 (2 bytes) in, single elements; an odd Fl,
    single elements everywhere."""
    buf = torch.zeros(3 * 2 * 910 + 8, dtype=torch.bfloat16)
    out = torch.empty(3, 910, dtype=torch.bfloat16)
    for Fl, off, want in ((910, 0, 2), (910, 2, 2), (910, 1, 1), (455, 0, 1)):
        y = buf[off:off + 3 * 2 * Fl].view(3, 2 * Fl)
        assert y.is_contiguous()
        assert y.data_ptr() - buf.data_ptr() == 2 * off
        assert vector_width(Fl, y.data_ptr(), out.data_ptr()) == want


@pytest.fixture(scope="module")
def pallas_cases():
    """Two ranks' inputs of the whole GEGLU + LayerNorm and the Pallas
    kernel's output in interpret mode, at an odd and an even half width."""
    cases = {}
    for rows, F in ((11, 170), (6, 2730)):
        y, g = _inputs(rows, F, F + rows)
        fp = -(-F // 128) * 128
        pad = ((0, 0), (0, fp - F))
        yp = np.concatenate([np.pad(y[:, :F], pad), np.pad(y[:, F:], pad)], -1)
        gp = np.pad(g, (0, fp - F))
        kern = jfg.geglu_layernorm_fwd(jnp.asarray(yp), jnp.asarray(gp), F,
                                       tile=8, interpret=True)
        cases[(rows, F)] = (y, g, np.asarray(kern)[:, :F])
    return cases


@pytest.mark.parametrize("rows,F", [(11, 170), (6, 2730)])
def test_two_ranks_join_to_the_pallas_kernel(pallas_cases, rows, F):
    """Both ranks' statistics by the emulated stats kernel, summed in rank
    order (the sum over tp), each rank's columns by the emulated norm
    kernel, joined: the whole row's Pallas output."""
    y, g, want = pallas_cases[(rows, F)]
    ys = [tten.take_part(y, 1, 2, 2, r).copy() for r in range(2)]
    gs = [tten.take_part(g, 0, 1, 2, r).copy() for r in range(2)]
    V = vector_width(F // 2, 0, 0)
    stats = [block_walk(p, V) for p in ys]
    total = (stats[0] + stats[1]).astype(np.float32)
    parts = [block_walk(p, V, 0, 0, total, gr, F) for p, gr in zip(ys, gs)]
    got = tten.join_parts(parts, 1, 1)
    np.testing.assert_allclose(got, want, atol=SPLIT_TOL, rtol=SPLIT_TOL)
