"""The standalone LayerNorm (table row 14, `csrc/layernorm.cu`) on the CPU:
a plain emulation of the register form's walk, and the rule that picks
between the register form and the general form.

The walk is the contract the register form relies on: one warp per row,
lane l owning the 8-column chunks l + 32 k (k below the instance's chunk
count, the chunk below D / 8), per-lane partial sums taken chunk by chunk
and column by column, an xor-shuffle tree (offsets 16, 8, 4, 2, 1) for the
row's sum and sum of squares, and a persistent grid of G blocks of 8 warps
in which warp w of block b takes rows b + G (w + 8 j) and holds at most two
rows at a time (the next row's loads go out before the current row's
reduction and store). The emulation is held to `layernorm_reference` at
1e-6 and to the Pallas `fused_layernorm` in interpret mode at 1e-5 (fp32
inputs of scale 3 about 1, outputs up to about 5). The kernel itself is
held to the plain version on the card (`chip_smoke.py` phases 21 and 25;
`tests/test_torch_guards.py`, marked `cuda`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops.pallas import layernorm as jln
from bevgen_torch.ops import layernorm as ln

WARPS = 8      # warps of a block of the register form
CHUNK = 8      # bf16 in one 16-byte access
LANES = np.arange(32)
REF_TOL = 1e-6
PALLAS_TOL = 1e-5


def warp_instance(D):
    """Chunks a lane holds in the instance the kernel launches for width D
    (csrc/layernorm.cu:warp_instance): the fewest of 1, 2, 4, 8 that cover
    D / 8 chunks."""
    need = -(-(D // CHUNK) // 32)
    return next(n for n in (1, 2, 4, 8) if need <= n)


def _load(xrow, nch):
    """One row's chunks as the lanes hold them: (nch, 32, 8) values and the
    (nch, 32) mask of chunks that exist."""
    chunks = xrow.reshape(-1, CHUNK)
    c = LANES[None, :] + 32 * np.arange(nch)[:, None]
    valid = c < len(chunks)
    vals = np.where(valid[..., None], chunks[np.minimum(c, len(chunks) - 1)],
                    np.float32(0))
    return vals.astype(np.float32), valid


def _normalize(vals, valid, gchunks, D):
    s = np.zeros(32, np.float32)
    ss = np.zeros(32, np.float32)
    for k in range(vals.shape[0]):
        for i in range(CHUNK):
            f = vals[k, :, i]
            s = np.where(valid[k], s + f, s).astype(np.float32)
            ss = np.where(valid[k], ss + f * f, ss).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        s = (s + s[LANES ^ o]).astype(np.float32)
        ss = (ss + ss[LANES ^ o]).astype(np.float32)
    assert (s == s[0]).all() and (ss == ss[0]).all()  # every lane agrees
    inv = np.float32(1.0) / np.float32(D)
    mu = s[0] * inv
    var = ss[0] * inv - mu * mu
    rstd = np.float32(1.0) / np.sqrt(var + np.float32(ln.EPS))
    return ((vals - mu) * rstd * gchunks).astype(np.float32)


def warp_walk(x, scale, grid):
    """The register form's walk over x (rows, D), D a multiple of 8, with
    `grid` blocks. Returns (out, the rows each warp took in order, the most
    rows a warp held at once)."""
    rows, D = x.shape
    nch = warp_instance(D)
    nchunks = D // CHUNK
    out = np.full(x.shape, np.nan, np.float32)
    gv, _ = _load(scale.astype(np.float32), nch)
    order, held = {}, 0
    for b in range(grid):
        for w in range(WARPS):
            mine = list(range(b + grid * w, rows, grid * WARPS))
            order[(b, w)] = mine
            if not mine:
                continue
            cur = _load(x[mine[0]], nch)
            for j, r in enumerate(mine):
                nxt = _load(x[mine[j + 1]], nch) if j + 1 < len(mine) else None
                held = max(held, 1 + (nxt is not None))
                o = _normalize(*cur, gv, D)
                c = LANES[None, :] + 32 * np.arange(nch)[:, None]
                for k in range(nch):
                    for lane in range(32):
                        if c[k, lane] < nchunks:
                            cc = c[k, lane]
                            out[r, cc * CHUNK:(cc + 1) * CHUNK] = o[k, lane]
                cur = nxt
    return out, order, held


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 3.0 + 1.0).astype(np.float32)
    s = (1.0 + 0.1 * rng.standard_normal(shape[-1:])).astype(np.float32)
    return x, s


@pytest.mark.parametrize("shape,grid", [
    ((2, 7, 64), 2),       # 14 rows over 16 warps: two warps idle
    ((3, 13, 1024), 1),    # 39 rows over 8 warps: 4 or 5 rows a warp
    ((3, 13, 1024), 5),    # 39 rows over 40 warps
    ((5, 9, 512), 2),      # 45 rows over 16 warps
    ((1, 11, 1000), 3),    # 125 chunks: the last lanes hold 3 of 4
    ((2, 3, 2048), 1),     # the widest instance, 8 chunks a lane
])
def test_warp_walk_matches_reference_and_pallas(shape, grid):
    x, s = _inputs(shape, shape[-1] + grid)
    rows = int(np.prod(shape[:-1]))
    got, order, held = warp_walk(x.reshape(rows, -1), s, grid)
    # every row exactly once, each warp's rows in order, two at most in flight
    taken = sorted(r for rs in order.values() for r in rs)
    assert taken == list(range(rows))
    assert held == (2 if rows > grid * WARPS else 1)
    got = got.reshape(shape)
    with torch.no_grad():
        want = ln.layernorm_reference(torch.from_numpy(x), torch.from_numpy(s))
    np.testing.assert_allclose(got, want.numpy(), atol=REF_TOL, rtol=0)
    pallas = jln.fused_layernorm(jnp.asarray(x), jnp.asarray(s), interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=PALLAS_TOL, rtol=0)


@pytest.mark.parametrize("D,nch", [(8, 1), (256, 1), (264, 2), (512, 2),
                                   (1000, 4), (1024, 4), (1032, 8), (2048, 8)])
def test_warp_instance_covers_the_row(D, nch):
    assert warp_instance(D) == nch
    assert 32 * CHUNK * nch >= D


@pytest.mark.parametrize("D,ptrs,want", [
    (1024, (0, 16, 4096), "warp"),
    (64, (256, 512, 768), "warp"),
    (8, (16, 16, 16), "warp"),
    (ln.WARP_MAX_WIDTH, (0, 0, 0), "warp"),
    (ln.WARP_MAX_WIDTH + 8, (0, 0, 0), "block"),   # above the cap
    (4096, (0, 0, 0), "block"),
    (1003, (0, 0, 0), "block"),                   # odd width
    (1020, (0, 0, 0), "block"),                   # even, not a multiple of 8
    (12, (0, 0, 0), "block"),
    (1024, (2, 0, 0), "block"),                   # x one bf16 off
    (1024, (4, 0, 0), "block"),                   # x 4-byte aligned only
    (1024, (0, 8, 0), "block"),                   # scale off 16 bytes
    (1024, (0, 0, 1032), "block"),                # out off 16 bytes
    (0, (0, 0, 0), "block"),
])
def test_layernorm_variant_rule(D, ptrs, want):
    assert ln.layernorm_variant(D, *ptrs) == want


def test_variant_rule_on_misaligned_views():
    """A contiguous view that starts one or two bf16 into its storage is off
    16 bytes, and so goes to the general form; the same rows at the
    storage's start go to the register form."""
    buf = torch.zeros(3 * 1024 + 8, dtype=torch.bfloat16)
    scale = torch.ones(1024)
    for off, want in ((0, "warp"), (1, "block"), (2, "block"), (8, "warp")):
        x = buf[off:off + 3 * 1024].view(3, 1024)
        assert x.is_contiguous()
        assert ln.layernorm_variant(1024, x.data_ptr(), scale.data_ptr()) == want

