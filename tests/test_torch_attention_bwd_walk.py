"""The MaskGit attention backward (table row 8, `csrc/attention_bwd.cu`) on
the CPU: the dispatch with head-transposed qf, out and dO against
contiguous inputs and the Pallas backward in interpret mode; the kernels'
stride array; and a plain emulation of the kernels' tile walks, held to
`attention_bwd_reference` in fp32 at 1e-5 of each gradient's largest
entry. The walks are the contract the kernels rely on: 64-row tiles
zero-filled past N and M, P recomputed from the log2 logsumexp, the mask
evaluated only on the partial last key tile (dq), the partial last query
tile (dk/dv) and a dropped sample's tiles, and dbias summed over (b, h) in
order by blocks of 64 rows x 128 keys, two warpgroups of 64 keys each. The
kernels themselves are held to the plain version on the card
(`chip_smoke.py` phase 6).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bevgen_tpu.ops.pallas import fused_attention as fa
from bevgen_torch.ops import attention_bwd as ab

PALLAS_TOL = 1e-4  # as tests/test_torch_attention_bwd.py
WALK_TOL = 1e-5
T = 64                # tile rows of every kernel
DB_KEYS = 128         # keys of a dbias block
LOG2E = 1.4426950408889634


def _inputs(B, H, N, M, D, with_bias, keep, seed):
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


def _heads_view(x):
    """(B, H, L, D) as a head-transposed view of a (B, L, H, D) tensor."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("with_bias,keep", [(True, [1, 0]), (False, None),
                                            (True, None)])
def test_cpu_dispatch_takes_head_transposed_views(with_bias, keep):
    B, H, N, M, D = 2, 2, 160, 70, 32
    q, k, v, bias, keep_a, do = _inputs(B, H, N, M, D, with_bias, keep, 7)
    qt, kt, vt, dot = (_t(a) for a in (q, k, v, do))
    out = torch.zeros_like(qt)  # the forward's output: unused by the plain version
    want = ab.attention_bwd(qt, kt, vt, _t(bias), _t(keep_a), dot, 2.0,
                            out=out, lse=None)
    qs, outs, dos = (_heads_view(x) for x in (qt, out, dot))
    assert not qs.is_contiguous() and not dos.is_contiguous()
    got = ab.attention_bwd(qs, kt, vt, _t(bias), _t(keep_a), dos, 2.0,
                           out=outs, lse=None)
    pallas = fa.fused_bias_attention_bwd(_j(q), _j(k), _j(v), _j(bias),
                                         _j(keep_a), _j(do), sm_scale=2.0,
                                         interpret=True)
    for name, g, w, p in zip(("dq", "dk", "dv", "dbias"), got, want, pallas):
        if w is None:
            assert g is None and p is None
            continue
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), atol=PALLAS_TOL,
                                   rtol=0, err_msg=name)
    assert ab.attention_bwd_cuda.launches == 0


def test_kernel_strides_cover_eight_tensors_and_the_bias_rows():
    B, H, N, M, D = 2, 3, 20, 21, 64
    q = _heads_view(torch.zeros(B, H, N, D))
    k = torch.zeros(B, H, M, D)
    bias = ab.bias_rows(torch.zeros(N, M))
    assert bias.stride(0) == 24  # M = 21 padded to a multiple of 4
    strides = list(ab.kernel_strides(q, k, k, q, q, q, k, k, bias))
    assert len(strides) == 25
    assert strides[:3] == [N * H * D, D, H * D]   # (b, h, row) of the view
    assert strides[3:6] == [H * M * D, M * D, D]
    assert strides[-1] == 24
    assert list(ab.kernel_strides(q, k, k, q, q, q, k, k, None))[-1] == 0


def test_cuda_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 1, 64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        ab.attention_bwd_cuda(x, x, x, None, None, x, x,
                              torch.zeros(1, 1, 64), 8.0)
    assert ab.attention_bwd_cuda.launches == 0


def _rows(x, n):
    """x (..., L, D) zero-filled to n rows, as a tile copy past the end."""
    return F.pad(x, (0, 0, 0, n - x.shape[-2]))


def _lse2(q, k, bias, keep, sm_scale):
    """The forward's per-row logsumexp in log2 units over the valid columns."""
    s = torch.einsum("bhid,bhjd->bhij", q, k) * sm_scale
    if bias is not None:
        s = s + bias
    valid = ab.valid_columns(keep, q.shape[0], k.shape[2], s.device)
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s, torch.tensor(-torch.inf))
    return torch.logsumexp(s, -1) * LOG2E


def _walk_backward(q, k, v, bias, keep, do, sm_scale):
    """dq, dk, dv, dbias as the three kernels walk their tiles."""
    B, H, N, D = q.shape
    M = k.shape[2]
    nq, nk, nkb = -(-N // T), -(-M // T), -(-M // DB_KEYS)
    s_full = torch.einsum("bhid,bhjd->bhij", q, k) * sm_scale
    if bias is not None:
        s_full = s_full + bias
    valid = ab.valid_columns(keep, B, M, q.device)
    if valid is not None:
        s_full = torch.where(valid[:, None, None, :], s_full, torch.tensor(ab.NEG_INF))
    o = torch.einsum("bhij,bhjd->bhid", torch.softmax(s_full, -1), v)  # the forward's output
    lse = _lse2(q, k, bias, keep, sm_scale)
    # tiles zero-filled past N and M; lse and delta zero past N (the
    # kernels' zero-filled vectors)
    qp, dop = _rows(q, nq * T), _rows(do, nq * T)
    kp, vp = _rows(k, nkb * DB_KEYS), _rows(v, nkb * DB_KEYS)
    bl = torch.zeros(nq * T, nkb * DB_KEYS)
    if bias is not None:
        bl[:N, :M] = bias * LOG2E
    lsep = F.pad(lse, (0, nq * T - N))
    deltap = F.pad((do * o).sum(-1), (0, nq * T - N))
    sc = sm_scale * LOG2E
    kept = [keep is None or bool(keep[b] > 0) for b in range(B)]
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dbias = torch.zeros(N, M) if bias is not None else None
    for b in range(B):
        for h in range(H):
            # 1. dq: all key tiles, the first of a dropped sample; the mask
            # on the partial last tile and a dropped sample's tile only
            for i in range(nq):
                r = slice(i * T, (i + 1) * T)
                acc = torch.zeros(T, D)
                for j in range(nk if kept[b] else 1):
                    c = slice(j * T, (j + 1) * T)
                    p = torch.exp2(qp[b, h, r] @ kp[b, h, c].T * sc + bl[r, c]
                                   - lsep[b, h, r, None])
                    if j * T + T > M or not kept[b]:
                        col = torch.arange(j * T, j * T + T)
                        ok = (col < M) & (kept[b] | (col == 0))
                        p = torch.where(ok[None], p, torch.zeros(()))
                    dp = dop[b, h, r] @ vp[b, h, c].T
                    acc += (p * (dp - deltap[b, h, r, None])) @ kp[b, h, c]
                n = min(N, (i + 1) * T) - i * T
                dq[b, h, i * T:i * T + n] = acc[:n] * sm_scale
            # 2. dk, dv: keys past the first tile of a dropped sample get
            # zeros; the mask on the partial last query tile and a dropped
            # sample's keys past the null column only
            for j in range(nk):
                if not (kept[b] or j == 0):
                    continue
                c = slice(j * T, (j + 1) * T)
                key = torch.arange(j * T, j * T + T)
                dka, dva = torch.zeros(T, D), torch.zeros(T, D)
                for i in range(nq):
                    r = slice(i * T, (i + 1) * T)
                    p = torch.exp2(kp[b, h, c] @ qp[b, h, r].T * sc + bl[r, c].T
                                   - lsep[b, h, r][None])
                    if not kept[b] or i * T + T > N:
                        q_ok = torch.arange(i * T, i * T + T) < N
                        k_ok = torch.full((T,), kept[b]) | (key == 0)
                        p = torch.where(k_ok[:, None] & q_ok[None], p, torch.zeros(()))
                    dpt = vp[b, h, c] @ dop[b, h, r].T
                    dva += p @ dop[b, h, r]
                    dka += (p * (dpt - deltap[b, h, r][None])) @ qp[b, h, r]
                n = min(M, (j + 1) * T) - j * T
                dk[b, h, j * T:j * T + n] = dka[:n] * sm_scale
                dv[b, h, j * T:j * T + n] = dva[:n]
    # 3. dbias: blocks of 64 rows x 128 keys, a warpgroup's 64 keys summed
    # over (b, h) in order; no mask but a dropped sample's null column
    if dbias is not None:
        for i in range(nq):
            r = slice(i * T, (i + 1) * T)
            for y in range(nkb):
                for w in range(DB_KEYS // T):
                    kw0 = y * DB_KEYS + w * T
                    c = slice(kw0, kw0 + T)
                    acc = torch.zeros(T, T)
                    for it in range(B * H):
                        b, h = divmod(it, H)
                        if not kept[b] and kw0 > 0:
                            continue
                        p = torch.exp2(qp[b, h, r] @ kp[b, h, c].T * sc + bl[r, c]
                                       - lsep[b, h, r, None])
                        if not kept[b]:
                            col = torch.arange(kw0, kw0 + T)
                            p = torch.where((col == 0)[None], p, torch.zeros(()))
                        dp = dop[b, h, r] @ vp[b, h, c].T
                        acc += p * (dp - deltap[b, h, r, None])
                    n, m = min(N, (i + 1) * T) - i * T, min(M, kw0 + T) - kw0
                    if m > 0:
                        dbias[i * T:i * T + n, kw0:kw0 + m] = acc[:n, :m]
    return dq, dk, dv, dbias


WALK_CASES = {
    # N, M as the MaskGit shapes cut down: M = N + 1 (a partial last key
    # tile holding one column) and M = 257's kind, a partial query tile,
    # a dropped sample, no bias
    "self-like": (2, 2, 128, 129, 32, True, None),
    "partial-q+keep": (2, 2, 150, 70, 32, True, [1, 0]),
    "cross-like+keep": (2, 3, 96, 257, 64, True, [0, 1]),
    "no-bias": (1, 2, 130, 200, 32, False, None),
}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_tile_walks_match_plain_backward(case):
    B, H, N, M, D, with_bias, keep = WALK_CASES[case]
    q, k, v, bias, keep_a, do = (_t(a) for a in _inputs(B, H, N, M, D, with_bias,
                                                         keep, 11))
    got = _walk_backward(q, k, v, bias, keep_a, do, 2.0)
    want = ab.attention_bwd_reference(q, k, v, bias, keep_a, do, 2.0)
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        if w is None:
            assert a is None
            continue
        np.testing.assert_allclose(a.numpy(), w.numpy(),
                                   atol=WALK_TOL * float(w.abs().max()), rtol=0,
                                   err_msg=name)
