"""The int8 products of the port (`bevgen_torch/csrc/int8_gemm.cu`) on the
CPU: what a CPU can hold of kernels that run only on the card.

  * the fused W8A8 route's plain version (`int8_dense_reference`, mesh None)
    against the JAX package's `QuantDense` and `int8_matmul`, jitted, bit
    for bit: static and dynamic, bf16 and fp32 outputs, ragged K and N
    (1003, 1365, 2730), on the unpadded weight and on the padded operand;
  * the pure-Python plans of the two kernels (`w8_plan`, `int8_linear_plan`):
    every int8 product of `tiny_test`, `argoverse_muse_7cam` and
    `nuscenes_ar`, whole and at a tp=2 rank (the models built on the meta
    device, split by `tp_plan`), gets a plan that the kernel takes, with no
    shape left to another route but the row-split chain under tp;
  * `w8_linear`'s summation orders (the decode form's K split over warps and
    a cluster, the prefill form's K steps) emulated in fp32 on the CPU and
    held to `w8_linear_reference` within the kernel's bound (2^-6 of max
    |out|, `chip_smoke.py:W8_TOL`);
  * the wrappers refuse CPU tensors, and the CPU route takes the plain
    versions.

The kernels themselves are held to these plain versions on the card:
`tests/test_torch_guards.py:test_cuda_int8_kernels_match_plain_versions`
(`cuda` marker, skipped here) and `chip_smoke.py` phases 35-37 and 53.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bevgen_tpu.ops import quant as jq
from bevgen_torch.core.config import (argoverse_muse_7cam_config,
                                      nuscenes_ar_config, tiny_test_config)
from bevgen_torch.models.stage2.gpt import SparseGPT
from bevgen_torch.models.stage2.maskgit import MaskGit
from bevgen_torch.ops import quant as tq
from bevgen_torch.parallel import sharding

# the kernel's bound against its plain version (chip_smoke.py:W8_TOL): three
# bf16 roundings of the tail, each within 2^-8 of the value's size
W8_TOL = 2.0 ** -6
RAGGED = ((13, 1003, 1365), (9, 2730, 64), (5, 64, 2730))
# preset -> (its config, whether it serves MUSE, whether it serves AR)
CONFIGS = {"tiny_test": (tiny_test_config, True, True),
           "argoverse_muse_7cam": (argoverse_muse_7cam_config, True, False),
           "nuscenes_ar": (nuscenes_ar_config, False, True)}
BATCHES = (1, 2, 3, 4, 8, 16, 32)


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


def _bf16_values(a):
    """fp32 numpy values that bf16 holds exactly."""
    return torch.from_numpy(a).bfloat16().float().numpy()


@pytest.fixture(scope="module")
def dense_cases():
    """Per (rows, K, N) of RAGGED and static/dynamic: the JAX `_quant_node`
    ({kernel_q (K, N), scale, in_scale}) and bf16-exact inputs."""
    rng = np.random.default_rng(7)
    cases = {}
    for rows, K, N in RAGGED:
        w = rng.standard_normal((K, N)).astype(np.float32) / np.sqrt(K)
        gamma = 1.0 + 0.2 * rng.standard_normal(K).astype(np.float32)
        x = _bf16_values(rng.standard_normal((rows, K)).astype(np.float32)
                         * gamma * 3.0)
        for static in (False, True):
            node = jq._quant_node({"kernel": w}, gamma if static else None)
            cases[(rows, K, N, static)] = (node, x)
    return cases


def _jax_dense(node, x, static, dtype):
    """The JAX package's QuantDense and its int8_matmul on the jitted
    quantizers: two views of the reference's product."""
    params = jax.tree_util.tree_map(jnp.asarray, node)
    N = node["kernel_q"].shape[1]
    module = jq.QuantDense(N, dtype=dtype, static_input=static)
    xj = jnp.asarray(x, dtype)
    via_module = jax.jit(lambda p, a: module.apply({"params": p}, a))(params, xj)
    if static:
        xq = jax.jit(lambda a, s: jq.quantize_activations_static(a, 1.0 / s))(
            xj, params["in_scale"])
        xs = None
    else:
        xq, xs = jax.jit(jq.quantize_activations)(xj)
    via_matmul = jax.jit(lambda q, s, w, ws: jq.int8_matmul(q, s, w, ws, dtype))(
        xq, xs, params["kernel_q"], params["scale"])
    return np.asarray(via_module, np.float32), np.asarray(via_matmul, np.float32)


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("static", [False, True])
def test_fused_route_plain_version_matches_jax(dense_cases, static, out_dtype):
    """int8_dense_reference (the plain version of int8_linear and of the
    chain) against the JAX QuantDense and int8_matmul, bit for bit, on the
    weight as it is and on QuantDense's padded operand (N to a multiple of
    8, K to a multiple of 16, zeros)."""
    tdt, jdt = getattr(torch, out_dtype), getattr(jnp, out_dtype)
    for rows, K, N in RAGGED:
        node, x = dense_cases[(rows, K, N, static)]
        want_module, want_matmul = _jax_dense(node, x, static, jdt)
        np.testing.assert_array_equal(want_module, want_matmul)
        w_q = torch.from_numpy(np.ascontiguousarray(node["kernel_q"].T))
        scale = torch.from_numpy(node["scale"])
        in_scale = torch.from_numpy(node["in_scale"]) if static else None
        xt = torch.from_numpy(x).to(tdt)
        got = tq.int8_dense_reference(xt, w_q, scale, in_scale)
        assert got.dtype == tdt and got.shape == (rows, N)
        np.testing.assert_array_equal(got.float().numpy(), want_module)
        op = torch.zeros(tq.padded(N), tq.padded(K, tq.K_PAD), dtype=torch.int8)
        op[:N, :K] = w_q
        again = tq.int8_dense(xt, op, scale, in_scale)
        np.testing.assert_array_equal(again.float().numpy(), want_module)


# ---- the plans -----------------------------------------------------------------

def _flax_path(name):
    return name.replace(".", "/") + "/kernel_q"


def _split(name, K, N, tp):
    """(K, N, row_split) of a rank's part of a product: `tp_plan` on the
    flax kernel (K, N) splits N (column) or K (row), or neither."""
    axis = sharding.tp_axis(_flax_path(name), (K, N), tp) if tp > 1 else None
    if axis == 1:
        return K, N // tp, False
    if axis == 0:
        return K // tp, N, True
    return K, N, False


def _muse_products(cfg, tp):
    """(rows, N, K, dynamic, row_split) of every W8A8 product of the int8
    MaskGit at batches BATCHES."""
    tf = cfg.transformer
    with torch.device("meta"):
        model = MaskGit(tf.replace(quant="int8"), cfg.muse, dtype=torch.bfloat16)
    out = set()
    for name, m in model.named_modules():
        if not isinstance(m, tq.QuantDense):
            continue
        K, N, row = _split(name, m.in_features, m.out_features, tp)
        tokens = (tf.num_cond_tokens if "cross_attn.to_kv" in name
                  else tf.num_img_tokens)
        for b in BATCHES:
            out.add((b * tokens, N, K, m.in_scale is None, row))
    return out


def _gpt_products(cfg, tp):
    """(M, N, K, row_split) of every product of the int8 GPT: the decode
    steps (fused q/k/v, the MLP, the head at M = b <= 8), the prefill (q,
    k, v, the MLP at M = b x the condition tokens)."""
    tf = cfg.transformer
    with torch.device("meta"):
        model = SparseGPT(tf.replace(quant="int8"), dtype=torch.bfloat16)
    out = set()
    for name, m in model.named_modules():
        if not isinstance(m, tq.Int8WeightDense):
            continue
        K, N, row = _split(name, m.in_features, m.out_features, tp)
        if name.endswith("query"):      # the decode step's fused q/k/v
            for b in range(1, 9):
                out.add((b, 3 * N, K, row))
        for b in range(1, 9):
            out.add((b, N, K, row))
        if not name.endswith("head"):
            for b in (1, 2, 4, 8):
                out.add((b * tf.num_cond_tokens, N, K, row))
    return out


def _check_int8_linear_plan(rows, N, K):
    plan = tq.int8_linear_plan(rows, N, K)
    assert plan["form"] in ("resident", "streamed")
    assert plan["resident"] == (plan["k_tiles"] <= tq.I8_RESIDENT_K_TILES)
    assert plan["groups"] * plan["tiles_per_block"] >= plan["n_tiles"]
    assert (plan["groups"] - 1) * plan["tiles_per_block"] < plan["n_tiles"]
    assert plan["m_blocks"] * tq.I8_TILE >= rows
    assert plan["smem"] <= tq.SMEM_MAX
    # as few blocks per 128 rows as fill the card
    assert plan["blocks"] <= max(tq.SMS, plan["m_blocks"])
    # a resident panel is quantized once by the cluster of the groups' blocks
    if plan["resident"]:
        assert plan["cluster"] == plan["groups"] <= tq.I8_MAX_CLUSTER
    else:
        assert plan["cluster"] == 1
    return plan


def _check_w8_plan(M, N, K):
    assert K % 16 == 0, (M, N, K)
    plan = tq.w8_plan(M, N, K)
    if M <= tq.W8_DECODE_MAX_M:
        assert plan["form"] == "decode"
        s = plan["splits"]
        assert s in tq.W8_SPLITS and K % (16 * s) == 0
        assert plan["k_per_block"] * s == K
        assert plan["blocks"] == -(-N // tq.W8_DECODE_ROWS) * s
        # the fewest splits that fill the card, or as many as K allows
        smaller = [x for x in tq.W8_SPLITS if x < s]
        assert all(-(-N // 16) * x < tq.W8_FILL for x in smaller)
        # beside the kernel's 8,320 bytes of static shared memory
        assert plan["smem"] + 8320 <= tq.SMEM_MAX
    else:
        assert plan["form"] == "prefill"
        assert plan["grid"][0] * plan["bn"] >= N
        assert plan["grid"][1] * plan["bm"] >= M
        assert plan["smem"] <= tq.SMEM_MAX
    return plan


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("preset", sorted(CONFIGS))
def test_plans_cover_every_int8_shape(preset, tp):
    """Every int8 product of the preset's MUSE or AR tree, whole and at a
    tp=2 rank, has a plan its kernel takes: int8_linear for every W8A8
    product but the row-split ones under tp (the chain, whose K padding is
    a multiple of 8), w8_linear for every AR product in its decode form at
    M <= 8 and its prefill form above."""
    make, muse, ar = CONFIGS[preset]
    cfg = make()
    forms = set()
    if muse:
        products = _muse_products(cfg, tp)
        assert products
        for rows, N, K, dynamic, row in products:
            if row:
                assert tp > 1 and tq.padded(K, tq.K_PAD) % tq.PAD == 0
                continue
            forms.add(_check_int8_linear_plan(rows, N, K)["form"])
        assert "resident" in forms
    if ar:
        products = _gpt_products(cfg, tp)
        assert products
        for M, N, K, row in products:
            forms.add(_check_w8_plan(M, N, K)["form"])
        assert {"decode", "prefill"} <= forms
    if preset == "argoverse_muse_7cam":      # proj_out's K = 2730 (whole)
        assert ("streamed" in forms) == (tp == 1)


def test_plans_at_the_serving_shapes():
    """The plans of phase 35's shapes, as the kernels' notes describe them:
    one wave of blocks (112 at the MUSE b=2 rows), the A panel resident up
    to K = 1024 and shared by a cluster of the blocks of its 128 rows, the
    decode form's K split only where the columns give fewer than 128
    blocks."""
    p = tq.int8_linear_plan(3584, 5460, 1024)
    assert (p["form"], p["groups"], p["tiles_per_block"], p["blocks"],
            p["cluster"]) == ("resident", 4, 11, 112, 4)
    p = tq.int8_linear_plan(3584, 1024, 2730)
    assert (p["form"], p["k_tiles"], p["blocks"], p["cluster"]) == (
        "streamed", 22, 112, 1)
    p = tq.int8_linear_plan(13, 1365, 1003)
    assert (p["m_blocks"], p["groups"], p["tiles_per_block"], p["cluster"]) \
        == (1, 6, 2, 6)
    p = tq.int8_linear_plan(28672, 1024, 1024)     # b=16: one block a row block
    assert (p["groups"], p["tiles_per_block"], p["cluster"]) == (1, 8, 1)
    assert tq.w8_plan(2, 3072, 1024)["splits"] == 1
    assert tq.w8_plan(2, 1024, 4096)["splits"] == 2
    assert tq.w8_plan(1, 512, 1024)["splits"] == 4
    assert tq.w8_plan(2, 64, 64)["splits"] == 1
    assert tq.w8_plan(512, 4096, 1024)["warpgroups"] == 2
    assert tq.w8_plan(512, 1024, 1024)["warpgroups"] == 1
    with pytest.raises(ValueError, match="K % 16"):
        tq.w8_plan(2, 64, 40)
    with pytest.raises(ValueError, match="shared memory"):
        tq.int8_linear_plan(128, 128, 200000)


# ---- w8_linear's summation orders ---------------------------------------------

def _w8_tail(y, scale, bias):
    """The kernel's tail on fp32 sums: bf16(bf16(bf16(y) * bf16(scale)) +
    bias)."""
    y = y.bfloat16().float()
    out = (y * scale.bfloat16().float()).bfloat16().float()
    return (out + bias.float()).bfloat16()


def _emulate_decode(x, w, scale, bias, plan):
    """The decode form's order: per cluster rank r (K range of k_per_block)
    and warp v (its 16-column chunks v, v + 8, ...), fp32 sums chunk by
    chunk; the warps' sums in warp order, then the ranks' in rank order."""
    M, K = x.shape
    kc = plan["k_per_block"]
    xf, wf = x.float(), w.float()
    total = torch.zeros(M, w.shape[0])
    for r in range(plan["splits"]):
        block = torch.zeros(M, w.shape[0])
        for v in range(8):
            acc = torch.zeros(M, w.shape[0])
            for c in range(v, kc // 16, 8):
                k0 = r * kc + 16 * c
                acc = acc + xf[:, k0:k0 + 16] @ wf[:, k0:k0 + 16].T
            block = block + acc
        total = total + block
    return _w8_tail(total, scale, bias)


def _emulate_prefill(x, w, scale, bias):
    """The prefill form's order: fp32 sums in K steps of 64."""
    xf, wf = x.float(), w.float()
    acc = torch.zeros(x.shape[0], w.shape[0])
    for k0 in range(0, x.shape[1], tq.W8_PREFILL_BK):
        acc = acc + xf[:, k0:k0 + 64] @ wf[:, k0:k0 + 64].T
    return _w8_tail(acc, scale, bias)


@pytest.mark.parametrize("M,N,K", [(2, 96, 512), (1, 48, 2048), (8, 40, 256),
                                   (3, 64, 64), (40, 72, 320), (13, 50, 128)])
def test_w8_summation_orders_stay_within_the_bound(M, N, K):
    g = torch.Generator().manual_seed(M * 1000 + N + K)
    x = torch.randn(M, K, generator=g).bfloat16()
    w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    scale = torch.rand(N, generator=g) * 0.03 / K ** 0.5
    bias = (0.02 * torch.randn(N, generator=g)).bfloat16()
    plan = tq.w8_plan(M, N, K)
    if plan["form"] == "decode":
        got = _emulate_decode(x, w, scale, bias, plan)
    else:
        got = _emulate_prefill(x, w, scale, bias)
    want = tq.w8_linear_reference(x.float(), w, scale, bias.float())
    err = (got.float() - want).abs().max().item()
    assert err <= W8_TOL * want.abs().max().item()
    # and the CPU route is the plain version in x's dtype
    np.testing.assert_array_equal(
        tq.w8_linear(x, w, scale, bias).float().numpy(),
        tq.w8_linear_reference(x, w, scale, bias).float().numpy())


def test_kernel_wrappers_refuse_cpu_tensors():
    x = torch.zeros(4, 64, dtype=torch.bfloat16)
    w = torch.zeros(32, 64, dtype=torch.int8)
    s = torch.ones(32)
    with pytest.raises(ValueError, match="CUDA"):
        tq.int8_linear_cuda(x, w, s, None, torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        tq.w8_linear_cuda(x, w, s, None)
    with pytest.raises(ValueError, match="CUDA"):
        tq.int8_dense_chain(x, w, s, None)
    assert {"int8_linear", "w8_linear"} <= set(tq.launch_counts())
