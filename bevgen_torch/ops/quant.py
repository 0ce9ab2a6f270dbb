"""int8 serving: W8A8 for the MUSE transformer, int8 weights for the AR GPT.

Port of `bevgen_tpu/ops/quant.py`.

Host side (numpy, on the reference's parameter tree): `quantize_weight`,
`quantize_weight_static`, `quantize_dense_tree`, `quantize_gpt_tree` and
`dequantize_dense_tree` are copies of the reference's, so the port's int8
tree equals the JAX package's leaf for leaf. The scheme:

  * weights: per-output-channel symmetric int8, scale = amax / 127;
  * activations, STATIC path (`to_q`, the self-attention `to_kv`,
    `proj_in`, `proj_out`, `to_logits`, whose inputs are scale-only
    LayerNorm outputs): a per-channel scale a_k = CLIP_SIGMA |gamma_k| / 127
    from the LN gamma, folded into the weight before its int8 step, so the
    runtime quantize is one multiply and round with no reduce;
  * activations, DYNAMIC path (`to_out` and the cross-attention `to_kv`):
    per-row symmetric int8, scale = max(amax, 1e-8) / 127, computed as XLA
    compiles it (below);
  * the product in int8 with int32 accumulation, rescaled in fp32:
    acc -> f32 * w_scale (* x_scale), then the compute dtype.

Device side: `quantize_activations`, `quantize_activations_static` and
`int8_matmul` are the plain versions, in the order of operations of the
reference's jitted model: the static path multiplies by the fp32 reciprocal
1 / in_scale; the dynamic path's row scale is max(amax, 1e-8) times the fp32
constant 1/127 (XLA's algebraic simplifier turns the reference's division by
the constant 127 into that product, and the two differ in the last bit for
some rows), then it divides by the scale; both round half to even. On the
same fp32 inputs they give the jitted reference's int8 values and outputs
bit for bit. On CUDA tensors the hand-written kernels take their place:

  * `int8_linear` (`csrc/int8_gemm.cu`): the whole W8A8 product in one
    launch, the quantizer in its prologue, int8 `wgmma` with int32 sums in
    registers, the epilogue acc -> f32 * w_scale[col] (* x_scale[row]) ->
    the compute dtype in registers; its tiles and grid are
    `int8_linear_plan`'s. It equals the three-launch chain below bit for
    bit (the same fp32 operations; int32 sums are exact in any order);
  * the chain, `int8_dense_chain` (`csrc/int8.cu`): `quantize_static` /
    `quantize_dynamic` (the int8 activations, columns padded with zeros to
    a multiple of 8, and the row scales), `torch._int_mm` on the padded
    operands (K and N multiples of 8, more than 16 rows; the weight is
    padded with zero rows and columns once, `QuantDense.operand`, which
    changes no sum) and `int8_epilogue`;
  * `w8_linear` (`csrc/int8_gemm.cu`): the AR tree's weight-only product
    dtype(dtype(x @ Wq^T) * dtype(scale)) + bias
    (`bevgen_tpu/models/stage2/ar_cached.py:41-49`), the int8 weights read
    once and widened to bf16 on their way to the tensor cores; its form
    (decode, M <= 8, or prefill) and grid are `w8_plan`'s.

Under tensor parallelism (`parallel/tensor.py`) a column-split product runs
as it is on the rank's outputs (`int8_linear`). A row-split one (`to_out`,
`proj_out`; the AR tree's `mlp_proj`) holds the rank's columns of the input
and rows of the weight, and sums over tp inside the product (the `mesh`
argument):

  * W8A8: the chain, with the int32 accumulators summed over tp
    (`sum_int_over_tp`, exact) before the epilogue, once; on the static path
    the rank's part of in_scale quantizes its columns; on the dynamic path
    the row scale comes from the amax over every rank's columns, as GSPMD
    reduces the reference's `quantize_activations` over the split axis:
    `row_amax`, a max over tp (`max_over_tp`), then `quantize_scaled`. The
    output equals one process's bit for bit;
  * the AR form: the raw product dtype(x @ Wq^T) of each rank (`w8_linear`
    with no scale), its sum over tp in the compute dtype, then the tail
    `w8_tail` (times dtype(scale), plus the bias, once), in the reference's
    order.

On the TPU, XLA fuses each of these into the dot; eager PyTorch cannot.
What bounds the kernels on an H100 and their design are in `csrc/int8.cu`
and `csrc/int8_gemm.cu`. Each wrapper counts its launches; CPU tensors take
the plain versions, CUDA tensors launch the kernels or raise.

`QuantDense` is the reference's module (kernel_q stored (out, in) like a
Linear weight, scale, and in_scale on the static path); `Int8WeightDense`
holds the AR form (kernel_q, scale, bias). Both are serving-only: their
parameters take no gradient. Both take a `tp_ready` hook
(`parallel.tensor.shard_module_`).
"""
from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch
from torch import nn

from bevgen_torch.ops import _build
from bevgen_torch.parallel import tensor as tpar

SOURCE = "bevgen_torch/csrc/int8.cu"
GEMM_SOURCE = "bevgen_torch/csrc/int8_gemm.cu"
# the JAX functions the kernels stand in for (XLA fuses them into the dot on
# the TPU; none is a Pallas kernel)
QUANTIZE_STATIC_REPLACES = "bevgen_tpu/ops/quant.py:66"
QUANTIZE_DYNAMIC_REPLACES = "bevgen_tpu/ops/quant.py:57"
EPILOGUE_REPLACES = "bevgen_tpu/ops/quant.py:100"
W8_LINEAR_REPLACES = "bevgen_tpu/models/stage2/ar_cached.py:41"
INT8_LINEAR_REPLACES = "bevgen_tpu/ops/quant.py:132"

# dense-layer module names eligible for int8 (the hot products; the small
# geometry embeds, embeddings and norms stay in the compute dtype)
QUANT_LAYER_NAMES = ("to_q", "to_kv", "to_out", "proj_in", "proj_out",
                     "to_logits")
# static activation clip range in units of the LN'd per-channel signal
CLIP_SIGMA = 8.0
# the AR sparse GPT's dense layers (its attention has no output projection)
GPT_QUANT_LAYER_NAMES = ("query", "key", "value", "mlp_fc", "mlp_proj",
                         "head")
# `torch._int_mm` takes more than 16 rows, and K and N multiples of 8;
# `int8_linear` reads the weight's rows in 16-byte pieces, so the operand's
# K is padded to a multiple of 16
INT_MM_MIN_ROWS = 17
PAD = 8
K_PAD = 16


def padded(n: int, multiple: int = PAD) -> int:
    """n rounded up to a multiple of `multiple` (8 by default)."""
    return -(-n // multiple) * multiple


# ---- host side: the reference's tree conversions, in numpy -----------------

def _as_numpy(tree):
    if isinstance(tree, Mapping):
        return {k: _as_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def quantize_weight(w: np.ndarray):
    """Per-output-channel symmetric int8 for a (in, out) kernel."""
    wf = np.asarray(w, np.float32)
    amax = np.abs(wf).max(axis=0)                       # (out,)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(wf / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_weight_static(w: np.ndarray, gamma: np.ndarray,
                           clip_sigma: float = CLIP_SIGMA):
    """Static-activation weight quantization: a_k = clip_sigma |gamma_k| /
    127 folds into the kernel before the per-output-channel int8 step.
    Returns (kernel_q int8, out scale (out,), in_scale a (in,))."""
    wf = np.asarray(w, np.float32)
    a = np.maximum(np.abs(np.asarray(gamma, np.float32)), 1e-8) \
        * (clip_sigma / 127.0)                          # (in,)
    wa = wf * a[:, None]
    amax = np.abs(wa).max(axis=0)                       # (out,)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(wa / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32), a.astype(np.float32)


def _map_named_modules(params, layer_names: Sequence[str], key: str,
                       transform):
    """Every sub-dict whose module name is in `layer_names` and that holds a
    2-D `key` array, replaced by transform(subdict)."""
    def rec(node, name):
        if isinstance(node, dict):
            if (name in layer_names and key in node
                    and np.ndim(node[key]) == 2):
                return transform(node)
            return {k: rec(v, k) for k, v in node.items()}
        return node
    return rec(_as_numpy(params), "")


def _ln_gamma(node):
    """Gamma of a LayerNormG subtree ({'norm': {'scale': ...}})."""
    return np.asarray(node["norm"]["scale"], np.float32)


def _quant_node(node, gamma=None, clip_sigma: float = CLIP_SIGMA):
    out = {k: v for k, v in node.items() if k != "kernel"}
    if gamma is None:
        q, s = quantize_weight(node["kernel"])
        out.update(kernel_q=q, scale=s)
    else:
        q, s, a = quantize_weight_static(node["kernel"], gamma, clip_sigma)
        out.update(kernel_q=q, scale=s, in_scale=a)
    return out


def quantize_dense_tree(params, layer_names: Sequence[str] = QUANT_LAYER_NAMES,
                        clip_sigma: float = CLIP_SIGMA):
    """{'kernel'} -> {'kernel_q', 'scale'(, 'in_scale')} for every hot dense
    layer of a reference-format tree. The static path goes to the layers
    whose input is a scale-only LayerNorm output (in_scale from the sibling
    LN's gamma), the dynamic one to `to_out` and the cross-attention `to_kv`
    (told apart by its module name); `self_cond_to_init_embed` stays as it
    is. The runtime's choices (`models/stage2/transformer.py:make_dense`)
    agree with these."""
    def rec(node, name):
        if not isinstance(node, dict):
            return node
        if name == "self_cond_to_init_embed":
            return node
        out = {}
        is_attn = "to_q" in node and "norm" in node
        is_ff = "proj_in" in node and "norm_in" in node
        has_logits = "to_logits" in node and "final_norm" in node
        for k, v in node.items():
            if is_attn and k == "to_q":
                out[k] = _quant_node(v, _ln_gamma(node["norm"]), clip_sigma)
            elif is_attn and k == "to_kv":
                g = (None if "cross" in name
                     else _ln_gamma(node["norm"]))
                out[k] = _quant_node(v, g, clip_sigma)
            elif is_attn and k == "to_out":
                out[k] = _quant_node(v)
            elif is_ff and k == "proj_in":
                out[k] = _quant_node(v, _ln_gamma(node["norm_in"]), clip_sigma)
            elif is_ff and k == "proj_out":
                out[k] = _quant_node(v, _ln_gamma(node["norm_mid"]), clip_sigma)
            elif has_logits and k == "to_logits":
                out[k] = _quant_node(v, _ln_gamma(node["final_norm"]),
                                     clip_sigma)
            elif k in layer_names and isinstance(v, dict) and "kernel" in v \
                    and np.ndim(v["kernel"]) == 2:
                out[k] = _quant_node(v)
            else:
                out[k] = rec(v, k)
        return out
    return rec(_as_numpy(params), "")


def quantize_gpt_tree(params):
    """The AR GPT's dense kernels as int8 weights (biases kept):
    {'kernel': W, ...} -> {'kernel_q', 'scale', ...}."""
    return quantize_dense_tree(params, GPT_QUANT_LAYER_NAMES)


def dequantize_dense_tree(params, layer_names: Sequence[str] = QUANT_LAYER_NAMES):
    """The inverse structure map (lossy): kernel_q * scale (/ in_scale) ->
    an fp32 kernel."""
    def dequant(node):
        k = (node["kernel_q"].astype(np.float32) *
             node["scale"].astype(np.float32))
        if "in_scale" in node:
            k = k / node["in_scale"].astype(np.float32)[:, None]
        out = {k2: v for k2, v in node.items()
               if k2 not in ("kernel_q", "scale", "in_scale")}
        out["kernel"] = k
        return out
    return _map_named_modules(params, layer_names, "kernel_q", dequant)


# ---- device side: the plain versions ----------------------------------------

# the fp32 constant XLA multiplies by where the reference divides by 127
INV_127 = float(np.float32(1.0) / np.float32(127.0))


def row_amax(x: torch.Tensor) -> torch.Tensor:
    """max |x| per row, fp32 (..., 1)."""
    return x.float().abs().amax(dim=-1, keepdim=True)


def row_scale(amax: torch.Tensor) -> torch.Tensor:
    """The dynamic row scale from the row's amax: max(amax, 1e-8) *
    fp32(1/127), as the jitted reference computes it."""
    return amax.clamp_min(1e-8) * INV_127


def quantize_with_scale(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """clip(round(x / scale), +-127) as int8, scale fp32 (..., 1)."""
    return torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)


def quantize_activations(x: torch.Tensor):
    """Per-row symmetric int8: (x_q int8, scale fp32 (..., 1))."""
    scale = row_scale(row_amax(x))
    return quantize_with_scale(x, scale), scale


def quantize_activations_static(x: torch.Tensor,
                                inv_in: torch.Tensor) -> torch.Tensor:
    """Per-channel static int8, one multiply and round: inv_in = 1 /
    in_scale, (in,) fp32."""
    q = torch.clamp(torch.round(x.float() * inv_in), -127, 127)
    return q.to(torch.int8)


def int8_product(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 @ (N, K)^T int8 -> int32 (..., N), exact: the products
    and their sums are integers far below 2^53, so fp64 holds them in any
    order."""
    return (x_q.double() @ w_q.double().T).to(torch.int32)


def int8_epilogue_reference(acc: torch.Tensor, w_scale: torch.Tensor,
                            x_scale: Optional[torch.Tensor],
                            out_dtype: torch.dtype) -> torch.Tensor:
    """acc -> f32 * w_scale (* x_scale), then out_dtype."""
    out = acc.float() * w_scale
    if x_scale is not None:
        out = out * x_scale
    return out.to(out_dtype)


def int8_matmul(x_q, x_scale, w_q, w_scale, out_dtype):
    """(rows, K) int8 @ w_q^T (w_q (N, K) int8) -> int32, rescaled to
    out_dtype. x_scale None: the static path, whose activation scale lives
    in w_scale."""
    return int8_epilogue_reference(int8_product(x_q, w_q), w_scale, x_scale,
                                   out_dtype)


def int8_dense_reference(x: torch.Tensor, w_q: torch.Tensor,
                         scale: torch.Tensor,
                         in_scale: Optional[torch.Tensor],
                         mesh=None) -> torch.Tensor:
    """`QuantDense`'s product in plain PyTorch, in x's dtype: w_q (N, K) or
    its padded operand (the padding is cut off). With a tensor-parallel
    `mesh` the product is row-split: x holds the rank's columns, w_q and
    in_scale their rows; the row amax is taken over tp and the int32
    products summed over tp before the epilogue."""
    N, K = scale.numel(), x.shape[-1]
    w_q = w_q[:N, :K]
    if in_scale is not None:
        x_q, x_s = quantize_activations_static(x, 1.0 / in_scale), None
    else:
        x_s = row_scale(tpar.max_over_tp(row_amax(x), mesh))
        x_q = quantize_with_scale(x, x_s)
    acc = tpar.sum_int_over_tp(int8_product(x_q, w_q), mesh)
    return int8_epilogue_reference(acc, scale, x_s, x.dtype)


def w8_tail_reference(y: torch.Tensor, scale: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
    """The AR product's tail in y's dtype: y * dtype(scale) (+ dtype(bias))."""
    dt = y.dtype
    out = y * scale.to(dt)
    if bias is not None:
        out = out + bias.to(dt)
    return out


def w8_linear_reference(x: torch.Tensor, w_q: torch.Tensor,
                        scale: torch.Tensor,
                        bias: Optional[torch.Tensor],
                        mesh=None) -> torch.Tensor:
    """The AR tree's product in x's dtype: dtype(x @ w_q^T) * dtype(scale)
    (+ dtype(bias)), with w_q (N, K) int8. With a tensor-parallel `mesh`
    the product is row-split: dtype(x @ w_q^T) is summed over tp before the
    tail."""
    y = x @ w_q.to(x.dtype).T
    if tpar.active(mesh):
        y = tpar.reduce_from_tp(y, mesh)
    return w8_tail_reference(y, scale, bias)


# ---- the kernels' plans (pure Python: the CPU tests check them) ---------------

SMS = 132                   # the H100 SXM's streaming multiprocessors
SMEM_MAX = 232448           # shared memory one block can take, bytes
# w8_linear's decode form: 16 weight rows a block, K split over a cluster of
# up to 8 blocks while the columns give fewer than W8_FILL blocks
W8_DECODE_MAX_M = 8
W8_DECODE_ROWS = 16
W8_FILL = 128
W8_SPLITS = (1, 2, 4, 8)
W8_MIN_SPLIT_K = 128
# its prefill form: 64 rows of x a warpgroup, 64 columns, K steps of 64, a
# ring of 6 stages
W8_PREFILL_BN = 64
W8_PREFILL_BK = 64
W8_PREFILL_STAGES = 6
# int8_linear: 128 x 128 output tiles, K steps of 128, a ring of 5 Wq
# stages; the A panel resident up to 8 k-tiles, else 3 streamed slots
I8_TILE = 128
I8_B_STAGES = 5
I8_A_SLOTS = 3
I8_RESIDENT_K_TILES = 8
# the blocks that share 128 rows and quantize their resident panel together
# (one thread block cluster, the portable maximum)
I8_MAX_CLUSTER = 8


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _w8_row_strides(kc: int):
    """The decode form's staged row strides in bytes for a K range of kc
    (csrc/int8_gemm.cu:dec::w_ld, x_ld): the panel's a multiple of 16 with
    an odd quotient, x's a multiple of 32 with an odd quotient."""
    wld = kc + (16 if (kc // 16) % 2 == 0 else 32)
    xld = 2 * kc + (32 if (2 * kc // 32) % 2 == 0 else 64)
    return wld, xld


@functools.lru_cache(maxsize=None)
def w8_plan(M: int, N: int, K: int) -> dict:
    """How `w8_linear` runs an (M, K) x (N, K)^T product: the decode form
    for M <= 8 (16 weight rows a block, K split over a cluster of
    `splits` blocks, the fewest that give W8_FILL blocks), else the prefill
    form (64 columns a block, `warpgroups` x 64 rows of x, two warpgroups
    where one wave of single ones would fill the card). K must be a
    multiple of 16."""
    if min(M, N, K) <= 0 or K % 16:
        raise ValueError(f"w8_linear takes M, N, K > 0 and K % 16 == 0, got "
                         f"{(M, N, K)}")
    if M <= W8_DECODE_MAX_M:
        cols = _cdiv(N, W8_DECODE_ROWS)
        splits = 1
        for s in W8_SPLITS[1:]:
            if (cols * splits >= W8_FILL or K % (16 * s)
                    or K // s < W8_MIN_SPLIT_K):
                break
            splits = s
        kc = K // splits
        wld, xld = _w8_row_strides(kc)
        return {"form": "decode", "param": splits, "splits": splits,
                "rows_per_block": W8_DECODE_ROWS, "k_per_block": kc,
                "grid": (cols * splits,), "blocks": cols * splits,
                "smem": W8_DECODE_ROWS * wld + M * xld}
    wgs = 2 if _cdiv(M, 128) * _cdiv(N, W8_PREFILL_BN) >= SMS else 1
    grid = (_cdiv(N, W8_PREFILL_BN), _cdiv(M, 64 * wgs))
    stage = wgs * 64 * 128 + W8_PREFILL_BN * W8_PREFILL_BK
    return {"form": "prefill", "param": wgs, "warpgroups": wgs,
            "bm": 64 * wgs, "bn": W8_PREFILL_BN, "bk": W8_PREFILL_BK,
            "k_steps": _cdiv(K, W8_PREFILL_BK), "grid": grid,
            "blocks": grid[0] * grid[1],
            "smem": 1024 + W8_PREFILL_STAGES * stage + 2 * 64 * 128}


@functools.lru_cache(maxsize=None)
def int8_linear_plan(rows: int, N: int, K: int) -> dict:
    """How `int8_linear` runs a (rows, K) x (N, K)^T W8A8 product: 128 x
    128 output tiles; each block takes 128 rows and `tiles_per_block`
    consecutive column tiles, `groups` blocks per 128 rows, as many as
    fill the card's SMS with one block each. The quantized A panel stays in
    shared memory (`resident`) where its k-tiles fit, quantized once by the
    `cluster` of the groups' blocks (at most 8) and shared between them;
    else it streams, each block quantizing it again for each tile."""
    if min(rows, N, K) <= 0:
        raise ValueError(f"int8_linear takes rows, N, K > 0, got {(rows, N, K)}")
    k_tiles = _cdiv(K, I8_TILE)
    resident = k_tiles <= I8_RESIDENT_K_TILES
    m_blocks, n_tiles = _cdiv(rows, I8_TILE), _cdiv(N, I8_TILE)
    if m_blocks > 65535:
        raise ValueError(f"int8_linear takes at most {65535 * I8_TILE} rows")
    groups = max(1, min(n_tiles, SMS // m_blocks,
                        I8_MAX_CLUSTER if resident else n_tiles))
    per_block = _cdiv(n_tiles, groups)
    groups = _cdiv(n_tiles, per_block)
    smem = (1024 + (k_tiles if resident else I8_A_SLOTS) * I8_TILE * I8_TILE
            + I8_B_STAGES * I8_TILE * I8_TILE
            + 4 * max(k_tiles * I8_TILE, 2 * I8_TILE))
    if smem > SMEM_MAX:
        raise ValueError(f"int8_linear at K = {K} needs {smem} bytes of "
                         f"shared memory, above {SMEM_MAX}")
    return {"form": "resident" if resident else "streamed",
            "resident": resident, "cluster": groups if resident else 1,
            "bm": I8_TILE, "bn": I8_TILE, "bk": I8_TILE,
            "k_tiles": k_tiles, "m_blocks": m_blocks, "n_tiles": n_tiles,
            "groups": groups, "tiles_per_block": per_block,
            "grid": (groups, m_blocks), "blocks": groups * m_blocks,
            "smem": smem}


# ---- device side: the kernels -----------------------------------------------

_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_PTR = ctypes.c_void_p


def _launch(symbol: str, argtypes, dev, *args, lib: str = "int8") -> None:
    fn = _build.function(lib, symbol, list(argtypes) + [_PTR])
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {err}")


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {x.device}")


def quantize_static_cuda(x: torch.Tensor, in_scale: torch.Tensor,
                         k_pad: int) -> torch.Tensor:
    """Launch `quantize_static`: x (rows, K) contiguous bf16, in_scale (K,)
    fp32 -> int8 (max(rows, 17), k_pad) with
    clip(round(x * (1 / in_scale)), +-127) in columns < K and zeros up to
    k_pad (a multiple of 8 >= K); the rows past `rows` are left unset (they
    only feed output rows that `int8_epilogue` drops)."""
    _check_cuda(x, "quantize_static_cuda")
    rows, K = x.shape
    dev = x.device
    _build.check("x", x, torch.bfloat16, (rows, K), dev, align=2)
    _build.check("in_scale", in_scale, torch.float32, (K,), dev, align=4)
    if k_pad % PAD or k_pad < K:
        raise ValueError(f"k_pad {k_pad} must be a multiple of 8 >= K = {K}")
    q = torch.empty(max(rows, INT_MM_MIN_ROWS), k_pad, dtype=torch.int8,
                    device=dev)
    if rows:
        _launch("quantize_static", [_PTR, _PTR, _PTR, _I64, _INT, _INT],
                dev, x.data_ptr(), in_scale.data_ptr(), q.data_ptr(), rows, K,
                k_pad)
    quantize_static_cuda.launches += 1
    quantize_static_cuda.launches_by_shape[(rows, K)] += 1
    return q


def quantize_dynamic_cuda(x: torch.Tensor, k_pad: int):
    """Launch `quantize_dynamic`: x (rows, K) contiguous bf16 ->
    (int8 (max(rows, 17), k_pad), scale fp32 (rows,)): per row scale =
    max(amax, 1e-8) / 127 and clip(round(x / scale), +-127), zeros in the
    padding columns; rows past `rows` unset, as in `quantize_static_cuda`."""
    _check_cuda(x, "quantize_dynamic_cuda")
    rows, K = x.shape
    dev = x.device
    _build.check("x", x, torch.bfloat16, (rows, K), dev, align=2)
    if k_pad % PAD or k_pad < K:
        raise ValueError(f"k_pad {k_pad} must be a multiple of 8 >= K = {K}")
    q = torch.empty(max(rows, INT_MM_MIN_ROWS), k_pad, dtype=torch.int8,
                    device=dev)
    scale = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        _launch("quantize_dynamic", [_PTR, _PTR, _PTR, _I64, _INT, _INT],
                dev, x.data_ptr(), q.data_ptr(), scale.data_ptr(), rows, K,
                k_pad)
    quantize_dynamic_cuda.launches += 1
    quantize_dynamic_cuda.launches_by_shape[(rows, K)] += 1
    return q, scale


def _rows_amax_check(x: torch.Tensor, what: str):
    _check_cuda(x, what)
    rows, K = x.shape
    _build.check("x", x, torch.bfloat16, (rows, K), x.device, align=2)
    return rows, K


def row_amax_cuda(x: torch.Tensor) -> torch.Tensor:
    """Launch `row_amax`: x (rows, K) contiguous bf16 -> fp32 (rows,), max
    |x| per row (a row-split dynamic product's first half under tp)."""
    rows, K = _rows_amax_check(x, "row_amax_cuda")
    amax = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows:
        _launch("row_amax", [_PTR, _PTR, _I64, _INT], x.device, x.data_ptr(),
                amax.data_ptr(), rows, K)
    row_amax_cuda.launches += 1
    row_amax_cuda.launches_by_shape[(rows, K)] += 1
    return amax


def quantize_scaled_cuda(x: torch.Tensor, amax: torch.Tensor, k_pad: int):
    """Launch `quantize_scaled`: x (rows, K) contiguous bf16, amax (rows,)
    fp32 (the max over tp) -> (int8 (max(rows, 17), k_pad), scale fp32
    (rows,)), scale = max(amax, 1e-8) * fp32(1/127): `quantize_dynamic_cuda`
    with the amax given; rows past `rows` unset."""
    rows, K = _rows_amax_check(x, "quantize_scaled_cuda")
    dev = x.device
    _build.check("amax", amax, torch.float32, (rows,), dev, align=4)
    if k_pad % PAD or k_pad < K:
        raise ValueError(f"k_pad {k_pad} must be a multiple of 8 >= K = {K}")
    q = torch.empty(max(rows, INT_MM_MIN_ROWS), k_pad, dtype=torch.int8,
                    device=dev)
    scale = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows:
        _launch("quantize_scaled", [_PTR, _PTR, _PTR, _PTR, _I64, _INT, _INT],
                dev, x.data_ptr(), amax.data_ptr(), q.data_ptr(),
                scale.data_ptr(), rows, K, k_pad)
    quantize_scaled_cuda.launches += 1
    quantize_scaled_cuda.launches_by_shape[(rows, K)] += 1
    return q, scale


def int8_epilogue_cuda(acc: torch.Tensor, w_scale: torch.Tensor,
                       x_scale: Optional[torch.Tensor], rows: int,
                       out_dtype: torch.dtype) -> torch.Tensor:
    """Launch `int8_epilogue`: acc (>= rows, Np) contiguous int32, w_scale
    (N,) fp32 with N <= Np, x_scale (rows,) fp32 or None -> (rows, N) in
    out_dtype (bf16 or fp32): f32(acc) * w_scale[col] (* x_scale[row]),
    rounded once."""
    _check_cuda(acc, "int8_epilogue_cuda")
    dev = acc.device
    Np = acc.shape[1]
    N = w_scale.numel()
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: bfloat16 or float32")
    if acc.dtype != torch.int32 or not acc.is_contiguous() or acc.shape[0] < rows:
        raise ValueError(f"acc must be contiguous int32 with >= {rows} rows, "
                         f"got {acc.dtype} {tuple(acc.shape)}")
    if N > Np or Np % PAD:
        raise ValueError(f"acc's {Np} columns must be a multiple of 8 >= N = {N}")
    _build.check("w_scale", w_scale, torch.float32, (N,), dev, align=4)
    if x_scale is not None:
        _build.check("x_scale", x_scale, torch.float32, (rows,), dev, align=4)
    out = torch.empty(rows, N, dtype=out_dtype, device=dev)
    if rows:
        _launch("int8_epilogue",
                [_PTR, _PTR, _PTR, _PTR, _I64, _INT, _INT, _INT], dev,
                acc.data_ptr(), w_scale.data_ptr(),
                None if x_scale is None else x_scale.data_ptr(),
                out.data_ptr(), rows, N, Np, int(out_dtype == torch.float32))
    int8_epilogue_cuda.launches += 1
    int8_epilogue_cuda.launches_by_shape[(rows, N, x_scale is not None)] += 1
    return out


def _aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous at a 16-byte aligned address (a copy where needed)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def w8_linear_cuda(x: torch.Tensor, w_q: torch.Tensor,
                   scale: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch `w8_linear` (`csrc/int8_gemm.cu`) in `w8_plan`'s form: x (M,
    K) contiguous bf16, w_q (N, K) contiguous int8, both 16-byte aligned, K
    a multiple of 16, scale (N,) fp32, bias (N,) bf16 or None -> (M, N)
    bf16, `w8_linear_reference`'s function. scale None (and bias None): the
    raw product bf16(x @ w_q^T), a row-split rank's part before the sum
    over tp (counted in `raw_launches` as well)."""
    _check_cuda(x, "w8_linear_cuda")
    M, K = x.shape
    N = w_q.shape[0]
    dev = x.device
    _build.check("x", x, torch.bfloat16, (M, K), dev)
    _build.check("w_q", w_q, torch.int8, (N, K), dev)
    if scale is not None:
        _build.check("scale", scale, torch.float32, (N,), dev, align=4)
    elif bias is not None:
        raise ValueError("the raw product (no scale) takes no bias")
    if bias is not None:
        _build.check("bias", bias, torch.bfloat16, (N,), dev, align=2)
    out = torch.empty(M, N, dtype=x.dtype, device=dev)
    if M:
        plan = w8_plan(M, N, K)
        _launch("w8_linear",
                [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _INT, _INT, _INT, _INT],
                dev, x.data_ptr(), w_q.data_ptr(),
                None if scale is None else scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(),
                M, N, K, 0 if plan["form"] == "decode" else 1, plan["param"],
                lib="int8_gemm")
        w8_linear_cuda.launches_by_form[plan["form"]] += 1
    w8_linear_cuda.launches += 1
    w8_linear_cuda.launches_by_shape[(M, N, K)] += 1
    w8_linear_cuda.raw_launches += scale is None
    return out


def int8_linear_cuda(x: torch.Tensor, w_q: torch.Tensor,
                     scale: torch.Tensor, in_scale: Optional[torch.Tensor],
                     out_dtype: torch.dtype) -> torch.Tensor:
    """Launch `int8_linear` (`csrc/int8_gemm.cu`) with `int8_linear_plan`'s
    tiles: x (rows, K) contiguous bf16; w_q the (>= N, ldw) contiguous int8
    operand, 16-byte aligned, ldw a multiple of 16 >= K (`QuantDense.
    operand`; columns past K are not read); scale (N,) fp32; in_scale (K,)
    fp32 (static) or None (dynamic) -> (rows, N) in out_dtype (bf16 or
    fp32): `int8_dense_reference`'s function in one launch, equal to the
    chain's output bit for bit."""
    _check_cuda(x, "int8_linear_cuda")
    rows, K = x.shape
    N = scale.numel()
    dev = x.device
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"out_dtype {out_dtype}: bfloat16 or float32")
    _build.check("x", x, torch.bfloat16, (rows, K), dev, align=2)
    ldw = w_q.shape[1]
    if (w_q.dtype != torch.int8 or w_q.dim() != 2 or w_q.shape[0] < N
            or ldw < K or ldw % K_PAD):
        raise ValueError(f"w_q must be int8 (>= {N}, a multiple of 16 >= "
                         f"{K}), got {w_q.dtype} {tuple(w_q.shape)}")
    _build.check("w_q", w_q, torch.int8, tuple(w_q.shape), dev)
    _build.check("scale", scale, torch.float32, (N,), dev, align=4)
    if in_scale is not None:
        _build.check("in_scale", in_scale, torch.float32, (K,), dev, align=4)
    out = torch.empty(rows, N, dtype=out_dtype, device=dev)
    if rows:
        plan = int8_linear_plan(rows, N, K)
        _launch("int8_linear",
                [_PTR, _PTR, _PTR, _PTR, _PTR, _I64, _INT, _INT, _INT, _INT,
                 _INT, _INT, _INT, _INT], dev,
                x.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                None if in_scale is None else in_scale.data_ptr(),
                out.data_ptr(), rows, N, K, ldw,
                int(out_dtype == torch.float32), plan["groups"],
                plan["tiles_per_block"], int(plan["resident"]),
                plan["cluster"], lib="int8_gemm")
    int8_linear_cuda.launches += 1
    int8_linear_cuda.launches_by_shape[(rows, N, K, in_scale is None)] += 1
    return out


def w8_tail_cuda(y: torch.Tensor, scale: torch.Tensor,
                 bias: Optional[torch.Tensor]) -> torch.Tensor:
    """Launch `w8_tail`: y (M, N) contiguous bf16 (the raw product summed
    over tp), scale (N,) fp32, bias (N,) bf16 or None -> (M, N) bf16,
    `w8_tail_reference`'s function."""
    _check_cuda(y, "w8_tail_cuda")
    M, N = y.shape
    dev = y.device
    _build.check("y", y, torch.bfloat16, (M, N), dev, align=2)
    _build.check("scale", scale, torch.float32, (N,), dev, align=4)
    if bias is not None:
        _build.check("bias", bias, torch.bfloat16, (N,), dev, align=2)
    out = torch.empty_like(y)
    if M:
        _launch("w8_tail", [_PTR, _PTR, _PTR, _PTR, _I64, _INT], dev,
                y.data_ptr(), scale.data_ptr(),
                None if bias is None else bias.data_ptr(), out.data_ptr(), M,
                N)
    w8_tail_cuda.launches += 1
    w8_tail_cuda.launches_by_shape[(M, N)] += 1
    return out


KERNELS = (quantize_static_cuda, quantize_dynamic_cuda, int8_epilogue_cuda,
           w8_linear_cuda, row_amax_cuda, quantize_scaled_cuda, w8_tail_cuda,
           int8_linear_cuda)


def reset_launch_counts() -> None:
    """Zero each wrapper's `launches` and its `launches_by_shape`: (rows, K)
    for the quantizers and row_amax, (rows, N, dynamic) for the epilogue,
    (M, N, K) for w8_linear (and its `raw_launches` and `launches_by_form`,
    decode or prefill), (M, N) for w8_tail, (rows, N, K, dynamic) for
    int8_linear."""
    for k in KERNELS:
        k.launches = 0
        k.launches_by_shape = Counter()
    w8_linear_cuda.raw_launches = 0
    w8_linear_cuda.launches_by_form = Counter()


reset_launch_counts()


def launch_counts() -> dict:
    return {k.__name__[:-len("_cuda")]: k.launches for k in KERNELS}


# ---- the dispatching entries ------------------------------------------------

def int8_dense(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
               in_scale: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """`QuantDense`'s product in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch `int8_linear` with w_q the padded (Np, Kp)
    operand (`QuantDense.operand`), or, with a tensor-parallel `mesh` (a
    row-split product, `int8_dense_reference`'s), the chain with its sums
    over tp (`int8_dense_chain`)."""
    if x.device.type == "cpu":
        return int8_dense_reference(x, w_q, scale, in_scale, mesh)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 product for device {x.device}")
    if tpar.active(mesh):
        return int8_dense_chain(x, w_q, scale, in_scale, mesh)
    lead, K = x.shape[:-1], x.shape[-1]
    out = int8_linear_cuda(x.reshape(-1, K).contiguous(), w_q, scale,
                           in_scale, x.dtype)
    return out.reshape(*lead, scale.numel())


def int8_dense_chain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                     in_scale: Optional[torch.Tensor],
                     mesh=None) -> torch.Tensor:
    """`QuantDense`'s product on CUDA tensors in three launches and a
    library call: quantize_static (in_scale given) or quantize_dynamic,
    `torch._int_mm` and int8_epilogue, with w_q the padded (Np, Kp)
    operand. With a tensor-parallel `mesh` (a row-split product) the
    dynamic path launches row_amax and quantize_scaled around a max over
    tp, and the int32 accumulators are summed over tp before the epilogue.
    The route of the row-split products, and the card's comparison route
    for `int8_linear`."""
    _check_cuda(x, "int8_dense_chain")
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    rows, k_pad = x2.shape[0], w_q.shape[1]
    split = tpar.active(mesh)
    if in_scale is not None:
        x_q, x_s = quantize_static_cuda(x2, in_scale, k_pad), None
    elif split:
        amax = tpar.max_over_tp(row_amax_cuda(x2), mesh)
        x_q, x_s = quantize_scaled_cuda(x2, amax, k_pad)
    else:
        x_q, x_s = quantize_dynamic_cuda(x2, k_pad)
    acc = torch._int_mm(x_q, w_q.t())
    if split:   # the rows past `rows` are unset: they stay out of the sum
        tpar.sum_int_over_tp(acc[:rows], mesh)
    out = int8_epilogue_cuda(acc, scale, x_s, rows, x.dtype)
    return out.reshape(*lead, scale.numel())


def w8_linear(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
              bias: Optional[torch.Tensor], mesh=None) -> torch.Tensor:
    """The AR tree's product in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch the `w8_linear` kernel, or with a
    tensor-parallel `mesh` (row-split) its raw form, a bf16 sum over tp and
    `w8_tail`."""
    if x.device.type == "cpu":
        return w8_linear_reference(x, w_q, scale, bias, mesh)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 product for device {x.device}")
    lead, K = x.shape[:-1], x.shape[-1]
    x2, w_q = _aligned_rows(x.reshape(-1, K)), _aligned_rows(w_q)
    b = None if bias is None else bias.to(x.dtype).contiguous()
    if tpar.active(mesh):
        y = tpar.reduce_from_tp(w8_linear_cuda(x2, w_q, None, None), mesh)
        out = w8_tail_cuda(y.contiguous(), scale.contiguous(), b)
    else:
        out = w8_linear_cuda(x2, w_q, scale.contiguous(), b)
    return out.reshape(*lead, w_q.shape[0])


# ---- the modules ------------------------------------------------------------

def _int8_param(out_features: int, in_features: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(out_features, in_features,
                                    dtype=torch.int8), requires_grad=False)


class QuantDense(nn.Module):
    """The reference's `QuantDense`: a W8A8 Linear without bias, serving
    only. kernel_q (out, in) int8, scale (out,) fp32 and, with
    `static_input`, in_scale (in,) fp32; made from a trained kernel by
    `quantize_dense_tree`. The output is in the compute `dtype`.

    `route` is the product (`int8_dense` by default; `int8_dense_reference`
    for the plain version on any device).

    Tensor-parallel (`tp_ready` after `tensor.shard_module_` cut it): a
    column-split product runs as it is on the rank's outputs (its kernel_q
    rows and scale are the rank's); a row-split one takes its part of
    in_scale at use and sums over tp inside the product (`int8_dense`'s
    `mesh`)."""

    def __init__(self, in_features: int, out_features: int, dtype,
                 static_input: bool = False):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = dtype
        self.kernel_q = _int8_param(out_features, in_features)
        self.scale = nn.Parameter(torch.zeros(out_features),
                                  requires_grad=False)
        self.in_scale = (nn.Parameter(torch.zeros(in_features),
                                      requires_grad=False)
                         if static_input else None)
        self.route: Callable = int8_dense
        self._operand = None
        self.mesh = None    # set for a row-split product

    def tp_ready(self, mesh) -> None:
        if tpar.split_axis(self) == 1:
            self.mesh = mesh

    def operand(self) -> torch.Tensor:
        """kernel_q itself on the CPU; on the card the (Np, Kp) operand of
        `int8_linear` and `torch._int_mm`, N padded with zeros to a multiple
        of 8 and K to a multiple of 16. Where it is padded, kernel_q becomes
        a view into it (so a load into kernel_q writes the operand too, and
        no second copy is kept); it is made again once kernel_q has moved or
        been replaced."""
        w = self.kernel_q
        N, K = w.shape
        if w.device.type == "cpu" or (N % PAD == 0 and K % K_PAD == 0):
            return w
        op = self._operand
        if (op is None or op.device != w.device or
                op.untyped_storage().data_ptr() != w.untyped_storage().data_ptr()):
            # a normal tensor even under inference_mode, so that a later
            # load into kernel_q may write it
            with torch.inference_mode(False), torch.no_grad():
                op = torch.zeros(padded(N), padded(K, K_PAD),
                                 dtype=torch.int8, device=w.device)
                op[:N, :K] = w.data
                w.data = op[:N, :K]
            self._operand = op
        return op

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_scale, mesh = self.in_scale, self.mesh
        if mesh is not None and in_scale is not None:
            in_scale = tpar.take_part(in_scale, 0, 1, mesh.tp, mesh.tp_rank)
        return self.route(x.to(self.compute_dtype), self.operand(), self.scale,
                          in_scale, mesh)


class Int8WeightDense(nn.Module):
    """The AR tree's int8-weight Linear (`quantize_gpt_tree`): kernel_q
    (out, in) int8, scale (out,) fp32 and an optional bias stored in
    `param_dtype`; the product runs in the compute `dtype`
    (`w8_linear`). `route` as in `QuantDense`.

    Tensor-parallel: a column-split product takes its part of the whole
    bias (`local_bias`, as `Dense`'s); a row-split one sums the raw
    products over tp before the scale and the bias (`w8_linear`'s
    `mesh`)."""

    def __init__(self, in_features: int, out_features: int, bias: bool,
                 dtype, param_dtype=None):
        super().__init__()
        self.in_features, self.out_features = in_features, out_features
        self.compute_dtype = dtype
        self.kernel_q = _int8_param(out_features, in_features)
        self.scale = nn.Parameter(torch.zeros(out_features),
                                  requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(out_features,
                                              dtype=param_dtype or dtype),
                                  requires_grad=False) if bias else None)
        self.route: Callable = w8_linear
        self.mesh = None        # set for a split product
        self.row_split = False

    def tp_ready(self, mesh) -> None:
        axis = tpar.split_axis(self)
        if axis is not None:
            self.mesh, self.row_split = mesh, axis == 1

    def local_bias(self) -> Optional[torch.Tensor]:
        """The bias of this rank's outputs (the whole bias unless the
        output axis is cut), in the compute dtype."""
        b = self.bias
        if b is None:
            return None
        if self.mesh is not None and not self.row_split:
            b = tpar.take_part(b, 0, self._tp_split["kernel_q"][1],
                               self.mesh.tp, self.mesh.tp_rank)
        return b.to(self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mesh is None:
            return self.route(x.to(self.compute_dtype), self.kernel_q,
                              self.scale, self.bias)
        return self.route(x.to(self.compute_dtype), self.kernel_q, self.scale,
                          self.local_bias(),
                          self.mesh if self.row_split else None)


QUANT_MODULES = (QuantDense, Int8WeightDense)


def init_quant_param(owner: nn.Module, leaf: str, shape, gen) -> torch.Tensor:
    """A seeded fresh value of a quantized module's parameter, as the
    reference's `QuantDense` init draws it: a random int8 kernel, the
    lecun-normal-matched scale sqrt(1 / in) / 73 and in_scale CLIP_SIGMA /
    127, so an unconverted model still computes (random) values; a zero
    bias."""
    if leaf == "kernel_q":
        return torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    if leaf == "scale":
        return torch.full(shape, math.sqrt(1.0 / owner.in_features) / 73.0)
    if leaf == "in_scale":
        return torch.full(shape, CLIP_SIGMA / 127.0)
    return torch.zeros(shape)


def weight_bytes(module: nn.Module) -> int:
    """Bytes of `module`'s parameters (the int8 kernels at one byte)."""
    return sum(p.numel() * p.element_size() for p in module.parameters())

