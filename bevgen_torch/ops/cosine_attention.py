"""Cosine attention forward: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the TPU kernel `fused_cosine_attention_fwd_fb2`
(`bevgen_tpu/ops/pallas/fused_attention.py:737`, kernel body
`_qknorm_kernel_fb2` :445), which serves every self- and cross-attention
of the MUSE transformer. Its oracle there is `make_cosine_attention(
use_pallas=False)` = `_prologue` (:1335) + `_dense_cosine` (:1413);
`cosine_attention_reference` below is that function in PyTorch.

The function, for q (B,H,N,D), k/v (B,H,M,D), null_kv (2,H,1,D):
  softmax_j(l2n(q)*q_scale . k^_j * sm_scale + bias[:, j-1]) . v_j
with column 0 the learned null key/value (bias 0) and k^ = l2n(k)*k_scale;
`keep[b] == 0` masks every real column of sample b.

What bounds the kernel on an H100 (estimates from the shapes, checked in
`chip_smoke.py`): self-attention at B=2, N=M=1792 is about 26 GFLOP, so
about 27 us at 989 TFLOP/s bf16; cross-attention at M=256 moves about
19 MB, so about 6 us at 3.35 TB/s. The kernel's design (blocks of 128 rows
of two heads on `wgmma`, a `cp.async` ring for K, V and the shared bias
tile, the q prologue fused in, an online softmax seeded with the null
column) is described in `csrc/cosine_attention.cu`. q, k, v and out go
through their (b, h, row) strides: the head transposes of the transformer
are never copied, and `out` is a (B,H,N,D) view of a (B,N,H,D) tensor.

Training goes through `CosineAttentionFn`, the counterpart of
`make_cosine_attention`'s custom_vjp (:1358-1391): its forward is the
kernel (which then also writes the per-row logsumexp), its backward
recomputes the prologue under autograd, runs the attention backward
(`ops/attention_bwd.py`, the port of `fused_bias_attention_bwd` :198) on
the prologue's outputs and chains the result through the prologue.

`cosine_attention` dispatches: CPU tensors take the plain versions, CUDA
tensors launch the kernels or raise. There is no fallback between them.
`make_cosine_attention_nhd` is the (B, L, H, D) entry over the same
function (the reference's :1241, whose forward :1160 is row 1's kernel
read through other strides).
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch
import torch.nn.functional as F

from bevgen_torch.ops import _build
from bevgen_torch.ops.attention_bwd import attention_bwd
from bevgen_torch.ops.bias_attention import (
    bias_attention_reference, bias_rows, check_kernel_args as check_bias_args,
    kernel_strides, new_output)

SOURCE = "bevgen_torch/csrc/cosine_attention.cu"
REPLACES = "bevgen_tpu/ops/pallas/fused_attention.py:737"


def _l2n(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)


def cosine_prologue(q, k, v, null_kv, q_scale, k_scale,
                    bias: Optional[torch.Tensor] = None,
                    k_prenormed: bool = True):
    """The reference's `_prologue` (fused_attention.py:1335): (qf, kf, vc,
    biasp) with qf = l2n(q) * q_scale, the null key normed with k_scale and
    prepended to k (all of k normed too unless k_prenormed), the null value
    prepended to v, and the bias padded with a zero column 0; in q's dtype
    (vc in v's), norms in fp32, biasp fp32 or None."""
    B, H, _, D = q.shape
    dt = q.dtype
    nk = null_kv[0][None].expand(B, H, 1, D).to(dt)
    nv = null_kv[1][None].expand(B, H, 1, D).to(v.dtype)
    vc = torch.cat([nv, v], dim=2)
    qf = (_l2n(q) * q_scale.float()).to(dt)
    if k_prenormed:
        nkf = (_l2n(nk) * k_scale.float()).to(dt)
        kf = torch.cat([nkf, k.to(dt)], dim=2)
    else:
        kf = (_l2n(torch.cat([nk, k.to(dt)], dim=2)) * k_scale.float()).to(dt)
    biasp = None if bias is None else F.pad(bias.float(), (1, 0))
    return qf, kf, vc, biasp


def cosine_attention_reference(q, k, v, null_kv, q_scale, k_scale,
                               bias: Optional[torch.Tensor] = None,
                               keep: Optional[torch.Tensor] = None,
                               sm_scale: float = 8.0,
                               k_prenormed: bool = True) -> torch.Tensor:
    """Plain PyTorch cosine attention, computed in q's dtype with fp32
    norms, scores and softmax: the prologue, then plain biased attention.

    q: (B,H,N,D); k, v: (B,H,M,D) without the null column; null_kv:
    (2,H,1,D) raw; q_scale, k_scale: (D,); bias: (N,M) or None; keep: (B,)
    or None. k_prenormed: k is already l2-normalised and k_scale-d."""
    qf, kf, vc, biasp = cosine_prologue(q, k, v, null_kv, q_scale, k_scale,
                                        bias, k_prenormed)
    return bias_attention_reference(qf, kf, vc, biasp, keep, sm_scale)


def _fn():
    return _build.function("cosine_attention", "cosine_attention_fwd_bf16",
                           [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p, ctypes.c_float,
                              ctypes.c_void_p])


def check_kernel_args(q, k, v, null_kv, q_scale, k_scale,
                      bias: Optional[torch.Tensor] = None,
                      keep: Optional[torch.Tensor] = None):
    """Raise unless the kernel takes these arguments: q, k, v, bias and
    keep as `bias_attention.check_kernel_args` says (any b, h, row strides
    with a contiguous last dim); null_kv (2,H,1,D), q_scale and k_scale (D,)
    fp32 contiguous. Returns (B, H, N, M, D). A plain function: it runs on
    any device."""
    B, H, N, M, D = check_bias_args(q, k, v, bias, keep)
    dev = q.device
    _build.check("null_kv", null_kv, torch.float32, (2, H, 1, D), dev)
    _build.check("q_scale", q_scale, torch.float32, (D,), dev)
    _build.check("k_scale", k_scale, torch.float32, (D,), dev)
    return B, H, N, M, D


def cosine_attention_cuda(q, k, v, null_kv, q_scale, k_scale,
                          bias: Optional[torch.Tensor] = None,
                          keep: Optional[torch.Tensor] = None,
                          sm_scale: float = 8.0, return_lse: bool = False):
    """Launch the CUDA kernel (k prenormed). q, k, v: bf16 on one CUDA
    device, D in {32, 64}, any (b, h, row) strides with a contiguous last
    dim; null_kv, q_scale, k_scale: fp32; bias: (N, M), copied into padded
    rows when M is not a multiple of 4 (`bias_rows`); keep: int32 or None
    (`check_kernel_args`). Returns out, a (B,H,N,D) view of a (B,N,H,D)
    tensor, or (out, lse) with lse the (B,H,N) fp32 logsumexp of the scores
    (null column included) in log2 units. Raises on anything the kernel
    does not take and on a failed launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"cosine_attention_cuda takes CUDA tensors, got {dev}")
    bias = bias_rows(bias)
    B, H, N, M, D = check_kernel_args(q, k, v, null_kv, q_scale, k_scale,
                                      bias, keep)
    out = new_output(q)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=dev)
           if return_lse else None)
    p = _build.ptr
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p(q), p(k), p(v), p(null_kv), p(q_scale), p(k_scale), p(bias),
                 p(keep), p(out), p(lse), B, H, N, M, D,
                 kernel_strides(q, k, v, out, bias), float(sm_scale),
                 ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cosine_attention kernel launch failed: CUDA "
                           f"error {err} at B={B} H={H} N={N} M={M} D={D}")
    cosine_attention_cuda.launches += 1
    cosine_attention_cuda.launches_by_shape[(N, M)] += 1
    cosine_attention_cuda.launches_by_batch_shape[(B, N, M)] += 1
    cosine_attention_cuda.launches_by_heads[H] += 1
    return (out, lse) if return_lse else out


cosine_attention_cuda.launches = 0
cosine_attention_cuda.launches_by_shape = Counter()
cosine_attention_cuda.launches_by_batch_shape = Counter()
cosine_attention_cuda.launches_by_heads = Counter()


def reset_launch_counts() -> None:
    cosine_attention_cuda.launches = 0
    cosine_attention_cuda.launches_by_shape.clear()
    cosine_attention_cuda.launches_by_batch_shape.clear()
    cosine_attention_cuda.launches_by_heads.clear()


def _forward(q, k, v, null_kv, q_scale, k_scale, bias, keep, sm_scale,
             return_lse: bool = False):
    """Device dispatch of the forward, without autograd: (out, lse or None)."""
    if q.device.type == "cpu":
        return (cosine_attention_reference(q, k, v, null_kv, q_scale, k_scale,
                                           bias, keep, sm_scale), None)
    if q.device.type != "cuda":
        raise ValueError(f"no cosine attention for device {q.device}")
    if keep is not None:
        keep = (keep > 0).to(torch.int32).contiguous()
    res = cosine_attention_cuda(
        _build.rows(q), _build.rows(k), _build.rows(v),
        null_kv.float().contiguous(), q_scale.float().contiguous(),
        k_scale.float().contiguous(), bias, keep, sm_scale,
        return_lse=return_lse)
    return res if return_lse else (res, None)


class CosineAttentionFn(torch.autograd.Function):
    """Cosine attention (k prenormed) with its gradient: the counterpart of
    `make_cosine_attention`'s custom_vjp. Gradients for q, k, v, null_kv,
    q_scale, k_scale and bias; none for keep."""

    @staticmethod
    def forward(ctx, q, k, v, null_kv, q_scale, k_scale, bias, keep,
                sm_scale):
        out, lse = _forward(q, k, v, null_kv, q_scale, k_scale, bias, keep,
                            sm_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, null_kv, q_scale, k_scale, bias, keep,
                              out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, null_kv, q_scale, k_scale, bias, keep, out, lse = \
            ctx.saved_tensors
        need = ctx.needs_input_grad[:7]
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip((q, k, v, null_kv, q_scale, k_scale, bias),
                                  need)]
        with torch.enable_grad():
            prologue = cosine_prologue(*leaves, k_prenormed=True)
        qf, kf, vc, biasp = (None if t is None else t.detach() for t in prologue)
        # dq, dk, dv come back in the prologue's dtypes (the kernels write
        # bf16, as the reference rounds them); dbias stays fp32
        grads = attention_bwd(qf, kf, vc, biasp, keep, dout.to(qf.dtype),
                              ctx.sm_scale, out=out, lse=lse)
        outs = [(t, gt) for t, gt in zip(prologue, grads)
                if t is not None and t.requires_grad]
        wanted = [t for t, n in zip(leaves, need) if n]
        chained = iter(torch.autograd.grad(
            [t for t, _ in outs], wanted, [gt for _, gt in outs],
            allow_unused=True) if outs and wanted else ())
        result = [next(chained) if n else None for n in need]
        return (*result, None, None)


def cosine_attention(q, k, v, null_kv, q_scale, k_scale,
                     bias: Optional[torch.Tensor] = None,
                     keep: Optional[torch.Tensor] = None,
                     sm_scale: float = 8.0) -> torch.Tensor:
    """The attention core of the MUSE transformer, k prenormed. CPU
    tensors run the plain versions; CUDA tensors launch the kernels (or
    raise). Under autograd with an input that needs a gradient it goes
    through `CosineAttentionFn`; otherwise (serving) straight to the
    forward, with no logsumexp."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no cosine attention for device {q.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (q, k, v, null_kv, q_scale, k_scale, bias)):
        return CosineAttentionFn.apply(q, k, v, null_kv, q_scale, k_scale,
                                       bias, keep, sm_scale)
    return _forward(q, k, v, null_kv, q_scale, k_scale, bias, keep,
                    sm_scale)[0]


def make_cosine_attention_nhd(sm_scale: float = 8.0,
                              use_kernel: Optional[bool] = None):
    """`attn(q, k, v, null_kv, q_scale, k_scale, bias=None, keep=None)` in
    the (B, L, H, D) layout, the counterpart of the reference's
    `make_cosine_attention_nhd` (`fused_attention.py:1241-1307`, its kernel
    `fused_cosine_attention_fwd_nhd` :1160): q (B, N, H, D), k and v (B, M,
    H, D) with k raw (normed here, as the reference's entry norms it), the
    rest as `cosine_attention` takes them; returns (B, N, H * D).

    k is normed with k_scale into a new (B, M, H, D) tensor; q, v and that
    tensor reach `cosine_attention` as (B, H, L, D) views (`transpose(1,
    2)`), which row 1's kernel reads through their strides with no copy,
    and its (B, H, N, D) output, a view of a (B, N, H, D) tensor, comes back
    as a (B, N, H * D) view. Gradients go through `CosineAttentionFn` and
    autograd through the norm of k. `use_kernel` None takes the device's
    route: the kernels for CUDA tensors, the plain version for CPU ones;
    True or False raises where the tensors' device has no such route (the
    plain version serves the CPU only). No path of the port calls it."""

    def attn(q, k, v, null_kv, q_scale, k_scale,
             bias: Optional[torch.Tensor] = None,
             keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        on_cuda = q.device.type == "cuda"
        if use_kernel is not None and bool(use_kernel) != on_cuda:
            raise ValueError(
                f"make_cosine_attention_nhd(use_kernel={use_kernel}) on "
                f"{q.device} tensors: the kernels take CUDA tensors and the "
                f"plain version CPU ones")
        B, N, H, D = q.shape
        kf = (_l2n(k) * k_scale.float()).to(q.dtype)
        out = cosine_attention(q.transpose(1, 2), kf.transpose(1, 2),
                               v.transpose(1, 2), null_kv, q_scale, k_scale,
                               bias, keep, sm_scale)
        return out.transpose(1, 2).reshape(B, N, H * D)

    return attn
