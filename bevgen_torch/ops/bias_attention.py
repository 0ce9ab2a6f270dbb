"""Plain biased attention: the hand-written CUDA forward, its plain PyTorch
version, and the autograd function that pairs it with the backward kernels.

Replaces the TPU kernel `fused_bias_attention_fwd`
(`bevgen_tpu/ops/pallas/fused_attention.py:84`, kernel body `_kernel` :29)
and its public entry `make_fused_attention` (:285), whose backward is
`fused_bias_attention_bwd` (:198, `ops/attention_bwd.py` here):

    softmax(sm_scale q k^T + bias) v

for q (B,H,N,D), k/v (B,H,M,D) whose column 0 is the null column, bias
(N,M) fp32 shared by the batch and the heads or None, and keep (B,) or
None: `keep[b] == 0` masks every column of sample b but column 0.

The forward kernel is the plain mode of `csrc/cosine_attention.cu` (no q
prologue, no null seed); `bias_attention_reference` is the port of
`_dense_reference` (:270). `bias_attention` dispatches: CPU tensors take
the plain version forward and backward, CUDA tensors launch the kernels or
raise.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from bevgen_torch.ops import _build
from bevgen_torch.ops.attention_bwd import (NEG_INF, attention_bwd,
                                            valid_columns)

SOURCE = "bevgen_torch/csrc/cosine_attention.cu"
REPLACES = "bevgen_tpu/ops/pallas/fused_attention.py:84"


def bias_attention_reference(q, k, v, bias: Optional[torch.Tensor] = None,
                             keep: Optional[torch.Tensor] = None,
                             sm_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch biased attention in q's dtype, with fp32 scores and
    softmax; the softmax weights are rounded to v's dtype before P.V."""
    s = torch.einsum("bhid,bhjd->bhij", q.float(), k.float()) * sm_scale
    if bias is not None:
        s = s + bias.float()[None, None]
    valid = valid_columns(keep, q.shape[0], k.shape[2], s.device)
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhij,bhjd->bhid", p.float(), v.float()).to(q.dtype)


def _fn():
    return _build.function("cosine_attention", "bias_attention_fwd_bf16",
                           [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p])


def bias_attention_cuda(q, k, v, bias: Optional[torch.Tensor] = None,
                        keep: Optional[torch.Tensor] = None,
                        sm_scale: float = 1.0, return_lse: bool = False):
    """Launch the forward kernel's plain mode. q, k, v: contiguous bf16 on
    one CUDA device, D in {32, 64}, M >= 1; bias: fp32 (N, M) or None;
    keep: int32 (B,) or None. Returns out, or (out, lse) with lse the
    (B,H,N) fp32 logsumexp in log2 units. Raises on anything the kernel
    does not take and on a failed launch."""
    B, H, N, D = q.shape
    M = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"bias_attention_cuda takes CUDA tensors, got {dev}")
    if D not in (32, 64):
        raise ValueError(f"head dim {D} not supported by the kernel (32, 64)")
    _build.check("q", q, torch.bfloat16, (B, H, N, D), dev)
    _build.check("k", k, torch.bfloat16, (B, H, M, D), dev)
    _build.check("v", v, torch.bfloat16, (B, H, M, D), dev)
    if bias is not None:
        _build.check("bias", bias, torch.float32, (N, M), dev)
    if keep is not None:
        _build.check("keep", keep, torch.int32, (B,), dev)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=dev)
           if return_lse else None)
    p = _build.ptr
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p(q), p(k), p(v), p(bias), p(keep), p(out), p(lse),
                 B, H, N, M, D, float(sm_scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"bias_attention kernel launch failed: CUDA error "
                           f"{err} at B={B} H={H} N={N} M={M} D={D}")
    bias_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


bias_attention_cuda.launches = 0


def reset_launch_counts() -> None:
    bias_attention_cuda.launches = 0


def _cuda_args(q, k, v, bias, keep):
    keep = None if keep is None else (keep > 0).to(torch.int32).contiguous()
    return (q.contiguous(), k.contiguous(), v.contiguous(),
            None if bias is None else bias.float().contiguous(), keep)


class BiasAttentionFn(torch.autograd.Function):
    """The counterpart of `make_fused_attention`'s custom_vjp: the forward
    kernel (keeping its output and logsumexp) and the backward kernels on
    CUDA, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, bias, keep, sm_scale):
        lse = None
        if q.device.type == "cuda":
            out, lse = bias_attention_cuda(*_cuda_args(q, k, v, bias, keep),
                                           sm_scale=sm_scale, return_lse=True)
        else:
            out = bias_attention_reference(q, k, v, bias, keep, sm_scale)
        ctx.save_for_backward(q, k, v, bias, keep, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, keep, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = attention_bwd(q, k, v, bias, keep, dout,
                                          ctx.sm_scale, out=out, lse=lse)
        return dq, dk, dv, dbias, None, None


def bias_attention(q, k, v, bias: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None,
                   sm_scale: float = 1.0) -> torch.Tensor:
    """softmax(sm_scale q k^T + bias) v with the null column at k/v column
    0 (exempt from keep). Differentiable in q, k, v and bias. CPU tensors
    run the plain versions; CUDA tensors launch the kernels (or raise)."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no bias attention for device {q.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (q, k, v, bias)):
        return BiasAttentionFn.apply(q, k, v, bias, keep, sm_scale)
    if q.device.type == "cpu":
        return bias_attention_reference(q, k, v, bias, keep, sm_scale)
    return bias_attention_cuda(*_cuda_args(q, k, v, bias, keep),
                               sm_scale=sm_scale)
