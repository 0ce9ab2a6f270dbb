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
                                            bias_rows, valid_columns)

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
                           + [ctypes.c_void_p, ctypes.c_float,
                              ctypes.c_void_p])


def check_kernel_args(q, k, v, bias: Optional[torch.Tensor] = None,
                      keep: Optional[torch.Tensor] = None):
    """Raise unless the forward kernel takes these arguments: q (B,H,N,D),
    k and v (B,H,M,D) bf16 on one device with D in {32, 64}, each with a
    contiguous last dim and 16-byte rows (any b, h, row strides); bias fp32
    (N, M) with a contiguous last dim and 16-byte rows (`bias_rows`) or
    None; keep int32 (B,) or None. Returns (B, H, N, M, D). A plain
    function: it runs on any device."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k must be (B, H, rows, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, H, N, D = q.shape
    M = k.shape[2]
    dev = q.device
    if D not in (32, 64):
        raise ValueError(f"head dim {D} not supported by the kernel (32, 64)")
    _build.check_rows("q", q, torch.bfloat16, (B, H, N, D), dev)
    _build.check_rows("k", k, torch.bfloat16, (B, H, M, D), dev)
    _build.check_rows("v", v, torch.bfloat16, (B, H, M, D), dev)
    if bias is not None:
        _build.check_rows("bias", bias, torch.float32, (N, M), dev)
    if keep is not None:
        _build.check("keep", keep, torch.int32, (B,), dev)
    return B, H, N, M, D


def kernel_strides(q, k, v, out, bias):
    """The forward kernel's 13 strides: (b, h, row) of q, k, v and out in
    elements, then the bias row stride (0 without a bias)."""
    strides = list(_build.row_strides(q, k, v, out))
    strides.append(0 if bias is None else bias.stride(0))
    return (ctypes.c_longlong * 13)(*strides)


def new_output(q):
    """The forward kernel's output for q (B,H,N,D): a (B,H,N,D) view of a
    (B,N,H,D) tensor, so that the heads' merge back to (B,N,H*D) is a view."""
    B, H, N, D = q.shape
    return torch.empty((B, N, H, D), dtype=q.dtype,
                       device=q.device).transpose(1, 2)


def bias_attention_cuda(q, k, v, bias: Optional[torch.Tensor] = None,
                        keep: Optional[torch.Tensor] = None,
                        sm_scale: float = 1.0, return_lse: bool = False):
    """Launch the forward kernel's plain mode. q, k, v: bf16 on one CUDA
    device, D in {32, 64}, M >= 1, any (b, h, row) strides with a contiguous
    last dim (`check_kernel_args`); bias: (N, M) or None, copied into padded
    rows when M is not a multiple of 4 (`bias_rows`); keep: int32 (B,) or
    None. Returns out, a (B,H,N,D) view of a (B,N,H,D) tensor, or
    (out, lse) with lse the (B,H,N) fp32 logsumexp in log2 units. Raises on
    anything the kernel does not take and on a failed launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"bias_attention_cuda takes CUDA tensors, got {dev}")
    bias = bias_rows(bias)
    B, H, N, M, D = check_kernel_args(q, k, v, bias, keep)
    out = new_output(q)
    lse = (torch.empty((B, H, N), dtype=torch.float32, device=dev)
           if return_lse else None)
    p = _build.ptr
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p(q), p(k), p(v), p(bias), p(keep), p(out), p(lse),
                 B, H, N, M, D, kernel_strides(q, k, v, out, bias),
                 float(sm_scale), ctypes.c_void_p(stream))
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
    return _build.rows(q), _build.rows(k), _build.rows(v), bias, keep


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
