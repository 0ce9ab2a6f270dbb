"""Attention backward: the hand-written CUDA kernels and their plain
PyTorch version.

Replaces the TPU kernel `fused_bias_attention_bwd`
(`bevgen_tpu/ops/pallas/fused_attention.py:198`, kernel body `_bwd_kernel`
:138), the training backward of every MUSE attention. Inputs are taken
after the cosine prologue (`ops/cosine_attention.py:cosine_prologue`): qf
(B,H,N,D), kf and vc (B,H,M,D) with the null column at index 0, biasp
(N,M) fp32 or None, keep (B,) or None, dO (B,H,N,D). With

    P  = softmax(sm_scale qf kf^T + biasp) over the valid columns
         (col < M and keep[b] > 0, or col == 0),
    dS = P * (dO vc^T - delta),  delta_i = sum_j P_ij (dO vc^T)_ij,

it returns dq = sm_scale dS kf, dk = sm_scale dS^T qf, dv = P^T dO and
dbias = sum over (b, h) of dS (None without a bias). dq, dk and dv come back
in the input dtypes, dbias in fp32, as the TPU kernel's wrapper gives them.

`attention_bwd_reference` writes that out formula by formula, as
`_bwd_kernel` :150-195 does. `attention_bwd_cuda` launches the kernels of
`csrc/attention_bwd.cu`: dq (which also forms delta = rowsum(dO * O) from
the forward's output), then dk/dv, then dbias; they recompute P from the
forward's logsumexp and read q, k, v, out and dO through their (b, h, row)
strides, so head-transposed views are taken without a copy. The kernel
design, and what bounds it, are described in the source. `attention_bwd`
dispatches: CPU tensors take the plain version, CUDA tensors launch the
kernels or raise.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bevgen_torch.ops import _build

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
SOURCE = "bevgen_torch/csrc/attention_bwd.cu"
REPLACES = "bevgen_tpu/ops/pallas/fused_attention.py:198"

Grads = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


def valid_columns(keep: Optional[torch.Tensor], B: int, M: int,
                  device) -> Optional[torch.Tensor]:
    """(B, M) bool: the columns a sample's rows attend to (all of them, or
    the null column 0 alone where keep is 0); None without keep."""
    if keep is None:
        return None
    col = torch.arange(M, device=device)
    return (keep.reshape(B, 1) > 0) | (col[None] == 0)


def attention_bwd_reference(qf, kf, vc, biasp, keep, do,
                            sm_scale: float = 8.0) -> Grads:
    """Plain PyTorch backward of softmax(sm_scale qf kf^T + biasp) vc, in
    fp32 on the given inputs."""
    B = qf.shape[0]
    q, k, v, g = qf.float(), kf.float(), vc.float(), do.float()
    s = torch.einsum("bhid,bhjd->bhij", q, k) * sm_scale
    if biasp is not None:
        s = s + biasp.float()[None, None]
    valid = valid_columns(keep, B, k.shape[2], s.device)
    if valid is not None:
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bhid,bhjd->bhij", g, v)
    delta = (dp * p).sum(dim=-1, keepdim=True)
    ds = p * (dp - delta)
    if valid is not None:
        ds = torch.where(valid[:, None, None, :], ds, torch.zeros((), device=s.device))
    dq = torch.einsum("bhij,bhjd->bhid", ds, k) * sm_scale
    dk = torch.einsum("bhij,bhid->bhjd", ds, q) * sm_scale
    dv = torch.einsum("bhij,bhid->bhjd", p, g)
    dbias = ds.sum(dim=(0, 1)) if biasp is not None else None
    return dq.to(qf.dtype), dk.to(kf.dtype), dv.to(vc.dtype), dbias


def bias_rows(bias: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """The (N, M) bias as the attention kernels read it: fp32 rows that
    start on 16-byte boundaries. A bias whose rows do not (M not a multiple
    of 4, as the backward's and plain mode's M = N + 1) is copied into rows
    padded to a multiple of 4 and returned as an (N, M) view of them."""
    if bias is None:
        return None
    bias = bias.float()
    if _build.rows_ok(bias):
        return bias
    return F.pad(bias, (0, -bias.shape[1] % 4))[:, :bias.shape[1]]


def _fn():
    return _build.function("attention_bwd", "attention_bwd_bf16",
                           [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                           + [ctypes.c_void_p, ctypes.c_float,
                              ctypes.c_void_p])


def kernel_strides(qf, kf, vc, out, do, dq, dk, dv, biasp):
    """The backward kernels' 25 strides: (b, h, row) of qf, kf, vc, out,
    do, dq, dk and dv in elements, then the bias row stride (0 without a
    bias)."""
    strides = list(_build.row_strides(qf, kf, vc, out, do, dq, dk, dv))
    strides.append(0 if biasp is None else biasp.stride(0))
    return (ctypes.c_longlong * 25)(*strides)


def attention_bwd_cuda(qf, kf, vc, biasp, keep, out, do, lse,
                       sm_scale: float = 8.0) -> Grads:
    """Launch the backward kernels. qf, out, do (B,H,N,D) and kf, vc
    (B,H,M,D): bf16 on one CUDA device, D in {32, 64}, any (b, h, row)
    strides with a contiguous last dim and 16-byte rows (a head-transposed
    view is fine); biasp: (N, M) or None, copied into padded rows when M is
    not a multiple of 4 (`bias_rows`); keep: int32 (B,) or None; out and
    lse (B,H,N) fp32 (log2 units): the forward kernel's output and
    logsumexp on the same inputs. dq, dk, dv come back in the layouts of
    qf, kf, vc (`torch.empty_like`), dbias (N, M) fp32 contiguous. Raises
    on anything the kernels do not take and on a failed launch."""
    B, H, N, D = qf.shape
    M = kf.shape[2]
    dev = qf.device
    if dev.type != "cuda":
        raise ValueError(f"attention_bwd_cuda takes CUDA tensors, got {dev}")
    if D not in (32, 64):
        raise ValueError(f"head dim {D} not supported by the kernel (32, 64)")
    biasp = bias_rows(biasp)
    for name, t, shape in (("qf", qf, (B, H, N, D)), ("kf", kf, (B, H, M, D)),
                           ("vc", vc, (B, H, M, D)), ("out", out, (B, H, N, D)),
                           ("do", do, (B, H, N, D))):
        _build.check_rows(name, t, torch.bfloat16, shape, dev)
    _build.check("lse", lse, torch.float32, (B, H, N), dev)
    if biasp is not None:
        _build.check_rows("biasp", biasp, torch.float32, (N, M), dev)
    if keep is not None:
        _build.check("keep", keep, torch.int32, (B,), dev)
    dq, dk, dv = torch.empty_like(qf), torch.empty_like(kf), torch.empty_like(vc)
    delta = torch.empty((B, H, N), dtype=torch.float32, device=dev)
    dbias = (None if biasp is None
             else torch.empty((N, M), dtype=torch.float32, device=dev))
    p = _build.ptr
    fn = _fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(p(qf), p(kf), p(vc), p(biasp), p(keep), p(out), p(do), p(lse),
                 p(delta), p(dq), p(dk), p(dv), p(dbias), B, H, N, M, D,
                 kernel_strides(qf, kf, vc, out, do, dq, dk, dv, biasp),
                 float(sm_scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"attention_bwd kernel launch failed: CUDA error "
                           f"{err} at B={B} H={H} N={N} M={M} D={D}")
    # dq, dk/dv and (with a bias) dbias: one launch each
    n = 3 if biasp is not None else 2
    attention_bwd_cuda.launches += n
    attention_bwd_cuda.launches_by_shape[(N, M)] += n
    attention_bwd_cuda.launches_by_heads[H] += n
    return dq, dk, dv, dbias


attention_bwd_cuda.launches = 0
attention_bwd_cuda.launches_by_shape = Counter()
attention_bwd_cuda.launches_by_heads = Counter()


def reset_launch_counts() -> None:
    attention_bwd_cuda.launches = 0
    attention_bwd_cuda.launches_by_shape.clear()
    attention_bwd_cuda.launches_by_heads.clear()


def attention_bwd(qf, kf, vc, biasp, keep, do, sm_scale: float = 8.0,
                  out: Optional[torch.Tensor] = None,
                  lse: Optional[torch.Tensor] = None) -> Grads:
    """The attention backward. CPU tensors run the plain version (out and
    lse unused); CUDA tensors launch the kernels, which need the forward
    kernel's `out` and `lse`, or raise."""
    if qf.device.type == "cpu":
        return attention_bwd_reference(qf, kf, vc, biasp, keep, do, sm_scale)
    if qf.device.type != "cuda":
        raise ValueError(f"no attention backward for device {qf.device}")
    if out is None or lse is None:
        raise ValueError("the CUDA attention backward needs the forward "
                         "kernel's output and logsumexp (out=, lse=)")
    if keep is not None:
        keep = (keep > 0).to(torch.int32).contiguous()
    return attention_bwd_cuda(
        _build.rows(qf), _build.rows(kf), _build.rows(vc), biasp, keep,
        _build.rows(out), _build.rows(do.to(qf.dtype)), lse.contiguous(),
        sm_scale)
