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
19 MB, so about 6 us at 3.35 TB/s. The kernel's design (online softmax
seeded with the null column, q prologue fused in, K/V tiles in shared
memory, P kept in registers) is described in `csrc/cosine_attention.cu`.

`cosine_attention` dispatches: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. There is no fallback between them.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import numpy as np
import torch

NEG_INF = -0.7 * float(np.finfo(np.float32).max)
SOURCE = "bevgen_torch/csrc/cosine_attention.cu"
REPLACES = "bevgen_tpu/ops/pallas/fused_attention.py:737"


def _l2n(t: torch.Tensor) -> torch.Tensor:
    t = t.float()
    return t / torch.linalg.vector_norm(t, dim=-1, keepdim=True).clamp_min(1e-12)


def cosine_attention_reference(q, k, v, null_kv, q_scale, k_scale,
                               bias: Optional[torch.Tensor] = None,
                               keep: Optional[torch.Tensor] = None,
                               sm_scale: float = 8.0,
                               k_prenormed: bool = True) -> torch.Tensor:
    """Plain PyTorch cosine attention, computed in q's dtype with fp32
    norms, scores and softmax.

    q: (B,H,N,D); k, v: (B,H,M,D) without the null column; null_kv:
    (2,H,1,D) raw; q_scale, k_scale: (D,); bias: (N,M) or None; keep: (B,)
    or None. k_prenormed: k is already l2-normalised and k_scale-d."""
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
    s = torch.einsum("bhid,bhjd->bhij", qf.float(), kf.float()) * sm_scale
    if bias is not None:
        s = s + torch.nn.functional.pad(bias.float(), (1, 0))[None, None]
    if keep is not None:
        col = torch.arange(s.shape[-1], device=s.device)
        valid = (keep.reshape(B, 1) > 0) | (col[None] == 0)
        s = torch.where(valid[:, None, None, :], s,
                        torch.full((), NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1).to(vc.dtype)
    return torch.einsum("bhij,bhjd->bhid", p.float(), vc.float()).to(dt)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _lib():
    from bevgen_torch.ops import _build
    lib = _build.load("cosine_attention")
    fn = lib.cosine_attention_fwd_bf16
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
    return fn


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def cosine_attention_cuda(q, k, v, null_kv, q_scale, k_scale,
                          bias: Optional[torch.Tensor] = None,
                          keep: Optional[torch.Tensor] = None,
                          sm_scale: float = 8.0) -> torch.Tensor:
    """Launch the CUDA kernel (k prenormed). q, k, v: contiguous bf16 on
    one CUDA device, D in {32, 64}; null_kv, q_scale, k_scale, bias: fp32;
    keep: int32 or None. Raises on anything the kernel does not take and
    on a failed launch."""
    B, H, N, D = q.shape
    M = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"cosine_attention_cuda takes CUDA tensors, got {dev}")
    if D not in (32, 64):
        raise ValueError(f"head dim {D} not supported by the kernel (32, 64)")
    _check("q", q, torch.bfloat16, (B, H, N, D), dev)
    _check("k", k, torch.bfloat16, (B, H, M, D), dev)
    _check("v", v, torch.bfloat16, (B, H, M, D), dev)
    _check("null_kv", null_kv, torch.float32, (2, H, 1, D), dev)
    _check("q_scale", q_scale, torch.float32, (D,), dev)
    _check("k_scale", k_scale, torch.float32, (D,), dev)
    if bias is not None:
        _check("bias", bias, torch.float32, (N, M), dev)
    if keep is not None:
        _check("keep", keep, torch.int32, (B,), dev)
    out = torch.empty_like(q)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(null_kv), _ptr(q_scale),
                 _ptr(k_scale), _ptr(bias), _ptr(keep), _ptr(out),
                 B, H, N, M, D, float(sm_scale), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"cosine_attention kernel launch failed: CUDA "
                           f"error {err} at B={B} H={H} N={N} M={M} D={D}")
    cosine_attention_cuda.launches += 1
    cosine_attention_cuda.launches_by_shape[(N, M)] += 1
    return out


cosine_attention_cuda.launches = 0
cosine_attention_cuda.launches_by_shape = Counter()


def reset_launch_counts() -> None:
    cosine_attention_cuda.launches = 0
    cosine_attention_cuda.launches_by_shape.clear()


def cosine_attention(q, k, v, null_kv, q_scale, k_scale,
                     bias: Optional[torch.Tensor] = None,
                     keep: Optional[torch.Tensor] = None,
                     sm_scale: float = 8.0) -> torch.Tensor:
    """The attention core of the MUSE transformer, k prenormed. CPU
    tensors run the plain version; CUDA tensors launch the kernel (or
    raise)."""
    if q.device.type == "cpu":
        return cosine_attention_reference(q, k, v, null_kv, q_scale, k_scale,
                                          bias, keep, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no cosine attention for device {q.device}")
    if keep is not None:
        keep = (keep > 0).to(torch.int32).contiguous()
    return cosine_attention_cuda(
        q.contiguous(), k.contiguous(), v.contiguous(),
        null_kv.float().contiguous(), q_scale.float().contiguous(),
        k_scale.float().contiguous(),
        None if bias is None else bias.float().contiguous(), keep,
        sm_scale)
