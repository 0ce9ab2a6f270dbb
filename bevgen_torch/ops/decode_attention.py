"""Single-position (decode-time) attention: the hand-written CUDA kernel and
its plain PyTorch version.

Replaces the TPU kernel `decode_attention`
(`bevgen_tpu/ops/pallas/decode_attention.py:72`, kernel body `_kernel` :44):
for one query position per (b, h) row against the first pl positions of a
K/V cache,

    softmax(q K^T * scale + addend) V

with `addend` (H, pl) fp32 carrying bias * scale where the column is visible
and -1e9 where it is masked. `decode_attention_reference` is the port of
`decode_attention_reference` (:111). What bounds the kernel on an H100 and
its design (each row split across a thread block cluster of
`splits_for(pl)` blocks, one launch per call) are in
`csrc/decode_attention.cu`; `decode_attention_split_reference` is that
split in plain PyTorch, for the tests.

`decode_attention` dispatches: CPU tensors take the plain version, CUDA
tensors launch the kernel or raise. The kernel takes any b*H (the TPU
wrapper fell back to its reference unless b*H was a multiple of 8) and pl
up to MAX_PL = 2560, beyond every AR configuration's sequence. K and V may be prefix
views `cache[:, :, :pl]` of wider caches: the kernel reads them with their
row stride, without a copy.
"""
from __future__ import annotations

import ctypes
from collections import Counter
from typing import Optional

import torch

from bevgen_torch.ops import _build

SOURCE = "bevgen_torch/csrc/decode_attention.cu"
REPLACES = "bevgen_tpu/ops/pallas/decode_attention.py:72"
NEG_INF = -1e9
# the kernel's split of a (b, h) row: a cluster of at most MAX_SPLITS
# blocks of about ROWS_PER_BLOCK cache rows, at most MAX_ROWS each
MAX_SPLITS, ROWS_PER_BLOCK, MAX_ROWS = 8, 192, 320
MAX_PL = MAX_SPLITS * MAX_ROWS


def splits_for(pl: int) -> int:
    """Blocks of the kernel's cluster for prefix length pl (its
    `splits_for`)."""
    return min(MAX_SPLITS, max(1, -(-pl // ROWS_PER_BLOCK)))


def decode_attention_reference(q, k, v, addend, sm_scale: float):
    """q (b,H,dh), k/v (b,H,pl,dh), addend (H,pl): fp32 scores and softmax,
    the weights rounded to v's dtype before P.V, the output in q's dtype."""
    scores = torch.einsum("bhd,bhjd->bhj", q.to(k.dtype).float(), k.float())
    scores = scores * sm_scale + addend.float()[None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhj,bhjd->bhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def decode_attention_split_reference(q, k, v, addend, sm_scale: float,
                                     splits: Optional[int] = None):
    """The kernel's split of each row in plain PyTorch, for tests: chunk r
    of `splits` (default `splits_for(pl)`) holds cache rows [r c, (r + 1)
    c), c = ceil(pl / splits) (empty where pl < splits); each chunk's max
    and sum of exp(s - max) combine in rank order into the row's max m and
    sum l; each chunk forms p = exp(s - m) / l rounded to v's dtype and its
    P.V partial in fp32, and the partials are summed in rank order. Same
    arguments and result as `decode_attention_reference`."""
    scores = torch.einsum("bhd,bhjd->bhj", q.to(k.dtype).float(), k.float())
    scores = scores * sm_scale + addend.float()[None]
    pl = scores.shape[-1]
    splits = splits_for(pl) if splits is None else splits
    c = -(-pl // splits)
    chunks = [slice(r * c, min(pl, (r + 1) * c)) for r in range(splits)
              if r * c < pl]
    stats = []  # (chunk max, chunk sum of exp(s - chunk max))
    for sl in chunks:
        mr = scores[..., sl].amax(-1)
        stats.append((mr, torch.exp(scores[..., sl] - mr[..., None]).sum(-1)))
    m = stats[0][0]
    for mr, _ in stats[1:]:
        m = torch.maximum(m, mr)
    l = torch.zeros_like(m)
    for mr, lr in stats:
        l = l + lr * torch.exp(mr - m)
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for sl in chunks:
        p = (torch.exp(scores[..., sl] - m[..., None]) / l[..., None]).to(v.dtype)
        out = out + torch.einsum("bhj,bhjd->bhd", p.float(), v[:, :, sl].float())
    return out.to(q.dtype)


def _fn():
    return _build.function("decode_attention", "decode_attention_bf16",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_longlong, ctypes.c_float,
                              ctypes.c_void_p])


def decode_attention_cuda(q, k, v, addend, sm_scale: float):
    """Launch the CUDA kernel, one launch of b*H clusters of
    `splits_for(pl)` blocks. q: contiguous bf16 (b,H,dh), dh = 64;
    k, v: bf16 (b,H,pl,dh) whose last two dims are contiguous and whose
    (b, h) rows are evenly strided (a prefix view of a cache is fine);
    addend: contiguous fp32 (H,pl). Returns (b,H,dh) bf16. Raises on
    anything the kernel does not take and on a failed launch. Called once
    per layer per decoded token, so its checks are kept few and cheap."""
    b, H, dh = q.shape
    pl = k.shape[2]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda takes CUDA tensors, got {dev}")
    if dh != 64:
        raise ValueError(f"head dim {dh} not supported by the kernel (64)")
    if pl > MAX_PL:
        raise ValueError(f"prefix length {pl} above the kernel's {MAX_PL}")
    if q.dtype != torch.bfloat16 or k.dtype != torch.bfloat16 \
            or v.dtype != torch.bfloat16 or addend.dtype != torch.float32:
        raise TypeError("decode_attention_cuda takes bf16 q, k, v and fp32 addend")
    if tuple(k.shape) != (b, H, pl, dh) or k.shape != v.shape \
            or k.stride() != v.stride() or tuple(addend.shape) != (H, pl):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} addend {tuple(addend.shape)}")
    rs = k.stride(1)
    if (k.stride(3) != 1 or k.stride(2) != dh or k.stride(0) != H * rs
            or rs % 8 or not q.is_contiguous() or not addend.is_contiguous()
            or k.device != dev or v.device != dev or addend.device != dev
            or (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16):
        raise ValueError("decode_attention_cuda: q and addend must be "
                         "contiguous; k and v (b,H,pl,dh) views with "
                         "contiguous rows, 16-byte aligned")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), addend.data_ptr(),
                out.data_ptr(), b, H, pl, dh, rs, float(sm_scale), stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err} at b={b} H={H} pl={pl} dh={dh}")
    decode_attention_cuda.launches += 1
    decode_attention_cuda.launches_by_shape[pl] += 1
    decode_attention_cuda.launches_by_heads[H] += 1
    return out


decode_attention_cuda.launches = 0
decode_attention_cuda.launches_by_shape = Counter()
decode_attention_cuda.launches_by_heads = Counter()


def reset_launch_counts() -> None:
    decode_attention_cuda.launches = 0
    decode_attention_cuda.launches_by_shape.clear()
    decode_attention_cuda.launches_by_heads.clear()


def decode_attention(q, k, v, addend, sm_scale: float):
    """The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, addend, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no decode attention for device {q.device}")
    return decode_attention_cuda(q, k, v, addend, sm_scale)
