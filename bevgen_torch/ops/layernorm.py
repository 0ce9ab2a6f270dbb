"""Scale-only LayerNorm: the hand-written CUDA kernel and its plain PyTorch
version.

Replaces the TPU kernel `fused_layernorm`
(`bevgen_tpu/ops/pallas/layernorm.py:54`, kernel body `_ln_kernel` :35) and
its public entry `make_layernorm` (:89):

    LN(x) * scale,  fp32 statistics, var = E[x^2] - E[x]^2, eps 1e-5

in x's dtype, for x (..., D) and scale (D,). `layernorm_reference` is the
port of `make_layernorm`'s `_dense` (:95-100). What bounds the kernel on
an H100 and its design are in `csrc/layernorm.cu`: a register form (one
warp per row, 16-byte accesses, a persistent grid) and the general form
(one block per row) for what the register form does not take; the rule
between them is `layernorm_variant`, and each variant counts its own
launches (`layernorm_cuda.launches_by_variant`).

`LayerNormFn` is the counterpart of `make_layernorm`'s custom_vjp
(:102-115): the kernel forward on CUDA, and a backward that recomputes
through the plain version under autograd (the reference has no backward
kernel). `layernorm` dispatches: CPU tensors take the plain version, CUDA
tensors launch the kernel (bf16 x, fp32 scale) or raise.

No configuration runs it, in the reference or here: `LayerNormG(use_fused
=True)` (`models/stage2/transformer.py`) reaches it.
"""
from __future__ import annotations

import ctypes

import torch

from bevgen_torch.ops import _build

SOURCE = "bevgen_torch/csrc/layernorm.cu"
REPLACES = "bevgen_tpu/ops/pallas/layernorm.py:54"
EPS = 1e-5
# the register form's widest row: 8 chunks of 8 bf16 per lane (csrc/
# layernorm.cu:WARP_MAX_WIDTH; chip_smoke.py phase 21 fails on a spill)
WARP_MAX_WIDTH = 2048
VARIANTS = ("warp", "block")


def layernorm_variant(D: int, *ptrs: int) -> str:
    """Which form of the kernel takes rows of width D at the addresses
    `ptrs` (x, scale, out): "warp", the register form, where D is a multiple
    of 8 up to WARP_MAX_WIDTH and every address is 16-byte aligned; else
    "block", the general form."""
    if 0 < D <= WARP_MAX_WIDTH and D % 8 == 0 and all(p % 16 == 0 for p in ptrs):
        return "warp"
    return "block"


def layernorm_reference(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain scale-only LayerNorm in x's dtype with fp32 statistics."""
    f32 = x.float()
    mean = f32.mean(-1, keepdim=True)
    var = (f32 * f32).mean(-1, keepdim=True) - mean * mean
    return ((f32 - mean) * torch.rsqrt(var + EPS) * scale.float()).to(x.dtype)


def twin_grads(twin, inputs, grads, needs_input_grad):
    """The backward of a forward kernel that has no backward kernel, as the
    reference's custom_vjps take it: `twin` (the plain version) recomputed
    under autograd on detached copies of `inputs`, and the gradients of its
    outputs against `grads` for the inputs that need one (None for the
    rest)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(need)
                  for t, need in zip(inputs, needs_input_grad)]
        outs = twin(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        wrt = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(outs, wrt, grads))
    return tuple(next(got) if need else None for need in needs_input_grad)


def _fn(variant: str):
    return _build.function("layernorm", f"layernorm_{variant}_bf16",
                           [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def layernorm_cuda(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel in the form `layernorm_variant` picks. x:
    contiguous bf16 (..., D) on a CUDA device, at any address; scale:
    contiguous fp32 (D,) on the same device. Returns LN(x) * scale in bf16.
    Raises on anything the kernel does not take and on a failed launch."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"layernorm_cuda takes CUDA tensors, got {dev}")
    D = x.shape[-1]
    _build.check("x", x, torch.bfloat16, x.shape, dev, align=2)
    _build.check("scale", scale, torch.float32, (D,), dev, align=4)
    out = torch.empty_like(x)
    rows = x.numel() // D
    variant = layernorm_variant(D, x.data_ptr(), scale.data_ptr(),
                                out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _fn(variant)(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           rows, D, stream)
    if err != 0:
        raise RuntimeError(f"layernorm kernel ({variant} form) launch failed: "
                           f"CUDA error {err} at rows={rows} D={D}")
    layernorm_cuda.launches += 1
    layernorm_cuda.launches_by_variant[variant] += 1
    return out


layernorm_cuda.launches = 0
layernorm_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def reset_launch_counts() -> None:
    layernorm_cuda.launches = 0
    layernorm_cuda.launches_by_variant = dict.fromkeys(VARIANTS, 0)


def _forward(x, scale):
    if x.device.type == "cpu":
        return layernorm_reference(x, scale)
    return layernorm_cuda(x.contiguous(), scale.contiguous())


class LayerNormFn(torch.autograd.Function):
    """The counterpart of `make_layernorm`'s custom_vjp: the kernel (or, on
    the CPU, the plain version) forward, the plain version's gradients."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.save_for_backward(x, scale)
        return _forward(x, scale)

    @staticmethod
    def backward(ctx, grad):
        return twin_grads(layernorm_reference, ctx.saved_tensors, (grad,),
                          ctx.needs_input_grad)


def layernorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """LN(x) * scale in x's dtype, differentiable in both. CPU tensors run
    the plain version; CUDA tensors launch the kernel (or raise)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no layernorm for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return LayerNormFn.apply(x, scale)
    return _forward(x, scale)
