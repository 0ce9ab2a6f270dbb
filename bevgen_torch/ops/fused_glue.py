"""The transformer's fused glue: residual add + LayerNorm and GEGLU +
LayerNorm, each one hand-written CUDA kernel with a plain PyTorch twin.

Replaces the TPU kernels of `bevgen_tpu/ops/pallas/fused_glue.py`:

  * `residual_layernorm_fwd` (:71, kernel body `_res_ln_kernel` :59):
    x_new = dtype(x + d), normed = LN(x_new) * gamma, both in x's dtype,
    the fp32 statistics taken from the rounded x_new;
    `residual_layernorm_reference` is the port of `_res_ln_reference` (:99);
  * `geglu_layernorm_fwd` (:171, kernel body `_geglu_ln_kernel` :157):
    LN(dtype(gate * gelu(a))) * gamma with the exact-erf gelu;
    `geglu_layernorm_reference` is the port of `_geglu_ln_reference` (:198).

The LayerNorm is scale-only, eps 1e-5, var = E[v^2] - mu^2
(`ops/layernorm.py`). The GEGLU input is the projection's own (..., 2F)
output [a | gate], unpadded, and the output is (..., F): the TPU wrapper's
128-lane padding of both halves (and of the projection weights around them)
was a layout for the TPU's tiles that the CUDA kernel does not need. What
bounds the kernels on an H100 and their design are in `csrc/fused_glue.cu`.

Under tensor parallelism a rank holds Fl = F / tp columns of a and of gate
(`parallel/sharding.py:tp_plan`), and the GEGLU + LayerNorm statistics
span every rank's columns: `geglu_stats` gives the rank's per-row (sum h,
sum h^2), `parallel.tensor.sum_over_tp` sums them once per layer, and
`geglu_norm` normalises the rank's columns with them (two kernels of
`csrc/fused_glue.cu` on the card; `geglu_stats_reference` and
`geglu_norm_reference` on the CPU). The variance is the glue's own
one-pass E[h^2] - mu^2. `GegluLayerNormSplitFn` is that form's autograd
Function. The residual + LayerNorm pass needs no split: the stream is
replicated and the deltas reaching it are already summed over tp.

`ResidualLayerNormFn` and `GegluLayerNormFn` are the counterparts of
`make_residual_layernorm` / `make_geglu_layernorm`'s custom_vjps (:113-127,
:214-228): the kernel forward on CUDA, and a backward that recomputes
through the twin under autograd, as the reference does (it has no backward
kernel). `residual_layernorm` and `geglu_layernorm` dispatch: CPU tensors
take the twins, CUDA tensors launch the kernels (bf16 activations, fp32
gamma) or raise; `geglu_layernorm(..., mesh)` takes the split form when
the mesh splits the GEGLU.
"""
from __future__ import annotations

import ctypes

import torch

from bevgen_torch.ops import _build
from bevgen_torch.ops.layernorm import EPS, layernorm_reference, twin_grads
from bevgen_torch.parallel import tensor as tpar

SOURCE = "bevgen_torch/csrc/fused_glue.cu"
RES_LN_REPLACES = "bevgen_tpu/ops/pallas/fused_glue.py:71"
# also the split pair's (GSPMD ran this Pallas kernel on the gathered operands)
GEGLU_LN_REPLACES = "bevgen_tpu/ops/pallas/fused_glue.py:171"


def residual_layernorm_reference(x: torch.Tensor, d: torch.Tensor,
                                 gamma: torch.Tensor):
    """(x_new, normed): x_new = (x + d) summed in fp32 and rounded to x's
    dtype, normed its scale-only LayerNorm in x's dtype."""
    s = (x.float() + d.float()).to(x.dtype)
    return s, layernorm_reference(s, gamma)


def geglu_layernorm_reference(y: torch.Tensor,
                              gamma: torch.Tensor) -> torch.Tensor:
    """y (..., 2F) = [a | gate] -> LN(gate * gelu(a)) * gamma, (..., F) in
    y's dtype; gate * gelu(a) is computed in fp32 and rounded to y's dtype
    before the statistics."""
    return layernorm_reference(_geglu_h(y), gamma)


def _geglu_h(y: torch.Tensor) -> torch.Tensor:
    """gate * gelu(a) for y = [a | gate], in fp32, rounded to y's dtype."""
    a, gate = y.float().chunk(2, dim=-1)
    return (gate * (a * 0.5 * (1.0 + torch.erf(a * 2.0 ** -0.5)))).to(y.dtype)


def geglu_stats_reference(y: torch.Tensor) -> torch.Tensor:
    """y (..., 2Fl) = [a | gate] of a rank's columns -> (..., 2) fp32: the
    row's (sum h, sum h^2) over them, h = gate * gelu(a) rounded to y's
    dtype."""
    h = _geglu_h(y).float()
    return torch.stack([h.sum(-1), (h * h).sum(-1)], dim=-1)


def geglu_norm_reference(y: torch.Tensor, stats: torch.Tensor,
                         gamma: torch.Tensor, width: int) -> torch.Tensor:
    """(h - mu) * rsqrt(E[h^2] - mu^2 + eps) * gamma in y's dtype, for the
    rank's columns h of y = [a | gate], with the row statistics `stats`
    (..., 2) summed over all `width` columns and `gamma` the rank's gains."""
    h = _geglu_h(y).float()
    mean = stats[..., :1] / width
    var = stats[..., 1:] / width - mean * mean
    return ((h - mean) * torch.rsqrt(var + EPS) * gamma.float()).to(y.dtype)


def geglu_layernorm_split_reference(y: torch.Tensor, gamma: torch.Tensor,
                                    mesh) -> torch.Tensor:
    """The split GEGLU + LayerNorm in plain PyTorch: y (..., 2Fl) and gamma
    (Fl,) are the rank's, the statistics summed over tp (`sum_over_tp`,
    differentiable: its backward sums the statistics' gradients, so the
    gradients are those of the whole-row norm)."""
    stats = tpar.sum_over_tp(geglu_stats_reference(y), mesh)
    return geglu_norm_reference(y, stats, gamma, gamma.shape[0] * mesh.tp)


def _res_fn():
    return _build.function("fused_glue", "residual_layernorm_bf16",
                           [ctypes.c_void_p] * 5
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _geglu_fn():
    return _build.function("fused_glue", "geglu_layernorm_bf16",
                           [ctypes.c_void_p] * 3
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _stats_fn():
    return _build.function("fused_glue", "geglu_stats_bf16",
                           [ctypes.c_void_p] * 2
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _norm_fn():
    return _build.function("fused_glue", "geglu_norm_bf16",
                           [ctypes.c_void_p] * 4
                           + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])


def _launch(fn, dev, *args) -> int:
    """Call a kernel's C entry on `dev` and its current stream."""
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def residual_layernorm_cuda(x: torch.Tensor, d: torch.Tensor,
                            gamma: torch.Tensor):
    """Launch the residual + LayerNorm kernel. x, d: contiguous bf16
    (..., F) of one shape on a CUDA device; gamma: contiguous fp32 (F,).
    Returns (x_new, normed), both bf16 (..., F). Raises on anything the
    kernel does not take and on a failed launch."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"residual_layernorm_cuda takes CUDA tensors, got {dev}")
    F = x.shape[-1]
    _build.check("x", x, torch.bfloat16, x.shape, dev)
    _build.check("d", d, torch.bfloat16, x.shape, dev)
    _build.check("gamma", gamma, torch.float32, (F,), dev)
    xo, no = torch.empty_like(x), torch.empty_like(x)
    rows = x.numel() // F
    err = _launch(_res_fn(), dev, x.data_ptr(), d.data_ptr(), gamma.data_ptr(),
                  xo.data_ptr(), no.data_ptr(), rows, F)
    if err != 0:
        raise RuntimeError(f"residual_layernorm kernel launch failed: CUDA "
                           f"error {err} at rows={rows} F={F}")
    residual_layernorm_cuda.launches += 1
    return xo, no


def geglu_layernorm_cuda(y: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """Launch the GEGLU + LayerNorm kernel. y: contiguous bf16 (..., 2F) on
    a CUDA device, [a | gate]; gamma: contiguous fp32 (F,). Returns bf16
    (..., F). Raises on anything the kernel does not take and on a failed
    launch."""
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"geglu_layernorm_cuda takes CUDA tensors, got {dev}")
    F2 = y.shape[-1]
    if F2 % 2:
        raise ValueError(f"y's last dim {F2} is not [a | gate] (odd)")
    F = F2 // 2
    _build.check("y", y, torch.bfloat16, y.shape, dev)
    _build.check("gamma", gamma, torch.float32, (F,), dev)
    out = torch.empty(y.shape[:-1] + (F,), dtype=y.dtype, device=dev)
    rows = out.numel() // F
    err = _launch(_geglu_fn(), dev, y.data_ptr(), gamma.data_ptr(),
                  out.data_ptr(), rows, F)
    if err != 0:
        raise RuntimeError(f"geglu_layernorm kernel launch failed: CUDA error "
                           f"{err} at rows={rows} F={F}")
    geglu_layernorm_cuda.launches += 1
    return out


def _split_input(y: torch.Tensor, what: str) -> int:
    """Fl of a rank's y (..., 2Fl) on a CUDA device, after the checks."""
    dev = y.device
    if dev.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, got {dev}")
    if y.shape[-1] % 2:
        raise ValueError(f"y's last dim {y.shape[-1]} is not [a | gate] (odd)")
    _build.check("y", y, torch.bfloat16, y.shape, dev, align=2)
    return y.shape[-1] // 2


def geglu_stats_cuda(y: torch.Tensor) -> torch.Tensor:
    """Launch the GEGLU statistics kernel. y: contiguous bf16 (..., 2Fl) on a
    CUDA device, [a | gate] of a rank's columns, at any address. Returns fp32 (..., 2), the
    row's (sum h, sum h^2). Raises on anything the kernel does not take and
    on a failed launch."""
    Fl = _split_input(y, "geglu_stats_cuda")
    stats = torch.empty(y.shape[:-1] + (2,), dtype=torch.float32,
                        device=y.device)
    rows = stats.numel() // 2
    err = _launch(_stats_fn(), y.device, y.data_ptr(), stats.data_ptr(), rows,
                  Fl)
    if err != 0:
        raise RuntimeError(f"geglu_stats kernel launch failed: CUDA error "
                           f"{err} at rows={rows} Fl={Fl}")
    geglu_stats_cuda.launches += 1
    return stats


def geglu_norm_cuda(y: torch.Tensor, stats: torch.Tensor, gamma: torch.Tensor,
                    width: int) -> torch.Tensor:
    """Launch the split GEGLU + LayerNorm kernel. y: contiguous bf16 (...,
    2Fl) on a CUDA device, at any address; stats: contiguous fp32 (..., 2),
    8-byte aligned, summed over all `width` columns; gamma: contiguous fp32
    (Fl,), the rank's gains. Returns bf16 (..., Fl). Raises on anything the
    kernel does not take and on a failed launch."""
    Fl = _split_input(y, "geglu_norm_cuda")
    dev = y.device
    _build.check("stats", stats, torch.float32, y.shape[:-1] + (2,), dev,
                 align=8)
    _build.check("gamma", gamma, torch.float32, (Fl,), dev, align=4)
    out = torch.empty(y.shape[:-1] + (Fl,), dtype=y.dtype, device=dev)
    rows = out.numel() // Fl
    err = _launch(_norm_fn(), dev, y.data_ptr(), stats.data_ptr(),
                  gamma.data_ptr(), out.data_ptr(), rows, Fl, width)
    if err != 0:
        raise RuntimeError(f"geglu_norm kernel launch failed: CUDA error "
                           f"{err} at rows={rows} Fl={Fl} F={width}")
    geglu_norm_cuda.launches += 1
    return out


KERNELS = (residual_layernorm_cuda, geglu_layernorm_cuda, geglu_stats_cuda,
           geglu_norm_cuda)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


def _residual_forward(x, d, gamma):
    if x.device.type == "cpu":
        return residual_layernorm_reference(x, d, gamma)
    return residual_layernorm_cuda(x.contiguous(), d.contiguous(),
                                   gamma.contiguous())


def _geglu_forward(y, gamma):
    if y.device.type == "cpu":
        return geglu_layernorm_reference(y, gamma)
    return geglu_layernorm_cuda(y.contiguous(), gamma.contiguous())


def _geglu_split_forward(y, gamma, mesh):
    """The split form's forward: the kernels on CUDA, the plain pieces on
    the CPU, the statistics summed over tp between them."""
    if y.device.type == "cpu":
        return geglu_layernorm_split_reference(y, gamma, mesh)
    y = y.contiguous()
    stats = tpar.sum_over_tp(geglu_stats_cuda(y), mesh)
    return geglu_norm_cuda(y, stats, gamma.contiguous(), gamma.shape[0] * mesh.tp)


class ResidualLayerNormFn(torch.autograd.Function):
    """The counterpart of `make_residual_layernorm`'s custom_vjp."""

    @staticmethod
    def forward(ctx, x, d, gamma):
        ctx.save_for_backward(x, d, gamma)
        return _residual_forward(x, d, gamma)

    @staticmethod
    def backward(ctx, dx_new, dnormed):
        return twin_grads(residual_layernorm_reference, ctx.saved_tensors,
                          (dx_new, dnormed), ctx.needs_input_grad)


class GegluLayerNormFn(torch.autograd.Function):
    """The counterpart of `make_geglu_layernorm`'s custom_vjp."""

    @staticmethod
    def forward(ctx, y, gamma):
        ctx.save_for_backward(y, gamma)
        return _geglu_forward(y, gamma)

    @staticmethod
    def backward(ctx, dout):
        return twin_grads(geglu_layernorm_reference, ctx.saved_tensors,
                          (dout,), ctx.needs_input_grad)


class GegluLayerNormSplitFn(torch.autograd.Function):
    """The split form over a rank's columns: the forward through the kernels
    (or the plain pieces), the backward recomputed through
    `geglu_layernorm_split_reference` under autograd, `sum_over_tp`
    inside, so y's and the gains' gradients are those of the whole-row
    norm (the reference has no backward kernel)."""

    @staticmethod
    def forward(ctx, y, gamma, mesh):
        ctx.mesh = mesh
        ctx.save_for_backward(y, gamma)
        return _geglu_split_forward(y, gamma, mesh)

    @staticmethod
    def backward(ctx, dout):
        mesh = ctx.mesh
        grads = twin_grads(
            lambda y, g: geglu_layernorm_split_reference(y, g, mesh),
            ctx.saved_tensors, (dout,), ctx.needs_input_grad[:2])
        return (*grads, None)


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} for device {t.device}")


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def residual_layernorm(x: torch.Tensor, d: torch.Tensor,
                       gamma: torch.Tensor):
    """(x_new, normed) = (dtype(x + d), LN(x_new) * gamma), differentiable
    in all three. CPU tensors run the twin; CUDA tensors launch the kernel
    (or raise)."""
    _check_device(x, "residual_layernorm")
    if _needs_grad(x, d, gamma):
        return ResidualLayerNormFn.apply(x, d, gamma)
    return _residual_forward(x, d, gamma)


def geglu_layernorm(y: torch.Tensor, gamma: torch.Tensor,
                    mesh=None) -> torch.Tensor:
    """LN(gate * gelu(a)) * gamma for y = [a | gate], differentiable in both.
    CPU tensors run the twin; CUDA tensors launch the kernel (or raise).
    With a tensor-parallel `mesh`, y holds the rank's columns of a and of
    gate and gamma their gains: the split form (`geglu_stats`, a sum over
    tp, `geglu_norm`)."""
    _check_device(y, "geglu_layernorm")
    if tpar.active(mesh):
        if _needs_grad(y, gamma):
            return GegluLayerNormSplitFn.apply(y, gamma, mesh)
        return _geglu_split_forward(y, gamma, mesh)
    if _needs_grad(y, gamma):
        return GegluLayerNormFn.apply(y, gamma)
    return _geglu_forward(y, gamma)
