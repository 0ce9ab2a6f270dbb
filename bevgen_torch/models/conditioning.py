"""Auxiliary conditioning encoders.

The port's copy of `bevgen_tpu/models/conditioning.py`. Reference:
utils/taming_utils.py:103-131 — `Labelator` (class-label -> one-token
conditioning "code") and `SOSProvider` (constant start-of-sequence token),
used by the unconditional/class-conditional Net2Net variants. Both return
int32 tensors (the JAX package's int32 arrays) on the input's device, or
on the CPU for a numpy or list input.
"""
from __future__ import annotations

import torch


class Labelator:
    """Class label -> quantized one-token conditioning
    (taming_utils.py:103-116)."""

    def __init__(self, n_classes: int, quantize_interface: bool = True):
        self.n_classes = n_classes
        self.quantize_interface = quantize_interface

    def encode(self, labels):
        c = torch.as_tensor(labels).to(torch.int32).reshape(-1, 1)
        if self.quantize_interface:
            return c, None, c
        return c


class SOSProvider:
    """Constant start-of-sequence token (taming_utils.py:117-131)."""

    def __init__(self, sos_token: int, quantize_interface: bool = True):
        self.sos_token = sos_token
        self.quantize_interface = quantize_interface

    def encode(self, x):
        b = x.shape[0]
        device = x.device if isinstance(x, torch.Tensor) else None
        c = torch.full((b, 1), self.sos_token, dtype=torch.int32,
                       device=device)
        if self.quantize_interface:
            return c, None, c
        return c
