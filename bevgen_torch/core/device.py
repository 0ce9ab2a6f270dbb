"""Device and dtype resolution for the port's entry points.

Entry points run on the card by default. Without a CUDA device they raise
rather than fall back to the CPU: a caller who wants the CPU (the tests)
passes `device="cpu"` explicitly.
"""
from __future__ import annotations

from typing import Union

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bevgen_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}; expected one of "
                         f"{sorted(DTYPES)}")
    return DTYPES[dtype]
