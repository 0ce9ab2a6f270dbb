"""Profiling and debug instrumentation: a trace context, device memory
statistics, a timed benchmark and NaN checks.

The counterpart of `bevgen_tpu/utils/profiling.py` on `torch.profiler` and
`torch.cuda`. Two departures: `trace` writes one Chrome trace
(`<logdir>/trace.json`, for Perfetto or chrome://tracing) where the JAX one
writes a TensorBoard `jax.profiler` directory; `enable_nan_checks` turns on
autograd's anomaly mode, which checks the backward's outputs only, where
`jax_debug_nans` checks every operation. Each function takes the device it
measures, `cuda` unless the caller passes `device="cpu"` (where there is no
device activity to record or synchronise, and the memory statistics are 0);
`cuda` without a card raises (`core/device.py:resolve_device`).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from bevgen_torch.core.device import resolve_device

Device = Union[str, torch.device, None]
TRACE_LEAD_S = 0.5


@contextlib.contextmanager
def trace(logdir: str = "output/trace", cpu: bool = True,
          device: Device = "cuda"):
    """Record the block's activity with `torch.profiler` and write it to
    `<logdir>/trace.json` as a Chrome trace: the CUDA activity on a CUDA
    `device` (synchronised at the block's end), and the CPU activity when
    `cpu` or on the CPU. Pass cpu=False for a long launch stream (the AR
    decode launches some 800,000 kernels a generate): its CPU events would
    multiply the trace. On a card the block starts TRACE_LEAD_S after the
    session: an H100 under CUPTI dropped the device events of a session's
    first milliseconds (1 to 17 launches in a run of eight traces, some 800
    in another run), as if their timestamps fell before its start."""
    from torch.profiler import ProfilerActivity, profile
    cuda = resolve_device(device).type == "cuda"
    activities = ([ProfilerActivity.CPU] if cpu or not cuda else []) + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_LEAD_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device: Device = "cuda") -> Dict[str, float]:
    """Current, peak and total memory of a CUDA device in MB
    (`memory_allocated`, `max_memory_allocated`, the device's total); all
    0 on the CPU, as the JAX function gives where the device keeps no
    statistics."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"bytes_in_use_mb": 0.0, "peak_bytes_in_use_mb": 0.0,
                "bytes_limit_mb": 0.0}
    mb = 1024 * 1024
    return {
        "bytes_in_use_mb": torch.cuda.memory_allocated(dev) / mb,
        "peak_bytes_in_use_mb": torch.cuda.max_memory_allocated(dev) / mb,
        "bytes_limit_mb": torch.cuda.get_device_properties(dev).total_memory / mb,
    }


def benchmark(fn: Callable, *args, reps: int = 5, warmup: int = 2,
              sync: Optional[Callable] = None,
              device: Device = "cuda") -> Dict[str, float]:
    """Time `fn(*args)` on `device`: `warmup` calls, then `reps` timed ones on
    the host's clock, each ended by `sync(out)` (default: synchronise a CUDA
    device, where the JAX one copies a leaf to the host). The peak memory
    statistic is reset before the warm-up, so the peak is the calls'.
    Returns best_ms, mean_ms and `device_memory_stats(device)`."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"

    def _sync(out):
        if sync is not None:
            return sync(out)
        if cuda:
            torch.cuda.synchronize(dev)
        return out

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return {"best_ms": min(times) * 1e3,
            "mean_ms": float(np.mean(times)) * 1e3,
            **device_memory_stats(dev)}


def enable_nan_checks() -> None:
    """Raise where a backward function returns NaN (autograd's anomaly mode,
    which also records each forward's stack). The forward is not checked."""
    torch.autograd.set_detect_anomaly(True, check_nan=True)
