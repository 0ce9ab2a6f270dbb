"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source `csrc/<name>.cu` exports plain C functions and becomes one
shared library `build/lib<name>-<hash>.so`, where the hash covers the
source, the shared headers `csrc/*.cuh` and the flags, so an edited source
is rebuilt and a stale library is never loaded. Libraries are built at first use, never at import: the
CPU tests import every module of the package. `build_all` starts one nvcc
per source at once and waits for all of them.

Build by hand with the same command:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o bevgen_torch/build/libcosine_attention.so \\
        bevgen_torch/csrc/cosine_attention.cu
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("cosine_attention", "attention_bwd", "block_sparse",
           "block_sparse_bwd", "decode_attention", "fused_glue", "layernorm",
           "int8", "int8_gemm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of bevgen_torch are "
                       "built with nvcc on the machine that has the card")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build every named source that has no up-to-date library, one nvcc
    process per source, all started together. Returns name -> library
    path; the compiler's register/shared-memory report is kept beside each
    library as `<lib>.log`. Raises with nvcc's output on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for name, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        Path(str(out) + ".log").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for `csrc/<name>.cu`, building it if needed."""
    return ctypes.CDLL(str(build_all([name])[name]))


def function(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C function `symbol` of the library for `csrc/<name>.cu`, with
    its argument types set (pointers as c_void_p, so ctypes never cuts one
    to 32 bits) and an int return code."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
    return fn


def ptr(t) -> Optional[ctypes.c_void_p]:
    """A tensor's device address for a kernel argument (None -> NULL)."""
    return None if t is None else ctypes.c_void_p(t.data_ptr())


def _check_meta(name: str, t, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def check(name: str, t, dtype, shape, device, align: int = 16) -> None:
    """Raise unless `t` is what a kernel takes: on `device`, of `dtype` and
    `shape`, contiguous and `align`-byte aligned (16 unless the kernel
    says otherwise)."""
    _check_meta(name, t, dtype, shape, device)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} must be {align}-byte aligned")


def rows_ok(t) -> bool:
    """Whether a kernel can read `t` row by row (`check_rows`)."""
    size = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * size % 16 == 0
                    for n, st in zip(t.shape[:-1], t.stride()[:-1]) if n > 1))


def check_rows(name: str, t, dtype, shape, device) -> None:
    """Raise unless `t` is what a kernel reads row by row: on `device`, of
    `dtype` and `shape`, its last dim contiguous, its address and every other
    stride (of a dim longer than 1) a multiple of 16 bytes."""
    _check_meta(name, t, dtype, shape, device)
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s last dim must be contiguous, got strides "
                         f"{tuple(t.stride())}")
    if not rows_ok(t):
        raise ValueError(f"{name}'s address and strides {tuple(t.stride())} "
                         f"must be multiples of 16 bytes")


def rows(t):
    """`t` itself when a kernel can read it row by row (`check_rows`), else
    a contiguous copy in new (aligned) memory."""
    if rows_ok(t):
        return t
    return t.clone() if t.is_contiguous() else t.contiguous()


def row_strides(*tensors):
    """The leading strides of each tensor (all dims but the last), in
    elements, with 0 for a dim of length 1, as one C array of int64."""
    vals = [0 if n == 1 else st for t in tensors
            for n, st in zip(t.shape[:-1], t.stride()[:-1])]
    return (ctypes.c_longlong * len(vals))(*vals)
