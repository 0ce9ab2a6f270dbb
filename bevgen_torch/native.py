"""ctypes bindings of the port's native C++ rasterization core.

`csrc/rasterize.cpp` (host C++, no CUDA; the JAX package's
`native/rasterize.cpp`, the same code) is built at first use, never at
import, with

    g++ -O3 -shared -fPIC -std=c++17 bevgen_torch/csrc/rasterize.cpp \\
        -o bevgen_torch/build/librasterize-<hash>.so

where the hash covers the source and the flags, so an edited source is
rebuilt and a stale library never loaded. `data/rasterize.py` draws
through it under `BEVGEN_NATIVE_RASTER=1` (or after `enable()`); cv2 stays
the default route. The one departure from the JAX module: a failed build
raises, with the compiler's output, wherever the core is used (JAX
quietly falls back to cv2); `available()` and `build_error()` report it
without raising.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SRC = PKG_DIR / "csrc" / "rasterize.cpp"
BUILD_DIR = PKG_DIR / "build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

# source path -> the loaded library, or the build's error text
_built: Dict[Path, Union[ctypes.CDLL, str]] = {}


def library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"librasterize-{digest.hexdigest()[:12]}.so"


def _build(src: Path) -> Union[ctypes.CDLL, str]:
    """Build (unless an up-to-date library exists) and load `src`; the
    error text on failure."""
    if not src.exists():
        return f"source missing: {src}"
    out = library_path(src)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            return f"{' '.join(cmd)}: {e}"
        if proc.returncode != 0:
            return f"{' '.join(cmd)} failed:\n{proc.stderr}"
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    for fn in (lib.fill_polygons, lib.draw_polylines):
        fn.argtypes = [i32p, i32p, ctypes.c_int32, u8p, ctypes.c_int32,
                       ctypes.c_int32, ctypes.c_uint8]
        fn.restype = None
    return lib


def _state() -> Union[ctypes.CDLL, str]:
    if SRC not in _built:
        _built[SRC] = _build(SRC)
    return _built[SRC]


def _get() -> ctypes.CDLL:
    """The loaded library; raises RuntimeError with the compiler's output
    when the build failed."""
    lib = _state()
    if isinstance(lib, str):
        raise RuntimeError(f"the native rasterizer did not build: {lib}")
    return lib


def available() -> bool:
    return not isinstance(_state(), str)


def build_error() -> Optional[str]:
    lib = _state()
    return lib if isinstance(lib, str) else None


def _pack(polys: Iterable[np.ndarray]) -> Tuple[np.ndarray, np.ndarray, int]:
    arrs = [np.ascontiguousarray(np.asarray(p, np.int32).reshape(-1, 2))
            for p in polys]
    lens = np.asarray([len(a) for a in arrs], np.int32)
    pts = (np.concatenate(arrs).reshape(-1) if arrs
           else np.zeros(0, np.int32))
    return np.ascontiguousarray(pts), lens, len(arrs)


def _draw(symbol: str, polys, shape: Tuple[int, int]) -> np.ndarray:
    fn = getattr(_get(), symbol)
    out = np.zeros(shape, np.uint8)
    pts, lens, n = _pack(polys)
    if n:
        fn(pts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
           lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
           n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
           shape[0], shape[1], 1)
    return out


def fill_polygons(polys, shape: Tuple[int, int]) -> np.ndarray:
    """(h, w) uint8 mask of the even-odd fills of int pixel polygons."""
    return _draw("fill_polygons", polys, shape)


def draw_polylines(lines, shape: Tuple[int, int]) -> np.ndarray:
    """(h, w) uint8 mask of 1-px open Bresenham polylines."""
    return _draw("draw_polylines", lines, shape)


def enable():
    """Route bevgen_torch.data.rasterize through the native core."""
    os.environ["BEVGEN_NATIVE_RASTER"] = "1"
