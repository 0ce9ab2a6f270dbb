"""bevgen_torch: BEVGen multi-view street-scene generation in PyTorch + CUDA.

A port of the JAX package `bevgen_tpu` (which stays the reference) to one
NVIDIA Hopper card. The layout mirrors the reference so every module has a
counterpart: `core/`, `models/stage1/`, `models/stage2/`, `ops/`,
`pipelines/`, `data/`, `scripts/`. Hand-written kernels live in `csrc/` and
are built with nvcc at first use (`ops/_build.py`).
"""
