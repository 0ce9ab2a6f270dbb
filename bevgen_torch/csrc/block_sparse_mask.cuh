// The keep rule of the block-sparse attention, shared by its forward
// (block_sparse.cu) and backward (block_sparse_bwd.cu) kernels: a (query
// row, key column) pair with column < L is kept when the head's layout keeps
// its block,
//
//   layout_row(layout, h, nb, row, block)[col / block] != 0,
//
// and the index rule of the AR sequence allows it (`BLOCK_SPARSE_ALLOWED`,
// the TPU kernels' `_allowed_tile`, bevgen_tpu/ops/pallas/block_sparse.py:77):
// condition columns `< nc`, the causal band `col <= row`, and pad rows
// (`row >= pad_start`) that see only column 0. The callers look up the
// layout byte and pass the pad flag themselves, so that what depends only on
// the row or only on the column is computed once, outside the inner loops.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace block_sparse {

// The layout row (nb bytes) of query row `row` in head h. Rows past the
// layout, in the ragged last tile, are clamped to its last row, so every
// read stays in bounds; such rows are never stored.
__device__ __forceinline__ const uint8_t* layout_row(const uint8_t* layout,
                                                     int h, int nb, int row,
                                                     int block) {
  return layout + (static_cast<size_t>(h) * nb + min(row / block, nb - 1)) * nb;
}

}  // namespace block_sparse

// The index rule for (row, col); pad = row >= pad_start. A macro and not an
// inline function: written out in place it compiles the forward kernel to
// the same machine code as before the rule was shared, where an inline
// function made nvcc emit 128 more instructions and the forward 10-14%
// slower on the H100 (block_sparse.cu at nuscenes_ar, same-call A/B).
#define BLOCK_SPARSE_ALLOWED(pad, row, col, nc) \
  ((pad) ? (col) == 0 : ((col) < (nc) || (col) <= (row)))
