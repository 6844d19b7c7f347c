// Block-ELL SpMM for Hopper (sm_90a): y = A @ x, where A is stored per
// row-block as max_blocks 128x128 tiles (data) with their column-block
// indices (cols) and a count of the real ones (nnz_blocks), as packed by
// megacrn_tpu_torch/kernels/spmm.py:to_block_ell. Padding entries repeat a
// valid column with a zero tile.
//
// Replaces the TPU kernel megacrn_tpu/kernels/spmm.py:_spmm_kernel (launched
// by _spmm_padded). That kernel ran an ordered grid (row-block, feature
// tile, r < max_blocks) whose innermost axis swept every entry of the
// row-block, padding included, into a VMEM accumulator that it flushed at
// r == max_blocks - 1. Here each CUDA block owns one (row-block, 64-feature)
// output tile outright: it sums in f32 registers over r < nnz_blocks[i]
// only, so it never touches a padding tile, and writes its tile once. No
// atomics, no cross-block order. A row-block with nnz_blocks == 0 writes
// zeros.
//
// Edges are masked in the kernel, as in spmm_coo.cu: rows of x at or past
// n_col_orig are read as zero and never loaded, feature columns at or past f
// are neither loaded nor stored, and only the first n_orig output rows are
// written. Rectangular packs (n_col != n) need nothing more. So the wrapper
// copies and pads nothing.
//
// What bounds it: at the training slice's shapes (N=1843 road graph, one
// pack per support, every row-block holding all 15 column tiles, each tile
// ~0.4% nonzero, f = 2048..4224) the function is bound by its bytes (the
// ~14.7 MB of f32 tiles per support, x and y), not by its nonzero flops.
// This kernel multiplies every real tile as if dense (2*128*128*f flops per
// tile) through tile_spmm.cuh's product, the same as spmm_coo.cu's, so it
// runs at the FP32 FMA rate far above the byte bound. That waste is known
// and left on purpose: skipping the zeros inside a tile is later work, for
// both kernels. Also left: bf16 on the FP32 FMA path, synchronous loads.
//
// The backward of y = A @ x (dx = A^T g) is this same kernel on the
// transposed pack (kernels/spmm.py:SpmmELLFunction).
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_spmm.cuh"

namespace {

using namespace tile_spmm;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmm_ell_kernel(const int* __restrict__ cols,
                    const int* __restrict__ nnz_blocks,
                    const T* __restrict__ data, const T* __restrict__ x,
                    T* __restrict__ y, int max_blocks, int n_orig,
                    int n_col_orig, int f) {
  __shared__ Stage stage;
  const int rb = blockIdx.x;
  const int j0 = blockIdx.y * kBN;
  float acc[kTM][kTN] = {};
  const int64_t base = static_cast<int64_t>(rb) * max_blocks;
  const int nnz = min(nnz_blocks[rb], max_blocks);
  for (int r = 0; r < nnz; ++r) {
    accumulate_tile(data + (base + r) * kBlock * kBlock, x,
                    static_cast<int64_t>(cols[base + r]) * kBlock, n_col_orig,
                    f, j0, stage, acc);
  }
  store_tile(y, acc, rb, n_orig, f, j0);
}

template <typename T>
int launch(const void* cols, const void* nnz_blocks, const void* data,
           const void* x, void* y, int n_row_blocks, int max_blocks,
           int n_orig, int n_col_orig, int f, void* stream) {
  if (n_row_blocks <= 0 || n_orig <= 0 || f <= 0) return 0;
  const int f_tiles = (f + kBN - 1) / kBN;
  if (f_tiles > 65535 || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_row_blocks, f_tiles);
  spmm_ell_kernel<T><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(cols), static_cast<const int*>(nnz_blocks),
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), max_blocks, n_orig, n_col_orig, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns the launch's
// cudaGetLastError() (0 = launched) and never synchronises.
extern "C" {

int spmm_ell_f32(const void* cols, const void* nnz_blocks, const void* data,
                 const void* x, void* y, int n_row_blocks, int max_blocks,
                 int n_orig, int n_col_orig, int f, void* stream) {
  return launch<float>(cols, nnz_blocks, data, x, y, n_row_blocks,
                       max_blocks, n_orig, n_col_orig, f, stream);
}

int spmm_ell_bf16(const void* cols, const void* nnz_blocks, const void* data,
                  const void* x, void* y, int n_row_blocks, int max_blocks,
                  int n_orig, int n_col_orig, int f, void* stream) {
  return launch<__nv_bfloat16>(cols, nnz_blocks, data, x, y, n_row_blocks,
                               max_blocks, n_orig, n_col_orig, f, stream);
}

const char* spmm_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
