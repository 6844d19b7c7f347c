// Block-COO SpMM for Hopper (sm_90a): y = A @ x, where A is a row-sorted
// flat list of nonzero 128x128 tiles (rows / cols / data) with a CSR
// row_ptr over the tiles, as packed by
// megacrn_tpu_torch/kernels/spmm_coo.py:to_block_coo.
//
// Replaces the TPU kernel megacrn_tpu/kernels/spmm_coo.py:_spmm_coo_kernel
// (launched by _spmm_coo_padded). That kernel swept the tiles in one ordered
// grid and reset / flushed a VMEM accumulator whenever the row index
// changed. CUDA blocks run in no order, so here each CUDA block owns one
// (row-block, feature-tile) output tile outright: it zeroes an f32
// accumulator in registers, loops over its own tile segment
// [row_ptr[r], row_ptr[r+1]), and writes once in the output type. No
// atomics, no cross-block order. An empty segment writes zeros, so the zero
// tile the pack keeps for an empty row-block is not relied on.
//
// Edges are masked in the kernel: rows of x at or past n_col_orig are read
// as zero and never loaded (a zero tile times uninitialised padding could
// give NaN), feature columns at or past f are neither loaded nor stored,
// and only the first n_orig output rows are written.
//
// What bounds it: at the serving slice's shapes (N=1843 road graph packed
// block-diagonally over 2 supports, 450 stored tiles, f = 2048..4224) the
// stored tiles are only ~0.4% nonzero, so the function itself is bound by
// its bytes (the ~29.5 MB of f32 tiles, x and y: ~6 GB per 64-window
// forward), not by its ~9 GFLOP of nonzero work. This design multiplies
// every stored tile as if it were dense (2*128*128*f flops per tile, ~2.2
// TFLOP per forward), so it runs at the FP32 FMA rate of the CUDA cores,
// far above the byte bound. The tile product itself (128 x 64 output tile
// per block, 8 x 4 outputs per thread in registers, 32-deep staged chunks)
// is tile_spmm.cuh's, shared with the block-ELL kernel spmm_ell.cu.
//
// What this simple design leaves for later: skipping the zeros inside a
// stored tile (the work the data needs is 2*nnz*f flops); bf16 goes through
// the FP32 FMA path; loads are synchronous (no cp.async / TMA double
// buffering); every feature tile re-reads its row-block's tiles (from L2);
// scalar rather than vector loads.
//
// The backward of y = A @ x (dx = A^T g) is this same kernel on the
// transposed pack (kernels/spmm_coo.py:SpmmCOOFunction).
#include <cuda_runtime.h>

#include <cstdint>

#include "tile_spmm.cuh"

namespace {

using namespace tile_spmm;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    spmm_coo_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ cols, const T* __restrict__ data,
                    const T* __restrict__ x, T* __restrict__ y, int n_orig,
                    int n_col_orig, int f) {
  __shared__ Stage stage;
  const int rb = blockIdx.x;
  const int j0 = blockIdx.y * kBN;
  float acc[kTM][kTN] = {};
  const int t_end = row_ptr[rb + 1];
  for (int t = row_ptr[rb]; t < t_end; ++t) {
    accumulate_tile(data + static_cast<int64_t>(t) * kBlock * kBlock, x,
                    static_cast<int64_t>(cols[t]) * kBlock, n_col_orig, f, j0,
                    stage, acc);
  }
  store_tile(y, acc, rb, n_orig, f, j0);
}

template <typename T>
int launch(const void* row_ptr, const void* cols, const void* data,
           const void* x, void* y, int n_row_blocks, int n_orig,
           int n_col_orig, int f, void* stream) {
  if (n_row_blocks <= 0 || n_orig <= 0 || f <= 0) return 0;
  const int f_tiles = (f + kBN - 1) / kBN;
  if (f_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(n_row_blocks, f_tiles);
  spmm_coo_kernel<T><<<grid, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n_orig, n_col_orig, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, loaded with ctypes. Each returns the launch's
// cudaGetLastError() (0 = launched) and never synchronises.
extern "C" {

int spmm_coo_f32(const void* row_ptr, const void* cols, const void* data,
                 const void* x, void* y, int n_row_blocks, int n_orig,
                 int n_col_orig, int f, void* stream) {
  return launch<float>(row_ptr, cols, data, x, y, n_row_blocks, n_orig,
                       n_col_orig, f, stream);
}

int spmm_coo_bf16(const void* row_ptr, const void* cols, const void* data,
                  const void* x, void* y, int n_row_blocks, int n_orig,
                  int n_col_orig, int f, void* stream) {
  return launch<__nv_bfloat16>(row_ptr, cols, data, x, y, n_row_blocks,
                               n_orig, n_col_orig, f, stream);
}

const char* spmm_coo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
