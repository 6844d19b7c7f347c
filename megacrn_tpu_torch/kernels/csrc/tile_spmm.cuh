// The 128x128 tile product shared by the port's block-sparse SpMM kernels
// (spmm_coo.cu, spmm_ell.cu): one CUDA block of kThreads threads owns one
// (row-block, kBN-feature) output tile, keeps its f32 sum in registers,
// adds tile @ x-slab for every tile of its row-block, and writes once.
//
// Per thread: kTM x kTN outputs (rows ty + 16 * i, columns tx + 16 * j).
// The tile and the x slab are staged in kBK-deep chunks through shared
// memory, so each value read from shared memory feeds kTN or kTM FMAs. Tiles
// are multiplied as if dense, on the FP32 FMA path, for f32 and bf16 alike
// (bf16 is widened on load); the known cost of that is noted in each kernel.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace tile_spmm {

constexpr int kBlock = 128;    // tile edge: output rows per block, tile depth
constexpr int kBN = 64;        // feature columns per block
constexpr int kBK = 32;        // depth of one staged chunk of a tile
constexpr int kThreads = 256;  // 16 row lanes x 16 column lanes
constexpr int kTM = kBlock / 16;  // 8 output rows per thread
constexpr int kTN = kBN / 16;     // 4 output columns per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, like torch's cast
}

// Shared-memory staging of one chunk: a[k][r] = tile[r][k0 + k] (transposed;
// the +1 pad keeps the transposing store free of bank conflicts),
// x[k][n] = x slab.
struct Stage {
  float a[kBK][kBlock + 1];
  float x[kBK][kBN];
};

// acc += tile @ x[x_row0 : x_row0 + kBlock, j0 : j0 + kBN]. Rows of x at or
// past n_col_orig are read as zero and never loaded (a zero tile times
// uninitialised padding could give NaN); columns at or past f likewise.
template <typename T>
__device__ __forceinline__ void accumulate_tile(
    const T* __restrict__ tile, const T* __restrict__ x, int64_t x_row0,
    int n_col_orig, int f, int j0, Stage& s, float (&acc)[kTM][kTN]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  for (int k0 = 0; k0 < kBlock; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kBlock * kBK / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kBK, c = e % kBK;
      s.a[c][r] = to_f32(tile[r * kBlock + k0 + c]);
    }
#pragma unroll
    for (int i = 0; i < kBK * kBN / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int kk = e / kBN, n = e % kBN;
      const int64_t row = x_row0 + k0 + kk;
      const int col = j0 + n;
      s.x[kk][n] = (row < n_col_orig && col < f) ? to_f32(x[row * f + col])
                                                 : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = s.a[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = s.x[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// y[rb * kBlock + ., j0 + .] = acc in y's type, only rows < n_orig and
// columns < f.
template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ y,
                                           const float (&acc)[kTM][kTN],
                                           int rb, int n_orig, int f, int j0) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int64_t row0 = static_cast<int64_t>(rb) * kBlock;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t row = row0 + ty + 16 * i;
    if (row >= n_orig) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = j0 + tx + 16 * j;
      if (col < f) store(&y[row * f + col], acc[i][j]);
    }
  }
}

}  // namespace tile_spmm
