// The row-wise product over a nonzero list shared by the port's SpMM kernels
// (spmm_coo.cu, spmm_ell.cu): y = A @ x, with A given as a CSR of its
// nonzeros (nz_row_ptr, nz_cols, nz_vals) that the host builds once from
// either pack's tiles (kernels/row_spmm.py:nonzero_rows). Only these three
// arrays, x and y are read or written; the 128x128 tiles are not.
//
// Work split: one warp owns one output row and one slab of 32 * kV feature
// columns (kV = 16 bytes of T: 4 f32 or 8 bf16). blockIdx.x runs over
// groups of kWarps rows and is the fastest grid index, blockIdx.y over
// slabs, so the CTAs in flight share one slab and the x rows they gather
// stay in L2 (at f = 4224 the whole f32 x is 65 MB, more than the 50 MB L2;
// one 128-column slab of it is 2 MB).
//
// Per chunk of 32 nonzeros of its row, each lane loads one (col, val) pair
// and the warp broadcasts them one by one with __shfl_sync. For each
// nonzero every lane reads 16 bytes of x's row (one float4 or 8 bf16, 512
// bytes a warp, coalesced) and adds val * x into f32 registers. The slab is
// written once, with 16-byte stores. There is no shared memory, no atomic
// and no __syncthreads: each output element is summed by one thread in
// nonzero order, so the result is the same from run to run. bf16 is widened
// on load and rounded once at the store, as the plain versions sum in f32.
// A row with no nonzero (an empty row-block, the padded rows of a stacked
// pack, block-ELL's nnz_blocks == 0) writes zeros.
//
// Where f is not a multiple of kV, or x or y is not 16-byte aligned, the
// launch takes the scalar variant of the same kernel: lane l reads and
// writes columns l, l + 32, ... of the slab, one element at a time, still
// coalesced.
//
// Zeros are never multiplied. The TPU kernels and both plain versions
// multiply whole tiles, so there one non-finite value in x poisons every
// output row of its row-block; here it reaches only the rows whose nonzeros
// reference that x row. On finite x the two functions are equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace row_spmm {

constexpr int kWarps = 8;  // output rows per CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, like torch's cast
}

// 16 bytes of T, widened to f32 on load and rounded back on store.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
  __device__ __forceinline__ static void store(float* p,
                                               const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&v)[8]) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&v)[8]) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    }
    *reinterpret_cast<uint4*>(p) = q;
  }
};

// kVector: lane l owns columns j0 + l * kV .. + kV (one 16-byte access);
// otherwise columns j0 + l + 32 * i, i < kV (scalar accesses).
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
    row_spmm_kernel(const int* __restrict__ row_ptr,
                    const int* __restrict__ cols, const T* __restrict__ vals,
                    const T* __restrict__ x, T* __restrict__ y, int n_rows,
                    int f) {
  constexpr int kV = Vec<T>::kN;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= n_rows) return;  // the whole warp: row is warp-uniform
  const int j0 = blockIdx.y * (32 * kV);
  const int jv = j0 + lane * kV;  // kVector: f % kV == 0, so all or none
  float acc[kV] = {};
  const int end = row_ptr[row + 1];
  for (int base = row_ptr[row]; base < end; base += 32) {
    int my_col = 0;
    float my_val = 0.f;
    if (base + lane < end) {
      my_col = cols[base + lane];
      my_val = to_f32(vals[base + lane]);
    }
    const int count = min(32, end - base);
#pragma unroll 4
    for (int k = 0; k < count; ++k) {
      const int col = __shfl_sync(kFullMask, my_col, k);
      const float a = __shfl_sync(kFullMask, my_val, k);
      const T* xr = x + static_cast<int64_t>(col) * f;
      if constexpr (kVector) {
        if (jv < f) {
          float v[kV];
          Vec<T>::load(xr + jv, v);
#pragma unroll
          for (int i = 0; i < kV; ++i) acc[i] = fmaf(a, v[i], acc[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kV; ++i) {
          const int j = j0 + lane + 32 * i;
          if (j < f) acc[i] = fmaf(a, to_f32(xr[j]), acc[i]);
        }
      }
    }
  }
  T* yr = y + static_cast<int64_t>(row) * f;
  if constexpr (kVector) {
    if (jv < f) Vec<T>::store(yr + jv, acc);
  } else {
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const int j = j0 + lane + 32 * i;
      if (j < f) store(yr + j, acc[i]);
    }
  }
}

// y[:n_rows] = A[:n_rows] @ x on `stream`; returns cudaGetLastError() of the
// launch (0 = launched) and never synchronises.
template <typename T>
int launch(const void* row_ptr, const void* cols, const void* vals,
           const void* x, void* y, int n_rows, int f, void* stream) {
  if (n_rows <= 0 || f <= 0) return 0;
  constexpr int kV = Vec<T>::kN;
  const int slabs = (f + 32 * kV - 1) / (32 * kV);
  if (slabs > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_rows + kWarps - 1) / kWarps, slabs);
  const bool vector = f % kV == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(y) % 16 == 0;
  void (*kernel)(const int*, const int*, const T*, const T*, T*, int, int) =
      vector ? &row_spmm_kernel<T, true> : &row_spmm_kernel<T, false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(row_ptr), static_cast<const int*>(cols),
      static_cast<const T*>(vals), static_cast<const T*>(x),
      static_cast<T*>(y), n_rows, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace row_spmm
