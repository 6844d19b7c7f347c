// Block-COO SpMM for Hopper (sm_90a): y = A @ x for the packs of
// megacrn_tpu_torch/kernels/spmm_coo.py (BlockCOO, the StackedRoadPack).
//
// Replaces the TPU kernel megacrn_tpu/kernels/spmm_coo.py:_spmm_coo_kernel
// (launched by _spmm_coo_padded). That kernel swept the sorted 128x128 tiles
// in one ordered grid, multiplied each as if dense on the matrix unit, and
// flushed a VMEM accumulator whenever the row index changed. On the road
// graphs the port serves, the stored tiles are about 0.4% nonzero (29,376
// nonzeros in 450 tiles for the EXPY-TKY-sized stacked pack), so a dense tile
// product does some 250 times the work the function needs. This kernel
// reads instead the pack's nonzero list (nz_row_ptr / nz_cols / nz_vals,
// built once on the host from the same tiles by kernels/row_spmm.py) and
// multiplies only the nonzeros, through row_spmm.cuh's body, which it
// shares with spmm_ell.cu. CUDA blocks run in no order, so each warp owns
// one output row outright: no flush, no atomics, no cross-block order.
//
// What bounds it: the function needs 2 * nnz * f flops, far below the card's
// rate, and bytes: x read once, y written once, the nonzeros (nnz * (4 + elem
// size)) and the row pointers. Gathering x rows per nonzero also reads about
// nnz * f * elem_size bytes from L2 (e.g. ~248 MB at f = 2112 in f32), about
// four times the x and y traffic, so L2 bandwidth is the second limit. The
// design keeps that traffic in L2 and not HBM by running the CTAs in flight
// over one feature slab at a time (see row_spmm.cuh), and keeps each x access
// at 16 bytes a lane, 512 bytes a warp.
//
// As in row_spmm.cuh: zeros are not multiplied, so a non-finite value in x
// reaches only the rows that reference it, where the TPU kernel and the
// plain versions (which multiply whole tiles) spread it over its row-block.
//
// The backward of y = A @ x (dx = A^T g) is this same kernel on the
// transposed pack (kernels/spmm_coo.py:SpmmCOOFunction).
#include "row_spmm.cuh"

// Plain C interface, loaded with ctypes. Each computes the first n_rows rows
// of y, returns the launch's cudaGetLastError() (0 = launched) and never
// synchronises.
extern "C" {

int spmm_coo_f32(const void* nz_row_ptr, const void* nz_cols,
                 const void* nz_vals, const void* x, void* y, int n_rows,
                 int f, void* stream) {
  return row_spmm::launch<float>(nz_row_ptr, nz_cols, nz_vals, x, y, n_rows,
                                 f, stream);
}

int spmm_coo_bf16(const void* nz_row_ptr, const void* nz_cols,
                  const void* nz_vals, const void* x, void* y, int n_rows,
                  int f, void* stream) {
  return row_spmm::launch<__nv_bfloat16>(nz_row_ptr, nz_cols, nz_vals, x, y,
                                         n_rows, f, stream);
}

const char* spmm_coo_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
