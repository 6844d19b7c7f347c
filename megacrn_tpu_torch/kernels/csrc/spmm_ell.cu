// Block-ELL SpMM for Hopper (sm_90a): y = A @ x for the packs of
// megacrn_tpu_torch/kernels/spmm.py (BlockELL, one per road support).
//
// Replaces the TPU kernel megacrn_tpu/kernels/spmm.py:_spmm_kernel (launched
// by _spmm_padded). That kernel ran an ordered grid (row-block, feature
// tile, r < max_blocks) whose innermost axis swept every stored tile of a
// row-block, padding included, multiplied each as if dense on the matrix
// unit, and flushed a VMEM accumulator at r == max_blocks - 1. On the road
// graphs the port trains on, each tile is about 0.4% nonzero (14,688
// nonzeros in 225 tiles per support at EXPY-TKY's size). This kernel reads
// instead the pack's nonzero list (nz_row_ptr / nz_cols / nz_vals), built
// once on the host by kernels/row_spmm.py from the real tiles only
// (r < nnz_blocks[i]), so padding tiles and the zeros inside a tile cost
// nothing, and multiplies only the nonzeros through row_spmm.cuh's body,
// the same as spmm_coo.cu's. A row-block with nnz_blocks == 0 has no entry
// and writes zeros. Rectangular packs need nothing more.
//
// What bounds it: the function needs 2 * nnz * f flops, far below the card's
// rate, and bytes: x read once, y written once, the nonzeros (nnz * (4 + elem
// size)) and the row pointers. Gathering x rows per nonzero also reads about
// nnz * f * elem_size bytes from L2 (e.g. ~124 MB at f = 2112 in f32), about
// four times the x and y traffic, so L2 bandwidth is the second limit. The
// design keeps that traffic in L2 by running the CTAs in flight over one
// feature slab at a time (see row_spmm.cuh), at 16 bytes a lane.
//
// As in row_spmm.cuh: zeros are not multiplied, so a non-finite value in x
// reaches only the rows that reference it, where the TPU kernel and the
// plain version (which multiply whole tiles) spread it over its row-block.
//
// The backward of y = A @ x (dx = A^T g) is this same kernel on the
// transposed pack (kernels/spmm.py:SpmmELLFunction).
#include "row_spmm.cuh"

// Plain C interface, loaded with ctypes. Each computes the first n_rows rows
// of y, returns the launch's cudaGetLastError() (0 = launched) and never
// synchronises.
extern "C" {

int spmm_ell_f32(const void* nz_row_ptr, const void* nz_cols,
                 const void* nz_vals, const void* x, void* y, int n_rows,
                 int f, void* stream) {
  return row_spmm::launch<float>(nz_row_ptr, nz_cols, nz_vals, x, y, n_rows,
                                 f, stream);
}

int spmm_ell_bf16(const void* nz_row_ptr, const void* nz_cols,
                  const void* nz_vals, const void* x, void* y, int n_rows,
                  int f, void* stream) {
  return row_spmm::launch<__nv_bfloat16>(nz_row_ptr, nz_cols, nz_vals, x, y,
                                         n_rows, f, stream);
}

const char* spmm_ell_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
