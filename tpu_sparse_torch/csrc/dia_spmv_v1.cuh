// Kernel 1's first plain-mode design (DIA SpMV), kept as the yardstick and
// the bit-for-bit reference of the redesign in dia_spmv.cu. The design
// probe (`python3 -m tpu_sparse_torch.kernels.dia_spmv_probe`) times it
// beside the candidates; the library exports it as `ts_dia_spmv_v1_*`
// (`cuda_spmv.dia_spmv_v1_cuda`) for the card tests and the smoke run.
// Nothing on a solver path launches it.
//
// Design: one thread per row in a grid-stride loop over at most
// TS_MAX_GRID blocks of TS_BLOCK threads; thread i reads data[d, i] for
// each d (coalesced along i), the offsets from shared memory, and tests
// every column against [0, n_cols).
#pragma once

#include "ts_common.cuh"

// V: the data's type; X: x's and y's type.
template <typename V, typename X>
__global__ void __launch_bounds__(TS_BLOCK)
dia_spmv_v1_kernel(const V* __restrict__ data, long long ld, TsOffsets offs,
                   int ndiag, const X* __restrict__ x, X* __restrict__ y,
                   long long n_rows, long long n_cols) {
  using A = ts_acc_t<V, X>;
  __shared__ int s_off[TS_MAX_DIAG];
  ts_load_offsets(offs, ndiag, s_off);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_rows; i += stride) {
    A acc = A(0);
    for (int d = 0; d < ndiag; ++d) {
      const long long j = i + s_off[d];
      if (j >= 0 && j < n_cols)
        acc += ts_widen(data[d * ld + i]) * ts_widen(x[j]);
    }
    y[i] = ts_narrow<X>(acc);
  }
}

template <typename V, typename X>
static int launch_dia_spmv_v1(const V* data, long long ld, const int* offsets,
                              int ndiag, const X* x, X* y, long long n_rows,
                              long long n_cols, cudaStream_t stream) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs)) return TS_BAD_ARGUMENT;
  if (n_rows < 0 || n_cols < 0 || ld < n_rows) return TS_BAD_ARGUMENT;
  if (n_rows == 0) return 0;
  dia_spmv_v1_kernel<V, X><<<ts_grid_for(n_rows), TS_BLOCK, 0, stream>>>(
      data, ld, offs, ndiag, x, y, n_rows, n_cols);
  return (int)cudaGetLastError();
}
