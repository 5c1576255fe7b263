// Kernel 1: square/rectangular DIA (stencil) SpMV, float and double; the
// plain mode also in complex64 and complex128 (ts_common.cuh's TsComplex:
// products (ac - bd, ad + bc), each operation rounded on its own); both
// modes also on bf16 data, with a float x (float y) or a bf16 x (bf16 y).
//
// Replaces tpu_sparse/kernels/pallas_spmv.py: `_dia_kernel` (plain SpMV,
// entry `dia_spmv_pallas`), `_dia_ext_kernel` / `_dia_ext_kernel_res`
// (halo-extended operator, `ExtendedStencilOperator._apply`) and, as the
// double instance, `_dia_ext_kernel_df` / `_dia_ext_kernel_df_res` (the
// double-f32 operator `ExtendedStencilOperatorDF`): the H100 has native
// fp64, so the hi/lo pair arithmetic is gone.
//
// y[i] = sum_d data[d, i] * x[i + offsets[d]]
//
// bf16 data streams at 2 bytes a value and is widened to float in
// registers (exact), the products and the sum run in float, and a bf16 y is
// rounded once. With a float x this is what the JAX kernel computes after
// casting the data to float (pallas_spmv.py:183-191, `dia_spmv_pallas`;
// the extended mode's body casts each data row to x's dtype), with no
// float copy of the data: on bf16-exact values it is the float build's
// result bit for bit. With a bf16 x the TPU kernel summed in bf16; here the
// sum stays in float and only y is rounded.
//
// Bound: device-memory bandwidth. Each row streams ndiag matrix values
// plus one x read and one y write: sizeof(T) * (ndiag + 2) bytes per row
// (27-point stencil in float: 116 B/row; complex64 232, complex128 464;
// bf16 data with a float x 62, with a bf16 x 58).
// x is re-read ndiag times, but neighbouring diagonals of one block touch
// neighbouring rows of x, so those reads hit L1/L2 and only the first
// touch costs device memory.
//
// Design: one thread per row in a grid-stride loop; thread i reads
// data[d, i] for each d, so every diagonal read is coalesced along i. The
// offsets ride by value in the parameters (at most TS_MAX_DIAG; the host
// entry refuses more rather than truncating). The plain mode bounds-masks
// each column; the extended mode works on vectors [0..0 | x | 0..0] whose
// margins (>= the bandwidth) are zero, so it needs no masks and writes
// the output margins as zero. No Pallas chunk/halo-window structure is
// carried over: the TPU staged x windows through VMEM by DMA; here the
// caches do that work.

#include "ts_common.cuh"

// V: the data's type; X: x's and y's type.
template <typename V, typename X>
__global__ void __launch_bounds__(TS_BLOCK)
dia_spmv_plain_kernel(const V* __restrict__ data, long long ld, TsOffsets offs,
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
__global__ void __launch_bounds__(TS_BLOCK)
dia_spmv_ext_kernel(const V* __restrict__ data, long long ld, TsOffsets offs,
                    int ndiag, const X* __restrict__ x_ext,
                    X* __restrict__ y_ext, long long n, long long wl,
                    long long e) {
  using A = ts_acc_t<V, X>;
  __shared__ int s_off[TS_MAX_DIAG];
  ts_load_offsets(offs, ndiag, s_off);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < e;
       t += stride) {
    const long long i = t - wl;
    if (i < 0 || i >= n) {
      y_ext[t] = ts_zero<X>();
      continue;
    }
    A acc = A(0);
    for (int d = 0; d < ndiag; ++d)
      acc += ts_widen(data[d * ld + i]) * ts_widen(x_ext[t + s_off[d]]);
    y_ext[t] = ts_narrow<X>(acc);
  }
}

template <typename V, typename X>
static int launch_dia_spmv(const V* data, long long ld, const int* offsets,
                           int ndiag, const X* x, X* y, long long n_rows,
                           long long n_cols, long long wl, long long e,
                           int extended, cudaStream_t stream) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs)) return TS_BAD_ARGUMENT;
  if (n_rows < 0 || n_cols < 0 || ld < n_rows) return TS_BAD_ARGUMENT;
  if (extended) {
    if (wl < 0 || e != 2 * wl + n_rows || n_rows != n_cols) return TS_BAD_ARGUMENT;
    for (int d = 0; d < ndiag; ++d) {
      if (offs.o[d] > wl || -offs.o[d] > wl) return TS_BAD_ARGUMENT;
    }
    if (e == 0) return 0;
    dia_spmv_ext_kernel<V, X><<<ts_grid_for(e), TS_BLOCK, 0, stream>>>(
        data, ld, offs, ndiag, x, y, n_rows, wl, e);
  } else {
    if (n_rows == 0) return 0;
    dia_spmv_plain_kernel<V, X><<<ts_grid_for(n_rows), TS_BLOCK, 0, stream>>>(
        data, ld, offs, ndiag, x, y, n_rows, n_cols);
  }
  return (int)cudaGetLastError();
}

extern "C" int ts_dia_spmv_f32(const float* data, long long ld,
                               const int* offsets, int ndiag, const float* x,
                               float* y, long long n_rows, long long n_cols,
                               long long wl, long long e, int extended,
                               cudaStream_t stream) {
  return launch_dia_spmv<float, float>(data, ld, offsets, ndiag, x, y, n_rows, n_cols,
                                wl, e, extended, stream);
}

extern "C" int ts_dia_spmv_f64(const double* data, long long ld,
                               const int* offsets, int ndiag, const double* x,
                               double* y, long long n_rows, long long n_cols,
                               long long wl, long long e, int extended,
                               cudaStream_t stream) {
  return launch_dia_spmv<double, double>(data, ld, offsets, ndiag, x, y, n_rows,
                                 n_cols, wl, e, extended, stream);
}

// Plain mode only: the extended (fused) paths stay real.
extern "C" int ts_dia_spmv_c64(const ts_c64* data, long long ld,
                               const int* offsets, int ndiag, const ts_c64* x,
                               ts_c64* y, long long n_rows, long long n_cols,
                               long long wl, long long e, int extended,
                               cudaStream_t stream) {
  if (extended) return TS_BAD_ARGUMENT;
  return launch_dia_spmv<ts_c64, ts_c64>(data, ld, offsets, ndiag, x, y, n_rows,
                                 n_cols, wl, e, 0, stream);
}

extern "C" int ts_dia_spmv_c128(const ts_c128* data, long long ld,
                                const int* offsets, int ndiag,
                                const ts_c128* x, ts_c128* y, long long n_rows,
                                long long n_cols, long long wl, long long e,
                                int extended, cudaStream_t stream) {
  if (extended) return TS_BAD_ARGUMENT;
  return launch_dia_spmv<ts_c128, ts_c128>(data, ld, offsets, ndiag, x, y, n_rows,
                                  n_cols, wl, e, 0, stream);
}

// bf16 data, both modes: with a bf16 x (y bf16) and with a float x (y
// float); the sum runs in float either way.
extern "C" int ts_dia_spmv_bf16(const ts_bf16* data, long long ld,
                                const int* offsets, int ndiag,
                                const ts_bf16* x, ts_bf16* y, long long n_rows,
                                long long n_cols, long long wl, long long e,
                                int extended, cudaStream_t stream) {
  return launch_dia_spmv<ts_bf16, ts_bf16>(data, ld, offsets, ndiag, x, y,
                                           n_rows, n_cols, wl, e, extended,
                                           stream);
}

extern "C" int ts_dia_spmv_bf16_f32(const ts_bf16* data, long long ld,
                                    const int* offsets, int ndiag,
                                    const float* x, float* y, long long n_rows,
                                    long long n_cols, long long wl,
                                    long long e, int extended,
                                    cudaStream_t stream) {
  return launch_dia_spmv<ts_bf16, float>(data, ld, offsets, ndiag, x, y,
                                         n_rows, n_cols, wl, e, extended,
                                         stream);
}

extern "C" const char* ts_error_string(int code) {
  if (code == TS_BAD_ARGUMENT) return "argument refused by the kernel's host entry";
  return cudaGetErrorString((cudaError_t)code);
}
