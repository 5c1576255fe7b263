// K4 / K5: general-structure SpMV on the CWELL pack, float and double.
//
// Replaces tpu_sparse/kernels/pallas_cwell.py: `_cwell_kernel` and its
// grouped form `_cwell_kernel_gq` (K4, entry `cwell_spmv_pallas`, call in
// `_cwell_spmv_inner`), and, as the double instance, `_cwell_kernel_df` /
// `_cwell_kernel_df_gq` (K5, entry `cwell_spmv_pallas_df`, call in
// `_cwell_df_inner`). The H100 has native fp64, so K5's hi/lo pairs and
// compensated sums are gone: the double build accumulates in double.
//
// y[b*128 + l] = sum_s vals[b, s, l] * x[srow[b, s] * 128 + idx2[b, s, l]]
// with columns at or past m gathering 0 (the plain version's fill rule).
//
// Bound: device-memory bandwidth. Every slot streams its value and its
// 4-byte index once, every plane its 4-byte window row; x (16 MB in float
// at n = 160^3) is gathered and stays in the 50 MB L2, y is written once.
// Each padding slot costs as much as an entry, so the fill of the pack
// (0.66 for the 27-point stencil as a general matrix) sets how far this
// kernel sits above a CSR matvec of the same matrix.
//
// Design: one block of 128 threads per row block, thread l owning output
// row b*128 + l and looping over the planes, so each plane's vals and idx2
// reads are 128 consecutive elements (coalesced) and its srow read is one
// address per warp (a broadcast). The streamed arrays are read with the
// evict-first hint (__ldcs) so that x keeps its place in L2. Offsets are
// 64-bit; there are no atomics, so reruns give the same bits. None of the
// TPU limits carries over (x held in VMEM, row-block picking, the window
// budget, planes % 8): every pack runs, grouped packs too, since every
// plane of a grouped run carries the run's window row.

#include "ts_common.cuh"

#define TS_CWELL_LANES 128
#define TS_CWELL_MAX_GRID (1 << 20)

template <typename T>
__global__ void __launch_bounds__(TS_CWELL_LANES)
cwell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ idx2,
                  const int* __restrict__ srow, const T* __restrict__ x,
                  T* __restrict__ y, long long n_blocks, int planes,
                  long long n_rows, long long n_cols) {
  const int lane = threadIdx.x;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long plane0 = b * planes;
    const T* v = vals + plane0 * TS_CWELL_LANES + lane;
    const int* ix = idx2 + plane0 * TS_CWELL_LANES + lane;
    const int* sr = srow + plane0;
    T acc = T(0);
#pragma unroll 4
    for (int s = 0; s < planes; ++s) {
      const long long off = (long long)s * TS_CWELL_LANES;
      const long long col =
          (long long)__ldg(sr + s) * TS_CWELL_LANES + __ldcs(ix + off);
      const T a = __ldcs(v + off);
      const T xv = (col >= 0 && col < n_cols) ? __ldg(x + col) : T(0);
      acc += a * xv;
    }
    const long long row = b * TS_CWELL_LANES + lane;
    if (row < n_rows) y[row] = acc;
  }
}

template <typename T>
static int launch_cwell_spmv(const T* vals, const int* idx2, const int* srow,
                             const T* x, T* y, long long n_blocks,
                             long long planes, long long n_rows,
                             long long n_cols, cudaStream_t stream) {
  if (n_blocks < 0 || planes < 0 || planes > 0x7fffffffLL || n_rows < 0 ||
      n_cols < 0 || n_rows > n_blocks * TS_CWELL_LANES)
    return TS_BAD_ARGUMENT;
  if (n_rows == 0) return 0;
  const long long grid =
      n_blocks < TS_CWELL_MAX_GRID ? n_blocks : TS_CWELL_MAX_GRID;
  cwell_spmv_kernel<T><<<(int)grid, TS_CWELL_LANES, 0, stream>>>(
      vals, idx2, srow, x, y, n_blocks, (int)planes, n_rows, n_cols);
  return (int)cudaGetLastError();
}

extern "C" int ts_cwell_spmv_f32(const float* vals, const int* idx2,
                                 const int* srow, const float* x, float* y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long n_cols,
                                 cudaStream_t stream) {
  return launch_cwell_spmv<float>(vals, idx2, srow, x, y, n_blocks, planes,
                                  n_rows, n_cols, stream);
}

extern "C" int ts_cwell_spmv_f64(const double* vals, const int* idx2,
                                 const int* srow, const double* x, double* y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long n_cols,
                                 cudaStream_t stream) {
  return launch_cwell_spmv<double>(vals, idx2, srow, x, y, n_blocks, planes,
                                   n_rows, n_cols, stream);
}
