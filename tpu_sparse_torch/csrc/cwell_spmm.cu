// K6 / K7: general-structure SpMM Y = W B on the CWELL pack, float and
// double.
//
// Replaces tpu_sparse/kernels/pallas_cwell.py: `_cwell_spmm_gather_kernel`
// (K6, call in `_cwell_spmm_gather_impl`, entry `cwell_spmm_pallas_gather`)
// and `_cwell_spmm_kernel` / `_cwell_spmm_kernel_gq` (K7, call in
// `_cwell_spmm_inner`, entry `cwell_spmm_pallas`). Both compute the same
// function; K7 gathered through one-hot (128 x 256) products on the TPU's
// matrix unit, a device with no purpose here, so one kernel replaces both.
// The TPU kernels were float32 only; the double build takes the float64
// operands that the JAX package left to XLA.
//
// Y[b*128 + l, j] = sum_s vals[b, s, l] * B[srow[b, s]*128 + idx2[b, s, l], j]
// with columns at or past m gathering 0 (the plain version's fill rule).
// B (m, k) and Y (n, k) are row-major, so a gathered row of B is k
// contiguous values (the TPU kernel's transposed (k, m) layout served its
// lane axis and is not kept).
//
// Bound: device-memory bandwidth. The pack streams 8 bytes a slot in
// float (12 in double) plus 4 a plane; B and Y move 4 (8) bytes per value.
// At k = 8 on the 160^3 27-point pack the pack is 1.31 GB of the 1.58 GB
// the function must move. The gathered rows of B come from L2: a row
// block's columns span a narrow band of B.
//
// Design: one block of 128 threads per (row block, tile of CL columns of
// B), CL = 8, 16 or 32 (the smallest that covers k, 32 past it). The
// block stages the values and global columns of 8 planes at a time in
// shared memory (each plane's vals and idx2 read as 128 consecutive
// elements, its window row as one broadcast address), then thread (rs,
// cl) accumulates column cl of the CL rows rs, rs + 128/CL, ... in
// registers: consecutive lanes take consecutive columns of one gathered
// row of B, so a warp's gather is 32 * 4 contiguous bytes (CL = 32) or
// four rows of 32 (CL = 8), not 32 rows of one value each. Rows sum their
// planes in order, as K4 and the plain version do. Wider B takes ceil(k /
// 32) tiles, each re-reading the row block's pack; the tiles of one row
// block are neighbouring blocks of the grid, so those reads meet in L2.
// Offsets are 64-bit (col * k passes 2^31 at m = 4.1M, k = 128); there
// are no atomics, so reruns give the same bits. Every pack runs, grouped
// ones too: each plane carries its run's window row.

#include "ts_common.cuh"

#define TS_SPMM_LANES 128
#define TS_SPMM_STAGE 8
#define TS_SPMM_MAX_GRID (1 << 20)

template <typename T, int CL>
__global__ void __launch_bounds__(TS_SPMM_LANES)
cwell_spmm_kernel(const T* __restrict__ vals, const int* __restrict__ idx2,
                  const int* __restrict__ srow, const T* __restrict__ B,
                  T* __restrict__ Y, long long n_blocks, int planes,
                  long long n_rows, long long n_cols, int k) {
  constexpr int RS = TS_SPMM_LANES / CL;  // rows a pass of the block covers
  __shared__ T s_val[TS_SPMM_STAGE][TS_SPMM_LANES];
  __shared__ long long s_col[TS_SPMM_STAGE][TS_SPMM_LANES];
  const int tid = threadIdx.x;
  const int cl = tid % CL;
  const int rs = tid / CL;
  const int tiles = (k + CL - 1) / CL;
  const long long work = n_blocks * tiles;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const long long b = w / tiles;
    const int j = (int)(w - b * tiles) * CL + cl;
    const long long plane0 = b * planes;
    T acc[CL];
#pragma unroll
    for (int i = 0; i < CL; ++i) acc[i] = T(0);
    for (int s0 = 0; s0 < planes; s0 += TS_SPMM_STAGE) {
      const int cnt =
          planes - s0 < TS_SPMM_STAGE ? planes - s0 : TS_SPMM_STAGE;
      __syncthreads();  // the previous stage has been read
      for (int q = 0; q < cnt; ++q) {
        const long long p = plane0 + s0 + q;
        const long long off = p * TS_SPMM_LANES + tid;
        const long long col =
            (long long)__ldg(srow + p) * TS_SPMM_LANES + __ldg(idx2 + off);
        s_val[q][tid] = __ldg(vals + off);
        s_col[q][tid] = (col >= 0 && col < n_cols) ? col : -1;
      }
      __syncthreads();
      if (j < k) {
        for (int q = 0; q < cnt; ++q) {
#pragma unroll
          for (int i = 0; i < CL; ++i) {
            const int r = rs + i * RS;
            const long long c = s_col[q][r];
            if (c >= 0) acc[i] += s_val[q][r] * __ldg(B + c * k + j);
          }
        }
      }
    }
    if (j < k) {
#pragma unroll
      for (int i = 0; i < CL; ++i) {
        const long long row = b * TS_SPMM_LANES + rs + i * RS;
        if (row < n_rows) Y[row * k + j] = acc[i];
      }
    }
  }
}

template <typename T, int CL>
static void launch_tile(int grid, cudaStream_t stream, const T* vals,
                        const int* idx2, const int* srow, const T* B, T* Y,
                        long long n_blocks, long long planes,
                        long long n_rows, long long n_cols, long long k) {
  cwell_spmm_kernel<T, CL><<<grid, TS_SPMM_LANES, 0, stream>>>(
      vals, idx2, srow, B, Y, n_blocks, (int)planes, n_rows, n_cols, (int)k);
}

template <typename T>
static int launch_cwell_spmm(const T* vals, const int* idx2, const int* srow,
                             const T* B, T* Y, long long n_blocks,
                             long long planes, long long n_rows,
                             long long n_cols, long long k,
                             cudaStream_t stream) {
  if (n_blocks < 0 || planes < 0 || planes > 0x7fffffffLL || n_rows < 0 ||
      n_cols < 0 || k < 0 || k > 0x7fffffffLL ||
      n_rows > n_blocks * TS_SPMM_LANES)
    return TS_BAD_ARGUMENT;
  if (n_rows == 0 || k == 0) return 0;
  const int cl = k <= 8 ? 8 : (k <= 16 ? 16 : 32);
  const long long work = n_blocks * ((k + cl - 1) / cl);
  const int grid = (int)(work < TS_SPMM_MAX_GRID ? work : TS_SPMM_MAX_GRID);
  if (cl == 8)
    launch_tile<T, 8>(grid, stream, vals, idx2, srow, B, Y, n_blocks, planes,
                      n_rows, n_cols, k);
  else if (cl == 16)
    launch_tile<T, 16>(grid, stream, vals, idx2, srow, B, Y, n_blocks,
                       planes, n_rows, n_cols, k);
  else
    launch_tile<T, 32>(grid, stream, vals, idx2, srow, B, Y, n_blocks,
                       planes, n_rows, n_cols, k);
  return (int)cudaGetLastError();
}

extern "C" int ts_cwell_spmm_f32(const float* vals, const int* idx2,
                                 const int* srow, const float* B, float* Y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long n_cols,
                                 long long k, cudaStream_t stream) {
  return launch_cwell_spmm<float>(vals, idx2, srow, B, Y, n_blocks, planes,
                                  n_rows, n_cols, k, stream);
}

extern "C" int ts_cwell_spmm_f64(const double* vals, const int* idx2,
                                 const int* srow, const double* B, double* Y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long n_cols,
                                 long long k, cudaStream_t stream) {
  return launch_cwell_spmm<double>(vals, idx2, srow, B, Y, n_blocks, planes,
                                   n_rows, n_cols, k, stream);
}
