// The first designs of K6 / K7 (CWELL SpMM on the plane pack) and K8
// (BELL SpMM), kept as templates for the design probe
// (`python3 -m tpu_sparse_torch.kernels.spmm_probe`), which instantiates
// them beside the shipped kernels. Nothing else launches them.
//
// K6 / K7, first design: one 128-thread CTA per (row block, tile of CL =
// 8, 16 or 32 columns of B). It stages the values and global columns of 8
// planes at a time in shared memory, padding included; thread (rs, cl)
// sums column cl of rows rs, rs + 128 / CL, ... over the planes in order.
// Wider B re-reads the pack once per 32-column tile.
//
// K8, first design: one CTA per (block row, tile of KT columns), bs * KT
// threads, thread (i, jj) owning Y[r*bs + i, j0 + jj]; the block row's
// blocks staged in shared memory in chunks of 4096 values, B's stripes
// read from L2 block after block.
#pragma once

#include "ts_common.cuh"

#define TS_SPMM_V1_LANES 128
#define TS_SPMM_V1_STAGE 8
#define TS_SPMM_V1_MAX_GRID (1 << 20)

template <typename T, int CL>
__global__ void __launch_bounds__(TS_SPMM_V1_LANES)
cwell_spmm_v1_kernel(const T* __restrict__ vals,
                     const int* __restrict__ idx2,
                     const int* __restrict__ srow, const T* __restrict__ B,
                     T* __restrict__ Y, long long n_blocks, int planes,
                     long long n_rows, long long n_cols, int k) {
  constexpr int RS = TS_SPMM_V1_LANES / CL;  // rows a pass covers
  __shared__ T s_val[TS_SPMM_V1_STAGE][TS_SPMM_V1_LANES];
  __shared__ long long s_col[TS_SPMM_V1_STAGE][TS_SPMM_V1_LANES];
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
    for (int s0 = 0; s0 < planes; s0 += TS_SPMM_V1_STAGE) {
      const int cnt =
          planes - s0 < TS_SPMM_V1_STAGE ? planes - s0 : TS_SPMM_V1_STAGE;
      __syncthreads();  // the previous stage has been read
      for (int q = 0; q < cnt; ++q) {
        const long long p = plane0 + s0 + q;
        const long long off = p * TS_SPMM_V1_LANES + tid;
        const long long col =
            (long long)__ldg(srow + p) * TS_SPMM_V1_LANES + __ldg(idx2 + off);
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
        const long long row = b * TS_SPMM_V1_LANES + rs + i * RS;
        if (row < n_rows) Y[row * k + j] = acc[i];
      }
    }
  }
}

template <typename T, int CL>
static void launch_v1_tile(int grid, cudaStream_t stream, const T* vals,
                           const int* idx2, const int* srow, const T* B,
                           T* Y, long long n_blocks, long long planes,
                           long long n_rows, long long n_cols, long long k) {
  cwell_spmm_v1_kernel<T, CL><<<grid, TS_SPMM_V1_LANES, 0, stream>>>(
      vals, idx2, srow, B, Y, n_blocks, (int)planes, n_rows, n_cols, (int)k);
}

template <typename T>
static int launch_cwell_spmm_v1(const T* vals, const int* idx2,
                                const int* srow, const T* B, T* Y,
                                long long n_blocks, long long planes,
                                long long n_rows, long long n_cols,
                                long long k, cudaStream_t stream) {
  if (n_blocks < 0 || planes < 0 || planes > 0x7fffffffLL || n_rows < 0 ||
      n_cols < 0 || k < 0 || k > 0x7fffffffLL ||
      n_rows > n_blocks * TS_SPMM_V1_LANES)
    return TS_BAD_ARGUMENT;
  if (n_rows == 0 || k == 0) return 0;
  const int cl = k <= 8 ? 8 : (k <= 16 ? 16 : 32);
  const long long work = n_blocks * ((k + cl - 1) / cl);
  const int grid =
      (int)(work < TS_SPMM_V1_MAX_GRID ? work : TS_SPMM_V1_MAX_GRID);
  if (cl == 8)
    launch_v1_tile<T, 8>(grid, stream, vals, idx2, srow, B, Y, n_blocks,
                         planes, n_rows, n_cols, k);
  else if (cl == 16)
    launch_v1_tile<T, 16>(grid, stream, vals, idx2, srow, B, Y, n_blocks,
                          planes, n_rows, n_cols, k);
  else
    launch_v1_tile<T, 32>(grid, stream, vals, idx2, srow, B, Y, n_blocks,
                          planes, n_rows, n_cols, k);
  return (int)cudaGetLastError();
}

#define TS_BELL_V1_MAX_THREADS 256
#define TS_BELL_V1_STAGE 4096   // block values staged per chunk
#define TS_BELL_V1_MAX_GRID (1 << 20)

template <typename T>
__global__ void __launch_bounds__(TS_BELL_V1_MAX_THREADS)
bell_spmm_v1_kernel(const T* __restrict__ blocks,
                    const int* __restrict__ idx, const T* __restrict__ B,
                    T* __restrict__ Y, long long nbr, int L, int bs,
                    long long n_cols, int k, int kt) {
  extern __shared__ __align__(16) unsigned char ts_bell_v1_smem[];
  const int per = TS_BELL_V1_STAGE / (bs * bs);
  const int chunk = per < L ? per : L;
  T* sblk = reinterpret_cast<T*>(ts_bell_v1_smem);
  int* sidx = reinterpret_cast<int*>(sblk + (long long)chunk * bs * bs);
  const int tid = threadIdx.x;
  const int i = tid / kt;
  const int jj = tid - i * kt;
  const int tiles = (k + kt - 1) / kt;
  const long long bb = (long long)bs * bs;
  const long long work = nbr * tiles;
  for (long long w = blockIdx.x; w < work; w += gridDim.x) {
    const long long r = w / tiles;
    const int j = (int)(w - r * tiles) * kt + jj;
    T acc = T(0);
    for (int l0 = 0; l0 < L; l0 += chunk) {
      const int cnt = L - l0 < chunk ? L - l0 : chunk;
      const T* src = blocks + (r * L + l0) * bb;
      __syncthreads();  // the previous chunk is no longer read
      for (long long e = tid; e < cnt * bb; e += blockDim.x)
        sblk[e] = __ldg(src + e);
      for (int e = tid; e < cnt; e += blockDim.x)
        sidx[e] = __ldg(idx + r * L + l0 + e);
      __syncthreads();
      if (j < k) {
        for (int l = 0; l < cnt; ++l) {
          const long long c0 = (long long)sidx[l] * bs;
          if (c0 < 0 || c0 + bs > n_cols) continue;
          const T* a = sblk + l * bb + (long long)i * bs;
          const T* bcol = B + c0 * k + j;
#pragma unroll 8
          for (int c = 0; c < bs; ++c)
            acc += a[c] * __ldg(bcol + (long long)c * k);
        }
      }
    }
    if (j < k) Y[(r * bs + i) * k + j] = acc;
  }
}

template <typename T>
static int launch_bell_spmm_v1(const T* blocks, const int* idx, const T* B,
                               T* Y, long long nbr, long long L, long long bs,
                               long long n_cols, long long k,
                               cudaStream_t stream) {
  if (nbr < 0 || L < 0 || L > 0x7fffffffLL || bs < 1 || bs > 64 ||
      n_cols < 0 || k < 0 || k > 0x7fffffffLL)
    return TS_BAD_ARGUMENT;
  if (nbr == 0 || k == 0) return 0;
  long long kp = 1;
  while (kp < k) kp *= 2;
  int kt = 1;
  while (2 * kt <= kp && 2 * kt * bs <= TS_BELL_V1_MAX_THREADS) kt *= 2;
  const int threads = (int)bs * kt;
  const long long chunk_max = TS_BELL_V1_STAGE / (bs * bs);
  const long long chunk = L < chunk_max ? L : chunk_max;
  const size_t smem = (size_t)(chunk > 0 ? chunk : 1) * bs * bs * sizeof(T) +
                      (size_t)(chunk > 0 ? chunk : 1) * sizeof(int);
  const long long work = nbr * ((k + kt - 1) / kt);
  const int grid =
      (int)(work < TS_BELL_V1_MAX_GRID ? work : TS_BELL_V1_MAX_GRID);
  bell_spmm_v1_kernel<T><<<grid, threads, smem, stream>>>(
      blocks, idx, B, Y, nbr, (int)L, (int)bs, n_cols, (int)k, kt);
  return (int)cudaGetLastError();
}
