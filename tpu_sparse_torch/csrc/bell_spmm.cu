// K8: block-ELL SpMM Y = A B on a BELL matrix, float and double.
//
// Replaces tpu_sparse/kernels/pallas_bell.py: `_bell_spmm_kernel` and its
// column-tiled form `_bell_spmm_kernel_tiled` (call in `_bell_spmm_impl`,
// entry `bell_spmm_pallas`). The TPU kernel multiplied each (bs, bs) block
// by a (bs, k) stripe of B on its matrix unit at HIGHEST precision; here the
// products are float FMAs (no TF32), and the double build takes the
// float64 operands the JAX package left to XLA.
//
// Y[r*bs + i, j] = sum_l sum_c blocks[r, l, i, c] * B[idx[r, l]*bs + c, j]
// with blocks (nbr, L, bs, bs), idx (nbr, L), B (m, k) and Y (n, k)
// row-major; a block column at or past m / bs gathers 0.
//
// Bound: device-memory bandwidth. Each stored block value is used k times
// but read once; at k = 8 on kron(poisson3d_27pt(40), C8) the 442 MB of
// blocks are most of the 482 MB the function must move, and its 1.77 GFLOP
// are far below the card's float rate. B's stripes are gathered through L2
// (the block columns of a block row lie in a narrow band).
//
// Design: one CUDA block per (block row, tile of KT columns of B), bs * KT
// threads, thread (i, jj) owning Y[r*bs + i, j0 + jj]; consecutive threads
// take consecutive columns, so B's stripe rows and Y's rows are read and
// written coalesced. The block row's blocks are staged through shared
// memory in chunks of at most 4096 values (coalesced, each value read from
// device memory once per tile), then every thread reads its block row i
// from shared memory, where the threads of one i share an address (a
// broadcast). KT is the largest power of two with KT <= 256 / bs and at
// most k rounded up to a power of two; wider B takes ceil(k / KT) tiles,
// neighbouring in the grid so that their reads of the blocks meet in L2.
// No atomics: reruns give the same bits. The wrapper refuses bs > 64.

#include "ts_common.cuh"

#define TS_BELL_MAX_THREADS 256
#define TS_BELL_STAGE 4096   // block values staged per chunk
#define TS_BELL_MAX_GRID (1 << 20)

template <typename T>
__global__ void __launch_bounds__(TS_BELL_MAX_THREADS)
bell_spmm_kernel(const T* __restrict__ blocks, const int* __restrict__ idx,
                 const T* __restrict__ B, T* __restrict__ Y, long long nbr,
                 int L, int bs, long long n_cols, int k, int kt) {
  extern __shared__ __align__(16) unsigned char ts_bell_smem[];
  const int chunk = TS_BELL_STAGE / (bs * bs) < L ? TS_BELL_STAGE / (bs * bs)
                                                  : L;
  T* sblk = reinterpret_cast<T*>(ts_bell_smem);
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
static int launch_bell_spmm(const T* blocks, const int* idx, const T* B, T* Y,
                            long long nbr, long long L, long long bs,
                            long long n_cols, long long k,
                            cudaStream_t stream) {
  if (nbr < 0 || L < 0 || L > 0x7fffffffLL || bs < 1 || bs > 64 ||
      n_cols < 0 || k < 0 || k > 0x7fffffffLL)
    return TS_BAD_ARGUMENT;
  if (nbr == 0 || k == 0) return 0;
  long long kp = 1;
  while (kp < k) kp *= 2;
  int kt = 1;
  while (2 * kt <= kp && 2 * kt * bs <= TS_BELL_MAX_THREADS) kt *= 2;
  const int threads = (int)bs * kt;
  const long long chunk_max = TS_BELL_STAGE / (bs * bs);
  const long long chunk = L < chunk_max ? L : chunk_max;
  const size_t smem = (size_t)(chunk > 0 ? chunk : 1) * bs * bs * sizeof(T) +
                      (size_t)(chunk > 0 ? chunk : 1) * sizeof(int);
  const long long work = nbr * ((k + kt - 1) / kt);
  const int grid = (int)(work < TS_BELL_MAX_GRID ? work : TS_BELL_MAX_GRID);
  bell_spmm_kernel<T><<<grid, threads, smem, stream>>>(
      blocks, idx, B, Y, nbr, (int)L, (int)bs, n_cols, (int)k, kt);
  return (int)cudaGetLastError();
}

extern "C" int ts_bell_spmm_f32(const float* blocks, const int* idx,
                                const float* B, float* Y, long long nbr,
                                long long L, long long bs, long long n_cols,
                                long long k, cudaStream_t stream) {
  return launch_bell_spmm<float>(blocks, idx, B, Y, nbr, L, bs, n_cols, k,
                                 stream);
}

extern "C" int ts_bell_spmm_f64(const double* blocks, const int* idx,
                                const double* B, double* Y, long long nbr,
                                long long L, long long bs, long long n_cols,
                                long long k, cudaStream_t stream) {
  return launch_bell_spmm<double>(blocks, idx, B, Y, nbr, L, bs, n_cols, k,
                                  stream);
}
