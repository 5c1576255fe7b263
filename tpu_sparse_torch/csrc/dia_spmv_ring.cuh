// Kernel 1's plain mode, the staged-ring design: a template the design
// probe (`python3 -m tpu_sparse_torch.kernels.dia_spmv_probe`) times beside
// the shipped designs of dia_spmv.cu and the first design (v1). It equals
// them bit for bit; it lost to them in every build on the 160^3 shapes
// (each tile's x loads wait until its data has landed), so nothing else
// launches it. Include after dia_spmv.cu.
#pragma once

#include "ts_async.cuh"

// TS_DIA_RING: a persistent grid of TS_DIA_RING_THREADS-thread CTAs, CTA c
// taking a contiguous share of the tiles of T rows. Warp 0 streams each
// tile's (ndiag x T) box of data into a ring of STAGES stages in shared
// memory (one 1-D bulk async copy a diagonal, L2 evict-first, completing
// on the stage's mbarrier), so the next tiles' data is in flight while the
// threads sum this one: thread t the rows base + t + TS_DIA_RING_THREADS * r,
// x read through L1. Needs a 16-byte aligned data pointer and rows of
// whole 16-byte vectors (the last tile's copies round up within ld).
#define TS_DIA_RING 2
#define TS_DIA_RING_THREADS 128
#define TS_DIA_RING_SMEM_CAP (200 * 1024)

template <typename V, int T, int STAGES>
constexpr size_t ts_dia_ring_bytes(int ndiag) {
  return (size_t)STAGES * ndiag * T * sizeof(V);
}

template <typename V, typename X, int T, int STAGES, int ND>
__global__ void __launch_bounds__(TS_DIA_RING_THREADS)
dia_spmv_ring_kernel(const V* __restrict__ data, long long ld,
                     TsOffsets offs, int ndiag, const X* __restrict__ x,
                     X* __restrict__ y, long long n_rows, long long n_cols,
                     long long lo, long long hi) {
  using A = ts_acc_t<V, X>;
  constexpr int RT = T / TS_DIA_RING_THREADS;
  constexpr int ALIGN = sizeof(V) >= 16 ? 1 : 16 / (int)sizeof(V);
  static_assert(RT >= 1 && T % TS_DIA_RING_THREADS == 0, "whole rows");
  extern __shared__ __align__(128) unsigned char ts_smem[];
  V* s_data = reinterpret_cast<V*>(ts_smem);
  __shared__ uint64_t full[STAGES];
  __shared__ int s_off[ND > 0 ? 1 : TS_MAX_DIAG];
  const int nd = ND > 0 ? ND : ndiag;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long tiles = (n_rows + T - 1) / T;
  const long long g = gridDim.x, c = blockIdx.x;
  const long long t0 = tiles * c / g, count = tiles * (c + 1) / g - t0;
  const uint64_t policy = ts_evict_first_policy();
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) ts_mbar_init(&full[s], 1);
    ts_fence_mbar_init();
  }
  if constexpr (ND == 0)
    for (int d = tid; d < ndiag; d += blockDim.x) s_off[d] = offs.o[d];
  __syncthreads();
  // tile t0 + p into stage p % STAGES, by warp 0: lane 0 arms the
  // barrier, then lane l copies diagonals l, l + 32
  auto fill = [&](long long p) {
    const int st = (int)(p % STAGES);
    const long long base = (t0 + p) * T;
    long long nr = n_rows - base < T ? n_rows - base : T;
    nr = (nr + ALIGN - 1) / ALIGN * ALIGN;
    const uint32_t bytes = (uint32_t)(nr * sizeof(V));
    if (lane == 0) ts_mbar_expect_tx(&full[st], bytes * (uint32_t)nd);
    __syncwarp();
    // the threads' reads of this stage happened before the barrier that
    // led here; order them before the async proxy's writes
    ts_fence_proxy_async();
    for (int d = lane; d < nd; d += 32)
      ts_bulk_load(s_data + ((size_t)st * nd + d) * T, data + d * ld + base,
                   bytes, &full[st], policy);
  };
  if (tid < 32)
    for (long long p = 0; p < STAGES - 1 && p < count; ++p) fill(p);
  for (long long p = 0; p < count; ++p) {
    if (tid < 32 && p + STAGES - 1 < count) fill(p + STAGES - 1);
    const int st = (int)(p % STAGES);
    ts_mbar_wait(&full[st], (uint32_t)((p / STAGES) & 1));
    const V* sd = s_data + (size_t)st * nd * T + tid;
    const long long base = (t0 + p) * T;
    const long long i0 = base + tid;
    if (base >= lo && base + T <= hi) {
      A acc[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) acc[r] = A(0);
      ts_for_diag<ND>(ndiag, [&](int d) {
        const X* xp = x + (i0 + ts_dia_off<ND>(offs, s_off, d));
#pragma unroll
        for (int r = 0; r < RT; ++r)
          acc[r] += ts_widen(sd[d * T + r * TS_DIA_RING_THREADS]) *
                    ts_widen(ts_ldg(xp + r * TS_DIA_RING_THREADS));
      });
#pragma unroll
      for (int r = 0; r < RT; ++r)
        y[i0 + r * TS_DIA_RING_THREADS] = ts_narrow<X>(acc[r]);
    } else {
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        const long long i = i0 + r * TS_DIA_RING_THREADS;
        if (i >= n_rows) continue;
        A acc = A(0);
        ts_for_diag<ND>(ndiag, [&](int d) {
          const long long j = i + ts_dia_off<ND>(offs, s_off, d);
          if (j >= 0 && j < n_cols)
            acc += ts_widen(sd[d * T + r * TS_DIA_RING_THREADS]) *
                   ts_widen(ts_ldg(x + j));
        });
        y[i] = ts_narrow<X>(acc);
      }
    }
    __syncthreads();  // every read of this stage is done: it may refill
  }
}

// One launch of the ring: as many CTAs as fit on the SMs at this stage
// size (the occupancy read once per instance, device and diagonal count),
// at most one a tile.
template <typename V, typename X, int T, int STAGES, int ND>
static int launch_dia_ring_nd(const V* data, long long ld,
                              const TsOffsets& offs, int ndiag, const X* x,
                              X* y, long long n_rows, long long n_cols,
                              long long lo, long long hi, int sms,
                              cudaStream_t stream) {
  auto kern = dia_spmv_ring_kernel<V, X, T, STAGES, ND>;
  const size_t smem = ts_dia_ring_bytes<V, T, STAGES>(ndiag);
  if (smem > TS_DIA_RING_SMEM_CAP) return TS_BAD_ARGUMENT;
  static int occ[64][TS_MAX_DIAG + 1] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return TS_BAD_ARGUMENT;
  if (occ[dev][ndiag] == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TS_DIA_RING_SMEM_CAP);
    if (e != cudaSuccess) return (int)e;
    int o = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &o, kern, TS_DIA_RING_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    occ[dev][ndiag] = o > 0 ? o : 1;
  }
  const long long tiles = (n_rows + T - 1) / T;
  const long long cap = (long long)sms * occ[dev][ndiag];
  const long long grid = tiles < cap ? tiles : cap;
  kern<<<(unsigned)grid, TS_DIA_RING_THREADS, smem, stream>>>(
      data, ld, offs, ndiag, x, y, n_rows, n_cols, lo, hi);
  return (int)cudaGetLastError();
}
