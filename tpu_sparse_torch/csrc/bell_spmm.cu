// K8: block-ELL SpMM Y = A B on a BELL matrix, float and double, and
// complex64 / complex128 (ts_common.cuh's TsComplex: products (ac - bd,
// ad + bc), a value skipped when both its parts are 0), and bf16 blocks
// with a bf16 or a float B: the blocks (and a bf16 B) stage at 2 bytes a
// value and are widened to float where they are multiplied, the sums run
// in float, and Y, in B's dtype, is rounded once.
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
// row-major; products whose block value is 0 are skipped (so a NaN in B
// reaches only the rows whose nonzeros gather it), and a block column at or
// past m / bs gathers 0. Sums run over l in order, then c in order.
//
// Bound: device-memory bandwidth. Each stored block value is used k times
// but read once; at k = 8 on kron(poisson3d_27pt(40), C8) the 442 MB of
// blocks are most of the 482 MB the function must move (221 MB of bf16
// blocks of 261 MB with a float B), and its 1.77 GFLOP
// are far below the card's float rate. B's stripes come from L2 (the block
// columns of a block row lie in a narrow band).
//
// Design: a persistent grid of 256-thread CTAs, as many as fit on the SMs.
// A thread owns V consecutive columns of one output row (16 bytes of
// columns where k allows, else one), so a block row takes bs * KT / V
// threads and a CTA takes groups of RB consecutive block rows. For each
// group, column tile of KT columns and chunk of LC block columns (a unit)
// it stages in shared memory the unit's blocks (LC * bs^2 contiguous
// values a block row) and the B stripes they name (bs rows of KT values;
// with one tile of all k columns, bs * k contiguous values) by per-thread
// asynchronous copies (cp.async, 16 bytes where the layout allows, else
// one value), a warp to a block row or stripe, so a copy costs no
// division; a warp loads the block columns of its next 32 stripes at
// once, so the copies do not wait on one index load per stripe. Then the
// threads run the unit's products out of shared memory, each reading its
// block row's value once (a broadcast) for V columns of the stripe (one
// vector load). The shipped build stages one unit of at most 96 KB
// (float) or 64 KB (double) at a time and overlaps one CTA's copies with
// the products of the other CTAs on its SM; STAGES = 2, which
// double-buffers the units inside a CTA, is slower on the card at every
// stage size (the probe). Sums carry across a group's chunks in
// registers; each output is written once. No atomics: reruns give the
// same bits. The wrapper refuses bs > 64.
//
// `python3 -m tpu_sparse_torch.kernels.spmm_probe` instantiates stages of
// 24 to 96 KB, two stages, and any bs beside the bs = 8 specialisation,
// and times them on one card.

#include <map>
#include <type_traits>
#include <mutex>
#include <utility>

#include "ts_async.cuh"

#define TS_BELL_THREADS 256
#define TS_BELL_MAX_BS 64
#define TS_BELL_SMEM_CAP (100 * 1024)    // the kernel's shared-memory cap

// Elements of T in 16 bytes, and n rounded up to a multiple of them.
template <typename T>
__host__ __device__ constexpr int ts_vec16() {
  return 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ inline long long ts_round16(long long n) {
  return (n + ts_vec16<T>() - 1) / ts_vec16<T>() * ts_vec16<T>();
}

// One value of T from device memory into shared memory: an asynchronous
// copy (cp.async takes 4, 8 or 16 bytes), or for a 2-byte bf16 value a
// plain load and store, which the barrier after the unit's wait orders as
// it orders the copies.
template <typename T>
__device__ __forceinline__ void ts_copy_one(T* dst, const T* src) {
  if constexpr (sizeof(T) >= 4)
    ts_cp_async<sizeof(T)>(dst, src);
  else
    *dst = *src;
}

// V consecutive values of a staged B stripe, as sums' type A (widened
// where B is bf16: V = 8 is one 16-byte load).
template <typename X, typename A, int V>
__device__ __forceinline__ void ts_stripe_load(const X* p, A (&o)[V]) {
  if constexpr (std::is_same<X, A>::value) {
    ts_vec_load<X, V>(p, o);
  } else if constexpr (V == 8) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      o[2 * q] = __uint_as_float(w[q] << 16);
      o[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else {
    static_assert(V == 1, "a bf16 stripe is read 8 or 1 values at a time");
    o[0] = ts_widen(*p);
  }
}

// T: the blocks' type; X: B's; Y: Y's (B's type; the sums run in
// A = ts_acc_t<T, X>, and a bf16 Y is rounded once). STAGES: 1 or 2
// (double-buffered units); V: columns a thread owns (V > 1 only when k and
// kt are multiples of V); BS: the block size, or 0 for any (read from
// bs_).
template <typename T, typename X, typename Y, int STAGES, int V, int BS>
__global__ void __launch_bounds__(TS_BELL_THREADS)
bell_spmm_staged(const T* __restrict__ blocks, const int* __restrict__ idx,
                 const X* __restrict__ B, Y* __restrict__ Yo, long long nbr,
                 int L, int bs_, long long n_cols, int k, int kt, int rb,
                 int lc, int vblk, int vb) {
  using A = ts_acc_t<T, X>;
  extern __shared__ __align__(16) unsigned char ts_bell_smem[];
  constexpr int ET = ts_vec16<T>();
  constexpr int EX = ts_vec16<X>();
  constexpr int NW = TS_BELL_THREADS / 32;
  const int bs = BS ? BS : bs_;
  const int bb = bs * bs;
  // a stage: the unit's blocks, then its stripes, each 16-byte aligned
  const long long blk_bytes = ts_round16<T>((long long)rb * lc * bb) * sizeof(T);
  const long long stage_bytes =
      blk_bytes + ts_round16<X>((long long)rb * lc * bs * kt) * sizeof(X);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tiles = (k + kt - 1) / kt;
  const int chunks = (L + lc - 1) / lc;
  const int per_group = tiles * chunks;
  const long long groups = (nbr + rb - 1) / rb;
  // this CTA's units (fewer than 2^31: the launcher checks)
  const int units =
      blockIdx.x < groups
          ? (int)((groups - 1 - blockIdx.x) / gridDim.x + 1) * per_group
          : 0;

  // unit u of this CTA: group g, column tile t, chunk ch (innermost)
  auto unit = [&](int u, long long& g, int& t, int& ch) {
    const int q = u / per_group, rem = u - q * per_group;
    g = blockIdx.x + (long long)q * gridDim.x;
    t = rem / chunks;
    ch = rem - t * chunks;
  };
  auto stage_blocks = [&](int u) {
    return reinterpret_cast<T*>(ts_bell_smem + (u % STAGES) * stage_bytes);
  };
  auto stage_stripes = [&](int u) {
    return reinterpret_cast<X*>(ts_bell_smem + (u % STAGES) * stage_bytes +
                                blk_bytes);
  };

  auto load_unit = [&](int u) {
    long long g;
    int t, ch;
    unit(u, g, t, ch);
    T* sblk = stage_blocks(u);
    X* sB = stage_stripes(u);
    const long long r0 = g * rb;
    const int nrb = (int)min((long long)rb, nbr - r0);
    const int l0 = ch * lc;
    const int cnt = min(lc, L - l0);
    const int j0 = t * kt;
    const int w = min(kt, k - j0);
    // the blocks: cnt * bs^2 contiguous values per block row, a warp each
    const int nb = cnt * bb;
    for (int rr = warp; rr < nrb; rr += NW) {
      T* dst = sblk + (long long)rr * lc * bb;
      const T* src = blocks + ((r0 + rr) * L + l0) * bb;
      if (vblk) {
        for (int q = lane * ET; q < nb; q += 32 * ET)
          ts_cp_async<16>(dst + q, src + q);
      } else {
        for (int q = lane; q < nb; q += 32) ts_copy_one(dst + q, src + q);
      }
    }
    // the stripes, a warp each: row c of block (rr, l) is w values of B's
    // row idx * bs + c from column j0; with one tile of all k columns the
    // stripe is bs * k contiguous values
    const int step = vb ? EX : 1;
    const int per_row = w / step;  // vb: w is a multiple of EX
    const int ns = nrb * cnt;
    long long my_ci = 0;  // lane j holds the block column of stripe j
    for (int s = warp, j = 32; s < ns; s += NW, ++j) {
      if (j == 32) {  // the next 32 stripes' indices, one load each
        const int sj = s + lane * NW;
        if (sj < ns) {
          const int rr = sj / cnt;
          my_ci = __ldg(idx + (r0 + rr) * L + l0 + sj - rr * cnt);
        }
        j = 0;
      }
      const long long ci = __shfl_sync(0xffffffffu, my_ci, j);
      const int rr = s / cnt, l = s - rr * cnt;
      X* dst = sB + (long long)(rr * lc + l) * bs * kt;
      const bool outside = ci < 0 || (ci + 1) * bs > n_cols;
      for (int q = lane; q < bs * per_row; q += 32) {
        int c = 0, x = q * step;
        if (w != kt || kt != k) {
          c = q / per_row;
          x = (q - c * per_row) * step;
        }
        X* d = dst + c * kt + x;
        if (outside) {
          for (int z = 0; z < step; ++z) d[z] = ts_zero<X>();
          continue;
        }
        const X* src = B + (ci * bs + c) * k + j0 + x;
        if (vb)
          ts_cp_async<16>(d, src);
        else
          ts_copy_one(d, src);
      }
    }
  };

  // this thread's outputs: block row rr, row i, columns jv .. jv + V - 1
  const int vpr = kt / V;   // threads a row of a block row
  const int tpb = bs * vpr;  // threads a block row
  const int orr = tid / tpb;
  const int oi = (tid - orr * tpb) / vpr;
  const int ojv = (tid - orr * tpb - oi * vpr) * V;
  const bool own = orr < rb;
  A acc[V];

  if (units > 0) load_unit(0);
  ts_cp_async_commit();
  for (int u = 0; u < units; ++u) {
    if constexpr (STAGES == 2) {
      if (u + 1 < units) load_unit(u + 1);
      ts_cp_async_commit();
      ts_cp_async_wait<1>();
    } else {
      ts_cp_async_wait<0>();
    }
    __syncthreads();  // unit u's copies (every thread's) have landed
    long long g;
    int t, ch;
    unit(u, g, t, ch);
    if (own) {
      const T* pa = stage_blocks(u) + (long long)orr * lc * bb + oi * bs;
      const X* pb = stage_stripes(u) + (long long)orr * lc * bs * kt + ojv;
      const int cnt = min(lc, L - ch * lc);
      if (ch == 0) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = A(0);
      }
      for (int l = 0; l < cnt; ++l) {
#pragma unroll 8
        for (int c = 0; c < bs; ++c) {
          const auto a = ts_widen(pa[l * bb + c]);
          if (a != decltype(a)(0)) {
            A bv[V];
            ts_stripe_load<X, A, V>(pb + (l * bs + c) * kt, bv);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] += a * bv[v];
          }
        }
      }
      const long long r = g * rb + orr;
      const int j = t * kt + ojv;
      if (ch == chunks - 1 && r < nbr && j < k) {
#pragma unroll
        for (int v = 0; v < V; ++v)
          Yo[(r * bs + oi) * k + j + v] = ts_narrow<Y>(acc[v]);
      }
    }
    __syncthreads();  // the stage is read: it may be refilled
    if constexpr (STAGES == 1) {
      if (u + 1 < units) load_unit(u + 1);
      ts_cp_async_commit();
    }
  }
}

// CTAs of one instance that fit on the current device at `smem` bytes,
// asked once per (device, size) and kept under a lock.
template <typename T, typename X, typename Y, int STAGES, int V, int BS>
static int ts_bell_ctas(size_t smem, long long* ctas) {
  static std::mutex lock;
  static std::map<std::pair<int, size_t>, long long> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(lock);
  auto it = known.find({dev, smem});
  if (it == known.end()) {
    auto kernel = bell_spmm_staged<T, X, Y, STAGES, V, BS>;
    int sms = 0, per_sm = 0;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TS_BELL_SMEM_CAP);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, TS_BELL_THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    it = known.emplace(std::make_pair(dev, smem),
                       (long long)sms * (per_sm > 0 ? per_sm : 1)).first;
  }
  *ctas = it->second;
  return 0;
}

template <typename T, typename X, typename Y, int STAGES, int V, int BS>
static int launch_bell_instance(const T* blocks, const int* idx, const X* B,
                                Y* Yo, long long nbr, long long L,
                                long long bs, long long n_cols, long long k,
                                cudaStream_t stream, long long stage_bytes) {
  constexpr int ET = ts_vec16<T>();
  constexpr int EX = ts_vec16<X>();
  long long kp = 1;
  while (kp < k) kp *= 2;
  int kt = V;  // columns a tile: one block row's outputs fit the CTA
  while (2 * kt <= kp && bs * (2 * kt / V) <= TS_BELL_THREADS) kt *= 2;
  // block rows a group: as many as the CTA has threads for, as far as one
  // block column of each fits the stage
  const long long per_block =
      bs * bs * (long long)sizeof(T) + bs * kt * (long long)sizeof(X);
  long long rb = TS_BELL_THREADS / (bs * (kt / V));
  if (rb > stage_bytes / per_block) rb = stage_bytes / per_block;
  if (rb < 1) rb = 1;
  if (rb > nbr) rb = nbr;
  // block columns a chunk: as many as fit the stage, evened out over the
  // chunks of a block row
  long long lc = stage_bytes / (rb * per_block);
  if (lc < 1) lc = 1;
  if (lc > L) lc = L;
  const long long chunks = (L + lc - 1) / lc;
  lc = (L + chunks - 1) / chunks;
  const size_t stage =
      (size_t)(ts_round16<T>(rb * lc * bs * bs) * sizeof(T) +
               ts_round16<X>(rb * lc * bs * kt) * sizeof(X));
  const size_t smem = STAGES * stage;
  if (smem > TS_BELL_SMEM_CAP) return TS_BAD_ARGUMENT;
  const int vblk = (bs * bs) % ET == 0 && (uintptr_t)blocks % 16 == 0;
  const int vb = k % EX == 0 && kt % EX == 0 && (uintptr_t)B % 16 == 0;
  long long ctas = 0;
  const int rc = ts_bell_ctas<T, X, Y, STAGES, V, BS>(smem, &ctas);
  if (rc != 0) return rc;
  const long long groups = (nbr + rb - 1) / rb;
  const int grid = (int)(groups < ctas ? groups : ctas);
  const long long tiles = (k + kt - 1) / kt;
  if (((groups + grid - 1) / grid) * tiles * chunks > 0x7fffffffLL)
    return TS_BAD_ARGUMENT;  // a CTA's units must count in an int
  bell_spmm_staged<T, X, Y, STAGES, V, BS><<<grid, TS_BELL_THREADS, smem,
                                              stream>>>(
      blocks, idx, B, Yo, nbr, (int)L, (int)bs, n_cols, (int)k, kt, (int)rb,
      (int)lc, vblk, vb);
  return (int)cudaGetLastError();
}

// One launch of the design STAGES (x BS, 0 for any block size);
// `stage_bytes`: the target size of a stage. A thread owns 16 bytes of
// B's columns where k allows, else one.
template <typename T, typename X, typename Y, int STAGES, int BS>
static int launch_bell_spmm(const T* blocks, const int* idx, const X* B,
                            Y* Yo, long long nbr, long long L, long long bs,
                            long long n_cols, long long k,
                            cudaStream_t stream, long long stage_bytes) {
  if (nbr < 0 || L < 0 || L > 0x7fffffffLL || bs < 1 ||
      bs > TS_BELL_MAX_BS || (BS && bs != BS) || n_cols < 0 || k < 0 ||
      k > 0x7fffffffLL || stage_bytes < 1)
    return TS_BAD_ARGUMENT;
  if (nbr == 0 || k == 0) return 0;
  if (L == 0)  // no stored block: Y is 0
    return (int)cudaMemsetAsync(Yo, 0, nbr * bs * k * sizeof(Y), stream);
  constexpr int V = ts_vec16<X>();
  if (k % V == 0)
    return launch_bell_instance<T, X, Y, STAGES, V, BS>(
        blocks, idx, B, Yo, nbr, L, bs, n_cols, k, stream, stage_bytes);
  return launch_bell_instance<T, X, Y, STAGES, 1, BS>(
      blocks, idx, B, Yo, nbr, L, bs, n_cols, k, stream, stage_bytes);
}

// The shipped design: one stage of at most 96 KB in float, 64 KB in
// double (the probe's fastest of 24 to 96 KB for each type: large units
// amortise their barriers, and the CTAs on a SM overlap one another's
// copies and products); 64 KB in complex64 (8-byte values, as double) and
// in complex128, whose tiles hold half the values of double's; 64 KB for
// bf16 blocks (at 96 KB a unit's stage is 84 KB and two CTAs fit a SM, at
// 64 KB it is 54 KB and four fit: 0.45 against 0.49 ms on the kron BELL);
// bs = 8, the main path's block size, with its inner loop unrolled.
template <typename T, typename X = T, typename Y = X>
static int bell_spmm_entry(const T* blocks, const int* idx, const X* B, Y* Yo,
                           long long nbr, long long L, long long bs,
                           long long n_cols, long long k,
                           cudaStream_t stream) {
  constexpr long long stage = (sizeof(T) == 4 ? 96 : 64) * 1024;
  static_assert(stage <= TS_BELL_SMEM_CAP, "a stage must fit the cap");
  if (bs == 8)
    return launch_bell_spmm<T, X, Y, 1, 8>(blocks, idx, B, Yo, nbr, L, bs,
                                           n_cols, k, stream, stage);
  return launch_bell_spmm<T, X, Y, 1, 0>(blocks, idx, B, Yo, nbr, L, bs,
                                         n_cols, k, stream, stage);
}

extern "C" int ts_bell_spmm_f32(const float* blocks, const int* idx,
                                const float* B, float* Y, long long nbr,
                                long long L, long long bs, long long n_cols,
                                long long k, cudaStream_t stream) {
  return bell_spmm_entry<float>(blocks, idx, B, Y, nbr, L, bs, n_cols, k,
                                stream);
}

extern "C" int ts_bell_spmm_f64(const double* blocks, const int* idx,
                                const double* B, double* Y, long long nbr,
                                long long L, long long bs, long long n_cols,
                                long long k, cudaStream_t stream) {
  return bell_spmm_entry<double>(blocks, idx, B, Y, nbr, L, bs, n_cols, k,
                                 stream);
}

extern "C" int ts_bell_spmm_c64(const ts_c64* blocks, const int* idx,
                                const ts_c64* B, ts_c64* Y, long long nbr,
                                long long L, long long bs, long long n_cols,
                                long long k, cudaStream_t stream) {
  return bell_spmm_entry<ts_c64>(blocks, idx, B, Y, nbr, L, bs, n_cols, k,
                                 stream);
}

extern "C" int ts_bell_spmm_c128(const ts_c128* blocks, const int* idx,
                                 const ts_c128* B, ts_c128* Y, long long nbr,
                                 long long L, long long bs, long long n_cols,
                                 long long k, cudaStream_t stream) {
  return bell_spmm_entry<ts_c128>(blocks, idx, B, Y, nbr, L, bs, n_cols, k,
                                  stream);
}

// bf16 blocks with a bf16 B (Y bf16) or a float B (Y float): Y in B's
// dtype, as the JAX kernel writes it (pallas_bell.py:119); the sums run in
// float.
extern "C" int ts_bell_spmm_bf16(const ts_bf16* blocks, const int* idx,
                                 const ts_bf16* B, ts_bf16* Y, long long nbr,
                                 long long L, long long bs, long long n_cols,
                                 long long k, cudaStream_t stream) {
  return bell_spmm_entry<ts_bf16>(blocks, idx, B, Y, nbr, L, bs, n_cols, k,
                                  stream);
}

extern "C" int ts_bell_spmm_bf16_f32(const ts_bf16* blocks, const int* idx,
                                     const float* B, float* Y, long long nbr,
                                     long long L, long long bs,
                                     long long n_cols, long long k,
                                     cudaStream_t stream) {
  return bell_spmm_entry<ts_bf16, float>(blocks, idx, B, Y, nbr, L, bs,
                                         n_cols, k, stream);
}
