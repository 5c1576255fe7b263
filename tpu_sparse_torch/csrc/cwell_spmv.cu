// K4 / K5: general-structure SpMV on the row-compact plan of a CWELL pack,
// float and double, and complex64 / complex128 (ts_common.cuh's TsComplex);
// K4 also on bf16 values, with a float x (float y) or a bf16 x (bf16 y).
//
// Replaces tpu_sparse/kernels/pallas_cwell.py: `_cwell_kernel` and its
// grouped form `_cwell_kernel_gq` (K4, entry `cwell_spmv_pallas`, call in
// `_cwell_spmv_inner`), and, as the double instance, `_cwell_kernel_df` /
// `_cwell_kernel_df_gq` (K5, entry `cwell_spmv_pallas_df`, call in
// `_cwell_df_inner`). The H100 has native fp64, so K5's hi/lo pairs and
// compensated sums are gone: the double build accumulates in double.
//
// Layout (tpu_sparse_torch/sparse/cwell_compact.py): row block b holds
// L_b slot rows of 128 slots at [boff[b], boff[b+1]); slot j*128 + l is the
// j-th nonzero of row b*128 + l in plane order, padding (value 0) after.
// A narrow slot index is (plane << 8) | idx2 in 16 bits, the column
// srow[b, plane] * 128 + idx2; a wide one (packs of more than 256 planes)
// is the int32 column. The plan checked every column against m when it
// was built, so the kernel makes no bounds test.
//
// y[b*128 + l] = sum over the row's slots of cvals * x[col], in slot order
// in the value type; slots of value 0 are skipped, so a NaN in x reaches
// only the rows whose nonzeros gather it. bf16 values stream at 2 bytes a
// slot and are widened to float in registers; x is gathered in its own
// type and widened, the sum runs in float and a bf16 y is rounded once:
// the JAX kernel's f32 gather and accumulate (pallas_cwell.py:262-290),
// and on bf16-exact values the float build's result bit for bit.
//
// Bound: device-memory bandwidth. Each slot streams its value and its
// 2-byte index once (4 / 6 / 10 bytes a slot in bf16 / float / double, where the
// plane pack streamed 8 / 12 and a third of its slots were padding), each
// block its window rows; x (16 MB in float at n = 160^3) is gathered and
// stays in the 50 MB L2; y is written once.
//
// Two designs, one for each kernel; both walk the same slots in the same
// order, so they agree bit for bit.
//
// K4 (float, and bf16 values): a persistent grid of as many 128-thread
// CTAs as fit on the SMs. CTA c takes the row blocks whose slots start in its share of the
// slot rows (a binary search over boff), so its slots are one contiguous
// range, and streams that range in pieces of CHUNK = 8 slot rows through a
// ring of STAGES = 2 stages in shared memory: thread 0 fills a stage with
// two 1-D bulk async copies (cp.async.bulk, L2 evict-first) that complete
// on the stage's mbarrier, so the next piece is in flight while the
// threads gather x for this one. Thread l owns row b*128 + l of the
// current block; at a block's end (the same slot row for every thread) it
// writes y, and the CTA loads the next block's window rows into shared
// memory (double buffered). A __syncthreads at the end of each piece frees
// its stage for the refill. Small stages keep many CTAs on an SM, which the
// x gathers need: 8 x 2 beat 16 x 2, 4 x 2 and 8 x 4 in float; with bf16
// values (4-byte slots) 16 x 2 is the fastest (TsCwellDesign).
//
// K5 (double, and both complex builds): plain loads. One CTA per row
// block (grid-stride), its window rows in shared memory, each thread
// loading its slots from device memory with the evict-first hint
// (__ldcs). On the 27-point 160^3 pack it was 2-4% faster than the ring
// in double, and 3-7% slower in float; the complex builds take it because
// a complex64 value is 8 bytes as a double is (a complex128 value 16, so
// a slot streams 18 bytes). A complex
// product is (ac - bd, ad + bc), each operation rounded on its own; a slot
// is skipped when both parts of its value are 0.
//
// `python3 -m tpu_sparse_torch.kernels.cwell_spmv_probe` instantiates both
// designs for both types, at several ring sizes, and times them on one card.
//
// Offsets are 64-bit and there are no atomics: reruns give the same bits.

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

#include "ts_async.cuh"

#define TS_CWELL_MAX_GRID (1 << 20)

// The design each kernel ships: the ring's slot rows a stage and stages
// (K4), or 0 x 0 for plain loads (K5). bf16 values take pieces of 16 slot
// rows: a slot is 4 bytes, not 6, and on the 160^3 pack 16 x 2 beat 8 x 2,
// 8 x 4, 4 x 2 and plain loads (cwell_spmv_probe).
template <typename T>
struct TsCwellDesign {
  static constexpr int chunk = 8, stages = 2;
};
template <>
struct TsCwellDesign<ts_bf16> {
  static constexpr int chunk = 16, stages = 2;
};
template <>
struct TsCwellDesign<double> {
  static constexpr int chunk = 0, stages = 0;
};
// complex64 values are 8 bytes as double's, complex128 16: plain loads
template <typename R>
struct TsCwellDesign<TsComplex<R>> {
  static constexpr int chunk = 0, stages = 0;
};

// ---- plain loads (K5) -----------------------------------------------------

// T: the values' type; X: x's and y's type.
template <typename T, typename X, typename I>
__global__ void __launch_bounds__(TS_CWELL_LANES)
cwell_spmv_plain(const T* __restrict__ cvals, const I* __restrict__ idx,
                 const int* __restrict__ srow,
                 const long long* __restrict__ boff, const X* __restrict__ x,
                 X* __restrict__ y, long long n_blocks, int planes,
                 long long n_rows) {
  using A = ts_acc_t<T, X>;
  __shared__ int s_srow[TS_CWELL_NARROW_PLANES];
  const int lane = threadIdx.x;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    if constexpr (sizeof(I) == 2) {
      __syncthreads();  // the previous block's reads of s_srow are done
      ts_load_window_rows<I>(srow, b, planes, s_srow);
      __syncthreads();
    }
    const long long o0 = __ldg(boff + b);
    const int len = (int)((__ldg(boff + b + 1) - o0) / TS_CWELL_LANES);
    const T* v = cvals + o0 + lane;
    const I* ix = idx + o0 + lane;
    A acc = A(0);
#pragma unroll 4
    for (int j = 0; j < len; ++j) {
      const auto a = ts_widen(ts_ldcs(v + (long long)j * TS_CWELL_LANES));
      const I c = __ldcs(ix + (long long)j * TS_CWELL_LANES);
      if (a != decltype(a)(0))
        acc += a * ts_widen(ts_ldg(x + ts_slot_col(c, s_srow)));
    }
    const long long row = b * TS_CWELL_LANES + lane;
    if (row < n_rows) y[row] = ts_narrow<X>(acc);
  }
}

// ---- the bulk-copy ring (K4) ----------------------------------------------

// The first row block in [0, n_blocks] whose first slot row is >= r.
__device__ __forceinline__ long long ts_first_block(const long long* boff,
                                                    long long n_blocks,
                                                    long long r) {
  long long lo = 0, hi = n_blocks;
  const long long key = r * TS_CWELL_LANES;
  while (lo < hi) {
    const long long mid = (lo + hi) / 2;
    if (__ldg(boff + mid) < key)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The ring, then two buffers of window rows (narrow indices only). At
// most 48 KB, the dynamic shared memory every kernel may take unasked.
template <typename T, typename I, int CHUNK, int STAGES>
constexpr size_t ts_ring_smem_bytes(long long planes) {
  return (size_t)STAGES * CHUNK * TS_CWELL_LANES * (sizeof(T) + sizeof(I)) +
         (sizeof(I) == 2 ? 2 * planes * sizeof(int) : 0);
}

template <typename T, typename X, typename I, int CHUNK, int STAGES>
__global__ void __launch_bounds__(TS_CWELL_LANES)
cwell_spmv_ring(const T* __restrict__ cvals, const I* __restrict__ idx,
                const int* __restrict__ srow,
                const long long* __restrict__ boff, const X* __restrict__ x,
                X* __restrict__ y, long long n_blocks, int planes,
                long long n_rows) {
  using A = ts_acc_t<T, X>;
  constexpr int PIECE = CHUNK * TS_CWELL_LANES;  // slots a stage
  extern __shared__ __align__(128) unsigned char ts_smem[];
  T* s_val = reinterpret_cast<T*>(ts_smem);
  I* s_idx = reinterpret_cast<I*>(s_val + STAGES * PIECE);
  int* s_srow = reinterpret_cast<int*>(s_idx + STAGES * PIECE);
  __shared__ uint64_t full[STAGES];

  const int lane = threadIdx.x;
  // this CTA's row blocks [b0, b1): those whose first slot row lies in
  // its share of the slot rows; the last CTA also takes the empty blocks
  // at the end
  const long long rows = __ldg(boff + n_blocks) / TS_CWELL_LANES;
  const long long g = gridDim.x, c = blockIdx.x;
  const long long b0 = ts_first_block(boff, n_blocks, rows * c / g);
  const long long b1 = c + 1 == g ? n_blocks
                                   : ts_first_block(boff, n_blocks,
                                                    rows * (c + 1) / g);
  const long long r0 = __ldg(boff + b0) / TS_CWELL_LANES;
  const long long r1 = __ldg(boff + b1) / TS_CWELL_LANES;
  const long long pieces = (r1 - r0 + CHUNK - 1) / CHUNK;

  uint64_t policy = 0;
  if (lane == 0) {
    policy = ts_evict_first_policy();
    for (int s = 0; s < STAGES; ++s) ts_mbar_init(&full[s], 1);
    ts_fence_mbar_init();
  }
  // piece p: slot rows [r0 + p * CHUNK, + CHUNK) into stage p % STAGES
  auto fill_stage = [&](long long p) {
    const int st = (int)(p % STAGES);
    const long long r = r0 + p * CHUNK;
    const long long nr = min((long long)CHUNK, r1 - r);
    const uint32_t vb = (uint32_t)(nr * TS_CWELL_LANES * sizeof(T));
    const uint32_t ib = (uint32_t)(nr * TS_CWELL_LANES * sizeof(I));
    // the threads' reads of this stage happened before the barrier that
    // led here; order them before the async proxy's writes
    ts_fence_proxy_async();
    ts_mbar_expect_tx(&full[st], vb + ib);
    ts_bulk_load(s_val + st * PIECE, cvals + r * TS_CWELL_LANES, vb,
                 &full[st], policy);
    ts_bulk_load(s_idx + st * PIECE, idx + r * TS_CWELL_LANES, ib,
                 &full[st], policy);
  };

  long long b = b0;
  int buf = 0;  // the window-row buffer of block b
  if (b < b1) ts_load_window_rows<I>(srow, b, planes, s_srow);
  __syncthreads();  // barriers initialised, window rows loaded
  if (lane == 0)
    for (long long p = 0; p < STAGES - 1 && p < pieces; ++p) fill_stage(p);
  long long bend = b < b1 ? __ldg(boff + b + 1) / TS_CWELL_LANES : r1;
  A acc = A(0);
  for (long long p = 0; p < pieces; ++p) {
    if (lane == 0 && p + STAGES - 1 < pieces) fill_stage(p + STAGES - 1);
    const int st = (int)(p % STAGES);
    ts_mbar_wait(&full[st], (uint32_t)((p / STAGES) & 1));
    const T* sv = s_val + st * PIECE + lane;
    const I* si = s_idx + st * PIECE + lane;
    const long long ps = r0 + p * CHUNK;  // the piece's first slot row
    const long long pe = min(ps + CHUNK, r1);
    long long r = ps;
    while (r < pe) {
      if (r == bend) {  // block b ends here, at the same row for every thread
        do {
          const long long row = b * TS_CWELL_LANES + lane;
          if (row < n_rows) y[row] = ts_narrow<X>(acc);
          acc = A(0);
          ++b;
          bend = __ldg(boff + b + 1) / TS_CWELL_LANES;
        } while (r == bend);
        if constexpr (sizeof(I) == 2) {
          buf ^= 1;
          ts_load_window_rows<I>(srow, b, planes, s_srow + buf * planes);
          __syncthreads();
        }
      }
      const int* sw = s_srow + buf * planes;
      const int j1 = (int)(min(pe, bend) - ps);
#pragma unroll 4
      for (int j = (int)(r - ps); j < j1; ++j) {
        const auto a = ts_widen(sv[j * TS_CWELL_LANES]);
        const I ci = si[j * TS_CWELL_LANES];
        if (a != decltype(a)(0))
          acc += a * ts_widen(ts_ldg(x + ts_slot_col(ci, sw)));
      }
      r = ps + j1;
    }
    __syncthreads();  // every warp is done with stage st: it may be refilled
  }
  // the last block's sum, then the empty blocks after it
  for (; b < b1; ++b) {
    const long long row = b * TS_CWELL_LANES + lane;
    if (row < n_rows) y[row] = ts_narrow<X>(acc);
    acc = A(0);
  }
}

// The ring's CTAs that fit on the current device at `smem` bytes of
// dynamic shared memory: asked once per (device, size) and kept, under a
// lock, per instance of the kernel.
template <typename T, typename X, typename I, int CHUNK, int STAGES>
static int ts_ring_ctas(size_t smem, long long* ctas) {
  static std::mutex lock;
  static std::map<std::pair<int, size_t>, long long> known;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> hold(lock);
  auto it = known.find({dev, smem});
  if (it == known.end()) {
    auto kernel = cwell_spmv_ring<T, X, I, CHUNK, STAGES>;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, TS_CWELL_LANES, smem);
    if (e != cudaSuccess) return (int)e;
    it = known.emplace(std::make_pair(dev, smem),
                       (long long)sms * (per_sm > 0 ? per_sm : 1)).first;
  }
  *ctas = it->second;
  return 0;
}

// One launch of the design CHUNK x STAGES (0 x 0: plain loads).
template <typename T, typename X, typename I, int CHUNK, int STAGES>
static int launch_cwell_spmv(const T* cvals, const I* idx, const int* srow,
                             const long long* boff, const X* x, X* y,
                             long long n_blocks, long long planes,
                             long long n_rows, cudaStream_t stream) {
  if (n_blocks < 0 || planes < 0 || n_rows < 0 ||
      n_rows > n_blocks * TS_CWELL_LANES ||
      (sizeof(I) == 2 && planes > TS_CWELL_NARROW_PLANES) ||
      planes > 0x7fffffffLL || ((uintptr_t)cvals | (uintptr_t)idx) % 16)
    return TS_BAD_ARGUMENT;
  if (n_rows == 0) return 0;
  if constexpr (CHUNK == 0) {
    const long long grid =
        n_blocks < TS_CWELL_MAX_GRID ? n_blocks : TS_CWELL_MAX_GRID;
    cwell_spmv_plain<T, X, I><<<(int)grid, TS_CWELL_LANES, 0, stream>>>(
        cvals, idx, srow, boff, x, y, n_blocks, (int)planes, n_rows);
  } else {
    static_assert(ts_ring_smem_bytes<T, I, CHUNK, STAGES>(
                      TS_CWELL_NARROW_PLANES) <= 48 * 1024,
                  "the ring must fit the default dynamic shared memory");
    const size_t smem = ts_ring_smem_bytes<T, I, CHUNK, STAGES>(planes);
    long long ctas = 0;
    const int rc = ts_ring_ctas<T, X, I, CHUNK, STAGES>(smem, &ctas);
    if (rc != 0) return rc;
    const long long grid = ctas < n_blocks ? ctas : n_blocks;
    cwell_spmv_ring<T, X, I, CHUNK, STAGES>
        <<<(int)grid, TS_CWELL_LANES, smem, stream>>>(
            cvals, idx, srow, boff, x, y, n_blocks, (int)planes, n_rows);
  }
  return (int)cudaGetLastError();
}

template <typename T, typename X = T>
static int cwell_spmv_entry(const T* cvals, const void* idx, const int* srow,
                            const long long* boff, const X* x, X* y,
                            long long n_blocks, long long planes,
                            long long n_rows, int wide, cudaStream_t stream) {
  constexpr int C = TsCwellDesign<T>::chunk, S = TsCwellDesign<T>::stages;
  if (wide)
    return launch_cwell_spmv<T, X, int, C, S>(
        cvals, static_cast<const int*>(idx), srow, boff, x, y, n_blocks,
        planes, n_rows, stream);
  return launch_cwell_spmv<T, X, unsigned short, C, S>(
      cvals, static_cast<const unsigned short*>(idx), srow, boff, x, y,
      n_blocks, planes, n_rows, stream);
}

extern "C" int ts_cwell_spmv_f32(const float* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const float* x, float* y, long long n_blocks,
                                 long long planes, long long n_rows, int wide,
                                 cudaStream_t stream) {
  return cwell_spmv_entry<float>(cvals, idx, srow, boff, x, y, n_blocks,
                                 planes, n_rows, wide, stream);
}

extern "C" int ts_cwell_spmv_f64(const double* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const double* x, double* y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, int wide,
                                 cudaStream_t stream) {
  return cwell_spmv_entry<double>(cvals, idx, srow, boff, x, y, n_blocks,
                                  planes, n_rows, wide, stream);
}

extern "C" int ts_cwell_spmv_c64(const ts_c64* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const ts_c64* x, ts_c64* y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, int wide,
                                 cudaStream_t stream) {
  return cwell_spmv_entry<ts_c64>(cvals, idx, srow, boff, x, y, n_blocks,
                                  planes, n_rows, wide, stream);
}

extern "C" int ts_cwell_spmv_c128(const ts_c128* cvals, const void* idx,
                                  const int* srow, const long long* boff,
                                  const ts_c128* x, ts_c128* y,
                                  long long n_blocks, long long planes,
                                  long long n_rows, int wide,
                                  cudaStream_t stream) {
  return cwell_spmv_entry<ts_c128>(cvals, idx, srow, boff, x, y, n_blocks,
                                   planes, n_rows, wide, stream);
}

// bf16 values (K4's ring): with a bf16 x (y bf16) and with a float x (y
// float); the sum runs in float either way.
extern "C" int ts_cwell_spmv_bf16(const ts_bf16* cvals, const void* idx,
                                  const int* srow, const long long* boff,
                                  const ts_bf16* x, ts_bf16* y,
                                  long long n_blocks, long long planes,
                                  long long n_rows, int wide,
                                  cudaStream_t stream) {
  return cwell_spmv_entry<ts_bf16>(cvals, idx, srow, boff, x, y, n_blocks,
                                   planes, n_rows, wide, stream);
}

extern "C" int ts_cwell_spmv_bf16_f32(const ts_bf16* cvals, const void* idx,
                                      const int* srow, const long long* boff,
                                      const float* x, float* y,
                                      long long n_blocks, long long planes,
                                      long long n_rows, int wide,
                                      cudaStream_t stream) {
  return cwell_spmv_entry<ts_bf16, float>(cvals, idx, srow, boff, x, y,
                                          n_blocks, planes, n_rows, wide,
                                          stream);
}
