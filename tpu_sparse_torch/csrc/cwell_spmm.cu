// K6 / K7: general-structure SpMM Y = W B on the row-compact plan of a
// CWELL pack, float and double, and complex64 / complex128 (ts_common.cuh's
// TsComplex).
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
// Layout: the plan K4 / K5 stream (tpu_sparse_torch/sparse/cwell_compact.py,
// described in cwell_spmv.cu): row block b holds L_b slot rows of 128 slots
// at [boff[b], boff[b+1]), slot q*128 + l the q-th nonzero of row b*128 + l
// in plane order, padding (value 0) after; a narrow index is (plane << 8)
// | idx2 in 16 bits, a wide one the int32 column. B (m, k) and Y (n, k) are
// row-major, so a gathered row of B is k contiguous values.
//
// Y[row, j] = sum over the row's slots of cvals * B[col, j], in slot order,
// in the value type; slots of value 0 are skipped. That is K4 / K5's sum of
// each column, operation for operation, so column j of Y equals K4 / K5 on
// B[:, j] bit for bit (in complex too: every product and sum of TsComplex
// is rounded on its own, never fused).
//
// Bound: device-memory bandwidth. The plan streams 6 / 10 bytes a slot in
// float / double (12 / 16 wide); B and Y move k values a row. At k = 8 on
// the 160^3 27-point plan that is ~0.93 GB, where the plane pack streamed
// 1.31 GB of padded slots alone. The gathered rows of B come from L1 / L2:
// a row block's columns span a narrow band of B.
//
// Design: one CTA of NT = 256 threads per row block (grid-stride past 2^20
// blocks; the block scheduler balances blocks of unequal L_b). The block's
// slots are contiguous, so thread 0 streams them into shared memory with
// two 1-D bulk async copies (cp.async.bulk, L2 evict-first) completing on
// an mbarrier, once, whatever k is; at most ~46 KB a piece (62 slot rows in
// float, 37 in double and complex64, 20 in complex128: the piece is sized
// by the value's bytes), so a longer block streams in pieces and carries its
// sums through Y, which reloads them exactly. The block's window rows go to
// shared memory beside them, so each slot's column decodes there. Then the
// threads walk the slots out of shared memory for every column: TPR
// consecutive threads take V consecutive columns each of one row (V = 4
// floats, 2 doubles or 2 complex64 values, one 16-byte load of B, when k
// and the pointers allow; a complex128 value is a 16-byte load alone), so
// a warp's gather is whole runs of a row of B; the CTA's rows
// are spread over its warps; column tiles of TPR * V columns follow each
// other over the same staged slots. One accumulator per (row, column) in
// registers. Several CTAs a SM hide one block's copy behind another's
// gathers.
//
// `python3 -m tpu_sparse_torch.kernels.spmm_probe` instantiates the design
// with 128 threads and with plain loads in place of the bulk copies, and
// times them on one card.
//
// Offsets are 64-bit (col * k passes 2^31 at m = 4.1M, k = 128) and there
// are no atomics: reruns give the same bits.

#include <cstdint>
#include <type_traits>

#include "ts_async.cuh"

#define TS_SPMM_THREADS 256
#define TS_SPMM_MAX_GRID (1 << 20)
// Dynamic shared memory a CTA takes at most: under the 48 KB that every
// kernel may take without asking.
#define TS_SPMM_SMEM (46 * 1024)

// V consecutive values of B (read-only for the kernel's lifetime).
template <typename T, int V>
__device__ __forceinline__ void ts_vec_ldg(const T* p, T (&o)[V]) {
  if constexpr (ts_is_complex<T>::value && V == 2) {
    static_assert(sizeof(T) == 8, "two complex128 values are 32 bytes");
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = T(q.x, q.y); o[1] = T(q.z, q.w);
  } else if constexpr (ts_is_complex<T>::value) {
    o[0] = ts_ldg(p);
  } else if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else if constexpr (V == 2 && sizeof(T) == 8) {
    const double2 q = __ldg(reinterpret_cast<const double2*>(p));
    o[0] = q.x; o[1] = q.y;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    o[0] = q.x; o[1] = q.y;
  } else {
    o[0] = __ldg(p);
  }
}

// V consecutive bf16 values of B (one 8-, 4- or 2-byte load), widened.
template <int V>
__device__ __forceinline__ void ts_vec_ldg_bf16(const ts_bf16* p,
                                                float (&o)[V]) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  if constexpr (V == 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(q));
    o[0] = __uint_as_float(u.x << 16); o[1] = __uint_as_float(u.x & 0xffff0000u);
    o[2] = __uint_as_float(u.y << 16); o[3] = __uint_as_float(u.y & 0xffff0000u);
  } else if constexpr (V == 2) {
    const unsigned int u = __ldg(reinterpret_cast<const unsigned int*>(q));
    o[0] = __uint_as_float(u << 16); o[1] = __uint_as_float(u & 0xffff0000u);
  } else {
    o[0] = ts_bf16_bits_to_float(__ldg(q));
  }
}

template <typename T, int V>
__device__ __forceinline__ void ts_vec_st(T* p, const T (&o)[V]) {
  if constexpr (ts_is_complex<T>::value && V == 2)
    *reinterpret_cast<float4*>(p) =
        make_float4(o[0].re, o[0].im, o[1].re, o[1].im);
  else if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  else if constexpr (V == 2 && sizeof(T) == 8)
    *reinterpret_cast<double2*>(p) = make_double2(o[0], o[1]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(o[0], o[1]);
  else
    p[0] = o[0];
}

// V float sums rounded once to bf16 and stored (one 8-, 4- or 2-byte
// store).
template <int V>
__device__ __forceinline__ void ts_vec_st_bf16(ts_bf16* p,
                                               const float (&o)[V]) {
  unsigned short h[V];
#pragma unroll
  for (int v = 0; v < V; ++v) h[v] = __bfloat16_as_ushort(__float2bfloat16_rn(o[v]));
  if constexpr (V == 4)
    *reinterpret_cast<uint2*>(p) =
        make_uint2(h[0] | ((unsigned int)h[1] << 16),
                   h[2] | ((unsigned int)h[3] << 16));
  else if constexpr (V == 2)
    *reinterpret_cast<unsigned int*>(p) = h[0] | ((unsigned int)h[1] << 16);
  else
    *reinterpret_cast<unsigned short*>(p) = h[0];
}

// V values of B into sums of type A (widened where B is bf16), and V sums
// out as Y (rounded where Y is bf16).
template <typename X, typename A, int V>
__device__ __forceinline__ void ts_vec_ldg_as(const X* p, A (&o)[V]) {
  if constexpr (std::is_same<X, A>::value)
    ts_vec_ldg<X, V>(p, o);
  else
    ts_vec_ldg_bf16<V>(p, o);
}

template <typename Y, typename A, int V>
__device__ __forceinline__ void ts_vec_st_as(Y* p, const A (&o)[V]) {
  if constexpr (std::is_same<Y, A>::value)
    ts_vec_st<Y, V>(p, o);
  else
    ts_vec_st_bf16<V>(p, o);
}

// T: the values' type; X: B's; Y: Y's, the common type (a bf16 Y only
// for bf16 values and a bf16 B). The sums run in A = ts_acc_t<T, X>. A
// block of more than one piece carries its sums from piece to piece
// through `carry` (n, k) of A: Y itself where Y is A, else a workspace,
// so a bf16 Y is rounded once, as K4's y is.
// NT threads a CTA; BULK: bulk async copies (else plain loads) of the
// slots; V: columns a thread loads at once; tpr: threads a row (a power of
// two up to 32); piece: slot rows staged at once.
template <typename T, typename X, typename Y, typename I, int V, int NT,
          bool BULK>
__global__ void __launch_bounds__(NT)
cwell_spmm_compact(const T* __restrict__ cvals, const I* __restrict__ idx,
                   const int* __restrict__ srow,
                   const long long* __restrict__ boff,
                   const X* __restrict__ B, Y* __restrict__ Yo,
                   ts_acc_t<T, X>* __restrict__ carry, long long n_blocks,
                   int planes, long long n_rows, int k, int tpr, int piece) {
  using A = ts_acc_t<T, X>;
  extern __shared__ __align__(128) unsigned char ts_smem[];
  T* s_val = reinterpret_cast<T*>(ts_smem);
  I* s_idx = reinterpret_cast<I*>(s_val + piece * TS_CWELL_LANES);
  int* s_srow = reinterpret_cast<int*>(s_idx + piece * TS_CWELL_LANES);
  __shared__ uint64_t full;

  const int tid = threadIdx.x;
  const int sub = tid % tpr;     // this thread's place in its row's group
  const int rpass = NT / tpr;    // rows the CTA covers at once
  const int ct = tpr * V;        // columns a tile
  const int tiles = (k + ct - 1) / ct;
  uint64_t policy = 0;
  if (BULK && tid == 0) {
    policy = ts_evict_first_policy();
    ts_mbar_init(&full, 1);
    ts_fence_mbar_init();
  }
  uint32_t parity = 0;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long o0 = __ldg(boff + b);
    const int len = (int)((__ldg(boff + b + 1) - o0) / TS_CWELL_LANES);
    // pieces of the block's slot rows; an empty block runs one, of none
    for (int p0 = 0; p0 == 0 || p0 < len; p0 += piece) {
      const int nr = min(piece, len - p0);
      const bool last = p0 + piece >= len;
      __syncthreads();  // the last piece's reads (the barrier's init) done
      if (p0 == 0) ts_load_window_rows<I>(srow, b, planes, s_srow);
      const T* gv = cvals + o0 + (long long)p0 * TS_CWELL_LANES;
      const I* gi = idx + o0 + (long long)p0 * TS_CWELL_LANES;
      if constexpr (BULK) {
        if (tid == 0 && nr > 0) {
          const uint32_t vb = (uint32_t)(nr * TS_CWELL_LANES * sizeof(T));
          const uint32_t ib = (uint32_t)(nr * TS_CWELL_LANES * sizeof(I));
          ts_fence_proxy_async();
          ts_mbar_expect_tx(&full, vb + ib);
          ts_bulk_load(s_val, gv, vb, &full, policy);
          ts_bulk_load(s_idx, gi, ib, &full, policy);
        }
      } else {
        for (int e = tid; e < nr * TS_CWELL_LANES; e += NT) {
          s_val[e] = ts_ldcs(gv + e);
          s_idx[e] = __ldcs(gi + e);
        }
      }
      __syncthreads();  // window rows (and plain-loaded slots) visible
      if constexpr (BULK) {
        if (nr > 0) {
          ts_mbar_wait(&full, parity);
          parity ^= 1;
        }
      }
      for (int t = 0; t < tiles; ++t) {
        const int j = t * ct + sub * V;  // j + V <= k when j < k
        if (j >= k) continue;
        for (int r = tid / tpr; r < TS_CWELL_LANES; r += rpass) {
          const long long row = b * TS_CWELL_LANES + r;
          if (row >= n_rows) break;
          A* cp = carry + row * k + j;
          A acc[V];
          if (p0 == 0) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = A(0);
          } else {
            ts_vec_load<A, V>(cp, acc);  // the sums of the earlier pieces
          }
          const T* sv = s_val + r;
          const I* si = s_idx + r;
#pragma unroll 4
          for (int q = 0; q < nr; ++q) {
            const auto a = ts_widen(sv[q * TS_CWELL_LANES]);
            if (a != decltype(a)(0)) {
              A bv[V];
              ts_vec_ldg_as<X, A, V>(
                  B + ts_slot_col(si[q * TS_CWELL_LANES], s_srow) * k + j,
                  bv);
#pragma unroll
              for (int v = 0; v < V; ++v) acc[v] += a * bv[v];
            }
          }
          if (last)
            ts_vec_st_as<Y, A, V>(Yo + row * k + j, acc);
          else
            ts_vec_st<A, V>(cp, acc);
        }
      }
    }
  }
}

template <typename T, typename X, typename Y, typename I, int V, int NT,
          bool BULK>
static void launch_spmm_instance(int grid, size_t smem, cudaStream_t stream,
                                 const T* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const X* B, Y* Yo, ts_acc_t<T, X>* carry,
                                 long long n_blocks, int planes,
                                 long long n_rows, int k, int tpr,
                                 int piece) {
  cwell_spmm_compact<T, X, Y, I, V, NT, BULK><<<grid, NT, smem, stream>>>(
      cvals, static_cast<const I*>(idx), srow, boff, B, Yo, carry, n_blocks,
      planes, n_rows, k, tpr, piece);
}

// Slot rows a piece stages at most (the host mirror is
// cuda_cwell._spmm_piece_cap).
template <typename T>
static long long ts_spmm_piece_cap(long long planes, int wide) {
  const size_t slot = sizeof(T) + (wide ? sizeof(int) : sizeof(short));
  const size_t window = wide ? 0 : (size_t)planes * sizeof(int);
  return (long long)((TS_SPMM_SMEM - window) / (TS_CWELL_LANES * slot));
}

// One launch of the design NT x BULK; `depth` is the plan's largest L_b.
// `work`: an (n, k) workspace of the sum type, needed (else refused) where
// Y's type is not the sum type and a block takes more than one piece.
template <typename T, typename X, typename Y, int NT, bool BULK>
static int launch_cwell_spmm(const T* cvals, const void* idx, const int* srow,
                             const long long* boff, const X* B, Y* Yo,
                             ts_acc_t<T, X>* work, long long n_blocks,
                             long long planes, long long n_rows, long long k,
                             long long depth, int wide, cudaStream_t stream) {
  using A = ts_acc_t<T, X>;
  if (n_blocks < 0 || planes < 0 || planes > 0x7fffffffLL || n_rows < 0 ||
      n_rows > n_blocks * TS_CWELL_LANES || k < 0 || k > 0x7fffffffLL ||
      depth < 0 || (!wide && planes > TS_CWELL_NARROW_PLANES) ||
      ((uintptr_t)cvals | (uintptr_t)idx) % 16)
    return TS_BAD_ARGUMENT;
  if (n_rows == 0 || k == 0) return 0;
  const size_t slot = sizeof(T) + (wide ? sizeof(int) : sizeof(short));
  const size_t window = wide ? 0 : (size_t)planes * sizeof(int);
  const long long cap = ts_spmm_piece_cap<T>(planes, wide);
  const int piece = (int)(depth < 1 ? 1 : (depth < cap ? depth : cap));
  const size_t smem = (size_t)piece * TS_CWELL_LANES * slot + window;
  A* carry;
  if constexpr (std::is_same<Y, A>::value) {
    carry = Yo;
  } else {
    if (depth > piece && work == nullptr) return TS_BAD_ARGUMENT;
    carry = work;
  }
  // columns a thread loads at once: 16 bytes of the widest of B, Y and
  // the carry where k and the pointers allow
  constexpr size_t wmax = sizeof(X) > sizeof(Y)
                              ? (sizeof(X) > sizeof(A) ? sizeof(X) : sizeof(A))
                              : (sizeof(Y) > sizeof(A) ? sizeof(Y) : sizeof(A));
  auto aligned = [&](int v) {
    return (uintptr_t)B % (v * sizeof(X)) == 0 &&
           (uintptr_t)Yo % (v * sizeof(Y)) == 0 &&
           (uintptr_t)carry % (v * sizeof(A)) == 0;
  };
  int v = 1;
  if (wmax == 4 && k % 4 == 0 && aligned(4))
    v = 4;
  else if (wmax <= 8 && k % 2 == 0 && aligned(2))
    v = 2;
  const long long need = (k + v - 1) / v;
  int tpr = 1;
  while (tpr < need && tpr < 32) tpr *= 2;
  const int grid =
      (int)(n_blocks < TS_SPMM_MAX_GRID ? n_blocks : TS_SPMM_MAX_GRID);
#define TS_SPMM_LAUNCH(I_, V_)                                              \
  launch_spmm_instance<T, X, Y, I_, V_, NT, BULK>(                          \
      grid, smem, stream, cvals, idx, srow, boff, B, Yo, carry, n_blocks,   \
      (int)planes, n_rows, (int)k, tpr, piece)
  if (wide) {
    if (v == 1) TS_SPMM_LAUNCH(int, 1);
    if constexpr (wmax <= 8) {
      if (v == 2) TS_SPMM_LAUNCH(int, 2);
    }
    if constexpr (wmax == 4) {
      if (v == 4) TS_SPMM_LAUNCH(int, 4);
    }
  } else {
    if (v == 1) TS_SPMM_LAUNCH(unsigned short, 1);
    if constexpr (wmax <= 8) {
      if (v == 2) TS_SPMM_LAUNCH(unsigned short, 2);
    }
    if constexpr (wmax == 4) {
      if (v == 4) TS_SPMM_LAUNCH(unsigned short, 4);
    }
  }
#undef TS_SPMM_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int ts_cwell_spmm_f32(const float* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const float* B, float* Y, long long n_blocks,
                                 long long planes, long long n_rows,
                                 long long k, long long depth, int wide,
                                 cudaStream_t stream) {
  return launch_cwell_spmm<float, float, float, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, nullptr, n_blocks, planes, n_rows, k,
      depth, wide, stream);
}

extern "C" int ts_cwell_spmm_f64(const double* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const double* B, double* Y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long k,
                                 long long depth, int wide,
                                 cudaStream_t stream) {
  return launch_cwell_spmm<double, double, double, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, nullptr, n_blocks, planes, n_rows, k,
      depth, wide, stream);
}

extern "C" int ts_cwell_spmm_c64(const ts_c64* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const ts_c64* B, ts_c64* Y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long k,
                                 long long depth, int wide,
                                 cudaStream_t stream) {
  return launch_cwell_spmm<ts_c64, ts_c64, ts_c64, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, nullptr, n_blocks, planes, n_rows, k,
      depth, wide, stream);
}

extern "C" int ts_cwell_spmm_c128(const ts_c128* cvals, const void* idx,
                                  const int* srow, const long long* boff,
                                  const ts_c128* B, ts_c128* Y,
                                  long long n_blocks, long long planes,
                                  long long n_rows, long long k,
                                  long long depth, int wide,
                                  cudaStream_t stream) {
  return launch_cwell_spmm<ts_c128, ts_c128, ts_c128, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, nullptr, n_blocks, planes, n_rows, k,
      depth, wide, stream);
}

// bf16 builds: bf16 values with a bf16 B (Y bf16, carried through the
// float workspace `work` across pieces) or a float B (Y float), and float
// values with a bf16 B (Y float); the sums run in float.
extern "C" int ts_cwell_spmm_bf16(const ts_bf16* cvals, const void* idx,
                                  const int* srow, const long long* boff,
                                  const ts_bf16* B, ts_bf16* Y, float* work,
                                  long long n_blocks, long long planes,
                                  long long n_rows, long long k,
                                  long long depth, int wide,
                                  cudaStream_t stream) {
  return launch_cwell_spmm<ts_bf16, ts_bf16, ts_bf16, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, work, n_blocks, planes, n_rows, k, depth,
      wide, stream);
}

extern "C" int ts_cwell_spmm_bf16_f32(const ts_bf16* cvals, const void* idx,
                                      const int* srow, const long long* boff,
                                      const float* B, float* Y, float* work,
                                      long long n_blocks, long long planes,
                                      long long n_rows, long long k,
                                      long long depth, int wide,
                                      cudaStream_t stream) {
  return launch_cwell_spmm<ts_bf16, float, float, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, work, n_blocks, planes, n_rows, k, depth,
      wide, stream);
}

extern "C" int ts_cwell_spmm_f32_bf16(const float* cvals, const void* idx,
                                      const int* srow, const long long* boff,
                                      const ts_bf16* B, float* Y, float* work,
                                      long long n_blocks, long long planes,
                                      long long n_rows, long long k,
                                      long long depth, int wide,
                                      cudaStream_t stream) {
  return launch_cwell_spmm<float, ts_bf16, float, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, work, n_blocks, planes, n_rows, k, depth,
      wide, stream);
}
