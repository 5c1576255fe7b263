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
// times them beside the first design (spmm_v1.cuh) on one card.
//
// Offsets are 64-bit (col * k passes 2^31 at m = 4.1M, k = 128) and there
// are no atomics: reruns give the same bits.

#include <cstdint>

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

// NT threads a CTA; BULK: bulk async copies (else plain loads) of the
// slots; V: columns a thread loads at once; tpr: threads a row (a power of
// two up to 32); piece: slot rows staged at once.
template <typename T, typename I, int V, int NT, bool BULK>
__global__ void __launch_bounds__(NT)
cwell_spmm_compact(const T* __restrict__ cvals, const I* __restrict__ idx,
                   const int* __restrict__ srow,
                   const long long* __restrict__ boff,
                   const T* __restrict__ B, T* __restrict__ Y,
                   long long n_blocks, int planes, long long n_rows, int k,
                   int tpr, int piece) {
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
          T* yp = Y + row * k + j;
          T acc[V];
          if (p0 == 0) {
#pragma unroll
            for (int v = 0; v < V; ++v) acc[v] = T(0);
          } else {
            ts_vec_load<T, V>(yp, acc);  // the sums of the earlier pieces
          }
          const T* sv = s_val + r;
          const I* si = s_idx + r;
#pragma unroll 4
          for (int q = 0; q < nr; ++q) {
            const T a = sv[q * TS_CWELL_LANES];
            if (a != T(0)) {
              T bv[V];
              ts_vec_ldg<T, V>(
                  B + ts_slot_col(si[q * TS_CWELL_LANES], s_srow) * k + j,
                  bv);
#pragma unroll
              for (int v = 0; v < V; ++v) acc[v] += a * bv[v];
            }
          }
          ts_vec_st<T, V>(yp, acc);
        }
      }
    }
  }
}

template <typename T, typename I, int V, int NT, bool BULK>
static void launch_spmm_instance(int grid, size_t smem, cudaStream_t stream,
                                 const T* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const T* B, T* Y, long long n_blocks,
                                 int planes, long long n_rows, int k, int tpr,
                                 int piece) {
  cwell_spmm_compact<T, I, V, NT, BULK><<<grid, NT, smem, stream>>>(
      cvals, static_cast<const I*>(idx), srow, boff, B, Y, n_blocks, planes,
      n_rows, k, tpr, piece);
}

// One launch of the design NT x BULK; `depth` is the plan's largest L_b.
template <typename T, int NT, bool BULK>
static int launch_cwell_spmm(const T* cvals, const void* idx, const int* srow,
                             const long long* boff, const T* B, T* Y,
                             long long n_blocks, long long planes,
                             long long n_rows, long long k, long long depth,
                             int wide, cudaStream_t stream) {
  if (n_blocks < 0 || planes < 0 || planes > 0x7fffffffLL || n_rows < 0 ||
      n_rows > n_blocks * TS_CWELL_LANES || k < 0 || k > 0x7fffffffLL ||
      depth < 0 || (!wide && planes > TS_CWELL_NARROW_PLANES) ||
      ((uintptr_t)cvals | (uintptr_t)idx) % 16)
    return TS_BAD_ARGUMENT;
  if (n_rows == 0 || k == 0) return 0;
  const size_t slot = sizeof(T) + (wide ? sizeof(int) : sizeof(short));
  const size_t window = wide ? 0 : (size_t)planes * sizeof(int);
  const long long cap = (long long)((TS_SPMM_SMEM - window) /
                                    (TS_CWELL_LANES * slot));
  const int piece = (int)(depth < 1 ? 1 : (depth < cap ? depth : cap));
  const size_t smem = (size_t)piece * TS_CWELL_LANES * slot + window;
  // columns a thread loads at once: 16 bytes where k and the pointers allow
  const uintptr_t al = (uintptr_t)B | (uintptr_t)Y;
  int v = 1;
  if (sizeof(T) == 4 && k % 4 == 0 && al % 16 == 0)
    v = 4;
  else if (sizeof(T) <= 8 && k % 2 == 0 && al % (2 * sizeof(T)) == 0)
    v = 2;
  const long long need = (k + v - 1) / v;
  int tpr = 1;
  while (tpr < need && tpr < 32) tpr *= 2;
  const int grid =
      (int)(n_blocks < TS_SPMM_MAX_GRID ? n_blocks : TS_SPMM_MAX_GRID);
#define TS_SPMM_LAUNCH(I_, V_)                                              \
  launch_spmm_instance<T, I_, V_, NT, BULK>(                                \
      grid, smem, stream, cvals, idx, srow, boff, B, Y, n_blocks,           \
      (int)planes, n_rows, (int)k, tpr, piece)
  if (wide) {
    if (v == 1) TS_SPMM_LAUNCH(int, 1);
    if constexpr (sizeof(T) <= 8) {
      if (v == 2) TS_SPMM_LAUNCH(int, 2);
    }
    if constexpr (sizeof(T) == 4) {
      if (v == 4) TS_SPMM_LAUNCH(int, 4);
    }
  } else {
    if (v == 1) TS_SPMM_LAUNCH(unsigned short, 1);
    if constexpr (sizeof(T) <= 8) {
      if (v == 2) TS_SPMM_LAUNCH(unsigned short, 2);
    }
    if constexpr (sizeof(T) == 4) {
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
  return launch_cwell_spmm<float, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, n_blocks, planes, n_rows, k, depth, wide,
      stream);
}

extern "C" int ts_cwell_spmm_f64(const double* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const double* B, double* Y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long k,
                                 long long depth, int wide,
                                 cudaStream_t stream) {
  return launch_cwell_spmm<double, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, n_blocks, planes, n_rows, k, depth, wide,
      stream);
}

extern "C" int ts_cwell_spmm_c64(const ts_c64* cvals, const void* idx,
                                 const int* srow, const long long* boff,
                                 const ts_c64* B, ts_c64* Y,
                                 long long n_blocks, long long planes,
                                 long long n_rows, long long k,
                                 long long depth, int wide,
                                 cudaStream_t stream) {
  return launch_cwell_spmm<ts_c64, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, n_blocks, planes, n_rows, k, depth, wide,
      stream);
}

extern "C" int ts_cwell_spmm_c128(const ts_c128* cvals, const void* idx,
                                  const int* srow, const long long* boff,
                                  const ts_c128* B, ts_c128* Y,
                                  long long n_blocks, long long planes,
                                  long long n_rows, long long k,
                                  long long depth, int wide,
                                  cudaStream_t stream) {
  return launch_cwell_spmm<ts_c128, TS_SPMM_THREADS, true>(
      cvals, idx, srow, boff, B, Y, n_blocks, planes, n_rows, k, depth, wide,
      stream);
}
