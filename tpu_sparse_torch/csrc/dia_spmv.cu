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
// Extended mode (the first design): one thread per row in a grid-stride loop;
// thread i reads data[d, i] for each d, so every diagonal read is
// coalesced along i. It works on vectors [0..0 | x | 0..0] whose margins
// (>= the bandwidth) are zero, so it needs no masks and writes the output
// margins as zero.
//
// Plain mode (redesigned; the first design, v1, is dia_spmv_v1.cuh and the
// bit-for-bit reference). What held v1 (0.44-0.84 of the bound): a column
// test on every term, a diagonal loop of run-time length reading its
// offsets from shared memory, so few loads in flight a thread, and a grid
// capped at 1,024 CTAs. Here:
// * the rows whose every column is in range form one interval [lo, hi),
//   computed on the host; a tile wholly inside it sums without tests
//   (98.7% of the rows at 160^3), the edge tiles test each column;
// * the diagonal loop is unrolled for the generators' counts (3, 5, 7, 9,
//   27; the offsets then come from the parameter bank), so a thread issues
//   all its data and x loads before its first multiply-add (70 registers
//   in float at 27 diagonals, one row a thread);
// * one CTA a tile, no grid-stride loop: 8,000 or 16,000 CTAs at 160^3.
// Three designs (dia_spmv_probe times them beside v1 on one card): strided
// (a CTA owns 256 R rows, thread t the rows t + 256 r: v1's coalesced
// loads, R rows in registers), vector (R consecutive rows a thread, each
// diagonal's R values as one vector load of 4, 8 or 16 bytes; x read at a
// stride of R values, R times the L1 wavefronts of a coalesced read) and
// ring (a persistent grid streaming (ndiag x T) boxes of data through
// shared memory by bulk async copies). Each build ships the fastest at
// 160^3 (TsDiaShipped): vector R = 2 for f32 (8-byte loads; strided R = 1
// within 1%); vector R = 2 at 4 CTAs a SM for both bf16 builds (a bf16
// pair in one 4-byte load, so a warp's load is a whole 128-byte line: 0.76
// / 0.74 of the bound, where 2-byte loads reached 0.64 / 0.61 and 16-byte
// ones 0.48 / 0.63); strided R = 1 for c64 and c128, and for f64 at 8 CTAs
// a SM (one wave at 64^3). The ring lost everywhere: each tile waits for
// its x loads after its data has landed. Grids short of two CTAs a SM (the
// LDC's 65,536 rows, the AMG's small levels) and data the vector loads do
// not fit take one row a thread: one launch per SpMV either way.
//
// The offsets ride by value in the parameters (at most TS_MAX_DIAG; the
// host entry refuses more rather than truncating). No Pallas
// chunk/halo-window structure is carried over: the TPU staged x windows
// through VMEM by DMA; here the caches do that work.

#include <cstring>

#include "dia_spmv_v1.cuh"
#include "ts_common.cuh"

// ---- plain mode -----------------------------------------------------------

// The plain mode's designs (the third, the ring, is in dia_spmv_ring.cuh;
// only the probe launches it):
// TS_DIA_STRIDED, a CTA owns a tile of TS_BLOCK * R rows and thread t the
// rows base + t + TS_BLOCK * r (every load coalesced, as v1's); and
// TS_DIA_VECTOR, thread t owns R consecutive rows and reads each
// diagonal's R values as one vector (R * sizeof(V) = 4, 8 or a multiple of
// 16 bytes).
// R = 1 is one row a thread in either: the scalar path.
#define TS_DIA_STRIDED 0
#define TS_DIA_VECTOR 1

// Diagonal counts with an unrolled instance (the stencils of the
// generators: tridiagonal, 5- and 9-point 2-D, 7- and 27-point 3-D); any
// other count runs the generic loop.
#define TS_DIA_FOR_EACH_ND(M) M(3) M(5) M(7) M(9) M(27)

// d's offset: from the parameter bank when the loop is unrolled (d is a
// constant), from shared memory in the generic loop.
template <int ND>
__device__ __forceinline__ long long ts_dia_off(const TsOffsets& offs,
                                                const int* s_off, int d) {
  if constexpr (ND > 0)
    return offs.o[d];
  else
    return s_off[d];
}

template <int ND, typename F>
__device__ __forceinline__ void ts_for_diag(int ndiag, F&& f) {
  if constexpr (ND > 0) {
#pragma unroll
    for (int d = 0; d < ND; ++d) f(d);
  } else {
    for (int d = 0; d < ndiag; ++d) f(d);
  }
}

// R consecutive values from an address aligned to their R * sizeof(V)
// bytes (4, 8, 16 or a multiple of 16), as vector streaming loads of up to
// 16 bytes.
template <typename V, int R>
__device__ __forceinline__ void ts_ldcs_rows(const V* p, V (&v)[R]) {
  constexpr int B = R * (int)sizeof(V);
  static_assert(B == 4 || B == 8 || B % 16 == 0, "a whole vector");
  if constexpr (B == 4) {
    const unsigned int q = __ldcs(reinterpret_cast<const unsigned int*>(p));
    memcpy(v, &q, B);
  } else if constexpr (B == 8) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    memcpy(v, &q, B);
  } else {
    uint4 buf[B / 16];
#pragma unroll
    for (int k = 0; k < B / 16; ++k)
      buf[k] = __ldcs(reinterpret_cast<const uint4*>(p) + k);
    memcpy(v, buf, B);
  }
}

// One row of an edge tile: every column tested against [0, n_cols), a term
// outside skipped (never read as data x 0).
template <typename V, typename X, int ND>
__device__ __forceinline__ void ts_dia_edge_row(
    const V* __restrict__ data, long long ld, const TsOffsets& offs,
    const int* s_off, int ndiag, const X* __restrict__ x, X* __restrict__ y,
    long long i, long long n_cols) {
  ts_acc_t<V, X> acc = ts_acc_t<V, X>(0);
  ts_for_diag<ND>(ndiag, [&](int d) {
    const long long j = i + ts_dia_off<ND>(offs, s_off, d);
    if (j >= 0 && j < n_cols)
      acc += ts_widen(ts_ldcs(data + d * ld + i)) * ts_widen(ts_ldg(x + j));
  });
  y[i] = ts_narrow<X>(acc);
}

// Every row sums its diagonals in offsets order from 0 with v1's
// expression (the same widening and multiply-add contraction, the same
// TsComplex operations), so both designs equal v1 bit for bit. Rows in
// [lo, hi) have every column in range: a tile wholly inside takes the
// path without tests.
template <typename V, typename X, int R, int ND, int MINB>
__global__ void __launch_bounds__(TS_BLOCK, MINB)
dia_spmv_strided_kernel(const V* __restrict__ data, long long ld,
                        TsOffsets offs, int ndiag, const X* __restrict__ x,
                        X* __restrict__ y, long long n_rows, long long n_cols,
                        long long lo, long long hi) {
  using A = ts_acc_t<V, X>;
  __shared__ int s_off[ND > 0 ? 1 : TS_MAX_DIAG];
  if constexpr (ND == 0) ts_load_offsets(offs, ndiag, s_off);
  const long long base = (long long)blockIdx.x * (TS_BLOCK * R);
  const long long i0 = base + threadIdx.x;
  if (base >= lo && base + TS_BLOCK * R <= hi) {
    A acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = A(0);
    ts_for_diag<ND>(ndiag, [&](int d) {
      const V* dp = data + d * ld + i0;
      const X* xp = x + (i0 + ts_dia_off<ND>(offs, s_off, d));
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] += ts_widen(ts_ldcs(dp + r * TS_BLOCK)) *
                  ts_widen(ts_ldg(xp + r * TS_BLOCK));
    });
#pragma unroll
    for (int r = 0; r < R; ++r) y[i0 + r * TS_BLOCK] = ts_narrow<X>(acc[r]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long i = i0 + r * TS_BLOCK;
      if (i < n_rows)
        ts_dia_edge_row<V, X, ND>(data, ld, offs, s_off, ndiag, x, y, i,
                                  n_cols);
    }
  }
}

template <typename V, typename X, int R, int ND, int MINB>
__global__ void __launch_bounds__(TS_BLOCK, MINB)
dia_spmv_vector_kernel(const V* __restrict__ data, long long ld,
                       TsOffsets offs, int ndiag, const X* __restrict__ x,
                       X* __restrict__ y, long long n_rows, long long n_cols,
                       long long lo, long long hi) {
  using A = ts_acc_t<V, X>;
  __shared__ int s_off[ND > 0 ? 1 : TS_MAX_DIAG];
  if constexpr (ND == 0) ts_load_offsets(offs, ndiag, s_off);
  const long long i0 = ((long long)blockIdx.x * TS_BLOCK + threadIdx.x) * R;
  if (i0 >= n_rows) return;
  if (i0 >= lo && i0 + R <= hi) {
    A acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = A(0);
    ts_for_diag<ND>(ndiag, [&](int d) {
      V v[R];
      ts_ldcs_rows<V, R>(data + d * ld + i0, v);
      const X* xp = x + (i0 + ts_dia_off<ND>(offs, s_off, d));
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] += ts_widen(v[r]) * ts_widen(ts_ldg(xp + r));
    });
#pragma unroll
    for (int r = 0; r < R; ++r) y[i0 + r] = ts_narrow<X>(acc[r]);
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (i0 + r < n_rows)
        ts_dia_edge_row<V, X, ND>(data, ld, offs, s_off, ndiag, x, y, i0 + r,
                                  n_cols);
    }
  }
}

// What the host entry decides per call, from the operands' shapes and the
// data's address alone (no device query but the SM count, read once).
struct TsDiaGeometry {
  long long lo, hi;  // the interior rows
  long long grid;    // CTAs of TS_BLOCK threads
  int rows;          // rows a thread (1: the scalar path)
  int design;
};

// The interior [lo, hi): row i has every column i + o in [0, n_cols) iff
// lo <= i < hi (every row when there are no diagonals). Rows a thread: the
// design's R when its loads fit (the vector design needs the data pointer
// and the row length ld aligned to its vector, min(R * sizeof(V), 16)
// bytes) and the grid still has two CTAs a SM; else one row a thread, on
// the strided design (mirrored by cuda_spmv.plain_geometry).
static TsDiaGeometry ts_dia_geometry(const TsOffsets& offs, int ndiag,
                                     long long n_rows, long long n_cols,
                                     long long ld, unsigned long long addr,
                                     int vsize, int design, int rows,
                                     int sms) {
  TsDiaGeometry g;
  g.lo = 0;
  g.hi = n_rows;
  if (ndiag > 0) {
    int mn = offs.o[0], mx = offs.o[0];
    for (int d = 1; d < ndiag; ++d) {
      mn = offs.o[d] < mn ? offs.o[d] : mn;
      mx = offs.o[d] > mx ? offs.o[d] : mx;
    }
    const long long lo = -(long long)mn, hi = n_cols - (long long)mx;
    g.lo = lo < 0 ? 0 : (lo > n_rows ? n_rows : lo);
    g.hi = hi > n_rows ? n_rows : (hi < g.lo ? g.lo : hi);
  }
  const long long vec = (long long)rows * vsize < 16 ? rows * vsize : 16;
  const bool fits = design != TS_DIA_VECTOR ||
                    (addr % vec == 0 && (ld * vsize) % vec == 0);
  const long long tile = (long long)TS_BLOCK * rows;
  if (!fits || rows < 1 || (n_rows + tile - 1) / tile < 2LL * sms) {
    rows = 1;
    design = TS_DIA_STRIDED;
  }
  g.rows = rows;
  g.design = design;
  const long long t = (long long)TS_BLOCK * rows;
  g.grid = (n_rows + t - 1) / t;
  return g;
}

static int ts_sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      return 132;
    cached[dev] = n;
  }
  return cached[dev];
}

template <typename V, typename X, int DESIGN, int R, int MINB, int ND>
static void launch_dia_plain_nd(const V* data, long long ld,
                                const TsOffsets& offs, int ndiag, const X* x,
                                X* y, long long n_rows, long long n_cols,
                                long long lo, long long hi, long long grid,
                                cudaStream_t stream) {
  if constexpr (DESIGN == TS_DIA_VECTOR && R > 1)
    dia_spmv_vector_kernel<V, X, R, ND, MINB>
        <<<(unsigned)grid, TS_BLOCK, 0, stream>>>(data, ld, offs, ndiag, x, y,
                                                  n_rows, n_cols, lo, hi);
  else
    dia_spmv_strided_kernel<V, X, R, ND, MINB>
        <<<(unsigned)grid, TS_BLOCK, 0, stream>>>(data, ld, offs, ndiag, x, y,
                                                  n_rows, n_cols, lo, hi);
}

// One launch of a design at R rows a thread, its instance chosen by the
// diagonal count.
template <typename V, typename X, int DESIGN, int R, int MINB>
static void launch_dia_plain(const V* data, long long ld,
                             const TsOffsets& offs, int ndiag, const X* x,
                             X* y, long long n_rows, long long n_cols,
                             long long lo, long long hi, long long grid,
                             cudaStream_t stream) {
  switch (ndiag) {
#define TS_DIA_CASE(N)                                                   \
  case N:                                                                \
    launch_dia_plain_nd<V, X, DESIGN, R, MINB, N>(                       \
        data, ld, offs, ndiag, x, y, n_rows, n_cols, lo, hi, grid, stream); \
    return;
    TS_DIA_FOR_EACH_ND(TS_DIA_CASE)
#undef TS_DIA_CASE
    default:
      launch_dia_plain_nd<V, X, DESIGN, R, MINB, 0>(
          data, ld, offs, ndiag, x, y, n_rows, n_cols, lo, hi, grid, stream);
  }
}

// The shipped design of each build (dia_spmv_probe, PERF.md): design, rows
// a thread, min CTAs a SM for ptxas. Mirrored by cuda_spmv.PLAIN_DESIGNS.
template <typename V, typename X>
struct TsDiaShipped;
template <>
struct TsDiaShipped<float, float> {
  static constexpr int design = TS_DIA_VECTOR, rows = 2, minb = 1;
};
template <>
struct TsDiaShipped<double, double> {
  static constexpr int design = TS_DIA_STRIDED, rows = 1, minb = 8;
};
template <>
struct TsDiaShipped<ts_c64, ts_c64> {
  static constexpr int design = TS_DIA_STRIDED, rows = 1, minb = 1;
};
template <>
struct TsDiaShipped<ts_c128, ts_c128> {
  static constexpr int design = TS_DIA_STRIDED, rows = 1, minb = 1;
};
template <>
struct TsDiaShipped<ts_bf16, ts_bf16> {
  static constexpr int design = TS_DIA_VECTOR, rows = 2, minb = 4;
};
template <>
struct TsDiaShipped<ts_bf16, float> {
  static constexpr int design = TS_DIA_VECTOR, rows = 2, minb = 4;
};

template <typename V, typename X>
static TsDiaGeometry ts_dia_shipped_geometry(const TsOffsets& offs, int ndiag,
                                             long long n_rows,
                                             long long n_cols, long long ld,
                                             const V* data, int sms) {
  using S = TsDiaShipped<V, X>;
  return ts_dia_geometry(offs, ndiag, n_rows, n_cols, ld,
                         (unsigned long long)(size_t)data, (int)sizeof(V),
                         S::design, S::rows, sms);
}

// The shipped plain mode: one launch, the design's R rows a thread or the
// scalar path.
template <typename V, typename X>
static void launch_dia_plain_shipped(const V* data, long long ld,
                                     const TsOffsets& offs, int ndiag,
                                     const X* x, X* y, long long n_rows,
                                     long long n_cols, cudaStream_t stream) {
  using S = TsDiaShipped<V, X>;
  const TsDiaGeometry g = ts_dia_shipped_geometry<V, X>(
      offs, ndiag, n_rows, n_cols, ld, data, ts_sm_count());
  if (g.rows == 1)
    launch_dia_plain<V, X, TS_DIA_STRIDED, 1, S::minb>(
        data, ld, offs, ndiag, x, y, n_rows, n_cols, g.lo, g.hi, g.grid,
        stream);
  else
    launch_dia_plain<V, X, S::design, S::rows, S::minb>(
        data, ld, offs, ndiag, x, y, n_rows, n_cols, g.lo, g.hi, g.grid,
        stream);
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
    launch_dia_plain_shipped<V, X>(data, ld, offs, ndiag, x, y, n_rows,
                                   n_cols, stream);
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

// The first plain-mode design (v1, dia_spmv_v1.cuh), for the card tests
// and the smoke run: nothing on a solver path calls these.
#define TS_DIA_V1_ENTRY(SFX, V, X)                                          \
  extern "C" int ts_dia_spmv_v1_##SFX(const V* data, long long ld,          \
                                      const int* offsets, int ndiag,        \
                                      const X* x, X* y, long long n_rows,   \
                                      long long n_cols,                     \
                                      cudaStream_t stream) {                \
    return launch_dia_spmv_v1<V, X>(data, ld, offsets, ndiag, x, y, n_rows, \
                                    n_cols, stream);                        \
  }
TS_DIA_V1_ENTRY(f32, float, float)
TS_DIA_V1_ENTRY(f64, double, double)
TS_DIA_V1_ENTRY(c64, ts_c64, ts_c64)
TS_DIA_V1_ENTRY(c128, ts_c128, ts_c128)
TS_DIA_V1_ENTRY(bf16, ts_bf16, ts_bf16)
TS_DIA_V1_ENTRY(bf16_f32, ts_bf16, float)
#undef TS_DIA_V1_ENTRY

// The plain mode's geometry for a call of build `build` (0 f32, 1 f64, 2
// c64, 3 c128, 4 bf16, 5 bf16_f32) on `sms` SMs (<= 0: the current
// device's): out = {lo, hi, grid, rows a thread, design}. For the tests,
// which hold cuda_spmv.plain_geometry to it.
extern "C" int ts_dia_spmv_geometry(const int* offsets, int ndiag,
                                    long long n_rows, long long n_cols,
                                    long long ld, unsigned long long addr,
                                    int build, int sms, long long* out) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs)) return TS_BAD_ARGUMENT;
  if (n_rows < 0 || n_cols < 0 || ld < n_rows) return TS_BAD_ARGUMENT;
  if (sms <= 0) sms = ts_sm_count();
  TsDiaGeometry g;
  switch (build) {
#define TS_DIA_GEOMETRY(ID, V, X)                                          \
  case ID:                                                                 \
    g = ts_dia_shipped_geometry<V, X>(offs, ndiag, n_rows, n_cols, ld,     \
                                      (const V*)(size_t)addr, sms);        \
    break;
    TS_DIA_GEOMETRY(0, float, float)
    TS_DIA_GEOMETRY(1, double, double)
    TS_DIA_GEOMETRY(2, ts_c64, ts_c64)
    TS_DIA_GEOMETRY(3, ts_c128, ts_c128)
    TS_DIA_GEOMETRY(4, ts_bf16, ts_bf16)
    TS_DIA_GEOMETRY(5, ts_bf16, float)
#undef TS_DIA_GEOMETRY
    default: return TS_BAD_ARGUMENT;
  }
  out[0] = g.lo;
  out[1] = g.hi;
  out[2] = g.grid;
  out[3] = g.rows;
  out[4] = g.design;
  return 0;
}

extern "C" const char* ts_error_string(int code) {
  if (code == TS_BAD_ARGUMENT) return "argument refused by the kernel's host entry";
  return cudaGetErrorString((cudaError_t)code);
}
