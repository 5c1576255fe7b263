// Shared launch geometry and reductions for the tpu_sparse_torch kernels.
//
// Every kernel runs TS_BLOCK threads per block. Those that leave per-block
// partials for a fixed-order sum run a grid-stride loop over at most
// TS_MAX_GRID blocks, or fold their tiles into TS_MAX_GRID slots (kernel
// 2), so a partial buffer never holds more than TS_MAX_GRID values and a
// fixed-order sum over it is cheap.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

#define TS_MAX_DIAG 64
#define TS_BLOCK 256
#define TS_MAX_GRID 1024

// Error code for arguments the kernels do not take (distinct from every
// cudaError_t value the runtime returns).
#define TS_BAD_ARGUMENT 10000

// Stencil offsets travel by value in the kernel parameters; no device copy.
struct TsOffsets {
  int o[TS_MAX_DIAG];
};

static inline int ts_grid_for(long long rows) {
  long long g = (rows + TS_BLOCK - 1) / TS_BLOCK;
  if (g < 1) g = 1;
  return (int)(g < TS_MAX_GRID ? g : TS_MAX_GRID);
}

static inline bool ts_fill_offsets(const int* offsets, int ndiag, TsOffsets* out) {
  if (ndiag < 0 || ndiag > TS_MAX_DIAG) return false;
  for (int d = 0; d < TS_MAX_DIAG; ++d) out->o[d] = d < ndiag ? offsets[d] : 0;
  return true;
}

// Copies the by-value offsets into shared memory once per block, so the
// diagonal loop indexes shared memory rather than the parameter bank.
__device__ __forceinline__ void ts_load_offsets(const TsOffsets& offs, int ndiag,
                                                int* s_off) {
  for (int d = threadIdx.x; d < ndiag; d += blockDim.x) s_off[d] = offs.o[d];
  __syncthreads();
}

// Block-wide sum in a fixed order (warp shuffle tree, then one warp over
// the warp sums). The result is valid in thread 0. Ends with a barrier so
// the shared scratch can be reused by the next call.
__device__ __forceinline__ double ts_block_sum(double v) {
  __shared__ double warp_sums[TS_BLOCK / 32];
  for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) warp_sums[wid] = v;
  __syncthreads();
  v = (threadIdx.x < TS_BLOCK / 32) ? warp_sums[threadIdx.x] : 0.0;
  if (wid == 0) {
    for (int s = 16; s > 0; s >>= 1) v += __shfl_down_sync(0xffffffffu, v, s);
  }
  __syncthreads();
  return v;
}

extern "C" const char* ts_error_string(int code);

// ---- the complex scalar ---------------------------------------------------

// A complex value of the layout of torch's complex64 (R = float) and
// complex128 (R = double): an aligned {re, im} pair. The kernels use only
// T(0), +, +=, * and != on it. The products are (ac - bd, ad + bc) with each
// operation rounded on its own (the _rn intrinsics keep nvcc from fusing
// them into FMAs), so every kernel that sums the same products in the same
// order gives the same bits (K6/K7's column j equals K4/K5), and there is
// no NaN/Inf recovery as in C's Annex G or cuda::std::complex: a NaN in x
// gives NaN, as in the real builds.
template <typename R>
struct alignas(2 * sizeof(R)) TsComplex {
  R re, im;
  TsComplex() = default;
  __host__ __device__ constexpr TsComplex(R r, R i = R(0)) : re(r), im(i) {}
};

using ts_c64 = TsComplex<float>;
using ts_c128 = TsComplex<double>;

template <typename T>
struct ts_is_complex {
  static constexpr bool value = false;
};
template <typename R>
struct ts_is_complex<TsComplex<R>> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float ts_add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double ts_add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float ts_sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double ts_sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float ts_mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double ts_mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

template <typename R>
__device__ __forceinline__ TsComplex<R> operator+(TsComplex<R> a,
                                                  TsComplex<R> b) {
  return TsComplex<R>(ts_add_rn(a.re, b.re), ts_add_rn(a.im, b.im));
}

template <typename R>
__device__ __forceinline__ TsComplex<R>& operator+=(TsComplex<R>& a,
                                                    TsComplex<R> b) {
  a = a + b;
  return a;
}

template <typename R>
__device__ __forceinline__ TsComplex<R> operator*(TsComplex<R> a,
                                                  TsComplex<R> b) {
  return TsComplex<R>(
      ts_sub_rn(ts_mul_rn(a.re, b.re), ts_mul_rn(a.im, b.im)),
      ts_add_rn(ts_mul_rn(a.re, b.im), ts_mul_rn(a.im, b.re)));
}

template <typename R>
__device__ __forceinline__ bool operator!=(TsComplex<R> a, TsComplex<R> b) {
  return a.re != b.re || a.im != b.im;
}

// Read-only (__ldg) and streaming (__ldcs) loads of one value; a complex
// value is one 8- or 16-byte vector load.
template <typename T>
__device__ __forceinline__ T ts_ldg(const T* p) {
  return __ldg(p);
}
__device__ __forceinline__ ts_c64 ts_ldg(const ts_c64* p) {
  const float2 q = __ldg(reinterpret_cast<const float2*>(p));
  return ts_c64(q.x, q.y);
}
__device__ __forceinline__ ts_c128 ts_ldg(const ts_c128* p) {
  const double2 q = __ldg(reinterpret_cast<const double2*>(p));
  return ts_c128(q.x, q.y);
}

template <typename T>
__device__ __forceinline__ T ts_ldcs(const T* p) {
  return __ldcs(p);
}
__device__ __forceinline__ ts_c64 ts_ldcs(const ts_c64* p) {
  const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
  return ts_c64(q.x, q.y);
}
__device__ __forceinline__ ts_c128 ts_ldcs(const ts_c128* p) {
  const double2 q = __ldcs(reinterpret_cast<const double2*>(p));
  return ts_c128(q.x, q.y);
}

// ---- bf16 -------------------------------------------------------------------

// torch's bfloat16 is __nv_bfloat16's layout: the high 16 bits of a float.
// A bf16 value is loaded as its 16 bits and widened in registers (exact:
// the bits shifted into a float's high half), and the kernels compute on
// the widened value; a bf16 output is rounded once, to nearest even. So a
// bf16 build on bf16-exact values gives the float build's sums.

using ts_bf16 = __nv_bfloat16;

template <typename T>
struct ts_is_bf16 {
  static constexpr bool value = false;
};
template <>
struct ts_is_bf16<ts_bf16> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float ts_bf16_bits_to_float(unsigned short u) {
  return __uint_as_float(static_cast<unsigned int>(u) << 16);
}

__device__ __forceinline__ ts_bf16 ts_ldg(const ts_bf16* p) {
  return __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p)));
}
__device__ __forceinline__ ts_bf16 ts_ldcs(const ts_bf16* p) {
  return __ushort_as_bfloat16(
      __ldcs(reinterpret_cast<const unsigned short*>(p)));
}

// The type a value computes in: float for bf16, the type itself otherwise.
template <typename T>
struct ts_wide {
  using type = T;
};
template <>
struct ts_wide<ts_bf16> {
  using type = float;
};
template <typename T>
using ts_wide_t = typename ts_wide<T>::type;

template <typename T>
__device__ __forceinline__ T ts_widen(T v) {
  return v;
}
__device__ __forceinline__ float ts_widen(ts_bf16 v) {
  return ts_bf16_bits_to_float(__bfloat16_as_ushort(v));
}

// The sum of a product of values V and operands X, in the type the two
// compute in: X's widened type (the builds pair bf16 with float or bf16,
// and every other type with itself).
template <typename V, typename X>
using ts_acc_t = ts_wide_t<X>;

// An accumulator written out as Y: rounded once to nearest even for bf16.
template <typename Y, typename A>
__device__ __forceinline__ Y ts_narrow(A v) {
  if constexpr (ts_is_bf16<Y>::value)
    return __float2bfloat16_rn(v);
  else
    return static_cast<Y>(v);
}

// 0 of a value type (bf16 has no constexpr constructor from an int).
template <typename T>
__device__ __forceinline__ T ts_zero() {
  if constexpr (ts_is_bf16<T>::value)
    return __ushort_as_bfloat16((unsigned short)0);
  else
    return T(0);
}

// ---- the DIA kernels' diagonal loop ----------------------------------------

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

// The current device's SM count, read once a device.
static inline int ts_sm_count() {
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
