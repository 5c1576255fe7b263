// Kernels 2 and 3: one CG iteration on a halo-extended DIA operator as two
// launches, float only (the fused path is f32, as supports_fused_cg says).
//
// Replaces tpu_sparse/kernels/pallas_cg.py `_dia_cg_kernel` (driven by
// `_fused_cg_block` / `fused_cg_ext`). The TPU kernel ran K iterations in
// one launch with x, r, p resident in VMEM and an ordered grid that carried
// <p,Ap> from chunk to chunk. Hopper blocks run in no order and nothing
// stays on chip between launches, so each iteration here is:
//
//   dia_cg_spmv_dot  p = z + beta*p_prev (z = D^-1 r, or r), Ap = A p, and
//                    one partial <p,Ap> per block;
//   dia_cg_update    every block sums the <p,Ap> partials in the same fixed
//                    order, alpha = gamma/pAp if pAp > 0 else 0 (the freeze
//                    guard of pallas_cg.py:155-156), x += alpha p,
//                    r -= alpha Ap, and per-block partials of <r,r> (and
//                    <r,D^-1 r> under Jacobi). The block that finishes last
//                    (integer ticket, no float atomics) sums those partials
//                    in a fixed order, writes ||r||^2 to the history and
//                    sets gamma' and beta' = gamma'/gamma if gamma > 0
//                    else 0 (pallas_cg.py:174-175) for the next iteration.
//
// The beta / p update (pallas_cg.py:177-183) is folded into the next
// iteration's dia_cg_spmv_dot: each neighbour read forms z + beta*p_prev
// on the fly from r, p_prev (and D^-1), and the block writes its own rows
// of the new p to a second buffer (p is double-buffered, so no block reads
// a value another block of the same launch writes). gamma, beta and the
// history stay on the device; the host reads the history once per block
// of K iterations. All dot products accumulate in double and every sum
// over partials runs in a fixed order, so two runs give the same bits.
//
// Bound: device-memory bandwidth. Per row and iteration the two launches
// move 4*ndiag bytes of matrix data plus about 40 bytes of vectors (r, p
// read and p, Ap written; x, r, p, Ap read and x, r written), 48 with
// Jacobi; the 27-point stencil's 108 data bytes dominate.

#include "ts_common.cuh"

// The search direction at extended index t: z + beta * p_prev, formed the
// same way (one fused multiply-add) wherever it is needed.
template <bool HAS_M>
__device__ __forceinline__ float ts_pdir(const float* __restrict__ r,
                                         const float* __restrict__ dinv,
                                         const float* __restrict__ p_prev,
                                         float beta, long long t) {
  const float z = HAS_M ? dinv[t] * r[t] : r[t];
  return fmaf(beta, p_prev[t], z);
}

template <bool HAS_M>
__global__ void __launch_bounds__(TS_BLOCK)
dia_cg_spmv_dot_kernel(const float* __restrict__ data, long long ld,
                       TsOffsets offs, int ndiag, long long n, long long wl,
                       const float* __restrict__ r,
                       const float* __restrict__ dinv,
                       const float* __restrict__ p_prev,
                       float* __restrict__ p_new, float* __restrict__ ap,
                       const double* __restrict__ scal,
                       double* __restrict__ pap_part) {
  __shared__ int s_off[TS_MAX_DIAG];
  ts_load_offsets(offs, ndiag, s_off);
  const float beta = (float)scal[1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  double local = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long t = wl + i;
    float acc = 0.f;
    for (int d = 0; d < ndiag; ++d) {
      acc += data[d * ld + i] * ts_pdir<HAS_M>(r, dinv, p_prev, beta, t + s_off[d]);
    }
    const float pc = ts_pdir<HAS_M>(r, dinv, p_prev, beta, t);
    p_new[t] = pc;
    ap[t] = acc;
    local += (double)pc * (double)acc;
  }
  const double s = ts_block_sum(local);
  if (threadIdx.x == 0) pap_part[blockIdx.x] = s;
}

template <bool HAS_M, bool INIT>
__global__ void __launch_bounds__(TS_BLOCK)
dia_cg_update_kernel(long long n, long long wl, float* __restrict__ x,
                     float* __restrict__ r, const float* __restrict__ p,
                     const float* __restrict__ ap,
                     const float* __restrict__ dinv,
                     const double* __restrict__ pap_part, int n_pap,
                     double* scal, double* rr_part, double* gz_part,
                     unsigned int* counter, float* hist) {
  __shared__ float s_alpha;
  __shared__ bool s_last;
  float alpha = 0.f;
  if (!INIT) {
    double s = 0.0;
    for (int g = threadIdx.x; g < n_pap; g += blockDim.x) s += pap_part[g];
    const double pap = ts_block_sum(s);
    if (threadIdx.x == 0) {
      const double gamma = scal[0];
      s_alpha = pap > 0.0 ? (float)(gamma / pap) : 0.f;
    }
    __syncthreads();
    alpha = s_alpha;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  double rr = 0.0, gz = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long t = wl + i;
    float ri = r[t];
    if (!INIT) {
      x[t] = fmaf(alpha, p[t], x[t]);
      ri = fmaf(-alpha, ap[t], ri);
      r[t] = ri;
    }
    rr += (double)ri * (double)ri;
    if (HAS_M) gz += (double)ri * (double)(dinv[t] * ri);
  }
  rr = ts_block_sum(rr);
  if (HAS_M) gz = ts_block_sum(gz);
  if (threadIdx.x == 0) {
    rr_part[blockIdx.x] = rr;
    if (HAS_M) gz_part[blockIdx.x] = gz;
    __threadfence();
    const unsigned int ticket = atomicAdd(counter, 1u);
    s_last = (ticket == gridDim.x - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // Last block: every other block's partials are visible (fence + ticket).
  double a = 0.0, b = 0.0;
  for (int g = threadIdx.x; g < (int)gridDim.x; g += blockDim.x) {
    a += __ldcg(rr_part + g);
    if (HAS_M) b += __ldcg(gz_part + g);
  }
  a = ts_block_sum(a);
  if (HAS_M) b = ts_block_sum(b);
  if (threadIdx.x == 0) {
    const double g_new = HAS_M ? b : a;
    const double g_old = scal[0];
    scal[1] = g_old > 0.0 ? g_new / g_old : 0.0;
    scal[0] = g_new;
    if (hist != nullptr) *hist = (float)a;
    *counter = 0u;
  }
}

extern "C" int ts_dia_cg_spmv_dot(const float* data, long long ld,
                                  const int* offsets, int ndiag, long long n,
                                  long long wl, const float* r,
                                  const float* dinv, const float* p_prev,
                                  float* p_new, float* ap, const double* scal,
                                  double* pap_part, int grid,
                                  cudaStream_t stream) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs)) return TS_BAD_ARGUMENT;
  if (n <= 0 || ld < n || wl < 0 || grid != ts_grid_for(n)) return TS_BAD_ARGUMENT;
  for (int d = 0; d < ndiag; ++d) {
    if (offs.o[d] > wl || -offs.o[d] > wl) return TS_BAD_ARGUMENT;
  }
  if (dinv != nullptr) {
    dia_cg_spmv_dot_kernel<true><<<grid, TS_BLOCK, 0, stream>>>(
        data, ld, offs, ndiag, n, wl, r, dinv, p_prev, p_new, ap, scal, pap_part);
  } else {
    dia_cg_spmv_dot_kernel<false><<<grid, TS_BLOCK, 0, stream>>>(
        data, ld, offs, ndiag, n, wl, r, dinv, p_prev, p_new, ap, scal, pap_part);
  }
  return (int)cudaGetLastError();
}

extern "C" int ts_dia_cg_update(long long n, long long wl, float* x, float* r,
                                const float* p, const float* ap,
                                const float* dinv, const double* pap_part,
                                int n_pap, double* scal, double* rr_part,
                                double* gz_part, unsigned int* counter,
                                float* hist, int init, int grid,
                                cudaStream_t stream) {
  if (n <= 0 || wl < 0 || grid != ts_grid_for(n)) return TS_BAD_ARGUMENT;
  if (n_pap < 1 || n_pap > TS_MAX_GRID) return TS_BAD_ARGUMENT;
  if (dinv != nullptr && gz_part == nullptr) return TS_BAD_ARGUMENT;
  const bool m = dinv != nullptr;
  if (init) {
    if (m) {
      dia_cg_update_kernel<true, true><<<grid, TS_BLOCK, 0, stream>>>(
          n, wl, x, r, p, ap, dinv, pap_part, n_pap, scal, rr_part, gz_part, counter, hist);
    } else {
      dia_cg_update_kernel<false, true><<<grid, TS_BLOCK, 0, stream>>>(
          n, wl, x, r, p, ap, dinv, pap_part, n_pap, scal, rr_part, gz_part, counter, hist);
    }
  } else {
    if (m) {
      dia_cg_update_kernel<true, false><<<grid, TS_BLOCK, 0, stream>>>(
          n, wl, x, r, p, ap, dinv, pap_part, n_pap, scal, rr_part, gz_part, counter, hist);
    } else {
      dia_cg_update_kernel<false, false><<<grid, TS_BLOCK, 0, stream>>>(
          n, wl, x, r, p, ap, dinv, pap_part, n_pap, scal, rr_part, gz_part, counter, hist);
    }
  }
  return (int)cudaGetLastError();
}
