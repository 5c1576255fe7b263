// K10: one fused BiCGStab iteration on a halo-extended DIA operator as three
// launches, float only (the fused path is f32, as supports_fused_bicgstab
// says).
//
// Replaces tpu_sparse/kernels/pallas_bicgstab.py `_dia_bicgstab_kernel`
// (driven by `_fused_bicgstab_block` / `fused_bicgstab_ext`). The TPU kernel
// ran K iterations in one launch with x, r, p, r^, q, t resident in VMEM and
// an ordered grid that carried the dot products from chunk to chunk, with a
// serial epilogue sweep after each of the two matvec phases. Hopper blocks
// run in no order and nothing stays on chip between launches, and an
// iteration needs three global sums before its next vector can be formed
// (<r^,q>, then <t,s> and <t,t>, then <r^,r>), so one iteration here is:
//
//   dia_bicgstab_q       p = r + beta (p_prev - omega q_prev), formed on the
//                        fly at every neighbour read; writes its own rows of
//                        p and q = A p to second buffers (p and q are
//                        double-buffered: no block reads what another block
//                        of the same launch writes) and one partial <r^,q>
//                        per block;
//   dia_bicgstab_t       every block sums the <r^,q> partials in the same
//                        fixed order: alpha = rho/<r^,q> unless |<r^,q>| <=
//                        eps or frozen; s = r - alpha q formed on the fly at
//                        every neighbour read; writes its rows of s and
//                        t = A s, and partials of <t,s>, <t,t>, ||s||^2.
//                        The block that finishes last (integer ticket, no
//                        float atomics) sets omega and the -11 codes;
//   dia_bicgstab_update  x += alpha p + omega s, r = s - omega t, partials
//                        of <r,r> and <r^,r>; the last block sets rho', the
//                        -10 code, beta and the history entry (||r||^2, or
//                        the breakdown code once frozen).
//
// The guards and codes are the fused TPU kernel's (pallas_bicgstab.py
// :150-227): eps = FLT_MIN guards the divisions, eps_rel = FLT_EPSILON the
// breakdown tests, both compared in float; <r^,q> collapse gives -11 (in
// dia_bicgstab_t), omega ~ 0 with ||s||^2 > eps gives -11 (end of
// dia_bicgstab_t), |rho'| < eps_rel |rho| gives -10 (end of
// dia_bicgstab_update), so -11 is written first and wins, as on the TPU.
// Once frozen alpha, omega and beta are 0. rho, alpha, omega, beta and the
// code live in a small double array on the device (values rounded to
// float, the TPU kernel's scalar type); the TPU kernel re-derived rho from
// <r^,r> at each launch, which is the same value. Dot products accumulate
// in double and every sum over partials runs in a fixed order, so two runs
// give the same bits.
//
// Bound: device-memory bandwidth. Per row and iteration: dia_bicgstab_q
// reads 4*ndiag matrix bytes + r, p_prev, q_prev, r^ and writes p, q
// (24 B); dia_bicgstab_t reads 4*ndiag + r, q and writes s, t (16 B);
// dia_bicgstab_update reads x, p, s, t, r^ and writes x, r (28 B). At the
// 27-point stencil that is 284 B/row against the 244 B/row the algorithm
// needs at the least (two matrix streams plus x, r, p, r^ read and x, r, p
// written once); the neighbour reads of the folded updates hit L1/L2.
//
// Launch bounds: (TS_BLOCK, 1) lets ptxas give q and t 56 and 52 registers
// and keep more neighbour loads in flight. Measured on an H100 80GB HBM3 at
// 700 W, 160^3: q 0.25 / t 0.24 ms with it, 0.36 / 0.37 ms with plain
// (TS_BLOCK) (40 registers) and 0.28 / 0.24 ms capped at 32 registers
// (TS_BLOCK, 8). Occupancy is not what limits these kernels.

#include "ts_common.cuh"

// Slots of the device scalar array `scal` (double, values in float).
#define BICG_RHO 0
#define BICG_ALPHA 1
#define BICG_OMEGA 2
#define BICG_BETA 3
#define BICG_CODE 4
#define BICG_NSCAL 5

// Rows of the partials buffer `part` (double, BICG_NPART x n_part).
#define BICG_RHQ 0
#define BICG_TS 1
#define BICG_TT 2
#define BICG_SS 3
#define BICG_RR 4
#define BICG_RHON 5
#define BICG_NPART 6

#define BICG_EPS 1.1754944e-38f      // float tiny: division guards
#define BICG_EPS_REL 1.1920929e-07f  // float eps: breakdown tests

// The search direction at extended index t, formed the same way (two fused
// multiply-adds) wherever it is needed.
__device__ __forceinline__ float ts_bicg_pdir(const float* __restrict__ r,
                                              const float* __restrict__ p_prev,
                                              const float* __restrict__ q_prev,
                                              float beta, float omega,
                                              long long t) {
  return fmaf(beta, fmaf(-omega, q_prev[t], p_prev[t]), r[t]);
}

__global__ void __launch_bounds__(TS_BLOCK, 1)
dia_bicgstab_q_kernel(const float* __restrict__ data, long long ld,
                      TsOffsets offs, int ndiag, long long n, long long wl,
                      const float* __restrict__ r,
                      const float* __restrict__ p_prev,
                      const float* __restrict__ q_prev,
                      const float* __restrict__ rhat,
                      float* __restrict__ p_new, float* __restrict__ q_new,
                      const double* __restrict__ scal,
                      double* __restrict__ rhq_part) {
  __shared__ int s_off[TS_MAX_DIAG];
  ts_load_offsets(offs, ndiag, s_off);
  const float beta = (float)scal[BICG_BETA];
  const float omega = (float)scal[BICG_OMEGA];
  const long long stride = (long long)gridDim.x * blockDim.x;
  double local = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long t = wl + i;
    float acc = 0.f;
    for (int d = 0; d < ndiag; ++d) {
      acc += data[d * ld + i] * ts_bicg_pdir(r, p_prev, q_prev, beta, omega, t + s_off[d]);
    }
    p_new[t] = ts_bicg_pdir(r, p_prev, q_prev, beta, omega, t);
    q_new[t] = acc;
    local += (double)rhat[t] * (double)acc;
  }
  const double s = ts_block_sum(local);
  if (threadIdx.x == 0) rhq_part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(TS_BLOCK, 1)
dia_bicgstab_t_kernel(const float* __restrict__ data, long long ld,
                      TsOffsets offs, int ndiag, long long n, long long wl,
                      const float* __restrict__ r,
                      const float* __restrict__ q, float* __restrict__ s,
                      float* __restrict__ tv, double* scal, double* part,
                      int n_part, unsigned int* counter) {
  __shared__ int s_off[TS_MAX_DIAG];
  __shared__ float s_alpha;
  __shared__ bool s_ok;
  __shared__ bool s_last;
  ts_load_offsets(offs, ndiag, s_off);
  double acc_rhq = 0.0;
  for (int g = threadIdx.x; g < n_part; g += blockDim.x) {
    acc_rhq += part[BICG_RHQ * n_part + g];
  }
  const double rhq = ts_block_sum(acc_rhq);
  if (threadIdx.x == 0) {
    const bool ok = fabsf((float)rhq) > BICG_EPS && scal[BICG_CODE] == 0.0;
    s_ok = ok;
    s_alpha = ok ? (float)(scal[BICG_RHO] / rhq) : 0.f;
  }
  __syncthreads();
  const float alpha = s_alpha;
  const long long stride = (long long)gridDim.x * blockDim.x;
  double ts = 0.0, tt = 0.0, ss = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long t = wl + i;
    float acc = 0.f;
    for (int d = 0; d < ndiag; ++d) {
      const long long u = t + s_off[d];
      acc += data[d * ld + i] * fmaf(-alpha, q[u], r[u]);
    }
    const float sc = fmaf(-alpha, q[t], r[t]);
    s[t] = sc;
    tv[t] = acc;
    ts += (double)acc * (double)sc;
    tt += (double)acc * (double)acc;
    ss += (double)sc * (double)sc;
  }
  ts = ts_block_sum(ts);
  tt = ts_block_sum(tt);
  ss = ts_block_sum(ss);
  if (threadIdx.x == 0) {
    part[BICG_TS * n_part + blockIdx.x] = ts;
    part[BICG_TT * n_part + blockIdx.x] = tt;
    part[BICG_SS * n_part + blockIdx.x] = ss;
    __threadfence();
    const unsigned int ticket = atomicAdd(counter, 1u);
    s_last = (ticket == gridDim.x - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // Last block: every other block's partials are visible (fence + ticket),
  // and every block has read scal before taking its ticket.
  double a = 0.0, b = 0.0, c = 0.0;
  for (int g = threadIdx.x; g < (int)gridDim.x; g += blockDim.x) {
    a += __ldcg(part + BICG_TS * n_part + g);
    b += __ldcg(part + BICG_TT * n_part + g);
    c += __ldcg(part + BICG_SS * n_part + g);
  }
  a = ts_block_sum(a);
  b = ts_block_sum(b);
  c = ts_block_sum(c);
  if (threadIdx.x == 0) {
    double code = scal[BICG_CODE];
    if (!s_ok && code == 0.0) code = -11.0;  // <r^,q> collapse
    const bool ok_t = (float)b > BICG_EPS && code == 0.0;
    const float omega = ok_t ? (float)(a / b) : 0.f;
    if (code == 0.0 && fabsf(omega) < BICG_EPS_REL && (float)c > BICG_EPS) {
      code = -11.0;  // omega ~ 0 while ||s|| is not small
    }
    scal[BICG_ALPHA] = alpha;
    scal[BICG_OMEGA] = omega;
    scal[BICG_CODE] = code;
    *counter = 0u;
  }
}

template <bool INIT>
__global__ void __launch_bounds__(TS_BLOCK, 1)
dia_bicgstab_update_kernel(long long n, long long wl, float* __restrict__ x,
                           float* __restrict__ r, const float* __restrict__ p,
                           const float* __restrict__ s,
                           const float* __restrict__ tv,
                           const float* __restrict__ rhat, double* scal,
                           double* part, int n_part, unsigned int* counter,
                           float* hist) {
  __shared__ bool s_last;
  const float alpha = (float)scal[BICG_ALPHA];
  const float omega = (float)scal[BICG_OMEGA];
  const long long stride = (long long)gridDim.x * blockDim.x;
  double rr = 0.0, rh = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long t = wl + i;
    float ri;
    if (INIT) {
      ri = r[t];
    } else {
      const float sc = s[t];
      x[t] = fmaf(omega, sc, fmaf(alpha, p[t], x[t]));
      ri = fmaf(-omega, tv[t], sc);
      r[t] = ri;
    }
    rr += (double)ri * (double)ri;
    rh += (double)rhat[t] * (double)ri;
  }
  rr = ts_block_sum(rr);
  rh = ts_block_sum(rh);
  if (threadIdx.x == 0) {
    part[BICG_RR * n_part + blockIdx.x] = rr;
    part[BICG_RHON * n_part + blockIdx.x] = rh;
    __threadfence();
    const unsigned int ticket = atomicAdd(counter, 1u);
    s_last = (ticket == gridDim.x - 1);
  }
  __syncthreads();
  if (!s_last) return;
  double a = 0.0, b = 0.0;
  for (int g = threadIdx.x; g < (int)gridDim.x; g += blockDim.x) {
    a += __ldcg(part + BICG_RR * n_part + g);
    b += __ldcg(part + BICG_RHON * n_part + g);
  }
  a = ts_block_sum(a);
  b = ts_block_sum(b);
  if (threadIdx.x == 0) {
    if (INIT) {
      scal[BICG_RHO] = (float)b;
      scal[BICG_ALPHA] = 0.0;
      scal[BICG_OMEGA] = 0.0;
      scal[BICG_BETA] = 0.0;
      scal[BICG_CODE] = 0.0;
    } else {
      const float rho = (float)scal[BICG_RHO];
      const float rho_new = (float)b;
      double code = scal[BICG_CODE];
      if (code == 0.0 && fabsf(rho_new) < BICG_EPS_REL * fabsf(rho)) {
        code = -10.0;  // rho collapse
      }
      float beta = 0.f;
      if (code == 0.0 && fabsf(rho) > BICG_EPS && fabsf(omega) > BICG_EPS) {
        beta = (float)(((double)rho_new / rho) * ((double)alpha / omega));
      }
      scal[BICG_BETA] = beta;
      scal[BICG_RHO] = rho_new;
      scal[BICG_CODE] = code;
      if (hist != nullptr) *hist = code != 0.0 ? (float)code : (float)a;
    }
    *counter = 0u;
  }
}

static bool ts_bicg_offsets_ok(const TsOffsets& offs, int ndiag, long long wl) {
  for (int d = 0; d < ndiag; ++d) {
    if (offs.o[d] > wl || -offs.o[d] > wl) return false;
  }
  return true;
}

extern "C" int ts_dia_bicgstab_q(const float* data, long long ld,
                                 const int* offsets, int ndiag, long long n,
                                 long long wl, const float* r,
                                 const float* p_prev, const float* q_prev,
                                 const float* rhat, float* p_new, float* q_new,
                                 const double* scal, double* part, int grid,
                                 cudaStream_t stream) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs)) return TS_BAD_ARGUMENT;
  if (n <= 0 || ld < n || wl < 0 || grid != ts_grid_for(n)) return TS_BAD_ARGUMENT;
  if (!ts_bicg_offsets_ok(offs, ndiag, wl)) return TS_BAD_ARGUMENT;
  dia_bicgstab_q_kernel<<<grid, TS_BLOCK, 0, stream>>>(
      data, ld, offs, ndiag, n, wl, r, p_prev, q_prev, rhat, p_new, q_new,
      scal, part + BICG_RHQ * grid);
  return (int)cudaGetLastError();
}

extern "C" int ts_dia_bicgstab_t(const float* data, long long ld,
                                 const int* offsets, int ndiag, long long n,
                                 long long wl, const float* r, const float* q,
                                 float* s, float* tv, double* scal,
                                 double* part, unsigned int* counter, int grid,
                                 cudaStream_t stream) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs)) return TS_BAD_ARGUMENT;
  if (n <= 0 || ld < n || wl < 0 || grid != ts_grid_for(n)) return TS_BAD_ARGUMENT;
  if (!ts_bicg_offsets_ok(offs, ndiag, wl)) return TS_BAD_ARGUMENT;
  dia_bicgstab_t_kernel<<<grid, TS_BLOCK, 0, stream>>>(
      data, ld, offs, ndiag, n, wl, r, q, s, tv, scal, part, grid, counter);
  return (int)cudaGetLastError();
}

extern "C" int ts_dia_bicgstab_update(long long n, long long wl, float* x,
                                      float* r, const float* p, const float* s,
                                      const float* tv, const float* rhat,
                                      double* scal, double* part,
                                      unsigned int* counter, float* hist,
                                      int init, int grid, cudaStream_t stream) {
  if (n <= 0 || wl < 0 || grid != ts_grid_for(n)) return TS_BAD_ARGUMENT;
  if (init) {
    dia_bicgstab_update_kernel<true><<<grid, TS_BLOCK, 0, stream>>>(
        n, wl, x, r, p, s, tv, rhat, scal, part, grid, counter, hist);
  } else {
    dia_bicgstab_update_kernel<false><<<grid, TS_BLOCK, 0, stream>>>(
        n, wl, x, r, p, s, tv, rhat, scal, part, grid, counter, hist);
  }
  return (int)cudaGetLastError();
}
