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
//                    <p,Ap> in partials, one a block of dia_cg_update;
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
// Jacobi; the 27-point stencil's 108 data bytes dominate. Kernel 2 moves at
// the least 4*ndiag + 16 bytes a row (124 at 27 diagonals; + 4 for D^-1):
// the diagonals once, r and p_prev read once, p and Ap written once; its
// neighbour reads of r and p_prev (two loads a term, three with D^-1) hit
// L1/L2, whose latency is what held the first design to 0.61-0.67 of that
// bound: a diagonal loop of run-time length with offsets in shared memory,
// one row a thread in a grid-stride loop of at most 1,024 CTAs, so each
// thread had few loads in flight.
//
// Kernel 2's design (as kernel 1's plain mode): the diagonal loop is
// unrolled for the generators' counts (3, 5, 7, 9, 27; offsets from the
// parameter bank), so a thread issues its diagonal and neighbour loads
// ahead of its multiply-adds; one CTA a tile, no grid-stride loop; R = 2
// rows a thread, each diagonal's pair one 8-byte load; and launch bounds
// (TS_BLOCK, 5), 48 registers, so 5 CTAs a SM keep loads in flight. What the
// occupancy buys (H100 80GB HBM3, 700 W, 27-point 256^3, a call by CUDA
// events): 0.704 ms, 0.88 of the bound, where the same code at (TS_BLOCK,
// 1) took 0.981 ms (182 registers, one CTA a SM) and the first design
// 0.98-1.01 ms. Other counts run the generic loop; data the vector loads do
// not fit, and grids short of two CTAs a SM, take one row a thread. More
// tiles than kernel 3's 1,024 <p,Ap> slots fold into them in a fixed order
// (see the kernel), so no float atomics enter.

#include "ts_common.cuh"

// The search direction at extended index t: z + beta * p_prev, formed the
// same way (one fused multiply-add) wherever it is needed.
template <bool HAS_M>
__device__ __forceinline__ float ts_pdir(const float* __restrict__ r,
                                         const float* __restrict__ dinv,
                                         const float* __restrict__ p_prev,
                                         float beta, long long t) {
  const float z = HAS_M ? __ldg(dinv + t) * __ldg(r + t) : __ldg(r + t);
  return fmaf(beta, __ldg(p_prev + t), z);
}

// Kernel 2's geometry: R rows a thread (TS_CG_ROWS, each diagonal's R
// values one vector load; 1 on the scalar path) and the CTAs a SM ptxas
// sizes the registers for (TS_CG_MIN_CTAS: 48 registers).
#define TS_CG_ROWS 2
#define TS_CG_MIN_CTAS 5

// One row of a tile that n cuts: the same terms in the same order.
template <bool HAS_M, int ND>
__device__ __forceinline__ float ts_cg_row(
    const float* __restrict__ data, long long ld, const TsOffsets& offs,
    const int* s_off, int ndiag, const float* __restrict__ r,
    const float* __restrict__ dinv, const float* __restrict__ p_prev,
    float beta, long long i, long long t) {
  float acc = 0.f;
  ts_for_diag<ND>(ndiag, [&](int d) {
    acc += __ldcs(data + d * ld + i) *
           ts_pdir<HAS_M>(r, dinv, p_prev, beta, t + ts_dia_off<ND>(offs, s_off, d));
  });
  return acc;
}

// p_new = z + beta p_prev and ap = A p_new on the CTA's tile of TS_BLOCK *
// R rows, thread t owning the R rows from base + t R, and the tile's
// <p,Ap>. Every row sums its diagonals in offsets order from 0 with the
// expression of the first design (acc += data * pdir, one multiply-add a
// term), so p_new and ap do not depend on R. The extended layout's margins
// (>= the bandwidth) are zero, so no column is tested; only a tile that n
// cuts tests its rows.
//
// The <p,Ap> partials: kernel 3 sums n_pap = ts_grid_for(n) slots in a
// fixed order. Slot s takes the tiles [s * per_slot, (s + 1) * per_slot):
// with one tile a slot the CTA writes its slot; else it writes its tile's
// partial to tile_part, and the CTA that finishes its slot's set last
// (integer ticket in slot_count, no float atomics) sums the set in tile
// order and rearms the ticket. Slots no tile reaches are written zero. So
// two launches give the same bits.
template <bool HAS_M, int R, int ND>
__global__ void __launch_bounds__(TS_BLOCK, TS_CG_MIN_CTAS)
dia_cg_spmv_dot_kernel(const float* __restrict__ data, long long ld,
                       TsOffsets offs, int ndiag, long long n, long long wl,
                       const float* __restrict__ r,
                       const float* __restrict__ dinv,
                       const float* __restrict__ p_prev,
                       float* __restrict__ p_new, float* __restrict__ ap,
                       const double* __restrict__ scal,
                       double* __restrict__ pap_part, int n_pap, int per_slot,
                       double* __restrict__ tile_part,
                       unsigned int* __restrict__ slot_count) {
  __shared__ int s_off[ND > 0 ? 1 : TS_MAX_DIAG];
  __shared__ bool s_last;
  if constexpr (ND == 0) ts_load_offsets(offs, ndiag, s_off);
  const float beta = (float)scal[1];
  const long long base = (long long)blockIdx.x * (TS_BLOCK * R);
  const long long i0 = base + (long long)threadIdx.x * R;
  double local = 0.0;
  if (base + TS_BLOCK * R <= n) {
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.f;
    ts_for_diag<ND>(ndiag, [&](int d) {
      const long long o = ts_dia_off<ND>(offs, s_off, d);
      float v[R];
      ts_ldcs_rows<float, R>(data + d * ld + i0, v);
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[k] += v[k] * ts_pdir<HAS_M>(r, dinv, p_prev, beta, wl + i0 + k + o);
    });
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long t = wl + i0 + k;
      const float pc = ts_pdir<HAS_M>(r, dinv, p_prev, beta, t);
      p_new[t] = pc;
      ap[t] = acc[k];
      local += (double)pc * (double)acc[k];
    }
  } else {
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const long long i = i0 + k;
      if (i < n) {
        const long long t = wl + i;
        const float acc = ts_cg_row<HAS_M, ND>(data, ld, offs, s_off, ndiag,
                                               r, dinv, p_prev, beta, i, t);
        const float pc = ts_pdir<HAS_M>(r, dinv, p_prev, beta, t);
        p_new[t] = pc;
        ap[t] = acc;
        local += (double)pc * (double)acc;
      }
    }
  }
  const double s = ts_block_sum(local);
  if (per_slot == 1) {
    if (threadIdx.x == 0) pap_part[blockIdx.x] = s;
  } else {
    const unsigned int slot = blockIdx.x / per_slot;
    const unsigned int first = slot * per_slot;
    const unsigned int count = min((unsigned int)per_slot, gridDim.x - first);
    if (threadIdx.x == 0) {
      tile_part[blockIdx.x] = s;
      __threadfence();
      s_last = atomicAdd(slot_count + slot, 1u) == count - 1;
    }
    __syncthreads();
    if (s_last) {
      // every tile of the set has written its partial (fence + ticket)
      double a = 0.0;
      for (unsigned int g = threadIdx.x; g < count; g += TS_BLOCK)
        a += __ldcg(tile_part + first + g);
      a = ts_block_sum(a);
      if (threadIdx.x == 0) {
        pap_part[slot] = a;
        slot_count[slot] = 0u;
      }
    }
  }
  if (blockIdx.x == 0) {
    const int used = (int)((gridDim.x + per_slot - 1) / per_slot);
    for (int g = used + threadIdx.x; g < n_pap; g += TS_BLOCK) pap_part[g] = 0.0;
  }
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

// What the host entry decides per call, from n, ld, the diagonal count,
// the data's address and the SM count alone.
struct TsCgGeometry {
  long long grid;      // CTAs, one a tile of TS_BLOCK * rows rows
  long long per_slot;  // tiles a <p,Ap> slot sums
  int rows;            // rows a thread (1: the scalar path)
  int unrolled;        // 1: the diagonal loop unrolled for ndiag
  int n_pap;           // <p,Ap> slots, ts_grid_for(n)
};

static bool ts_cg_unrolled(int ndiag) {
  switch (ndiag) {
#define TS_CG_CASE(N) case N:
    TS_DIA_FOR_EACH_ND(TS_CG_CASE)
#undef TS_CG_CASE
    return true;
    default:
      return false;
  }
}

// Rows a thread: TS_CG_ROWS when its vector loads fit (the data pointer and
// the row length ld aligned to TS_CG_ROWS * 4 bytes) and the grid still
// has two CTAs a SM; else one row a thread (mirrored by
// cuda_cg.spmv_dot_geometry).
static TsCgGeometry ts_cg_geometry(int ndiag, long long n, long long ld,
                                   unsigned long long addr, int sms) {
  const long long vec = 4LL * TS_CG_ROWS;
  const long long tile = (long long)TS_BLOCK * TS_CG_ROWS;
  const bool fits = addr % vec == 0 && (ld * 4) % vec == 0;
  TsCgGeometry g;
  g.rows = fits && (n + tile - 1) / tile >= 2LL * sms ? TS_CG_ROWS : 1;
  g.grid = (n + (long long)TS_BLOCK * g.rows - 1) / ((long long)TS_BLOCK * g.rows);
  g.n_pap = ts_grid_for(n);
  g.per_slot = (g.grid + g.n_pap - 1) / g.n_pap;
  g.unrolled = ts_cg_unrolled(ndiag) ? 1 : 0;
  return g;
}

template <bool HAS_M, int R, int ND>
static void launch_cg_spmv_dot_nd(const float* data, long long ld,
                                  const TsOffsets& offs, int ndiag,
                                  long long n, long long wl, const float* r,
                                  const float* dinv, const float* p_prev,
                                  float* p_new, float* ap, const double* scal,
                                  double* pap_part, const TsCgGeometry& g,
                                  double* tile_part, unsigned int* slot_count,
                                  cudaStream_t stream) {
  dia_cg_spmv_dot_kernel<HAS_M, R, ND>
      <<<(unsigned)g.grid, TS_BLOCK, 0, stream>>>(
          data, ld, offs, ndiag, n, wl, r, dinv, p_prev, p_new, ap, scal,
          pap_part, g.n_pap, (int)g.per_slot, tile_part, slot_count);
}

// One launch at R rows a thread, its instance chosen by the diagonal count.
template <bool HAS_M, int R>
static void launch_cg_spmv_dot(const float* data, long long ld,
                               const TsOffsets& offs, int ndiag, long long n,
                               long long wl, const float* r, const float* dinv,
                               const float* p_prev, float* p_new, float* ap,
                               const double* scal, double* pap_part,
                               const TsCgGeometry& g, double* tile_part,
                               unsigned int* slot_count, cudaStream_t stream) {
  switch (ndiag) {
#define TS_CG_CASE(N)                                                       \
  case N:                                                                   \
    launch_cg_spmv_dot_nd<HAS_M, R, N>(data, ld, offs, ndiag, n, wl, r,     \
                                       dinv, p_prev, p_new, ap, scal,       \
                                       pap_part, g, tile_part, slot_count,  \
                                       stream);                             \
    return;
    TS_DIA_FOR_EACH_ND(TS_CG_CASE)
#undef TS_CG_CASE
    default:
      launch_cg_spmv_dot_nd<HAS_M, R, 0>(data, ld, offs, ndiag, n, wl, r,
                                         dinv, p_prev, p_new, ap, scal,
                                         pap_part, g, tile_part, slot_count,
                                         stream);
  }
}

template <bool HAS_M>
static void launch_cg_spmv_dot_rows(
    const float* data, long long ld, const TsOffsets& offs, int ndiag,
    long long n, long long wl, const float* r, const float* dinv,
    const float* p_prev, float* p_new, float* ap, const double* scal,
    double* pap_part, const TsCgGeometry& g, double* tile_part,
    unsigned int* slot_count, cudaStream_t stream) {
  if (g.rows == 1)
    launch_cg_spmv_dot<HAS_M, 1>(data, ld, offs, ndiag, n, wl, r, dinv,
                                 p_prev, p_new, ap, scal, pap_part, g,
                                 tile_part, slot_count, stream);
  else
    launch_cg_spmv_dot<HAS_M, TS_CG_ROWS>(data, ld, offs, ndiag, n, wl, r,
                                          dinv, p_prev, p_new, ap, scal,
                                          pap_part, g, tile_part, slot_count,
                                          stream);
}

// Kernel 2. pap_part has n_pap = ts_grid_for(n) slots; when a slot sums
// more than one tile (per_slot > 1, ts_dia_cg_spmv_dot_geometry), tile_part
// holds at least grid doubles and slot_count n_pap zeroed integers, which
// the launch leaves zeroed.
extern "C" int ts_dia_cg_spmv_dot(const float* data, long long ld,
                                  const int* offsets, int ndiag, long long n,
                                  long long wl, const float* r,
                                  const float* dinv, const float* p_prev,
                                  float* p_new, float* ap, const double* scal,
                                  double* pap_part, int n_pap,
                                  double* tile_part, long long n_tile,
                                  unsigned int* slot_count,
                                  cudaStream_t stream) {
  TsOffsets offs;
  if (!ts_fill_offsets(offsets, ndiag, &offs)) return TS_BAD_ARGUMENT;
  if (n <= 0 || ld < n || wl < 0 || n_pap != ts_grid_for(n)) return TS_BAD_ARGUMENT;
  for (int d = 0; d < ndiag; ++d) {
    if (offs.o[d] > wl || -offs.o[d] > wl) return TS_BAD_ARGUMENT;
  }
  const TsCgGeometry g = ts_cg_geometry(
      ndiag, n, ld, (unsigned long long)(size_t)data, ts_sm_count());
  if (g.per_slot > 1 &&
      (tile_part == nullptr || n_tile < g.grid || slot_count == nullptr))
    return TS_BAD_ARGUMENT;
  if (dinv != nullptr)
    launch_cg_spmv_dot_rows<true>(data, ld, offs, ndiag, n, wl, r, dinv,
                                  p_prev, p_new, ap, scal, pap_part, g,
                                  tile_part, slot_count, stream);
  else
    launch_cg_spmv_dot_rows<false>(data, ld, offs, ndiag, n, wl, r, dinv,
                                   p_prev, p_new, ap, scal, pap_part, g,
                                   tile_part, slot_count, stream);
  return (int)cudaGetLastError();
}

// Kernel 2's geometry for a call on `sms` SMs (<= 0: the current device's):
// out = {grid, rows a thread, unrolled, n_pap, per_slot}. For the tests,
// which hold cuda_cg.spmv_dot_geometry to it.
extern "C" int ts_dia_cg_spmv_dot_geometry(int ndiag, long long n,
                                           long long ld,
                                           unsigned long long addr, int sms,
                                           long long* out) {
  if (ndiag < 0 || ndiag > TS_MAX_DIAG || n <= 0 || ld < n) return TS_BAD_ARGUMENT;
  if (sms <= 0) sms = ts_sm_count();
  const TsCgGeometry g = ts_cg_geometry(ndiag, n, ld, addr, sms);
  out[0] = g.grid;
  out[1] = g.rows;
  out[2] = g.unrolled;
  out[3] = g.n_pap;
  out[4] = g.per_slot;
  return 0;
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
