// Shared launch geometry and reductions for the tpu_sparse_torch kernels.
//
// Every kernel runs TS_BLOCK threads per block over a grid-stride loop of at
// most TS_MAX_GRID blocks, so a per-block partial buffer never holds more
// than TS_MAX_GRID values and a fixed-order sum over it is cheap.
#pragma once

#include <cuda_runtime.h>

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
