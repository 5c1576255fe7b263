// Asynchronous copies into shared memory, vector loads, and the slot
// decoding of the row-compact CWELL plan, shared by K4 / K5
// (cwell_spmv.cu) and K6 / K7 (cwell_spmm.cu); K8 (bell_spmm.cu) uses the
// cp.async helpers and the vector loads.
#pragma once

#include <cstdint>

#include "ts_common.cuh"

#define TS_CWELL_LANES 128
#define TS_CWELL_NARROW_PLANES 256

// ---- the compact plan's slots ---------------------------------------------

// A slot's column: a narrow index decodes through its block's window rows
// in shared memory, a wide one is the column.
__device__ __forceinline__ long long ts_slot_col(unsigned short ix,
                                                 const int* s_srow) {
  return (long long)s_srow[ix >> 8] * TS_CWELL_LANES + (ix & 0xFF);
}

__device__ __forceinline__ long long ts_slot_col(int ix, const int*) {
  return ix;
}

// Block b's window rows into shared memory (narrow indices only), by all
// threads of the CTA.
template <typename I>
__device__ __forceinline__ void ts_load_window_rows(const int* srow,
                                                    long long b, int planes,
                                                    int* s_srow) {
  if constexpr (sizeof(I) == 2) {
    for (int s = threadIdx.x; s < planes; s += blockDim.x)
      s_srow[s] = __ldg(srow + b * planes + s);
  }
}

// V consecutive values (V = 4 floats, 2 doubles, 2 floats or 2 complex64
// values: one vector load, the address aligned to it; V = 1: one value)
// by plain loads, from shared memory or from device memory the kernel
// writes.
template <typename T, int V>
__device__ __forceinline__ void ts_vec_load(const T* p, T (&o)[V]) {
  if constexpr (ts_is_complex<T>::value && V == 2) {
    static_assert(sizeof(T) == 8, "two complex128 values are 32 bytes");
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = T(q.x, q.y); o[1] = T(q.z, q.w);
  } else if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    o[0] = q.x; o[1] = q.y; o[2] = q.z; o[3] = q.w;
  } else if constexpr (V == 2 && sizeof(T) == 8) {
    const double2 q = *reinterpret_cast<const double2*>(p);
    o[0] = q.x; o[1] = q.y;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    o[0] = q.x; o[1] = q.y;
  } else {
    o[0] = *p;
  }
}

// ---- mbarriers and bulk copies ---------------------------------------------

__device__ __forceinline__ uint32_t ts_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ts_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(ts_smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void ts_mbar_expect_tx(uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(ts_smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void ts_mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = ts_smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// An L2 policy that evicts the streamed bytes first.
__device__ __forceinline__ uint64_t ts_evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// Order this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy writes (a bulk copy into a reused buffer).
__device__ __forceinline__ void ts_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void ts_fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void ts_bulk_load(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar,
                                             uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
      ::"r"(ts_smem_addr(dst)), "l"(src), "r"(bytes),
        "r"(ts_smem_addr(bar)), "l"(policy)
      : "memory");
}

// ---- per-thread asynchronous copies (cp.async) -----------------------------

// N bytes (4, 8 or 16; both addresses aligned to N) from device memory
// into shared memory; 16-byte copies bypass L1.
template <int N>
__device__ __forceinline__ void ts_cp_async(void* dst, const void* src) {
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 ::"r"(ts_smem_addr(dst)), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
                 ::"r"(ts_smem_addr(dst)), "l"(src), "n"(N) : "memory");
}

__device__ __forceinline__ void ts_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void ts_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
