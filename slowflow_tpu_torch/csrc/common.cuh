// Shared device helpers of the slow-flow kernels: the robust penalties of
// slowflow_tpu_torch/core/penalty.py, selected by their integer id, and
// cp.async.
#pragma once

#include <cuda_runtime.h>

namespace sf {

struct Pen {
  int fct;          // 0 quadratic, 1 modified L1, 2 Lorentzian,
                    // 3 truncated modified L1, 4 Geman-McClure
  float eps_sq;
  float trunc;
  float trunc_val;  // sqrt(trunc + eps_sq), rho beyond the truncation
};

__device__ __forceinline__ float pen_apply(const Pen& p, float s) {
  switch (p.fct) {
    case 0: return s;
    case 2: return log1pf(0.5f * s / p.eps_sq);
    case 3: return sqrtf(s) > p.trunc ? p.trunc_val : sqrtf(s + p.eps_sq);
    case 4: return s / ((s + 1.f) * (s + 1.f));
    default: return sqrtf(s + p.eps_sq);
  }
}

__device__ __forceinline__ float pen_deriv(const Pen& p, float s) {
  switch (p.fct) {
    case 0: return 1.f;
    case 2: return 1.f / (2.f * p.eps_sq + s);
    case 3: return sqrtf(s) > p.trunc ? 0.f : 1.f / (2.f * sqrtf(s + p.eps_sq));
    case 4: return (p.eps_sq + 2.f * s) / ((p.eps_sq + s) * (p.eps_sq + s));
    default: return 1.f / (2.f * sqrtf(s + p.eps_sq));
  }
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// 4-byte asynchronous copy global -> shared (sm_80+); cp_async_wait_all
// waits for every copy this thread committed.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src)
               : "memory");
}

// 16-byte asynchronous copy global -> shared, through L2 only (both
// addresses 16-byte aligned).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

}  // namespace sf
