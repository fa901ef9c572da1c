// K4 (and K6's entry): bilinear warp of a frame stack by per-frame factors.
//
// Replaces the TPU kernels slowflow_tpu/core/warp_shift.py `_shift_kernel`
// (dispatch `warp_stack_auto_batched`) and slowflow_tpu/core/warp_pallas.py
// `_kernel` (`warp_stack_pallas`). Plain PyTorch twins: core/warp_shift.py
// `warp_stack_ref` (= variational/terms.py `warp_window_frames`) and
// core/warp_pallas.py `warp_stack_pallas_ref`.
//
// What it computes: frame k of jet b is sampled at (j + f_k * wx,
// i + f_k * wy) with 4 corners, each clamped to the image on its own
// (`image_warp` semantics); the mask is 1 iff the continuous coordinate lies
// in [0, W-1] x [0, H-1]. The frame `identity` (or none, -1) is copied with
// an all-ones mask.
//
// What bounds it on an H100: HBM bytes. Per output pixel and channel it
// reads 4 gathered source values (mostly L1/L2 hits: neighbouring threads
// read neighbouring corners) and writes one; at B = 4, F = 5, 3 x 270 x 480
// that is ~31 MB written plus ~31 MB of unique source read, ~20 us at
// 3.35 TB/s.
//
// Design: one thread per (jet, frame, pixel), all channels in a loop, so the
// coordinates and weights are formed once per pixel. The TPU kernel's strip
// anchors, shift-grid ladder and banded fallback exist because TPU gathers
// are slow; here a gather is a load, and any flow is exact. Coordinates and
// the interpolation use __fmul_rn / __fadd_rn, the twin's rounding without
// FMA contraction, so the result equals the twin's bit for bit; floor(x) is
// clamped to [-1, W] before the int conversion so a large flow cannot
// overflow it.
#include "common.cuh"

namespace {

constexpr int MAXF = 16;
constexpr int THREADS = 256;

struct Factors {
  float f[MAXF];
};

__global__ void __launch_bounds__(THREADS) warp_stack_kernel(
    const float* __restrict__ src, const float* __restrict__ wx,
    const float* __restrict__ wy, float* __restrict__ out,
    float* __restrict__ masks, int F, int C, int H, int W, Factors fac,
    int identity) {
  const size_t HW = (size_t)H * W;
  const size_t pix = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const int k = blockIdx.y, b = blockIdx.z;
  if (pix >= HW) return;
  const size_t frame = (size_t)b * F + k;
  const float* s = src + frame * C * HW;
  float* o = out + frame * C * HW;
  if (k == identity) {
    for (int c = 0; c < C; ++c) o[c * HW + pix] = s[c * HW + pix];
    if (masks) masks[frame * HW + pix] = 1.f;
    return;
  }
  const int i = (int)(pix / W), j = (int)(pix % W);
  const float f = fac.f[k];
  const float x = __fadd_rn((float)j, __fmul_rn(f, wx[b * HW + pix]));
  const float y = __fadd_rn((float)i, __fmul_rn(f, wy[b * HW + pix]));
  const float xf = floorf(x), yf = floorf(y);
  const float dx = x - xf, dy = y - yf;
  const float ex = 1.f - dx, ey = 1.f - dy;
  const int xi = (int)fminf(fmaxf(xf, -1.f), (float)W);
  const int yi = (int)fminf(fmaxf(yf, -1.f), (float)H);
  const int xa = sf::clampi(xi, 0, W - 1), xb = sf::clampi(xi + 1, 0, W - 1);
  const int ya = sf::clampi(yi, 0, H - 1), yb = sf::clampi(yi + 1, 0, H - 1);
  const size_t q00 = (size_t)ya * W + xa, q01 = (size_t)ya * W + xb;
  const size_t q10 = (size_t)yb * W + xa, q11 = (size_t)yb * W + xb;
  for (int c = 0; c < C; ++c) {
    const float* p = s + c * HW;
    const float top = __fadd_rn(__fmul_rn(ex, p[q00]), __fmul_rn(dx, p[q01]));
    const float bot = __fadd_rn(__fmul_rn(ex, p[q10]), __fmul_rn(dx, p[q11]));
    o[c * HW + pix] = __fadd_rn(__fmul_rn(ey, top), __fmul_rn(dy, bot));
  }
  if (masks)
    masks[frame * HW + pix] =
        (x >= 0.f && x <= (float)(W - 1) && y >= 0.f && y <= (float)(H - 1))
            ? 1.f : 0.f;
}

}  // namespace

// src [B, F, C, H, W], wx / wy [B, H, W], factors: F host floats (F <= 16);
// out [B, F, C, H, W], masks [B, F, H, W] or null. identity: the frame
// copied unwarped, or -1. Returns a cudaError_t code (0 = launched).
extern "C" int sf_warp_stack(const float* src, const float* wx,
                             const float* wy, float* out, float* masks,
                             int B, int F, int C, int H, int W,
                             const float* factors, int identity,
                             void* stream) {
  if (B < 1 || F < 1 || F > MAXF || C < 1 || H < 1 || W < 1 ||
      identity >= F || B > 65535)
    return (int)cudaErrorInvalidValue;
  Factors fac = {};
  for (int k = 0; k < F; ++k) fac.f[k] = factors[k];
  const size_t HW = (size_t)H * W;
  const dim3 grid((unsigned)((HW + THREADS - 1) / THREADS), F, B);
  warp_stack_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      src, wx, wy, out, masks, F, C, H, W, fac, identity);
  return (int)cudaGetLastError();
}
