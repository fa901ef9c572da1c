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
// What bounds it on an H100: HBM bytes. Each output value is one store and
// 4 gathered loads that hit L1 / L2 (neighbouring lanes read neighbouring
// corners); at B = 4, F = 5, 3 x 270 x 480 the call writes ~31 MB of planes
// and 10 MB of masks and reads ~31 MB of source and 1 MB of flow: ~23 us at
// 3.35 TB/s.
//
// Design: a block is TY rows x TX * PIX columns of one jet (a 2D grid per
// jet, blockIdx.z = jet: no division per pixel); a thread owns PIX pixels
// of its row, TX columns apart, so every warp-wide load or store of one
// pixel slot covers 32 consecutive floats. The thread reads its pixels'
// flow once and loops over all F frames (three channels unrolled), so the
// flow is read once per pixel and each frame's 12 corner loads per pixel
// are in flight together. One pixel a thread measured faster than two or
// four, and a persistent grid no faster than a block per tile (PERF.md).
// The identity frame is copied in the same pass with float4 loads and
// stores where rows are 16-byte aligned (W % 4 == 0). Corner gathers
// take the read-only path (__ldg); stores stay cacheable, since K3 reads the
// warped stack next on the stack route and it fits the 50 MB L2.
// Strip windows (slowflow_tpu_torch/parallel/strips.py): with a table
// rows[B][3] row i of jet b's window is image row rows[b][0] + i of an image
// of img_h rows; corners are clamped and masks taken against the image's
// rows, then a corner outside the window reads its nearest row.
// Coordinates and the interpolation use __fmul_rn / __fadd_rn, the twin's
// rounding without FMA contraction, so the result equals the twin's bit for
// bit; floor(x) is clamped to [-1, W] before the int conversion so a large
// flow cannot overflow it.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int MAXF = 16;
constexpr int TX = 32, TY = 8, NT = TX * TY;
constexpr int PIX = 1;                 // pixels per thread, TX apart
constexpr int TILE_W = TX * PIX;

struct Factors {
  float f[MAXF];
};

// Copies the tile's row i of C planes (stride HW); float4 when rows are
// 16-byte aligned.
__device__ __forceinline__ void copy_row(const float* __restrict__ s,
                                         float* __restrict__ o, int C,
                                         size_t HW, size_t row, int x0,
                                         int W, bool vec) {
  if (vec) {
    for (int jj = 4 * (int)threadIdx.x; jj < TILE_W; jj += 4 * TX) {
      const int j = x0 + jj;
      if (j >= W) break;
      for (int c = 0; c < C; ++c)
        *reinterpret_cast<float4*>(o + c * HW + row + j) =
            __ldg(reinterpret_cast<const float4*>(s + c * HW + row + j));
    }
    return;
  }
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      const int j = x0 + (int)threadIdx.x + TX * q;
      if (j < W) o[c * HW + row + j] = __ldg(s + c * HW + row + j);
    }
}

__device__ __forceinline__ void fill_ones(float* __restrict__ m, int x0,
                                          int W, bool vec) {
  if (vec) {
    for (int jj = 4 * (int)threadIdx.x; jj < TILE_W; jj += 4 * TX)
      if (x0 + jj < W)
        *reinterpret_cast<float4*>(m + x0 + jj) = make_float4(1.f, 1.f, 1.f, 1.f);
    return;
  }
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int j = x0 + (int)threadIdx.x + TX * q;
    if (j < W) m[j] = 1.f;
  }
}

// CF: the channel count when fixed at compile time (3), else 0 (runtime C).
// STRIP: the strip table is given (rows, img_h); else whole images, with
// none of its index work.
template <int CF, bool STRIP>
__global__ void __launch_bounds__(NT) warp_stack_kernel(
    const float* __restrict__ src, const float* __restrict__ wx,
    const float* __restrict__ wy, float* __restrict__ out,
    float* __restrict__ masks, int F, int C_, int H, int W, Factors fac,
    int identity, bool vec, const int* __restrict__ rows, int img_h) {
  const int C = CF ? CF : C_;
  const size_t HW = (size_t)H * W;
  const int b = blockIdx.z, x0 = blockIdx.x * TILE_W;
  const int i = blockIdx.y * TY + (int)threadIdx.y;
  if (i >= H) return;
  const size_t row = (size_t)i * W;
  const int row0 = STRIP ? __ldg(rows + 3 * b) : 0;
  const int ih = STRIP ? img_h : H;  // the image's rows
  float fx[PIX], fy[PIX];
#pragma unroll
  for (int q = 0; q < PIX; ++q) {
    const int j = x0 + (int)threadIdx.x + TX * q;
    fx[q] = j < W ? __ldg(wx + b * HW + row + j) : 0.f;
    fy[q] = j < W ? __ldg(wy + b * HW + row + j) : 0.f;
  }
  for (int k = 0; k < F; ++k) {
    const size_t frame = (size_t)b * F + k;
    const float* s = src + frame * C * HW;
    float* o = out + frame * C * HW + row;
    float* m = masks ? masks + frame * HW + row : nullptr;
    if (k == identity) {
      copy_row(s, o - row, C, HW, row, x0, W, vec);
      if (m) fill_ones(m, x0, W, vec);
      continue;
    }
    const float f = fac.f[k];
#pragma unroll
    for (int q = 0; q < PIX; ++q) {
      const int j = x0 + (int)threadIdx.x + TX * q;
      if (j >= W) continue;
      const float x = __fadd_rn((float)j, __fmul_rn(f, fx[q]));
      const float y = __fadd_rn((float)(i + row0), __fmul_rn(f, fy[q]));
      const float xf = floorf(x), yf = floorf(y);
      const float dx = x - xf, dy = y - yf;
      const float ex = 1.f - dx, ey = 1.f - dy;
      const int xi = (int)fminf(fmaxf(xf, -1.f), (float)W);
      const int yi = (int)fminf(fmaxf(yf, -1.f), (float)ih);
      const int xa = sf::clampi(xi, 0, W - 1), xb = sf::clampi(xi + 1, 0, W - 1);
      int ya = sf::clampi(yi, 0, ih - 1), yb = sf::clampi(yi + 1, 0, ih - 1);
      if (STRIP) {
        ya = sf::clampi(ya - row0, 0, H - 1);
        yb = sf::clampi(yb - row0, 0, H - 1);
      }
      ya *= W;
      yb *= W;
      if (m)
        m[j] = (x >= 0.f && x <= (float)(W - 1) && y >= 0.f &&
                y <= (float)(ih - 1)) ? 1.f : 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* p = s + c * HW;
        const float top = __fadd_rn(__fmul_rn(ex, __ldg(p + ya + xa)),
                                    __fmul_rn(dx, __ldg(p + ya + xb)));
        const float bot = __fadd_rn(__fmul_rn(ex, __ldg(p + yb + xa)),
                                    __fmul_rn(dx, __ldg(p + yb + xb)));
        o[c * HW + j] = __fadd_rn(__fmul_rn(ey, top), __fmul_rn(dy, bot));
      }
    }
  }
}

template <int CF>
cudaError_t launch(const float* src, const float* wx, const float* wy,
                   float* out, float* masks, int B, int F, int C, int H,
                   int W, const Factors& fac, int identity, bool vec,
                   const int* rows, int img_h, cudaStream_t st) {
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TY - 1) / TY, B),
      block(TX, TY);
  if (rows)
    warp_stack_kernel<CF, true><<<grid, block, 0, st>>>(
        src, wx, wy, out, masks, F, C, H, W, fac, identity, vec, rows, img_h);
  else
    warp_stack_kernel<CF, false><<<grid, block, 0, st>>>(
        src, wx, wy, out, masks, F, C, H, W, fac, identity, vec, rows, img_h);
  return cudaGetLastError();
}

}  // namespace

// src [B, F, C, H, W], wx / wy [B, H, W], factors: F host floats (F <= 16);
// out [B, F, C, H, W], masks [B, F, H, W] or null. identity: the frame
// copied unwarped, or -1. rows: the strip table above, or null (img_h = H).
// Returns a cudaError_t code (0 = launched).
extern "C" int sf_warp_stack(const float* src, const float* wx,
                             const float* wy, float* out, float* masks,
                             int B, int F, int C, int H, int W,
                             const float* factors, int identity,
                             const int* rows, int img_h, void* stream) {
  if (B < 1 || F < 1 || F > MAXF || C < 1 || H < 1 || W < 1 ||
      identity >= F || B > 65535 || (size_t)H * W > 0x7fffffffu ||
      img_h < H || (!rows && img_h != H))
    return (int)cudaErrorInvalidValue;
  Factors fac = {};
  for (int k = 0; k < F; ++k) fac.f[k] = factors[k];
  const bool vec = W % 4 == 0 && (reinterpret_cast<uintptr_t>(src) |
                                  reinterpret_cast<uintptr_t>(out) |
                                  reinterpret_cast<uintptr_t>(masks)) % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(C == 3 ? launch<3>(src, wx, wy, out, masks, B, F, C, H, W, fac,
                                  identity, vec, rows, img_h, st)
                      : launch<0>(src, wx, wy, out, masks, B, F, C, H, W, fac,
                                  identity, vec, rows, img_h, st));
}

// out[0..2] = resident blocks per SM, registers per thread, spill bytes per
// thread of the warp kernel (three channels).
extern "C" int sf_warp_stack_occupancy(int* out) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, warp_stack_kernel<3, false>);
  if (err != cudaSuccess) return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], warp_stack_kernel<3, false>, NT, 0);
}
