// The grid matcher: for each point of a batch of image pairs, the integer
// displacement in [-r, r]^2 with the least patch SAD cost.
//
// Replaces the JAX package's compiled matcher, which has no Pallas kernel:
// slowflow_tpu/epic/matching.py `_match_costs` (one cost map per
// displacement in a fori_loop) inside `_grid_match_core`, jitted with vmap
// over the batch. Plain PyTorch twin: slowflow_tpu_torch/epic/matching.py
// `_best_displacement` (a [B, H, 2r+1, W] cost stack per dy).
//
// What it computes: g1, g2 [B, H, W] float32; points ys, xs [B, P] int64
// inside the image. The cost of (dy, dx) at (y, x) sums over the patch
// offsets (py, px) in [-p, p]^2: a patch pixel (y+py, x+px) outside the
// image adds 0; else |g1[y+py, x+px] - g2v| where g2v = g2[y+py+dy,
// x+px+dx] if that pixel is inside the image, else 0 and the tap adds 1e3
// more. out[b, i] = the first k = (dy+r)(2r+1) + (dx+r) of least cost.
// Each cost is summed in one fixed order: patch rows top to bottom, each
// row's taps left to right into a row sum, the row sums in turn. There is
// no multiply, so nothing is contracted into an FMA: tests/match_model.py
// repeats the arithmetic in numpy float32 and gets the same labels.
//
// What bounds it on an H100: operations. A point needs (2r+1)^2 patch sums
// of (2p+1)^2 taps and reads only its (2r+2p+1)^2 search window: at B = 4,
// 270x480, r = 50, p = 4 the 2,040 grid points need 13.5 G taps for both
// directions against ~4 MB of images. A tap cannot take fewer than two
// float32 instructions, FADD t = a - b and FADD s = s + |t| (the absolute
// value is an operand modifier), so the instruction rate sets the floor.
//
// Design: one block per (point, pair).
// - Sentinel-padded window. The block stages g1's patch and g2's search
//   window in shared memory (opted in above 48 KB once per device; the
//   window by cp.async). Window cells whose column lies outside the image
//   hold SENTINEL = -1e3, and one extra row holds SENTINEL throughout and
//   stands for every image row outside the image. For a patch value
//   a >= 0, float32 |a - (-1e3)| is a + 1e3 rounded once, as |a - 0| + 1e3
//   is: the cost is bitwise the same without a bound test or a
//   conditional add per tap. A block whose in-image patch holds a
//   negative (or NaN) value takes the general tap loop instead, which
//   tests each tap as the definition reads: one block-uniform branch,
//   decided by the data. `g_path_blocks` counts the blocks of each kind.
// - Patch bounds per point. The patch rows and columns inside the image
//   (py_lo..py_hi, px_lo..px_hi) are fixed once per block, so the tap loop
//   has no test; window column 0 is the image column a tap of px_lo at
//   dx = -r reads, patch column 0 is px_lo. The kernel is instantiated for
//   the CLIs' p = 4, with the tap loop unrolled (and cut at the last patch
//   column inside the image, a block-uniform test, for points within p of
//   the left or right edge), and for a runtime p.
// - NX displacements a thread. A thread takes NX consecutive dx of one dy:
//   per patch row it loads the q + NX - 1 window values it needs into
//   registers once and reads each patch value once (the same address for
//   the whole warp), then keeps NX row sums and NX costs. A row sum starts
//   from its first tap (0 + t is t for t >= 0 or NaN), so each tap costs
//   two FADDs and nothing else. At p = 4 both rows are read as float4
//   (VEC): a thread's window columns start at a multiple of NX, the row
//   pitch is 4 mod 8 floats and the patch pitch a multiple of 4. The lanes
//   of a warp take consecutive dy at the same dx, so the 8 lanes of each
//   float4 phase read distinct banks (with a runtime p the pitch is odd
//   and the reads are scalar, again in distinct banks).
// - Reduction. Each thread keeps the lexicographic minimum of (cost, k)
//   over its displacements; a warp shuffle and then a block reduction of
//   the same minimum give the first index of least cost, whatever the
//   thread count or the schedule.
// When the window does not fit the shared memory (a large radius on a
// large image), dy is taken in bands, the window's rows for one band at a
// time.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <initializer_list>
#include <mutex>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;
constexpr int NX = 8;                   // consecutive dx a thread
constexpr bool VEC = NX % 4 == 0;       // float4 reads at p = 4
constexpr int CLI_Q = 9;                // the CLIs' patch width (p = 4)
constexpr int MAX_DEVICES = 64;
constexpr float OUTSIDE = 1e3f;         // cost of a tap displaced out
constexpr float SENTINEL = -OUTSIDE;    // window cell outside the image

// scan modes: taps unrolled (p = 4, patch columns all inside), the same
// loop cut at the last patch column inside, taps in a runtime loop
// (runtime p), the general tap loop (a negative patch value)
enum Mode { UNROLLED, CLIPPED, RUNTIME, GENERAL };

// blocks that took the sentinel path and the general path, on this device
__device__ unsigned long long g_path_blocks[2];

struct Args {
  const float* g1;
  const float* g2;
  const long long* ys;
  const long long* xs;
  long long* out;
  int H, W, P, r, p;
  int band;    // dy values per band
  int pitch;   // floats per window row in shared memory
  int wrows;   // window rows in shared memory, the sentinel row last
};

__device__ __forceinline__ void keep_min(float& c, int& k, float oc, int ok) {
  if (oc < c || (oc == c && ok < k)) {
    c = oc;
    k = ok;
  }
}

// Floats per patch row in shared memory (a multiple of 4) and of the
// patch.
__host__ __device__ constexpr int patch_pitch(int q) { return (q + 3) & ~3; }
__host__ __device__ constexpr int patch_floats(int q) {
  return q * patch_pitch(q);
}

// What a block's scan of one band needs.
struct Point {
  const float* patch;   // g1's patch from column px_lo on
  const float* win;     // window rows of the band
  const float* sent;    // the sentinel row
  int q, p, y, oy, H, W, pitch;
  int py_lo, py_hi, px_lo, nq;
  int cx0;              // image column of window column 0
};

// The NX costs of displacements (dy, dx0 + j), j < NX, whose taps read
// the window from column `col` on. Each cost in the fixed order.
template <int Q, int MODE>
__device__ __forceinline__ void item_costs(const Point& s, int dy, int col,
                                           float (&cost)[NX]) {
#pragma unroll
  for (int j = 0; j < NX; ++j) cost[j] = 0.f;
  for (int py = s.py_lo; py <= s.py_hi; ++py) {
    const int ty = s.y + py + dy;
    const bool row_in = (unsigned)ty < (unsigned)s.H;
    const float* wrow =
        (row_in ? s.win + (ty - s.oy) * s.pitch : s.sent) + col;
    const float* prow = s.patch + (py + s.p) * patch_pitch(s.q);
    float rs[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) rs[j] = 0.f;
    if constexpr ((MODE == UNROLLED || MODE == CLIPPED) && Q > 0) {
      constexpr int NV = (Q + NX + 2) / 4;   // float4 of window a row
      float w[4 * NV], pv[patch_pitch(Q)];
      if constexpr (VEC) {
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 t = reinterpret_cast<const float4*>(wrow)[v];
          w[4 * v] = t.x, w[4 * v + 1] = t.y, w[4 * v + 2] = t.z;
          w[4 * v + 3] = t.w;
        }
#pragma unroll
        for (int v = 0; v < patch_pitch(Q) / 4; ++v) {
          const float4 t = reinterpret_cast<const float4*>(prow)[v];
          pv[4 * v] = t.x, pv[4 * v + 1] = t.y, pv[4 * v + 2] = t.z;
          pv[4 * v + 3] = t.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < Q + NX - 1; ++c) w[c] = wrow[c];
#pragma unroll
        for (int c = 0; c < Q; ++c) pv[c] = prow[c];
      }
#pragma unroll
      for (int c = 0; c < Q; ++c) {
        if (MODE == CLIPPED && c >= s.nq) break;
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const float t = fabsf(pv[c] - w[c + j]);
          rs[j] = c == 0 ? t : rs[j] + t;
        }
      }
    } else {
      for (int c = 0; c < s.nq; ++c) {
        const float a = prow[c];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const float v = wrow[c + j];
          if constexpr (MODE == GENERAL) {
            const int tx = s.cx0 + col + c + j;
            const bool in = row_in && tx >= 0 && tx < s.W;
            float t = fabsf(a - (in ? v : 0.f));
            if (!in) t += OUTSIDE;
            rs[j] += t;
          } else {
            rs[j] += fabsf(a - v);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) cost[j] += rs[j];
  }
}

// One band's displacements dy0..dy1 over the block's threads: item `it`
// is NX consecutive dx of one dy, the lanes of a warp on consecutive dy.
template <int Q, int MODE>
__device__ __forceinline__ void scan_band(const Point& s, int dy0, int dy1,
                                          int r, float& best, int& best_k) {
  const int d = 2 * r + 1, nb = dy1 - dy0 + 1;
  const int items = nb * ((d + NX - 1) / NX);
  for (int it = threadIdx.x; it < items; it += NT) {
    const int xi = it / nb, dy = dy0 + (it - xi * nb);
    float cost[NX];
    item_costs<Q, MODE>(s, dy, xi * NX, cost);
    const int k0 = (dy + r) * d + xi * NX;
#pragma unroll
    for (int j = 0; j < NX; ++j)
      if (xi * NX + j < d) keep_min(best, best_k, cost[j], k0 + j);
  }
}

// Q > 0: the patch width fixed at compile time (p = (Q - 1) / 2); 0: p at
// run time.
template <int Q>
__global__ void __launch_bounds__(NT) grid_match_kernel(Args a) {
  extern __shared__ float smem[];
  const int p = Q > 0 ? (Q - 1) / 2 : a.p;
  const int q = 2 * p + 1, r = a.r;
  float* patch = smem;                   // q rows: g1 around the point
  float* red_c = patch + patch_floats(q);  // NW partial minima
  int* red_k = reinterpret_cast<int*>(red_c + NW);
  float* win = reinterpret_cast<float*>(red_k + NW);

  const int b = blockIdx.y, i = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = a.H, W = a.W;
  const size_t hw = (size_t)H * W;
  const float* g1 = a.g1 + b * hw;
  const float* g2 = a.g2 + b * hw;
  const int y = (int)a.ys[(size_t)b * a.P + i];
  const int x = (int)a.xs[(size_t)b * a.P + i];

  // the patch's cells inside the image, each row from column px_lo on
  bool neg = false;
  for (int t = tid; t < q * q; t += NT) {
    const int yy = y + t / q - p, xx = x + t % q - p;
    if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
      const float v = g1[(size_t)yy * W + xx];
      patch[(t / q) * patch_pitch(q) + xx - max(0, x - p)] = v;
      neg |= !(v >= 0.f);
    }
  }
  const bool general = __syncthreads_or(neg);
  if (tid == 0) atomicAdd(&g_path_blocks[general ? 1 : 0], 1ull);

  Point s;
  s.patch = patch;
  s.win = win;
  s.sent = win + (size_t)(a.wrows - 1) * a.pitch;
  s.q = q;
  s.p = p;
  s.y = y;
  s.H = H;
  s.W = W;
  s.pitch = a.pitch;
  s.py_lo = max(-p, -y);
  s.py_hi = min(p, H - 1 - y);
  s.px_lo = max(-p, -x);
  s.nq = min(p, W - 1 - x) - s.px_lo + 1;
  s.cx0 = x + s.px_lo - r;
  for (int t = tid; t < a.pitch; t += NT)
    win[(a.wrows - 1) * a.pitch + t] = SENTINEL;

  float best = CUDART_INF_F;
  int best_k = INT_MAX;
  for (int dy0 = -r; dy0 <= r; dy0 += a.band) {
    const int dy1 = min(r, dy0 + a.band - 1);
    // the image rows the band's in-image patch rows reach
    s.oy = max(0, y + s.py_lo + dy0);
    const int rows = min(H - 1, y + s.py_hi + dy1) - s.oy + 1;
    __syncthreads();                     // the last band's window is done
    for (int rr = warp; rr < rows; rr += NW) {
      const float* src = g2 + (size_t)(s.oy + rr) * W;
      float* dst = win + rr * a.pitch;
      for (int c = lane; c < a.pitch; c += 32) {
        const int gx = s.cx0 + c;
        if (gx >= 0 && gx < W)
          sf::cp_async4(dst + c, src + gx);
        else
          dst[c] = SENTINEL;
      }
    }
    sf::cp_async_wait_all();
    __syncthreads();
    if (general)
      scan_band<Q, GENERAL>(s, dy0, dy1, r, best, best_k);
    else if (Q > 0 && s.nq == Q)
      scan_band<Q, UNROLLED>(s, dy0, dy1, r, best, best_k);
    else if (Q > 0)
      scan_band<Q, CLIPPED>(s, dy0, dy1, r, best, best_k);
    else
      scan_band<Q, RUNTIME>(s, dy0, dy1, r, best, best_k);
  }

  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, best, off);
    const int ok = __shfl_down_sync(0xffffffffu, best_k, off);
    keep_min(best, best_k, oc, ok);
  }
  if (lane == 0) {
    red_c[warp] = best;
    red_k[warp] = best_k;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < NW; ++w) keep_min(best, best_k, red_c[w], red_k[w]);
    a.out[(size_t)b * a.P + i] = best_k == INT_MAX ? 0 : best_k;
  }
}

// The instance of the kernel for patch radius p.
void (*kernel_for(int p))(Args) {
  return 2 * p + 1 == CLI_Q ? grid_match_kernel<CLI_Q> : grid_match_kernel<0>;
}

// The opt-in shared-memory limit of the current device, and both
// instances' limits raised to it, once per device (several host threads
// launch).
cudaError_t device_smem(int& optin) {
  static std::mutex mu;
  static bool done[MAX_DEVICES];
  static cudaError_t errs[MAX_DEVICES];
  static int limits[MAX_DEVICES];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaDeviceGetAttribute(&limits[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    for (int p : {(CLI_Q - 1) / 2, 0})
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel_for(p),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   limits[dev]);
    errs[dev] = err;
    done[dev] = true;
  }
  optin = limits[dev];
  return errs[dev];
}

struct Plan {
  int band, bands, wrows, pitch;
  size_t smem;
};

// The band plan at (H, W, r, p) under `optin` shared bytes a block. A row
// holds the 2r + q columns the taps reach and those that the last item of
// a dy row reads past them; its pitch is 4 mod 8 floats at p = 4 (float4
// reads), odd otherwise.
cudaError_t make_plan(int H, int W, int r, int p, int optin, Plan& pl) {
  const int q = 2 * p + 1, d = 2 * r + 1;
  if (q == CLI_Q) {
    pl.pitch = 2 * r + 4 * ((CLI_Q + NX + 2) / 4);
    pl.pitch += (12 - pl.pitch % 8) % 8;
  } else {
    pl.pitch = (2 * r + q + NX - 1) | 1;
  }
  const size_t fixed = (size_t)(patch_floats(q) + 2 * NW) * sizeof(float);
  const size_t row = (size_t)pl.pitch * sizeof(float);
  if ((size_t)optin < fixed + row * (q + 1)) return cudaErrorInvalidValue;
  const size_t max_rows = ((size_t)optin - fixed) / row - 1;  // image rows
  pl.band = (int)std::min((size_t)d, max_rows - 2 * p);
  pl.bands = (d + pl.band - 1) / pl.band;
  pl.wrows = std::min(pl.band + 2 * p, H) + 1;
  pl.smem = fixed + row * pl.wrows;
  return cudaSuccess;
}

}  // namespace

// The plan of a call: out[0..5] = dy values per band, bands, window rows in
// shared memory (the sentinel row included), floats per window row, shared
// bytes a block, displacements a thread (NX). Returns a cudaError_t code
// (cudaErrorInvalidValue: not even one dy fits the shared memory).
extern "C" int sf_grid_match_plan(int H, int W, int r, int p, long long* out) {
  if (H < 1 || W < 1 || r < 0 || p < 0) return (int)cudaErrorInvalidValue;
  int optin;
  cudaError_t err = device_smem(optin);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  if ((err = make_plan(H, W, r, p, optin, pl)) != cudaSuccess) return (int)err;
  const long long v[6] = {pl.band, pl.bands, pl.wrows, pl.pitch,
                          (long long)pl.smem, NX};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// out[0..2] = resident blocks per SM of patch radius p's instance at
// `smem` shared bytes, its registers per thread, spill bytes per thread.
extern "C" int sf_grid_match_occupancy(long long smem, int p, int* out) {
  int optin;
  cudaError_t err = device_smem(optin);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kernel_for(p))) != cudaSuccess)
    return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], kernel_for(p), NT, (size_t)smem);
}

// out[0..1] = blocks of the current device that took the sentinel path
// and the general path since the last call, which zeroes them. Waits for
// the device.
extern "C" int sf_grid_match_paths(long long* out) {
  unsigned long long v[2];
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(v, g_path_blocks, sizeof(v));
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)v[0];
  out[1] = (long long)v[1];
  const unsigned long long zero[2] = {0, 0};
  return (int)cudaMemcpyToSymbol(g_path_blocks, zero, sizeof(zero));
}

// out[b, i] (int64) for B pairs of [H, W] planes and P points each on
// `stream`. Returns a cudaError_t code (0 = launched).
extern "C" int sf_grid_match(const float* g1, const float* g2,
                             const long long* ys, const long long* xs,
                             long long* out, int B, int H, int W, int P, int r,
                             int p, void* stream) {
  if (B < 1 || H < 1 || W < 1 || P < 0 || r < 0 || p < 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (P == 0) return 0;
  int optin;
  cudaError_t err = device_smem(optin);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  if ((err = make_plan(H, W, r, p, optin, pl)) != cudaSuccess) return (int)err;
  Args a{g1, g2, ys, xs, out, H, W, P, r, p, pl.band, pl.pitch, pl.wrows};
  kernel_for(p)<<<dim3(P, B), NT, pl.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
