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
//
// What bounds it on an H100: operations. A point needs (2r+1)^2 patch sums
// of (2p+1)^2 taps, ~3 float operations a tap, and reads only its
// (2r+2p+1)^2 search window: at B = 4, 270x480, r = 50, p = 4 the 2,040
// grid points need ~20 GFLOP a direction against ~4 MB of images.
//
// Design: one block per (point, pair). The block stages g1's patch and the
// part of g2's search window that lies inside the image in shared memory
// (opted in above 48 KB once per device), then its threads stride over the
// displacements. Each thread sums its taps in one fixed order (patch rows
// top to bottom, each row's taps left to right into a row sum, the row sums
// in turn) and keeps its least (cost, k); a warp-shuffle and then a block
// reduction by the lexicographic minimum of (cost, k) gives the first index
// of least cost, so the result does not depend on the thread count or the
// schedule. There is no multiply, so nothing is contracted into an FMA:
// tests/match_model.py repeats the arithmetic in numpy float32 and gets
// the same labels. When the window does not fit the shared memory (a large
// radius on a wide image), dy is taken in bands of rows, the window's rows
// for one band at a time.
#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_DEVICES = 64;
constexpr float OUTSIDE = 1e3f;         // cost of a tap displaced out

struct Args {
  const float* g1;
  const float* g2;
  const long long* ys;
  const long long* xs;
  long long* out;
  int H, W, P, r, p;
  int band;    // dy values per band
  int wcols;   // floats per window row in shared memory
};

__device__ __forceinline__ void keep_min(float& c, int& k, float oc, int ok) {
  if (oc < c || (oc == c && ok < k)) {
    c = oc;
    k = ok;
  }
}

__global__ void __launch_bounds__(NT) grid_match_kernel(Args a) {
  extern __shared__ float smem[];
  const int q = 2 * a.p + 1, d = 2 * a.r + 1;
  float* patch = smem;                   // q * q: g1 around the point
  float* red_c = patch + q * q;          // NW partial minima
  int* red_k = reinterpret_cast<int*>(red_c + NW);
  float* win = reinterpret_cast<float*>(red_k + NW);

  const int b = blockIdx.y, i = blockIdx.x, tid = threadIdx.x;
  const int H = a.H, W = a.W, p = a.p, r = a.r;
  const size_t hw = (size_t)H * W;
  const float* g1 = a.g1 + b * hw;
  const float* g2 = a.g2 + b * hw;
  const int y = (int)a.ys[(size_t)b * a.P + i];
  const int x = (int)a.xs[(size_t)b * a.P + i];

  for (int t = tid; t < q * q; t += NT) {
    const int yy = y + t / q - p, xx = x + t % q - p;
    patch[t] = (yy >= 0 && yy < H && xx >= 0 && xx < W)
                   ? g1[(size_t)yy * W + xx] : 0.f;
  }
  // the image columns a displaced patch can reach
  const int ox = max(0, x - r - p);
  const int cols = min(W - 1, x + r + p) - ox + 1;

  float best = CUDART_INF_F;
  int best_k = INT_MAX;
  for (int dy0 = -r; dy0 <= r; dy0 += a.band) {
    const int dy1 = min(r, dy0 + a.band - 1);
    // the image rows this band of dy reaches
    const int oy = max(0, y - p + dy0);
    const int rows = min(H - 1, y + p + dy1) - oy + 1;
    __syncthreads();                     // the last band's window is done
    for (int t = tid; t < rows * cols; t += NT) {
      const int rr = t / cols, cc = t % cols;
      win[rr * a.wcols + cc] = g2[(size_t)(oy + rr) * W + ox + cc];
    }
    __syncthreads();
    const int nk = (dy1 - dy0 + 1) * d;
    for (int j = tid; j < nk; j += NT) {
      const int dy = dy0 + j / d, dx = j % d - r;
      float cost = 0.f;
      for (int py = -p; py <= p; ++py) {
        const int yy = y + py;
        if (yy < 0 || yy >= H) continue;
        const int ty = yy + dy;
        const bool row_in = ty >= 0 && ty < H;
        const float* wrow = win + (row_in ? (ty - oy) * a.wcols : 0);
        const float* prow = patch + (py + p) * q + p;
        float rs = 0.f;
        for (int px = -p; px <= p; ++px) {
          const int xx = x + px;
          if (xx < 0 || xx >= W) continue;
          const int tx = xx + dx;
          const bool in = row_in && tx >= 0 && tx < W;
          float t = fabsf(prow[px] - (in ? wrow[tx - ox] : 0.f));
          if (!in) t += OUTSIDE;
          rs += t;
        }
        cost += rs;
      }
      // k rises along a thread's displacements, so a tie keeps the first
      if (cost < best) {
        best = cost;
        best_k = (dy + r) * d + dx + r;
      }
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
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

// The opt-in shared-memory limit of the current device, and the kernel's
// limit raised to it, once per device (several host threads launch).
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
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(grid_match_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 limits[dev]);
    errs[dev] = err;
    done[dev] = true;
  }
  optin = limits[dev];
  return errs[dev];
}

struct Plan {
  int band, bands, wrows, wcols;
  size_t smem;
};

// The band plan at (H, W, r, p) under `optin` shared bytes a block.
cudaError_t make_plan(int H, int W, int r, int p, int optin, Plan& pl) {
  const int q = 2 * p + 1, d = 2 * r + 1;
  pl.wcols = std::min(2 * r + 2 * p + 1, W);
  const size_t fixed = (size_t)(q * q + 2 * NW) * sizeof(float);
  const size_t row = (size_t)pl.wcols * sizeof(float);
  if ((size_t)optin < fixed + row * q) return cudaErrorInvalidValue;
  const size_t max_rows = ((size_t)optin - fixed) / row;
  pl.band = (int)std::min((size_t)d, max_rows - 2 * p);
  pl.bands = (d + pl.band - 1) / pl.band;
  pl.wrows = std::min(pl.band + 2 * p, H);
  pl.smem = fixed + row * pl.wrows;
  return cudaSuccess;
}

}  // namespace

// The plan of a call: out[0..4] = dy values per band, bands, window rows
// and columns in shared memory, shared bytes a block. Returns a cudaError_t
// code (cudaErrorInvalidValue: not even one dy fits the shared memory).
extern "C" int sf_grid_match_plan(int H, int W, int r, int p, long long* out) {
  if (H < 1 || W < 1 || r < 0 || p < 0) return (int)cudaErrorInvalidValue;
  int optin;
  cudaError_t err = device_smem(optin);
  if (err != cudaSuccess) return (int)err;
  Plan pl;
  if ((err = make_plan(H, W, r, p, optin, pl)) != cudaSuccess) return (int)err;
  const long long v[5] = {pl.band, pl.bands, pl.wrows, pl.wcols,
                          (long long)pl.smem};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// out[0..2] = resident blocks per SM at `smem` shared bytes, registers per
// thread, spill bytes per thread.
extern "C" int sf_grid_match_occupancy(long long smem, int* out) {
  int optin;
  cudaError_t err = device_smem(optin);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, grid_match_kernel)) != cudaSuccess)
    return (int)err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], grid_match_kernel, NT, (size_t)smem);
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
  Args a{g1, g2, ys, xs, out, H, W, P, r, p, pl.band, pl.wcols};
  grid_match_kernel<<<dim3(P, B), NT, pl.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
