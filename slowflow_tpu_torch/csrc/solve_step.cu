// K1: one post-assembly solve step of the multi-frame jet solve.
//
// Replaces the TPU kernel slowflow_tpu/variational/fused_solve.py
// `_solve_kernel`. Plain PyTorch twin: variational/fused_solve.py
// `solve_step_ref` (compute_smoothness_mt + 2x sub_laplacian +
// sor_coupled_rb).
//
// What it computes, per jet: edge-aware robust smoothness weights (methods
// 0/1/2), the two sub_laplacian right-hand-side adjustments, the 2x2 block
// inverse, then `iterations` red-black coupled SOR sweeps with relaxation
// omega, red = (row + col) % 2 == 0 first; optionally the sums
// (sum |ndu - du|, sum |ndv - dv|) for the caller's convergence test.
//
// What bounds it on an H100: launch latency and L2 bandwidth. A half-sweep
// over 4 x 270 x 480 touches ~0.26 M cells x 13 floats; the level's ~12
// planes (~6 MB per jet, ~25 MB for 4 jets) stay in the 50 MB L2, and each
// half-sweep depends on the whole plane of the previous one. One 480 x 270
// plane (518 KB) exceeds an SM's 227 KB of shared memory, so the TPU
// design (whole level resident in one program) does not carry over.
//
// Design: a prologue launch computes wh, wv, the adjusted RHS and
// (i11, i12, i22) into scratch planes (each thread recomputes its west and
// north neighbour's weights, so no second pass is needed), and seeds
// ndu/ndv; then 2 * iterations half-sweep launches update only their
// colour's cells, one thread per cell, blockIdx.z = jet. The change sums are
// reduced deterministically: fixed per-block partials, then one block per
// jet sums them in a fixed order (float atomics would make the outer loop's
// `change >= thres` exits vary from run to run).
//
// K5 (`sf_sor_coupled_rb`, end of file) is the sweep loop alone on a given
// system, for the composed solve: its own prologue fills the same scratch
// planes from given weights, then the same half-sweep launches. It is bound
// as K1's sweeps are.
#include "common.cuh"

namespace {

struct SolveArgs {
  const float *uu, *vv, *dpsis, *a11, *a12, *a22, *b1, *b2;
  int H, W, method;
  float alpha;
  sf::Pen reg;
};

// Smoothness weights (wh, wv) of pixel (i, j); wh is 0 on the last column
// and wv on the last row, as in compute_smoothness_mt.
__device__ void smooth_weights(const SolveArgs& a, const float* uu,
                               const float* vv, const float* dp, int i, int j,
                               float& wh, float& wv) {
  const int H = a.H, W = a.W;
  const int je = min(j + 1, W - 1), is = min(i + 1, H - 1);
  const bool has_e = j < W - 1, has_s = i < H - 1;
  auto at = [W](const float* p, int r, int c) { return p[r * W + c]; };
  const float u = at(uu, i, j), v = at(vv, i, j);
  const float ux1 = has_e ? at(uu, i, j + 1) - u : 0.f;
  const float vx1 = has_e ? at(vv, i, j + 1) - v : 0.f;
  const float uy1 = has_s ? at(uu, i + 1, j) - u : 0.f;
  const float vy1 = has_s ? at(vv, i + 1, j) - v : 0.f;
  const float d = at(dp, i, j);
  if (a.method <= 1) {
    float th_u = 0.f, th_v = 0.f, tv_u = 0.f, tv_v = 0.f;
    if (a.method == 1) {
      // DERIV_3PT central differences, edge clamped, averaged to the edge
      auto dy3 = [&](const float* p, int r, int c) {
        return -0.5f * at(p, max(r - 1, 0), c) + 0.5f * at(p, min(r + 1, H - 1), c);
      };
      auto dx3 = [&](const float* p, int r, int c) {
        return -0.5f * at(p, r, max(c - 1, 0)) + 0.5f * at(p, r, min(c + 1, W - 1));
      };
      th_u = 0.5f * (dy3(uu, i, j) + dy3(uu, i, je));
      th_v = 0.5f * (dy3(vv, i, j) + dy3(vv, i, je));
      tv_u = 0.5f * (dx3(uu, i, j) + dx3(uu, is, j));
      tv_v = 0.5f * (dx3(vv, i, j) + dx3(vv, is, j));
    }
    const float hsq = ux1 * ux1 + th_u * th_u + vx1 * vx1 + th_v * th_v;
    const float vsq = uy1 * uy1 + tv_u * tv_u + vy1 * vy1 + tv_v * tv_v;
    wh = (d + at(dp, i, je)) * a.alpha * sf::pen_deriv(a.reg, hsq);
    wv = (d + at(dp, is, j)) * a.alpha * sf::pen_deriv(a.reg, vsq);
  } else {
    const float sq = (has_e ? ux1 * ux1 + vx1 * vx1 : 0.f) +
                     (has_s ? uy1 * uy1 + vy1 * vy1 : 0.f);
    const float wsum = d + (has_e ? at(dp, i, je) : 0.f) + (has_s ? at(dp, is, j) : 0.f);
    wh = wv = wsum * a.alpha * sf::pen_deriv(a.reg, sq);
  }
  if (!has_e) wh = 0.f;
  if (!has_s) wv = 0.f;
}

// scratch planes, each [B, H, W]: 0 wh, 1 wv, 2 B1, 3 B2, 4 i11, 5 i12, 6 i22
__global__ void prologue_kernel(SolveArgs a, const float* __restrict__ du,
                                const float* __restrict__ dv,
                                float* __restrict__ ndu, float* __restrict__ ndv,
                                float* __restrict__ scratch, int B) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  const int H = a.H, W = a.W;
  if (i >= H || j >= W) return;
  const size_t HW = (size_t)H * W, off = b * HW;
  const float* uu = a.uu + off;
  const float* vv = a.vv + off;
  const float* dp = a.dpsis + off;
  const size_t p = (size_t)i * W + j;

  float wh, wv, whw = 0.f, wvn = 0.f, tmp;
  smooth_weights(a, uu, vv, dp, i, j, wh, wv);
  if (j > 0) smooth_weights(a, uu, vv, dp, i, j - 1, whw, tmp);
  if (i > 0) smooth_weights(a, uu, vv, dp, i - 1, j, tmp, wvn);

  // sub_laplacian: dst + th - th_west + tv - tv_north
  const int je = min(j + 1, W - 1), is = min(i + 1, H - 1);
  auto adjust = [&](float dst, const float* src) {
    const float s0 = src[p];
    const float th = wh * (src[(size_t)i * W + je] - s0);
    const float thw = j > 0 ? whw * (s0 - src[p - 1]) : 0.f;
    const float tv = wv * (src[(size_t)is * W + j] - s0);
    const float tvn = i > 0 ? wvn * (s0 - src[p - W]) : 0.f;
    return dst + th - thw + tv - tvn;
  };
  const float rhs1 = adjust(a.b1[off + p], uu);
  const float rhs2 = adjust(a.b2[off + p], vv);

  const float sum_w = wvn + whw + wv + wh;
  const float a12 = a.a12[off + p];
  const float A11 = a.a11[off + p] + sum_w;
  const float A22 = a.a22[off + p] + sum_w;
  float det = A11 * A22 - a12 * a12;
  det = det == 0.f ? 1.f : det;

  const size_t plane = (size_t)B * HW, q = off + p;
  scratch[q] = wh;
  scratch[plane + q] = wv;
  scratch[2 * plane + q] = rhs1;
  scratch[3 * plane + q] = rhs2;
  scratch[4 * plane + q] = A22 / det;
  scratch[5 * plane + q] = -a12 / det;
  scratch[6 * plane + q] = A11 / det;
  ndu[q] = du ? du[q] : 0.f;
  ndv[q] = dv ? dv[q] : 0.f;
}

// One half-sweep over the cells of `color` ((row + col) % 2 == color).
__global__ void half_sweep_kernel(float* __restrict__ du, float* __restrict__ dv,
                                  const float* __restrict__ scratch, int B,
                                  int H, int W, int color, float omega) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  const int j = 2 * k + ((i + color) & 1);
  if (i >= H || j >= W) return;
  const size_t HW = (size_t)H * W, plane = (size_t)B * HW;
  const size_t q = b * HW + (size_t)i * W + j;
  const float* wh = scratch;
  const float* wv = scratch + plane;
  const float w_n = i > 0 ? wv[q - W] : 0.f;
  const float w_w = j > 0 ? wh[q - 1] : 0.f;
  const float w_s = wv[q], w_e = wh[q];
  const float un = i > 0 ? du[q - W] : 0.f, vn = i > 0 ? dv[q - W] : 0.f;
  const float uw = j > 0 ? du[q - 1] : 0.f, vw = j > 0 ? dv[q - 1] : 0.f;
  const float us = i < H - 1 ? du[q + W] : 0.f, vs = i < H - 1 ? dv[q + W] : 0.f;
  const float ue = j < W - 1 ? du[q + 1] : 0.f, ve = j < W - 1 ? dv[q + 1] : 0.f;
  const float su = w_n * un + w_w * uw + w_s * us + w_e * ue;
  const float sv = w_n * vn + w_w * vw + w_s * vs + w_e * ve;
  const float B1 = scratch[2 * plane + q] + su;
  const float B2 = scratch[3 * plane + q] + sv;
  const float i11 = scratch[4 * plane + q], i12 = scratch[5 * plane + q];
  const float i22 = scratch[6 * plane + q];
  const float nu = i11 * B1 + i12 * B2;
  const float nv = i12 * B1 + i22 * B2;
  du[q] = (1.f - omega) * du[q] + omega * nu;
  dv[q] = (1.f - omega) * dv[q] + omega * nv;
}

// K5's prologue: the scratch planes of a given system. wh loses its last
// column and wv its last row (boundary), the 2x2 inverse uses the
// neighbour-weight sum in core/solver.py's order; ndu / ndv start from
// du / dv.
__global__ void sor_prologue_kernel(
    const float* __restrict__ du, const float* __restrict__ dv,
    const float* __restrict__ a11, const float* __restrict__ a12,
    const float* __restrict__ a22, const float* __restrict__ b1,
    const float* __restrict__ b2, const float* __restrict__ wh,
    const float* __restrict__ wv, float* __restrict__ ndu,
    float* __restrict__ ndv, float* __restrict__ scratch, int B, int H,
    int W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (i >= H || j >= W) return;
  const size_t HW = (size_t)H * W, plane = (size_t)B * HW;
  const size_t q = b * HW + (size_t)i * W + j;
  const float w_e = j < W - 1 ? wh[q] : 0.f;
  const float w_s = i < H - 1 ? wv[q] : 0.f;
  const float w_w = j > 0 ? wh[q - 1] : 0.f;
  const float w_n = i > 0 ? wv[q - W] : 0.f;
  const float sum_w = w_n + w_w + w_s + w_e;
  const float A11 = a11[q] + sum_w, A22 = a22[q] + sum_w, c12 = a12[q];
  float det = A11 * A22 - c12 * c12;
  det = det == 0.f ? 1.f : det;
  scratch[q] = w_e;
  scratch[plane + q] = w_s;
  scratch[2 * plane + q] = b1[q];
  scratch[3 * plane + q] = b2[q];
  scratch[4 * plane + q] = A22 / det;
  scratch[5 * plane + q] = -c12 / det;
  scratch[6 * plane + q] = A11 / det;
  ndu[q] = du[q];
  ndv[q] = dv[q];
}

// 2 * iterations half-sweep launches on ndu / ndv (K1 and K5).
cudaError_t launch_sweeps(float* ndu, float* ndv, const float* scratch, int B,
                          int H, int W, int iterations, float omega,
                          cudaStream_t st) {
  const int half_w = (W + 1) / 2;
  const dim3 sblock(32, 8), sgrid((half_w + 31) / 32, (H + 7) / 8, B);
  for (int it = 0; it < iterations; ++it) {
    for (int color = 0; color < 2; ++color) {
      half_sweep_kernel<<<sgrid, sblock, 0, st>>>(ndu, ndv, scratch, B, H, W,
                                                  color, omega);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

constexpr int RED_THREADS = 256, RED_BLOCKS = 64;

// partials[b][blk][2]: fixed-order block sums of |ndu - du|, |ndv - dv|
__global__ void change_partials_kernel(const float* __restrict__ ndu,
                                       const float* __restrict__ ndv,
                                       const float* __restrict__ du,
                                       const float* __restrict__ dv, int HW,
                                       float* __restrict__ partials) {
  __shared__ float su[RED_THREADS], sv[RED_THREADS];
  const int b = blockIdx.y, t = threadIdx.x;
  const size_t off = (size_t)b * HW;
  float au = 0.f, av = 0.f;
  for (int p = blockIdx.x * RED_THREADS + t; p < HW; p += RED_BLOCKS * RED_THREADS) {
    au += fabsf(ndu[off + p] - (du ? du[off + p] : 0.f));
    av += fabsf(ndv[off + p] - (dv ? dv[off + p] : 0.f));
  }
  su[t] = au;
  sv[t] = av;
  __syncthreads();
  for (int w = RED_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
      su[t] += su[t + w];
      sv[t] += sv[t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    partials[(b * RED_BLOCKS + blockIdx.x) * 2] = su[0];
    partials[(b * RED_BLOCKS + blockIdx.x) * 2 + 1] = sv[0];
  }
}

__global__ void change_final_kernel(const float* __restrict__ partials,
                                    float* __restrict__ sums) {
  const int b = blockIdx.x;
  if (threadIdx.x != 0) return;
  float au = 0.f, av = 0.f;
  for (int k = 0; k < RED_BLOCKS; ++k) {
    au += partials[(b * RED_BLOCKS + k) * 2];
    av += partials[(b * RED_BLOCKS + k) * 2 + 1];
  }
  sums[b * 2] = au;
  sums[b * 2 + 1] = av;
}

}  // namespace

// Launches the whole solve step on `stream`. du / dv may be null (start from
// zero); sums may be null (no change sums). scratch holds 7 * B * H * W
// floats, partials 2 * B * 64. Returns a cudaError_t code (0 = launched).
extern "C" int sf_solve_step(const float* uu, const float* vv,
                             const float* dpsis, const float* a11,
                             const float* a12, const float* a22,
                             const float* b1, const float* b2, const float* du,
                             const float* dv, float* ndu, float* ndv,
                             float* scratch, float* partials, float* sums,
                             int B, int H, int W, int method, int reg_fct,
                             float reg_eps_sq, float reg_trunc,
                             float reg_trunc_val, float alpha, int iterations,
                             float omega, void* stream) {
  if (B < 1 || H < 1 || W < 1 || iterations < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  SolveArgs a{uu, vv, dpsis, a11, a12, a22, b1, b2, H, W, method, alpha,
              sf::Pen{reg_fct, reg_eps_sq, reg_trunc, reg_trunc_val}};
  const dim3 pblock(32, 8), pgrid((W + 31) / 32, (H + 7) / 8, B);
  prologue_kernel<<<pgrid, pblock, 0, st>>>(a, du, dv, ndu, ndv, scratch, B);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_sweeps(ndu, ndv, scratch, B, H, W, iterations, omega, st);
  if (err != cudaSuccess) return (int)err;
  if (sums) {
    change_partials_kernel<<<dim3(RED_BLOCKS, B), RED_THREADS, 0, st>>>(
        ndu, ndv, du, dv, H * W, partials);
    change_final_kernel<<<B, 32, 0, st>>>(partials, sums);
  }
  return (int)cudaGetLastError();
}

// K5: `iterations` red-black coupled SOR sweeps on a given system
// (replaces the TPU kernel slowflow_tpu/core/solver_pallas.py `_sor_kernel`;
// plain twin core/solver.py `sor_coupled_rb`). The prologue writes K1's
// scratch layout from the given weights, then K1's half-sweep kernel runs
// 2 * iterations times on ndu / ndv, which start from du / dv. Every plane
// is [B, H, W]; du, dv and the system are read only. scratch holds
// 7 * B * H * W floats. Returns a cudaError_t code (0 = launched).
extern "C" int sf_sor_coupled_rb(const float* du, const float* dv,
                                 const float* a11, const float* a12,
                                 const float* a22, const float* b1,
                                 const float* b2, const float* wh,
                                 const float* wv, float* ndu, float* ndv,
                                 float* scratch, int B, int H, int W,
                                 int iterations, float omega, void* stream) {
  if (B < 1 || H < 1 || W < 1 || iterations < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 pblock(32, 8), pgrid((W + 31) / 32, (H + 7) / 8, B);
  sor_prologue_kernel<<<pgrid, pblock, 0, st>>>(du, dv, a11, a12, a22, b1, b2,
                                                wh, wv, ndu, ndv, scratch, B,
                                                H, W);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = launch_sweeps(ndu, ndv, scratch, B, H, W, iterations, omega, st);
  return (int)err;
}
