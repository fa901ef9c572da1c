// EPIC's locally-affine interpolation on the card: the per-seed weighted
// affine fits (kernelized geodesic weights fused in) and the per-pixel
// apply through the closest-seed label map.
//
// Replaces no TPU kernel: the JAX package fits and applies in host numpy
// (slowflow_tpu/epic/interp.py). Plain twins: slowflow_tpu_torch/epic/
// interp.py `_kernelize` -> `fit_localaffine` -> `apply_localaffine`, which
// the CPU path runs and the tests hold these kernels to.
//
// What it computes. A call holds the seeds of all of its jobs, concatenated:
// seeds, vects [S, 2] float32; the k-NN table of each job's seed graph,
// nnf [S, K] int32 job-local neighbour indices (-1 unfilled) and dis
// [S, K] float32 geodesic distances (+inf unfilled); src [S] int32, the
// job-local table row that holds each seed's neighbours, and d0 [S]
// float32, the distance at its pixel; job [S] int32, each seed's job, and
// starts [B + 1] int32, each job's first row and then S. For seed s of job
// b and each filled neighbour j of row starts[b] + src[s] (global g =
// starts[b] + j, at d = d0[s] + dis, the twin's float32 sum):
//   w = expf(-coef * d) + 1e-8 (0 for d not finite); if g == s: ci += 0.01 w,
//   w *= 0.96; P = w * w, all float32 as the twin rounds them;
//   the 12 moments P * {px px, px py, px, py py, py, 1, px bx, py bx, bx,
//   px by, py by, by} (bx = px + u, by = py + v, float32 products) summed
//   in float64. The float32 x float32 products are exact in float64, so
//   only the order of the sums differs from the twin (a contracted DFMA
//   rounds the same exact product once, as the separate add does).
// Then the four stabilizer rows at (sx +- 0.1, sy), (sx, sy +- 0.1) with
// weight (float)ci and the seed's own target are added in closed form, the
// 1e-9 ridge on the diagonal, and the two 3x3 normal systems are solved in
// float64 by Gaussian elimination with partial pivoting (the twin's LAPACK
// gesv), each of these steps in the twin's order and rounded once: a fit
// with little spread (a job of one seed has only the stabilizers' 0.1 px)
// is conditioned ~1e14, where one contracted FMA moves it by ~1e-5.
// A seed with an exactly zero pivot is not guessed: it takes the twin's
// fallback, the minimum-norm least-squares solution (numpy's lstsq, rcond
// None), here from a float64 Jacobi eigendecomposition of its symmetric
// system with lstsq's cutoff (an eigenvalue no larger in size than 3 eps
// times the largest is dropped), and is counted in counts[0]. A seed with a neighbour index
// beyond its job is counted in counts[1] (its row NaN), and the wrapper
// raises: the indices are checked here, in the pass that reads them.
// The apply: out[b, y, x] = (a00 x + a01 y + tx - x, a10 x + a11 y + ty - y)
// from the affine row start[b] + label, in the twin's float32 order, 0
// where the label is < 0.
//
// What bounds it on an H100: bytes. The stage-3 call (10 jobs of up to
// 32,400 seeds, K 160) reads ~415 MB of nnf / dis about once (a row twice
// only where two seeds share a pixel); the seeds' table
// (<= 0.5 MB a job) stays in L2 for the gathers. ~24 float64 operations a
// neighbour (1.2 GFLOP a call) are far below the card's float64 rate.
//
// Design: one warp a seed, the lanes striding over its K neighbours, so
// that each warp reads its row of nnf and dis coalesced and any mix of
// job sizes (stage 1 and 2's few thousand seeds a job, stage 3's ~32 k)
// takes one launch. The weights live in registers only. Each lane keeps
// the 12 moments and the self weight in float64; a butterfly of shuffles
// sums them (the same order on every run), and lane 0 adds the stabilizer
// and solves. The float32 steps use the _rn intrinsics, which nvcc never
// contracts into an FMA, so they round as the twin's numpy does; the apply
// is bitwise the twin for the same affine rows.
#include <cfloat>
#include <cmath>

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int FIT_THREADS = 256;                   // 8 seeds a block
constexpr int FIT_SEEDS = FIT_THREADS / 32;
constexpr int APPLY_THREADS = 256;
constexpr int NMOM = 13;                           // 12 moments + self weight

struct FitArgs {
  const float2* seeds;
  const float2* vects;
  const int* nnf;
  const float* dis;
  const int* src;
  const float* d0;
  const int* job;
  const int* starts;
  float* affine;        // [S, 6]
  int* counts;          // zero-pivot seeds, seeds with a bad index
  int S, K;
  float coef;
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Solves A x = b and A y = c (A 3x3, row-major) in place by elimination
// with partial pivoting, the first largest |pivot| in column order as
// LAPACK's idamax takes it. Returns false at an exactly zero pivot. Every
// step rounds once (_rn: nothing contracted), as numpy's would.
__device__ __forceinline__ bool solve3(double (&A)[3][3], double (&b)[3],
                                       double (&c)[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    double best = fabs(A[k][k]);
#pragma unroll
    for (int r = k + 1; r < 3; ++r) {
      if (fabs(A[r][k]) > best) {
        best = fabs(A[r][k]);
        p = r;
      }
    }
    if (!(best != 0.0)) return false;
#pragma unroll
    for (int r = k + 1; r < 3; ++r) {
      if (p == r) {            // compile-time indices: A stays in registers
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const double t = A[k][j];
          A[k][j] = A[r][j];
          A[r][j] = t;
        }
        double t = b[k]; b[k] = b[r]; b[r] = t;
        t = c[k]; c[k] = c[r]; c[r] = t;
      }
    }
#pragma unroll
    for (int r = k + 1; r < 3; ++r) {
      const double f = __ddiv_rn(A[r][k], A[k][k]);
#pragma unroll
      for (int j = k + 1; j < 3; ++j)
        A[r][j] = __dsub_rn(A[r][j], __dmul_rn(f, A[k][j]));
      b[r] = __dsub_rn(b[r], __dmul_rn(f, b[k]));
      c[r] = __dsub_rn(c[r], __dmul_rn(f, c[k]));
    }
  }
#pragma unroll
  for (int k = 2; k >= 0; --k) {
#pragma unroll
    for (int j = k + 1; j < 3; ++j) {
      b[k] = __dsub_rn(b[k], __dmul_rn(A[k][j], b[j]));
      c[k] = __dsub_rn(c[k], __dmul_rn(A[k][j], c[j]));
    }
    b[k] = __ddiv_rn(b[k], A[k][k]);
    c[k] = __ddiv_rn(c[k], A[k][k]);
  }
  return true;
}

// The minimum-norm least-squares solutions of A x = b and A y = c (A 3x3
// symmetric, row-major), as numpy's lstsq (rcond None) gives them: A's
// eigendecomposition by cyclic Jacobi rotations in float64, then
// x = sum over |l_i| > 3 eps max |l| of v_i (v_i . b) / l_i. A is symmetric,
// so its singular values are the |l_i| and this is lstsq's pseudo-inverse.
__device__ void lstsq3(double (&A)[3][3], double (&b)[3], double (&c)[3]) {
  double V[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  for (int sweep = 0; sweep < 16; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      const double apq = A[p][q];
      if (apq == 0.0) continue;
      rotated = true;
      const double theta = (A[q][q] - A[p][p]) / (2.0 * apq);
      double t = 1.0 / (fabs(theta) + sqrt(theta * theta + 1.0));
      if (theta < 0.0) t = -t;
      const double cs = 1.0 / sqrt(t * t + 1.0), sn = t * cs;
#pragma unroll
      for (int k = 0; k < 3; ++k) {      // A J
        const double akp = A[k][p], akq = A[k][q];
        A[k][p] = cs * akp - sn * akq;
        A[k][q] = sn * akp + cs * akq;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {      // J^T (A J)
        const double apk = A[p][k], aqk = A[q][k];
        A[p][k] = cs * apk - sn * aqk;
        A[q][k] = sn * apk + cs * aqk;
      }
      A[p][q] = A[q][p] = 0.0;
#pragma unroll
      for (int k = 0; k < 3; ++k) {      // V J
        const double vkp = V[k][p], vkq = V[k][q];
        V[k][p] = cs * vkp - sn * vkq;
        V[k][q] = sn * vkp + cs * vkq;
      }
    }
    if (!rotated) break;
  }
  const double cut = 3 * DBL_EPSILON
      * fmax(fabs(A[0][0]), fmax(fabs(A[1][1]), fabs(A[2][2])));
  double x[3] = {0, 0, 0}, y[3] = {0, 0, 0};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (!(fabs(A[i][i]) > cut)) continue;
    const double pb = (V[0][i] * b[0] + V[1][i] * b[1] + V[2][i] * b[2])
        / A[i][i];
    const double pc = (V[0][i] * c[0] + V[1][i] * c[1] + V[2][i] * c[2])
        / A[i][i];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] += V[k][i] * pb;
      y[k] += V[k][i] * pc;
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    b[k] = x[k];
    c[k] = y[k];
  }
}

// float64 steps rounded once each, as numpy's are (nothing contracted)
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}

__global__ void __launch_bounds__(FIT_THREADS)
    epic_fit_kernel(FitArgs a) {
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * FIT_SEEDS + (threadIdx.x >> 5);
  if (s >= a.S) return;                // whole warps leave together
  const int b = a.starts[a.job[s]];
  const int nb = a.starts[a.job[s] + 1] - b;
  const size_t row = (size_t)(b + a.src[s]) * a.K;
  const int* nrow = a.nnf + row;
  const float* drow = a.dis + row;
  const float d0 = a.d0[s];
  double m[NMOM];
#pragma unroll
  for (int i = 0; i < NMOM; ++i) m[i] = 0.0;
  bool bad = false;

  for (int k = lane; k < a.K; k += 32) {
    const int j = nrow[k];
    if (j < 0) continue;
    if (j >= nb) {
      bad = true;
      continue;
    }
    const float d = __fadd_rn(d0, drow[k]);
    float w = isfinite(d) ? __fadd_rn(expf(__fmul_rn(-a.coef, d)), 1e-8f)
                          : 0.f;
    const int g = b + j;
    if (g == s) {
      m[12] += (double)__fmul_rn(0.01f, w);
      w = __fmul_rn(w, 0.96f);
    }
    const double P = (double)__fmul_rn(w, w);
    const float2 pt = a.seeds[g];
    const float2 uv = a.vects[g];
    const float px = pt.x, py = pt.y;
    const float bx = __fadd_rn(px, uv.x);
    const float by = __fadd_rn(py, uv.y);
    m[0] += P * (double)__fmul_rn(px, px);
    m[1] += P * (double)__fmul_rn(px, py);
    m[2] += P * (double)px;
    m[3] += P * (double)__fmul_rn(py, py);
    m[4] += P * (double)py;
    m[5] += P;
    m[6] += P * (double)__fmul_rn(px, bx);
    m[7] += P * (double)__fmul_rn(py, bx);
    m[8] += P * (double)bx;
    m[9] += P * (double)__fmul_rn(px, by);
    m[10] += P * (double)__fmul_rn(py, by);
    m[11] += P * (double)by;
  }
#pragma unroll
  for (int i = 0; i < NMOM; ++i) m[i] = warp_sum(m[i]);
  bad = __any_sync(0xffffffffu, bad);
  if (lane != 0) return;
  float* out = a.affine + (size_t)s * 6;
  if (bad) {
    atomicAdd(&a.counts[1], 1);
#pragma unroll
    for (int i = 0; i < 6; ++i) out[i] = CUDART_NAN_F;
    return;
  }

  // stabilizer rows: (sx +- 0.1, sy) and (sx, sy +- 0.1), weight ci, each
  // mapped to the seed's own target
  const float2 own = a.seeds[s];
  const float2 ov = a.vects[s];
  const double ci = (double)(float)m[12];
  const double Pi = mul(ci, ci);
  const double d2 = 2 * 0.1 * 0.1;
  const double sx = own.x, sy = own.y;
  const double tx = add(sx, (double)ov.x), ty = add(sy, (double)ov.y);
  // the twin's order: the stabilizer added to each moment, then the ridge
  const double Sxx = add(add(m[0], mul(Pi, add(mul(mul(4, sx), sx), d2))),
                         1e-9);
  const double Sxy = add(m[1], mul(mul(mul(Pi, 4), sx), sy));
  const double Sx = add(m[2], mul(mul(Pi, 4), sx));
  const double Syy = add(add(m[3], mul(Pi, add(mul(mul(4, sy), sy), d2))),
                         1e-9);
  const double Sy = add(m[4], mul(mul(Pi, 4), sy));
  const double S0 = add(add(m[5], mul(Pi, 4)), 1e-9);
  const double x0[3] = {add(m[6], mul(Pi, add(mul(mul(4, sx), tx), d2))),
                        add(m[7], mul(Pi, mul(mul(4, sy), tx))),
                        add(m[8], mul(Pi, mul(4, tx)))};
  const double y0[3] = {add(m[9], mul(Pi, mul(mul(4, sx), ty))),
                        add(m[10], mul(Pi, add(mul(mul(4, sy), ty), d2))),
                        add(m[11], mul(Pi, mul(4, ty)))};
  double x[3] = {x0[0], x0[1], x0[2]}, y[3] = {y0[0], y0[1], y0[2]};
  double A[3][3] = {{Sxx, Sxy, Sx}, {Sxy, Syy, Sy}, {Sx, Sy, S0}};
  if (!solve3(A, x, y)) {
    // the twin's fallback, from the system as it was before solve3
    double B[3][3] = {{Sxx, Sxy, Sx}, {Sxy, Syy, Sy}, {Sx, Sy, S0}};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      x[i] = x0[i];
      y[i] = y0[i];
    }
    lstsq3(B, x, y);
    atomicAdd(&a.counts[0], 1);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = (float)x[i];
    out[3 + i] = (float)y[i];
  }
}

__global__ void __launch_bounds__(APPLY_THREADS)
    epic_apply_kernel(const int* __restrict__ labels,
                      const int* __restrict__ start,
                      const float* __restrict__ affine, int H, int W,
                      long long n, float2* __restrict__ out) {
  const long long i = (long long)blockIdx.x * APPLY_THREADS + threadIdx.x;
  if (i >= n) return;
  const long long hw = (long long)H * W;
  const int b = (int)(i / hw);
  const int rem = (int)(i - b * hw);
  const int yi = rem / W;
  const float fy = (float)yi;
  const float fx = (float)(rem - yi * W);
  const int l = labels[i];
  float u = 0.f, v = 0.f;
  if (l >= 0) {
    const float* m = affine + (size_t)(start[b] + l) * 6;
    u = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], fx),
                                      __fmul_rn(m[1], fy)), m[2]), fx);
    v = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], fx),
                                      __fmul_rn(m[4], fy)), m[5]), fy);
  }
  out[i] = make_float2(u, v);
}

}  // namespace

// affine [S, 6] from the packed k-NN fields of a call (see the top of the
// file); counts (2 ints, zeroed here first, S == 0 included) receive the
// number of zero-pivot seeds solved by least squares and of seeds with a
// bad index. On `stream`; returns a cudaError_t code (0 = launched).
extern "C" int sf_epic_fit(const float* seeds, const float* vects,
                           const int* nnf, const float* dis, const int* src,
                           const float* d0, const int* job,
                           const int* starts, float* affine, int* counts,
                           int S, int K, float coef, void* stream) {
  if (S < 0 || K < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaMemsetAsync(counts, 0, 2 * sizeof(int),
                                          (cudaStream_t)stream);
  if (err != cudaSuccess || S == 0) return (int)err;
  FitArgs a{reinterpret_cast<const float2*>(seeds),
            reinterpret_cast<const float2*>(vects),
            nnf, dis, src, d0, job, starts, affine, counts, S, K, coef};
  const int blocks = (S + FIT_SEEDS - 1) / FIT_SEEDS;
  epic_fit_kernel<<<blocks, FIT_THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out [B, H, W, 2] float32 from labels [B, H, W] int32 (job-local seed
// indices, < 0 none), start [B] int32 (each image's first affine row) and
// affine [S, 6]. On `stream`; returns a cudaError_t code (0 = launched).
extern "C" int sf_epic_apply(const int* labels, const int* start,
                             const float* affine, float* out, int B, int H,
                             int W, void* stream) {
  if (B < 0 || H < 0 || W < 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * H * W;
  if (n == 0) return 0;
  const long long blocks = (n + APPLY_THREADS - 1) / APPLY_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  epic_apply_kernel<<<(unsigned)blocks, APPLY_THREADS, 0,
                      (cudaStream_t)stream>>>(
      labels, start, affine, H, W, n, reinterpret_cast<float2*>(out));
  return (int)cudaGetLastError();
}
