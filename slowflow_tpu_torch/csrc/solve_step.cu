// K1: one post-assembly solve step of the multi-frame jet solve, and K5, the
// red-black coupled SOR sweeps on a given system. One cooperative launch per
// call for each.
//
// K1 replaces the TPU kernel slowflow_tpu/variational/fused_solve.py
// `_solve_kernel`. Plain PyTorch twin: variational/fused_solve.py
// `solve_step_ref` (compute_smoothness_mt + 2x sub_laplacian +
// sor_coupled_rb). K5 (`sf_sor_coupled_rb`) replaces
// slowflow_tpu/core/solver_pallas.py `_sor_kernel`; plain twin core/solver.py
// `sor_coupled_rb`.
//
// What K1 computes, per jet: edge-aware robust smoothness weights (methods
// 0/1/2), the two sub_laplacian right-hand-side adjustments, the 2x2 block
// inverse, then `iterations` red-black coupled SOR sweeps with relaxation
// omega, red = (row + col) % 2 == 0 first; optionally the sums
// (sum |ndu - du|, sum |ndv - dv|) for the caller's convergence test. K5 takes
// the weights as given (zeroing wh's last column and wv's last row), the RHS
// as given, and runs the same sweeps from du, dv.
// Strip windows (slowflow_tpu_torch/parallel/strips.py): an optional int32
// table rows[B][3] gives each jet entry's first image row, whose parity
// shifts the colours (red = (image row + col) % 2 == 0), and its own rows
// [lo, hi), the only rows K1's change sums count. Null: whole images.
//
// What bounds it on an H100: not bytes (~21 MB in and out at 4 x 270 x 480,
// ~6 us at 3.35 TB/s) nor flops (~0.5 GFLOP for 30 sweeps, ~7 us at 67
// TFLOP/s), but the 2 * iterations dependent half-sweeps: each needs the
// other colour of its neighbours, so every half-sweep waits for the bands
// that touch (an L2 round trip and block barriers, ~1.1 us a half-sweep on
// an H100 SXM), and its cell updates are bound by shared-memory traffic (19
// loads a cell); the grouped path pays them once a group. The row-streamed
// path is bound by HBM: a half-sweep reads its colour's nine arrays and the
// other colour's four and writes two, ~60 bytes a cell a sweep.
//
// Design: one persistent kernel, launched with cudaLaunchCooperativeKernel so
// that every block is resident. Each jet is cut into bands of rows; a block
// owns a band. The band's coefficients (wh, wv, rhs1, rhs2, i11, i12, i22)
// and its du, dv live colour-packed in the block's shared memory for the
// whole call ("resident"): row r, colour c holds the cells j with
// (r + j) % 2 == c at index k = j >> 1, so a warp's lanes read 32 consecutive
// cells of one colour and a cell's four neighbours sit at k (north, south),
// k - 1 + off and k + off (west, east) of the other colour, off = (r + c) & 1
// (the GPU form of the TPU kernel's `_packed_rb_sweeps`). The prologue builds
// the coefficients once per cell (the band computes the weights of its rows
// plus the row above), then the half-sweeps run. A half-sweep fetches the
// colour its neighbours updated last into its halo rows, updates its first
// and last row, publishes their new colour to an exchange buffer in global
// memory (L2), then updates the interior rows, so the exchange is in flight
// while the interior is computed. Each published cell is one 16-byte store
// {du, epoch, dv, epoch} (the LL protocol of NCCL: an 8-byte-aligned value
// and its flag land together), so the fetching threads poll the cells
// themselves until they carry the half-sweep's epoch: no fence, no separate
// flag, no grid-wide barrier between half-sweeps.
//
// Three regimes, chosen by the planner (make_plan) from B, H, W and the
// card's SMs and shared memory:
// - resident: the bands of all B jets fit one block per SM (the bench
//   shape, 4 x 270 x 480).
// - grouped: one jet's bands fit but the batch's do not (e.g. 8, 16 or 40 x
//   270 x 480, B x 540 x 960). The grid, one block per SM, walks the batch
//   in ceil(B / G_max) groups of at most G = ceil(B / ceil(B / G_max))
//   jets that differ by at most one jet; each group runs as the resident path does (prologue
//   into shared memory, 2 * iterations half-sweeps, epilogue), then the
//   blocks move on to the next group without a grid barrier: every band of
//   every group has exchange cells of its own, all set to epoch 0 before the
//   one grid barrier that follows the first group's prologue. This is the
//   TPU kernel's shape (one jet a grid program, held in VMEM for every
//   sweep) with a group of jets on chip in place of one.
// - row-streamed: one jet's bands do not fit (e.g. 1 x 1080 x 1920, the sp
//   path's 2 x 1207 x 3840 windows). Each band's packed arrays stay in a
//   global scratch region in the same colour-packed layout, and a
//   half-sweep walks the band's rows in order, in chunks of at most CHUNK
//   packed cells (a 1080p row is one chunk), through rings of rows in
//   shared memory that the TMA's bulk copies fill AHEAD rows ahead of the
//   row being updated: the other colour's du, dv, wh, wv, kept for the
//   rows above and below, in one ring, the updated colour's nine arrays,
//   needed for one row only, in a shorter one. The copies mark the
//   coefficients' lines to leave L2 first, so du / dv, stored and read
//   again every half-sweep, stay in L2 where they fit (at 1080p). The
//   updated cells go back to the region, and the first and last row are
//   published by the threads that update them. A block may own several
//   bands.
// Every block has NT threads. The cell update (relax) is one function for
// both paths, so du / dv do not depend on the regime, the bands or B.
// The change sums are deterministic: each band reduces its cells in a fixed
// order, and after a final grid barrier block 0 adds the band partials of
// each jet in band order (float atomics would make the outer loop's
// `change >= thres` exits vary from run to run).
#include <cooperative_groups.h>

#include <algorithm>
#include <mutex>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;            // threads per block
constexpr int FETCH_BATCH = 2;     // exchange loads in flight per thread
constexpr int AHEAD = 3;           // row-streamed: ring rows loading ahead
constexpr int RING_OWN = AHEAD + 1;  // ... the updated colour's arrays
constexpr int RING_NBR = AHEAD + 2;  // ... the other colour's (rows +- 1)
constexpr int CHUNK = 960;         // row-streamed: packed cells of a ring row
constexpr int STATIC_SMEM = 2 * NT * (int)sizeof(float);  // block_sum
constexpr int MAX_DEVICES = 64;    // per-device cache of the card's limits

struct SolveArgs {
  const float *uu, *vv, *dpsis, *a11, *a12, *a22, *b1, *b2;
  int H, W, method;
  float alpha;
  sf::Pen reg;
};

// Smoothness weights (wh, wv) of pixel (i, j) of one jet; wh is 0 on the last
// column and wv on the last row, as in compute_smoothness_mt.
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

// Everything one launch needs. K5 fills wh_in / wv_in and leaves the
// smoothness inputs of `s` null.
struct KernelArgs {
  SolveArgs s;
  const float *wh_in, *wv_in;          // K5: the given weights
  const float *du0, *dv0;              // start (null: zero)
  float *ndu, *ndv, *sums;             // outputs (sums may be null)
  const int* rows;                     // [B][3] strip windows, or null
  uint4* xch;                          // [B * bpj][edge][colour][hwp]
  float* regions;                      // row-streamed: [B * bpj][region]
  float* partials;                     // [B * bpj][2]
  int B, bpj, hwp, iterations;
  int groups;                          // group g: jets [g B / groups, ...)
  int kc, nch;                         // row-streamed: chunk width, chunks
  size_t region;                       // floats of one band's arrays
  float omega;
};

// Floats of one band's packed arrays: du, dv (rows -1..rows), wv (rows
// -1..rows-1), wh, rhs1, rhs2, i11, i12, i22 (rows 0..rows-1); each row holds
// two colours of hwp cells.
__host__ __device__ inline size_t region_floats(int rows, int hwp) {
  return (size_t)2 * hwp * (9 * rows + 5);
}

// One band of rows of one jet, its packed arrays and its neighbours. par is
// the parity of the jet entry's first image row; [lo, hi) its own rows.
struct Band {
  int b, i0, rows, id, par, lo, hi;
  bool above, below;
  float *du, *dv, *wv, *wh, *r1, *r2, *i11, *i12, *i22;
};

__device__ __forceinline__ int at(int lr, int c, int k, int hwp) {
  return (lr * 2 + c) * hwp + k;
}

__device__ Band band_at(const KernelArgs& a, int id, float* R, int H) {
  Band d;
  const int kb = id % a.bpj;
  d.id = id;
  d.b = id / a.bpj;
  d.i0 = (int)((long long)kb * H / a.bpj);
  d.rows = (int)((long long)(kb + 1) * H / a.bpj) - d.i0;
  d.above = kb > 0;
  d.below = kb < a.bpj - 1;
  d.par = a.rows ? a.rows[3 * d.b] & 1 : 0;
  d.lo = a.rows ? a.rows[3 * d.b + 1] : 0;
  d.hi = a.rows ? a.rows[3 * d.b + 2] : H;
  const size_t row = 2 * (size_t)a.hwp;
  d.du = R + row;  R += (d.rows + 2) * row;
  d.dv = R + row;  R += (d.rows + 2) * row;
  d.wv = R + row;  R += (d.rows + 1) * row;
  d.wh = R;        R += d.rows * row;
  d.r1 = R;        R += d.rows * row;
  d.r2 = R;        R += d.rows * row;
  d.i11 = R;       R += d.rows * row;
  d.i12 = R;       R += d.rows * row;
  d.i22 = R;
  return d;
}

// Weights, adjusted RHS, 2x2 inverse and starting du / dv of one band.
template <bool K5>
__device__ void prologue(const KernelArgs& a, const Band& d) {
  const int H = a.s.H, W = a.s.W, hwp = a.hwp;
  const size_t HW = (size_t)H * W, off = d.b * HW;
  const float* uu = K5 ? nullptr : a.s.uu + off;
  const float* vv = K5 ? nullptr : a.s.vv + off;
  const float* dp = K5 ? nullptr : a.s.dpsis + off;
  // pass 1: wh of the band's rows, wv of its rows and the row above
  for (int idx = threadIdx.x; idx < (d.rows + 1) * W; idx += blockDim.x) {
    const int lr = idx / W - 1, j = idx % W, i = d.i0 + lr;
    const int c = (i + j + d.par) & 1, k = j >> 1;
    float wh = 0.f, wv = 0.f;
    if (i >= 0) {
      if (K5) {
        const size_t q = off + (size_t)i * W + j;
        wh = j < W - 1 ? a.wh_in[q] : 0.f;
        wv = i < H - 1 ? a.wv_in[q] : 0.f;
      } else {
        smooth_weights(a.s, uu, vv, dp, i, j, wh, wv);
      }
    }
    d.wv[at(lr, c, k, hwp)] = wv;
    if (lr >= 0) d.wh[at(lr, c, k, hwp)] = wh;
  }
  // starting values of the halo rows (zero outside the image)
  for (int idx = threadIdx.x; idx < 2 * W; idx += blockDim.x) {
    const int lr = idx < W ? -1 : d.rows, j = idx % W, i = d.i0 + lr;
    const int c = (i + j + d.par) & 1, k = j >> 1;
    const bool in = i >= 0 && i < H && a.du0;
    const size_t q = off + (size_t)(in ? i : 0) * W + j;
    d.du[at(lr, c, k, hwp)] = in ? a.du0[q] : 0.f;
    d.dv[at(lr, c, k, hwp)] = in ? a.dv0[q] : 0.f;
  }
  __syncthreads();
  // pass 2: per cell, with the west / north neighbours' weights
  for (int idx = threadIdx.x; idx < d.rows * W; idx += blockDim.x) {
    const int lr = idx / W, j = idx % W, i = d.i0 + lr;
    const int c = (i + j + d.par) & 1, k = j >> 1, o = at(lr, c, k, hwp);
    const size_t p = (size_t)i * W + j, q = off + p;
    const float we = d.wh[o], ws = d.wv[o];
    const float ww = j > 0 ? d.wh[at(lr, c ^ 1, (j - 1) >> 1, hwp)] : 0.f;
    const float wn = d.wv[at(lr - 1, c ^ 1, k, hwp)];  // 0 above the image
    float rhs1, rhs2;
    if (K5) {
      rhs1 = a.s.b1[q];
      rhs2 = a.s.b2[q];
    } else {
      // sub_laplacian: dst + th - th_west + tv - tv_north
      const int je = min(j + 1, W - 1), is = min(i + 1, H - 1);
      auto adjust = [&](float dst, const float* src) {
        const float s0 = src[p];
        const float th = we * (src[(size_t)i * W + je] - s0);
        const float thw = j > 0 ? ww * (s0 - src[p - 1]) : 0.f;
        const float tv = ws * (src[(size_t)is * W + j] - s0);
        const float tvn = i > 0 ? wn * (s0 - src[p - W]) : 0.f;
        return dst + th - thw + tv - tvn;
      };
      rhs1 = adjust(a.s.b1[q], uu);
      rhs2 = adjust(a.s.b2[q], vv);
    }
    const float sum_w = wn + ww + ws + we;
    const float c12 = a.s.a12[q];
    const float A11 = a.s.a11[q] + sum_w, A22 = a.s.a22[q] + sum_w;
    float det = A11 * A22 - c12 * c12;
    det = det == 0.f ? 1.f : det;
    d.r1[o] = rhs1;
    d.r2[o] = rhs2;
    d.i11[o] = A22 / det;
    d.i12[o] = -c12 / det;
    d.i22[o] = A11 / det;
    d.du[o] = a.du0 ? a.du0[q] : 0.f;
    d.dv[o] = a.du0 ? a.dv0[q] : 0.f;
  }
  __syncthreads();
}

// One relaxed coupled update of a cell from its neighbours' other colour
// (north, west, south, east) and its system. Both paths call it, and its
// roundings are spelled out (no contraction left to nvcc, which contracts
// the same expressions differently in different kernels), so du / dv are
// the same bits on each. They are the roundings nvcc chose for the plain
// expressions su = w_n un + w_w uw + w_s us + w_e ue, nu = i11 B1 + i12
// B2, nv = i12 B1 + i22 B2, du = (1 - omega) du + omega nu (and dv) in the
// single-path kernel these paths replaced, so its results keep their bits.
__device__ __forceinline__ void relax(float w_n, float w_w, float w_s,
                                      float w_e, float un, float vn, float uw,
                                      float vw, float us, float vs, float ue,
                                      float ve, float r1, float r2, float i11,
                                      float i12, float i22, float omega,
                                      float& du, float& dv) {
  const float su = __fmaf_rn(w_e, ue, __fmaf_rn(w_s, us, __fmaf_rn(
      w_n, un, __fmul_rn(w_w, uw))));
  const float sv = __fmaf_rn(w_e, ve, __fmaf_rn(w_s, vs, __fmaf_rn(
      w_n, vn, __fmul_rn(w_w, vw))));
  const float B1 = __fadd_rn(r1, su), B2 = __fadd_rn(r2, sv);
  const float nu = __fmaf_rn(i12, B2, __fmul_rn(i11, B1));
  const float nv = __fmaf_rn(i12, B1, __fmul_rn(i22, B2));
  du = __fmaf_rn(1.f - omega, du, __fmul_rn(omega, nu));
  dv = __fmaf_rn(omega, nv, __fmul_rn(1.f - omega, dv));
}

// Updates the band's cells of colour c in rows r0, r0 + step, ... (n rows),
// with threads tid of nthr.
__device__ void half_sweep(const Band& d, int W, int hwp, int c, float omega,
                           int r0, int n, int step, int tid, int nthr) {
  // (m, k) walks the packed cells of colour c of those rows, nthr at a time
  const int dm = nthr / hwp, dk = nthr % hwp;
  int m = tid / hwp, k = tid % hwp;
  for (; m < n; m += dm, k += dk) {
    if (k >= hwp) {
      k -= hwp;
      if (++m >= n) break;
    }
    const int lr = r0 + m * step;
    const int off = (d.i0 + d.par + lr + c) & 1, j = 2 * k + off;
    if (j >= W) continue;
    const int o = at(lr, c, k, hwp), x = at(lr, c ^ 1, 0, hwp);
    const int no = at(lr - 1, c ^ 1, k, hwp), so = at(lr + 1, c ^ 1, k, hwp);
    const bool hw = j > 0, he = j < W - 1;
    float u = d.du[o], v = d.dv[o];
    relax(d.wv[no], hw ? d.wh[x + k - 1 + off] : 0.f, d.wv[o], d.wh[o],
          d.du[no], d.dv[no], hw ? d.du[x + k - 1 + off] : 0.f,
          hw ? d.dv[x + k - 1 + off] : 0.f, d.du[so], d.dv[so],
          he ? d.du[x + k + off] : 0.f, he ? d.dv[x + k + off] : 0.f, d.r1[o],
          d.r2[o], d.i11[o], d.i12[o], d.i22[o], omega, u, v);
    d.du[o] = u;
    d.dv[o] = v;
  }
}

__device__ __forceinline__ uint4* xch_row(const KernelArgs& a, int band,
                                          int edge, int c) {
  return a.xch + (((size_t)band * 2 + edge) * 2 + c) * a.hwp;
}

__device__ __forceinline__ void ll_store(uint4* p, float u, float v,
                                         unsigned e) {
  asm volatile("st.volatile.global.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p),
               "r"(__float_as_uint(u)), "r"(e), "r"(__float_as_uint(v)),
               "r"(e)
               : "memory");
}

__device__ __forceinline__ uint4 ll_load(const uint4* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p)
               : "memory");
  return v;
}

// Band -> exchange: colour c of its first (edge 0) and last (edge 1) row,
// tagged with epoch e.
__device__ void publish(const KernelArgs& a, const Band& d, int c,
                        unsigned e) {
  for (int idx = threadIdx.x; idx < 2 * a.hwp; idx += blockDim.x) {
    const int edge = idx >= a.hwp, k = idx - edge * a.hwp;
    if (edge ? !d.below : !d.above) continue;
    const int o = at(edge ? d.rows - 1 : 0, c, k, a.hwp);
    ll_store(xch_row(a, d.id, edge, c) + k, d.du[o], d.dv[o], e);
  }
}

// Exchange -> halo rows: colour c of the last row of the band above and of
// the first row of the band below, once those cells carry epoch e; threads
// tid of nthr, FETCH_BATCH loads in flight each.
__device__ void fetch_halo(const KernelArgs& a, const Band& d, int c,
                           unsigned e, int tid, int nthr) {
  const int n = 2 * a.hwp;
  auto src = [&](int idx) {
    const int edge = idx >= a.hwp;
    return xch_row(a, edge ? d.id + 1 : d.id - 1, 1 - edge, c) + idx - edge * a.hwp;
  };
  auto wanted = [&](int idx) { return idx < n && (idx >= a.hwp ? d.below : d.above); };
  for (int base = tid; base < n; base += FETCH_BATCH * nthr) {
    uint4 v[FETCH_BATCH];
#pragma unroll
    for (int q = 0; q < FETCH_BATCH; ++q)
      if (wanted(base + q * nthr)) v[q] = ll_load(src(base + q * nthr));
#pragma unroll
    for (int q = 0; q < FETCH_BATCH; ++q) {
      const int idx = base + q * nthr;
      if (!wanted(idx)) continue;
      while (v[q].y != e || v[q].w != e) v[q] = ll_load(src(idx));
      const int edge = idx >= a.hwp;
      const int o = at(edge ? d.rows : -1, c, idx - edge * a.hwp, a.hwp);
      d.du[o] = __uint_as_float(v[q].x);
      d.dv[o] = __uint_as_float(v[q].z);
    }
  }
}

// Row-streamed: a ring row's arrays, in floats from the row's start, for
// chunks of at most kc packed cells (kc, k0 and hwp are multiples of 4, so
// every copy is a multiple of 16 bytes). The other colour's ("nbr") du, dv
// and wh at packed cells k0 - 4 .. k0 + kc + 3 and its wv at k0 .. k0 + kc
// - 1; the updated colour's ("own") du, dv, wh, wv, rhs1, rhs2, i11, i12,
// i22 at k0 .. k0 + kc - 1.
struct NbrRow {
  int nu, nv, nwh, nwv, floats;
  __host__ __device__ explicit NbrRow(int kc)
      : nu(0), nv(kc + 8), nwh(2 * (kc + 8)), nwv(3 * (kc + 8)),
        floats(nwv + kc) {}
};
constexpr int OWN_ARRAYS = 9;

// Shared bytes of the row-streamed rings and their mbarriers (one an
// item, RING_NBR of them).
int ring_bytes(int kc) {
  return (RING_OWN * OWN_ARRAYS * kc + RING_NBR * NbrRow(kc).floats) *
             (int)sizeof(float) +
         RING_NBR * 8;
}

// The ring's copies: the Tensor Memory Accelerator's bulk copies (16-byte
// aligned, multiples of 16 bytes), each ring row's landing counted by an
// mbarrier of its own.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// A bulk copy; `first` marks its lines in L2 to be evicted first.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar,
                                          bool first) {
  unsigned long long policy;
  if (first)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(policy));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Row-streamed half-sweep of colour c of one band, epoch e for its
// published rows. The band's rows -1 .. rows of every chunk form one
// sequence of ring items; the item of row lr in 0 .. rows - 1 is updated
// once the items of rows lr - 1 .. lr + 1 have landed, while the bulk
// copies of the next AHEAD - 1 are in flight. `loaded` counts the block's
// items of every earlier pass: item g lands in own row g % RING_OWN and
// nbr row g % RING_NBR, counted by the (g / RING_NBR)-th phase of mbarrier
// g % RING_NBR. The halo rows must hold the neighbours' colour c ^ 1
// (fetch_halo). The updated cells are in the region once the block has
// passed a barrier.
__device__ void ring_half_sweep(const KernelArgs& a, const Band& d, int c,
                                unsigned e, float* smem, unsigned& loaded) {
  const int hwp = a.hwp, W = a.s.W, tid = threadIdx.x, n = c ^ 1;
  const int per = d.rows + 2, items = a.nch * per;
  const NbrRow L(a.kc);
  float* nbr_ring = smem + RING_OWN * OWN_ARRAYS * a.kc;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      nbr_ring + RING_NBR * L.floats);
  const float* own[OWN_ARRAYS] = {d.du, d.dv, d.wh, d.wv, d.r1,
                                  d.r2, d.i11, d.i12, d.i22};
  // the region's cells this block stored (the last pass, fetch_halo, the
  // prologue) are read by the bulk copies
  asm volatile("fence.proxy.async.global;" ::: "memory");
  __syncthreads();  // ... and the rings' last readers are done
  auto own_row = [&](int q) {
    return smem + (loaded + q) % RING_OWN * OWN_ARRAYS * a.kc;
  };
  auto nbr_row = [&](int q) {
    return nbr_ring + (loaded + q) % RING_NBR * L.floats;
  };
  auto bar = [&](int q) { return bars + (loaded + q) % RING_NBR; };
  auto load = [&](int q) {  // thread 0
    if (q >= items) return;
    const int lr = q % per - 1, k0 = q / per * a.kc;
    const int kc = min(a.kc, hwp - k0);
    const bool in = lr >= 0 && lr < d.rows;
    const int r = at(lr, n, 0, hwp), o = at(lr, c, 0, hwp);
    // nbr: du, dv (+ wh in the band) at k0 - 4 .. k0 + kc + 3 inside the
    // row, wv above the last row; own: the nine arrays, in the band. du /
    // dv (stored and read again every half-sweep) stay in L2 where they
    // fit; the coefficients are evicted first.
    const int lo = max(k0 - 4, 0), hi = min(k0 + kc + 4, hwp);
    const int nw = in ? 3 : 2, nwv = lr < d.rows, no = in ? OWN_ARRAYS : 0;
    float* s = nbr_row(q);
    bar_expect(bar(q), 4u * (nw * (hi - lo) + (nwv + no) * kc));
    for (int w = 0; w < nw; ++w)
      bulk_copy(s + w * (a.kc + 8) + lo - (k0 - 4),
                (w == 0 ? d.du : w == 1 ? d.dv : d.wh) + r + lo,
                4u * (hi - lo), bar(q), w == 2);
    if (nwv) bulk_copy(s + L.nwv, d.wv + r + k0, 4u * kc, bar(q), true);
    for (int w = 0; w < no; ++w)
      bulk_copy(own_row(q) + w * a.kc, own[w] + o + k0, 4u * kc, bar(q),
                w > 1);
  };
  if (tid == 0)
    for (int q = 0; q < AHEAD; ++q) load(q);
  for (int q = 0; q < items; ++q) {
    // item q + 1 has landed (and item 0 before the first step)
    if (q == 0) bar_wait(bar(0), loaded / RING_NBR & 1);
    if (q + 1 < items) bar_wait(bar(q + 1), (loaded + q + 1) / RING_NBR & 1);
    // every thread is past item q - 1: q - 1's own row and q - 2's nbr
    // row are free
    __syncthreads();
    if (tid == 0) load(q + AHEAD);
    const int lr = q % per - 1, k0 = q / per * a.kc;
    if (lr < 0 || lr >= d.rows) continue;
    const float* P = nbr_row(q + RING_NBR - 1);
    const float* C = nbr_row(q);
    const float* N = nbr_row(q + 1);
    const float* O = own_row(q);
    const int off = (d.i0 + d.par + lr + c) & 1, o = at(lr, c, k0, hwp);
    for (int i = tid; i < min(a.kc, hwp - k0); i += NT) {
      const int k = k0 + i, j = 2 * k + off;
      float u = O[i], v = O[a.kc + i];
      if (j < W) {
        const bool hw = j > 0, he = j < W - 1;
        const float* x = O + i;
        relax(P[L.nwv + i], hw ? C[L.nwh + i + 3 + off] : 0.f, x[3 * a.kc],
              x[2 * a.kc], P[L.nu + i + 4], P[L.nv + i + 4],
              hw ? C[L.nu + i + 3 + off] : 0.f,
              hw ? C[L.nv + i + 3 + off] : 0.f, N[L.nu + i + 4],
              N[L.nv + i + 4], he ? C[L.nu + i + 4 + off] : 0.f,
              he ? C[L.nv + i + 4 + off] : 0.f, x[4 * a.kc], x[5 * a.kc],
              x[6 * a.kc], x[7 * a.kc], x[8 * a.kc], a.omega, u, v);
        d.du[o + i] = u;
        d.dv[o + i] = v;
      }
      // every cell of an edge row is published, as publish() does
      if (lr == 0 && d.above) ll_store(xch_row(a, d.id, 0, c) + k, u, v, e);
      if (lr == d.rows - 1 && d.below)
        ll_store(xch_row(a, d.id, 1, c) + k, u, v, e);
    }
  }
  loaded += items;
}

// Fixed-order block sum of (u, v) (blockDim.x a power of 2).
__device__ void block_sum(float& u, float& v) {
  __shared__ float su[NT], sv[NT];
  su[threadIdx.x] = u;
  sv[threadIdx.x] = v;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if ((int)threadIdx.x < w) {
      su[threadIdx.x] += su[threadIdx.x + w];
      sv[threadIdx.x] += sv[threadIdx.x + w];
    }
    __syncthreads();
  }
  u = su[0];
  v = sv[0];
  __syncthreads();
}

// Writes the band's ndu / ndv and, with sums, its partial change sums.
__device__ void epilogue(const KernelArgs& a, const Band& d) {
  const int H = a.s.H, W = a.s.W;
  const size_t off = d.b * (size_t)H * W;
  float au = 0.f, av = 0.f;
  for (int idx = threadIdx.x; idx < d.rows * W; idx += blockDim.x) {
    const int lr = idx / W, j = idx % W, i = d.i0 + lr;
    const int o = at(lr, (i + j + d.par) & 1, j >> 1, a.hwp);
    const size_t q = off + (size_t)i * W + j;
    const float u = d.du[o], v = d.dv[o];
    a.ndu[q] = u;
    a.ndv[q] = v;
    if (i < d.lo || i >= d.hi) continue;
    au += fabsf(u - (a.du0 ? a.du0[q] : 0.f));
    av += fabsf(v - (a.du0 ? a.dv0[q] : 0.f));
  }
  if (!a.sums) return;
  block_sum(au, av);
  if (threadIdx.x == 0) {
    a.partials[2 * d.id] = au;
    a.partials[2 * d.id + 1] = av;
  }
}

template <bool K5, bool ROWS>
__global__ void __launch_bounds__(NT, 1) solve_kernel(KernelArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int H = a.s.H, W = a.s.W, tid = threadIdx.x;
  const int nbands = a.B * a.bpj;
  auto band = [&](int id) {
    return band_at(a, id, ROWS ? a.regions + id * a.region : smem, H);
  };
  unsigned loaded = 0;  // row-streamed: ring items of the block so far
  if (ROWS && tid == 0) {
    auto* bars = reinterpret_cast<unsigned long long*>(
        smem + RING_OWN * OWN_ARRAYS * a.kc + RING_NBR * NbrRow(a.kc).floats);
    for (int r = 0; r < RING_NBR; ++r) bar_init(bars + r);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every exchange cell carries epoch 0 before any band polls
  const size_t cells = (size_t)nbands * 4 * a.hwp;
  for (size_t i = (size_t)blockIdx.x * NT + tid; i < cells;
       i += (size_t)gridDim.x * NT)
    a.xch[i] = make_uint4(0u, 0u, 0u, 0u);

  for (int g = 0; g < a.groups; ++g) {
    // group g's jets [g B / groups, (g + 1) B / groups): sizes within one
    const int first = g * a.B / a.groups * a.bpj + blockIdx.x;
    const int end = (g + 1) * a.B / a.groups * a.bpj;
    for (int id = first; id < end; id += gridDim.x) prologue<K5>(a, band(id));
    if (g == 0) grid.sync();

    for (int t = 0; t < 2 * a.iterations; ++t) {
      const int c = t & 1;
      for (int id = first; id < end; id += gridDim.x) {
        const Band d = band(id);
        if (t > 0) {  // the neighbours' colour c ^ 1 of half-sweep t - 1
          fetch_halo(a, d, c ^ 1, (unsigned)t, tid, NT);
          __syncthreads();
        }
        if (ROWS) {
          ring_half_sweep(a, d, c, (unsigned)t + 1, smem, loaded);
          continue;
        }
        // first and last row, published, then the interior
        const int edges = d.rows > 1 ? 2 : 1;
        half_sweep(d, W, a.hwp, c, a.omega, 0, edges, d.rows - 1, tid, NT);
        __syncthreads();
        publish(a, d, c, (unsigned)t + 1);
        half_sweep(d, W, a.hwp, c, a.omega, 1, d.rows - 2, 1, tid, NT);
        __syncthreads();
      }
    }

    for (int id = first; id < end; id += gridDim.x) {
      if (ROWS) __syncthreads();  // the last pass's stores, for every thread
      epilogue(a, band(id));
    }
  }
  if (!a.sums) return;
  grid.sync();
  if (blockIdx.x != 0) return;
  for (int b = threadIdx.x; b < a.B; b += blockDim.x) {
    float au = 0.f, av = 0.f;
    for (int k = 0; k < a.bpj; ++k) {
      au += __ldcg(a.partials + 2 * (b * a.bpj + k));
      av += __ldcg(a.partials + 2 * (b * a.bpj + k) + 1);
    }
    a.sums[2 * b] = au;
    a.sums[2 * b + 1] = av;
  }
}

enum Regime { RESIDENT = 0, GROUPED = 1, ROW_STREAMED = 2 };

// How a call is cut: into groups of `group` jets, each jet into bpj bands of
// at most `rows` rows, a block per band of a group (on chip), or a band's
// rows streamed through the ring in nch chunks of at most kc packed cells.
struct Plan {
  int regime, grid, nbands, bpj, rows, hwp, threads, group, groups, kc, nch;
  size_t smem, region, scratch;  // bytes, floats, floats
};

template <bool K5, bool ROWS>
void* kernel_of() {
  return (void*)solve_kernel<K5, ROWS>;
}

void* kernel_of(bool k5, bool rows) {
  return k5 ? (rows ? kernel_of<true, true>() : kernel_of<true, false>())
            : (rows ? kernel_of<false, true>() : kernel_of<false, false>());
}

// The card's limits that a plan needs, read once per device; the kernels'
// shared-memory limit is raised there too.
struct DeviceLimits {
  cudaError_t err;
  int nsm, optin;
};

// The current device's limits. Shards call from several host threads at
// once, so each device's entry is filled under its own std::call_once.
const DeviceLimits* device_limits() {
  static std::once_flag once[MAX_DEVICES];
  static DeviceLimits limits[MAX_DEVICES];
  static const DeviceLimits invalid{cudaErrorInvalidDevice, 0, 0};
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return &invalid;
  DeviceLimits* d = &limits[dev];
  std::call_once(once[dev], [d, dev] {
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&d->nsm, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&d->optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev))) {
      d->err = err;
      return;
    }
    // one block of NT threads must fit an SM beside the dynamic memory
    // the plans use: the ring's at its widest and any band that fits
    const int ring = ring_bytes(CHUNK);
    for (int k = 0; k < 4; ++k) {
      void* kern = kernel_of(k & 1, k & 2);
      int occ = 0;
      if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                      d->optin - STATIC_SMEM)) ||
          (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &occ, kern, NT, (k & 2) ? ring : d->optin - STATIC_SMEM))) {
        d->err = err;
        return;
      }
      if (occ < 1) {
        d->err = cudaErrorInvalidConfiguration;
        return;
      }
    }
    d->err = cudaSuccess;
  });
  return d;
}

// Bands per jet and rows per band when `slots` blocks hold g jets' bands.
void bands(int H, int slots, int g, int& bpj, int& rows) {
  bpj = std::min(H, std::max(1, slots / g));
  rows = (H + bpj - 1) / bpj;
}

cudaError_t make_plan(int B, int H, int W, Plan& p) {
  const DeviceLimits* d = device_limits();
  if (d->err != cudaSuccess) return d->err;
  p.hwp = (W + 1) / 2;
  p.threads = NT;
  const size_t limit = (size_t)(d->optin - STATIC_SMEM);
  // the most jets whose bands fit one block per SM (fewer jets, more and
  // shorter bands: the first that fits from the top is the largest)
  int gmax = 0;
  for (int g = std::min(B, d->nsm); g >= 1 && !gmax; --g) {
    bands(H, d->nsm, g, p.bpj, p.rows);
    if (region_floats(p.rows, p.hwp) * sizeof(float) <= limit) gmax = g;
  }
  if (gmax) {
    p.groups = (B + gmax - 1) / gmax;
    p.group = (B + p.groups - 1) / p.groups;
    bands(H, d->nsm, p.group, p.bpj, p.rows);
    p.regime = p.groups == 1 ? RESIDENT : GROUPED;
    p.grid = p.group * p.bpj;
    p.smem = region_floats(p.rows, p.hwp) * sizeof(float);
    p.region = 0;
    p.kc = p.nch = 0;
  } else {
    p.regime = ROW_STREAMED;
    p.group = B;
    p.groups = 1;
    bands(H, d->nsm, B, p.bpj, p.rows);
    p.grid = std::min(B * p.bpj, d->nsm);
    p.hwp = (p.hwp + 3) / 4 * 4;  // 16-byte rows for the ring's copies
    p.nch = (p.hwp + CHUNK - 1) / CHUNK;
    p.kc = ((p.hwp + p.nch - 1) / p.nch + 3) / 4 * 4;
    p.smem = ring_bytes(p.kc);
    p.region = region_floats(p.rows, p.hwp);
  }
  p.nbands = B * p.bpj;
  // exchange cells (4 floats each), row-streamed regions, partials
  p.scratch = (size_t)p.nbands * (16 * p.hwp + 2) + p.nbands * p.region;
  return cudaSuccess;
}

cudaError_t launch(bool k5, KernelArgs a, const Plan& p, float* scratch,
                   long long scratch_floats, cudaStream_t st) {
  if (scratch_floats < (long long)p.scratch) return cudaErrorInvalidValue;
  a.bpj = p.bpj;
  a.hwp = p.hwp;
  a.groups = p.groups;
  a.kc = p.kc;
  a.nch = p.nch;
  a.region = p.region;
  a.xch = reinterpret_cast<uint4*>(scratch);  // torch's 16-byte alignment
  a.regions = scratch + (size_t)p.nbands * 16 * p.hwp;
  a.partials = a.regions + p.nbands * p.region;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(kernel_of(k5, p.regime == ROW_STREAMED),
                                     dim3(p.grid), dim3(p.threads), args,
                                     p.smem, st);
}

}  // namespace

// The plan of a call at (B, H, W): out[0..11] = regime (0 resident, 1
// grouped, 2 row-streamed), grid, bands (B x bands per jet), bands per jet,
// rows per band (at most), shared bytes per block, scratch floats, threads
// per block, jets a group, groups, packed cells of a ring chunk and chunks
// (row-streamed; else 0). K1 and K5 share the plan. Returns a cudaError_t
// code.
extern "C" int sf_solve_plan(int B, int H, int W, long long* out) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(B, H, W, p);
  if (err != cudaSuccess) return (int)err;
  const long long v[12] = {p.regime, p.grid, p.nbands, p.bpj, p.rows,
                           (long long)p.smem, (long long)p.scratch, p.threads,
                           p.group, p.groups, p.kc, p.nch};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// K1: the whole solve step in one cooperative launch on `stream`. du / dv may
// be null (start from zero); sums may be null (no change sums); rows may be
// null (whole images; else the strip table above). scratch holds at least
// sf_solve_plan's scratch floats. Returns a cudaError_t code (0 = launched).
extern "C" int sf_solve_step(const float* uu, const float* vv,
                             const float* dpsis, const float* a11,
                             const float* a12, const float* a22,
                             const float* b1, const float* b2, const float* du,
                             const float* dv, float* ndu, float* ndv,
                             float* scratch, long long scratch_floats,
                             float* sums, const int* rows, int B, int H,
                             int W, int method,
                             int reg_fct, float reg_eps_sq, float reg_trunc,
                             float reg_trunc_val, float alpha, int iterations,
                             float omega, void* stream) {
  if (B < 1 || H < 1 || W < 1 || iterations < 0 || (du == nullptr) != (dv == nullptr))
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(B, H, W, p);
  if (err != cudaSuccess) return (int)err;
  KernelArgs a{};
  a.s = SolveArgs{uu, vv, dpsis, a11, a12, a22, b1, b2, H, W, method, alpha,
                  sf::Pen{reg_fct, reg_eps_sq, reg_trunc, reg_trunc_val}};
  a.du0 = du;
  a.dv0 = dv;
  a.ndu = ndu;
  a.ndv = ndv;
  a.sums = sums;
  a.rows = rows;
  a.B = B;
  a.iterations = iterations;
  a.omega = omega;
  return (int)launch(false, a, p, scratch, scratch_floats, (cudaStream_t)stream);
}

// K5: `iterations` red-black coupled SOR sweeps on a given system in one
// cooperative launch: the prologue zeroes wh's last column and wv's last row
// and forms the 2x2 inverse with the neighbour-weight sum in core/solver.py's
// order; the sweeps start from du / dv, which are read only, and end in
// ndu / ndv. Every plane is [B, H, W]; rows: the strip table (colours only)
// or null. scratch holds at least sf_solve_plan's scratch floats.
// Returns a cudaError_t code (0 = launched).
extern "C" int sf_sor_coupled_rb(const float* du, const float* dv,
                                 const float* a11, const float* a12,
                                 const float* a22, const float* b1,
                                 const float* b2, const float* wh,
                                 const float* wv, float* ndu, float* ndv,
                                 float* scratch, long long scratch_floats,
                                 const int* rows, int B, int H, int W,
                                 int iterations,
                                 float omega, void* stream) {
  if (B < 1 || H < 1 || W < 1 || iterations < 0 || !du || !dv)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(B, H, W, p);
  if (err != cudaSuccess) return (int)err;
  KernelArgs a{};
  a.s.a11 = a11;
  a.s.a12 = a12;
  a.s.a22 = a22;
  a.s.b1 = b1;
  a.s.b2 = b2;
  a.s.H = H;
  a.s.W = W;
  a.wh_in = wh;
  a.wv_in = wv;
  a.du0 = du;
  a.dv0 = dv;
  a.ndu = ndu;
  a.ndv = ndv;
  a.rows = rows;
  a.B = B;
  a.iterations = iterations;
  a.omega = omega;
  return (int)launch(true, a, p, scratch, scratch_floats, (cudaStream_t)stream);
}
