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
// loads a cell).
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
// Where the bands of B x H x W do not fit the blocks' shared memory
// ("streaming", e.g. B = 16 at 270 x 480), the same kernel keeps each band's
// packed arrays in a global scratch region instead (read through L1 / L2),
// and a block may own several bands. Resident blocks have 512 threads,
// streaming ones 1024 (more loads in flight).
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

constexpr int NT_RESIDENT = 512, NT_STREAMING = 1024;  // threads per block
constexpr int FETCH_BATCH = 2;     // exchange loads in flight per thread
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
  uint4* xch;                          // [nbands][edge][colour][hwp]
  float* partials;                     // [nbands][2]
  float* regions;                      // streaming: [nbands][region]
  int B, nbands, bpj, hwp, iterations;
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
  // exchange cells of this band carry epoch 0 until the first half-sweep
  for (int idx = threadIdx.x; idx < 4 * hwp; idx += blockDim.x)
    a.xch[(size_t)d.id * 4 * hwp + idx] = make_uint4(0u, 0u, 0u, 0u);
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
    const float w_n = d.wv[no], w_w = hw ? d.wh[x + k - 1 + off] : 0.f;
    const float w_s = d.wv[o], w_e = d.wh[o];
    const float un = d.du[no], vn = d.dv[no];
    const float uw = hw ? d.du[x + k - 1 + off] : 0.f;
    const float vw = hw ? d.dv[x + k - 1 + off] : 0.f;
    const float us = d.du[so], vs = d.dv[so];
    const float ue = he ? d.du[x + k + off] : 0.f;
    const float ve = he ? d.dv[x + k + off] : 0.f;
    const float su = w_n * un + w_w * uw + w_s * us + w_e * ue;
    const float sv = w_n * vn + w_w * vw + w_s * vs + w_e * ve;
    const float B1 = d.r1[o] + su, B2 = d.r2[o] + sv;
    const float i12 = d.i12[o];
    const float nu = d.i11[o] * B1 + i12 * B2;
    const float nv = i12 * B1 + d.i22[o] * B2;
    d.du[o] = (1.f - omega) * d.du[o] + omega * nu;
    d.dv[o] = (1.f - omega) * d.dv[o] + omega * nv;
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

// Fixed-order block sum of (u, v) (blockDim.x a power of 2).
__device__ void block_sum(float& u, float& v) {
  __shared__ float su[NT_STREAMING], sv[NT_STREAMING];
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

template <bool K5, bool RESIDENT>
__global__ void __launch_bounds__(RESIDENT ? NT_RESIDENT : NT_STREAMING, 1)
    solve_kernel(KernelArgs a) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  const int H = a.s.H, W = a.s.W, tid = threadIdx.x, nt = blockDim.x;
  auto band = [&](int id) {
    return band_at(a, id, RESIDENT ? smem : a.regions + id * a.region, H);
  };
  for (int id = blockIdx.x; id < a.nbands; id += gridDim.x)
    prologue<K5>(a, band(id));
  grid.sync();  // every exchange cell holds epoch 0 before any band polls

  for (int t = 0; t < 2 * a.iterations; ++t) {
    const int c = t & 1;
    for (int id = blockIdx.x; id < a.nbands; id += gridDim.x) {
      const Band d = band(id);
      if (t > 0) {  // the neighbours' colour c ^ 1 of half-sweep t - 1
        fetch_halo(a, d, c ^ 1, (unsigned)t, tid, nt);
        __syncthreads();
      }
      // first and last row, published, then the interior
      const int edges = d.rows > 1 ? 2 : 1;
      half_sweep(d, W, a.hwp, c, a.omega, 0, edges, d.rows - 1, tid, nt);
      __syncthreads();
      publish(a, d, c, (unsigned)t + 1);
      half_sweep(d, W, a.hwp, c, a.omega, 1, d.rows - 2, 1, tid, nt);
      __syncthreads();
    }
  }

  for (int id = blockIdx.x; id < a.nbands; id += gridDim.x) epilogue(a, band(id));
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

// How a call is cut into bands: resident (one band per block, in shared
// memory) where B x H x W fits the card's blocks, streaming otherwise.
struct Plan {
  int resident, grid, nbands, bpj, rows, hwp, threads;
  int smem_limit;                // the resident kernel's shared-memory limit
  size_t smem, region, scratch;  // bytes, floats, floats
};

template <bool K5, bool RESIDENT>
void* kernel_of() {
  return (void*)solve_kernel<K5, RESIDENT>;
}

// The card's limits that a plan needs, read once per device.
struct DeviceLimits {
  cudaError_t err;
  int nsm, optin, occ_stream[2];  // SMs, opt-in shared bytes, streaming blocks/SM
};

// The current device's limits. Shards call from several host threads at
// once, so each device's entry is filled under its own std::call_once.
const DeviceLimits* device_limits() {
  static std::once_flag once[MAX_DEVICES];
  static DeviceLimits limits[MAX_DEVICES];
  static const DeviceLimits invalid{cudaErrorInvalidDevice, 0, 0, {0, 0}};
  int dev;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= MAX_DEVICES)
    return &invalid;
  DeviceLimits* d = &limits[dev];
  std::call_once(once[dev], [d, dev] {
    cudaError_t err;
    if ((err = cudaDeviceGetAttribute(&d->nsm, cudaDevAttrMultiProcessorCount, dev)) ||
        (err = cudaDeviceGetAttribute(&d->optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                      dev)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &d->occ_stream[0], solve_kernel<false, false>, NT_STREAMING, 0)) ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &d->occ_stream[1], solve_kernel<true, false>, NT_STREAMING, 0)))
      d->err = err;
    else
      d->err = cudaSuccess;
  });
  return d;
}

cudaError_t make_plan(bool k5, int B, int H, int W, Plan& p) {
  const DeviceLimits* d = device_limits();
  if (d->err != cudaSuccess) return d->err;
  p.hwp = (W + 1) / 2;
  const int static_smem = 2 * NT_STREAMING * (int)sizeof(float);
  p.smem_limit = d->optin - static_smem;
  // resident: one band per block, one block per SM
  int bpj = std::min(H, std::max(1, d->nsm / B));
  int rows = (H + bpj - 1) / bpj;
  p.smem = region_floats(rows, p.hwp) * sizeof(float);
  p.resident = B * bpj <= d->nsm && p.smem <= (size_t)p.smem_limit;
  p.threads = p.resident ? NT_RESIDENT : NT_STREAMING;
  if (p.resident) {
    p.nbands = p.grid = B * bpj;
    p.region = 0;
  } else {
    const int slots = d->occ_stream[k5] * d->nsm;
    if (slots < 1) return cudaErrorInvalidConfiguration;
    bpj = std::min(H, std::max(1, slots / B));
    rows = (H + bpj - 1) / bpj;
    p.nbands = B * bpj;
    p.grid = std::min(p.nbands, slots);
    p.smem = 0;
    p.region = region_floats(rows, p.hwp);
  }
  p.bpj = bpj;
  p.rows = rows;
  // exchange cells (4 floats each), partials, streaming regions
  p.scratch = (size_t)p.nbands * (16 * p.hwp + 2) + p.nbands * p.region;
  return cudaSuccess;
}

cudaError_t launch(bool k5, KernelArgs a, const Plan& p, float* scratch,
                   long long scratch_floats, cudaStream_t st) {
  if (scratch_floats < (long long)p.scratch) return cudaErrorInvalidValue;
  a.nbands = p.nbands;
  a.bpj = p.bpj;
  a.hwp = p.hwp;
  a.region = p.region;
  a.xch = reinterpret_cast<uint4*>(scratch);  // torch's 16-byte alignment
  a.partials = scratch + (size_t)p.nbands * 16 * p.hwp;
  a.regions = a.partials + 2 * (size_t)p.nbands;
  void* kern = k5 ? (p.resident ? kernel_of<true, true>() : kernel_of<true, false>())
                  : (p.resident ? kernel_of<false, true>() : kernel_of<false, false>());
  if (p.resident) {
    // raise the resident kernel's shared-memory limit once per device (the
    // plan came from device_limits, so the device index is valid)
    static std::once_flag once[2][MAX_DEVICES];
    static cudaError_t raised[2][MAX_DEVICES];
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    std::call_once(once[k5][dev], [&] {
      raised[k5][dev] = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem_limit);
    });
    if (raised[k5][dev] != cudaSuccess) return raised[k5][dev];
  }
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(kern, dim3(p.grid), dim3(p.threads), args,
                                     p.smem, st);
}

}  // namespace

// The plan of a call at (B, H, W): out[0..7] = resident, grid, nbands, bands
// per jet, rows per band (at most), shared bytes per block, scratch floats,
// threads per block. k5 selects K5's kernel. Returns a cudaError_t code.
extern "C" int sf_solve_plan(int k5, int B, int H, int W, long long* out) {
  if (B < 1 || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = make_plan(k5 != 0, B, H, W, p);
  if (err != cudaSuccess) return (int)err;
  const long long v[8] = {p.resident, p.grid, p.nbands, p.bpj, p.rows,
                          (long long)p.smem, (long long)p.scratch, p.threads};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
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
  cudaError_t err = make_plan(false, B, H, W, p);
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
// or null. scratch holds at least sf_solve_plan's scratch floats (k5 = 1).
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
  cudaError_t err = make_plan(true, B, H, W, p);
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
