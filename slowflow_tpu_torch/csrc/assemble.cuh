// IRLS data-term assembly of one output tile, shared by K2
// (warp_assemble.cu, which warps the window into shared memory first) and
// K3 (fused_data.cu, which copies an already-warped window). Device-code
// counterpart of slowflow_tpu/variational/fused_data.py
// `assemble_from_windows`.
//
// The caller fills `frames` ([F][3][LH][LW] floats of shared memory: the
// tile plus an EXT-pixel halo of every window frame, halo pixels outside the
// image holding the value at the clamped image pixel, i.e. the edge
// replication of each warped plane) and calls `assemble_tile` from every
// thread of its TW x TH block. Per offset and pair, the block writes Ix (rows
// and cols +-2) and Iy (rows +-2) to shared scratch; each thread then forms
// its own Ixx/Ixy/Iyy/Ixz/Iyz from them. Ixx and Iyy clamp their taps on the
// DERIVATIVE plane at the image edge (clamped global index), as
// conv_horiz(ix) / conv_vert(iy) do in the reference; Ixy and the
// z-derivatives need no clamp because the halo rows/cols are replicas.
//   mode 0 "assembly"     -> a11, a12, a22, b1, b2
//   mode 1 "occ"          -> e0, e1 (occlusion data costs)
//   mode 2 "occ_assembly" -> e0, e1, 5 past-offset planes, 5 future ones
// ZERO_DUV promises du == dv == 0 and drops the linearization terms. The
// per-offset mask value comes from the caller's `mask_of(s)`.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace sf {

constexpr int TW = 32, TH = 16, EXT = 4, NT = TW * TH;
constexpr int LW = TW + 2 * EXT, LH = TH + 2 * EXT;  // frame tile 40 x 24
constexpr int XW = TW + 4, XH = TH + 4;              // Ix tile 36 x 20
constexpr int YW = TW, YH = TH + 4;                  // Iy tile 32 x 20
constexpr int MAXN = 8;                              // offsets, S <= 5
constexpr int N_HEAD = 15, N_ARR = 14;
constexpr int N_PARAMS = N_HEAD + N_ARR * MAXN;
constexpr float DATANORM = (float)(0.1 * 0.1);
constexpr float DT_SCALE = (float)0.01;
// DERIV_5PT = [1/12, -8/12, 0, 8/12, -1/12] in float32
constexpr float C0 = (float)(1.0 / 12.0), C1 = -(float)(8.0 / 12.0);
constexpr float C3 = (float)(8.0 / 12.0), C4 = -(float)(1.0 / 12.0);

enum { MODE_ASSEMBLY = 0, MODE_OCC = 1, MODE_OCC_ASSEMBLY = 2 };

struct AsmParams {
  int ref, delta_on, gamma_on, norm, one_direction;
  Pen color, grad;
  float data_norm, occ_penalty;
  // per offset s: data-term weights f32(rho_w[s]) * f32(delta/3) etc.
  float wd_s[MAXN], wg_s[MAXN], wd_r[MAXN], wg_r[MAXN];
  // term enabled: assembly tests the direction-zeroed weights, occ the raw
  float on_asm_s[MAXN], on_asm_r[MAXN], on_raw_s[MAXN], on_raw_r[MAXN];
  float fac[MAXN];                                 // to-reference factor
  float od_s[MAXN], og_s[MAXN], od_r[MAXN], og_r[MAXN];  // occ-cost weights
  float contrib[MAXN];                             // 2 rho + 2 omega (raw)
};

// Shared memory of one block: frame tiles, then the Ix and Iy tiles.
inline size_t tile_smem_bytes(int F) {
  return sizeof(float) * (F * 3 * LH * LW + 3 * XH * XW + 3 * YH * YW);
}

// Unpacks the N_PARAMS host floats laid out by
// slowflow_tpu_torch/variational/fused_data.py `kernel_params`.
inline bool parse_params(const float* h, int n_params, AsmParams& P) {
  if (n_params != N_PARAMS) return false;
  P.ref = (int)h[0];
  P.delta_on = (int)h[1];
  P.gamma_on = (int)h[2];
  P.norm = (int)h[3];
  P.one_direction = (int)h[4];
  P.color = Pen{(int)h[5], h[6], h[7], h[8]};
  P.grad = Pen{(int)h[9], h[10], h[11], h[12]};
  P.data_norm = h[13];
  P.occ_penalty = h[14];
  if (P.ref < 1 || 2 * P.ref > MAXN) return false;
  float* arrs[N_ARR] = {P.wd_s, P.wg_s, P.wd_r, P.wg_r, P.on_asm_s,
                        P.on_asm_r, P.on_raw_s, P.on_raw_r, P.fac, P.od_s,
                        P.og_s, P.od_r, P.og_r, P.contrib};
  for (int a = 0; a < N_ARR; ++a)
    for (int s = 0; s < MAXN; ++s) arrs[a][s] = h[N_HEAD + a * MAXN + s];
  return true;
}

// Calls fn(std::integral_constant<int, MODE>, std::bool_constant<ZERO_DUV>)
// for the supported (mode, zero_duv) pairs.
template <class Fn>
cudaError_t dispatch_mode(int mode, int zero_duv, Fn&& fn) {
  using A = std::integral_constant<int, MODE_ASSEMBLY>;
  using O = std::integral_constant<int, MODE_OCC>;
  using OA = std::integral_constant<int, MODE_OCC_ASSEMBLY>;
  if (mode == MODE_ASSEMBLY) {
    return zero_duv ? fn(A{}, std::true_type{}) : fn(A{}, std::false_type{});
  }
  if (mode == MODE_OCC) {
    return zero_duv ? fn(O{}, std::true_type{}) : fn(O{}, std::false_type{});
  }
  if (mode == MODE_OCC_ASSEMBLY && zero_duv) return fn(OA{}, std::true_type{});
  return cudaErrorInvalidValue;  // occ_assembly needs zero_duv
}

// Resident blocks per SM, registers per thread and local (spill) bytes per
// thread of an assembly kernel at `smem` bytes of dynamic shared memory.
template <class Kern>
cudaError_t kernel_occupancy(Kern kern, size_t smem, int* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  if ((err = cudaFuncGetAttributes(&fa, kern)) != cudaSuccess) return err;
  out[1] = fa.numRegs;
  out[2] = (int)fa.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kern, NT,
                                                       smem);
}

__device__ __forceinline__ float d5(float a, float b, float c, float d) {
  // taps at -2, -1, +1, +2 summed in the reference's order
  return ((C0 * a + C1 * b) + C3 * c) + C4 * d;
}

// Assembly of one pair's data terms into acc[5] = a11, a12, a22, b1, b2.
// d[c][0..7] = ix, iy, iz, ixx, ixy, iyy, ixz, iyz of channel c.
template <bool ZERO_DUV>
__device__ __forceinline__ void assemble_succ(
    const AsmParams& P, int s, float m, const float (&d)[3][8],
    const float (&cwv)[3], float du, float dv, float (&acc)[5]) {
  if (P.delta_on) {
    float rn[3], arg = 0.f;  // reciprocal of each channel's normalization
    for (int c = 0; c < 3; ++c) {
      const float ix = d[c][0], iy = d[c][1], iz = d[c][2];
      const float t = ZERO_DUV ? cwv[c] * iz : cwv[c] * (iz - ix * du - iy * dv);
      rn[c] = P.norm ? 1.f / (ix * ix + iy * iy + DATANORM) : 1.f;
      arg += t * t * rn[c];
    }
    const float wgt = m * P.wd_s[s] * pen_deriv(P.color, arg);
    for (int c = 0; c < 3; ++c) {
      const float ix = d[c][0], iy = d[c][1], iz = d[c][2];
      const float coef = wgt * cwv[c] * rn[c];
      acc[0] += coef * ix * ix;
      acc[1] += coef * ix * iy;
      acc[2] += coef * iy * iy;
      acc[3] += coef * iz * ix;
      acc[4] += coef * iz * iy;
    }
  }
  if (P.gamma_on) {
    float r1[3], r2[3], arg = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float ixx = d[c][3], ixy = d[c][4], iyy = d[c][5];
      const float ixz = d[c][6], iyz = d[c][7];
      const float t1 = ZERO_DUV ? cwv[c] * ixz : cwv[c] * (ixz - ixx * du - ixy * dv);
      const float t2 = ZERO_DUV ? cwv[c] * iyz : cwv[c] * (iyz - ixy * du - iyy * dv);
      r1[c] = P.norm ? 1.f / (ixx * ixx + ixy * ixy + DATANORM) : 1.f;
      r2[c] = P.norm ? 1.f / (iyy * iyy + ixy * ixy + DATANORM) : 1.f;
      arg += t1 * t1 * r1[c] + t2 * t2 * r2[c];
    }
    const float wgt = m * P.wg_s[s] * pen_deriv(P.grad, arg);
    for (int c = 0; c < 3; ++c) {
      const float ixx = d[c][3], ixy = d[c][4], iyy = d[c][5];
      const float ixz = d[c][6], iyz = d[c][7];
      const float c1 = wgt * cwv[c] * r1[c], c2 = wgt * cwv[c] * r2[c];
      acc[0] += c1 * ixx * ixx + c2 * ixy * ixy;
      acc[1] += c1 * ixx * ixy + c2 * ixy * iyy;
      acc[2] += c2 * iyy * iyy + c1 * ixy * ixy;
      acc[3] += c1 * ixx * ixz + c2 * ixy * iyz;
      acc[4] += c2 * iyy * iyz + c1 * ixy * ixz;
    }
  }
}

template <bool ZERO_DUV>
__device__ __forceinline__ void assemble_ref(
    const AsmParams& P, int s, float m, const float (&d)[3][8],
    const float (&cwv)[3], float du, float dv, float (&acc)[5]) {
  const float fac = P.fac[s], facsq = fac * fac;
  if (P.delta_on) {
    float rn[3], arg = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float ix = d[c][0], iy = d[c][1], iz = d[c][2];
      const float t = ZERO_DUV ? cwv[c] * iz
                               : cwv[c] * (iz + ix * fac * du + iy * fac * dv);
      rn[c] = 1.f / (P.norm ? facsq * (ix * ix + iy * iy) + DATANORM : facsq);
      arg += t * t * rn[c];
    }
    const float wgt = m * P.wd_r[s] * pen_deriv(P.color, arg);
    for (int c = 0; c < 3; ++c) {
      const float ix = d[c][0], iy = d[c][1], iz = d[c][2];
      const float coef = wgt * cwv[c] * rn[c];
      acc[3] -= coef * fac * iz * ix;
      acc[4] -= coef * fac * iz * iy;
      acc[0] += coef * facsq * ix * ix;
      acc[1] += coef * facsq * ix * iy;
      acc[2] += coef * facsq * iy * iy;
    }
  }
  if (P.gamma_on) {
    float r1[3], r2[3], arg = 0.f;
    for (int c = 0; c < 3; ++c) {
      const float ixx = d[c][3], ixy = d[c][4], iyy = d[c][5];
      const float ixz = d[c][6], iyz = d[c][7];
      const float t1 = ZERO_DUV ? cwv[c] * ixz
                                : cwv[c] * (ixz + ixx * fac * du + ixy * fac * dv);
      const float t2 = ZERO_DUV ? cwv[c] * iyz
                                : cwv[c] * (iyz + ixy * fac * du + iyy * fac * dv);
      r1[c] = 1.f / (P.norm ? facsq * (ixx * ixx + ixy * ixy) + DATANORM : facsq);
      r2[c] = 1.f / (P.norm ? facsq * (iyy * iyy + ixy * ixy) + DATANORM : facsq);
      arg += t1 * t1 * r1[c] + t2 * t2 * r2[c];
    }
    const float wgt = m * P.wg_r[s] * pen_deriv(P.grad, arg);
    for (int c = 0; c < 3; ++c) {
      const float ixx = d[c][3], ixy = d[c][4], iyy = d[c][5];
      const float ixz = d[c][6], iyz = d[c][7];
      const float c1 = wgt * cwv[c] * r1[c], c2 = wgt * cwv[c] * r2[c];
      acc[3] -= c1 * fac * ixx * ixz + c2 * fac * ixy * iyz;
      acc[4] -= c2 * fac * iyy * iyz + c1 * fac * ixy * ixz;
      acc[0] += c1 * facsq * ixx * ixx + c2 * facsq * ixy * ixy;
      acc[1] += c1 * facsq * ixx * ixy + c2 * facsq * ixy * iyy;
      acc[2] += c2 * facsq * iyy * iyy + c1 * facsq * ixy * ixy;
    }
  }
}

// Derivatives, assembly and output of the block's tile (origin x0, y0) of
// jet b. frames: the filled frame tiles; sx / sy: shared scratch of
// 3 * XH * XW and 3 * YH * YW floats. mask_of(s) gives the mask value of
// offset s at this thread's pixel (clamped to the image when the thread
// lies outside it). out: [n_out, B, H, W].
template <int MODE, bool ZERO_DUV, class MaskFn>
__device__ __forceinline__ void assemble_tile(
    const AsmParams& P, const float* frames, float* sx, float* sy,
    const float* __restrict__ cw, const float* __restrict__ du,
    const float* __restrict__ dv, float* __restrict__ out, int b, int B,
    int H, int W, int x0, int y0, MaskFn mask_of) {
  const int ref = P.ref, N = 2 * ref;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t HW = (size_t)H * W;
  const int ox = threadIdx.x, oy = threadIdx.y;
  const int gx = x0 + ox, gy = y0 + oy;
  const bool live = gx < W && gy < H;
  const size_t pp = (size_t)min(gy, H - 1) * W + min(gx, W - 1);
  float cwv[3];
  for (int c = 0; c < 3; ++c) cwv[c] = cw[(size_t)(b * 3 + c) * HW + pp];
  const float duv = ZERO_DUV ? 0.f : du[b * HW + pp];
  const float dvv = ZERO_DUV ? 0.f : dv[b * HW + pp];
  // clamped tap positions (local Ix / Iy tile coordinates) for Ixx / Iyy
  auto cx = [&](int t) { return clampi(gx + t - 2, 0, W - 1) - x0 + 2; };
  auto cy = [&](int t) { return clampi(gy + t - 2, 0, H - 1) - y0 + 2; };

  float acc[2][5] = {};
  float e0 = 0.f, e1 = 0.f, n0 = 0.f, n1 = 0.f;

  for (int s = 0; s < N; ++s) {
    const float m = mask_of(s);
    float term = 0.f;
    float(&a)[5] = acc[(MODE == MODE_OCC_ASSEMBLY && s >= ref) ? 1 : 0];

    for (int pair = 0; pair < 2; ++pair) {
      const bool on = MODE == MODE_ASSEMBLY
          ? (pair ? P.on_asm_r[s] : P.on_asm_s[s]) != 0.f
          : (pair ? P.on_raw_r[s] : P.on_raw_s[s]) != 0.f;
      if (!on) continue;  // uniform across the block
      const int ka = pair ? (s < ref ? s : ref) : s;
      const int kb = pair ? (s < ref ? ref : s + 1) : s + 1;
      const float* fa = frames + (size_t)ka * 3 * LH * LW;
      const float* fb = frames + (size_t)kb * 3 * LH * LW;

      if (MODE != MODE_OCC) {
        __syncthreads();  // previous pair's readers are done with sx / sy
        for (int idx = tid; idx < 3 * XH * XW; idx += NT) {
          const int c = idx / (XH * XW), r = idx % (XH * XW);
          const int ly = r / XW + 2, lx = r % XW + 2;
          const float* A = fa + c * LH * LW + ly * LW;
          const float* Bp = fb + c * LH * LW + ly * LW;
          sx[idx] = d5(0.5f * (A[lx - 2] + Bp[lx - 2]), 0.5f * (A[lx - 1] + Bp[lx - 1]),
                       0.5f * (A[lx + 1] + Bp[lx + 1]), 0.5f * (A[lx + 2] + Bp[lx + 2]));
        }
        for (int idx = tid; idx < 3 * YH * YW; idx += NT) {
          const int c = idx / (YH * YW), r = idx % (YH * YW);
          const int ly = r / YW + 2, lx = r % YW + EXT;
          const float* A = fa + c * LH * LW + lx;
          const float* Bp = fb + c * LH * LW + lx;
          sy[idx] = d5(0.5f * (A[(ly - 2) * LW] + Bp[(ly - 2) * LW]),
                       0.5f * (A[(ly - 1) * LW] + Bp[(ly - 1) * LW]),
                       0.5f * (A[(ly + 1) * LW] + Bp[(ly + 1) * LW]),
                       0.5f * (A[(ly + 2) * LW] + Bp[(ly + 2) * LW]));
        }
        __syncthreads();
      }
      if (!live) continue;

      float d[3][8];
      for (int c = 0; c < 3; ++c) {
        const float* A = fa + c * LH * LW;
        const float* Bp = fb + c * LH * LW;
        auto izf = [&](int ry, int rx) {
          const int l = (ry + EXT) * LW + rx + EXT;
          return A[l] - Bp[l];
        };
        d[c][2] = izf(oy, ox);
        d[c][6] = d5(izf(oy, ox - 2), izf(oy, ox - 1), izf(oy, ox + 1), izf(oy, ox + 2));
        d[c][7] = d5(izf(oy - 2, ox), izf(oy - 1, ox), izf(oy + 1, ox), izf(oy + 2, ox));
        if (MODE != MODE_OCC) {
          const float* X = sx + c * XH * XW;
          const float* Y = sy + c * YH * YW;
          const float* xrow = X + (oy + 2) * XW;
          d[c][0] = xrow[ox + 2];
          d[c][1] = Y[(oy + 2) * YW + ox];
          d[c][3] = d5(xrow[cx(0)], xrow[cx(1)], xrow[cx(3)], xrow[cx(4)]);
          d[c][4] = d5(X[oy * XW + ox + 2], X[(oy + 1) * XW + ox + 2],
                       X[(oy + 3) * XW + ox + 2], X[(oy + 4) * XW + ox + 2]);
          d[c][5] = d5(Y[cy(0) * YW + ox], Y[cy(1) * YW + ox],
                       Y[cy(3) * YW + ox], Y[cy(4) * YW + ox]);
        }
      }

      if (MODE != MODE_ASSEMBLY) {  // occlusion data cost of this pair
        float iz2 = 0.f, gz2 = 0.f;
        for (int c = 0; c < 3; ++c) {
          iz2 += d[c][2] * d[c][2];
          gz2 += d[c][6] * d[c][6] + d[c][7] * d[c][7];
        }
        const float wdc = pair ? P.od_r[s] : P.od_s[s];
        const float wgc = pair ? P.og_r[s] : P.og_s[s];
        term = term + wdc * m * pen_apply(P.color, iz2)
                    + wgc * m * pen_apply(P.grad, gz2);
      }
      if (MODE != MODE_OCC) {
        if (pair) assemble_ref<ZERO_DUV>(P, s, m, d, cwv, duv, dvv, a);
        else assemble_succ<ZERO_DUV>(P, s, m, d, cwv, duv, dvv, a);
      }
    }
    if (MODE != MODE_ASSEMBLY) {
      const float contrib = m * P.contrib[s];
      if (s >= ref) { e0 += term; n0 += contrib; }  // future scores label 0
      else { e1 += term; n1 += contrib; }
    }
  }

  if (!live) return;
  const size_t o = (size_t)b * HW + (size_t)gy * W + gx;
  const size_t plane = (size_t)B * HW;
  int k = 0;
  if (MODE != MODE_ASSEMBLY) {
    n0 = n0 == 0.f ? 1.f : n0;
    n1 = n1 == 0.f ? 1.f : n1;
    out[o] = DT_SCALE * e0 / n0;
    out[plane + o] = DT_SCALE * e1 / n1 + P.occ_penalty;
    k = 2;
  }
  if (MODE != MODE_OCC) {
    const int groups = MODE == MODE_OCC_ASSEMBLY ? 2 : 1;
    for (int g = 0; g < groups; ++g)
      for (int q = 0; q < 5; ++q) out[(k + 5 * g + q) * plane + o] = acc[g][q];
  }
}

}  // namespace sf
