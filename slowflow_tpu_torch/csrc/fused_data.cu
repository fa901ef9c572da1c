// K3: IRLS data-term assembly from an already-warped window.
//
// Replaces the TPU kernel slowflow_tpu/variational/fused_data.py `_kernel`
// (wrapper `fused_data_system_batched`). Plain PyTorch twin:
// variational/fused_data.py `fused_data_system_ref`.
//
// What it computes, per output pixel of jet b: K2's derivatives and
// assembly, from the warped window [B, F, 3, H, W] that K4 wrote and a given
// per-offset mask [B, N, H, W]: the gated mask in "assembly" mode, the raw
// warp mask in "occ" / "occ_assembly" mode. The per-pixel assembly math is
// assemble.cuh's `assemble_succ` / `assemble_ref`, shared with K2.
//
// What bounds it on an H100: arithmetic and shared-memory traffic. The
// window is read once per 32 x 16 tile plus a 4-pixel halo (1.875x), ~100
// B/pixel with the mask and the outputs: ~50 MB per call at 4 x 270 x 480,
// ~15 us at 3.35 TB/s, against ~2000 flops per pixel and offset group.
//
// Design: one block of 32 x 16 threads per output tile, blockIdx.z = jet,
// two blocks per SM. Unlike K2 it reads a plain rectangle of the stack, so
// the frames stream in by cp.async (16-byte copies where a row chunk lies
// inside the image and rows are 16-byte aligned; 4-byte copies of the
// clamped pixel at the image edge, which is the edge replication the
// reference's convolutions see), one frame ahead of the math: the frames
// are loaded in the order ref, 0, 1, ... (ref skipped); offset s needs
// frames s, s + 1 and ref, so it is assembled as soon as frame s + 1 is in,
// in K2's order of offsets, while the next frame is in flight. Only the
// reference and a ring of three frame slots are resident. Each offset's
// on pairs get their Ix / Iy tiles of the averaged frames in one pass and
// behind one barrier, with K2's arithmetic, so K3 rounds as K2 and the
// twin do (the average of per-frame derivatives would round elsewhere and
// sit far closer to the 1e-4 bound). A frame's arrival is one more
// barrier, and the next copy is issued right after it. 4 x 11.5 KB of
// frames and 2 x 16.3 KB of derivative tiles (78.7 KB) keep two blocks
// per SM. In "occ_assembly" the past offsets come first, so their system
// is stored before the future ones are summed and one group of sums stays
// in registers.
#include <cstdint>

#include "assemble.cuh"

using namespace sf;

namespace {

constexpr int FRAME_FLOATS = 3 * LH * LW;          // one frame tile + halo
constexpr int PAIR_FLOATS = 3 * XH * XW + 3 * YH * YW;  // a pair's Ix, Iy
constexpr int SLOTS = 4;  // the reference frame and a ring of three
constexpr int CHUNKS = LW / 4;  // 16-byte chunks per tile row
constexpr size_t SMEM_BYTES =
    sizeof(float) * (SLOTS * FRAME_FLOATS + 2 * PAIR_FLOATS);
static_assert(FRAME_FLOATS % 4 == 0 && LW % 4 == 0 && EXT % 4 == 0 &&
                  TW % 4 == 0,
              "frame slots and tile rows must stay 16-byte aligned");

// Starts the copy of one frame's tile + halo ([3][LH][LW], edge-clamped)
// from src ([3][H][W]) into dst as one cp.async group.
__device__ __forceinline__ void load_frame(float* dst,
                                           const float* __restrict__ src,
                                           int H, int W, int x0, int y0,
                                           bool vec, int tid) {
  const size_t HW = (size_t)H * W;
  for (int idx = tid; idx < 3 * LH * CHUNKS; idx += NT) {
    const int c = idx / (LH * CHUNKS), r = idx % (LH * CHUNKS);
    const int row = r / CHUNKS, q = r % CHUNKS;
    const int gx = x0 - EXT + 4 * q;
    const float* s = src + c * HW + (size_t)clampi(y0 - EXT + row, 0, H - 1) * W;
    float* d = dst + (c * LH + row) * LW + 4 * q;
    if (vec && gx >= 0 && gx + 4 <= W) {
      cp_async16(d, s + gx);
    } else {
      for (int e = 0; e < 4; ++e) cp_async4(d + e, s + clampi(gx + e, 0, W - 1));
    }
  }
  cp_async_commit();
}

// Ix (rows and cols +-2) and Iy (rows +-2) of the averaged frames a, b into
// buf ([3][XH][XW] then [3][YH][YW]), as K2 forms them (assemble.cuh).
__device__ __forceinline__ void build_pair(float* buf, const float* fa,
                                           const float* fb, int tid) {
  float* sx = buf;
  float* sy = buf + 3 * XH * XW;
  for (int idx = tid; idx < 3 * XH * XW; idx += NT) {
    const int c = idx / (XH * XW), r = idx % (XH * XW);
    const int l = (c * LH + r / XW + 2) * LW + r % XW + 2;
    const float* A = fa + l;
    const float* Bp = fb + l;
    sx[idx] = d5(0.5f * (A[-2] + Bp[-2]), 0.5f * (A[-1] + Bp[-1]),
                 0.5f * (A[1] + Bp[1]), 0.5f * (A[2] + Bp[2]));
  }
  for (int idx = tid; idx < 3 * YH * YW; idx += NT) {
    const int c = idx / (YH * YW), r = idx % (YH * YW);
    const int l = (c * LH + r / YW + 2) * LW + r % YW + EXT;
    const float* A = fa + l;
    const float* Bp = fb + l;
    sy[idx] = d5(0.5f * (A[-2 * LW] + Bp[-2 * LW]), 0.5f * (A[-LW] + Bp[-LW]),
                 0.5f * (A[LW] + Bp[LW]), 0.5f * (A[2 * LW] + Bp[2 * LW]));
  }
}

template <int MODE, bool ZERO_DUV>
__global__ void __launch_bounds__(NT, 2) fused_data_kernel(
    const float* __restrict__ warped, const float* __restrict__ mask,
    const float* __restrict__ du, const float* __restrict__ dv,
    const float* __restrict__ cw, float* __restrict__ out, int B, int H,
    int W, bool vec, AsmParams P) {
  extern __shared__ __align__(16) float smem[];
  float* pairs = smem + SLOTS * FRAME_FLOATS;  // 2 x [Ix, Iy] of a pair
  const int ref = P.ref, F = 2 * ref + 1, N = 2 * ref;
  const int b = blockIdx.z, x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int ox = threadIdx.x, oy = threadIdx.y, tid = oy * TW + ox;
  const int gx = x0 + ox, gy = y0 + oy;
  const bool live = gx < W && gy < H;
  const size_t HW = (size_t)H * W;
  const size_t pp = (size_t)min(gy, H - 1) * W + min(gx, W - 1);
  const float* win = warped + (size_t)b * F * 3 * HW;
  // the i-th frame loaded: the reference, then the others in order
  auto frame_at = [&](int i) { return i == 0 ? ref : (i <= ref ? i - 1 : i); };
  auto slot = [&](int k) {
    return smem + (k == ref ? 0 : 1 + (k < ref ? k : k - 1) % 3) * FRAME_FLOATS;
  };
  auto load = [&](int k) {
    load_frame(slot(k), win + (size_t)k * 3 * HW, H, W, x0, y0, vec, tid);
  };
  auto pair_on = [&](int s, int pair) {  // uniform across the block
    return MODE == MODE_ASSEMBLY
        ? (pair ? P.on_asm_r[s] : P.on_asm_s[s]) != 0.f
        : (pair ? P.on_raw_r[s] : P.on_raw_s[s]) != 0.f;
  };
  auto frame_a = [&](int s, int pair) { return pair ? (s < ref ? s : ref) : s; };
  auto frame_b = [&](int s, int pair) { return pair ? (s < ref ? ref : s + 1) : s + 1; };

  float cwv[3];
  for (int c = 0; c < 3; ++c) cwv[c] = cw[(size_t)(b * 3 + c) * HW + pp];
  const float duv = ZERO_DUV ? 0.f : du[b * HW + pp];
  const float dvv = ZERO_DUV ? 0.f : dv[b * HW + pp];
  // clamped tap positions (local Ix / Iy tile coordinates) for Ixx / Iyy
  auto cx = [&](int t) { return clampi(gx + t - 2, 0, W - 1) - x0 + 2; };
  auto cy = [&](int t) { return clampi(gy + t - 2, 0, H - 1) - y0 + 2; };
  const size_t o = (size_t)b * HW + pp, plane = (size_t)B * HW;
  float acc[5] = {};
  float e0 = 0.f, e1 = 0.f, n0 = 0.f, n1 = 0.f;

  // assembles offset s (pairs s -> s + 1 and s <-> ref) into acc / e0 / e1;
  // pairs + pair * PAIR_FLOATS holds the pair's Ix / Iy tiles
  auto offset = [&](int s) {
    const float m = mask[(size_t)(b * N + s) * HW + pp];
    float term = 0.f;
    for (int pair = 0; pair < 2; ++pair) {
      if (!pair_on(s, pair) || !live) continue;
      const float* fa = slot(frame_a(s, pair));
      const float* fb = slot(frame_b(s, pair));
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
          const float* X = pairs + pair * PAIR_FLOATS + c * XH * XW;
          const float* Y = pairs + pair * PAIR_FLOATS + 3 * XH * XW + c * YH * YW;
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
        if (pair) assemble_ref<ZERO_DUV>(P, s, m, d, cwv, duv, dvv, acc);
        else assemble_succ<ZERO_DUV>(P, s, m, d, cwv, duv, dvv, acc);
      }
    }
    if (MODE != MODE_ASSEMBLY) {
      const float contrib = m * P.contrib[s];
      if (s >= ref) { e0 += term; n0 += contrib; }  // future scores label 0
      else { e1 += term; n1 += contrib; }
    }
    if (MODE == MODE_OCC_ASSEMBLY && s == ref - 1) {  // the past system
      if (live)
        for (int q = 0; q < 5; ++q) out[(2 + q) * plane + o] = acc[q];
      for (int q = 0; q < 5; ++q) acc[q] = 0.f;
    }
  };

  load(ref);
  load(frame_at(1));
  for (int i = 0; i < F; ++i) {
    if (i == 0) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // frame i is in; every reader of older slots is done
    if (i >= 1 && i + 1 < F) load(frame_at(i + 1));  // into a free slot
    const int k = frame_at(i);
    if (k == ref) continue;
    // frame k completes offset k - 1, and offset ref - 1 when k = ref - 1
    const int last = k == ref - 1 ? k : k - 1;
    for (int s = max(k - 1, 0); s <= last; ++s) {
      if (MODE != MODE_OCC) {
        if (s > max(k - 1, 0)) __syncthreads();  // the last offset's readers
        for (int pair = 0; pair < 2; ++pair)
          if (pair_on(s, pair))
            build_pair(pairs + pair * PAIR_FLOATS, slot(frame_a(s, pair)),
                       slot(frame_b(s, pair)), tid);
        __syncthreads();
      }
      offset(s);
    }
  }

  if (!live) return;
  if (MODE != MODE_ASSEMBLY) {
    n0 = n0 == 0.f ? 1.f : n0;
    n1 = n1 == 0.f ? 1.f : n1;
    out[o] = DT_SCALE * e0 / n0;
    out[plane + o] = DT_SCALE * e1 / n1 + P.occ_penalty;
  }
  if (MODE != MODE_OCC) {
    const int k0 = MODE == MODE_OCC_ASSEMBLY ? 7 : 0;
    for (int q = 0; q < 5; ++q) out[(k0 + q) * plane + o] = acc[q];
  }
}

// Dynamic shared memory above 48 KB, and the largest shared-memory carveout,
// so that two blocks of SMEM_BYTES fit an SM.
template <class Kern>
cudaError_t prepare(Kern kern) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// warped [B, 2ref+1, 3, H, W], mask [B, 2ref, H, W], du / dv [B, H, W]
// (unused with zero_duv), cw [B, 3, H, W]; params: N_PARAMS host floats
// laid out by slowflow_tpu_torch/variational/fused_data.py `kernel_params`.
// out: [n_out, B, H, W]. Returns a cudaError_t code (0 = launched).
extern "C" int sf_fused_data(const float* warped, const float* mask,
                             const float* du, const float* dv,
                             const float* cw, float* out, int B, int H,
                             int W, int mode, int zero_duv,
                             const float* params, int n_params,
                             void* stream) {
  AsmParams P;
  if (!parse_params(params, n_params, P) || B > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(warped) % 16 == 0;
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B), block(TW, TH);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)dispatch_mode(mode, zero_duv, [&](auto m, auto z) {
    auto kern = fused_data_kernel<decltype(m)::value, decltype(z)::value>;
    cudaError_t err = prepare(kern);
    if (err != cudaSuccess) return err;
    kern<<<grid, block, SMEM_BYTES, st>>>(warped, mask, du, dv, cw, out, B, H,
                                          W, vec, P);
    return cudaGetLastError();
  });
}

// out[0..2] = resident blocks per SM, registers per thread, spill bytes per
// thread of the (mode, zero_duv) variant (its shared memory does not depend
// on the window size).
extern "C" int sf_fused_data_occupancy(int mode, int zero_duv, int ref, int* out) {
  if (ref < 1 || 2 * ref > MAXN) return (int)cudaErrorInvalidValue;
  return (int)dispatch_mode(mode, zero_duv, [&](auto m, auto z) {
    auto kern = fused_data_kernel<decltype(m)::value, decltype(z)::value>;
    cudaError_t err = prepare(kern);
    if (err != cudaSuccess) return err;
    return kernel_occupancy(kern, SMEM_BYTES, out);
  });
}
