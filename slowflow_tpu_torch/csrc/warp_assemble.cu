// K2: merged warp + IRLS data-term assembly for the multi-frame jet solve.
//
// Replaces the TPU kernel slowflow_tpu/variational/fused_warp.py
// `_merged_kernel` (with fused_data.assemble_from_windows), self-masking
// route. Plain PyTorch twin: variational/fused_warp.py `warp_assemble_ref`.
//
// What it computes, per output pixel of jet b: every non-reference window
// frame k is bilinearly warped by (k - ref) * flow (4 clamped corners), the
// successive (s -> s+1) and to-reference pairs of each offset s get 5-tap
// first and second derivatives, and the robust IRLS normal equations are
// summed over offsets:
//   mode 0 "assembly"     -> a11, a12, a22, b1, b2 (occlusion gate applied)
//   mode 1 "occ"          -> e0, e1 (occlusion data costs)
//   mode 2 "occ_assembly" -> e0, e1, 5 past-offset planes, 5 future ones
//                            (raw masks: the caller gates after the ICM step)
// ZERO_DUV promises du == dv == 0 and drops the linearization terms.
//
// What bounds it on an H100: arithmetic and shared-memory traffic, not HBM.
// Per pixel it reads F*3 source planes (gathered, 4 corners each) plus ~8
// planes of flow/occ/cw/du/dv and writes <= 12 planes: ~120 B/pixel, 62 MB
// per call at 4 x 270 x 480 -> ~20 us at 3.35 TB/s; the derivative and
// assembly math is ~2000 flops per pixel and offset group.
//
// Design: one block of 32 x 16 threads per output tile, blockIdx.z = jet,
// at most 64 registers a thread (42 in "occ" mode) so that two (three)
// blocks share an SM and one block's gather overlaps another's math. The load phase IS the warp:
// the block copies the reference frame's tile plus a 4-pixel halo into
// dynamic shared memory with cp.async (issued first, waited last), then for
// each halo-tile position reads the flow once and gathers the 4 clamped
// corners x 3 channels of every other window frame from it (5 frames x 3
// channels x 24 x 40 floats = 57.6 KB at S = 3). Halo pixels outside the
// image take the warped value at the clamped image pixel, which is the edge
// replication the reference applies to each warped plane. The derivatives and
// the assembly are assemble.cuh's `assemble_tile`, shared with K3
// (fused_data.cu); the mask of offset s is the warp-coordinate validity of its
// frame, times the occlusion gate in assembly mode. The tile stays 32 x 16
// (1.875x halo): a taller tile needs more threads or more state per thread,
// and either breaks the two-blocks-per-SM register budget.
// Strip windows (slowflow_tpu_torch/parallel/strips.py): with a table
// rows[B][3] the window's row i is image row row0 + i of an image of img_h
// rows; the warp's corners are clamped and its mask taken against the
// image's rows, and a corner outside the window reads the window's nearest
// row (the plan sizes windows so that no sample that matters does). The
// halo tile stays clamped to the window: its error lies in the ghost rows.
// Warp coordinates use __fmul_rn/__fadd_rn so that floor() sees the same
// rounded x = j + fac * wx as the plain version (no FMA contraction there);
// elsewhere nvcc's FMA contraction makes results differ from the twin in
// the last bits.
#include "assemble.cuh"

using namespace sf;

namespace {

// STRIP: the strip table is given (rows, img_h); else whole images, with
// none of its index work.
template <int MODE, bool ZERO_DUV, bool STRIP>
__global__ void __launch_bounds__(NT, MODE == MODE_OCC ? 3 : 2) warp_assemble_kernel(
    const float* __restrict__ seq, const float* __restrict__ wx,
    const float* __restrict__ wy, const float* __restrict__ occ,
    const float* __restrict__ du, const float* __restrict__ dv,
    const float* __restrict__ cw, float* __restrict__ out,
    const int* __restrict__ rows, int img_h, int B, int H, int W,
    AsmParams P) {
  extern __shared__ float smem[];
  const int ref = P.ref, F = 2 * ref + 1;
  float* frames = smem;                  // [F][3][LH][LW]
  float* sx = frames + F * 3 * LH * LW;  // [3][XH][XW]  Ix
  float* sy = sx + 3 * XH * XW;          // [3][YH][YW]  Iy

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t HW = (size_t)H * W;
  const float* fxp = wx + b * HW;
  const float* fyp = wy + b * HW;
  const float* win = seq + (size_t)b * F * 3 * HW;
  const int row0 = STRIP ? rows[3 * b] : 0;
  const int ih = STRIP ? img_h : H;  // the image's rows

  // ---- load phase: the reference tile by cp.async, the others warped ----
  for (int idx = tid; idx < 3 * LH * LW; idx += NT) {
    const int c = idx / (LH * LW), r = idx % (LH * LW);
    const int gy = clampi(y0 - EXT + r / LW, 0, H - 1);
    const int gx = clampi(x0 - EXT + r % LW, 0, W - 1);
    cp_async4(frames + (size_t)(ref * 3 + c) * LH * LW + r,
              win + (size_t)(ref * 3 + c) * HW + (size_t)gy * W + gx);
  }
  cp_async_commit();
  for (int r = tid; r < LH * LW; r += NT) {
    const int gy = clampi(y0 - EXT + r / LW, 0, H - 1);
    const int gx = clampi(x0 - EXT + r % LW, 0, W - 1);
    const size_t pix = (size_t)gy * W + gx;
    const float fx = fxp[pix], fy = fyp[pix];
#pragma unroll 2
    for (int k = 0; k < F; ++k) {
      if (k == ref) continue;
      const float fac = (float)(k - ref);
      const float x = __fadd_rn((float)gx, __fmul_rn(fac, fx));
      const float y = __fadd_rn((float)(gy + row0), __fmul_rn(fac, fy));
      const float xf = floorf(x), yf = floorf(y);
      const float dx = x - xf, dy = y - yf;
      const int xi = (int)fminf(fmaxf(xf, -1.f), (float)W);
      const int yi = (int)fminf(fmaxf(yf, -1.f), (float)ih);
      const int xa = clampi(xi, 0, W - 1), xb = clampi(xi + 1, 0, W - 1);
      int ya = clampi(yi, 0, ih - 1), yb = clampi(yi + 1, 0, ih - 1);
      if (STRIP) {
        ya = clampi(ya - row0, 0, H - 1);
        yb = clampi(yb - row0, 0, H - 1);
      }
      const float* src = win + (size_t)k * 3 * HW;
      float* dst = frames + (size_t)k * 3 * LH * LW + r;
      for (int c = 0; c < 3; ++c) {
        const float* s = src + c * HW;
        const float top = (1.f - dx) * s[ya * W + xa] + dx * s[ya * W + xb];
        const float bot = (1.f - dx) * s[yb * W + xa] + dx * s[yb * W + xb];
        dst[c * LH * LW] = (1.f - dy) * top + dy * bot;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // ---- self-mask: warp-coordinate validity, occlusion gate in assembly ----
  const int gx = x0 + (int)threadIdx.x, gy = y0 + (int)threadIdx.y;
  const size_t pp = (size_t)min(gy, H - 1) * W + min(gx, W - 1);
  const float fx = fxp[pp], fy = fyp[pp];
  float gate_b = 1.f, gate_f = 1.f;
  if (MODE == MODE_ASSEMBLY) {
    const float o = occ[b * HW + pp];
    const float factor = (1.f + (o == 0.f ? 1.f : 0.f)) * P.data_norm;
    gate_b = P.one_direction ? 0.f : (o >= 0.f ? 1.f : 0.f) / factor;
    gate_f = (o <= 0.f ? 1.f : 0.f) / factor;
  }
  auto mask_of = [&](int s) {
    // warp-coordinate validity of the frame serving offset s
    const int km = s < ref ? s : s + 1;
    const float facm = (float)(km - ref);
    const float xm = __fadd_rn((float)gx, __fmul_rn(facm, fx));
    const float ym = __fadd_rn((float)(gy + row0), __fmul_rn(facm, fy));
    float m = (xm >= 0.f && xm <= (float)(W - 1) && ym >= 0.f &&
               ym <= (float)(ih - 1)) ? 1.f : 0.f;
    if (MODE == MODE_ASSEMBLY) m *= s < ref ? gate_b : gate_f;
    return m;
  };
  assemble_tile<MODE, ZERO_DUV>(P, frames, sx, sy, cw, du, dv, out, b, B, H,
                                W, x0, y0, mask_of);
}

}  // namespace

// params: N_PARAMS host floats, laid out by
// slowflow_tpu_torch/variational/fused_data.py `kernel_params`.
// out: [n_out, B, H, W]. rows: the strip table above, or null (img_h = H).
// Returns a cudaError_t code (0 = launched).
extern "C" int sf_warp_assemble(const float* seq, const float* wx,
                                const float* wy, const float* occ,
                                const float* du, const float* dv,
                                const float* cw, float* out, const int* rows,
                                int img_h, int B, int H, int W, int mode,
                                int zero_duv,
                                const float* params, int n_params,
                                void* stream) {
  AsmParams P;
  if (!parse_params(params, n_params, P) || img_h < H || (!rows && img_h != H))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(2 * P.ref + 1);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B), block(TW, TH);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)dispatch_mode(mode, zero_duv, [&](auto m, auto z) {
    auto kern = rows ? warp_assemble_kernel<decltype(m)::value, decltype(z)::value, true>
                     : warp_assemble_kernel<decltype(m)::value, decltype(z)::value, false>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, block, smem, st>>>(seq, wx, wy, occ, du, dv, cw, out, rows,
                                    img_h, B, H, W, P);
    return cudaGetLastError();
  });
}

// out[0..2] = resident blocks per SM, registers per thread, spill bytes per
// thread of the (mode, zero_duv) variant at a window of 2 ref + 1 frames.
extern "C" int sf_warp_assemble_occupancy(int mode, int zero_duv, int ref, int* out) {
  if (ref < 1 || 2 * ref > MAXN) return (int)cudaErrorInvalidValue;
  return (int)dispatch_mode(mode, zero_duv, [&](auto m, auto z) {
    return kernel_occupancy(warp_assemble_kernel<decltype(m)::value, decltype(z)::value, false>,
                            tile_smem_bytes(2 * ref + 1), out);
  });
}
