// K3: IRLS data-term assembly from an already-warped window.
//
// Replaces the TPU kernel slowflow_tpu/variational/fused_data.py `_kernel`
// (wrapper `fused_data_system_batched`). Plain PyTorch twin:
// variational/fused_data.py `fused_data_system_ref`.
//
// What it computes, per output pixel of jet b: K2's derivatives and
// assembly (assemble.cuh), from the warped window [B, F, 3, H, W] that K4
// wrote and a given per-offset mask [B, N, H, W]: the gated mask in
// "assembly" mode, the raw warp mask in "occ" / "occ_assembly" mode.
//
// What bounds it on an H100: as K2, arithmetic and shared-memory traffic.
// The window is read once per tile plus a 4-pixel halo (1.5x the tile at
// 32 x 16), ~100 B/pixel with the mask and the outputs: ~50 MB per call at
// 4 x 270 x 480, ~15 us at 3.35 TB/s, against ~2000 flops per pixel and
// offset group.
//
// Design: K2's tiling (32 x 16 threads per output tile, blockIdx.z = jet)
// with a plain load phase: the block copies its tile plus the halo of every
// frame into shared memory with clamped indices, which is the edge
// replication of the warped planes that the reference's convolutions see.
#include "assemble.cuh"

using namespace sf;

namespace {

template <int MODE, bool ZERO_DUV>
__global__ void __launch_bounds__(NT) fused_data_kernel(
    const float* __restrict__ warped, const float* __restrict__ mask,
    const float* __restrict__ du, const float* __restrict__ dv,
    const float* __restrict__ cw, float* __restrict__ out, int B, int H,
    int W, AsmParams P) {
  extern __shared__ float smem[];
  const int ref = P.ref, F = 2 * ref + 1, N = 2 * ref;
  float* frames = smem;                  // [F][3][LH][LW]
  float* sx = frames + F * 3 * LH * LW;  // [3][XH][XW]  Ix
  float* sy = sx + 3 * XH * XW;          // [3][YH][YW]  Iy

  const int b = blockIdx.z;
  const int x0 = blockIdx.x * TW, y0 = blockIdx.y * TH;
  const int tid = threadIdx.y * TW + threadIdx.x;
  const size_t HW = (size_t)H * W;

  // ---- load phase: tile + halo of every warped frame, edge-clamped ----
  for (int idx = tid; idx < F * 3 * LH * LW; idx += NT) {
    const int kc = idx / (LH * LW), r = idx % (LH * LW);
    const int gy = clampi(y0 - EXT + r / LW, 0, H - 1);
    const int gx = clampi(x0 - EXT + r % LW, 0, W - 1);
    frames[idx] = warped[((size_t)b * F * 3 + kc) * HW + (size_t)gy * W + gx];
  }
  __syncthreads();

  const int gx = x0 + (int)threadIdx.x, gy = y0 + (int)threadIdx.y;
  const size_t pp = (size_t)min(gy, H - 1) * W + min(gx, W - 1);
  const float* mb = mask + (size_t)b * N * HW + pp;
  auto mask_of = [&](int s) { return mb[s * HW]; };
  assemble_tile<MODE, ZERO_DUV>(P, frames, sx, sy, cw, du, dv, out, b, B, H,
                                W, x0, y0, mask_of);
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
  if (!parse_params(params, n_params, P)) return (int)cudaErrorInvalidValue;
  const size_t smem = tile_smem_bytes(2 * P.ref + 1);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B), block(TW, TH);
  cudaStream_t st = (cudaStream_t)stream;
  return (int)dispatch_mode(mode, zero_duv, [&](auto m, auto z) {
    auto kern = fused_data_kernel<decltype(m)::value, decltype(z)::value>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kern<<<grid, block, smem, st>>>(warped, mask, du, dv, cw, out, B, H, W,
                                    P);
    return cudaGetLastError();
  });
}

// out[0..2] = resident blocks per SM, registers per thread, spill bytes per
// thread of the (mode, zero_duv) variant at a window of 2 ref + 1 frames.
extern "C" int sf_fused_data_occupancy(int mode, int zero_duv, int ref, int* out) {
  if (ref < 1 || 2 * ref > MAXN) return (int)cudaErrorInvalidValue;
  return (int)dispatch_mode(mode, zero_duv, [&](auto m, auto z) {
    return kernel_occupancy(fused_data_kernel<decltype(m)::value, decltype(z)::value>,
                            tile_smem_bytes(2 * ref + 1), out);
  });
}
