// K4: per-sample source-view colours + in-bounds masks.
//
// Replaces the TPU kernel mvsnerf_tpu/ops/pallas_sweep.py:258
// `bilinear_warp_pallas` (forward `_fwd_kernel`) as used by
// render/renderer.py:26-113 `build_color_volume`: for every sample point
// and each of the V source views, project the world point with the view's
// w2c and intrinsics (`get_ndc_coordinate` without pad, inv_scale
// (W-1, H-1)), take grid = ndc * 2 - 1, the strict mask
// (-1 < gx < 1) & (-1 < gy < 1), and the RGB by bilinear interpolation with
// border padding (coordinates clamped to the corner pixel centres),
// align_corners=True. Output (M, 4V) in per-view blocks [R, G, B, mask].
//
// One thread per sample. The projection is fused in, so no (N, S, 2) grid
// tensor exists. It uses round-to-nearest intrinsics with no FMA
// contraction, in the plain twin's operation order, so the sampling
// coordinates are bit-identical to the twin's (a one-ulp coordinate
// difference moves a colour by up to 1e-4 at 640 px).
//
// What bounds it on the H100: the (M, 12) f32 output write (48 B per
// sample) and the 12 B point read; three 640x512 RGB f32 images are
// 3 x 3.9 MiB by their shape and fit the 50 MB L2.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

__global__ void color_warp_kernel(const float* __restrict__ pts,
                                  const float* __restrict__ w2cs,
                                  const float* __restrict__ intr,
                                  const float* __restrict__ imgs,
                                  float* __restrict__ out, long long M, int V,
                                  int H, int W) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float p0 = pts[3 * m], p1 = pts[3 * m + 1], p2 = pts[3 * m + 2];
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  float* o = out + m * 4 * V;
  for (int v = 0; v < V; ++v) {
    const float* E = w2cs + 16 * v;  // (4, 4) world-to-camera
    const float* K = intr + 9 * v;   // (3, 3)
    const float c0 = __fadd_rn(dot3_rn(p0, p1, p2, E[0], E[1], E[2]), E[3]);
    const float c1 = __fadd_rn(dot3_rn(p0, p1, p2, E[4], E[5], E[6]), E[7]);
    const float c2 =
        __fadd_rn(dot3_rn(p0, p1, p2, E[8], E[9], E[10]), E[11]);
    const float q0 = dot3_rn(c0, c1, c2, K[0], K[1], K[2]);
    const float q1 = dot3_rn(c0, c1, c2, K[3], K[4], K[5]);
    const float q2 = dot3_rn(c0, c1, c2, K[6], K[7], K[8]);
    const float gx =
        __fsub_rn(__fmul_rn(__fdiv_rn(__fdiv_rn(q0, q2), wm1), 2.f), 1.f);
    const float gy =
        __fsub_rn(__fmul_rn(__fdiv_rn(__fdiv_rn(q1, q2), hm1), 2.f), 1.f);
    const bool inside = gx > -1.f && gx < 1.f && gy > -1.f && gy < 1.f;

    // grid_sample border padding: unnormalise, clamp to [0, size - 1]
    float ix = __fmul_rn(__fdiv_rn(__fadd_rn(gx, 1.f), 2.f), wm1);
    float iy = __fmul_rn(__fdiv_rn(__fadd_rn(gy, 1.f), 2.f), hm1);
    ix = fminf(wm1, fmaxf(ix, 0.f));
    iy = fminf(hm1, fmaxf(iy, 0.f));
    const float fx = floorf(ix), fy = floorf(iy);
    const int x0 = (int)fx, y0 = (int)fy;
    const float wx0 = (fx + 1.f) - ix, wx1 = ix - fx;
    const float wy0 = (fy + 1.f) - iy, wy1 = iy - fy;
    const float wt[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
    const float* img = imgs + (long long)v * H * W * 3;
    float rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int xi = x0 + (t & 1), yi = y0 + (t >> 1);
      if (xi >= W || yi >= H) continue;  // zero weight at the clamped edge
      const float* px = img + ((long long)yi * W + xi) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = fmaf(px[c], wt[t], rgb[c]);
    }
    o[4 * v] = rgb[0];
    o[4 * v + 1] = rgb[1];
    o[4 * v + 2] = rgb[2];
    o[4 * v + 3] = inside ? 1.f : 0.f;
  }
}

}  // namespace

extern "C" int color_warp(const void* pts, const void* w2cs,
                          const void* intr, const void* imgs, void* out,
                          int M, int V, int H, int W, void* stream) {
  if (V < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)(((long long)M + threads - 1) / threads);
  color_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)w2cs, (const float*)intr,
      (const float*)imgs, (float*)out, M, V, H, W);
  return (int)cudaGetLastError();
}
