// K4: per-sample source-view colours + in-bounds masks, and the transpose
// of the colour warp (the source images' gradient).
//
// Forward: replaces the TPU kernel mvsnerf_tpu/ops/pallas_sweep.py:258
// `bilinear_warp_pallas` (forward `_fwd_kernel`) as used by
// render/renderer.py:26-113 `build_color_volume`: for every sample point
// and each of the V source views, project the world point with the view's
// w2c and intrinsics (`get_ndc_coordinate` without pad, inv_scale
// (W-1, H-1)), take grid = ndc * 2 - 1, the strict mask
// (-1 < gx < 1) & (-1 < gy < 1), and the RGB by bilinear interpolation with
// border padding (coordinates clamped to the corner pixel centres),
// align_corners=True. Output (M, 4V) in per-view blocks [R, G, B, mask].
//
// Backward: replaces pallas_sweep.py:147 `_bwd_kernel` (pallas_call :202,
// reached through `_warp_bwd_rule` :316): each sample's RGB cotangent,
// times each of its 4 bilinear weights, is added to the tap's source
// pixel; the mask's cotangent is dropped (a step function). The TPU kernel
// keeps the whole (h, 8, w) image gradient in VMEM across a sequential
// grid and scatters with banded one-hot matmuls; blocks here run in no
// order, so the sum across them is f32 atomics into a gradient the wrapper
// zeroed on the same stream.
//
// One thread per sample in both directions, looping over the V views. The
// projection, clamp and taps are one helper that both kernels call, so the
// backward scatters to exactly the forward's taps with exactly its weights.
// It uses round-to-nearest intrinsics with no FMA contraction, in the plain
// twin's operation order, so the sampling coordinates are bit-identical to
// the twin's (a one-ulp coordinate difference moves a colour by up to 1e-4
// at 640 px).
//
// What bounds it on the H100: the forward's (M, 12) f32 output write (48 B
// per sample) and 12 B point read; three 640x512 RGB f32 images are 3 x 3.9
// MiB by their shape and fit the 50 MB L2. The backward reads the same
// 60 B per sample and issues up to 36 f32 atomics per sample into that
// L2-resident gradient; consecutive samples of a ray land on neighbouring
// pixels of an epipolar segment, so a warp's atomics collide often, and
// most where samples outside a view clamp onto its border pixels.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// The projection of one point into one view and its 4 bilinear taps:
// tap t is pixel (x0 + (t & 1), y0 + (t >> 1)) with weight wt[t]; a tap
// past the clamped far edge (xi >= W or yi >= H) has weight 0 and is
// skipped by both kernels.
struct Taps {
  int x0, y0;
  float wt[4];
  bool inside;
};

__device__ __forceinline__ Taps project_taps(float p0, float p1, float p2,
                                             const float* __restrict__ E,
                                             const float* __restrict__ K,
                                             float wm1, float hm1) {
  const float c0 = __fadd_rn(dot3_rn(p0, p1, p2, E[0], E[1], E[2]), E[3]);
  const float c1 = __fadd_rn(dot3_rn(p0, p1, p2, E[4], E[5], E[6]), E[7]);
  const float c2 = __fadd_rn(dot3_rn(p0, p1, p2, E[8], E[9], E[10]), E[11]);
  const float q0 = dot3_rn(c0, c1, c2, K[0], K[1], K[2]);
  const float q1 = dot3_rn(c0, c1, c2, K[3], K[4], K[5]);
  const float q2 = dot3_rn(c0, c1, c2, K[6], K[7], K[8]);
  const float gx =
      __fsub_rn(__fmul_rn(__fdiv_rn(__fdiv_rn(q0, q2), wm1), 2.f), 1.f);
  const float gy =
      __fsub_rn(__fmul_rn(__fdiv_rn(__fdiv_rn(q1, q2), hm1), 2.f), 1.f);
  Taps t;
  t.inside = gx > -1.f && gx < 1.f && gy > -1.f && gy < 1.f;

  // grid_sample border padding: unnormalise, clamp to [0, size - 1]
  float ix = __fmul_rn(__fdiv_rn(__fadd_rn(gx, 1.f), 2.f), wm1);
  float iy = __fmul_rn(__fdiv_rn(__fadd_rn(gy, 1.f), 2.f), hm1);
  ix = fminf(wm1, fmaxf(ix, 0.f));
  iy = fminf(hm1, fmaxf(iy, 0.f));
  const float fx = floorf(ix), fy = floorf(iy);
  t.x0 = (int)fx;
  t.y0 = (int)fy;
  const float wx0 = (fx + 1.f) - ix, wx1 = ix - fx;
  const float wy0 = (fy + 1.f) - iy, wy1 = iy - fy;
  t.wt[0] = wx0 * wy0;
  t.wt[1] = wx1 * wy0;
  t.wt[2] = wx0 * wy1;
  t.wt[3] = wx1 * wy1;
  return t;
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
    const Taps tp = project_taps(p0, p1, p2, w2cs + 16 * v, intr + 9 * v,
                                 wm1, hm1);
    const float* img = imgs + (long long)v * H * W * 3;
    float rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int xi = tp.x0 + (t & 1), yi = tp.y0 + (t >> 1);
      if (xi >= W || yi >= H) continue;  // zero weight at the clamped edge
      const float* px = img + ((long long)yi * W + xi) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) rgb[c] = fmaf(px[c], tp.wt[t], rgb[c]);
    }
    o[4 * v] = rgb[0];
    o[4 * v + 1] = rgb[1];
    o[4 * v + 2] = rgb[2];
    o[4 * v + 3] = tp.inside ? 1.f : 0.f;
  }
}

__global__ void color_warp_bwd_kernel(const float* __restrict__ g,
                                      const float* __restrict__ pts,
                                      const float* __restrict__ w2cs,
                                      const float* __restrict__ intr,
                                      float* __restrict__ gimgs, long long M,
                                      int V, int H, int W) {
  const long long m = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  const float p0 = pts[3 * m], p1 = pts[3 * m + 1], p2 = pts[3 * m + 2];
  const float wm1 = (float)(W - 1), hm1 = (float)(H - 1);
  const float* gm = g + m * 4 * V;
  for (int v = 0; v < V; ++v) {
    const float gc[3] = {gm[4 * v], gm[4 * v + 1], gm[4 * v + 2]};
    const Taps tp = project_taps(p0, p1, p2, w2cs + 16 * v, intr + 9 * v,
                                 wm1, hm1);
    float* gimg = gimgs + (long long)v * H * W * 3;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int xi = tp.x0 + (t & 1), yi = tp.y0 + (t >> 1);
      // the forward's taps: none past the clamped edge, and a zero weight
      // (a coordinate on a pixel centre) adds nothing
      if (xi >= W || yi >= H || tp.wt[t] == 0.f) continue;
      float* px = gimg + ((long long)yi * W + xi) * 3;
#pragma unroll
      for (int c = 0; c < 3; ++c) atomicAdd(px + c, tp.wt[t] * gc[c]);
    }
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

// g: (M, 4V) cotangent of color_warp's output; gimgs: (V, H, W, 3), zeroed
// by the caller on `stream`.
extern "C" int color_warp_bwd(const void* g, const void* pts,
                              const void* w2cs, const void* intr,
                              void* gimgs, int M, int V, int H, int W,
                              void* stream) {
  if (V < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)(((long long)M + threads - 1) / threads);
  color_warp_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)pts, (const float*)w2cs,
      (const float*)intr, (float*)gimgs, M, V, H, W);
  return (int)cudaGetLastError();
}
