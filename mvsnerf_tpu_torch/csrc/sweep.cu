// K1: fused plane sweep + cross-view variance cost volume.
//
// Replaces the TPU kernels mvsnerf_tpu/ops/pallas_sweep2.py:316
// `cost_volume_xband_pallas` (forward `_xb_fwd_kernel`) and its fallback
// mvsnerf_tpu/ops/pallas_sweep.py:504 `cost_volume_fused_pallas`, plus the
// packed16 relayout pallas_sweep2.py:418 `pack16_from_tiles` (K3), whose
// job this kernel's epilogue does: it writes the (1, 3V+C, D, hp, wp)
// cost volume directly in channels_last_3d memory, i.e. physically
// (D, hp, wp, 3V+C), the layout the cuDNN U-Net reads. No relayout pass.
//
// One thread per output voxel (d, y, x) of the padded grid. For each source
// view the homography coordinate is computed in-register (the JAX
// `plane_sweep_pix_coords`, homography.py:53-80), so no coordinate arrays
// exist in memory. A direct gather needs no x/y window contract, so the
// TPU's `xband_fits` / `sweep_fits_band_pix` checks and their lax.cond
// fallbacks have no counterpart.
//
// The coordinate and variance arithmetic uses round-to-nearest intrinsics
// with no FMA contraction, in the plain twin's operation order
// (ops/sweep.py), so kernel and twin sample at the same coordinates: with
// ~1e2-px coordinates and steep feature maps, one ulp of a coordinate
// moves the variance by ~1e-4.
//
// What bounds it on the H100: the output write, 4 B x (3V+C) per voxel
// (4 B x 41 x 128 x 176 x 208 by the shapes). The sources, 4 B x 35 x
// 128 x 160 per view, stay in L2. Each thread writes its 41 channels contiguously, so a warp's
// stores cover one contiguous 5 KB span; L2 merges the partial sectors.

#include <cuda_runtime.h>

namespace {

template <int C>
__global__ void sweep_kernel(const float* __restrict__ srcs,
                             const float* __restrict__ proj,
                             const float* __restrict__ depths,
                             float* __restrict__ out, int V, int h, int w,
                             int D, int pad) {
  constexpr int CS = C + 3;  // [feat(C) | rgb(3)] per source pixel
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const long long n = (long long)D * hp * wp;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const int x = (int)(idx % wp);
  const int y = (int)((idx / wp) % hp);
  const int d = (int)(idx / ((long long)wp * hp));
  const int OC = 3 * V + C;
  float* o = out + idx * OC;

  float sum[C], sq[C];
  // the reference view is zero-padded, not warped (homography.py:170-172)
  const int rx = x - pad, ry = y - pad;
  if (rx >= 0 && rx < w && ry >= 0 && ry < h) {
    const float* r = srcs + ((long long)ry * w + rx) * CS;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float f = r[c];
      sum[c] = f;
      sq[c] = __fmul_rn(f, f);
    }
    o[0] = r[C];
    o[1] = r[C + 1];
    o[2] = r[C + 2];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) sum[c] = sq[c] = 0.f;
    o[0] = o[1] = o[2] = 0.f;
  }

  float count = 1.f;
  const float gx = (float)rx, gy = (float)ry;
  const float depth = depths[d];
  for (int v = 1; v < V; ++v) {
    const float* P = proj + (v - 1) * 12;  // (3, 4) = [R | T]
    // R @ [gx, gy, 1] + T / depth, then the perspective divide
    float s3[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      s3[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[4 * i], gx),
                                            __fmul_rn(P[4 * i + 1], gy)),
                                  P[4 * i + 2]),
                        __fdiv_rn(P[4 * i + 3], depth));
    const float inv_z = __fdiv_rn(1.f, s3[2]);
    const float px = __fmul_rn(s3[0], inv_z), py = __fmul_rn(s3[1], inv_z);
    // strict in-bounds mask (pallas_sweep2.py:165-168)
    if (px > 0.f && px < w - 1.f && py > 0.f && py < h - 1.f) count += 1.f;

    // normalise, then unnormalise as grid_sample(align_corners=True) does
    const float gnx = __fsub_rn(__fdiv_rn(px, (w - 1) * 0.5f), 1.f);
    const float gny = __fsub_rn(__fdiv_rn(py, (h - 1) * 0.5f), 1.f);
    const float ix =
        __fmul_rn(__fdiv_rn(__fadd_rn(gnx, 1.f), 2.f), (float)(w - 1));
    const float iy =
        __fmul_rn(__fdiv_rn(__fadd_rn(gny, 1.f), 2.f), (float)(h - 1));
    float val[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c) val[c] = 0.f;
    // bilinear, zeros padding: out-of-image corners contribute nothing
    if (ix > -1.f && ix < (float)w && iy > -1.f && iy < (float)h) {
      const float fx = floorf(ix), fy = floorf(iy);
      const int x0 = (int)fx, y0 = (int)fy;
      const float wx1 = ix - fx, wy1 = iy - fy;
      const float wx0 = (fx + 1.f) - ix, wy0 = (fy + 1.f) - iy;
      const float wt[4] = {wx0 * wy0, wx1 * wy0, wx0 * wy1, wx1 * wy1};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int xi = x0 + (t & 1), yi = y0 + (t >> 1);
        if (xi < 0 || xi >= w || yi < 0 || yi >= h) continue;
        const float* s =
            srcs + (((long long)v * h + yi) * w + xi) * CS;
#pragma unroll
        for (int c = 0; c < CS; ++c) val[c] = fmaf(s[c], wt[t], val[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum[c] = __fadd_rn(sum[c], val[c]);
      sq[c] = __fadd_rn(sq[c], __fmul_rn(val[c], val[c]));
    }
    o[3 * v] = val[C];
    o[3 * v + 1] = val[C + 1];
    o[3 * v + 2] = val[C + 2];
  }

  // var = E[x^2] - E[x]^2 over the views that see the voxel, in f32
  const float inv = __fdiv_rn(1.f, count);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mean = __fmul_rn(sum[c], inv);
    o[3 * V + c] = __fsub_rn(__fmul_rn(sq[c], inv), __fmul_rn(mean, mean));
  }
}

}  // namespace

extern "C" int sweep_cost_volume(const void* srcs, const void* proj,
                                 const void* depths, void* out, int V, int h,
                                 int w, int C, int D, int pad, void* stream) {
  if (C != 32 || V < 2) return (int)cudaErrorInvalidValue;
  const long long n = (long long)D * (h + 2 * pad) * (w + 2 * pad);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sweep_kernel<32><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)srcs, (const float*)proj, (const float*)depths,
      (float*)out, V, h, w, D, pad);
  return (int)cudaGetLastError();
}
