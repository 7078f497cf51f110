// K1: fused plane sweep + cross-view variance cost volume, and K2, its
// backward.
//
// K1 replaces the TPU kernels mvsnerf_tpu/ops/pallas_sweep2.py:316
// `cost_volume_xband_pallas` (forward `_xb_fwd_kernel`) and its fallback
// mvsnerf_tpu/ops/pallas_sweep.py:504 `cost_volume_fused_pallas`, plus the
// packed16 relayout pallas_sweep2.py:418 `pack16_from_tiles` (K3), whose
// job this kernel's store does: it writes the (1, 3V+C, D, hp, wp) cost
// volume contiguous (NCDHW), the layout cuDNN runs the f32 3-D U-Net in,
// so CostRegNet's first convolution reads it without a relayout pass.
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
// What bounds K1 on the H100: the output write, 4 B x (3V+C) per voxel
// (4 B x 41 x 128 x 176 x 208 by the shapes). The sources, 4 B x 35 x
// 128 x 160 per view, stay in L2. Consecutive threads hold consecutive
// voxels, so each of a warp's 41 channel stores covers 128 contiguous
// bytes.
//
// K2 replaces the TPU backward kernels pallas_sweep2.py:210 `_xb_bwd_kernel`
// (via `_xb_bwd_rule` :342) and pallas_sweep.py:432 `_fused_bwd_kernel`
// (via `_fused_bwd_rule` :581), and the cotangent direction of the packed16
// relayout, pallas_sweep2.py:487 `unpack16_to_tiles` (K3'): it reads the
// cotangent where the U-Net's backward leaves it (NCDHW, as K1 wrote the
// volume), through its strides.
// For each voxel it recomputes the per-view warps and the in-bounds count
// with K1's own coordinate arithmetic (`sweep_tap` below), then
//   d warped_v[c] = g_var[c] * 2 / count * (warped_v[c] - mean[c])
//   d rgb_v[k]    = g[3v + k]
// scattered through the 4 bilinear taps (off-image taps get nothing), and
// for the reference view 2 / count * g_var * (ref - mean) plus g[0:3],
// summed over the planes. The coordinates get no gradient. Nothing of the
// forward is saved: the warps are recomputed, as the TPU kernel does.
//
// K2's layout: one warp per (column, run of BWD_PLANES planes), one lane
// per feature channel, so each load of a tap and each atomic add of a warp
// covers 128 contiguous bytes of a source pixel. The source-view gradients
// are f32 atomicAdd (summation order varies from run to run); the
// reference gradient is summed in a register over the warp's planes and
// added once. The cotangent is read through its strides, so the layout the
// U-Net's backward leaves (NCDHW, or channels_last_3d) is read in place:
// the packed16 relayout's cotangent direction needs no pass of its own.
// The TPU kernel's x-band windows, tile-major lanes, one-hot
// MXU transposes and `bwd_groups` partial accumulators have no counterpart.
//
// What bounds K2 on the H100: reading the cotangent, 4 B x (3V+C) per
// voxel (the same 770 MB K1 writes); in practice the ~1.3e9 atomic adds
// onto the 2 x 128 x 160 x 35 source gradients, of which neighbouring
// planes and columns hit the same pixels.

#include <cuda_runtime.h>

namespace {

// The bilinear taps of one voxel in one source view, by K1's arithmetic.
struct SweepTap {
  bool inside;  // strict in-bounds mask (pallas_sweep2.py:165-168)
  bool hit;     // at least one tap lies in the image
  int x0, y0;
  float wt[4];  // (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1)
};

__device__ __forceinline__ SweepTap sweep_tap(const float* __restrict__ P,
                                              float gx, float gy,
                                              float depth, int h, int w) {
  SweepTap t;
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
  t.inside = px > 0.f && px < w - 1.f && py > 0.f && py < h - 1.f;

  // normalise, then unnormalise as grid_sample(align_corners=True) does
  const float gnx = __fsub_rn(__fdiv_rn(px, (w - 1) * 0.5f), 1.f);
  const float gny = __fsub_rn(__fdiv_rn(py, (h - 1) * 0.5f), 1.f);
  const float ix =
      __fmul_rn(__fdiv_rn(__fadd_rn(gnx, 1.f), 2.f), (float)(w - 1));
  const float iy =
      __fmul_rn(__fdiv_rn(__fadd_rn(gny, 1.f), 2.f), (float)(h - 1));
  // bilinear, zeros padding: out-of-image corners contribute nothing
  t.hit = ix > -1.f && ix < (float)w && iy > -1.f && iy < (float)h;
  if (t.hit) {
    const float fx = floorf(ix), fy = floorf(iy);
    t.x0 = (int)fx;
    t.y0 = (int)fy;
    const float wx1 = ix - fx, wy1 = iy - fy;
    const float wx0 = (fx + 1.f) - ix, wy0 = (fy + 1.f) - iy;
    t.wt[0] = wx0 * wy0;
    t.wt[1] = wx1 * wy0;
    t.wt[2] = wx0 * wy1;
    t.wt[3] = wx1 * wy1;
  }
  return t;
}

// tap k of `t` lies in the h x w image
__device__ __forceinline__ bool tap_in(const SweepTap& t, int k, int h,
                                       int w) {
  const int xi = t.x0 + (k & 1), yi = t.y0 + (k >> 1);
  return xi >= 0 && xi < w && yi >= 0 && yi < h;
}

__device__ __forceinline__ long long tap_pixel(const SweepTap& t, int k,
                                               int w) {
  return (long long)(t.y0 + (k >> 1)) * w + t.x0 + (k & 1);
}

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
  // channel c of this voxel is o[c * n] (NCDHW)
  float* o = out + idx;

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
    o[n] = r[C + 1];
    o[2 * n] = r[C + 2];
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) sum[c] = sq[c] = 0.f;
    o[0] = o[n] = o[2 * n] = 0.f;
  }

  float count = 1.f;
  const float gx = (float)rx, gy = (float)ry;
  const float depth = depths[d];
  for (int v = 1; v < V; ++v) {
    const SweepTap t = sweep_tap(proj + (v - 1) * 12, gx, gy, depth, h, w);
    if (t.inside) count += 1.f;
    float val[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c) val[c] = 0.f;
    if (t.hit) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!tap_in(t, k, h, w)) continue;
        const float* s = srcs + ((long long)v * h * w + tap_pixel(t, k, w)) *
                                    CS;
#pragma unroll
        for (int c = 0; c < CS; ++c) val[c] = fmaf(s[c], t.wt[k], val[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      sum[c] = __fadd_rn(sum[c], val[c]);
      sq[c] = __fadd_rn(sq[c], __fmul_rn(val[c], val[c]));
    }
    o[3 * v * n] = val[C];
    o[(3 * v + 1) * n] = val[C + 1];
    o[(3 * v + 2) * n] = val[C + 2];
  }

  // var = E[x^2] - E[x]^2 over the views that see the voxel, in f32
  const float inv = __fdiv_rn(1.f, count);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const float mean = __fmul_rn(sum[c], inv);
    o[(3 * V + c) * n] =
        __fsub_rn(__fmul_rn(sq[c], inv), __fmul_rn(mean, mean));
  }
}

// element strides of the (1, 3V+C, D, hp, wp) cotangent: channel, plane,
// row, column
struct GradStrides {
  long long c, d, y, x;
};

constexpr int BWD_WARPS = 8;    // warps per block
constexpr int BWD_PLANES = 16;  // planes per warp

// channel `c` of view image `s` (h, w, CS) warped by `t`, in K1's order
template <int CS>
__device__ __forceinline__ float warp_channel(const float* __restrict__ s,
                                              const SweepTap& t, int h, int w,
                                              int c) {
  float val = 0.f;
  if (t.hit) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (tap_in(t, k, h, w))
        val = fmaf(s[tap_pixel(t, k, w) * CS + c], t.wt[k], val);
  }
  return val;
}

template <int C>
__global__ void __launch_bounds__(BWD_WARPS * 32)
    sweep_bwd_kernel(const float* __restrict__ g,
                     const float* __restrict__ srcs,
                     const float* __restrict__ proj,
                     const float* __restrict__ depths,
                     float* __restrict__ gsrc, GradStrides gst, int V,
                     int h, int w, int D, int pad) {
  static_assert(C == 32, "one lane per feature channel");
  constexpr int CS = C + 3;
  const int lane = threadIdx.x & 31;
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const int n_runs = (D + BWD_PLANES - 1) / BWD_PLANES;
  const long long item =
      (long long)blockIdx.x * BWD_WARPS + (threadIdx.x >> 5);
  if (item >= (long long)n_runs * hp * wp) return;  // whole warps leave
  const int x = (int)(item % wp);
  const int y = (int)((item / wp) % hp);
  const int d0 = (int)(item / ((long long)wp * hp)) * BWD_PLANES;
  const int d1 = min(D, d0 + BWD_PLANES);
  const long long view = (long long)h * w * CS;

  const int rx = x - pad, ry = y - pad;
  const bool interior = rx >= 0 && rx < w && ry >= 0 && ry < h;
  const float* r = srcs + ((long long)ry * w + rx) * CS;
  const float ref = interior ? r[lane] : 0.f;
  const float gx = (float)rx, gy = (float)ry;
  float g_ref = 0.f, g_ref_rgb = 0.f;  // feature `lane`; rgb `lane` < 3

  for (int d = d0; d < d1; ++d) {
    // channel c of this voxel's cotangent is gv[c * gst.c]
    const float* gv = g + d * gst.d + y * gst.y + x * gst.x;
    const float depth = depths[d];
    // recompute the forward's sum and count for this voxel
    float sum = ref, count = 1.f;
    for (int v = 1; v < V; ++v) {
      const SweepTap t =
          sweep_tap(proj + (v - 1) * 12, gx, gy, depth, h, w);
      if (t.inside) count += 1.f;
      sum = __fadd_rn(sum, warp_channel<CS>(srcs + v * view, t, h, w, lane));
    }
    const float inv = __fdiv_rn(1.f, count);
    const float mean = __fmul_rn(sum, inv);
    // d var / d x = 2 / n (x - mean)
    const float gs = gv[(3 * V + lane) * gst.c] * (2.f * inv);
    if (interior) {
      g_ref += gs * (ref - mean);
      if (lane < 3) g_ref_rgb += gv[lane * gst.c];
    }
    for (int v = 1; v < V; ++v) {
      const SweepTap t =
          sweep_tap(proj + (v - 1) * 12, gx, gy, depth, h, w);
      if (!t.hit) continue;
      const float* s = srcs + v * view;
      const float gf = gs * (warp_channel<CS>(s, t, h, w, lane) - mean);
      const float gr = lane < 3 ? gv[(3 * v + lane) * gst.c] : 0.f;
      float* dst = gsrc + v * view;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (!tap_in(t, k, h, w)) continue;
        float* p = dst + tap_pixel(t, k, w) * CS;
        atomicAdd(p + lane, gf * t.wt[k]);
        if (lane < 3) atomicAdd(p + C + lane, gr * t.wt[k]);
      }
    }
  }
  if (interior) {  // view 0's gradient: this warp's share of the planes
    float* p = gsrc + ((long long)ry * w + rx) * CS;
    atomicAdd(p + lane, g_ref);
    if (lane < 3) atomicAdd(p + C + lane, g_ref_rgb);
  }
}

bool bad_args(int V, int h, int w, int C, int D, int pad) {
  return C != 32 || V < 2 || h < 2 || w < 2 || D < 1 || pad < 0;
}

}  // namespace

extern "C" int sweep_cost_volume(const void* srcs, const void* proj,
                                 const void* depths, void* out, int V, int h,
                                 int w, int C, int D, int pad, void* stream) {
  if (bad_args(V, h, w, C, D, pad)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)D * (h + 2 * pad) * (w + 2 * pad);
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  sweep_kernel<32><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)srcs, (const float*)proj, (const float*)depths,
      (float*)out, V, h, w, D, pad);
  return (int)cudaGetLastError();
}

// gsrc (V, h, w, C + 3) must be zeroed by the caller; g is the
// (1, 3V+C, D, hp, wp) cotangent with element strides (sc, sd, sy, sx).
extern "C" int sweep_cost_volume_bwd(const void* g, long long sc,
                                     long long sd, long long sy, long long sx,
                                     const void* srcs, const void* proj,
                                     const void* depths, void* gsrc, int V,
                                     int h, int w, int C, int D, int pad,
                                     void* stream) {
  if (bad_args(V, h, w, C, D, pad) || sc < 0 || sd < 0 || sy < 0 || sx < 0)
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)((D + BWD_PLANES - 1) / BWD_PLANES) *
                          (h + 2 * pad) * (w + 2 * pad);
  const unsigned blocks = (unsigned)((items + BWD_WARPS - 1) / BWD_WARPS);
  sweep_bwd_kernel<32><<<blocks, BWD_WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)srcs, (const float*)proj,
      (const float*)depths, (float*)gsrc, GradStrides{sc, sd, sy, sx}, V,
      h, w, D, pad);
  return (int)cudaGetLastError();
}
