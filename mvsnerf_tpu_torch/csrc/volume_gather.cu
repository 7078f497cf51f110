// K5: trilinear gather from the trainable encoding volume, and the splat
// of its cotangent back into a dense volume gradient.
//
// Replaces the TPU kernel mvsnerf_tpu/ops/pallas_volgather2.py:268
// `sample_volume_pallas2` (forward `_fwd_kernel`, pallas_call :241;
// backward `_bwd_kernel`, pallas_call :315), reached through
// `sample_volume_sorted` in the fine-tune step. The TPU kernel y-sorts the
// rays, cuts them into blocks with a static y window and a z band, turns
// the gather into one-hot MXU contractions in bf16 and falls back to a
// banded XLA VJP when a batch breaks the window contract. A direct gather
// and an atomic splat need none of that: every sample reads and writes
// exactly its 8 corners, and no tap is dropped.
//
// Semantics are those of F.grid_sample(mode="bilinear",
// padding_mode="zeros", align_corners=True) on the (1, C, D, HP, WP) view of
// the channel-last (D, HP, WP, C) volume at grid = ndc * 2 - 1, with the
// coordinate unnormalised in ATen's order ((g + 1) / 2 * (size - 1)) and the
// corner weights formed as ATen forms them. f32 throughout.
//
// Layout: one thread per (sample, group of 4 channels); a corner is one
// float4 load (two threads share a 32 B voxel at C = 8). The backward adds
// w * g into the zeroed gradient with f32 atomicAdd, so its summation
// order varies from run to run.
//
// What bounds it on the H100: the forward reads 8 corners per sample from
// a 150 MB volume that does not fit in L2 (random rows), the backward the
// same corners as atomics plus the 150 MB zeroing pass of the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// grid_sample(align_corners=True) unnormalisation of an NDC coordinate
__device__ __forceinline__ float unnorm(float ndc, int size) {
  const float g = __fsub_rn(__fmul_rn(ndc, 2.f), 1.f);
  return __fmul_rn(__fdiv_rn(__fadd_rn(g, 1.f), 2.f), (float)(size - 1));
}

struct Taps {
  int x0, y0, z0;
  float wx[2], wy[2], wz[2];
};

// false when every corner lies outside the volume
__device__ __forceinline__ bool taps(const float* __restrict__ p, int D,
                                     int HP, int WP, Taps& t) {
  const float ix = unnorm(p[0], WP), iy = unnorm(p[1], HP),
              iz = unnorm(p[2], D);
  if (!(ix > -1.f && ix < (float)WP && iy > -1.f && iy < (float)HP &&
        iz > -1.f && iz < (float)D))
    return false;
  const float fx = floorf(ix), fy = floorf(iy), fz = floorf(iz);
  t.x0 = (int)fx;
  t.y0 = (int)fy;
  t.z0 = (int)fz;
  t.wx[0] = (fx + 1.f) - ix;
  t.wx[1] = ix - fx;
  t.wy[0] = (fy + 1.f) - iy;
  t.wy[1] = iy - fy;
  t.wz[0] = (fz + 1.f) - iz;
  t.wz[1] = iz - fz;
  return true;
}

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const float* __restrict__ vol,
                  const float* __restrict__ ndc, float* __restrict__ out,
                  long long M, int CG, int D, int HP, int WP) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= M) return;
  const long long s = i / CG;
  const int cg = (int)(i % CG), C = CG * 4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  Taps t;
  if (taps(ndc + s * 3, D, HP, WP, t)) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {  // ATen's order: x fastest, then y, z
      const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
      const int xi = t.x0 + dx, yi = t.y0 + dy, zi = t.z0 + dz;
      if (xi < 0 || xi >= WP || yi < 0 || yi >= HP || zi < 0 || zi >= D)
        continue;
      const float w = t.wx[dx] * t.wy[dy] * t.wz[dz];
      const float4 v = __ldg(reinterpret_cast<const float4*>(
                                 vol + (((long long)zi * HP + yi) * WP + xi) *
                                           C) +
                             cg);
      acc.x = fmaf(v.x, w, acc.x);
      acc.y = fmaf(v.y, w, acc.y);
      acc.z = fmaf(v.z, w, acc.z);
      acc.w = fmaf(v.w, w, acc.w);
    }
  }
  reinterpret_cast<float4*>(out)[i] = acc;
}

__global__ void __launch_bounds__(THREADS)
    splat_kernel(const float* __restrict__ g, const float* __restrict__ ndc,
                 float* __restrict__ gvol, long long M, int CG, int D, int HP,
                 int WP) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= M) return;
  const long long s = i / CG;
  const int cg = (int)(i % CG), C = CG * 4;
  Taps t;
  if (!taps(ndc + s * 3, D, HP, WP, t)) return;
  const float4 gg = reinterpret_cast<const float4*>(g)[i];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
    const int xi = t.x0 + dx, yi = t.y0 + dy, zi = t.z0 + dz;
    if (xi < 0 || xi >= WP || yi < 0 || yi >= HP || zi < 0 || zi >= D)
      continue;
    const float w = t.wx[dx] * t.wy[dy] * t.wz[dz];
    float* dst = gvol + (((long long)zi * HP + yi) * WP + xi) * C + cg * 4;
    atomicAdd(dst + 0, w * gg.x);
    atomicAdd(dst + 1, w * gg.y);
    atomicAdd(dst + 2, w * gg.z);
    atomicAdd(dst + 3, w * gg.w);
  }
}

bool bad_args(int n_samples, int D, int HP, int WP, int C) {
  return n_samples < 0 || D < 1 || HP < 1 || WP < 1 || C < 4 || C % 4 != 0;
}

}  // namespace

extern "C" int volume_gather_fwd(const void* vol, const void* ndc, void* out,
                                 int n_samples, int D, int HP, int WP, int C,
                                 void* stream) {
  if (bad_args(n_samples, D, HP, WP, C)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)n_samples * (C / 4);
  if (M == 0) return 0;
  gather_kernel<<<(unsigned)((M + THREADS - 1) / THREADS), THREADS, 0,
                  (cudaStream_t)stream>>>((const float*)vol, (const float*)ndc,
                                          (float*)out, M, C / 4, D, HP, WP);
  return (int)cudaGetLastError();
}

extern "C" int volume_splat_bwd(const void* g, const void* ndc, void* gvol,
                                int n_samples, int D, int HP, int WP, int C,
                                void* stream) {
  if (bad_args(n_samples, D, HP, WP, C)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)n_samples * (C / 4);
  if (M == 0) return 0;
  splat_kernel<<<(unsigned)((M + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>((const float*)g, (const float*)ndc,
                                         (float*)gvol, M, C / 4, D, HP, WP);
  return (int)cudaGetLastError();
}
