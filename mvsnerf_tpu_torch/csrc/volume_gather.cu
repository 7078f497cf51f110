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
// float4 load (two threads share a 32 B voxel at C = 8).
//
// The backward (splat_kernel) adds w * g into the zeroed gradient, each
// corner's 4 channels with one 16-byte atomicAdd (a single REDG.128 on
// sm_90, not four scalar REDs), so its summation order varies from run to
// run. A ray's samples are consecutive in `ndc` and step about one plane
// in z each: where the sample before this one in the warp (lane - CG, the
// same channel group) has the same x and y taps and its z tap one plane
// below, its 4 upper corners are this sample's 4 lower ones. That lane
// hands their weights and its cotangent over by shuffles and skips them,
// and this lane adds both in one atomic a corner (ops/volume_gather.py
// `splat_merges` is the rule). Each corner's add is issued once whatever
// the merge; the merge only saves atomics.
//
// What bounds it on the H100: the forward reads 8 corners per sample from
// a 150 MB volume that does not fit in L2 (random rows), the backward the
// same corners as atomics plus the 150 MB zeroing pass of the wrapper,
// which writes the dense gradient (Adam updates the whole volume).

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

// adds: null, or 2 counters of the corner adds that went to device memory
// ([0], each one atomic) and of those merged into the next sample's ([1])
__global__ void __launch_bounds__(THREADS)
    splat_kernel(const float* __restrict__ g, const float* __restrict__ ndc,
                 float* __restrict__ gvol, long long M, int CG, int D, int HP,
                 int WP, unsigned long long* __restrict__ adds) {
  constexpr unsigned ALL = 0xffffffffu;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31, C = CG * 4;
  Taps t;
  // every lane of the warp takes part in the shuffles; x0 = -2 (no sample's
  // tap) where this lane has no sample or its corners all lie outside
  const bool on = i < M && taps(ndc + i / CG * 3, D, HP, WP, t);
  const int kx = on ? t.x0 : -2, ky = on ? t.y0 : 0, kz = on ? t.z0 : 0;
  const float4 gg = on ? reinterpret_cast<const float4*>(g)[i]
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  // the previous sample's (lane - CG) taps, upper-corner weights and
  // cotangent
  const int px = __shfl_up_sync(ALL, kx, CG), py = __shfl_up_sync(ALL, ky, CG),
            pz = __shfl_up_sync(ALL, kz, CG);
  float pw[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    pw[c] = __shfl_up_sync(
        ALL, on ? t.wx[c & 1] * t.wy[c >> 1] * t.wz[1] : 0.f, CG);
  const float4 pg = make_float4(
      __shfl_up_sync(ALL, gg.x, CG), __shfl_up_sync(ALL, gg.y, CG),
      __shfl_up_sync(ALL, gg.z, CG), __shfl_up_sync(ALL, gg.w, CG));
  const bool take =
      on && lane >= CG && px == kx && py == ky && pz + 1 == kz;
  const unsigned takers = __ballot_sync(ALL, take);
  const bool give = lane + CG < 32 && (takers >> (lane + CG) & 1u);
  unsigned n_add = 0, n_merged = 0;
  if (on) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k & 1, dy = (k >> 1) & 1, dz = k >> 2;
      const int xi = t.x0 + dx, yi = t.y0 + dy, zi = t.z0 + dz;
      if (xi < 0 || xi >= WP || yi < 0 || yi >= HP || zi < 0 || zi >= D)
        continue;
      if (dz == 1 && give) {  // the next sample adds it
        ++n_merged;
        continue;
      }
      const float w = t.wx[dx] * t.wy[dy] * t.wz[dz];
      float4 v = make_float4(w * gg.x, w * gg.y, w * gg.z, w * gg.w);
      if (dz == 0 && take) {
        const float u = pw[dx + 2 * dy];
        v = make_float4(v.x + u * pg.x, v.y + u * pg.y, v.z + u * pg.z,
                        v.w + u * pg.w);
      }
      ++n_add;
      atomicAdd(reinterpret_cast<float4*>(
                    gvol + (((long long)zi * HP + yi) * WP + xi) * C) +
                    i % CG,
                v);
    }
  }
  if (adds != nullptr) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      n_add += __shfl_xor_sync(ALL, n_add, m);
      n_merged += __shfl_xor_sync(ALL, n_merged, m);
    }
    if (lane == 0) {
      atomicAdd(adds, (unsigned long long)n_add);
      atomicAdd(adds + 1, (unsigned long long)n_merged);
    }
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

// gvol (D, HP, WP, C) must be zeroed by the caller; adds: null, or 2
// zeroed counters (splat_kernel)
extern "C" int volume_splat_bwd(const void* g, const void* ndc, void* gvol,
                                int n_samples, int D, int HP, int WP, int C,
                                void* adds, void* stream) {
  if (bad_args(n_samples, D, HP, WP, C)) return (int)cudaErrorInvalidValue;
  const long long M = (long long)n_samples * (C / 4);
  if (M == 0) return 0;
  splat_kernel<<<(unsigned)((M + THREADS - 1) / THREADS), THREADS, 0,
                 (cudaStream_t)stream>>>(
      (const float*)g, (const float*)ndc, (float*)gvol, M, C / 4, D, HP, WP,
      (unsigned long long*)adds);
  return (int)cudaGetLastError();
}
