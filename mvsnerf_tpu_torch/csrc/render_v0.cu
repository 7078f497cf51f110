// K6, K6b and K8: fused per-ray render with the v0 MLP, one kernel body
// in three forms (template parameters NV volume channels fetched, NC
// feature channels read from a buffer; NV + NC = 20, pts_bias's inputs).
//
//   K6  <8, 12>  replaces mvsnerf_tpu/ops/pallas_render_tiled.py:313
//       `tiled_render_v0` (`_make_kernel` :133) in its hybrid form: 8
//       encoding channels fetched, the 12 exact colour channels of K4
//       streamed in;
//   K6b <20, 0>  the same TPU kernel in its baked (`tiled`) form: all 20
//       channels fetched from the colour-baked (D, HP, WP, 20) volume
//       (render/tiled.py:44 `bake_color_volume`);
//   K8  <0, 20>  replaces mvsnerf_tpu/ops/pallas_kernels.py:196
//       `fused_render_v0` (`_kernel_body` :155): all 20 features already
//       gathered, no fetch; it also writes the (N, S) compositing weights.
//
// Per ray, front to back over S samples:
//   - the trilinear zeros-padded fetch of NV channels from the
//     (D, HP, WP, NV) f32 volume at the sample's NDC (index_point_feature,
//     interp.py:266), then the NC buffered channels -> 20 features,
//   - PE of the NDC xyz (10 frequencies, input included -> 63),
//   - the v0 MLP with the ray's unit direction in the reference frame,
//   - alpha = 1 - exp(-relu sigma), T <- T * (max(1 - alpha, 0) + 1e-10)
//     (pallas_kernels.py:170-188's clamp), accumulating rgb, depth, acc.
// White background is applied by the caller. There is NO early stop (the
// TPU kernel skips blocks below 1e-4 transmittance), so the result equals
// the unfused chunked render up to f32 summation order. Not carried over:
// the TPU kernels' bf16 interpolation, 3-pass split dots, CP=32 lane
// packing, tile windows (plan_tiles / pick_tile), and K8's rays_per_tile
// padding and triangular-matmul prefix sum (a running product here).
//
// Layout: one block of 128 threads per ray; thread j owns hidden unit j.
// Samples go through the MLP in groups of G = 8, so every weight read from
// global memory (126,788 floats in all, L1/L2-resident) feeds 8 FMAs.
// Activations live in shared memory as [unit][sample] rows read as
// broadcast float4s. The group's 20 x 8 (channel, sample) feature slots
// are staged by threads 32..127, two rounds of 96. After each group,
// thread 0 composites the group's samples in order.
//
// What bounds it on the H100: f32 FMA issue and L1 weight traffic, ~125k
// FMA per sample; the per-sample inputs (at most 80 B features or 8 x 80 B
// volume corners, 12 B NDC, 4 B z) are small beside that. The weight loads
// are latency-bound, so residency matters: uncapped, ptxas gives the body
// 54 registers (9 blocks a SM) and each form takes ~30 ms per 16384 x 128
// chunk; `__launch_bounds__(W, MIN_BLOCKS)` caps it at 48 (10 blocks a SM,
// a few bytes of spills) and brings each form to ~25 ms (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int W = 128;   // hidden width
constexpr int G = 8;     // samples per MLP group
constexpr int NFREQ = 10;
constexpr int NPE = 3 + 2 * NFREQ * 3;  // 63
constexpr int NF = 20;                  // MLP feature inputs (pts_bias)
constexpr int WH = W / 2;               // views head width
constexpr int STAGE0 = 4 * G;           // first feature-staging thread
constexpr int MIN_BLOCKS = 10;          // resident blocks a SM (48 regs)

// packed weights: each layer's (in, out) matrix row-major, then its bias
constexpr int OFF_W0 = 0;                         // pts_linears.0 (63, 128)
constexpr int OFF_B0 = OFF_W0 + NPE * W;
constexpr int OFF_WB = OFF_B0 + W;                // pts_bias (20, 128)
constexpr int OFF_BB = OFF_WB + NF * W;
constexpr int OFF_W1 = OFF_BB + W;                // pts_linears.1-4
constexpr int LAYER = W * W + W;                  //   (128, 128) + 128 each
constexpr int OFF_W5 = OFF_W1 + 4 * LAYER;        // pts_linears.5 (191, 128)
constexpr int OFF_B5 = OFF_W5 + (NPE + W) * W;
constexpr int OFF_WA = OFF_B5 + W;                // alpha_linear (128, 1)
constexpr int OFF_BA = OFF_WA + W;
constexpr int OFF_WF = OFF_BA + 1;                // feature_linear (128, 128)
constexpr int OFF_BF = OFF_WF + W * W;
constexpr int OFF_WV = OFF_BF + W;                // views_linears.0 (131, 64)
constexpr int OFF_BV = OFF_WV + (W + 3) * WH;
constexpr int OFF_WR = OFF_BV + WH;               // rgb_linear (64, 3)
constexpr int OFF_BR = OFF_WR + WH * 3;
constexpr int N_WEIGHTS = OFF_BR + 3;

// a[g] += w * row[g] for the G samples of one input unit
__device__ __forceinline__ void fma_row(float (&a)[G], float w,
                                        const float* row) {
  const float4 u = reinterpret_cast<const float4*>(row)[0];
  const float4 v = reinterpret_cast<const float4*>(row)[1];
  a[0] = fmaf(w, u.x, a[0]);
  a[1] = fmaf(w, u.y, a[1]);
  a[2] = fmaf(w, u.z, a[2]);
  a[3] = fmaf(w, u.w, a[3]);
  a[4] = fmaf(w, v.x, a[4]);
  a[5] = fmaf(w, v.y, a[5]);
  a[6] = fmaf(w, v.z, a[6]);
  a[7] = fmaf(w, v.w, a[7]);
}

// a = bias[j] + sum_k Wt[k, j] * x[k]  over n_in input units
__device__ __forceinline__ void dense(float (&a)[G],
                                      const float* __restrict__ Wt,
                                      const float* __restrict__ b, int n_in,
                                      int n_out, int j, float (*x)[G]) {
  const float b0 = __ldg(b + j);
#pragma unroll
  for (int g = 0; g < G; ++g) a[g] = b0;
#pragma unroll 4
  for (int k = 0; k < n_in; ++k) fma_row(a, __ldg(Wt + k * n_out + j), x[k]);
}

// grid_sample(align_corners=True) unnormalisation of an NDC coordinate
__device__ __forceinline__ float unnorm(float ndc, int size) {
  const float g = __fsub_rn(__fmul_rn(ndc, 2.f), 1.f);
  return __fmul_rn(__fdiv_rn(__fadd_rn(g, 1.f), 2.f), (float)(size - 1));
}

// trilinear zeros-padded fetch of channel c of the (D, HP, WP, NV) volume
template <int NV>
__device__ __forceinline__ float fetch(const float* __restrict__ vol,
                                       const float* p, int c, int D, int HP,
                                       int WP) {
  const float ix = unnorm(p[0], WP), iy = unnorm(p[1], HP),
              iz = unnorm(p[2], D);
  float val = 0.f;
  if (ix > -1.f && ix < (float)WP && iy > -1.f && iy < (float)HP &&
      iz > -1.f && iz < (float)D) {
    const float fx = floorf(ix), fy = floorf(iy), fz = floorf(iz);
    const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
    const float wx[2] = {(fx + 1.f) - ix, ix - fx};
    const float wy[2] = {(fy + 1.f) - iy, iy - fy};
    const float wz[2] = {(fz + 1.f) - iz, iz - fz};
#pragma unroll
    for (int t8 = 0; t8 < 8; ++t8) {
      const int dx = t8 & 1, dy = (t8 >> 1) & 1, dz = t8 >> 2;
      const int xi = x0 + dx, yi = y0 + dy, zi = z0 + dz;
      if (xi < 0 || xi >= WP || yi < 0 || yi >= HP || zi < 0 || zi >= D)
        continue;
      const float wgt = wx[dx] * wy[dy] * wz[dz];
      val = fmaf(__ldg(vol + (((long long)zi * HP + yi) * WP + xi) * NV + c),
                 wgt, val);
    }
  }
  return val;
}

template <int NV, int NC, bool WEIGHTS>
__global__ void __launch_bounds__(W, MIN_BLOCKS)
    render_v0_kernel(const float* __restrict__ ndc,
                     const float* __restrict__ zv,
                     const float* __restrict__ feats,
                     const float* __restrict__ dirs,
                     const float* __restrict__ vol,
                     const float* __restrict__ wts, float* __restrict__ out,
                     float* __restrict__ wout, int S, int D, int HP,
                     int WP) {
  static_assert(NV + NC == NF, "the v0 MLP takes 20 feature channels");
  __shared__ __align__(16) float s_pe[NPE][G];
  __shared__ __align__(16) float s_ft[NF][G];
  __shared__ __align__(16) float s_ha[W][G];
  __shared__ __align__(16) float s_hb[W][G];
  __shared__ __align__(16) float s_hv[WH][G];
  __shared__ float s_sig[G], s_rgb[3][G], s_z[G], s_dir[3];

  const int j = threadIdx.x;
  const long long ray = blockIdx.x;
  if (j < 3) s_dir[j] = dirs[ray * 3 + j];
  float trans = 1.f, acc_r = 0.f, acc_g = 0.f, acc_b = 0.f, acc_d = 0.f,
        acc_a = 0.f;  // thread 0's compositing state

  for (int s0 = 0; s0 < S; s0 += G) {
    const long long base = ray * S + s0;
    // ---- stage the group's inputs in shared memory
    if (j < 3 * G) {  // positional encoding, one (sample, axis) each
      const int g = j / 3, i = j % 3;
      const float x = ndc[(base + g) * 3 + i];
      s_pe[i][g] = x;
      float f = 1.f;
      for (int k = 0; k < NFREQ; ++k, f *= 2.f) {
        s_pe[3 + 3 * k + i][g] = sinf(x * f);
        s_pe[3 + 3 * NFREQ + 3 * k + i][g] = cosf(x * f);
      }
    } else if (j < STAGE0) {
      s_z[j - 3 * G] = zv[base + j - 3 * G];
    } else {  // the 20 features, one (sample, channel) slot per round
      for (int t = j - STAGE0; t < NF * G; t += W - STAGE0) {
        const int g = t / NF, c = t % NF;
        s_ft[c][g] = c < NV ? fetch<NV>(vol, ndc + (base + g) * 3, c, D, HP,
                                        WP)
                            : feats[(base + g) * NC + (c - NV)];
      }
    }
    __syncthreads();

    // ---- v0 MLP, thread j = hidden unit j
    float bias[G], a[G];
    dense(bias, wts + OFF_WB, wts + OFF_BB, NF, W, j, s_ft);
    dense(a, wts + OFF_W0, wts + OFF_B0, NPE, W, j, s_pe);
#pragma unroll
    for (int g = 0; g < G; ++g) s_ha[j][g] = fmaxf(a[g] * bias[g], 0.f);
    __syncthreads();
    float(*hin)[G] = s_ha;
    float(*hout)[G] = s_hb;
    for (int l = 0; l < 4; ++l) {
      const float* Wl = wts + OFF_W1 + l * LAYER;
      dense(a, Wl, Wl + W * W, W, W, j, hin);
#pragma unroll
      for (int g = 0; g < G; ++g) hout[j][g] = fmaxf(a[g] * bias[g], 0.f);
      __syncthreads();
      float(*tmp)[G] = hin;
      hin = hout;
      hout = tmp;
    }
    // skip connection: layer 5 reads [pe | h]
    dense(a, wts + OFF_W5, wts + OFF_B5, NPE, W, j, s_pe);
#pragma unroll 4
    for (int k = 0; k < W; ++k)
      fma_row(a, __ldg(wts + OFF_W5 + (NPE + k) * W + j), hin[k]);
#pragma unroll
    for (int g = 0; g < G; ++g) hout[j][g] = fmaxf(a[g] * bias[g], 0.f);
    __syncthreads();
    // heads: feature (all threads) and sigma (threads 0..G-1)
    dense(a, wts + OFF_WF, wts + OFF_BF, W, W, j, hout);
    if (j < G) {
      float sig = __ldg(wts + OFF_BA);
      for (int k = 0; k < W; ++k)
        sig = fmaf(__ldg(wts + OFF_WA + k), hout[k][j], sig);
      s_sig[j] = fmaxf(sig, 0.f);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) hin[j][g] = a[g];  // hin is free here
    __syncthreads();
    if (j < WH) {
      dense(a, wts + OFF_WV, wts + OFF_BV, W, WH, j, hin);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float w = __ldg(wts + OFF_WV + (W + k) * WH + j);
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] = fmaf(w, s_dir[k], a[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) s_hv[j][g] = fmaxf(a[g], 0.f);
    }
    __syncthreads();
    if (j < 3 * G) {
      const int g = j / 3, c = j % 3;
      float v = __ldg(wts + OFF_BR + c);
      for (int k = 0; k < WH; ++k)
        v = fmaf(__ldg(wts + OFF_WR + k * 3 + c), s_hv[k][g], v);
      s_rgb[c][g] = 1.f / (1.f + expf(-v));
    }
    __syncthreads();

    // ---- front-to-back compositing, in sample order
    if (j == 0) {
      for (int g = 0; g < G; ++g) {
        const float alpha = 1.f - expf(-s_sig[g]);
        const float wgt = alpha * trans;
        if (WEIGHTS) wout[base + g] = wgt;
        trans *= fmaxf(1.f - alpha, 0.f) + 1e-10f;
        acc_r += wgt * s_rgb[0][g];
        acc_g += wgt * s_rgb[1][g];
        acc_b += wgt * s_rgb[2][g];
        acc_d += wgt * s_z[g];
        acc_a += wgt;
      }
    }
    __syncthreads();  // the next group restages s_z / s_rgb / s_sig
  }
  if (j == 0) {
    float* o = out + ray * 5;
    o[0] = acc_r;
    o[1] = acc_g;
    o[2] = acc_b;
    o[3] = acc_d;
    o[4] = acc_a;
  }
}

}  // namespace

// K6 (colors given, C = 8) or K6b (colors null, the baked C = 20 volume);
// out (N, 5) = rgb, depth, acc
extern "C" int render_v0(const void* ndc, const void* z, const void* colors,
                         const void* dirs, const void* vol,
                         const void* weights, void* out, int N, int S, int D,
                         int HP, int WP, int C, int n_weights, void* stream) {
  if (n_weights != N_WEIGHTS || S % G != 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  if (colors != nullptr && C == 8)
    render_v0_kernel<8, 12, false><<<N, W, 0, st>>>(
        (const float*)ndc, (const float*)z, (const float*)colors,
        (const float*)dirs, (const float*)vol, (const float*)weights,
        (float*)out, nullptr, S, D, HP, WP);
  else if (colors == nullptr && C == NF)
    render_v0_kernel<NF, 0, false><<<N, W, 0, st>>>(
        (const float*)ndc, (const float*)z, nullptr, (const float*)dirs,
        (const float*)vol, (const float*)weights, (float*)out, nullptr, S, D,
        HP, WP);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K8: the 20 features of every sample gathered already; out (N, 5) = rgb,
// depth, acc and wout (N, S) the compositing weights
extern "C" int render_v0_feats(const void* ndc, const void* z,
                               const void* feats, const void* dirs,
                               const void* weights, void* out, void* wout,
                               int N, int S, int n_weights, void* stream) {
  if (n_weights != N_WEIGHTS || S % G != 0 || N < 1)
    return (int)cudaErrorInvalidValue;
  render_v0_kernel<0, NF, true><<<N, W, 0, (cudaStream_t)stream>>>(
      (const float*)ndc, (const float*)z, (const float*)feats,
      (const float*)dirs, nullptr, (const float*)weights, (float*)out,
      (float*)wout, S, 0, 0, 0);
  return (int)cudaGetLastError();
}
