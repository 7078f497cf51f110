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
//       gathered, no fetch; it also writes the (N, S) compositing weights
//       and, when asked (the fusion trainer's local renders), the (N, S)
//       alphas.
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
// the unfused chunked render up to f32 rounding. Not carried over: the TPU
// kernels' bf16 interpolation, CP=32 lane packing, tile windows
// (plan_tiles / pick_tile), and K8's rays_per_tile padding and
// triangular-matmul prefix sum (a warp's product scan here).
//
// Layout: a block of 256 threads (8 warps) takes a tile of 128 rows, the
// samples of 128 / S whole rays (S <= 128) or 128 samples of one ray (S >
// 128: the block walks the ray's tiles in order, carrying the compositing
// state). Per tile:
//   1. stage: threads 0-127 fetch one row's features each (the sample's
//      trilinear corners and weights once, each corner's NV channels as
//      float4s; the unnormalisation bit for bit the twin's), threads
//      128-255 its PE; the per-ray start of the views layer (bias +
//      direction term) in f32;
//   2. the MLP's products on tensor cores (csrc/mlp_tc.cuh: 3xTF32
//      `mma.sync`, f32 accumulation; every weight streamed through a
//      shared-memory ring by bulk copies, once per tile, the next tile's
//      first chunks prefetched where a ray spans tiles): warp w owns rows
//      64 (w / 4) .. + 63 and columns 32 (w % 4) .. + 31 (16 for the
//      64-wide views layer). pts_bias's output stays in registers as the
//      multiplier of layers 0-5; each layer's epilogue (x bias, ReLU) goes
//      to a shared [row][unit] buffer that the next layer reads as A. The
//      activations never touch device memory;
//   3. the heads in f32: sigma (128 -> 1) from h5, rgb (64 -> 3, sigmoid);
//   4. compositing: a warp a ray, each lane a run of consecutive samples,
//      the transmittance by a product scan across lanes.
//
// What bounds it on the H100: the MLP's 1.26e5 multiply-adds a sample, run
// three times on the tensor cores (3xTF32: 3.19 ms a 16384 x 128 chunk at
// the 495 TFLOP/s TF32 peak, against 7.87 ms at the f32 FMA peak); then
// the A fragments' shared-memory reads and splits, the weight stream (1 MB
// of L2 reads a tile, 16 GB a chunk), and the tile's staging, epilogues
// and heads, during which the tensor cores idle (one block a SM: 207 KB of
// shared memory).

#include <cuda_runtime.h>

#include "mlp_tc.cuh"

namespace {

using namespace mlp_tc;

constexpr int W = 128;   // hidden width
constexpr int NFREQ = 10;
constexpr int NPE = 3 + 2 * NFREQ * 3;  // 63
constexpr int NF = 20;                  // MLP feature inputs (pts_bias)
constexpr int WH = W / 2;               // views head width
constexpr int ROWS = 128;               // samples a tile
constexpr int THREADS = 256;            // 8 warps: 2 row halves x 4 columns
constexpr int MAX_RAYS = ROWS / 8;      // rays a tile holds (S % 8 == 0)
constexpr int LDA = W + 4;              // shared row strides (floats): the
constexpr int LDP = 64 + 4;             // A fragments' reads are free of
constexpr int LDF = 24 + 4;             // bank conflicts when stride % 32 = 4

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

struct Smem {
  float ring[NSTAGE * CHUNK];  // the weight stream (16-byte aligned)
  float act[ROWS * LDA];       // activations; the features (LDF) first
  float pe[ROWS * LDP];        // PE, 63 + a zero column
  float vinit[MAX_RAYS][WH];   // views layer: bias + direction term a ray
  float sig[ROWS], z[ROWS], rgb[ROWS][3];
  alignas(8) uint64_t bars[NSTAGE];  // the stream's barriers
};

// grid_sample(align_corners=True) unnormalisation of an NDC coordinate
__device__ __forceinline__ float unnorm(float ndc, int size) {
  const float g = __fsub_rn(__fmul_rn(ndc, 2.f), 1.f);
  return __fmul_rn(__fdiv_rn(__fadd_rn(g, 1.f), 2.f), (float)(size - 1));
}

// val[0, NV) = the trilinear zeros-padded fetch of the (D, HP, WP, NV)
// volume at NDC p: each channel sums its 8 corners in the same order and
// with the same arithmetic as the twin's coordinates give
template <int NV>
__device__ __forceinline__ void fetch(const float* __restrict__ vol,
                                      const float* p, int D, int HP, int WP,
                                      float (&val)[NF]) {
#pragma unroll
  for (int c = 0; c < NV; ++c) val[c] = 0.f;
  const float ix = unnorm(p[0], WP), iy = unnorm(p[1], HP),
              iz = unnorm(p[2], D);
  if (!(ix > -1.f && ix < (float)WP && iy > -1.f && iy < (float)HP &&
        iz > -1.f && iz < (float)D))
    return;
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
    const float4* src = reinterpret_cast<const float4*>(
        vol + (((long long)zi * HP + yi) * WP + xi) * NV);
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const float4 v = __ldg(src + q);
      val[4 * q] = fmaf(v.x, wgt, val[4 * q]);
      val[4 * q + 1] = fmaf(v.y, wgt, val[4 * q + 1]);
      val[4 * q + 2] = fmaf(v.z, wgt, val[4 * q + 2]);
      val[4 * q + 3] = fmaf(v.w, wgt, val[4 * q + 3]);
    }
  }
}

// epilogue of layers 0-5: act = relu(acc * bias), fragment by fragment
__device__ __forceinline__ void store_hidden(const float (&acc)[4][4][4],
                                             const float (&pb)[4][4][4],
                                             float* act, int row0, int nb0) {
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(frag_at(act, LDA, row0, nb0, mi, ni,
                                           2 * h)) =
            make_float2(fmaxf(acc[mi][ni][2 * h] * pb[mi][ni][2 * h], 0.f),
                        fmaxf(acc[mi][ni][2 * h + 1] * pb[mi][ni][2 * h + 1],
                              0.f));
}

// Composite rows [first, first + len) of the tile front to back, one warp:
// lane l takes a run of consecutive samples; T_in and the sums carry in
// (S > 128) and out. K8 writes each sample's weight to wout[gbase + row]
// and, where aout is not null, its alpha to aout[gbase + row].
template <bool WEIGHTS>
__device__ __forceinline__ void composite(const Smem& sm, int first, int len,
                                          float* __restrict__ wout,
                                          float* __restrict__ aout,
                                          long long gbase, float& T,
                                          float (&sum)[5]) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int per = (len + 31) / 32;
  const int s0 = min(lane * per, len), s1 = min(s0 + per, len);
  float prod = 1.f;
  for (int s = s0; s < s1; ++s) {
    const float alpha = 1.f - expf(-sm.sig[first + s]);
    prod *= fmaxf(1.f - alpha, 0.f) + 1e-10f;
  }
  float inc = prod;  // inclusive product scan over the lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc *= v;
  }
  float tr = __shfl_up_sync(FULL, inc, 1);
  tr = T * (lane == 0 ? 1.f : tr);
  float part[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = s0; s < s1; ++s) {
    const int row = first + s;
    const float alpha = 1.f - expf(-sm.sig[row]);
    const float wgt = alpha * tr;
    if (WEIGHTS) {
      wout[gbase + row] = wgt;
      if (aout != nullptr) aout[gbase + row] = alpha;
    }
    tr *= fmaxf(1.f - alpha, 0.f) + 1e-10f;
    part[0] += wgt * sm.rgb[row][0];
    part[1] += wgt * sm.rgb[row][1];
    part[2] += wgt * sm.rgb[row][2];
    part[3] += wgt * sm.z[row];
    part[4] += wgt;
  }
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1)
      part[i] += __shfl_xor_sync(FULL, part[i], o);
    sum[i] += part[i];
  }
  T = __shfl_sync(FULL, tr, 31);
}

template <int NV, int NC, bool WEIGHTS>
__global__ void __launch_bounds__(THREADS, 1)
    render_v0_kernel(const float* __restrict__ ndc,
                     const float* __restrict__ zv,
                     const float* __restrict__ feats,
                     const float* __restrict__ dirs,
                     const float* __restrict__ vol,
                     const float* __restrict__ wts,
                     const float* __restrict__ tc, float* __restrict__ out,
                     float* __restrict__ wout, float* __restrict__ aout,
                     int N, int S, int D, int HP, int WP) {
  static_assert(NV + NC == NF && NV % 4 == 0 && NC % 4 == 0,
                "the v0 MLP takes 20 feature channels, in float4s");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = 64 * (warp >> 2), wn = warp & 3;
  const bool whole = S <= ROWS;  // whole rays in a tile
  const int rpc = whole ? ROWS / S : 1;
  const int n_tiles = whole ? 1 : (S + ROWS - 1) / ROWS;
  const long long ray0 = (long long)blockIdx.x * rpc;
  const int n_rays = (int)min((long long)rpc, N - ray0);  // 1 if S > 128
  float carry_T = 1.f, carry[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // S > 128
  WeightStream ws;
  ws.init(tc, TC_TOTAL, n_tiles, sm.ring, sm.bars);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int len = whole ? S : min(ROWS, S - tile * ROWS);
    const int n_rows = whole ? n_rays * S : len;
    const long long gbase = ray0 * S + (long long)tile * ROWS;
    if (tile > 0) __syncthreads();  // the last tile's readers are done
    ws.next_pass();

    // ---- 1. stage the tile's inputs
    if (tid < ROWS) {  // features, one row a thread
      const int r = tid;
      float val[NF];
#pragma unroll
      for (int c = 0; c < NF; ++c) val[c] = 0.f;
      float z = 0.f;
      if (r < n_rows) {
        const long long gi = gbase + r;
        if (NV > 0) fetch<NV>(vol, ndc + gi * 3, D, HP, WP, val);
        if (NC > 0) {
          const float4* src = reinterpret_cast<const float4*>(feats + gi * NC);
#pragma unroll
          for (int q = 0; q < NC / 4; ++q) {
            const float4 v = __ldg(src + q);
            val[NV + 4 * q] = v.x;
            val[NV + 4 * q + 1] = v.y;
            val[NV + 4 * q + 2] = v.z;
            val[NV + 4 * q + 3] = v.w;
          }
        }
        z = zv[gi];
      }
      float4* f = reinterpret_cast<float4*>(sm.act + r * LDF);
#pragma unroll
      for (int q = 0; q < NF / 4; ++q)
        f[q] = make_float4(val[4 * q], val[4 * q + 1], val[4 * q + 2],
                           val[4 * q + 3]);
      f[NF / 4] = make_float4(0.f, 0.f, 0.f, 0.f);  // K padding 20 -> 24
      sm.z[r] = z;
    } else {  // PE, one row a thread
      const int r = tid - ROWS;
      float* p = sm.pe + r * LDP;
      if (r < n_rows) {
        const float* pn = ndc + (gbase + r) * 3;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float x = pn[i];
          p[i] = x;
          float f = 1.f;
#pragma unroll
          for (int k = 0; k < NFREQ; ++k, f *= 2.f) {
            float s, c;
            sincosf(x * f, &s, &c);
            p[3 + 3 * k + i] = s;
            p[3 + 3 * NFREQ + 3 * k + i] = c;
          }
        }
      } else {
        for (int k = 0; k < NPE; ++k) p[k] = 0.f;
      }
      p[NPE] = 0.f;  // K padding 63 -> 64
    }
    // the views layer's start a ray: bias + direction term, f32
    for (int i = tid; i < n_rays * WH; i += THREADS) {
      const int rr = i / WH, j = i % WH;
      const float* d = dirs + (ray0 + rr) * 3;
      float a = __ldg(wts + OFF_BV + j);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        a = fmaf(__ldg(wts + OFF_WV + (W + k) * WH + j), d[k], a);
      sm.vinit[rr][j] = a;
    }
    __syncthreads();

    // ---- 2. the MLP on tensor cores
    float pb[4][4][4], acc[4][4][4];
    init_cols(pb, wts + OFF_BB, 4 * wn);  // pts_bias: the multiplier
    mma_ksteps(pb, sm.act, LDF, row0, 3, ws, W, 4 * wn);
    init_cols(acc, wts + OFF_B0, 4 * wn);  // layer 0 over PE
    mma_ksteps(acc, sm.pe, LDP, row0, 8, ws, W, 4 * wn);
    __syncthreads();  // the features are read
    store_hidden(acc, pb, sm.act, row0, 4 * wn);
    __syncthreads();
    for (int l = 0; l < 4; ++l) {  // layers 1-4
      init_cols(acc, wts + OFF_W1 + l * LAYER + W * W, 4 * wn);
      mma_ksteps(acc, sm.act, LDA, row0, W / 8, ws, W, 4 * wn);
      __syncthreads();
      store_hidden(acc, pb, sm.act, row0, 4 * wn);
      __syncthreads();
    }
    init_cols(acc, wts + OFF_B5, 4 * wn);  // layer 5 over [PE | h]
    mma_ksteps(acc, sm.pe, LDP, row0, 8, ws, W, 4 * wn);
    mma_ksteps(acc, sm.act, LDA, row0, W / 8, ws, W, 4 * wn);
    __syncthreads();
    store_hidden(acc, pb, sm.act, row0, 4 * wn);
    __syncthreads();
    init_cols(acc, wts + OFF_BF, 4 * wn);  // feature_linear
    mma_ksteps(acc, sm.act, LDA, row0, W / 8, ws, W, 4 * wn);
    {  // sigma from h5, f32: two threads a row
      const int r = tid >> 1, h = tid & 1;
      const float* hr = sm.act + r * LDA + WH * h;
      const float* wa = wts + OFF_WA + WH * h;
      float s = 0.f;
#pragma unroll 8
      for (int k = 0; k < WH; ++k) s = fmaf(__ldg(wa + k), hr[k], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (h == 0) sm.sig[r] = fmaxf(s + __ldg(wts + OFF_BA), 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              frag_at(sm.act, LDA, row0, 4 * wn, mi, ni, 2 * h)) =
              make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
    __syncthreads();
    float av[4][2][4];  // views layer: the ray's start + feature term
    {
      const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 16 * mi + g + 8 * (e >> 1);
          const int rr = whole ? row / S : 0;
#pragma unroll
          for (int ni = 0; ni < 2; ++ni)
            av[mi][ni][e] = sm.vinit[rr][16 * wn + 8 * ni + 2 * t + (e & 1)];
        }
    }
    mma_ksteps(av, sm.act, LDA, row0, W / 8, ws, WH, 2 * wn);
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<float2*>(
              frag_at(sm.act, LDA, row0, 2 * wn, mi, ni, 2 * h)) =
              make_float2(fmaxf(av[mi][ni][2 * h], 0.f),
                          fmaxf(av[mi][ni][2 * h + 1], 0.f));
    __syncthreads();

    // ---- 3. rgb head, f32
    for (int i = tid; i < ROWS * 3; i += THREADS) {
      const int r = i / 3, c = i % 3;
      const float* hr = sm.act + r * LDA;
      float v = __ldg(wts + OFF_BR + c);
#pragma unroll 8
      for (int k = 0; k < WH; ++k)
        v = fmaf(__ldg(wts + OFF_WR + k * 3 + c), hr[k], v);
      sm.rgb[r][c] = 1.f / (1.f + expf(-v));
    }
    __syncthreads();

    // ---- 4. front-to-back compositing, a warp a ray
    for (int rr = warp; rr < n_rays; rr += THREADS / 32) {
      float T = whole ? 1.f : carry_T;
      float sum[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) sum[i] = whole ? 0.f : carry[i];
      composite<WEIGHTS>(sm, whole ? rr * S : 0, len, wout, aout, gbase, T,
                         sum);
      if (!whole) {
        carry_T = T;
#pragma unroll
        for (int i = 0; i < 5; ++i) carry[i] = sum[i];
      }
      if (tile == n_tiles - 1 && (tid & 31) == 0) {
        float* o = out + (ray0 + rr) * 5;
#pragma unroll
        for (int i = 0; i < 5; ++i) o[i] = sum[i];
      }
    }
  }
}

template <int NV, int NC, bool WEIGHTS>
int launch(const float* ndc, const float* z, const float* feats,
           const float* dirs, const float* vol, const float* wts,
           const float* tc, float* out, float* wout, float* aout, int N,
           int S, int D, int HP, int WP, cudaStream_t st) {
  auto kernel = render_v0_kernel<NV, NC, WEIGHTS>;
  static bool ready = false;  // the shared-memory opt-in, once a form
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int rpc = S <= ROWS ? ROWS / S : 1;
  const long long grid = ((long long)N + rpc - 1) / rpc;
  kernel<<<(unsigned)grid, THREADS, sizeof(Smem), st>>>(
      ndc, z, feats, dirs, vol, wts, tc, out, wout, aout, N, S, D, HP, WP);
  return (int)cudaGetLastError();
}

bool args_ok(int n_weights, int n_tc, int N, int S) {
  return n_weights == N_WEIGHTS && n_tc == TC_TOTAL && S % 8 == 0 && S > 0 &&
         N > 0;
}

}  // namespace

// K6 (colors given, C = 8) or K6b (colors null, the baked C = 20 volume);
// weights: the f32 pack (pack_v0_weights), tc: its tensor-core stream
// (pack_v0_weights_tc); out (N, 5) = rgb, depth, acc
extern "C" int render_v0(const void* ndc, const void* z, const void* colors,
                         const void* dirs, const void* vol,
                         const void* weights, const void* tc, void* out,
                         int N, int S, int D, int HP, int WP, int C,
                         int n_weights, int n_tc, void* stream) {
  if (!args_ok(n_weights, n_tc, N, S)) return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  if (colors != nullptr && C == 8)
    return launch<8, 12, false>(
        (const float*)ndc, (const float*)z, (const float*)colors,
        (const float*)dirs, (const float*)vol, (const float*)weights,
        (const float*)tc, (float*)out, nullptr, nullptr, N, S, D, HP, WP,
        st);
  if (colors == nullptr && C == NF)
    return launch<NF, 0, false>(
        (const float*)ndc, (const float*)z, nullptr, (const float*)dirs,
        (const float*)vol, (const float*)weights, (const float*)tc,
        (float*)out, nullptr, nullptr, N, S, D, HP, WP, st);
  return (int)cudaErrorInvalidValue;
}

// K8: the 20 features of every sample gathered already; out (N, 5) = rgb,
// depth, acc, wout (N, S) the compositing weights and aout (N, S), or null,
// the alphas
extern "C" int render_v0_feats(const void* ndc, const void* z,
                               const void* feats, const void* dirs,
                               const void* weights, const void* tc,
                               void* out, void* wout, void* aout, int N,
                               int S, int n_weights, int n_tc, void* stream) {
  if (!args_ok(n_weights, n_tc, N, S)) return (int)cudaErrorInvalidValue;
  return launch<0, NF, true>((const float*)ndc, (const float*)z,
                             (const float*)feats, (const float*)dirs, nullptr,
                             (const float*)weights, (const float*)tc,
                             (float*)out, (float*)wout, (float*)aout, N, S, 0,
                             0, 0, (cudaStream_t)stream);
}

// the body's dynamic shared memory a block, bytes (one block a SM)
extern "C" int render_v0_smem_bytes() { return (int)sizeof(Smem); }
