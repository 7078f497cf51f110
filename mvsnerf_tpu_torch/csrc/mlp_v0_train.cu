// K7: the v0 NeRF MLP for training steps, forward and backward, on the
// H100's tensor cores.
//
// Replaces the TPU kernel mvsnerf_tpu/ops/pallas_mlp.py:318 `mlp_v0_train`
// (forward `_fwd_kernel`, pallas_call :296; backward `_bwd_kernel`,
// pallas_call :346). The maths is JAX's `_forward` (:89-109) and its
// backward (:128-188):
//   bias = Wb.feats + bb;  pre_i = W_i.h + b_i;  h_i = relu(pre_i * bias)
//   (the ReLU mask comes from pre_i * bias, not pre_i); layer 5 reads
//   [PE | h4]; alpha = relu(Wa.h5 + ba); feat = Wf.h5 + bf;
//   hv = relu(Wv.[feat | viewdirs] + bv); rgb = sigmoid(Wr.hv + br);
//   d bias = sum_i dt_i * pre_i over the six trunk layers;
//   d feats = d bias . Wb^T.
// Gradient contract as in JAX: exact dW, db and d feats; the PE and
// view-direction slices of dx are written as zeros. Float32-equivalent
// throughout: the TPU kernel's `precision="default"` (one bf16 MXU pass
// per dot) and its 13 x 128 x 128 lane packing are TPU choices.
//
// Design. Every product with a hidden-width operand runs in 3xTF32 on
// `mma.sync` (csrc/mlp_tc.cuh: lo.hi + hi.lo + hi.hi), each k-step's three
// passes into a zeroed fragment that is then added to the f32 sum
// (`mma_ksteps<true>`: the tensor core's own accumulation truncates, which
// over long sums biases the gradients past their tolerance). The heads
// (alpha, rgb, the views layer's direction term) and every elementwise
// step stay f32.
//   mlp_pack_kernel   the packed f32 weights -> the forward stream (K6's,
//                     `pack_v0_weights_tc`) and the transposed stream of
//                     the backward (`pack_v0_weights_tct`), split into
//                     TF32 hi/lo once a call (the trainer's weights change
//                     every step);
//   mlp_fwd_kernel    128 samples a block, the render body's MLP tile: the
//                     weights streamed by bulk copies, activations in
//                     shared memory. It saves, per sample, only what the
//                     backward cannot rebuild elementwise: bias, pre_0..5,
//                     feat, pre_v, pre_a, pre_r (ST_ROWS = 1092 floats; h_i
//                     is relu(pre_i * bias) and hv relu(pre_v), rebuilt
//                     where read; PE, feats and dirs are read from x),
//                     as [row][sample] rows of each 128-sample tile;
//   mlp_delta_kernel  128 samples a block: the heads' deltas in f32, then
//                     d feat, d h5 .. d h0 and d feats as products with
//                     the transposed stream, each masked by pre * bias;
//                     d bias stays in registers over the six layers.
//                     Writes the deltas the dW products read (same rows as
//                     the state), the tile's sums of the heads' 516 weight
//                     gradients (f32), and whole dx rows;
//   mlp_dw_kernel     dW = sum over samples of input^T . delta per layer,
//                     the input rows rebuilt and both operands split into
//                     hi/lo once as a chunk of 32 samples is staged in
//                     shared memory (the next chunk's loads in flight
//                     during the products), never again in an `mma`. Each
//                     block takes one layer's output tile and a fixed
//                     sample range (ranges per layer in proportion to its
//                     bytes and products: 33 x n_splits blocks, one wave);
//                     db sums the f32 deltas as they are staged; one more
//                     job sums the heads' tile sums;
//   mlp_dw_reduce     sums each weight's sample ranges in order. No
//                     atomics anywhere: dW is deterministic.
// Recomputing the forward inside the backward, as the TPU kernel does,
// would need all six pre-activations of a 128-sample tile at once while
// the deltas walk back (458 KB, twice a block's shared memory).
//
// What bounds it on the H100: the products, 3 x 2 x 125,476 multiply-adds
// a sample forward and twice that backward, at the 495 TFLOP/s TF32 peak
// (0.20 ms forward, 0.40 ms backward at 131,072 samples), and the state
// and delta traffic (4.4 KB a sample written by the forward, read by the
// delta kernel, which writes ~4.3 KB of deltas; ~12 KB a sample read by
// the dW kernel), ~3.2 GB at 131,072 samples, ~0.97 ms at 3.35 TB/s.

#include <cuda_runtime.h>

#include "mlp_tc.cuh"

namespace {

using namespace mlp_tc;

constexpr int W = 128;          // hidden width
constexpr int WH = W / 2;       // views head width
constexpr int NPE = 63, NF = 20, NVD = 3, NX = NPE + NF + NVD;  // 86
constexpr int ROWS = 128;       // samples a tile
constexpr int THREADS = 256;    // 8 warps: 2 row halves x 4 column quarters
constexpr int LDA = W + 4;      // shared row strides (floats), % 32 == 4:
constexpr int LDP = 64 + 4;     // the A fragments' reads are free of bank
constexpr int LDF = 24 + 4;     // conflicts

// packed layout: each layer's (in, out) matrix row-major, then its bias
// (render_v0.cu's order, `pack_v0_weights`)
constexpr int OFF_W0 = 0;                         // pts_linears.0 (63, 128)
constexpr int OFF_B0 = OFF_W0 + NPE * W;
constexpr int OFF_WB = OFF_B0 + W;                // pts_bias (20, 128)
constexpr int OFF_BB = OFF_WB + NF * W;
constexpr int OFF_W1 = OFF_BB + W;                // pts_linears.1-4
constexpr int LAYER = W * W + W;
constexpr int OFF_W5 = OFF_W1 + 4 * LAYER;        // pts_linears.5 (191, 128)
constexpr int OFF_B5 = OFF_W5 + (NPE + W) * W;
constexpr int OFF_WA = OFF_B5 + W;                // alpha_linear (128, 1)
constexpr int OFF_BA = OFF_WA + W;
constexpr int OFF_WF = OFF_BA + 1;                // feature_linear (128, 128)
constexpr int OFF_BF = OFF_WF + W * W;
constexpr int OFF_WV = OFF_BF + W;                // views_linears.0 (131, 64)
constexpr int OFF_BV = OFF_WV + (W + NVD) * WH;
constexpr int OFF_WR = OFF_BV + WH;               // rgb_linear (64, 3)
constexpr int OFF_BR = OFF_WR + WH * 3;
constexpr int N_WEIGHTS = OFF_BR + 3;

// the saved state of a tile, in rows of ROWS samples; the deltas use the
// same rows for the gradient of each (d bias, d pre_0..5, ...)
constexpr int ST_BIAS = 0;               // bias
constexpr int ST_PRE = ST_BIAS + W;      // pre_0 .. pre_5
constexpr int ST_FEAT = ST_PRE + 6 * W;  // feat
constexpr int ST_PREV = ST_FEAT + W;     // views pre-activation (64)
constexpr int ST_PREA = ST_PREV + WH;    // alpha pre-activation
constexpr int ST_PRER = ST_PREA + 1;     // rgb pre-activations (3)
constexpr int ST_ROWS = ST_PRER + 3;     // 1092 floats a sample
constexpr long long TILE = (long long)ST_ROWS * ROWS;
static_assert(ST_ROWS == 1092, "the saved state");

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }
__device__ __forceinline__ float sigmoid(float v) {
  return 1.f / (1.f + expf(-v));
}

// ---------------------------------------------------------------- pack ----

// One layer of a stream: its padded (K, N) matrix M read from the packed
// vector. Forward: M[k][n] = w[src + row(k) * N + n]; transposed:
// M[k][n] = w[src + row(n) * K + k]. row(r) = r + base for r < a, -1 (a
// zero) for the p rows after, then r - p + base.
struct PackLayer {
  int off, K, N, src, a, p, base, trans;
};
constexpr int N_PACK = 17;
__constant__ PackLayer PACK[N_PACK] = {
    {TC_PTS_BIAS, 24, W, OFF_WB, NF, 4, 0, 0},
    {TC_PTS_0, 64, W, OFF_W0, NPE, 1, 0, 0},
    {TC_PTS_1, W, W, OFF_W1, W, 0, 0, 0},
    {TC_PTS_2, W, W, OFF_W1 + LAYER, W, 0, 0, 0},
    {TC_PTS_3, W, W, OFF_W1 + 2 * LAYER, W, 0, 0, 0},
    {TC_PTS_4, W, W, OFF_W1 + 3 * LAYER, W, 0, 0, 0},
    {TC_PTS_5, 192, W, OFF_W5, NPE, 1, 0, 0},
    {TC_FEATURE, W, W, OFF_WF, W, 0, 0, 0},
    {TC_VIEWS, W, WH, OFF_WV, W, 0, 0, 0},
    {TC_TOTAL + TCT_VIEWS, WH, W, OFF_WV, W, 0, 0, 1},
    {TC_TOTAL + TCT_FEATURE, W, W, OFF_WF, W, 0, 0, 1},
    {TC_TOTAL + TCT_PTS_5, W, W, OFF_W5, W, 0, NPE, 1},
    {TC_TOTAL + TCT_PTS_4, W, W, OFF_W1 + 3 * LAYER, W, 0, 0, 1},
    {TC_TOTAL + TCT_PTS_3, W, W, OFF_W1 + 2 * LAYER, W, 0, 0, 1},
    {TC_TOTAL + TCT_PTS_2, W, W, OFF_W1 + LAYER, W, 0, 0, 1},
    {TC_TOTAL + TCT_PTS_1, W, W, OFF_W1, W, 0, 0, 1},
    {TC_TOTAL + TCT_PTS_BIAS, W, 24, OFF_WB, NF, 4, 0, 1}};
constexpr int STREAMS = TC_TOTAL + TCT_TOTAL;

__device__ __forceinline__ float pack_at(const float* __restrict__ w,
                                         const PackLayer& L, int k, int n) {
  const int r = L.trans ? n : k, c = L.trans ? k : n;
  const int row = r < L.a ? r + L.base
                          : (r < L.a + L.p ? -1 : r - L.p + L.base);
  return row < 0 ? 0.f : __ldg(w + L.src + row * (L.trans ? L.K : L.N) + c);
}

// one lane's {b0 hi, b1 hi, b0 lo, b1 lo} a thread, as
// `pack_v0_weights_tc` lays them out (csrc/mlp_tc.cuh)
__global__ void mlp_pack_kernel(const float* __restrict__ w,
                                float* __restrict__ streams) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= STREAMS / 4) return;
  int i = 0;
  while (i + 1 < N_PACK && PACK[i + 1].off <= 4 * q) ++i;
  const PackLayer L = PACK[i];
  const int s = q - L.off / 4, per_k = (L.N / 8) * 32;
  const int kb = s / per_k, nb = (s % per_k) / 32, lane = s % 32;
  const int g = lane >> 2, t = lane & 3;
  const float b0 = pack_at(w, L, 8 * kb + t, 8 * nb + g);
  const float b1 = pack_at(w, L, 8 * kb + t + 4, 8 * nb + g);
  const float h0 = __uint_as_float(tf32_rna(b0));
  const float h1 = __uint_as_float(tf32_rna(b1));
  reinterpret_cast<float4*>(streams)[q] =
      make_float4(h0, h1, __uint_as_float(tf32_rna(b0 - h0)),
                  __uint_as_float(tf32_rna(b1 - h1)));
}

// ------------------------------------------------------------- forward ----

struct FwdSmem {
  float ring[NSTAGE * CHUNK];  // the weight stream (16-byte aligned)
  float act[ROWS * LDA];       // activations; the features (LDF) first
  float pe[ROWS * LDP];        // PE, 63 + a zero column
  float dirs[ROWS][NVD];
  float prea[ROWS];
  float prer[ROWS][3];
  alignas(8) uint64_t bars[NSTAGE];
};

// fragment (mi, ni, e) of acc to rows [col][sample] of a state tile
template <int MT, int NT>
__device__ __forceinline__ void store_rows(float* __restrict__ S,
                                           const float (&acc)[MT][NT][4],
                                           int row0, int nb0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        S[(8 * (nb0 + ni) + 2 * t + (e & 1)) * ROWS + row0 + 16 * mi + g +
          8 * (e >> 1)] = acc[mi][ni][e];
}

// the fragments to the shared [row][unit] matrix A, after f
template <int MT, int NT, class F>
__device__ __forceinline__ void store_act(float* A, int lda,
                                          const float (&acc)[MT][NT][4],
                                          int row0, int nb0, F f) {
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(
            frag_at(A, lda, row0, nb0, mi, ni, 2 * h)) =
            make_float2(f(acc[mi][ni][2 * h], mi, ni, 2 * h),
                        f(acc[mi][ni][2 * h + 1], mi, ni, 2 * h + 1));
}

// the forward of one 128-sample tile; with `save`, its state to S
__global__ void __launch_bounds__(THREADS, 1)
    mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ tc, float* __restrict__ out,
                   int N, float* __restrict__ state, int save) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int row0 = 64 * (warp >> 2), nb0 = 4 * (warp & 3);
  const long long base = (long long)blockIdx.x * ROWS;
  float* S = state + blockIdx.x * TILE;
  WeightStream ws;
  ws.init(tc, TC_TOTAL, 1, sm.ring, sm.bars);

  for (int i = tid; i < ROWS * NX; i += THREADS) {  // x, coalesced
    const int r = i / NX, c = i % NX;
    const float v = base + r < N ? x[base * NX + i] : 0.f;
    if (c < NPE)
      sm.pe[r * LDP + c] = v;
    else if (c < NPE + NF)
      sm.act[r * LDF + c - NPE] = v;
    else
      sm.dirs[r][c - NPE - NF] = v;
  }
  if (tid < ROWS) {  // K padding: 63 -> 64, 20 -> 24
    sm.pe[tid * LDP + NPE] = 0.f;
    *reinterpret_cast<float4*>(sm.act + tid * LDF + NF) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  float pb[4][4][4], acc[4][4][4];
  const auto hidden = [&pb](float v, int mi, int ni, int e) {
    return relu(v * pb[mi][ni][e]);
  };
  init_cols(pb, w + OFF_BB, nb0);  // pts_bias: the multiplier
  mma_ksteps<true>(pb, sm.act, LDF, row0, 3, ws, W, nb0);
  init_cols(acc, w + OFF_B0, nb0);  // layer 0 over PE
  mma_ksteps<true>(acc, sm.pe, LDP, row0, 8, ws, W, nb0);
  if (save) {
    store_rows(S + ST_BIAS * ROWS, pb, row0, nb0);
    store_rows(S + ST_PRE * ROWS, acc, row0, nb0);
  }
  __syncthreads();  // the features are read
  store_act(sm.act, LDA, acc, row0, nb0, hidden);
  __syncthreads();
  for (int l = 1; l <= 4; ++l) {
    init_cols(acc, w + OFF_W1 + (l - 1) * LAYER + W * W, nb0);
    mma_ksteps<true>(acc, sm.act, LDA, row0, W / 8, ws, W, nb0);
    if (save) store_rows(S + (ST_PRE + l * W) * ROWS, acc, row0, nb0);
    __syncthreads();
    store_act(sm.act, LDA, acc, row0, nb0, hidden);
    __syncthreads();
  }
  init_cols(acc, w + OFF_B5, nb0);  // layer 5 over [PE | h4]
  mma_ksteps<true>(acc, sm.pe, LDP, row0, 8, ws, W, nb0);
  mma_ksteps<true>(acc, sm.act, LDA, row0, W / 8, ws, W, nb0);
  if (save) store_rows(S + (ST_PRE + 5 * W) * ROWS, acc, row0, nb0);
  __syncthreads();
  store_act(sm.act, LDA, acc, row0, nb0, hidden);
  __syncthreads();
  init_cols(acc, w + OFF_BF, nb0);  // feature_linear
  mma_ksteps<true>(acc, sm.act, LDA, row0, W / 8, ws, W, nb0);
  if (save) store_rows(S + ST_FEAT * ROWS, acc, row0, nb0);
  {  // alpha's pre-activation from h5, f32: two threads a row
    const int r = tid >> 1, h = tid & 1;
    const float* hr = sm.act + r * LDA + WH * h;
    const float* wa = w + OFF_WA + WH * h;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < WH; ++k) s = fmaf(__ldg(wa + k), hr[k], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (h == 0) sm.prea[r] = s + __ldg(w + OFF_BA);
  }
  __syncthreads();
  store_act(sm.act, LDA, acc, row0, nb0,
            [](float v, int, int, int) { return v; });
  __syncthreads();
  // views layer: bias + the direction term in f32, then feat on the cores
  float av[4][2][4];
  {
    const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = 8 * (2 * (warp & 3) + ni) + 2 * t + c;
        const float b = __ldg(w + OFF_BV + col);
        const float d0 = __ldg(w + OFF_WV + W * WH + col);
        const float d1 = __ldg(w + OFF_WV + (W + 1) * WH + col);
        const float d2 = __ldg(w + OFF_WV + (W + 2) * WH + col);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float* dr = sm.dirs[row0 + 16 * mi + g + 8 * hh];
            av[mi][ni][2 * hh + c] =
                fmaf(d2, dr[2], fmaf(d1, dr[1], fmaf(d0, dr[0], b)));
          }
      }
  }
  mma_ksteps<true>(av, sm.act, LDA, row0, W / 8, ws, WH, 2 * (warp & 3));
  if (save) store_rows(S + ST_PREV * ROWS, av, row0, 2 * (warp & 3));
  __syncthreads();
  store_act(sm.act, LDA, av, row0, 2 * (warp & 3),
            [](float v, int, int, int) { return relu(v); });
  __syncthreads();
  for (int i = tid; i < ROWS * 3; i += THREADS) {  // rgb head, f32
    const int r = i / 3, c = i % 3;
    const float* hr = sm.act + r * LDA;
    float v = __ldg(w + OFF_BR + c);
#pragma unroll 8
    for (int k = 0; k < WH; ++k)
      v = fmaf(__ldg(w + OFF_WR + k * 3 + c), hr[k], v);
    sm.prer[r][c] = v;
  }
  __syncthreads();
  for (int i = tid; i < ROWS * 4; i += THREADS) {
    const int r = i / 4, c = i % 4;
    if (base + r < N)
      out[base * 4 + i] = c < 3 ? sigmoid(sm.prer[r][c]) : relu(sm.prea[r]);
  }
  if (save)
    for (int i = tid; i < ROWS * 4; i += THREADS) {
      const int c = i / ROWS, r = i % ROWS;
      S[(ST_PREA + c) * ROWS + r] = c == 0 ? sm.prea[r] : sm.prer[r][c - 1];
    }
}

// ------------------------------------------------------------- deltas ----

// the heads' weight gradients of one tile (f32, summed over its samples
// by mlp_delta_kernel; over the tiles by mlp_dw_kernel): alpha's weights
// and bias, rgb's weights and biases, views_linears.0's direction rows, in
// the packed order of each
constexpr int HD_WA = 0, HD_WR = W + 1, HD_WV = HD_WR + WH * 3 + 3,
              HEADS = HD_WV + NVD * WH;  // 516

struct DeltaSmem {
  float ring[NSTAGE * CHUNK];
  float act[ROWS * LDA];  // hv [sample][64] (LDP); then the A operand: d
                          // feat, d pre_5 .. d pre_1, d bias
  float dv[ROWS * LDP];   // d pre_v [sample][64]; then d feats
  float g[ROWS][4];
  float dprea[ROWS];
  float dprer[ROWS][3];
  float dirs[ROWS][NVD];
  float colsum[2][W];     // alpha's weight gradient by row half
  alignas(8) uint64_t bars[NSTAGE];
};

// Every delta of one 128-sample tile from its state, to D; the heads'
// weight gradients of the tile, to H; dx rows.
__global__ void __launch_bounds__(THREADS, 1)
    mlp_delta_kernel(const float* __restrict__ gout,
                     const float* __restrict__ x,
                     const float* __restrict__ w,
                     const float* __restrict__ tct,
                     const float* __restrict__ state,
                     float* __restrict__ delta, float* __restrict__ heads,
                     float* __restrict__ dx, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DeltaSmem& sm = *reinterpret_cast<DeltaSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row0 = 64 * (warp >> 2), nb0 = 4 * (warp & 3);
  const long long base = (long long)blockIdx.x * ROWS;
  const float* S = state + blockIdx.x * TILE;
  float* D = delta + blockIdx.x * TILE;
  float* H = heads + (long long)blockIdx.x * HEADS;
  WeightStream ws;
  ws.init(tct, TCT_TOTAL, 1, sm.ring, sm.bars);

  for (int i = tid; i < ROWS * 4; i += THREADS)
    sm.g[i / 4][i % 4] = base + i / 4 < N ? gout[base * 4 + i] : 0.f;
  for (int i = tid; i < ROWS * NVD; i += THREADS)
    sm.dirs[i / NVD][i % NVD] =
        base + i / NVD < N ? x[(base + i / NVD) * NX + NPE + NF + i % NVD]
                           : 0.f;
  __syncthreads();
  // ---- the heads, f32: d pre_r, d pre_a
  for (int i = tid; i < ROWS * 4; i += THREADS) {
    const int c = i / ROWS, r = i % ROWS;
    float v;
    if (c < 3) {
      const float s = sigmoid(S[(ST_PRER + c) * ROWS + r]);
      v = sm.g[r][c] * s * (1.f - s);
      sm.dprer[r][c] = v;
    } else {
      v = S[ST_PREA * ROWS + r] > 0.f ? sm.g[r][3] : 0.f;
      sm.dprea[r] = v;
    }
  }
  __syncthreads();
  // ---- d pre_v = mask(Wr . d pre_r), f32
  for (int i = tid; i < WH * ROWS; i += THREADS) {
    const int k = i / ROWS, r = i % ROWS;
    float d = __ldg(w + OFF_WR + k * 3) * sm.dprer[r][0];
    d = fmaf(__ldg(w + OFF_WR + k * 3 + 1), sm.dprer[r][1], d);
    d = fmaf(__ldg(w + OFF_WR + k * 3 + 2), sm.dprer[r][2], d);
    const float pv = S[(ST_PREV + k) * ROWS + r];
    d = pv > 0.f ? d : 0.f;
    sm.dv[r * LDP + k] = d;
    sm.act[r * LDP + k] = relu(pv);  // hv
    D[(ST_PREV + k) * ROWS + r] = d;
  }
  __syncthreads();
  // ---- the heads' weight gradients over the tile, f32 (alpha's weights
  // below, from h5): rgb's hv x d pre_r, the direction rows' dirs x
  // d pre_v, and the biases
  for (int o = W + tid; o < HEADS; o += THREADS) {
    float s = 0.f;
    if (o == HD_WA + W)
      for (int r = 0; r < ROWS; ++r) s += sm.dprea[r];
    else if (o < HD_WV - 3) {
      const int k = (o - HD_WR) / 3, c = (o - HD_WR) % 3;
      for (int r = 0; r < ROWS; ++r)
        s = fmaf(sm.act[r * LDP + k], sm.dprer[r][c], s);
    } else if (o < HD_WV) {
      for (int r = 0; r < ROWS; ++r) s += sm.dprer[r][o - (HD_WV - 3)];
    } else {
      const int k = (o - HD_WV) / WH, j = (o - HD_WV) % WH;
      for (int r = 0; r < ROWS; ++r)
        s = fmaf(sm.dirs[r][k], sm.dv[r * LDP + j], s);
    }
    H[o] = s;
  }
  __syncthreads();  // hv is read

  // ---- d feat = d pre_v . Wv[:128]^T
  float acc[4][4][4] = {}, dbias[4][4][4] = {};
  mma_ksteps<true>(acc, sm.dv, LDP, row0, WH / 8, ws, W, nb0);
  store_rows(D + ST_FEAT * ROWS, acc, row0, nb0);
  store_act(sm.act, LDA, acc, row0, nb0,
            [](float v, int, int, int) { return v; });
  __syncthreads();

  // ---- d h5 = d feat . Wf^T + Wa d pre_a, then layers 5 .. 0: the mask
  // of pre_l * bias, d pre_l = dt * bias, d bias += dt * pre_l, and
  // (l > 0) d h_{l-1} = d pre_l . W_l^T (layer 5: its h rows only)
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float wa = __ldg(w + OFF_WA + 8 * (nb0 + ni) + 2 * t4 + c);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          acc[mi][ni][2 * hh + c] =
              wa * sm.dprea[row0 + 16 * mi + g8 + 8 * hh];
    }
  mma_ksteps<true>(acc, sm.act, LDA, row0, W / 8, ws, W, nb0);
  for (int l = 5; l >= 0; --l) {
    const float* pre = S + (ST_PRE + l * W) * ROWS;
    const float* bs = S + ST_BIAS * ROWS;
    float ca[4][2] = {};  // l = 5: alpha's weight gradient, h5 x d pre_a
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row0 + 16 * mi + g8 + 8 * (e >> 1);
          const int at = (8 * (nb0 + ni) + 2 * t4 + (e & 1)) * ROWS + row;
          const float p = pre[at], b = bs[at];
          const float dt = p * b > 0.f ? acc[mi][ni][e] : 0.f;
          dbias[mi][ni][e] = fmaf(dt, p, dbias[mi][ni][e]);
          acc[mi][ni][e] = dt * b;
          if (l == 5)
            ca[ni][e & 1] = fmaf(relu(p * b), sm.dprea[row], ca[ni][e & 1]);
        }
    if (l == 5) {  // sum the rows of each column: the lanes, the halves
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = ca[ni][c];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g8 == 0) sm.colsum[warp >> 2][8 * (nb0 + ni) + 2 * t4 + c] = v;
        }
    }
    store_rows(D + (ST_PRE + l * W) * ROWS, acc, row0, nb0);
    if (l == 0) break;
    __syncthreads();  // every warp is done reading act
    if (l == 5 && tid < W) H[HD_WA + tid] = sm.colsum[0][tid] +
                                            sm.colsum[1][tid];
    store_act(sm.act, LDA, acc, row0, nb0,
              [](float v, int, int, int) { return v; });
    __syncthreads();
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    mma_ksteps<true>(acc, sm.act, LDA, row0, W / 8, ws, W, nb0);
  }

  // ---- d feats = d bias . Wb^T (N 24: warp w takes rows 16 w .. + 15)
  store_rows(D + ST_BIAS * ROWS, dbias, row0, nb0);
  __syncthreads();
  store_act(sm.act, LDA, dbias, row0, nb0,
            [](float v, int, int, int) { return v; });
  __syncthreads();
  float df[1][3][4] = {};
  mma_ksteps<true>(df, sm.act, LDA, 16 * warp, W / 8, ws, 24, 0);
  store_act(sm.dv, LDP, df, 16 * warp, 0,
            [](float v, int, int, int) { return v; });
  __syncthreads();
  for (int i = tid; i < ROWS * NX; i += THREADS) {  // whole dx rows
    const int r = i / NX, c = i % NX;
    if (base + r < N)
      dx[base * NX + i] =
          c >= NPE && c < NPE + NF ? sm.dv[r * LDP + c - NPE] : 0.f;
  }
}

// ----------------------------------------------------------------- dW ----

constexpr int CK = 32;       // samples a staged chunk
constexpr int LDK = CK + 4;  // shared row stride, % 32 == 4
constexpr int N_UNITS = 33;  // blocks a sample range (x n_splits)

// input rows of a dW job (HEAD_SUMS: none, it sums the tiles' head
// gradients)
enum Kind { FEATS, PE, HID, FEAT, HEAD_SUMS };
// a dW job: input `kind` (HID: h_l = relu(pre_l * bias)), `rows` real
// input rows, delta rows [d, d + n), its share of blocks, the packed
// offset p of its (rows, n) block (row stride n) and of its bias (-1:
// none)
struct Job {
  int kind, l, rows, d, n, units, p, bias;
};
constexpr int N_JOBS = 11;
__constant__ Job JOBS[N_JOBS] = {
    {FEATS, 0, NF, ST_BIAS, W, 2, OFF_WB, OFF_BB},
    {PE, 0, NPE, ST_PRE, W, 2, OFF_W0, OFF_B0},
    {HID, 0, W, ST_PRE + W, W, 4, OFF_W1, OFF_W1 + W * W},
    {HID, 1, W, ST_PRE + 2 * W, W, 4, OFF_W1 + LAYER, OFF_W1 + LAYER + W * W},
    {HID, 2, W, ST_PRE + 3 * W, W, 4, OFF_W1 + 2 * LAYER,
     OFF_W1 + 2 * LAYER + W * W},
    {HID, 3, W, ST_PRE + 4 * W, W, 4, OFF_W1 + 3 * LAYER,
     OFF_W1 + 3 * LAYER + W * W},
    {PE, 0, NPE, ST_PRE + 5 * W, W, 2, OFF_W5, OFF_B5},
    {HID, 4, W, ST_PRE + 5 * W, W, 4, OFF_W5 + NPE * W, -1},
    {HID, 5, W, ST_FEAT, W, 4, OFF_WF, OFF_BF},
    {FEAT, 0, W, ST_PREV, WH, 2, OFF_WV, OFF_BV},
    {HEAD_SUMS, 0, 0, 0, 0, 1, 0, -1}};

// packed ranges -> the units of the job that writes them (mlp_dw_reduce)
struct Range {
  int begin, units;
};
constexpr int N_RANGES = 13;
__constant__ Range RANGES[N_RANGES] = {
    {OFF_W0, 2},           {OFF_WB, 2},
    {OFF_W1, 4},           {OFF_W5, 2},
    {OFF_W5 + NPE * W, 4}, {OFF_B5, 2},
    {OFF_WA, 1},           {OFF_WF, 4},
    {OFF_WV, 2},           {OFF_WV + W * WH, 1},
    {OFF_BV, 2},           {OFF_WR, 1},
    {N_WEIGHTS, 0}};

// the staged chunk: input rows [row][sample] hi, lo, then delta rows
// [n][sample] hi, lo (ROWS x LDK floats each)
struct DwSmem {
  float buf[4 * ROWS * LDK];
  __device__ float* ah() { return buf; }
  __device__ float* al() { return buf + ROWS * LDK; }
  __device__ float* dh() { return buf + 2 * ROWS * LDK; }
  __device__ float* dl() { return buf + 3 * ROWS * LDK; }
};

__device__ __forceinline__ void split4(float4 v, float* hi, float* lo) {
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *reinterpret_cast<float4*>(hi) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// One tensor-core job over sample tiles [t0, t1): input rows (32 MT) x
// delta rows (32 NT), warp (row half, column quarter) owning 16 MT x 8 NT.
template <int KIND, int MT, int NT>
__device__ void dw_job(DwSmem& sm, const Job& jb, const float* __restrict__ x,
                       const float* __restrict__ state,
                       const float* __restrict__ delta, int N, int t0,
                       int t1, float* __restrict__ P) {
  constexpr int XR = KIND == FEATS ? NF : NPE;  // the x columns read
  constexpr int XL = (CK * XR + THREADS - 1) / THREADS;  // x loads a thread
  constexpr int AQ = KIND == HID || KIND == FEAT ? MT : 0;  // float4 loads
  constexpr int DQ = NT;  // delta float4 loads a thread (n = 32 NT)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = (warp >> 2) * 16 * MT, nb0 = (warp & 3) * NT;
  const int c0 = KIND == FEATS ? NPE : 0;  // first x column of the rows
  float *sah = sm.ah(), *sal = sm.al(), *sdh = sm.dh(), *sdl = sm.dl();
  for (int i = tid; i < ROWS * LDK; i += THREADS) {  // the zero rows
    sah[i] = 0.f;
    sal[i] = 0.f;
  }
  float acc[MT][NT][4] = {}, bsum[DQ] = {};
  float xv[XL];
  float4 av[AQ > 0 ? AQ : 1], bv[AQ > 0 ? AQ : 1], dv[DQ];

  const auto load = [&](int c) {  // chunk c: tile c / 4, quarter c % 4
    const long long tile = c >> 2;
    const int s0 = (c & 3) * CK;
    const float* S = state + tile * TILE;
    const float* Dt = delta + tile * TILE;
    if (KIND == FEATS || KIND == PE) {
      const long long first = tile * ROWS + s0;
#pragma unroll
      for (int q = 0; q < XL; ++q) {
        const int i = tid + THREADS * q, s = i / XR;
        xv[q] = i < CK * XR && first + s < N
                    ? x[(first + s) * NX + c0 + i % XR]
                    : 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const int i = tid + THREADS * q, r = i >> 3, j = 4 * (i & 7);
        if (KIND == HID) {
          av[q] = *reinterpret_cast<const float4*>(
              S + (ST_PRE + jb.l * W + r) * ROWS + s0 + j);
          bv[q] = *reinterpret_cast<const float4*>(
              S + (ST_BIAS + r) * ROWS + s0 + j);
        } else {
          av[q] = *reinterpret_cast<const float4*>(
              S + (ST_FEAT + r) * ROWS + s0 + j);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int i = tid + THREADS * q, r = i >> 3, j = 4 * (i & 7);
      dv[q] = *reinterpret_cast<const float4*>(Dt + (jb.d + r) * ROWS + s0 +
                                               j);
    }
  };
  const auto stage = [&]() {
    if (KIND == FEATS || KIND == PE) {
#pragma unroll
      for (int q = 0; q < XL; ++q) {
        const int i = tid + THREADS * q, s = i / XR, r = i % XR;
        if (i < CK * XR) {
          uint32_t h, l;
          split(xv[q], h, l);
          sah[r * LDK + s] = __uint_as_float(h);
          sal[r * LDK + s] = __uint_as_float(l);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < AQ; ++q) {
        const int i = tid + THREADS * q, r = i >> 3, j = 4 * (i & 7);
        float4 v = av[q];
        if (KIND == HID)
          v = make_float4(relu(v.x * bv[q].x), relu(v.y * bv[q].y),
                          relu(v.z * bv[q].z), relu(v.w * bv[q].w));
        split4(v, sah + r * LDK + j, sal + r * LDK + j);
      }
    }
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      const int i = tid + THREADS * q, r = i >> 3, j = 4 * (i & 7);
      split4(dv[q], sdh + r * LDK + j, sdl + r * LDK + j);
      bsum[q] += (dv[q].x + dv[q].y) + (dv[q].z + dv[q].w);
    }
  };

  // ldmatrix row addresses: A as in mma_ksteps; B's 8x4 block m of a pair
  // of n-tiles is (n-tile m >> 1, k half m & 1), so that registers 0-3
  // are b0, b1 of the first n-tile and b0, b1 of the second
  const int a_off = (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LDK +
                    4 * (lane >> 4);
  const int b_off = (8 * nb0 + 8 * (lane >> 4) + (lane & 7)) * LDK +
                    4 * ((lane >> 3) & 1);
  const int c_end = 4 * t1;
  if (4 * t0 < c_end) load(4 * t0);
  for (int c = 4 * t0; c < c_end; ++c) {
    __syncthreads();  // the last chunk's products are done
    stage();
    __syncthreads();
    if (c + 1 < c_end) load(c + 1);  // in flight during the products
#pragma unroll
    for (int kb = 0; kb < CK / 8; ++kb) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        ldmatrix_x4(ah[mi], sah + a_off + 16 * mi * LDK + 8 * kb);
        ldmatrix_x4(al[mi], sal + a_off + 16 * mi * LDK + 8 * kb);
      }
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bh[4], bl[4];
        ldmatrix_x4(bh, sdh + b_off + 16 * np * LDK + 8 * kb);
        ldmatrix_x4(bl, sdl + b_off + 16 * np * LDK + 8 * kb);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // a zeroed fragment a k-step, as
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // mma_ksteps<true>
            mma(t, al[mi], bh[2 * h], bh[2 * h + 1]);
            mma(t, ah[mi], bl[2 * h], bl[2 * h + 1]);
            mma(t, ah[mi], bh[2 * h], bh[2 * h + 1]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][2 * np + h][e] += t[e];
          }
      }
    }
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + 16 * mi + g + 8 * (e >> 1);
        if (r < jb.rows)
          P[jb.p + r * jb.n + 8 * (nb0 + ni) + 2 * t + (e & 1)] =
              acc[mi][ni][e];
      }
  if (jb.bias >= 0) {  // db: the 8 threads of each delta row, in order
#pragma unroll
    for (int q = 0; q < DQ; ++q) {
      float s = bsum[q];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      if ((tid & 7) == 0) P[jb.bias + ((tid + THREADS * q) >> 3)] = s;
    }
  }
}

// The heads' weights: the tiles' sums (mlp_delta_kernel) over [t0, t1),
// in order; thread o owns outputs o, o + 256, ...
__device__ void dw_heads(const float* __restrict__ heads, int t0, int t1,
                         float* __restrict__ P) {
  for (int o = threadIdx.x; o < HEADS; o += THREADS) {
    float s = 0.f;
#pragma unroll 8
    for (int t = t0; t < t1; ++t) s += heads[(long long)t * HEADS + o];
    P[o < HD_WR   ? OFF_WA + o
      : o < HD_WV ? OFF_WR + o - HD_WR
                  : OFF_WV + W * WH + o - HD_WV] = s;
  }
}

// Block b: unit b / n_splits of the jobs' N_UNITS, sample range b %
// n_splits of it; writes its job's weights (and bias) into row `split`
// of `partial`.
__global__ void __launch_bounds__(THREADS, 1)
    mlp_dw_kernel(const float* __restrict__ x,
                  const float* __restrict__ state,
                  const float* __restrict__ delta,
                  const float* __restrict__ heads, int N, int n_splits,
                  float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem& sm = *reinterpret_cast<DwSmem*>(smem_raw);
  const int unit = blockIdx.x / n_splits;
  int job = 0, first = 0;
  while (first + JOBS[job].units <= unit) first += JOBS[job++].units;
  const Job jb = JOBS[job];
  const int split = (unit - first) * n_splits + blockIdx.x % n_splits;
  const int n_ranges = jb.units * n_splits;
  const int n_tiles = (N + ROWS - 1) / ROWS;
  const int t0 = (int)((long long)n_tiles * split / n_ranges);
  const int t1 = (int)((long long)n_tiles * (split + 1) / n_ranges);
  float* P = partial + (long long)split * N_WEIGHTS;
  switch (jb.kind) {
    case FEATS:
      dw_job<FEATS, 1, 4>(sm, jb, x, state, delta, N, t0, t1, P);
      break;
    case PE:
      dw_job<PE, 2, 4>(sm, jb, x, state, delta, N, t0, t1, P);
      break;
    case HID:
      dw_job<HID, 4, 4>(sm, jb, x, state, delta, N, t0, t1, P);
      break;
    case FEAT:
      dw_job<FEAT, 4, 2>(sm, jb, x, state, delta, N, t0, t1, P);
      break;
    default:
      dw_heads(heads, t0, t1, P);
  }
}

// dw[i] = the sum of its job's sample ranges' partials, in order
__global__ void mlp_dw_reduce(const float* __restrict__ partial,
                              float* __restrict__ dw, int n_splits) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= N_WEIGHTS) return;
  int k = 0;
  while (RANGES[k + 1].begin <= i) ++k;
  const int n = RANGES[k].units * n_splits;
  float s = 0.f;
  for (int b = 0; b < n; ++b) s += partial[(long long)b * N_WEIGHTS + i];
  dw[i] = s;
}

template <class K>
int opt_in(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int set_smem() {
  static int rc = -1;
  if (rc < 0) {
    rc = opt_in(mlp_fwd_kernel, (int)sizeof(FwdSmem));
    if (rc == 0) rc = opt_in(mlp_delta_kernel, (int)sizeof(DeltaSmem));
    if (rc == 0) rc = opt_in(mlp_dw_kernel, (int)sizeof(DwSmem));
  }
  return rc;
}

long long n_tiles_of(int N) { return (N + ROWS - 1) / ROWS; }

// the buffer the forward fills for the backward: the two weight streams,
// then the state (ST_ROWS a sample, in whole tiles)
long long scratch_floats(int N) { return STREAMS + n_tiles_of(N) * TILE; }

// the backward's own buffer: the deltas, the heads' sums a tile, then the
// dW partials
long long work_floats(int N, int n_splits) {
  return n_tiles_of(N) * (TILE + HEADS) + 4LL * n_splits * N_WEIGHTS;
}

}  // namespace

// The weight streams alone (forward, then transposed) into streams
// (TC_TOTAL + TCT_TOTAL floats), from the packed weights w.
extern "C" int mlp_v0_pack(const void* w, void* streams, int n_weights,
                           void* stream) {
  if (n_weights != N_WEIGHTS) return (int)cudaErrorInvalidValue;
  mlp_pack_kernel<<<(STREAMS / 4 + THREADS - 1) / THREADS, THREADS, 0,
                    (cudaStream_t)stream>>>((const float*)w,
                                            (float*)streams);
  return (int)cudaGetLastError();
}

// The forward: the streams into scratch (n_scratch floats, checked), then
// out (N, 4); with save != 0 also the state the backward reads.
extern "C" int mlp_v0_fwd(const void* x, const void* w, void* out, int N,
                          int n_weights, void* scratch, long long n_scratch,
                          int save, void* stream) {
  if (n_weights != N_WEIGHTS || N < 0 || scratch == nullptr ||
      n_scratch != scratch_floats(N))
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (int rc = set_smem()) return rc;
  if (int rc = mlp_v0_pack(w, scratch, n_weights, stream)) return rc;
  float* s = (float*)scratch;
  mlp_fwd_kernel<<<(unsigned)n_tiles_of(N), THREADS, sizeof(FwdSmem),
                   (cudaStream_t)stream>>>((const float*)x, (const float*)w,
                                           s, (float*)out, N, s + STREAMS,
                                           save);
  return (int)cudaGetLastError();
}

// The backward from the scratch mlp_v0_fwd filled (with save) on the same
// x (N, 86): g (N, 4); work (n_work floats, checked); dw (n_weights,); dx
// (N, 86), every element written.
extern "C" int mlp_v0_bwd(const void* g, const void* x, const void* w,
                          const void* scratch, long long n_scratch,
                          void* work, long long n_work, void* dw, void* dx,
                          int N, int n_splits, int n_weights, void* stream) {
  if (n_weights != N_WEIGHTS || N < 1 || n_splits < 1 ||
      n_scratch != scratch_floats(N) || n_work != work_floats(N, n_splits))
    return (int)cudaErrorInvalidValue;
  if (int rc = set_smem()) return rc;
  cudaStream_t st = (cudaStream_t)stream;
  const float* s = (const float*)scratch;
  float* delta = (float*)work;
  float* heads = delta + n_tiles_of(N) * TILE;
  float* partial = heads + n_tiles_of(N) * HEADS;
  mlp_delta_kernel<<<(unsigned)n_tiles_of(N), THREADS, sizeof(DeltaSmem),
                     st>>>((const float*)g, (const float*)x, (const float*)w,
                           s + TC_TOTAL, s + STREAMS, delta, heads,
                           (float*)dx, N);
  if (int rc = (int)cudaGetLastError()) return rc;
  mlp_dw_kernel<<<N_UNITS * n_splits, THREADS, sizeof(DwSmem), st>>>(
      (const float*)x, s + STREAMS, delta, heads, N, n_splits, partial);
  if (int rc = (int)cudaGetLastError()) return rc;
  mlp_dw_reduce<<<(N_WEIGHTS + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      partial, (float*)dw, n_splits);
  return (int)cudaGetLastError();
}
