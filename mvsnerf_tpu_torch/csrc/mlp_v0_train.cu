// K7: the v0 NeRF MLP for training steps, forward and backward.
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
// view-direction slices of dx are zero (the caller allocates dx zeroed).
// f32 throughout: the TPU kernel's `precision="default"` (one bf16 MXU pass
// per dot) and its 13 x 128 x 128 lane packing are TPU choices.
//
// Forward and deltas: a block of 256 threads takes a tile of T = 32
// samples; thread (j = tid % 128, half = tid / 128) owns hidden unit j for
// the 16 samples [16 * half, 16 * half + 16). Activations live in shared
// memory as [unit][sample] rows, ~190 KB per block, so one block per SM.
// Weights are read from L1/L2 in two packings: `w` ((in, out) row-major,
// K6's layout) for products that walk the inputs, `wt` ((out, in),
// nn.Linear's own layout) for the backward's transposed products.
//
// Parameter gradient: the TPU kernel keeps all 126,788 accumulators in
// VMEM across its sequential grid and recomputes the forward in its
// backward; no GPU block can hold the accumulators. Here the forward
// writes, per tile, every layer's input rows and the state the deltas need
// (bias, pre-activations) to a scratch buffer (S_ROWS rows of T samples,
// ~12.6 KB per sample); the delta kernel reads that state and adds the
// delta rows; a dW kernel forms dW = sum over samples of input^T . delta
// and db = sum of delta, one 64 x 64 output tile per block with the
// samples split into `n_splits` fixed ranges; a last kernel sums the
// splits in order. No atomics: the result is deterministic.
//
// What bounds it on the H100: f32 FMA issue (~125k multiply-adds per
// sample each for the forward, the deltas and dW) with most of shared
// memory in use, leaving little L1 for the weights, and the scratch
// traffic (~1.65 GB written, ~2.9 GB read at 131,072 samples). PERF.md has
// the measured split and the designs tried before this one.

#include <cuda_runtime.h>

namespace {

constexpr int T = 32;          // samples per tile
constexpr int TH = 16;         // samples per thread
constexpr int NT = 256;        // threads per block
constexpr int W = 128;         // hidden width
constexpr int WH = W / 2;      // views head width
constexpr int NPE = 63, NF = 20, NVD = 3, NX = NPE + NF + NVD;  // 86

// packed layout: each layer's matrix, then its bias (render_v0.cu's order)
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

// shared memory, in rows of T floats
constexpr int R_X = 0;                 // x: PE 0..62, feats 63..82, dirs 83..85
constexpr int R_BIAS = R_X + NX;       // bias
constexpr int R_PRE = R_BIAS + W;      // pre_0 .. pre_5
constexpr int R_BUF = R_PRE + 6 * W;   // three 128-row work buffers
constexpr int R_PREV = R_BUF + 3 * W;  // views pre-activation / its delta
constexpr int R_HV = R_PREV + WH;      // views activation
constexpr int R_PREA = R_HV + WH;      // alpha pre-activation / its delta
constexpr int R_PRER = R_PREA + 1;     // rgb pre-activations / their deltas
constexpr int R_G = R_PRER + 3;        // output cotangent
constexpr int ROWS = R_G + 4;
constexpr int SMEM_BYTES = ROWS * T * 4;
static_assert(SMEM_BYTES <= 232448, "shared memory exceeds a block's share");

// scratch, per tile, in rows of T floats: each layer's input rows (laid
// out so that one layer's inputs are contiguous), then the delta rows
constexpr int S_B = 0;                 // pts_bias input: feats (20)
constexpr int S_0 = S_B + NF;          // layer 0 input: PE (63)
constexpr int S_1 = S_0 + NPE;         // layers 1-4 inputs: h0..h3
constexpr int S_5 = S_1 + 4 * W;       // layer 5 input: [PE | h4] (191)
constexpr int S_H5 = S_5 + NPE + W;    // alpha and feature input: h5
constexpr int S_V = S_H5 + W;          // views input: [feat | dirs] (131)
constexpr int S_R = S_V + W + NVD;     // rgb input: hv (64)
constexpr int S_DB = S_R + WH;         // d bias
constexpr int S_DP = S_DB + W;         // d pre_0 .. d pre_5
constexpr int S_DA = S_DP + 6 * W;     // d alpha pre-activation (1)
constexpr int S_DF = S_DA + 1;         // d feat
constexpr int S_DV = S_DF + W;         // d views pre-activation (64)
constexpr int S_DR = S_DV + WH;        // d rgb pre-activations (3)
// the forward's state the deltas need, in shared memory's order
constexpr int S_BIAS = S_DR + 3;       // bias, then pre_0 .. pre_5
constexpr int S_PREV = S_BIAS + 7 * W; // views pre-activation (64)
constexpr int S_PREA = S_PREV + WH;    // alpha, then rgb pre-activations
constexpr int S_ROWS = S_PREA + 4;
static_assert(R_PRE == R_BIAS + W && R_PRER == R_PREA + 1,
              "the state rows must be contiguous as in the scratch");

// dW jobs: input rows `a` (k of them), delta rows `d` (n), packed offset
// `p` of the (k, n) matrix, whose bias (n) follows it
struct Job {
  int a, k, d, n, p;
};
constexpr int NJOBS = 11;
#define K7_JOBS                                                   \
  {S_B, NF, S_DB, W, OFF_WB}, {S_0, NPE, S_DP, W, OFF_W0},        \
      {S_1, W, S_DP + W, W, OFF_W1},                              \
      {S_1 + W, W, S_DP + 2 * W, W, OFF_W1 + LAYER},              \
      {S_1 + 2 * W, W, S_DP + 3 * W, W, OFF_W1 + 2 * LAYER},      \
      {S_1 + 3 * W, W, S_DP + 4 * W, W, OFF_W1 + 3 * LAYER},      \
      {S_5, NPE + W, S_DP + 5 * W, W, OFF_W5},                    \
      {S_H5, W, S_DA, 1, OFF_WA}, {S_H5, W, S_DF, W, OFF_WF},     \
      {S_V, W + NVD, S_DV, WH, OFF_WV}, {S_R, WH, S_DR, 3, OFF_WR}
__constant__ Job JOBS[NJOBS] = {K7_JOBS};
constexpr Job HOST_JOBS[NJOBS] = {K7_JOBS};
constexpr int TK = 64, TJ = 64, LD = T + 4;  // dW tile and smem row stride

__device__ __forceinline__ float relu(float v) { return fmaxf(v, 0.f); }

// a[g] += w * row[g] over the thread's 16 samples
__device__ __forceinline__ void fma16(float (&a)[TH], float w,
                                      const float* row) {
  const float4* r = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < TH / 4; ++q) {
    const float4 u = r[q];
    a[4 * q + 0] = fmaf(w, u.x, a[4 * q + 0]);
    a[4 * q + 1] = fmaf(w, u.y, a[4 * q + 1]);
    a[4 * q + 2] = fmaf(w, u.z, a[4 * q + 2]);
    a[4 * q + 3] = fmaf(w, u.w, a[4 * q + 3]);
  }
}

__device__ __forceinline__ void fill(float (&a)[TH], float v) {
#pragma unroll
  for (int g = 0; g < TH; ++g) a[g] = v;
}

// a[g] += sum_k M[k * stride + j] * rows[k][g], k < n_rows; `rows` points
// at the thread's first sample of row 0
__device__ __forceinline__ void accum(float (&a)[TH],
                                      const float* __restrict__ M, int stride,
                                      int n_rows, int j, const float* rows) {
#pragma unroll 8
  for (int k = 0; k < n_rows; ++k)
    fma16(a, __ldg(M + k * stride + j), rows + k * T);
}

// 16 floats to a row (shared or global), as float4s
__device__ __forceinline__ void store(float* row, const float (&a)[TH]) {
  float4* r = reinterpret_cast<float4*>(row);
#pragma unroll
  for (int q = 0; q < TH / 4; ++q)
    r[q] = make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
}

// n rows of T floats between shared memory and the scratch
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int n) {
  for (int i = threadIdx.x; i < n * (T / 4); i += NT)
    reinterpret_cast<float4*>(dst)[i] =
        reinterpret_cast<const float4*>(src)[i];
}

// Forward over one tile. Leaves x, bias, pre_0..5, h4 in buffer 0, h5 in
// buffer 1, feat in buffer 2, the views pre-activation and activation, and
// the alpha and rgb pre-activations in shared memory, and writes to the
// tile's scratch `S` every activation a weight gradient reads and the state
// the deltas need.
__device__ void forward_tile(float* sm, const float* __restrict__ x,
                             const float* __restrict__ w, long long base,
                             int N, float* __restrict__ S) {
  const int tid = threadIdx.x, j = tid & (W - 1), t0 = (tid >> 7) * TH;
  float* X = sm + R_X * T;
  float* BIAS = sm + R_BIAS * T;
  float* PRE = sm + R_PRE * T;
  float* B0 = sm + R_BUF * T;
  float* B1 = B0 + W * T;
  float* B2 = B1 + W * T;
  float* PREV = sm + R_PREV * T;
  float* HV = sm + R_HV * T;
  float* PREA = sm + R_PREA * T;
  float* PRER = sm + R_PRER * T;

  const int valid = (int)min((long long)T, (long long)N - base);
  for (int i = tid; i < T * NX; i += NT) {  // coalesced x rows, transposed
    const int t = i / NX, k = i % NX;
    X[k * T + t] = t < valid ? x[base * NX + i] : 0.f;
  }
  __syncthreads();
  // the x slices that are weight-gradient inputs
  copy_rows(S + S_B * T, X + NPE * T, NF);
  copy_rows(S + S_0 * T, X, NPE);
  copy_rows(S + S_5 * T, X, NPE);
  copy_rows(S + (S_V + W) * T, X + (NPE + NF) * T, NVD);

  float a[TH], bias[TH];
  fill(bias, __ldg(w + OFF_BB + j));
  accum(bias, w + OFF_WB, W, NF, j, X + NPE * T + t0);
  store(BIAS + j * T + t0, bias);
  fill(a, __ldg(w + OFF_B0 + j));
  accum(a, w + OFF_W0, W, NPE, j, X + t0);
  store(PRE + j * T + t0, a);
#pragma unroll
  for (int g = 0; g < TH; ++g) a[g] = relu(a[g] * bias[g]);
  store(B0 + j * T + t0, a);
  store(S + (S_1 + j) * T + t0, a);
  __syncthreads();

  float* hin = B0;
  float* hout = B1;
  for (int l = 1; l <= 4; ++l) {
    const float* Wl = w + OFF_W1 + (l - 1) * LAYER;
    fill(a, __ldg(Wl + W * W + j));
    accum(a, Wl, W, W, j, hin + t0);
    store(PRE + (l * W + j) * T + t0, a);
#pragma unroll
    for (int g = 0; g < TH; ++g) a[g] = relu(a[g] * bias[g]);
    store(hout + j * T + t0, a);
    // h_l is layer l+1's input
    store(S + ((l < 4 ? S_1 + l * W : S_5 + NPE) + j) * T + t0, a);
    __syncthreads();
    float* tmp = hin;
    hin = hout;
    hout = tmp;
  }
  // hin = B0 holds h4; layer 5 reads [PE | h4] and writes h5 into B1
  fill(a, __ldg(w + OFF_B5 + j));
  accum(a, w + OFF_W5, W, NPE, j, X + t0);
  accum(a, w + OFF_W5 + NPE * W, W, W, j, B0 + t0);
  store(PRE + (5 * W + j) * T + t0, a);
#pragma unroll
  for (int g = 0; g < TH; ++g) a[g] = relu(a[g] * bias[g]);
  store(B1 + j * T + t0, a);
  store(S + (S_H5 + j) * T + t0, a);
  __syncthreads();

  fill(a, __ldg(w + OFF_BF + j));  // feature head
  accum(a, w + OFF_WF, W, W, j, B1 + t0);
  store(B2 + j * T + t0, a);
  store(S + (S_V + j) * T + t0, a);
  if (tid < T) {  // alpha head, one sample per thread
    float s = __ldg(w + OFF_BA);
    for (int k = 0; k < W; ++k)
      s = fmaf(__ldg(w + OFF_WA + k), B1[k * T + tid], s);
    PREA[tid] = s;
  }
  __syncthreads();

  if (j < WH) {  // views head on [feat | viewdirs]
    fill(a, __ldg(w + OFF_BV + j));
    accum(a, w + OFF_WV, WH, W, j, B2 + t0);
    accum(a, w + OFF_WV + W * WH, WH, NVD, j, X + (NPE + NF) * T + t0);
    store(PREV + j * T + t0, a);
#pragma unroll
    for (int g = 0; g < TH; ++g) a[g] = relu(a[g]);
    store(HV + j * T + t0, a);
    store(S + (S_R + j) * T + t0, a);
  }
  __syncthreads();

  if (tid < 3 * T) {  // rgb head, one (channel, sample) per thread
    const int c = tid / T, t = tid % T;
    float v = __ldg(w + OFF_BR + c);
    for (int k = 0; k < WH; ++k)
      v = fmaf(__ldg(w + OFF_WR + k * 3 + c), HV[k * T + t], v);
    PRER[c * T + t] = v;
  }
  __syncthreads();
  copy_rows(S + S_BIAS * T, BIAS, 7 * W);
  copy_rows(S + S_PREV * T, PREV, WH);
  copy_rows(S + S_PREA * T, PREA, 4);
}

// The forward, and what the backward reads, into the scratch.
__global__ void __launch_bounds__(NT, 1)
    mlp_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ out, int N,
                   float* __restrict__ scratch) {
  extern __shared__ __align__(16) float sm[];
  const long long base = (long long)blockIdx.x * T;
  forward_tile(sm, x, w, base, N,
               scratch + (long long)blockIdx.x * S_ROWS * T);
  const int tid = threadIdx.x;
  if (tid < 4 * T) {
    const int c = tid / T, t = tid % T;
    if (base + t < N) {
      const float v = c < 3 ? 1.f / (1.f + expf(-sm[(R_PRER + c) * T + t]))
                            : relu(sm[R_PREA * T + t]);
      out[(base + t) * 4 + c] = v;
    }
  }
}

// One tile per block: the forward's state from the scratch, then every
// delta, written to the tile's scratch rows; d feats to dx.
__global__ void __launch_bounds__(NT, 1)
    mlp_bwd_kernel(const float* __restrict__ gout,
                   const float* __restrict__ w, const float* __restrict__ wt,
                   float* __restrict__ scratch, float* __restrict__ dx,
                   int N) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, j = tid & (W - 1), t0 = (tid >> 7) * TH;
  const long long base = (long long)blockIdx.x * T;
  float* S = scratch + (long long)blockIdx.x * S_ROWS * T;
  float* BIAS = sm + R_BIAS * T;
  float* PRE = sm + R_PRE * T;
  float* B0 = sm + R_BUF * T;
  float* B1 = B0 + W * T;
  float* B2 = B1 + W * T;
  float* PREV = sm + R_PREV * T;
  float* PREA = sm + R_PREA * T;
  float* PRER = sm + R_PRER * T;
  float* G = sm + R_G * T;
  const int valid = (int)min((long long)T, (long long)N - base);
  if (tid < T * 4) {
    const int t = tid / 4, c = tid % 4;
    G[c * T + t] = t < valid ? gout[base * 4 + tid] : 0.f;
  }
  copy_rows(BIAS, S + S_BIAS * T, 7 * W);
  copy_rows(PREV, S + S_PREV * T, WH);
  copy_rows(PREA, S + S_PREA * T, 4);
  __syncthreads();

  // ---- heads: d pre_r, d pre_a
  if (tid < 3 * T) {
    const int c = tid / T, t = tid % T;
    const float s = 1.f / (1.f + expf(-PRER[c * T + t]));
    const float v = G[c * T + t] * s * (1.f - s);
    PRER[c * T + t] = v;
    S[(S_DR + c) * T + t] = v;
  } else if (tid < 4 * T) {
    const int t = tid - 3 * T;
    const float v = PREA[t] > 0.f ? G[3 * T + t] : 0.f;
    PREA[t] = v;
    S[S_DA * T + t] = v;
  }
  __syncthreads();

  // ---- d pre_v
  for (int i = tid; i < WH * T; i += NT) {
    const int k = i / T, t = i % T;
    float d = __ldg(w + OFF_WR + k * 3) * PRER[t];
    d = fmaf(__ldg(w + OFF_WR + k * 3 + 1), PRER[T + t], d);
    d = fmaf(__ldg(w + OFF_WR + k * 3 + 2), PRER[2 * T + t], d);
    d = PREV[i] > 0.f ? d : 0.f;
    PREV[i] = d;
    S[S_DV * T + i] = d;
  }
  __syncthreads();

  // ---- d feat = Wv[:128] . d pre_v -> B2 (feat is no longer needed)
  float a[TH], dbias[TH];
  fill(a, 0.f);
  accum(a, wt + OFF_WV, W + NVD, WH, j, PREV + t0);
  store(B2 + j * T + t0, a);
  store(S + (S_DF + j) * T + t0, a);
  __syncthreads();

  // ---- d h5 -> dt5 -> d pre5 into B1, d bias starts
  fill(a, 0.f);
  accum(a, wt + OFF_WF, W, W, j, B2 + t0);
  {
    const float wa = __ldg(w + OFF_WA + j);
    const float* pre = PRE + (5 * W + j) * T + t0;
    const float* bs = BIAS + j * T + t0;
#pragma unroll
    for (int g = 0; g < TH; ++g) {
      const float dh = fmaf(wa, PREA[t0 + g], a[g]);
      const float dt = pre[g] * bs[g] > 0.f ? dh : 0.f;
      dbias[g] = dt * pre[g];
      a[g] = dt * bs[g];
    }
  }
  store(B1 + j * T + t0, a);
  store(S + (S_DP + 5 * W + j) * T + t0, a);
  __syncthreads();

  // ---- trunk layers 5..1: d pre_{l-1} from d pre_l
  float* D = B1;
  float* Nx = B2;
  for (int l = 5; l >= 1; --l) {
    fill(a, 0.f);
    if (l == 5)
      accum(a, wt + OFF_W5 + NPE, NPE + W, W, j, D + t0);
    else
      accum(a, wt + OFF_W1 + (l - 1) * LAYER, W, W, j, D + t0);
    const float* pre = PRE + ((l - 1) * W + j) * T + t0;
    const float* bs = BIAS + j * T + t0;
#pragma unroll
    for (int g = 0; g < TH; ++g) {
      const float dt = pre[g] * bs[g] > 0.f ? a[g] : 0.f;
      dbias[g] = fmaf(dt, pre[g], dbias[g]);
      a[g] = dt * bs[g];
    }
    store(Nx + j * T + t0, a);
    store(S + (S_DP + (l - 1) * W + j) * T + t0, a);
    __syncthreads();
    float* tmp = D;
    D = Nx;
    Nx = tmp;
  }

  // ---- d feats = Wb . d bias
  store(B0 + j * T + t0, dbias);
  store(S + (S_DB + j) * T + t0, dbias);
  __syncthreads();
  if (j < NF) {
    fill(a, 0.f);
    accum(a, wt + OFF_WB, NF, W, j, B0 + t0);
#pragma unroll
    for (int g = 0; g < TH; ++g)
      if (base + t0 + g < N) dx[(base + t0 + g) * NX + NPE + j] = a[g];
  }
}

__host__ __device__ constexpr int tiles_of(const Job& jb) {
  return ((jb.k + TK - 1) / TK) * ((jb.n + TJ - 1) / TJ);
}

// dW and db: block (output tile o, split s) sums input^T . delta over the
// sample tiles [n_tiles * s / n_splits, n_tiles * (s + 1) / n_splits) of
// one job into partial[s]. Thread (tk, tj) owns rows tk + 16 i and columns
// tj + 16 jj (i, jj < 4); the block's row-0 threads also sum the deltas
// for the bias.
__global__ void __launch_bounds__(NT)
    mlp_dw_kernel(const float* __restrict__ scratch, int n_tiles,
                  int n_splits, int n_out, float* __restrict__ partial) {
  __shared__ __align__(16) float As[TK * LD];
  __shared__ __align__(16) float Ds[TJ * LD];
  const int tid = threadIdx.x, tj = tid % 16, tk = tid / 16;
  const int split = blockIdx.x / n_out;
  int rem = blockIdx.x % n_out, job = 0;
  while (rem >= tiles_of(JOBS[job])) rem -= tiles_of(JOBS[job++]);
  const Job jb = JOBS[job];
  const int ntj = (jb.n + TJ - 1) / TJ;
  const int k0 = (rem / ntj) * TK, j0 = (rem % ntj) * TJ;
  const bool bias_rows = k0 == 0 && tk == 0;
  const int t_begin = (int)((long long)n_tiles * split / n_splits);
  const int t_end = (int)((long long)n_tiles * (split + 1) / n_splits);

  float acc[4][4] = {}, bsum[4] = {};
  for (int tile = t_begin; tile < t_end; ++tile) {
    const float* St = scratch + (long long)tile * S_ROWS * T;
    for (int i = tid; i < TK * (T / 4); i += NT) {
      const int r = i / (T / 4), q = i % (T / 4);
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(As + r * LD)[q] =
          k0 + r < jb.k
              ? reinterpret_cast<const float4*>(St + (jb.a + k0 + r) * T)[q]
              : z;
      reinterpret_cast<float4*>(Ds + r * LD)[q] =
          j0 + r < jb.n
              ? reinterpret_cast<const float4*>(St + (jb.d + j0 + r) * T)[q]
              : z;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      float4 av[4], dv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = reinterpret_cast<const float4*>(As + (tk + 16 * i) * LD)[q];
        dv[i] = reinterpret_cast<const float4*>(Ds + (tj + 16 * i) * LD)[q];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          acc[i][jj] = fmaf(av[i].x, dv[jj].x, acc[i][jj]);
          acc[i][jj] = fmaf(av[i].y, dv[jj].y, acc[i][jj]);
          acc[i][jj] = fmaf(av[i].z, dv[jj].z, acc[i][jj]);
          acc[i][jj] = fmaf(av[i].w, dv[jj].w, acc[i][jj]);
        }
      if (bias_rows) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bsum[jj] += (dv[jj].x + dv[jj].y) + (dv[jj].z + dv[jj].w);
      }
    }
    __syncthreads();
  }
  float* P = partial + (long long)split * N_WEIGHTS + jb.p;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int k = k0 + tk + 16 * i, jn = j0 + tj + 16 * jj;
      if (k < jb.k && jn < jb.n) P[k * jb.n + jn] = acc[i][jj];
    }
  if (bias_rows) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int jn = j0 + tj + 16 * jj;
      if (jn < jb.n) P[jb.k * jb.n + jn] = bsum[jj];
    }
  }
}

__global__ void reduce_partials(const float* __restrict__ partial,
                                float* __restrict__ out, int n_splits) {
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i >= N_WEIGHTS) return;
  float s = 0.f;
  for (int b = 0; b < n_splits; ++b)
    s += partial[(long long)b * N_WEIGHTS + i];
  out[i] = s;
}

int set_smem() {
  static int rc = -1;
  if (rc < 0) {
    rc = (int)cudaFuncSetAttribute(
        mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (rc == 0)
      rc = (int)cudaFuncSetAttribute(
          mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_BYTES);
  }
  return rc;
}

}  // namespace

// scratch: mlp_v0_scratch_floats(N) floats, filled for the backward
extern "C" int mlp_v0_fwd(const void* x, const void* w, void* out, int N,
                          int n_weights, void* scratch, void* stream) {
  if (n_weights != N_WEIGHTS || N < 0 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (int rc = set_smem()) return rc;
  mlp_fwd_kernel<<<(N + T - 1) / T, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, N, (float*)scratch);
  return (int)cudaGetLastError();
}

// Floats of scratch the backward needs for N samples.
extern "C" long long mlp_v0_scratch_floats(int N) {
  return (long long)((N + T - 1) / T) * S_ROWS * T;
}

// scratch: as mlp_v0_fwd left it; partial: (n_splits, n_weights);
// dw: (n_weights,); dx: (N, 86) zeroed
extern "C" int mlp_v0_bwd(const void* g, const void* w, const void* wt,
                          void* scratch, void* partial, void* dw, void* dx,
                          int N, int n_splits, int n_weights, void* stream) {
  if (n_weights != N_WEIGHTS || N < 1 || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  if (int rc = set_smem()) return rc;
  const int n_tiles = (N + T - 1) / T;
  cudaStream_t s = (cudaStream_t)stream;
  mlp_bwd_kernel<<<n_tiles, NT, SMEM_BYTES, s>>>(
      (const float*)g, (const float*)w, (const float*)wt, (float*)scratch,
      (float*)dx, N);
  if (int rc = (int)cudaGetLastError()) return rc;
  int n_out = 0;
  for (const Job& jb : HOST_JOBS) n_out += tiles_of(jb);
  mlp_dw_kernel<<<n_out * n_splits, NT, 0, s>>>(
      (const float*)scratch, n_tiles, n_splits, n_out, (float*)partial);
  if (int rc = (int)cudaGetLastError()) return rc;
  reduce_partials<<<(N_WEIGHTS + NT - 1) / NT, NT, 0, s>>>(
      (const float*)partial, (float*)dw, n_splits);
  return (int)cudaGetLastError();
}
