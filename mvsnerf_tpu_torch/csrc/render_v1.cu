// K11: fused per-ray render with the v1 attention MLP (`--net_type v1`,
// `Renderer_attention`, reference models.py:304-462), from features that
// are gathered already, as K8 (csrc/render_v0.cu `<0, 20>`) renders the
// v0 MLP. It replaces no TPU kernel: the JAX package renders v1 in XLA
// (mvsnerf_tpu/models/nerf_mlp.py:117 `mlp_v1_apply`), and the port ran
// it as eager module code, launches of tiny batched products (B = the
// chunk's samples, 3 x 3 scores) at ~8x K8's time a request.
//
// Per ray, front to back over S samples:
//   - the 20 gathered features [volume (8) | 3 x (RGB, mask)] -> three
//     tokens of 12, [RGB, mask | volume], one a source view;
//   - the colour attention, f32 on the CUDA cores: q, k, v (12 -> 16, no
//     bias), each of 4 heads a softmax over the 3 tokens of (q / 2) . k,
//     fc (16 -> 12, no bias) + the token (the residual), a LayerNorm (eps
//     1e-6, affine), sigmoid(weight_out (12 -> 3)) summed over the views:
//     the sample's colour;
//   - pts_bias over [volume | colour] (11 -> 128), ADDED at every layer of
//     a 6 x 128 ReLU trunk over the PE of the NDC xyz (10 frequencies, 63),
//     with no skip; the v0 heads: sigma = relu(alpha_linear(h5)), rgb =
//     sigmoid(rgb_linear(relu(views_linears.0([feature_linear(h5) |
//     direction]))));
//   - alpha = 1 - exp(-sigma), T <- T * (max(1 - alpha, 0) + 1e-10) (no
//     delta t: `raw2outputs`), accumulating rgb, depth, acc. It writes each
//     sample's weight, alpha and [volume | colour | colour], the rest of
//     what the module's route returns (its `feats`: JAX renderer.py:
//     307-309).
// White background is the caller's; no early stop.
//
// Layout: K8's (csrc/render_v0.cu's header): a block of 256 threads takes
// a tile of 128 rows, whole rays (S <= 128) or 128 samples of one ray
// carried over the ray's tiles (S > 128). Per tile:
//   1. stage: threads 0-127 read one row's 20 features each, 128-255 its
//      PE; the per-ray start of the views layer in f32;
//   2. the colour attention, two threads a row (heads 0-1 and 2-3): the
//      volume's share of q, k, v once for the three tokens, each token's
//      (RGB, mask) share added; each thread's heads' fc terms summed with
//      its partner's by a shuffle; both then finish the residual,
//      LayerNorm and weight_out (a few dozen operations a token); one
//      writes [volume | colour | 0 x 5] over the row's features, pts_bias's
//      A operand (K 16), the other the sample's folded features to device
//      memory. The attention's 831 weights sit in shared memory, read as
//      broadcast float4s;
//   3. the MLP's products on the tensor cores in 3xTF32 (csrc/mlp_tc.cuh;
//      the stream `pack_v1_weights_tc`): pts_bias into registers, then
//      each layer's epilogue relu(acc + bias) into the shared [row][unit]
//      buffer the next layer reads; the heads and compositing as K8's.
//
// What bounds it on the H100: the trunk and heads' 1.165e5 multiply-adds
// a sample on the tensor cores, three passes each (7 % fewer than v0's:
// no PE skip into layer 5, 11 bias inputs for 20), at K8's efficiency;
// the attention adds ~1.9e3 f32 multiply-adds a sample on the CUDA cores
// (the volume's share of q, k, v taken once for the three tokens), during
// which the tensor cores idle, as they do during staging and the heads.

#include <cuda_runtime.h>

#include "mlp_tc.cuh"

namespace {

using namespace mlp_tc;

constexpr int W = 128;   // hidden width
constexpr int NFREQ = 10;
constexpr int NPE = 3 + 2 * NFREQ * 3;  // 63
constexpr int NF = 20;                  // gathered features a sample
constexpr int NVIEW = 3;                // source views (tokens)
constexpr int NTOK = 12;                // token width: RGB, mask, volume 8
constexpr int NHEAD = 4;                // heads
constexpr int DK = 4;                   // d_k = d_v
constexpr int NQ = NHEAD * DK;          // 16
constexpr int NB = 8 + 3;               // pts_bias inputs: volume, colour
constexpr int NFO = 8 + 3 + 3;          // folded features: volume, colour x 2
constexpr int WH = W / 2;               // views head width
constexpr int ROWS = 128;               // samples a tile
constexpr int THREADS = 256;            // 8 warps: 2 row halves x 4 columns
constexpr int MAX_RAYS = ROWS / 8;      // rays a tile holds (S % 8 == 0)
constexpr int LDA = W + 4;              // shared row strides (floats), each
constexpr int LDP = 64 + 4;             // 4 mod 8: the A fragments' reads
constexpr int LDF = 24 + 4;             // are free of bank conflicts

// packed weights (`pack_v1_weights`): each layer's (in, out) matrix
// row-major, then its bias where it has one
constexpr int OFF_W0 = 0;                         // pts_linears.0 (63, 128)
constexpr int OFF_B0 = OFF_W0 + NPE * W;
constexpr int OFF_WB = OFF_B0 + W;                // pts_bias (11, 128)
constexpr int OFF_BB = OFF_WB + NB * W;
constexpr int OFF_W1 = OFF_BB + W;                // pts_linears.1-5
constexpr int LAYER = W * W + W;                  //   (128, 128) + 128 each
constexpr int OFF_WA = OFF_W1 + 5 * LAYER;        // alpha_linear (128, 1)
constexpr int OFF_BA = OFF_WA + W;
constexpr int OFF_WF = OFF_BA + 1;                // feature_linear (128, 128)
constexpr int OFF_BF = OFF_WF + W * W;
constexpr int OFF_WV = OFF_BF + W;                // views_linears.0 (131, 64)
constexpr int OFF_BV = OFF_WV + (W + 3) * WH;
constexpr int OFF_WR = OFF_BV + WH;               // rgb_linear (64, 3)
constexpr int OFF_BR = OFF_WR + WH * 3;
constexpr int OFF_ATTN = OFF_BR + 3;              // the attention, below
// the attention's weights, from OFF_ATTN in the pack and in shared memory
constexpr int A_WQ = 0;                  // w_qs (12, 16)
constexpr int A_WK = A_WQ + NTOK * NQ;   // w_ks (12, 16)
constexpr int A_WV = A_WK + NTOK * NQ;   // w_vs (12, 16)
constexpr int A_FC = A_WV + NTOK * NQ;   // fc (16, 12)
constexpr int A_LNW = A_FC + NQ * NTOK;  // layer_norm scale (12)
constexpr int A_LNB = A_LNW + NTOK;      //   and shift (12)
constexpr int A_WO = A_LNB + NTOK;       // weight_out (12, 3)
constexpr int A_BO = A_WO + NTOK * 3;    //   and its bias (3)
constexpr int N_ATTN = A_BO + 3;         // 831
constexpr int N_WEIGHTS = OFF_ATTN + N_ATTN;
static_assert(A_FC % 4 == 0 && NQ % 4 == 0 && NTOK % 4 == 0,
              "float4 rows of the attention's products");

// the tensor-core stream (`pack_v1_weights_tc`), in floats: each layer's
// padded (K, N) matrix as hi/lo fragments, K x N x 2
constexpr int TC1_PTS_BIAS = 0;      // pts_bias       K 16 (11 + 5 zero rows)
constexpr int TC1_PTS_0 = 4096;      // pts_linears.0  K 64 (63 + 1)
constexpr int TC1_PTS_1 = 20480;     // pts_linears.1-5, K 128
constexpr int TC1_PTS_2 = 53248;
constexpr int TC1_PTS_3 = 86016;
constexpr int TC1_PTS_4 = 118784;
constexpr int TC1_PTS_5 = 151552;
constexpr int TC1_FEATURE = 184320;  // feature_linear K 128
constexpr int TC1_VIEWS = 217088;    // views_linears.0's first 128 rows, N 64
constexpr int TC1_TOTAL = 233472;
static_assert(TC1_PTS_0 == TC1_PTS_BIAS + 16 * 128 * 2, "v1 stream");
static_assert(TC1_PTS_1 == TC1_PTS_0 + 64 * 128 * 2, "v1 stream");
static_assert(TC1_PTS_2 == TC1_PTS_1 + 128 * 128 * 2 &&
                  TC1_PTS_3 == TC1_PTS_2 + 128 * 128 * 2 &&
                  TC1_PTS_4 == TC1_PTS_3 + 128 * 128 * 2 &&
                  TC1_PTS_5 == TC1_PTS_4 + 128 * 128 * 2,
              "v1 stream");
static_assert(TC1_FEATURE == TC1_PTS_5 + 128 * 128 * 2, "v1 stream");
static_assert(TC1_VIEWS == TC1_FEATURE + 128 * 128 * 2, "v1 stream");
static_assert(TC1_TOTAL == TC1_VIEWS + 128 * 64 * 2, "v1 stream");

struct Smem {
  float ring[NSTAGE * CHUNK];  // the weight stream (16-byte aligned)
  float act[ROWS * LDA];       // activations; the features (LDF) first
  float pe[ROWS * LDP];        // PE, 63 + a zero column
  float vinit[MAX_RAYS][WH];   // views layer: bias + direction term a ray
  float sig[ROWS], z[ROWS], rgb[ROWS][3];
  alignas(16) float attn[N_ATTN + 1];  // the attention's weights
  alignas(8) uint64_t bars[NSTAGE];    // the stream's barriers
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&a)[DK], float4 w, float x) {
  a[0] = fmaf(w.x, x, a[0]);
  a[1] = fmaf(w.y, x, a[1]);
  a[2] = fmaf(w.z, x, a[2]);
  a[3] = fmaf(w.w, x, a[3]);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The colour of one sample from its 20 features f, by the two threads of
// a pair (hf = 0, 1: heads 2 hf, 2 hf + 1), which must be adjacent lanes
// of one warp, both active. A the attention's weights (shared memory).
__device__ __forceinline__ void color_attention(const float* f, int hf,
                                                const float* A,
                                                float (&color)[3]) {
  float vol[8], cm[NVIEW][4];
#pragma unroll
  for (int c = 0; c < 8; ++c) vol[c] = f[c];
#pragma unroll
  for (int v = 0; v < NVIEW; ++v)
#pragma unroll
    for (int c = 0; c < 4; ++c) cm[v][c] = f[8 + 4 * v + c];

  float y[NVIEW][NTOK];  // fc(o): this thread's heads' terms
#pragma unroll
  for (int v = 0; v < NVIEW; ++v)
#pragma unroll
    for (int c = 0; c < NTOK; ++c) y[v][c] = 0.f;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int col = DK * (2 * hf + hh);  // the head's 4 columns of q, k, v
    // the volume's share (token inputs 4-11), the same for every token
    float vq[DK] = {0.f, 0.f, 0.f, 0.f}, vk[DK] = {0.f, 0.f, 0.f, 0.f},
          vv[DK] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      fma4(vq, ld4(A + A_WQ + (4 + i) * NQ + col), vol[i]);
      fma4(vk, ld4(A + A_WK + (4 + i) * NQ + col), vol[i]);
      fma4(vv, ld4(A + A_WV + (4 + i) * NQ + col), vol[i]);
    }
    float q[NVIEW][DK], k[NVIEW][DK], val[NVIEW][DK];
#pragma unroll
    for (int v = 0; v < NVIEW; ++v)
#pragma unroll
      for (int d = 0; d < DK; ++d) {
        q[v][d] = vq[d];
        k[v][d] = vk[d];
        val[v][d] = vv[d];
      }
    // each token's (RGB, mask) share (inputs 0-3)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 wq = ld4(A + A_WQ + i * NQ + col);
      const float4 wk = ld4(A + A_WK + i * NQ + col);
      const float4 wv = ld4(A + A_WV + i * NQ + col);
#pragma unroll
      for (int v = 0; v < NVIEW; ++v) {
        fma4(q[v], wq, cm[v][i]);
        fma4(k[v], wk, cm[v][i]);
        fma4(val[v], wv, cm[v][i]);
      }
    }
    // softmax over the keys of (q / sqrt(d_k)) . k, then o = a . v, and
    // o's fc terms into y
#pragma unroll
    for (int i = 0; i < NVIEW; ++i) {
      float s[NVIEW];
#pragma unroll
      for (int j = 0; j < NVIEW; ++j) {
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < DK; ++d) a = fmaf(q[i][d] * 0.5f, k[j][d], a);
        s[j] = a;
      }
      const float m = fmaxf(fmaxf(s[0], s[1]), s[2]);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NVIEW; ++j) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
      float o[DK] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NVIEW; ++j) {
        const float a = s[j] / sum;
#pragma unroll
        for (int d = 0; d < DK; ++d) o[d] = fmaf(a, val[j][d], o[d]);
      }
#pragma unroll
      for (int d = 0; d < DK; ++d)
#pragma unroll
        for (int c4 = 0; c4 < NTOK / 4; ++c4) {
          const float4 w = ld4(A + A_FC + (col + d) * NTOK + 4 * c4);
          y[i][4 * c4] = fmaf(w.x, o[d], y[i][4 * c4]);
          y[i][4 * c4 + 1] = fmaf(w.y, o[d], y[i][4 * c4 + 1]);
          y[i][4 * c4 + 2] = fmaf(w.z, o[d], y[i][4 * c4 + 2]);
          y[i][4 * c4 + 3] = fmaf(w.w, o[d], y[i][4 * c4 + 3]);
        }
    }
  }
  // the partner's heads
#pragma unroll
  for (int v = 0; v < NVIEW; ++v)
#pragma unroll
    for (int c = 0; c < NTOK; ++c)
      y[v][c] += __shfl_xor_sync(0xffffffffu, y[v][c], 1);

  // residual, LayerNorm, sigmoid(weight_out), summed over the views
  color[0] = color[1] = color[2] = 0.f;
#pragma unroll
  for (int v = 0; v < NVIEW; ++v) {
    float t[NTOK];
#pragma unroll
    for (int c = 0; c < 4; ++c) t[c] = y[v][c] + cm[v][c];
#pragma unroll
    for (int c = 0; c < 8; ++c) t[4 + c] = y[v][4 + c] + vol[c];
    float mean = 0.f;
#pragma unroll
    for (int c = 0; c < NTOK; ++c) mean += t[c];
    mean *= 1.f / NTOK;
    float var = 0.f;
#pragma unroll
    for (int c = 0; c < NTOK; ++c) {
      t[c] -= mean;
      var = fmaf(t[c], t[c], var);
    }
    const float inv = rsqrtf(var * (1.f / NTOK) + 1e-6f);
    float out[3] = {A[A_BO], A[A_BO + 1], A[A_BO + 2]};
#pragma unroll
    for (int c = 0; c < NTOK; ++c) {
      const float n = fmaf(t[c] * inv, A[A_LNW + c], A[A_LNB + c]);
#pragma unroll
      for (int e = 0; e < 3; ++e)
        out[e] = fmaf(A[A_WO + c * 3 + e], n, out[e]);
    }
#pragma unroll
    for (int e = 0; e < 3; ++e) color[e] += sigmoid(out[e]);
  }
}

// epilogue of layers 0-5: act = relu(acc + bias), fragment by fragment
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
            make_float2(fmaxf(acc[mi][ni][2 * h] + pb[mi][ni][2 * h], 0.f),
                        fmaxf(acc[mi][ni][2 * h + 1] + pb[mi][ni][2 * h + 1],
                              0.f));
}

// Composite rows [first, first + len) of the tile front to back, one warp
// (K8's): lane l takes a run of consecutive samples; T and the sums carry
// in (S > 128) and out; each sample's weight and alpha go to wout and aout
// at gbase + row.
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
    wout[gbase + row] = wgt;
    aout[gbase + row] = alpha;
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

__global__ void __launch_bounds__(THREADS, 1)
    render_v1_kernel(const float* __restrict__ ndc,
                     const float* __restrict__ zv,
                     const float* __restrict__ feats,
                     const float* __restrict__ dirs,
                     const float* __restrict__ wts,
                     const float* __restrict__ tc, float* __restrict__ out,
                     float* __restrict__ wout, float* __restrict__ aout,
                     float* __restrict__ fout, int N, int S) {
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
  ws.init(tc, TC1_TOTAL, n_tiles, sm.ring, sm.bars);
  for (int i = tid; i < N_ATTN; i += THREADS)
    sm.attn[i] = __ldg(wts + OFF_ATTN + i);

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int len = whole ? S : min(ROWS, S - tile * ROWS);
    const int n_rows = whole ? n_rays * S : len;
    const long long gbase = ray0 * S + (long long)tile * ROWS;
    if (tile > 0) __syncthreads();  // the last tile's readers are done
    ws.next_pass();

    // ---- 1. stage the tile's inputs
    if (tid < ROWS) {  // features, one row a thread
      const int r = tid;
      float4* f = reinterpret_cast<float4*>(sm.act + r * LDF);
      float z = 0.f;
      if (r < n_rows) {
        const long long gi = gbase + r;
        const float4* src = reinterpret_cast<const float4*>(feats + gi * NF);
#pragma unroll
        for (int q = 0; q < NF / 4; ++q) f[q] = __ldg(src + q);
        z = zv[gi];
      } else {
#pragma unroll
        for (int q = 0; q < NF / 4; ++q)
          f[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
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

    // ---- 2. the colour attention, two threads a row
    {
      const int r = tid >> 1, hf = tid & 1;
      float* f = sm.act + r * LDF;
      float color[3];
      color_attention(f, hf, sm.attn, color);
      __syncwarp();  // the pair has read the row's features
      if (hf == 0) {  // pts_bias's inputs [volume | colour | 0 x 5]
        f[8] = color[0];
        f[9] = color[1];
        f[10] = color[2];
#pragma unroll
        for (int c = NB; c < 16; ++c) f[c] = 0.f;
      } else if (r < n_rows) {  // [volume | colour | colour], 8-byte rows
        float2* fo = reinterpret_cast<float2*>(fout + (gbase + r) * NFO);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          fo[q] = make_float2(f[2 * q], f[2 * q + 1]);
        fo[4] = make_float2(color[0], color[1]);
        fo[5] = make_float2(color[2], color[0]);
        fo[6] = make_float2(color[1], color[2]);
      }
    }
    __syncthreads();

    // ---- 3. the MLP on tensor cores
    float pb[4][4][4], acc[4][4][4];
    init_cols(pb, wts + OFF_BB, 4 * wn);  // pts_bias: added at each layer
    mma_ksteps(pb, sm.act, LDF, row0, 2, ws, W, 4 * wn);
    init_cols(acc, wts + OFF_B0, 4 * wn);  // layer 0 over PE
    mma_ksteps(acc, sm.pe, LDP, row0, 8, ws, W, 4 * wn);
    __syncthreads();  // the features are read
    store_hidden(acc, pb, sm.act, row0, 4 * wn);
    __syncthreads();
    for (int l = 0; l < 5; ++l) {  // layers 1-5, no skip
      init_cols(acc, wts + OFF_W1 + l * LAYER + W * W, 4 * wn);
      mma_ksteps(acc, sm.act, LDA, row0, W / 8, ws, W, 4 * wn);
      __syncthreads();
      store_hidden(acc, pb, sm.act, row0, 4 * wn);
      __syncthreads();
    }
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

    // ---- 4. rgb head, f32
    for (int i = tid; i < ROWS * 3; i += THREADS) {
      const int r = i / 3, c = i % 3;
      const float* hr = sm.act + r * LDA;
      float v = __ldg(wts + OFF_BR + c);
#pragma unroll 8
      for (int k = 0; k < WH; ++k)
        v = fmaf(__ldg(wts + OFF_WR + k * 3 + c), hr[k], v);
      sm.rgb[r][c] = sigmoid(v);
    }
    __syncthreads();

    // ---- 5. front-to-back compositing, a warp a ray
    for (int rr = warp; rr < n_rays; rr += THREADS / 32) {
      float T = whole ? 1.f : carry_T;
      float sum[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) sum[i] = whole ? 0.f : carry[i];
      composite(sm, whole ? rr * S : 0, len, wout, aout, gbase, T, sum);
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

}  // namespace

// K11: the 20 features of every sample gathered already; weights: the f32
// pack (pack_v1_weights), tc: its tensor-core stream (pack_v1_weights_tc);
// out (N, 5) = rgb, depth, acc; wout, aout (N, S) the compositing weights
// and alphas; fout (N, S, 14) each sample's [volume | colour | colour]
extern "C" int render_v1_feats(const void* ndc, const void* z,
                               const void* feats, const void* dirs,
                               const void* weights, const void* tc,
                               void* out, void* wout, void* aout, void* fout,
                               int N, int S, int n_weights, int n_tc,
                               void* stream) {
  if (n_weights != N_WEIGHTS || n_tc != TC1_TOTAL || S % 8 != 0 || S <= 0 ||
      N <= 0)
    return (int)cudaErrorInvalidValue;
  static bool ready = false;  // the shared-memory opt-in, once
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        render_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)sizeof(Smem));
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int rpc = S <= ROWS ? ROWS / S : 1;
  const long long grid = ((long long)N + rpc - 1) / rpc;
  render_v1_kernel<<<(unsigned)grid, THREADS, sizeof(Smem),
                     (cudaStream_t)stream>>>(
      (const float*)ndc, (const float*)z, (const float*)feats,
      (const float*)dirs, (const float*)weights, (const float*)tc,
      (float*)out, (float*)wout, (float*)aout, (float*)fout, N, S);
  return (int)cudaGetLastError();
}
