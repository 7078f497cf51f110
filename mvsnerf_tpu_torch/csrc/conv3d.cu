// K10: the CostRegNet U-Net's 3x3x3 convolutions, forward and both
// gradients, for the `--costreg_impl dband` route.
//
// Replaces the TPU kernels of mvsnerf_tpu/ops/pallas_costreg.py:
//   conv3d_s1_dband (:210, pallas_call :238)   -> conv3d_s1_tc_kernel
//                                                 (+ conv3d_pack_kernel)
//   conv3d_s2_dband (:337, pallas_call :365)   -> conv3d_s2_pair_kernel
//                                                 (conv3d_fwd_kernel<2>
//                                                 where W % 4 != 0)
//   conv3d_up_dband (:480, pallas_call :513)   -> conv3d_up_cell_kernel
//   _s1_wgrad_dband (:597, pallas_call :612)   -> conv3d_wgrad_tc_kernel<1>
//   _s2_wgrad_dband (:707, pallas_call :722)   -> conv3d_wgrad_tc_kernel<2>
//                                                 + wgrad_reduce_kernel
// The TPU kernels turn each depth band into a banded (Cin*win, Cout*P)
// matrix for the MXU, pad W to 128 lanes, split stride-2 inputs into even
// and odd columns and stream row windows through VMEM. None of that layout
// carries over: here every kernel reads the NCDHW activations (batch 1) in
// place and computes the dense convolution with float32 accuracy.
//
// Weights keep PyTorch's layouts: Conv3d (Cout, Cin, 3, 3, 3) and
// ConvTranspose3d (Cin, Cout, 3, 3, 3). All three gradients of the U-Net
// reduce to these kernels (ops/costreg_conv.py):
//   s1 dgrad = the s1 forward on the flipped, in/out-swapped kernel;
//   s2 dgrad = conv3d_up on the s2 kernel as stored;
//   up dgrad = the s2 forward on the up kernel as stored;
//   wgrad    = dW[a, b, k] = sum_o g[a, o] x[b, s o + k - 1] (the up
//              kernel's by duality, with g = its input and x = its
//              output's cotangent).
//
// ---- Stride 1 and every weight gradient: implicit GEMMs on the tensor
// cores in 3xTF32 (`mma.sync.m16n8k8`, csrc/mlp_tc.cuh). Each float32
// operand is split once, where it is staged into shared memory, into hi =
// x rounded to TF32 and lo = the remainder (read by the tensor core to
// TF32); a product is lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b). Each
// k-step's three passes go into a zeroed fragment that is then added to
// the float32 accumulators (as `mma_ksteps<true>`): the tensor core
// truncates as it accumulates, and a weight gradient sums up to 4.7M
// voxels.
//
// The K order of the forward (and the M order of wgrad) is (chunk of CC =
// 8 input channels, tap, channel in the chunk), flattened: a full chunk
// is 27 k-steps, one tap x 8 channels each, and only the last, partial
// chunk pads, once, to a multiple of 8 (conv0's forward: K 1107 -> 1112,
// not the 1296 of padding 41 channels to 48).
//
// Staging, both kernels: a block's next item (a chunk of a box, or a box)
// lands raw in shared memory by `cp.async` while the current item's
// products run (halo rows as aligned 16-byte groups where the rows start
// on 16 bytes, else float by float), then all threads split it into the
// hi and lo buffers between two barriers.
//
// conv3d_s1_tc_kernel: M = output voxels, N = Cout padded to 8, K = 27 x
// Cin. A block owns a 2 x 4 x 32 box of outputs and 8 warps of 2 m-tiles
// (16-voxel W runs); per chunk it stages the box's halo of the chunk's
// channels with a channel stride = 8 mod 32, so that the 32 lanes of an A
// fragment (8 voxels x 4 channels) hit 32 banks; a full chunk's tap
// offsets are constants of the loop over kw, the partial chunk's come
// from a table. B (the weights) is packed once a call by
// conv3d_pack_kernel in fragment order, hi and lo, one float4 a lane a
// (k-step, n-tile). With one n-tile (conv0's forward), or one chunk and
// one n-tile group (conv0's dgrad, 83 KB of hi/lo: one block a SM), each
// chunk's B lands in shared memory with the halo; otherwise it is read
// through L1 (conv6's 885 KB fit no block), which the staged halo shares.
// What bounds it: the fragment loads from shared memory beside the
// `mma`s, not the tensor pipe's rate. An A fragment costs 8 32-bit loads
// (hi and lo, 8 wavefronts) and feeds 3 `mma`s per n-tile, so conv0's
// forward (Cout 8) needs ~1.3 ms of shared reads at 128 B a clock against
// ~0.5 ms of 3xTF32 products; conv0's dgrad (N 48, each A fragment into
// 18 `mma`s) reads 6 B float4s a k-step beside them. A clock64 split of both
// kernels' blocks on the card put most of their time in the product loop,
// little in the waits for the staged data. Measured times: PERF.md.
//
// conv3d_wgrad_tc_kernel<S>: dW^T[(b, tap), a] = sum_v x[b, S v + tap - 1]
// g[a, v]; M = (chunk, tap, channel) rows, one chunk a block (<= 14
// m-tiles, two a warp), N = A padded to 8 (up to 32 a block at stride 1,
// 16 at stride 2), K = the gradient's voxels in boxes of TD x TH x 32, 8
// consecutive W a k-step. Per box a block stages the x halo of its chunk
// (channel stride = 4 mod 32: rows g of a fragment are channels, columns
// t voxels at stride S) and the box's g rows ([a][voxel], row stride = 4
// mod 32); each lane's row offsets into the x halo are fixed for the
// block. The boxes are cut into fixed runs (`wgrad_plan`), each writing
// its partial sums; wgrad_reduce_kernel adds the runs in order. No
// atomics: dW is bit-identical over calls. Bound as the forward: conv0's
// wgrad (N 8) by shared reads and the staging of a 3.2x halo a box.
//
// Tried on the card and not kept (slower): staging through registers one
// item ahead (spills at 2 blocks a SM); three blocks a SM without the raw
// buffer; producer warps staging for consumer warps (the producers' loads
// set the pace); voxel-major tiles read as 64- and 128-bit fragment loads;
// wgrad's g read as one float4 a lane; a shared-memory carveout leaving
// more L1 (no change).
//
// `mma.sync` rather than `wgmma`, as in csrc/mlp_tc.cuh: A is an im2col
// view, gathered per lane from the staged halo, not a canonical tile.
//
// ---- Stride 2 and the transposed convolution: f32 FMAs (SIMT).
// conv3d_fwd_kernel<2>: one thread per output voxel with a tile of COT
// output channels in registers; the block's weights for a chunk of input
// channels sit in shared memory as [channel, tap][COT] rows, read as
// broadcast float4s. With W % 4 == 0 (every DTU layer) a thread takes a
// pair of W outputs instead: one float4 and a shuffle feed both
// (conv3d_s2_pair_kernel), and the blocks are sized to give every SM the
// same load. conv3d_up_cell_kernel, the transposed convolution (the up
// layers' forward and the stride-2 layers' dgrad), in gather form: one
// thread per cell of 2 x 2 output rows x four W outputs 4q .. 4q + 3 x 4
// channels, whose 9 (row, kd, kh) taps share the inputs 2q .. 2q + 2 of 4
// input rows (a float2 and a shuffle each) and feed 8 multiply-adds per
// weight float4; only taps of matching parity exist, so no atomics, and
// every thread does the same work. Every width: the float2 where Wi is
// even (the DTU layers' 26, 52 and 104), two scalar loads where it is odd.
// They are bound by f32 FMA issue; PERF.md has the measured times per
// layer.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_tc.cuh"

namespace {

using mlp_tc::mma;
using mlp_tc::split;
using mlp_tc::tf32_rna;

constexpr int THREADS = 256;
constexpr int WCHUNK = 256;  // COT x input channels per weight chunk
constexpr int SMS_FALLBACK = 132;
constexpr int PAIR_MAX_THREADS = 640;  // the paired s2 kernel's largest block
constexpr int UP_MAX_THREADS = 512;    // the transposed kernel's largest block
// the tensor-core kernels: input channels a staged chunk, and the W extent
// of a tile (two 16-voxel m-tiles, four 8-voxel k-steps)
constexpr int CC = 8;
constexpr int TW = 32;

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms <= 0)
      sms = SMS_FALLBACK;
  }
  return sms;
}

// Stage the weights of input channels [c0, c0 + CIC) and output channels
// [co0, co0 + COT) as sw[(cl * 27 + tap) * COT + co]; out-of-range entries
// are 0. `io_major` reads (Cin, Cout, 27) (ConvTranspose3d), else (Cout,
// Cin, 27) (Conv3d).
template <int COT>
__device__ __forceinline__ void stage_weights(float* sw,
                                              const float* __restrict__ w,
                                              int Cin, int Cout, int c0,
                                              int co0, bool io_major,
                                              int nt = THREADS) {
  constexpr int CIC = WCHUNK / COT;
  for (int i = threadIdx.x; i < CIC * 27 * COT; i += nt) {
    const int co = i % COT, r = i / COT, cl = r / 27, tap = r % 27;
    const int ci = c0 + cl, o = co0 + co;
    float v = 0.f;
    if (ci < Cin && o < Cout)
      v = io_major ? w[((long long)ci * Cout + o) * 27 + tap]
                   : w[((long long)o * Cin + ci) * 27 + tap];
    sw[i] = v;
  }
}

template <int COT>
__device__ __forceinline__ void fma_row(float (&acc)[COT], const float* sw,
                                        float xv) {
  const float4* w4 = reinterpret_cast<const float4*>(sw);
#pragma unroll
  for (int j = 0; j < COT / 4; ++j) {
    const float4 q = w4[j];
    acc[4 * j] = fmaf(q.x, xv, acc[4 * j]);
    acc[4 * j + 1] = fmaf(q.y, xv, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(q.z, xv, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(q.w, xv, acc[4 * j + 3]);
  }
}

// y[co, o] = sum_{ci, k} w[co, ci, k] x[ci, S o + k - 1], zero padding.
template <int S, int COT>
__global__ void __launch_bounds__(THREADS)
conv3d_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ y, int Cin, int Cout, int Di, int Hi,
                  int Wi, int Do, int Ho, int Wo) {
  constexpr int CIC = WCHUNK / COT;
  __shared__ __align__(16) float sw[CIC * 27 * COT];
  const int n_out = Do * Ho * Wo;
  const int v = blockIdx.x * THREADS + threadIdx.x;
  const int co0 = blockIdx.y * COT;
  const bool live = v < n_out;
  int od = 0, oh = 0, ow = 0;
  if (live) {
    ow = v % Wo;
    const int t = v / Wo;
    oh = t % Ho;
    od = t / Ho;
  }
  const int id0 = S * od - 1, ih0 = S * oh - 1, iw0 = S * ow - 1;
  const long long plane = (long long)Di * Hi * Wi;
  float acc[COT];
#pragma unroll
  for (int j = 0; j < COT; ++j) acc[j] = 0.f;
  for (int c0 = 0; c0 < Cin; c0 += CIC) {
    __syncthreads();
    stage_weights<COT>(sw, w, Cin, Cout, c0, co0, false);
    __syncthreads();
    if (!live) continue;
    const int nc = min(CIC, Cin - c0);
    for (int cl = 0; cl < nc; ++cl) {
      const float* xc = x + (c0 + cl) * plane;
      const float* swc = sw + cl * 27 * COT;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int id = id0 + kd;
        if (id < 0 || id >= Di) continue;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int ih = ih0 + kh;
          if (ih < 0 || ih >= Hi) continue;
          const float* row = xc + ((long long)id * Hi + ih) * Wi;
#pragma unroll
          for (int kw = 0; kw < 3; ++kw) {
            const int iw = iw0 + kw;
            if (iw < 0 || iw >= Wi) continue;
            fma_row<COT>(acc, swc + ((kd * 3 + kh) * 3 + kw) * COT,
                         __ldg(row + iw));
          }
        }
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < COT; ++j)
    if (co0 + j < Cout) y[(long long)(co0 + j) * n_out + v] = acc[j];
}

// a0 += w * x0, a1 += w * x1 over one tap's COT output channels
template <int COT>
__device__ __forceinline__ void fma_pair(float (&a0)[COT], float (&a1)[COT],
                                         const float* sw, float x0,
                                         float x1) {
  const float4* w4 = reinterpret_cast<const float4*>(sw);
#pragma unroll
  for (int j = 0; j < COT / 4; ++j) {
    const float4 q = w4[j];
    a0[4 * j] = fmaf(q.x, x0, a0[4 * j]);
    a0[4 * j + 1] = fmaf(q.y, x0, a0[4 * j + 1]);
    a0[4 * j + 2] = fmaf(q.z, x0, a0[4 * j + 2]);
    a0[4 * j + 3] = fmaf(q.w, x0, a0[4 * j + 3]);
    a1[4 * j] = fmaf(q.x, x1, a1[4 * j]);
    a1[4 * j + 1] = fmaf(q.y, x1, a1[4 * j + 1]);
    a1[4 * j + 2] = fmaf(q.z, x1, a1[4 * j + 2]);
    a1[4 * j + 3] = fmaf(q.w, x1, a1[4 * j + 3]);
  }
}

// Stride 2 with each thread on the pair of W outputs (2p, 2p + 1) of one
// (od, oh) row, COT channels each: their 6 taps of an input row are the 5
// columns 4p - 1 .. 4p + 3, read as one float4 (4p .. 4p + 3) and the left
// neighbour lane's last column by a shuffle (the row's first pair has
// none: the zero padding), so a warp's row read is 512 contiguous bytes
// instead of three half-used stride-2 sweeps, and each staged weight
// float4 feeds 8 multiply-adds. Needs Wi % 4 == 0 (16-byte rows; Wo = Wi /
// 2 even, every float4 in range). Rows outside the input read zeros rather
// than branching, so every lane reaches the shuffle; the sums are the
// per-output kernel's, in the same tap order. Any block size up to
// PAIR_MAX_THREADS (a multiple of 32): s2_pair_plan sizes the blocks so
// that every SM gets the same number of pairs.
template <int COT>
__global__ void __launch_bounds__(PAIR_MAX_THREADS)
conv3d_s2_pair_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ y,
                      int Cin, int Cout, int Di, int Hi, int Wi, int Do,
                      int Ho, int Wo) {
  constexpr int CIC = WCHUNK / COT;
  __shared__ __align__(16) float sw[CIC * 27 * COT];
  const int Wp = Wo / 2;
  const int n_pairs = Do * Ho * Wp;
  const int nt = blockDim.x;
  const int v = blockIdx.x * nt + threadIdx.x;
  const int co0 = blockIdx.y * COT;
  const int lane = threadIdx.x & 31;
  const bool live = v < n_pairs;
  int od = 0, oh = 0, p = 0;
  if (live) {
    p = v % Wp;
    const int t = v / Wp;
    oh = t % Ho;
    od = t / Ho;
  }
  const long long plane = (long long)Di * Hi * Wi;
  float a0[COT], a1[COT];
#pragma unroll
  for (int j = 0; j < COT; ++j) a0[j] = a1[j] = 0.f;
  for (int c0 = 0; c0 < Cin; c0 += CIC) {
    __syncthreads();
    stage_weights<COT>(sw, w, Cin, Cout, c0, co0, false, nt);
    __syncthreads();
    const int nc = min(CIC, Cin - c0);
    for (int cl = 0; cl < nc; ++cl) {
      const float* xc = x + (c0 + cl) * plane;
      const float* swc = sw + cl * 27 * COT;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        const int id = 2 * od - 1 + kd;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          const int ih = 2 * oh - 1 + kh;
          const bool ok = live && id >= 0 && id < Di && ih >= 0 && ih < Hi;
          const float* row = xc + ((long long)id * Hi + ih) * Wi;
          float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
          if (ok) q = __ldg(reinterpret_cast<const float4*>(row) + p);
          float left = __shfl_up_sync(0xffffffffu, q.w, 1);
          if (p == 0)
            left = 0.f;
          else if (lane == 0)
            left = ok ? __ldg(row + 4 * p - 1) : 0.f;
          const float* wr = swc + (kd * 3 + kh) * 3 * COT;
          fma_pair<COT>(a0, a1, wr, left, q.y);           // kw = 0
          fma_pair<COT>(a0, a1, wr + COT, q.x, q.z);      // kw = 1
          fma_pair<COT>(a0, a1, wr + 2 * COT, q.y, q.w);  // kw = 2
        }
      }
    }
  }
  if (!live) return;
  const long long n_out = (long long)Do * Ho * Wo;
  const long long o = ((long long)od * Ho + oh) * Wo + 2 * p;
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    if (co0 + j >= Cout) break;
    y[(co0 + j) * n_out + o] = a0[j];
    y[(co0 + j) * n_out + o + 1] = a1[j];
  }
}

// Transposed stride-2 convolution, pad 1 (torch ConvTranspose3d with
// output_padding 1 when Do = 2 Di): y[co, o] = sum over ci, k with
// o = 2 i - 1 + k of w[ci, co, k] x[ci, i]. Along each axis an even output
// 2 m takes tap 1 at i = m, an odd one 2 m + 1 tap 0 at i = m + 1 and tap 2
// at i = m. Each thread owns a cell of outputs: the 2 x 2 (od, oh) rows
// 2 md + {0, 1}, 2 mh + {0, 1} (one of each parity class, so every thread
// does the same work and a warp never diverges on parity), the four W
// outputs 4 q .. 4 q + 3 of each, and UP_COT channels: 64 sums. Per input
// channel the cell reads the 2 x 2 input rows (md, mh) .. (md + 1, mh + 1)
// at inputs 2 q, 2 q + 1 (one float2 where the rows start on 8 bytes, Wi
// even) and 2 q + 2 (the right neighbour lane's first, by a shuffle; lane
// 31 loads it, a row's last quad takes the zero past its end), and its 9
// (row, kd, kh) taps each feed the W outputs as
//   y[4q]     = w1 x[2q]             y[4q + 1] = w0 x[2q + 1] + w2 x[2q]
//   y[4q + 2] = w1 x[2q + 1]         y[4q + 3] = w0 x[2q + 2] + w2 x[2q + 1]
// so each staged weight float4 feeds 8 multiply-adds. Rows outside the
// input read zeros rather than branching, so every lane reaches the
// shuffles. Any block size up to UP_MAX_THREADS (a multiple of 32):
// up_cell_plan sizes them so that every SM gets the same number of cells.
constexpr int UP_COT = 4;

__global__ void __launch_bounds__(UP_MAX_THREADS)
conv3d_up_cell_kernel(const float* __restrict__ x,
                      const float* __restrict__ w, float* __restrict__ y,
                      int Cin, int Cout, int Di, int Hi, int Wi, int Do,
                      int Ho, int Wo, int vec2, int vec4) {
  constexpr int COT = UP_COT, CIC = WCHUNK / COT;
  __shared__ __align__(16) float sw[CIC * 27 * COT];
  const int nmd = (Do + 1) / 2, nmh = (Ho + 1) / 2, nq = (Wi + 1) / 2;
  const int nt = blockDim.x;
  const long long n_cells = (long long)nmd * nmh * nq;
  const long long v = (long long)blockIdx.x * nt + threadIdx.x;
  const int co0 = blockIdx.y * COT;
  const int lane = threadIdx.x & 31;
  const bool live = v < n_cells;
  int md = 0, mh = 0, q = 0;
  if (live) {
    q = (int)(v % nq);
    const long long t = v / nq;
    mh = (int)(t % nmh);
    md = (int)(t / nmh);
  }
  const bool last = q + 1 >= nq;  // x[2q + 2] lies past the row's end
  const long long plane = (long long)Di * Hi * Wi;
  // input row r = (md + (r >> 1), mh + (r & 1))
  long long roff[4];
  bool rok[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int id = md + (r >> 1), ih = mh + (r & 1);
    rok[r] = live && id < Di && ih < Hi;
    roff[r] = ((long long)id * Hi + ih) * Wi;
  }
  // a[(ed * 2 + eh) * 4 + k][j]: output row (2 md + ed, 2 mh + eh), W
  // output 4 q + k, channel co0 + j
  float a[16][COT];
#pragma unroll
  for (int o = 0; o < 16; ++o)
#pragma unroll
    for (int j = 0; j < COT; ++j) a[o][j] = 0.f;
  for (int c0 = 0; c0 < Cin; c0 += CIC) {
    __syncthreads();
    stage_weights<COT>(sw, w, Cin, Cout, c0, co0, true, nt);
    __syncthreads();
    const int nc = min(CIC, Cin - c0);
    for (int cl = 0; cl < nc; ++cl) {
      const float* xc = x + (c0 + cl) * plane;
      const float* swc = sw + cl * 27 * COT;
      float x0[4], x1[4], x2[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* row = xc + roff[r];
        x0[r] = x1[r] = x2[r] = 0.f;
        if (rok[r]) {
          if (vec2) {
            const float2 p = __ldg(reinterpret_cast<const float2*>(row) + q);
            x0[r] = p.x;
            x1[r] = p.y;
          } else {
            x0[r] = __ldg(row + 2 * q);
            if (2 * q + 1 < Wi) x1[r] = __ldg(row + 2 * q + 1);
          }
          if (!last && lane == 31) x2[r] = __ldg(row + 2 * q + 2);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float right = __shfl_down_sync(0xffffffffu, x0[r], 1);
        if (last)
          x2[r] = 0.f;
        else if (lane != 31)
          x2[r] = right;
      }
      // the 9 taps: output row parity e, input row offset m, kernel tap k
      // along d and h (even: k 1 at m 0; odd: k 0 at m 1, k 2 at m 0)
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int td = t / 3, th = t % 3;  // 0: even, 1: odd k 0, 2: odd k 2
        const int ed = td > 0, eh = th > 0;
        const int kd = td == 0 ? 1 : td == 1 ? 0 : 2;
        const int kh = th == 0 ? 1 : th == 1 ? 0 : 2;
        const int r = (td == 1) * 2 + (th == 1);
        const float* wr = swc + (kd * 3 + kh) * 3 * COT;
        const int o = (ed * 2 + eh) * 4;
        fma_pair<COT>(a[o], a[o + 2], wr + COT, x0[r], x1[r]);      // kw 1
        fma_pair<COT>(a[o + 1], a[o + 3], wr, x1[r], x2[r]);        // kw 0
        fma_pair<COT>(a[o + 1], a[o + 3], wr + 2 * COT, x0[r], x1[r]);  // 2
      }
    }
  }
  if (!live) return;
  const long long n_out = (long long)Do * Ho * Wo;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int od = 2 * md + (e >> 1), oh = 2 * mh + (e & 1);
    if (od >= Do || oh >= Ho) continue;
    const long long o = ((long long)od * Ho + oh) * Wo + 4 * q;
#pragma unroll
    for (int j = 0; j < COT; ++j) {
      if (co0 + j >= Cout) break;
      float* yo = y + (co0 + j) * n_out + o;
      if (vec4 && 4 * q + 3 < Wo) {
        *reinterpret_cast<float4*>(yo) = make_float4(
            a[4 * e][j], a[4 * e + 1][j], a[4 * e + 2][j], a[4 * e + 3][j]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * q + k < Wo) yo[k] = a[4 * e + k][j];
      }
    }
  }
}

// ---- the tensor-core kernels

// the smallest stride >= n that is r mod 32
__host__ __device__ constexpr int pad_stride(int n, int r) {
  return (n - r + 31) / 32 * 32 + r;
}

// k-steps of the (chunk, tap, channel) K order over Cin channels: 27 a
// full chunk, the partial one's 27 nc taps rounded up to 8
__host__ __device__ constexpr int k_steps(int cin) {
  return 27 * (cin / CC) + (27 * (cin % CC) + 7) / 8;
}

// the offset of tap (kd, kh, kw) in a halo of rows pw, planes plane
__host__ __device__ constexpr int tap_offset(int tap, int pw, int plane) {
  return tap / 9 * plane + tap / 3 % 3 * pw + tap % 3;
}

// B of the stride-1 GEMM: bp[(ks * n_nt + nb) * 32 + lane] = {hi(b0),
// hi(b1), lo(b0), lo(b1)}, b0 = W[k = 8 ks + t][co = 8 nb + g], b1 at k +
// 4 (lane = 4 g + t), K in the (chunk, tap, channel) order, zero beyond
// Cin's 27 Cin rows and Cout's columns; lo is rounded to TF32 too
__global__ void conv3d_pack_kernel(const float* __restrict__ w,
                                   float4* __restrict__ bp, int Cin,
                                   int Cout, int n_nt) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= k_steps(Cin) * n_nt * 32) return;
  const int lane = i & 31, nb = (i >> 5) % n_nt, ks = (i >> 5) / n_nt;
  const int co = 8 * nb + (lane >> 2);
  float v[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int k = 8 * ks + (lane & 3) + 4 * j, q = k / (27 * CC);
    const int nc = min(CC, Cin - CC * q), kl = k - 27 * CC * q;
    v[j] = co < Cout && kl < 27 * nc
               ? w[((long long)co * Cin + CC * q + kl % nc) * 27 + kl / nc]
               : 0.f;
  }
  const uint32_t h0 = tf32_rna(v[0]), h1 = tf32_rna(v[1]);
  bp[i] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                      __uint_as_float(tf32_rna(v[0] - __uint_as_float(h0))),
                      __uint_as_float(tf32_rna(v[1] - __uint_as_float(h1))));
}

// the 3xTF32 product of one k-step into acc, through a zeroed fragment
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, al, bh0, bh1);
  mma(t, ah, bl0, bl1);
  mma(t, ah, bh0, bh1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// value v split into hi and lo at hi[i], lo[i]
__device__ __forceinline__ void put_split(float* hi, float* lo, int i,
                                          float v) {
  uint32_t h, l;
  split(v, h, l);
  hi[i] = __uint_as_float(h);
  lo[i] = __uint_as_float(l);
}

// 4 bytes from global to shared memory without holding a register: dst =
// *src where ok, else 0 (cp.async's zero fill; src is then not read)
__device__ __forceinline__ void load_async(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   mlp_tc::smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 16 bytes from global to shared memory, not through L1: dst = *src
// where ok, else 16 zero bytes
__device__ __forceinline__ void load_async16(void* dst, const void* src,
                                             bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   mlp_tc::smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// A warp's copy of one halo row into raw row dst of RW floats: raw column
// k holds input column col0 - 4 + k of the row src (w columns; zeros off
// it, or where !row_ok). With vec (16-byte rows, w % 4 == 0) in aligned
// 16-byte groups, else float by float. `any` is a valid address.
template <int RW>
__device__ __forceinline__ void fetch_row(float* dst, const float* src,
                                          bool row_ok, int col0, int w,
                                          bool vec, const float* any) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    for (int l = lane; l < RW / 4; l += 32) {
      const int col = col0 - 4 + 4 * l;
      const bool ok = row_ok && col >= 0 && col < w;
      load_async16(dst + 4 * l, ok ? src + col : any, ok);
    }
  } else {
    for (int k = lane; k < RW; k += 32) {
      const int col = col0 - 4 + k;
      const bool ok = row_ok && col >= 0 && col < w;
      load_async(dst + k, ok ? src + col : any, ok);
    }
  }
}

// Split raw rows (RW floats, columns 3 .. PW + 2 used) of n_rows into hi
// and lo rows of PW floats: raw row r = (channel, row of ROWS) lands at
// channel * CS + row * PW. Every thread of the block, a float4 at a time.
template <int RW, int PW, int ROWS, int CS>
__device__ __forceinline__ void split_rows(float* hi, float* lo,
                                           const float* raw, int n_rows,
                                           int tid, int nt) {
  static_assert(RW % 4 == 0 && RW >= PW + 3, "raw rows");
  for (int e = 4 * tid; e < n_rows * RW; e += 4 * nt) {
    const int r = e / RW, col = e % RW;
    const int o = r / ROWS * CS + r % ROWS * PW + col - 3;
    const float4 v = *reinterpret_cast<const float4*>(raw + e);
    const float f[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (col + j >= 3 && col + j < PW + 3) put_split(hi, lo, o + j, f[j]);
  }
}

// raw[i .. i + 3] split into hi and lo at o .. o + 3 (16-byte aligned)
__device__ __forceinline__ void put_split4(float* hi, float* lo, int o,
                                           const float* raw) {
  const float4 v = *reinterpret_cast<const float4*>(raw);
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *reinterpret_cast<float4*>(hi + o) =
      make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                  __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(lo + o) =
      make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                  __uint_as_float(l[2]), __uint_as_float(l[3]));
}

__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The stride-1 forward's tile: a 2 x 4 x TW box of outputs, 8 warps of 2
// m-tiles (16-voxel W runs); a chunk's halo lands raw (rows of RW floats)
// while the last chunk's products run, and is split into hi and lo, a
// channel CS floats apart (= 8 mod 32)
struct S1Tile {
  static constexpr int MT = 2, TD = 2, TH = 4;
  static constexpr int PH = TH + 2, PW = TW + 2, PLANE = PH * PW;
  static constexpr int HALO = (TD + 2) * PLANE;
  static constexpr int RW = TW + 8;  // a raw row: 16-byte groups
  static constexpr int RAW = CC * (TD + 2) * PH * RW;
  static constexpr int CS = pad_stride(HALO, 8);
  static constexpr int TABLE = 27 * CC;  // the partial chunk's offsets
  static constexpr int SMEM = (2 * CC * CS + RAW + TABLE) * 4;
  // B in shared memory (SB): a chunk's k-steps for n n-tiles, two
  // buffers where there are several chunks
  static int b_smem(int n_nt, int cin) {
    return (cin > CC ? 2 : 1) * 27 * n_nt * 32 * 16;
  }
  static_assert(8 * MT == TD * TH * TW / 16, "a warp's m-tiles");
  static_assert(CS % 4 == 0 && RAW % 4 == 0 && TABLE % 4 == 0,
                "16-byte rows");
};

// y[co, o] = sum over k = (chunk, tap, channel) of x[c, o + tap - 1]
// B[k, co]: stride 1, pad 1, y the size of x. Block (box, n-tile group):
// n-tiles NT blockIdx.y .. + NT - 1 of n_nt. SB (one n-tile group): each
// chunk's B lands in shared memory with its halo, in buffer q & 1; else B
// is read through L1, which it would share with the staged halo.
template <int NT, bool SB>
__global__ void __launch_bounds__(THREADS, 2)
    conv3d_s1_tc_kernel(const float* __restrict__ x,
                        const float4* __restrict__ bp, float* __restrict__ y,
                        int Cin, int Cout, int D, int H, int W, int nbh,
                        int nbw, int n_nt, int vec) {
  using T = S1Tile;
  constexpr int MT = T::MT;
  extern __shared__ __align__(16) float smem[];
  float* sh = smem;                 // [channel][halo], hi
  float* sl = sh + CC * T::CS;      // lo
  float* raw = sl + CC * T::CS;     // the next chunk, [channel][halo]
  int* toff = reinterpret_cast<int*>(raw + T::RAW);
  float4* sb = reinterpret_cast<float4*>(toff + T::TABLE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bw = blockIdx.x % nbw, bh = blockIdx.x / nbw % nbh,
            bd = blockIdx.x / nbw / nbh;
  const int od0 = bd * T::TD, oh0 = bh * T::TH, ow0 = bw * TW;
  const int nb0 = blockIdx.y * NT;
  const long long plane = (long long)D * H * W;
  int base[MT];  // row g of m-tile mi in the halo (row g + 8 at + 8)
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int m = warp + 8 * mi;
    base[mi] = m / (2 * T::TH) * T::PLANE + (m >> 1) % T::TH * T::PW +
               (m & 1) * 16 + g;
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int mi = 0; mi < MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // chunk q's halo into raw: a warp a (channel, plane, row), lanes along W
  const auto fetch = [&](int q) {
    const int nc = min(CC, Cin - CC * q);
    constexpr int ROWS = (T::TD + 2) * T::PH;
    for (int r = warp; r < nc * ROWS; r += THREADS / 32) {
      const int c = r / ROWS, pd = r % ROWS / T::PH, ph = r % T::PH;
      const int id = od0 - 1 + pd, ih = oh0 - 1 + ph;
      const bool row_ok = id >= 0 && id < D && ih >= 0 && ih < H;
      const float* src =
          x + (CC * q + c) * plane + ((long long)id * H + ih) * W;
      fetch_row<T::RW>(raw + r * T::RW, src, row_ok, ow0, W, vec, x);
    }
    if (SB)
      for (int i = tid; i < (27 * nc + 7) / 8 * n_nt * 32; i += THREADS)
        load_async16(sb + (q & 1) * 27 * n_nt * 32 + i,
                     bp + 27 * 32 * n_nt * q + i);
  };

  // one k-step: A's rows at this lane's voxels, columns at halo offsets
  // o0 (channel t) and o1 (channel t + 4); B from bk
  const auto kstep = [&](const float4* __restrict__ bk, int o0, int o1) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      const float *ph = sh + base[mi], *pl = sl + base[mi];
      ah[mi][0] = __float_as_uint(ph[o0]);
      ah[mi][1] = __float_as_uint(ph[o0 + 8]);
      ah[mi][2] = __float_as_uint(ph[o1]);
      ah[mi][3] = __float_as_uint(ph[o1 + 8]);
      al[mi][0] = __float_as_uint(pl[o0]);
      al[mi][1] = __float_as_uint(pl[o0 + 8]);
      al[mi][2] = __float_as_uint(pl[o1]);
      al[mi][3] = __float_as_uint(pl[o1 + 8]);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      if (nb0 + ni >= n_nt) break;
      const float4 b = SB ? bk[ni * 32] : __ldg(bk + (nb0 + ni) * 32);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        mma3(acc[mi][ni], ah[mi], al[mi], __float_as_uint(b.x),
             __float_as_uint(b.y), __float_as_uint(b.z),
             __float_as_uint(b.w));
    }
  };

  fetch(0);
  for (int q = 0; CC * q < Cin; ++q) {
    const int nc = min(CC, Cin - CC * q);
    wait_async();
    __syncthreads();  // raw holds chunk q; the last chunk's products done
    split_rows<T::RW, T::PW, (T::TD + 2) * T::PH, T::CS>(
        sh, sl, raw, nc * (T::TD + 2) * T::PH, tid, THREADS);
    if (nc < CC)  // k = tap nc + c; the padding reads channel 0 (B is 0)
      for (int k = tid; k < T::TABLE; k += THREADS)
        toff[k] = k < 27 * nc ? k % nc * T::CS +
                                    tap_offset(k / nc, T::PW, T::PLANE)
                              : 0;
    __syncthreads();
    if (CC * (q + 1) < Cin) fetch(q + 1);  // lands during the products
    const float4* bq = SB ? sb + (q & 1) * 27 * n_nt * 32 + lane
                          : bp + (long long)27 * q * n_nt * 32 + lane;
    if (nc == CC) {
#pragma unroll 1
      for (int kdh = 0; kdh < 9; ++kdh) {  // taps 3 kdh .. 3 kdh + 2
        const int to = kdh / 3 * T::PLANE + kdh % 3 * T::PW;
        const float4* bk = bq + 3 * kdh * n_nt * 32;
#pragma unroll
        for (int kw = 0; kw < 3; ++kw)
          kstep(bk + kw * n_nt * 32, t * T::CS + to + kw,
                (t + 4) * T::CS + to + kw);
      }
    } else {
      const int ks_n = (27 * nc + 7) / 8;
      for (int ks = 0; ks < ks_n; ++ks)
        kstep(bq + ks * n_nt * 32, toff[8 * ks + t], toff[8 * ks + t + 4]);
    }
  }

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
#pragma unroll
  for (int mi = 0; mi < MT; ++mi) {
    const int m = warp + 8 * mi;
    const int od = od0 + m / (2 * T::TH), oh = oh0 + (m >> 1) % T::TH;
    if (od >= D || oh >= H) continue;
    const long long row = ((long long)od * H + oh) * W;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ow = ow0 + (m & 1) * 16 + g + 8 * h;
      if (ow >= W) continue;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = 8 * (nb0 + ni) + 2 * t + e;
          if (co < Cout) y[co * plane + row + ow] = acc[mi][ni][2 * h + e];
        }
    }
  }
}

// The weight gradient's tile: boxes of TD x TH x TW gradient voxels; the
// x halo of a channel CS floats apart (= 4 mod 32), g's rows LG apart; a
// box's x halo (rows of RW floats) and g rows land raw while the last
// box's products run
template <int S, int NT>
struct WgTile {
  static constexpr int TD = S == 1 && NT == 1 ? 2 : 1, TH = S == 1 ? 4 : 2;
  static constexpr int TV = TD * TH * TW;  // voxels a box: TV / 8 k-steps
  static constexpr int PH = S * (TH - 1) + 3, PW = S * (TW - 1) + 3;
  static constexpr int PLANE = PH * PW, PD = S * (TD - 1) + 3;
  static constexpr int HALO = PD * PLANE;
  static constexpr int CS = pad_stride(HALO, 4);
  static constexpr int LG = TV + 4;
  // a raw x row: 16-byte groups from S ow0 - 4 past S (TW - 1) + 1
  static constexpr int RW = 4 + (S * (TW - 1) + 5) / 4 * 4;
  static constexpr int RAWX = CC * PD * PH * RW;
  static constexpr int RAW = RAWX + 8 * NT * TV;
  static constexpr int SMEM = (2 * (CC * CS + 8 * NT * LG) + RAW) * 4;
  static_assert(CS % 4 == 0 && LG % 4 == 0 && RAWX % 4 == 0,
                "16-byte rows");
  static_assert(LG % 32 == 4, "g rows on distinct banks");
};

// partial[z][a][b * 27 + tap] = sum over box run z's voxels v of g[a, v]
// x[b, S v + tap - 1]. Block (chunk blockIdx.x of CC input channels,
// gradient channels 8 NT blockIdx.y .., run blockIdx.z).
template <int S, int NT>
__global__ void __launch_bounds__(THREADS, 2)
    conv3d_wgrad_tc_kernel(const float* __restrict__ gr,
                           const float* __restrict__ x,
                           float* __restrict__ partial, int A, int B, int Dg,
                           int Hg, int Wg, int Dx, int Hx, int Wx, int nbh,
                           int nbw, int n_boxes, int per_run, int vec_x,
                           int vec_g) {
  using T = WgTile<S, NT>;
  extern __shared__ __align__(16) float smem[];
  float* xh = smem;                 // [channel][halo]
  float* xl = xh + CC * T::CS;
  float* gh = xl + CC * T::CS;      // [a][voxel of the box]
  float* gl = gh + 8 * NT * T::LG;
  float* raw = gl + 8 * NT * T::LG;  // the next box: x halo, then g rows
  float* graw = raw + T::RAWX;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q = blockIdx.x, a0 = 8 * NT * blockIdx.y;
  const int nc = min(CC, B - CC * q), rows = 27 * nc;
  const int n_mt = (rows + 15) / 16, na = min(8 * NT, A - a0);
  const long long plane_x = (long long)Dx * Hx * Wx,
                  plane_g = (long long)Dg * Hg * Wg;
  // rows 16 (warp + 8 mi) + g + 8 h = tap nc + c: their halo offsets
  int roff[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (warp + 8 * mi) + g + 8 * h;
      roff[mi][h] =
          r < rows ? r % nc * T::CS + tap_offset(r / nc, T::PW, T::PLANE) : 0;
    }
  const bool live[2] = {warp < n_mt, warp + 8 < n_mt};
  float acc[2][NT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // a box's x halo (a warp a (channel, plane, row)) and g rows (a warp a
  // (a, plane, row)) into raw, lanes along W
  const auto fetch = [&](int box) {
    const int bw = box % nbw, bh = box / nbw % nbh, bd = box / nbw / nbh;
    const int od0 = bd * T::TD, oh0 = bh * T::TH, ow0 = bw * TW;
    constexpr int XROWS = T::PD * T::PH;
    for (int r = warp; r < nc * XROWS; r += THREADS / 32) {
      const int c = r / XROWS, pd = r % XROWS / T::PH, ph = r % T::PH;
      const int id = S * od0 - 1 + pd, ih = S * oh0 - 1 + ph;
      const bool row_ok = id >= 0 && id < Dx && ih >= 0 && ih < Hx;
      const float* src =
          x + (CC * q + c) * plane_x + ((long long)id * Hx + ih) * Wx;
      fetch_row<T::RW>(raw + r * T::RW, src, row_ok, S * ow0, Wx, vec_x, x);
    }
    // g rows: TW floats from column ow0 (fetch_row's col0 - 4)
    for (int r = warp; r < na * T::TD * T::TH; r += THREADS / 32) {
      const int od = od0 + r % (T::TD * T::TH) / T::TH,
                oh = oh0 + r % T::TH;
      const bool ok = od < Dg && oh < Hg;
      const float* src = gr + (a0 + r / (T::TD * T::TH)) * plane_g +
                         ((long long)od * Hg + oh) * Wg;
      fetch_row<TW>(graw + r * TW, src, ok, ow0 + 4, Wg, vec_g, gr);
    }
  };

  const int box_end = min(n_boxes, (blockIdx.z + 1) * per_run);
  if (blockIdx.z * per_run < box_end) fetch(blockIdx.z * per_run);
  for (int box = blockIdx.z * per_run; box < box_end; ++box) {
    wait_async();
    __syncthreads();  // raw holds this box; the last box's products done
    split_rows<T::RW, T::PW, T::PD * T::PH, T::CS>(
        xh, xl, raw, nc * T::PD * T::PH, tid, THREADS);
    for (int i = 4 * tid; i < na * T::TV; i += 4 * THREADS)
      put_split4(gh, gl, i / T::TV * T::LG + i % T::TV, graw + i);
    __syncthreads();
    if (box + 1 < box_end) fetch(box + 1);  // lands during the products
#pragma unroll
    for (int ks = 0; ks < T::TV / 8; ++ks) {
      // voxels 8 ks .. + 7 of the box: row ks / 4, W 8 (ks % 4) ..
      const int rr = ks / 4;
      const int vo = S * (rr / T::TH) * T::PLANE + S * (rr % T::TH) * T::PW +
                     S * (8 * (ks % 4) + t);
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if (!live[mi]) continue;
        const int o0 = roff[mi][0] + vo, o1 = roff[mi][1] + vo;
        ah[mi][0] = __float_as_uint(xh[o0]);
        ah[mi][1] = __float_as_uint(xh[o1]);
        ah[mi][2] = __float_as_uint(xh[o0 + 4 * S]);
        ah[mi][3] = __float_as_uint(xh[o1 + 4 * S]);
        al[mi][0] = __float_as_uint(xl[o0]);
        al[mi][1] = __float_as_uint(xl[o1]);
        al[mi][2] = __float_as_uint(xl[o0 + 4 * S]);
        al[mi][3] = __float_as_uint(xl[o1 + 4 * S]);
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const int o = (8 * ni + g) * T::LG + 8 * ks + t;
        const uint32_t bh0 = __float_as_uint(gh[o]),
                       bh1 = __float_as_uint(gh[o + 4]),
                       bl0 = __float_as_uint(gl[o]),
                       bl1 = __float_as_uint(gl[o + 4]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          if (live[mi]) mma3(acc[mi][ni], ah[mi], al[mi], bh0, bh1, bl0, bl1);
      }
    }
  }

  float* P = partial + (long long)blockIdx.z * A * B * 27;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * (warp + 8 * mi) + g + 8 * h;
      if (r >= rows) continue;
      const int col = (CC * q + r % nc) * 27 + r / nc;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int a = 8 * ni + 2 * t + e;
          if (a < na)
            P[(long long)(a0 + a) * B * 27 + col] = acc[mi][ni][2 * h + e];
        }
    }
}

// out[i] = sum of the splits' partials, in split order
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial,
                                float* __restrict__ out, int n, int n_splits) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < n_splits; ++b) s += partial[(long long)b * n + i];
  out[i] = s;
}

// The output-channel tile: the least padding of Cout, then the larger
// tile, then halved while the grid has fewer than two blocks per SM.
int pick_cot(int cout, long long n_blocks) {
  auto padded = [cout](int t) { return (cout + t - 1) / t * t; };
  int cot = 32;
  if (padded(16) < padded(cot)) cot = 16;
  if (padded(8) < padded(cot)) cot = 8;
  while (cot > 8 && n_blocks * ((cout + cot - 1) / cot) < 2 * sm_count())
    cot /= 2;
  return cot;
}

// The paired stride-2 kernel's tile (COT channels, nt threads a block):
// COT 16 where Cout allows; where the (pair, channel tile) units fit in
// one block a SM, blocks of that many threads (rounded up to a warp), so
// that every SM carries the same load; else 256.
void s2_pair_plan(int cout, long long n_pairs, int* cot, int* nt) {
  *cot = cout % 16 == 0 ? 16 : 8;
  const long long units = n_pairs * ((cout + *cot - 1) / *cot);
  const long long per_sm = (units + sm_count() - 1) / sm_count();
  *nt = per_sm <= PAIR_MAX_THREADS ? (int)((per_sm + 31) / 32 * 32) : 256;
}

// The transposed kernel's blocks: where the (cell, channel tile) units
// fit one block a SM, blocks of that many threads (rounded up to a warp),
// so that every SM carries the same load; else UP_MAX_THREADS / 2.
int up_cell_plan(long long units) {
  const long long per_sm = (units + sm_count() - 1) / sm_count();
  return per_sm <= UP_MAX_THREADS ? (int)((per_sm + 31) / 32 * 32)
                                  : UP_MAX_THREADS / 2;
}

// The stride-1 kernel's plan: NT n-tiles a block (n_nt rounded up to 1, 2,
// 4 or 6, and 4 a block past 6, so that a thread's accumulators and
// fragments fit the 128 registers of two blocks a SM; 4 halved while the
// grid has fewer than four blocks a SM)
struct S1Plan {
  int nt, n_nt, gy, nbh, nbw;
  long long boxes;
};

S1Plan s1_plan(int Cout, int D, int H, int W) {
  S1Plan p;
  p.n_nt = (Cout + 7) / 8;
  p.nt = p.n_nt <= 2 ? p.n_nt : p.n_nt <= 4 ? 4 : p.n_nt <= 6 ? 6 : 4;
  p.nbh = (H + S1Tile::TH - 1) / S1Tile::TH;
  p.nbw = (W + TW - 1) / TW;
  p.boxes = (long long)(D + S1Tile::TD - 1) / S1Tile::TD * p.nbh * p.nbw;
  p.gy = (p.n_nt + p.nt - 1) / p.nt;
  if (p.nt == 4 && p.boxes * p.gy < 4 * sm_count()) {
    p.nt = 2;
    p.gy = (p.n_nt + 1) / 2;
  }
  return p;
}

// whether the rows of an NCDHW tensor of width w start on 16 bytes
int rows16(const float* t, int w) {
  return w % 4 == 0 && reinterpret_cast<uintptr_t>(t) % 16 == 0;
}

// A kernel's dynamic shared memory above 48 KB: allowed once a process
template <class Kernel>
int allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return 0;
  const int rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = rc == 0;
  return rc;
}

template <int NT, bool SB>
int launch_s1(const S1Plan& p, cudaStream_t st, const float* x,
              const float4* bp, float* y, int Cin, int Cout, int D, int H,
              int W) {
  const int vec = rows16(x, W);
  static bool ready = false;
  const int smem =
      S1Tile::SMEM + (SB ? S1Tile::b_smem(p.n_nt, Cin) : 0);
  // the most this form takes: two buffers with one n-tile, else one
  const int most =
      S1Tile::SMEM + (SB ? S1Tile::b_smem(NT, NT == 1 ? 2 * CC : CC) : 0);
  if (int rc = allow_smem(conv3d_s1_tc_kernel<NT, SB>, most, ready))
    return rc;
  const dim3 grid((unsigned)p.boxes, p.gy);
  conv3d_s1_tc_kernel<NT, SB><<<grid, THREADS, smem, st>>>(
      x, bp, y, Cin, Cout, D, H, W, p.nbh, p.nbw, p.n_nt, vec);
  return (int)cudaGetLastError();
}

int launch_fwd2(int cot, dim3 grid, cudaStream_t st, const float* x,
                const float* w, float* y, int Cin, int Cout, int Di, int Hi,
                int Wi, int Do, int Ho, int Wo) {
  switch (cot) {
    case 8:
      conv3d_fwd_kernel<2, 8><<<grid, THREADS, 0, st>>>(
          x, w, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo);
      break;
    case 16:
      conv3d_fwd_kernel<2, 16><<<grid, THREADS, 0, st>>>(
          x, w, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo);
      break;
    default:
      conv3d_fwd_kernel<2, 32><<<grid, THREADS, 0, st>>>(
          x, w, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

template <int COT>
int launch_s2_pair(int nt, long long n_pairs, cudaStream_t st,
                   const float* x, const float* w, float* y, int Cin,
                   int Cout, int Di, int Hi, int Wi, int Do, int Ho, int Wo) {
  const dim3 grid((unsigned)((n_pairs + nt - 1) / nt), (Cout + COT - 1) / COT);
  conv3d_s2_pair_kernel<COT><<<grid, nt, 0, st>>>(x, w, y, Cin, Cout, Di, Hi,
                                                  Wi, Do, Ho, Wo);
  return (int)cudaGetLastError();
}

// The weight gradient's plan: NT n-tiles a block (ceil(A / 8) rounded up
// to 1, 2 or 4 at stride 1, 1 or 2 at stride 2, the most a block past
// that: the registers and shared memory of two blocks a SM), the box
// grid, and the boxes cut into n_runs fixed runs of per_run, about four
// blocks a SM in all
struct WgPlan {
  int nt, gy, nbh, nbw, n_boxes, per_run, n_runs;
};

WgPlan wgrad_plan(int A, int B, int Dg, int Hg, int Wg, int stride) {
  WgPlan p;
  const int n_nt = (A + 7) / 8;
  p.nt = n_nt <= 1 ? 1 : n_nt <= 2 || stride == 2 ? 2 : 4;
  p.gy = (n_nt + p.nt - 1) / p.nt;
  const int td = stride == 1 && p.nt == 1 ? 2 : 1, th = stride == 1 ? 4 : 2;
  p.nbh = (Hg + th - 1) / th;
  p.nbw = (Wg + TW - 1) / TW;
  const long long boxes = (long long)(Dg + td - 1) / td * p.nbh * p.nbw;
  p.n_boxes = boxes < (1LL << 31) ? (int)boxes : 0;
  const long long tiles = (long long)(B + CC - 1) / CC * p.gy;
  long long want = (4LL * sm_count() + tiles - 1) / tiles;
  if (want > boxes) want = boxes;
  if (want < 1) want = 1;
  p.per_run = (int)((boxes + want - 1) / want);
  p.n_runs = p.per_run > 0 ? (p.n_boxes + p.per_run - 1) / p.per_run : 0;
  return p;
}

template <int S, int NT>
int launch_wgrad(const WgPlan& p, cudaStream_t st, const float* g,
                 const float* x, float* partial, int A, int B, int Dg,
                 int Hg, int Wg, int Dx, int Hx, int Wx) {
  static bool ready = false;
  constexpr int smem = WgTile<S, NT>::SMEM;
  if (int rc = allow_smem(conv3d_wgrad_tc_kernel<S, NT>, smem, ready))
    return rc;
  const dim3 grid((B + CC - 1) / CC, p.gy, p.n_runs);
  conv3d_wgrad_tc_kernel<S, NT><<<grid, THREADS, smem, st>>>(
      g, x, partial, A, B, Dg, Hg, Wg, Dx, Hx, Wx, p.nbh, p.nbw, p.n_boxes,
      p.per_run, rows16(x, Wx), rows16(g, Wg));
  return (int)cudaGetLastError();
}

template <int S>
int launch_wgrad(const WgPlan& p, cudaStream_t st, const float* g,
                 const float* x, float* partial, int A, int B, int Dg,
                 int Hg, int Wg, int Dx, int Hx, int Wx) {
  switch (p.nt) {
    case 1:
      return launch_wgrad<S, 1>(p, st, g, x, partial, A, B, Dg, Hg, Wg, Dx,
                                Hx, Wx);
    case 2:
      return launch_wgrad<S, 2>(p, st, g, x, partial, A, B, Dg, Hg, Wg, Dx,
                                Hx, Wx);
    default:
      return launch_wgrad<S, S == 1 ? 4 : 2>(p, st, g, x, partial, A, B, Dg,
                                             Hg, Wg, Dx, Hx, Wx);
  }
}

bool sizes_ok(long long a, long long b) {
  return a > 0 && b > 0 && a * b < (1LL << 31);
}

// Floats of the packed weights conv3d_fwd takes (ops/costreg_conv.py
// `packed_floats`): the stride-1 GEMM's B as hi/lo fragments, k_steps(Cin)
// x ceil(Cout / 8) x 32 x 4; 0 at stride 2
long long fwd_packed_floats(int Cin, int Cout, int stride) {
  return stride == 2 ? 0 : (long long)k_steps(Cin) * ((Cout + 7) / 8) * 128;
}

}  // namespace

// Whether a stride-2 conv3d_fwd from width Wi to Wo runs
// conv3d_s2_pair_kernel (1) or the generic conv3d_fwd_kernel<2> (0): the
// pair kernel reads 16-byte rows of two outputs' inputs
extern "C" int conv3d_s2_pairs(int Wi, int Wo) {
  return Wi % 4 == 0 && 2 * Wo == Wi;
}

// y (Cout, Do, Ho, Wo) = conv(x (Cin, Di, Hi, Wi), w (Cout, Cin, 3, 3, 3)),
// stride 1 (Do = Di, ...) or 2, pad 1; packed: fwd_packed_floats floats
// of scratch, which a stride-1 call fills with the split weights
extern "C" int conv3d_fwd(const void* x, const void* w, void* packed,
                          void* y, int Cin, int Cout, int Di, int Hi, int Wi,
                          int Do, int Ho, int Wo, int stride,
                          int packed_floats, void* stream) {
  const long long n_out = (long long)Do * Ho * Wo;
  if ((stride != 1 && stride != 2) || !sizes_ok(Cin, (long long)Di * Hi * Wi) ||
      !sizes_ok(Cout, n_out) ||
      fwd_packed_floats(Cin, Cout, stride) != packed_floats ||
      (stride == 1 && (Do != Di || Ho != Hi || Wo != Wi)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  auto xp = (const float*)x;
  auto wp = (const float*)w;
  auto yp = (float*)y;
  if (stride == 1) {
    const S1Plan p = s1_plan(Cout, Di, Hi, Wi);
    if (p.boxes >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    auto bp = (float4*)packed;
    conv3d_pack_kernel<<<(packed_floats / 4 + THREADS - 1) / THREADS, THREADS,
                         0, st>>>(wp, bp, Cin, Cout, p.n_nt);
    if (int rc = (int)cudaGetLastError()) return rc;
    // B in shared memory with one n-tile, or one chunk and one group
    const bool sb = p.n_nt == 1 || (Cin <= CC && p.gy == 1);
#define K10_S1(NT_)                                                         \
  (sb ? launch_s1<NT_, true>(p, st, xp, bp, yp, Cin, Cout, Di, Hi, Wi)      \
      : launch_s1<NT_, false>(p, st, xp, bp, yp, Cin, Cout, Di, Hi, Wi))
    switch (p.nt) {
      case 1: return K10_S1(1);
      case 2: return K10_S1(2);
      case 4: return K10_S1(4);
      default: return K10_S1(6);
    }
#undef K10_S1
  }
  if (conv3d_s2_pairs(Wi, Wo)) {
    const long long n_pairs = n_out / 2;
    int cot, nt;
    s2_pair_plan(Cout, n_pairs, &cot, &nt);
    return cot == 8 ? launch_s2_pair<8>(nt, n_pairs, st, xp, wp, yp, Cin,
                                        Cout, Di, Hi, Wi, Do, Ho, Wo)
                    : launch_s2_pair<16>(nt, n_pairs, st, xp, wp, yp, Cin,
                                         Cout, Di, Hi, Wi, Do, Ho, Wo);
  }
  const long long n_blocks = (n_out + THREADS - 1) / THREADS;
  const int cot = pick_cot(Cout, n_blocks);
  const dim3 grid((unsigned)n_blocks, (Cout + cot - 1) / cot);
  return launch_fwd2(cot, grid, st, xp, wp, yp, Cin, Cout, Di, Hi, Wi, Do,
                     Ho, Wo);
}

// y (Cout, Do, Ho, Wo) = transposed stride-2 conv of x (Cin, Di, Hi, Wi)
// with w (Cin, Cout, 3, 3, 3), pad 1; Do <= 2 Di (and H, W alike)
extern "C" int conv3d_up(const void* x, const void* w, void* y, int Cin,
                         int Cout, int Di, int Hi, int Wi, int Do, int Ho,
                         int Wo, void* stream) {
  const long long n_out = (long long)Do * Ho * Wo;
  if (!sizes_ok(Cin, (long long)Di * Hi * Wi) || !sizes_ok(Cout, n_out) ||
      Do > 2 * Di || Ho > 2 * Hi || Wo > 2 * Wi)
    return (int)cudaErrorInvalidValue;
  const long long cells =
      (long long)((Do + 1) / 2) * ((Ho + 1) / 2) * ((Wi + 1) / 2);
  const int tiles = (Cout + UP_COT - 1) / UP_COT;
  const int nt = up_cell_plan(cells * tiles);
  const long long blocks = (cells + nt - 1) / nt;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int vec2 = Wi % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;
  const int vec4 = Wo % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  conv3d_up_cell_kernel<<<dim3((unsigned)blocks, tiles), nt, 0,
                          (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)y, Cin, Cout, Di, Hi, Wi, Do,
      Ho, Wo, vec2, vec4);
  return (int)cudaGetLastError();
}

// The number of box runs (rows of the partial buffer) of a wgrad with A
// gradient channels, B input channels, a Dg x Hg x Wg gradient grid and
// the given stride; 0 for sizes it does not take.
extern "C" int conv3d_wgrad_splits(int A, int B, int Dg, int Hg, int Wg,
                                   int stride) {
  if (!sizes_ok(A, (long long)Dg * Hg * Wg) || B < 1 || Dg < 1 || Hg < 1 ||
      Wg < 1 || (stride != 1 && stride != 2) ||
      (long long)A * B * 27 >= (1LL << 31))
    return 0;
  const WgPlan p = wgrad_plan(A, B, Dg, Hg, Wg, stride);
  return (long long)p.n_runs * A * B * 27 < (1LL << 31) ? p.n_runs : 0;
}

// dw (A, B, 3, 3, 3) = sum_o g (A, Dg, Hg, Wg)[a, o] x (B, Dx, Hx, Wx)[b,
// stride o + k - 1]; partial: (conv3d_wgrad_splits(A, B, Dg, Hg, Wg,
// stride), A, B * 27)
extern "C" int conv3d_wgrad(const void* g, const void* x, void* partial,
                            void* dw, int A, int B, int Dg, int Hg, int Wg,
                            int Dx, int Hx, int Wx, int stride, int n_splits,
                            void* stream) {
  if ((stride != 1 && stride != 2) || !sizes_ok(A, (long long)Dg * Hg * Wg) ||
      !sizes_ok(B, (long long)Dx * Hx * Wx) || n_splits < 1 ||
      conv3d_wgrad_splits(A, B, Dg, Hg, Wg, stride) != n_splits)
    return (int)cudaErrorInvalidValue;
  const WgPlan p = wgrad_plan(A, B, Dg, Hg, Wg, stride);
  cudaStream_t st = (cudaStream_t)stream;
  auto gp = (const float*)g;
  auto xp = (const float*)x;
  auto pp = (float*)partial;
  const int rc = stride == 1
                     ? launch_wgrad<1>(p, st, gp, xp, pp, A, B, Dg, Hg, Wg,
                                       Dx, Hx, Wx)
                     : launch_wgrad<2>(p, st, gp, xp, pp, A, B, Dg, Hg, Wg,
                                       Dx, Hx, Wx);
  if (rc) return rc;
  const int n = A * B * 27;
  wgrad_reduce_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      pp, (float*)dw, n, p.n_runs);
  return (int)cudaGetLastError();
}
