// K10: the CostRegNet U-Net's 3x3x3 convolutions, forward and both
// gradients, for the `--costreg_impl dband` route.
//
// Replaces the TPU kernels of mvsnerf_tpu/ops/pallas_costreg.py:
//   conv3d_s1_dband (:210, pallas_call :238)   -> conv3d_fwd_kernel<1>
//   conv3d_s2_dband (:337, pallas_call :365)   -> conv3d_fwd_kernel<2>
//   conv3d_up_dband (:480, pallas_call :513)   -> conv3d_up_kernel
//   _s1_wgrad_dband (:597, pallas_call :612)   -> conv3d_wgrad_kernel<1>
//   _s2_wgrad_dband (:707, pallas_call :722)   -> conv3d_wgrad_kernel<2>
//                                                 + wgrad_reduce_kernel
// The TPU kernels turn each depth band into a banded (Cin*win, Cout*P)
// matrix for the MXU, pad W to 128 lanes, split stride-2 inputs into even
// and odd columns and stream row windows through VMEM. None of that layout
// carries over: here every kernel reads the NCDHW activations (batch 1) in
// place and does the arithmetic of the dense convolution, f32 multiply-adds
// with f32 accumulation (no TF32).
//
// Weights keep PyTorch's layouts: Conv3d (Cout, Cin, 3, 3, 3) and
// ConvTranspose3d (Cin, Cout, 3, 3, 3). All three gradients of the U-Net
// reduce to these kernels (ops/costreg_conv.py):
//   s1 dgrad = conv3d_fwd<1> on the flipped, in/out-swapped kernel;
//   s2 dgrad = conv3d_up on the s2 kernel as stored;
//   up dgrad = conv3d_fwd<2> on the up kernel as stored;
//   wgrad    = conv3d_wgrad<s>: dW[a, b, k] = sum_o g[a, o] x[b, s o + k - 1]
//              (the up kernel's by duality, with g = its input and x = its
//              output's cotangent).
//
// conv3d_fwd: one thread per output voxel with a tile of COT output
// channels in registers; the block's weights for a chunk of input channels
// sit in shared memory as [channel, tap][COT] rows, read as broadcast
// float4s. conv3d_up: gather form, one thread per pair of W outputs (2m,
// 2m+1), which share their input taps; only taps of matching parity are
// visited, so no atomics. conv3d_wgrad: an implicit GEMM, M = A output
// rows, N = B x 27 (channel, tap) columns, K = the gradient's voxels in
// stages of KC along a W row, split into fixed runs of stages; a block
// stages g's KC voxels and, per (b, kd, kh) row key, the one x row segment
// its three kw taps read at shifts of 0, 1, 2, so each staged value feeds
// 3 taps x 4 channels of a thread's accumulators; each run writes its
// partial sums to a scratch buffer and a last kernel adds the runs in
// order. No atomics: deterministic.
//
// What bounds it on the H100: f32 FMA issue (55.7 G multiply-adds for the
// U-Net's forward at DTU size, as many for each gradient); the bytes (the
// 768 MB cost volume read once is 0.23 ms) are far below. The forward's
// and the up kernel's inner loops issue one L1 load and a shared-memory
// broadcast per COT multiply-adds; wgrad's inner loop one shared float4
// and one or two shared floats per 12. PERF.md has the measured times per
// layer.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WCHUNK = 256;  // COT x input channels per weight chunk
constexpr int KC = 32;       // voxels (along W) per wgrad stage
constexpr int SMS_FALLBACK = 132;

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
                                              int co0, bool io_major) {
  constexpr int CIC = WCHUNK / COT;
  for (int i = threadIdx.x; i < CIC * 27 * COT; i += THREADS) {
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

// Transposed stride-2 convolution, pad 1 (torch ConvTranspose3d with
// output_padding 1 when Do = 2 Di): y[co, o] = sum over ci, k with
// o = 2 i - 1 + k of w[ci, co, k] x[ci, i]. One thread per output pair
// (.., 2m) and (.., 2m + 1): the even output takes kw = 1 at i = m, the
// odd one kw = 0 at i = m + 1 and kw = 2 at i = m.
template <int COT>
__global__ void __launch_bounds__(THREADS)
conv3d_up_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ y, int Cin, int Cout, int Di, int Hi,
                 int Wi, int Do, int Ho, int Wo) {
  constexpr int CIC = WCHUNK / COT;
  __shared__ __align__(16) float sw[CIC * 27 * COT];
  const int Wp = (Wo + 1) / 2;
  const int n_pairs = Do * Ho * Wp;
  const int v = blockIdx.x * THREADS + threadIdx.x;
  const int co0 = blockIdx.y * COT;
  const bool live = v < n_pairs;
  int od = 0, oh = 0, m = 0;
  if (live) {
    m = v % Wp;
    const int t = v / Wp;
    oh = t % Ho;
    od = t / Ho;
  }
  const bool has0 = m < Wi, has1 = m + 1 < Wi;
  const long long plane = (long long)Di * Hi * Wi;
  float ae[COT], ao[COT];
#pragma unroll
  for (int j = 0; j < COT; ++j) ae[j] = ao[j] = 0.f;
  for (int c0 = 0; c0 < Cin; c0 += CIC) {
    __syncthreads();
    stage_weights<COT>(sw, w, Cin, Cout, c0, co0, true);
    __syncthreads();
    if (!live) continue;
    const int nc = min(CIC, Cin - c0);
    for (int cl = 0; cl < nc; ++cl) {
      const float* xc = x + (c0 + cl) * plane;
      const float* swc = sw + cl * 27 * COT;
#pragma unroll
      for (int kd = 0; kd < 3; ++kd) {
        if ((od + 1 - kd) & 1) continue;
        const int id = (od + 1 - kd) >> 1;
        if (id < 0 || id >= Di) continue;
#pragma unroll
        for (int kh = 0; kh < 3; ++kh) {
          if ((oh + 1 - kh) & 1) continue;
          const int ih = (oh + 1 - kh) >> 1;
          if (ih < 0 || ih >= Hi) continue;
          const float* row = xc + ((long long)id * Hi + ih) * Wi;
          const float* wr = swc + (kd * 3 + kh) * 3 * COT;
          if (has0) {
            const float x0 = __ldg(row + m);
            fma_row<COT>(ae, wr + COT, x0);
            fma_row<COT>(ao, wr + 2 * COT, x0);
          }
          if (has1) fma_row<COT>(ao, wr, __ldg(row + m + 1));
        }
      }
    }
  }
  if (!live) return;
  const long long n_out = (long long)Do * Ho * Wo;
  const long long o = ((long long)od * Ho + oh) * Wo + 2 * m;
  const bool odd_ok = 2 * m + 1 < Wo;
#pragma unroll
  for (int j = 0; j < COT; ++j) {
    if (co0 + j >= Cout) break;
    y[(co0 + j) * n_out + o] = ae[j];
    if (odd_ok) y[(co0 + j) * n_out + o + 1] = ao[j];
  }
}

// wgrad partials: P[split][a][n] = sum over the split's voxels o of
// g[a, o] x[b, S o + k - 1], n = b * 27 + k. The voxels go in stages of
// KC along one W row of g; the three kw taps of a (b, kd, kh) row key read
// one staged x row segment of S (KC - 1) + 3 values at shifts 0, 1, 2.
// Tile: MT gradient channels x RK row keys (3 RK columns); each thread
// owns 4 channels x 1 row key x 3 taps.
template <int S, int MT>
__global__ void __launch_bounds__(THREADS)
conv3d_wgrad_kernel(const float* __restrict__ g, const float* __restrict__ x,
                    float* __restrict__ partial, int A, int B, int Dg, int Hg,
                    int Wg, int Dx, int Hx, int Wx, int stages_per_split) {
  constexpr int RK = THREADS * 4 / MT;          // row keys per tile
  constexpr int SPAN = (S * (KC - 1) + 3) | 1;  // odd: no bank conflicts
  __shared__ __align__(16) float sg[KC][MT + 4];
  __shared__ float sx[RK][SPAN];
  const int n_keys = B * 9, N = B * 27;
  const int k0 = blockIdx.x * RK, a0 = blockIdx.y * MT;
  const int segs = (Wg + KC - 1) / KC;
  const int n_stages = Dg * Hg * segs;
  const int t_begin = blockIdx.z * stages_per_split;
  const int t_end = min(n_stages, t_begin + stages_per_split);
  const int plane_x = Dx * Hx * Wx, plane_g = Dg * Hg * Wg;
  const int tid = threadIdx.x, tx = tid % RK, ty = tid / RK;
  float acc[4][3];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[i][j] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int row = t / segs, ow0 = (t % segs) * KC;
    const int oh = row % Hg, od = row / Hg;
    __syncthreads();
    for (int i = tid; i < KC * MT; i += THREADS) {
      const int kk = i % KC, a = i / KC;
      const int ow = ow0 + kk;
      sg[kk][a] = (ow < Wg && a0 + a < A)
                      ? __ldg(g + (long long)(a0 + a) * plane_g +
                              row * Wg + ow)
                      : 0.f;
    }
    for (int i = tid; i < RK * SPAN; i += THREADS) {
      const int j = i % SPAN, r = i / SPAN, key = k0 + r;
      const int kd = key % 9 / 3, kh = key % 3;
      const int id = S * od + kd - 1, ih = S * oh + kh - 1,
                iw = S * ow0 + j - 1;
      float v = 0.f;
      if (key < n_keys && id >= 0 && id < Dx && ih >= 0 && ih < Hx &&
          iw >= 0 && iw < Wx)
        v = __ldg(x + (key / 9) * plane_x + (id * Hx + ih) * Wx + iw);
      sx[r][j] = v;
    }
    __syncthreads();
    const float* xr = sx[tx];
    float x0 = xr[0], x1 = xr[1], x2 = xr[2];
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&sg[kk][ty * 4]);
      const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(a4[i], x0, acc[i][0]);
        acc[i][1] = fmaf(a4[i], x1, acc[i][1]);
        acc[i][2] = fmaf(a4[i], x2, acc[i][2]);
      }
      if (kk + 1 < KC) {  // the taps of voxel kk + 1: shifted by S
        if (S == 1) {
          x0 = x1;
          x1 = x2;
          x2 = xr[kk + 3];
        } else {
          x0 = x2;
          x1 = xr[2 * kk + 3];
          x2 = xr[2 * kk + 4];
        }
      }
    }
  }
  const int key = k0 + tx;
  if (key >= n_keys) return;
  float* P = partial + (long long)blockIdx.z * A * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = a0 + ty * 4 + i;
    if (a >= A) break;
#pragma unroll
    for (int j = 0; j < 3; ++j) P[(long long)a * N + key * 3 + j] = acc[i][j];
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

template <int S>
int launch_fwd(int cot, dim3 grid, cudaStream_t st, const float* x,
               const float* w, float* y, int Cin, int Cout, int Di, int Hi,
               int Wi, int Do, int Ho, int Wo) {
  switch (cot) {
    case 8:
      conv3d_fwd_kernel<S, 8><<<grid, THREADS, 0, st>>>(
          x, w, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo);
      break;
    case 16:
      conv3d_fwd_kernel<S, 16><<<grid, THREADS, 0, st>>>(
          x, w, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo);
      break;
    default:
      conv3d_fwd_kernel<S, 32><<<grid, THREADS, 0, st>>>(
          x, w, y, Cin, Cout, Di, Hi, Wi, Do, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

int wgrad_mt(int A) { return A <= 8 ? 8 : A <= 16 ? 16 : A <= 32 ? 32 : 64; }

// (n_splits, stages per split) of a wgrad with gradient grid Dg x Hg x
// Wg: about four blocks per SM in all
void wgrad_plan(int A, int B, int Dg, int Hg, int Wg, int* n_splits,
                int* per_split) {
  const int mt = wgrad_mt(A), rk = THREADS * 4 / mt;
  const long long tiles =
      (long long)((A + mt - 1) / mt) * ((B * 9 + rk - 1) / rk);
  const long long stages = (long long)Dg * Hg * ((Wg + KC - 1) / KC);
  long long want = (4LL * sm_count() + tiles - 1) / tiles;
  if (want > stages) want = stages;
  if (want < 1) want = 1;
  const long long c = (stages + want - 1) / want;
  *per_split = (int)c;
  *n_splits = (int)((stages + c - 1) / c);
}

bool sizes_ok(long long a, long long b) {
  return a > 0 && b > 0 && a * b < (1LL << 31);
}

}  // namespace

// y (Cout, Do, Ho, Wo) = conv(x (Cin, Di, Hi, Wi), w (Cout, Cin, 3, 3, 3)),
// stride 1 or 2, pad 1
extern "C" int conv3d_fwd(const void* x, const void* w, void* y, int Cin,
                          int Cout, int Di, int Hi, int Wi, int Do, int Ho,
                          int Wo, int stride, void* stream) {
  const long long n_out = (long long)Do * Ho * Wo;
  if ((stride != 1 && stride != 2) || !sizes_ok(Cin, (long long)Di * Hi * Wi) ||
      !sizes_ok(Cout, n_out))
    return (int)cudaErrorInvalidValue;
  const long long n_blocks = (n_out + THREADS - 1) / THREADS;
  const int cot = pick_cot(Cout, n_blocks);
  const dim3 grid((unsigned)n_blocks, (Cout + cot - 1) / cot);
  cudaStream_t st = (cudaStream_t)stream;
  auto xp = (const float*)x;
  auto wp = (const float*)w;
  auto yp = (float*)y;
  return stride == 1
             ? launch_fwd<1>(cot, grid, st, xp, wp, yp, Cin, Cout, Di, Hi, Wi,
                             Do, Ho, Wo)
             : launch_fwd<2>(cot, grid, st, xp, wp, yp, Cin, Cout, Di, Hi, Wi,
                             Do, Ho, Wo);
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
  const long long n_blocks =
      ((long long)Do * Ho * ((Wo + 1) / 2) + THREADS - 1) / THREADS;
  const int cot = pick_cot(Cout, n_blocks);
  const dim3 grid((unsigned)n_blocks, (Cout + cot - 1) / cot);
  cudaStream_t st = (cudaStream_t)stream;
  auto xp = (const float*)x;
  auto wp = (const float*)w;
  auto yp = (float*)y;
  switch (cot) {
    case 8:
      conv3d_up_kernel<8><<<grid, THREADS, 0, st>>>(xp, wp, yp, Cin, Cout, Di,
                                                    Hi, Wi, Do, Ho, Wo);
      break;
    case 16:
      conv3d_up_kernel<16><<<grid, THREADS, 0, st>>>(xp, wp, yp, Cin, Cout, Di,
                                                     Hi, Wi, Do, Ho, Wo);
      break;
    default:
      conv3d_up_kernel<32><<<grid, THREADS, 0, st>>>(xp, wp, yp, Cin, Cout, Di,
                                                     Hi, Wi, Do, Ho, Wo);
  }
  return (int)cudaGetLastError();
}

// The number of voxel chunks (rows of the partial buffer) of a wgrad with
// A gradient channels, B input channels and a Dg x Hg x Wg gradient grid.
extern "C" int conv3d_wgrad_splits(int A, int B, int Dg, int Hg, int Wg) {
  if (!sizes_ok(A, (long long)Dg * Hg * Wg) || B < 1 || Hg < 1 || Wg < 1)
    return 0;
  int n_splits, per_split;
  wgrad_plan(A, B, Dg, Hg, Wg, &n_splits, &per_split);
  return n_splits;
}

// dw (A, B, 3, 3, 3) = sum_o g (A, Dg, Hg, Wg)[a, o] x (B, Dx, Hx, Wx)[b,
// stride o + k - 1]; partial: (conv3d_wgrad_splits(A, B, Dg, Hg, Wg), A,
// B * 27)
extern "C" int conv3d_wgrad(const void* g, const void* x, void* partial,
                            void* dw, int A, int B, int Dg, int Hg, int Wg,
                            int Dx, int Hx, int Wx, int stride, int n_splits,
                            void* stream) {
  if ((stride != 1 && stride != 2) || !sizes_ok(A, (long long)Dg * Hg * Wg) ||
      !sizes_ok(B, (long long)Dx * Hx * Wx) ||
      conv3d_wgrad_splits(A, B, Dg, Hg, Wg) != n_splits)
    return (int)cudaErrorInvalidValue;
  int splits, per_split;
  wgrad_plan(A, B, Dg, Hg, Wg, &splits, &per_split);
  const int mt = wgrad_mt(A), rk = THREADS * 4 / mt, N = B * 27;
  const dim3 grid((B * 9 + rk - 1) / rk, (A + mt - 1) / mt, splits);
  cudaStream_t st = (cudaStream_t)stream;
  auto gp = (const float*)g;
  auto xp = (const float*)x;
  auto pp = (float*)partial;
#define K10_WGRAD(S_, MT_)                                                   \
  conv3d_wgrad_kernel<S_, MT_><<<grid, THREADS, 0, st>>>(                   \
      gp, xp, pp, A, B, Dg, Hg, Wg, Dx, Hx, Wx, per_split)
  if (stride == 1) {
    switch (mt) {
      case 8: K10_WGRAD(1, 8); break;
      case 16: K10_WGRAD(1, 16); break;
      case 32: K10_WGRAD(1, 32); break;
      default: K10_WGRAD(1, 64);
    }
  } else {
    switch (mt) {
      case 8: K10_WGRAD(2, 8); break;
      case 16: K10_WGRAD(2, 16); break;
      case 32: K10_WGRAD(2, 32); break;
      default: K10_WGRAD(2, 64);
    }
  }
#undef K10_WGRAD
  if (int rc = (int)cudaGetLastError()) return rc;
  const int n = A * N;
  wgrad_reduce_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, st>>>(
      pp, (float*)dw, n, splits);
  return (int)cudaGetLastError();
}
