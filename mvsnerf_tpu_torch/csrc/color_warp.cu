// K4: per-sample source-view colours + in-bounds masks, and the transpose
// of the colour warp (the source images' gradient).
//
// Forward: replaces the TPU kernel mvsnerf_tpu/ops/pallas_sweep.py:258
// `bilinear_warp_pallas` (forward `_fwd_kernel`) as used by
// render/renderer.py:26-113 `build_color_volume`: for every sample point
// and each of the V source views, project the world point with the view's
// w2c and intrinsics (`get_ndc_coordinate` without pad, inv_scale
// (W-1, H-1)), take grid = ndc * 2 - 1, the strict mask
// (-1 < gx < 1) & (-1 < gy < 1), and the RGB by bilinear interpolation with
// border padding (coordinates clamped to the corner pixel centres),
// align_corners=True. Output (M, 4V) in per-view blocks [R, G, B, mask].
//
// Backward: replaces pallas_sweep.py:147 `_bwd_kernel` (pallas_call :202,
// reached through `_warp_bwd_rule` :316): each sample's RGB cotangent,
// times each of its 4 bilinear weights, is added to the tap's source
// pixel; the mask's cotangent is dropped (a step function). The TPU kernel
// keeps the whole (h, 8, w) image gradient in VMEM across a sequential
// grid and scatters with banded one-hot matmuls; blocks here run in no
// order, so the sum across them is atomics into a gradient zeroed on the
// same stream.
//
// One thread per (sample, view) pair in both directions. A block of 256
// threads holds 256 / V consecutive samples with their V views in order,
// so thread i of the block owns the i-th [R, G, B, mask] slot of one
// contiguous range of the output (and of the cotangent): each thread
// stores (loads) one aligned float4 and a warp's access is 512 contiguous
// bytes. The projection, clamp and taps are one helper that both kernels
// call, so the backward scatters to exactly the forward's taps with
// exactly its weights. It uses round-to-nearest intrinsics with no FMA
// contraction, in the plain twin's operation order, so the sampling
// coordinates are bit-identical to the twin's (a one-ulp coordinate
// difference moves a colour by up to 1e-4 at 640 px).
//
// What bounds it on the H100. The forward: its (M, 4V) f32 output write
// (16 B per sample and view, 100 MB for a 16384 x 128 chunk of 3 views)
// and the projection's IEEE divides; the three 640x512 RGB images (11.8
// MB) stay in the 50 MB L2 and are gathered with read-only scalar loads
// (an RGBA copy made per call, one 16-byte load a tap, measured slower with
// its packing pass). The backward: its atomics into the L2-resident image
// gradient. Consecutive samples of a ray land on the same or neighbouring
// pixels of an epipolar segment, and samples outside a view clamp onto its
// border pixels, so a warp's lanes often share a tap base: lanes with an
// equal (view, x0, y0) first sum their 12 products (4 taps x 3 channels)
// with shuffles, and one lane of each group issues the atomics, one
// float4 atomicAdd (sm_90) a tap into an RGBA-padded gradient, a third of
// the scalar atomics' count.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // a multiple of 32, so every warp is full
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

// The projection of one point into one view and its 4 bilinear taps:
// tap t is pixel (x0 + (t & 1), y0 + (t >> 1)) with weight wt[t]; a tap
// past the clamped far edge (xi >= W or yi >= H) has weight 0 and is
// skipped by both kernels.
struct Taps {
  int x0, y0;
  float wt[4];
  bool inside;
};

__device__ __forceinline__ Taps project_taps(float p0, float p1, float p2,
                                             const float* __restrict__ E,
                                             const float* __restrict__ K,
                                             float wm1, float hm1) {
  const float c0 = __fadd_rn(dot3_rn(p0, p1, p2, E[0], E[1], E[2]), E[3]);
  const float c1 = __fadd_rn(dot3_rn(p0, p1, p2, E[4], E[5], E[6]), E[7]);
  const float c2 = __fadd_rn(dot3_rn(p0, p1, p2, E[8], E[9], E[10]), E[11]);
  const float q0 = dot3_rn(c0, c1, c2, K[0], K[1], K[2]);
  const float q1 = dot3_rn(c0, c1, c2, K[3], K[4], K[5]);
  const float q2 = dot3_rn(c0, c1, c2, K[6], K[7], K[8]);
  const float gx =
      __fsub_rn(__fmul_rn(__fdiv_rn(__fdiv_rn(q0, q2), wm1), 2.f), 1.f);
  const float gy =
      __fsub_rn(__fmul_rn(__fdiv_rn(__fdiv_rn(q1, q2), hm1), 2.f), 1.f);
  Taps t;
  t.inside = gx > -1.f && gx < 1.f && gy > -1.f && gy < 1.f;

  // grid_sample border padding: unnormalise, clamp to [0, size - 1]
  float ix = __fmul_rn(__fdiv_rn(__fadd_rn(gx, 1.f), 2.f), wm1);
  float iy = __fmul_rn(__fdiv_rn(__fadd_rn(gy, 1.f), 2.f), hm1);
  ix = fminf(wm1, fmaxf(ix, 0.f));
  iy = fminf(hm1, fmaxf(iy, 0.f));
  const float fx = floorf(ix), fy = floorf(iy);
  t.x0 = (int)fx;
  t.y0 = (int)fy;
  const float wx0 = (fx + 1.f) - ix, wx1 = ix - fx;
  const float wy0 = (fy + 1.f) - iy, wy1 = iy - fy;
  t.wt[0] = wx0 * wy0;
  t.wt[1] = wx1 * wy0;
  t.wt[2] = wx0 * wy1;
  t.wt[3] = wx1 * wy1;
  return t;
}

// The launch geometry: a block of kThreads threads holds `per_block` =
// kThreads / V consecutive samples, each with its V views in order, so
// thread j of block b owns output slot b * per_block * V + j (the last
// kThreads % V threads of a block, and those past sample M, own none).
// `v_magic` = ceil(2^24 / V) turns j / V into a multiply and a shift,
// exact for j < 256 and V <= 256 (the error j * ceil-slack / 2^24 < 2^-16
// stays below the 1 / V gap to the next integer).
struct Grid {
  long long M;
  int V, H, W, per_block;
  unsigned v_magic;
};

struct Pair {
  long long m;   // sample
  long long i;   // output slot m * V + v
  int v;         // view
  bool valid;
};

__device__ __forceinline__ Pair pair_of(const Grid& gr) {
  const int j = threadIdx.x;
  const int s = (int)((j * gr.v_magic) >> 24);
  Pair p;
  p.v = j - s * gr.V;
  p.m = (long long)blockIdx.x * gr.per_block + s;
  p.i = (long long)blockIdx.x * (gr.per_block * gr.V) + j;
  p.valid = s < gr.per_block && p.m < gr.M;
  return p;
}

// The V views' cameras into the block's shared memory, 25 floats a view:
// w2c (16) then intrinsics (9). The odd stride puts the V views a warp
// reads at once in different banks.
__device__ __forceinline__ const float* load_cameras(
    float* cam, const float* __restrict__ w2cs,
    const float* __restrict__ intr, int V) {
  for (int j = threadIdx.x; j < 25 * V; j += kThreads) {
    const int v = j / 25, r = j - 25 * v;
    cam[j] = r < 16 ? w2cs[16 * v + r] : intr[9 * v + r - 16];
  }
  __syncthreads();
  return cam;
}

__device__ __forceinline__ Taps taps_of(const Pair& p, const float* cam,
                                        const float* __restrict__ pts,
                                        const Grid& gr) {
  const float* pt = pts + 3 * p.m;
  const float* E = cam + 25 * p.v;
  return project_taps(__ldg(pt), __ldg(pt + 1), __ldg(pt + 2), E, E + 16,
                      (float)(gr.W - 1), (float)(gr.H - 1));
}

// Sums `val` and ORs `nz` over `peers` (the lanes of the warp whose key
// equals this lane's) in a tree of shuffles; every lane of the warp must
// call it. The lowest lane of each group ends with the group's totals and
// returns true.
__device__ __forceinline__ bool reduce_peers(unsigned peers, float (&val)[12],
                                             unsigned& nz) {
  const int lane = threadIdx.x & 31;
  const bool leader = __ffs(peers) - 1 == lane;
  int rel = __popc(peers & ((1u << lane) - 1u));  // rank among the peers
  unsigned above = peers & (0xfffffffeu << lane);
  while (__any_sync(kFullWarp, above)) {
    const int next = __ffs(above);  // the next peer still summing, or 0
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const float o = __shfl_sync(kFullWarp, val[k], src);
      if (next) val[k] += o;
    }
    const unsigned o = __shfl_sync(kFullWarp, nz, src);
    if (next) nz |= o;
    // peers of odd rank at this level have been taken in by the one below
    above &= ~__ballot_sync(kFullWarp, rel & 1);
    rel >>= 1;
  }
  return leader;
}

__global__ void __launch_bounds__(kThreads)
    color_warp_kernel(const float* __restrict__ pts,
                      const float* __restrict__ w2cs,
                      const float* __restrict__ intr,
                      const float* __restrict__ imgs,
                      float4* __restrict__ out, Grid gr) {
  extern __shared__ float shared[];
  const float* cam = load_cameras(shared, w2cs, intr, gr.V);
  const Pair p = pair_of(gr);
  if (!p.valid) return;
  const Taps tp = taps_of(p, cam, pts, gr);
  const int W = gr.W;
  const float* px = imgs + (((long long)p.v * gr.H + tp.y0) * W + tp.x0) * 3;
  float rgb[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dx = t & 1, dy = t >> 1;
    // zero weight at the clamped edge
    if (tp.x0 + dx >= W || tp.y0 + dy >= gr.H) continue;
    const float* q = px + 3 * (dy * W + dx);
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[c] = fmaf(__ldg(q + c), tp.wt[t], rgb[c]);
  }
  out[p.i] = make_float4(rgb[0], rgb[1], rgb[2], tp.inside ? 1.f : 0.f);
}

// gimgs: (V, H, W, 4) RGBA-padded, so a tap's 3 channels are one float4
// reduction (sm_90's vector atomicAdd); the wrapper returns the RGB.
__global__ void __launch_bounds__(kThreads)
    color_warp_bwd_kernel(const float4* __restrict__ g,
                          const float* __restrict__ pts,
                          const float* __restrict__ w2cs,
                          const float* __restrict__ intr,
                          float4* __restrict__ gimgs, Grid gr) {
  extern __shared__ float shared[];
  const float* cam = load_cameras(shared, w2cs, intr, gr.V);
  const Pair p = pair_of(gr);
  // Every lane takes part in the merge; one without a pair brings a key
  // no pixel has and nothing to add.
  unsigned long long key = ~0ull;  // the tap base pixel (v, y0, x0)
  float val[12];  // tap t, channel c at 3 t + c
  unsigned nz = 0;  // bit t: tap t has a nonzero weight
  int x0 = 0, y0 = 0;
#pragma unroll
  for (int k = 0; k < 12; ++k) val[k] = 0.f;
  if (p.valid) {
    const float4 gv = __ldg(g + p.i);
    const Taps tp = taps_of(p, cam, pts, gr);
    x0 = tp.x0;
    y0 = tp.y0;
    key = ((unsigned long long)p.v * gr.H + y0) * gr.W + x0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      val[3 * t] = tp.wt[t] * gv.x;
      val[3 * t + 1] = tp.wt[t] * gv.y;
      val[3 * t + 2] = tp.wt[t] * gv.z;
      // a zero weight (a coordinate on a pixel centre) adds nothing
      nz |= (tp.wt[t] != 0.f ? 1u : 0u) << t;
    }
  }
  const bool leader = reduce_peers(__match_any_sync(kFullWarp, key), val, nz);
  if (!p.valid || !leader) return;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int dx = t & 1, dy = t >> 1;
    // the forward's taps: none past the clamped edge
    if (x0 + dx >= gr.W || y0 + dy >= gr.H || !(nz >> t & 1u)) continue;
    atomicAdd(gimgs + key + dy * gr.W + dx,
              make_float4(val[3 * t], val[3 * t + 1], val[3 * t + 2], 0.f));
  }
}

// Checks the sizes and fills the launch geometry; false if the kernels
// cannot take them.
bool grid_of(int M, int V, int H, int W, Grid* gr, unsigned* blocks) {
  if (M < 0 || V < 1 || V > kThreads || H < 2 || W < 2) return false;
  gr->M = M;
  gr->V = V;
  gr->H = H;
  gr->W = W;
  gr->per_block = kThreads / V;
  gr->v_magic = ((1u << 24) + V - 1) / V;
  *blocks = (unsigned)(((long long)M + gr->per_block - 1) / gr->per_block);
  return true;
}

}  // namespace

// pts (M, 3), w2cs (V, 4, 4), intr (V, 3, 3), imgs (V, H, W, 3); out
// (M, 4V), 16-byte aligned. 1 <= V <= 256.
extern "C" int color_warp(const void* pts, const void* w2cs,
                          const void* intr, const void* imgs, void* out,
                          int M, int V, int H, int W, void* stream) {
  Grid gr;
  unsigned blocks;
  if (!grid_of(M, V, H, W, &gr, &blocks)) return (int)cudaErrorInvalidValue;
  if (M == 0) return (int)cudaSuccess;
  color_warp_kernel<<<blocks, kThreads, 25 * V * sizeof(float),
                      (cudaStream_t)stream>>>(
      (const float*)pts, (const float*)w2cs, (const float*)intr,
      (const float*)imgs, (float4*)out, gr);
  return (int)cudaGetLastError();
}

// g: (M, 4V) cotangent of color_warp's output, 16-byte aligned; gimgs:
// (V, H, W, 4), 16-byte aligned, zeroed here on `stream` before the
// scatter; its 4th channel stays 0.
extern "C" int color_warp_bwd(const void* g, const void* pts,
                              const void* w2cs, const void* intr,
                              void* gimgs, int M, int V, int H, int W,
                              void* stream) {
  Grid gr;
  unsigned blocks;
  if (!grid_of(M, V, H, W, &gr, &blocks)) return (int)cudaErrorInvalidValue;
  const cudaError_t rc =
      cudaMemsetAsync(gimgs, 0, (size_t)V * H * W * sizeof(float4),
                      (cudaStream_t)stream);
  if (rc != cudaSuccess || M == 0) return (int)rc;
  color_warp_bwd_kernel<<<blocks, kThreads, 25 * V * sizeof(float),
                          (cudaStream_t)stream>>>(
      (const float4*)g, (const float*)pts, (const float*)w2cs,
      (const float*)intr, (float4*)gimgs, gr);
  return (int)cudaGetLastError();
}
