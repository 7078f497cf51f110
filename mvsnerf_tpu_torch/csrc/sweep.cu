// K1: fused plane sweep + cross-view variance cost volume, and K2, its
// backward.
//
// K1 replaces the TPU kernels mvsnerf_tpu/ops/pallas_sweep2.py:316
// `cost_volume_xband_pallas` (forward `_xb_fwd_kernel`) and its fallback
// mvsnerf_tpu/ops/pallas_sweep.py:504 `cost_volume_fused_pallas`, plus the
// packed16 relayout pallas_sweep2.py:418 `pack16_from_tiles` (K3), whose
// job this kernel's store does: it writes the (1, 3V+C, D, hp, wp) cost
// volume contiguous (NCDHW), the layout cuDNN runs the f32 3-D U-Net in,
// so CostRegNet's first convolution reads it without a relayout pass.
//
// K1's layout (sweep_kernel). A first launch (sweep_pack_kernel) lays
// the (V, h, w, 35) sources out quad-planar, (V, 9, h, w, 4): quad q of a
// pixel holds its channels 4 q .. 4 q + 3, the ninth [r, g, b, 0]. So a
// bilinear tap reads 4 channels with one 16-byte load, and a warp's
// lanes, at neighbouring reference columns, read neighbouring 16-byte
// pieces of one source row. A block owns SW_TX reference columns
// of SW_TY rows (a warp a row) over a run of SW_RUN planes, for one
// channel group (blockIdx.y): 16 feature channels, 4 quads (2 groups:
// the variance of a channel depends on that channel alone), or the 3 rgb
// channels (the third group, which writes the reference and warped rgb
// and needs no mean). A thread walks its column down the run: from one
// plane to the next a tap moves by a fraction of a pixel at DTU geometry,
// so its source pixels are still in L1, and the sources are read from L2
// about once per run. Each group recomputes the coordinates (~70
// instructions a (voxel, view), beside 16 16-byte loads); at 16 channels
// a thread fits 80 registers, 6 blocks an SM (8 channels, 5 groups: the
// coordinates' issue costs more than the occupancy gains; 32: too few
// warps to cover the loads). The output goes out with streaming stores
// (st.global.cs), so the 768 MB written through L2 does not evict the
// sources every block gathers from.
// A direct gather needs no x/y window contract, so the TPU's `xband_fits`
// / `sweep_fits_band_pix` checks and their lax.cond fallbacks have no
// counterpart.
//
// The coordinate and variance arithmetic uses round-to-nearest intrinsics
// with no FMA contraction, in the plain twin's operation order
// (ops/sweep.py), so kernel and twin sample at the same coordinates: with
// ~1e2-px coordinates and steep feature maps, one ulp of a coordinate
// moves the variance by ~1e-4. Each channel's sums over the views run in
// view order, var = E[x^2] - E[x]^2 in f32.
//
// What bounds K1 on the H100: the output write, 4 B x (3V+C) per voxel
// (4 B x 41 x 128 x 176 x 208 by the shapes, 768 MB). Each of a warp's
// stores of a channel covers 128 contiguous bytes. Measured times, and the
// variants tried: PERF.md.
//
// K2 replaces the TPU backward kernels pallas_sweep2.py:210 `_xb_bwd_kernel`
// (via `_xb_bwd_rule` :342) and pallas_sweep.py:432 `_fused_bwd_kernel`
// (via `_fused_bwd_rule` :581), and the cotangent direction of the packed16
// relayout, pallas_sweep2.py:487 `unpack16_to_tiles` (K3'): it reads the
// cotangent where the U-Net's backward leaves it (NCDHW, as K1 wrote the
// volume), through its strides.
// For each voxel it recomputes the per-view warps and the in-bounds count
// with K1's own coordinate arithmetic (`sweep_tap` below), then
//   d warped_v[c] = g_var[c] * 2 / count * (warped_v[c] - mean[c])
//   d rgb_v[k]    = g[3v + k]
// scattered through the 4 bilinear taps (off-image taps get nothing), and
// for the reference view 2 / count * g_var * (ref - mean) plus g[0:3],
// summed over the planes. The coordinates get no gradient. Nothing of the
// forward is saved: the warps are recomputed, as the TPU kernel does.
//
// K2's layout (sweep_bwd_kernel). A block owns 32 consecutive reference
// columns of 8 rows, every other row (a warp a row; the band's other rows
// are another block's), over a run of BWD_RUN planes, for one channel
// group: 8 feature channels (4 groups), or the 3 rgb channels (the fifth
// group, which needs no mean). So a warp's cotangent load is one channel
// of 32 consecutive x, 128 contiguous bytes on NCDHW. Each (voxel, view)
// computes its taps once and keeps them, and its weights, in registers
// from the mean to the scatter.
// For each source view the block holds a window of the source image in
// shared memory: the group's forward values, staged once, and its
// gradient, zeroed, each a pixel's 8 channels as two float4s (`wpos`). The
// window is the bounding box of the taps of the block's 4 corner columns
// at the run's first and last plane (a plane maps the tile to a convex
// quadrilateral and a point moves monotonically with 1 / depth, so that
// box holds every tap of the block), widened by one pixel for rounding,
// clipped to the image and cut to BWD_WIN pixels. A tap reads its 4
// channels with one 16-byte shared load and adds into them with one
// 16-byte compare-and-swap (sm_90 has no float add in shared memory: a
// float atomicAdd there is a 4-byte compare-and-swap loop). A lane's 8
// compare-and-swaps of a view are predicated, with no branch between them,
// so each next read issues before the last swap's result is checked; lanes
// of a warp whose taps are the same pixels (a view that shrinks the
// reference) take turns, and the rows of a block are two apart, so its
// warps seldom touch one pixel at once (adjacent rows share a source row);
// the few that lose try again one at a time. At the end of the block each
// window pixel is added to device memory with float4 atomicAdds (sm_90),
// into a gradient padded to 36 floats a pixel (the wrapper returns the
// first 35). A tap outside the window (a cut window, a corner behind the
// source camera, which empties the window, degenerate geometry) reads its
// source values and adds its gradient in device memory instead: the same
// sums either way. The reference view's gradient is summed over the
// block's planes in registers and added once per (column, channel). The
// TPU kernel's x-band windows, tile-major lanes, one-hot MXU transposes and
// `bwd_groups` partial accumulators have no counterpart.
//
// What bounds K2 on the H100: reading the cotangent, 4 B x (3V+C) per
// voxel (the same 770 MB K1 writes), is ~0.4 ms of it at the DTU shape.
// The rest is latency: per (voxel, view, group), the tap arithmetic
// (recomputed by each of the 5 channel groups) and the compare-and-swap
// round trips into the window, at 16 warps an SM (the registers and the
// windows of two blocks). Measured times, and the variants tried: PERF.md.

#include <cuda_runtime.h>

namespace {

// T / depth of one source view's [R | T] at one plane: the same for every
// voxel of the plane
struct PlaneT {
  float t[3];
};

__device__ __forceinline__ PlaneT plane_t(const float* P, float depth) {
  PlaneT q;
#pragma unroll
  for (int i = 0; i < 3; ++i) q.t[i] = __fdiv_rn(P[4 * i + 3], depth);
  return q;
}

// The source-pixel coordinate of one voxel in one source view, by K1's
// arithmetic: (px, py) for the in-bounds mask, (ix, iy) as
// grid_sample(align_corners=True) unnormalises it, and whether the plane
// point lies in front of the source camera. `tz` is the plane's T / depth.
// Halving is a multiply by 0.5: the same correctly rounded value as the
// divide by 2.
struct SweepCoord {
  float px, py, ix, iy;
  bool front;
};

__device__ __forceinline__ SweepCoord sweep_coord(const float* P,
                                                  const float* tz, float gx,
                                                  float gy, int h, int w) {
  SweepCoord q;
  // R @ [gx, gy, 1] + T / depth, then the perspective divide
  float s3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    s3[i] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(P[4 * i], gx),
                                          __fmul_rn(P[4 * i + 1], gy)),
                                P[4 * i + 2]),
                      tz[i]);
  q.front = s3[2] > 0.f;
  const float inv_z = __fdiv_rn(1.f, s3[2]);
  q.px = __fmul_rn(s3[0], inv_z);
  q.py = __fmul_rn(s3[1], inv_z);
  // normalise, then unnormalise as grid_sample(align_corners=True) does
  const float gnx = __fsub_rn(__fdiv_rn(q.px, (w - 1) * 0.5f), 1.f);
  const float gny = __fsub_rn(__fdiv_rn(q.py, (h - 1) * 0.5f), 1.f);
  q.ix = __fmul_rn(__fmul_rn(__fadd_rn(gnx, 1.f), 0.5f), (float)(w - 1));
  q.iy = __fmul_rn(__fmul_rn(__fadd_rn(gny, 1.f), 0.5f), (float)(h - 1));
  return q;
}

// The bilinear taps of one voxel in one source view, by K1's arithmetic.
struct SweepTap {
  bool inside;  // strict in-bounds mask (pallas_sweep2.py:165-168)
  bool hit;     // at least one tap lies in the image
  int x0, y0;
  float wt[4];  // (x0, y0), (x0+1, y0), (x0, y0+1), (x0+1, y0+1)
};

__device__ __forceinline__ SweepTap sweep_tap(const float* P,
                                              const float* tz, float gx,
                                              float gy, int h, int w) {
  SweepTap t;
  const SweepCoord q = sweep_coord(P, tz, gx, gy, h, w);
  t.inside = q.px > 0.f && q.px < w - 1.f && q.py > 0.f && q.py < h - 1.f;
  const float ix = q.ix, iy = q.iy;
  // bilinear, zeros padding: out-of-image corners contribute nothing
  t.hit = ix > -1.f && ix < (float)w && iy > -1.f && iy < (float)h;
  if (t.hit) {
    const float fx = floorf(ix), fy = floorf(iy);
    t.x0 = (int)fx;
    t.y0 = (int)fy;
    const float wx1 = ix - fx, wy1 = iy - fy;
    const float wx0 = (fx + 1.f) - ix, wy0 = (fy + 1.f) - iy;
    t.wt[0] = wx0 * wy0;
    t.wt[1] = wx1 * wy0;
    t.wt[2] = wx0 * wy1;
    t.wt[3] = wx1 * wy1;
  }
  return t;
}

// tap k of `t` lies in the h x w image
__device__ __forceinline__ bool tap_in(const SweepTap& t, int k, int h,
                                       int w) {
  const int xi = t.x0 + (k & 1), yi = t.y0 + (k >> 1);
  return xi >= 0 && xi < w && yi >= 0 && yi < h;
}

__device__ __forceinline__ long long tap_pixel(const SweepTap& t, int k,
                                               int w) {
  return (long long)(t.y0 + (k >> 1)) * w + t.x0 + (k & 1);
}

// K1's tiling (ops/sweep.py's SW_* constants mirror these)
constexpr int SW_TX = 32;       // reference columns of a block (a warp a row)
constexpr int SW_TY = 4;        // rows of a block
constexpr int SW_RUN = 16;      // planes of a block
constexpr int SW_CG = 16;       // feature channels of a group: 4 quads
constexpr int SW_MIN_BLOCKS = 6;  // blocks an SM holds at once: <= 85
                                  // registers a thread
constexpr int SW_QUADS = 9;     // quads of a packed source pixel: 8 of
                                // features, then [r, g, b, 0]
constexpr int SW_THREADS = SW_TX * SW_TY;
constexpr int SW_MAX_SMEM = 48 * 1024;  // the views' projections and T /
                                        // depth, static launch limit

// (V, h, w, 35) sources -> (V, SW_QUADS, h, w) float4s, one thread a
// pixel: quad q of pixel p of view v at (v * SW_QUADS + q) * h * w + p
__global__ void sweep_pack_kernel(const float* __restrict__ srcs,
                                  float4* __restrict__ packed, long long hw,
                                  long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* s = srcs + i * 35;
  float4* o = packed + i / hw * SW_QUADS * hw + i % hw;
#pragma unroll
  for (int q = 0; q < 8; ++q)
    o[q * hw] = make_float4(s[4 * q], s[4 * q + 1], s[4 * q + 2],
                            s[4 * q + 3]);
  o[8 * hw] = make_float4(s[32], s[33], s[34], 0.f);
}

// One block: SW_TX reference columns x SW_TY rows x SW_RUN planes
// (blockIdx.x) for channel group blockIdx.y: features [16 y, 16 y + 16)
// for y < 2, the rgb channels for y = 2. Dynamic shared memory: each
// source view's projection, then its T / depth at the block's planes.
__global__ void __launch_bounds__(SW_THREADS, SW_MIN_BLOCKS)
    sweep_kernel(const float4* __restrict__ src4,
                 const float* __restrict__ proj,
                 const float* __restrict__ depths, float* __restrict__ out,
                 int V, int h, int w, int D, int pad) {
  constexpr int C = 32, CG = SW_CG;
  extern __shared__ float ssm[];
  const int NS = V - 1;
  float* const sproj = ssm;          // [view][12]
  float* const stz = ssm + 12 * NS;  // [view][plane][3]
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const int ntx = (wp + SW_TX - 1) / SW_TX;
  const int nty = (hp + SW_TY - 1) / SW_TY;
  const int tx0 = blockIdx.x % ntx * SW_TX;
  const int ty0 = blockIdx.x / ntx % nty * SW_TY;
  const int d0 = blockIdx.x / (ntx * nty) * SW_RUN;
  const int d1 = min(D, d0 + SW_RUN);
  for (int i = threadIdx.x; i < 12 * NS; i += SW_THREADS) sproj[i] = proj[i];
  for (int i = threadIdx.x; i < NS * SW_RUN; i += SW_THREADS) {
    const int s = i / SW_RUN, k = i % SW_RUN;
    if (d0 + k < d1) {
      const PlaneT q = plane_t(proj + 12 * s, depths[d0 + k]);
#pragma unroll
      for (int j = 0; j < 3; ++j) stz[3 * i + j] = q.t[j];
    }
  }
  __syncthreads();
  const int x = tx0 + threadIdx.x % SW_TX, y = ty0 + threadIdx.x / SW_TX;
  if (x >= wp || y >= hp) return;
  const long long hw = (long long)h * w;
  const long long plane = (long long)hp * wp, n = D * plane;
  // channel c of this column's voxel at plane d is o[c * n], o advancing
  // a plane a step (NCDHW)
  float* o = out + d0 * plane + (long long)y * wp + x;
  // the reference view is zero-padded, not warped (homography.py:170-172)
  const int rx = x - pad, ry = y - pad;
  const bool interior = rx >= 0 && rx < w && ry >= 0 && ry < h;
  const long long rpix = interior ? (long long)ry * w + rx : 0;
  const float gx = (float)rx, gy = (float)ry;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // view s's taps at plane d
  auto tap = [&](int s, int d) {
    return sweep_tap(sproj + 12 * s, stz + 3 * (s * SW_RUN + d - d0), gx, gy,
                     h, w);
  };

  if (blockIdx.y == C / CG) {  // rgb: the reference's, then each view's warp
    const float4 r = interior ? __ldg(src4 + 8 * hw + rpix) : zero;
    for (int d = d0; d < d1; ++d, o += plane) {
      __stcs(o, r.x);
      __stcs(o + n, r.y);
      __stcs(o + 2 * n, r.z);
      for (int s = 0; s < NS; ++s) {
        const SweepTap t = tap(s, d);
        float4 v = zero;
        if (t.hit) {
          const float4* q = src4 + ((s + 1) * SW_QUADS + 8) * hw;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!tap_in(t, k, h, w)) continue;
            const float4 f = __ldg(q + tap_pixel(t, k, w));
            v.x = fmaf(f.x, t.wt[k], v.x);
            v.y = fmaf(f.y, t.wt[k], v.y);
            v.z = fmaf(f.z, t.wt[k], v.z);
          }
        }
        float* ov = o + 3 * (s + 1) * n;
        __stcs(ov, v.x);
        __stcs(ov + n, v.y);
        __stcs(ov + 2 * n, v.z);
      }
    }
    return;
  }

  constexpr int QG = CG / 4;   // this group's quads: q0 .. q0 + QG - 1
  const int q0 = QG * blockIdx.y;
  const float4* const rq = src4 + q0 * hw + rpix;
  float* const ovar = o + (3 * V + CG * blockIdx.y) * n;
  for (int d = d0; d < d1; ++d) {
    float sum[CG], sq[CG];
#pragma unroll
    for (int j = 0; j < QG; ++j) {
      const float4 r = interior ? __ldg(rq + j * hw) : zero;
      const float f[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sum[4 * j + c] = f[c];
        sq[4 * j + c] = __fmul_rn(f[c], f[c]);
      }
    }
    float count = 1.f;
    for (int s = 0; s < NS; ++s) {
      const SweepTap t = tap(s, d);
      if (t.inside) count += 1.f;
      const float4* q = src4 + ((s + 1) * SW_QUADS + q0) * hw;
#pragma unroll
      for (int j = 0; j < QG; ++j) {
        float val[4] = {0.f, 0.f, 0.f, 0.f};
        if (t.hit) {
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!tap_in(t, k, h, w)) continue;
            const float4 a = __ldg(q + j * hw + tap_pixel(t, k, w));
            val[0] = fmaf(a.x, t.wt[k], val[0]);
            val[1] = fmaf(a.y, t.wt[k], val[1]);
            val[2] = fmaf(a.z, t.wt[k], val[2]);
            val[3] = fmaf(a.w, t.wt[k], val[3]);
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * j + c;
          sum[i] = __fadd_rn(sum[i], val[c]);
          sq[i] = __fadd_rn(sq[i], __fmul_rn(val[c], val[c]));
        }
      }
    }
    // var = E[x^2] - E[x]^2 over the views that see the voxel, in f32
    const float inv = __fdiv_rn(1.f, count);
    float* const ov = ovar + (d - d0) * plane;
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      const float mean = __fmul_rn(sum[c], inv);
      __stcs(ov + c * n,
             __fsub_rn(__fmul_rn(sq[c], inv), __fmul_rn(mean, mean)));
    }
  }
}

// element strides of the (1, 3V+C, D, hp, wp) cotangent: channel, plane,
// row, column
struct GradStrides {
  long long c, d, y, x;
};

// K2's tiling (ops/sweep.py's BWD_* constants mirror these)
constexpr int BWD_TX = 32;       // reference columns of a block in x
constexpr int BWD_TY = 8;        // ... in y (a warp a row)
constexpr int BWD_YSTEP = 2;     // ... every other row: two blocks share a
                                 // band of BWD_TY x BWD_YSTEP rows
constexpr int BWD_RUN = 16;      // planes of a block
constexpr int BWD_CG = 8;        // feature channels of a block
constexpr int BWD_MAX_SRC = 4;   // source views (V <= 5): a warp's lanes
                                 // take the windows' 8 corner points each
constexpr int BWD_WIN = 768;     // window pixels a source view, at most
constexpr int BWD_THREADS = BWD_TX * BWD_TY;
constexpr int GS = 36;           // floats a pixel of the padded gradient
constexpr int SLOT_OUT = -1;     // a tap in the image, outside the window
constexpr int SLOT_NONE = -2;    // a tap off the image

// Float offset of channels 4 h .. 4 h + 3 of window pixel p: a pixel's
// BWD_CG = 8 channels are two float4s, swapped on every other run of 4
// pixels, so that the 8 lanes of a quarter warp reading 8 neighbouring
// pixels' float4 h hit 32 different banks.
__device__ __forceinline__ int wpos(int p, int h) {
  return (2 * p + (h ^ ((p >> 2) & 1))) * 4;
}

// 16-byte compare-and-swap in shared memory (sm_90's ATOMS.CAS.128;
// sm_90 has no float add in shared memory), predicated on `on`, with no
// branch: p[0..3] = n if it holds c; returns whether it did (true where
// not on), and in c what it held
__device__ __forceinline__ bool cas4(bool on, float* p, float4& c,
                                     float4 n) {
  auto bits = [](float lo, float hi) {
    return (unsigned long long)__float_as_uint(hi) << 32 | __float_as_uint(lo);
  };
  const unsigned long long c0 = bits(c.x, c.y), c1 = bits(c.z, c.w);
  unsigned long long o0, o1;
  asm volatile(
      "{\n .reg .pred p;\n .reg .b128 c, n, o;\n setp.ne.u32 p, %7, 0;\n"
      " mov.b128 c, {%2, %3};\n mov.b128 n, {%4, %5};\n"
      " mov.b128 o, c;\n @p atom.shared.cas.b128 o, [%6], c, n;\n"
      " mov.b128 {%0, %1}, o;\n}"
      : "=l"(o0), "=l"(o1)
      : "l"(c0), "l"(c1), "l"(bits(n.x, n.y)), "l"(bits(n.z, n.w)),
        "r"((unsigned)__cvta_generic_to_shared(p)), "r"((unsigned)on)
      : "memory");
  c = make_float4(__uint_as_float((unsigned)o0),
                  __uint_as_float((unsigned)(o0 >> 32)),
                  __uint_as_float((unsigned)o1),
                  __uint_as_float((unsigned)(o1 >> 32)));
  return o0 == c0 && o1 == c1;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One try of p[0..3] += v where `on`: false if another thread changed them
// between the read and the swap. Where not on, p is any address of the
// window, read and left alone.
__device__ __forceinline__ bool try_add4(bool on, float* p, float4 v) {
  float4 c = *reinterpret_cast<const float4*>(p);
  return cas4(on, p, c, add4(c, v));
}

// p[0..3] += v, tried until it holds
__device__ __forceinline__ void shared_add4(float* p, float4 v) {
  float4 c = *reinterpret_cast<const float4*>(p);
  while (!cas4(true, p, c, add4(c, v))) {
  }
}

// blocks along y: each band of BWD_TY x BWD_YSTEP rows takes BWD_YSTEP
// blocks, one for each row parity
__host__ __device__ constexpr int bwd_y_blocks(int hp) {
  return (hp + BWD_TY * BWD_YSTEP - 1) / (BWD_TY * BWD_YSTEP) * BWD_YSTEP;
}

struct Window {
  int x0, y0, w, h;  // origin and extent in the source image; w = 0: empty
};

// The slot of tap k of `t` in window `win` (pixel (y - y0) * win.w + x -
// x0), SLOT_OUT outside it, SLOT_NONE off the image
__device__ __forceinline__ int tap_slot(const SweepTap& t, int k,
                                        const Window& win, int h, int w) {
  if (!t.hit || !tap_in(t, k, h, w)) return SLOT_NONE;
  const int lx = t.x0 + (k & 1) - win.x0, ly = t.y0 + (k >> 1) - win.y0;
  return (unsigned)lx < (unsigned)win.w && (unsigned)ly < (unsigned)win.h
             ? ly * win.w + lx
             : SLOT_OUT;
}

// One block: BWD_TX reference columns x BWD_TY rows (every BWD_YSTEP-th)
// x BWD_RUN planes (blockIdx.x) for channel group blockIdx.y: features
// [8 y, 8 y + 8) for y < 4, the rgb channels for y = 4. Dynamic shared memory: per source view,
// the group's forward window and its gradient window, BWD_WIN pixels of
// BWD_CG floats each (`wpos`). gsrc is (V, h, w, GS), zeroed; taps, when
// not null, counts the feature taps that went to a window ([0]) and to
// device memory ([1]).
template <int NS>
__global__ void __launch_bounds__(BWD_THREADS, 2)
    sweep_bwd_kernel(const float* __restrict__ g,
                     const float* __restrict__ srcs,
                     const float* __restrict__ proj,
                     const float* __restrict__ depths,
                     float* __restrict__ gsrc, GradStrides gst, int h, int w,
                     int D, int pad, unsigned long long* __restrict__ taps) {
  constexpr int C = 32, CS = C + 3, V = NS + 1, CG = BWD_CG;
  constexpr int WV = BWD_WIN * CG;  // floats of a view's window
  static_assert(NS >= 1 && NS <= BWD_MAX_SRC, "1 to 4 source views");
  static_assert(CG == 8, "a window pixel is two float4s");
  extern __shared__ __align__(16) float smem[];
  __shared__ Window win[NS];
  __shared__ float sproj[NS * 12];
  __shared__ PlaneT stz[NS][BWD_RUN];  // each view's T / depth a plane
  float* const fwin = smem;            // [view][pixel][channel]
  float* const gwin = smem + NS * WV;  // the same, gradient

  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const int ntx = (wp + BWD_TX - 1) / BWD_TX;
  const int nty = bwd_y_blocks(hp);
  const int tx0 = blockIdx.x % ntx * BWD_TX;
  // this block's rows: ty0, ty0 + BWD_YSTEP, ... up to ty1, below hp
  const int tyb = blockIdx.x / ntx % nty;
  const int ty0 = tyb / BWD_YSTEP * BWD_TY * BWD_YSTEP + tyb % BWD_YSTEP;
  const int ty1 =
      ty0 + BWD_YSTEP * min(BWD_TY - 1, (hp - 1 - ty0) / BWD_YSTEP);
  const int d0 = blockIdx.x / (ntx * nty) * BWD_RUN;
  const int d1 = min(D, d0 + BWD_RUN);
  const bool rgb = blockIdx.y == C / CG;
  const int c0 = rgb ? C : blockIdx.y * CG;
  const long long hw = (long long)h * w;

  if (threadIdx.x < NS * 12) sproj[threadIdx.x] = proj[threadIdx.x];
  if (threadIdx.x < NS * BWD_RUN && d0 + threadIdx.x % BWD_RUN < d1)
    stz[threadIdx.x / BWD_RUN][threadIdx.x % BWD_RUN] =
        plane_t(proj + 12 * (threadIdx.x / BWD_RUN),
                depths[d0 + threadIdx.x % BWD_RUN]);
  __syncthreads();
  // ---- the windows: lane 8 s + k takes corner k of view s's box
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x, s = lane >> 3, k = lane & 7;
    const int x = (k & 1) ? min(tx0 + BWD_TX, wp) - 1 : tx0;
    const int y = (k & 2) ? ty1 : ty0;
    const int d = (k & 4) ? d1 - 1 : d0;
    float lx = 0.f, ly = 0.f;
    int ok = 0;
    if (s < NS) {
      const SweepCoord q = sweep_coord(sproj + 12 * s, stz[s][d - d0].t,
                                       (float)(x - pad), (float)(y - pad), h,
                                       w);
      ok = ty0 < hp && q.front && isfinite(q.ix) && isfinite(q.iy);
      lx = fminf(fmaxf(q.ix, -2.f), w + 1.f);
      ly = fminf(fmaxf(q.iy, -2.f), h + 1.f);
    }
    float hx = lx, hy = ly;
#pragma unroll
    for (int m = 1; m < 8; m <<= 1) {
      lx = fminf(lx, __shfl_xor_sync(0xffffffffu, lx, m));
      ly = fminf(ly, __shfl_xor_sync(0xffffffffu, ly, m));
      hx = fmaxf(hx, __shfl_xor_sync(0xffffffffu, hx, m));
      hy = fmaxf(hy, __shfl_xor_sync(0xffffffffu, hy, m));
      ok &= __shfl_xor_sync(0xffffffffu, ok, m);
    }
    if (k == 0 && s < NS) {
      Window b;
      b.x0 = max(0, (int)floorf(lx) - 1);
      b.y0 = max(0, (int)floorf(ly) - 1);
      b.w = min(w - 1, (int)floorf(hx) + 2) - b.x0 + 1;
      b.h = min(h - 1, (int)floorf(hy) + 2) - b.y0 + 1;
      if (!ok || b.w <= 0 || b.h <= 0) {
        b.w = b.h = 0;
      } else if (b.w * b.h > BWD_WIN) {
        if (b.w > BWD_WIN) {
          b.w = BWD_WIN;
          b.h = 1;
        } else {
          b.h = BWD_WIN / b.w;
        }
      }
      win[s] = b;
    }
  }
  __syncthreads();
  // ---- stage the forward windows (features), zero the gradient windows
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const Window b = win[s];
    const int n = b.w * b.h;
    for (int i = threadIdx.x; i < n * CG; i += BWD_THREADS) {
      const int c = i % CG, p = i / CG;
      const int at = s * WV + wpos(p, c >> 2) + (c & 3);
      if (!rgb)
        fwin[at] = srcs[((s + 1) * hw + (long long)(b.y0 + p / b.w) * w +
                         b.x0 + p % b.w) * CS + c0 + c];
      gwin[at] = 0.f;
    }
  }
  __syncthreads();

  // ---- the columns: thread (tx, ty) over the run's planes
  const int x = tx0 + threadIdx.x % BWD_TX;
  const int y = ty0 + BWD_YSTEP * (threadIdx.x / BWD_TX);
  const bool live = x < wp && y < hp;
  const int rx = x - pad, ry = y - pad;
  const bool interior = live && rx >= 0 && rx < w && ry >= 0 && ry < h;
  const float gx = (float)rx, gy = (float)ry;
  float ref[CG], gref[CG];
#pragma unroll
  for (int c = 0; c < CG; ++c) {
    ref[c] = !rgb && interior ? srcs[((long long)ry * w + rx) * CS + c0 + c]
                              : 0.f;
    gref[c] = 0.f;
  }
  Window wr[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) wr[s] = win[s];
  const unsigned live_lanes = __ballot_sync(0xffffffffu, live);
  const int lane = threadIdx.x & 31;
  unsigned n_win = 0, n_out = 0;  // taps into windows / outside them
  for (int d = d0; live && d < d1; ++d) {
    // channel c of this voxel's cotangent is gv[c * gst.c]
    const float* gv = g + d * gst.d + y * gst.y + x * gst.x;
    float gc[CG];  // the group's variance channels
#pragma unroll
    for (int c = 0; c < CG; ++c)
      gc[c] = rgb ? 0.f : gv[(3 * V + c0 + c) * gst.c];
    float wt[NS][4];
    int slot[NS][4], base[NS], key[NS];
    float count = 1.f;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const SweepTap t =
          sweep_tap(sproj + 12 * s, stz[s][d - d0].t, gx, gy, h, w);
      if (t.inside) count += 1.f;
      base[s] = t.y0 * w + t.x0;
      key[s] = t.hit ? base[s] : -1 - lane;  // equal: the same 4 pixels
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wt[s][k] = t.wt[k];
        slot[s][k] = tap_slot(t, k, wr[s], h, w);
        n_win += slot[s][k] >= 0;
        n_out += slot[s][k] == SLOT_OUT;
      }
    }
    // tap k of view s in device memory
    auto at = [&](int s, int k) {
      return (s + 1) * hw + base[s] + (k >> 1) * w + (k & 1);
    };
    // gf[q] (channels 4 q .. 4 q + 3) through the taps of view s: one
    // 16-byte compare-and-swap a (tap, float4) into the window, with no
    // branch between them; the taps outside it in device memory. Lanes
    // whose taps are the same pixels take turns; those that still lost to
    // another thread (another warp on the same pixel) try again one at a
    // time.
    auto scatter = [&](int s, const float4* gf, int nq) {
      float* ws = gwin + s * WV;
      const unsigned peers = __match_any_sync(live_lanes, key[s]);
      const int turn = __popc(peers & ((1u << lane) - 1u));
      const int turns = __reduce_max_sync(live_lanes, (unsigned)turn);
      unsigned lost = 0;
      for (int r = 0; r <= turns; ++r) {
        if (r != turn) continue;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int q = 0; q < CG / 4; ++q) {
            if (q >= nq) continue;
            const float4 v =
                make_float4(gf[q].x * wt[s][k], gf[q].y * wt[s][k],
                            gf[q].z * wt[s][k], gf[q].w * wt[s][k]);
            lost |= (unsigned)!try_add4(slot[s][k] >= 0,
                                        ws + wpos(max(slot[s][k], 0), q), v)
                    << (k * CG / 4 + q);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (slot[s][k] != SLOT_OUT) continue;
#pragma unroll
        for (int q = 0; q < CG / 4; ++q)
          if (q < nq)
            atomicAdd(reinterpret_cast<float4*>(gsrc + at(s, k) * GS + c0 +
                                                4 * q),
                      make_float4(gf[q].x * wt[s][k], gf[q].y * wt[s][k],
                                  gf[q].z * wt[s][k], gf[q].w * wt[s][k]));
      }
      while (lost) {
        const int i = __ffs(lost) - 1, k = i / (CG / 4), q = i % (CG / 4);
        lost &= lost - 1;
        shared_add4(ws + wpos(slot[s][k], q),
                    make_float4(gf[q].x * wt[s][k], gf[q].y * wt[s][k],
                                gf[q].z * wt[s][k], gf[q].w * wt[s][k]));
      }
    };
    if (rgb) {  // d rgb_v[k] = g[3v + k] through the taps; no mean
#pragma unroll
      for (int k3 = 0; k3 < 3; ++k3)
        if (interior) gref[k3] += gv[k3 * gst.c];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 gr = make_float4(gv[3 * (s + 1) * gst.c],
                                      gv[(3 * (s + 1) + 1) * gst.c],
                                      gv[(3 * (s + 1) + 2) * gst.c], 0.f);
        scatter(s, &gr, 1);
      }
      continue;
    }
    // this voxel's warp of each view, 4 channels a float4, in K1's order
    float wv[NS][CG];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
#pragma unroll
      for (int hq = 0; hq < CG / 4; ++hq) {
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float4 f;
          if (slot[s][k] >= 0) {
            f = *reinterpret_cast<const float4*>(
                fwin + s * WV + wpos(slot[s][k], hq));
          } else if (slot[s][k] == SLOT_OUT) {
            const float* q = srcs + at(s, k) * CS + c0 + 4 * hq;
            f = make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
          } else {
            continue;
          }
          v.x = fmaf(f.x, wt[s][k], v.x);
          v.y = fmaf(f.y, wt[s][k], v.y);
          v.z = fmaf(f.z, wt[s][k], v.z);
          v.w = fmaf(f.w, wt[s][k], v.w);
        }
        wv[s][4 * hq] = v.x;
        wv[s][4 * hq + 1] = v.y;
        wv[s][4 * hq + 2] = v.z;
        wv[s][4 * hq + 3] = v.w;
      }
    }
    const float inv = __fdiv_rn(1.f, count);
#pragma unroll
    for (int c = 0; c < CG; ++c) {
      float sum = ref[c];
#pragma unroll
      for (int s = 0; s < NS; ++s) sum = __fadd_rn(sum, wv[s][c]);
      const float mean = __fmul_rn(sum, inv);
      // d var / d x = 2 / n (x - mean)
      const float gs = gc[c] * (2.f * inv);
      if (interior) gref[c] += gs * (ref[c] - mean);
#pragma unroll
      for (int s = 0; s < NS; ++s) wv[s][c] = gs * (wv[s][c] - mean);
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float4 gf[CG / 4];
#pragma unroll
      for (int q = 0; q < CG / 4; ++q)
        gf[q] = make_float4(wv[s][4 * q], wv[s][4 * q + 1], wv[s][4 * q + 2],
                            wv[s][4 * q + 3]);
      scatter(s, gf, CG / 4);
    }
  }
  // ---- view 0's gradient: this block's share of the planes
  if (interior) {
    float4* p = reinterpret_cast<float4*>(
        gsrc + ((long long)ry * w + rx) * GS + c0);
    if (rgb) {
      atomicAdd(p, make_float4(gref[0], gref[1], gref[2], 0.f));
    } else {
#pragma unroll
      for (int q = 0; q < CG / 4; ++q)
        atomicAdd(p + q, make_float4(gref[4 * q], gref[4 * q + 1],
                                     gref[4 * q + 2], gref[4 * q + 3]));
    }
  }
  if (taps != nullptr && blockIdx.y == 0) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      n_win += __shfl_xor_sync(0xffffffffu, n_win, m);
      n_out += __shfl_xor_sync(0xffffffffu, n_out, m);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(taps, (unsigned long long)n_win);
      atomicAdd(taps + 1, (unsigned long long)n_out);
    }
  }
  __syncthreads();
  // ---- add the gradient windows to device memory, 4 channels a float4
  const int nq = rgb ? 1 : CG / 4;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const Window b = win[s];
    const int n = b.w * b.h;
    for (int i = threadIdx.x; i < n * nq; i += BWD_THREADS) {
      const int q = i % nq, p = i / nq;
      const float4 v =
          *reinterpret_cast<const float4*>(gwin + s * WV + wpos(p, q));
      if (v.x == 0.f && v.y == 0.f && v.z == 0.f && v.w == 0.f) continue;
      atomicAdd(reinterpret_cast<float4*>(
                    gsrc + ((s + 1) * hw + (long long)(b.y0 + p / b.w) * w +
                            b.x0 + p % b.w) * GS + c0 + 4 * q),
                v);
    }
  }
}

bool bad_args(int V, int h, int w, int C, int D, int pad) {
  return C != 32 || V < 2 || h < 2 || w < 2 || D < 1 || pad < 0;
}

template <int NS>
int launch_bwd(dim3 grid, cudaStream_t st, const float* g, GradStrides gst,
               const float* srcs, const float* proj, const float* depths,
               float* gsrc, int h, int w, int D, int pad,
               unsigned long long* taps) {
  static bool ready = false;
  const int smem = NS * 2 * BWD_WIN * BWD_CG * (int)sizeof(float);
  if (!ready) {
    const int rc = (int)cudaFuncSetAttribute(
        sweep_bwd_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (rc) return rc;
    ready = true;
  }
  sweep_bwd_kernel<NS><<<grid, BWD_THREADS, smem, st>>>(
      g, srcs, proj, depths, gsrc, gst, h, w, D, pad, taps);
  return (int)cudaGetLastError();
}

}  // namespace

// packed: scratch of V x SW_QUADS x h x w float4s, which the first launch
// fills from srcs (V, h, w, 35) and the second reads
extern "C" int sweep_cost_volume(const void* srcs, void* packed,
                                 const void* proj, const void* depths,
                                 void* out, int V, int h, int w, int C, int D,
                                 int pad, void* stream) {
  if (bad_args(V, h, w, C, D, pad)) return (int)cudaErrorInvalidValue;
  const int hp = h + 2 * pad, wp = w + 2 * pad;
  const long long tiles = (long long)((wp + SW_TX - 1) / SW_TX) *
                          ((hp + SW_TY - 1) / SW_TY) *
                          ((D + SW_RUN - 1) / SW_RUN);
  const long long smem = (long long)(V - 1) * (12 + 3 * SW_RUN) * 4;
  if (tiles >= (1LL << 31) || smem > SW_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  auto st = (cudaStream_t)stream;
  const long long hw = (long long)h * w, pix = V * hw;
  sweep_pack_kernel<<<(unsigned)((pix + 255) / 256), 256, 0, st>>>(
      (const float*)srcs, (float4*)packed, hw, pix);
  const int rc = (int)cudaGetLastError();
  if (rc) return rc;
  sweep_kernel<<<dim3((unsigned)tiles, 32 / SW_CG + 1), SW_THREADS,
                 (size_t)smem, st>>>((const float4*)packed, (const float*)proj,
                                     (const float*)depths, (float*)out, V, h,
                                     w, D, pad);
  return (int)cudaGetLastError();
}

// gsrc (V, h, w, 36), the gradient padded to 36 floats a pixel, must be
// zeroed by the caller; g is the (1, 3V+C, D, hp, wp) cotangent with
// element strides (sc, sd, sy, sx); taps: null, or 2 zeroed counters of
// the feature taps added into the windows and outside them. V <= 5.
extern "C" int sweep_cost_volume_bwd(const void* g, long long sc,
                                     long long sd, long long sy, long long sx,
                                     const void* srcs, const void* proj,
                                     const void* depths, void* gsrc, int V,
                                     int h, int w, int C, int D, int pad,
                                     void* taps, void* stream) {
  if (bad_args(V, h, w, C, D, pad) || V > BWD_MAX_SRC + 1 || sc < 0 ||
      sd < 0 || sy < 0 || sx < 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (long long)((w + 2 * pad + BWD_TX - 1) / BWD_TX) *
                          bwd_y_blocks(h + 2 * pad) *
                          ((D + BWD_RUN - 1) / BWD_RUN);
  if (tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 32 / BWD_CG + 1);
  auto st = (cudaStream_t)stream;
  auto gp = (const float*)g;
  const GradStrides gst{sc, sd, sy, sx};
  auto sp = (const float*)srcs;
  auto pp = (const float*)proj;
  auto dp = (const float*)depths;
  auto op = (float*)gsrc;
  auto tp = (unsigned long long*)taps;
  switch (V - 1) {
    case 1: return launch_bwd<1>(grid, st, gp, gst, sp, pp, dp, op, h, w, D, pad, tp);
    case 2: return launch_bwd<2>(grid, st, gp, gst, sp, pp, dp, op, h, w, D, pad, tp);
    case 3: return launch_bwd<3>(grid, st, gp, gst, sp, pp, dp, op, h, w, D, pad, tp);
    default: return launch_bwd<4>(grid, st, gp, gst, sp, pp, dp, op, h, w, D, pad, tp);
  }
}
