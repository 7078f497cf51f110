// The v0 MLP's matrix products on the H100's tensor cores at float32
// accuracy: a tile of rows (samples) times a layer's weights, streamed
// through shared memory, in 3xTF32 with float32 accumulation.
//
// The split. Each float32 operand x is cut into hi = x rounded to TF32 (10
// mantissa bits, to nearest, ties away, as `cvt.rna.tf32.f32` rounds) and
// lo = the remainder x - hi, which the tensor core reads to TF32: rounded
// on the host for the weights, truncated for the activations; hi + lo
// keeps ~21-22 significant bits.
// A product a.b is taken as lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), three
// `mma.sync.m16n8k8` TF32 passes into one float32 accumulator (the lo.lo
// term, below 2^-22 of the product, is dropped). The TPU kernels ran their
// MLPs the same way on the MXU (`_split_dot`, three bf16 passes, or the
// "highest" policy): one TF32 or bf16 pass amplifies through the v0 MLP's
// multiplicative pts_bias cascade to ~1 in rgb.
//
// The operands. A (activations, row-major in shared memory, split in
// registers as they are read) and B (weights, split once a call by the
// wrapper, `ops/render_fused.py` `pack_v0_weights_tc`). B is laid out in
// the order the fragments are read: for each k-step of 8 input rows and
// each n-tile of 8 output columns, 32 lanes x {b0 hi, b1 hi, b0 lo, b1 lo}
// (b0 = W[8 kb + t][8 nb + g], b1 = W[8 kb + t + 4][8 nb + g], lane =
// 4 g + t), so a lane reads one float4 per (k-step, n-tile) and a warp 512
// contiguous bytes. K is zero-padded to a multiple of 8 in that packing.
//
// The stream. All layers' B tiles form one stream (1 MB as hi/lo) that a
// block reads once per tile of rows, chunk by chunk (CHUNK floats, 32 KB)
// through a ring of NSTAGE shared-memory buffers, NSTAGE - 1 chunks ahead
// of the k-step being multiplied (`WeightStream`). One thread a block
// issues each chunk as one bulk copy (`cp.async.bulk`, completing on an
// mbarrier), where 256 threads' 16-byte `cp.async`s cost issue slots.
//
// `mma.sync` rather than `wgmma`: the fragment layouts and the split of A
// stay in registers and plain CUDA (no shared-memory descriptors or
// swizzled canonical layouts, which `wgmma` needs for B, and for A unless
// A comes from registers in its own fragment order), at a lower peak than
// `wgmma`'s. Moving the same tiles to `wgmma` is later work.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mlp_tc {

constexpr int CHUNK = 8192;  // floats per streamed chunk (32 KB)
constexpr int NSTAGE = 3;    // chunks in the shared-memory ring

// ---- the v0 MLP's tensor-core weight stream (pack_v0_weights_tc), in
// floats: each layer's padded (K, N) matrix as hi/lo fragments, K x N x 2
constexpr int TC_PTS_BIAS = 0;     // pts_bias       K 24 (20 + 4 zero rows)
constexpr int TC_PTS_0 = 6144;     // pts_linears.0  K 64 (63 + 1)
constexpr int TC_PTS_1 = 22528;    // pts_linears.1-4, K 128
constexpr int TC_PTS_2 = 55296;
constexpr int TC_PTS_3 = 88064;
constexpr int TC_PTS_4 = 120832;
constexpr int TC_PTS_5 = 153600;   // pts_linears.5  K 192: PE 63, 1 zero, h
constexpr int TC_FEATURE = 202752; // feature_linear K 128
constexpr int TC_VIEWS = 235520;   // views_linears.0's first 128 rows, N 64
constexpr int TC_TOTAL = 251904;
static_assert(TC_PTS_0 == TC_PTS_BIAS + 24 * 128 * 2, "v0 stream");
static_assert(TC_PTS_1 == TC_PTS_0 + 64 * 128 * 2, "v0 stream");
static_assert(TC_PTS_2 == TC_PTS_1 + 128 * 128 * 2, "v0 stream");
static_assert(TC_PTS_3 == TC_PTS_2 + 128 * 128 * 2, "v0 stream");
static_assert(TC_PTS_4 == TC_PTS_3 + 128 * 128 * 2, "v0 stream");
static_assert(TC_PTS_5 == TC_PTS_4 + 128 * 128 * 2, "v0 stream");
static_assert(TC_FEATURE == TC_PTS_5 + 192 * 128 * 2, "v0 stream");
static_assert(TC_VIEWS == TC_FEATURE + 128 * 128 * 2, "v0 stream");
static_assert(TC_TOTAL == TC_VIEWS + 128 * 64 * 2, "v0 stream");

// ---- the transposed stream of K7's backward (pack_v0_weights_tct), in
// the order its deltas read it: each layer's W^T as a padded (K = out,
// N = in) matrix, hi/lo fragments as above, so that d input = d pre . W^T
constexpr int TCT_VIEWS = 0;        // views_linears.0 K 64, N 128 (feat)
constexpr int TCT_FEATURE = 16384;  // feature_linear  K 128, N 128
constexpr int TCT_PTS_5 = 49152;    // pts_linears.5   K 128, N 128 (h only)
constexpr int TCT_PTS_4 = 81920;    // pts_linears.4-1 K 128, N 128
constexpr int TCT_PTS_3 = 114688;
constexpr int TCT_PTS_2 = 147456;
constexpr int TCT_PTS_1 = 180224;
constexpr int TCT_PTS_BIAS = 212992;  // pts_bias K 128, N 24 (20 + 4 zero)
constexpr int TCT_TOTAL = 219136;
static_assert(TCT_FEATURE == TCT_VIEWS + 64 * 128 * 2, "v0 T stream");
static_assert(TCT_PTS_5 == TCT_FEATURE + 128 * 128 * 2, "v0 T stream");
static_assert(TCT_PTS_4 == TCT_PTS_5 + 128 * 128 * 2, "v0 T stream");
static_assert(TCT_PTS_3 == TCT_PTS_4 + 128 * 128 * 2, "v0 T stream");
static_assert(TCT_PTS_2 == TCT_PTS_3 + 128 * 128 * 2, "v0 T stream");
static_assert(TCT_PTS_1 == TCT_PTS_2 + 128 * 128 * 2, "v0 T stream");
static_assert(TCT_PTS_BIAS == TCT_PTS_1 + 128 * 128 * 2, "v0 T stream");
static_assert(TCT_TOTAL == TCT_PTS_BIAS + 128 * 24 * 2, "v0 T stream");
// pts_bias's 16 k-steps of 384 floats lie in one chunk of the stream
static_assert(TCT_PTS_BIAS % CHUNK == 0 && TCT_TOTAL - TCT_PTS_BIAS <= CHUNK,
              "v0 T stream");

// ---- TF32 split and the m16n8k8 product
// x rounded to TF32 as `cvt.rna.tf32.f32` rounds a finite x (to nearest,
// ties away from zero), in two full-rate integer operations: add half a
// unit of the 13 dropped bits to the magnitude, then clear them
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// an activation's split: lo is passed whole, and the tensor core reads
// only its TF32 bits (truncation, within 2^-21 of |x| in all)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a (16 x 8, row) . b (8 x 8, col), TF32 in, float32 accumulate
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8x4 blocks of 32-bit values from shared memory, each lane giving
// one 16-byte row address; lane 4 g + t receives element t of row g of
// each block
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const float* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row))
      : "memory");
}

// ---- mbarriers and bulk copies (sm_90)
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

// this CTA's arrival on its own barrier, expecting `bytes` more to land
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      " @!p bra WAIT;\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global to shared memory, completing on
// the barrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The weight stream of one block: `passes` passes
// over the same `total` floats (one a tile), cut into chunks of CHUNK
// floats (a pass's last one shorter). Chunk g goes to ring buffer
// g % NSTAGE in one bulk copy that thread 0 issues; full[g % NSTAGE]
// completes when it has landed. Every thread calls `take` in the same
// order; it returns the next k-step's B tiles, and at each new chunk
// synchronises the block (the previous chunk is then free) and issues the
// chunk NSTAGE - 1 ahead, into the next pass where a pass ends.
struct WeightStream {
  const float* src;
  float* ring;
  uint64_t* full;  // NSTAGE barriers
  int total, per_pass, n_chunks, g, pos;

  // every thread; the ring and barriers are this block's shared memory
  __device__ void init(const float* s, int n, int passes, float* r,
                       uint64_t* bars) {
    src = s;
    total = n;
    per_pass = (n + CHUNK - 1) / CHUNK;
    n_chunks = passes * per_pass;
    ring = r;
    full = bars;
    g = -1;
    pos = 0;
    if (threadIdx.x == 0) {
      for (int b = 0; b < NSTAGE; ++b) mbar_init(full + b, 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (int c = 0; c < NSTAGE - 1; ++c) issue(c);
  }

  // thread 0: chunk c into buffer c % NSTAGE
  __device__ void issue(int c) {
    if (c >= n_chunks) return;
    const int b = c % NSTAGE, k = c % per_pass;
    const unsigned bytes = (unsigned)min(CHUNK, total - k * CHUNK) * 4u;
    mbar_expect_tx(full + b, bytes);
    bulk_copy(ring + b * CHUNK, src + k * CHUNK, bytes, full + b);
  }

  // start the next pass (tile); its first `take` opens a new chunk
  __device__ void next_pass() { pos = 0; }

  __device__ const float* take(int n) {
    if (pos % CHUNK == 0) {
      if (g >= 0) __syncthreads();  // every thread is done with chunk g
      ++g;
      if (threadIdx.x == 0) issue(g + NSTAGE - 1);
      mbar_wait(full + g % NSTAGE, (g / NSTAGE) & 1);
    }
    const float* p = ring + (g % NSTAGE) * CHUNK + pos % CHUNK;
    pos += n;
    return p;
  }
};

// acc[mi][ni] += A . B over `ksteps` k-steps: A's rows row0 + 16 mi + {g,
// g + 8} and columns [8 kb, 8 kb + 8) of the row-major shared-memory
// matrix A (16-byte aligned rows; conflict-free when its row stride lda %
// 32 == 4); B the next `ksteps` k-steps of the stream (n columns), this
// warp's n-tiles nb0 .. nb0 + NT - 1. 3xTF32, the small terms first.
//
// FRESH: each k-step's three passes go into a zeroed fragment, which is
// then added to acc in f32 (round to nearest). The tensor core truncates
// the low bits of its accumulator input as it adds, so chaining every
// k-step through one fragment biases a long sum by up to ~2^-23 of it a
// step; K7's gradients, differences of such sums, need the f32 add.
template <bool FRESH = false, int MT, int NT, class Stream>
__device__ __forceinline__ void mma_ksteps(float (&acc)[MT][NT][4],
                                           const float* A, int lda, int row0,
                                           int ksteps, Stream& ws, int n,
                                           int nb0) {
  const int lane = threadIdx.x & 31;
  // ldmatrix's row addresses: lanes 8 m .. 8 m + 7 give the rows of 8x4
  // block m = (rows + 8 (m & 1), columns + 4 (m >> 1)), so that register m
  // of lane 4 g + t holds a_m of the m16n8k8 TF32 A fragment
  const float* a_base = A + (row0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * lda +
                        4 * (lane >> 4);
  for (int kb = 0; kb < ksteps; ++kb) {
    const float4* wk =
        reinterpret_cast<const float4*>(ws.take(n * 16)) + nb0 * 32 + lane;
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      uint32_t r[4];
      ldmatrix_x4(r, a_base + 16 * mi * lda + 8 * kb);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split(__uint_as_float(r[e]), ah[mi][e], al[mi][e]);
    }
#pragma unroll
    for (int ni = 0; ni < NT; ++ni) {
      const float4 b = wk[ni * 32];
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (FRESH) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
          mma(t, al[mi], bh0, bh1);
          mma(t, ah[mi], bl0, bl1);
          mma(t, ah[mi], bh0, bh1);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mi][ni][e] += t[e];
        } else {
          mma(acc[mi][ni], al[mi], bh0, bh1);
          mma(acc[mi][ni], ah[mi], bl0, bl1);
          mma(acc[mi][ni], ah[mi], bh0, bh1);
        }
      }
    }
  }
}

// acc[mi][ni] = b[column]: the columns 8 (nb0 + ni) + 2 t + {0, 1} of the
// accumulator fragments, rows alike
template <int MT, int NT>
__device__ __forceinline__ void init_cols(float (&acc)[MT][NT][4],
                                          const float* __restrict__ b,
                                          int nb0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int ni = 0; ni < NT; ++ni) {
    const int col = 8 * (nb0 + ni) + 2 * t;
    const float b0 = __ldg(b + col), b1 = __ldg(b + col + 1);
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      acc[mi][ni][0] = b0;
      acc[mi][ni][1] = b1;
      acc[mi][ni][2] = b0;
      acc[mi][ni][3] = b1;
    }
  }
}

// The shared-memory address of element e of fragment (mi, ni): row row0 +
// 16 mi + g + 8 (e >> 1), column 8 (nb0 + ni) + 2 t + (e & 1)
__device__ __forceinline__ float* frag_at(float* A, int lda, int row0,
                                          int nb0, int mi, int ni, int e) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  return A + (row0 + 16 * mi + g + 8 * (e >> 1)) * lda + 8 * (nb0 + ni) +
         2 * t + (e & 1);
}

}  // namespace mlp_tc
