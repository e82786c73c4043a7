// FiLM conditioning chain, backward (K2), for one MRF stage's n FiLM blocks.
//
// Replaces td_vc_gan_tpu/ops/pallas/cond_chain.py::_bwd_kernel (launched by
// _pallas_bwd, wrapped by _chain_bwd). The forward (cond_chain.cu) computes,
// per batch row b and time t, with exc and lrelu(h) zero outside [0, T):
//
//   h[t]     = sum_j exc[t+j-1] @ W0[j] + hbias - [t==0] edge0 - [t==T-1] edge_t
//   out_i[t] = sum_j lrelu(h_i)[t+j-1] @ W1_i[j] + b1_i        (i < n blocks)
//
// Given g = d(out) (B, T, n*2C) this computes
//
//   da_i[t]  = sum_j g_i[t-j+1] @ W1_i[j]^T        dh = lrelu'(h) * da
//   dexc[t]  = sum_j dh[t-j+1] @ W0[j]^T
//   dW1_i[j] = sum_{b,t} lrelu(h_i)[t+j-1]^T g_i[t]    db1 = sum_{b,t} g
//   dW0[j]   = sum_{b,t} exc[t+j-1]^T dh[t]
//   dhbias   = sum_t dh (also over b when hbias is shared), dedge0 = -dh[0],
//   dedge_t  = -dh[T-1]
//
// with lrelu'(h) = 1 where h >= 0 and 0.2 elsewhere, as the JAX package's
// leaky_relu VJP. The concat form is the same computation with exc = c, a
// shared bias and no edges.
//
// What bounds it on an H100: da and dW1 each cost 2*3*n*Cc*2C flops per
// (b, t) row, the h recompute, dexc and dW0 2*3*E*n*Cc each; at the decoder's
// shapes (n*Cc = 1224, 2C = 32..256) that is hundreds of flops per byte of
// g read, above the card's ridge even at the tensor cores' f32-accurate rate
// (165 TFLOP/s over 3.35 TB/s = 49 flops per byte): K2 is bound by
// operations, even counting the dh scratch below (written once, read once).
//
// What the design does about it. Every product runs on the tensor cores as
// 3xTF32 on Hopper's wgmma (tf32x3.cuh: f32 accuracy at a third of the
// TF32 rate, 2.5x the f32 CUDA-core peak). The TPU kernel accumulates the
// weight grads in VMEM across a grid that runs in order; Hopper CTAs run in
// no order, so the work is split into kernels that each own their outputs,
// and every sum runs in a fixed order (the results are the same from run to
// run, with no atomics). Four launches at E <= 9 (the decoder's E = 8), five
// past it:
//
//  (a) k2_images_kernel lays out, at each launch, the images of the weights
//      the data kernel's products read, split into hi and lo (K-major,
//      without swizzle: tf32x3.cuh): Wh (cond_chain_f32.cuh), W1_i[j]^T for
//      da and W0_i[j]^T for dexc.
//  (b) k2_data_kernel: one CTA per (run of consecutive 124-row time tiles of
//      one batch row, block i, pass of 136 channels of h), with two consumer
//      warpgroups of 64 rows of h and a producer warp (cond_chain_f32.cuh).
//      A run is at most 8 tiles; the runs are as long as make the CTAs'
//      waves take least (at the step's first stage, B = 16 and T = 280, 432
//      CTAs of one tile each). The
//      producer keeps a ring of 3 stages (4 past E = 9) fed: bulk copies of
//      the images, TMA copies of g, whose zero fill outside [0, T) gives the
//      'same' conv's zero rows. Per tile:
//       - h on wgmma as K1 takes it (the same operands in the same order),
//         Wh's k-slices two an item; at E <= 9 its A read from X's image in
//         shared memory (X's rows u0 .. u0 + 63, split, K-major with time
//         contiguous: X^T dh's B too), built from X's values loaded under
//         the tile before's X^T dh; the sign of h as 68 bits a thread, so
//         that h's registers take da;
//       - da_i, M = 64, N = 136, K = 3 x 2C in slices of 8 output channels:
//         a stage is the slice of g for the CTA's 128 rows t0 - 2 ..
//         t0 + 125 (two TMA boxes of 4 channels, raw f32) and the image of
//         W1_i's three taps; A from registers: each thread loads its g
//         fragment for tap j (the rows 2 - j further down) and splits it, a
//         tap a commit group, the next tap's fragment loaded while one runs;
//         in the first pass one warp per channel of the slice sums the
//         tile's rows of g (db1) while the products run;
//       - dh = lrelu'(h) da, zero outside [0, T) and past Cc, raw (f32) to
//         the warpgroup's shared memory, every row; past E = 9 the own rows
//         also to the dh scratch (for (d)) and lrelu(h)'s to the a scratch
//         (for (c)). dh's registers are free from here on;
//       - at E <= 9, X^T dh (dW0, dhbias and the edges, see (d)) of the
//         warpgroup's rows: M = 64 columns of dh (A from dh in shared
//         memory, split as loaded), N = 32 columns of X (B: X's image, its
//         halo rows zeroed), K = the 64 rows; three products (columns 0 ..,
//         64 .. and 72 .., of which 128 .. 135 are kept), each added into
//         the warpgroup's f32 sums in shared memory. At the run's end both
//         warpgroups' sums, in order, make the (batch row, run) partial: at
//         most 16 units of 62 rows (wgmma's f32 sums drift over longer runs,
//         see (c));
//       - dexc: P = dh @ [W0_i[0]^T | W0_i[1]^T | W0_i[2]^T] for E in chunks
//         of 8, one m64n24 product (K = the pass's channels, three k-slices
//         a commit group) with A from dh in shared memory (an 8-byte load
//         gives a thread two of its A registers when the image's K order is
//         permuted: k -> 2k (k < 4), 2(k - 4) + 1); then dexc[t] = (P_0[t+1]
//         + P_1[t]) + P_2[t-1] through shared memory (P in X's place), stored
//         as this block's and pass's f32 part, which (e) sums in order: no
//         read-modify-write across blocks.
//  (c) k2_w1_kernel, dW1 with no scratch of lrelu(h). A CTA owns (block i,
//      pass p, a tile of OT = 64 output channels o, 32 where 2C <= 32) and
//      a chunk of units, a unit being a batch row's 64 rows s0 .. s0 + 63 of
//      lrelu(h). Three warpgroups (warp-specialized, so that the recompute of
//      one unit overlaps the products of the one before):
//       - warpgroup 0 recomputes h_i for the unit's rows as (b) does (the same
//         A words, the same image of Wh, the same k-slices and the same
//         m64n136k8 products in the same order: the same bits, so the slope
//         (b) took and the a taken here never disagree), and writes
//         lrelu(h), split, straight from its accumulators into one of two
//         K-major images: element (c, s) at (c / 8) 2048 + (s / 4) 128 +
//         (c % 8) 16 + (s % 4) 4 bytes, rows past T and channels past Cc
//         zero. The transpose tf32 wgmma needs (K = time) costs nothing: it
//         is the store. Where K = 3E + 3 > 32 (E > 9) Wh's image does not
//         fit the one slot held across units, and the recompute would
//         stream it once per unit and output tile (0.8 MB a unit at
//         E = 256): there warpgroup 0 reads
//         lrelu(h) from the scratch (b) wrote instead, 35 KB a unit, the
//         data kernel's bits by construction. Its first thread asks for each
//         unit's rows of g s0 - 1 .. s0 + 64 (TMA, boxes of 8 channels, zeros
//         outside [0, T) and past 2C) two units ahead;
//       - warpgroups 1 and 2 take dW1_i[j][c][o] += sum_s g[s - j + 1][o]
//         a[s][c] on wgmma, on 72 and 64 columns c: M = 64 rows (tap, o),
//         the three taps of OT channels stacked (3 products at OT = 64, 2 at
//         32), N = the columns c, K = the unit's 64 rows in slices of 8. B
//         is a's image. A is g^T from registers: each thread loads its
//         m16n8k8 A fragment (o = m, s = k) from the raw stage of g, the
//         tap's shift being a shift of the rows it reads, and splits it.
//         The shift cannot go on a's side: one row is 4 bytes inside a core
//         matrix, and descriptors move in 16-byte steps.
//      The chunks are as many as make the CTAs one wave of the card's 132
//      SMs. wgmma's accumulation drifts over long sums (about 2^-24 of the
//      sum an add: 1.3e-4 of max|dW1| over a chunk of 320 units), so a
//      chunk is whole runs of at most 16 units, and the accumulators take
//      one run and write it as an f32 partial (one per run).
//  (d) past E = 9, k2_xdh_kernel, dW0, dhbias, dedge0 and dedge_t as one
//      product, X^T dh, with X the rows of h's A in (b),
//        X[t] = [exc[t-1] | exc[t] | exc[t+1] | 1 | -[t == 0] | -[t == T-1]]   (K = 3E + 3),
//      so that row jE + e of X^T dh is dW0[j][e], row 3E dhbias, rows 3E + 1
//      and 3E + 2 dedge0 and dedge_t (the taps are columns of X: no row
//      shift). Taken as (dh^T X)^T: M = 64 columns of dh a warpgroup (A from
//      registers, loaded from a raw TMA stage of the dh scratch, boxes of 8
//      channels), N = 32 columns of X (B: built by the consumer threads from
//      exc straight into a K-major hi/lo image, time contiguous in a core
//      matrix), K = 64 rows a stage of a 2-stage ring; two CTAs an SM, at
//      least four waves of them. A CTA owns 128 columns of dh, 32 columns
//      of X and one part of one batch row's rows, so that a per-row hbias
//      and the edges never mix two batch rows; its accumulators take one
//      stage and are then added into its f32 sums. dh is read raw (4 bytes
//      an element) rather than written by (b) as a split image (8 bytes):
//      its bytes are the kernel's bound. At E <= 9 (b) takes X^T dh on chip
//      instead, and there is no dh scratch.
//  (e) k2_reduce_kernel sums every kind of partial (dexc's blocks and
//      passes, dW1, db1, dW0, dhbias, the edges) over its chunks in order,
//      in one launch.
//
// Nothing of it grows with Cc or E: one tile for every width (Wh's image is
// fetched by (c) once a batch row, where it fits one chunk of 4 k-slices).
// Past E = 9 the dh scratch and the a scratch ((B, T, n*Cc) f32 each) live
// in device memory.
//
// Numerics: 3xTF32 products into f32 accumulators, no TF32-only product and
// no library call anywhere; the sums run in another order than the plain
// version's, so results agree with it to rounding (tolerances are stated by
// the callers). Inputs with at most 11 significant bits are multiplied
// exactly, so on dyadic inputs the recomputed h, and the slope taken at each
// element, are exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

#include <algorithm>

#include "cond_chain_f32.cuh"
#include "tf32x3.cuh"

namespace {

using namespace f32chain;

constexpr int kSmCount = 132;  // an H100's SMs: the grids are sized by them

// A diagnostic build (-DCOND_CHAIN_TIMERS) sums the data kernel's clock64
// cycles by phase over the launch, read by cond_chain_bwd_timers: each
// consumer warpgroup's h (its products and sign bits; at E <= 9 with X's
// image, its A, built first), da (its products and
// loads), da's waits on full (also in da), dh (the slope and its stores),
// dexc's products, X^T dh (its products and the
// add into the run's sums), dexc's shift and store, and the whole kernel;
// the producer's waits on empty and its whole. Then k2_w1_kernel's (from
// kW1Timers on): the recompute warpgroup's A (X's fragments at E <= 9, past
// it the read of lrelu(h)), h's products and their wait, the fetches of
// Wh's image, the waits on a_empty, lrelu, its split and store, the g
// ring's waits on empty (its first thread) and its whole; the product
// warpgroups' waits on a_full and on g_full, their A fragments (loads and
// splits), their products, the waits after them, the partials' store and
// their whole. The normal build has none.
#ifdef COND_CHAIN_TIMERS
constexpr int kW1Timers = 12;
constexpr int kTimers = kW1Timers + 16;  // the data kernel: h, da, da's waits, dh, dexc,
                                         // X^T dh, dexc's store, whole, warpgroups,
                                         // producer waits, producer whole, producers;
                                         // k2_w1_kernel: 6 + 1 recompute counters and
                                         // warpgroups, 6 + 1 products'
__device__ unsigned long long g_timers[kTimers];
#define TIMER_START(v) const long long v = clock64()
#define TIMER_ADD(acc, since) acc += clock64() - since
#else
#define TIMER_START(v)
#define TIMER_ADD(acc, since)
#endif

// -- (a), (b): the images and the data kernel

constexpr int kGBox = kTile + 4;           // 128 rows of g a stage: t0 - 2 .. t0 + 125
constexpr int kGTile = 2 * kGBox * 16;     // 4096: 8 channels of them, raw, 4 channels a box
constexpr int kW1Item = 3 * 2 * kHItem;    // 26112: W1_i[j]^T's k-slice, 3 taps, hi and lo
constexpr int kW0Rows = 24;                // dexc's N: 3 taps x 8 columns of exc
constexpr int kW0Block = kW0Rows * 32;     // 768: a k-slice of dexc's B, hi or lo
constexpr int kW0Item = kPassSlices * 2 * kW0Block;  // 26112: a pass of it
constexpr int kDSlot = kGTile + kW1Item;   // 30208: a ring slot (a multiple of 128: TMA)
static_assert(kDSlot % 128 == 0 && kW0Item <= kDSlot && 2 * 2 * kHItem <= kDSlot,
              "ring items fit a slot");
constexpr int kPLd = 28;                   // floats a row of dexc's P in shared memory
constexpr int kPBytes = kRows * kPLd * 4;  // 7168: a warpgroup's P
constexpr int kRunTiles = 8;               // tiles a CTA walks at most: 16 units of 62 rows
// A warpgroup's dh, raw: 17 boxes of 8 columns x 64 rows, 32 bytes a row
// (dexc's and X^T dh's A); at E <= 9 (K = 3E + 3 <= 30) its X's image, h's A
// and X^T dh's B (32 columns k x 64 rows t, K-major, hi then lo; dexc's P in
// its place once X^T dh has read it), and the CTA's run's X^T dh in f32
// (rows k < 30 of 136 columns c)
constexpr int kDhBox = kRows * 32;               // 2048
constexpr int kDhRaw = kPassSlices * kDhBox;     // 34816
constexpr int kXdhN = 32;                        // X^T dh's N: columns k of X
constexpr int kXGroup = kRows * 32;              // 2048: 8 columns of X, every row (SBO)
constexpr int kXImg = (kXdhN / 8) * kXGroup;     // 8192: X, hi or lo
constexpr int kXdhRows = 30;                     // K = 3E + 3 at E = 9
constexpr int kSumBytes = kXdhRows * kPass * 4;  // 16320
static_assert(kPBytes <= 2 * kXImg, "dexc's P lies in X's place once X^T dh has read it");

// The data kernel's shared memory: the ring, then each consumer warpgroup's
// own part (dh raw; at E <= 9 X's image and the run's X^T dh, else dexc's
// P), then the barriers
template <bool kNarrow>
struct DataSmem {
  static constexpr int kStages = kNarrow ? 3 : 4;
  static constexpr int kOwnBytes = kDhRaw + (kNarrow ? 2 * kXImg + kSumBytes : kPBytes);
  static constexpr size_t kBytes =
      (size_t)kStages * kDSlot + 2 * (size_t)kOwnBytes + 16 * kStages + 1024;
  static_assert(kBytes <= kSmemMax, "K2's data kernel's shared memory");
};

struct DataArgs {
  HArgs h;
  const unsigned char* img_h;   // Wh's images (cond_chain_f32.cuh)
  long long h_image;            // bytes of one batch row's (0: one for every row)
  const unsigned char* img_w1;  // da's B: [i][p][so][j][hi, lo][136 rows c x 8 o]
  const unsigned char* img_w0;  // dexc's B: [i][p][ec][s][hi, lo][24 rows (j, e) x 8 c]
  float* dh_out;                // E > 9: (B, T, n*Cc) scratch: dh, for k2_xdh_kernel
  float* a_out;                 // E > 9: (B, T, n*Cc) scratch: lrelu(h), for k2_w1_kernel
  float* dexc;                  // (B, T, E) where n npass = 1, else (n npass, B, T, E):
                                // each block's and pass's part, summed in order by (e)
  float* pb1;                   // (B, ntiles, n*2C): g summed over a tile's rows
  float* pw0;                   // E <= 9: (B nruns, K, n*Cc): X^T dh of each (batch row, run)
  int two_c, no, ne, ntiles, run, nruns, kx;  // no, ne: slices of 8 of 2C and of E; run:
                                              // tiles a CTA walks; kx = 3E + 3
  CUtensorMap g_map;            // g as (o: 2C, i: n, t: T, b: B), box (4, 1, 128, 1)
};

// dexc's K order within a slice: image column k holds channel perm(k), so
// that dh's neighbours (2 tig, 2 tig + 1), one 8-byte load, are the A
// fragment's columns (tig, tig + 4)
__device__ __forceinline__ int perm(int k) { return k < 4 ? 2 * k : 2 * (k - 4) + 1; }

// X[u0 + q][k] for the warpgroup's rows q and k < 32 (x_at's values): thread
// wt's 16, column wt % 32 of the row quads wt / 32 + 4 z
__device__ __forceinline__ void x_load(const HArgs& h, int b, int u0, const Lane& l,
                                       float (&xv)[16]) {
  const int kk = l.wt & 31;
  const int tap = kk < 3 * h.E ? (kk >= h.E) + (kk >= 2 * h.E) : -1;
  const float* src = h.exc + (size_t)b * h.T * h.E + (tap >= 0 ? kk - tap * h.E : 0);
  const float ones = kk == 3 * h.E ? 1.f : 0.f;
  const int edge = kk == 3 * h.E + 1 ? 0 : kk == 3 * h.E + 2 ? h.T - 1 : -1;
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    const int tg = (l.wt >> 5) + 4 * z;
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int u = u0 + 4 * tg + x;
      const int t = u + tap - 1;
      float v = u == edge ? -1.f : ones;
      if (tap >= 0) v = t >= 0 && t < h.T ? __ldg(src + (size_t)t * h.E) : 0.f;
      xv[4 * z + x] = v;
    }
  }
}

// x_load's values split into X's K-major image at dst (hi, then lo kXImg
// on): element (k, q) at (k / 8) 2048 + (q / 4) 128 + (k % 8) 16 + (q % 4) 4
// bytes, 16 bytes each of hi and lo a row quad. h's A reads it
// (x_frag_image), then X^T dh's B, once its halo rows are zeroed (x_halo).
__device__ __forceinline__ void x_image(const float (&xv)[16], const Lane& l, unsigned char* dst) {
  const int kk = l.wt & 31;
#pragma unroll
  for (int z = 0; z < 4; ++z) {
    const int tg = (l.wt >> 5) + 4 * z;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int x = 0; x < 4; ++x) split(xv[4 * z + x], hi[x], lo[x]);
    const int off = (kk >> 3) * kXGroup + tg * 128 + (kk & 7) * 16;
    *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + kXImg + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// X's halo rows q = 0 and 63 zeroed in its image (hi and lo), so that X^T dh
// sums the own rows only: one word a thread
__device__ __forceinline__ void x_halo(const Lane& l, unsigned char* dst) {
  const int kk = l.wt & 31, w = l.wt >> 5;
  const int off = (kk >> 3) * kXGroup + (kk & 7) * 16 + ((w & 1) ? 15 * 128 + 12 : 0);
  *reinterpret_cast<uint32_t*>(dst + (w >> 1) * kXImg + off) = 0u;
}

// dexc's products P = dh @ [W0_i[0]^T | W0_i[1]^T | W0_i[2]^T] for 8 columns
// of exc: M = 64, N = 24 (the three taps), K = the pass's 136 channels; A
// from dh raw (dh_row: the thread's row l.row of box 0, 2 tig on; the
// image's permuted K order makes each 8-byte load two of its A registers),
// split two k-slices a commit group, one group in flight while the next is
// loaded; B the image at wb.
__device__ __forceinline__ void dexc_products(const float* dh_row, float (&pj)[12], uint32_t wb) {
  XFrag fa[2][3];
#pragma unroll
  for (int g = 0; g < (kPassSlices + 2) / 3; ++g) {
#pragma unroll
    for (int ss = 0; ss < 3; ++ss) {
      const int s = 3 * g + ss;
      if (s < kPassSlices) {
        XFrag& f = fa[g & 1][ss];
        const float2 r0 = *reinterpret_cast<const float2*>(dh_row + s * (kDhBox / 4));
        const float2 r1 = *reinterpret_cast<const float2*>(dh_row + s * (kDhBox / 4) + 64);
        split(r0.x, f.hi[0], f.lo[0]);
        split(r1.x, f.hi[1], f.lo[1]);
        split(r0.y, f.hi[2], f.lo[2]);
        split(r1.y, f.hi[3], f.lo[3]);
        fence_regs(f.hi);
        fence_regs(f.lo);
      }
    }
    wgmma_fence();
#pragma unroll
    for (int ss = 0; ss < 3; ++ss) {
      const int s = 3 * g + ss;
      if (s < kPassSlices) {
        const XFrag& f = fa[g & 1][ss];
        const uint32_t bh = wb + 2 * s * kW0Block;
        tf32x3::wgmma_rs_n24(pj, f.lo, desc(bh, 128, 256), s > 0);
        tf32x3::wgmma_rs_n24(pj, f.hi, desc(bh + kW0Block, 128, 256), 1);
        tf32x3::wgmma_rs_n24(pj, f.hi, desc(bh, 128, 256), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  fence_regs(pj);
}

// dexc[tb + r] = (P_0[r + 2] + P_1[r + 1]) + P_2[r] for the 62 own rows r and
// the 8 columns of chunk ec (P's row q is dh's time u0 + q = tb - 1 + q),
// through the warpgroup's buffer pw: each row's three taps are other threads'
__device__ __forceinline__ void dexc_store(const HArgs& h, const Lane& l, int bar, int b, int tb,
                                           int ec, const float (&pj)[12], float* pw,
                                           float* dexc) {
#pragma unroll
  for (int jj = 0; jj < 3; ++jj) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      *reinterpret_cast<float2*>(pw + (l.row + 8 * half) * kPLd + jj * 8 + 2 * l.tig) =
          make_float2(pj[4 * jj + 2 * half], pj[4 * jj + 2 * half + 1]);
    }
  }
  bar_sync(bar, 128);
  if (h.E % 8 == 0) {
    // 4 columns a thread: one 16-byte read of each tap's products, one store
    if (l.wt < 2 * kOwn) {
      const int r = l.wt >> 1, e4 = 4 * (l.wt & 1);
      const int t = tb + r;
      const float4 p0 = *reinterpret_cast<const float4*>(pw + (r + 2) * kPLd + e4);
      const float4 p1 = *reinterpret_cast<const float4*>(pw + (r + 1) * kPLd + 8 + e4);
      const float4 p2 = *reinterpret_cast<const float4*>(pw + r * kPLd + 16 + e4);
      if (t < h.T) {
        *reinterpret_cast<float4*>(dexc + ((size_t)b * h.T + t) * h.E + 8 * ec + e4) =
            make_float4((p0.x + p1.x) + p2.x, (p0.y + p1.y) + p2.y, (p0.z + p1.z) + p2.z,
                        (p0.w + p1.w) + p2.w);
      }
    }
  } else {
    // this thread's (row, column) pairs x = wt + 128 z of the 62 x 8
#pragma unroll
    for (int z = 0; z < 4; ++z) {
      const int x = l.wt + 128 * z;
      const int r = x >> 3, e = 8 * ec + (x & 7);
      const int t = tb + r;
      if (x < kOwn * 8 && t < h.T && e < h.E) {
        dexc[((size_t)b * h.T + t) * h.E + e] =
            (pw[(r + 2) * kPLd + (x & 7)] + pw[(r + 1) * kPLd + 8 + (x & 7)]) +
            pw[r * kPLd + 16 + (x & 7)];
      }
    }
  }
  bar_sync(bar, 128);  // every read of pw done before it is written again
}

// kNarrow: E <= 9 (K = 3E + 3 <= 30), X^T dh taken here from dh and X in
// shared memory; else dh (and lrelu(h)) to the scratch for k2_xdh_kernel
// (and k2_w1_kernel).
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1) k2_data_kernel(const __grid_constant__ DataArgs a) {
  using Smem = DataSmem<kNarrow>;
  constexpr int kS = Smem::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* owns = ring + kS * kDSlot;  // [warpgroup][Smem::kOwnBytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(owns + 2 * Smem::kOwnBytes);
  uint64_t* empty = full + kS;

  const HArgs& h = a.h;
  const int b = blockIdx.y;
  const int ip = blockIdx.z;  // the CTA's block i and pass p of 136 channels of h
  const int i = ip / h.npass;
  const int p = ip - i * h.npass;
  const int c0 = kPass * p;
  const int tile0 = blockIdx.x * a.run;
  const int ntl = min(a.run, a.ntiles - tile0);
  const int warp = warp_index();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  if (kNarrow) {  // the run's X^T dh starts from zero
    for (int idx = threadIdx.x; idx < 2 * kXdhRows * kPass; idx += kThreads) {
      const int w = idx / (kXdhRows * kPass);
      reinterpret_cast<float*>(owns + w * Smem::kOwnBytes + kDhRaw +
                               2 * kXImg)[idx - w * kXdhRows * kPass] = 0.f;
    }
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: per tile of the run, Wh's k-slices (two an item), then per slice of 8
    // output channels g's rows and W1's image, then dexc's B per chunk of E
    if (threadIdx.x == 256) {
#ifdef COND_CHAIN_TIMERS
      long long t_w = 0;
      const long long t_all = clock64();
#endif
      prefetch_map(&a.g_map);
      const unsigned char* img_h = a.img_h + (size_t)b * a.h_image + (size_t)ip * h.nkh * 2 * kHItem;
      const unsigned char* img_w1 = a.img_w1 + (size_t)ip * a.no * kW1Item;
      const unsigned char* img_w0 = a.img_w0 + (size_t)ip * a.ne * kW0Item;
      int k = 0;
      auto put_item = [&](const void* src, uint32_t bytes) {
        const int slot = slot_of<kS>(k);
        TIMER_START(tw);
        mbar_wait(&empty[slot], parity_of<kS>(k) ^ 1);
        TIMER_ADD(t_w, tw);
        mbar_arrive_expect_tx(&full[slot], bytes);
        bulk_load(ring + slot * kDSlot, src, bytes, &full[slot]);
        ++k;
      };
      for (int tl = 0; tl < ntl; ++tl) {
        const int t0 = (tile0 + tl) * kTile;
        for (int s = 0; s < h.nkh; s += 2) {
          put_item(img_h + (size_t)s * 2 * kHItem, (uint32_t)min(2, h.nkh - s) * 2 * kHItem);
        }
        for (int so = 0; so < a.no; ++so) {
          const int slot = slot_of<kS>(k);
          TIMER_START(tw);
          mbar_wait(&empty[slot], parity_of<kS>(k) ^ 1);
          TIMER_ADD(t_w, tw);
          mbar_arrive_expect_tx(&full[slot], kGTile + kW1Item);
          unsigned char* dst = ring + slot * kDSlot;
          tma_load_4d(dst, &a.g_map, &full[slot], 8 * so, i, t0 - 2, b);
          tma_load_4d(dst + kGTile / 2, &a.g_map, &full[slot], 8 * so + 4, i, t0 - 2, b);
          bulk_load(dst + kGTile, img_w1 + (size_t)so * kW1Item, kW1Item, &full[slot]);
          ++k;
        }
        for (int ec = 0; ec < a.ne; ++ec) put_item(img_w0 + (size_t)ec * kW0Item, kW0Item);
      }
#ifdef COND_CHAIN_TIMERS
      atomicAdd(&g_timers[9], (unsigned long long)t_w);
      atomicAdd(&g_timers[10], (unsigned long long)(clock64() - t_all));
      atomicAdd(&g_timers[11], 1ull);
#endif
    }
    return;
  }

  const int wg = warp >> 2;
  const int bar = 1 + wg;
  const Lane l;
  const int lane = threadIdx.x & 31;
  const int n0 = h.n * h.cc;
  const int n2 = h.n * a.two_c;
  unsigned char* own = owns + wg * Smem::kOwnBytes;
  const float* dhr = reinterpret_cast<const float*>(own);  // dh raw: [c / 8][q][c % 8]
  unsigned char* ximg = own + kDhRaw;                       // E <= 9: X's image
  float* pw = reinterpret_cast<float*>(own + kDhRaw);      // dexc's P (at E <= 9 in X's place)
  float* sums = reinterpret_cast<float*>(own + kDhRaw + 2 * kXImg);  // [k][c]: the run's X^T dh
  // this block's and pass's dexc: the output where n npass = 1, else its part
  float* const dexc =
      a.dexc + (h.n * h.npass == 1 ? 0 : (size_t)ip * gridDim.y * h.T * h.E);
#ifdef COND_CHAIN_TIMERS
  long long tm[7] = {0, 0, 0, 0, 0, 0, 0};
  const long long t_all = clock64();
#endif
  int k = 0;
  float xv[16];
  if (kNarrow) x_load(h, b, tile0 * kTile + kOwn * wg - 1, l, xv);
  for (int tl = 0; tl < ntl; ++tl) {
    const int t0 = (tile0 + tl) * kTile;
    const int tb = t0 + kOwn * wg;  // the warpgroup's first own row
    const int u0 = tb - 1;          // its h row q = 0
    float acc[68];
    // 1. h; where h >= 0, as bits. At E <= 9 its A from X's image (X^T dh's
    // B too), written first from the values loaded under the last tile's X^T dh
    TIMER_START(t_h);
    if (kNarrow) {
      x_image(xv, l, ximg);
      bar_sync(bar, 128);
    }
    h_pass<kS, kDSlot>(h, acc, ring, full, empty, k, b, u0, l, kNarrow ? ximg : nullptr);
    uint32_t pos[3] = {0u, 0u, 0u};
#pragma unroll
    for (int r = 0; r < 68; ++r) {
      if (acc[r] >= 0.f) pos[r >> 5] |= 1u << (r & 31);
    }
    if (!kNarrow) {
      // lrelu(h) of the own rows, for k2_w1_kernel, which would stream Wh's
      // image once per unit
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const int u = u0 + q;
          const int c = c0 + nt * 8 + 2 * l.tig;
          if (q >= 1 && q <= kOwn && u < h.T && c < h.cc) {
            const float x0 = acc[nt * 4 + 2 * half], x1 = acc[nt * 4 + 2 * half + 1];
            *reinterpret_cast<float2*>(a.a_out + ((size_t)b * h.T + u) * n0 + i * h.cc + c) =
                make_float2(x0 >= 0.f ? x0 : kSlope * x0, x1 >= 0.f ? x1 : kSlope * x1);
          }
        }
      }
    }
    TIMER_ADD(tm[0], t_h);
    // 2. da = sum_j g[t - j + 1] @ W1_i[j]^T, a slice of 8 output channels an
    // item, a tap a commit group: tap j's A (g at the h row's time - j + 1,
    // the stage's row 62 wg + q + 2 - j) loaded and split while the tap before
    // runs; an item's slot released once its last tap is done
    TIMER_START(t_da);
    zero(acc);
    {
      XFrag gf[3];
      int prev = -1;
      for (int so = 0; so < a.no; ++so) {
        const int slot = slot_of<kS>(k);
        TIMER_START(t_w);
        mbar_wait(&full[slot], parity_of<kS>(k));
        TIMER_ADD(tm[2], t_w);
        const float* graw = reinterpret_cast<const float*>(ring + slot * kDSlot);
        const uint32_t base = smem_u32(ring + slot * kDSlot) + kGTile;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float* g0 = graw + (kOwn * wg + l.row + 2 - j) * 4 + l.tig;
          split(g0[0], gf[j].hi[0], gf[j].lo[0]);
          split(g0[32], gf[j].hi[1], gf[j].lo[1]);
          split(g0[kGBox * 4], gf[j].hi[2], gf[j].lo[2]);
          split(g0[kGBox * 4 + 32], gf[j].hi[3], gf[j].lo[3]);
          fence_regs(gf[j].hi);
          fence_regs(gf[j].lo);
          const uint32_t bh = base + 2 * j * kHItem;
          wgmma_fence();
          tf32x3::wgmma_rs_n136(acc, gf[j].lo, desc(bh, 128, 256), 1);
          tf32x3::wgmma_rs_n136(acc, gf[j].hi, desc(bh + kHItem, 128, 256), 1);
          tf32x3::wgmma_rs_n136(acc, gf[j].hi, desc(bh, 128, 256), 1);
          wgmma_commit();
          wgmma_wait<1>();
          if (j == 0 && prev >= 0) release(&empty[prev]);
        }
        if (p == 0) {
          // db1, while the last tap runs: warp w sums channel 8 so + w over
          // the tile's rows t0 .. t0 + 123
          const int o = 8 * so + warp;
          const float* col = graw + (warp >> 2) * kGBox * 4 + (warp & 3);
          float sv = 0.f;
          for (int r = 2 + lane; r < 2 + kTile; r += 32) {
            if (t0 - 2 + r < h.T) sv += col[r * 4];
          }
#pragma unroll
          for (int m = 16; m >= 1; m >>= 1) sv += __shfl_xor_sync(0xffffffffu, sv, m);
          if (lane == 0 && o < a.two_c) {
            a.pb1[((size_t)b * a.ntiles + tile0 + tl) * n2 + i * a.two_c + o] = sv;
          }
        }
        prev = slot;
        ++k;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      release(&empty[prev]);
    }
    TIMER_ADD(tm[1], t_da);
    // 3. dh = lrelu'(h) da, zero outside [0, T) and past Cc, raw to shared
    // memory (every row: the A of dexc and X^T dh), past E = 9 the own rows
    // also to the scratch; dh's registers are free after it. At E <= 9 X's
    // halo rows zeroed (X^T dh's B)
    TIMER_START(t_dh);
#pragma unroll
    for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = l.row + 8 * half;
        const int u = u0 + q;
        const int c = c0 + nt * 8 + 2 * l.tig;
        const bool ok = u >= 0 && u < h.T && c < h.cc;
        float2 v;
        v.x = ok ? ((pos[(nt * 4 + 2 * half) >> 5] >> ((nt * 4 + 2 * half) & 31)) & 1u
                        ? acc[nt * 4 + 2 * half] : kSlope * acc[nt * 4 + 2 * half]) : 0.f;
        v.y = ok ? ((pos[(nt * 4 + 2 * half + 1) >> 5] >> ((nt * 4 + 2 * half + 1) & 31)) & 1u
                        ? acc[nt * 4 + 2 * half + 1] : kSlope * acc[nt * 4 + 2 * half + 1]) : 0.f;
        *reinterpret_cast<float2*>(own + nt * kDhBox + q * 32 + 8 * l.tig) = v;
        if (!kNarrow && ok && q >= 1 && q <= kOwn) {
          *reinterpret_cast<float2*>(a.dh_out + ((size_t)b * h.T + u) * n0 + i * h.cc + c) = v;
        }
      }
    }
    if (kNarrow) {
      x_halo(l, ximg);
      fence_proxy_async();  // X's image, for the async proxy
    }
    bar_sync(bar, 128);     // dh (and X) in place
    TIMER_ADD(tm[3], t_dh);
    if (kNarrow) {
      // 4. X^T dh of the warpgroup's rows, D^T[c][k] = sum_q dh[q][c] X[q][k]:
      // M = 64 columns c of dh (0 .., 64 .., and 72 .., of which 128 .. 135
      // are kept), N = 32 columns k of X (B: its image), K = the 64 rows in
      // slices of 8; A from dh raw, the thread's element (m, kk) of slice ks
      // dh[8 ks + kk][cm + m]; each product added into the run's sums
      TIMER_START(t_x);
      const uint32_t xb = smem_u32(ximg);
      if (tl + 1 < ntl) x_load(h, b, u0 + kTile, l, xv);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int cm = m == 2 ? kPass - 64 : 64 * m;
        const float* ap = dhr + ((cm >> 3) + 2 * (l.row >> 4)) * (kDhBox / 4) + (l.row & 7) +
                          8 * l.tig;
        XFrag f[kRows / 8];
#pragma unroll
        for (int ks = 0; ks < kRows / 8; ++ks) {
          const float* d0 = ap + 64 * ks;
          split(d0[0], f[ks].hi[0], f[ks].lo[0]);
          split(d0[kDhBox / 4], f[ks].hi[1], f[ks].lo[1]);
          split(d0[32], f[ks].hi[2], f[ks].lo[2]);
          split(d0[kDhBox / 4 + 32], f[ks].hi[3], f[ks].lo[3]);
          fence_regs(f[ks].hi);
          fence_regs(f[ks].lo);
        }
        float d[kXdhN / 2];
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kRows / 8; ++ks) {
          tf32x3::wgmma_rs_n32(d, f[ks].lo, desc(xb + 256 * ks, 128, kXGroup), ks > 0);
          tf32x3::wgmma_rs_n32(d, f[ks].hi, desc(xb + kXImg + 256 * ks, 128, kXGroup), 1);
          tf32x3::wgmma_rs_n32(d, f[ks].hi, desc(xb + 256 * ks, 128, kXGroup), 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(d);
        // d[4 nb + v]: column c = cm + l.row + 8 ((v >> 1) & 1), k = 8 nb + 2 tig + (v & 1)
#pragma unroll
        for (int v = 0; v < kXdhN / 2; ++v) {
          const int mm = l.row + 8 * ((v >> 1) & 1);
          const int kx = 8 * (v >> 2) + 2 * l.tig + (v & 1);
          if ((m < 2 || cm + mm >= 128) && kx < kXdhRows) sums[kx * kPass + cm + mm] += d[v];
        }
      }
      bar_sync(bar, 128);  // X read by every product before P takes its place
      TIMER_ADD(tm[5], t_x);
    }
    // 5. dexc: per chunk of 8 columns of E, P = dh @ [W0_i[0]^T | W0_i[1]^T |
    // W0_i[2]^T], then dexc[tb + r] = (P_0[r + 2] + P_1[r + 1]) + P_2[r],
    // stored as this block's and pass's part
    for (int ec = 0; ec < a.ne; ++ec) {
      TIMER_START(t_dx);
      const int slot = slot_of<kS>(k);
      mbar_wait(&full[slot], parity_of<kS>(k));
      float pj[12];
      dexc_products(dhr + l.row * 8 + 2 * l.tig, pj, smem_u32(ring + slot * kDSlot));
      release(&empty[slot]);
      ++k;
      TIMER_ADD(tm[4], t_dx);
      TIMER_START(t_s);
      dexc_store(h, l, bar, b, tb, ec, pj, pw, dexc);
      TIMER_ADD(tm[6], t_s);
    }
  }
  if (kNarrow) {
    // the run's X^T dh, both warpgroups' sums in order: rows k of columns
    // i Cc + c0 + c of the (batch row, run) partial
    bar_sync(3, 256);
    const int cw = min(kPass, h.cc - c0);
    const float* s0 = reinterpret_cast<const float*>(owns + kDhRaw + 2 * kXImg);
    const float* s1 = reinterpret_cast<const float*>(owns + Smem::kOwnBytes + kDhRaw + 2 * kXImg);
    float* pd = a.pw0 + ((size_t)b * a.nruns + blockIdx.x) * a.kx * n0 + (size_t)i * h.cc + c0;
    for (int idx = threadIdx.x; idx < a.kx * kPass; idx += 256) {
      const int kk = idx / kPass, c = idx - kk * kPass;
      if (c < cw) pd[(size_t)kk * n0 + c] = s0[idx] + s1[idx];
    }
  }
#ifdef COND_CHAIN_TIMERS
  if (l.wt == 0) {
    for (int x = 0; x < 7; ++x) atomicAdd(&g_timers[x], (unsigned long long)tm[x]);
    atomicAdd(&g_timers[7], (unsigned long long)(clock64() - t_all));
    atomicAdd(&g_timers[8], 1ull);
  }
#endif
}

struct ImageArgs {
  WhArgs wh;
  const float* w1;  // (3, Cc, n*2C)
  unsigned char* img_h;
  unsigned char* img_w1;
  unsigned char* img_w0;
  int nimg, two_c, no, ne;
};

// The data kernel's images, 16 bytes (4 k of one row of a core matrix) a
// thread (cond_chain_f32.cuh's layout)
__global__ void k2_images_kernel(ImageArgs a) {
  const WhArgs& wh = a.wh;
  const int npass = passes(wh.cc);
  const long long uh = (long long)a.nimg * (long long)(h_image_bytes(wh.n, wh.cc, wh.E) / 16);
  const long long uw1 = (long long)wh.n * npass * a.no * (kW1Item / 16);
  const long long uw0 = (long long)wh.n * npass * a.ne * (kW0Item / 16);
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < uh + uw1 + uw0;
       u += (long long)gridDim.x * blockDim.x) {
    if (u < uh) {
      h_image_unit(wh, u, a.img_h);
      continue;
    }
    float v[4];
    int hl, row, k0;
    unsigned char* dst;
    if (u < uh + uw1) {
      // W1_i[j]^T: row c of the pass, k = output channel 8 so + k
      const long long u2 = u - uh;
      const long long item = u2 / (kW1Item / 16);
      int r = (int)(u2 - item * (kW1Item / 16));
      const int jh = r / kHUnits;
      r -= jh * kHUnits;
      hl = jh & 1;
      unit_place(r, row, k0);
      const int so = (int)(item % a.no);
      const int p = (int)((item / a.no) % npass);
      const int i = (int)(item / ((long long)a.no * npass));
      const int j = jh >> 1;
      const int c = kPass * p + row;
      const int n2 = wh.n * a.two_c;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = 8 * so + k0 + e;
        v[e] = c < wh.cc && o < a.two_c ? a.w1[((size_t)j * wh.cc + c) * n2 + i * a.two_c + o]
                                        : 0.f;
      }
      dst = a.img_w1 + u2 * 16;
    } else {
      // W0_i[j]^T: row 8 j + e of the chunk ec, k = the pass's channel 8 s + perm(k)
      const long long u3 = u - uh - uw1;
      const long long item = u3 / (kW0Item / 16);
      int r = (int)(u3 - item * (kW0Item / 16));
      const int blk = r / (kW0Block / 16);
      r -= blk * (kW0Block / 16);
      hl = blk & 1;
      const int s = blk >> 1;
      unit_place(r, row, k0);
      const int ec = (int)(item % a.ne);
      const int p = (int)((item / a.ne) % npass);
      const int i = (int)(item / ((long long)a.ne * npass));
      const int j = row >> 3;
      const int e = 8 * ec + (row & 7);
      const int n0 = wh.n * wh.cc;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int c = kPass * p + 8 * s + perm(k0 + x);
        v[x] = e < wh.E && c < wh.cc ? wh.w0[((size_t)j * wh.E + e) * n0 + (size_t)i * wh.cc + c]
                                     : 0.f;
      }
      dst = a.img_w0 + u3 * 16;
    }
    put_unit(dst, v, hl);
  }
}

// -- (c): dW1, lrelu(h) recomputed
//
// k2_w1_kernel's CTA: three warpgroups, 384 threads (168 registers a
// thread). Shared memory: two slots of a's image (hi, then lo, each 17
// groups of 8 columns c x 64 rows s); a ring of kW1Stages stages of g (OT
// channels in boxes of 8, each 66 rows of 32 bytes in a 2176-byte slot); a
// Wh's image where it is recomputed (up to 4 k-slices, hi and lo); the
// barriers.
constexpr int kW1Threads = 384;
constexpr int kUnit = 64;                            // a's rows a unit (dW1's K)
constexpr int kGUnitRows = kUnit + 2;                // g's rows a unit: s0 - 1 .. s0 + 64
constexpr int kW1GBox = 68 * 32;                     // 2176: 8 channels of them, 128-byte
                                                     // aligned (a TMA destination)
constexpr int kW1GStage = 8 * kW1GBox;               // 17408: 64 channels
constexpr int kW1Stages = 3;
constexpr int kW1Ahead = 2;
constexpr int kW1Run = 16;                           // units a run at most (the accumulators' take)
constexpr int kAGroup = kUnit * 32;                  // 2048: 8 columns of a, every row (SBO)
constexpr int kAImg = (kPass / 8) * kAGroup;         // 34816: a, hi or lo
constexpr int kASlot = 2 * kAImg;
constexpr int kWhChunk = 4;                          // k-slices of Wh recomputed from
constexpr int kWhBytes = kWhChunk * 2 * kHItem;      // 34816
constexpr size_t kW1Smem = 2 * (size_t)kASlot + (size_t)kW1Stages * kW1GStage + kWhBytes +
                           8 * (2 * kW1Stages + 5) + 1024;
static_assert(kW1Smem <= kSmemMax, "k2_w1_kernel's shared memory");
static_assert(kW1Ahead < kW1Stages, "k2_w1_kernel's ring");

struct W1Args {
  HArgs h;
  const unsigned char* img_h;  // Wh's images, as the data kernel's
  long long h_image;           // bytes of one batch row's (0: one for every row)
  const float* a_in;           // lrelu(h) (B, T, n*Cc) from the data kernel, or null (recomputed)
  float* pw1;                  // (runs, 3, Cc, n*2C): dW1 per run of units
  int two_c, notiles, nsub, units, chunk, run;  // units = B nsub of 64 rows; chunk: units a
                                                // CTA, whole runs of `run` units
  CUtensorMap g_map;           // g as (o: 2C, i: n, t: T, b: B), box (8, 1, 66, 1)
};

// A product warpgroup of k2_w1_kernel: dW1 of the CTA's tile for N columns
// of a from cw on, over its chunk of units; then the partial.
template <int OT, int N>
__device__ __forceinline__ void w1_products(const W1Args& a, const Lane& l,
                                            const unsigned char* aslots,
                                            const unsigned char* gring, uint64_t* g_full,
                                            uint64_t* g_empty, uint64_t* a_full,
                                            uint64_t* a_empty, int i, int c0, int o0, int cw,
                                            int k_begin, int k_end) {
  constexpr int kNch = (3 * OT + 63) / 64;  // products of 64 rows (tap, o)
  // this thread's rows r = 64 m + l.row + 8 half of the stacked taps: tap
  // j = r / OT, channel o = r % OT; the A fragment's element (r, k) is g at
  // the unit's row k - j + 1, the stage's row k + 2 - j
  int off[kNch][2];
  bool ok[kNch][2];
#pragma unroll
  for (int m = 0; m < kNch; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 64 * m + l.row + 8 * half;
      const int j = r / OT, o = r % OT;
      ok[m][half] = r < 3 * OT;
      off[m][half] = ok[m][half] ? (o / 8) * (kW1GBox / 4) + (2 - j + l.tig) * 8 + (o % 8) : 0;
    }
  // The accumulators take one run of units (a chunk is whole runs), then go
  // to the run's partial, and start again: a long run of wgmma's
  // accumulation drifts (it loses about 2^-24 of the sum an add: 1.3e-4 of
  // max|dW1| over 320 units)
  const HArgs& h = a.h;
  const size_t n2 = (size_t)h.n * a.two_c;
  float acc[kNch][N / 2];
#ifdef COND_CHAIN_TIMERS
  long long tw[6] = {0, 0, 0, 0, 0, 0};  // as g_timers from kW1Timers + 8
  const long long t_all = clock64();
#endif
  for (int k = k_begin, n = 0; k < k_end; ++k, ++n) {
    const int fresh = k % a.run == 0;  // the unit's products overwrite the accumulators
    const int slot = n & 1;
    const int st = slot_of<kW1Stages>(n);
    TIMER_START(t_af);
    mbar_wait(&a_full[slot], (uint32_t)((n >> 1) & 1));
    TIMER_ADD(tw[0], t_af);
    TIMER_START(t_gf);
    mbar_wait(&g_full[st], parity_of<kW1Stages>(n));
    TIMER_ADD(tw[1], t_gf);
    const float* gs = reinterpret_cast<const float*>(gring + st * kW1GStage);
    const uint32_t abase = smem_u32(aslots + slot * kASlot) + (cw / 8) * kAGroup;
#pragma unroll 1
    for (int kk = 0; kk < kUnit / 8; ++kk) {
      TIMER_START(t_fr);
      XFrag f[kNch];
#pragma unroll
      for (int m = 0; m < kNch; ++m) {
        const float* p0 = gs + off[m][0] + 64 * kk;
        const float* p1 = gs + off[m][1] + 64 * kk;
        split(ok[m][0] ? p0[0] : 0.f, f[m].hi[0], f[m].lo[0]);
        split(ok[m][1] ? p1[0] : 0.f, f[m].hi[1], f[m].lo[1]);
        split(ok[m][0] ? p0[32] : 0.f, f[m].hi[2], f[m].lo[2]);
        split(ok[m][1] ? p1[32] : 0.f, f[m].hi[3], f[m].lo[3]);
        fence_regs(f[m].hi);
        fence_regs(f[m].lo);
      }
      TIMER_ADD(tw[2], t_fr);
      TIMER_START(t_p);
      const uint32_t bh = abase + 256 * kk;
      wgmma_fence();
      const int keep = kk > 0 || !fresh;
#pragma unroll
      for (int m = 0; m < kNch; ++m) {
        if constexpr (N == 72) {
          tf32x3::wgmma_rs_n72(acc[m], f[m].lo, desc(bh, 128, kAGroup), keep);
          tf32x3::wgmma_rs_n72(acc[m], f[m].hi, desc(bh + kAImg, 128, kAGroup), 1);
          tf32x3::wgmma_rs_n72(acc[m], f[m].hi, desc(bh, 128, kAGroup), 1);
        } else {
          tf32x3::wgmma_rs_n64(acc[m], f[m].lo, desc(bh, 128, kAGroup), keep);
          tf32x3::wgmma_rs_n64(acc[m], f[m].hi, desc(bh + kAImg, 128, kAGroup), 1);
          tf32x3::wgmma_rs_n64(acc[m], f[m].hi, desc(bh, 128, kAGroup), 1);
        }
      }
      wgmma_commit();
      TIMER_ADD(tw[3], t_p);
      TIMER_START(t_pw);
      wgmma_wait<0>();
#pragma unroll
      for (int m = 0; m < kNch; ++m) fence_regs(acc[m]);
      TIMER_ADD(tw[4], t_pw);
    }
    release(&g_empty[st]);
    release(&a_empty[slot]);
    if ((k + 1) % a.run && k + 1 < k_end) continue;
    TIMER_START(t_o);
    float* part = a.pw1 + (size_t)(k / a.run) * 3 * h.cc * n2 + (size_t)i * a.two_c;
#pragma unroll
    for (int m = 0; m < kNch; ++m) {
#pragma unroll
      for (int v = 0; v < N / 2; ++v) {
        const int r = 64 * m + l.row + 8 * ((v >> 1) & 1);
        const int j = r / OT, o = o0 + r % OT;
        const int c = c0 + cw + 8 * (v >> 2) + 2 * l.tig + (v & 1);
        if (r < 3 * OT && o < a.two_c && c < h.cc) {
          part[((size_t)j * h.cc + c) * n2 + o] = acc[m][v];
        }
      }
    }
    TIMER_ADD(tw[5], t_o);
  }
#ifdef COND_CHAIN_TIMERS
  if (l.wt == 0) {
    for (int x = 0; x < 6; ++x) atomicAdd(&g_timers[kW1Timers + 8 + x], (unsigned long long)tw[x]);
    atomicAdd(&g_timers[kW1Timers + 14], (unsigned long long)(clock64() - t_all));
    atomicAdd(&g_timers[kW1Timers + 15], 1ull);
  }
#endif
}

template <int OT>
__global__ void __launch_bounds__(kW1Threads, 1) k2_w1_kernel(const __grid_constant__ W1Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* aslots = smem;
  unsigned char* gring = aslots + 2 * kASlot;
  unsigned char* wh = gring + kW1Stages * kW1GStage;
  uint64_t* g_full = reinterpret_cast<uint64_t*>(wh + kWhBytes);
  uint64_t* g_empty = g_full + kW1Stages;
  uint64_t* a_full = g_empty + kW1Stages;
  uint64_t* a_empty = a_full + 2;
  uint64_t* w_full = a_empty + 2;

  const HArgs& h = a.h;
  const int ot = blockIdx.x % a.notiles;
  const int ip = blockIdx.x / a.notiles;
  const int p = ip % h.npass;
  const int i = ip / h.npass;
  const int o0 = ot * OT;
  const int c0 = p * kPass;
  const int k_begin = blockIdx.y * a.chunk;
  const int k_end = min(a.units, k_begin + a.chunk);
  const int wg = warp_index() >> 2;
  const Lane l;

  if (threadIdx.x == 0) {
    for (int k = 0; k < kW1Stages; ++k) {
      mbar_init(&g_full[k], 1);
      mbar_init(&g_empty[k], 8);  // one arrival per product warp
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(&a_full[k], 4);   // one arrival per recompute warp
      mbar_init(&a_empty[k], 8);
    }
    mbar_init(w_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
#ifdef COND_CHAIN_TIMERS
    long long tw[6] = {0, 0, 0, 0, 0, 0};  // as g_timers from kW1Timers
    const long long t_all = clock64();
#endif
    // the g stage of unit k (the CTA's n-th), once the products of the unit
    // kW1Stages before are done with it
    auto ask_g = [&](int k, int n) {
      const int b = k / a.nsub;
      const int s0 = (k - b * a.nsub) * kUnit;
      const int st = slot_of<kW1Stages>(n);
      TIMER_START(t_ge);
      mbar_wait(&g_empty[st], parity_of<kW1Stages>(n) ^ 1);
      TIMER_ADD(tw[5], t_ge);
      mbar_arrive_expect_tx(&g_full[st], (OT / 8) * kGUnitRows * 32);
      for (int bx = 0; bx < OT / 8; ++bx) {
        tma_load_4d(gring + st * kW1GStage + bx * kW1GBox, &a.g_map, &g_full[st], o0 + 8 * bx, i,
                    s0 - 1, b);
      }
    };
    if (l.wt == 0) {
      prefetch_map(&a.g_map);
      for (int n = 0; n < kW1Ahead && k_begin + n < k_end; ++n) ask_g(k_begin + n, n);
    }
    // batch row b's image of Wh (block i, pass p; at most kWhChunk k-slices
    // where it is recomputed) into the slot, once every recompute thread is
    // done with what it held
    int loads = 0, held = -1;
    auto fetch = [&](int b) {
      TIMER_START(t_f);
      bar_sync(1, 128);
      if (l.wt == 0) {
        mbar_arrive_expect_tx(w_full, (uint32_t)(h.nkh * 2 * kHItem));
        bulk_load(wh, a.img_h + (size_t)b * a.h_image + ((size_t)i * h.npass + p) * h.nkh * 2 * kHItem,
                  (uint32_t)(h.nkh * 2 * kHItem), w_full);
      }
      mbar_wait(w_full, (uint32_t)(loads & 1));
      ++loads;
      TIMER_ADD(tw[2], t_f);
    };
    const uint32_t whb = smem_u32(wh);
    const size_t n0 = (size_t)h.n * h.cc;
    float acc[68];
    for (int k = k_begin, n = 0; k < k_end; ++k, ++n) {
      const int b = k / a.nsub;
      const int u0 = (k - b * a.nsub) * kUnit;  // a's row q = 0
      TIMER_START(t_x);
      if (a.a_in) {
        // lrelu(h) of rows u0 + q as the data kernel wrote it (E > 9)
#pragma unroll
        for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int u = u0 + l.row + 8 * half;
            const int c = c0 + 8 * nt + 2 * l.tig;
            float2 v = make_float2(0.f, 0.f);
            if (u < h.T && c < h.cc) {
              v = __ldg(reinterpret_cast<const float2*>(a.a_in + ((size_t)b * h.T + u) * n0 +
                                                        (size_t)i * h.cc + c));
            }
            acc[nt * 4 + 2 * half] = v.x;
            acc[nt * 4 + 2 * half + 1] = v.y;
          }
        }
      }
      // else h for rows u0 + q as the data kernel's h_pass takes it: slice by
      // slice, X.lo Wh.hi, X.hi Wh.lo, X.hi Wh.hi
      if (!a.a_in) {
        zero(acc);
        if (held < 0 || (a.h_image && b != held)) fetch(b);
        held = b;
        TIMER_START(t_xf);
        XFrag x[kWhChunk];
#pragma unroll
        for (int ss = 0; ss < kWhChunk; ++ss) {
          if (ss < h.nkh) {
            x[ss] = x_frag(h, b, u0, l, ss);
            fence_regs(x[ss].hi);
            fence_regs(x[ss].lo);
          }
        }
        TIMER_ADD(tw[0], t_xf);
        TIMER_START(t_h);
        wgmma_fence();
#pragma unroll
        for (int ss = 0; ss < kWhChunk; ++ss) {
          if (ss < h.nkh) {
            const uint32_t base = whb + ss * 2 * kHItem;
            tf32x3::wgmma_rs_n136(acc, x[ss].lo, desc(base, 128, 256), 1);
            tf32x3::wgmma_rs_n136(acc, x[ss].hi, desc(base + kHItem, 128, 256), 1);
            tf32x3::wgmma_rs_n136(acc, x[ss].hi, desc(base, 128, 256), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        TIMER_ADD(tw[1], t_h);
      } else {
        TIMER_ADD(tw[0], t_x);
      }
      // a = lrelu(h), zero past T and Cc, split, into the slot's K-major image
      const int slot = n & 1;
      unsigned char* as = aslots + slot * kASlot;
      TIMER_START(t_ae);
      mbar_wait(&a_empty[slot], (uint32_t)(((n >> 1) & 1) ^ 1));
      TIMER_ADD(tw[3], t_ae);
      TIMER_START(t_s);
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const bool row_ok = u0 + q < h.T;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = acc[nt * 4 + 2 * half + e];
            const int cl = 2 * l.tig + e;
            const float v = !(row_ok && c0 + 8 * nt + cl < h.cc) ? 0.f
                            : a.a_in || x >= 0.f                 ? x
                                                                 : kSlope * x;
            uint32_t hi, lo;
            split(v, hi, lo);
            const int off = nt * kAGroup + (q >> 2) * 128 + cl * 16 + (q & 3) * 4;
            *reinterpret_cast<uint32_t*>(as + off) = hi;
            *reinterpret_cast<uint32_t*>(as + kAImg + off) = lo;
          }
        }
      }
      fence_proxy_async();
      release(&a_full[slot]);
      TIMER_ADD(tw[4], t_s);
      if (l.wt == 0 && k + kW1Ahead < k_end) ask_g(k + kW1Ahead, n + kW1Ahead);
    }
#ifdef COND_CHAIN_TIMERS
    if (l.wt == 0) {
      for (int x = 0; x < 6; ++x) atomicAdd(&g_timers[kW1Timers + x], (unsigned long long)tw[x]);
      atomicAdd(&g_timers[kW1Timers + 6], (unsigned long long)(clock64() - t_all));
      atomicAdd(&g_timers[kW1Timers + 7], 1ull);
    }
#endif
    return;
  }
  if (wg == 1) {
    w1_products<OT, 72>(a, l, aslots, gring, g_full, g_empty, a_full, a_empty, i, c0, o0, 0,
                        k_begin, k_end);
  } else {
    w1_products<OT, 64>(a, l, aslots, gring, g_full, g_empty, a_full, a_empty, i, c0, o0, 72,
                        k_begin, k_end);
  }
}

// -- (d): past E = 9, dW0, dhbias and the edges as X^T dh
//
// k2_xdh_kernel's shared memory: a ring of kXStages stages of 64 rows x 128
// columns of dh (16 TMA boxes of 8 columns, each its 64 rows of 32 bytes);
// two slots of the step's X image (hi, then lo, each 4 groups of 8 columns
// x 64 rows, K-major); the barriers. Two CTAs an SM: ptxas serializes its
// wgmma there for want of registers (C7512), and still the kernel runs 1.4x
// faster than at one CTA an SM with a ring of 4 stages, which has no C7512.
constexpr int kXStages = 2;
constexpr int kXRows = 64;                      // rows a step (the products' K)
constexpr int kXStage = 16 * kDhBox;            // 32768: 128 columns, 64 a warpgroup
constexpr size_t kXSmem = (size_t)kXStages * kXStage + 4 * (size_t)kXImg + 16 * kXStages + 1024;
static_assert(2 * kXSmem <= kSmemMax + 1024, "k2_xdh_kernel: two CTAs an SM");

struct XArgs {
  HArgs h;
  float* pw0;            // (B parts, K, n*Cc): X^T dh per part of a batch row
  int parts, prows, kx;  // parts a batch row, rows a part (a multiple of 64), K = 3E + 3
  CUtensorMap dh_map;    // the dh scratch as (c: n Cc, 1, t: T, b: B), box (8, 1, 64, 1)
};

__global__ void __launch_bounds__(kThreads, 2) k2_xdh_kernel(const __grid_constant__ XArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* xs = ring + kXStages * kXStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + 4 * kXImg);
  uint64_t* empty = full + kXStages;

  const HArgs& h = a.h;
  const int col0 = blockIdx.x * 128;
  const int sp = blockIdx.y;  // (batch row, part)
  const int b = sp / a.parts;
  const int r0 = (sp - b * a.parts) * a.prows;
  const int r1 = min(h.T, r0 + a.prows);
  const int nsteps = (r1 - r0 + kXRows - 1) / kXRows;
  const int k0 = blockIdx.z * kXdhN;
  const int warp = warp_index();

  if (threadIdx.x == 0) {
    for (int k = 0; k < kXStages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    if (threadIdx.x == 256) {
      prefetch_map(&a.dh_map);
      for (int n = 0; n < nsteps; ++n) {
        const int st = slot_of<kXStages>(n);
        unsigned char* dst = ring + st * kXStage;
        mbar_wait(&empty[st], parity_of<kXStages>(n) ^ 1);
        mbar_arrive_expect_tx(&full[st], kXStage);
        for (int q = 0; q < 16; ++q) {
          tma_load_4d(dst + q * kDhBox, &a.dh_map, &full[st], col0 + 8 * q, 0, r0 + kXRows * n, b);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const Lane l;
  const int n0 = h.n * h.cc;
  // X[t0 + r][k0 + kk], zero past the part's rows, split, into slot `slot`:
  // thread ct builds column kk = ct % 32 of rows 4 (idx / 32) .. + 3 for
  // idx = ct and ct + 256, 16 bytes each of hi and lo. Its column is x_at's
  // for every row: exc's column e of tap j (src, from row j - 1 on), the
  // ones, an edge row (-1 at row `edge`) or zeros
  const int ct = threadIdx.x;
  const int kk = ct & 31, kx = k0 + kk;
  const int tap = kx < 3 * h.E ? (kx >= h.E) + (kx >= 2 * h.E) : -1;
  const float* src = h.exc + (size_t)b * h.T * h.E + (tap >= 0 ? kx - tap * h.E : 0);
  const float ones = kx == 3 * h.E ? 1.f : 0.f;
  const int edge = kx == 3 * h.E + 1 ? 0 : kx == 3 * h.E + 2 ? h.T - 1 : -1;
  auto build = [&](int t0, int slot) {
    unsigned char* dst = xs + slot * 2 * kXImg;
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      const int tg = (ct >> 5) + 8 * z;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int u = t0 + 4 * tg + x;
        const int t = u + tap - 1;
        float v = u == edge ? -1.f : ones;
        if (tap >= 0) v = t >= 0 && t < h.T ? __ldg(src + (size_t)t * h.E) : 0.f;
        split(u < r1 ? v : 0.f, hi[x], lo[x]);
      }
      const int off = (kk >> 3) * kXGroup + tg * 128 + (kk & 7) * 16;
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + kXImg + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };
  // D^T[c][k] = sum_t dh[t][c] X[t][k]: this thread's A element (m, k) of a
  // step's k-slice kk is dh[8 kk + k][col0 + 64 wg + m], in box 8 wg + m / 8
  const int fo = (8 * wg + (l.row >> 3)) * (kDhBox / 4) + l.tig * 8 + (l.row & 7);
  // the accumulators take one step, then are added into tot in f32 (a long
  // run of wgmma's accumulation drifts: k2_w1_kernel)
  float acc[kXdhN / 2], tot[kXdhN / 2];
  zero(tot);
  build(r0, 0);
  for (int n = 0; n < nsteps; ++n) {
    fence_proxy_async();
    bar_sync(1, 256);  // the step's X in place; every warp done with the last step's
    const int st = slot_of<kXStages>(n);
    mbar_wait(&full[st], parity_of<kXStages>(n));
    const float* ds = reinterpret_cast<const float*>(ring + st * kXStage) + fo;
    XFrag f[kXRows / 8];
#pragma unroll
    for (int kk = 0; kk < kXRows / 8; ++kk) {
      const float* d0 = ds + 64 * kk;
      split(d0[0], f[kk].hi[0], f[kk].lo[0]);
      split(d0[kDhBox / 4], f[kk].hi[1], f[kk].lo[1]);
      split(d0[32], f[kk].hi[2], f[kk].lo[2]);
      split(d0[kDhBox / 4 + 32], f[kk].hi[3], f[kk].lo[3]);
      fence_regs(f[kk].hi);
      fence_regs(f[kk].lo);
    }
    release(&empty[st]);  // the stage is in registers
    const uint32_t xb = smem_u32(xs + (n & 1) * 2 * kXImg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kXRows / 8; ++kk) {
      tf32x3::wgmma_rs_n32(acc, f[kk].lo, desc(xb + 256 * kk, 128, kXGroup), kk > 0);
      tf32x3::wgmma_rs_n32(acc, f[kk].hi, desc(xb + kXImg + 256 * kk, 128, kXGroup), 1);
      tf32x3::wgmma_rs_n32(acc, f[kk].hi, desc(xb + 256 * kk, 128, kXGroup), 1);
    }
    wgmma_commit();
    if (n + 1 < nsteps) build(r0 + kXRows * (n + 1), (n + 1) & 1);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int v = 0; v < kXdhN / 2; ++v) tot[v] += acc[v];
  }
#pragma unroll
  for (int v = 0; v < kXdhN / 2; ++v) {
    const int c = col0 + 64 * wg + l.row + 8 * ((v >> 1) & 1);
    const int k = k0 + 8 * (v >> 2) + 2 * l.tig + (v & 1);
    if (k < a.kx && c < n0) a.pw0[((size_t)sp * a.kx + k) * n0 + c] = tot[v];
  }
}

// -- (e): the reduce
//
// One job of k2_reduce_kernel: out[o*len + k] = sum_{s < S} part[o*ostride +
// s*sstride + k], s in order, for o < outer, k < len.
struct ReduceJob {
  const float* part;
  float* out;
  long long len, sstride, ostride, first;  // first: its first element in the launch
  int outer, S;
};
constexpr int kMaxJobs = 7;
struct ReduceArgs {
  ReduceJob job[kMaxJobs];
  int n;
  long long total;
};

__global__ void k2_reduce_kernel(const __grid_constant__ ReduceArgs r) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= r.total) return;
  int j = 0;
  while (j + 1 < r.n && x >= r.job[j + 1].first) ++j;
  const ReduceJob& jb = r.job[j];
  const long long e = x - jb.first;
  const long long o = e / jb.len;
  const long long k = e - o * jb.len;
  const float* p = jb.part + o * jb.ostride + k;
  // in order, eight loads in flight at a time
  float acc = 0.f;
  int s = 0;
  for (; s + 8 <= jb.S; s += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = p[(long long)(s + u) * jb.sstride];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; s < jb.S; ++s) acc += p[(long long)s * jb.sstride];
  jb.out[o * jb.len + k] = acc;
}

// the job of an (outer, len) sum of partials S apart at `part`
void add_job(ReduceArgs& r, const float* part, float* out, long long len, int outer, int S,
             long long sstride, long long ostride) {
  ReduceJob& j = r.job[r.n++];
  j.part = part;
  j.out = out;
  j.len = len;
  j.outer = outer;
  j.S = S;
  j.sstride = sstride;
  j.ostride = ostride;
  j.first = r.total;
  r.total += len * outer;
}

// Everything the launch needs, from the shapes alone; ok = false for shapes
// the kernels do not take. Offsets are in floats of the workspace, each on a
// 256-byte boundary.
struct Plan {
  bool ok;
  bool narrow;                              // E <= 9: X^T dh in (b); else (b) writes the
                                            // dh and lrelu(h) scratches, for (d) and (c)
  int ntiles, no, ne, nimg, run, nruns;     // (a), (b): runs of `run` tiles a batch row
  int ot, notiles, nsub, units, chunk, wrun, s1, runs;  // (c)
  int kx, xcols, xks, parts, prows, s0;     // (d), and X^T dh's partials: parts a batch row
  size_t h_image;                           // bytes
  size_t off_dh, off_pb1, off_pw1, off_pw0, off_imh, off_imw1, off_imw0, off_a, off_dx, total;
};

Plan make_plan(int B, int T, int E, int n, int cc, int two_c, bool per_row) {
  Plan p{};
  p.ok = false;
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 4 || (long long)B * (T + 1) > (1LL << 30) ||
      (long long)n * passes(cc) > 65535) {
    return p;
  }
  // (b) takes X^T dh where Wh's image fits one fetch of (c), K = 3E + 3 <= 32
  // (the decoder's E = 8); past that (c) would stream that image once per
  // unit and output tile, so (b) writes lrelu(h) for it, and dh for (d)
  p.narrow = h_slices(E) <= kWhChunk;
  p.ntiles = (T + kTile - 1) / kTile;
  p.no = (two_c + 7) / 8;
  p.ne = (E + 7) / 8;
  p.nimg = per_row ? B : 1;
  p.h_image = h_image_bytes(n, cc, E);
  const int npass = passes(cc);
  // (b): a CTA per (run of tiles, batch row, block and pass); runs of at
  // most kRunTiles tiles, as long as the CTAs' waves on the card take least:
  // a wave of runs of r tiles counted as r + 1/4 tiles (a CTA's start and its
  // partial), the longest run first where two take as long
  const long long per_run = (long long)B * n * npass;
  p.run = std::min(kRunTiles, p.ntiles);
  long long best = -1;
  for (int run = std::min(kRunTiles, p.ntiles); run >= 1; --run) {
    const long long ctas = per_run * ((p.ntiles + run - 1) / run);
    const long long cost = (ctas + kSmCount - 1) / kSmCount * (4 * run + 1);
    if (best < 0 || cost < best) {
      best = cost;
      p.run = run;
    }
  }
  p.nruns = (p.ntiles + p.run - 1) / p.run;
  // (c): (block, pass, OT output channels) tiles times chunks of units, one wave
  p.ot = two_c <= 32 ? 32 : 64;
  p.notiles = (two_c + p.ot - 1) / p.ot;
  p.nsub = (T + kUnit - 1) / kUnit;
  p.units = B * p.nsub;
  const long long tiles = (long long)n * npass * p.notiles;
  const int s1 = (int)std::min<long long>(std::max<long long>(1, kSmCount / tiles), p.units);
  const int chunk = (p.units + s1 - 1) / s1;
  const int nwruns = (chunk + kW1Run - 1) / kW1Run;  // a chunk is nwruns runs of at most kW1Run
  p.wrun = (chunk + nwruns - 1) / nwruns;
  p.chunk = p.wrun * nwruns;
  p.s1 = (p.units + p.chunk - 1) / p.chunk;
  p.runs = (p.units + p.wrun - 1) / p.wrun;
  p.kx = 3 * E + 3;
  if (p.narrow) {
    // X^T dh in (b): a partial per (batch row, run)
    p.parts = p.nruns;
  } else {
    // (d): (batch row, part) chunks times (128 columns of dh, 32 columns of
    // X) tiles, at least four waves of two CTAs an SM, so that the last
    // wave's idle SMs cost little
    p.xcols = (int)((n * cc + 127) / 128);
    p.xks = (p.kx + kXdhN - 1) / kXdhN;
    const long long per_b = (long long)B * p.xcols * p.xks;
    const int parts = (int)std::min<long long>(
        std::max<long long>(1, (8 * kSmCount + per_b - 1) / per_b), 65535 / B);
    p.prows = ((T + parts - 1) / parts + kXRows - 1) / kXRows * kXRows;
    p.parts = (T + p.prows - 1) / p.prows;
  }
  p.s0 = B * p.parts;
  auto up = [](size_t x) { return (x + 63) / 64 * 64; };
  const size_t R = (size_t)B * T, n0 = (size_t)n * cc, n2 = (size_t)n * two_c;
  p.off_dh = 0;
  p.off_pb1 = up(p.narrow ? 0 : R * n0);
  p.off_pw1 = up(p.off_pb1 + (size_t)B * p.ntiles * n2);
  p.off_pw0 = up(p.off_pw1 + (size_t)p.runs * 3 * cc * n2);
  p.off_imh = up(p.off_pw0 + (size_t)p.s0 * p.kx * n0);
  p.off_imw1 = up(p.off_imh + p.nimg * p.h_image / 4);
  p.off_imw0 = up(p.off_imw1 + (size_t)n * npass * p.no * kW1Item / 4);
  p.off_a = up(p.off_imw0 + (size_t)n * npass * p.ne * kW0Item / 4);
  // dexc: one part a block and pass, which (e) sums in order
  p.off_dx = up(p.off_a + (p.narrow ? 0 : R * n0));
  p.total = p.off_dx + ((size_t)n * npass > 1 ? (size_t)n * npass * R * E : 0);
  p.ok = true;
  return p;
}

// Device time of each of a call's launches, for measurement (smoke phase 8):
// while on, a call records an event before its first launch and after each
// one, on its stream
bool g_timed = false;
cudaEvent_t g_marks[6];
int g_launched = 0;  // the last timed call's launches

}  // namespace

// Times the kernels of the calls that follow (on != 0) or stops (0); the
// events are made at the first call that turns it on.
extern "C" int cond_chain_bwd_time_kernels(int on) {
  if (on && g_marks[0] == nullptr) {
    for (cudaEvent_t& e : g_marks) {
      const cudaError_t err = cudaEventCreate(&e);
      if (err != cudaSuccess) return (int)err;
    }
  }
  g_timed = on != 0;
  return 0;
}

#ifdef COND_CHAIN_TIMERS
// The diagnostic build's cycle sums since the last reset (kTimers of them:
// the data kernel's phases, see g_timers) into out; then zero them where
// `reset`.
extern "C" int cond_chain_bwd_timers(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_timers, sizeof(g_timers));
  if (e == cudaSuccess && reset) {
    const unsigned long long zeros[kTimers] = {};
    e = cudaMemcpyToSymbol(g_timers, zeros, sizeof(zeros));
  }
  return (int)e;
}
#endif

// ms[0..]: the last timed call's k2_images_kernel, k2_data_kernel,
// k2_w1_kernel, past E = 9 k2_xdh_kernel, and k2_reduce_kernel (four
// launches at E <= 9, five past), each from the end of the launch before it
// (synchronize first)
extern "C" int cond_chain_bwd_kernel_ms(float* ms) {
  for (int k = 0; k < g_launched; ++k) {
    const cudaError_t err = cudaEventElapsedTime(&ms[k], g_marks[k], g_marks[k + 1]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The launches of the last call timed (cond_chain_bwd_time_kernels): four at
// E <= 9, five past it
extern "C" int cond_chain_bwd_launched() { return g_launched; }

// Floats of device scratch cond_chain_bwd_f32 needs for these shapes (0 for
// shapes the kernels do not take); per_row: hbias or the edges differ per
// batch row.
extern "C" long long cond_chain_bwd_workspace(int B, int T, int E, int n, int cc, int two_c,
                                              int per_row) {
  const Plan p = make_plan(B, T, E, n, cc, two_c, per_row != 0);
  return p.ok ? (long long)p.total : 0;
}

// Launches K2's kernels on `stream` and returns the first CUDA error (0 on
// success); shapes the kernels do not take, too little workspace or a tensor
// map cuTensorMapEncodeTiled refuses give cudaErrorInvalidValue. w1 is in
// its own (3, Cc, n*2C) layout; g must be 16-byte aligned. dhbias is
// (B, n*Cc), or (n*Cc) when hbias_bstride is 0; dedge0/dedge_t are written
// when edge0 is given.
extern "C" int cond_chain_bwd_f32(const float* exc, const float* w0, const float* hbias,
                                  long long hbias_bstride, const float* edge0,
                                  const float* edge_t, const float* w1, const float* g,
                                  float* dexc, float* dw0, float* dhbias, float* dedge0,
                                  float* dedge_t, float* dw1, float* db1, float* ws,
                                  long long ws_floats, int B, int T, int E, int n, int cc,
                                  int two_c, void* stream_ptr) {
  const bool per_row = hbias_bstride != 0 || edge0 != nullptr;
  const Plan p = make_plan(B, T, E, n, cc, two_c, per_row);
  if (!p.ok || ws_floats < (long long)p.total || (edge0 == nullptr) != (dedge0 == nullptr) ||
      (uintptr_t)g % 16 || (uintptr_t)ws % 256) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n0 = n * cc;
  const int n2 = n * two_c;
  const int nparts = n * passes(cc);  // dexc's parts, one a block and pass
  float* pb1 = ws + p.off_pb1;
  float* pw1 = ws + p.off_pw1;
  float* pw0 = ws + p.off_pw0;
  unsigned char* img_h = reinterpret_cast<unsigned char*>(ws + p.off_imh);
  unsigned char* img_w1 = reinterpret_cast<unsigned char*>(ws + p.off_imw1);
  unsigned char* img_w0 = reinterpret_cast<unsigned char*>(ws + p.off_imw0);
  const HArgs h{exc, T, E, n, cc, passes(cc), h_slices(E)};
  const long long h_image = per_row ? (long long)p.h_image : 0;

  DataArgs d;
  d.h = h;
  d.img_h = img_h;
  d.h_image = h_image;
  d.img_w1 = img_w1;
  d.img_w0 = img_w0;
  d.dh_out = p.narrow ? nullptr : ws + p.off_dh;
  d.a_out = p.narrow ? nullptr : ws + p.off_a;
  d.dexc = nparts > 1 ? ws + p.off_dx : dexc;
  d.pb1 = pb1;
  d.pw0 = pw0;
  d.two_c = two_c;
  d.no = p.no;
  d.ne = p.ne;
  d.ntiles = p.ntiles;
  d.run = p.run;
  d.nruns = p.nruns;
  d.kx = p.kx;
  W1Args w;
  w.h = h;
  w.img_h = img_h;
  w.h_image = h_image;
  w.a_in = d.a_out;
  w.pw1 = pw1;
  w.two_c = two_c;
  w.notiles = p.notiles;
  w.nsub = p.nsub;
  w.units = p.units;
  w.chunk = p.chunk;
  w.run = p.wrun;
  XArgs x;
  x.h = h;
  x.pw0 = pw0;
  x.parts = p.parts;
  x.prows = p.prows;
  x.kx = p.kx;
  const cuuint64_t o = (cuuint64_t)two_c;
  const cuuint64_t g_dims[4] = {o, (cuuint64_t)n, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t g_strides[3] = {o * 4, o * 4 * n, o * 4 * n * T};
  const cuuint32_t g_box[4] = {4, 1, (cuuint32_t)kGBox, 1};
  const cuuint32_t g_box_w1[4] = {8, 1, (cuuint32_t)kGUnitRows, 1};
  const cuuint64_t ld = (cuuint64_t)n0 * 4;
  const cuuint64_t dh_dims[4] = {(cuuint64_t)n0, 1, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t dh_strides[3] = {ld, ld, ld * T};
  const cuuint32_t dh_box[4] = {8, 1, (cuuint32_t)kXRows, 1};
  if (!make_map_f32(&d.g_map, g, 4, g_dims, g_strides, g_box) ||
      !make_map_f32(&w.g_map, g, 4, g_dims, g_strides, g_box_w1) ||
      (!p.narrow && !make_map_f32(&x.dh_map, d.dh_out, 4, dh_dims, dh_strides, dh_box))) {
    return (int)cudaErrorInvalidValue;
  }
  const ImageArgs im{WhArgs{w0, hbias, hbias_bstride, edge0, edge_t, E, n, cc}, w1, img_h, img_w1,
                     img_w0, p.nimg, two_c, p.no, p.ne};

  int launched = 0;
  auto mark = [&]() {
    if (g_timed) cudaEventRecord(g_marks[launched], stream);
  };
  mark();
  k2_images_kernel<<<264, 256, 0, stream>>>(im);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ++launched;
  mark();
  const dim3 dgrid((unsigned)p.nruns, (unsigned)B, (unsigned)nparts);
  e = p.narrow ? launch_kernel(k2_data_kernel<true>, dgrid, kThreads, DataSmem<true>::kBytes, d,
                               stream)
               : launch_kernel(k2_data_kernel<false>, dgrid, kThreads, DataSmem<false>::kBytes, d,
                               stream);
  if (e != cudaSuccess) return (int)e;
  ++launched;
  mark();
  const dim3 w1_grid((unsigned)(n * passes(cc) * p.notiles), (unsigned)p.s1);
  e = p.ot == 32 ? launch_kernel(k2_w1_kernel<32>, w1_grid, kW1Threads, kW1Smem, w, stream)
                 : launch_kernel(k2_w1_kernel<64>, w1_grid, kW1Threads, kW1Smem, w, stream);
  if (e != cudaSuccess) return (int)e;
  ++launched;
  mark();
  if (!p.narrow) {
    if ((e = launch_kernel(k2_xdh_kernel, dim3((unsigned)p.xcols, (unsigned)p.s0, (unsigned)p.xks),
                           kThreads, kXSmem, x, stream)) != cudaSuccess) return (int)e;
    ++launched;
    mark();
  }

  // dexc over the blocks and passes; dW1 over the runs of units; db1 over
  // every (batch row, time tile); dW0 over every (batch row, part); dhbias,
  // the edges over a batch row's parts (dhbias over all of them when hbias
  // is shared)
  ReduceArgs r{};
  const long long xs = (long long)p.kx * n0;
  if (nparts > 1) add_job(r, d.dexc, dexc, (long long)B * T * E, 1, nparts,
                          (long long)B * T * E, 0);
  add_job(r, pw1, dw1, 3LL * cc * n2, 1, p.runs, 3LL * cc * n2, 0);
  add_job(r, pb1, db1, n2, 1, B * p.ntiles, n2, 0);
  add_job(r, pw0, dw0, 3LL * E * n0, 1, p.s0, xs, 0);
  if (hbias_bstride) {
    add_job(r, pw0 + 3LL * E * n0, dhbias, n0, B, p.parts, xs, p.parts * xs);
  } else {
    add_job(r, pw0 + 3LL * E * n0, dhbias, n0, 1, p.s0, xs, 0);
  }
  if (edge0) {
    add_job(r, pw0 + (3LL * E + 1) * n0, dedge0, n0, B, p.parts, xs, p.parts * xs);
    add_job(r, pw0 + (3LL * E + 2) * n0, dedge_t, n0, B, p.parts, xs, p.parts * xs);
  }
  k2_reduce_kernel<<<(unsigned)((r.total + 255) / 256), 256, 0, stream>>>(r);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ++launched;
  mark();
  if (g_timed) g_launched = launched;
  return 0;
}
