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
//  (c) k2_w1_kernel, dW1 with no scratch of lrelu(h). The items are (tile,
//      unit): a tile is (block i, pass p, OT = 64 output channels o, 32
//      where 2C <= 32), a unit a batch row's 64 rows s0 .. s0 + 63 of
//      lrelu(h). The CTAs walk the items tile-major in equal runs, one wave
//      of the card's 132 SMs, so that a CTA may end one tile's units and
//      start the next's. Three warpgroups; per item n:
//       - warpgroup m takes the products of 64 rows (tap, o) of the three
//         taps' OT channels stacked (at OT = 64 tap m's, so that no A
//         fragment is built twice; at OT = 32 warpgroups 0 and 1 take the 96
//         rows, the second with 32 rows of zeros: the M layout wastes 25%,
//         as any must where B, a's image, is one unit's of one block),
//         dW1_i[j][c][o] += sum_s g[s - j + 1][o] a[s][c] on m64n136k8: N =
//         the pass's 136 columns c, K = the unit's 64 rows in slices of 8. B
//         is a's image, K-major: element (c, s) at (c / 8) 2048 + (s / 4) 128
//         + (c % 8) 16 + (s % 4) 4 bytes. A is g^T from registers: each
//         thread loads its m16n8k8 A fragment (o = m, s = k) from the raw TMA
//         stage of g, the tap's shift being a shift of the rows it reads, and
//         splits it; the next slice's fragment built while the one before
//         runs (wgmma_wait<1>). The shift cannot go on a's side: one row is 4
//         bytes inside a core matrix, and descriptors move in 16-byte steps;
//         nor can g^T be an A descriptor: g arrives channels contiguous and
//         tf32 wgmma takes K-major operands only;
//       - then, behind its products (one wait for both), its third of item
//         n + 1's a: h of the unit's rows for 48 columns of the pass (40 in
//         the third) as (b) computes h (the same X, image of Wh, k-slices and
//         products in the same order: the same bits, so that the slope (b)
//         took and the a taken here never disagree), A = X by descriptor from
//         X's image, which the warpgroups write under their products from the
//         unit's exc rows (cp.async, a unit ahead); lrelu, the split, and a's
//         store into the other slot, a lane pair's two rows as 8 bytes;
//       - one barrier of the CTA; the first thread asks for the next unit's
//         g rows s0 - 1 .. s0 + 64 (TMA, zeros outside [0, T) and past 2C)
//         and, where it needs another, Wh's image. Past E = 9 (K = 3E + 3 >
//         32, Wh's image more than a slot) nothing is recomputed: a is the
//         scratch (b) wrote, its rows brought by TMA in Wh's place.
//      wgmma's accumulation drifts over long sums (about 2^-24 of the sum an
//      add: 1.3e-4 of max|dW1| over a chunk of 320 units), so the
//      accumulators take a run of at most 16 units of a segment (a tile's
//      units in one CTA), and each run is added, in order, to the sum of the
//      segment's runs before it, which the CTA keeps in a scratch of its own
//      (float4 a thread at fixed offsets); the segment's sum is its partial,
//      one slot per CTA a tile spans, the tile's last CTA zeroing the slots
//      after its own (at the step's largest call 16 slots of 470 KB, where a
//      partial a run made 280).
//      What the other designs did, on the card (the f32 step, k2_w1_kernel
//      per step; the design before, a recompute warpgroup beside two product
//      warpgroups split by N, a partial a run: 6.2-6.4 ms in the same
//      calls): one recompute warpgroup beside three product warpgroups split
//      by M (512 threads) 6.8 ms, the recompute pacing it; the warpgroups'
//      shares at different points of their products (so that one stores
//      while the others multiply) made ptxas serialize the wgmma (C7515) or
//      spill at every point tried, 6.4-9.5 ms; h issued under the last
//      k-slices, 412 bytes of spills, 5.2-5.4 ms; each run's sums added
//      into the partial in device memory, one dependent load a value, 3.6 ms
//      more; a base aligned through an integer cast, which makes every
//      shared access generic, 1.0 ms more; an item read by reference from
//      shared memory, reloaded after every shared store, 0.16 ms more;
//      h's widths a runtime branch, 0.15 ms more. With this kernel's fixes,
//      a recompute warpgroup of its own (512 threads at OT = 64, 128
//      registers) ran 4% slower (5% faster at OT = 32). At E = 8 exc's rows
//      are staged 16 bytes a copy and X's quads read 16 bytes at a time; the
//      4-byte copies and reads of other E at E = 8 too were 0.22 ms slower.
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
//      in one launch; in a job of few outputs, an output of more than 256
//      partials by a warp, each lane a run of them in order, the runs' sums
//      then added in order.
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
// kW1Timers on), summed over its warpgroups: X's image (its store and the
// copies of the next unit's exc rows), h (the waits on X and Wh, its
// products and their wait, which also retires the products before it), a's
// store (past E = 9 with the read of lrelu(h)), the waits on g_full, the
// products (A fragments, issue and the waits of the slices before), the
// wait after them, the run sums and partials, and the barrier; each
// warpgroup's whole. The normal build has none.
#ifdef COND_CHAIN_TIMERS
constexpr int kW1Timers = 12;
constexpr int kTimers = kW1Timers + 10;  // the data kernel: h, da, da's waits, dh, dexc,
                                         // X^T dh, dexc's store, whole, warpgroups,
                                         // producer waits, producer whole, producers;
                                         // k2_w1_kernel: 8 phases, whole, warpgroups
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
// groups of 8 columns c x 64 rows s); a ring of two stages of g (OT
// channels in boxes of 8, each 66 rows of 32 bytes in a 2176-byte slot);
// Wh's image where it is recomputed (up to 4 k-slices, hi and lo); X's
// image of the next unit (4 k-slices, hi and lo); two stages of exc's rows
// s0 - 1 .. s0 + 64 a unit's X is made from; a ring of four W1Items; the
// barriers.
constexpr int kW1Threads = 384;
constexpr int kUnit = 64;                            // a's rows a unit (dW1's K)
constexpr int kGUnitRows = kUnit + 2;                // g's rows a unit: s0 - 1 .. s0 + 64
constexpr int kW1GBox = 68 * 32;                     // 2176: 8 channels of them, 128-byte
                                                     // aligned (a TMA destination)
constexpr int kW1GStage = 8 * kW1GBox;               // 17408: 64 channels
constexpr int kW1Run = 16;                           // units a run at most (the accumulators' take)
constexpr int kAGroup = kUnit * 32;                  // 2048: 8 columns of a, every row (SBO)
constexpr int kAImg = (kPass / 8) * kAGroup;         // 34816: a, hi or lo
constexpr int kASlot = 2 * kAImg;
constexpr int kWhChunk = 4;                          // k-slices of Wh recomputed from
constexpr int kWhBytes = kWhChunk * 2 * kHItem;      // 34816
constexpr int kW1XSlice = kUnit * 32;                // 2048: a k-slice of X, 64 rows (A, K-major)
constexpr int kW1XImg = kWhChunk * kW1XSlice;        // 8192: X, hi or lo
constexpr int kW1Exc = 2432;                         // a stage of exc's rows: 66 x E <= 9 floats
constexpr int kW1XAt = 4;                            // the next unit's X built after this many
                                                     // k-slices of the products
constexpr int kW1HCols = 48;                         // h's columns a warpgroup recomputes (40
                                                     // in the third: 96 .. 135)
constexpr size_t kW1Smem = 2 * (size_t)kASlot + 2 * (size_t)kW1GStage + kWhBytes +
                           2 * (size_t)kW1XImg + 2 * kW1Exc + 4 * 32 + 8 * 4 + 1024;
static_assert(kW1Smem <= kSmemMax && kGUnitRows * 9 * 4 <= kW1Exc,
              "k2_w1_kernel's shared memory");

struct W1Args {
  HArgs h;
  const unsigned char* img_h;  // Wh's images, as the data kernel's
  long long h_image;           // bytes of one batch row's (0: one for every row)
  const float* a_in;           // lrelu(h) (B, T, n*Cc) from the data kernel, or null (recomputed)
  float* pw1;                  // (S, 3, Cc, n*2C): dW1 per segment of a tile's units
  float* w1_runs;              // (CTAs, 17, 384) x 4: each CTA's sum of a segment's runs
  int two_c, notiles, nsub, units;  // tiles of OT columns of g; units a tile = B nsub
  int per_cta, nslots;              // items (tile, unit) a CTA; S
  CUtensorMap g_map;           // g as (o: 2C, i: n, t: T, b: B), box (8, 1, 66, 1)
  CUtensorMap a_map;           // past E = 9: the a scratch as (c: n Cc, t: T, b: B), box (8, 64, 1)
};

// The CTAs walk the items (tile, unit), tile-major, per_cta each (a tile
// being (block i, pass p, OT output channels ot), a unit a batch row's 64
// rows s0 .. s0 + 63); a cursor over them, advanced without divisions
struct W1Item {
  int tau, k, b, s0, i, p, ot;
  int nwh;  // the images of Wh fetched up to this item's (its own included)
  __device__ __forceinline__ W1Item(const W1Args& a, int x) {
    tau = x / a.units;
    k = x - tau * a.units;
    b = k / a.nsub;
    s0 = (k - b * a.nsub) * kUnit;
    tile(a);
    nwh = 1;
  }
  __device__ __forceinline__ void tile(const W1Args& a) {
    const int ip = tau / a.notiles;
    ot = tau - ip * a.notiles;
    i = ip / a.h.npass;
    p = ip - i * a.h.npass;
  }
  // whether this item's h needs another image of Wh than item o's
  __device__ __forceinline__ bool new_wh(const W1Item& o, const W1Args& a) const {
    return i != o.i || p != o.p || (a.h_image && b != o.b);
  }
  __device__ __forceinline__ void next(const W1Args& a) {
    const W1Item o = *this;
    s0 += kUnit;
    if (s0 >= a.nsub * kUnit) {
      s0 = 0;
      ++b;
    }
    if (++k == a.units) {
      k = b = 0;
      ++tau;
      tile(a);
    }
    nwh += new_wh(o, a);
  }
};

// the CTA whose items start tile tau: the segment of tile tau CTA c takes
// writes the partial of slot c - w1_first_cta(tau)
__device__ __forceinline__ int w1_first_cta(const W1Args& a, int tau) {
  return (int)((long long)tau * a.units / a.per_cta);
}

// k2_w1_kernel's shared memory from its base (1024-byte aligned)
constexpr int kW1GRing = 2 * kASlot;                       // g, two stages
constexpr int kW1Wh = kW1GRing + 2 * kW1GStage;            // Wh's image
constexpr int kW1X = kW1Wh + kWhBytes;                     // X's image of the next unit
constexpr int kW1Stg = kW1X + 2 * kW1XImg;                 // exc's rows, two stages
constexpr int kW1Items = kW1Stg + 2 * kW1Exc;              // four items' W1Item
constexpr int kW1Bars = kW1Items + 4 * (int)sizeof(W1Item);  // g_full (2), x_full, w_full
static_assert(kW1Bars + 32 + 1024 <= (int)kW1Smem && sizeof(W1Item) == 32,
              "k2_w1_kernel's shared memory");

// exc's rows s0 - 1 .. s0 + 64 of batch row b (zeros outside [0, T)) into
// a stage at stg, element (r, e) at r E + e floats: each thread's cp.async
// copies of 4 bytes, waited on (cp.async.wait_all) by the thread before the
// barrier after which they are read
__device__ __forceinline__ void w1_exc_rows(const HArgs& h, int b, int s0, uint32_t stg) {
  const float* src = h.exc + (size_t)b * h.T * h.E;
  if (h.E == 8 && ((uintptr_t)h.exc & 15) == 0) {
    // the decoder's E: 16 bytes a copy, half a row
    const int x = threadIdx.x;
    const int t = s0 - 1 + (x >> 1);
    const bool in = t >= 0 && t < h.T;
    if (x < 2 * kGUnitRows) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(stg + 16 * x),
                   "l"(in ? src + (size_t)t * 8 + 4 * (x & 1) : src), "r"(in ? 16 : 0));
    }
    return;
  }
  for (int x = threadIdx.x; x < kGUnitRows * h.E; x += kW1Threads) {
    const int r = x / h.E;
    const int t = s0 - 1 + r;
    const bool in = t >= 0 && t < h.T;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(stg + 4 * x),
                 "l"(in ? src + (size_t)t * h.E + (x - r * h.E) : src), "r"(in ? 4 : 0));
  }
}

// X's image at xs from a unit's exc rows (X at the unit's rows, split): the
// thread's 16-byte quads x = thread + 384 z (< 512), row q = x % 64,
// k = 4 (x / 64) .. + 3; K-major (h's A by descriptor): element (q, k) at
// (k / 8) 2048 + (k % 8 / 4) 1024 + 16 q + (k % 4) 4 bytes, hi then lo
// kW1XImg on
__device__ __forceinline__ void w1_x_image(const HArgs& h, int s0, const float* stg,
                                           unsigned char* xs) {
#pragma unroll
  for (int z = 0; z < 2; ++z) {
    const int x = threadIdx.x + kW1Threads * z;
    if (x >= 512) break;
    const int q = x & 63, kq = x >> 6;
    float v[4];
    if (h.E == 8) {
      // the decoder's E: quad kq < 6 is 4 columns of exc's row q + kq / 2
      // (tap kq / 2), 16 bytes at q E + 4 kq floats; quad 6 the ones and the
      // edges, quad 7 zeros
      if (kq < 6) {
        const float4 r = *reinterpret_cast<const float4*>(stg + q * 8 + 4 * kq);
        v[0] = r.x;
        v[1] = r.y;
        v[2] = r.z;
        v[3] = r.w;
      } else {
        v[0] = kq == 6 ? 1.f : 0.f;
        v[1] = kq == 6 && s0 + q == 0 ? -1.f : 0.f;
        v[2] = kq == 6 && s0 + q == h.T - 1 ? -1.f : 0.f;
        v[3] = 0.f;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kq + e;
        // column k < 3E: tap j = k / E's column k - j E of row q + j, at q E + k
        v[e] = k < 3 * h.E        ? stg[q * h.E + k]
               : k == 3 * h.E     ? 1.f
               : k == 3 * h.E + 1 ? (s0 + q == 0 ? -1.f : 0.f)
               : k == 3 * h.E + 2 ? (s0 + q == h.T - 1 ? -1.f : 0.f)
                                  : 0.f;
      }
    }
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) split(v[e], hi[e], lo[e]);
    const int off = (x >> 7) * kW1XSlice + ((x >> 6) & 1) * 1024 + q * 16;
    *reinterpret_cast<uint4*>(xs + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(xs + kW1XImg + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// Warpgroup c's share of a unit's a is the N columns of the pass from 48 c
// on. Where it is recomputed: h for the unit's rows s0 + q as the data
// kernel computes it (the same X, image of Wh, k-slices and m64nNk8
// products in the same order: the same bits, so that the slope (b) took and
// the a taken here never disagree; the first product overwrites the
// accumulators, which the data kernel's zeros before it leave as they are
// but for the sign of a zero), issued as one commit group once X's and Wh's
// images are in; not waited on
template <int N>
__device__ __forceinline__ void w1_h_issue(const W1Args& a, int col0, int m, int nwh,
                                           uint32_t xs, uint32_t whb, uint64_t* x_full,
                                           uint64_t* w_full, float (&acc)[N / 2]) {
  const HArgs& h = a.h;
  mbar_wait(x_full, (uint32_t)(m & 1));
  mbar_wait(w_full, (uint32_t)((nwh - 1) & 1));
  // slice by slice, X.lo Wh.hi, X.hi Wh.lo, X.hi Wh.hi; Wh's rows (the
  // pass's columns) from col0 on
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < kWhChunk; ++s) {
    if (s < h.nkh) {
      const uint64_t xh = desc(xs + s * kW1XSlice, 1024, 128);
      const uint64_t xl = desc(xs + kW1XImg + s * kW1XSlice, 1024, 128);
      const uint32_t base = whb + s * 2 * kHItem + (col0 / 8) * 256;
      const uint64_t wl = desc(base + kHItem, 128, 256), wh = desc(base, 128, 256);
      if constexpr (N == 48) {
        tf32x3::wgmma_ss_n48(acc, xl, wh, s > 0);
        tf32x3::wgmma_ss_n48(acc, xh, wl, 1);
        tf32x3::wgmma_ss_n48(acc, xh, wh, 1);
      } else {
        tf32x3::wgmma_ss_n40(acc, xl, wh, s > 0);
        tf32x3::wgmma_ss_n40(acc, xh, wl, 1);
        tf32x3::wgmma_ss_n40(acc, xh, wh, 1);
      }
    }
  }
  wgmma_commit();
}

// ... once every product of the warpgroup is done (wgmma_wait<0>): a =
// lrelu(h), zero past T and Cc, split, into the slot's K-major image at
// `as`: element (c, s) at (c / 8) 2048 + (s / 4) 128 + (c % 8) 16 + (s % 4) 4
// bytes, hi then lo kAImg on. Past E = 9 (acc unused) a is the data
// kernel's scratch, its bits by construction, as TMA brought the unit's rows
// to a_rows.
template <int N>
__device__ __forceinline__ void w1_a_store(const W1Args& a, const Lane& l, int col0,
                                           const W1Item u, const float (&acc)[N / 2],
                                           const unsigned char* a_rows, unsigned char* as) {
  const HArgs& h = a.h;
  // rows q and q ^ 1 are lanes 4 apart: the even row's lane keeps column cl
  // of both rows, the odd row's column cl + 1, one exchange; 8 bytes (two
  // rows, time contiguous) of hi and of lo a store
  const bool odd = l.row & 1;
  auto put = [&](int nt, int half, float2 x) {
    const float r = __shfl_xor_sync(0xffffffffu, odd ? x.x : x.y, 4);
    const float2 pair = odd ? make_float2(r, x.y) : make_float2(x.x, r);
    const int q = (l.row & ~1) + 8 * half;
    const int col = col0 + 8 * nt + 2 * l.tig + odd;
    uint32_t hi[2], lo[2];
    split(pair.x, hi[0], lo[0]);
    split(pair.y, hi[1], lo[1]);
    const int off = (col >> 3) * kAGroup + (q >> 2) * 128 + (col & 7) * 16 + (q & 3) * 4;
    *reinterpret_cast<uint2*>(as + off) = make_uint2(hi[0], hi[1]);
    *reinterpret_cast<uint2*>(as + kAImg + off) = make_uint2(lo[0], lo[1]);
  };
  if (a.a_in) {
    // past E = 9 lrelu(h) as TMA brought it: box cl / 8 of 64 rows x 8 columns
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = l.row + 8 * half;
        const int cl = col0 + 8 * nt + 2 * l.tig;
        const float2 x = *reinterpret_cast<const float2*>(a_rows + (cl >> 3) * 2048 + q * 32 +
                                                          (cl & 7) * 4);
        put(nt, half, u.s0 + q < h.T && u.p * kPass + cl < h.cc ? x : make_float2(0.f, 0.f));
      }
    }
  } else {
#pragma unroll
    for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = l.row + 8 * half;
        const int cl = col0 + 8 * nt + 2 * l.tig;
        const bool ok = u.s0 + q < h.T && u.p * kPass + cl < h.cc;
        const float x0 = acc[nt * 4 + 2 * half], x1 = acc[nt * 4 + 2 * half + 1];
        put(nt, half, make_float2(ok ? (x0 >= 0.f ? x0 : kSlope * x0) : 0.f,
                                  ok ? (x1 >= 0.f ? x1 : kSlope * x1) : 0.f));
      }
    }
  }
  fence_proxy_async();
}

// A warpgroup's whole share of item m's a (u), the N columns of the pass
// from col0 on, into slot m & 1 (slot 0 at smem): h issued and waited on
// (wgmma_wait<0>, which also retires any product issued before it), then
// a's store; past E = 9 a's rows read from the Wh region once TMA brought
// them (w_full's phase m)
template <int N>
__device__ __forceinline__ void w1_share_n(const W1Args& a, const Lane& l, int col0,
                                           const W1Item u, int m, uint32_t xs, uint32_t whb,
                                           unsigned char* smem, uint64_t* x_full,
                                           uint64_t* w_full, long long* tw) {
  float acc[N / 2];
  TIMER_START(t1);
  if (a.a_in == nullptr) {
    w1_h_issue<N>(a, col0, m, u.nwh, xs, whb, x_full, w_full, acc);
  } else {
    mbar_wait(w_full, (uint32_t)(m & 1));
  }
  wgmma_wait<0>();
  fence_regs(acc);
  TIMER_ADD(tw[1], t1);
  TIMER_START(t2);
  w1_a_store<N>(a, l, col0, u, acc, smem + kW1Wh, smem + (m & 1) * kASlot);
  TIMER_ADD(tw[2], t2);
}

// Warpgroup c's products of one k-slice kk of a unit: dW1 rows r = 64 c +
// (0 .. 63) of the three taps' OT channels stacked (tap j = r / OT, channel
// o = r % OT), all 136 columns, on m64n136k8. A is g^T from registers: the
// thread's m16n8k8 A fragment (o = m, s = k) loaded from the raw stage of g
// (its rows shifted by the tap: off, ok) and split; one commit group, and
// the one before it retired, so that its fragment may be built again
__device__ __forceinline__ void w1_slice(const float* gs, const int (&off)[2], const bool (&ok)[2],
                                         int kk, uint32_t abase, int keep, float (&acc)[68],
                                         XFrag& f) {
  const float* p0 = gs + off[0] + 64 * kk;
  const float* p1 = gs + off[1] + 64 * kk;
  split(ok[0] ? p0[0] : 0.f, f.hi[0], f.lo[0]);
  split(ok[1] ? p1[0] : 0.f, f.hi[1], f.lo[1]);
  split(ok[0] ? p0[32] : 0.f, f.hi[2], f.lo[2]);
  split(ok[1] ? p1[32] : 0.f, f.hi[3], f.lo[3]);
  fence_regs(f.hi);
  fence_regs(f.lo);
  const uint32_t bh = abase + 256 * kk;
  wgmma_fence();
  tf32x3::wgmma_rs_n136(acc, f.lo, desc(bh, 128, kAGroup), keep);
  tf32x3::wgmma_rs_n136(acc, f.hi, desc(bh + kAImg, 128, kAGroup), 1);
  tf32x3::wgmma_rs_n136(acc, f.hi, desc(bh, 128, kAGroup), 1);
  wgmma_commit();
  wgmma_wait<1>();
}

// The end of a run of product warpgroup c's accumulators (item u, seg units
// of the segment so far): the run's sums added to the sum of the segment's
// runs before it, which the CTA keeps in its own scratch (17 chunks of 4 a
// thread, each chunk of the CTA's threads contiguous: float4 loads and
// stores at fixed offsets, four chunks in flight), and that sum stored
// there; at the segment's end copied from there into its partial, slot sx,
// and at the tile's end the tile's last CTA zeroes the slots after its own
template <int OT>
__device__ __forceinline__ void w1_run_end(const W1Args& a, const Lane& l, int c,
                                           const W1Item u, float (&acc)[68], int seg, int sx,
                                           bool seg_end, bool tile_end) {
  const HArgs& h = a.h;
  float4* run_sum = reinterpret_cast<float4*>(a.w1_runs) +
                    (size_t)blockIdx.x * (kPass / 8) * kW1Threads + threadIdx.x;
  if (seg > kW1Run) {
#pragma unroll
    for (int k = 0; k < kPass / 8; ++k) {
      const float4 v = run_sum[k * kW1Threads];
      acc[4 * k] += v.x;
      acc[4 * k + 1] += v.y;
      acc[4 * k + 2] += v.z;
      acc[4 * k + 3] += v.w;
      if (k % 4 == 3) asm volatile("" ::: "memory");
    }
  }
#pragma unroll
  for (int k = 0; k < kPass / 8; ++k) {
    run_sum[k * kW1Threads] =
        make_float4(acc[4 * k], acc[4 * k + 1], acc[4 * k + 2], acc[4 * k + 3]);
  }
  if (!seg_end) return;
  // chunk nt holds the columns c0 + 8 nt + 2 tig + e of the rows r = 64 c +
  // l.row + 8 half (tap r / OT, o = r % OT), as (half, e) = (0, 0), (0, 1),
  // (1, 0), (1, 1)
  const size_t n2 = (size_t)h.n * a.two_c;
  const int c0 = u.p * kPass;
  const int cend = min(h.cc - c0, kPass);
  const int s_end = tile_end ? a.nslots : sx + 1;
  const size_t slot = (size_t)3 * h.cc * n2;
#pragma unroll 1
  for (int nt = 0; nt < kPass / 8; ++nt) {
    const float4 v4 = run_sum[nt * kW1Threads];
    const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int r = 64 * c + l.row + 8 * (x >> 1);
      const int o = u.ot * OT + r % OT;
      const int cx = 8 * nt + 2 * l.tig + (x & 1);
      if (r >= 3 * OT || o >= a.two_c || cx >= cend) continue;
      float* part = a.pw1 + (((size_t)sx * 3 + r / OT) * h.cc + c0 + cx) * n2 +
                    (size_t)u.i * a.two_c + o;
      for (int s = sx; s < s_end; ++s, part += slot) *part = s == sx ? v[x] : 0.f;
    }
  }
}

// k2_w1_kernel: per item n of the CTA, every warpgroup c takes the products
// of tap c's rows (w1_slice; at OT = 32 warpgroups 0 and 1 take the 96
// rows, the second with 32 rows of zeros, and warpgroup 2 none), writing
// its quads of item n + 1's X into X's image under them (from the item's
// exc rows, which cp.async copied under item n - 1), and then, behind them,
// its share of item n + 1's a (w1_share_n: h issued after the products, one
// wait for both, a's store into the other slot). One barrier of the CTA
// before each item: a of item n whole, every product of item n - 1 and
// every h of item n done (slot, stage, X's and Wh's images free). After it
// the first thread writes item n + 3's W1Item into the ring of four (every
// thread reads an item's there: no cursor is held in registers), asks for
// item n + 1's g rows s0 - 1 .. s0 + 64 (TMA, boxes of 8 channels, zeros
// outside [0, T) and past 2C) and, where item n + 1 needs another image of
// Wh than item n, for it (past E = 9 for its rows of the a scratch); the
// threads copy item n + 2's exc rows. The accumulators take a run of at
// most kW1Run units of a segment, which is then added, in order, into the
// segment's f32 partial (w1_run_end).
template <int OT>
__global__ void __launch_bounds__(kW1Threads, 1) k2_w1_kernel(const __grid_constant__ W1Args a) {
  constexpr int kNch = (3 * OT + 63) / 64;  // warpgroups with products
  // the base 1024-byte aligned by an offset into the array, so that the
  // compiler knows every access from it to be a shared one (lds/sts, not
  // generic loads and stores)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const HArgs& h = a.h;
  const int total = h.n * h.npass * a.notiles * a.units;
  const int nx = min(total, (int)(blockIdx.x + 1) * a.per_cta) - (int)blockIdx.x * a.per_cta;
  const int c = warp_index() >> 2;
  const Lane l;
  const bool recompute = a.a_in == nullptr;
  W1Item* items = reinterpret_cast<W1Item*>(smem + kW1Items);
  uint64_t* g_full = reinterpret_cast<uint64_t*>(smem + kW1Bars);
  uint64_t* x_full = g_full + 2;
  uint64_t* w_full = g_full + 3;
  const uint32_t xsa = smem_u32(smem + kW1X), whb = smem_u32(smem + kW1Wh);
  const uint32_t stga = smem_u32(smem + kW1Stg);
#ifdef COND_CHAIN_TIMERS
  long long tw[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // as g_timers from kW1Timers
  const long long t_all = clock64();
  long long* const twp = tw;
#else
  long long* const twp = nullptr;
#endif

  // the first thread's requests for item m (u): its g stage (slot m & 1)
  // and, where it needs another than item m - 1's, Wh's image
  auto ask = [&](const W1Item u, int m, bool wh) {
    const int st = m & 1;
    mbar_arrive_expect_tx(&g_full[st], (OT / 8) * kGUnitRows * 32);
    for (int bx = 0; bx < OT / 8; ++bx) {
      tma_load_4d(smem + kW1GRing + st * kW1GStage + bx * kW1GBox, &a.g_map, &g_full[st],
                  u.ot * OT + 8 * bx, u.i, u.s0 - 1, u.b);
    }
    if (!recompute) {
      // past E = 9 the unit's rows of lrelu(h) from the data kernel's
      // scratch, 17 boxes of 8 columns, into the Wh region
      mbar_arrive_expect_tx(w_full, kPass * kUnit * 4);
      for (int q = 0; q < kPass / 8; ++q) {
        tma_load_3d(smem + kW1Wh + q * 2048, &a.a_map, w_full, u.i * h.cc + u.p * kPass + 8 * q,
                    u.s0, u.b);
      }
    } else if (wh) {
      mbar_arrive_expect_tx(w_full, (uint32_t)(h.nkh * 2 * kHItem));
      bulk_load(smem + kW1Wh,
                a.img_h + (size_t)u.b * a.h_image +
                    ((size_t)u.i * h.npass + u.p) * h.nkh * 2 * kHItem,
                (uint32_t)(h.nkh * 2 * kHItem), w_full);
    }
  };
  // item m's X's image from its exc rows (stage m & 1), for the async proxy
  auto x_put = [&](const W1Item u, int m) {
    w1_x_image(h, u.s0, reinterpret_cast<const float*>(smem + kW1Stg + (m & 1) * kW1Exc),
               smem + kW1X);
    fence_proxy_async();
    release(x_full);
  };
  // warpgroup c's whole share of item m's a (u): the pass's columns from
  // 48 c on (96 .. 135 in the third)
  auto share = [&](const W1Item u, int m) {
    if (c < 2) {
      w1_share_n<kW1HCols>(a, l, kW1HCols * c, u, m, xsa, whb, smem, x_full, w_full, twp);
    } else {
      w1_share_n<kPass - 2 * kW1HCols>(a, l, 2 * kW1HCols, u, m, xsa, whb, smem, x_full, w_full,
                                       twp);
    }
  };

  // items 0 .. 2 and item 0's a: its g, Wh, X, then every warpgroup's share
  if (threadIdx.x == 0) {
    mbar_init(&g_full[0], 1);
    mbar_init(&g_full[1], 1);
    mbar_init(x_full, kW1Threads / 32);  // one arrival per warp
    mbar_init(w_full, 1);
    fence_barrier_init();
    W1Item u(a, blockIdx.x * a.per_cta);
    for (int m = 0; m < 3 && m < nx; ++m, u.next(a)) items[m] = u;
    prefetch_map(&a.g_map);
    if (!recompute) prefetch_map(&a.a_map);
    if (nx > 0) ask(items[0], 0, true);
  }
  __syncthreads();
  if (nx > 0) {
    if (recompute) {
      w1_exc_rows(h, items[0].b, items[0].s0, stga);
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      bar_sync(1, kW1Threads);
      x_put(items[0], 0);
      if (nx > 1) w1_exc_rows(h, items[1].b, items[1].s0, stga + kW1Exc);
    }
    share(items[0], 0);
  }
  float acc[68];
  int seg = 0;                                            // the segment's units so far
  int sx = blockIdx.x - w1_first_cta(a, items[0].tau);  // its partial's slot
  for (int n = 0; n < nx; ++n) {
    TIMER_START(t_b);
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // item n + 1's exc rows
    bar_sync(1, kW1Threads);
    TIMER_ADD(tw[7], t_b);
    const bool more = n + 1 < nx;
    if (recompute && more) {
      // item n + 1's X (the product warpgroups' parts under their products)
      // and item n + 2's exc rows
      TIMER_START(t_x);
      if (c >= kNch) x_put(items[(n + 1) & 3], n + 1);
      if (n + 2 < nx) {
        w1_exc_rows(h, items[(n + 2) & 3].b, items[(n + 2) & 3].s0, stga + (n & 1) * kW1Exc);
      }
      TIMER_ADD(tw[0], t_x);
    }
    if (threadIdx.x == 0) {
      if (n + 3 < nx) {
        W1Item u = items[(n + 2) & 3];
        u.next(a);
        items[(n + 3) & 3] = u;
      }
      if (more) ask(items[(n + 1) & 3], n + 1, items[(n + 1) & 3].nwh != items[n & 3].nwh);
    }
    if (c < kNch) {
      const int st = n & 1;
      TIMER_START(t_gf);
      mbar_wait(&g_full[st], (uint32_t)((n >> 1) & 1));
      TIMER_ADD(tw[3], t_gf);
      const float* gs = reinterpret_cast<const float*>(smem + kW1GRing + st * kW1GStage);
      const uint32_t abase = smem_u32(smem + st * kASlot);
      const int keep0 = seg % kW1Run != 0;  // else the unit's products overwrite the accumulators
      // this thread's product rows r = 64 c + l.row + 8 half; the A
      // fragment's element (r, k) is g at the unit's row k - j + 1, the
      // stage's row k + 2 - j
      int off[2];
      bool ok[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 64 * c + l.row + 8 * half;
        ok[half] = r < 3 * OT;
        off[half] = ok[half] ? (r % OT / 8) * (kW1GBox / 4) + (2 - r / OT + l.tig) * 8 + r % 8 : 0;
      }
      XFrag f[2];
      TIMER_START(t_p);
#pragma unroll 1
      for (int kk = 0; kk < kUnit / 8; kk += 2) {
        if (kk == kW1XAt && recompute && more) {
          // item n + 1's X, under the products issued so far
          TIMER_START(t_x);
          x_put(items[(n + 1) & 3], n + 1);
          TIMER_ADD(tw[0], t_x);
        }
        w1_slice(gs, off, ok, kk, abase, kk > 0 || keep0, acc, f[0]);
        w1_slice(gs, off, ok, kk + 1, abase, 1, acc, f[1]);
      }
      TIMER_ADD(tw[4], t_p);
      if (more) {
        share(items[(n + 1) & 3], n + 1);  // h behind the products: one wait for both
      } else {
        TIMER_START(t_pw);
        wgmma_wait<0>();
        TIMER_ADD(tw[5], t_pw);
      }
      fence_regs(acc);
      ++seg;
      const W1Item u = items[n & 3];
      const bool tile_end = u.k + 1 == a.units;
      const bool seg_end = tile_end || !more;
      if (seg % kW1Run == 0 || seg_end) {
        TIMER_START(t_o);
        w1_run_end<OT>(a, l, c, u, acc, seg, sx, seg_end, tile_end);
        TIMER_ADD(tw[6], t_o);
      }
      if (seg_end) {
        seg = 0;
        sx = 0;  // the next tile starts in this CTA
      }
    } else if (more) {
      share(items[(n + 1) & 3], n + 1);
    }
  }
#ifdef COND_CHAIN_TIMERS
  if (l.wt == 0) {
    for (int x = 0; x < 8; ++x) atomicAdd(&g_timers[kW1Timers + x], (unsigned long long)tw[x]);
    atomicAdd(&g_timers[kW1Timers + 8], (unsigned long long)(clock64() - t_all));
    atomicAdd(&g_timers[kW1Timers + 9], 1ull);
  }
#endif
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
// s*sstride + k], s in order, for o < outer, k < len. Past kReduceLong
// partials, in a job of fewer than kReduceFew outputs (whose threads would
// not fill the card), an output's sum is taken by a warp: lane l sums the l-th of
// kReduceLanes runs of ceil(S / kReduceLanes) consecutive partials in
// order, then the runs' sums are added in order (a long sum, such as db1's
// over every (batch row, tile), would otherwise be one thread's chain of
// dependent loads). Shorter sums stay one thread's: a warp an output reads
// 32 partials' sectors for one float each (on an H100, past 32 partials, dW0's 49,152
// outputs of 64 at the options' bottleneck took 3x as long by warps), and
// 32 registers keep eight CTAs of 256 threads an SM (at 40, concat
// E = Cc = 600's reduce, 600 MB, took 8% longer).
struct ReduceJob {
  const float* part;
  float* out;
  long long len, sstride, ostride, first;  // first: its first thread in the launch
  int outer, S, lanes;                     // lanes: threads an output, 1 or kReduceLanes
};
constexpr int kMaxJobs = 7;
constexpr int kReduceLanes = 32;
constexpr int kReduceLong = 256;           // partials a job has at least to take lanes
constexpr long long kReduceFew = 1 << 16;  // outputs a job has at most to take lanes
struct ReduceArgs {
  ReduceJob job[kMaxJobs];
  int n;
  long long total;
};

__global__ void __launch_bounds__(256, 8) k2_reduce_kernel(const __grid_constant__ ReduceArgs r) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= r.total) return;  // a warp of a job of kReduceLanes lanes is whole
  int j = 0;
  while (j + 1 < r.n && x >= r.job[j + 1].first) ++j;
  const ReduceJob& jb = r.job[j];
  // a job that takes lanes starts on a warp: the threads of the gap before
  // it fall in the job before, which takes one lane an output, past its end
  const bool warp = jb.lanes > 1;
  const long long e = warp ? (x - jb.first) / kReduceLanes : x - jb.first;
  if (e >= jb.len * jb.outer) return;
  const int lane = warp ? (int)(x - jb.first) % kReduceLanes : 0;
  const long long o = e / jb.len;
  const long long k = e - o * jb.len;
  const float* p = jb.part + o * jb.ostride + k;
  const int per = warp ? (jb.S + kReduceLanes - 1) / kReduceLanes : jb.S;
  const int s1 = min(jb.S, (lane + 1) * per);
  // in order, eight loads in flight at a time
  float acc = 0.f;
  int s = lane * per;
  for (; s + 8 <= s1; s += 8) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = p[(long long)(s + u) * jb.sstride];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += v[u];
  }
  for (; s < s1; ++s) acc += p[(long long)s * jb.sstride];
  if (warp) {
    float sum = 0.f;
    for (int l = 0; l < kReduceLanes; ++l) sum += __shfl_sync(0xffffffffu, acc, l);
    if (lane) return;
    acc = sum;
  }
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
  j.lanes = S > kReduceLong && len * outer < kReduceFew ? kReduceLanes : 1;
  if (j.lanes > 1) r.total = (r.total + kReduceLanes - 1) / kReduceLanes * kReduceLanes;
  j.first = r.total;
  r.total += len * outer * j.lanes;
}

// Everything the launch needs, from the shapes alone; ok = false for shapes
// the kernels do not take. Offsets are in floats of the workspace, each on a
// 256-byte boundary.
struct Plan {
  bool ok;
  bool narrow;                              // E <= 9: X^T dh in (b); else (b) writes the
                                            // dh and lrelu(h) scratches, for (d) and (c)
  int ntiles, no, ne, nimg, run, nruns;     // (a), (b): runs of `run` tiles a batch row
  int ot, notiles, nsub, units, per_cta, w1_ctas, s1;  // (c): s1 partial slots
  int kx, xcols, xks, parts, prows, s0;     // (d), and X^T dh's partials: parts a batch row
  size_t h_image;                           // bytes
  size_t off_dh, off_pb1, off_pw1, off_pw0, off_imh, off_imw1, off_imw0, off_a, off_dx, off_w1r;
  size_t total;
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
  // (c): the items (tile of (block, pass, OT output channels), unit of 64
  // rows) in equal runs over one wave of the card's SMs; a tile's units go
  // to consecutive CTAs, each writing the partial of its segment into the
  // next slot (s1: the most segments of any tile)
  p.ot = two_c <= 32 ? 32 : 64;
  p.notiles = (two_c + p.ot - 1) / p.ot;
  p.nsub = (T + kUnit - 1) / kUnit;
  p.units = B * p.nsub;
  const long long tiles = (long long)n * npass * p.notiles;
  const long long items = tiles * p.units;
  if (items >= (1LL << 31)) return p;
  p.per_cta = (int)((items + kSmCount - 1) / kSmCount);
  p.w1_ctas = (int)((items + p.per_cta - 1) / p.per_cta);
  p.s1 = 1;
  for (long long tau = 0; tau < tiles; ++tau) {
    const long long first = tau * p.units / p.per_cta;
    const long long last = ((tau + 1) * p.units - 1) / p.per_cta;
    p.s1 = std::max(p.s1, (int)(last - first + 1));
  }
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
  p.off_pw0 = up(p.off_pw1 + (size_t)p.s1 * 3 * cc * n2);
  p.off_imh = up(p.off_pw0 + (size_t)p.s0 * p.kx * n0);
  p.off_imw1 = up(p.off_imh + p.nimg * p.h_image / 4);
  p.off_imw0 = up(p.off_imw1 + (size_t)n * npass * p.no * kW1Item / 4);
  p.off_a = up(p.off_imw0 + (size_t)n * npass * p.ne * kW0Item / 4);
  // dexc: one part a block and pass, which (e) sums in order
  p.off_dx = up(p.off_a + (p.narrow ? 0 : R * n0));
  p.off_w1r = up(p.off_dx + ((size_t)n * npass > 1 ? (size_t)n * npass * R * E : 0));
  p.total = p.off_w1r + (size_t)p.w1_ctas * (kPass / 8) * kW1Threads * 4;
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
  w.w1_runs = ws + p.off_w1r;
  w.two_c = two_c;
  w.notiles = p.notiles;
  w.nsub = p.nsub;
  w.units = p.units;
  w.per_cta = p.per_cta;
  w.nslots = p.s1;
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
  const cuuint64_t a_dims[3] = {(cuuint64_t)n0, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {ld, ld * T};
  const cuuint32_t a_box[3] = {8, (cuuint32_t)kUnit, 1};
  if (!make_map_f32(&d.g_map, g, 4, g_dims, g_strides, g_box) ||
      !make_map_f32(&w.g_map, g, 4, g_dims, g_strides, g_box_w1) ||
      (!p.narrow && (!make_map_f32(&x.dh_map, d.dh_out, 4, dh_dims, dh_strides, dh_box) ||
                     !make_map_f32(&w.a_map, d.a_out, 3, a_dims, a_strides, a_box)))) {
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
  const dim3 w1_grid((unsigned)p.w1_ctas);
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

  // dexc over the blocks and passes; dW1 over the segments' slots; db1 over
  // every (batch row, time tile); dW0 over every (batch row, part); dhbias,
  // the edges over a batch row's parts (dhbias over all of them when hbias
  // is shared)
  ReduceArgs r{};
  const long long xs = (long long)p.kx * n0;
  if (nparts > 1) add_job(r, d.dexc, dexc, (long long)B * T * E, 1, nparts,
                          (long long)B * T * E, 0);
  add_job(r, pw1, dw1, 3LL * cc * n2, 1, p.s1, 3LL * cc * n2, 0);
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
