// FiLM conditioning chain, backward, bf16 instance (K2-bf16), for one MRF
// stage's n FiLM blocks.
//
// Replaces the bf16 instance of td_vc_gan_tpu/ops/pallas/cond_chain.py::_bwd_kernel
// (launched by _pallas_bwd, wrapped by _chain_bwd, on bf16 operands under
// the JAX package's bf16 compute scope). With every operand bf16 and the
// forward of cond_chain_bf16.cu, given g = d(out) (B, T, n*2C) it computes
//
//   h        recomputed in f32;  a32 = lrelu(h) (zero outside [0, T)), a = bf16(a32)
//   da_i[t]  = sum_j g_i[t-j+1] @ W1_i[j]^T                              (f32)
//   dh       = bf16(where(a32 >= 0, da, 0.2 da))                         (zero outside [0, T))
//   dexc[t]  = bf16(sum_i sum_j dh_i[t-j+1] @ W0_i[j]^T)                 (f32 sum, one rounding)
//   dW1_i[j] = bf16(sum_{b,t} a_i[t+j-1]^T g_i[t]),  db1 = bf16(sum_{b,t} g)
//   dW0[j]   = bf16(sum_{b,t} exc[t+j-1]^T dh[t])
//   dhbias   = bf16(sum_t dh) (also over b when hbias is shared),
//   dedge0   = -dh[0], dedge_t = -dh[T-1]
//
// with every weight and bias gradient summed in f32 over all (batch row,
// time) pairs and rounded to bf16 once, as the Pallas kernel accumulates in
// f32 and casts at the end. lrelu'(h) is 1 where h >= 0, as the JAX
// package's leaky_relu VJP.
//
// What bounds it on an H100: hundreds of flops per byte at the decoder's
// shapes, above the ridge of the card's dense bf16 tensor-core rate (295
// flops per byte): bound by operations. Past E = 8 also by the bytes of the
// dh and a scratches that the data kernel writes for dW0 and the edges and
// for dW1 and that k2b_xdh_kernel and k2b_w1_kernel read back; at E <= 8
// (the decoder's E = 8) there is no scratch (each would be 2 x 7.5 GB a
// batch-64 train step).
//
// What the design does about it: the work is split into kernels that each
// own their outputs, every sum runs in a fixed order (the same result every
// run, no atomics), every product runs on wgmma (hopper_bf16.cuh) with f32
// accumulators in registers, and every operand in shared memory comes by
// TMA or a bulk copy through mbarrier rings. The data kernel and
// k2b_xdh_kernel have the CTA of cond_chain_bf16.cuh: two consumer
// warpgroups and a producer warp.
//
//  (a) k2b_data_kernel, one CTA per (run of consecutive 124-row time tiles
//      of one batch row, block i, pass of 136 columns of h): two consumer
//      warpgroups of 64 rows of h each, walking the run's tiles (at most
//      kRunTiles, and more runs where the CTAs would not fill two waves of
//      the card). The warp roles come from a warp index ptxas sees uniform
//      (warp_index), so that it does not serialize the wgmma (C7520). Per
//      tile:
//       - h_i on wgmma (M = 64, N = 136, K = 3E + 3: exc's taps, the bias
//         and the edge corrections; B an image w_images_kernel makes at
//         each launch, held for the run at E <= 8). At E <= 8, A is X
//         staged in shared memory by the consumer threads (one 16-byte
//         load a tap at E = 8, the next tile's loaded under this tile's
//         da), and the product is issued under the last tile's dexc shift
//         and store; past E = 8 X is gathered into registers k-slice by
//         k-slice and B streams through the weights ring. Only where h < 0
//         is kept, as 68 bits a thread: the slope (lrelu(-0) = +0, as the
//         f32 h);
//       - da_i on wgmma in the same accumulator layout (M = 64, N = 136,
//         K = 3 x 2C, the first k-slice at scale 0), both operands fed by
//         TMA into a ring of 3 stages with full/empty mbarriers: a stage is
//         64 columns of g_i for one tap at each warpgroup's rows (the tap
//         window t0 - j + 62 w: a 4-D tensor map over (2C, n, T, B) whose
//         zero fill outside [0, T) gives the 'same' conv's zero rows at both
//         ends of every batch row, and past 2C the zero columns of a ragged
//         k-slice) and the matching 136 x 64 tile of W1_i (a tensor map
//         over (2C, n, Cc, 3)). The producer thread runs ahead across taps
//         and tiles;
//       - dh = bf16(slope da), zero outside [0, T), to shared memory, each
//         8-column chunk holding all its rows 16 bytes apart (past E = 8 its
//         own rows also to the scratch, for (c), and before da, through the
//         same shared memory, a = bf16(lrelu(h)) of its own rows to the a
//         scratch, for (b));
//       - the block's and pass's dexc: the three taps' products of all 64
//         rows as one product on wgmma (M = 64, N = 24: 8 columns of E a
//         tap, K = 144; dh and W0's image in shared memory), then shifted
//         and added through shared memory, dexc[r] = (P_0[r + 2] +
//         P_1[r + 1]) + P_2[r], and stored as this block's and pass's f32
//         partial (rounded to bf16 here where n npass = 1);
//       - at E <= 8, in the same commit group, X^T dh for dW0, dhbias and
//         both edges (see (c)): after a barrier of both warpgroups, each
//         takes 72 of the pass's columns of dh (0 .. 71, 64 .. 135) over
//         both windows' own rows (X's halo rows zeroed once h has read
//         them), D = X^T dh with M = 64 columns k of X (A MN-major; the rows
//         past X's 32 columns dropped), N = 72, K = 64 rows a window; each
//         tile's D added in f32 to the run's sum in shared memory, written
//         as the partial of (batch row, run) at its end. A run is at most 8
//         tiles: 16 units of 62 rows, the most a partial sums.
//  (b) k2b_w1_kernel, dW1 and db1. The items are (tile, unit): a tile is
//      (block i, pass p, 64 columns o of g), a unit a batch row's 62 rows
//      t0 .. t0 + 61 of g. The CTAs walk the items tile-major in equal runs,
//      one wave of the card's 132 SMs (one CTA an SM), so that a CTA may end
//      one tile's units and start the next's; each segment of a tile a CTA
//      takes is an f32 partial in the next slot, the tile's last CTA zeroing
//      the slots after its own (the accumulators take a whole segment, up to
//      ~1,300 units: bf16's rounding at 2^-8 hides wgmma's f32 drift).
//      Three warpgroups, warpgroup c taking tap c; per unit n:
//       - the products, dW1_i[c] += g^T a(rows shifted by c) on wgmma for
//         all 144 columns (the pass's and a column of ones: tap 1's D[o][136]
//         is db1): M = the 64 columns o (A: the g tile, MN-major, 128-byte
//         swizzle), N = 144 (B: a, MN-major; tap c's B the same descriptor
//         16 c bytes on, a one or two rows down: the conv's zero rows are g's
//         zero fill and a's zeros outside [0, T)), K = 64 rows in 4 slices;
//       - at E <= 8, issued after them, a third of unit n + 1's recompute: h
//         of the unit's rows t0 - 1 .. t0 + 62 for 48 columns (40 in the
//         third), as (a) computes h (the same X in shared memory, image of
//         cond_0's weights, k-slices and instruction: the same bits); once
//         both are done, lrelu (max(h, 0.2 h)), the rounding and a's store
//         (stmatrix, to the other of two slots, MN-major), then one barrier
//         of the three. At E = 8 X's taps are the unit's exc rows t0 - 2 ..
//         t0 + 63, which TMA brings with g (tap j's 8 columns the rows from j
//         on: the descriptor's two k halves 16 bytes apart), and its last 8
//         columns (1, -[u == 0], -[u == T-1]) one of six chunks written
//         once; the image of cond_0's weights in one of two slots, the next
//         one bulk-copied while the one before is in use. Past E = 8 nothing
//         is recomputed: (a) wrote a to a scratch, which TMA brings with g
//         (17 boxes of 8 columns), so that neither the image chunks (29 at
//         concat E = 600) nor X stream per unit and tile.
//      Warpgroup 0's first thread keeps the ring of stages fed three units
//      ahead. What the other designs did, on the card against this one
//      (the batch-64 step, k2b_w1_kernel 5.6 ms): one recompute warpgroup
//      beside three product warpgroups (512 threads; the three taps' 64
//      channels stacked as M rows, A = g^T by ldmatrix into register
//      wgmma) 7.9 ms, the recompute pacing it (the products waited on it
//      74-79%); two recompute warpgroups taking units in turn beside three
//      product warpgroups (640 threads) does not compile (m64n144 needs 98
//      registers, the cap is 96); the recompute issued before the products
//      and waited on with wgmma_wait<1>, lrelu under the products: ptxas
//      serialized every wgmma (C7514), 6.8 ms; a whole unit's recompute by
//      one warpgroup in turn, two units ahead: 308 bytes of spills, 6.3 ms;
//      two units an iteration: spills and C7511, 7.0 ms; h waited alone
//      first, then the products with lrelu after their issue: 5.9 ms (the
//      issue itself waits for the tensor cores); lrelu between the products'
//      k-slices: C7511, 7.5 ms.
//  (c) past E = 8, k2b_xdh_kernel, dW0, dhbias, dedge0 and dedge_t as one
//      product, X^T dh, with X the rows of h's A in (a),
//        X[t] = [exc[t-1] | exc[t] | exc[t+1] | 1 | -[t == 0] | -[t == T-1]]   (K = 3E + 3),
//      so that row jE + e of X^T dh is dW0[j][e], row 3E dhbias, rows 3E + 1
//      and 3E + 2 dedge0 and dedge_t (each a single term). Taken as
//      (dh^T X)^T: M = 64 columns of dh (A: a TMA box, MN-major, 128-byte
//      swizzle; two a warpgroup), N = 32 columns of X (B: X's rows of the
//      step, built once a step in shared memory by the consumer threads, 16
//      bytes each, from exc: one 16-byte load a tap where E is a multiple
//      of 8, element by element at any other E), K = 64 rows a stage of a
//      3-stage ring; two CTAs an SM. A CTA owns 256 columns, 32 columns of
//      X and one part of one batch row's rows, so that one batch row's
//      outputs (dhbias of a per-row hbias, the edges) never mix two batch
//      rows.
//  (d) k2b_reduce_kernel sums every kind of partial (dexc where n npass >
//      1, dW1, db1, dW0, dhbias, the edges) over its chunks in order and
//      rounds once (one launch for all of them).
//
// Every width goes in passes of 136 columns of h and chunks of 64 columns
// of g, so the kernels' shared memory does not grow with Cc or E: one tile
// for every width. g and W1 need 2C a multiple of 8 (their tensor maps'
// strides are multiples of 16 bytes): the wrapper pads other widths with
// zero columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

#include <algorithm>

#include "cond_chain_bf16.cuh"

namespace {

using namespace bf16chain;

constexpr int kSmCount = 132;  // an H100's SMs: the kernels' grids are sized by them

// A diagnostic build (-DCOND_CHAIN_TIMERS) sums the data kernel's clock64
// cycles by phase over the launch, read by cond_chain_bwd_bf16_timers: each
// consumer warpgroup's h (the product and the sign bits, with the weights
// ring's waits where E > 8; at E <= 8 the wait for the product, which is
// issued under the last tile's dexc shift and counted there), da's
// products (with the waits on full, also counted alone), the slope and
// dh's store (with the two CTA barriers around it; where E > 8 also dh's
// copy to the scratch), dexc and X^T dh (the products, X^T dh's sum in
// shared memory and dexc's shift and store also counted alone), and the
// whole kernel; the producer's waits on empty and its whole. Then
// k2b_w1_kernel's (from kW1Timers on), its warpgroup 1's: the recompute's
// X (the wait for the unit's stage at E = 8, else X's copy) and its waits
// for an image, the products' waits on g_full, their issue, the wait for
// the products and the recompute, lrelu and a's store, the barrier of the
// three warpgroups, the partials' store, its whole and count; the
// producer's (thread 0's) waits on empty, its whole and count. The normal
// build has none.
#ifdef COND_CHAIN_TIMERS
constexpr int kW1Timers = 13;
constexpr int kTimers = kW1Timers + 13;  // the data kernel: h, da, da's waits, dh, dexc,
                                         // dexc's products, X^T dh's sum, dexc's shift,
                                         // whole, warpgroups, producer wait, whole,
                                         // producers; k2b_w1_kernel: 8 + 2 compute,
                                         // 1 + 2 producer
__device__ unsigned long long g_timers[kTimers];
#define TIMER_START(v) const long long v = clock64()
#define TIMER_ADD(acc, since) acc += clock64() - since
#else
#define TIMER_START(v)
#define TIMER_ADD(acc, since)
#endif

// The weights ring, consumer side: two slots of kWSlot bytes, each with a
// full and an empty barrier (one arrival per consumer warp), taken in the
// order the producer fills them.
struct WRing {
  unsigned char* slots;
  uint64_t* full;
  uint64_t* empty;
  int k;
  __device__ __forceinline__ uint32_t wait() {
    mbar_wait(&full[k & 1], (uint32_t)((k >> 1) & 1));
    return smem_u32(slots + (k & 1) * kWSlot);
  }
  __device__ __forceinline__ void release() {
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[k & 1]);
    ++k;
  }
};

// The producer's side: the next slot, once free, filled with `bytes` from `src`
__device__ __forceinline__ void wring_put(const WRing& wr, int& k, const void* src,
                                          uint32_t bytes) {
  const int s = k & 1;
  mbar_wait(&wr.empty[s], (uint32_t)(((k >> 1) & 1) ^ 1));
  mbar_arrive_expect_tx(&wr.full[s], bytes);
  bulk_load(wr.slots + s * kWSlot, src, bytes, &wr.full[s]);
  ++k;
}

// X[u][k] (cond_chain_bf16.cuh): exc[b][u + j - 1][e] for k = j E + e < 3E
// (0 outside [0, T)), then 1, -[u == 0], -[u == T-1], then 0
__device__ __forceinline__ uint32_t x_at(const HArgs& h, int b, int u, int k) {
  constexpr uint32_t kOne = 0x3F80u, kMinusOne = 0xBF80u;  // bf16 1 and -1
  if (k < 3 * h.E) {
    const int j = (k >= h.E) + (k >= 2 * h.E);  // k / E, without the division
    const int t = u + j - 1;
    if (t < 0 || t >= h.T) return 0u;
    return bits(h.exc[((size_t)b * h.T + t) * h.E + (k - j * h.E)]);
  }
  if (k == 3 * h.E) return kOne;
  if (k == 3 * h.E + 1) return u == 0 ? kMinusOne : 0u;
  if (k == 3 * h.E + 2) return u == h.T - 1 ? kMinusOne : 0u;
  return 0u;
}

// The A registers of k-slice k0 of the h product: A[q][k] = X at h row u0 + q
__device__ __forceinline__ void x_frag(const HArgs& h, uint32_t (&a)[4], int b, int u0,
                                       const Lane& l, int k0) {
  const int k = k0 + 2 * l.tig;
  const int u = u0 + l.row;
  a[0] = x_at(h, b, u, k) | (x_at(h, b, u, k + 1) << 16);
  a[1] = x_at(h, b, u + 8, k) | (x_at(h, b, u + 8, k + 1) << 16);
  a[2] = x_at(h, b, u, k + 8) | (x_at(h, b, u, k + 9) << 16);
  a[3] = x_at(h, b, u + 8, k + 8) | (x_at(h, b, u + 8, k + 9) << 16);
}

// X[u][8 c .. 8 c + 7] (K <= 32: c < 4) as 16 bytes: a tap of exc by one
// 16-byte load where E = 8 and exc is 16-byte aligned (`vec`), else element
// by element
__device__ __forceinline__ uint4 x_chunk(const HArgs& h, int b, int u, int c, bool vec) {
  if (vec && c < 3) {
    const int t = u + c - 1;
    return t >= 0 && t < h.T ? *reinterpret_cast<const uint4*>(h.exc + ((size_t)b * h.T + t) * 8)
                             : make_uint4(0u, 0u, 0u, 0u);
  }
  uint32_t v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = x_at(h, b, u, 8 * c + 2 * e) | (x_at(h, b, u, 8 * c + 2 * e + 1) << 16);
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// x, which the compiler may not assume unchanged: what is computed from it
// is computed where it is used, not hoisted and held in registers
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The data kernel's shared memory: a ring of kStages stages of (64 rows of g
// for each consumer warpgroup, 136 rows of W1), each 128-byte swizzled rows
// of 64 columns; the weights ring (two slots); at E <= 8 two slots per
// warpgroup of X (4 chunks of 8 columns of K x 64 rows x 16 bytes; X^T dh's
// A, 8 chunks, reads the 4 after them, whose rows of D it drops); per
// warpgroup dh (19 chunks of 8 columns x 64 rows x 16 bytes: the pass's 144
// columns and a zero chunk) and dexc's three taps' products (64 rows of 24
// floats, rows kPLd floats apart); at E <= 8 the run's X^T dh in f32 (27
// rows k x 136 columns c); the barriers.
constexpr int kStages = 3;
constexpr int kGBytes = kRows * 128;     // 8192
constexpr int kW1Bytes = kPass * 128;    // 17408
constexpr int kStageBytes = 2 * kGBytes + kW1Bytes;
constexpr int kDhChunk = kRows * 16;     // 1024: the LBO of the dh operand
constexpr int kDhBytes = (2 * kPassSlices + 1) * kDhChunk;
constexpr int kXBytes = 4 * kDhChunk;    // X of 64 rows, K = 32
constexpr int kW0xTap = 2 * kPassSlices * 128;  // 2304: one tap of an img_x chunk
constexpr int kPLd = 28;       // floats a row of dexc's products (24, padded: bank conflicts)
constexpr int kPBytes = kRows * kPLd * 4;
constexpr int kRunTiles = 8;  // tiles a CTA walks at most: 16 units of 62 rows a partial
constexpr int kBarAll = 3;    // the named barrier of both consumer warpgroups
constexpr int kXdhN = 72;     // X^T dh's N: a warpgroup's columns of dh (0 .. 71, 64 .. 135)
constexpr int kXdhRows = 27;   // rows k of X^T dh at E <= 8: K = 3E + 3
constexpr int kXdhBytes = kXdhRows * kPass * 4;
constexpr size_t kDataSmem = (size_t)kStages * kStageBytes + 2 * kWSlot + 4 * (size_t)kXBytes +
                             2 * (size_t)kDhBytes + 2 * (size_t)kPBytes + kXdhBytes +
                             16 * (kStages + 2) + 1024;
static_assert(kDataSmem <= kSmemMax, "K2-bf16's data kernel's shared memory");
static_assert(kDhBytes >= kXBytes, "X^T dh's A reads 4 chunks past the last X, into dh");

struct DataArgs {
  HArgs h;
  const bf16* img_h;   // cond_0's weights as h's B (cond_chain_bf16.cuh), per batch row
  const bf16* img_x;   // ... and as dexc's B
  bf16* dh_out;        // E > 8: (B, T, ld) scratch: dh, for k2b_xdh_kernel
  bf16* a_out;         // E > 8: (B, T, ld) scratch: a = bf16(lrelu(h)), for k2b_w1_kernel
  long long ld;
  float* pdexc;        // (n npass, B, T, E): dexc of each block and pass, or null
  bf16* dexc;          // (B, T, E), written here when n npass = 1
  float* pw0;          // E <= 8: (B runs, K, n Cc): X^T dh of each run
  int two_c, noc, run, nruns, kx;  // run: tiles a CTA walks; kx = 3E + 3
  int vec;             // E = 8 and exc 16-byte aligned: X's taps by 16-byte loads
  W0Geo geo;
  CUtensorMap g_map;   // g as (o: 2C, i: n, t: T, b: B), box (64, 1, 64, 1)
  CUtensorMap w1_map;  // w1 as (o: 2C, i: n, c: Cc, j: 3), box (64, 1, 136, 1)
};

// Past E = 8, a warpgroup's own rows (q = 1 .. 62) of the pass's columns
// from shared memory (8-column chunks holding their rows 16 bytes apart) to
// a (B, T, ld) scratch, 8 columns a thread, consecutive threads along a row
__device__ __forceinline__ void own_rows_out(const HArgs& h, bf16* out, long long ld,
                                             const unsigned char* src, int b, int i, int c0,
                                             int u0, int wt) {
  const bool vec16 = h.cc % 8 == 0;  // block offsets in the scratch's rows 16-byte aligned
  for (int idx = wt; idx < kOwn * (kPass / 8); idx += 128) {
    const int q = 1 + idx / (kPass / 8);
    const int ch = idx - (q - 1) * (kPass / 8);
    const int c = c0 + ch * 8;
    if (c < h.cc && u0 + q < h.T) {
      const uint4 dv = *reinterpret_cast<const uint4*>(src + ch * kDhChunk + q * 16);
      bf16* dst = out + ((size_t)b * h.T + u0 + q) * ld + (size_t)i * h.cc + c;
      if (vec16) {
        *reinterpret_cast<uint4*>(dst) = dv;
      } else {  // Cc a multiple of 4: 8-byte pieces
        *reinterpret_cast<uint2*>(dst) = make_uint2(dv.x, dv.y);
        if (c + 4 < h.cc) *reinterpret_cast<uint2*>(dst + 4) = make_uint2(dv.z, dv.w);
      }
    }
  }
}

// kNarrow: E <= 8 (K = 3E + 3 <= 27: one k-chunk of h's weights, one of
// dexc's), X staged in shared memory and X^T dh taken here; else X read
// from exc k-slice by k-slice into registers and dh copied to the scratch.
template <bool kNarrow>
__global__ void __launch_bounds__(kThreads, 1) k2b_data_kernel(const __grid_constant__ DataArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* wslots = ring + kStages * kStageBytes;
  unsigned char* xs_all = wslots + 2 * kWSlot;  // [slot][warpgroup]
  unsigned char* dhs_all = xs_all + 4 * kXBytes;
  float* pbuf = reinterpret_cast<float*>(dhs_all + 2 * kDhBytes);  // [warpgroup][64][kPLd]
  float* xacc = pbuf + 2 * kRows * kPLd;                            // [k][c]
  uint64_t* full = reinterpret_cast<uint64_t*>(xacc + kXdhRows * kPass);
  uint64_t* empty = full + kStages;
  uint64_t* wfull = empty + kStages;
  uint64_t* wempty = wfull + 2;

  const HArgs& h = a.h;
  const W0Geo& geo = a.geo;
  const int b = blockIdx.y;
  const int ip = blockIdx.z;  // the CTA's block i and pass p
  const int i = ip / geo.npass;
  const int p = ip - i * geo.npass;
  const int c0 = p * kPass;
  const int tile0 = blockIdx.x * a.run;
  const int ntiles = min(a.run, (h.T + kTile - 1) / kTile - tile0);
  const int warp = warp_index();
  const Ring rg{kStages};

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 8);
    }
    fence_barrier_init();
  }
  // dh's columns 136..143, and the chunk after them, stay zero; the run's
  // X^T dh starts from zero
  for (int idx = threadIdx.x; idx < 2 * kDhBytes / 16; idx += kThreads) {
    reinterpret_cast<uint4*>(dhs_all)[idx] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = threadIdx.x; idx < kXdhRows * kPass; idx += kThreads) xacc[idx] = 0.f;
  __syncthreads();

  if (warp == 8) {
    // the producer: cond_0's weights of (i, p) (once, at E <= 8), then per
    // tile of the run the (tap j, chunk oc of g's 2C columns) stages (and,
    // past E = 8, the tile's chunks of the weights), in the order the
    // consumers take them
    if (threadIdx.x == 256) {
#ifdef COND_CHAIN_TIMERS
      long long t_w = 0;
      const long long t_all = clock64();
#endif
      prefetch_map(&a.g_map);
      prefetch_map(&a.w1_map);
      const unsigned char* img_h = reinterpret_cast<const unsigned char*>(a.img_h) +
                                   (h.hbias_bstride ? (size_t)b * geo.h_image : 0);
      const unsigned char* img_x = reinterpret_cast<const unsigned char*>(a.img_x);
      const WRing pw{wslots, wfull, wempty, 0};
      int k = 0, wk = 0;
      if (kNarrow) {
        wring_put(pw, wk, img_h + (size_t)ip * geo.h_chunk, (uint32_t)geo.h_chunk);
        wring_put(pw, wk, img_x + (size_t)ip * kXChunk, (uint32_t)kXChunk);
      }
      for (int tl = 0; tl < ntiles; ++tl) {
        const int t0 = (tile0 + tl) * kTile;
        if (!kNarrow) {
          for (int kc = 0; kc < geo.nkc; ++kc) {
            TIMER_START(tw);
            wring_put(pw, wk, img_h + ((size_t)ip * geo.nkc + kc) * geo.h_chunk,
                      (uint32_t)geo.h_chunk);
            TIMER_ADD(t_w, tw);
          }
        }
        for (int j = 0; j < 3; ++j)
          for (int oc = 0; oc < a.noc; ++oc, ++k) {
            const int s = rg.slot(k);
            unsigned char* st = ring + s * kStageBytes;
            TIMER_START(tw);
            mbar_wait(&empty[s], rg.parity(k) ^ 1);
            TIMER_ADD(t_w, tw);
            mbar_arrive_expect_tx(&full[s], kStageBytes);
            // warpgroup w's A row q is h row t0 + 62 w - 1 + q: tap j reads g row t0 + 62 w - j + q
            tma_load_4d(st, &a.g_map, &full[s], oc * 64, i, t0 - j, b);
            tma_load_4d(st + kGBytes, &a.g_map, &full[s], oc * 64, i, t0 + kOwn - j, b);
            tma_load_4d(st + 2 * kGBytes, &a.w1_map, &full[s], oc * 64, i, c0, j);
          }
        if (!kNarrow) {
          for (int ec = 0; ec < geo.nec; ++ec) {
            TIMER_START(tw);
            wring_put(pw, wk, img_x + ((size_t)ip * geo.nec + ec) * kXChunk, (uint32_t)kXChunk);
            TIMER_ADD(t_w, tw);
          }
        }
      }
#ifdef COND_CHAIN_TIMERS
      atomicAdd(&g_timers[10], (unsigned long long)t_w);
      atomicAdd(&g_timers[11], (unsigned long long)(clock64() - t_all));
      atomicAdd(&g_timers[12], 1ull);
#endif
    }
    return;
  }

  const int wg = warp >> 2;
  const int bar = 1 + wg;
  const Lane l;
  unsigned char* dhs = dhs_all + wg * kDhBytes;
  float* pw = pbuf + wg * kRows * kPLd;
  const bool direct = h.n * geo.npass == 1;  // dexc in bf16 here, no partials
  const size_t bte = (size_t)gridDim.y * h.T * h.E;
  WRing wr{wslots, wfull, wempty, 0};
  uint32_t hbase = 0, xbase = 0;
  if (kNarrow) {  // cond_0's weights of (i, p), held for the run
    hbase = wr.wait();
    ++wr.k;
    xbase = wr.wait();
  }

  float acc[68];     // h, then da
  uint4 xv[2];       // E <= 8: the next tile's X, 2 of the window's 256 pieces
  auto x_load = [&](int tl) {
    const int u0 = (tile0 + tl) * kTile + kOwn * wg - 1;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int idx = l.wt + 128 * m;  // chunk idx / 64, row idx % 64
      xv[m] = x_chunk(h, b, u0 + (idx & 63), idx >> 6, a.vec != 0);
    }
  };
  uint32_t neg[3];   // where h < 0, as bits: the slope's (lrelu(-0) = +0)
#ifdef COND_CHAIN_TIMERS
  long long tm[8] = {0, 0, 0, 0, 0, 0, 0, 0};
#endif
  // E <= 8: tile tl's X from xv to its slot and h = X Wh issued (the first
  // k-slice at scale 0), not waited on
  auto h_issue = [&](int tl) {
    unsigned char* xw_p = xs_all + ((tl & 1) * 2 + wg) * kXBytes;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int idx = l.wt + 128 * m;
      *reinterpret_cast<uint4*>(xw_p + (idx >> 6) * kDhChunk + (idx & 63) * 16) = xv[m];
    }
    fence_proxy_async();
    bar_sync(bar, 128);
    const uint32_t xw = opaque(smem_u32(xw_p));
    const uint32_t hb = opaque(hbase);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (16 * s < geo.kc) {
        wgmma_ss_n136(acc, make_desc(xw + 2 * s * kDhChunk, kDhChunk, 128, kLayoutNone),
                      make_desc(hb + 256 * s, 128, geo.kc * 16, kLayoutNone), s);
      }
    }
    wgmma_commit();
  };
  // ... and its end: the sign bits; the halo rows' X zeroed (X^T dh reads
  // only the own rows); the tile after's X loaded, under da
  auto h_finish = [&](int tl) {
    TIMER_START(t_h);
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int x = 0; x < 3; ++x) neg[x] = 0u;
#pragma unroll
    for (int r = 0; r < 68; ++r) neg[r >> 5] |= (acc[r] < 0.f ? 1u : 0u) << (r & 31);
    if (l.wt < 8) {
      *reinterpret_cast<uint4*>(xs_all + ((tl & 1) * 2 + wg) * kXBytes + (l.wt & 3) * kDhChunk +
                                (l.wt >> 2) * 63 * 16) = make_uint4(0u, 0u, 0u, 0u);
    }
    x_load(tl + 1);
    TIMER_ADD(tm[0], t_h);
  };
  int k = 0;
#ifdef COND_CHAIN_TIMERS
  const long long t_all = clock64();
#endif
  if (kNarrow) {
    x_load(0);
    h_issue(0);
    h_finish(0);
  }
  for (int tl = 0; tl < ntiles; ++tl) {
    const int t0 = (tile0 + tl) * kTile;
    const int tb = t0 + kOwn * wg;  // the warpgroup's first own row
    const int u0 = tb - 1;          // its h row q = 0
    // shared-memory addresses, made anew each tile (opaque to the compiler),
    // so that the products' descriptors are not all held in registers
    const uint32_t xs_u = opaque(smem_u32(xs_all)) + (tl & 1) * 2 * kXBytes;  // this tile's X
    const uint32_t dhs_all_u = opaque(smem_u32(dhs_all));
    const uint32_t dhs_u = dhs_all_u + wg * kDhBytes;

    // past E = 8, h = X Wh here, X gathered into registers k-slice by
    // k-slice (at E <= 8 it was issued under the last tile's epilogue)
    if (!kNarrow) {
      TIMER_START(t_h);
      for (int kc = 0; kc < geo.nkc; ++kc) {
        const int slices = geo.kc / 16;
        uint32_t fa[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < slices) {
            x_frag(h, fa[s], b, u0, l, kc * geo.kc + 16 * s);
          } else {
            fa[s][0] = fa[s][1] = fa[s][2] = fa[s][3] = 0u;
          }
          fence_regs(fa[s]);
        }
        const uint32_t base = wr.wait();
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          if (s < slices) {
            wgmma_rs_n136(acc, fa[s], make_desc(base + 256 * s, 128, geo.kc * 16, kLayoutNone),
                          kc + s > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        wr.release();
      }
#pragma unroll
      for (int x = 0; x < 3; ++x) neg[x] = 0u;
#pragma unroll
      for (int r = 0; r < 68; ++r) neg[r >> 5] |= (acc[r] < 0.f ? 1u : 0u) << (r & 31);
      // a = bf16(lrelu(h)) through dh's shared memory (free: the last
      // tile's dexc and copy are done with it) to the scratch, its own rows,
      // for k2b_w1_kernel, which would otherwise stream the image chunks
      // for every unit and tile of o
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = l.row + 8 * half;
#pragma unroll
        for (int nt = 0; nt < kPass / 8; ++nt) {
          const int v = nt * 4 + 2 * half;
          *reinterpret_cast<uint32_t*>(dhs + nt * kDhChunk + q * 16 + 4 * l.tig) =
              pack_rn(fmaxf(acc[v], kSlope * acc[v]), fmaxf(acc[v + 1], kSlope * acc[v + 1]));
        }
      }
      bar_sync(bar, 128);
      own_rows_out(h, a.a_out, a.ld, dhs, b, i, c0, u0, l.wt);
      TIMER_ADD(tm[0], t_h);
    }

    // da[q][c] = sum_j sum_o g[u0 + q - j + 1][o] W1_i[j][c][o], the first
    // k-slice at scale 0
    TIMER_START(t_da);
    // one commit group a stage; where the tile's three stages fit the ring
    // (2C <= 64), one group for the tile (fewer waits on the products). Two
    // loops, not one with the commits in branches: ptxas serializes wgmma
    // whose commit or wait sits in a branch (C7520)
    if (a.noc == 1) {
      const int k0 = k;
      wgmma_fence();
      for (int j = 0; j < 3; ++j, ++k) {
        const int s = rg.slot(k);
        TIMER_START(t_w);
        mbar_wait(&full[s], rg.parity(k));
        TIMER_ADD(tm[2], t_w);
        const uint32_t gbase = smem_u32(ring + s * kStageBytes + wg * kGBytes);
        const uint32_t wbase = smem_u32(ring + s * kStageBytes + 2 * kGBytes);
        const int slices = (min(64, a.two_c) + 15) / 16;
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          if (sl < slices) {
            wgmma_ss_n136(acc, desc_sw128(gbase + 32 * sl), desc_sw128(wbase + 32 * sl),
                          j + sl > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      for (int j = 0; j < 3; ++j) release(&empty[rg.slot(k0 + j)]);
      fence_regs(acc);
    } else {
      int prev = -1;
      for (int j = 0; j < 3; ++j) {
        for (int oc = 0; oc < a.noc; ++oc, ++k) {
          const int s = rg.slot(k);
          const int slices = (min(64, a.two_c - oc * 64) + 15) / 16;
          TIMER_START(t_w);
          mbar_wait(&full[s], rg.parity(k));
          TIMER_ADD(tm[2], t_w);
          const uint32_t gbase = smem_u32(ring + s * kStageBytes + wg * kGBytes);
          const uint32_t wbase = smem_u32(ring + s * kStageBytes + 2 * kGBytes);
          const int first = j + oc;
          wgmma_fence();
#pragma unroll
          for (int sl = 0; sl < 4; ++sl) {
            if (sl < slices) {
              wgmma_ss_n136(acc, desc_sw128(gbase + 32 * sl), desc_sw128(wbase + 32 * sl),
                            first + sl > 0);
            }
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (prev >= 0) release(&empty[prev]);
          prev = s;
        }
      }
      wgmma_wait<0>();
      release(&empty[prev]);
      fence_regs(acc);
    }
    TIMER_ADD(tm[1], t_da);

    // dh = bf16(lrelu'(h) da), zero outside [0, T), to shared memory, once
    // both warpgroups' products of the last tile are done with it
    TIMER_START(t_dh);
    if (kNarrow) {
      bar_sync(kBarAll, 256);
    } else {
      bar_sync(bar, 128);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = l.row + 8 * half;
      const bool valid = u0 + q >= 0 && u0 + q < h.T;
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
        const int v = nt * 4 + 2 * half;
        const bool n0 = (neg[v >> 5] >> (v & 31)) & 1u;
        const bool n1 = (neg[(v + 1) >> 5] >> ((v + 1) & 31)) & 1u;
        const float d0 = valid ? (n0 ? kSlope * acc[v] : acc[v]) : 0.f;
        const float d1 = valid ? (n1 ? kSlope * acc[v + 1] : acc[v + 1]) : 0.f;
        *reinterpret_cast<uint32_t*>(dhs + nt * kDhChunk + q * 16 + 4 * l.tig) = pack_rn(d0, d1);
      }
    }
    fence_proxy_async();
    if (kNarrow) {
      bar_sync(kBarAll, 256);  // both windows' dh and X in place
    } else {
      bar_sync(bar, 128);
      own_rows_out(h, a.dh_out, a.ld, dhs, b, i, c0, u0, l.wt);  // for k2b_xdh_kernel
    }
    TIMER_ADD(tm[3], t_dh);

    // dexc: the three taps' products P_j[q][e] = sum_c dh[q][c] W0[j][e][i Cc
    // + c] as one product (M = 64, N = 24: the taps of 8 columns of E, K =
    // 144), then dexc[tb + r] = (P_0[r + 2] + P_1[r + 1]) + P_2[r] through
    // shared memory: this block's and pass's part. At E <= 8 in the same
    // commit group the tile's X^T dh, both windows' own rows, for this
    // warpgroup's 72 columns c of dh (0 .. 71, or 64 .. 135): D[k][c] =
    // sum_w sum_q X_w[q][k] dh_w[q][c] (M = 64 columns k of X, A MN-major;
    // N = 72, B MN-major; K = 64 rows a window), added to the run's f32 sum
    // in shared memory (each warpgroup its own columns)
    TIMER_START(t_dx);
    for (int ec = 0; ec < (kNarrow ? 1 : geo.nec); ++ec) {
      float pj[12];
      float xd[36];
      const uint32_t xb = kNarrow ? opaque(xbase) : wr.wait();
      TIMER_START(t_p);
      wgmma_fence();
#pragma unroll
      for (int sl = 0; sl < kPassSlices; ++sl) {
        wgmma_ss_n24(pj, make_desc(dhs_u + 2 * sl * kDhChunk, kDhChunk, 128, kLayoutNone),
                     make_desc(xb + 256 * sl, 128, kW0xTap, kLayoutNone), sl);
      }
      if (kNarrow) {
        const int cb = wg * 8;  // the warpgroup's first chunk of dh's columns
#pragma unroll
        for (int w = 0; w < 2; ++w) {
#pragma unroll
          for (int sl = 0; sl < kRows / 16; ++sl) {
            wgmma_ss_n72<1, 1>(
                xd, make_desc(xs_u + w * kXBytes + 256 * sl, 128, kDhChunk, kLayoutNone),
                make_desc(dhs_all_u + w * kDhBytes + cb * kDhChunk + 256 * sl, 128, kDhChunk,
                          kLayoutNone),
                w + sl > 0);
          }
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      TIMER_ADD(tm[5], t_p);
      fence_regs(pj);
      TIMER_START(t_s);
      if (kNarrow) {
        fence_regs(xd);
        // rows k = l.row (+ 8) of D, columns wg * 64 + 8 kk + 2 tig (+ 1);
        // warpgroup 1's columns 64 .. 71 are warpgroup 0's
        if (l.row < kXdhRows) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int kk = l.row + 8 * half;
#pragma unroll
            for (int ch = 0; ch < kXdhN / 8; ++ch) {
              if (ch >= wg && kk < kXdhRows) {
                float2* x2 = reinterpret_cast<float2*>(xacc + kk * kPass + wg * 64 + 8 * ch +
                                                       2 * l.tig);
                const float2 v0 = *x2;
                *x2 = make_float2(v0.x + xd[4 * ch + 2 * half], v0.y + xd[4 * ch + 2 * half + 1]);
              }
            }
          }
        }
      } else {
        wr.release();
      }
      TIMER_ADD(tm[6], t_s);
      TIMER_START(t_sh);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(pw + (l.row + 8 * half) * kPLd + j * 8 + 2 * l.tig) =
              make_float2(pj[4 * j + 2 * half], pj[4 * j + 2 * half + 1]);
        }
      }
      if (kNarrow) {
        // the next tile's h under the shift below (its barrier also the
        // shift's; past the run's last tile a product no one reads)
        h_issue(tl + 1);
      } else {
        bar_sync(bar, 128);
      }
      if (h.E % 8 == 0) {
        // the 62 x 8 outputs, 4 columns a thread: one 16-byte read of each
        // tap's products, one (aligned) store
        if (l.wt < 2 * kOwn) {
          const int r = l.wt >> 1, e4 = 4 * (l.wt & 1);
          const int t = tb + r;
          const float4 p0 = *reinterpret_cast<const float4*>(pw + (r + 2) * kPLd + e4);
          const float4 p1 = *reinterpret_cast<const float4*>(pw + (r + 1) * kPLd + 8 + e4);
          const float4 p2 = *reinterpret_cast<const float4*>(pw + r * kPLd + 16 + e4);
          const float4 v = make_float4((p0.x + p1.x) + p2.x, (p0.y + p1.y) + p2.y,
                                       (p0.z + p1.z) + p2.z, (p0.w + p1.w) + p2.w);
          const size_t idx = ((size_t)b * h.T + t) * h.E + 8 * ec + e4;
          if (t < h.T) {
            if (direct) {
              *reinterpret_cast<uint2*>(a.dexc + idx) =
                  make_uint2(pack_rn(v.x, v.y), pack_rn(v.z, v.w));
            } else {
              *reinterpret_cast<float4*>(a.pdexc + (size_t)ip * bte + idx) = v;
            }
          }
        }
      } else {
        // this thread's (row, column) pairs x = wt + 128 z of the 62 x 8 outputs
#pragma unroll
        for (int z = 0; z < 4; ++z) {
          const int x = l.wt + 128 * z;
          const int r = x >> 3, e = 8 * ec + (x & 7);
          const int t = tb + r;
          if (x < kOwn * 8 && t < h.T && e < h.E) {
            const float v = (pw[(r + 2) * kPLd + (x & 7)] + pw[(r + 1) * kPLd + 8 + (x & 7)]) +
                            pw[r * kPLd + 16 + (x & 7)];
            const size_t idx = ((size_t)b * h.T + t) * h.E + e;
            if (direct) {
              a.dexc[idx] = __float2bfloat16_rn(v);
            } else {
              a.pdexc[(size_t)ip * bte + idx] = v;
            }
          }
        }
      }
      if (geo.nec > 1) bar_sync(bar, 128);  // the next chunk's products go to pw
      TIMER_ADD(tm[7], t_sh);
    }
    TIMER_ADD(tm[4], t_dx);
    if (kNarrow) h_finish(tl + 1);
  }

  if (kNarrow) {
    // the run's X^T dh: row k of column i Cc + c0 + c of the (batch row, run) partial
    bar_sync(kBarAll, 256);
    const int cw = min(kPass, h.cc - c0);
    const size_t n0 = (size_t)h.n * h.cc;
    float* pd = a.pw0 + (size_t)(b * a.nruns + blockIdx.x) * a.kx * n0 + (size_t)i * h.cc + c0;
    for (int idx = threadIdx.x; idx < a.kx * kPass; idx += 256) {
      const int kk = idx / kPass, c = idx - kk * kPass;
      if (c < cw) pd[(size_t)kk * n0 + c] = xacc[idx];
    }
  }
#ifdef COND_CHAIN_TIMERS
  if (l.wt == 0) {
    for (int x = 0; x < 8; ++x) atomicAdd(&g_timers[x], (unsigned long long)tm[x]);
    atomicAdd(&g_timers[8], (unsigned long long)(clock64() - t_all));
    atomicAdd(&g_timers[9], 1ull);
  }
#endif
}

// k2b_w1_kernel's CTA: three warpgroups, 384 threads (168 registers a
// thread). Warpgroup c takes tap c's products for all 144 columns (N = 144:
// 72 accumulators a thread) and, at E <= 8, recomputes 48 columns of a (40:
// columns 96 .. 135) one unit ahead of them; warpgroup 0's first thread
// keeps the ring of stages fed. Shared memory: a ring of kW1Stages stages,
// each g's 62 rows of 64 columns (128-byte swizzled: a TMA box; rows 62 and
// 63 zero), then at E = 8 exc's rows t0 - 2 .. t0 + 63 (16 bytes each) or
// past E = 8 a as the slots hold it; two slots of a (18 chunks of 8 columns
// x 72 rows x 16 bytes, MN-major: the unit's rows t0 - 1 .. t0 + 62, then
// zeros; chunk 17, columns 136 .. 143, holds 1, 0, .., 0 in every row:
// db1's column of ones); at E = 8 the six kinds of X's last 8 columns, else
// two slots of X; two slots of the image of cond_0's weights; the barriers.
constexpr int kW1Threads = 384;
constexpr int kW1GBytes = kOwn * 128;          // 7936: g's box
constexpr int kW1XRows = kRows + 2;            // exc's rows a unit's X reads: t0 - 2 .. t0 + 63
constexpr int kARows = 72;
constexpr int kAChunk = kARows * 16;           // 1152: 8 columns of a (the SBO of a as B)
constexpr int kW1N = kPass + 8;                // 144: a's columns, then db1's ones
constexpr int kASlot = (kW1N / 8) * kAChunk;   // 20736
constexpr int kW1GStage = 29 * 1024;           // g (8192 with its two zero rows), then exc or a
constexpr int kW1Stages = 4;
constexpr int kW1Ahead = 3;                    // units the producer asks for ahead
constexpr int kXChunk8 = kRows * 16;           // 1024: 8 columns of X, its 64 rows
constexpr int kW1HSlot = kPass * 32 * 2;       // 8704: an image chunk at K <= 32
constexpr int kW1Kinds = 6;                    // of X's last 8 columns, see the kernel
constexpr size_t kW1Smem = (size_t)kW1Stages * kW1GStage + 2 * (size_t)kASlot +
                           kW1Kinds * (size_t)kXChunk8 + 2 * 4 * (size_t)kXChunk8 +
                           2 * (size_t)kW1HSlot + 8 * (2 * kW1Stages + 2) + 64 + 1024;
static_assert(kW1Smem <= kSmemMax, "k2b_w1_kernel's shared memory");
static_assert(kRows * 128 + kASlot <= kW1GStage && kW1Ahead < kW1Stages, "k2b_w1_kernel's ring");

struct W1Args {
  HArgs h;
  const bf16* img_h;   // as DataArgs'
  float* pw1;          // (S, 3, Cc, n*2C): dW1 per segment of a tile's units
  float* pb1;          // (S, n*2C): db1 per segment
  int two_c, notiles, nsub, units;  // tiles of 64 columns of g; units a tile = B nsub
  int per_cta, nslots;  // items (tile, unit) a CTA; S
  int vec;              // E = 8 and exc 16-byte aligned: exc's rows by TMA (x_map)
  int wide;             // E > 8: a read from the scratch, nothing recomputed
  W0Geo geo;
  CUtensorMap g_map;   // g as (o: 2C, i: n, t: T, b: B), box (64, 1, 62, 1)
  CUtensorMap x_map;   // E = 8: exc as (e: 8, t: T, b: B), box (8, 66, 1), no swizzle
  CUtensorMap a_map;   // E > 8: the a scratch as (c: n Cc, t: T, b: B), box (8, 64, 1), no swizzle
};

// The CTAs walk the items (tile, unit), tile-major, per_cta each; a cursor
// over them, advanced without divisions: the tile's block i, pass p and
// tile ot of g's columns, the unit's batch row b and first row t0. The
// segment of tile tau a CTA takes writes the partial of slot cta -
// first_cta(tau), and the tile's last CTA zeroes the slots after its own.
struct Item {
  int x, tau, k, b, t0, i, p, ot;
  __device__ __forceinline__ Item(const W1Args& a, int x0) : x(x0) {
    tau = x0 / a.units;
    k = x0 - tau * a.units;
    b = k / a.nsub;
    t0 = (k - b * a.nsub) * kOwn;
    tile(a);
  }
  __device__ __forceinline__ void tile(const W1Args& a) {
    const int ip = tau / a.notiles;
    ot = tau - ip * a.notiles;
    i = ip / a.geo.npass;
    p = ip - i * a.geo.npass;
  }
  __device__ __forceinline__ void next(const W1Args& a) {
    ++x;
    t0 += kOwn;
    if (t0 >= a.nsub * kOwn) {
      t0 = 0;
      ++b;
    }
    if (++k == a.units) {
      k = b = 0;
      ++tau;
      tile(a);
    }
  }
  // the image of cond_0's weights it needs: of (block, pass), and batch row
  // where hbias is per row
  __device__ __forceinline__ bool same_image(const Item& o, const HArgs& h) const {
    return i == o.i && p == o.p && (h.hbias_bstride == 0 || b == o.b);
  }
};

__device__ __forceinline__ int first_cta(const W1Args& a, int tau) {
  return (int)((long long)tau * a.units / a.per_cta);
}

// Warpgroup c's share of a unit's recompute at E <= 8, issued (one commit
// group) and not waited on: h of the unit's rows for the N columns from
// 48 c on, the data kernel's X, image and k-slices, the data kernel's
// m64nNk16 instruction on the same operands (the same bits)
template <int N>
__device__ __forceinline__ void w1_h_issue(float (&acc)[N / 2], const W0Geo& geo, int c,
                                           uint64_t xd0, uint64_t xd1, uint32_t hb) {
  const uint32_t hbc = hb + 6 * c * geo.kc * 16;  // the image's rows from column 48 c on
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (16 * s < geo.kc) {
      const uint64_t db = make_desc(hbc + 256 * s, 128, geo.kc * 16, kLayoutNone);
      if constexpr (N == 48) {
        wgmma_ss_n48(acc, s ? xd1 : xd0, db, s);
      } else {
        wgmma_ss_n40(acc, s ? xd1 : xd0, db, s);
      }
    }
  }
  wgmma_commit();
}

// ... and once it is done: a = bf16(lrelu(h)) (lrelu(x) = max(x, 0.2 x)),
// zero outside [0, T) and past Cc, to the slot's rows 0 .. 63 (stmatrix:
// two 8-column chunks of the warp's 16 rows each)
template <int N>
__device__ __forceinline__ void w1_a_store(float (&acc)[N / 2], const HArgs& h, const Lane& l,
                                           int c, uint32_t aslot, int t0, int p, int warp) {
  fence_regs(acc);
  const int lane = threadIdx.x & 31;
  const int u0 = t0 - 1;
  const bool inner = u0 >= 0 && u0 + kRows <= h.T && p * kPass + kPass <= h.cc;
  const bool ok0 = u0 + l.row >= 0 && u0 + l.row < h.T, ok1 = u0 + l.row + 8 < h.T;
  const int cl = h.cc - p * kPass - 48 * c - 2 * l.tig;  // chunk nt's columns valid: 8 nt < cl
  const uint32_t base = aslot + 6 * c * kAChunk + (lane >> 4) * kAChunk +
                        ((warp & 3) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * 16;
#pragma unroll
  for (int nt = 0; nt < N / 8; nt += 2) {
    uint32_t pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int z = 0; z < 4; ++z) {
      const int ch = nt + (z >> 1);
      if (ch < N / 8) {
        const int v = 4 * ch + 2 * (z & 1);
        pk[z] = pack_rn(fmaxf(acc[v], kSlope * acc[v]), fmaxf(acc[v + 1], kSlope * acc[v + 1]));
        if (!inner && !(8 * ch < cl && ((z & 1) ? ok1 : ok0))) pk[z] = 0u;
      }
    }
    if (nt + 1 < N / 8) {
      stmatrix_x4(base + nt * kAChunk, pk[0], pk[1], pk[2], pk[3]);
    } else {
      stmatrix_x2(base + nt * kAChunk, pk[0], pk[1]);
    }
  }
}

__global__ void __launch_bounds__(kW1Threads, 1) k2b_w1_kernel(const __grid_constant__ W1Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* aslots = ring + kW1Stages * kW1GStage;
  unsigned char* kinds = aslots + 2 * kASlot;          // at E = 8 X's last 8 columns
  unsigned char* xslots = kinds + kW1Kinds * kXChunk8;  // else X, two slots
  unsigned char* hslots = xslots + 2 * 4 * kXChunk8;
  uint64_t* g_full = reinterpret_cast<uint64_t*>(hslots + 2 * kW1HSlot);
  uint64_t* g_empty = g_full + kW1Stages;
  uint64_t* w_full = g_empty + kW1Stages;
  Item* ask_s = reinterpret_cast<Item*>(w_full + 2);  // the producer's next item

  const HArgs& h = a.h;
  const W0Geo& geo = a.geo;
  const int total = (int)((long long)h.n * geo.npass * a.notiles * a.units);
  const int x0 = blockIdx.x * a.per_cta;
  const int x1 = min(total, x0 + a.per_cta);
  const int nx = x1 - x0;  // the CTA's items
  const int warp = warp_index();
  const int c = warp >> 2;  // the warpgroup: tap c, a's columns from 48 c on
  const Lane l;

  if (threadIdx.x == 0) {
    for (int k = 0; k < kW1Stages; ++k) {
      mbar_init(&g_full[k], 1);
      mbar_init(&g_empty[k], 12);  // one arrival per warp
    }
    for (int k = 0; k < 2; ++k) mbar_init(&w_full[k], 1);
    fence_barrier_init();
  }
  // g's rows 62 and 63 zero; every a's (the slots', past E = 8 the stages')
  // rows 64 .. 71 zero and chunk 17 1 (bf16) in column 136 of each row; at
  // E = 8 the six kinds of X's last 8 columns (1, -[u == 0], -[u == T-1],
  // zeros) of a unit's rows u = t0 - 1 + q: kind & 1 a batch row's first
  // unit (u = 0 at q = 1), kind / 2 = 1 its last (u = T-1 at q = T - t0 of
  // the last unit), 2 the unit before where its halo row holds u = T-1
  // (q = 63, where T = 1 mod 62)
  for (int idx = threadIdx.x; idx < kW1Stages * 2 * 8; idx += kW1Threads) {
    *reinterpret_cast<uint4*>(ring + (idx >> 4) * kW1GStage + kW1GBytes + (idx & 15) * 16) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = threadIdx.x; idx < (2 + kW1Stages) * 18 * kARows; idx += kW1Threads) {
    const int q = idx % kARows, ch = (idx / kARows) % 18, sl = idx / (18 * kARows);
    unsigned char* as = sl < 2 ? aslots + sl * kASlot : ring + (sl - 2) * kW1GStage + kRows * 128;
    if (ch == 17 || q >= kRows) {
      *reinterpret_cast<uint4*>(as + ch * kAChunk + q * 16) =
          make_uint4(ch == 17 ? 0x3F80u : 0u, 0u, 0u, 0u);
    }
  }
  if (a.vec) {
    const int q_last = h.T - (a.nsub - 1) * kOwn;  // the row u = T - 1 of the last unit
    for (int idx = threadIdx.x; idx < kW1Kinds * kRows; idx += kW1Threads) {
      const int kind = idx / kRows, q = idx % kRows;
      const bool first = (kind & 1) && q == 1;
      const bool last = (kind >> 1 == 1 && q == q_last) || (kind >> 1 == 2 && q == kRows - 1);
      *reinterpret_cast<uint4*>(kinds + idx * 16) =
          make_uint4(0x3F80u | (first ? 0xBF800000u : 0u), last ? 0xBF80u : 0u, 0u, 0u);
    }
  }
  fence_proxy_async();
  __syncthreads();

#ifdef COND_CHAIN_TIMERS
  long long tw[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};  // as g_timers from kW1Timers
  const long long t_all = clock64();
#endif
  // the producer: item n's (the CTA's n-th) g rows t0 .. t0 + 61 (TMA, zeros
  // outside [0, T) and past 2C) into its stage and, at E = 8, its exc rows
  // t0 - 2 .. t0 + 63 (zeros outside [0, T)) or past E = 8 its a rows
  // t0 - 1 .. t0 + 62 (17 boxes of 8 columns of the scratch), once every
  // warp is done with the item kW1Stages before
  const bool producer = threadIdx.x == 0;
  const uint32_t gbytes =
      kW1GBytes + (a.vec ? kW1XRows * 16 : 0) + (a.wide ? 17 * kRows * 16 : 0);
  auto ask_next = [&](int n) {
    Item ask = *ask_s;
    const int st = n % kW1Stages;
    unsigned char* stage = ring + st * kW1GStage;
    TIMER_START(t_ge);
    mbar_wait(&g_empty[st], (uint32_t)(((n / kW1Stages) & 1) ^ 1));
    TIMER_ADD(tw[8], t_ge);
    mbar_arrive_expect_tx(&g_full[st], gbytes);
    tma_load_4d(stage, &a.g_map, &g_full[st], ask.ot * 64, ask.i, ask.t0, ask.b);
    if (a.vec) tma_load_3d(stage + kRows * 128, &a.x_map, &g_full[st], 0, ask.t0 - 2, ask.b);
    if (a.wide) {
      for (int q = 0; q < 17; ++q) {
        tma_load_3d(stage + kRows * 128 + q * kAChunk, &a.a_map, &g_full[st],
                    ask.i * h.cc + ask.p * kPass + 8 * q, ask.t0 - 1, ask.b);
      }
    }
    ask.next(a);
    *ask_s = ask;
  };
  if (producer) {
    prefetch_map(&a.g_map);
    if (a.vec) prefetch_map(&a.x_map);
    if (a.wide) prefetch_map(&a.a_map);
    *ask_s = Item(a, x0);
    for (int n = 0; n < kW1Ahead && n < nx; ++n) ask_next(n);
  }

  // the recompute's state (E <= 8): the unit whose a is recomputed next
  // (one ahead of the products), the image in use (slot f & 1) and the
  // first unit of the next one; the first image fetched by the first
  // thread before the loop, each next one once every warp is past the
  // first unit of the one before (the slot it takes held the image before
  // that)
  auto fetch = [&](const Item& it, int f) {
    mbar_arrive_expect_tx(&w_full[f & 1], (uint32_t)geo.h_chunk);
    bulk_load(hslots + (f & 1) * kW1HSlot,
              reinterpret_cast<const unsigned char*>(a.img_h) +
                  (h.hbias_bstride ? (size_t)it.b * geo.h_image : 0) +
                  (size_t)(it.i * geo.npass + it.p) * geo.h_chunk,
              (uint32_t)geo.h_chunk, &w_full[f & 1]);
  };
  Item rc(a, x0);
  int img_x = x0, f = -1;
  bool new_img = false;  // the last recompute issued started an image
  auto skip_image = [&]() {
    const Item key(a, img_x);
    Item nx2 = key;
    do {
      nx2.next(a);
    } while (nx2.x < x1 && nx2.same_image(key, h));
    img_x = nx2.x;
  };
  if (!a.wide && producer) fetch(rc, 0);
  // issues unit rc's recompute (item m of the CTA) into hacc: waits for its
  // stage (at E = 8) or copies its X (else), and for its image where it is
  // the first to use it
  float hacc[24];
  auto h_issue = [&](int m) {
    const int st = m % kW1Stages;
    unsigned char* stage = ring + st * kW1GStage;
    TIMER_START(t_x);
    uint64_t xd0, xd1;
    if (a.vec) {
      mbar_wait(&g_full[st], (uint32_t)((m / kW1Stages) & 1));
      const uint32_t xe = smem_u32(stage + kRows * 128);
      const int kind = (rc.t0 == 0) + (rc.t0 + kOwn >= h.T ? 2 : rc.t0 + kOwn == h.T - 1 ? 4 : 0);
      const uint32_t xb = smem_u32(kinds + kind * kXChunk8);
      xd0 = make_desc(xe, 16, 128, kLayoutNone);
      xd1 = make_desc(xe + 32, xb - xe - 32, 128, kLayoutNone);
    } else {
      unsigned char* xw = xslots + (m & 1) * 4 * kXChunk8;
      const int ct = threadIdx.x;
      if (ct < 4 * kRows) {  // chunk ct / 64, row ct % 64
        *reinterpret_cast<uint4*>(xw + (ct >> 6) * kXChunk8 + (ct & 63) * 16) =
            x_chunk(h, rc.b, rc.t0 - 1 + (ct & 63), ct >> 6, false);
      }
      fence_proxy_async();
      bar_sync(1, kW1Threads);
      const uint32_t xs = smem_u32(xw);
      xd0 = make_desc(xs, kXChunk8, 128, kLayoutNone);
      xd1 = make_desc(xs + 2 * kXChunk8, kXChunk8, 128, kLayoutNone);
    }
    TIMER_ADD(tw[0], t_x);
    TIMER_START(t_f);
    if (rc.x == img_x) {
      ++f;
      new_img = true;
      skip_image();
      mbar_wait(&w_full[f & 1], (uint32_t)((f >> 1) & 1));
    }
    TIMER_ADD(tw[1], t_f);
    const uint32_t hb = smem_u32(hslots + (f & 1) * kW1HSlot);
    if (c < 2) {
      w1_h_issue<48>(*reinterpret_cast<float(*)[24]>(hacc), geo, c, xd0, xd1, hb);
    } else {
      w1_h_issue<40>(*reinterpret_cast<float(*)[20]>(hacc), geo, c, xd0, xd1, hb);
    }
  };
  auto a_store = [&](int m) {
    const uint32_t as = smem_u32(aslots + (m & 1) * kASlot);
    if (c < 2) {
      w1_a_store<48>(*reinterpret_cast<float(*)[24]>(hacc), h, l, c, as, rc.t0, rc.p, warp);
    } else {
      w1_a_store<40>(*reinterpret_cast<float(*)[20]>(hacc), h, l, c, as, rc.t0, rc.p, warp);
    }
    fence_proxy_async();
  };
  if (!a.wide) {
    // the first unit's a, then the second image's fetch
    h_issue(0);
    wgmma_wait<0>();
    a_store(0);
    rc.next(a);
    bar_sync(1, kW1Threads);
    if (producer && img_x < x1) fetch(Item(a, img_x), f + 1);
    new_img = false;
  }

  // the products of tap c: dW1_i[c][col][o] += sum_r g[t0 + r][o]
  // a[u0 + r + c][col], r < 64 (g's rows 62 and 63 zero), M = the tile's 64
  // columns o (A: the g stage, MN-major, 128-byte swizzle), N = 144 (B: a,
  // MN-major; tap c's B the slot's rows from c on: the descriptor 16 c bytes
  // on), K = 64 rows in 4 slices; db1 = D[o][136] of tap 1 (a's column of
  // ones). Per unit n: the products, then unit n + 1's share of the
  // recompute, one wait for both, a's store, one barrier of the three
  const size_t n2 = (size_t)h.n * a.two_c;
  float acc[kW1N / 2];
  int tau = x0 / a.units, k = x0 - tau * a.units;  // the unit's tile and place in it
  for (int n = 0; n < nx; ++n) {
    const int st = n % kW1Stages;
    unsigned char* stage = ring + st * kW1GStage;
    const bool ahead = !a.wide && n + 1 < nx;
    TIMER_START(t_gf);
    mbar_wait(&g_full[st], (uint32_t)((n / kW1Stages) & 1));
    TIMER_ADD(tw[2], t_gf);
    TIMER_START(t_p);
    const int fresh = n == 0 || k == 0;  // the segment's first unit
    const uint32_t gbase = smem_u32(stage);
    const uint32_t abase = smem_u32(a.wide ? stage + kRows * 128 : aslots + (n & 1) * kASlot) +
                           16 * c;
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < kRows / 16; ++sl) {
      wgmma_ss_n144<1, 1>(acc, make_desc(gbase + 2048 * sl, 8192, 1024, kLayoutSwizzle128),
                          make_desc(abase + 256 * sl, 128, kAChunk, kLayoutNone),
                          sl > 0 || !fresh);
    }
    wgmma_commit();
    TIMER_ADD(tw[3], t_p);
    if (ahead) h_issue(n + 1);
    if (producer && n + kW1Ahead < nx) ask_next(n + kW1Ahead);
    TIMER_START(t_pw);
    wgmma_wait<0>();
    fence_regs(acc);
    TIMER_ADD(tw[4], t_pw);
    if (ahead) {
      TIMER_START(t_s);
      a_store(n + 1);
      rc.next(a);
      TIMER_ADD(tw[5], t_s);
    }
    release(&g_empty[st]);
    // a of unit n + 1 whole; every warp past the products of unit n (the
    // slot unit n + 2 takes)
    TIMER_START(t_b);
    if (!a.wide) bar_sync(1, kW1Threads);
    TIMER_ADD(tw[6], t_b);
    if (new_img && producer && img_x < x1) fetch(Item(a, img_x), f + 1);
    new_img = false;
    if (++k < a.units && n + 1 < nx) continue;
    // the segment's end: its partial to slot blockIdx.x - first_cta(tau);
    // the tile's last CTA zeroes the slots after it
    TIMER_START(t_o);
    Item cur(a, tau * a.units);
    const int c0 = cur.p * kPass;
    const int cend = min(h.cc - c0, kPass);
    const int slot = blockIdx.x - first_cta(a, tau);
    const int last = (int)(((long long)(tau + 1) * a.units - 1) / a.per_cta);
    const int s_end = blockIdx.x == last ? a.nslots : slot + 1;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = cur.ot * 64 + l.row + 8 * half;
      if (o >= a.two_c) continue;
      const size_t col = (size_t)cur.i * a.two_c + o;
      for (int sx = slot; sx < s_end; ++sx) {
        float* part = a.pw1 + (((size_t)sx * 3 + c) * h.cc + c0) * n2 + col;
#pragma unroll
        for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cx = 8 * nt + 2 * l.tig + e;
            if (cx < cend) part[(size_t)cx * n2] = sx == slot ? acc[4 * nt + 2 * half + e] : 0.f;
          }
        }
        if (cur.p == 0 && c == 1 && l.tig == 0) {
          a.pb1[(size_t)sx * n2 + col] = sx == slot ? acc[68 + 2 * half] : 0.f;
        }
      }
    }
    TIMER_ADD(tw[7], t_o);
    k = 0;
    ++tau;
  }
#ifdef COND_CHAIN_TIMERS
  if (c == 1 && l.wt == 0) {
    for (int x = 0; x < 8; ++x) atomicAdd(&g_timers[kW1Timers + x], (unsigned long long)tw[x]);
    atomicAdd(&g_timers[kW1Timers + 8], (unsigned long long)(clock64() - t_all));
    atomicAdd(&g_timers[kW1Timers + 9], 1ull);
  }
  if (producer) {
    atomicAdd(&g_timers[kW1Timers + 10], (unsigned long long)tw[8]);
    atomicAdd(&g_timers[kW1Timers + 11], (unsigned long long)(clock64() - t_all));
    atomicAdd(&g_timers[kW1Timers + 12], 1ull);
  }
#endif
}

// k2b_xdh_kernel's shared memory: a ring of kXStages stages of 64 rows x 256
// columns of dh in four 128-byte swizzled boxes (two per warpgroup); two
// slots of the step's X (64 rows x 32 columns, each 8-column chunk holding
// its rows 16 bytes apart); the barriers. Two CTAs an SM.
constexpr int kXStages = 3;
constexpr int kXCols = 128;                     // columns of dh (M) a warpgroup
constexpr int kXStage = 4 * kGBytes;            // 32768
constexpr int kXK = 32;                         // columns of X (N) a CTA
constexpr int kXTile = kXK / 8 * kRows * 16;    // 4096
constexpr size_t kXSmem = (size_t)kXStages * kXStage + 2 * kXTile + 16 * kXStages + 1024;
static_assert(2 * kXSmem <= kSmemMax + 1024, "k2b_xdh_kernel: two CTAs an SM");

struct XArgs {
  HArgs h;
  float* pw0;          // (B parts, K, n*Cc): X^T dh per part of a batch row
  int parts, prows, kx;  // parts a batch row, rows a part (a multiple of 64), K = 3E + 3
  int vec;             // E a multiple of 8 and exc 16-byte aligned: taps as 16-byte loads
  CUtensorMap dh_map;  // the dh scratch as (c: n Cc, 1, t: T, b: B), box (64, 1, 64, 1)
};

__global__ void __launch_bounds__(kThreads, 2) k2b_xdh_kernel(const __grid_constant__ XArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* xt = ring + kXStages * kXStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(xt + 2 * kXTile);
  uint64_t* empty = full + kXStages;

  const HArgs& h = a.h;
  const int col0 = blockIdx.x * 2 * kXCols;  // the CTAs of one part's rows run together
  const int s = blockIdx.y;                  // (batch row, part)
  const int b = s / a.parts;
  const int r0 = (s - b * a.parts) * a.prows;
  const int r1 = min(h.T, r0 + a.prows);
  const int nsteps = (r1 - r0 + 63) / 64;
  const int k0 = blockIdx.z * kXK;
  const int warp = warp_index();
  const Ring rg{kXStages};

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
        const int st = rg.slot(n);
        unsigned char* dst = ring + st * kXStage;
        mbar_wait(&empty[st], rg.parity(n) ^ 1);
        mbar_arrive_expect_tx(&full[st], kXStage);
        for (int q = 0; q < 4; ++q) {
          tma_load_4d(dst + q * kGBytes, &a.dh_map, &full[st], col0 + 64 * q, 0, r0 + 64 * n, b);
        }
      }
    }
    return;
  }

  const int wg = warp >> 2;
  const Lane l;
  const int n0 = h.n * h.cc;
  // X[t0 + r][k0 + kk] of a step, zero past the part's rows: thread ct builds
  // row r = ct / 4, columns kq .. kq + 7 (one tap of exc when `tap`: a 16-byte load)
  const int ct = threadIdx.x;
  const int kq = k0 + 8 * (ct & 3);
  const int tj = (kq >= h.E) + (kq >= 2 * h.E);
  const bool tap = a.vec && kq + 8 <= 3 * h.E;
  const bf16* src = h.exc + (size_t)b * h.T * h.E + (kq - tj * h.E);
  const uint32_t xt_u = smem_u32(xt);
  auto build = [&](int t0, int slot) {
    const int u = t0 + (ct >> 2);
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (u < r1) {
      if (tap) {
        const int t = u + tj - 1;
        if (t >= 0 && t < h.T) w = *reinterpret_cast<const uint4*>(src + (size_t)t * h.E);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[e] = x_at(h, b, u, kq + 2 * e) | (x_at(h, b, u, kq + 2 * e + 1) << 16);
        }
        w = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    *reinterpret_cast<uint4*>(xt + slot * kXTile + (ct & 3) * (kRows * 16) + (ct >> 2) * 16) = w;
  };
  // D^T[c][k] = sum_r dh[t0 + r][c] X[t0 + r][k]: M = 64 columns of dh (A:
  // a TMA box, MN-major), N = 32 columns of X (B: MN-major), K = 64 rows
  float acc[2][kXK / 2];
  zero(acc[0]);
  zero(acc[1]);
  build(r0, 0);
  for (int n = 0; n < nsteps; ++n) {
    fence_proxy_async();
    bar_sync(1, 256);  // the step's X in place; every warp done with the last step's
    const int st = rg.slot(n);
    mbar_wait(&full[st], rg.parity(n));
    const uint32_t abase = smem_u32(ring + st * kXStage + wg * 2 * kGBytes);
    const uint32_t xbase = xt_u + (n & 1) * kXTile;
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < 4; ++sl) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        wgmma_ss_n32<1, 1>(acc[m],
                           make_desc(abase + m * kGBytes + 2048 * sl, 8192, 1024, kLayoutSwizzle128),
                           make_desc(xbase + 256 * sl, 128, kRows * 16, kLayoutNone), 1);
      }
    }
    wgmma_commit();
    if (n + 1 < nsteps) build(r0 + 64 * (n + 1), (n + 1) & 1);
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    release(&empty[st]);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int r = 0; r < kXK / 2; ++r) {
      const int c = col0 + wg * kXCols + 64 * m + l.row + 8 * ((r >> 1) & 1);
      const int k = k0 + 8 * (r >> 2) + 2 * l.tig + (r & 1);
      if (k < a.kx && c < n0) a.pw0[((size_t)s * a.kx + k) * n0 + c] = acc[m][r];
    }
  }
}

// One job of k2b_reduce_kernel: out[o*len + k] = bf16(sum_{s < S} part[o*ostride
// + s*sstride + k]), s in order, for o < outer, k < len.
struct ReduceJob {
  const float* part;
  bf16* out;
  long long len, sstride, ostride, first;  // first: its first element in the launch
  int outer, S;
};
constexpr int kMaxJobs = 7;
struct ReduceArgs {
  ReduceJob job[kMaxJobs];
  int n;
  long long total;
};

__global__ void k2b_reduce_kernel(const __grid_constant__ ReduceArgs r) {
  const long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (x >= r.total) return;
  int j = 0;
  while (j + 1 < r.n && x >= r.job[j + 1].first) ++j;
  const ReduceJob& jb = r.job[j];
  const long long e = x - jb.first;
  const long long o = e / jb.len;
  const long long k = e - o * jb.len;
  const float* p = jb.part + o * jb.ostride + k;
  float acc = 0.f;
  for (int s = 0; s < jb.S; ++s) acc += p[(long long)s * jb.sstride];
  jb.out[o * jb.len + k] = __float2bfloat16_rn(acc);
}

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// Everything the launch needs, from the shapes alone; ok = false for shapes
// the kernels do not take. Offsets are in bytes of the workspace.
struct Plan {
  bool ok, narrow;                          // narrow: E <= 8, X^T dh in (a)
  int noc, ntiles, run, nruns;              // (a): runs of `run` tiles a batch row
  W0Geo geo;
  long long ld;                             // the dh and a scratches' row stride (E > 8)
  int notiles, nsub, units, per_cta, w1_ctas, s1;  // (b): s1 partial slots
  int kx, xcols, xks, parts, prows, s0;     // (c), and X^T dh's partials: parts a batch row
  size_t off_dh, off_a, off_dexc, off_pb1, off_pw1, off_pw0, off_imh, off_imx, total;
};

Plan make_plan(int B, int T, int E, int n, int cc, int two_c) {
  Plan p{};
  p.ok = false;
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 8 || (long long)B * (T + 1) > (1LL << 30)) {
    return p;
  }
  p.geo = w0_geo(E, n, cc);
  p.narrow = E <= 8;
  p.noc = (two_c + 63) / 64;
  p.ntiles = (T + kTile - 1) / kTile;
  // (a): a CTA per (run of tiles, batch row, block and pass); runs of at
  // most kRunTiles tiles, more of them while the CTAs would not fill two
  // waves of the card
  const long long units_a = (long long)B * n * p.geo.npass;
  int runs = (p.ntiles + kRunTiles - 1) / kRunTiles;
  while (units_a * runs < 2 * kSmCount && runs < p.ntiles) ++runs;
  p.run = (p.ntiles + runs - 1) / runs;
  p.nruns = (p.ntiles + p.run - 1) / p.run;
  const size_t R = (size_t)B * T, n0 = (size_t)n * cc, n2 = (size_t)n * two_c;
  p.ld = (long long)(n0 + 7) / 8 * 8;
  // (b): the items (tile of (block, pass, 64 columns of g), unit of 62
  // rows) in equal runs over one wave of the card's SMs; a tile's units go
  // to consecutive CTAs, each writing the partial of its segment into the
  // next slot (s1: the most segments of any tile)
  p.notiles = (two_c + 63) / 64;
  p.nsub = (T + kOwn - 1) / kOwn;
  p.units = B * p.nsub;
  const long long tiles = (long long)n * p.geo.npass * p.notiles;
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
    // X^T dh in (a): a partial per (batch row, run)
    p.parts = p.nruns;
  } else {
    // (c): (batch row, part) chunks times (256 columns of dh, 32 columns of
    // X) tiles, at least two CTAs an SM
    p.xcols = (int)((n0 + 2 * kXCols - 1) / (2 * kXCols));
    p.xks = (p.kx + kXK - 1) / kXK;
    const long long per_b = (long long)B * p.xcols * p.xks;
    const int parts = (int)std::min<long long>(
        std::max<long long>(1, (2 * kSmCount + per_b - 1) / per_b), 65535 / B);
    p.prows = ((T + parts - 1) / parts + 63) / 64 * 64;
    p.parts = (T + p.prows - 1) / p.prows;
  }
  p.s0 = B * p.parts;
  p.off_dh = 0;
  p.off_a = align256(p.off_dh + (p.narrow ? 0 : R * p.ld * 2));
  p.off_dexc = align256(p.off_a + (p.narrow ? 0 : R * p.ld * 2));
  const size_t nparts = (size_t)n * p.geo.npass;  // dexc's partials: one a block and pass
  p.off_pb1 = align256(p.off_dexc + (nparts > 1 ? nparts * R * E * 4 : 0));
  p.off_pw1 = align256(p.off_pb1 + (size_t)p.s1 * n2 * 4);
  p.off_pw0 = align256(p.off_pw1 + (size_t)p.s1 * 3 * cc * n2 * 4);
  p.off_imh = align256(p.off_pw0 + (size_t)p.s0 * p.kx * n0 * 4);
  p.off_imx = align256(p.off_imh + (size_t)B * p.geo.h_image);
  p.total = align256(p.off_imx + p.geo.x_bytes);
  p.ok = true;
  return p;
}

// the job of an (outer, len) sum of partials S apart at `part`
void add_job(ReduceArgs& r, const float* part, void* out, long long len, int outer, int S,
             long long sstride, long long ostride) {
  ReduceJob& j = r.job[r.n++];
  j.part = part;
  j.out = static_cast<bf16*>(out);
  j.len = len;
  j.outer = outer;
  j.S = S;
  j.sstride = sstride;
  j.ostride = ostride;
  j.first = r.total;
  r.total += len * outer;
}

// Device time of each of a call's launches (four, five past E = 8), for
// measurement (smoke phase 14): while on, a call records an event before
// its first launch and after each one, on its stream
bool g_timed = false;
cudaEvent_t g_marks[6];
int g_launched = 0;  // the last timed call's launches

}  // namespace

// Times the kernels of the calls that follow (on != 0) or stops (0); the
// events are made at the first call that turns it on.
extern "C" int cond_chain_bwd_bf16_time_kernels(int on) {
  if (on && g_marks[0] == nullptr) {
    for (cudaEvent_t& e : g_marks) {
      const cudaError_t err = cudaEventCreate(&e);
      if (err != cudaSuccess) return (int)err;
    }
  }
  g_timed = on != 0;
  return 0;
}

// ms[0..3] or [0..4]: the last timed call's w_images_kernel,
// k2b_data_kernel, k2b_w1_kernel, past E = 8 k2b_xdh_kernel, and
// k2b_reduce_kernel, each from the end of the launch before it (synchronize
// first)
extern "C" int cond_chain_bwd_bf16_kernel_ms(float* ms) {
  for (int k = 0; k < g_launched; ++k) {
    const cudaError_t err = cudaEventElapsedTime(&ms[k], g_marks[k], g_marks[k + 1]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

#ifdef COND_CHAIN_TIMERS
// The diagnostic build's cycle sums since the last reset (kTimers of them:
// the data kernel's phases, see g_timers) into out; then zero them where
// `reset`.
extern "C" int cond_chain_bwd_bf16_timers(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_timers, sizeof(g_timers));
  if (e == cudaSuccess && reset) {
    const unsigned long long zeros[kTimers] = {};
    e = cudaMemcpyToSymbol(g_timers, zeros, sizeof(zeros));
  }
  return (int)e;
}
#endif

// The rows of the data kernel's time tile at these widths (124: every width
// goes in passes of 136 columns), or 0 for shapes the kernels do not take.
extern "C" int cond_chain_bwd_bf16_rows(int B, int T, int E, int n, int cc, int two_c) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  return p.ok ? kTile : 0;
}

// Bytes of device scratch cond_chain_bwd_bf16 needs for these shapes (0 for
// shapes the kernels do not take).
extern "C" long long cond_chain_bwd_bf16_workspace(int B, int T, int E, int n, int cc,
                                                   int two_c) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  return p.ok ? (long long)p.total : 0;
}

// Launches K2-bf16's kernels on `stream` and returns the first CUDA error (0
// on success); shapes the kernels do not take (2C not a multiple of 8, Cc
// not a multiple of 4), too little workspace, g or w1 not 16-byte aligned,
// or a tensor map cuTensorMapEncodeTiled refuses give cudaErrorInvalidValue. Every
// tensor is bf16; w1 is in its own (3, Cc, n*2C) layout. dhbias is (B,
// n*Cc), or (n*Cc) when hbias_bstride is 0; dedge0/dedge_t are written when
// edge0 is given.
extern "C" int cond_chain_bwd_bf16(const void* exc, const void* w0, const void* hbias,
                                   long long hbias_bstride, const void* edge0,
                                   const void* edge_t, const void* w1, const void* g,
                                   void* dexc, void* dw0, void* dhbias, void* dedge0,
                                   void* dedge_t, void* dw1, void* db1, void* ws,
                                   long long ws_bytes, int B, int T, int E, int n, int cc,
                                   int two_c, void* stream_ptr) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  if (!p.ok || ws_bytes < (long long)p.total || (edge0 == nullptr) != (dedge0 == nullptr) ||
      (uintptr_t)w1 % 16 || (uintptr_t)g % 16) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const long long n0 = (long long)n * cc;
  const long long n2 = (long long)n * two_c;
  unsigned char* wsb = static_cast<unsigned char*>(ws);
  bf16* dh_s = reinterpret_cast<bf16*>(wsb + p.off_dh);
  float* pb1 = reinterpret_cast<float*>(wsb + p.off_pb1);
  float* pw1 = reinterpret_cast<float*>(wsb + p.off_pw1);
  float* pw0 = reinterpret_cast<float*>(wsb + p.off_pw0);

  HArgs h;
  h.exc = static_cast<const bf16*>(exc);
  h.w0 = static_cast<const bf16*>(w0);
  h.hbias = static_cast<const bf16*>(hbias);
  h.hbias_bstride = hbias_bstride;
  h.edge0 = static_cast<const bf16*>(edge0);
  h.edge_t = static_cast<const bf16*>(edge_t);
  h.T = T;
  h.E = E;
  h.n = n;
  h.cc = cc;
  DataArgs d;
  d.h = h;
  d.img_h = reinterpret_cast<const bf16*>(wsb + p.off_imh);
  d.img_x = reinterpret_cast<const bf16*>(wsb + p.off_imx);
  d.dh_out = dh_s;
  d.a_out = reinterpret_cast<bf16*>(wsb + p.off_a);
  d.ld = p.ld;
  d.pdexc = reinterpret_cast<float*>(wsb + p.off_dexc);
  d.dexc = static_cast<bf16*>(dexc);
  d.pw0 = pw0;
  d.two_c = two_c;
  d.noc = p.noc;
  d.run = p.run;
  d.nruns = p.nruns;
  d.kx = p.kx;
  d.vec = E == 8 && (uintptr_t)exc % 16 == 0;
  d.geo = p.geo;
  W1Args w;
  w.h = h;
  w.img_h = d.img_h;
  w.pw1 = pw1;
  w.pb1 = pb1;
  w.two_c = two_c;
  w.notiles = p.notiles;
  w.nsub = p.nsub;
  w.units = p.units;
  w.per_cta = p.per_cta;
  w.nslots = p.s1;
  w.vec = E == 8 && (uintptr_t)exc % 16 == 0;
  w.wide = !p.narrow;
  w.geo = p.geo;
  XArgs x;
  x.h = h;
  x.pw0 = pw0;
  x.parts = p.parts;
  x.prows = p.prows;
  x.kx = p.kx;
  x.vec = E % 8 == 0 && (uintptr_t)exc % 16 == 0;
  const cuuint64_t o = (cuuint64_t)two_c, nn = (cuuint64_t)n;
  const cuuint64_t g_dims[4] = {o, nn, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t g_strides[3] = {o * 2, o * 2 * nn, o * 2 * nn * T};
  const cuuint32_t g_box[4] = {64, 1, (cuuint32_t)kRows, 1};
  const cuuint32_t g_box_w1[4] = {64, 1, (cuuint32_t)kOwn, 1};
  const cuuint64_t w_dims[4] = {o, nn, (cuuint64_t)cc, 3};
  const cuuint64_t w_strides[3] = {o * 2, o * 2 * nn, o * 2 * nn * cc};
  const cuuint32_t w_box[4] = {64, 1, (cuuint32_t)kPass, 1};
  const cuuint64_t ld2 = (cuuint64_t)p.ld * 2;
  const cuuint64_t x_dims[4] = {(cuuint64_t)n0, 1, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t x_strides[3] = {ld2, ld2, ld2 * T};
  const cuuint32_t x_box[4] = {64, 1, 64, 1};
  const cuuint64_t e_dims[3] = {8, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t e_strides[2] = {16, 16 * (cuuint64_t)T};
  const cuuint32_t e_box[3] = {8, (cuuint32_t)kW1XRows, 1};
  const cuuint64_t a_dims[3] = {(cuuint64_t)n0, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t a_strides[2] = {ld2, ld2 * T};
  const cuuint32_t a_box[3] = {8, (cuuint32_t)kRows, 1};
  if (!make_map(&d.g_map, g, 4, g_dims, g_strides, g_box) ||
      !make_map(&d.w1_map, w1, 4, w_dims, w_strides, w_box) ||
      !make_map(&w.g_map, g, 4, g_dims, g_strides, g_box_w1) ||
      (!p.narrow && !make_map(&x.dh_map, dh_s, 4, x_dims, x_strides, x_box)) ||
      (!p.narrow && !make_map(&w.a_map, d.a_out, 3, a_dims, a_strides, a_box, false)) ||
      (w.vec && !make_map(&w.x_map, exc, 3, e_dims, e_strides, e_box, false))) {
    return (int)cudaErrorInvalidValue;
  }
  ImageArgs im{h, nullptr, reinterpret_cast<bf16*>(wsb + p.off_imh),
               reinterpret_cast<bf16*>(wsb + p.off_imx), nullptr, hbias_bstride ? B : 1, two_c};
  int launched = 0;
  auto mark = [&]() {
    if (g_timed) cudaEventRecord(g_marks[launched], stream);
  };
  mark();
  cudaError_t e = launch_images(im, stream);
  if (e != cudaSuccess) return (int)e;
  ++launched;
  mark();
  const dim3 dgrid((unsigned)p.nruns, (unsigned)B, (unsigned)(n * p.geo.npass));
  e = p.narrow ? launch_kernel(k2b_data_kernel<true>, dgrid, kThreads, kDataSmem, d, stream)
               : launch_kernel(k2b_data_kernel<false>, dgrid, kThreads, kDataSmem, d, stream);
  if (e != cudaSuccess) return (int)e;
  ++launched;
  mark();
  if ((e = launch_kernel(k2b_w1_kernel, dim3((unsigned)p.w1_ctas), kW1Threads, kW1Smem, w,
                         stream)) != cudaSuccess) return (int)e;
  ++launched;
  mark();
  if (!p.narrow) {
    if ((e = launch_kernel(k2b_xdh_kernel,
                           dim3((unsigned)p.xcols, (unsigned)p.s0, (unsigned)p.xks), kThreads,
                           kXSmem, x, stream)) != cudaSuccess) return (int)e;
    ++launched;
    mark();
  }

  // dexc over the blocks and passes; dW1, db1 over the chunks of units; dW0
  // over every (batch row, part); dhbias, the edges over a batch row's parts
  // (dhbias over all of them when hbias is shared)
  ReduceArgs r{};
  const long long xs = (long long)p.kx * n0;
  if (n * p.geo.npass > 1) {
    const long long bte = (long long)B * T * E;
    add_job(r, reinterpret_cast<float*>(wsb + p.off_dexc), dexc, bte, 1, n * p.geo.npass, bte, 0);
  }
  add_job(r, pw1, dw1, 3LL * cc * n2, 1, p.s1, 3LL * cc * n2, 0);
  add_job(r, pb1, db1, n2, 1, p.s1, n2, 0);
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
  k2b_reduce_kernel<<<(unsigned)((r.total + 255) / 256), 256, 0, stream>>>(r);
  ++launched;
  mark();
  if (g_timed) g_launched = launched;
  return (int)cudaGetLastError();
}
