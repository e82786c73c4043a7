// FiLM conditioning chain, forward (K1), for one MRF stage's n FiLM blocks.
//
// Replaces td_vc_gan_tpu/ops/pallas/cond_chain.py::_fwd_kernel (launched by
// _pallas_fwd). It computes, in the split form the decoder feeds it
// (td_vc_gan_tpu/models/layers.py MRFBlock._split_film), per batch row b and
// time t:
//
//   h[t]     = sum_j exc[t+j-1] @ W0[j] + hbias - [t==0] edge0 - [t==T-1] edge_t
//   out_i[t] = sum_j lrelu(h_i)[t+j-1] @ W1_i[j] + b1_i        (i < n blocks)
//
// with exc and lrelu(h) zero outside [0, T) ('same' zero padding of both k=3
// convs). h_i is block i's Cc-column slice of h. The concat form
// (film_cond_chain) is the same kernel with exc = c, hbias = b0 broadcast over
// the batch (hbias_bstride = 0) and no edges.
//
// What bounds it on an H100: at the decoder's shapes the work is
// ~2*3*Cc*n*2C flops per output row against n*2C*4 bytes written, about 400
// flops per byte, far above the card's ridge even at the tensor cores'
// f32-accurate rate (165 TFLOP/s over 3.35 TB/s = 49 flops per byte): the
// chain is bound by operations. Its earlier design (warp-level mma.sync
// m16n8k8, operands by cp.async, split into hi and lo in shared memory by
// every thread) reached 24% of that bound: chains of small mma, fragment
// loads and splits cost more than the products.
//
// What the design does about it: Hopper's warpgroup products (wgmma tf32,
// tf32x3.cuh) with f32 accumulators in registers, every product 3xTF32
// (a.b ~ a.lo b.hi + a.hi b.lo + a.hi b.hi, the small terms first: f32
// accuracy at a third of the TF32 rate), and the n*Cc-wide h never in
// device memory. The CTA (cond_chain_f32.cuh): two consumer warpgroups of
// 64 rows of h each, 124 rows a CTA, one output chunk of W columns (grid z),
// and a producer warp whose one thread keeps bulk copies in flight through a
// ring of 3 stages of 24576 bytes: images of the weights that a small kernel
// (k1_images_kernel) lays out at each launch in the workspace, in the
// shared-memory layout the products read, split into hi and lo once there
// (no thread splits a weight): h's B (the header's img_h), two k-slices an
// item, and P's B, img_w1[i][oc][17 p + s], 24576 / (6 W 32) k-slices an item
// (4 at W = 32, 2 at 64, 1 at 128): for output chunk oc and the pass's k-slice
// s, W1_i[j] for the three taps as W rows x 8 k, the three taps' hi, then
// their lo. Per block i (and, in the general instances, per pass):
//  1. h on wgmma with X in registers (made from exc per k-slice; a slice's
//     three products a group, issued before the slice before it is waited
//     for); lrelu in f32, zero outside [0, T) and past Cc, split, into the
//     warpgroup's A image in shared memory (no swizzle: each 4-column chunk
//     holds the 64 rows 16 bytes apart);
//  2. P on wgmma, M = 64, K = the pass's columns in slices of 8. At the
//     decoder's E = 8, one pass and W <= 64 the three taps are P's N
//     (m64n96k8 at W = 32, m64n192k8 at 64): P_j = A @ W1_i[j], each A read
//     once a product, so that P's shared-memory reads (A and B a product)
//     stay under the card's 128 bytes a cycle; at W = 32 A's lo stays in
//     registers as the RS form's A (each slice's k order permuted to match
//     the accumulator's layout) and only A's hi is stored. Else (W = 128, and
//     the general instances) P = sum_j A_j @ W1_i[j], tap j's A the same
//     descriptor 16 j bytes further on (the image one or two rows down);
//  3. P staged in the warpgroup's A space, then out[t] = b1 + P_0[r] +
//     P_1[r + 1] + P_2[r + 2] (taps as N) or b1 + P[r] from it, a warp
//     storing whole rows; at E = 8 under the next block's first slice of h.
// The general instances (kWide: K = 3E + 3 past 32 or Cc past one pass) sum
// P over the passes in one accumulator, W <= 64, and store A in two parts,
// the second under P's first products. h is computed once per tile and
// output chunk: at 2C = 256 (two chunks of 128) twice, with twice the CTAs in
// flight, since P staged takes A's space. Shared memory does not grow with
// Cc or E: one tile for every width. Every instance keeps within the 168
// registers of a 9-warp CTA without a spill: h's X is made per slice and at
// most two slices' registers are held, and the output's row steps are a loop
// in the general instances.
//
// Numerics: 3xTF32 products into f32 accumulators, no TF32-only product; the
// bias and the edges enter h as products with 1 (hi + lo); the sums run in
// another order than cuDNN's or XLA's, so results agree with the plain
// version to rounding (tolerances are stated by the callers). Inputs with
// at most 11 significant bits are multiplied exactly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

#include <cstdint>

#include "cond_chain_f32.cuh"

namespace {

using namespace f32chain;

constexpr int kStages = 3;
constexpr int kAChunk = kRows * 16;         // 1024: 4 columns of A, every row; A's LBO
constexpr int kAImage = (kPass / 4) * kAChunk;  // 34816: A, hi or lo
// A's hi and lo images and one chunk after them, which the last tap's window
// reads two rows into (rows that feed only output rows the warpgroup drops)
constexpr int kABytes = 2 * kAImage + kAChunk;
constexpr int kSlot = 3 * 2 * 128 * 32;     // 24576: a ring slot
constexpr int kHPer = 2;  // h's k-slices a ring item (2 x 8704 bytes), issued a slice at a time
constexpr size_t kSmem = (size_t)kStages * kSlot + 2 * (size_t)kABytes + 16 * kStages + 1024;
static_assert(kSmem <= kSmemMax, "K1's shared memory");
static_assert(kHPer * 2 * kHItem <= kSlot, "h's ring items fit a slot");

// A diagnostic build (-DCOND_CHAIN_TIMERS) sums clock64 cycles by phase over
// the launch, read by cond_chain_fwd_f32_timers: each consumer warpgroup's h
// (its products with their waits on full, the next block's first slice
// counted here too though the output is stored under it), h's waits on full
// (also counted alone), A (lrelu, the split and the stores of A's image),
// the barriers around A, P's products (the waits on full apart), P's waits
// on full, the output (P staged, then stored) and the whole kernel; the
// producer's waits on empty and its whole. The normal build has none.
#ifdef COND_CHAIN_TIMERS
constexpr int kTimers = 12;  // h, h's waits, A, barriers, P, P's waits, out, whole,
                             // warpgroups, producer wait, whole, producers
__device__ unsigned long long g_timers[kTimers];
#define TIMER_START(v) const long long v = clock64()
#define TIMER_ADD(acc, since) acc += clock64() - since
#else
#define TIMER_START(v)
#define TIMER_ADD(acc, since)
#endif

struct Args {
  HArgs h;
  const float* b1;              // (n*2C)
  float* out;                   // (B, T, n*2C)
  const unsigned char* img_h;   // h's B (cond_chain_f32.cuh)
  const unsigned char* img_w1;  // P's B (above)
  long long h_image;            // bytes of one batch row's img_h (0: one for every row)
  int two_c, noc;               // output columns, chunks of W of them
};

// d += A B^T for P's N = NW columns (W, or the three taps' 3W)
template <int NW>
__device__ __forceinline__ void wgmma_p(float (&d)[NW / 2], uint64_t da, uint64_t db) {
  if constexpr (NW == 192) {
    tf32x3::wgmma_ss_n192(d, da, db, 1);
  } else if constexpr (NW == 128) {
    tf32x3::wgmma_ss_n128(d, da, db, 1);
  } else if constexpr (NW == 96) {
    tf32x3::wgmma_ss_n96(d, da, db, 1);
  } else if constexpr (NW == 64) {
    tf32x3::wgmma_ss_n64(d, da, db, 1);
  } else {
    tf32x3::wgmma_ss_n32(d, da, db, 1);
  }
}

// Waits for ring item k; returns its slot
__device__ __forceinline__ int take(uint64_t* full, int& k) {
  const int slot = slot_of<kStages>(k);
  mbar_wait(&full[slot], parity_of<kStages>(k));
  ++k;
  return slot;
}

// Issues h's products of one k-slice of Wh at `base` (hi, then lo) with X's
// registers x into hacc (X.lo Wh.hi, X.hi Wh.lo, X.hi Wh.hi, as the
// header's h_pass) as one group
__device__ __forceinline__ void h_slice(float (&hacc)[68], const XFrag& x, uint32_t base) {
  wgmma_fence();
  tf32x3::wgmma_rs_n136(hacc, x.lo, desc(base, 128, 256), 1);
  tf32x3::wgmma_rs_n136(hacc, x.hi, desc(base + kHItem, 128, 256), 1);
  tf32x3::wgmma_rs_n136(hacc, x.hi, desc(base, 128, 256), 1);
  wgmma_commit();
}

// W: output columns a chunk. kWide: the general instance, for K = 3E + 3
// past 32 or Cc past one pass: P summed over the passes in one accumulator
// (W <= 64). Else (the decoder's E = 8 at one pass) P's taps side by side
// where W <= 64.
template <int W, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) k1_f32_kernel(const __grid_constant__ Args a) {
  // P's three taps side by side as its N (an accumulator each) where their
  // 3W columns fit one product and the registers; else summed in one
  // accumulator with A's rows shifted by the tap
  constexpr bool kTapsN = !kWide && W <= 64;
  constexpr int kNT = kTapsN ? 3 : 1;  // taps in P's accumulator
  constexpr int kN = kNT * W;          // P's N
  constexpr int kWItem = 6 * W * 32;   // a k-slice of W1's three taps, hi and lo
  constexpr int kWPer = kSlot / kWItem;  // W1's k-slices a ring item: 24576 bytes at every W
  constexpr int kLds = kN + 8;         // floats a row of P staged for the output
  // the output's row steps unrolled (in the general instances a loop: their
  // registers are needed elsewhere)
  constexpr bool kOutUnroll = !kWide;
  // At W = 32 with the taps as N, A's lo parts stay in registers as the A of
  // P's lo.hi products (wgmma's RS form): only A's hi is stored, and each
  // k-slice's k order is permuted so that the registers of h's accumulator
  // are that A as they lie: position k holds the slice's column perm(k) =
  // 2k (k < 4), 2(k - 4) + 1 (k >= 4), in A's hi and in W1's image alike
  constexpr bool kLoRegs = kTapsN && W == 32;
  // A stored in two parts, the second under P's first products, in the
  // general instances (where h, long at wide E, leaves P's items waiting;
  // at E = 8 the split costs more than it hides)
  constexpr bool kASplit = kWide;
  // the output's rows read of P staged: up to 63 + 2 (taps), within A's space
  static_assert(kWPer >= 1 && (kRows + 2) * kLds * 4 <= kABytes, "ring items and P's stage fit");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* aimg = ring + kStages * kSlot;
  uint64_t* full = reinterpret_cast<uint64_t*>(aimg + 2 * kABytes);
  uint64_t* empty = full + kStages;

  const HArgs& h = a.h;
  const int npass = kWide ? h.npass : 1;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int oc = blockIdx.z;  // the CTA's chunk of W output columns
  const int warp = warp_index();

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: per block i and pass p, h's k-slices, kHPer an item, then
    // the pass's k-slices of W1 for the CTA's output chunk, kWPer an item
    if (threadIdx.x == 256) {
#ifdef COND_CHAIN_TIMERS
      long long t_w = 0;
      const long long t_all = clock64();
#endif
      const unsigned char* img_h = a.img_h + (size_t)b * a.h_image;
      int k = 0;
      for (int i = 0; i < h.n; ++i)
        for (int p = 0; p < npass; ++p) {
          const size_t h0 = ((size_t)i * h.npass + p) * h.nkh;
          for (int s = 0; s < h.nkh; s += kHPer) {
            TIMER_START(tw);
            put<kStages, kSlot>(ring, full, empty, k, img_h + (h0 + s) * 2 * kHItem,
                                min(kHPer, h.nkh - s) * 2 * kHItem);
            TIMER_ADD(t_w, tw);
          }
          const int ns = pass_slices(h, p);
          const size_t w0 = ((size_t)i * a.noc + oc) * h.npass * kPassSlices + p * kPassSlices;
          for (int s = 0; s < ns; s += kWPer) {
            TIMER_START(tw);
            put<kStages, kSlot>(ring, full, empty, k, a.img_w1 + (w0 + s) * kWItem,
                                min(kWPer, ns - s) * kWItem);
            TIMER_ADD(t_w, tw);
          }
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
  const int tb = t0 + kOwn * wg;  // the warpgroup's first own row
  const int u0 = tb - 1;          // its h row q = 0
  const Lane l;
  unsigned char* a_gen = aimg + wg * kABytes;
  const uint32_t a_hi = smem_u32(a_gen);
  float* ps = reinterpret_cast<float*>(a_gen);  // P staged for the output, in A's space
  const int n2 = h.n * a.two_c;

  // X's registers for h's k-slices in turn: xs[0] for slices 0, 2, ..,
  // xs[1] for 1, 3, .. (each made from exc as its slice is issued, kept until
  // its products are done)
  XFrag xs[2];
  float hacc[68];
  float pacc[kN / 2];
  int k = 0;
#ifdef COND_CHAIN_TIMERS
  long long tm[7] = {0, 0, 0, 0, 0, 0, 0};
  long long t_pw = 0;  // P's waits on full in the pass
  const long long t_all = clock64();
#endif

  // lrelu(h) of pass p, zero outside [0, T) and past Cc, split, into A for
  // the k-slices [s0, s1): element (q, c) at (c / 4) kAChunk + 16 q + 4 (c % 4);
  // then made visible to the products. Where kLoRegs (never split) every
  // slice: hi at the permuted positions, lo into alo.
  uint32_t alo[kLoRegs ? kPassSlices : 1][4];  // A's lo as P's RS operand (kLoRegs)
  auto a_store = [&](int p, int s0, int s1) {
#pragma unroll
    for (int nt = 0; nt < kPass / 8; ++nt) {
      if constexpr (kLoRegs) {
        // hi to positions tig (column 2 tig) and tig + 4 (2 tig + 1) of
        // slice nt; lo kept: alo[nt][v] = A[16 w + grp + 8 (v & 1)][tig + 4 (v >> 1)]
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const int u = u0 + q;
          const int c = nt * 8 + 2 * l.tig;
          const bool row_ok = u >= 0 && u < h.T;
          uint32_t hi[2], lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = hacc[nt * 4 + 2 * half + e];
            split(row_ok && kPass * p + c + e < h.cc ? (x >= 0.f ? x : kSlope * x) : 0.f,
                  hi[e], lo[e]);
            alo[kLoRegs ? nt : 0][half + 2 * e] = lo[e];
          }
          const int off = nt * 2 * kAChunk + q * 16 + l.tig * 4;
          *reinterpret_cast<uint32_t*>(a_gen + off) = hi[0];
          *reinterpret_cast<uint32_t*>(a_gen + off + kAChunk) = hi[1];
        }
      } else if (nt >= s0 && nt < s1) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const int u = u0 + q;
          const int c = nt * 8 + 2 * l.tig;
          const bool row_ok = u >= 0 && u < h.T;
          uint32_t hi[2], lo[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float x = hacc[nt * 4 + 2 * half + e];
            split(row_ok && kPass * p + c + e < h.cc ? (x >= 0.f ? x : kSlope * x) : 0.f,
                  hi[e], lo[e]);
          }
          const int off = (c >> 2) * kAChunk + q * 16 + (c & 3) * 4;
          *reinterpret_cast<uint2*>(a_gen + off) = make_uint2(hi[0], hi[1]);
          *reinterpret_cast<uint2*>(a_gen + kAImage + off) = make_uint2(lo[0], lo[1]);
        }
      }
    }
    fence_proxy_async();
  };
  // P's ring item of k-slices s0 .. (< ns): waited for (the wait counted in
  // the timers' t_pw), its products issued as one group; returns its slot
  auto p_item = [&](int s0, int ns) {
    TIMER_START(t_w);
    const int slot = take(full, k);
    TIMER_ADD(t_pw, t_w);
    const uint32_t base = smem_u32(ring + slot * kSlot);
    wgmma_fence();
#pragma unroll
    for (int ss = 0; ss < kWPer; ++ss) {
      if (s0 + ss < ns) {
        const uint32_t ah = a_hi + 2 * kAChunk * (s0 + ss);
        const uint32_t bh = base + ss * kWItem;
        if constexpr (kTapsN) {
          wgmma_p<kN>(pacc, desc(ah + kAImage, kAChunk, 128), desc(bh, 128, 256));
          wgmma_p<kN>(pacc, desc(ah, kAChunk, 128), desc(bh + 3 * W * 32, 128, 256));
          wgmma_p<kN>(pacc, desc(ah, kAChunk, 128), desc(bh, 128, 256));
        } else {
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const uint32_t aj = ah + 16 * j;
            const uint32_t bj = bh + j * W * 32;
            wgmma_p<kN>(pacc, desc(aj + kAImage, kAChunk, 128), desc(bj, 128, 256));
            wgmma_p<kN>(pacc, desc(aj, kAChunk, 128), desc(bj + 3 * W * 32, 128, 256));
            wgmma_p<kN>(pacc, desc(aj, kAChunk, 128), desc(bj, 128, 256));
          }
        }
      }
    }
    wgmma_commit();
    return slot;
  };
  // h's pass in two parts, so that the output of the block before is
  // stored while h's first k-slice is on the tensor cores. Its ring items
  // hold kHPer k-slices; a slice's products are a group, issued before the
  // slice before it is waited for, so that X's registers of two slices are
  // held at most. h_begin: hacc zeroed, slice 0 issued; h_end: the others,
  // then the last waited for.
  int hslot = 0;  // the slot of the item of the slice last issued
  auto h_begin = [&]() {
    TIMER_START(t_h);
    zero(hacc);
    TIMER_START(t_hw);
    hslot = take(full, k);
    TIMER_ADD(tm[1], t_hw);
    xs[0] = x_frag(h, b, u0, l, 0);
    h_slice(hacc, xs[0], smem_u32(ring + hslot * kSlot));
    TIMER_ADD(tm[0], t_h);
  };
  auto h_end = [&]() {
    TIMER_START(t_h);
    for (int s = 1; s < h.nkh; s += 2) {
      // slice s, the second of its item
      xs[1] = x_frag(h, b, u0, l, s);
      h_slice(hacc, xs[1], smem_u32(ring + hslot * kSlot) + 2 * kHItem);
      wgmma_wait<1>();
      if (s + 1 < h.nkh) {
        // slice s + 1, the first of the next item; then the item before is done
        TIMER_START(t_hw);
        const int slot = take(full, k);
        TIMER_ADD(tm[1], t_hw);
        xs[0] = x_frag(h, b, u0, l, s + 1);
        h_slice(hacc, xs[0], smem_u32(ring + slot * kSlot));
        wgmma_wait<1>();
        release(&empty[hslot]);
        hslot = slot;
      }
    }
    wgmma_wait<0>();
    release(&empty[hslot]);
    fence_regs(hacc);
    TIMER_ADD(tm[0], t_h);
  };
  // out[t] = b1 + P_0[r] + P_1[r + 1] + P_2[r + 2] (taps as N) or b1 + P[r]
  // for own row r (t = tb + r), from P staged: a thread keeps 4 columns
  // o .. o + 3 of the chunk, a warp whole rows; every thread takes the same
  // rows' steps, its stores predicated (no branch while h is in flight)
  auto output = [&](int i) {
    TIMER_START(t_o);
    constexpr int kTpr = W / 4;                     // threads a row
    constexpr int kStep = 128 / kTpr;               // rows a step
    constexpr int kSteps = (kOwn + kStep - 1) / kStep;
    const int o = 4 * (l.wt % kTpr);
    const int col = oc * W + o;
    // 2C is even: the pairs col, col + 1 and col + 2, col + 3 are whole or absent
    const bool c01 = col < a.two_c, c23 = col + 2 < a.two_c;
    const float* b1 = a.b1 + i * a.two_c + col;
    const float bb0 = c01 ? __ldg(b1) : 0.f, bb1 = c01 ? __ldg(b1 + 1) : 0.f;
    const float bb2 = c23 ? __ldg(b1 + 2) : 0.f, bb3 = c23 ? __ldg(b1 + 3) : 0.f;
    float* orow = a.out + ((size_t)b * h.T + tb) * n2 + i * a.two_c + col;
    auto step = [&](int st) {
      const int r = l.wt / kTpr + st * kStep;  // < 64
      const float* pr = ps + r * kLds + o;
      float4 v = *reinterpret_cast<const float4*>(pr);
      v = make_float4(bb0 + v.x, bb1 + v.y, bb2 + v.z, bb3 + v.w);
      if constexpr (kTapsN) {
        const float4 p1 = *reinterpret_cast<const float4*>(pr + kLds + W);
        const float4 p2 = *reinterpret_cast<const float4*>(pr + 2 * kLds + 2 * W);
        v = make_float4(v.x + p1.x + p2.x, v.y + p1.y + p2.y, v.z + p1.z + p2.z,
                        v.w + p1.w + p2.w);
      }
      const bool row_ok = r < kOwn && tb + r < h.T;
      float* dst = orow + (size_t)r * n2;
      if (row_ok && c01) *reinterpret_cast<float2*>(dst) = make_float2(v.x, v.y);
      if (row_ok && c23) *reinterpret_cast<float2*>(dst + 2) = make_float2(v.z, v.w);
    };
    if constexpr (kOutUnroll) {
#pragma unroll
      for (int st = 0; st < kSteps; ++st) step(st);
    } else {
#pragma unroll 1
      for (int st = 0; st < kSteps; ++st) step(st);
    }
    TIMER_ADD(tm[6], t_o);
  };

  h_begin();
  h_end();
  for (int i = 0;; ++i) {
    for (int p = 0; p < npass; ++p) {
      if (kWide && p > 0) {
        // 1. h_i's pass p (pass 0's was taken under the block before's output)
        h_begin();
        h_end();
      }
      // every warp of the warpgroup is past its reads of A's space (P's
      // products, or the output's reads of P staged there)
      TIMER_START(t_b0);
      bar_sync(bar, 128);
      TIMER_ADD(tm[3], t_b0);
      // 2. P over the pass's k-slices, kWPer an item of the ring: with the
      // taps as N, P_j = A @ W1_i[j] side by side (three products a slice);
      // else P += A_j @ W1_i[j], tap j's A the same descriptor 16 j bytes on
      // (nine a slice). A slice's B: W1_i[j] for the three taps, hi (3W rows)
      // then lo. Where kASplit, A is stored in two parts: the k-slices of P's
      // first two items, then (under their products) the rest.
      const int ns = pass_slices(h, p);
      const int nit = (ns + kWPer - 1) / kWPer;
      const int nfirst = kASplit ? min(2 * kWPer, ns) : kPassSlices;
#ifdef COND_CHAIN_TIMERS
      long long t_pp = 0;
      t_pw = 0;
#endif
      if (p == 0) zero(pacc);
      TIMER_START(t_a0);
      a_store(p, 0, nfirst);
      TIMER_ADD(tm[2], t_a0);
      TIMER_START(t_b1);
      bar_sync(bar, 128);
      TIMER_ADD(tm[3], t_b1);
      int it = 0, q0 = -1, q1 = -1;  // the items issued but not released
      if (kASplit) {
        TIMER_START(t_p0);
        q0 = p_item(0, ns);
        if (nit > 1) q1 = p_item(kWPer, ns);
        it = nit > 1 ? 2 : 1;
        TIMER_ADD(t_pp, t_p0);
        TIMER_START(t_a1);
        a_store(p, nfirst, kPassSlices);
        TIMER_ADD(tm[2], t_a1);
        TIMER_START(t_b2);
        bar_sync(bar, 128);
        TIMER_ADD(tm[3], t_b2);
      }
      TIMER_START(t_p1);
      if constexpr (kLoRegs) {
        // the slices unrolled, so that each takes its registers of alo
#pragma unroll
        for (int jt = 0; jt < (kPassSlices + kWPer - 1) / kWPer; ++jt) {
          if (jt < nit) {
            TIMER_START(t_w);
            const int slot = take(full, k);
            TIMER_ADD(t_pw, t_w);
            const uint32_t base = smem_u32(ring + slot * kSlot);
            wgmma_fence();
#pragma unroll
            for (int ss = 0; ss < kWPer; ++ss) {
              constexpr int kLast = kPassSlices - 1;
              const int sl = jt * kWPer + ss;
              if (sl <= kLast && sl < ns) {
                const uint32_t ah = a_hi + 2 * kAChunk * sl;
                const uint32_t bh = base + ss * kWItem;
                tf32x3::wgmma_rs_n96(pacc, alo[sl <= kLast ? sl : kLast], desc(bh, 128, 256),
                                     1);
                wgmma_p<kN>(pacc, desc(ah, kAChunk, 128), desc(bh + 3 * W * 32, 128, 256));
                wgmma_p<kN>(pacc, desc(ah, kAChunk, 128), desc(bh, 128, 256));
              }
            }
            wgmma_commit();
            wgmma_wait<1>();
            if (q0 >= 0) release(&empty[q0]);
            q0 = slot;
          }
        }
      } else {
        for (; it < nit; ++it) {
          const int slot = p_item(it * kWPer, ns);
          wgmma_wait<1>();
          if (q0 >= 0) release(&empty[q0]);
          if (q1 >= 0) release(&empty[q1]);
          q0 = slot;
          q1 = -1;
        }
      }
      wgmma_wait<0>();
      if (q0 >= 0) release(&empty[q0]);
      if (q1 >= 0) release(&empty[q1]);
      fence_regs(pacc);
      TIMER_ADD(t_pp, t_p1);
#ifdef COND_CHAIN_TIMERS
      tm[4] += t_pp - t_pw;
      tm[5] += t_pw;
#endif
    }
    // 3. P staged in A's space once every warp's products on A are done;
    // then the output, at E = 8 under the next block's first slice of h
    TIMER_START(t_s);
    bar_sync(bar, 128);
#pragma unroll
    for (int nt = 0; nt < kN / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        *reinterpret_cast<float2*>(ps + (l.row + 8 * half) * kLds + nt * 8 + 2 * l.tig) =
            make_float2(pacc[nt * 4 + 2 * half], pacc[nt * 4 + 2 * half + 1]);
      }
    }
    bar_sync(bar, 128);
    TIMER_ADD(tm[6], t_s);
    if (i + 1 == h.n) {
      output(i);
      break;
    }
    if constexpr (kWide) {
      output(i);
      h_begin();
      h_end();
    } else {
      h_begin();
      output(i);
      h_end();
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

// -- the images of the weights

struct ImageArgs {
  WhArgs wh;
  const float* w1;      // (3, Cc, n*2C)
  unsigned char* img_h;
  unsigned char* img_w1;
  int nimg, two_c, noc, w;
  int perm;             // each k-slice's k order permuted (k1_f32_kernel's kLoRegs)
};

// Both images, 16 bytes (4 k of one row of a core matrix) a thread: an hi or
// lo image of R rows x 8 k is R / 8 groups of 256 bytes, each the k 0-3 half
// of its 8 rows (16 bytes a row), then the k 4-7 half.
__global__ void k1_images_kernel(ImageArgs a) {
  const WhArgs& wh = a.wh;
  const int npass = passes(wh.cc);
  const long long uh = (long long)a.nimg * (long long)(h_image_bytes(wh.n, wh.cc, wh.E) / 16);
  const int wunits = a.w * 2;  // a hi or lo image of one tap
  const long long uw = (long long)wh.n * a.noc * npass * kPassSlices * 6 * wunits;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < uh + uw;
       u += (long long)gridDim.x * blockDim.x) {
    if (u < uh) {
      h_image_unit(wh, u, a.img_h);
      continue;
    }
    const long long u2 = u - uh;
    const long long item = u2 / (6 * wunits);
    int r = (int)(u2 - item * 6 * wunits);
    const int jh = r / wunits;  // (hi or lo) * 3 + tap
    r -= jh * wunits;
    int ol, k0;
    unit_place(r, ol, k0);
    const int o = (int)((item / (npass * kPassSlices)) % a.noc) * a.w + ol;
    const int ps = (int)(item % (npass * kPassSlices));
    const int c8 = kPass * (ps / kPassSlices) + 8 * (ps % kPassSlices);
    const int i = (int)(item / ((long long)npass * kPassSlices * a.noc));
    const int j = jh % 3;
    const int n2 = wh.n * a.two_c;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c8 + (a.perm ? 2 * e + (k0 >> 2) : k0 + e);  // position k0 + e
      v[e] = c < wh.cc && o < a.two_c ? a.w1[((size_t)j * wh.cc + c) * n2 + i * a.two_c + o]
                                      : 0.f;
    }
    put_unit(a.img_w1 + u2 * 16, v, jh / 3);
  }
}

struct FwdPlan {
  int w, noc, ntiles, nimg;
  bool wide;                      // the general instances (k1_f32_kernel's kWide)
  bool perm;                      // W1's k-slices permuted (its kLoRegs)
  size_t h_image, off_w1, total;  // workspace bytes: img_h, then img_w1
};

FwdPlan fwd_plan(int B, int T, int E, int n, int cc, int two_c, bool per_row) {
  FwdPlan p{};
  const int npass = passes(cc);
  p.wide = npass > 1 || h_slices(E) > 4;
  p.w = two_c <= 32 ? 32 : two_c <= 64 || p.wide ? 64 : 128;
  p.perm = !p.wide && p.w == 32;
  p.noc = (two_c + p.w - 1) / p.w;
  p.ntiles = (T + kTile - 1) / kTile;
  p.nimg = per_row ? B : 1;
  p.h_image = h_image_bytes(n, cc, E);
  p.off_w1 = ((size_t)p.nimg * p.h_image + 255) / 256 * 256;
  p.total = p.off_w1 + (size_t)n * p.noc * npass * kPassSlices * 6 * p.w * 32;
  return p;
}

template <int W, bool kWide>
int launch(const Args& a, int B, const FwdPlan& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k1_f32_kernel<W, kWide>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  k1_f32_kernel<W, kWide>
      <<<dim3((unsigned)p.ntiles, (unsigned)B, (unsigned)p.noc), kThreads, kSmem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int T, int E, int n, int cc, int two_c) {
  return B > 0 && B <= 65535 && T > 0 && E > 0 && n > 0 && cc > 0 && two_c > 0 &&
         two_c % 2 == 0 && (long long)n * cc * 3 < (1LL << 30);
}

}  // namespace

extern "C" const char* cond_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

#ifdef COND_CHAIN_TIMERS
// The diagnostic build's cycle sums since the last reset (kTimers of them,
// see g_timers) into out; then zero them where `reset`.
extern "C" int cond_chain_fwd_f32_timers(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_timers, sizeof(g_timers));
  if (e == cudaSuccess && reset) {
    const unsigned long long zeros[kTimers] = {};
    e = cudaMemcpyToSymbol(g_timers, zeros, sizeof(zeros));
  }
  return (int)e;
}
#endif

// Bytes of device scratch cond_chain_fwd_f32 needs for these shapes: the
// images of the weights it makes at each launch (per_row: hbias or the edges
// differ per batch row).
extern "C" long long cond_chain_fwd_f32_workspace(int B, int E, int n, int cc, int two_c,
                                                  int per_row) {
  return shapes_ok(B, 1, E, n, cc, two_c)
             ? (long long)fwd_plan(B, 1, E, n, cc, two_c, per_row != 0).total
             : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); shapes
// the kernel does not take (2C odd), too little workspace, or a launch the
// card refuses give an error code. Any Cc and E: shared memory does not grow
// with them.
extern "C" int cond_chain_fwd_f32(const float* exc, const float* w0, const float* hbias,
                                  long long hbias_bstride, const float* edge0,
                                  const float* edge_t, const float* w1, const float* b1,
                                  float* out, void* ws, long long ws_bytes, int B, int T, int E,
                                  int n, int cc, int two_c, void* stream) {
  if (!shapes_ok(B, T, E, n, cc, two_c)) return (int)cudaErrorInvalidValue;
  const bool per_row = hbias_bstride != 0 || edge0 != nullptr;
  const FwdPlan p = fwd_plan(B, T, E, n, cc, two_c, per_row);
  if (ws_bytes < (long long)p.total || (uintptr_t)ws % 256) return (int)cudaErrorInvalidValue;
  unsigned char* wsb = static_cast<unsigned char*>(ws);
  Args a;
  a.h = HArgs{exc, T, E, n, cc, passes(cc), h_slices(E)};
  a.b1 = b1;
  a.out = out;
  a.img_h = wsb;
  a.img_w1 = wsb + p.off_w1;
  a.h_image = per_row ? (long long)p.h_image : 0;
  a.two_c = two_c;
  a.noc = p.noc;
  const ImageArgs im{WhArgs{w0, hbias, hbias_bstride, edge0, edge_t, E, n, cc}, w1, wsb,
                     wsb + p.off_w1, p.nimg, two_c, p.noc, p.w, p.perm ? 1 : 0};
  cudaStream_t st = (cudaStream_t)stream;
  k1_images_kernel<<<264, 256, 0, st>>>(im);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (p.wide) {
    return p.w == 64 ? launch<64, true>(a, B, p, st) : launch<32, true>(a, B, p, st);
  }
  if (p.w == 128) return launch<128, false>(a, B, p, st);
  return p.w == 64 ? launch<64, false>(a, B, p, st) : launch<32, false>(a, B, p, st);
}
