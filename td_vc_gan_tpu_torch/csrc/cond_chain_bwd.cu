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
// operations, even counting the scratch below (written once, read once).
//
// What the design does about it. Every product runs on the tensor cores as
// 3xTF32 (tf32x3.cuh: f32 accuracy at a third of the TF32 rate, 2.5x the
// f32 CUDA-core peak). The TPU kernel accumulates the weight grads in VMEM
// across a grid that runs in order; Hopper CTAs run in no order, so the work
// is split into kernels that each own their outputs, and every sum runs in a
// fixed order (the results are the same from run to run, with no atomics):
//
//  (a) k2_images_kernel lays out, at each launch, the images of the weights
//      the data kernel's products read, split into hi and lo (K-major,
//      without swizzle: tf32x3.cuh): Wh (cond_chain_f32.cuh), W1_i[j]^T for
//      da and W0_i[j]^T for dexc.
//  (b) k2_data_kernel, on Hopper's wgmma: one CTA per (batch row, 124-row
//      time tile), two consumer warpgroups of 64 rows of h and a producer
//      warp (cond_chain_f32.cuh), a ring of 5 stages (bulk copies of the
//      images; TMA copies of g, whose zero fill outside [0, T) gives the
//      'same' conv's zero rows). Per block i and pass of 136 channels:
//       - h on wgmma as K1 takes it (the same operands in the same order);
//         lrelu(h) of the own rows to the scratch (for (c)) straight from
//         the accumulators, and the sign of h as 68 bits a thread, so that
//         h's registers take da;
//       - da_i, M = 64, N = 136, K = 3 x 2C in slices of 8 output channels:
//         a stage is the slice of g for the CTA's 128 rows t0 - 2 ..
//         t0 + 125 (two TMA boxes of 4 channels, raw f32) and the image of
//         W1_i's three taps; A from registers: each thread loads its g
//         fragment for tap j (the rows 2 - j further down) and splits it;
//         in the first pass one warp per channel of the slice sums the
//         CTA's rows of g (db1) while the products run;
//       - dh = lrelu'(h) da in place, zero outside [0, T); the own rows to
//         the scratch; dhbias's column sums over each warp's own rows (the
//         lanes by shuffles, one partial a warp);
//       - dexc: P = dh @ [W0_i[0]^T | W0_i[1]^T | W0_i[2]^T] for E in chunks
//         of 8 (K = the pass's channels), on mma.sync m16n8k8 per warp (its
//         16 rows, one accumulator a tap: small products that need no
//         asynchronous wait) with A from dh's registers: a warp's part of the
//         wgmma accumulator layout is the m16n8k8 tile's, and its pairs are
//         the A fragment's columns tig and tig + 4 when the image's K order
//         is permuted to match (k -> 2k (k < 4), 2(k - 4) + 1); then
//         dexc[t] += P_0[t+1] + P_1[t] + P_2[t-1] through shared memory,
//         a sum the CTA owns, over the blocks and passes in order.
//      Nothing of it grows with Cc or E: one tile for every width.
//  (c) k2_wgrad_kernel, split-K weight grads on mma.sync m16n8k8, both as
//      D = X^T Y(shifted): dW1_i^T[j] (M = 2C, N = Cc; X = g_i, Y = the
//      lrelu(h) scratch) and dW0^T[j] (M = n*Cc, N = E; X = the dh scratch,
//      Y = exc). A CTA owns one (block, output tile) and one fixed chunk of
//      the B*T rows and computes all three taps: it stages 32 rows of X and
//      the 34 rows of Y around them (a one-row halo each side) per cp.async
//      stage, double buffered, splits both into hi and lo once where they
//      land, and serves the three taps from that one staging. Rows are
//      indexed with a zero row between batch rows, so that a tap never pairs
//      rows of two batch rows. It writes a partial.
//  (d) k2_reduce_kernel sums the partials over the chunks in order, and gives
//      db1, dhbias and the edge grads.
//
// The scratch (two (B, T, n*Cc) f32 arrays, 1.4 GB each at B = 32, T = 8960)
// lives in device memory; keeping it on chip is later work.
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

#include "cond_chain_f32.cuh"
#include "tf32x3.cuh"

namespace {

using namespace f32chain;
using tf32x3::FragA;
using tf32x3::FragB;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;
using tf32x3::load_a_split;
using tf32x3::load_b_split;
using tf32x3::mma3;
using tf32x3::split_in_place;

// -- (a), (b): the data kernel on wgmma

constexpr int kDStages = 5;
constexpr int kGBox = kTile + 4;           // 128 rows of g a stage: t0 - 2 .. t0 + 125
constexpr int kGTile = 2 * kGBox * 16;     // 4096: 8 channels of them, raw, 4 channels a box
constexpr int kW1Item = 3 * 2 * kHItem;    // 26112: W1_i[j]^T's k-slice, 3 taps, hi and lo
constexpr int kW0Rows = 24;                // dexc's N: 3 taps x 8 columns of exc
constexpr int kW0Block = kW0Rows * 32;     // 768: a k-slice of dexc's B, hi or lo
constexpr int kW0Item = kPassSlices * 2 * kW0Block;  // 26112: a pass of it
constexpr int kDSlot = 30 * 1024;
static_assert(kGTile + kW1Item <= kDSlot && kW0Item <= kDSlot && 2 * kHItem <= kDSlot,
              "ring items fit a slot");
constexpr int kPLd = 28;                   // floats a row of dexc's P in shared memory
constexpr int kPFloats = kRows * kPLd;
constexpr size_t kDataSmem =
    (size_t)kDStages * kDSlot + 2 * (size_t)kPFloats * 4 + 16 * kDStages + 1024;
static_assert(kDataSmem <= kSmemMax, "K2's data kernel's shared memory");

struct DataArgs {
  HArgs h;
  const unsigned char* img_h;   // Wh's images (cond_chain_f32.cuh)
  long long h_image;            // bytes of one batch row's (0: one for every row)
  const unsigned char* img_w1;  // da's B: [i][p][so][j][hi, lo][136 rows c x 8 o]
  const unsigned char* img_w0;  // dexc's B: [i][p][ec][s][hi, lo][24 rows (j, e) x 8 c]
  float* a_out;                 // (B, T, n*Cc) scratch: lrelu(h)
  float* dh_out;                // (B, T, n*Cc) scratch: dh
  float* dexc;                  // (B, T, E)
  float* phb;                   // (B, 8 ntiles, n*Cc): dh summed over a warp's own rows
  float* pb1;                   // (B, ntiles, n*2C): g summed over a CTA's rows
  int two_c, no, ne, ntiles;    // no, ne: slices of 8 of 2C and of E
  CUtensorMap g_map;            // g as (o: 2C, i: n, t: T, b: B), box (4, 1, 128, 1)
};

// dexc's K order within a slice: image column k holds channel perm(k), so
// that dh's accumulator pair (2 tig, 2 tig + 1) is the A fragment's (tig, tig + 4)
__device__ __forceinline__ int perm(int k) { return k < 4 ? 2 * k : 2 * (k - 4) + 1; }

__global__ void __launch_bounds__(kThreads, 1) k2_data_kernel(const __grid_constant__ DataArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  float* pbuf = reinterpret_cast<float*>(ring + kDStages * kDSlot);  // [wg][64][kPLd]
  uint64_t* full = reinterpret_cast<uint64_t*>(pbuf + 2 * kPFloats);
  uint64_t* empty = full + kDStages;

  const HArgs& h = a.h;
  const int b = blockIdx.y;
  const int tix = blockIdx.x;
  const int t0 = tix * kTile;
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kDStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: per block i and pass p, Wh's k-slices, then per slice of
    // 8 output channels g's rows and W1's image, then dexc's B per chunk of E
    if (threadIdx.x == 256) {
      prefetch_map(&a.g_map);
      const unsigned char* img_h = a.img_h + (size_t)b * a.h_image;
      int k = 0;
      for (int i = 0; i < h.n; ++i)
        for (int p = 0; p < h.npass; ++p) {
          const size_t ip = (size_t)i * h.npass + p;
          for (int s = 0; s < h.nkh; ++s) {
            put<kDStages, kDSlot>(ring, full, empty, k, img_h + (ip * h.nkh + s) * 2 * kHItem,
                                  2 * kHItem);
          }
          for (int so = 0; so < a.no; ++so) {
            const int slot = slot_of<kDStages>(k);
            mbar_wait(&empty[slot], parity_of<kDStages>(k) ^ 1);
            mbar_arrive_expect_tx(&full[slot], kGTile + kW1Item);
            unsigned char* dst = ring + slot * kDSlot;
            tma_load_4d(dst, &a.g_map, &full[slot], 8 * so, i, t0 - 2, b);
            tma_load_4d(dst + kGTile / 2, &a.g_map, &full[slot], 8 * so + 4, i, t0 - 2, b);
            bulk_load(dst + kGTile, a.img_w1 + (ip * a.no + so) * kW1Item, kW1Item, &full[slot]);
            ++k;
          }
          for (int ec = 0; ec < a.ne; ++ec) {
            put<kDStages, kDSlot>(ring, full, empty, k, a.img_w0 + (ip * a.ne + ec) * kW0Item,
                                  kW0Item);
          }
        }
    }
    return;
  }

  const int wg = warp >> 2;
  const int bar = 1 + wg;
  const int tb = t0 + kOwn * wg;  // the warpgroup's first own row
  const int u0 = tb - 1;          // its h row q = 0
  const Lane l;
  const int wq = l.wt >> 5;       // the warp within the warpgroup
  const int lane = threadIdx.x & 31;
  const int n0 = h.n * h.cc;
  const int n2 = h.n * a.two_c;
  float* pw = pbuf + wg * kPFloats;
  XFrag none[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) none[s].hi[r] = none[s].lo[r] = 0u;

  int k = 0;
  for (int i = 0; i < h.n; ++i) {
    for (int p = 0; p < h.npass; ++p) {
      const int c0 = kPass * p;
      float acc[68];
      // 1. h; lrelu(h) of the own rows to the scratch; where h >= 0, as bits
      h_pass<kDStages, kDSlot>(h, acc, ring, full, empty, k, none, false, b, u0, l);
      uint32_t pos[3] = {0u, 0u, 0u};
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const int u = u0 + q;
          const int c = c0 + nt * 8 + 2 * l.tig;
          float av[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = nt * 4 + 2 * half + e;
            const float x = acc[r];
            if (x >= 0.f) pos[r >> 5] |= 1u << (r & 31);
            av[e] = x >= 0.f ? x : kSlope * x;
          }
          if (q >= 1 && q <= kOwn && u < h.T && c < h.cc) {
            *reinterpret_cast<float2*>(a.a_out + ((size_t)b * h.T + u) * n0 + i * h.cc + c) =
                make_float2(av[0], av[1]);
          }
        }
      }
      // 2. da = sum_j g[t - j + 1] @ W1_i[j]^T, a slice of 8 output channels an item
      zero(acc);
      for (int so = 0; so < a.no; ++so) {
        const int slot = slot_of<kDStages>(k);
        mbar_wait(&full[slot], parity_of<kDStages>(k));
        const float* graw = reinterpret_cast<const float*>(ring + slot * kDSlot);
        // tap j's A: g at the h row's time - j + 1, the tile's row 62 wg + q + 2 - j
        XFrag gf[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float* g0 = graw + (kOwn * wg + l.row + 2 - j) * 4 + l.tig;
          split(g0[0], gf[j].hi[0], gf[j].lo[0]);
          split(g0[32], gf[j].hi[1], gf[j].lo[1]);
          split(g0[kGBox * 4], gf[j].hi[2], gf[j].lo[2]);
          split(g0[kGBox * 4 + 32], gf[j].hi[3], gf[j].lo[3]);
          fence_regs(gf[j].hi);
          fence_regs(gf[j].lo);
        }
        const uint32_t base = smem_u32(ring + slot * kDSlot) + kGTile;
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint32_t bh = base + 2 * j * kHItem;
          tf32x3::wgmma_rs_n136(acc, gf[j].lo, desc(bh, 128, 256), 1);
          tf32x3::wgmma_rs_n136(acc, gf[j].hi, desc(bh + kHItem, 128, 256), 1);
          tf32x3::wgmma_rs_n136(acc, gf[j].hi, desc(bh, 128, 256), 1);
        }
        wgmma_commit();
        if (p == 0) {
          // db1, while the products run: warp w sums channel 8 so + w over the
          // CTA's rows t0 .. t0 + 123
          const int o = 8 * so + warp;
          const float* col = graw + (warp >> 2) * kGBox * 4 + (warp & 3);
          float sv = 0.f;
          for (int r = 2 + lane; r < 2 + kTile; r += 32) {
            if (t0 - 2 + r < h.T) sv += col[r * 4];
          }
#pragma unroll
          for (int m = 16; m >= 1; m >>= 1) sv += __shfl_xor_sync(0xffffffffu, sv, m);
          if (lane == 0 && o < a.two_c) {
            a.pb1[((size_t)b * a.ntiles + tix) * n2 + i * a.two_c + o] = sv;
          }
        }
        wgmma_wait<0>();
        fence_regs(acc);
        release(&empty[slot]);
        ++k;
      }
      // 3. dh = lrelu'(h) da, zero outside [0, T) and past Cc; the own rows to
      // the scratch
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const int u = u0 + q;
          const int c = c0 + nt * 8 + 2 * l.tig;
          const bool ok = u >= 0 && u < h.T && c < h.cc;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = nt * 4 + 2 * half + e;
            acc[r] = ok ? ((pos[r >> 5] >> (r & 31)) & 1u ? acc[r] : kSlope * acc[r]) : 0.f;
          }
          if (ok && q >= 1 && q <= kOwn) {
            *reinterpret_cast<float2*>(a.dh_out + ((size_t)b * h.T + u) * n0 + i * h.cc + c) =
                make_float2(acc[nt * 4 + 2 * half], acc[nt * 4 + 2 * half + 1]);
          }
        }
      }
      // dhbias: dh summed over a warp's own rows per channel, by its lanes;
      // one partial a warp (the reduce sums them in order)
      const bool own0 = l.row >= 1 && u0 + l.row < h.T;
      const bool own1 = l.row + 8 <= kOwn && u0 + l.row + 8 < h.T;
      float* phb = a.phb + ((((size_t)b * a.ntiles + tix) * 2 + wg) * 4 + wq) * n0 + i * h.cc;
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
        float sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sv[e] = (own0 ? acc[nt * 4 + e] : 0.f) + (own1 ? acc[nt * 4 + 2 + e] : 0.f);
          sv[e] += __shfl_xor_sync(0xffffffffu, sv[e], 4);
          sv[e] += __shfl_xor_sync(0xffffffffu, sv[e], 8);
          sv[e] += __shfl_xor_sync(0xffffffffu, sv[e], 16);
        }
        const int c = c0 + nt * 8 + 2 * l.tig;
        if (lane < 4 && c < h.cc) *reinterpret_cast<float2*>(phb + c) = make_float2(sv[0], sv[1]);
      }
      // 4. dexc: P = dh @ [W0_i[0]^T | W0_i[1]^T | W0_i[2]^T], E in chunks of
      // 8, on mma.sync m16n8k8 per warp (its 16 rows; the A fragment of that
      // tile is the warp's part of the wgmma layout), one accumulator a tap
      const int ns = pass_slices(h, p);
      for (int ec = 0; ec < a.ne; ++ec) {
        float pac[3][4] = {};
        const int slot = slot_of<kDStages>(k);
        mbar_wait(&full[slot], parity_of<kDStages>(k));
        // B[k][n] of tap j at (n / 8 = j) 256 + (k / 4) 128 + (n % 8) 16 + (k % 4) 4
        const float* w0i = reinterpret_cast<const float*>(ring + slot * kDSlot) +
                           (lane >> 2) * 4 + l.tig;
#pragma unroll
        for (int s = 0; s < kPassSlices; ++s) {
          if (s < ns) {
            FragA f;
            split(acc[4 * s], f.hi[0], f.lo[0]);
            split(acc[4 * s + 2], f.hi[1], f.lo[1]);
            split(acc[4 * s + 1], f.hi[2], f.lo[2]);
            split(acc[4 * s + 3], f.hi[3], f.lo[3]);
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              mma3(pac[j], f, load_b_split(w0i + 2 * s * (kW0Block / 4) + j * 64,
                                           kW0Block / 4, 8));
            }
          }
        }
        release(&empty[slot]);
        ++k;
        // dexc[tb + r] += P_0[r + 2] + P_1[r + 1] + P_2[r] (P's row q is dh's time u0 + q)
        bar_sync(bar, 128);  // the previous chunk's reads of pw are done
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            *reinterpret_cast<float2*>(pw + (l.row + 8 * half) * kPLd + jj * 8 + 2 * l.tig) =
                make_float2(pac[jj][2 * half], pac[jj][2 * half + 1]);
          }
        }
        bar_sync(bar, 128);
        for (int x = l.wt; x < kOwn * 8; x += 128) {
          const int r = x >> 3;
          const int e = 8 * ec + (x & 7);
          const int t = tb + r;
          if (t < h.T && e < h.E) {
            const float v = (pw[(r + 2) * kPLd + (x & 7)] + pw[(r + 1) * kPLd + 8 + (x & 7)]) +
                            pw[r * kPLd + 16 + (x & 7)];
            float* d = a.dexc + ((size_t)b * h.T + t) * h.E + e;
            *d = i == 0 && p == 0 ? v : *d + v;
          }
        }
      }
    }
  }
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

// -- (c), (d): the weight grads and the reduce, on mma.sync from the scratch

constexpr int kWRows = 32;           // weight-grad kernel: rows per stage
constexpr int kWStages = 2;
constexpr int kTargetCtas = 4 * 132;  // split-K aims at four CTAs per SM

struct WgradArgs {
  const float* X;  // unshifted operand: element (row, grp*xgoff + m), row = b*T + t
  long long ldx;
  int xgoff, M;
  const float* Y;  // shifted operand: element (row, grp*ygoff + n)
  long long ldy;
  int ygoff, N;
  float* part;     // (S, 3, N, G*M)
  int T, G, prows, chunk;
};

// The weight-grad CTA's shape for NTW n-tiles (of 8 columns) per warp: 8 x 1
// warps of 16 x 8 for N <= 8 (dW0 of the split form), else 2 x 6 warps of
// 16 x 24.
template <int NTW>
struct WgradGeom {
  static constexpr int kWM = NTW == 1 ? 8 : 2;  // warps along M
  static constexpr int kWN = NTW == 1 ? 1 : 6;  // warps along N
  static constexpr int kBM = 16 * kWM;
  static constexpr int kBN = 8 * NTW * kWN;
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int kLdx = k_read_stride(kBM);
  static constexpr int kLdy = k_read_stride(kBN);
  static constexpr int kXlo = kWRows * kLdx;        // a stage's lo parts, after its hi parts
  static constexpr int kYlo = (kWRows + 2) * kLdy;
  static constexpr size_t kSmem = (size_t)kWStages * 2 * (kXlo + kYlo) * sizeof(float);
};

// part[s][j][n][grp*M + m] = sum over rows (b, t) of chunk s of
// X[b, t][grp*xgoff + m] * Y[b, t+j-1][grp*ygoff + n], Y zero outside [0, T).
// Rows are indexed p = b*(T+1) + t + 1, so p = b*(T+1) is a zero row between
// batch rows and tap j pairs X row p with Y row p + j - 1. A CTA owns a
// kBM x kBN output tile, all three taps, and the padded rows
// [s*chunk, (s+1)*chunk).
// kYVec: Y's rows are 16-byte aligned (ldy a multiple of 4) and are staged in
// 16-byte pieces; else (dW0 at E not a multiple of 4) in 4-byte pieces.
template <int NTW, bool kYVec>
__global__ void __launch_bounds__(WgradGeom<NTW>::kThreads) k2_wgrad_kernel(WgradArgs w) {
  using G = WgradGeom<NTW>;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                         // [kWStages][hi, lo][kWRows][kLdx]
  float* ys = smem + kWStages * 2 * G::kXlo;  // [kWStages][hi, lo][kWRows + 2][kLdy]
  const int mblocks = (w.M + G::kBM - 1) / G::kBM;
  const int m0 = (blockIdx.x % mblocks) * G::kBM;
  const int n0 = (blockIdx.x / mblocks) * G::kBN;
  const int grp_i = blockIdx.y;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp / G::kWN;
  const int wn = warp % G::kWN;
  const int p_begin = s * w.chunk;
  const int p_end = min(w.prows, p_begin + w.chunk);
  const int nsub = (p_end - p_begin + kWRows - 1) / kWRows;
  const int tp = w.T + 1;
  const float* X = w.X + (size_t)grp_i * w.xgoff;
  const float* Y = w.Y + (size_t)grp_i * w.ygoff;

  // (split = true: this thread's pieces of stage sub, landed, split in place)
  auto load = [&](int sub, bool split) {
    const int pb = p_begin + sub * kWRows;
    const int pb_b = pb / tp;  // pb = pb_b*(T+1) + pb_q
    const int pb_q = pb - pb_b * tp;
    float* xd = xs + (sub % kWStages) * 2 * G::kXlo;
    float* yd = ys + (sub % kWStages) * 2 * G::kYlo;
    constexpr int kXP = G::kBM / 4;  // 16-byte pieces per row
    constexpr int kYP = G::kBN / 4;
    constexpr int kNX = kWRows * kXP;
    constexpr int kNY = (kWRows + 2) * kYP;
    for (int idx = tid; idx < kNX + kNY; idx += G::kThreads) {
      const bool is_x = idx < kNX;
      const int k = is_x ? idx : idx - kNX;
      const int r = is_x ? k / kXP : k / kYP;
      const int c = (k - r * (is_x ? kXP : kYP)) * 4;
      float* dst = is_x ? xd + r * G::kLdx + c : yd + r * G::kLdy + c;
      if (split) {
        split_in_place(dst, is_x ? G::kXlo : G::kYlo);
        continue;
      }
      // padded row p = pb + r (X) or pb - 1 + r (Y), as (batch row, t + 1)
      int bq = pb_b;
      int q = pb_q + r - (is_x ? 0 : 1);
      if (q < 0) {
        q += tp;
        --bq;
      }
      while (q >= tp) {
        q -= tp;
        ++bq;
      }
      const int p = bq * tp + q;
      const size_t row = (size_t)bq * w.T + q - 1;
      const bool ok = q != 0 && p >= 0 && (is_x ? p < p_end && m0 + c < w.M
                                                 : p < w.prows && n0 + c < w.N);
      const float* src = !ok ? w.X : is_x ? X + row * w.ldx + m0 + c : Y + row * w.ldy + n0 + c;
      if (is_x || kYVec) {
        cp_async16(dst, src, ok);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok_u = ok && n0 + c + u < w.N;
          cp_async4(dst + u, ok_u ? src + u : w.X, ok_u);
        }
      }
    }
  };

  float acc[3][NTW][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][nt][v] = 0.f;

  for (int sub = 0; sub < kWStages - 1; ++sub) {
    if (sub < nsub) load(sub, false);
    cp_async_commit();
  }
  for (int sub = 0; sub < nsub; ++sub) {
    cp_async_wait<kWStages - 2>();
    load(sub, true);
    __syncthreads();  // stage sub landed and split; stage sub-1 is free
    if (sub + kWStages - 1 < nsub) load(sub + kWStages - 1, false);
    cp_async_commit();
    const float* xd = xs + (sub % kWStages) * 2 * G::kXlo;
    const float* yd = ys + (sub % kWStages) * 2 * G::kYlo;
#pragma unroll 2
    for (int kk = 0; kk < kWRows; kk += 8) {
      // A[m][k] = X[row kk + k][m]; B_j[k][n] = Y[row kk + k + j - 1][n] = yd row kk + k + j
      const FragA fa = load_a_split(xd + (kk + tig) * G::kLdx + wm * 16 + grp, G::kXlo, 1, G::kLdx);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const FragB fb = load_b_split(yd + (kk + tig + j) * G::kLdy + (wn * NTW + nt) * 8 + grp,
                                        G::kYlo, G::kLdy);
          mma3(acc[j][nt], fa, fb);
        }
      }
    }
  }
  cp_async_wait<0>();

  const size_t ldo = (size_t)w.G * w.M;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float* out = w.part + ((size_t)s * 3 + j) * w.N * ldo + (size_t)grp_i * w.M;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = m0 + wm * 16 + grp + 8 * half;
        if (m >= w.M) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nn = n0 + (wn * NTW + nt) * 8 + 2 * tig + u;
          if (nn < w.N) out[nn * ldo + m] = acc[j][nt][2 * half + u];
        }
      }
    }
  }
}

// out[o*len + k] = scale * sum_{s < S} part[o*ostride + s*sstride + k], s in order.
__global__ void k2_reduce_kernel(const float* part, float* out, long long len, int S,
                                 long long sstride, long long ostride, float scale) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long o = blockIdx.y;
  if (k >= len) return;
  const float* p = part + o * ostride + k;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[(long long)s * sstride];
  out[o * len + k] = scale * acc;
}

// The split-K plan of one weight grad D = X^T Y (M x N per group, G groups)
// over R = B*T rows.
struct Wgrad {
  int ntw, mblocks, nblocks, S, chunk;
  size_t smem;
};

template <int NTW>
void wgrad_shape(Wgrad& p, int M, int N) {
  using G = WgradGeom<NTW>;
  p.ntw = NTW;
  p.mblocks = (M + G::kBM - 1) / G::kBM;
  p.nblocks = (N + G::kBN - 1) / G::kBN;
  p.smem = G::kSmem;
}

Wgrad wgrad_plan(int M, int N, int G, int B, int T) {
  Wgrad p;
  if (N <= 8) {
    wgrad_shape<1>(p, M, N);
  } else {
    wgrad_shape<3>(p, M, N);
  }
  const int prows = B * (T + 1);
  const int tiles = p.mblocks * p.nblocks * G;
  int S = (kTargetCtas + tiles - 1) / tiles;
  const int max_s = (prows + 4 * kWRows - 1) / (4 * kWRows);  // at least 4 stages a CTA
  if (S > max_s) S = max_s;
  if (S < 1) S = 1;
  p.chunk = ((prows + S - 1) / S + kWRows - 1) / kWRows * kWRows;
  p.S = (prows + p.chunk - 1) / p.chunk;
  return p;
}


// Everything the launch needs, from the shapes alone; ok = false for shapes
// the kernels do not take. Offsets are in floats of the workspace.
struct Plan {
  bool ok;
  int ntiles, no, ne, nimg;
  Wgrad w1, w0;
  size_t off_a, off_dh, off_phb, off_pb1, off_pw1, off_pw0, off_imh, off_imw1, off_imw0, total;
  size_t h_image;  // bytes
};

Plan make_plan(int B, int T, int E, int n, int cc, int two_c, bool per_row) {
  Plan p{};
  p.ok = false;
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 4 || (long long)B * (T + 1) > (1LL << 30)) {
    return p;
  }
  p.ntiles = (T + kTile - 1) / kTile;
  p.no = (two_c + 7) / 8;
  p.ne = (E + 7) / 8;
  p.nimg = per_row ? B : 1;
  p.h_image = h_image_bytes(n, cc, E);
  const size_t R = (size_t)B * T;
  const size_t n0 = (size_t)n * cc, n2 = (size_t)n * two_c;
  p.w1 = wgrad_plan(two_c, cc, n, B, T);
  p.w0 = wgrad_plan((int)n0, E, 1, B, T);
  if (p.w1.smem > kSmemMax || p.w0.smem > kSmemMax) return p;
  auto up = [](size_t x) { return (x + 63) / 64 * 64; };  // 256-byte boundaries
  const size_t npass = passes(cc);
  p.off_a = 0;
  p.off_dh = p.off_a + R * n0;
  p.off_phb = p.off_dh + R * n0;
  p.off_pb1 = p.off_phb + (size_t)B * 8 * p.ntiles * n0;
  p.off_pw1 = p.off_pb1 + (size_t)B * p.ntiles * n2;
  p.off_pw0 = p.off_pw1 + (size_t)p.w1.S * 3 * cc * n2;
  p.off_imh = up(p.off_pw0 + (size_t)p.w0.S * 3 * E * n0);
  p.off_imw1 = up(p.off_imh + p.nimg * p.h_image / 4);
  p.off_imw0 = up(p.off_imw1 + (size_t)n * npass * p.no * kW1Item / 4);
  p.total = p.off_imw0 + (size_t)n * npass * p.ne * kW0Item / 4;
  p.ok = true;
  return p;
}

cudaError_t launch_data(const DataArgs& d, const Plan& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k2_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kDataSmem);
  if (e != cudaSuccess) return e;
  k2_data_kernel<<<dim3((unsigned)p.ntiles, (unsigned)B), kThreads, kDataSmem, stream>>>(d);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* part, float* out, long long len, int outer, int S,
                          long long sstride, long long ostride, float scale,
                          cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((unsigned)((len + threads - 1) / threads), (unsigned)outer);
  k2_reduce_kernel<<<grid, threads, 0, stream>>>(part, out, len, S, sstride, ostride, scale);
  return cudaGetLastError();
}

template <int NTW, bool kYVec>
cudaError_t launch_wgrad_t(const Wgrad& p, const WgradArgs& w, int G, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k2_wgrad_kernel<NTW, kYVec>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(p.mblocks * p.nblocks), (unsigned)G, (unsigned)p.S);
  k2_wgrad_kernel<NTW, kYVec><<<grid, WgradGeom<NTW>::kThreads, p.smem, stream>>>(w);
  return cudaGetLastError();
}

// D[grp][j] = X_grp^T Y_grp(shifted by j - 1) into part (S, 3, N, G*M)
cudaError_t launch_wgrad(const Wgrad& p, const float* X, long long ldx, int xgoff, int M,
                         const float* Y, long long ldy, int ygoff, int N, int G, int B, int T,
                         float* part, cudaStream_t stream) {
  WgradArgs w;
  w.X = X;
  w.ldx = ldx;
  w.xgoff = xgoff;
  w.M = M;
  w.Y = Y;
  w.ldy = ldy;
  w.ygoff = ygoff;
  w.N = N;
  w.part = part;
  w.T = T;
  w.G = G;
  w.prows = B * (T + 1);
  w.chunk = p.chunk;
  if (ldy % 4 == 0) {
    return p.ntw == 1 ? launch_wgrad_t<1, true>(p, w, G, stream)
                      : launch_wgrad_t<3, true>(p, w, G, stream);
  }
  return p.ntw == 1 ? launch_wgrad_t<1, false>(p, w, G, stream)
                    : launch_wgrad_t<3, false>(p, w, G, stream);
}
// Device time of a call's kernels, for measurement (smoke phase 8): while
// on, a call records an event before its first launch and after the images,
// the data kernel, each weight-grad kernel and the last reduce, on its stream
bool g_timed = false;
cudaEvent_t g_marks[6];

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

// ms[0..4]: the last timed call's k2_images_kernel, k2_data_kernel,
// k2_wgrad_kernel for dW1, k2_wgrad_kernel for dW0 and its k2_reduce_kernel
// launches (4 to 6), each from the end of the launch before it (synchronize
// first)
extern "C" int cond_chain_bwd_kernel_ms(float* ms) {
  for (int k = 0; k < 5; ++k) {
    const cudaError_t err = cudaEventElapsedTime(&ms[k], g_marks[k], g_marks[k + 1]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

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
  float* a_s = ws + p.off_a;
  float* dh_s = ws + p.off_dh;
  unsigned char* img_h = reinterpret_cast<unsigned char*>(ws + p.off_imh);
  unsigned char* img_w1 = reinterpret_cast<unsigned char*>(ws + p.off_imw1);
  unsigned char* img_w0 = reinterpret_cast<unsigned char*>(ws + p.off_imw0);

  DataArgs d;
  d.h = HArgs{exc, T, E, n, cc, passes(cc), h_slices(E)};
  d.img_h = img_h;
  d.h_image = per_row ? (long long)p.h_image : 0;
  d.img_w1 = img_w1;
  d.img_w0 = img_w0;
  d.a_out = a_s;
  d.dh_out = dh_s;
  d.dexc = dexc;
  d.phb = ws + p.off_phb;
  d.pb1 = ws + p.off_pb1;
  d.two_c = two_c;
  d.no = p.no;
  d.ne = p.ne;
  d.ntiles = p.ntiles;
  const cuuint64_t o = (cuuint64_t)two_c;
  const cuuint64_t g_dims[4] = {o, (cuuint64_t)n, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t g_strides[3] = {o * 4, o * 4 * n, o * 4 * n * T};
  const cuuint32_t g_box[4] = {4, 1, (cuuint32_t)kGBox, 1};
  if (!make_map_f32(&d.g_map, g, 4, g_dims, g_strides, g_box)) return (int)cudaErrorInvalidValue;
  const ImageArgs im{WhArgs{w0, hbias, hbias_bstride, edge0, edge_t, E, n, cc}, w1, img_h, img_w1,
                     img_w0, p.nimg, two_c, p.no, p.ne};

  auto mark = [&](int k) {
    if (g_timed) cudaEventRecord(g_marks[k], stream);
  };
  mark(0);
  k2_images_kernel<<<264, 256, 0, stream>>>(im);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  mark(1);
  if ((e = launch_data(d, p, B, stream)) != cudaSuccess) return (int)e;
  mark(2);

  // dW1^T from g and lrelu(h) (shifted); dW0^T from dh and exc (shifted)
  if ((e = launch_wgrad(p.w1, g, n2, two_c, two_c, a_s, n0, cc, cc, n, B, T, ws + p.off_pw1,
                        stream)) != cudaSuccess) return (int)e;
  mark(3);
  if ((e = launch_wgrad(p.w0, dh_s, n0, 0, n0, exc, E, 0, E, 1, B, T, ws + p.off_pw0,
                        stream)) != cudaSuccess) return (int)e;
  mark(4);

  const long long len1 = 3LL * cc * n2;
  const long long len0 = 3LL * E * n0;
  const int parts = 8 * p.ntiles;  // dhbias's partials a batch row: one a consumer warp
  if ((e = launch_reduce(ws + p.off_pw1, dw1, len1, 1, p.w1.S, len1, 0, 1.f, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(ws + p.off_pw0, dw0, len0, 1, p.w0.S, len0, 0, 1.f, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(ws + p.off_pb1, db1, n2, 1, B * p.ntiles, n2, 0, 1.f, stream)) !=
      cudaSuccess) return (int)e;
  if (hbias_bstride) {
    e = launch_reduce(ws + p.off_phb, dhbias, n0, B, parts, n0, (long long)parts * n0, 1.f,
                      stream);
  } else {
    e = launch_reduce(ws + p.off_phb, dhbias, n0, 1, B * parts, n0, 0, 1.f, stream);
  }
  if (e != cudaSuccess) return (int)e;
  if (edge0) {
    if ((e = launch_reduce(dh_s, dedge0, n0, B, 1, 0, (long long)T * n0, -1.f, stream)) !=
        cudaSuccess) return (int)e;
    if ((e = launch_reduce(dh_s + (size_t)(T - 1) * n0, dedge_t, n0, B, 1, 0,
                           (long long)T * n0, -1.f, stream)) != cudaSuccess) return (int)e;
  }
  mark(5);
  return 0;
}
