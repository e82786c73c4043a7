// FiLM conditioning chain, forward, bf16 instance (K1-bf16), for one MRF
// stage's n FiLM blocks.
//
// Replaces the bf16 instance of td_vc_gan_tpu/ops/pallas/cond_chain.py::_fwd_kernel
// (the Pallas kernel on bf16 operands under the JAX package's bf16 compute
// scope). It computes, per batch row b and time t, with every operand bf16:
//
//   h[t]     = sum_j exc[t+j-1] @ W0[j] + hbias - [t==0] edge0 - [t==T-1] edge_t   (f32)
//   a[t]     = bf16(lrelu(h)[t])                    (zero outside [0, T))
//   out_i[t] = bf16(b1_i + sum_j a_i[t+j-1] @ W1_i[j])   (the sum in f32)
//
// rounding where the Pallas kernel rounds: a once, after leaky_relu, and the
// output once. The concat form (film_cond_chain) is the same kernel with
// exc = c, hbias = b0 broadcast over the batch (hbias_bstride = 0) and no
// edges.
//
// What bounds it on an H100: about 400 flops per byte written at the
// decoder's shapes, above the ridge of the card's dense bf16 tensor-core
// rate (989.4 TFLOP/s over 3.35 TB/s = 295 flops per byte): operations, on
// products whose N is small (2C = 32 at the longest stage). Its first
// version (bf16 mma.sync, fragments loaded from global memory) was bound by
// instruction throughput and latency; its second (one CTA walking every
// output chunk, cond_0's A gathered element by element from global memory,
// every chunk of W0's image waited for in turn) took 1.8-1.9 ms at the
// options' bottleneck (Cc = E = 256), 8-10x cuDNN's time (NVIDIA H100 80GB
// HBM3, 700 W).
//
// What the design does about it: both products on wgmma (hopper_bf16.cuh)
// with f32 accumulators in registers, every operand brought by the producer
// warp's TMA and bulk copies through mbarrier rings. The CTA
// (cond_chain_bf16.cuh): two consumer warpgroups of 64 rows of h each, 124
// own rows a CTA, and a producer warp. At each launch a small kernel
// (w_images_kernel) lays out cond_0's weights as h's B, the bias and edges
// folded in as three more k, and W1 transposed, (n, 3, 2C, Cc8) (K-major, Cc
// padded to 8: every stride a multiple of 16 bytes, as TMA wants), in the
// workspace.
//  - The grid is (time tiles, batch rows, groups of output chunks). A CTA
//    takes every chunk of W output columns (h computed once a tile) where
//    the tiles alone fill the card's SMs, else one chunk (the chunks' CTAs
//    in parallel, each computing h); where Cc takes several passes, one
//    chunk (h is computed per chunk either way).
//  - cond_0's A, X[u] = [exc[u-1] | exc[u] | exc[u+1] | 1 | -[u==0] |
//    -[u==T-1]], is read by ldmatrix from exc staged in shared memory by
//    TMA, the CTA's 128 rows t0 - 2 .. t0 + 125 (zero filled outside
//    [0, T)), one row address a lane, so that tap j's shift is j rows; the
//    column of ones and the edge indicators are made in registers. The
//    wrapper pads E (exc and W0, zero channels) to a multiple of 8 up to 16,
//    of 64 past it. E <= 16: boxes of 8 channels (16-byte rows), kept for
//    the CTA, a group of 8 k one tap's 8 channels; at E = 8 (K <= 32) X's
//    two k-slices are loaded into registers once. E > 16: each chunk of 64
//    k is one tap's 64 channels, and its box (128-byte rows, TMA's 128-byte
//    swizzle, read at the swizzled 16-byte piece) comes through the h ring
//    with the chunk of W0's image, so that shared memory does not grow with
//    E. The kernel is templated on these three modes (XMode), so that each
//    keeps only its own registers.
//  - Per block i (and per pass of 136 columns of h):
//     1. h_i on wgmma: M = 64, N = 136, K = 3E + 3 in chunks of 64 (4
//        k-slices) through a ring of 2 slots, the producer filling one while
//        the consumers multiply the other; lrelu in f32, rounded to bf16 in
//        pairs: the A registers of the next product.
//     2. P = a_i @ [W1_i[0] | W1_i[1] | W1_i[2]] on wgmma with A from
//        registers: N = 3W for a chunk of W = 64 output columns (32 where
//        2C <= 32, or where Cc takes several passes and P's accumulators
//        live beside h's), K = the pass's 144 columns in slices of 16 (the
//        last 8 zero in A, against W1's next columns). A stage of the TMA
//        ring is the three taps' W x 64 boxes of w1t, 3 stages (W = 64; 2
//        where E > 16) or 4, with full/empty mbarriers; the producer runs
//        ahead across chunks and blocks. Consecutive stages' products
//        overlap (one wgmma group in flight when a stage is released).
//     3. out[t] = b1 + P_0[t-1] + P_1[t] + P_2[t+1] (a's rows t-1 .. t+1),
//        summed in f32 through shared memory and rounded once, a thread
//        taking 4 columns (16-byte shared-memory reads, 8-byte stores), a
//        warp whole rows of the chunk.
// The row shift of the second conv is taken on the products' outputs (route
// (a)): a_i comes straight out of h's accumulators into A registers, and A
// from registers leaves shared memory's bandwidth to B alone (at 2C = 32 an
// A in shared memory would be read once per 32 output columns). Every width
// goes in passes of 136 columns of h, so the shared memory does not grow
// with Cc or E. Where Cc takes more than one pass (kMulti), P sums over the
// passes and h is recomputed per output chunk.
//
// Numerics: bf16 products are exact in the f32 accumulators, so the sums
// differ from an f32 sum of the same values by their order only; the plain
// version (cond_chain_plain on bf16 operands) rounds at the same two points.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

#include "cond_chain_bf16.cuh"

namespace {

using namespace bf16chain;

// A diagnostic build (-DCOND_CHAIN_TIMERS) sums each consumer warpgroup's
// clock64 cycles by phase (h, P, epilogue, the whole kernel) over the
// launch, read by cond_chain_fwd_bf16_timers; the normal build has none.
#ifdef COND_CHAIN_TIMERS
__device__ unsigned long long g_timers[5];  // h, P, epilogue, whole, warpgroups
#define TIMER_START(v) const long long v = clock64()
#define TIMER_ADD(acc, since) acc += clock64() - since
#else
#define TIMER_START(v)
#define TIMER_ADD(acc, since)
#endif

// exc staged for cond_0's A: the CTA's 128 rows t0 - 2 .. t0 + 125 of 8
// channels where E <= 16 (a box of 16-byte rows, kept for the CTA), else of
// 64 channels (a box of 128-byte rows with TMA's 128-byte swizzle, one a
// chunk of img_h)
constexpr int kXRows = 128;
constexpr int kXBox8 = kXRows * 16;                 // 2048
constexpr int kXBox64 = kXRows * 128;               // 16384
constexpr int kItemStream = kXBox64 + kWSlot;       // 33792: a chunk of img_h after its box
constexpr int kResidentBoxes = 2;                   // E <= 16
constexpr int kHSlots = 2;                          // the h ring's slots
// How cond_0's A comes (a template argument, so that each mode's kernel
// keeps only its own registers): from registers, loaded once (K = 3E + 3 <=
// 32, the decoder's E = 8); by ldmatrix from the CTA's boxes of 8 channels
// (E = 16); by ldmatrix from the box of 64 channels each chunk of img_h
// brings (E > 16)
enum XMode { kXHoist, kXResident, kXStream };
static_assert(kItemStream % 1024 == 0, "a swizzled box starts on 1024 bytes");

struct Args {
  HArgs h;
  const bf16* b1;      // (n*2C)
  bf16* out;           // (B, T, n*2C)
  const bf16* img_h;   // cond_0's weights as h's B (cond_chain_bf16.cuh), per batch row
  int two_c, cpc;      // output columns; output chunks a CTA (1 or all)
  W0Geo geo;
  CUtensorMap w1;      // w1t (n, 3, 2C, Cc8) as (c: Cc8, o: 2C, j: 3, i: n), box (64, W, 1, 1)
  CUtensorMap x;       // exc (B, T, E) as (e: E, t: T, b: B, 1), box (8 or 64, 128, 1, 1)
};

// W: output columns per chunk (64 or 32); N = 3W columns of P. The W1 ring
// has 2 stages where W = 64 and the h ring brings exc's boxes (kXStream),
// else 3 (W = 64) or 4.
template <int W, int kX>
struct Geo {
  static constexpr int kN = 3 * W;
  static constexpr int kStageBytes = 3 * W * 128;
  static constexpr int kStages = W == 32 ? 4 : kX == kXStream ? 2 : 3;
  static constexpr int kHRingBytes =
      kX == kXStream ? 2 * kItemStream : kResidentBoxes * kXBox8 + kHSlots * kWSlot;
  static constexpr int kLdp = kN + 8;  // floats per row of P in shared memory
  static constexpr size_t kPBytes = (size_t)kRows * kLdp * 4;
  // the W1 ring, the h ring, per warpgroup P, the barriers; +1024 to align
  // the base
  static constexpr size_t kSmem = (size_t)kStages * kStageBytes + kHRingBytes + 2 * kPBytes +
                                  8 * (2 * kStages + 2 * kHSlots + 1) + 1024;
  static_assert(kSmem <= kSmemMax, "K1-bf16's shared memory");
};

template <int W>
__device__ __forceinline__ void wgmma_p(float (&d)[3 * W / 2], const uint32_t (&a)[4],
                                        uint64_t db) {
  if constexpr (W == 64) {
    wgmma_rs_n192(d, a, db, 1);
  } else {
    wgmma_rs_n96(d, a, db, 1);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// The h ring: two slots of kBytes (a chunk of img_h; in kXStream a box of
// exc and the chunk after it), each with a full and an empty barrier (one
// arrival per consumer warp), taken in the order the producer fills them
template <int kBytes>
struct HRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  __device__ __forceinline__ unsigned char* slot(int k) const { return base + (k & 1) * kBytes; }
  __device__ __forceinline__ uint32_t parity(int k) const { return (uint32_t)((k >> 1) & 1); }
};

// Where this lane's ldmatrix row lies: row q of the warpgroup's 64 (lanes
// 8m .. 8m + 7 address matrix m: rows 0-7 and 8-15 of the warp's 16, of the
// slice's first 8 k, then of its second 8), and the rows and column pair of
// its own fragment registers
struct XLane {
  int q;      // the row it addresses
  int gsel;   // 0: the slice's first group of 8 k, 1: its second
  int u;      // the time row of its fragment's first row (the second is u + 8)
  int tig;
  __device__ __forceinline__ XLane(int u0) {
    const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, m = lane >> 3;
    q = 16 * w + (lane & 7) + 8 * (m & 1);
    gsel = m >> 1;
    u = u0 + 16 * w + (lane >> 2);
    tig = lane & 3;
  }
};

// The pair of X's columns (2 tig, 2 tig + 1) of group `g` past exc's groups
// (g = ngx = 3E / 8: 1, -[u == 0], -[u == T-1], then zeros; past it: zeros)
// at row u
__device__ __forceinline__ uint32_t x_extra(const HArgs& h, int g, int ngx, int u, int tig) {
  constexpr uint32_t kOne = 0x3F80u, kMinusOne = 0xBF80u;  // bf16 1 and -1
  if (g != ngx) return 0u;
  if (tig == 0) return kOne | (u == 0 ? kMinusOne << 16 : 0u);
  return tig == 1 && u == h.T - 1 ? kMinusOne : 0u;
}

// Groups g0 and g0 + 1 of X past exc's, as the slice's A registers
__device__ __forceinline__ void x_extras(uint32_t (&a)[4], const HArgs& h, const XLane& xl, int ngx,
                                         int g0) {
  if (g0 >= ngx) {
    a[0] = x_extra(h, g0, ngx, xl.u, xl.tig);
    a[1] = x_extra(h, g0, ngx, xl.u + 8, xl.tig);
  }
  if (g0 + 1 >= ngx) {
    a[2] = x_extra(h, g0 + 1, ngx, xl.u, xl.tig);
    a[3] = x_extra(h, g0 + 1, ngx, xl.u + 8, xl.tig);
  }
}

// k-slice s of X where E <= 16 (the CTA's boxes of 8 channels): group g <
// 3E/8 of 8 k is channels 8 (g % nbx) .. of tap g / nbx, in box g % nbx
__device__ __forceinline__ void x_slice8(uint32_t (&x)[4], const HArgs& h, const XLane& xl,
                                         uint32_t tile, int rowbase, int s) {
  const int nbx = h.E / 8, ngx = 3 * nbx;
  const int g = 2 * s + xl.gsel;
  const int j = g < ngx ? g / nbx : 0;
  ldmatrix_x4(x, tile + (g < ngx ? g - j * nbx : 0) * kXBox8 + (rowbase + xl.q + j) * 16);
  x_extras(x, h, xl, ngx, 2 * s);
}

// acc = lrelu(h_i) for the warpgroup's rows u0 + q and the pass's columns
// c0 + c (c < 136), in the accumulator layout, in f32; 0 outside [0, T) and
// beyond Cc, and +0 where h is -0. An M = 64, N = 136, K = 3E + 3 product on
// wgmma (A: X by ldmatrix from the exc boxes, B: img_h's chunks from the h
// ring, items hk ..), each chunk's products awaited before its slot is
// released. X's row q reads tap j of exc at the box row rowbase + q + j.
//  - E <= 16 (one chunk): x_slice8 (kXHoist: from `xh`, loaded once);
//  - E > 16 (a multiple of 64): chunk kc < 3E/64 is tap kc / (E/64)'s 64
//    channels of its box, the box's 16-byte piece p of row R at
//    (p ^ R % 8) 16 (TMA's 128-byte swizzle); the last chunk is X's ones
//    and edge indicators.
template <int kX, int kBytes>
__device__ __forceinline__ void h_pass(const Args& a, float (&acc)[68], const HRing<kBytes>& hr,
                                       int& hk, uint32_t tile, const XLane& xl,
                                       const uint32_t (&xh)[2][4], int rowbase, int u0, int c0) {
  const HArgs& h = a.h;
  const W0Geo& geo = a.geo;
  const int ngx = 3 * h.E / 8, nbe = h.E / 64;
  const int k16 = (3 * h.E + 3 + 15) / 16 * 16;
  const Lane l;
  zero(acc);
  for (int kc = 0; kc < geo.nkc; ++kc, ++hk) {
    mbar_wait(&hr.full[hk & 1], hr.parity(hk));
    const uint32_t item = smem_u32(hr.slot(hk));
    const uint32_t wb = kX == kXStream ? item + kXBox64 : item;  // the chunk of img_h
    const int slices = min(geo.kc, k16 - kc * geo.kc) / 16;
    uint32_t x[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < slices) {
        if constexpr (kX == kXHoist) {
#pragma unroll
          for (int v = 0; v < 4; ++v) x[s][v] = xh[s & 1][v];
        } else if constexpr (kX == kXResident) {
          x_slice8(x[s], h, xl, tile, rowbase, s);
        } else if (kc < 3 * nbe) {
          const int r = rowbase + xl.q + kc / nbe;
          ldmatrix_x4(x[s], item + r * 128 + (((2 * s + xl.gsel) ^ (r & 7)) << 4));
        } else {
          x[s][0] = x[s][1] = x[s][2] = x[s][3] = 0u;
          x_extras(x[s], h, xl, ngx, ngx + 2 * s);
        }
      } else {
        x[s][0] = x[s][1] = x[s][2] = x[s][3] = 0u;
      }
      fence_regs(x[s]);
    }
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (s < slices) {
        wgmma_rs_n136(acc, x[s], make_desc(wb + 256 * s, 128, geo.kc * 16, kLayoutNone), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    release(&hr.empty[hk & 1]);
  }
  const int ua = u0 + l.row, ub = ua + 8;
  if (c0 + kPass <= h.cc && ua >= 0 && ub < h.T) {  // the thread's rows and columns all in
#pragma unroll
    for (int r = 0; r < 68; ++r) acc[r] = acc[r] >= 0.f ? acc[r] + 0.f : kSlope * acc[r];
    return;
  }
#pragma unroll
  for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int u = v < 2 ? ua : ub;
      const int c = c0 + nt * 8 + 2 * l.tig + (v & 1);
      float& y = acc[nt * 4 + v];
      y = c < h.cc && u >= 0 && u < h.T ? (y >= 0.f ? y + 0.f : kSlope * y) : 0.f;  // -0 + 0 = +0
    }
  }
}

// kMulti: Cc takes more than one pass of 136 columns, so that P sums over
// passes and h is recomputed per output chunk
template <int W, bool kMulti, int kX>
__global__ void __launch_bounds__(kThreads, 1) k1_bf16_kernel(const __grid_constant__ Args a) {
  using G = Geo<W, kX>;
  constexpr int kHBytes = kX == kXStream ? kItemStream : kWSlot;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* hring = ring + G::kStages * G::kStageBytes;
  float* pbuf = reinterpret_cast<float*>(hring + G::kHRingBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(pbuf) +
                                               2 * G::kPBytes);
  uint64_t* empty = full + G::kStages;
  uint64_t* hfull = empty + G::kStages;
  uint64_t* hempty = hfull + kHSlots;
  uint64_t* xfull = hempty + kHSlots;

  const HArgs& h = a.h;
  const W0Geo& geo = a.geo;
  const int npass = kMulti ? geo.npass : 1;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int oc0 = blockIdx.z * a.cpc;  // the CTA's first chunk of W output columns
  const int warp = threadIdx.x >> 5;
  const Ring rg{G::kStages};
  // the h ring: its slots after the CTA's boxes of exc (kXHoist,
  // kXResident), or each a box and a chunk (kXStream)
  unsigned char* tile = hring;
  const HRing<kHBytes> hr{kX == kXStream ? hring : hring + kResidentBoxes * kXBox8, hfull,
                          hempty};

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < kHSlots; ++s) {
      mbar_init(&hfull[s], 1);
      mbar_init(&hempty[s], 8);
    }
    mbar_init(xfull, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: the CTA's exc boxes (E <= 16), then per block i and
    // output chunk oc, per pass p: h's chunks (each after its box of exc
    // where E > 16) where the consumers compute h, then the 3 atoms (64
    // columns of the pass's K each) of W1's three taps
    if (threadIdx.x == 256) {
      prefetch_map(&a.w1);
      prefetch_map(&a.x);
      const int nbx = h.E / 8, nbe = h.E / 64;
      if constexpr (kX != kXStream) {
        mbar_arrive_expect_tx(xfull, (uint32_t)(nbx * kXBox8));
        for (int e = 0; e < nbx; ++e) tma_load_4d(tile + e * kXBox8, &a.x, xfull, 8 * e, t0 - 2, b, 0);
      }
      const unsigned char* img_h = reinterpret_cast<const unsigned char*>(a.img_h) +
                                   (h.hbias_bstride ? (size_t)b * geo.h_image : 0);
      int k = 0, hk = 0;
      for (int i = 0; i < h.n; ++i)
        for (int oc = oc0; oc < oc0 + a.cpc; ++oc)
          for (int p = 0; p < npass; ++p) {
            if (kMulti || oc == oc0) {
              for (int kc = 0; kc < geo.nkc; ++kc, ++hk) {
                const int s = hk & 1;
                unsigned char* item = hr.slot(hk);
                const bool box = kX == kXStream && kc < 3 * nbe;
                mbar_wait(&hempty[s], hr.parity(hk) ^ 1);
                mbar_arrive_expect_tx(&hfull[s], (uint32_t)(geo.h_chunk + (box ? kXBox64 : 0)));
                if (box) tma_load_4d(item, &a.x, &hfull[s], 64 * (kc % nbe), t0 - 2, b, 0);
                const size_t ch = ((size_t)i * geo.npass + p) * geo.nkc + kc;
                bulk_load(kX == kXStream ? item + kXBox64 : item, img_h + ch * geo.h_chunk,
                          (uint32_t)geo.h_chunk, &hfull[s]);
              }
            }
            for (int atom = 0; atom < 3; ++atom, ++k) {
              const int s = rg.slot(k);
              mbar_wait(&empty[s], rg.parity(k) ^ 1);
              mbar_arrive_expect_tx(&full[s], G::kStageBytes);
              for (int j = 0; j < 3; ++j) {
                tma_load_4d(ring + s * G::kStageBytes + j * W * 128, &a.w1, &full[s],
                            p * kPass + atom * 64, oc * W, j, i);
              }
            }
          }
    }
    return;
  }

  const int wg = warp >> 2;
  const int bar = 1 + wg;
  const int tb = t0 + kOwn * wg;  // the warpgroup's first own row
  const int u0 = tb - 1;          // its h row q = 0
  const int rowbase = kOwn * wg;  // the box row of its h row q = 0's exc[u0 - 1]
  const Lane l;
  const XLane xl(u0);
  float* ps = pbuf + (size_t)wg * kRows * G::kLdp;
  const int n2 = h.n * a.two_c;
  const uint32_t tile_u32 = smem_u32(tile);
  uint32_t xh[2][4] = {};
  if constexpr (kX != kXStream) mbar_wait(xfull, 0);
  if constexpr (kX == kXHoist) {
#pragma unroll
    for (int s = 0; s < 2; ++s) x_slice8(xh[s], h, xl, tile_u32, rowbase, s);
  }

  uint32_t afr[kPassSlices][4];
  float pacc[G::kN / 2];
  int k = 0, hk = 0;
#ifdef COND_CHAIN_TIMERS
  long long t_h = 0, t_p = 0, t_e = 0;
  const long long t_all = clock64();
#endif
  for (int i = 0; i < h.n; ++i) {
    for (int oc = oc0; oc < oc0 + a.cpc; ++oc) {
      for (int p = 0; p < npass; ++p) {
        TIMER_START(t0c);
        if (kMulti || oc == oc0) {
          float acc[68];
          h_pass<kX>(a, acc, hr, hk, tile_u32, xl, xh, rowbase, u0, p * kPass);
          // a = bf16(lrelu(h)) as the A of P: k-slice s is n8 chunks 2s, 2s + 1
#pragma unroll
          for (int s = 0; s < kPassSlices; ++s) {
            afr[s][0] = pack_rn(acc[8 * s], acc[8 * s + 1]);
            afr[s][1] = pack_rn(acc[8 * s + 2], acc[8 * s + 3]);
            if (s < kPassSlices - 1) {
              afr[s][2] = pack_rn(acc[8 * s + 4], acc[8 * s + 5]);
              afr[s][3] = pack_rn(acc[8 * s + 6], acc[8 * s + 7]);
            } else {  // columns 136 .. 143: zero
              afr[s][2] = afr[s][3] = 0u;
            }
            fence_regs(afr[s]);
          }
        }
        TIMER_ADD(t_h, t0c);
        TIMER_START(t1c);
        if (p == 0) zero(pacc);
        int prev = -1;
#pragma unroll
        for (int atom = 0; atom < 3; ++atom, ++k) {
          const int s = rg.slot(k);
          mbar_wait(&full[s], rg.parity(k));
          const uint32_t base = smem_u32(ring + s * G::kStageBytes);
          wgmma_fence();
#pragma unroll
          for (int sl = 0; sl < (atom < 2 ? 4 : 1); ++sl) {
            wgmma_p<W>(pacc, afr[atom * 4 + sl], desc_sw128(base + 32 * sl));
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (prev >= 0) release(&empty[prev]);
          prev = s;
        }
        wgmma_wait<0>();
        release(&empty[prev]);
        TIMER_ADD(t_p, t1c);
      }
      fence_regs(pacc);
      TIMER_START(t2c);

      // out[t] = b1 + P_0[r] + P_1[r + 1] + P_2[r + 2] for own row r (t = tb + r)
      bar_sync(bar, 128);  // the last chunk's reads of ps are done
#pragma unroll
      for (int nt = 0; nt < G::kN / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          *reinterpret_cast<float2*>(ps + (l.row + 8 * half) * G::kLdp + nt * 8 + 2 * l.tig) =
              make_float2(pacc[nt * 4 + 2 * half], pacc[nt * 4 + 2 * half + 1]);
        }
      }
      bar_sync(bar, 128);
      // a thread keeps its 4 columns o .. o + 3 (128 is a multiple of W / 4):
      // a warp stores whole rows of the chunk, 8 bytes a thread
      const int o = 4 * (l.wt % (W / 4));
      if (oc * W + o < a.two_c) {
        const int col = i * a.two_c + oc * W + o;
        const float2 b01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b1 + col));
        const float2 b23 =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(a.b1 + col + 2));
        for (int r = l.wt / (W / 4); r < kOwn && tb + r < h.T; r += 128 / (W / 4)) {
          const float* pr = ps + r * G::kLdp + o;
          const float4 p0 = *reinterpret_cast<const float4*>(pr);
          const float4 p1 = *reinterpret_cast<const float4*>(pr + G::kLdp + W);
          const float4 p2 = *reinterpret_cast<const float4*>(pr + 2 * G::kLdp + 2 * W);
          *reinterpret_cast<uint2*>(a.out + ((size_t)b * h.T + tb + r) * n2 + col) =
              make_uint2(pack_rn(b01.x + p0.x + p1.x + p2.x, b01.y + p0.y + p1.y + p2.y),
                         pack_rn(b23.x + p0.z + p1.z + p2.z, b23.y + p0.w + p1.w + p2.w));
        }
      }
      TIMER_ADD(t_e, t2c);
    }
  }
#ifdef COND_CHAIN_TIMERS
  if (l.wt == 0) {
    atomicAdd(&g_timers[0], (unsigned long long)t_h);
    atomicAdd(&g_timers[1], (unsigned long long)t_p);
    atomicAdd(&g_timers[2], (unsigned long long)t_e);
    atomicAdd(&g_timers[3], (unsigned long long)(clock64() - t_all));
    atomicAdd(&g_timers[4], 1ull);
  }
#endif
}

struct FwdPlan {
  int w, noc, ntiles, cpc;
  W0Geo geo;
  size_t off_w1t, total;  // workspace: img_h, then w1t
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0) {
      n = 132;  // an H100's
    }
  }
  return n;
}

FwdPlan fwd_plan(int B, int T, int E, int n, int cc, int two_c) {
  FwdPlan p{};
  p.geo = w0_geo(E, n, cc);
  const bool multi = p.geo.npass > 1;
  // W = 64 but where 2C <= 32, or where Cc takes several passes (P's
  // accumulators then live beside h's: 48 + 68 registers, not 96 + 68)
  p.w = two_c <= 32 || multi ? 32 : 64;
  p.noc = (two_c + p.w - 1) / p.w;
  p.ntiles = (T + kTile - 1) / kTile;
  p.off_w1t = ((size_t)B * p.geo.h_image + 255) / 256 * 256;
  p.total = p.off_w1t + (size_t)n * 3 * two_c * ((cc + 7) / 8 * 8) * 2;
  // a CTA per output chunk where the tiles alone leave SMs idle, or where
  // Cc takes several passes (h is then computed per chunk in either grid);
  // else every chunk in one CTA, h once a tile (fewer CTAs, each filling its
  // rings once: 9% less time at the conversion's first stage, 304 tiles)
  p.cpc = multi || (long long)p.ntiles * B < sm_count() ? 1 : p.noc;
  return p;
}

template <int W, bool kMulti, int kX>
int launch(const Args& a, int B, const FwdPlan& p, cudaStream_t stream) {
  return (int)launch_kernel(k1_bf16_kernel<W, kMulti, kX>,
                            dim3((unsigned)p.ntiles, (unsigned)B, (unsigned)(p.noc / p.cpc)),
                            kThreads, Geo<W, kX>::kSmem, a, stream);
}

// the instance for the widths: W = 32 wherever Cc takes several passes
template <int kX>
int launch_mode(const Args& a, int B, const FwdPlan& p, cudaStream_t stream) {
  if (p.geo.npass > 1) return launch<32, true, kX>(a, B, p, stream);
  return p.w == 64 ? launch<64, false, kX>(a, B, p, stream) : launch<32, false, kX>(a, B, p, stream);
}

// E: exc's channels, a multiple of 8 up to 16, else of 64 (the wrapper pads
// exc and W0): exc's rows are then multiples of 16 bytes, as TMA wants, a
// group of 8 k of cond_0's product is one tap's 8 channels, and past 16 a
// chunk of 64 k is one tap's 64 channels.
bool shapes_ok(int B, int T, int E, int n, int cc, int two_c) {
  return B > 0 && B <= 65535 && T > 0 && E > 0 && E % (E <= 16 ? 8 : 64) == 0 && n > 0 &&
         cc > 0 && two_c > 0 && cc % 4 == 0 && two_c % 4 == 0;
}

// A tensor map over exc (B, T, E) bf16 as (e, t, b, 1), in boxes of 8
// channels (no swizzle: a box lands as its 16-byte rows, one after the
// other) or 64 (128-byte rows, 128-byte swizzle) x kXRows rows, zeros out of
// bounds
bool make_x_map(CUtensorMap* map, const void* exc, int B, int T, int E) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const bool wide = E > 16;
  const cuuint64_t dims[4] = {(cuuint64_t)E, (cuuint64_t)T, (cuuint64_t)B, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)E * 2, (cuuint64_t)E * 2 * T,
                                 (cuuint64_t)E * 2 * T * B};
  const cuuint32_t box[4] = {wide ? 64u : 8u, kXRows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(exc), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            wide ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" const char* cond_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Bytes of device scratch cond_chain_fwd_bf16 needs for these shapes: the
// images of the weights it makes at each launch.
extern "C" long long cond_chain_fwd_bf16_workspace(int B, int E, int n, int cc, int two_c) {
  return shapes_ok(B, 1, E, n, cc, two_c) ? (long long)fwd_plan(B, 1, E, n, cc, two_c).total
                                          : 0;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); shapes
// the kernel does not take (shapes_ok), exc not 16-byte aligned, too little
// workspace, or a tensor map cuTensorMapEncodeTiled refuses give an error
// code. Every pointer but ws is
// to bf16, w1 in its own (3, Cc, n*2C) layout.
extern "C" int cond_chain_fwd_bf16(const void* exc, const void* w0, const void* hbias,
                                   long long hbias_bstride, const void* edge0,
                                   const void* edge_t, const void* w1, const void* b1,
                                   void* out, void* ws, long long ws_bytes, int B, int T, int E,
                                   int n, int cc, int two_c, void* stream) {
  if (!shapes_ok(B, T, E, n, cc, two_c) || (uintptr_t)exc % 16) return (int)cudaErrorInvalidValue;
  const FwdPlan p = fwd_plan(B, T, E, n, cc, two_c);
  if (ws_bytes < (long long)p.total || (uintptr_t)ws % 256) return (int)cudaErrorInvalidValue;
  unsigned char* wsb = static_cast<unsigned char*>(ws);
  Args a;
  a.h.exc = static_cast<const bf16*>(exc);
  a.h.w0 = static_cast<const bf16*>(w0);
  a.h.hbias = static_cast<const bf16*>(hbias);
  a.h.hbias_bstride = hbias_bstride;
  a.h.edge0 = static_cast<const bf16*>(edge0);
  a.h.edge_t = static_cast<const bf16*>(edge_t);
  a.h.T = T;
  a.h.E = E;
  a.h.n = n;
  a.h.cc = cc;
  a.b1 = static_cast<const bf16*>(b1);
  a.out = static_cast<bf16*>(out);
  a.img_h = reinterpret_cast<const bf16*>(wsb);
  a.two_c = two_c;
  a.cpc = p.cpc;
  a.geo = p.geo;
  bf16* w1t = reinterpret_cast<bf16*>(wsb + p.off_w1t);
  const cuuint64_t cc8 = (cuuint64_t)(cc + 7) / 8 * 8;
  const cuuint64_t dims[4] = {cc8, (cuuint64_t)two_c, 3, (cuuint64_t)n};
  const cuuint64_t strides[3] = {cc8 * 2, cc8 * 2 * two_c, cc8 * 2 * two_c * 3};
  const cuuint32_t box[4] = {64, (cuuint32_t)p.w, 1, 1};
  if (!make_map(&a.w1, w1t, 4, dims, strides, box) || !make_x_map(&a.x, exc, B, T, E)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  ImageArgs im{a.h, static_cast<const bf16*>(w1), reinterpret_cast<bf16*>(wsb), nullptr, w1t,
               hbias_bstride ? B : 1, two_c};
  cudaError_t e = launch_images(im, st);
  if (e != cudaSuccess) return (int)e;
  if (E > 16) return launch_mode<kXStream>(a, B, p, st);
  return p.geo.kc <= 32 ? launch_mode<kXHoist>(a, B, p, st) : launch_mode<kXResident>(a, B, p, st);
}

#ifdef COND_CHAIN_TIMERS
// The diagnostic build's cycle sums since the last reset (h, P, epilogue,
// whole kernel, warpgroups) into out[5]; then zero them where `reset`.
extern "C" int cond_chain_fwd_bf16_timers(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_timers, sizeof(g_timers));
  if (e == cudaSuccess && reset) {
    const unsigned long long zeros[5] = {0, 0, 0, 0, 0};
    e = cudaMemcpyToSymbol(g_timers, zeros, sizeof(zeros));
  }
  return (int)e;
}
#endif

// The rows of the time tile cond_chain_fwd_bf16 takes at these widths, as
// the wrapper pads them (124: every width goes in passes of 136 columns), or
// 0 for widths it does not take.
extern "C" int cond_chain_fwd_bf16_tile(int E, int cc, int two_c) {
  return shapes_ok(1, 1, E, 1, cc, two_c) ? kTile : 0;
}
