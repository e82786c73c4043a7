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
// flops per byte): bound by operations; after the products, by the bytes
// of the dh scratch that the data kernel writes for dW0 and the edges and
// that k2b_xdh_kernel reads back (2.8 GB each way at B = 128, T = 8960,
// n Cc = 1224).
//
// What the design does about it: the work is split into kernels that each
// own their outputs, every sum runs in a fixed order (the same result every
// run, no atomics), every product runs on wgmma (hopper_bf16.cuh) with f32
// accumulators in registers, and every operand in shared memory comes by
// TMA or a bulk copy through mbarrier rings. Each kernel has the CTA of
// cond_chain_bf16.cuh: two consumer warpgroups and a producer warp.
//
//  (a) k2b_data_kernel, one CTA per (batch row, 124-row time tile): two
//      consumer warpgroups of 64 rows of h each. Per block i and pass of 136
//      columns of h:
//       - h_i on wgmma (M = 64, N = 136, K = 3E + 3: exc's taps, the bias
//         and the edge corrections, A from registers; B a bulk copy of an
//         image w_images_kernel makes at each launch), lrelu in f32, to
//         shared memory as bf16 pairs (a);
//       - da_i on wgmma in the same accumulator layout (M = 64, N = 136,
//         K = 3 x 2C), both operands fed by TMA into a ring of 3 stages with
//         full/empty mbarriers: a stage is 64 columns of g_i for one tap at
//         each warpgroup's rows (the tap window t0 - j + 62 w: a 4-D tensor
//         map over (2C, n, T, B) whose zero fill outside [0, T) gives the
//         'same' conv's zero rows at both ends of every batch row, and past
//         2C the zero columns of a ragged k-slice) and the matching 136 x 64
//         tile of W1_i (a tensor map over (2C, n, Cc, 3)). The producer
//         thread runs ahead across taps, passes and blocks, so block i+1's
//         weights are in flight while block i finishes;
//       - the slope where(h >= 0, 1, 0.2) is thread-local: each thread
//         reads back the a it wrote, whose sign (lrelu(-0) = +0) is the
//         sign of the f32 h, in da's layout; dh = bf16(slope da); no f32 h
//         or dh buffer in shared memory, and a in shared memory rather than
//         in registers, which da's accumulators need (ptxas caps the
//         kernel at 168 registers a thread; spills overflow into L2, as the
//         shared memory leaves L1 ~28 KB);
//       - dh to shared memory in bf16; from there the own rows of dh go to
//         the scratch (for (c)) in 16-byte pieces, rows ld = n Cc rounded
//         up to 8 apart (a TMA stride);
//       - the tile's dexc, an M = 64, N = 8 (E in chunks of 8), K = 3 x 144
//         product on wgmma with both operands in shared memory (dh, and W0's
//         image from the weights ring), added to an f32 sum over the blocks
//         and passes (a scratch the CTA owns), rounded to bf16 after the
//         last.
//      The row shift of the dexc conv: dh lies in shared memory without
//      swizzle, each 8-column chunk holding all its rows 16 bytes apart, so
//      that tap j's window (dh one or two rows down) is the same descriptor
//      16 or 32 bytes further on.
//  (b) k2b_w1_kernel, dW1 and db1, with no scratch of a. A CTA owns (block
//      i, pass p, 64 columns o of g_i) and a chunk of units; a unit is a
//      batch row's 62 rows t0 .. t0 + 61 of g. Three warpgroups, each with
//      its own part (warp-specialized, so that the recompute of one unit
//      overlaps the products of the one before):
//       - warpgroup 0 recomputes a = bf16(lrelu(h_i)) for the unit's rows
//         t0 - 1 .. t0 + 62 as (a) computes it (the same A registers, the
//         same image of cond_0's weights, the same k-slices and the same
//         m64n136 instruction: the same bits), and writes it to one of two
//         slots of shared memory without swizzle, each 8-column chunk
//         holding its 64 rows 16 bytes apart, then zeros (MN-major for the
//         products' B). Its first thread asks for each unit's g (TMA, a map
//         like (a)'s with a box of 62 rows: zeros outside [0, T) and past
//         2C; rows 62 and 63 of a stage stay zero) and, at E = 8, the unit's
//         exc rows (a bulk copy) two units ahead, so that neither load is
//         waited on; the image comes by bulk copy once a batch row when K
//         fits one chunk;
//       - warpgroups 1 and 2 take dW1_i[j] += g^T a(rows shifted by j) on
//         wgmma, each on 72 columns c of a: M = the 64 columns o (A: the g
//         tile, MN-major, 128-byte swizzle), N = 72 (B: a, MN-major), K = 64
//         rows in 4 slices, the three taps' f32 accumulators in registers
//         (108 a thread). Tap j's B is the same descriptor 16 j bytes
//         further on, a one or two rows down: the conv's zero rows are g's
//         zero fill and a's zeros outside [0, T). In the first pass's CTAs
//         warpgroup 1 also sums g's columns (db1: the g tile against a
//         chunk of ones, M = 64, N = 8).
//      It writes f32 partials per chunk of units. The chunks are as many as
//      make the CTAs one wave of the card's 132 SMs (one CTA an SM).
//  (c) k2b_xdh_kernel, dW0, dhbias, dedge0 and dedge_t as one product,
//      X^T dh, with X the rows of h's A in (a),
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
//  (d) k2b_reduce_kernel sums every kind of partial over its chunks in
//      order and rounds once (one launch for all of them).
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

constexpr int kSmCount = 132;  // an H100's SMs: k2b_w1_kernel's CTAs make one wave

// The data kernel's shared memory: a ring of kStages stages of (64 rows of g
// for each consumer warpgroup, 136 rows of W1), each 128-byte swizzled rows
// of 64 columns; the weights ring (two slots); per warpgroup dh (19 chunks
// of 8 columns x 64 rows x 16 bytes: the pass's 144 columns and a zero
// chunk, which the last tap's window reads two rows into) and a in the same
// layout (17 chunks); the barriers.
constexpr int kStages = 3;
constexpr int kGBytes = kRows * 128;     // 8192
constexpr int kW1Bytes = kPass * 128;    // 17408
constexpr int kStageBytes = 2 * kGBytes + kW1Bytes;
constexpr int kDhChunk = kRows * 16;     // 1024: the LBO of the dh operand
constexpr int kDhBytes = (2 * kPassSlices + 1) * kDhChunk;
constexpr int kABytes = (kPass / 8) * kDhChunk;
constexpr int kW0xTap = 2 * kPassSlices * 128;  // 2304: one tap of an img_x chunk
constexpr size_t kDataSmem = (size_t)kStages * kStageBytes + 2 * kWSlot +
                             2 * (size_t)(kDhBytes + kABytes) + 16 * (kStages + 2) + 1024;
static_assert(kDataSmem <= kSmemMax, "K2-bf16's data kernel's shared memory");

struct DataArgs {
  HArgs h;
  const bf16* img_h;   // cond_0's weights as h's B (cond_chain_bf16.cuh), per batch row
  const bf16* img_x;   // ... and as dexc's B
  bf16* dh_out;        // (B, T, ld) scratch: dh
  long long ld;
  float* dexc_acc;     // (B, T, E) scratch: dexc summed over the blocks and passes so far
  bf16* dexc;          // (B, T, E)
  int two_c, noc;
  W0Geo geo;
  CUtensorMap g_map;   // g as (o: 2C, i: n, t: T, b: B), box (64, 1, 64, 1)
  CUtensorMap w1_map;  // w1 as (o: 2C, i: n, c: Cc, j: 3), box (64, 1, 136, 1)
};

__global__ void __launch_bounds__(kThreads, 1) k2b_data_kernel(const __grid_constant__ DataArgs a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* wslots = ring + kStages * kStageBytes;
  unsigned char* dhs_all = wslots + 2 * kWSlot;
  unsigned char* as_all = dhs_all + 2 * kDhBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(as_all + 2 * kABytes);
  uint64_t* empty = full + kStages;
  uint64_t* wfull = empty + kStages;
  uint64_t* wempty = wfull + 2;

  const HArgs& h = a.h;
  const W0Geo& geo = a.geo;
  const int b = blockIdx.y;
  const int tix = blockIdx.x;
  const int t0 = tix * kTile;
  const int warp = threadIdx.x >> 5;
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
  // dh's columns 136..143, and the chunk after them, stay zero
  for (int idx = threadIdx.x; idx < 2 * kDhBytes / 16; idx += kThreads) {
    reinterpret_cast<uint4*>(dhs_all)[idx] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  if (warp == 8) {
    // the producer, per block i and pass p: h's weights, then (tap j, chunk
    // oc of g's 2C columns) stages, then dexc's weights, in the order the
    // consumers take them
    if (threadIdx.x == 256) {
      prefetch_map(&a.g_map);
      prefetch_map(&a.w1_map);
      const unsigned char* img_h = reinterpret_cast<const unsigned char*>(a.img_h) +
                                   (h.hbias_bstride ? (size_t)b * geo.h_image : 0);
      const WRing pw{wslots, wfull, wempty, 0};
      int k = 0, wk = 0;
      for (int i = 0; i < h.n; ++i)
        for (int p = 0; p < geo.npass; ++p) {
          const size_t unit = (size_t)i * geo.npass + p;
          for (int kc = 0; kc < geo.nkc; ++kc) {
            wring_put(pw, wk, img_h + (unit * geo.nkc + kc) * geo.h_chunk,
                      (uint32_t)geo.h_chunk);
          }
          for (int j = 0; j < 3; ++j)
            for (int oc = 0; oc < a.noc; ++oc, ++k) {
              const int s = rg.slot(k);
              unsigned char* st = ring + s * kStageBytes;
              mbar_wait(&empty[s], rg.parity(k) ^ 1);
              mbar_arrive_expect_tx(&full[s], kStageBytes);
              // warpgroup w's A row q is h row t0 + 62 w - 1 + q: tap j reads g row t0 + 62 w - j + q
              tma_load_4d(st, &a.g_map, &full[s], oc * 64, i, t0 - j, b);
              tma_load_4d(st + kGBytes, &a.g_map, &full[s], oc * 64, i, t0 + kOwn - j, b);
              tma_load_4d(st + 2 * kGBytes, &a.w1_map, &full[s], oc * 64, i, p * kPass, j);
            }
          for (int ec = 0; ec < geo.nec; ++ec) {
            wring_put(pw, wk,
                      reinterpret_cast<const unsigned char*>(a.img_x) +
                          (unit * geo.nec + ec) * kXChunk,
                      (uint32_t)kXChunk);
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
  unsigned char* dhs = dhs_all + wg * kDhBytes;
  unsigned char* as = as_all + wg * kABytes;
  const uint32_t dhs_u = smem_u32(dhs);
  const bool vec16 = h.cc % 8 == 0;  // block offsets in the scratch's rows 16-byte aligned
  const XFrags xf(h, geo, b, u0);
  WRing wr{wslots, wfull, wempty, 0};

  float dd[68];  // h, then da, then dh
  int k = 0;
  for (int i = 0; i < h.n; ++i) {
    for (int p = 0; p < geo.npass; ++p) {
      const int c0 = p * kPass;
      // a = bf16(lrelu(h)) to shared memory (chunk c / 8, row q), where the
      // slope step reads its sign (h's) back
      act_pass(h, dd, wr, geo, xf, b, u0, c0);
      bar_sync(bar, 128);  // the last unit's reads of dhs and as are done
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int v = nt * 4 + 2 * half;
          *reinterpret_cast<uint32_t*>(as + nt * kDhChunk + (l.row + 8 * half) * 16 +
                                       4 * l.tig) = pack_rn(dd[v], dd[v + 1]);
        }
      }

      // da[q][c] = sum_j sum_o g[u0 + q - j + 1][o] W1_i[j][c][o]
      zero(dd);
      int prev = -1;
      for (int j = 0; j < 3; ++j) {
        for (int oc = 0; oc < a.noc; ++oc, ++k) {
          const int s = rg.slot(k);
          const int slices = (min(64, a.two_c - oc * 64) + 15) / 16;
          mbar_wait(&full[s], rg.parity(k));
          const uint32_t gbase = smem_u32(ring + s * kStageBytes + wg * kGBytes);
          const uint32_t wbase = smem_u32(ring + s * kStageBytes + 2 * kGBytes);
          wgmma_fence();
          for (int sl = 0; sl < slices; ++sl) {
            wgmma_ss_n136(dd, desc_sw128(gbase + 32 * sl), desc_sw128(wbase + 32 * sl), 1);
          }
          wgmma_commit();
          wgmma_wait<1>();
          if (prev >= 0) release(&empty[prev]);
          prev = s;
        }
      }
      wgmma_wait<0>();
      release(&empty[prev]);
      fence_regs(dd);

      // dh = bf16(lrelu'(h) da), zero outside [0, T), to shared memory
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const int u = u0 + q;
          const bool valid = u >= 0 && u < h.T;
          const int v = nt * 4 + 2 * half;
          const int off = nt * kDhChunk + q * 16 + 4 * l.tig;
          const uint32_t av = *reinterpret_cast<const uint32_t*>(as + off);
          const float d0 = valid ? round_bf16(av & 0x8000u ? kSlope * dd[v] : dd[v]) : 0.f;
          const float d1 =
              valid ? round_bf16(av & 0x80000000u ? kSlope * dd[v + 1] : dd[v + 1]) : 0.f;
          *reinterpret_cast<uint32_t*>(dhs + off) = pack_rn(d0, d1);
        }
      }
      fence_proxy_async();
      bar_sync(bar, 128);

      // dh of the own rows (q = 1 .. 62) to the scratch (for k2b_xdh_kernel),
      // 8 columns a thread, consecutive threads along a row
      for (int idx = l.wt; idx < kOwn * (kPass / 8); idx += 128) {
        const int q = 1 + idx / (kPass / 8);
        const int ch = idx - (q - 1) * (kPass / 8);
        const int c = c0 + ch * 8;
        if (c >= h.cc || u0 + q >= h.T) continue;
        const uint4 dv = *reinterpret_cast<const uint4*>(dhs + ch * kDhChunk + q * 16);
        bf16* dst = a.dh_out + ((size_t)b * h.T + u0 + q) * a.ld + (size_t)i * h.cc + c;
        if (vec16) {
          *reinterpret_cast<uint4*>(dst) = dv;
        } else {  // Cc a multiple of 4: 8-byte pieces
          *reinterpret_cast<uint2*>(dst) = make_uint2(dv.x, dv.y);
          if (c + 4 < h.cc) *reinterpret_cast<uint2*>(dst + 4) = make_uint2(dv.z, dv.w);
        }
      }

      // dexc[tb + r] += sum_j sum_c dh[q = r + 2 - j][c] W0[j][e][i Cc + c]
      const bool first = i == 0 && p == 0;
      const bool last = i == h.n - 1 && p == geo.npass - 1;
      for (int ec = 0; ec < geo.nec; ++ec) {
        float dx[4];
        zero(dx);
        const uint32_t xbase = wr.wait();
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 3; ++j) {
#pragma unroll
          for (int sl = 0; sl < kPassSlices; ++sl) {
            wgmma_ss_n8(dx,
                        make_desc(dhs_u + 2 * sl * kDhChunk + (2 - j) * 16, kDhChunk, 128,
                                  kLayoutNone),
                        make_desc(xbase + j * kW0xTap + 256 * sl, 128, 256, kLayoutNone), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dx);
        wr.release();
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int r = l.row + 8 * (v >> 1);
          const int t = tb + r;
          const int e = ec * 8 + 2 * l.tig + (v & 1);
          if (r >= kOwn || t >= h.T || e >= h.E) continue;
          const size_t idx = ((size_t)b * h.T + t) * h.E + e;
          const float d = first ? dx[v] : a.dexc_acc[idx] + dx[v];
          if (last) {
            a.dexc[idx] = __float2bfloat16_rn(d);
          } else {
            a.dexc_acc[idx] = d;
          }
        }
      }
    }
  }
}

// k2b_w1_kernel's CTA: three warpgroups, 384 threads (168 registers a
// thread: three warps on each of the SM's four register files). Warpgroup
// 0 recomputes each unit's a and keeps the ring of g tiles fed (its first
// thread asks for a unit's g kW1Ahead units ahead); warpgroups 1 and 2 take
// the products, each on 72 columns of a (its three taps' accumulators, 108
// registers a thread). Shared memory: the ring of kW1Stages tiles of g (62
// rows of 64 columns, 128-byte swizzled, and two zero rows); two slots of
// a (18 chunks of 8 columns x kARows rows x 16 bytes: the unit's 64 rows,
// then zeros; the last chunk, columns 136 .. 143, zero); two slots of the
// image of cond_0's weights; a chunk of ones (db1's B); at E = 8, a ring
// of the units' exc rows (t0 - 2 .. t0 + 63, 16 bytes each); the barriers.
constexpr int kW1Threads = 384;
constexpr int kW1Stages = 4;
constexpr int kW1Ahead = 2;
constexpr int kW1Cols = 72;                          // columns of a (N) a product warpgroup
constexpr int kARows = 72;
constexpr int kAChunk = kARows * 16;                 // 1152: the SBO of a as B
constexpr int kASlot = (2 * kW1Cols / 8) * kAChunk;  // 20736
constexpr int kOnes = 512;
constexpr int kXRows = kRows + 2;       // exc rows a unit's X reads
constexpr int kXSlot = kXRows * 16;    // 1056 bytes: a slot of the exc ring
constexpr size_t kW1Smem = (size_t)kW1Stages * kGBytes + 2 * kASlot + 2 * kWSlot + kOnes +
                           kW1Stages * kXSlot + 8 * (3 * kW1Stages + 6) + 1024;
static_assert(kW1Smem <= kSmemMax, "k2b_w1_kernel's shared memory");
static_assert(2 * kW1Cols >= kPass && kW1Ahead < kW1Stages, "k2b_w1_kernel's shape");

struct W1Args {
  HArgs h;
  const bf16* img_h;  // as DataArgs'
  float* pw1;         // (S, 3, Cc, n*2C): dW1 per chunk
  float* pb1;         // (S, n*2C): db1 per chunk
  int two_c, notiles, nsub, units, chunk;  // units = B nsub of 62 rows; chunk: units a CTA
  int vec;            // E = 8 and exc 16-byte aligned: a unit's exc rows by one bulk copy
  W0Geo geo;
  CUtensorMap g_map;  // g as (o: 2C, i: n, t: T, b: B), box (64, 1, 62, 1)
};

// X[u0 + q][k] at E = 8 from the unit's exc rows in shared memory (xs: rows
// t0 - 2 .. t0 + 63 of the batch row, u0 = t0 - 1)
__device__ __forceinline__ uint32_t x_at_rows(const HArgs& h, const unsigned char* xs, int u0,
                                              int q, int k) {
  constexpr uint32_t kOne = 0x3F80u, kMinusOne = 0xBF80u;  // bf16 1 and -1
  const int u = u0 + q;
  if (k < 24) {
    const int j = k >> 3;
    const int t = u + j - 1;
    if (t < 0 || t >= h.T) return 0u;
    return *reinterpret_cast<const uint16_t*>(xs + (q + j) * 16 + (k & 7) * 2);
  }
  if (k == 24) return kOne;
  if (k == 25) return u == 0 ? kMinusOne : 0u;
  if (k == 26) return u == h.T - 1 ? kMinusOne : 0u;
  return 0u;
}

__global__ void __launch_bounds__(kW1Threads, 1) k2b_w1_kernel(const __grid_constant__ W1Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* aslots = ring + kW1Stages * kGBytes;
  unsigned char* wslots = aslots + 2 * kASlot;
  unsigned char* ones = wslots + 2 * kWSlot;
  unsigned char* xring = ones + kOnes;
  uint64_t* g_full = reinterpret_cast<uint64_t*>(xring + kW1Stages * kXSlot);
  uint64_t* g_empty = g_full + kW1Stages;
  uint64_t* a_full = g_empty + kW1Stages;
  uint64_t* a_empty = a_full + 2;
  uint64_t* w_full = a_empty + 2;
  uint64_t* x_full = w_full + 2;

  const HArgs& h = a.h;
  const W0Geo& geo = a.geo;
  const int ot = blockIdx.x % a.notiles;
  const int ip = blockIdx.x / a.notiles;
  const int p = ip % geo.npass;
  const int i = ip / geo.npass;
  const int o0 = ot * 64;
  const int c0 = p * kPass;
  const int s = blockIdx.y;
  const int k_begin = s * a.chunk;
  const int k_end = min(a.units, k_begin + a.chunk);
  const int wg = warp_index() >> 2;
  const Lane l;
  const Ring rg{kW1Stages};

  if (threadIdx.x == 0) {
    for (int k = 0; k < kW1Stages; ++k) {
      mbar_init(&g_full[k], 1);
      mbar_init(&g_empty[k], 8);  // one arrival per product warp
      mbar_init(&x_full[k], 1);
    }
    for (int k = 0; k < 2; ++k) {
      mbar_init(&a_full[k], 4);   // one arrival per recompute warp
      mbar_init(&a_empty[k], 8);
      mbar_init(&w_full[k], 1);
    }
    fence_barrier_init();
  }
  // zeros under g's rows 62 and 63 and a's rows 64 .. 71 and columns 136 ..
  // 143; then the ones
  for (int idx = threadIdx.x; idx < (int)(wslots - smem) / 16; idx += kW1Threads) {
    reinterpret_cast<uint4*>(smem)[idx] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int idx = threadIdx.x; idx < kOnes / 4; idx += kW1Threads) {
    reinterpret_cast<uint32_t*>(ones)[idx] = 0x3F803F80u;  // bf16 1.0 pairs
  }
  fence_proxy_async();
  __syncthreads();

  const bool hoisted = geo.nkc == 1 && geo.kc <= 32;  // K = 3E + 3 <= 32: the decoder's E = 8
  const bool xsmem = hoisted && a.vec;
  // the g tile of unit k (the CTA's n-th) into its stage, once the products
  // of the unit kW1Stages before are done with it; at E = 8 also its exc
  // rows (t0 - 2 .. t0 + 63, those inside [0, T)), into the same slot of
  // the exc ring, which only warpgroup 0 reads
  auto ask_g = [&](int k, int n) {
    const int b = k / a.nsub;
    const int t0 = (k - b * a.nsub) * kOwn;
    const int st = rg.slot(n);
    mbar_wait(&g_empty[st], rg.parity(n) ^ 1);
    mbar_arrive_expect_tx(&g_full[st], kOwn * 128);
    tma_load_4d(ring + st * kGBytes, &a.g_map, &g_full[st], o0, i, t0, b);
    if (xsmem) {
      const int lo = max(0, t0 - 2), hi = min(h.T, t0 + kRows);
      mbar_arrive_expect_tx(&x_full[st], (uint32_t)(hi - lo) * 16);
      bulk_load(xring + st * kXSlot + (lo - t0 + 2) * 16, h.exc + ((size_t)b * h.T + lo) * 8,
                (uint32_t)(hi - lo) * 16, &x_full[st]);
    }
  };

  if (wg == 0) {
    // a = bf16(lrelu(h_i)) of the unit's rows u0 + q and the pass's columns,
    // as k2b_data_kernel computes it (act_pass): the same A registers, image
    // chunks, k-slices and instruction
    if (l.wt == 0) {
      prefetch_map(&a.g_map);
      for (int n = 0; n < kW1Ahead && k_begin + n < k_end; ++n) ask_g(k_begin + n, n);
    }
    const bool resident = geo.nkc == 1;  // one image chunk: fetched once a batch row
    int loads = 0, prev_b = -1;
    // chunk kc of batch row b's image into the next slot, once every
    // recompute warp is done with what it held two fetches ago
    auto fetch = [&](int b, int kc) -> uint32_t {
      const int slot = loads & 1;
      unsigned char* dst = wslots + slot * kWSlot;
      bar_sync(1, 128);
      if (l.wt == 0) {
        mbar_arrive_expect_tx(&w_full[slot], (uint32_t)geo.h_chunk);
        bulk_load(dst,
                  reinterpret_cast<const unsigned char*>(a.img_h) +
                      (h.hbias_bstride ? (size_t)b * geo.h_image : 0) +
                      ((size_t)(i * geo.npass + p) * geo.nkc + kc) * geo.h_chunk,
                  (uint32_t)geo.h_chunk, &w_full[slot]);
      }
      mbar_wait(&w_full[slot], (uint32_t)((loads >> 1) & 1));
      ++loads;
      return smem_u32(dst);
    };
    uint32_t held = 0;
    float acc[68];
    for (int k = k_begin, n = 0; k < k_end; ++k, ++n) {
      const int b = k / a.nsub;
      const int u0 = (k - b * a.nsub) * kOwn - 1;  // a's row q = 0
      if (resident && (prev_b < 0 || (h.hbias_bstride && b != prev_b))) held = fetch(b, 0);
      prev_b = b;
      // the A registers of the h product's first two k-slices, for the
      // unit's one product when K <= 32: from the exc ring at E = 8
      uint32_t xa[2][4];
      if (xsmem) {
        const int st = rg.slot(n);
        const unsigned char* xs = xring + st * kXSlot;
        mbar_wait(&x_full[st], rg.parity(n));
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          const int kk = 16 * sl + 2 * l.tig;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = l.row + 8 * (v & 1);
            const int k2 = kk + 8 * (v >> 1);
            xa[sl][v] = x_at_rows(h, xs, u0, q, k2) | (x_at_rows(h, xs, u0, q, k2 + 1) << 16);
          }
        }
      } else {
#pragma unroll
        for (int sl = 0; sl < 2; ++sl) {
          if (hoisted && 16 * sl < geo.kc) {
            x_frag(h, xa[sl], b, u0, l, 16 * sl);
          } else {
            xa[sl][0] = xa[sl][1] = xa[sl][2] = xa[sl][3] = 0u;
          }
        }
      }
      zero(acc);
      for (int kc = 0; kc < geo.nkc; ++kc) {
        const int slices = geo.kc / 16;
        uint32_t fa[4][4];
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          if (hoisted && sl < 2) {
#pragma unroll
            for (int v = 0; v < 4; ++v) fa[sl][v] = xa[sl][v];
          } else if (!hoisted && sl < slices) {
            x_frag(h, fa[sl], b, u0, l, kc * geo.kc + 16 * sl);
          } else {
            fa[sl][0] = fa[sl][1] = fa[sl][2] = fa[sl][3] = 0u;
          }
          fence_regs(fa[sl]);
        }
        const uint32_t base = resident ? held : fetch(b, kc);
        wgmma_fence();
#pragma unroll
        for (int sl = 0; sl < 4; ++sl) {
          if (sl < slices) {
            wgmma_rs_n136(acc, fa[sl], make_desc(base + 256 * sl, 128, geo.kc * 16, kLayoutNone), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
      }
      const int slot = n & 1;
      unsigned char* as = aslots + slot * kASlot;
      mbar_wait(&a_empty[slot], (uint32_t)(((n >> 1) & 1) ^ 1));
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = l.row + 8 * half;
          const int u = u0 + q;
          const int c = c0 + nt * 8 + 2 * l.tig;
          const int v = nt * 4 + 2 * half;
          const bool row_ok = u >= 0 && u < h.T;
          const float x0 = row_ok && c < h.cc ? (acc[v] >= 0.f ? acc[v] + 0.f : kSlope * acc[v]) : 0.f;
          const float x1 =
              row_ok && c + 1 < h.cc ? (acc[v + 1] >= 0.f ? acc[v + 1] + 0.f : kSlope * acc[v + 1]) : 0.f;
          *reinterpret_cast<uint32_t*>(as + nt * kAChunk + q * 16 + 4 * l.tig) = pack_rn(x0, x1);
        }
      }
      fence_proxy_async();
      release(&a_full[slot]);
      if (l.wt == 0 && k + kW1Ahead < k_end) ask_g(k + kW1Ahead, n + kW1Ahead);
    }
    return;
  }

  // dW1_i[j][c][o] += sum_r g[t0 + r][o] a[u0 + r + j][c], r < 64 (g's rows
  // 62 and 63 zero); db1 += sum_r g[t0 + r]
  const uint32_t ones_u = smem_u32(ones);
  const int cw = kW1Cols * (wg - 1);        // the warpgroup's first column of the pass
  const int cend = min(h.cc - c0, kPass);   // the pass's columns
  const bool with_db1 = wg == 1 && p == 0;
  float acc[3][kW1Cols / 2];
  float accb[4];
#pragma unroll
  for (int j = 0; j < 3; ++j) zero(acc[j]);
  zero(accb);
  for (int k = k_begin, n = 0; k < k_end; ++k, ++n) {
    const int slot = n & 1;
    const int st = rg.slot(n);
    mbar_wait(&a_full[slot], (uint32_t)((n >> 1) & 1));
    mbar_wait(&g_full[st], rg.parity(n));
    const uint32_t abase = smem_u32(aslots + slot * kASlot) + cw / 8 * kAChunk;
    const uint32_t gbase = smem_u32(ring + st * kGBytes);
    wgmma_fence();
#pragma unroll
    for (int sl = 0; sl < kRows / 16; ++sl) {
      const uint64_t da = make_desc(gbase + 2048 * sl, 8192, 1024, kLayoutSwizzle128);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        wgmma_ss_n72<1, 1>(acc[j], da,
                           make_desc(abase + 16 * (16 * sl + j), 128, kAChunk, kLayoutNone), 1);
      }
      if (with_db1) wgmma_ss_n8<1, 0>(accb, da, make_desc(ones_u, 128, 256, kLayoutNone), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 3; ++j) fence_regs(acc[j]);
    fence_regs(accb);
    release(&g_empty[st]);
    release(&a_empty[slot]);
  }

  const size_t n2 = (size_t)h.n * a.two_c;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int r = 0; r < kW1Cols / 2; ++r) {
      const int o = o0 + l.row + 8 * ((r >> 1) & 1);
      const int cl = cw + 8 * (r >> 2) + 2 * l.tig + (r & 1);
      if (o < a.two_c && cl < cend) {
        a.pw1[(((size_t)s * 3 + j) * h.cc + c0 + cl) * n2 + (size_t)i * a.two_c + o] = acc[j][r];
      }
    }
  }
  if (with_db1 && l.tig == 0) {
#pragma unroll
    for (int r = 0; r < 4; r += 2) {
      const int o = o0 + l.row + 8 * (r >> 1);
      if (o < a.two_c) a.pb1[(size_t)s * n2 + (size_t)i * a.two_c + o] = accb[r];
    }
  }
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
constexpr int kMaxJobs = 6;
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
  bool ok;
  int noc, ntiles;                          // (a)
  W0Geo geo;
  long long ld;                             // the dh scratch's row stride
  int notiles, nsub, units, chunk, s1;      // (b)
  int kx, xcols, xks, parts, prows, s0;     // (c)
  size_t off_dh, off_dexc, off_pb1, off_pw1, off_pw0, off_imh, off_imx, total;
};

Plan make_plan(int B, int T, int E, int n, int cc, int two_c) {
  Plan p{};
  p.ok = false;
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 8 || (long long)B * (T + 1) > (1LL << 30)) {
    return p;
  }
  p.geo = w0_geo(E, n, cc);
  p.noc = (two_c + 63) / 64;
  p.ntiles = (T + kTile - 1) / kTile;
  const size_t R = (size_t)B * T, n0 = (size_t)n * cc, n2 = (size_t)n * two_c;
  p.ld = (long long)(n0 + 7) / 8 * 8;
  // (b): (block, pass, 64 columns of g) tiles times chunks of units, one wave
  p.notiles = (two_c + 63) / 64;
  p.nsub = (T + kOwn - 1) / kOwn;
  p.units = B * p.nsub;
  const long long tiles = (long long)n * p.geo.npass * p.notiles;
  const int s1 = (int)std::min<long long>(std::max<long long>(1, kSmCount / tiles), p.units);
  p.chunk = (p.units + s1 - 1) / s1;
  p.s1 = (p.units + p.chunk - 1) / p.chunk;
  // (c): (batch row, part) chunks times (256 columns of dh, 32 columns of
  // X) tiles, at least two CTAs an SM
  p.kx = 3 * E + 3;
  p.xcols = (int)((n0 + 2 * kXCols - 1) / (2 * kXCols));
  p.xks = (p.kx + kXK - 1) / kXK;
  const long long per_b = (long long)B * p.xcols * p.xks;
  const int parts = (int)std::min<long long>(std::max<long long>(1, (2 * kSmCount + per_b - 1) / per_b),
                                             65535 / B);
  p.prows = ((T + parts - 1) / parts + 63) / 64 * 64;
  p.parts = (T + p.prows - 1) / p.prows;
  p.s0 = B * p.parts;
  p.off_dh = 0;
  p.off_dexc = align256(p.off_dh + R * p.ld * 2);
  p.off_pb1 = align256(p.off_dexc + ((size_t)n * p.geo.npass > 1 ? R * E * 4 : 0));
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

// Device time of each of a call's five launches, for measurement (smoke
// phase 14): while on, a call records an event before its first launch and
// after each one, on its stream
bool g_timed = false;
cudaEvent_t g_marks[6];

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

// ms[0..4]: the last timed call's w_images_kernel, k2b_data_kernel,
// k2b_w1_kernel, k2b_xdh_kernel and k2b_reduce_kernel, each from the end of
// the launch before it (synchronize first)
extern "C" int cond_chain_bwd_bf16_kernel_ms(float* ms) {
  for (int k = 0; k < 5; ++k) {
    const cudaError_t err = cudaEventElapsedTime(&ms[k], g_marks[k], g_marks[k + 1]);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

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
  d.ld = p.ld;
  d.dexc_acc = reinterpret_cast<float*>(wsb + p.off_dexc);
  d.dexc = static_cast<bf16*>(dexc);
  d.two_c = two_c;
  d.noc = p.noc;
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
  w.chunk = p.chunk;
  w.vec = E == 8 && (uintptr_t)exc % 16 == 0;
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
  if (!make_map(&d.g_map, g, 4, g_dims, g_strides, g_box) ||
      !make_map(&d.w1_map, w1, 4, w_dims, w_strides, w_box) ||
      !make_map(&w.g_map, g, 4, g_dims, g_strides, g_box_w1) ||
      !make_map(&x.dh_map, dh_s, 4, x_dims, x_strides, x_box)) {
    return (int)cudaErrorInvalidValue;
  }
  ImageArgs im{h, nullptr, reinterpret_cast<bf16*>(wsb + p.off_imh),
               reinterpret_cast<bf16*>(wsb + p.off_imx), nullptr, hbias_bstride ? B : 1, two_c};
  auto mark = [&](int k) {
    if (g_timed) cudaEventRecord(g_marks[k], stream);
  };
  mark(0);
  cudaError_t e = launch_images(im, stream);
  if (e != cudaSuccess) return (int)e;
  mark(1);
  if ((e = launch_kernel(k2b_data_kernel, dim3((unsigned)p.ntiles, (unsigned)B), kThreads,
                         kDataSmem, d, stream)) != cudaSuccess) return (int)e;
  mark(2);
  if ((e = launch_kernel(k2b_w1_kernel,
                         dim3((unsigned)(n * p.geo.npass * p.notiles), (unsigned)p.s1),
                         kW1Threads, kW1Smem, w, stream)) != cudaSuccess) return (int)e;
  mark(3);
  if ((e = launch_kernel(k2b_xdh_kernel,
                         dim3((unsigned)p.xcols, (unsigned)p.s0, (unsigned)p.xks), kThreads,
                         kXSmem, x, stream)) != cudaSuccess) return (int)e;
  mark(4);

  // dW1, db1 over the chunks of units; dW0 over every (batch row, part);
  // dhbias, the edges over a batch row's parts (dhbias over all of them
  // when hbias is shared)
  ReduceArgs r{};
  const long long xs = (long long)p.kx * n0;
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
  mark(5);
  return (int)cudaGetLastError();
}
