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
// of the a and dh scratch it writes for the weight grads (2 x 2.8 GB at
// B = 128, T = 8960, n Cc = 1224).
//
// What the design does about it: the work is split into kernels that each
// own their outputs, and every sum runs in a fixed order (the same result
// every run, no atomics):
//
//  (a) k2b_data_kernel, one CTA per (batch row, 124-row time tile)
//      (cond_chain_bf16.cuh: two consumer warpgroups of 64 rows of h each,
//      a producer warp), every product on wgmma with f32 accumulators in
//      registers, every operand of them brought by the producer's TMA and
//      bulk copies through mbarrier rings; per block i and pass of 136
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
//       - dh to shared memory in bf16; from there the own rows of a and dh
//         go to the scratch (for (b)) in 16-byte pieces, a warp writing
//         whole row segments, and dh is summed per column over them
//         (dhbias, f32 partials per half tile);
//       - the tile's dexc, an M = 64, N = 8 (E in chunks of 8), K = 3 x 144
//         product on wgmma with both operands in shared memory (dh, and W0's
//         image from the weights ring), added to an f32 sum over the blocks
//         and passes (a scratch the CTA owns), rounded to bf16 after the
//         last.
//      The row shift of the dexc conv, route (b): dh lies in shared memory
//      without swizzle, each 8-column chunk holding all its rows 16 bytes
//      apart, so that tap j's window (dh one or two rows down) is the same
//      descriptor 16 or 32 bytes further on.
//  (b) k2b_wgrad_kernel, split-K weight grads as D = X^T Y(shifted): dW1_i^T
//      (X = g_i, Y = the a scratch) and dW0^T (X = the dh scratch, Y = exc);
//      a CTA owns one (group, output tile), all three taps and one chunk of
//      the B*T rows; it stages 32 rows of X and the 34 rows of Y around them
//      per stage, double-buffered (16-byte cp.async pieces at the decoder's
//      widths, element by element through registers elsewhere), and reads
//      both as transposed fragments with ldmatrix.trans for bf16 mma.sync
//      m16n8k16. Rows are indexed with a zero row between batch rows, so
//      that a tap never pairs two batch rows. It writes f32 partials.
//  (c) k2b_colsum_kernel sums g over chunks of rows (db1's partials);
//      k2b_reduce_kernel sums every kind of partial over its chunks in order
//      and rounds once; k2b_edge_kernel gives the edge grads.
//
// Every width goes in passes of 136 columns of h and chunks of 64 columns
// of g, so the data kernel's shared memory does not grow with Cc or E: one
// tile for every width. g and W1 need 2C a multiple of 8 (their tensor
// maps' strides are multiples of 16 bytes): the wrapper pads other widths
// with zero columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

#include "cond_chain_bf16.cuh"
#include "tf32x3.cuh"  // cp.async

namespace {

using namespace bf16chain;

constexpr int kWRows = 32;     // weight-grad kernel: rows per stage
constexpr int kTargetCtas = 4 * 132;  // split-K aims at four CTAs per SM

// The data kernel's shared memory: a ring of kStages stages of (64 rows of g
// for each consumer warpgroup, 136 rows of W1), each 128-byte swizzled rows
// of 64 columns; the weights ring (two slots); per warpgroup dh (19 chunks
// of 8 columns x 64 rows x 16 bytes: the pass's 144 columns and a zero
// chunk, which the last tap's window reads two rows into), a in the same
// layout (17 chunks) and a reduction buffer; the barriers.
constexpr int kStages = 3;
constexpr int kGBytes = kRows * 128;     // 8192
constexpr int kW1Bytes = kPass * 128;    // 17408
constexpr int kStageBytes = 2 * kGBytes + kW1Bytes;
constexpr int kDhChunk = kRows * 16;     // 1024: the LBO of the dh operand
constexpr int kDhBytes = (2 * kPassSlices + 1) * kDhChunk;
constexpr int kABytes = (kPass / 8) * kDhChunk;
constexpr int kRowGroups = 7;            // copy-out: 7 x 17 threads of 8 columns
constexpr int kRedBytes = kRowGroups * kPass * 4;
constexpr int kW0xTap = 2 * kPassSlices * 128;  // 2304: one tap of an img_x chunk
constexpr size_t kDataSmem = (size_t)kStages * kStageBytes + 2 * kWSlot +
                             2 * (size_t)(kDhBytes + kABytes + kRedBytes) +
                             16 * (kStages + 2) + 1024;
static_assert(kDataSmem <= kSmemMax, "K2-bf16's data kernel's shared memory");

struct DataArgs {
  HArgs h;
  const bf16* img_h;   // cond_0's weights as h's B (cond_chain_bf16.cuh), per batch row
  const bf16* img_x;   // ... and as dexc's B
  bf16* a_out;         // (B, T, n*Cc) scratch: bf16(lrelu(h))
  bf16* dh_out;        // (B, T, n*Cc) scratch: dh
  float* dexc_acc;     // (B, T, E) scratch: dexc summed over the blocks and passes so far
  bf16* dexc;          // (B, T, E)
  float* phb;          // (B, 2 ntiles, n*Cc) partial sums of dh per half tile
  int two_c, noc, ntiles;
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
  float* red_all = reinterpret_cast<float*>(as_all + 2 * kABytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(red_all + 2 * kRedBytes / 4);
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
  float* red = red_all + wg * (kRedBytes / 4);
  const uint32_t dhs_u = smem_u32(dhs);
  const int n0 = h.n * h.cc;
  const bool vec16 = h.cc % 8 == 0;  // scratch rows and block offsets 16-byte aligned
  const int half_tile = 2 * tix + wg;
  const XFrags xf(h, geo, b, u0);
  WRing wr{wslots, wfull, wempty, 0};

  float dd[68];  // h, then da, then dh
  int k = 0;
  for (int i = 0; i < h.n; ++i) {
    for (int p = 0; p < geo.npass; ++p) {
      const int c0 = p * kPass;
      // a = bf16(lrelu(h)) to shared memory (chunk c / 8, row q), where the
      // slope step reads its sign (h's) back and the copy-out its values
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

      // a and dh of the own rows (q = 1 .. 62) to the scratch, 8 columns a
      // thread and row; dh of its rows summed per column in the same pass
      // (thread (rg, ch): rows 1 + rg, 8 + rg, ...), then over the 7 row
      // groups in order (dhbias)
      if (l.wt < kRowGroups * (kPass / 8)) {
        const int rgp = l.wt / (kPass / 8);
        const int ch = l.wt % (kPass / 8);
        const int c = c0 + ch * 8;
        float cs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int q = 1 + rgp; q <= kOwn && u0 + q < h.T; q += kRowGroups) {
          const uint4 dv = *reinterpret_cast<const uint4*>(dhs + ch * kDhChunk + q * 16);
          const uint4 av = *reinterpret_cast<const uint4*>(as + ch * kDhChunk + q * 16);
          const uint32_t dw[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            cs[e] += __uint_as_float((e & 1 ? dw[e / 2] >> 16 : dw[e / 2] & 0xFFFFu) << 16);
          }
          if (c < h.cc) {
            const size_t off = ((size_t)b * h.T + u0 + q) * n0 + (size_t)i * h.cc + c;
            if (vec16) {
              *reinterpret_cast<uint4*>(a.a_out + off) = av;
              *reinterpret_cast<uint4*>(a.dh_out + off) = dv;
            } else {  // Cc a multiple of 4: 8-byte pieces
              *reinterpret_cast<uint2*>(a.a_out + off) = make_uint2(av.x, av.y);
              *reinterpret_cast<uint2*>(a.dh_out + off) = make_uint2(dv.x, dv.y);
              if (c + 4 < h.cc) {
                *reinterpret_cast<uint2*>(a.a_out + off + 4) = make_uint2(av.z, av.w);
                *reinterpret_cast<uint2*>(a.dh_out + off + 4) = make_uint2(dv.z, dv.w);
              }
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) red[rgp * kPass + ch * 8 + e] = cs[e];
      }
      bar_sync(bar, 128);
      for (int cl = l.wt; cl < kPass; cl += 128) {
        if (c0 + cl >= h.cc) continue;
        float s = 0.f;
        for (int r = 0; r < kRowGroups; ++r) s += red[r * kPass + cl];
        a.phb[((size_t)b * 2 * a.ntiles + half_tile) * n0 + (size_t)i * h.cc + c0 + cl] = s;
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

// part[s][2m .. 2m+1] = sum of g's rows [s rows, (s + 1) rows) in columns
// 2m, 2m + 1, in order (db1's partials)
__global__ void k2b_colsum_kernel(const bf16* g, float* part, long long nrows, int rows,
                                  int cols) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (2 * m >= cols) return;
  float2 acc = make_float2(0.f, 0.f);
  const long long end = min(nrows, (long long)(s + 1) * rows);
  for (long long r = (long long)s * rows; r < end; ++r) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(g + r * cols + 2 * m);
    acc.x += __low2float(v);
    acc.y += __high2float(v);
  }
  *reinterpret_cast<float2*>(part + (size_t)s * cols + 2 * m) = acc;
}

// d += a * b on one m16n8k16 bf16 tile (mma.sync; the weight-grad kernel's
// product). A (16 x 16, row-major): a0 = A[grp][2tig, 2tig+1], a1 = A[grp+8][..],
// a2 = A[grp][2tig+8, +9], a3 = A[grp+8][2tig+8, +9]; B (16 x 8, k-major):
// b0 = B[2tig, 2tig+1][grp], b1 = B[2tig+8, +9][grp]; D as wgmma's n8 chunk.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct WgradArgs {
  const bf16* X;  // unshifted operand: element (row, grp*xgoff + m), row = b*T + t
  long long ldx;
  int xgoff, M;
  const bf16* Y;  // shifted operand: element (row, grp*ygoff + n)
  long long ldy;
  int ygoff, N;
  float* part;    // (S, 3, N, G*M)
  int T, G, prows, chunk;
};

// The weight-grad CTA's shape for NTW n-tiles (of 8 columns) per warp: 8 x 1
// warps of 16 x 8 for N <= 8 (dW0 of the split form), else 2 x 6 warps of
// 16 x 24. Shared-memory rows are 8 mod 64 bf16 apart, so that ldmatrix's 8
// row addresses fall in 8 different 16-byte bank groups.
template <int NTW>
struct WgradGeom {
  static constexpr int kWM = NTW == 1 ? 8 : 2;
  static constexpr int kWN = NTW == 1 ? 1 : 6;
  static constexpr int kBM = 16 * kWM;
  static constexpr int kBN = 8 * NTW * kWN;
  static constexpr int kThreads = 32 * kWM * kWN;
  static constexpr int kLdx = (kBM + 63) / 64 * 64 + 8;
  static constexpr int kLdy = (kBN + 63) / 64 * 64 + 8;
  static constexpr int kNX = kWRows * kBM;        // staged elements per stage
  static constexpr int kNY = (kWRows + 2) * kBN;
  static constexpr int kPer = (kNX + kNY + kThreads - 1) / kThreads;  // per thread
  static constexpr int kXs = kWRows * kLdx;       // shared elements per stage
  static constexpr int kYs = (kWRows + 2) * kLdy;
  static constexpr size_t kSmem = (size_t)2 * (kXs + kYs) * sizeof(bf16);
};

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

// part[s][j][n][grp*M + m] = sum over rows (b, t) of chunk s of
// X[b, t][grp*xgoff + m] * Y[b, t+j-1][grp*ygoff + n], Y zero outside [0, T).
// Rows are indexed p = b*(T+1) + t + 1, so p = b*(T+1) is a zero row between
// batch rows and tap j pairs X row p with Y row p + j - 1. A CTA owns a
// kBM x kBN output tile, all three taps, and the padded rows
// [s*chunk, (s+1)*chunk).
// kVec: every row stride, group offset, M and N a multiple of 8 and X and Y
// 16-byte aligned, so that a stage lands as 16-byte cp.async pieces of 8
// columns (each all inside or all outside the tile); else element by element
// through registers.
template <int NTW, bool kVec>
__global__ void __launch_bounds__(WgradGeom<NTW>::kThreads) k2b_wgrad_kernel(WgradArgs w) {
  using G = WgradGeom<NTW>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);  // [2][kWRows][kLdx]
  bf16* ys = xs + 2 * G::kXs;                    // [2][kWRows + 2][kLdy]
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
  const bf16* X = w.X + (size_t)grp_i * w.xgoff;
  const bf16* Y = w.Y + (size_t)grp_i * w.ygoff;

  // staged row r of X is padded row pb + r, of Y pb - 1 + r
  constexpr int kXP = G::kBM / 8;  // 16-byte pieces per staged row
  constexpr int kYP = G::kBN / 8;
  auto load16 = [&](int sub) {
    const int pb = p_begin + sub * kWRows;
    bf16* xd = xs + (sub & 1) * G::kXs;
    bf16* yd = ys + (sub & 1) * G::kYs;
    for (int idx = tid; idx < kWRows * kXP + (kWRows + 2) * kYP; idx += G::kThreads) {
      const bool is_x = idx < kWRows * kXP;
      const int k = is_x ? idx : idx - kWRows * kXP;
      const int per = is_x ? kXP : kYP;
      const int r = k / per;
      const int c = (k - r * per) * 8;
      const int p = pb + r - (is_x ? 0 : 1);
      const int bq = p >= 0 ? p / tp : 0;
      const int q = p - bq * tp;
      const bool ok = p >= 0 && q != 0 &&
                      (is_x ? p < p_end && m0 + c < w.M : p < w.prows && n0 + c < w.N);
      const size_t row = ok ? (size_t)bq * w.T + q - 1 : 0;
      const bf16* src = is_x ? X + row * w.ldx + m0 + c : Y + row * w.ldy + n0 + c;
      tf32x3::cp_async16(is_x ? xd + r * G::kLdx + c : yd + r * G::kLdy + c,
                         ok ? src : w.X, ok);
    }
  };
  // element by element, through registers
  unsigned short regs[G::kPer];
  auto gather = [&](int sub) {
    const int pb = p_begin + sub * kWRows;
#pragma unroll
    for (int u = 0; u < G::kPer; ++u) {
      const int idx = tid + u * G::kThreads;
      const bool is_x = idx < G::kNX;
      const int k = is_x ? idx : idx - G::kNX;
      const int cols = is_x ? G::kBM : G::kBN;
      const int r = k / cols;
      const int c = k - r * cols;
      const int p = pb + r - (is_x ? 0 : 1);
      const int bq = p >= 0 ? p / tp : 0;
      const int q = p - bq * tp;
      const bool ok = idx < G::kNX + G::kNY && p >= 0 && q != 0 &&
                      (is_x ? p < p_end && m0 + c < w.M : p < w.prows && n0 + c < w.N);
      const size_t row = (size_t)bq * w.T + q - 1;
      regs[u] = ok ? __ldg(reinterpret_cast<const unsigned short*>(
                         is_x ? X + row * w.ldx + m0 + c : Y + row * w.ldy + n0 + c))
                   : (unsigned short)0;
    }
  };
  auto scatter = [&](int sub) {
    bf16* xd = xs + (sub & 1) * G::kXs;
    bf16* yd = ys + (sub & 1) * G::kYs;
#pragma unroll
    for (int u = 0; u < G::kPer; ++u) {
      const int idx = tid + u * G::kThreads;
      if (idx >= G::kNX + G::kNY) break;
      const bool is_x = idx < G::kNX;
      const int k = is_x ? idx : idx - G::kNX;
      const int cols = is_x ? G::kBM : G::kBN;
      const int r = k / cols;
      const int c = k - r * cols;
      (is_x ? xd + r * G::kLdx + c : yd + r * G::kLdy + c)[0] = __ushort_as_bfloat16(regs[u]);
    }
  };

  float acc[3][NTW][4];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][nt][v] = 0.f;

  // ldmatrix row addresses: lane l gives row l & 7 of matrix l >> 3
  const int lr = lane & 7;
  const int lq = lane >> 3;
  auto compute = [&](int sub) {
    const bf16* xd = xs + (sub & 1) * G::kXs;
    const bf16* yd = ys + (sub & 1) * G::kYs;
#pragma unroll
    for (int kk = 0; kk < kWRows; kk += 16) {
      // A[m][k] = X[row kk + k][m]: matrices (k 0-7, m 0-7), (k 0-7, m 8-15),
      // (k 8-15, m 0-7), (k 8-15, m 8-15) give a0..a3
      uint32_t fa[4];
      ldsm_x4_t(fa, xd + (kk + (lq >> 1) * 8 + lr) * G::kLdx + wm * 16 + (lq & 1) * 8);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          // B_j[k][n] = Y[row kk + k + j - 1][n] = yd row kk + k + j
          uint32_t fb[2];
          ldsm_x2_t(fb, yd + (kk + j + (lq & 1) * 8 + lr) * G::kLdy + (wn * NTW + nt) * 8);
          mma(acc[j][nt], fa, fb);
        }
      }
    }
  };
  if constexpr (kVec) {
    if (nsub > 0) load16(0);
    tf32x3::cp_async_commit();
    for (int sub = 0; sub < nsub; ++sub) {
      if (sub + 1 < nsub) load16(sub + 1);
      tf32x3::cp_async_commit();
      tf32x3::cp_async_wait<1>();
      __syncthreads();  // stage sub landed
      compute(sub);
      __syncthreads();  // stage sub read before it is loaded again
    }
  } else {
    if (nsub > 0) gather(0);
    for (int sub = 0; sub < nsub; ++sub) {
      scatter(sub);
      __syncthreads();  // stage sub in place; every thread is done with stage sub - 2
      if (sub + 1 < nsub) gather(sub + 1);
      compute(sub);
    }
  }

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

// out[o*len + k] = bf16(sum_{s < S} part[o*ostride + s*sstride + k]), s in order
__global__ void k2b_reduce_kernel(const float* part, bf16* out, long long len, int S,
                                  long long sstride, long long ostride) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long o = blockIdx.y;
  if (k >= len) return;
  const float* p = part + o * ostride + k;
  float acc = 0.f;
  for (int s = 0; s < S; ++s) acc += p[(long long)s * sstride];
  out[o * len + k] = __float2bfloat16_rn(acc);
}

// out[o*len + k] = -dh[o*ostride + k]
__global__ void k2b_edge_kernel(const bf16* dh, bf16* out, long long len, long long ostride) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long o = blockIdx.y;
  if (k < len) out[o * len + k] = __hneg(dh[o * ostride + k]);
}

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

// The split-K plan of one weight grad D = X^T Y (M x N per group, G groups)
// over R = B*T rows.
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

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// Everything the launch needs, from the shapes alone; ok = false for shapes
// the kernels do not take. Offsets are in bytes of the workspace.
struct Plan {
  bool ok;
  int noc, ntiles, gchunks, grows;  // grows: rows of g per db1 partial
  W0Geo geo;
  Wgrad w1, w0;
  size_t off_a, off_dh, off_dexc, off_phb, off_pb1, off_pw1, off_pw0, off_imh, off_imx, total;
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
  const size_t R = (size_t)B * T;
  p.grows = (int)((R + 2 * 132 - 1) / (2 * 132));
  p.gchunks = (int)((R + p.grows - 1) / p.grows);
  const size_t n0 = (size_t)n * cc, n2 = (size_t)n * two_c;
  p.w1 = wgrad_plan(two_c, cc, n, B, T);
  p.w0 = wgrad_plan((int)n0, E, 1, B, T);
  if (p.w1.smem > kSmemMax || p.w0.smem > kSmemMax) return p;
  const size_t halves = (size_t)B * 2 * p.ntiles;
  p.off_a = 0;
  p.off_dh = align256(p.off_a + R * n0 * 2);
  p.off_dexc = align256(p.off_dh + R * n0 * 2);
  p.off_phb = align256(p.off_dexc + ((size_t)n * p.geo.npass > 1 ? R * E * 4 : 0));
  p.off_pb1 = align256(p.off_phb + halves * n0 * 4);
  p.off_pw1 = align256(p.off_pb1 + (size_t)p.gchunks * n2 * 4);
  p.off_pw0 = align256(p.off_pw1 + (size_t)p.w1.S * 3 * cc * n2 * 4);
  p.off_imh = align256(p.off_pw0 + (size_t)p.w0.S * 3 * E * n0 * 4);
  p.off_imx = align256(p.off_imh + (size_t)B * p.geo.h_image);
  p.total = align256(p.off_imx + p.geo.x_bytes);
  p.ok = true;
  return p;
}

cudaError_t launch_data(const DataArgs& d, const Plan& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k2b_data_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kDataSmem);
  if (e != cudaSuccess) return e;
  k2b_data_kernel<<<dim3((unsigned)p.ntiles, (unsigned)B), kThreads, kDataSmem, stream>>>(d);
  return cudaGetLastError();
}

template <int NTW, bool kVec>
cudaError_t launch_wgrad_t(const Wgrad& p, const WgradArgs& w, int G, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k2b_wgrad_kernel<NTW, kVec>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)(p.mblocks * p.nblocks), (unsigned)G, (unsigned)p.S);
  k2b_wgrad_kernel<NTW, kVec><<<grid, WgradGeom<NTW>::kThreads, p.smem, stream>>>(w);
  return cudaGetLastError();
}

// D[grp][j] = X_grp^T Y_grp(shifted by j - 1) into part (S, 3, N, G*M)
cudaError_t launch_wgrad(const Wgrad& p, const bf16* X, long long ldx, int xgoff, int M,
                         const bf16* Y, long long ldy, int ygoff, int N, int G, int B, int T,
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
  const bool vec = ldx % 8 == 0 && ldy % 8 == 0 && xgoff % 8 == 0 && ygoff % 8 == 0 &&
                   M % 8 == 0 && N % 8 == 0 && (uintptr_t)X % 16 == 0 && (uintptr_t)Y % 16 == 0;
  if (vec) {
    return p.ntw == 1 ? launch_wgrad_t<1, true>(p, w, G, stream)
                      : launch_wgrad_t<3, true>(p, w, G, stream);
  }
  return p.ntw == 1 ? launch_wgrad_t<1, false>(p, w, G, stream)
                    : launch_wgrad_t<3, false>(p, w, G, stream);
}

cudaError_t launch_reduce(const float* part, bf16* out, long long len, int outer, int S,
                          long long sstride, long long ostride, cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((unsigned)((len + threads - 1) / threads), (unsigned)outer);
  k2b_reduce_kernel<<<grid, threads, 0, stream>>>(part, out, len, S, sstride, ostride);
  return cudaGetLastError();
}

cudaError_t launch_edge(const bf16* dh, bf16* out, long long len, int outer, long long ostride,
                        cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((unsigned)((len + threads - 1) / threads), (unsigned)outer);
  k2b_edge_kernel<<<grid, threads, 0, stream>>>(dh, out, len, ostride);
  return cudaGetLastError();
}

}  // namespace

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
  const int n0 = n * cc;
  const int n2 = n * two_c;
  unsigned char* wsb = static_cast<unsigned char*>(ws);
  bf16* a_s = reinterpret_cast<bf16*>(wsb + p.off_a);
  bf16* dh_s = reinterpret_cast<bf16*>(wsb + p.off_dh);
  float* phb = reinterpret_cast<float*>(wsb + p.off_phb);
  float* pb1 = reinterpret_cast<float*>(wsb + p.off_pb1);
  float* pw1 = reinterpret_cast<float*>(wsb + p.off_pw1);
  float* pw0 = reinterpret_cast<float*>(wsb + p.off_pw0);

  DataArgs d;
  d.h.exc = static_cast<const bf16*>(exc);
  d.h.w0 = static_cast<const bf16*>(w0);
  d.h.hbias = static_cast<const bf16*>(hbias);
  d.h.hbias_bstride = hbias_bstride;
  d.h.edge0 = static_cast<const bf16*>(edge0);
  d.h.edge_t = static_cast<const bf16*>(edge_t);
  d.h.T = T;
  d.h.E = E;
  d.h.n = n;
  d.h.cc = cc;
  d.img_h = reinterpret_cast<const bf16*>(wsb + p.off_imh);
  d.img_x = reinterpret_cast<const bf16*>(wsb + p.off_imx);
  d.a_out = a_s;
  d.dh_out = dh_s;
  d.dexc_acc = reinterpret_cast<float*>(wsb + p.off_dexc);
  d.dexc = static_cast<bf16*>(dexc);
  d.phb = phb;
  d.two_c = two_c;
  d.noc = p.noc;
  d.ntiles = p.ntiles;
  d.geo = p.geo;
  const bf16* gp = static_cast<const bf16*>(g);
  const cuuint64_t o = (cuuint64_t)two_c, nn = (cuuint64_t)n;
  const cuuint64_t g_dims[4] = {o, nn, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t g_strides[3] = {o * 2, o * 2 * nn, o * 2 * nn * T};
  const cuuint32_t g_box[4] = {64, 1, (cuuint32_t)kRows, 1};
  const cuuint64_t w_dims[4] = {o, nn, (cuuint64_t)cc, 3};
  const cuuint64_t w_strides[3] = {o * 2, o * 2 * nn, o * 2 * nn * cc};
  const cuuint32_t w_box[4] = {64, 1, (cuuint32_t)kPass, 1};
  if (!make_map(&d.g_map, g, 4, g_dims, g_strides, g_box) ||
      !make_map(&d.w1_map, w1, 4, w_dims, w_strides, w_box)) {
    return (int)cudaErrorInvalidValue;
  }
  ImageArgs im{d.h, nullptr, reinterpret_cast<bf16*>(wsb + p.off_imh),
               reinterpret_cast<bf16*>(wsb + p.off_imx), nullptr, hbias_bstride ? B : 1, two_c};
  cudaError_t e = launch_images(im, stream);
  if (e != cudaSuccess) return (int)e;
  if ((e = launch_data(d, p, B, stream)) != cudaSuccess) return (int)e;
  k2b_colsum_kernel<<<dim3((unsigned)((n2 / 2 + 127) / 128), (unsigned)p.gchunks), 128, 0,
                      stream>>>(gp, pb1, (long long)B * T, p.grows, n2);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // dW1^T from g and a (shifted); dW0^T from dh and exc (shifted)
  if ((e = launch_wgrad(p.w1, gp, n2, two_c, two_c, a_s, n0, cc, cc, n, B, T, pw1,
                        stream)) != cudaSuccess) return (int)e;
  if ((e = launch_wgrad(p.w0, dh_s, n0, 0, n0, d.h.exc, E, 0, E, 1, B, T, pw0,
                        stream)) != cudaSuccess) return (int)e;

  const long long len1 = 3LL * cc * n2;
  const long long len0 = 3LL * E * n0;
  const int halves = 2 * p.ntiles;
  if ((e = launch_reduce(pw1, static_cast<bf16*>(dw1), len1, 1, p.w1.S, len1, 0, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(pw0, static_cast<bf16*>(dw0), len0, 1, p.w0.S, len0, 0, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(pb1, static_cast<bf16*>(db1), n2, 1, p.gchunks, n2, 0, stream)) !=
      cudaSuccess) return (int)e;
  if (hbias_bstride) {
    e = launch_reduce(phb, static_cast<bf16*>(dhbias), n0, B, halves, n0,
                      (long long)halves * n0, stream);
  } else {
    e = launch_reduce(phb, static_cast<bf16*>(dhbias), n0, 1, B * halves, n0, 0, stream);
  }
  if (e != cudaSuccess) return (int)e;
  if (edge0) {
    if ((e = launch_edge(dh_s, static_cast<bf16*>(dedge0), n0, B, (long long)T * n0,
                         stream)) != cudaSuccess) return (int)e;
    if ((e = launch_edge(dh_s + (size_t)(T - 1) * n0, static_cast<bf16*>(dedge_t), n0, B,
                         (long long)T * n0, stream)) != cudaSuccess) return (int)e;
  }
  return 0;
}
