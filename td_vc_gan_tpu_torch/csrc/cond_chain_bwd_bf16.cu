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
// What bounds it on an H100: as K2 (cond_chain_bwd.cu), hundreds of flops
// per byte at the decoder's shapes, above the ridge of the card's dense bf16
// tensor-core rate (295 flops per byte): bound by operations.
//
// What the design does about it: every product is one bf16 mma.sync
// m16n8k16 (cond_chain_bf16.cuh) with f32 accumulators. As in K2, the work
// is split into kernels that each own their outputs, and every sum runs in a
// fixed order (the same result every run, no atomics):
//
//  (a) k2b_data_kernel, one CTA of 8 warps per (batch row, 126-row time tile;
//      62 or 30 rows where a wide Cc or E passes a block's shared memory):
//      stages the tile's excitation rows once; per block i it
//       - recomputes a32 = lrelu(h_i) for the tile plus a halo row each side
//         (128 rows), in f32, into shared memory (the slope is taken from
//         the f32 value, as the Pallas kernel takes it);
//       - forms da_i (M = 128, N = Cc, K = 3*2C) in passes of 144 channels:
//         A = g_i's rows and B = W1_i, both read as pairs of bf16 through L1
//         (g_i's neighbouring output channels, W1_i's as W1 is laid out);
//       - turns da into dh in place (rounded to bf16, kept as f32 values),
//         and writes a = bf16(a32) and dh of its own rows to scratch (bf16:
//         the scratch is 2 x 2.8 GB at B = 128, T = 8960, n*Cc = 1224);
//       - adds the tile's dexc (M = 128, N = E, K = 3*Cc: A = dh, B = W0_i as
//         pairs) into an f32 sum over the blocks, rounded to bf16 after the
//         last block;
//       - sums dh over its own rows per channel (dhbias) and g_i over its own
//         rows per channel (db1), in f32.
//  (b) k2b_wgrad_kernel, split-K weight grads as D = X^T Y(shifted): dW1_i^T
//      (X = g_i, Y = the a scratch) and dW0^T (X = the dh scratch, Y = exc);
//      a CTA owns one (group, output tile), all three taps and one chunk of
//      the B*T rows; it stages 32 rows of X and the 34 rows of Y around them
//      per stage, double-buffered (16-byte cp.async pieces at the decoder's
//      widths, element by element through registers elsewhere), and reads
//      both as transposed fragments with ldmatrix.trans. Rows are indexed with a
//      zero row between batch rows, so that a tap never pairs two batch
//      rows. It writes f32 partials.
//  (c) k2b_reduce_kernel sums the partials over the chunks in order and
//      rounds once; k2b_edge_kernel gives the edge grads.
//
// A simple first version: nothing of da's operands is staged in shared
// memory and there is no wgmma or TMA (later work, PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

#include "cond_chain_bf16.cuh"
#include "tf32x3.cuh"  // cp.async

namespace {

using namespace bf16mma;

constexpr int kThreads = 256;  // data kernel: 8 warps
constexpr int kWRows = 32;     // weight-grad kernel: rows per stage
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kTargetCtas = 4 * 132;  // split-K aims at four CTAs per SM

// The data kernel's shape for R rows of h / dh per CTA (its time tile and a
// halo row each side): at R = 128 and 64 the warps are 4 (rows) x 2
// (channels), each owning 72 channels of a pass; at R = 32, 2 x 4, each
// owning 32.
template <int R>
struct DataGeom {
  static constexpr int kTile = R - 2;           // the CTA's own rows
  static constexpr int kWNShift = R >= 64 ? 1 : 2;
  static constexpr int kWN = 1 << kWNShift;     // warps along da's channels
  static constexpr int kWM = 8 / kWN;           // warps along its rows
  static constexpr int kMT = R / (16 * kWM);    // m-tiles (16 rows) per warp
  static constexpr int kDaNT = R >= 64 ? 9 : 4;  // 8-channel n-tiles of da per warp and pass
  static constexpr int kDaCols = kWN * kDaNT * 8;
  static_assert(kMT >= 1 && kMT * 16 * kWM == R, "warps must cover the rows");
};
constexpr int kDataRows[] = {128, 64, 32};

struct DataArgs {
  HArgs h;
  const bf16* w1;    // (3, Cc, n*2C)
  const bf16* g;     // (B, T, n*2C)
  bf16* a_out;       // (B, T, n*Cc) scratch: bf16(lrelu(h))
  bf16* dh_out;      // (B, T, n*Cc) scratch: dh
  float* dexc_acc;   // (B, T, E) scratch: dexc summed over the blocks so far
  bf16* dexc;        // (B, T, E)
  float* phb;        // (B, ntiles, n*Cc) partial sums of dh
  float* pb1;        // (B, ntiles, n*2C) partial sums of g
  int two_c, ntiles;
  int lda, ldx;      // shared-memory row strides: f32 buffer (floats), exc (bf16)
};

// sum over r < kTile of p[(r0 + r) * ld], by one warp, in a fixed order; the
// result in every lane
template <int kTile>
__device__ __forceinline__ float own_rows_sum(const float* p, int ld, int r0) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int r = lane; r < kTile; r += 32) s += p[(r0 + r) * ld];
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// two CTAs an SM: at most 128 registers a thread
template <int R>
__global__ void __launch_bounds__(kThreads, 2) k2b_data_kernel(DataArgs a) {
  using Geo = DataGeom<R>;
  constexpr int kTile = Geo::kTile;
  constexpr int kMT = Geo::kMT;
  constexpr int kDaNT = Geo::kDaNT;
  constexpr int kDaCols = Geo::kDaCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const HArgs& h = a.h;
  float* buf = reinterpret_cast<float*>(smem_raw);                 // [R + 2][lda]: a32, then dh
  bf16* xs = reinterpret_cast<bf16*>(buf + (R + 2) * a.lda);       // [R + 2][ldx]: exc rows t0-2 ..
  float2* red = reinterpret_cast<float2*>(
      smem_raw + (((size_t)(R + 2) * a.lda * 4 + (size_t)(R + 2) * a.ldx * 2 + 15) / 16 * 16));

  const int b = blockIdx.y;
  const int tix = blockIdx.x;
  const int t0 = tix * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> Geo::kWNShift;
  const int wn = warp & (Geo::kWN - 1);
  const int n0 = h.n * h.cc;
  const int n2 = h.n * a.two_c;
  const int npass = (h.cc + kDaCols - 1) / kDaCols;
  const int ks_o = (a.two_c + 15) / 16;
  const int ks_c = h.cc_pad / 16;
  const int etiles = (h.E + 7) / 8;

  stage_exc(h, xs, a.ldx, R + 2, b, t0);
  // rows R, R+1 of buf stay zero: the dexc product's last m-tile reads them
  for (int idx = tid; idx < 2 * a.lda; idx += kThreads) buf[R * a.lda + idx] = 0.f;

  for (int i = 0; i < h.n; ++i) {
    const bf16* g_i = a.g + (size_t)b * h.T * n2 + i * a.two_c;
    __syncthreads();  // xs staged; the previous block's buf fully read
    recompute_act<R / 16, true>(h, xs, a.ldx, buf, a.lda, R, b, t0, i);
    __syncthreads();

    // da[q][c] = sum_j sum_o g[t0 + q - j][o] W1_i[j][c][o] for h row t0 - 1 + q
    for (int ps = 0; ps < npass; ++ps) {
      const int cp0 = ps * kDaCols;
      float acc[kMT][kDaNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kDaNT; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;
      for (int j = 0; j < 3; ++j) {
        for (int ks = 0; ks < ks_o; ++ks) {
          const int o = ks * 16 + 2 * tig;  // this lane's k (output channel) pairs
          FragA fa[kMT];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              const int t = t0 + wm * 16 * kMT + mt * 16 + grp + 8 * (v & 1) - j;
              const int oo = o + 8 * (v >> 1);
              fa[mt].r[v] = (t >= 0 && t < h.T && oo < a.two_c)
                                ? ldg2(g_i + (size_t)t * n2 + oo) : 0u;
            }
          }
#pragma unroll
          for (int nt = 0; nt < kDaNT; ++nt) {
            const int c = cp0 + wn * kDaNT * 8 + nt * 8 + grp;  // this lane's B column
            const bool cok = c < h.cc;
            const bf16* wp = a.w1 + ((size_t)j * h.cc + c) * n2 + i * a.two_c;
            uint32_t bb[2];
            bb[0] = cok && o < a.two_c ? ldg2(wp + o) : 0u;
            bb[1] = cok && o + 8 < a.two_c ? ldg2(wp + o + 8) : 0u;
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma(acc[mt][nt], fa[mt].r, bb);
          }
        }
      }

      // dh = bf16(lrelu'(h) da) in place (each element read and written by its
      // owner only); a and dh of the tile's own rows to scratch
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < kDaNT; ++nt) {
          const int c = cp0 + wn * kDaNT * 8 + nt * 8 + 2 * tig;
          if (c >= h.cc) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int q = wm * 16 * kMT + mt * 16 + grp + 8 * half;
            const int u = t0 - 1 + q;
            const bool valid = u >= 0 && u < h.T;
            float* slot = buf + q * a.lda + c;
            const float a0 = slot[0];
            const float a1 = slot[1];
            const float da0 = acc[mt][nt][2 * half];
            const float da1 = acc[mt][nt][2 * half + 1];
            const float d0 = valid ? round_bf16(a0 >= 0.f ? da0 : kSlope * da0) : 0.f;
            const float d1 = valid ? round_bf16(a1 >= 0.f ? da1 : kSlope * da1) : 0.f;
            slot[0] = d0;
            slot[1] = d1;
            if (valid && q >= 1 && q <= kTile) {
              const size_t off = ((size_t)b * h.T + u) * n0 + i * h.cc + c;
              store2(a.a_out + off, a0, a1);
              store2(a.dh_out + off, d0, d1);
            }
          }
        }
      }
    }
    __syncthreads();

    // dexc[t0 + r] += sum_j sum_c dh[t0 + r - j + 1][c] W0[j][e][i*Cc + c]: buf row r + 2 - j
    for (int item = warp; item < (R / 16) * etiles; item += kThreads / 32) {
      const int mt = item / etiles;
      const int et = item - mt * etiles;
      const int e = et * 8 + grp;  // this lane's B column
      const bool eok = e < h.E;
      float dj[3][4];
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) dj[j][v] = 0.f;
      for (int ks = 0; ks < ks_c; ++ks) {
        const int c = ks * 16 + 2 * tig;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const FragA fa = load_a_f32(buf + (mt * 16 + grp + 2 - j) * a.lda + c, a.lda);
          const bf16* wp = h.w0 + ((size_t)j * h.E + e) * n0 + (size_t)i * h.cc;
          uint32_t bb[2];
          bb[0] = eok && c < h.cc ? ldg2(wp + c) : 0u;
          bb[1] = eok && c + 8 < h.cc ? ldg2(wp + c + 8) : 0u;
          mma(dj[j], fa.r, bb);
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = mt * 16 + grp + 8 * half;
        const int t = t0 + r;
        if (r >= kTile || t >= h.T) continue;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int ec = et * 8 + 2 * tig + u;
          if (ec >= h.E) continue;
          const int v = 2 * half + u;
          const size_t idx = ((size_t)b * h.T + t) * h.E + ec;
          float d = (dj[0][v] + dj[1][v]) + dj[2][v];
          if (i > 0) d += a.dexc_acc[idx];
          if (i == h.n - 1) {
            a.dexc[idx] = __float2bfloat16_rn(d);
          } else {
            a.dexc_acc[idx] = d;
          }
        }
      }
    }
    // dh of the tile's own rows (buf rows 1 .. kTile) summed per channel, for dhbias
    for (int c = warp; c < h.cc; c += kThreads / 32) {
      const float s = own_rows_sum<kTile>(buf + c, a.lda, 1);
      if (lane == 0) a.phb[((size_t)b * a.ntiles + tix) * n0 + i * h.cc + c] = s;
    }
    // g_i of the tile's own rows summed per channel, for db1: each thread sums
    // a channel pair over every s-th row, then the s partials in order
    const int P = a.two_c / 2;
    for (int p0 = 0; p0 < P; p0 += kThreads) {
      const int np = min(P - p0, kThreads);
      const int S = kThreads / np;
      const int p = p0 + tid % np;
      const int part = tid / np;
      float2 s = make_float2(0.f, 0.f);
      if (part < S) {
        for (int r = part; r < kTile && t0 + r < h.T; r += S) {
          const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(
              g_i + (size_t)(t0 + r) * n2 + 2 * p);
          s.x += __low2float(v);
          s.y += __high2float(v);
        }
      }
      red[tid] = s;
      __syncthreads();
      if (tid < np) {
        float2 tot = make_float2(0.f, 0.f);
        for (int k = 0; k < S; ++k) {
          tot.x += red[k * np + tid].x;
          tot.y += red[k * np + tid].y;
        }
        float* dst = a.pb1 + ((size_t)b * a.ntiles + tix) * n2 + i * a.two_c + 2 * (p0 + tid);
        dst[0] = tot.x;
        dst[1] = tot.y;
      }
      __syncthreads();
    }
  }
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
  int rows, ntiles, lda, ldx;
  size_t smem;
  Wgrad w1, w0;
  size_t off_a, off_dh, off_dexc, off_phb, off_pb1, off_pw1, off_pw0, total;
};

Plan make_plan(int B, int T, int E, int n, int cc, int two_c) {
  Plan p{};
  p.ok = false;
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 4 || (long long)B * (T + 1) > (1LL << 30)) {
    return p;
  }
  const int cc_pad = (cc + 15) / 16 * 16, e_pad = (E + 15) / 16 * 16;
  p.lda = (cc_pad + 31) / 32 * 32 + 8;  // floats: float2 fragment loads free of conflicts
  p.ldx = a_stride(e_pad);
  p.rows = 0;
  for (int r : kDataRows) {  // the largest tile whose shared memory fits
    p.smem = ((size_t)(r + 2) * p.lda * 4 + (size_t)(r + 2) * p.ldx * 2 + 15) / 16 * 16 +
             kThreads * sizeof(float2);
    if (p.smem <= kSmemMax) {
      p.rows = r;
      break;
    }
  }
  if (p.rows == 0) return p;
  p.ntiles = (T + p.rows - 3) / (p.rows - 2);
  const size_t R = (size_t)B * T;
  const size_t n0 = (size_t)n * cc, n2 = (size_t)n * two_c;
  p.w1 = wgrad_plan(two_c, cc, n, B, T);
  p.w0 = wgrad_plan((int)n0, E, 1, B, T);
  if (p.w1.smem > kSmemMax || p.w0.smem > kSmemMax) return p;
  p.off_a = 0;
  p.off_dh = align256(p.off_a + R * n0 * 2);
  p.off_dexc = align256(p.off_dh + R * n0 * 2);
  p.off_phb = align256(p.off_dexc + (n > 1 ? R * E * 4 : 0));
  p.off_pb1 = align256(p.off_phb + (size_t)B * p.ntiles * n0 * 4);
  p.off_pw1 = align256(p.off_pb1 + (size_t)B * p.ntiles * n2 * 4);
  p.off_pw0 = align256(p.off_pw1 + (size_t)p.w1.S * 3 * cc * n2 * 4);
  p.total = align256(p.off_pw0 + (size_t)p.w0.S * 3 * E * n0 * 4);
  p.ok = true;
  return p;
}

template <int R>
cudaError_t launch_data(const DataArgs& d, const Plan& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k2b_data_kernel<R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return e;
  k2b_data_kernel<R><<<dim3((unsigned)p.ntiles, (unsigned)B), kThreads, p.smem, stream>>>(d);
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

// The rows of h / dh per data-kernel CTA at these widths (128, 64 or 32), or
// 0 for shapes the kernels do not take.
extern "C" int cond_chain_bwd_bf16_rows(int B, int T, int E, int n, int cc, int two_c) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  return p.ok ? p.rows : 0;
}

// Bytes of device scratch cond_chain_bwd_bf16 needs for these shapes (0 for
// shapes the kernels do not take).
extern "C" long long cond_chain_bwd_bf16_workspace(int B, int T, int E, int n, int cc,
                                                   int two_c) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  return p.ok ? (long long)p.total : 0;
}

// Launches K2-bf16's kernels on `stream` and returns the first CUDA error (0
// on success); shapes the kernels do not take, or too little workspace, give
// cudaErrorInvalidValue. Every tensor is bf16; w1 is in its own (3, Cc,
// n*2C) layout. dhbias is (B, n*Cc), or (n*Cc) when hbias_bstride is 0;
// dedge0/dedge_t are written when edge0 is given.
extern "C" int cond_chain_bwd_bf16(const void* exc, const void* w0, const void* hbias,
                                   long long hbias_bstride, const void* edge0,
                                   const void* edge_t, const void* w1, const void* g,
                                   void* dexc, void* dw0, void* dhbias, void* dedge0,
                                   void* dedge_t, void* dw1, void* db1, void* ws,
                                   long long ws_bytes, int B, int T, int E, int n, int cc,
                                   int two_c, void* stream_ptr) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  if (!p.ok || ws_bytes < (long long)p.total || (edge0 == nullptr) != (dedge0 == nullptr)) {
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
  d.h.e_pad = (E + 15) / 16 * 16;
  d.h.cc_pad = (cc + 15) / 16 * 16;
  d.w1 = static_cast<const bf16*>(w1);
  d.g = static_cast<const bf16*>(g);
  d.a_out = a_s;
  d.dh_out = dh_s;
  d.dexc_acc = reinterpret_cast<float*>(wsb + p.off_dexc);
  d.dexc = static_cast<bf16*>(dexc);
  d.phb = phb;
  d.pb1 = pb1;
  d.two_c = two_c;
  d.ntiles = p.ntiles;
  d.lda = p.lda;
  d.ldx = p.ldx;
  cudaError_t e = p.rows == 128 ? launch_data<128>(d, p, B, stream)
                  : p.rows == 64 ? launch_data<64>(d, p, B, stream)
                                 : launch_data<32>(d, p, B, stream);
  if (e != cudaSuccess) return (int)e;

  // dW1^T from g and a (shifted); dW0^T from dh and exc (shifted)
  if ((e = launch_wgrad(p.w1, d.g, n2, two_c, two_c, a_s, n0, cc, cc, n, B, T, pw1,
                        stream)) != cudaSuccess) return (int)e;
  if ((e = launch_wgrad(p.w0, dh_s, n0, 0, n0, d.h.exc, E, 0, E, 1, B, T, pw0,
                        stream)) != cudaSuccess) return (int)e;

  const long long len1 = 3LL * cc * n2;
  const long long len0 = 3LL * E * n0;
  if ((e = launch_reduce(pw1, static_cast<bf16*>(dw1), len1, 1, p.w1.S, len1, 0, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(pw0, static_cast<bf16*>(dw0), len0, 1, p.w0.S, len0, 0, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(pb1, static_cast<bf16*>(db1), n2, 1, B * p.ntiles, n2, 0, stream)) !=
      cudaSuccess) return (int)e;
  if (hbias_bstride) {
    e = launch_reduce(phb, static_cast<bf16*>(dhbias), n0, B, p.ntiles, n0,
                      (long long)p.ntiles * n0, stream);
  } else {
    e = launch_reduce(phb, static_cast<bf16*>(dhbias), n0, 1, B * p.ntiles, n0, 0, stream);
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
