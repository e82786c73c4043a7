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
// 3xTF32 (tf32x3.cuh: warp-level mma.sync m16n8k8, f32 accuracy at a third
// of the TF32 rate, 2.5x the f32 CUDA-core peak). The TPU kernel accumulates
// the weight grads in VMEM across a grid that runs in order; Hopper CTAs run
// in no order, so the work is split into kernels that each own their
// outputs, and every sum runs in a fixed order (the results are the same
// from run to run, with no atomics):
//
//  (a) k2_data_kernel, one CTA of 8 warps per (batch row, 126-row time tile;
//      62 or 30 rows where a wide Cc or E passes a block's shared memory,
//      chosen on the host by make_plan, DataGeom below):
//      stages the tile's excitation rows once; per block i it
//       - recomputes lrelu(h_i) for the tile plus one halo row on each side
//         (128 rows) in shared memory (cond_chain_h.cuh);
//       - forms da_i, an M = 128, N = Cc, K = 3*2C product, in passes of
//         144 channels (one pass at the decoder's Cc = 136): g_i's rows and
//         W1_i^T come in K-chunks of 8 output channels (130 g rows and the 3
//         taps' 8 x 144 slices of W1_i^T) through a double-buffered cp.async
//         ring, so neither operand streams through L1 (W1_i^T is 418 KB at
//         2C = 256 and does not fit in shared memory whole); W1_i^T is split
//         into hi and lo once where it lands; tap j reads the staged g rows j
//         rows up; each warp owns 32 x 72 of a pass's da; in the first pass
//         one warp per staged g column sums the tile's own rows (db1);
//       - turns da into dh in place (the slope from the recomputed h), and
//         writes lrelu(h_i) and dh_i of the tile's own rows to scratch;
//       - adds the tile's dexc (M = 128, N = E, K = 3*Cc: A = dh in shared
//         memory, B = W0_i through L1, one accumulator per tap) into dexc,
//         which the CTA owns;
//       - sums dh_i over its own rows per channel (dhbias), a warp a channel.
//  (b) k2_wgrad_kernel, split-K weight grads, both as D = X^T Y(shifted):
//      dW1_i^T[j] (M = 2C, N = Cc; X = g_i, Y = the lrelu(h) scratch) and
//      dW0^T[j] (M = n*Cc, N = E; X = the dh scratch, Y = exc). A CTA owns
//      one (block, output tile) and one fixed chunk of the B*T rows and
//      computes all three taps: it stages 32 rows of X and the 34 rows of Y
//      around them (a one-row halo each side) per cp.async stage, double
//      buffered, splits both into hi and lo once where they land, and serves
//      the three taps from that one staging. Rows are indexed with a zero row
//      between batch rows, so that a tap never pairs rows of two batch rows.
//      It writes a partial.
//  (c) k2_reduce_kernel sums the partials over the chunks in order, and gives
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

#include "cond_chain_h.cuh"
#include "tf32x3.cuh"

namespace {

using cond_chain_h::HArgs;
using cond_chain_h::kSlope;
using namespace tf32x3;

constexpr int kThreads = 256;        // data kernel: 8 warps
constexpr int kOC = 8;               // g columns (output channels o) per stage
constexpr int kStages = 2;           // double-buffered

// The data kernel's shape for R rows of h / dh per CTA (its time tile and a
// halo row each side): 128, or 64 and then 32 where a wide Cc (or E) leaves
// the 128-row plan's shared memory over the limit. At R = 128 and 64 the
// warps are 4 (rows) x 2 (channels), each owning 72 channels of a pass; at
// R = 32 they are 2 x 4, each owning 32 channels.
template <int R>
struct DataGeom {
  static constexpr int kRows = R;
  static constexpr int kTile = R - 2;        // the CTA's own rows
  static constexpr int kXsRows = R + 2;      // exc rows t0-2 ..
  static constexpr int kGRows = R + 2;       // g rows t0-2 .. t0+kTile+1
  static constexpr int kWNShift = R >= 64 ? 1 : 2;
  static constexpr int kWN = 1 << kWNShift;    // warps along da's channels
  static constexpr int kWM = 8 / kWN;          // warps along its rows
  static constexpr int kMT = R / (16 * kWM);   // m-tiles (16 rows) per warp
  static constexpr int kDaNT = R >= 64 ? 9 : 4;  // 8-channel n-tiles of da per warp and pass
  static constexpr int kDaCols = kWN * kDaNT * 8;  // channels of da per pass
  static_assert(kMT >= 1 && kMT * 16 * kWM == R, "warps must cover the rows");
};
constexpr int kDataRows[] = {128, 64, 32};
constexpr int kDaCols128 = DataGeom<128>::kDaCols;  // 144: one pass at the decoder's Cc
constexpr int kWRows = 32;           // weight-grad kernel: rows per stage
constexpr int kWStages = 2;
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kTargetCtas = 4 * 132;  // split-K aims at four CTAs per SM

struct DataArgs {
  HArgs h;
  const float* w1t;  // (n, 3, 2C, Cc): W1 with the input channel innermost
  const float* g;    // (B, T, n*2C)
  float* a_out;      // (B, T, n*Cc) scratch: lrelu(h)
  float* dh_out;     // (B, T, n*Cc) scratch: dh
  float* dexc;       // (B, T, E)
  float* phb;        // (B, ntiles, n*Cc) partial sums of dh
  float* pb1;        // (B, ntiles, n*2C) partial sums of g
  int two_c, ntiles;
  int lda, ldx, ldg, ldw;  // shared-memory row strides (floats)
};

// sum over r < kTile of p[(r0 + r) * ld], by one warp, in a fixed order
// (rows outside [0, T) hold zeros); the result in every lane
template <int kTile>
__device__ __forceinline__ float own_rows_sum(const float* p, int ld, int r0) {
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  for (int r = lane; r < kTile; r += 32) s += p[(r0 + r) * ld];
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// kOnePass (Cc <= kDaCols, R = 128 only) compiles the loop over da's
// passes, and the h recompute's over column groups, away.
template <int R, bool kOnePass>
__global__ void __launch_bounds__(kThreads) k2_data_kernel(DataArgs a) {
  using Geo = DataGeom<R>;
  constexpr int kRows = Geo::kRows;
  constexpr int kTile = Geo::kTile;
  constexpr int kXsRows = Geo::kXsRows;
  constexpr int kGRows = Geo::kGRows;
  constexpr int kDaNT = Geo::kDaNT;
  constexpr int kDaCols = Geo::kDaCols;
  constexpr int kMT = Geo::kMT;
  extern __shared__ __align__(16) float smem[];
  const HArgs& h = a.h;
  float* buf = smem;                         // [kRows + 2][lda]: lrelu(h_i), then dh_i; rows t0-1 ..
  float* xs = buf + (kRows + 2) * a.lda;     // [kXsRows][ldx]: exc rows t0-2 ..
  float* stg = xs + kXsRows * a.ldx;         // [kStages]: g [kGRows][ldg], W1^T hi, lo [3*kOC][ldw]
  const int wlo = 3 * kOC * a.ldw;           // W1^T's lo parts, after its hi parts
  const int stage_floats = kGRows * a.ldg + 2 * wlo;

  const int b = blockIdx.y;
  const int tix = blockIdx.x;
  const int t0 = tix * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp >> Geo::kWNShift;  // slab of 16 * kMT rows of da
  const int wn = warp & (Geo::kWN - 1);  // kDaNT * 8 channels of a pass
  const int n0 = h.n * h.cc;
  const int n2 = h.n * a.two_c;
  const int nchunks = (a.two_c + kOC - 1) / kOC;
  const int npass = kOnePass ? 1 : (h.cc + kDaCols - 1) / kDaCols;
  const int ks_tap = h.cc_pad / 8;

  cond_chain_h::stage_exc(h, xs, a.ldx, kXsRows, b, t0);
  // rows kRows, kRows+1 of buf stay zero: the dexc tile's last rows read them
  for (int idx = tid; idx < 2 * a.lda; idx += kThreads) buf[kRows * a.lda + idx] = 0.f;

  for (int i = 0; i < h.n; ++i) {
    const float* g_i = a.g + (size_t)b * h.T * n2 + i * a.two_c;
    const float* wt_i = a.w1t + (size_t)i * 3 * a.two_c * h.cc;
    // chunk ch of pass ps: g_i rows t0-2 .. and columns o0 = ch*kOC ..; W1_i^T
    // rows (j, o0 ..), channels cp0 = ps*kDaCols ..
    // (split = true: this thread's pieces of W1_i^T in chunk ch, landed, split in place)
    int cp0 = 0;
    auto load = [&](int ch, bool split) {
      float* gd = stg + (ch % kStages) * stage_floats;
      float* wd = gd + kGRows * a.ldg;
      const int o0 = ch * kOC;
      constexpr int kGP = kOC / 4;       // 16-byte pieces per g row
      constexpr int kWP = kDaCols / 4;   // per W1^T row
      constexpr int kNG = kGRows * kGP;
      for (int idx = tid; idx < kNG + 3 * kOC * kWP; idx += kThreads) {
        if (idx < kNG) {
          if (split) continue;  // g is split where it is read
          const int r = idx / kGP;
          const int o = (idx - r * kGP) * 4;
          const int t = t0 - 2 + r;
          const bool ok = t >= 0 && t < h.T && o0 + o < a.two_c;
          cp_async16(gd + r * a.ldg + o, ok ? g_i + (size_t)t * n2 + o0 + o : a.g, ok);
        } else {
          const int k = idx - kNG;
          const int r = k / kWP;  // j*kOC + o
          const int c = (k - r * kWP) * 4;
          const int j = r / kOC;
          const int o = o0 + r - j * kOC;
          const bool ok = o < a.two_c && cp0 + c < h.cc;
          if (split) {
            split_in_place(wd + r * a.ldw + c, wlo);
          } else {
            cp_async16(wd + r * a.ldw + c,
                       ok ? wt_i + ((size_t)j * a.two_c + o) * h.cc + cp0 + c : a.w1t, ok);
          }
        }
      }
    };

    __syncthreads();  // xs staged; the previous block's buf fully read
    // the first chunks of g_i and W1_i^T land while lrelu(h_i) is recomputed
    for (int ch = 0; ch < kStages - 1; ++ch) {
      if (ch < nchunks) load(ch, false);
      cp_async_commit();
    }
    cond_chain_h::recompute_act<kOnePass>(h, xs, a.ldx, buf, a.lda, kRows, b, t0, i);

    // da[q][c] = sum_j sum_o g[t0-1+q-j+1][o] W1_i[j][c][o]: gs row q + 2 - j, in
    // passes of kDaCols channels (one pass at Cc <= 144); each pass streams
    // all of g_i and its channels of W1_i^T
    for (int ps = 0; ps < npass; ++ps) {
      cp0 = ps * kDaCols;
      if (ps > 0) {
        __syncthreads();  // the previous pass's last stage fully read
        for (int ch = 0; ch < kStages - 1; ++ch) {
          if (ch < nchunks) load(ch, false);
          cp_async_commit();
        }
      }
      float acc[kMT][kDaNT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kDaNT; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;
      for (int ch = 0; ch < nchunks; ++ch) {
        cp_async_wait<kStages - 2>();
        load(ch, true);
        __syncthreads();  // chunk ch landed and split; chunk ch-1's stage is free; buf holds lrelu(h_i)
        if (ch + kStages - 1 < nchunks) load(ch + kStages - 1, false);
        cp_async_commit();
        const float* gs = stg + (ch % kStages) * stage_floats;
        const float* wts = gs + kGRows * a.ldg;
        // g of the tile's own rows (gs rows 2 .. kTile + 1) summed per channel, for db1
        if (ps == 0 && warp < kOC && ch * kOC + warp < a.two_c) {
          const float s = own_rows_sum<kTile>(gs + warp, a.ldg, 2);
          if (lane == 0) a.pb1[((size_t)b * a.ntiles + tix) * n2 + i * a.two_c + ch * kOC + warp] = s;
        }
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          FragA fa[kMT];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            fa[mt] = load_a(gs + (wm * 16 * kMT + mt * 16 + grp + 2 - j) * a.ldg + tig, a.ldg, 1);
#pragma unroll
          for (int nt = 0; nt < kDaNT; ++nt) {
            const FragB fb = load_b_split(
                wts + (j * kOC + tig) * a.ldw + wn * kDaNT * 8 + nt * 8 + grp, wlo, a.ldw);
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt) mma3(acc[mt][nt], fa[mt], fb);
          }
        }
      }
      cp_async_wait<0>();

      // dh = lrelu'(h) da in place (each element is read and written by its
      // owner only); lrelu(h) and dh of the tile's own rows to scratch
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
            const float d0 = valid ? (a0 >= 0.f ? da0 : kSlope * da0) : 0.f;
            const float d1 = valid ? (a1 >= 0.f ? da1 : kSlope * da1) : 0.f;
            slot[0] = d0;
            slot[1] = d1;
            if (valid && q >= 1 && q <= kTile) {
              const size_t off = ((size_t)b * h.T + u) * n0 + i * h.cc + c;
              *reinterpret_cast<float2*>(a.a_out + off) = make_float2(a0, a1);
              *reinterpret_cast<float2*>(a.dh_out + off) = make_float2(d0, d1);
            }
          }
        }
      }
    }
    __syncthreads();

    // dexc[t0+r] += sum_j sum_c dh[t0+r-j+1][c] W0[j][e][i*Cc+c]: buf row r + 2 - j
    {
      const int etiles = h.e_pad / 8;
      for (int item = warp; item < (kRows / 16) * etiles; item += kThreads / 32) {
        const int mt = item / etiles;
        const int et = item - mt * etiles;
        const int e = et * 8 + grp;  // this lane's B column
        const float* wrow = h.w0 + (size_t)e * n0 + i * h.cc;
        // one accumulator per tap: three independent chains of mma
        float dj[3][4];
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) dj[j][v] = 0.f;
        for (int ks = 0; ks < ks_tap; ++ks) {
          const int cb = ks * 8;
          const int ca = cb + tig;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float* wj = wrow + (size_t)j * h.E * n0;
            const FragA fa = load_a(buf + (mt * 16 + grp + 2 - j) * a.lda + cb + tig, a.lda, 1);
            const float b0 = (e < h.E && ca < h.cc) ? __ldg(wj + ca) : 0.f;
            const float b1 = (e < h.E && ca + 4 < h.cc) ? __ldg(wj + ca + 4) : 0.f;
            mma3(dj[j], fa, make_b(b0, b1));
          }
        }
        float d[4];
#pragma unroll
        for (int v = 0; v < 4; ++v) d[v] = (dj[0][v] + dj[1][v]) + dj[2][v];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = mt * 16 + grp + 8 * half;
          const int t = t0 + r;
          if (r >= kTile || t >= h.T) continue;
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int ec = et * 8 + 2 * tig + u;
            if (ec >= h.E) continue;
            float* dst = a.dexc + ((size_t)b * h.T + t) * h.E + ec;
            *dst = i == 0 ? d[2 * half + u] : *dst + d[2 * half + u];
          }
        }
      }
    }
    // dh of the tile's own rows (buf rows 1 .. kTile) summed per channel, for dhbias
    for (int c = warp; c < h.cc; c += kThreads / 32) {
      const float s = own_rows_sum<kTile>(buf + c, a.lda, 1);
      if (lane == 0) a.phb[((size_t)b * a.ntiles + tix) * n0 + i * h.cc + c] = s;
    }
  }
}

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
// the kernels do not take.
struct Plan {
  bool ok;
  int rows, ntiles, lda, ldx, ldg, ldw;
  size_t smem;
  Wgrad w1, w0;
  size_t off_a, off_dh, off_phb, off_pb1, off_pw1, off_pw0, total;
};

Plan make_plan(int B, int T, int E, int n, int cc, int two_c) {
  Plan p{};
  p.ok = false;
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 4 ||
      (long long)B * (T + 1) > (1LL << 30)) {
    return p;
  }
  p.lda = row_read_stride(cc);
  p.ldx = row_read_stride(E);
  p.ldg = row_read_stride(kOC);
  p.rows = 0;
  for (int r : kDataRows) {  // the largest tile whose shared memory fits
    const int da_cols = r == 128 ? DataGeom<128>::kDaCols
                                 : r == 64 ? DataGeom<64>::kDaCols : DataGeom<32>::kDaCols;
    p.ldw = k_read_stride(da_cols);
    p.smem = ((size_t)(r + 2) * p.lda + (size_t)(r + 2) * p.ldx +
              (size_t)kStages * ((r + 2) * p.ldg + 2 * 3 * kOC * p.ldw)) * sizeof(float);
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
  p.off_dh = p.off_a + R * n0;
  p.off_phb = p.off_dh + R * n0;
  p.off_pb1 = p.off_phb + (size_t)B * p.ntiles * n0;
  p.off_pw1 = p.off_pb1 + (size_t)B * p.ntiles * n2;
  p.off_pw0 = p.off_pw1 + (size_t)p.w1.S * 3 * cc * n2;
  p.total = p.off_pw0 + (size_t)p.w0.S * 3 * E * n0;
  p.ok = true;
  return p;
}

template <int R, bool kOnePass>
cudaError_t launch_data(const DataArgs& d, const Plan& p, int B, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k2_data_kernel<R, kOnePass>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return e;
  k2_data_kernel<R, kOnePass>
      <<<dim3((unsigned)p.ntiles, (unsigned)B), kThreads, p.smem, stream>>>(d);
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

}  // namespace

// The rows of h / dh per data-kernel CTA at these widths (128, 64 or 32), or
// 0 for shapes the kernels do not take.
extern "C" int cond_chain_bwd_rows(int B, int T, int E, int n, int cc, int two_c) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  return p.ok ? p.rows : 0;
}

// Floats of device scratch cond_chain_bwd_f32 needs for these shapes (0 for
// shapes the kernels do not take).
extern "C" long long cond_chain_bwd_workspace(int B, int T, int E, int n, int cc, int two_c) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  return p.ok ? (long long)p.total : 0;
}

// Launches K2's kernels on `stream` and returns the first CUDA error (0 on
// success); shapes the kernels do not take, or too little workspace, give
// cudaErrorInvalidValue. dhbias is (B, n*Cc), or (n*Cc) when hbias_bstride is
// 0; dedge0/dedge_t are written when edge0 is given.
extern "C" int cond_chain_bwd_f32(const float* exc, const float* w0, const float* hbias,
                                  long long hbias_bstride, const float* edge0,
                                  const float* edge_t, const float* w1t, const float* g,
                                  float* dexc, float* dw0, float* dhbias, float* dedge0,
                                  float* dedge_t, float* dw1, float* db1, float* ws,
                                  long long ws_floats, int B, int T, int E, int n, int cc,
                                  int two_c, void* stream_ptr) {
  const Plan p = make_plan(B, T, E, n, cc, two_c);
  if (!p.ok || ws_floats < (long long)p.total || (edge0 == nullptr) != (dedge0 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int n0 = n * cc;
  const int n2 = n * two_c;
  float* a_s = ws + p.off_a;
  float* dh_s = ws + p.off_dh;

  DataArgs d;
  d.h.exc = exc;
  d.h.w0 = w0;
  d.h.hbias = hbias;
  d.h.hbias_bstride = hbias_bstride;
  d.h.edge0 = edge0;
  d.h.edge_t = edge_t;
  d.h.T = T;
  d.h.E = E;
  d.h.n = n;
  d.h.cc = cc;
  d.h.e_pad = (E + 7) / 8 * 8;
  d.h.cc_pad = (cc + 7) / 8 * 8;
  d.w1t = w1t;
  d.g = g;
  d.a_out = a_s;
  d.dh_out = dh_s;
  d.dexc = dexc;
  d.phb = ws + p.off_phb;
  d.pb1 = ws + p.off_pb1;
  d.two_c = two_c;
  d.ntiles = p.ntiles;
  d.lda = p.lda;
  d.ldx = p.ldx;
  d.ldg = p.ldg;
  d.ldw = p.ldw;
  cudaError_t e = p.rows == 128 ? (cc <= kDaCols128 ? launch_data<128, true>(d, p, B, stream)
                                                    : launch_data<128, false>(d, p, B, stream))
                  : p.rows == 64 ? launch_data<64, false>(d, p, B, stream)
                                 : launch_data<32, false>(d, p, B, stream);
  if (e != cudaSuccess) return (int)e;

  // dW1^T from g and lrelu(h) (shifted); dW0^T from dh and exc (shifted)
  if ((e = launch_wgrad(p.w1, g, n2, two_c, two_c, a_s, n0, cc, cc, n, B, T, ws + p.off_pw1,
                        stream)) != cudaSuccess) return (int)e;
  if ((e = launch_wgrad(p.w0, dh_s, n0, 0, n0, exc, E, 0, E, 1, B, T, ws + p.off_pw0,
                        stream)) != cudaSuccess) return (int)e;

  const long long len1 = 3LL * cc * n2;
  const long long len0 = 3LL * E * n0;
  if ((e = launch_reduce(ws + p.off_pw1, dw1, len1, 1, p.w1.S, len1, 0, 1.f, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(ws + p.off_pw0, dw0, len0, 1, p.w0.S, len0, 0, 1.f, stream)) !=
      cudaSuccess) return (int)e;
  if ((e = launch_reduce(ws + p.off_pb1, db1, n2, 1, B * p.ntiles, n2, 0, 1.f, stream)) !=
      cudaSuccess) return (int)e;
  if (hbias_bstride) {
    e = launch_reduce(ws + p.off_phb, dhbias, n0, B, p.ntiles, n0, (long long)p.ntiles * n0,
                      1.f, stream);
  } else {
    e = launch_reduce(ws + p.off_phb, dhbias, n0, 1, B * p.ntiles, n0, 0, 1.f, stream);
  }
  if (e != cudaSuccess) return (int)e;
  if (edge0) {
    if ((e = launch_reduce(dh_s, dedge0, n0, B, 1, 0, (long long)T * n0, -1.f, stream)) !=
        cudaSuccess) return (int)e;
    if ((e = launch_reduce(dh_s + (size_t)(T - 1) * n0, dedge_t, n0, B, 1, 0,
                           (long long)T * n0, -1.f, stream)) != cudaSuccess) return (int)e;
  }
  return 0;
}
