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
// ~2*3*Cc*n*2C flops per output row against n*2C*4 bytes written, i.e. about
// 400 flops per byte, far above the card's ridge even at the tensor cores'
// f32-accurate rate (165 TFLOP/s over 3.35 TB/s = 49 flops per byte): the
// chain is bound by operations.
//
// What the design does about it: both products run on the tensor cores as
// 3xTF32 (tf32x3.cuh: f32 accuracy at a third of the TF32 rate, 2.5x the
// f32 CUDA-core peak), and the n*Cc-wide intermediate h (1224 columns at full
// width) never reaches device memory. One CTA of 8 warps owns (batch row,
// 128-row time tile). It stages the tile's excitation rows (plus a 2-row halo
// on each side) in shared memory once, then loops over the n blocks:
//  1. lrelu(h_i) for the tile plus one halo row on each side, into shared
//     memory (cond_chain_h.cuh: an M = 144, N = Cc, K = 3E tensor-core
//     product; each warp keeps its columns' W0 fragments in registers and
//     walks the rows);
//  2. out_i = the M = 128, N = 2C, K = 3*Cc product: A is lrelu(h_i) in shared
//     memory (tap j reads it j rows down), B is W1_i, which at 2C = 256
//     (3*136*256 floats, 418 KB) does not fit in shared memory, so it comes in
//     K-chunks of 24 (or 48) rows x 64 (or 32) columns through a
//     double-buffered cp.async ring and is split into hi and lo once where it
//     lands (not in each of the 4 or 8 warps that read it); each warp owns a
//     32 x 32 (or 16 x 32) tile of out_i, 8 (or 4) m16n8k8 tiles per k-step,
//     and the CTA makes 2C / 64 passes over the columns. Every staged chunk
//     of W1 serves the tile's 128 rows.
// Shared-memory strides keep each warp's fragment loads free of bank
// conflicts (tf32x3.cuh). Two CTAs fit on an SM (107-111 KB of shared
// memory each in the split form at the decoder's widths).
//
// Wide conditioning. The staged rows grow with Cc (and E in the concat
// form): where the 128-row tile's plan passes a block's 227 KB, the host
// (fwd_plan) takes a 64-row tile and then a 32-row one, a template
// parameter with its own warp layout (4 x 2 warps of 16 x 32; 2 x 4 warps
// of 16 x 32 over 128 columns), so the decoder's widths keep their
// instances. Only what no tile holds is refused.
//
// Numerics: 3xTF32 products into f32 accumulators, no TF32-only product; the
// sums run in another order than cuDNN's or XLA's, so results agree with the
// plain version to rounding (tolerances are stated by the callers). Inputs
// with at most 11 significant bits are multiplied exactly.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

#include "cond_chain_h.cuh"
#include "tf32x3.cuh"

namespace {

using cond_chain_h::HArgs;
using namespace tf32x3;

constexpr int kThreads = 256;         // 8 warps
constexpr int kStages = 2;            // double-buffered
// output rows per CTA: 128, or 64 and then 32 where a wide Cc (or E) leaves
// the 128-row tile's shared memory over the limit
constexpr int kTiles[] = {128, 64, 32};
__host__ __device__ constexpr int act_rows(int tile) { return tile + 2; }  // rows t0-1 .. t0+tile
__host__ __device__ constexpr int xs_rows(int tile) {                       // exc rows t0-2 ..
  return (act_rows(tile) + 15) / 16 * 16 + 2;
}
// warps across a pass's columns: at least 2 for 64-row tiles and 4 for
// 32-row tiles, so that each warp still owns whole 16-row m-tiles
__host__ __device__ constexpr int min_wn(int tile) { return tile >= 128 ? 1 : tile >= 64 ? 2 : 4; }

// k-steps (8 rows each) of W1 per stage: as many as keep two CTAs on an SM
__host__ __device__ constexpr int chunk_steps(int wn) { return wn == 1 ? 6 : wn == 2 ? 3 : 2; }
constexpr size_t kSmemMax = 227 * 1024;

struct Args {
  HArgs h;
  const float* w1;  // (3, Cc, n*2C)
  const float* b1;  // (n*2C)
  float* out;       // (B, T, n*2C)
  int two_c;
  int ldx, lda, ldw;  // shared-memory row strides (floats): exc, lrelu(h), W1 chunk
};

// WN: warps across the columns of a pass, TILE: output rows per CTA. At
// TILE = 128: WN = 2 gives 64 columns, 4 x 2 warps of 32 x 32; WN = 1 gives
// 32 columns, 8 x 1 warps of 16 x 32. At TILE = 64, WN = 2: 4 x 2 warps of
// 16 x 32; at TILE = 32, WN = 4: 128 columns, 2 x 4 warps of 16 x 32.
template <int WN, int TILE>
__global__ void __launch_bounds__(kThreads) cond_chain_fwd_kernel(Args a) {
  constexpr int MT = TILE * WN / 128;  // m-tiles (16 rows) per warp
  static_assert(MT >= 1 && MT * 16 * (8 / WN) == TILE, "warps must cover the tile");
  constexpr int kTile = TILE;
  constexpr int kActRows = act_rows(TILE);
  constexpr int kXsRows = xs_rows(TILE);
  constexpr int BN = 32 * WN;  // columns per pass
  constexpr int kChunkSteps = chunk_steps(WN);
  constexpr int kChunkRows = kChunkSteps * 8;
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                     // [kActRows][lda]
  float* xs = act + kActRows * a.lda;    // [kXsRows][ldx]
  float* wst = xs + kXsRows * a.ldx;     // [kStages][hi, lo][kChunkRows][ldw]
  const int wlo = kChunkRows * a.ldw;    // lo parts of a stage, after its hi parts

  const HArgs& h = a.h;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int n2 = h.n * a.two_c;
  const int ks_tap = h.cc_pad / 8;
  const int ksteps = 3 * ks_tap;
  const int nchunks = (ksteps + kChunkSteps - 1) / kChunkSteps;

  cond_chain_h::stage_exc(h, xs, a.ldx, kXsRows, b, t0);

  for (int i = 0; i < h.n; ++i) {
    __syncthreads();  // xs staged; the previous block's act fully read
    cond_chain_h::recompute_act<false>(h, xs, a.ldx, act, a.lda, kActRows, b, t0, i);
    __syncthreads();

    for (int c0 = 0; c0 < a.two_c; c0 += BN) {
      // chunk ch: W1 rows k = ch*kChunkRows .. (k = j*Cc_pad + c), columns c0 .. c0+BN
      // (split = true: this thread's pieces of chunk ch, landed, split in place)
      auto load = [&](int ch, bool split) {
        float* dst = wst + (ch % kStages) * 2 * wlo;
        constexpr int kPieces = BN / 4;
        for (int idx = tid; idx < kChunkRows * kPieces; idx += kThreads) {
          const int kr = idx / kPieces;
          const int p = idx - kr * kPieces;
          const int k = ch * kChunkRows + kr;
          const int j = k >= 2 * h.cc_pad ? 2 : k >= h.cc_pad ? 1 : 0;
          const int c = k - j * h.cc_pad;
          const int col = c0 + p * 4;
          const bool ok = j < 3 && c < h.cc && col < a.two_c;
          if (split) {
            split_in_place(dst + kr * a.ldw + p * 4, wlo);
          } else {
            cp_async16(dst + kr * a.ldw + p * 4,
                       ok ? a.w1 + ((size_t)j * h.cc + c) * n2 + i * a.two_c + col : a.w1, ok);
          }
        }
      };

      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

      // A[r][k] of k-step (j, cb) = act[r + j][cb + k]: output row t0 + r reads h
      // row t0 + r + j - 1; ap walks (j, cb) = (0, 0), (0, 8), .., (1, 0), ..
      const float* ap = act + (wm * 16 * MT + grp) * a.lda + tig;
      int cb = 0;
      for (int ch = 0; ch < kStages - 1; ++ch) {
        if (ch < nchunks) load(ch, false);
        cp_async_commit();
      }
      for (int ch = 0; ch < nchunks; ++ch) {
        cp_async_wait<kStages - 2>();
        load(ch, true);   // split once here, not in every warp that reads it
        __syncthreads();  // chunk ch split for every thread; chunk ch-1's stage is free
        if (ch + kStages - 1 < nchunks) load(ch + kStages - 1, false);
        cp_async_commit();
        const float* ws = wst + (ch % kStages) * 2 * wlo;
        for (int ss = 0; ss < kChunkSteps; ++ss) {
          const int s = ch * kChunkSteps + ss;
          if (s >= ksteps) break;
          FragA fa[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fa[mt] = load_a(ap + mt * 16 * a.lda, a.lda, 1);
          cb += 8;
          ap += 8;
          if (cb == h.cc_pad) {
            cb = 0;
            ap += a.lda - h.cc_pad;
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const FragB fb =
                load_b_split(ws + (ss * 8 + tig) * a.ldw + wn * 32 + nt * 8 + grp, wlo, a.ldw);
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][nt], fa[mt], fb);
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();  // every stage read before the next pass loads into them

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = c0 + wn * 32 + nt * 8 + 2 * tig;
          if (col >= a.two_c) continue;
          const int ocol = i * a.two_c + col;
          const float bb0 = __ldg(a.b1 + ocol);
          const float bb1 = __ldg(a.b1 + ocol + 1);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = t0 + wm * 16 * MT + mt * 16 + grp + 8 * half;
            if (t < h.T) {
              *reinterpret_cast<float2*>(a.out + ((size_t)b * h.T + t) * n2 + ocol) =
                  make_float2(acc[mt][nt][2 * half] + bb0, acc[mt][nt][2 * half + 1] + bb1);
            }
          }
        }
      }
    }
  }
}

template <int WN, int TILE>
int launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(cond_chain_fwd_kernel<WN, TILE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a.h.T + TILE - 1) / TILE), (unsigned)B);
  cond_chain_fwd_kernel<WN, TILE><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The largest tile whose shared memory fits (0 if none), its WN and bytes.
struct FwdPlan {
  int tile, wn;
  size_t smem;
  int ldx, lda, ldw;
};

FwdPlan fwd_plan(int E, int cc, int two_c) {
  for (int tile : kTiles) {
    FwdPlan p;
    p.tile = tile;
    p.wn = two_c > 32 ? 2 : 1;
    if (p.wn < min_wn(tile)) p.wn = min_wn(tile);
    p.ldx = row_read_stride(E);
    p.lda = row_read_stride(cc);
    p.ldw = k_read_stride(32 * p.wn);
    p.smem = ((size_t)act_rows(tile) * p.lda + (size_t)xs_rows(tile) * p.ldx +
              (size_t)kStages * 2 * chunk_steps(p.wn) * 8 * p.ldw) * sizeof(float);
    if (p.smem <= kSmemMax) return p;
  }
  return FwdPlan{0, 0, 0, 0, 0, 0};
}

}  // namespace

extern "C" const char* cond_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); shapes
// the kernel does not take (2C or Cc not a multiple of 4), or too much shared
// memory, give an error code.
extern "C" int cond_chain_fwd_f32(const float* exc, const float* w0, const float* hbias,
                                  long long hbias_bstride, const float* edge0,
                                  const float* edge_t, const float* w1, const float* b1,
                                  float* out, int B, int T, int E, int n, int cc, int two_c,
                                  void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 4) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.h.exc = exc;
  a.h.w0 = w0;
  a.h.hbias = hbias;
  a.h.hbias_bstride = hbias_bstride;
  a.h.edge0 = edge0;
  a.h.edge_t = edge_t;
  a.h.T = T;
  a.h.E = E;
  a.h.n = n;
  a.h.cc = cc;
  a.h.e_pad = (E + 7) / 8 * 8;
  a.h.cc_pad = (cc + 7) / 8 * 8;
  a.w1 = w1;
  a.b1 = b1;
  a.out = out;
  a.two_c = two_c;
  const FwdPlan p = fwd_plan(E, cc, two_c);
  if (p.tile == 0) return (int)cudaErrorInvalidValue;
  a.ldx = p.ldx;
  a.lda = p.lda;
  a.ldw = p.ldw;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.tile == 128) {
    return p.wn == 2 ? launch<2, 128>(a, B, p.smem, st) : launch<1, 128>(a, B, p.smem, st);
  }
  return p.tile == 64 ? launch<2, 64>(a, B, p.smem, st) : launch<4, 32>(a, B, p.smem, st);
}

// The rows of the time tile cond_chain_fwd_f32 takes at these widths (128,
// 64 or 32), or 0 when no tile's shared memory fits.
extern "C" int cond_chain_fwd_tile(int E, int cc, int two_c) {
  return fwd_plan(E, cc, two_c).tile;
}
