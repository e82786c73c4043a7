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
// What bounds it on an H100: as K1 (cond_chain.cu), about 400 flops per byte
// written at the decoder's shapes, above the ridge of the card's dense bf16
// tensor-core rate (989.4 TFLOP/s over 3.35 TB/s = 295 flops per byte): it
// is bound by operations.
//
// What the design does about it: every product is one bf16 mma.sync per
// m16n8k16 tile (cond_chain_bf16.cuh), where K1 makes three 3xTF32 ones per
// m16n8k8 tile, and the n*Cc-wide intermediate stays on chip. One CTA of 8
// warps owns (batch row, 128-row time tile): it stages the tile's excitation
// rows (a 2-row halo each side) in shared memory once, then per block i
//  1. a = bf16(lrelu(h_i)) for the tile and one halo row each side, into
//     shared memory (cond_chain_bf16.cuh: M = 144, N = Cc, K = 3E);
//  2. out_i, an M = 128, N = 2C, K = 3*Cc product in passes of 64 (or 32)
//     columns: A is a in shared memory (tap j reads it j rows down), B is
//     W1_i, read as pairs of bf16 through L1 (1.9 MB in all at the decoder's
//     widths, resident in L2); each warp owns 32 x 32 (or 16 x 32) of a pass.
// A simple first version: W1 is not staged, nothing is double-buffered and
// there is no wgmma or TMA (later work, PERF.md). Where the 128-row tile's
// shared memory passes a block's 227 KB (wide Cc or E), the host takes a
// 64-row and then a 32-row tile, as K1 does.
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

using namespace bf16mma;

constexpr int kThreads = 256;  // 8 warps
constexpr int kTiles[] = {128, 64, 32};
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ constexpr int act_rows(int tile) { return tile + 2; }  // rows t0-1 .. t0+tile
__host__ __device__ constexpr int h_mtiles(int tile) { return (act_rows(tile) + 15) / 16; }
__host__ __device__ constexpr int xs_rows(int tile) { return h_mtiles(tile) * 16 + 2; }
__host__ __device__ constexpr int min_wn(int tile) { return tile >= 128 ? 1 : tile >= 64 ? 2 : 4; }

struct Args {
  HArgs h;
  const bf16* w1;  // (3, Cc, n*2C)
  const bf16* b1;  // (n*2C)
  bf16* out;       // (B, T, n*2C)
  int two_c;
  int ldx, lda;    // shared-memory row strides (bf16): exc, a
};

// WN: warps across a pass's columns (32 * WN of them), TILE: output rows per
// CTA; 8 / WN warps down the rows, MT m-tiles of 16 rows each.
template <int WN, int TILE>
__global__ void __launch_bounds__(kThreads) k1_bf16_kernel(Args a) {
  constexpr int MT = TILE * WN / 128;
  static_assert(MT >= 1 && MT * 16 * (8 / WN) == TILE, "warps must cover the tile");
  constexpr int kActRows = act_rows(TILE);
  constexpr int BN = 32 * WN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* act = reinterpret_cast<bf16*>(smem_raw);  // [kActRows][lda]
  bf16* xs = act + kActRows * a.lda;                 // [xs_rows][ldx]

  const HArgs& h = a.h;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp / WN;
  const int wn = warp % WN;
  const int n2 = h.n * a.two_c;
  const int ks_tap = h.cc_pad / 16;

  stage_exc(h, xs, a.ldx, xs_rows(TILE), b, t0);

  for (int i = 0; i < h.n; ++i) {
    __syncthreads();  // xs staged; the previous block's a fully read
    recompute_act<h_mtiles(TILE), false>(h, xs, a.ldx, act, a.lda, kActRows, b, t0, i);
    __syncthreads();

    for (int c0 = 0; c0 < a.two_c; c0 += BN) {
      float acc[MT][4][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

      for (int j = 0; j < 3; ++j) {
        // A[r][k] of tap j = a[r + j][k]: output row t0 + r reads h row t0 + r + j - 1
        const bf16* ap = act + (wm * 16 * MT + grp + j) * a.lda + 2 * tig;
        const bf16* wj = a.w1 + (size_t)j * h.cc * n2 + (size_t)i * a.two_c;
        for (int ks = 0; ks < ks_tap; ++ks) {
          const int c = ks * 16 + 2 * tig;  // this lane's k (cond channel) pairs
          FragA fa[MT];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) fa[mt] = load_a(ap + mt * 16 * a.lda + ks * 16, a.lda);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const int o = c0 + wn * 32 + nt * 8 + grp;  // this lane's B column
            const bool ook = o < a.two_c;
            const bf16* wp = wj + o;
            uint32_t bb[2];
            bb[0] = pack(ldg1(wp + (size_t)c * n2, ook && c < h.cc),
                         ldg1(wp + (size_t)(c + 1) * n2, ook && c + 1 < h.cc));
            bb[1] = pack(ldg1(wp + (size_t)(c + 8) * n2, ook && c + 8 < h.cc),
                         ldg1(wp + (size_t)(c + 9) * n2, ook && c + 9 < h.cc));
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) mma(acc[mt][nt], fa[mt].r, bb);
          }
        }
      }

#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = c0 + wn * 32 + nt * 8 + 2 * tig;
          if (col >= a.two_c) continue;
          const int ocol = i * a.two_c + col;
          const float bb0 = f32(a.b1[ocol]);
          const float bb1 = f32(a.b1[ocol + 1]);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int t = t0 + wm * 16 * MT + mt * 16 + grp + 8 * half;
            if (t < h.T) {
              store2(a.out + ((size_t)b * h.T + t) * n2 + ocol,
                     bb0 + acc[mt][nt][2 * half], bb1 + acc[mt][nt][2 * half + 1]);
            }
          }
        }
      }
    }
  }
}

template <int WN, int TILE>
int launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k1_bf16_kernel<WN, TILE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a.h.T + TILE - 1) / TILE), (unsigned)B);
  k1_bf16_kernel<WN, TILE><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

struct FwdPlan {
  int tile, wn;
  size_t smem;
  int ldx, lda;
};

// The largest tile whose shared memory fits (tile 0 if none)
FwdPlan fwd_plan(int E, int cc, int two_c) {
  const int e_pad = (E + 15) / 16 * 16, cc_pad = (cc + 15) / 16 * 16;
  for (int tile : kTiles) {
    FwdPlan p;
    p.tile = tile;
    p.wn = two_c > 32 ? 2 : 1;
    if (p.wn < min_wn(tile)) p.wn = min_wn(tile);
    p.ldx = a_stride(e_pad);
    p.lda = a_stride(cc_pad);
    p.smem = ((size_t)act_rows(tile) * p.lda + (size_t)xs_rows(tile) * p.ldx) * sizeof(bf16);
    if (p.smem <= kSmemMax) return p;
  }
  return FwdPlan{0, 0, 0, 0, 0};
}

}  // namespace

extern "C" const char* cond_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); shapes
// the kernel does not take (2C or Cc not a multiple of 4), or too much shared
// memory, give an error code. Every pointer is to bf16.
extern "C" int cond_chain_fwd_bf16(const void* exc, const void* w0, const void* hbias,
                                   long long hbias_bstride, const void* edge0,
                                   const void* edge_t, const void* w1, const void* b1,
                                   void* out, int B, int T, int E, int n, int cc, int two_c,
                                   void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 4) {
    return (int)cudaErrorInvalidValue;
  }
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
  a.h.e_pad = (E + 15) / 16 * 16;
  a.h.cc_pad = (cc + 15) / 16 * 16;
  a.w1 = static_cast<const bf16*>(w1);
  a.b1 = static_cast<const bf16*>(b1);
  a.out = static_cast<bf16*>(out);
  a.two_c = two_c;
  const FwdPlan p = fwd_plan(E, cc, two_c);
  if (p.tile == 0) return (int)cudaErrorInvalidValue;
  a.ldx = p.ldx;
  a.lda = p.lda;
  cudaStream_t st = (cudaStream_t)stream;
  if (p.tile == 128) {
    return p.wn == 2 ? launch<2, 128>(a, B, p.smem, st) : launch<1, 128>(a, B, p.smem, st);
  }
  return p.tile == 64 ? launch<2, 64>(a, B, p.smem, st) : launch<4, 32>(a, B, p.smem, st);
}

// The rows of the time tile cond_chain_fwd_bf16 takes at these widths (128,
// 64 or 32), or 0 when no tile's shared memory fits.
extern "C" int cond_chain_fwd_bf16_tile(int E, int cc, int two_c) {
  return fwd_plan(E, cc, two_c).tile;
}
