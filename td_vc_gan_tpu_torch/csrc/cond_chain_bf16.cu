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
// products whose N is small (2C = 32 at the longest stage). The kernel's
// first version, with bf16 mma.sync fragments loaded from global memory (B
// packed from four 16-bit loads per fragment), was bound by instruction
// throughput and latency.
//
// What the design does about it: both products on wgmma (hopper_bf16.cuh)
// with f32 accumulators in registers, every operand of them brought by the
// producer warp's TMA and bulk copies through mbarrier rings; no operand
// read through L1 per fragment. One CTA owns (batch row, 124-row time tile)
// (cond_chain_bf16.cuh: two consumer warpgroups of 64 rows of h each, a
// producer warp). At each launch a small kernel (w_images_kernel) lays out
// cond_0's weights as h's B, the bias and edges folded in as three more k,
// and W1 transposed, (n, 3, 2C, Cc8) (K-major, Cc padded to 8: every stride
// a multiple of 16 bytes, as TMA wants), in the workspace. Per block i:
//  1. h_i on wgmma: M = 64, N = 136 columns a pass, K = 3E + 3 (32 at the
//     decoder's E = 8): A from registers (exc's taps, 1 and the edge
//     indicators; kept for every block at E <= 9), B a bulk copy through a
//     2-slot weights ring; lrelu in f32, rounded to bf16 in pairs: the A
//     registers of the next product (route (a) below).
//  2. P = a_i @ [W1_i[0] | W1_i[1] | W1_i[2]] on wgmma with A from
//     registers: N = 3W for a chunk of W = 64 output columns (32 where
//     2C <= 32), K = the pass's 144 columns in slices of 16 (the last 8 zero
//     in A, against W1's next columns). A stage of the TMA ring is the three
//     taps' W x 64 boxes of w1t, 3 (W = 64) or 4 stages with full/empty
//     mbarriers; the producer runs ahead across chunks and blocks, so block
//     i+1's weights are in flight while block i finishes. Consecutive stages'
//     products overlap (one wgmma group in flight when a stage is released).
//  3. out[t] = b1 + P_0[t-1] + P_1[t] + P_2[t+1] (a's rows t-1 .. t+1),
//     summed in f32 through shared memory and rounded once.
// The row shift of the second conv, route (a): products from registers,
// shifted in the epilogue. a_i comes straight out of h's accumulators, so it
// never goes through shared memory, and A from registers leaves shared
// memory's bandwidth to B alone (at 2C = 32 an A in shared memory would be
// read once per 32 output columns). The output goes out with plain 4-byte
// stores from the epilogue (a warp writes whole 128-byte rows at W = 64):
// the sum through shared memory is the epilogue's staging already, and the
// output's row stride (n 2C bf16) is not a multiple of 16 bytes at every
// width the kernel takes, as a TMA store would need.
// Every width goes in passes of 136 columns of h, so the shared memory does
// not grow with Cc or E: one tile for every width. Where Cc takes more than
// one pass (kMulti), P sums over the passes and h is recomputed per output
// chunk.
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

struct Args {
  HArgs h;
  const bf16* b1;      // (n*2C)
  bf16* out;           // (B, T, n*2C)
  const bf16* img_h;   // cond_0's weights as h's B (cond_chain_bf16.cuh), per batch row
  int two_c, noc;
  W0Geo geo;
  CUtensorMap w1;      // w1t (n, 3, 2C, Cc8) as (c: Cc8, o: 2C, j: 3, i: n), box (64, W, 1, 1)
};

// W: output columns per chunk (64 or 32); N = 3W columns of P
template <int W>
struct Geo {
  static constexpr int kN = 3 * W;
  static constexpr int kStageBytes = 3 * W * 128;
  static constexpr int kStages = W == 64 ? 3 : 4;
  static constexpr int kLdp = kN + 8;  // floats per row of P in shared memory
  static constexpr size_t kPBytes = (size_t)kRows * kLdp * 4;
  // the ring, the weights ring, per warpgroup P, the barriers; +1024 to align the base
  static constexpr size_t kSmem =
      (size_t)kStages * kStageBytes + 2 * kWSlot + 2 * kPBytes + 16 * (kStages + 2) + 1024;
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

// kMulti: Cc takes more than one pass of 136 columns, so that P sums over
// passes and h is recomputed per output chunk
template <int W, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1) k1_bf16_kernel(const __grid_constant__ Args a) {
  using G = Geo<W>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* wslots = ring + G::kStages * G::kStageBytes;
  float* pbuf = reinterpret_cast<float*>(wslots + 2 * kWSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<unsigned char*>(pbuf) +
                                               2 * G::kPBytes);
  uint64_t* empty = full + G::kStages;
  uint64_t* wfull = empty + G::kStages;
  uint64_t* wempty = wfull + 2;

  const HArgs& h = a.h;
  const W0Geo& geo = a.geo;
  const int npass = kMulti ? geo.npass : 1;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int warp = threadIdx.x >> 5;
  const Ring rg{G::kStages};

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&wfull[s], 1);
      mbar_init(&wempty[s], 8);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: per block i and output chunk oc, per pass p: h's weights
    // (where the consumers recompute h), then the 3 atoms (64 columns of the
    // pass's K each) of W1's three taps
    if (threadIdx.x == 256) {
      prefetch_map(&a.w1);
      const unsigned char* img_h = reinterpret_cast<const unsigned char*>(a.img_h) +
                                   (h.hbias_bstride ? (size_t)b * geo.h_image : 0);
      const WRing pw{wslots, wfull, wempty, 0};
      int k = 0, wk = 0;
      for (int i = 0; i < h.n; ++i)
        for (int oc = 0; oc < a.noc; ++oc)
          for (int p = 0; p < npass; ++p) {
            if (kMulti || oc == 0) {
              for (int kc = 0; kc < geo.nkc; ++kc) {
                const size_t ch = ((size_t)i * geo.npass + p) * geo.nkc + kc;
                wring_put(pw, wk, img_h + ch * geo.h_chunk, (uint32_t)geo.h_chunk);
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
  const Lane l;
  float* ps = pbuf + (size_t)wg * kRows * G::kLdp;
  const int n2 = h.n * a.two_c;
  const XFrags xf(h, geo, b, u0);
  WRing wr{wslots, wfull, wempty, 0};

  uint32_t afr[kPassSlices][4];
  float pacc[G::kN / 2];
  int k = 0;
  for (int i = 0; i < h.n; ++i) {
    for (int oc = 0; oc < a.noc; ++oc) {
      for (int p = 0; p < npass; ++p) {
        if (kMulti || oc == 0) {
          float acc[68];
          act_pass(h, acc, wr, geo, xf, b, u0, p * kPass);
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
      }
      fence_regs(pacc);

      // out[t] = b1 + P_0[q = r] + P_1[r + 1] + P_2[r + 2] for own row r (t = tb + r)
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
      // a thread keeps its column pair o (128 is a multiple of W / 2)
      const int o = 2 * (l.wt % (W / 2));
      const int col = i * a.two_c + oc * W + o;
      if (oc * W + o < a.two_c) {
        const float bb0 = f32(a.b1[col]);
        const float bb1 = f32(a.b1[col + 1]);
        for (int r = l.wt / (W / 2); r < kOwn && tb + r < h.T; r += 128 / (W / 2)) {
          const float* pr = ps + r * G::kLdp + o;
          const float2 p0 = *reinterpret_cast<const float2*>(pr);
          const float2 p1 = *reinterpret_cast<const float2*>(pr + G::kLdp + W);
          const float2 p2 = *reinterpret_cast<const float2*>(pr + 2 * G::kLdp + 2 * W);
          store2(a.out + ((size_t)b * h.T + tb + r) * n2 + col, bb0 + p0.x + p1.x + p2.x,
                 bb1 + p0.y + p1.y + p2.y);
        }
      }
    }
  }
}

struct FwdPlan {
  int w, noc, ntiles;
  W0Geo geo;
  size_t smem, off_w1t, total;  // workspace: img_h, then w1t
};

FwdPlan fwd_plan(int B, int T, int E, int n, int cc, int two_c) {
  FwdPlan p{};
  p.w = two_c <= 32 ? 32 : 64;
  p.noc = (two_c + p.w - 1) / p.w;
  p.ntiles = (T + kTile - 1) / kTile;
  p.geo = w0_geo(E, n, cc);
  p.smem = p.w == 64 ? Geo<64>::kSmem : Geo<32>::kSmem;
  p.off_w1t = ((size_t)B * p.geo.h_image + 255) / 256 * 256;
  p.total = p.off_w1t + (size_t)n * 3 * two_c * ((cc + 7) / 8 * 8) * 2;
  return p;
}

template <int W, bool kMulti>
int launch(const Args& a, int B, const FwdPlan& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k1_bf16_kernel<W, kMulti>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  k1_bf16_kernel<W, kMulti>
      <<<dim3((unsigned)p.ntiles, (unsigned)B), kThreads, p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

bool shapes_ok(int B, int T, int E, int n, int cc, int two_c) {
  return B > 0 && B <= 65535 && T > 0 && E > 0 && n > 0 && cc > 0 && two_c > 0 && cc % 4 == 0 &&
         two_c % 4 == 0;
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
// the kernel does not take (2C or Cc not a multiple of 4), too little
// workspace, or a tensor map cuTensorMapEncodeTiled refuses give an error code. Every
// pointer but ws is to bf16, w1 in its own (3, Cc, n*2C) layout.
extern "C" int cond_chain_fwd_bf16(const void* exc, const void* w0, const void* hbias,
                                   long long hbias_bstride, const void* edge0,
                                   const void* edge_t, const void* w1, const void* b1,
                                   void* out, void* ws, long long ws_bytes, int B, int T, int E,
                                   int n, int cc, int two_c, void* stream) {
  if (!shapes_ok(B, T, E, n, cc, two_c)) return (int)cudaErrorInvalidValue;
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
  a.noc = p.noc;
  a.geo = p.geo;
  bf16* w1t = reinterpret_cast<bf16*>(wsb + p.off_w1t);
  const cuuint64_t cc8 = (cuuint64_t)(cc + 7) / 8 * 8;
  const cuuint64_t dims[4] = {cc8, (cuuint64_t)two_c, 3, (cuuint64_t)n};
  const cuuint64_t strides[3] = {cc8 * 2, cc8 * 2 * two_c, cc8 * 2 * two_c * 3};
  const cuuint32_t box[4] = {64, (cuuint32_t)p.w, 1, 1};
  if (!make_map(&a.w1, w1t, 4, dims, strides, box)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ImageArgs im{a.h, static_cast<const bf16*>(w1), reinterpret_cast<bf16*>(wsb), nullptr, w1t,
               hbias_bstride ? B : 1, two_c};
  cudaError_t e = launch_images(im, st);
  if (e != cudaSuccess) return (int)e;
  const bool multi = p.geo.npass > 1;
  if (p.w == 64) return multi ? launch<64, true>(a, B, p, st) : launch<64, false>(a, B, p, st);
  return multi ? launch<32, true>(a, B, p, st) : launch<32, false>(a, B, p, st);
}

// The rows of the time tile cond_chain_fwd_bf16 takes at these widths (124:
// every width goes in passes of 136 columns), or 0 for widths it does not
// take (Cc or 2C not a multiple of 4).
extern "C" int cond_chain_fwd_bf16_tile(int E, int cc, int two_c) {
  return shapes_ok(1, 1, E, 1, cc, two_c) ? kTile : 0;
}
