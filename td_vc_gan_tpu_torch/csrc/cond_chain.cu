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
// 64 rows of h each, 124 rows a CTA, and a producer warp whose one thread
// keeps bulk copies in flight through a ring of 3 stages of images of the
// weights that a small kernel (k1_images_kernel) lays out at each launch in
// the workspace, in the shared-memory layout the products read, split into
// hi and lo once there (no thread splits a weight): h's B (the header's
// img_h) and P's B, img_w1[i][oc][17 p + s]: for output chunk oc of W
// columns and the pass's k-slice s, W1_i[j] for the three taps as W rows x
// 8 k, hi and lo of each. Per block i (and, where Cc takes more than one
// pass, per pass):
//  1. h on wgmma (the header's h_pass; X's slices kept in registers for
//     every block where K = 3E + 3 <= 32, the decoder's E = 8); lrelu in
//     f32, zero outside [0, T) and past Cc, split, into the warpgroup's A
//     image in shared memory (no swizzle: each 4-column chunk holds the 64
//     rows 16 bytes apart);
//  2. out = b1 + sum_j A(rows shifted by j) @ W1_i[j] on wgmma with both
//     operands in shared memory: M = 64, N = W (128, 64 or 32 output
//     columns), K = the pass's columns in slices of 8; tap j's A is the same
//     descriptor 16 j bytes further on (the image one or two rows down), so
//     the three taps sum in one accumulator and no epilogue shifts rows;
//     one wgmma group in flight while the next stage is waited for;
//  3. the accumulators, plus b1, to the output rows the warpgroup owns.
// A CTA owns one output chunk (grid z), so that the chunks run in parallel
// and each CTA computes h for its own: at 2C <= 128 (one chunk) h is
// computed once a tile; at 2C = 256 once per chunk, with twice the CTAs in
// flight. Shared memory does not grow with Cc or E: one tile for every
// width. Where Cc takes more than one pass (kMulti), P sums over the
// passes, and W <= 64 keeps P's and h's accumulators within the registers
// of a 9-warp CTA (168 a thread).
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
constexpr int kSlot = 3 * 2 * 128 * 32;     // 24576: the largest ring item
constexpr size_t kSmem = (size_t)kStages * kSlot + 2 * (size_t)kABytes + 16 * kStages + 1024;
static_assert(kSmem <= kSmemMax, "K1's shared memory");

struct Args {
  HArgs h;
  const float* b1;              // (n*2C)
  float* out;                   // (B, T, n*2C)
  const unsigned char* img_h;   // h's B (cond_chain_f32.cuh)
  const unsigned char* img_w1;  // P's B (above)
  long long h_image;            // bytes of one batch row's img_h (0: one for every row)
  int two_c, noc;               // output columns, chunks of W of them
};

template <int W>
__device__ __forceinline__ void wgmma_p(float (&d)[W / 2], uint64_t da, uint64_t db) {
  if constexpr (W == 128) {
    tf32x3::wgmma_ss_n128(d, da, db, 1);
  } else if constexpr (W == 64) {
    tf32x3::wgmma_ss_n64(d, da, db, 1);
  } else {
    tf32x3::wgmma_ss_n32(d, da, db, 1);
  }
}

// W: output columns a chunk (the N of P); kMulti: Cc takes more than one pass
template <int W, bool kMulti>
__global__ void __launch_bounds__(kThreads, 1) k1_f32_kernel(const __grid_constant__ Args a) {
  constexpr int kWItem = 6 * W * 32;  // a k-slice of W1's three taps, hi and lo
  static_assert(kWItem <= kSlot && 2 * kHItem <= kSlot, "ring items fit a slot");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* ring = smem;
  unsigned char* aimg = ring + kStages * kSlot;
  uint64_t* full = reinterpret_cast<uint64_t*>(aimg + 2 * kABytes);
  uint64_t* empty = full + kStages;

  const HArgs& h = a.h;
  const int npass = kMulti ? h.npass : 1;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int oc = blockIdx.z;  // the CTA's chunk of W output columns
  const int warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 8) {
    // the producer: per block i and pass p, h's k-slices, then the pass's
    // k-slices of W1 for the CTA's output chunk
    if (threadIdx.x == 256) {
      const unsigned char* img_h = a.img_h + (size_t)b * a.h_image;
      int k = 0;
      for (int i = 0; i < h.n; ++i)
        for (int p = 0; p < npass; ++p) {
          for (int s = 0; s < h.nkh; ++s) {
            put<kStages, kSlot>(ring, full, empty, k,
                                img_h + (((size_t)i * h.npass + p) * h.nkh + s) * 2 * kHItem,
                                2 * kHItem);
          }
          const int ns = pass_slices(h, p);
          for (int s = 0; s < ns; ++s) {
            const size_t item =
                ((size_t)i * a.noc + oc) * h.npass * kPassSlices + p * kPassSlices + s;
            put<kStages, kSlot>(ring, full, empty, k, a.img_w1 + item * kWItem, kWItem);
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
  unsigned char* a_gen = aimg + wg * kABytes;
  const uint32_t a_hi = smem_u32(a_gen);
  const int n2 = h.n * a.two_c;

  // X's slices for every block where K <= 32 (not in the multi-pass
  // instances, whose accumulators take those registers)
  const bool hoisted = !kMulti && h.nkh <= 4;
  XFrag xf[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if (hoisted && s < h.nkh) {
      xf[s] = x_frag(h, b, u0, l, s);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) xf[s].hi[r] = xf[s].lo[r] = 0u;
    }
  }

  float pacc[W / 2];
  int k = 0;
  for (int i = 0; i < h.n; ++i) {
    for (int p = 0; p < npass; ++p) {
      // 1. h_i's pass p
      float hacc[68];
      h_pass<kStages, kSlot>(h, hacc, ring, full, empty, k, xf, hoisted, b, u0, l);
      // every warp of the warpgroup is past its products on the A image
      bar_sync(bar, 128);
      // lrelu(h), zero outside [0, T) and past Cc, split, into A:
      // element (q, c) at (c / 4) kAChunk + 16 q + 4 (c % 4)
#pragma unroll
      for (int nt = 0; nt < kPass / 8; ++nt) {
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
      fence_proxy_async();
      bar_sync(bar, 128);
      // 2. P += A_j @ W1_i[j] over the pass's k-slices and the three taps
      if (p == 0) zero(pacc);
      const int ns = pass_slices(h, p);
      int prev = -1;
      for (int s = 0; s < ns; ++s) {
        const int slot = slot_of<kStages>(k);
        mbar_wait(&full[slot], parity_of<kStages>(k));
        const uint32_t base = smem_u32(ring + slot * kSlot);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const uint32_t ah = a_hi + 2 * kAChunk * s + 16 * j;
          const uint32_t bh = base + 2 * j * W * 32;
          wgmma_p<W>(pacc, desc(ah + kAImage, kAChunk, 128), desc(bh, 128, 256));
          wgmma_p<W>(pacc, desc(ah, kAChunk, 128), desc(bh + W * 32, 128, 256));
          wgmma_p<W>(pacc, desc(ah, kAChunk, 128), desc(bh, 128, 256));
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0) release(&empty[prev]);
        prev = slot;
        ++k;
      }
      wgmma_wait<0>();
      if (prev >= 0) release(&empty[prev]);
      fence_regs(pacc);
    }
    // 3. out[t] = b1 + P[r] for own row r (t = tb + r)
#pragma unroll
    for (int nt = 0; nt < W / 8; ++nt) {
      const int col = oc * W + nt * 8 + 2 * l.tig;
      if (col >= a.two_c) continue;
      const float bb0 = __ldg(a.b1 + i * a.two_c + col);
      const float bb1 = __ldg(a.b1 + i * a.two_c + col + 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = l.row + 8 * half;
        const int t = tb + r;
        if (r < kOwn && t < h.T) {
          *reinterpret_cast<float2*>(a.out + ((size_t)b * h.T + t) * n2 + i * a.two_c + col) =
              make_float2(pacc[nt * 4 + 2 * half] + bb0, pacc[nt * 4 + 2 * half + 1] + bb1);
        }
      }
    }
  }
}

// -- the images of the weights

struct ImageArgs {
  WhArgs wh;
  const float* w1;      // (3, Cc, n*2C)
  unsigned char* img_h;
  unsigned char* img_w1;
  int nimg, two_c, noc, w;
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
    const int jh = r / wunits;
    r -= jh * wunits;
    int ol, k0;
    unit_place(r, ol, k0);
    const int o = (int)((item / (npass * kPassSlices)) % a.noc) * a.w + ol;
    const int ps = (int)(item % (npass * kPassSlices));
    const int c0 = kPass * (ps / kPassSlices) + 8 * (ps % kPassSlices) + k0;
    const int i = (int)(item / ((long long)npass * kPassSlices * a.noc));
    const int j = jh >> 1;
    const int n2 = wh.n * a.two_c;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = c0 + e;
      v[e] = c < wh.cc && o < a.two_c ? a.w1[((size_t)j * wh.cc + c) * n2 + i * a.two_c + o]
                                      : 0.f;
    }
    put_unit(a.img_w1 + u2 * 16, v, jh & 1);
  }
}

struct FwdPlan {
  int w, noc, ntiles, nimg;
  size_t h_image, off_w1, total;  // workspace bytes: img_h, then img_w1
};

FwdPlan fwd_plan(int B, int T, int E, int n, int cc, int two_c, bool per_row) {
  FwdPlan p{};
  const int npass = passes(cc);
  p.w = two_c <= 32 ? 32 : two_c <= 64 || npass > 1 ? 64 : 128;
  p.noc = (two_c + p.w - 1) / p.w;
  p.ntiles = (T + kTile - 1) / kTile;
  p.nimg = per_row ? B : 1;
  p.h_image = h_image_bytes(n, cc, E);
  p.off_w1 = ((size_t)p.nimg * p.h_image + 255) / 256 * 256;
  p.total = p.off_w1 + (size_t)n * p.noc * npass * kPassSlices * 6 * p.w * 32;
  return p;
}

template <int W, bool kMulti>
int launch(const Args& a, int B, const FwdPlan& p, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(k1_f32_kernel<W, kMulti>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  k1_f32_kernel<W, kMulti>
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
                     wsb + p.off_w1, p.nimg, two_c, p.noc, p.w};
  cudaStream_t st = (cudaStream_t)stream;
  k1_images_kernel<<<264, 256, 0, st>>>(im);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (passes(cc) > 1) {
    return p.w == 64 ? launch<64, true>(a, B, p, st) : launch<32, true>(a, B, p, st);
  }
  if (p.w == 128) return launch<128, false>(a, B, p, st);
  return p.w == 64 ? launch<64, false>(a, B, p, st) : launch<32, false>(a, B, p, st);
}
