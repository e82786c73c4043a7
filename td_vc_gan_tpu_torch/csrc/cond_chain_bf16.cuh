// The bf16 instances of the FiLM cond-chain kernels (cond_chain_bf16.cu,
// K1-bf16; cond_chain_bwd_bf16.cu, K2-bf16): what both share. Their CTAs
// have the same shape, and both recompute cond_0's activation,
//
//   h[t] = sum_j exc[t+j-1] @ W0[j] + hbias - [t==0] edge0 - [t==T-1] edge_t
//
// with exc zero outside [0, T), every operand bf16 and h summed in f32, on
// wgmma (hopper_bf16.cuh).
//
// The CTA. Two consumer warpgroups and a producer warp. Consumer
// warpgroup w holds 64 rows of h (wgmma's M) for the time rows
// u0 + q, q < 64, u0 = t0 + 62 w - 1: its 62 own rows and a halo row each
// side, which the k=3 conv of the next product needs. The CTA owns the
// 124 rows [t0, t0 + 124); the two warpgroups overlap by two rows of h, so
// that each reads only its own rows when it shifts them and neither waits
// for the other but through the ring of stages they share. The producer is
// one warp, one of whose threads keeps the TMA copies of the ring in
// flight: with 288 threads a CTA a thread may hold 224 registers, which the
// consumers need (h and da: 136 accumulators). (With a producer warpgroup
// and setmaxnreg, 384 threads, ptxas allocated the kernels at 168
// registers a thread and spilled 920 bytes a thread in K2-bf16's data
// kernel: setmaxnreg moves registers at run time, but the compiler did not
// allocate the consumers' code beyond the launch's share.)
//
// Columns of h go in passes of 136 (one m64n136 accumulator: 68 registers a
// thread; Cc = 136 at the decoder's widths is one pass); the pass's K for
// the next product is 144, 9 k-slices of 16, the last 8 columns zero.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "hopper_bf16.cuh"

namespace bf16chain {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr float kSlope = 0.2f;    // leaky_relu's negative slope
constexpr int kRows = 64;         // rows of h per consumer warpgroup
constexpr int kOwn = kRows - 2;   // of which its own
constexpr int kTile = 2 * kOwn;   // rows a CTA owns
constexpr int kPass = 136;        // columns of h per pass
constexpr int kPassSlices = 9;    // the pass as K: 144 = 9 x 16
constexpr int kThreads = 288;     // two consumer warpgroups, one producer warp
constexpr size_t kSmemMax = 227 * 1024;

// -- bf16 helpers

__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
// x rounded to bf16, nearest even, and back to f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
// two f32 rounded to bf16, nearest even, as one register (lo in the low half)
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ uint32_t bits(bf16 x) {
  return (uint32_t)__bfloat16_as_ushort(x);
}

struct HArgs {
  const bf16* exc;     // (B, T, E)
  const bf16* w0;      // (3, E, n*Cc)
  const bf16* hbias;   // (B, n*Cc), or (n*Cc) with hbias_bstride = 0
  long long hbias_bstride;
  const bf16* edge0;   // (B, n*Cc) or null
  const bf16* edge_t;  // (B, n*Cc) or null
  int T, E, n, cc;
};

// The warpgroup's thread index and its place in the accumulator layout
struct Lane {
  int wt;    // 0 .. 127
  int row;   // its first row of h (q), the second is row + 8
  int tig;   // its columns are 8k + 2 tig, + 1
  __device__ __forceinline__ Lane() {
    wt = threadIdx.x & 127;
    const int lane = wt & 31;
    row = (wt >> 5) * 16 + (lane >> 2);
    tig = lane & 3;
  }
};

// cond_0 as one product: h = X @ Wh with, per row u of h and block i,
//   X[u] = [exc[u-1] | exc[u] | exc[u+1] | 1 | -[u == 0] | -[u == T-1]]   (K = 3E + 3)
//   Wh   = [W0_i[0]; W0_i[1]; W0_i[2]; hbias_i[b]; edge0_i[b]; edge_t_i[b]]
// (exc zero outside [0, T); zero edge rows without edges): the bias and the
// edge corrections are three more k of the wgmma's f32 sum, exact products
// of bf16 values as the rest.
//
// The B images of the weights for one call, made once per launch by
// w_images_kernel in the shared-memory layouts the products read, so that
// the producer brings each with one bulk copy (K-major, no swizzle):
//  - h's B, img_h[b][i][p][kc] (one image per batch row when hbias is, else
//    one): the 136 columns c = 136 p + nn of block i's pass p as rows, the
//    kc-th chunk of K = 3E + 3 (rounded up to 16; chunks of 64 above 64) as
//    columns: element (nn, kk) at (nn / 8) KC 16 + (kk / 8) 128 + (nn % 8) 16
//    + (kk % 8) 2 bytes;
//  - dexc's B, img_x[i][p][ec]: for each tap j (2304 bytes apart), the 8
//    rows e = 8 ec + el and the pass's 144 columns as K: element (el, cl) at
//    j 2304 + (cl / 8) 128 + el 16 + (cl % 8) 2;
// zeros beyond Cc, K, E and the pass's 136 columns.
struct W0Geo {
  int npass, kc, nkc, nec;
  size_t h_chunk, h_image, x_bytes;  // bytes: one h chunk, one batch row's img_h, img_x
};

constexpr int kXChunk = 3 * 2 * kPassSlices * 8 * 8 * 2;  // 6912: one img_x chunk
constexpr int kWSlot = kPass * 64 * 2;  // 17408: a slot of the weights ring holds any chunk

__host__ __device__ inline W0Geo w0_geo(int E, int n, int cc) {
  W0Geo g;
  g.npass = (cc + kPass - 1) / kPass;
  const int k16 = (3 * E + 3 + 15) / 16 * 16;
  g.kc = k16 < 64 ? k16 : 64;
  g.nkc = (k16 + g.kc - 1) / g.kc;
  g.nec = (E + 7) / 8;
  g.h_chunk = (size_t)kPass * g.kc * 2;
  g.h_image = (size_t)n * g.npass * g.nkc * g.h_chunk;
  g.x_bytes = (size_t)n * g.npass * g.nec * kXChunk;
  return g;
}

struct ImageArgs {
  HArgs h;
  const bf16* w1;  // (3, Cc, n*2C), for w1t
  bf16* img_h;     // nimg images
  bf16* img_x;     // or null
  bf16* w1t;       // (n, 3, 2C, Cc8), or null
  int nimg, two_c;
};

// Wh[k][c] of batch row b (c < Cc, k < 3E + 3: see above)
__device__ __forceinline__ uint32_t wh_at(const HArgs& h, int b, int i, int c, int k) {
  const int n0 = h.n * h.cc;
  const size_t col = (size_t)i * h.cc + c;
  if (k < 3 * h.E) {
    const int j = k / h.E;
    return bits(h.w0[((size_t)j * h.E + (k - j * h.E)) * n0 + col]);
  }
  if (k == 3 * h.E) return bits(h.hbias[(size_t)b * h.hbias_bstride + col]);
  const bf16* edge = k == 3 * h.E + 1 ? h.edge0 : h.edge_t;
  return edge ? bits(edge[(size_t)b * n0 + col]) : 0u;
}

// img_h, img_x (when given) and w1t = W1 transposed, (n, 3, 2C, Cc8) with
// Cc8 = Cc rounded up to 8 and zeros beyond Cc (when given), 8 elements (16
// bytes) a thread
__global__ void w_images_kernel(ImageArgs a) {
  const HArgs& h = a.h;
  const W0Geo g = w0_geo(h.E, h.n, h.cc);
  const int n0 = h.n * h.cc;
  const long long uh = (long long)a.nimg * (long long)(g.h_image / 16);
  const long long ux = a.img_x ? (long long)(g.x_bytes / 16) : 0;
  const int cc8 = (h.cc + 7) / 8 * 8;
  const long long uw = a.w1t ? (long long)h.n * 3 * a.two_c * (cc8 / 8) : 0;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < uh + ux + uw;
       u += (long long)gridDim.x * blockDim.x) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (u < uh) {
      const long long per = (long long)kPass * g.kc / 8;  // units a chunk
      const long long ch = u / per;
      const int r = (int)(u - ch * per);
      const int kgs = g.kc / 8;
      const int nn = r / (kgs * 8) * 8 + r % 8;
      const int kk0 = (r % (kgs * 8)) / 8 * 8;
      const int kci = (int)(ch % g.nkc);
      const int p = (int)((ch / g.nkc) % g.npass);
      const int i = (int)((ch / ((long long)g.nkc * g.npass)) % h.n);
      const int b = (int)(ch / ((long long)g.nkc * g.npass * h.n));
      const int c = p * kPass + nn;
      for (int v = 0; v < 8; ++v) {
        const int k = kci * g.kc + kk0 + v;
        if (c < h.cc && k < 3 * h.E + 3) w[v / 2] |= wh_at(h, b, i, c, k) << (16 * (v & 1));
      }
      reinterpret_cast<uint4*>(a.img_h)[u] = make_uint4(w[0], w[1], w[2], w[3]);
    } else if (u < uh + ux) {
      const long long ux0 = u - uh;
      const long long ch = ux0 / (kXChunk / 16);
      const int r = (int)(ux0 - ch * (kXChunk / 16));
      const int j = r / (2 * kPassSlices * 8);
      const int cg = (r / 8) % (2 * kPassSlices);
      const int e = (int)(ch % g.nec) * 8 + r % 8;
      const int p = (int)((ch / g.nec) % g.npass);
      const int i = (int)(ch / ((long long)g.nec * g.npass));
      for (int v = 0; v < 8; ++v) {
        const int cl = cg * 8 + v;
        const int c = p * kPass + cl;
        if (cl < kPass && c < h.cc && e < h.E) {
          w[v / 2] |= bits(h.w0[((size_t)j * h.E + e) * n0 + (size_t)i * h.cc + c])
                      << (16 * (v & 1));
        }
      }
      reinterpret_cast<uint4*>(a.img_x)[ux0] = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      // w1t[i][j][o][c0 .. c0 + 8) = W1[j][c][i 2C + o]
      const long long uw0 = u - uh - ux;
      const int c0 = (int)(uw0 % (cc8 / 8)) * 8;
      const long long row = uw0 / (cc8 / 8);  // (i, j, o)
      const int o = (int)(row % a.two_c);
      const int j = (int)((row / a.two_c) % 3);
      const int i = (int)(row / (3LL * a.two_c));
      const int n2 = h.n * a.two_c;
      for (int v = 0; v < 8; ++v) {
        const int c = c0 + v;
        if (c < h.cc) {
          w[v / 2] |= bits(a.w1[((size_t)j * h.cc + c) * n2 + (size_t)i * a.two_c + o])
                      << (16 * (v & 1));
        }
      }
      reinterpret_cast<uint4*>(a.w1t)[uw0] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

inline cudaError_t launch_images(const ImageArgs& a, cudaStream_t stream) {
  w_images_kernel<<<264, 256, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) d[r] = 0.f;
}

// The ring's stage k: its slot and the parity of the phase to wait for
struct Ring {
  int stages;
  __device__ __forceinline__ int slot(int k) const { return k % stages; }
  __device__ __forceinline__ uint32_t parity(int k) const { return (uint32_t)((k / stages) & 1); }
};

// A consumer warp's release of a stage once its products have read it
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

}  // namespace bf16chain
