// The bf16 instances of the FiLM cond-chain kernels (cond_chain_bf16.cu,
// K1-bf16; cond_chain_bwd_bf16.cu, K2-bf16): bf16 products on Hopper's tensor
// cores with f32 accumulators, and cond_0's recompute, which both share:
//
//   h[t] = sum_j exc[t+j-1] @ W0[j] + hbias - [t==0] edge0 - [t==T-1] edge_t
//
// with exc zero outside [0, T), every operand bf16 and h summed in f32.
//
// The tile. mma.sync.aligned.m16n8k16 with bf16 inputs and f32 accumulators,
// one warp, lane = 4 * grp + tig (grp = lane / 4, tig = lane % 4); each
// 32-bit register holds two bf16 of consecutive k, the lower k in the low
// half (so a 4-byte load of two neighbours in memory is a register):
//   A (16 x 16, row-major): a0 = A[grp][2tig, 2tig+1],     a1 = A[grp+8][2tig, 2tig+1],
//                           a2 = A[grp][2tig+8, 2tig+9],   a3 = A[grp+8][2tig+8, 2tig+9]
//   B (16 x 8, k-major):    b0 = B[2tig, 2tig+1][grp],     b1 = B[2tig+8, 2tig+9][grp]
//   D (16 x 8, f32):        d0 = D[grp][2tig], d1 = D[grp][2tig+1],
//                           d2 = D[grp+8][2tig], d3 = D[grp+8][2tig+1]
// One such product does the work of the f32 instances' three 3xTF32 ones at
// twice the depth (k = 16), and bf16's 8 significant bits are exact in the
// product, so the sums differ from an f32 sum of the same bf16 values only
// by their order.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace bf16mma {

using bf16 = __nv_bfloat16;

constexpr float kSlope = 0.2f;  // leaky_relu's negative slope

// -- primitives

// d += a * b on one m16n8k16 bf16 tile
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two neighbouring bf16 as one register (p 4-byte aligned), through L1 for global memory
__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ldg2(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
// one bf16's bits from global memory, 0 when !ok (nothing is read)
__device__ __forceinline__ uint32_t ldg1(const bf16* p, bool ok) {
  return ok ? (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) : 0u;
}
__device__ __forceinline__ uint32_t pack(uint32_t lo, uint32_t hi) { return lo | (hi << 16); }
// two f32 rounded to bf16, nearest even, as one register
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// x rounded to bf16, nearest even, and back to f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

struct FragA {
  uint32_t r[4];
};

// A fragment from p = &A[grp][2tig] in bf16 memory, rows ld apart (ld even)
__device__ __forceinline__ FragA load_a(const bf16* p, int ld) {
  FragA f;
  f.r[0] = ld2(p);
  f.r[1] = ld2(p + 8 * ld);
  f.r[2] = ld2(p + 8);
  f.r[3] = ld2(p + 8 * ld + 8);
  return f;
}

// A fragment from p = &A[grp][2tig] in f32 memory holding bf16 values (ld even)
__device__ __forceinline__ FragA load_a_f32(const float* p, int ld) {
  FragA f;
  const int off[4] = {0, 8 * ld, 8, 8 * ld + 8};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float2 x = *reinterpret_cast<const float2*>(p + off[v]);
    f.r[v] = pack_rn(x.x, x.y);
  }
  return f;
}

// -- end primitives

// bf16 row strides of a shared-memory array read as A fragments (4-byte
// loads of (row grp, word tig)): a stride of 4 mod 8 words puts a warp's 32
// loads in 32 banks
__host__ __device__ constexpr int a_stride(int cols) {
  return 2 * ((cols / 2 + 7) / 8 * 8 + 4);
}

struct HArgs {
  const bf16* exc;     // (B, T, E)
  const bf16* w0;      // (3, E, n*Cc)
  const bf16* hbias;   // (B, n*Cc), or (n*Cc) with hbias_bstride = 0
  long long hbias_bstride;
  const bf16* edge0;   // (B, n*Cc) or null
  const bf16* edge_t;  // (B, n*Cc) or null
  int T, E, n, cc;
  int e_pad, cc_pad;   // E and Cc rounded up to 16
};

// xs[r][e] = exc[t0 - 2 + r][e] for r < rows, zero outside [0, T) and for
// e >= E (up to the row stride ldx)
__device__ __forceinline__ void stage_exc(const HArgs& h, bf16* xs, int ldx, int rows, int b,
                                          int t0) {
  const bf16* exc_b = h.exc + (size_t)b * h.T * h.E;
  for (int idx = threadIdx.x; idx < rows * ldx; idx += blockDim.x) {
    const int r = idx / ldx;
    const int e = idx - r * ldx;
    const int t = t0 - 2 + r;
    xs[idx] = (t >= 0 && t < h.T && e < h.E) ? exc_b[(size_t)t * h.E + e]
                                             : __ushort_as_bfloat16((unsigned short)0);
  }
}

// act[q][c] = lrelu(h_i)[t0 - 1 + q] for q < rows and c < Cc_pad, zero
// outside [0, T) and for c >= Cc; block i's Cc columns of h, summed in f32.
// kF32: act is f32 (the exact lrelu(h), for K2), else bf16 (rounded once,
// K1's operand of the second product). An M = 16*MTH, N = Cc_pad, K = 3*E_pad
// product: A from the staged exc rows (xs row q + j for tap j, so xs holds
// 16*MTH + 2 rows), B = W0_i read through L1 as pairs of bf16 (k = e runs
// down W0's rows). Warp w owns the n-tiles w, w + 8, ...; for each it holds
// all MTH m-tiles' accumulators and walks K once. Needs 8 warps.
template <int MTH, bool kF32>
__device__ __forceinline__ void recompute_act(const HArgs& h, const bf16* xs, int ldx,
                                              void* act, int lda, int rows, int b, int t0,
                                              int i) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int n0 = h.n * h.cc;
  const int ntiles = h.cc_pad / 8;
  const int ks_tap = h.e_pad / 16;
  for (int nt = warp; nt < ntiles; nt += 8) {
    const int c = nt * 8 + grp;  // this lane's B column
    const bool cok = c < h.cc;
    float acc[MTH][4];
#pragma unroll
    for (int mt = 0; mt < MTH; ++mt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][v] = 0.f;
    for (int j = 0; j < 3; ++j) {
      const bf16* wj = h.w0 + (size_t)j * h.E * n0 + (size_t)i * h.cc + c;
      for (int ks = 0; ks < ks_tap; ++ks) {
        const int e = ks * 16 + 2 * tig;
        uint32_t bb[2];
        bb[0] = pack(ldg1(wj + (size_t)e * n0, cok && e < h.E),
                     ldg1(wj + (size_t)(e + 1) * n0, cok && e + 1 < h.E));
        bb[1] = pack(ldg1(wj + (size_t)(e + 8) * n0, cok && e + 8 < h.E),
                     ldg1(wj + (size_t)(e + 9) * n0, cok && e + 9 < h.E));
#pragma unroll
        for (int mt = 0; mt < MTH; ++mt) {
          const FragA fa = load_a(xs + (mt * 16 + grp + j) * ldx + ks * 16 + 2 * tig, ldx);
          mma(acc[mt], fa.r, bb);
        }
      }
    }
    const int col = nt * 8 + 2 * tig;
    float hb[2], ed0[2], edt[2];
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      const bool ok = col + v < h.cc;
      const size_t gcol = (size_t)i * h.cc + col + v;
      hb[v] = ok ? f32(h.hbias[(size_t)b * h.hbias_bstride + gcol]) : 0.f;
      ed0[v] = ok && h.edge0 ? f32(h.edge0[(size_t)b * n0 + gcol]) : 0.f;
      edt[v] = ok && h.edge_t ? f32(h.edge_t[(size_t)b * n0 + gcol]) : 0.f;
    }
#pragma unroll
    for (int mt = 0; mt < MTH; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int q = mt * 16 + grp + 8 * half;
        if (q >= rows) continue;
        const int t = t0 - 1 + q;
        float x[2];
#pragma unroll
        for (int v = 0; v < 2; ++v) {
          x[v] = acc[mt][2 * half + v];
          if (t >= 0 && t < h.T && col + v < h.cc) {
            x[v] += hb[v];
            if (t == 0) x[v] -= ed0[v];
            if (t == h.T - 1) x[v] -= edt[v];
            x[v] = x[v] >= 0.f ? x[v] : kSlope * x[v];
          } else {
            x[v] = 0.f;
          }
        }
        if (kF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(act) + q * lda + col) =
              make_float2(x[0], x[1]);
        } else {
          store2(static_cast<bf16*>(act) + q * lda + col, x[0], x[1]);
        }
      }
    }
  }
}

}  // namespace bf16mma
