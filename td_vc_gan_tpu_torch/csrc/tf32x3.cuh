// f32-accurate matrix products on Hopper's tensor cores: the 3xTF32 split,
// the warp-level mma.sync tile and cp.async, shared by the FiLM cond-chain
// kernels (cond_chain.cu, K1; cond_chain_bwd.cu, K2).
//
// The split. Every f32 operand x is cut into x = hi + lo with hi = tf32(x)
// and lo = tf32(x - hi), both rounded to nearest with ties away from zero,
// as cvt.rna.tf32.f32 rounds (10 explicit mantissa bits); to_tf32 does it
// with two integer operations on the bits (half an ulp added to the
// magnitude, the 13 low bits cleared), which give cvt.rna's result for every
// finite input and cost less than the cvt on this card. A product is then taken as
// a.b ~ a.lo*b.hi + a.hi*b.lo + a.hi*b.hi, three TF32 tensor-core products
// into the same f32 accumulators (the small terms first); the dropped
// a.lo*b.lo is below 2^-22 of |a.b|. So the sums keep about f32 accuracy at
// a third of the card's TF32 rate (494.7 / 3 = 165 TFLOP/s dense), 2.5x its
// f32 CUDA-core peak. An operand with at most 11 significant bits (10
// explicit ones) has lo = 0 and is taken exactly.
//
// The tile. mma.sync.aligned.m16n8k8 with TF32 inputs and f32 accumulators,
// one warp, lane = 4 * grp + tig (grp = lane / 4, tig = lane % 4):
//   A (16 x 8, row-major): a0 = A[grp][tig],    a1 = A[grp + 8][tig],
//                          a2 = A[grp][tig + 4], a3 = A[grp + 8][tig + 4]
//   B (8 x 8, k-major):    b0 = B[tig][grp],    b1 = B[tig + 4][grp]
//   D (16 x 8):            d0 = D[grp][2 tig],  d1 = D[grp][2 tig + 1],
//                          d2 = D[grp + 8][2 tig], d3 = D[grp + 8][2 tig + 1]
// The kernels read fragments from shared memory with row strides chosen so
// that a warp's 32 loads fall in 32 different banks: a stride of 4 (mod 8)
// words for A read along its rows (stride = 4, 12, 20 or 28 mod 32), and 8
// or 24 mod 32 for A or B read along k (row_read_stride and k_read_stride below).

#pragma once

#include <cstdint>

namespace tf32x3 {

// -- primitives (inline PTX)

// d += a * b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes global -> shared, asynchronously; zeros when !pred (nothing is read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (through L1); zero when !pred
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// -- end primitives

// x rounded to TF32, nearest, ties away from zero (cvt.rna.tf32.f32's
// result for finite x; an overflow gives inf, as there)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

struct FragA {
  uint32_t hi[4], lo[4];
};

struct FragB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// A fragment from p = &A[grp][tig], element (r, k) at p[r * rs + k * ks]
__device__ __forceinline__ FragA load_a(const float* p, int rs, int ks) {
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * rs], f.hi[1], f.lo[1]);
  split(p[4 * ks], f.hi[2], f.lo[2]);
  split(p[8 * rs + 4 * ks], f.hi[3], f.lo[3]);
  return f;
}

// B fragment from two values the caller loaded (b0 = B[tig][grp], b1 = B[tig + 4][grp])
__device__ __forceinline__ FragB make_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// An operand staged in shared memory is split once where it lands: a thread
// replaces the 4 floats at p by their hi parts and writes their lo parts at
// p + lo_off. The fragment loaders below then read both halves.
__device__ __forceinline__ void split_in_place(float* p, int lo_off) {
  float4 v = *reinterpret_cast<float4*>(p);
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *reinterpret_cast<float4*>(p) = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                                              __uint_as_float(h[2]), __uint_as_float(h[3]));
  *reinterpret_cast<float4*>(p + lo_off) = make_float4(
      __uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// A fragment of a pre-split operand: hi at p (as load_a), lo at p + lo_off
__device__ __forceinline__ FragA load_a_split(const float* p, int lo_off, int rs, int ks) {
  FragA f;
  const int off[4] = {0, 8 * rs, 4 * ks, 8 * rs + 4 * ks};
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    f.hi[v] = __float_as_uint(p[off[v]]);
    f.lo[v] = __float_as_uint(p[off[v] + lo_off]);
  }
  return f;
}

// B fragment of a pre-split operand: p = &B[tig][grp], element (k, n) of the
// hi parts at p[k * ks + n], of the lo parts lo_off further
__device__ __forceinline__ FragB load_b_split(const float* p, int lo_off, int ks) {
  FragB f;
  f.hi[0] = __float_as_uint(p[0]);
  f.hi[1] = __float_as_uint(p[4 * ks]);
  f.lo[0] = __float_as_uint(p[lo_off]);
  f.lo[1] = __float_as_uint(p[4 * ks + lo_off]);
  return f;
}

// d += a * b in f32 accuracy: three TF32 products, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

}  // namespace tf32x3

// Shared-memory row strides, in floats (multiples of 4, so that 16-byte
// cp.async rows stay aligned), for which a warp's 32 fragment loads hit 32
// different banks: read along rows (element (grp, tig)) the stride must be
// 4 mod 8; read along k (element (tig, grp)) it must be 8 or 24 mod 32.
__host__ __device__ constexpr int row_read_stride(int cols) { return (cols + 7) / 8 * 8 + 4; }
__host__ __device__ constexpr int k_read_stride(int cols) { return (cols + 31) / 32 * 32 + 8; }
