// The f32 FiLM cond-chain kernels on Hopper (cond_chain.cu, K1;
// cond_chain_bwd.cu's data kernel, K2): what both share. Their CTAs have the
// same shape, and both compute cond_0's pre-activation
//
//   h[t] = sum_j exc[t+j-1] @ W0[j] + hbias - [t==0] edge0 - [t==T-1] edge_t
//
// (exc zero outside [0, T)) on wgmma in 3xTF32 (tf32x3.cuh), with the same
// operands in the same order, so that K2's recompute of h is K1's h.
//
// The CTA. Two consumer warpgroups and a producer warp (288 threads, at most
// 168 registers a thread). Consumer warpgroup w holds 64 rows of h (wgmma's
// M), the time rows u0 + q, q < 64, u0 = t0 + 62 w - 1: its 62 own rows and
// a halo row each side, which the k=3 convs of the next products need; the
// CTA owns the 124 rows [t0, t0 + 124). The producer's one thread keeps bulk
// copies (and TMA copies) in flight through a ring of stages, each with a
// full and an empty mbarrier (one arrival per consumer warp); both
// warpgroups take every item of the ring, in the order it is filled.
//
// h as one product per pass of 136 columns: h = X @ Wh, per row u and block i,
//   X[u] = [exc[u-1] | exc[u] | exc[u+1] | 1 | -[u == 0] | -[u == T-1]]   (K = 3E + 3)
//   Wh   = [W0_i[0]; W0_i[1]; W0_i[2]; hbias_i[b]; edge0_i[b]; edge_t_i[b]]
// (zero edge rows without edges), in k-slices of 8: A from registers (X's hi
// and lo, made from exc), B an image of Wh's k-slice, hi then lo, each 136
// rows (the pass's columns) x 8 k, K-major without swizzle (tf32x3.cuh):
// element (nn, kk) at (nn / 8) 256 + (kk / 4) 128 + (nn % 8) 16 + (kk % 4) 4
// bytes. The images are laid out at each launch by the kernels' image
// kernels (h_image_unit), split into hi and lo there, one per batch row
// where hbias or the edges are per batch row.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper_bf16.cuh"
#include "tf32x3.cuh"

namespace f32chain {

using namespace hopper;
using tf32x3::split;  // x = hi + lo, each rounded to tf32
using tf32x3::to_tf32;

constexpr float kSlope = 0.2f;    // leaky_relu's negative slope
constexpr int kRows = 64;         // rows of h per consumer warpgroup
constexpr int kOwn = kRows - 2;   // of which its own
constexpr int kTile = 2 * kOwn;   // rows a CTA owns
constexpr int kPass = 136;        // columns of h per pass
constexpr int kPassSlices = 17;   // the pass as K: 17 slices of 8
constexpr int kThreads = 288;     // two consumer warpgroups, one producer warp
constexpr int kHItem = kPass * 8 * 4;  // 4352: a k-slice of a 136-row operand, hi or lo
constexpr int kHUnits = kHItem / 16;   // its 16-byte units
constexpr size_t kSmemMax = 227 * 1024;

struct HArgs {
  const float* exc;  // (B, T, E)
  int T, E, n, cc;
  int npass, nkh;    // passes of 136 columns; k-slices of h (K = 3E + 3)
};

__host__ __device__ inline int passes(int cc) { return (cc + kPass - 1) / kPass; }
__host__ __device__ inline int h_slices(int E) { return (3 * E + 3 + 7) / 8; }
// bytes of one batch row's image of Wh (every block and pass)
__host__ __device__ inline size_t h_image_bytes(int n, int cc, int E) {
  return (size_t)n * passes(cc) * h_slices(E) * 2 * kHItem;
}

// The warpgroup's thread and its place in the accumulator layout
struct Lane {
  int wt;   // 0 .. 127
  int row;  // its first row (q), the second is row + 8
  int tig;  // its columns are 8k + 2 tig, + 1
  __device__ __forceinline__ Lane() {
    wt = threadIdx.x & 127;
    const int lane = wt & 31;
    row = (wt >> 5) * 16 + (lane >> 2);
    tig = lane & 3;
  }
};

// X[u][k] (above): exc[b][u + j - 1][e] for k = j E + e < 3E (0 outside
// [0, T)), then 1, -[u == 0], -[u == T-1], then 0
__device__ __forceinline__ float x_at(const HArgs& h, int b, int u, int k) {
  if (k < 3 * h.E) {
    const int j = (k >= h.E) + (k >= 2 * h.E);  // k / E, without the division
    const int t = u + j - 1;
    if (t < 0 || t >= h.T) return 0.f;
    return __ldg(h.exc + ((size_t)b * h.T + t) * h.E + (k - j * h.E));
  }
  if (k == 3 * h.E) return 1.f;
  if (k == 3 * h.E + 1) return u == 0 ? -1.f : 0.f;
  if (k == 3 * h.E + 2) return u == h.T - 1 ? -1.f : 0.f;
  return 0.f;
}

// The A registers, hi and lo, of a k-slice (the m16n8k8 A layout per warp)
struct XFrag {
  uint32_t hi[4], lo[4];
};

// X's k-slice s for the warpgroup's rows u0 + q
__device__ __forceinline__ XFrag x_frag(const HArgs& h, int b, int u0, const Lane& l, int s) {
  XFrag f;
  const int k = 8 * s + l.tig;
  const int u = u0 + l.row;
  const float v[4] = {x_at(h, b, u, k), x_at(h, b, u + 8, k), x_at(h, b, u, k + 4),
                      x_at(h, b, u + 8, k + 4)};
#pragma unroll
  for (int r = 0; r < 4; ++r) split(v[r], f.hi[r], f.lo[r]);
  return f;
}

// The ring of S stages: item k in slot k % S, its phase (k / S) & 1
template <int S>
__device__ __forceinline__ int slot_of(int k) {
  return k % S;
}
template <int S>
__device__ __forceinline__ uint32_t parity_of(int k) {
  return (uint32_t)((k / S) & 1);
}

// A consumer warp's release of a slot once its products have read it
__device__ __forceinline__ void release(uint64_t* empty) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(empty);
}

// the producer's bulk copy of item k (`bytes` from `src`) into its slot, once free
template <int S, int kSlot>
__device__ __forceinline__ void put(unsigned char* ring, uint64_t* full, uint64_t* empty, int& k,
                                    const void* src, uint32_t bytes) {
  const int s = slot_of<S>(k);
  mbar_wait(&empty[s], parity_of<S>(k) ^ 1);
  mbar_arrive_expect_tx(&full[s], bytes);
  bulk_load(ring + s * kSlot, src, bytes, &full[s]);
  ++k;
}

// no swizzle, K-major: 8-row groups SBO bytes apart, the two 4-element halves
// of a k-slice LBO bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return make_desc(saddr, lbo, sbo, kLayoutNone);
}

template <int R>
__device__ __forceinline__ void zero(float (&d)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) d[r] = 0.f;
}

// k-slices of pass p's columns
__device__ __forceinline__ int pass_slices(const HArgs& h, int p) {
  const int width = min(kPass, h.cc - kPass * p);
  return (width + 7) / 8;
}

// X's k-slice s for the warpgroup's rows q from X's image in shared memory
// (cond_chain_bwd.cu's x_image: element (k, q), split, at (k / 8) 2048 +
// (q / 4) 128 + (k % 8) 16 + (q % 4) 4 bytes, hi then lo 8192 on): the same
// words as x_frag's
__device__ __forceinline__ XFrag x_frag_image(const unsigned char* xs, const Lane& l, int s) {
  const uint32_t* p = reinterpret_cast<const uint32_t*>(xs + s * 2048 + (l.row >> 2) * 128 +
                                                        l.tig * 16 + (l.row & 3) * 4);
  XFrag f;
  f.hi[0] = p[0];
  f.hi[1] = p[64];
  f.hi[2] = p[16];
  f.hi[3] = p[80];
  f.lo[0] = p[2048];
  f.lo[1] = p[2048 + 64];
  f.lo[2] = p[2048 + 16];
  f.lo[3] = p[2048 + 80];
  return f;
}

// hacc = h for the warpgroup's rows u0 + q and the pass's 136 columns, in
// the accumulator layout, before leaky_relu: M = 64, N = 136, K = 3E + 3, two
// k-slices of Wh an item of the ring (items k ..), X's A registers made four
// k-slices at a time (from exc, or where xs is given from X's image there);
// each item's products (per slice X.lo Wh.hi, X.hi Wh.lo, X.hi Wh.hi) a
// commit group, issued as soon as the item is in, the slot of the item
// before released once its products are done (one group in flight while
// the next item is waited for).
template <int S, int kSlot>
__device__ __forceinline__ void h_pass(const HArgs& h, float (&hacc)[68], unsigned char* ring,
                                       uint64_t* full, uint64_t* empty, int& k, int b, int u0,
                                       const Lane& l, const unsigned char* xs) {
  zero(hacc);
  XFrag x[4];
  int prev = -1;
  for (int s0 = 0; s0 < h.nkh; s0 += 4) {
    if (s0 > 0) wgmma_wait<0>();  // the four slices before are done with x
#pragma unroll
    for (int ss = 0; ss < 4; ++ss) {
      if (s0 + ss < h.nkh) {
        x[ss] = xs ? x_frag_image(xs, l, s0 + ss) : x_frag(h, b, u0, l, s0 + ss);
        fence_regs(x[ss].hi);
        fence_regs(x[ss].lo);
      }
    }
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      if (s0 + 2 * it < h.nkh) {
        const int slot = slot_of<S>(k);
        mbar_wait(&full[slot], parity_of<S>(k));
        const uint32_t base = smem_u32(ring + slot * kSlot);
        wgmma_fence();
#pragma unroll
        for (int ss = 0; ss < 2; ++ss) {
          if (s0 + 2 * it + ss < h.nkh) {
            const XFrag& xf = x[2 * it + ss];
            const uint32_t bs = base + ss * 2 * kHItem;
            tf32x3::wgmma_rs_n136(hacc, xf.lo, desc(bs, 128, 256), 1);
            tf32x3::wgmma_rs_n136(hacc, xf.hi, desc(bs + kHItem, 128, 256), 1);
            tf32x3::wgmma_rs_n136(hacc, xf.hi, desc(bs, 128, 256), 1);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (prev >= 0) release(&empty[prev]);
        prev = slot;
        ++k;
      }
    }
  }
  wgmma_wait<0>();
  fence_regs(hacc);
  release(&empty[prev]);
}

// -- the image of Wh (made by the image kernels)

struct WhArgs {
  const float* w0;      // (3, E, n*Cc)
  const float* hbias;   // (B, n*Cc), or (n*Cc) with hbias_bstride = 0
  long long hbias_bstride;
  const float* edge0;   // (B, n*Cc) or null
  const float* edge_t;  // (B, n*Cc) or null
  int E, n, cc;
};

// Wh[k][c] of batch row b (above)
__device__ __forceinline__ float wh_at(const WhArgs& a, int b, int i, int c, int k) {
  const int n0 = a.n * a.cc;
  const size_t col = (size_t)i * a.cc + c;
  if (k < 3 * a.E) {
    const int j = k / a.E;
    return a.w0[((size_t)j * a.E + (k - j * a.E)) * n0 + col];
  }
  if (k == 3 * a.E) return a.hbias[(size_t)b * a.hbias_bstride + col];
  if (k > 3 * a.E + 2) return 0.f;
  const float* edge = k == 3 * a.E + 1 ? a.edge0 : a.edge_t;
  return edge ? edge[(size_t)b * n0 + col] : 0.f;
}

// 4 values' hi (hl = 0) or lo (hl = 1) parts, as 16 bytes at dst
__device__ __forceinline__ void put_unit(unsigned char* dst, const float (&v)[4], int hl) {
  uint32_t out[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    uint32_t hi, lo;
    split(v[e], hi, lo);
    out[e] = hl ? lo : hi;
  }
  *reinterpret_cast<uint4*>(dst) = make_uint4(out[0], out[1], out[2], out[3]);
}

// Where 16-byte unit r (< kHUnits) of a 136-row image lies: its row and its
// first k (the unit holds k .. k + 3 of that row)
__device__ __forceinline__ void unit_place(int r, int& row, int& k0) {
  row = (r / 16) * 8 + r % 8;
  k0 = ((r % 16) / 8) * 4;
}

// Unit u of the images of Wh, img_h[image][i][p][s][hi, lo] (nimg images)
__device__ __forceinline__ void h_image_unit(const WhArgs& a, long long u, unsigned char* img_h) {
  const int npass = passes(a.cc), nkh = h_slices(a.E);
  const long long item = u / (2 * kHUnits);
  int r = (int)(u - item * 2 * kHUnits);
  const int hl = r / kHUnits;
  r -= hl * kHUnits;
  int nn, k0;
  unit_place(r, nn, k0);
  k0 += 8 * (int)(item % nkh);
  const int p = (int)((item / nkh) % npass);
  const int i = (int)((item / ((long long)nkh * npass)) % a.n);
  const int bi = (int)(item / ((long long)nkh * npass * a.n));
  const int c = kPass * p + nn;
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = c < a.cc ? wh_at(a, bi, i, c, k0 + e) : 0.f;
  put_unit(img_h + u * 16, v, hl);
}

// -- host

// A tensor map over the f32 tensor at `base` (16-byte aligned) of `rank`
// dimensions, dims[0] contiguous, strides[k] the bytes between neighbours of
// dimension k + 1 (multiples of 16), copied in boxes of `box` (box[0] x 4
// bytes a multiple of 16) without swizzle: a box lands in shared memory as
// its rows of box[0] elements, one after the other; zeros out of bounds.
// False where cuTensorMapEncodeTiled refuses it.
inline bool make_map_f32(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, (cuuint32_t)rank, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace f32chain
