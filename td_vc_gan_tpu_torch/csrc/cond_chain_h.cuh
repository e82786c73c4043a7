// cond_0 of the FiLM cond chain on the tensor cores, shared by the forward
// (cond_chain.cu, K1) and the backward (cond_chain_bwd.cu, K2), which both
// recompute lrelu(h) per time tile instead of keeping the n*Cc-wide h in
// device memory:
//
//   h[t] = sum_j exc[t+j-1] @ W0[j] + hbias - [t==0] edge0 - [t==T-1] edge_t
//
// with exc zero outside [0, T).

#pragma once

#include "tf32x3.cuh"

namespace cond_chain_h {

constexpr float kSlope = 0.2f;  // leaky_relu's negative slope

struct HArgs {
  const float* exc;     // (B, T, E)
  const float* w0;      // (3, E, n*Cc)
  const float* hbias;   // (B, n*Cc), or (n*Cc) with hbias_bstride = 0
  long long hbias_bstride;
  const float* edge0;   // (B, n*Cc) or null
  const float* edge_t;  // (B, n*Cc) or null
  int T, E, n, cc;
  int e_pad, cc_pad;    // E and Cc rounded up to 8
};

// xs[r][e] = exc[t0 - 2 + r][e] for r < rows, zero outside [0, T) and for
// e >= E (up to the row stride ldx).
__device__ __forceinline__ void stage_exc(const HArgs& h, float* xs, int ldx, int rows, int b,
                                          int t0) {
  const float* exc_b = h.exc + (size_t)b * h.T * h.E;
  for (int idx = threadIdx.x; idx < rows * ldx; idx += blockDim.x) {
    const int r = idx / ldx;
    const int e = idx - r * ldx;
    const int t = t0 - 2 + r;
    xs[idx] = (t >= 0 && t < h.T && e < h.E) ? exc_b[(size_t)t * h.E + e] : 0.f;
  }
}

constexpr int kHNT = 3;  // n-tiles of h per warp and column group: 8 warps cover 192 columns

// act[q][c] = lrelu(h_i)[t0 - 1 + q] for q < rows and c < Cc_pad, zero
// outside [0, T) and for c >= Cc; block i's Cc columns of h. An
// M = 16*ceil(rows/16), N = Cc_pad, K = 3*E_pad product on the tensor cores
// (3xTF32): A from the staged exc rows (xs row q + j for tap j, so xs holds
// 16*ceil(rows/16) + 2 rows), B = W0_i read through L1. The columns go in
// groups of 192 (one group at Cc <= 192); in each, warp w owns the n-tiles
// w, w + 8, w + 16 for every row: it loads and splits their B fragments once
// per K-chunk of 3 k-steps (all of K at E <= 8), and its bias and edge
// values once, then walks the m-tiles with up to three independent
// accumulators. With K in more than one chunk (E > 8, the
// concat form) the partial sums wait in act between chunks; each element
// stays with one lane throughout, so no barrier is needed. Needs 8 warps.
// kOneGroup (for Cc <= 192 only) compiles the group loop away.
template <bool kOneGroup>
__device__ __forceinline__ void recompute_act(const HArgs& h, const float* xs, int ldx,
                                              float* act, int lda, int rows, int b, int t0,
                                              int i) {
  using namespace tf32x3;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tig = lane & 3;
  const int n0 = h.n * h.cc;
  const int mtiles = (rows + 15) / 16;
  const int ntiles = h.cc_pad / 8;
  const int ks_tap = h.e_pad / 8;
  const int ksteps = 3 * ks_tap;

  const int tb_end = kOneGroup ? 1 : ntiles;
  for (int tb = 0; tb < tb_end; tb += 8 * kHNT) {  // column group: n-tiles tb ..
    float hb[kHNT][2], ed0[kHNT][2], edt[kHNT][2];
#pragma unroll
    for (int u = 0; u < kHNT; ++u) {
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int col = (tb + warp + 8 * u) * 8 + 2 * tig + v;
        const bool ok = col < h.cc;
        const size_t gcol = (size_t)i * h.cc + col;
        hb[u][v] = ok ? __ldg(h.hbias + (size_t)b * h.hbias_bstride + gcol) : 0.f;
        ed0[u][v] = ok && h.edge0 ? __ldg(h.edge0 + (size_t)b * n0 + gcol) : 0.f;
        edt[u][v] = ok && h.edge_t ? __ldg(h.edge_t + (size_t)b * n0 + gcol) : 0.f;
      }
    }

    for (int k0 = 0; k0 < ksteps; k0 += 3) {
      const bool last = k0 + 3 >= ksteps;
      FragB bf[3][kHNT];
      int xoff[3];  // k-step k0 + kk reads xs[q + j][e0 + ..]: offset j*ldx + e0 + tig
#pragma unroll
      for (int kk = 0; kk < 3; ++kk) {
        const int s = min(k0 + kk, ksteps - 1);
        const int j = s / ks_tap;
        const int ea = (s - j * ks_tap) * 8 + tig;
        xoff[kk] = j * ldx + ea;
#pragma unroll
        for (int u = 0; u < kHNT; ++u) {
          const int c = (tb + warp + 8 * u) * 8 + grp;
          const float* wc = h.w0 + (size_t)j * h.E * n0 + (size_t)i * h.cc + c;
          const bool ok = c < h.cc && k0 + kk < ksteps;
          bf[kk][u] = make_b(ok && ea < h.E ? __ldg(wc + (size_t)ea * n0) : 0.f,
                             ok && ea + 4 < h.E ? __ldg(wc + (size_t)(ea + 4) * n0) : 0.f);
        }
      }
      for (int mt = 0; mt < mtiles; ++mt) {
        float d[kHNT][4];
#pragma unroll
        for (int u = 0; u < kHNT; ++u) {
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = mt * 16 + grp + 8 * (v >> 1);
            const int col = (tb + warp + 8 * u) * 8 + 2 * tig + (v & 1);
            d[u][v] = (k0 == 0 || q >= rows || col >= h.cc_pad) ? 0.f : act[q * lda + col];
          }
        }
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          if (k0 + kk >= ksteps) break;
          const FragA fa = load_a(xs + (mt * 16 + grp) * ldx + xoff[kk], ldx, 1);
#pragma unroll
          for (int u = 0; u < kHNT; ++u) {
            if (tb + warp + 8 * u < ntiles) mma3(d[u], fa, bf[kk][u]);
          }
        }
#pragma unroll
        for (int u = 0; u < kHNT; ++u) {
          if (tb + warp + 8 * u >= ntiles) continue;
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int q = mt * 16 + grp + 8 * (v >> 1);
            if (q >= rows) continue;
            const int col = (tb + warp + 8 * u) * 8 + 2 * tig + (v & 1);
            float x = d[u][v];
            if (last) {
              const int t = t0 - 1 + q;
              if (t >= 0 && t < h.T && col < h.cc) {
                x += hb[u][v & 1];
                if (t == 0) x -= ed0[u][v & 1];
                if (t == h.T - 1) x -= edt[u][v & 1];
                x = x >= 0.f ? x : kSlope * x;
              } else {
                x = 0.f;
              }
            }
            act[q * lda + col] = x;
          }
        }
      }
    }
  }
}

}  // namespace cond_chain_h
