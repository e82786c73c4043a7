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
// The concat form is the same computation with exc = c, a shared bias and no
// edges.
//
// What bounds it on an H100: da and dW1 each cost 2*3*n*Cc*2C flops per
// (b, t) row, the h recompute, dexc and dW0 2*3*E*n*Cc each; at the decoder's
// shapes (n*Cc = 1224, 2C = 32..256) that is hundreds of flops per byte of
// g read, far above the card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20
// flops per byte): K2 is bound by f32 operations, even counting the scratch
// below (written once, read once).
//
// What the design does about it. The TPU kernel accumulates the weight grads
// in VMEM across a grid that runs in order; Hopper CTAs run in no order, so
// the work is split into kernels that each own their outputs, and every sum
// runs in a fixed order (the results are the same from run to run, with no
// atomics):
//
//  (a) k2_data_kernel, one CTA per (batch row, time tile): stages the tile's
//      excitation rows once; per block i it recomputes lrelu(h_i) for the
//      tile plus one halo row on each side in shared memory (channel-major,
//      odd row stride), stages g_i's rows, forms da_i with 4 x 4 register
//      tiles (6 g values from shared memory and three float4 rows of W1_i^T
//      through L1/L2 for 48 FMAs), turns it into dh_i in place, accumulates
//      dexc for the tile in shared memory, writes lrelu(h_i) and dh_i for the
//      tile's own rows to scratch, and writes the tile's partial sums of dh_i
//      (for dhbias) and g_i (for db1).
//  (b) k2_wgrad_kernel, split-K weight grads: a CTA owns one (tap, block,
//      output tile) of dW1 (from the lrelu(h) scratch and g) or of dW0 (from
//      exc and the dh scratch) and one fixed chunk of the B*T rows, stages 16
//      rows at a time in shared memory and gives each thread a 4 x 4 register
//      tile; it writes a partial.
//  (c) k2_reduce_kernel sums the partials over the chunks in order, and gives
//      db1, dhbias and the edge grads.
//
// The scratch (two (B, T, n*Cc) f32 arrays, 1.4 GB each at B = 32, T = 8960)
// lives in device memory; keeping it on chip is later work.
//
// Numerics: plain f32 FMAs on the CUDA cores, no TF32 and no library call
// anywhere; the sums run in another order than the plain version's, so
// results agree with it to rounding (tolerances are stated by the callers).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

namespace {

constexpr float kSlope = 0.2f;
constexpr int kHRows = 8;              // h rows per work item of the recompute
constexpr int kKB = 16;                // rows per shared-memory stage of (b)
constexpr int kTargetThreads = 256;
constexpr size_t kSmemTarget = 116 * 1024;
constexpr size_t kSmemMax = 227 * 1024;
constexpr int kTargetCtas = 4 * 132;   // split-K aims at four CTAs per SM

struct DataArgs {
  const float* exc;      // (B, T, E)
  const float* w0;       // (3, E, n*Cc)
  const float* hbias;    // (B, n*Cc), or (n*Cc) with hbias_bstride = 0
  long long hbias_bstride;
  const float* edge0;    // (B, n*Cc) or null
  const float* edge_t;   // (B, n*Cc) or null
  const float* w1t;      // (n, 3, 2C, Cc): W1 with the input channel innermost
  const float* g;        // (B, T, n*2C)
  float* a_out;          // (B, T, n*Cc) scratch: lrelu(h)
  float* dh_out;         // (B, T, n*Cc) scratch: dh
  float* dexc;           // (B, T, E)
  float* phb;            // (B, ntiles, n*Cc) partial sums of dh
  float* pb1;            // (B, ntiles, n*2C) partial sums of g
  int T, E, n, cc, two_c;
  int tile, ntiles, lda, exc_rows, cgroups;
};

__global__ void k2_data_kernel(DataArgs a) {
  extern __shared__ float smem[];
  float* buf = smem;                          // [Cc][lda]: lrelu(h_i), then dh_i; rows t0-1 ..
  float* xs = buf + a.cc * a.lda;             // [exc_rows][E]: exc rows t0-2 ..
  float* gs = xs + a.exc_rows * a.E;          // [tile+4][2C]: g_i rows t0-2 ..
  float* dex = gs + (a.tile + 4) * a.two_c;   // [E][tile]: dexc of the tile

  const int b = blockIdx.y;
  const int tix = blockIdx.x;
  const int t0 = tix * a.tile;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n0 = a.n * a.cc;
  const int n2 = a.n * a.two_c;
  const int h_rows = a.tile + 2;               // a multiple of 4 (host)
  const int groups = (h_rows + kHRows - 1) / kHRows;
  const int g_rows = a.tile + 4;

  const float* exc_b = a.exc + (size_t)b * a.T * a.E;
  for (int idx = tid; idx < a.exc_rows * a.E; idx += nthr) {
    const int r = idx / a.E;
    const int t = t0 - 2 + r;
    xs[idx] = (t >= 0 && t < a.T) ? exc_b[(size_t)t * a.E + (idx - r * a.E)] : 0.f;
  }
  for (int idx = tid; idx < a.E * a.tile; idx += nthr) dex[idx] = 0.f;

  for (int i = 0; i < a.n; ++i) {
    __syncthreads();  // xs staged; the previous block's buf and gs fully read

    // phase 1: buf[c][q] = lrelu(h_i)[t0 - 1 + q], zero outside [0, T)
    for (int item = tid; item < a.cc * groups; item += nthr) {
      const int c = item % a.cc;
      const int gq = item / a.cc;
      const int col = i * a.cc + c;
      float acc[kHRows];
#pragma unroll
      for (int k = 0; k < kHRows; ++k) acc[k] = 0.f;
      for (int j = 0; j < 3; ++j) {
        const float* wj = a.w0 + (size_t)j * a.E * n0 + col;
        const float* xj = xs + (gq * kHRows + j) * a.E;
        for (int e = 0; e < a.E; ++e) {
          const float w = __ldg(wj + (size_t)e * n0);
#pragma unroll
          for (int k = 0; k < kHRows; ++k) acc[k] = fmaf(xj[k * a.E + e], w, acc[k]);
        }
      }
      const float hb = __ldg(a.hbias + (size_t)b * a.hbias_bstride + col);
      const float e0 = a.edge0 ? __ldg(a.edge0 + (size_t)b * n0 + col) : 0.f;
      const float et = a.edge_t ? __ldg(a.edge_t + (size_t)b * n0 + col) : 0.f;
#pragma unroll
      for (int k = 0; k < kHRows; ++k) {
        const int q = gq * kHRows + k;
        if (q < h_rows) {
          const int t = t0 - 1 + q;
          float v = 0.f;
          if (t >= 0 && t < a.T) {
            v = acc[k] + hb;
            if (t == 0) v -= e0;
            if (t == a.T - 1) v -= et;
            v = v >= 0.f ? v : kSlope * v;
          }
          buf[c * a.lda + q] = v;
        }
      }
    }
    // g_i rows t0-2 .. t0+tile+1, zero outside [0, T)
    const float* g_b = a.g + (size_t)b * a.T * n2 + i * a.two_c;
    for (int idx = tid; idx < g_rows * a.two_c; idx += nthr) {
      const int p = idx / a.two_c;
      const int v = t0 - 2 + p;
      gs[idx] = (v >= 0 && v < a.T) ? g_b[(size_t)v * n2 + (idx - p * a.two_c)] : 0.f;
    }
    __syncthreads();

    // phase 2: da for buf rows q (4 rows x 4 channels per item), dh in place
    {
      const int items = (h_rows / 4) * a.cgroups;
      const float* wt_i = a.w1t + (size_t)i * 3 * a.two_c * a.cc;
      for (int item = tid; item < items; item += nthr) {
        const int c0 = (item % a.cgroups) * 4;
        const int q0 = (item / a.cgroups) * 4;
        float acc[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[k][m] = 0.f;
        const float* wc = wt_i + c0;
        for (int o = 0; o < a.two_c; ++o) {
          // buf row q reads g at gs row q - j + 2: rows q0 .. q0+5 over the taps
          float gv[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) gv[k] = gs[(q0 + k) * a.two_c + o];
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float4 w = __ldg(reinterpret_cast<const float4*>(
                wc + ((size_t)j * a.two_c + o) * a.cc));
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const float x = gv[k + 2 - j];
              acc[k][0] = fmaf(x, w.x, acc[k][0]);
              acc[k][1] = fmaf(x, w.y, acc[k][1]);
              acc[k][2] = fmaf(x, w.z, acc[k][2]);
              acc[k][3] = fmaf(x, w.w, acc[k][3]);
            }
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int q = q0 + k;
          const int u = t0 - 1 + q;
          const bool valid = u >= 0 && u < a.T;
          float av[4], dv[4];
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            float* slot = buf + (c0 + m) * a.lda + q;
            av[m] = *slot;
            dv[m] = valid ? (av[m] >= 0.f ? acc[k][m] : kSlope * acc[k][m]) : 0.f;
            *slot = dv[m];
          }
          if (valid && q >= 1 && q <= a.tile) {
            const size_t off = ((size_t)b * a.T + u) * n0 + i * a.cc + c0;
            *reinterpret_cast<float4*>(a.a_out + off) = make_float4(av[0], av[1], av[2], av[3]);
            *reinterpret_cast<float4*>(a.dh_out + off) = make_float4(dv[0], dv[1], dv[2], dv[3]);
          }
        }
      }
    }
    __syncthreads();

    // phase 3: dexc of row t0+r += sum_j dh_i[t0+r-j+1] @ W0_i[j]^T (buf row r-j+2)
    for (int item = tid; item < a.E * a.tile; item += nthr) {
      const int r = item % a.tile;
      const int e = item / a.tile;
      float acc = 0.f;
      for (int j = 0; j < 3; ++j) {
        const float* wj = a.w0 + ((size_t)j * a.E + e) * n0 + i * a.cc;
        const float* dq = buf + (r + 2 - j);
        for (int c = 0; c < a.cc; ++c) acc = fmaf(dq[c * a.lda], __ldg(wj + c), acc);
      }
      dex[item] += acc;
    }
    // phase 4: the tile's own rows summed, for dhbias and db1
    for (int c = tid; c < a.cc; c += nthr) {
      float s = 0.f;
      for (int q = 1; q <= a.tile; ++q) s += buf[c * a.lda + q];
      a.phb[((size_t)b * a.ntiles + tix) * n0 + i * a.cc + c] = s;
    }
    for (int o = tid; o < a.two_c; o += nthr) {
      float s = 0.f;
      for (int p = 2; p < a.tile + 2; ++p) s += gs[p * a.two_c + o];
      a.pb1[((size_t)b * a.ntiles + tix) * n2 + i * a.two_c + o] = s;
    }
  }
  __syncthreads();
  for (int item = tid; item < a.E * a.tile; item += nthr) {
    const int r = item % a.tile;
    const int e = item / a.tile;
    const int t = t0 + r;
    if (t < a.T) a.dexc[((size_t)b * a.T + t) * a.E + e] = dex[item];
  }
}

struct WgradArgs {
  const float* A;   // rows of the shifted operand: element (row, grp*a_goff + m)
  int lda, a_goff, M;
  const float* Bm;  // rows of the unshifted operand: element (row, grp*b_goff + n)
  int ldb, b_goff, N;
  float* part;      // (S, 3, M, G*N)
  int R, T, G, chunk, tm, tn;
};

// part[s][j][m][grp*N + n] = sum over rows k of chunk s (k = b*T + t) of
// A[b, t+j-1][grp*a_goff + m] * Bm[b, t][grp*b_goff + n], A zero outside [0, T).
__global__ void k2_wgrad_kernel(WgradArgs w) {
  extern __shared__ float smem[];
  float* As = smem;                // [kKB][tm]
  float* Bs = smem + kKB * w.tm;   // [kKB][tn]
  const int mtiles = (w.M + w.tm - 1) / w.tm;
  const int m0 = (blockIdx.x % mtiles) * w.tm;
  const int n0 = (blockIdx.x / mtiles) * w.tn;
  const int j = blockIdx.y % 3;
  const int grp = blockIdx.y / 3;
  const int s = blockIdx.z;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int tx = tid % (w.tn / 4);
  const int ty = tid / (w.tn / 4);
  const int k_begin = s * w.chunk;
  const int k_end = min(w.R, k_begin + w.chunk);
  const float* A = w.A + (size_t)grp * w.a_goff;
  const float* Bm = w.Bm + (size_t)grp * w.b_goff;

  float acc[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[p][q] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kKB) {
    __syncthreads();
    for (int idx = tid; idx < kKB * w.tm; idx += nthr) {
      const int kk = idx / w.tm;
      const int m = idx - kk * w.tm;
      const int k = k0 + kk;
      float v = 0.f;
      if (k < k_end && m0 + m < w.M) {
        const int tt = k % w.T + j - 1;
        if (tt >= 0 && tt < w.T) v = A[(size_t)(k + j - 1) * w.lda + m0 + m];
      }
      As[idx] = v;
    }
    for (int idx = tid; idx < kKB * w.tn; idx += nthr) {
      const int kk = idx / w.tn;
      const int nn = idx - kk * w.tn;
      const int k = k0 + kk;
      Bs[idx] = (k < k_end && n0 + nn < w.N) ? Bm[(size_t)k * w.ldb + n0 + nn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKB; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(As + kk * w.tm + ty * 4);
      const float4 bv = *reinterpret_cast<const float4*>(Bs + kk * w.tn + tx * 4);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        acc[p][0] = fmaf(ar[p], bv.x, acc[p][0]);
        acc[p][1] = fmaf(ar[p], bv.y, acc[p][1]);
        acc[p][2] = fmaf(ar[p], bv.z, acc[p][2]);
        acc[p][3] = fmaf(ar[p], bv.w, acc[p][3]);
      }
    }
  }
  const size_t ldo = (size_t)w.G * w.N;
  float* out = w.part + ((size_t)s * 3 + j) * w.M * ldo + (size_t)grp * w.N;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + ty * 4 + p;
    if (m < w.M) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int nn = n0 + tx * 4 + q;
        if (nn < w.N) out[m * ldo + nn] = acc[p][q];
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

struct Wgrad {
  int tm, tn, mtiles, ntiles, S, chunk;
};

int round4(int x) { return (x + 3) / 4 * 4; }

Wgrad wgrad_plan(int M, int N, int G, int R) {
  Wgrad p;
  int mt = (M + 63) / 64;
  p.tm = round4((M + mt - 1) / mt);
  const int ncap = p.tm > 16 ? 64 : 256;
  int nt = (N + ncap - 1) / ncap;
  p.tn = round4((N + nt - 1) / nt);
  p.mtiles = (M + p.tm - 1) / p.tm;
  p.ntiles = (N + p.tn - 1) / p.tn;
  const int tiles = p.mtiles * p.ntiles * 3 * G;
  int S = (kTargetCtas + tiles - 1) / tiles;
  const int max_s = (R + 63) / 64;
  if (S > max_s) S = max_s;
  if (S < 1) S = 1;
  p.chunk = ((R + S - 1) / S + kKB - 1) / kKB * kKB;
  p.S = (R + p.chunk - 1) / p.chunk;
  return p;
}

// Everything the launch needs, from the shapes alone; ok = false for shapes
// the kernels do not take.
struct Plan {
  bool ok;
  int threads, tile, ntiles, lda, exc_rows, cgroups;
  size_t smem;
  Wgrad w1, w0;
  size_t off_a, off_dh, off_phb, off_pb1, off_pw1, off_pw0, total;
};

Plan make_plan(int B, int T, int E, int n, int cc, int two_c) {
  Plan p{};
  p.ok = false;
  if (B <= 0 || B > 65535 || T <= 0 || E <= 0 || n <= 0 || cc <= 0 || two_c <= 0 ||
      cc % 4 || two_c % 4 || (long long)B * T > (1LL << 30)) {
    return p;
  }
  p.cgroups = cc / 4;
  int rthreads = (kTargetThreads + p.cgroups - 1) / p.cgroups;
  if (rthreads * p.cgroups > 1024) rthreads = 1024 / p.cgroups;
  if (rthreads < 1) return p;
  p.threads = rthreads * p.cgroups;
  for (int rounds = 4; rounds >= 1; rounds /= 2) {
    p.tile = 4 * rthreads * rounds - 2;
    p.lda = (p.tile + 2) | 1;
    p.exc_rows = ((p.tile + 2 + kHRows - 1) / kHRows) * kHRows + 2;
    p.smem = ((size_t)cc * p.lda + (size_t)p.exc_rows * E + (size_t)(p.tile + 4) * two_c +
              (size_t)E * p.tile) * sizeof(float);
    if (p.smem <= kSmemTarget) break;
  }
  if (p.smem > kSmemMax) return p;
  p.ntiles = (T + p.tile - 1) / p.tile;
  const int R = B * T;
  const size_t n0 = (size_t)n * cc, n2 = (size_t)n * two_c;
  p.w1 = wgrad_plan(cc, two_c, n, R);
  p.w0 = wgrad_plan(E, (int)n0, 1, R);
  p.off_a = 0;
  p.off_dh = p.off_a + (size_t)R * n0;
  p.off_phb = p.off_dh + (size_t)R * n0;
  p.off_pb1 = p.off_phb + (size_t)B * p.ntiles * n0;
  p.off_pw1 = p.off_pb1 + (size_t)B * p.ntiles * n2;
  p.off_pw0 = p.off_pw1 + (size_t)p.w1.S * 3 * cc * n2;
  p.total = p.off_pw0 + (size_t)p.w0.S * 3 * E * n0;
  p.ok = true;
  return p;
}

cudaError_t launch_reduce(const float* part, float* out, long long len, int outer, int S,
                          long long sstride, long long ostride, float scale,
                          cudaStream_t stream) {
  const int threads = 256;
  dim3 grid((unsigned)((len + threads - 1) / threads), (unsigned)outer);
  k2_reduce_kernel<<<grid, threads, 0, stream>>>(part, out, len, S, sstride, ostride, scale);
  return cudaGetLastError();
}

cudaError_t launch_wgrad(const Wgrad& p, const float* A, int lda, int a_goff, int M,
                         const float* Bm, int ldb, int b_goff, int N, int G, int R, int T,
                         float* part, cudaStream_t stream) {
  WgradArgs w;
  w.A = A;
  w.lda = lda;
  w.a_goff = a_goff;
  w.M = M;
  w.Bm = Bm;
  w.ldb = ldb;
  w.b_goff = b_goff;
  w.N = N;
  w.part = part;
  w.R = R;
  w.T = T;
  w.G = G;
  w.chunk = p.chunk;
  w.tm = p.tm;
  w.tn = p.tn;
  dim3 grid((unsigned)(p.mtiles * p.ntiles), (unsigned)(3 * G), (unsigned)p.S);
  const int threads = (p.tm / 4) * (p.tn / 4);
  const size_t smem = (size_t)kKB * (p.tm + p.tn) * sizeof(float);
  k2_wgrad_kernel<<<grid, threads, smem, stream>>>(w);
  return cudaGetLastError();
}

}  // namespace

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
  const int R = B * T;
  float* a_s = ws + p.off_a;
  float* dh_s = ws + p.off_dh;

  DataArgs d;
  d.exc = exc;
  d.w0 = w0;
  d.hbias = hbias;
  d.hbias_bstride = hbias_bstride;
  d.edge0 = edge0;
  d.edge_t = edge_t;
  d.w1t = w1t;
  d.g = g;
  d.a_out = a_s;
  d.dh_out = dh_s;
  d.dexc = dexc;
  d.phb = ws + p.off_phb;
  d.pb1 = ws + p.off_pb1;
  d.T = T;
  d.E = E;
  d.n = n;
  d.cc = cc;
  d.two_c = two_c;
  d.tile = p.tile;
  d.ntiles = p.ntiles;
  d.lda = p.lda;
  d.exc_rows = p.exc_rows;
  d.cgroups = p.cgroups;
  cudaError_t e = cudaSuccess;
  if (p.smem > 48 * 1024) {
    e = cudaFuncSetAttribute(k2_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
    if (e != cudaSuccess) return (int)e;
  }
  k2_data_kernel<<<dim3((unsigned)p.ntiles, (unsigned)B), p.threads, p.smem, stream>>>(d);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  // dW1 from lrelu(h) (shifted) and g; dW0 from exc (shifted) and dh
  if ((e = launch_wgrad(p.w1, a_s, n0, cc, cc, g, n2, two_c, two_c, n, R, T, ws + p.off_pw1,
                        stream)) != cudaSuccess) return (int)e;
  if ((e = launch_wgrad(p.w0, exc, E, 0, E, dh_s, n0, 0, n0, 1, R, T, ws + p.off_pw0,
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
