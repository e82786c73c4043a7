// FiLM conditioning chain, forward, for one MRF stage's n FiLM blocks.
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
// 400 flops per byte, far above the card's f32 ridge (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte): the chain is bound by f32 operations.
//
// What the design does about it: the n*Cc-wide intermediate h (1224 columns at
// full width) never reaches device memory. One CTA owns (batch row, time
// tile); it stages the tile's excitation rows (plus a 2-row halo on each side)
// in shared memory once, then loops over the n blocks: phase 1 computes block
// i's h for the tile plus one halo row on each side into shared memory
// (channel-major, odd row stride so the stores do not conflict) and applies
// leaky_relu; phase 2 gives every thread a 4-row x 4-column register tile of
// out_i, reading 6 activations from shared memory and three float4 rows of W1
// through L1/L2 per input channel, for 48 FMAs. W1 (up to 3*136*256 floats per
// block) does not fit in shared memory and is streamed through L1/L2; all CTAs
// read the same W1, so it stays resident in L2.
//
// Numerics: plain f32 FMAs on the CUDA cores, no TF32 anywhere; the sums run in
// another order than cuDNN's or XLA's, so results agree with the plain
// version to rounding (tolerances are stated by the callers).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// (td_vc_gan_tpu_torch/ops/cuda/cond_chain.py does this at first use).

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerThread = 4;   // output rows of a thread's register tile
constexpr int kColsPerThread = 4;   // output columns of it: one float4
constexpr int kHRows = 8;           // h rows per work item of phase 1
constexpr int kMaxThreads = 256;
constexpr int kMaxRowThreads = 32;  // caps the time tile at 128 rows
constexpr float kSlope = 0.2f;

struct Args {
  const float* exc;      // (B, T, E)
  const float* w0;       // (3, E, n*Cc)
  const float* hbias;    // (B, n*Cc), or (n*Cc) with hbias_bstride = 0
  long long hbias_bstride;
  const float* edge0;    // (B, n*Cc) or null
  const float* edge_t;   // (B, n*Cc) or null
  const float* w1;       // (3, Cc, n*2C)
  const float* b1;       // (n*2C)
  float* out;            // (B, T, n*2C)
  int T, E, n, cc, two_c;
  int tile, lda, exc_rows, col_threads;
};

__global__ void cond_chain_fwd_kernel(Args a) {
  extern __shared__ float smem[];
  float* act = smem;                    // [Cc][lda]: lrelu(h_i), tile rows t0-1 ..
  float* xs = smem + a.cc * a.lda;      // [exc_rows][E]: exc rows t0-2 ..

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * a.tile;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int n0 = a.n * a.cc;
  const int n2 = a.n * a.two_c;
  const int h_rows = a.tile + 2;
  const int groups = (h_rows + kHRows - 1) / kHRows;

  const float* exc_b = a.exc + (size_t)b * a.T * a.E;
  for (int idx = tid; idx < a.exc_rows * a.E; idx += nthr) {
    const int r = idx / a.E;
    const int t = t0 - 2 + r;
    xs[idx] = (t >= 0 && t < a.T) ? exc_b[(size_t)t * a.E + (idx - r * a.E)] : 0.f;
  }

  const int tx = tid % a.col_threads;
  const int ty = tid / a.col_threads;  // tile = blockDim.x / col_threads * 4 rows

  for (int i = 0; i < a.n; ++i) {
    __syncthreads();  // xs staged; the previous block's act fully read

    // phase 1: act[c][r] = lrelu(h_i)[t0 - 1 + r], zero outside [0, T)
    for (int item = tid; item < a.cc * groups; item += nthr) {
      const int c = item % a.cc;
      const int g = item / a.cc;
      const int col = i * a.cc + c;
      float acc[kHRows];
#pragma unroll
      for (int k = 0; k < kHRows; ++k) acc[k] = 0.f;
      for (int j = 0; j < 3; ++j) {
        const float* wj = a.w0 + (size_t)j * a.E * n0 + col;
        const float* xj = xs + (g * kHRows + j) * a.E;
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
        const int r = g * kHRows + k;
        if (r < h_rows) {
          const int t = t0 - 1 + r;
          float v = 0.f;
          if (t >= 0 && t < a.T) {
            v = acc[k] + hb;
            if (t == 0) v -= e0;
            if (t == a.T - 1) v -= et;
            v = v >= 0.f ? v : kSlope * v;
          }
          act[c * a.lda + r] = v;
        }
      }
    }
    __syncthreads();

    // phase 2: a 4x4 register tile of out_i per thread
    {
      const int col = i * a.two_c + tx * kColsPerThread;
      float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k)
#pragma unroll
        for (int q = 0; q < kColsPerThread; ++q) acc[k][q] = __ldg(a.b1 + col + q);
      const float* w1c = a.w1 + col;
      for (int c = 0; c < a.cc; ++c) {
        const float* ar = act + c * a.lda + ty * kRowsPerThread;
        float av[kRowsPerThread + 2];
#pragma unroll
        for (int q = 0; q < kRowsPerThread + 2; ++q) av[q] = ar[q];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float4 w = __ldg(reinterpret_cast<const float4*>(
              w1c + ((size_t)j * a.cc + c) * n2));
#pragma unroll
          for (int k = 0; k < kRowsPerThread; ++k) {
            acc[k][0] = fmaf(av[k + j], w.x, acc[k][0]);
            acc[k][1] = fmaf(av[k + j], w.y, acc[k][1]);
            acc[k][2] = fmaf(av[k + j], w.z, acc[k][2]);
            acc[k][3] = fmaf(av[k + j], w.w, acc[k][3]);
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int t = t0 + ty * kRowsPerThread + k;
        if (t < a.T) {
          *reinterpret_cast<float4*>(a.out + ((size_t)b * a.T + t) * n2 + col) =
              make_float4(acc[k][0], acc[k][1], acc[k][2], acc[k][3]);
        }
      }
    }
  }
}

}  // namespace

// The launch geometry: 256 threads (fewer when 2C < 32), each owning 4
// output columns and 4 rows, so the time tile is 16 rows at 2C = 256 and 128
// at 2C = 32. Returns false for shapes the kernel does not take.
static bool geometry(int T, int E, int cc, int two_c, int* threads, int* tile,
                     int* lda, int* exc_rows, size_t* smem) {
  if (T <= 0 || E <= 0 || cc <= 0 || two_c <= 0 || two_c % kColsPerThread) return false;
  const int col_threads = two_c / kColsPerThread;
  if (col_threads > kMaxThreads) return false;
  int row_threads = kMaxThreads / col_threads;
  if (row_threads > kMaxRowThreads) row_threads = kMaxRowThreads;
  *threads = col_threads * row_threads;
  *tile = row_threads * kRowsPerThread;
  *lda = (*tile + 2) | 1;
  *exc_rows = ((*tile + 2 + kHRows - 1) / kHRows) * kHRows + 2;
  *smem = ((size_t)cc * *lda + (size_t)*exc_rows * E) * sizeof(float);
  return true;
}

extern "C" const char* cond_chain_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream` and returns cudaGetLastError() (0 on success); shapes
// the kernel does not take, or too much shared memory, give an error code.
extern "C" int cond_chain_fwd_f32(const float* exc, const float* w0, const float* hbias,
                                  long long hbias_bstride, const float* edge0,
                                  const float* edge_t, const float* w1, const float* b1,
                                  float* out, int B, int T, int E, int n, int cc, int two_c,
                                  void* stream) {
  Args a;
  int threads;
  size_t smem;
  if (B <= 0 || B > 65535 || n <= 0 ||
      !geometry(T, E, cc, two_c, &threads, &a.tile, &a.lda, &a.exc_rows, &smem)) {
    return (int)cudaErrorInvalidValue;
  }
  a.exc = exc;
  a.w0 = w0;
  a.hbias = hbias;
  a.hbias_bstride = hbias_bstride;
  a.edge0 = edge0;
  a.edge_t = edge_t;
  a.w1 = w1;
  a.b1 = b1;
  a.out = out;
  a.T = T;
  a.E = E;
  a.n = n;
  a.cc = cc;
  a.two_c = two_c;
  a.col_threads = two_c / kColsPerThread;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        cond_chain_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((T + a.tile - 1) / a.tile), (unsigned)B);
  cond_chain_fwd_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
