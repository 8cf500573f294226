// Kronecker-fusion train forward with dropout on the Kronecker vector, for
// Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel `_fwd_train_kernel` in
// multimodal_learning_tpu/ops/kron_fusion.py (launched by
// `kron_matmul_dropout`).  It computes
//
//     y[b, k] = sum_n a[b, n] * W[k, n] + bias[k],
//     a[b, n] = o1[b, i] * o2[b, j] * m[b, n],   n = i*d2 + j,
//
// with W the pofusion `encoder1` Linear weight read in place, in the torch
// layout [K, d1*d2], and m the pre-scaled dropout mask [B, d1*d2].  The
// masked Kronecker vector a is formed in shared memory only; it never
// reaches device memory.
//
// Bound.  At the paper width (B=16, d1=d2=129, K=128, N=d1*d2=16641) the
// kernel must read W (8.52 MB) and m (1.06 MB) once: about 2.9 us at
// 3.35 TB/s.  The arithmetic is about 68 MFLOP, about 1 us at 67 TFLOP/s of
// fp32 outside the tensor cores.  So it is bound by bytes.  It stays in IEEE
// fp32 FMA (no TF32, no tensor cores).
//
// Design.  The mask is rank-full over (i, j), so the factored contraction of
// the eval kernel does not apply: this is a [B, N] x [N, K] product whose
// left operand is made on the fly.  One block per chunk of NC = 64 columns
// n (261 blocks at the paper width) and per tile of BT = 16 batch rows and
// KT = 128 outputs k, so each block reads its slice of W and of m once and
// no byte of W is read by two blocks.  The block forms a[b, n] for its chunk
// in shared memory and stages its 32 KB of W transposed to [n][k], each
// thread issuing its 32 coalesced loads at once, so the whole of W is in
// flight across the card; each thread then accumulates a 2 x 4 (b, k)
// register tile: per column one float4 of W and two broadcast loads of a
// for 8 FMAs.  Each block writes its partial sums to part[chunk, b, k]; a
// second kernel adds the chunks in a fixed order and the bias.  No atomics:
// the result repeats from run to run.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BT = 16;     // batch rows per block
constexpr int KT = 128;    // outputs per block
constexpr int NC = 64;     // columns n per block
constexpr int NS = 64;     // columns per W sub-tile in shared memory
constexpr int WPAD = KT + 4;

__global__ void __launch_bounds__(kThreads)
kron_train_partial_kernel(const float* __restrict__ o1,
                          const float* __restrict__ o2,
                          const float* __restrict__ w,
                          const float* __restrict__ m,
                          float* __restrict__ part, int B, int d1, int d2,
                          int K) {
  __shared__ float a_s[BT][NC];
  __shared__ __align__(16) float w_s[NS][WPAD];

  const int N = d1 * d2;
  const int chunk = blockIdx.x;
  const int n0 = chunk * NC;
  const int b0 = blockIdx.y * BT;
  const int k0 = blockIdx.z * KT;
  const int tid = threadIdx.x;
  const int kq = tid & 31;   // outputs k0 + 4*kq .. +3
  const int bq = tid >> 5;   // batch rows b0 + 2*bq, +1

  // a[b, n] for this chunk; threads run along n, so m is read coalesced
  for (int idx = tid; idx < BT * NC; idx += kThreads) {
    const int b = idx / NC, nn = idx % NC;
    const int n = n0 + nn;
    float v = 0.f;
    if (n < N && b0 + b < B) {
      const size_t row = (size_t)(b0 + b);
      const int i = n / d2, j = n - i * d2;
      v = o1[row * d1 + i] * o2[row * d2 + j] * m[row * N + n];
    }
    a_s[b][nn] = v;
  }

  float acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int s = 0; s < NC; s += NS) {
    __syncthreads();  // a_s is written / the previous sub-tile's readers done
#pragma unroll
    for (int r = 0; r < KT * NS / kThreads; ++r) {  // all loads in flight
      const int idx = tid + r * kThreads;
      const int kk = idx / NS, nn = idx % NS;
      const int k = k0 + kk, n = n0 + s + nn;
      w_s[nn][kk] = (k < K && n < N) ? __ldg(w + (size_t)k * N + n) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < NS; ++nn) {
      const float4 wv = *reinterpret_cast<const float4*>(&w_s[nn][4 * kq]);
      const float a0 = a_s[2 * bq][s + nn];
      const float a1 = a_s[2 * bq + 1][s + nn];
      acc[0][0] = fmaf(a0, wv.x, acc[0][0]);
      acc[0][1] = fmaf(a0, wv.y, acc[0][1]);
      acc[0][2] = fmaf(a0, wv.z, acc[0][2]);
      acc[0][3] = fmaf(a0, wv.w, acc[0][3]);
      acc[1][0] = fmaf(a1, wv.x, acc[1][0]);
      acc[1][1] = fmaf(a1, wv.y, acc[1][1]);
      acc[1][2] = fmaf(a1, wv.z, acc[1][2]);
      acc[1][3] = fmaf(a1, wv.w, acc[1][3]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = b0 + 2 * bq + r;
    if (b >= B) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + 4 * kq + q;
      if (k < K) part[((size_t)chunk * B + b) * K + k] = acc[r][q];
    }
  }
}

// y[b, k] = bias[k] + sum over chunks of part[c, b, k]: a block per 32
// consecutive outputs, lane over outputs, warp w over the chunks
// c = w, w + 8, ..., then the 8 warp sums in order.
__global__ void __launch_bounds__(kThreads)
kron_train_reduce_kernel(const float* __restrict__ part,
                         const float* __restrict__ bias,
                         float* __restrict__ y, int B, int K, int chunks) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int idx = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (idx < B * K) {
#pragma unroll 4
    for (int c = warp; c < chunks; c += kWarps)
      s += part[(size_t)c * B * K + idx];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && idx < B * K) {
    float t = red[0][lane];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) t += red[q][lane];
    y[idx] = t + bias[idx % K];
  }
}

}  // namespace

extern "C" {

// Number of column chunks; the caller allocates part as [chunks, B, K].
int kron_train_chunks(int d1, int d2) { return (d1 * d2 + NC - 1) / NC; }

// Launches both kernels on `stream` (PyTorch's current stream) of the
// current device.  Returns cudaGetLastError() after the launches.
int kron_train_fwd(const float* o1, const float* o2, const float* w,
                   const float* bias, const float* m, float* part, float* y,
                   int B, int d1, int d2, int K, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int chunks = kron_train_chunks(d1, d2);
  const dim3 grid(chunks, (B + BT - 1) / BT, (K + KT - 1) / KT);
  kron_train_partial_kernel<<<grid, kThreads, 0, st>>>(o1, o2, w, m, part, B,
                                                       d1, d2, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kron_train_reduce_kernel<<<(B * K + 31) / 32, kThreads, 0, st>>>(
      part, bias, y, B, K, chunks);
  return (int)cudaGetLastError();
}

const char* kron_train_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
