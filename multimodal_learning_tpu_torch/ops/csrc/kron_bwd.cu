// Kronecker-fusion backward for Hopper (sm_90a), fp32: the two kernels of
// the eval contraction's gradient.
//
// Replaces the Pallas TPU kernels `_bwd_dw_kernel` and `_bwd_dvec_kernel` in
// multimodal_learning_tpu/ops/kron_fusion.py (launched by `_kron_bwd`).  With
// W the pofusion `encoder1` Linear weight in the torch layout [K, N],
// N = d1*d2 (W[k, i*d2 + j]), and g the output gradient [B, K]:
//
//   kron_bwd_dw:    dW[k, n] = sum_b g[b, k] * a[b, n],
//                   a[b, i*d2 + j] = o1[b, i] * o2[b, j]
//   kron_bwd_dvec:  s[b, n] = sum_k g[b, k] * W[k, n]
//                   do1[b, i] = sum_j s[b, i*d2 + j] * o2[b, j]
//                   do2[b, j] = sum_i s[b, i*d2 + j] * o1[b, i]
//
// dW lands in the torch layout, so it is the gradient of `encoder1.0.weight`
// as it is.  Both stay in IEEE fp32 FMA and use no atomics: every sum runs in
// a fixed order, so results repeat from run to run.
//
// Bounds at the paper width (B=16, d1=d2=129, K=128): kron_bwd_dw must write
// dW once, 8.52 MB, about 2.5 us at 3.35 TB/s (34 MFMA, 1 us of fp32);
// kron_bwd_dvec must read W once, 8.52 MB, about 2.5 us (69 MFMA, 2 us).
// Both are bound by bytes.
//
// kron_bwd_dw design.  A rank-B product [K, B] x [B, N] whose right factor
// is formed on the fly: one block per 128 columns n (131 blocks) and 128
// outputs k.  The block forms a[b, n] for its columns and stages g in
// shared memory; each lane keeps a of its 4 columns (every 32nd) for 16
// batch rows in registers, and each warp computes 16 rows k: per row one
// broadcast float4 per 4 batch rows, 64 FMAs, and 4 stores that are each a
// coalesced 128-byte line across the warp.  Batches beyond 16 rows loop in
// tiles, accumulating in registers.
//
// kron_bwd_dvec design.  Pass 1 streams W once, as a [B, K] x [K, N] product:
// one block per 64 columns n (261 blocks), lanes along n so every load of W
// is a coalesced line, four groups of warps over quarters of k, each thread
// accumulating 16 batch rows with g read as broadcast float4 from shared
// memory; the four quarters are added in order through shared memory and s
// (1.06 MB) is written once.  Pass 2 reads s: a warp per (b, i) reduces
// do1 along j with a fixed shuffle tree, a thread per (b, j) sums do2 along
// i in 8 interleaved runs added in order.
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;           // 8 warps
constexpr int BT = 16;                  // batch rows per tile

// ---------------------------------------------------------------- dW
constexpr int DW_NB = 128;              // columns per block: 4 per lane
constexpr int DW_KT = 128;              // outputs k per block: 16 per warp

__global__ void __launch_bounds__(kThreads)
kron_bwd_dw_kernel(const float* __restrict__ o1, const float* __restrict__ o2,
                   const float* __restrict__ g, float* __restrict__ dw, int B,
                   int d1, int d2, int K) {
  __shared__ float as[BT][DW_NB];
  __shared__ __align__(16) float gs[DW_KT][BT];

  const int N = d1 * d2;
  const int n0 = blockIdx.x * DW_NB;
  const int k0 = blockIdx.y * DW_KT;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float acc[16][4];
#pragma unroll
  for (int r = 0; r < 16; ++r)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[r][t] = 0.f;

  for (int b0 = 0; b0 < B; b0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < BT * DW_NB; idx += kThreads) {
      const int b = idx / DW_NB, nn = idx % DW_NB;
      const int n = n0 + nn;
      float v = 0.f;
      if (n < N && b0 + b < B) {
        const int i = n / d2, j = n - i * d2;
        v = o1[(size_t)(b0 + b) * d1 + i] * o2[(size_t)(b0 + b) * d2 + j];
      }
      as[b][nn] = v;
    }
    for (int idx = threadIdx.x; idx < DW_KT * BT; idx += kThreads) {
      const int kk = idx / BT, b = idx % BT;
      gs[kk][b] = (k0 + kk < K && b0 + b < B)
                      ? g[(size_t)(b0 + b) * K + k0 + kk]
                      : 0.f;
    }
    __syncthreads();

    float ar[BT][4];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int t = 0; t < 4; ++t) ar[b][t] = as[b][lane + 32 * t];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4* gv = reinterpret_cast<const float4*>(gs[warp * 16 + r]);
#pragma unroll
      for (int q = 0; q < BT / 4; ++q) {
        const float4 v = gv[q];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          acc[r][t] = fmaf(v.x, ar[4 * q + 0][t], acc[r][t]);
          acc[r][t] = fmaf(v.y, ar[4 * q + 1][t], acc[r][t]);
          acc[r][t] = fmaf(v.z, ar[4 * q + 2][t], acc[r][t]);
          acc[r][t] = fmaf(v.w, ar[4 * q + 3][t], acc[r][t]);
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int k = k0 + warp * 16 + r;
    if (k >= K) break;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int n = n0 + lane + 32 * t;
      if (n < N) dw[(size_t)k * N + n] = acc[r][t];
    }
  }
}

// ------------------------------------------------------------- dvec
constexpr int DV_NB = 64;               // columns per block: 1 per lane
constexpr int DV_KQ = kThreads / DV_NB; // 4 quarters of k
constexpr int DV_KT = 128;              // k staged per smem tile

__global__ void __launch_bounds__(kThreads)
kron_bwd_s_kernel(const float* __restrict__ w, const float* __restrict__ g,
                  float* __restrict__ s, int B, int N, int K) {
  __shared__ __align__(16) float gs[DV_KT][BT];
  __shared__ float red[DV_KQ][BT][DV_NB];

  const int nl = threadIdx.x % DV_NB;
  const int kq = threadIdx.x / DV_NB;
  const int n = blockIdx.x * DV_NB + nl;
  const int b0 = blockIdx.y * BT;

  float acc[BT];
#pragma unroll
  for (int b = 0; b < BT; ++b) acc[b] = 0.f;

  for (int k0 = 0; k0 < K; k0 += DV_KT) {
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < DV_KT * BT; idx += kThreads) {
      const int kk = idx / BT, b = idx % BT;
      gs[kk][b] = (k0 + kk < K && b0 + b < B)
                      ? g[(size_t)(b0 + b) * K + k0 + kk]
                      : 0.f;
    }
    __syncthreads();
    const int kend = min(DV_KT, K - k0);
    const int per = (kend + DV_KQ - 1) / DV_KQ;
    const int kbeg = kq * per, kstop = min(kend, kbeg + per);
#pragma unroll 8
    for (int kk = kbeg; kk < kstop; ++kk) {
      const float wv = n < N ? __ldg(w + (size_t)(k0 + kk) * N + n) : 0.f;
      const float4* gv = reinterpret_cast<const float4*>(gs[kk]);
#pragma unroll
      for (int q = 0; q < BT / 4; ++q) {
        const float4 v = gv[q];
        acc[4 * q + 0] = fmaf(v.x, wv, acc[4 * q + 0]);
        acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
        acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
        acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < BT; ++b) red[kq][b][nl] = acc[b];
  __syncthreads();
  for (int idx = threadIdx.x; idx < BT * DV_NB; idx += kThreads) {
    const int b = idx / DV_NB, c = idx % DV_NB;
    const int nn = blockIdx.x * DV_NB + c;
    if (b0 + b < B && nn < N) {
      float v = red[0][b][c];
#pragma unroll
      for (int q = 1; q < DV_KQ; ++q) v += red[q][b][c];
      s[(size_t)(b0 + b) * N + nn] = v;
    }
  }
}

// Blocks [0, rows_blocks) reduce do1 with a warp per (b, i).  The rest sum
// do2 for 32 consecutive (b, j) each: lane over (b, j), warp w over the
// rows i = w, w + 8, ..., then the 8 warp sums in order.
__global__ void __launch_bounds__(kThreads)
kron_bwd_vec_kernel(const float* __restrict__ s, const float* __restrict__ o1,
                    const float* __restrict__ o2, float* __restrict__ do1,
                    float* __restrict__ do2, int B, int d1, int d2,
                    int rows_blocks) {
  constexpr int kWarps = kThreads / 32;
  __shared__ float red[kWarps][32];
  const size_t N = (size_t)d1 * d2;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < rows_blocks) {
    const int row = blockIdx.x * kWarps + warp;
    if (row >= B * d1) return;
    const int b = row / d1, i = row % d1;
    const float* sr = s + b * N + (size_t)i * d2;
    const float* o2r = o2 + (size_t)b * d2;
    float v = 0.f;
    for (int j = lane; j < d2; j += 32) v = fmaf(sr[j], o2r[j], v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) do1[(size_t)b * d1 + i] = v;
    return;
  }
  const int c = (blockIdx.x - rows_blocks) * 32 + lane;  // flat (b, j)
  float v = 0.f;
  if (c < B * d2) {
    const int b = c / d2, j = c % d2;
    const float* sc = s + b * N + j;
    const float* o1r = o1 + (size_t)b * d1;
#pragma unroll 4
    for (int i = warp; i < d1; i += kWarps)
      v = fmaf(sc[(size_t)i * d2], o1r[i], v);
  }
  red[warp][lane] = v;
  __syncthreads();
  if (warp == 0 && c < B * d2) {
    float t = red[0][lane];
#pragma unroll
    for (int q = 1; q < kWarps; ++q) t += red[q][lane];
    do2[c] = t;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream) of the current device.
// Each returns cudaGetLastError() after its launches: 0 when accepted.
int kron_bwd_dw(const float* o1, const float* o2, const float* g, float* dw,
                int B, int d1, int d2, int K, void* stream) {
  const dim3 grid((d1 * d2 + DW_NB - 1) / DW_NB, (K + DW_KT - 1) / DW_KT);
  kron_bwd_dw_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      o1, o2, g, dw, B, d1, d2, K);
  return (int)cudaGetLastError();
}

// s: scratch [B, d1*d2] allocated by the caller.
int kron_bwd_dvec(const float* o1, const float* o2, const float* w,
                  const float* g, float* s, float* do1, float* do2, int B,
                  int d1, int d2, int K, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int N = d1 * d2;
  const dim3 grid((N + DV_NB - 1) / DV_NB, (B + BT - 1) / BT);
  kron_bwd_s_kernel<<<grid, kThreads, 0, st>>>(w, g, s, B, N, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rows_blocks = (B * d1 + kThreads / 32 - 1) / (kThreads / 32);
  const int col_blocks = (B * d2 + 31) / 32;
  kron_bwd_vec_kernel<<<rows_blocks + col_blocks, kThreads, 0, st>>>(
      s, o1, o2, do1, do2, B, d1, d2, rows_blocks);
  return (int)cudaGetLastError();
}

const char* kron_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
