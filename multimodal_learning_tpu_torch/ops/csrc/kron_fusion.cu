// Kronecker-fusion eval forward for Hopper (sm_90a), fp32.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` in
// multimodal_learning_tpu/ops/kron_fusion.py (launched by `kron_matmul`).
// It computes
//
//     y[b, k] = sum_i o1[b, i] * sum_j o2[b, j] * W[k, i*d2 + j] + bias[k]
//
// with W the pofusion `encoder1` Linear weight read in place, in the torch
// layout [K, d1*d2] (row-major over (i, j)).  The Kronecker vector
// vec(o1 o2^T) is never formed in device memory.
//
// Bound.  At the paper width (B=16, d1=d2=129, K=128) the kernel must read
// W once: 8.52 MB, about 2.5 us at 3.35 TB/s.  The arithmetic is about
// 68 MFLOP, about 1 us at the card's 67 TFLOP/s of fp32 outside the tensor
// cores.  So it is bound by bytes.  It stays in IEEE fp32 FMA (no TF32, no
// tensor cores) because the JAX kernel runs Precision.HIGHEST.
//
// Design.  One block per output column k, so W's row k (16641 floats) is
// read by one block, once per tile of BT batch rows, and no two blocks
// share an output: no atomics, and the sum order is fixed (deterministic).
// Lanes of a warp take 32 consecutive j, warps take rows i, so each warp's
// load of W is one coalesced 128-byte line.  A thread keeps o2[b, j] of its
// NCH column chunks in registers and forms the row product
// t[b] = sum_j W[k,i,j] o2[b,j] before it multiplies by o1[b,i] (read as a
// warp-wide broadcast from shared memory), so the inner loop is about one
// FMA per W element and batch row.  A fixed-order block reduction writes
// y[b,k] + bias[k].  Loops over b tiles, j groups and i tiles take any B,
// d1, d2 and K; ragged edges are masked.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;            // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int BT = 16;                   // batch rows per tile
constexpr int NCH = 5;                   // 32-wide j chunks held per thread
constexpr int IT = 128;                  // o1 rows (i) staged per smem tile

__global__ void __launch_bounds__(kThreads)
kron_fwd_kernel(const float* __restrict__ o1, const float* __restrict__ o2,
                const float* __restrict__ w, const float* __restrict__ bias,
                float* __restrict__ y, int B, int d1, int d2, int K) {
  __shared__ __align__(16) float o1s[IT * BT];  // o1s[ii * BT + b]
  __shared__ float red[BT][kWarps];

  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* wk = w + (size_t)k * d1 * d2;

  for (int b0 = 0; b0 < B; b0 += BT) {
    float acc[BT];
#pragma unroll
    for (int b = 0; b < BT; ++b) acc[b] = 0.f;

    for (int jg = 0; jg < d2; jg += 32 * NCH) {
      float o2r[NCH][BT];
#pragma unroll
      for (int m = 0; m < NCH; ++m) {
        const int j = jg + 32 * m + lane;
#pragma unroll
        for (int b = 0; b < BT; ++b)
          o2r[m][b] = (j < d2 && b0 + b < B) ? o2[(size_t)(b0 + b) * d2 + j]
                                             : 0.f;
      }

      for (int i0 = 0; i0 < d1; i0 += IT) {
        __syncthreads();  // the previous tile's readers are done
        for (int idx = threadIdx.x; idx < IT * BT; idx += kThreads) {
          const int ii = idx / BT, b = idx % BT;
          const int i = i0 + ii;
          o1s[idx] = (i < d1 && b0 + b < B) ? o1[(size_t)(b0 + b) * d1 + i]
                                            : 0.f;
        }
        __syncthreads();

        const int iend = min(IT, d1 - i0);
#pragma unroll 2
        for (int ii = warp; ii < iend; ii += kWarps) {
          const float* row = wk + (size_t)(i0 + ii) * d2 + jg + lane;
          float wv[NCH];
#pragma unroll
          for (int m = 0; m < NCH; ++m)
            wv[m] = (jg + 32 * m + lane < d2) ? __ldg(row + 32 * m) : 0.f;
          float t[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            float s = 0.f;
#pragma unroll
            for (int m = 0; m < NCH; ++m) s = fmaf(wv[m], o2r[m][b], s);
            t[b] = s;
          }
          const float4* o1v = reinterpret_cast<const float4*>(o1s + ii * BT);
#pragma unroll
          for (int q = 0; q < BT / 4; ++q) {
            const float4 v = o1v[q];
            acc[4 * q + 0] = fmaf(v.x, t[4 * q + 0], acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(v.y, t[4 * q + 1], acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(v.z, t[4 * q + 2], acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(v.w, t[4 * q + 3], acc[4 * q + 3]);
          }
        }
      }
    }

    // Block reduction in a fixed order: warp shuffles, then across warps.
#pragma unroll
    for (int b = 0; b < BT; ++b) {
      float v = acc[b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[b][warp] = v;
    }
    __syncthreads();
    if (threadIdx.x < BT && b0 + threadIdx.x < B) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kWarps; ++q) s += red[threadIdx.x][q];
      y[(size_t)(b0 + threadIdx.x) * K + k] = s + bias[k];
    }
    __syncthreads();  // red is reused by the next b tile
  }
}

}  // namespace

extern "C" {

// Launches on `stream` (PyTorch's current stream, passed as a pointer) of
// the current device, which the caller sets to the one holding the tensors.
// Returns cudaGetLastError() after the launch: 0 when it was accepted.
int kron_fwd(const float* o1, const float* o2, const float* w,
             const float* bias, float* y, int B, int d1, int d2, int K,
             void* stream) {
  kron_fwd_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      o1, o2, w, bias, y, B, d1, d2, K);
  return (int)cudaGetLastError();
}

const char* kron_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
