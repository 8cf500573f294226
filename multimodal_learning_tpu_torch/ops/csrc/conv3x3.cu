// Same-pad 3x3 stride-1 convolution, 64 -> 64 channels, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` launched by `conv_pallas` in
// tools/pallas_conv_proto.py: the ResNet18 stage-1 convolution, which the
// JAX package's `--paired_conv True` routes through ops/paired_conv.py.
// It computes
//
//     y[b, h, w, co] = sum_{ky, kx, ci} x[b, h+ky-1, w+kx-1, ci] * W[co, ci, ky, kx]
//
// on NHWC activations (zero outside the image), with W in the torch layout
// [Co, Ci, 3, 3], summing in fp32 and writing y in the input's dtype.  The
// data gradient of the same convolution is this kernel again, on the
// incoming gradient with W flipped in (ky, kx) and Ci, Co swapped.
//
// Bound.  At (B, H, W) = (16, 128, 128) the work is 2*16*128^2*9*64^2 =
// 19.3 GFLOP and the bytes are x and y once each plus W: in bf16 67.2 MB,
// 20 us at 3.35 TB/s against 19.5 us of operations at 989 TFLOP/s, so it is
// bound by bytes; in fp32 134 MB (40 us) against 288 us of operations at
// the 67 TFLOP/s of fp32 outside the tensor cores, so it is bound by
// operations.
//
// Design.  One block per tile of output pixels of one image (a few rows by
// a run of columns) and all 64 output channels.  The block stages its input
// tile with a one-pixel halo (zeros outside the image) and the weights in
// shared memory, so device memory sees each input value about once (the
// halo aside) and the weights once per block (from L2).  Shared-memory rows
// are padded so that the reads of a warp fall in distinct banks.
// - bf16: tensor cores through `mma.sync.m16n8k16` (bf16 in, fp32 sums), an
//   implicit GEMM of [pixels, 9*64] by [9*64, 64].  8 warps, each 32 pixels
//   of one row by 64 channels; the 9*64 reduction walks (ky, kx) then 16
//   input channels at a time.  The output tile goes back through shared
//   memory so that stores are 16-byte and coalesced.
// - fp32: IEEE fp32 FMA (no TF32), each thread 4 pixels by 8 channels; the
//   weights are staged one ky at a time, so two blocks fit on an SM.
// Both keep a fixed summation order and use no atomics.  `wgmma`, TMA and
// overlapping the staging with the products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;  // input and output channels

// ------------------------------------------------------------- bf16 path
constexpr int MH = 4;         // output rows per block
constexpr int MW = 64;        // output columns per block
constexpr int M_THREADS = 256;
constexpr int CP = 72;        // padded channel stride in shared memory
constexpr int M_IN = (MH + 2) * (MW + 2) * CP;  // input tile, bf16 elements
constexpr int M_WT = 9 * C * CP;                // weights [tap][co][ci]
constexpr size_t M_SMEM = (size_t)(M_IN + M_WT) * 2;

__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__global__ void __launch_bounds__(M_THREADS)
conv3x3_bf16_kernel(const uint16_t* __restrict__ x,
                    const uint16_t* __restrict__ w, uint16_t* __restrict__ y,
                    int H, int W, int tiles_w) {
  extern __shared__ __align__(16) uint16_t msm[];
  uint16_t* in_s = msm;         // [(MH+2)*(MW+2) pixels][CP]
  uint16_t* w_s = msm + M_IN;   // [9 taps][64 co][CP]
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_w) * MH;
  const int x0 = (blockIdx.x % tiles_w) * MW;

  // Weights: W is [co][ci][tap] in memory; read 8 at a time in that order.
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  for (int i = threadIdx.x; i < C * C * 9 / 8; i += M_THREADS) {
    const uint4 v = __ldg(w4 + i);
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = i * 8 + q;
      const int co = e / (9 * C), r = e - co * 9 * C;
      const int ci = r / 9, tap = r - ci * 9;
      w_s[(tap * C + co) * CP + ci] =
          (uint16_t)(words[q >> 1] >> (16 * (q & 1)));
    }
  }
  // Input tile with its halo, 16 bytes (8 channels) at a time.
  for (int i = threadIdx.x; i < (MH + 2) * (MW + 2) * (C / 8);
       i += M_THREADS) {
    const int pix = i >> 3, q = i & 7;
    const int r = pix / (MW + 2), c = pix - r * (MW + 2);
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(reinterpret_cast<const uint4*>(
                    x + (((size_t)b * H + gy) * W + gx) * C) + q);
    *reinterpret_cast<uint4*>(in_s + pix * CP + q * 8) = v;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1;          // output row of this warp in the tile
  const int wc = (warp & 1) * 32;    // its first output column
  const uint32_t* in32 = reinterpret_cast<const uint32_t*>(in_s);
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w_s);
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[mt][nt][k] = 0.f;

#pragma unroll 1
  for (int tap = 0; tap < 9; ++tap) {
    const int ky = tap / 3, kx = tap - 3 * ky;
#pragma unroll
    for (int kc = 0; kc < C; kc += 16) {
      // B fragments (k = input channel, n = output channel) of 8 n-tiles
      uint32_t bf[8][2];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int e = ((tap * C + nt * 8 + g) * CP + kc + 2 * t) >> 1;
        bf[nt][0] = w32[e];
        bf[nt][1] = w32[e + 4];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // A fragment: rows are the pixels g and g+8 of this m-tile
        const int col = wc + mt * 16 + g + kx;
        const int lo = (((wr + ky) * (MW + 2) + col) * CP + kc + 2 * t) >> 1;
        const int hi = lo + 4 * CP;   // 8 pixels further: 8*CP/2 words
        const uint32_t a0 = in32[lo], a1 = in32[hi];
        const uint32_t a2 = in32[lo + 4], a3 = in32[hi + 4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma_bf16(acc[mt][nt], a0, a1, a2, a3, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // The output tile [MH*MW pixels][64] goes through shared memory (the
  // input tile's space) so that each store to y is 16 coalesced bytes.
  __syncthreads();
  uint32_t* out32 = reinterpret_cast<uint32_t*>(in_s);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = wr * MW + wc + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int co = nt * 8 + 2 * t;
      out32[(p * CP + co) >> 1] = pack_bf16(acc[mt][nt][0], acc[mt][nt][1]);
      out32[((p + 8) * CP + co) >> 1] =
          pack_bf16(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < MH * MW * (C / 8); i += M_THREADS) {
    const int p = i >> 3, q = i & 7;
    const int r = p / MW, c = p - r * MW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy < H && gx < W)
      *reinterpret_cast<uint4*>(y + (((size_t)b * H + gy) * W + gx) * C +
                                q * 8) =
          *reinterpret_cast<const uint4*>(in_s + p * CP + q * 8);
  }
}

// ------------------------------------------------------------- fp32 path
constexpr int FH = 4;          // output rows per block
constexpr int FW = 32;         // output columns per block
constexpr int F_THREADS = 256; // 32 columns x 8 groups of 8 channels
constexpr int FP = 68;         // padded channel stride of the input tile
constexpr int WP = 68;         // padded co stride of the weights
constexpr int F_IN = (FH + 2) * (FW + 2) * FP;   // floats
constexpr int F_WT = 3 * C * WP;                 // one ky: [kx][ci][co]
constexpr size_t F_SMEM = (size_t)(F_IN + F_WT) * 4;

__global__ void __launch_bounds__(F_THREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int H, int W, int tiles_w) {
  extern __shared__ __align__(16) float fsm[];
  float* in_s = fsm;          // [(FH+2)*(FW+2) pixels][FP]
  float* w_s = fsm + F_IN;    // [3 kx][64 ci][WP]
  const int b = blockIdx.y;
  const int y0 = (blockIdx.x / tiles_w) * FH;
  const int x0 = (blockIdx.x % tiles_w) * FW;

  for (int i = threadIdx.x; i < (FH + 2) * (FW + 2) * (C / 4);
       i += F_THREADS) {
    const int pix = i >> 4, q = i & 15;
    const int r = pix / (FW + 2), c = pix - r * (FW + 2);
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = __ldg(reinterpret_cast<const float4*>(
                    x + (((size_t)b * H + gy) * W + gx) * C) + q);
    *reinterpret_cast<float4*>(in_s + pix * FP + q * 4) = v;
  }

  const int cq = threadIdx.x & 7;    // output channels cq*8 .. cq*8+7
  const int pc = threadIdx.x >> 3;   // output column; rows 0 .. FH-1
  float acc[FH][8];
#pragma unroll
  for (int i = 0; i < FH; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll 1
  for (int ky = 0; ky < 3; ++ky) {
    __syncthreads();  // the input is staged; the previous ky's weights used
    // W[co][ci][ky][kx], read in memory order for this ky
    for (int i = threadIdx.x; i < 3 * C * C; i += F_THREADS) {
      const int co = i / (3 * C), r = i - co * 3 * C;
      const int ci = r / 3, kx = r - ci * 3;
      w_s[(kx * C + ci) * WP + co] = __ldg(w + co * 9 * C + ci * 9 + ky * 3 + kx);
    }
    __syncthreads();
#pragma unroll 1
    for (int kx = 0; kx < 3; ++kx) {
      const float* a_base = in_s + (ky * (FW + 2) + pc + kx) * FP;
      const float* w_base = w_s + kx * C * WP + cq * 8;
#pragma unroll 4
      for (int ci = 0; ci < C; ++ci) {
        float a[FH];
#pragma unroll
        for (int i = 0; i < FH; ++i) a[i] = a_base[i * (FW + 2) * FP + ci];
        const float4 w0 = *reinterpret_cast<const float4*>(w_base + ci * WP);
        const float4 w1 =
            *reinterpret_cast<const float4*>(w_base + ci * WP + 4);
        const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int i = 0; i < FH; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], wv[j], acc[i][j]);
      }
    }
  }

  const int gx = x0 + pc;
#pragma unroll
  for (int i = 0; i < FH; ++i) {
    const int gy = y0 + i;
    if (gy < H && gx < W) {
      float4* dst = reinterpret_cast<float4*>(
          y + (((size_t)b * H + gy) * W + gx) * C + cq * 8);
      dst[0] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      dst[1] = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

}  // namespace

extern "C" {

// y = conv3x3(x, w) on `stream` (PyTorch's current stream, passed as a
// pointer) of the current device, which the caller sets to the one holding
// the tensors.  x, y: [B, H, W, 64] contiguous (NHWC), w: [64, 64, 3, 3]
// contiguous, all 16-byte aligned and of one dtype: bf16 when `bf16` is
// non-zero, else fp32.  Returns the first CUDA error of the set-up and the
// launch: 0 when the launch was accepted.
int conv3x3_fwd(const void* x, const void* w, void* y, int B, int H, int W,
                int bf16, void* stream) {
  cudaError_t err;
  if (bf16) {
    const int tiles_w = (W + MW - 1) / MW;
    const dim3 grid(((H + MH - 1) / MH) * tiles_w, B);
    err = cudaFuncSetAttribute(conv3x3_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)M_SMEM);
    if (err != cudaSuccess) return (int)err;
    conv3x3_bf16_kernel<<<grid, M_THREADS, M_SMEM, (cudaStream_t)stream>>>(
        (const uint16_t*)x, (const uint16_t*)w, (uint16_t*)y, H, W, tiles_w);
  } else {
    const int tiles_w = (W + FW - 1) / FW;
    const dim3 grid(((H + FH - 1) / FH) * tiles_w, B);
    err = cudaFuncSetAttribute(conv3x3_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)F_SMEM);
    if (err != cudaSuccess) return (int)err;
    conv3x3_f32_kernel<<<grid, F_THREADS, F_SMEM, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)y, H, W, tiles_w);
  }
  return (int)cudaGetLastError();
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
