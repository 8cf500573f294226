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
// [Co, Ci, 3, 3], summing in fp32 and writing y in the input's dtype.  With
// `transposed` it uses W flipped in (ky, kx) with Ci and Co swapped, read in
// place while the weights are staged: the data gradient of the same
// convolution, with no flipped copy of W in device memory.
//
// Bound.  At (B, H, W) = (16, 128, 128) the work is 2*16*128^2*9*64^2 =
// 19.3 GFLOP and the bytes are x and y once each plus W: in bf16 67.2 MB,
// 20 us at 3.35 TB/s against 19.5 us of operations at 989 TFLOP/s, so it is
// bound by bytes; in fp32 134 MB (40 us) against 288 us of operations at
// the 67 TFLOP/s of fp32 outside the tensor cores, so it is bound by
// operations.
//
// Design.  Both kernels are persistent: min(#SMs, tiles) blocks, block i
// taking the contiguous run of tiles [i*n/G, (i+1)*n/G).  A tile is 4 rows x
// 64 columns of one image and all 64 output channels, and tile indices run
// down the rows of a 64-column band, so a block's next tile shares 2 halo
// rows with its last one and finds them in L2 (1024 tiles at the stage-1
// shape: 100 blocks take 8, 32 take 7).  Each block stages all 9x64x64
// weights once, so L2 serves them 132 times per call instead of once per
// tile, and reuses each staged input value for the 9 taps from shared
// memory, as the TPU kernel keeps its packed weights in VMEM across the grid
// and reuses the padded image across the three row taps.  Both keep a fixed
// schedule and summation order and use no atomics, so a call is bitwise
// reproducible.
// - bf16: warp-specialised.  A producer thread keeps a 2-stage ring of input
//   tiles in flight with TMA (`cp.async.bulk.tensor`, one box of 6 rows x 66
//   columns x 64 channels from (y0-1, x0-1): the hardware writes zeros
//   outside the tensor, so halo and ragged edges need no code), tracked by
//   full/empty `mbarrier`s; its first two loads are issued before the
//   weights are staged, and its warpgroup hands registers to the consumers
//   (`setmaxnreg`).  The weights are staged from runs of 72 bf16 (16-byte
//   loads) straight into the K-major, 128-byte-swizzled layout that a
//   `wgmma` descriptor reads, with 16-byte stores.  Two consumer warpgroups
//   each own 2 output rows (2 m-tiles of 64 pixels) and run
//   `wgmma.mma_async` m64n64k16 (bf16 in, fp32 sums): A from registers,
//   loaded with `ldmatrix` at each tap's shifted window of the swizzled tile
//   (a per-lane address), B from the resident weights; 9 taps x 4 k-steps
//   per m-tile, the next tap's A fragments loaded while the current tap's
//   products run.  The epilogue rounds to bf16 into a swizzled staging
//   buffer per warpgroup and writes it with a TMA store, which clips rows
//   and columns outside the image and overlaps the next tile's loads and
//   products.  Shared memory: 72 KB of weights, 2 x 50 KB of input stages,
//   2 x 16 KB of output staging.  What holds it above its bound: with 64
//   output channels the product is a skinny GEMM (N = 64), so every m64n64k16
//   reads 2 KB of B through its descriptor and 2 KB of A through `ldmatrix`,
//   as many shared-memory bytes per cycle as the SM can serve at the tensor
//   cores' rate.
// - fp32: IEEE FMA (no TF32).  The weights stay resident as [tap][ci][co]
//   (144 KB), staged with 12 16-byte loads in flight per thread; the input
//   streams through a 2-stage `cp.async` ring in chunks of 16 channels
//   (6 x 66 pixels each), so copies overlap FMAs.  Each thread owns 8 pixels
//   of one row x 8 output channels: per 4 input channels and one ky it loads
//   the 10 pixels its 3 kx taps need once (10 LDS.128) and the weights as 2
//   LDS.128 per (kx, ci), 768 FMAs per 34 LDS.128.  It is bound by FMA
//   issue.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int C = 64;        // input and output channels
constexpr int TR = 4;        // output rows per tile
constexpr int TW = 64;       // output columns per tile
constexpr int IR = TR + 2;   // staged input rows (halo included)
constexpr int IW = TW + 2;   // staged input columns

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Walks W in memory order, W[a][b][t]: element (a, b, t) is weight (co,
// ci, tap) = (a, b, t), or (b, a, 8 - t) when `transposed`.
struct WeightIndex {
  int a, b, t;
  __device__ __forceinline__ explicit WeightIndex(int e) {
    a = e / (9 * C);
    const int r = e - a * 9 * C;
    b = r / 9;
    t = r - b * 9;
  }
  __device__ __forceinline__ void next() {
    if (++t == 9) { t = 0; ++b; }
  }
  __device__ __forceinline__ void coords(int transposed, int& tap, int& co,
                                         int& ci) const {
    co = transposed ? b : a;
    ci = transposed ? a : b;
    tap = transposed ? 8 - t : t;
  }
};

// ------------------------------------------------------------- bf16 path
constexpr int B_CONSUMERS = 2;                       // warpgroups
constexpr int B_THREADS = 128 * (B_CONSUMERS + 1);   // + the producer's
constexpr int B_WT_BYTES = 9 * C * C * 2;            // 73 728
constexpr int B_IN_BYTES = IR * IW * C * 2;        // 50 688, one TMA box
constexpr int B_IN_STRIDE = (B_IN_BYTES + 1023) / 1024 * 1024;
constexpr int B_OUT_ROWS = TR / B_CONSUMERS;       // rows per warpgroup
constexpr int B_OUT_BYTES = B_OUT_ROWS * TW * C * 2; // 16 384
constexpr int B_STAGES = 2;
constexpr int B_OFF_IN = B_WT_BYTES;
constexpr int B_OFF_OUT = B_OFF_IN + B_STAGES * B_IN_STRIDE;
constexpr int B_OFF_BAR = B_OFF_OUT + B_CONSUMERS * B_OUT_BYTES;
constexpr size_t B_SMEM = B_OFF_BAR + 4 * 8 + 1024;  // + alignment slack
static_assert(B_WT_BYTES % 1024 == 0 && B_OFF_OUT % 1024 == 0, "align");
static_assert(B_SMEM <= 232448, "shared memory");

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%1, %2, %3, %4}], [%5];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(src)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t* a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Descriptor of a K-major, 128-byte-swizzled B operand: 8-row groups 1024
// bytes apart (SBO), leading offset unused by this layout.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 64] += A[64 x 16] (registers) * B[16 x 64] (shared, descriptor)
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a,
                                                uint64_t desc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Byte offset of 16-byte chunk `c` of 128-byte row `row` under the
// 128-byte swizzle that TMA applies (chunk index XOR row mod 8).
__device__ __forceinline__ uint32_t swz(int row, int c) {
  return (uint32_t)(row * 128 + ((c ^ (row & 7)) << 4));
}

// Tile t of an image's column band runs down the rows: vertically adjacent
// tiles have adjacent indices, so a block that walks a run of them finds the
// halo rows it shares with the previous tile in L2.
__device__ __forceinline__ void tile_coords(int t, int tiles_w, int tiles_h,
                                            int& b, int& y0, int& x0) {
  const int ty = t % tiles_h, r = t / tiles_h;
  y0 = ty * TR;
  x0 = (r % tiles_w) * TW;
  b = r / tiles_w;
}

// This block's tiles: the contiguous run [begin, end), the runs of all
// blocks balanced to within one tile.
__device__ __forceinline__ void block_tiles(int n_tiles, int& begin,
                                            int& end) {
  begin = (int)((long long)blockIdx.x * n_tiles / gridDim.x);
  end = (int)((long long)(blockIdx.x + 1) * n_tiles / gridDim.x);
}

// A fragments of one tap (ky, kx) for the warpgroup's 2 m-tiles and 4
// k-steps.  Row m of m-tile j is output pixel (row0 + j, m); its input for
// the tap is staged pixel (row0 + j + ky) * IW + m + kx.
__device__ __forceinline__ void load_a(uint32_t in_base, int row0, int tap,
                                       int m, int khalf, uint32_t (*a)[4][4]) {
  const int ky = tap / 3, kx = tap - 3 * (tap / 3);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = (row0 + j + ky) * IW + m + kx;
#pragma unroll
    for (int s = 0; s < 4; ++s) ldmatrix_x4(in_base + swz(p, 2 * s + khalf), a[j][s]);
  }
}

__global__ void __launch_bounds__(B_THREADS, 1)
conv3x3_bf16_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap y_map,
                    const uint16_t* __restrict__ w, int transposed,
                    int tiles_w, int tiles_h, int n_tiles) {
  extern __shared__ uint8_t bsm_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(bsm_raw) + 1023) & ~(uintptr_t)1023);
  const uint32_t w_base = smem_u32(sm);
  const uint32_t in_base = w_base + B_OFF_IN;
  const uint32_t out_base = w_base + B_OFF_OUT;
  const uint32_t full_bar = w_base + B_OFF_BAR;    // [2]
  const uint32_t empty_bar = full_bar + 16;        // [2]
  const int tid = threadIdx.x;

  const int warp = tid >> 5, lane = tid & 31;
  // Tile begin + k of the block's run goes through stage k % 2 to both
  // consumer warpgroups.
  int begin, end;
  block_tiles(n_tiles, begin, end);
  const bool loader = warp == 4 * B_CONSUMERS && lane == 0;
  auto load = [&](int k) {
    const int s = k % B_STAGES;
    mbar_expect_tx(full_bar + 8 * s, B_IN_BYTES);
    int b, y0, x0;
    tile_coords(begin + k, tiles_w, tiles_h, b, y0, x0);
    tma_load_4d(in_base + s * B_IN_STRIDE, &x_map, full_bar + 8 * s, 0,
                x0 - 1, y0 - 1, b);
  };
  if (loader) {   // the first tiles' loads overlap the weights' staging
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 4 * B_CONSUMERS);  // one per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int k = 0; k < B_STAGES && begin + k < end; ++k) load(k);
  }
  // Weights once per block.  A work item is one run of 72 bf16 of W in
  // memory order, W[a][8k .. 8k+7][0 .. 8], read as 9 16-byte loads; its
  // element 9u + t is W[a][8k + u][t].  Forward, that is (co, ci, tap) =
  // (a, 8k + u, t): for each tap the run holds one whole 16-byte chunk of
  // the [tap][co][ci] layout (ci = 8k .. 8k+7), stored at once; the 8 lanes
  // of a store phase take the 8 chunks of one row, distinct banks under the
  // swizzle.  Transposed it is (co, ci, tap) = (8k + u, a, 8 - t): 2-byte
  // stores, the lanes taking consecutive ci of one row.
  const uint4* w4 = reinterpret_cast<const uint4*>(w);
  for (int item = tid; item < C * 8; item += B_THREADS) {
    const int a = transposed ? item % C : item / 8;
    const int k = transposed ? item / C : item % 8;
    uint32_t e[36];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const uint4 v = __ldg(w4 + a * 72 + k * 9 + j);
      e[4 * j] = v.x; e[4 * j + 1] = v.y; e[4 * j + 2] = v.z; e[4 * j + 3] = v.w;
    }
    auto elem = [&](int i) { return (e[i >> 1] >> (16 * (i & 1))) & 0xFFFFu; };
    if (!transposed) {
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        uint32_t q[4];
#pragma unroll
        for (int u = 0; u < 8; u += 2)
          q[u / 2] = elem(9 * u + t) | (elem(9 * (u + 1) + t) << 16);
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                         w_base + t * C * C * 2 + swz(a, k)),
                     "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]));
      }
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int t = 0; t < 9; ++t)
          asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(
                           w_base + (8 - t) * C * C * 2 +
                           swz(8 * k + u, a >> 3) + (a & 7) * 2),
                       "h"((uint16_t)elem(9 * u + t)));
    }
  }
  // the weights are read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  if (warp >= 4 * B_CONSUMERS) {
    // ---- producer warpgroup: it gives its registers to the consumers, and
    // one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (loader) {
      for (int k = B_STAGES; begin + k < end; ++k) {
        mbar_wait(empty_bar + 8 * (k % B_STAGES), ((k / B_STAGES) & 1) ^ 1);
        load(k);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns output rows 2*wg, 2*wg+1 of a tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, wq = warp & 3, tig = tid & 127;
  const int row0 = B_OUT_ROWS * wg;
  const int m = 16 * wq + (lane & 15);   // this lane's ldmatrix row
  const int khalf = lane >> 4;
  const int g = lane >> 2, t4 = lane & 3;
  const uint32_t stage_out = out_base + wg * B_OUT_BYTES;
  float acc[2][32];
  uint32_t a[2][2][4][4];   // [buffer][m-tile][k-step][reg]
  for (int t = begin, i = 0; t < end; ++t, ++i) {
    const int s = i & 1;
    const uint32_t tile_in = in_base + s * B_IN_STRIDE;
    mbar_wait(full_bar + 8 * s, (i >> 1) & 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[j][k] = 0.f;
    load_a(tile_in, row0, 0, m, khalf, a[0]);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int buf = tap & 1;
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t desc = b_desc(w_base + tap * C * C * 2 + ks * 32);
        wgmma_m64n64k16(acc[0], a[buf][0][ks], desc);
        wgmma_m64n64k16(acc[1], a[buf][1][ks], desc);
      }
      wgmma_commit();
      fence_acc(acc[0]);
      fence_acc(acc[1]);
      if (tap + 1 < 9) {
        wgmma_wait<1>();   // the products that read a[buf ^ 1] are done
        load_a(tile_in, row0, tap + 1, m, khalf, a[buf ^ 1]);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc[0]);
    fence_acc(acc[1]);
    // this warp has read the stage: release it to the producer
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);

    // epilogue: the previous tile's store must have read the staging buffer
    if (tig == 0) bulk_wait_read();
    named_sync(1 + wg);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = j * TW + 16 * wq + g;   // pixel in the staging box
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage_out + swz(q, n) +
                                                        4 * t4),
                     "r"(pack_bf16(acc[j][4 * n], acc[j][4 * n + 1])));
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage_out +
                                                        swz(q + 8, n) + 4 * t4),
                     "r"(pack_bf16(acc[j][4 * n + 2], acc[j][4 * n + 3])));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    named_sync(1 + wg);
    if (tig == 0) {
      int b, y0, x0;
      tile_coords(t, tiles_w, tiles_h, b, y0, x0);
      tma_store_4d(&y_map, stage_out, 0, x0, y0 + row0, b);
    }
  }
  if (tig == 0) bulk_wait_all();
}

// ------------------------------------------------------------- fp32 path
constexpr int F_THREADS = 256;   // 32 pixel groups (8 pixels) x 8 co groups
constexpr int F_CH = 16;         // input channels per streamed chunk
constexpr int F_PITCH = 20;      // floats per staged pixel (16 + 4 padding)
constexpr int F_CHUNKS = C / F_CH;
constexpr int F_WT = 9 * C * C;                 // floats, [tap][ci][co]
constexpr int F_IN = IR * IW * F_PITCH;       // floats per stage
constexpr size_t F_SMEM = (size_t)(F_WT + 2 * F_IN) * 4;
static_assert(F_SMEM <= 232448, "shared memory");

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

// Stage chunk `ch` (channels 16*ch ..) of the input tile at (b, y0, x0),
// halo included, zeros outside the image.
__device__ __forceinline__ void load_chunk(const float* __restrict__ x,
                                           float* dst, int b, int y0, int x0,
                                           int ch, int H, int W) {
  for (int i = threadIdx.x; i < IR * IW * (F_CH / 4); i += F_THREADS) {
    const int pix = i >> 2, q = i & 3;
    const int r = pix / IW, c = pix - r * IW;
    const int gy = y0 - 1 + r, gx = x0 - 1 + c;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float* src =
        in ? x + (((size_t)b * H + gy) * W + gx) * C + ch * F_CH + q * 4 : x;
    cp_async16(smem_u32(dst + pix * F_PITCH + q * 4), src, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(F_THREADS, 1)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   float* __restrict__ y, int transposed, int H, int W,
                   int tiles_w, int tiles_h, int n_tiles) {
  extern __shared__ __align__(16) float fsm[];
  float* w_s = fsm;              // [9 taps][64 ci][64 co]
  float* in_s = fsm + F_WT;      // [2 stages][IR * IW pixels][F_PITCH]
  const int tid = threadIdx.x;
  int t, end;
  block_tiles(n_tiles, t, end);
  const int n_chunks = (end - t) * F_CHUNKS;
  int b, y0, x0;
  if (n_chunks) {
    tile_coords(t, tiles_w, tiles_h, b, y0, x0);
    load_chunk(x, in_s, b, y0, x0, 0, H, W);
  }
  // Weights once per block: 16-byte loads, 12 of a thread's in flight at a
  // time.  The lanes of a warp should store to distinct banks, so to
  // different co of one [tap][ci] row of w_s.  Item n is float4 n / 64 of
  // W's row a = n % 64 (the row's 144 float4s hold its (b, t) in memory
  // order): the lanes vary co = a.  Transposed, co = b, which varies along
  // a row: item n is float4 n in memory order.
  constexpr int W_BATCH = 12, W_ROW = 9 * C / 4;
  static_assert(C * C * 9 / 4 % (W_BATCH * F_THREADS) == 0, "weight split");
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll 1
  for (int n0 = 0; n0 < C * C * 9 / 4; n0 += W_BATCH * F_THREADS) {
    float4 wv[W_BATCH];
#pragma unroll
    for (int j = 0; j < W_BATCH; ++j) {
      const int n = n0 + tid + j * F_THREADS;
      wv[j] = __ldg(w4 + (transposed ? n : (n % C) * W_ROW + n / C));
    }
#pragma unroll
    for (int j = 0; j < W_BATCH; ++j) {
      const float vals[4] = {wv[j].x, wv[j].y, wv[j].z, wv[j].w};
      const int n = n0 + tid + j * F_THREADS;
      WeightIndex wi((transposed ? n : (n % C) * W_ROW + n / C) * 4);
#pragma unroll
      for (int q = 0; q < 4; ++q, wi.next()) {
        int tap, co, ci;
        wi.coords(transposed, tap, co, ci);
        w_s[(tap * C + ci) * C + co] = vals[q];
      }
    }
  }

  // Thread: output channels 4*cq .. +3 and 32 + 4*cq .. +3 (the 8 lanes of
  // a quarter-warp read one contiguous 128-byte run of a weight row), and 8
  // pixels (row pr, columns 8*pc .. +7) of the tile.
  const int warp = tid >> 5, lane = tid & 31;
  const int cq = lane & 7;
  const int pg = warp * 4 + (lane >> 3);
  const int pr = pg >> 3, pc = (pg & 7) * 8;
  float acc[8][8];
#pragma unroll
  for (int p = 0; p < 8; ++p)
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[p][k] = 0.f;

  for (int j = 0; j < n_chunks; ++j) {
    const int ch = j % F_CHUNKS;
    if (j + 1 < n_chunks) {   // the next chunk, maybe of the next tile
      const int ch1 = (j + 1) % F_CHUNKS;
      int b1 = b, y1 = y0, x1 = x0;
      if (ch1 == 0)
        tile_coords(t + 1, tiles_w, tiles_h, b1, y1, x1);
      load_chunk(x, in_s + ((j + 1) & 1) * F_IN, b1, y1, x1, ch1, H, W);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    const float* in = in_s + (j & 1) * F_IN;
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky) {
      const float* arow = in + ((pr + ky) * IW + pc) * F_PITCH;
#pragma unroll 1
      for (int c4 = 0; c4 < F_CH; c4 += 4) {
        float4 a[10];
#pragma unroll
        for (int p = 0; p < 10; ++p)
          a[p] = *reinterpret_cast<const float4*>(arow + p * F_PITCH + c4);
        const float* wrow = w_s + (ky * 3 * C + ch * F_CH + c4) * C + 4 * cq;
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            const float* wp = wrow + (kx * C + cc) * C;
            const float4 w0 = *reinterpret_cast<const float4*>(wp);
            const float4 w1 = *reinterpret_cast<const float4*>(wp + 32);
            const float wv[8] = {w0.x, w0.y, w0.z, w0.w,
                                 w1.x, w1.y, w1.z, w1.w};
#pragma unroll
            for (int p = 0; p < 8; ++p) {
              const float4 av = a[p + kx];
              const float s = cc == 0 ? av.x : cc == 1 ? av.y
                            : cc == 2 ? av.z : av.w;
#pragma unroll
              for (int k = 0; k < 8; ++k) acc[p][k] = fmaf(s, wv[k], acc[p][k]);
            }
          }
        }
      }
    }
    if (ch == F_CHUNKS - 1) {
      const int gy = y0 + pr;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const int gx = x0 + pc + p;
        if (gy < H && gx < W) {
          float* dst = y + (((size_t)b * H + gy) * W + gx) * C + 4 * cq;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
          *reinterpret_cast<float4*>(dst + 32) =
              make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[p][k] = 0.f;
      }
      if (++t < end) tile_coords(t, tiles_w, tiles_h, b, y0, x0);
    }
    __syncthreads();   // the stage just read is the next load's target
  }
}

// ------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// Set up once per process and device, not per launch: the device's SM
// count, the kernels' shared-memory limits, and `cuTensorMapEncodeTiled`
// (reached through the runtime, so the library needs no -lcuda).
struct Setup {
  cudaError_t err = cudaSuccess;
  int sms = 0;
  EncodeTiled encode = nullptr;
};

Setup make_setup(int dev) {
  Setup s;
  if ((s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess)
    return s;
  if ((s.err = cudaFuncSetAttribute(conv3x3_bf16_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)B_SMEM)) != cudaSuccess)
    return s;
  if ((s.err = cudaFuncSetAttribute(conv3x3_f32_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)F_SMEM)) != cudaSuccess)
    return s;
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
  s.err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn,
                                           12000, cudaEnableDefault, &found);
  if (s.err == cudaSuccess && (found != cudaDriverEntryPointSuccess || !fn))
    s.err = cudaErrorSymbolNotFound;
  s.encode = reinterpret_cast<EncodeTiled>(fn);
  return s;
}

constexpr int MAX_DEVICES = 64;

Setup setup() {
  static std::once_flag once[MAX_DEVICES];
  static Setup done[MAX_DEVICES];
  Setup s;
  int dev = 0;
  if ((s.err = cudaGetDevice(&dev)) != cudaSuccess) return s;
  if (dev < 0 || dev >= MAX_DEVICES) {
    s.err = cudaErrorInvalidDevice;
    return s;
  }
  std::call_once(once[dev], [dev] { done[dev] = make_setup(dev); });
  return done[dev];
}

// Tensor map of an NHWC bf16 tensor [B, H, W, 64] with a box of
// (64 channels, bw columns, bh rows, 1 image) and the 128-byte swizzle;
// elements outside the tensor read as zero and are not written.
cudaError_t nhwc_map(EncodeTiled encode, CUtensorMap* map, const void* p,
                     int B, int H, int W, int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C, (cuuint32_t)bw, (cuuint32_t)bh, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// y = conv3x3(x, w) on `stream` (PyTorch's current stream, passed as a
// pointer) of the current device, which the caller sets to the one holding
// the tensors.  x, y: [B, H, W, 64] contiguous (NHWC), w: [64, 64, 3, 3]
// contiguous, all 16-byte aligned and of one dtype: bf16 when `bf16` is
// non-zero, else fp32.  With `transposed` non-zero, W is read flipped in
// (ky, kx) with its two channel axes swapped.  Returns the first CUDA error
// of the set-up and the launch: 0 when the launch was accepted.
int conv3x3_fwd(const void* x, const void* w, void* y, int B, int H, int W,
                int bf16, int transposed, void* stream) {
  const Setup s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  const int tiles_w = (W + TW - 1) / TW, tiles_h = (H + TR - 1) / TR;
  const long long n = (long long)tiles_w * tiles_h * B;
  if (n <= 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
  const int n_tiles = (int)n;
  const int grid = n_tiles < s.sms ? n_tiles : s.sms;
  if (bf16) {
    CUtensorMap x_map, y_map;
    cudaError_t err = nhwc_map(s.encode, &x_map, x, B, H, W, IW, IR);
    if (err == cudaSuccess)
      err = nhwc_map(s.encode, &y_map, y, B, H, W, TW, B_OUT_ROWS);
    if (err != cudaSuccess) return (int)err;
    conv3x3_bf16_kernel<<<grid, B_THREADS, B_SMEM, (cudaStream_t)stream>>>(
        x_map, y_map, (const uint16_t*)w, transposed, tiles_w, tiles_h,
        n_tiles);
  } else {
    conv3x3_f32_kernel<<<grid, F_THREADS, F_SMEM, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)w, (float*)y, transposed, H, W,
        tiles_w, tiles_h, n_tiles);
  }
  return (int)cudaGetLastError();
}

const char* conv3x3_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
