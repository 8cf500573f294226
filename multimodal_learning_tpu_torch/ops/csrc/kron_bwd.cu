// Kronecker-fusion backward for Hopper (sm_90a), fp32: the two kernels of
// the eval contraction's gradient.
//
// Replaces the Pallas TPU kernels `_bwd_dw_kernel` and `_bwd_dvec_kernel` in
// multimodal_learning_tpu/ops/kron_fusion.py (:76 and :89, launched by
// `_kron_bwd`).  With W the pofusion `encoder1` Linear weight in the torch
// layout [K, N], N = d1*d2 (W[k, i*d2 + j]), and g the output gradient
// [B, K]:
//
//   kron_bwd_dw:    dW[k, n] = sum_b g[b, k] * a[b, n],
//                   a[b, i*d2 + j] = o1[b, i] * o2[b, j]
//   kron_bwd_dvec:  s[b, n] = sum_k g[b, k] * W[k, n]
//                   do1[b, i] = sum_j s[b, i*d2 + j] * o2[b, j]
//                   do2[b, j] = sum_i s[b, i*d2 + j] * o1[b, i]
//
// dW lands in the torch layout, so it is the gradient of `encoder1.0.weight`
// as it is.  Both stay in IEEE fp32 FMA (no TF32: the JAX kernels run at
// Precision.HIGHEST) and use no atomics: every sum runs in a fixed order,
// so two launches on the same inputs give the same bits.
//
// Bounds at the paper width (B=16, d1=d2=129, K=128): kron_bwd_dw must write
// dW once, 8.52 MB, 2.55 us at 3.35 TB/s (34 M FMA, 0.5 us at 67 TFLOP/s
// fp32); kron_bwd_dvec must read W once, 8.52 MB, 2.55 us (35 M FMA).  Both
// are bound by bytes.
//
// kron_bwd_dvec design: the forward's split-column stream (kron_tma.cuh).
// - One block of 16 warps per SM owns a contiguous column range (127
//   columns at the paper width, 132 blocks) and sums s over ALL of K for
//   it, so s needs no sum across blocks and never reaches device memory.
//   The block walks units (16 batch rows x up to 128 columns) and, in each,
//   stages of 64 rows of W, loaded by TMA into a ring of 3 stages: one box
//   of 16 rows x 132 floats per residue of the row mod 4, so W's odd row
//   stride needs no alignment.  At the paper width the block's whole W
//   (67 KB) is requested at once, by thread 0 while its own set-up loads
//   are in flight; the FMAs start when the first 34 KB land.
// - Warp (r, h, e) takes the rows of residue r in half h of each stage and
//   batch rows 8e..8e+7; lane l the columns l, l+32, l+64, l+96.  A row of
//   residue r sits at one shift in its box, so the lanes of a warp read 32
//   consecutive floats (no bank conflict, whatever the shift) and g as a
//   broadcast float4: 6 shared wavefronts per 1024 FMAs.
// - At a unit's end the eight row sets' sums are added in order in shared
//   memory, which gives s, and used at once: s*o2 summed over the columns
//   of each row i gives a partial do1[b, i]; s*o1 goes to prod[b, n].  do2
//   sums prod over i, across blocks: a second pass (1.06 MB of prod, read
//   from L2, 32 interleaved runs per output added in order) launched with
//   programmatic dependent launch, so it is placed while the main pass
//   runs.  prod and do1's partials live in a scratch the caller caches.
//   A grid-wide barrier in place of the second pass was slower on the
//   card: its atomics and fences cost more than the launch it saves.
//
// kron_bwd_dw design: a rank-B product [K, B] x [B, N] whose right factor
// is formed once in shared memory, and whose rows are stored as they are
// made.
// - Two blocks per SM, each owning a contiguous column range (64 columns at
//   the paper width) for all of K.  A block forms a = o1 (x) o2 for its
//   columns and stages g (transposed), kBatch loads in flight a thread.
// - A thread's tile is 4 rows k of one residue (k = 16m + r + 4t) x one
//   aligned quad of dW's flat index: rows of one residue share their shift
//   (k*N + n0) mod 4, and a is stored at the four shifts, so the thread
//   holds a's quad for 8 batch rows in registers (one float4 each) and
//   reads g as broadcast float4s.  It finishes the tile row by row and
//   writes each row with one 16-byte streaming store (scalar stores only
//   at the range's two ragged ends), so the stores that bound the kernel
//   leave the SM from the first row on.  The warp's lanes write contiguous
//   runs of a row.
// - Nothing is summed across blocks, so there is no second pass.
#include <limits.h>

#include "kron_tma.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;           // 8 warps
constexpr int kBatch = 8;               // global loads in flight a thread

// ------------------------------------------------------------- dvec (B4)
constexpr int DV_THREADS = 512;         // 16 warps
constexpr int DV_WARPS = DV_THREADS / 32;
constexpr int DV_BT = 16;               // batch rows per unit
constexpr int DV_CW = 128;              // columns per unit: 4 per lane
constexpr int DV_PB = DV_CW + 4;        // floats per box row (shift <= 3)
constexpr int DV_KS = 64;               // rows of W per stage
constexpr int DV_BR = DV_KS / 4;        // rows per residue box
constexpr int DV_WR = DV_BR / 2;        // rows of its box a warp takes
constexpr int DV_NST = 3;               // stages in the ring
constexpr int DV_KG = 256;              // rows of g staged at a time
constexpr int DV_BOX = DV_BR * DV_PB;   // floats of one box
constexpr int DV_STAGE = 4 * DV_BOX;
constexpr int DV_RED = 8 * DV_BT * DV_CW;   // [residue + 4 * half][b][x]
constexpr size_t DV_SMEM =
    (size_t)(DV_NST * DV_STAGE + DV_RED + DV_KG * DV_BT + 2 * DV_BT * DV_CW) *
        4 +
    DV_NST * 8;
static_assert(DV_SMEM <= 232448, "shared memory");
static_assert(DV_BOX % 32 == 0, "boxes 128-byte aligned");
static_assert(DV_KG % DV_KS == 0, "g chunks hold whole stages");
static_assert(DV_THREADS == 4 * DV_CW && DV_WARPS == 16, "thread layout");

struct Maps {   // tensor maps of W, one per residue of the row mod 4
  CUtensorMap w[4];
};

// For the block's columns [n0, n1), n0 = blockIdx.x * cols, with s the
// full sum over K:
//   prod[b, n] = s[b, n] * o1[b, i(n)]            (do2's terms)
//   part1[g, b, u] = sum of s*o2 over the block's columns of row
//                    i = n0/d2 + u   (u < T1)    (do1's partial sums)
// Bit r of `w_maps` is set when map r exists (K > r).
__global__ void __launch_bounds__(DV_THREADS, 1)
kron_dvec_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ o1, const float* __restrict__ o2,
                 const float* __restrict__ g, float* __restrict__ prod,
                 float* __restrict__ part1, int B, int d1, int d2, int K,
                 int cols, int T1, int w_maps) {
  // The reduction pass may be placed now; it waits for this grid to end.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(1024) float sm[];
  float* red = sm + DV_NST * DV_STAGE;
  float* gs = red + DV_RED;                 // [k - chunk start][b]
  float* o1c = gs + DV_KG * DV_BT;          // o1[b, i(c0 + x)]
  float* o2c = o1c + DV_BT * DV_CW;         // o2[b, j(c0 + x)]
  uint64_t* full = reinterpret_cast<uint64_t*>(o2c + DV_BT * DV_CW);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = d1 * d2;
  const int n0 = blockIdx.x * cols, n1 = min(n0 + cols, N);
  const int nks = (K + DV_KS - 1) / DV_KS;
  const int ncs = (n1 - n0 + DV_CW - 1) / DV_CW;
  const int n_t = (B + DV_BT - 1) / DV_BT * ncs * nks;
  const int i_first = n0 / d2;
  // this thread's column of a unit and first batch row, in the set-up and
  // the fold: x = tid mod 128, rows bx, bx + 4, ...
  const int x = tid & (DV_CW - 1), bx = tid >> 7;

  // stage t -> batch tile b0, column start c0, row start k0
  auto decode = [&](int t, int& b0, int& c0, int& k0) {
    k0 = t % nks * DV_KS;
    c0 = n0 + t / nks % ncs * DV_CW;
    b0 = t / (nks * ncs) * DV_BT;
  };
  auto load = [&](int t) {   // by thread 0, into slot t mod NST
    int b0, c0, k0;
    decode(t, b0, c0, k0);
    float* st = sm + t % DV_NST * DV_STAGE;
    uint64_t* bar = full + t % DV_NST;
    mbar_expect_tx(bar, __popc(w_maps) * DV_BOX * 4);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (w_maps >> r & 1)
        tma_load_2d(st + r * DV_BOX, &maps.w[r], bar,
                    residue_box_x(r, N, c0), k0 / 4);
  };
  // By thread 0, between the issue of its set-up loads and their use:
  // issuing the first stages takes it longer than the loads' latency.
  auto start_ring = [&]() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (w_maps >> r & 1) prefetch_tensormap(&maps.w[r]);
    for (int s = 0; s < DV_NST; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < DV_NST && t < n_t; ++t) load(t);
  };

  // Warp (r, h, e): the rows 4m + r of each stage with m in [4h, 4h + 4)
  // and the batch rows [8e, 8e + 8); lane l the columns l + 32c.
  const int r = warp & 3, h = warp >> 2 & 1, be = warp >> 3;
  const bool has_r = w_maps >> r & 1;
  float acc[8][4];
#pragma unroll
  for (int b = 0; b < 8; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[b][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < n_t; ++t) {
    int b0, c0, k0;
    decode(t, b0, c0, k0);
    const int cw = min(DV_CW, n1 - c0);
    if (k0 % DV_KG == 0) {
      // a new chunk of g (and, at a unit's start, the unit's o1 and o2);
      // their last readers finished before an earlier __syncthreads.  Rows
      // past K up to the last stage's end are zeros, as W's are.
      const int kl = min(DV_KG, K - k0);
      const int rows = min(DV_KG, (K - k0 + DV_KS - 1) / DV_KS * DV_KS);
      // o1 and o2 are first read in the fold: their loads go out first and
      // are stored after g's, so the set-up pays one global latency
      float v1[DV_BT / 4], v2[DV_BT / 4];
      if (k0 == 0) {
        const int n = c0 + min(x, cw - 1), i = n / d2, j = n - i * d2;
#pragma unroll
        for (int u = 0; u < DV_BT / 4; ++u) {
          const int b = b0 + bx + 4 * u;
          const bool ok = b < B && x < cw;
          v1[u] = ok ? __ldg(o1 + (size_t)b * d1 + i) : 0.f;
          v2[u] = ok ? __ldg(o2 + (size_t)b * d2 + j) : 0.f;
        }
      }
      // one batch of kBatch loads a thread covers the chunk's rows
      const int gb = tid & (DV_BT - 1), kk0 = tid / DV_BT;
      const bool b_ok = b0 + gb < B;
      const float* gcol = g + (size_t)(b0 + gb) * K + k0;
      constexpr int kStep = DV_THREADS / DV_BT;
      static_assert(kBatch * kStep == DV_KG, "g chunk in one batch");
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int kk = kk0 + kStep * u;
        v[u] = b_ok && kk < kl ? __ldg(gcol + kk) : 0.f;
      }
      if (t == 0 && tid == 0) start_ring();
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (kk0 + kStep * u < rows) gs[(kk0 + kStep * u) * DV_BT + gb] = v[u];
      if (k0 == 0) {
#pragma unroll
        for (int u = 0; u < DV_BT / 4; ++u) {
          o1c[(bx + 4 * u) * DV_CW + x] = v1[u];
          o2c[(bx + 4 * u) * DV_CW + x] = v2[u];
        }
      }
      __syncthreads();
    }
    const int slot = t % DV_NST;
    mbar_wait(full + slot, t / DV_NST & 1);
    if (has_r) {
      const float* wb = sm + slot * DV_STAGE + r * DV_BOX +
                        DV_WR * h * DV_PB + ((r * (N & 3) + c0) & 3) + lane;
      const float* gr =
          gs + (k0 % DV_KG + 4 * DV_WR * h + r) * DV_BT + 8 * be;
#pragma unroll
      for (int m = 0; m < DV_WR; ++m) {
        float w[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = wb[m * DV_PB + 32 * c];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const float4 gv =
              *reinterpret_cast<const float4*>(gr + 4 * m * DV_BT + 4 * q);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[4 * q + e][c] = fmaf(g4[e], w[c], acc[4 * q + e][c]);
        }
      }
    }
    __syncthreads();   // every warp is done with this slot and with gs
    if (tid == 0 && t + DV_NST < n_t) {
      // the generic-proxy reads of the slot are done before TMA rewrites it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(t + DV_NST);
    }
    if (k0 + DV_KS < K) continue;

    // The unit's last stage: s = the eight row sets' sums in order; do2's
    // terms s*o1 go to `prod`, do1's terms s*o2 are summed over each row.
#pragma unroll
    for (int b = 0; b < 8; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        red[((r + 4 * h) * DV_BT + 8 * be + b) * DV_CW + lane + 32 * c] =
            acc[b][c];
        acc[b][c] = 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < DV_BT / 4; ++u) {
      const int e = (bx + 4 * u) * DV_CW + x;
      float s = red[e];
#pragma unroll
      for (int p = 1; p < 8; ++p) s += red[p * DV_BT * DV_CW + e];
      red[e] = s * o2c[e];
      if (x < cw && b0 + bx + 4 * u < B)
        prod[(size_t)(b0 + bx + 4 * u) * N + c0 + x] = s * o1c[e];
    }
    __syncthreads();
    // do1: a warp per (b, row i of the unit), a fixed shuffle tree
    const int ia = c0 / d2, ib = (c0 + cw - 1) / d2;
    for (int i = ia; i <= ib; ++i) {
      const int xa = max(i * d2, c0) - c0, xb = min((i + 1) * d2, c0 + cw) - c0;
      for (int b = warp; b < DV_BT && b0 + b < B; b += DV_WARPS) {
        float v = 0.f;
        for (int y = xa + lane; y < xb; y += 32) v += red[b * DV_CW + y];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(kFull, v, off);
        if (lane == 0) {
          float* dst =
              part1 + ((size_t)blockIdx.x * B + b0 + b) * T1 + (i - i_first);
          if (c0 + xa == max(i * d2, n0))   // the row's first column writes
            *dst = v;
          else
            *dst += v;
        }
      }
    }
    __syncthreads();   // red and the o1/o2 tiles are free again
  }
}

// Blocks [0, G2) sum do2 for 16 consecutive outputs (b, j) each: thread
// (slice, o) adds prod[b, i*d2 + j] for i = slice, slice + 16, ..., then
// the 16 slice sums are added in order.  The rest sum do1, a thread per
// (b, i), over the blocks that cover row i, in their order.
constexpr int kReduceOuts = 8;
constexpr int kSlices = kThreads / kReduceOuts;

__global__ void __launch_bounds__(kThreads)
kron_dvec_reduce_kernel(const float* __restrict__ prod,
                        const float* __restrict__ part1,
                        float* __restrict__ do1, float* __restrict__ do2,
                        int B, int d1, int d2, int cols, int T1, int G2) {
  __shared__ float red[kSlices][kReduceOuts];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // prod is written
  if ((int)blockIdx.x >= G2) {
    const int idx = (blockIdx.x - G2) * kThreads + threadIdx.x;
    if (idx >= B * d1) return;
    const int b = idx / d1, i = idx - b * d1;
    float v = 0.f;
    for (int blk = i * d2 / cols; blk <= ((i + 1) * d2 - 1) / cols; ++blk)
      v += part1[((size_t)blk * B + b) * T1 + (i - blk * cols / d2)];
    do1[idx] = v;
    return;
  }
  const int o = threadIdx.x % kReduceOuts, slice = threadIdx.x / kReduceOuts;
  const int idx = blockIdx.x * kReduceOuts + o;
  float v = 0.f;
  if (idx < B * d2) {
    const int b = idx / d2, j = idx - b * d2;
    const float* col = prod + (size_t)b * d1 * d2 + j;
    for (int i0 = slice; i0 < d1; i0 += kBatch * kSlices) {
      float p[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = i0 + u * kSlices;
        p[u] = i < d1 ? col[(size_t)i * d2] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) v += p[u];
    }
  }
  red[slice][o] = v;
  __syncthreads();
  if (threadIdx.x < kReduceOuts && idx < B * d2) {
    float t = red[0][o];
#pragma unroll
    for (int q = 1; q < kSlices; ++q) t += red[q][o];
    do2[idx] = t;
  }
}

// --------------------------------------------------------------- dW (B3)
constexpr int DW_BLOCKS_PER_SM = 2;
constexpr int DW_TR = 4;                  // rows k per tile, one residue
constexpr int DW_GR = 4 * DW_TR;          // rows of a group of tiles
constexpr int DW_BR = 8;                  // batch rows of a in registers
constexpr int DW_SMEM_MAX = 100 * 1024;   // per block, two blocks per SM

// Block g writes dW[:, n0:n1), n0 = g*cols, staging `bc` batch rows at a
// time (a multiple of DW_BR; rows past B are zeros): a at the four shifts,
// as_[s][b][y] = a[b, n0 + y - s], in rows of `aw` floats (4 * quads),
// and g transposed, gt[k][b].  A thread's tile is the rows
// k = GR*m + r + 4t (t < TR) of one residue r and one quad q: it holds
// a's quad for DW_BR batch rows at a time in registers and makes the tile
// row by row, storing each row as it is done.
__global__ void __launch_bounds__(kThreads, DW_BLOCKS_PER_SM)
kron_dw_kernel(const float* __restrict__ o1, const float* __restrict__ o2,
               const float* __restrict__ g, float* __restrict__ dw, int B,
               int d1, int d2, int K, int cols, int bc) {
  extern __shared__ __align__(16) float smw[];
  const int N = d1 * d2;
  const int n0 = blockIdx.x * cols, ncol = min(n0 + cols, N) - n0;
  const int nq = (ncol + 6) / 4, aw = 4 * nq;   // quads cover shifts 0..3
  const int kp = (K + DW_GR - 1) / DW_GR * DW_GR;
  float* as_ = smw;                             // [4][bc][aw]
  float* gt = smw + 4 * bc * aw;                // [kp][bc]
  const int tiles = kp / DW_TR * nq;            // (row group, quad)
  const int iters = (tiles + kThreads - 1) / kThreads;
  const int nch = (B + bc - 1) / bc;
  const int tid = threadIdx.x;

  // Staging of batch rows [b0, b0 + bc), kBatch loads in flight a thread:
  // thread (x mod 128, b parity) forms a for the columns x, x + 128, ...
  // (one division each); thread (b mod 16, k mod 16) stages g.
  auto stage = [&](int b0) {
    for (int x = tid & 127; x < aw; x += 128) {
      const int n = n0 + min(x, ncol - 1), i = n / d2, j = n - i * d2;
      for (int bb = tid >> 7; bb < bc; bb += 2 * kBatch) {
        // every load is issued (rows past B read row B - 1) before any
        // product, so the loads of a thread overlap; rows past B are zeros
        float v1[kBatch], v2[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int b = min(b0 + bb + 2 * u, B - 1);
          v1[u] = __ldg(o1 + (size_t)b * d1 + i);
          v2[u] = __ldg(o2 + (size_t)b * d2 + j);
        }
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int b = bb + 2 * u;
          v[u] = x < ncol && b < bc && b0 + b < B ? v1[u] * v2[u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int b = bb + 2 * u;
          if (b >= bc) break;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            if (x + s < aw) as_[(s * bc + b) * aw + x + s] = v[u];
            if (x < s) as_[(s * bc + b) * aw + x] = 0.f;   // leading zeros
          }
        }
      }
    }
    const int gb = tid & (DW_BR - 1);
    for (int sb = 0; sb < bc; sb += DW_BR) {
      const bool b_ok = b0 + sb + gb < B;
      const float* grow = g + (size_t)(b0 + sb + gb) * K;
      for (int k0 = tid / DW_BR; k0 < kp; k0 += kBatch * (kThreads / DW_BR)) {
        float v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + u * (kThreads / DW_BR);
          v[u] = b_ok && k < K ? __ldg(grow + k) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int k = k0 + u * (kThreads / DW_BR);
          if (k < kp) gt[k * bc + sb + gb] = v[u];
        }
      }
    }
  };

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int tile = it * kThreads + tid;
    const bool active = tile < tiles;
    const int grp = tile / nq, q = tile % nq;      // grp = 4 * (k / GR) + r
    const int r = grp & 3, kb = (grp >> 2) * DW_GR;
    const int sh = (r * (N & 3) + n0) & 3;
    const int x0 = 4 * q - sh;   // the quad's first column in the block
    float acc[DW_TR][4];
#pragma unroll
    for (int t = 0; t < DW_TR; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] = 0.f;
    for (int ch = 0; ch < nch; ++ch) {
      if (it == 0 || nch > 1) {
        if (it + ch > 0) __syncthreads();   // the last chunk's readers
        stage(ch * bc);
        __syncthreads();
      }
      if (!active) continue;
      for (int sb = 0; sb < bc; sb += DW_BR) {
        float4 av[DW_BR];
#pragma unroll
        for (int b = 0; b < DW_BR; ++b)
          av[b] = *reinterpret_cast<const float4*>(
              as_ + (sh * bc + sb + b) * aw + 4 * q);
        // the tile's rows are complete after this sub-chunk: store each
        const bool done = ch == nch - 1 && sb + DW_BR >= bc;
#pragma unroll
        for (int t = 0; t < DW_TR; ++t) {
          const int k = kb + r + 4 * t;
          const float* gk = gt + k * bc + sb;
#pragma unroll
          for (int b4 = 0; b4 < DW_BR / 4; ++b4) {
            const float4 gv = *reinterpret_cast<const float4*>(gk + 4 * b4);
            const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 a = av[4 * b4 + e];
              acc[t][0] = fmaf(g4[e], a.x, acc[t][0]);
              acc[t][1] = fmaf(g4[e], a.y, acc[t][1]);
              acc[t][2] = fmaf(g4[e], a.z, acc[t][2]);
              acc[t][3] = fmaf(g4[e], a.w, acc[t][3]);
            }
          }
          if (done && k < K) {
            float* row = dw + (size_t)k * N + n0;
            if (x0 >= 0 && x0 + 4 <= ncol) {
              __stcs(reinterpret_cast<float4*>(row + x0),
                     make_float4(acc[t][0], acc[t][1], acc[t][2], acc[t][3]));
            } else {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                if (x0 + c >= 0 && x0 + c < ncol) row[x0 + c] = acc[t][c];
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------- host side
Setup setup() {
  return setup_once([](int) {
    cudaError_t err = cudaFuncSetAttribute(
        kron_dvec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)DV_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kron_dw_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 DW_SMEM_MAX);
    return err;
  });
}

// kron_bwd_dvec's geometry for N = d1*d2 on `sms` SMs: columns and blocks,
// and the slots of do1's partials per block and batch row.
struct DvecSplit {
  int cols, blocks, T1;
};

DvecSplit dvec_split(int d1, int d2, int sms) {
  DvecSplit p;
  split(d1 * d2, sms, p.cols, p.blocks);
  p.T1 = (p.cols - 1) / d2 + 2;
  return p;
}

bool shape_ok(int B, int d1, int d2, int K) {
  const long long n = (long long)d1 * d2;
  return B > 0 && K > 0 && d1 > 0 && d2 > 0 && n <= INT_MAX - 4 &&
         (long long)B * K <= INT_MAX;
}

}  // namespace

extern "C" {

// Floats of scratch that kron_bwd_dvec needs for a batch of B on the
// current device.  A negative value is minus a CUDA error.
long long kron_bwd_dvec_scratch(int B, int d1, int d2) {
  const Setup s = setup();
  if (s.err != cudaSuccess) return -(long long)s.err;
  if (!shape_ok(B, d1, d2, 1)) return -(long long)cudaErrorInvalidValue;
  const DvecSplit p = dvec_split(d1, d2, s.sms);
  return (long long)B * d1 * d2 + (long long)p.blocks * B * p.T1;
}

// Launches on `stream` (PyTorch's current stream, passed as a pointer) of
// the current device, which the caller sets to the one holding the
// tensors.  All tensors fp32 and contiguous.  Each returns the first CUDA
// error of its set-up and launches: 0 when all were accepted.

int kron_bwd_dw(const float* o1, const float* o2, const float* g, float* dw,
                int B, int d1, int d2, int K, void* stream) {
  const Setup s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  if (!shape_ok(B, d1, d2, K) || ((uintptr_t)dw & 15))
    return (int)cudaErrorInvalidValue;
  int cols, blocks;
  split(d1 * d2, DW_BLOCKS_PER_SM * s.sms, cols, blocks);
  const long long aw = 4LL * ((cols + 6) / 4),
                  kp = (K + DW_GR - 1LL) / DW_GR * DW_GR;
  const long long row = 4 * aw + kp;   // floats per staged batch row
  const long long fit = DW_SMEM_MAX / 4 / row / DW_BR * DW_BR;
  if (fit < DW_BR) return (int)cudaErrorInvalidValue;
  const long long need = (B + DW_BR - 1LL) / DW_BR * DW_BR;
  const int bc = (int)(fit < need ? fit : need);
  kron_dw_kernel<<<blocks, kThreads, (size_t)(bc * row * 4),
                   (cudaStream_t)stream>>>(o1, o2, g, dw, B, d1, d2, K, cols,
                                           bc);
  return (int)cudaGetLastError();
}

// `part`: scratch of kron_bwd_dvec_scratch(B, d1, d2) floats; W 16-byte
// aligned.
int kron_bwd_dvec(const float* o1, const float* o2, const float* w,
                  const float* g, float* part, float* do1, float* do2, int B,
                  int d1, int d2, int K, void* stream) {
  const Setup s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  if (!shape_ok(B, d1, d2, K) || ((uintptr_t)w & 15))
    return (int)cudaErrorInvalidValue;
  const int N = d1 * d2;
  const DvecSplit p = dvec_split(d1, d2, s.sms);
  Maps maps = {};
  cudaError_t err = cudaSuccess;
  const int w_maps =
      residue_maps(s.encode, maps.w, w, K, N, DV_PB, DV_BR, err);
  if (err != cudaSuccess) return (int)err;
  float* prod = part;
  float* part1 = part + (size_t)B * N;
  const cudaStream_t st = (cudaStream_t)stream;
  kron_dvec_kernel<<<p.blocks, DV_THREADS, DV_SMEM, st>>>(
      maps, o1, o2, g, prod, part1, B, d1, d2, K, p.cols, p.T1, w_maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int g2 = (B * d2 + kReduceOuts - 1) / kReduceOuts;
  const int g1 = (B * d1 + kThreads - 1) / kThreads;
  return (int)launch_dependent(kron_dvec_reduce_kernel, dim3(g2 + g1),
                               dim3(kThreads), st, (const float*)prod,
                               (const float*)part1, do1, do2, B, d1, d2,
                               p.cols, p.T1, g2);
}

const char* kron_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
