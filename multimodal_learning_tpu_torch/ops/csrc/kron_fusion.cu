// Kronecker-fusion forward for Hopper (sm_90a), fp32: the eval contraction
// (`kron_fwd`) and the masked train contraction (`kron_train_fwd`) as one
// split-column skinny GEMM.
//
// Replaces two Pallas TPU kernels of multimodal_learning_tpu/ops/
// kron_fusion.py: `_fwd_kernel` (:46, launched by `kron_matmul`) and
// `_fwd_train_kernel` (:164, launched by `kron_matmul_dropout`).  Both are
//
//     y[b, k] = sum_n a[b, n] * W[k, n] + bias[k],
//     a[b, n] = o1[b, i] * o2[b, j] * m[b, n],   n = i*d2 + j,
//
// with W the pofusion `encoder1` Linear weight read in place, in the torch
// layout [K, N], N = d1*d2, and m the pre-scaled dropout mask [B, N].  The
// eval kernel is the same template with no mask: no mask bytes are read.  a
// is formed in shared memory only; it never reaches device memory.
//
// Bound.  At the paper width (B=16, d1=d2=129, K=128) the kernel must read
// W once (8.52 MB), and the mask (1.06 MB) when masked: 2.55 / 2.87 us at
// 3.35 TB/s.  Its 34 M FMAs take about 1.0 us at the card's 67 TFLOP/s of
// fp32 outside the tensor cores.  So it is bound by bytes.  It stays in IEEE
// fp32 FMA (no TF32, no tensor cores): the JAX kernels run Precision.HIGHEST.
//
// Design.
// - One wave over every SM.  The grid is about the SM count, and block g
//   owns the columns [g*cols, (g+1)*cols) for all K (127 columns at the
//   paper width, 132 blocks), so every byte of W and of m is read once per
//   tile of 16 batch rows and every SM streams.  The block walks work units
//   (16 batch rows x 128 outputs) and, in each, stages of CS = 60 columns.
// - W in flight while the FMAs run, by TMA.  One thread keeps a ring of
//   NST = 3 stages loading, tracked by mbarriers, while all eight warps
//   multiply.  (With cp.async a warp keeps only a few copies in flight, so
//   the warps would stall issuing them instead of multiplying.)  For odd N,
//   W's row k starts at byte 4*N*k, which is not
//   16-byte aligned, so no tensor map can step from row to row.  But rows
//   k = 4m + r of one residue r are 16*N bytes apart, so each residue gets
//   its own 2-D tensor map, based at the aligned float at or before row r's
//   start, and a stage is four boxes of 32 rows x 68 floats.  The box of
//   residue r starts at the aligned column at or before the stage's first,
//   so its rows sit at a shift s_r = (r*N + c0) mod 4 in the box; the shift
//   is fixed within a block.  A thread's rows of W all have one residue,
//   and it reads a from a copy of a shifted by s_r: a is stored four times,
//   at shifts 0..3.  Columns outside the stage are 0 in a, so the box's
//   extra W values add nothing; rows and columns past the tensor load as
//   zeros.  The mask is loaded the same way (four boxes of 4 batch rows),
//   and a = o1*o2*m is formed from it and from o1 and o2, which are read
//   through L1 one stage ahead.
// - Register tiles.  A thread holds 8 (b) x 8 (k) accumulators and reads,
//   per 4 columns, 8 float4 of a and 8 float4 of W for 256 FMAs.  Box rows
//   are 68 floats and a thread's rows are rotated by its residue, so a
//   quarter-warp's float4 reads hit distinct banks: a warp's 16 loads cost
//   64 shared wavefronts per 256 FMA instructions: on paper shared memory
//   and the FMA pipes are matched.  Each warp takes two quads of columns of
//   a stage; the eight warps are added in the block in a fixed order at the
//   end of each unit.
// - Partials.  Each block writes one [B, K] tile of partial sums to `part`
//   (held by the caller; 1.08 MB at the paper width, so it stays in L2).  A
//   second kernel adds them in the order of the blocks, with the bias.  It
//   is launched with programmatic dependent launch: its blocks are placed
//   while the main pass runs and wait at `griddepcontrol.wait`, so no launch
//   gap remains.  No atomics: two launches on the same inputs give the same
//   bits.
#include <limits.h>

#include "kron_tma.cuh"

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int BT = 16;         // batch rows per work unit
constexpr int KT = 128;        // outputs per work unit
constexpr int CS = 60;         // columns per stage
constexpr int WIN = CS + 4;    // floats of a row a stage reads
constexpr int QPW = WIN / 4 / (kThreads / 32);   // quads per warp
constexpr int NST = 3;         // stages in the ring
constexpr int P = WIN + 4;     // floats per box row (the box's width)
constexpr int W_BOX = KT / 4 * P;        // floats of one residue's W box
constexpr int M_BOX = 288;               // one mask box (4 rows), padded
constexpr int STAGE = 4 * W_BOX + 4 * M_BOX;
constexpr int SA = BT * P + 8;           // floats per shifted copy of a
constexpr int A_BUF = 4 * SA;            // a at shifts 0..3
constexpr int RP = KT + 16;              // floats per row of the reduction
constexpr int RED = 8 * BT * RP;         // [warp][b][k]
constexpr size_t SMEM =
    (size_t)(NST * STAGE + 2 * A_BUF + RED) * 4 + NST * 8;
static_assert(SMEM <= 232448, "shared memory");
static_assert(WIN / 4 == QPW * (kThreads / 32), "quads split by warps");
static_assert(BT * WIN / 4 <= kThreads, "one mask quad per thread");
static_assert(W_BOX % 32 == 0 && M_BOX % 32 == 0 && M_BOX >= BT / 4 * P,
              "boxes 128-byte aligned");
static_assert(SA % 32 == 8 && P % 32 == 4 && RP % 32 == 16, "banks");
static_assert(CS % 4 == 0, "shifts fixed within a block");

struct Maps {   // tensor maps of W and m, one per residue of the row mod 4
  CUtensorMap w[4], m[4];
};

// A block's stages in order: work units (batch tile b0, output tile k0),
// each over the block's columns [n0, n1) in stages of CS, starting at c0.
struct Cursor {
  int n0, n1, K, b0 = 0, k0 = 0, c0;
  __device__ Cursor(int n0_, int n1_, int K_) : n0(n0_), n1(n1_), K(K_),
                                                c0(n0_) {}
  __device__ bool last() const { return c0 + CS >= n1; }
  // Advances; returns true when a new unit begins.
  __device__ bool next() {
    if (!last()) {
      c0 += CS;
      return false;
    }
    c0 = n0;
    if ((k0 += KT) >= K) k0 = 0, b0 += BT;
    return true;
  }
};

// Partial sums of block g over its columns: part[g, b, k] for all b < B,
// k < K.  gridDim.x * cols >= N.  Map r of W (of m) exists when bit r of
// `w_maps` (`m_maps`) is set: when a row of that residue exists.
template <bool kMasked>
__global__ void __launch_bounds__(kThreads, 1)
kron_gemm_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ o1, const float* __restrict__ o2,
                 float* __restrict__ part, int B, int d1, int d2, int K,
                 int cols, int w_maps, int m_maps) {
  // The reduction pass may be placed now; it waits for this grid to end.
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  extern __shared__ __align__(1024) float sm[];
  float* a_buf = sm + NST * STAGE;
  float* red = a_buf + 2 * A_BUF;
  uint64_t* full = reinterpret_cast<uint64_t*>(red + RED);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = d1 * d2;
  const int n0 = blockIdx.x * cols, n1 = min(n0 + cols, N);
  const int n_t = (B + BT - 1) / BT * ((K + KT - 1) / KT) *
                  ((n1 - n0 + CS - 1) / CS);
  // the shift of residue r's rows in a box: (r*N + c0) mod 4, c0 = n0 mod 4
  auto shift_of = [&](int r) { return (r * (N & 3) + n0) & 3; };

  Cursor ld(n0, n1, K);   // the next stage to load, into slot s_ld
  int s_ld = 0;
  auto load = [&]() {     // by thread 0
    float* st = sm + s_ld * STAGE;
    const int bytes =
        __popc(w_maps) * W_BOX * 4 +
        (kMasked ? __popc(m_maps) * BT / 4 * P * 4 : 0);
    mbar_expect_tx(full + s_ld, bytes);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int x = residue_box_x(r, N, ld.c0);
      if (w_maps >> r & 1)
        tma_load_2d(st + r * W_BOX, &maps.w[r], full + s_ld, x, ld.k0 / 4);
      if (kMasked && (m_maps >> r & 1))
        tma_load_2d(st + 4 * W_BOX + r * M_BOX, &maps.m[r], full + s_ld, x,
                    ld.b0 / 4);
    }
    ld.next();
    if (++s_ld == NST) s_ld = 0;
  };
  if (tid == 0) {   // first, as the maps' first use waits for their fetch
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      prefetch_tensormap(&maps.w[r]);
      if (kMasked) prefetch_tensormap(&maps.m[r]);
    }
    for (int s = 0; s < NST; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < NST - 1 && t < n_t; ++t) load();
  }
  // a_s[s][b][x] outside x in [s, s + CS) is never written: zeros
  for (int e = tid; e < 2 * 4 * BT * 4; e += kThreads) {
    const int x = e & 3, b = e >> 2 & (BT - 1), sh = e / (4 * BT) & 3;
    a_buf[e / (16 * BT) * A_BUF + sh * SA + b * P + (x < sh ? x : CS + x)] =
        0.f;
  }

  // This thread forms a for mask quad mq of batch row mr of each stage:
  // columns c0 + y[c], y[c] = 4*mq + c - tau, tau the row's shift.  o1 and
  // o2 for them are read one stage ahead (cursor nx); (i, j) of a column
  // advance by CS a stage, with no division.
  const int mr = tid / (WIN / 4), mq = tid % (WIN / 4);
  const bool has_mq = tid < BT * WIN / 4;
  const int tau = kMasked ? shift_of(mr & 3) : 0;
  const float* m_s = sm + 4 * W_BOX + (mr & 3) * M_BOX + (mr >> 2) * P;
  Cursor nx(n0, n1, K);
  int y[4], i[4], j[4];
  bool ok[4];
  float v1[4], v2[4];
  const float *r1 = o1, *r2 = o2;
  auto unit_start = [&]() {
    const int b = nx.b0 + mr;
    r1 = o1 + (size_t)b * d1;
    r2 = o2 + (size_t)b * d2;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      y[c] = 4 * mq + c - tau;
      ok[c] = has_mq && b < B && y[c] >= 0 && y[c] < CS;
      const int n = n0 + max(y[c], 0);
      i[c] = n / d2;
      j[c] = n - i[c] * d2;
    }
  };
  auto fetch = [&]() {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool in = ok[c] && nx.c0 + y[c] < n1;
      v1[c] = in ? __ldg(r1 + i[c]) : 0.f;
      v2[c] = in ? __ldg(r2 + j[c]) : 0.f;
    }
  };
  unit_start();
  fetch();
  __syncthreads();   // the barriers are set up; a's zeros are in

  // Thread: batch rows bg + 2r (r < 8) and outputs k = 4*mk(q) + rk of the
  // unit, mk(q) = (kg/4 + 4q + rk) mod 32 (q < 8), rk = kg mod 4: all of
  // one residue, at one shift.
  const int bg = lane & 1, kg = lane >> 1, rk = kg & 3;
  const int shift = shift_of(rk);
  const float* a_row = a_buf + shift * SA + bg * P;
  const float* w_row = sm + rk * W_BOX;
  Cursor cu(n0, n1, K);
  int slot = 0, phase = 0;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

#pragma unroll 1
  for (int t = 0; t < n_t; ++t) {
    float* a_s = a_buf + (t & 1) * A_BUF;
    mbar_wait(full + slot, phase);
    // a at each shift, a_s[s][b][x] = a[b, c0 + x - s]
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (has_mq && y[c] >= 0 && y[c] < CS) {
        float v = v1[c] * v2[c];
        if (kMasked && v != 0.f) v *= m_s[slot * STAGE + 4 * mq + c];
#pragma unroll
        for (int s = 0; s < 4; ++s) a_s[s * SA + mr * P + y[c] + s] = v;
      }
    }
    __syncthreads();   // stage t and a are in; stage t-1's slot is free
    if (tid == 0 && t + NST - 1 < n_t) {
      // the generic-proxy reads of that slot are done before TMA rewrites it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load();
    }
    if (t + 1 < n_t) {
      if (nx.next()) {
        unit_start();
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          for (j[c] += CS; j[c] >= d2; j[c] -= d2) ++i[c];
      }
      fetch();
    }

    const int valid = min(CS, n1 - cu.c0);
#pragma unroll
    for (int h = 0; h < QPW; ++h) {
      const int qd = warp + 8 * h;   // this warp's quad
      if (4 * qd - 3 >= valid) continue;   // it holds no column
      const float* ar = a_row + (t & 1) * A_BUF + 4 * qd;
      const float* wr = w_row + slot * STAGE + 4 * qd;
      float4 av[8], wv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        av[r] = *reinterpret_cast<const float4*>(ar + 2 * r * P);
        wv[r] = *reinterpret_cast<const float4*>(
            wr + ((kg >> 2) + 4 * r + rk & 31) * P);
      }
      // column by column, so the 64 FMAs of a column are independent
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float a = reinterpret_cast<const float*>(&av[r])[c];
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[r][q] = fmaf(a, reinterpret_cast<const float*>(&wv[q])[c],
                             acc[r][q]);
        }
    }

    if (cu.last()) {   // the unit's last stage: add the warps in order
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int k = 4 * ((kg >> 2) + 4 * q + rk & 31) + rk;
          red[(warp * BT + bg + 2 * r) * RP + k] = acc[r][q];
          acc[r][q] = 0.f;
        }
      __syncthreads();
      float* out = part + ((size_t)blockIdx.x * B + cu.b0) * K + cu.k0;
#pragma unroll
      for (int e = 4 * tid; e < BT * KT; e += 4 * kThreads) {
        const int bb = e / KT, kk = e % KT;
        float4 v = *reinterpret_cast<const float4*>(red + bb * RP + kk);
#pragma unroll
        for (int q = 1; q < 8; ++q) {
          const float4 u =
              *reinterpret_cast<const float4*>(red + (q * BT + bb) * RP + kk);
          v = make_float4(v.x + u.x, v.y + u.y, v.z + u.z, v.w + u.w);
        }
        if (cu.b0 + bb < B) {
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (cu.k0 + kk + c < K) out[bb * K + kk + c] = vs[c];
        }
      }
      // red is written again only after the next stage's barrier
    }
    cu.next();
    if (++slot == NST) slot = 0, phase ^= 1;
  }
}

// y[b, k] = bias[k] + sum over blocks g of part[g, b, k]: a block per 16
// consecutive outputs; thread (slice, o) sums g = slice, slice + 16, ...
// for output o, then the 16 slice sums are added in order.
constexpr int kReduceThreads = 256;
constexpr int kReduceOuts = 16;
constexpr int kSlices = kReduceThreads / kReduceOuts;

__global__ void __launch_bounds__(kReduceThreads)
kron_reduce_kernel(const float* __restrict__ part,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int B, int K, int G) {
  __shared__ float red[kSlices][kReduceOuts];
  const int o = threadIdx.x % kReduceOuts, slice = threadIdx.x / kReduceOuts;
  const int idx = blockIdx.x * kReduceOuts + o, bk = B * K;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // part is written
  float s = 0.f;
  if (idx < bk) {
#pragma unroll 8
    for (int g = slice; g < G; g += kSlices) s += part[(size_t)g * bk + idx];
  }
  red[slice][o] = s;
  __syncthreads();
  if (threadIdx.x < kReduceOuts && idx < bk) {
    float t = red[0][o];
#pragma unroll
    for (int q = 1; q < kSlices; ++q) t += red[q][o];
    y[idx] = t + bias[idx % K];
  }
}

// ------------------------------------------------------------- host side

// The set-up of the current device: the main kernels' shared-memory limit.
Setup setup() {
  return setup_once([](int) {
    cudaError_t err = cudaFuncSetAttribute(
        kron_gemm_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kron_gemm_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)SMEM);
    return err;
  });
}

template <bool kMasked>
int launch(const float* o1, const float* o2, const float* w,
           const float* bias, const float* m, float* part, float* y, int B,
           int d1, int d2, int K, void* stream) {
  const Setup s = setup();
  if (s.err != cudaSuccess) return (int)s.err;
  const long long n = (long long)d1 * d2;
  if (B <= 0 || K <= 0 || n <= 0 || n > INT_MAX - 4 ||
      (long long)B * K > INT_MAX || ((uintptr_t)w & 15) ||
      (kMasked && ((uintptr_t)m & 15)))
    return (int)cudaErrorInvalidValue;
  int cols, blocks;
  split((int)n, s.sms, cols, blocks);
  Maps maps = {};
  cudaError_t err = cudaSuccess;
  const int w_maps = residue_maps(s.encode, maps.w, w, K, (int)n, P, KT / 4,
                                   err);
  const int m_maps =
      kMasked ? residue_maps(s.encode, maps.m, m, B, (int)n, P, BT / 4, err)
              : 0;
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  kron_gemm_kernel<kMasked><<<blocks, kThreads, SMEM, st>>>(
      maps, o1, o2, part, B, d1, d2, K, cols, w_maps, m_maps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_dependent(
      kron_reduce_kernel, dim3((B * K + kReduceOuts - 1) / kReduceOuts),
      dim3(kReduceThreads), st, (const float*)part, bias, y, B, K, blocks);
}

}  // namespace

extern "C" {

// Blocks of a launch over d1*d2 columns on the current device: the caller
// holds `part` as [blocks, B, K] floats.  A negative value is minus a CUDA
// error.
int kron_blocks(int d1, int d2) {
  const Setup s = setup();
  if (s.err != cudaSuccess) return -(int)s.err;
  const long long n = (long long)d1 * d2;
  if (n <= 0 || n > INT_MAX - 4) return -(int)cudaErrorInvalidValue;
  int cols, blocks;
  split((int)n, s.sms, cols, blocks);
  return blocks;
}

// Launch on `stream` (PyTorch's current stream, passed as a pointer) of the
// current device, which the caller sets to the one holding the tensors.
// All tensors fp32 and contiguous, W (and m) 16-byte aligned; `part` is
// scratch of kron_blocks(d1, d2) * B * K floats.  Returns the first CUDA
// error of the set-up and the two launches: 0 when both were accepted.
int kron_fwd(const float* o1, const float* o2, const float* w,
             const float* bias, float* part, float* y, int B, int d1, int d2,
             int K, void* stream) {
  return launch<false>(o1, o2, w, bias, nullptr, part, y, B, d1, d2, K,
                       stream);
}

// The same with the dropout mask m [B, d1*d2] on the Kronecker vector.
int kron_train_fwd(const float* o1, const float* o2, const float* w,
                   const float* bias, const float* m, float* part, float* y,
                   int B, int d1, int d2, int K, void* stream) {
  return launch<true>(o1, o2, w, bias, m, part, y, B, d1, d2, K, stream);
}

const char* kron_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
