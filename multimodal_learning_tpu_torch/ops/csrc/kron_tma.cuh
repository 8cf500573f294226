// Shared machinery of the Kronecker-fusion kernels (kron_fusion.cu,
// kron_bwd.cu): W, the pofusion `encoder1` weight in the torch layout
// [K, N] with N = d1*d2, streamed into shared memory by TMA.
//
// For odd N, row k of W starts at byte 4*N*k, which is not 16-byte aligned,
// so no tensor map can step from row to row.  But rows k = 4m + r of one
// residue r are 16*N bytes apart, so each residue gets its own 2-D tensor
// map, based at the aligned float at or before row r's start.  In map r the
// element (k = 4m + r, n) sits at (x, y) = (n + ((r*N) & 3), m).  A box of
// residue r that starts at the aligned column at or before column c0's
// holds column c0 at the shift (r*N + c0) & 3; what lies past the tensor
// loads as zeros.
//
// Everything here has internal linkage (an anonymous namespace), so the
// libraries that include it share no symbol, not even a static cache.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map,
                                            uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// The x coordinate, in map r, of the box that holds column c0 of W.
__device__ __forceinline__ int residue_box_x(int r, int N, int c0) {
  return (((r * (N & 3)) & 3) + c0) & ~3;
}

// ------------------------------------------------------------- host side
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

constexpr int MAX_DEVICES = 64;

// What a library sets up once per process and device, not per launch: the
// SM count and `cuTensorMapEncodeTiled` (reached through the runtime, so
// the library needs no -lcuda), after `prepare(dev)`, which sets its own
// kernels' attributes.
struct Setup {
  cudaError_t err = cudaSuccess;
  int sms = 0;
  EncodeTiled encode = nullptr;
};

template <typename Prepare>
Setup make_setup(int dev, Prepare prepare) {
  Setup s;
  if ((s.err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess ||
      (s.err = prepare(dev)) != cudaSuccess)
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

// The Setup of the current device, made at its first use.  Call it from
// one place per library: each `Prepare` type has its own once-flags.
template <typename Prepare>
Setup setup_once(Prepare prepare) {
  static std::once_flag once[MAX_DEVICES];
  static Setup done[MAX_DEVICES];
  Setup s;
  int dev = 0;
  if ((s.err = cudaGetDevice(&dev)) != cudaSuccess) return s;
  if (dev < 0 || dev >= MAX_DEVICES) {
    s.err = cudaErrorInvalidDevice;
    return s;
  }
  std::call_once(once[dev],
                 [dev, prepare] { done[dev] = make_setup(dev, prepare); });
  return done[dev];
}

// Columns per block and the number of blocks, at most `parts`, that cover
// N columns.
inline void split(int N, int parts, int& cols, int& blocks) {
  cols = (N + parts - 1) / parts;
  blocks = (N + cols - 1) / cols;
}

// The maps of the rows r, r + 4, ... of a row-major [rows, N] fp32 tensor
// at the 16-byte aligned p, for each residue r that has a row (bit r of
// the result), with boxes of `box_cols` floats (a multiple of 4) x
// `box_rows` rows.
inline int encode_maps(EncodeTiled encode, CUtensorMap* maps, const float* p,
                       int rows, int N, int box_cols, int box_rows,
                       cudaError_t& err) {
  int valid = 0;
  for (int r = 0; r < 4 && r < rows; ++r) {
    const long long start = (long long)r * N, shift = start & 3;
    const cuuint64_t dims[2] = {(cuuint64_t)(N + shift),
                                (cuuint64_t)((rows - r + 3) / 4)};
    const cuuint64_t strides[1] = {(cuuint64_t)N * 16};
    const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    const CUresult res = encode(
        maps + r, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
        const_cast<float*>(p + (start - shift)), dims, strides, box, elem,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) err = cudaErrorInvalidValue;
    valid |= 1 << r;
  }
  return valid;
}

// The same, from a cache keyed by address, shape and box (a map depends on
// nothing else), so that a call with W, or a tensor at an address the
// allocator hands out again, encodes nothing.
inline int residue_maps(EncodeTiled encode, CUtensorMap* maps, const float* p,
                        int rows, int N, int box_cols, int box_rows,
                        cudaError_t& err) {
  struct Entry {
    const float* p = nullptr;
    int rows = 0, N = 0, box_cols = 0, box_rows = 0, valid = 0;
    CUtensorMap maps[4];
  };
  constexpr int kEntries = 16;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache)
    if (e.p == p && e.rows == rows && e.N == N && e.box_cols == box_cols &&
        e.box_rows == box_rows) {
      for (int r = 0; r < 4; ++r) maps[r] = e.maps[r];
      return e.valid;
    }
  const int valid =
      encode_maps(encode, maps, p, rows, N, box_cols, box_rows, err);
  if (err == cudaSuccess) {
    Entry& e = cache[next];
    next = (next + 1) % kEntries;
    e.p = p, e.rows = rows, e.N = N, e.box_cols = box_cols,
    e.box_rows = box_rows, e.valid = valid;
    for (int r = 0; r < 4; ++r) e.maps[r] = maps[r];
  }
  return valid;
}

// Launches `kernel` on `stream` with programmatic dependent launch: its
// blocks may be placed while the previous kernel on the stream runs, and
// wait at `griddepcontrol.wait` until it has ended.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
