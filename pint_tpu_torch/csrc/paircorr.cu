// Pair-block cross products of the GW detection stage, hand-written for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (pint_tpu_torch/kernels/build.py, kernels/paircorr.py).
//
// Replaces the TPU (Pallas) kernel
//   pint_tpu/kernels/paircorr.py::pair_products_pallas
// which computes, for one pulsar-block pair, both
//   num = U_a U_b^T   and   den = W_a W_b^T
// from row-major (B_a, M) and (B_b, M) f32 inputs (an "NT" product: both
// operands run along the lattice axis M) into two (B_a, B_b) f32 outputs.
//
// Numerics: f32 in, f32 FFMA accumulation in registers over m = 0..M-1
// in order, no tensor cores and no TF32. The mixed GW tier is held to
// ~1e-5 of the f64 sweep (ERRORBUDGET.md); TF32's ~1e-3 would break it.
// No atomics and no split of the sum: every output is one thread's
// register, so results repeat bitwise.
//
// What bounds it on an H100: a (B_a x B_b x M) pair does 4 B_a B_b M
// flops (two products) on 4 (2 (B_a + B_b) M + 2 B_a B_b) bytes. The
// whole 3000 x 3000 x 512 product is 18.4 GFLOP on 48 MB: operation-
// bound, 0.275 ms at the 67 TFLOP/s f32 FFMA peak. A 256 x 256 x 512
// sweep tile is ~2 us of ideal work, so its time is the launch's.
//
// What held the first design back, and what this one does about it:
// - Shared-memory issue. With a 4 x 4 register tile a thread issued 8
//   scalar shared loads per 16 FFMA. Here a thread owns an 8 x 4 tile
//   and reads its operands as float4 along M: per 4 lattice cells, 8 + 4
//   float4 loads feed 128 FFMA, 10.7 FFMA per shared load. (An 8 x 8
//   tile spills at the 128 registers that two 256-thread blocks per SM
//   allow, and measured slower than 8 x 4 at every timed shape, at 128
//   x 128 and at 128 x 64 output tiles alike: registers force 8 x 4.)
// - No overlap of copies and FMAs. The lattice runs through a 2-stage
//   ring of 32-cell chunks filled by cp.async: chunk t+1's copies are
//   in flight while chunk t is multiplied out.
//
// Layout: the chunk is kept row-major (M-contiguous), as it lies in
// HBM, so 16-byte copies move it unchanged. Rows are padded to 36
// floats (9 float4). Thread (ty, tx) owns rows ty + 8 i and columns
// tx + 16 j of the 64 x 64 output tile. A quarter-warp (the 8 threads a
// 128-bit shared load serves at once) shares ty and has 8 consecutive
// tx: its B reads hit rows r..r+7 at float offset 36 r + c, which is
// 4 r + c mod 32, so the 8 float4s fall on 8 different 4-bank groups,
// and its A reads are one address, a broadcast. No conflicts.
//
// Edges: rows past B_a or B_b and cells past M are zero-filled by the
// copy itself (cp.async with a source size of 0), so nothing is padded
// in device memory. When M is a multiple of 4 and the four operands
// are 16-byte aligned (the fleet's M = 100 and the sweep's M = 512),
// rows copy 16 bytes at a time; otherwise each thread copies 4 bytes at
// a time (kernels/paircorr.py decides, `vec`).
//
// The grid: 64 x 64 output tiles of 128 threads, grid.z = 2 picks the
// product (0: num from U, 1: den from W), both in one launch.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kTM = 8;         // output rows per thread
constexpr int kTN = 4;         // output columns per thread
constexpr int kRT = kTile / kTM, kCT = kTile / kTN;  // 8 x 16 threads
constexpr int kThreads = kRT * kCT;
constexpr int kChunk = 32;     // lattice cells per staged chunk
constexpr int kStride = 36;    // floats per staged row (9 float4)
constexpr int kRow4 = kStride / 4;
constexpr int kStages = 2;     // chunks in the ring
constexpr int kStageFloats = 2 * kTile * kStride;  // A rows, then B rows
constexpr int kSmemBytes = kStages * kStageFloats * (int)sizeof(float);
static_assert(kSmemBytes <= 48 * 1024, "no shared-memory opt-in needed");
static_assert(kTile * kChunk % (4 * kThreads) == 0, "whole copies");

// copy chunk [k0, k0 + kChunk) of rows [r0, r0 + kTile) of src (rows x m,
// row-major) into dst (kTile rows of kStride floats), zero-filling rows
// past `rows` and cells past m
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int r0, int rows, int k0, int m,
                                          bool vec, int tid) {
  if (vec) {
    constexpr int kQuads = kChunk / 4;
#pragma unroll
    for (int u = 0; u < kTile * kQuads / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / kQuads, k = k0 + 4 * (e % kQuads);
      const bool in = r0 + r < rows && k < m;
      pint_async::copy16(dst + r * kStride + 4 * (e % kQuads),
                         in ? src + (size_t)(r0 + r) * m + k : src, in);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kTile * kChunk / kThreads; ++u) {
      const int e = tid + u * kThreads;
      const int r = e / kChunk, k = k0 + e % kChunk;
      const bool in = r0 + r < rows && k < m;
      pint_async::copy4(dst + r * kStride + e % kChunk,
                        in ? src + (size_t)(r0 + r) * m + k : src, in);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 4)
pair_products_kernel(const float* __restrict__ ua,
                     const float* __restrict__ wa,
                     const float* __restrict__ ub,
                     const float* __restrict__ wb,
                     float* __restrict__ num, float* __restrict__ den,
                     int ba, int bb, int m, bool vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const bool second = blockIdx.z == 1;
  const float* __restrict__ a = second ? wa : ua;
  const float* __restrict__ b = second ? wb : ub;
  float* __restrict__ out = second ? den : num;

  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % kCT, ty = tid / kCT;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  const int nk = (m + kChunk - 1) / kChunk;
  auto load = [&](int t) {
    float* st = smem + (t % kStages) * kStageFloats;
    load_rows(st, a, a0, ba, t * kChunk, m, vec, tid);
    load_rows(st + kTile * kStride, b, b0, bb, t * kChunk, m, vec, tid);
  };
  if (nk > 0) load(0);
  pint_async::commit();
  for (int t = 0; t < nk; ++t) {
    // the stage chunk t+1 lands in was last read in iteration t-1,
    // which ended on a barrier
    if (t + 1 < nk) load(t + 1);
    pint_async::commit();
    pint_async::wait<1>();  // chunk t has landed (this thread's copies)
    __syncthreads();        // ... and every other thread's
    const float4* as = reinterpret_cast<const float4*>(
        smem + (t % kStages) * kStageFloats);
    const float4* bs = as + kTile * kRow4;
#pragma unroll
    for (int c4 = 0; c4 < kChunk / 4; ++c4) {
      float4 x[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) x[i] = as[(ty + kRT * i) * kRow4 + c4];
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float4 y = bs[(tx + kCT * j) * kRow4 + c4];
#pragma unroll
        for (int i = 0; i < kTM; ++i) {
          float s = acc[i][j];
          s = fmaf(x[i].x, y.x, s);
          s = fmaf(x[i].y, y.y, s);
          s = fmaf(x[i].z, y.z, s);
          acc[i][j] = fmaf(x[i].w, y.w, s);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
  }
  pint_async::wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = a0 + ty + kRT * i;
    if (r >= ba) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = b0 + tx + kCT * j;
      if (col < bb) out[(size_t)r * bb + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// ua, wa (ba, m) and ub, wb (bb, m) row-major f32 -> num = ua ub^T and
// den = wa wb^T, each (ba, bb) row-major f32, in one launch on `stream`
// of `device`. `vec` != 0 copies rows 16 bytes at a time, which needs
// m % 4 == 0 and 16-byte aligned operands. Returns the CUDA error code
// of the launch (0 = success).
int pair_products_f32(const void* ua, const void* wa, const void* ub,
                      const void* wb, void* num, void* den, int ba, int bb,
                      int m, int vec, int device, void* stream) {
  if (ba <= 0 || bb <= 0) return 0;
  if (m < 0 || (vec && m % 4)) return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime: select the caller's device
  // (the stream belongs to it) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned gy = (unsigned)((ba + kTile - 1) / kTile);
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((bb + kTile - 1) / kTile), gy, 2);
  auto s = static_cast<cudaStream_t>(stream);
  pair_products_kernel<<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const float*>(ua), static_cast<const float*>(wa),
      static_cast<const float*>(ub), static_cast<const float*>(wb),
      static_cast<float*>(num), static_cast<float*>(den), ba, bb, m,
      vec != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
