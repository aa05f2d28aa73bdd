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
//
// What bounds it on an H100: a (B_a x B_b x M) tile pair does
// 4 B_a B_b M flops (two products) on 4 (2 (B_a + B_b) M + 2 B_a B_b)
// bytes. At the sweep's 256 x 256 x 512 tiles that is 134 MFLOP on
// 2.6 MB, ~51 flops per byte against the card's balance point of ~20
// (67 TFLOP/s f32 FMA over 3.35 TB/s): operation-bound, but at ~2 us
// of ideal work a tile's time is set by the launch. The 3000 x 3000 x
// 512 whole-fleet product is also operation-bound (18.4 GFLOP, ~0.27 ms).
//
// Design (simple and correct first, not the TPU blocking): a 2-D grid
// of 64 x 64 output tiles, grid.z = 2 picks the product (0: num from
// U, 1: den from W), so both products share one launch. A block of
// 16 x 16 threads stages 64 A rows and 64 B rows through shared memory
// in chunks of 32 lattice cells; the global loads run along M, so a
// warp reads 32 consecutive floats of one row, and each thread issues
// all 16 of its loads before it stores any. The chunk is stored
// transposed (cell-major) with an odd row stride of 65 floats, so the
// transposed stores and the reads of the product loop are free of bank
// conflicts. Thread (ty, tx) owns the 4 x 4 outputs at rows ty + 16 i,
// cols tx + 16 j: per cell it reads 4 A values (two addresses per warp,
// broadcast) and 4 B values (16 consecutive floats) for 16 FMAs, and
// its stores put 16 consecutive floats of an output row per half-warp.
// Every edge is masked in the kernel (B_a, B_b, M): nothing is padded
// in device memory. Larger register tiles, double buffering and a
// persistent schedule are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                  // output tile edge
constexpr int kThreads = 16;               // threads per tile edge
constexpr int kSub = kTile / kThreads;     // outputs per thread per edge
constexpr int kChunk = 32;                 // lattice cells per staged chunk
constexpr int kStride = kTile + 1;         // odd: no bank conflicts
constexpr int kBlockThreads = kThreads * kThreads;
constexpr int kLoads = kTile * kChunk / kBlockThreads;  // per operand

__global__ void __launch_bounds__(kBlockThreads)
pair_products_kernel(const float* __restrict__ ua,
                     const float* __restrict__ wa,
                     const float* __restrict__ ub,
                     const float* __restrict__ wb,
                     float* __restrict__ num, float* __restrict__ den,
                     int ba, int bb, int m) {
  __shared__ float as[kChunk * kStride];
  __shared__ float bs[kChunk * kStride];

  const bool second = blockIdx.z == 1;
  const float* __restrict__ a = second ? wa : ua;
  const float* __restrict__ b = second ? wb : ub;
  float* __restrict__ out = second ? den : num;

  const int a0 = blockIdx.y * kTile;
  const int b0 = blockIdx.x * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreads + tx;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    // element e of the (kTile rows x kChunk cells) chunk: row e / kChunk,
    // cell e % kChunk; a warp covers kChunk consecutive cells of one row
    float va[kLoads], vb[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kBlockThreads;
      const int r = e / kChunk, k = k0 + e % kChunk;
      const bool kin = k < m;
      va[u] = (kin && a0 + r < ba) ? a[(size_t)(a0 + r) * m + k] : 0.f;
      vb[u] = (kin && b0 + r < bb) ? b[(size_t)(b0 + r) * m + k] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = tid + u * kBlockThreads;
      const int idx = (e % kChunk) * kStride + e / kChunk;
      as[idx] = va[u];
      bs[idx] = vb[u];
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < kChunk; ++c) {
      float x[kSub], y[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) x[i] = as[c * kStride + ty + kThreads * i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) y[j] = bs[c * kStride + tx + kThreads * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = a0 + ty + kThreads * i;
    if (r >= ba) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int col = b0 + tx + kThreads * j;
      if (col < bb) out[(size_t)r * bb + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// ua, wa (ba, m) and ub, wb (bb, m) row-major f32 -> num = ua ub^T and
// den = wa wb^T, each (ba, bb) row-major f32, in one launch on `stream`
// of `device`. Returns the CUDA error code of the launch (0 = success).
int pair_products_f32(const void* ua, const void* wa, const void* ub,
                      const void* wb, void* num, void* den, int ba, int bb,
                      int m, int device, void* stream) {
  if (ba <= 0 || bb <= 0) return 0;
  if (m < 0) return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime: select the caller's device
  // (the stream belongs to it) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned gy = (unsigned)((ba + kTile - 1) / kTile);
  if (gy > 65535u) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((bb + kTile - 1) / kTile), gy, 2);
  dim3 block(kThreads, kThreads);
  pair_products_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ua), static_cast<const float*>(wa),
      static_cast<const float*>(ub), static_cast<const float*>(wb),
      static_cast<float*>(num), static_cast<float*>(den), ba, bb, m);
  return (int)cudaGetLastError();
}

}  // extern "C"
