// Weighted harmonic sums over photon phases (the H-test / Z^2_m hot
// loop), hand-written for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (pint_tpu_torch/kernels/build.py,
// kernels/harmonics.py).
//
// Replaces the TPU (Pallas) kernel
//   pint_tpu/kernels/harmonics.py::harmonic_sums_pallas
// which computes, for harmonics k = 1..m,
//   C_k = sum_i w_i cos(2 pi k phi_i),   S_k = sum_i w_i sin(2 pi k phi_i)
// from f32 phases and weights, with the Chebyshev recurrence
//   cos(k t) = 2 cos(t) cos((k-1) t) - cos((k-2) t)   (and the same for sin)
// so each photon pays one sincos and not 2m transcendentals; f32
// partial sums, reduced across partials in f64.
//
// Input: G rows of n phases, row-major f32 (G, n); weights either none
// (null pointer: weight 1), one (n,) row shared by every row (w_stride
// = 0) or (G, n) (w_stride = n). Output: (G, 2, m) f64, row g holding
// C_1..C_m then S_1..S_m.
//
// Numerics: theta = phi * (float)(2 pi) in f32, then cos and sin of
// that f32 theta at full precision, taken in f64 (sincos) and rounded
// to f32: the correctly rounded f32 values, the ones the plain version
// (kernels/harmonics.py::harmonic_sums_plain) uses. f32 sincosf is
// within 2 ulp, and the recurrence multiplies an error in cos(theta)
// near theta = 0 or pi by ~k^2 at harmonic k: with sincosf the kernel
// left the K4 tolerance against the plain version at 8191 photons, m =
// 20, 3 rows, on an H100. No --use_fast_math and no __sinf: 2 pi k phi
// needs the argument reduction. The recurrence is the plain version's
// multiply-then-subtract, each rounded (__fmul_rn, __fsub_rn: no
// contraction into an FMA), so every photon's cos(k theta) and
// sin(k theta) are the plain version's bit for bit; the per-thread
// sums are f32 FMAs, the block sums f32 (warp shuffles, then a
// fixed-order pass over the warps in shared memory), and the block
// partials are summed in f64 by a second kernel, one block per
// output, in a fixed order. The kernel and the plain version differ by
// summation order only. No atomics: two launches on the same input
// give bitwise-equal results.
//
// What bounds it on an H100: per photon 8 bytes read (phase + weight),
// one sincos, and per harmonic 8 f32 operations (4 for the recurrence,
// 2 FMAs for the weighted accumulation; 2 adds unweighted): at
// 4,000,000 photons and m = 20 that is 32 MB (0.0096 ms at 3.35 TB/s)
// against 648 MFLOP (0.0097 ms at 67 TFLOP/s f32), computed; the two
// limits tie, and the f64 sincos (~50 f64 operations at half the f32
// rate) runs on top. This first version streams each photon
// once per chunk of harmonics with plain 4-byte loads.
//
// Design (simple and correct first, not the TPU blocking): grid
// (blocks per row, G rows, harmonic chunks). A thread walks its row
// with a grid-stride loop and keeps the chunk's 2 KC sums in registers
// (KC = 4, 24 or 32, a template parameter: the smallest that holds m,
// else 32 with several chunks). A chunk starting at harmonic
// k0 + 1 runs the recurrence from k = 1 and accumulates only k0 < k <=
// k0 + KC, so any m works and every harmonic's value is the one an
// unchunked pass would give. The TPU kernel's padding to 8192-photon blocks with
// weight 0 becomes a bounds check in the loop: nothing is padded in
// device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 32;

template <int KC>
__global__ void __launch_bounds__(kThreads)
harmonic_partials_kernel(const float* __restrict__ ph,
                         const float* __restrict__ w, long long w_stride,
                         float* __restrict__ partial, long long n, int m) {
  __shared__ float red[kWarps][2 * KC];

  const int g = blockIdx.y;
  const int chunk = blockIdx.z;
  const int k0 = chunk * KC;  // harmonics k0 + 1 .. k0 + KC
  const int kc = min(KC, m - k0);
  const float* __restrict__ row = ph + (long long)g * n;
  const float* __restrict__ wrow = w ? w + (long long)g * w_stride : nullptr;

  float cacc[KC], sacc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    cacc[j] = 0.f;
    sacc[j] = 0.f;
  }

  const float two_pi = 6.283185307179586f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float wi = wrow ? wrow[i] : 1.f;
    double sd, cd;
    sincos((double)__fmul_rn(row[i], two_pi), &sd, &cd);
    const float c1 = (float)cd, s1 = (float)sd;
    const float two_c1 = 2.f * c1;
    // (c, s) at harmonic k, (cp, sp) at k - 1; start at k = 1
    float cp = 1.f, sp = 0.f, c = c1, s = s1;
    for (int k = 1; k <= k0; ++k) {  // advance to harmonic k0 + 1
      const float cn = __fsub_rn(__fmul_rn(two_c1, c), cp);
      const float sn = __fsub_rn(__fmul_rn(two_c1, s), sp);
      cp = c;
      sp = s;
      c = cn;
      s = sn;
    }
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      cacc[j] = fmaf(wi, c, cacc[j]);
      sacc[j] = fmaf(wi, s, sacc[j]);
      const float cn = __fsub_rn(__fmul_rn(two_c1, c), cp);
      const float sn = __fsub_rn(__fmul_rn(two_c1, s), sp);
      cp = c;
      sp = s;
      c = cn;
      s = sn;
    }
  }

  // block reduction: within each warp by shuffles, then over the warps
  // in a fixed order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    float cv = cacc[j], sv = sacc[j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      cv += __shfl_down_sync(0xffffffffu, cv, off);
      sv += __shfl_down_sync(0xffffffffu, sv, off);
    }
    if (lane == 0) {
      red[warp][j] = cv;
      red[warp][KC + j] = sv;
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * KC) {
    const int j = threadIdx.x % KC;
    if (j < kc) {
      float v = 0.f;
#pragma unroll
      for (int u = 0; u < kWarps; ++u) v += red[u][threadIdx.x];
      // partial layout (G, chunks, blocks, 2 KC)
      const long long base =
          (((long long)g * gridDim.z + chunk) * gridDim.x + blockIdx.x) *
          (2 * KC);
      partial[base + threadIdx.x] = v;
    }
  }
}

// out (G, 2, m) f64: one block per (row, cos|sin, harmonic). Its
// threads sum the row's block partials of that harmonic in f64 (thread
// t takes blocks t, t + kReduce, ...), then a fixed tree in shared
// memory adds the threads' sums: the same order on every launch.
constexpr int kReduce = 128;

__global__ void __launch_bounds__(kReduce)
harmonic_reduce_kernel(const float* __restrict__ partial,
                       double* __restrict__ out, int m, int kc_max,
                       int nchunks, int nblocks) {
  __shared__ double red[kReduce];
  const long long t = blockIdx.x;       // index into out (G, 2, m)
  const int k = (int)(t % m);           // harmonic k + 1
  const int cs = (int)((t / m) % 2);    // 0: cos, 1: sin
  const int g = (int)(t / (2LL * m));
  const int chunk = k / kc_max, j = k % kc_max;
  const float* p = partial +
                   ((long long)g * nchunks + chunk) * nblocks * (2 * kc_max) +
                   cs * kc_max + j;
  double acc = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += kReduce)
    acc += (double)p[(long long)b * 2 * kc_max];
  red[threadIdx.x] = acc;
  __syncthreads();
  for (int half = kReduce / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[t] = red[0];
}

template <int KC>
cudaError_t launch(const float* ph, const float* w, long long w_stride,
                   float* partial, double* out, int g_rows, long long n, int m,
                   int nblocks, cudaStream_t stream) {
  const int nchunks = (m + KC - 1) / KC;
  dim3 grid((unsigned)nblocks, (unsigned)g_rows, (unsigned)nchunks);
  harmonic_partials_kernel<KC><<<grid, kThreads, 0, stream>>>(
      ph, w, w_stride, partial, n, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long outs = (long long)g_rows * 2 * m;
  harmonic_reduce_kernel<<<(unsigned)outs, kReduce, 0, stream>>>(
      partial, out, m, KC, nchunks, nblocks);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Harmonics per chunk for m harmonics: 4 (Z^2_m at small m), 24 (the
// H-test's m = 20) or 32 (m above 24, in several chunks). The wrapper
// sizes the partial buffer as g_rows * chunks * nblocks * 2 * chunk
// floats.
int harmonic_chunk(int m) { return m <= 4 ? 4 : m <= 24 ? 24 : kMaxChunk; }

// Blocks per row for n photons: about 8 photons per thread, at most
// 1024 blocks per row (a fixed function of n, so the summation order,
// and with it the result, depends on the input shape only).
int harmonic_blocks(long long n) {
  long long b = (n + (long long)kThreads * 8 - 1) / ((long long)kThreads * 8);
  if (b < 1) b = 1;
  if (b > 1024) b = 1024;
  return (int)b;
}

// ph (g_rows, n) row-major f32; w null, (n,) with w_stride 0 or
// (g_rows, n) with w_stride n; partial a scratch of g_rows *
// ceil(m / harmonic_chunk(m)) * harmonic_blocks(n) * 2 *
// harmonic_chunk(m) floats; out (g_rows, 2, m) f64. Two launches on
// `stream` of `device`. Returns the CUDA error code (0 = success).
int harmonic_sums_f32(const void* ph, const void* w, long long w_stride,
                      void* partial, void* out, int g_rows, long long n,
                      int m, int device, void* stream) {
  if (g_rows <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  if (g_rows > 65535) return (int)cudaErrorInvalidValue;
  const int kc = harmonic_chunk(m);
  if ((m + kc - 1) / kc > 65535) return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime: select the caller's device
  // (the stream belongs to it) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int nb = harmonic_blocks(n);
  auto s = static_cast<cudaStream_t>(stream);
  auto p = static_cast<const float*>(ph);
  auto wp = static_cast<const float*>(w);
  auto part = static_cast<float*>(partial);
  auto o = static_cast<double*>(out);
  switch (kc) {
    case 4:
      err = launch<4>(p, wp, w_stride, part, o, g_rows, n, m, nb, s);
      break;
    case 24:
      err = launch<24>(p, wp, w_stride, part, o, g_rows, n, m, nb, s);
      break;
    default:
      err = launch<kMaxChunk>(p, wp, w_stride, part, o, g_rows, n, m, nb, s);
  }
  return (int)err;
}

}  // extern "C"
