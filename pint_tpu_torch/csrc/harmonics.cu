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
// (weight 1), one (n,) row shared by every row (w_stride = 0) or (G, n)
// (w_stride = n). Output: (G, 2, m) f64, row g holding C_1..C_m then
// S_1..S_m.
//
// Numerics: theta = phi * (float)(2 pi) in f32; cos and sin of that f32
// theta are the correctly rounded f32 values (the recurrence multiplies
// an error in cos(theta) near theta = 0 or pi by ~k^2 at harmonic k, so
// f32 sincosf's 2 ulp leave the K4 tolerance). They come from a
// reduction and polynomials written for an f32 argument: the quadrant
// q = rint(theta 2/pi), theta - q pi/2 by a three-part pi/2 in f64 FMAs
// (exact for |theta| < 65536, where the first part's product and the
// difference fit in 53 bits), the fdlibm minimax polynomials for sin and
// cos on [-pi/4, pi/4] (error below 2^-58) in f64, and one rounding to
// f32 each; |theta| >= 65536 (and NaN) takes CUDA's sincos(double), a
// call out of the loop body, tested once per 4 photons.
// Both round the f64 value to f32, as the plain version rounds its f64
// cos/sin, so they agree except where an f64 error of an ulp straddles
// an f32 rounding boundary (a double-rounding tie, ~1 in 2^28 values).
// The recurrence is contracted: each step is one fmaf(2 c1, c_k,
// -c_{k-1}), which the plain version forms as the exact f64 product
// minus c_{k-1}, rounded once to f32 (again equal except at
// double-rounding ties). The per-thread sums are f32 (FADD, or FFMA
// with the weight), the block sums f32 (warp shuffles, then a
// fixed-order pass over the warps in shared memory), and the block
// partials are summed in f64 by a second kernel, one block per output,
// in a fixed order. No atomics: two launches on the same input give
// bitwise-equal results.
//
// What bounds it on an H100: per photon 4 or 8 bytes read, one sincos,
// and per harmonic 4 f32 instructions (2 FFMA of the recurrence, 2
// FADD or FFMA of the sums): at 4,000,000 photons and m = 20 the
// recurrence and the sums are 488 MFLOP unweighted (0.0073 ms at 67
// TFLOP/s f32) against 16 MB (0.0048 ms at 3.35 TB/s), computed; the
// f64 sincos (21 f64 operations at half the f32 rate) and three
// f32<->f64 conversions (an eighth of the f32 rate) come on top, so the
// kernel is bound by instruction issue, not by memory: ~155 SASS
// instructions a photon at m = 20, of which 80 are the f32 work the
// bound counts (chip_smoke.py counts them with cuobjdump).
//
// Design: the accumulator count KC is a template parameter, one
// instantiation per width the photon path uses (20 for the H-test, 2
// and 4 for Z^2_m; 8, 16 and 32 for other m; m above 32 runs in chunks
// of 32, each chunk advancing the recurrence to its first harmonic), so
// no harmonic past m is computed for m = 2, 4 or 20, and weighted and
// unweighted sums are separate instantiations. The sincos's f64
// constants sit in constant memory, where a DFMA reads them as
// operands. A thread takes 4
// photons per iteration (one float4 load where the rows are 16-byte
// aligned, else 4 scalar loads), runs their 4 recurrences interleaved,
// and loads the next 4 photons before working on the current ones. The
// grid is (blocks per row, G rows, chunks), its block count chosen in
// kernels/harmonics.py from the occupancy API so that the whole grid is
// one wave where the rows allow; the count is a function of the shape
// and the card, so repeats are bitwise. The f64 reduce is a second
// launch with programmatic dependent launch: the partials kernel lets
// it be scheduled at once, and it waits in griddepcontrol.wait for the
// partials, so its launch overlaps the partials' tail.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPhotons = 4;  // photons per thread per loop iteration
constexpr int kReduce = 128;

// plan entries, as kernels/harmonics.py packs them
enum PlanIndex { kRows, kN, kM, kChunk, kChunks, kBlocks, kVec, kWStride };

constexpr float kTwoPiF = 6.283185307179586f;
constexpr float kFastMax = 65536.f;

// The f64 constants of the reduction and the polynomials, in constant
// memory so that each DFMA reads its constant as an operand; as literals
// the compiler rebuilds each one in registers for every photon (2
// instructions per constant).
enum SinCosConstant { kTwoOverPi, kShift, kPio2A, kPio2B, kPio2C, kS1, kS2,
                      kS3, kS4, kS5, kS6, kMinusHalf, kC1, kC2, kC3, kC4,
                      kC5, kC6, kConstants };
__constant__ double kSinCos[kConstants] = {
    0.6366197723675814,     // 2/pi
    6755399441055744.0,     // 1.5 * 2^52: rounds to an integer
    1.5707963267948966,     // pi/2 in three parts
    6.123233995736766e-17,
    -1.4973849048591698e-33,
    // fdlibm k_sin.c / k_cos.c (|x| <= pi/4)
    -1.66666666666666324348e-01, 8.33333333332248946124e-03,
    -1.98412698298579493134e-04, 2.75573137070700676789e-06,
    -2.50507602534068634195e-08, 1.58969099521155010221e-10, -0.5,
    4.16666666666666019037e-02, -1.38888888888741095749e-03,
    2.48015872894767294178e-05, -2.75573143513906633035e-07,
    2.08757232129817482790e-09, -1.13596475577881948265e-11};

// |theta| >= 65536 or NaN: CUDA's sincos(double), out of the loop body;
// (sin, cos) rounded to f32
__device__ __noinline__ float2 sincos_wide(float theta) {
  double sd, cd;
  sincos((double)theta, &sd, &cd);
  return make_float2((float)sd, (float)cd);
}

// correctly rounded f32 sin and cos of an f32 theta with |theta| < 65536
// (see the header); any other theta gives a value sincos_wide replaces
__device__ __forceinline__ void sincos_theta(float theta, float& s,
                                             float& c) {
  const double* k = kSinCos;
  const double x = (double)theta;
  const double t = fma(x, k[kTwoOverPi], k[kShift]);
  const double q = t - k[kShift];
  const int quad = __double2loint(t) & 3;  // q mod 4 (t = 2^52 + 2^51 + q)
  double r = fma(-q, k[kPio2A], x);
  r = fma(-q, k[kPio2B], r);
  r = fma(-q, k[kPio2C], r);
  const double z = r * r;
  double ps = fma(z, k[kS6], k[kS5]);
  ps = fma(z, ps, k[kS4]);
  ps = fma(z, ps, k[kS3]);
  ps = fma(z, ps, k[kS2]);
  ps = fma(z, ps, k[kS1]);
  const double sr = fma(r * z, ps, r);
  double pc = fma(z, k[kC6], k[kC5]);
  pc = fma(z, pc, k[kC4]);
  pc = fma(z, pc, k[kC3]);
  pc = fma(z, pc, k[kC2]);
  pc = fma(z, pc, k[kC1]);
  const double cr = fma(z * z, pc, fma(z, k[kMinusHalf], 1.0));
  const float sr32 = (float)sr, cr32 = (float)cr;
  const float sf = (quad & 1) ? cr32 : sr32;
  const float cf = (quad & 1) ? sr32 : cr32;
  s = (quad & 2) ? -sf : sf;
  c = ((quad + 1) & 2) ? -cf : cf;
}

// P photons' terms of harmonics k0 + 1 .. k0 + KC into the sums, the P
// recurrences interleaved
template <int KC, bool W, int P>
__device__ __forceinline__ void accumulate(const float (&phi)[P],
                                           const float (&wt)[P], int k0,
                                           float (&cacc)[KC],
                                           float (&sacc)[KC]) {
  float c[P], s[P], cp[P], sp[P], two_c1[P], theta[P];
  bool wide = false;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    theta[p] = __fmul_rn(phi[p], kTwoPiF);
    sincos_theta(theta[p], s[p], c[p]);
    wide |= !(fabsf(theta[p]) < kFastMax);
  }
  if (wide) {  // one test per P photons; taken only for |theta| >= 65536
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (!(fabsf(theta[p]) < kFastMax)) {
        const float2 sc = sincos_wide(theta[p]);
        s[p] = sc.x;
        c[p] = sc.y;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    two_c1[p] = 2.f * c[p];
    cp[p] = 1.f;
    sp[p] = 0.f;
  }
#pragma unroll 1
  for (int k = 1; k <= k0; ++k) {  // a later chunk: advance to k0 + 1
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float cn = fmaf(two_c1[p], c[p], -cp[p]);
      const float sn = fmaf(two_c1[p], s[p], -sp[p]);
      cp[p] = c[p];
      sp[p] = s[p];
      c[p] = cn;
      s[p] = sn;
    }
  }
#pragma unroll
  for (int j = 0; j < KC; ++j) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (W) {
        cacc[j] = fmaf(wt[p], c[p], cacc[j]);
        sacc[j] = fmaf(wt[p], s[p], sacc[j]);
      } else {
        cacc[j] = __fadd_rn(cacc[j], c[p]);
        sacc[j] = __fadd_rn(sacc[j], s[p]);
      }
      if (j + 1 < KC) {
        const float cn = fmaf(two_c1[p], c[p], -cp[p]);
        const float sn = fmaf(two_c1[p], s[p], -sp[p]);
        cp[p] = c[p];
        sp[p] = s[p];
        c[p] = cn;
        s[p] = sn;
      }
    }
  }
}

// photons 4q .. 4q + 3 of a row: one 16-byte load when `vec`
__device__ __forceinline__ void load_quad(const float* __restrict__ row,
                                          long long q, int vec,
                                          float (&v)[kPhotons]) {
  if (vec) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(row) + q);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int p = 0; p < kPhotons; ++p) v[p] = __ldg(row + kPhotons * q + p);
  }
}

template <int KC, bool W>
__global__ void __launch_bounds__(kThreads)
harmonic_partials_kernel(const float* __restrict__ ph,
                         const float* __restrict__ w, long long w_stride,
                         float* __restrict__ partial, long long n, int m,
                         int vec) {
  // the reduce kernel may be scheduled now; it waits for this grid
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ float red[kWarps][2 * KC];

  const int g = blockIdx.y;
  const int chunk = blockIdx.z;
  const int k0 = chunk * KC;  // harmonics k0 + 1 .. k0 + KC
  const int kc = min(KC, m - k0);
  const float* __restrict__ row = ph + (long long)g * n;
  const float* __restrict__ wrow = W ? w + (long long)g * w_stride : row;

  float cacc[KC], sacc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    cacc[j] = 0.f;
    sacc[j] = 0.f;
  }

  const long long nq = n / kPhotons;  // whole quads of the row
  const long long stride = (long long)gridDim.x * kThreads;
  const long long lin = (long long)blockIdx.x * kThreads + threadIdx.x;
  float phi[kPhotons], wt[kPhotons] = {1.f, 1.f, 1.f, 1.f};
  if (lin < nq) {
    load_quad(row, lin, vec, phi);
    if (W) load_quad(wrow, lin, vec, wt);
  }
  for (long long q = lin; q < nq; q += stride) {
    float nphi[kPhotons], nwt[kPhotons] = {1.f, 1.f, 1.f, 1.f};
    const long long qn = q + stride;
    if (qn < nq) {  // the next quad's loads go out before this one's work
      load_quad(row, qn, vec, nphi);
      if (W) load_quad(wrow, qn, vec, nwt);
    }
    accumulate<KC, W, kPhotons>(phi, wt, k0, cacc, sacc);
#pragma unroll
    for (int p = 0; p < kPhotons; ++p) {
      phi[p] = nphi[p];
      wt[p] = nwt[p];
    }
  }
  // the row's last n % 4 photons, one at a time, by the thread whose
  // turn the next quad would have been
  if (lin == nq % stride) {
    for (long long i = nq * kPhotons; i < n; ++i) {
      const float p1[1] = {row[i]};
      const float w1[1] = {W ? wrow[i] : 1.f};
      accumulate<KC, W, 1>(p1, w1, k0, cacc, sacc);
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
  if (threadIdx.x < 2 * KC && threadIdx.x % KC < kc) {
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

// out (G, 2, m) f64: one block per (row, cos|sin, harmonic). Its
// threads sum the row's block partials of that harmonic in f64 (thread
// t takes blocks t, t + kReduce, ...), then a fixed tree in shared
// memory adds the threads' sums: the same order on every launch.
__global__ void __launch_bounds__(kReduce)
harmonic_reduce_kernel(const float* __restrict__ partial,
                       double* __restrict__ out, int m, int kc_max,
                       int nchunks, int nblocks) {
  // launched as the partials grid's programmatic dependent: wait until
  // that grid has completed and its partials are visible
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __shared__ double red[kReduce];
  const long long t = blockIdx.x;     // index into out (G, 2, m)
  const int k = (int)(t % m);         // harmonic k + 1
  const int cs = (int)((t / m) % 2);  // 0: cos, 1: sin
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

using PartialsFn = void (*)(const float*, const float*, long long, float*,
                            long long, int, int);

// the instantiation for KC harmonics per chunk, or null
PartialsFn partials_fn(long long kc, bool weighted) {
#define PINT_K4_CASE(KC)                                       \
  case KC:                                                     \
    return weighted ? harmonic_partials_kernel<KC, true>       \
                    : harmonic_partials_kernel<KC, false>;
  switch (kc) {
    PINT_K4_CASE(2)
    PINT_K4_CASE(4)
    PINT_K4_CASE(8)
    PINT_K4_CASE(16)
    PINT_K4_CASE(20)
    PINT_K4_CASE(32)
    default:
      return nullptr;
  }
#undef PINT_K4_CASE
}

// this library links its own CUDA runtime: make the caller's device
// (whose stream it is given) current, without a cudaSetDevice on each
// call once it is
cudaError_t use_device(int device) {
  int cur = -1;
  if (cudaGetDevice(&cur) == cudaSuccess && cur == device) return cudaSuccess;
  return cudaSetDevice(device);
}

}  // namespace

extern "C" {

// Blocks of the partials kernel with kc harmonics per chunk that stay
// resident on the card (SM count x blocks per SM, from the occupancy
// API), into *out.
int harmonic_resident_blocks(int kc, int weighted, int device, int* out) {
  const PartialsFn fn = partials_fn(kc, weighted != 0);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(fn), kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  return 0;
}

// ph (g_rows, n) row-major f32; w null, (n,) with w_stride 0 or
// (g_rows, n) with w_stride n; partial a scratch of g_rows * chunks *
// blocks * 2 * chunk floats; out (g_rows, 2, m) f64. The launch plan
// {g_rows, n, m, chunk, chunks, blocks, vec, w_stride} comes from
// kernels/harmonics.py. Two launches on `stream` of `device`. Returns
// the CUDA error code (0 = success).
int harmonic_sums_f32(const void* ph, const void* w, void* partial,
                      void* out, const long long* plan, int device,
                      void* stream) {
  const long long g = plan[kRows], n = plan[kN], m = plan[kM];
  const long long kc = plan[kChunk], nchunks = plan[kChunks];
  const long long nb = plan[kBlocks], vec = plan[kVec];
  const long long w_stride = plan[kWStride];
  const PartialsFn fn = partials_fn(kc, w != nullptr);
  if (!fn || g < 1 || g > 65535 || n < 1 || m < 1 ||
      g * 2 * m > (1LL << 31) - 1 ||
      nchunks != (m + kc - 1) / kc || nchunks > 65535 || nb < 1 ||
      nb > (1LL << 31) - 1 || (vec != 0 && vec != 1) ||
      (w && w_stride != 0 && w_stride != n))
    return (int)cudaErrorInvalidValue;
  const bool rows_aligned = g == 1 || n % kPhotons == 0;
  if (vec && (reinterpret_cast<uintptr_t>(ph) % 16 || !rows_aligned ||
              (w && (reinterpret_cast<uintptr_t>(w) % 16 ||
                     (w_stride && !rows_aligned)))))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  auto s = static_cast<cudaStream_t>(stream);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)nb, (unsigned)g, (unsigned)nchunks);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, fn, static_cast<const float*>(ph),
                           static_cast<const float*>(w), w_stride,
                           static_cast<float*>(partial), n, (int)m, (int)vec);
  if (err != cudaSuccess) return (int)err;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((unsigned)(g * 2 * m));
  cfg.blockDim = dim3(kReduce);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, harmonic_reduce_kernel,
                           static_cast<const float*>(partial),
                           static_cast<double*>(out), (int)m, (int)kc,
                           (int)nchunks, (int)nb);
  return (int)err;
}

}  // extern "C"
