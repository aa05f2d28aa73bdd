// Per-block f32 Gram matrices for the packed GLS fit, hand-written for
// Hopper (sm_90a), with a plain C interface loaded through ctypes
// (pint_tpu_torch/kernels/build.py, kernels/gram.py).
//
// Replaces two TPU (Pallas) kernels of the JAX package:
//   - pint_tpu/kernels/fusedgls.py::fused_block_gls_pallas  (entry
//     fused_block_gls_f32): for each Q-row block of aug = [X | r | winv]
//     whiten every column by the winv column, then G = xw^T xw;
//   - pint_tpu/kernels/seggram.py::block_grams_pallas  (entry
//     block_grams_f32): G = x^T x per Q-row block, no whitening.
// Both are the same kernel; the second has no whitening column. The
// streaming appends' K1' (kernels/incremental.py) is the first entry
// with one Q-block, nb = 1.
//
// Numerics: f32 in, f32 FFMA accumulation in registers over the Q rows
// of a block in order, no tensor cores and no TF32. The mixed-precision
// GLS tier refines this Gram against exact f64 matvecs and its
// contraction argument assumes plain f32 rounding (~1e-7 relative). No
// atomics: each output entry is one thread's register, so results
// repeat bitwise.
//
// What bounds it on an H100: HBM bytes. Per input row of Ka floats the
// upper triangle takes ~Ka^2/2 FMAs, ~8 per byte read at Ka = 64-66,
// under the card's balance point of ~10 (33.5 TFMA/s of f32 FFMA over
// 3.35 TB/s); at K2's Q = 32 two thirds of the bytes are the (Ka, Ka)
// outputs. So the design keeps HBM busy both ways, and keeps the SM's
// issue slots and load/store pipe for the products.
//
// What held the first design back (one block per Q-block running load,
// products and store in series, with the (j, i) half of each output
// written one float per row at stride Ka, many times on one bank) and
// what this one does about it:
// - Persistent grid. kernels/gram.py launches as many blocks as stay
//   resident (SM count x blocks per SM from the occupancy API, never
//   more than nb); each walks Q-blocks blk = blockIdx.x, blk +
//   gridDim.x, ...
// - Asynchronous row ring. A block's rows stream through a ring of
//   kStages shared chunks (about 8 KB each) filled by cp.async, and the
//   ring runs across Q-block boundaries: while chunk s is multiplied
//   out, chunks s+1 and s+2 (of this Q-block or the next) are in
//   flight. A Q-block is one contiguous span of q Ka floats, so a chunk
//   is too: it copies 16 bytes at a time when q Ka and chunk Ka are
//   multiples of 4 and x is 16-byte aligned, else 4 bytes at a time
//   (kernels/gram.py decides, `vec`).
// - Rows are read where they land. Without whitening and at Ka % 4 == 0
//   (K2) the products read float4s straight from the ring. Else (K1,
//   K1', odd widths) one pass per landed chunk whitens each row by its
//   winv column, as the plain version does (xw = x * winv), and lays it
//   out at a row stride Kp (Ka rounded up to 4, padding zero); its
//   threads each move one float2 of a row (a float at odd Ka), so the
//   pass has no dependent chain.
// - Epilogue off the threads. Each thread writes its tile and the
//   mirrored tile into a dense (Ka, Ka) staging tile, its own buffer
//   apart from the ring, so the next Q-block's rows keep landing. Tiles
//   are numbered diagonal by diagonal, (ti, ti + d): a quarter-warp
//   holds 8 consecutive ti, so its float4 stores of (i, j) rows and of
//   mirrored (j, i) rows step by Ka + 1 float4s and, Ka being even, fall
//   on 8 different 4-bank groups (float2 stores at Ka % 4 == 2). Then one
//   thread hands the whole tile to the Tensor Memory Accelerator as one
//   bulk store (cp.async.bulk, shared -> global, bulk_group), and the
//   block goes on to the next chunk while it drains; the tile is
//   rewritten only after wait_group.read. At odd Ka, when grid.y splits
//   the tiles, or when each block has a single Q-block (K1': no next
//   Q-block for the store to overlap), the block's threads copy the
//   tile out instead.
//
// Products: each thread owns one 4 x 4 tile (ti <= tj) of the upper
// triangle, keeps its 16 sums in registers and reads its two 4-wide row
// slices as float4 (2 shared loads per 16 FMAs); grid.y splits the tiles
// when there are more than 256, and each y-block then writes only the
// entries of its own tiles. Any Q and Ka up to the shared-memory limit:
// the last chunk of a Q-block may be short, and padding columns are zero.

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int kTile = 4;       // output tile edge owned by one thread
constexpr int kMaxThreads = 256;
constexpr int kStages = 3;     // row chunks in the ring (kernels/gram.py)

// tiles (ti, tj = ti + d) of the upper triangle, numbered diagonal by
// diagonal: diagonal d holds n_tiles_row - d tiles
__device__ __forceinline__ int diagonal_start(int d, int n_tiles_row) {
  return d * n_tiles_row - d * (d - 1) / 2;
}

// the products read rows straight from the ring when there is no
// whitening and a row of Ka floats is a whole number of float4s; else a
// layout pass whitens each landed chunk into rows of stride Kp
__host__ __device__ inline bool direct_rows(int ka, int wcol) {
  return wcol < 0 && ka % kTile == 0;
}

// dynamic shared memory of one block, in floats: the ring (kStages
// chunks of `chunk` rows, each rounded up to 4 floats), the laid-out
// chunk at row stride Kp unless rows are read from the ring, and the
// dense (ka, ka) staging tile (kernels/gram.py::gram_shape computes the
// same)
__host__ __device__ inline long long smem_floats(int ka, int chunk,
                                                 bool direct) {
  const long long kp = (ka + kTile - 1) / kTile * kTile;
  return (long long)kStages * ((chunk * (long long)ka + 3) / 4 * 4) +
         (direct ? 0 : chunk * kp) + (long long)ka * ka;
}

// put 4 consecutive outputs at (row, col) of the staging tile (row
// stride ka), as one float4, two float2 or single floats as ka allows,
// dropping those past the (ka, ka) edge
__device__ __forceinline__ void put4(float* stage, int ka, int row, int col,
                                     float v0, float v1, float v2, float v3) {
  if (row >= ka || col >= ka) return;
  float* p = stage + row * ka + col;
  if (ka % 4 == 0) {
    *reinterpret_cast<float4*>(p) = make_float4(v0, v1, v2, v3);
  } else if (ka % 2 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    if (col + 2 < ka) *reinterpret_cast<float2*>(p + 2) = make_float2(v2, v3);
  } else {
    p[0] = v0;
    if (col + 1 < ka) p[1] = v1;
    if (col + 2 < ka) p[2] = v2;
    if (col + 3 < ka) p[3] = v3;
  }
}

__global__ void __launch_bounds__(kMaxThreads, 3)
block_gram_kernel(const float* __restrict__ x, float* __restrict__ out,
                  long long nb, int q, int ka, int wcol, int chunk,
                  bool vec, bool bulk) {
  extern __shared__ float4 smem4[];
  const bool direct = direct_rows(ka, wcol);
  const int kp = (ka + kTile - 1) / kTile * kTile;
  const int land = (chunk * ka + 3) / 4 * 4;
  float* ring = reinterpret_cast<float*>(smem4);            // kStages x land
  float* rows = ring + (size_t)kStages * land;               // chunk x kp
  float* stage = rows + (direct ? 0 : (size_t)chunk * kp);  // ka x ka

  const int tid = threadIdx.x, nthr = blockDim.x;
  const int ntr = kp / kTile;
  const int n_tiles = ntr * (ntr + 1) / 2;

  // this thread's tile (ti, tj = ti + d), diagonal by diagonal: a
  // quarter-warp holds 8 consecutive ti of one diagonal, so its float4
  // stores of (i, j) rows and of mirrored (j, i) rows into the dense
  // staging tile step by Ka + 1 float4 and, Ka being even, fall on 8
  // different 4-bank groups
  const int t = blockIdx.y * nthr + tid;
  const bool active = t < n_tiles;
  int d = 0;
  while (active && t >= diagonal_start(d + 1, ntr)) ++d;
  const int ti = t - diagonal_start(d, ntr), tj = ti + d;

  float acc[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) acc[a][b] = 0.f;

  // this block's stream of chunks: Q-blocks blockIdx.x + j gridDim.x,
  // each cut into cpb chunks of up to `chunk` rows
  const int cpb = (q + chunk - 1) / chunk;
  const long long mine =
      nb > blockIdx.x ? (nb - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const long long n_chunks = mine * cpb;

  // issue the copies of chunk s into ring stage s % kStages (none past
  // the stream's end) and close them into one group
  auto issue = [&](long long s) {
    if (s < n_chunks) {
      const long long blk = blockIdx.x + (s / cpb) * gridDim.x;
      const int r0 = (int)(s % cpb) * chunk;
      const int n = min(chunk, q - r0) * ka;
      const float* src = x + (blk * q + r0) * (long long)ka;
      float* dst = ring + (size_t)(s % kStages) * land;
      if (vec) {
        for (int e = 4 * tid; e < n; e += 4 * nthr)
          pint_async::copy16(dst + e, src + e, true);
      } else {
        for (int e = tid; e < n; e += nthr)
          pint_async::copy4(dst + e, src + e, true);
      }
    }
    pint_async::commit();
  };

  // the layout pass: thread (tr, tc) moves unit tc (a float2 when Ka is
  // even, else a float) of rows tr, tr + per_pass, ...; the padding
  // columns Ka..Kp-1 of the laid-out rows stay zero
  const int width = ka % 2 == 0 ? ka / 2 : ka;
  const int per_pass = nthr / width;
  const int tr = tid / width, tc = tid - tr * width;
  if (!direct) {
    for (int e = tid; e < chunk * (kp - ka); e += nthr) {
      const int r = e / (kp - ka);
      rows[r * kp + ka + (e - r * (kp - ka))] = 0.f;
    }
  }

  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (long long s = 0; s < n_chunks; ++s) {
    pint_async::wait<kStages - 2>();  // chunk s has landed (own copies)
    // every thread's copies are visible, and every thread is done with
    // chunk s - 1, so its ring stage and the laid-out rows are free
    __syncthreads();
    issue(s + kStages - 1);
    const int r0 = (int)(s % cpb) * chunk;
    const int nr = min(chunk, q - r0);
    const float* landed = ring + (size_t)(s % kStages) * land;
    if (!direct) {
      // whiten by the winv column (K1) as the plain version does (xw =
      // x * winv), into rows of stride kp
      if (tr < per_pass) {
#pragma unroll 4
        for (int r = tr; r < nr; r += per_pass) {
          const float* src = landed + r * ka;
          const float w = wcol >= 0 ? src[wcol] : 1.f;
          if (ka % 2 == 0) {
            const float2 v = reinterpret_cast<const float2*>(src)[tc];
            reinterpret_cast<float2*>(rows + r * kp)[tc] =
                make_float2(v.x * w, v.y * w);
          } else {
            rows[r * kp + tc] = src[tc] * w;
          }
        }
      }
      __syncthreads();
    }
    if (active) {
      const float4* rows4 =
          reinterpret_cast<const float4*>(direct ? landed : rows);
      const int kp4 = kp / kTile;
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float4 av = rows4[r * kp4 + ti];
        const float4 bv = rows4[r * kp4 + tj];
        const float a[kTile] = {av.x, av.y, av.z, av.w};
        const float b[kTile] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < kTile; ++i)
#pragma unroll
          for (int j = 0; j < kTile; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (s % cpb != cpb - 1) continue;

    // epilogue of Q-block blk: the whole (ka, ka) Gram into the staging
    // tile, then out to HBM by one bulk store (or, where that cannot
    // run, by the block's threads), while the next chunks keep landing
    const long long blk = blockIdx.x + (s / cpb) * gridDim.x;
    if (bulk) {
      // the previous Q-block's bulk store has read the staging tile
      if (tid == 0) pint_bulk::wait_read();
      __syncthreads();
    }
    if (active) {
#pragma unroll
      for (int i = 0; i < kTile; ++i)
        put4(stage, ka, ti * kTile + i, tj * kTile, acc[i][0], acc[i][1],
             acc[i][2], acc[i][3]);
      if (ti != tj) {
#pragma unroll
        for (int j = 0; j < kTile; ++j)
          put4(stage, ka, tj * kTile + j, ti * kTile, acc[0][j], acc[1][j],
               acc[2][j], acc[3][j]);
      }
#pragma unroll
      for (int i = 0; i < kTile; ++i)
#pragma unroll
        for (int j = 0; j < kTile; ++j) acc[i][j] = 0.f;
    }
    float* ob = out + blk * (long long)ka * ka;
    if (bulk) {
      pint_bulk::fence_shared();
      __syncthreads();
      if (tid == 0)
        pint_bulk::store(ob, stage, (unsigned)(ka * ka * sizeof(float)));
      continue;
    }
    __syncthreads();
    // coalesced copy; with grid.y > 1 each block writes only the
    // entries of its own tiles. The staging tile is next written after
    // the barriers of the next Q-block's chunks.
    for (int e = tid; e < ka * ka; e += nthr) {
      if (gridDim.y > 1) {
        const int r = e / ka, c = e - r * ka;
        const int lo = min(r, c) / kTile, hi = max(r, c) / kTile;
        if ((diagonal_start(hi - lo, ntr) + lo) / nthr != (int)blockIdx.y)
          continue;
      }
      ob[e] = stage[e];
    }
  }
  pint_async::wait<0>();
  if (bulk && tid == 0) pint_bulk::wait_all();
}

// set the kernel's dynamic shared-memory ceiling to the device's opt-in
// maximum, once per process and device
int opt_in(int device) {
  static bool done[64] = {};
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (done[device]) return 0;
  int max_optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(block_gram_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             max_optin);
  if (err != cudaSuccess) return (int)err;
  done[device] = true;
  return 0;
}

// plan: the launch as kernels/gram.py::launch_gram packs it, int64s
// {nb, q, ka, grid_x, threads, chunk rows, vec, bulk, smem_bytes}
int launch(const float* x, float* out, const long long* plan, int wcol,
           int device, cudaStream_t stream) {
  const long long nb = plan[0], grid_x = plan[3], smem_bytes = plan[8];
  if (nb <= 0) return 0;
  for (int i = 1; i < 8; ++i)
    if (plan[i] < 0 || plan[i] > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
  const int q = (int)plan[1], ka = (int)plan[2], threads = (int)plan[4],
            chunk = (int)plan[5], vec = (int)plan[6], bulk = (int)plan[7];
  // this library links its own CUDA runtime: select the caller's device
  // (the stream belongs to it) before launching
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (q <= 0 || ka <= 0 || chunk < 1 || chunk > q || grid_x < 1 ||
      grid_x > nb || threads < 32 ||
      threads > kMaxThreads || threads % 32 ||
      (ka % 2 ? ka : ka / 2) > threads ||
      smem_bytes != smem_floats(ka, chunk, direct_rows(ka, wcol)) *
                        (long long)sizeof(float))
    return (int)cudaErrorInvalidValue;
  if (vec && ((long long)q * ka % 4 || (long long)chunk * ka % 4 ||
              reinterpret_cast<size_t>(x) % 16))
    return (int)cudaErrorInvalidValue;
  const int ntr = (ka + kTile - 1) / kTile;
  const int n_tiles = ntr * (ntr + 1) / 2;
  const unsigned gy = (unsigned)((n_tiles + threads - 1) / threads);
  if (bulk && (gy > 1 || ka % 2 || reinterpret_cast<size_t>(out) % 16))
    return (int)cudaErrorInvalidValue;
  const int rc = opt_in(device);
  if (rc) return rc;
  dim3 grid((unsigned)grid_x, gy);
  block_gram_kernel<<<grid, threads, (size_t)smem_bytes, stream>>>(
      x, out, nb, q, ka, wcol, chunk, vec != 0, bulk != 0);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of `threads` threads with `smem_bytes` of dynamic shared memory
// that stay resident on the whole of `device` (SM count x blocks per SM)
// into *out; kernels/gram.py sizes the persistent grid from it. Returns
// the CUDA error code (0 = success).
int gram_resident_blocks(int threads, long long smem_bytes, int device,
                         int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int rc = opt_in(device);
  if (rc) return rc;
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, block_gram_kernel, threads, (size_t)smem_bytes);
  if (err != cudaSuccess) return (int)err;
  *out = sms * per_sm;
  return 0;
}

// aug (nb*q, ka) row-major f32 -> out (nb, ka, ka) f32: per-block Gram of
// the rows whitened by their last column (K1, and K1' with nb = 1). The
// launch plan (see `launch`) comes from kernels/gram.py, packed into one
// int64 array so that a call passes five arguments.
int fused_block_gls_f32(const void* aug, void* out, const long long* plan,
                        int device, void* stream) {
  return launch(static_cast<const float*>(aug), static_cast<float*>(out),
                plan, (int)plan[2] - 1, device,
                static_cast<cudaStream_t>(stream));
}

// x (nb*q, k) row-major f32 -> out (nb, k, k) f32: per-block Gram (K2).
int block_grams_f32(const void* x, void* out, const long long* plan,
                    int device, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<float*>(out),
                plan, -1, device, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
