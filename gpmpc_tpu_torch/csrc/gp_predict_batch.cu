// Batched GP cross-covariance and mean for Ny output dims:
//   ks[d, b, n] = sf2[d] * exp(-0.5 * ||(z_b - x_n) / ell[d]||^2),
//   mu[d, b]    = sum_n ks[d, b, n] * alpha[d, n].
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:gp_predict_batch_pallas (body
// _predict_kernel), which runs one output dim per call; here one launch
// covers all Ny dims.  Same function as the plain version
// gpmpc_tpu_torch/ops/gp_cuda.py:gp_predict_batch_reference; the schedule
// below is mirrored in plain PyTorch by
// gp_cuda.gp_predict_batch_tiles_reference (TILE_N, FC and SCALE there are
// gp_cuda.PREDICT_TILE_N, PREDICT_FC and GRAM_EXP2_SCALE).  The caller
// completes the variance sf2 - ||L^-1 ks^T||^2 with a batched triangular
// solve, as the JAX package leaves that step to XLA.
//
// What bounds it on an H100.  At validation's shape (Ny = 4, B = 100,
// N = 100, D = 6) it writes 160 KB of k* and does ~1 MFLOP: a twentieth of
// a microsecond of bandwidth, so what counts is the latency of a block's
// work on top of the launch.  At large B and N the k* write bounds it: Ny
// = 4, B = N = 1000 writes 16 MB, 4.8 us at 3.35 TB/s, against ~1.4 us of
// f32 arithmetic at 67 TFLOP/s.  No tensor cores: D = 6 is far under
// wgmma's depth, and the direct difference sum below is what keeps k*
// accurate in f32 (ROADMAP "Numerics").
//
// Design.  One block of WARPS = 8 warps per (tile of QT = 16 queries,
// output dim); warp w owns ROWS = 2 queries and walks the N points in
// tiles of TILE_N = 128, lane l taking the 4 consecutive points 4l .. 4l +
// 3 of a tile, so a warp writes 512 contiguous bytes of each of its k*
// rows per tile, one 16-byte store per lane and row (4-byte stores with a
// mask where N % 4 != 0 or at the ragged edge).  Every warp of the block
// shares the tile's points:
//  * one device round trip before any arithmetic: the tile's points (and,
//    with its last feature chunk, alpha) are requested by 4-byte cp.async
//    straight into shared memory, feature-major (row pitch TILE_N + 4, so a
//    warp's copies and a lane's float4 reads are free of bank conflicts),
//    zero-filled past N and D; the queries, ell and sf2 are loaded into
//    registers meanwhile.  The next tile's copies are in flight while a
//    tile is computed (two buffers, one barrier each way);
//  * the copies cost a few instructions each: a thread copies one feature
//    of every MSTEP-th point, so its shared and global offsets start at
//    values set once and advance by constants, with no branch, no integer
//    or IEEE division and no 64-bit index arithmetic (with those, the
//    copies took half of the loop's instructions, and the same block
//    shape read 0.0102-0.0108 ms against 0.0079-0.0083 at Ny = 4, B = N =
//    1000 on the H100);
//  * s_k = sqrt(log2(e) / 2) / ell_k by rcp.approx; the queries are
//    pre-scaled, q' = z s, and each point's scaled difference is one FMA,
//    z'_k - x_k s_k, so d2' = d2 log2(e) / 2 and k* = sf2 exp2(-d2') by one
//    MUFU.EX2;
//  * any D: the features are walked in chunks of FC = 8, d2 accumulating
//    in registers across chunks; for D <= FC (the four-tank's D = 6) the
//    queries stay in registers for the whole walk;
//  * mu: each lane keeps its rows' partial sums k* alpha in registers
//    across tiles, and the warp reduces them by a fixed shuffle butterfly,
//    so mu is the same from run to run (no floating-point atomics).
// Measured on the H100 (PERF.md): 4 or 16 warps, 1 or 4 queries a warp,
// 3 or 4 buffers, 8 points a lane, and warps split across a block's point
// tiles were each slower at N = 100 or 1000, or no faster.
// The Pallas kernel's (8, 128) padding, 1e6 sentinel points and norm
// expansion exist for the TPU's layout and matrix unit and have no
// counterpart here: the ragged edges are masked.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int LANE_N = 4;                    // points per lane, one float4
constexpr int TILE_N = 32 * LANE_N;          // points per tile
constexpr int FC = 8;                        // features per chunk
constexpr int ROWS = 2;                      // queries per warp
constexpr int WARPS = 8;                     // warps per block
constexpr int THREADS = 32 * WARPS;
constexpr int QT = ROWS * WARPS;             // queries per block
constexpr int PITCH = TILE_N + 4;            // floats per staged feature row
constexpr int STAGE = FC * PITCH + TILE_N;   // one buffer: points, alpha
constexpr int MSTEP = THREADS / FC;          // points between a thread's
                                             // copies
static_assert(TILE_N % MSTEP == 0, "whole copy passes");
static_assert(PITCH % 32 == 4, "conflict-free staging and float4 reads");
// sqrt(log2(e) / 2): queries and points scaled by this / ell give
// d2' = d2 log2(e) / 2, and exp(-d2 / 2) = exp2(-d2')
constexpr float SCALE = 0.84932180028801904272f;

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// 4-byte asynchronous copy global -> shared address s; zero-fills when
// !valid (gmem must still be a valid address)
__device__ __forceinline__ void cp_async4(unsigned s, const float* gmem,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__global__ void __launch_bounds__(THREADS)
gp_predict_batch_kernel(const float* __restrict__ z,
                        const float* __restrict__ x,
                        const float* __restrict__ ell,
                        const float* __restrict__ sf2,
                        const float* __restrict__ alpha,
                        float* __restrict__ mu, float* __restrict__ ks, int b,
                        int n, int d) {
  __shared__ __align__(16) float smem[2][STAGE];   // two tile buffers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dim = blockIdx.y;
  const int q0 = blockIdx.x * QT + warp * ROWS;   // this warp's first query
  const float* el = ell + dim * d;
  const float* al = alpha + static_cast<size_t>(dim) * n;
  const int fchunks = (d + FC - 1) / FC;
  const int tiles = (n + TILE_N - 1) / TILE_N * fchunks;

  // tile (n0, f0) into buffer bi: x[n0 + m, f0 + k] at [k * PITCH + m],
  // zero past N and D (so the mean's padding terms are 0 * 0) and, on the
  // last feature chunk, alpha[n0 + m] at [FC * PITCH + m].  Thread tid
  // copies feature tid % FC of points tid / FC + i MSTEP: no branch, and
  // 32-bit offsets that advance by a constant
  const int sk = tid % FC, sm = tid / FC;
  const unsigned s_first =
      static_cast<unsigned>(__cvta_generic_to_shared(&smem[0][0])) +
      4u * (sk * PITCH + sm);
  const unsigned s_alpha =
      static_cast<unsigned>(__cvta_generic_to_shared(&smem[0][FC * PITCH]));
  const int g_first = sm * d + sk, g_step = MSTEP * d;
  auto stage = [&](int n0, int f0, int bi) {
    const unsigned dst = s_first + 4u * STAGE * bi;
    const bool feat = f0 + sk < d;
    const int left = n - n0 - sm;              // copy i is in if i MSTEP < it
    int off = n0 * d + f0 + g_first;
#pragma unroll
    for (int i = 0; i < TILE_N / MSTEP; ++i) {
      const bool in = feat && i * MSTEP < left;
      cp_async4(dst + 4u * i * MSTEP, x + (in ? off : 0), in);
      off += g_step;
    }
    if (f0 + FC >= d) {
#pragma unroll
      for (int j = 0; j < (TILE_N + THREADS - 1) / THREADS; ++j) {
        const int m = j * THREADS + tid;
        const bool in = n0 + m < n;
        if (m < TILE_N)
          cp_async4(s_alpha + 4u * (STAGE * bi + m), al + (in ? n0 + m : 0),
                    in);
      }
    }
  };

  // this thread's scaled queries z' = z s and the scales s of chunk f0
  // (0 past D and for queries past B)
  float zq[ROWS][FC], s[FC];
  auto load_queries = [&](int f0) {
#pragma unroll
    for (int k = 0; k < FC; ++k) {
      const bool in = f0 + k < d;
      s[k] = in ? __fdividef(SCALE, el[f0 + k]) : 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        zq[r][k] = in && q0 + r < b ? z[(q0 + r) * d + f0 + k] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < FC; ++k)
#pragma unroll
      for (int r = 0; r < ROWS; ++r) zq[r][k] *= s[k];
  };

  // tiles in order: the feature chunks of points 0 .. TILE_N - 1, then of
  // the next TILE_N points, ...
  auto next = [&](int& a0, int& b0) {
    b0 += FC;
    if (b0 >= d) {
      b0 = 0;
      a0 += TILE_N;
    }
  };

  // ---- the prologue: one round trip for tile 0, the queries, ell, sf2
  stage(0, 0, 0);
  cp_async_commit();
  const float sf = sf2[dim];
  load_queries(0);

  float d2[ROWS][LANE_N] = {};
  float acc[ROWS] = {};
  const bool vec = (n % LANE_N) == 0;
  float* row_ks[ROWS];                         // this warp's k* rows
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    row_ks[r] = ks + (static_cast<size_t>(dim) * b + q0 + r) * n;
  const int c = lane * LANE_N;                 // this lane's first point
  int n0 = 0, f0 = 0;                          // the tile computed
  int in0 = 0, if0 = 0;                        // the tile staged next
  next(in0, if0);
  for (int t = 0; t < tiles; ++t) {
    if (t + 1 < tiles) {                       // in flight meanwhile
      stage(in0, if0, (t + 1) & 1);
      next(in0, if0);
    }
    cp_async_commit();
    if (fchunks > 1 && t > 0) load_queries(f0);
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = smem[t & 1];
    const int kn = d - f0;                     // features left in the chunk
#pragma unroll
    for (int k = 0; k < FC; ++k) {
      if (k >= kn) break;
      const float4 xv = *reinterpret_cast<const float4*>(xs + k * PITCH + c);
      const float xq[LANE_N] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
#pragma unroll
        for (int q = 0; q < LANE_N; ++q) {
          const float diff = fmaf(xq[q], -s[k], zq[r][k]);
          d2[r][q] = fmaf(diff, diff, d2[r][q]);
        }
    }
    if (f0 + FC >= d) {                        // the tile's last chunk
      const float4 av =
          *reinterpret_cast<const float4*>(xs + FC * PITCH + c);
      const float a[LANE_N] = {av.x, av.y, av.z, av.w};
      const int col = n0 + c;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        float v[LANE_N];
#pragma unroll
        for (int q = 0; q < LANE_N; ++q) {
          v[q] = sf * exp2_approx(-d2[r][q]);
          acc[r] = fmaf(v[q], a[q], acc[r]);
          d2[r][q] = 0.f;
        }
        if (q0 + r >= b || col >= n) continue;
        float* dst = row_ks[r] + col;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
#pragma unroll
          for (int q = 0; q < LANE_N; ++q)
            if (col + q < n) dst[q] = v[q];
        }
      }
    }
    if (t + 1 < tiles) __syncthreads();       // buffer t & 1 read by all
    next(n0, f0);
  }

  // ---- mu: a fixed butterfly over the warp's lanes
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    float v = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && q0 + r < b)
      mu[static_cast<size_t>(dim) * b + q0 + r] = v;
  }
}

}  // namespace

// C interface, loaded with ctypes.  z (b, d), x (n, d), ell (ny, d),
// sf2 (ny,), alpha (ny, n); outputs mu (ny, b) and ks (ny, b, n); all
// contiguous float32 on the device, ks 16-byte aligned.  Enqueues on
// `stream`, never synchronises; returns the CUDA error of the launch, 0 on
// success.
extern "C" int gpmpc_gp_predict_batch_f32(const float* z, const float* x,
                                          const float* ell, const float* sf2,
                                          const float* alpha, float* mu,
                                          float* ks, int ny, int b, int n,
                                          int d, void* stream) {
  // z, x and ell are indexed in int
  if (ny <= 0 || b <= 0 || n <= 0 || d <= 0 || ny > 65535 ||
      static_cast<long long>(n) * d > INT_MAX ||
      static_cast<long long>(b) * d > INT_MAX ||
      static_cast<long long>(ny) * d > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((b + QT - 1) / QT, ny);
  gp_predict_batch_kernel<<<blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      z, x, ell, sf2, alpha, mu, ks, b, n, d);
  return static_cast<int>(cudaGetLastError());
}
