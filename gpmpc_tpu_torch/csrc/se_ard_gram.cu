// SE-ARD Gram matrices of P problems that share one point set:
//   K[p] = sf2[p] * exp(-0.5 * ||(x_i - x_j) / ell[p]||^2),
//   diagonal written exactly as sf2[p] + sn2[p] + jitter * sf2[p].
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:se_ard_gram_pallas (body
// _gram_kernel).  Same function as the plain version
// gpmpc_tpu_torch/ops/gp_cuda.py:se_ard_gram_reference; the tile-pair
// schedule is mirrored in plain PyTorch by gp_cuda.se_ard_gram_pairs_reference
// (TILE there is gp_cuda.GRAM_TILE).
//
// What bounds it on an H100.  At the training path's shape (P = 8, N = 100,
// D = 6) the kernel writes 320 KB and does ~1.7 MFLOP: far below one
// launch, so what counts is the latency of its one block's work.  At large N
// the output write bounds it: P = 4, N = 1000 writes 16 MB, 4.8 us at
// 3.35 TB/s, against ~1.3 us of f32 arithmetic at 67 TFLOP/s.  No tensor
// cores: D = 6 is far under wgmma's depth, TF32 would lose the digits that
// the Gram's cancellation needs (ROADMAP "Numerics"), and the kernel is
// write-bound where it is not latency-bound.
//
// Design.  One block of 128 threads per (problem p, tile pair I <= J) of
// TILE x TILE tiles, so the grid is P * T(T+1)/2 blocks for T = ceil(N/TILE)
// tiles a side (80 at the training shape) and every exp is taken once:
//  * one device round trip before any arithmetic: every thread issues its
//    loads of the block's row and column points, of ell[p] and of sf2[p] and
//    sn2[p] before it uses any of them, then stores the points scaled by
//    sqrt(log2(e) / 2) / ell into shared memory, k-major, and the block
//    meets one barrier.  Nothing is read from device memory after that (for
//    D <= 8; a larger D takes one more round trip per 8 dims).  The
//    prologue is kept short, since at the training shape it is most of a
//    block's time: no integer division, no IEEE division or square root
//    (whose slow-path branches the compiler lays out around each use);
//  * any D: the features are staged in chunks of DCHUNK = 256, d2
//    accumulating in registers across chunks, one barrier between chunks;
//    D <= DCHUNK (every configuration the port runs) is one chunk and its
//    own instantiation, without the chunk loop (the loop cost the D = 6
//    shapes up to 12% on the card), and shared memory holds at most 2 x 256 x 32
//    points (64 KB);
//  * each thread computes two runs of 4 consecutive columns, in rows r and
//    r + 16 of tile (I, J), by the direct difference sum over D, which is more
//    accurate in f32 than the norm expansion the plain version uses, then
//    sf2 exp2(-d2') by one MUFU.EX2, and writes each run with one 16-byte
//    store, so a warp writes 4 rows of 128 bytes.  A row start is 16-byte
//    aligned only when N % 4 == 0; other N, and runs that cross the ragged
//    edge, take 4-byte stores with a mask;
//  * off the diagonal the block also writes tile (J, I): the tile goes
//    through shared memory (row pitch TILE + 1, free of bank conflicts both
//    ways) and is stored transposed with the same 16-byte runs.  The output
//    is therefore exactly symmetric; a diagonal tile is written once, and
//    is symmetric because (a - b)^2 == (b - a)^2 in IEEE arithmetic.
// Measured on the H100 (PERF.md): 256 threads with one run each, 64 with
// four, 64-wide tiles and a persistent grid of resident blocks walking the
// pairs were each slower at N = 100 or at N = 1000.
// The stores are plain write-back stores: K5 reads the matrix next, and at
// the sizes the port fits (16 MB at N = 1000, P = 4) it stays in the 50 MB
// L2.  The Pallas kernel's (8, 128) padding and 1e6 sentinel rows exist for
// the TPU's layout and have no counterpart here: the ragged edge is masked.

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int TILE = 32;
constexpr int THREADS = 128;
constexpr int RUN = 4;                      // columns per run, one float4
constexpr int RUNS = TILE / RUN;            // runs per tile row
constexpr int ROW_STEP = THREADS / RUNS;    // rows between a thread's runs
constexpr int ROWS = TILE / ROW_STEP;       // runs per thread
constexpr int PER_PASS = 4;                 // point loads per thread per pass
constexpr int DCHUNK = 256;                 // features staged per chunk
static_assert(ROWS * ROW_STEP == TILE, "whole runs per thread");
// sqrt(log2(e) / 2): points scaled by this / ell give d2' = d2 log2(e) / 2,
// and exp(-d2 / 2) = exp2(-d2')
constexpr float SCALE = 0.84932180028801904272f;

__device__ __forceinline__ float exp2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float sqrt_approx(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// CHUNKED: D > DCHUNK, the features walked in chunks; else one chunk, the
// code of a fixed D with no chunk loop
template <bool CHUNKED>
__global__ void __launch_bounds__(THREADS)
se_ard_gram_kernel(const float* __restrict__ x, const float* __restrict__ ell,
                   const float* __restrict__ sf2, const float* __restrict__ sn2,
                   float jitter, float* __restrict__ out, int n, int d) {
  extern __shared__ __align__(16) float smem[];
  float* pts = smem;                        // (2, dc, TILE): rows, then cols
  float* tile = smem + 2 * TILE * (CHUNKED ? DCHUNK : d);  // (TILE, TILE+1)
  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int t = blockIdx.x;
  // pair index -> (I, J), I <= J, J-major: t = J (J + 1) / 2 + I; the
  // approximate root is off by at most one, which the two tests repair
  int tj = static_cast<int>((sqrt_approx(8.f * t + 1.f) - 1.f) * 0.5f);
  if ((tj + 1) * (tj + 2) / 2 <= t) ++tj;
  if (tj * (tj + 1) / 2 > t) --tj;
  const int ti = t - tj * (tj + 1) / 2;
  const int i0 = ti * TILE, j0 = tj * TILE;
  const bool diag_tile = ti == tj;

  // ---- the prologue: one round trip for the points, ell, sf2 and sn2,
  // per chunk of at most DCHUNK features (one chunk for D <= DCHUNK).
  // Element f of a side's chunk is point f / dc, feature f0 + f % dc, with
  // f / dc taken in float (exact: f < TILE * DCHUNK = 2^13 and the quotient
  // is at least 0.5 / dc from an integer, where the float error is below
  // 2^13 * 2^-21 / dc).
  const float s = sf2[p];
  const float noise = sn2[p];
  const float* el = ell + p * d;
  const int r0 = tid / RUNS;
  const int c0 = (tid % RUNS) * RUN;
  float d2[ROWS][RUN] = {};
  for (int f0 = 0; f0 < (CHUNKED ? d : 1); f0 += DCHUNK) {
    const int dc = CHUNKED ? min(DCHUNK, d - f0) : d;
    const int span = TILE * dc;             // floats of one side's chunk
    const int total = diag_tile ? span : 2 * span;
    const int row_end = min(TILE, n - i0) * dc;
    const int col_end = min(TILE, n - j0) * dc;
    const float inv_d = __fdividef(1.f, static_cast<float>(dc));
    if (f0 > 0) __syncthreads();            // the last chunk read by all
    for (int base = 0; base < total; base += PER_PASS * THREADS) {
      float xv[PER_PASS], ev[PER_PASS];
      int dst[PER_PASS];
#pragma unroll
      for (int q = 0; q < PER_PASS; ++q) {
        const int e = base + q * THREADS + tid;
        const int side = e >= span;         // 0 rows, 1 cols
        const int f = e - side * span;
        const int r = __float2int_rz((f + 0.5f) * inv_d);
        const int k = f - r * dc;
        const bool in = e < total && f < (side ? col_end : row_end);
        // point (side ? j0 : i0) + r, feature f0 + k
        xv[q] = in ? x[(side ? j0 : i0) * d + f0 + f + r * (d - dc)] : 0.f;
        ev[q] = in ? el[f0 + k] : 1.f;
        dst[q] = e < total ? side * span + k * TILE + r : -1;
      }
#pragma unroll
      for (int q = 0; q < PER_PASS; ++q)
        if (dst[q] >= 0) pts[dst[q]] = xv[q] * __fdividef(SCALE, ev[q]);
    }
    __syncthreads();

    // ---- tile (I, J): rows r0 + m ROW_STEP, columns c0 .. c0 + 3
    const float* rows = pts;
    const float* cols = diag_tile ? pts : pts + span;
#pragma unroll 4
    for (int k = 0; k < dc; ++k) {
      const float4 b = *reinterpret_cast<const float4*>(cols + k * TILE + c0);
      const float bv[RUN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int m = 0; m < ROWS; ++m) {
        const float a = rows[k * TILE + r0 + m * ROW_STEP];
#pragma unroll
        for (int q = 0; q < RUN; ++q) {
          const float diff = a - bv[q];
          d2[m][q] += diff * diff;
        }
      }
    }
  }
  float v[ROWS][RUN];
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int q = 0; q < RUN; ++q)
      // exactly sf2 + sn2 + jitter * sf2 on the diagonal, no FMA contraction
      v[m][q] = (i0 + r0 + m * ROW_STEP == j0 + c0 + q)
                    ? __fadd_rn(__fadd_rn(s, noise), __fmul_rn(jitter, s))
                    : s * exp2_approx(-d2[m][q]);
  float* const out_p = out + static_cast<size_t>(p) * n * n;
  const bool vec = (n % RUN) == 0;
  auto store_run = [&](int row, int col, const float* w) {
    if (row >= n) return;
    float* dst = out_p + row * n + col;
    if (vec && col + RUN <= n) {
      *reinterpret_cast<float4*>(dst) = make_float4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int q = 0; q < RUN; ++q)
        if (col + q < n) dst[q] = w[q];
    }
  };
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
    store_run(i0 + r0 + m * ROW_STEP, j0 + c0, v[m]);
  if (diag_tile) return;

  // ---- tile (J, I) = tile (I, J)^T through shared memory
#pragma unroll
  for (int m = 0; m < ROWS; ++m)
#pragma unroll
    for (int q = 0; q < RUN; ++q)
      tile[(r0 + m * ROW_STEP) * (TILE + 1) + c0 + q] = v[m][q];
  __syncthreads();
#pragma unroll
  for (int m = 0; m < ROWS; ++m) {
    float w[RUN];
#pragma unroll
    for (int q = 0; q < RUN; ++q)
      w[q] = tile[(c0 + q) * (TILE + 1) + r0 + m * ROW_STEP];
    store_run(j0 + r0 + m * ROW_STEP, i0 + c0, w);
  }
}

}  // namespace

// C interface, loaded with ctypes.  x (n, d), ell (batch, d), sf2 (batch,),
// sn2 (batch,), out (batch, n, n), all contiguous float32 on the device.
extern "C" int gpmpc_se_ard_gram_f32(const float* x, const float* ell,
                                     const float* sf2, const float* sn2,
                                     float jitter, float* out, int batch,
                                     int n, int d, void* stream) {
  // n * n, n * d and batch * d are indexed in int
  if (batch <= 0 || n <= 0 || n > 46340 || d <= 0 || batch > 65535 ||
      static_cast<long long>(n) * d > INT_MAX ||
      static_cast<long long>(batch) * d > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n + TILE - 1) / TILE;
  const dim3 blocks(tiles * (tiles + 1) / 2, batch);
  const size_t shared =
      (2 * TILE * (d < DCHUNK ? d : DCHUNK) + TILE * (TILE + 1)) *
      sizeof(float);
  const auto kernel = d > DCHUNK ? &se_ard_gram_kernel<true>
                                 : &se_ard_gram_kernel<false>;
  if (shared > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, THREADS, shared, static_cast<cudaStream_t>(stream)>>>(
      x, ell, sf2, sn2, jitter, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
