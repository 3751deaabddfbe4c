// Lower Cholesky factors of P symmetric positive-definite matrices.
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:cholesky_pallas (body
// _chol_kernel: a right-looking factor over 128-wide panels with the whole
// matrix in VMEM).  Same function as the plain version
// gpmpc_tpu_torch/ops/gp_cuda.py:cholesky_reference (LAPACK/cuSOLVER
// through torch.linalg.cholesky_ex).  Two paths; the wrapper picks one by
// the order N against gp_cuda.CHOL_ONE_BLOCK_MAX_N, set from device times
// on the card (`chip_smoke.py --k5-paths`).
//
// One-block path (small N: the GP fit's P = 8, N = 100).  What bounds it
// on an H100: latency.  A factor is 2.7 MFLOP and 482 KB for all 8
// matrices, a fraction of a microsecond of the card's rate; what costs is
// the chain of dependent column steps and what each step waits on (an
// unblocked factor crosses 2 block barriers per column, 200 at N = 100).
// Design: one block per matrix, the packed lower triangle in shared memory
// (fits up to N ~ 337), factored by factor_packed in panels of 32 columns
// with 3 block barriers per panel (12 at N = 100): warp 0 factors the
// panel's 32 x 32 diagonal block with each row in a lane's registers (a
// column step is one shared-memory exchange, __syncwarp, an rsqrt and ~31
// FMAs; the next column is published before the rest of the update), every
// thread solves one row of the panel below it, and the block applies the
// rank-32 trailing update in 4x4 register tiles.
//
// Blocked path (larger N).  What bounds it: at N = 1024 the 3.6e8 FLOP take
// 5.3 us at the f32 peak (67 TFLOP/s), which no single SM comes near, so
// the O(N^3) trailing work has to spread over all SMs; what remains is the
// chain of panels, each a few microseconds of dependent latency.  Design:
// a right-looking blocked factor over panels of NB = 32 columns (faster
// than 64 at every N measured on the card, PERF.md), two grids per panel
// and one pass at the end:
//   (a)+(b) chol_panel_kernel, grid (row tiles of ROWS rows below the
//       diagonal tile) x P: every block stages the NB x NB diagonal tile
//       with cp.async and factors it as the one-block path does (so no
//       separate launch and wait for it), while its rows' copy lands, then
//       solves its rows x L_kk^T = a, one thread per row with the row in
//       registers and no block barrier inside the solve;
//   (c) chol_trailing_update_kernel, grid (lower tile pairs i >= j of the
//       trailing matrix) x P: the two panel tiles staged with cp.async in
//       two stages along the panel (the second stage's copy overlaps the
//       first's products), each thread's A_ij entries loaded meanwhile,
//       A_ij -= P_i P_j^T in a 2x2 register micro-tile of FP32 FMA.
//       No tensor cores: f32 on them is TF32, which the port keeps off
//       (ROADMAP "Numerics");
//   (d) chol_finish_kernel: the upper triangle to 0, and NaN over the whole
//       lower triangle of each flagged matrix (a bad pivot's NaN reaches
//       only the panels after it).
// Panel 0 reads the input and writes the output, so no copy precedes it;
// ragged edges are masked, not padded.  2 ceil(N / NB) launches a call.
//
// Contract: a non-positive (or NaN) pivot gives NaN in the whole lower
// triangle of that matrix only, like torch.linalg.cholesky_ex as the plain
// version uses it and jnp.linalg.cholesky: the pivot is never clamped (the
// Pallas kernel's 1e-30 clamp returns finite garbage instead).  The upper
// triangle is 0.  Pivots go through rsqrtf (2 ulp) and multiplies, not
// sqrt and divisions, which would lengthen every column step.  The Pallas
// kernel's 128-wide identity padding and its one-hot matmuls exist for the
// TPU's layout and have no counterpart here.

#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int PW = 32;            // panel width of the one-block factor
constexpr int MAX_THREADS = 512;  // threads of a one-block-path block
constexpr int NB = 32;            // panel width of the blocked path
constexpr int ROWS = 64;          // panel rows per block of the blocked path

__device__ __forceinline__ int tri(int i, int k) {
  return i * (i + 1) / 2 + k;
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
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

// (rb, cb) with rb >= cb of the idx-th lower-triangular tile pair, row-major
__device__ __forceinline__ void tile_pair(int idx, int& rb, int& cb) {
  rb = static_cast<int>((sqrtf(8.f * idx + 1.f) - 1.f) * 0.5f);
  while ((rb + 1) * (rb + 2) / 2 <= idx) ++rb;
  while (rb * (rb + 1) / 2 > idx) --rb;
  cb = idx - rb * (rb + 1) / 2;
}

// Factor the packed lower triangle t (order n) in shared memory in place,
// in panels of PW columns, three phases and a block barrier after each:
// (1) warp 0 factors the panel's diagonal block with its rows in registers
// (each column passed through shared memory, the pivot's reciprocal
// square root kept in dinv); (2) every thread solves one row below it
// against that block; (3) the block applies the rank-PW update to the
// trailing triangle in 4x4 register tiles.  dinv (n floats, shared) ends
// as the factor's inverse diagonal.  Sets *bad on a non-positive or NaN
// pivot.  Every thread of the block calls it.
__device__ __forceinline__ void factor_packed(float* t, float* dinv, int n,
                                              int* bad) {
  __shared__ float col[2][PW];
  const int tid = threadIdx.x, nthreads = blockDim.x;
  for (int off = 0; off < n; off += PW) {
    const int w = min(PW, n - off), end = off + w;
    if (tid < 32) {                                // (1) diagonal block
      const int lane = tid;
      const int row = tri(off + lane, off);
      float r[PW];
#pragma unroll
      for (int k = 0; k < PW; ++k)
        r[k] = lane < w && k <= lane ? t[row + k] : 0.f;
      float my_rs = 0.f;                           // lane c keeps 1/L_cc
      bool failed = false;
      // column c is published (not yet scaled) into col[c & 1] before step
      // c: two buffers, so one __syncwarp a step keeps each write behind
      // the last step's reads
      col[0][lane] = r[0];
#pragma unroll
      for (int c = 0; c < PW; ++c) {
        if (c >= w) break;
        __syncwarp();
        float a[PW];                               // a_kc, k >= c
#pragma unroll
        for (int k = c; k < PW; ++k) a[k] = col[c & 1][k];
        const float pivot = a[c];
        const float rs = rsqrtf(pivot);            // NaN for a bad pivot
        const float lic = r[c] * rs;               // L_ic for lane i > c
        const float g = lic * rs;                  // L_ic L_kc = g a_kc
        r[c] = lane == c ? pivot * rs : lic;
        my_rs = lane == c ? rs : my_rs;
        failed |= !(pivot > 0.f);
        // for k > lane these update the upper triangle, never read
        if (c + 1 < PW) {
          r[c + 1] -= g * a[c + 1];
          col[(c + 1) & 1][lane] = r[c + 1];
        }
#pragma unroll
        for (int k = c + 2; k < PW; ++k) r[k] -= g * a[k];
      }
#pragma unroll
      for (int k = 0; k < PW; ++k)
        if (lane < w && k <= lane) t[row + k] = r[k];
      if (lane < w) dinv[off + lane] = my_rs;
      if (lane == 0 && failed) *bad = 1;
    }
    __syncthreads();
    for (int i = end + tid; i < n; i += nthreads) {  // (2) panel solve
      const int row = tri(i, off);
      float x[PW];
#pragma unroll
      for (int k = 0; k < PW; ++k) x[k] = t[row + k];  // w == PW here
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        x[j] *= dinv[off + j];
#pragma unroll
        for (int m = j + 1; m < PW; ++m)
          x[m] -= x[j] * t[tri(off + m, off + j)];
      }
#pragma unroll
      for (int k = 0; k < PW; ++k) t[row + k] = x[k];
    }
    __syncthreads();
    // (3) trailing update of rows and columns >= end, 4x4 tiles i >= j
    const int m = n - end, nt = (m + 3) / 4;
    for (int idx = tid; idx < nt * (nt + 1) / 2; idx += nthreads) {
      int rb, cb;
      tile_pair(idx, rb, cb);
      const int i0 = end + 4 * rb, k0 = end + 4 * cb;
      int ri[4], rk[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ri[r] = i0 + r < n ? tri(i0 + r, 0) : -1;
        rk[r] = k0 + r < n ? tri(k0 + r, 0) : -1;
      }
      float acc[4][4] = {};
      for (int p = off; p < end; ++p) {
        float a[4], b[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          a[r] = ri[r] >= 0 ? t[ri[r] + p] : 0.f;
          b[r] = rk[r] >= 0 ? t[rk[r] + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] += a[r] * b[q];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (ri[r] >= 0 && k0 + q <= i0 + r) t[ri[r] + k0 + q] -= acc[r][q];
    }
    __syncthreads();
  }
}

// One-block path: matrix blockIdx.x whole, written with its upper triangle
// 0 and, on a bad pivot, NaN in its lower triangle.
__global__ void __launch_bounds__(MAX_THREADS)
chol_one_block_kernel(const float* __restrict__ a, float* __restrict__ out,
                      int n) {
  extern __shared__ float t[];                 // packed triangle, then dinv
  __shared__ int bad;
  const size_t base = static_cast<size_t>(blockIdx.x) * n * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;          // a warp per row
  if (threadIdx.x == 0) bad = 0;
  for (int i = warp; i < n; i += nwarps)
    for (int k = lane; k <= i; k += 32)
      cp_async4(&t[tri(i, k)], a + base + static_cast<size_t>(i) * n + k,
                true);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  factor_packed(t, t + n * (n + 1) / 2, n, &bad);
  const bool failed = bad != 0;
  for (int i = warp; i < n; i += nwarps)
    for (int k = lane; k < n; k += 32)
      out[base + static_cast<size_t>(i) * n + k] =
          k > i ? 0.f : (failed ? NAN : t[tri(i, k)]);
}

// (a) + (b) of panel [off, off + NB): every block stages and factors the
// diagonal tile (as the one-block path does) and solves its ROWS rows of
// the panel below it, x L_kk^T = a, one thread per row with the row in
// registers.  Block 0 sets the failure flag and writes L_kk: into dst when
// this is the last panel, else into the scratch tile `work`, which the
// trailing update copies into place (the other blocks may still be reading
// A_kk from dst).
__global__ void __launch_bounds__(ROWS)
chol_panel_kernel(const float* src, float* dst, float* __restrict__ work,
                  int* __restrict__ flags, int n, int off) {
  __shared__ float tile[NB * (NB + 1) / 2];
  __shared__ float dinv[NB];
  __shared__ float rows[ROWS][NB + 1];
  __shared__ int bad;
  const size_t base = static_cast<size_t>(blockIdx.y) * n * n;
  const size_t at = base + static_cast<size_t>(off) * n + off;
  const int tid = threadIdx.x;
  const int w = min(NB, n - off), below = n - off - w;
  const int r0 = off + NB + blockIdx.x * ROWS;
  constexpr int STEP = ROWS / NB;               // rows staged per pass
  const int kc = tid % NB;                     // column staged
  if (tid == 0) bad = 0;
  for (int i = tid / NB; i < w; i += STEP)     // group 0: the tile
    if (kc <= i)
      cp_async4(&tile[tri(i, kc)], src + at + static_cast<size_t>(i) * n + kc,
                true);
  cp_async_commit();
  if (below > 0)                               // group 1: this block's rows
    for (int r = tid / NB; r < ROWS; r += STEP) {
      const bool valid = r0 + r < n;
      cp_async4(&rows[r][kc],
                src + base + static_cast<size_t>(valid ? r0 + r : off) * n
                    + off + kc, valid);
    }
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  factor_packed(tile, dinv, w, &bad);          // overlaps the rows' copy
  cp_async_wait<0>();
  __syncthreads();
  if (below > 0) {
    float x[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) x[k] = rows[tid][k];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      x[j] *= dinv[j];
#pragma unroll
      for (int m = j + 1; m < NB; ++m) x[m] -= x[j] * tile[tri(m, j)];
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) rows[tid][k] = x[k];
    __syncthreads();
    for (int r = tid / NB; r < ROWS; r += STEP)
      if (r0 + r < n)
        dst[base + static_cast<size_t>(r0 + r) * n + off + kc] = rows[r][kc];
  }
  if (blockIdx.x != 0) return;
  if (tid == 0 && bad) flags[blockIdx.y] = 1;
  for (int i = tid / NB; i < w; i += STEP) {
    if (kc > i) continue;
    if (below > 0)
      work[static_cast<size_t>(blockIdx.y) * NB * NB + i * NB + kc] =
          tile[tri(i, kc)];
    else
      dst[at + static_cast<size_t>(i) * n + kc] = tile[tri(i, kc)];
  }
}

// (c) trailing update A_ij -= P_i P_j^T over NB x NB tiles of the
// trailing matrix (rows, columns >= off + NB), lower tile pairs only; the
// first block of each matrix also copies L_kk from `work` into place
__global__ void __launch_bounds__(256)
chol_trailing_update_kernel(const float* src, float* dst,
                            const float* __restrict__ work, int n, int off) {
  constexpr int TM = NB / 16, HALF = NB / 2;
  __shared__ float pi[NB][NB + 1];
  __shared__ float pj[NB][NB + 1];
  const size_t base = static_cast<size_t>(blockIdx.y) * n * n;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = off + NB;
  int ti, tj;
  tile_pair(blockIdx.x, ti, tj);
  const int r0 = t0 + ti * NB, c0 = t0 + tj * NB;
  const float* panel = dst + base + off;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    for (int e = tid; e < NB * HALF; e += 256) {
      const int r = e / HALF, k = s * HALF + (e - r * HALF);
      const bool vi = r0 + r < n, vj = c0 + r < n;
      cp_async4(&pi[r][k], panel + static_cast<size_t>(vi ? r0 + r : 0) * n
                + k, vi);
      cp_async4(&pj[r][k], panel + static_cast<size_t>(vj ? c0 + r : 0) * n
                + k, vj);
    }
    cp_async_commit();
  }
  float acc[TM][TM];                 // this thread's A_ij, loaded meanwhile
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int i = r0 + ty + 16 * r, k = c0 + tx + 16 * q;
      acc[r][q] = i < n && k <= i
          ? src[base + static_cast<size_t>(i) * n + k] : 0.f;
    }
  if (blockIdx.x == 0)
    for (int e = tid; e < NB * NB; e += 256) {
      const int i = e / NB, k = e - i * NB;
      if (k <= i)
        dst[base + static_cast<size_t>(off + i) * n + off + k] =
            work[static_cast<size_t>(blockIdx.y) * NB * NB + e];
    }
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (s == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    __syncthreads();
#pragma unroll 8
    for (int k = s * HALF; k < (s + 1) * HALF; ++k) {
      float a[TM], b[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        a[r] = pi[ty + 16 * r][k];
        b[r] = pj[tx + 16 * r][k];
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int q = 0; q < TM; ++q) acc[r][q] -= a[r] * b[q];
    }
  }
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TM; ++q) {
      const int i = r0 + ty + 16 * r, k = c0 + tx + 16 * q;
      if (i < n && k <= i)
        dst[base + static_cast<size_t>(i) * n + k] = acc[r][q];
    }
}

// (d) upper triangle to 0; NaN over the lower triangle of flagged matrices
__global__ void chol_finish_kernel(float* __restrict__ out,
                                   const int* __restrict__ flags, int n) {
  const size_t base = static_cast<size_t>(blockIdx.y) * n * n;
  const bool failed = flags[blockIdx.y] != 0;
  const int nn = n * n;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < nn;
       e += gridDim.x * blockDim.x) {
    const int i = e / n, k = e - i * n;
    if (k > i) out[base + e] = 0.f;
    else if (failed) out[base + e] = NAN;
  }
}

int threads_for(int n) {
  // enough threads for the first trailing update's 4x4 tiles, in warps
  const int nt = (n > PW ? n - PW + 3 : 0) / 4;
  const int want = (nt * (nt + 1) / 2 + 31) / 32 * 32;
  return want < 64 ? 64 : (want > MAX_THREADS ? MAX_THREADS : want);
}

cudaError_t blocked(const float* a, float* out, int* flags, float* work,
                    int batch, int n, cudaStream_t s) {
  for (int off = 0; off < n; off += NB) {
    const float* src = off == 0 ? a : out;
    const int below = n - off - NB;
    const int row_blocks = below > 0 ? (below + ROWS - 1) / ROWS : 1;
    chol_panel_kernel<<<dim3(row_blocks, batch), ROWS, 0, s>>>(
        src, out, work, flags, n, off);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (below <= 0) break;
    const int tiles = (below + NB - 1) / NB;
    chol_trailing_update_kernel<<<dim3(tiles * (tiles + 1) / 2, batch), 256,
                                  0, s>>>(src, out, work, n, off);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  int blocks = (n * n + 255) / 256;
  if (blocks > 256) blocks = 256;
  chol_finish_kernel<<<dim3(blocks, batch), 256, 0, s>>>(out, flags, n);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  a and out (batch, n, n), contiguous
// float32 on the device; a is read only in its lower triangle.  blocked
// = 0 takes the one-block path (flags and work unused, may be null);
// otherwise the blocked path, with flags (batch,) int32 zeroed by the
// caller and work (batch, 32, 32) float32 scratch.
// Enqueues on `stream`, never synchronises; returns the first CUDA error
// of a launch, 0 on success.
extern "C" int gpmpc_cholesky_f32(const float* a, float* out, int* flags,
                                  float* work, int batch, int n,
                                  int blocked_path, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocked_path)
    return static_cast<int>(blocked(a, out, flags, work, batch, n, s));
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t packed =
      (static_cast<size_t>(n) * (n + 1) / 2 + n) * sizeof(float);
  if (packed + 64 > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(chol_one_block_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(packed));
  if (err != cudaSuccess) return static_cast<int>(err);
  chol_one_block_kernel<<<batch, threads_for(n), packed, s>>>(a, out, n);
  return static_cast<int>(cudaGetLastError());
}
