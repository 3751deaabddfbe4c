// SE-ARD Gram matrices of P problems that share one point set:
//   K[p] = sf2[p] * exp(-0.5 * ||(x_i - x_j) / ell[p]||^2),
//   diagonal written exactly as sf2[p] + sn2[p] + jitter * sf2[p].
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:se_ard_gram_pallas (body
// _gram_kernel).  Same function as the plain version
// gpmpc_tpu_torch/ops/gp_cuda.py:se_ard_gram_reference.
//
// What bounds it on an H100: launch latency.  At the training path's shape
// (P = 8 problems, N = 100 points, D = 6) the kernel writes 320 KB and does
// ~1.4 MFLOP, a tenth of a microsecond at 3.35 TB/s, far below one launch.
// The bound at large N is the output write (N^2 floats per problem).
// Design: a 2-D tile of 16 x 16 threads per block, one output entry per
// thread, over a grid of (column tiles, row tiles, problems); neighbouring
// threads write neighbouring columns, so the stores coalesce.  Each block
// stages its 16 row points and 16 column points, pre-scaled by 1/ell of its
// problem, in shared memory.  d^2 is the direct difference sum over D (D is
// small), which is more accurate in f32 than the norm expansion the plain
// version uses.  The Pallas kernel's (8, 128) padding and 1e6 sentinel rows
// exist for the TPU's layout and have no counterpart here: the ragged edge
// is masked.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 16;

__global__ void se_ard_gram_kernel(const float* __restrict__ x,
                                   const float* __restrict__ ell,
                                   const float* __restrict__ sf2,
                                   const float* __restrict__ sn2,
                                   float jitter, float* __restrict__ out,
                                   int n, int d) {
  extern __shared__ float smem[];
  float* rows = smem;               // (TILE, d) row points / ell
  float* cols = smem + TILE * d;    // (TILE, d) column points / ell
  const int p = blockIdx.z;
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
  const float* el = ell + static_cast<size_t>(p) * d;
  const int tid = threadIdx.y * TILE + threadIdx.x;
  for (int t = tid; t < TILE * d; t += TILE * TILE) {
    const int r = t / d, k = t % d;
    rows[t] = (i0 + r < n) ? x[static_cast<size_t>(i0 + r) * d + k] / el[k]
                           : 0.f;
    cols[t] = (j0 + r < n) ? x[static_cast<size_t>(j0 + r) * d + k] / el[k]
                           : 0.f;
  }
  __syncthreads();
  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= n || j >= n) return;
  const float s = sf2[p];
  float v;
  if (i == j) {
    // exactly sf2 + sn2 + jitter * sf2, no FMA contraction
    v = __fadd_rn(__fadd_rn(s, sn2[p]), __fmul_rn(jitter, s));
  } else {
    const float* a = rows + threadIdx.y * d;
    const float* b = cols + threadIdx.x * d;
    float d2 = 0.f;
    for (int k = 0; k < d; ++k) {
      const float diff = a[k] - b[k];
      d2 += diff * diff;
    }
    v = s * expf(-0.5f * d2);
  }
  out[(static_cast<size_t>(p) * n + i) * n + j] = v;
}

}  // namespace

// C interface, loaded with ctypes.  x (n, d), ell (batch, d), sf2 (batch,),
// sn2 (batch,), out (batch, n, n), all contiguous float32 on the device.
extern "C" int gpmpc_se_ard_gram_f32(const float* x, const float* ell,
                                     const float* sf2, const float* sn2,
                                     float jitter, float* out, int batch,
                                     int n, int d, void* stream) {
  if (batch <= 0 || n <= 0 || d <= 0 || d > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 threads(TILE, TILE);
  const dim3 blocks((n + TILE - 1) / TILE, (n + TILE - 1) / TILE, batch);
  const size_t shared = 2 * TILE * d * sizeof(float);
  se_ard_gram_kernel<<<blocks, threads, shared,
                       static_cast<cudaStream_t>(stream)>>>(
      x, ell, sf2, sn2, jitter, out, n, d);
  return static_cast<int>(cudaGetLastError());
}
