// Lower Cholesky factors of P symmetric positive-definite matrices, one
// block per matrix.
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:cholesky_pallas (body
// _chol_kernel).  Same function as the plain version
// gpmpc_tpu_torch/ops/gp_cuda.py:cholesky_reference (LAPACK/cuSOLVER
// through torch.linalg.cholesky_ex).
//
// What bounds it on an H100: latency.  At the training path's shape
// (P = 8, N = 100) a factor is N = 100 dependent column steps of ~N^2/2
// multiply-adds, 2.7 MFLOP and 482 KB in all (the lower triangles read,
// the whole factors written): a fraction of a microsecond of bandwidth or
// arithmetic, far below one launch.  At N = 1024 the 3.6e8 FLOP of one
// factor are a few microseconds of the card's f32 rate spread over all
// SMs, but one block runs them in 1024 dependent steps, each a
// read-modify-write of the trailing triangle through one SM's path to
// L2: ~33 us a step, 100x cuSOLVER (a blocked multi-block path is
// ROADMAP work).  Design: one block per matrix; the columns in order
// (right-looking: scale column j by its pivot, then subtract its outer
// product from the
// trailing triangle), the rows and columns of each step in parallel across
// the block's threads, one __syncthreads between steps.  The lower
// triangle stays in dynamic shared memory (packed, N(N+1)/2 floats) while
// it fits in the 227 KB a block may have, so up to N ~ 330; above that the
// kernel factors in place in the output array, whose working set stays in
// the 50 MB L2.  Column j is staged in shared memory for the update.
//
// Contract: a non-positive (or NaN) pivot gives NaN in the whole lower
// triangle, like torch.linalg.cholesky_ex as the plain version uses it and
// jnp.linalg.cholesky: the pivot is never clamped (the Pallas kernel's
// 1e-30 clamp returns finite garbage instead).  The upper triangle is 0.
// The Pallas kernel's 128-wide panels, identity padding and one-hot
// matmuls exist for the TPU's layout and have no counterpart here.

#include <cmath>
#include <cuda_runtime.h>

namespace {

template <bool PACKED>
__device__ __forceinline__ int tri(int i, int k, int n) {
  return PACKED ? i * (i + 1) / 2 + k : i * n + k;
}

template <bool PACKED>
__global__ void cholesky_kernel(const float* __restrict__ a,
                                float* __restrict__ out, int n) {
  extern __shared__ float smem[];
  __shared__ int bad;
  const size_t off = static_cast<size_t>(blockIdx.x) * n * n;
  const float* src = a + off;
  float* dst = out + off;
  float* col = smem;                           // column j, (n,)
  float* t = PACKED ? smem + n : dst;          // the working lower triangle
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  if (tid == 0) bad = 0;
  for (int i = threadIdx.y; i < n; i += blockDim.y)
    for (int k = threadIdx.x; k <= i; k += blockDim.x)
      t[tri<PACKED>(i, k, n)] = src[static_cast<size_t>(i) * n + k];
  __syncthreads();

  for (int j = 0; j < n; ++j) {
    const float pivot = t[tri<PACKED>(j, j, n)];
    const float ljj = sqrtf(pivot);            // NaN for a negative pivot
    for (int i = j + 1 + tid; i < n; i += nthreads) {
      const float v = t[tri<PACKED>(i, j, n)] / ljj;
      t[tri<PACKED>(i, j, n)] = v;
      col[i] = v;
    }
    __syncthreads();                           // every thread read the pivot
    if (tid == 0) {
      t[tri<PACKED>(j, j, n)] = ljj;
      if (!(pivot > 0.f)) bad = 1;
    }
    for (int i = j + 1 + threadIdx.y; i < n; i += blockDim.y) {
      const float lij = col[i];
      for (int k = j + 1 + threadIdx.x; k <= i; k += blockDim.x)
        t[tri<PACKED>(i, k, n)] -= lij * col[k];
    }
    __syncthreads();
  }

  const bool failed = bad != 0;
  for (int i = threadIdx.y; i < n; i += blockDim.y)
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      float v = 0.f;
      if (k <= i) v = failed ? NAN : t[tri<PACKED>(i, k, n)];
      dst[static_cast<size_t>(i) * n + k] = v;
    }
}

}  // namespace

// C interface, loaded with ctypes.  a and out (batch, n, n), contiguous
// float32 on the device; a is read only in its lower triangle.
extern "C" int gpmpc_cholesky_f32(const float* a, float* out, int batch,
                                  int n, void* stream) {
  if (batch <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 threads(32, n <= 256 ? 8 : 32);
  const size_t packed =
      (static_cast<size_t>(n) * (n + 1) / 2 + n) * sizeof(float);
  if (packed + 64 <= static_cast<size_t>(optin)) {
    err = cudaFuncSetAttribute(cholesky_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(packed));
    if (err != cudaSuccess) return static_cast<int>(err);
    cholesky_kernel<true><<<batch, threads, packed, s>>>(a, out, n);
  } else {
    cholesky_kernel<false><<<batch, threads, n * sizeof(float), s>>>(a, out,
                                                                    n);
  }
  return static_cast<int>(cudaGetLastError());
}
