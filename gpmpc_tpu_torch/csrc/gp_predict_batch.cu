// Batched GP cross-covariance and mean for Ny output dims:
//   ks[d, b, n] = sf2[d] * exp(-0.5 * ||(z_b - x_n) / ell[d]||^2),
//   mu[d, b]    = sum_n ks[d, b, n] * alpha[d, n].
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:gp_predict_batch_pallas (body
// _predict_kernel), which runs one output dim per call; here one launch
// covers all Ny dims.  Same function as the plain version
// gpmpc_tpu_torch/ops/gp_cuda.py:gp_predict_batch_reference.  The caller
// completes the variance sf2 - ||L^-1 ks^T||^2 with a batched triangular
// solve, as the JAX package leaves that step to XLA.
//
// What bounds it on an H100: launch latency.  At validation's shape (B = 100
// queries, N = 100 points, Ny = 4, D = 6) it writes 160 KB of k* and does
// ~0.5 MFLOP: a twentieth of a microsecond of bandwidth.  At large B the
// bound is the k* write.  Design: one block per (tile of QB queries, output
// dim); the block stages its queries, pre-scaled by 1/ell of its dim, in
// shared memory, then walks the points in chunks of blockDim: thread m
// stages point m of the chunk, computes its k* against every query of the
// tile (consecutive threads write consecutive k* entries) and keeps the QB
// partial sums k* alpha in registers.  A warp-shuffle and shared-memory
// block reduction gives mu.  d^2 is the direct difference sum over D; the
// Pallas kernel's padded 1e6 sentinel points have no counterpart here.

#include <cuda_runtime.h>

namespace {

constexpr int QB = 8;          // queries per block
constexpr int THREADS = 128;   // points per chunk

__global__ void gp_predict_batch_kernel(const float* __restrict__ z,
                                        const float* __restrict__ x,
                                        const float* __restrict__ ell,
                                        const float* __restrict__ sf2,
                                        const float* __restrict__ alpha,
                                        float* __restrict__ mu,
                                        float* __restrict__ ks, int b, int n,
                                        int d) {
  extern __shared__ float smem[];
  float* zs = smem;                       // (QB, d)
  float* xs = smem + QB * d;              // (THREADS, d)
  __shared__ float red[THREADS / 32][QB];
  const int dim = blockIdx.y;
  const int q0 = blockIdx.x * QB;
  const int nq = min(QB, b - q0);
  const float* el = ell + static_cast<size_t>(dim) * d;
  const float s = sf2[dim];
  const float* al = alpha + static_cast<size_t>(dim) * n;
  float* ks_dim = ks + static_cast<size_t>(dim) * b * n;
  for (int t = threadIdx.x; t < QB * d; t += THREADS) {
    const int q = t / d, k = t % d;
    zs[t] = q < nq ? z[static_cast<size_t>(q0 + q) * d + k] / el[k] : 0.f;
  }
  float acc[QB];
#pragma unroll
  for (int q = 0; q < QB; ++q) acc[q] = 0.f;

  for (int n0 = 0; n0 < n; n0 += THREADS) {
    __syncthreads();                       // zs staged / previous chunk used
    for (int t = threadIdx.x; t < THREADS * d; t += THREADS) {
      const int m = t / d, k = t % d;
      xs[t] = n0 + m < n ? x[static_cast<size_t>(n0 + m) * d + k] / el[k]
                         : 0.f;
    }
    __syncthreads();
    const int m = n0 + threadIdx.x;
    if (m < n) {
      const float a = al[m];
      const float* xm = xs + threadIdx.x * d;
#pragma unroll
      for (int q = 0; q < QB; ++q) {
        if (q < nq) {
          const float* zq = zs + q * d;
          float d2 = 0.f;
          for (int k = 0; k < d; ++k) {
            const float diff = zq[k] - xm[k];
            d2 += diff * diff;
          }
          const float kv = s * expf(-0.5f * d2);
          ks_dim[static_cast<size_t>(q0 + q) * n + m] = kv;
          acc[q] += kv * a;
        }
      }
    }
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int q = 0; q < QB; ++q) {
    float v = acc[q];
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][q] = v;
  }
  __syncthreads();
  if (threadIdx.x < nq) {
    float total = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) total += red[w][threadIdx.x];
    mu[static_cast<size_t>(dim) * b + q0 + threadIdx.x] = total;
  }
}

}  // namespace

// C interface, loaded with ctypes.  z (b, d), x (n, d), ell (ny, d),
// sf2 (ny,), alpha (ny, n); outputs mu (ny, b) and ks (ny, b, n); all
// contiguous float32 on the device.
extern "C" int gpmpc_gp_predict_batch_f32(const float* z, const float* x,
                                          const float* ell, const float* sf2,
                                          const float* alpha, float* mu,
                                          float* ks, int ny, int b, int n,
                                          int d, void* stream) {
  if (ny <= 0 || b <= 0 || n <= 0 || d <= 0 || d > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 blocks((b + QB - 1) / QB, ny);
  const size_t shared = (QB + THREADS) * d * sizeof(float);
  gp_predict_batch_kernel<<<blocks, THREADS, shared,
                            static_cast<cudaStream_t>(stream)>>>(
      z, x, ell, sf2, alpha, mu, ks, b, n, d);
  return static_cast<int>(cudaGetLastError());
}
