// Single-launch Riccati sweep over the block-banded KKT system of a
// trajectory QP: the backward factorization and the forward rollout.
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:riccati_sweep_pallas (body
// _riccati_kernel, _chol_cols_small, _chol_solve_small).  Same math as
// gpmpc_tpu_torch/solvers/riccati.py:solve and its plain twin
// gpmpc_tpu_torch/ops/cuda_kernels.py:riccati_sweep_reference.
//
// What bounds it on an H100: latency.  At the main path's size (Nt = 20
// stages, nx = 4, nu = 2) the whole sweep is ~20 dependent steps of 4x4
// products — a few thousand flops and ~10 KB of input, far below any
// roofline.  As plain tensor code every stage would be tens of kernel
// launches.  Design: one thread owns one problem (batch dim B, B = 1 on the
// main path) and runs the stage loop at run time; V_xx, V_x and the stage
// matrices live in registers, so no device-memory round trip happens
// between stages.  Gains and feedforwards go to the output arrays and the
// forward pass reads them back.  reg and dx0 are device pointers, so the
// caller never syncs the host to pass them.  A non-PD pivot of H_uu gives
// NaN (sqrtf of a negative), never a clamp: the caller's finiteness flag
// reads it.

#include <cuda_runtime.h>

namespace {

template <int NX, int NU>
__global__ void riccati_sweep_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ q_xx,
    const float* __restrict__ q_uu, const float* __restrict__ q_xu,
    const float* __restrict__ q_x, const float* __restrict__ q_u,
    const float* __restrict__ qf_xx, const float* __restrict__ qf_x,
    const float* __restrict__ dx0, const float* __restrict__ reg,
    float* __restrict__ dx, float* __restrict__ du,
    float* __restrict__ gains, float* __restrict__ ffs,
    float* __restrict__ dec_out, int batch, int nt) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  const size_t P = static_cast<size_t>(p);
  const size_t T = static_cast<size_t>(nt);
  a += P * T * NX * NX;
  b += P * T * NX * NU;
  c += P * T * NX;
  q_xx += P * T * NX * NX;
  q_uu += P * T * NU * NU;
  q_xu += P * T * NX * NU;
  q_x += P * T * NX;
  q_u += P * T * NU;
  qf_xx += P * NX * NX;
  qf_x += P * NX;
  dx0 += P * NX;
  dx += P * (T + 1) * NX;
  du += P * T * NU;
  gains += P * T * NU * NX;
  ffs += P * T * NU;
  const float r = reg[p];

  float vxx[NX][NX], vx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    vx[i] = qf_x[i];
#pragma unroll
    for (int j = 0; j < NX; ++j) vxx[i][j] = qf_xx[i * NX + j];
  }
  float dec = 0.f;

  for (int t = nt - 1; t >= 0; --t) {
    const float* at = a + t * NX * NX;
    const float* bt = b + t * NX * NU;
    float A[NX][NX], B[NX][NU], cc[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      cc[i] = c[t * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j) A[i][j] = at[i * NX + j];
#pragma unroll
      for (int j = 0; j < NU; ++j) B[i][j] = bt[i * NU + j];
    }
    // av = A' V, bv = B' V
    float av[NX][NX], bv[NU][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < NX; ++k) s += A[k][i] * vxx[k][j];
        av[i][j] = s;
      }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < NX; ++k) s += B[k][i] * vxx[k][j];
        bv[i][j] = s;
      }
    // H_xx, H_uu + reg I, H_xu, h_x, h_u
    float hxx[NX][NX], huu[NU][NU], hxu[NX][NU], hx[NX], hu[NU], vc[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < NX; ++k) s += av[i][k] * A[k][j];
        hxx[i][j] = q_xx[(t * NX + i) * NX + j] + s;
      }
#pragma unroll
    for (int i = 0; i < NU; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < NX; ++k) s += bv[i][k] * B[k][j];
        huu[i][j] = q_uu[(t * NU + i) * NU + j] + s + (i == j ? r : 0.f);
      }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < NX; ++k) s += av[i][k] * B[k][j];
        hxu[i][j] = q_xu[(t * NX + i) * NU + j] + s;
      }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NX; ++k) s += vxx[i][k] * cc[k];
      vc[i] = vx[i] + s;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NX; ++k) s += A[k][i] * vc[k];
      hx[i] = q_x[t * NX + i] + s;
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NX; ++k) s += B[k][i] * vc[k];
      hu[i] = q_u[t * NU + i] + s;
    }

    // Cholesky of H_uu, unclamped: a non-PD pivot gives NaN
    float L[NU][NU];
#pragma unroll
    for (int j = 0; j < NU; ++j) {
#pragma unroll
      for (int i = 0; i < NU; ++i) L[i][j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NU; ++j) {
      float s = huu[j][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
      const float d = sqrtf(s);
      L[j][j] = d;
#pragma unroll
      for (int i = j + 1; i < NU; ++i) {
        float e = huu[i][j];
#pragma unroll
        for (int k = 0; k < j; ++k) e -= L[i][k] * L[j][k];
        L[i][j] = e / d;
      }
    }

    // K = -(H_uu)^-1 H_xu',  k = -(H_uu)^-1 h_u; column NX is h_u
    float K[NU][NX], kf[NU];
#pragma unroll
    for (int col = 0; col <= NX; ++col) {
      float y[NU], xs[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        float s = (col < NX) ? hxu[col][i] : hu[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s -= L[i][k] * y[k];
        y[i] = s / L[i][i];
      }
#pragma unroll
      for (int i = NU - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < NU; ++k) s -= L[k][i] * xs[k];
        xs[i] = s / L[i][i];
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (col < NX) K[i][col] = -xs[i];
        else kf[i] = -xs[i];
      }
    }
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      ffs[t * NU + i] = kf[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) gains[(t * NU + i) * NX + j] = K[i][j];
    }

    // V_xx <- sym(H_xx + H_xu K),  V_x <- h_x + H_xu k
    float vn[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < NU; ++k) s += hxu[i][k] * K[k][j];
        vn[i][j] = hxx[i][j] + s;
      }
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) vxx[i][j] = 0.5f * (vn[i][j] + vn[j][i]);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NU; ++k) s += hxu[i][k] * kf[k];
      vx[i] = hx[i] + s;
    }
    // predicted decrease: -k'h_u - 0.5 k'H_uu k
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float hk = 0.f;
#pragma unroll
      for (int k = 0; k < NU; ++k) hk += huu[i][k] * kf[k];
      dec -= kf[i] * (hu[i] + 0.5f * hk);
    }
  }
  dec_out[p] = dec;

  // forward rollout: du_t = k_t + K_t dx_t, dx_{t+1} = A dx + B du + c
  float x[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = dx0[i];
  for (int t = 0; t < nt; ++t) {
    const float* at = a + t * NX * NX;
    const float* bt = b + t * NX * NU;
    float u[NU];
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      float s = ffs[t * NU + i];
#pragma unroll
      for (int k = 0; k < NX; ++k) s += gains[(t * NU + i) * NX + k] * x[k];
      u[i] = s;
      du[t * NU + i] = s;
    }
    float xn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      dx[t * NX + i] = x[i];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < NX; ++k) s += at[i * NX + k] * x[k];
#pragma unroll
      for (int k = 0; k < NU; ++k) s += bt[i * NU + k] * u[k];
      xn[i] = s + c[t * NX + i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) x[i] = xn[i];
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[T * NX + i] = x[i];
}

template <int NX, int NU>
cudaError_t launch(const float* a, const float* b, const float* c,
                   const float* q_xx, const float* q_uu, const float* q_xu,
                   const float* q_x, const float* q_u, const float* qf_xx,
                   const float* qf_x, const float* dx0, const float* reg,
                   float* dx, float* du, float* gains, float* ffs,
                   float* dec, int batch, int nt, cudaStream_t stream) {
  const int threads = 64;
  const int blocks = (batch + threads - 1) / threads;
  riccati_sweep_kernel<NX, NU><<<blocks, threads, 0, stream>>>(
      a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg, dx, du,
      gains, ffs, dec, batch, nt);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns cudaErrorInvalidValue for an
// (nx, nu) pair without an instantiation; the Python wrapper checks the
// pair first.
extern "C" int gpmpc_riccati_sweep_f32(
    const float* a, const float* b, const float* c, const float* q_xx,
    const float* q_uu, const float* q_xu, const float* q_x, const float* q_u,
    const float* qf_xx, const float* qf_x, const float* dx0, const float* reg,
    float* dx, float* du, float* gains, float* ffs, float* dec, int batch,
    int nt, int nx, int nu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || nt <= 0) return static_cast<int>(cudaErrorInvalidValue);
#define GPMPC_RICCATI_CASE(NX_, NU_)                                        \
  if (nx == NX_ && nu == NU_)                                               \
    return static_cast<int>(launch<NX_, NU_>(                               \
        a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg, dx, du, \
        gains, ffs, dec, batch, nt, s));
  GPMPC_RICCATI_CASE(4, 2)
  GPMPC_RICCATI_CASE(5, 3)
  GPMPC_RICCATI_CASE(2, 1)
#undef GPMPC_RICCATI_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
