// n_sub RK4 substeps of a plant ODE in one launch (the plant-truth step of
// Model.integrate with fused_integrator=True).
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:rk4_substeps_pallas.  Same math
// as gpmpc_tpu_torch/ops/cuda_kernels.py:rk4_substeps_reference.
//
// What bounds it on an H100: latency.  One main-path call is 4 * n_sub = 40
// evaluations of a 4-state ODE (a few hundred flops, 24 bytes in, 16 out);
// as plain tensor code each evaluation is several kernel launches.  Design:
// one thread per rollout, the state in registers for the whole chain, one
// launch.  The JAX kernel traces any jnp ODE into its body; here each ODE is
// a functor compiled in, and the Python side maps an ODE to its functor id.
//
// Constants are folded in double and cast to float, matching the Python
// float folding of gpmpc_tpu_torch/systems.py:four_tank_ode.  nvcc contracts
// a*b+c into FMA, so results differ from the plain version in the last ulps.

#include <cuda_runtime.h>

namespace {

// Quadruple-tank process with the default TANK_PARAMS (systems.py).
struct FourTank {
  static constexpr int NX = 4;
  static constexpr int NU = 2;

  __device__ static void eval(const float* x, const float* u, float* f) {
    constexpr double A1 = 28.0, A2 = 32.0, A3 = 28.0, A4 = 32.0;
    constexpr double a1 = 0.071, a2 = 0.057, a3 = 0.071, a4 = 0.057;
    constexpr double g = 981.0, k1 = 3.33, k2 = 3.35;
    constexpr double gamma1 = 0.7, gamma2 = 0.6;
    const float two_g = static_cast<float>(2.0 * g);
    float q[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = sqrtf(two_g * fmaxf(x[i], 1e-6f));
    f[0] = static_cast<float>(-a1 / A1) * q[0]
         + static_cast<float>(a3 / A1) * q[2]
         + static_cast<float>(gamma1 * k1 / A1) * u[0];
    f[1] = static_cast<float>(-a2 / A2) * q[1]
         + static_cast<float>(a4 / A2) * q[3]
         + static_cast<float>(gamma2 * k2 / A2) * u[1];
    f[2] = static_cast<float>(-a3 / A3) * q[2]
         + static_cast<float>((1.0 - gamma2) * k2 / A3) * u[1];
    f[3] = static_cast<float>(-a4 / A4) * q[3]
         + static_cast<float>((1.0 - gamma1) * k1 / A4) * u[0];
  }
};

template <class Ode, int NX, int NU>
__global__ void rk4_substeps_kernel(const float* __restrict__ x,
                                    const float* __restrict__ u,
                                    float* __restrict__ out, int batch,
                                    int n_sub, float h, float h_half,
                                    float h_sixth) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  float xv[NX], uv[NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) xv[i] = x[p * NX + i];
#pragma unroll
  for (int i = 0; i < NU; ++i) uv[i] = u[p * NU + i];
  for (int s = 0; s < n_sub; ++s) {
    float k1[NX], k2[NX], k3[NX], k4[NX], tmp[NX];
    Ode::eval(xv, uv, k1);
#pragma unroll
    for (int i = 0; i < NX; ++i) tmp[i] = xv[i] + h_half * k1[i];
    Ode::eval(tmp, uv, k2);
#pragma unroll
    for (int i = 0; i < NX; ++i) tmp[i] = xv[i] + h_half * k2[i];
    Ode::eval(tmp, uv, k3);
#pragma unroll
    for (int i = 0; i < NX; ++i) tmp[i] = xv[i] + h * k3[i];
    Ode::eval(tmp, uv, k4);
#pragma unroll
    for (int i = 0; i < NX; ++i)
      xv[i] = xv[i] + h_sixth * (k1[i] + 2.f * k2[i] + 2.f * k3[i] + k4[i]);
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) out[p * NX + i] = xv[i];
}

template <class Ode>
cudaError_t launch(const float* x, const float* u, float* out, int batch,
                   int n_sub, double h, cudaStream_t stream) {
  const int threads = 64;
  const int blocks = (batch + threads - 1) / threads;
  rk4_substeps_kernel<Ode, Ode::NX, Ode::NU><<<blocks, threads, 0, stream>>>(
      x, u, out, batch, n_sub, static_cast<float>(h),
      static_cast<float>(0.5 * h), static_cast<float>(h / 6.0));
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  ode_id 0 = FourTank.  x (batch, NX),
// u (batch, NU), out (batch, NX), all contiguous float32 on the device.
extern "C" int gpmpc_rk4_substeps_f32(int ode_id, const float* x,
                                      const float* u, float* out, int batch,
                                      int n_sub, double h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_sub < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (ode_id) {
    case 0:
      return static_cast<int>(launch<FourTank>(x, u, out, batch, n_sub, h, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
