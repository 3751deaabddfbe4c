// n_sub RK4 substeps of a plant ODE in one launch (the plant-truth step of
// Model.integrate with fused_integrator=True).
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:rk4_substeps_pallas.  Same math
// as gpmpc_tpu_torch/ops/cuda_kernels.py:rk4_substeps_reference.
//
// What bounds it on an H100: latency.  One main-path call is 4 * n_sub = 40
// evaluations of a 4-state ODE (a few hundred flops, 24 bytes in, 16 out),
// each depending on the one before, so the time of a call is one load round
// trip, the dependent chain of 40 evaluations, and one store.  The JAX
// kernel traces any jnp ODE into its body; here an ODE is a functor:
// FourTank and Car below are written by hand and compiled into the main
// library, and any other ODE is traced by gpmpc_tpu_torch/ops/ode_trace.py
// into a generated functor that a unit of its own defines before it
// includes this file with GPMPC_RK4_TRACED naming it (as the K1 unit
// defines GPMPC_RICCATI_NX/NU): that unit's library holds the entries
// gpmpc_rk4_traced_f32 and gpmpc_rk4_traced_chain_cycles_f32 for that
// functor alone, built at first launch with --fmad=false.  A traced
// functor rounds as the plain version does: each ATen op once, and the RK4
// stages combined in the plain version's order (rk4_chain.h); the design
// below is the hand-written functors'.
//
// Design: one thread per rollout, the state in registers for the whole
// chain, 32-thread blocks so that a batch of rollouts spreads over as many
// SMs as it has warps.  The chain stays in one thread: the four states'
// square roots are already independent instructions there, and splitting a
// rollout over lanes would add a shuffle's latency to every evaluation.
// What the chain is made of, and what was done to shorten it:
//  * the square root.  Its argument 2 g max(x, 1e-6) is a positive normal
//    number, so IEEE sqrtf's handling of zero, denormal and special inputs
//    (a MUFU.RSQ, a Newton correction and a branch to a slow path) is not
//    needed: the functor takes one rsqrt.approx (MUFU.RSQ) of max(x, 1e-6)
//    and forms sqrt(2 g) max(x, 1e-6) by multiplying the coefficient that
//    consumes it, a product that runs beside the MUFU, so after the MUFU the
//    chain is the FMAs of the ODE's right-hand side;
//  * the RK4 combination k1 + 2 k2 + 2 k3 + k4 is accumulated as the stages
//    come, and x + h/6 (...) is split so that one FMA follows the last stage;
//  * n_sub = 10, the only value the main path uses, is a compile-time
//    count (fully unrolled); other counts take the run-time loop of the same
//    kernel.
// gpmpc_rk4_chain_cycles_f32 runs the same chain in one thread between two
// clock64() reads, so the chain's length can be read in SM cycles.
//
// Constants are folded in double and cast to float, as the Python float
// folding of gpmpc_tpu_torch/systems.py:four_tank_ode and car_ode does; the
// rsqrt form, the different folding and nvcc's FMA contraction round
// differently from the plain version, by a few ulps per evaluation.
//
// Two hand-written functors: FourTank (ode_id 0, the four-tank main path)
// and Car (ode_id 1, the kinematic bicycle of the car bench).  Car takes
// the accurate tanf, atanf and sincosf (no __ intrinsics, no fast-math
// flags): its steering reaches +-0.5 rad and its heading any angle, where
// the approximate forms lose digits.  A traced functor follows the same
// rule.  The functor protocol and the substep chain are in rk4_chain.h.

#include <cuda_runtime.h>

#include "rk4_chain.h"

namespace {

using gpmpc_rk4::rk4_chain;

constexpr int THREADS = 32;
// the main path's substep count, compiled in
constexpr int MAIN_N_SUB = 10;

#ifndef GPMPC_RK4_TRACED
// 1/sqrt(v) by MUFU.RSQ alone (relative error ~2^-23 for a normal v)
__device__ __forceinline__ float rsqrt_approx(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Quadruple-tank process with the default TANK_PARAMS (systems.py).
struct FourTank {
  static constexpr int NX = 4;
  static constexpr int NU = 2;
  static constexpr int NW = 2;

  __device__ static void prep(const float* u, float* w) {
    w[0] = u[0];
    w[1] = u[1];
  }

  __device__ static void eval(const float* x, const float* u, float* f) {
    constexpr double A1 = 28.0, A2 = 32.0, A3 = 28.0, A4 = 32.0;
    constexpr double a1 = 0.071, a2 = 0.057, a3 = 0.071, a4 = 0.057;
    constexpr double k1 = 3.33, k2 = 3.35;
    constexpr double gamma1 = 0.7, gamma2 = 0.6;
    constexpr double sqrt_2g = 44.294469180700204;   // sqrt(2 * 981)
    // q_i = sqrt(2 g h_i) = sqrt_2g * h_i * rsqrt(h_i), h_i = max(x_i, 1e-6)
    float h[4], r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      h[i] = fmaxf(x[i], 1e-6f);
      r[i] = rsqrt_approx(h[i]);
    }
    f[0] = fmaf(static_cast<float>(-a1 / A1 * sqrt_2g) * h[0], r[0],
                fmaf(static_cast<float>(a3 / A1 * sqrt_2g) * h[2], r[2],
                     static_cast<float>(gamma1 * k1 / A1) * u[0]));
    f[1] = fmaf(static_cast<float>(-a2 / A2 * sqrt_2g) * h[1], r[1],
                fmaf(static_cast<float>(a4 / A2 * sqrt_2g) * h[3], r[3],
                     static_cast<float>(gamma2 * k2 / A2) * u[1]));
    f[2] = fmaf(static_cast<float>(-a3 / A3 * sqrt_2g) * h[2], r[2],
                static_cast<float>((1.0 - gamma2) * k2 / A3) * u[1]);
    f[3] = fmaf(static_cast<float>(-a4 / A4 * sqrt_2g) * h[3], r[3],
                static_cast<float>((1.0 - gamma1) * k1 / A4) * u[0]);
  }
};

// Kinematic bicycle car with the default CAR_PARAMS (systems.py): states
// [px, py, psi, v], inputs [a, delta].  The slip angle beta and sin(beta) /
// lr depend on the input alone: prep takes them once per rollout, so each
// evaluation is one sincosf and three products.
struct Car {
  static constexpr int NX = 4;
  static constexpr int NU = 2;
  static constexpr int NW = 3;

  __device__ static void prep(const float* u, float* w) {
    constexpr double lf = 1.2, lr = 1.4;
    const float beta =
        atanf(static_cast<float>(lr / (lf + lr)) * tanf(u[1]));
    w[0] = u[0];                                   // a
    w[1] = beta;
    w[2] = sinf(beta) * static_cast<float>(1.0 / lr);
  }

  __device__ static void eval(const float* x, const float* w, float* f) {
    float s, c;
    sincosf(x[2] + w[1], &s, &c);
    f[0] = x[3] * c;
    f[1] = x[3] * s;
    f[2] = x[3] * w[2];
    f[3] = w[0];
  }
};

#endif  // GPMPC_RK4_TRACED

template <class Ode, int NSUB>
__global__ void __launch_bounds__(THREADS)
rk4_substeps_kernel(const float* __restrict__ x, const float* __restrict__ u,
                    float* __restrict__ out, int batch, int n_sub, float h,
                    float h_half, float h_sixth) {
  constexpr int NX = Ode::NX, NU = Ode::NU;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= batch) return;
  float xv[NX], uv[NU], wv[Ode::NW];
#pragma unroll
  for (int i = 0; i < NX; ++i) xv[i] = x[p * NX + i];
#pragma unroll
  for (int i = 0; i < NU; ++i) uv[i] = u[p * NU + i];
  Ode::prep(uv, wv);
  rk4_chain<Ode, NSUB>(xv, wv, n_sub, h, h_half, h_sixth);
#pragma unroll
  for (int i = 0; i < NX; ++i) out[p * NX + i] = xv[i];
}

// The chain of rollout 0 in one thread, between two clock64() reads: from
// before its loads to after its stores.
template <class Ode, int NSUB>
__global__ void rk4_chain_cycles_kernel(const float* __restrict__ x,
                                        const float* __restrict__ u,
                                        float* __restrict__ out,
                                        long long* __restrict__ cycles,
                                        int n_sub, float h, float h_half,
                                        float h_sixth) {
  constexpr int NX = Ode::NX, NU = Ode::NU;
  const long long t0 = clock64();
  float xv[NX], uv[NU], wv[Ode::NW];
#pragma unroll
  for (int i = 0; i < NX; ++i) xv[i] = x[i];
#pragma unroll
  for (int i = 0; i < NU; ++i) uv[i] = u[i];
  Ode::prep(uv, wv);
  rk4_chain<Ode, NSUB>(xv, wv, n_sub, h, h_half, h_sixth);
#pragma unroll
  for (int i = 0; i < NX; ++i) out[i] = xv[i];
  cycles[0] = clock64() - t0;
}

template <class Ode, int NSUB>
cudaError_t launch_nsub(const float* x, const float* u, float* out,
                        int batch, int n_sub, double h, cudaStream_t stream) {
  const int blocks = (batch + THREADS - 1) / THREADS;
  rk4_substeps_kernel<Ode, NSUB><<<blocks, THREADS, 0, stream>>>(
      x, u, out, batch, n_sub, static_cast<float>(h),
      static_cast<float>(0.5 * h), static_cast<float>(h / 6.0));
  return cudaGetLastError();
}

template <class Ode>
cudaError_t launch(const float* x, const float* u, float* out, int batch,
                   int n_sub, double h, cudaStream_t stream) {
  return n_sub == MAIN_N_SUB
             ? launch_nsub<Ode, MAIN_N_SUB>(x, u, out, batch, n_sub, h, stream)
             : launch_nsub<Ode, 0>(x, u, out, batch, n_sub, h, stream);
}

template <class Ode>
cudaError_t chain_cycles(const float* x, const float* u, float* out,
                         long long* cycles, int n_sub, double h,
                         cudaStream_t stream) {
  const float hf = static_cast<float>(h), hh = static_cast<float>(0.5 * h),
              h6 = static_cast<float>(h / 6.0);
  if (n_sub == MAIN_N_SUB)
    rk4_chain_cycles_kernel<Ode, MAIN_N_SUB><<<1, 1, 0, stream>>>(
        x, u, out, cycles, n_sub, hf, hh, h6);
  else
    rk4_chain_cycles_kernel<Ode, 0><<<1, 1, 0, stream>>>(
        x, u, out, cycles, n_sub, hf, hh, h6);
  return cudaGetLastError();
}

}  // namespace

#ifdef GPMPC_RK4_TRACED
// C interface of a traced functor's own library, loaded with ctypes: x
// (batch, NX), u (batch, NU), out (batch, NX), all contiguous float32 on
// the device.
extern "C" int gpmpc_rk4_traced_f32(const float* x, const float* u,
                                    float* out, int batch, int n_sub,
                                    double h, void* stream) {
  if (batch <= 0 || n_sub < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<GPMPC_RK4_TRACED>(
      x, u, out, batch, n_sub, h, static_cast<cudaStream_t>(stream)));
}

// Its measurement entry, as gpmpc_rk4_chain_cycles_f32 below.
extern "C" int gpmpc_rk4_traced_chain_cycles_f32(const float* x,
                                                 const float* u, float* out,
                                                 long long* cycles,
                                                 int n_sub, double h,
                                                 void* stream) {
  if (n_sub < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(chain_cycles<GPMPC_RK4_TRACED>(
      x, u, out, cycles, n_sub, h, static_cast<cudaStream_t>(stream)));
}
#else
// C interface, loaded with ctypes.  ode_id 0 = FourTank, 1 = Car.  x (batch, NX),
// u (batch, NU), out (batch, NX), all contiguous float32 on the device.
extern "C" int gpmpc_rk4_substeps_f32(int ode_id, const float* x,
                                      const float* u, float* out, int batch,
                                      int n_sub, double h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_sub < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (ode_id) {
    case 0:
      return static_cast<int>(launch<FourTank>(x, u, out, batch, n_sub, h, s));
    case 1:
      return static_cast<int>(launch<Car>(x, u, out, batch, n_sub, h, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Measurement entry: the substep chain of one rollout (x (NX,), u (NU,),
// out (NX,)) in one thread; cycles (1,) int64 gets the SM cycles from before
// its loads to after its stores.  n_sub = MAIN_N_SUB runs the compiled-in
// count, any other the run-time loop, as gpmpc_rk4_substeps_f32 does.
extern "C" int gpmpc_rk4_chain_cycles_f32(int ode_id, const float* x,
                                          const float* u, float* out,
                                          long long* cycles, int n_sub,
                                          double h, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_sub < 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (ode_id) {
    case 0:
      return static_cast<int>(
          chain_cycles<FourTank>(x, u, out, cycles, n_sub, h, s));
    case 1:
      return static_cast<int>(
          chain_cycles<Car>(x, u, out, cycles, n_sub, h, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
#endif  // GPMPC_RK4_TRACED
