// The RK4 substep chain of K2 (csrc/rk4_substeps.cu), and the scalar helpers
// of the functors that gpmpc_tpu_torch/ops/ode_trace.py generates.
//
// Under nvcc these are device functions; under a host compiler (the CPU
// tests build the generated functors with g++ behind this same chain)
// they are host functions, so the two run the same arithmetic.
//
// A functor has NX states, NU inputs and NW input terms: prep(u, w) forms
// once per rollout what the ODE needs of the input, which is constant over
// the substeps, and eval(x, w, f) the right-hand side from the state and
// those terms.  A functor that declares PLAIN_ORDER = true (the traced
// ones) combines the RK4 stages in the plain version's order, each
// product and sum rounded on its own (its unit is built without FMA
// contraction), so that it rounds as PyTorch's elementwise ops do; the
// hand-written functors take the FMA form below, shorter by a rounding
// and a dependent instruction a stage.

#ifndef GPMPC_RK4_CHAIN_H
#define GPMPC_RK4_CHAIN_H

#include <math.h>

#ifdef __CUDACC__
#define GPMPC_FN __device__ __forceinline__
#else
#define GPMPC_FN inline
#endif

namespace gpmpc_rk4 {

// torch.maximum / torch.minimum: a NaN operand gives NaN
GPMPC_FN float maximum(float a, float b) {
  return (a != a || b != b) ? a + b : fmaxf(a, b);
}
GPMPC_FN float minimum(float a, float b) {
  return (a != a || b != b) ? a + b : fminf(a, b);
}
// torch.clamp: min(max(x, lo), hi), NaN stays NaN
GPMPC_FN float clamp(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
// torch.sign: -1, 0 or 1, and 0 for NaN
GPMPC_FN float sign(float a) {
  return static_cast<float>((0.0f < a) - (a < 0.0f));
}

// Whether Ode declares PLAIN_ORDER = true.
template <class Ode, class = void>
struct PlainOrder {
  static constexpr bool value = false;
};
template <class Ode>
struct PlainOrder<Ode, decltype(void(Ode::PLAIN_ORDER))> {
  static constexpr bool value = Ode::PLAIN_ORDER;
};

// One RK4 substep in the plain version's order
// (cuda_kernels.rk4_substeps_reference): x + (h/2) k1, x + (h/2) k2,
// x + h k3, then x + (h/6) (((k1 + 2 k2) + 2 k3) + k4), the sum kept as
// the stages come.
template <class Ode>
GPMPC_FN void rk4_step_plain(float* xv, const float* wv, float h,
                             float h_half, float h_sixth) {
  constexpr int NX = Ode::NX;
  float k[NX], acc[NX], tmp[NX];
  Ode::eval(xv, wv, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = k[i];
    tmp[i] = xv[i] + h_half * k[i];
  }
  Ode::eval(tmp, wv, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = acc[i] + 2.f * k[i];
    tmp[i] = xv[i] + h_half * k[i];
  }
  Ode::eval(tmp, wv, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = acc[i] + 2.f * k[i];
    tmp[i] = xv[i] + h * k[i];
  }
  Ode::eval(tmp, wv, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) xv[i] = xv[i] + h_sixth * (acc[i] + k[i]);
}

// One RK4 substep in the FMA form.
template <class Ode>
GPMPC_FN void rk4_step_fma(float* xv, const float* wv, float h,
                           float h_half, float h_sixth) {
  constexpr int NX = Ode::NX;
  float k[NX], acc[NX], tmp[NX];
  Ode::eval(xv, wv, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = k[i];
    tmp[i] = fmaf(h_half, k[i], xv[i]);
  }
  Ode::eval(tmp, wv, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = fmaf(2.f, k[i], acc[i]);
    tmp[i] = fmaf(h_half, k[i], xv[i]);
  }
  Ode::eval(tmp, wv, k);
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    acc[i] = fmaf(2.f, k[i], acc[i]);
    tmp[i] = fmaf(h, k[i], xv[i]);
  }
  Ode::eval(tmp, wv, k);
  // x + h/6 (k1 + 2 k2 + 2 k3 + k4), the k4 term last
#pragma unroll
  for (int i = 0; i < NX; ++i)
    xv[i] = fmaf(h_sixth, k[i], fmaf(h_sixth, acc[i], xv[i]));
}

// One RK4 substep of size h of Ode, in place on xv; wv the input terms.
template <class Ode>
GPMPC_FN void rk4_step(float* xv, const float* wv, float h, float h_half,
                       float h_sixth) {
  if constexpr (PlainOrder<Ode>::value)
    rk4_step_plain<Ode>(xv, wv, h, h_half, h_sixth);
  else
    rk4_step_fma<Ode>(xv, wv, h, h_half, h_sixth);
}

// n_sub substeps: NSUB of them when NSUB > 0 (unrolled), else the run-time
// count.
template <class Ode, int NSUB>
GPMPC_FN void rk4_chain(float* xv, const float* wv, int n_sub, float h,
                        float h_half, float h_sixth) {
  if (NSUB > 0) {
#pragma unroll
    for (int s = 0; s < NSUB; ++s) rk4_step<Ode>(xv, wv, h, h_half, h_sixth);
  } else {
#pragma unroll 1
    for (int s = 0; s < n_sub; ++s)
      rk4_step<Ode>(xv, wv, h, h_half, h_sixth);
  }
}

}  // namespace gpmpc_rk4

#endif  // GPMPC_RK4_CHAIN_H
