// K1: the Riccati sweep over the block-banded KKT system of a trajectory
// QP -- the backward factorization and the forward rollout -- in one launch.
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:riccati_sweep_pallas (body
// _riccati_kernel, _chol_cols_small, _chol_solve_small).  Same math as
// gpmpc_tpu_torch/solvers/riccati.py:solve and its plain twin
// gpmpc_tpu_torch/ops/cuda_kernels.py:riccati_sweep_reference.
//
// What bounds it on an H100: latency.  At the main path's size (B = 1
// problem, Nt = 20 stages, nx = 4, nu = 2) the sweep is a chain of 20
// dependent backward stages of 4x4 products and 20 forward stages: a few
// thousand flops over ~5 KB of input, microseconds below any roofline.
// What costs is the chain itself and every device-memory round trip that
// sits on it.  The Pallas kernel has all its inputs in VMEM before its body
// runs and keeps the gains as values; this kernel does the same with
// shared memory:
//
// * One warp per problem; a block holds up to Layout::WARPS problems, and
//   B = 1 launches one block of one warp.  A stage is three steps with a
//   __syncwarp after each and no block barrier: (1) the lanes own the
//   entries of A'V, B'V and V c; (2) of H_xx, H_xu, h_x and h_u, while
//   every lane forms the small H_uu + reg I itself; (3) every lane factors
//   H_uu (reciprocal square-root pivots and multiplies), solves for the
//   gain columns its V_xx or V_x entry needs and writes that entry, and
//   lane c <= NX stores column c of -(H_uu)^-1 [H_xu' h_u].  Each entry is
//   a short FMA chain over operands in shared memory; a table built once
//   per lane maps the lane to its entries, so the warp runs one
//   instruction stream.  The forward pass carries the state in every lane,
//   so nothing is exchanged on its chain.
// * The stage arrays go to shared memory in chunks of CHUNK stages (fewer
//   where one warp's buffers would pass the card's shared memory), by
//   16-byte cp.async copies (4-byte where a span is not 16-byte aligned),
//   double-buffered: the backward pass walks the chunks from the last one
//   down, with the copy of chunk k-1 in flight while chunk k is solved.
//   Nt <= CHUNK pays one memory round trip in all; longer horizons stream.
// * The gains and feedforwards stay in shared memory for the forward pass,
//   which finds the first two chunks' A, B, c and gains still in their
//   buffers.  From the third chunk on it re-stages A, B, c and the gains it
//   stored, one chunk ahead of use.  dx, du, gains and ffs leave in
//   coalesced stores once per chunk, the predicted decrease once.
//
// The template takes any NX < 31 and NU <= 32 whose one warp fits the
// block's shared memory (see chunk_for); ops/cuda_kernels.py builds the
// shapes outside the C entry's list at first use, each into a library of
// its own, from a unit that defines GPMPC_RICCATI_NX and GPMPC_RICCATI_NU
// and includes this file.
//
// reg and dx0 are device pointers, so the caller never syncs the host.  A
// non-PD pivot of H_uu + reg I gives NaN (rsqrt of a negative) and a zero
// pivot inf (rsqrt of 0), so the gains are non-finite either way, never
// clamped: the caller's finiteness flag reads it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Stages per staged chunk, at most.  ops/cuda_kernels.py mirrors it as
// RICCATI_CHUNK.
constexpr int CHUNK = 32;

// The most dynamic shared memory a block may opt in to on an H100
// (227 KB).  ops/cuda_kernels.py mirrors it as RICCATI_SMEM_OPTIN.
constexpr int SMEM_OPTIN = 232448;

constexpr int pad4(int n) { return (n + 3) & ~3; }

// One warp's shared memory, in floats, at CH stages a chunk.  Each staged
// array holds two chunk buffers, [2 * CH][its floats a stage], 16-byte
// aligned (CH a multiple of 4).
template <int NX, int NU, int CH>
struct LayoutAt {
  static constexpr int XX = NX * NX, XU = NX * NU, UU = NU * NU;
  static constexpr int S2 = 2 * CH;
  static constexpr int A = 0, B = A + S2 * XX, C = B + S2 * XU,
                       QXX = C + S2 * NX, QUU = QXX + S2 * XX,
                       QXU = QUU + S2 * UU, QX = QXU + S2 * XU,
                       QU = QX + S2 * NX,
                       G = QU + S2 * NU,   // gains [2 * CH][NU][NX]
                       F = G + S2 * XU,    // feedforwards [2 * CH][NU]
                       DU = F + S2 * NU,   // a chunk's du [CH][NU]
                       DX = DU + pad4(CH * NU),  // [CH + 1][NX]
                       V = DX + pad4((CH + 1) * NX), VX = V + XX,
                       AV = VX + NX, BV = AV + XX, VC = BV + XU,
                       HXX = VC + NX, HXU = HXX + XX,
                       HX = HXU + XU, HU = HX + NX, ZERO = HU + NU,
                       SINK = ZERO + 1,  // written by lanes without entry
                       FLOATS = pad4(SINK + 1);
  // problems per block: up to 4 within 200 KB of shared memory
  static constexpr int FIT = (200 * 1024) / (FLOATS * 4);
  static constexpr int WARPS = FIT < 1 ? 1 : (FIT > 4 ? 4 : FIT);
};

// The chunk of an (NX, NU) warp: CHUNK, halved while one warp's buffers
// pass SMEM_OPTIN, down to 4 stages (the least that keeps every chunk
// buffer 16-byte aligned for cp.async).  At CHUNK one warp fits up to
// (18, 2) or (11, 11); at 4 stages every NX < 31 with NU <= 32 fits (the
// largest, (30, 32), in 202 KB).
template <int NX, int NU, int CH = CHUNK>
constexpr int chunk_for() {
  if constexpr (CH > 4 && LayoutAt<NX, NU, CH>::FLOATS * 4 > SMEM_OPTIN)
    return chunk_for<NX, NU, CH / 2>();
  else
    return CH;
}

template <int NX, int NU>
struct Layout : LayoutAt<NX, NU, chunk_for<NX, NU>()> {
  static constexpr int CH = chunk_for<NX, NU>();
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1/sqrt(x): +inf at 0, NaN below 0 (a subnormal counts as 0)
__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The warp copies n floats to shared memory (dst 16-byte aligned): 16 bytes
// a lane where the source allows it, else 4.
__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n, int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int v = 4 * lane; v < n; v += 128) cp_async16(dst + v, src + v);
  } else {
    for (int i = lane; i < n; i += 32) cp_async4(dst + i, src + i);
  }
}

__device__ __forceinline__ void store_span(float* dst, const float* src,
                                           int n, int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = src[i];
}

// One lane's entry of a stage product, offsets into the warp's shared
// memory: dst = base (+ reg if diag) + sum_k x[k * xs] y[k * ys].  base, x
// and y move on by bst, xst and yst floats a staged stage.  A lane without
// an entry gets one that reads the ZERO cell and writes the SINK cell, so
// no lane branches.
struct Dot {
  int dst, base, bst, x, xs, xst, y, ys, yst, diag;
};

template <int NX, int NU>
__device__ __forceinline__ Dot no_dot() {
  using L = Layout<NX, NU>;
  return {L::SINK, L::ZERO, 0, L::ZERO, 0, 0, L::ZERO, 0, 0, 0};
}

// Step 1: A'V, B'V and vc = V_x + V_xx c.
template <int NX, int NU>
__device__ Dot step1_entry(int e) {
  using L = Layout<NX, NU>;
  if (e < L::XX)
    return {L::AV + e, L::ZERO, 0, L::A + e / NX, NX, L::XX, L::V + e % NX,
            NX, 0, 0};
  e -= L::XX;
  if (e < L::XU)
    return {L::BV + e, L::ZERO, 0, L::B + e / NX, NU, L::XU, L::V + e % NX,
            NX, 0, 0};
  e -= L::XU;
  if (e < NX)
    return {L::VC + e, L::VX + e, 0, L::V + e * NX, 1, 0, L::C, 1, NX, 0};
  return no_dot<NX, NU>();
}

// Step 2: H_xx = q_xx + (A'V) A, H_xu = q_xu + (A'V) B, h_x = q_x + A' vc,
// h_u = q_u + B' vc.  H_uu = q_uu + (B'V) B + reg I, which every lane
// needs, every lane computes itself.
template <int NX, int NU>
__device__ Dot step2_entry(int e) {
  using L = Layout<NX, NU>;
  if (e < L::XX)
    return {L::HXX + e, L::QXX + e, L::XX, L::AV + e / NX * NX, 1, 0,
            L::A + e % NX, NX, L::XX, 0};
  e -= L::XX;
  if (e < L::XU)
    return {L::HXU + e, L::QXU + e, L::XU, L::AV + e / NU * NX, 1, 0,
            L::B + e % NU, NU, L::XU, 0};
  e -= L::XU;
  if (e < NX)
    return {L::HX + e, L::QX + e, NX, L::A + e, NX, L::XX, L::VC, 1, 0, 0};
  e -= NX;
  if (e < NU)
    return {L::HU + e, L::QU + e, NU, L::B + e, NU, L::XU, L::VC, 1, 0, 0};
  return no_dot<NX, NU>();
}

template <int K>
__device__ __forceinline__ float eval_dot(const float* sm, const Dot& d,
                                          int si, float r) {
  const float* x = sm + d.x + si * d.xst;
  const float* y = sm + d.y + si * d.yst;
  float acc = sm[d.base + si * d.bst];
#pragma unroll
  for (int k = 0; k < K; ++k) acc = fmaf(x[k * d.xs], y[k * d.ys], acc);
  return d.diag ? acc + r : acc;
}

// A step's entries: all values first, then all stores, so a lane's chains
// overlap.
template <int K, int E>
__device__ __forceinline__ void run_dots(float* sm, const Dot (&d)[E],
                                         int si, float r) {
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) v[e] = eval_dot<K>(sm, d[e], si, r);
#pragma unroll
  for (int e = 0; e < E; ++e) sm[d[e].dst] = v[e];
}

// Step 3, one lane's entry of the value update: dst = (t1 + t2) / 2 with
// t = base - sum_k H_xu[row][k] s[k] over k < NU, where s = H_uu^-1 rhs
// (rhs: a row of H_xu, so -s is a column of the gain, or h_u, so -s is the
// feedforward).  A V_xx entry (i, j) takes rows i and j, which is the
// symmetrization; a V_x entry takes the same term twice (exact).
struct Sym {
  int dst, b1, x1, r1, b2, x2, r2;
};

template <int NX, int NU>
__device__ Sym step3_entry(int e) {
  using L = Layout<NX, NU>;
  if (e < L::XX) {
    const int i = e / NX, j = e % NX;
    return {L::V + e, L::HXX + e, L::HXU + i * NU, L::HXU + j * NU,
            L::HXX + j * NX + i, L::HXU + j * NU, L::HXU + i * NU};
  }
  e -= L::XX;
  if (e < NX)
    return {L::VX + e, L::HX + e, L::HXU + e * NU, L::HU,
            L::HX + e, L::HXU + e * NU, L::HU};
  return {L::SINK, L::ZERO, L::HXU, L::HU, L::ZERO, L::HXU, L::HU};
}

// s = H_uu^-1 rhs from the factor's strict lower triangle l and its
// reciprocal diagonal inv
template <int NU>
__device__ __forceinline__ void chol_solve(const float (&l)[NU][NU],
                                           const float (&inv)[NU],
                                           const float* rhs, float (&s)[NU]) {
  float y[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float v = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) v -= l[i][k] * y[k];
    y[i] = v * inv[i];
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int k = i + 1; k < NU; ++k) v -= l[k][i] * s[k];
    s[i] = v * inv[i];
  }
}

template <int NU>
__device__ __forceinline__ float eval_sym(const float* sm, const Sym& d,
                                          const float (&l)[NU][NU],
                                          const float (&inv)[NU]) {
  float s1[NU], s2[NU];
  chol_solve<NU>(l, inv, sm + d.r1, s1);
  chol_solve<NU>(l, inv, sm + d.r2, s2);
  float t1 = sm[d.b1], t2 = sm[d.b2];
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    t1 = fmaf(sm[d.x1 + k], -s1[k], t1);
    t2 = fmaf(sm[d.x2 + k], -s2[k], t2);
  }
  return 0.5f * (t1 + t2);
}

template <int NX, int NU>
__global__ void __launch_bounds__(32 * Layout<NX, NU>::WARPS)
    riccati_sweep_kernel(
        const float* __restrict__ a, const float* __restrict__ b,
        const float* __restrict__ c, const float* __restrict__ q_xx,
        const float* __restrict__ q_uu, const float* __restrict__ q_xu,
        const float* __restrict__ q_x, const float* __restrict__ q_u,
        const float* __restrict__ qf_xx, const float* __restrict__ qf_x,
        const float* __restrict__ dx0, const float* __restrict__ reg,
        float* __restrict__ dx, float* __restrict__ du,
        float* __restrict__ gains, float* __restrict__ ffs,
        float* __restrict__ dec_out, int batch, int nt) {
  using L = Layout<NX, NU>;
  constexpr int E1 = (L::XX + L::XU + NX + 31) / 32;
  constexpr int E2 = (L::XX + L::XU + NX + NU + 31) / 32;
  constexpr int E3 = (L::XX + NX + 31) / 32;
  static_assert(NX < 31, "lane 31 sums the predicted decrease");
  static_assert(NU <= 32, "lane j keeps row j of a chunk's du");
  static_assert(L::FLOATS * 4 <= SMEM_OPTIN,
                "one warp's shared memory passes the H100's 227 KB");
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p = blockIdx.x * L::WARPS + warp;
  if (p >= batch) return;
  float* sm = reinterpret_cast<float*>(smem4) + warp * L::FLOATS;
  const size_t P = static_cast<size_t>(p);
  const size_t T = static_cast<size_t>(nt);
  a += P * T * L::XX;
  b += P * T * L::XU;
  c += P * T * NX;
  q_xx += P * T * L::XX;
  q_uu += P * T * L::UU;
  q_xu += P * T * L::XU;
  q_x += P * T * NX;
  q_u += P * T * NU;
  qf_xx += P * L::XX;
  qf_x += P * NX;
  dx0 += P * NX;
  dx += P * (T + 1) * NX;
  du += P * T * NU;
  gains += P * T * L::XU;
  ffs += P * T * NU;
  const int nchunks = (nt + L::CH - 1) / L::CH;

  // Copy chunk k into buffer k & 1 as one cp.async group: A, B, c and,
  // for the backward pass, the cost terms, else the gains and feedforwards
  // this warp stored.
  auto stage = [&](int k, bool backward) {
    const int t0 = k * L::CH, n = min(L::CH, nt - t0);
    const int s0 = (k & 1) * L::CH;
    stage_span(sm + L::A + s0 * L::XX, a + t0 * L::XX, n * L::XX, lane);
    stage_span(sm + L::B + s0 * L::XU, b + t0 * L::XU, n * L::XU, lane);
    stage_span(sm + L::C + s0 * NX, c + t0 * NX, n * NX, lane);
    if (backward) {
      stage_span(sm + L::QXX + s0 * L::XX, q_xx + t0 * L::XX, n * L::XX,
                 lane);
      stage_span(sm + L::QUU + s0 * L::UU, q_uu + t0 * L::UU, n * L::UU,
                 lane);
      stage_span(sm + L::QXU + s0 * L::XU, q_xu + t0 * L::XU, n * L::XU,
                 lane);
      stage_span(sm + L::QX + s0 * NX, q_x + t0 * NX, n * NX, lane);
      stage_span(sm + L::QU + s0 * NU, q_u + t0 * NU, n * NU, lane);
    } else {
      stage_span(sm + L::G + s0 * L::XU, gains + t0 * L::XU, n * L::XU,
                 lane);
      stage_span(sm + L::F + s0 * NU, ffs + t0 * NU, n * NU, lane);
    }
    cp_async_commit();
  };

  stage(nchunks - 1, true);
  Dot d1[E1], d2[E2];
  Sym d3[E3];
#pragma unroll
  for (int e = 0; e < E1; ++e) d1[e] = step1_entry<NX, NU>(lane + 32 * e);
#pragma unroll
  for (int e = 0; e < E2; ++e) d2[e] = step2_entry<NX, NU>(lane + 32 * e);
#pragma unroll
  for (int e = 0; e < E3; ++e) d3[e] = step3_entry<NX, NU>(lane + 32 * e);
  // the column of [H_xu' h_u] whose solution this lane stores (lane <= NX)
  const int own_rhs = lane < NX ? L::HXU + lane * NU : L::HU;
  for (int i = lane; i < L::XX; i += 32) sm[L::V + i] = qf_xx[i];
  for (int i = lane; i < NX; i += 32) sm[L::VX + i] = qf_x[i];
  if (lane == 0) sm[L::ZERO] = 0.f;
  const float r = reg[p];
  float dec = 0.f, x[NX];  // x: the forward pass's state
#pragma unroll
  for (int i = 0; i < NX; ++i) x[i] = dx0[i];

  // backward: the chunks from the last one down, each stage from its last
  for (int k = nchunks - 1; k >= 0; --k) {
    if (k > 0) {
      stage(k - 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int t0 = k * L::CH, n = min(L::CH, nt - t0);
    const int s0 = (k & 1) * L::CH;
    for (int s = n - 1; s >= 0; --s) {
      const int si = s0 + s;
      run_dots<NX>(sm, d1, si, r);
      __syncwarp();
      float huu[NU][NU], l[NU][NU], inv[NU];
#pragma unroll
      for (int i = 0; i < NU; ++i)
#pragma unroll
        for (int j = 0; j < NU; ++j) {
          const Dot d = {0, L::QUU + i * NU + j, L::UU, L::BV + i * NX, 1, 0,
                         L::B + j, NU, L::XU, i == j};
          huu[i][j] = eval_dot<NX>(sm, d, si, r);
        }
      run_dots<NX>(sm, d2, si, r);
      __syncwarp();
      // Cholesky of H_uu + reg I in every lane, unclamped
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float d = huu[j][j];
#pragma unroll
        for (int k2 = 0; k2 < j; ++k2) d -= l[j][k2] * l[j][k2];
        inv[j] = rsqrt_ftz(d);
#pragma unroll
        for (int i = j + 1; i < NU; ++i) {
          float e = huu[i][j];
#pragma unroll
          for (int k2 = 0; k2 < j; ++k2) e -= l[i][k2] * l[j][k2];
          l[i][j] = e * inv[j];
        }
      }
      float own[NU], v[E3];
      chol_solve<NU>(l, inv, sm + own_rhs, own);
#pragma unroll
      for (int e = 0; e < E3; ++e) v[e] = eval_sym<NU>(sm, d3[e], l, inv);
      if (lane == 31) {
        // predicted decrease -k'h_u - 0.5 k'H_uu k, with k = -own
        float t = 0.f;
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          float hk = 0.f;
#pragma unroll
          for (int m = 0; m < NU; ++m) hk = fmaf(huu[i][m], -own[m], hk);
          t = fmaf(-own[i], sm[L::HU + i] + 0.5f * hk, t);
        }
        dec -= t;
      }
      if (lane <= NX) {
        float* out = sm + (lane < NX ? L::G + si * L::XU + lane
                                     : L::F + si * NU);
        const int os = lane < NX ? NX : 1;
#pragma unroll
        for (int i = 0; i < NU; ++i) out[i * os] = -own[i];
      }
#pragma unroll
      for (int e = 0; e < E3; ++e) sm[d3[e].dst] = v[e];
      __syncwarp();
    }
    store_span(gains + t0 * L::XU, sm + L::G + s0 * L::XU, n * L::XU, lane);
    store_span(ffs + t0 * NU, sm + L::F + s0 * NU, n * NU, lane);
  }
  if (lane == 31) dec_out[p] = dec;
  // the gains just stored are re-staged from the third chunk on
  __threadfence_block();
  __syncwarp();

  // forward rollout: du_t = k_t + K_t dx_t, dx_{t+1} = A dx + B du + c
  for (int k = 0; k < nchunks; ++k) {
    // chunks 0 and 1 are still in their buffers from the backward pass
    if (k + 1 >= 2 && k + 1 < nchunks) {
      stage(k + 1, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const int t0 = k * L::CH, n = min(L::CH, nt - t0);
    const int s0 = (k & 1) * L::CH;
    for (int s = 0; s < n; ++s) {
      // every lane carries the whole state, so no exchange sits on the
      // chain; lanes < NX (< NU) keep the chunk's dx (du) rows for the
      // coalesced store
      const int si = s0 + s;
      const float* g = sm + L::G + si * L::XU;
      const float* am = sm + L::A + si * L::XX;
      const float* bm = sm + L::B + si * L::XU;
      float u[NU], xn[NX];
#pragma unroll
      for (int j = 0; j < NU; ++j) {
        float acc = sm[L::F + si * NU + j];
#pragma unroll
        for (int m = 0; m < NX; ++m) acc = fmaf(g[j * NX + m], x[m], acc);
        u[j] = acc;
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < NX; ++m) acc = fmaf(am[i * NX + m], x[m], acc);
#pragma unroll
        for (int m = 0; m < NU; ++m) acc = fmaf(bm[i * NU + m], u[m], acc);
        xn[i] = acc + sm[L::C + si * NX + i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        if (lane == i) sm[L::DX + s * NX + i] = x[i];
        x[i] = xn[i];
      }
#pragma unroll
      for (int j = 0; j < NU; ++j)
        if (lane == j) sm[L::DU + s * NU + j] = u[j];
    }
    const bool last = k == nchunks - 1;
    if (last) {
#pragma unroll
      for (int i = 0; i < NX; ++i)
        if (lane == i) sm[L::DX + n * NX + i] = x[i];
    }
    __syncwarp();
    store_span(du + t0 * NU, sm + L::DU, n * NU, lane);
    store_span(dx + t0 * NX, sm + L::DX, (last ? n + 1 : n) * NX, lane);
    __syncwarp();
  }
}

template <int NX, int NU>
cudaError_t launch(const float* a, const float* b, const float* c,
                   const float* q_xx, const float* q_uu, const float* q_xu,
                   const float* q_x, const float* q_u, const float* qf_xx,
                   const float* qf_x, const float* dx0, const float* reg,
                   float* dx, float* du, float* gains, float* ffs,
                   float* dec, int batch, int nt, cudaStream_t stream) {
  using L = Layout<NX, NU>;
  constexpr int warp_bytes = L::FLOATS * static_cast<int>(sizeof(float));
  static const cudaError_t attr = cudaFuncSetAttribute(
      riccati_sweep_kernel<NX, NU>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::WARPS * warp_bytes);
  if (attr != cudaSuccess) return attr;
  const int warps = batch < L::WARPS ? batch : L::WARPS;
  const int blocks = (batch + L::WARPS - 1) / L::WARPS;
  riccati_sweep_kernel<NX, NU><<<blocks, 32 * warps, warps * warp_bytes,
                                 stream>>>(
      a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg, dx, du,
      gains, ffs, dec, batch, nt);
  return cudaGetLastError();
}

}  // namespace

// C interface, loaded with ctypes.  Returns cudaErrorInvalidValue for an
// (nx, nu) pair without an instantiation; the Python wrapper checks the
// pair first.  The main library instantiates the pairs of RICCATI_SHAPES
// (ops/cuda_kernels.py); a unit built on demand for one other pair defines
// GPMPC_RICCATI_NX and GPMPC_RICCATI_NU and instantiates that pair alone.
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
#ifdef GPMPC_RICCATI_NX
  GPMPC_RICCATI_CASE(GPMPC_RICCATI_NX, GPMPC_RICCATI_NU)
#else
  GPMPC_RICCATI_CASE(4, 2)
  GPMPC_RICCATI_CASE(5, 3)
  GPMPC_RICCATI_CASE(2, 1)
  GPMPC_RICCATI_CASE(6, 2)
  GPMPC_RICCATI_CASE(4, 4)
#endif
#undef GPMPC_RICCATI_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
