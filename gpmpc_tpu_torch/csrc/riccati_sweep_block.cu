// K1's block path: the Riccati sweep over the block-banded KKT system of a
// trajectory QP -- the backward factorization and the forward rollout -- in
// one launch, one thread block per problem, at any (nx, nu).
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:riccati_sweep_pallas (body
// _riccati_kernel, _chol_cols_small, _chol_solve_small) at the pairs the
// warp kernel (riccati_sweep.cu) does not take: nx >= 31 or nu > 32, where
// its lanes run out (lane 31 sums the predicted decrease, lane j keeps row
// j of du).  Same math as gpmpc_tpu_torch/solvers/riccati.py:solve and its
// plain twin gpmpc_tpu_torch/ops/cuda_kernels.py:riccati_sweep_reference,
// V symmetrized as 0.5 (V + V') at every stage.
//
// What bounds it on an H100: latency.  At the 40-state network's (40, 20),
// Nt = 20, one problem, the sweep is ~10 MFLOP over ~0.5 MB: ~1.5e-4 ms at
// the f32 peak, while its chain is Nt dependent stages, each a few
// dependent dense products, a Cholesky of H_uu column by column and
// triangular solves.  This first version keeps the chain on one block and
// out of device memory, and leaves speed for later:
//
// * nx and nu are run-time arguments: one instantiation serves every
//   pair.  One block of THREADS threads per problem, the grid the batch.
// * Stage t's A, B, c, Q_xx, Q_uu, Q_xu, q_x and q_u reach shared memory
//   by cp.async (16 bytes a thread where a span allows it, else 4), in two
//   buffers where two stages fit beside the working set (stage t-1's copy
//   in flight while stage t is solved), else one.  V_xx, v_x and the
//   stage's products live in shared memory.
// * A'V, B'V, V c, then H_xx, H_xu, H_uu + reg I, h_x and h_u: threads
//   strided over the output entries, one dot product each (no tensor
//   cores yet).  H_uu is factored right-looking in shared memory, one
//   block barrier per column; thread c then solves column c of
//   H_uu^-1 [H_xu' | h_u] (nx + 1 columns) and stores column c of the
//   gain (the feedforward for c = nx) straight to device memory.  The
//   value update follows; warp 0 sums the predicted decrease by a fixed
//   shuffle tree, so a run repeats bitwise.
// * The forward rollout reads the gains back with A, B and c (L2-hot), a
//   warp per row with a fixed shuffle tree.
// * No shape limit of its own: the working set is ~3 nx^2 + 3 nx nu +
//   2 nu^2 floats and a stage ~2 nx^2 + 2 nx nu + nu^2.  Where one stage
//   and the working set pass the 227 KB a block may opt in to, the working
//   set moves to a per-problem workspace in device memory that the caller
//   allocates (block_layout gives its floats; the wrapper's torch.empty
//   takes it from the caching allocator, no host sync), and the stages
//   stay staged while one fits (else they are read from device memory).
//   For nx = nu = n (block_layout below; ops/cuda_kernels.py:
//   riccati_block_layout mirrors it) two stages fit beside the working
//   set up to n = 56, one up to n = 66; from (67, 67) the working set is
//   in the workspace (two stage buffers up to n = 75, one up to 107, none
//   after).
//
// reg and dx0 are device pointers, so the caller never syncs the host.  A
// non-PD pivot of H_uu + reg I gives NaN (sqrt of a negative) and a zero
// pivot inf (division by a zero root), so the gains are non-finite either
// way, never clamped: the caller's finiteness flag reads it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Threads of a problem's block.  ops/cuda_kernels.py mirrors it as
// RICCATI_BLOCK_THREADS.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The most dynamic shared memory a block may opt in to on an H100 (227
// KB), in floats: SMEM_OPTIN of riccati_sweep.cu.
constexpr int OPTIN_FLOATS = 232448 / 4;

constexpr int pad4(int n) { return (n + 3) & ~3; }

// Offsets in floats, each array 16-byte aligned.  A stage buffer: A, B,
// c, Q_xx, Q_uu, Q_xu, q_x, q_u.  The working set: V, v_x, A'V, B'V, V c,
// H_xx, H_xu, H_uu (kept for the decrease), its factor, the factor's
// diagonal, the solutions [nu][nx + 1], h_x, h_u, the forward pass's
// state (two buffers) and input.
struct BlockLayout {
  int a, b, c, qxx, quu, qxu, qx, qu, stage;  // stage: floats a buffer
  int v, vx, av, bv, vc, hxx, hxu, huu, l, dg, sol, hx, hu, xf, uf, work;
  int buffers;     // stage buffers in shared memory: 2, 1 or 0
  int work_smem;   // 1: the working set in shared memory, 0: workspace
  int smem_bytes;  // dynamic shared memory of the launch
};

inline BlockLayout block_layout(int nx, int nu) {
  BlockLayout L;
  const int xx = nx * nx, xu = nx * nu, uu = nu * nu;
  int o = 0;
  L.a = o;   o += pad4(xx);
  L.b = o;   o += pad4(xu);
  L.c = o;   o += pad4(nx);
  L.qxx = o; o += pad4(xx);
  L.quu = o; o += pad4(uu);
  L.qxu = o; o += pad4(xu);
  L.qx = o;  o += pad4(nx);
  L.qu = o;  o += pad4(nu);
  L.stage = o;
  o = 0;
  L.v = o;   o += pad4(xx);
  L.vx = o;  o += pad4(nx);
  L.av = o;  o += pad4(xx);
  L.bv = o;  o += pad4(xu);
  L.vc = o;  o += pad4(nx);
  L.hxx = o; o += pad4(xx);
  L.hxu = o; o += pad4(xu);
  L.huu = o; o += pad4(uu);
  L.l = o;   o += pad4(uu);
  L.dg = o;  o += pad4(nu);
  L.sol = o; o += pad4(nu * (nx + 1));
  L.hx = o;  o += pad4(nx);
  L.hu = o;  o += pad4(nu);
  L.xf = o;  o += pad4(2 * nx);
  L.uf = o;  o += pad4(nu);
  L.work = o;
  if (L.work + 2 * L.stage <= OPTIN_FLOATS) {
    L.buffers = 2; L.work_smem = 1;
  } else if (L.work + L.stage <= OPTIN_FLOATS) {
    L.buffers = 1; L.work_smem = 1;
  } else {
    L.work_smem = 0;
    L.buffers = 2 * L.stage <= OPTIN_FLOATS ? 2
                : (L.stage <= OPTIN_FLOATS ? 1 : 0);
  }
  L.smem_bytes = 4 * (L.buffers * L.stage + (L.work_smem ? L.work : 0));
  if (L.smem_bytes == 0) L.smem_bytes = 16;
  return L;
}

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

// The block copies n floats to shared memory (dst 16-byte aligned): 16
// bytes a thread where the source allows it, else 4.
__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int v = 4 * threadIdx.x; v < n; v += 4 * THREADS)
      cp_async16(dst + v, src + v);
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) cp_async4(dst + i, src + i);
  }
}

// sum over the warp by a fixed butterfly: every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A stage's arrays: in a shared-memory buffer, or in device memory
struct Stage {
  const float *a, *b, *c, *qxx, *quu, *qxu, *qx, *qu;
};

__global__ void __launch_bounds__(THREADS) riccati_sweep_block_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ q_xx,
    const float* __restrict__ q_uu, const float* __restrict__ q_xu,
    const float* __restrict__ q_x, const float* __restrict__ q_u,
    const float* __restrict__ qf_xx, const float* __restrict__ qf_x,
    const float* __restrict__ dx0, const float* __restrict__ reg,
    float* __restrict__ dx, float* __restrict__ du,
    float* __restrict__ gains, float* __restrict__ ffs,
    float* __restrict__ dec_out, float* __restrict__ workspace, int nt,
    int nx, int nu, BlockLayout L) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t P = blockIdx.x;
  const size_t T = static_cast<size_t>(nt);
  const int xx = nx * nx, xu = nx * nu, uu = nu * nu, s1 = nx + 1;
  a += P * T * xx;
  b += P * T * xu;
  c += P * T * nx;
  q_xx += P * T * xx;
  q_uu += P * T * uu;
  q_xu += P * T * xu;
  q_x += P * T * nx;
  q_u += P * T * nu;
  qf_xx += P * xx;
  qf_x += P * nx;
  dx0 += P * nx;
  dx += P * (T + 1) * nx;
  du += P * T * nu;
  gains += P * T * xu;
  ffs += P * T * nu;
  float* w = L.work_smem ? sm + L.buffers * L.stage
                         : workspace + P * static_cast<size_t>(L.work);
  float *V = w + L.v, *VX = w + L.vx, *AV = w + L.av, *BV = w + L.bv,
        *VC = w + L.vc, *HXX = w + L.hxx, *HXU = w + L.hxu,
        *HUU = w + L.huu, *LF = w + L.l, *DG = w + L.dg, *SOL = w + L.sol,
        *HX = w + L.hx, *HU = w + L.hu, *XF = w + L.xf, *UF = w + L.uf;

  // stage t's arrays: its buffer, or device memory without one
  auto stage_at = [&](int t) -> Stage {
    if (L.buffers == 0)
      return {a + t * xx, b + t * xu, c + t * nx, q_xx + t * xx,
              q_uu + t * uu, q_xu + t * xu, q_x + t * nx, q_u + t * nu};
    const float* s = sm + (L.buffers == 2 ? (t & 1) : 0) * L.stage;
    return {s + L.a, s + L.b, s + L.c, s + L.qxx, s + L.quu, s + L.qxu,
            s + L.qx, s + L.qu};
  };
  // copy stage t into its buffer as one cp.async group
  auto stage = [&](int t) {
    float* s = sm + (L.buffers == 2 ? (t & 1) : 0) * L.stage;
    stage_span(s + L.a, a + t * xx, xx);
    stage_span(s + L.b, b + t * xu, xu);
    stage_span(s + L.c, c + t * nx, nx);
    stage_span(s + L.qxx, q_xx + t * xx, xx);
    stage_span(s + L.quu, q_uu + t * uu, uu);
    stage_span(s + L.qxu, q_xu + t * xu, xu);
    stage_span(s + L.qx, q_x + t * nx, nx);
    stage_span(s + L.qu, q_u + t * nu, nu);
    cp_async_commit();
  };

  if (L.buffers == 2) stage(nt - 1);
  for (int i = tid; i < xx; i += THREADS) V[i] = qf_xx[i];
  for (int i = tid; i < nx; i += THREADS) VX[i] = qf_x[i];
  const float r = reg[P];
  float dec = 0.f;  // warp 0's lane 0 keeps the sum

  for (int t = nt - 1; t >= 0; --t) {
    if (L.buffers == 2) {
      if (t > 0) {
        stage(t - 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
    } else if (L.buffers == 1) {
      stage(t);
      cp_async_wait<0>();
    }
    __syncthreads();
    const Stage S = stage_at(t);

    // 1. A'V (nx x nx), B'V (nu x nx), V c + v_x
    for (int e = tid; e < xx + xu + nx; e += THREADS) {
      float acc;
      if (e < xx) {
        const int i = e / nx, j = e - i * nx;
        acc = 0.f;
        for (int k = 0; k < nx; ++k)
          acc = fmaf(S.a[k * nx + i], V[k * nx + j], acc);
        AV[e] = acc;
      } else if (e < xx + xu) {
        const int f = e - xx, i = f / nx, j = f - i * nx;
        acc = 0.f;
        for (int k = 0; k < nx; ++k)
          acc = fmaf(S.b[k * nu + i], V[k * nx + j], acc);
        BV[f] = acc;
      } else {
        const int i = e - xx - xu;
        acc = 0.f;
        for (int k = 0; k < nx; ++k) acc = fmaf(V[i * nx + k], S.c[k], acc);
        VC[i] = VX[i] + acc;
      }
    }
    __syncthreads();

    // 2. H_xx = Q_xx + (A'V) A, H_xu = Q_xu + (A'V) B (and its transpose
    // into the right-hand sides), H_uu = Q_uu + (B'V) B + reg I (and a
    // copy to factor), h_x = q_x + A' vc, h_u = q_u + B' vc
    for (int e = tid; e < xx + xu + uu + nx + nu; e += THREADS) {
      float acc = 0.f;
      if (e < xx) {
        const int i = e / nx, j = e - i * nx;
        for (int k = 0; k < nx; ++k)
          acc = fmaf(AV[i * nx + k], S.a[k * nx + j], acc);
        HXX[e] = S.qxx[e] + acc;
      } else if (e < xx + xu) {
        const int f = e - xx, i = f / nu, j = f - i * nu;
        for (int k = 0; k < nx; ++k)
          acc = fmaf(AV[i * nx + k], S.b[k * nu + j], acc);
        const float h = S.qxu[f] + acc;
        HXU[f] = h;
        SOL[j * s1 + i] = h;
      } else if (e < xx + xu + uu) {
        const int f = e - xx - xu, i = f / nu, j = f - i * nu;
        for (int k = 0; k < nx; ++k)
          acc = fmaf(BV[i * nx + k], S.b[k * nu + j], acc);
        float h = S.quu[f] + acc;
        if (i == j) h += r;
        HUU[f] = h;
        LF[f] = h;
      } else if (e < xx + xu + uu + nx) {
        const int i = e - xx - xu - uu;
        for (int k = 0; k < nx; ++k) acc = fmaf(S.a[k * nx + i], VC[k], acc);
        HX[i] = S.qx[i] + acc;
      } else {
        const int i = e - xx - xu - uu - nx;
        for (int k = 0; k < nx; ++k) acc = fmaf(S.b[k * nu + i], VC[k], acc);
        const float h = S.qu[i] + acc;
        HU[i] = h;
        SOL[i * s1 + nx] = h;
      }
    }
    __syncthreads();

    // 3. Cholesky of H_uu + reg I, right-looking, in place in LF (lower
    // triangle), unclamped.  At column j every thread takes the root of
    // the pivot; the trailing entries (i, k), j < k <= i, take the update
    // from column j, which stays unscaled until step j + 1 scales it
    // (nothing reads it then).  The roots go to DG.
    for (int j = 0; j < nu; ++j) {
      const float dj = sqrtf(LF[j * nu + j]);
      const float inv = 1.0f / dj;
      if (tid == 0) DG[j] = dj;
      const int m = nu - 1 - j;
      for (int e = tid; e < m * m; e += THREADS) {
        const int ri = e / m, ck = e - ri * m;
        if (ck <= ri) {
          const int i = j + 1 + ri, k = j + 1 + ck;
          LF[i * nu + k] -= (LF[i * nu + j] * inv) * (LF[k * nu + j] * inv);
        }
      }
      if (j > 0) {
        for (int i = j + tid; i < nu; i += THREADS)
          LF[i * nu + j - 1] = LF[i * nu + j - 1] / DG[j - 1];
      }
      __syncthreads();
    }

    // 4. column q of H_uu^-1 [H_xu' | h_u] by thread q: L y = rhs, L' s =
    // y; column q < nx of the gain is -s, the feedforward (q = nx) too
    for (int q = tid; q < s1; q += THREADS) {
      for (int i = 0; i < nu; ++i) {
        float v = SOL[i * s1 + q];
        for (int k = 0; k < i; ++k) v -= LF[i * nu + k] * SOL[k * s1 + q];
        SOL[i * s1 + q] = v / DG[i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        float v = SOL[i * s1 + q];
        for (int k = i + 1; k < nu; ++k) v -= LF[k * nu + i] * SOL[k * s1 + q];
        SOL[i * s1 + q] = v / DG[i];
      }
      if (q < nx) {
        for (int i = 0; i < nu; ++i)
          gains[t * xu + i * nx + q] = -SOL[i * s1 + q];
      } else {
        for (int i = 0; i < nu; ++i) ffs[t * nu + i] = -SOL[i * s1 + nx];
      }
    }
    __syncthreads();

    // 5. the predicted decrease -k'(h_u + 0.5 H_uu k) by warp 0, then the
    // value update V = 0.5 (T + T'), T = H_xx + H_xu K, v_x = h_x + H_xu k
    if (warp == 0) {
      float part = 0.f;
      for (int i = lane; i < nu; i += 32) {
        float hk = 0.f;
        for (int m = 0; m < nu; ++m)
          hk = fmaf(HUU[i * nu + m], -SOL[m * s1 + nx], hk);
        part = fmaf(-SOL[i * s1 + nx], HU[i] + 0.5f * hk, part);
      }
      part = warp_sum(part);
      if (lane == 0) dec -= part;
    }
    for (int e = tid; e < xx + nx; e += THREADS) {
      if (e < xx) {
        const int i = e / nx, j = e - i * nx;
        float t1 = HXX[i * nx + j], t2 = HXX[j * nx + i];
        for (int k = 0; k < nu; ++k) {
          t1 = fmaf(HXU[i * nu + k], -SOL[k * s1 + j], t1);
          t2 = fmaf(HXU[j * nu + k], -SOL[k * s1 + i], t2);
        }
        V[e] = 0.5f * (t1 + t2);
      } else {
        const int i = e - xx;
        float t1 = HX[i];
        for (int k = 0; k < nu; ++k)
          t1 = fmaf(HXU[i * nu + k], -SOL[k * s1 + nx], t1);
        VX[i] = t1;
      }
    }
    __syncthreads();
  }
  if (tid == 0) dec_out[P] = dec;

  // forward rollout: du_t = k_t + K_t dx_t, dx_{t+1} = A dx + B du + c;
  // the gains were stored by this block (visible after the barriers)
  for (int i = tid; i < nx; i += THREADS) XF[i] = dx0[i];
  __syncthreads();
  for (int t = 0; t < nt; ++t) {
    const float* cur = XF + (t & 1) * nx;
    float* nxt = XF + ((t + 1) & 1) * nx;
    for (int i = tid; i < nx; i += THREADS) dx[t * nx + i] = cur[i];
    for (int i = warp; i < nu; i += WARPS) {
      const float* g = gains + t * xu + i * nx;
      float part = 0.f;
      for (int m = lane; m < nx; m += 32) part = fmaf(g[m], cur[m], part);
      part = warp_sum(part);
      if (lane == 0) {
        const float u = ffs[t * nu + i] + part;
        UF[i] = u;
        du[t * nu + i] = u;
      }
    }
    __syncthreads();
    for (int i = warp; i < nx; i += WARPS) {
      const float* ar = a + t * xx + i * nx;
      const float* br = b + t * xu + i * nu;
      float part = 0.f;
      for (int m = lane; m < nx; m += 32) part = fmaf(ar[m], cur[m], part);
      for (int m = lane; m < nu; m += 32) part = fmaf(br[m], UF[m], part);
      part = warp_sum(part);
      if (lane == 0) nxt[i] = part + c[t * nx + i];
    }
    __syncthreads();
  }
  for (int i = tid; i < nx; i += THREADS)
    dx[T * nx + i] = XF[(nt & 1) * nx + i];
}

}  // namespace

// C interface, loaded with ctypes.  The arguments of
// gpmpc_riccati_sweep_f32 (riccati_sweep.cu) with the workspace after
// the 17 arrays: batch * gpmpc_riccati_block_layout's work floats where
// the working set passes shared memory (workspace flag 1), else unused
// (may be null).  Any nx >= 1, nu >= 1.
extern "C" int gpmpc_riccati_sweep_block_f32(
    const float* a, const float* b, const float* c, const float* q_xx,
    const float* q_uu, const float* q_xu, const float* q_x, const float* q_u,
    const float* qf_xx, const float* qf_x, const float* dx0, const float* reg,
    float* dx, float* du, float* gains, float* ffs, float* dec,
    float* workspace, int batch, int nt, int nx, int nu, void* stream) {
  if (batch <= 0 || nt <= 0 || nx <= 0 || nu <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockLayout L = block_layout(nx, nu);
  if (!L.work_smem && workspace == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      riccati_sweep_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      4 * OPTIN_FLOATS);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  riccati_sweep_block_kernel<<<batch, THREADS, L.smem_bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg, dx, du,
      gains, ffs, dec, workspace, nt, nx, nu, L);
  return static_cast<int>(cudaGetLastError());
}

// The layout the kernel takes at (nx, nu), for the wrapper's mirror:
// out = {stage buffers, working set in shared memory (1) or workspace
// (0), floats of the working set, dynamic shared memory bytes}.
extern "C" void gpmpc_riccati_block_layout(int nx, int nu, int* out) {
  const BlockLayout L = block_layout(nx, nu);
  out[0] = L.buffers;
  out[1] = L.work_smem;
  out[2] = L.work;
  out[3] = L.smem_bytes;
}
