// K1's block path: the Riccati sweep over the block-banded KKT system of a
// trajectory QP -- the backward factorization and the forward rollout -- in
// one launch, one thread block per problem, at any (nx, nu).
//
// Replaces gpmpc_tpu/ops/pallas_kernels.py:riccati_sweep_pallas (body
// _riccati_kernel, _chol_cols_small, _chol_solve_small) at the pairs the
// warp kernel (riccati_sweep.cu) does not take: nx >= 31 or nu > 32, where
// its lanes run out.  Same math as gpmpc_tpu_torch/solvers/riccati.py:solve
// and its plain twin ops/cuda_kernels.py:riccati_sweep_reference, worked
// from the stacked stage matrix Z = [A B c] (n = nx + nu):
//
//   M = V [A B c] + [0 0 v_x]                              (nx x (n + 1))
//   [H | h] = [A B]' M + [Q_xx Q_xu; Q_xu' Q_uu + reg I | q]   (lower H)
//   S = H_uu^-1 [H_ux | h_u] (Cholesky)   gains -S[:, :nx], ffs -S[:, nx]
//   [V | v_x] = [H_xx | h_x] - H_ux' S                 (lower V, mirrored)
//   dec -= k'(h_u + 0.5 H_uu k),  k = -S[:, nx]
//
// V is exactly symmetric (its lower triangle mirrored) where the plain
// version takes 0.5 (T + T').  The cost block need not be symmetric (the
// solver's Hessians, jacfwd of jacrev, are so only up to rounding): H_uu's
// factor takes Q_uu's lower triangle as given, as the plain version's
// Cholesky reads it, and H, whence V, v_x and the predicted decrease,
// takes 0.5 (Q + Q'), as the plain version symmetrizes V and sums k'H_uu k
// over the whole of H_uu.
//
// What bounds it on an H100: latency, not operations or bytes.  At B = 1
// one block runs on one SM, so the floor is one SM's share of the f32
// peak, 67 TFLOP/s / 132 = 0.51 TFLOP/s: 0.021 ms at (40, 20), Nt = 20
// (10.8 MFLOP), 0.0094 ms at (40, 40), Nt = 5.  The chain is Nt dependent
// stages, each a few dense products, a Cholesky and triangular solves.
// Measured with clock64 stamps (GPMPC_RICCATI_STAMPS below; PERF.md §6),
// what a stage pays besides its arithmetic is: block barriers; shared-
// memory and shuffle round trips on a dependent chain (29 and 15 SM
// cycles); warp shuffles and cp.async, which an SM serves about one warp
// instruction at a time whatever they move; __frsqrt_rn (119 cycles);
// generic loads where the compiler cannot tell shared from device memory;
// and instruction fetch, where a loop body passes the instruction cache.
// This kernel's first version (one output per thread, a barrier per
// Cholesky column, solves in nx + 1 threads) took 1.08 ms at (40, 20),
// Nt = 20, 33% of it in the products, 24% in the solves, 19% in the
// Cholesky, 12% in the value update and 11% in the rollout.  This design:
//
// * The working set sits in shared memory where it fits, and the kernel
//   is a template on that (WSM), so that every array of the sweep is known
//   to the compiler as shared (LDS and STS, not generic loads).
// * Stage products as two register-tiled passes (M, then H and h), and the
//   value update as a third (V and v_x).  A thread owns a 4 x 4 output tile
//   (4 x 1 for the h and v_x columns) and keeps its sums in registers; both
//   operands are rows of shared arrays (V is symmetric, so V[:, i] is
//   V[i, :]), read as float4: the lanes of a warp read one row, so no two
//   lanes' float4s share a bank.  The tile coordinates come from the tile
//   index once (tri_tile, rect_tile below), never divided out per entry;
//   H and V compute their lower triangles only.  The cost terms arrive
//   laid out as H (QH), so the epilogue adds one term an entry; epilogues
//   run one entry's code in a loop, so the loop body stays small.
// * H_uu is factored by panels of PANEL = 32 columns.  Warp 0 factors a
//   panel's diagonal block in registers: lane r holds row r's trailing part
//   and shifts it down one register a column (static indices), the pivot
//   of column j reaches the lanes by one shuffle and the column by eight at
//   a time, and the next pivot's MUFU.RSQ is issued before the trailing
//   update (its Newton step after).  One block barrier after it, none per
//   column; the other warps issue the next stage's copy meanwhile.  Past
//   32 columns the rows below a panel are solved as more right-hand sides,
//   and the trailing matrix and right-hand sides are updated as a tiled
//   product: three block barriers a panel.  A non-PD pivot gives NaN and a
//   zero pivot inf (never clamped), so the gains come out non-finite.
// * The gains' solves: the nx + 1 right-hand sides go to the warps in
//   groups of GV = 8; lanes hold rows, the substitution runs by columns,
//   each solved entry broadcast by a shuffle: ~nu steps of one
//   multiply-add a lane forward and back, GV chains side by side.  (One
//   thread a right-hand side, no shuffles, measured 2.4x slower: each row
//   waits on shared-memory loads.)
// * The predicted decrease: one warp sums k'h_u + 0.5 k'H_uu k over the
//   lower triangle of H_uu in a fixed order and a fixed shuffle butterfly,
//   beside the value update; no atomics, so a run repeats bitwise.
// * The gains stay in shared memory, one slot a stage, where all Nt fit
//   beside the working set (Nt nu (nx + 1) floats: 70 KB at (40, 20), Nt =
//   20); the forward rollout reads them there, A, B and c staged a step
//   ahead by cp.async, four lanes an entry over the whole block: du_t, a
//   barrier, dx_{t+1}, a barrier.  (One barrier a step, du_t in every
//   warp, measured 2-9% slower on the launch: the redundant loads cost
//   more than the barrier.)  Where the gains do not fit, the rollout reads
//   them back from device memory.
// * Copies move whole arrays, 16 bytes a lane where aligned, so every lane
//   of a cp.async has work; row strides are odd multiples of 4 floats
//   (ld4), so the 8 rows a warp reads four lanes a row start in 8 bank
//   quads.
// * nx and nu are run-time arguments: one instantiation (of each WSM)
//   serves every pair, one block of THREADS threads per problem, the grid
//   the batch.  Stage t's arrays reach shared memory by cp.async, in two
//   buffers where two stages fit beside the working set (stage t-1's copy
//   in flight while stage t is solved), else one.  Where a stage and the
//   working set pass the 227 KB a block may opt in to, the working set
//   moves to a per-problem workspace in device memory that the caller
//   allocates (block_layout gives its floats; the wrapper's torch.empty
//   takes it from the caching allocator, no host sync), and the stages
//   keep two shared buffers, one, or (past one stage) a buffer in the
//   workspace.  ops/cuda_kernels.py:riccati_block_layout mirrors
//   block_layout; for nx = nu = n the working set leaves shared memory
//   from n = 61.
//
// reg and dx0 are device pointers, so the caller never syncs the host.
//
// GPMPC_RICCATI_STAMPS: defined only for a library of its own (chip_smoke.py
// --k1 builds it beside the main one), it makes thread 0 of problem 0 sum
// the SM cycles (clock64) of each section of every launch -- the stage
// copy, the products, the Cholesky, the solves, the value update and
// decrease, the rollout -- into gpmpc_riccati_stamps, which
// gpmpc_riccati_block_stamps reads and zeroes.  The main library has none.

#include <cstdint>
#include <cuda_runtime.h>

#if defined(__CUDACC__)
#define GPMPC_HD __host__ __device__
#else
#define GPMPC_HD
#endif

namespace {

// Threads of a problem's block.  ops/cuda_kernels.py mirrors it as
// RICCATI_BLOCK_THREADS.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

// The most dynamic shared memory a block may opt in to on an H100 (227
// KB), in floats: SMEM_OPTIN of riccati_sweep.cu.
constexpr int OPTIN_FLOATS = 232448 / 4;

// Columns of a Cholesky panel: a warp's lanes.
constexpr int PANEL = 32;

// Right-hand sides a warp carries through one substitution.
constexpr int GV = 8;

// Lanes that share one entry of du_t or dx_{t+1} in the rollout.
constexpr int RG = 4;

GPMPC_HD constexpr int pad4(int n) { return (n + 3) & ~3; }

// A leading dimension of at least n floats, an odd multiple of 4: rows
// stay 16-byte aligned for float4 reads, and the 8 rows that the lanes of
// a warp read in groups of 4 start in 8 different bank quads.
GPMPC_HD constexpr int ld4(int n) {
  return (pad4(n) & 4) ? pad4(n) : pad4(n) + 4;
}

// ---- the tile schedule (host and device) ----
// A thread's output tile: rows i0 .. i0 + 3, columns j0 .. j0 + tn - 1
// (tn = 4, or 1 for a tile of the extra column).
struct Tile {
  int i0, j0, tn;
};

GPMPC_HD inline int cdiv4(int n) { return (n + 3) >> 2; }

// A rows x cols rectangle in 4 x 4 tiles, row by row.
GPMPC_HD inline int rect_count(int rows, int cols) {
  return cdiv4(rows) * cdiv4(cols);
}

GPMPC_HD inline Tile rect_tile(int t, int cols) {
  const int c4 = cdiv4(cols), bi = t / c4;
  return {4 * bi, 4 * (t - bi * c4), 4};
}

// The lower triangle of a rows x rows matrix in 4 x 4 tiles (tile column
// <= tile row), then, where col >= 0, one 4 x 1 tile a tile row at column
// col (the h or v_x column beside H or V).
GPMPC_HD inline int tri_count(int rows, int col) {
  const int r4 = cdiv4(rows);
  return r4 * (r4 + 1) / 2 + (col >= 0 ? r4 : 0);
}

GPMPC_HD inline Tile tri_tile(int t, int rows, int col) {
  const int r4 = cdiv4(rows), ntri = r4 * (r4 + 1) / 2;
  if (t >= ntri) return {4 * (t - ntri), col, 1};
  int bi = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (bi * (bi + 1) / 2 > t) --bi;
  while ((bi + 1) * (bi + 2) / 2 <= t) ++bi;
  return {4 * bi, 4 * (t - bi * (bi + 1) / 2), 4};
}

// Whether a tile writes its entry (i, j) of a rows x cols output: inside
// it, and for a triangle's 4 x 4 tile on or below the diagonal.
GPMPC_HD inline bool tile_keeps(const Tile& T, int i, int j, int rows,
                                int cols, bool tri) {
  return i < rows && j < cols && (!tri || T.tn == 1 || j <= i);
}

// H_uu's panels: PANEL columns each, the last the rest.
GPMPC_HD inline int panel_count(int nu) { return (nu + PANEL - 1) / PANEL; }

GPMPC_HD inline int panel_width(int p, int nu) {
  return nu - PANEL * p < PANEL ? nu - PANEL * p : PANEL;
}
// ---- end of the tile schedule ----

// Offsets in floats, each array 16-byte aligned, and leading dimensions.
// A stage buffer: Z = [A B c] (nx rows of ldn) and QH = [Q_xx Q_xu; Q_ux
// Q_uu | q] (n rows of ldn, q in column n), the cost terms laid out as H.
// The working set: V (nx x ldv, symmetric), v_x, M (nx x ldn), H (n x ldn:
// lower H, h in column n), W (H_uu's lower triangle, then its panels'
// factors; pad4(nu) rows of the odd ldw), S (nu x lds: [H_ux | h_u], solved
// in place; unused where the gains stay in shared memory), the current
// panel's factor (pw x ldp, 1 / L_jj on its diagonal), the forward pass's
// state (two of ldv) and du; and, where no stage buffer fits
// shared memory, a stage buffer (zs).
struct BlockLayout {
  int ldn, ldv, lds, ldw, pw, ldp;
  int z, qh, stage;  // stage: floats a buffer
  int v, vx, m, h, w, s, pv, xf, uf, zs, work;
  int buffers;     // stage buffers in shared memory: 2, 1 or 0
  int work_smem;   // 1: the working set in shared memory, 0: workspace
  int smem_bytes;  // dynamic shared memory of the launch, gains aside
};

inline BlockLayout block_layout(int nx, int nu) {
  BlockLayout L;
  const int n = nx + nu;
  L.ldn = ld4(n + 1);
  L.ldv = ld4(nx);
  L.lds = ld4(nx + 1);
  L.ldw = nu | 1;
  L.pw = nu < PANEL ? nu : PANEL;
  L.ldp = L.pw | 1;
  int o = 0;
  L.z = o;   o += nx * L.ldn;
  L.qh = o;  o += n * L.ldn;
  L.stage = o;
  o = 0;
  L.v = o;   o += nx * L.ldv;
  L.vx = o;  o += L.ldv;
  L.m = o;   o += nx * L.ldn;
  L.h = o;   o += n * L.ldn;
  L.w = o;   o += pad4(pad4(nu) * L.ldw);
  L.s = o;   o += nu * L.lds;
  L.pv = o;  o += pad4(L.pw * L.ldp);
  L.xf = o;  o += 2 * L.ldv;
  L.uf = o;  o += pad4(nu);
  L.zs = o;
  L.work = o;
  if (L.work + 2 * L.stage <= OPTIN_FLOATS) {
    L.buffers = 2; L.work_smem = 1;
  } else if (L.work + L.stage <= OPTIN_FLOATS) {
    L.buffers = 1; L.work_smem = 1;
  } else {
    L.work_smem = 0;
    L.buffers = 2 * L.stage <= OPTIN_FLOATS ? 2
                : (L.stage <= OPTIN_FLOATS ? 1 : 0);
    if (L.buffers == 0) L.work += L.stage;
  }
  L.smem_bytes = 4 * (L.buffers * L.stage + (L.work_smem ? L.work : 0));
  if (L.smem_bytes == 0) L.smem_bytes = 16;
  return L;
}

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ bool aligned16(const float* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Threads r0, r0 + nr, ... copy a rows x cols array (row-major, rows of
// cols floats) into rows of ldd floats at dst: by cp.async into shared
// memory, 16 bytes a thread where both sides allow it, else 4, or by
// plain loads and stores into the workspace.  The whole array is one
// index space, so every lane of a warp has work: a cp.async costs the
// SM's load unit about the same per warp instruction whatever it moves.
__device__ __forceinline__ void copy_rows(float* dst, int ldd,
                                          const float* src, int rows,
                                          int cols, bool async, int r0,
                                          int nr) {
  if (async && (cols & 3) == 0 && aligned16(src) && aligned16(dst)) {
    const int c4 = cols >> 2;
    for (int v = r0; v < rows * c4; v += nr) {
      const int k = v / c4;
      cp_async16(dst + k * ldd + 4 * (v - k * c4), src + 4 * v);
    }
  } else {
    for (int e = r0; e < rows * cols; e += nr) {
      const int k = e / cols;
      float* d = dst + k * ldd + e - k * cols;
      if (async) cp_async4(d, src + e);
      else *d = __ldg(src + e);
    }
  }
}

// Stage t's arrays into the buffer s by warps w0 .. WARPS - 1 (one
// cp.async group where it is shared): Z = [A_t | B_t | c_t], and with full
// QH = [Q_xx Q_xu | q_x; Q_xu' Q_uu | q_u], each array copied whole.
__device__ __forceinline__ void stage_copy(
    float* s, const BlockLayout& L, int nx, int nu, const float* a,
    const float* b, const float* c, const float* q_xx, const float* q_uu,
    const float* q_xu, const float* q_x, const float* q_u, bool full,
    bool async, int w0) {
  const int r0 = threadIdx.x - 32 * w0, nr = THREADS - 32 * w0;
  const int n = nx + nu, ldn = L.ldn;
  copy_rows(s, ldn, a, nx, nx, async, r0, nr);
  copy_rows(s + nx, ldn, b, nx, nu, async, r0, nr);
  copy_rows(s + n, ldn, c, nx, 1, async, r0, nr);
  if (full) {
    float* qh = s + L.qh;
    copy_rows(qh, ldn, q_xx, nx, nx, async, r0, nr);
    copy_rows(qh + nx, ldn, q_xu, nx, nu, async, r0, nr);
    copy_rows(qh + nx * ldn + nx, ldn, q_uu, nu, nu, async, r0, nr);
    copy_rows(qh + n, ldn, q_x, nx, 1, async, r0, nr);
    copy_rows(qh + nx * ldn + n, ldn, q_u, nu, 1, async, r0, nr);
    // Q_ux = Q_xu', read in Q_xu's order
    for (int e = r0; e < nx * nu; e += nr) {
      const int j = e / nu;
      float* d = qh + (nx + e - j * nu) * ldn + j;
      if (async) cp_async4(d, q_xu + e);
      else *d = __ldg(q_xu + e);
    }
  }
  if (async) cp_async_commit();
}

// sum over the warp by a fixed butterfly: every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// acc[a][b] += sum_k P(k, a) Q(k, b), k < K.  P(k, a) = p[k pk + a pi]:
// with PV a's four entries are one aligned float4 (pi = 1); Q likewise
// with QV, or one column (TN = 1).
template <int TN, bool PV, bool QV>
__device__ __forceinline__ void tile_mac(float (&acc)[4][TN], const float* p,
                                         int pk, int pi, const float* q,
                                         int qk, int qj, int K) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    float pa[4], qb[TN];
    if constexpr (PV) {
      const float4 v = *reinterpret_cast<const float4*>(p + k * pk);
      pa[0] = v.x; pa[1] = v.y; pa[2] = v.z; pa[3] = v.w;
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p[k * pk + a * pi];
    }
    if constexpr (TN == 4 && QV) {
      const float4 v = *reinterpret_cast<const float4*>(q + k * qk);
      qb[0] = v.x; qb[1] = v.y; qb[2] = v.z; qb[3] = v.w;
    } else {
#pragma unroll
      for (int b = 0; b < TN; ++b) qb[b] = q[k * qk + b * qj];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(pa[a], qb[b], acc[a][b]);
  }
}

template <int TN>
__device__ __forceinline__ void zero(float (&acc)[4][TN]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;
}

// Entry (e, f) of a 4 x 4 tile by selects, so that an epilogue loops over
// its entries with one copy of its code.
__device__ __forceinline__ float entry(const float (&acc)[4][4], int e,
                                       int f) {
  float r[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    r[b] = e == 0 ? acc[0][b]
           : (e == 1 ? acc[1][b] : (e == 2 ? acc[2][b] : acc[3][b]));
  return f == 0 ? r[0] : (f == 1 ? r[1] : (f == 2 ? r[2] : r[3]));
}

// 1 / sqrt(x) from y = MUFU.RSQ(x) by one Newton step: within an ulp or
// two of the rounded value at a third of __frsqrt_rn's latency (119 SM
// cycles on an H100, measured); a negative x gives NaN and a zero one inf
// (the Newton step alone would give 0 * inf = NaN), as the unclamped
// Cholesky wants.
__device__ __forceinline__ float rsqrt_newton(float x, float y) {
  const float z = y * fmaf(-0.5f * x * y, y, 1.5f);
  return x == 0.f ? y : z;
}

// Warp 0 factors the pw x pw diagonal block of W at (c0, c0) into Lp (ld):
// row r ends with L[r][k] (k < r) and 1 / L[r][r] on the diagonal.  Lane
// r keeps row r's trailing part in registers, a[m] = entry (r, j + m) at
// column j, shifted down one register a column (static indices); column
// j's entries reach the rows below by shuffles, eight issued at a time,
// and the next pivot's 1 / sqrt is taken before column j's trailing
// update, off its chain.  Unclamped: a negative pivot gives NaN, a zero
// one inf.
__device__ __forceinline__ void factor_panel(float* Lp, int ld,
                                             const float* W, int ldw, int c0,
                                             int pw, int lane) {
  const bool mine = lane < pw;
  const float* src = W + (c0 + (mine ? lane : 0)) * ldw + c0;
  float* row = Lp + (mine ? lane : 0) * ld;
  float a[PANEL];
#pragma unroll
  for (int m = 0; m < PANEL; ++m) a[m] = mine && m < lane ? src[m] : 0.f;
  float dg = mine ? src[lane] : 1.f;
  const float piv0 = __shfl_sync(FULL, dg, 0);
  float rd = rsqrt_newton(piv0, rsqrtf(piv0));
  for (int j = 0; j < pw; ++j) {
    const bool below = mine && lane > j;
    const float lv = a[0] * rd;
    const float l = below ? lv : 0.f;
    dg = below ? fmaf(-lv, lv, dg) : dg;
    const float piv = __shfl_sync(FULL, dg, j + 1 < pw ? j + 1 : j);
    const float y0 = rsqrtf(piv);  // its Newton step after the update
    if (below) row[j] = lv;
    if (lane == j) row[j] = rd;
    // a[m - 1] = entry (r, j + m) - l_rj l_(j+m)j: column j + 1's window
#pragma unroll
    for (int m0 = 1; m0 < PANEL; m0 += 8) {
      if (j + m0 >= pw) break;
      float lk[8];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        lk[q] = __shfl_sync(FULL, l, (j + m0 + q) & 31);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (m0 + q < PANEL) a[m0 + q - 1] = fmaf(-l, lk[q], a[m0 + q]);
    }
    rd = rsqrt_newton(piv, y0);
  }
}

// L y = b for GV right-hand sides a warp, lane r holding row r, the
// factor's rows in Lp (ld) as factor_panel leaves them (rdl: this lane's
// 1 / L[r][r]): column j's entry is solved on lane j and reaches the rows
// below by a shuffle, GV chains side by side.
__device__ __forceinline__ void forward(const float* Lp, int ld, float rdl,
                                        float (&y)[GV], int pw, int lane) {
  const float* row = Lp + (lane < pw ? lane : pw - 1) * ld;
  for (int j = 0; j < pw; ++j) {
    const float lrj = row[j];
#pragma unroll
    for (int g = 0; g < GV; ++g) {
      const float yj = __shfl_sync(FULL, y[g] * rdl, j);
      y[g] = lane == j ? yj : (lane > j ? fmaf(-lrj, yj, y[g]) : y[g]);
    }
  }
}

// L' x = y likewise.
__device__ __forceinline__ void back(const float* Lp, int ld, float rdl,
                                     float (&y)[GV], int pw, int lane) {
  for (int j = pw - 1; j >= 0; --j) {
    const float lji = Lp[j * ld + (lane < j ? lane : 0)];
#pragma unroll
    for (int g = 0; g < GV; ++g) {
      const float sj = __shfl_sync(FULL, y[g] * rdl, j);
      y[g] = lane == j ? sj : (lane < j ? fmaf(-lji, sj, y[g]) : y[g]);
    }
  }
}

#ifdef GPMPC_RICCATI_STAMPS
// SM cycles by section (clock64 of thread 0 of problem 0), summed over the
// launches since the last gpmpc_riccati_block_stamps; slot 6 counts them.
__device__ unsigned long long gpmpc_riccati_stamps[8];
#define STAMP_BEGIN                                          \
  const bool stamping = blockIdx.x == 0 && threadIdx.x == 0; \
  long long st_last = clock64(), st_acc[6] = {0, 0, 0, 0, 0, 0}
#define STAMP(s)                          \
  do {                                    \
    if (stamping) {                       \
      const long long st_now = clock64(); \
      st_acc[s] += st_now - st_last;      \
      st_last = st_now;                   \
    }                                     \
  } while (0)
#define STAMP_END                                              \
  do {                                                         \
    if (stamping) {                                            \
      for (int s = 0; s < 6; ++s)                              \
        atomicAdd(&gpmpc_riccati_stamps[s],                    \
                  static_cast<unsigned long long>(st_acc[s])); \
      atomicAdd(&gpmpc_riccati_stamps[6], 1ull);               \
    }                                                          \
  } while (0)
#else
#define STAMP_BEGIN do {} while (0)
#define STAMP(s) do {} while (0)
#define STAMP_END do {} while (0)
#endif

enum { ST_COPY, ST_PRODUCTS, ST_CHOL, ST_SOLVES, ST_VALUE, ST_ROLLOUT };

// WSM: the working set in shared memory (every array of the sweep then
// known to the compiler as shared), else in the workspace.
template <bool WSM>
__global__ void __launch_bounds__(THREADS, 1) riccati_sweep_block_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ c, const float* __restrict__ q_xx,
    const float* __restrict__ q_uu, const float* __restrict__ q_xu,
    const float* __restrict__ q_x, const float* __restrict__ q_u,
    const float* __restrict__ qf_xx, const float* __restrict__ qf_x,
    const float* __restrict__ dx0, const float* __restrict__ reg,
    float* __restrict__ dx, float* __restrict__ du,
    float* __restrict__ gains, float* __restrict__ ffs,
    float* __restrict__ dec_out, float* __restrict__ workspace, int nt,
    int nx, int nu, BlockLayout L, int gains_at) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t P = blockIdx.x;
  const size_t T = static_cast<size_t>(nt);
  const int xx = nx * nx, xu = nx * nu, uu = nu * nu, n = nx + nu;
  const int ldn = L.ldn, ldv = L.ldv, lds = L.lds, ldw = L.ldw;
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
  float* w;
  if constexpr (WSM) w = sm + L.buffers * L.stage;
  else w = workspace + P * static_cast<size_t>(L.work);
  float *V = w + L.v, *VX = w + L.vx, *M = w + L.m, *H = w + L.h,
        *W = w + L.w, *PV = w + L.pv, *XF = w + L.xf,
        *UF = w + L.uf;
  // the gains' slots: all Nt in shared memory from gains_at where they fit
  const bool gsm = gains_at >= 0;
  const bool async = L.buffers > 0;
  auto zbuf = [&](int t) -> float* {
    if constexpr (WSM)
      return sm + (L.buffers == 2 ? (t & 1) : 0) * L.stage;
    else
      return L.buffers == 0 ? w + L.zs
                            : sm + (L.buffers == 2 ? (t & 1) : 0) * L.stage;
  };
  // stage t into its buffer by warps w0 and up; with full = false only
  // Z, for the rollout
  auto stage = [&](int t, bool full, int w0) {
    stage_copy(zbuf(t), L, nx, nu, a + t * xx, b + t * xu, c + t * nx,
               q_xx + t * xx, q_uu + t * uu, q_xu + t * xu, q_x + t * nx,
               q_u + t * nu, full, async, w0);
  };

  STAMP_BEGIN;
  stage(nt - 1, true, 0);
  // V = Qf_xx, stored transposed: pass 1 reads V's columns as rows
  for (int i = tid; i < xx; i += THREADS) {
    const int row = i / nx;
    V[(i - row * nx) * ldv + row] = qf_xx[i];
  }
  for (int i = tid; i < nx; i += THREADS) VX[i] = qf_x[i];
  const float r = reg[P];
  float dec = 0.f;  // the last warp keeps the sum
  if (async) cp_async_wait_all();
  __syncthreads();
  STAMP(ST_COPY);

  for (int t = nt - 1; t >= 0; --t) {
    // stage t is in its buffer (stage t - 1's copy goes in flight while
    // warp 0 factors H_uu)
    const float* zs = zbuf(t);
    const float *Z = zs + L.z, *QH = zs + L.qh;
    float* S = gsm ? sm + gains_at + t * nu * lds : w + L.s;

    // 1. M = V [A B c] + [0 0 v_x]: nx x (n + 1) in 4 x 4 tiles
    for (int ti = tid; ti < rect_count(nx, n + 1); ti += THREADS) {
      const Tile tl = rect_tile(ti, n + 1);
      float acc[4][4];
      zero(acc);
      tile_mac<4, true, true>(acc, V + tl.i0, ldv, 1, Z + tl.j0, ldn, 1, nx);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = tl.i0 + e;
        if (i >= nx) break;
        float4 o = make_float4(acc[e][0], acc[e][1], acc[e][2], acc[e][3]);
        const int d = n - tl.j0;  // v_x joins column n
        if (d == 0) o.x += VX[i];
        if (d == 1) o.y += VX[i];
        if (d == 2) o.z += VX[i];
        if (d == 3) o.w += VX[i];
        *reinterpret_cast<float4*>(M + i * ldn + tl.j0) = o;
      }
    }
    __syncthreads();

    // 2. H = [A B]' M + Q (+ reg I on H_uu), lower, and h = [A B]' m + q in
    // column n; H_ux and h_u also into S, H_uu also into W
    for (int ti = tid; ti < tri_count(n, n); ti += THREADS) {
      const Tile tl = tri_tile(ti, n, n);
      float acc[4][4];
      zero(acc);
      if (tl.tn == 4) {
        tile_mac<4, true, true>(acc, Z + tl.i0, ldn, 1, M + tl.j0, ldn, 1,
                                nx);
      } else {
        float col[4][1];
        zero(col);
        tile_mac<1, true, false>(col, Z + tl.i0, ldn, 1, M + n, ldn, 0, nx);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e][0] = col[e][0];
      }
#pragma unroll 1
      for (int e = 0; e < 4; ++e)
#pragma unroll 1
        for (int f = 0; f < tl.tn; ++f) {
          const int i = tl.i0 + e, j = tl.j0 + f;
          if (!tile_keeps(tl, i, j, n, n + 1, true)) continue;
          const bool xrow = i < nx;
          const float p = entry(acc, e, f), ql = QH[i * ldn + j];
          const float rr = !xrow && i == j ? r : 0.f;
          const float h =
              p + (j == n ? ql : 0.5f * (ql + QH[j * ldn + i])) + rr;
          if (!xrow && j >= nx && j < n)
            W[(i - nx) * ldw + j - nx] = p + ql + rr;
          else if (!xrow)
            S[(i - nx) * lds + (j == n ? nx : j)] = h;
          H[i * ldn + j] = h;
        }
    }
    __syncthreads();
    STAMP(ST_PRODUCTS);

    // 3-4. H_uu = L L' by panels, S = H_uu^-1 [H_ux | h_u] in place, a
    // thread a right-hand side: the S columns, and for a panel with rows
    // below it those rows of W
    const int np = panel_count(nu);
    for (int p = 0; p < np; ++p) {
      const int c0 = PANEL * p, pw = panel_width(p, nu), c1 = c0 + pw;
      const bool last = p == np - 1;
      if (warp == 0) factor_panel(PV, L.ldp, W, ldw, c0, pw, lane);
      else if (p == 0 && L.buffers == 2 && t > 0) stage(t - 1, true, 1);
      __syncthreads();
      STAMP(ST_CHOL);
      // the S columns over the panel's rows (the last panel: forward and
      // back), then the rows below the panel, GV a warp
      const float rdl = lane < pw ? PV[lane * L.ldp + lane] : 0.f;
      const int ns = (nx + GV) / GV, nr = last ? 0 : (nu - c1 + GV - 1) / GV;
      for (int g = warp; g < ns + nr; g += WARPS) {
        float y[GV];
        if (g < ns) {
          float* col = S + (c0 + lane) * lds + g * GV;
          const int nv = nx + 1 - g * GV;
#pragma unroll
          for (int k = 0; k < GV; ++k)
            y[k] = lane < pw && k < nv ? col[k] : 0.f;
          forward(PV, L.ldp, rdl, y, pw, lane);
          if (last) back(PV, L.ldp, rdl, y, pw, lane);
#pragma unroll
          for (int k = 0; k < GV; ++k)
            if (lane < pw && k < nv) col[k] = y[k];
        } else {
          const int r0 = c1 + (g - ns) * GV;
#pragma unroll
          for (int k = 0; k < GV; ++k)
            y[k] = lane < pw && r0 + k < nu ? W[(r0 + k) * ldw + c0 + lane]
                                            : 0.f;
          forward(PV, L.ldp, rdl, y, pw, lane);
#pragma unroll
          for (int k = 0; k < GV; ++k)
            if (lane < pw && r0 + k < nu) W[(r0 + k) * ldw + c0 + lane] = y[k];
        }
      }
      if (!last) {
        // the factor kept for the back solve; the trailing H_uu -= L21
        // L21' (lower) and the rows below of S -= L21 Y
        if (warp == 0 && lane < pw)
          for (int k = 0; k <= lane; ++k)
            W[(c0 + lane) * ldw + c0 + k] = PV[lane * L.ldp + k];
        __syncthreads();
        const int rows = nu - c1, ntri = tri_count(rows, -1);
        for (int ti = tid; ti < ntri + rect_count(rows, nx + 1);
             ti += THREADS) {
          const bool tri = ti < ntri;
          const Tile tl = tri ? tri_tile(ti, rows, -1)
                              : rect_tile(ti - ntri, nx + 1);
          float acc[4][4];
          zero(acc);
          const float* l21 = W + (c1 + tl.i0) * ldw + c0;
          if (tri)
            tile_mac<4, false, false>(acc, l21, 1, ldw,
                                      W + (c1 + tl.j0) * ldw + c0, 1, ldw,
                                      pw);
          else
            tile_mac<4, false, true>(acc, l21, 1, ldw, S + c0 * lds + tl.j0,
                                     lds, 1, pw);
#pragma unroll 1
          for (int e = 0; e < 4; ++e)
#pragma unroll 1
            for (int f = 0; f < 4; ++f) {
              const int i = tl.i0 + e, j = tl.j0 + f;
              if (!tile_keeps(tl, i, j, rows, tri ? rows : nx + 1, tri))
                continue;
              float* o = tri ? W + (c1 + i) * ldw + c1 + j
                             : S + (c1 + i) * lds + j;
              *o -= entry(acc, e, f);
            }
        }
      }
      __syncthreads();
      STAMP(ST_SOLVES);
    }
    // the earlier panels' back solves: S_p -= L21' S_below, then L11'
    for (int p = np - 2; p >= 0; --p) {
      const int c0 = PANEL * p, pw = panel_width(p, nu), c1 = c0 + pw;
      for (int ti = tid; ti < rect_count(pw, nx + 1); ti += THREADS) {
        const Tile tl = rect_tile(ti, nx + 1);
        float acc[4][4];
        zero(acc);
        tile_mac<4, false, true>(acc, W + c1 * ldw + c0 + tl.i0, ldw, 1,
                                 S + c1 * lds + tl.j0, lds, 1, nu - c1);
#pragma unroll 1
        for (int e = 0; e < 4; ++e)
#pragma unroll 1
          for (int f = 0; f < 4; ++f) {
            const int i = tl.i0 + e, j = tl.j0 + f;
            if (tile_keeps(tl, i, j, pw, nx + 1, false))
              S[(c0 + i) * lds + j] -= entry(acc, e, f);
          }
      }
      __syncthreads();
      const float* l11 = W + c0 * ldw + c0;
      const float rdl = lane < pw ? l11[lane * ldw + lane] : 0.f;
      for (int g = warp; g < (nx + GV) / GV; g += WARPS) {
        float y[GV];
        float* col = S + (c0 + lane) * lds + g * GV;
        const int nv = nx + 1 - g * GV;
#pragma unroll
        for (int k = 0; k < GV; ++k) y[k] = lane < pw && k < nv ? col[k] : 0.f;
        back(l11, ldw, rdl, y, pw, lane);
#pragma unroll
        for (int k = 0; k < GV; ++k)
          if (lane < pw && k < nv) col[k] = y[k];
      }
      __syncthreads();
      STAMP(ST_SOLVES);
    }

    // 5. the predicted decrease by the last warp: k'h_u + 0.5 k'H_uu k over
    // H_uu's lower triangle, k = -S[:, nx]
    if (warp == WARPS - 1) {
      float part = 0.f;
#pragma unroll 4
      for (int i = 0; i < nu; ++i) {
        const float ki = -S[i * lds + nx];
        const float* hrow = H + (nx + i) * ldn + nx;
        for (int m = lane; m <= i; m += 32) {
          const float km = -S[m * lds + nx];
          part = fmaf((m == i ? 0.5f : 1.0f) * hrow[m] * ki, km, part);
        }
        if ((i & 31) == lane) part = fmaf(ki, H[(nx + i) * ldn + n], part);
      }
      dec -= warp_sum(part);
    }
    // V = H_xx - H_ux' S (lower, mirrored), v_x = h_x - H_ux' S[:, nx]
    for (int ti = tid; ti < tri_count(nx, nx); ti += THREADS) {
      const Tile tl = tri_tile(ti, nx, nx);
      float acc[4][4];
      zero(acc);
      if (tl.tn == 4) {
        tile_mac<4, true, true>(acc, H + nx * ldn + tl.i0, ldn, 1,
                                S + tl.j0, lds, 1, nu);
      } else {
        float col[4][1];
        zero(col);
        tile_mac<1, true, false>(col, H + nx * ldn + tl.i0, ldn, 1, S + nx,
                                 lds, 0, nu);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e][0] = col[e][0];
      }
#pragma unroll 1
      for (int e = 0; e < 4; ++e)
#pragma unroll 1
        for (int f = 0; f < tl.tn; ++f) {
          const int i = tl.i0 + e, j = tl.j0 + f;
          if (!tile_keeps(tl, i, j, nx, nx + 1, true)) continue;
          // h_x sits in H's column n
          const float v = H[i * ldn + (j == nx ? n : j)] - entry(acc, e, f);
          if (j == nx) {
            VX[i] = v;
          } else {
            V[i * ldv + j] = v;
            V[j * ldv + i] = v;
          }
        }
    }
    // the gains -S[:, :nx] and feedforwards -S[:, nx] to device memory
    for (int i = warp; i < nu; i += WARPS)
      for (int j = lane; j <= nx; j += 32) {
        const float g = -S[i * lds + j];
        if (j < nx) gains[t * xu + i * nx + j] = g;
        else ffs[t * nu + i] = g;
      }
    if (L.buffers == 2 && t > 0) cp_async_wait_all();
    __syncthreads();
    STAMP(ST_VALUE);
    if (L.buffers < 2 && t > 0) {
      stage(t - 1, true, 0);
      if (async) cp_async_wait_all();
      __syncthreads();
      STAMP(ST_COPY);
    }
  }
  if (tid == (WARPS - 1) * 32) dec_out[P] = dec;

  // forward rollout: du_t = -(S_t[:, nx] + S_t[:, :nx] dx_t) (or the gains
  // read back), dx_{t+1} = A dx + B du + c; A, B, c staged a step ahead.
  // RG lanes an entry, over the whole block: du_t, a barrier, dx_{t+1}, a
  // barrier (measured faster than one barrier with du_t in every warp)
  for (int i = tid; i < nx; i += THREADS) XF[i] = dx0[i];
  if (L.buffers == 2) stage(0, false, 0);
  // entries (and rows) tid / RG, every THREADS / RG; a warp's lanes run
  // the same iterations, for the shuffles
  const int sub = lane & (RG - 1), first = tid / RG;
  for (int t = 0; t < nt; ++t) {
    const float* cur = XF + (t & 1) * ldv;
    float* nxt = XF + ((t + 1) & 1) * ldv;
    if (L.buffers == 2) {
      cp_async_wait_all();
    } else {
      if (t > 0) __syncthreads();  // the buffer's last step is done
      stage(t, false, 0);
      if (async) cp_async_wait_all();
    }
    __syncthreads();
    if (L.buffers == 2 && t + 1 < nt) stage(t + 1, false, 0);
    const float* Z = zbuf(t) + L.z;
    // du_t from S_t (u = -(s + S x)) or from the gains read back (u = k +
    // K x): the same bits either way.
    auto du_from = [&](const float* kt, int ldk, bool neg) {
      for (int j = first; j - lane / RG < nu; j += THREADS / RG) {
        float part = 0.f;
        if (j < nu) {
          const float* kr = kt + j * ldk;
#pragma unroll 4
          for (int m = sub; m < nx; m += RG)
            part = fmaf(kr[m], cur[m], part);
        }
#pragma unroll
        for (int o = RG / 2; o > 0; o >>= 1)
          part += __shfl_xor_sync(FULL, part, o);
        if (j < nu && sub == 0) {
          const float u = neg ? -(kt[j * ldk + nx] + part)
                              : ffs[t * nu + j] + part;
          UF[j] = u;
          du[t * nu + j] = u;
        }
      }
    };
    if (gsm) du_from(sm + gains_at + t * nu * lds, lds, true);
    else du_from(gains + t * xu, nx, false);
    __syncthreads();
    for (int i = tid; i < nx; i += THREADS) dx[t * nx + i] = cur[i];
    for (int i = first; i - lane / RG < nx; i += THREADS / RG) {
      float part = 0.f;
      if (i < nx) {
        const float* zr = Z + i * ldn;
#pragma unroll 4
        for (int m = sub; m < nx; m += RG) part = fmaf(zr[m], cur[m], part);
#pragma unroll 4
        for (int m = sub; m < nu; m += RG)
          part = fmaf(zr[nx + m], UF[m], part);
      }
#pragma unroll
      for (int o = RG / 2; o > 0; o >>= 1)
        part += __shfl_xor_sync(FULL, part, o);
      if (i < nx && sub == 0) nxt[i] = part + Z[i * ldn + n];
    }
  }
  __syncthreads();
  for (int i = tid; i < nx; i += THREADS)
    dx[T * nx + i] = XF[(nt & 1) * ldv + i];
  STAMP(ST_ROLLOUT);
  STAMP_END;
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
  // the gains stay in shared memory after the rest where all Nt fit
  const long long base = L.buffers * L.stage + (L.work_smem ? L.work : 0);
  const long long slots = static_cast<long long>(nt) * nu * L.lds;
  const bool fit = base + slots <= OPTIN_FLOATS;
  const int gains_at = fit ? static_cast<int>(base) : -1;
  const int smem = fit ? static_cast<int>(4 * (base + slots)) : L.smem_bytes;
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(riccati_sweep_block_kernel<false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           4 * OPTIN_FLOATS),
      cudaFuncSetAttribute(riccati_sweep_block_kernel<true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           4 * OPTIN_FLOATS)};
  if (attr[L.work_smem] != cudaSuccess)
    return static_cast<int>(attr[L.work_smem]);
  auto kernel = L.work_smem ? riccati_sweep_block_kernel<true>
                            : riccati_sweep_block_kernel<false>;
  kernel<<<batch, THREADS, smem > 16 ? smem : 16,
           static_cast<cudaStream_t>(stream)>>>(
      a, b, c, q_xx, q_uu, q_xu, q_x, q_u, qf_xx, qf_x, dx0, reg, dx, du,
      gains, ffs, dec, workspace, nt, nx, nu, L, gains_at);
  return static_cast<int>(cudaGetLastError());
}

#ifdef GPMPC_RICCATI_STAMPS
// The section cycles summed since the last call, and the launches (slot
// 6), into out[8]; then zeroes them.
extern "C" int gpmpc_riccati_block_stamps(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, gpmpc_riccati_stamps,
                                       8 * sizeof(unsigned long long));
  if (e != cudaSuccess) return static_cast<int>(e);
  static const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(
      cudaMemcpyToSymbol(gpmpc_riccati_stamps, zero, sizeof(zero)));
}
#endif

// The layout the kernel takes at (nx, nu), for the wrapper's mirror:
// out = {stage buffers, working set in shared memory (1) or workspace
// (0), floats of a problem's workspace (the working set, and a stage
// buffer where none is shared), dynamic shared memory bytes without the
// gains}.
extern "C" void gpmpc_riccati_block_layout(int nx, int nu, int* out) {
  const BlockLayout L = block_layout(nx, nu);
  out[0] = L.buffers;
  out[1] = L.work_smem;
  out[2] = L.work;
  out[3] = L.smem_bytes;
}
