// Device pieces shared by the whole-QP kernels of this package, included by
// qp_kernel.cu (K1-K4) and qp_kernel_btd.cu (K6/K7): the reductions, the
// matvecs, the Schur build and the column Cholesky / triangular inverse,
// and the ADMM core (twin of sqp_solver_tpu/ops/qp_kernel.py:_admm_core)
// templated on an operator with the JAX core's hooks.
//
// An operator `Op` supplies, each called by every thread of its scope (the
// block, or the warp of K3's warp layout: OpScope below):
//   op.atmv(w, epi)       A' w: epi(j, (A'w)_j) once per column j   (no sync)
//   op.amv(v, epi)        A v:  epi(i, (Av)_i) once per row i        (no sync)
//   op.pmv(v, out)        out = P v                                  (no sync)
//   op.apply_minv(b, out) out = M^-1 b; the caller syncs after it
//   op.factor(rv)         build the factor of M = P + sigma I + A' diag(rv) A,
//                         return the block-uniform fail flag (syncs inside)
// and, where the defaults below do not do, the reduction hooks op_max,
// op_sum and op_cols.
// DenseOp is the dense one (K3's block layout): explicit Minv, A and P as
// matrices.  Every branch that guards a barrier is uniform over the scope.

#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemBytes = 232448;  // per block on sm_90
constexpr int kRedSlots = 8 * 32;      // up to 8 values reduced at once
constexpr float kRhoMin = 1e-6f;
constexpr float kRhoMax = 1e6f;
constexpr float kRhoTol = 1e-4f;
constexpr float kRhoEqFactor = 1e3f;
constexpr float kLooseThresh = 1e16f;

// Phase clocks, off unless compiled with -DADMM_PHASE_CLOCKS (as
// tools/kernel_ab.py and chip_smoke.py build their instrumented copies):
// thread 0 of each block adds the clock64() span of each phase, stamped
// right after the barriers that bound it, to admm_phase_cycles[phase] (a
// begin subtracts the clock, an end adds it; the sums wrap modulo 2^64 to
// the spans).  The ADMM core marks its iteration phases; a factor marks
// its own pieces (Gram, Cholesky, L^-1, L'L for the dense factors; Gram
// and Thomas for the band); K1 and K2 mark BFGS, K2's refinement sweeps
// ("polish"), the loads and stores, and the whole kernel; K3 its loads
// and stores and the whole kernel; the core marks the certificates apart
// from the chunk-end stats; K5 (admm_kernel.cu) marks its load, its
// iterations ("iter") and its stats, and its wide variant also thread 0's
// waits on the ring of W ("ring"), its dot products ("dot") and the
// update with the cluster's exchange ("exchange"), summed over the
// iterations (phase_add).  The Anderson step (aa_chunk_end) marks its
// parts apart from the chunk-end stats: the ring's update ("aaring"), the
// dot products' reductions ("aadot"), the k x k solve ("aasolve"), the
// candidate with its stats ("aacand") and the revert ("aarevert").
#ifdef ADMM_PHASE_CLOCKS
enum AdmmPhase {
  kPhGram, kPhThomas, kPhAtmv, kPhSweep, kPhAmv, kPhStats, kPhTotal,
  kPhChol, kPhLinv, kPhLtl, kPhBfgs, kPhPolish, kPhLoad, kPhCert, kPhIter,
  kPhRing, kPhDot, kPhExchange, kPhAaRing, kPhAaDot, kPhAaSolve, kPhAaCand, kPhAaRevert,
  kNumPhases
};
// The sums are spread over kPhaseSlots copies (by block), so that the
// stamps of thousands of blocks do not queue on one address.
constexpr int kPhaseSlots = 128;
__device__ unsigned long long admm_phase_cycles[kPhaseSlots][kNumPhases];
__device__ __forceinline__ void phase_stamp(int p, bool begin) {
  if (threadIdx.x == 0) {
    const unsigned long long t = (unsigned long long)clock64();
    atomicAdd(&admm_phase_cycles[blockIdx.x % kPhaseSlots][p], begin ? 0ull - t : t);
  }
}
// adds cycles summed elsewhere by thread 0 to phase p
__device__ __forceinline__ void phase_add(int p, unsigned long long cycles) {
  if (threadIdx.x == 0) atomicAdd(&admm_phase_cycles[blockIdx.x % kPhaseSlots][p], cycles);
}
#define ADMM_PHASE_BEGIN(p) phase_stamp(p, true)
#define ADMM_PHASE_END(p) phase_stamp(p, false)
#else
#define ADMM_PHASE_BEGIN(p) ((void)0)
#define ADMM_PHASE_END(p) ((void)0)
#endif

// max that propagates NaN like jnp.maximum / torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

// min that propagates NaN like jnp.minimum / torch.minimum
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}

// clip that propagates NaN like jnp.clip
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ---- asynchronous copies and row strides (K3's warp layout, K5) ----
// cp.async puts a copy from device to shared memory in flight without
// holding a register; a thread's copies complete at cp_async_wait_all, and
// the caller's barrier then makes them visible to the other threads.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Put rows x cols floats of src (row stride cols) in flight to dst (row
// stride ldd, dst 16-byte aligned): rows over the groups of 32 threads
// [0, groups), columns over lanes; 16 bytes a copy where every source and
// destination row is 16-byte aligned (cols and ldd multiples of 4, src
// aligned), 4 bytes otherwise (a problem's operand at b n m floats is not,
// for odd n m).
__device__ __forceinline__ void copy_rows_async(float* dst, int ldd, const float* src, int rows,
                                                int cols, int group, int groups, int lane) {
  if ((cols & 3) == 0 && (ldd & 3) == 0 && ((uintptr_t)src & 15) == 0) {
    const int c4 = cols >> 2;
    for (int i = group; i < rows; i += groups)
      for (int k = lane; k < c4; k += 32)
        cp_async16(dst + i * ldd + 4 * k, src + (size_t)i * cols + 4 * k);
  } else {
    for (int i = group; i < rows; i += groups)
      for (int j = lane; j < cols; j += 32) cp_async4(dst + i * ldd + j, src + (size_t)i * cols + j);
  }
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }
__host__ __device__ constexpr int round32(int v) { return (v + 31) & ~31; }
// A row stride of 4 x odd floats: a warp's 16-byte reads of rows i..i+7 at
// one column (one quarter-warp phase) fall on eight disjoint bank groups.
__host__ __device__ constexpr int stride4(int cols) {
  return (round4(cols) & 7) ? round4(cols) : round4(cols) + 4;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- sync scopes ---------------------------------------------------------
// The pieces below run on a scope of threads that shares one problem: the
// whole block (K1, K3's block layout, K4, K6, K7) or one warp (K3's warp
// layout, several problems a block).  rank() and size() index the scope's
// threads; sync() is its barrier.  An operator names its scope through
// OpScope (the block unless specialised).
struct BlockScope {
  __device__ static __forceinline__ int rank() { return threadIdx.x; }
  __device__ static __forceinline__ int size() { return blockDim.x; }
  __device__ static __forceinline__ void sync() { __syncthreads(); }
};
struct WarpScope {
  __device__ static __forceinline__ int rank() { return threadIdx.x & 31; }
  __device__ static __forceinline__ int size() { return 32; }
  __device__ static __forceinline__ void sync() { __syncwarp(); }
};
template <class Op>
struct OpScope {
  using type = BlockScope;
};

// Block-wide reductions of K values at once.  Every thread returns the same
// result (the partials are summed in the same order by every thread).
template <int K>
__device__ void block_sum(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
  __syncthreads();  // the previous reduction's readers are done with red
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * 32 + w] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float r = 0.f;
    for (int i = 0; i < nw; ++i) r += red[k * 32 + i];
    v[k] = r;
  }
}

template <int K>
__device__ void block_max(float (&v)[K], float* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int o = 16; o > 0; o >>= 1) v[k] = nan_max(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * 32 + w] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float r = red[k * 32];
    for (int i = 1; i < nw; ++i) r = nan_max(r, red[k * 32 + i]);
    v[k] = r;
  }
}

// y = M x for M (rows x cols, row stride ld); one thread per row.  No sync.
__device__ __forceinline__ void mv(const float* M, int ld, int rows, int cols,
                                   const float* x, float* y) {
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const float* r = M + (size_t)i * ld;
    float acc = 0.f;
    for (int j = 0; j < cols; ++j) acc = fmaf(r[j], x[j], acc);
    y[i] = acc;
  }
}

// y = M' x for M (rows x cols, row stride ld); one thread per column.  No sync.
__device__ __forceinline__ void mtv(const float* M, int ld, int rows, int cols,
                                    const float* x, float* y) {
  for (int j = threadIdx.x; j < cols; j += blockDim.x) {
    float acc = 0.f;
    for (int i = 0; i < rows; ++i) acc = fmaf(M[(size_t)i * ld + j], x[i], acc);
    y[j] = acc;
  }
}

// W (lower triangle) = P + sigma I + A' diag(w) A.  Twin of _factor_schur_refs.
__device__ void schur_build(float* W, int ldw, const float* P, int ldp, const float* A,
                            int lda, const float* w, float sigma, int n, int m) {
  ADMM_PHASE_BEGIN(kPhGram);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    if (j > i) continue;
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc = fmaf(A[k * lda + i] * w[k], A[k * lda + j], acc);
    W[i * ldw + j] = P[(size_t)i * ldp + j] + (i == j ? sigma : 0.f) + acc;
  }
  __syncthreads();
  ADMM_PHASE_END(kPhGram);
}

// In-place lower Cholesky of W by columns (right-looking).  A pivot d <= 0
// or NaN sets the returned fail flag and is clamped to max(d, 1e-30), as
// in _chol_inv_ltl.  Block-uniform result.
__device__ bool cholesky_inplace(float* W, int ld, int n) {
  ADMM_PHASE_BEGIN(kPhChol);
  bool fail = false;
  for (int j = 0; j < n; ++j) {
    const float d = W[j * ld + j];
    fail = fail || (d <= 0.f) || isnan(d);
    const float dc = nan_max(d, 1e-30f);
    const float rs = rsqrtf(dc);
    __syncthreads();  // every thread has read the pivot
    for (int i = j + 1 + threadIdx.x; i < n; i += blockDim.x) W[i * ld + j] *= rs;
    if (threadIdx.x == 0) W[j * ld + j] = sqrtf(dc);
    __syncthreads();
    const int r = n - j - 1;
    for (int e = threadIdx.x; e < r * r; e += blockDim.x) {
      const int a = e / r, b = e - a * r;
      if (b > a) continue;
      const int i = j + 1 + a, k = j + 1 + b;
      W[i * ld + k] = fmaf(-W[i * ld + j], W[k * ld + j], W[i * ld + k]);
    }
    __syncthreads();
  }
  ADMM_PHASE_END(kPhChol);
  return fail;
}

// Li = L^-1 for the lower-triangular L held in the lower triangle of Lm:
// one thread per column, forward substitution, dividing by max(L_ii, 1e-30).
__device__ void tri_inv(const float* Lm, int ldl, float* Li, int ldi, int n) {
  ADMM_PHASE_BEGIN(kPhLinv);
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    for (int i = 0; i < c; ++i) Li[i * ldi + c] = 0.f;
    for (int i = c; i < n; ++i) {
      float acc = 0.f;
      for (int k = c; k < i; ++k) acc = fmaf(Lm[i * ldl + k], Li[k * ldi + c], acc);
      Li[i * ldi + c] = ((i == c ? 1.f : 0.f) - acc) / nan_max(Lm[i * ldl + i], 1e-30f);
    }
  }
  __syncthreads();
  ADMM_PHASE_END(kPhLinv);
}

// W = Li' Li (full symmetric): W[i][j] = sum_{k >= max(i,j)} Li[k][i] Li[k][j].
__device__ void ltl(const float* Li, int ldi, float* W, int ldw, int n) {
  ADMM_PHASE_BEGIN(kPhLtl);
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) {
    const int i = e / n, j = e - i * n;
    float acc = 0.f;
    for (int k = max(i, j); k < n; ++k) acc = fmaf(Li[k * ldi + i], Li[k * ldi + j], acc);
    W[i * ldw + j] = acc;
  }
  __syncthreads();
  ADMM_PHASE_END(kPhLtl);
}

// Minv (in W) of M = P + sigma I + A' diag(w) A; Li is scratch.  Returns fail.
__device__ bool factor_minv(float* W, float* Li, int ldm, const float* P, int ldp,
                            const float* A, const float* w, float sigma, int n, int m) {
  schur_build(W, ldm, P, ldp, A, ldm, w, sigma, n, m);
  const bool fail = cholesky_inplace(W, ldm, n);
  tri_inv(W, ldm, Li, ldm, n);
  ltl(Li, ldm, W, ldm, n);
  return fail;
}

// per-row rho from the scalar rho and the row classes (twin of _rho_from)
template <class S = BlockScope>
__device__ void set_rho_vec(float* rv, const float* l, const float* u, float rho, int m) {
  for (int i = S::rank(); i < m; i += S::size()) {
    const bool loose = (l[i] < -kLooseThresh) && (u[i] > kLooseThresh);
    const bool eq = (u[i] - l[i]) < kRhoTol;
    rv[i] = loose ? kRhoMin : (eq ? kRhoEqFactor * rho : rho);
  }
  S::sync();
}

// Reduction hooks of an operator, called by admm_stats and certificate:
// the defaults reduce over the block.  An operator whose problem spans a
// cluster of blocks overloads them (and op_cols) to combine the blocks'
// partials, so that every block of the cluster gets the same result.
template <class Op, int K>
__device__ __forceinline__ void op_max(const Op&, float (&v)[K], float* red) {
  block_max(v, red);
}
template <class Op, int K>
__device__ __forceinline__ void op_sum(const Op&, float (&v)[K], float* red) {
  block_sum(v, red);
}
// The columns [j0, j1) of the n-vectors whose terms this block adds to a
// certificate's sums and maxima (the default all).
template <class Op>
__device__ __forceinline__ void op_cols(const Op&, int n, int& j0, int& j1) {
  j0 = 0;
  j1 = n;
}

// The state an operator carries from call to call (BandOp's exchange
// count): the Anderson step takes the operator by value and hands the
// state back through these.
template <class Op>
__device__ __forceinline__ int op_state(const Op&) {
  return 0;
}
template <class Op>
__device__ __forceinline__ void op_set_state(const Op&, int) {}

// The phase marks around an epoch's refactor in admm_solve: an operator
// whose factor splits at a Gram / Thomas boundary marks that boundary
// itself (BandOp); one whose factor pieces mark themselves (the dense
// operators) overloads this to mark nothing.
template <class Op>
__device__ __forceinline__ void op_factor_mark(const Op&, bool begin) {
  if (begin) ADMM_PHASE_BEGIN(kPhGram);
  else ADMM_PHASE_END(kPhThomas);
}

struct StepParams {
  int n, m;
  float sigma, alpha, rho0, eps_abs, eps_rel;
  int n_epochs, chunks_per_epoch, seg, adaptive_rho;
  float adaptive_rho_tolerance;
  int do_bfgs;
  int check_infeas;      // infeasibility certificates at every chunk's end
  float eps_pinf, eps_dinf;
  int n_smem_mats;       // leading matrices [W, A, Li] held in shared memory
  long long ws_floats;   // per-problem workspace for the others
};

// The Anderson instantiations' extra kernel argument (the kernels without
// Anderson keep their parameters as they were): the memory k (pairs kept),
// the workspace of aa_floats(k, n, m) floats a scope, and where each
// scope's shared-memory area (its Gram, aa_gram_floats, unless gram_ws;
// then its ring where ring_sm) starts in the block's dynamic shared memory:
// at sm_off floats, sm_stride floats a scope (a block of several
// problems).  What shared memory does not hold is in the scope's slice of
// the workspace (aa_state).
struct AaArgs {
  int k;
  float* ws;
  long long sm_off;
  int sm_stride;
  int ring_sm;
  int gram_ws;  // the Gram area at the head of the workspace slice (k > kAaGramSmemMemory)
};

// The second argument of the Anderson kernels whose step solves off the
// Gram area (the _aas instantiations of K1, K3, K6 and K7; the others keep
// AaArgs alone, as they were): where the chunk's system goes (AaSolve,
// aa_sys), a solve area at sys_off floats of the block's shared memory,
// sys_stride floats a scope (the area a scope) or one area the scopes take
// in turn, or a slice of sys_ws (the workspace after the scopes' slices).
struct AaSysArgs {
  int solve;
  long long sys_off;
  int sys_stride;
  float* sys_ws;
};

// Matrix placement: the first n_smem of the sizes go to shared memory after
// the vectors, the rest to this problem's slice of the workspace.
template <int K>
__device__ void place(float* (&ptr)[K], const int (&size)[K], float* smem_mats, int n_smem,
                      float* ws, long long ws_floats) {
  float* s = smem_mats;
  float* g = ws ? ws + (size_t)blockIdx.x * ws_floats : nullptr;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (k < n_smem) { ptr[k] = s; s += size[k]; }
    else { ptr[k] = g; g += size[k]; }
  }
}

struct AdmmState {
  bool done, fail, pending;
  int itc, rho_upd, nfact;
  int infs;  // certificate: 0 none, 1 primal infeasible, 2 dual infeasible
  float rho, rho_est, rp, rd, mz, mq;
};

// One ADMM iteration in place on (x, z, y).  bt, xt, tm are scratch.
template <class Op>
__device__ void admm_iter(const Op& op, const float* q, const float* l, const float* u,
                          const float* rv, float* x, float* z, float* y, float* bt, float* xt,
                          float* tm, float sigma, float alpha, int n, int m) {
  using S = typename OpScope<Op>::type;
  ADMM_PHASE_BEGIN(kPhAtmv);
  for (int i = S::rank(); i < m; i += S::size()) tm[i] = rv[i] * z[i] - y[i];
  S::sync();
  op.atmv(tm, [&](int j, float acc) { bt[j] = sigma * x[j] - q[j] + acc; });
  S::sync();
  ADMM_PHASE_END(kPhAtmv);
  ADMM_PHASE_BEGIN(kPhSweep);
  op.apply_minv(bt, xt);
  S::sync();
  ADMM_PHASE_END(kPhSweep);
  ADMM_PHASE_BEGIN(kPhAmv);
  op.amv(xt, [&](int i, float zt) {
    const float z_pre = alpha * zt + (1.f - alpha) * z[i];
    const float zn = clip(z_pre + (1.f / rv[i]) * y[i], l[i], u[i]);
    y[i] = y[i] + rv[i] * (z_pre - zn);
    z[i] = zn;
  });
  for (int j = S::rank(); j < n; j += S::size()) x[j] = alpha * xt[j] + (1.f - alpha) * x[j];
  S::sync();
  ADMM_PHASE_END(kPhAmv);
}

// Termination residuals: rp = |Ax - z|, rd = |Px + q + A'y|, and their
// relative scales (linf norms), as _admm_core's stats().
template <class Op>
__device__ void admm_stats(const Op& op, const float* q, const float* x, const float* z,
                           const float* y, float* tm, float* tn1, float* tn2, float* red, int n,
                           int m, AdmmState& st) {
  using S = typename OpScope<Op>::type;
  op.amv(x, [&](int i, float acc) { tm[i] = acc; });
  op.pmv(x, tn1);
  op.atmv(y, [&](int j, float acc) { tn2[j] = acc; });
  S::sync();
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = S::rank(); i < m; i += S::size()) {
    v[0] = nan_max(v[0], fabsf(tm[i] - z[i]));
    v[1] = nan_max(v[1], fabsf(tm[i]));
    v[2] = nan_max(v[2], fabsf(z[i]));
  }
  for (int j = S::rank(); j < n; j += S::size()) {
    v[3] = nan_max(v[3], fabsf(tn1[j] + q[j] + tn2[j]));
    v[4] = nan_max(v[4], fabsf(tn1[j]));
    v[5] = nan_max(v[5], fabsf(tn2[j]));
    v[6] = nan_max(v[6], fabsf(q[j]));
  }
  op_max(op, v, red);
  st.rp = v[0];
  st.mz = nan_max(v[1], v[2]);
  st.rd = v[3];
  st.mq = nan_max(v[4], nan_max(v[5], v[6]));
}

// Infeasibility certificate (OSQP section 3.4, twin of _admm_core's
// certificates) from the chunk's deltas, which the caller has left in
// dx (n) and dy (m).  tn1, tn2 (n) and tm (m) are scratch.  Returns the
// block-uniform code 0 none, 1 primal infeasible, 2 dual infeasible.
template <class Op>
__device__ int certificate(const StepParams& p, const Op& op, const float* q, const float* l,
                           const float* u, const float* dx, const float* dy, float* tn1,
                           float* tn2, float* tm, float* red) {
  using S = typename OpScope<Op>::type;
  const int n = p.n, m = p.m;
  op.atmv(dy, [&](int j, float acc) { tn1[j] = acc; });  // A' dy
  op.pmv(dx, tn2);                                        // P dx
  op.amv(dx, [&](int i, float acc) { tm[i] = acc; });    // A dx
  S::sync();
  float mx[6] = {0.f, 0.f, 0.f, 0.f, -INFINITY, -INFINITY};
  float sm[2] = {0.f, 0.f};
  for (int i = S::rank(); i < m; i += S::size()) {
    const bool lo_l = l[i] < -kLooseThresh, lo_u = u[i] > kLooseThresh;
    const float l_eff = lo_l ? -1e20f : l[i], u_eff = lo_u ? 1e20f : u[i];
    mx[0] = nan_max(mx[0], fabsf(dy[i]));
    sm[0] += u_eff * nan_max(dy[i], 0.f) + l_eff * nan_min(dy[i], 0.f);
    if (!lo_u) mx[4] = nan_max(mx[4], tm[i]);
    if (!lo_l) mx[5] = nan_max(mx[5], -tm[i]);
  }
  int j0, j1;
  op_cols(op, n, j0, j1);
  for (int j = j0 + S::rank(); j < j1; j += S::size()) {
    mx[1] = nan_max(mx[1], fabsf(tn1[j]));
    mx[2] = nan_max(mx[2], fabsf(dx[j]));
    mx[3] = nan_max(mx[3], fabsf(tn2[j]));
    sm[1] = fmaf(q[j], dx[j], sm[1]);
  }
  op_max(op, mx, red);
  op_sum(op, sm, red);
  const float norm_dy = mx[0], norm_dx = mx[2], tol = p.eps_dinf * norm_dx;
  const bool prim = (norm_dy > 0.f) && (mx[1] <= p.eps_pinf * norm_dy) &&
                    (sm[0] <= -p.eps_pinf * norm_dy);
  const bool dual = (norm_dx > 0.f) && (mx[3] <= p.eps_dinf * norm_dx) &&
                    (sm[1] <= -p.eps_dinf * norm_dx) && (mx[4] <= tol) && (mx[5] <= tol);
  return prim ? 1 : (dual ? 2 : 0);
}

// ---- Anderson acceleration (twin of _admm_core's aa_step) ---------------
// Safeguarded type-II Anderson on the chunk map of one scope's iterate,
// packed as u = (x, z, y), D = n + 2 m entries (m the scope's rows: a
// block of a K6/K7 cluster holds all of x and its own rows of z and y).
// The state of one scope, read and written once a chunk, after the
// chunk's seg iterations:
//   the Gram area (aa_gram_floats(k) floats), in shared memory at every
//   k <= kAaGramSmemMemory, past it where the launcher's rule puts it
//   (the kernels' aa_*_placement), else at the head of the scope's slice
//   of the device workspace (AaArgs::gram_ws):
//     Gk     k x k: the Gram of the pairs' dF by ring slot, kept from chunk
//            to chunk: a chunk computes only the row of the pair it pushes
//            (a pair's dot products do not change while it is held; a rho
//            change empties the ring and with it the kept entries)
//     Ga     k x (k + 1): the chunk's normal equations [G + reg | rhs] in
//            the ring's logical order, solved in place (aa_solve); past
//            kAaGramSmemMemory every kernel puts Ga where
//            AaSysArgs::solve says (AaSolve, aa_sys, aa_solve_sys)
//   the ring (aa_ring_floats(k, n, m) floats), in shared memory after the
//   Gram area where the launcher's rule puts it (only where the Gram is
//   there too), else in the scope's slice of the device workspace, after
//   the Gram area where that is there too:
//     dU, dF k x D each: the difference pairs, a ring whose slot head holds
//            the oldest pair (logical index i sits in slot head + i mod k,
//            so the newest pairs are at the end, as on the TPU)
//     uT, f  D each: the previous chunk's output and its step u_T - u_in
//     u0, ua D each: the chunk-start iterate, the plain output while the
//            candidate is evaluated
// The ring's indices (AaRing) are the same in every thread of the scope:
// each thread keeps them in registers and updates them alike.
// Any memory k >= 1: the step walks the pairs kAaSlots at a time and the
// solve (aa_solve) puts rows on the lanes of one warp in rounds of 32.
constexpr int kAaGroup = kRedSlots / 32;  // dot products reduced at once
constexpr int kAaSlots = kAaGroup / 2;    // pairs a group: their Gram entry and rhs
// Up to this memory every launch keeps the Gram area in shared memory (the
// kernels' bound on k before the area could leave it: 2,080 floats at 32).
// Past it, a Gram area in the workspace made aa_solve's k pivots each wait
// on device memory, and one on chip each wait on a lane's chain (PERF.md),
// so there every kernel solves off the Gram area.
constexpr int kAaGramSmemMemory = 32;

__host__ __device__ constexpr int aa_gram_floats(int k) { return round4(k * k + k * (k + 1)); }
__host__ __device__ constexpr long long aa_ring_floats(int k, int n, int m) {
  return (2LL * k + 4) * (n + 2LL * m);
}
// A scope's workspace slice: the ring, after the Gram area where that is not
// in shared memory (the slice has room for both either way).  The launches
// whose system goes to the workspace (kAaSolveWorkspace) put it after the
// slices, aa_solve_floats a scope (admm_aa_floats below counts it in each
// scope's share of the allocation).
__host__ __device__ constexpr long long aa_floats(int k, int n, int m) {
  return aa_gram_floats(k) + aa_ring_floats(k, n, m);
}

// Where the chunk's system Ga goes (AaSysArgs::solve; the rules
// qp_kernel.cu:aa_dense_plan, qp_kernel_btd.cu:btd_aa_plan and
// qp_kernel_btd_wide.cu:wide_aa_plan pick past kAaGramSmemMemory):
//   kAaSolveGram       beside Gk in the Gram area (every launch up to
//                      kAaGramSmemMemory)
//   kAaSolveScope      a solve area of aa_solve_floats(k) floats a scope in
//                      shared memory
//   kAaSolveBlock      one solve area a block, after its lock word, which
//                      the block's scopes take in turn (K3's warp layout)
//   kAaSolveWorkspace  a slice of AaSysArgs::sys_ws in device memory
// On the last three K1's and K3's Gk stays in the workspace (a chunk reads
// it once); the structured kernels' stays on chip where that costs nothing.
enum AaSolve { kAaSolveGram = 0, kAaSolveScope = 1, kAaSolveBlock = 2, kAaSolveWorkspace = 3 };

// A solve area holds the system by columns: column c (c = k the right-hand
// side, gamma after the solve) at c * aa_solve_ldc(k), its k rows padded to
// a multiple of 8.  The stride is 4 x an odd number, so that the 16-byte
// reads of eight lanes at one row fall on eight distinct bank groups.
__host__ __device__ constexpr int aa_solve_ldc(int k) { return ((k + 7) & ~7) + 4; }
__host__ __device__ constexpr int aa_solve_floats(int k) { return aa_solve_ldc(k) * (k + 1); }
// floats before a block's solve areas: the lock word of kAaSolveBlock, and
// the room to put the areas at a multiple of 4 floats
constexpr int kAaSolveHead = 4;

// Blocks an SM that shared memory allows at smem_bytes a block on sm_90
// (228 KB an SM, 1 KB reserved a block): the placement rules keep the ring
// (and past kAaGramSmemMemory the Gram area) off chip where it would lower
// this below the kernel without Anderson.
constexpr long long kAaSmemPerSm = 233472;
constexpr long long kAaSmemReserved = 1024;
__host__ __device__ constexpr int smem_blocks_per_sm(long long smem_bytes) {
  return (int)(kAaSmemPerSm / (smem_bytes + kAaSmemReserved));
}

// One scope's Anderson state: the ring and the Gram area, each in shared
// memory or the workspace.
struct AaState {
  float* ring;
  float* gram;
  int k;
};

// The state of scope `scope` of this block (K3's warp layout: its warp)
// from the launch's AaArgs; smem is the block's dynamic shared memory,
// slice the scope's slice of the workspace and m the rows it is sized for.
__device__ __forceinline__ AaState aa_state(const AaArgs& a, float* smem, int scope, size_t slice,
                                            int n, int m) {
  float* w = a.ws + slice * aa_floats(a.k, n, m);
  float* g = a.gram_ws ? w : smem + a.sm_off + (size_t)scope * a.sm_stride;
  float* r = a.ring_sm ? g + aa_gram_floats(a.k) : w + (a.gram_ws ? aa_gram_floats(a.k) : 0);
  return AaState{r, g, a.k};
}

// The chunk's system of a scope that solves off the Gram area (AaSysArgs::
// solve past kAaSolveGram): Ga by columns (aa_solve_ldc), and the right-hand
// side (gamma after the solve) of logical pair a at gv[a]: Ga's last column
// where the scope owns Ga, else the head of the scope's slice of sys_ws (a
// block's solve area is the scope's only for its turn); lock: the block's
// area's lock word, or null.
struct AaSys {
  float* ga;
  float* gv;
  int* lock;
};

__device__ __forceinline__ AaSys aa_sys(const AaSysArgs& a, int k, float* smem, int scope,
                                        size_t slice) {
  float* room = a.sys_ws + slice * aa_solve_floats(k);
  const size_t last = (size_t)k * aa_solve_ldc(k);
  if (a.solve == kAaSolveScope) {
    float* ga = smem + a.sys_off + (size_t)scope * a.sys_stride;
    return AaSys{ga, ga + last, nullptr};
  }
  if (a.solve == kAaSolveBlock)
    return AaSys{smem + a.sys_off, room, reinterpret_cast<int*>(smem + a.sys_off - 1)};
  return AaSys{room, room + last, nullptr};
}

// prev_ok: the previous chunk's output is in uT and f; pairs: the pairs
// held; head: the slot of the oldest.  {0, 0, 0} at every kernel entry; a
// pending rho empties the ring (prev_ok = pairs = 0: the chunk map changes
// with rho, so stale pairs would extrapolate through another fixed point).
struct AaRing {
  int prev_ok, pairs, head;
};

// The chunk-start iterate into u0, by the threads (and entries) that read
// it back in aa_chunk_end.
template <class S>
__device__ __forceinline__ void aa_begin(float* aa, int k, int n, int m, const float* x,
                                         const float* z, const float* y) {
  const int D = n + 2 * m;
  float* u0 = aa + (2 * k + 2) * D;
#pragma unroll 1
  for (int e = S::rank(); e < D; e += S::size())
    u0[e] = e < n ? x[e] : (e < n + m ? z[e - n] : y[e - n - m]);
}

// The slot of the logical index after the one in slot s (s < k).
__device__ __forceinline__ int aa_next(int s, int k) { return s + 1 == k ? 0 : s + 1; }

// The normal equations of a chunk, by one warp (lane: its lane): Ga gets
// the kept Gram Gk in the logical order (slot s_lo holds logical index
// lo), the Levenberg term 1e-8 (trace G + 1) on the diagonal and 1 on the
// unused rows (whose right-hand side is 0, so their gamma is 0), then
// Gauss-Jordan on [G | rhs] with a row a lane.  The pivot row i is scaled
// after the other rows' updates, which each lane computes from row i times
// 1 / G_ii as the serial elimination stores it, so that every value has
// the bits of the serial loop (the JAX kernel's statically unrolled
// elimination, qp/anderson.py:gauss_jordan).  The valid rows' right-hand
// side is in Ga's last column on entry; gamma is there on exit.
__device__ __noinline__ void aa_solve(const float* Gk, float* Ga, int k, int lo, int s_lo,
                                      int lane) {
  const int k1 = k + 1;
  float tr = 0.f;
  for (int a = lo, s = s_lo; a < k; ++a, s = aa_next(s, k)) tr += Gk[s * k + s];
  const float reg = 1e-8f * (tr + 1.f);
  for (int r = lane; r < k; r += 32) {
    float* row = Ga + r * k1;
    int sr = s_lo + r - lo;
    sr = sr >= k ? sr - k : sr;
    for (int b = 0, sb = s_lo; b < k; ++b) {
      float g = 0.f;
      if (r >= lo && b >= lo) {
        g = Gk[sr * k + sb];
        sb = aa_next(sb, k);
      }
      if (b == r) g += reg + (r < lo ? 1.f : 0.f);
      row[b] = g;
    }
    if (r < lo) row[k] = 0.f;
  }
  __syncwarp();
  for (int i = 0; i < k; ++i) {
    const float* pr = Ga + i * k1;
    const float inv = 1.f / pr[i];
    for (int r = lane; r < k; r += 32) {
      if (r == i) continue;
      float* row = Ga + r * k1;
      const float fac = row[i];
      for (int b = 0; b < k1; ++b) row[b] = fmaf(-fac, pr[b] * inv, row[b]);
    }
    __syncwarp();  // every lane has read row i
    for (int b = lane; b < k1; b += 32) Ga[i * k1 + b] *= inv;
    __syncwarp();
  }
}

// The same normal equations and elimination, every value of gamma with the
// same bits, on a system off the Gram area (AaSys; Gk in the workspace), by
// every thread of the scope S.  The system is stored by columns (column k
// the right-hand side, gamma after the solve), each of k8 rows (k padded
// to 8) and 4 spare floats.  At pivot i the live columns are i + 1, ..., k
// (a column pivoted already is dead: no later pivot reads it as a factor
// or a pivot entry, and gamma is column k, so it is left as it is).  Each
// live column's pivot entry is scaled first, G_ic * (1 / G_ii) as the
// serial order of aa_solve stores it, into the column's row k8 (spare);
// after a sync the work is items of 8 rows of one live column, spread over
// the scope's threads, two at a time with their loads in flight before
// their stores: an item reads its rows of column i (the factor, the same
// for every column: a broadcast), of its own column and the scaled entry,
// writes its rows with G_rc - G_ri (G_ic / G_ii), the product the serial
// order uses, and row i with the scaled entry (the pivot row); then a sync.
// No item reads what another writes in that pivot.  (Rows on the lanes,
// aa_solve, read 4 bytes a line an instruction and chain a lane's k + 1
// updates a row: in device memory the solve waited on L2's bandwidth, in
// shared memory on those chains; a column a lane chained k / 8 reads a
// column.)  The fill reads Gk by rows (it is symmetric: both entries of a
// pair hold the one dot product).  A block's solve area is taken under its
// lock, and gamma copied to the scope's vector before the lock is let go.
template <class S>
__device__ __noinline__ void aa_solve_sys(const float* Gk, AaSys sys, int k, int lo, int s_lo) {
  constexpr int T = 8;  // the trace's loads at once
  const int rank = S::rank(), size = S::size();
  const int k1 = k + 1, ldc = aa_solve_ldc(k), k8 = (k + 7) & ~7, nch = k8 / 8;
  float* Ga = sys.ga;
  if (sys.lock) {  // the block's area, in turn with its other scopes
    if (rank == 0) {
      while (atomicCAS(sys.lock, 0, 1) != 0) __nanosleep(64);
      __threadfence_block();
    }
    S::sync();
  }
  auto slot = [&](int a) { return s_lo + a - lo >= k ? s_lo + a - lo - k : s_lo + a - lo; };
  float tr = 0.f;
#pragma unroll 1
  for (int a0 = lo; a0 < k; a0 += T) {
    float d[T];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int s = slot(min(a0 + j, k - 1));
      d[j] = Gk[s * k + s];
    }
#pragma unroll
    for (int j = 0; j < T; ++j)
      if (a0 + j < k) tr += d[j];
  }
  const float reg = 1e-8f * (tr + 1.f);
  // column c of G is row c of Gk at the rows' slots, 16 rows' loads in
  // flight at once; column k the right-hand side
#pragma unroll 1
  for (int c = rank; c < k1; c += size) {
    float* col = Ga + (size_t)c * ldc;
    const float* gc = c == k ? sys.gv : Gk + (c >= lo ? slot(c) : 0) * k;
    const bool live = c >= lo;
#pragma unroll 1
    for (int r0 = 0; r0 < k8; r0 += 16) {
      float g[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int r = r0 + j;
        g[j] = live && r >= lo && r < k ? gc[c == k ? r : slot(r)] : 0.f;
        if (r == c) g[j] += reg + (r < lo ? 1.f : 0.f);
      }
#pragma unroll
      for (int j = 0; j < 16; j += 4)
        if (r0 + j < k8)
          *reinterpret_cast<float4*>(col + r0 + j) = make_float4(g[j], g[j + 1], g[j + 2], g[j + 3]);
    }
  }
  S::sync();
  // this thread's first item at every pivot: column i + 1 + c0, rows 8 ch0 on
  const int c0 = rank / nch, ch0 = rank - c0 * nch, dc = size / nch, dch = size - dc * nch;
#pragma unroll 1
  for (int i = 0; i < k; ++i) {
    const float* fc = Ga + (size_t)i * ldc;  // the factor column
    const float inv = 1.f / fc[i];
    // each live column's pivot entry G_ic * 1 / G_ii into its row k8 (padding)
    for (int c = i + 1 + rank; c < k1; c += size) {
      float* col = Ga + (size_t)c * ldc;
      col[k8] = col[i] * inv;
    }
    S::sync();
    const int items = (k - i) * nch, ci = i >> 3;
    int c = i + 1 + c0, ch = ch0;
#pragma unroll 1
    for (int q = rank; q < items; q += 2 * size) {
      // this item and this thread's next one (c2, ch2), where there is one
      int c2 = c + dc, ch2 = ch + dch;
      if (ch2 >= nch) {
        ch2 -= nch;
        ++c2;
      }
      const bool two = q + size < items;
      if (!two) c2 = c;
      float* v = Ga + (size_t)c * ldc;
      float* v2 = Ga + (size_t)c2 * ldc;
      const float4* f = reinterpret_cast<const float4*>(fc + 8 * ch);
      const float4* f2 = reinterpret_cast<const float4*>(fc + 8 * ch2);
      float4* w = reinterpret_cast<float4*>(v + 8 * ch);
      float4* w2 = reinterpret_cast<float4*>(v2 + 8 * ch2);
      const float p = v[k8], p2 = v2[k8];
      const float4 A0 = f[0], A1 = f[1], V0 = w[0], V1 = w[1];
      const float4 B0 = f2[0], B1 = f2[1], W0 = w2[0], W1 = w2[1];
      w[0] = make_float4(fmaf(-A0.x, p, V0.x), fmaf(-A0.y, p, V0.y), fmaf(-A0.z, p, V0.z),
                         fmaf(-A0.w, p, V0.w));
      w[1] = make_float4(fmaf(-A1.x, p, V1.x), fmaf(-A1.y, p, V1.y), fmaf(-A1.z, p, V1.z),
                         fmaf(-A1.w, p, V1.w));
      if (ch == ci) v[i] = p;  // the pivot row: its entry scaled
      if (two) {
        w2[0] = make_float4(fmaf(-B0.x, p2, W0.x), fmaf(-B0.y, p2, W0.y),
                            fmaf(-B0.z, p2, W0.z), fmaf(-B0.w, p2, W0.w));
        w2[1] = make_float4(fmaf(-B1.x, p2, W1.x), fmaf(-B1.y, p2, W1.y),
                            fmaf(-B1.z, p2, W1.z), fmaf(-B1.w, p2, W1.w));
        if (ch2 == ci) v2[i] = p2;
      }
      c = c2 + dc;  // the item after those two
      ch = ch2 + dch;
      if (ch >= nch) {
        ch -= nch;
        ++c;
      }
    }
    S::sync();  // pivot i's columns, and column i + 1, to the scope
  }
  const float* gamma = Ga + (size_t)k * ldc;
  if (sys.gv != gamma) {
    for (int r = rank; r < k; r += size) sys.gv[r] = gamma[r];
    S::sync();
  }
  if (sys.lock && rank == 0) {
    __threadfence_block();
    atomicExch(sys.lock, 0);
  }
}

struct AaStats {
  float rp, rd, mz, mq;  // the termination residuals of the iterate kept
  int state;             // the operator's state after the step (op_state)
  AaRing ring;           // the ring's indices before (sp) and after the step
};

// The chunk's system in the Gram area (kAaSolveGram): Ga after Gk, rows
// of k + 1.
struct AaGramSys {
  float* ga;
};

// The right-hand side of logical pair a into the system, by rank 0.
__device__ __forceinline__ void aa_put_rhs(const AaGramSys& s, int a, int k, float v) {
  s.ga[a * (k + 1) + k] = v;
}
__device__ __forceinline__ void aa_put_rhs(const AaSys& s, int a, int, float v) { s.gv[a] = v; }

// The solve: in the Gram area by warp 0, off it by the whole scope; the
// caller syncs the scope after it.
template <class S>
__device__ __forceinline__ void aa_solve_of(const float* Gk, const AaGramSys& s, int k, int lo,
                                            int s_lo) {
  if (S::rank() < 32) {
    __syncwarp();  // the pushed row and the right-hand side to warp 0
    aa_solve(Gk, s.ga, k, lo, s_lo, S::rank());
  }
}
template <class S>
__device__ __forceinline__ void aa_solve_of(const float* Gk, const AaSys& s, int k, int lo,
                                            int s_lo) {
  S::sync();  // the pushed row and the right-hand side to the scope
  aa_solve_sys<S>(Gk, s, k, lo, s_lo);
}

// The candidate u_T - sum_a gamma_a dU_a, z clipped to [l, u], into the
// iterate (cur), and u_T into ua, by each thread of the scope on its
// entries; in the Gram area gamma read at every pair of every entry.
template <class S, class Cur>
__device__ __forceinline__ void aa_candidate(const AaGramSys& sys, int k, int lo, int s_lo,
                                             int n, int m, const float* dU, float* ua,
                                             const float* l, const float* u, Cur cur) {
  const int D = n + 2 * m, k1 = k + 1;
#pragma unroll 1
  for (int e = S::rank(); e < D; e += S::size()) {
    float acc = 0.f;
#pragma unroll 1
    for (int a = lo, s = s_lo; a < k; ++a, s = aa_next(s, k))
      acc = fmaf(sys.ga[a * k1 + k], dU[(size_t)s * D + e], acc);
    float& c = cur(e);
    const float cand = c - acc;
    ua[e] = c;
    c = (e >= n && e < n + m) ? clip(cand, l[e - n], u[e - n]) : cand;
  }
}

// Off the Gram area: each thread takes AaCand<S>::entries of its entries
// at once (a warp's lanes hold several of D's entries each, a block's
// threads one or two) and kAaCandPairs pairs at a time, their dU loads
// issued before the fmafs, so that gamma is read once a pair for those
// entries and a round trip serves several products; each entry sums its
// pairs in the order of the loop above, so the bits are the same.
template <class S>
struct AaCand {
  static constexpr int entries = 2;
};
template <>
struct AaCand<WarpScope> {
  static constexpr int entries = 4;
};
constexpr int kAaCandPairs = 4;

template <class S, class Cur>
__device__ __forceinline__ void aa_candidate(const AaSys& sys, int k, int lo, int s_lo, int n,
                                             int m, const float* dU, float* ua, const float* l,
                                             const float* u, Cur cur) {
  constexpr int E = AaCand<S>::entries, P = kAaCandPairs;
  const int D = n + 2 * m, stride = S::size();
#pragma unroll 1
  for (int e0 = S::rank(); e0 < D; e0 += E * stride) {
    float acc[E];
#pragma unroll
    for (int j = 0; j < E; ++j) acc[j] = 0.f;
#pragma unroll 1
    for (int a0 = lo; a0 < k; a0 += P) {
      float g[P], d[P][E];
#pragma unroll
      for (int t = 0; t < P; ++t) {
        const int a = a0 + t, s = s_lo + a - lo >= k ? s_lo + a - lo - k : s_lo + a - lo;
        g[t] = a < k ? sys.gv[a] : 0.f;
#pragma unroll
        for (int j = 0; j < E; ++j) {
          const int e = e0 + j * stride;
          d[t][j] = a < k && e < D ? dU[(size_t)s * D + e] : 0.f;
        }
      }
#pragma unroll
      for (int t = 0; t < P; ++t)
        if (a0 + t < k)
#pragma unroll
          for (int j = 0; j < E; ++j) acc[j] = fmaf(g[t], d[t][j], acc[j]);
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const int e = e0 + j * stride;
      if (e >= D) continue;
      float& c = cur(e);
      const float cand = c - acc[j];
      ua[e] = c;
      c = (e >= n && e < n + m) ? clip(cand, l[e - n], u[e - n]) : cand;
    }
  }
}

// The step at a chunk's end, after the plain chunk output u_T's residuals
// (sp, the caller's stats): (x, z, y) hold u_T on entry and the accepted
// iterate on exit, the candidate u_T - sum_i gamma_i dU_i (z clipped to
// [l, u]) where it has pairs, a finite combined residual rp / (mz + 1e-30)
// + rd / (mq + 1e-30) below the plain one and does not undo termination,
// else u_T.  One pass over the scope's entries updates the
// ring and adds each thread's terms of the chunk's 2 x pairs dot products:
// the pushed pair's row of the Gram (dF_push . dF_i) and the right-hand
// side (dF_i . f), from one read of each dF_i, each summed over the same
// entries by the same threads in the same order as every earlier chunk's
// (so the kept entries are the ones a fresh Gram would have, bit for bit);
// one op_sum reduces those of kAaSlots pairs (a cluster's blocks take x's
// entries of op_cols and their own rows).  The chunk's stats stay in the
// caller, whose loops keep their registers: fused into this out-of-line
// step's reduction under the kernels' register caps, they ran slower
// (K1 n = 32, K6 horizon 64 on an H100).  Rank 0 keeps the reduced values
// in the Gram area (the right-hand side in the system, Sys) and warp 0
// solves there (aa_solve), or the whole scope where the system is off the
// Gram area (aa_solve_sys), then a sync; every
// thread reads the one gamma, so the candidate and the accept are the same
// in every thread of the scope.  (A solve in registers by every warp, with
// no barrier, at k <= kAaSlots ran no faster end to end: K1 n = 32, K3 and
// K6/K7 at memory 4 on an H100.)  The candidate and the saved plain output
// are one pass (in tiles off the Gram area, aa_candidate); the candidate's
// stats are the step's floor.  It runs in aa_chunk_end, which takes the
// operator by value and stays out of line with its loops kept rolled, so
// that the iterations around it keep their register allocation.
template <class Op, class Sys>
__device__ __forceinline__ AaStats aa_step(const Op& op, int k, int n, int m, float eps_abs,
                                           float eps_rel, AaStats sp, const float* q,
                                           const float* l, const float* u, float* x, float* z,
                                           float* y, float* tm, float* tn1, float* tn2,
                                           float* red, float* aa, float* Gk, const Sys& sys) {
  using S = typename OpScope<Op>::type;
  const int D = n + 2 * m;
  float* dU = aa;
  float* dF = dU + (size_t)k * D;
  float* uTp = dF + (size_t)k * D;
  float* fp = uTp + D;
  float* u0 = fp + D;
  float* ua = u0 + D;
  const bool prev_ok = sp.ring.prev_ok != 0;
  int pairs = sp.ring.pairs, head = sp.ring.head;
  const int push = head;  // the oldest slot takes the newest pair
  if (prev_ok) {
    pairs = min(pairs + 1, k);
    head = aa_next(head, k);
  }
  const int lo = k - pairs;
  const int s_lo = head + lo >= k ? head + lo - k : head + lo;  // logical lo's slot
  auto cur = [&](int e) -> float& { return e < n ? x[e] : (e < n + m ? z[e - n] : y[e - n - m]); };
  int j0, j1;
  op_cols(op, n, j0, j1);
  float v[kAaGroup];  // the group's dot products
  ADMM_PHASE_BEGIN(kPhAaRing);
  // kAaSlots pairs a group, two dot products each: the pushed pair's entry
  // of the Gram dF_push . dF_s and the right-hand side's dF_s . f, from one
  // read of dF_s; the group's slots' offsets worked out once, in registers
#pragma unroll 1
  for (int a0 = 0; a0 == 0 || a0 < pairs; a0 += kAaSlots) {
    int os[kAaSlots];  // logical lo + a0 + g's slot times D (past pairs, the last one's)
#pragma unroll
    for (int g = 0; g < kAaSlots; ++g) {
      const int a = max(min(a0 + g, pairs - 1), 0);
      os[g] = (s_lo + a >= k ? s_lo + a - k : s_lo + a) * D;
    }
#pragma unroll
    for (int g = 0; g < kAaGroup; ++g) v[g] = 0.f;
#pragma unroll 1
    for (int e = S::rank(); e < D; e += S::size()) {
      float dfp, fe;  // dF_push and f at e
      if (a0 == 0) {
        const float uT = cur(e);
        fe = uT - u0[e];
        dfp = fe - fp[e];
        if (prev_ok) {
          dU[(size_t)push * D + e] = uT - uTp[e];
          dF[(size_t)push * D + e] = dfp;
        }
        uTp[e] = uT;
        fp[e] = fe;
      } else {
        dfp = dF[(size_t)push * D + e];
        fe = fp[e];
      }
      if (pairs == 0 || (e < n && (e < j0 || e >= j1))) continue;
#pragma unroll
      for (int g = 0; g < kAaSlots; ++g) {
        const float d = dF[os[g] + e];
        v[2 * g] = fmaf(dfp, d, v[2 * g]);
        v[2 * g + 1] = fmaf(d, fe, v[2 * g + 1]);
      }
    }
    if (a0 == 0) {
      ADMM_PHASE_END(kPhAaRing);
      ADMM_PHASE_BEGIN(kPhAaDot);
    }
    if (pairs == 0) break;
    op_sum(op, v, red);
    if (S::rank() == 0)  // the pushed row kept, the rhs into the system
#pragma unroll 1
      for (int g = 0; g < kAaSlots && a0 + g < pairs; ++g) {
        const int sb = s_lo + a0 + g >= k ? s_lo + a0 + g - k : s_lo + a0 + g;
        Gk[push * k + sb] = Gk[sb * k + push] = v[2 * g];
        aa_put_rhs(sys, lo + a0 + g, k, v[2 * g + 1]);
      }
  }
  ADMM_PHASE_END(kPhAaDot);
  AaStats out = sp;
  out.ring = AaRing{1, pairs, head};
  if (pairs > 0) {
    ADMM_PHASE_BEGIN(kPhAaSolve);
    aa_solve_of<S>(Gk, sys, k, lo, s_lo);
    S::sync();  // gamma to the scope
    ADMM_PHASE_END(kPhAaSolve);
    ADMM_PHASE_BEGIN(kPhAaCand);
    aa_candidate<S>(sys, k, lo, s_lo, n, m, dU, ua, l, u, cur);
    S::sync();
    AdmmState sa;
    admm_stats(op, q, x, z, y, tm, tn1, tn2, red, n, m, sa);
    const float tiny = 1e-30f;
    const float comb_a = sa.rp / (sa.mz + tiny) + sa.rd / (sa.mq + tiny);
    const float comb_p = sp.rp / (sp.mz + tiny) + sp.rd / (sp.mq + tiny);
    const bool term_a = (sa.rp <= eps_abs + eps_rel * sa.mz) && (sa.rd <= eps_abs + eps_rel * sa.mq);
    const bool term_p = (sp.rp <= eps_abs + eps_rel * sp.mz) && (sp.rd <= eps_abs + eps_rel * sp.mq);
    const bool accept = isfinite(comb_a) && comb_a < comb_p && (term_a || !term_p);
    S::sync();  // the candidate stats' readers are done
    ADMM_PHASE_END(kPhAaCand);
    ADMM_PHASE_BEGIN(kPhAaRevert);
    if (accept) {
      out.rp = sa.rp;
      out.rd = sa.rd;
      out.mz = sa.mz;
      out.mq = sa.mq;
    } else {
#pragma unroll 1
      for (int e = S::rank(); e < D; e += S::size()) cur(e) = ua[e];
      S::sync();
    }
    ADMM_PHASE_END(kPhAaRevert);
  }
  out.state = op_state(op);
  return out;
}

// The step on the Gram area ag (Gk, then the system): every launch up to
// kAaGramSmemMemory.
template <class Op>
__device__ __noinline__ AaStats aa_chunk_end(Op op, int k, int n, int m, float eps_abs,
                                             float eps_rel, AaStats sp, const float* q,
                                             const float* l, const float* u, float* x, float* z,
                                             float* y, float* tm, float* tn1, float* tn2,
                                             float* red, float* aa, float* ag) {
  return aa_step(op, k, n, m, eps_abs, eps_rel, sp, q, l, u, x, z, y, tm, tn1, tn2, red, aa, ag,
                 AaGramSys{ag + k * k});
}

// The step with the kept Gram gk (in the workspace, or for K6/K7 in its
// Gram area on chip) and the chunk's system in sys (AaSysArgs::solve past
// kAaSolveGram).
template <class Op>
__device__ __noinline__ AaStats aa_chunk_end(Op op, int k, int n, int m, float eps_abs,
                                             float eps_rel, AaStats sp, const float* q,
                                             const float* l, const float* u, float* x, float* z,
                                             float* y, float* tm, float* tn1, float* tn2,
                                             float* red, float* aa, float* gk, AaSys sys) {
  return aa_step(op, k, n, m, eps_abs, eps_rel, sp, q, l, u, x, z, y, tm, tn1, tn2, red, aa, gk,
                 sys);
}

// The warm-started ADMM solve of one problem (twin of _admm_core).  The
// operator's factor holds the factor for the current rho on entry and on
// exit (or is built in the first epoch when st.pending is set on entry).
// With p.check_infeas, xp (n) and yp (m) keep the chunk-start iterates for
// the certificates; a certified problem commits its chunk and stops.  The
// instantiation with AA runs the Anderson step (aa_chunk_end) at each
// chunk's end on this scope's ring aa and Gram area ag (k pairs; aa_state),
// fresh at entry; the one without it is the solve as it was, register for
// register (its signature too: the Gram area comes as a parameter pack that
// only the instantiation with AA is given).
template <class Op, bool AA = false, class... Gram>
__device__ void admm_solve(const StepParams& p, const Op& op, const float* q, const float* l,
                           const float* u, float* rv, float* x, float* z, float* y, float* bt,
                           float* xt, float* tm, float* tn1, float* tn2, float* xp, float* yp,
                           float* red, AdmmState& st, float* aa = nullptr, int k = 0,
                           Gram... ag) {
  using S = typename OpScope<Op>::type;
  const int n = p.n, m = p.m;
  [[maybe_unused]] AaRing ring{0, 0, 0};
  for (int e = 0; e < p.n_epochs && !st.done && !st.fail && st.infs == 0; ++e) {
    // adopt the pending rho together with its factorization; a NaN
    // rho_est (NaN residuals) poisons rho, as the TPU's arithmetic select
    // does, and the refactor reports the fail
    if (st.pending || isnan(st.rho_est)) st.rho = st.rho_est;
    if (st.pending || isnan(st.rho)) {
      op_factor_mark(op, true);
      set_rho_vec<S>(rv, l, u, st.rho, m);
      st.fail = op.factor(rv);
      st.nfact += 1;
      op_factor_mark(op, false);
    }
    for (int c = 0; c < p.chunks_per_epoch && !st.done && !st.fail && st.infs == 0; ++c) {
      if (p.check_infeas) {
        for (int j = S::rank(); j < n; j += S::size()) xp[j] = x[j];
        for (int i = S::rank(); i < m; i += S::size()) yp[i] = y[i];
      }
      if constexpr (AA) aa_begin<S>(aa, k, n, m, x, z, y);
      for (int it = 0; it < p.seg; ++it)
        admm_iter(op, q, l, u, rv, x, z, y, bt, xt, tm, p.sigma, p.alpha, n, m);
      ADMM_PHASE_BEGIN(kPhStats);
      admm_stats(op, q, x, z, y, tm, tn1, tn2, red, n, m, st);
      ADMM_PHASE_END(kPhStats);
      if constexpr (AA) {
        const AaStats r = aa_chunk_end(op, k, n, m, p.eps_abs, p.eps_rel,
                                       AaStats{st.rp, st.rd, st.mz, st.mq, 0, ring}, q, l, u,
                                       x, z, y, tm, tn1, tn2, red, aa, ag...);
        op_set_state(op, r.state);
        ring = r.ring;
        st.rp = r.rp;
        st.rd = r.rd;
        st.mz = r.mz;
        st.mq = r.mq;
      }
      if (p.check_infeas) {
        ADMM_PHASE_BEGIN(kPhCert);
        // the deltas replace the chunk-start copies; the stats' readers of
        // tm, tn1, tn2 are past the barriers inside block_max
        for (int j = S::rank(); j < n; j += S::size()) xp[j] = x[j] - xp[j];
        for (int i = S::rank(); i < m; i += S::size()) yp[i] = y[i] - yp[i];
        S::sync();
        st.infs = certificate(p, op, q, l, u, xp, yp, tn1, tn2, tm, red);
        ADMM_PHASE_END(kPhCert);
      }
      const bool conv = (st.rp <= p.eps_abs + p.eps_rel * st.mz) &&
                        (st.rd <= p.eps_abs + p.eps_rel * st.mq);
      st.itc += p.seg;
      st.done = conv;
    }
    if (p.adaptive_rho) {
      const bool act = !st.done && !st.fail && st.infs == 0;
      bool changed = false;
      if (act) {
        const float tiny = 1e-30f;
        const float nrp = st.rp / (st.mz + tiny);
        const float nrd = st.rd / (st.mq + tiny);
        const float new_rho = clip(st.rho * sqrtf(nrp / (nrd + tiny)), kRhoMin, kRhoMax);
        changed = (new_rho < st.rho / p.adaptive_rho_tolerance) ||
                  (new_rho > st.rho * p.adaptive_rho_tolerance);
        st.rho_est = new_rho;
      }
      st.rho_upd += changed ? 1 : 0;
      st.pending = changed;
      if constexpr (AA) {
        if (changed) ring.prev_ok = ring.pairs = 0;
      }
    }
  }
}

// The dense operator (K1, K3): A (m x n) and the factor's Minv in W and
// scratch Li, all with row stride ld; P with row stride ldp.
struct DenseOp {
  const float* P;
  int ldp;
  const float* A;
  float* W;
  float* Li;
  int ld, n, m;
  float sigma;

  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < m; ++i) acc = fmaf(A[(size_t)i * ld + j], w[i], acc);
      epi(j, acc);
    }
  }
  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    for (int i = threadIdx.x; i < m; i += blockDim.x) {
      const float* r = A + (size_t)i * ld;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(r[j], v[j], acc);
      epi(i, acc);
    }
  }
  __device__ void pmv(const float* v, float* out) const { mv(P, ldp, n, n, v, out); }
  __device__ void apply_minv(const float* b, float* out) const { mv(W, ld, n, n, b, out); }
  __device__ bool factor(const float* rv) const {
    return factor_minv(W, Li, ld, P, ldp, A, rv, sigma, n, m);
  }
};
__device__ __forceinline__ void op_factor_mark(const DenseOp&, bool) {}

}  // namespace

// Floats of one scope's share of the Anderson workspace at memory k, n
// variables and m rows: its slice (aa_floats) and room for its chunk's
// system (aa_solve_floats; kAaSolveWorkspace, after the
// slices, from a multiple of 4 floats); the wrappers allocate one share a problem (a block, for a K6/K7
// cluster) with acceleration="anderson".  Weak, so that each unit may
// define it and a library of any of the Anderson units has it.
extern "C" __attribute__((weak)) long long admm_aa_floats(int k, int n, int m) {
  return aa_floats(k, n, m) + kAaSolveHead + aa_solve_floats(k);
}

#ifdef ADMM_PHASE_CLOCKS
// Copies the phase sums out (kNumPhases values, summed over the slots)
// and zeroes them.  Each unit has its own sums: an Anderson unit, linked
// beside the unit it includes, names its reader admm_phase_clocks_aa.
#ifndef ADMM_PHASE_READER
#define ADMM_PHASE_READER admm_phase_clocks
#endif
extern "C" int ADMM_PHASE_READER(unsigned long long* out) {
  static unsigned long long buf[kPhaseSlots][kNumPhases];
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(buf, admm_phase_cycles, sizeof(buf));
  for (int p = 0; p < kNumPhases; ++p) {
    out[p] = 0;
    for (int k = 0; k < kPhaseSlots; ++k) out[p] += buf[k][p];
  }
  static const unsigned long long zero[kPhaseSlots][kNumPhases] = {};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(admm_phase_cycles, zero, sizeof(zero));
  return (int)err;
}
#endif
