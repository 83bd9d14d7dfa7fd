// Hopper (sm_90a) kernels of the SQP main path and the QP serving path,
// with a plain C interface loaded through ctypes by
// sqp_solver_tpu_torch/ops/qp_kernel.py.
//
//   sqp_step_kernel    replaces sqp_solver_tpu/ops/qp_kernel.py:sqp_step_kernel
//                      (body _sqp_step_kernel, pallas_call in _sqp_step_call)
//   polish_kkt_kernel  replaces sqp_solver_tpu/ops/qp_kernel.py:polish_kkt_kernel
//                      (body _polish_kkt_body, pallas_call in _polish_kkt_call)
//   qp_solve_kernel    replaces sqp_solver_tpu/ops/qp_kernel.py:qp_solve_kernel
//                      (body _qp_kernel, pallas_call in _qp_kernel_call)
//   spd_inverse_kernel replaces sqp_solver_tpu/ops/qp_kernel.py:spd_inverse_kernel
//                      (body _spd_inverse_body, pallas_call in _spd_inverse_call)
//
// Design.  One thread block per problem, batch-first operands.  The TPU
// kernels put 128 problems on the VPU lanes and branch once per tile; here
// every loop exit (ADMM chunk and rho epoch, the posdef retry, skipping an
// inactive problem) is a per-problem branch.  Every such condition is
// computed identically by all threads of the block from shared memory or
// from a block reduction, so it is block-uniform and __syncthreads() never
// sits under a thread-divergent branch.
//
// The pieces the TPU kernels share are device functions in admm_core.cuh
// (shared with the structured kernel, qp_kernel_btd.cu) and
// dense_factor.cuh (K1 and K2 only):
//   schur_build      M = P + sigma I + A' diag(w) A     (_factor_schur_refs)
//   cholesky_inplace, tri_inv, ltl                      (_chol_inv_ltl)
//                    the column factor of K3 and K4
//   gram_build, chol_blocked, tri_inv_blocked, ltl_tiles
//                    the blocked, register-tiled factor of K1 and K2, the
//                    Cholesky in panels of 32 columns with the column
//                    factor's pivot rule and per-element fmaf chain
//   admm_solve       rho epochs / chunks / adaptive rho /
//                    infeasibility certificates         (_admm_core), run
//                    with the dense operator DenseOp (K3's block layout),
//                    DenseLaneOp (K1, its matvecs split over lanes) or,
//                    with the warp as its scope, WarpDenseOp (K3's warp
//                    layout, below, with its own factor in the warp)
//
// Numerics follow the TPU kernels where they decide a flag or a branch:
// float32 storage and accumulation; the explicit inverse Minv = L^-T L^-1
// that ADMM applies (K1) and Li'(Li t) (K2); the pivot clamp max(d, 1e-30)
// with fail = (d <= 0 | isnan(d)); rho adopted only at factor time so the
// emitted (Minv, rho) pair stays consistent for SOC reuse; the iteration
// count advancing by seg only on active problems.
//
// Anderson acceleration.  K1 and K3 (both layouts) take it as a second
// instantiation of their bodies (AA = true), whose ADMM core runs the
// Anderson step of admm_core.cuh at each chunk's end; the instantiations
// without it are the kernels as they were.  The Anderson kernels and their
// entry points live in qp_kernel_aa.cu, which includes this file with
// QP_KERNEL_AA_UNIT defined, so that nvcc builds them in a process of
// their own beside this one: with them in this unit, nvcc took 112.6 s
// over it, against 75.8 and 81.9 s over the structured kernel's two units
// (the build line of chip_smoke.py, sm_90a), and the library's build
// waited for it.  The step keeps its Gram area and its ring in shared
// memory where aa_dense_plan (below) puts them (the Gram always at a
// memory up to 32); the Anderson kernels' registers
// are capped at their twins', so that the step costs no blocks an SM.
//
// Memory.  Vectors live in shared memory.  The per-problem matrices
// (row stride n+1, which makes the row-per-thread matvecs of K3/K4 and
// the lane-split ones of K1/K2 free of bank conflicts) go to shared memory in a fixed order for as long as they fit
// in the 227 KB a block may use; the rest go to a per-problem workspace in
// device memory that the wrapper allocates.  At n = 32 and at n = 128
// (m = n + 1) every matrix fits; the workspace serves larger n or m.

#include "admm_core.cuh"
#include "dense_factor.cuh"

namespace {

// K1 and K2 run 128 threads a block with 4 lanes a dot product (n, m <=
// 64) or 256 with 2.  The small variant caps its registers at 64 a thread
// (eight blocks an SM, as many as its ~16 KB of shared memory allows at
// n = 32) and tiles the factor 2 x 2 a quadrant; the large one runs one
// block an SM at n = 128 and tiles 4 x 4.
template <int L>
constexpr int kThreads = L == 4 ? 128 : 256;
template <int L>
constexpr int kMinBlocks = L == 4 ? 8 : 1;
template <int L>
constexpr int kQuad = L == 4 ? 2 : 4;

// K1's dense operator: A (m x n) and the explicit Minv in W, scratch Li,
// all with row stride ld; P (the Hessian, in device memory) with stride
// ldp.  Each dot product split over L lanes with its loads issued
// together (dense_factor.cuh); each epilogue called once per row or
// column, from one lane.  factor() is the blocked factor of
// dense_factor.cuh; sc is 33 floats of scratch (the reduction slots,
// free while a factor runs).
template <int L>
struct DenseLaneOp {
  const float* P;
  int ldp;
  const float* A;
  float* W;
  float* Li;
  float* sc;
  int ld, n, m;
  float sigma;

  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    cols_dot<L>(A, ld, m, n, w, epi);
  }
  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    rows_dot<L>(A, ld, m, n, v, epi);
  }
  __device__ void pmv(const float* v, float* out) const {
    rows_dot<L>(P, ldp, n, n, v, [&](int i, float acc) { out[i] = acc; });
  }
  __device__ void apply_minv(const float* b, float* out) const {
    rows_dot<L>(W, ld, n, n, b, [&](int i, float acc) { out[i] = acc; });
  }
  __device__ bool factor(const float* rv) const {
    return dense_factor_minv<kQuad<L>>(W, Li, ld, P, ldp, A, rv, sigma, n, m, sc);
  }
};
template <int L>
__device__ __forceinline__ void op_factor_mark(const DenseLaneOp<L>&, bool) {}

// K1.  Replaces sqp_solver_tpu/ops/qp_kernel.py:sqp_step_kernel.
// Per problem: damped BFGS (Procedure 18.2) into B_out, the posdef fallback
// (factor; on a failed pivot B := I and refactor), then the warm-started
// ADMM solve.  With minv_in the factor and rho of a previous solve of the
// same (B, J) are reused (the SOC re-solve); minv_out emits the final one.
// What bounds it on this card: at n = 32, B = 4096 it is per-problem
// latency (4096 blocks of 128 threads, ~31 per SM over 132 SMs; each ADMM
// iteration is four dependent matvec phases with a barrier between them),
// at n = 128 the O(n^3) factor of one block per SM (208 KB of shared
// memory).  The design keeps the operands of the hot loop (A and Minv,
// padded rows) in shared memory at both sizes, so the ADMM iterations
// never touch device memory; B_out, read once per chunk, stays in device
// memory (L1/L2 resident).  The factor (setup, posdef retry, every rho
// epoch's refactor) is the blocked one of dense_factor.cuh plus L'L in
// register tiles; the ADMM matvecs split each dot product over L lanes
// (4 at 128 threads, 2 at 256) so that every thread works on short
// chains with their loads in flight.  BFGS is the parent's.
// The body, with (AA) or without Anderson acceleration, and with SYS the
// Anderson step off the Gram area (AaSys); the kernels sqp_step_kernel,
// sqp_step_kernel_aa and sqp_step_kernel_aas (qp_kernel_aa.cu) instantiate
// it.
#define SQP_STEP_PARAMS                                                                       \
  StepParams p, const float* __restrict__ Bp, const float* __restrict__ J,                    \
      const float* __restrict__ g, const float* __restrict__ lg, const float* __restrict__ ug, \
      const float* __restrict__ sg, const float* __restrict__ dglg,                           \
      const uint8_t* __restrict__ reset, const uint8_t* __restrict__ upd,                     \
      const uint8_t* __restrict__ active, const float* __restrict__ rho_in,                   \
      const float* __restrict__ minv_in, const float* __restrict__ x0,                        \
      const float* __restrict__ z0, const float* __restrict__ y0, float* __restrict__ p_out,  \
      float* __restrict__ z_out, float* __restrict__ y_out, float* __restrict__ B_out,        \
      float* __restrict__ stats, float* __restrict__ minv_out, float* __restrict__ ws
#define SQP_STEP_ARGS                                                                     \
  p, Bp, J, g, lg, ug, sg, dglg, reset, upd, active, rho_in, minv_in, x0, z0, y0, p_out, \
      z_out, y_out, B_out, stats, minv_out, ws
template <int L, bool AA, bool SYS = false>
__device__ __forceinline__ void sqp_step_body(SQP_STEP_PARAMS, AaArgs aa_args,
                                              AaSysArgs sys_args = {}) {
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int n = p.n, m = p.m, ld = n + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, wp = tid >> 5, nw = T >> 5;

  float* q = smem;
  float* x = q + n;
  float* bt = x + n;
  float* xt = bt + n;
  float* tn1 = xt + n;
  float* tn2 = tn1 + n;
  float* s = tn2 + n;
  float* yv = s + n;
  float* Bs = yv + n;   // 9 n
  float* z = Bs + n;
  float* y = z + m;
  float* l = y + m;
  float* u = l + m;
  float* rv = u + m;
  float* tm = rv + m;
  float* tm2 = tm + m;  // 7 m
  float* red = tm2 + m;
  float* mats = red + kRedSlots;
  float* M[3];
  const int msize[3] = {n * ld, m * ld, n * ld};
  place(M, msize, mats, p.n_smem_mats, ws, p.ws_floats);
  float* W = M[0];
  float* A = M[1];
  float* Li = M[2];
  float* Bn = B_out + b * n * n;
  const float* Bpb = Bp + b * n * n;

  for (int j = tid; j < n; j += T) {
    q[j] = g[b * n + j];
    x[j] = x0[b * n + j];
  }
  for (int i = tid; i < m; i += T) {
    z[i] = z0[b * m + i];
    y[i] = y0[b * m + i];
    l[i] = lg[b * m + i];
    u[i] = ug[b * m + i];
  }
  map_rows(J + b * m * n, n, m, n, false, [&](int i, int j, float a) { A[i * ld + j] = a; });
  __syncthreads();
  ADMM_PHASE_END(kPhLoad);

  ADMM_PHASE_BEGIN(kPhBfgs);
  const bool act0 = active[b] != 0;
  if (p.do_bfgs) {
    for (int j = tid; j < n; j += T) {
      s[j] = sg[b * n + j];
      yv[j] = dglg[b * n + j];
    }
    __syncthreads();
    mv(Bpb, n, n, n, s, Bs);
    __syncthreads();
    float v[2] = {0.f, 0.f};
    for (int j = tid; j < n; j += T) {
      v[0] = fmaf(s[j], Bs[j], v[0]);
      v[1] = fmaf(s[j], yv[j], v[1]);
    }
    block_sum(v, red);
    const float sBs = v[0], sy = v[1];
    const bool damped = sy < 0.2f * sBs;
    const float theta = 0.8f * sBs / nan_max(sBs - sy, FLT_MIN);
    float* r = tn1;
    for (int j = tid; j < n; j += T)
      r[j] = damped ? theta * yv[j] + (1.f - theta) * Bs[j] : yv[j];
    const float sr = damped ? theta * sy + (1.f - theta) * sBs : sy;
    const bool keep = (sr < FLT_EPSILON) || upd[b] == 0;
    const bool rst = reset[b] != 0;
    const float isBs = 1.f / nan_max(sBs, FLT_MIN);
    const float isr = 1.f / nan_max(sr, FLT_MIN);
    __syncthreads();
    for (int e = tid; e < n * n; e += T) {
      const int i = e / n, j = e - i * n;
      float val;
      if (rst) val = (i == j) ? 1.f : 0.f;
      else if (keep) val = Bpb[e];
      else val = Bpb[e] - (Bs[i] * Bs[j]) * isBs + (r[i] * r[j]) * isr;
      Bn[e] = val;
    }
  } else {
    for (int e = tid; e < n * n; e += T) Bn[e] = Bpb[e];
  }
  __syncthreads();
  ADMM_PHASE_END(kPhBfgs);

  AdmmState st;
  st.done = !act0;
  st.pending = false;
  st.itc = 0;
  st.rho_upd = 1;  // the reference counts the setup rho update
  st.nfact = 0;
  st.infs = 0;
  st.rp = st.rd = st.mz = st.mq = 0.f;
  if (minv_in) {
    const float* mi = minv_in + b * n * n;
    map_rows(mi, n, n, n, false, [&](int i, int j, float a) { W[i * ld + j] = a; });
    const float ri = rho_in ? rho_in[b] : 0.f;
    st.rho = ri > 0.f ? ri : p.rho0;
    st.fail = false;
    set_rho_vec(rv, l, u, st.rho, m);
  } else {
    st.rho = p.rho0;
    set_rho_vec(rv, l, u, st.rho, m);
    bool f = false;
    if (act0) {
      f = dense_factor_minv<kQuad<L>>(W, Li, ld, Bn, n, A, rv, p.sigma, n, m, red);
      st.nfact = 1;
      if (f) {  // posdef fallback: B := I and refactor once
        for (int i = wp; i < n; i += nw)
          for (int j = lane; j < n; j += 32) Bn[i * n + j] = i == j ? 1.f : 0.f;
        __syncthreads();
        f = dense_factor_minv<kQuad<L>>(W, Li, ld, Bn, n, A, rv, p.sigma, n, m, red);
        st.nfact = 2;
      }
    }
    st.fail = f && act0;
  }
  st.rho_est = st.rho;

  const DenseLaneOp<L> op{Bn, n, A, W, Li, red, ld, n, m, p.sigma};
  if constexpr (AA) {
    const AaState aa = aa_state(aa_args, smem, 0, b, n, m);
    if constexpr (SYS)
      admm_solve<DenseLaneOp<L>, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, nullptr,
                                     nullptr, red, st, aa.ring, aa.k, aa.gram,
                                     aa_sys(sys_args, aa.k, smem, 0, b));
    else
      admm_solve<DenseLaneOp<L>, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, nullptr,
                                     nullptr, red, st, aa.ring, aa.k, aa.gram);
  } else {
    admm_solve<DenseLaneOp<L>, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, nullptr,
                                   nullptr, red, st);
  }

  ADMM_PHASE_BEGIN(kPhLoad);
  for (int j = tid; j < n; j += T) p_out[b * n + j] = x[j];
  for (int i = tid; i < m; i += T) {
    z_out[b * m + i] = z[i];
    y_out[b * m + i] = y[i];
  }
  if (tid == 0) {  // stats is (9, batch): one row per field
    const size_t B = gridDim.x;
    stats[0 * B + b] = st.done ? 1.f : 0.f;
    stats[1 * B + b] = (float)st.itc;
    stats[2 * B + b] = st.rp;
    stats[3 * B + b] = st.rd;
    stats[4 * B + b] = st.fail ? 1.f : 0.f;
    stats[5 * B + b] = (float)st.rho_upd;
    stats[6 * B + b] = st.rho_est;
    stats[7 * B + b] = st.rho;
    stats[8 * B + b] = (float)st.nfact;
  }
  if (minv_out) {
    const bool have = minv_in != nullptr || st.nfact > 0;
    float* mo = minv_out + b * n * n;
    for (int i = wp; i < n; i += nw)
      for (int j = lane; j < n; j += 32) mo[i * n + j] = have ? W[i * ld + j] : 0.f;
  }
  ADMM_PHASE_END(kPhLoad);
  ADMM_PHASE_END(kPhTotal);
}

#ifndef QP_KERNEL_AA_UNIT
template <int L>
__global__ void __launch_bounds__(kThreads<L>, kMinBlocks<L>) sqp_step_kernel(SQP_STEP_PARAMS) {
  sqp_step_body<L, false>(SQP_STEP_ARGS, AaArgs{0, nullptr});
}
#else
template <int L>
__global__ void __launch_bounds__(kThreads<L>, kMinBlocks<L>) sqp_step_kernel_aa(
    SQP_STEP_PARAMS, AaArgs aa_args) {
  sqp_step_body<L, true>(SQP_STEP_ARGS, aa_args);
}
// The same where the Gram area is in the workspace (aa_dense_plan's
// solve past kAaSolveGram): the step's system in a solve area (AaSys).
template <int L>
__global__ void __launch_bounds__(kThreads<L>, kMinBlocks<L>) sqp_step_kernel_aas(
    SQP_STEP_PARAMS, AaArgs aa_args, AaSysArgs sys_args) {
  sqp_step_body<L, true, true>(SQP_STEP_ARGS, aa_args, sys_args);
}
#endif

// K2.  Replaces sqp_solver_tpu/ops/qp_kernel.py:polish_kkt_kernel.
// Per problem: mask J by the active rows, L^-1 of M = H + delta I +
// (1/delta) Jm'Jm, then `sweeps` ideal-operator refinement sweeps that
// apply M^-1 as Li'(Li t).  What bounds it on this card: the O(n^3)
// factor (Gram n^2 m, Cholesky and L^-1 n^3 / 3 each) of one block per
// problem, one block per SM at n = 128 for the ~207 KB of shared memory.
// The design: the blocked factor of dense_factor.cuh (register-tiled Gram
// and SYRK, one warp per diagonal block, a few barriers a panel); L^-1
// held with its transpose mirrored into the upper triangle, so both
// triangular products of a sweep read rows; H copied once, by rows, into
// the slot W's factor leaves; every sweep matvec split over L lanes (4 at
// 128 threads, 2 at 256; the triangular ones over 2 L lanes, rows i and
// n - 1 - i together) and reduced by shuffles; the elementwise updates
// in the matvecs' epilogues, four barriers a sweep.
// Factor reuse (the JAX kernel's actt_prev / li_prev / fail_prev): the
// instantiation with REUSE compares each problem's mask with a previous
// call's; a problem whose mask is unchanged skips the factor, takes the
// previous L^-1 (and mirrors it) and reports the previous fail flag.  The
// decision is per problem (the TPU kernel's per tile of 128 lanes); the
// block-wide OR keeps the branch around the factor's barriers uniform.
#ifndef QP_KERNEL_AA_UNIT
struct PolishReuse {
  const uint8_t* act_prev;  // (B, m): the previous call's mask
  const float* li_prev;     // (B, n, n): its L^-1 (lower triangle)
  const uint8_t* fail_prev; // (B,): its fail flag (none: false)
};

#define POLISH_PARAMS                                                                      \
  int n, int m, float delta, int sweeps, int n_smem_mats, long long ws_floats,             \
      const float *__restrict__ H, const float *__restrict__ J,                            \
      const uint8_t *__restrict__ actg, const float *__restrict__ r1g,                     \
      const float *__restrict__ bg, const float *__restrict__ nu0,                         \
      const float *__restrict__ x0, float *__restrict__ x_out, float *__restrict__ nu_out, \
      uint8_t *__restrict__ fail_out, float *__restrict__ li_out, float *__restrict__ ws
#define POLISH_ARGS                                                                      \
  n, m, delta, sweeps, n_smem_mats, ws_floats, H, J, actg, r1g, bg, nu0, x0, x_out, nu_out, \
      fail_out, li_out, ws

template <int L, bool REUSE>
__device__ __forceinline__ void polish_kkt_body(POLISH_PARAMS, PolishReuse reuse) {
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int ld = n + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, wp = tid >> 5, nw = T >> 5;
  const float inv_d = 1.f / delta;

  float* r1 = smem;
  float* x = r1 + n;
  float* w_n = x + n;
  float* t = w_n + n;
  float* v = t + n;
  float* dx = v + n;  // 6 n
  float* bb = dx + n;
  float* nu = bb + m;
  float* w_m = nu + m;
  float* act = w_m + m;
  float* res2 = act + m;
  float* tmp = res2 + m;
  float* wrow = tmp + m;  // 7 m
  float* red = wrow + m;
  float* mats = red + kRedSlots;
  float* M[3];
  const int msize[3] = {n * ld, n * ld, m * ld};
  place(M, msize, mats, n_smem_mats, ws, ws_floats);
  float* W = M[0];
  float* Li = M[1];
  float* Jm = M[2];
  const float* Hb = H + b * n * n;

  for (int i = tid; i < m; i += T) {
    const float a = actg[b * m + i] ? 1.f : 0.f;
    act[i] = a;
    bb[i] = bg[b * m + i];
    nu[i] = nu0[b * m + i] * a;
    wrow[i] = a * inv_d;
  }
  for (int j = tid; j < n; j += T) r1[j] = r1g[b * n + j];
  __syncthreads();
  map_rows(J + b * m * n, n, m, n, false,
           [&](int i, int j, float a) { Jm[i * ld + j] = a * act[i]; });
  __syncthreads();
  ADMM_PHASE_END(kPhLoad);

  bool fail;
  if constexpr (REUSE) {
    bool changed = false;
    for (int i = tid; i < m; i += T) changed = changed || (actg[b * m + i] != reuse.act_prev[b * m + i]);
    if (__syncthreads_or(changed)) {
      gram_build<kQuad<L>>(W, ld, Hb, n, Jm, ld, wrow, delta, n, m);
      fail = chol_blocked<kQuad<L>>(W, ld, n, red);
      tri_inv_blocked(W, ld, Li, ld, n, true);
    } else {
      // the previous L^-1, its transpose mirrored above the diagonal
      const float* lp = reuse.li_prev + b * n * n;
      for (int i = wp; i < n; i += nw)
        for (int j = lane; j <= i; j += 32) Li[i * ld + j] = Li[j * ld + i] = lp[(size_t)i * n + j];
      fail = reuse.fail_prev ? reuse.fail_prev[b] != 0 : false;
    }
  } else {
    gram_build<kQuad<L>>(W, ld, Hb, n, Jm, ld, wrow, delta, n, m);
    fail = chol_blocked<kQuad<L>>(W, ld, n, red);
    tri_inv_blocked(W, ld, Li, ld, n, true);
  }

  ADMM_PHASE_BEGIN(kPhPolish);
  // H into the factor's dead slot; the warm start's H x0 and Jm x0
  map_rows(Hb, n, n, n, false, [&](int i, int j, float h) { W[i * ld + j] = h; });
  for (int j = tid; j < n; j += T) x[j] = x0 ? x0[b * n + j] : 0.f;
  __syncthreads();
  if (x0) {
    rows_dot<L>(W, ld, n, n, x, [&](int i, float acc) { w_n[i] = acc; });
    rows_dot<L>(Jm, ld, m, n, x, [&](int i, float acc) { w_m[i] = acc; });
  } else {
    for (int j = tid; j < n; j += T) w_n[j] = 0.f;
    for (int i = tid; i < m; i += T) w_m[i] = 0.f;
  }
  __syncthreads();
  for (int i = tid; i < m; i += T) {
    res2[i] = act[i] * (bb[i] - w_m[i]);
    tmp[i] = nu[i] - inv_d * res2[i];
  }
  __syncthreads();

  for (int sw = 0; sw < sweeps; ++sw) {
    cols_dot<L>(Jm, ld, m, n, tmp, [&](int j, float acc) { t[j] = r1[j] - w_n[j] - acc; });
    __syncthreads();
    tri_rows_dot<2 * L, false>(Li, ld, n, t, [&](int i, float acc) { v[i] = acc; });
    __syncthreads();
    tri_rows_dot<2 * L, true>(Li, ld, n, v, [&](int j, float acc) { dx[j] = acc; });
    __syncthreads();
    rows_dot<L>(W, ld, n, n, dx, [&](int j, float acc) {
      x[j] += dx[j];
      w_n[j] += acc;
    });
    rows_dot<L>(Jm, ld, m, n, dx, [&](int i, float acc) {
      nu[i] = nu[i] + act[i] * inv_d * (acc - res2[i]);
      w_m[i] += acc;
      res2[i] = act[i] * (bb[i] - w_m[i]);
      tmp[i] = nu[i] - inv_d * res2[i];
    });
    __syncthreads();
  }
  ADMM_PHASE_END(kPhPolish);

  ADMM_PHASE_BEGIN(kPhLoad);
  for (int j = tid; j < n; j += T) x_out[b * n + j] = x[j];
  for (int i = tid; i < m; i += T) nu_out[b * m + i] = nu[i];
  if (tid == 0) fail_out[b] = fail ? 1 : 0;
  float* lo = li_out + b * n * n;
  for (int i = wp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) lo[(size_t)i * n + j] = j <= i ? Li[i * ld + j] : 0.f;
  ADMM_PHASE_END(kPhLoad);
  ADMM_PHASE_END(kPhTotal);
}

template <int L>
__global__ void __launch_bounds__(kThreads<L>, kMinBlocks<L>) polish_kkt_kernel(POLISH_PARAMS) {
  polish_kkt_body<L, false>(POLISH_ARGS, PolishReuse{nullptr, nullptr, nullptr});
}

template <int L>
__global__ void __launch_bounds__(kThreads<L>, kMinBlocks<L>) polish_kkt_reuse_kernel(
    POLISH_PARAMS, PolishReuse reuse) {
  polish_kkt_body<L, true>(POLISH_ARGS, reuse);
}
#endif  // QP_KERNEL_AA_UNIT

// K3.  Replaces sqp_solver_tpu/ops/qp_kernel.py:qp_solve_kernel.
// Per problem: classify the rows, then the ADMM solve entered with a
// pending rho, so that its first epoch adopts rho0 (rho0 + 0 q_0: a NaN in
// q reaches the fail flag through the factorization) and factors M = P +
// sigma I + A' diag(rho) A in the block; rho epochs, chunks with early
// exit, adaptive rho and the infeasibility certificates, whose
// chunk-start iterates stay in shared memory (xp, yp).  Output x, z, y
// and stats (8, B): done, iter, res_prim, res_dual, fail, rho_updates,
// rho_estimate, infs.
// What bounds it on this card: as K1, per-problem latency at n = 16-32
// (each ADMM iteration is four dependent matvec phases with a barrier
// between them; the factor is a sequence of n column steps), and the
// O(n^3) factor loops at n = 128 with one block per SM.  The design keeps
// A, Minv and L^-1 (row stride n + 1) and every vector in shared memory,
// so the ADMM iterations never touch device memory; P, read once per
// chunk (residuals, certificates) and by the factor, stays in device
// memory (L1/L2 resident).  This block layout serves n > 32 or m > 64;
// smaller problems take the warp layout (qp_solve_warp_kernel).
// The body, with (AA) or without Anderson acceleration, and with SYS the
// step off the Gram area; the kernels qp_solve_kernel, qp_solve_kernel_aa
// and qp_solve_kernel_aas (qp_kernel_aa.cu) instantiate it.
#define QP_SOLVE_PARAMS                                                                       \
  StepParams p, const float* __restrict__ Pg, const float* __restrict__ Ag,                   \
      const float* __restrict__ qg, const float* __restrict__ lg, const float* __restrict__ ug, \
      const float* __restrict__ x0, const float* __restrict__ z0, const float* __restrict__ y0, \
      float* __restrict__ x_out, float* __restrict__ z_out, float* __restrict__ y_out,        \
      float* __restrict__ stats
#define QP_SOLVE_ARGS p, Pg, Ag, qg, lg, ug, x0, z0, y0, x_out, z_out, y_out, stats
template <bool AA, bool SYS = false>
__device__ __forceinline__ void qp_solve_body(QP_SOLVE_PARAMS, float* __restrict__ ws,
                                              AaArgs aa_args, AaSysArgs sys_args = {}) {
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int n = p.n, m = p.m, ld = n + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;

  float* q = smem;
  float* x = q + n;
  float* bt = x + n;
  float* xt = bt + n;
  float* tn1 = xt + n;
  float* tn2 = tn1 + n;
  float* xp = tn2 + n;  // 7 n
  float* z = xp + n;
  float* y = z + m;
  float* l = y + m;
  float* u = l + m;
  float* rv = u + m;
  float* tm = rv + m;
  float* yp = tm + m;  // 7 m
  float* red = yp + m;
  float* mats = red + kRedSlots;
  float* M[3];
  const int msize[3] = {n * ld, m * ld, n * ld};
  place(M, msize, mats, p.n_smem_mats, ws, p.ws_floats);
  float* W = M[0];
  float* A = M[1];
  float* Li = M[2];
  const float* Pb = Pg + b * n * n;

  for (int j = tid; j < n; j += T) {
    q[j] = qg[b * n + j];
    x[j] = x0[b * n + j];
  }
  for (int i = tid; i < m; i += T) {
    z[i] = z0[b * m + i];
    y[i] = y0[b * m + i];
    l[i] = lg[b * m + i];
    u[i] = ug[b * m + i];
  }
  for (int e = tid; e < m * n; e += T) {
    const int i = e / n, j = e - i * n;
    A[i * ld + j] = Ag[b * m * n + e];
  }
  __syncthreads();
  ADMM_PHASE_END(kPhLoad);

  AdmmState st;
  st.done = false;
  st.fail = false;
  st.pending = true;  // the first epoch factors
  st.itc = 0;
  st.rho_upd = 1;  // the reference counts the setup rho update
  st.nfact = 0;
  st.infs = 0;
  st.rp = st.rd = st.mz = st.mq = 0.f;
  st.rho = p.rho0 + 0.f * q[0];
  st.rho_est = st.rho;

  const DenseOp op{Pb, n, A, W, Li, ld, n, m, p.sigma};
  if constexpr (AA) {
    const AaState aa = aa_state(aa_args, smem, 0, b, n, m);
    if constexpr (SYS)
      admm_solve<DenseOp, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                              aa.ring, aa.k, aa.gram, aa_sys(sys_args, aa.k, smem, 0, b));
    else
      admm_solve<DenseOp, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                              aa.ring, aa.k, aa.gram);
  } else {
    admm_solve<DenseOp, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st);
  }

  ADMM_PHASE_BEGIN(kPhLoad);
  for (int j = tid; j < n; j += T) x_out[b * n + j] = x[j];
  for (int i = tid; i < m; i += T) {
    z_out[b * m + i] = z[i];
    y_out[b * m + i] = y[i];
  }
  if (tid == 0) {  // stats is (8, batch): one row per field
    const size_t B = gridDim.x;
    stats[0 * B + b] = st.done ? 1.f : 0.f;
    stats[1 * B + b] = (float)st.itc;
    stats[2 * B + b] = st.rp;
    stats[3 * B + b] = st.rd;
    stats[4 * B + b] = st.fail ? 1.f : 0.f;
    stats[5 * B + b] = (float)st.rho_upd;
    stats[6 * B + b] = st.rho_est;
    stats[7 * B + b] = (float)st.infs;
  }
  ADMM_PHASE_END(kPhLoad);
  ADMM_PHASE_END(kPhTotal);
}

#ifndef QP_KERNEL_AA_UNIT
__global__ void __launch_bounds__(256) qp_solve_kernel(QP_SOLVE_PARAMS, float* __restrict__ ws) {
  qp_solve_body<false>(QP_SOLVE_ARGS, ws, AaArgs{0, nullptr});
}
#else
// With Anderson the registers are capped at those of the kernel without it
// (64 a thread: 8 blocks an SM at 128 threads); the step took it to 121
// uncapped, 4 blocks an SM (cuobjdump, sm_90a).
__global__ void __launch_bounds__(256, 4) qp_solve_kernel_aa(QP_SOLVE_PARAMS,
                                                             float* __restrict__ ws,
                                                             AaArgs aa_args) {
  qp_solve_body<true>(QP_SOLVE_ARGS, ws, aa_args);
}
__global__ void __launch_bounds__(256, 4) qp_solve_kernel_aas(QP_SOLVE_PARAMS,
                                                              float* __restrict__ ws,
                                                              AaArgs aa_args,
                                                              AaSysArgs sys_args) {
  qp_solve_body<true, true>(QP_SOLVE_ARGS, ws, aa_args, sys_args);
}
#endif

// K3's warp layout: one warp a problem, kQpWarps problems a block, for
// n <= 32 and m <= 64 (qp_warp_layout, the one place that states the
// rule).  The block layout above gives such a problem 128 threads, of
// which the matvecs keep 32-33 busy between three barriers an iteration;
// here every lane works, the iteration waits on __syncwarp() only, and
// the reductions are shuffles.  The control logic is admm_core.cuh's
// admm_solve, instantiated with the warp scope (OpScope<WarpDenseOp>).
constexpr int kQpWarps = 2;  // problems a block

__host__ __device__ constexpr bool qp_warp_layout(int n, int m) { return n <= 32 && m <= 64; }

// The factor in the warp (K3's warp layout and K4's): lane i holds row i
// of the lower triangle of M in r (NM >= n columns unrolled), and the
// Cholesky, L^-1 and L^-T L^-1 run with the column factor's per-element
// operations (so the column factor's Minv, pivots and fail flag: d clamped
// to max(d, 1e-30), fail = d <= 0 | NaN), in W and the lanes' registers:
//   Cholesky  right-looking on those rows; column j goes through cb
//             (two n-vectors, one a column by turns), one store and one
//             barrier a column, read back as float4 broadcasts, so that
//             the column's loads overlap (that of cholesky_inplace);
//   L^-1      L's rows to W, lane c forms column c of L^-1 in registers by
//             forward substitution over L's rows as float4 broadcasts
//             (that of tri_inv);
//   L^-T L^-1 L^-1's columns to W as rows, lane j forms column j of Minv
//             in registers (row j: it is symmetric bit for bit), then
//             stores it (that of ltl).
// W (n rows, stride ld4) gets Minv, zero in its padding columns; it may
// hold M on entry (it is first written after the Cholesky's barriers).
template <int NM>
__device__ __forceinline__ bool warp_chol_inv_ltl(float (&r)[NM], float* W, float* cb, int ld4,
                                                  int n) {
  const int lane = threadIdx.x & 31;
  const int i = min(lane, n - 1);  // lanes past n shadow row n - 1, writing nothing
  const int n4 = round4(n);
  ADMM_PHASE_BEGIN(kPhChol);
  bool fail = false;
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    if (j < n) {
      float* col = cb + (j & 1) * n4;  // column j, unscaled
      if (lane < n) col[lane] = r[j];
      __syncwarp();
      const float d = col[j];
      fail = fail || (d <= 0.f) || isnan(d);
      const float dc = nan_max(d, 1e-30f);
      const float rs = rsqrtf(dc);
      r[j] = i > j ? r[j] * rs : (i == j ? sqrtf(dc) : r[j]);
      const float4* col4 = reinterpret_cast<const float4*>(col);
#pragma unroll
      for (int k4 = (j + 1) / 4; k4 < NM / 4; ++k4) {
        if (4 * k4 < n) {
          const float4 v = col4[k4];
          const float lk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int k = 4 * k4 + t;
            if (k > j && k < n && k <= i) r[k] = fmaf(-r[j], lk[t] * rs, r[k]);
          }
        }
      }
    }
  }
  // L's rows to W
  if (lane < n)
#pragma unroll
    for (int k = 0; k < NM; ++k)
      if (k < n) W[lane * ld4 + k] = k <= lane ? r[k] : 0.f;
  __syncwarp();
  ADMM_PHASE_END(kPhChol);

  ADMM_PHASE_BEGIN(kPhLinv);
  const int c = i;  // lane c: column c of L^-1, in r
#pragma unroll
  for (int ii = 0; ii < NM; ++ii) {
    if (ii < n) {
      const float4* row = reinterpret_cast<const float4*>(W + ii * ld4);
      float acc = 0.f;
#pragma unroll
      for (int k4 = 0; k4 < (ii + 3) / 4; ++k4) {
        const float4 v = row[k4];
        const float lk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int k = 4 * k4 + t;
          if (k < ii && k >= c) acc = fmaf(lk[t], r[k], acc);
        }
      }
      const float dgl = W[ii * ld4 + ii];
      r[ii] = ii < c ? 0.f : ((ii == c ? 1.f : 0.f) - acc) / nan_max(dgl, 1e-30f);
    }
  }
  __syncwarp();  // every lane is done with L's rows
  if (lane < n)
#pragma unroll
    for (int k = 0; k < NM; ++k)
      if (k < n) W[lane * ld4 + k] = r[k];
  __syncwarp();
  ADMM_PHASE_END(kPhLinv);

  ADMM_PHASE_BEGIN(kPhLtl);
  const int jc = lane;  // lane j: column j of Minv, from column j of L^-1 (r)
  float mc[NM];
#pragma unroll
  for (int ii = 0; ii < NM; ++ii) {
    mc[ii] = 0.f;
    if (ii < n) {
      const float4* row = reinterpret_cast<const float4*>(W + ii * ld4);  // column ii of L^-1
      const int k0 = max(ii, jc);
      float acc = 0.f;
#pragma unroll
      for (int k4 = ii / 4; k4 < NM / 4; ++k4) {
        if (4 * k4 < n) {
          const float4 v = row[k4];
          const float lk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            const int k = 4 * k4 + t;
            if (k >= k0 && k < n) acc = fmaf(lk[t], r[k], acc);
          }
        }
      }
      mc[ii] = acc;
    }
  }
  __syncwarp();  // every lane is done with L^-1's columns
  if (jc < n4)
#pragma unroll
    for (int ii = 0; ii < NM; ++ii)
      if (ii < n) W[ii * ld4 + jc] = jc < n ? mc[ii] : 0.f;
  __syncwarp();
  ADMM_PHASE_END(kPhLtl);
  return fail;
}

// K3's factor in the warp: Minv of M = P + sigma I + A' diag(w) A.  Lane i
// builds row i of M in registers, each row of A read as float4 broadcasts
// (the fmaf chain of schur_build), then warp_chol_inv_ltl.
template <int NM>
__device__ bool warp_factor_minv(float* W, float* cb, int ld4, const float* P, const float* A,
                                 const float* w, float sigma, int n, int m) {
  const int lane = threadIdx.x & 31;
  const int i = min(lane, n - 1);  // lanes past n shadow row n - 1, writing nothing
  float r[NM];
  ADMM_PHASE_BEGIN(kPhGram);
#pragma unroll
  for (int k = 0; k < NM; ++k) r[k] = 0.f;
  for (int kp = 0; kp < m; ++kp) {
    const float a = A[kp * ld4 + i] * w[kp];
    const float4* row = reinterpret_cast<const float4*>(A + kp * ld4);
#pragma unroll
    for (int c = 0; c < NM / 4; ++c) {
      if (4 * c < n) {
        const float4 v = row[c];
        r[4 * c] = fmaf(a, v.x, r[4 * c]);
        r[4 * c + 1] = fmaf(a, v.y, r[4 * c + 1]);
        r[4 * c + 2] = fmaf(a, v.z, r[4 * c + 2]);
        r[4 * c + 3] = fmaf(a, v.w, r[4 * c + 3]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < NM; ++k)
    if (k < n && k <= i) r[k] = __ldg(P + (size_t)i * n + k) + (i == k ? sigma : 0.f) + r[k];
  ADMM_PHASE_END(kPhGram);
  return warp_chol_inv_ltl<NM>(r, W, cb, ld4, n);
}

// The warp's operator.  A (m rows, 4-float-padded, stride ld4 = 4 x odd)
// and Minv (in W, stride ld4) in the warp's slice of shared memory, zero
// past their columns (and A past its rows), so that a lane reads its row
// as float4s without bank conflicts and the vector operand as float4
// broadcasts.  Lane i owns row i of A and Minv, lane j column j of A;
// rows of A past the 32nd go lane-split with a warp sum while there are
// at most kSplitRows of them (m = 33: one), else one lane a row.  Each
// lane's dot product is one fmaf chain in the block layout's order
// (DenseOp, mv), the padding adding exact zeros, so that with m <= 32 the
// warp layout's iterates are the block layout's bit for bit (past the
// 32nd row, the lane-split rows and the certificates' sums take another
// order).  P (read per chunk and per factor) stays in device memory.
constexpr int kSplitRows = 4;

// sum_k row[k] v[k], k < 4 n4, in one fmaf chain in k order; row and v
// 16-byte aligned and zero past their length.  Unrolled by four, so that
// the loads of four steps go first.
__device__ __forceinline__ float dot4_chain(const float* row, const float* v, int n4) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < n4; ++k) {
    const float4 r = r4[k], x = v4[k];
    acc = fmaf(r.x, x.x, acc);
    acc = fmaf(r.y, x.y, acc);
    acc = fmaf(r.z, x.z, acc);
    acc = fmaf(r.w, x.w, acc);
  }
  return acc;
}

template <int NM>
struct WarpDenseOp {
  const float* P;
  const float* A;
  float* W;
  float* cb;  // 2 n4 floats of scratch for the factor's columns
  int ld4, n, m;
  float sigma;

  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    const int j = min((int)(threadIdx.x & 31), n - 1);
    const float4* w4 = reinterpret_cast<const float4*>(w);
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < round4(m) >> 2; ++k) {
      const float4 x = w4[k];
      const float* c = A + 4 * k * ld4 + j;
      acc = fmaf(c[0], x.x, acc);
      acc = fmaf(c[ld4], x.y, acc);
      acc = fmaf(c[2 * ld4], x.z, acc);
      acc = fmaf(c[3 * ld4], x.w, acc);
    }
    if ((int)(threadIdx.x & 31) < n) epi(j, acc);
  }
  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    const int lane = threadIdx.x & 31, n4 = round4(n) >> 2;
    if (lane < m) epi(lane, dot4_chain(A + lane * ld4, v, n4));
    if (m - 32 > kSplitRows) {
      if (32 + lane < m) epi(32 + lane, dot4_chain(A + (32 + lane) * ld4, v, n4));
    } else {
      for (int i = 32; i < m; ++i) {
        const float a = warp_sum(lane < n ? A[i * ld4 + lane] * v[lane] : 0.f);
        if (lane == (i & 31)) epi(i, a);
      }
    }
  }
  __device__ void pmv(const float* v, float* out) const {
    const int i = threadIdx.x & 31;
    if (i < n) {
      const float* r = P + (size_t)i * n;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < n; ++j) acc = fmaf(__ldg(r + j), v[j], acc);
      out[i] = acc;
    }
  }
  __device__ void apply_minv(const float* b, float* out) const {
    const int i = threadIdx.x & 31;
    if (i < n) out[i] = dot4_chain(W + i * ld4, b, round4(n) >> 2);
  }
  __device__ bool factor(const float* rv) const {
    return warp_factor_minv<NM>(W, cb, ld4, P, A, rv, sigma, n, m);
  }
};
template <int NM>
struct OpScope<WarpDenseOp<NM>> {
  using type = WarpScope;
};
template <int NM>
__device__ __forceinline__ void op_factor_mark(const WarpDenseOp<NM>&, bool) {}
// Reductions over the warp by shuffles; a sum is taken from lane 0, so
// that every lane holds the same value.
template <int NM, int K>
__device__ __forceinline__ void op_max(const WarpDenseOp<NM>&, float (&v)[K], float*) {
#pragma unroll
  for (int k = 0; k < K; ++k)
    for (int o = 16; o > 0; o >>= 1) v[k] = nan_max(v[k], __shfl_xor_sync(kFull, v[k], o));
}
template <int NM, int K>
__device__ __forceinline__ void op_sum(const WarpDenseOp<NM>&, float (&v)[K], float*) {
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = __shfl_sync(kFull, warp_sum(v[k]), 0);
}

// Floats of one warp's slice: seven n-vectors and seven m-vectors (padded
// to 4), then A (m rounded to 4 rows) and W (n rows), with stride ld4.
__host__ __device__ constexpr int qp_warp_floats(int n, int m) {
  return 7 * round4(n) + 7 * round4(m) + (round4(m) + n) * stride4(n);
}

// K3, warp layout: the same computation as qp_solve_kernel per problem;
// NM (16 or 32) >= n unrolls the factor's registers.
// The body, with (AA) or without Anderson acceleration; the kernels
// qp_solve_warp_kernel and qp_solve_warp_kernel_aa (qp_kernel_aa.cu)
// instantiate it.
#define QP_WARP_PARAMS                                                                         \
  StepParams p, int batch, const float* __restrict__ Pg, const float* __restrict__ Ag,         \
      const float* __restrict__ qg, const float* __restrict__ lg, const float* __restrict__ ug, \
      const float* __restrict__ x0, const float* __restrict__ z0, const float* __restrict__ y0, \
      float* __restrict__ x_out, float* __restrict__ z_out, float* __restrict__ y_out,         \
      float* __restrict__ stats
#define QP_WARP_ARGS p, batch, Pg, Ag, qg, lg, ug, x0, z0, y0, x_out, z_out, y_out, stats
template <int NM, bool AA, bool SYS = false>
__device__ __forceinline__ void qp_solve_warp_body(QP_WARP_PARAMS, AaArgs aa_args,
                                                   AaSysArgs sys_args = {}) {
  extern __shared__ float4 smem4[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int n = p.n, m = p.m, ld4 = stride4(n);
  const int n4 = round4(n), m4 = round4(m);
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const size_t b = (size_t)blockIdx.x * kQpWarps + wp;
  if constexpr (SYS) {  // a block's solve area starts unlocked
    if (sys_args.solve == kAaSolveBlock) {
      if (threadIdx.x == 0)
        *reinterpret_cast<int*>(reinterpret_cast<float*>(smem4) + sys_args.sys_off - 1) = 0;
      __syncthreads();
    }
  }
  if (b >= (size_t)batch) return;  // no block barrier below: a warp may leave
  float* q = reinterpret_cast<float*>(smem4) + (size_t)wp * qp_warp_floats(n, m);
  float* x = q + n4;
  float* bt = x + n4;
  float* xt = bt + n4;
  float* tn1 = xt + n4;
  float* tn2 = tn1 + n4;
  float* xp = tn2 + n4;  // 7 n4
  float* z = xp + n4;
  float* y = z + m4;
  float* l = y + m4;
  float* u = l + m4;
  float* rv = u + m4;
  float* tm = rv + m4;
  float* yp = tm + m4;  // 7 m4
  float* A = yp + m4;
  float* W = A + m4 * ld4;

  copy_rows_async(A, ld4, Ag + b * m * n, m, n, 0, 1, lane);
  for (int i = 0; i < m4; ++i)  // A's padding: the columns past n, the rows past m
    for (int j = (i < m ? n : 0) + lane; j < n4; j += 32) A[i * ld4 + j] = 0.f;
  for (int j = lane; j < n4; j += 32) {
    const bool in = j < n;
    q[j] = in ? qg[b * n + j] : 0.f;
    x[j] = in ? x0[b * n + j] : 0.f;
    bt[j] = xt[j] = tn1[j] = tn2[j] = xp[j] = 0.f;
  }
  for (int i = lane; i < m4; i += 32) {
    const bool in = i < m;
    z[i] = in ? z0[b * m + i] : 0.f;
    y[i] = in ? y0[b * m + i] : 0.f;
    l[i] = in ? lg[b * m + i] : 0.f;
    u[i] = in ? ug[b * m + i] : 0.f;
    rv[i] = tm[i] = yp[i] = 0.f;
  }
  cp_async_wait_all();
  __syncwarp();
  ADMM_PHASE_END(kPhLoad);

  AdmmState st;
  st.done = false;
  st.fail = false;
  st.pending = true;  // the first epoch factors
  st.itc = 0;
  st.rho_upd = 1;  // the reference counts the setup rho update
  st.nfact = 0;
  st.infs = 0;
  st.rp = st.rd = st.mz = st.mq = 0.f;
  st.rho = p.rho0 + 0.f * q[0];
  st.rho_est = st.rho;

  // the factor's column buffer: tn1 and tn2, free while it runs
  const WarpDenseOp<NM> op{Pg + b * n * n, A, W, tn1, ld4, n, m, p.sigma};
  if constexpr (AA) {
    float* sm = reinterpret_cast<float*>(smem4);
    const AaState aa = aa_state(aa_args, sm, wp, b, n, m);
    if constexpr (SYS)
      admm_solve<WarpDenseOp<NM>, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp,
                                      nullptr, st, aa.ring, aa.k, aa.gram,
                                      aa_sys(sys_args, aa.k, sm, wp, b));
    else
      admm_solve<WarpDenseOp<NM>, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp,
                                      nullptr, st, aa.ring, aa.k, aa.gram);
  } else {
    admm_solve<WarpDenseOp<NM>, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp,
                                    nullptr, st);
  }

  ADMM_PHASE_BEGIN(kPhLoad);
  for (int j = lane; j < n; j += 32) x_out[b * n + j] = x[j];
  for (int i = lane; i < m; i += 32) {
    z_out[b * m + i] = z[i];
    y_out[b * m + i] = y[i];
  }
  if (lane == 0) {  // stats is (8, batch): one row per field
    const size_t B = batch;
    stats[0 * B + b] = st.done ? 1.f : 0.f;
    stats[1 * B + b] = (float)st.itc;
    stats[2 * B + b] = st.rp;
    stats[3 * B + b] = st.rd;
    stats[4 * B + b] = st.fail ? 1.f : 0.f;
    stats[5 * B + b] = (float)st.rho_upd;
    stats[6 * B + b] = st.rho_est;
    stats[7 * B + b] = (float)st.infs;
  }
  ADMM_PHASE_END(kPhLoad);
  ADMM_PHASE_END(kPhTotal);
}

#ifndef QP_KERNEL_AA_UNIT
template <int NM>
__global__ void __launch_bounds__(32 * kQpWarps) qp_solve_warp_kernel(QP_WARP_PARAMS) {
  qp_solve_warp_body<NM, false>(QP_WARP_ARGS, AaArgs{0, nullptr});
}
#else
// With Anderson the registers are capped at those of the kernel without it
// (128 a thread, 8 blocks an SM): uncapped, the step took the kernel to
// 237 a thread and 4 blocks an SM (cuobjdump, sm_90a).
template <int NM>
__global__ void __launch_bounds__(32 * kQpWarps, 8) qp_solve_warp_kernel_aa(QP_WARP_PARAMS,
                                                                           AaArgs aa_args) {
  qp_solve_warp_body<NM, true>(QP_WARP_ARGS, aa_args);
}
template <int NM>
__global__ void __launch_bounds__(32 * kQpWarps, 8) qp_solve_warp_kernel_aas(
    QP_WARP_PARAMS, AaArgs aa_args, AaSysArgs sys_args) {
  qp_solve_warp_body<NM, true, true>(QP_WARP_ARGS, aa_args, sys_args);
}
#endif

#ifndef QP_KERNEL_AA_UNIT
// K4.  Replaces sqp_solver_tpu/ops/qp_kernel.py:spd_inverse_kernel.
// Per problem: the lower triangle of M, Cholesky with the pivot clamp
// max(d, 1e-30) and fail = (d <= 0 | NaN), L^-1, then Minv = L^-T L^-1,
// written in full.  M is read once and Minv and fail are written once.
// What bounds it on this card: per-problem latency at n <= 32 (a chain of
// n column steps; 4 KB in, 4 KB out), the O(n^3) factor at n = 128 (about
// n^3 flops a problem, one block each).  The design has two layouts, by
// spd_rule_arm:
//   n <= 32   one warp a problem, several a block (spd_inverse_warp_kernel):
//             M's lower triangle in flight by cp.async into the warp's
//             slice, lane i's row into registers, then K3's warp factor
//             (warp_chol_inv_ltl: the column factor's per-element
//             operations, so the outputs are the column kernel's bit for
//             bit), Minv stored by rows as float4s;
//   n > 32    one block of 128 threads a problem
//             (spd_inverse_blocked_kernel): the blocked factor of
//             dense_factor.cuh (chol_blocked, the panels' order of K1 and
//             K2), L^-1 and L^-T L^-1 in place in the same one matrix
//             (tri_inv_inplace, ltl_inplace), so that a block holds
//             n (n + 1) floats: 66 KB at n = 128, three blocks an SM, and
//             shared memory up to n = 240; larger n works in the
//             per-problem workspace.
// The column kernel (the earlier design: cholesky_inplace, tri_inv, ltl
// over two matrices, 256 threads a problem) and the two-buffer blocked
// factor (K1's calls) stay as the two arms the raw launcher can force:
// the references that the warp layout and the in-place factor equal bit
// for bit, for the A/B tool and the card's tests.
__global__ void __launch_bounds__(256) spd_inverse_column_kernel(
    int n, int n_smem_mats, long long ws_floats, const float* __restrict__ Mg,
    float* __restrict__ minv_out, uint8_t* __restrict__ fail_out, float* __restrict__ ws) {
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int ld = n + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  float* red = smem;
  float* mats = red + kRedSlots;
  float* M[3];
  const int msize[3] = {n * ld, n * ld, 0};
  place(M, msize, mats, n_smem_mats, ws, ws_floats);
  float* W = M[0];
  float* Li = M[1];
  const float* Mb = Mg + b * n * n;
  for (int e = tid; e < n * n; e += T) {
    const int i = e / n, j = e - i * n;
    if (j <= i) W[i * ld + j] = Mb[e];
  }
  __syncthreads();
  ADMM_PHASE_END(kPhLoad);
  const bool fail = cholesky_inplace(W, ld, n);
  tri_inv(W, ld, Li, ld, n);
  ltl(Li, ld, W, ld, n);
  ADMM_PHASE_BEGIN(kPhLoad);
  float* mo = minv_out + b * n * n;
  for (int e = tid; e < n * n; e += T) {
    const int i = e / n, j = e - i * n;
    mo[e] = W[i * ld + j];
  }
  if (tid == 0) fail_out[b] = fail ? 1 : 0;
  ADMM_PHASE_END(kPhLoad);
  ADMM_PHASE_END(kPhTotal);
}

// Floats of one warp's slice in K4's warp layout: M, then L, L^-1 and
// Minv in turn (n rows, stride ld4), and the factor's column buffer.
__host__ __device__ constexpr int spd_warp_floats(int n) { return n * stride4(n) + 2 * round4(n); }

// K4, warp layout: kSpdWarps problems a block, NM (16 or 32) >= n
// unrolling the factor's registers.  On an H100 at n = 32, 2, 4 and 8
// problems a block ran within 5 % of each other.
constexpr int kSpdWarps = 8;

template <int NM>
__global__ void __launch_bounds__(32 * kSpdWarps) spd_inverse_warp_kernel(
    int n, int batch, const float* __restrict__ Mg, float* __restrict__ minv_out,
    uint8_t* __restrict__ fail_out) {
  extern __shared__ float4 smem4[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int ld4 = stride4(n);
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
  const size_t b = (size_t)blockIdx.x * kSpdWarps + wp;
  if (b >= (size_t)batch) return;  // no block barrier below: a warp may leave
  float* W = reinterpret_cast<float*>(smem4) + (size_t)wp * spd_warp_floats(n);
  float* cb = W + n * ld4;
  const float* Mb = Mg + b * n * n;
  // the lower triangle in flight at once: 16 bytes a copy where every row
  // is 16-byte aligned, else 4
  if ((n & 3) == 0 && ((uintptr_t)Mb & 15) == 0) {
    const int c4 = n >> 2;
    for (int e = lane; e < n * c4; e += 32) {
      const int i = e / c4, k = e - i * c4;
      if (4 * k <= i) cp_async16(W + i * ld4 + 4 * k, Mb + (size_t)i * n + 4 * k);
    }
  } else {
    for (int e = lane; e < n * n; e += 32) {
      const int i = e / n, j = e - i * n;
      if (j <= i) cp_async4(W + i * ld4 + j, Mb + e);
    }
  }
  cp_async_wait_all();
  __syncwarp();
  const int i = min(lane, n - 1);  // lanes past n shadow row n - 1
  float r[NM];
  const float4* row = reinterpret_cast<const float4*>(W + i * ld4);
#pragma unroll
  for (int c = 0; c < NM / 4; ++c) {
    const float4 v = 4 * c < n ? row[c] : make_float4(0.f, 0.f, 0.f, 0.f);
    const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) r[4 * c + t] = (4 * c + t < n && 4 * c + t <= i) ? e4[t] : 0.f;
  }
  ADMM_PHASE_END(kPhLoad);
  const bool fail = warp_chol_inv_ltl<NM>(r, W, cb, ld4, n);
  ADMM_PHASE_BEGIN(kPhLoad);
  float* mo = minv_out + b * n * n;
  if ((n & 3) == 0) {  // by rows, 16 bytes a lane
    const int c4 = n >> 2;
    for (int e = lane; e < n * c4; e += 32) {
      const int ii = e / c4, k = e - ii * c4;
      reinterpret_cast<float4*>(mo + (size_t)ii * n)[k] =
          reinterpret_cast<const float4*>(W + ii * ld4)[k];
    }
  } else {
    for (int e = lane; e < n * n; e += 32) {
      const int ii = e / n, j = e - ii * n;
      mo[e] = W[ii * ld4 + j];
    }
  }
  if (lane == 0) fail_out[b] = fail ? 1 : 0;
  ADMM_PHASE_END(kPhLoad);
  ADMM_PHASE_END(kPhTotal);
}

// K4, blocked layout: one block of kSpdThreads threads a problem, Q = 2
// register tiles in chol_blocked's SYRK, registers capped for three blocks
// an SM.  On an H100 at n = 128 this beat 256 threads with Q = 4 at two or
// three blocks an SM (whose register caps spill) and the two-buffer
// factor (one block an SM).  kInPlace: L^-1 and Minv in the one matrix W;
// else L^-1 in a second (the two-buffer arm: K1's tri_inv_blocked and
// ltl_tiles).
constexpr int kSpdThreads = 128;

template <bool kInPlace>
__global__ void __launch_bounds__(kSpdThreads, 3) spd_inverse_blocked_kernel(
    int n, int n_smem_mats, long long ws_floats, const float* __restrict__ Mg,
    float* __restrict__ minv_out, uint8_t* __restrict__ fail_out, float* __restrict__ ws) {
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int ld = n + 1;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5, nw = kSpdThreads >> 5;
  float* red = smem;
  float* M[2];
  const int msize[2] = {n * ld, kInPlace ? 0 : n * ld};
  place(M, msize, smem + kRedSlots, n_smem_mats, ws, ws_floats);
  float* W = M[0];
  const float* Mb = Mg + b * n * n;
  if (n_smem_mats > 0) {  // the lower triangle in flight at once
    for (int i = wp; i < n; i += nw)
      for (int j = lane; j <= i; j += 32) cp_async4(W + i * ld + j, Mb + (size_t)i * n + j);
    cp_async_wait_all();
  } else {
    map_rows(Mb, n, n, n, true, [&](int i, int j, float a) { W[i * ld + j] = a; });
  }
  __syncthreads();
  ADMM_PHASE_END(kPhLoad);
  const bool fail = chol_blocked<2>(W, ld, n, red);
  if (kInPlace) {
    tri_inv_inplace(W, ld, n);
    ltl_inplace(W, ld, n);
  } else {
    tri_inv_blocked(W, ld, M[1], ld, n, false);
    ltl_tiles<2>(M[1], ld, W, ld, n);
  }
  ADMM_PHASE_BEGIN(kPhLoad);
  float* mo = minv_out + b * n * n;
  for (int i = wp; i < n; i += nw)
    for (int j = lane; j < n; j += 32) mo[(size_t)i * n + j] = W[i * ld + j];
  if (tid == 0) fail_out[b] = fail ? 1 : 0;
  ADMM_PHASE_END(kPhLoad);
  ADMM_PHASE_END(kPhTotal);
}

#endif  // QP_KERNEL_AA_UNIT

// K4's arms: the rule's, or one of the two forced by the raw launcher's
// A/B argument (the column kernel, the two-buffer blocked factor), and the
// two that the rule picks.
enum SpdArm { kSpdRule, kSpdColumn, kSpdTwoBuffer, kSpdWarp, kSpdBlocked };

// The rule, its one place: the warp layout where the warp factor's
// registers hold a row (n <= 32), else the blocked layout in place.
constexpr int spd_rule_arm(int n) { return n <= 32 ? kSpdWarp : kSpdBlocked; }

struct Layout {
  size_t smem_bytes;
  int n_smem_mats;
  long long ws_floats;
};

Layout plan(long long vec_floats, const long long (&mats)[3]) {
  Layout L;
  L.smem_bytes = (size_t)vec_floats * sizeof(float);
  L.n_smem_mats = 0;
  L.ws_floats = 0;
  bool spill = false;
  for (int k = 0; k < 3; ++k) {
    const size_t bytes = (size_t)mats[k] * sizeof(float);
    if (!spill && L.smem_bytes + bytes <= (size_t)kMaxSmemBytes) {
      L.smem_bytes += bytes;
      L.n_smem_mats += 1;
    } else {
      spill = true;
      L.ws_floats += mats[k];
    }
  }
  return L;
}

Layout step_layout(int n, int m) {
  const long long ld = n + 1;
  const long long mats[3] = {n * ld, m * ld, n * ld};
  return plan(9LL * n + 7LL * m + kRedSlots, mats);
}

Layout polish_layout(int n, int m) {
  const long long ld = n + 1;
  const long long mats[3] = {n * ld, n * ld, m * ld};
  return plan(6LL * n + 7LL * m + kRedSlots, mats);
}

Layout qp_layout(int n, int m) {
  const long long ld = n + 1;
  const long long mats[3] = {n * ld, m * ld, n * ld};
  return plan(7LL * n + 7LL * m + kRedSlots, mats);
}

// K4's blocked layouts: W alone (in place), or W and L^-1 (the column
// kernel, the two-buffer arm).  The warp layout has no workspace.
Layout spd_layout(int arm, int n) {
  const long long ld = n + 1;
  const bool two = arm == kSpdColumn || arm == kSpdTwoBuffer;
  const long long mats[3] = {n * ld, two ? n * ld : 0, 0};
  return plan(kRedSlots, mats);
}

int threads_for(int n, int m) { return (n <= 64 && m <= 64) ? 128 : 256; }

// The kernels with an Anderson instantiation, as the placement functions
// name them.
enum AaKernel { kAaK1 = 1, kAaK3Block = 2, kAaK3Warp = 3 };

template <typename Kernel>
cudaError_t set_smem(Kernel k, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The ADMM core's parameters of one launch of K1 or K3, without Anderson.
StepParams step_params(int n, int m, float sigma, float alpha, float rho0, float eps_abs,
                       float eps_rel, int n_epochs, int chunks_per_epoch, int seg,
                       int adaptive_rho, float adaptive_rho_tolerance, int do_bfgs,
                       int check_infeas, float eps_pinf, float eps_dinf, const Layout& L) {
  StepParams p;
  p.n = n;
  p.m = m;
  p.sigma = sigma;
  p.alpha = alpha;
  p.rho0 = rho0;
  p.eps_abs = eps_abs;
  p.eps_rel = eps_rel;
  p.n_epochs = n_epochs;
  p.chunks_per_epoch = chunks_per_epoch;
  p.seg = seg;
  p.adaptive_rho = adaptive_rho;
  p.adaptive_rho_tolerance = adaptive_rho_tolerance;
  p.do_bfgs = do_bfgs;
  p.check_infeas = check_infeas;
  p.eps_pinf = eps_pinf;
  p.eps_dinf = eps_dinf;
  p.n_smem_mats = L.n_smem_mats;
  p.ws_floats = L.ws_floats;
  return p;
}

#ifndef QP_KERNEL_AA_UNIT
// A K4 arm's kernel and launch shape at n.
struct SpdLaunch {
  const void* kernel;
  int threads, per_block;
  size_t smem_bytes;
  Layout L;
};

// The arm's launch (arm already resolved from the rule).
SpdLaunch spd_launch_of(int arm, int n) {
  SpdLaunch s;
  s.per_block = 1;
  s.threads = kSpdThreads;
  if (arm == kSpdWarp) {
    s.kernel = n <= 16 ? (const void*)spd_inverse_warp_kernel<16>
                       : (const void*)spd_inverse_warp_kernel<32>;
    s.threads = 32 * kSpdWarps;
    s.per_block = kSpdWarps;
    s.smem_bytes = (size_t)kSpdWarps * spd_warp_floats(n) * sizeof(float);
    s.L = Layout{s.smem_bytes, 0, 0};
    return s;
  }
  if (arm == kSpdColumn) {
    s.kernel = (const void*)spd_inverse_column_kernel;
    s.threads = threads_for(n, n);
  } else {
    s.kernel = arm == kSpdBlocked ? (const void*)spd_inverse_blocked_kernel<true>
                                  : (const void*)spd_inverse_blocked_kernel<false>;
  }
  s.L = spd_layout(arm, n);
  s.smem_bytes = s.L.smem_bytes;
  return s;
}

// The launch of a caller's arm (the rule's, or a forced one): kernel null
// for any other code.
SpdLaunch spd_launch_as(int arm, int n) {
  if (arm == kSpdRule) return spd_launch_of(spd_rule_arm(n), n);
  if (arm == kSpdColumn || arm == kSpdTwoBuffer) return spd_launch_of(arm, n);
  SpdLaunch none{};
  return none;
}

// An arm's kernel attributes: shared memory past 48 KB, and the largest
// shared-memory carveout, so that as many blocks an SM fit as it allows.
cudaError_t spd_prepare(const SpdLaunch& s) {
  cudaError_t err = set_smem(s.kernel, s.smem_bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(s.kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}
#endif  // QP_KERNEL_AA_UNIT

}  // namespace

#ifndef QP_KERNEL_AA_UNIT
extern "C" {

long long sqp_step_workspace_floats(int n, int m) { return step_layout(n, m).ws_floats; }

long long polish_kkt_workspace_floats(int n, int m) { return polish_layout(n, m).ws_floats; }

long long qp_solve_workspace_floats(int n, int m) { return qp_layout(n, m).ws_floats; }

long long spd_inverse_workspace_floats(int n) { return spd_launch_as(kSpdRule, n).L.ws_floats; }

long long spd_inverse_workspace_floats_as(int arm, int n) {
  return spd_launch_as(arm, n).L.ws_floats;
}

const char* qp_kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int sqp_step_launch(const float* Bp, const float* J, const float* g, const float* l,
                    const float* u, const float* s, const float* dgl, const uint8_t* reset,
                    const uint8_t* upd, const uint8_t* active, const float* rho_in,
                    const float* minv_in, const float* x0, const float* z0, const float* y0,
                    float* p_out, float* z_out, float* y_out, float* B_out, float* stats,
                    float* minv_out, float* ws, int batch, int n, int m, float sigma,
                    float alpha, float rho0, float eps_abs, float eps_rel, int n_epochs,
                    int chunks_per_epoch, int seg, int adaptive_rho,
                    float adaptive_rho_tolerance, int do_bfgs, int device, void* stream) {
  if (batch <= 0) return 0;
  const Layout L = step_layout(n, m);
  if (L.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  // this library's runtime keeps its own current device: use the tensors'
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = threads_for(n, m);
  // 4 lanes a dot product at 128 threads, 2 at 256
  auto kernel = threads == 128 ? sqp_step_kernel<4> : sqp_step_kernel<2>;
  err = set_smem(kernel, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const StepParams p = step_params(n, m, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs,
                                   chunks_per_epoch, seg, adaptive_rho, adaptive_rho_tolerance,
                                   do_bfgs, 0, 0.f, 0.f, L);
  kernel<<<batch, threads, L.smem_bytes, (cudaStream_t)stream>>>(
      p, Bp, J, g, l, u, s, dgl, reset, upd, active, rho_in, minv_in, x0, z0, y0, p_out,
      z_out, y_out, B_out, stats, minv_out, ws);
  return (int)cudaGetLastError();
}

int polish_kkt_launch(const float* H, const float* J, const uint8_t* act, const float* r1,
                      const float* b, const float* nu0, const float* x0, float* x_out,
                      float* nu_out, uint8_t* fail_out, float* li_out, float* ws, int batch,
                      int n, int m, float delta, int sweeps, int device, void* stream) {
  if (batch <= 0) return 0;
  const Layout L = polish_layout(n, m);
  if (L.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = threads_for(n, m);
  // 4 lanes a dot product at 128 threads, 2 at 256
  auto kernel = threads == 128 ? polish_kkt_kernel<4> : polish_kkt_kernel<2>;
  err = set_smem(kernel, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, threads, L.smem_bytes, (cudaStream_t)stream>>>(
      n, m, delta, sweeps, L.n_smem_mats, L.ws_floats, H, J, act, r1, b, nu0, x0, x_out,
      nu_out, fail_out, li_out, ws);
  return (int)cudaGetLastError();
}

// polish_kkt_launch with factor reuse: a problem whose act equals act_prev
// takes li_prev (B, n, n) as its L^-1 and fail_prev (B,; nullptr: false)
// as its fail flag instead of factoring.
int polish_kkt_launch_reuse(const float* H, const float* J, const uint8_t* act,
                            const float* r1, const float* b, const float* nu0, const float* x0,
                            const uint8_t* act_prev, const float* li_prev,
                            const uint8_t* fail_prev, float* x_out, float* nu_out,
                            uint8_t* fail_out, float* li_out, float* ws, int batch, int n,
                            int m, float delta, int sweeps, int device, void* stream) {
  if (batch <= 0) return 0;
  if (act_prev == nullptr || li_prev == nullptr) return (int)cudaErrorInvalidValue;
  const Layout L = polish_layout(n, m);
  if (L.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int threads = threads_for(n, m);
  auto kernel = threads == 128 ? polish_kkt_reuse_kernel<4> : polish_kkt_reuse_kernel<2>;
  err = set_smem(kernel, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<batch, threads, L.smem_bytes, (cudaStream_t)stream>>>(
      n, m, delta, sweeps, L.n_smem_mats, L.ws_floats, H, J, act, r1, b, nu0, x0, x_out,
      nu_out, fail_out, li_out, ws, PolishReuse{act_prev, li_prev, fail_prev});
  return (int)cudaGetLastError();
}

// layout: 0 by qp_warp_layout, 1 the block layout, 2 the warp layout
// (which refuses a shape outside its range).
int qp_solve_launch_as(int layout, const float* P, const float* A, const float* q,
                       const float* l, const float* u, const float* x0, const float* z0,
                       const float* y0, float* x_out, float* z_out, float* y_out, float* stats,
                       float* ws, int batch, int n, int m, float sigma, float alpha,
                       float rho0, float eps_abs, float eps_rel, int n_epochs,
                       int chunks_per_epoch, int seg, int adaptive_rho,
                       float adaptive_rho_tolerance, int check_infeas, float eps_pinf,
                       float eps_dinf, int device, void* stream) {
  if (batch <= 0) return 0;
  if (layout < 0 || layout > 2 || (layout == 2 && !qp_warp_layout(n, m)))
    return (int)cudaErrorInvalidValue;
  const bool warp = layout == 2 || (layout == 0 && qp_warp_layout(n, m));
  const Layout L = qp_layout(n, m);
  if (!warp && L.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const size_t warp_bytes = (size_t)kQpWarps * qp_warp_floats(n, m) * sizeof(float);
  auto warp_kernel = n <= 16 ? qp_solve_warp_kernel<16> : qp_solve_warp_kernel<32>;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = warp ? set_smem(warp_kernel, warp_bytes) : set_smem(qp_solve_kernel, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const StepParams p = step_params(n, m, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs,
                                   chunks_per_epoch, seg, adaptive_rho, adaptive_rho_tolerance, 0,
                                   check_infeas, eps_pinf, eps_dinf, L);
  if (warp) {
    const int blocks = (batch + kQpWarps - 1) / kQpWarps;
    warp_kernel<<<blocks, 32 * kQpWarps, warp_bytes, (cudaStream_t)stream>>>(
        p, batch, P, A, q, l, u, x0, z0, y0, x_out, z_out, y_out, stats);
  } else {
    qp_solve_kernel<<<batch, threads_for(n, m), L.smem_bytes, (cudaStream_t)stream>>>(
        p, P, A, q, l, u, x0, z0, y0, x_out, z_out, y_out, stats, ws);
  }
  return (int)cudaGetLastError();
}

int qp_solve_launch(const float* P, const float* A, const float* q, const float* l,
                    const float* u, const float* x0, const float* z0, const float* y0,
                    float* x_out, float* z_out, float* y_out, float* stats, float* ws,
                    int batch, int n, int m, float sigma, float alpha, float rho0,
                    float eps_abs, float eps_rel, int n_epochs, int chunks_per_epoch, int seg,
                    int adaptive_rho, float adaptive_rho_tolerance, int check_infeas,
                    float eps_pinf, float eps_dinf, int device, void* stream) {
  return qp_solve_launch_as(0, P, A, q, l, u, x0, z0, y0, x_out, z_out, y_out, stats, ws,
                            batch, n, m, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs,
                            chunks_per_epoch, seg, adaptive_rho, adaptive_rho_tolerance,
                            check_infeas, eps_pinf, eps_dinf, device, stream);
}

int qp_solve_problems_per_block(int n, int m) { return qp_warp_layout(n, m) ? kQpWarps : 1; }

// Blocks an SM that the runtime can hold of the kernel without Anderson of
// `kernel` (kAaK1: K1; kAaK3Block, kAaK3Warp: K3 in that layout) at its
// shared memory for this shape (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
// the bound below which the Anderson instantiation's placement rule
// (qp_kernel_aa.cu) keeps its ring off chip.  A negative CUDA error code on
// failure.
int qp_kernel_twin_blocks(int kernel, int n, int m, int device) {
  cudaError_t err = cudaSetDevice(device);
  const void* fn = nullptr;
  int threads = threads_for(n, m);
  size_t smem = 0;
  if (kernel == kAaK1) {
    fn = threads == 128 ? (const void*)sqp_step_kernel<4> : (const void*)sqp_step_kernel<2>;
    smem = step_layout(n, m).smem_bytes;
  } else if (kernel == kAaK3Block) {
    fn = (const void*)qp_solve_kernel;
    smem = qp_layout(n, m).smem_bytes;
  } else if (kernel == kAaK3Warp && qp_warp_layout(n, m)) {
    fn = n <= 16 ? (const void*)qp_solve_warp_kernel<16> : (const void*)qp_solve_warp_kernel<32>;
    threads = 32 * kQpWarps;
    smem = (size_t)kQpWarps * qp_warp_floats(n, m) * sizeof(float);
  } else {
    return -(int)cudaErrorInvalidValue;
  }
  int blocks = 0;
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// arm: kSpdRule (0) by spd_rule_arm, or kSpdColumn / kSpdTwoBuffer forced.
int spd_inverse_launch_as(int arm, const float* M, float* minv_out, uint8_t* fail_out, float* ws,
                          int batch, int n, int device, void* stream) {
  if (batch <= 0) return 0;
  const SpdLaunch s = spd_launch_as(arm, n);
  if (s.kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (s.L.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = spd_prepare(s);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (batch + s.per_block - 1) / s.per_block;
  cudaStream_t st = (cudaStream_t)stream;
  if (s.per_block > 1) {
    int nn = n, bb = batch;
    void* args[] = {&nn, &bb, &M, &minv_out, &fail_out};
    err = cudaLaunchKernel(s.kernel, dim3(blocks), dim3(s.threads), args, s.smem_bytes, st);
  } else {
    int nn = n, nsm = s.L.n_smem_mats;
    long long wsf = s.L.ws_floats;
    void* args[] = {&nn, &nsm, &wsf, &M, &minv_out, &fail_out, &ws};
    err = cudaLaunchKernel(s.kernel, dim3(blocks), dim3(s.threads), args, s.smem_bytes, st);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int spd_inverse_launch(const float* M, float* minv_out, uint8_t* fail_out, float* ws,
                       int batch, int n, int device, void* stream) {
  return spd_inverse_launch_as(kSpdRule, M, minv_out, fail_out, ws, batch, n, device, stream);
}

int spd_inverse_problems_per_block(int n) { return spd_launch_as(kSpdRule, n).per_block; }

// What the rule's launch at n takes, for the records: out = [its arm,
// problems a block, threads a block, dynamic shared memory bytes, registers
// a thread, local (spill) bytes a thread, blocks an SM by the occupancy
// calculator].  Returns a CUDA error code.
int spd_inverse_arm_info(int n, int device, int* out) {
  const SpdLaunch s = spd_launch_as(kSpdRule, n);
  cudaError_t err = cudaSetDevice(device);
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, s.kernel);
  if (err == cudaSuccess) err = spd_prepare(s);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, s.kernel, s.threads,
                                                        s.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  out[0] = spd_rule_arm(n);
  out[1] = s.per_block;
  out[2] = s.threads;
  out[3] = (int)s.smem_bytes;
  out[4] = fa.numRegs;
  out[5] = (int)fa.localSizeBytes;
  out[6] = per_sm;
  return 0;
}

}  // extern "C"

#else  // QP_KERNEL_AA_UNIT: the Anderson kernels' entry points

extern "C" int qp_kernel_twin_blocks(int kernel, int n, int m, int device);  // qp_kernel.cu

namespace {

// Where an Anderson launch of K1 or K3 keeps each problem's Anderson state:
// up to a memory k of kAaGramSmemMemory, the Gram area (aa_gram_floats) in
// shared memory, and the ring (aa_ring_floats) there too where, with both,
// the block's shared memory still holds every matrix the kernel without
// Anderson holds there and still allows as many blocks an SM as that
// kernel gets (twin_blocks, qp_kernel_twin_blocks), else in the device
// workspace.  Past it the ring and the Gram area go to the problem's
// workspace slice, and the chunk's system (the k x k solve's operand,
// every live entry read and written at each of its k pivots) to a solve
// area in shared memory (AaSolve, aa_solve_sys): one a problem where that
// keeps those two, else (K3's warp layout) one a block where that does,
// else one a block wherever shared memory holds it beside the kernel's own
// (at fewer blocks an SM; the block layout with every matrix the twin
// holds there), and only where it does not, to the workspace.  Measured in
// turns with each placement forced (NVIDIA H100, PERF.md section 6): a
// solve area beat the workspace at memories 33-128 in K1 and both K3
// layouts even at fewer blocks an SM, one a block beat one a problem on
// K3's warp layout wherever the latter lost blocks, and a solve area beat
// the whole Gram area on chip even where that kept the twin's blocks
// (memory 33: K1 52.6 against 65.7 ms).  The block layout puts the
// areas after its matrices in shared memory (at k <= kAaGramSmemMemory a
// matrix the Gram leaves no room for goes to the workspace:
// aa_workspace_floats), the warp layout after its problems' slices.
// ops/qp_kernel.py:anderson_placement is the rule's Python mirror.  A
// build with -DAA_FORCE_SOLVE=p forces past kAaGramSmemMemory the whole
// Gram area into shared memory (p = 0) or the solve AaSolve p, where
// shared memory holds it (tools/kernel_ab.py --parts placements).
#ifndef AA_FORCE_SOLVE
#define AA_FORCE_SOLVE -1
#endif
struct AaPlan {
  bool ring;             // the ring in shared memory
  bool gram;             // the Gram area in shared memory
  int solve;             // AaSolve: where the chunk's system goes
  long long smem_bytes;  // the block's dynamic shared memory
  long long sm_off;      // floats before the first problem's area
  int sm_stride;         // floats of a problem's area
  long long sys_off;     // floats before the first solve area (a multiple of 4)
  int sys_stride;        // floats of a problem's solve area (kAaSolveScope)
  long long sys_floats;  // floats of the block's solve areas, with their head
  int scopes;            // problems a block
  long long twin_smem;   // the kernel without Anderson's
  Layout L;              // the block layout's matrices (the warp layout: none)
};

AaPlan aa_dense_plan(int kernel, int n, int m, int k, int twin_blocks) {
  const long long g = aa_gram_floats(k), r = aa_ring_floats(k, n, m), sa = aa_solve_floats(k);
  const bool warp = kernel == kAaK3Warp;
  AaPlan P{};
  P.scopes = warp ? kQpWarps : 1;
  long long base = 0, vec = 0;
  long long mats[3] = {0, 0, 0};
  if (warp) {
    base = kQpWarps * (long long)qp_warp_floats(n, m);
  } else {
    const long long ld = n + 1;
    mats[0] = n * ld;
    mats[1] = m * ld;
    mats[2] = n * ld;
    vec = (kernel == kAaK1 ? 9LL * n : 7LL * n) + 7LL * m + kRedSlots;
  }
  // the layout with `extra` floats a block more: the warp layout's after
  // its slices, the block layout's after its matrices
  auto with = [&](long long extra) {
    return warp ? Layout{(size_t)((base + extra) * 4), 0, 0} : plan(vec + extra, mats);
  };
  const Layout twin = with(0);
  // that layout fits on the card with every matrix of the twin's in shared memory
  auto fits = [&](long long extra) {
    const Layout w = with(extra);
    return w.n_smem_mats == twin.n_smem_mats && w.smem_bytes <= (size_t)kMaxSmemBytes;
  };
  // ... and keeps the twin's blocks an SM
  auto keeps = [&](long long extra) {
    return fits(extra) && smem_blocks_per_sm((long long)with(extra).smem_bytes) >= twin_blocks;
  };
  const long long per_scope = kAaSolveHead + P.scopes * sa, per_block = kAaSolveHead + sa;
  const bool past = k > kAaGramSmemMemory;
  const int force = past ? AA_FORCE_SOLVE : -1;
  P.ring = !past && keeps(P.scopes * (g + r));
  P.gram = !past || force == 0;
  if (P.gram) {
    P.solve = kAaSolveGram;
  } else if (force > 0) {  // one problem a block: its area is the block's
    P.solve = force == kAaSolveBlock && P.scopes == 1 ? kAaSolveScope : force;
  } else if (keeps(per_scope)) {
    P.solve = kAaSolveScope;
  } else if (P.scopes > 1 && keeps(per_block)) {
    P.solve = kAaSolveBlock;
  } else if (fits(P.scopes > 1 ? per_block : per_scope)) {
    P.solve = P.scopes > 1 ? kAaSolveBlock : kAaSolveScope;
  } else {
    P.solve = kAaSolveWorkspace;
  }
  P.sm_stride = (int)((P.gram ? g : 0) + (P.ring ? r : 0));
  P.sys_stride = P.solve == kAaSolveScope ? (int)sa : 0;
  P.sys_floats = P.solve == kAaSolveScope ? per_scope : (P.solve == kAaSolveBlock ? per_block : 0);
  P.L = with(P.scopes * (long long)P.sm_stride + P.sys_floats);
  P.twin_smem = (long long)twin.smem_bytes;
  P.smem_bytes = (long long)P.L.smem_bytes;
  const long long sys_start = P.smem_bytes / 4 - P.sys_floats;  // after the Gram areas
  P.sys_off = (sys_start + kAaSolveHead) & ~3LL;  // the lock word just before it
  P.sm_off = sys_start - P.scopes * (long long)P.sm_stride;
  return P;
}

// The plan of a launch on the card: the twin's blocks an SM from the
// runtime; an error where the memory is not positive or the shared memory
// passes the card's.
cudaError_t aa_dense_launch_plan(int kernel, int n, int m, int k, int device, AaPlan& P,
                                 int& twin_blocks) {
  if (k <= 0) return cudaErrorInvalidValue;
  twin_blocks = qp_kernel_twin_blocks(kernel, n, m, device);
  if (twin_blocks < 0) return (cudaError_t)(-twin_blocks);
  P = aa_dense_plan(kernel, n, m, k, twin_blocks);
  return P.smem_bytes <= kMaxSmemBytes ? cudaSuccess : cudaErrorInvalidValue;
}

AaArgs aa_args_of(const AaPlan& P, int k, float* ws) {
  return AaArgs{k, ws, P.sm_off, P.sm_stride, P.ring ? 1 : 0, P.gram ? 0 : 1};
}

// The _aas kernels' second argument: the slices in ws one a problem of
// `batch`, the chunk systems of kAaSolveWorkspace after them.
AaSysArgs sys_args_of(const AaPlan& P, int k, float* ws, int n, int m, int batch) {
  return AaSysArgs{P.solve, P.sys_off, P.sys_stride,
                   ws + (((size_t)batch * aa_floats(k, n, m) + 3) & ~(size_t)3)};
}

}  // namespace

extern "C" {

// Workspace floats a problem of K1 (kernel kAaK1) or K3's block layout
// (kAaK3Block) with Anderson of memory k: the matrices' that shared memory
// does not hold beside the Anderson area (the warp layout: 0).
long long qp_kernel_aa_workspace_floats(int kernel, int n, int m, int k) {
  if (kernel == kAaK3Warp) return 0;
  return aa_dense_plan(kernel, n, m, k, 0).L.ws_floats;
}

// The kernel of an Anderson launch of `kernel` at n, m by its plan: the
// instantiation whose step solves off the Gram area where P.solve says so.
const void* aa_kernel_of(int kernel, int n, int m, const AaPlan& P) {
  const bool sys = P.solve != kAaSolveGram;
  if (kernel == kAaK1) {
    if (threads_for(n, m) == 128)
      return sys ? (const void*)sqp_step_kernel_aas<4> : (const void*)sqp_step_kernel_aa<4>;
    return sys ? (const void*)sqp_step_kernel_aas<2> : (const void*)sqp_step_kernel_aa<2>;
  }
  if (kernel == kAaK3Block)
    return sys ? (const void*)qp_solve_kernel_aas : (const void*)qp_solve_kernel_aa;
  if (n <= 16)
    return sys ? (const void*)qp_solve_warp_kernel_aas<16> : (const void*)qp_solve_warp_kernel_aa<16>;
  return sys ? (const void*)qp_solve_warp_kernel_aas<32> : (const void*)qp_solve_warp_kernel_aa<32>;
}

// The placement of an Anderson launch of `kernel` (kAaK1, kAaK3Block,
// kAaK3Warp) at n, m and memory k on this card, into out[12]: the ring in
// shared memory (1) or in the workspace (0), the block's shared-memory
// bytes, those of the kernel without Anderson, that kernel's blocks an SM
// and this one's (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the Gram
// area's and the ring's floats a problem, problems a block, the workspace
// floats a problem, the Gram area in shared memory (1) or in the Anderson
// workspace (0), where the chunk's system goes (AaSolve) and the floats of
// the block's solve areas in shared memory (aa_dense_plan).  Returns a
// CUDA error code.
int qp_kernel_aa_placement(int kernel, int n, int m, int k, int device, long long* out) {
  AaPlan P;
  int twin = 0;
  cudaError_t err = aa_dense_launch_plan(kernel, n, m, k, device, P, twin);
  const void* fn = aa_kernel_of(kernel, n, m, P);
  const int threads = kernel == kAaK3Warp ? 32 * kQpWarps : threads_for(n, m);
  int blocks = 0;
  if (err == cudaSuccess && P.smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)P.smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, P.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long v[12] = {P.ring ? 1 : 0, P.smem_bytes, P.twin_smem, twin, blocks,
                           aa_gram_floats(k), aa_ring_floats(k, n, m), P.scopes,
                           P.L.ws_floats, P.gram ? 1 : 0, P.solve, P.sys_floats};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}


// sqp_step_launch with Anderson acceleration of any memory aa_mem > 0, its
// state in aa_ws (batch x admm_aa_floats(aa_mem, n, m)
// floats) and shared memory (aa_dense_plan); ws holds
// qp_kernel_aa_workspace_floats(kAaK1, n, m, aa_mem) floats a problem.
int sqp_step_launch_aa(const float* Bp, const float* J, const float* g, const float* l,
                       const float* u, const float* s, const float* dgl, const uint8_t* reset,
                       const uint8_t* upd, const uint8_t* active, const float* rho_in,
                       const float* minv_in, const float* x0, const float* z0, const float* y0,
                       float* p_out, float* z_out, float* y_out, float* B_out, float* stats,
                       float* minv_out, float* ws, int batch, int n, int m, float sigma,
                       float alpha, float rho0, float eps_abs, float eps_rel, int n_epochs,
                       int chunks_per_epoch, int seg, int adaptive_rho,
                       float adaptive_rho_tolerance, int do_bfgs, int device, void* stream,
                       int aa_mem, float* aa_ws) {
  if (batch <= 0) return 0;
  if (aa_ws == nullptr) return (int)cudaErrorInvalidValue;
  AaPlan P;
  int twin = 0;
  cudaError_t err = aa_dense_launch_plan(kAaK1, n, m, aa_mem, device, P, twin);
  if (err != cudaSuccess) return (int)err;
  if (P.L.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const int threads = threads_for(n, m);
  const void* fn = aa_kernel_of(kAaK1, n, m, P);
  err = set_smem(fn, P.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const StepParams p = step_params(n, m, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs,
                                   chunks_per_epoch, seg, adaptive_rho, adaptive_rho_tolerance,
                                   do_bfgs, 0, 0.f, 0.f, P.L);
  const AaArgs aa = aa_args_of(P, aa_mem, aa_ws);
  if (P.solve == kAaSolveGram)
    ((decltype(&sqp_step_kernel_aa<4>))fn)<<<batch, threads, P.smem_bytes,
                                              (cudaStream_t)stream>>>(
        p, Bp, J, g, l, u, s, dgl, reset, upd, active, rho_in, minv_in, x0, z0, y0, p_out,
        z_out, y_out, B_out, stats, minv_out, ws, aa);
  else
    ((decltype(&sqp_step_kernel_aas<4>))fn)<<<batch, threads, P.smem_bytes,
                                               (cudaStream_t)stream>>>(
        p, Bp, J, g, l, u, s, dgl, reset, upd, active, rho_in, minv_in, x0, z0, y0, p_out,
        z_out, y_out, B_out, stats, minv_out, ws, aa, sys_args_of(P, aa_mem, aa_ws, n, m, batch));
  return (int)cudaGetLastError();
}

// qp_solve_launch_as with Anderson acceleration of any memory aa_mem > 0,
// its state in aa_ws (batch x admm_aa_floats(aa_mem, n, m)
// floats) and shared memory (aa_dense_plan); layout 0 by qp_warp_layout, 1
// the block layout (ws: qp_kernel_aa_workspace_floats(kAaK3Block, n, m,
// aa_mem) floats a problem), 2 the warp layout.
int qp_solve_launch_aa(int layout, const float* P, const float* A, const float* q,
                       const float* l, const float* u, const float* x0, const float* z0,
                       const float* y0, float* x_out, float* z_out, float* y_out, float* stats,
                       float* ws, int batch, int n, int m, float sigma, float alpha,
                       float rho0, float eps_abs, float eps_rel, int n_epochs,
                       int chunks_per_epoch, int seg, int adaptive_rho,
                       float adaptive_rho_tolerance, int check_infeas, float eps_pinf,
                       float eps_dinf, int device, void* stream, int aa_mem, float* aa_ws) {
  if (batch <= 0) return 0;
  if (layout < 0 || layout > 2 || (layout == 2 && !qp_warp_layout(n, m)) || aa_ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool warp = layout == 2 || (layout == 0 && qp_warp_layout(n, m));
  AaPlan pl;
  int twin = 0;
  cudaError_t err =
      aa_dense_launch_plan(warp ? kAaK3Warp : kAaK3Block, n, m, aa_mem, device, pl, twin);
  if (err != cudaSuccess) return (int)err;
  if (!warp && pl.L.ws_floats > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const void* fn = aa_kernel_of(warp ? kAaK3Warp : kAaK3Block, n, m, pl);
  err = set_smem(fn, pl.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const StepParams p = step_params(n, m, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs,
                                   chunks_per_epoch, seg, adaptive_rho, adaptive_rho_tolerance, 0,
                                   check_infeas, eps_pinf, eps_dinf, warp ? qp_layout(n, m) : pl.L);
  const AaArgs aa = aa_args_of(pl, aa_mem, aa_ws);
  const AaSysArgs sa = sys_args_of(pl, aa_mem, aa_ws, n, m, batch);
  const bool sys = pl.solve != kAaSolveGram;
  const cudaStream_t st = (cudaStream_t)stream;
  if (warp) {
    const int blocks = (batch + kQpWarps - 1) / kQpWarps, threads = 32 * kQpWarps;
    if (sys)
      ((decltype(&qp_solve_warp_kernel_aas<16>))fn)<<<blocks, threads, pl.smem_bytes, st>>>(
          p, batch, P, A, q, l, u, x0, z0, y0, x_out, z_out, y_out, stats, aa, sa);
    else
      ((decltype(&qp_solve_warp_kernel_aa<16>))fn)<<<blocks, threads, pl.smem_bytes, st>>>(
          p, batch, P, A, q, l, u, x0, z0, y0, x_out, z_out, y_out, stats, aa);
  } else if (sys) {
    ((decltype(&qp_solve_kernel_aas))fn)<<<batch, threads_for(n, m), pl.smem_bytes, st>>>(
        p, P, A, q, l, u, x0, z0, y0, x_out, z_out, y_out, stats, ws, aa, sa);
  } else {
    ((decltype(&qp_solve_kernel_aa))fn)<<<batch, threads_for(n, m), pl.smem_bytes, st>>>(
        p, P, A, q, l, u, x0, z0, y0, x_out, z_out, y_out, stats, ws, aa);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
#endif  // QP_KERNEL_AA_UNIT
