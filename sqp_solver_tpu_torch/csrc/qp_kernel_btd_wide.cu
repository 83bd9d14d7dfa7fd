// Hopper (sm_90a) structured whole-QP kernel for internal blocks wider than
// a warp, with a plain C interface loaded through ctypes by
// sqp_solver_tpu_torch/ops/qp_kernel_btd.py.  The same two entry points as
// qp_kernel_btd.cu, which keeps the internal blocks 8, 16, 24 and 32:
//
//   qp_solve_kernel_btd  (K6) replaces sqp_solver_tpu/ops/qp_kernel_btd.py:
//                        qp_solve_kernel_btd
//   btd_step_kernel      (K7) replaces sqp_solver_tpu/ops/qp_kernel_btd.py:
//                        btd_step_kernel
//   (body _qp_btd_kernel, pallas_call in _qp_btd_call)
//
// for every internal block bb that is a multiple of 8 up to 128, bb a
// runtime argument (one instantiation: the narrow kernel's six take most
// of the library's nvcc time).  The narrow kernel keeps row i of a block
// in lane i of one warp and two whole rows of the Gram band in a thread's
// registers; past 32 rows neither holds.  Here the whole block of 256
// threads works on each bb x bb step, through shared memory:
//   factor      the Gram band D_k = A_k' diag(rho) A_k and E_k =
//               A_{k+1}' diag(rho) A_k in 4 x 4 register tiles (a tile
//               reads 4 + 4 entries of a row of A for 16 FMAs); then
//               block-Thomas, T dependent steps of a few block barriers
//               each: S_k = D_k - F_{k-1} F_{k-1}', its Cholesky by
//               dense_factor.cuh's chol_blocked (panels of 32; the pivot
//               clamp max(d, 1e-30), fail = d <= 0 | NaN), L_k^-1 by
//               tri_inv_blocked, then G_k = L_k^-1 F_{k-1}, F_k =
//               E_k L_k^-T and H_k = L_k^-T F_k', one thread an entry;
//   apply_minv  c_k = L_k^-1 b_k and d_k = L_k^-T w_k for all k, one
//               thread a row; the chains w_k = c_k - G_k w_{k-1} and
//               x_k = d_k - H_k x_{k+1} by the whole block, a warp a row
//               of the coupling (lanes over its columns, a warp sum), one
//               block barrier a step: 2 (T - 1) steps an iteration;
//   amv, atmv   A dense, dense_factor.cuh's lane-split rows_dot / cols_dot;
//   pmv         P v from the band of P only (one thread per row).
// One block per problem, never a cluster.  Every branch around a barrier
// depends on the shape alone, so it is uniform over the block.
//
// Memory.  The vectors (8 n + 7 m), then the band and factor arrays in the
// order Li, G, H, pd, pe (n bb floats each) and the Thomas scratch S
// (bb (bb + 1)), F_{k-1}, F_k (bb^2 each), as many leading ones in shared
// memory as fit; the others in a per-problem workspace in device memory
// that the wrapper allocates (pd and pe are then read where they are
// given).  A goes to shared memory only after all of those, and whole
// where it fits; else it is read from device memory.  The rule depends on
// the shape alone (qp_btd_wide_smem_arrays, qp_btd_wide_smem_rows).  At the
// 6-DOF arm's shape (n = 360, m = 600, bb = 40) Li, G and H are on chip
// and A (864 KB a problem) is read from device memory.
//
// What bounds it on this card.  Each ADMM iteration is two dense matvecs
// with A (4 m n flops; where A is in device memory, 8 m n bytes a problem)
// and the two chains (2 (T - 1) steps of one bb x bb matvec and a block
// barrier); the factor is O(m n bb) for the Gram band and T dependent steps
// of O(bb^3).  At the arm's shape the bytes of A bound an iteration; one
// block an SM for the shared memory the band takes.
//
// Anderson acceleration as in qp_kernel_btd.cu: a second instantiation of
// the body (AA = true) in qp_kernel_btd_wide_aa.cu, which includes this
// file with QP_KERNEL_BTD_WIDE_AA_UNIT defined.

#include "admm_core.cuh"
#include "dense_factor.cuh"

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideMaxBlock = 128;
constexpr int kWideQuad = 2;  // chol_blocked's trailing-update tiles

// The band and factor arrays, in the order they take shared memory.
enum WideArray { kWLi, kWG, kWH, kWPd, kWPe, kWS, kWFa, kWFb, kWideArrays };

struct WideLayout {
  long long size[kWideArrays];
  int n_smem;           // leading arrays in shared memory (-1: the vectors do not fit)
  int rs;               // rows of A in shared memory (m or 0)
  long long ws_floats;  // per-problem workspace (the arrays past n_smem but pd, pe)
  size_t smem_bytes;
};

// Shared-memory floats before the arrays: 8 n + 7 m vectors, the reduction
// slots and chol_blocked's 33 floats of scratch.
long long wide_vector_floats(int n, int m) { return 8LL * n + 7LL * m + kRedSlots + kPanel + 1; }

WideLayout wide_layout(int n, int m, int bb) {
  WideLayout L;
  const long long nb = (long long)n * bb, b2 = (long long)bb * bb;
  const long long sizes[kWideArrays] = {nb, nb, nb, nb, nb, b2 + bb, b2, b2};
  const long long cap = kMaxSmemBytes / 4;
  long long used = wide_vector_floats(n, m);
  L.n_smem = used <= cap ? 0 : -1;
  L.ws_floats = 0;
  for (int k = 0; k < kWideArrays; ++k) {
    L.size[k] = sizes[k];
    if (L.n_smem == k && used + sizes[k] <= cap) {
      used += sizes[k];
      ++L.n_smem;
    } else if (k != kWPd && k != kWPe) {
      L.ws_floats += sizes[k];
    }
  }
  L.rs = L.n_smem == kWideArrays && cap - used >= (long long)m * (n + 1) ? m : 0;
  L.smem_bytes = L.n_smem < 0 ? 0 : (size_t)(used + (long long)L.rs * (n + 1)) * 4;
  return L;
}

// The structured operator of one problem with a runtime internal block bb.
// A (m x n, row stride lda: n + 1 in shared memory, n in device memory);
// the band of P (pd, pe) and the factor (Li, G, H), each T blocks of
// bb x bb; S (stride bb + 1), Fa, Fb the Thomas chain's scratch; sc
// chol_blocked's; tw (n) the sweeps'.
struct WideBandOp {
  const float* A;
  int lda, m;
  const float* pd;
  const float* pe;
  float* Li;
  float* G;
  float* H;
  float* S;
  float* Fa;
  float* Fb;
  float* sc;
  float* tw;
  int n, T, bb;
  float sigma;

  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    cols_dot<4>(A, lda, m, n, w, epi);
  }
  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    rows_dot<4>(A, lda, m, n, v, epi);
  }

  // (P v)_k = P_{k,k} v_k + P_{k,k-1} v_{k-1} + P_{k+1,k}' v_{k+1}
  __device__ void pmv(const float* v, float* out) const {
    const size_t nb2 = (size_t)bb * bb;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int k = r / bb, i = r - k * bb, o = k * bb;
      const float* d = pd + k * nb2 + (size_t)i * bb;
      float acc = 0.f;
      for (int j = 0; j < bb; ++j) acc = fmaf(d[j], v[o + j], acc);
      if (k > 0) {
        const float* e = pe + (k - 1) * nb2 + (size_t)i * bb;
        float a2 = 0.f;
        for (int j = 0; j < bb; ++j) a2 = fmaf(e[j], v[o - bb + j], a2);
        acc += a2;
      }
      if (k + 1 < T) {
        const float* e = pe + k * nb2 + i;
        float a3 = 0.f;
        for (int j = 0; j < bb; ++j) a3 = fmaf(e[(size_t)j * bb], v[o + bb + j], a3);
        acc += a3;
      }
      out[r] = acc;
    }
  }

  // out = M^-1 b: c_k = L_k^-1 b_k (into out), the forward chain in place,
  // d_k = L_k^-T w_k (into tw), the backward chain into out.  The caller's
  // barrier follows.
  __device__ void apply_minv(const float* b, float* out) const {
    const size_t nb2 = (size_t)bb * bb;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int k = r / bb, i = r - k * bb;
      const float* L = Li + k * nb2 + (size_t)i * bb;
      const float* bk = b + k * bb;
      float c = 0.f;
      for (int q = 0; q <= i; ++q) c = fmaf(L[q], bk[q], c);
      out[r] = c;
    }
    __syncthreads();
    chain(G, out, out, 1);
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int k = r / bb, i = r - k * bb;
      const float* L = Li + k * nb2 + i;
      const float* wk = out + k * bb;
      float d = 0.f;
      for (int q = i; q < bb; ++q) d = fmaf(L[(size_t)q * bb], wk[q], d);
      tw[r] = d;
    }
    __syncthreads();
    chain(H, tw, out, -1);
  }

  // One sweep chain by the block: y_k = rhs_k - C_k y_{k-dir} for the
  // blocks in order dir (1: k = 0 .. T-1 with C = G; -1: k = T-1 .. 0 with
  // C = H), y_first = rhs_first; a warp a row of C_k, one barrier a step.
  // rhs and y may alias.  Ends with a barrier.
  __device__ void chain(const float* C, const float* rhs, float* y, int dir) const {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const size_t nb2 = (size_t)bb * bb;
    const int k0 = dir > 0 ? 0 : T - 1;
    for (int i = threadIdx.x; i < bb; i += blockDim.x) y[k0 * bb + i] = rhs[k0 * bb + i];
    __syncthreads();
    for (int s = 1, k = k0 + dir; s < T; ++s, k += dir) {
      const float* Ck = C + k * nb2;
      const float* yp = y + (k - dir) * bb;
      for (int i = wp; i < bb; i += nw) {
        const float* row = Ck + (size_t)i * bb;
        float a = 0.f;
        for (int j = lane; j < bb; j += 32) a = fmaf(row[j], yp[j], a);
        a = warp_sum(a);
        if (lane == 0) y[k * bb + i] = rhs[k * bb + i] - a;
      }
      __syncthreads();
    }
  }

  // The Gram band over this problem's rows: D_k + pd_k + sigma I into Li's
  // block k, E_k + pe_k into H's (E_{T-1} = pe_{T-1}).  A task is a 4 x 4
  // tile of the 2 bb x bb stack [D_k; E_k]: rows of A column block k (D)
  // or k + 1 (E), columns of column block k.  No sync.
  __device__ void gram(const float* rv) const {
    const size_t nb2 = (size_t)bb * bb;
    const int tb = bb >> 2, per = 2 * tb * tb, tasks = T * per;
    for (int t = threadIdx.x; t < tasks; t += blockDim.x) {
      const int k = t / per, rem = t - k * per, tr = rem / tb, tc = rem - tr * tb;
      const bool erow = tr >= tb;
      const int i0 = 4 * (erow ? tr - tb : tr), j0 = 4 * tc;
      const int ci = (k + (erow ? 1 : 0)) * bb + i0, cj = k * bb + j0;
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
      for (int r = 0; r < (!erow || k + 1 < T ? m : 0); ++r) {
        const float* ar = A + (size_t)r * lda;
        const float w = rv[r];
        float x[4], y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[e] = ar[ci + e] * w;
          y[e] = ar[cj + e];
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[e * 4 + f] = fmaf(x[e], y[f], acc[e * 4 + f]);
      }
      float* out = (erow ? H : Li) + k * nb2;
      const float* base = (erow ? pe : pd) + k * nb2;
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int i = i0 + e, j = j0 + f;
          const size_t o = (size_t)i * bb + j;
          out[o] = base[o] + (!erow && i == j ? sigma : 0.f) + acc[e * 4 + f];
        }
    }
  }

  // Gram band, then block-Thomas into Li (L_k^-1), G, H.  Returns the
  // block-uniform fail flag.
  __device__ bool factor(const float* rv) const {
    const int tid = threadIdx.x, NT = blockDim.x, lds = bb + 1, b2 = bb * bb;
    const size_t nb2 = (size_t)b2;
    gram(rv);
    float* Fp = Fa;  // F_{k-1}, F_{-1} = 0
    float* Fn = Fb;  // F_k
    for (int e = tid; e < b2; e += NT) Fp[e] = 0.f;
    __syncthreads();
    ADMM_PHASE_END(kPhGram);
    ADMM_PHASE_BEGIN(kPhThomas);
    bool fail = false;
    for (int k = 0; k < T; ++k) {
      float* Dk = Li + k * nb2;  // D_k, then L_k^-1
      float* Ek = H + k * nb2;   // E_k, then H_k
      // S_k = D_k - F_{k-1} F_{k-1}' (lower triangle)
      for (int e = tid; e < b2; e += NT) {
        const int i = e / bb, j = e - i * bb;
        if (j > i) continue;
        float acc = 0.f;
        for (int l = 0; l < bb; ++l) acc = fmaf(Fp[i * bb + l], Fp[j * bb + l], acc);
        S[i * lds + j] = Dk[e] - acc;
      }
      __syncthreads();
      fail = chol_blocked<kWideQuad>(S, lds, bb, sc) || fail;
      tri_inv_blocked(S, lds, Dk, bb, bb, false);
      // G_k = L_k^-1 F_{k-1}, F_k = E_k L_k^-T
      for (int e = tid; e < b2; e += NT) {
        const int i = e / bb, j = e - i * bb;
        float g = 0.f, f = 0.f;
        for (int q = 0; q <= i; ++q) g = fmaf(Dk[i * bb + q], Fp[q * bb + j], g);
        for (int q = 0; q <= j; ++q) f = fmaf(Ek[i * bb + q], Dk[j * bb + q], f);
        G[k * nb2 + e] = g;
        Fn[e] = f;
      }
      __syncthreads();
      // H_k = L_k^-T F_k' over E_k
      for (int e = tid; e < b2; e += NT) {
        const int i = e / bb, j = e - i * bb;
        float h = 0.f;
        for (int q = i; q < bb; ++q) h = fmaf(Dk[q * bb + i], Fn[j * bb + q], h);
        Ek[e] = h;
      }
      __syncthreads();
      float* t = Fp;
      Fp = Fn;
      Fn = t;
    }
    return fail;
  }
};

// K6 / K7 at a wide internal block: the narrow kernel's entry (per
// problem: load, rho = rho0 + 0 q_0 or rho_in's select, the ADMM solve
// entered with a pending rho, output x, z, y and the stats (9, B)) on
// WideBandOp.  This unit compiles it as qp_btd_wide_kernel (without
// Anderson) and qp_kernel_btd_wide_aa.cu as qp_btd_wide_kernel_aa.
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
__global__ void __launch_bounds__(kWideThreads) qp_btd_wide_kernel(
#else
__global__ void __launch_bounds__(kWideThreads) qp_btd_wide_kernel_aa(
#endif
    StepParams p, int bb, int rs, int batch, const float* __restrict__ pdg,
    const float* __restrict__ peg, const float* __restrict__ Ag, const float* __restrict__ qg,
    const float* __restrict__ lg, const float* __restrict__ ug,
    const uint8_t* __restrict__ active, const float* __restrict__ rho_in,
    const float* __restrict__ x0, const float* __restrict__ z0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ z_out, float* __restrict__ y_out,
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
    float* __restrict__ stats, float* __restrict__ ws) {
  constexpr bool AA = false;
  const AaArgs aa_args{0, nullptr};
#else
    float* __restrict__ stats, float* __restrict__ ws, AaArgs aa_args) {
  constexpr bool AA = true;
#endif
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  const int n = p.n, m = p.m, ld = n + 1, T = n / bb;
  const size_t nband = (size_t)n * bb;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, NT = blockDim.x;

  float* q = smem;
  float* x = q + n;
  float* bt = x + n;
  float* xt = bt + n;
  float* tn1 = xt + n;
  float* tn2 = tn1 + n;
  float* xp = tn2 + n;
  float* tw = xp + n;  // 8 n
  float* z = tw + n;
  float* y = z + m;
  float* l = y + m;
  float* u = l + m;
  float* rv = u + m;
  float* tm = rv + m;
  float* yp = tm + m;  // 7 m
  float* red = yp + m;
  float* sc = red + kRedSlots;  // kPanel + 1
  // the arrays: the first n_smem in shared memory, the others in this
  // problem's workspace slice, pd and pe read where they are given
  const int b2 = bb * bb;
  const long long sizes[kWideArrays] = {(long long)nband, (long long)nband, (long long)nband,
                                        (long long)nband, (long long)nband, b2 + bb, b2, b2};
  float* arr[kWideArrays];
  float* s = sc + kPanel + 1;
  float* g = ws ? ws + b * (size_t)p.ws_floats : nullptr;
  for (int k = 0; k < kWideArrays; ++k) {
    if (k < p.n_smem_mats) {
      arr[k] = s;
      s += sizes[k];
    } else if (k == kWPd || k == kWPe) {
      arr[k] = nullptr;
    } else {
      arr[k] = g;
      g += sizes[k];
    }
  }
  float* As = s;  // A with row stride ld where it fits (rs = m)
  const float* pd = arr[kWPd] ? arr[kWPd] : pdg + b * nband;
  const float* pe = arr[kWPe] ? arr[kWPe] : peg + b * nband;
  const float* Ab = Ag + b * (size_t)m * n;

  for (int j = tid; j < n; j += NT) {
    q[j] = qg[b * n + j];
    x[j] = x0[b * n + j];
  }
  for (int i = tid; i < m; i += NT) {
    const size_t o = b * m + i;
    z[i] = z0[o];
    y[i] = y0[o];
    l[i] = lg[o];
    u[i] = ug[o];
  }
  if (arr[kWPd])
    for (size_t e = tid; e < nband; e += NT) arr[kWPd][e] = pdg[b * nband + e];
  if (arr[kWPe])
    for (size_t e = tid; e < nband; e += NT) arr[kWPe][e] = peg[b * nband + e];
  for (int e = tid; e < rs * n; e += NT) {
    const int i = e / n, j = e - i * n;
    As[i * ld + j] = Ab[e];
  }
  __syncthreads();

  AdmmState st;
  st.done = active ? active[b] == 0 : false;
  st.fail = false;
  st.pending = true;  // the first epoch factors
  st.itc = 0;
  st.rho_upd = 1;  // the reference counts the setup rho update
  st.nfact = 0;
  st.infs = 0;
  st.rp = st.rd = st.mz = st.mq = 0.f;
  const float rho_base = p.rho0 + 0.f * q[0];
  if (rho_in) {
    const float ri = rho_in[b];
    st.rho = rho_base + (ri > 0.f ? 1.f : 0.f) * (ri - rho_base);
  } else {
    st.rho = rho_base;
  }
  st.rho_est = st.rho;

  const WideBandOp op{rs ? As : Ab, rs ? ld : n, m, pd, pe, arr[kWLi], arr[kWG], arr[kWH],
                      arr[kWS], arr[kWFa], arr[kWFb], sc, tw, n, T, bb, p.sigma};
  float* aa = AA ? aa_args.ws + b * (size_t)aa_floats(aa_args.k, n, m) : nullptr;
  admm_solve<WideBandOp, AA>(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                             aa, aa_args.k);

  ADMM_PHASE_END(kPhTotal);
  for (int j = tid; j < n; j += NT) x_out[b * n + j] = x[j];
  for (int i = tid; i < m; i += NT) {
    z_out[b * m + i] = z[i];
    y_out[b * m + i] = y[i];
  }
  if (tid == 0) {  // stats is (9, batch): one row per field
    const size_t B = batch;
    stats[0 * B + b] = st.done ? 1.f : 0.f;
    stats[1 * B + b] = (float)st.itc;
    stats[2 * B + b] = st.rp;
    stats[3 * B + b] = st.rd;
    stats[4 * B + b] = st.fail ? 1.f : 0.f;
    stats[5 * B + b] = (float)st.rho_upd;
    stats[6 * B + b] = st.rho_est;
    stats[7 * B + b] = (float)st.infs;
    stats[8 * B + b] = st.rho;
  }
}

// The launch of this unit's kernel on a checked shape: bb a multiple of 8
// up to kWideMaxBlock dividing n, the vectors in shared memory, the
// workspace given where the layout needs one.
cudaError_t launch_wide(int n, int m, int bb, float sigma, float alpha, float rho0,
                        float eps_abs, float eps_rel, int n_epochs, int chunks_per_epoch,
                        int seg, int adaptive_rho, float adaptive_rho_tolerance,
                        int check_infeas, float eps_pinf, float eps_dinf, int batch,
                        const float* pd, const float* pe, const float* A, const float* q,
                        const float* l, const float* u, const uint8_t* active,
                        const float* rho_in, const float* x0, const float* z0, const float* y0,
                        float* x_out, float* z_out, float* y_out, float* stats, float* ws,
                        int device, void* stream, AaArgs aa) {
  if (bb < 8 || bb > kWideMaxBlock || bb % 8 != 0 || n <= 0 || m <= 0 || n % bb != 0)
    return cudaErrorInvalidValue;
  const WideLayout L = wide_layout(n, m, bb);
  if (L.n_smem < 0 || (L.ws_floats > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
  auto kernel = qp_btd_wide_kernel;
#else
  auto kernel = qp_btd_wide_kernel_aa;
#endif
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L.smem_bytes);
  if (err != cudaSuccess) return err;
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
  p.do_bfgs = 0;
  p.check_infeas = check_infeas;
  p.eps_pinf = eps_pinf;
  p.eps_dinf = eps_dinf;
  p.n_smem_mats = L.n_smem;
  p.ws_floats = L.ws_floats;
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
  (void)aa;
  kernel<<<batch, kWideThreads, L.smem_bytes, (cudaStream_t)stream>>>(
      p, bb, L.rs, batch, pd, pe, A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out,
      stats, ws);
#else
  kernel<<<batch, kWideThreads, L.smem_bytes, (cudaStream_t)stream>>>(
      p, bb, L.rs, batch, pd, pe, A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out,
      stats, ws, aa);
#endif
  return cudaGetLastError();
}

}  // namespace

#define QP_BTD_WIDE_ARGS                                                                    \
  const float *pd, const float *pe, const float *A, const float *q, const float *l,        \
      const float *u, const uint8_t *active, const float *rho_in, const float *x0,          \
      const float *z0, const float *y0, float *x_out, float *z_out, float *y_out,           \
      float *stats, int batch, int n, int m, int bb, float sigma, float alpha, float rho0,  \
      float eps_abs, float eps_rel, int n_epochs, int chunks_per_epoch, int seg,            \
      int adaptive_rho, float adaptive_rho_tolerance, int check_infeas, float eps_pinf,     \
      float eps_dinf, int device, void *stream, float *ws
#define QP_BTD_WIDE_CALL                                                                    \
  n, m, bb, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs, chunks_per_epoch, seg,          \
      adaptive_rho, adaptive_rho_tolerance, check_infeas, eps_pinf, eps_dinf, batch, pd, pe, \
      A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out, stats, ws, device, stream

extern "C" {

#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
// Floats of the per-problem workspace at this shape (-1 where the vectors
// do not fit in shared memory).
long long qp_btd_wide_workspace_floats(int n, int m, int bb) {
  const WideLayout L = wide_layout(n, m, bb);
  return L.n_smem < 0 ? -1 : L.ws_floats;
}

// Leading band and factor arrays in shared memory (of Li, G, H, pd, pe, S,
// F_{k-1}, F_k), and the rows of A there (m or 0).
int qp_btd_wide_smem_arrays(int n, int m, int bb) { return wide_layout(n, m, bb).n_smem; }

int qp_btd_wide_smem_rows(int n, int m, int bb) { return wide_layout(n, m, bb).rs; }

// One launch of the wide kernel; the arguments of qp_btd_launch and the
// workspace, batch x qp_btd_wide_workspace_floats(n, m, bb) floats.
int qp_btd_wide_launch(QP_BTD_WIDE_ARGS) {
  if (batch <= 0) return 0;
  return (int)launch_wide(QP_BTD_WIDE_CALL, AaArgs{0, nullptr});
}
#else
// With Anderson acceleration of memory aa_mem > 0, its state in aa_ws:
// batch slices of admm_aa_floats(aa_mem, n, m) floats, one a block.
int qp_btd_wide_launch_aa(QP_BTD_WIDE_ARGS, int aa_mem, float* aa_ws) {
  if (batch <= 0) return 0;
  if (aa_mem <= 0 || aa_ws == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_wide(QP_BTD_WIDE_CALL, AaArgs{aa_mem, aa_ws});
}
#endif

}  // extern "C"
