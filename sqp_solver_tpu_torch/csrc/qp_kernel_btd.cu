// Hopper (sm_90a) structured whole-QP kernel: ADMM with a block-tridiagonal
// Schur matrix, with a plain C interface loaded through ctypes by
// sqp_solver_tpu_torch/ops/qp_kernel_btd.py.  One kernel, two entry points:
//
//   qp_solve_kernel_btd  (K6) replaces sqp_solver_tpu/ops/qp_kernel_btd.py:
//                        qp_solve_kernel_btd
//   btd_step_kernel      (K7) replaces sqp_solver_tpu/ops/qp_kernel_btd.py:
//                        btd_step_kernel
//   (body _qp_btd_kernel, pallas_call in _qp_btd_call)
//
// Design.  One problem per thread block, or per cluster of two blocks
// (below), batch-first operands, the ADMM core of admm_core.cuh (rho
// epochs, chunks with per-problem early exit, adaptive rho adopted at
// factor time, certificates) run with BandOp, the structured hooks of the
// JAX core:
//   factor      the Gram band (A' rho A)_{k,k} and _{k+1,k}: one thread per
//               (band row, slice of A's rows) accumulating a whole row of
//               both blocks, the slices summed by shuffles; then the
//               block-Thomas factor by warp 0 alone, row i of each bb x bb
//               block in lane i's registers, the other rows by shuffles and
//               a warp-private scratch, no block barrier inside the chain:
//               S_k = D_k - F_{k-1} F_{k-1}', L_k = chol(S_k) (pivot clamp
//               max(d, 1e-30), fail = d <= 0 | NaN), L_k^-1, F_k =
//               E_k L_k^-T, and the sweeps' couplings G_k = L_k^-1 F_{k-1},
//               H_k = L_k^-T F_k' (F itself is not kept);
//   apply_minv  c_k = L_k^-1 b_k for all k by the block; the forward chain
//               w_k = c_k - G_k w_{k-1} by warp 0; d_k = L_k^-T w_k by the
//               block; the backward chain x_k = d_k - H_k x_{k+1} by warp 0.
//               A chain step is one bb x bb matvec, lane i holding row i of
//               the coupling (loaded a step ahead) and taking the previous
//               block by __shfl_sync: 2 (T - 1) short steps with no barrier
//               inside a chain (three block barriers between the phases);
//   amv, atmv   A dense, each dot product split over 4 lanes and reduced by
//               shuffles, so that every thread works on short chains with
//               eight loads in flight; the lane-to-entry maps keep a warp's
//               32 reads of A (row stride n + 1) on 32 banks;
//   pmv         P v from the band of P only (one thread per row).
// Problems that enter inactive (K7's `active`) skip the solve and pass
// their warm start through; every branch that guards a block or cluster
// barrier is uniform over the block or cluster.
//
// Cluster variant (CS = 2).  Block r of the cluster holds rows
// [r m0, (r + 1) m0) of A, z, y, l, u and rho (m0 = ceil(m / 2)); x and
// the band are held by both.  A v, the z/y updates and the row parts of
// the residuals stay local; A' w is summed from the two blocks' partials
// through distributed shared memory (each block stores its part into both
// blocks' exchange slot, one cluster barrier per iteration), and so are
// the Gram band and the residual maxima; both blocks run the
// Thomas factor and the sweeps, so neither waits for the other's x.  The
// launcher takes a cluster where one block cannot hold all of A and two
// hold more of it (n = 192, m = 320 or 336: 160 or 168 rows a block), or
// where single blocks would leave half of the SMs idle (2 B <= SMs: K7's
// B = 64); a block (or cluster) that cannot hold all of its rows reads the
// rest from device memory.  The rule depends on the shape (and the card's
// SM count) alone; a shape whose band and vectors do not fit, or an
// internal block other than 8, 16, 24 or 32, is refused.
//
// What bounds it on this card.  Each ADMM iteration is two dense matvecs
// with A (4 m n flops; each FMA reads A and the vector from shared memory,
// two wavefronts, so a matvec over 160 rows at n = 192 needs ~1,900
// cycles of the SM's shared-memory bandwidth) and the two sweep chains
// (2 (T - 1) dependent steps of bb x bb work in one warp, ~130 cycles
// each); the factor is O(m n bb) for the Gram band and T dependent
// bb x bb steps for Thomas, also in one warp.  The operations bound of
// the card is far below both: one problem per block (or cluster) is
// latency- and shared-memory bound, and the batch fills the card only
// when B (or 2 B on clusters) >= 132.

// Anderson acceleration.  The kernel takes it as a second instantiation of
// its body (AA = true), whose ADMM core runs the Anderson step of
// admm_core.cuh at each chunk's end, one workspace slice a block; the
// instantiations without it are the kernel as it was.  They live in
// qp_kernel_btd_aa.cu with their entry point (qp_btd_launch_aa), which
// includes this file with QP_KERNEL_BTD_AA_UNIT defined, so that nvcc
// builds them in a process of their own beside this one.  The step keeps
// its Gram area and its ring in shared memory where btd_aa_plan puts them
// (the Gram always at a memory up to 32).  Past memory 32 the chunk's
// system leaves the Gram area for a solve area by columns (in shared
// memory where it costs the kernel without Anderson nothing, else the
// workspace) that the whole block solves: a third instantiation,
// qp_btd_kernel_aas, compiled in qp_kernel_btd_aas.cu (this file with
// QP_KERNEL_BTD_AAS_UNIT too) beside the others.

#include <cooperative_groups.h>

#include "admm_core.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;

// The structured operator of one block.  This block's rows of A (ml of
// them) are its first rs in shared memory (stride ld = n + 1), the rest in
// device memory (Ag, stride n, from row rs); the band of P (pd, pe) and the
// factor (Li, G, H), each T blocks of BB x BB, in shared memory; Fs, Ls
// (BB x (BB + 1)) the Thomas chain's scratch, tw (n) the sweeps', flag one
// slot for the factor's fail flag.  With CS = 2, xch is a ring of two
// exchange slots, each two halves of xlen floats (rank 0's part, rank 1's
// part).
template <int BB, int CS>
struct BandOp {
  const float* As;
  const float* Ag;
  int ld, rs, ml;
  const float* pd;
  const float* pe;
  float* Li;
  float* G;
  float* H;
  float* Fs;
  float* Ls;
  float* tw;
  float* flag;
  float* xch;
  int xlen, rank;
  int n, T;
  float sigma;
  mutable int seq;  // exchanges so far (the same in every thread of the cluster)

  // ---- cluster exchange (CS = 2) ----------------------------------------

  // The next slot of the exchange ring.  Exchange e writes this block's
  // part into half `rank` of slot e % 2 of both blocks (the peer's through
  // distributed shared memory) and reads both halves locally after the
  // cluster barrier; before exchange e + 2 writes the slot again, both
  // blocks have passed exchange e + 1's barrier, so both have read it.
  __device__ float* slot() const { return xch + (seq++ & 1) * 2 * xlen; }

  __device__ float* remote(float* p) const {
    return cg::this_cluster().map_shared_rank(p, rank ^ 1);
  }

  // Combines the block results v[0..K) with the peer block's, in rank
  // order; every thread of both blocks returns the same values.
  template <int K, bool MAX>
  __device__ void combine(float (&v)[K]) const {
    float* s = slot();
    if (threadIdx.x == 0) {
      float* mine = s + rank * xlen;
      float* theirs = remote(mine);
#pragma unroll
      for (int k = 0; k < K; ++k) mine[k] = theirs[k] = v[k];
    }
    cg::this_cluster().sync();
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = MAX ? nan_max(s[k], s[xlen + k]) : s[k] + s[xlen + k];
  }

  // ---- the hooks of admm_core.cuh ---------------------------------------

  // A' w over this block's rows, w local.  Lane (jj, c) of a warp task
  // (span s of 32 columns, pass p) sums column 32 s + 4 jj + p over the
  // rows r = c mod 4, eight rows a step into four accumulators so that
  // eight loads are in flight; a warp's reads of one row step fall on the
  // banks (r + j) mod 32, all different.  With CS = 2 the two blocks'
  // partial sums meet in distributed shared memory and epi gets their sum.
  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int c = lane & 3, jj = lane >> 2, rsm = min(rs, ml);
    float* part = nullptr;
    if constexpr (CS > 1) part = slot();
    const int tasks = ((n + 31) >> 5) * 4;
    for (int t = wp; t < tasks; t += nw) {
      const int j = 32 * (t >> 2) + 4 * jj + (t & 3);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (j < n) {
        int r = c;
        for (; r + 28 < rsm; r += 32) {
#pragma unroll
          for (int u = 0; u < 8; ++u) a[u & 3] = fmaf(As[(r + 4 * u) * ld + j], w[r + 4 * u], a[u & 3]);
        }
        for (; r < rsm; r += 4) a[0] = fmaf(As[r * ld + j], w[r], a[0]);
        for (; r + 28 < ml; r += 32) {
#pragma unroll
          for (int u = 0; u < 8; ++u)
            a[u & 3] = fmaf(Ag[(r + 4 * u - rs) * n + j], w[r + 4 * u], a[u & 3]);
        }
        for (; r < ml; r += 4) a[1] = fmaf(Ag[(r - rs) * n + j], w[r], a[1]);
      }
      float acc = (a[0] + a[1]) + (a[2] + a[3]);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (c == 0 && j < n) {
        if constexpr (CS > 1) {
          part[rank * xlen + j] = acc;
          remote(part)[rank * xlen + j] = acc;
        } else {
          epi(j, acc);
        }
      }
    }
    if constexpr (CS > 1) {
      cg::this_cluster().sync();
      for (int j = threadIdx.x; j < n; j += blockDim.x) epi(j, part[j] + part[xlen + j]);
    }
  }

  // A v for this block's rows.  A warp task is 8 rows; lane (ii, c) sums
  // row ii over columns 32 s + 8 c + e (e < 8) of every span s, eight loads
  // in flight a span, so a warp's reads fall on the banks (ii + 8 c + e)
  // mod 32, all different.
  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    const int c = lane & 3, ii = lane >> 2, rsm = min(rs, ml);
    for (int i0 = 8 * wp; i0 < ml; i0 += 8 * nw) {
      const int i = i0 + ii;
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (i < rsm) {
        const float* r = As + i * ld;
#pragma unroll 2
        for (int j = 8 * c; j < n; j += 32) {
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e & 3] = fmaf(r[j + e], v[j + e], a[e & 3]);
        }
      } else if (i < ml) {
        const float* r = Ag + (i - rs) * n;
#pragma unroll 2
        for (int j = 8 * c; j < n; j += 32) {
#pragma unroll
          for (int e = 0; e < 8; ++e) a[e & 3] = fmaf(r[j + e], v[j + e], a[e & 3]);
        }
      }
      float acc = (a[0] + a[1]) + (a[2] + a[3]);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (c == 0 && i < ml) epi(i, acc);
    }
  }

  // (P v)_k = P_{k,k} v_k + P_{k,k-1} v_{k-1} + P_{k+1,k}' v_{k+1}
  __device__ void pmv(const float* v, float* out) const {
    constexpr int nb2 = BB * BB;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int k = r / BB, i = r - k * BB, o = k * BB;
      const float* d = pd + (size_t)k * nb2 + i * BB;
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < BB; ++j) acc = fmaf(d[j], v[o + j], acc);
      if (k > 0) {
        const float* e = pe + (size_t)(k - 1) * nb2 + i * BB;
        float a2 = 0.f;
#pragma unroll
        for (int j = 0; j < BB; ++j) a2 = fmaf(e[j], v[o - BB + j], a2);
        acc += a2;
      }
      if (k + 1 < T) {
        const float* e = pe + (size_t)k * nb2 + i;
        float a3 = 0.f;
#pragma unroll
        for (int j = 0; j < BB; ++j) a3 = fmaf(e[j * BB], v[o + BB + j], a3);
        acc += a3;
      }
      out[r] = acc;
    }
  }

  // out = M^-1 b in four phases; the caller's barrier follows.  The block
  // forms c_k = L_k^-1 b_k (into out); warp 0 runs the forward chain
  // w_k = c_k - G_k w_{k-1} in place; the block forms d_k = L_k^-T w_k
  // (into tw); warp 0 runs the backward chain x_k = d_k - H_k x_{k+1}.
  // In a chain lane i < BB owns row i: the next block's coupling row and
  // right-hand side are loaded a step ahead, and the previous block comes
  // by __shfl_sync, so each step waits only for its own matvec.
  __device__ void apply_minv(const float* b, float* out) const {
    constexpr int nb2 = BB * BB;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int k = r / BB, i = r - k * BB;
      const float* L = Li + k * nb2 + i * BB;
      const float* bk = b + k * BB;
      float c = 0.f;
#pragma unroll
      for (int q = 0; q < BB; ++q)
        if (q <= i) c = fmaf(L[q], bk[q], c);
      out[r] = c;
    }
    __syncthreads();
    if (threadIdx.x < 32) chain(G, out, out, 1);
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int k = r / BB, i = r - k * BB;
      const float* L = Li + k * nb2 + i;
      const float* wk = out + k * BB;
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < BB; ++q)
        if (q >= i) d = fmaf(L[q * BB], wk[q], d);
      tw[r] = d;
    }
    __syncthreads();
    if (threadIdx.x < 32) chain(H, tw, out, -1);
  }

  // One sweep chain by warp 0: y_k = rhs_k - C_k y_{k-dir} for the blocks
  // in order dir (1: k = 0 .. T-1 with C = G; -1: k = T-1 .. 0 with
  // C = H), y_first = rhs_first.  rhs and y may alias.
  __device__ void chain(const float* C, const float* rhs, float* y, int dir) const {
    constexpr int nb2 = BB * BB;
    const int i = threadIdx.x;
    const bool row = i < BB;
    const int ir = row ? i : 0, k0 = dir > 0 ? 0 : T - 1;
    float prev = rhs[k0 * BB + ir];
    if (row) y[k0 * BB + i] = prev;
    int k = k0 + dir;
    const int kc = dir > 0 ? min(k, T - 1) : max(k, 0);
    float g[BB];
#pragma unroll
    for (int j = 0; j < BB; ++j) g[j] = C[kc * nb2 + ir * BB + j];
    float rk = rhs[kc * BB + ir];
    for (int s = 1; s < T; ++s, k += dir) {
      // next step's row and right-hand side (clamped at the end)
      const int kn = dir > 0 ? min(k + 1, T - 1) : max(k - 1, 0);
      float gn[BB];
#pragma unroll
      for (int j = 0; j < BB; ++j) gn[j] = C[kn * nb2 + ir * BB + j];
      const float rn = rhs[kn * BB + ir];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int j = 0; j < BB; j += 2) {
        a0 = fmaf(g[j], __shfl_sync(0xffffffffu, prev, j), a0);
        a1 = fmaf(g[j + 1], __shfl_sync(0xffffffffu, prev, j + 1), a1);
      }
      prev = rk - (a0 + a1);
      if (row) y[k * BB + i] = prev;
#pragma unroll
      for (int j = 0; j < BB; ++j) g[j] = gn[j];
      rk = rn;
    }
  }

  // Gram band, then block-Thomas into Li (L_k^-1), G, H.  Returns the
  // block-uniform (and cluster-uniform) fail flag.
  __device__ bool factor(const float* rv) const {
    constexpr int nb2 = BB * BB;
    constexpr int S = BB <= 8 ? 4 : (BB <= 16 ? 2 : 1);  // row slices per band row
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    const int total = n * S, tot = T * nb2, rsm = min(rs, ml);
    // thread (band row k BB + i, slice c) sums row i of D_k (into Li) and
    // of E_k (into H) over this block's rows r = c mod S
    for (int base = 32 * wp; base < total; base += blockDim.x) {
      const int e = base + lane, c = e % S, rb = e / S, k = rb / BB, i = rb - k * BB;
      const bool valid = e < total, has_e = valid && k + 1 < T;
      float d[BB], f[BB];
#pragma unroll
      for (int j = 0; j < BB; ++j) d[j] = f[j] = 0.f;
      if (valid) {
        const int ca = k * BB;
        for (int r = c; r < rsm; r += S) {
          const float* a = As + (size_t)r * ld;
          const float ai = a[ca + i] * rv[r];
          const float ei = has_e ? a[ca + BB + i] * rv[r] : 0.f;
#pragma unroll
          for (int j = 0; j < BB; ++j) {
            d[j] = fmaf(ai, a[ca + j], d[j]);
            f[j] = fmaf(ei, a[ca + j], f[j]);
          }
        }
        for (int r = rsm + ((c - rsm) % S + S) % S; r < ml; r += S) {
          const float* a = Ag + (size_t)(r - rs) * n;
          const float ai = a[ca + i] * rv[r];
          const float ei = has_e ? a[ca + BB + i] * rv[r] : 0.f;
#pragma unroll
          for (int j = 0; j < BB; ++j) {
            d[j] = fmaf(ai, a[ca + j], d[j]);
            f[j] = fmaf(ei, a[ca + j], f[j]);
          }
        }
      }
#pragma unroll
      for (int o = 1; o < S; o <<= 1) {
#pragma unroll
        for (int j = 0; j < BB; ++j) {
          d[j] += __shfl_xor_sync(0xffffffffu, d[j], o);
          f[j] += __shfl_xor_sync(0xffffffffu, f[j], o);
        }
      }
      if (valid && c == 0) {
        const int o = k * nb2 + i * BB;
#pragma unroll
        for (int j = 0; j < BB; ++j) {
          if constexpr (CS > 1) {  // partial sums; combined below
            Li[o + j] = d[j];
            H[o + j] = f[j];
          } else {
            Li[o + j] = pd[o + j] + (i == j ? sigma : 0.f) + d[j];
            H[o + j] = pe[o + j] + f[j];
          }
        }
      }
    }
    if constexpr (CS > 1) {
      // each block pushes its partial of D (then of E) into the peer's G
      // (free until Thomas) and adds the peer's, pushed into its own G
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();  // the peer is past its last read of G
      float* peer_g = remote(G);
      for (int e = threadIdx.x; e < tot; e += blockDim.x) peer_g[e] = Li[e];
      cl.sync();
      for (int e = threadIdx.x; e < tot; e += blockDim.x) {
        const int ij = e % nb2, i = ij / BB, j = ij - i * BB;
        Li[e] = pd[e] + (i == j ? sigma : 0.f) + (Li[e] + G[e]);
      }
      cl.sync();
      for (int e = threadIdx.x; e < tot; e += blockDim.x) peer_g[e] = H[e];
      cl.sync();
      for (int e = threadIdx.x; e < tot; e += blockDim.x) H[e] = pe[e] + (H[e] + G[e]);
    }
    __syncthreads();
    ADMM_PHASE_END(kPhGram);
    ADMM_PHASE_BEGIN(kPhThomas);
    if (threadIdx.x < 32) {
      const bool fail = thomas();
      if (threadIdx.x == 0) flag[0] = fail ? 1.f : 0.f;
    }
    __syncthreads();
    return flag[0] != 0.f;
  }

  // Block-Thomas by warp 0 (see the header); D_k in Li and E_k in H on
  // entry.  F_{-1} = 0 (Fs zeroed), so every step runs the same code, and
  // G_0 = 0.  Returns the warp-uniform fail flag.
  __device__ bool thomas() const {
    constexpr int nb2 = BB * BB, LD = BB + 1;
    const int i = threadIdx.x;
    const bool row = i < BB;
    const int ir = row ? i : 0;
    float f[BB];  // row i of F_{k-1}
#pragma unroll
    for (int j = 0; j < BB; ++j) {
      f[j] = 0.f;
      if (row) Fs[i * LD + j] = 0.f;
    }
    __syncwarp();
    bool fail = false;
    for (int k = 0; k < T; ++k) {
      float* Dk = Li + k * nb2;
      float* Ek = H + k * nb2;
      float s[BB], e[BB];
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        s[j] = Dk[ir * BB + j];
        e[j] = Ek[ir * BB + j];
      }
      // S_k = D_k - F_{k-1} F_{k-1}', row i
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int l = 0; l < BB; ++l) acc = fmaf(f[l], Fs[j * LD + l], acc);
        s[j] -= acc;
      }
      // Cholesky by columns, row i in lane i
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        const float dj = __shfl_sync(0xffffffffu, s[j], j);
        fail = fail || (dj <= 0.f) || isnan(dj);
        const float dc = nan_max(dj, 1e-30f);
        s[j] = i > j ? s[j] * rsqrtf(dc) : (i == j ? sqrtf(dc) : s[j]);
#pragma unroll
        for (int c = j + 1; c < BB; ++c) {
          const float lcj = __shfl_sync(0xffffffffu, s[j], c);
          if (i >= c) s[c] = fmaf(-s[j], lcj, s[c]);
        }
      }
#pragma unroll
      for (int j = 0; j < BB; ++j)
        if (row && j <= i) Ls[i * LD + j] = s[j];
      __syncwarp();
      // L_k^-1 by columns, column i in lane i (forward substitution, each
      // row scaled by 1 / max(L_rr, 1e-30)), over D_k
      float rinv[BB], li[BB];
#pragma unroll
      for (int r = 0; r < BB; ++r) rinv[r] = 1.f / nan_max(Ls[r * LD + r], 1e-30f);
#pragma unroll
      for (int r = 0; r < BB; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < r; ++q)
          if (q >= i) acc = fmaf(Ls[r * LD + q], li[q], acc);
        li[r] = r >= i ? ((r == i ? 1.f : 0.f) - acc) * rinv[r] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < BB; ++r)
        if (row) Dk[r * BB + i] = li[r];
      __syncwarp();
      // G_k = L_k^-1 F_{k-1} and F_k = E_k L_k^-T, row i
      float lr[BB];
#pragma unroll
      for (int q = 0; q < BB; ++q) lr[q] = Dk[ir * BB + q];
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < BB; ++q)
          if (q <= i) acc = fmaf(lr[q], Fs[q * LD + j], acc);
        if (row) G[k * nb2 + i * BB + j] = acc;
      }
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q <= j; ++q) acc = fmaf(e[q], Dk[j * BB + q], acc);
        f[j] = acc;
      }
      __syncwarp();  // every lane is done with F_{k-1} in Fs
#pragma unroll
      for (int j = 0; j < BB; ++j)
        if (row) Fs[i * LD + j] = f[j];
      __syncwarp();
      // H_k = L_k^-T F_k', row i (over E_k's row i, read above)
#pragma unroll
      for (int j = 0; j < BB; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < BB; ++q)
          if (q >= i) acc = fmaf(Dk[q * BB + ir], Fs[j * LD + q], acc);
        if (row) Ek[i * BB + j] = acc;
      }
      __syncwarp();
    }
    return fail;
  }
};

// The cluster's reductions: the block's, then combined with the peer's.
template <int BB, int CS, int K>
__device__ __forceinline__ void op_max(const BandOp<BB, CS>& op, float (&v)[K], float* red) {
  block_max(v, red);
  if constexpr (CS > 1) op.template combine<K, true>(v);
}

template <int BB, int CS, int K>
__device__ __forceinline__ void op_sum(const BandOp<BB, CS>& op, float (&v)[K], float* red) {
  block_sum(v, red);
  if constexpr (CS > 1) op.template combine<K, false>(v);
}

// The exchange count, carried through the Anderson step (op_state).
template <int BB, int CS>
__device__ __forceinline__ int op_state(const BandOp<BB, CS>& op) {
  return op.seq;
}
template <int BB, int CS>
__device__ __forceinline__ void op_set_state(const BandOp<BB, CS>& op, int seq) {
  op.seq = seq;
}

// A block of a cluster adds its share of the n-vectors' terms (they are
// the same in both blocks), so that the combined sums count each once.
template <int BB, int CS>
__device__ __forceinline__ void op_cols(const BandOp<BB, CS>& op, int n, int& j0, int& j1) {
  const int per = (n + CS - 1) / CS;
  j0 = min(n, op.rank * per);
  j1 = min(n, j0 + per);
}

// Shared-memory floats of one block before A's rows: 8 n + 7 m0 vectors
// (m0 = ceil(m / cs) local rows), the reduction slots, the exchange ring
// (cs > 1), the five band arrays, the Thomas scratch and the fail slot.
long long btd_fixed_floats(int n, int m, int bb, int cs) {
  const long long m0 = (m + cs - 1) / cs;
  const long long ring = cs > 1 ? 4LL * (n > 16 ? n : 16) : 0;
  return 8LL * n + 7 * m0 + kRedSlots + ring + 5LL * n * bb + 2LL * bb * (bb + 1) + 1;
}

// Rows of A each block keeps in shared memory (-1 where the rest does not
// fit), beside `extra` floats of an Anderson launch's area.
int btd_block_rows(int n, int m, int bb, int cs, long long extra = 0) {
  const long long spare = (long long)kMaxSmemBytes / 4 - btd_fixed_floats(n, m, bb, cs) - extra;
  if (spare < 0) return -1;
  const long long rows = spare / (n + 1), m0 = (m + cs - 1) / cs;
  return (int)(rows < m0 ? rows : m0);
}

// Rows of A on chip over the blocks of one problem.
int btd_rows_on_chip(int n, int m, int bb, int cs) {
  const int rb = btd_block_rows(n, m, bb, cs);
  if (rb < 0) return -1;
  const int m0 = (m + cs - 1) / cs;
  int rows = 0;
  for (int r = 0; r < cs; ++r) {
    const int ml = r * m0 < m ? (m - r * m0 < m0 ? m - r * m0 : m0) : 0;
    rows += ml < rb ? ml : rb;
  }
  return rows;
}

// The rule: a cluster of two blocks where one block cannot hold all of A
// in shared memory and two hold more of it, or where the batch in single
// blocks would leave half of the card's SMs idle (2 B <= SMs) and two
// blocks hold all of A; else one block.  bb = 8 or 16 only.
int btd_cluster_size(int n, int m, int bb, int batch) {
  if (bb > 16) return 1;  // BTD_INSTANCES has no cluster for them
  const int one = btd_rows_on_chip(n, m, bb, 1), two = btd_rows_on_chip(n, m, bb, 2);
  if (one < m && two > one) return 2;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  return (two == m && 2LL * batch <= sms) ? 2 : 1;
}

// K6 / K7.  Per problem: load the band, the vectors and the leading rows of
// A; rho = rho0 + 0 q_0 (a NaN in q reaches the fail flag through the
// factor), replaced where rho_in > 0 by the same arithmetic select as the
// TPU kernel; the ADMM solve entered with a pending rho, so the first
// epoch factors.  Output x, z, y and stats (9, B): done, iter, res_prim,
// res_dual, fail, rho_updates, rho_estimate, infs, rho of the final factor.
// One body, written in the kernel itself: this unit compiles it as
// qp_btd_kernel (without Anderson, the kernel as it was), and
// qp_kernel_btd_aa.cu as qp_btd_kernel_aa (with it, AA).  Inlined from a
// body function the two shared (as K1 and K3 are), the bb = 8 cluster
// instance without Anderson came out with its loop-carried values
// numbered in another order and other registers (122 a thread against the
// kernel's 126 before Anderson, cuobjdump --dump-resource-usage through
// tools/kernel_ab.py --parts regs on sm_90a).  A unit of its own also
// keeps these instantiations, most of the library's build, in an nvcc
// process of their own.
#ifndef QP_KERNEL_BTD_AA_UNIT
template <int BB, int CS>
__global__ void __launch_bounds__(kThreads) qp_btd_kernel(
#elif !defined(QP_KERNEL_BTD_AAS_UNIT)
// With Anderson the step's registers count in the kernel's.  MINB = 2
// caps them at the 128 a thread of the kernel without it, for the launches
// where that kernel gets two blocks an SM (btd_aa_kernel: internal blocks
// 8 and 16 at shapes whose shared memory allows two), so that the step
// costs no block an SM and spills instead; MINB = 1 leaves them uncapped
// where it gets one (200 / 221 a thread at bb = 8 / 16 on a cluster,
// cuobjdump, sm_90a), which ran K6 at horizon 64, B = 256 2 % faster than
// capped on an H100.
template <int BB, int CS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) qp_btd_kernel_aa(
#else
// The same past kAaGramSmemMemory, where btd_aa_plan puts the chunk's
// system off the Gram area (AaSysArgs: a solve area of the block's shared
// memory or the workspace, solved by columns over the block,
// aa_solve_sys); its registers capped as qp_btd_kernel_aa's
// (btd_aas_kernel).
template <int BB, int CS, int MINB>
__global__ void __launch_bounds__(kThreads, MINB) qp_btd_kernel_aas(
#endif
    StepParams p, int rs, int batch, const float* __restrict__ pdg,
    const float* __restrict__ peg, const float* __restrict__ Ag, const float* __restrict__ qg,
    const float* __restrict__ lg, const float* __restrict__ ug,
    const uint8_t* __restrict__ active, const float* __restrict__ rho_in,
    const float* __restrict__ x0, const float* __restrict__ z0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ z_out, float* __restrict__ y_out,
#ifndef QP_KERNEL_BTD_AA_UNIT
    float* __restrict__ stats) {
  constexpr bool AA = false;
  const AaArgs aa_args{0, nullptr};
#elif !defined(QP_KERNEL_BTD_AAS_UNIT)
    float* __restrict__ stats, AaArgs aa_args) {
  constexpr bool AA = true;
#else
    float* __restrict__ stats, AaArgs aa_args, AaSysArgs sys_args) {
  constexpr bool AA = true;
#endif
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  const int n = p.n, m = p.m, ld = n + 1, T = n / BB, nband = n * BB;
  const size_t b = blockIdx.x / CS;
  const int rank = CS > 1 ? (int)(blockIdx.x % CS) : 0;
  const int m0 = (m + CS - 1) / CS, r0 = rank * m0;
  const int ml = r0 < m ? min(m0, m - r0) : 0;
  const int tid = threadIdx.x, NT = blockDim.x;
  const int xlen = n > 16 ? n : 16;

  float* q = smem;
  float* x = q + n;
  float* bt = x + n;
  float* xt = bt + n;
  float* tn1 = xt + n;
  float* tn2 = tn1 + n;
  float* xp = tn2 + n;
  float* tw = xp + n;  // 8 n
  float* z = tw + n;
  float* y = z + m0;
  float* l = y + m0;
  float* u = l + m0;
  float* rv = u + m0;
  float* tm = rv + m0;
  float* yp = tm + m0;  // 7 m0
  float* red = yp + m0;
  float* xch = red + kRedSlots;
  float* pd = xch + (CS > 1 ? 4 * xlen : 0);
  float* pe = pd + nband;
  float* Li = pe + nband;
  float* G = Li + nband;
  float* H = G + nband;
  float* Fs = H + nband;
  float* Ls = Fs + BB * (BB + 1);
  float* flag = Ls + BB * (BB + 1);
  float* As = flag + 1;  // rs rows of stride ld
  const float* Ab = Ag + (b * (size_t)m + r0) * n;

  for (int j = tid; j < n; j += NT) {
    q[j] = qg[b * n + j];
    x[j] = x0[b * n + j];
  }
  for (int i = tid; i < ml; i += NT) {
    const size_t g = b * m + r0 + i;
    z[i] = z0[g];
    y[i] = y0[g];
    l[i] = lg[g];
    u[i] = ug[g];
  }
  for (int e = tid; e < nband; e += NT) {
    pd[e] = pdg[b * nband + e];
    pe[e] = peg[b * nband + e];
  }
  const int rsl = min(rs, ml);
  for (int e = tid; e < rsl * n; e += NT) {
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

  const BandOp<BB, CS> op{As, Ab + (size_t)rs * n, ld, rs, ml, pd, pe, Li, G, H, Fs, Ls, tw,
                          flag, xch, xlen, rank, n, T, p.sigma, 0};
  StepParams pl = p;
  pl.m = ml;  // the ADMM core sees this block's rows
  if constexpr (AA) {  // Anderson's state: sized for m0 rows a block
    const AaState aa = aa_state(aa_args, smem, 0, blockIdx.x, n, m0);
#ifdef QP_KERNEL_BTD_AAS_UNIT
    admm_solve<BandOp<BB, CS>, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp,
                                   red, st, aa.ring, aa.k, aa.gram,
                                   aa_sys(sys_args, aa.k, smem, 0, blockIdx.x));
#else
    admm_solve<BandOp<BB, CS>, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp,
                                   red, st, aa.ring, aa.k, aa.gram);
#endif
  } else {
    admm_solve<BandOp<BB, CS>, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp,
                                   red, st);
  }

  ADMM_PHASE_END(kPhTotal);
  if (rank == 0)
    for (int j = tid; j < n; j += NT) x_out[b * n + j] = x[j];
  for (int i = tid; i < ml; i += NT) {
    z_out[b * m + r0 + i] = z[i];
    y_out[b * m + r0 + i] = y[i];
  }
  if (rank == 0 && tid == 0) {  // stats is (9, batch): one row per field
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
  // no block leaves before its peer is past the last exchange into it
  if constexpr (CS > 1) cg::this_cluster().sync();
}

// One launch of this unit's kernel (with Anderson in qp_kernel_btd_aa.cu,
// and with the chunk's system off the Gram area in qp_kernel_btd_aas.cu).
#ifdef QP_KERNEL_BTD_AA_UNIT
// The Anderson kernel of a launch at (BB, CS) where the kernel without
// Anderson gets twin_blocks blocks an SM: its registers capped to keep two
// where that kernel gets two (internal blocks up to 16; wider ones get one).
template <int BB, int CS>
auto btd_aa_kernel(int twin_blocks) {
#ifndef QP_KERNEL_BTD_AAS_UNIT
  auto kernel = qp_btd_kernel_aa<BB, CS, 1>;
  if constexpr (BB <= 16)
    if (twin_blocks >= 2) kernel = qp_btd_kernel_aa<BB, CS, 2>;
#else
  auto kernel = qp_btd_kernel_aas<BB, CS, 1>;
  if constexpr (BB <= 16)
    if (twin_blocks >= 2) kernel = qp_btd_kernel_aas<BB, CS, 2>;
#endif
  return kernel;
}
#endif

// twin_blocks: with Anderson, the blocks an SM of the kernel without it
// (btd_aa_kernel); unused without.  sys: the chunk's system of the
// qp_kernel_btd_aas.cu kernels; unused by the others.
template <int BB, int CS>
cudaError_t launch_btd(const StepParams& p, int rs, int batch, size_t smem, cudaStream_t stream,
                       const float* pd, const float* pe, const float* A, const float* q,
                       const float* l, const float* u, const uint8_t* active,
                       const float* rho_in, const float* x0, const float* z0, const float* y0,
                       float* x_out, float* z_out, float* y_out, float* stats, AaArgs aa,
                       int twin_blocks, const AaSysArgs& sys) {
#ifndef QP_KERNEL_BTD_AA_UNIT
  (void)twin_blocks;
  auto kernel = qp_btd_kernel<BB, CS>;
#else
  auto kernel = btd_aa_kernel<BB, CS>(twin_blocks);
#endif
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * CS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = CS > 1 ? 1 : 0;
#ifndef QP_KERNEL_BTD_AA_UNIT
  (void)aa;
  (void)sys;
  return cudaLaunchKernelEx(&cfg, kernel, p, rs, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                            z0, y0, x_out, z_out, y_out, stats);
#elif !defined(QP_KERNEL_BTD_AAS_UNIT)
  (void)sys;
  return cudaLaunchKernelEx(&cfg, kernel, p, rs, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                            z0, y0, x_out, z_out, y_out, stats, aa);
#else
  return cudaLaunchKernelEx(&cfg, kernel, p, rs, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                            z0, y0, x_out, z_out, y_out, stats, aa, sys);
#endif
}

// The ADMM core's parameters of one launch, without Anderson.
StepParams btd_params(int n, int m, float sigma, float alpha, float rho0, float eps_abs,
                      float eps_rel, int n_epochs, int chunks_per_epoch, int seg,
                      int adaptive_rho, float adaptive_rho_tolerance, int check_infeas,
                      float eps_pinf, float eps_dinf) {
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
  p.n_smem_mats = 0;
  p.ws_floats = 0;
  return p;
}

// One launch with cs blocks per problem (1 or 2, as BTD_INSTANCES has them)
// of this unit's kernel and the parameters p, rs rows of A a block and smem
// bytes of shared memory (btd_block_rows, btd_aa_plan); twin_blocks and sys
// as launch_btd's.
cudaError_t launch_btd_as(int cs, const StepParams& p, int bb, const float* pd, const float* pe,
                          const float* A, const float* q, const float* l, const float* u,
                          const uint8_t* active, const float* rho_in, const float* x0,
                          const float* z0, const float* y0, float* x_out, float* z_out,
                          float* y_out, float* stats, int batch, void* stream, AaArgs aa,
                          int rs, size_t smem, int twin_blocks, const AaSysArgs& sys = {});

// The shared memory of a launch without Anderson: the fixed part and rs
// rows of A.
size_t btd_smem_bytes(int n, int m, int bb, int cs, int rs) {
  return (size_t)(btd_fixed_floats(n, m, bb, cs) + (long long)rs * (n + 1)) * 4;
}

}  // namespace

// The kernel's instantiations, X(internal block, blocks per problem); a
// launch at any other pair is refused.  tools/build_timing.py --instances
// compiles this file with each alone (a unit that defines the list first
// and includes the file) to time it.
#ifndef BTD_INSTANCES
#define BTD_INSTANCES X(8, 1) X(8, 2) X(16, 1) X(16, 2) X(24, 1) X(32, 1)
#endif

namespace {

cudaError_t launch_btd_as(int cs, const StepParams& p, int bb, const float* pd, const float* pe,
                          const float* A, const float* q, const float* l, const float* u,
                          const uint8_t* active, const float* rho_in, const float* x0,
                          const float* z0, const float* y0, float* x_out, float* z_out,
                          float* y_out, float* stats, int batch, void* stream, AaArgs aa,
                          int rs, size_t smem, int twin_blocks, const AaSysArgs& sys) {
  const int n = p.n;
  if ((cs != 1 && cs != 2) || bb <= 0 || n % bb != 0 || rs < 0) return cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaErrorInvalidValue;  // unless an instantiation takes (bb, cs)
#define X(BB_, CS_)                                                                        \
  if (bb == BB_ && cs == CS_)                                                              \
    err = launch_btd<BB_, CS_>(p, rs, batch, smem, st, pd, pe, A, q, l, u, active, rho_in, \
                               x0, z0, y0, x_out, z_out, y_out, stats, aa, twin_blocks, sys);
  BTD_INSTANCES
#undef X
  return err;
}

}  // namespace

#ifndef QP_KERNEL_BTD_AA_UNIT
extern "C" {

// Blocks per problem the launcher takes at these sizes (1 or 2).
int qp_btd_cluster_size(int n, int m, int bb, int batch) {
  return btd_cluster_size(n, m, bb, batch);
}

// Blocks an SM that the runtime can hold of the kernel without Anderson at
// cs blocks per problem and its shared memory for this shape
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor): the bound below which
// the Anderson instantiation's placement rule (btd_aa_plan) keeps its ring
// off chip.  A negative CUDA error code on failure.
int qp_btd_twin_blocks(int n, int m, int bb, int cs, int device) {
  const int rs = btd_block_rows(n, m, bb, cs);
  if (rs < 0) return -(int)cudaErrorInvalidValue;
  const size_t smem = btd_smem_bytes(n, m, bb, cs, rs);
  const void* fn = nullptr;
#define X(BB_, CS_) \
  if (bb == BB_ && cs == CS_) fn = (const void*)qp_btd_kernel<BB_, CS_>;
  BTD_INSTANCES
#undef X
  if (fn == nullptr) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, smem);
  return err == cudaSuccess ? blocks : -(int)err;
}

// Rows of A the launch keeps on chip, over the blocks of one problem (-1
// where the band and vectors do not fit).
int qp_btd_smem_rows(int n, int m, int bb, int batch) {
  return btd_rows_on_chip(n, m, bb, btd_cluster_size(n, m, bb, batch));
}

// One launch with cs blocks per problem (1 or 2, as BTD_INSTANCES has them).
int qp_btd_launch_as(int cs, const float* pd, const float* pe, const float* A, const float* q,
                     const float* l, const float* u, const uint8_t* active, const float* rho_in,
                     const float* x0, const float* z0, const float* y0, float* x_out,
                     float* z_out, float* y_out, float* stats, int batch, int n, int m, int bb,
                     float sigma, float alpha, float rho0, float eps_abs, float eps_rel,
                     int n_epochs, int chunks_per_epoch, int seg, int adaptive_rho,
                     float adaptive_rho_tolerance, int check_infeas, float eps_pinf,
                     float eps_dinf, int device, void* stream) {
  if (batch <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const StepParams p = btd_params(n, m, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs,
                                  chunks_per_epoch, seg, adaptive_rho, adaptive_rho_tolerance,
                                  check_infeas, eps_pinf, eps_dinf);
  const int rs = btd_block_rows(n, m, bb, cs);
  err = launch_btd_as(cs, p, bb, pd, pe, A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out,
                      y_out, stats, batch, stream, AaArgs{0, nullptr}, rs,
                      btd_smem_bytes(n, m, bb, cs, rs), 0);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// One launch with the blocks per problem of the rule (qp_btd_cluster_size).
int qp_btd_launch(const float* pd, const float* pe, const float* A, const float* q,
                  const float* l, const float* u, const uint8_t* active, const float* rho_in,
                  const float* x0, const float* z0, const float* y0, float* x_out, float* z_out,
                  float* y_out, float* stats, int batch, int n, int m, int bb, float sigma,
                  float alpha, float rho0, float eps_abs, float eps_rel, int n_epochs,
                  int chunks_per_epoch, int seg, int adaptive_rho, float adaptive_rho_tolerance,
                  int check_infeas, float eps_pinf, float eps_dinf, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);  // the rule reads this card's SM count
  if (err != cudaSuccess) return (int)err;
  return qp_btd_launch_as(btd_cluster_size(n, m, bb, batch), pd, pe, A, q, l, u, active, rho_in,
                          x0, z0, y0, x_out, z_out, y_out, stats, batch, n, m, bb, sigma, alpha,
                          rho0, eps_abs, eps_rel, n_epochs, chunks_per_epoch, seg, adaptive_rho,
                          adaptive_rho_tolerance, check_infeas, eps_pinf, eps_dinf, device,
                          stream);
}

}  // extern "C"

#else  // QP_KERNEL_BTD_AA_UNIT: the Anderson kernels' entry points

extern "C" int qp_btd_twin_blocks(int n, int m, int bb, int cs, int device);  // qp_kernel_btd.cu

namespace {

// Where an Anderson launch keeps each block's Anderson state.  Up to a
// memory k of kAaGramSmemMemory: the Gram area (aa_gram_floats: the kept
// Gram Gk and the chunk's system) in shared memory after A's rows (where
// shared memory is full of A's rows, it takes the room of the last ones),
// and its ring (aa_ring_floats for m0 rows) after it where, with both, the
// block still holds as many rows of A as the kernel without Anderson and
// shared memory still allows as many blocks an SM as that kernel gets
// (twin_blocks, qp_btd_twin_blocks); else the ring stays in the device
// workspace.  Past it the chunk's system leaves the Gram area, which every
// pivot of the k x k solve reads and writes (rows on lanes, aa_solve: the
// step ran 3-7x the step at memory 4), for a solve area by columns that
// the whole block solves (AaSolve, aa_solve_sys; the qp_kernel_btd_aas.cu
// kernels), and each area goes to shared memory only where it costs the
// kernel without Anderson no row of A and no block an SM: Gk's Gram area
// and a solve area both where the two together keep those (with the ring
// too, where all three do), else the solve area alone (Gk at the head of
// the block's workspace slice), else the system to the workspace (a slice
// of AaSysArgs::sys_ws) and the Gram area on chip where it alone keeps
// them.  Decided by forcing every placement on an H100, in turns (PERF.md
// section 6): a build with -DAA_FORCE_SOLVE=p forces past kAaGramSmemMemory
// the parent's whole Gram area in shared memory (p = 0, the system in it,
// qp_btd_kernel_aa), a solve area (1) or the workspace (3), and with
// -DAA_FORCE_GRAM=g Gk on chip (1) or in the workspace (0)
// (tools/kernel_ab.py --parts placements).  ops/qp_kernel.py:
// anderson_placement is the rule's Python mirror.
#ifndef AA_FORCE_SOLVE
#define AA_FORCE_SOLVE -1
#endif
#ifndef AA_FORCE_GRAM
#define AA_FORCE_GRAM 1
#endif
struct BtdAaPlan {
  bool ring, gram;  // the ring, the Gram area (Gk) in shared memory
  int solve;        // AaSolve: kAaSolveGram, kAaSolveScope or kAaSolveWorkspace
  int rs, twin_rs;  // rows of A a block, with Anderson and without
  long long smem_bytes, twin_smem, sm_off, area;
  long long sys_off, sys_floats;  // the solve area's offset and floats with its head
};

BtdAaPlan btd_aa_plan(int n, int m, int bb, int cs, int k, int twin_blocks) {
  const long long m0 = (m + cs - 1) / cs, fixed = btd_fixed_floats(n, m, bb, cs);
  const long long g = aa_gram_floats(k), r = aa_ring_floats(k, n, (int)m0);
  const long long s = kAaSolveHead + aa_solve_floats(k);
  BtdAaPlan P{};
  P.twin_rs = btd_block_rows(n, m, bb, cs);
  P.twin_smem = (long long)btd_smem_bytes(n, m, bb, cs, P.twin_rs);
  // `area` floats more keep the twin's rows of A and its blocks an SM
  auto keeps = [&](long long area) {
    const long long with = (fixed + area + (long long)P.twin_rs * (n + 1)) * 4;
    return P.twin_rs >= 0 && btd_block_rows(n, m, bb, cs, area) == P.twin_rs &&
           with <= kMaxSmemBytes && smem_blocks_per_sm(with) >= twin_blocks;
  };
  if (k <= kAaGramSmemMemory) {
    P.ring = keeps(g + r);
    P.gram = true;
    P.solve = kAaSolveGram;
  } else if (AA_FORCE_SOLVE >= 0) {
    P.solve = AA_FORCE_SOLVE;
    P.gram = P.solve == kAaSolveGram || AA_FORCE_GRAM == 1;
  } else {
    P.ring = keeps(g + r + s);
    const bool both = P.ring || keeps(g + s), sys = both || keeps(s);
    P.gram = both || (!sys && keeps(g));
    P.solve = sys ? kAaSolveScope : kAaSolveWorkspace;
  }
  P.area = (P.gram ? g : 0) + (P.ring ? r : 0);
  P.sys_floats = P.solve == kAaSolveScope ? s : 0;
  const long long extra = P.area + P.sys_floats;
  P.rs = extra == 0 ? P.twin_rs : btd_block_rows(n, m, bb, cs, extra);
  P.sm_off = fixed + (long long)P.rs * (n + 1);
  const long long sys_start = P.sm_off + P.area;  // the solve area after the Gram area
  P.sys_off = (sys_start + kAaSolveHead) & ~3LL;
  P.smem_bytes = (sys_start + P.sys_floats) * 4;
  return P;
}

// The plan of a launch on this card, with the blocks an SM of the kernel
// without Anderson (twin); a CUDA error code, or 0.
int btd_aa_launch_plan(int n, int m, int bb, int cs, int k, int device, BtdAaPlan& P,
                       int& twin) {
  if (k <= 0) return (int)cudaErrorInvalidValue;
  twin = qp_btd_twin_blocks(n, m, bb, cs, device);
  if (twin < 0) return -twin;
  P = btd_aa_plan(n, m, bb, cs, k, twin);
  if (P.rs < 0 || P.smem_bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  return 0;
}

// qp_btd_launch_aa's launch of this unit's kernel by the plan P: the slices
// of aa_ws one a block of batch x cs, the chunk systems of
// kAaSolveWorkspace after them (admm_aa_floats counts their room).
int btd_aa_launch(const BtdAaPlan& P, int twin, int cs, const float* pd, const float* pe,
                  const float* A, const float* q, const float* l, const float* u,
                  const uint8_t* active, const float* rho_in, const float* x0, const float* z0,
                  const float* y0, float* x_out, float* z_out, float* y_out, float* stats,
                  int batch, int n, int m, int bb, float sigma, float alpha, float rho0,
                  float eps_abs, float eps_rel, int n_epochs, int chunks_per_epoch, int seg,
                  int adaptive_rho, float adaptive_rho_tolerance, int check_infeas,
                  float eps_pinf, float eps_dinf, void* stream, int aa_mem, float* aa_ws) {
  const StepParams p = btd_params(n, m, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs,
                                  chunks_per_epoch, seg, adaptive_rho, adaptive_rho_tolerance,
                                  check_infeas, eps_pinf, eps_dinf);
  const int m0 = (m + cs - 1) / cs;
  const size_t slices = (size_t)batch * cs * aa_floats(aa_mem, n, m0);
  const AaSysArgs sys{P.solve, P.sys_off, 0, aa_ws + ((slices + 3) & ~(size_t)3)};
  cudaError_t err = launch_btd_as(
      cs, p, bb, pd, pe, A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out, stats,
      batch, stream,
      AaArgs{aa_mem, aa_ws, P.sm_off, (int)P.area, P.ring ? 1 : 0, P.gram ? 0 : 1}, P.rs,
      (size_t)P.smem_bytes, twin, sys);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The Anderson kernel of this unit for a launch at (bb, cs) with twin, its
// blocks an SM at smem_bytes into blocks; a CUDA error code.
int btd_aa_blocks(int bb, int cs, int twin, long long smem_bytes, int* blocks) {
  const void* fn = nullptr;
#define X(BB_, CS_) \
  if (bb == BB_ && cs == CS_) fn = (const void*)btd_aa_kernel<BB_, CS_>(twin);
  BTD_INSTANCES
#undef X
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kThreads, smem_bytes);
  return (int)err;
}

}  // namespace

#define QP_BTD_AA_ARGS                                                                        \
  int cs, const float *pd, const float *pe, const float *A, const float *q, const float *l,  \
      const float *u, const uint8_t *active, const float *rho_in, const float *x0,           \
      const float *z0, const float *y0, float *x_out, float *z_out, float *y_out,            \
      float *stats, int batch, int n, int m, int bb, float sigma, float alpha, float rho0,   \
      float eps_abs, float eps_rel, int n_epochs, int chunks_per_epoch, int seg,             \
      int adaptive_rho, float adaptive_rho_tolerance, int check_infeas, float eps_pinf,      \
      float eps_dinf, int device, void *stream, int aa_mem, float *aa_ws
#define QP_BTD_AA_CALL                                                                        \
  cs, pd, pe, A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out, stats, batch, n, \
      m, bb, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs, chunks_per_epoch, seg,         \
      adaptive_rho, adaptive_rho_tolerance, check_infeas, eps_pinf, eps_dinf

extern "C" {

#ifndef QP_KERNEL_BTD_AAS_UNIT
// The entries of qp_kernel_btd_aas.cu, whose kernels take the launches
// whose chunk system is off the Gram area (null in a library built
// without that unit: such a launch is refused).
__attribute__((weak)) int qp_btd_launch_aas(QP_BTD_AA_ARGS);
__attribute__((weak)) int qp_btd_aas_blocks(int bb, int cs, int twin, long long smem_bytes,
                                            int* blocks);

// The placement of an Anderson launch at n, m, internal block bb, cs blocks
// per problem and memory k on this card, into out[12]: the ring in shared
// memory (1) or in the workspace (0), a block's shared-memory bytes, those
// of the kernel without Anderson, that kernel's blocks an SM and this
// one's (cudaOccupancyMaxActiveBlocksPerMultiprocessor), the Gram area's
// and the ring's floats a block, rows of A a block with Anderson and
// without, the Gram area in shared memory (1) or in the Anderson workspace
// (0), where the chunk's system goes (AaSolve) and the floats of the
// block's solve area in shared memory (btd_aa_plan).  Returns a CUDA error
// code.
int qp_btd_aa_placement(int n, int m, int bb, int cs, int k, int device, long long* out) {
  BtdAaPlan P;
  int twin = 0, blocks = 0;
  int err = btd_aa_launch_plan(n, m, bb, cs, k, device, P, twin);
  if (err == 0 && P.solve == kAaSolveGram)
    err = btd_aa_blocks(bb, cs, twin, P.smem_bytes, &blocks);
  else if (err == 0)
    err = qp_btd_aas_blocks ? qp_btd_aas_blocks(bb, cs, twin, P.smem_bytes, &blocks)
                            : (int)cudaErrorInvalidDeviceFunction;
  if (err != 0) return err;
  const long long m0 = (m + cs - 1) / cs;
  const long long v[12] = {P.ring ? 1 : 0, P.smem_bytes, P.twin_smem, twin, blocks,
                           aa_gram_floats(k), aa_ring_floats(k, n, (int)m0), P.rs, P.twin_rs,
                           P.gram ? 1 : 0, P.solve, P.sys_floats};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}

// qp_btd_launch_as with Anderson acceleration of any memory aa_mem > 0, cs
// blocks per problem (1 or 2; 0: the rule's, qp_btd_cluster_size), its
// state in shared memory and aa_ws (btd_aa_plan): batch x cs slices of
// admm_aa_floats(aa_mem, n, ceil(m / cs)) floats, one a block.  A launch
// whose chunk system is off the Gram area runs qp_kernel_btd_aas.cu's
// kernels (qp_btd_launch_aas).
int qp_btd_launch_aa(QP_BTD_AA_ARGS) {
  if (batch <= 0) return 0;
  if (aa_mem <= 0 || aa_ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t cerr = cudaSetDevice(device);  // the rule reads this card's SM count
  if (cerr != cudaSuccess) return (int)cerr;
  if (cs == 0) cs = btd_cluster_size(n, m, bb, batch);
  BtdAaPlan P;
  int twin = 0;
  const int err = btd_aa_launch_plan(n, m, bb, cs, aa_mem, device, P, twin);
  if (err != 0) return err;
  if (P.solve != kAaSolveGram)
    return qp_btd_launch_aas ? qp_btd_launch_aas(QP_BTD_AA_CALL, device, stream, aa_mem, aa_ws)
                             : (int)cudaErrorInvalidDeviceFunction;
  return btd_aa_launch(P, twin, QP_BTD_AA_CALL, stream, aa_mem, aa_ws);
}
#else
// The blocks an SM of this unit's kernel at (bb, cs), twin and smem_bytes
// (qp_btd_aa_placement's report of a launch off the Gram area).
int qp_btd_aas_blocks(int bb, int cs, int twin, long long smem_bytes, int* blocks) {
  return btd_aa_blocks(bb, cs, twin, smem_bytes, blocks);
}

// qp_btd_launch_aa's launches whose chunk system btd_aa_plan puts off the
// Gram area (cs as the rule's or the caller's).
int qp_btd_launch_aas(QP_BTD_AA_ARGS) {
  if (batch <= 0) return 0;
  if (aa_mem <= 0 || aa_ws == nullptr || cs <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t cerr = cudaSetDevice(device);
  if (cerr != cudaSuccess) return (int)cerr;
  BtdAaPlan P;
  int twin = 0;
  const int err = btd_aa_launch_plan(n, m, bb, cs, aa_mem, device, P, twin);
  if (err != 0) return err;
  if (P.solve == kAaSolveGram) return (int)cudaErrorInvalidValue;
  return btd_aa_launch(P, twin, QP_BTD_AA_CALL, stream, aa_mem, aa_ws);
}
#endif

}  // extern "C"
#endif  // QP_KERNEL_BTD_AA_UNIT
