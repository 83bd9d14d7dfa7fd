// The blocked, register-tiled dense factor and the lane-split matvecs of
// the SQP-step (K1) and polish-KKT (K2) kernels in qp_kernel.cu, and the
// in-place factor of the SPD-inverse kernel's (K4) blocked layout.  K3's
// block layout keeps the column factor of admm_core.cuh.
//
//   gram_build      M = P + sigma I + A' diag(w) A (lower triangle): each
//                   thread a register tile of 3 Q^2 entries (48 at Q = 4),
//                   2Q + 2Q operands a step of k; P and sigma added by a
//                   row pass
//   chol_blocked    right-looking Cholesky in panels of 32 columns: one
//                   warp factors the panel's diagonal block in registers
//                   (shuffles only), one thread per row solves the rows
//                   below it, the block updates the trailing matrix with a
//                   register-tiled SYRK.  Per element the same fmaf chain,
//                   in the same column order, as cholesky_inplace, the
//                   pivot rule included: d clamped to max(d, 1e-30), fail
//                   = d <= 0 | NaN, column by column
//   tri_inv_blocked L^-1 in blocks of 32: the diagonal blocks inverted at
//                   once, one warp each (the forward substitution of
//                   tri_inv, a lane a column), then by block distance Li_ij = -Li_ii
//                   sum_{k=j}^{i-1} L_ik Li_kj in register-tiled products;
//                   the upper triangle is zeroed, or holds Li' (K2's sweeps
//                   then read both triangles by rows)
//   ltl_tiles       Minv = Li' Li, register tiles of the lower triangle,
//                   mirrored into the upper (K1's explicit Minv)
//   tri_inv_inplace, ltl_inplace
//                   the same two steps in the one matrix that holds L, as
//                   LAPACK's trtri and lauum: L^-1 by 32-row block rows
//                   (each block row's sums read L before its L^-1 replaces
//                   it), then L^-T L^-1 by block rows; per element the
//                   fmaf chains of tri_inv_blocked and ltl_tiles
//   rows_dot, tri_rows_dot, cols_dot
//                   M x and M' w with each dot product split over L lanes
//                   (eight or more loads in flight) and reduced by
//                   shuffles; the triangular ones pair row i with row
//                   n - 1 - i so that every lane does the same work
//
// Matrices have the row stride n + 1 of the kernels' layouts, which at
// n = 32 and 128 is 1 mod 32: the lane-to-entry maps below keep a warp's
// reads of one step on distinct banks for such a stride.  Every barrier is
// reached by the whole block; the branches around them depend on n alone.

#pragma once

#include "admm_core.cuh"

namespace {

constexpr int kPanel = 32;           // Cholesky panel and L^-1 block width
constexpr unsigned kFull = 0xffffffffu;

// ---- register tiles over a lower triangle --------------------------------
// Thread tile (tr, tc), tr, tc < H = ceil(ceil(r / Q) / 2), holds rows
// {Q tr + a, Q (tr + H) + a} and columns {Q tc + b, Q (tc + H) + b}
// (a, b < Q).  Rows below QH against columns from QH on lie above the
// diagonal for every thread and are skipped; the other 3 Q^2 entries are
// computed (48 at Q = 4 for 256 threads, 12 at Q = 2, whose registers
// leave room for several blocks of 128 threads an SM).  A warp task is 4
// tile rows by 8 tile columns, so that a warp's 32 reads of one operand
// row fall on 4 + 8 addresses Q floats apart.
template <int Q>
struct QuadTile {
  int row[2 * Q], col[2 * Q];    // indices in [0, r + 2Q)
  int rowc[2 * Q], colc[2 * Q];  // clamped to r - 1, for the loads
  int kstart;                    // the least row of the entries the tile needs
};

template <int Q>
__device__ __forceinline__ int quad_slot(int ri, int cj) {
  return ri < Q ? ri * Q + cj : Q * Q + (ri - Q) * 2 * Q + cj;
}

template <int Q, class Body>
__device__ void for_quad_tiles(int r, Body body) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int H = ((r + Q - 1) / Q + 1) / 2;
  const int tcb = (H + 7) / 8, tasks = ((H + 3) / 4) * tcb;
  for (int q = wp; q < tasks; q += nw) {
    const int tr = 4 * (q / tcb) + (lane >> 3), tc = 8 * (q % tcb) + (lane & 7);
    if (tr >= H || tc >= H) continue;
    QuadTile<Q> t;
#pragma unroll
    for (int a = 0; a < 2 * Q; ++a) {
      t.row[a] = Q * (a < Q ? tr : tr + H) + (a % Q);
      t.col[a] = Q * (a < Q ? tc : tc + H) + (a % Q);
      t.rowc[a] = min(t.row[a], r - 1);
      t.colc[a] = min(t.col[a], r - 1);
    }
    t.kstart = tr >= tc ? Q * tr : Q * (tr + H);
    body(t);
  }
}

// Lower triangle of the r x r block C (stride ldc) from the operand X:
//   kGram: C[i][j] = sum_{k < kdim} (X[k][i] w[k]) X[k][j]     (X k-major)
//          (w == nullptr: no scale, k from the tile's kstart: L' L with
//          the zero upper triangle of X = L^-1 skipped);
//   else:  C[i][j] -= sum_{k < kdim} X[i][k] X[j][k]          (X row-major)
//          one fmaf per k in k order, the chain of cholesky_inplace.
// kMirror also writes C[j][i].  No sync.
template <int Q, bool kGram, bool kMirror>
__device__ void tile_products(float* C, int ldc, const float* X, int ldx, const float* w,
                              int r, int kdim) {
  constexpr int R = 2 * Q;
  for_quad_tiles<Q>(r, [&](const QuadTile<Q>& t) {
    float acc[3 * Q * Q];
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        if (a < Q && b >= Q) continue;
        acc[quad_slot<Q>(a, b)] = kGram ? 0.f : C[t.rowc[a] * ldc + t.colc[b]];
      }
    const int k0 = (kGram && w == nullptr) ? t.kstart : 0;
    for (int k = k0; k < kdim; ++k) {
      float x[R], y[R];
      if (kGram) {
        const float* xk = X + (size_t)k * ldx;
        const float wk = w ? w[k] : 1.f;
#pragma unroll
        for (int a = 0; a < R; ++a) {
          x[a] = w ? xk[t.rowc[a]] * wk : xk[t.rowc[a]];
          y[a] = xk[t.colc[a]];
        }
      } else {
#pragma unroll
        for (int a = 0; a < R; ++a) {
          x[a] = -X[(size_t)t.rowc[a] * ldx + k];
          y[a] = X[(size_t)t.colc[a] * ldx + k];
        }
      }
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int b = 0; b < R; ++b) {
          if (a < Q && b >= Q) continue;
          acc[quad_slot<Q>(a, b)] = fmaf(x[a], y[b], acc[quad_slot<Q>(a, b)]);
        }
    }
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int b = 0; b < R; ++b) {
        if (a < Q && b >= Q) continue;
        const int i = t.row[a], j = t.col[b];
        if (i < r && j <= i) {
          C[i * ldc + j] = acc[quad_slot<Q>(a, b)];
          if (kMirror) C[j * ldc + i] = acc[quad_slot<Q>(a, b)];
        }
      }
  });
}

// f(i, j, src[i * lds + j]) for i < rows and j < cols (j <= i too with
// lower), by rows: a warp a row, lanes on consecutive entries.  No sync.
template <class F>
__device__ void map_rows(const float* src, int lds, int rows, int cols, bool lower, F f) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int i = wp; i < rows; i += nw)
    for (int j = lane; j < (lower ? min(cols, i + 1) : cols); j += 32)
      f(i, j, src[(size_t)i * lds + j]);
}

// W (lower triangle) = P + sigma I + A' diag(w) A, A (m x n, stride lda),
// P (stride ldp, in device memory).  The sums as schur_build's; P + sigma
// is added by rows, lanes on consecutive entries.  Ends with a barrier.
template <int Q>
__device__ void gram_build(float* W, int ldw, const float* P, int ldp, const float* A, int lda,
                           const float* w, float sigma, int n, int m) {
  ADMM_PHASE_BEGIN(kPhGram);
  tile_products<Q, true, false>(W, ldw, A, lda, w, n, m);
  __syncthreads();
  map_rows(P, ldp, n, n, true, [&](int i, int j, float p) {
    W[i * ldw + j] = p + (i == j ? sigma : 0.f) + W[i * ldw + j];
  });
  __syncthreads();
  ADMM_PHASE_END(kPhGram);
}

// The diagonal block (b <= 32 rows at D, stride ld) factored by one warp:
// lane i holds row i in registers (rows b.. padded with the identity), the
// pivot and column j by shuffles.  rs_j = 1 / sqrt(max(d_j, 1e-30)) goes
// to sc[j] for the rows below, the panel's fail bit to sc[kPanel].
__device__ void chol_diag_warp(float* D, int ld, int b, float* sc) {
  const int lane = threadIdx.x & 31;
  float v[kPanel];
#pragma unroll
  for (int k = 0; k < kPanel; ++k)
    v[k] = (lane < b && k <= lane) ? D[lane * ld + k] : (k == lane ? 1.f : 0.f);
  bool fail = false;
#pragma unroll
  for (int j = 0; j < kPanel; ++j) {
    const float d = __shfl_sync(kFull, v[j], j);
    fail = fail || (j < b && ((d <= 0.f) || isnan(d)));
    const float dc = nan_max(d, 1e-30f);
    const float rs = rsqrtf(dc);
    if (lane == j) {
      v[j] = sqrtf(dc);
      sc[j] = rs;
    } else if (lane > j) {
      v[j] *= rs;
    }
#pragma unroll
    for (int k = j + 1; k < kPanel; ++k) v[k] = fmaf(-v[j], __shfl_sync(kFull, v[j], k), v[k]);
  }
  if (lane < b) {
#pragma unroll
    for (int k = 0; k < kPanel; ++k)
      if (k <= lane) D[lane * ld + k] = v[k];
  }
  if (lane == 0) sc[kPanel] = fail ? 1.f : 0.f;
}

// In-place lower Cholesky of W in panels of 32 columns; sc is 33 floats of
// scratch.  Returns the block-uniform fail flag.  Ends with a barrier.
template <int Q>
__device__ bool chol_blocked(float* W, int ld, int n, float* sc) {
  ADMM_PHASE_BEGIN(kPhChol);
  const int wp = threadIdx.x >> 5;
  bool fail = false;
  for (int c0 = 0; c0 < n; c0 += kPanel) {
    if (wp == 0) chol_diag_warp(W + c0 * ld + c0, ld, min(kPanel, n - c0), sc);
    __syncthreads();
    fail = fail || sc[kPanel] != 0.f;
    const int r = n - c0 - kPanel;  // rows below the panel (a full one then)
    if (r <= 0) break;
    // the panel's rows below its diagonal block, one thread a row:
    // column j scaled by rs_j after the fmaf updates of columns < j
    const float* Ld = W + c0 * ld + c0;
    for (int t = threadIdx.x; t < r; t += blockDim.x) {
      float* row = W + (c0 + kPanel + t) * ld + c0;
      float x[kPanel];
#pragma unroll
      for (int k = 0; k < kPanel; ++k) x[k] = row[k];
#pragma unroll
      for (int j = 0; j < kPanel; ++j) {
        x[j] *= sc[j];
#pragma unroll
        for (int k = j + 1; k < kPanel; ++k) x[k] = fmaf(-x[j], Ld[k * ld + j], x[k]);
      }
#pragma unroll
      for (int k = 0; k < kPanel; ++k) row[k] = x[k];
    }
    __syncthreads();
    // trailing update W22 -= L21 L21' (lower), a chain of 32 fmaf per entry
    float* W22 = W + (c0 + kPanel) * ld + c0 + kPanel;
    tile_products<Q, false, false>(W22, ld, W + (c0 + kPanel) * ld + c0, ld, nullptr, r, kPanel);
    __syncthreads();
  }
  ADMM_PHASE_END(kPhChol);
  return fail;
}

// One warp's half of L^-1's off-diagonal block (I, J), I > J: rows
// 16 half .. 16 half + 15 of it in 4 x 4 register tiles (lane / 8, lane % 8
// tile row and column).
//   li_sum_task    T = sum_{k=oj}^{oi-1} L_ik Li_kj, read from L's block row
//                  I and Li's block rows J .. I - 1, into the upper block
//                  (J, I) of Li, transposed (free until Li is done);
//   li_scale_task  Li_IJ = -Li_II T, from Li_II and that T.
// No sync.
__device__ __forceinline__ void li_sum_task(const float* Lm, int ldl, float* Li, int ldi, int n,
                                            int I, int J, int half) {
  const int lane = threadIdx.x & 31;
  const int r0 = 4 * (4 * half + (lane >> 3)), c0 = 4 * (lane & 7);
  const int oi = kPanel * I, oj = kPanel * J;
  int rows[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) rows[a] = min(oi + r0 + a, n - 1);
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  for (int k = oj; k < oi; ++k) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = Lm[rows[a] * ldl + k];
      y[a] = Li[k * ldi + oj + c0 + a];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a * 4 + b] = fmaf(x[a], y[b], acc[a * 4 + b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (oi + r0 + a < n) Li[(oj + c0 + b) * ldi + oi + r0 + a] = acc[a * 4 + b];
}

__device__ __forceinline__ void li_scale_task(float* Li, int ldi, int n, int I, int J, int half) {
  const int lane = threadIdx.x & 31;
  const int r0 = 4 * (4 * half + (lane >> 3)), c0 = 4 * (lane & 7);
  const int oi = kPanel * I, oj = kPanel * J;
  const int smax = min(r0 + 4, n - oi);  // T has n - oi rows
  int rows[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) rows[a] = min(oi + r0 + a, n - 1);
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;
  for (int s = 0; s < smax; ++s) {
    float x[4], y[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      x[a] = Li[rows[a] * ldi + oi + s];
      y[a] = Li[(oj + c0 + a) * ldi + oi + s];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a * 4 + b] = fmaf(x[a], y[b], acc[a * 4 + b]);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (oi + r0 + a < n) Li[(oi + r0 + a) * ldi + oj + c0 + b] = -acc[a * 4 + b];
}

// Li = L^-1 for L in the lower triangle of Lm, in blocks of 32 (NB
// blocks a side; the last one may be partial).  The strictly upper
// triangle of Li serves as scratch and ends zeroed or, with mirror, as
// Li' (Li[j][i] = Li[i][j]).  Ends with a barrier.
__device__ void tri_inv_blocked(const float* Lm, int ldl, float* Li, int ldi, int n, bool mirror) {
  ADMM_PHASE_BEGIN(kPhLinv);
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int NB = (n + kPanel - 1) / kPanel;
  // diagonal blocks, one warp each: lane c forms column c by the forward
  // substitution of tri_inv (k from c, dividing by max(L_ii, 1e-30)),
  // reading back its own earlier entries; the block's upper triangle is
  // stored as zeros
  for (int q = wp; q < NB; q += nw) {
    const int o = kPanel * q, bq = min(kPanel, n - o);
    const float* L = Lm + o * ldl + o;
    float* X = Li + o * ldi + o;
    if (lane < bq) {
      for (int i = 0; i < bq; ++i) {
        float acc = 0.f;
        for (int k = lane; k < i; ++k) acc = fmaf(L[i * ldl + k], X[k * ldi + lane], acc);
        X[i * ldi + lane] =
            i < lane ? 0.f : ((i == lane ? 1.f : 0.f) - acc) / nan_max(L[i * ldl + i], 1e-30f);
      }
    }
  }
  __syncthreads();
  // off-diagonal blocks by distance d: T into the (free) upper block
  // (j, i), then Li_ij = -Li_ii T.  A warp task is half a 32 x 32 block.
  for (int d = 1; d < NB; ++d) {
    for (int q = wp; q < 2 * (NB - d); q += nw)
      li_sum_task(Lm, ldl, Li, ldi, n, (q >> 1) + d, q >> 1, q & 1);
    __syncthreads();
    for (int q = wp; q < 2 * (NB - d); q += nw)
      li_scale_task(Li, ldi, n, (q >> 1) + d, q >> 1, q & 1);
    __syncthreads();
  }
  // the strictly upper triangle: zeros, or Li'
  for (int i = wp; i < n; i += nw)
    for (int j = i + 1 + lane; j < n; j += 32) Li[i * ldi + j] = mirror ? Li[j * ldi + i] : 0.f;
  __syncthreads();
  ADMM_PHASE_END(kPhLinv);
}

// W = Li' Li (full symmetric) from Li with a zero upper triangle: the
// sums of ltl, each from k = max(i, j) (the tile's earlier rows of Li add
// exact zeros).  Ends with a barrier.
template <int Q>
__device__ void ltl_tiles(const float* Li, int ldi, float* W, int ldw, int n) {
  ADMM_PHASE_BEGIN(kPhLtl);
  tile_products<Q, true, true>(W, ldw, Li, ldi, nullptr, n, n);
  __syncthreads();
  ADMM_PHASE_END(kPhLtl);
}

// The factor of K1: Minv (in W) of M = P + sigma I + A' diag(w) A; Li is
// scratch, sc 33 floats.  Returns the block-uniform fail flag.
template <int Q>
__device__ bool dense_factor_minv(float* W, float* Li, int ld, const float* P, int ldp,
                                  const float* A, const float* w, float sigma, int n, int m,
                                  float* sc) {
  gram_build<Q>(W, ld, P, ldp, A, ld, w, sigma, n, m);
  const bool fail = chol_blocked<Q>(W, ld, n, sc);
  tri_inv_blocked(W, ld, Li, ld, n, false);
  ltl_tiles<Q>(Li, ld, W, ld, n);
  return fail;
}

// ---- the factor in one matrix (K4's blocked layout) ----------------------

// The diagonal block D (bq <= 32 rows, stride ld) of L^-1 in place of L's:
// lane c forms column c in registers by tri_inv_blocked's forward
// substitution (the same fmaf chain, L's rows read as broadcasts), then
// stores it, zeros above the diagonal.  One warp; no block sync.
__device__ __forceinline__ void li_diag_inplace(float* D, int ld, int bq) {
  const int c = threadIdx.x & 31;
  float x[kPanel];
#pragma unroll
  for (int i = 0; i < kPanel; ++i) {
    if (i < bq) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < i; ++k)
        if (k >= c) acc = fmaf(D[i * ld + k], x[k], acc);
      x[i] = i < c ? 0.f : ((i == c ? 1.f : 0.f) - acc) / nan_max(D[i * ld + i], 1e-30f);
    }
  }
  __syncwarp();  // every lane has read L's rows
  if (c < bq) {
#pragma unroll
    for (int i = 0; i < kPanel; ++i)
      if (i < bq) D[i * ld + c] = x[i];
  }
}

// L^-1 in place of L (lower triangle of W, stride ld): the diagonal blocks
// at once, one warp each; then block row I = 1, 2, ...: its sums T from
// L's block row I and Li's rows above it (li_sum_task, into the upper
// blocks (J, I)), a barrier, then Li_IJ = -Li_II T over L's block row,
// whose L no one reads again.  Per element tri_inv_blocked's chain.  The
// diagonal blocks' upper triangles end zero, the other upper blocks hold
// the dead sums.  Ends with a barrier.
__device__ void tri_inv_inplace(float* W, int ld, int n) {
  ADMM_PHASE_BEGIN(kPhLinv);
  const int wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int NB = (n + kPanel - 1) / kPanel;
  for (int q = wp; q < NB; q += nw)
    li_diag_inplace(W + kPanel * q * (ld + 1), ld, min(kPanel, n - kPanel * q));
  __syncthreads();
  for (int I = 1; I < NB; ++I) {
    for (int q = wp; q < 2 * I; q += nw) li_sum_task(W, ld, W, ld, n, I, q >> 1, q & 1);
    __syncthreads();
    for (int q = wp; q < 2 * I; q += nw) li_scale_task(W, ld, n, I, q >> 1, q & 1);
    __syncthreads();
  }
  ADMM_PHASE_END(kPhLinv);
}

// Minv = Li' Li in place of Li (tri_inv_inplace's output), by block rows
// I = 0, 1, ...: one warp a 32 x 32 block (I, J), J <= I, lane (lr, lc)
// rows lr + 8a and columns lc + 4b of it; each entry the fmaf chain of
// ltl_tiles from k = 32 I (the terms below max(i, j) read the diagonal
// block's zeros and add exact zeros).  A block (I, J < I) is read by its
// own task alone once the rows above are done, so its warp stores it (and
// its mirror, into the dead upper block (J, I)) as soon as it is summed;
// the diagonal block, which every task of the row reads, is stored by its
// warp (its last task) after the row's barrier.  W ends holding the full
// Minv.  Ends with a barrier.
__device__ void ltl_inplace(float* W, int ld, int n) {
  ADMM_PHASE_BEGIN(kPhLtl);
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int NB = (n + kPanel - 1) / kPanel;
  const int lr = lane >> 2, lc = lane & 3;
  for (int I = 0; I < NB; ++I) {
    const int oi = kPanel * I;
    int rows[4], rowc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rows[a] = oi + lr + 8 * a;
      rowc[a] = min(rows[a], n - 1);
    }
    float acc[32];
    bool diag = false;
    for (int J = wp; J <= I; J += nw) {
      const int oj = kPanel * J;
      int cols[8], colc[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        cols[b] = oj + lc + 4 * b;
        colc[b] = min(cols[b], n - 1);
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      for (int k = oi; k < n; ++k) {
        const float* wk = W + (size_t)k * ld;
        float x[4], y[8];
#pragma unroll
        for (int a = 0; a < 4; ++a) x[a] = wk[rowc[a]];
#pragma unroll
        for (int b = 0; b < 8; ++b) y[b] = wk[colc[b]];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc[a * 8 + b] = fmaf(x[a], y[b], acc[a * 8 + b]);
      }
      if (J < I) {
        __syncwarp();  // the warp is done reading block (I, J)
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b)
            if (rows[a] < n) {
              W[rows[a] * ld + cols[b]] = acc[a * 8 + b];
              W[cols[b] * ld + rows[a]] = acc[a * 8 + b];
            }
      } else {
        diag = true;
      }
    }
    __syncthreads();  // every task of the row has read the diagonal block
    if (diag) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b)
          if (rows[a] < n && oi + lc + 4 * b < n) W[rows[a] * ld + oi + lc + 4 * b] = acc[a * 8 + b];
    }
  }
  __syncthreads();
  ADMM_PHASE_END(kPhLtl);
}

// ---- lane-split matvecs ---------------------------------------------------

template <int L>
__device__ __forceinline__ float lanes_sum(float (&a)[4]) {
  float acc = (a[0] + a[1]) + (a[2] + a[3]);
#pragma unroll
  for (int o = 1; o < L; o <<= 1) acc += __shfl_xor_sync(kFull, acc, o);
  return acc;
}

// epi(i, (M x)_i) for the rows i < rows of M (stride ld): a warp task is
// 32 / L rows; lane (i, c) sums columns 32 s + (32 / L) c + e, e < 32 / L,
// of every span s, its loads of a span issued together.  The rows past
// the last round in which every warp has a full task (the m = n + 1th row
// of a Jacobian) go one to a warp, 32 lanes a row, rather than costing a
// whole round.  No sync.
template <int L, class Epi>
__device__ void rows_dot(const float* M, int ld, int rows, int cols, const float* x, Epi epi) {
  constexpr int C = 32 / L;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int c = lane % L, ii = lane / L;
  const int full = rows - rows % (C * nw);
  for (int i0 = C * wp; i0 < full; i0 += C * nw) {
    const int i = i0 + ii;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    const float* r = M + (size_t)i * ld;
    for (int j0 = C * c; j0 < cols; j0 += 32) {
      if (j0 + C <= cols) {
#pragma unroll
        for (int e = 0; e < C; ++e) a[e & 3] = fmaf(r[j0 + e], x[j0 + e], a[e & 3]);
      } else {
        for (int j = j0; j < cols; ++j) a[0] = fmaf(r[j], x[j], a[0]);
      }
    }
    const float acc = lanes_sum<L>(a);
    if (c == 0) epi(i, acc);
  }
  for (int i = full + wp; i < rows; i += nw) {
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    const float* r = M + (size_t)i * ld;
    for (int j = lane; j < cols; j += 32) a[0] = fmaf(r[j], x[j], a[0]);
    const float acc = lanes_sum<32>(a);
    if (lane == 0) epi(i, acc);
  }
}

// Row i of the n x n M over the columns [lo, hi), lane c's share.
template <int L>
__device__ __forceinline__ void seg_dot(const float* r, int lo, int hi, const float* x, int c,
                                        float (&a)[4]) {
  constexpr int C = 32 / L;
  for (int j0 = (lo & ~31) + C * c; j0 < hi; j0 += 32) {
#pragma unroll
    for (int e = 0; e < C; ++e) {
      const int j = j0 + e;
      if (j >= lo && j < hi) a[e & 3] = fmaf(r[j], x[j], a[e & 3]);
    }
  }
}

// The triangular products of M (n x n, stride ld): kUpper false, epi(i,
// sum_{j <= i} M[i][j] x[j]) (L x for L lower); kUpper true, epi(i,
// sum_{j >= i} M[i][j] x[j]) (L' x with L' mirrored into the upper
// triangle).  L lanes take rows i and n - 1 - i together, so that every
// lane sums about (n + 1) / L entries.  No sync.
template <int L, bool kUpper, class Epi>
__device__ void tri_rows_dot(const float* M, int ld, int n, const float* x, Epi epi) {
  constexpr int C = 32 / L;
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int c = lane % L, pp = lane / L, np = (n + 1) / 2;
  for (int p0 = C * wp; p0 < np; p0 += C * nw) {
    const int p = p0 + pp, p2 = n - 1 - p;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, b[4] = {0.f, 0.f, 0.f, 0.f};
    if (p < np) {
      seg_dot<L>(M + (size_t)p * ld, kUpper ? p : 0, kUpper ? n : p + 1, x, c, a);
      if (p2 != p) seg_dot<L>(M + (size_t)p2 * ld, kUpper ? p2 : 0, kUpper ? n : p2 + 1, x, c, b);
    }
    const float y1 = lanes_sum<L>(a), y2 = lanes_sum<L>(b);
    if (c == 0 && p < np) {
      epi(p, y1);
      if (p2 != p) epi(p2, y2);
    }
  }
}

// epi(j, (M' w)_j) for the columns j < cols of M (rows x cols, stride ld):
// a warp task is 32 / L columns of one span, lane (j, c) summing the rows
// r = c mod L, eight a step into four accumulators, so that eight loads
// are in flight; a step's reads fall on the banks (r + j) mod 32, all
// different.  No sync.
template <int L, class Epi>
__device__ void cols_dot(const float* M, int ld, int rows, int cols, const float* w, Epi epi) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int c = lane % L, jj = lane / L;
  const int tasks = ((cols + 31) >> 5) * L;
  for (int t = wp; t < tasks; t += nw) {
    const int j = 32 * (t / L) + L * jj + (t % L);
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < cols) {
      int r = c;
      for (; r + 7 * L < rows; r += 8 * L) {
#pragma unroll
        for (int u = 0; u < 8; ++u)
          a[u & 3] = fmaf(M[(size_t)(r + L * u) * ld + j], w[r + L * u], a[u & 3]);
      }
      for (; r < rows; r += L) a[0] = fmaf(M[(size_t)r * ld + j], w[r], a[0]);
    }
    const float acc = lanes_sum<L>(a);
    if (c == 0 && j < cols) epi(j, acc);
  }
}

}  // namespace
