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
// for every internal block bb past 32 that is a multiple of 8, bb a
// runtime argument (one instantiation), at every shape whose vectors and
// fixed part fit a block's shared memory (wide_layout).  Blocks up to 128
// are the shapes it was designed for; a wider one (the OSQP control class
// at 50 states: declared stage block 75, bb = 152) runs its sweep chains'
// rows in rounds and most of its arrays from the workspace.
//
// Design: one problem a cluster of CS = 2 thread blocks of 256 threads,
// every array an ADMM iteration reads in the cluster's shared memory
// where the shape allows it.
//
//   A in two-block band rows.  M = P + sigma I + A' rho A is block-
//   tridiagonal at bb exactly where every row of A touches at most two
//   consecutive column blocks.  The load phase scans each row for its
//   first and last nonzero column block, sets k_r = min(first, T - 2) and
//   keeps the row's 2 bb entries from column k_r bb (its slab) and k_r;
//   it lists, for each column block k, the rows whose slab covers it
//   (in row order, by ballots: no atomics).  A v is each slab against v's
//   two blocks; A' w and the Gram band read, for column block k, only the
//   rows of k's list.  A problem with a row outside two consecutive
//   blocks takes the dense route in the same kernel: its rows of A read
//   densely from device memory, as the JAX kernel reads them.  The branch
//   is per problem (every block of the cluster agrees on it first), and
//   the route is written to `route` (1 band, 0 dense).
//
//   The cluster.  Block r holds rows [r m0, (r + 1) m0) of A (m0 =
//   ceil(m / CS)) with their z, y, l, u, rho and its rows' lists, all of
//   the n-vectors (q, x, b, x~, ...), and the band and factor arrays of
//   its column blocks [kb_r, kb_{r+1}), kb_r = r T / CS: L_k^-1, the sweeps'
//   couplings G_k (k > 0) and H_k (k < T - 1), P's band pd_k, pe_k.  Every
//   block computes the n-vectors' updates alike, so they stay equal bit
//   for bit; the blocks meet in distributed shared memory
//   (cg::this_cluster().map_shared_rank) at cluster barriers:
//     A' w      each block's partial over its rows for all n columns goes
//               into every block's exchange slot; one barrier; each block
//               sums the CS partials in rank order;
//     M^-1 b    c_k = L_k^-1 b_k by the owner of k, a thread a row; the
//               forward chain w_k = c_k - G_k w_{k-1} by the owners in rank
//               order, each handing its last w_k to the next (CS - 1
//               barriers); d_k = L_k^-T w_k by the owner, a thread a
//               column; the backward chain x_k = d_k - H_k x_{k+1} in
//               reverse rank order, each owner writing its x_k into every
//               block (CS barriers, the last one publishing x).  A chain
//               step is a bb x bb matvec by two lanes a row over the
//               coupling stored transposed (consecutive lanes on
//               consecutive words), the pair's sums met by a shuffle, one
//               block barrier (past bb = 128 the rows in rounds of 128);
//     P v       rows of its column blocks by the owner (pe_{k-1} of the
//               block before its first read from the neighbour), written
//               into every block; one barrier;
//     factor    the Gram band block by block: each block's partial
//               [D_k; E_k] over its rows of k's list in 4 x 4 register
//               tiles, summed into L_k^-1's and H_k's place by k's owner
//               (two barriers a block); then block-Thomas by the owners in
//               rank order, F handed on at each boundary: S_k = D_k -
//               F_{k-1} F_{k-1}', its Cholesky by dense_factor.cuh's
//               chol_blocked (panels of 32; the pivot clamp max(d, 1e-30),
//               fail = d <= 0 | NaN), L_k^-1 by tri_inv_blocked, G_k =
//               L_k^-1 F_{k-1}, F_k = E_k L_k^-T, H_k = L_k^-T F_k';
//     reductions each block's, then combined across the cluster.
//   A, pd and pe are loaded once, with cp.async, while the vectors load,
//   where shared memory holds them; pd and pe that it does not hold are
//   read from device memory at each P v (the termination checks and
//   certificates, not the ADMM iterations).
//   The operator's shapes and its arrays' offsets live in a context at the
//   start of shared memory (WideCtx) rather than in registers, and its
//   arrays are addressed from the shared-memory base, so that the
//   compiler reads them with 32-bit shared-memory loads; the factor's
//   loops are functions of their own (__noinline__), so that the ADMM
//   core around them keeps its registers.
//
// Memory (wide_layout, the rule of the shape alone).  A block's fixed part
// (the context, 8 n + 8 m0 vectors, reductions, a ring of two exchange
// slots of CS n floats, k_r and the lists), then its arrays first-fit in
// the order L^-1, the couplings, A's band rows (what an iteration reads;
// the band rows first where that leaves an iteration fewer bytes to read
// from device memory), the Thomas scratch S, F_{k-1}, F_k, and pd with pe;
// an array that does not fit goes to the block's slice of a workspace in
// device memory the wrapper allocates (pd and pe are then read where they
// are given).  A cluster of four blocks, which would hold more of a
// larger shape on chip, measured 1.4-2.2x slower than two on an H100 at
// every shape it was tried on (its cluster barriers and chain hand-overs
// cost more than the device-memory reads they save), so the launcher
// takes two.  At the
// 6-DOF arm's shape (n = 360, m = 600, bb = 40) two blocks hold L^-1, the
// couplings, A's band rows (300 a block) and S: an ADMM iteration reads
// nothing from device memory.
//
// What bounds it on this card.  An iteration is two passes over A's
// nonzeros in band rows (2 m 2 bb FMAs a problem where the dense product
// takes 2 m n), the L^-1 products and the two chains (2 (T - 1) dependent
// bb x bb matvecs): a few thousand FMAs a block, under the latency of the
// chain steps (a barrier and a shared-memory round trip each) and of the
// 2 CS cluster barriers.  The card's bounds on these inputs are far below
// that: one problem a cluster is latency bound, and the batch fills the
// card when CS B >= 132.  A batch's wall is its slowest problem's
// iterations times an iteration's latency.
//
// Anderson acceleration as in qp_kernel_btd.cu: a second instantiation of
// the body (AA = true) in qp_kernel_btd_wide_aa.cu, which includes this
// file with QP_KERNEL_BTD_WIDE_AA_UNIT defined; its Gram area in shared
// memory (wide_layout's reserve) where wide_aa_gram_sm puts it, else at
// the head of the block's Anderson workspace slice; its ring in that
// slice.

#include <cooperative_groups.h>

#include "admm_core.cuh"
#include "dense_factor.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideChainRows = kWideThreads / 2;  // a sweep chain's rows a round
constexpr int kWideQuad = 2;  // chol_blocked's trailing-update tiles
constexpr int kWideCtxFloats = 64;  // the operator's context (WideCtx)
constexpr int kWideCluster = 2;     // thread blocks a problem

// A block's arrays: L^-1, the sweeps' couplings G', H', A's band rows, the
// Thomas scratch S, F_{k-1}, F_k, and P's band pd, pe.
enum WideArray { kWLi, kWC, kWA, kWS, kWFa, kWFb, kWPd, kWPe, kWideArrays };

__host__ __device__ constexpr long long round4ll(long long v) { return (v + 3) & ~3LL; }

struct WideLayout {
  int cs, T, R, m0, W, lds, ldl, ldf, xlen;
  long long fixed;               // floats before the arrays
  long long off[kWideArrays];    // from the arrays' start in shared memory, or in the
                                 // workspace slice; -1: pd / pe read where given
  unsigned smem;                 // bit a: array a in shared memory
  long long ws_floats;           // workspace floats of one block
  long long iter_bytes;          // bytes an iteration reads from device memory, per problem
  long long smem_bytes;
  bool ok;                       // the fixed part fits
};

// The couplings a block holds: G_k for its column blocks but k = 0, H_k
// for its column blocks but k = T - 1 (G_0 and H_{T-1} vanish).
__host__ __device__ inline int wide_couplings(int T, int cs, int rank, int& ng) {
  const int kb = rank * T / cs, ke = (rank + 1) * T / cs;
  const int g0 = kb > 1 ? kb : 1, h1 = ke < T - 1 ? ke : T - 1;
  ng = ke > g0 ? ke - g0 : 0;
  return ng + (h1 > kb ? h1 - kb : 0);
}

// The layout of one block of a cluster of cs at this shape.  Fixed part:
// the operator's context; q, x, b, x~, two n scratch, x_prev, the sweeps'
// scratch (8 n); z, y, l, u, rho, one m scratch, y_prev, A v's (8 m0);
// the reduction slots, chol_blocked's scratch, the exchange ring
// (2 cs xlen); the ints k_r (m0), the lists' offsets
// (T + 1) and entries (2 m0).  Arrays: L^-1 (R column blocks of row
// stride ldl = bb + 1), the couplings (the most any block holds, each
// bb^2, transposed), the band rows (row stride lds = 4 x odd), S and
// F_{k-1}, F_k (row stride ldf = bb + 1), pd, pe (R blocks of bb^2); they
// take shared memory first-fit in the order L^-1, couplings, band rows
// (or the band rows first, where that leaves an iteration fewer bytes to
// read from device memory), then the rest.
__host__ __device__ inline WideLayout wide_layout_as(int n, int m, int bb, int cs,
                                                     bool a_first, long long reserve = 0) {
  WideLayout L;
  L.cs = cs;
  L.T = n / bb;
  L.R = (L.T + cs - 1) / cs;
  L.m0 = (m + cs - 1) / cs;
  L.W = (L.T < 2 ? L.T : 2) * bb;
  L.lds = stride4(L.W);
  L.ldl = bb + 1;
  L.ldf = bb + 1;
  L.xlen = round4(n > 8 ? n : 8);
  L.fixed = round4ll(kWideCtxFloats + 8LL * n + 8LL * L.m0 + kRedSlots + kPanel + 1 +
                     2LL * cs * L.xlen + 3LL * L.m0 + L.T + 1) + reserve;
  int nc = 0;
  for (int r = 0; r < cs; ++r) {
    int ng;
    const int c = wide_couplings(L.T, cs, r, ng);
    nc = c > nc ? c : nc;
  }
  const long long b2 = (long long)bb * bb, blk = (long long)L.R * b2;
  const long long bf = round4ll((long long)bb * L.ldf);
  long long sizes[kWideArrays];
  sizes[kWLi] = (long long)L.R * bb * L.ldl;
  sizes[kWC] = (long long)nc * b2;
  sizes[kWA] = (long long)L.m0 * L.lds;
  sizes[kWS] = sizes[kWFa] = sizes[kWFb] = bf;
  sizes[kWPd] = sizes[kWPe] = blk;
  const int order[2][kWideArrays] = {{kWLi, kWC, kWA, kWS, kWFa, kWFb, kWPd, kWPe},
                                     {kWA, kWLi, kWC, kWS, kWFa, kWFb, kWPd, kWPe}};
  const long long cap = kMaxSmemBytes / 4;
  long long used = L.fixed;
  L.ok = used <= cap;
  L.smem = 0;
  L.ws_floats = 0;
  for (int o = 0; o < kWideArrays; ++o) {
    const int a = order[a_first ? 1 : 0][o];
    // pd and pe go to shared memory together or not at all
    const long long need = a == kWPd ? sizes[kWPd] + sizes[kWPe] : sizes[a];
    if (L.ok && used + need <= cap && (a != kWPe || (L.smem >> kWPd & 1))) {
      L.off[a] = used - L.fixed;
      used += sizes[a];
      L.smem |= 1u << a;
    } else if (a == kWPd || a == kWPe) {
      L.off[a] = -1;
    } else {
      L.off[a] = L.ws_floats;
      L.ws_floats += sizes[a];
    }
  }
  L.smem_bytes = used * 4;
  // an iteration: A' w and A v over the band rows, c and d over L^-1's
  // triangles (one L^-1 in all), the two chains over the couplings
  long long ib = 0;
  if (!(L.smem >> kWA & 1)) ib += 2LL * cs * L.m0 * L.W;
  if (!(L.smem >> kWLi & 1)) ib += (long long)L.T * b2;
  if (!(L.smem >> kWC & 1)) ib += 2LL * (L.T - 1) * b2;
  L.iter_bytes = 4 * ib;
  return L;
}

// The layout of the two orders that leaves an iteration fewer bytes to
// read from device memory (A's band rows first at bb = 128, T = 2: 131 KB
// an iteration a problem where the other order reads 524 KB of A).  An
// Anderson launch reserves its Gram area (aa_gram_floats, a multiple of 4
// floats) at the end of the fixed part; its ring stays in the workspace,
// since the arrays an iteration reads take the shared memory first-fit.
__host__ __device__ inline WideLayout wide_layout(int n, int m, int bb, int cs,
                                                  long long reserve = 0) {
  const WideLayout L = wide_layout_as(n, m, bb, cs, false, reserve);
  if (L.iter_bytes == 0) return L;
  const WideLayout La = wide_layout_as(n, m, bb, cs, true, reserve);
  return La.iter_bytes < L.iter_bytes ? La : L;
}

// ---- the hooks' loops -----------------------------------------------------
// The iterations' loops below are inlined on operands addressed from
// wide_smem (or the workspace, on_arr); the factor's (the Gram part and
// Thomas) are functions of their own, so that the ADMM core around them
// keeps its registers.

// out[r] = sum_{q <= i} L[i][q] b[q] for the own rows r = kl bb + i of the
// lower-triangular blocks L (bb x bb, row stride ldl, ldl bb apart), one
// thread a row, four sums in flight.  No sync.
__device__ __forceinline__ void wide_lower(const float* Li, int ldl, int bb, int own,
                                           const float* b, float* out) {
  for (int r = threadIdx.x; r < own; r += blockDim.x) {
    const int kl = r / bb, i = r - kl * bb;
    const float* L = Li + ((size_t)kl * bb + i) * ldl;
    const float* bk = b + kl * bb;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    int q = 0;
    for (; q + 3 <= i; q += 4)
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = fmaf(L[q + u], bk[q + u], a[u]);
    for (; q <= i; ++q) a[0] = fmaf(L[q], bk[q], a[0]);
    out[r] = (a[0] + a[1]) + (a[2] + a[3]);
  }
}

// out[r] = sum_{q >= i} L[q][i] w[q] (L' w) for the own rows, one thread a
// column (consecutive threads on consecutive words).  No sync.
__device__ __forceinline__ void wide_upper(const float* Li, int ldl, int bb, int own, const float* w,
                                        float* out) {
  for (int r = threadIdx.x; r < own; r += blockDim.x) {
    const int kl = r / bb, i = r - kl * bb;
    const float* L = Li + (size_t)kl * bb * ldl + i;
    const float* wk = w + kl * bb;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    int q = i;
    for (; q + 3 < bb; q += 4) {
#pragma unroll
      for (int u = 0; u < 4; ++u) d[u] = fmaf(L[(size_t)(q + u) * ldl], wk[q + u], d[u]);
    }
    for (; q < bb; ++q) d[0] = fmaf(L[(size_t)q * ldl], wk[q], d[0]);
    out[r] = (d[0] + d[1]) + (d[2] + d[3]);
  }
}

// A sweep chain's steps k = k0, k0 + dir, ... up to k1 (excluded) by the
// block: y_k = rhs_k - C_k y_{k-dir}, C_k at C + k bb^2 stored transposed.
// Two lanes a row: lane s of row i's pair sums columns s, s + 2, ...
// (consecutive pairs on consecutive words of C), the pair's sums meet by a
// shuffle, and one block barrier a step publishes y_k.  The rows go in
// rounds of kWideChainRows (one round up to bb = 128), each row's sums as
// in one round.
__device__ __forceinline__ void wide_chain(const float* C, const float* rhs, float* y, int k0,
                                           int k1, int dir, int bb) {
  const int t = threadIdx.x, sl = t & 1;
  const size_t b2 = (size_t)bb * bb;
  for (int k = k0; k != k1; k += dir) {
    const float* yp = y + (k - dir) * bb + sl;
    for (int i0 = 0; i0 < bb; i0 += kWideChainRows) {
      const int i = i0 + (t >> 1);
      const bool row = i < bb;
      const float* Ct = C + k * b2 + sl * bb + (row ? i : 0);
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      if (row) {
        int j = 0;
#pragma unroll 2
        for (; j + 8 <= bb; j += 8) {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            a[u] = fmaf(Ct[(size_t)(j + 2 * u) * bb], yp[j + 2 * u], a[u]);
        }
        for (; j + sl < bb; j += 2) a[0] = fmaf(Ct[(size_t)j * bb], yp[j], a[0]);
      }
      float acc = (a[0] + a[1]) + (a[2] + a[3]);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      if (row && sl == 0) y[k * bb + i] = rhs[k * bb + i] - acc;
    }
    __syncthreads();
  }
}

// y's blocks k0 .. k1 - 1 into every other block of the cluster, by the
// block.  No sync.
__device__ __forceinline__ void wide_publish(float* y, int k0, int k1, int bb, int cs, int rank) {
  cg::cluster_group cl = cg::this_cluster();
  for (int t = 0; t < cs; ++t) {
    if (t == rank) continue;
    float* py = cl.map_shared_rank(y, t);
    for (int e = k0 * bb + threadIdx.x; e < k1 * bb; e += blockDim.x) py[e] = y[e];
  }
}

// The band rows' partial of A' w for every column, into part (part `rank`
// of a slot of every block of the cluster): a warp task is gw = ceil(bb /
// ceil(bb / 32)) columns of one column block, lanes on the columns, over
// the block's list (eight rows in flight).  No sync.
__device__ __forceinline__ void wide_band_atmv(const float* As, int lds, const int* loffs,
                                               const int* ent, int T, int bb, const float* w,
                                               float* mine, int cs, int rank) {
  cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int ng = (bb + 31) >> 5, gw = (bb + ng - 1) / ng;
  for (int task = wp; task < T * ng; task += nw) {
    const int k = task / ng, i = (task - k * ng) * gw + lane;
    if (lane < gw && i < bb) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      int e = loffs[k];
      const int e1 = loffs[k + 1];
      for (; e + 7 < e1; e += 8) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int v = ent[e + u], r = v >> 1;
          a[u & 3] = fmaf(As[r * lds + (v & 1) * bb + i], w[r], a[u & 3]);
        }
      }
      for (; e < e1; ++e) {
        const int v = ent[e], r = v >> 1;
        a[0] = fmaf(As[r * lds + (v & 1) * bb + i], w[r], a[0]);
      }
      const float acc = (a[0] + a[1]) + (a[2] + a[3]);
      for (int t = 0; t < cs; ++t)
        (t == rank ? mine : cl.map_shared_rank(mine, t))[k * bb + i] = acc;
    }
  }
}

// out[i] = the band row i's slab against v's two blocks, for the ml rows:
// a warp task is 8 rows, lane (ii, c) summing entries c, c + 4, ... (the
// row stride lds = 4 x odd keeps a step's 32 reads of A on 32 banks).
// No sync.
__device__ __forceinline__ void wide_band_amv(const float* As, int lds, const int* kr, int bb,
                                           int W, int ml, const float* v, float* out) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int c = lane & 3, ii = lane >> 2;
  for (int i0 = 8 * wp; i0 < ml; i0 += 8 * nw) {
    const int i = i0 + ii;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (i < ml) {
      const float* r = As + (size_t)i * lds;
      const float* vk = v + kr[i] * bb;
#pragma unroll 4
      for (int e = c; e < W; e += 16) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ee = e + 4 * u;
          if (ee < W) a[u] = fmaf(r[ee], vk[ee], a[u]);
        }
      }
    }
    float acc = (a[0] + a[1]) + (a[2] + a[3]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (c == 0 && i < ml) out[i] = acc;
  }
}

// This block's partial of the Gram band's column block k over its rows:
// D_k = sum_r a_rk' rho_r a_rk into Fa, E_k = sum_r a_r,k+1' rho_r a_rk
// into Fb (zero at k = T - 1), row stride ldf, from the band rows and
// k's list (band) or from the dense rows Ad.  A task is a 4 x 4 tile of
// the 2 bb x bb stack [D_k; E_k].  No sync.
__device__ __noinline__ void wide_gram_part(const float* As, int lds, const int* loffs,
                                            const int* ent, const float* Ad, int n, int ml,
                                            bool band, const float* rv, int k, int T, int bb,
                                            float* Fa, float* Fb, int ldf) {
  const int tb = bb >> 2, per = 2 * tb * tb;
  for (int t = threadIdx.x; t < per; t += blockDim.x) {
    const int tr = t / tb, tc = t - tr * tb;
    const bool erow = tr >= tb;
    const int i0 = 4 * (erow ? tr - tb : tr), j0 = 4 * tc;
    float acc[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] = 0.f;
    // D: every row of k's list at block k of its slab (band), or every
    // row at column block k (dense); E: the rows whose slab starts at k
    // (block k + 1 at bb), or every row at k + 1
    const int e0 = band ? loffs[k] : 0;
    const int e1 = !erow || k + 1 < T ? (band ? loffs[k + 1] : ml) : e0;
    for (int e = e0; e < e1; ++e) {
      const float* ai;
      const float* aj;
      float w;
      if (band) {
        const int v = ent[e], r = v >> 1;
        if (erow && (v & 1)) continue;
        const float* ar = As + r * lds + (v & 1) * bb;
        ai = ar + (erow ? bb : 0) + i0;
        aj = ar + j0;
        w = rv[r];
      } else {
        const float* ar = Ad + (size_t)e * n;
        ai = ar + (k + (erow ? 1 : 0)) * bb + i0;
        aj = ar + k * bb + j0;
        w = rv[e];
      }
      float x[4], y[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        x[c] = ai[c] * w;
        y[c] = aj[c];
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int f = 0; f < 4; ++f) acc[c * 4 + f] = fmaf(x[c], y[f], acc[c * 4 + f]);
    }
    float* out = erow ? Fb : Fa;
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int f = 0; f < 4; ++f) out[(i0 + e) * ldf + j0 + f] = acc[e * 4 + f];
  }
}

// Block-Thomas over the column blocks kb .. ke - 1 of this block: D_k in
// Li's block (row stride ldl), E_k (k < T - 1) in H_k's place; F_{kb-1} in
// Fa (zero at kb = 0, set by the caller).  Leaves L_k^-1 in Li, G_k' at
// G + k bb^2 (k > 0) and H_k' at H + k bb^2 (k < T - 1), both transposed,
// and F_{ke-1} (ke < T) in the returned buffer (Fa or Fb); fail |= a
// clamped pivot.  Syncs inside; ends with a barrier.
__device__ __noinline__ float* wide_thomas(float* Li, int ldl, float* G, float* H, float* S,
                                           float* Fa, float* Fb, int ldf, float* sc, int kb,
                                           int ke, int T, int bb, bool& fail) {
  const int tid = threadIdx.x, NT = blockDim.x, b2 = bb * bb;
  const size_t nb2 = (size_t)b2, lb = (size_t)bb * ldl;
  float* Fp = Fa;  // F_{k-1}
  float* Fn = Fb;  // F_k
  for (int k = kb; k < ke; ++k) {
    float* Dk = Li + (k - kb) * lb;  // D_k, then L_k^-1
    float* Ek = H + k * nb2;         // E_k, then H_k' (k < T - 1)
    float* Gk = G + k * nb2;         // G_k' (k > 0)
    const bool g = k > 0, h = k + 1 < T;
    // S_k = D_k - F_{k-1} F_{k-1}' (lower triangle)
    for (int e = tid; e < b2; e += NT) {
      const int i = e / bb, j = e - i * bb;
      if (j > i) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int l = 0; l < bb; l += 4)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          acc[u] = fmaf(Fp[i * ldf + l + u], Fp[j * ldf + l + u], acc[u]);
      S[i * ldf + j] = Dk[i * ldl + j] - ((acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
    __syncthreads();
    fail = chol_blocked<kWideQuad>(S, ldf, bb, sc) || fail;
    tri_inv_blocked(S, ldf, Dk, ldl, bb, false);
    // G_k = L_k^-1 F_{k-1} (stored transposed), F_k = E_k L_k^-T
    for (int e = tid; e < b2; e += NT) {
      const int i = e / bb, j = e - i * bb;
      float gs[4] = {0.f, 0.f, 0.f, 0.f}, f[4] = {0.f, 0.f, 0.f, 0.f};
      int q = 0;
      if (g) {
        for (; q + 3 <= i; q += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            gs[u] = fmaf(Dk[i * ldl + q + u], Fp[(q + u) * ldf + j], gs[u]);
        for (; q <= i; ++q) gs[0] = fmaf(Dk[i * ldl + q], Fp[q * ldf + j], gs[0]);
        Gk[j * bb + i] = (gs[0] + gs[1]) + (gs[2] + gs[3]);
      }
      if (h) {
        for (q = 0; q + 3 <= j; q += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u) f[u] = fmaf(Ek[i * bb + q + u], Dk[j * ldl + q + u], f[u]);
        for (; q <= j; ++q) f[0] = fmaf(Ek[i * bb + q], Dk[j * ldl + q], f[0]);
        Fn[i * ldf + j] = (f[0] + f[1]) + (f[2] + f[3]);
      }
    }
    __syncthreads();
    if (h) {
      // H_k = L_k^-T F_k' over E_k (stored transposed)
      for (int e = tid; e < b2; e += NT) {
        const int i = e / bb, j = e - i * bb;
        float hs[4] = {0.f, 0.f, 0.f, 0.f};
        int q = i;
        for (; q + 3 < bb; q += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            hs[u] = fmaf(Dk[(q + u) * ldl + i], Fn[j * ldf + q + u], hs[u]);
        for (; q < bb; ++q) hs[0] = fmaf(Dk[q * ldl + i], Fn[j * ldf + q], hs[0]);
        Ek[j * bb + i] = (hs[0] + hs[1]) + (hs[2] + hs[3]);
      }
      __syncthreads();
    }
    float* t = Fp;
    Fp = Fn;
    Fn = t;
  }
  return Fp;
}

// The structured operator's context: one block's shapes and where its
// arrays lie, written once at the start of its shared memory, so that the
// operator itself (below) holds no registers but its exchange count.
// Shared-memory arrays are kept as offsets from wide_smem, so that the
// compiler sees their address space and reads them with 32-bit shared
// addresses; array a lies at wide_smem + off[a] where bit a of `smem` is
// set, else at wsb + off[a] (this block's workspace slice; pd and pe at
// off -1 are read from the input band pdg, peg).  Rows: ml of them (the
// problem's r0 .. r0 + ml - 1), band rows A (row stride lds, W = min(2, T)
// bb entries from column k_r bb), dense rows Ad (stride n, device memory),
// kr, and the lists: the entries [loffs[k], loffs[k + 1]) of ent, each
// 2 r + (k - k_r) for a row r whose slab covers column block k.  Column
// blocks kb .. ke - 1: Li (block k at (k - kb) bb ldl, row stride ldl), the
// couplings G_k (k > 0) then H_k (k < T - 1) transposed (G_k's entry (i, j)
// at gofs + k bb^2 + j bb + i of the couplings' array); pd, pe
// (block k at (k - kb) bb^2) where both are in shared memory, else the
// problem's input band (block k at k bb^2).  S, Fa, Fb (row stride ldf)
// the factor's scratch (Fa, Fb also the Gram's partials and F's
// hand-over); sc chol_blocked's; tw (n) the sweeps'; av (ml) A v's; xch
// the ring of two exchange slots, each cs parts of xlen floats.  A
// workspace array lies at the same offset of every block's slice,
// ws_floats apart.
struct WideCtx {
  const float* Ad;
  const float* pdg;
  const float* peg;
  float* wsb;
  long long ws_floats;
  int off[kWideArrays];
  unsigned smem;
  int kr, loffs, ent, sc, tw, av, xch;
  int gofs, hofs;  // G_k' at the couplings + gofs + k bb^2, H_k' at + hofs + k bb^2
  int xlen, rank, cs, n, ml, T, bb, W, lds, ldl, ldf, kb, ke;
  float sigma;
  int band;
};
static_assert(sizeof(WideCtx) <= 4 * kWideCtxFloats, "WideCtx outgrew its slot");

extern __shared__ __align__(16) float wide_smem[];

__device__ __forceinline__ const WideCtx& wide_ctx() {
  return *reinterpret_cast<const WideCtx*>(wide_smem);
}

__device__ __forceinline__ bool in_smem(const WideCtx& c, int a) { return c.smem >> a & 1; }

// Array a wherever it lies, as a generic pointer (the factor's paths).
__device__ __forceinline__ float* wide_arr(const WideCtx& c, int a) {
  return in_smem(c, a) ? wide_smem + c.off[a] : c.wsb + c.off[a];
}

// run(pointer to array a): twice inlined, once on the shared-memory
// address (so that the compiler reads it with shared-memory loads) and
// once on the workspace's.
template <class F>
__device__ __forceinline__ void on_arr(const WideCtx& c, int a, F run) {
  if (in_smem(c, a)) run(wide_smem + c.off[a]);
  else run(c.wsb + c.off[a]);
}

// p (an address in this block's shared memory or workspace slice) in
// block s of the cluster
template <class P>
__device__ __forceinline__ P* wide_peer(P* p, int s, int rank, long long ws_floats) {
  if (s == rank) return p;
  if (__isShared(p)) return cg::this_cluster().map_shared_rank(p, s);
  return p + (long long)(s - rank) * ws_floats;
}

// The structured operator of one block of the cluster (see the header):
// the hooks of admm_core.cuh on the context in shared memory.
struct WideOp {
  mutable int seq;  // exchanges so far (the same in every thread of the cluster)

  __device__ static int kbeg(const WideCtx& c, int s) { return s * c.T / c.cs; }
  __device__ static int owner(const WideCtx& c, int k) {
    int s = 0;
    while (s + 1 < c.cs && kbeg(c, s + 1) <= k) ++s;
    return s;
  }
  // block k of pd / pe (a = kWPd, kWPe; their owner's, through the
  // cluster where it is another block)
  __device__ static const float* band_blk(const WideCtx& c, int a, int k) {
    const size_t b2 = (size_t)c.bb * c.bb;
    if (!in_smem(c, kWPd) || !in_smem(c, kWPe)) return (a == kWPd ? c.pdg : c.peg) + k * b2;
    const int o = owner(c, k);
    return wide_peer(wide_smem + c.off[a], o, c.rank, 0) + (k - kbeg(c, o)) * b2;
  }

  // The next slot of the exchange ring.  Exchange e writes this block's
  // part into part `rank` of slot e % 2 of every block and reads the
  // parts locally after the cluster barrier; before exchange e + 2 writes
  // the slot again, every block has passed exchange e + 1's barrier, so
  // every block has read it.
  __device__ float* slot() const {
    const WideCtx& c = wide_ctx();
    return wide_smem + c.xch + (seq++ & 1) * c.cs * c.xlen;
  }

  // Combines the block results v[0..K) with the other blocks', in rank
  // order; every thread of the cluster returns the same values.
  template <int K, bool MAX>
  __device__ void combine(float (&v)[K]) const {
    float* s = slot();
    const WideCtx& c = wide_ctx();
    const int cs = c.cs, rank = c.rank, xlen = c.xlen;
    if (threadIdx.x == 0)
      for (int t = 0; t < cs; ++t) {
        float* d = wide_peer(s, t, rank, 0) + rank * xlen;
#pragma unroll
        for (int k = 0; k < K; ++k) d[k] = v[k];
      }
    cg::this_cluster().sync();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float r = s[k];
      for (int t = 1; t < cs; ++t) r = MAX ? nan_max(r, s[t * xlen + k]) : r + s[t * xlen + k];
      v[k] = r;
    }
  }

  // ---- the hooks of admm_core.cuh ---------------------------------------

  // A' w: this block's partial over its rows, for every column, into every
  // block's slot (wide_band_atmv, or cols_dot on the dense rows); then
  // epi(j, sum of the parts in rank order) for all n.
  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    float* part = slot();
    const WideCtx& c = wide_ctx();
    const int cs = c.cs, rank = c.rank, xlen = c.xlen, n = c.n;
    float* mine = part + rank * xlen;
    if (c.band) {
      const int* loffs = reinterpret_cast<const int*>(wide_smem + c.loffs);
      const int* ent = reinterpret_cast<const int*>(wide_smem + c.ent);
      on_arr(c, kWA, [&](const float* As) {
        wide_band_atmv(As, c.lds, loffs, ent, c.T, c.bb, w, mine, cs, rank);
      });
    } else {
      cols_dot<4>(c.Ad, n, c.ml, n, w, [=](int j, float acc) {
        for (int t = 0; t < cs; ++t) wide_peer(mine, t, rank, 0)[j] = acc;
      });
    }
    cg::this_cluster().sync();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float s = part[j];
      for (int t = 1; t < cs; ++t) s += part[t * xlen + j];
      epi(j, s);
    }
  }

  // A v for this block's rows (wide_band_amv into av, or rows_dot on the
  // dense rows).
  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    const WideCtx& c = wide_ctx();
    if (!c.band) {
      rows_dot<4>(c.Ad, c.n, c.ml, c.n, v, epi);
      return;
    }
    float* av = wide_smem + c.av;
    const int ml = c.ml;
    const int* kr = reinterpret_cast<const int*>(wide_smem + c.kr);
    on_arr(c, kWA, [&](const float* As) { wide_band_amv(As, c.lds, kr, c.bb, c.W, ml, v, av); });
    __syncthreads();
    for (int i = threadIdx.x; i < ml; i += blockDim.x) epi(i, av[i]);
  }

  // (P v)_k = P_{k,k} v_k + P_{k,k-1} v_{k-1} + P_{k+1,k}' v_{k+1} for this
  // block's column blocks, one thread a row, written into every block;
  // ends with a cluster barrier, so out holds all of P v everywhere.
  __device__ void pmv(const float* v, float* out) const {
    const WideCtx& c = wide_ctx();
    const int bb = c.bb, T = c.T, kb = c.kb, cs = c.cs, rank = c.rank;
    for (int r = threadIdx.x; r < (c.ke - kb) * bb; r += blockDim.x) {
      const int kl = r / bb, i = r - kl * bb, k = kb + kl, o = k * bb;
      const float* d = band_blk(c, kWPd, k) + (size_t)i * bb;
      float acc = 0.f;
      for (int j = 0; j < bb; ++j) acc = fmaf(d[j], v[o + j], acc);
      if (k > 0) {
        const float* e = band_blk(c, kWPe, k - 1) + (size_t)i * bb;
        float a2 = 0.f;
        for (int j = 0; j < bb; ++j) a2 = fmaf(e[j], v[o - bb + j], a2);
        acc += a2;
      }
      if (k + 1 < T) {
        const float* e = band_blk(c, kWPe, k) + i;
        float a3 = 0.f;
        for (int j = 0; j < bb; ++j) a3 = fmaf(e[(size_t)j * bb], v[o + bb + j], a3);
        acc += a3;
      }
      for (int t = 0; t < cs; ++t) wide_peer(out, t, rank, 0)[o + i] = acc;
    }
    cg::this_cluster().sync();
  }

  // out = M^-1 b (see the header); out holds all of it in every block on
  // return.  The caller's barrier follows.
  __device__ void apply_minv(const float* b, float* out) const {
    const WideCtx& c = wide_ctx();
    cg::cluster_group cl = cg::this_cluster();
    const int bb = c.bb, kb = c.kb, ke = c.ke, cs = c.cs, rank = c.rank, T = c.T, ldl = c.ldl;
    const int o0 = kb * bb, own = (ke - kb) * bb;
    float* tw = wide_smem + c.tw;
    on_arr(c, kWLi, [&](const float* Li) { wide_lower(Li, ldl, bb, own, b + o0, out + o0); });
    __syncthreads();
    for (int s = 0; s < cs; ++s) {  // the forward chain, owners in rank order
      if (s == rank && ke > kb) {
        on_arr(c, kWC, [&](const float* C) {
          wide_chain(C + c.gofs, out, out, kb > 0 ? kb : 1, ke, 1, bb);
        });
        if (s + 1 < cs) wide_publish(out, ke - 1, ke, bb, cs, rank);  // w_{ke-1} on
      }
      if (s + 1 < cs) cl.sync();
    }
    __syncthreads();
    on_arr(c, kWLi, [&](const float* Li) { wide_upper(Li, ldl, bb, own, out + o0, tw + o0); });
    __syncthreads();
    for (int s = cs - 1; s >= 0; --s) {  // the backward chain, in reverse rank order
      if (s == rank && ke > kb) {
        int k = ke - 1;
        if (k == T - 1) {  // x_{T-1} = d_{T-1}
          for (int i = threadIdx.x; i < bb; i += blockDim.x) out[k * bb + i] = tw[k * bb + i];
          __syncthreads();
          --k;
        }
        on_arr(c, kWC, [&](const float* C) {
          wide_chain(C + c.hofs, tw, out, k, kb - 1, -1, bb);
        });
        wide_publish(out, kb, ke, bb, cs, rank);  // x_k of the own blocks everywhere
      }
      cl.sync();
    }
  }

  // Gram band, then block-Thomas into Li (L_k^-1), G', H'.  Returns the
  // cluster-uniform fail flag.
  __device__ bool factor(const float* rv) const {
    const WideCtx& c = wide_ctx();
    cg::cluster_group cl = cg::this_cluster();
    const int tid = threadIdx.x, NT = blockDim.x, bb = c.bb, b2 = bb * bb, T = c.T;
    const int kb = c.kb, ke = c.ke, cs = c.cs, rank = c.rank, ldl = c.ldl, ldf = c.ldf;
    const size_t nb2 = (size_t)b2, lb = (size_t)bb * ldl;
    float* Li = wide_arr(c, kWLi);
    float* G = wide_arr(c, kWC) + c.gofs;  // G_k' at G + k bb^2
    float* H = wide_arr(c, kWC) + c.hofs;  // E_k, then H_k' at H + k bb^2
    float* Fa = wide_arr(c, kWFa);
    float* Fb = wide_arr(c, kWFb);
    const int* loffs = reinterpret_cast<const int*>(wide_smem + c.loffs);
    const int* ent = reinterpret_cast<const int*>(wide_smem + c.ent);
    for (int k = 0; k < T; ++k) {
      wide_gram_part(wide_arr(c, kWA), c.lds, loffs, ent, c.Ad, c.n, c.ml, c.band, rv, k, T,
                     bb, Fa, Fb, ldf);
      cl.sync();
      if (k >= kb && k < ke) {  // D_k + pd_k + sigma I into L^-1's place, E_k + pe_k into H's
        float* Dk = Li + (k - kb) * lb;
        float* Ek = H + k * nb2;
        const bool e_k = k + 1 < T;
        const float* pdk = band_blk(c, kWPd, k);
        const float* pek = band_blk(c, kWPe, k);
        for (int e = tid; e < b2; e += NT) {
          const int i = e / bb, j = e - i * bb, o = i * ldf + j;
          float sd = wide_peer(Fa, 0, rank, c.ws_floats)[o];
          float se = wide_peer(Fb, 0, rank, c.ws_floats)[o];
          for (int t = 1; t < cs; ++t) {
            sd += wide_peer(Fa, t, rank, c.ws_floats)[o];
            se += wide_peer(Fb, t, rank, c.ws_floats)[o];
          }
          Dk[i * ldl + j] = pdk[e] + (i == j ? c.sigma : 0.f) + sd;
          if (e_k) Ek[e] = pek[e] + se;
        }
      }
      cl.sync();
    }
    ADMM_PHASE_END(kPhGram);
    ADMM_PHASE_BEGIN(kPhThomas);
    bool fail = false;
    for (int s = 0; s < cs; ++s) {  // the owners in rank order, F handed on
      if (s == rank && ke > kb) {
        if (kb == 0)  // F_{-1} = 0; else F_{kb-1} was handed over into Fa
          for (int e = tid; e < bb * ldf; e += NT) Fa[e] = 0.f;
        __syncthreads();
        const float* Fp = wide_thomas(Li, ldl, G, H, wide_arr(c, kWS), Fa, Fb, ldf,
                                      wide_smem + c.sc, kb, ke, T, bb, fail);
        if (s + 1 < cs)  // F_{ke-1} into every other block's Fa
          for (int e = tid; e < bb * ldf; e += NT)
            for (int t = 0; t < cs; ++t)
              if (t != rank) wide_peer(Fa, t, rank, c.ws_floats)[e] = Fp[e];
      }
      if (s + 1 < cs) cl.sync();
    }
    float v[1] = {fail ? 1.f : 0.f};
    combine<1, true>(v);
    return v[0] != 0.f;
  }
};

// The cluster's reductions: the block's, then combined with the others'.
template <int K>
__device__ __forceinline__ void op_max(const WideOp& op, float (&v)[K], float* red) {
  block_max(v, red);
  op.template combine<K, true>(v);
}

template <int K>
__device__ __forceinline__ void op_sum(const WideOp& op, float (&v)[K], float* red) {
  block_sum(v, red);
  op.template combine<K, false>(v);
}

// The exchange count, carried through the Anderson step (op_state).
__device__ __forceinline__ int op_state(const WideOp& op) { return op.seq; }
__device__ __forceinline__ void op_set_state(const WideOp& op, int seq) { op.seq = seq; }

// Each block adds the terms of its own column blocks' entries of the
// n-vectors (equal in every block), so that the combined sums count each
// once.
__device__ __forceinline__ void op_cols(const WideOp&, int, int& j0, int& j1) {
  const WideCtx& c = wide_ctx();
  j0 = c.kb * c.bb;
  j1 = c.ke * c.bb;
}

// K6 / K7 at a wide internal block.  Per problem (a cluster): load, the
// band rows and their lists, the route agreed by the cluster; rho = rho0 +
// 0 q_0 or rho_in's select; the ADMM solve entered with a pending rho;
// output x, z, y, the stats (9, B) and the route.  This unit compiles it as
// qp_btd_wide_kernel (without Anderson) and qp_kernel_btd_wide_aa.cu as
// qp_btd_wide_kernel_aa.
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
__global__ void __launch_bounds__(kWideThreads) qp_btd_wide_kernel(
#else
__global__ void __launch_bounds__(kWideThreads) qp_btd_wide_kernel_aa(
#endif
    StepParams p, int bb, int batch, const float* __restrict__ pdg,
    const float* __restrict__ peg, const float* __restrict__ Ag, const float* __restrict__ qg,
    const float* __restrict__ lg, const float* __restrict__ ug,
    const uint8_t* __restrict__ active, const float* __restrict__ rho_in,
    const float* __restrict__ x0, const float* __restrict__ z0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ z_out, float* __restrict__ y_out,
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
    float* __restrict__ stats, uint8_t* __restrict__ route, float* __restrict__ ws) {
  constexpr bool AA = false;
  const AaArgs aa_args{0, nullptr};
#else
    float* __restrict__ stats, uint8_t* __restrict__ route, float* __restrict__ ws,
    AaArgs aa_args) {
  constexpr bool AA = true;
#endif
  float* smem = wide_smem + kWideCtxFloats;  // after the operator's context
  ADMM_PHASE_BEGIN(kPhTotal);
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const WideLayout Lay = wide_layout(p.n, p.m, bb, cs, AA ? aa_args.sm_stride : 0);
  const int n = p.n, m = p.m, T = Lay.T, m0 = Lay.m0, W = Lay.W, lds = Lay.lds;
  const int xlen = Lay.xlen;
  const size_t b = blockIdx.x / cs, b2 = (size_t)bb * bb;
  const int r0 = rank * m0, ml = r0 < m ? min(m0, m - r0) : 0;
  const int kb = rank * T / cs, ke = (rank + 1) * T / cs;
  const int tid = threadIdx.x, NT = blockDim.x, lane = tid & 31, wp = tid >> 5,
            nw = NT >> 5;

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
  float* yp = tm + m0;
  float* av = yp + m0;  // 8 m0
  float* red = av + m0;
  float* sc = red + kRedSlots;  // kPanel + 1
  float* xch = sc + kPanel + 1;  // 2 cs xlen
  int* kr = reinterpret_cast<int*>(xch + 2 * cs * xlen);
  int* loffs = kr + m0;
  int* ent = loffs + T + 1;
  float* arrays = wide_smem + Lay.fixed;
  float* wsb = ws ? ws + (b * cs + rank) * (size_t)Lay.ws_floats : nullptr;
  float* arr[kWideArrays];
  for (int a = 0; a < kWideArrays; ++a)
    arr[a] = (Lay.smem >> a & 1) ? arrays + Lay.off[a]
                                 : (Lay.off[a] < 0 ? nullptr : wsb + Lay.off[a]);
  const bool pd_own = arr[kWPd] != nullptr && arr[kWPe] != nullptr;
  float* As = arr[kWA];
  const float* Ad = Ag + (b * m + r0) * (size_t)n;

  // the vectors; pd and pe of this block's column blocks in flight
  for (int j = tid; j < n; j += NT) {
    q[j] = qg[b * n + j];
    x[j] = x0[b * n + j];
  }
  for (int i = tid; i < ml; i += NT) {
    const size_t o = b * m + r0 + i;
    z[i] = z0[o];
    y[i] = y0[o];
    l[i] = lg[o];
    u[i] = ug[o];
  }
  if (pd_own) {
    const size_t src = b * (size_t)n * bb + kb * b2, cnt = (ke - kb) * b2;
    const bool al = (((uintptr_t)(pdg + src) | (uintptr_t)(peg + src)) & 15) == 0;
    for (size_t e = (al ? 4 * tid : tid); e < cnt; e += (al ? 4 * NT : NT)) {
      if (al) {
        cp_async16(arr[kWPd] + e, pdg + src + e);
        cp_async16(arr[kWPe] + e, peg + src + e);
      } else {
        cp_async4(arr[kWPd] + e, pdg + src + e);
        cp_async4(arr[kWPe] + e, peg + src + e);
      }
    }
  }
  // the band rows: a warp a row finds its first and last nonzero column
  // (a NaN counts as nonzero), sets k_r and puts its slab in flight
  bool fits = true;
  const bool as_smem = __isShared(As);
  for (int i = wp; i < ml; i += nw) {
    const float* row = Ad + (size_t)i * n;
    int f = n, e = -1;
    for (int j = lane; j < n; j += 32)
      if (row[j] != 0.f) {
        f = min(f, j);
        e = max(e, j);
      }
    f = __reduce_min_sync(0xffffffffu, f);
    e = __reduce_max_sync(0xffffffffu, e);
    const int kf = f == n ? 0 : f / bb, kl = e < 0 ? 0 : e / bb;
    const int k = min(kf, max(T - 2, 0));
    fits = fits && kl <= k + 1;
    if (lane == 0) kr[i] = k;
    const float* src = row + k * bb;
    float* dst = As + (size_t)i * lds;
    if (as_smem && ((uintptr_t)src & 15) == 0) {
      for (int c = 4 * lane; c < W; c += 128) cp_async16(dst + c, src + c);
    } else if (as_smem) {
      for (int c = lane; c < W; c += 32) cp_async4(dst + c, src + c);
    } else {
      for (int c = lane; c < W; c += 32) dst[c] = src[c];
    }
  }
  cp_async_wait_all();
  fits = __syncthreads_and(fits);
  // each column block's list of the rows whose slab covers it: counts,
  // their prefix, then the entries in row order
  for (int k = wp; k < T; k += nw) {
    int cnt = 0;
    for (int i0 = 0; i0 < ml; i0 += 32) {
      const int i = i0 + lane;
      const bool in = i < ml && (kr[i] == k || kr[i] + 1 == k);
      cnt += __popc(__ballot_sync(0xffffffffu, in));
    }
    if (lane == 0) loffs[k + 1] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    loffs[0] = 0;
    for (int k = 0; k < T; ++k) loffs[k + 1] += loffs[k];
  }
  __syncthreads();
  for (int k = wp; k < T; k += nw) {
    int pos = loffs[k];
    for (int i0 = 0; i0 < ml; i0 += 32) {
      const int i = i0 + lane;
      const bool in = i < ml && (kr[i] == k || kr[i] + 1 == k);
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (in) {
        const int at = pos + __popc(bal & ((1u << lane) - 1u));
        ent[at] = 2 * i + (k - kr[i]);
      }
      pos += __popc(bal);
    }
  }
  __syncthreads();

  if (tid == 0) {
    WideCtx& c = *reinterpret_cast<WideCtx*>(wide_smem);
    auto at = [](const void* q) { return (int)(reinterpret_cast<const float*>(q) - wide_smem); };
    c.Ad = Ad;
    c.pdg = pdg + b * n * (size_t)bb;
    c.peg = peg + b * n * (size_t)bb;
    c.wsb = wsb;
    c.ws_floats = Lay.ws_floats;
    for (int a = 0; a < kWideArrays; ++a)
      c.off[a] = (Lay.smem >> a & 1) ? (int)(Lay.fixed + Lay.off[a]) : (int)Lay.off[a];
    c.smem = Lay.smem;
    c.kr = at(kr);
    c.loffs = at(loffs);
    c.ent = at(ent);
    c.sc = at(sc);
    c.tw = at(tw);
    c.av = at(av);
    c.xch = at(xch);
    c.xlen = xlen;
    c.rank = rank;
    c.cs = cs;
    c.n = n;
    c.ml = ml;
    c.T = T;
    c.bb = bb;
    c.W = W;
    c.lds = lds;
    c.ldl = Lay.ldl;
    c.ldf = Lay.ldf;
    c.kb = kb;
    c.ke = ke;
    int ng;
    wide_couplings(T, cs, rank, ng);
    c.gofs = -(kb > 1 ? kb : 1) * bb * bb;
    c.hofs = (ng - kb) * bb * bb;
    c.sigma = p.sigma;
    c.band = 0;
  }
  __syncthreads();
  const WideOp op{0};
  {  // the route, agreed by the cluster (also publishes pd / pe to the peers)
    float v[1] = {fits ? 0.f : 1.f};
    op.combine<1, true>(v);
    if (tid == 0) reinterpret_cast<WideCtx*>(wide_smem)->band = v[0] == 0.f ? 1 : 0;
    __syncthreads();
  }

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

  StepParams pl = p;
  pl.m = ml;  // the ADMM core sees this block's rows
  // Anderson's state: its Gram area at the end of the fixed part (the
  // launcher's sm_off) or at the head of the block's workspace slice, its
  // ring in that slice, one a block, sized for m0 rows (aa_state)
  if constexpr (AA) {
    const AaState aa = aa_state(aa_args, wide_smem, 0, blockIdx.x, n, m0);
    admm_solve<WideOp, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                           aa.ring, aa.k, aa.gram);
  } else {
    admm_solve<WideOp, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st);
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
    route[b] = wide_ctx().band ? 1 : 0;
  }
  // no block leaves before the others are past the last access into it
  cl.sync();
}

// Whether an Anderson launch of memory k keeps its Gram area in shared
// memory, at the end of the fixed part (wide_layout's reserve): always at
// k <= kAaGramSmemMemory; past it where the layout with the reserve keeps
// in shared memory every array that the one without it keeps there, and
// as many blocks an SM as shared memory allows that one.
bool wide_aa_gram_sm(int n, int m, int bb, int cs, int k) {
  if (k <= kAaGramSmemMemory) return true;
  const WideLayout L = wide_layout(n, m, bb, cs);
  const WideLayout Lg = wide_layout(n, m, bb, cs, aa_gram_floats(k));
  return Lg.ok && Lg.smem == L.smem &&
         smem_blocks_per_sm(Lg.smem_bytes) >= smem_blocks_per_sm(L.smem_bytes);
}

// A shape the wide kernel takes: bb a multiple of 8 dividing n (its layout
// may still refuse it, where the fixed part does not fit).
bool wide_shape(int n, int m, int bb) {
  return bb >= 8 && bb % 8 == 0 && n > 0 && m > 0 && n % bb == 0;
}

// The launch of this unit's kernel on a checked shape (wide_shape), the
// workspace given where the layout needs one; with Anderson (aa.ws), the
// Gram area where wide_aa_gram_sm puts it.
cudaError_t launch_wide(int n, int m, int bb, float sigma, float alpha, float rho0,
                        float eps_abs, float eps_rel, int n_epochs, int chunks_per_epoch,
                        int seg, int adaptive_rho, float adaptive_rho_tolerance,
                        int check_infeas, float eps_pinf, float eps_dinf, int batch,
                        const float* pd, const float* pe, const float* A, const float* q,
                        const float* l, const float* u, const uint8_t* active,
                        const float* rho_in, const float* x0, const float* z0, const float* y0,
                        float* x_out, float* z_out, float* y_out, float* stats, uint8_t* route,
                        float* ws, int device, void* stream, AaArgs aa) {
  if (!wide_shape(n, m, bb)) return cudaErrorInvalidValue;
  const int cs = kWideCluster;
  const bool gram_sm = aa.ws == nullptr || wide_aa_gram_sm(n, m, bb, cs, aa.k);
  const long long reserve = aa.ws != nullptr && gram_sm ? aa_gram_floats(aa.k) : 0;
  const WideLayout L = wide_layout(n, m, bb, cs, reserve);
  if (!L.ok || (L.ws_floats > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  aa.sm_off = L.fixed - reserve;
  aa.sm_stride = (int)reserve;
  aa.ring_sm = 0;
  aa.gram_ws = gram_sm ? 0 : 1;
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
  p.n_smem_mats = 0;
  p.ws_floats = L.ws_floats;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * cs);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = (size_t)L.smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
  (void)aa;
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                           z0, y0, x_out, z_out, y_out, stats, route, ws);
#else
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                           z0, y0, x_out, z_out, y_out, stats, route, ws, aa);
#endif
  if (err != cudaSuccess) return err;
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
      float eps_dinf, int device, void *stream, float *ws, uint8_t *route
#define QP_BTD_WIDE_CALL                                                                    \
  n, m, bb, sigma, alpha, rho0, eps_abs, eps_rel, n_epochs, chunks_per_epoch, seg,      \
      adaptive_rho, adaptive_rho_tolerance, check_infeas, eps_pinf, eps_dinf, batch, pd, pe, \
      A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out, stats, route, ws, device, \
      stream

namespace {

// A layout's report (qp_btd_wide_layout) into out[11]; 0, or -1 where the
// fixed part does not fit.
int wide_report(const WideLayout& L, long long* out) {
  const long long v[11] = {L.cs, L.smem_bytes, L.ws_floats, (long long)L.smem, L.iter_bytes,
                           L.T,  L.R,          L.m0,        L.W,               L.lds,
                           L.fixed};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return L.ok ? 0 : -1;
}

}  // namespace

extern "C" {

#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
// The layout of one block of the launcher's cluster at this shape, into
// out[11]: the blocks a problem, shared-memory bytes, workspace floats,
// the mask of the arrays in shared memory (bit a of L^-1, the couplings
// G', H', A's band rows, S, F_{k-1}, F_k, pd, pe), the bytes an iteration
// reads from device memory a problem, T, column blocks a block (at most), rows a block, the band
// row's width and stride, and the fixed part's floats.  Returns 0, or -1
// where the shape is refused.
int qp_btd_wide_layout(int n, int m, int bb, long long* out) {
  if (!wide_shape(n, m, bb)) return -1;
  return wide_report(wide_layout(n, m, bb, kWideCluster), out);
}

// One launch of the wide kernel; the arguments of qp_btd_launch, the
// workspace (batch x 2 x the layout's workspace floats) and the route
// (B,).
int qp_btd_wide_launch(QP_BTD_WIDE_ARGS) {
  if (batch <= 0) return 0;
  return (int)launch_wide(QP_BTD_WIDE_CALL, AaArgs{0, nullptr});
}
#else
// The layout of one block of an Anderson launch of memory k, as
// qp_btd_wide_layout gives it, and out[11]: its Gram area in shared memory
// (1: the fixed part ends with it, so that the workspace floats may be
// more) or at the head of the Anderson workspace slice (0)
// (wide_aa_gram_sm).
int qp_btd_wide_layout_aa(int n, int m, int bb, int k, long long* out) {
  if (!wide_shape(n, m, bb) || k <= 0) return -1;
  const bool gram_sm = wide_aa_gram_sm(n, m, bb, kWideCluster, k);
  out[11] = gram_sm ? 1 : 0;
  return wide_report(wide_layout(n, m, bb, kWideCluster, gram_sm ? aa_gram_floats(k) : 0), out);
}

// With Anderson acceleration of any memory aa_mem > 0, its Gram area in
// shared memory (wide_layout's reserve; ws then holds
// qp_btd_wide_layout_aa's workspace floats a block) or in aa_ws, and its
// ring in aa_ws: batch x 2 slices of admm_aa_floats(aa_mem, n, ceil(m /
// 2)) floats, one a block.
int qp_btd_wide_launch_aa(QP_BTD_WIDE_ARGS, int aa_mem, float* aa_ws) {
  if (batch <= 0) return 0;
  if (aa_mem <= 0 || aa_ws == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_wide(QP_BTD_WIDE_CALL, AaArgs{aa_mem, aa_ws});
}
#endif

}  // extern "C"
