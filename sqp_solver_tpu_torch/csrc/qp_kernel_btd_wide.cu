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
// runtime argument, at every shape whose vectors and fixed part fit a
// block's shared memory, by two routes of one design (a cluster of thread
// blocks a problem, the arrays an ADMM iteration reads in the cluster's
// shared memory where they fit):
//
//   up to kWideCompactAbove (128): the band route (qp_btd_wide_kernel,
//   WideOp, wide_layout), a cluster of two, A in two-block band rows,
//   each block holding the arrays of its column blocks;
//   past it (the OSQP control class at 50 states: declared stage block
//   75, bb = 152): the compact route (qp_btd_xwide_kernel, XOp,
//   xwide_rule), A's band rows held by their nonzeros, a cluster of 2, 4
//   or 8 that the layout rule picks, every matrix of the sweeps in a slot
//   of one block (second part below).
//
// The band route.  One problem a cluster of CS = 2 thread blocks of 256
// threads.
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
//               block barrier;
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
// are given).  A cluster of four blocks measured 1.4-2.2x slower than two
// on an H100 at every shape up to 128 it was tried on, where two held
// every array an iteration reads (its cluster barriers and chain
// hand-overs cost more than the reads they save), so this route takes
// two.  At the 6-DOF arm's shape (n = 360, m = 600, bb = 40) two blocks
// hold L^-1, the couplings, A's band rows (300 a block) and S: an ADMM
// iteration reads nothing from device memory.
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
// The compact route past 128.  There the band route's arrays outgrow two
// blocks (at the control class's shape, n = 760, m = 1,250, bb = 152,
// T = 5: L^-1 0.46 MB, the couplings 0.74 MB, A's band rows 1.52 MB), an
// iteration waited on 4.24 MB of device memory a problem inside its
// dependent steps, and most of A's band rows are zeros (the control
// class's 36 K nonzeros in 380 K band entries).  So:
//
//   A by its nonzeros.  The block's rows are r, r + cs, r + 2 cs, ... (its
//   share of every kind of row, so the blocks hold alike many nonzeros);
//   at load it keeps, beside k_r and the column blocks' lists, each row's
//   nonzeros in its slab in column order (a float and a 16-bit column
//   within the slab) for A v, four lanes a row, and the same entries by
//   column (a float and a 16-bit row) for A' w, a thread a column; the
//   factor's Gram puts batches of a column block's rows back into dense
//   staging rows in the iterations' scratch (dead while it runs) and sums
//   register tiles of D_k's lower triangle and of E_k over them
//   (x_gram_staged).  A problem with a row outside two
//   consecutive blocks, or a block with more nonzeros than the layout has
//   room for, takes the dense route, as in the band route.
//
//   The matrices of the sweeps in slots.  L_k^-1 (T), G_k (T - 1) and
//   H_k (T - 1), numbered couplings first (xj_g, xj_h, xj_l), each in a
//   slot of one block (matrix j in block j % cs, slot j / cs), the slots
//   in shared memory as far as they fit; the couplings row-major.  M^-1 b
//   runs in phases, each ended by one cluster barrier: c_k = L_k^-1 b_k by
//   every holder at once (a thread a row), a forward chain step a phase
//   (G_k's holder: eight lanes a row over float4s of G_k's rows), d_k =
//   L_k^-T w_k at once (a thread a column), a backward chain step a phase;
//   each phase's result is written into the block's own vector, then into
//   every other block's as float4s by all its threads (2 T barriers at T
//   blocks).
//
//   The cluster (xwide_rule).  Of 2, 4 and 8, the smallest at which an
//   iteration reads nothing from device memory, else the one (and the
//   order: A, or the slots, first into shared memory) that reads the
//   fewest bytes, for the nonzeros the wrapper counts (compact_nnz).  A' w
//   partials stay in the block (a ring of two n-slots) and every block
//   sums the cs partials by reading them across the cluster in rank order,
//   so the fixed part does not grow with the cluster; the reductions push
//   eight values a block into a ring of two 64-float slots.  At the
//   control shape: eight blocks, every matrix on chip, A's 4,581 nonzeros
//   a block in the workspace: 0.44 MB an iteration a problem.
//
//   The factor.  Block-Thomas a column block k at a time over the whole
//   cluster (XOp::factor): every block's Gram partial; the sums into
//   L_k^-1's slot and its holder's (the runner's) E; S_k = D_k - F_{k-1}
//   F_{k-1}' in place; the runner's chol_blocked and tri_inv_inplace in its
//   own shared memory; G_k, F_k (into the next runner's F_{k-1}) and H_k,
//   each product in 4 x 4 register tiles spread over the cluster's
//   threads.
//
//   What bounds it on this card: an iteration's latency, as the band
//   route's, now mostly M^-1 b's 2 T phases (each a block's matvec and a
//   cluster barrier; about 0.6 of an iteration at the control shape), not
//   device memory; a batch needs cs B blocks of one SM each, so a larger
//   cluster also halves the problems in flight.
//
// Anderson acceleration as in qp_kernel_btd.cu: a second instantiation of
// each route's body (AA = true) in qp_kernel_btd_wide_aa.cu, which
// includes this file with QP_KERNEL_BTD_WIDE_AA_UNIT defined; its Gram area
// in shared memory (the layout's reserve) where wide_aa_plan puts it,
// else at the head of the block's Anderson workspace slice; its ring in
// that slice.  Past memory 32 the chunk's system goes to a solve area, in
// the reserve or the workspace, that the whole block solves by columns
// (the instantiations of qp_kernel_btd_wide_aas.cu).

#include <cooperative_groups.h>

#include "admm_core.cuh"
#include "dense_factor.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWideThreads = 256;
constexpr int kWideQuad = 2;  // chol_blocked's trailing-update tiles
constexpr int kWideCtxFloats = 64;  // the operator's context (WideCtx)
constexpr int kWideCluster = 2;     // thread blocks a problem
constexpr int kWideCompactAbove = 128;  // internal blocks past it take the compact route

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
// Two lanes a row (2 bb <= threads): lane s of row i's pair sums columns
// s, s + 2, ... (consecutive pairs on consecutive words of C), the pair's
// sums meet by a shuffle, and one block barrier a step publishes y_k.
__device__ __forceinline__ void wide_chain(const float* C, const float* rhs, float* y, int k0,
                                           int k1, int dir, int bb) {
  const int t = threadIdx.x, i = t >> 1, sl = t & 1;
  const bool row = i < bb;
  const size_t b2 = (size_t)bb * bb;
  for (int k = k0; k != k1; k += dir) {
    const float* Ct = C + k * b2 + sl * bb + (row ? i : 0);
    const float* yp = y + (k - dir) * bb + sl;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (row) {
      int j = 0;
#pragma unroll 2
      for (; j + 8 <= bb; j += 8) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = fmaf(Ct[(size_t)(j + 2 * u) * bb], yp[j + 2 * u], a[u]);
      }
      for (; j + sl < bb; j += 2) a[0] = fmaf(Ct[(size_t)j * bb], yp[j], a[0]);
    }
    float acc = (a[0] + a[1]) + (a[2] + a[3]);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (row && sl == 0) y[k * bb + i] = rhs[k * bb + i] - acc;
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
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
__global__ void __launch_bounds__(kWideThreads) qp_btd_wide_kernel_aa(
#else
__global__ void __launch_bounds__(kWideThreads) qp_btd_wide_kernel_aas(
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
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
    float* __restrict__ stats, uint8_t* __restrict__ route, float* __restrict__ ws,
    AaArgs aa_args) {
  constexpr bool AA = true;
#else
    float* __restrict__ stats, uint8_t* __restrict__ route, float* __restrict__ ws,
    AaArgs aa_args, AaSysArgs sys_args) {
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
#ifdef QP_KERNEL_BTD_WIDE_AAS_UNIT
    admm_solve<WideOp, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                           aa.ring, aa.k, aa.gram,
                           aa_sys(sys_args, aa.k, wide_smem, 0, blockIdx.x));
#else
    admm_solve<WideOp, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                           aa.ring, aa.k, aa.gram);
#endif
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


// ---- past internal block 128: the compact route ---------------------------
// (design in the header: A held by its nonzeros, the cluster the rule's,
// rows dealt round the blocks, every matrix of the sweeps in a slot of one
// block)

constexpr int kXCmb = 64;  // a combine slot: eight values of each of up to eight blocks

// The factor's scratch arrays: F_{k-1} (the runner's), the Gram's D and E
// partials (E_k itself at the runner).
enum XScratch { kXFp, kXPd, kXPe, kXScratch };

struct XLayout {
  int cs, T, m0, W, ldl, ldf, xlen, nmat, nslot, mat_sm;
  bool a_first, a_sm, ok;
  unsigned scr_sm;                  // bit s: scratch array s in shared memory
  long long nnz;                    // A's entries a block has room for
  long long msz, fixed, a_floats;   // a matrix slot; floats before the arrays; A's floats
  long long a_off, mat_off, mat_ws;  // A; slot 0 in shared memory; the first slot in the workspace
  long long scr_off[kXScratch];
  long long ws_floats, iter_bytes, smem_bytes;
};

// The entries a block's band rows hold at most: ceil(m / cs) rows of W.
__host__ __device__ inline long long xwide_full_nnz(int n, int m, int bb, int cs) {
  const int T = n / bb;
  return (long long)((m + cs - 1) / cs) * ((T < 2 ? T : 2) * bb);
}

// The layout of one block of a cluster of cs at this shape, with room for
// nnz of A's entries.  Fixed part: the context; q, x, b, x~, two n scratch,
// x_prev, the sweeps' scratch (8 n); z, y, l, u, rho, one m scratch,
// y_prev, A v's (8 m0); the reduction slots, chol_blocked's scratch, the
// ring of two A' w slots (xlen each) and two combine slots; the ints k_r
// (m0), the lists' offsets (T + 1) and entries (2 m0), the row offsets
// (m0 + 1) and the column offsets (n + 1).  Arrays: A (the row-ordered
// values, the column-ordered values, then the 16-bit columns and rows,
// nnz each), the block's matrix slots (bb (bb + 1) floats each: L_k^-1
// with row stride bb + 1, or a coupling row-major), F_{k-1} and the
// Gram's D and E partials (row stride bb + 1); shared memory first-fit in
// the order
// A, slots, scratch (or slots, A, scratch: a_first false).
__host__ __device__ inline XLayout xwide_layout_as(int n, int m, int bb, int cs, long long nnz,
                                                   bool a_first, long long reserve = 0) {
  XLayout L;
  L.cs = cs;
  L.T = n / bb;
  L.m0 = (m + cs - 1) / cs;
  L.W = (L.T < 2 ? L.T : 2) * bb;
  L.ldl = bb + 1;
  L.ldf = bb + 1;
  L.xlen = round4(n > 8 ? n : 8);
  L.nmat = 3 * L.T - 2;
  L.nslot = (L.nmat + cs - 1) / cs;
  L.a_first = a_first;
  L.nnz = nnz;
  L.msz = round4ll((long long)bb * L.ldl);
  L.fixed = round4ll(kWideCtxFloats + 8LL * n + 8LL * L.m0 + kRedSlots + kPanel + 1 +
                     2LL * L.xlen + 2LL * kXCmb + 3LL * L.m0 + L.T + 1 + (L.m0 + 1LL) +
                     (n + 1LL)) +
            reserve;
  L.a_floats = round4ll(3 * nnz);
  const long long cap = kMaxSmemBytes / 4;
  long long used = L.fixed, ws = 0;
  // 16-bit rows and columns
  L.ok = used <= cap && L.m0 <= 65535 && L.W <= 65535;
  L.a_sm = false;
  L.mat_sm = 0;
  for (int pass = 0; pass < 2; ++pass) {
    if ((pass == 0) == a_first) {
      L.a_sm = L.ok && used + L.a_floats <= cap;
      if (L.a_sm) {
        L.a_off = used - L.fixed;
        used += L.a_floats;
      }
    } else {
      L.mat_off = used - L.fixed;
      while (L.ok && L.mat_sm < L.nslot && used + L.msz <= cap) {
        ++L.mat_sm;
        used += L.msz;
      }
    }
  }
  if (!L.a_sm) {
    L.a_off = ws;
    ws += L.a_floats;
  }
  L.mat_ws = ws;
  ws += (L.nslot - L.mat_sm) * L.msz;
  const long long bf = round4ll((long long)bb * L.ldf);
  L.scr_sm = 0;
  for (int s = 0; s < kXScratch; ++s) {
    if (L.ok && used + bf <= cap) {
      L.scr_off[s] = used - L.fixed;
      used += bf;
      L.scr_sm |= 1u << s;
    } else {
      L.scr_off[s] = ws;
      ws += bf;
    }
  }
  L.ws_floats = ws;
  L.ok = L.ok && ws < (1LL << 31);
  L.smem_bytes = used * 4;
  // an iteration: A v over the row-ordered entries and A' w over the
  // column-ordered ones (12 bytes an entry), c and d over L^-1's
  // triangles (one L^-1 in all), the two chains over the couplings
  long long ib = L.a_sm ? 0 : 12LL * cs * nnz;
  for (int j = 0; j < L.nmat; ++j)
    if (j / cs >= L.mat_sm) ib += 4LL * bb * bb;
  L.iter_bytes = ib;
  return L;
}

// The rule: the smallest cluster of 2, 4 and 8 at which an iteration reads
// nothing from device memory, else the one (and the order) that reads the
// fewest bytes, the smaller cluster on a tie.  nnz (kXNnzArgs values, or
// null): the most entries a block of the problems holds at each of the
// three clusters (null: the band rows' full count, xwide_full_nnz).  A
// build with -DXWIDE_FORCE_CLUSTER=2|4|8 or -DXWIDE_FORCE_ORDER=1|2 (A, or
// the slots, first) takes that cluster or order instead, for the
// measurements (tools/past128_probe.py).
constexpr int kXNnzArgs = 3;
#ifndef XWIDE_FORCE_CLUSTER
#define XWIDE_FORCE_CLUSTER 0
#endif
#ifndef XWIDE_FORCE_ORDER
#define XWIDE_FORCE_ORDER 0
#endif
__host__ __device__ inline XLayout xwide_rule(int n, int m, int bb, const long long* nnz,
                                              long long reserve = 0) {
  XLayout best = xwide_layout_as(n, m, bb, 2, xwide_full_nnz(n, m, bb, 2), true, reserve);
  bool have = false;
  for (int c = 0; c < kXNnzArgs && !(have && best.iter_bytes == 0); ++c) {
    const int cs = 2 << c;
    if (XWIDE_FORCE_CLUSTER && cs != XWIDE_FORCE_CLUSTER) continue;
    const long long nz = nnz ? nnz[c] : xwide_full_nnz(n, m, bb, cs);
    for (int af = 1; af >= 0; --af) {
      if (XWIDE_FORCE_ORDER && XWIDE_FORCE_ORDER != (af ? 1 : 2)) continue;
      const XLayout L = xwide_layout_as(n, m, bb, cs, nz, af != 0, reserve);
      if (L.ok && (!have || L.iter_bytes < best.iter_bytes)) {
        best = L;
        have = true;
      }
    }
  }
  return best;
}

// The matrices of the sweeps, numbered j: G_k (k = 1 .. T - 1) at k - 1,
// H_k (k = 0 .. T - 2) at T - 1 + k, L_k^-1 (k = 0 .. T - 1) at 2 T - 2 +
// k, the couplings first, so that they take the slots on chip first.
// Matrix j lies in block j % cs, slot j / cs.  (Consecutive couplings in
// one block, each chain hand-over within it a block barrier rather than a
// cluster barrier, measured slower at the control class's shape: the
// blocks holding two L_k^-1 ran the c and d phases twice as long.)
__host__ __device__ inline int xj_g(int T, int k) { return k - 1; }
__host__ __device__ inline int xj_h(int T, int k) { return T - 1 + k; }
__host__ __device__ inline int xj_l(int T, int k) { return 2 * T - 2 + k; }

// The compact route's context (as WideCtx): Ad the block's first row of A
// (row i at Ad + i lda, lda = cs n: the block's rows are r, r + cs, ...);
// A at aoff (wide_smem, or wsb where a_sm is 0): the row-ordered values,
// the column-ordered ones, the 16-bit columns (within the slab), the
// 16-bit rows, nnz apart; slot s at moff + s msz (s < mat_sm) or at
// wsb + mws + (s - mat_sm) msz; scratch array s at scr[s] (wide_smem where
// bit s of scr_sm is set, else wsb); the ints kr, loffs, ent (as
// WideCtx's), rp (row offsets into A), cp (column offsets); the A' w ring
// xch (two slots of xlen) and the combine ring cmb (two of kXCmb).
struct XCtx {
  const float* Ad;
  const float* pdg;
  const float* peg;
  float* wsb;
  long long ws_floats;
  int lda, a_sm, aoff, mat_sm, moff, mws, msz, nnz;
  int scr[kXScratch];
  unsigned scr_sm;
  int kr, loffs, ent, rp, cp, sc, tw, av, xch, cmb, stg, stg_rows;
  int xlen, rank, cs, n, ml, T, bb, ldl, ldf, kb, ke;
  float sigma;
  int band;
};
static_assert(sizeof(XCtx) <= 4 * kWideCtxFloats, "XCtx outgrew its slot");

__device__ __forceinline__ const XCtx& x_ctx() {
  return *reinterpret_cast<const XCtx*>(wide_smem);
}

// run(A's base), on the shared-memory address or the workspace's
template <class F>
__device__ __forceinline__ void x_on_a(const XCtx& c, F run) {
  if (c.a_sm) run(wide_smem + c.aoff);
  else run(c.wsb + c.aoff);
}

// the block and the slot of matrix j
__device__ __forceinline__ int x_blk(const XCtx& c, int j) { return j % c.cs; }
__device__ __forceinline__ int x_slot(const XCtx& c, int j) { return j / c.cs; }

// run(matrix j's base) in its holder, on the shared-memory address or the
// workspace's
template <class F>
__device__ __forceinline__ void x_on_mat(const XCtx& c, int j, F run) {
  const int s = x_slot(c, j);
  if (s < c.mat_sm) run(wide_smem + c.moff + s * c.msz);
  else run(c.wsb + c.mws + (s - c.mat_sm) * c.msz);
}

// matrix j wherever it lies, from any block of the cluster (the factor's
// paths)
__device__ __forceinline__ float* x_mat_any(const XCtx& c, int j) {
  const int t = x_blk(c, j), s = x_slot(c, j);
  if (s < c.mat_sm) {
    float* p = wide_smem + c.moff + s * c.msz;
    return t == c.rank ? p : cg::this_cluster().map_shared_rank(p, t);
  }
  return c.wsb + (long long)(t - c.rank) * c.ws_floats + c.mws + (s - c.mat_sm) * c.msz;
}

__device__ __forceinline__ float* x_scr(const XCtx& c, int s) {
  return (c.scr_sm >> s & 1) ? wide_smem + c.scr[s] : c.wsb + c.scr[s];
}

// val into entry i of y in every block of the cluster
__device__ __forceinline__ void x_put(float* y, int i, float val, int cs, int rank) {
  cg::cluster_group cl = cg::this_cluster();
  y[i] = val;
  for (int t = 0; t < cs; ++t)
    if (t != rank) cl.map_shared_rank(y, t)[i] = val;
}

// y's entries [0, cnt) into the blocks of bit mask `to` but this one, as
// float4s spread over the block's threads (cnt a multiple of 4, y 16-byte
// aligned).  No sync.
__device__ __forceinline__ void x_publish(float* y, int cnt, unsigned to, int rank) {
  cg::cluster_group cl = cg::this_cluster();
  to &= ~(1u << rank);
  const int n4 = cnt >> 2, np = __popc(to);
  const float4* src = reinterpret_cast<const float4*>(y);
  for (int e = threadIdx.x; e < np * n4; e += blockDim.x) {
    const int p = e / n4, q = e - p * n4;
    unsigned rest = to;  // the p-th block of the mask
    for (int i = 0; i < p; ++i) rest &= rest - 1;
    reinterpret_cast<float4*>(cl.map_shared_rank(y, __ffs(rest) - 1))[q] = src[q];
  }
}

// out_k = L_k^-1 b_k (wide_lower on one column block), then into the
// blocks of `to`.  Syncs inside.
__device__ __forceinline__ void x_lower(const float* Li, int ldl, int bb, const float* bk,
                                        float* outk, unsigned to, int rank) {
  wide_lower(Li, ldl, bb, bb, bk, outk);
  __syncthreads();
  x_publish(outk, bb, to, rank);
}

// out_k = L_k^-T w_k (wide_upper on one column block), then into the blocks
// of `to`.  Syncs inside.
__device__ __forceinline__ void x_upper(const float* Li, int ldl, int bb, const float* wk,
                                        float* outk, unsigned to, int rank) {
  wide_upper(Li, ldl, bb, bb, wk, outk);
  __syncthreads();
  x_publish(outk, bb, to, rank);
}

// One sweep chain step y_k = rhs_k - C yp, C row-major (row stride bb, rows
// 16-byte aligned): eight lanes a row, lane l summing the float4s l, l + 8,
// ... of its row against yp's (two sums in flight), the eight sums met by
// a butterfly; four rows a warp, the rows in rounds; then y_k into the
// blocks of `to`.  Syncs inside.
__device__ __forceinline__ void x_chain_step(const float* C, const float* rhs, const float* yp,
                                             float* yk, int bb, unsigned to, int rank) {
  const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int g = lane >> 3, sl = lane & 7, nq = bb >> 2;
  const float4* y4 = reinterpret_cast<const float4*>(yp);
  for (int i0 = 0; i0 < bb; i0 += 4 * nw) {
    const int i = i0 + 4 * wp + g;
    float a0 = 0.f, a1 = 0.f;
    if (i < bb) {
      const float4* r = reinterpret_cast<const float4*>(C + (size_t)i * bb);
      int q = sl;
      for (; q + 8 < nq; q += 16) {
        const float4 c0 = r[q], v0 = y4[q], c1 = r[q + 8], v1 = y4[q + 8];
        a0 = fmaf(c0.x, v0.x, a0);
        a0 = fmaf(c0.y, v0.y, a0);
        a0 = fmaf(c0.z, v0.z, a0);
        a0 = fmaf(c0.w, v0.w, a0);
        a1 = fmaf(c1.x, v1.x, a1);
        a1 = fmaf(c1.y, v1.y, a1);
        a1 = fmaf(c1.z, v1.z, a1);
        a1 = fmaf(c1.w, v1.w, a1);
      }
      if (q < nq) {
        const float4 c0 = r[q], v0 = y4[q];
        a0 = fmaf(c0.x, v0.x, a0);
        a0 = fmaf(c0.y, v0.y, a0);
        a0 = fmaf(c0.z, v0.z, a0);
        a0 = fmaf(c0.w, v0.w, a0);
      }
    }
    float acc = a0 + a1;
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    if (i < bb && sl == 0) yk[i] = rhs[i] - acc;
  }
  __syncthreads();
  x_publish(yk, bb, to, rank);
}

// This block's partial of the Gram band's column block k from its compact
// rows (the band route): the rows of k's list in batches of R, each row's
// entries in column blocks k and k + 1 put into a staging row of 2 bb
// floats (zeros elsewhere; block k + 1 only where the slab starts at k),
// its rho beside the batch; then the 4 x 4 tiles of D_k's lower triangle
// into Fa and of E_k (k < T - 1) into Fb (row stride ldf), each summed
// over the batch in registers and added to the batches before.  st: R
// (2 bb + 1) floats, 16-byte aligned, the iterations' scratch (dead while
// the factor runs).  Syncs inside; ends with a barrier.
__device__ __noinline__ void x_gram_staged(const float* vr, const unsigned short* col,
                                           const int* rp, const int* loffs, const int* ent,
                                           const float* rv, int k, int T, int bb, float* st,
                                           int R, float* Fa, float* Fb, int ldf) {
  const int tid = threadIdx.x, NT = blockDim.x, lane = tid & 31, wp = tid >> 5, nw = NT >> 5;
  const int W2 = 2 * bb, tb = bb >> 2, nd = tb * (tb + 1) / 2, ne = k + 1 < T ? tb * tb : 0;
  const int e0 = loffs[k], e1 = loffs[k + 1];
  float* rs = st + R * W2;
  for (int b0 = e0, first = 1; first || b0 < e1; b0 += R, first = 0) {
    const int nb = min(R, e1 - b0);
    for (int e = tid; e < nb * W2; e += NT) st[e] = 0.f;
    __syncthreads();
    for (int q = wp; q < nb; q += nw) {  // a warp a row
      const int v = ent[b0 + q], r = v >> 1, off = (v & 1) * bb;
      for (int e = rp[r] + lane; e < rp[r + 1]; e += 32) {
        const int c = (int)col[e] - off;
        if (c >= 0 && c < W2) st[q * W2 + c] = vr[e];
      }
      if (lane == 0) rs[q] = rv[r];
    }
    __syncthreads();
    for (int t = tid; t < nd + ne; t += NT) {
      const bool erow = t >= nd;
      int tr, tc;
      if (erow) {
        tr = (t - nd) / tb;
        tc = t - nd - tr * tb;
      } else {  // lower tile t: tr (tr + 1) / 2 <= t < (tr + 1) (tr + 2) / 2
        tr = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
        while (tr * (tr + 1) / 2 > t) --tr;
        while ((tr + 1) * (tr + 2) / 2 <= t) ++tr;
        tc = t - tr * (tr + 1) / 2;
      }
      const int i0 = 4 * tr, j0 = 4 * tc;
      float acc[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = 0.f;
      for (int q = 0; q < nb; ++q) {
        const float4 a = *reinterpret_cast<const float4*>(st + q * W2 + (erow ? bb : 0) + i0);
        const float4 y4 = *reinterpret_cast<const float4*>(st + q * W2 + j0);
        const float w = rs[q];
        const float x[4] = {a.x * w, a.y * w, a.z * w, a.w * w};
        const float y[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int f = 0; f < 4; ++f) acc[c * 4 + f] = fmaf(x[c], y[f], acc[c * 4 + f]);
      }
      float* out = erow ? Fb : Fa;
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          float* o = out + (i0 + e) * ldf + j0 + f;
          *o = first ? acc[e * 4 + f] : *o + acc[e * 4 + f];
        }
    }
    __syncthreads();
  }
}

// One 4 x 4 tile of a product of the factor: acc(e, f) = sum over q in
// [q0, q1) of a(e, q) b(f, q), q0 a multiple of 4, each entry's terms in
// four sums by q mod 4 met as (s0 + s1) + (s2 + s3), the order of
// wide_thomas's sums (entries outside a triangle come as exact zeros).
template <class FA, class FB>
__device__ __forceinline__ void x_tile(float (&acc)[16], int q0, int q1, FA fa, FB fb) {
  float sm[16][4];
#pragma unroll
  for (int e = 0; e < 16; ++e)
#pragma unroll
    for (int u = 0; u < 4; ++u) sm[e][u] = 0.f;
  for (int q = q0; q < q1; q += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (q + u < q1) {
        float a[4], b[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = fa(e, q + u);
          b[e] = fb(e, q + u);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int f = 0; f < 4; ++f) sm[e * 4 + f][u] = fmaf(a[e], b[f], sm[e * 4 + f][u]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = (sm[e][0] + sm[e][1]) + (sm[e][2] + sm[e][3]);
}

// The lower 4 x 4 tile t of S_k = D_k - F_{k-1} F_{k-1}', in place of D_k
// (row stride ldl; F row stride ldf).
__device__ __noinline__ void x_tile_s(float* Dk, int ldl, const float* Fp, int ldf, int bb,
                                      int t) {
  int tr = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
  while (tr * (tr + 1) / 2 > t) --tr;
  while ((tr + 1) * (tr + 2) / 2 <= t) ++tr;
  const int i0 = 4 * tr, j0 = 4 * (t - tr * (tr + 1) / 2);
  float acc[16];
  x_tile(acc, 0, bb, [&](int e, int q) { return Fp[(i0 + e) * ldf + q]; },
         [&](int f, int q) { return Fp[(j0 + f) * ldf + q]; });
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f)
      if (j0 + f <= i0 + e) Dk[(i0 + e) * ldl + j0 + f] -= acc[e * 4 + f];
}

// Tile (i0, j0) of G_k = L_k^-1 F_{k-1} (row-major into G) or of F_k =
// E_k L_k^-T (into Fn, row stride ldf), L_k^-1 in Li (row stride ldl,
// its upper triangle dead: each sum stops at the diagonal).
__device__ __noinline__ void x_tile_gf(bool isg, const float* Li, int ldl, const float* Fp,
                                       const float* Ek, int ldf, int bb, int i0, int j0,
                                       float* G, float* Fn) {
  float acc[16];
  if (isg) {
    x_tile(acc, 0, i0 + 4, [&](int e, int q) { return q <= i0 + e ? Li[(i0 + e) * ldl + q] : 0.f; },
           [&](int f, int q) { return Fp[q * ldf + j0 + f]; });
  } else {
    x_tile(acc, 0, j0 + 4, [&](int e, int q) { return Ek[(i0 + e) * ldf + q]; },
           [&](int f, int q) { return q <= j0 + f ? Li[(j0 + f) * ldl + q] : 0.f; });
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      if (isg) G[(i0 + e) * bb + j0 + f] = acc[e * 4 + f];
      else Fn[(i0 + e) * ldf + j0 + f] = acc[e * 4 + f];
    }
}

// Tile (i0, j0) of H_k = L_k^-T F_k' (row-major into H), the sums from
// the diagonal down.
__device__ __noinline__ void x_tile_h(const float* Li, int ldl, const float* Fn, int ldf, int bb,
                                      int i0, int j0, float* H) {
  float acc[16];
  x_tile(acc, i0, bb, [&](int e, int q) { return q >= i0 + e ? Li[q * ldl + i0 + e] : 0.f; },
         [&](int f, int q) { return Fn[(j0 + f) * ldf + q]; });
#pragma unroll
  for (int e = 0; e < 4; ++e)
#pragma unroll
    for (int f = 0; f < 4; ++f) H[(i0 + e) * bb + j0 + f] = acc[e * 4 + f];
}

// The compact route's operator of one block of the cluster (the header):
// the hooks of admm_core.cuh on the context in shared memory.
struct XOp {
  mutable int seq;  // exchanges so far (the same in every thread of the cluster)

  // The next exchange's slot parity.  Exchange e writes slot e % 2 (its
  // own, for A' w's partials, which the others read after the cluster
  // barrier; every block's, for a combine); exchange e + 2 writes it again
  // only after every block has passed exchange e + 1's barrier, so after
  // every block has read it.
  __device__ int next() const { return seq++ & 1; }

  // Combines the block results v[0..K) with the other blocks', in rank
  // order; every thread of the cluster returns the same values.
  template <int K, bool MAX>
  __device__ void combine(float (&v)[K]) const {
    static_assert(K <= 8, "a combine slot holds eight values a block");
    const XCtx& c = x_ctx();
    float* s = wide_smem + c.cmb + next() * kXCmb;
    const int cs = c.cs, rank = c.rank;
    if (threadIdx.x == 0)
      for (int t = 0; t < cs; ++t) {
        float* d = wide_peer(s, t, rank, 0) + 8 * rank;
#pragma unroll
        for (int k = 0; k < K; ++k) d[k] = v[k];
      }
    cg::this_cluster().sync();
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float r = s[k];
      for (int t = 1; t < cs; ++t) r = MAX ? nan_max(r, s[8 * t + k]) : r + s[8 * t + k];
      v[k] = r;
    }
  }

  // A' w: this block's partial over its rows for every column (a thread a
  // column over the column-ordered entries, or cols_dot on the dense rows)
  // into its own slot; one cluster barrier; then epi(j, the parts summed in
  // rank order, read from each block) for all n.
  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    const XCtx& c = x_ctx();
    cg::cluster_group cl = cg::this_cluster();
    float* part = wide_smem + c.xch + next() * c.xlen;
    const int n = c.n, cs = c.cs, rank = c.rank;
    if (c.band) {
      const int* cp = reinterpret_cast<const int*>(wide_smem + c.cp);
      x_on_a(c, [&](const float* Ab) {
        const float* vc = Ab + c.nnz;
        const unsigned short* rw = reinterpret_cast<const unsigned short*>(Ab + 2 * c.nnz) + c.nnz;
        for (int j = threadIdx.x; j < n; j += blockDim.x) {
          float a0 = 0.f, a1 = 0.f;
          int e = cp[j];
          const int e1 = cp[j + 1];
          for (; e + 1 < e1; e += 2) {
            a0 = fmaf(vc[e], w[rw[e]], a0);
            a1 = fmaf(vc[e + 1], w[rw[e + 1]], a1);
          }
          if (e < e1) a0 = fmaf(vc[e], w[rw[e]], a0);
          part[j] = a0 + a1;
        }
      });
    } else {
      cols_dot<4>(c.Ad, c.lda, c.ml, n, w, [=](int j, float acc) { part[j] = acc; });
    }
    cl.sync();
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float s = (rank == 0 ? part : cl.map_shared_rank(part, 0))[j];
      for (int t = 1; t < cs; ++t) s += (rank == t ? part : cl.map_shared_rank(part, t))[j];
      epi(j, s);
    }
  }

  // A v for this block's rows: four lanes a row over its row-ordered
  // entries (or rows_dot on the dense rows).
  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    const XCtx& c = x_ctx();
    if (!c.band) {
      rows_dot<4>(c.Ad, c.lda, c.ml, c.n, v, epi);
      return;
    }
    float* av = wide_smem + c.av;
    const int ml = c.ml, bb = c.bb;
    const int* kr = reinterpret_cast<const int*>(wide_smem + c.kr);
    const int* rp = reinterpret_cast<const int*>(wide_smem + c.rp);
    x_on_a(c, [&](const float* Ab) {
      const unsigned short* col = reinterpret_cast<const unsigned short*>(Ab + 2 * c.nnz);
      const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5, nw = blockDim.x >> 5;
      const int q = lane & 3, ii = lane >> 2;
      for (int i0 = 8 * wp; i0 < ml; i0 += 8 * nw) {
        const int i = i0 + ii;
        float a0 = 0.f, a1 = 0.f;
        if (i < ml) {
          const float* vk = v + kr[i] * bb;
          int e = rp[i] + q;
          const int e1 = rp[i + 1];
          for (; e + 4 < e1; e += 8) {
            a0 = fmaf(Ab[e], vk[col[e]], a0);
            a1 = fmaf(Ab[e + 4], vk[col[e + 4]], a1);
          }
          if (e < e1) a0 = fmaf(Ab[e], vk[col[e]], a0);
        }
        float acc = a0 + a1;
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        acc += __shfl_xor_sync(0xffffffffu, acc, 2);
        if (q == 0 && i < ml) av[i] = acc;
      }
    });
    __syncthreads();
    for (int i = threadIdx.x; i < ml; i += blockDim.x) epi(i, av[i]);
  }

  // P v from the problem's band (WideOp's, pd and pe read where they are
  // given), written into every block; ends with a cluster barrier.
  __device__ void pmv(const float* v, float* out) const {
    const XCtx& c = x_ctx();
    const int bb = c.bb, T = c.T, kb = c.kb, cs = c.cs, rank = c.rank;
    const size_t b2 = (size_t)bb * bb;
    for (int r = threadIdx.x; r < (c.ke - kb) * bb; r += blockDim.x) {
      const int kl = r / bb, i = r - kl * bb, k = kb + kl, o = k * bb;
      const float* d = c.pdg + k * b2 + (size_t)i * bb;
      float acc = 0.f;
      for (int j = 0; j < bb; ++j) acc = fmaf(d[j], v[o + j], acc);
      if (k > 0) {
        const float* e = c.peg + (k - 1) * b2 + (size_t)i * bb;
        float a2 = 0.f;
        for (int j = 0; j < bb; ++j) a2 = fmaf(e[j], v[o - bb + j], a2);
        acc += a2;
      }
      if (k + 1 < T) {
        const float* e = c.peg + k * b2 + i;
        float a3 = 0.f;
        for (int j = 0; j < bb; ++j) a3 = fmaf(e[(size_t)j * bb], v[o + bb + j], a3);
        acc += a3;
      }
      x_put(out, o + i, acc, cs, rank);
    }
    cg::this_cluster().sync();
  }

  // out = M^-1 b in phases, each ended by a cluster barrier, each block
  // computing with the matrices it holds and writing what it computes into
  // the blocks that read it next: c_k = L_k^-1 b_k (all k at once; into
  // G_k's holder, c_0 = w_0 into G_1's); the forward chain w_k = c_k - G_k
  // w_{k-1}, a phase a step (into G_{k+1}'s and L_k's holders); d_k =
  // L_k^-T w_k (all k; into H_k's holder, d_{T-1} into every block);
  // x_{T-1} = d_{T-1}; the backward chain x_k = d_k - H_k x_{k+1}, a phase a
  // step (into every block).  out holds all of x in every block on return.
  __device__ void apply_minv(const float* b, float* out) const {
    const XCtx& c = x_ctx();
    cg::cluster_group cl = cg::this_cluster();
    const int bb = c.bb, T = c.T, rank = c.rank, ldl = c.ldl;
    const unsigned all = (1u << c.cs) - 1u;
    auto bit = [&](int j) { return 1u << x_blk(c, j); };
    float* tw = wide_smem + c.tw;
    for (int k = 0; k < T; ++k)
      if (x_blk(c, xj_l(T, k)) == rank)
        x_on_mat(c, xj_l(T, k), [&](const float* Li) {
          x_lower(Li, ldl, bb, b + k * bb, out + k * bb, bit(xj_g(T, k > 0 ? k : 1)), rank);
        });
    cl.sync();
    for (int k = 1; k < T; ++k) {
      if (x_blk(c, xj_g(T, k)) == rank)
        x_on_mat(c, xj_g(T, k), [&](const float* G) {
          const unsigned to = bit(xj_l(T, k)) | (k + 1 < T ? bit(xj_g(T, k + 1)) : 0u);
          x_chain_step(G, out + k * bb, out + (k - 1) * bb, out + k * bb, bb, to, rank);
        });
      cl.sync();
    }
    for (int k = 0; k < T; ++k)
      if (x_blk(c, xj_l(T, k)) == rank)
        x_on_mat(c, xj_l(T, k), [&](const float* Li) {
          x_upper(Li, ldl, bb, out + k * bb, tw + k * bb, k + 1 < T ? bit(xj_h(T, k)) : all,
                  rank);
        });
    cl.sync();
    for (int i = threadIdx.x; i < bb; i += blockDim.x) out[(T - 1) * bb + i] = tw[(T - 1) * bb + i];
    __syncthreads();
    for (int k = T - 2; k >= 0; --k) {
      if (x_blk(c, xj_h(T, k)) == rank)
        x_on_mat(c, xj_h(T, k), [&](const float* H) {
          x_chain_step(H, tw + k * bb, out + (k + 1) * bb, out + k * bb, bb, all, rank);
        });
      cl.sync();
    }
  }

  // Block-Thomas over the cluster, a column block k at a time, its runner
  // R the holder of L_k^-1, every other step shared by all blocks (a thread
  // a 4 x 4 tile or an entry, the cluster's threads in turn):
  //   every block's Gram partial (D's lower triangle, E) of its rows;
  //   D_k + pd_k + sigma I (lower) summed in rank order into L_k^-1's slot,
  //   E_k + pe_k into R's E partial;
  //   S_k = D_k - F_{k-1} F_{k-1}' in place of D_k;
  //   R alone: chol_blocked and tri_inv_inplace, L_k^-1 in the slot (its
  //   strict upper triangle dead);
  //   G_k = L_k^-1 F_{k-1} into its holder's slot (row-major) and F_k =
  //   E_k L_k^-T into the next runner's F_{k-1};
  //   H_k = L_k^-T F_k' into its holder's slot (row-major), beside the next
  //   column block's Gram partials, which touch none of its arrays.
  // Four cluster barriers a column block.  Returns the cluster-uniform fail
  // flag.
  __device__ bool factor(const float* rv) const {
    const XCtx& c = x_ctx();
    cg::cluster_group cl = cg::this_cluster();
    const int bb = c.bb, b2 = bb * bb, T = c.T, tb = bb >> 2, nt = tb * tb;
    const int cs = c.cs, rank = c.rank, ldl = c.ldl, ldf = c.ldf;
    const int first = rank * (int)blockDim.x + threadIdx.x, stride = cs * (int)blockDim.x;
    const long long wf = c.ws_floats;
    float* Pd = x_scr(c, kXPd);
    float* Pe = x_scr(c, kXPe);
    const int* loffs = reinterpret_cast<const int*>(wide_smem + c.loffs);
    const int* ent = reinterpret_cast<const int*>(wide_smem + c.ent);
    bool fail = false;
    for (int k = 0; k < T; ++k) {
      if (c.band)
        x_on_a(c, [&](const float* Ab) {
          x_gram_staged(Ab, reinterpret_cast<const unsigned short*>(Ab + 2 * c.nnz),
                        reinterpret_cast<const int*>(wide_smem + c.rp), loffs, ent, rv, k, T,
                        bb, wide_smem + c.stg, c.stg_rows, Pd, Pe, ldf);
        });
      else  // the dense route: every row, read where the problem gives it
        wide_gram_part(nullptr, 0, nullptr, nullptr, c.Ad, c.lda, c.ml, false, rv, k, T, bb, Pd,
                       Pe, ldf);
      cl.sync();
      const int jl = xj_l(T, k), R = x_blk(c, jl);
      const bool g = k > 0, h = k + 1 < T;
      float* Dk = x_mat_any(c, jl);
      float* Ek = wide_peer(Pe, R, rank, wf);
      const float* Fp = wide_peer(x_scr(c, kXFp), R, rank, wf);
      const float* pdk = c.pdg + (size_t)k * b2;
      const float* pek = c.peg + (size_t)k * b2;
      for (int e = first; e < b2; e += stride) {
        const int i = e / bb, j = e - i * bb, o = i * ldf + j;
        if (j <= i) {
          float sd = wide_peer(Pd, 0, rank, wf)[o];
          for (int t = 1; t < cs; ++t) sd += wide_peer(Pd, t, rank, wf)[o];
          Dk[i * ldl + j] = pdk[e] + (i == j ? c.sigma : 0.f) + sd;
        }
        if (h) {
          float se = wide_peer(Pe, 0, rank, wf)[o];
          for (int t = 1; t < cs; ++t) se += wide_peer(Pe, t, rank, wf)[o];
          Ek[o] = pek[e] + se;
        }
      }
      cl.sync();
      if (g)  // S_k = D_k - F_{k-1} F_{k-1}' (lower), in place
        for (int t = first; t < tb * (tb + 1) / 2; t += stride) x_tile_s(Dk, ldl, Fp, ldf, bb, t);
      cl.sync();
      if (rank == R) {
        ADMM_PHASE_END(kPhGram);
        ADMM_PHASE_BEGIN(kPhThomas);
        fail = chol_blocked<kWideQuad>(Dk, ldl, bb, wide_smem + c.sc) || fail;
        tri_inv_inplace(Dk, ldl, bb);
        ADMM_PHASE_END(kPhThomas);
        ADMM_PHASE_BEGIN(kPhGram);
      }
      cl.sync();
      // G_k = L_k^-1 F_{k-1} and F_k = E_k L_k^-T, tiles; L_k^-1's entries
      // above the diagonal are dead, so each sum stops at the diagonal
      float* Gk = g ? x_mat_any(c, xj_g(T, k)) : nullptr;
      float* Fn = h ? wide_peer(x_scr(c, kXFp), x_blk(c, jl + 1), rank, wf) : nullptr;
      for (int t = first; t < (g ? nt : 0) + (h ? nt : 0); t += stride) {
        const bool isg = g && t < nt;
        const int tt = isg || !g ? t : t - nt;
        x_tile_gf(isg, Dk, ldl, Fp, Ek, ldf, bb, 4 * (tt / tb), 4 * (tt % tb), Gk, Fn);
      }
      cl.sync();
      if (h) {  // H_k = L_k^-T F_k'
        float* Hk = x_mat_any(c, xj_h(T, k));
        for (int t = first; t < nt; t += stride)
          x_tile_h(Dk, ldl, Fn, ldf, bb, 4 * (t / tb), 4 * (t % tb), Hk);
      }
    }
    ADMM_PHASE_END(kPhGram);
    ADMM_PHASE_BEGIN(kPhThomas);
    float v[1] = {fail ? 1.f : 0.f};
    combine<1, true>(v);
    return v[0] != 0.f;
  }
};

template <int K>
__device__ __forceinline__ void op_max(const XOp& op, float (&v)[K], float* red) {
  block_max(v, red);
  op.template combine<K, true>(v);
}

template <int K>
__device__ __forceinline__ void op_sum(const XOp& op, float (&v)[K], float* red) {
  block_sum(v, red);
  op.template combine<K, false>(v);
}

__device__ __forceinline__ int op_state(const XOp& op) { return op.seq; }
__device__ __forceinline__ void op_set_state(const XOp& op, int seq) { op.seq = seq; }

__device__ __forceinline__ void op_cols(const XOp&, int, int& j0, int& j1) {
  const XCtx& c = x_ctx();
  j0 = c.kb * c.bb;
  j1 = c.ke * c.bb;
}

// K6 / K7 past internal block 128, the compact route.  Per problem (a
// cluster of the rule's size): load (the block's rows r, r + cs, ...: k_r,
// whether the row lies in its slab, its nonzeros in the slab), the route
// agreed by the cluster (band where every row fits and every block's
// nonzeros fit the nnz the layout has room for), A's row-ordered and
// column-ordered entries; the ADMM solve as qp_btd_wide_kernel's.
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
__global__ void __launch_bounds__(kWideThreads) qp_btd_xwide_kernel(
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
__global__ void __launch_bounds__(kWideThreads) qp_btd_xwide_kernel_aa(
#else
__global__ void __launch_bounds__(kWideThreads) qp_btd_xwide_kernel_aas(
#endif
    StepParams p, int bb, int batch, long long nnz, int a_first, const float* __restrict__ pdg,
    const float* __restrict__ peg, const float* __restrict__ Ag, const float* __restrict__ qg,
    const float* __restrict__ lg, const float* __restrict__ ug,
    const uint8_t* __restrict__ active, const float* __restrict__ rho_in,
    const float* __restrict__ x0, const float* __restrict__ z0, const float* __restrict__ y0,
    float* __restrict__ x_out, float* __restrict__ z_out, float* __restrict__ y_out,
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
    float* __restrict__ stats, uint8_t* __restrict__ route, float* __restrict__ ws) {
  constexpr bool AA = false;
  const AaArgs aa_args{0, nullptr};
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
    float* __restrict__ stats, uint8_t* __restrict__ route, float* __restrict__ ws,
    AaArgs aa_args) {
  constexpr bool AA = true;
#else
    float* __restrict__ stats, uint8_t* __restrict__ route, float* __restrict__ ws,
    AaArgs aa_args, AaSysArgs sys_args) {
  constexpr bool AA = true;
#endif
  float* smem = wide_smem + kWideCtxFloats;
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  cg::cluster_group cl = cg::this_cluster();
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const XLayout Lay =
      xwide_layout_as(p.n, p.m, bb, cs, nnz, a_first != 0, AA ? aa_args.sm_stride : 0);
  const int n = p.n, m = p.m, T = Lay.T, m0 = Lay.m0, W = Lay.W, xlen = Lay.xlen;
  const size_t b = blockIdx.x / cs;
  const int ml = rank < m ? (m - rank + cs - 1) / cs : 0;
  const int kb = rank * T / cs, ke = (rank + 1) * T / cs;
  const int lda = cs * n;
  const int tid = threadIdx.x, NT = blockDim.x, lane = tid & 31, wp = tid >> 5, nw = NT >> 5;

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
  float* sc = red + kRedSlots;   // kPanel + 1
  float* xch = sc + kPanel + 1;  // 2 xlen
  float* cmb = xch + 2 * xlen;   // 2 kXCmb
  int* kr = reinterpret_cast<int*>(cmb + 2 * kXCmb);
  int* loffs = kr + m0;
  int* ent = loffs + T + 1;
  int* rp = ent + 2 * m0;
  int* cp = rp + m0 + 1;
  float* arrays = wide_smem + Lay.fixed;
  float* wsb = ws ? ws + (b * cs + rank) * (size_t)Lay.ws_floats : nullptr;
  float* Ab = Lay.a_sm ? arrays + Lay.a_off : (wsb ? wsb + Lay.a_off : nullptr);
  const float* Ad = Ag + (b * m + rank) * (size_t)n;

  for (int j = tid; j < n; j += NT) {
    q[j] = qg[b * n + j];
    x[j] = x0[b * n + j];
  }
  for (int i = tid; i < ml; i += NT) {
    const size_t o = b * m + rank + (size_t)i * cs;
    z[i] = z0[o];
    y[i] = y0[o];
    l[i] = lg[o];
    u[i] = ug[o];
  }
  // a warp a row: its first and last nonzero column (a NaN counts as
  // nonzero), k_r, and its nonzeros in the slab
  bool fits = true;
  for (int i = wp; i < ml; i += nw) {
    const float* row = Ad + (size_t)i * lda;
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
    unsigned cnt = 0;
    for (int c = lane; c < W; c += 32) cnt += row[k * bb + c] != 0.f ? 1u : 0u;
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    if (lane == 0) {
      kr[i] = k;
      rp[i + 1] = (int)cnt;
    }
  }
  fits = __syncthreads_and(fits);
  // each column block's list of the rows whose slab covers it, as the
  // kernel up to 128 builds it
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
    rp[0] = 0;
    for (int i = 0; i < ml; ++i) rp[i + 1] += rp[i];
  }
  __syncthreads();
  for (int k = wp; k < T; k += nw) {
    int pos = loffs[k];
    for (int i0 = 0; i0 < ml; i0 += 32) {
      const int i = i0 + lane;
      const bool in = i < ml && (kr[i] == k || kr[i] + 1 == k);
      const unsigned bal = __ballot_sync(0xffffffffu, in);
      if (in) ent[pos + __popc(bal & ((1u << lane) - 1u))] = 2 * i + (k - kr[i]);
      pos += __popc(bal);
    }
  }
  const bool room = Ab != nullptr && rp[ml] <= Lay.nnz;
  __syncthreads();

  if (tid == 0) {
    XCtx& c = *reinterpret_cast<XCtx*>(wide_smem);
    auto at = [](const void* v) { return (int)(reinterpret_cast<const float*>(v) - wide_smem); };
    c.Ad = Ad;
    c.pdg = pdg + b * n * (size_t)bb;
    c.peg = peg + b * n * (size_t)bb;
    c.wsb = wsb;
    c.ws_floats = Lay.ws_floats;
    c.lda = lda;
    c.a_sm = Lay.a_sm ? 1 : 0;
    c.aoff = Lay.a_sm ? (int)(Lay.fixed + Lay.a_off) : (int)Lay.a_off;
    c.mat_sm = Lay.mat_sm;
    c.moff = (int)(Lay.fixed + Lay.mat_off);
    c.mws = (int)Lay.mat_ws;
    c.msz = (int)Lay.msz;
    c.nnz = (int)Lay.nnz;
    for (int s = 0; s < kXScratch; ++s)
      c.scr[s] = (Lay.scr_sm >> s & 1) ? (int)(Lay.fixed + Lay.scr_off[s]) : (int)Lay.scr_off[s];
    c.scr_sm = Lay.scr_sm;
    c.kr = at(kr);
    c.loffs = at(loffs);
    c.ent = at(ent);
    c.rp = at(rp);
    c.cp = at(cp);
    c.sc = at(sc);
    c.tw = at(tw);
    c.av = at(av);
    c.xch = at(xch);
    c.cmb = at(cmb);
    c.stg = at(bt);  // the Gram's staging: bt .. tw (6 n), dead while the factor runs
    c.stg_rows = 6 * n / (2 * bb + 1);
    c.xlen = xlen;
    c.rank = rank;
    c.cs = cs;
    c.n = n;
    c.ml = ml;
    c.T = T;
    c.bb = bb;
    c.ldl = Lay.ldl;
    c.ldf = Lay.ldf;
    c.kb = kb;
    c.ke = ke;
    c.sigma = p.sigma;
    c.band = 0;
  }
  __syncthreads();
  const XOp op{0};
  bool band;
  {  // the route, agreed by the cluster
    float v[1] = {fits && room ? 0.f : 1.f};
    op.combine<1, true>(v);
    band = v[0] == 0.f;
    if (tid == 0) reinterpret_cast<XCtx*>(wide_smem)->band = band ? 1 : 0;
  }
  if (band) {
    // the row-ordered entries (a warp a row, in column order), then the
    // column-ordered ones (a thread a column, over its column block's list
    // in row order)
    const int cap = (int)Lay.nnz;
    float* vr = Ab;
    float* vc = Ab + cap;
    unsigned short* col = reinterpret_cast<unsigned short*>(Ab + 2 * cap);
    unsigned short* rw = col + cap;
    for (int i = wp; i < ml; i += nw) {
      const float* row = Ad + (size_t)i * lda + kr[i] * bb;
      int pos = rp[i];
      for (int c0 = 0; c0 < W; c0 += 32) {
        const int c = c0 + lane;
        const float a = c < W ? row[c] : 0.f;
        const bool nz = c < W && a != 0.f;
        const unsigned bal = __ballot_sync(0xffffffffu, nz);
        if (nz) {
          const int at = pos + __popc(bal & ((1u << lane) - 1u));
          vr[at] = a;
          col[at] = (unsigned short)c;
        }
        pos += __popc(bal);
      }
    }
    for (int j = tid; j < n; j += NT) {
      const int k = j / bb;
      int cnt = 0;
      for (int e = loffs[k]; e < loffs[k + 1]; ++e)
        cnt += Ad[(size_t)(ent[e] >> 1) * lda + j] != 0.f ? 1 : 0;
      cp[j + 1] = cnt;
    }
    __syncthreads();
    if (tid == 0) {
      cp[0] = 0;
      for (int j = 0; j < n; ++j) cp[j + 1] += cp[j];
    }
    __syncthreads();
    for (int j = tid; j < n; j += NT) {
      const int k = j / bb;
      int pos = cp[j];
      for (int e = loffs[k]; e < loffs[k + 1]; ++e) {
        const int r = ent[e] >> 1;
        const float a = Ad[(size_t)r * lda + j];
        if (a != 0.f) {
          vc[pos] = a;
          rw[pos] = (unsigned short)r;
          ++pos;
        }
      }
    }
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

  StepParams pl = p;
  pl.m = ml;  // the ADMM core sees this block's rows
  ADMM_PHASE_END(kPhLoad);
  if constexpr (AA) {
    const AaState aa = aa_state(aa_args, wide_smem, 0, blockIdx.x, n, m0);
#ifdef QP_KERNEL_BTD_WIDE_AAS_UNIT
    admm_solve<XOp, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                        aa.ring, aa.k, aa.gram, aa_sys(sys_args, aa.k, wide_smem, 0, blockIdx.x));
#else
    admm_solve<XOp, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st,
                        aa.ring, aa.k, aa.gram);
#endif
  } else {
    admm_solve<XOp, AA>(pl, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st);
  }

  ADMM_PHASE_END(kPhTotal);
  if (rank == 0)
    for (int j = tid; j < n; j += NT) x_out[b * n + j] = x[j];
  for (int i = tid; i < ml; i += NT) {
    const size_t o = b * m + rank + (size_t)i * cs;
    z_out[o] = z[i];
    y_out[o] = y[i];
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
    route[b] = band ? 1 : 0;
  }
  // no block leaves before the others are past the last access into it
  cl.sync();
}

// Where an Anderson launch of memory k (0: none) keeps its Gram area and
// the chunk's system, both routes.  Up to kAaGramSmemMemory the Gram area
// (Gk and the system) in shared memory at the end of the fixed part (the
// layout's reserve); past it the system leaves the Gram area for a solve
// area by columns that the whole block solves (aa_solve_sys, the
// qp_kernel_btd_wide_aas.cu kernels), and each area is reserved in shared
// memory only where the layout with it keeps in shared memory every array
// that the layout without it keeps there and as many blocks an SM as
// shared memory allows that one (keeps(reserve)): Gk's Gram area and a
// solve area both where the two together do, else the solve area alone
// (Gk at the head of the block's Anderson workspace slice), else the
// system to the workspace and the Gram area on chip where it alone does.
// The ring stays in the workspace (the arrays an iteration reads take
// shared memory first).  Decided by forcing every placement on an H100 (as
// qp_kernel_btd.cu:btd_aa_plan's, with the same -DAA_FORCE_SOLVE and
// -DAA_FORCE_GRAM; PERF.md section 6).
#ifndef AA_FORCE_SOLVE
#define AA_FORCE_SOLVE -1
#endif
#ifndef AA_FORCE_GRAM
#define AA_FORCE_GRAM 1
#endif
struct WideAaPlan {
  bool gram;             // the Gram area (Gk) in shared memory
  int solve;             // AaSolve: kAaSolveGram, kAaSolveScope or kAaSolveWorkspace
  long long reserve;     // floats at the end of the fixed part: the Gram area, the solve area
  long long sys_floats;  // the solve area's, with its head
};

template <class Keeps>
WideAaPlan wide_aa_plan(int k, Keeps keeps) {
  WideAaPlan P{true, kAaSolveGram, 0, 0};
  if (k <= 0) return P;
  const long long g = aa_gram_floats(k), s = kAaSolveHead + aa_solve_floats(k);
  if (k <= kAaGramSmemMemory) {
    P.gram = true;
  } else if (AA_FORCE_SOLVE >= 0) {
    P.solve = AA_FORCE_SOLVE;
    P.gram = P.solve == kAaSolveGram || AA_FORCE_GRAM == 1;
  } else {
    const bool both = keeps(g + s), sys = both || keeps(s);
    P.gram = both || (!sys && keeps(g));
    P.solve = sys ? kAaSolveScope : kAaSolveWorkspace;
  }
  P.sys_floats = P.solve == kAaSolveScope ? s : 0;
  P.reserve = (P.gram ? g : 0) + P.sys_floats;
  return P;
}

// The band route's plan (cs blocks a problem).
WideAaPlan wide_aa_plan_band(int n, int m, int bb, int cs, int k) {
  const WideLayout L = wide_layout(n, m, bb, cs);
  return wide_aa_plan(k, [&](long long reserve) {
    const WideLayout Lr = wide_layout(n, m, bb, cs, reserve);
    return Lr.ok && Lr.smem == L.smem &&
           smem_blocks_per_sm(Lr.smem_bytes) >= smem_blocks_per_sm(L.smem_bytes);
  });
}

// A launch's AaArgs (aa: k and the workspace) and AaSysArgs by the plan P
// and its layout's fixed part: the Gram area at the start of the reserve,
// the solve area at its end, after its head; the chunk systems of
// kAaSolveWorkspace after the batch x cs slices of aa.ws.
AaSysArgs wide_aa_args(const WideAaPlan& P, long long fixed, AaArgs& aa, int batch, int cs,
                       int n, int m0) {
  aa.sm_off = fixed - P.reserve;
  aa.sm_stride = (int)P.reserve;  // the kernels' layouts take it as their reserve
  aa.ring_sm = 0;
  aa.gram_ws = P.gram ? 0 : 1;
  if (aa.ws == nullptr) return AaSysArgs{};
  const size_t slices = (size_t)batch * cs * aa_floats(aa.k, n, m0);
  return AaSysArgs{P.solve, fixed - P.sys_floats + kAaSolveHead, 0,
                   aa.ws + ((slices + 3) & ~(size_t)3)};
}

// A shape the wide kernel takes: bb a multiple of 8 dividing n (its layout
// may still refuse it, where the fixed part does not fit).
bool wide_shape(int n, int m, int bb) {
  return bb >= 8 && bb % 8 == 0 && n > 0 && m > 0 && n % bb == 0;
}

// The launch of this unit's kernel on a checked shape (wide_shape), the
// workspace given where the layout needs one; with Anderson (aa.ws), its
// areas where wide_aa_plan_band puts them: this unit's launches are those
// whose system is (qp_kernel_btd_wide_aa.cu) or is not
// (qp_kernel_btd_wide_aas.cu) in the Gram area.
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
  const WideAaPlan P = wide_aa_plan_band(n, m, bb, cs, aa.ws ? aa.k : 0);
  const WideLayout L = wide_layout(n, m, bb, cs, P.reserve);
  if (!L.ok || (L.ws_floats > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  const AaSysArgs sys = wide_aa_args(P, L.fixed, aa, batch, cs, n, L.m0);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
  auto kernel = qp_btd_wide_kernel;
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
  if (P.solve != kAaSolveGram) return cudaErrorInvalidValue;
  auto kernel = qp_btd_wide_kernel_aa;
#else
  if (P.solve == kAaSolveGram) return cudaErrorInvalidValue;
  auto kernel = qp_btd_wide_kernel_aas;
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
  (void)sys;
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                           z0, y0, x_out, z_out, y_out, stats, route, ws);
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
  (void)sys;
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                           z0, y0, x_out, z_out, y_out, stats, route, ws, aa);
#else
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, pd, pe, A, q, l, u, active, rho_in, x0,
                           z0, y0, x_out, z_out, y_out, stats, route, ws, aa, sys);
#endif
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The compact route's layout of a launch: the rule's cluster and order,
// with the Anderson areas of memory k (0: none) where wide_aa_plan puts
// them in that cluster and order (P).
XLayout xwide_launch_layout(int n, int m, int bb, const long long* nnz, int k, WideAaPlan& P) {
  const XLayout L0 = xwide_rule(n, m, bb, nnz);
  P = wide_aa_plan(k, [&](long long reserve) {
    if (!L0.ok) return false;
    const XLayout Lr = xwide_layout_as(n, m, bb, L0.cs, L0.nnz, L0.a_first, reserve);
    return Lr.ok && Lr.a_sm == L0.a_sm && Lr.mat_sm == L0.mat_sm && Lr.scr_sm == L0.scr_sm &&
           smem_blocks_per_sm(Lr.smem_bytes) >= smem_blocks_per_sm(L0.smem_bytes);
  });
  if (P.reserve == 0) return L0;
  return xwide_layout_as(n, m, bb, L0.cs, L0.nnz, L0.a_first, P.reserve);
}

// The launch of this unit's compact-route kernel (internal blocks past
// kWideCompactAbove) on a checked shape, in the rule's cluster for the
// entries a block holds (nnz; null: the band rows' full count); with
// Anderson as launch_wide's.
cudaError_t launch_xwide(int n, int m, int bb, float sigma, float alpha, float rho0,
                         float eps_abs, float eps_rel, int n_epochs, int chunks_per_epoch,
                         int seg, int adaptive_rho, float adaptive_rho_tolerance,
                         int check_infeas, float eps_pinf, float eps_dinf, int batch,
                         const float* pd, const float* pe, const float* A, const float* q,
                         const float* l, const float* u, const uint8_t* active,
                         const float* rho_in, const float* x0, const float* z0, const float* y0,
                         float* x_out, float* z_out, float* y_out, float* stats, uint8_t* route,
                         float* ws, int device, void* stream, AaArgs aa, const long long* nnz) {
  if (!wide_shape(n, m, bb)) return cudaErrorInvalidValue;
  WideAaPlan P;
  const XLayout L = xwide_launch_layout(n, m, bb, nnz, aa.ws ? aa.k : 0, P);
  if (!L.ok || (L.ws_floats > 0 && ws == nullptr)) return cudaErrorInvalidValue;
  const int cs = L.cs;
  const AaSysArgs sys = wide_aa_args(P, L.fixed, aa, batch, cs, n, L.m0);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
  auto kernel = qp_btd_xwide_kernel;
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
  if (P.solve != kAaSolveGram) return cudaErrorInvalidValue;
  auto kernel = qp_btd_xwide_kernel_aa;
#else
  if (P.solve == kAaSolveGram) return cudaErrorInvalidValue;
  auto kernel = qp_btd_xwide_kernel_aas;
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
  const long long room = L.nnz;
  const int a_first = L.a_first ? 1 : 0;
#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
  (void)aa;
  (void)sys;
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, room, a_first, pd, pe, A, q, l, u, active,
                           rho_in, x0, z0, y0, x_out, z_out, y_out, stats, route, ws);
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
  (void)sys;
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, room, a_first, pd, pe, A, q, l, u, active,
                           rho_in, x0, z0, y0, x_out, z_out, y_out, stats, route, ws, aa);
#else
  err = cudaLaunchKernelEx(&cfg, kernel, p, bb, batch, room, a_first, pd, pe, A, q, l, u, active,
                           rho_in, x0, z0, y0, x_out, z_out, y_out, stats, route, ws, aa, sys);
#endif
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan of an Anderson launch of memory k at this shape, on the route
// the internal block takes (nnz as launch_xwide's).
WideAaPlan wide_launch_plan(int n, int m, int bb, const long long* nnz, int k) {
  if (bb <= kWideCompactAbove) return wide_aa_plan_band(n, m, bb, kWideCluster, k);
  WideAaPlan P;
  xwide_launch_layout(n, m, bb, nnz, k, P);
  return P;
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
// the C entries' own order
#define QP_BTD_WIDE_ENTRY_CALL                                                                \
  pd, pe, A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out, stats, batch, n, m, bb, \
      sigma, alpha, rho0, eps_abs, eps_rel, n_epochs, chunks_per_epoch, seg, adaptive_rho,    \
      adaptive_rho_tolerance, check_infeas, eps_pinf, eps_dinf, device, stream, ws, route

#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
namespace {

// The band route's report (qp_btd_wide_layout_nnz's first eleven values)
// into out[11]; 0, or -1 where the fixed part does not fit.
int wide_report(const WideLayout& L, long long* out) {
  const long long v[11] = {L.cs, L.smem_bytes, L.ws_floats, (long long)L.smem, L.iter_bytes,
                           L.T,  L.R,          L.m0,        L.W,               L.lds,
                           L.fixed};
  for (int i = 0; i < 11; ++i) out[i] = v[i];
  return L.ok ? 0 : -1;
}

// The compact route's report into out[16]: the blocks a problem,
// shared-memory bytes, workspace floats, the mask of the arrays in shared
// memory (bit 0 A, bits 1-3 F_{k-1}, the D and E partials), the bytes an
// iteration reads from device memory a problem, T, the matrix slots a
// block, rows a block, the band row's width, A's entries a block has room
// for, the fixed part's floats, the Anderson Gram area in shared memory
// (1) or not, the route (1: compact), the slots in shared memory, A first
// (1) or after the slots, and the matrices of the sweeps.  0, or -1 where
// the shape is refused.
int x_report(const XLayout& L, bool gram_sm, long long* out) {
  const long long mask = (L.a_sm ? 1 : 0) | (long long)L.scr_sm << 1;
  const long long v[16] = {L.cs,  L.smem_bytes, L.ws_floats, mask,          L.iter_bytes, L.T,
                           L.nslot, L.m0,       L.W,         L.nnz,         L.fixed,
                           gram_sm ? 1 : 0,     1,           L.mat_sm,      L.a_first ? 1 : 0,
                           L.nmat};
  for (int i = 0; i < 16; ++i) out[i] = v[i];
  return L.ok ? 0 : -1;
}

}  // namespace
#endif

extern "C" {

#ifndef QP_KERNEL_BTD_WIDE_AA_UNIT
// The layout of one block of a launch at this shape, with Anderson of
// memory aa_mem > 0 (0: none), into out[18].  Up to kWideCompactAbove the
// band route's: the blocks a problem, shared-memory bytes, workspace
// floats, the mask of the arrays in shared memory (bit a of L^-1, the
// couplings G', H', A's band rows, S, F_{k-1}, F_k, pd, pe), the bytes an
// iteration reads from device memory a problem, T, column blocks a block
// (at most), rows a block, the band row's width and stride, the fixed
// part's floats, the Anderson Gram area in shared memory (1: the fixed
// part ends with it, so that the workspace floats may be more) or at the
// head of the Anderson workspace slice (0), and the route 0.  Past it the
// compact route's (x_report), for the entries a block of the problems
// holds at clusters of 2, 4 and 8 (nnz: xwide_rule's kXNnzArgs values;
// null: the band rows' full count).  Both routes then where the chunk's
// system goes (AaSolve) and the floats of the block's solve area in shared
// memory (wide_aa_plan).  Returns 0, or -1 where the shape is refused.
int qp_btd_wide_layout_nnz(int n, int m, int bb, int aa_mem, const long long* nnz,
                           long long* out) {
  if (!wide_shape(n, m, bb) || aa_mem < 0) return -1;
  for (int i = 0; i < 18; ++i) out[i] = 0;
  WideAaPlan P;
  int rc;
  if (bb > kWideCompactAbove) {
    const XLayout L = xwide_launch_layout(n, m, bb, nnz, aa_mem, P);  // P first
    rc = x_report(L, P.gram, out);
  } else {
    P = wide_aa_plan_band(n, m, bb, kWideCluster, aa_mem);
    out[11] = P.gram ? 1 : 0;
    rc = wide_report(wide_layout(n, m, bb, kWideCluster, P.reserve), out);
  }
  out[16] = P.solve;
  out[17] = P.sys_floats;
  return rc;
}

// The layout of one block at this shape with `reserve` floats at the end
// of the fixed part, as an Anderson launch reserves its areas (the layouts
// whose arrays and blocks an SM wide_aa_plan compares), in the rule's
// cluster and order for nnz (as qp_btd_wide_layout_nnz's), into out[18] as
// that reports it without Anderson.  Returns 0, or -1 where the shape is
// refused.
int qp_btd_wide_layout_reserve(int n, int m, int bb, long long reserve, const long long* nnz,
                               long long* out) {
  if (!wide_shape(n, m, bb) || reserve < 0) return -1;
  for (int i = 0; i < 18; ++i) out[i] = 0;
  if (bb > kWideCompactAbove) {
    const XLayout L0 = xwide_rule(n, m, bb, nnz);
    if (!L0.ok || reserve == 0) return x_report(L0, true, out);
    return x_report(xwide_layout_as(n, m, bb, L0.cs, L0.nnz, L0.a_first, reserve), true, out);
  }
  out[11] = 1;
  return wide_report(wide_layout(n, m, bb, kWideCluster, reserve), out);
}

// One launch of the wide kernel: the arguments of qp_btd_launch, the
// workspace (batch x the layout's blocks x its workspace floats), the
// route (B,) and, past kWideCompactAbove, the entries a block of the
// problems holds (nnz, as qp_btd_wide_layout_nnz takes them; ignored up to
// it).
int qp_btd_wide_launch_nnz(QP_BTD_WIDE_ARGS, const long long* nnz) {
  if (batch <= 0) return 0;
  if (bb > kWideCompactAbove)
    return (int)launch_xwide(QP_BTD_WIDE_CALL, AaArgs{0, nullptr}, nnz);
  return (int)launch_wide(QP_BTD_WIDE_CALL, AaArgs{0, nullptr});
}
#elif !defined(QP_KERNEL_BTD_WIDE_AAS_UNIT)
// qp_kernel_btd_wide_aas.cu's entry, which takes the launches whose chunk
// system is off the Gram area (null in a library built without that unit:
// such a launch is refused).
__attribute__((weak)) int qp_btd_wide_launch_aas_nnz(QP_BTD_WIDE_ARGS, int aa_mem, float* aa_ws,
                                                     const long long* nnz);

// qp_btd_wide_launch_nnz with Anderson acceleration of any memory aa_mem >
// 0: its Gram area in shared memory (the layout's reserve; ws then holds
// qp_btd_wide_layout_nnz's workspace floats a block for aa_mem) or in
// aa_ws, and its ring in aa_ws: one slice of admm_aa_floats(aa_mem, n,
// ceil(m / cs)) floats a block, batch x cs of them (cs the layout's blocks
// a problem).  A launch whose chunk system wide_aa_plan puts off the Gram
// area runs qp_kernel_btd_wide_aas.cu's kernels.
int qp_btd_wide_launch_aa_nnz(QP_BTD_WIDE_ARGS, int aa_mem, float* aa_ws,
                              const long long* nnz) {
  if (batch <= 0) return 0;
  if (aa_mem <= 0 || aa_ws == nullptr) return (int)cudaErrorInvalidValue;
  if (!wide_shape(n, m, bb)) return (int)cudaErrorInvalidValue;
  if (wide_launch_plan(n, m, bb, nnz, aa_mem).solve != kAaSolveGram)
    return qp_btd_wide_launch_aas_nnz
               ? qp_btd_wide_launch_aas_nnz(QP_BTD_WIDE_ENTRY_CALL, aa_mem, aa_ws, nnz)
               : (int)cudaErrorInvalidDeviceFunction;
  if (bb > kWideCompactAbove)
    return (int)launch_xwide(QP_BTD_WIDE_CALL, AaArgs{aa_mem, aa_ws}, nnz);
  return (int)launch_wide(QP_BTD_WIDE_CALL, AaArgs{aa_mem, aa_ws});
}
#else
// qp_btd_wide_launch_aa_nnz's launches whose chunk system wide_aa_plan puts
// off the Gram area.
int qp_btd_wide_launch_aas_nnz(QP_BTD_WIDE_ARGS, int aa_mem, float* aa_ws,
                               const long long* nnz) {
  if (batch <= 0) return 0;
  if (aa_mem <= 0 || aa_ws == nullptr) return (int)cudaErrorInvalidValue;
  if (bb > kWideCompactAbove)
    return (int)launch_xwide(QP_BTD_WIDE_CALL, AaArgs{aa_mem, aa_ws}, nnz);
  return (int)launch_wide(QP_BTD_WIDE_CALL, AaArgs{aa_mem, aa_ws});
}
#endif

}  // extern "C"
