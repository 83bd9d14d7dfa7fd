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
// Design.  One thread block per problem, batch-first operands, the ADMM
// core of admm_core.cuh (rho epochs, chunks with per-problem early exit,
// adaptive rho adopted at factor time, certificates) run with BandOp, the
// structured hooks of the JAX core:
//   factor      the Gram band (A' rho A)_{k,k} and _{k+1,k} from A's
//               columns (one thread per band entry; the n x n Schur matrix
//               is never formed), then block-Thomas: S_k = D_k -
//               F_{k-1} F_{k-1}', L_k = chol(S_k) (cholesky_inplace, pivot
//               clamp max(d, 1e-30), fail = d <= 0 | NaN), L_k^-1 (tri_inv),
//               F_k = E_k L_k^-T, F_{T-1} = 0;
//   apply_minv  the forward and backward block sweeps, by warp 0 alone with
//               __syncwarp() between blocks (T dependent steps of bb x bb
//               work each);
//   pmv         P v from the band of P only (one thread per row);
//   amv, atmv   A dense.
// Problems that enter inactive (K7's `active`) skip the solve and pass
// their warm start through; every branch that guards a barrier is
// block-uniform.
//
// What bounds it on this card.  The band factor is O(m n bb) for the Gram
// band and O(T bb^3) for Thomas; each ADMM iteration is two dense matvecs
// with A (4 m n flops) and the sweeps (4 n bb flops in 2 T dependent
// steps).  At n = 192, m = 320 the operations bound is far below the
// latency of the 2 T dependent sweep steps and the barrier-separated
// phases of one block per problem.  Memory: the band (pd, pe, L_k^-1, F_k:
// 4 n bb floats) and the vectors live in shared memory, with as many
// leading rows of A (row stride n + 1) as fit in the 227 KB a block may
// use; the remaining rows are read from the input in device memory with
// coalesced loads (one thread per column in A' w, one warp per row in
// A v), unrolled so that several loads are in flight per thread (with
// one block per SM nothing else hides their latency).  At n = 128, m = 224 all of A fits; at n = 192, m = 320 about 250
// of the 320 rows do.

#include "admm_core.cuh"

namespace {

// The structured operator: A's first rs rows in shared memory (stride ld),
// the rest in device memory (Ag, stride n, row rs first); the band of P
// (pd, pe) and the factor (Li, F), each T blocks of bb x bb (stride bb),
// in shared memory; S, S2 (bb x bb scratch) and tb (bb) for the factor
// and the sweeps.  BB > 0 fixes the block size at compile time (the
// instantiations for 8 and 16 unroll the bb-long loops of the sweeps, the
// band matvec and the Thomas products); BB = 0 reads it from bb_rt.
template <int BB>
struct BandOp {
  const float* As;
  const float* Ag;
  int ld, rs;
  const float* pd;
  const float* pe;
  float* Li;
  float* F;
  float* S;
  float* S2;
  float* tb;
  int n, m, bb_rt, T;
  float sigma;

  __device__ __forceinline__ int block() const { return BB > 0 ? BB : bb_rt; }

  template <class Epi>
  __device__ void atmv(const float* w, Epi epi) const {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      float acc = 0.f;
      for (int i = 0; i < rs; ++i) acc = fmaf(As[(size_t)i * ld + j], w[i], acc);
#pragma unroll 8
      for (int i = rs; i < m; ++i) acc = fmaf(Ag[(size_t)(i - rs) * n + j], w[i], acc);
      epi(j, acc);
    }
  }

  template <class Epi>
  __device__ void amv(const float* v, Epi epi) const {
    for (int i = threadIdx.x; i < rs; i += blockDim.x) {
      const float* r = As + (size_t)i * ld;
      float acc = 0.f;
      for (int j = 0; j < n; ++j) acc = fmaf(r[j], v[j], acc);
      epi(i, acc);
    }
    // rows in device memory: one warp per row, coalesced, shuffle-reduced
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    for (int i = rs + w; i < m; i += nw) {
      const float* r = Ag + (size_t)(i - rs) * n;
      float acc = 0.f;
#pragma unroll 4
      for (int j = lane; j < n; j += 32) acc = fmaf(r[j], v[j], acc);
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (lane == 0) epi(i, acc);
    }
  }

  // (P v)_k = P_{k,k} v_k + P_{k,k-1} v_{k-1} + P_{k+1,k}' v_{k+1}
  __device__ void pmv(const float* v, float* out) const {
    const int bb = block(), nb2 = bb * bb;
    for (int r = threadIdx.x; r < n; r += blockDim.x) {
      const int k = r / bb, i = r - k * bb, o = k * bb;
      const float* d = pd + (size_t)k * nb2 + i * bb;
      float acc = 0.f;
      #pragma unroll
      for (int j = 0; j < bb; ++j) acc = fmaf(d[j], v[o + j], acc);
      if (k > 0) {
        const float* e = pe + (size_t)(k - 1) * nb2 + i * bb;
        float a2 = 0.f;
        #pragma unroll
        for (int j = 0; j < bb; ++j) a2 = fmaf(e[j], v[o - bb + j], a2);
        acc += a2;
      }
      if (k + 1 < T) {
        const float* e = pe + (size_t)k * nb2 + i;
        float a3 = 0.f;
        #pragma unroll
        for (int j = 0; j < bb; ++j) a3 = fmaf(e[j * bb], v[o + bb + j], a3);
        acc += a3;
      }
      out[r] = acc;
    }
  }

  // out = M^-1 b: L w = b forward (w_k = L_k^-1 (b_k - F_{k-1} w_{k-1})),
  // L' x = w backward (x_k = L_k^-T (w_k - F_k' x_{k+1})), w in place in
  // out.  Warp 0 alone; the caller's barrier follows.
  __device__ void apply_minv(const float* b, float* out) const {
    if (threadIdx.x >= 32) return;
    const int bb = block(), lane = threadIdx.x, nb2 = bb * bb;
    for (int k = 0; k < T; ++k) {
      const int o = k * bb;
      const float* Lk = Li + (size_t)k * nb2;
      for (int i = lane; i < bb; i += 32) {
        float t = b[o + i];
        if (k > 0) {
          const float* Fp = F + (size_t)(k - 1) * nb2;
          float acc = 0.f;
          #pragma unroll
          for (int j = 0; j < bb; ++j) acc = fmaf(Fp[i * bb + j], out[o - bb + j], acc);
          t -= acc;
        }
        tb[i] = t;
      }
      __syncwarp();
      for (int i = lane; i < bb; i += 32) {
        float acc = 0.f;
        #pragma unroll
        for (int j = 0; j < bb; ++j)
          if (j <= i) acc = fmaf(Lk[i * bb + j], tb[j], acc);
        out[o + i] = acc;
      }
      __syncwarp();
    }
    for (int k = T - 1; k >= 0; --k) {
      const int o = k * bb;
      const float* Fk = F + (size_t)k * nb2;
      const float* Lk = Li + (size_t)k * nb2;
      for (int i = lane; i < bb; i += 32) {
        float t = out[o + i];
        if (k + 1 < T) {
          float acc = 0.f;
          #pragma unroll
          for (int j = 0; j < bb; ++j) acc = fmaf(Fk[j * bb + i], out[o + bb + j], acc);
          t -= acc;
        }
        tb[i] = t;
      }
      __syncwarp();
      for (int i = lane; i < bb; i += 32) {
        float acc = 0.f;
        #pragma unroll
        for (int j = 0; j < bb; ++j)
          if (j >= i) acc = fmaf(Lk[j * bb + i], tb[j], acc);
        out[o + i] = acc;
      }
      __syncwarp();
    }
  }

  // Gram band and block-Thomas factor into Li, F.  Block-uniform fail.
  __device__ bool factor(const float* rv) const {
    const int bb = block(), nb2 = bb * bb, tot = T * nb2;
    // D_k (into Li) and E_k (into F), one thread per band entry
    for (int e = threadIdx.x; e < 2 * tot; e += blockDim.x) {
      const bool lower = e >= tot;
      const int rem = lower ? e - tot : e;
      const int k = rem / nb2, ij = rem - k * nb2, i = ij / bb, j = ij - i * bb;
      if (lower && k + 1 == T) {
        F[rem] = pe[rem];
        continue;
      }
      const int ca = (lower ? k + 1 : k) * bb + i, cb = k * bb + j;
      float acc = 0.f;
      for (int r = 0; r < rs; ++r) {
        const float* a = As + (size_t)r * ld;
        acc = fmaf(a[ca] * rv[r], a[cb], acc);
      }
#pragma unroll 8
      for (int r = rs; r < m; ++r) {
        const float* a = Ag + (size_t)(r - rs) * n;
        acc = fmaf(a[ca] * rv[r], a[cb], acc);
      }
      if (lower) F[rem] = pe[rem] + acc;
      else Li[rem] = pd[rem] + (i == j ? sigma : 0.f) + acc;
    }
    __syncthreads();
    bool fail = false;
    const int lds = bb + 1;
    for (int k = 0; k < T; ++k) {
      float* Lk = Li + (size_t)k * nb2;
      float* Fk = F + (size_t)k * nb2;
      for (int e = threadIdx.x; e < nb2; e += blockDim.x) {
        const int i = e / bb, j = e - i * bb;
        float s = Lk[e];
        if (k > 0) {
          const float* Fp = Fk - nb2;
          float acc = 0.f;
          #pragma unroll
          for (int l = 0; l < bb; ++l) acc = fmaf(Fp[i * bb + l], Fp[j * bb + l], acc);
          s -= acc;
        }
        S[i * lds + j] = s;
      }
      __syncthreads();
      fail = cholesky_inplace(S, lds, bb) || fail;
      tri_inv(S, lds, Lk, bb, bb);  // L_k^-1 replaces D_k
      for (int e = threadIdx.x; e < nb2; e += blockDim.x) {
        const int i = e / bb, j = e - i * bb;
        float acc = 0.f;
        #pragma unroll
        for (int l = 0; l < bb; ++l)
          if (l <= j) acc = fmaf(Fk[i * bb + l], Lk[j * bb + l], acc);
        S2[e] = acc;  // (E_k L_k^-T)_{ij}
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nb2; e += blockDim.x) Fk[e] = S2[e];
      __syncthreads();
    }
    return fail;
  }
};

// K6 / K7.  Per problem: load the band, the vectors and the leading rows of
// A; rho = rho0 + 0 q_0 (a NaN in q reaches the fail flag through the
// factor), replaced where rho_in > 0 by the same arithmetic select as the
// TPU kernel; the ADMM solve entered with a pending rho, so the first
// epoch factors.  Output x, z, y and stats (9, B): done, iter, res_prim,
// res_dual, fail, rho_updates, rho_estimate, infs, rho of the final factor.
template <int BB>
__global__ void __launch_bounds__(256) qp_btd_kernel(
    StepParams p, int bb, int rs, const float* __restrict__ pdg, const float* __restrict__ peg,
    const float* __restrict__ Ag, const float* __restrict__ qg, const float* __restrict__ lg,
    const float* __restrict__ ug, const uint8_t* __restrict__ active,
    const float* __restrict__ rho_in, const float* __restrict__ x0,
    const float* __restrict__ z0, const float* __restrict__ y0, float* __restrict__ x_out,
    float* __restrict__ z_out, float* __restrict__ y_out, float* __restrict__ stats) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, ld = n + 1, T = n / bb, nband = n * bb;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, NT = blockDim.x;

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
  float* pd = red + kRedSlots;
  float* pe = pd + nband;
  float* Li = pe + nband;
  float* F = Li + nband;
  float* S = F + nband;          // bb (bb + 1)
  float* S2 = S + bb * (bb + 1);  // bb bb
  float* tb = S2 + bb * bb;      // bb
  float* As = tb + bb;           // rs rows of stride ld
  const float* Ab = Ag + b * (size_t)m * n;

  for (int j = tid; j < n; j += NT) {
    q[j] = qg[b * n + j];
    x[j] = x0[b * n + j];
  }
  for (int i = tid; i < m; i += NT) {
    z[i] = z0[b * m + i];
    y[i] = y0[b * m + i];
    l[i] = lg[b * m + i];
    u[i] = ug[b * m + i];
  }
  for (int e = tid; e < nband; e += NT) {
    pd[e] = pdg[b * nband + e];
    pe[e] = peg[b * nband + e];
  }
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

  const BandOp<BB> op{As, Ab + (size_t)rs * n, ld, rs, pd, pe, Li, F, S, S2, tb, n, m, bb, T,
                      p.sigma};
  admm_solve(p, op, q, l, u, rv, x, z, y, bt, xt, tm, tn1, tn2, xp, yp, red, st);

  for (int j = tid; j < n; j += NT) x_out[b * n + j] = x[j];
  for (int i = tid; i < m; i += NT) {
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
    stats[7 * B + b] = (float)st.infs;
    stats[8 * B + b] = st.rho;
  }
}

// Shared-memory floats before A's rows: 7 n + 7 m vectors, the reduction
// slots, the four band arrays and the factor/sweep scratch.
long long btd_fixed_floats(int n, int m, int bb) {
  return 7LL * n + 7LL * m + kRedSlots + 4LL * n * bb + 2LL * bb * bb + 2LL * bb;
}

// Rows of A kept in shared memory (-1 where not even the rest fits).
int btd_rows_smem(int n, int m, int bb) {
  const long long spare = (long long)kMaxSmemBytes / 4 - btd_fixed_floats(n, m, bb);
  if (spare < 0) return -1;
  const long long rows = spare / (n + 1);
  return (int)(rows < m ? rows : m);
}

}  // namespace

extern "C" {

int qp_btd_smem_rows(int n, int m, int bb) { return btd_rows_smem(n, m, bb); }

int qp_btd_launch(const float* pd, const float* pe, const float* A, const float* q,
                  const float* l, const float* u, const uint8_t* active, const float* rho_in,
                  const float* x0, const float* z0, const float* y0, float* x_out, float* z_out,
                  float* y_out, float* stats, int batch, int n, int m, int bb, float sigma,
                  float alpha, float rho0, float eps_abs, float eps_rel, int n_epochs,
                  int chunks_per_epoch, int seg, int adaptive_rho, float adaptive_rho_tolerance,
                  int check_infeas, float eps_pinf, float eps_dinf, int device, void* stream) {
  if (batch <= 0) return 0;
  if (bb <= 0 || n % bb != 0) return (int)cudaErrorInvalidValue;
  const int rs = btd_rows_smem(n, m, bb);
  if (rs < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(btd_fixed_floats(n, m, bb) + (long long)rs * (n + 1)) * 4;
  void (*kernel)(StepParams, int, int, const float*, const float*, const float*, const float*,
                 const float*, const float*, const uint8_t*, const float*, const float*,
                 const float*, const float*, float*, float*, float*, float*) =
      bb == 8 ? qp_btd_kernel<8> : (bb == 16 ? qp_btd_kernel<16> : qp_btd_kernel<0>);
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
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
  kernel<<<batch, 256, smem, (cudaStream_t)stream>>>(
      p, bb, rs, pd, pe, A, q, l, u, active, rho_in, x0, z0, y0, x_out, z_out, y_out, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
