// Hopper (sm_90a) kernel of the fused ADMM tier, with a plain C interface
// loaded through ctypes by sqp_solver_tpu_torch/ops/admm_kernel.py.
//
//   admm_chunk_kernel  replaces sqp_solver_tpu/ops/admm_kernel.py:admm_chunk_pallas
//                      (body _chunk_kernel, pallas_call at :151)
//
// What it computes, per problem, on padded D = n + m vectors:
//   seg times:  rhs = scale1 .* s - qv - ysel .* yp      (ysel = rhoip .* rhop)
//               pre = alpha W rhs + (1 - alpha) s
//               s'  = clip(pre + rhoip .* yp, lp, up)
//               yp' = yp + rhop .* (pre - s')
//   then the chunk-end residual stats from x = s[:n], z = s[n:], y = yp[n:]:
//   [|Ax - z|inf, |Px + q + A'y|inf, max(|Ax|, |z|), max(|Px|, |A'y|, |q|)].
//
// Design.  One thread block per problem, one thread per row of W
// (blockDim = D rounded up to a warp, D <= 1024), so each thread keeps its
// row's state and constants in registers for the whole chunk.  W is read
// from device memory once per launch into shared memory with an odd row
// stride (conflict-free row-per-thread dot products).  Each iteration is
// two barrier-separated phases: the matvec against rhs in shared memory,
// then each row's relaxation, clip, dual update and next rhs entry.  The
// stats read P and A once from device memory, one warp per row (coalesced),
// A'y one thread per column (coalesced), and one block max-reduction.
// Every loop bound and branch that holds a barrier or a shuffle is uniform
// across the block or the warp.
//
// Memory.  When all of W does not fit in the 227 KB a block may use
// (D = 257 at n = 128 needs 264 KB), the first `rows_smem` rows go to
// shared memory and the rest are read from W in device memory on every
// iteration, one warp per row; no workspace is needed.
//
// Bound.  Per launch the kernel must read W, P, A and eight (B, D)
// vectors and write s, yp and the (B, 4) stats: 114 MB at n = 32, m = 33,
// B = 4096, 0.034 ms at 3.35 TB/s; the 2 D^2 seg flops are a fifth of
// that time at 67 TFLOP/s, so bytes bound it at every path shape.  The
// design reads W once while it fits (D <= 237 with m ~ n); the rows it
// cannot hold are re-read seg times.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxSmemBytes = 232448;  // per block on sm_90
constexpr int kMaxThreads = 1024;
constexpr int kRedSlots = 8 * 32;

struct ChunkParams {
  int n, m, D, ld, rows_smem, seg;
  float alpha, beta;  // beta = 1 - alpha, rounded once on the host
};

// max that propagates NaN like jnp.maximum / torch.maximum
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Block-wide max of K values at once; every thread returns the result.
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

__global__ void __launch_bounds__(kMaxThreads) admm_chunk_kernel(
    ChunkParams p, const float* __restrict__ Wg, const float* __restrict__ Pg,
    const float* __restrict__ Ag, const float* __restrict__ qv, const float* __restrict__ sc,
    const float* __restrict__ ri, const float* __restrict__ rp, const float* __restrict__ lp,
    const float* __restrict__ up, const float* __restrict__ s_in,
    const float* __restrict__ yp_in, float* __restrict__ s_out, float* __restrict__ yp_out,
    float* __restrict__ stats) {
  extern __shared__ float smem[];
  const int n = p.n, m = p.m, D = p.D, ld = p.ld, R = p.rows_smem;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  float* red = smem;
  float* rhs = red + kRedSlots;  // D
  float* xz = rhs + D;           // D: products of the rows read from device memory
  float* sv = xz + D;            // D: final s, for the stats
  float* yv = sv + D;            // D: final yp
  float* aty = yv + D;           // n
  float* Ws = aty + n;           // R rows of W, stride ld
  const float* Wb = Wg + b * D * D;
  for (int e = tid; e < R * D; e += T) {
    const int i = e / D, j = e - i * D;
    Ws[i * ld + j] = Wb[e];
  }

  // this thread's row: state and constants in registers
  const size_t vo = b * D;
  const int i = tid;
  const bool own = i < D;
  float s = 0.f, y = 0.f, q = 0.f, c = 0.f, rinv = 0.f, rho = 0.f, lo = 0.f, hi = 0.f,
        ysel = 0.f;
  if (own) {
    s = s_in[vo + i];
    y = yp_in[vo + i];
    q = qv[vo + i];
    c = sc[vo + i];
    rinv = ri[vo + i];
    rho = rp[vo + i];
    lo = lp[vo + i];
    hi = up[vo + i];
    ysel = rinv * rho;
    rhs[i] = c * s - q - ysel * y;
  }
  __syncthreads();

  for (int it = 0; it < p.seg; ++it) {
    float acc = 0.f;
    if (own && i < R) {
      const float* r = Ws + i * ld;
      for (int j = 0; j < D; ++j) acc = fmaf(r[j], rhs[j], acc);
    }
    for (int k = R + warp; k < D; k += nw) {  // rows held in device memory
      const float* r = Wb + (size_t)k * D;
      float a = 0.f;
      for (int j = lane; j < D; j += 32) a = fmaf(__ldg(r + j), rhs[j], a);
      a = warp_sum(a);
      if (lane == 0) xz[k] = a;
    }
    __syncthreads();
    if (own) {
      const float w = i < R ? acc : xz[i];
      const float pre = p.alpha * w + p.beta * s;
      float sn = pre + rinv * y;
      sn = sn < lo ? lo : sn;  // clip as min(max(v, lo), hi); NaN stays NaN
      sn = sn > hi ? hi : sn;
      y = y + rho * (pre - sn);
      s = sn;
      rhs[i] = c * s - q - ysel * y;
    }
    __syncthreads();
  }

  if (own) {
    s_out[vo + i] = s;
    yp_out[vo + i] = y;
    sv[i] = s;
    yv[i] = y;
  }
  __syncthreads();

  // chunk-end stats: x = sv[:n], z = sv[n:], y = yv[n:]
  const float* Ab = Ag + b * m * n;
  const float* Pb = Pg + b * n * n;
  const float* xs = sv;
  const float* zs = sv + n;
  const float* ys = yv + n;
  for (int j = tid; j < n; j += T) {
    float a = 0.f;
    for (int r = 0; r < m; ++r) a = fmaf(__ldg(Ab + (size_t)r * n + j), ys[r], a);
    aty[j] = a;
  }
  __syncthreads();
  // |Ax - z|, |Px + q + A'y|, |Ax|, |z|, |Px|, |A'y|, |q|
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = warp; k < m + n; k += nw) {  // rows of A, then rows of P
    const bool is_a = k < m;
    const int r = is_a ? k : k - m;
    const float* row = is_a ? Ab + (size_t)r * n : Pb + (size_t)r * n;
    float a = 0.f;
    for (int j = lane; j < n; j += 32) a = fmaf(__ldg(row + j), xs[j], a);
    a = warp_sum(a);
    if (is_a) {
      v[0] = nan_max(v[0], fabsf(a - zs[r]));
      v[2] = nan_max(v[2], fabsf(a));
    } else {
      v[1] = nan_max(v[1], fabsf(a + qv[vo + r] + aty[r]));
      v[4] = nan_max(v[4], fabsf(a));
    }
  }
  for (int j = tid; j < n; j += T) {
    v[5] = nan_max(v[5], fabsf(aty[j]));
    v[6] = nan_max(v[6], fabsf(qv[vo + j]));
  }
  for (int r = tid; r < m; r += T) v[3] = nan_max(v[3], fabsf(zs[r]));
  block_max<7>(v, red);
  if (tid == 0) {
    float* st = stats + b * 4;
    st[0] = v[0];
    st[1] = v[1];
    st[2] = nan_max(v[2], v[3]);
    st[3] = nan_max(v[4], nan_max(v[5], v[6]));
  }
}

struct ChunkLayout {
  size_t smem_bytes;
  int ld, rows_smem, threads;
};

ChunkLayout chunk_layout(int n, int m) {
  ChunkLayout L;
  const int D = n + m;
  L.ld = D | 1;  // odd stride: the row-per-thread reads hit 32 banks
  L.threads = (D + 31) / 32 * 32;
  const long long vec_floats = kRedSlots + 4LL * D + n;
  const long long room = kMaxSmemBytes / (long long)sizeof(float) - vec_floats;
  long long rows = room > 0 ? room / L.ld : 0;
  if (rows > D) rows = D;
  L.rows_smem = (int)rows;
  L.smem_bytes = (size_t)(vec_floats + rows * L.ld) * sizeof(float);
  return L;
}

}  // namespace

extern "C" {

int admm_chunk_smem_rows(int n, int m) { return chunk_layout(n, m).rows_smem; }

int admm_chunk_launch(const float* W, const float* P, const float* A, const float* qv,
                      const float* scale1, const float* rhoip, const float* rhop,
                      const float* lp, const float* up, const float* s, const float* yp,
                      float* s_out, float* yp_out, float* stats, int batch, int n, int m,
                      float alpha, float beta, int seg, int device, void* stream) {
  if (batch <= 0) return 0;
  if (n + m > kMaxThreads || n <= 0 || m <= 0 || seg < 0) return (int)cudaErrorInvalidValue;
  const ChunkLayout L = chunk_layout(n, m);
  // this library's runtime keeps its own current device: use the tensors'
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && L.smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(admm_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ChunkParams p;
  p.n = n;
  p.m = m;
  p.D = n + m;
  p.ld = L.ld;
  p.rows_smem = L.rows_smem;
  p.seg = seg;
  p.alpha = alpha;
  p.beta = beta;
  admm_chunk_kernel<<<batch, L.threads, L.smem_bytes, (cudaStream_t)stream>>>(
      p, W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, s_out, yp_out, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
