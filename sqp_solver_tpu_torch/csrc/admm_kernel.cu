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
// Bound.  Per launch the kernel must read W, P, A and eight (B, D) vectors
// and write s, yp and the (B, 4) stats: 114 MB at n = 32, m = 33,
// B = 4096, 0.034 ms at 3.35 TB/s; the 2 D^2 seg flops are a fifth of that
// time at 67 TFLOP/s, so bytes bound it at every path shape.
//
// Design.  One thread block per problem, one thread per row of W
// (blockDim = D rounded up to a warp, D <= 1024); each thread keeps its
// row's state and constants in registers for the whole chunk.
//   Load.  Every row of W that shared memory holds goes in flight at entry
//   at once (cp.async, 16 bytes a copy where the rows are aligned, 4
//   otherwise: a problem's W starts at b D^2 floats, unaligned for odd D),
//   while the threads load their rows' vectors; one wait, one barrier.
//   What bounds the small shapes is latency, so shared memory is kept to
//   W and the vectors: ten blocks an SM at D = 65, whose loads and
//   iterations overlap.
//   Iterations.  Shared memory's bandwidth bounds them at D <= 65: one
//   thread a row reads its row of W and rhs, two operands a FMA.  Rows of
//   W have a stride of 4 x odd floats and are read as float4s (no bank
//   conflicts) against float4 broadcasts of rhs, on four accumulators: a
//   quarter of the load instructions, but as many wavefronts (a 16-byte
//   read takes four, broadcast or not), so there they run at the pace of
//   one scalar load each.  Holding each row in registers halves the
//   wavefronts but halves the blocks an SM, and measured slower.
//   Rows that shared memory cannot hold (D = 257 at n = 128: 216 of 257
//   fit) stay in registers, split over the lanes of the block's warps (at
//   most kRegRows rows a warp, a lane the columns lane + 32 c), each dot a
//   lane-split sum and a warp sum: no iteration touches device memory.
//   Only a D beyond the register variant's 288 reads the rest of W from
//   device memory each iteration, one warp a row.
//   Stats.  P and A go in flight into W's dead rows when the iterations
//   end (device memory only where those cannot hold them, D > 288); q
//   and x in shared memory.  A'y one thread a column, Ax and Px one
//   thread a row (float4 dot products), one block max-reduction.
//   D > 1024 (up to 2048): a variant of its own (admm_chunk_wide_kernel,
//   below), two rows a thread and W read from device memory every
//   iteration; the launches at D <= 1024 are the kernels above.
// Every loop bound and branch that holds a barrier or a shuffle is uniform
// across the block or the warp.

#include "admm_core.cuh"

namespace {

constexpr int kMaxThreads = 1024;
// The register variant: D <= kRegCols x 32 = 288 (nine warps), up to
// kRegRows rows of W a warp in registers (99 floats a thread): every row
// that shared memory cannot hold at D <= 288.
constexpr int kRegRows = 11;
constexpr int kRegCols = 9;
constexpr int kRegThreads = 32 * kRegCols;

// sum_k row[k] v[k] over k < 4 n4, both 16-byte aligned and zero past
// their length: float4 reads, four accumulators for short fmaf chains.
__device__ __forceinline__ float dot4(const float* row, const float* v, int n4) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* v4 = reinterpret_cast<const float4*>(v);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
  for (int k = 0; k < n4; ++k) {
    const float4 r = r4[k], x = v4[k];
    a0 = fmaf(r.x, x.x, a0);
    a1 = fmaf(r.y, x.y, a1);
    a2 = fmaf(r.z, x.z, a2);
    a3 = fmaf(r.w, x.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// where the stats read P and A: device memory, or W's dead rows
enum PaPlace { kPaDevice = 0, kPaWRows = 1 };

struct ChunkParams {
  int n, m, D, ld, rows_smem, rows_reg, pa, seg;
  float alpha, beta;  // beta = 1 - alpha, rounded once on the host
};

template <int KR>
__global__ void __launch_bounds__(KR > 0 ? kRegThreads : kMaxThreads) admm_chunk_kernel(
    ChunkParams p, const float* __restrict__ Wg, const float* __restrict__ Pg,
    const float* __restrict__ Ag, const float* __restrict__ qv, const float* __restrict__ sc,
    const float* __restrict__ ri, const float* __restrict__ rp, const float* __restrict__ lp,
    const float* __restrict__ up, const float* __restrict__ s_in,
    const float* __restrict__ yp_in, float* __restrict__ s_out, float* __restrict__ yp_out,
    float* __restrict__ stats) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int n = p.n, m = p.m, D = p.D, ld = p.ld, R = p.rows_smem, G = p.rows_reg;
  const int D4 = round4(D), D32 = round32(D), n4 = round4(n);
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  // every offset a multiple of 4 floats: 16-byte aligned
  const int ldn = stride4(n);    // P and A in W's rows
  float* red = smem;
  float* rhs = red + kRedSlots;  // D32, zero past D
  float* xz = rhs + D32;         // D32: products of the rows not in shared memory
  float* sv = xz + D32;          // D32: final s, for the stats
  float* yv = sv + D32;          // D32: final yp
  float* aty = yv + D32;         // n4
  float* qs = aty + n4;          // n4: q, zero past n
  float* xs = qs + n4;           // n4: final x, zero past n
  float* Ws = xs + n4;           // R rows of W, stride ld, zero from D to D4
  float* Ps = Ws;                // after the iterations: n rows, stride ldn
  float* As = Ps + (size_t)n * ldn;  // m rows, stride ldn
  const float* Wb = Wg + b * D * D;
  const float* Pb = Pg + b * n * n;
  const float* Ab = Ag + b * m * n;

  copy_rows_async(Ws, ld, Wb, R, D, warp, nw, lane);

  // while the copies fly: this thread's row (state and constants in
  // registers), the zero pads, and the rows of W held in registers
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
    if (i < R)
      for (int j = D; j < D4; ++j) Ws[i * ld + j] = 0.f;
  } else {
    rhs[i] = 0.f;  // D..T-1; T = D32
  }
  if (i < n4) qs[i] = i < n ? q : 0.f;
  float wr[KR > 0 ? KR : 1][kRegCols];  // row R + warp + nw r, columns lane + 32 c
  const int cc = D32 >> 5;
  if (KR > 0) {
#pragma unroll
    for (int r = 0; r < KR; ++r) {
      const int row = R + warp + nw * r;
#pragma unroll
      for (int cI = 0; cI < kRegCols; ++cI) {
        const int col = lane + 32 * cI;
        wr[r][cI] = (row < R + G && col < D) ? __ldg(Wb + (size_t)row * D + col) : 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  ADMM_PHASE_END(kPhLoad);

  ADMM_PHASE_BEGIN(kPhIter);
  for (int it = 0; it < p.seg; ++it) {
    float acc = 0.f;
    if (own && i < R) acc = dot4(Ws + i * ld, rhs, D4 >> 2);
    if (KR > 0) {  // rows in registers: lane-split dots and a warp sum each
      float part[KR > 0 ? KR : 1];
#pragma unroll
      for (int r = 0; r < KR; ++r) part[r] = 0.f;
#pragma unroll
      for (int cI = 0; cI < kRegCols; ++cI) {
        if (cI < cc) {
          const float x = rhs[lane + 32 * cI];
#pragma unroll
          for (int r = 0; r < KR; ++r) part[r] = fmaf(wr[r][cI], x, part[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < KR; ++r) {
        const int row = R + warp + nw * r;
        if (row < R + G) {  // warp-uniform
          const float a = warp_sum(part[r]);
          if (lane == 0) xz[row] = a;
        }
      }
    }
    for (int k = R + G + warp; k < D; k += nw) {  // rows held in device memory
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
  ADMM_PHASE_END(kPhIter);

  ADMM_PHASE_BEGIN(kPhStats);
  const bool pa_smem = p.pa == kPaWRows;
  if (pa_smem) {  // W's rows are dead: P and A into them
    copy_rows_async(Ps, ldn, Pb, n, n, warp, nw, lane);
    copy_rows_async(As, ldn, Ab, m, n, warp, nw, lane);
    if (i < n + m)  // the rows' padding
      for (int j = n; j < n4; ++j) Ps[i * ldn + j] = 0.f;
  }
  if (own) {
    s_out[vo + i] = s;
    yp_out[vo + i] = y;
    sv[i] = s;
    yv[i] = y;
  }
  if (i < n4) xs[i] = i < n ? s : 0.f;
  cp_async_wait_all();
  __syncthreads();

  // chunk-end stats: x = xs, z = sv[n:], y = yv[n:]; from shared memory
  // one thread a column (A'y) and one a row of A or P (Ax, Px, a float4
  // dot product), from device memory one warp a row
  const float* Am = pa_smem ? As : Ab;
  const int lda = pa_smem ? ldn : n;
  const float* zs = sv + n;
  const float* ys = yv + n;
  for (int j = tid; j < n; j += T) {
    float a = 0.f;
#pragma unroll 4
    for (int r = 0; r < m; ++r) a = fmaf(Am[(size_t)r * lda + j], ys[r], a);
    aty[j] = a;
  }
  __syncthreads();
  // |Ax - z|, |Px + q + A'y|, |Ax|, |z|, |Px|, |A'y|, |q|
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  auto row_term = [&](int k, float a) {  // row k of [A; P] times x is a
    if (k < m) {
      v[0] = nan_max(v[0], fabsf(a - zs[k]));
      v[2] = nan_max(v[2], fabsf(a));
    } else {
      v[1] = nan_max(v[1], fabsf(a + qs[k - m] + aty[k - m]));
      v[4] = nan_max(v[4], fabsf(a));
    }
  };
  if (pa_smem) {
    if (i < m + n) row_term(i, dot4(i < m ? As + i * ldn : Ps + (i - m) * ldn, xs, n4 >> 2));
  } else {
    for (int k = warp; k < m + n; k += nw) {
      const float* row = k < m ? Ab + (size_t)k * n : Pb + (size_t)(k - m) * n;
      float a = 0.f;
      for (int j = lane; j < n; j += 32) a = fmaf(__ldg(row + j), xs[j], a);
      a = warp_sum(a);
      if (lane == 0) row_term(k, a);
    }
  }
  for (int j = tid; j < n; j += T) {
    v[5] = nan_max(v[5], fabsf(aty[j]));
    v[6] = nan_max(v[6], fabsf(qs[j]));
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
  ADMM_PHASE_END(kPhStats);
  ADMM_PHASE_END(kPhTotal);
}

// D > 1024: more rows than a block has threads.  Thread i owns the rows
// i and i + 1024 (state and constants in registers, kWideRows a thread);
// no row of W fits in shared memory beside the others' vectors at any
// size worth staging, so every iteration reads all of W from device
// memory, one warp a row (lanes over its columns, a warp sum), against rhs
// in shared memory: D^2 floats a problem an iteration bound it.  The stats
// read P and A from device memory (one thread a column of A'y, one warp a
// row of Ax and Px), as the narrow variant does where W's dead rows cannot
// hold them.
constexpr int kWideRows = 2;
constexpr int kMaxWideD = kWideRows * kMaxThreads;

__global__ void __launch_bounds__(kMaxThreads) admm_chunk_wide_kernel(
    ChunkParams p, const float* __restrict__ Wg, const float* __restrict__ Pg,
    const float* __restrict__ Ag, const float* __restrict__ qv, const float* __restrict__ sc,
    const float* __restrict__ ri, const float* __restrict__ rp, const float* __restrict__ lp,
    const float* __restrict__ up, const float* __restrict__ s_in,
    const float* __restrict__ yp_in, float* __restrict__ s_out, float* __restrict__ yp_out,
    float* __restrict__ stats) {
  extern __shared__ float smem[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int n = p.n, m = p.m, D = p.D;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = T >> 5;
  float* red = smem;
  float* rhs = red + kRedSlots;  // D
  float* xz = rhs + D;           // D: W rhs
  float* sv = xz + D;            // D: final s, for the stats
  float* yv = sv + D;            // D: final yp
  float* aty = yv + D;           // n
  const float* Wb = Wg + b * D * D;
  const float* Pb = Pg + b * n * n;
  const float* Ab = Ag + b * m * n;
  const size_t vo = b * D;

  float s[kWideRows], y[kWideRows], q[kWideRows], c[kWideRows], rinv[kWideRows],
      rho[kWideRows], lo[kWideRows], hi[kWideRows], ysel[kWideRows];
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    const int i = tid + r * T;
    const bool own = i < D;
    s[r] = own ? s_in[vo + i] : 0.f;
    y[r] = own ? yp_in[vo + i] : 0.f;
    q[r] = own ? qv[vo + i] : 0.f;
    c[r] = own ? sc[vo + i] : 0.f;
    rinv[r] = own ? ri[vo + i] : 0.f;
    rho[r] = own ? rp[vo + i] : 0.f;
    lo[r] = own ? lp[vo + i] : 0.f;
    hi[r] = own ? up[vo + i] : 0.f;
    ysel[r] = rinv[r] * rho[r];
    if (own) rhs[i] = c[r] * s[r] - q[r] - ysel[r] * y[r];
  }
  __syncthreads();
  ADMM_PHASE_END(kPhLoad);

  ADMM_PHASE_BEGIN(kPhIter);
  for (int it = 0; it < p.seg; ++it) {
    for (int k = warp; k < D; k += nw) {
      const float* row = Wb + (size_t)k * D;
      float a = 0.f;
#pragma unroll 4
      for (int j = lane; j < D; j += 32) a = fmaf(__ldg(row + j), rhs[j], a);
      a = warp_sum(a);
      if (lane == 0) xz[k] = a;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kWideRows; ++r) {
      const int i = tid + r * T;
      if (i < D) {
        const float pre = p.alpha * xz[i] + p.beta * s[r];
        float sn = pre + rinv[r] * y[r];
        sn = sn < lo[r] ? lo[r] : sn;  // clip as min(max(v, lo), hi); NaN stays NaN
        sn = sn > hi[r] ? hi[r] : sn;
        y[r] = y[r] + rho[r] * (pre - sn);
        s[r] = sn;
        rhs[i] = c[r] * s[r] - q[r] - ysel[r] * y[r];
      }
    }
    __syncthreads();
  }
  ADMM_PHASE_END(kPhIter);

  ADMM_PHASE_BEGIN(kPhStats);
#pragma unroll
  for (int r = 0; r < kWideRows; ++r) {
    const int i = tid + r * T;
    if (i < D) {
      s_out[vo + i] = s[r];
      yp_out[vo + i] = y[r];
      sv[i] = s[r];
      yv[i] = y[r];
    }
  }
  __syncthreads();
  // x = sv[:n], z = sv[n:], y = yv[n:]
  const float* zs = sv + n;
  const float* ys = yv + n;
  for (int j = tid; j < n; j += T) {
    float a = 0.f;
#pragma unroll 4
    for (int r = 0; r < m; ++r) a = fmaf(__ldg(Ab + (size_t)r * n + j), ys[r], a);
    aty[j] = a;
  }
  __syncthreads();
  // |Ax - z|, |Px + q + A'y|, |Ax|, |z|, |Px|, |A'y|, |q|
  float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = warp; k < m + n; k += nw) {
    const float* row = k < m ? Ab + (size_t)k * n : Pb + (size_t)(k - m) * n;
    float a = 0.f;
    for (int j = lane; j < n; j += 32) a = fmaf(__ldg(row + j), sv[j], a);
    a = warp_sum(a);
    if (lane == 0) {
      if (k < m) {
        v[0] = nan_max(v[0], fabsf(a - zs[k]));
        v[2] = nan_max(v[2], fabsf(a));
      } else {
        v[1] = nan_max(v[1], fabsf(a + qv[vo + k - m] + aty[k - m]));
        v[4] = nan_max(v[4], fabsf(a));
      }
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
  ADMM_PHASE_END(kPhStats);
  ADMM_PHASE_END(kPhTotal);
}

struct ChunkLayout {
  size_t smem_bytes;
  int ld, rows_smem, rows_reg, pa, threads;
};

// Rows of W in shared memory while they fit (all D where they do); where
// they do not and D <= 288, the rest in registers (the register variant);
// P and A in W's rows after the iterations where those hold them.
ChunkLayout chunk_layout(int n, int m) {
  ChunkLayout L;
  const int D = n + m;
  L.ld = stride4(D);
  L.threads = round32(D);
  const long long vec_floats = kRedSlots + 4LL * round32(D) + 3LL * round4(n);
  const long long cap = kMaxSmemBytes / (long long)sizeof(float);
  long long rows = cap > vec_floats ? (cap - vec_floats) / L.ld : 0;
  if (rows > D) rows = D;
  L.rows_smem = (int)rows;
  L.rows_reg = 0;
  if (rows < D && D <= kRegThreads) {
    const int nw = L.threads / 32;
    const long long left = D - rows;
    L.rows_reg = (int)(left < (long long)nw * kRegRows ? left : (long long)nw * kRegRows);
  }
  L.pa = rows * L.ld >= (long long)(n + m) * stride4(n) ? kPaWRows : kPaDevice;
  L.smem_bytes = (size_t)(vec_floats + rows * L.ld) * sizeof(float);
  return L;
}

// The launch of the wide variant (D = n + m > 1024).
int launch_wide(const float* W, const float* P, const float* A, const float* qv,
                const float* scale1, const float* rhoip, const float* rhop, const float* lp,
                const float* up, const float* s, const float* yp, float* s_out, float* yp_out,
                float* stats, int batch, int n, int m, float alpha, float beta, int seg,
                int device, void* stream) {
  const int D = n + m;
  const size_t smem = (size_t)(kRedSlots + 4LL * D + n) * sizeof(float);  // < 48 KB
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  ChunkParams p;
  p.n = n;
  p.m = m;
  p.D = D;
  p.ld = D;
  p.rows_smem = 0;
  p.rows_reg = 0;
  p.pa = kPaDevice;
  p.seg = seg;
  p.alpha = alpha;
  p.beta = beta;
  admm_chunk_wide_kernel<<<batch, kMaxThreads, smem, (cudaStream_t)stream>>>(
      p, W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, s_out, yp_out, stats);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows of W in shared memory and in registers (none past D = 1024).
int admm_chunk_smem_rows(int n, int m) {
  return n + m > kMaxThreads ? 0 : chunk_layout(n, m).rows_smem;
}

int admm_chunk_reg_rows(int n, int m) {
  return n + m > kMaxThreads ? 0 : chunk_layout(n, m).rows_reg;
}

int admm_chunk_launch(const float* W, const float* P, const float* A, const float* qv,
                      const float* scale1, const float* rhoip, const float* rhop,
                      const float* lp, const float* up, const float* s, const float* yp,
                      float* s_out, float* yp_out, float* stats, int batch, int n, int m,
                      float alpha, float beta, int seg, int device, void* stream) {
  if (batch <= 0) return 0;
  if (n + m > kMaxWideD || n <= 0 || m <= 0 || seg < 0) return (int)cudaErrorInvalidValue;
  if (n + m > kMaxThreads) return launch_wide(W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp,
                                              s_out, yp_out, stats, batch, n, m, alpha, beta,
                                              seg, device, stream);
  const ChunkLayout L = chunk_layout(n, m);
  auto kernel = L.rows_reg > 0 ? admm_chunk_kernel<kRegRows> : admm_chunk_kernel<0>;
  // this library's runtime keeps its own current device: use the tensors'
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && L.smem_bytes > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  ChunkParams p;
  p.n = n;
  p.m = m;
  p.D = n + m;
  p.ld = L.ld;
  p.rows_smem = L.rows_smem;
  p.rows_reg = L.rows_reg;
  p.pa = L.pa;
  p.seg = seg;
  p.alpha = alpha;
  p.beta = beta;
  kernel<<<batch, L.threads, L.smem_bytes, (cudaStream_t)stream>>>(
      p, W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, s_out, yp_out, stats);
  return (int)cudaGetLastError();
}

}  // extern "C"
