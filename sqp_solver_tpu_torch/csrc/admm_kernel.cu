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
// Routes.  One layout rule (route_layout, reported by the C entry
// admm_chunk_route_layout) picks one of three by D, n and the batch: the
// narrow kernel up to D = 288, the cluster route from 289 to 1024 where a
// portable cluster's shared memory holds W, the stream route past that
// (up to D = 2125, the JAX kernel's limit).
//
// The narrow route.  One thread block per problem, one thread per row of
// W (blockDim = D rounded up to a warp, D <= 1024); each thread keeps its
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
//   Past 288 the rule takes the other routes; forced onto this kernel
//   (the A/B comparisons do), a D up to 1024 reads the rows of W that
//   shared memory cannot hold from device memory each iteration, one
//   warp a row.
//   Stats.  P and A go in flight into W's dead rows when the iterations
//   end (device memory only where those cannot hold them, D > 288); q
//   and x in shared memory.  A'y one thread a column, Ax and Px one
//   thread a row (float4 dot products), one block max-reduction.
// The cluster and stream routes are one ring kernel in three
// instantiations (ring_chunk, below): W's rows spread over a cluster of
// blocks a problem and brought in by bulk copies, rhs exchanged through
// distributed shared memory every iteration.  The stream route's ring
// streams W every iteration; the cluster route's holds the block's rows
// for the whole chunk.
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

// ---- the stream route: D > 1024 (up to 2125), and below where W does not
// ---- fit a cluster ----------------------------------------------------------
//
// Bound.  No problem's W fits on chip (6.6 MB at D = 1280, 16.8 MB at
// D = 2048; a portable cluster of eight blocks holds 1.8 MB), and one
// right-hand side a problem gives W no reuse inside an iteration, so every
// iteration streams all of W from device memory: the floor this shape can
// reach is 4 B (seg D^2 + n^2 + m n + 10 D + 4) bytes over 3.35 TB/s
// (5.26 ms at D = 1280, B = 256, seg 10), seg times the bound that counts
// W once.
//
// Design: keep device memory streaming without a pause.
//   A cluster of cs blocks a problem (wide_layout: the most
//   blocks a problem that leave every block an SM of its own), block r owning the
//   contiguous rows [r D / cs, (r + 1) D / cs) of W.  Each block has 8
//   consumer warps and one producer warp.
//   The ring.  One producer thread streams the block's rows of W, a stage
//   of whole rows at a time, through kWideStages stages in shared memory
//   with bulk copies (cp.async.bulk, the TMA's non-tensor form) completing
//   an mbarrier each (full); stage k is consumer warp k's, which takes its
//   rows (one warp a row, a lane the columns lane + 32 j, scalar shared
//   memory reads of the row and of rhs), writes W rhs of each row and
//   releases the stage (empty).  W does not depend on the iterate, so the
//   producer streams straight on into the next iteration's rows while the
//   consumers update and exchange: the ring's phases run across the
//   iterations, and device memory waits only when the whole ring is full.
//   A copy needs 16-byte aligned ends (a problem's W starts at b D^2
//   floats, unaligned for odd D): each stage holds the 16-byte aligned
//   window around its rows, rows from the window's offset; at the ends of
//   an operand the unaligned head and tail (at most 3 floats each) are
//   copied by the producer thread, so no copy reads outside the tensor.
//   The exchange.  Each consumer thread updates up to kWideRowsThread of
//   the block's rows (s and y in registers, the row's constants read again
//   from device memory each iteration, L2 hits) and writes its rows of the
//   next rhs into every block of the cluster (distributed shared memory);
//   rhs has two buffers by iteration parity, and each buffer an mbarrier
//   that every consumer thread of the cluster arrives on (release at
//   cluster scope) and the consumers wait on (acquire): the producer never
//   takes part.  A consumer thread arrives only after its last read of the
//   buffer it will write next, so a late reader never sees the next
//   iteration's values.
//   Stats.  Final s and yp go to every block; the same ring then streams
//   the block's rows of A (Ax, a warp a row; A'y, a warp a range of
//   columns in registers) and of P (Px); each block sends its A'y partial
//   of every column to the block that owns the column's row of P, which
//   sums the cs partials in rank order, and block 0 takes the cluster's
//   maxima.  A last cluster barrier comes before any block exits.
//   Below D = 1025 the stream route takes the same kernel and layout
//   rule, where W does not fit a cluster (D = 960: 3.7 MB a problem).
//
// ---- the cluster route: D = 289-1024 where a cluster holds W -----------------
//
// Bound.  W is read once a launch: 4 B (D^2 + n^2 + m n + 10 D + 4) bytes
// over 3.35 TB/s (0.487 ms at D = 512, B = 1024).  Each iteration then
// reads all of W from shared memory once, 4 seg D^2 bytes a problem (26.8
// GB at D = 512, B = 1024, seg 25: ~0.9 ms at 128 bytes a cycle an SM).
//
// Design: the stream route's kernel with W resident in its ring.
//   The fewest blocks a problem (2, 4 or 8) whose shared memory holds
//   W, preferring a cluster whose blocks fit two to an SM
//   (resident_cluster_rule; 8 at D = 512, up to D = 640).  Stage k holds
//   the block's chunk k (ceil(rows / 8) rows) for the whole chunk of
//   iterations: the producer copies W once, consumer warp k waits on
//   its stage's barrier in the first iteration alone and frees the stage
//   for A and P after the last.
//   Dots.  A lane keeps its columns of rhs in registers (32 at most), and
//   a warp takes its rows four at a time, their loads issued together
//   before their products (reg_dots): one shared-memory wavefront a 32
//   products, against two where rhs is read from shared memory as well.
//   The exchange.  A thread holds one row: its state and constants in
//   registers.  It writes its row of the next rhs into every block, then
//   after a barrier of the block's consumers one thread a peer arrives on
//   that peer's buffer barrier (release at cluster scope): cs arrivals a
//   buffer, not cs x 256 (the same for the final s, yp and the A'y
//   partials).
// Every branch that holds a named, mbarrier or cluster barrier is uniform
// over the consumer threads, or over the cluster.
constexpr int kMaxWideD = 2048;  // the wide instantiation's arrays; past it up to kMaxD
// the JAX kernel's limit: its smallest tile's VMEM footprint reaches its
// 100 MiB limit past D = 2,125 (sqp_solver_tpu/ops/admm_kernel.py:pick_tile)
constexpr int kMaxD = 2125;
constexpr int kMaxNarrowD = kRegThreads;  // the rule's narrow route: D <= 288
constexpr int kWideConsumerWarps = 8;
constexpr int kWideConsumers = 32 * kWideConsumerWarps;
constexpr int kWideThreads = kWideConsumers + 32;  // and the producer warp
constexpr int kWideStages = kWideConsumerWarps;    // stage k is consumer warp k's
constexpr int kWideRowsThread = kMaxWideD / kWideConsumers;  // rows a consumer thread updates
constexpr int kWideAtyCols = kMaxWideD / kWideConsumers;     // A'y columns a lane holds
constexpr int kWideMaxCluster = 8;                           // the portable limit
constexpr int kMaxResidentCluster = 16;  // the cluster route's, forced: non-portable
constexpr int kSmemPerSm = 233472;                           // sm_90
constexpr int kSmemReservedPerBlock = 1024;
constexpr int kWideBarriers = 2 * kWideStages + 5;
constexpr int kWideBarBytes = (kWideBarriers * 8 + 127) / 128 * 128;  // the ring after them

struct WideParams {
  int n, m, D, seg, cs;
  int stage_floats, rows_stage, rows_max, prow_max;
  float alpha, beta;  // beta = 1 - alpha, rounded once on the host
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// whether the phase of parity `parity` has completed: the ring's barriers,
// which this block's threads and copies complete (CTA scope), or one that
// the cluster's blocks arrive on (acquire at cluster scope)
template <bool kCluster>
__device__ __forceinline__ bool mbar_try(uint32_t bar, unsigned parity) {
  uint32_t done;
  if (kCluster)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  return done != 0;
}
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_u32(bar);
  while (!mbar_try<kCluster>(a, parity)) {
  }
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ uint32_t peer_u32(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}
// arrive on `bar` in block `rank` of the cluster, releasing this thread's
// writes at cluster scope
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, int rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   peer_u32(bar, rank))
               : "memory");
}
__device__ __forceinline__ void st_at(float* p, int rank, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(peer_u32(p, rank)), "f"(v) : "memory");
}
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"r"(kWideConsumers) : "memory");
}

// Put the nf floats at src (inside the operand [lo_lim, hi_lim)) in flight
// to `stage`, float k of src at stage[shift + k], shift = (src mod 16
// bytes) / 4: one bulk copy of the 16-byte aligned window inside the
// operand, completing `full`, and the unaligned head or tail at the
// operand's ends (at most 3 floats each) by this thread.
__device__ void ring_fill(float* stage, uint64_t* full, const float* src, int nf,
                          const float* lo_lim, const float* hi_lim) {
  const uintptr_t a = (uintptr_t)src, e = a + 4ull * (unsigned)nf, wa = a & ~(uintptr_t)15;
  const uintptr_t l0 = ((uintptr_t)lo_lim + 15) & ~(uintptr_t)15;
  const uintptr_t l1 = (uintptr_t)hi_lim & ~(uintptr_t)15;
  uintptr_t lo = wa < l0 ? l0 : wa, hi = (e + 15) & ~(uintptr_t)15;
  if (hi > l1) hi = l1;
  const bool bulk = hi > lo;
  const uintptr_t head = bulk ? lo : e, tail = bulk ? hi : e;
  bool generic = false;
  for (uintptr_t g = a; g < head; g += 4, generic = true)
    stage[(g - wa) >> 2] = *reinterpret_cast<const float*>(g);
  for (uintptr_t g = tail > a ? tail : a; g < e; g += 4, generic = true)
    stage[(g - wa) >> 2] = *reinterpret_cast<const float*>(g);
  if (generic) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (bulk) {
    const unsigned bytes = (unsigned)(hi - lo);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(full)),
                 "r"(bytes)
                 : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(stage + ((lo - wa) >> 2))),
        "l"(lo), "r"(bytes), "r"(smem_u32(full))
        : "memory");
  } else {
    mbar_arrive(full);
  }
}

// The stage's first row of the copy from src.
__device__ __forceinline__ const float* ring_rows(const float* stage, const float* src) {
  return stage + (((uintptr_t)src & 15) >> 2);
}

// sum_j r[j] v[j] over j < len by one warp (lane the columns lane + 32 k,
// four accumulators, a warp sum); every lane returns it.
__device__ __forceinline__ float row_dot(const float* r, const float* v, int len, int lane) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  int j = lane;
  for (; j + 96 < len; j += 128) {
    a0 = fmaf(r[j], v[j], a0);
    a1 = fmaf(r[j + 32], v[j + 32], a1);
    a2 = fmaf(r[j + 64], v[j + 64], a2);
    a3 = fmaf(r[j + 96], v[j + 96], a3);
  }
  for (; j < len; j += 32) a0 = fmaf(r[j], v[j], a0);
  return warp_sum((a0 + a1) + (a2 + a3));
}

// The cluster rank whose rows [n r / cs, n (r + 1) / cs) of P hold column j.
__device__ __forceinline__ int prow_owner(int j, int n, int cs) {
  int o = (int)((long long)j * cs / n);
  if (o >= cs) o = cs - 1;
  while (o > 0 && n * o / cs > j) --o;
  while (o < cs - 1 && n * (o + 1) / cs <= j) ++o;
  return o;
}

// Thread 0's spans inside the iterations (phase-clock builds only): waits on
// the ring, dot products, and the update with the exchange.
enum { kClkRing = 0, kClkDot = 1, kClkExch = 2 };
struct WideClock {
#ifdef ADMM_PHASE_CLOCKS
  unsigned long long t = 0, acc[3] = {0ull, 0ull, 0ull};
  __device__ __forceinline__ void mark() { t = clock64(); }
  __device__ __forceinline__ void add(int k) {
    const unsigned long long u = clock64();
    acc[k] += u - t;
    t = u;
  }
  __device__ __forceinline__ void flush() const {
    phase_add(kPhRing, acc[kClkRing]);
    phase_add(kPhDot, acc[kClkDot]);
    phase_add(kPhExchange, acc[kClkExch]);
  }
#else
  __device__ __forceinline__ void mark() {}
  __device__ __forceinline__ void add(int) {}
  __device__ __forceinline__ void flush() const {}
#endif
};

// G rows of W at once (nr of them real, row stride ld) times v by one
// warp: lane the columns lane + 32 k < len, v in registers (the lane's
// columns of the right-hand side, zero past len), one accumulator a row,
// the G warp sums interleaved; every lane gets them in out.  Four columns
// of 32 at a time: their 4 G loads go out before any product, with no
// branch between them (a load past len reads at most 127 floats on, inside
// the block's shared memory, and its product is replaced by zero), so
// their latencies overlap; every index is static, so v stays in registers.
constexpr int kResGroup = 4;  // rows a group (2 and 8 measured slower, PERF.md section 6)
template <int K, int G>
__device__ __forceinline__ void reg_dots(const float* r, int ld, int nr, const float (&v)[K],
                                         int len, int lane, float (&out)[G]) {
  static_assert(K % 4 == 0, "columns in fours");
  const int kc = (len + 31) >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) out[g] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 4) {
    if (k0 < kc) {  // warp-uniform
      float w[4][G];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int g = 0; g < G; ++g) w[k][g] = g < nr ? r[g * ld + lane + 32 * (k0 + k)] : 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const bool in = lane + 32 * (k0 + k) < len;
#pragma unroll
        for (int g = 0; g < G; ++g)
          out[g] = fmaf(in ? w[k][g] : 0.f, v[k0 + k], out[g]);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g) out[g] += __shfl_xor_sync(0xffffffffu, out[g], o);
}

// The ring's body, in three instantiations (RingCfg): the wide variant's
// up to D = 2048 (kWideRowsThread rows a consumer thread, kWideAtyCols
// A'y columns a lane), past it up to kMaxD (one more of each, so that the
// launches up to 2048 keep their registers), and the cluster route's,
// where the ring holds the block's rows of W for the whole chunk.
template <int kRows, int kAty, bool kResident>
struct RingCfg {
  static constexpr int rows = kRows, aty = kAty;
  static constexpr bool resident = kResident;
};
constexpr int kXlRowsThread = (kMaxD + kWideConsumers - 1) / kWideConsumers;
constexpr int kXlAtyCols = ((kMaxD + kWideConsumerWarps - 1) / kWideConsumerWarps + 31) / 32;
// The cluster route: D <= kMaxThreads, at most kResRowsThread rows of W a
// consumer thread, a lane's columns of rhs in kResCols registers.
constexpr int kResRowsThread = 1;
constexpr int kResCols = kMaxThreads / 32;
constexpr int kResAtyCols = (kMaxThreads / kWideConsumerWarps + 31) / 32;
using WideCfg = RingCfg<kWideRowsThread, kWideAtyCols, false>;
using XlCfg = RingCfg<kXlRowsThread, kXlAtyCols, false>;
using ResCfg = RingCfg<kResRowsThread, kResAtyCols, true>;

template <class C>
__device__ __forceinline__ void ring_chunk(
    const WideParams& p, const float* __restrict__ Wg, const float* __restrict__ Pg,
    const float* __restrict__ Ag, const float* __restrict__ qv, const float* __restrict__ sc,
    const float* __restrict__ ri, const float* __restrict__ rp, const float* __restrict__ lp,
    const float* __restrict__ up, const float* __restrict__ s_in,
    const float* __restrict__ yp_in, float* __restrict__ s_out, float* __restrict__ yp_out,
    float* __restrict__ stats, int batch) {
  extern __shared__ __align__(128) unsigned char wsm[];
  ADMM_PHASE_BEGIN(kPhTotal);
  ADMM_PHASE_BEGIN(kPhLoad);
  const int n = p.n, m = p.m, D = p.D, cs = p.cs, SF = p.stage_floats;
  const int rank = (int)(blockIdx.x % cs);
  const size_t b = blockIdx.x / cs;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint64_t* full = reinterpret_cast<uint64_t*>(wsm);
  uint64_t* empty = full + kWideStages;
  uint64_t* ready = empty + kWideStages;  // [2]: rhs buffer 0 / 1 written
  uint64_t* fin = ready + 2;              // final s and yp written
  uint64_t* aty_bar = fin + 1;            // the A'y partials written
  uint64_t* gather_bar = aty_bar + 1;     // the blocks' maxima written (rank 0)
  float* ring = reinterpret_cast<float*>(wsm + kWideBarBytes);
  float* rb = ring + (size_t)kWideStages * SF;  // [2][D]: rhs by iteration parity
  float* sv = rb + 2 * D;                       // D: final s
  float* yv = sv + D;                           // D: final yp
  float* xz = yv + D;                           // rows_max: W rhs of the block's rows
  float* px = xz + p.rows_max;                  // prow_max: P x of the block's rows of P
  float* atyp = px + p.prow_max;                // [cs][prow_max]: A'y partials
  float* red = atyp + cs * p.prow_max;          // [8][consumer warps]
  float* gat = red + 8 * kWideConsumerWarps;    // [cs][8] (rank 0)
  const int r0 = D * rank / cs, R = D * (rank + 1) / cs - r0;
  const int p0 = n * rank / cs, np = n * (rank + 1) / cs - p0;
  const int a0 = m * rank / cs, na = m * (rank + 1) / cs - a0;
  const int kw = p.rows_stage, nch = (R + kw - 1) / kw;
  const int ka = (SF - 8) / n, nca = (na + ka - 1) / ka, ncp = (np + ka - 1) / ka;
  // rounds of W through the ring: one an iteration, or one in all where the
  // ring holds the block's rows for the whole chunk (chunk k in stage k)
  const int wrounds = C::resident ? (p.seg > 0 ? 1 : 0) : p.seg;
  const float* Wb = Wg + b * D * D;
  const float* Pb = Pg + b * n * n;
  const float* Ab = Ag + b * m * n;
  if (tid == 0) {
    const unsigned all = (unsigned)(cs * kWideConsumers);
    for (int k = 0; k < kWideStages; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&empty[k], 1);
    }
    // the cluster route's blocks arrive once each on a peer's barriers
    mbar_init(&ready[0], C::resident ? (unsigned)cs : all);
    mbar_init(&ready[1], C::resident ? (unsigned)cs : all);
    mbar_init(fin, C::resident ? (unsigned)cs : all);
    mbar_init(aty_bar, C::resident ? (unsigned)cs : all);
    mbar_init(gather_bar, (unsigned)cs);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync_all();  // every block's barriers are set before a peer arrives

  if (warp == kWideConsumerWarps) {  // the producer
    if (lane == 0) {
      const float* Wend = Wg + (size_t)batch * D * D;
      const float* Aend = Ag + (size_t)batch * m * n;
      const float* Pend = Pg + (size_t)batch * n * n;
      int Q = 0;  // chunks so far: stage Q mod kWideStages, its fill Q / kWideStages
      auto fill = [&](const float* src, int nf, const float* lo, const float* hi) {
        const int k = Q % kWideStages, f = Q / kWideStages;
        if (f > 0) mbar_wait(&empty[k], (f - 1) & 1);
        ring_fill(ring + (size_t)k * SF, &full[k], src, nf, lo, hi);
        ++Q;
      };
      for (int it = 0; it < wrounds; ++it)
        for (int j = 0; j < nch; ++j)
          fill(Wb + (size_t)(r0 + j * kw) * D, min(kw, R - j * kw) * D, Wg, Wend);
      for (int j = 0; j < nca; ++j)
        fill(Ab + (size_t)(a0 + j * ka) * n, min(ka, na - j * ka) * n, Ag, Aend);
      for (int j = 0; j < ncp; ++j)
        fill(Pb + (size_t)(p0 + j * ka) * n, min(ka, np - j * ka) * n, Pg, Pend);
    }
    __syncwarp();
  } else {  // the consumers
    WideClock clk;
    const int t = tid;
    const size_t vo = b * D;
    float s[C::rows], y[C::rows];
    // the cluster route keeps its rows' constants in registers
    constexpr int kc = C::resident ? C::rows : 1;
    float cq[kc], cc[kc], cri[kc], crp[kc], clo[kc], chi[kc];
#pragma unroll
    for (int k = 0; k < C::rows; ++k) {
      const int loc = t + k * kWideConsumers;
      s[k] = 0.f;
      y[k] = 0.f;
      if (loc < R) {
        const int g = r0 + loc;
        s[k] = s_in[vo + g];
        y[k] = yp_in[vo + g];
        if constexpr (C::resident) {
          cq[k] = qv[vo + g];
          cc[k] = sc[vo + g];
          cri[k] = ri[vo + g];
          crp[k] = rp[vo + g];
          clo[k] = lp[vo + g];
          chi[k] = up[vo + g];
        }
        if (p.seg > 0) {
          const float q = qv[vo + g], c = sc[vo + g], ysel = ri[vo + g] * rp[vo + g];
          const float rhs = c * s[k] - q - ysel * y[k];
          for (int r = 0; r < cs; ++r) st_at(rb + g, r, rhs);
        }
      }
    }
    if (p.seg > 0) {
      if constexpr (C::resident) {
        consumers_sync();  // the block's rows written: one arrival on each peer
        if (t < cs) mbar_arrive_at(&ready[0], t);
      } else {
        for (int r = 0; r < cs; ++r) mbar_arrive_at(&ready[0], r);
      }
    }
    ADMM_PHASE_END(kPhLoad);

    ADMM_PHASE_BEGIN(kPhIter);
    for (int it = 0; it < p.seg; ++it) {
      clk.mark();
      mbar_wait<true>(&ready[it & 1], (it >> 1) & 1);
      clk.add(kClkExch);
      const float* rhs = rb + (it & 1) * D;
      if constexpr (C::resident) {
        // this warp's chunk stays in its stage: rhs in registers, a warp a row
        if (warp < nch) {
          if (it == 0) mbar_wait(&full[warp], 0);
          clk.add(kClkRing);
          float rh[kResCols];
#pragma unroll
          for (int k = 0; k < kResCols; ++k) {
            const int col = lane + 32 * k;
            rh[k] = col < D ? rhs[col] : 0.f;
          }
          const int row = warp * kw, rows = min(kw, R - row);
          const float* w = ring_rows(ring + (size_t)warp * SF, Wb + (size_t)(r0 + row) * D);
          for (int rr = 0; rr < rows; rr += kResGroup) {
            float a[kResGroup];
            reg_dots(w + (size_t)rr * D, D, rows - rr, rh, D, lane, a);
            if (lane == 0)
#pragma unroll
              for (int g = 0; g < kResGroup; ++g)
                if (rr + g < rows) xz[row + rr + g] = a[g];
          }
          if (it + 1 == p.seg) {  // the stage's last read: free it for A and P
            __syncwarp();
            if (lane == 0) mbar_arrive(&empty[warp]);
          }
          clk.add(kClkDot);
        }
      } else {
        const int base = it * nch;
        // this warp's chunks: those whose stage is its own
        for (int j = (warp - base % kWideStages + kWideStages) % kWideStages; j < nch;
             j += kWideStages) {
          mbar_wait(&full[warp], ((base + j) / kWideStages) & 1);
          clk.add(kClkRing);
          const int row = j * kw, rows = min(kw, R - row);
          const float* w = ring_rows(ring + (size_t)warp * SF, Wb + (size_t)(r0 + row) * D);
          for (int rr = 0; rr < rows; ++rr) {
            const float a = row_dot(w + (size_t)rr * D, rhs, D, lane);
            if (lane == 0) xz[row + rr] = a;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[warp]);
          clk.add(kClkDot);
        }
      }
      consumers_sync();  // xz complete
      const bool last = it + 1 == p.seg;
      float* nxt = rb + ((it + 1) & 1) * D;
#pragma unroll
      for (int k = 0; k < C::rows; ++k) {
        const int loc = t + k * kWideConsumers;
        if (loc < R) {
          const int g = r0 + loc;
          float q, c, rinv, rho, lo, hi;
          if constexpr (C::resident) {
            q = cq[k], c = cc[k], rinv = cri[k], rho = crp[k], lo = clo[k], hi = chi[k];
          } else {
            q = qv[vo + g], c = sc[vo + g], rinv = ri[vo + g], rho = rp[vo + g];
            lo = lp[vo + g], hi = up[vo + g];
          }
          const float ysel = rinv * rho;
          const float pre = p.alpha * xz[loc] + p.beta * s[k];
          float sn = pre + rinv * y[k];
          sn = sn < lo ? lo : sn;  // clip as min(max(v, lo), hi); NaN stays NaN
          sn = sn > hi ? hi : sn;
          y[k] = y[k] + rho * (pre - sn);
          s[k] = sn;
          if (!last) {
            const float rhs_new = c * s[k] - q - ysel * y[k];
            for (int r = 0; r < cs; ++r) st_at(nxt + g, r, rhs_new);
          }
        }
      }
      if (!last) {
        if constexpr (C::resident) {
          consumers_sync();
          if (t < cs) mbar_arrive_at(&ready[(it + 1) & 1], t);
        } else {
          for (int r = 0; r < cs; ++r) mbar_arrive_at(&ready[(it + 1) & 1], r);
        }
      }
      clk.add(kClkExch);
    }
    ADMM_PHASE_END(kPhIter);

    ADMM_PHASE_BEGIN(kPhStats);
#pragma unroll
    for (int k = 0; k < C::rows; ++k) {
      const int loc = t + k * kWideConsumers;
      if (loc < R) {
        const int g = r0 + loc;
        s_out[vo + g] = s[k];
        yp_out[vo + g] = y[k];
        for (int r = 0; r < cs; ++r) {
          st_at(sv + g, r, s[k]);
          if (g >= n) st_at(yv + g, r, y[k]);
        }
      }
    }
    if constexpr (C::resident) {
      consumers_sync();  // one arrival a block on each peer
      if (t < cs) mbar_arrive_at(fin, t);
    } else {
      for (int r = 0; r < cs; ++r) mbar_arrive_at(fin, r);
    }
    mbar_wait<true>(fin, 0);
    // x = sv[:n], z = sv[n:], y = yv[n:].  The block's rows of A: Ax (a
    // warp a row) and the A'y partial of every column (a warp a range of
    // columns, lane the columns cw0 + lane + 32 k)
    float v[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const int cw0 = n * warp / kWideConsumerWarps, cw1 = n * (warp + 1) / kWideConsumerWarps;
    float acc[C::aty];
#pragma unroll
    for (int k = 0; k < C::aty; ++k) acc[k] = 0.f;
    int Q = wrounds * nch;
    for (int j = 0; j < nca; ++j, ++Q) {
      const int k = Q % kWideStages;
      mbar_wait(&full[k], (Q / kWideStages) & 1);
      const int i0 = a0 + j * ka, rows = min(ka, na - j * ka);
      const float* st = ring_rows(ring + (size_t)k * SF, Ab + (size_t)i0 * n);
      for (int rr = warp; rr < rows; rr += kWideConsumerWarps) {
        const float a = row_dot(st + (size_t)rr * n, sv, n, lane);
        if (lane == 0) {
          v[0] = nan_max(v[0], fabsf(a - sv[n + i0 + rr]));
          v[2] = nan_max(v[2], fabsf(a));
        }
      }
      for (int rr = 0; rr < rows; ++rr) {
        const float yi = yv[n + i0 + rr];
        const float* row = st + (size_t)rr * n;
#pragma unroll
        for (int c = 0; c < C::aty; ++c) {
          const int col = cw0 + lane + 32 * c;
          if (col < cw1) acc[c] = fmaf(row[col], yi, acc[c]);
        }
      }
      consumers_sync();
      if (t == 0) mbar_arrive(&empty[k]);
    }
    // each column's partial to the block that holds its row of P
#pragma unroll
    for (int c = 0; c < C::aty; ++c) {
      const int col = cw0 + lane + 32 * c;
      if (col < cw1) {
        const int o = prow_owner(col, n, cs);
        st_at(atyp + rank * p.prow_max + (col - n * o / cs), o, acc[c]);
      }
    }
    if constexpr (C::resident) {
      consumers_sync();
      if (t < cs) mbar_arrive_at(aty_bar, t);
    } else {
      for (int r = 0; r < cs; ++r) mbar_arrive_at(aty_bar, r);
    }
    // the block's rows of P: Px, a warp a row
    for (int j = 0; j < ncp; ++j, ++Q) {
      const int k = Q % kWideStages;
      mbar_wait(&full[k], (Q / kWideStages) & 1);
      const int j0 = j * ka, rows = min(ka, np - j0);
      const float* st = ring_rows(ring + (size_t)k * SF, Pb + (size_t)(p0 + j0) * n);
      for (int rr = warp; rr < rows; rr += kWideConsumerWarps) {
        const float a = row_dot(st + (size_t)rr * n, sv, n, lane);
        if (lane == 0) px[j0 + rr] = a;
      }
      consumers_sync();
      if (t == 0) mbar_arrive(&empty[k]);
    }
    // |Ax - z|, |Px + q + A'y|, |Ax|, |z|, |Px|, |A'y|, |q|
    for (int i = t; i < na; i += kWideConsumers) v[3] = nan_max(v[3], fabsf(sv[n + a0 + i]));
    mbar_wait<true>(aty_bar, 0);
    for (int jj = t; jj < np; jj += kWideConsumers) {
      float aty = 0.f;
      for (int r = 0; r < cs; ++r) aty += atyp[r * p.prow_max + jj];
      const float q = qv[vo + p0 + jj], a = px[jj];
      v[1] = nan_max(v[1], fabsf(a + q + aty));
      v[4] = nan_max(v[4], fabsf(a));
      v[5] = nan_max(v[5], fabsf(aty));
      v[6] = nan_max(v[6], fabsf(q));
    }
#pragma unroll
    for (int k = 0; k < 7; ++k)
      for (int o = 16; o > 0; o >>= 1) v[k] = nan_max(v[k], __shfl_xor_sync(0xffffffffu, v[k], o));
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 7; ++k) red[k * kWideConsumerWarps + warp] = v[k];
    consumers_sync();
    if (t == 0) {
      for (int k = 0; k < 7; ++k) {
        float r = red[k * kWideConsumerWarps];
        for (int w = 1; w < kWideConsumerWarps; ++w) r = nan_max(r, red[k * kWideConsumerWarps + w]);
        st_at(gat + rank * 8 + k, 0, r);
      }
      mbar_arrive_at(gather_bar, 0);
      if (rank == 0) {
        mbar_wait<true>(gather_bar, 0);
        float g[7];
        for (int k = 0; k < 7; ++k) {
          g[k] = gat[k];
          for (int r = 1; r < cs; ++r) g[k] = nan_max(g[k], gat[r * 8 + k]);
        }
        float* out = stats + b * 4;
        out[0] = g[0];
        out[1] = g[1];
        out[2] = nan_max(g[2], g[3]);
        out[3] = nan_max(g[4], nan_max(g[5], g[6]));
      }
    }
    clk.flush();
    ADMM_PHASE_END(kPhStats);
  }
  cluster_sync_all();  // no block exits while a peer may still reach its shared memory
  ADMM_PHASE_END(kPhTotal);
}

#define RING_KERNEL_ARGS                                                                      \
  WideParams p, const float *__restrict__ Wg, const float *__restrict__ Pg,                   \
      const float *__restrict__ Ag, const float *__restrict__ qv,                              \
      const float *__restrict__ sc, const float *__restrict__ ri,                              \
      const float *__restrict__ rp, const float *__restrict__ lp,                              \
      const float *__restrict__ up, const float *__restrict__ s_in,                            \
      const float *__restrict__ yp_in, float *__restrict__ s_out, float *__restrict__ yp_out, \
      float *__restrict__ stats, int batch
#define RING_KERNEL_CALL \
  p, Wg, Pg, Ag, qv, sc, ri, rp, lp, up, s_in, yp_in, s_out, yp_out, stats, batch

// D = 1025-2048, and the stream route below: the wide variant
__global__ void __launch_bounds__(kWideThreads, 2) admm_chunk_wide_kernel(RING_KERNEL_ARGS) {
  ring_chunk<WideCfg>(RING_KERNEL_CALL);
}
// D = 2049-2125
__global__ void __launch_bounds__(kWideThreads, 2) admm_chunk_wide_xl_kernel(RING_KERNEL_ARGS) {
  ring_chunk<XlCfg>(RING_KERNEL_CALL);
}
// the cluster route: W on chip for the whole chunk
__global__ void __launch_bounds__(kWideThreads, 2) admm_chunk_cluster_kernel(RING_KERNEL_ARGS) {
  ring_chunk<ResCfg>(RING_KERNEL_CALL);
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

// The wide variant's layout: the cluster (cs > 0 forces it; the rule takes
// the most blocks a problem, up to 8, for which every block has an SM of
// its own: B = 64 takes 2 on 132 SMs, B = 256 one; at D = 2048, B = 64,
// clusters of 4, two blocks an SM with half the ring each, measured
// slower than clusters of 2, PERF.md section 6), two blocks an SM where
// the batch's blocks outnumber the SMs (else one, with a ring twice as
// deep), and the ring's stages of whole rows of W in the shared memory
// that is left.  The stream route at D <= 1024 takes it too.  Python
// mirror of the wide range: ops/admm_kernel.py:admm_chunk_wide_layout.
struct WideLayout {
  int cluster, blocks_per_sm, stage_floats, rows_stage, rows_max, prow_max;
  long long smem_bytes;
};

int wide_cluster_rule(int batch, int sms) {
  int cs = 1;
  while (cs < kWideMaxCluster && 2LL * batch * cs <= sms) cs *= 2;
  return cs;
}

// rhs x 2, s, yp, xz, px, the A'y partials, the maxima: floats a block
long long ring_vec_floats(int n, int D, int cs) {
  const long long fixed = 4LL * D + (D + cs - 1) / cs + (1LL + cs) * ((n + cs - 1) / cs) +
                          8LL * kWideConsumerWarps + 8LL * cs;
  return (fixed + 3) / 4 * 4;
}

WideLayout wide_layout(int n, int m, int batch, int cs, int sms) {
  WideLayout L;
  const int D = n + m;
  L.cluster = cs > 0 ? cs : wide_cluster_rule(batch, sms);
  cs = L.cluster;
  L.rows_max = (D + cs - 1) / cs;
  L.prow_max = (n + cs - 1) / cs;
  const long long vec = ring_vec_floats(n, D, cs);
  L.blocks_per_sm = (long long)batch * cs > sms ? 2 : 1;
  for (;;) {
    const long long budget =
        L.blocks_per_sm == 2 ? kSmemPerSm / 2 - kSmemReservedPerBlock : kMaxSmemBytes;
    const long long sf = ((budget - kWideBarBytes) / 4 - vec) / kWideStages / 4 * 4;
    L.rows_stage = sf > 8 ? (int)((sf - 8) / D) : 0;
    if (L.rows_stage >= 1 || L.blocks_per_sm == 1) break;
    L.blocks_per_sm = 1;
  }
  L.stage_floats = round4(L.rows_stage * D + 8);
  L.smem_bytes = kWideBarBytes + 4LL * ((long long)kWideStages * L.stage_floats + vec);
  return L;
}

// The cluster route's layout at cs blocks a problem: block r's rows of W
// [r D / cs, (r + 1) D / cs) in the ring's eight stages for the whole
// chunk (stage k holds chunk k, the rows_stage = ceil(rows / 8) rows of
// consumer warp k), two blocks an SM where the shared memory allows.
// Fits where a block's shared memory does and its rows are at most one a
// consumer thread.
WideLayout resident_layout(int n, int m, int cs, bool* fits) {
  WideLayout L;
  const int D = n + m;
  L.cluster = cs;
  L.rows_max = (D + cs - 1) / cs;
  L.prow_max = (n + cs - 1) / cs;
  L.rows_stage = (L.rows_max + kWideStages - 1) / kWideStages;
  L.stage_floats = round4(L.rows_stage * D + 8);
  L.smem_bytes = kWideBarBytes + 4LL * ((long long)kWideStages * L.stage_floats +
                                        ring_vec_floats(n, D, cs));
  L.blocks_per_sm = L.smem_bytes <= kSmemPerSm / 2 - kSmemReservedPerBlock ? 2 : 1;
  *fits = D <= kMaxThreads && L.smem_bytes <= kMaxSmemBytes &&
          L.rows_max <= kResRowsThread * kWideConsumers;
  return L;
}

// The cluster route's rule: the fewest blocks a problem (2, 4 or 8: a
// portable cluster) that hold W with two blocks an SM, else the fewest
// that hold it at all; 0 where no portable cluster does.
int resident_cluster_rule(int n, int m) {
  int best = 0;
  for (int cs = 2; cs <= kWideMaxCluster; cs *= 2) {
    bool fits = false;
    const WideLayout L = resident_layout(n, m, cs, &fits);
    if (!fits) continue;
    if (L.blocks_per_sm == 2) return cs;
    if (best == 0) best = cs;
  }
  return best;
}

// K5's one layout rule.  Given D = n + m, n and the batch it picks the
// route and its cluster:
//   narrow   D <= 288: one block a problem, W in shared memory and
//            registers (chunk_layout);
//   cluster  289 <= D <= 1024 where a portable cluster's shared memory
//            holds W (resident_cluster_rule): W on chip for the whole
//            chunk, read from device memory once a launch;
//   stream   past that (D <= 2125): W streamed through the ring every
//            iteration (wide_layout).
// A forced route (route > 0) or cluster (cluster > 0) replaces the rule's
// where it fits: the narrow kernel up to D = 1024 (the rows of W it cannot
// hold read from device memory every iteration), the cluster route at
// 2, 4, 8 or 16 blocks a problem (16: a non-portable cluster), the stream
// route past D = 288 at 1, 2, 4 or 8.  False where the choice does not fit.
enum Route { kRouteRule = 0, kRouteNarrow = 1, kRouteCluster = 2, kRouteStream = 3 };

struct RouteLayout {
  int route, cluster, threads, blocks_per_sm, rows_max, smem_rows, reg_rows, device_rows;
  int stages, rows_stage, stage_floats, prow_max;
  long long smem_bytes;
  ChunkLayout narrow;
};

bool route_layout(int n, int m, int batch, int route, int cluster, int sms, RouteLayout* out) {
  const int D = n + m;
  if (n <= 0 || m <= 0 || D > kMaxD || batch <= 0 || route < kRouteRule ||
      route > kRouteStream || cluster < 0 || cluster > kMaxResidentCluster ||
      (cluster & (cluster - 1)))
    return false;
  int rc = 0;  // the rule's cluster on the cluster route
  if (route == kRouteRule) {
    if (D <= kMaxNarrowD) {
      route = kRouteNarrow;
    } else if (D <= kMaxThreads && (rc = resident_cluster_rule(n, m)) > 0) {
      route = kRouteCluster;
    } else {
      route = kRouteStream;
    }
  }
  RouteLayout& L = *out;
  L.route = route;
  if (route == kRouteNarrow) {
    if (D > kMaxThreads || cluster != 0) return false;
    L.narrow = chunk_layout(n, m);
    L.cluster = 1;
    L.threads = L.narrow.threads;
    L.blocks_per_sm = 0;  // the runtime's (resident)
    L.rows_max = D;
    L.smem_rows = L.narrow.rows_smem;
    L.reg_rows = L.narrow.rows_reg;
    L.device_rows = D - L.smem_rows - L.reg_rows;
    L.stages = L.rows_stage = L.stage_floats = L.prow_max = 0;
    L.smem_bytes = (long long)L.narrow.smem_bytes;
    return true;
  }
  if (D <= kMaxNarrowD) return false;  // the narrow kernel's alone
  WideLayout W;
  if (route == kRouteCluster) {
    const int cs = cluster > 0 ? cluster : rc > 0 ? rc : resident_cluster_rule(n, m);
    bool fits = false;
    if (cs < 1) return false;
    W = resident_layout(n, m, cs, &fits);
    if (!fits) return false;
    L.smem_rows = D;
    L.device_rows = 0;
  } else {
    if (cluster > kWideMaxCluster) return false;
    W = wide_layout(n, m, batch, cluster, sms);
    if (W.rows_stage < 1) return false;
    L.smem_rows = 0;
    L.device_rows = D;
  }
  L.cluster = W.cluster;
  L.threads = kWideThreads;
  L.blocks_per_sm = W.blocks_per_sm;
  L.rows_max = W.rows_max;
  L.reg_rows = 0;
  L.stages = kWideStages;
  L.rows_stage = W.rows_stage;
  L.stage_floats = W.stage_floats;
  L.prow_max = W.prow_max;
  L.smem_bytes = W.smem_bytes;
  return true;
}

typedef void (*RingKernel)(WideParams, const float*, const float*, const float*, const float*,
                           const float*, const float*, const float*, const float*,
                           const float*, const float*, const float*, float*, float*, float*,
                           int);

RingKernel ring_kernel(const RouteLayout& L, int D) {
  if (L.route == kRouteCluster) return admm_chunk_cluster_kernel;
  return D > kMaxWideD ? admm_chunk_wide_xl_kernel : admm_chunk_wide_kernel;
}

// the ring kernel's attributes for this layout: its shared memory, and
// clusters past the portable 8
cudaError_t ring_attributes(RingKernel kernel, const RouteLayout& L) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.smem_bytes);
  if (err == cudaSuccess && L.cluster > kWideMaxCluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

cudaLaunchConfig_t ring_config(const RouteLayout& L, int batch, cudaLaunchAttribute* attr,
                               void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)batch * L.cluster);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = (size_t)L.smem_bytes;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch_ring(const RouteLayout& L, const float* W, const float* P, const float* A,
                const float* qv, const float* scale1, const float* rhoip, const float* rhop,
                const float* lp, const float* up, const float* s, const float* yp, float* s_out,
                float* yp_out, float* stats, int batch, int n, int m, float alpha, float beta,
                int seg, void* stream) {
  const RingKernel kernel = ring_kernel(L, n + m);
  cudaError_t err = ring_attributes(kernel, L);
  if (err != cudaSuccess) return (int)err;
  WideParams p;
  p.n = n;
  p.m = m;
  p.D = n + m;
  p.seg = seg;
  p.cs = L.cluster;
  p.stage_floats = L.stage_floats;
  p.rows_stage = L.rows_stage;
  p.rows_max = L.rows_max;
  p.prow_max = L.prow_max;
  p.alpha = alpha;
  p.beta = beta;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ring_config(L, batch, attr, stream);
  err = cudaLaunchKernelEx(&cfg, kernel, p, W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp,
                           s_out, yp_out, stats, batch);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_narrow(const ChunkLayout& L, const float* W, const float* P, const float* A,
                  const float* qv, const float* scale1, const float* rhoip, const float* rhop,
                  const float* lp, const float* up, const float* s, const float* yp,
                  float* s_out, float* yp_out, float* stats, int batch, int n, int m,
                  float alpha, float beta, int seg, void* stream) {
  auto kernel = L.rows_reg > 0 ? admm_chunk_kernel<kRegRows> : admm_chunk_kernel<0>;
  if (L.smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
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

}  // namespace

extern "C" {

// K5's layout at this shape and batch on a card of `sms` SMs (route and
// cluster 0: the rule's; else forced, as admm_chunk_launch_as takes them),
// in `out`: route (1 narrow, 2 cluster, 3 stream), cluster, threads a
// block, the layout's blocks an SM (0: the runtime's), shared memory bytes
// a block, rows of W a block (at most), rows of W in shared memory for
// the whole chunk (over a problem's blocks), in registers, and read from
// device memory every iteration, the ring's stages, rows of W a stage and
// floats a stage, the blocks an SM the runtime can hold of the kernel at
// that shared memory, rows of P a block (at most), and the clusters the
// card can hold at once (0 on the narrow route).  Returns
// cudaErrorInvalidValue where the choice does not fit.
int admm_chunk_route_layout(int n, int m, int batch, int route, int cluster, int sms,
                            long long* out) {
  RouteLayout L;
  if (sms <= 0 || !route_layout(n, m, batch, route, cluster, sms, &L))
    return (int)cudaErrorInvalidValue;
  int resident = 0, clusters = 0;
  cudaError_t err = cudaSuccess;
  if (L.route == kRouteNarrow) {
    // raised only past the default 48 KB, as launch_narrow does: a lower
    // maximum would refuse a later launch at another shape
    auto kernel = L.narrow.rows_reg > 0 ? admm_chunk_kernel<kRegRows> : admm_chunk_kernel<0>;
    if (L.smem_bytes > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)L.smem_bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, L.threads,
                                                          (size_t)L.smem_bytes);
  } else {
    const RingKernel kernel = ring_kernel(L, n + m);
    err = ring_attributes(kernel, L);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kWideThreads,
                                                          (size_t)L.smem_bytes);
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = ring_config(L, batch, attr, nullptr);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
  }
  const long long v[15] = {L.route,      L.cluster,    L.threads,   L.blocks_per_sm,
                           L.smem_bytes, L.rows_max,   L.smem_rows, L.reg_rows,
                           L.device_rows, L.stages,    L.rows_stage, L.stage_floats,
                           resident,     L.prow_max,   clusters};
  for (int k = 0; k < 15; ++k) out[k] = v[k];
  return (int)err;
}

// One launch of K5 on the route `route` in clusters of `cluster` blocks
// (0: the layout rule's; the card's tests, kernel_ab and chip_smoke.py
// force them), refused (cudaErrorInvalidValue) where the choice does not
// fit (route_layout); the route it took in *taken (where not null: 1
// narrow, 2 cluster, 3 stream, 0 for an empty batch).
int admm_chunk_launch_as(int route, int cluster, const float* W, const float* P, const float* A,
                         const float* qv, const float* scale1, const float* rhoip,
                         const float* rhop, const float* lp, const float* up, const float* s,
                         const float* yp, float* s_out, float* yp_out, float* stats, int batch,
                         int n, int m, float alpha, float beta, int seg, int device,
                         void* stream, int* taken) {
  if (taken) *taken = 0;
  if (batch <= 0) return 0;
  if (seg < 0) return (int)cudaErrorInvalidValue;
  // this library's runtime keeps its own current device: use the tensors'
  cudaError_t err = cudaSetDevice(device);
  int sms = 1;  // the narrow kernel's rule needs no SM count
  if (err == cudaSuccess && (n + m > kMaxNarrowD || route != kRouteRule || cluster != 0))
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  RouteLayout L;
  if (!route_layout(n, m, batch, route, cluster, sms, &L)) return (int)cudaErrorInvalidValue;
  if (taken) *taken = L.route;
  if (L.route == kRouteNarrow)
    return launch_narrow(L.narrow, W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, s_out,
                         yp_out, stats, batch, n, m, alpha, beta, seg, stream);
  return launch_ring(L, W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, s_out, yp_out, stats,
                     batch, n, m, alpha, beta, seg, stream);
}

int admm_chunk_launch(const float* W, const float* P, const float* A, const float* qv,
                      const float* scale1, const float* rhoip, const float* rhop,
                      const float* lp, const float* up, const float* s, const float* yp,
                      float* s_out, float* yp_out, float* stats, int batch, int n, int m,
                      float alpha, float beta, int seg, int device, void* stream) {
  return admm_chunk_launch_as(0, 0, W, P, A, qv, scale1, rhoip, rhop, lp, up, s, yp, s_out,
                              yp_out, stats, batch, n, m, alpha, beta, seg, device, stream,
                              nullptr);
}

}  // extern "C"
