// K13 and K12: the dynamic-time-warping fill of one cost matrix, and the
// batched fill with the backtrace on the card, for Hopper (sm_90a).
//
// `dtw_trace_f32` (K13) replaces `_dtw_kernel`
// (asr_ttl_mtl_tpu/ops/pallas_dtw.py:36, entry `dtw_trace_pallas` :105). x
// is the (N, M) fp32 cost matrix (N text tokens x M frames; callers pass
// -attention). The output is the int8 trace (N+1, M+1), row-major and
// unskewed: for 1 <= i <= N and 1 <= j <= M
//   cost[i, j] = x[i-1, j-1] + min(c0 = cost[i-1, j-1], c1 = cost[i-1, j],
//                                   c2 = cost[i, j-1])
// with t = 0 only if c0 is strictly smallest, t = 1 only if c1 is strictly
// smaller than both, else t = 2 (the tie rule of pallas_dtw.py:18-20,
// :57-60); every other cell is -1. cost[0, 0] = 0 and the rest of row 0 and
// column 0 are +inf. The cell cost is one fp32 add with no multiply, so the
// trace is bit-exact against a plain fp32 wavefront. A NaN cost fails every
// strict comparison and takes t = 2, as XLA's `jnp.where` chain does. K13's
// backtrace walks on the host, as in the JAX package.
//
// `dtw_paths_f32` (K12) replaces `_dtw_kernel_batch` and `_backtrace_one`
// (pallas_dtw.py:141, :175; entries `dtw_paths_batch` :242 and
// `dtw_paths_dispatch` :262). x is (B, N_max, M_max) fp32; row b is filled
// with K13's recurrence inside its own (n[b], m[b]), and no cell outside it
// is read. Then one thread walks the row's trace from (n, m) to (0, 0),
// taking i == 0 as t = 2 and j == 0 as t = 1 (the host walk's priming), and
// writes ti[k] = i-1, tj[k] = j-1 for k = 0, 1, ... (reverse path order) and
// the length to lens[b]. Slots past the length hold 0, as the zeros the JAX
// while_loop starts from.
//
// What bounds them on the H100: the dependency chain, not the bytes. K13
// reads N*M*4 bytes and writes (N+1)*(M+1) (at N=225, M=1500: 1.35 MB and
// 0.34 MB, about 0.5 us at 3.35 TB/s), but diagonal d needs diagonal d-1, so
// the fill is N+M-1 dependent steps. K12's walk adds N+M dependent reads of
// the trace, which the fill has just written and which stays in L2 (16 rows
// x 449 x 1501 bytes is 10.8 MB of the 50 MB).
//
// K13's design, `dtw_wave_kernel`: a register wavefront with no block
// barrier per diagonal. One CTA per matrix. Compute warp w owns 32 R
// consecutive rows, R a lane (R from `k13_plan` in ops/dtw.py: 2 up to 512
// rows, then 4 and 8, so that at most 8 compute warps run up to 2048 rows
// and 16 up to 4096), and at step s computes cell (i, s - i) of each of its
// rows: the whole anti-diagonal s, with every cost in registers.
// cost[i-1, j] comes from the row above: the lane's own previous row, or,
// for its first row, the lane above through __shfl_up_sync; the diagonal
// neighbour is the same value kept from the step before. R rows a lane give
// R independent cells a step, and the shuffle is on the chain once every R
// steps. A warp's first lane takes the row above from the warp above through
// a ring of shared memory, in chunks of C steps (32, 16, 8 or 4 with R): the
// warp above arrives on an mbarrier when a chunk is written and the warp
// below when it has read it, so a warp runs a chunk behind the one above and
// four chunks of the ring bound how far ahead it may run. Only those two
// warps wait for each other. The fill takes about N + M + C * (warps - 1)
// steps, each a shuffle, four compares, three selects and one add on the
// chain.
//   - Each compute warp has 1-4 helper warps, so that no load, store or
//     address of the staging and the trace sits between two steps. The
//     helpers stage the next chunk's skewed window of x for the warp's rows
//     (C consecutive floats of each row: one coalesced read a row) by 4-byte
//     cp.async into a double buffer, and the cells outside the matrix from a
//     two-float table (+inf left of column 1, 0 and +inf on row 0), so the
//     recurrence itself gives cost[i, 0] = inf, cost[0, 0] = 0 and
//     cost[0, j] = inf with no test per cell; cp.async.mbarrier.arrive tells
//     the compute warp when a chunk has landed. The compute warp reads a
//     lane's R values of a step as one vector load.
//   - The compute warp writes a step's R trace bytes as one store into a
//     double-buffered tile, one row of it per step; the helper writes a done
//     chunk out as coalesced row segments (C bytes of a row per
//     instruction), with -1 on row 0 and column 0.
// The 16-byte TMA is not used: a row of x is 4M bytes, not always a multiple
// of 16 (M = 1499), and the window is skewed by one float per row.
//
// K12's design (its own fill, not K13's): one CTA per row of the batch, a thread
// per text index i (N+1 rounded up to a warp; up to kItems indices a thread
// when N+1 > 1024). The cost of the last three anti-diagonals lives in
// shared memory as a ring of three fp32 rows of N+1, with one __syncthreads
// per diagonal: step d writes slot d % 3, which step d-1 read as d-3 before
// the barrier. Each thread loads its x for the next diagonal before the
// barrier, so the load's latency overlaps it. The ring's 48 KB of static
// shared memory bounds N+1 to 4096 (the wrappers check it), in place of the
// JAX VMEM guards (pallas_dtw.py:115-116, :274-275). K12's trace is an int8
// scratch of (B, N_max+1, M_max+1) that the wrapper allocates.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kMaxRows = kThreads * kItems;  // N + 1; 3 x 4096 fp32 = 48 KB

// Fill the trace of one (n, m) matrix: x row i at x + i * ldx, trace row i at
// trace + i * ldt. Ends with a barrier, so the whole block sees the trace.
__device__ void dtw_fill(const float* __restrict__ x, size_t ldx, int8_t* __restrict__ trace, size_t ldt, int n,
                         int m, float (*ring)[kMaxRows]) {
  const int n1 = n + 1;
  const float inf = __int_as_float(0x7f800000);

  // diagonals 0 and 1: cost[0, 0] = 0, cost[0, 1] = cost[1, 0] = inf; their
  // trace cells are -1
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    ring[0][i] = i == 0 ? 0.f : inf;
    ring[1][i] = inf;
    trace[i * ldt] = -1;             // (i, 0), which holds (1, 0)
    if (i == 0 && m >= 1) trace[1] = -1;  // (0, 1)
  }

  // x[i-1, d-i-1] of this thread's cells for the diagonal about to run
  float xn[kItems];
  auto load = [&](int d) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      const int j = d - i;
      xn[k] = (i >= 1 && i <= n && j >= 1 && j <= m) ? __ldg(x + (i - 1) * ldx + (j - 1)) : 0.f;
    }
  };
  load(2);
  __syncthreads();

  for (int d = 2; d <= n + m; ++d) {
    const float* prev2 = ring[(d - 2) % 3];
    const float* prev1 = ring[(d - 1) % 3];
    float* cur = ring[d % 3];
    float xc[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) xc[k] = xn[k];
    if (d < n + m) load(d + 1);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      if (i >= n1) break;
      const int j = d - i;
      if (j < 0 || j > m) continue;  // not on this diagonal's part of the grid
      float c = inf;
      int8_t t = -1;
      if (i >= 1 && j >= 1) {
        const float c0 = prev2[i - 1], c1 = prev1[i - 1], c2 = prev1[i];
        if (c0 < c1 && c0 < c2) {
          c = c0;
          t = 0;
        } else if (c1 < c0 && c1 < c2) {
          c = c1;
          t = 1;
        } else {
          c = c2;
          t = 2;
        }
        c = __fadd_rn(xc[k], c);
      }
      cur[i] = c;
      trace[i * ldt + j] = t;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) dtw_paths_kernel(const float* __restrict__ x, int8_t* __restrict__ trace,
                                                             int* __restrict__ ti, int* __restrict__ tj,
                                                             int* __restrict__ lens, const int* __restrict__ ns,
                                                             const int* __restrict__ ms, int n_max, int m_max) {
  __shared__ float ring[3][kMaxRows];
  const int b = blockIdx.x;
  const int n = ns[b], m = ms[b];
  const int l_max = n_max + m_max;
  const size_t ldt = m_max + 1;
  int8_t* tr = trace + (size_t)b * (n_max + 1) * ldt;
  int* ti_b = ti + (size_t)b * l_max;
  int* tj_b = tj + (size_t)b * l_max;
  for (int k = threadIdx.x; k < l_max; k += blockDim.x) ti_b[k] = tj_b[k] = 0;
  dtw_fill(x + (size_t)b * n_max * m_max, m_max, tr, ldt, n, m, ring);  // ends with a barrier

  if (threadIdx.x == 0) {
    int i = n, j = m, k = 0;
    while (i > 0 || j > 0) {
      ti_b[k] = i - 1;
      tj_b[k] = j - 1;
      ++k;
      const int t = i == 0 ? 2 : j == 0 ? 1 : tr[i * ldt + j];
      i -= t != 2;
      j -= t != 1;
    }
    lens[b] = k;
  }
}

int threads_for(int rows) { return rows <= kThreads ? (rows + 31) / 32 * 32 : kThreads; }

// ------------------------------------------------------------------ K13

namespace wave {

constexpr int kRing = 4;              // chunks of boundary costs between two compute warps
constexpr int kMaxWarps = 16;         // compute warps
// helper warps a compute warp: 4 up to 6 compute warps, 2 up to 10, else 1
// (`k13_plan` mirrors it); each takes every H-th pass of a chunk's rows
__host__ __device__ constexpr int helpers_for(int warps) { return warps <= 6 ? 4 : warps <= 10 ? 2 : 1; }
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t saddr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}
// an arrive on `bar` once every cp.async this thread started has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(saddr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The chunk of steps for R rows a lane (`k13_plan` mirrors it): the
// buffers of 8 compute warps fit a block at 32, 16 and 8 steps; 16 warps
// of 8 rows a lane take 4.
__host__ __device__ constexpr int chunk_for(int rows_per_lane, int warps) {
  return rows_per_lane == 2 ? 32 : rows_per_lane == 4 ? 16 : warps <= 8 ? 8 : 4;
}
// Shared memory of one compute warp and its helpers: 16 mbarriers, the ring
// of the warp's last row's costs, x's double buffer [2][C][32R + 4] fp32
// and the trace tile's [2][C][32R + 4] int8 (the +4 keeps the helper's
// column reads of the tile apart in the banks)
__host__ __device__ constexpr int warp_bytes(int rows_per_lane, int chunk) {
  return 16 * 8 + kRing * chunk * 4 + 2 * chunk * (32 * rows_per_lane + 4) * 5;
}

// Compute warp w (w < W) owns rows 32 R w .. + 32 R - 1 of the cost matrix
// (row 0 the border, row i >= 1 text token i - 1), R consecutive rows a
// lane, and at step s computes cell (i, s - i) of each: the anti-diagonal s.
// Helper warps W + H w .. + H - 1 stage its x and write its trace, each
// every H-th pass of 32 / C rows (H from `helpers_for`). Steps run in chunks of C, from the chunk
// holding the warp's column 0 to the one holding its last row's column M.
template <int R, int C, int H>
__global__ void __launch_bounds__(1024) dtw_wave_kernel(const float* __restrict__ x, int8_t* __restrict__ trace,
                                                        int n, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = 32 * R + 4;              // row of x's buffer (fp32) and of the trace tile (int8)
  constexpr int kPass = 32 / C;               // rows a helper pass covers: lane l takes step l % C
  constexpr int kPasses = 32 * R / kPass / H;  // passes of each helper a chunk
  const int n_warps = blockDim.x / (32 * (1 + H)), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp < n_warps ? warp : (warp - n_warps) / H;  // the compute warp this warp is or serves
  constexpr int per_warp = warp_bytes(R, C);
  auto bars_of = [&](int v) { return reinterpret_cast<uint64_t*>(smem + v * per_warp); };
  uint64_t* bars = bars_of(w);
  uint64_t *full = bars, *done = bars + kRing;           // between compute warps w and w + 1, w - 1 and w
  uint64_t *x_full = bars + 8, *x_empty = bars + 10;     // helper -> compute, compute -> helper
  uint64_t *t_full = bars + 12, *t_empty = bars + 14;    // compute -> helper, helper -> compute
  float* bnd = reinterpret_cast<float*>(bars + 16);
  float* xs = bnd + kRing * C;                           // [2][C][LD]
  int8_t* tile = reinterpret_cast<int8_t*>(xs + 2 * C * LD);  // [2][C][LD]
  constexpr int ring_mask = kRing * C - 1;

  if (warp < n_warps && lane == 0) {
    for (int k = 0; k < kRing; ++k) {
      mbar_init(&full[k], 1);
      mbar_init(&done[k], 1);
    }
    mbar_init(&x_full[0], 32 * H);  // a cp.async arrive of each helper lane
    mbar_init(&x_full[1], 32 * H);
    mbar_init(&x_empty[0], 32);
    mbar_init(&x_empty[1], 32);
    mbar_init(&t_full[0], 32);
    mbar_init(&t_full[1], 32);
    mbar_init(&t_empty[0], 32 * H);
    mbar_init(&t_empty[1], 32 * H);
  }
  __syncthreads();

  const int r0 = w * 32 * R, rl = min(r0 + 32 * R, n + 1) - 1;
  const int k0 = r0 / C, k1 = (rl + m) / C;  // the warp's chunks

  if (warp >= n_warps) {  // a helper: stage chunk k + 1, then write chunk k's trace
    const int h = (warp - n_warps) % H, l_step = lane % C, l_row = lane / C;
    const int last_row = n - r0;  // rows rr <= last_row exist
    // In a chunk whose columns j - 1 all lie in [0, m) no cell of x is off
    // the matrix's sides and no trace cell is in column 0: then only the
    // row count is checked. Elsewhere, every cell.
    auto inside = [&](int kc) { return kc * C - (r0 + 32 * R - 1) >= 1 && kc * C + C - 1 - r0 <= m; };
    auto stage = [&](int kc) {
      const int it = kc - k0, b = it & 1;
      mbar_wait(&x_empty[b], ((it >> 1) & 1) ^ 1);
      const int s = kc * C + l_step;
      float* dst = xs + b * C * LD + l_step * LD;
      // x[i-1, j-1] of row r0 + rr, column j = s - r0 - rr: x0 + rr (m - 1)
      const float* x0 = x + ((long long)(r0 - 1) * m + (s - r0 - 1));
      const bool fast = inside(kc);
#pragma unroll
      for (int q = 0; q < kPasses; ++q) {
        const int rr = l_row + kPass * (h + H * q), j = s - r0 - rr;
        const bool valid = rr <= last_row && r0 + rr >= 1 && (fast || (j >= 1 && j <= m));
        // off the matrix: zeros (the compute warp puts the border's +inf on them)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst + rr)),
                     "l"(valid ? x0 + (long long)rr * (m - 1) : x), "r"(valid ? 4 : 0)
                     : "memory");
      }
      mbar_arrive_cp_async(&x_full[b]);
    };
    stage(k0);
    for (int kc = k0; kc <= k1; ++kc) {
      if (kc < k1) stage(kc + 1);
      const int it = kc - k0, b = it & 1;
      mbar_wait(&t_full[b], (it >> 1) & 1);
      const int s = kc * C + l_step;
      const int8_t* src = tile + b * C * LD + l_step * LD;
      int8_t* t0 = trace + ((long long)r0 * (m + 1) + (s - r0));  // row r0 + rr, column s - r0 - rr: t0 + rr m
      const bool fast = inside(kc);
#pragma unroll
      for (int q = 0; q < kPasses; ++q) {
        const int rr = l_row + kPass * (h + H * q), j = s - r0 - rr;
        if (rr <= last_row && (fast || (j >= 0 && j <= m)))
          t0[(long long)rr * m] = (r0 + rr == 0 || (!fast && j == 0)) ? (int8_t)-1 : src[rr];
      }
      mbar_arrive(&t_empty[b]);
    }
    return;
  }

  // the compute warp
  const float* bnd_up = reinterpret_cast<const float*>(bars_of(w > 0 ? w - 1 : 0) + 16);
  uint64_t* full_up = bars_of(w > 0 ? w - 1 : 0);
  uint64_t* done_down = bars_of(w + 1 < n_warps ? w + 1 : w) + kRing;
  const bool below = w + 1 < n_warps;
  const int up_k1 = (r0 - 1 + m) / C;        // the warp above's last chunk
  const int down_k0 = (r0 + 32 * R) / C;     // the warp below's first chunk
  const float inf = __int_as_float(0x7f800000);

  float cur[R], old[R];  // this lane's costs on the last two diagonals
  // the border: x is taken as +inf at the steps s with lo <= s <= hi, left
  // of column 1 (s <= i) on row i >= 1 and right of column 0 (s >= 1) on
  // row 0, where the helper staged zeros; so cost[i, 0] = inf, cost[0, 0]
  // = 0 and cost[0, j] = inf with the recurrence unchanged
  int lo[R];
  unsigned span[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = r0 + lane * R + k;
    lo[k] = i == 0 ? 1 : -(1 << 30);
    span[k] = (unsigned)((i == 0 ? (1 << 30) : i) - lo[k]);
    cur[k] = old[k] = i == 0 ? 0.f : inf;
  }
  float up_old = inf;  // the row above's cost on the diagonal before last

  for (int kc = k0; kc <= k1; ++kc) {
    const int it = kc - k0, b = it & 1;
    mbar_wait(&x_full[b], (it >> 1) & 1);
    mbar_wait(&t_empty[b], ((it >> 1) & 1) ^ 1);
    // the full and done barriers count chunks from the lower warp's first
    // one, so neither side's wait is ever two phases from the barrier's
    if (w > 0 && kc <= up_k1) mbar_wait(&full_up[(kc - k0) % kRing], ((kc - k0) / kRing) & 1);
    const int freed = kc - kRing + 1;  // the warp below must have read this chunk before its slots are rewritten
    if (below && freed >= down_k0)
      mbar_wait(&done_down[(freed - down_k0) % kRing], ((freed - down_k0) / kRing) & 1);

    const float* xb = xs + b * C * LD + lane * R;
    int8_t* tb = tile + b * C * LD + lane * R;
    int from_lo[R];
#pragma unroll
    for (int k = 0; k < R; ++k) from_lo[k] = kc * C - lo[k];
    // a step's x and the warp above's cost are loaded a step ahead, before
    // the step's stores, so that no load's latency sits on the chain
    float xn[R];
    auto load_x = [&](int l) {
#pragma unroll
      for (int k = 0; k < R; k += 2) {
        const float2 v = *reinterpret_cast<const float2*>(xb + l * LD + k);
        xn[k] = v.x;
        xn[k + 1] = v.y;
      }
    };
    load_x(0);
    float bn = w > 0 ? bnd_up[(kc * C - 1) & ring_mask] : inf;
#pragma unroll
    for (int l = 0; l < C; ++l) {
      const int s = kc * C + l;
      float xv[R];
#pragma unroll
      for (int k = 0; k < R; ++k) xv[k] = (unsigned)(from_lo[k] + l) <= span[k] ? inf : xn[k];
      const float from_warp = bn;
      if (l + 1 < C) {
        load_x(l + 1);
        bn = w > 0 ? bnd_up[s & ring_mask] : inf;
      }
      // the shuffle first, then rows R-1 .. 1, whose inputs are this lane's
      // own, while it is in flight, then row 0 from the lane above
      const float from_lane = __shfl_up_sync(kFull, cur[R - 1], 1);
      float nw[R];
      uint32_t packed[(R + 3) / 4] = {};
      auto cell = [&](int k, float c0, float c1) {
        const float c2 = cur[k];
        const bool t0 = c0 < c1 && c0 < c2, t1 = c1 < c0 && c1 < c2;
        packed[k / 4] |= (uint32_t)(t0 ? 0 : t1 ? 1 : 2) << (8 * (k % 4));
        nw[k] = __fadd_rn(xv[k], t0 ? c0 : t1 ? c1 : c2);
      };
#pragma unroll
      for (int k = R - 1; k >= 1; --k) cell(k, old[k - 1], cur[k - 1]);
      const float up = lane == 0 ? from_warp : from_lane;
      cell(0, up_old, up);
      up_old = up;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        old[k] = cur[k];
        cur[k] = nw[k];
      }
      if (R == 2) {
        *reinterpret_cast<uint16_t*>(tb + l * LD) = (uint16_t)packed[0];
      } else {
#pragma unroll
        for (int k = 0; k < R / 4; ++k) *reinterpret_cast<uint32_t*>(tb + l * LD + 4 * k) = packed[k];
      }
      if (lane == 31) bnd[s & ring_mask] = cur[R - 1];
    }
    mbar_arrive(&x_empty[b]);
    mbar_arrive(&t_full[b]);
    if (below && lane == 31 && kc >= down_k0) mbar_arrive(&full[(kc - down_k0) % kRing]);
    if (w > 0 && lane == 0) mbar_arrive(&done[(kc - k0) % kRing]);
  }
}

template <int R, int C, int H>
int launch(const float* x, int8_t* trace, int n, int m, int warps, cudaStream_t stream) {
  const int smem = warps * warp_bytes(R, C);
  if (warps < 1 || warps > kMaxWarps || (warps - 1) * 32 * R >= n + 1 || warps * 32 * R < n + 1 ||
      chunk_for(R, warps) != C || helpers_for(warps) != H || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static bool lifted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !lifted[dev]) {  // once a device, not on every launch
    err = cudaFuncSetAttribute(dtw_wave_kernel<R, C, H>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) lifted[dev] = true;
  }
  dtw_wave_kernel<R, C, H><<<1, warps * (1 + H) * 32, smem, stream>>>(x, trace, n, m);
  return (int)cudaGetLastError();
}

// The latency of one dependent step of the wavefront, for the chain bound:
// one warp runs `iters` steps of a lane's recurrence (the shuffle from the
// lane above, the compares, the selects and the add), each on the last.
__global__ void chain_probe_kernel(float* out, int iters) {
  const int lane = threadIdx.x & 31;
  const float xv = 1e-3f * (float)lane;
  float cur = (float)lane, up_old = 0.f;
  for (int s = 0; s < iters; ++s) {
    const float from_lane = __shfl_up_sync(kFull, cur, 1);
    const float up = lane == 0 ? cur : from_lane;
    const bool t0 = up_old < up && up_old < cur, t1 = up < up_old && up < cur;
    const float c = t0 ? up_old : t1 ? up : cur;
    up_old = up;
    cur = __fadd_rn(xv, c);
  }
  out[threadIdx.x] = cur;
}

}  // namespace wave

}  // namespace

// K13; rows_per_lane (2, 4 or 8) and warps (compute warps) from `k13_plan`
extern "C" int dtw_trace_f32(const void* x, void* trace, int n, int m, int rows_per_lane, int warps, void* stream) {
  if (n < 1 || m < 1 || n + 1 > kMaxRows) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  int8_t* tp = static_cast<int8_t*>(trace);
  const cudaStream_t st = (cudaStream_t)stream;
  const int h = wave::helpers_for(warps);
  switch (rows_per_lane * 8 + h) {  // the instantiations `k13_plan` can ask for
    case 2 * 8 + 4: return wave::launch<2, 32, 4>(xp, tp, n, m, warps, st);
    case 2 * 8 + 2: return wave::launch<2, 32, 2>(xp, tp, n, m, warps, st);
    case 4 * 8 + 4: return wave::launch<4, 16, 4>(xp, tp, n, m, warps, st);
    case 4 * 8 + 2: return wave::launch<4, 16, 2>(xp, tp, n, m, warps, st);
    case 8 * 8 + 4: return wave::launch<8, 8, 4>(xp, tp, n, m, warps, st);
    case 8 * 8 + 2:
      return warps <= 8 ? wave::launch<8, 8, 2>(xp, tp, n, m, warps, st) : wave::launch<8, 4, 2>(xp, tp, n, m, warps, st);
    case 8 * 8 + 1: return wave::launch<8, 4, 1>(xp, tp, n, m, warps, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K13's chain bound: one warp, `iters` dependent steps; out holds 32 floats
extern "C" int dtw_chain_probe(void* out, int iters, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  wave::chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

extern "C" int dtw_paths_f32(const void* x, void* trace, void* ti, void* tj, void* lens, const void* ns,
                             const void* ms, int batch, int n_max, int m_max, void* stream) {
  if (batch < 1 || n_max < 0 || m_max < 0 || n_max + 1 > kMaxRows || n_max + m_max < 1)
    return (int)cudaErrorInvalidValue;
  dtw_paths_kernel<<<batch, threads_for(n_max + 1), 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(trace), static_cast<int*>(ti), static_cast<int*>(tj),
      static_cast<int*>(lens), static_cast<const int*>(ns), static_cast<const int*>(ms), n_max, m_max);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
