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
// is read. Then the row's trace is walked from (n, m) to (0, 0), taking
// i == 0 as t = 2 and j == 0 as t = 1 (the host walk's priming), and
// ti[k] = i-1, tj[k] = j-1 are written for k = 0, 1, ... (reverse path
// order) and the length to lens[b]. Slots past the length hold 0, as the
// zeros the JAX while_loop starts from. K12's trace is an int8 scratch of
// (B, N_max+1, M_max+1) that the wrapper allocates.
//
// What bounds them on the H100: the dependency chain, not the bytes. K13
// reads N*M*4 bytes and writes (N+1)*(M+1) (at N=225, M=1500: 1.35 MB and
// 0.34 MB, about 0.5 us at 3.35 TB/s), but diagonal d needs diagonal d-1, so
// the fill is N+M-1 dependent steps. K12's walk adds up to N+M dependent
// steps, each a read of the trace the fill has just written.
//
// The fill, `dtw_wave_kernel`: a register wavefront with no block barrier
// per diagonal. One CTA per matrix (K13) or per row of the batch (K12).
// Compute warp w owns 32 R
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
// K12 runs the same kernel with the plan of N_max. Each CTA reads its row's
// n and m; x's row stride is M_max and the trace's M_max + 1, apart from the
// row's own m. Compute warps whose rows all lie below n (and their helpers)
// skip the fill, and the last live compute warp has no warp below it. A row
// with n == 0 or m == 0 has no cell to fill and its walk reads no trace.
//
// K12's walk, `walk_paths`: the next steps from (i, j) stay inside the box
// [i - BR + 1, i] x [j - BC + 1, j], so the whole block copies that box of
// the trace into shared memory in one round trip, as each cell's move (up,
// left or diagonal; none on a sentinel row above the box, a sentinel column
// left of it, and at (0, 0)). A trace row is M_max + 1 bytes, odd at the
// words run's M_max, so each box row is read as aligned 4-byte words, the
// last holding column j, and the up to three cells left of the first word
// count as sentinels (K12's trace scratch has 4 bytes past its end for the
// last word). The block then chains each cell's next four steps (their 2-bit
// codes and the cell they reach), and one thread walks with one
// shared-memory load and one add per four steps until it lands on a
// sentinel or on (0, 0), staging each group's first cell and codes; the
// block expands the groups into (ti, tj) while it loads the next box. The
// box holds 4096 cells, BR x (BC + 1) with BR = 4 .. 128, shaped by the
// row's n / m so that the path leaves it as late as it can: a few boxes a
// row, in place of one dependent read of L2 a step. A larger box loads
// more cells the path never visits, a smaller one takes more round trips
// and barriers. The walk is a function of its own, not inlined, so that
// its registers do not press on the fill's loop, and its shared memory lies
// behind the fill's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

namespace wave {

constexpr int kRing = 4;              // chunks of boundary costs between two compute warps
constexpr int kMaxWarps = 16;         // compute warps
constexpr int kMaxRows = kMaxWarps * 32 * 8;  // N + 1
// helper warps a compute warp: 4 up to 6 compute warps, 2 up to 10, else 1
// (`k13_plan` mirrors it); each takes every H-th pass of a chunk's rows
__host__ __device__ constexpr int helpers_for(int warps) { return warps <= 6 ? 4 : warps <= 10 ? 2 : 1; }
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

// K12's walk: a box of kBoxCells cells, (kBoxCells / LD) rows of LD (LD =
// 32 .. 1024, the first column a sentinel) under a sentinel row, twice: each
// cell's move and code (int16) and its next four steps (8 bytes); the
// staged groups of four steps of one box (at most (rows + LD - 2) / 4 + 1);
// the box's next anchor and group count. It lies behind the fill's shared
// memory, within a block's at every plan (8 compute warps of 2 rows a lane:
// 179200 + 52304 bytes).
constexpr int kBoxCells = 4096;
constexpr int kMaxLd = 1024;
constexpr int kGroups = 272;
constexpr int kWalkBytes = (kBoxCells + kMaxLd) * (2 + 8) + kGroups * 4 + 16;
// K12's block: the warps past the fill's only walk, and a box loads in one round trip
constexpr int kWalkThreads = 1024;
constexpr int kWordsInFlight = 4;   // 4-byte words of the box a thread reads before it writes any
constexpr int kChains = 4;          // cells a thread chains four steps on from at once

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
__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
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
// K13's plan (`k13_plan`): 2, 4 or 8 rows a lane, the fewest that keep to 8
// compute warps, and the compute warps for N + 1 rows
__host__ __device__ constexpr int rows_per_lane_for(int rows) { return rows <= 512 ? 2 : rows <= 1024 ? 4 : 8; }

// K12's batch: row b's lengths, its path's outputs, and the batch's shape
struct Batch {
  const int* ns;
  const int* ms;
  int* ti;
  int* tj;
  int* lens;
  int n_max, m_max;
};

// K12's walk of one row's trace (row i at trace + i * ldt) from (n, m) to
// (0, 0), box by box, with its shared memory at `offset`, behind the
// fill's; the whole block calls it after the trace is written. A box is
// copied in as each cell's move in cells and its code (0 stop, 1 left, 2
// up, 3 diagonal; a stop at a sentinel and at (0, 0)); then each cell's
// next four steps are chained from those, as their codes (a stop repeats)
// and the byte offset of the cell four steps on; one thread walks with one
// load and one add per four steps, staging each group's first cell and
// codes, until a group ends on a stop: a sentinel (the next box's anchor)
// or (0, 0). The block expands the groups into (ti, tj). Not inlined: its
// registers are its own, and the fill's loop keeps K13's.
__device__ __noinline__ void walk_paths(const int8_t* trace, int ldt, int n, int m, int* ti, int* tj, int* len,
                                        int l_max, int offset) {
  extern __shared__ __align__(16) unsigned char walk_smem[];
  int16_t* mv = reinterpret_cast<int16_t*>(walk_smem + offset);    // [kMaxLd + kBoxCells]
  uint2* four = reinterpret_cast<uint2*>(mv + kMaxLd + kBoxCells);  // [kMaxLd + kBoxCells]
  uint32_t* groups = reinterpret_cast<uint32_t*>(four + kMaxLd + kBoxCells);  // cell | codes << 16
  int* ctl = reinterpret_cast<int*>(groups + kGroups);
  const int tid = threadIdx.x, nt = blockDim.x;
  // the box with the fewest boxes over the whole path: max(n / BR, m / (LD - 1))
  int lg = 10;
  float fewest = __int_as_float(0x7f800000);
  for (int g = 10; g >= 5; --g) {
    const float boxes = fmaxf((float)n / (kBoxCells >> g), (float)m / ((1 << g) - 1));
    if (boxes < fewest) {
      fewest = boxes;
      lg = g;
    }
  }
  const int ld = 1 << lg, br = kBoxCells >> lg, cells = kBoxCells;
  for (int c = tid; c < ld; c += nt) {  // the sentinel row
    mv[c] = 0;
    four[c] = make_uint2(0, 0);
  }
  const uint32_t base = saddr(four);

  int ai = n, aj = m, k = 0, n_groups = 0, pi = 0, pj = 0;  // the box's anchor, steps so far, the last box's
  while (true) {
    // the last box's groups, four steps each but the last: shared (r, c) is
    // cell (pi - br + r, pj - ld + 1 + c)
    for (int q = tid; q < n_groups; q += nt) {
      const uint32_t g = groups[q];
      int gi = pi - br + (int)((g & 0xffff) >> lg), gj = pj - ld + 1 + (int)(g & (ld - 1));
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t code = (g >> (16 + 2 * u)) & 3;
        if (code == 0) break;
        ti[k + 4 * q + u] = gi - 1;
        tj[k + 4 * q + u] = gj - 1;
        gi -= code >> 1;
        gj -= code != 2;
      }
    }
    if (n_groups > 0) {  // four steps a group but the last, whose steps are its nonzero codes
      const uint32_t last = groups[n_groups - 1] >> 16;
      k += 4 * (n_groups - 1) + __popc((last | last >> 1) & 0x55);
    }
    if (ai == 0 && aj == 0) break;
    // the box whose bottom right cell is (ai, aj): shared (r, c) holds cell
    // (oi + r, oj + c) for r >= 1, c >= 1, as its move in cells << 2 | its
    // code. Row r is read as ld / 4 aligned words, the last holding
    // (oi + r, aj); the cells left of the first word are stops
    const int oi = ai - br, oj = aj - ld + 1, wpr = ld >> 2, words = cells >> 2;
    for (int w0 = tid; w0 < words; w0 += kWordsInFlight * nt) {
      uint32_t v[kWordsInFlight];
#pragma unroll
      for (int u = 0; u < kWordsInFlight; ++u) {
        const int w = w0 + u * nt, gi = oi + (w >> (lg - 2)) + 1, q = w & (wpr - 1);
        const unsigned long long end = (unsigned long long)(trace + (long long)gi * ldt + aj);
        const unsigned long long at = (end & ~3ull) - 4ull * (wpr - 1 - q);
        const int gj0 = aj - (int)(end - at);  // the column of the word's first byte
        v[u] = w < words && gi >= 1 && gj0 + 3 >= 1 ? *reinterpret_cast<const uint32_t*>(at) : 0u;
      }
#pragma unroll
      for (int u = 0; u < kWordsInFlight; ++u) {
        const int w = w0 + u * nt, r = (w >> (lg - 2)) + 1, gi = oi + r, q = w & (wpr - 1);
        if (w >= words) break;
        const unsigned long long end = (unsigned long long)(trace + (long long)gi * ldt + aj);
        const int gj0 = aj - (int)(end - ((end & ~3ull) - 4ull * (wpr - 1 - q)));
        int16_t* row = mv + r * ld;
        if (q == 0)  // the sentinel column and the cells before the first word
          for (int c = 0; c < max(gj0 - oj, 1); ++c) row[c] = 0;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int gj = gj0 + b, c = gj - oj, t = (int8_t)(v[u] >> (8 * b));
          if (c < 1 || c > ld - 1) continue;
          int e = 0;  // a stop: (0, 0), or a cell the walk cannot reach
          if (gi >= 0 && gj >= 0 && (gi | gj) != 0)  // row 0 moves left, column 0 up
            e = gi == 0 || (gj != 0 && t == 2) ? -4 + 1 : gj == 0 || t == 1 ? -4 * ld + 2 : -4 * (ld + 1) + 3;
          row[c] = (int16_t)e;
        }
      }
    }
    __syncthreads();
    for (int c0 = ld + tid; c0 < ld + cells; c0 += kChains * nt) {  // four steps on from each cell
      int at[kChains];
      uint32_t codes[kChains] = {};
#pragma unroll
      for (int u = 0; u < kChains; ++u) at[u] = c0 + u * nt < ld + cells ? c0 + u * nt : c0;
#pragma unroll
      for (int step = 0; step < 4; ++step) {
#pragma unroll
        for (int u = 0; u < kChains; ++u) {
          const int e = mv[at[u]];
          codes[u] |= (uint32_t)(e & 3) << (2 * step);
          at[u] += e >> 2;
        }
      }
#pragma unroll
      for (int u = 0; u < kChains; ++u)
        if (c0 + u * nt < ld + cells) four[c0 + u * nt] = make_uint2(codes[u], (uint32_t)(8 * (at[u] - c0 - u * nt)));
    }
    __syncthreads();
    if (tid == 0) {
      uint32_t a = base + 8 * (br * ld + ld - 1);  // (ai, aj)
      int q = 0;
      uint2 e;
      do {
        e = lds64(a);
        groups[q++] = ((a - base) >> 3) | (e.x << 16);
        a += e.y;
      } while (e.x >> 6);  // the fourth step moved: the next group starts at a
      const int off = (a - base) >> 3;  // a sentinel (the next box's anchor) or (0, 0)
      ctl[0] = oi + (off >> lg);
      ctl[1] = oj + (off & (ld - 1));
      ctl[2] = q;
    }
    __syncthreads();
    pi = ai;
    pj = aj;
    ai = ctl[0];
    aj = ctl[1];
    n_groups = ctl[2];
  }
  for (int q = k + tid; q < l_max; q += nt) ti[q] = tj[q] = 0;
  if (tid == 0) *len = k;
}

// Compute warp w (w < W) owns rows 32 R w .. + 32 R - 1 of the cost matrix
// (row 0 the border, row i >= 1 text token i - 1), R consecutive rows a
// lane, and at step s computes cell (i, s - i) of each: the anti-diagonal s.
// Helper warps W + H w .. + H - 1 stage its x and write its trace, each
// every H-th pass of 32 / C rows (H from `helpers_for`). Steps run in chunks of C, from the chunk
// holding the warp's column 0 to the one holding its last row's column M.
// K13 (kPaths false): one (n, m) matrix, x's row stride m and the trace's
// m + 1. K12 (kPaths true): row blockIdx.x of `batch`, then its walk, with
// warps past the fill's W (H + 1) that only walk.
template <int R, int C, int H, bool kPaths>
__global__ void __launch_bounds__(1024) dtw_wave_kernel(const float* __restrict__ x, int8_t* __restrict__ trace,
                                                        int n, int m, int n_warps, Batch batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int LD = 32 * R + 4;              // row of x's buffer (fp32) and of the trace tile (int8)
  constexpr int kPass = 32 / C;               // rows a helper pass covers: lane l takes step l % C
  constexpr int kPasses = 32 * R / kPass / H;  // passes of each helper a chunk
  int ldx = m, ldt = m + 1;  // 32-bit strides: each row offset is one wide multiply-add
  if constexpr (kPaths) {
    const int b = blockIdx.x;
    n = batch.ns[b];
    m = batch.ms[b];
    ldx = batch.m_max;
    ldt = batch.m_max + 1;
    x += (long long)b * batch.n_max * ldx;
    trace += (long long)b * (batch.n_max + 1) * ldt;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = warp < n_warps ? warp : (warp - n_warps) / H;  // the compute warp this warp is or serves
  const int live = (n + 32 * R) / (32 * R);  // compute warps that hold a row of the matrix
  const bool fills = n >= 1 && m >= 1 && warp < n_warps * (1 + H) && w < live;
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

  if (fills && warp >= n_warps) {  // a helper: stage chunk k + 1, then write chunk k's trace
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
      // x[i-1, j-1] of row r0 + rr, column j = s - r0 - rr: x0 + rr (ldx - 1)
      const float* x0 = x + ((long long)(r0 - 1) * ldx + (s - r0 - 1));
      const bool fast = inside(kc);
#pragma unroll
      for (int q = 0; q < kPasses; ++q) {
        const int rr = l_row + kPass * (h + H * q), j = s - r0 - rr;
        const bool valid = rr <= last_row && r0 + rr >= 1 && (fast || (j >= 1 && j <= m));
        // off the matrix: zeros (the compute warp puts the border's +inf on them)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(saddr(dst + rr)),
                     "l"(valid ? x0 + (long long)rr * (ldx - 1) : x), "r"(valid ? 4 : 0)
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
      // row r0 + rr, column s - r0 - rr: t0 + rr (ldt - 1)
      int8_t* t0 = trace + ((long long)r0 * ldt + (s - r0));
      const bool fast = inside(kc);
#pragma unroll
      for (int q = 0; q < kPasses; ++q) {
        const int rr = l_row + kPass * (h + H * q), j = s - r0 - rr;
        if (rr <= last_row && (fast || (j >= 0 && j <= m)))
          t0[(long long)rr * (ldt - 1)] = (r0 + rr == 0 || (!fast && j == 0)) ? (int8_t)-1 : src[rr];
      }
      mbar_arrive(&t_empty[b]);
    }
  } else if (fills) {  // the compute warp
    const float* bnd_up = reinterpret_cast<const float*>(bars_of(w > 0 ? w - 1 : 0) + 16);
    uint64_t* full_up = bars_of(w > 0 ? w - 1 : 0);
    const bool below = w + 1 < live;
    uint64_t* done_down = bars_of(below ? w + 1 : w) + kRing;
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

  if constexpr (kPaths) {
    __syncthreads();  // the row's trace is written
    const int b = blockIdx.x, l_max = batch.n_max + batch.m_max;
    walk_paths(trace, ldt, n, m, batch.ti + (long long)b * l_max, batch.tj + (long long)b * l_max,
               batch.lens + b, l_max, n_warps * per_warp);
  }
}

// One launch of the fill: K13's (kPaths false, one CTA) or K12's (one CTA a
// row of the batch, the plan from n_max); n is the rows the plan covers.
template <int R, int C, int H, bool kPaths>
int launch(const float* x, int8_t* trace, int n, int m, int warps, const Batch& batch, int grid,
           cudaStream_t stream) {
  const int smem = warps * warp_bytes(R, C) + (kPaths ? kWalkBytes : 0);
  if (warps < 1 || warps > kMaxWarps || (warps - 1) * 32 * R >= n + 1 || warps * 32 * R < n + 1 ||
      chunk_for(R, warps) != C || helpers_for(warps) != H || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  static bool lifted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !lifted[dev]) {  // once a device, not on every launch
    err = cudaFuncSetAttribute(dtw_wave_kernel<R, C, H, kPaths>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) lifted[dev] = true;
  }
  const int fill_threads = warps * (1 + H) * 32;
  const int threads = kPaths ? kWalkThreads : fill_threads;
  dtw_wave_kernel<R, C, H, kPaths><<<grid, threads, smem, stream>>>(x, trace, n, m, warps, batch);
  return (int)cudaGetLastError();
}

// the instantiations `k13_plan` can ask for
template <bool kPaths>
int dispatch(const float* x, int8_t* trace, int n, int m, int rows_per_lane, int warps, const Batch& batch,
             int grid, cudaStream_t st) {
  switch (rows_per_lane * 8 + helpers_for(warps)) {
    case 2 * 8 + 4: return launch<2, 32, 4, kPaths>(x, trace, n, m, warps, batch, grid, st);
    case 2 * 8 + 2: return launch<2, 32, 2, kPaths>(x, trace, n, m, warps, batch, grid, st);
    case 4 * 8 + 4: return launch<4, 16, 4, kPaths>(x, trace, n, m, warps, batch, grid, st);
    case 4 * 8 + 2: return launch<4, 16, 2, kPaths>(x, trace, n, m, warps, batch, grid, st);
    case 8 * 8 + 4: return launch<8, 8, 4, kPaths>(x, trace, n, m, warps, batch, grid, st);
    case 8 * 8 + 2:
      return warps <= 8 ? launch<8, 8, 2, kPaths>(x, trace, n, m, warps, batch, grid, st)
                        : launch<8, 4, 2, kPaths>(x, trace, n, m, warps, batch, grid, st);
    case 8 * 8 + 1: return launch<8, 4, 1, kPaths>(x, trace, n, m, warps, batch, grid, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
  if (n < 1 || m < 1 || n + 1 > wave::kMaxRows) return (int)cudaErrorInvalidValue;
  return wave::dispatch<false>(static_cast<const float*>(x), static_cast<int8_t*>(trace), n, m, rows_per_lane,
                               warps, wave::Batch{}, 1, (cudaStream_t)stream);
}

// K13's chain bound: one warp, `iters` dependent steps; out holds 32 floats
extern "C" int dtw_chain_probe(void* out, int iters, void* stream) {
  if (iters < 1) return (int)cudaErrorInvalidValue;
  wave::chain_probe_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

// K12: K13's fill with the plan of n_max, one CTA a row, then the walk
extern "C" int dtw_paths_f32(const void* x, void* trace, void* ti, void* tj, void* lens, const void* ns,
                             const void* ms, int batch, int n_max, int m_max, void* stream) {
  if (batch < 1 || n_max < 0 || m_max < 0 || n_max + 1 > wave::kMaxRows || n_max + m_max < 1)
    return (int)cudaErrorInvalidValue;
  const int rows_per_lane = wave::rows_per_lane_for(n_max + 1);
  const int warps = (n_max + 32 * rows_per_lane) / (32 * rows_per_lane);
  const wave::Batch rows{static_cast<const int*>(ns), static_cast<const int*>(ms), static_cast<int*>(ti),
                         static_cast<int*>(tj), static_cast<int*>(lens), n_max, m_max};
  return wave::dispatch<true>(static_cast<const float*>(x), static_cast<int8_t*>(trace), n_max, m_max,
                              rows_per_lane, warps, rows, batch, (cudaStream_t)stream);
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
