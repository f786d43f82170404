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
// the fill is N+M-1 dependent steps of one shared-memory round trip and one
// barrier each: about 1700 steps at base. K12's walk adds N+M dependent
// reads of the trace, which the fill has just written and which stays in L2
// (16 rows x 449 x 1501 bytes is 10.8 MB of the 50 MB).
//
// Design: one CTA per matrix (K12: per row), a thread per text index i
// (N+1 rounded up to a warp; up to kItems indices a thread when N+1 > 1024).
// The cost of the last three anti-diagonals lives in shared memory as a
// ring of three fp32 rows of N+1, with one __syncthreads per diagonal: step
// d writes slot d % 3, which step d-1 read as d-3 before the barrier. Each
// thread loads its x for the next diagonal before the barrier, so the
// load's latency overlaps it. The ring's 48 KB of static shared memory
// bounds N+1 to 4096 (the wrappers check it), in place of the JAX VMEM
// guards (pallas_dtw.py:115-116, :274-275). K12's trace is an int8 scratch
// of (B, N_max+1, M_max+1) that the wrapper allocates.

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

__global__ void __launch_bounds__(kThreads) dtw_kernel(const float* __restrict__ x, int8_t* __restrict__ trace,
                                                       int n, int m) {
  __shared__ float ring[3][kMaxRows];
  dtw_fill(x, m, trace, m + 1, n, m, ring);
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

}  // namespace

extern "C" int dtw_trace_f32(const void* x, void* trace, int n, int m, void* stream) {
  if (n < 1 || m < 1 || n + 1 > kMaxRows) return (int)cudaErrorInvalidValue;
  // a warp-rounded CTA when N+1 fits in one pass: fewer warps per barrier
  dtw_kernel<<<1, threads_for(n + 1), 0, (cudaStream_t)stream>>>(static_cast<const float*>(x),
                                                                 static_cast<int8_t*>(trace), n, m);
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
