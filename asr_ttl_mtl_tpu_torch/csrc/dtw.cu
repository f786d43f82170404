// K13: the dynamic-time-warping fill of one cost matrix, for Hopper
// (sm_90a).
//
// `dtw_trace_f32` replaces `_dtw_kernel` (asr_ttl_mtl_tpu/ops/pallas_dtw.py:36,
// entry `dtw_trace_pallas` :105). x is the (N, M) fp32 cost matrix (N text
// tokens x M frames; callers pass -attention). The output is the int8 trace
// (N+1, M+1), row-major and unskewed: for 1 <= i <= N and 1 <= j <= M
//   cost[i, j] = x[i-1, j-1] + min(c0 = cost[i-1, j-1], c1 = cost[i-1, j],
//                                   c2 = cost[i, j-1])
// with t = 0 only if c0 is strictly smallest, t = 1 only if c1 is strictly
// smaller than both, else t = 2 (the tie rule of pallas_dtw.py:18-20,
// :57-60); every other cell is -1. cost[0, 0] = 0 and the rest of row 0 and
// column 0 are +inf. The cell cost is one fp32 add with no multiply, so the
// trace is bit-exact against a plain fp32 wavefront. The backtrace walks on
// the host, as in the JAX package.
//
// What bounds it on the H100: the dependency chain, not the bytes. It reads
// N*M*4 bytes and writes (N+1)*(M+1) (at N=225, M=1500: 1.35 MB and 0.34 MB,
// about 0.5 us at 3.35 TB/s), but diagonal d needs diagonal d-1, so the
// fill is N+M-1 dependent steps of one shared-memory round trip and one
// barrier each: about 1700 steps at base.
//
// Design: one CTA per matrix, a thread per text index i (N+1 rounded up to
// a warp; up to kItems indices a thread when N+1 > 1024). The cost of the
// last three anti-diagonals lives in shared memory as a ring of three fp32 rows of N+1,
// with one __syncthreads per diagonal: step d writes slot d % 3, which step
// d-1 read as d-3 before the barrier. Each thread loads its x for the next
// diagonal before the barrier, so the load's latency overlaps it. There is
// no VMEM budget here, so no size guard like pallas_dtw.py:115-116 beyond
// the ring's 48 KB of static shared memory.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kItems = 4;
constexpr int kMaxRows = kThreads * kItems;  // N + 1; 3 x 4096 fp32 = 48 KB

__global__ void __launch_bounds__(kThreads) dtw_kernel(const float* __restrict__ x, int8_t* __restrict__ trace,
                                                       int n, int m) {
  __shared__ float ring[3][kMaxRows];
  const int n1 = n + 1, m1 = m + 1;
  const float inf = __int_as_float(0x7f800000);

  // diagonals 0 and 1: cost[0, 0] = 0, cost[0, 1] = cost[1, 0] = inf; their
  // trace cells are -1
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    ring[0][i] = i == 0 ? 0.f : inf;
    ring[1][i] = inf;
    trace[(size_t)i * m1] = -1;  // (i, 0), which holds (1, 0)
    if (i == 0) trace[1] = -1;   // (0, 1)
  }

  // x[i-1, d-i-1] of this thread's cells for the diagonal about to run
  float xn[kItems];
  auto load = [&](int d) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = threadIdx.x + k * blockDim.x;
      const int j = d - i;
      xn[k] = (i >= 1 && i <= n && j >= 1 && j <= m) ? __ldg(x + (size_t)(i - 1) * m + (j - 1)) : 0.f;
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
      trace[(size_t)i * m1 + j] = t;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int dtw_trace_f32(const void* x, void* trace, int n, int m, void* stream) {
  if (n < 1 || m < 1 || n + 1 > kMaxRows) return (int)cudaErrorInvalidValue;
  // a warp-rounded CTA when N+1 fits in one pass: fewer warps per barrier
  const int threads = n + 1 <= kThreads ? (n + 1 + 31) / 32 * 32 : kThreads;
  dtw_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(static_cast<const float*>(x), static_cast<int8_t*>(trace),
                                                       n, m);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
