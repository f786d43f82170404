// K11: sliding-window median of odd width along the last axis, reflect-
// padded, for Hopper (sm_90a).
//
// `median_filter_f32` replaces `_median_kernel`
// (asr_ttl_mtl_tpu/ops/pallas_median.py:25, entry `median_filter_pallas`
// :41): each output is the middle element of the `width` values around it,
// so every output is one of its inputs and the result is exact.
//
// NaN: the TPU kernel's jnp.minimum / jnp.maximum propagate NaN, and a
// zero-variance column of the standardized attention is NaN. PTX's
// min.NaN.f32 / max.NaN.f32 (sm_80 and up) propagate it in one instruction
// each. A NaN entering a comparator leaves by both of its outputs, and every
// input of a median network reaches the middle output (else the median
// would not depend on it), so the output is NaN exactly when its window
// holds a NaN, whichever network computes it: the same NaN mask as the TPU
// kernel's odd-even transposition sort, and the same value elsewhere. The
// NaN is the canonical one.
//
// What bounds it on the H100: memory. One fp32 read and one fp32 write per
// element: at the word-timestamp path's largest shape (8 heads, ~229
// tokens, 1500 frames), 22 MB, about 6.6 us at 3.35 TB/s.
//
// Design: two adjacent outputs a thread, whose windows share W - 1 inputs.
// Those are ordered once by Batcher's odd-even merge network, pruned to the
// middle two (h - 1 and h, h = W / 2): the compiler drops every min and max
// whose result no output reads, so a comparator with one output discarded
// costs one instruction. Each output is then the median of those two and
// its own extra input: max(s[h-1], min(s[h], e)), two instructions. A CTA
// stages its row segment (512 outputs and the W - 1 around them) in shared
// memory once, with the reflection at both ends done there, so an output
// does no index arithmetic; a thread reads its W + 1 values as float2. The
// width is a template argument, the network unrolls fully, and the launcher
// switches over the odd widths 3..13.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kOut = 2;                 // outputs a thread
constexpr int kSeg = kThreads * kOut;  // outputs a CTA takes of a row

__device__ __forceinline__ float min_prop(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));  // not volatile: dropped when unread
  return d;
}
__device__ __forceinline__ float max_prop(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Batcher's odd-even merge sort of k values as (lo, hi) comparators: the
// network of the next power of two, less every comparator that touches an
// index >= k (those hold +inf there, and a comparator puts its max at hi)
struct Network {
  int n = 0;
  int lo[64] = {}, hi[64] = {};
};
__host__ __device__ constexpr Network batcher(int k) {
  Network net;
  int size = 1;
  while (size < k) size <<= 1;
  for (int p = 1; p < size; p <<= 1)
    for (int q = p; q >= 1; q >>= 1)
      for (int j = q % p; j + q < size; j += 2 * q)
        for (int i = 0; i < q && i + j + q < k; ++i)
          if ((i + j) / (2 * p) == (i + j + q) / (2 * p)) {
            net.lo[net.n] = i + j;
            net.hi[net.n] = i + j + q;
            ++net.n;
          }
  return net;
}

template <int K, int... I>
__device__ __forceinline__ void sort_network(float* s, std::integer_sequence<int, I...>) {
  constexpr Network net = batcher(K);
  auto swap = [&](float& a, float& b) {
    const float lo = min_prop(a, b), hi = max_prop(a, b);
    a = lo;
    b = hi;
  };
  (swap(s[net.lo[I]], s[net.hi[I]]), ...);
}

template <int W>
__global__ void __launch_bounds__(kThreads) median_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int rows, int t) {
  constexpr int h = W / 2;
  constexpr int kStaged = kSeg + W - 1;
  __shared__ __align__(16) float seg[kStaged];
  const int first = blockIdx.x * kSeg;  // the CTA's first output
  const int p = first + kOut * threadIdx.x;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* src = x + (size_t)row * t;
    __syncthreads();  // the last row's reads are done
    for (int i = threadIdx.x; i < kStaged; i += kThreads) {
      int j = first - h + i;
      // numpy's "reflect" (t > h); past the row's end only for outputs that are not written
      j = j < 0 ? -j : j >= t ? max(2 * (t - 1) - j, 0) : j;
      seg[i] = __ldg(src + j);
    }
    __syncthreads();
    float v[W + 1];  // positions p - h .. p + 1 + h
#pragma unroll
    for (int q = 0; q < (W + 1) / 2; ++q) {
      const float2 pair = *reinterpret_cast<const float2*>(seg + kOut * threadIdx.x + 2 * q);
      v[2 * q] = pair.x;
      v[2 * q + 1] = pair.y;
    }
    float s[W - 1];  // the inputs both windows hold
#pragma unroll
    for (int q = 0; q < W - 1; ++q) s[q] = v[q + 1];
    sort_network<W - 1>(s, std::make_integer_sequence<int, batcher(W - 1).n>{});
    float* dst = out + (size_t)row * t;
    if (p < t) dst[p] = max_prop(s[h - 1], min_prop(s[h], v[0]));
    if (p + 1 < t) dst[p + 1] = max_prop(s[h - 1], min_prop(s[h], v[W]));
  }
}

template <int W>
int launch(const float* x, float* out, int rows, int t, cudaStream_t s) {
  const dim3 grid((t + kSeg - 1) / kSeg, rows < 65535 ? rows : 65535);
  median_kernel<W><<<grid, kThreads, 0, s>>>(x, out, rows, t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int median_filter_f32(const void* x, void* out, int rows, int t, int width, void* stream) {
  if (rows <= 0 || t <= width / 2) return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 3: return launch<3>(xf, of, rows, t, s);
    case 5: return launch<5>(xf, of, rows, t, s);
    case 7: return launch<7>(xf, of, rows, t, s);
    case 9: return launch<9>(xf, of, rows, t, s);
    case 11: return launch<11>(xf, of, rows, t, s);
    case 13: return launch<13>(xf, of, rows, t, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
