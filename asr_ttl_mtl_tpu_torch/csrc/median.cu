// K11: sliding-window median of odd width along the last axis, reflect-
// padded, for Hopper (sm_90a).
//
// `median_filter_f32` replaces `_median_kernel`
// (asr_ttl_mtl_tpu/ops/pallas_median.py:25, entry `median_filter_pallas`
// :41): each output is the middle element of the `width` values around it,
// sorted by the odd-even transposition network of the TPU kernel (`width`
// rounds of min/max compare-swaps), so every output is one of its inputs
// and the result is exact.
//
// NaN: the TPU kernel's jnp.minimum / jnp.maximum propagate NaN, and a
// zero-variance column of the standardized attention is NaN. CUDA's fminf /
// fmaxf drop it, so the compare-swap here returns a NaN operand first, as
// torch.minimum / torch.maximum do on the card.
//
// What bounds it on the H100: memory. One fp32 read and one fp32 write per
// element and `width` * (width - 1) / 2 compare-swaps of registers: at the
// word-timestamp path's largest shape (8 heads, ~229 tokens, 1500 frames),
// 22 MB, about 6.6 us at 3.35 TB/s.
//
// Design: one thread per output element, neighbouring threads on
// neighbouring frames, so each of the `width` loads of a warp is one
// coalesced read of the row (the overlap comes from L1). The reflect index
// is computed in the kernel: no padded copy in device memory. The window's
// values live in registers: the width is a template argument, the network
// unrolls fully, and the launcher switches over the odd widths 3..13.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

template <int W>
__global__ void __launch_bounds__(kThreads) median_kernel(const float* __restrict__ x, float* __restrict__ out,
                                                          int rows, int t) {
  constexpr int kPad = W / 2;
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= t) return;
  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const float* src = x + (size_t)row * t;
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i) {
      int j = col + i - kPad;
      j = j < 0 ? -j : (j >= t ? 2 * (t - 1) - j : j);  // numpy's "reflect" (t > kPad)
      v[i] = __ldg(src + j);
    }
#pragma unroll
    for (int rnd = 0; rnd < W; ++rnd) {
#pragma unroll
      for (int i = rnd % 2; i < W - 1; i += 2) {
        const float lo = min_nan(v[i], v[i + 1]);
        const float hi = max_nan(v[i], v[i + 1]);
        v[i] = lo;
        v[i + 1] = hi;
      }
    }
    out[(size_t)row * t + col] = v[kPad];
  }
}

template <int W>
int launch(const float* x, float* out, int rows, int t, cudaStream_t s) {
  const dim3 grid((t + kThreads - 1) / kThreads, rows < 65535 ? rows : 65535);
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
