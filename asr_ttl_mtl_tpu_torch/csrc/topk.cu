// K9 and K10: exact small-k top-k of each row, for Hopper (sm_90a).
//
// K9 `topk_logprobs_*` replaces `_topk_logprobs_kernel`
// (asr_ttl_mtl_tpu/ops/pallas_topk.py:51, entry `topk_logprobs_pallas` :77):
// the k largest entries of log_softmax(x.float()) of each row, read once,
// without the (rows, V) log-probabilities in device memory. Ranking on the
// raw logits is the same as ranking on the log-probabilities, so the indices
// are exact; each chosen value is finished as (x_sel - m) - log(sum), the
// TPU kernel's float order, where m is the row max and sum the row's
// sum of exp(x - m).
// K10 `topk_*` replaces `_topk_kernel` (:32, entry `topk_pallas` :123): the
// same selection without the log-softmax (values are the raw x as fp32).
//
// Order, as lax.top_k: value descending, ties to the lowest index, a value
// that occurs several times is listed as often as it occurs. Empty slots are
// (-inf, INT_MAX), so a real -inf entry (a suppressed logit) beats them and
// rows with fewer than k finite values still return the lowest -inf indices.
//
// What bounds it on the H100: memory. A beam step reads (rows, V) logits,
// 160 x 51865 bf16 = 16.6 MB at base with 32 windows x 5 beams, and does a
// compare, and for K9 one exp, per element.
//
// Design: one CTA per row, 256 threads. Each thread walks its share of the
// row with 16-byte loads (the row's unaligned head and tail one element at a
// time), four loads in flight, and keeps an online max and sum of exp (one
// exp per element: each vector's max first) plus its own best KMAX
// (value, index) pairs, sorted, in registers (KMAX = 8 or 32, at least k).
// The hot loop only compares each element with the list's static last slot;
// the few that beat it are inserted from one call site per loop, which keeps
// the unrolled insertion out of the unrolled load loop.
// A block merge then takes k rounds: each round finds the best list head
// over the CTA (warp shuffles, then one value per warp in shared memory),
// and the thread that owned it pops its head. The (max, sum) pairs reduce
// the same way before the merge, in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// (m, s) of two partial rows merged: max and rescaled sum of exp(x - max)
__device__ __forceinline__ void merge_lse(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;  // both empty (all -inf so far)
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// element q of a 16-byte vector of T, by register selects (no local memory)
__device__ __forceinline__ unsigned word(const uint4& u, int w) {
  return w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
}
__device__ __forceinline__ float pick(const uint4& u, int q, float) { return __uint_as_float(word(u, q)); }
__device__ __forceinline__ float pick(const uint4& u, int q, __nv_bfloat16) {
  const unsigned w = word(u, q >> 1);  // little-endian: element 2j is the low half of word j
  return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
}

template <int KMAX, bool LOGSM>
struct RowState {
  float lv[KMAX];
  int li[KMAX];
  float m = -INFINITY;  // running max
  float s = 0.f;        // sum of exp(x - m)

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      lv[j] = -INFINITY;
      li[j] = INT_MAX;
    }
  }

  // online sum of exp over N values: the chunk's max first, so one exp per value
  template <int N>
  __device__ __forceinline__ void add(const float (&e)[N]) {
    if (!LOGSM) return;
    float cm = e[0];
#pragma unroll
    for (int q = 1; q < N; ++q) cm = fmaxf(cm, e[q]);
    if (cm > m) {
      s *= expf(m - cm);  // 0 while m is -inf (s is 0 then too)
      m = cm;
    }
    if (m == -INFINITY) return;  // every value so far is -inf
#pragma unroll
    for (int q = 0; q < N; ++q) s += expf(e[q] - m);  // -inf adds 0
  }

  __device__ __forceinline__ bool passes(float x, int i) const { return better(x, i, lv[KMAX - 1], li[KMAX - 1]); }

  // insertion into the sorted list, unrolled so that it stays in registers;
  // callers reach it through one call site per loop, so the code stays small
  __device__ __forceinline__ void insert(float x, int i) {
    if (!passes(x, i)) return;
    bool placed = false;
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      if (better(x, i, lv[j - 1], li[j - 1])) {
        lv[j] = lv[j - 1];
        li[j] = li[j - 1];
      } else if (!placed) {
        lv[j] = x;
        li[j] = i;
        placed = true;
      }
    }
    if (!placed) {
      lv[0] = x;
      li[0] = i;
    }
  }

  __device__ __forceinline__ void visit(float x, int i) {
    const float e[1] = {x};
    add(e);
    insert(x, i);
  }

  // a 16-byte vector of T whose first element has index `base`
  template <typename T>
  __device__ __forceinline__ void visit_vec(const uint4& u, int base) {
    constexpr int kVec = 16 / sizeof(T);
    float e[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) e[q] = pick(u, q, T());
    add(e);
    unsigned hit = 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) hit |= (unsigned)passes(e[q], base + q) << q;
    while (hit) {  // rare once the list holds the thread's best: a handful of times a row
      const int q = __ffs(hit) - 1;
      hit &= hit - 1;
      insert(pick(u, q, T()), base + q);
    }
  }

  __device__ __forceinline__ void pop() {
#pragma unroll
    for (int j = 0; j < KMAX - 1; ++j) {
      lv[j] = lv[j + 1];
      li[j] = li[j + 1];
    }
    lv[KMAX - 1] = -INFINITY;
    li[KMAX - 1] = INT_MAX;
  }
};

template <typename T, int KMAX, bool LOGSM>
__global__ void __launch_bounds__(kThreads)
topk_rows_kernel(const T* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, int v, int k) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ float s_m[kWarps];
  __shared__ float s_s[kWarps];

  const int row = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* xr = x + (size_t)row * v;

  RowState<KMAX, LOGSM> st;
  st.init();

  // elements before the first 16-byte boundary of the row, the vector body,
  // and the tail
  const int head = min(v, (int)(((16u - (reinterpret_cast<uintptr_t>(xr) & 15u)) & 15u) / sizeof(T)));
  const int n_vec = (v - head) / kVec;
  const int tail = head + n_vec * kVec;
  for (int t = tid; t < head; t += kThreads) st.visit(to_float(xr[t]), t);

  const uint4* body = reinterpret_cast<const uint4*>(xr + head);
  int j = tid;
  for (; j + (kUnroll - 1) * kThreads < n_vec; j += kUnroll * kThreads) {
    uint4 u[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) u[r] = __ldg(body + j + r * kThreads);
#pragma unroll
    for (int r = 0; r < kUnroll; ++r) st.template visit_vec<T>(u[r], head + (j + r * kThreads) * kVec);
  }
  for (; j < n_vec; j += kThreads) st.template visit_vec<T>(__ldg(body + j), head + j * kVec);
  for (int t = tail + tid; t < v; t += kThreads) st.visit(to_float(xr[t]), t);

  // the row's max and sum of exp, reduced in a fixed order
  float lse = 0.f, row_max = 0.f;
  if (LOGSM) {
    float m = st.m, s = st.s;
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m, off);
      const float os = __shfl_xor_sync(0xffffffffu, s, off);
      merge_lse(m, s, om, os);
    }
    if (lane == 0) {
      s_m[warp] = m;
      s_s[warp] = s;
    }
    __syncthreads();
    m = s_m[0];
    s = s_s[0];
    for (int w = 1; w < kWarps; ++w) merge_lse(m, s, s_m[w], s_s[w]);
    row_max = m;
    lse = logf(s);
  }

  // k rounds of (best value, lowest index) over the threads' list heads
  for (int r = 0; r < k; ++r) {
    float bv = st.lv[0];
    int bi = st.li[0];
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    __syncthreads();  // the previous round's readers are done with s_val / s_idx
    if (lane == 0) {
      s_val[warp] = bv;
      s_idx[warp] = bi;
    }
    __syncthreads();
    bv = s_val[0];
    bi = s_idx[0];
    for (int w = 1; w < kWarps; ++w) {
      if (better(s_val[w], s_idx[w], bv, bi)) {
        bv = s_val[w];
        bi = s_idx[w];
      }
    }
    if (st.li[0] == bi && bi != INT_MAX) st.pop();  // indices are unique: one owner
    if (tid == 0) {
      vals[(size_t)row * k + r] = LOGSM ? (bv - row_max) - lse : bv;
      idx[(size_t)row * k + r] = bi;
    }
  }
}

template <typename T, bool LOGSM>
int launch(const void* x, float* vals, int* idx, int rows, int v, int k, void* stream) {
  if (rows <= 0 || v <= 0 || k < 1 || k > 32 || k > v) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= 8)
    topk_rows_kernel<T, 8, LOGSM><<<rows, kThreads, 0, s>>>(xt, vals, idx, v, k);
  else
    topk_rows_kernel<T, 32, LOGSM><<<rows, kThreads, 0, s>>>(xt, vals, idx, v, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int topk_logprobs_bf16(const void* x, float* vals, int* idx, int rows, int v, int k, void* stream) {
  return launch<__nv_bfloat16, true>(x, vals, idx, rows, v, k, stream);
}

extern "C" int topk_logprobs_f32(const void* x, float* vals, int* idx, int rows, int v, int k, void* stream) {
  return launch<float, true>(x, vals, idx, rows, v, k, stream);
}

extern "C" int topk_bf16(const void* x, float* vals, int* idx, int rows, int v, int k, void* stream) {
  return launch<__nv_bfloat16, false>(x, vals, idx, rows, v, k, stream);
}

extern "C" int topk_f32(const void* x, float* vals, int* idx, int rows, int v, int k, void* stream) {
  return launch<float, false>(x, vals, idx, rows, v, k, stream);
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
