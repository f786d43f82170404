// K1 and K2: single-token decode attention over a layer of the stacked
// (L, B, Tk, D) KV caches, for Hopper (sm_90a).
//
// K2 `decode_attn_*` replaces `_decode_attn_kernel`
// (asr_ttl_mtl_tpu/ops/decode_attention.py:39, entry `decode_attention` :94):
// bf16 or fp32 caches, per-head fp32 scores, a full softmax, p / l cast to
// the cache dtype, then p.V with fp32 accumulation. Keys past `valid_upto`
// are masked (-1 = all valid). `group` query rows share one cache row.
//
// K1 `decode_attn_i8_*` replaces `_decode_attn_i8_kernel` (:186, entry
// `decode_attention_i8` :329): int8 caches with one fp32 scale per
// (layer, batch, position) row. q is quantized per (row, head); keys are
// walked in blocks of `tk_blk` IN ORDER with an online softmax; p times the
// v scale is quantized to int8 per (row, block) relative to the running max;
// both products are int8 x int8 -> int32. The rounding (round half to even,
// rintf), the masked-lane rules (p = 0 where masked, l == 0 -> 1) and the
// block size come from the TPU kernel, because the int8 rounding of p
// depends on them: tk_blk is part of the contract (`_i8_blocks`).
//
// What bounds them on the H100: memory. One decode step reads the whole
// cache of a layer for 1 query row per (batch row, head): 2 FLOPs per
// cache element, far below the card's ~295 FLOPs per byte. The design goal
// is to read each cache byte once, in whole 32-byte sectors.
//
// Design, K2: one CTA per (cache row, head) streams the head's 64 columns of
// K once (one thread per key, 16-byte loads) to get the `group` rows' scores
// into shared memory, then V once (a thread per column, the two halves of
// the CTA on alternate keys).
// Design, K1: one CTA per (query row, head), since the int8 rounding of p is
// per row and per block and the blocks must be taken in order. A thread per
// key computes its int8 score with __dp4a over four 16-byte loads; block
// max, sum and the p quantization are CTA reductions; P.V accumulates int32
// over a thread per column. With group > 1 the group's CTAs read the same
// cache row, which then comes from L2. Split-K (flash-decoding) would fill
// the card better but changes the rounding of p: a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDh = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// CTA-wide max or sum; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// ---------------------------------------------------------------- K2 ------

// G is the exact group size, so the per-row accumulators and the hoisted
// q values take registers for G rows only (a runtime group with a fixed
// maximum of 8 spilled).
template <typename T, int G>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ cache_k, const T* __restrict__ cache_v,
                   T* __restrict__ out, int layer, int batch, int tk, int d, int valid_upto, float scale) {
  extern __shared__ float sc[];  // [G][tk] scores, then probabilities
  __shared__ float qs[G][kDh];
  __shared__ float part[G][kDh];
  __shared__ float red[kWarps];

  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const size_t row = (size_t)layer * batch + b;
  const T* kb = cache_k + row * tk * d + (size_t)h * kDh;
  const T* vb = cache_v + row * tk * d + (size_t)h * kDh;

  for (int i = tid; i < G * kDh; i += kThreads)
    qs[i / kDh][i % kDh] = to_f(q[(size_t)(b * G + i / kDh) * d + (size_t)h * kDh + i % kDh]);
  __syncthreads();

  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte load
  for (int j = tid; j < tk; j += kThreads) {
    const T* kr = kb + (size_t)j * d;
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
#pragma unroll
    for (int c0 = 0; c0 < kDh; c0 += kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + c0);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int c = 0; c < kVec; ++c) {
        const float kv = to_f(e[c]);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = fmaf(qs[g][c0 + c], kv, acc[g]);
      }
    }
    const bool masked = valid_upto >= 0 && j > valid_upto;
#pragma unroll
    for (int g = 0; g < G; ++g) sc[g * tk + j] = masked ? kNegInf : acc[g] * scale;
  }
  __syncthreads();

  for (int g = 0; g < G; ++g) {
    float* s = sc + g * tk;
    float mx = kNegInf;
    for (int j = tid; j < tk; j += kThreads) mx = fmaxf(mx, s[j]);
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int j = tid; j < tk; j += kThreads) {
      const float p = expf(s[j] - mx);
      s[j] = p;
      sum += p;
    }
    sum = block_reduce<false>(sum, red);
    for (int j = tid; j < tk; j += kThreads) s[j] = to_f(from_f<T>(s[j] / sum));
  }
  __syncthreads();

  const int c = tid % kDh, half = tid / kDh;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;
  for (int j = half; j < tk; j += 2) {
    const float vv = to_f(vb[(size_t)j * d + c]);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = fmaf(sc[g * tk + j], vv, acc[g]);
  }
  if (half == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) part[g][c] = acc[g];
  }
  __syncthreads();
  if (half == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) out[(size_t)(b * G + g) * d + (size_t)h * kDh + c] = from_f<T>(acc[g] + part[g][c]);
  }
}

// ---------------------------------------------------------------- K1 ------

template <typename TQ>
__global__ void __launch_bounds__(kThreads)
decode_attn_i8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ cache_k,
                      const float* __restrict__ k_scale, const int8_t* __restrict__ cache_v,
                      const float* __restrict__ v_scale, TQ* __restrict__ out, int layer, int batch, int group,
                      int tk, int d, int tk_blk, int valid_upto, float scale) {
  __shared__ __align__(16) int8_t qi[kDh];
  __shared__ float pbuf[kMaxBlock];
  __shared__ int opart[kDh];
  __shared__ float red[kWarps];
  __shared__ float sq_s;

  const int qrow = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int b = qrow / group;
  const size_t row = (size_t)layer * batch + b;
  const int8_t* kb = cache_k + row * tk * d + (size_t)h * kDh;
  const int8_t* vb = cache_v + row * tk * d + (size_t)h * kDh;
  const float* ksb = k_scale + row * tk;
  const float* vsb = v_scale + row * tk;

  // quantize this (row, head) of q: abs-max scale, round half to even
  if (tid < 32) {
    const TQ* qr = q + (size_t)qrow * d + (size_t)h * kDh;
    const float x0 = to_f(qr[tid]), x1 = to_f(qr[tid + 32]);
    float mx = fmaxf(fabsf(x0), fabsf(x1));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float sq = fmaxf(mx, 1e-20f) / 127.f;
    qi[tid] = (int8_t)rintf(x0 / sq);
    qi[tid + 32] = (int8_t)rintf(x1 / sq);
    if (tid == 0) sq_s = sq;
  }
  __syncthreads();
  const float qscale = sq_s * scale;
  int qw[kDh / 4];
#pragma unroll
  for (int i = 0; i < kDh / 4; ++i) qw[i] = reinterpret_cast<const int*>(qi)[i];

  const int c = tid % kDh, half = tid / kDh;
  float m_run = kNegInf, l_run = 0.f, acc = 0.f;

  for (int k0 = 0; k0 < tk; k0 += tk_blk) {
    float tmax = kNegInf;
    for (int jj = tid; jj < tk_blk; jj += kThreads) {
      const int j = k0 + jj;
      const int4* kr = reinterpret_cast<const int4*>(kb + (size_t)j * d);
      int s32 = 0;
#pragma unroll
      for (int w = 0; w < kDh / 16; ++w) {
        const int4 kv = kr[w];
        s32 = __dp4a(kv.x, qw[4 * w + 0], s32);
        s32 = __dp4a(kv.y, qw[4 * w + 1], s32);
        s32 = __dp4a(kv.z, qw[4 * w + 2], s32);
        s32 = __dp4a(kv.w, qw[4 * w + 3], s32);
      }
      const bool masked = valid_upto >= 0 && j > valid_upto;
      const float s = masked ? kNegInf : (float)s32 * qscale * ksb[j];
      pbuf[jj] = s;
      tmax = fmaxf(tmax, s);
    }
    tmax = block_reduce<true>(tmax, red);
    const float m_new = fmaxf(m_run, tmax);
    const float corr = expf(m_run - m_new);

    float psum = 0.f, pmax = 0.f;
    for (int jj = tid; jj < tk_blk; jj += kThreads) {
      const int j = k0 + jj;
      const bool masked = valid_upto >= 0 && j > valid_upto;
      const float p = masked ? 0.f : expf(pbuf[jj] - m_new);
      psum += p;
      const float pv = p * vsb[j];
      pbuf[jj] = pv;
      pmax = fmaxf(pmax, pv);
    }
    psum = block_reduce<false>(psum, red);
    pmax = block_reduce<true>(pmax, red);
    l_run = corr * l_run + psum;
    m_run = m_new;
    const float sp = fmaxf(pmax, 1e-30f) / 127.f;
    for (int jj = tid; jj < tk_blk; jj += kThreads) pbuf[jj] = rintf(pbuf[jj] / sp);
    __syncthreads();

    int o32 = 0;
    for (int jj = half; jj < tk_blk; jj += 2) o32 += (int)pbuf[jj] * (int)vb[(size_t)(k0 + jj) * d + c];
    if (half == 1) opart[c] = o32;
    __syncthreads();
    if (half == 0) acc = acc * corr + (float)(o32 + opart[c]) * sp;
    __syncthreads();  // pbuf and opart are rewritten by the next block
  }
  if (half == 0) {
    const float safe = l_run == 0.f ? 1.f : l_run;
    out[(size_t)qrow * d + (size_t)h * kDh + c] = from_f<TQ>(acc / safe);
  }
}

template <typename T, int G>
int launch_decode_g(const void* q, const void* k, const void* v, void* out, int layer, int batch, int tk, int d,
                    int n_head, int valid_upto, float scale, void* stream) {
  const size_t smem = (size_t)G * tk * sizeof(float);
  // the 48 KB default covers static and dynamic shared memory together
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, decode_attn_kernel<T, G>);
  if (err != cudaSuccess) return (int)err;
  if (smem + attr.sharedSizeBytes > 48 * 1024) {
    err = cudaFuncSetAttribute(decode_attn_kernel<T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  decode_attn_kernel<T, G><<<dim3(batch, n_head), kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(out), layer,
      batch, tk, d, valid_upto, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* out, int layer, int n_layer, int batch,
                  int group, int tk, int d, int n_head, int valid_upto, float scale, void* stream) {
  if (d != n_head * kDh || tk < 1 || layer < 0 || layer >= n_layer || batch < 1) return (int)cudaErrorInvalidValue;
  switch (group) {
    case 1: return launch_decode_g<T, 1>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    case 2: return launch_decode_g<T, 2>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    case 3: return launch_decode_g<T, 3>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    case 4: return launch_decode_g<T, 4>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    case 5: return launch_decode_g<T, 5>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    case 6: return launch_decode_g<T, 6>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    case 7: return launch_decode_g<T, 7>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    case 8: return launch_decode_g<T, 8>(q, k, v, out, layer, batch, tk, d, n_head, valid_upto, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename TQ>
int launch_decode_i8(const void* q, const void* k, const void* ks, const void* v, const void* vs, void* out,
                     int layer, int n_layer, int batch, int group, int tk, int d, int n_head, int tk_blk,
                     int valid_upto, float scale, void* stream) {
  if (d != n_head * kDh || group < 1 || tk_blk < 1 || tk_blk > kMaxBlock || tk % tk_blk != 0 || layer < 0 ||
      layer >= n_layer || batch < 1)
    return (int)cudaErrorInvalidValue;
  decode_attn_i8_kernel<TQ><<<dim3(batch * group, n_head), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const TQ*>(q), static_cast<const int8_t*>(k), static_cast<const float*>(ks),
      static_cast<const int8_t*>(v), static_cast<const float*>(vs), static_cast<TQ*>(out), layer, batch, group,
      tk, d, tk_blk, valid_upto, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v, void* out, int layer, int n_layer,
                                int batch, int group, int tk, int d, int n_head, int valid_upto, float scale,
                                void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto,
                                      scale, stream);
}

extern "C" int decode_attn_f32(const void* q, const void* k, const void* v, void* out, int layer, int n_layer,
                               int batch, int group, int tk, int d, int n_head, int valid_upto, float scale,
                               void* stream) {
  return launch_decode<float>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, scale,
                              stream);
}

extern "C" int decode_attn_i8_bf16(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                                   void* out, int layer, int n_layer, int batch, int group, int tk, int d,
                                   int n_head, int tk_blk, int valid_upto, float scale, void* stream) {
  return launch_decode_i8<__nv_bfloat16>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head,
                                         tk_blk, valid_upto, scale, stream);
}

extern "C" int decode_attn_i8_f32(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                                  void* out, int layer, int n_layer, int batch, int group, int tk, int d,
                                  int n_head, int tk_blk, int valid_upto, float scale, void* stream) {
  return launch_decode_i8<float>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                 valid_upto, scale, stream);
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
