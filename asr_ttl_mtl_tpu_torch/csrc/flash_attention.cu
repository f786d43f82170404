// K3: non-causal multi-head attention over natural (B, T, D) projections,
// forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_h2_fwd_kernel` (asr_ttl_mtl_tpu/ops/
// flash_attention.py:514, entry `flash_attention_h2` :562 with
// return_lse=False), which the encoder self-attention reaches through
// `flash_attention_mh_vjp` (:853-867). Per head h:
//   out_h = (softmax(scale * q_h k_h^T + tail mask) cast to v's dtype) v_h
// with fp32 scores, keys at or past `kv_len` masked, and the p.V sum divided
// by the fp32 row sum at the end (:540-547).
//
// What bounds it on the H100: at the encoder's shapes (T 1536, dh 64) the
// kernel does 4 T^2 dh FLOPs per head against 4 T dh bytes of q, k, v and
// out, about 700 FLOPs per byte, so it is bound by the tensor cores and the
// softmax between the two products, not by memory.
//
// Design: the TPU kernel holds all keys in VMEM and takes one softmax over
// them; shared memory cannot, so this is an FA2 forward. One CTA of 4 warps
// per (64-row q tile, head, batch row) reads its q, k and v columns straight
// from (B, T, D) at stride D (no head transpose in device memory) and walks
// 64-key tiles with an online softmax in fp32. Each warp owns 16 query rows:
// S = Q K^T and P V run on the tensor cores through WMMA (bf16 in, fp32
// accumulate). Two lanes own one row of the score tile for the softmax, and
// keep that row's output accumulator in registers, rescaled by
// exp(m_old - m_new) at every tile. As in the TPU kernel, p is rounded to
// bf16 before P V while the row sum l adds the fp32 p. Key tiles wholly past
// kv_len are skipped: their p is exactly 0. Not yet done: cp.async/TMA
// double-buffering of the K/V tiles and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kDh = 64;
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kWarps = kBlockQ / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLdh = kDh + 8;      // bf16 row stride of the q/k/v/p tiles
constexpr int kLds = kBlockK + 4;  // fp32 row stride of a warp's score tile
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_h2_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int tq, int tk,
                    int d, int kv_len, float scale) {
  __shared__ __align__(32) __nv_bfloat16 qs[kBlockQ * kLdh];
  __shared__ __align__(32) __nv_bfloat16 ks[kBlockK * kLdh];
  __shared__ __align__(32) __nv_bfloat16 vs[kBlockK * kLdh];
  __shared__ __align__(32) float ss[kWarps * 16 * kLds];

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const __nv_bfloat16* qb = q + (size_t)b * tq * d + (size_t)h * kDh;
  const __nv_bfloat16* kb = k + (size_t)b * tk * d + (size_t)h * kDh;
  const __nv_bfloat16* vb = v + (size_t)b * tk * d + (size_t)h * kDh;

  // q tile: 64 rows x 8 chunks of 16 bytes; rows past tq are zero
  for (int i = tid; i < kBlockQ * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < tq) val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * d + c * 8);
    *reinterpret_cast<uint4*>(qs + r * kLdh + c * 8) = val;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[kDh / 16];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wmma::load_matrix_sync(qf[kk], qs + warp * 16 * kLdh + kk * 16, kLdh);

  float* sw = ss + warp * 16 * kLds;
  // p (bf16) reuses this warp's score tile once the scores are in registers
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(sw);
  const int row = lane / 2;         // this lane's row of the warp's 16
  const int cbase = (lane % 2) * 32;  // and its 32 columns

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  const int n_tiles = (kv_len + kBlockK - 1) / kBlockK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // every warp is done with the previous k/v tile
    for (int i = tid; i < kBlockK * 8; i += kThreads) {
      const int r = i / 8, c = i % 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < tk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * d + c * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * d + c * 8);
      }
      *reinterpret_cast<uint4*>(ks + r * kLdh + c * 8) = kv;
      *reinterpret_cast<uint4*>(vs + r * kLdh + c * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < kBlockK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, ks + n * 16 * kLdh + kk * 16, kLdh);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sw + n * 16, sf, kLds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over the tile, fp32
    float s[32];
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float x = k0 + cbase + i < kv_len ? sw[row * kLds + cbase + i] * scale : kNegInf;
      s[i] = x;
      tile_max = fmaxf(tile_max, x);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m_run, tile_max);
    const float corr = expf(m_run - m_new);
    __syncwarp();  // all scores read before p overwrites the tile
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = k0 + cbase + i < kv_len ? expf(s[i] - m_new) : 0.f;
      psum += p;
      pw[row * kLdh + cbase + i] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncwarp();

    // O_tile = P V
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf[kBlockK / 16];
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) wmma::load_matrix_sync(pf[kk], pw + kk * 16, kLdh);
    __syncwarp();  // p is in registers; the tile now takes P V
#pragma unroll
    for (int n = 0; n < kDh / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, vs + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(of, pf[kk], vf, of);
      }
      wmma::store_matrix_sync(sw + n * 16, of, kLds, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = o[i] * corr + sw[row * kLds + cbase + i];
  }

  const int qrow = q0 + warp * 16 + row;
  if (qrow < tq) {
    __nv_bfloat16* dst = out + (size_t)b * tq * d + (size_t)qrow * d + (size_t)h * kDh + cbase;
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(o[i] / l_run, o[i + 1] / l_run);
  }
}

}  // namespace

extern "C" int flash_h2_fwd_bf16(const void* q, const void* k, const void* v, void* out, int batch, int tq,
                                 int tk, int d, int n_head, int kv_len, float scale, void* stream) {
  if (d != n_head * kDh || d % 8 != 0 || kv_len < 1 || kv_len > tk || tq < 1 || batch < 1)
    return (int)cudaErrorInvalidValue;
  dim3 grid((tq + kBlockQ - 1) / kBlockQ, n_head, batch);
  flash_h2_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), tq, tk, d, kv_len, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
