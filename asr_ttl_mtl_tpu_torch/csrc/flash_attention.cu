// Flash attention for Hopper (sm_90a): the forward K3 (non-causal, natural
// (B, T, D) layout, optional logsumexp), K5 (non-causal, natural layout,
// any head width that is a multiple of 8 up to 768) and K7 (head-split
// (BH, T, 64), causal / q_offset / kv_len, optional logsumexp), and the
// FlashAttention-2 backward K6 (of K3) and K8 (of K7), bf16 in, fp32
// accumulate.
//
// Replaces these TPU kernels of asr_ttl_mtl_tpu/ops/flash_attention.py:
//   K5  `_flash_mh_kernel` :346 (entry `flash_attention_mh` :401)
//   K3  `_h2_fwd_kernel` :514 and `_h2_fwd_kernel_lse` :552
//       (entry `flash_attention_h2` :562)
//   K6  `_h2_bwd_dq_kernel` :651, `_h2_bwd_dkv_kernel` :691
//       (entry `flash_attention_h2_bwd` :756)
//   K7  `_flash_kernel` :165, `_flash_kernel_lse` :169
//       (entries `flash_attention` :211, `flash_attention_bhtd` :309)
//   K8  `_flash_bwd_dq_kernel` :976, `_flash_bwd_dkv_kernel` :1030
//       (entry `flash_attention_bwd` :1095)
// Per head h, with s = scale * q_h k_h^T in fp32 and the structural mask
// (keys >= kv_len; with `causal`, keys > q_offset + query):
//   forward   out_h = (softmax(s) cast to bf16) v_h, lse = m + log(l);
//   backward  p = exp(s - lse), dP = dO v^T, dS = p (dP - delta) scale,
//             dq = bf16(dS) k, dk = bf16(dS)^T q, dv = bf16(p)^T dO,
// where delta = rowsum(dO * O) comes from the caller (plain PyTorch, as the
// JAX package leaves it to XLA).
//
// Both layouts are one addressing scheme: a block serves (q or k tile, head
// h, batch row b) and reads rows of 64 values at stride `d` from
// b*T*d + h*64. K3/K6 pass the natural layout (d = 64 * n_head); K7/K8 pass
// (BH, T, 64) as batch = BH, n_head = 1, d = 64. The lse/delta residuals
// live at ((h / hpb) * batch + b) * T * hpb + t * hpb + h % hpb: the JAX
// h2 layout (D//128, B, Tq, hpb) with hpb = 2, and (BH, Tq, 1) with hpb = 1.
//
// What bounds them on the H100: at the encoder's shapes (T 1536, dh 64) the
// forward does 4 T^2 dh FLOPs per head against 4 T dh bytes (~700 FLOPs per
// byte) and the backward 10 T^2 dh against 8 T dh bytes, so all are bound by
// the tensor cores and the fp32 softmax work between the products, not by
// memory. At the decoder's causal shapes (T 48-448) the per-block work is
// small and launch and load latency dominate.
//
// Design. The TPU kernels hold all keys (or all queries) of a head in VMEM
// and carry accumulators across a sequential grid axis; on Hopper blocks run
// in parallel and in no order, so each block loops over the other axis
// itself and owns every accumulator it writes (no atomics: the results are
// the same from run to run). One block of 4 warps per 64-row tile; each warp
// owns 16 rows. Products run on the tensor cores through WMMA 16x16x16 (bf16
// in, fp32 accumulate); the per-element softmax work goes through a per-warp
// fp32 tile in shared memory, two lanes per row, 32 columns each.
//   forward: loops over 64-key tiles with an online softmax in fp32; p is
//     rounded to bf16 before P V while l sums the fp32 p, as on the TPU.
//     Causal key tiles wholly above the diagonal, and tiles past kv_len, are
//     skipped. A row with no valid key writes 0 and lse -1e30.
//   dq: per q tile, loops over key tiles, recomputes p from lse, keeps dq in
//     WMMA accumulators; dS is rounded to bf16 before dS K.
//   dkv: per key tile, loops over q tiles (skipping those wholly below the
//     causal diagonal), keeps dk and dv in WMMA accumulators; p and dS are
//     rounded to bf16 before P^T dO and dS^T Q. Key tiles at or past kv_len
//     write zeros.
// K5 at a head width of 64 is the K3 forward without the logsumexp, over
// any number of heads (its device code reads the natural layout at 64
// columns a head and never assumes d % 128 == 0; the lse layout is the only
// part that does). Other widths take `flash_mh_kernel`: 4 warps over 16
// queries of one head, 64-key tiles, the head slice zero-padded to a
// multiple of 16 columns in shared memory (q, k then v over the same
// buffer, the fp32 output accumulator), WMMA for S = Q K^T and O += P V,
// and the same online softmax with p rounded to bf16 before P V. The TPU
// kernel holds the whole key range of a row block in VMEM and takes one
// softmax per head; on Hopper the keys go by tiles.
// Not yet done: cp.async/TMA double-buffering and wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int kDh = 64;
constexpr int kBlock = 64;          // rows of a q tile and of a key tile
constexpr int kWarps = kBlock / 16;
constexpr int kThreads = kWarps * 32;
constexpr int kLdh = kDh + 8;       // bf16 row stride of the tiles
constexpr int kLds = kBlock + 4;    // fp32 row stride of a warp's score tile
constexpr float kNegInf = -1e30f;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Shape {
  int batch, tq, tk, d, n_head, hpb, kv_len, q_offset;
  float scale;
};

__device__ __forceinline__ size_t res_index(const Shape& sh, int h, int b, int t) {
  return ((size_t)(h / sh.hpb) * sh.batch + b) * (size_t)sh.tq * sh.hpb + (size_t)t * sh.hpb + h % sh.hpb;
}

// 64 rows x 64 bf16 from `src` (row stride d) into a shared tile; rows at or
// past `n_rows` are zero
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int row0, int n_rows,
                                          int d) {
  for (int i = threadIdx.x; i < kBlock * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * d + c * 8);
    *reinterpret_cast<uint4*>(dst + r * kLdh + c * 8) = val;
  }
}

// this warp's 16 rows of a shared tile as four A fragments (16 x 64)
__device__ __forceinline__ void load_a(FragA (&f)[kDh / 16], const __nv_bfloat16* tile, int warp) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) wmma::load_matrix_sync(f[kk], tile + warp * 16 * kLdh + kk * 16, kLdh);
}

// out (16 x 64 fp32, row stride kLds) = A (16 x 64) . tile^T, tile 64 rows x 64
__device__ __forceinline__ void mul_abt(float* out, const FragA (&a)[kDh / 16], const __nv_bfloat16* tile) {
#pragma unroll
  for (int n = 0; n < kBlock / 16; ++n) {
    FragC c;
    wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      FragBc b;
      wmma::load_matrix_sync(b, tile + n * 16 * kLdh + kk * 16, kLdh);
      wmma::mma_sync(c, a[kk], b, c);
    }
    wmma::store_matrix_sync(out + n * 16, c, kLds, wmma::mem_row_major);
  }
}

// acc[n] += A (16 x 64, bf16 in shared memory at row stride kLdh) . tile
// (64 x 64 row-major)
__device__ __forceinline__ void mac_ab(FragC (&acc)[kDh / 16], const __nv_bfloat16* a_s,
                                       const __nv_bfloat16* tile) {
  FragA a[kBlock / 16];
#pragma unroll
  for (int kk = 0; kk < kBlock / 16; ++kk) wmma::load_matrix_sync(a[kk], a_s + kk * 16, kLdh);
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) {
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) {
      FragBr b;
      wmma::load_matrix_sync(b, tile + kk * 16 * kLdh + n * 16, kLdh);
      wmma::mma_sync(acc[n], a[kk], b, acc[n]);
    }
  }
}

// write this warp's 16 x 64 fp32 accumulators as bf16 rows (rows < n_rows)
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, FragC (&acc)[kDh / 16], float* sw, int row0,
                                           int n_rows, int d) {
  const int lane = threadIdx.x % 32, row = lane / 2, cbase = (lane % 2) * 32;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) wmma::store_matrix_sync(sw + n * 16, acc[n], kLds, wmma::mem_row_major);
  __syncwarp();
  if (row0 + row < n_rows) {
    __nv_bfloat16* out = dst + (size_t)(row0 + row) * d + cbase;
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(out + i) =
          __floats2bfloat162_rn(sw[row * kLds + cbase + i], sw[row * kLds + cbase + i + 1]);
  }
}

// ------------------------------------------------------------------ forward

template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                 Shape sh) {
  __shared__ __align__(32) __nv_bfloat16 qs[kBlock * kLdh];
  __shared__ __align__(32) __nv_bfloat16 ks[kBlock * kLdh];
  __shared__ __align__(32) __nv_bfloat16 vs[kBlock * kLdh];
  __shared__ __align__(32) float ss[kWarps * 16 * kLds];

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = q + (size_t)b * sh.tq * sh.d + (size_t)h * kDh;
  const __nv_bfloat16* kb = k + (size_t)b * sh.tk * sh.d + (size_t)h * kDh;
  const __nv_bfloat16* vb = v + (size_t)b * sh.tk * sh.d + (size_t)h * kDh;

  load_tile(qs, qb, q0, sh.tq, sh.d);
  __syncthreads();
  FragA qf[kDh / 16];
  load_a(qf, qs, warp);

  float* sw = ss + warp * 16 * kLds;
  // p (bf16) reuses this warp's score tile once the scores are in registers
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(sw);
  const int row = lane / 2;           // this lane's row of the warp's 16
  const int cbase = (lane % 2) * 32;  // and its 32 columns
  const int qpos = sh.q_offset + q0 + warp * 16 + row;

  float o[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  int n_tiles = (sh.kv_len + kBlock - 1) / kBlock;
  if (kCausal) n_tiles = min(n_tiles, (sh.q_offset + q0 + kBlock - 1) / kBlock + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile(ks, kb, k0, sh.tk, sh.d);
    load_tile(vs, vb, k0, sh.tk, sh.d);
    __syncthreads();

    mul_abt(sw, qf, ks);  // S = Q K^T for this warp's 16 rows
    __syncwarp();

    // online softmax over the tile, fp32
    float s[32];
    bool valid[32];
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kpos = k0 + cbase + i;
      valid[i] = kpos < sh.kv_len && (!kCausal || kpos <= qpos);
      s[i] = valid[i] ? sw[row * kLds + cbase + i] * sh.scale : kNegInf;
      tile_max = fmaxf(tile_max, s[i]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    const float m_new = fmaxf(m_run, tile_max);
    const float corr = expf(m_run - m_new);
    __syncwarp();  // all scores read before p overwrites the tile
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = valid[i] ? expf(s[i] - m_new) : 0.f;
      psum += p;
      pw[row * kLdh + cbase + i] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncwarp();

    // O_tile = P V
    FragC of[kDh / 16];
#pragma unroll
    for (int n = 0; n < kDh / 16; ++n) wmma::fill_fragment(of[n], 0.f);
    FragA pf[kBlock / 16];
#pragma unroll
    for (int kk = 0; kk < kBlock / 16; ++kk) wmma::load_matrix_sync(pf[kk], pw + kk * 16, kLdh);
    __syncwarp();  // p is in registers; the tile now takes P V
#pragma unroll
    for (int n = 0; n < kDh / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < kBlock / 16; ++kk) {
        FragBr vf;
        wmma::load_matrix_sync(vf, vs + kk * 16 * kLdh + n * 16, kLdh);
        wmma::mma_sync(of[n], pf[kk], vf, of[n]);
      }
      wmma::store_matrix_sync(sw + n * 16, of[n], kLds, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = o[i] * corr + sw[row * kLds + cbase + i];
  }

  const int qrow = q0 + warp * 16 + row;
  if (qrow < sh.tq) {
    // a row with no valid key (l == 0) writes 0, and lse -1e30
    const float inv = l_run == 0.f ? 0.f : 1.f / l_run;
    __nv_bfloat16* dst = out + (size_t)b * sh.tq * sh.d + (size_t)qrow * sh.d + (size_t)h * kDh + cbase;
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      *reinterpret_cast<__nv_bfloat162*>(dst + i) = __floats2bfloat162_rn(o[i] * inv, o[i + 1] * inv);
    if (lse != nullptr && cbase == 0)
      lse[res_index(sh, h, b, qrow)] = l_run == 0.f ? kNegInf : m_run + logf(l_run);
  }
}

// ---------------------------------------------------------------- backward

// dq: one block per (q tile, head, batch row), looping over key tiles
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
                    Shape sh) {
  __shared__ __align__(32) __nv_bfloat16 stage[kBlock * kLdh];  // q, then dO
  __shared__ __align__(32) __nv_bfloat16 ks[kBlock * kLdh];
  __shared__ __align__(32) __nv_bfloat16 vs[kBlock * kLdh];
  __shared__ __align__(32) float ss[kWarps * 16 * kLds];
  __shared__ float lse_s[kBlock], delta_s[kBlock];

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t qoff = (size_t)b * sh.tq * sh.d + (size_t)h * kDh;
  const __nv_bfloat16* kb = k + (size_t)b * sh.tk * sh.d + (size_t)h * kDh;
  const __nv_bfloat16* vb = v + (size_t)b * sh.tk * sh.d + (size_t)h * kDh;

  for (int i = threadIdx.x; i < kBlock; i += kThreads) {
    const bool in = q0 + i < sh.tq;
    lse_s[i] = in ? lse[res_index(sh, h, b, q0 + i)] : 0.f;
    delta_s[i] = in ? delta[res_index(sh, h, b, q0 + i)] : 0.f;
  }
  load_tile(stage, q + qoff, q0, sh.tq, sh.d);
  __syncthreads();
  FragA qf[kDh / 16], dof[kDh / 16];
  load_a(qf, stage, warp);
  __syncthreads();
  load_tile(stage, dout + qoff, q0, sh.tq, sh.d);
  __syncthreads();
  load_a(dof, stage, warp);

  float* sw = ss + warp * 16 * kLds;
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(sw);
  const int row = lane / 2, cbase = (lane % 2) * 32;
  const int qrow = q0 + warp * 16 + row;
  const int qpos = sh.q_offset + qrow;
  const float lse_r = lse_s[warp * 16 + row], delta_r = delta_s[warp * 16 + row];

  FragC acc[kDh / 16];
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  int n_tiles = (sh.kv_len + kBlock - 1) / kBlock;
  if (kCausal) n_tiles = min(n_tiles, (sh.q_offset + q0 + kBlock - 1) / kBlock + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlock;
    __syncthreads();
    load_tile(ks, kb, k0, sh.tk, sh.d);
    load_tile(vs, vb, k0, sh.tk, sh.d);
    __syncthreads();

    mul_abt(sw, qf, ks);  // S
    __syncwarp();
    float p[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int kpos = k0 + cbase + i;
      const bool valid = kpos < sh.kv_len && qrow < sh.tq && (!kCausal || kpos <= qpos);
      p[i] = valid ? expf(sw[row * kLds + cbase + i] * sh.scale - lse_r) : 0.f;
    }
    __syncwarp();
    mul_abt(sw, dof, vs);  // dP = dO V^T
    __syncwarp();
    float ds[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) ds[i] = p[i] * (sw[row * kLds + cbase + i] - delta_r) * sh.scale;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 32; ++i) pw[row * kLdh + cbase + i] = __float2bfloat16(ds[i]);
    __syncwarp();
    mac_ab(acc, pw, ks);  // dQ += bf16(dS) K
  }
  store_rows(dq + qoff, acc, sw, q0 + warp * 16, sh.tq, sh.d);
}

// dk, dv: one block per (key tile, head, batch row), looping over q tiles
template <bool kCausal>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, Shape sh) {
  __shared__ __align__(32) __nv_bfloat16 qs[kBlock * kLdh];   // k, then q tiles
  __shared__ __align__(32) __nv_bfloat16 dos[kBlock * kLdh];  // v, then dO tiles
  __shared__ __align__(32) float ss[kWarps * 16 * kLds];
  __shared__ float lse_s[kBlock], delta_s[kBlock];

  const int k0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t koff = (size_t)b * sh.tk * sh.d + (size_t)h * kDh;
  const size_t qoff = (size_t)b * sh.tq * sh.d + (size_t)h * kDh;
  float* sw = ss + warp * 16 * kLds;
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(sw);
  const int row = lane / 2, cbase = (lane % 2) * 32;
  const int kpos = k0 + warp * 16 + row;

  FragC dk_acc[kDh / 16], dv_acc[kDh / 16];
#pragma unroll
  for (int n = 0; n < kDh / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  if (k0 < sh.kv_len) {  // key tiles at or past kv_len keep dk = dv = 0
    load_tile(qs, k + koff, k0, sh.tk, sh.d);
    load_tile(dos, v + koff, k0, sh.tk, sh.d);
    __syncthreads();
    FragA kf[kDh / 16], vf[kDh / 16];
    load_a(kf, qs, warp);
    load_a(vf, dos, warp);

    // causal: q tiles whose last query lies above this tile's first key
    // see none of it
    const int lo = k0 - sh.q_offset - (kBlock - 1);
    const int qt0 = (kCausal && lo > 0) ? (lo + kBlock - 1) / kBlock : 0;
    const int n_qt = (sh.tq + kBlock - 1) / kBlock;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kBlock;
      __syncthreads();  // every warp is done with the previous q/dO tile
      load_tile(qs, q + qoff, q0, sh.tq, sh.d);
      load_tile(dos, dout + qoff, q0, sh.tq, sh.d);
      for (int i = threadIdx.x; i < kBlock; i += kThreads) {
        const bool in = q0 + i < sh.tq;
        lse_s[i] = in ? lse[res_index(sh, h, b, q0 + i)] : 0.f;
        delta_s[i] = in ? delta[res_index(sh, h, b, q0 + i)] : 0.f;
      }
      __syncthreads();

      mul_abt(sw, kf, qs);  // S^T = K Q^T: this warp's 16 keys x 64 queries
      __syncwarp();
      float p[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int qrow = q0 + cbase + i;
        const bool valid = kpos < sh.kv_len && qrow < sh.tq && (!kCausal || kpos <= sh.q_offset + qrow);
        p[i] = valid ? expf(sw[row * kLds + cbase + i] * sh.scale - lse_s[cbase + i]) : 0.f;
      }
      __syncwarp();
      mul_abt(sw, vf, dos);  // dP^T = V dO^T
      __syncwarp();
      float ds[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) ds[i] = p[i] * (sw[row * kLds + cbase + i] - delta_s[cbase + i]) * sh.scale;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) pw[row * kLdh + cbase + i] = __float2bfloat16(p[i]);
      __syncwarp();
      mac_ab(dv_acc, pw, dos);  // dV += bf16(P)^T dO
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 32; ++i) pw[row * kLdh + cbase + i] = __float2bfloat16(ds[i]);
      __syncwarp();
      mac_ab(dk_acc, pw, qs);  // dK += bf16(dS)^T Q
    }
  }
  store_rows(dk + koff, dk_acc, sw, k0 + warp * 16, sh.tk, sh.d);
  store_rows(dv + koff, dv_acc, sw, k0 + warp * 16, sh.tk, sh.d);
}

bool bad_shape(const Shape& sh) {
  return sh.batch < 1 || sh.tq < 1 || sh.tk < 1 || sh.n_head < 1 || sh.d != sh.n_head * kDh ||
         sh.kv_len < 1 || sh.kv_len > sh.tk || sh.q_offset < 0 || sh.hpb < 1;
}

int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, bool causal,
               void* stream) {
  if (bad_shape(sh)) return (int)cudaErrorInvalidValue;
  dim3 grid((sh.tq + kBlock - 1) / kBlock, sh.n_head, sh.batch);
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k);
  auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  auto* lp = static_cast<float*>(lse);
  if (causal)
    flash_fwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(qp, kp, vp, op, lp, sh);
  else
    flash_fwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(qp, kp, vp, op, lp, sh);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, const Shape& sh, bool causal, void* stream) {
  if (bad_shape(sh)) return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
  auto* qp = static_cast<const __nv_bfloat16*>(q);
  auto* kp = static_cast<const __nv_bfloat16*>(k);
  auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* gp = static_cast<const __nv_bfloat16*>(dout);
  auto* lp = static_cast<const float*>(lse);
  auto* dp = static_cast<const float*>(delta);
  auto* dqp = static_cast<__nv_bfloat16*>(dq);
  auto* dkp = static_cast<__nv_bfloat16*>(dk);
  auto* dvp = static_cast<__nv_bfloat16*>(dv);
  dim3 gq((sh.tq + kBlock - 1) / kBlock, sh.n_head, sh.batch);
  dim3 gk((sh.tk + kBlock - 1) / kBlock, sh.n_head, sh.batch);
  if (causal) {
    flash_bwd_dq_kernel<true><<<gq, kThreads, 0, s>>>(qp, kp, vp, gp, lp, dp, dqp, sh);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_kernel<true><<<gk, kThreads, 0, s>>>(qp, kp, vp, gp, lp, dp, dkp, dvp, sh);
  } else {
    flash_bwd_dq_kernel<false><<<gq, kThreads, 0, s>>>(qp, kp, vp, gp, lp, dp, dqp, sh);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dkv_kernel<false><<<gk, kThreads, 0, s>>>(qp, kp, vp, gp, lp, dp, dkp, dvp, sh);
  }
  return (int)cudaGetLastError();
}

// ------------------------------------------------- K5 at any head width

constexpr int kMhRows = 16;   // queries per block
constexpr int kMhKeys = 64;   // keys per tile
constexpr int kMhMaxDh = 768;
constexpr int kMhLds = kMhKeys + 8;   // fp32 row stride of the score tile
constexpr int kMhLdp = kMhKeys + 16;  // bf16 row stride of the p tile

struct MhShape {
  int batch, tq, tk, d, n_head, dh, dhp, kv_len;
  float scale;
};

// bf16 row stride of the q and k/v tiles and fp32 row stride of the output
// accumulator: multiples of 32 bytes, so every WMMA pointer is 256-bit aligned
__host__ __device__ __forceinline__ int mh_ldh(int dhp) { return dhp + 16; }
__host__ __device__ __forceinline__ int mh_ldo(int dhp) { return dhp + 8; }

__host__ __device__ __forceinline__ size_t mh_smem_bytes(int dhp) {
  return (size_t)(kMhRows + kMhKeys) * mh_ldh(dhp) * 2 + (size_t)kMhRows * mh_ldo(dhp) * 4 +
         (size_t)kMhRows * kMhLds * 4 + (size_t)kMhRows * kMhLdp * 2;
}

// `rows` rows from row0 of one head's slice (dh of every d values) into a
// shared tile of dhp columns; columns dh.. and rows at or past n_rows are zero
__device__ __forceinline__ void load_head_rows(__nv_bfloat16* dst, int ld, const __nv_bfloat16* src, int row0,
                                               int rows, int n_rows, const MhShape& sh) {
  const int chunks = sh.dhp / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kThreads) {
    const int r = i / chunks, c = (i % chunks) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows && c < sh.dh) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * sh.d + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(kThreads)
flash_mh_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, MhShape sh) {
  extern __shared__ __align__(32) unsigned char mh_smem[];
  const int ldh = mh_ldh(sh.dhp), ldo = mh_ldo(sh.dhp);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(mh_smem);
  __nv_bfloat16* kv = qs + kMhRows * ldh;  // the k tile, then the v tile
  float* os = reinterpret_cast<float*>(kv + kMhKeys * ldh);
  float* ss = os + kMhRows * ldo;
  __nv_bfloat16* ps = reinterpret_cast<__nv_bfloat16*>(ss + kMhRows * kMhLds);

  const int q0 = blockIdx.x * kMhRows, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const size_t hoff = (size_t)h * sh.dh;
  const __nv_bfloat16* kb = k + (size_t)b * sh.tk * sh.d + hoff;
  const __nv_bfloat16* vb = v + (size_t)b * sh.tk * sh.d + hoff;

  load_head_rows(qs, ldh, q + (size_t)b * sh.tq * sh.d + hoff, q0, kMhRows, sh.tq, sh);
  for (int i = threadIdx.x; i < kMhRows * ldo; i += kThreads) os[i] = 0.f;

  // the softmax: 8 threads per query row (neighbouring lanes), 8 keys each
  const int row = threadIdx.x / 8, part = threadIdx.x % 8;
  float m_run = kNegInf, l_run = 0.f;

  const int n_tiles = (sh.kv_len + kMhKeys - 1) / kMhKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kMhKeys;
    __syncthreads();  // the previous tile's P V is done with the v tile
    load_head_rows(kv, ldh, kb, k0, kMhKeys, sh.tk, sh);
    __syncthreads();

    {  // S = Q K^T: warp w takes keys k0 + 16w ..
      FragC c;
      wmma::fill_fragment(c, 0.f);
      for (int kk = 0; kk < sh.dhp; kk += 16) {
        FragA a;
        FragBc bk;
        wmma::load_matrix_sync(a, qs + kk, ldh);
        wmma::load_matrix_sync(bk, kv + warp * 16 * ldh + kk, ldh);
        wmma::mma_sync(c, a, bk, c);
      }
      wmma::store_matrix_sync(ss + warp * 16, c, kMhLds, wmma::mem_row_major);
    }
    __syncthreads();
    load_head_rows(kv, ldh, vb, k0, kMhKeys, sh.tk, sh);  // the k tile is no longer read

    float s[8];
    bool valid[8];
    float tile_max = kNegInf;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      valid[i] = k0 + part * 8 + i < sh.kv_len;
      s[i] = valid[i] ? ss[row * kMhLds + part * 8 + i] * sh.scale : kNegInf;
      tile_max = fmaxf(tile_max, s[i]);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m_run, tile_max);
    const float corr = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = valid[i] ? expf(s[i] - m_new) : 0.f;
      psum += p;
      ps[row * kMhLdp + part * 8 + i] = __float2bfloat16(p);
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l_run = l_run * corr + psum;
    m_run = m_new;
    for (int c = part; c < sh.dhp; c += 8) os[row * ldo + c] *= corr;
    __syncthreads();

    // O += P V: warp w takes the output column tiles w, w + 4, ...
    for (int nt = warp; nt < sh.dhp / 16; nt += kWarps) {
      FragC c;
      wmma::load_matrix_sync(c, os + nt * 16, ldo, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kMhKeys / 16; ++kk) {
        FragA a;
        FragBr bv;
        wmma::load_matrix_sync(a, ps + kk * 16, kMhLdp);
        wmma::load_matrix_sync(bv, kv + kk * 16 * ldh + nt * 16, ldh);
        wmma::mma_sync(c, a, bv, c);
      }
      wmma::store_matrix_sync(os + nt * 16, c, ldo, wmma::mem_row_major);
    }
  }
  __syncthreads();

  const int qrow = q0 + row;
  if (qrow < sh.tq) {  // a row with no valid key (l == 0) writes 0
    __nv_bfloat16* dst = out + (size_t)b * sh.tq * sh.d + (size_t)qrow * sh.d + hoff;
    for (int c = part * 2; c < sh.dh; c += 16) {
      const float o0 = l_run == 0.f ? 0.f : os[row * ldo + c] / l_run;
      const float o1 = l_run == 0.f ? 0.f : os[row * ldo + c + 1] / l_run;
      *reinterpret_cast<__nv_bfloat162*>(dst + c) = __floats2bfloat162_rn(o0, o1);
    }
  }
}

}  // namespace

// K5: natural (B, T, D) layout, non-causal, head width d / n_head any
// multiple of 8 up to 768; no logsumexp
extern "C" int flash_mh_fwd_bf16(const void* q, const void* k, const void* v, void* out, int batch, int tq, int tk,
                                 int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  if (dh == kDh) {
    Shape sh{batch, tq, tk, d, n_head, 1, kv_len, 0, scale};
    return launch_fwd(q, k, v, out, nullptr, sh, false, stream);
  }
  if (batch < 1 || tq < 1 || tk < 1 || dh % 8 || dh > kMhMaxDh || kv_len < 1 || kv_len > tk)
    return (int)cudaErrorInvalidValue;
  MhShape sh{batch, tq, tk, d, n_head, dh, (dh + 15) / 16 * 16, kv_len, scale};
  const size_t smem = mh_smem_bytes(sh.dhp);
  cudaError_t err = cudaFuncSetAttribute(flash_mh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tq + kMhRows - 1) / kMhRows, n_head, batch);
  flash_mh_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sh);
  return (int)cudaGetLastError();
}

// K3: natural (B, T, D) layout, non-causal; `lse` may be null, else it is
// (D/128, B, Tq, 2) fp32
extern "C" int flash_h2_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                 int tq, int tk, int d, int n_head, int kv_len, float scale, void* stream) {
  Shape sh{batch, tq, tk, d, n_head, 128 / kDh, kv_len, 0, scale};
  return launch_fwd(q, k, v, out, lse, sh, false, stream);
}

// K6: (dq, dk, dv) of K3 from lse and delta, both (D/128, B, Tq, 2) fp32
extern "C" int flash_h2_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv, int batch, int tq, int tk, int d,
                                 int n_head, int kv_len, float scale, void* stream) {
  Shape sh{batch, tq, tk, d, n_head, 128 / kDh, kv_len, 0, scale};
  return launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, sh, false, stream);
}

// K7: head-split (BH, T, 64); `lse` may be null, else it is (BH, Tq, 1) fp32
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq,
                              int tk, int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, kDh, 1, 1, kv_len, q_offset, scale};
  return launch_fwd(q, k, v, out, lse, sh, causal != 0, stream);
}

// K8: (dq, dk, dv) of K7 from lse and delta, both (BH, Tq, 1) fp32
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv, int bh, int tq, int tk, int kv_len,
                              int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, kDh, 1, 1, kv_len, q_offset, scale};
  return launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, sh, causal != 0, stream);
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
