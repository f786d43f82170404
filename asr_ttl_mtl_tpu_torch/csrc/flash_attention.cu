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
// K3's forward (and K5's at a head width of 64) is `flash_fwd_sm90_kernel`
// and K6 is `flash_bwd_dq_sm90_kernel` + `flash_bwd_dkv_sm90_kernel` below:
// TMA, mbarriers and wgmma, each with its own note. What follows here is
// the design of the other kernels (K7, K8, and K5 at other widths).
//
// Design. The TPU kernels hold all keys (or all queries) of a head in VMEM
// and carry accumulators across a sequential grid axis; on Hopper blocks run
// in parallel and in no order, so each block loops over the other axis
// itself and owns every accumulator it writes (no atomics: the results are
// the same from run to run). One block of 4 warps per 64-row tile; each warp
// owns 16 rows. Products run on the tensor cores through WMMA 16x16x16 (bf16
// in, fp32 accumulate); the per-element softmax work goes through a per-warp
// fp32 tile in shared memory, two lanes per row, 32 columns each.
//   forward (K7): loops over 64-key tiles with an online softmax in fp32; p is
//     rounded to bf16 before P V while l sums the fp32 p, as on the TPU.
//     Causal key tiles wholly above the diagonal, and tiles past kv_len, are
//     skipped. A row with no valid key writes 0 and lse -1e30.
//   dq (K8): per q tile, loops over key tiles, recomputes p from lse, keeps
//     dq in WMMA accumulators; dS is rounded to bf16 before dS K.
//   dkv (K8): per key tile, loops over q tiles (skipping those wholly below
//     the causal diagonal), keeps dk and dv in WMMA accumulators; p and dS
//     are rounded to bf16 before P^T dO and dS^T Q. Key tiles at or past
//     kv_len write zeros.
// K7 and K8 stay on WMMA: at the decoder's causal shapes they beat the
// library call, and causal masking is outside the Hopper kernels' design.
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

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
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

// ------------------------------------- K3 forward on Hopper: TMA + wgmma
//
// Serves K3 (`flash_h2_fwd_bf16`, with and without the logsumexp) and K5 at
// a head width of 64 (`flash_mh_fwd_bf16`). K7 (head-split, causal,
// q_offset) stays on `flash_fwd_kernel` above: it already beats the library
// at its shapes, and causal masking is outside this design.
//
// What bounds it on the H100: the tensor cores and the softmax between the
// two products (~700 FLOPs a byte at the encoder shape), so the design keeps
// the tensor cores fed and the scores out of shared memory:
//   - One CTA takes 128 query rows of one (batch row, head) (64 where
//     tq <= 64: the eval and prefill cross shapes) and walks the keys in
//     tiles of 128 up to kv_len; tiles past kv_len are skipped, the last is
//     masked, and TMA fills rows past tk with zeros.
//   - One producer warp starts the TMA loads: Q once, then K and V tiles of 128
//     keys x 64 columns (128 bytes a row, 128-byte swizzle) from 3-D tensor
//     maps over the natural (B, T, D) layout at column h * 64, into a ring of
//     stages with full and empty mbarriers (4 stages with two consumer
//     warpgroups, 2 with one).
//   - Each consumer warpgroup owns 64 query rows. S = Q K^T runs on
//     wgmma.mma_async m64n128k16 with Q and K from shared memory through
//     descriptors; the online softmax works on the accumulator registers
//     (fp32, a running max per row, p = exp(s - m)); p is rounded to bf16
//     in registers and is the register A operand of O += P V (m64n64k16,
//     V from shared memory through a transposed-B descriptor), while l sums
//     the fp32 p, as on the TPU. O is rescaled in registers and never
//     leaves them until the epilogue writes O / l (and lse = m + log l).
//   - The two consumer warpgroups share each K/V stage, so while one runs
//     its softmax the other's products keep the tensor cores busy.
// The scores are scaled into log2 units (exp2), which moves p by an fp32
// rounding only.

namespace sm90 {

constexpr int kBM = 64;                // query rows a consumer warpgroup owns
constexpr int kBN = 128;               // keys a K/V tile holds
constexpr int kRowB = kDh * 2;         // 128 bytes: a tile row, the swizzle span
constexpr int kTileB = kBN * kRowB;    // 16 KB
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int kWG, int kStages>
struct Smem {  // every tile 1024-byte aligned: the 128-byte swizzle repeats over 8 rows
  alignas(1024) __nv_bfloat16 q[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 k[kStages][kBN * kDh];
  alignas(1024) __nv_bfloat16 v[kStages][kBN * kDh];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};

__device__ __forceinline__ uint32_t saddr(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
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
// a box of the 3-D tensor map at (column, row, batch) into shared memory;
// completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a box of a 1-D tensor map at element c0 into shared memory
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3}], [%2];\n" ::"r"(
          saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0)
      : "memory");
}

// wgmma shared-memory descriptor of a tile of 128-byte rows in the 128-byte
// swizzle: start address, leading byte offset (unused by a K-major operand;
// for the MN-major V, whose 64 columns are one swizzle atom wide, also
// unused), stride byte offset 1024 (8 rows of 128 bytes), layout 1 (128B)
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// the accumulators are written by the asynchronous products: no read may
// move above the wait
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile on the S accumulators of a thread:
// sc[4j + e] is row g (e < 2) or g + 8 (e >= 2), key k0 + 8j + 2 * t4 +
// (e & 1); the 4 threads of a quad share a row. Keys past kv_len are -inf.
// m_run is the running max of s * scale * log2(e); on return sc holds the
// fp32 p = 2^(s * scale * log2(e) - m), l_run the running sum of p, corr
// the factor for the rows' previous output.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], int k0, int kv_len, int t4, float sl2) {
  if (k0 + kBN > kv_len) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= kv_len) sc[i] = -INFINITY;
  }
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m_run[r], tmax[r] * sl2);  // kv_len >= 1: tile 0 makes it finite
    corr[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    neg_m[r] = -m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    sc[i] = ex2(fmaf(sc[i], sl2, neg_m[(i >> 1) & 1]));
    psum[(i >> 1) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 1);
    psum[r] += __shfl_xor_sync(0xffffffffu, psum[r], 2);
    l_run[r] = l_run[r] * corr[r] + psum[r];
  }
}

// p rounded to bf16 pairs as the A fragments of P V: the accumulator of 16
// keys is the A fragment of one k16 step (pairs 4kk .. 4kk + 3)
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i / 4][i % 4] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// d (m64n128 fp32, 64 a thread) (+)= A (64 x 16, shared, K-major) . B (n128 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (m64n64 fp32, 32 a thread) += A (64 x 16 bf16, registers) . B (16 x n64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int kWG, int kStages>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, Shape sh) {
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<Smem<kWG, kStages>*>(smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023));
  const int q0 = blockIdx.x * kWG * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (sh.kv_len + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.k_full[st], 1);
      mbar_init(&s.v_full[st], 1);
      mbar_init(&s.empty[st], kWG * 128);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWG * 4) {  // the producer warp: one thread starts every load
    if (lane == 0) {
      mbar_expect_tx(&s.q_full, kWG * kBM * kRowB);
      tma_load_3d(s.q, &tm_q, &s.q_full, h * kDh, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&s.k_full[st], kTileB);
        tma_load_3d(s.k[st], &tm_k, &s.k_full[st], h * kDh, t * kBN, b);
        mbar_expect_tx(&s.v_full[st], kTileB);
        tma_load_3d(s.v[st], &tm_v, &s.v_full[st], h * kDh, t * kBN, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 + wq * 16 + {g, g + 8} of the CTA's
  // tile in this thread, columns 2 * t4 + {0, 1} of every 8. Per tile t the
  // products of S(t) and P(t-1) V(t-1) are started together, and the softmax
  // of tile t runs while P V of the one before is still on the tensor cores.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const float sl2 = sh.scale * kLog2e;
  float o[32], sc[64], corr[2];
  uint32_t pa[kBN / 16][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  mbar_wait(&s.q_full, 0);
  const uint64_t dq = desc_sw128(s.q + wg * kBM * kDh);
  // S = Q K^T of tile t: 4 steps of 16 columns, +32 bytes each inside the swizzle atom
  auto start_s = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&s.k_full[st], (t / kStages) & 1);
    const uint64_t dk = desc_sw128(s.k[st]);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) wgmma_ss_m64n128(sc, dq + 2 * kk, dk + 2 * kk, kk);
    wg_commit();
  };
  // O += P V of tile t: 8 steps of 16 keys, +2048 bytes of V each
  auto start_pv = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&s.v_full[st], (t / kStages) & 1);
    const uint64_t dv = desc_sw128(s.v[st]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) wgmma_rs_m64n64(o, pa[kk], dv + (uint64_t)(kk * 16 * kRowB >> 4));
    wg_commit();
  };

  wg_fence();
  start_s(0);
  wg_wait<0>();
  reg_fence(sc);
  softmax_tile(sc, m_run, l_run, corr, 0, sh.kv_len, t4, sl2);
  pack_p(sc, pa);
  for (int t = 1; t < n_tiles; ++t) {
    wg_fence();  // sc was rewritten by the softmax, o rescaled, pa packed
    start_s(t);
    start_pv(t - 1);
    wg_wait<1>();  // S(t) is done; P V of t - 1 may still run
    reg_fence(sc);
    softmax_tile(sc, m_run, l_run, corr, t * kBN, sh.kv_len, t4, sl2);
    wg_wait<0>();
    reg_fence(o);
    mbar_arrive(&s.empty[(t - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_p(sc, pa);
  }
  wg_fence();
  start_pv(n_tiles - 1);
  wg_wait<0>();
  reg_fence(o);

  // o[4j + e]: row g (e < 2) or g + 8, column 8j + 2 * t4 + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = q0 + wg * kBM + wq * 16 + g + 8 * r;
    if (qrow >= sh.tq) continue;
    // a row with no valid key (l == 0) writes 0, and lse -1e30
    const float inv = l_run[r] == 0.f ? 0.f : 1.f / l_run[r];
    __nv_bfloat16* dst = out + ((size_t)b * sh.tq + qrow) * sh.d + (size_t)h * kDh + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (lse != nullptr && t4 == 0)
      lse[res_index(sh, h, b, qrow)] = l_run[r] == 0.f ? kNegInf : m_run[r] * kLn2 + logf(l_run[r]);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime so
// that the library links the runtime only
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (B, T, D) bf16 tensor as a 3-D map (D, T, B), boxes of 64 columns x
// `rows` rows x 1, 128-byte swizzle, zeros outside
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int batch, int t, int d, int rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kDh, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the shared-memory limit of `kernel` lifted to `bytes` once a device, not on
// every launch
template <typename Kernel>
cudaError_t lift_smem(Kernel kernel, int bytes, bool (&lifted)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && lifted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) lifted[dev] = true;
  return err;
}

template <int kWG, int kStages>
int run(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode(enc, &tm_q, q, sh.batch, sh.tq, sh.d, kWG * kBM) || !encode(enc, &tm_k, k, sh.batch, sh.tk, sh.d, kBN) ||
      !encode(enc, &tm_v, v, sh.batch, sh.tk, sh.d, kBN))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<kWG, kStages>) + 1024;  // + the alignment slack
  static bool lifted[64] = {};
  const cudaError_t err = lift_smem(flash_fwd_sm90_kernel<kWG, kStages>, smem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kWG * kBM - 1) / (kWG * kBM), sh.n_head, sh.batch);
  flash_fwd_sm90_kernel<kWG, kStages><<<grid, kWG * 128 + 32, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

// ------------------------------------- K6 on Hopper: TMA + wgmma
//
// Serves K6 (`flash_h2_bwd_bf16`); K8 stays on the WMMA kernels above.
//
// What bounds it on the H100: the tensor cores and the exps between the
// products. The backward does 10 T Tk dh FLOPs a head (S, dP, dQ, dK, dV)
// against ~8 T dh bytes, and recomputes p = exp(s scale - lse) for every
// (query, key) pair. The design keeps p and dS in registers and the tiles
// flowing through TMA, in two kernels as the TPU has them: each output is
// written once by the CTA that owns it, with no atomics (the results are
// the same from run to run) and no scratch (a one-pass design's dq
// partials would need atomics or ~600 MB at the encoder shape). The
// split does 7 products where the bound counts 5, and the exps twice.
//   - Each CTA is one producer warpgroup, whose first thread starts every
//     TMA load into a ring of stages (full / empty mbarriers, the maps and
//     swizzle of K3's forward), and one or two consumer warpgroups. The
//     producer gives its registers to the consumers (setmaxnreg 40 / 232:
//     with the 168 registers a thread of a 288- or 384-thread CTA gets,
//     the dq consumers spilled).
//   - dq: one CTA per 128 queries of a (batch row, head) (64 where tq <= 64:
//     the token bucket's cross shape). Q and dO are loaded once, then K and
//     V tiles of 128 keys up to kv_len. S = Q K^T and dP = dO V^T run on
//     wgmma m64n128k16 from shared memory; p and dS = p (dP - delta) scale
//     are computed on the accumulator registers (lse and delta read once a
//     row); dS is rounded to bf16 in registers and is the register A
//     operand of dQ += dS K (m64n64k16, K as an MN-major B, as V is in the
//     forward's P V). dQ stays in registers until the epilogue.
//   - dkv: one CTA per 128 keys (64 where tk <= 64). K and V are loaded
//     once; Q and dO tiles of 64 queries stream through the ring with the
//     tile's lse and delta for both heads of the pair, loaded by 1-D maps
//     over the h2 residuals (staged through a warp's loads instead, a
//     global round trip a tile on the producer's path set dkv's time).
//     S^T = K Q^T and dP^T = V dO^T run on m64n64k16 (Q and dO as K-major
//     Bs); bf16(p)^T and bf16(dS)^T are the register A operands of dV +=
//     P^T dO and dK += dS^T Q, the same Q and dO tiles read again as
//     MN-major Bs. 64-query tiles keep dK, dV, S^T and dP^T at 32 fp32
//     registers each.
//   - In both, the last products of tile t and the first of tile t + 1 are
//     on the tensor cores together, and the two consumer warpgroups share
//     every stage, so one's exps overlap the other's products.
//   - Masks: keys at or past kv_len give p = 0 (dq: -inf scores in the
//     ragged tile; dkv: rows of the CTA's keys, and CTAs wholly past kv_len
//     write zeros without loading); queries past tq give p = 0 (dq: an
//     infinite lse; dkv: the columns past tq, whose residual boxes hold the
//     next pair's or zeros), and TMA fills rows past tq and tk with zeros.
//   - Scores in log2 units (ex2), which moves p by an fp32 rounding only.

// d (m64n64 fp32, 32 a thread) (+)= A (64 x 16, shared, K-major) . B (n64 x 16, shared, K-major)^T
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// a thread's accumulator rows (g, g + 8 of its warp's 16) as bf16, rows < n_rows
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, const float (&x)[N], int row0, int n_rows, int d,
                                          int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= n_rows) continue;
    __nv_bfloat16* dst = base + (size_t)(row0 + 8 * r) * d + 2 * t4;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
  }
}

// the register split of the backward's warpgroups: the producer gives up
// registers that the consumers take (128 x (40 + 2 x 232) <= 65536)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// launch bounds of three warpgroups whatever kWG: the register count at
// entry is then 168, which the split above raises and lowers
constexpr int kBwdThreadsMax = 3 * 128;
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int kWG, int kStages>
struct DqSmem {
  alignas(1024) __nv_bfloat16 q[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 g[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 k[kStages][kBN * kDh];
  alignas(1024) __nv_bfloat16 v[kStages][kBN * kDh];
  uint64_t qg_full, full[kStages], empty[kStages];
};

// dq: one CTA per kWG x 64 queries of a (batch row, head); the producer
// warpgroup loads Q and dO once, then K and V tiles of 128 keys up to kv_len
template <int kWG, int kStages>
__global__ void __launch_bounds__(kBwdThreadsMax, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, Shape sh) {
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<DqSmem<kWG, kStages>*>(smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023));
  const int q0 = blockIdx.x * kWG * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (sh.kv_len + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(&s.qg_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWG * 4) {  // the producer warpgroup: one thread starts every load
    reg_dealloc<kProducerRegs>();
    if (warp == kWG * 4 && lane == 0) {
      mbar_expect_tx(&s.qg_full, 2 * kWG * kBM * kRowB);
      tma_load_3d(s.q, &tm_q, &s.qg_full, h * kDh, q0, b);
      tma_load_3d(s.g, &tm_g, &s.qg_full, h * kDh, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kTileB);
        tma_load_3d(s.k[st], &tm_k, &s.full[st], h * kDh, t * kBN, b);
        tma_load_3d(s.v[st], &tm_v, &s.full[st], h * kDh, t * kBN, b);
      }
    }
    return;
  }
  reg_alloc<kConsumerRegs>();

  // rows wg * 64 + wq * 16 + {g, g + 8} of the CTA's queries; S and dP
  // columns 8j + 2 t4 + {0, 1} of the key tile. dQ of tile t and S, dP of
  // tile t + 1 are on the tensor cores together.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + wg * kBM + wq * 16 + g;
  const float sl2 = sh.scale * kLog2e;
  float lse2[2], dlt[2];  // lse in log2 units and delta x scale; p = 0 on rows past tq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < sh.tq ? lse[res_index(sh, h, b, row)] * kLog2e : INFINITY;
    dlt[r] = row < sh.tq ? delta[res_index(sh, h, b, row)] * sh.scale : 0.f;
  }
  float sc[64], dp[64], acc[32];
  uint32_t da[kBN / 16][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  mbar_wait(&s.qg_full, 0);
  const uint64_t dq_desc = desc_sw128(s.q + wg * kBM * kDh), dg_desc = desc_sw128(s.g + wg * kBM * kDh);
  // S = Q K^T and dP = dO V^T of tile t, 4 steps of 16 columns each
  auto start_s = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&s.full[st], (t / kStages) & 1);
    const uint64_t dk = desc_sw128(s.k[st]), dv = desc_sw128(s.v[st]);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) wgmma_ss_m64n128(sc, dq_desc + 2 * kk, dk + 2 * kk, kk);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) wgmma_ss_m64n128(dp, dg_desc + 2 * kk, dv + 2 * kk, kk);
    wg_commit();
  };
  wg_fence();
  start_s(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages, k0 = t * kBN;
    wg_wait<0>();  // S, dP of tile t, and dQ of tile t - 1
    reg_fence(sc);
    reg_fence(dp);
    reg_fence(acc);
    if (t > 0) mbar_arrive(&s.empty[(t - 1) % kStages]);
    // p = exp(s scale - lse) (0 at keys past kv_len), dS = p (dP - delta)
    // scale, rounded to bf16 pairs straight from the accumulators, which
    // no other instruction writes (ptxas would serialize the products)
    const int k_hi = sh.kv_len - k0;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = (i >> 1) & 1, key = 8 * (i / 4) + 2 * t4;
      const float p0 = key < k_hi ? ex2(fmaf(sc[i], sl2, -lse2[r])) : 0.f;
      const float p1 = key + 1 < k_hi ? ex2(fmaf(sc[i + 1], sl2, -lse2[r])) : 0.f;
      da[i / 8][(i / 2) % 4] =
          pack_bf16(p0 * fmaf(dp[i], sh.scale, -dlt[r]), p1 * fmaf(dp[i + 1], sh.scale, -dlt[r]));
    }
    wg_fence();
    const uint64_t dk = desc_sw128(s.k[st]);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)  // dQ += bf16(dS) K: K as an MN-major B, 16 keys a step
      wgmma_rs_m64n64(acc, da[kk], dk + (uint64_t)(kk * 16 * kRowB >> 4));
    wg_commit();
    if (t + 1 < n_tiles) start_s(t + 1);
  }
  wg_wait<0>();
  reg_fence(acc);
  mbar_arrive(&s.empty[(n_tiles - 1) % kStages]);
  store_acc(dq + (size_t)b * sh.tq * sh.d + (size_t)h * kDh, acc, row0, sh.tq, sh.d, t4);
}

constexpr int kBQ = 64;  // queries a Q / dO tile of the dkv kernel holds
// a residual box: the tile's (query, head % 2) pairs from the 16-byte
// boundary at or below their first (a TMA box starts on one), so 4 more
constexpr int kResBox = 2 * kBQ + 4;
constexpr int kResRow = 2 * kBQ + 32;  // its row in shared memory: 640 bytes, so every row starts on 128

template <int kWG, int kStages>
struct DkvSmem {
  alignas(1024) __nv_bfloat16 k[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 v[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 q[kStages][kBQ * kDh];
  alignas(1024) __nv_bfloat16 g[kStages][kBQ * kDh];
  // lse and delta of the tile's queries for both heads of the head pair,
  // (query, head % 2) in the h2 residual layout, from the element
  // (first & ~3): the tile's first pair is at (first & 3) = 0 or 2
  alignas(128) float lse[kStages][kResRow];
  alignas(128) float dlt[kStages][kResRow];
  uint64_t kv_full, full[kStages], empty[kStages];
};

// dk, dv: one CTA per kWG x 64 keys of a (batch row, head); the producer
// warpgroup loads K and V once, then Q and dO tiles of 64 queries with
// their lse and delta, all by TMA from one thread. CTAs whose keys all lie
// at or past kv_len write zeros.
template <int kWG, int kStages>
__global__ void __launch_bounds__(kBwdThreadsMax, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                          const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_dlt,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh) {
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<DkvSmem<kWG, kStages>*>(smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023));
  const int k0 = blockIdx.x * kWG * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = k0 < sh.kv_len ? (sh.tq + kBQ - 1) / kBQ : 0;
  const int res0 = ((h / sh.hpb) * sh.batch + b) * sh.tq * sh.hpb;  // this (head pair, batch row)'s residuals

  if (threadIdx.x == 0) {
    mbar_init(&s.kv_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&s.full[st], 1);
      mbar_init(&s.empty[st], kWG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kWG * 4) {  // the producer warpgroup: one thread starts every load
    reg_dealloc<kProducerRegs>();
    if (warp == kWG * 4 && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(&s.kv_full, 2 * kWG * kBM * kRowB);
      tma_load_3d(s.k, &tm_k, &s.kv_full, h * kDh, k0, b);
      tma_load_3d(s.v, &tm_v, &s.kv_full, h * kDh, k0, b);
      // a box past tq reads the next pair's residuals (masked below) or
      // zeros past the end
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages, first = res0 + t * kBQ * sh.hpb;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kBQ * kRowB + 2 * kResBox * 4);
        tma_load_3d(s.q[st], &tm_q, &s.full[st], h * kDh, t * kBQ, b);
        tma_load_3d(s.g[st], &tm_g, &s.full[st], h * kDh, t * kBQ, b);
        tma_load_1d(s.lse[st], &tm_lse, &s.full[st], first & ~3);
        tma_load_1d(s.dlt[st], &tm_dlt, &s.full[st], first & ~3);
      }
    }
    return;
  }
  reg_alloc<kConsumerRegs>();

  // keys wg * 64 + wq * 16 + {g, g + 8} of the CTA's; S^T and dP^T columns
  // (queries) 8j + 2 t4 + {0, 1} of the q tile. dV, dK of tile t and S^T,
  // dP^T of tile t + 1 are on the tensor cores together.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const int key0 = k0 + wg * kBM + wq * 16 + g;
  const bool live[2] = {key0 < sh.kv_len, key0 + 8 < sh.kv_len};
  const bool odd = h % sh.hpb != 0;
  const float sl2 = sh.scale * kLog2e;
  float acc_k[32], acc_v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (n_tiles > 0) {
    float sc[32], dp[32];
    uint32_t pa[kBQ / 16][4], da[kBQ / 16][4];
    mbar_wait(&s.kv_full, 0);
    const uint64_t dk_desc = desc_sw128(s.k + wg * kBM * kDh), dv_desc = desc_sw128(s.v + wg * kBM * kDh);
    // S^T = K Q^T and dP^T = V dO^T of q tile t
    auto start_s = [&](int t) {
      const int st = t % kStages;
      mbar_wait(&s.full[st], (t / kStages) & 1);
      const uint64_t dq_desc = desc_sw128(s.q[st]), dg_desc = desc_sw128(s.g[st]);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) wgmma_ss_m64n64(sc, dk_desc + 2 * kk, dq_desc + 2 * kk, kk);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk) wgmma_ss_m64n64(dp, dv_desc + 2 * kk, dg_desc + 2 * kk, kk);
      wg_commit();
    };
    wg_fence();
    start_s(0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kStages;
      wg_wait<0>();  // S^T, dP^T of tile t, and dV, dK of tile t - 1
      reg_fence(sc);
      reg_fence(dp);
      reg_fence(acc_k);
      reg_fence(acc_v);
      if (t > 0) mbar_arrive(&s.empty[(t - 1) % kStages]);
      const int q_hi = sh.tq - t * kBQ;  // columns at or past it are queries past tq: p = 0
      const int first = (res0 + t * kBQ * sh.hpb) & 3;  // the tile's first pair in its residual box
#pragma unroll
      for (int j = 0; j < kBQ / 8; ++j) {
        // (lse, delta) of queries 8j + 2 t4 and + 1, both heads of the pair
        const float* lp = &s.lse[st][first + 16 * j + 4 * t4];
        const float* dl = &s.dlt[st][first + 16 * j + 4 * t4];
        const float2 l0 = *reinterpret_cast<const float2*>(lp), l1 = *reinterpret_cast<const float2*>(lp + 2);
        const float2 d0 = *reinterpret_cast<const float2*>(dl), d1 = *reinterpret_cast<const float2*>(dl + 2);
        const float lse2[2] = {(odd ? l0.y : l0.x) * kLog2e, (odd ? l1.y : l1.x) * kLog2e};
        const float dlt[2] = {(odd ? d0.y : d0.x) * sh.scale, (odd ? d1.y : d1.x) * sh.scale};
        // the pairs (e, e + 1) of rows key0 (e = 0) and key0 + 8 (e = 2),
        // rounded to bf16 straight from the accumulators, as in dq
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = 4 * j + e;
          const bool on0 = live[e >> 1] && 8 * j + 2 * t4 < q_hi, on1 = live[e >> 1] && 8 * j + 2 * t4 + 1 < q_hi;
          const float p0 = on0 ? ex2(fmaf(sc[i], sl2, -lse2[0])) : 0.f;
          const float p1 = on1 ? ex2(fmaf(sc[i + 1], sl2, -lse2[1])) : 0.f;
          pa[i / 8][(i / 2) % 4] = pack_bf16(p0, p1);
          da[i / 8][(i / 2) % 4] = pack_bf16(on0 ? p0 * fmaf(dp[i], sh.scale, -dlt[0]) : 0.f,
                                             on1 ? p1 * fmaf(dp[i + 1], sh.scale, -dlt[1]) : 0.f);
        }
      }
      wg_fence();
      const uint64_t dq_desc = desc_sw128(s.q[st]), dg_desc = desc_sw128(s.g[st]);
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)  // dV += bf16(P)^T dO: dO as an MN-major B, 16 queries a step
        wgmma_rs_m64n64(acc_v, pa[kk], dg_desc + (uint64_t)(kk * 16 * kRowB >> 4));
#pragma unroll
      for (int kk = 0; kk < kBQ / 16; ++kk)  // dK += bf16(dS)^T Q: Q as an MN-major B
        wgmma_rs_m64n64(acc_k, da[kk], dq_desc + (uint64_t)(kk * 16 * kRowB >> 4));
      wg_commit();
      if (t + 1 < n_tiles) start_s(t + 1);
    }
    wg_wait<0>();
    reg_fence(acc_v);
    reg_fence(acc_k);
    mbar_arrive(&s.empty[(n_tiles - 1) % kStages]);
  }
  const size_t off = (size_t)b * sh.tk * sh.d + (size_t)h * kDh;
  store_acc(dk + off, acc_k, key0, sh.tk, sh.d, t4);
  store_acc(dv + off, acc_v, key0, sh.tk, sh.d, t4);
}

template <int kWG, int kStages>
int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           void* dq, const Shape& sh, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_g;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (!encode(enc, &tm_q, q, sh.batch, sh.tq, sh.d, kWG * kBM) || !encode(enc, &tm_g, dout, sh.batch, sh.tq, sh.d, kWG * kBM) ||
      !encode(enc, &tm_k, k, sh.batch, sh.tk, sh.d, kBN) || !encode(enc, &tm_v, v, sh.batch, sh.tk, sh.d, kBN))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DqSmem<kWG, kStages>) + 1024;  // + the alignment slack
  static bool lifted[64] = {};
  cudaError_t err = lift_smem(flash_bwd_dq_sm90_kernel<kWG, kStages>, smem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kWG * kBM - 1) / (kWG * kBM), sh.n_head, sh.batch);
  flash_bwd_dq_sm90_kernel<kWG, kStages><<<grid, (kWG + 1) * 128, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_g, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sh);
  return (int)cudaGetLastError();
}

// an h2 residual (D/128, B, Tq, 2) fp32 as a 1-D map, boxes of one q tile's
// (query, head % 2) pairs
bool encode_res(EncodeTiled enc, CUtensorMap* map, const void* ptr, const Shape& sh) {
  const cuuint64_t dims[1] = {(cuuint64_t)(sh.n_head / sh.hpb) * sh.batch * sh.tq * sh.hpb};
  const cuuint64_t strides[1] = {4};  // none at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)kResBox};
  const cuuint32_t elem[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kWG, int kStages>
int run_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
            void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_g, tm_lse, tm_dlt;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (!encode(enc, &tm_q, q, sh.batch, sh.tq, sh.d, kBQ) || !encode(enc, &tm_g, dout, sh.batch, sh.tq, sh.d, kBQ) ||
      !encode(enc, &tm_k, k, sh.batch, sh.tk, sh.d, kWG * kBM) || !encode(enc, &tm_v, v, sh.batch, sh.tk, sh.d, kWG * kBM) ||
      !encode_res(enc, &tm_lse, lse, sh) || !encode_res(enc, &tm_dlt, delta, sh))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DkvSmem<kWG, kStages>) + 1024;
  static bool lifted[64] = {};
  cudaError_t err = lift_smem(flash_bwd_dkv_sm90_kernel<kWG, kStages>, smem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tk + kWG * kBM - 1) / (kWG * kBM), sh.n_head, sh.batch);
  flash_bwd_dkv_sm90_kernel<kWG, kStages><<<grid, (kWG + 1) * 128, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_g, tm_lse, tm_dlt, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sh);
  return (int)cudaGetLastError();
}

}  // namespace sm90

// non-causal forward over the natural layout (K3, and K5 at a head width of 64)
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh,
                    void* stream) {
  if (bad_shape(sh) || sh.q_offset != 0) return (int)cudaErrorInvalidValue;
  // TMA needs 16-byte aligned bases and row strides (d % 8 == 0 holds: d = 64 * n_head)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (sh.tq <= sm90::kBM) return sm90::run<1, 2>(q, k, v, out, lse, sh, (cudaStream_t)stream);
  return sm90::run<2, 4>(q, k, v, out, lse, sh, (cudaStream_t)stream);
}

// K6: (dq, dk, dv) of the non-causal forward over the natural layout
int launch_bwd_sm90(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, void* dk, void* dv, const Shape& sh, void* stream) {
  if (bad_shape(sh) || sh.q_offset != 0 || sh.hpb != 2) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) % 16)
    return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  const int err = sh.tq <= sm90::kBM ? sm90::run_dq<1, 2>(q, k, v, dout, lse, delta, dq, sh, s)
                                     : sm90::run_dq<2, 4>(q, k, v, dout, lse, delta, dq, sh, s);
  if (err != 0) return err;
  return sh.tk <= sm90::kBM ? sm90::run_dkv<1, 2>(q, k, v, dout, lse, delta, dk, dv, sh, s)
                            : sm90::run_dkv<2, 4>(q, k, v, dout, lse, delta, dk, dv, sh, s);
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
    return launch_fwd_sm90(q, k, v, out, nullptr, sh, stream);
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
  return launch_fwd_sm90(q, k, v, out, lse, sh, stream);
}

// K6: (dq, dk, dv) of K3 from lse and delta, both (D/128, B, Tq, 2) fp32
extern "C" int flash_h2_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv, int batch, int tq, int tk, int d,
                                 int n_head, int kv_len, float scale, void* stream) {
  Shape sh{batch, tq, tk, d, n_head, 128 / kDh, kv_len, 0, scale};
  return launch_bwd_sm90(q, k, v, dout, lse, delta, dq, dk, dv, sh, stream);
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
