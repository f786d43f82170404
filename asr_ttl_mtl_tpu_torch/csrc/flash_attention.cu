// Flash attention for Hopper (sm_90a): the forward K3 (non-causal, natural
// (B, T, D) layout, optional logsumexp), K5 (non-causal, natural layout,
// any head width that is a multiple of 8 up to 768) and K7 (head-split
// (BH, T, dh), causal / q_offset / kv_len, optional logsumexp), and the
// FlashAttention-2 backward K6 (of K3) and K8 (of K7), bf16 in, fp32
// accumulate; and the same functions in fp32, fp32-accurate on the tensor
// cores in 3xTF32 (namespace f32, its own note below). The kernels up to
// a head width of 128 are built for the width classes 32, 64 and 128 (a
// template parameter). K3 and K6 take those widths alone, as the JAX
// package's h2 kernels do; K7, K7-lse, K8 and the fp32 K5 take every
// multiple of 8 from 8 to 128 in the smallest class at or above it
// (`width_class`; Shape::dh is the true width): the columns past dh load
// as zeros (TMA fills a box past the tensor's dh columns with them; the
// fp32 copies are predicated on the column), add nothing to q k^T, and
// give output columns that are never written. The compute is the class's
// (80 columns at 128's work); the bytes read and written are dh's. The bf16
// K5 takes any multiple of 8 up to 768: K3's forward at its class up to 128
// (over per-head tensor maps below a class: route A), the wide forward
// from 136 (route B). K7 and K7-lse take 136-768 on the wide forward of
// their dtype (bf16: route B's kernel; fp32: `f32::fwd_wide_kernel`, which
// the fp32 K5 takes there too), and K8 on the wide backward of its dtype
// (bf16: `flash_bwd_dq_wide_sm90_kernel` + `flash_bwd_dkv_wide_sm90_kernel`;
// fp32: `f32::bwd_dq_wide_kernel` + `f32::bwd_dkv_wide_kernel`), each CTA
// a 128-column slab of its outputs.
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
// The serving forwards (K3, K5 and K7 without the logsumexp) also take
// fp16: the same kernels (`flash_fwd_sm90_kernel`,
// `flash_fwd_wide_sm90_kernel`) instantiated for __half (their element
// type a template parameter: 2 bytes as bf16, so every shared-memory plan,
// TMA box, swizzle and wgmma shape holds), with fp16 tensor maps, wgmma
// `.f16` products and p and the output rounded to fp16 (the `_f16`
// entries). The training kernels stay bf16 and fp32.
//
// Both layouts are one addressing scheme: a block serves (q or k tile, head
// h, batch row b) and reads rows of dh values at stride `d` from
// b*T*d + h*dh. K3/K6 pass the natural layout (d = dh * n_head); K7/K8 pass
// (BH, T, dh) as batch = BH, n_head = 1, d = dh. The lse/delta residuals
// live at ((h / hpb) * batch + b) * T * hpb + t * hpb + h % hpb: the JAX
// h2 layout (D//128, B, Tq, hpb) with hpb = 128 / dh (4, 2 or 1), and
// (BH, Tq, 1) with hpb = 1.
//
// What bounds them on the H100: at the encoder's shapes (T 1536, d 512) the
// forward does 4 T^2 d FLOPs per batch row against 4 T d bytes (~700 FLOPs
// per byte) and the backward 10 T^2 d against 8 T d bytes, so all are bound
// by the tensor cores and the fp32 softmax work between the products (one
// exp per query, key and head: twice dh 64's at dh 32, half at dh 128),
// not by memory. At the decoder's causal shapes (T 48-448) the per-block
// work is small and launch and load latency dominate.
//
// K3's and K7's forwards (and K5's at head widths 32, 64 and 128) are
// `flash_fwd_sm90_kernel`, and K6 and K8 are `flash_bwd_dq_sm90_kernel` +
// `flash_bwd_dkv_sm90_kernel` below: TMA, mbarriers and wgmma, each with its
// own note, the head width a template parameter of all three. The causal
// mask and `q_offset` are one too: a CTA walks key tiles only up to the
// diagonal of its last live query (dkv: q tiles only from the first whose
// last query reaches its first key), and masks per row inside the tiles it
// walks. K7/K8 read (BH, T, dh) as the natural layout with batch = BH and
// one head, and their residuals through `res_index` with hpb = 1.
// K5 is the K3 forward without the logsumexp, over any number of heads
// (its device code reads the natural layout at dh columns a head and never
// assumes d % 128 == 0; the lse layout is the only part that does): at 32,
// 64 and 128 over K3's 3-D maps, at the other widths up to 120 at their
// class over 4-D maps of (dh, n_head, T, B), whose boxes TMA fills with
// zeros past the head's dh columns (route A: the class's compute, dh's
// bytes). From 136 to 768 it is `flash_fwd_wide_sm90_kernel` (route B, its
// own note), which owns 128 output columns of a head a CTA. Both keep p
// and O in registers, as the TPU kernel keeps its row block in VMEM; on
// Hopper the keys go by tiles.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;

// dh: the head width, a multiple of 8 from 8 to 128; the kernels run at
// its width class (`width_class`), columns [dh, class) zeros
struct Shape {
  int batch, tq, tk, d, dh, n_head, hpb, kv_len, q_offset;
  float scale;
};

__device__ __forceinline__ size_t res_index(const Shape& sh, int h, int b, int t) {
  return ((size_t)(h / sh.hpb) * sh.batch + b) * (size_t)sh.tq * sh.hpb + (size_t)t * sh.hpb + h % sh.hpb;
}

// the width class a head width runs in (`ops.width_class`): the smallest of
// 32, 64 and 128 that is >= dh, for a multiple of 8 from 8 to 128; else 0
int width_class(int dh) { return dh < 8 || dh > 128 || dh % 8 ? 0 : dh <= 32 ? 32 : dh <= 64 ? 64 : 128; }

// a shape the kernels of width class kDh take (d = dh * n_head)
bool bad_shape(const Shape& sh, int kDh) {
  return sh.batch < 1 || sh.tq < 1 || sh.tk < 1 || sh.n_head < 1 || sh.d != sh.n_head * sh.dh ||
         width_class(sh.dh) != kDh || sh.kv_len < 1 || sh.kv_len > sh.tk || sh.q_offset < 0 || sh.hpb < 1;
}

constexpr int kWideMaxDh = 768;  // the widest head the wide kernels serve

// a head width the wide kernels do not serve: they take the multiples of 8 from 136 to 768
bool bad_wide_dh(int dh) { return dh <= 128 || dh > kWideMaxDh || dh % 8; }

// a shape the wide kernels of either dtype take: a wide head width,
// residuals (BH, Tq, 1)
bool bad_wide_shape(const Shape& sh) {
  return sh.batch < 1 || sh.tq < 1 || sh.tk < 1 || sh.n_head < 1 || sh.d != sh.n_head * sh.dh || bad_wide_dh(sh.dh) ||
         sh.kv_len < 1 || sh.kv_len > sh.tk || sh.q_offset < 0 || sh.hpb != 1;
}

// ------------------------------ K3 and K7 forward on Hopper: TMA + wgmma
//
// Serves K3 (`flash_h2_fwd_bf16`, with and without the logsumexp), K5 at a
// head width up to 128 (`flash_mh_fwd_bf16`; kHeads: the head maps) and K7
// (`flash_fwd_bf16`: causal or not, any q_offset, with and without the
// logsumexp), each at head widths 32, 64 and 128 (a template parameter).
//
// What bounds it on the H100: the tensor cores and the softmax between the
// two products (~700 FLOPs a byte at the encoder shape at dh 64), so the
// design keeps the tensor cores fed and the scores out of shared memory:
//   - One CTA takes 128 query rows of one (batch row, head) (64 where
//     tq <= 64: the eval and prefill cross shapes, the token bucket) and
//     walks the keys in tiles of kN up to kv_len (128; 64 at dh 128, where
//     O takes 64 registers a thread and 128-key tiles spilled); tiles past
//     kv_len are skipped, the last is masked, and TMA fills rows past tk
//     with zeros.
//   - Causal (a template parameter): the walk also stops at the tile that
//     holds the diagonal of the CTA's last live query, and a tile that
//     reaches past a warp's first row is masked per row (key >= kv_len or
//     key > q_offset + query). Every consumer thread still releases every
//     stage, so a warpgroup whose rows all lie above a tile computes it
//     fully masked: key 0 is valid for every row, so the running max is
//     finite from tile 0 on and p is exactly 0 there.
//   - One producer warp starts the TMA loads: Q once, then K and V tiles of
//     kN keys x dh columns from 3-D tensor maps over the natural (B, T, D)
//     layout at column h * dh (kHeads: 4-D maps over (dh, n_head, T, B) at
//     column 0 of head h), into a ring of stages with full and empty
//     mbarriers (4 stages with two consumer warpgroups, 2 with one). A tile
//     lies in shared memory as
//     `Geo`'s swizzled boxes: one box of 64-byte rows at dh 32 (64-byte
//     swizzle), one of 128-byte rows at dh 64, and two 64-column boxes of
//     128-byte rows at dh 128 (no swizzle spans more than 128 bytes).
//   - Each consumer warpgroup owns 64 query rows. S = Q K^T runs on
//     wgmma.mma_async m64n{kN}k16 (dh / 16 steps) with Q and K from shared
//     memory through descriptors; the online softmax works on the
//     accumulator registers (fp32, a running max per row, p = exp(s - m));
//     p is rounded to bf16 in registers and is the register A operand of
//     O += P V (m64n{dh}k16, V from shared memory through a transposed-B
//     descriptor whose leading byte offset steps from one box to the next
//     at dh 128), while l sums the fp32 p, as on the TPU. O (dh / 2
//     registers a thread) is rescaled in registers and never leaves them
//     until the epilogue writes O / l (and lse = m + log l).
//   - The two consumer warpgroups share each K/V stage, so while one runs
//     its softmax the other's products keep the tensor cores busy.
// The scores are scaled into log2 units (exp2), which moves p by an fp32
// rounding only.

namespace sm90 {

constexpr int kBM = 64;                // query rows a consumer warpgroup owns
// keys a K/V tile of the forward holds: S takes kN / 2 registers a thread
// beside O's dh / 2
template <int kDh>
constexpr int kFwdKeys = kDh == 128 ? 64 : 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// How a tile of R rows x kDh bf16 columns lies in shared memory: kBoxes
// boxes of R rows x kBoxCols columns, each one TMA box, box j at element
// j * R * kBoxCols, every box row kSwB bytes and swizzled over kSwB bytes.
template <int kDh>
struct Geo {
  static_assert(kDh == 32 || kDh == 64 || kDh == 128, "the sm90 kernels take head widths 32, 64 and 128");
  static constexpr int kSwB = kDh * 2 < 128 ? kDh * 2 : 128;  // a box row: the swizzle span
  static constexpr int kBoxCols = kSwB / 2;
  static constexpr int kBoxes = kDh / kBoxCols;
  static constexpr int kRowB = kDh * 2;     // a row over all boxes: the bytes a TMA row moves
  static constexpr int kSteps = kSwB / 32;  // k16 steps of a K-major operand in a box row
};

template <int kDh, int kWG, int kStages, typename T = __nv_bfloat16>  // T: bf16 or fp16, 2 bytes either way
struct Smem {  // every tile 1024-byte aligned: a swizzle pattern repeats over 8 rows (1024 or 512 bytes)
  static constexpr int kN = kFwdKeys<kDh>;
  alignas(1024) T q[kWG * kBM * kDh];
  alignas(1024) T k[kStages][kN * kDh];
  alignas(1024) T v[kStages][kN * kDh];
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

// a tile of `rows` rows x kDh columns at (column col, row, batch b) into
// shared memory, one box a kBoxCols columns; completion counts on `bar`
template <int kDh, typename T>
__device__ __forceinline__ void tma_tile(T* dst, const CUtensorMap* map, uint64_t* bar, int col, int row, int b,
                                         int rows) {
  using G = Geo<kDh>;
#pragma unroll
  for (int j = 0; j < G::kBoxes; ++j)
    tma_load_3d(dst + j * rows * G::kBoxCols, map, bar, col + j * G::kBoxCols, row, b);
}

// a box of the 4-D head map (`encode_heads`) at (column of the head, head,
// row, batch) into shared memory; completion counts its bytes on `bar`
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(saddr(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// tma_tile from the head map: head h's columns 0 .. kDh, those past dh zeros
template <int kDh, typename T>
__device__ __forceinline__ void tma_head_tile(T* dst, const CUtensorMap* map, uint64_t* bar, int h, int row, int b,
                                              int rows) {
  using G = Geo<kDh>;
#pragma unroll
  for (int j = 0; j < G::kBoxes; ++j) tma_load_4d(dst + j * rows * G::kBoxCols, map, bar, j * G::kBoxCols, h, row, b);
}

// wgmma shared-memory descriptor of a tile of kSwB-byte box rows in the
// kSwB-byte swizzle: start address, leading byte offset `box_bytes` (the
// distance between two boxes, which an MN-major operand wider than one box
// steps by: V, K, Q or dO as the B of a product whose N is dh 128; unused
// by a K-major operand and by one box), stride byte offset 8 rows, layout
// 1 (128-byte swizzle) or 2 (64-byte)
template <int kDh>
__device__ __forceinline__ uint64_t desc(const void* p, int box_bytes) {
  constexpr int kSwB = Geo<kDh>::kSwB;
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)((box_bytes >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((8 * kSwB) >> 4) << 32) | ((uint64_t)(kSwB == 128 ? 1 : 2) << 62);
}
// the descriptor offset (16-byte units) of k16 step kk of a K-major operand
// whose boxes lie box_bytes apart: 32 bytes a step inside a box row
template <int kDh>
__device__ __forceinline__ uint64_t kstep(int kk, int box_bytes) {
  constexpr int kS = Geo<kDh>::kSteps;
  return (uint64_t)(((kk / kS) * box_bytes + (kk % kS) * 32) >> 4);
}
// ... of an MN-major operand: 16 rows of kSwB bytes a step
template <int kDh>
__device__ __forceinline__ uint64_t mnstep(int kk) {
  return (uint64_t)((kk * 16 * Geo<kDh>::kSwB) >> 4);
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
// two floats rounded to T (bf16 or fp16) as one word of a fragment
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  } else {
    return pack_bf16(lo, hi);
  }
}

__device__ __forceinline__ float ex2(float x) {  // 2^x on the SFU; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one tile on the S accumulators of a thread:
// sc[4j + e] is row g (e < 2) or g + 8 (e >= 2), key k0 + 8j + 2 * t4 +
// (e & 1); the 4 threads of a quad share a row. Keys at or past the row's
// limit lim[r] (kv_len, and q_offset + query + 1 when causal) are -inf;
// `warp_lim` is the least limit of the warp's rows, so the test is the
// same for the whole warp. m_run is the running max of s * scale *
// log2(e); on return sc holds the fp32 p = 2^(s * scale * log2(e) - m),
// l_run the running sum of p, corr the factor for the rows' previous output.
template <int N>  // N = kN / 2: the tile's kN keys
__device__ __forceinline__ void softmax_tile(float (&sc)[N], float (&m_run)[2], float (&l_run)[2],
                                             float (&corr)[2], int k0, const int (&lim)[2], int warp_lim, int t4,
                                             float sl2) {
  if (k0 + 2 * N > warp_lim) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (k0 + 8 * (i / 4) + 2 * t4 + (i & 1) >= lim[(i >> 1) & 1]) sc[i] = -INFINITY;
  }
  float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < N; ++i) tmax[(i >> 1) & 1] = fmaxf(tmax[(i >> 1) & 1], sc[i]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
    tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
    const float m_new = fmaxf(m_run[r], tmax[r] * sl2);  // key 0 is valid: tile 0 makes it finite
    corr[r] = ex2(m_run[r] - m_new);
    m_run[r] = m_new;
    neg_m[r] = -m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
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

// p rounded to pairs of T (bf16 or fp16) as the A fragments of P V: the
// accumulator of 16 keys is the A fragment of one k16 step (pairs 4kk .. 4kk + 3)
template <typename T, int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N], uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pa[i / 4][i % 4] = pack2<T>(sc[2 * i], sc[2 * i + 1]);
}

// two output values rounded to T at dst (4-byte aligned)
template <typename T>
__device__ __forceinline__ void store2(T* dst, float a, float b) {
  *reinterpret_cast<uint32_t*>(dst) = pack2<T>(a, b);
}

// The wgmma products of the 2-byte operand type T (bf16, or the fp16
// forwards' fp16): one instruction string a shape, the type its argument.
#define FA_WGMMA_SS_32(TY)                                                                                             \
  asm volatile(                                                                                                        \
      "{\n.reg .pred p;\n"                                                                                             \
      "setp.ne.b32 p, %18, 0;\n"                                                                                       \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                                                      \
      "{"                                                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"                                           \
      "}, "                                                                                                            \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])           \
      : "l"(da), "l"(db), "r"(accumulate))
#define FA_WGMMA_SS_64(TY)                                                                                             \
  asm volatile(                                                                                                        \
      "{\n.reg .pred p;\n"                                                                                             \
      "setp.ne.b32 p, %34, 0;\n"                                                                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                                                      \
      "{"                                                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                                 \
      "}, "                                                                                                            \
      "%32, %33, p, 1, 1, 0, 0;\n}\n"                                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])         \
      : "l"(da), "l"(db), "r"(accumulate))
#define FA_WGMMA_SS_128(TY)                                                                                            \
  asm volatile(                                                                                                        \
      "{\n.reg .pred p;\n"                                                                                             \
      "setp.ne.b32 p, %66, 0;\n"                                                                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                                                     \
      "{"                                                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                               \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                               \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                                 \
      "}, "                                                                                                            \
      "%64, %65, p, 1, 1, 0, 0;\n}\n"                                                                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),        \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),        \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),        \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])         \
      : "l"(da), "l"(db), "r"(accumulate))
#define FA_WGMMA_RS_32(TY)                                                                                             \
  asm volatile(                                                                                                        \
      "{\n.reg .pred p;\n"                                                                                             \
      "setp.ne.b32 p, %21, 0;\n"                                                                                       \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                                                      \
      "{"                                                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"                                           \
      "}, "                                                                                                            \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])           \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define FA_WGMMA_RS_64(TY)                                                                                             \
  asm volatile(                                                                                                        \
      "{\n.reg .pred p;\n"                                                                                             \
      "setp.ne.b32 p, %37, 0;\n"                                                                                       \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                                                      \
      "{"                                                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                                 \
      "}, "                                                                                                            \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))
#define FA_WGMMA_RS_128(TY)                                                                                            \
  asm volatile(                                                                                                        \
      "{\n.reg .pred p;\n"                                                                                             \
      "setp.ne.b32 p, %69, 0;\n"                                                                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "                                                     \
      "{"                                                                                                              \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                         \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                               \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                               \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                                 \
      "}, "                                                                                                            \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),          \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),        \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),        \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),        \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),        \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

// d (m64nN fp32, N / 2 a thread) (+)= A (64 x 16, shared, K-major) . B (nN x 16, shared, K-major)^T
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss takes N 32, 64 or 128");
  constexpr bool kF16 = std::is_same<T, __half>::value;
  if constexpr (N == 32) {
    if constexpr (kF16) FA_WGMMA_SS_32("f16"); else FA_WGMMA_SS_32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (kF16) FA_WGMMA_SS_64("f16"); else FA_WGMMA_SS_64("bf16");
  } else {
    if constexpr (kF16) FA_WGMMA_SS_128("f16"); else FA_WGMMA_SS_128("bf16");
  }
}

// d (m64nN fp32, N / 2 a thread) += A (64 x 16 of T, registers) . B (16 x nN, shared, MN-major)
template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_rs takes N 32, 64 or 128");
  constexpr bool kF16 = std::is_same<T, __half>::value;
  if constexpr (N == 32) {
    if constexpr (kF16) FA_WGMMA_RS_32("f16"); else FA_WGMMA_RS_32("bf16");
  } else if constexpr (N == 64) {
    if constexpr (kF16) FA_WGMMA_RS_64("f16"); else FA_WGMMA_RS_64("bf16");
  } else {
    if constexpr (kF16) FA_WGMMA_RS_128("f16"); else FA_WGMMA_RS_128("bf16");
  }
}

// the key tiles of kN that queries [q0, q_end) see: up to kv_len and, when
// causal, up to the tile that holds the last query's diagonal
template <bool kCausal, int kN>
__device__ __forceinline__ int key_tiles(const Shape& sh, int q0, int q_end) {
  const int n = (sh.kv_len + kN - 1) / kN;
  return kCausal ? min(n, (sh.q_offset + min(q_end, sh.tq) - 1) / kN + 1) : n;
}

// the key limit of query row `row`: keys at or past it are masked
template <bool kCausal>
__device__ __forceinline__ int key_limit(const Shape& sh, int row) {
  return kCausal ? min(sh.kv_len, sh.q_offset + row + 1) : sh.kv_len;
}

template <typename T, int kDh, int kWG, int kStages, bool kCausal, bool kHeads>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, float* __restrict__ lse,
                      Shape sh) {
  using G = Geo<kDh>;
  constexpr int kN = kFwdKeys<kDh>;
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<Smem<kDh, kWG, kStages, T>*>(smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023));
  const int q0 = blockIdx.x * kWG * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = key_tiles<kCausal, kN>(sh, q0, q0 + kWG * kBM);

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
    // head h's tile of `rows` rows from `row`: the 3-D maps at column h * dh,
    // or with kHeads the head maps at (0, h)
    auto load = [&](T* dst, const CUtensorMap* map, uint64_t* bar, int row, int rows) {
      if constexpr (kHeads)
        tma_head_tile<kDh>(dst, map, bar, h, row, b, rows);
      else
        tma_tile<kDh>(dst, map, bar, h * sh.dh, row, b, rows);
    };
    if (lane == 0) {
      mbar_expect_tx(&s.q_full, kWG * kBM * G::kRowB);
      load(s.q, &tm_q, &s.q_full, q0, kWG * kBM);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&s.k_full[st], kN * G::kRowB);
        load(s.k[st], &tm_k, &s.k_full[st], t * kN, kN);
        mbar_expect_tx(&s.v_full[st], kN * G::kRowB);
        load(s.v[st], &tm_v, &s.v_full[st], t * kN, kN);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wg * 64 + wq * 16 + {g, g + 8} of the CTA's
  // tile in this thread, columns 2 * t4 + {0, 1} of every 8. Per tile t the
  // products of S(t) and P(t-1) V(t-1) are started together, and the softmax
  // of tile t runs while P V of the one before is still on the tensor cores.
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + wg * kBM + wq * 16;  // the warp's first row
  const int lim[2] = {key_limit<kCausal>(sh, row0 + g), key_limit<kCausal>(sh, row0 + g + 8)};
  const int warp_lim = key_limit<kCausal>(sh, row0);
  const float sl2 = sh.scale * kLog2e;
  constexpr int kQBox = kWG * kBM * G::kSwB, kKBox = kN * G::kSwB;  // bytes of a box of the Q and K/V tiles
  float o[kDh / 2], sc[kN / 2], corr[2];
  uint32_t pa[kN / 16][4];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  mbar_wait(&s.q_full, 0);
  const uint64_t dq = desc<kDh>(s.q + wg * kBM * G::kBoxCols, kQBox);  // this warpgroup's rows of each box
  // S = Q K^T of tile t: dh / 16 steps of 16 columns
  auto start_s = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&s.k_full[st], (t / kStages) & 1);
    const uint64_t dk = desc<kDh>(s.k[st], kKBox);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss<kN, T>(sc, dq + kstep<kDh>(kk, kQBox), dk + kstep<kDh>(kk, kKBox), kk);
    wg_commit();
  };
  // O += P V of tile t: kN / 16 steps of 16 keys
  auto start_pv = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&s.v_full[st], (t / kStages) & 1);
    const uint64_t dv = desc<kDh>(s.v[st], kKBox);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs<kDh, T>(o, pa[kk], dv + mnstep<kDh>(kk));
    wg_commit();
  };

  wg_fence();
  start_s(0);
  wg_wait<0>();
  reg_fence(sc);
  softmax_tile(sc, m_run, l_run, corr, 0, lim, warp_lim, t4, sl2);
  pack_p<T>(sc, pa);
  for (int t = 1; t < n_tiles; ++t) {
    wg_fence();  // sc was rewritten by the softmax, o rescaled, pa packed
    start_s(t);
    start_pv(t - 1);
    wg_wait<1>();  // S(t) is done; P V of t - 1 may still run
    reg_fence(sc);
    softmax_tile(sc, m_run, l_run, corr, t * kN, lim, warp_lim, t4, sl2);
    wg_wait<0>();
    reg_fence(o);
    mbar_arrive(&s.empty[(t - 1) % kStages]);
#pragma unroll
    for (int i = 0; i < kDh / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_p<T>(sc, pa);
  }
  wg_fence();
  start_pv(n_tiles - 1);
  wg_wait<0>();
  reg_fence(o);

  // o[4j + e]: row g (e < 2) or g + 8, column 8j + 2 * t4 + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = row0 + g + 8 * r;
    if (qrow >= sh.tq) continue;
    // a row with no valid key (l == 0) writes 0, and lse -1e30
    const float inv = l_run[r] == 0.f ? 0.f : 1.f / l_run[r];
    T* dst = out + ((size_t)b * sh.tq + qrow) * sh.d + (size_t)h * sh.dh + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDh / 8; ++j)  // the dh real columns only
      if (8 * j < sh.dh) store2(dst + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
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

// the tensor map's element type of T: bf16 or, for the fp16 forwards, fp16
template <typename T>
constexpr CUtensorMapDataType kMapType =
    std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

// a (B, T, D) tensor of T (bf16 or fp16) as a 3-D map (D, T, B), boxes of
// kBoxCols columns x `rows` rows x 1 in the kSwB-byte swizzle, zeros outside
template <int kDh, typename T = __nv_bfloat16>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int batch, int t, int d, int rows) {
  constexpr int kSwB = Geo<kDh>::kSwB;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Geo<kDh>::kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, kMapType<T>, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, kSwB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a (B, T, n_head * dh) tensor of T as a 4-D map (dh, n_head, T, B), boxes
// of kBoxCols columns of one head x `rows` rows in the kSwB-byte swizzle:
// a box's columns past dh are zeros (out of the map's bounds), not the next
// head's, and a box wholly past dh is all zeros. The head stride, dh * 2
// bytes, is a multiple of 16 as TMA needs: dh is a multiple of 8
template <int kDh, typename T = __nv_bfloat16>
bool encode_heads(EncodeTiled enc, CUtensorMap* map, const void* ptr, const Shape& sh, int t, int rows) {
  constexpr int kSwB = Geo<kDh>::kSwB;
  const cuuint64_t dims[4] = {(cuuint64_t)sh.dh, (cuuint64_t)sh.n_head, (cuuint64_t)t, (cuuint64_t)sh.batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh.dh * 2, (cuuint64_t)sh.d * 2, (cuuint64_t)t * sh.d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Geo<kDh>::kBoxCols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, kMapType<T>, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, kSwB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// the forward's shared bytes at a width class and tile plan, the alignment slack included
template <int kDh, int kWG, int kStages>
constexpr int kFwdSmem = (int)sizeof(Smem<kDh, kWG, kStages>) + 1024;

template <typename T, int kDh, int kWG, int kStages, bool kCausal, bool kHeads>
int run(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, cudaStream_t stream) {
  constexpr int kN = kFwdKeys<kDh>;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  const bool encoded = kHeads ? encode_heads<kDh, T>(enc, &tm_q, q, sh, sh.tq, kWG * kBM) &&
                                    encode_heads<kDh, T>(enc, &tm_k, k, sh, sh.tk, kN) &&
                                    encode_heads<kDh, T>(enc, &tm_v, v, sh, sh.tk, kN)
                              : encode<kDh, T>(enc, &tm_q, q, sh.batch, sh.tq, sh.d, kWG * kBM) &&
                                    encode<kDh, T>(enc, &tm_k, k, sh.batch, sh.tk, sh.d, kN) &&
                                    encode<kDh, T>(enc, &tm_v, v, sh.batch, sh.tk, sh.d, kN);
  if (!encoded) return (int)cudaErrorInvalidValue;
  constexpr int kSmem = kFwdSmem<kDh, kWG, kStages>;
  static bool lifted[64] = {};
  const cudaError_t err = lift_smem(flash_fwd_sm90_kernel<T, kDh, kWG, kStages, kCausal, kHeads>, kSmem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kWG * kBM - 1) / (kWG * kBM), sh.n_head, sh.batch);
  flash_fwd_sm90_kernel<T, kDh, kWG, kStages, kCausal, kHeads><<<grid, kWG * 128 + 32, kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

// ------------------------------------- K6 and K8 on Hopper: TMA + wgmma
//
// Serves K6 (`flash_h2_bwd_bf16`) and K8 (`flash_bwd_bf16`: causal or not,
// any q_offset, residuals at hpb = 1), each at head widths 32, 64 and 128
// (a template parameter; the tiles lie in shared memory as the forward's);
// K8 above 128 takes the wide backward after route B, with its own note.
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
//     V tiles of kN keys up to kv_len: 128, and 64 at dh 128, where dQ
//     takes 64 registers a thread. S = Q K^T and dP = dO V^T run on wgmma
//     m64n{kN}k16 from shared memory; p and dS = p (dP - delta) scale are
//     computed on the accumulator registers (lse and delta read once a
//     row); dS is rounded to bf16 in registers and is the register A operand
//     of dQ += dS K (m64n{dh}k16, K as an MN-major B, as V is in the
//     forward's P V). dQ stays in registers until the epilogue.
//   - dkv: one CTA per 128 keys (64 where tk <= 64). K and V are loaded
//     once; Q and dO tiles of kQ queries (64, and 32 at dh 128) stream
//     through the ring with the tile's lse and delta for every head of the
//     h2 lane, loaded by 1-D maps over the residuals (staged through a
//     warp's loads instead, a global round trip a tile on the producer's
//     path set dkv's time). S^T = K Q^T and dP^T = V dO^T run on
//     m64n{kQ}k16 (Q and dO as K-major Bs); bf16(p)^T and bf16(dS)^T are
//     the register A operands of dV += P^T dO and dK += dS^T Q
//     (m64n{dh}k16), the same Q and dO tiles read again as MN-major Bs.
//     dK and dV take dh / 2 registers each, S^T and dP^T kQ / 2: 32 + 32 +
//     32 + 32 at dh 64, 64 + 64 + 16 + 16 at dh 128, which the 32-query
//     tiles keep inside the consumers' 232.
//   - In both, the last products of tile t and the first of tile t + 1 are
//     on the tensor cores together, and the two consumer warpgroups share
//     every stage, so one's exps overlap the other's products.
//   - Masks: keys at or past kv_len give p = 0 (dq: a per-row key limit
//     in the select that computes p; dkv: rows of the CTA's keys, and CTAs
//     wholly past kv_len write zeros without loading); queries past tq give
//     p = 0 (dq: an infinite lse; dkv: the columns past tq, whose residual
//     boxes hold the next lane's or zeros), and TMA fills rows past tq and
//     tk with zeros.
//   - Causal (a template parameter): dq walks key tiles only up to the
//     diagonal of its last live query, and its per-row key limit becomes
//     min(kv_len, q_offset + query + 1); dkv starts at the first q tile
//     whose last query reaches the CTA's first key, masks each key row to
//     the queries at or past key - q_offset, and a CTA whose keys no query
//     sees writes zeros without loading. The masks are selects on p, never
//     writes to the accumulators.
//   - Residuals (a template parameter of dkv): a box holds one q tile's
//     hpb x kQ floats from the 16-byte boundary at or below its first, so
//     up to 4 more: the (query, head % hpb) entries of the h2 layout (hpb
//     4 at dh 32, 2 at dh 64, 1 at dh 128), or the tile's queries of (BH,
//     Tq, 1) (hpb 1, where b * tq + t * kQ need not be a multiple of 4).
//   - Scores in log2 units (ex2), which moves p by an fp32 rounding only.

// a thread's accumulator rows (g, g + 8 of its warp's 16) as bf16, rows <
// n_rows, columns < cols (the head width: the class's columns past it are
// never written)
template <int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* base, const float (&x)[N], int row0, int n_rows, int d,
                                          int cols, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row0 + 8 * r >= n_rows) continue;
    __nv_bfloat16* dst = base + (size_t)(row0 + 8 * r) * d + 2 * t4;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
      if (8 * j < cols)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(x[4 * j + 2 * r], x[4 * j + 2 * r + 1]);
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

// keys a K/V tile of the dq kernel holds
template <int kDh>
constexpr int kDqKeys = kDh == 128 ? 64 : 128;

template <int kDh, int kWG, int kStages>
struct DqSmem {
  static constexpr int kN = kDqKeys<kDh>;
  alignas(1024) __nv_bfloat16 q[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 g[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 k[kStages][kN * kDh];
  alignas(1024) __nv_bfloat16 v[kStages][kN * kDh];
  uint64_t qg_full, full[kStages], empty[kStages];
};

// dq: one CTA per kWG x 64 queries of a (batch row, head); the producer
// warpgroup loads Q and dO once, then K and V tiles of kN keys up to kv_len
template <int kDh, int kWG, int kStages, bool kCausal>
__global__ void __launch_bounds__(kBwdThreadsMax, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, Shape sh) {
  using G = Geo<kDh>;
  constexpr int kN = kDqKeys<kDh>;
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<DqSmem<kDh, kWG, kStages>*>(smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023));
  const int q0 = blockIdx.x * kWG * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = key_tiles<kCausal, kN>(sh, q0, q0 + kWG * kBM);

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
      mbar_expect_tx(&s.qg_full, 2 * kWG * kBM * G::kRowB);
      tma_tile<kDh>(s.q, &tm_q, &s.qg_full, h * sh.dh, q0, b, kWG * kBM);
      tma_tile<kDh>(s.g, &tm_g, &s.qg_full, h * sh.dh, q0, b, kWG * kBM);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kN * G::kRowB);
        tma_tile<kDh>(s.k[st], &tm_k, &s.full[st], h * sh.dh, t * kN, b, kN);
        tma_tile<kDh>(s.v[st], &tm_v, &s.full[st], h * sh.dh, t * kN, b, kN);
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
  constexpr int kQBox = kWG * kBM * G::kSwB, kKBox = kN * G::kSwB;  // bytes of a box of the Q/dO and K/V tiles
  float lse2[2], dlt[2];  // lse in log2 units and delta x scale; p = 0 on rows past tq
  int lim[2];             // the rows' key limits
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < sh.tq ? lse[res_index(sh, h, b, row)] * kLog2e : INFINITY;
    dlt[r] = row < sh.tq ? delta[res_index(sh, h, b, row)] * sh.scale : 0.f;
    lim[r] = key_limit<kCausal>(sh, row);
  }
  float sc[kN / 2], dp[kN / 2], acc[kDh / 2];
  uint32_t da[kN / 16][4];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) acc[i] = 0.f;

  mbar_wait(&s.qg_full, 0);
  const uint64_t dq_desc = desc<kDh>(s.q + wg * kBM * G::kBoxCols, kQBox);
  const uint64_t dg_desc = desc<kDh>(s.g + wg * kBM * G::kBoxCols, kQBox);
  // S = Q K^T and dP = dO V^T of tile t, dh / 16 steps of 16 columns each
  auto start_s = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&s.full[st], (t / kStages) & 1);
    const uint64_t dk = desc<kDh>(s.k[st], kKBox), dv = desc<kDh>(s.v[st], kKBox);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss<kN>(sc, dq_desc + kstep<kDh>(kk, kQBox), dk + kstep<kDh>(kk, kKBox), kk);
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      wgmma_ss<kN>(dp, dg_desc + kstep<kDh>(kk, kQBox), dv + kstep<kDh>(kk, kKBox), kk);
    wg_commit();
  };
  wg_fence();
  start_s(0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages, k0 = t * kN;
    wg_wait<0>();  // S, dP of tile t, and dQ of tile t - 1
    reg_fence(sc);
    reg_fence(dp);
    reg_fence(acc);
    if (t > 0) mbar_arrive(&s.empty[(t - 1) % kStages]);
    // p = exp(s scale - lse) (0 at keys past the row's limit), dS = p (dP -
    // delta) scale, rounded to bf16 pairs straight from the accumulators,
    // which no other instruction writes (ptxas would serialize the products)
    const int k_hi[2] = {lim[0] - k0, lim[1] - k0};
#pragma unroll
    for (int i = 0; i < kN / 2; i += 2) {
      const int r = (i >> 1) & 1, key = 8 * (i / 4) + 2 * t4;
      const float p0 = key < k_hi[r] ? ex2(fmaf(sc[i], sl2, -lse2[r])) : 0.f;
      const float p1 = key + 1 < k_hi[r] ? ex2(fmaf(sc[i + 1], sl2, -lse2[r])) : 0.f;
      da[i / 8][(i / 2) % 4] =
          pack_bf16(p0 * fmaf(dp[i], sh.scale, -dlt[r]), p1 * fmaf(dp[i + 1], sh.scale, -dlt[r]));
    }
    wg_fence();
    const uint64_t dk = desc<kDh>(s.k[st], kKBox);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)  // dQ += bf16(dS) K: K as an MN-major B, 16 keys a step
      wgmma_rs<kDh>(acc, da[kk], dk + mnstep<kDh>(kk));
    wg_commit();
    if (t + 1 < n_tiles) start_s(t + 1);
  }
  wg_wait<0>();
  reg_fence(acc);
  mbar_arrive(&s.empty[(n_tiles - 1) % kStages]);
  store_acc(dq + (size_t)b * sh.tq * sh.d + (size_t)h * sh.dh, acc, row0, sh.tq, sh.d, sh.dh, t4);
}

// queries a Q / dO tile of the dkv kernel holds
template <int kDh>
constexpr int kDkvQueries = kDh == 128 ? 32 : 64;
// a tile's residuals: its hpb x kQ from the 16-byte boundary at or below
// their first (a TMA box starts on one), so 4 more, in kResPieces boxes of
// kResBox floats (a box spans at most 256): one exact box at hpb 1 and 2,
// two boxes of 160 at hpb 4, contiguous in shared memory and in the
// residual array, each 128-byte aligned in shared memory as TMA wants
template <int kHpb, int kQ>
constexpr int kResNeed = kHpb * kQ + 4;
template <int kHpb, int kQ>
constexpr int kResPieces = (kResNeed<kHpb, kQ> + 255) / 256;
template <int kHpb, int kQ>
constexpr int kResBox = kResPieces<kHpb, kQ> == 1
                            ? kResNeed<kHpb, kQ>
                            : ((kResNeed<kHpb, kQ> + kResPieces<kHpb, kQ> - 1) / kResPieces<kHpb, kQ> + 31) / 32 * 32;
// their row in shared memory, a multiple of 128 bytes: 1280 (hpb 4), 640
// (hpb 2), 384 (hpb 1) bytes at 64 queries, 256 at hpb 1 and 32 queries
template <int kHpb, int kQ>
constexpr int kResRow = (kResPieces<kHpb, kQ> * kResBox<kHpb, kQ> + 31) / 32 * 32;

template <int kDh, int kWG, int kStages, int kHpb>
struct DkvSmem {
  static constexpr int kQ = kDkvQueries<kDh>;
  alignas(1024) __nv_bfloat16 k[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 v[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 q[kStages][kQ * kDh];
  alignas(1024) __nv_bfloat16 g[kStages][kQ * kDh];
  // lse and delta of the tile's queries (hpb > 1: for every head of the h2
  // lane, (query, head % hpb) in the h2 layout) from the element (first &
  // ~3): the tile's first is at (first & 3)
  alignas(128) float lse[kStages][kResRow<kHpb, kQ>];
  alignas(128) float dlt[kStages][kResRow<kHpb, kQ>];
  uint64_t kv_full, full[kStages], empty[kStages];
};

// dk, dv: one CTA per kWG x 64 keys of a (batch row, head); the producer
// warpgroup loads K and V once, then Q and dO tiles of kQ queries with
// their lse and delta, all by TMA from one thread. CTAs whose keys all lie
// at or past kv_len, or that no query sees, write zeros.
template <int kDh, int kWG, int kStages, bool kCausal, int kHpb>
__global__ void __launch_bounds__(kBwdThreadsMax, 1)
flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                          const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_dlt,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh) {
  using G = Geo<kDh>;
  constexpr int kQ = kDkvQueries<kDh>;
  extern __shared__ unsigned char smem_raw[];
  auto& s =
      *reinterpret_cast<DkvSmem<kDh, kWG, kStages, kHpb>*>(smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023));
  const int k0 = blockIdx.x * kWG * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // causal: q tiles whose last query lies above the CTA's first key see none of it
  const int n_qt = (sh.tq + kQ - 1) / kQ;
  const int lo = k0 - sh.q_offset - (kQ - 1);
  const int qt0 = kCausal && lo > 0 ? (lo + kQ - 1) / kQ : 0;
  const int n_tiles = k0 < sh.kv_len && qt0 < n_qt ? n_qt - qt0 : 0;
  const int res0 = ((h / kHpb) * sh.batch + b) * sh.tq * kHpb;  // this (h2 lane, batch row)'s residuals

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
      mbar_expect_tx(&s.kv_full, 2 * kWG * kBM * G::kRowB);
      tma_tile<kDh>(s.k, &tm_k, &s.kv_full, h * sh.dh, k0, b, kWG * kBM);
      tma_tile<kDh>(s.v, &tm_v, &s.kv_full, h * sh.dh, k0, b, kWG * kBM);
      // a box past tq reads the next lane's residuals (masked below) or
      // zeros past the end
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages, first = res0 + (qt0 + t) * kQ * kHpb;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        constexpr int kPieces = kResPieces<kHpb, kQ>, kBox = kResBox<kHpb, kQ>;
        mbar_expect_tx(&s.full[st], 2 * kQ * G::kRowB + 2 * kPieces * kBox * 4);
        tma_tile<kDh>(s.q[st], &tm_q, &s.full[st], h * sh.dh, (qt0 + t) * kQ, b, kQ);
        tma_tile<kDh>(s.g[st], &tm_g, &s.full[st], h * sh.dh, (qt0 + t) * kQ, b, kQ);
#pragma unroll
        for (int pc = 0; pc < kPieces; ++pc) {
          tma_load_1d(s.lse[st] + pc * kBox, &tm_lse, &s.full[st], (first & ~3) + pc * kBox);
          tma_load_1d(s.dlt[st] + pc * kBox, &tm_dlt, &s.full[st], (first & ~3) + pc * kBox);
        }
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
  const int hm = h % kHpb;  // the head's place in its h2 lane
  const float sl2 = sh.scale * kLog2e;
  constexpr int kKBox = kWG * kBM * G::kSwB, kQBox = kQ * G::kSwB;  // bytes of a box of the K/V and Q/dO tiles
  float acc_k[kDh / 2], acc_v[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (n_tiles > 0) {
    float sc[kQ / 2], dp[kQ / 2];
    uint32_t pa[kQ / 16][4], da[kQ / 16][4];
    mbar_wait(&s.kv_full, 0);
    const uint64_t dk_desc = desc<kDh>(s.k + wg * kBM * G::kBoxCols, kKBox);
    const uint64_t dv_desc = desc<kDh>(s.v + wg * kBM * G::kBoxCols, kKBox);
    // S^T = K Q^T and dP^T = V dO^T of q tile t
    auto start_s = [&](int t) {
      const int st = t % kStages;
      mbar_wait(&s.full[st], (t / kStages) & 1);
      const uint64_t dq_desc = desc<kDh>(s.q[st], kQBox), dg_desc = desc<kDh>(s.g[st], kQBox);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wgmma_ss<kQ>(sc, dk_desc + kstep<kDh>(kk, kKBox), dq_desc + kstep<kDh>(kk, kQBox), kk);
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        wgmma_ss<kQ>(dp, dv_desc + kstep<kDh>(kk, kKBox), dg_desc + kstep<kDh>(kk, kQBox), kk);
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
      const int q_tile = qt0 + t;
      // the tile's columns c with q_lo[r] <= c < q_hi[r] are the queries key
      // row r sees: none for a key at or past kv_len, none past tq, and when
      // causal none above the key's diagonal (query < key - q_offset)
      int q_lo[2], q_hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        q_lo[r] = kCausal ? key0 + 8 * r - sh.q_offset - q_tile * kQ : 0;
        q_hi[r] = live[r] ? sh.tq - q_tile * kQ : 0;
      }
      const int first = (res0 + q_tile * kQ * kHpb) & 3;  // the tile's first residual in its box
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        // (lse, delta) of queries 8j + 2 t4 and + 1 (hpb > 1: at the head's
        // place among the lane's hpb)
        float lse2[2], dlt[2];
        if constexpr (kHpb == 2) {
          const float* lp = &s.lse[st][first + 16 * j + 4 * t4];
          const float* dl = &s.dlt[st][first + 16 * j + 4 * t4];
          const float2 l0 = *reinterpret_cast<const float2*>(lp), l1 = *reinterpret_cast<const float2*>(lp + 2);
          const float2 d0 = *reinterpret_cast<const float2*>(dl), d1 = *reinterpret_cast<const float2*>(dl + 2);
          lse2[0] = (hm ? l0.y : l0.x) * kLog2e;
          lse2[1] = (hm ? l1.y : l1.x) * kLog2e;
          dlt[0] = (hm ? d0.y : d0.x) * sh.scale;
          dlt[1] = (hm ? d1.y : d1.x) * sh.scale;
        } else {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = first + kHpb * (8 * j + 2 * t4 + c) + hm;
            lse2[c] = s.lse[st][e] * kLog2e;
            dlt[c] = s.dlt[st][e] * sh.scale;
          }
        }
        // the pairs (e, e + 1) of rows key0 (e = 0) and key0 + 8 (e = 2),
        // rounded to bf16 straight from the accumulators, as in dq
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = 4 * j + e, r = e >> 1, c0 = 8 * j + 2 * t4;
          const bool on0 = c0 >= q_lo[r] && c0 < q_hi[r], on1 = c0 + 1 >= q_lo[r] && c0 + 1 < q_hi[r];
          const float p0 = on0 ? ex2(fmaf(sc[i], sl2, -lse2[0])) : 0.f;
          const float p1 = on1 ? ex2(fmaf(sc[i + 1], sl2, -lse2[1])) : 0.f;
          pa[i / 8][(i / 2) % 4] = pack_bf16(p0, p1);
          da[i / 8][(i / 2) % 4] = pack_bf16(on0 ? p0 * fmaf(dp[i], sh.scale, -dlt[0]) : 0.f,
                                             on1 ? p1 * fmaf(dp[i + 1], sh.scale, -dlt[1]) : 0.f);
        }
      }
      wg_fence();
      const uint64_t dq_desc = desc<kDh>(s.q[st], kQBox), dg_desc = desc<kDh>(s.g[st], kQBox);
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)  // dV += bf16(P)^T dO: dO as an MN-major B, 16 queries a step
        wgmma_rs<kDh>(acc_v, pa[kk], dg_desc + mnstep<kDh>(kk));
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)  // dK += bf16(dS)^T Q: Q as an MN-major B
        wgmma_rs<kDh>(acc_k, da[kk], dq_desc + mnstep<kDh>(kk));
      wg_commit();
      if (t + 1 < n_tiles) start_s(t + 1);
    }
    wg_wait<0>();
    reg_fence(acc_v);
    reg_fence(acc_k);
    mbar_arrive(&s.empty[(n_tiles - 1) % kStages]);
  }
  const size_t off = (size_t)b * sh.tk * sh.d + (size_t)h * sh.dh;
  store_acc(dk + off, acc_k, key0, sh.tk, sh.d, sh.dh, t4);
  store_acc(dv + off, acc_v, key0, sh.tk, sh.d, sh.dh, t4);
}

template <int kDh, int kWG, int kStages, bool kCausal>
int run_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
           void* dq, const Shape& sh, cudaStream_t stream) {
  constexpr int kN = kDqKeys<kDh>;
  CUtensorMap tm_q, tm_k, tm_v, tm_g;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (!encode<kDh>(enc, &tm_q, q, sh.batch, sh.tq, sh.d, kWG * kBM) ||
      !encode<kDh>(enc, &tm_g, dout, sh.batch, sh.tq, sh.d, kWG * kBM) ||
      !encode<kDh>(enc, &tm_k, k, sh.batch, sh.tk, sh.d, kN) || !encode<kDh>(enc, &tm_v, v, sh.batch, sh.tk, sh.d, kN))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DqSmem<kDh, kWG, kStages>) + 1024;  // + the alignment slack
  static bool lifted[64] = {};
  cudaError_t err = lift_smem(flash_bwd_dq_sm90_kernel<kDh, kWG, kStages, kCausal>, smem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kWG * kBM - 1) / (kWG * kBM), sh.n_head, sh.batch);
  flash_bwd_dq_sm90_kernel<kDh, kWG, kStages, kCausal><<<grid, (kWG + 1) * 128, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_g, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sh);
  return (int)cudaGetLastError();
}

// a residual, (D/128, B, Tq, hpb) (h2) or (BH, Tq, 1) fp32, as a 1-D map,
// boxes of one q tile's residuals
template <int kHpb, int kQ>
bool encode_res(EncodeTiled enc, CUtensorMap* map, const void* ptr, const Shape& sh) {
  const cuuint64_t dims[1] = {(cuuint64_t)(sh.n_head / kHpb) * sh.batch * sh.tq * kHpb};
  const cuuint64_t strides[1] = {4};  // none at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)kResBox<kHpb, kQ>};
  const cuuint32_t elem[1] = {1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kDh, int kWG, int kStages, bool kCausal, int kHpb>
int run_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
            void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  constexpr int kQ = kDkvQueries<kDh>;
  CUtensorMap tm_q, tm_k, tm_v, tm_g, tm_lse, tm_dlt;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  if (!encode<kDh>(enc, &tm_q, q, sh.batch, sh.tq, sh.d, kQ) ||
      !encode<kDh>(enc, &tm_g, dout, sh.batch, sh.tq, sh.d, kQ) ||
      !encode<kDh>(enc, &tm_k, k, sh.batch, sh.tk, sh.d, kWG * kBM) ||
      !encode<kDh>(enc, &tm_v, v, sh.batch, sh.tk, sh.d, kWG * kBM) ||
      !encode_res<kHpb, kQ>(enc, &tm_lse, lse, sh) || !encode_res<kHpb, kQ>(enc, &tm_dlt, delta, sh))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DkvSmem<kDh, kWG, kStages, kHpb>) + 1024;
  static bool lifted[64] = {};
  cudaError_t err = lift_smem(flash_bwd_dkv_sm90_kernel<kDh, kWG, kStages, kCausal, kHpb>, smem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tk + kWG * kBM - 1) / (kWG * kBM), sh.n_head, sh.batch);
  flash_bwd_dkv_sm90_kernel<kDh, kWG, kStages, kCausal, kHpb><<<grid, (kWG + 1) * 128, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_g, tm_lse, tm_dlt, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sh);
  return (int)cudaGetLastError();
}

// plan[1..5] of `flash_mh_plan_bf16` for the forward at width class kDh
template <int kDh>
void fwd_plan(int tq, int* plan) {
  const bool one = tq <= kBM;  // `fwd`'s choice
  const int vals[5] = {kDh, one ? kBM : 2 * kBM, kFwdKeys<kDh>, one ? 2 : 4,
                       one ? kFwdSmem<kDh, 1, 2> : kFwdSmem<kDh, 2, 4>};
  for (int i = 0; i < 5; ++i) plan[1 + i] = vals[i];
}

// the forward over the natural layout (K3, K5 at a head width of kDh or,
// with `heads`, below it, and K7 as batch = BH, one head)
template <int kDh, typename T>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, bool causal, bool heads,
        cudaStream_t s) {
  // below its class, a head's boxes of the 3-D maps would take its
  // neighbour's columns: one head a row (K7), whose boxes TMA fills with
  // zeros past dh, or the head maps (K5, never causal, no lse)
  if (bad_shape(sh, kDh) || (sh.dh != kDh && sh.n_head != 1 && !heads) || (heads && (causal || lse != nullptr)))
    return (int)cudaErrorInvalidValue;
  // TMA needs 16-byte aligned bases and row strides (d % 8 == 0 holds: d = dh * n_head)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (heads)
    return sh.tq <= kBM ? run<T, kDh, 1, 2, false, true>(q, k, v, out, lse, sh, s)
                        : run<T, kDh, 2, 4, false, true>(q, k, v, out, lse, sh, s);
  if (sh.tq <= kBM)
    return causal ? run<T, kDh, 1, 2, true, false>(q, k, v, out, lse, sh, s)
                  : run<T, kDh, 1, 2, false, false>(q, k, v, out, lse, sh, s);
  return causal ? run<T, kDh, 2, 4, true, false>(q, k, v, out, lse, sh, s)
                : run<T, kDh, 2, 4, false, false>(q, k, v, out, lse, sh, s);
}

// (dq, dk, dv) of the forward: K6 (natural layout, h2 residuals, kHpb =
// 128 / kDh, never causal) and K8 (batch = BH, one head, kHpb 1)
template <int kDh, bool kCausal, int kHpb>
int bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, const Shape& sh, cudaStream_t s) {
  if (bad_shape(sh, kDh) || (sh.dh != kDh && sh.n_head != 1) || sh.hpb != kHpb || sh.n_head % kHpb)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int err = sh.tq <= kBM ? run_dq<kDh, 1, 2, kCausal>(q, k, v, dout, lse, delta, dq, sh, s)
                               : run_dq<kDh, 2, 4, kCausal>(q, k, v, dout, lse, delta, dq, sh, s);
  if (err != 0) return err;
  return sh.tk <= kBM ? run_dkv<kDh, 1, 2, kCausal, kHpb>(q, k, v, dout, lse, delta, dk, dv, sh, s)
                      : run_dkv<kDh, 2, 4, kCausal, kHpb>(q, k, v, dout, lse, delta, dk, dv, sh, s);
}

// ------------------------ K5, K7 and K7-lse at head widths 136-768: route B
//
// Serves `flash_mh_fwd_bf16` (K5: natural layout, non-causal, no lse) and
// `flash_fwd_bf16` (K7: (BH, T, dh) as BH batch rows of one head, causal or
// not, any q_offset and kv_len, with and without the logsumexp) at a head
// width above 128 (a multiple of 8 up to 768). The output of 64 rows at dh
// 768 is 192 KB of fp32, which no warpgroup's registers hold, so a CTA owns
// one slab of up to kSlab output columns of its (query rows, head, batch
// row), and the grid has ceil(dh / kSlab) slabs a head:
//   - The Q tile (64 or 128 rows x the head's columns, in 64-column boxes
//     of the 128-byte swizzle) is loaded once; K tiles (kN keys x the
//     head's columns) and V slabs (kN keys x kSlab columns from the slab's
//     first) stream through a ring of stages with full and empty
//     mbarriers, all by TMA from one producer thread, through the head maps
//     (`encode_heads`): the last 64-column box of a head and a V box past
//     dh are filled with zeros (a V box wholly past dh is not loaded at
//     all: it feeds output columns that are never written).
//   - S = Q K^T runs on wgmma m64n{kN}k16 over the whole head width (4 k16
//     steps a box), the online softmax on its accumulator registers as in
//     K3's forward, p rounded to bf16 in registers is the A operand of O +=
//     P V_slab (m64n128k16, V an MN-major B over two boxes), and O (64
//     registers a thread) stays in registers until the epilogue writes O /
//     l for the slab's columns below dh.
//   - Each slab computes S again: ceil(dh / 128) products Q K^T and one P V
//     where the bound counts one and one (3.5x the bound's products at dh
//     768, 1.5x at 256). Every slab computes the same m and l, so slab 0
//     alone writes the logsumexp.
//   - Causal (a template parameter) as in K3's forward: the walk stops at
//     the tile that holds the diagonal of the CTA's last live query, and a
//     tile that reaches past a warp's first row's limit is masked per row
//     (key >= kv_len or key > q_offset + query). Non-causal, the tile that
//     holds kv_len is masked.
//   - The plan (`wide_plan`, mirrored by `ops.flash_attention.k5_plan`):
//     two consumer warpgroups (128 rows) where the head fits in 4 boxes
//     (dh <= 256) and tq > 64, else one (the decoder's prefill, tq 16-64);
//     64-key tiles up to 6 boxes (dh <= 384), else 32; as many stages, up
//     to 4, as 227 KB holds (2 at dh 768: Q 96 KB and two stages of 48 KB
//     of K and 8 KB of V).

constexpr int kSlab = 128;           // output columns a CTA owns
constexpr int kSmemMax = 232448;     // a block's shared memory on the H100 (227 KB)

struct WidePlan {
  int boxes;   // 64-column boxes of a head's Q and K rows
  int slabs;   // output slabs a head, ceil(dh / kSlab)
  int wg;      // consumer warpgroups, 64 query rows each
  int keys;    // keys a K / V tile
  int stages;  // K / V stages in the ring
  int smem;    // shared bytes, the alignment slack included
};

inline WidePlan wide_plan(int dh, int tq) {
  WidePlan p;
  p.boxes = (dh + 63) / 64;
  p.slabs = (dh + kSlab - 1) / kSlab;
  p.wg = p.boxes <= 4 && tq > kBM ? 2 : 1;
  p.keys = p.boxes <= 6 ? 64 : 32;
  const int q = p.wg * kBM * p.boxes * 128, stage = p.keys * (p.boxes + kSlab / 64) * 128;
  const int barriers = 8 * (1 + 3 * 4);  // at the most stages
  const int fit = (kSmemMax - 1024 - barriers - q) / stage;
  p.stages = fit < 4 ? fit : 4;
  p.smem = 1024 + q + p.stages * stage + 8 * (1 + 3 * p.stages);
  return p;
}

template <typename T, int kWG, int kN, bool kCausal>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
flash_fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, T* __restrict__ out, float* __restrict__ lse,
                           Shape sh, int boxes, int stages) {
  constexpr int kRows = kWG * kBM;
  constexpr int kQBox = kRows * 128, kKBox = kN * 128;  // bytes of a 64-column box of the Q and K / V tiles
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  // Q, then the K tiles, then the V slabs, each box 1024-byte aligned (the
  // boxes are multiples of 4 KB), then the mbarriers
  T* sq = reinterpret_cast<T*>(base);
  T* sk = sq + kRows * 64 * boxes;
  T* sv = sk + stages * kN * 64 * boxes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + stages * kN * kSlab);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + stages;
  uint64_t* empty = v_full + stages;
  const int n_slab = (sh.dh + kSlab - 1) / kSlab;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y / n_slab, c0 = blockIdx.y % n_slab * kSlab, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = key_tiles<kCausal, kN>(sh, q0, q0 + kRows);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], kWG * 128);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kWG * 4) {  // the producer warp: one thread starts every load
    if (lane == 0) {
      const int v_boxes = c0 + 64 < sh.dh ? 2 : 1;
      mbar_expect_tx(q_full, boxes * kQBox);
      for (int j = 0; j < boxes; ++j) tma_load_4d(sq + j * kRows * 64, &tm_q, q_full, 64 * j, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % stages;
        if (t >= stages) mbar_wait(&empty[st], (t / stages - 1) & 1);
        T* kt = sk + st * kN * 64 * boxes;
        mbar_expect_tx(&k_full[st], boxes * kKBox);
        for (int j = 0; j < boxes; ++j) tma_load_4d(kt + j * kN * 64, &tm_k, &k_full[st], 64 * j, h, t * kN, b);
        T* vt = sv + st * kN * kSlab;
        mbar_expect_tx(&v_full[st], v_boxes * kKBox);
        for (int j = 0; j < v_boxes; ++j)
          tma_load_4d(vt + j * kN * 64, &tm_v, &v_full[st], c0 + 64 * j, h, t * kN, b);
      }
    }
    return;
  }

  // a consumer warpgroup, as in K3's forward: rows wg * 64 + wq * 16 + {g,
  // g + 8} of the CTA's tile in this thread, slab columns 2 * t4 + {0, 1}
  // of every 8; S of tile t and P V of tile t - 1 on the tensor cores together
  const int wg = warp / 4, wq = warp % 4, g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + wg * kBM + wq * 16;  // the warp's first row
  const int lim[2] = {key_limit<kCausal>(sh, row0 + g), key_limit<kCausal>(sh, row0 + g + 8)};
  const int warp_lim = key_limit<kCausal>(sh, row0);
  const float sl2 = sh.scale * kLog2e;
  float o[kSlab / 2], sc[kN / 2], corr[2];
  uint32_t pa[kN / 16][4];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) o[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  const uint64_t dq = desc<128>(sq + wg * kBM * 64, kQBox);  // this warpgroup's rows of each box
  // S = Q K^T of tile t: 4 k16 steps of 32 bytes in each 64-column box
  auto start_s = [&](int t) {
    const int st = t % stages;
    mbar_wait(&k_full[st], (t / stages) & 1);
    const uint64_t dk = desc<128>(sk + st * kN * 64 * boxes, kKBox);
    for (int j = 0; j < boxes; ++j) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kN, T>(sc, dq + (uint64_t)((j * kQBox + kk * 32) >> 4),
                        dk + (uint64_t)((j * kKBox + kk * 32) >> 4), j + kk);
    }
    wg_commit();
  };
  // O += P V_slab of tile t: kN / 16 steps of 16 keys
  auto start_pv = [&](int t) {
    const int st = t % stages;
    mbar_wait(&v_full[st], (t / stages) & 1);
    const uint64_t dv = desc<128>(sv + st * kN * kSlab, kKBox);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs<kSlab, T>(o, pa[kk], dv + mnstep<128>(kk));
    wg_commit();
  };

  wg_fence();
  start_s(0);
  wg_wait<0>();
  reg_fence(sc);
  softmax_tile(sc, m_run, l_run, corr, 0, lim, warp_lim, t4, sl2);
  pack_p<T>(sc, pa);
  for (int t = 1; t < n_tiles; ++t) {
    wg_fence();  // sc was rewritten by the softmax, o rescaled, pa packed
    start_s(t);
    start_pv(t - 1);
    wg_wait<1>();  // S(t) is done; P V of t - 1 may still run
    reg_fence(sc);
    softmax_tile(sc, m_run, l_run, corr, t * kN, lim, warp_lim, t4, sl2);
    wg_wait<0>();
    reg_fence(o);
    mbar_arrive(&empty[(t - 1) % stages]);
#pragma unroll
    for (int i = 0; i < kSlab / 2; ++i) o[i] *= corr[(i >> 1) & 1];
    pack_p<T>(sc, pa);
  }
  wg_fence();
  start_pv(n_tiles - 1);
  wg_wait<0>();
  reg_fence(o);

  // o[4j + e]: row g (e < 2) or g + 8, slab column 8j + 2 * t4 + (e & 1)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qrow = row0 + g + 8 * r;
    if (qrow >= sh.tq) continue;
    const float inv = l_run[r] == 0.f ? 0.f : 1.f / l_run[r];
    T* dst = out + ((size_t)b * sh.tq + qrow) * sh.d + (size_t)h * sh.dh + c0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < kSlab / 8; ++j)  // the slab's columns below dh only
      if (c0 + 8 * j < sh.dh) store2(dst + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    // a row with no valid key writes 0, and lse -1e30
    if (lse != nullptr && c0 == 0 && t4 == 0)
      lse[res_index(sh, h, b, qrow)] = l_run[r] == 0.f ? kNegInf : m_run[r] * kLn2 + logf(l_run[r]);
  }
}

template <typename T, int kWG, int kN, bool kCausal>
int run_wide(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, const WidePlan& p,
             cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;  // 64-column boxes in the 128-byte swizzle: the class 128's
  if (!encode_heads<128, T>(enc, &tm_q, q, sh, sh.tq, kWG * kBM) ||
      !encode_heads<128, T>(enc, &tm_k, k, sh, sh.tk, kN) || !encode_heads<128, T>(enc, &tm_v, v, sh, sh.tk, kN))
    return (int)cudaErrorInvalidValue;
  static bool lifted[64] = {};  // to the most any plan takes, once
  const cudaError_t err = lift_smem(flash_fwd_wide_sm90_kernel<T, kWG, kN, kCausal>, kSmemMax, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kWG * kBM - 1) / (kWG * kBM), sh.n_head * p.slabs, sh.batch);
  flash_fwd_wide_sm90_kernel<T, kWG, kN, kCausal><<<grid, kWG * 128 + 32, p.smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<T*>(out), static_cast<float*>(lse), sh, p.boxes, p.stages);
  return (int)cudaGetLastError();
}

template <typename T, bool kCausal>
int run_wide_plan(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh,
                  const WidePlan& p, cudaStream_t s) {
  if (p.wg == 2) return run_wide<T, 2, 64, kCausal>(q, k, v, out, lse, sh, p, s);
  return p.keys == 64 ? run_wide<T, 1, 64, kCausal>(q, k, v, out, lse, sh, p, s)
                      : run_wide<T, 1, 32, kCausal>(q, k, v, out, lse, sh, p, s);
}

// the wide forward at a head width from 136 to 768: K5 (route B; natural
// layout, no lse) and K7 (batch = BH, one head; causal, lse), residuals
// through `res_index`; T bf16 or (K5 and K7 without lse) fp16
template <typename T>
int fwd_wide(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, bool causal,
             cudaStream_t s) {
  if (bad_wide_shape(sh)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const WidePlan p = wide_plan(sh.dh, sh.tq);
  return causal ? run_wide_plan<T, true>(q, k, v, out, lse, sh, p, s)
                : run_wide_plan<T, false>(q, k, v, out, lse, sh, p, s);
}

// -------------------------------------- K8 at head widths 136-768: route B's cut
//
// Serves `flash_bwd_bf16` above 128 ((BH, T, dh) as BH batch rows of one
// head, causal or not, any q_offset and kv_len, residuals (BH, Tq, 1)). The
// outputs outgrow the registers as route B's O did (dq for 64 rows at dh
// 768 is 192 KB of fp32), so each kernel's CTA owns one slab of kSlab
// output columns and recomputes S and dP over the whole head width, as
// route B recomputes S:
//   - dq (`flash_bwd_dq_wide_sm90_kernel`): 64 queries of a (batch row,
//     head) and a slab of dq. Q and dO stay in shared memory for the walk
//     (64-column boxes of the 128-byte swizzle through the head maps, the
//     last box past dh zero-filled); the key tiles stream by boxes: K box j
//     and V box j of kN keys in a ring stage, S += Q_j K_j^T and dP += dO_j
//     V_j^T on wgmma m64n{kN}k16, the stage released as the next box's
//     products start. Then dS = p (dP - delta) scale, rounded to bf16 in
//     registers, is the A operand of dQ += dS K_slab (m64n128k16; the K
//     slab, its kN keys x the slab's columns, a single buffer of its own,
//     which the producer fills while the consumers walk the next tile's
//     boxes). dQ (64 registers a thread) stays in registers.
//   - dk/dv (`flash_bwd_dkv_wide_sm90_kernel`): 64 keys and a slab of dk
//     and dv. K and V stay resident, Q and dO boxes of kWideDkvQ = 32
//     queries stream; S^T += K_j Q_j^T, dP^T += V_j dO_j^T, then dV +=
//     bf16(P)^T dO_slab and dK += bf16(dS)^T Q_slab from a slab buffer that
//     also holds the tile's lse and delta (1-D maps, as the dh <= 128
//     kernel). dK and dV take 64 registers each, S^T and dP^T 16: the dh
//     128 kernel's 64 + 64 + 16 + 16.
//   - Products: each slab recomputes S and dP over the head, so the two
//     kernels do (2n + 1) + (2n + 2) full-width products where the bound
//     counts 5 (n = ceil(dh / 128): 2.2x at 256, 5.4x at 768).
//   - The rules of the dh <= 128 kernels: the masks are selects on p (per
//     row key limits for causal and kv_len; dk/dv: the columns past tq and
//     above a key's diagonal), the causal dq walk stops at the diagonal of
//     its last live query, a dk/dv CTA whose keys no query sees writes zeros
//     without loading, and a slab box wholly past dh is not loaded (it feeds
//     output columns that are never written). No atomics: each output is
//     written once, the same bits on every launch.
//   - The plan (`wide_bwd_plan`, mirrored by `ops.flash_attention.
//     k8_wide_plan`): one consumer warpgroup; dq's key tiles of 64 where two
//     stages fit beside Q and dO (dh <= 704), else 32; as many stages, up to
//     4, as 227 KB holds (dh 768: Q and dO 192 KB, 3 stages of 8 KB and an
//     8 KB slab; dk/dv: K and V 192 KB, 2 stages of 8 KB, a 16.5 KB slab).

constexpr int kWideDkvQ = 32;           // queries a Q / dO box of the wide dk/dv kernel
constexpr int kWideBwdStagesMax = 4;    // stages the mbarriers are laid out for
constexpr int kWideBwdBars = 8 * (1 + 2 * kWideBwdStagesMax + 2);  // own_full, full/empty, slab full/empty

struct WideBwdPlan {
  int boxes;       // 64-column boxes of a head
  int slabs;       // output slabs a head, ceil(dh / kSlab)
  int dq_keys;     // keys a K / V box of the dq kernel
  int dq_stages;   // K / V box stages of the dq kernel
  int dq_smem;     // shared bytes, the alignment slack included
  int dkv_stages;  // Q / dO box stages of the dk/dv kernel (kWideDkvQ queries)
  int dkv_smem;
};

// shared bytes of a wide backward kernel: the resident boxes, the stages, the slab buffer
inline int wide_bwd_smem(int own, int stage, int stages, int slab) {
  return 1024 + own + stages * stage + slab + kWideBwdBars;
}
// the stages that fit beside the rest, up to kWideBwdStagesMax
inline int wide_bwd_stages(int own, int stage, int slab) {
  const int fit = (kSmemMax - wide_bwd_smem(own, 0, 0, slab)) / stage;
  return fit < kWideBwdStagesMax ? fit : kWideBwdStagesMax;
}

inline WideBwdPlan wide_bwd_plan(int dh) {
  WideBwdPlan p;
  p.boxes = (dh + 63) / 64;
  p.slabs = (dh + kSlab - 1) / kSlab;
  const int own = 2 * p.boxes * kBM * 128;  // Q and dO (dk/dv: K and V) of the CTA's 64 rows
  // dq: a stage is a K and a V box of kN keys, the slab two K boxes
  p.dq_keys = wide_bwd_stages(own, 2 * 64 * 128, 2 * 64 * 128) >= 2 ? 64 : 32;
  const int kv = 2 * p.dq_keys * 128;
  p.dq_stages = wide_bwd_stages(own, kv, kv);
  p.dq_smem = wide_bwd_smem(own, kv, p.dq_stages, kv);
  // dk/dv: a stage is a Q and a dO box, the slab two of each and the lse and delta rows
  const int qg = 2 * kWideDkvQ * 128, slab = 2 * qg + 2 * kResRow<1, kWideDkvQ> * 4;
  p.dkv_stages = wide_bwd_stages(own, qg, slab);
  p.dkv_smem = wide_bwd_smem(own, qg, p.dkv_stages, slab);
  return p;
}

// dq: one CTA per 64 queries x one slab of a (batch row, head); one
// producer warp starts every load, one consumer warpgroup computes
template <int kN, bool kCausal>
__global__ void __launch_bounds__(128 + 32, 1)
flash_bwd_dq_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                              const float* __restrict__ lse, const float* __restrict__ delta,
                              __nv_bfloat16* __restrict__ dq, Shape sh, int boxes, int stages) {
  constexpr int kBox = kBM * 128, kNBox = kN * 128;  // bytes of a 64-column box of the CTA's queries, of kN keys
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  // Q's boxes, dO's, the stages (a K box, then a V box), the K slab (two
  // boxes), then the mbarriers; every box 1024-byte aligned
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sg = sq + boxes * kBM * 64;
  __nv_bfloat16* sk = sg + boxes * kBM * 64;
  __nv_bfloat16* ss = sk + stages * 2 * kN * 64;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(ss + 2 * kN * 64);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kWideBwdStagesMax;
  uint64_t* slab_full = empty + kWideBwdStagesMax;
  uint64_t* slab_empty = slab_full + 1;
  const int n_slab = (sh.dh + kSlab - 1) / kSlab;
  const int q0 = blockIdx.x * kBM, h = blockIdx.y / n_slab, c0 = blockIdx.y % n_slab * kSlab, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = key_tiles<kCausal, kN>(sh, q0, q0 + kBM);

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128);  // every consumer thread releases the stage
    }
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one thread starts every load
    if (lane == 0) {
      const int s_boxes = c0 + 64 < sh.dh ? 2 : 1;  // a slab box wholly past dh is not loaded
      mbar_expect_tx(own_full, 2 * boxes * kBox);
      for (int j = 0; j < boxes; ++j) {
        tma_load_4d(sq + j * kBM * 64, &tm_q, own_full, 64 * j, h, q0, b);
        tma_load_4d(sg + j * kBM * 64, &tm_g, own_full, 64 * j, h, q0, b);
      }
      int n = 0;  // boxes loaded so far
      for (int t = 0; t < n_tiles; ++t) {
        for (int j = 0; j < boxes; ++j, ++n) {
          const int st = n % stages;
          if (n >= stages) mbar_wait(&empty[st], (n / stages - 1) & 1);
          __nv_bfloat16* kt = sk + st * 2 * kN * 64;
          mbar_expect_tx(&full[st], 2 * kNBox);
          tma_load_4d(kt, &tm_k, &full[st], 64 * j, h, t * kN, b);
          tma_load_4d(kt + kN * 64, &tm_v, &full[st], 64 * j, h, t * kN, b);
        }
        if (t > 0) mbar_wait(slab_empty, (t - 1) & 1);
        mbar_expect_tx(slab_full, s_boxes * kNBox);
        for (int j = 0; j < s_boxes; ++j) tma_load_4d(ss + j * kN * 64, &tm_k, slab_full, c0 + 64 * j, h, t * kN, b);
      }
    }
    return;
  }

  // the consumer warpgroup: rows wq * 16 + {g, g + 8} of the CTA's queries;
  // S and dP columns 8j + 2 t4 + {0, 1} of the key tile, dQ's of the slab
  const int wq = warp, g = lane / 4, t4 = lane % 4;
  const int row0 = q0 + wq * 16 + g;
  const float sl2 = sh.scale * kLog2e;
  float lse2[2], dlt[2];  // lse in log2 units and delta x scale; p = 0 on rows past tq
  int lim[2];             // the rows' key limits
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    lse2[r] = row < sh.tq ? lse[res_index(sh, h, b, row)] * kLog2e : INFINITY;
    dlt[r] = row < sh.tq ? delta[res_index(sh, h, b, row)] * sh.scale : 0.f;
    lim[r] = key_limit<kCausal>(sh, row);
  }
  float sc[kN / 2], dp[kN / 2], acc[kSlab / 2];
  uint32_t da[kN / 16][4];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) acc[i] = 0.f;

  mbar_wait(own_full, 0);
  const uint64_t dq_desc = desc<128>(sq, kBox), dg_desc = desc<128>(sg, kBox);
  const uint64_t ds_desc = desc<128>(ss, kNBox);  // the K slab as an MN-major B over its two boxes
  int n = 0;
  for (int t = 0; t < n_tiles; ++t) {
    wg_fence();  // sc and dp were read by the last tile's dS
    for (int j = 0; j < boxes; ++j, ++n) {  // S += Q_j K_j^T, dP += dO_j V_j^T: 4 k16 steps a box
      const int st = n % stages;
      mbar_wait(&full[st], (n / stages) & 1);
      const uint64_t dk = desc<128>(sk + st * 2 * kN * 64, kNBox), dv = desc<128>(sk + (st * 2 + 1) * kN * 64, kNBox);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kN>(sc, dq_desc + (uint64_t)((j * kBox + kk * 32) >> 4), dk + (uint64_t)(kk * 2), j + kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<kN>(dp, dg_desc + (uint64_t)((j * kBox + kk * 32) >> 4), dv + (uint64_t)(kk * 2), j + kk);
      wg_commit();
      if (j > 0) {  // box j - 1's products are done: its stage is free
        wg_wait<1>();
        mbar_arrive(&empty[(n - 1) % stages]);
      }
    }
    wg_wait<0>();
    reg_fence(sc);
    reg_fence(dp);
    mbar_arrive(&empty[(n - 1) % stages]);
    // p = exp(s scale - lse) (0 at keys past the row's limit), dS = p (dP -
    // delta) scale, rounded to bf16 pairs as in flash_bwd_dq_sm90_kernel
    const int k_hi[2] = {lim[0] - t * kN, lim[1] - t * kN};
#pragma unroll
    for (int i = 0; i < kN / 2; i += 2) {
      const int r = (i >> 1) & 1, key = 8 * (i / 4) + 2 * t4;
      const float p0 = key < k_hi[r] ? ex2(fmaf(sc[i], sl2, -lse2[r])) : 0.f;
      const float p1 = key + 1 < k_hi[r] ? ex2(fmaf(sc[i + 1], sl2, -lse2[r])) : 0.f;
      da[i / 8][(i / 2) % 4] =
          pack_bf16(p0 * fmaf(dp[i], sh.scale, -dlt[r]), p1 * fmaf(dp[i + 1], sh.scale, -dlt[r]));
    }
    mbar_wait(slab_full, t & 1);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)  // dQ += bf16(dS) K_slab, 16 keys a step
      wgmma_rs<kSlab>(acc, da[kk], ds_desc + mnstep<128>(kk));
    wg_commit();
    wg_wait<0>();
    reg_fence(acc);
    mbar_arrive(slab_empty);
  }
  store_acc(dq + (size_t)b * sh.tq * sh.d + (size_t)h * sh.dh + c0, acc, row0, sh.tq, sh.d, sh.dh - c0, t4);
}

// dk, dv: one CTA per 64 keys x one slab of a (batch row, head). CTAs whose
// keys all lie at or past kv_len, or that no query sees, write zeros
template <bool kCausal>
__global__ void __launch_bounds__(128 + 32, 1)
flash_bwd_dkv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_g,
                               const __grid_constant__ CUtensorMap tm_lse, const __grid_constant__ CUtensorMap tm_dlt,
                               __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, Shape sh, int boxes,
                               int stages) {
  constexpr int kQ = kWideDkvQ;
  constexpr int kBox = kBM * 128, kQBox = kQ * 128;  // bytes of a 64-column box of the CTA's keys, of kQ queries
  constexpr int kRBox = kResBox<1, kQ>, kRRow = kResRow<1, kQ>;
  static_assert(kResPieces<1, kQ> == 1, "one residual box a tile");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023);
  // K's boxes, V's, the stages (a Q box, then a dO box), the slab (Q's two
  // boxes, dO's two, the lse row, the delta row), then the mbarriers
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* sv = sk + boxes * kBM * 64;
  __nv_bfloat16* sq = sv + boxes * kBM * 64;
  __nv_bfloat16* sqs = sq + stages * 2 * kQ * 64;
  __nv_bfloat16* sgs = sqs + 2 * kQ * 64;
  float* slse = reinterpret_cast<float*>(sgs + 2 * kQ * 64);
  float* sdlt = slse + kRRow;
  uint64_t* own_full = reinterpret_cast<uint64_t*>(sdlt + kRRow);
  uint64_t* full = own_full + 1;
  uint64_t* empty = full + kWideBwdStagesMax;
  uint64_t* slab_full = empty + kWideBwdStagesMax;
  uint64_t* slab_empty = slab_full + 1;
  const int n_slab = (sh.dh + kSlab - 1) / kSlab;
  const int k0 = blockIdx.x * kBM, h = blockIdx.y / n_slab, c0 = blockIdx.y % n_slab * kSlab, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // causal: q tiles whose last query lies above the CTA's first key see none of it
  const int n_qt = (sh.tq + kQ - 1) / kQ;
  const int lo = k0 - sh.q_offset - (kQ - 1);
  const int qt0 = kCausal && lo > 0 ? (lo + kQ - 1) / kQ : 0;
  const int n_tiles = k0 < sh.kv_len && qt0 < n_qt ? n_qt - qt0 : 0;
  const int res0 = (h * sh.batch + b) * sh.tq;  // this (head, batch row)'s residuals (hpb 1)

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 128);
    }
    mbar_init(slab_full, 1);
    mbar_init(slab_empty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {  // the producer warp: one thread starts every load
    if (lane == 0 && n_tiles > 0) {
      const int s_boxes = c0 + 64 < sh.dh ? 2 : 1;
      mbar_expect_tx(own_full, 2 * boxes * kBox);
      for (int j = 0; j < boxes; ++j) {
        tma_load_4d(sk + j * kBM * 64, &tm_k, own_full, 64 * j, h, k0, b);
        tma_load_4d(sv + j * kBM * 64, &tm_v, own_full, 64 * j, h, k0, b);
      }
      int n = 0;
      for (int t = 0; t < n_tiles; ++t) {
        const int q_row = (qt0 + t) * kQ;
        for (int j = 0; j < boxes; ++j, ++n) {
          const int st = n % stages;
          if (n >= stages) mbar_wait(&empty[st], (n / stages - 1) & 1);
          __nv_bfloat16* qt = sq + st * 2 * kQ * 64;
          mbar_expect_tx(&full[st], 2 * kQBox);
          tma_load_4d(qt, &tm_q, &full[st], 64 * j, h, q_row, b);
          tma_load_4d(qt + kQ * 64, &tm_g, &full[st], 64 * j, h, q_row, b);
        }
        if (t > 0) mbar_wait(slab_empty, (t - 1) & 1);
        // a residual box past tq reads the next row's residuals (masked
        // below) or zeros past the end
        const int first = (res0 + q_row) & ~3;
        mbar_expect_tx(slab_full, 2 * s_boxes * kQBox + 2 * kRBox * 4);
        for (int j = 0; j < s_boxes; ++j) {
          tma_load_4d(sqs + j * kQ * 64, &tm_q, slab_full, c0 + 64 * j, h, q_row, b);
          tma_load_4d(sgs + j * kQ * 64, &tm_g, slab_full, c0 + 64 * j, h, q_row, b);
        }
        tma_load_1d(slse, &tm_lse, slab_full, first);
        tma_load_1d(sdlt, &tm_dlt, slab_full, first);
      }
    }
    return;
  }

  // the consumer warpgroup: keys wq * 16 + {g, g + 8} of the CTA's; S^T and
  // dP^T columns (queries) 8j + 2 t4 + {0, 1} of the q tile
  const int wq = warp, g = lane / 4, t4 = lane % 4;
  const int key0 = k0 + wq * 16 + g;
  const bool live[2] = {key0 < sh.kv_len, key0 + 8 < sh.kv_len};
  const float sl2 = sh.scale * kLog2e;
  float acc_k[kSlab / 2], acc_v[kSlab / 2];
#pragma unroll
  for (int i = 0; i < kSlab / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

  if (n_tiles > 0) {
    float sc[kQ / 2], dp[kQ / 2];
    uint32_t pa[kQ / 16][4], da[kQ / 16][4];
    mbar_wait(own_full, 0);
    const uint64_t dk_desc = desc<128>(sk, kBox), dv_desc = desc<128>(sv, kBox);
    const uint64_t dqs = desc<128>(sqs, kQBox), dgs = desc<128>(sgs, kQBox);  // the slabs as MN-major Bs
    int n = 0;
    for (int t = 0; t < n_tiles; ++t) {
      wg_fence();
      for (int j = 0; j < boxes; ++j, ++n) {  // S^T += K_j Q_j^T, dP^T += V_j dO_j^T
        const int st = n % stages;
        mbar_wait(&full[st], (n / stages) & 1);
        const uint64_t dq_ = desc<128>(sq + st * 2 * kQ * 64, kQBox);
        const uint64_t dg_ = desc<128>(sq + (st * 2 + 1) * kQ * 64, kQBox);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kQ>(sc, dk_desc + (uint64_t)((j * kBox + kk * 32) >> 4), dq_ + (uint64_t)(kk * 2), j + kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<kQ>(dp, dv_desc + (uint64_t)((j * kBox + kk * 32) >> 4), dg_ + (uint64_t)(kk * 2), j + kk);
        wg_commit();
        if (j > 0) {
          wg_wait<1>();
          mbar_arrive(&empty[(n - 1) % stages]);
        }
      }
      wg_wait<0>();
      reg_fence(sc);
      reg_fence(dp);
      mbar_arrive(&empty[(n - 1) % stages]);
      mbar_wait(slab_full, t & 1);
      const int q_tile = qt0 + t;
      // the tile's columns c with q_lo[r] <= c < q_hi[r] are the queries key
      // row r sees, as in flash_bwd_dkv_sm90_kernel
      int q_lo[2], q_hi[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        q_lo[r] = kCausal ? key0 + 8 * r - sh.q_offset - q_tile * kQ : 0;
        q_hi[r] = live[r] ? sh.tq - q_tile * kQ : 0;
      }
      const int first = (res0 + q_tile * kQ) & 3;  // the tile's first residual in its box
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        float lse2[2], dlt[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          lse2[c] = slse[first + 8 * j + 2 * t4 + c] * kLog2e;
          dlt[c] = sdlt[first + 8 * j + 2 * t4 + c] * sh.scale;
        }
#pragma unroll
        for (int e = 0; e < 4; e += 2) {
          const int i = 4 * j + e, r = e >> 1, c = 8 * j + 2 * t4;
          const bool on0 = c >= q_lo[r] && c < q_hi[r], on1 = c + 1 >= q_lo[r] && c + 1 < q_hi[r];
          const float p0 = on0 ? ex2(fmaf(sc[i], sl2, -lse2[0])) : 0.f;
          const float p1 = on1 ? ex2(fmaf(sc[i + 1], sl2, -lse2[1])) : 0.f;
          pa[i / 8][(i / 2) % 4] = pack_bf16(p0, p1);
          da[i / 8][(i / 2) % 4] = pack_bf16(on0 ? p0 * fmaf(dp[i], sh.scale, -dlt[0]) : 0.f,
                                             on1 ? p1 * fmaf(dp[i + 1], sh.scale, -dlt[1]) : 0.f);
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)  // dV += bf16(P)^T dO_slab, 16 queries a step
        wgmma_rs<kSlab>(acc_v, pa[kk], dgs + mnstep<128>(kk));
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)  // dK += bf16(dS)^T Q_slab
        wgmma_rs<kSlab>(acc_k, da[kk], dqs + mnstep<128>(kk));
      wg_commit();
      wg_wait<0>();
      reg_fence(acc_v);
      reg_fence(acc_k);
      mbar_arrive(slab_empty);
    }
  }
  const size_t off = (size_t)b * sh.tk * sh.d + (size_t)h * sh.dh + c0;
  store_acc(dk + off, acc_k, key0, sh.tk, sh.d, sh.dh - c0, t4);
  store_acc(dv + off, acc_v, key0, sh.tk, sh.d, sh.dh - c0, t4);
}

template <int kN, bool kCausal>
int run_dq_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                void* dq, const Shape& sh, const WideBwdPlan& p, cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_g;  // 64-column boxes in the 128-byte swizzle
  if (!encode_heads<128>(enc, &tm_q, q, sh, sh.tq, kBM) || !encode_heads<128>(enc, &tm_g, dout, sh, sh.tq, kBM) ||
      !encode_heads<128>(enc, &tm_k, k, sh, sh.tk, kN) || !encode_heads<128>(enc, &tm_v, v, sh, sh.tk, kN))
    return (int)cudaErrorInvalidValue;
  static bool lifted[64] = {};  // to the most any plan takes, once
  const cudaError_t err = lift_smem(flash_bwd_dq_wide_sm90_kernel<kN, kCausal>, kSmemMax, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kBM - 1) / kBM, sh.n_head * p.slabs, sh.batch);
  flash_bwd_dq_wide_sm90_kernel<kN, kCausal><<<grid, 128 + 32, p.dq_smem, stream>>>(
      tm_q, tm_k, tm_v, tm_g, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), sh, p.boxes, p.dq_stages);
  return (int)cudaGetLastError();
}

template <bool kCausal>
int run_dkv_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                 void* dk, void* dv, const Shape& sh, const WideBwdPlan& p, cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v, tm_g, tm_lse, tm_dlt;
  if (!encode_heads<128>(enc, &tm_k, k, sh, sh.tk, kBM) || !encode_heads<128>(enc, &tm_v, v, sh, sh.tk, kBM) ||
      !encode_heads<128>(enc, &tm_q, q, sh, sh.tq, kWideDkvQ) ||
      !encode_heads<128>(enc, &tm_g, dout, sh, sh.tq, kWideDkvQ) || !encode_res<1, kWideDkvQ>(enc, &tm_lse, lse, sh) ||
      !encode_res<1, kWideDkvQ>(enc, &tm_dlt, delta, sh))
    return (int)cudaErrorInvalidValue;
  static bool lifted[64] = {};
  const cudaError_t err = lift_smem(flash_bwd_dkv_wide_sm90_kernel<kCausal>, kSmemMax, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tk + kBM - 1) / kBM, sh.n_head * p.slabs, sh.batch);
  flash_bwd_dkv_wide_sm90_kernel<kCausal><<<grid, 128 + 32, p.dkv_smem, stream>>>(
      tm_q, tm_k, tm_v, tm_g, tm_lse, tm_dlt, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), sh,
      p.boxes, p.dkv_stages);
  return (int)cudaGetLastError();
}

// K8 at a head width from 136 to 768: the dq kernel, then the dk/dv kernel
template <bool kCausal>
int bwd_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
             void* dq, void* dk, void* dv, const Shape& sh, cudaStream_t s) {
  if (bad_wide_shape(sh)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const WideBwdPlan p = wide_bwd_plan(sh.dh);
  const int err = p.dq_keys == 64 ? run_dq_wide<64, kCausal>(q, k, v, dout, lse, delta, dq, sh, p, s)
                                  : run_dq_wide<32, kCausal>(q, k, v, dout, lse, delta, dq, sh, p, s);
  if (err != 0) return err;
  return run_dkv_wide<kCausal>(q, k, v, dout, lse, delta, dk, dv, sh, p, s);
}

}  // namespace sm90

// the forward at the width class of sh.dh (below the class only with one
// head a row, K7, or over the head maps, K5's route A), of T (bf16 or fp16)
template <typename T = __nv_bfloat16>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh,
                    bool causal, void* stream, bool heads = false) {
  auto s = (cudaStream_t)stream;
  switch (width_class(sh.dh)) {
    case 32: return sm90::fwd<32, T>(q, k, v, out, lse, sh, causal, heads, s);
    case 64: return sm90::fwd<64, T>(q, k, v, out, lse, sh, causal, heads, s);
    case 128: return sm90::fwd<128, T>(q, k, v, out, lse, sh, causal, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifndef FLASH_ATTENTION_F16  // the fp16 entries' translation unit instantiates the fp16 forwards alone
// K6 at head width sh.dh (32, 64 or 128): the h2 residuals hold hpb = 128 /
// dh heads a lane
int launch_h2_bwd_sm90(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, void* dq, void* dk, void* dv, const Shape& sh, void* stream) {
  auto s = (cudaStream_t)stream;
  switch (sh.dh) {
    case 32: return sm90::bwd<32, false, 4>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 64: return sm90::bwd<64, false, 2>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 128: return sm90::bwd<128, false, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // FLASH_ATTENTION_F16

// K8 at the width class of sh.dh, residuals (BH, Tq, 1)
template <bool kCausal>
int launch_bwd_sm90(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, void* dk, void* dv, const Shape& sh, void* stream) {
  auto s = (cudaStream_t)stream;
  switch (width_class(sh.dh)) {
    case 32: return sm90::bwd<32, kCausal, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 64: return sm90::bwd<64, kCausal, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 128: return sm90::bwd<128, kCausal, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the h2 lane's head count, 128 / dh, for a head width K3 and K6 serve (a
// width class; 0 otherwise)
int h2_hpb(int dh) { return dh == 32 || dh == 64 || dh == 128 ? 128 / dh : 0; }

// ------------------------------------ fp32: K3, K5, K7, K6, K8 at dh 32-128
// (K5, K7, K7-lse and K8 above 128: the wide kernels after these, each with its note)
//
// fp32 in, fp32 out, fp32-accurate products on the tensor cores in 3xTF32.
// Serves `flash_h2_fwd_f32`, `flash_mh_fwd_f32`, `flash_fwd_f32`,
// `flash_h2_bwd_f32` and `flash_bwd_f32` at head widths 32, 64 and 128 (the
// width a template parameter of every kernel and helper below) over the
// layouts, masks and residuals of the bf16 kernels (`Shape`, `res_index`),
// causal a template parameter; p and dS stay fp32, as the JAX kernels keep
// them in v's (q's) dtype.
//
// What bounds it on the H100: the products. The encoder forward does
// 4 T^2 dh FLOPs a head against 16 T dh bytes, so memory is far off. FFMA
// on the CUDA cores peaks at 67 TFLOP/s. One TF32 pass on the tensor cores
// keeps 11 significant bits of each operand and moves a score by ~5e-4 of
// its size, 25x the 2e-5 these kernels are held to. Three passes reach fp32
// accuracy: x = big + small with big = tf32(x), `cvt.rna.tf32.f32`'s
// rounding (to nearest, ties away; done as two integer operations, for
// finite x the same bits) and small = x - big, exact in fp32, of which the
// tensor cores read the top 19 bits; a b = small_a big_b + big_a small_b +
// big_a big_b; small_a small_b (~2^-22 of the product) is dropped. The
// bound is then 3x the FLOPs over the 495 TFLOP/s of dense TF32 (165
// TFLOP/s of fp32-accurate products, 2.5x the FFMA peak); in practice
// mma.sync runs TF32 well below that peak (a probe of 8 independent
// products a warp measured it), so the design keeps mma.sync fed and
// spends few other instructions:
//   - mma.sync m16n8k8 tf32, fp32 accumulators in registers. wgmma takes
//     tf32 operands only K-major from shared memory, and V in P V, K in
//     dS K, and dO and Q in the dk/dv products are MN-major in these
//     layouts: wgmma would need a transposing pass (later work).
//   - The tensor cores' sums truncate: a long reduction into one
//     accumulator drifts by ~2^-24 of its size a step, all one way (over
//     1500 keys, most of the 2e-5 bound). So each n8 tile of a reduction
//     over keys (queries) sums 16 of them into a zeroed accumulator, added
//     to the running sum in fp32; and the two correction passes of a score
//     go into their own accumulator, 2^-11 the size of the first's.
//   - A CTA of 4 warps owns 64 rows (queries; keys in the dk/dv kernel), 16
//     a warp, and walks the other side in tiles (`Cfg`): keys in the
//     forward (64 a tile, 32 at dh 128; scored 32 at a time) and the dq
//     kernel (32, 16 at dh 128), queries in the dk/dv kernel (32, 16 at dh
//     128; 16 at a time). Shared memory a CTA: forward 24 x tile x dh
//     bytes (48, 96 and 96 KB at dh 32, 64 and 128), dq 40, 80 and 112 KB,
//     dk/dv 56.5, 112.5 and 112.25 KB: two CTAs an SM at every width.
//   - Q, which a warp of the forward or the dq kernel keeps for the whole
//     walk, is read once from global memory as A fragments into registers:
//     split once at dh 32 and 64 (dh registers a thread), raw at dh 128
//     (64 registers, split a k8 step at a time), where the split Q and the
//     output accumulator (dh / 2) would take 192 of the 255 registers. The
//     other operands a warp keeps (dO in the dq kernel; K and V in the
//     dk/dv kernel, whose two accumulators take dh registers) stay in split
//     tiles of 64 rows, but for K and V at dh 128: split tiles of both
//     would take 128 KB and leave one CTA an SM, so they stay raw (64 KB,
//     rows swizzled by `swz_raw`) and each A fragment is split as it is
//     read, once a k8 step a query part. dh 32 and 64 run at 174-250
//     registers a thread with no spill; dh 128's three kernels take all
//     255 and spill some (`-Xptxas -v`), 16-key forward parts spilled less
//     and ran slower.
//   - A shared operand is split once a tile, not once a warp: the tile lands
//     in a raw buffer by 16-byte cp.async (rows past the end zero-filled);
//     one pass writes it as (big, small) pairs into a split tile of 8 dh-byte
//     rows whose 16-byte chunks (two columns each) are XOR-swizzled by the
//     row (`swz`); then the next tile's copy starts into the raw buffer and
//     overlaps this tile's products. Every fragment load of a split tile is
//     free of bank conflicts at every width: a B operand read along its rows
//     (K in Q K^T, V in dO V^T, Q and dO in the dk/dv scores) and an A
//     operand (dO in the dq kernel, K and V in the dk/dv kernel) as one
//     16-byte load a fragment row, a B operand summed over its rows (V in
//     P V, K in dS K, dO in P^T dO, Q in dS^T Q) as two 8-byte loads. Why at
//     every width: a split row is 256, 512 or 1024 bytes, a whole number of
//     the 128-byte rows of the 32 banks, so a chunk's banks are those of its
//     position mod 8, and the swizzle moves only those 3 bits; each load
//     reads chunks 8 m + i (i < 8) of a row, the same 8 positions whatever
//     the width. A 16-byte load serves 8 lanes at a time: rows g and g + 1
//     (swz differs by 4) and 4 chunks t each, 8 positions; an 8-byte load
//     16 lanes: rows 2t + p (swz 0, 2, 4, 6 in some order) and 2 chunks,
//     8 positions, two lanes to a chunk on its two halves. The split pass's
//     stores, 8 lanes on one row, alternate which half of their float4 goes
//     first, so that they too hit 8 positions. A raw K (V) row at dh 128
//     (512 bytes) moves its chunks by swz_raw(r) = 2 (r & 3): a
//     `frag_a_raw` float2 load's half-warp reads rows g (4 of them) at 2
//     chunks each, 8 positions. tests/test_torch_fp32_head_width.py models
//     these formulas and checks both claims at each width.
//   - Within each k8 step, A columns t and t + 4 stand for the adjacent
//     columns 2t and 2t + 1 (a sum does not depend on its order). So the
//     accumulator's p or dS (columns 2t, 2t + 1 of rows g and g + 8) is the
//     A fragment of P V, dS K, P^T dO and dS^T Q as it stands, split in
//     registers: no p, dS, p^T or dS^T tile passes through shared memory.
//   - The forward skips the per-element mask on tiles that no mask cuts for
//     any row of a warp; exp2 is ex2.approx (2 ulp).
//   - Backward as FA2 without atomics, so a second launch gives the same
//     bits: a dq kernel over the key tiles (S, dP, then dQ += dS K) and a
//     dk/dv kernel over the query tiles (S^T, dP^T, then dV += P^T dO,
//     dK += dS^T Q).
// Scores are scaled into log2 units (exp2), which moves p by an fp32
// rounding only. Rows and keys that no mask lets through follow the plain
// version: p 0, an output row of 0 and lse -1e30 where a row sees no key,
// dk and dv 0 for keys that no query sees.

namespace f32 {

using sm90::key_limit;
using sm90::key_tiles;
using sm90::kLn2;
using sm90::kLog2e;

constexpr int kThreads = 128;  // 4 warps
constexpr int kBM = 64;        // rows a CTA owns (16 a warp): queries, or keys in the dk/dv kernel
constexpr int kFwdPart = 32;   // keys the forward scores at a time
constexpr int kDkvPart = 16;   // queries the dk/dv kernel scores at a time
// two CTAs of `bytes` of dynamic shared memory fit an SM's 228 KB (each also takes 1 KB)
constexpr bool two_an_sm(int bytes) { return 2 * (bytes + 1024) <= 228 * 1024; }

// the plan at head width kDh (32, 64 or 128)
template <int kDh>
struct Cfg {
  static constexpr int kSteps = kDh / 8;   // k8 steps over a row
  static constexpr int kRawF = kDh;        // floats of a raw row
  static constexpr int kSplitF = 2 * kDh;  // floats of a split row: (big, small) a column
  // Q in registers split (kDh registers) or raw (kDh / 2), split a step at a time
  static constexpr bool kQSplit = kDh <= 64;
  static constexpr int kFwdN = kDh <= 64 ? 64 : 32;  // keys of a forward tile
  static constexpr int kDqN = kDh <= 64 ? 32 : 16;   // keys of a dq tile
  // the dk/dv kernel's K and V: split tiles, or at dh 128 raw tiles (rows
  // swizzled by `swz_raw`), split a k8 step at a time, beside 16-query
  // tiles, so that two CTAs fit an SM
  static constexpr bool kKvRaw = kDh == 128;
  static constexpr int kDkvN = kKvRaw ? 16 : 32;     // queries of a dk/dv tile
  static constexpr int kKvF = kKvRaw ? kRawF : kSplitF;  // floats of a K (V) row
  static constexpr int kFwdSmem = (2 * kFwdN * kRawF + 2 * kFwdN * kSplitF) * 4;
  static constexpr int kDqSmem = (2 * kDqN * kRawF + 2 * kDqN * kSplitF + kBM * kSplitF) * 4;
  // the raw and split Q and dO tiles, K's and V's tiles, and lse and delta
  // as copied and as read
  static constexpr int kDkvSmem = (2 * kDkvN * kRawF + 2 * kDkvN * kSplitF + 2 * kBM * kKvF + 4 * kDkvN) * 4;
  static_assert(kDh == 32 || kDh == 64 || kDh == 128, "the fp32 kernels take head widths 32, 64 and 128");
  static_assert(kFwdN % kFwdPart == 0 && kDqN % 16 == 0 && kDkvN % kDkvPart == 0,
                "whole parts a tile, 16 keys an accumulation");
  static_assert(kBM * kRawF <= 2 * kDqN * kSplitF, "the raw dO rows wait in the dq kernel's K and V split tiles");
  static_assert(kKvRaw || kBM * kRawF <= kDkvN * kSplitF,
                "the raw K (V) rows wait in the dk/dv kernel's Q (dO) split tile");
  static_assert(two_an_sm(kFwdSmem) && two_an_sm(kDqSmem) && two_an_sm(kDkvSmem), "two CTAs an SM");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the XOR swizzle of a raw K (V) row's 16-byte chunks in the dk/dv kernel
// at dh 128: rows 4m .. 4m + 3 move their chunks by 0, 2, 4 and 6 within
// each 8, so that the 4 rows of a `frag_a_raw` load's half-warp, 2 chunks
// each, meet 8 bank groups
__device__ __forceinline__ int swz_raw(int r) { return (r & 3) << 1; }

// rows row0 .. row0 + kRows - 1 of one (batch row, head) slice (row r at
// src + r * d, dh values) into a raw tile of kDh columns, with kSwz its
// chunks at c ^ swz_raw(r); rows at or past n_rows and columns at or past dh
// are zero
template <int kDh, int kRows, bool kSwz = false>
__device__ __forceinline__ void load_raw(float* dst, const float* src, int row0, int n_rows, int d, int dh) {
  static_assert(kRows * kDh / 4 % kThreads == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int j = 0; j < kRows * kDh / 4 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (kDh / 4), c = i % (kDh / 4);
    const bool in = row0 + r < n_rows && 4 * c < dh;
    cp_async16(dst + r * Cfg<kDh>::kRawF + 4 * (kSwz ? c ^ swz_raw(r) : c),
               src + (in ? (size_t)(row0 + r) * d + 4 * c : 0), in);
  }
}

// lse and delta of query rows row0 .. row0 + kN - 1 (zero past tq)
template <int kN>
__device__ __forceinline__ void load_res(float* lraw, float* draw, const float* lse, const float* delta,
                                         const Shape& sh, int h, int b, int row0) {
  const int i = threadIdx.x, r = i % kN, row = row0 + r;
  if (i < 2 * kN) {
    const bool in = row < sh.tq;
    const size_t at = res_index(sh, h, b, in ? row : 0);
    cp_async4((i < kN ? lraw : draw) + r, (i < kN ? lse : delta) + at, in);
  }
}

// x = big + small: big is `cvt.rna.tf32.f32` of x (half a TF32 ulp added to
// the bits, the 13 low bits cut: the same bits for finite x), small = x -
// big exactly, whose 13 low bits the tensor cores do not read
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the XOR swizzle of a split row's 16-byte chunks by the row: rows 2m and
// 2m + 1 differ in bit 2, rows 0, 2, 4, 6 (and 1, 3, 5, 7) in bits 1-2
__device__ __forceinline__ int swz(int r) { return (((r >> 1) & 3) << 1) ^ ((r & 1) << 2); }

// a raw tile into a split tile: columns 2c, 2c + 1 of row r as (big, small,
// big, small) in chunk c ^ swz(r)
template <int kDh, int kRows>
__device__ __forceinline__ void split_tile(float* dst, const float* raw) {
#pragma unroll
  for (int j = 0; j < kRows * kDh / 4 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (kDh / 4), c4 = i % (kDh / 4);
    const float4 x = *reinterpret_cast<const float4*>(raw + r * Cfg<kDh>::kRawF + 4 * c4);
    uint4 lo, hi;
    split(x.x, lo.x, lo.y);
    split(x.y, lo.z, lo.w);
    split(x.z, hi.x, hi.y);
    split(x.w, hi.z, hi.w);
    // half the lanes of a row store their second chunk first: 8 lanes, 8 bank groups
    const int first = (c4 >> 2) & 1, s = swz(r);
    float* row = dst + r * Cfg<kDh>::kSplitF;
    *reinterpret_cast<uint4*>(row + (((2 * c4 + first) ^ s) << 2)) = first ? hi : lo;
    *reinterpret_cast<uint4*>(row + (((2 * c4 + 1 - first) ^ s) << 2)) = first ? lo : hi;
  }
}

// a thread's float offsets into a split tile (g = lane / 4, t = lane % 4):
// rows[e], row g's chunk of columns 2t, 2t + 1 in k8 step e (0 or 1; step
// ks adds 32 (ks / 2) floats); cols[p][e], row 2t + p's column g in n8 tile
// e (tile n adds 32 (n / 2))
struct Lanes {
  int rows[2];
  int cols[2][2];
};
template <int kDh>
__device__ __forceinline__ Lanes lanes() {
  constexpr int kSplitF = Cfg<kDh>::kSplitF;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  Lanes L;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    L.rows[e] = g * kSplitF + (((4 * e + t) ^ swz(g)) << 2);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      L.cols[p][e] = (2 * t + p) * kSplitF + (((4 * e + g / 2) ^ swz(2 * t + p)) << 2) + (g & 1) * 2;
  }
  return L;
}

// B fragment of n8 tile n, k8 step ks, of a product that reads the split
// tile along its rows (K in Q K^T): (big, small) of b0, then of b1
template <int kDh>
__device__ __forceinline__ uint4 frag_b_rows(const float* sp, const Lanes& L, int n, int ks) {
  return *reinterpret_cast<const uint4*>(sp + L.rows[ks & 1] + 32 * (ks >> 1) + 8 * n * Cfg<kDh>::kSplitF);
}

// B fragment of k8 step j, n8 tile n, of a product summed over the split
// tile's rows (V in P V): rows 8j + 2t and 8j + 2t + 1, A's columns t, t + 4
template <int kDh>
__device__ __forceinline__ uint4 frag_b_cols(const float* sp, const Lanes& L, int j, int n) {
  const float* base = sp + 32 * (n >> 1) + 8 * j * Cfg<kDh>::kSplitF;
  const uint2 lo = *reinterpret_cast<const uint2*>(base + L.cols[0][n & 1]);
  const uint2 hi = *reinterpret_cast<const uint2*>(base + L.cols[1][n & 1]);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// A fragment (big a0..a3, then small a0..a3) of rows r0 + g and r0 + g + 8,
// k8 step ks, from a split tile
template <int kDh>
__device__ __forceinline__ void frag_a(uint32_t (&a)[8], const float* sp, const Lanes& L, int r0, int ks) {
  constexpr int kSplitF = Cfg<kDh>::kSplitF;
  const float* base = sp + L.rows[ks & 1] + 32 * (ks >> 1) + r0 * kSplitF;
  const uint4 x = *reinterpret_cast<const uint4*>(base);                // row g: a0, a2
  const uint4 y = *reinterpret_cast<const uint4*>(base + 8 * kSplitF);  // row g + 8: a1, a3
  a[0] = x.x, a[1] = y.x, a[2] = x.z, a[3] = y.z;
  a[4] = x.y, a[5] = y.y, a[6] = x.w, a[7] = y.w;
}

// the same A fragment from a raw tile swizzled by `swz_raw` (r0 a multiple
// of 4), split here: columns 8 ks + 2t, + 1 are floats 2 (t & 1), + 1 of
// chunk 2 ks + t / 2
template <int kDh>
__device__ __forceinline__ void frag_a_raw(uint32_t (&a)[8], const float* raw, int r0, int ks) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    const float2 x = *reinterpret_cast<const float2*>(raw + row * Cfg<kDh>::kRawF +
                                                      4 * ((2 * ks + t / 2) ^ swz_raw(row)) + 2 * (t & 1));
    split(x.x, a[r], a[4 + r]);
    split(x.y, a[2 + r], a[6 + r]);
  }
}

// the dk/dv kernel's A fragment of its K (V) tile: split, or raw (Cfg::kKvRaw)
template <int kDh>
__device__ __forceinline__ void frag_kv(uint32_t (&a)[8], const float* tile, const Lanes& L, int r0, int ks) {
  if constexpr (Cfg<kDh>::kKvRaw)
    frag_a_raw<kDh>(a, tile, r0, ks);
  else
    frag_a<kDh>(a, tile, L, r0, ks);
}

// Q's A fragments of a warp's rows row and row + 8 for every k8 step, kept
// in registers for the whole walk: split (big a0..a3, small a0..a3) where
// Cfg::kQSplit, else raw (a0..a3), split a step at a time by `get`
template <int kDh>
struct QFrags {
  static constexpr bool kSplit = Cfg<kDh>::kQSplit;
  uint32_t a[Cfg<kDh>::kSteps][kSplit ? 8 : 4];

  // from global memory (zero at or past n_rows, and in the columns at or
  // past dh): columns 8 ks + 2t, 8 ks + 2t + 1
  __device__ __forceinline__ void load(const float* src, int row, int n_rows, int d, int dh) {
    const int t = threadIdx.x % 4;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row + 8 * r < n_rows;
      const float* p = src + (size_t)(in ? row + 8 * r : 0) * d + 2 * t;
#pragma unroll
      for (int ks = 0; ks < Cfg<kDh>::kSteps; ++ks) {
        const float2 x = in && 8 * ks < dh ? *reinterpret_cast<const float2*>(p + 8 * ks) : make_float2(0.f, 0.f);
        if constexpr (kSplit) {
          split(x.x, a[ks][r], a[ks][4 + r]);
          split(x.y, a[ks][2 + r], a[ks][6 + r]);
        } else {
          a[ks][r] = __float_as_uint(x.x);
          a[ks][2 + r] = __float_as_uint(x.y);
        }
      }
    }
  }

  // the split A fragment of k8 step ks
  __device__ __forceinline__ void get(uint32_t (&f)[8], int ks) const {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kSplit) {
        f[i] = a[ks][i], f[4 + i] = a[ks][4 + i];
      } else {
        split(__uint_as_float(a[ks][i]), f[i], f[4 + i]);
      }
    }
  }
};

// the A fragment of a product over the columns of accumulator tile c (P in
// P V, dS in dS K, ...): a0 = c0 (row g, column 2t), a1 = c2, a2 = c1, a3 = c3
__device__ __forceinline__ void split_acc(uint32_t (&a)[8], const float (&c)[4]) {
  split(c[0], a[0], a[4]);
  split(c[2], a[1], a[5]);
  split(c[1], a[2], a[6]);
  split(c[3], a[3], a[7]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// a b in 3xTF32: the correction passes (small a big b, big a small b) into
// c, big a big b into d
__device__ __forceinline__ void mma3(float (&d)[4], float (&c)[4], const uint32_t (&a)[8], uint4 b) {
  mma_tf32(c, a[4], a[5], a[6], a[7], b.x, b.z);
  mma_tf32(c, a[0], a[1], a[2], a[3], b.y, b.w);
  mma_tf32(d, a[0], a[1], a[2], a[3], b.x, b.z);
}

// s[n] = Q B_n^T for the kN n8 tiles of split tile sp read along its rows
// (K in Q K^T), Q's k8 steps in registers. With Q split, an n8 tile at a
// time (one correction accumulator); with Q raw, a k8 step at a time, so
// that each step is split once (kN correction accumulators). The sums are
// the same either way.
template <int kDh, int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4], const QFrags<kDh>& q, const float* sp, const Lanes& L) {
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
  if constexpr (QFrags<kDh>::kSplit) {
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      float c[4] = {};
#pragma unroll
      for (int ks = 0; ks < Cfg<kDh>::kSteps; ++ks) mma3(s[n], c, q.a[ks], frag_b_rows<kDh>(sp, L, n, ks));
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += c[e];
    }
  } else {
    float c[kN][4] = {};
#pragma unroll
    for (int ks = 0; ks < Cfg<kDh>::kSteps; ++ks) {
      uint32_t a[8];
      q.get(a, ks);
#pragma unroll
      for (int n = 0; n < kN; ++n) mma3(s[n], c[n], a, frag_b_rows<kDh>(sp, L, n, ks));
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] += c[n][e];
  }
}

// s[n] = A B_n^T and u[n] = A2 B2_n^T for kN n8 tiles (S and dP):
// frag_a1(a, ks) and frag_a2(a, ks) give A's and A2's k8 step ks, B and B2
// split tiles are read along their rows
template <int kDh, int kN, typename FragA1, typename FragA2>
__device__ __forceinline__ void scores2(float (&s)[kN][4], float (&u)[kN][4], FragA1 frag_a1, FragA2 frag_a2,
                                        const float* bsp, const float* b2sp, const Lanes& L) {
  float cs[kN][4] = {}, cu[kN][4] = {};
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = u[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Cfg<kDh>::kSteps; ++ks) {
    uint32_t a[8], a2[8];
    frag_a1(a, ks);
    frag_a2(a2, ks);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      mma3(s[n], cs[n], a, frag_b_rows<kDh>(bsp, L, n, ks));
      mma3(u[n], cu[n], a2, frag_b_rows<kDh>(b2sp, L, n, ks));
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += cs[n][e], u[n][e] += cu[n][e];
}

// acc[n] += P_0 B(0, n) + P_1 B(1, n) for the kDh / 8 n8 tiles of the
// columns: p0 and p1 accumulator tiles over 16 rows of split tile sp (V in
// P V), the two k8 steps' three passes summed into a zeroed accumulator (6
// truncating sums from 0) and added to acc in fp32
template <int kDh>
__device__ __forceinline__ void mma_rows16(float (&acc)[kDh / 8][4], const float (&p0)[4], const float (&p1)[4],
                                           const float* sp, const Lanes& L) {
  uint32_t a0[8], a1[8];
  split_acc(a0, p0);
  split_acc(a1, p1);
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) {
    float d[4] = {};
    mma3(d, d, a0, frag_b_cols<kDh>(sp, L, 0, n));
    mma3(d, d, a1, frag_b_cols<kDh>(sp, L, 1, n));
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += d[e];
  }
}

// over the 4 lanes (a quad) that hold one accumulator row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// rows row and row + 8 of an accumulator over kDh columns (kDh / 8 n8
// tiles) to global memory at dst (row r at dst + r * d), rows at or past
// n_rows and columns at or past dh skipped
template <int kDh>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[kDh / 8][4], int row, int n_rows, int d,
                                           int dh) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n_rows) continue;
    float* p = dst + (size_t)(row + 8 * r) * d + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
      if (8 * n < dh) *reinterpret_cast<float2*>(p + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// the forward's online softmax over one part's scores s (kS n8 tiles: keys
// key0 + 8n + 2t (+1) of rows row, row + 8, in log2 units after sl2): p
// replaces s, and m, l and o (kO n8 tiles of output columns) move to the
// part; kMask applies the limits lim
template <bool kMask, int kS, int kO>
__device__ __forceinline__ void softmax_part(float (&s)[kS][4], float (&m)[2], float (&l)[2], float (&o)[kO][4],
                                             int key0, const int (&lim)[2], float sl2) {
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[n][e] = !kMask || key0 + 8 * n + (e & 1) < lim[e >> 1] ? s[n][e] * sl2 : kNegInf;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r])), corr = exp2_approx(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr;
#pragma unroll
    for (int n = 0; n < kO; ++n) o[n][2 * r] *= corr, o[n][2 * r + 1] *= corr;
  }
#pragma unroll
  for (int n = 0; n < kS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = !kMask || key0 + 8 * n + (e & 1) < lim[e >> 1];
      s[n][e] = in ? exp2_approx(s[n][e] - m[e >> 1]) : 0.f;
      sum[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += quad_sum(sum[r]);
}

template <int kDh, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ out, float* __restrict__ lse, Shape sh) {
  using C = Cfg<kDh>;
  constexpr int kFwdN = C::kFwdN, kSplitF = C::kSplitF;
  extern __shared__ __align__(16) float fsm[];
  float* kraw = fsm;
  float* vraw = kraw + kFwdN * C::kRawF;
  float* ksp = vraw + kFwdN * C::kRawF;
  float* vsp = ksp + kFwdN * kSplitF;
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + h * sh.dh, koff = (size_t)b * sh.tk * sh.d + h * sh.dh;
  const int n_tiles = key_tiles<kCausal, kFwdN>(sh, q0, q0 + kBM);

  if (n_tiles > 0) {
    load_raw<kDh, kFwdN>(kraw, k + koff, 0, sh.tk, sh.d, sh.dh);
    load_raw<kDh, kFwdN>(vraw, v + koff, 0, sh.tk, sh.d, sh.dh);
  }
  cp_commit();
  const int row = q0 + 16 * warp + threadIdx.x % 32 / 4;  // this thread's rows: row and row + 8
  QFrags<kDh> qa;
  qa.load(q + qoff, row, sh.tq, sh.d, sh.dh);
  const Lanes L = lanes<kDh>();
  const int lim[2] = {key_limit<kCausal>(sh, row), key_limit<kCausal>(sh, row + 8)};
  const int warp_lim = key_limit<kCausal>(sh, q0 + 16 * warp);  // the warp's first row sees the fewest keys
  const float sl2 = sh.scale * kLog2e;
  float o[kDh / 8][4] = {}, m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1's splits
    split_tile<kDh, kFwdN>(ksp, kraw);
    split_tile<kDh, kFwdN>(vsp, vraw);
    __syncthreads();  // the splits are in; the raw buffers are free
    if (kt + 1 < n_tiles) {
      load_raw<kDh, kFwdN>(kraw, k + koff, (kt + 1) * kFwdN, sh.tk, sh.d, sh.dh);
      load_raw<kDh, kFwdN>(vraw, v + koff, (kt + 1) * kFwdN, sh.tk, sh.d, sh.dh);
    }
    cp_commit();
#pragma unroll 1  // one part's registers at a time
    for (int part = 0; part < kFwdN / kFwdPart; ++part) {
      const int key0 = kt * kFwdN + part * kFwdPart;
      float s[kFwdPart / 8][4];
      scores<kDh>(s, qa, ksp + part * kFwdPart * kSplitF, L);
      if (key0 + kFwdPart <= warp_lim)
        softmax_part<false>(s, m, l, o, key0 + 2 * t, lim, sl2);
      else
        softmax_part<true>(s, m, l, o, key0 + 2 * t, lim, sl2);
#pragma unroll
      for (int j = 0; j < kFwdPart / 8; j += 2)
        mma_rows16<kDh>(o, s[j], s[j + 1], vsp + (part * kFwdPart + 8 * j) * kSplitF, L);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row with no valid key (l == 0) writes 0
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n) {
      o[n][2 * r] = l[r] == 0.f ? 0.f : o[n][2 * r] / l[r];
      o[n][2 * r + 1] = l[r] == 0.f ? 0.f : o[n][2 * r + 1] / l[r];
    }
    if (lse != nullptr && t == 0 && row + 8 * r < sh.tq)
      lse[res_index(sh, h, b, row + 8 * r)] = l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]);
  }
  store_rows<kDh>(out + qoff, o, row, sh.tq, sh.d, sh.dh);
}

template <int kDh, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Shape sh) {
  using C = Cfg<kDh>;
  constexpr int kDqN = C::kDqN, kSplitF = C::kSplitF;
  extern __shared__ __align__(16) float fsm[];
  float* kraw = fsm;
  float* vraw = kraw + kDqN * C::kRawF;
  float* ksp = vraw + kDqN * C::kRawF;
  float* vsp = ksp + kDqN * kSplitF;
  float* gsp = vsp + kDqN * kSplitF;  // dO of the CTA's rows
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + h * sh.dh, koff = (size_t)b * sh.tk * sh.d + h * sh.dh;
  const int n_tiles = key_tiles<kCausal, kDqN>(sh, q0, q0 + kBM);

  load_raw<kDh, kBM>(ksp, dout + qoff, q0, sh.tq, sh.d, sh.dh);  // raw dO rows, in ksp's (and vsp's) room until split
  cp_commit();
  if (n_tiles > 0) {
    load_raw<kDh, kDqN>(kraw, k + koff, 0, sh.tk, sh.d, sh.dh);
    load_raw<kDh, kDqN>(vraw, v + koff, 0, sh.tk, sh.d, sh.dh);
  }
  cp_commit();
  const int row = q0 + 16 * warp + threadIdx.x % 32 / 4;
  QFrags<kDh> qa;
  qa.load(q + qoff, row, sh.tq, sh.d, sh.dh);
  const Lanes L = lanes<kDh>();
  float lr[2], dr[2];
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = row + 8 * r;
    lr[r] = qr < sh.tq ? lse[res_index(sh, h, b, qr)] * kLog2e : 0.f;
    dr[r] = qr < sh.tq ? delta[res_index(sh, h, b, qr)] : 0.f;
    lim[r] = key_limit<kCausal>(sh, qr);
  }
  const float sl2 = sh.scale * kLog2e;
  cp_wait<1>();
  __syncthreads();
  split_tile<kDh, kBM>(gsp, ksp);
  float acc[kDh / 8][4] = {};
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1's splits (and the raw dO)
    split_tile<kDh, kDqN>(ksp, kraw);
    split_tile<kDh, kDqN>(vsp, vraw);
    __syncthreads();
    if (kt + 1 < n_tiles) {
      load_raw<kDh, kDqN>(kraw, k + koff, (kt + 1) * kDqN, sh.tk, sh.d, sh.dh);
      load_raw<kDh, kDqN>(vraw, v + koff, (kt + 1) * kDqN, sh.tk, sh.d, sh.dh);
    }
    cp_commit();

    float s[kDqN / 8][4], dp[kDqN / 8][4];
    scores2<kDh>(
        s, dp, [&](uint32_t (&a)[8], int ks) { qa.get(a, ks); },
        [&](uint32_t (&a)[8], int ks) { frag_a<kDh>(a, gsp, L, 16 * warp, ks); }, ksp, vsp, L);
#pragma unroll
    for (int n = 0; n < kDqN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // s becomes dS = p (dP - delta) scale
        const int r = e >> 1;
        const bool in = kt * kDqN + 8 * n + 2 * t + (e & 1) < lim[r];
        const float p = in ? exp2_approx(s[n][e] * sl2 - lr[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - dr[r]) * sh.scale;
      }
#pragma unroll
    for (int j = 0; j < kDqN / 8; j += 2) mma_rows16<kDh>(acc, s[j], s[j + 1], ksp + 8 * j * kSplitF, L);
  }
  store_rows<kDh>(dq + qoff, acc, row, sh.tq, sh.d, sh.dh);
}

template <int kDh, bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, Shape sh) {
  using C = Cfg<kDh>;
  constexpr int kSplitF = C::kSplitF, kDkvN = C::kDkvN;
  extern __shared__ __align__(16) float fsm[];
  float* qraw = fsm;
  float* graw = qraw + kDkvN * C::kRawF;
  float* qsp = graw + kDkvN * C::kRawF;
  float* gsp = qsp + kDkvN * kSplitF;
  float* ksp = gsp + kDkvN * kSplitF;  // K and V of the CTA's keys: split, or raw (Cfg::kKvRaw)
  float* vsp = ksp + kBM * C::kKvF;
  float* lraw = vsp + kBM * C::kKvF;   // lse and delta of the query tile as copied
  float* draw = lraw + kDkvN;
  float* ls = draw + kDkvN;  // lse in log2 units (+inf past tq: p = 0) and delta, as the products read them
  float* ds = ls + kDkvN;
  const int k0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + h * sh.dh, koff = (size_t)b * sh.tk * sh.d + h * sh.dh;
  const int n_q = (sh.tq + kDkvN - 1) / kDkvN;
  // the first query tile that sees key k0 (none for keys past kv_len)
  const int first = k0 >= sh.kv_len ? n_q : kCausal ? max(0, k0 - sh.q_offset) / kDkvN : 0;
  const int key = k0 + 16 * warp + threadIdx.x % 32 / 4;  // this thread's keys: key and key + 8
  float acc_k[kDh / 8][4] = {}, acc_v[kDh / 8][4] = {};

  if (first < n_q) {
    if constexpr (C::kKvRaw) {
      load_raw<kDh, kBM, true>(ksp, k + koff, k0, sh.tk, sh.d, sh.dh);
      load_raw<kDh, kBM, true>(vsp, v + koff, k0, sh.tk, sh.d, sh.dh);
    } else {
      // raw K and V rows, in qsp's and gsp's room until split
      load_raw<kDh, kBM>(qsp, k + koff, k0, sh.tk, sh.d, sh.dh);
      load_raw<kDh, kBM>(gsp, v + koff, k0, sh.tk, sh.d, sh.dh);
    }
    cp_commit();
    load_raw<kDh, kDkvN>(qraw, q + qoff, first * kDkvN, sh.tq, sh.d, sh.dh);
    load_raw<kDh, kDkvN>(graw, dout + qoff, first * kDkvN, sh.tq, sh.d, sh.dh);
    load_res<kDkvN>(lraw, draw, lse, delta, sh, h, b, first * kDkvN);
    cp_commit();
    const Lanes L = lanes<kDh>();
    const float sl2 = sh.scale * kLog2e;
    cp_wait<1>();
    __syncthreads();
    if constexpr (!C::kKvRaw) {
      split_tile<kDh, kBM>(ksp, qsp);
      split_tile<kDh, kBM>(vsp, gsp);
    }
    for (int qt = first; qt < n_q; ++qt) {
      cp_wait<0>();
      __syncthreads();  // tile qt landed; every warp is done with tile qt - 1's splits (and the raw K, V)
      split_tile<kDh, kDkvN>(qsp, qraw);
      split_tile<kDh, kDkvN>(gsp, graw);
      if (threadIdx.x < kDkvN) {
        const int i = threadIdx.x;
        ls[i] = qt * kDkvN + i < sh.tq ? lraw[i] * kLog2e : INFINITY;
        ds[i] = draw[i];
      }
      __syncthreads();
      if (qt + 1 < n_q) {
        load_raw<kDh, kDkvN>(qraw, q + qoff, (qt + 1) * kDkvN, sh.tq, sh.d, sh.dh);
        load_raw<kDh, kDkvN>(graw, dout + qoff, (qt + 1) * kDkvN, sh.tq, sh.d, sh.dh);
        load_res<kDkvN>(lraw, draw, lse, delta, sh, h, b, (qt + 1) * kDkvN);
      }
      cp_commit();
#pragma unroll 1  // one part's registers at a time
      for (int part = 0; part < kDkvN / kDkvPart; ++part) {
        const int c0 = part * kDkvPart;  // the part's first query in the tile
        float st[kDkvPart / 8][4], dpt[kDkvPart / 8][4];
        scores2<kDh>(
            st, dpt, [&](uint32_t (&a)[8], int ks) { frag_kv<kDh>(a, ksp, L, 16 * warp, ks); },
            [&](uint32_t (&a)[8], int ks) { frag_kv<kDh>(a, vsp, L, 16 * warp, ks); }, qsp + c0 * kSplitF,
            gsp + c0 * kSplitF, L);
#pragma unroll
        for (int n = 0; n < kDkvPart / 8; ++n) {  // st becomes p^T, dpt dS^T; rows are keys, columns queries
          const int c = c0 + 8 * n + 2 * t, qr = qt * kDkvN + c;
          const float2 lq = *reinterpret_cast<const float2*>(ls + c), dq2 = *reinterpret_cast<const float2*>(ds + c);
          const int lim[2] = {key_limit<kCausal>(sh, qr), key_limit<kCausal>(sh, qr + 1)};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cc = e & 1;
            const bool in = key + 8 * (e >> 1) < lim[cc];
            const float p = in ? exp2_approx(st[n][e] * sl2 - (cc ? lq.y : lq.x)) : 0.f;
            dpt[n][e] = p * (dpt[n][e] - (cc ? dq2.y : dq2.x)) * sh.scale;
            st[n][e] = p;
          }
        }
#pragma unroll
        for (int j = 0; j < kDkvPart / 8; j += 2) {
          mma_rows16<kDh>(acc_v, st[j], st[j + 1], gsp + (c0 + 8 * j) * kSplitF, L);
          mma_rows16<kDh>(acc_k, dpt[j], dpt[j + 1], qsp + (c0 + 8 * j) * kSplitF, L);
        }
      }
    }
  }
  store_rows<kDh>(dk + koff, acc_k, key, sh.tk, sh.d, sh.dh);
  store_rows<kDh>(dv + koff, acc_v, key, sh.tk, sh.d, sh.dh);
}

// ---- the fp32 wide forward: K5, K7 and K7-lse at head widths 136-768
//
// Serves `flash_mh_fwd_f32` (natural layout, head h at column h dh, no lse)
// and `flash_fwd_f32` ((BH, T, dh) as BH batch rows of one head: causal or
// not, any q_offset, with and without the logsumexp) above 128: one kernel
// over `Shape`'s addressing, causal a template parameter (and the rows a
// CTA, below). What bounds it: the products, as the kernels above. What
// does not fit: Q of 64 rows at dh 768 is 192 KB of fp32, and a warp's
// output of 16 rows x 768 would take 384 registers a thread. So:
//   - A CTA owns kSlab = 128 output columns of a head (the grid has
//     ceil(dh / 128) slabs a head, as the bf16 route B; O 64 registers a
//     thread) and 16 query rows a warp: 64 rows (4 warps) where Q and two
//     K / V stages fit in 227 KB (dh <= 544), else 32 (2 warps) (`wide_cfg`,
//     mirrored by `ops.flash_attention.f32_wide_plan`). Each slab computes S
//     again: ceil(dh / 128) products Q K^T where the bound counts one.
//   - Q lies raw in shared memory for the whole walk, its rows dh rounded up
//     to 32 plus 8 floats apart (`stride`): a float2 A-fragment load's
//     half-warp, rows g .. g + 3 at columns 2t, meets 16 distinct bank
//     pairs. K tiles of kWideKeys = 16 keys (rows `stride` apart, read as B
//     along their rows the same way) and V slabs of 16 keys x 128 columns
//     (rows of 132 floats: a B fragment's rows 2t and 2t + 1 at column g
//     meet 32 banks) stream through two stages by 16-byte cp.async, rows
//     past tk and columns past dh zero-filled; the next tile's copy overlaps
//     this tile's products.
//   - Every operand fragment is split into (big, small) as it is read, in
//     registers: split tiles would double Q's and K's bytes.
//   - 3xTF32 on mma.sync m16n8k8 as above. A tile's 16 keys are one P V
//     accumulation into a zeroed accumulator (the truncation rule), and a
//     score's correction passes go into their own accumulator. P V skips
//     the n8 tiles of a slab past dh.
//   - The masks, the causal walk and the online softmax are `fwd_kernel`'s;
//     p and O stay in registers; slab 0 writes the logsumexp.
using sm90::kSlab;                  // output columns a CTA owns
constexpr int kWideKeys = 16;       // keys a K / V tile: one P V accumulation
constexpr int kWideVF = kSlab + 4;  // floats of a staged V slab row

struct WideCfg {
  int rows;    // query rows a CTA, 16 a warp
  int stride;  // floats of a staged Q or K row
  int slabs;   // output slabs a head
  int smem;    // dynamic shared bytes
};

inline WideCfg wide_cfg(int dh) {
  WideCfg c;
  c.stride = (dh + 31) / 32 * 32 + 8;
  c.slabs = (dh + kSlab - 1) / kSlab;
  const int stages = 2 * kWideKeys * (c.stride + kWideVF) * 4;
  c.rows = 64 * c.stride * 4 + stages <= sm90::kSmemMax ? 64 : 32;
  c.smem = c.rows * c.stride * 4 + stages;
  return c;
}

template <int kRows, bool kCausal>
__global__ void __launch_bounds__(kRows * 2, 1)
fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                float* __restrict__ out, float* __restrict__ lse, Shape sh, int stride) {
  constexpr int kThr = kRows * 2;  // a warp a 16 rows
  constexpr int kOut = kSlab / 8;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* ks = qs + kRows * stride;          // two stages of kWideKeys rows
  float* vs = ks + 2 * kWideKeys * stride;  // two stages of kWideKeys x kWideVF
  const int n_slab = (sh.dh + kSlab - 1) / kSlab;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y / n_slab, c0 = blockIdx.y % n_slab * kSlab;
  const int b = blockIdx.z, warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + (size_t)h * sh.dh;
  const size_t koff = (size_t)b * sh.tk * sh.d + (size_t)h * sh.dh;
  const int n_tiles = key_tiles<kCausal, kWideKeys>(sh, q0, q0 + kRows);
  const int chunks = sh.dh / 4;                  // 16-byte chunks of a Q or K row
  const int vcols = min(kSlab, sh.dh - c0);  // the slab's real columns, a multiple of 8

  for (int i = threadIdx.x; i < kRows * chunks; i += kThr) {  // Q, zero past tq
    const int r = i / chunks, c = i % chunks;
    const bool in = q0 + r < sh.tq;
    cp_async16(qs + r * stride + 4 * c, q + qoff + (in ? (size_t)(q0 + r) * sh.d + 4 * c : 0), in);
  }
  // the K rows and V slab of key tile kt into stage st, zero past tk and dh
  auto load_kv = [&](int kt, int st) {
    float* kd = ks + st * kWideKeys * stride;
    float* vd = vs + st * kWideKeys * kWideVF;
    const int key0 = kt * kWideKeys;
    for (int i = threadIdx.x; i < kWideKeys * chunks; i += kThr) {
      const int r = i / chunks, c = i % chunks;
      const bool in = key0 + r < sh.tk;
      cp_async16(kd + r * stride + 4 * c, k + koff + (in ? (size_t)(key0 + r) * sh.d + 4 * c : 0), in);
    }
    for (int i = threadIdx.x; i < kWideKeys * kSlab / 4; i += kThr) {
      const int r = i / (kSlab / 4), c = i % (kSlab / 4);
      const bool in = key0 + r < sh.tk && 4 * c < vcols;
      cp_async16(vd + r * kWideVF + 4 * c, v + koff + (in ? (size_t)(key0 + r) * sh.d + c0 + 4 * c : 0), in);
    }
  };
  load_kv(0, 0);
  cp_commit();

  const int row = q0 + 16 * warp + g;  // this thread's rows: row and row + 8
  const int lim[2] = {key_limit<kCausal>(sh, row), key_limit<kCausal>(sh, row + 8)};
  const int warp_lim = key_limit<kCausal>(sh, q0 + 16 * warp);  // the warp's first row sees the fewest keys
  const float sl2 = sh.scale * kLog2e;
  const int steps = sh.dh / 8, n_out = vcols / 8;
  const float* qa = qs + (16 * warp + g) * stride + 2 * t;  // rows g, g + 8: columns 2t, 2t + 1 of each k8 step
  float o[kOut][4] = {}, m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt (and Q) landed; every warp is done with tile kt - 1
    if (kt + 1 < n_tiles) load_kv(kt + 1, (kt + 1) & 1);
    cp_commit();
    const float* kb = ks + (kt & 1) * kWideKeys * stride + g * stride + 2 * t;
    const float* vb = vs + (kt & 1) * kWideKeys * kWideVF + 2 * t * kWideVF + g;
    // S = Q K^T of the tile's two n8 tiles of keys, the whole head width
    float s[2][4] = {}, cs[2][4] = {};
#pragma unroll 2
    for (int st = 0; st < steps; ++st) {
      const float2 x0 = *reinterpret_cast<const float2*>(qa + 8 * st);
      const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * stride + 8 * st);
      uint32_t a[8];
      split(x0.x, a[0], a[4]);
      split(x1.x, a[1], a[5]);
      split(x0.y, a[2], a[6]);
      split(x1.y, a[3], a[7]);
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const float2 y = *reinterpret_cast<const float2*>(kb + 8 * n * stride + 8 * st);
        uint4 bf;
        split(y.x, bf.x, bf.y);
        split(y.y, bf.z, bf.w);
        mma3(s[n], cs[n], a, bf);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] += cs[n][i];
    const int key0 = kt * kWideKeys;
    if (key0 + kWideKeys <= warp_lim)
      softmax_part<false>(s, m, l, o, key0 + 2 * t, lim, sl2);
    else
      softmax_part<true>(s, m, l, o, key0 + 2 * t, lim, sl2);
    // O += P V_slab: keys 8j + 2t, + 1 of the tile (A's columns t, t + 4), column 8n + g
    uint32_t p0[8], p1[8];
    split_acc(p0, s[0]);
    split_acc(p1, s[1]);
#pragma unroll
    for (int n = 0; n < kOut; ++n) {
      if (n >= n_out) continue;
      const float* vp = vb + 8 * n;
      uint4 b0, b1;  // keys 2t, 2t + 1, then 8 + 2t, 9 + 2t
      split(vp[0], b0.x, b0.y);
      split(vp[kWideVF], b0.z, b0.w);
      split(vp[8 * kWideVF], b1.x, b1.y);
      split(vp[9 * kWideVF], b1.z, b1.w);
      float d[4] = {};
      mma3(d, d, p0, b0);
      mma3(d, d, p1, b1);
#pragma unroll
      for (int i = 0; i < 4; ++i) o[n][i] += d[i];
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row with no valid key (l == 0) writes 0, and lse -1e30
    if (row + 8 * r >= sh.tq) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];
    if (lse != nullptr && c0 == 0 && t == 0)
      lse[res_index(sh, h, b, row + 8 * r)] = l[r] == 0.f ? kNegInf : m[r] * kLn2 + logf(l[r]);
    float* dst = out + qoff + (size_t)(row + 8 * r) * sh.d + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < kOut; ++n)
      if (n < n_out) *reinterpret_cast<float2*>(dst + 8 * n) = make_float2(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
  }
}

template <int kRows, bool kCausal>
int run_fwd_wide(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh,
                 const WideCfg& c, cudaStream_t stream) {
  static bool lifted[64] = {};  // to the most any plan takes, once
  const cudaError_t err = sm90::lift_smem(fwd_wide_kernel<kRows, kCausal>, sm90::kSmemMax, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kRows - 1) / kRows, sh.n_head * c.slabs, sh.batch);
  fwd_wide_kernel<kRows, kCausal><<<grid, kRows * 2, c.smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), sh, c.stride);
  return (int)cudaGetLastError();
}

// ---- the fp32 wide backward: K8 at head widths 136-768
//
// Serves `flash_bwd_f32` above 128: a dq kernel and a dk/dv kernel, each CTA
// one slab of kSlab output columns (O 64 registers a thread; dk/dv 128),
// recomputing S and dP over the whole head width, as the bf16 kernels do.
//   - A CTA's own operands (Q and dO in the dq kernel, K and V in the dk/dv
//     kernel) lie raw in shared memory for the whole walk, rows `stride`
//     floats apart as the wide forward's Q: 64 rows (4 warps) where they fit
//     beside the stages (dh <= 384), else 32 (`wide_bwd_cfg`, mirrored by
//     `ops.flash_attention.f32_k8_wide_plan`).
//   - The other side walks in tiles of kWideKeys = 16 keys (queries), each
//     streamed through two stages by 16-byte cp.async as items: chunks of
//     64 columns of both operands (K and V; Q and dO), rows kWideCF floats
//     apart (a float2 B-fragment load's half-warp meets 16 bank pairs), then
//     the slab's 128 columns of the operand the output product sums over (K;
//     dO, then Q), rows kWideVF apart as the wide forward's V. The next
//     item's copy overlaps this item's products.
//   - 3xTF32 on mma.sync m16n8k8 with every fragment split as it is read, as
//     the wide forward. The truncation rule: each chunk's S (dP) goes into
//     zeroed accumulators, its correction passes into their own, both added
//     in fp32; each tile's 16 keys (queries) are one output accumulation
//     into a zeroed accumulator, added to the slab's in fp32.
//   - Masks as `bwd_dq_kernel` and `bwd_dkv_kernel`: selects on p, per-row
//     key limits, the causal walks, zeros for keys no query sees.
constexpr int kWideChunk = 64;                    // columns of a streamed chunk
constexpr int kWideCF = kWideChunk + 8;           // floats of a staged chunk row
constexpr int kWideStageF = 2 * kWideKeys * kWideCF;  // floats of a stage: a chunk of two operands
static_assert(kWideKeys * kWideVF <= kWideStageF, "a slab item fits a stage");

struct WideBwdCfg {
  int rows;    // own rows a CTA (queries, or keys in the dk/dv kernel), 16 a warp
  int stride;  // floats of an own row
  int slabs;   // output slabs a head
  int smem;    // dynamic shared bytes (both kernels)
};

inline WideBwdCfg wide_bwd_cfg(int dh) {
  WideBwdCfg c;
  c.stride = (dh + 31) / 32 * 32 + 8;
  c.slabs = (dh + kSlab - 1) / kSlab;
  const int rest = (2 * kWideStageF + 2 * 2 * kWideKeys) * 4;  // two stages, lse and delta of two tiles
  c.rows = 2 * 64 * c.stride * 4 + rest <= sm90::kSmemMax ? 64 : 32;
  c.smem = 2 * c.rows * c.stride * 4 + rest;
  return c;
}

// rows row0 .. row0 + kRows - 1 (zero past n_rows) of a slice at src (row r at
// src + r * d, dh values) into dst, rows `stride` floats apart
template <int kRows>
__device__ __forceinline__ void load_own(float* dst, const float* src, int row0, int n_rows, int d, int dh,
                                         int stride) {
  const int chunks = dh / 4;
  for (int i = threadIdx.x; i < kRows * chunks; i += kRows * 2) {
    const int r = i / chunks, c = i % chunks;
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * stride + 4 * c, src + (in ? (size_t)(row0 + r) * d + 4 * c : 0), in);
  }
}

// kWideKeys rows from row0 of kOps operands (at src[op], zero past n_rows
// and past dh) into dst (operand op at dst + op * kWideKeys * kF), columns
// col0 .. col0 + kCols - 1, rows kF floats apart
template <int kThr, int kOps, int kCols, int kF>
__device__ __forceinline__ void load_tile(float* dst, const float* const (&src)[kOps], int row0, int n_rows, int d,
                                          int col0, int dh) {
  constexpr int kC = kCols / 4;
  for (int i = threadIdx.x; i < kOps * kWideKeys * kC; i += kThr) {
    const int op = i / (kWideKeys * kC), r = i / kC % kWideKeys, c = i % kC;
    const bool in = row0 + r < n_rows && col0 + 4 * c < dh;
    cp_async16(dst + op * kWideKeys * kF + r * kF + 4 * c,
               src[op] + (in ? (size_t)(row0 + r) * d + col0 + 4 * c : 0), in);
  }
}

// s[n] += A B_n^T over one chunk's k8 steps: A's rows g, g + 8 at a (float2
// at columns 8 st + 2t), B's two n8 tiles of rows along kWideCF-float rows
// at b (row g, 2t); the chunk's passes into zeroed accumulators
__device__ __forceinline__ void chunk_scores(float (&s)[2][4], const float* a, int a_stride, const float* b,
                                             int steps) {
  float ps[2][4] = {}, pc[2][4] = {};
#pragma unroll 2
  for (int st = 0; st < steps; ++st) {
    const float2 x0 = *reinterpret_cast<const float2*>(a + 8 * st);
    const float2 x1 = *reinterpret_cast<const float2*>(a + 8 * a_stride + 8 * st);
    uint32_t f[8];
    split(x0.x, f[0], f[4]);
    split(x1.x, f[1], f[5]);
    split(x0.y, f[2], f[6]);
    split(x1.y, f[3], f[7]);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const float2 y = *reinterpret_cast<const float2*>(b + 8 * n * kWideCF + 8 * st);
      uint4 bf;
      split(y.x, bf.x, bf.y);
      split(y.y, bf.z, bf.w);
      mma3(ps[n], pc[n], f, bf);
    }
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += ps[n][e] + pc[n][e];
}

// acc[n] += P B(n) for the slab's n_out n8 tiles: P two accumulator tiles
// over a tile's 16 keys (queries), B the staged slab (row 2t at b[0], column
// g: b = slab + 2t kWideVF + g), the 16 summed into a zeroed accumulator
__device__ __forceinline__ void slab_product(float (&acc)[kSlab / 8][4], const float (&p0)[4], const float (&p1)[4],
                                             const float* b, int n_out) {
  uint32_t a0[8], a1[8];
  split_acc(a0, p0);
  split_acc(a1, p1);
#pragma unroll
  for (int n = 0; n < kSlab / 8; ++n) {
    if (n >= n_out) continue;
    const float* vp = b + 8 * n;
    uint4 b0, b1;  // rows 2t, 2t + 1, then 8 + 2t, 9 + 2t
    split(vp[0], b0.x, b0.y);
    split(vp[kWideVF], b0.z, b0.w);
    split(vp[8 * kWideVF], b1.x, b1.y);
    split(vp[9 * kWideVF], b1.z, b1.w);
    float d[4] = {};
    mma3(d, d, a0, b0);
    mma3(d, d, a1, b1);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += d[i];
  }
}

// rows row, row + 8 (< n_rows) of a slab accumulator, its n_out n8 tiles, to dst (row r at dst + r * d)
__device__ __forceinline__ void store_slab(float* dst, const float (&acc)[kSlab / 8][4], int row, int n_rows, int d,
                                           int n_out) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n_rows) continue;
    float* p = dst + (size_t)(row + 8 * r) * d + 2 * t;
#pragma unroll
    for (int n = 0; n < kSlab / 8; ++n)
      if (n < n_out) *reinterpret_cast<float2*>(p + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dq: one CTA per kRows queries x one slab of a (batch row, head); items a
// key tile: its chunks of K and V, then its K slab
template <int kRows, bool kCausal>
__global__ void __launch_bounds__(kRows * 2, 1)
bwd_dq_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                   const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                   float* __restrict__ dq, Shape sh, int stride) {
  constexpr int kThr = kRows * 2;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;
  float* gs = qs + kRows * stride;
  float* stg = gs + kRows * stride;  // two stages of kWideStageF
  const int n_slab = (sh.dh + kSlab - 1) / kSlab;
  const int q0 = blockIdx.x * kRows, h = blockIdx.y / n_slab, c0 = blockIdx.y % n_slab * kSlab;
  const int b = blockIdx.z, warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + (size_t)h * sh.dh;
  const size_t koff = (size_t)b * sh.tk * sh.d + (size_t)h * sh.dh;
  const int chunks = (sh.dh + kWideChunk - 1) / kWideChunk, per_tile = chunks + 1;
  const int items = key_tiles<kCausal, kWideKeys>(sh, q0, q0 + kRows) * per_tile;
  const int n_out = min(kSlab, sh.dh - c0) / 8;  // the slab's n8 tiles below dh
  const float* const kv[2] = {k + koff, v + koff};
  const float* const ko[1] = {k + koff};

  load_own<kRows>(qs, q + qoff, q0, sh.tq, sh.d, sh.dh, stride);
  load_own<kRows>(gs, dout + qoff, q0, sh.tq, sh.d, sh.dh, stride);
  // item i: chunk c of key tile i / per_tile, or (c == chunks) its K slab
  auto load_item = [&](int i) {
    float* dst = stg + (i & 1) * kWideStageF;
    const int key0 = i / per_tile * kWideKeys, c = i % per_tile;
    if (c < chunks)
      load_tile<kThr, 2, kWideChunk, kWideCF>(dst, kv, key0, sh.tk, sh.d, c * kWideChunk, sh.dh);
    else
      load_tile<kThr, 1, kSlab, kWideVF>(dst, ko, key0, sh.tk, sh.d, c0, sh.dh);
  };
  load_item(0);
  cp_commit();

  const int row = q0 + 16 * warp + g;  // this thread's rows: row and row + 8
  float lse2[2], dlt[2];
  int lim[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // p = 0 on rows past tq
    const int qr = row + 8 * r;
    lse2[r] = qr < sh.tq ? lse[res_index(sh, h, b, qr)] * kLog2e : INFINITY;
    dlt[r] = qr < sh.tq ? delta[res_index(sh, h, b, qr)] : 0.f;
    lim[r] = key_limit<kCausal>(sh, qr);
  }
  const float sl2 = sh.scale * kLog2e;
  const float* qa = qs + (16 * warp + g) * stride + 2 * t;
  const float* ga = gs + (16 * warp + g) * stride + 2 * t;
  float s[2][4], dp[2][4], o[kSlab / 8][4] = {};
  for (int i = 0; i < items; ++i) {
    cp_wait<0>();
    __syncthreads();  // item i (and the own rows) landed; every warp is done with item i - 1
    if (i + 1 < items) load_item(i + 1);
    cp_commit();
    const float* cur = stg + (i & 1) * kWideStageF;
    const int c = i % per_tile;
    if (c == 0) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    }
    if (c < chunks) {  // S += Q K^T and dP += dO V^T over the chunk's columns
      const int steps = min(kWideChunk, sh.dh - c * kWideChunk) / 8;
      chunk_scores(s, qa + c * kWideChunk, stride, cur + g * kWideCF + 2 * t, steps);
      chunk_scores(dp, ga + c * kWideChunk, stride, cur + kWideKeys * kWideCF + g * kWideCF + 2 * t, steps);
    } else {  // s becomes dS = p (dP - delta) scale; dQ += dS K_slab
      const int key0 = i / per_tile * kWideKeys;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const bool in = key0 + 8 * n + 2 * t + (e & 1) < lim[r];
          const float p = in ? exp2_approx(s[n][e] * sl2 - lse2[r]) : 0.f;
          s[n][e] = p * (dp[n][e] - dlt[r]) * sh.scale;
        }
      slab_product(o, s[0], s[1], cur + 2 * t * kWideVF + g, n_out);
    }
  }
  cp_wait<0>();  // the own rows of a CTA with no item
  store_slab(dq + qoff + c0, o, row, sh.tq, sh.d, n_out);
}

// dk, dv: one CTA per kRows keys x one slab of a (batch row, head); items a
// query tile: its chunks of Q and dO (the first with the tile's lse and
// delta), then its dO slab, then its Q slab. CTAs whose keys no query sees
// write zeros
template <int kRows, bool kCausal>
__global__ void __launch_bounds__(kRows * 2, 1)
bwd_dkv_wide_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dk, float* __restrict__ dv, Shape sh, int stride) {
  constexpr int kThr = kRows * 2;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm;
  float* vs = ks + kRows * stride;
  float* stg = vs + kRows * stride;       // two stages of kWideStageF
  float* lsd = stg + 2 * kWideStageF;     // a tile's lse then delta, two tiles
  const int n_slab = (sh.dh + kSlab - 1) / kSlab;
  const int k0 = blockIdx.x * kRows, h = blockIdx.y / n_slab, c0 = blockIdx.y % n_slab * kSlab;
  const int b = blockIdx.z, warp = threadIdx.x / 32, g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + (size_t)h * sh.dh;
  const size_t koff = (size_t)b * sh.tk * sh.d + (size_t)h * sh.dh;
  const int n_q = (sh.tq + kWideKeys - 1) / kWideKeys;
  // the first query tile that sees key k0 (none for keys past kv_len)
  const int first = k0 >= sh.kv_len ? n_q : kCausal ? max(0, k0 - sh.q_offset) / kWideKeys : 0;
  const int chunks = (sh.dh + kWideChunk - 1) / kWideChunk, per_tile = chunks + 2;
  const int items = (n_q - first) * per_tile;
  const int n_out = min(kSlab, sh.dh - c0) / 8;
  const int key = k0 + 16 * warp + g;  // this thread's keys: key and key + 8
  const float* const qg[2] = {q + qoff, dout + qoff};
  float acc_k[kSlab / 8][4] = {}, acc_v[kSlab / 8][4] = {};

  if (items > 0) {
    load_own<kRows>(ks, k + koff, k0, sh.tk, sh.d, sh.dh, stride);
    load_own<kRows>(vs, v + koff, k0, sh.tk, sh.d, sh.dh, stride);
    // item i: chunk c of query tile first + i / per_tile, or its dO slab
    // (c == chunks) or Q slab (c == chunks + 1)
    auto load_item = [&](int i) {
      float* dst = stg + (i & 1) * kWideStageF;
      const int tile = i / per_tile, row0 = (first + tile) * kWideKeys, c = i % per_tile;
      if (c < chunks) {
        load_tile<kThr, 2, kWideChunk, kWideCF>(dst, qg, row0, sh.tq, sh.d, c * kWideChunk, sh.dh);
        if (c == 0 && threadIdx.x < 2 * kWideKeys) {  // the tile's lse and delta, zero past tq
          const int x = threadIdx.x, r = x % kWideKeys, qr = row0 + r;
          const size_t at = res_index(sh, h, b, qr < sh.tq ? qr : 0);
          cp_async4(lsd + (tile & 1) * 2 * kWideKeys + x, (x < kWideKeys ? lse : delta) + at, qr < sh.tq);
        }
      } else {
        const float* const slab[1] = {(c == chunks ? dout : q) + qoff};
        load_tile<kThr, 1, kSlab, kWideVF>(dst, slab, row0, sh.tq, sh.d, c0, sh.dh);
      }
    };
    load_item(0);
    cp_commit();
    const float sl2 = sh.scale * kLog2e;
    const float* ka = ks + (16 * warp + g) * stride + 2 * t;
    const float* va = vs + (16 * warp + g) * stride + 2 * t;
    float s[2][4], dp[2][4];
    for (int i = 0; i < items; ++i) {
      cp_wait<0>();
      __syncthreads();  // item i (and K, V) landed; every warp is done with item i - 1
      if (i + 1 < items) load_item(i + 1);
      cp_commit();
      const float* cur = stg + (i & 1) * kWideStageF;
      const int tile = i / per_tile, c = i % per_tile;
      if (c == 0) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      }
      if (c < chunks) {  // S^T += K Q^T and dP^T += V dO^T over the chunk's columns
        const int steps = min(kWideChunk, sh.dh - c * kWideChunk) / 8;
        chunk_scores(s, ka + c * kWideChunk, stride, cur + g * kWideCF + 2 * t, steps);
        chunk_scores(dp, va + c * kWideChunk, stride, cur + kWideKeys * kWideCF + g * kWideCF + 2 * t, steps);
      } else if (c == chunks) {  // s becomes p^T, dp dS^T (rows keys, columns queries); dV += P^T dO_slab
        const int q_row = (first + tile) * kWideKeys;
        const float* l = lsd + (tile & 1) * 2 * kWideKeys;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * t + (e & 1), qr = q_row + col;
            const bool in = qr < sh.tq && key + 8 * (e >> 1) < key_limit<kCausal>(sh, qr);
            const float p = in ? exp2_approx(s[n][e] * sl2 - l[col] * kLog2e) : 0.f;
            dp[n][e] = p * (dp[n][e] - l[kWideKeys + col]) * sh.scale;
            s[n][e] = p;
          }
        slab_product(acc_v, s[0], s[1], cur + 2 * t * kWideVF + g, n_out);
      } else {  // dK += dS^T Q_slab
        slab_product(acc_k, dp[0], dp[1], cur + 2 * t * kWideVF + g, n_out);
      }
    }
  }
  store_slab(dk + koff + c0, acc_k, key, sh.tk, sh.d, n_out);
  store_slab(dv + koff + c0, acc_v, key, sh.tk, sh.d, n_out);
}

template <int kRows, bool kCausal>
int run_bwd_wide(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
                 void* dq, void* dk, void* dv, const Shape& sh, const WideBwdCfg& c, cudaStream_t stream) {
  static bool lifted_dq[64] = {}, lifted_dkv[64] = {};  // to the most any plan takes, once
  cudaError_t err = sm90::lift_smem(bwd_dq_wide_kernel<kRows, kCausal>, sm90::kSmemMax, lifted_dq);
  if (err == cudaSuccess) err = sm90::lift_smem(bwd_dkv_wide_kernel<kRows, kCausal>, sm90::kSmemMax, lifted_dkv);
  if (err != cudaSuccess) return (int)err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout),
              *lf = static_cast<const float*>(lse), *df = static_cast<const float*>(delta);
  bwd_dq_wide_kernel<kRows, kCausal><<<dim3((sh.tq + kRows - 1) / kRows, sh.n_head * c.slabs, sh.batch), kRows * 2,
                                       c.smem, stream>>>(qf, kf, vf, gf, lf, df, static_cast<float*>(dq), sh,
                                                         c.stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_wide_kernel<kRows, kCausal><<<dim3((sh.tk + kRows - 1) / kRows, sh.n_head * c.slabs, sh.batch), kRows * 2,
                                        c.smem, stream>>>(qf, kf, vf, gf, lf, df, static_cast<float*>(dk),
                                                          static_cast<float*>(dv), sh, c.stride);
  return (int)cudaGetLastError();
}

// each instance lifts its own shared-memory limit (one record per kernel
// instance: a record per kernel type would skip a second width's)
template <int kDh, bool kCausal>
int run_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, cudaStream_t stream) {
  constexpr int kSmem = Cfg<kDh>::kFwdSmem;
  static bool lifted[64] = {};
  const cudaError_t err = sm90::lift_smem(fwd_kernel<kDh, kCausal>, kSmem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kBM - 1) / kBM, sh.n_head, sh.batch);
  fwd_kernel<kDh, kCausal><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <int kDh, bool kCausal>
int run_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
            void* dq, void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  using C = Cfg<kDh>;
  static bool lifted_dq[64] = {}, lifted_dkv[64] = {};
  cudaError_t err = sm90::lift_smem(bwd_dq_kernel<kDh, kCausal>, C::kDqSmem, lifted_dq);
  if (err == cudaSuccess) err = sm90::lift_smem(bwd_dkv_kernel<kDh, kCausal>, C::kDkvSmem, lifted_dkv);
  if (err != cudaSuccess) return (int)err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout),
              *lf = static_cast<const float*>(lse), *df = static_cast<const float*>(delta);
  bwd_dq_kernel<kDh, kCausal><<<dim3((sh.tq + kBM - 1) / kBM, sh.n_head, sh.batch), kThreads, C::kDqSmem, stream>>>(
      qf, kf, vf, gf, lf, df, static_cast<float*>(dq), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_kernel<kDh, kCausal><<<dim3((sh.tk + kBM - 1) / kBM, sh.n_head, sh.batch), kThreads, C::kDkvSmem,
                                  stream>>>(qf, kf, vf, gf, lf, df, static_cast<float*>(dk), static_cast<float*>(dv),
                                            sh);
  return (int)cudaGetLastError();
}

// rows are read by 16-byte copies and written 8 bytes at a time
bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

template <int kDh>
int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, bool causal,
               cudaStream_t s) {
  if (bad_shape(sh, kDh) || (lse != nullptr && sh.n_head % sh.hpb)) return (int)cudaErrorInvalidValue;
  if (misaligned({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
  return causal ? run_fwd<kDh, true>(q, k, v, out, lse, sh, s) : run_fwd<kDh, false>(q, k, v, out, lse, sh, s);
}

template <int kDh>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, const Shape& sh, bool causal, cudaStream_t s) {
  if (bad_shape(sh, kDh) || sh.n_head % sh.hpb) return (int)cudaErrorInvalidValue;
  if (misaligned({q, k, v, dout, dq, dk, dv})) return (int)cudaErrorMisalignedAddress;
  return causal ? run_bwd<kDh, true>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s)
                : run_bwd<kDh, false>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
}

#ifndef FLASH_ATTENTION_F16
// the forward at the width class of sh.dh, or the wide forward from 136 to 768
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, bool causal,
        void* stream) {
  auto s = (cudaStream_t)stream;
  if (sh.dh > 128) {
    if (bad_wide_shape(sh)) return (int)cudaErrorInvalidValue;
    if (misaligned({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
    const WideCfg c = wide_cfg(sh.dh);
    if (c.rows == 64)
      return causal ? run_fwd_wide<64, true>(q, k, v, out, lse, sh, c, s)
                    : run_fwd_wide<64, false>(q, k, v, out, lse, sh, c, s);
    return causal ? run_fwd_wide<32, true>(q, k, v, out, lse, sh, c, s)
                  : run_fwd_wide<32, false>(q, k, v, out, lse, sh, c, s);
  }
  switch (width_class(sh.dh)) {
    case 32: return launch_fwd<32>(q, k, v, out, lse, sh, causal, s);
    case 64: return launch_fwd<64>(q, k, v, out, lse, sh, causal, s);
    case 128: return launch_fwd<128>(q, k, v, out, lse, sh, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the backward at the width class of sh.dh, or the wide backward from 136 to 768
int bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, const Shape& sh, bool causal, void* stream) {
  auto s = (cudaStream_t)stream;
  if (sh.dh > 128) {
    if (bad_wide_shape(sh)) return (int)cudaErrorInvalidValue;
    if (misaligned({q, k, v, dout, dq, dk, dv})) return (int)cudaErrorMisalignedAddress;
    const WideBwdCfg c = wide_bwd_cfg(sh.dh);
    if (c.rows == 64)
      return causal ? run_bwd_wide<64, true>(q, k, v, dout, lse, delta, dq, dk, dv, sh, c, s)
                    : run_bwd_wide<64, false>(q, k, v, dout, lse, delta, dq, dk, dv, sh, c, s);
    return causal ? run_bwd_wide<32, true>(q, k, v, dout, lse, delta, dq, dk, dv, sh, c, s)
                  : run_bwd_wide<32, false>(q, k, v, dout, lse, delta, dq, dk, dv, sh, c, s);
  }
  switch (width_class(sh.dh)) {
    case 32: return launch_bwd<32>(q, k, v, dout, lse, delta, dq, dk, dv, sh, causal, s);
    case 64: return launch_bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, sh, causal, s);
    case 128: return launch_bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, sh, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
#endif  // FLASH_ATTENTION_F16

}  // namespace f32

}  // namespace

#ifdef FLASH_ATTENTION_F16
// ------------------------------------------------------ fp16 entry points
// The serving forwards of the bf16 entries below with fp16 tensors: the
// same kernels (`flash_fwd_sm90_kernel`, `flash_fwd_wide_sm90_kernel`)
// instantiated for __half, with fp16 tensor maps and wgmma f16 products,
// built by flash_attention_f16.cu in a translation unit of their own (one
// nvcc each, in parallel with this file's; `ops/_cuda.py`). No logsumexp:
// the training forwards (K3-lse, K7-lse) and backwards (K6, K8) come with
// the fp16 training slice.

// K5 at fp16: the routes and plan of `flash_mh_fwd_bf16`
extern "C" int flash_mh_fwd_f16(const void* q, const void* k, const void* v, void* out, int batch, int tq, int tk,
                                int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, dh, n_head, 1, kv_len, 0, scale};
  if (dh <= 128) return launch_fwd_sm90<__half>(q, k, v, out, nullptr, sh, false, stream, width_class(dh) != dh);
  return sm90::fwd_wide<__half>(q, k, v, out, nullptr, sh, false, (cudaStream_t)stream);
}

// K3 at fp16, no logsumexp (`lse` must be null)
extern "C" int flash_h2_fwd_f16(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                int tq, int tk, int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head || lse != nullptr) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, dh, n_head, h2_hpb(dh), kv_len, 0, scale};
  if (sh.hpb < 1) return (int)cudaErrorInvalidValue;
  return launch_fwd_sm90<__half>(q, k, v, out, nullptr, sh, false, stream);
}

// K7 at fp16, no logsumexp (`lse` must be null): dh a multiple of 8 from 8 to 768
extern "C" int flash_fwd_f16(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq,
                             int tk, int dh, int kv_len, int causal, int q_offset, float scale, void* stream) {
  if (lse != nullptr) return (int)cudaErrorInvalidValue;
  Shape sh{bh, tq, tk, dh, dh, 1, 1, kv_len, q_offset, scale};
  if (dh > 128) return sm90::fwd_wide<__half>(q, k, v, out, nullptr, sh, causal != 0, (cudaStream_t)stream);
  return launch_fwd_sm90<__half>(q, k, v, out, nullptr, sh, causal != 0, stream);
}

#else  // the bf16 and fp32 entries, and the plans

// K5: natural (B, T, D) layout, non-causal, head width d / n_head any
// multiple of 8 up to 768; no logsumexp. The width classes 32, 64 and 128
// take the sm90 forward over the 3-D maps (K3's), the other widths up to
// 120 the same kernel at their class over the head maps (route A), and
// 136-768 the wide forward (route B)
extern "C" int flash_mh_fwd_bf16(const void* q, const void* k, const void* v, void* out, int batch, int tq, int tk,
                                 int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, dh, n_head, 1, kv_len, 0, scale};
  if (dh <= 128) return launch_fwd_sm90(q, k, v, out, nullptr, sh, false, stream, width_class(dh) != dh);
  return sm90::fwd_wide<__nv_bfloat16>(q, k, v, out, nullptr, sh, false, (cudaStream_t)stream);
}

// K5's plan at head width dh and tq queries, as `flash_mh_fwd_bf16` takes
// it (`ops.flash_attention.k5_plan`): plan[0..5] = the route (0: a width
// class on the 3-D maps, 1: route A, 2: route B), the width class (route B:
// the slabs), query rows a CTA, keys a tile, stages, shared bytes. Returns
// cudaErrorInvalidValue for a width no route serves
extern "C" int flash_mh_plan_bf16(int dh, int tq, void* plan) {
  int* p = static_cast<int*>(plan);
  const int cls = width_class(dh);
  if (cls != 0) {
    p[0] = cls == dh ? 0 : 1;
    if (cls == 32) sm90::fwd_plan<32>(tq, p);
    if (cls == 64) sm90::fwd_plan<64>(tq, p);
    if (cls == 128) sm90::fwd_plan<128>(tq, p);
    return 0;
  }
  if (bad_wide_dh(dh)) return (int)cudaErrorInvalidValue;
  const sm90::WidePlan w = sm90::wide_plan(dh, tq);
  const int vals[6] = {2, w.slabs, w.wg * sm90::kBM, w.keys, w.stages, w.smem};
  for (int i = 0; i < 6; ++i) p[i] = vals[i];
  return 0;
}

// the fp16 K5's plan: the bf16 K5's (the element size, 2 bytes, is all the plan reads of the type)
extern "C" int flash_mh_plan_f16(int dh, int tq, void* plan) { return flash_mh_plan_bf16(dh, tq, plan); }

// K3: natural (B, T, D) layout, non-causal, head width d / n_head 32, 64 or
// 128; `lse` may be null, else it is (D/128, B, Tq, 128 / dh) fp32
extern "C" int flash_h2_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                 int tq, int tk, int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, dh, n_head, h2_hpb(dh), kv_len, 0, scale};
  if (sh.hpb < 1 || (lse != nullptr && n_head % sh.hpb)) return (int)cudaErrorInvalidValue;
  return launch_fwd_sm90(q, k, v, out, lse, sh, false, stream);
}

// K6: (dq, dk, dv) of K3 from lse and delta, both (D/128, B, Tq, 128 / dh) fp32
extern "C" int flash_h2_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv, int batch, int tq, int tk, int d,
                                 int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, dh, n_head, h2_hpb(dh), kv_len, 0, scale};
  return launch_h2_bwd_sm90(q, k, v, dout, lse, delta, dq, dk, dv, sh, stream);
}

// K7: head-split (BH, T, dh), dh a multiple of 8 from 8 to 768 (the wide
// forward above 128); `lse` may be null, else it is (BH, Tq, 1) fp32
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq,
                              int tk, int dh, int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, dh, 1, 1, kv_len, q_offset, scale};
  if (dh > 128) return sm90::fwd_wide<__nv_bfloat16>(q, k, v, out, lse, sh, causal != 0, (cudaStream_t)stream);
  return launch_fwd_sm90(q, k, v, out, lse, sh, causal != 0, stream);
}

// K8: (dq, dk, dv) of K7 from lse and delta, both (BH, Tq, 1) fp32; dh a
// multiple of 8 from 8 to 768 (the wide backward above 128)
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv, int bh, int tq, int tk, int dh,
                              int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, dh, 1, 1, kv_len, q_offset, scale};
  if (dh > 128)
    return causal ? sm90::bwd_wide<true>(q, k, v, dout, lse, delta, dq, dk, dv, sh, (cudaStream_t)stream)
                  : sm90::bwd_wide<false>(q, k, v, dout, lse, delta, dq, dk, dv, sh, (cudaStream_t)stream);
  return causal ? launch_bwd_sm90<true>(q, k, v, dout, lse, delta, dq, dk, dv, sh, stream)
                : launch_bwd_sm90<false>(q, k, v, dout, lse, delta, dq, dk, dv, sh, stream);
}

// ------------------------------------------------------ fp32 entry points
// The same arguments and layouts as the bf16 entries above, fp32 tensors
// on 16-byte boundaries (rows are copied 16 bytes at a time), at the head
// widths of their bf16 twins (K5 and K7 every multiple of 8 up to 768, a
// head's columns past dh loading as zeros up to 128 and the wide forward
// above): namespace f32's 3xTF32 kernels.

// K3 at fp32; `lse` may be null, else it is (D/128, B, Tq, 128 / dh) fp32
extern "C" int flash_h2_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                int tq, int tk, int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, dh, n_head, h2_hpb(dh), kv_len, 0, scale};
  if (sh.hpb < 1) return (int)cudaErrorInvalidValue;
  return f32::fwd(q, k, v, out, lse, sh, false, stream);
}

// K5 at fp32, a head width that is a multiple of 8 from 8 to 768 over any
// number of heads (the wide forward above 128); no logsumexp
extern "C" int flash_mh_fwd_f32(const void* q, const void* k, const void* v, void* out, int batch, int tq, int tk,
                                int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  Shape sh{batch, tq, tk, d, d / n_head, n_head, 1, kv_len, 0, scale};
  return f32::fwd(q, k, v, out, nullptr, sh, false, stream);
}

// K6 at fp32: (dq, dk, dv) of K3 from lse and delta, both (D/128, B, Tq, 128 / dh) fp32
extern "C" int flash_h2_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk, void* dv, int batch, int tq, int tk, int d,
                                int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, dh, n_head, h2_hpb(dh), kv_len, 0, scale};
  if (sh.hpb < 1) return (int)cudaErrorInvalidValue;
  return f32::bwd(q, k, v, dout, lse, delta, dq, dk, dv, sh, false, stream);
}

// K7 at fp32: head-split (BH, T, dh), dh a multiple of 8 from 8 to 768 (the
// wide forward above 128); `lse` may be null, else it is (BH, Tq, 1) fp32
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq,
                             int tk, int dh, int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, dh, 1, 1, kv_len, q_offset, scale};
  return f32::fwd(q, k, v, out, lse, sh, causal != 0, stream);
}

// K8 at fp32: (dq, dk, dv) of K7 from lse and delta, both (BH, Tq, 1) fp32;
// dh a multiple of 8 from 8 to 768 (the wide backward above 128)
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv, int bh, int tq, int tk, int dh,
                             int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, dh, 1, 1, kv_len, q_offset, scale};
  return f32::bwd(q, k, v, dout, lse, delta, dq, dk, dv, sh, causal != 0, stream);
}

// the fp32 wide forward's plan at head width dh (`ops.flash_attention.
// f32_wide_plan`): plan[0..3] = query rows a CTA, keys a tile, output slabs
// a head, shared bytes. Returns cudaErrorInvalidValue for a width it does
// not serve (a multiple of 8 from 136 to 768)
extern "C" int flash_wide_plan_f32(int dh, void* plan) {
  if (bad_wide_dh(dh)) return (int)cudaErrorInvalidValue;
  const f32::WideCfg c = f32::wide_cfg(dh);
  const int vals[4] = {c.rows, f32::kWideKeys, c.slabs, c.smem};
  int* p = static_cast<int*>(plan);
  for (int i = 0; i < 4; ++i) p[i] = vals[i];
  return 0;
}

// K8's wide backward plan at head width dh (`ops.flash_attention.
// k8_wide_plan`): plan[0..6] = output slabs a head, keys a K / V box of
// the dq kernel, its stages, its shared bytes, the dk/dv kernel's queries a
// Q / dO box, its stages, its shared bytes. Returns cudaErrorInvalidValue
// for a width it does not serve (a multiple of 8 from 136 to 768)
extern "C" int flash_wide_bwd_plan_bf16(int dh, void* plan) {
  if (bad_wide_dh(dh)) return (int)cudaErrorInvalidValue;
  const sm90::WideBwdPlan w = sm90::wide_bwd_plan(dh);
  const int vals[7] = {w.slabs, w.dq_keys, w.dq_stages, w.dq_smem, sm90::kWideDkvQ, w.dkv_stages, w.dkv_smem};
  int* p = static_cast<int*>(plan);
  for (int i = 0; i < 7; ++i) p[i] = vals[i];
  return 0;
}

// the fp32 wide backward's plan at head width dh (`ops.flash_attention.
// f32_k8_wide_plan`): plan[0..3] = own rows a CTA, keys (queries) a tile,
// output slabs a head, shared bytes of either kernel. Returns
// cudaErrorInvalidValue for a width it does not serve (136-768)
extern "C" int flash_wide_bwd_plan_f32(int dh, void* plan) {
  if (bad_wide_dh(dh)) return (int)cudaErrorInvalidValue;
  const f32::WideBwdCfg c = f32::wide_bwd_cfg(dh);
  const int vals[4] = {c.rows, f32::kWideKeys, c.slabs, c.smem};
  int* p = static_cast<int*>(plan);
  for (int i = 0; i < 4; ++i) p[i] = vals[i];
  return 0;
}

#endif  // FLASH_ATTENTION_F16

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

