// Flash attention for Hopper (sm_90a): the forward K3 (non-causal, natural
// (B, T, D) layout, optional logsumexp), K5 (non-causal, natural layout,
// any head width that is a multiple of 8 up to 768) and K7 (head-split
// (BH, T, dh), causal / q_offset / kv_len, optional logsumexp), and the
// FlashAttention-2 backward K6 (of K3) and K8 (of K7), bf16 in, fp32
// accumulate, at head widths dh of 32, 64 and 128 (K5 at any); and the
// same functions in fp32 at a head width of 64, fp32-accurate on the tensor
// cores in 3xTF32 (namespace f32, its own note below).
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
// K5 at those widths is the K3 forward without the logsumexp, over any
// number of heads (its device code reads the natural layout at dh columns
// a head and never assumes d % 128 == 0; the lse layout is the only part
// that does). Other widths take `flash_mh_kernel`: 4 warps over 16
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
#include <initializer_list>

using namespace nvcuda;

namespace {

constexpr int kWarps = 4;          // flash_mh_kernel's warps
constexpr int kThreads = kWarps * 32;
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

// a shape the kernels take at head width dh (d = dh * n_head)
bool bad_shape(const Shape& sh, int dh) {
  return sh.batch < 1 || sh.tq < 1 || sh.tk < 1 || sh.n_head < 1 || sh.d != sh.n_head * dh ||
         sh.kv_len < 1 || sh.kv_len > sh.tk || sh.q_offset < 0 || sh.hpb < 1;
}

// ------------------------------ K3 and K7 forward on Hopper: TMA + wgmma
//
// Serves K3 (`flash_h2_fwd_bf16`, with and without the logsumexp), K5 at a
// head width of 32, 64 or 128 (`flash_mh_fwd_bf16`) and K7
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
//     layout at column h * dh, into a ring of stages with full and empty
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

template <int kDh, int kWG, int kStages>
struct Smem {  // every tile 1024-byte aligned: a swizzle pattern repeats over 8 rows (1024 or 512 bytes)
  static constexpr int kN = kFwdKeys<kDh>;
  alignas(1024) __nv_bfloat16 q[kWG * kBM * kDh];
  alignas(1024) __nv_bfloat16 k[kStages][kN * kDh];
  alignas(1024) __nv_bfloat16 v[kStages][kN * kDh];
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
template <int kDh>
__device__ __forceinline__ void tma_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int row, int b, int rows) {
  using G = Geo<kDh>;
#pragma unroll
  for (int j = 0; j < G::kBoxes; ++j)
    tma_load_3d(dst + j * rows * G::kBoxCols, map, bar, col + j * G::kBoxCols, row, b);
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

// p rounded to bf16 pairs as the A fragments of P V: the accumulator of 16
// keys is the A fragment of one k16 step (pairs 4kk .. 4kk + 3)
template <int N>
__device__ __forceinline__ void pack_p(const float (&sc)[N], uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) pa[i / 4][i % 4] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// d (m64nN fp32, N / 2 a thread) (+)= A (64 x 16, shared, K-major) . B (nN x 16, shared, K-major)^T
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
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

// d (m64nN fp32, N / 2 a thread) += A (64 x 16 bf16, registers) . B (16 x nN, shared, MN-major)
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
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

template <int kDh, int kWG, int kStages, bool kCausal>
__global__ void __launch_bounds__(kWG * 128 + 32, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, Shape sh) {
  using G = Geo<kDh>;
  constexpr int kN = kFwdKeys<kDh>;
  extern __shared__ unsigned char smem_raw[];
  auto& s = *reinterpret_cast<Smem<kDh, kWG, kStages>*>(smem_raw + ((1024 - (saddr(smem_raw) & 1023)) & 1023));
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
    if (lane == 0) {
      mbar_expect_tx(&s.q_full, kWG * kBM * G::kRowB);
      tma_tile<kDh>(s.q, &tm_q, &s.q_full, h * kDh, q0, b, kWG * kBM);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&s.k_full[st], kN * G::kRowB);
        tma_tile<kDh>(s.k[st], &tm_k, &s.k_full[st], h * kDh, t * kN, b, kN);
        mbar_expect_tx(&s.v_full[st], kN * G::kRowB);
        tma_tile<kDh>(s.v[st], &tm_v, &s.v_full[st], h * kDh, t * kN, b, kN);
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
      wgmma_ss<kN>(sc, dq + kstep<kDh>(kk, kQBox), dk + kstep<kDh>(kk, kKBox), kk);
    wg_commit();
  };
  // O += P V of tile t: kN / 16 steps of 16 keys
  auto start_pv = [&](int t) {
    const int st = t % kStages;
    mbar_wait(&s.v_full[st], (t / kStages) & 1);
    const uint64_t dv = desc<kDh>(s.v[st], kKBox);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs<kDh>(o, pa[kk], dv + mnstep<kDh>(kk));
    wg_commit();
  };

  wg_fence();
  start_s(0);
  wg_wait<0>();
  reg_fence(sc);
  softmax_tile(sc, m_run, l_run, corr, 0, lim, warp_lim, t4, sl2);
  pack_p(sc, pa);
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
    pack_p(sc, pa);
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

// a (B, T, D) bf16 tensor as a 3-D map (D, T, B), boxes of kBoxCols columns
// x `rows` rows x 1 in the kSwB-byte swizzle, zeros outside
template <int kDh>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr, int batch, int t, int d, int rows) {
  constexpr int kSwB = Geo<kDh>::kSwB;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)t, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)t * d * 2};
  const cuuint32_t box[3] = {(cuuint32_t)Geo<kDh>::kBoxCols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
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

template <int kDh, int kWG, int kStages, bool kCausal>
int run(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, cudaStream_t stream) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode<kDh>(enc, &tm_q, q, sh.batch, sh.tq, sh.d, kWG * kBM) ||
      !encode<kDh>(enc, &tm_k, k, sh.batch, sh.tk, sh.d, kFwdKeys<kDh>) ||
      !encode<kDh>(enc, &tm_v, v, sh.batch, sh.tk, sh.d, kFwdKeys<kDh>))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<kDh, kWG, kStages>) + 1024;  // + the alignment slack
  static bool lifted[64] = {};
  const cudaError_t err = lift_smem(flash_fwd_sm90_kernel<kDh, kWG, kStages, kCausal>, smem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kWG * kBM - 1) / (kWG * kBM), sh.n_head, sh.batch);
  flash_fwd_sm90_kernel<kDh, kWG, kStages, kCausal><<<grid, kWG * 128 + 32, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

// ------------------------------------- K6 and K8 on Hopper: TMA + wgmma
//
// Serves K6 (`flash_h2_bwd_bf16`) and K8 (`flash_bwd_bf16`: causal or not,
// any q_offset, residuals at hpb = 1), each at head widths 32, 64 and 128
// (a template parameter; the tiles lie in shared memory as the forward's).
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
      tma_tile<kDh>(s.q, &tm_q, &s.qg_full, h * kDh, q0, b, kWG * kBM);
      tma_tile<kDh>(s.g, &tm_g, &s.qg_full, h * kDh, q0, b, kWG * kBM);
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        mbar_expect_tx(&s.full[st], 2 * kN * G::kRowB);
        tma_tile<kDh>(s.k[st], &tm_k, &s.full[st], h * kDh, t * kN, b, kN);
        tma_tile<kDh>(s.v[st], &tm_v, &s.full[st], h * kDh, t * kN, b, kN);
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
  store_acc(dq + (size_t)b * sh.tq * sh.d + (size_t)h * kDh, acc, row0, sh.tq, sh.d, t4);
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
      tma_tile<kDh>(s.k, &tm_k, &s.kv_full, h * kDh, k0, b, kWG * kBM);
      tma_tile<kDh>(s.v, &tm_v, &s.kv_full, h * kDh, k0, b, kWG * kBM);
      // a box past tq reads the next lane's residuals (masked below) or
      // zeros past the end
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kStages, first = res0 + (qt0 + t) * kQ * kHpb;
        if (t >= kStages) mbar_wait(&s.empty[st], (t / kStages - 1) & 1);
        constexpr int kPieces = kResPieces<kHpb, kQ>, kBox = kResBox<kHpb, kQ>;
        mbar_expect_tx(&s.full[st], 2 * kQ * G::kRowB + 2 * kPieces * kBox * 4);
        tma_tile<kDh>(s.q[st], &tm_q, &s.full[st], h * kDh, (qt0 + t) * kQ, b, kQ);
        tma_tile<kDh>(s.g[st], &tm_g, &s.full[st], h * kDh, (qt0 + t) * kQ, b, kQ);
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
  const size_t off = (size_t)b * sh.tk * sh.d + (size_t)h * kDh;
  store_acc(dk + off, acc_k, key0, sh.tk, sh.d, t4);
  store_acc(dv + off, acc_v, key0, sh.tk, sh.d, t4);
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

// the forward over the natural layout (K3, K5 at a head width of kDh, and K7
// as batch = BH, one head)
template <int kDh>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, bool causal,
        cudaStream_t s) {
  if (bad_shape(sh, kDh)) return (int)cudaErrorInvalidValue;
  // TMA needs 16-byte aligned bases and row strides (d % 8 == 0 holds: d = kDh * n_head)
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (sh.tq <= kBM)
    return causal ? run<kDh, 1, 2, true>(q, k, v, out, lse, sh, s) : run<kDh, 1, 2, false>(q, k, v, out, lse, sh, s);
  return causal ? run<kDh, 2, 4, true>(q, k, v, out, lse, sh, s) : run<kDh, 2, 4, false>(q, k, v, out, lse, sh, s);
}

// (dq, dk, dv) of the forward: K6 (natural layout, h2 residuals, kHpb =
// 128 / kDh, never causal) and K8 (batch = BH, one head, kHpb 1)
template <int kDh, bool kCausal, int kHpb>
int bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta, void* dq,
        void* dk, void* dv, const Shape& sh, cudaStream_t s) {
  if (bad_shape(sh, kDh) || sh.hpb != kHpb || sh.n_head % kHpb) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v) |
       reinterpret_cast<uintptr_t>(dout) | reinterpret_cast<uintptr_t>(lse) | reinterpret_cast<uintptr_t>(delta)) % 16)
    return (int)cudaErrorMisalignedAddress;
  const int err = sh.tq <= kBM ? run_dq<kDh, 1, 2, kCausal>(q, k, v, dout, lse, delta, dq, sh, s)
                               : run_dq<kDh, 2, 4, kCausal>(q, k, v, dout, lse, delta, dq, sh, s);
  if (err != 0) return err;
  return sh.tk <= kBM ? run_dkv<kDh, 1, 2, kCausal, kHpb>(q, k, v, dout, lse, delta, dk, dv, sh, s)
                      : run_dkv<kDh, 2, 4, kCausal, kHpb>(q, k, v, dout, lse, delta, dk, dv, sh, s);
}

}  // namespace sm90

// the forward at head width dh (32, 64 or 128)
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, int dh,
                    bool causal, void* stream) {
  auto s = (cudaStream_t)stream;
  switch (dh) {
    case 32: return sm90::fwd<32>(q, k, v, out, lse, sh, causal, s);
    case 64: return sm90::fwd<64>(q, k, v, out, lse, sh, causal, s);
    case 128: return sm90::fwd<128>(q, k, v, out, lse, sh, causal, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 at head width dh: the h2 residuals hold hpb = 128 / dh heads a lane
int launch_h2_bwd_sm90(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                       const void* delta, void* dq, void* dk, void* dv, const Shape& sh, int dh, void* stream) {
  auto s = (cudaStream_t)stream;
  switch (dh) {
    case 32: return sm90::bwd<32, false, 4>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 64: return sm90::bwd<64, false, 2>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 128: return sm90::bwd<128, false, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K8 at head width dh, residuals (BH, Tq, 1)
template <bool kCausal>
int launch_bwd_sm90(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                    const void* delta, void* dq, void* dk, void* dv, const Shape& sh, int dh, void* stream) {
  auto s = (cudaStream_t)stream;
  switch (dh) {
    case 32: return sm90::bwd<32, kCausal, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 64: return sm90::bwd<64, kCausal, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    case 128: return sm90::bwd<128, kCausal, 1>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the h2 lane's head count, 128 / dh, for a head width that divides 128 (0 otherwise)
int h2_hpb(int dh) { return dh > 0 && 128 % dh == 0 ? 128 / dh : 0; }

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

// ------------------------------------------ fp32: K3, K5 at dh 64, K7, K6, K8
//
// fp32 in, fp32 out, fp32-accurate products on the tensor cores in 3xTF32.
// Serves `flash_h2_fwd_f32`, `flash_mh_fwd_f32` (head width 64),
// `flash_fwd_f32`, `flash_h2_bwd_f32` and `flash_bwd_f32` over the layouts,
// masks and residuals of the bf16 kernels (`Shape`, `res_index`), causal a
// template parameter; p and dS stay fp32, as the JAX kernels keep them in
// v's (q's) dtype.
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
// mma.sync runs TF32 well below that peak (`tf32_mma_probe` measures it),
// so the design keeps mma.sync fed and spends few other instructions:
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
//     a warp, and walks the other side in tiles: 64 keys in the forward
//     (scored 32 at a time), 32 keys in the dq kernel, 32 queries in the
//     dk/dv kernel (16 at a time). Two CTAs an SM (96, 80 and 112.5 KB of
//     shared memory, at most 255 registers a thread, no spill).
//   - Q, which a warp of the forward or the dq kernel keeps for the whole
//     walk, is read once from global memory as A fragments and split once,
//     into registers. The other operands a warp keeps (dO in the dq kernel;
//     K and V in the dk/dv kernel, whose two accumulators fill the
//     registers) stay in split tiles of 64 rows.
//   - A shared operand is split once a tile, not once a warp: the tile lands
//     in a raw buffer by 16-byte cp.async (rows past the end zero-filled);
//     one pass writes it as (big, small) pairs into a split tile of 512-byte
//     rows whose 16-byte chunks (two columns each) are XOR-swizzled by the
//     row (`swz`); then the next tile's copy starts into the raw buffer and
//     overlaps this tile's products. Every fragment load of a split tile is
//     free of bank conflicts: a B operand read along its rows (K in Q K^T,
//     V in dO V^T, Q and dO in the dk/dv scores) and an A operand (dO in
//     the dq kernel, K and V in the dk/dv kernel) as one 16-byte load a
//     fragment row, a B operand summed over its rows (V in P V, K in dS K,
//     dO in P^T dO, Q in dS^T Q) as two 8-byte loads.
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

constexpr int kDh = 64;            // the head width the fp32 kernels take
constexpr int kSteps = kDh / 8;    // k8 steps over a row
constexpr int kThreads = 128;      // 4 warps
constexpr int kBM = 64;            // rows a CTA owns (16 a warp): queries, or keys in the dk/dv kernel
constexpr int kFwdN = 64;          // keys of a forward tile
constexpr int kFwdPart = 32;       // keys the forward scores at a time
constexpr int kBwdN = 32;          // keys of a dq tile, queries of a dk/dv tile
constexpr int kDkvPart = 16;       // queries the dk/dv kernel scores at a time
constexpr int kRawF = kDh;         // floats of a raw row
constexpr int kSplitF = 2 * kDh;   // floats of a split row: (big, small) a column
constexpr int kFwdSmem = (2 * kFwdN * kRawF + 2 * kFwdN * kSplitF) * 4;
constexpr int kDqSmem = (2 * kBwdN * kRawF + 2 * kBwdN * kSplitF + kBM * kSplitF) * 4;
// + K's split tile, and lse and delta as copied and as read
constexpr int kDkvSmem = kDqSmem + kBM * kSplitF * 4 + 4 * kBwdN * 4;
static_assert(kBM * kRawF <= kBwdN * kSplitF, "the raw rows of one 64-row operand wait in one split tile's room");

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

// rows row0 .. row0 + kRows - 1 of one (batch row, head) slice (row r at
// src + r * d, 64 values) into a raw tile; rows at or past n_rows are zero
template <int kRows>
__device__ __forceinline__ void load_raw(float* dst, const float* src, int row0, int n_rows, int d) {
  static_assert(kRows * kDh / 4 % kThreads == 0, "whole 16-byte chunks a thread");
#pragma unroll
  for (int j = 0; j < kRows * kDh / 4 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (kDh / 4), c = i % (kDh / 4);
    const bool in = row0 + r < n_rows;
    cp_async16(dst + r * kRawF + 4 * c, src + (size_t)(in ? row0 + r : 0) * d + 4 * c, in);
  }
}

// lse and delta of query rows row0 .. row0 + kBwdN - 1 (zero past tq)
__device__ __forceinline__ void load_res(float* lraw, float* draw, const float* lse, const float* delta,
                                         const Shape& sh, int h, int b, int row0) {
  const int i = threadIdx.x, r = i % kBwdN, row = row0 + r;
  if (i < 2 * kBwdN) {
    const bool in = row < sh.tq;
    const size_t at = res_index(sh, h, b, in ? row : 0);
    cp_async4((i < kBwdN ? lraw : draw) + r, (i < kBwdN ? lse : delta) + at, in);
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
template <int kRows>
__device__ __forceinline__ void split_tile(float* dst, const float* raw) {
#pragma unroll
  for (int j = 0; j < kRows * kDh / 4 / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads, r = i / (kDh / 4), c4 = i % (kDh / 4);
    const float4 x = *reinterpret_cast<const float4*>(raw + r * kRawF + 4 * c4);
    uint4 lo, hi;
    split(x.x, lo.x, lo.y);
    split(x.y, lo.z, lo.w);
    split(x.z, hi.x, hi.y);
    split(x.w, hi.z, hi.w);
    // half the lanes of a row store their second chunk first: 8 lanes, 8 bank groups
    const int first = (c4 >> 2) & 1, s = swz(r);
    float* row = dst + r * kSplitF;
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
__device__ __forceinline__ Lanes lanes() {
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
__device__ __forceinline__ uint4 frag_b_rows(const float* sp, const Lanes& L, int n, int ks) {
  return *reinterpret_cast<const uint4*>(sp + L.rows[ks & 1] + 32 * (ks >> 1) + 8 * n * kSplitF);
}

// B fragment of k8 step j, n8 tile n, of a product summed over the split
// tile's rows (V in P V): rows 8j + 2t and 8j + 2t + 1, A's columns t, t + 4
__device__ __forceinline__ uint4 frag_b_cols(const float* sp, const Lanes& L, int j, int n) {
  const float* base = sp + 32 * (n >> 1) + 8 * j * kSplitF;
  const uint2 lo = *reinterpret_cast<const uint2*>(base + L.cols[0][n & 1]);
  const uint2 hi = *reinterpret_cast<const uint2*>(base + L.cols[1][n & 1]);
  return make_uint4(lo.x, lo.y, hi.x, hi.y);
}

// A fragment (big a0..a3, then small a0..a3) of rows r0 + g and r0 + g + 8,
// k8 step ks, from a split tile
__device__ __forceinline__ void frag_a(uint32_t (&a)[8], const float* sp, const Lanes& L, int r0, int ks) {
  const float* base = sp + L.rows[ks & 1] + 32 * (ks >> 1) + r0 * kSplitF;
  const uint4 x = *reinterpret_cast<const uint4*>(base);                // row g: a0, a2
  const uint4 y = *reinterpret_cast<const uint4*>(base + 8 * kSplitF);  // row g + 8: a1, a3
  a[0] = x.x, a[1] = y.x, a[2] = x.z, a[3] = y.z;
  a[4] = x.y, a[5] = y.y, a[6] = x.w, a[7] = y.w;
}

// Q's A fragments of rows row and row + 8 (zero at or past n_rows) for every
// k8 step, from global memory, split once: columns 8 ks + 2t, 8 ks + 2t + 1
__device__ __forceinline__ void load_a(uint32_t (&a)[kSteps][8], const float* src, int row, int n_rows, int d) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < n_rows;
    const float* p = src + (size_t)(in ? row + 8 * r : 0) * d + 2 * t;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
      const float2 x = in ? *reinterpret_cast<const float2*>(p + 8 * ks) : make_float2(0.f, 0.f);
      split(x.x, a[ks][r], a[ks][4 + r]);
      split(x.y, a[ks][2 + r], a[ks][6 + r]);
    }
  }
}

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

// s[n] = A B_n^T for the kN n8 tiles of split tile sp read along its rows
// (K in Q K^T), A's k8 steps in registers
template <int kN>
__device__ __forceinline__ void scores(float (&s)[kN][4], const uint32_t (&a)[kSteps][8], const float* sp,
                                       const Lanes& L) {
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    float c[4] = {};
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) mma3(s[n], c, a[ks], frag_b_rows(sp, L, n, ks));
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += c[e];
  }
}

// s[n] = A B_n^T and u[n] = A2 B2_n^T for kN n8 tiles (S and dP): frag_a1(a,
// ks) gives A's k8 step ks, A2 is rows a2_row .. a2_row + 15 of split tile
// a2sp, B and B2 split tiles are read along their rows
template <int kN, typename FragA1>
__device__ __forceinline__ void scores2(float (&s)[kN][4], float (&u)[kN][4], FragA1 frag_a1, const float* bsp,
                                        const float* a2sp, const float* b2sp, int a2_row, const Lanes& L) {
  float cs[kN][4] = {}, cu[kN][4] = {};
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = u[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    uint32_t a[8], a2[8];
    frag_a1(a, ks);
    frag_a(a2, a2sp, L, a2_row, ks);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      mma3(s[n], cs[n], a, frag_b_rows(bsp, L, n, ks));
      mma3(u[n], cu[n], a2, frag_b_rows(b2sp, L, n, ks));
    }
  }
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += cs[n][e], u[n][e] += cu[n][e];
}

// acc[n] += P_0 B(0, n) + P_1 B(1, n) for the 8 n8 tiles of the 64 columns:
// p0 and p1 accumulator tiles over 16 rows of split tile sp (V in P V), the
// two k8 steps' three passes summed into a zeroed accumulator (6 truncating
// sums from 0) and added to acc in fp32
__device__ __forceinline__ void mma_rows16(float (&acc)[kDh / 8][4], const float (&p0)[4], const float (&p1)[4],
                                           const float* sp, const Lanes& L) {
  uint32_t a0[8], a1[8];
  split_acc(a0, p0);
  split_acc(a1, p1);
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) {
    float d[4] = {};
    mma3(d, d, a0, frag_b_cols(sp, L, 0, n));
    mma3(d, d, a1, frag_b_cols(sp, L, 1, n));
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

// rows row and row + 8 of an accumulator over 64 columns (8 n8 tiles) to
// global memory at dst (row r at dst + r * d), rows at or past n_rows skipped
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[kDh / 8][4], int row, int n_rows, int d) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= n_rows) continue;
    float* p = dst + (size_t)(row + 8 * r) * d + 2 * t;
#pragma unroll
    for (int n = 0; n < kDh / 8; ++n)
      *reinterpret_cast<float2*>(p + 8 * n) = make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// the forward's online softmax over one part's scores s (keys key0 + 8n + 2t
// (+1) of rows row, row + 8, in log2 units after sl2): p replaces s, and m,
// l and o move to the part; kMask applies the limits lim
template <bool kMask>
__device__ __forceinline__ void softmax_part(float (&s)[kFwdPart / 8][4], float (&m)[2], float (&l)[2],
                                             float (&o)[kDh / 8][4], int key0, const int (&lim)[2], float sl2) {
  float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < kFwdPart / 8; ++n)
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
    for (int n = 0; n < kDh / 8; ++n) o[n][2 * r] *= corr, o[n][2 * r + 1] *= corr;
  }
#pragma unroll
  for (int n = 0; n < kFwdPart / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = !kMask || key0 + 8 * n + (e & 1) < lim[e >> 1];
      s[n][e] = in ? exp2_approx(s[n][e] - m[e >> 1]) : 0.f;
      sum[e >> 1] += s[n][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] += quad_sum(sum[r]);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ out, float* __restrict__ lse, Shape sh) {
  extern __shared__ __align__(16) float fsm[];
  float* kraw = fsm;
  float* vraw = kraw + kFwdN * kRawF;
  float* ksp = vraw + kFwdN * kRawF;
  float* vsp = ksp + kFwdN * kSplitF;
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + h * kDh, koff = (size_t)b * sh.tk * sh.d + h * kDh;
  const int n_tiles = key_tiles<kCausal, kFwdN>(sh, q0, q0 + kBM);

  if (n_tiles > 0) {
    load_raw<kFwdN>(kraw, k + koff, 0, sh.tk, sh.d);
    load_raw<kFwdN>(vraw, v + koff, 0, sh.tk, sh.d);
  }
  cp_commit();
  const int row = q0 + 16 * warp + threadIdx.x % 32 / 4;  // this thread's rows: row and row + 8
  uint32_t qa[kSteps][8];
  load_a(qa, q + qoff, row, sh.tq, sh.d);
  const Lanes L = lanes();
  const int lim[2] = {key_limit<kCausal>(sh, row), key_limit<kCausal>(sh, row + 8)};
  const int warp_lim = key_limit<kCausal>(sh, q0 + 16 * warp);  // the warp's first row sees the fewest keys
  const float sl2 = sh.scale * kLog2e;
  float o[kDh / 8][4] = {}, m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1's splits
    split_tile<kFwdN>(ksp, kraw);
    split_tile<kFwdN>(vsp, vraw);
    __syncthreads();  // the splits are in; the raw buffers are free
    if (kt + 1 < n_tiles) {
      load_raw<kFwdN>(kraw, k + koff, (kt + 1) * kFwdN, sh.tk, sh.d);
      load_raw<kFwdN>(vraw, v + koff, (kt + 1) * kFwdN, sh.tk, sh.d);
    }
    cp_commit();
#pragma unroll 1  // one part's registers at a time
    for (int part = 0; part < kFwdN / kFwdPart; ++part) {
      const int key0 = kt * kFwdN + part * kFwdPart;
      float s[kFwdPart / 8][4];
      scores(s, qa, ksp + part * kFwdPart * kSplitF, L);
      if (key0 + kFwdPart <= warp_lim)
        softmax_part<false>(s, m, l, o, key0 + 2 * t, lim, sl2);
      else
        softmax_part<true>(s, m, l, o, key0 + 2 * t, lim, sl2);
#pragma unroll
      for (int j = 0; j < kFwdPart / 8; j += 2)
        mma_rows16(o, s[j], s[j + 1], vsp + (part * kFwdPart + 8 * j) * kSplitF, L);
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
  store_rows(out + qoff, o, row, sh.tq, sh.d);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
              const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, Shape sh) {
  extern __shared__ __align__(16) float fsm[];
  float* kraw = fsm;
  float* vraw = kraw + kBwdN * kRawF;
  float* ksp = vraw + kBwdN * kRawF;
  float* vsp = ksp + kBwdN * kSplitF;
  float* gsp = vsp + kBwdN * kSplitF;  // dO of the CTA's rows
  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + h * kDh, koff = (size_t)b * sh.tk * sh.d + h * kDh;
  const int n_tiles = key_tiles<kCausal, kBwdN>(sh, q0, q0 + kBM);

  load_raw<kBM>(ksp, dout + qoff, q0, sh.tq, sh.d);  // raw dO rows, in ksp's room until split
  cp_commit();
  if (n_tiles > 0) {
    load_raw<kBwdN>(kraw, k + koff, 0, sh.tk, sh.d);
    load_raw<kBwdN>(vraw, v + koff, 0, sh.tk, sh.d);
  }
  cp_commit();
  const int row = q0 + 16 * warp + threadIdx.x % 32 / 4;
  uint32_t qa[kSteps][8];
  load_a(qa, q + qoff, row, sh.tq, sh.d);
  const Lanes L = lanes();
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
  split_tile<kBM>(gsp, ksp);
  float acc[kDh / 8][4] = {};
  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt - 1's splits (and the raw dO)
    split_tile<kBwdN>(ksp, kraw);
    split_tile<kBwdN>(vsp, vraw);
    __syncthreads();
    if (kt + 1 < n_tiles) {
      load_raw<kBwdN>(kraw, k + koff, (kt + 1) * kBwdN, sh.tk, sh.d);
      load_raw<kBwdN>(vraw, v + koff, (kt + 1) * kBwdN, sh.tk, sh.d);
    }
    cp_commit();

    float s[kBwdN / 8][4], dp[kBwdN / 8][4];
    scores2(s, dp, [&](uint32_t (&a)[8], int ks) {
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = qa[ks][i];
    }, ksp, gsp, vsp, 16 * warp, L);
#pragma unroll
    for (int n = 0; n < kBwdN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // s becomes dS = p (dP - delta) scale
        const int r = e >> 1;
        const bool in = kt * kBwdN + 8 * n + 2 * t + (e & 1) < lim[r];
        const float p = in ? exp2_approx(s[n][e] * sl2 - lr[r]) : 0.f;
        s[n][e] = p * (dp[n][e] - dr[r]) * sh.scale;
      }
#pragma unroll
    for (int j = 0; j < kBwdN / 8; j += 2) mma_rows16(acc, s[j], s[j + 1], ksp + 8 * j * kSplitF, L);
  }
  store_rows(dq + qoff, acc, row, sh.tq, sh.d);
}

template <bool kCausal>
__global__ void __launch_bounds__(kThreads, 2)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
               const float* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dk, float* __restrict__ dv, Shape sh) {
  extern __shared__ __align__(16) float fsm[];
  float* qraw = fsm;
  float* graw = qraw + kBwdN * kRawF;
  float* qsp = graw + kBwdN * kRawF;
  float* gsp = qsp + kBwdN * kSplitF;
  float* ksp = gsp + kBwdN * kSplitF;  // K and V of the CTA's keys
  float* vsp = ksp + kBM * kSplitF;
  float* lraw = vsp + kBM * kSplitF;   // lse and delta of the query tile as copied
  float* draw = lraw + kBwdN;
  float* ls = draw + kBwdN;  // lse in log2 units (+inf past tq: p = 0) and delta, as the products read them
  float* ds = ls + kBwdN;
  const int k0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, t = threadIdx.x % 4;
  const size_t qoff = (size_t)b * sh.tq * sh.d + h * kDh, koff = (size_t)b * sh.tk * sh.d + h * kDh;
  const int n_q = (sh.tq + kBwdN - 1) / kBwdN;
  // the first query tile that sees key k0 (none for keys past kv_len)
  const int first = k0 >= sh.kv_len ? n_q : kCausal ? max(0, k0 - sh.q_offset) / kBwdN : 0;
  const int key = k0 + 16 * warp + threadIdx.x % 32 / 4;  // this thread's keys: key and key + 8
  float acc_k[kDh / 8][4] = {}, acc_v[kDh / 8][4] = {};

  if (first < n_q) {
    load_raw<kBM>(qsp, k + koff, k0, sh.tk, sh.d);  // raw K and V rows, in qsp's and gsp's room until split
    load_raw<kBM>(gsp, v + koff, k0, sh.tk, sh.d);
    cp_commit();
    load_raw<kBwdN>(qraw, q + qoff, first * kBwdN, sh.tq, sh.d);
    load_raw<kBwdN>(graw, dout + qoff, first * kBwdN, sh.tq, sh.d);
    load_res(lraw, draw, lse, delta, sh, h, b, first * kBwdN);
    cp_commit();
    const Lanes L = lanes();
    const float sl2 = sh.scale * kLog2e;
    cp_wait<1>();
    __syncthreads();
    split_tile<kBM>(ksp, qsp);
    split_tile<kBM>(vsp, gsp);
    for (int qt = first; qt < n_q; ++qt) {
      cp_wait<0>();
      __syncthreads();  // tile qt landed; every warp is done with tile qt - 1's splits (and the raw K, V)
      split_tile<kBwdN>(qsp, qraw);
      split_tile<kBwdN>(gsp, graw);
      if (threadIdx.x < kBwdN) {
        const int i = threadIdx.x;
        ls[i] = qt * kBwdN + i < sh.tq ? lraw[i] * kLog2e : INFINITY;
        ds[i] = draw[i];
      }
      __syncthreads();
      if (qt + 1 < n_q) {
        load_raw<kBwdN>(qraw, q + qoff, (qt + 1) * kBwdN, sh.tq, sh.d);
        load_raw<kBwdN>(graw, dout + qoff, (qt + 1) * kBwdN, sh.tq, sh.d);
        load_res(lraw, draw, lse, delta, sh, h, b, (qt + 1) * kBwdN);
      }
      cp_commit();
#pragma unroll 1  // one part's registers at a time
      for (int part = 0; part < kBwdN / kDkvPart; ++part) {
        const int c0 = part * kDkvPart;  // the part's first query in the tile
        float st[kDkvPart / 8][4], dpt[kDkvPart / 8][4];
        scores2(st, dpt, [&](uint32_t (&a)[8], int ks) { frag_a(a, ksp, L, 16 * warp, ks); }, qsp + c0 * kSplitF,
                vsp, gsp + c0 * kSplitF, 16 * warp, L);
#pragma unroll
        for (int n = 0; n < kDkvPart / 8; ++n) {  // st becomes p^T, dpt dS^T; rows are keys, columns queries
          const int c = c0 + 8 * n + 2 * t, qr = qt * kBwdN + c;
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
          mma_rows16(acc_v, st[j], st[j + 1], gsp + (c0 + 8 * j) * kSplitF, L);
          mma_rows16(acc_k, dpt[j], dpt[j + 1], qsp + (c0 + 8 * j) * kSplitF, L);
        }
      }
    }
  }
  store_rows(dk + koff, acc_k, key, sh.tk, sh.d);
  store_rows(dv + koff, acc_v, key, sh.tk, sh.d);
}

// the rate of mma.sync m16n8k8 tf32 on the card, which these kernels run
// on: `iters` rounds of 8 independent products a warp, 8 warps a CTA; every
// thread writes its sum, so that no product is dead
__global__ void __launch_bounds__(256) mma_probe_kernel(float* __restrict__ out, int iters) {
  const uint32_t a = __float_as_uint(1.f + threadIdx.x * 0x1p-8f) & 0xffffe000u, b = __float_as_uint(0.5f);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < 8; ++c) mma_tf32(d[c], a, a, a, a, b, b);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 8; ++c) sum += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = sum;
}

template <bool kCausal>
int run_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, cudaStream_t stream) {
  static bool lifted[64] = {};
  const cudaError_t err = sm90::lift_smem(fwd_kernel<kCausal>, kFwdSmem, lifted);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sh.tq + kBM - 1) / kBM, sh.n_head, sh.batch);
  fwd_kernel<kCausal><<<grid, kThreads, kFwdSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), sh);
  return (int)cudaGetLastError();
}

template <bool kCausal>
int run_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
            void* dq, void* dk, void* dv, const Shape& sh, cudaStream_t stream) {
  static bool lifted_dq[64] = {}, lifted_dkv[64] = {};
  cudaError_t err = sm90::lift_smem(bwd_dq_kernel<kCausal>, kDqSmem, lifted_dq);
  if (err == cudaSuccess) err = sm90::lift_smem(bwd_dkv_kernel<kCausal>, kDkvSmem, lifted_dkv);
  if (err != cudaSuccess) return (int)err;
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v), *gf = static_cast<const float*>(dout),
              *lf = static_cast<const float*>(lse), *df = static_cast<const float*>(delta);
  bwd_dq_kernel<kCausal><<<dim3((sh.tq + kBM - 1) / kBM, sh.n_head, sh.batch), kThreads, kDqSmem, stream>>>(
      qf, kf, vf, gf, lf, df, static_cast<float*>(dq), sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkv_kernel<kCausal><<<dim3((sh.tk + kBM - 1) / kBM, sh.n_head, sh.batch), kThreads, kDkvSmem, stream>>>(
      qf, kf, vf, gf, lf, df, static_cast<float*>(dk), static_cast<float*>(dv), sh);
  return (int)cudaGetLastError();
}

// rows are read by 16-byte copies and written 8 bytes at a time
bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}

int launch_fwd(const void* q, const void* k, const void* v, void* out, void* lse, const Shape& sh, bool causal,
               void* stream) {
  if (bad_shape(sh, kDh) || (lse != nullptr && sh.n_head % sh.hpb)) return (int)cudaErrorInvalidValue;
  if (misaligned({q, k, v, out})) return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  return causal ? run_fwd<true>(q, k, v, out, lse, sh, s) : run_fwd<false>(q, k, v, out, lse, sh, s);
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
               void* dq, void* dk, void* dv, const Shape& sh, bool causal, void* stream) {
  if (bad_shape(sh, kDh) || sh.n_head % sh.hpb) return (int)cudaErrorInvalidValue;
  if (misaligned({q, k, v, dout, dq, dk, dv})) return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  return causal ? run_bwd<true>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s)
                : run_bwd<false>(q, k, v, dout, lse, delta, dq, dk, dv, sh, s);
}

}  // namespace f32

}  // namespace

// K5: natural (B, T, D) layout, non-causal, head width d / n_head any
// multiple of 8 up to 768 (32, 64 and 128 on the sm90 forward); no logsumexp
extern "C" int flash_mh_fwd_bf16(const void* q, const void* k, const void* v, void* out, int batch, int tq, int tk,
                                 int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  if (dh == 32 || dh == 64 || dh == 128) {
    Shape sh{batch, tq, tk, d, n_head, 1, kv_len, 0, scale};
    return launch_fwd_sm90(q, k, v, out, nullptr, sh, dh, false, stream);
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

// K3: natural (B, T, D) layout, non-causal, head width d / n_head 32, 64 or
// 128; `lse` may be null, else it is (D/128, B, Tq, 128 / dh) fp32
extern "C" int flash_h2_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                 int tq, int tk, int d, int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, n_head, h2_hpb(dh), kv_len, 0, scale};
  if (lse != nullptr && (sh.hpb < 1 || n_head % sh.hpb)) return (int)cudaErrorInvalidValue;
  return launch_fwd_sm90(q, k, v, out, lse, sh, dh, false, stream);
}

// K6: (dq, dk, dv) of K3 from lse and delta, both (D/128, B, Tq, 128 / dh) fp32
extern "C" int flash_h2_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                 const void* delta, void* dq, void* dk, void* dv, int batch, int tq, int tk, int d,
                                 int n_head, int kv_len, float scale, void* stream) {
  if (n_head < 1 || d % n_head) return (int)cudaErrorInvalidValue;
  const int dh = d / n_head;
  Shape sh{batch, tq, tk, d, n_head, h2_hpb(dh), kv_len, 0, scale};
  return launch_h2_bwd_sm90(q, k, v, dout, lse, delta, dq, dk, dv, sh, dh, stream);
}

// K7: head-split (BH, T, dh), dh 32, 64 or 128; `lse` may be null, else it
// is (BH, Tq, 1) fp32
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq,
                              int tk, int dh, int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, 1, 1, kv_len, q_offset, scale};
  return launch_fwd_sm90(q, k, v, out, lse, sh, dh, causal != 0, stream);
}

// K8: (dq, dk, dv) of K7 from lse and delta, both (BH, Tq, 1) fp32
extern "C" int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                              const void* delta, void* dq, void* dk, void* dv, int bh, int tq, int tk, int dh,
                              int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, 1, 1, kv_len, q_offset, scale};
  return causal ? launch_bwd_sm90<true>(q, k, v, dout, lse, delta, dq, dk, dv, sh, dh, stream)
                : launch_bwd_sm90<false>(q, k, v, dout, lse, delta, dq, dk, dv, sh, dh, stream);
}

// ------------------------------------------------------ fp32 entry points
// The same arguments and layouts as the bf16 entries above, fp32 tensors
// on 16-byte boundaries (rows are copied 16 bytes at a time), at a head
// width of 64 only (f32::kDh): namespace f32's 3xTF32 kernels.

// K3 at fp32; `lse` may be null, else it is (D/128, B, Tq, 2) fp32
extern "C" int flash_h2_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int batch,
                                int tq, int tk, int d, int n_head, int kv_len, float scale, void* stream) {
  Shape sh{batch, tq, tk, d, n_head, 128 / f32::kDh, kv_len, 0, scale};
  return f32::launch_fwd(q, k, v, out, lse, sh, false, stream);
}

// K5 at fp32, a head width of 64 only (d = 64 * n_head); no logsumexp
extern "C" int flash_mh_fwd_f32(const void* q, const void* k, const void* v, void* out, int batch, int tq, int tk,
                                int d, int n_head, int kv_len, float scale, void* stream) {
  Shape sh{batch, tq, tk, d, n_head, 1, kv_len, 0, scale};
  return f32::launch_fwd(q, k, v, out, nullptr, sh, false, stream);
}

// K6 at fp32: (dq, dk, dv) of K3 from lse and delta, both (D/128, B, Tq, 2) fp32
extern "C" int flash_h2_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                                const void* delta, void* dq, void* dk, void* dv, int batch, int tq, int tk, int d,
                                int n_head, int kv_len, float scale, void* stream) {
  Shape sh{batch, tq, tk, d, n_head, 128 / f32::kDh, kv_len, 0, scale};
  return f32::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, sh, false, stream);
}

// K7 at fp32: head-split (BH, T, 64); `lse` may be null, else it is (BH, Tq, 1) fp32
extern "C" int flash_fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int tq,
                             int tk, int dh, int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, 1, 1, kv_len, q_offset, scale};
  return f32::launch_fwd(q, k, v, out, lse, sh, causal != 0, stream);
}

// K8 at fp32: (dq, dk, dv) of K7 from lse and delta, both (BH, Tq, 1) fp32
extern "C" int flash_bwd_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv, int bh, int tq, int tk, int dh,
                             int kv_len, int causal, int q_offset, float scale, void* stream) {
  Shape sh{bh, tq, tk, dh, 1, 1, kv_len, q_offset, scale};
  return f32::launch_bwd(q, k, v, dout, lse, delta, dq, dk, dv, sh, causal != 0, stream);
}

// the mma.sync tf32 rate probe: `ctas` CTAs of 256 threads, out holds ctas * 256 floats
extern "C" int tf32_mma_probe(void* out, int ctas, int iters, void* stream) {
  if (ctas < 1 || iters < 1) return (int)cudaErrorInvalidValue;
  f32::mma_probe_kernel<<<ctas, 256, 0, (cudaStream_t)stream>>>(static_cast<float*>(out), iters);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

