// K1 and K2: single-token decode attention over a layer of the stacked
// (L, B, Tk, D) KV caches, for Hopper (sm_90a), at every head width dh = D /
// n_head from 1 to 768, with bf16, fp16 or fp32 q. Both kernels are built
// for the width classes 32, 64, 128, 256, 512 and 768 (a template
// parameter, as is q's type); a width dh runs in the smallest class kDh >=
// dh (`decode_class`). A CTA reads only a head's dh real columns from device
// memory (the bytes stay dh's: both kernels are bound by them) and fills
// columns [dh, kDh) of its staged rows and of q with zeros, which add
// nothing to q.k; the output columns they give are never written. Head h
// starts at byte h dh sizeof(T) of a cache row, so a row is copied in the
// largest pieces of 16, 8, 4, 2 or 1 bytes that divide its dh sizeof(T)
// bytes (`piece_bytes`): 16-byte cp.async wherever dh sizeof(T) is a
// multiple of 16 (every preset's head; a template flag, `kPiece16`, so that
// this copy is the plain loop it was before the narrower pieces came), down
// to single bytes for an int8 row of odd dh (dh 75); pieces of 2 and 1
// bytes, which cp.async does not take, are a load and a store. The caches
// are read in place, never padded. The compute is the class's: 80 columns
// run at 128's tensor-core work, 136 at 256's, 300 at 512's. From the
// class of 256 on the staged tiles are wide, so fewer are in flight and,
// above 256, each holds fewer keys (`K2Cfg`, `K1Cfg`); the products hold at
// most 256 columns of q and of the P.V sums in registers at a time (K2's
// `kPass`; K1 reads q's fragments from shared memory above 256), and K2's
// fp32 scores keep q in registers 128 columns at a time.
//
// K2 `decode_attn_*` replaces `_decode_attn_kernel`
// (asr_ttl_mtl_tpu/ops/decode_attention.py:39, entry `decode_attention` :94):
// bf16, fp16 or fp32 caches, per-head fp32 scores, a full softmax, p / l
// cast to the cache dtype, then p.V with fp32 accumulation. Keys past
// `valid_upto` are masked (-1 = all valid). `group` query rows share one
// cache row.
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
// cache element and query row, far below the card's ~295 FLOPs per byte.
// The design goal is to read each cache byte once, in whole 32-byte
// sectors, with enough bytes in flight to keep HBM busy even when the step
// has few (cache row, head) pairs: one window of the CLI is 8 of them.
//
// Design, K2: one thread-block cluster of S CTAs per (cache row, head).
//   - The valid keys [0, n_valid) (n_valid = valid_upto + 1, or tk) are cut
//     into S contiguous chunks of ceil(n_valid / S); a CTA reads only its
//     own chunk, so masked keys are never read (exp(-1e30 - m) is exactly 0
//     in fp32: skipping them changes nothing). S is in {1, 2, 4, 8} (8 is
//     the portable cluster limit), chosen by the host (`k2_plan` in
//     ops/decode_attention.py): the largest S that keeps the grid within
//     the 2 x 132 CTAs the card holds at once, but no larger than leaves 64
//     keys a CTA, raised further only when a chunk's scores would not fit
//     in shared memory. One window of the CLI (8 heads) takes S = 8; 32
//     windows already fill the card with S = 1, where a second wave of
//     CTAs measured slower on an H100 (0.0546 against 0.0621 ms).
//   - A CTA streams its chunk's K rows, then its V rows, in tiles of 128
//     keys (above 256: 32 bf16 rows, 16 fp32) through a ring of
//     shared-memory buffers filled by cp.async (4 tiles in flight for bf16,
//     2 for fp32), so the V loads are already in flight while the softmax
//     runs. Above the class of 256 a CTA takes at most 16 of the group's
//     query rows (`k2_cta_rows`): each row's q and P.V partials are 3 KB at
//     768, so a larger group takes one CTA a 16-row chunk, each reading the
//     cache, still in one launch.
//   - Products. bf16 and fp16 caches: both on the tensor cores, mma.sync
//     m16n8k16 of the cache's type (fp16 the bf16 code's twin: the same
//     tiles, fragments and shared memory, as both are 2 bytes)
//     (dh / 16 steps for the scores; P.V's dh / 8 column blocks round the
//     4 warps) with the group's rows padded to 16 (rows beyond 16 in
//     further passes over the tile already staged) and fp32 accumulation;
//     the ring holds 4 tiles of 128 keys, 2 at 128 and 256; a bf16 x bf16
//     product is exact in fp32, as in the plain version's fp32 einsum. On
//     the CUDA cores the FMAs of a group of 5 to 16 rows took longer than
//     the bytes (group 16 over 32 windows took 0.21-0.32 ms on an H100).
//     fp32 caches (the fp16=False option): the CUDA cores, a thread per
//     (row, key) with the row's dh q values in registers (128 of them at
//     dh 128; at 256 the row in two halves, the second's sums added to the
//     first's score) and four FMA chains, and for P.V 8 threads a row, each over
//     dh / 8 columns (the 16-byte chunks c, c + 8, ... of the row, so that
//     a row's 8 threads read 128 contiguous bytes at a time) and a slice
//     of the keys; exact fp32 throughout, which tf32 mma would not be.
//   - Softmax across the cluster, through distributed shared memory: each
//     CTA's row maxima -> cluster barrier -> every CTA reads its peers' and
//     takes the global max m; p = exp(s - m) and its partial row sums ->
//     cluster barrier -> the global l, summed over the ranks in order; then
//     p / l rounded to the cache dtype, exactly as the plain version does.
//   - P.V partials go to shared memory and are summed over the cluster's
//     ranks in order through distributed shared memory; each output is
//     written once. No global scratch and no atomics: the result is the
//     same from run to run.
//   - Every group is one launch, and each cache byte is read from device
//     memory once per call whatever the group.
// Design, K1: one thread-block cluster of S CTAs per (cache row, head, 16
// query rows), so a group of up to 16 rows (the beam's 5) reads each cache
// byte from device memory once a call.
//   - The keys are walked in whole blocks of tk_blk (the contract): the nb
//     blocks that hold a valid key are cut into S chunks of whole blocks
//     (CTA r takes blocks [r nb / S, (r + 1) nb / S)); blocks wholly past
//     valid_upto, and keys past it, are never read. S (1-8) comes from the
//     host (`k1_plan` in ops/decode_attention.py): enough CTAs to fill the
//     card's resident slots, at most one block a CTA.
//   - Each CTA walks its blocks in order from its own running max, with the
//     plain version's arithmetic: q quantized per (row, head); s = s32 x q
//     step x scale x k scale; per block m = max(m, block max), p = exp(s -
//     m), sp = max(p v_scale) / 127, p_int8 = rint(p v_scale / sp), acc =
//     acc x exp(m_old - m) + (P_int8 V_int8) sp. p v_scale / sp does not
//     depend on the running max beyond an fp32 rounding, so the int8 p of a
//     block is the sequential walk's up to the flips the plain version's
//     flip bound covers.
//   - Per block, its K tiles (128 keys, 32 above 256, with their k and v
//     scales), then its V tiles, stream through a cp.async ring (4 deep, 2
//     from 256), so the V loads are in flight during the block's softmax.
//     The tile is only the staging unit: the block, over which p is
//     quantized, and its order stay the contract's at every width.
//   - Both products on the tensor cores, mma.sync m16n8k32 s8 with int32
//     accumulation (exact, as the plain version's float64 sums): the rows
//     padded to 16; K rows are the B operand as they lie. For P V each V
//     tile is transposed in shared memory (byte permutes, 4 keys x 4
//     columns a thread) so that four keys of a column form one word of B.
//     The output's dh / 8 column blocks go round the 8 warps (`K1Cfg`): one
//     a warp at dh 64, two at dh 128, four at 256, and at dh 32 two warps to a block,
//     each over alternate 32-key steps, their exact int32 sums added once a
//     key block.
//   - The softmax of a row is one warp's: block max, sum, p max and the p
//     quantization by warp shuffles, with no block-wide barrier between.
//   - The CTAs' partials (m, l, acc) meet through distributed shared memory
//     and are combined in rank order: out = sum acc e^(m - M) / sum l
//     e^(m - M), each output written once. No atomics and no global
//     scratch: the same bits on every run; with S = 1, e^0 = 1 and the
//     result is the sequential walk's.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxBlock = 1024;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// ---------------------------------------------------------------- K2 ------

constexpr int kK2Threads = 128;  // 4 warps
constexpr int kK2Warps = kK2Threads / 32;
constexpr int kK2Tile = 128;     // keys a staged tile holds
constexpr int kK2MaxSplit = 8;   // CTAs a cluster: the portable limit
constexpr int kK2RowChunk = 16;  // query rows a pass of the threads takes
constexpr size_t kSmemLimit = 227 * 1024;

// kDh: the width class, 32, 64, 128, 256, 512 or 768 (a head width dh <=
// kDh runs in it)
template <typename T, int kDh>
struct K2Cfg {
  static constexpr int kVec = 16 / (int)sizeof(T);                         // elements a 16-byte copy moves
  static constexpr int kRowBytes = kDh * (int)sizeof(T) + 16;             // a staged key row, padded off the banks
  // keys a staged tile holds: kK2Tile, but 64 of fp32 rows at 256 (1 KB a
  // row), and above 256 32 of bf16 rows and 16 of fp32 (1-3 KB a row)
  static constexpr int kTile = kDh > 256 ? (sizeof(T) == 2 ? 32 : 16) : sizeof(T) == 4 && kDh == 256 ? 64 : kK2Tile;
  // tiles in flight: ~70 KB of bf16 rows at 32-128 (2 tiles at 128), 2 of
  // fp32, 2 of ~67 KB at 256 in either dtype, and 2 of 33-50 KB above
  static constexpr int kRing = sizeof(T) == 2 ? (kDh >= 128 ? 2 : 4) : 2;
  static constexpr int kRingBytes = kRing * kTile * kRowBytes;
  // the q values a thread of the fp32 scores keeps in registers: the whole
  // row up to 128, else 128 at a time
  static constexpr int kQRegs = kDh < 128 ? kDh : 128;
  // the columns a pass of the tensor-core products (and of the fp32 P.V)
  // holds in registers: the whole row up to 256, else 256 at a time
  static constexpr int kPass = kDh < 256 ? kDh : 256;
};

// query rows a CTA takes: the whole group up to the class of 256; above it,
// 16 a CTA once the group is larger (q and the P.V partials, 3 KB a row
// each at 768, would outgrow shared memory beside the staged tiles), the
// CTAs of a cache row's row chunks each reading the cache
__host__ __device__ __forceinline__ int k2_cta_rows(int group, int dh_class) {
  return dh_class > 256 && group > kK2RowChunk ? kK2RowChunk : group;
}
__host__ __device__ __forceinline__ int k2_rows(int group) { return group < kK2RowChunk ? group : kK2RowChunk; }
// P.V: 8 threads take a row; the threads left over take slices of the keys
__host__ __device__ __forceinline__ int k2_slices(int group) { return kK2Threads / (8 * k2_rows(group)); }
__host__ __device__ __forceinline__ int k2_stride(int chunk) { return (chunk + 3) & ~3; }

// ring, q (G x dh fp32), scores (G x chunk fp32), P.V partials (slices x G
// x dh fp32), row max / sum, local and global (4 x G fp32), and one fp32 a
// thread for the row reductions, G the CTA's rows (`k2_cta_rows`)
template <typename T, int kDh>
size_t k2_smem_bytes(int group_all, int chunk) {
  const int group = k2_cta_rows(group_all, kDh);
  return (size_t)K2Cfg<T, kDh>::kRingBytes +
         4 * ((size_t)group * kDh + (size_t)group * k2_stride(chunk) + (size_t)k2_slices(group) * group * kDh +
              4 * (size_t)group + kK2Threads);
}

// m16n8k16 products of T (bf16 or fp16) on the tensor cores, fp32
// accumulate (products of either are exact in fp32, as in the plain
// version's fp32 einsum)
#define DECODE_MMA16(TY)                                                                                     \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY                                            \
               ".f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"                      \
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])                                              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <typename T>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __half>::value)
    DECODE_MMA16("f16");
  else
    DECODE_MMA16("bf16");
}
#undef DECODE_MMA16
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
// two floats rounded to T (bf16 or fp16) as one word of an mma fragment
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 x = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  } else {
    const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&x);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the bytes a copy of a head's row moves: the largest of 16, 8, 4, 2 and 1
// that divides the row's bytes. Head h starts at byte h x row_bytes of a
// cache row (and rows are d = n_head x dh elements apart), so every piece
// of every head lies on a multiple of it.
__host__ __device__ __forceinline__ int piece_bytes(int row_bytes) {
  return row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : row_bytes % 4 == 0 ? 4 : row_bytes % 2 == 0 ? 2 : 1;
}
// pieces of 2 or 1 bytes, which cp.async does not take: a load and a
// store each, kBatch loads a thread issued before their stores so that
// their latencies overlap; done before the barrier that precedes any read
// of the slot
template <typename P>
__device__ __forceinline__ void copy_narrow(unsigned char* dst, int dst_stride, const unsigned char* src,
                                            size_t src_stride, int n_rows, int per_row) {
  constexpr int kBatch = 8;
  const int n = n_rows * per_row, step = blockDim.x;
  for (int e0 = threadIdx.x; e0 < n; e0 += kBatch * step) {
    P v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * step;
      if (e < n)
        v[u] = *reinterpret_cast<const P*>(src + (size_t)(e / per_row) * src_stride + (e % per_row) * sizeof(P));
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * step;
      if (e < n) *reinterpret_cast<P*>(dst + (e / per_row) * dst_stride + (e % per_row) * sizeof(P)) = v[u];
    }
  }
}
// `n_rows` rows of `row_bytes` bytes, `src_stride` bytes apart in device
// memory, into shared rows `dst_stride` bytes apart, in pieces of
// `piece_bytes(row_bytes)`: 16, 8 and 4 by cp.async (the ring's commit
// groups wait for them), 2 and 1 by `copy_narrow`
__device__ __forceinline__ void copy_rows(unsigned char* dst, int dst_stride, const unsigned char* src,
                                          size_t src_stride, int n_rows, int row_bytes) {
  const int piece = piece_bytes(row_bytes), per_row = row_bytes / piece;
  if (piece == 2) return copy_narrow<uint16_t>(dst, dst_stride, src, src_stride, n_rows, per_row);
  if (piece == 1) return copy_narrow<uint8_t>(dst, dst_stride, src, src_stride, n_rows, per_row);
  for (int e = threadIdx.x; e < n_rows * per_row; e += blockDim.x) {
    unsigned char* d = dst + (e / per_row) * dst_stride + (e % per_row) * piece;
    const unsigned char* g = src + (size_t)(e / per_row) * src_stride + (e % per_row) * piece;
    if (piece == 16)
      cp_async16(d, g);
    else if (piece == 8)
      cp_async8(d, g);
    else
      cp_async4(d, g);
  }
}
// copy_rows for rows whose bytes are a multiple of 16 (`kPiece16`): 16-byte
// cp.async alone, `per_row` pieces a row, by kThreads threads
template <int kThreads>
__device__ __forceinline__ void copy_rows16(unsigned char* dst, int dst_stride, const unsigned char* src,
                                            size_t src_stride, int n_rows, int per_row) {
  for (int e = threadIdx.x; e < n_rows * per_row; e += kThreads)
    cp_async16(dst + (e / per_row) * dst_stride + (e % per_row) * 16,
               src + (size_t)(e / per_row) * src_stride + (e % per_row) * 16);
}
// zeros in bytes [row_bytes, class_bytes) of `n_rows` staged rows `stride`
// bytes apart (16-byte aligned): bytewise up to the next 16-byte boundary,
// then 16 bytes at a time; no copy writes them
__device__ __forceinline__ void zero_tail(unsigned char* base, int n_rows, int stride, int row_bytes,
                                          int class_bytes) {
  const int z0 = (row_bytes + 15) & ~15, lead = z0 - row_bytes, per = lead + (class_bytes - z0) / 16;
  for (int e = threadIdx.x; e < n_rows * per; e += blockDim.x) {
    unsigned char* r = base + (size_t)(e / per) * stride;
    const int c = e % per;
    if (c < lead)
      r[row_bytes + c] = 0;
    else
      *reinterpret_cast<uint4*>(r + z0 + 16 * (c - lead)) = make_uint4(0, 0, 0, 0);
  }
}

// ---- the products of one staged tile (128 keys; rows of kRowBytes)

// bf16 or fp16 (T): scores of rows g0 .. g0 + 15 (zero past G) against 8
// keys an mma (dh / 16 steps); warp w takes the key blocks w, w + kK2Warps,
// ...; thread (g8, t4) holds rows g0 + g8 and g0 + g8 + 8, keys 2 t4 and 2
// t4 + 1 of a block
template <typename T, int kDh>
__device__ __forceinline__ void scores_mma(float* sc, int cs, const float* qs, const unsigned char* tile, int nk,
                                           int j0, int G, float scale) {
  constexpr int kRow = K2Cfg<T, kDh>::kRowBytes, kPass = K2Cfg<T, kDh>::kPass;
  const int warp = threadIdx.x / 32, g8 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  for (int g0 = 0; g0 < G; g0 += 16) {
    const int r0 = g0 + g8, r1 = r0 + 8;
    // the columns kPass at a time (once up to 256): a pass's scores add to
    // the passes before it, which this thread wrote
    for (int p0 = 0; p0 < kDh; p0 += kPass) {
      uint32_t qa[kPass / 16][4];
#pragma unroll
      for (int ks = 0; ks < kPass / 16; ++ks) {
        const int c = p0 + 16 * ks + 2 * t4;
        const float2 zero = make_float2(0.f, 0.f);
        const float2 x00 = r0 < G ? *reinterpret_cast<const float2*>(qs + r0 * kDh + c) : zero;
        const float2 x10 = r1 < G ? *reinterpret_cast<const float2*>(qs + r1 * kDh + c) : zero;
        const float2 x01 = r0 < G ? *reinterpret_cast<const float2*>(qs + r0 * kDh + c + 8) : zero;
        const float2 x11 = r1 < G ? *reinterpret_cast<const float2*>(qs + r1 * kDh + c + 8) : zero;
        qa[ks][0] = pack2<T>(x00.x, x00.y);  // exact: q holds values of T
        qa[ks][1] = pack2<T>(x10.x, x10.y);
        qa[ks][2] = pack2<T>(x01.x, x01.y);
        qa[ks][3] = pack2<T>(x11.x, x11.y);
      }
      for (int kb = 8 * warp; kb < nk; kb += 8 * kK2Warps) {
        float dacc[4] = {0.f, 0.f, 0.f, 0.f};
        const unsigned char* kr = tile + (kb + g8) * kRow + 2 * p0 + 4 * t4;
#pragma unroll
        for (int ks = 0; ks < kPass / 16; ++ks)
          mma16<T>(dacc, qa[ks], *reinterpret_cast<const uint32_t*>(kr + 32 * ks),
                   *reinterpret_cast<const uint32_t*>(kr + 32 * ks + 16));
        const int kl = kb + 2 * t4, j = j0 + kl;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (kl + e >= nk) continue;
          if (r0 < G) sc[r0 * cs + j + e] = p0 == 0 ? dacc[e] * scale : sc[r0 * cs + j + e] + dacc[e] * scale;
          if (r1 < G) sc[r1 * cs + j + e] = p0 == 0 ? dacc[2 + e] * scale : sc[r1 * cs + j + e] + dacc[2 + e] * scale;
        }
      }
    }
  }
}

// fp32 (and any type): thread (row tid % RC of a pass, slot tid / RC) takes
// keys slot, slot + n_slots, ... with its row's dh q values in registers
template <typename T, int kDh>
__device__ __forceinline__ void scores_fma(float* sc, int cs, const float* qs, const unsigned char* tile, int nk,
                                           int j0, int G, float scale) {
  using C = K2Cfg<T, kDh>;
  constexpr int kQ = C::kQRegs;
  const int RC = k2_rows(G), slot = threadIdx.x / RC, n_slots = kK2Threads / RC;
  for (int g0 = 0; g0 < G; g0 += RC) {
    const int gg = g0 + threadIdx.x % RC;
    if (slot >= n_slots || gg >= G) continue;
    // the row's columns kQ at a time (once up to 128): a part's score adds
    // to the parts before it, which this thread wrote
    for (int q0 = 0; q0 < kDh; q0 += kQ) {
      float qr[kQ];
#pragma unroll
      for (int c = 0; c < kQ; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(qs + gg * kDh + q0 + c);
        qr[c] = x.x, qr[c + 1] = x.y, qr[c + 2] = x.z, qr[c + 3] = x.w;
      }
      for (int j = slot; j < nk; j += n_slots) {
        const unsigned char* kr = tile + j * C::kRowBytes + q0 * sizeof(T);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains keep the FMA pipe busy
#pragma unroll
        for (int c0 = 0; c0 < kQ; c0 += C::kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(kr + c0 * sizeof(T));
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int c = 0; c < C::kVec; ++c) acc[c % 4] = fmaf(qr[c0 + c], to_f(e[c]), acc[c % 4]);
        }
        const float s = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * scale;
        float* dst = sc + gg * cs + j0 + j;
        *dst = q0 == 0 ? s : *dst + s;
      }
    }
  }
}

// bf16 or fp16 (T): out rows g0 .. g0 + 15 += P (16 rows x 16 keys an mma)
// V (16 keys x 8 columns), into part (G x dh); warp w owns the 8-column
// blocks w, w + kK2Warps, ... (dh / 32 of them), and ldmatrix.trans turns the key-major V
// rows into B fragments. V rows past nk are zero (the loader writes them), p
// is 0 there.
template <typename T, int kDh>
__device__ __forceinline__ void pv_mma(float* part, const float* sc, int cs, const unsigned char* tile, int nk,
                                       int j0, int G) {
  constexpr int kRow = K2Cfg<T, kDh>::kRowBytes, kPass = K2Cfg<T, kDh>::kPass;
  constexpr int kBlocks = kPass / 8 / kK2Warps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
  // lanes 0-7 address keys 0-7 of a 16-key step, lanes 8-15 keys 8-15
  // (the columns kPass at a time: once up to 256)
  for (int p0 = 0; p0 < kDh; p0 += kPass)
  for (int g0 = 0; g0 < G; g0 += 16) {
    const unsigned char* vrow = tile + (lane % 16) * kRow + 2 * p0 + 16 * warp;
    const int r0 = g0 + g8, r1 = r0 + 8;
    float acc[kBlocks][4] = {};
    for (int k16 = 0; k16 < nk; k16 += 16) {
      uint32_t pa[4];
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8) {  // keys k16 + 2 t4 (+1), then 8 further
        const int kl = k16 + 8 * h8 + 2 * t4, j = j0 + kl;
        const float p00 = r0 < G && kl < nk ? sc[r0 * cs + j] : 0.f;
        const float p01 = r0 < G && kl + 1 < nk ? sc[r0 * cs + j + 1] : 0.f;
        const float p10 = r1 < G && kl < nk ? sc[r1 * cs + j] : 0.f;
        const float p11 = r1 < G && kl + 1 < nk ? sc[r1 * cs + j + 1] : 0.f;
        pa[2 * h8] = pack2<T>(p00, p01);  // exact: p / l was rounded to T
        pa[2 * h8 + 1] = pack2<T>(p10, p11);
      }
#pragma unroll
      for (int n = 0; n < kBlocks; ++n) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vrow + k16 * kRow + 16 * kK2Warps * n);
        mma16<T>(acc[n], pa, vb[0], vb[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlocks; ++n) {
      const int c = p0 + 8 * (warp + kK2Warps * n) + 2 * t4;
      if (r0 < G) part[r0 * kDh + c] += acc[n][0], part[r0 * kDh + c + 1] += acc[n][1];
      if (r1 < G) part[r1 * kDh + c] += acc[n][2], part[r1 * kDh + c + 1] += acc[n][3];
    }
  }
}

// fp32 (and any type): thread (chunk column cc, row rr of a pass, key
// slice ks), 8 threads a row, each over the row's 16-byte chunks cc, cc +
// 8, ... (kDh / 8 columns); each key slice sums into its own part[ks]
// (slices x G x kDh)
template <typename T, int kDh>
__device__ __forceinline__ void pv_fma(float* part, const float* sc, int cs, const unsigned char* tile, int nk,
                                       int j0, int G) {
  using C = K2Cfg<T, kDh>;
  constexpr int kChunks = C::kPass / C::kVec / 8;  // 16-byte chunks a thread a pass
  static_assert(C::kPass % (8 * C::kVec) == 0, "whole chunks a thread");
  const int RC = k2_rows(G), KS = k2_slices(G);
  const int cc = threadIdx.x % 8, rr = (threadIdx.x / 8) % RC, ks = threadIdx.x / (8 * RC);
  if (ks >= KS) return;
  for (int p0 = 0; p0 < kDh; p0 += C::kPass)  // the columns kPass at a time: once up to 256
  for (int g0 = 0; g0 < G; g0 += RC) {
    const int gg = g0 + rr;
    if (gg >= G) continue;
    const float* prow = sc + gg * cs + j0;
    float acc[kChunks][C::kVec] = {};
    for (int j = ks; j < nk; j += KS) {
      const float p = prow[j];
      const unsigned char* vr = tile + j * C::kRowBytes + p0 * sizeof(T) + cc * 16;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const uint4 raw = *reinterpret_cast<const uint4*>(vr + i * 128);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < C::kVec; ++c) acc[i][c] = fmaf(p, to_f(e[c]), acc[i][c]);
      }
    }
    float* dst = part + ((size_t)ks * G + gg) * kDh;
#pragma unroll
    for (int i = 0; i < kChunks; ++i)
#pragma unroll
      for (int c = 0; c < C::kVec; ++c) dst[p0 + (cc + 8 * i) * C::kVec + c] += acc[i][c];
  }
}

// grid (S, n_head, batch x row chunks), cluster (S, 1, 1): block x is the
// rank in the cluster, and takes keys [x * chunk, (x + 1) * chunk) of [0,
// n_valid) for the query rows of its row chunk (`k2_cta_rows`); kPiece16:
// a head's row is a whole number of 16-byte pieces (`copy_rows16`)
template <typename T, int kDh, bool kPiece16>
__global__ void __launch_bounds__(kK2Threads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ cache_k, const T* __restrict__ cache_v,
                   T* __restrict__ out, int layer, int batch, int group, int tk, int d, int dh, int n_valid,
                   int chunk, float scale) {
  using C = K2Cfg<T, kDh>;
  constexpr bool kMma = sizeof(T) == 2;  // bf16 and fp16 caches: both products on the tensor cores
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int rpc = k2_cta_rows(group, kDh), n_rc = (group + rpc - 1) / rpc;
  const int h = blockIdx.y, b = blockIdx.z / n_rc, g_lo = (blockIdx.z % n_rc) * rpc, tid = threadIdx.x;
  const int G = min(rpc, group - g_lo), cs = k2_stride(chunk), RC = k2_rows(G), KS = k2_slices(G);

  unsigned char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + C::kRingBytes);
  float* sc = qs + G * kDh;
  float* part = sc + G * cs;
  float* mloc = part + KS * G * kDh;
  float* lloc = mloc + G;
  float* mg = lloc + G;
  float* lg = mg + G;
  float* red = lg + G;

  const int k_lo = min(n_valid, rank * chunk), n_c = min(n_valid, k_lo + chunk) - k_lo;
  const int n_tiles = (n_c + C::kTile - 1) / C::kTile;
  const size_t row = (size_t)layer * batch + b;
  const T* kb = cache_k + (row * tk + k_lo) * d + (size_t)h * dh;
  const T* vb = cache_v + (row * tk + k_lo) * d + (size_t)h * dh;
  const int row_bytes = dh * (int)sizeof(T);

  // the loads in order: K tiles 0 .. n_tiles-1, then V tiles; item i goes
  // to ring slot i % kRing, and every item commits one group (empty past
  // the end) so that wait_group counts stay fixed
  auto load_item = [&](int i) {
    if (i < 2 * n_tiles) {
      const T* src = i < n_tiles ? kb : vb;
      const int j0 = (i < n_tiles ? i : i - n_tiles) * C::kTile, nk = min(C::kTile, n_c - j0);
      unsigned char* dst = ring + (size_t)(i % C::kRing) * C::kTile * C::kRowBytes;
      constexpr int kPerRow = kDh / C::kVec;
      const unsigned char* from = reinterpret_cast<const unsigned char*>(src + (size_t)j0 * d);
      if constexpr (kPiece16)
        copy_rows16<kK2Threads>(dst, C::kRowBytes, from, (size_t)d * sizeof(T), nk, row_bytes / 16);
      else
        copy_rows(dst, C::kRowBytes, from, (size_t)d * sizeof(T), nk, row_bytes);
      // the mma path takes V 16 keys at a time: rows past the chunk are zero
      // (p is 0 there, and 0 x a stale NaN would not be)
      if (kMma && i >= n_tiles)
        for (int e = nk * kPerRow + tid; e < ((nk + 15) & ~15) * kPerRow; e += kK2Threads)
          *reinterpret_cast<uint4*>(dst + (e / kPerRow) * C::kRowBytes + (e % kPerRow) * 16) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  // the columns past dh of every staged row are zeros: no copy writes them
  zero_tail(ring, C::kRing * C::kTile, C::kRowBytes, row_bytes, kDh * (int)sizeof(T));
#pragma unroll
  for (int i = 0; i < C::kRing; ++i) load_item(i);

  for (int i = tid; i < G * kDh; i += kK2Threads)
    qs[i] = i % kDh < dh ? to_f(q[((size_t)b * group + g_lo + i / kDh) * d + (size_t)h * dh + i % kDh]) : 0.f;
  for (int i = tid; i < KS * G * kDh; i += kK2Threads) part[i] = 0.f;

  int item = 0;
  // ---- scores: s = scale q.k for the chunk's keys, all G rows
  for (int t = 0; t < n_tiles; ++t, ++item) {
    cp_async_wait<C::kRing - 1>();
    __syncthreads();
    const unsigned char* tile = ring + (size_t)(item % C::kRing) * C::kTile * C::kRowBytes;
    const int nk = min(C::kTile, n_c - t * C::kTile);
    if constexpr (kMma)
      scores_mma<T, kDh>(sc, cs, qs, tile, nk, t * C::kTile, G, scale);
    else
      scores_fma<T, kDh>(sc, cs, qs, tile, nk, t * C::kTile, G, scale);
    __syncthreads();  // the slot is free again
    load_item(item + C::kRing);
  }

  // ---- softmax across the cluster (the V tiles are loading meanwhile).
  // Thread (row tid % RC of a pass, slot tid / RC) takes keys slot,
  // slot + n_slots, ... of its row; the slots' partials meet in `red` and a
  // thread per row combines them in slot order.
  const int slot = tid / RC, n_slots = kK2Threads / RC;
  for (int g0 = 0; g0 < G; g0 += RC) {
    const int gg = g0 + tid % RC;
    float mx = kNegInf;
    if (slot < n_slots && gg < G)
      for (int j = slot; j < n_c; j += n_slots) mx = fmaxf(mx, sc[gg * cs + j]);
    red[tid] = mx;
    __syncthreads();
    if (tid < RC && g0 + tid < G) {
      for (int k = 1; k < n_slots; ++k) mx = fmaxf(mx, red[k * RC + tid]);
      mloc[g0 + tid] = mx;
    }
    __syncthreads();
  }
  cluster.sync();
  for (int g = tid; g < G; g += kK2Threads) {
    float m = kNegInf;
    for (int r = 0; r < split; ++r) m = fmaxf(m, cluster.map_shared_rank(mloc, r)[g]);
    mg[g] = m;
  }
  __syncthreads();
  for (int g0 = 0; g0 < G; g0 += RC) {
    const int gg = g0 + tid % RC;
    float sum = 0.f;
    if (slot < n_slots && gg < G) {
      const float m = mg[gg];
      for (int j = slot; j < n_c; j += n_slots) {
        const float p = expf(sc[gg * cs + j] - m);
        sc[gg * cs + j] = p;
        sum += p;
      }
    }
    red[tid] = sum;
    __syncthreads();
    if (tid < RC && g0 + tid < G) {
      for (int k = 1; k < n_slots; ++k) sum += red[k * RC + tid];
      lloc[g0 + tid] = sum;
    }
    __syncthreads();
  }
  cluster.sync();
  for (int g = tid; g < G; g += kK2Threads) {
    float l = 0.f;
    for (int r = 0; r < split; ++r) l += cluster.map_shared_rank(lloc, r)[g];
    lg[g] = l;
  }
  __syncthreads();
  for (int e = tid; e < G * n_c; e += kK2Threads) {
    const int g = e / n_c, j = e % n_c;
    sc[g * cs + j] = to_f(from_f<T>(sc[g * cs + j] / lg[g]));  // p / l in the cache dtype, as the plain version
  }

  // ---- P.V over the V tiles
  for (int t = 0; t < n_tiles; ++t, ++item) {
    cp_async_wait<C::kRing - 1>();
    __syncthreads();  // also orders the p rounding above before the first tile
    const unsigned char* tile = ring + (size_t)(item % C::kRing) * C::kTile * C::kRowBytes;
    const int nk = min(C::kTile, n_c - t * C::kTile);
    if constexpr (kMma)
      pv_mma<T, kDh>(part, sc, cs, tile, nk, t * C::kTile, G);
    else
      pv_fma<T, kDh>(part, sc, cs, tile, nk, t * C::kTile, G);
    __syncthreads();
    load_item(item + C::kRing);
  }
  cp_async_wait<0>();

  // ---- sum the key slices, then the cluster's ranks, each in order
  __syncthreads();
  for (int e = tid; e < G * kDh; e += kK2Threads) {
    float s = part[e];
    for (int k = 1; k < KS; ++k) s += part[(size_t)k * G * kDh + e];
    part[e] = s;
  }
  cluster.sync();
  for (int e = rank * kK2Threads + tid; e < G * dh; e += split * kK2Threads) {  // the dh real columns only
    const int g = e / dh, c = e % dh;
    float s = 0.f;
    for (int r = 0; r < split; ++r) s += cluster.map_shared_rank(part, r)[g * kDh + c];
    out[((size_t)b * group + g_lo + g) * d + (size_t)h * dh + c] = from_f<T>(s);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

// ---------------------------------------------------------------- K1 ------

// 8 warps: on an H100 over 32 windows, 0.044 ms against 0.047 with 4 (0.058
// against 0.075 at group 16)
constexpr int kK1Threads = 256;
constexpr int kK1Warps = kK1Threads / 32;
constexpr int kK1Tile = 128;                 // the key blocks' granularity (tk_blk is a multiple of it)
constexpr int kK1Rows = 16;                  // query rows a CTA takes: the M of an mma
constexpr int kK1MaxSplit = 8;               // CTAs a cluster: the portable limit

// K1 at width class kDh (32, 64, 128, 256, 512 or 768): the staged rows and
// how the 8 warps share the P.V products. The output's kDh / 8 column
// blocks go round the warps, kColBlocks a warp (4 at 256, 12 at 768); at
// dh 32 its 4 blocks take 4 warps, so two warps share each block (kKSplit
// 2) and take alternate 32-key steps, and their int32 sums, exact in any
// order, meet after the block's last tile.
template <int kDh>
struct K1Cfg {
  // keys a staged tile holds: 128, but 32 above 256, where 128 rows would
  // take 66-99 KB a tile (and the transposed V tile as much again). The
  // tiles only stage a key block: the block (tk_blk), over which p is
  // quantized, stays the contract's at every width.
  static constexpr int kTile = kDh > 256 ? 32 : kK1Tile;
  // tiles in flight: 4, but 2 from 256 on, so that the scores of a block
  // of 1024 keys still fit beside them
  static constexpr int kRing = kDh >= 256 ? 2 : 4;
  static constexpr int kRow = kDh + 16;                       // a staged int8 row, off the banks
  static constexpr int kSlot = kTile * kRow + 2 * kTile * 4;  // the rows, then the k and v scales of a K tile
  static constexpr int kVtRow = kTile + 16;                   // a column of the transposed V tile (144 bytes up to 256)
  static constexpr int kColBlocks = kDh / 8 > kK1Warps ? kDh / 8 / kK1Warps : 1;  // 8-column blocks a warp owns
  static constexpr int kColWarps = kDh / 8 / kColBlocks;      // warps over the columns
  static constexpr int kKSplit = kK1Warps / kColWarps;        // warps that share a column block
  // q's A fragments (kDh / 32 x 4 registers) stay in registers up to 256;
  // above, each score step reads them from q's int8 rows in shared memory
  static constexpr bool kQInRegs = kDh <= 256;
  static_assert(kRing * kSlot >= kK1Rows * kDh * 4, "the ring holds the partial outputs");
};

// shared memory of a K1 CTA: the ring, the transposed V tile, q in int8,
// the scores of a block (fp32), its int8 p (16 rows, padded), the block's
// v scales and the row statistics (m, l, correction, p step, q step); the
// ring holds the partial outputs at the end (`ops.decode_attention.k1_smem_bytes`)
__host__ __device__ __forceinline__ int k1_score_stride(int tk_blk) { return tk_blk + 4; }
__host__ __device__ __forceinline__ int k1_p_stride(int tk_blk) { return tk_blk + 16; }
template <int kDh>
size_t k1_smem_bytes(int rows, int tk_blk) {
  using C = K1Cfg<kDh>;
  return (size_t)C::kRing * C::kSlot + (size_t)kDh * C::kVtRow + (size_t)kK1Rows * C::kRow +
         4 * (size_t)rows * k1_score_stride(tk_blk) + (size_t)kK1Rows * k1_p_stride(tk_blk) + 4 * (size_t)tk_blk +
         4 * 5 * kK1Rows;
}

// m16n8k32 int8 products on the tensor cores, int32 accumulate (exact, as
// the plain version's float64 sums of int8 products)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t ld_u32(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

template <bool kMax>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  return v;
}

// grid (S, n_head, batch x row chunks of 16), cluster (S, 1, 1): block x is
// the rank in the cluster and takes the whole key blocks
// [x * nb / S, (x + 1) * nb / S) of the nb blocks that hold valid keys;
// kPiece16 as K2's
template <typename TQ, int kDh, bool kPiece16>
__global__ void __launch_bounds__(kK1Threads)
decode_attn_i8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ cache_k,
                      const float* __restrict__ k_scale, const int8_t* __restrict__ cache_v,
                      const float* __restrict__ v_scale, TQ* __restrict__ out, int layer, int batch, int group,
                      int tk, int d, int dh, int tk_blk, int n_valid, float scale) {
  using C = K1Cfg<kDh>;
  constexpr int kK1Row = C::kRow, kK1Slot = C::kSlot, kK1ColBlocks = C::kColBlocks, kTile = C::kTile;
  constexpr int kVtRow = C::kVtRow;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n_rc = (group + kK1Rows - 1) / kK1Rows;
  const int h = blockIdx.y, b = blockIdx.z / n_rc, g0 = (blockIdx.z % n_rc) * kK1Rows;
  const int RC = min(kK1Rows, group - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  // P.V: this warp's column group and, where warps share one, its part of the keys
  const int cw = warp % C::kColWarps, kp = warp / C::kColWarps;
  const int scs = k1_score_stride(tk_blk), pis = k1_p_stride(tk_blk);

  unsigned char* ring = smem;
  int8_t* vt = reinterpret_cast<int8_t*>(ring + C::kRing * kK1Slot);
  int8_t* qi = vt + kDh * kVtRow;
  float* sc = reinterpret_cast<float*>(qi + kK1Rows * kK1Row);
  int8_t* pi = reinterpret_cast<int8_t*>(sc + RC * scs);
  float* vsb = reinterpret_cast<float*>(pi + kK1Rows * pis);
  float* m_s = vsb + tk_blk;
  float* l_s = m_s + kK1Rows;
  float* corr_s = l_s + kK1Rows;
  float* sp_s = corr_s + kK1Rows;
  float* qsc = sp_s + kK1Rows;
  // the partial outputs (RC x kDh) once every tile is done: the ring holds
  // them at every class (at 256 they outgrow a block of 128 keys' scores)
  float* part = reinterpret_cast<float*>(ring);

  const int n_blocks = (n_valid + tk_blk - 1) / tk_blk;
  const int blk_lo = rank * n_blocks / split, blk_hi = (rank + 1) * n_blocks / split;
  const int T = tk_blk / kTile;  // tiles of a whole block
  const int key_hi = min(blk_hi * tk_blk, n_valid);
  const int t_last = blk_hi > blk_lo ? (key_hi - (blk_hi - 1) * tk_blk + kTile - 1) / kTile : 0;
  const int n_items = blk_hi > blk_lo ? 2 * T * (blk_hi - blk_lo - 1) + 2 * t_last : 0;
  const size_t row = (size_t)layer * batch + b;
  const int8_t* kb = cache_k + row * tk * d + (size_t)h * dh;
  const int8_t* vb = cache_v + row * tk * d + (size_t)h * dh;
  const float* ksb = k_scale + row * tk;
  const float* vsg = v_scale + row * tk;

  // the loads in order: per block its K tiles (with the k and v scales),
  // then its V tiles; item i goes to ring slot i % C::kRing, and every item
  // commits one group (empty past the end) so that wait_group counts stay
  // fixed. Keys at or past n_valid are never read.
  auto item_at = [&](int i, int& j0, int& nk, bool& is_v) {
    const int rel = i / (2 * T), blk = blk_lo + rel;
    const int nt = blk == blk_hi - 1 ? t_last : T;
    const int w = i - rel * 2 * T;
    is_v = w >= nt;
    j0 = blk * tk_blk + (is_v ? w - nt : w) * kTile;
    nk = min(kTile, n_valid - j0);
  };
  auto load_item = [&](int i) {
    if (i < n_items) {
      int j0, nk;
      bool is_v;
      item_at(i, j0, nk, is_v);
      unsigned char* dst = ring + (size_t)(i % C::kRing) * kK1Slot;
      // a row's dh bytes (head h starts at byte h dh of a cache row)
      const unsigned char* from = reinterpret_cast<const unsigned char*>((is_v ? vb : kb) + (size_t)j0 * d);
      if constexpr (kPiece16)
        copy_rows16<kK1Threads>(dst, kK1Row, from, d, nk, dh / 16);
      else
        copy_rows(dst, kK1Row, from, d, nk, dh);
      if (!is_v) {
        float* dsc = reinterpret_cast<float*>(dst + kTile * kK1Row);
        for (int e = tid; e < 2 * nk; e += kK1Threads) {  // 4 bytes a key: no scale past n_valid is read
          const int j = e % nk;
          cp_async4(dsc + (e / nk) * kTile + j, (e < nk ? ksb : vsg) + j0 + j);
        }
      }
    }
    cp_async_commit();
  };
  // the columns past dh of every staged row are zeros: no copy writes them
  for (int slot = 0; slot < C::kRing; ++slot) zero_tail(ring + (size_t)slot * kK1Slot, kTile, kK1Row, dh, kDh);
#pragma unroll
  for (int i = 0; i < C::kRing; ++i) load_item(i);

  // quantize q per (row, head): abs-max step, round half to even (columns
  // past dh are zero)
  for (int r = warp; r < RC; r += kK1Warps) {
    const TQ* qr = q + ((size_t)b * group + g0 + r) * d + (size_t)h * dh;
    float x[kDh / 32], amax = 0.f;
#pragma unroll
    for (int i = 0; i < kDh / 32; ++i) {
      x[i] = lane + 32 * i < dh ? to_f(qr[lane + 32 * i]) : 0.f;
      amax = fmaxf(amax, fabsf(x[i]));
    }
    const float sq = fmaxf(warp_reduce<true>(amax), 1e-20f) / 127.f;
#pragma unroll
    for (int i = 0; i < kDh / 32; ++i) qi[r * kK1Row + lane + 32 * i] = (int8_t)rintf(x[i] / sq);
    if (lane == 0) {
      qsc[r] = sq * scale;
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
  }
  __syncthreads();
  // q as the A fragments of the dh / 32 k32 steps (rows past RC are zero):
  // in registers up to 256, else read from qi at each step
  auto q_frag = [&](int ks, uint32_t(&a)[4]) {
    a[0] = g < RC ? ld_u32(qi + g * kK1Row + 32 * ks + 4 * t4) : 0u;
    a[1] = g + 8 < RC ? ld_u32(qi + (g + 8) * kK1Row + 32 * ks + 4 * t4) : 0u;
    a[2] = g < RC ? ld_u32(qi + g * kK1Row + 32 * ks + 16 + 4 * t4) : 0u;
    a[3] = g + 8 < RC ? ld_u32(qi + (g + 8) * kK1Row + 32 * ks + 16 + 4 * t4) : 0u;
  };
  uint32_t qa[C::kQInRegs ? kDh / 32 : 1][4];
  if constexpr (C::kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < kDh / 32; ++ks) q_frag(ks, qa[ks]);
  }
  // this warp's output columns: the 8-column blocks kK1ColBlocks x cw + n
  float acc[kK1ColBlocks][4] = {};

  int item = 0;
  for (int blk = blk_lo; blk < blk_hi; ++blk) {
    const int kb0 = blk * tk_blk, n_k = min(tk_blk, n_valid - kb0);
    const int nt = (n_k + kTile - 1) / kTile;
    // ---- scores s = (s32 x q step x scale) x k scale of the block's keys, all rows
    for (int t = 0; t < nt; ++t, ++item) {
      cp_async_wait<C::kRing - 1>();
      __syncthreads();
      const unsigned char* slot = ring + (size_t)(item % C::kRing) * kK1Slot;
      const float* ks_t = reinterpret_cast<const float*>(slot + kTile * kK1Row);
      const int j0 = t * kTile, nk = min(kTile, n_k - j0);
      for (int n8 = warp; n8 * 8 < nk; n8 += kK1Warps) {
        int c[4] = {0, 0, 0, 0};
        const int8_t* kr = reinterpret_cast<const int8_t*>(slot) + (n8 * 8 + g) * kK1Row + 4 * t4;
#pragma unroll
        for (int ks = 0; ks < kDh / 32; ++ks) {
          if constexpr (C::kQInRegs) {
            mma_s8(c, qa[ks], ld_u32(kr + 32 * ks), ld_u32(kr + 32 * ks + 16));
          } else {
            uint32_t a[4];
            q_frag(ks, a);
            mma_s8(c, a, ld_u32(kr + 32 * ks), ld_u32(kr + 32 * ks + 16));
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), key = n8 * 8 + 2 * t4 + (e & 1);
          if (r < RC && key < nk) sc[r * scs + j0 + key] = __fmul_rn(__fmul_rn((float)c[e], qsc[r]), ks_t[key]);
        }
      }
      for (int j = tid; j < nk; j += kK1Threads) vsb[j0 + j] = ks_t[kTile + j];
      __syncthreads();  // the slot is free again
      load_item(item + C::kRing);
    }

    // ---- the block's softmax and p quantization, a warp per row (the V
    // tiles are loading meanwhile): m = max(m, block max), p = exp(s - m),
    // sp = max(p v_scale) / 127, p_int8 = rint(p v_scale / sp)
    const int n_k32 = (n_k + 31) & ~31;
    for (int r = warp; r < RC; r += kK1Warps) {
      float* srow = sc + r * scs;
      float mx = kNegInf;
      for (int j = lane; j < n_k; j += 32) mx = fmaxf(mx, srow[j]);
      const float m_old = m_s[r], m_new = fmaxf(m_old, warp_reduce<true>(mx));
      float psum = 0.f, pmax = 0.f;
      for (int j = lane; j < n_k; j += 32) {
        const float p = expf(srow[j] - m_new);
        const float pv = p * vsb[j];
        psum += p;
        pmax = fmaxf(pmax, pv);
        srow[j] = pv;
      }
      psum = warp_reduce<false>(psum);
      const float sp = fmaxf(warp_reduce<true>(pmax), 1e-30f) / 127.f;
      int8_t* prow = pi + r * pis;
      for (int j = lane; j < n_k; j += 32) prow[j] = (int8_t)rintf(srow[j] / sp);
      for (int j = n_k + lane; j < n_k32; j += 32) prow[j] = 0;  // the last k32 step's keys past the block
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        corr_s[r] = corr;
        sp_s[r] = sp;
        l_s[r] = corr * l_s[r] + psum;
        m_s[r] = m_new;
      }
    }

    // ---- P.V over the block's V tiles: V transposed in shared memory so
    // that four keys of a column form one word of an mma's B
    int o[kK1ColBlocks][4] = {};
    for (int t = 0; t < nt; ++t, ++item) {
      cp_async_wait<C::kRing - 1>();
      __syncthreads();  // also orders the softmax above before the first tile
      const unsigned char* slot = ring + (size_t)(item % C::kRing) * kK1Slot;
      const int j0 = t * kTile, nk = min(kTile, n_k - j0);
      for (int e = tid; e < ((nk + 3) / 4) * (kDh / 4); e += kK1Threads) {
        const int k4 = e / (kDh / 4), c4 = e % (kDh / 4);
        const unsigned char* src = slot + 4 * k4 * kK1Row + 4 * c4;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + kK1Row);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 2 * kK1Row);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 3 * kK1Row);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        int8_t* dst = vt + 4 * c4 * kVtRow + 4 * k4;
        *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + kVtRow) = __byte_perm(lo01, lo23, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + 2 * kVtRow) = __byte_perm(hi01, hi23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 3 * kVtRow) = __byte_perm(hi01, hi23, 0x7632);
      }
      __syncthreads();
      for (int k32 = 32 * kp; k32 < nk; k32 += 32 * C::kKSplit) {
        const int8_t* p0 = pi + j0 + k32 + 4 * t4;
        uint32_t pa[4];
        pa[0] = g < RC ? ld_u32(p0 + g * pis) : 0u;
        pa[1] = g + 8 < RC ? ld_u32(p0 + (g + 8) * pis) : 0u;
        pa[2] = g < RC ? ld_u32(p0 + g * pis + 16) : 0u;
        pa[3] = g + 8 < RC ? ld_u32(p0 + (g + 8) * pis + 16) : 0u;
#pragma unroll
        for (int n = 0; n < kK1ColBlocks; ++n) {
          const int8_t* vc = vt + ((kK1ColBlocks * cw + n) * 8 + g) * kVtRow + k32 + 4 * t4;
          mma_s8(o[n], pa, ld_u32(vc), ld_u32(vc + 16));
        }
      }
      __syncthreads();
      load_item(item + C::kRing);
    }
    if constexpr (C::kKSplit > 1) {
      // the later key parts hand their int32 sums to the first through the
      // transposed V tile, which no warp reads again before the next block:
      // a slot per (key part kq >= 1, column block n of this warp, lane, e)
      auto slot = [&](int kq, int n, int e) {
        return (((kq - 1) * C::kColWarps + cw) * kK1ColBlocks + n) * 128 + lane * 4 + e;
      };
      int* xo = reinterpret_cast<int*>(vt);
      if (kp > 0)
#pragma unroll
        for (int n = 0; n < kK1ColBlocks; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) xo[slot(kp, n, e)] = o[n][e];
      __syncthreads();
      if (kp == 0)
#pragma unroll
        for (int n = 0; n < kK1ColBlocks; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            for (int kq = 1; kq < C::kKSplit; ++kq) o[n][e] += xo[slot(kq, n, e)];
    }
    // acc = acc x correction + o x sp, rounded as the plain version (the
    // first key part's warps hold the block's sums)
#pragma unroll
    for (int n = 0; n < kK1ColBlocks; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1);
        if (r < RC) acc[n][e] = __fadd_rn(__fmul_rn(acc[n][e], corr_s[r]), __fmul_rn((float)o[n][e], sp_s[r]));
      }
  }
  cp_async_wait<0>();

  // ---- combine the cluster's partials in rank order: M = max m, out =
  // sum acc exp(m - M) / sum l exp(m - M) (one CTA: exp(0) = 1, the
  // sequential result); each output is written once
  if (kp == 0)
#pragma unroll
    for (int n = 0; n < kK1ColBlocks; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1);
        if (r < RC) part[r * kDh + (kK1ColBlocks * cw + n) * 8 + 2 * t4 + (e & 1)] = acc[n][e];
      }
  cluster.sync();
  for (int e = rank * kK1Threads + tid; e < RC * dh; e += split * kK1Threads) {  // the dh real columns only
    const int r = e / dh, col = e % dh;
    float m = kNegInf;
    for (int c = 0; c < split; ++c) m = fmaxf(m, cluster.map_shared_rank(m_s, c)[r]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < split; ++c) {
      const float f = expf(cluster.map_shared_rank(m_s, c)[r] - m);
      l += cluster.map_shared_rank(l_s, c)[r] * f;
      a += cluster.map_shared_rank(part, c)[r * kDh + col] * f;
    }
    out[((size_t)b * group + g0 + r) * d + (size_t)h * dh + col] = from_f<TQ>(a / (l == 0.f ? 1.f : l));
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

// lifts a kernel's dynamic shared memory limit to `bytes` on the current
// device once, not on every launch (the call costs host time a decode step
// does not have); one record per kernel, not per kernel type: the head
// widths' instances share a signature
template <auto kKernel>
cudaError_t raise_smem_limit(size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t lifted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && lifted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) lifted[dev] = bytes;
  return err;
}

// the width class a head width runs in (`ops.decode_class`): the smallest
// of 32, 64, 128, 256, 512 and 768 that is >= dh, for a width from 1 to
// 768; else 0
int decode_class(int dh) {
  return dh < 1 || dh > 768 ? 0
         : dh <= 32         ? 32
         : dh <= 64         ? 64
         : dh <= 128        ? 128
         : dh <= 256        ? 256
         : dh <= 512        ? 512
                            : 768;
}

// the head width of a call: d / n_head, or 0 where n_head does not divide d
int head_width(int d, int n_head) { return n_head > 0 && d % n_head == 0 ? d / n_head : 0; }

template <typename T, int kDh>
int launch_decode(const void* q, const void* k, const void* v, void* out, int layer, int n_layer, int batch,
                  int group, int tk, int d, int n_head, int valid_upto, int split, float scale, void* stream) {
  const int dh = head_width(d, n_head);
  if (decode_class(dh) != kDh || tk < 1 || layer < 0 || layer >= n_layer || batch < 1 || group < 1 || split < 1 ||
      split > kK2MaxSplit)
    return (int)cudaErrorInvalidValue;
  const int n_valid = valid_upto < 0 ? tk : min(valid_upto + 1, tk);
  const int chunk = (n_valid + split - 1) / split;
  const size_t smem = k2_smem_bytes<T, kDh>(group, chunk);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const bool whole = dh * sizeof(T) % 16 == 0;
  auto kernel = whole ? decode_attn_kernel<T, kDh, true> : decode_attn_kernel<T, kDh, false>;
  cudaError_t err = whole ? raise_smem_limit<decode_attn_kernel<T, kDh, true>>(smem)
                          : raise_smem_limit<decode_attn_kernel<T, kDh, false>>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  const int rpc = k2_cta_rows(group, kDh);
  cfg.gridDim = dim3(split, n_head, batch * ((group + rpc - 1) / rpc));
  cfg.blockDim = dim3(kK2Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<T*>(out), layer, batch, group, tk, d, dh, n_valid,
                           chunk, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, int kDh>
int launch_decode_i8(const void* q, const void* k, const void* ks, const void* v, const void* vs, void* out,
                     int layer, int n_layer, int batch, int group, int tk, int d, int n_head, int tk_blk,
                     int valid_upto, int split, float scale, void* stream) {
  const int dh = head_width(d, n_head);
  if (decode_class(dh) != kDh || group < 1 || tk_blk < kK1Tile || tk_blk > kMaxBlock || tk_blk % kK1Tile != 0 ||
      tk % tk_blk != 0 || layer < 0 || layer >= n_layer || batch < 1 || split < 1 || split > kK1MaxSplit)
    return (int)cudaErrorInvalidValue;
  const int n_valid = valid_upto < 0 ? tk : min(valid_upto + 1, tk);
  const size_t smem = k1_smem_bytes<kDh>(min(group, kK1Rows), tk_blk);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const bool whole = dh % 16 == 0;
  auto kernel = whole ? decode_attn_i8_kernel<TQ, kDh, true> : decode_attn_i8_kernel<TQ, kDh, false>;
  cudaError_t err = whole ? raise_smem_limit<decode_attn_i8_kernel<TQ, kDh, true>>(smem)
                          : raise_smem_limit<decode_attn_i8_kernel<TQ, kDh, false>>(smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_head, batch * ((group + kK1Rows - 1) / kK1Rows));
  cfg.blockDim = dim3(kK1Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const TQ*>(q),
                           static_cast<const int8_t*>(k), static_cast<const float*>(ks), static_cast<const int8_t*>(v),
                           static_cast<const float*>(vs), static_cast<TQ*>(out), layer, batch, group, tk, d, dh,
                           tk_blk, n_valid, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// K2 at the width class of d / n_head, caches and q of type T
template <typename T>
int decode_by_class(const void* q, const void* k, const void* v, void* out, int layer, int n_layer, int batch,
                    int group, int tk, int d, int n_head, int valid_upto, int split, float scale, void* stream) {
  switch (decode_class(head_width(d, n_head))) {
    case 32:
      return launch_decode<T, 32>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split, scale,
                                  stream);
    case 64:
      return launch_decode<T, 64>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split, scale,
                                  stream);
    case 128:
      return launch_decode<T, 128>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split,
                                   scale, stream);
    case 256:
      return launch_decode<T, 256>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split,
                                   scale, stream);
    case 512:
      return launch_decode<T, 512>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split,
                                   scale, stream);
    case 768:
      return launch_decode<T, 768>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split,
                                   scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K1 at the width class of d / n_head, q of type TQ
template <typename TQ>
int decode_i8_by_class(const void* q, const void* k, const void* ks, const void* v, const void* vs, void* out,
                       int layer, int n_layer, int batch, int group, int tk, int d, int n_head, int tk_blk,
                       int valid_upto, int split, float scale, void* stream) {
  switch (decode_class(head_width(d, n_head))) {
    case 32:
      return launch_decode_i8<TQ, 32>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                      valid_upto, split, scale, stream);
    case 64:
      return launch_decode_i8<TQ, 64>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                      valid_upto, split, scale, stream);
    case 128:
      return launch_decode_i8<TQ, 128>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                       valid_upto, split, scale, stream);
    case 256:
      return launch_decode_i8<TQ, 256>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                       valid_upto, split, scale, stream);
    case 512:
      return launch_decode_i8<TQ, 512>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                       valid_upto, split, scale, stream);
    case 768:
      return launch_decode_i8<TQ, 768>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                       valid_upto, split, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// a CTA's shared memory at width class kDh of either kernel, or 0 for a
// width K1 and K2 do not serve
template <typename T>
size_t k2_smem_at(int dh, int group, int chunk) {
  switch (decode_class(dh)) {
    case 32: return k2_smem_bytes<T, 32>(group, chunk);
    case 64: return k2_smem_bytes<T, 64>(group, chunk);
    case 128: return k2_smem_bytes<T, 128>(group, chunk);
    case 256: return k2_smem_bytes<T, 256>(group, chunk);
    case 512: return k2_smem_bytes<T, 512>(group, chunk);
    case 768: return k2_smem_bytes<T, 768>(group, chunk);
    default: return 0;
  }
}
size_t k1_smem_at(int dh, int rows, int tk_blk) {
  switch (decode_class(dh)) {
    case 32: return k1_smem_bytes<32>(rows, tk_blk);
    case 64: return k1_smem_bytes<64>(rows, tk_blk);
    case 128: return k1_smem_bytes<128>(rows, tk_blk);
    case 256: return k1_smem_bytes<256>(rows, tk_blk);
    case 512: return k1_smem_bytes<512>(rows, tk_blk);
    case 768: return k1_smem_bytes<768>(rows, tk_blk);
    default: return 0;
  }
}

}  // namespace

#ifdef DECODE_ATTENTION_F16
// The fp16 entries, built by decode_attention_f16.cu in a translation unit
// of their own (one nvcc each, in parallel with this file's;
// `ops/_cuda.py`): the bf16 kernels' twins, instantiated for __half.

// fp16 caches, the same head widths: the bf16 kernel's twin
extern "C" int decode_attn_f16(const void* q, const void* k, const void* v, void* out, int layer, int n_layer,
                               int batch, int group, int tk, int d, int n_head, int valid_upto, int split,
                               float scale, void* stream) {
  return decode_by_class<__half>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split, scale,
                                 stream);
}

// fp16 q over int8 caches, the same head widths
extern "C" int decode_attn_i8_f16(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                                  void* out, int layer, int n_layer, int batch, int group, int tk, int d,
                                  int n_head, int tk_blk, int valid_upto, int split, float scale, void* stream) {
  return decode_i8_by_class<__half>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                    valid_upto, split, scale, stream);
}
#else  // the bf16 and fp32 entries, and the shared-memory plans

// K2's shared bytes a CTA (`ops.decode_attention.k2_smem_bytes`) at head
// width dh over a chunk of `chunk` keys for a group of `group` rows, with
// caches of `itemsize` bytes (2: bf16 or fp16, 4: fp32); -1 for a width or itemsize
// K2 does not take
extern "C" int decode_smem_bytes(int itemsize, int dh, int group, int chunk) {
  const size_t n = itemsize == 2   ? k2_smem_at<__nv_bfloat16>(dh, group, chunk)
                   : itemsize == 4 ? k2_smem_at<float>(dh, group, chunk)
                                   : 0;
  return n == 0 ? -1 : (int)n;
}

// K1's shared bytes a CTA (`ops.decode_attention.k1_smem_bytes`) at head
// width dh over `rows` query rows (at most 16) and key blocks of tk_blk; -1
// for a width K1 does not take
extern "C" int decode_i8_smem_bytes(int dh, int rows, int tk_blk) {
  const size_t n = k1_smem_at(dh, rows, tk_blk);
  return n == 0 ? -1 : (int)n;
}

// `split` is the cluster size S (1, 2, 4 or 8; `k2_plan`); a head width d /
// n_head from 1 to 768 (d = dh * n_head)
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v, void* out, int layer, int n_layer,
                                int batch, int group, int tk, int d, int n_head, int valid_upto, int split,
                                float scale, void* stream) {
  return decode_by_class<__nv_bfloat16>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split,
                                        scale, stream);
}

// fp32 caches, the same head widths
extern "C" int decode_attn_f32(const void* q, const void* k, const void* v, void* out, int layer, int n_layer,
                               int batch, int group, int tk, int d, int n_head, int valid_upto, int split,
                               float scale, void* stream) {
  return decode_by_class<float>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split, scale,
                                stream);
}

// `split` is the cluster size S (1-8; `k1_plan`); bf16, fp16 or fp32 q at a head
// width from 1 to 768
extern "C" int decode_attn_i8_bf16(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                                   void* out, int layer, int n_layer, int batch, int group, int tk, int d,
                                   int n_head, int tk_blk, int valid_upto, int split, float scale, void* stream) {
  return decode_i8_by_class<__nv_bfloat16>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                           valid_upto, split, scale, stream);
}

extern "C" int decode_attn_i8_f32(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                                  void* out, int layer, int n_layer, int batch, int group, int tk, int d,
                                  int n_head, int tk_blk, int valid_upto, int split, float scale, void* stream) {
  return decode_i8_by_class<float>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                   valid_upto, split, scale, stream);
}

#endif  // DECODE_ATTENTION_F16

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
