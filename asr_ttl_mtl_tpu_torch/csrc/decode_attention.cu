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
//     keys through a ring of shared-memory buffers filled by 16-byte
//     cp.async (4 tiles in flight for bf16, 2 for fp32), so the V loads are
//     already in flight while the softmax runs.
//   - Products. bf16 caches: both on the tensor cores, mma.sync m16n8k16
//     with the group's rows padded to 16 (rows beyond 16 in further passes
//     over the tile already staged) and fp32 accumulation; a bf16 x bf16
//     product is exact in fp32, as in the plain version's fp32 einsum. On
//     the CUDA cores the FMAs of a group of 5 to 16 rows took longer than
//     the bytes (group 16 over 32 windows took 0.21-0.32 ms on an H100).
//     fp32 caches (the fp16=False option): the CUDA cores, a thread per
//     (row, key) with the row's 64 q values in registers and four FMA
//     chains, and for P.V a thread per (row, 8 columns, slice of keys);
//     exact fp32 throughout, which tf32 mma would not be.
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
//   - Per block, its K tiles (128 keys, with their k and v scales), then its
//     V tiles, stream through a 4-deep cp.async ring, so the V loads are in
//     flight during the block's softmax.
//   - Both products on the tensor cores, mma.sync m16n8k32 s8 with int32
//     accumulation (exact, as the plain version's float64 sums): the rows
//     padded to 16; K rows are the B operand as they lie. For P V each V
//     tile is transposed in shared memory (byte permutes, 4 keys x 4
//     columns a thread) so that four keys of a column form one word of B.
//   - The softmax of a row is one warp's: block max, sum, p max and the p
//     quantization by warp shuffles, with no block-wide barrier between.
//   - The CTAs' partials (m, l, acc) meet through distributed shared memory
//     and are combined in rank order: out = sum acc e^(m - M) / sum l
//     e^(m - M), each output written once. No atomics and no global
//     scratch: the same bits on every run; with S = 1, e^0 = 1 and the
//     result is the sequential walk's.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kDh = 64;
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

// ---------------------------------------------------------------- K2 ------

constexpr int kK2Threads = 128;  // 4 warps
constexpr int kK2Warps = kK2Threads / 32;
constexpr int kK2Tile = 128;     // keys a staged tile holds
constexpr int kK2MaxSplit = 8;   // CTAs a cluster: the portable limit
constexpr int kK2RowChunk = 16;  // query rows a pass of the threads takes
constexpr size_t kSmemLimit = 227 * 1024;

template <typename T>
struct K2Cfg {
  static constexpr int kVec = 16 / (int)sizeof(T);                         // elements a 16-byte copy moves
  static constexpr int kRowBytes = kDh * (int)sizeof(T) + 16;             // a staged key row, padded off the banks
  static constexpr int kRing = sizeof(T) == 2 ? 4 : 2;                      // tiles in flight
  static constexpr int kRingBytes = kRing * kK2Tile * kRowBytes;
};

__host__ __device__ __forceinline__ int k2_rows(int group) { return group < kK2RowChunk ? group : kK2RowChunk; }
// P.V: a thread takes 8 columns of a row; the threads left over take slices of the keys
__host__ __device__ __forceinline__ int k2_slices(int group) { return kK2Threads / (8 * k2_rows(group)); }
__host__ __device__ __forceinline__ int k2_stride(int chunk) { return (chunk + 3) & ~3; }

// ring, q (G x 64 fp32), scores (G x chunk fp32), P.V partials (slices x G
// x 64 fp32), row max / sum, local and global (4 x G fp32), and one fp32 a
// thread for the row reductions
template <typename T>
size_t k2_smem_bytes(int group, int chunk) {
  return (size_t)K2Cfg<T>::kRingBytes +
         4 * ((size_t)group * kDh + (size_t)group * k2_stride(chunk) + (size_t)k2_slices(group) * group * kDh +
              4 * (size_t)group + kK2Threads);
}

// m16n8k16 bf16 products on the tensor cores, fp32 accumulate (bf16 x bf16
// products are exact in fp32, as in the plain version's fp32 einsum)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- the products of one staged tile (128 keys; rows of kRowBytes)

// bf16: scores of rows g0 .. g0 + 15 (zero past G) against 8 keys an mma;
// warp w takes the key blocks w, w + kK2Warps, ...; thread (g8, t4) holds rows
// g0 + g8 and g0 + g8 + 8, keys 2 t4 and 2 t4 + 1 of a block
__device__ __forceinline__ void scores_mma(float* sc, int cs, const float* qs, const unsigned char* tile, int nk,
                                           int j0, int G, float scale) {
  constexpr int kRow = K2Cfg<__nv_bfloat16>::kRowBytes;
  const int warp = threadIdx.x / 32, g8 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  for (int g0 = 0; g0 < G; g0 += 16) {
    const int r0 = g0 + g8, r1 = r0 + 8;
    uint32_t qa[kDh / 16][4];
#pragma unroll
    for (int ks = 0; ks < kDh / 16; ++ks) {
      const int c = 16 * ks + 2 * t4;
      const float2 zero = make_float2(0.f, 0.f);
      const float2 x00 = r0 < G ? *reinterpret_cast<const float2*>(qs + r0 * kDh + c) : zero;
      const float2 x10 = r1 < G ? *reinterpret_cast<const float2*>(qs + r1 * kDh + c) : zero;
      const float2 x01 = r0 < G ? *reinterpret_cast<const float2*>(qs + r0 * kDh + c + 8) : zero;
      const float2 x11 = r1 < G ? *reinterpret_cast<const float2*>(qs + r1 * kDh + c + 8) : zero;
      qa[ks][0] = pack_bf16(x00.x, x00.y);  // exact: q holds bf16 values
      qa[ks][1] = pack_bf16(x10.x, x10.y);
      qa[ks][2] = pack_bf16(x01.x, x01.y);
      qa[ks][3] = pack_bf16(x11.x, x11.y);
    }
    for (int kb = 8 * warp; kb < nk; kb += 8 * kK2Warps) {
      float dacc[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* kr = tile + (kb + g8) * kRow + 4 * t4;
#pragma unroll
      for (int ks = 0; ks < kDh / 16; ++ks)
        mma_bf16(dacc, qa[ks], *reinterpret_cast<const uint32_t*>(kr + 32 * ks),
                 *reinterpret_cast<const uint32_t*>(kr + 32 * ks + 16));
      const int kl = kb + 2 * t4, j = j0 + kl;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (kl + e >= nk) continue;
        if (r0 < G) sc[r0 * cs + j + e] = dacc[e] * scale;
        if (r1 < G) sc[r1 * cs + j + e] = dacc[2 + e] * scale;
      }
    }
  }
}

// fp32 (and any type): thread (row tid % RC of a pass, slot tid / RC) takes
// keys slot, slot + n_slots, ... with its row's 64 q values in registers
template <typename T>
__device__ __forceinline__ void scores_fma(float* sc, int cs, const float* qs, const unsigned char* tile, int nk,
                                           int j0, int G, float scale) {
  using C = K2Cfg<T>;
  const int RC = k2_rows(G), slot = threadIdx.x / RC, n_slots = kK2Threads / RC;
  for (int g0 = 0; g0 < G; g0 += RC) {
    const int gg = g0 + threadIdx.x % RC;
    if (slot >= n_slots || gg >= G) continue;
    float qr[kDh];
#pragma unroll
    for (int c = 0; c < kDh; c += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qs + gg * kDh + c);
      qr[c] = x.x, qr[c + 1] = x.y, qr[c + 2] = x.z, qr[c + 3] = x.w;
    }
    for (int j = slot; j < nk; j += n_slots) {
      const unsigned char* kr = tile + j * C::kRowBytes;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains keep the FMA pipe busy
#pragma unroll
      for (int c0 = 0; c0 < kDh; c0 += C::kVec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + c0 * sizeof(T));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < C::kVec; ++c) acc[c % 4] = fmaf(qr[c0 + c], to_f(e[c]), acc[c % 4]);
      }
      sc[gg * cs + j0 + j] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) * scale;
    }
  }
}

// bf16: out rows g0 .. g0 + 15 += P (16 rows x 16 keys an mma) V (16 keys x 8
// columns), into part (G x 64); warp w owns the 8-column blocks w, w +
// kK2Warps, ..., and ldmatrix.trans turns the key-major V rows into B
// fragments. V rows past nk are zero (the loader writes them), p is 0 there.
__device__ __forceinline__ void pv_mma(float* part, const float* sc, int cs, const unsigned char* tile, int nk,
                                       int j0, int G) {
  constexpr int kRow = K2Cfg<__nv_bfloat16>::kRowBytes, kBlocks = kDh / 8 / kK2Warps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
  // lanes 0-7 address keys 0-7 of a 16-key step, lanes 8-15 keys 8-15
  const unsigned char* vrow = tile + (lane % 16) * kRow + 16 * warp;
  for (int g0 = 0; g0 < G; g0 += 16) {
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
        pa[2 * h8] = pack_bf16(p00, p01);  // exact: p / l was rounded to bf16
        pa[2 * h8 + 1] = pack_bf16(p10, p11);
      }
#pragma unroll
      for (int n = 0; n < kBlocks; ++n) {
        uint32_t vb[2];
        ldmatrix_x2_trans(vb, vrow + k16 * kRow + 16 * kK2Warps * n);
        mma_bf16(acc[n], pa, vb[0], vb[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < kBlocks; ++n) {
      const int c = 8 * (warp + kK2Warps * n) + 2 * t4;
      if (r0 < G) part[r0 * kDh + c] += acc[n][0], part[r0 * kDh + c + 1] += acc[n][1];
      if (r1 < G) part[r1 * kDh + c] += acc[n][2], part[r1 * kDh + c + 1] += acc[n][3];
    }
  }
}

// fp32 (and any type): thread (8 columns col8, row rr of a pass, key slice
// ks); each key slice sums into its own part[ks] (slices x G x 64)
template <typename T>
__device__ __forceinline__ void pv_fma(float* part, const float* sc, int cs, const unsigned char* tile, int nk,
                                       int j0, int G) {
  using C = K2Cfg<T>;
  const int RC = k2_rows(G), KS = k2_slices(G);
  const int col8 = threadIdx.x % 8, rr = (threadIdx.x / 8) % RC, ks = threadIdx.x / (8 * RC);
  if (ks >= KS) return;
  for (int g0 = 0; g0 < G; g0 += RC) {
    const int gg = g0 + rr;
    if (gg >= G) continue;
    const float* prow = sc + gg * cs + j0;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    for (int j = ks; j < nk; j += KS) {
      const float p = prow[j];
      const unsigned char* vr = tile + j * C::kRowBytes + col8 * 8 * sizeof(T);
#pragma unroll
      for (int c0 = 0; c0 < 8; c0 += C::kVec) {
        const uint4 raw = *reinterpret_cast<const uint4*>(vr + c0 * sizeof(T));
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int c = 0; c < C::kVec; ++c) acc[c0 + c] = fmaf(p, to_f(e[c]), acc[c0 + c]);
      }
    }
    float* dst = part + ((size_t)ks * G + gg) * kDh + col8 * 8;
#pragma unroll
    for (int c = 0; c < 8; ++c) dst[c] += acc[c];
  }
}

// grid (S, n_head, batch), cluster (S, 1, 1): block x is the rank in the
// cluster, and takes keys [x * chunk, (x + 1) * chunk) of [0, n_valid)
template <typename T>
__global__ void __launch_bounds__(kK2Threads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ cache_k, const T* __restrict__ cache_v,
                   T* __restrict__ out, int layer, int batch, int group, int tk, int d, int n_valid, int chunk,
                   float scale) {
  using C = K2Cfg<T>;
  constexpr bool kMma = sizeof(T) == 2;  // bf16 caches: both products on the tensor cores
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int G = group, cs = k2_stride(chunk), RC = k2_rows(G), KS = k2_slices(G);

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
  const int n_tiles = (n_c + kK2Tile - 1) / kK2Tile;
  const size_t row = (size_t)layer * batch + b;
  const T* kb = cache_k + (row * tk + k_lo) * d + (size_t)h * kDh;
  const T* vb = cache_v + (row * tk + k_lo) * d + (size_t)h * kDh;

  // the loads in order: K tiles 0 .. n_tiles-1, then V tiles; item i goes
  // to ring slot i % kRing, and every item commits one group (empty past
  // the end) so that wait_group counts stay fixed
  auto load_item = [&](int i) {
    if (i < 2 * n_tiles) {
      const T* src = i < n_tiles ? kb : vb;
      const int j0 = (i < n_tiles ? i : i - n_tiles) * kK2Tile, nk = min(kK2Tile, n_c - j0);
      unsigned char* dst = ring + (size_t)(i % C::kRing) * kK2Tile * C::kRowBytes;
      constexpr int kPerRow = kDh / C::kVec;
      for (int e = tid; e < nk * kPerRow; e += kK2Threads) {
        const int r = e / kPerRow, c = e % kPerRow;
        cp_async16(dst + r * C::kRowBytes + c * 16, src + (size_t)(j0 + r) * d + c * C::kVec);
      }
      // the mma path takes V 16 keys at a time: rows past the chunk are zero
      // (p is 0 there, and 0 x a stale NaN would not be)
      if (kMma && i >= n_tiles)
        for (int e = nk * kPerRow + tid; e < ((nk + 15) & ~15) * kPerRow; e += kK2Threads)
          *reinterpret_cast<uint4*>(dst + (e / kPerRow) * C::kRowBytes + (e % kPerRow) * 16) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < C::kRing; ++i) load_item(i);

  for (int i = tid; i < G * kDh; i += kK2Threads)
    qs[i] = to_f(q[((size_t)b * G + i / kDh) * d + (size_t)h * kDh + i % kDh]);
  for (int i = tid; i < KS * G * kDh; i += kK2Threads) part[i] = 0.f;

  int item = 0;
  // ---- scores: s = scale q.k for the chunk's keys, all G rows
  for (int t = 0; t < n_tiles; ++t, ++item) {
    cp_async_wait<C::kRing - 1>();
    __syncthreads();
    const unsigned char* tile = ring + (size_t)(item % C::kRing) * kK2Tile * C::kRowBytes;
    const int nk = min(kK2Tile, n_c - t * kK2Tile);
    if constexpr (kMma)
      scores_mma(sc, cs, qs, tile, nk, t * kK2Tile, G, scale);
    else
      scores_fma<T>(sc, cs, qs, tile, nk, t * kK2Tile, G, scale);
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
    const unsigned char* tile = ring + (size_t)(item % C::kRing) * kK2Tile * C::kRowBytes;
    const int nk = min(kK2Tile, n_c - t * kK2Tile);
    if constexpr (kMma)
      pv_mma(part, sc, cs, tile, nk, t * kK2Tile, G);
    else
      pv_fma<T>(part, sc, cs, tile, nk, t * kK2Tile, G);
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
  for (int e = rank * kK2Threads + tid; e < G * kDh; e += split * kK2Threads) {
    float s = 0.f;
    for (int r = 0; r < split; ++r) s += cluster.map_shared_rank(part, r)[e];
    out[((size_t)b * G + e / kDh) * d + (size_t)h * kDh + e % kDh] = from_f<T>(s);
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

// ---------------------------------------------------------------- K1 ------

// 8 warps: on an H100 over 32 windows, 0.044 ms against 0.047 with 4 (0.058
// against 0.075 at group 16)
constexpr int kK1Threads = 256;
constexpr int kK1Warps = kK1Threads / 32;
constexpr int kK1ColBlocks = kDh / 8 / kK1Warps;  // 8-column blocks of the output a warp owns
constexpr int kK1Tile = 128;                 // keys a staged tile holds
constexpr int kK1Ring = 4;                   // tiles in flight
constexpr int kK1Rows = 16;                  // query rows a CTA takes: the M of an mma
constexpr int kK1MaxSplit = 8;               // CTAs a cluster: the portable limit
constexpr int kK1Row = kDh + 16;             // 80 bytes: a staged int8 row, off the banks
constexpr int kK1Slot = kK1Tile * kK1Row + 2 * kK1Tile * 4;  // the rows, then the k and v scales of a K tile
constexpr int kK1VtRow = kK1Tile + 16;       // 144 bytes: a column of the transposed V tile

// shared memory of a K1 CTA: the ring, the transposed V tile, q in int8,
// the scores of a block (fp32), its int8 p (16 rows, padded), the block's
// v scales and the row statistics (m, l, correction, p step, q step)
__host__ __device__ __forceinline__ int k1_score_stride(int tk_blk) { return tk_blk + 4; }
__host__ __device__ __forceinline__ int k1_p_stride(int tk_blk) { return tk_blk + 16; }
size_t k1_smem_bytes(int rows, int tk_blk) {
  return (size_t)kK1Ring * kK1Slot + (size_t)kDh * kK1VtRow + (size_t)kK1Rows * kK1Row +
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
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
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
// [x * nb / S, (x + 1) * nb / S) of the nb blocks that hold valid keys
template <typename TQ>
__global__ void __launch_bounds__(kK1Threads)
decode_attn_i8_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ cache_k,
                      const float* __restrict__ k_scale, const int8_t* __restrict__ cache_v,
                      const float* __restrict__ v_scale, TQ* __restrict__ out, int layer, int batch, int group,
                      int tk, int d, int tk_blk, int n_valid, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int n_rc = (group + kK1Rows - 1) / kK1Rows;
  const int h = blockIdx.y, b = blockIdx.z / n_rc, g0 = (blockIdx.z % n_rc) * kK1Rows;
  const int RC = min(kK1Rows, group - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int scs = k1_score_stride(tk_blk), pis = k1_p_stride(tk_blk);

  unsigned char* ring = smem;
  int8_t* vt = reinterpret_cast<int8_t*>(ring + kK1Ring * kK1Slot);
  int8_t* qi = vt + kDh * kK1VtRow;
  float* sc = reinterpret_cast<float*>(qi + kK1Rows * kK1Row);
  int8_t* pi = reinterpret_cast<int8_t*>(sc + RC * scs);
  float* vsb = reinterpret_cast<float*>(pi + kK1Rows * pis);
  float* m_s = vsb + tk_blk;
  float* l_s = m_s + kK1Rows;
  float* corr_s = l_s + kK1Rows;
  float* sp_s = corr_s + kK1Rows;
  float* qsc = sp_s + kK1Rows;
  float* part = sc;  // the partial outputs (RC x 64) once the scores are done

  const int n_blocks = (n_valid + tk_blk - 1) / tk_blk;
  const int blk_lo = rank * n_blocks / split, blk_hi = (rank + 1) * n_blocks / split;
  const int T = tk_blk / kK1Tile;  // tiles of a whole block
  const int key_hi = min(blk_hi * tk_blk, n_valid);
  const int t_last = blk_hi > blk_lo ? (key_hi - (blk_hi - 1) * tk_blk + kK1Tile - 1) / kK1Tile : 0;
  const int n_items = blk_hi > blk_lo ? 2 * T * (blk_hi - blk_lo - 1) + 2 * t_last : 0;
  const size_t row = (size_t)layer * batch + b;
  const int8_t* kb = cache_k + row * tk * d + (size_t)h * kDh;
  const int8_t* vb = cache_v + row * tk * d + (size_t)h * kDh;
  const float* ksb = k_scale + row * tk;
  const float* vsg = v_scale + row * tk;

  // the loads in order: per block its K tiles (with the k and v scales),
  // then its V tiles; item i goes to ring slot i % kK1Ring, and every item
  // commits one group (empty past the end) so that wait_group counts stay
  // fixed. Keys at or past n_valid are never read.
  auto item_at = [&](int i, int& j0, int& nk, bool& is_v) {
    const int rel = i / (2 * T), blk = blk_lo + rel;
    const int nt = blk == blk_hi - 1 ? t_last : T;
    const int w = i - rel * 2 * T;
    is_v = w >= nt;
    j0 = blk * tk_blk + (is_v ? w - nt : w) * kK1Tile;
    nk = min(kK1Tile, n_valid - j0);
  };
  auto load_item = [&](int i) {
    if (i < n_items) {
      int j0, nk;
      bool is_v;
      item_at(i, j0, nk, is_v);
      unsigned char* dst = ring + (size_t)(i % kK1Ring) * kK1Slot;
      const int8_t* src = (is_v ? vb : kb) + (size_t)j0 * d;
      for (int e = tid; e < nk * (kDh / 16); e += kK1Threads)
        cp_async16(dst + (e / 4) * kK1Row + (e % 4) * 16, src + (size_t)(e / 4) * d + (e % 4) * 16);
      if (!is_v) {
        float* dsc = reinterpret_cast<float*>(dst + kK1Tile * kK1Row);
        for (int e = tid; e < 2 * nk; e += kK1Threads) {  // 4 bytes a key: no scale past n_valid is read
          const int j = e % nk;
          cp_async4(dsc + (e / nk) * kK1Tile + j, (e < nk ? ksb : vsg) + j0 + j);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kK1Ring; ++i) load_item(i);

  // quantize q per (row, head): abs-max step, round half to even
  for (int r = warp; r < RC; r += kK1Warps) {
    const TQ* qr = q + ((size_t)b * group + g0 + r) * d + (size_t)h * kDh;
    const float x0 = to_f(qr[lane]), x1 = to_f(qr[lane + 32]);
    const float sq = fmaxf(warp_reduce<true>(fmaxf(fabsf(x0), fabsf(x1))), 1e-20f) / 127.f;
    qi[r * kK1Row + lane] = (int8_t)rintf(x0 / sq);
    qi[r * kK1Row + lane + 32] = (int8_t)rintf(x1 / sq);
    if (lane == 0) {
      qsc[r] = sq * scale;
      m_s[r] = kNegInf;
      l_s[r] = 0.f;
    }
  }
  __syncthreads();
  // q as the A fragments of the two k32 steps (rows past RC are zero)
  uint32_t qa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    qa[ks][0] = g < RC ? ld_u32(qi + g * kK1Row + 32 * ks + 4 * t4) : 0u;
    qa[ks][1] = g + 8 < RC ? ld_u32(qi + (g + 8) * kK1Row + 32 * ks + 4 * t4) : 0u;
    qa[ks][2] = g < RC ? ld_u32(qi + g * kK1Row + 32 * ks + 16 + 4 * t4) : 0u;
    qa[ks][3] = g + 8 < RC ? ld_u32(qi + (g + 8) * kK1Row + 32 * ks + 16 + 4 * t4) : 0u;
  }
  // this warp's output columns: the 8-column blocks kK1ColBlocks x warp + n
  float acc[kK1ColBlocks][4] = {};

  int item = 0;
  for (int blk = blk_lo; blk < blk_hi; ++blk) {
    const int kb0 = blk * tk_blk, n_k = min(tk_blk, n_valid - kb0);
    const int nt = (n_k + kK1Tile - 1) / kK1Tile;
    // ---- scores s = (s32 x q step x scale) x k scale of the block's keys, all rows
    for (int t = 0; t < nt; ++t, ++item) {
      cp_async_wait<kK1Ring - 1>();
      __syncthreads();
      const unsigned char* slot = ring + (size_t)(item % kK1Ring) * kK1Slot;
      const float* ks_t = reinterpret_cast<const float*>(slot + kK1Tile * kK1Row);
      const int j0 = t * kK1Tile, nk = min(kK1Tile, n_k - j0);
      for (int n8 = warp; n8 * 8 < nk; n8 += kK1Warps) {
        int c[4] = {0, 0, 0, 0};
        const int8_t* kr = reinterpret_cast<const int8_t*>(slot) + (n8 * 8 + g) * kK1Row + 4 * t4;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) mma_s8(c, qa[ks], ld_u32(kr + 32 * ks), ld_u32(kr + 32 * ks + 16));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = g + 8 * (e >> 1), key = n8 * 8 + 2 * t4 + (e & 1);
          if (r < RC && key < nk) sc[r * scs + j0 + key] = __fmul_rn(__fmul_rn((float)c[e], qsc[r]), ks_t[key]);
        }
      }
      for (int j = tid; j < nk; j += kK1Threads) vsb[j0 + j] = ks_t[kK1Tile + j];
      __syncthreads();  // the slot is free again
      load_item(item + kK1Ring);
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
      cp_async_wait<kK1Ring - 1>();
      __syncthreads();  // also orders the softmax above before the first tile
      const unsigned char* slot = ring + (size_t)(item % kK1Ring) * kK1Slot;
      const int j0 = t * kK1Tile, nk = min(kK1Tile, n_k - j0);
      for (int e = tid; e < ((nk + 3) / 4) * (kDh / 4); e += kK1Threads) {
        const int k4 = e / (kDh / 4), c4 = e % (kDh / 4);
        const unsigned char* src = slot + 4 * k4 * kK1Row + 4 * c4;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(src);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(src + kK1Row);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(src + 2 * kK1Row);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(src + 3 * kK1Row);
        const uint32_t lo01 = __byte_perm(w0, w1, 0x5140), hi01 = __byte_perm(w0, w1, 0x7362);
        const uint32_t lo23 = __byte_perm(w2, w3, 0x5140), hi23 = __byte_perm(w2, w3, 0x7362);
        int8_t* dst = vt + 4 * c4 * kK1VtRow + 4 * k4;
        *reinterpret_cast<uint32_t*>(dst) = __byte_perm(lo01, lo23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + kK1VtRow) = __byte_perm(lo01, lo23, 0x7632);
        *reinterpret_cast<uint32_t*>(dst + 2 * kK1VtRow) = __byte_perm(hi01, hi23, 0x5410);
        *reinterpret_cast<uint32_t*>(dst + 3 * kK1VtRow) = __byte_perm(hi01, hi23, 0x7632);
      }
      __syncthreads();
      for (int k32 = 0; k32 < nk; k32 += 32) {
        const int8_t* p0 = pi + j0 + k32 + 4 * t4;
        uint32_t pa[4];
        pa[0] = g < RC ? ld_u32(p0 + g * pis) : 0u;
        pa[1] = g + 8 < RC ? ld_u32(p0 + (g + 8) * pis) : 0u;
        pa[2] = g < RC ? ld_u32(p0 + g * pis + 16) : 0u;
        pa[3] = g + 8 < RC ? ld_u32(p0 + (g + 8) * pis + 16) : 0u;
#pragma unroll
        for (int n = 0; n < kK1ColBlocks; ++n) {
          const int8_t* vc = vt + ((kK1ColBlocks * warp + n) * 8 + g) * kK1VtRow + k32 + 4 * t4;
          mma_s8(o[n], pa, ld_u32(vc), ld_u32(vc + 16));
        }
      }
      __syncthreads();
      load_item(item + kK1Ring);
    }
    // acc = acc x correction + o x sp, rounded as the plain version
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
#pragma unroll
  for (int n = 0; n < kK1ColBlocks; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e >> 1);
      if (r < RC) part[r * kDh + (kK1ColBlocks * warp + n) * 8 + 2 * t4 + (e & 1)] = acc[n][e];
    }
  cluster.sync();
  for (int e = rank * kK1Threads + tid; e < RC * kDh; e += split * kK1Threads) {
    const int r = e / kDh;
    float m = kNegInf;
    for (int c = 0; c < split; ++c) m = fmaxf(m, cluster.map_shared_rank(m_s, c)[r]);
    float l = 0.f, a = 0.f;
    for (int c = 0; c < split; ++c) {
      const float f = expf(cluster.map_shared_rank(m_s, c)[r] - m);
      l += cluster.map_shared_rank(l_s, c)[r] * f;
      a += cluster.map_shared_rank(part, c)[e] * f;
    }
    out[((size_t)b * group + g0 + r) * d + (size_t)h * kDh + e % kDh] = from_f<TQ>(a / (l == 0.f ? 1.f : l));
  }
  cluster.sync();  // no CTA leaves while a peer still reads its shared memory
}

// lifts a kernel's dynamic shared memory limit to `bytes` on the current
// device once, not on every launch (the call costs host time a decode step
// does not have)
template <typename Kernel>
cudaError_t raise_smem_limit(Kernel kernel, size_t bytes) {
  constexpr int kMaxDevices = 64;
  static size_t lifted[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && lifted[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && dev < kMaxDevices) lifted[dev] = bytes;
  return err;
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v, void* out, int layer, int n_layer, int batch,
                  int group, int tk, int d, int n_head, int valid_upto, int split, float scale, void* stream) {
  if (d != n_head * kDh || tk < 1 || layer < 0 || layer >= n_layer || batch < 1 || group < 1 || split < 1 ||
      split > kK2MaxSplit)
    return (int)cudaErrorInvalidValue;
  const int n_valid = valid_upto < 0 ? tk : min(valid_upto + 1, tk);
  const int chunk = (n_valid + split - 1) / split;
  const size_t smem = k2_smem_bytes<T>(group, chunk);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit(decode_attn_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_head, batch);
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
  err = cudaLaunchKernelEx(&cfg, decode_attn_kernel<T>, static_cast<const T*>(q), static_cast<const T*>(k),
                           static_cast<const T*>(v), static_cast<T*>(out), layer, batch, group, tk, d, n_valid,
                           chunk, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ>
int launch_decode_i8(const void* q, const void* k, const void* ks, const void* v, const void* vs, void* out,
                     int layer, int n_layer, int batch, int group, int tk, int d, int n_head, int tk_blk,
                     int valid_upto, int split, float scale, void* stream) {
  if (d != n_head * kDh || group < 1 || tk_blk < kK1Tile || tk_blk > kMaxBlock || tk_blk % kK1Tile != 0 ||
      tk % tk_blk != 0 || layer < 0 || layer >= n_layer || batch < 1 || split < 1 || split > kK1MaxSplit)
    return (int)cudaErrorInvalidValue;
  const int n_valid = valid_upto < 0 ? tk : min(valid_upto + 1, tk);
  const size_t smem = k1_smem_bytes(min(group, kK1Rows), tk_blk);
  cudaError_t err = raise_smem_limit(decode_attn_i8_kernel<TQ>, smem);
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
  err = cudaLaunchKernelEx(&cfg, decode_attn_i8_kernel<TQ>, static_cast<const TQ*>(q), static_cast<const int8_t*>(k),
                           static_cast<const float*>(ks), static_cast<const int8_t*>(v),
                           static_cast<const float*>(vs), static_cast<TQ*>(out), layer, batch, group, tk, d, tk_blk,
                           n_valid, scale);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `split` is the cluster size S (1, 2, 4 or 8; `k2_plan`)
extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v, void* out, int layer, int n_layer,
                                int batch, int group, int tk, int d, int n_head, int valid_upto, int split,
                                float scale, void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto,
                                      split, scale, stream);
}

extern "C" int decode_attn_f32(const void* q, const void* k, const void* v, void* out, int layer, int n_layer,
                               int batch, int group, int tk, int d, int n_head, int valid_upto, int split,
                               float scale, void* stream) {
  return launch_decode<float>(q, k, v, out, layer, n_layer, batch, group, tk, d, n_head, valid_upto, split, scale,
                              stream);
}

// `split` is the cluster size S (1-8; `k1_plan`)
extern "C" int decode_attn_i8_bf16(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                                   void* out, int layer, int n_layer, int batch, int group, int tk, int d,
                                   int n_head, int tk_blk, int valid_upto, int split, float scale, void* stream) {
  return launch_decode_i8<__nv_bfloat16>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head,
                                         tk_blk, valid_upto, split, scale, stream);
}

extern "C" int decode_attn_i8_f32(const void* q, const void* k, const void* ks, const void* v, const void* vs,
                                  void* out, int layer, int n_layer, int batch, int group, int tk, int d,
                                  int n_head, int tk_blk, int valid_upto, int split, float scale, void* stream) {
  return launch_decode_i8<float>(q, k, ks, v, vs, out, layer, n_layer, batch, group, tk, d, n_head, tk_blk,
                                 valid_upto, split, scale, stream);
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
