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
// Rows of bf16, fp16 or fp32 (a template parameter: 8, 8 or 4 values a
// 16-byte load); an fp16 row holds -inf where the logit filters fill it.
//
// Order, as lax.top_k: value descending, ties to the lowest index, a value
// that occurs several times is listed as often as it occurs. Empty slots are
// (-inf, INT_MAX), so a real -inf entry (a suppressed logit) beats them and
// rows with fewer than k finite values still return the lowest -inf indices.
//
// What bounds it on the H100: memory, 160 x 51865 bf16 = 16.6 MB at base
// with 32 windows x 5 beams (5.0 us at 3.35 TB/s), with a compare and, for
// K9, one exp an element. Most launches on the paths are smaller: one
// window's 5 beams (5 rows) in the CLI, 80 rows in batch mode. In practice
// the scan is bound by each warp's chain of dependent instructions a round
// (a CTA or two an SM at these row counts): measured, the loads with the
// exps and without the selection take ~60% of the time at 160 rows.
//
// Design: each row is split across a thread-block cluster of S CTAs (grid
// (S, rows), cluster (S, 1, 1); S from `k9_plan` in ops/topk.py, up to 16
// with the non-portable cluster size), so that the CLI's 5 rows still fill
// the card. CTA r of the cluster streams the contiguous slice [r * chunk,
// min(V, (r + 1) * chunk)) of the row:
//   - 256 threads walk the slice in rounds of kUnroll 16-byte loads each
//     (its unaligned head and tail one element at a time), double-buffered
//     in registers. Each round takes its max first (a tree), then keeps an
//     online (max, sum of exp) in the exp2 domain (one MUFU.EX2 an element,
//     summed as trees).
//   - Selection: each thread keeps its best KMAX (key, index) pairs, sorted,
//     in registers (KMAX = 8 or 32, at least k). Keys are the values as
//     ordered integers, 0 for an empty slot; a thread meets its entries in
//     index order, so an insertion compares keys only. A thread's own list
//     is a weak filter (about KMAX ln(n / KMAX) of its n entries would be
//     inserted), so every kRefresh rounds the warp takes the k-th largest of
//     its lanes' round maxima: k lanes hold an entry at least that good, so
//     nothing below it is in the row's top k. Only a round whose max reaches
//     it looks at its elements.
//   - The CTA merges its lists once: a butterfly of bitonic merges over the
//     warp's lanes (shuffles), then one over the 8 warp lists.
//   - The cluster's CTAs leave their (m, s) and their best KMAX pairs in
//     shared memory; rank 0 reads them through distributed shared memory,
//     merges the lists by the same butterfly and combines m = max m_c and
//     s = sum_c s_c * exp(m_c - m) in rank order, so the result is
//     deterministic. Slices are contiguous index ranges, so the order of
//     ties holds across slice boundaries.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // 16-byte loads a thread per round, and as many more in flight
constexpr int kRefresh = 4;    // rounds between two refreshes of the warp's threshold
constexpr int kMaxSplit = 16;  // CTAs a cluster (above 8: the non-portable size)
constexpr float kLog2e = 1.4426950408889634f;

// Values are ranked as ordered 32-bit keys: key(a) > key(b) iff a > b for
// floats, -inf has a key above 0, and 0 marks an empty slot, so that a real
// -inf entry beats it by the key alone.
__device__ __forceinline__ unsigned to_key(float x) {
  const unsigned b = __float_as_uint(x);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ bool better(unsigned ak, int ai, unsigned bk, int bi) {
  return ak > bk || (ak == bk && ai < bi);
}

// (m, s) of two partial rows merged: max and rescaled sum of exp(x - max)
__device__ __forceinline__ void merge_lse(float& m, float& s, float om, float os) {
  const float nm = fmaxf(m, om);
  if (nm == -INFINITY) return;  // both empty (all -inf so far)
  s = s * expf(m - nm) + os * expf(om - nm);
  m = nm;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// element q of a 16-byte vector of T, by register selects (no local memory)
__device__ __forceinline__ unsigned word(const uint4& u, int w) {
  return w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
}
__device__ __forceinline__ float pick(const uint4& u, int q, float) { return __uint_as_float(word(u, q)); }
__device__ __forceinline__ float pick(const uint4& u, int q, __nv_bfloat16) {
  const unsigned w = word(u, q >> 1);  // little-endian: element 2j is the low half of word j
  return __uint_as_float((q & 1) ? (w & 0xffff0000u) : (w << 16));
}
__device__ __forceinline__ float pick(const uint4& u, int q, __half) {  // fp16 -inf (0xfc00) gives -inf
  const unsigned w = word(u, q >> 1);
  return __half2float(__ushort_as_half((unsigned short)((q & 1) ? (w >> 16) : (w & 0xffffu))));
}

// one sorted list of KMAX (key, index) pairs in registers, best first
template <int KMAX>
struct TopList {
  unsigned v[KMAX];
  int i[KMAX];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      v[j] = 0u;
      i[j] = INT_MAX;
    }
  }

  // insertion of an entry whose index is above every index in the list (a
  // thread meets its entries in index order), so the key alone decides;
  // branch-free, each slot from its old value and its neighbour's
  __device__ __forceinline__ void insert_later(unsigned key, int idx) {
    bool above = key > v[KMAX - 1];
#pragma unroll
    for (int j = KMAX - 1; j > 0; --j) {
      const bool above_prev = key > v[j - 1];
      const unsigned nv = above_prev ? v[j - 1] : (above ? key : v[j]);
      const int ni = above_prev ? i[j - 1] : (above ? idx : i[j]);
      v[j] = nv;
      i[j] = ni;
      above = above_prev;
    }
    if (above) {
      v[0] = key;
      i[0] = idx;
    }
  }

  // keep the best KMAX of this list and lane (lane ^ off)'s: the partner's
  // list reversed against ours gives, pair by pair, the better of the two, a
  // bitonic sequence holding the union's best KMAX; a bitonic merge sorts it.
  // Both lanes end with the same list.
  __device__ __forceinline__ void merge_lane(int off) {
    // slots j and KMAX - 1 - j together, so that each shuffle sends an
    // unmerged slot
#pragma unroll
    for (int j = 0; j < KMAX / 2; ++j) {
      const int r = KMAX - 1 - j;
      const unsigned ov_r = __shfl_xor_sync(0xffffffffu, v[r], off);  // the partner's slot r, against our j
      const int oi_r = __shfl_xor_sync(0xffffffffu, i[r], off);
      const unsigned ov_j = __shfl_xor_sync(0xffffffffu, v[j], off);  // the partner's slot j, against our r
      const int oi_j = __shfl_xor_sync(0xffffffffu, i[j], off);
      if (better(ov_r, oi_r, v[j], i[j])) {
        v[j] = ov_r;
        i[j] = oi_r;
      }
      if (better(ov_j, oi_j, v[r], i[r])) {
        v[r] = ov_j;
        i[r] = oi_j;
      }
    }
#pragma unroll
    for (int half = KMAX / 2; half > 0; half >>= 1) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if ((j & half) == 0 && better(v[j + half], i[j + half], v[j], i[j])) {
          const unsigned tv = v[j];
          const int ti = i[j];
          v[j] = v[j + half];
          i[j] = i[j + half];
          v[j + half] = tv;
          i[j + half] = ti;
        }
      }
    }
  }

  __device__ __forceinline__ void load(const unsigned* sv, const int* si) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      v[j] = sv[j];
      i[j] = si[j];
    }
  }

  __device__ __forceinline__ void store(unsigned* sv, int* si) const {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      sv[j] = v[j];
      si[j] = i[j];
    }
  }
};

// element q of a round of U vectors of T (vector q / kVec), by selects
template <typename T, int U>
__device__ __forceinline__ float pick_round(const uint4 (&u)[U], int q) {
  constexpr int kVec = 16 / sizeof(T);
  uint4 w = u[0];
#pragma unroll
  for (int r = 1; r < U; ++r) w = (q / kVec == r) ? u[r] : w;
  return pick(w, q % kVec, T());
}

// the k-th largest of the warp's 32 keys (k <= 32, at run time): the max,
// k - 1 times taken out (one lane at a time, so that equal keys count each)
__device__ __forceinline__ unsigned warp_kth_largest(unsigned key, int k, int lane) {
  for (int r = 1; r < k; ++r) {
    const unsigned top = __reduce_max_sync(0xffffffffu, key);
    const unsigned holders = __ballot_sync(0xffffffffu, key == top);
    if (lane == __ffs(holders) - 1) key = 0u;
  }
  return __reduce_max_sync(0xffffffffu, key);
}

template <int KMAX, bool LOGSM>
struct SliceState {
  TopList<KMAX> top;
  unsigned thr = 0u;    // entries with a smaller key cannot be in the row's top k
  float m = -INFINITY;  // running max
  float s = 0.f;        // sum of exp(x - m)

  // one value (the slice's head and tail)
  __device__ __forceinline__ void visit(float x, int idx) {
    if (LOGSM && x != -INFINITY) {
      if (x > m) {
        s *= ex2((m - x) * kLog2e);
        m = x;
      }
      s += ex2((x - m) * kLog2e);
    }
    const unsigned key = to_key(x);
    if (key >= thr) top.insert_later(key, idx);
  }

  // one round: U 16-byte vectors of T, vector r at index base + r * stride
  // when valid[r]. The round's max first (for the exp sum and the filter),
  // then the exps as trees, then, only when the max reaches the threshold,
  // the elements that do. The whole warp calls it together.
  template <typename T, int U>
  __device__ __forceinline__ void visit_round(const uint4 (&u)[U], const bool (&valid)[U], int base, int stride,
                                              int k, int lane, bool refresh) {
    constexpr int kVec = 16 / sizeof(T);
    float vmax[U];
    float cm = -INFINITY;
#pragma unroll
    for (int r = 0; r < U; ++r) {
      float x = pick(u[r], 0, T());
#pragma unroll
      for (int q = 1; q < kVec; ++q) x = fmaxf(x, pick(u[r], q, T()));
      vmax[r] = valid[r] ? x : -INFINITY;
      cm = fmaxf(cm, vmax[r]);
    }
    if (LOGSM && cm != -INFINITY) {
      if (cm > m) {
        s *= ex2((m - cm) * kLog2e);  // 0 while m is -inf (s is 0 then too)
        m = cm;
      }
      float part[U];
#pragma unroll
      for (int r = 0; r < U; ++r) {
        float t[kVec];
#pragma unroll
        for (int q = 0; q < kVec; ++q) t[q] = ex2((pick(u[r], q, T()) - m) * kLog2e);  // -inf gives 0
#pragma unroll
        for (int w = 1; w < kVec; w *= 2) {
#pragma unroll
          for (int q = 0; q + w < kVec; q += 2 * w) t[q] += t[q + w];
        }
        part[r] = valid[r] ? t[0] : 0.f;
      }
#pragma unroll
      for (int w = 1; w < U; w *= 2) {
#pragma unroll
        for (int r = 0; r + w < U; r += 2 * w) part[r] += part[r + w];
      }
      s += part[0];
    }
    // k lanes each hold an entry at least as good as the k-th largest lane
    // max, so nothing below it is in the row's top k. The reduction is a
    // chain of 2k warp collectives, so it runs in every kRefresh-th round
    // only; the threshold stays valid in between
    const bool any = valid[0];
    if (refresh) thr = max(thr, warp_kth_largest(any ? to_key(cm) : 0u, k, lane));
    const unsigned bar = max(thr, top.v[KMAX - 1] + 1u);  // below it, no element enters the list usefully
    if (!any || to_key(cm) < bar) return;
    unsigned hit = 0;  // element q of the round at bit q
#pragma unroll
    for (int r = 0; r < U; ++r) {
      if (valid[r] && to_key(vmax[r]) >= bar) {
#pragma unroll
        for (int q = 0; q < kVec; ++q) hit |= (unsigned)(to_key(pick(u[r], q, T())) >= bar) << (r * kVec + q);
      }
    }
    while (hit) {  // rare once the threshold has risen
      const int q = __ffs(hit) - 1;
      hit &= hit - 1;
      top.insert_later(to_key(pick_round<T, U>(u, q)), base + (q / kVec) * stride + q % kVec);
    }
  }
};

template <int KMAX>
struct Shared {
  unsigned warp_v[kWarps][KMAX];
  int warp_i[kWarps][KMAX];
  float warp_m[kWarps];
  float warp_s[kWarps];
  unsigned cta_v[KMAX];  // the CTA's result, read by rank 0 of the cluster
  int cta_i[KMAX];
  float cta_m;
  float cta_s;
};

template <typename T, int KMAX, bool LOGSM>
__global__ void __launch_bounds__(kThreads, KMAX <= 8 ? 2 : 1)
topk_rows_kernel(const T* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, int rows, int v, int k,
                 int chunk) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ Shared<KMAX> sh;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = min(v, rank * chunk), hi = min(v, lo + chunk);

  for (int row = blockIdx.y; row < rows; row += gridDim.y) {
    const T* xs = x + (size_t)row * v + lo;
    const int len = hi - lo;
    SliceState<KMAX, LOGSM> st;
    st.top.clear();

    // the slice's elements before its first 16-byte boundary, the vector
    // body, and the tail
    const int head = min(len, (int)(((16u - (reinterpret_cast<uintptr_t>(xs) & 15u)) & 15u) / sizeof(T)));
    const int n_vec = (len - head) / kVec;
    const int tail = head + n_vec * kVec;
    for (int t = tid; t < head; t += kThreads) st.visit(to_float(xs[t]), lo + t);

    // the body in rounds of kUnroll vectors a thread; the next round's loads
    // are in flight while this one is scanned. The round count is the same
    // across a warp (`j0` is the warp's first vector), which shares its
    // threshold in each round
    const uint4* body = reinterpret_cast<const uint4*>(xs + head);
    const int j_warp = tid - lane;
    uint4 cur[kUnroll];
#pragma unroll
    for (int r = 0; r < kUnroll; ++r)
      if (tid + r * kThreads < n_vec) cur[r] = __ldcs(body + tid + r * kThreads);
    for (int j0 = j_warp; j0 < n_vec; j0 += kUnroll * kThreads) {
      const int j = j0 + lane;
      uint4 nxt[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) {
        const int jn = j + (kUnroll + r) * kThreads;
        if (jn < n_vec) nxt[r] = __ldcs(body + jn);
      }
      bool valid[kUnroll];
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) valid[r] = j + r * kThreads < n_vec;
      st.template visit_round<T, kUnroll>(cur, valid, lo + head + j * kVec, kThreads * kVec, k, lane,
                                          (j0 / (kUnroll * kThreads)) % kRefresh == 0);
#pragma unroll
      for (int r = 0; r < kUnroll; ++r) cur[r] = nxt[r];
    }
    for (int t = tail + tid; t < len; t += kThreads) st.visit(to_float(xs[t]), lo + t);

    // ---- the CTA: (m, s) over the warps in a fixed order; the lists by a
    // butterfly in each warp, then over the warps' lists in warp 0
    float m = st.m, s = st.s;
    if (LOGSM) {
#pragma unroll
      for (int off = 16; off; off >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, off);
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        merge_lse(m, s, om, os);
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) st.top.merge_lane(off);
    if (lane == 0) {
      st.top.store(sh.warp_v[warp], sh.warp_i[warp]);
      sh.warp_m[warp] = m;
      sh.warp_s[warp] = s;
    }
    __syncthreads();
    if (warp == 0) {
      TopList<KMAX> top;
      if (lane < kWarps)
        top.load(sh.warp_v[lane], sh.warp_i[lane]);
      else
        top.clear();
#pragma unroll
      for (int off = 1; off < kWarps; off <<= 1) top.merge_lane(off);
      if (lane == 0) {
        m = sh.warp_m[0];
        s = sh.warp_s[0];
        for (int w = 1; w < kWarps; ++w) merge_lse(m, s, sh.warp_m[w], sh.warp_s[w]);
        if (split > 1) {
          top.store(sh.cta_v, sh.cta_i);
          sh.cta_m = m;
          sh.cta_s = s;
        }
      }
      if (split == 1 && lane == 0) {
        const float lse = logf(s);
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (j < k) {
            const float x_sel = from_key(top.v[j]);
            vals[(size_t)row * k + j] = LOGSM ? (x_sel - m) - lse : x_sel;
            idx[(size_t)row * k + j] = top.i[j];
          }
        }
      }
    }

    // ---- the cluster: rank 0 merges the CTAs' lists and (m, s) through
    // distributed shared memory, in rank order
    if (split > 1) {
      cluster.sync();
      if (rank == 0 && warp == 0) {
        TopList<KMAX> top;
        float cm = -INFINITY, cs = 0.f;
        if (lane < split) {
          top.load(cluster.map_shared_rank(sh.cta_v, lane), cluster.map_shared_rank(sh.cta_i, lane));
          cm = *cluster.map_shared_rank(&sh.cta_m, lane);
          cs = *cluster.map_shared_rank(&sh.cta_s, lane);
        } else {
          top.clear();
        }
#pragma unroll
        for (int off = 1; off < kMaxSplit; off <<= 1) top.merge_lane(off);
        float rm = -INFINITY, rs = 0.f;
        if (LOGSM) {
          for (int r = 0; r < split; ++r) rm = fmaxf(rm, __shfl_sync(0xffffffffu, cm, r));
          const float term = (rm == -INFINITY || cm == -INFINITY) ? 0.f : cs * expf(cm - rm);
          for (int r = 0; r < split; ++r) rs += __shfl_sync(0xffffffffu, term, r);
        }
        if (lane == 0) {
          const float lse = logf(rs);
#pragma unroll
          for (int j = 0; j < KMAX; ++j) {
            if (j < k) {
              const float x_sel = from_key(top.v[j]);
              vals[(size_t)row * k + j] = LOGSM ? (x_sel - rm) - lse : x_sel;
              idx[(size_t)row * k + j] = top.i[j];
            }
          }
        }
      }
      cluster.sync();  // no CTA leaves, or refills its lists, while rank 0 still reads them
    } else {
      __syncthreads();  // warp 0 is done with the warp lists before the next row
    }
  }
}

template <typename T, int KMAX, bool LOGSM>
cudaError_t launch_kernel(const T* x, float* vals, int* idx, int rows, int v, int k, int split, cudaStream_t s) {
  auto kernel = topk_rows_kernel<T, KMAX, LOGSM>;
  if (split > 8) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  const int chunk = (v + split - 1) / split;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, min(rows, 65535));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, vals, idx, rows, v, k, chunk);
}

template <typename T, bool LOGSM>
int launch(const void* x, float* vals, int* idx, int rows, int v, int k, int split, void* stream) {
  // every slice [r * chunk, (r + 1) * chunk) must be non-empty
  if (rows <= 0 || v <= 0 || k < 1 || k > 32 || k > v || split < 1 || split > kMaxSplit ||
      (split - 1) * ((v + split - 1) / split) >= v)
    return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = k <= 8 ? launch_kernel<T, 8, LOGSM>(xt, vals, idx, rows, v, k, split, s)
                                 : launch_kernel<T, 32, LOGSM>(xt, vals, idx, rows, v, k, split, s);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// `split` is the cluster size S (1-16; `k9_plan`)
extern "C" int topk_logprobs_bf16(const void* x, float* vals, int* idx, int rows, int v, int k, int split,
                                  void* stream) {
  return launch<__nv_bfloat16, true>(x, vals, idx, rows, v, k, split, stream);
}

// fp16 rows (an fp16 model's beam step): the same kernel over 8 values a 16-byte load
extern "C" int topk_logprobs_f16(const void* x, float* vals, int* idx, int rows, int v, int k, int split,
                                 void* stream) {
  return launch<__half, true>(x, vals, idx, rows, v, k, split, stream);
}

extern "C" int topk_logprobs_f32(const void* x, float* vals, int* idx, int rows, int v, int k, int split,
                                 void* stream) {
  return launch<float, true>(x, vals, idx, rows, v, k, split, stream);
}

extern "C" int topk_bf16(const void* x, float* vals, int* idx, int rows, int v, int k, int split, void* stream) {
  return launch<__nv_bfloat16, false>(x, vals, idx, rows, v, k, split, stream);
}

extern "C" int topk_f16(const void* x, float* vals, int* idx, int rows, int v, int k, int split, void* stream) {
  return launch<__half, false>(x, vals, idx, rows, v, k, split, stream);
}

extern "C" int topk_f32(const void* x, float* vals, int* idx, int rows, int v, int k, int split, void* stream) {
  return launch<float, false>(x, vals, idx, rows, v, k, split, stream);
}

// The largest cluster the card schedules for these kernels (16 where the
// non-portable size is allowed, else 8 or less), or a negative CUDA error.
extern "C" int topk_max_split() {
  auto kernel = topk_rows_kernel<__nv_bfloat16, 32, true>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kMaxSplit, 1);
  cfg.blockDim = dim3(kThreads);
  int size = 0;
  err = cudaOccupancyMaxPotentialClusterSize(&size, kernel, &cfg);
  if (err != cudaSuccess) return -(int)err;
  return min(size, kMaxSplit);
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
