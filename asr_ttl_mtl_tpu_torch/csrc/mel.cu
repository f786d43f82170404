// K4: fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mel_kernel` (asr_ttl_mtl_tpu/ops/pallas_mel.py:44,
// entry `log_mel_spectrogram_pallas` :124). For each clip it frames the
// reflect-padded waveform (n_fft 400, hop 160), windows each frame with the
// periodic Hann window, takes the real DFT's bins 0..200, the power, the
// product with the mel filterbank, and log10(max(., 1e-10)). The per-clip
// max-8 clamp and (x+4)/4 stay outside, as in JAX.
//
// What bounds it on the H100: fp32 arithmetic. It must be true fp32 (TF32
// would lose the parity, see pallas_mel.py:55-58), so the tensor cores are
// out. The direct DFT, products with 400 x 201 cos and sin bases, is about
// 322k flops a frame; this kernel factors it instead (Cooley-Tukey, 400 =
// 20 x 20), about 31k flops a frame, with the frames and every intermediate
// in shared memory and registers. The waveform in and the mels out are
// about 2 KB and 0.3 KB a frame.
//
// Design: one CTA of 10 warps per (32-frame tile, clip); lane f of every
// warp works on frame f of the tile.
//   0. The tile's 5360-sample span goes to shared memory once, as rows of
//      160 samples padded to 161 words, so that 32 frames 160 samples apart
//      read 32 different banks.
//   1. With sample n = 20 n1 + n2 of the windowed frame: for each n2 (two a
//      warp), the real 20-point DFT over n1, Y[k1, n2] for k1 = 0..10 (the
//      others are conjugates), from sums and differences of the sample
//      pairs n1, 20 - n1; to shared memory.
//   2. For each k1 = 0..19 (two a warp): Z[n2] = Y[k1, n2] x W_400^(n2 k1),
//      then the complex 20-point DFT over n2 for k2 = 0..9 (and k2 = 10 at
//      k1 = 0), from the pairs n2, 20 - n2: bin k1 + 20 k2 and its power,
//      to shared memory. Bins 0..200, each once.
//   3. Each mel sums only its filter's nonzero bins [lo, hi) (at most two
//      filters share a bin), in bin order with no fused multiply-add, which
//      gives the bits of the dense product summed in bin order; log10; the
//      32 lanes write 32 consecutive frames.
// The 20-point DFTs' cos and sin values are 11 of each, held in registers;
// the window and the 400 twiddles sit in shared memory and are read as
// broadcasts (the index is the same across a warp).

#include <cuda_runtime.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kRow = kHop + 1;                   // a padded row of the span
constexpr int kFrames = 32;                      // frames a CTA: one a lane
constexpr int kWarps = 10;
constexpr int kThreads = 32 * kWarps;
constexpr int kSpan = (kFrames - 1) * kHop + kNFFT;  // 5360 samples
constexpr int kSpanPad = kSpan + kSpan / kHop + 1;   // padded words
constexpr int kBins = kNFFT / 2 + 1;             // 201
constexpr int kMaxMels = 128;
// constants: window (400), cos and sin of 2 pi m / 20 for m = 0..10 (11 + 11),
// twiddles W_400^(n2 k1) as re and im at [k1 * 20 + n2] (400 + 400)
constexpr int kWin = 0, kCos = 400, kSin = 411, kTwRe = 422, kTwIm = 822, kConsts = 1222;

struct Smem {
  float span[kSpanPad];
  float win[kNFFT];
  float tw_re[kNFFT];
  float tw_im[kNFFT];
  float y_re[11 * 20 * kFrames];  // Y[k1][n2][frame]
  float y_im[11 * 20 * kFrames];
  float power[kBins * kFrames];   // [bin][frame]
};

// cos and sin of 2 pi m / 20 for any m >= 0, from the 11 held values
struct Roots {
  float c[11], s[11];
  __device__ __forceinline__ float cos_(int m) const {
    m %= 20;
    return m <= 10 ? c[m] : c[20 - m];
  }
  __device__ __forceinline__ float sin_(int m) const {
    m %= 20;
    return m <= 10 ? s[m] : -s[20 - m];
  }
};

__global__ void __launch_bounds__(kThreads, 2)
log_mel_kernel(const float* __restrict__ audio,   // (B, padded_len)
               const float* __restrict__ consts,  // kConsts floats, see above
               const int* __restrict__ mel_lo,    // (n_mels) first nonzero bin of each filter
               const int* __restrict__ mel_hi,    // (n_mels) one past its last (lo == hi: empty)
               const int* __restrict__ mel_off,   // (n_mels) where its weights start in mel_w
               const float* __restrict__ mel_w,   // the nonzero weights, filter by filter, in bin order
               float* __restrict__ out,           // (B, n_mels, n_frames)
               int padded_len, int n_frames, int n_mels) {
  extern __shared__ float smem_raw[];
  Smem& sh = *reinterpret_cast<Smem*>(smem_raw);

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // ---- 0. the span, the window and the twiddles
  const float* src = audio + (size_t)b * padded_len + (size_t)t0 * kHop;
  const int avail = padded_len - t0 * kHop;
  for (int i = tid; i < kSpan; i += kThreads) sh.span[i + i / kHop] = i < avail ? __ldg(src + i) : 0.f;
  for (int i = tid; i < kNFFT; i += kThreads) {
    sh.win[i] = __ldg(consts + kWin + i);
    sh.tw_re[i] = __ldg(consts + kTwRe + i);
    sh.tw_im[i] = __ldg(consts + kTwIm + i);
  }
  Roots w;
#pragma unroll
  for (int m = 0; m < 11; ++m) {
    w.c[m] = __ldg(consts + kCos + m);
    w.s[m] = __ldg(consts + kSin + m);
  }
  __syncthreads();

  const int f = lane;
  const float* frame = sh.span + f * kRow;  // sample s of frame f at frame[s + s / 160]

  // ---- 1. real 20-point DFTs over n1, one for each n2
#pragma unroll 1
  for (int n2 = warp; n2 < 20; n2 += kWarps) {
    float xw[20];
#pragma unroll
    for (int n1 = 0; n1 < 20; ++n1) {
      const int s = 20 * n1 + n2;
      xw[n1] = frame[s + s / kHop] * sh.win[s];
    }
    float a[10], d[10];  // a[n1] = x[n1] + x[20 - n1], d[n1] = x[n1] - x[20 - n1], n1 = 1..9
#pragma unroll
    for (int n1 = 1; n1 < 10; ++n1) {
      a[n1] = xw[n1] + xw[20 - n1];
      d[n1] = xw[n1] - xw[20 - n1];
    }
#pragma unroll
    for (int k1 = 0; k1 <= 10; ++k1) {
      float re = (k1 & 1) ? xw[0] - xw[10] : xw[0] + xw[10];
      float im = 0.f;
#pragma unroll
      for (int n1 = 1; n1 < 10; ++n1) re = fmaf(a[n1], w.cos_(n1 * k1), re);
      if (k1 != 0 && k1 != 10) {
#pragma unroll
        for (int n1 = 1; n1 < 10; ++n1) im = fmaf(-d[n1], w.sin_(n1 * k1), im);
      }
      sh.y_re[(k1 * 20 + n2) * kFrames + f] = re;
      sh.y_im[(k1 * 20 + n2) * kFrames + f] = im;
    }
  }
  __syncthreads();

  // ---- 2. twiddles, then complex 20-point DFTs over n2, one for each k1
#pragma unroll 1
  for (int k1 = warp; k1 < 20; k1 += kWarps) {
    const int src_k1 = k1 <= 10 ? k1 : 20 - k1;  // Y[k1] = conj(Y[20 - k1])
    const float conj = k1 <= 10 ? 1.f : -1.f;
    // Z[n2] = Y[k1, n2] x W_400^(n2 k1), taken in the pairs n2, 20 - n2 as
    // their sums and differences, so that few are live at once
    auto z = [&](int n2, float& zr, float& zi) {
      const float yr = sh.y_re[(src_k1 * 20 + n2) * kFrames + f];
      const float yi = conj * sh.y_im[(src_k1 * 20 + n2) * kFrames + f];
      const float tr = sh.tw_re[k1 * 20 + n2], ti = sh.tw_im[k1 * 20 + n2];
      zr = yr * tr - yi * ti;
      zi = yr * ti + yi * tr;
    };
    float z0r, z0i, z10r, z10i;
    z(0, z0r, z0i);
    z(10, z10r, z10i);
    float nyq_r = z0r + z10r, nyq_i = z0i + z10i;  // bin 200 = k1 0 + 20 x 10: the alternating sum
    float ar[10], ai[10], dr[10], di[10];          // Z[n2] +- Z[20 - n2], n2 = 1..9
#pragma unroll
    for (int n2 = 1; n2 < 10; ++n2) {
      float pr, pi, qr, qi;
      z(n2, pr, pi);
      z(20 - n2, qr, qi);
      ar[n2] = pr + qr;
      ai[n2] = pi + qi;
      dr[n2] = pr - qr;
      di[n2] = pi - qi;
      nyq_r += (n2 & 1) ? -ar[n2] : ar[n2];
      nyq_i += (n2 & 1) ? -ai[n2] : ai[n2];
    }
    if (k1 == 0) sh.power[200 * kFrames + f] = nyq_r * nyq_r + nyq_i * nyq_i;
#pragma unroll
    for (int k2 = 0; k2 < 10; ++k2) {
      float re = (k2 & 1) ? z0r - z10r : z0r + z10r;
      float im = (k2 & 1) ? z0i - z10i : z0i + z10i;
#pragma unroll
      for (int n2 = 1; n2 < 10; ++n2) {
        const float c = w.cos_(n2 * k2), s = w.sin_(n2 * k2);
        re = fmaf(ar[n2], c, re);
        re = fmaf(di[n2], s, re);
        im = fmaf(ai[n2], c, im);
        im = fmaf(-dr[n2], s, im);
      }
      sh.power[(k1 + 20 * k2) * kFrames + f] = re * re + im * im;
    }
  }
  __syncthreads();

  // ---- 3. mel filters over their nonzero bins, log10, out
  const int t = t0 + f;
#pragma unroll 1
  for (int m = warp; m < n_mels; m += kWarps) {
    const int lo = __ldg(mel_lo + m), hi = __ldg(mel_hi + m);
    const float* wm = mel_w + __ldg(mel_off + m);
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = __fadd_rn(acc, __fmul_rn(sh.power[k * kFrames + f], __ldg(wm + k - lo)));
    if (t < n_frames) out[((size_t)b * n_mels + m) * n_frames + t] = log10f(fmaxf(acc, 1e-10f));
  }
}

}  // namespace

extern "C" int log_mel_f32(const float* audio, const float* consts, const int* mel_lo, const int* mel_hi,
                           const int* mel_off, const float* mel_w, float* out, int batch, int padded_len,
                           int n_frames, int n_mels, void* stream) {
  if (n_mels < 1 || n_mels > kMaxMels || n_frames <= 0 || batch <= 0 || batch > 65535 ||
      (size_t)(n_frames - 1) * kHop + kNFFT > (size_t)padded_len)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  log_mel_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(audio, consts, mel_lo, mel_hi, mel_off, mel_w, out,
                                                                 padded_len, n_frames, n_mels);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
