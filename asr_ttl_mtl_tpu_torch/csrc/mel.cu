// K4: fused log-mel spectrogram for Hopper (sm_90a).
//
// Replaces the TPU kernel `_mel_kernel` (asr_ttl_mtl_tpu/ops/pallas_mel.py:44,
// entry `log_mel_spectrogram_pallas` :124). For each clip it frames the
// reflect-padded waveform (n_fft 400, hop 160), takes the real DFT as products
// with the Hann-folded cos/sin bases, the power, the product with the mel
// filterbank, and log10(max(., 1e-10)). The per-clip max-8 clamp and
// (x+4)/4 stay outside, as in JAX.
//
// What bounds it on the H100: arithmetic. A 30 s clip is 3000 frames x 201
// bins x 400 taps x 2 bases, about 1 GFLOP, which must be true fp32 (TF32
// would lose the 1e-5 parity, see pallas_mel.py:55-58): the tensor cores are
// out, so this runs on the fp32 FMA pipes. The waveform itself is tiny.
//
// Design: one CTA per (32-frame tile, clip). The CTA copies the 5360 samples
// its frames cover into shared memory once, so overlapping frames are never
// re-read from device memory. The (400 x 201) bases are 321 KB each, more
// than shared memory holds, so they are read through L1/L2 in tiles of 32
// frequencies: a warp reads 32 consecutive bins of one tap (one 128-byte
// line) and every thread reuses each basis value for 4 frames. Each tile's
// power goes to shared memory and is folded into the mel sums at once, so the
// (frames x 201) power never reaches device memory. Rows 201..223 of the
// padded bases and filterbank are zero, which keeps the loops free of bounds
// checks.

#include <cuda_runtime.h>

namespace {

constexpr int kNFFT = 400;
constexpr int kHop = 160;
constexpr int kFreqPad = 224;   // 201 bins padded to 7 tiles of 32
constexpr int kFreqTile = 32;
constexpr int kFrames = 32;     // frames per CTA
constexpr int kThreads = 256;
constexpr int kRowsPerThread = kFrames / (kThreads / kFreqTile);  // 4
constexpr int kSpan = (kFrames - 1) * kHop + kNFFT;               // 5360 samples
constexpr int kMaxMels = 128;
constexpr int kMelPerThread = kFrames * kMaxMels / kThreads;      // 16

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ audio,  // (B, padded_len)
               const float* __restrict__ cos_b,  // (400, 224)
               const float* __restrict__ sin_b,  // (400, 224)
               const float* __restrict__ mel_t,  // (224, n_mels)
               float* __restrict__ out,          // (B, n_mels, n_frames)
               int padded_len, int n_frames, int n_mels) {
  __shared__ float frames[kSpan];
  __shared__ float power[kFrames][kFreqTile + 1];

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;

  const float* src = audio + (size_t)b * padded_len + (size_t)t0 * kHop;
  const int avail = padded_len - t0 * kHop;
  for (int i = tid; i < kSpan; i += kThreads) frames[i] = i < avail ? src[i] : 0.f;
  __syncthreads();

  const int col = tid % kFreqTile;                      // bin within the tile
  const int row0 = (tid / kFreqTile) * kRowsPerThread;  // first of this thread's frames

  float macc[kMelPerThread];
#pragma unroll
  for (int j = 0; j < kMelPerThread; ++j) macc[j] = 0.f;

  for (int f0 = 0; f0 < kFreqPad; f0 += kFreqTile) {
    float re[kRowsPerThread], im[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) re[i] = im[i] = 0.f;
    const float* cb = cos_b + f0 + col;
    const float* sb = sin_b + f0 + col;
#pragma unroll 4
    for (int n = 0; n < kNFFT; ++n) {
      const float c = __ldg(cb + n * kFreqPad);
      const float s = __ldg(sb + n * kFreqPad);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const float x = frames[(row0 + i) * kHop + n];
        re[i] = fmaf(x, c, re[i]);
        im[i] = fmaf(x, s, im[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) power[row0 + i][col] = re[i] * re[i] + im[i] * im[i];
    __syncthreads();

    // output o = tid + j * kThreads: frame o % 32 (the lane), mel o / 32
#pragma unroll
    for (int j = 0; j < kMelPerThread; ++j) {
      const int o = tid + j * kThreads;
      const int fr = o % kFrames, m = o / kFrames;
      if (m < n_mels) {
        float a = macc[j];
#pragma unroll 8
        for (int f = 0; f < kFreqTile; ++f) a = fmaf(power[fr][f], __ldg(mel_t + (f0 + f) * n_mels + m), a);
        macc[j] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMelPerThread; ++j) {
    const int o = tid + j * kThreads;
    const int fr = o % kFrames, m = o / kFrames;
    const int t = t0 + fr;
    if (m < n_mels && t < n_frames) out[((size_t)b * n_mels + m) * n_frames + t] = log10f(fmaxf(macc[j], 1e-10f));
  }
}

}  // namespace

extern "C" int log_mel_f32(const float* audio, const float* cos_b, const float* sin_b, const float* mel_t,
                           float* out, int batch, int padded_len, int n_frames, int n_mels, void* stream) {
  if (n_mels > kMaxMels || n_frames <= 0 || batch <= 0 ||
      (size_t)(n_frames - 1) * kHop + kNFFT > (size_t)padded_len)
    return (int)cudaErrorInvalidValue;
  dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  log_mel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(audio, cos_b, sin_b, mel_t, out, padded_len,
                                                              n_frames, n_mels);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }
