// Native host-side audio runtime: in-process WAV decode + polyphase
// resampling + a threaded batch loader.
//
// TPU-native replacement for the reference's per-sample ffmpeg subprocess
// (`whisper/audio.py:42-58`) and the torch-CPU resample path: the training
// input pipeline calls `load_batch` once per batch and gets back a packed
// (n, target_len) float32 buffer, decoded and resampled by a thread pool
// with zero process spawns and zero Python in the loop.
//
// The resampler reproduces scipy.signal.resample_poly(window=('kaiser',5.0))
// exactly (same firwin design, same pre-pad/trim alignment), so outputs are
// bit-comparable to the Python fallback in audio.py:resample.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (see runtime/build.py).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <numeric>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// WAV decode
// ---------------------------------------------------------------------------

struct Wav {
  std::vector<float> mono;  // downmixed mono samples in [-1, 1]
  int sample_rate = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

// returns 0 on success, negative error code otherwise
int wav_decode(const char* path, Wav* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 44) {
    fclose(f);
    return -2;
  }
  std::vector<uint8_t> buf((size_t)size);
  if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) {
    fclose(f);
    return -3;
  }
  fclose(f);

  if (memcmp(buf.data(), "RIFF", 4) != 0 || memcmp(buf.data() + 8, "WAVE", 4) != 0)
    return -4;

  uint16_t format = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  const uint8_t* data = nullptr;
  size_t data_len = 0;

  size_t pos = 12;
  while (pos + 8 <= (size_t)size) {
    const uint8_t* cid = buf.data() + pos;
    uint32_t csize = rd_u32(buf.data() + pos + 4);
    const uint8_t* body = buf.data() + pos + 8;
    size_t avail = (size_t)size - pos - 8;
    if (csize > avail) csize = (uint32_t)avail;  // tolerate truncated files
    if (memcmp(cid, "fmt ", 4) == 0 && csize >= 16) {
      format = rd_u16(body);
      channels = rd_u16(body + 2);
      rate = rd_u32(body + 4);
      bits = rd_u16(body + 14);
      if (format == 0xFFFE && csize >= 26) {  // WAVE_FORMAT_EXTENSIBLE
        format = rd_u16(body + 24);
      }
    } else if (memcmp(cid, "data", 4) == 0) {
      data = body;
      data_len = csize;
    }
    pos += 8 + csize + (csize & 1);  // chunks are word-aligned
  }
  if (!data || channels == 0 || rate == 0) return -5;

  size_t bytes_per = bits / 8;
  if (bytes_per == 0) return -6;
  size_t n_frames = data_len / (bytes_per * channels);
  out->mono.resize(n_frames);
  out->sample_rate = (int)rate;

  const double inv_ch = 1.0 / channels;
  for (size_t i = 0; i < n_frames; i++) {
    double acc = 0.0;
    for (int c = 0; c < channels; c++) {
      const uint8_t* p = data + (i * channels + c) * bytes_per;
      double v;
      if (format == 1 && bits == 8) {
        v = ((int)p[0] - 128) / 128.0;
      } else if (format == 1 && bits == 16) {
        v = (int16_t)rd_u16(p) / 32768.0;
      } else if (format == 1 && bits == 24) {
        int32_t s = (int32_t)p[0] | ((int32_t)p[1] << 8) | ((int32_t)p[2] << 16);
        if (s >= (1 << 23)) s -= (1 << 24);
        v = s / (double)(1 << 23);
      } else if (format == 1 && bits == 32) {
        v = (int32_t)rd_u32(p) / 2147483648.0;
      } else if (format == 3 && bits == 32) {
        float fv;
        memcpy(&fv, p, 4);
        v = fv;
      } else if (format == 3 && bits == 64) {
        double dv;
        memcpy(&dv, p, 8);
        v = dv;
      } else {
        return -7;
      }
      acc += v;
    }
    out->mono[i] = (float)(acc * inv_ch);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Polyphase resampler — scipy.signal.resample_poly parity
// ---------------------------------------------------------------------------

double bessel_i0(double x) {
  // power series; converges quickly for the beta=5 kaiser arguments
  double sum = 1.0, term = 1.0;
  const double x2 = x * x / 4.0;
  for (int k = 1; k < 64; k++) {
    term *= x2 / (double)(k * k);
    sum += term;
    if (term < 1e-18 * sum) break;
  }
  return sum;
}

// firwin(2*half_len+1, 1/max_rate, window=('kaiser', 5.0)), cf. scipy
std::vector<double> design_filter(int up, int down) {
  const int max_rate = up > down ? up : down;
  const double f_c = 1.0 / max_rate;
  const int half_len = 10 * max_rate;
  const int numtaps = 2 * half_len + 1;
  const double beta = 5.0;
  const double i0b = bessel_i0(beta);

  std::vector<double> h(numtaps);
  double sum = 0.0;
  for (int n = 0; n < numtaps; n++) {
    const double m = n - (double)half_len;
    // sinc low-pass at cutoff f_c (cutoff relative to Nyquist)
    double s = (m == 0.0) ? f_c : sin(M_PI * f_c * m) / (M_PI * m);
    const double r = 2.0 * n / (numtaps - 1) - 1.0;
    const double w = bessel_i0(beta * sqrt(std::max(0.0, 1.0 - r * r))) / i0b;
    h[n] = s * w;
    sum += h[n];
  }
  for (auto& v : h) v /= sum;       // firwin scale=True (DC gain 1)
  for (auto& v : h) v *= (double)up;  // resample_poly's h *= up
  return h;
}

// y = upfirdn(h_padded, x, up, down)[n_pre_remove : n_pre_remove + n_out]
void resample_poly(const float* x, long n_in, int up, int down,
                   std::vector<float>* out) {
  const long g = std::gcd((long)up, (long)down);
  up = (int)(up / g);
  down = (int)(down / g);
  if (up == 1 && down == 1) {
    out->assign(x, x + n_in);
    return;
  }
  long n_out = n_in * up;
  n_out = n_out / down + (n_out % down != 0 ? 1 : 0);

  const int half_len = 10 * (up > down ? up : down);
  std::vector<double> h = design_filter(up, down);
  const int n_pre_pad = down - (half_len % down);
  const long n_pre_remove = (half_len + n_pre_pad) / down;
  // pre-pad zeros shift the filter so output sample 0 aligns with input 0
  std::vector<double> hp(n_pre_pad, 0.0);
  hp.insert(hp.end(), h.begin(), h.end());
  const long len_h = (long)hp.size();

  out->assign((size_t)n_out, 0.0f);
  // polyphase evaluation of y[j] = sum_m x[m] * hp[t - m*up], t = j*down,
  // for the kept output range only
  for (long j = 0; j < n_out; j++) {
    const long t = (j + n_pre_remove) * down;
    long m_lo = (t - len_h + 1 + up - 1) / up;  // ceil
    if (m_lo < 0) m_lo = 0;
    long m_hi = t / up;
    if (m_hi > n_in - 1) m_hi = n_in - 1;
    double acc = 0.0;
    for (long m = m_lo; m <= m_hi; m++) {
      acc += (double)x[m] * hp[t - m * up];
    }
    (*out)[(size_t)j] = (float)acc;
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

// Decode a WAV file to mono float32 at its native rate.
// Returns sample count (>=0) or a negative error code.
// *out_data is malloc'd; free with audio_free.
long wav_read(const char* path, float** out_data, int* out_sr) {
  Wav w;
  int rc = wav_decode(path, &w);
  if (rc != 0) return rc;
  float* p = (float*)malloc(w.mono.size() * sizeof(float));
  if (!p) return -100;
  memcpy(p, w.mono.data(), w.mono.size() * sizeof(float));
  *out_data = p;
  *out_sr = w.sample_rate;
  return (long)w.mono.size();
}

void audio_free(float* p) { free(p); }

// Resample float32 audio; returns output length or negative error code.
long resample_f32(const float* in, long n_in, int up, int down, float** out_data) {
  std::vector<float> out;
  resample_poly(in, n_in, up, down, &out);
  float* p = (float*)malloc(out.size() * sizeof(float));
  if (!p) return -100;
  memcpy(p, out.data(), out.size() * sizeof(float));
  *out_data = p;
  return (long)out.size();
}

// Decode `n` WAV files, resample each to target_sr, pad-or-trim to
// target_len, and write row i of `out` (n x target_len float32, caller
// allocated). status[i] = decoded-sample count or negative error.
// Thread pool of n_threads workers; returns number of failures.
int load_batch(const char** paths, int n, int target_sr, long target_len,
               float* out, long* status, int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;

  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      float* row = out + (size_t)i * (size_t)target_len;
      Wav w;
      int rc = wav_decode(paths[i], &w);
      if (rc != 0) {
        memset(row, 0, (size_t)target_len * sizeof(float));
        status[i] = rc;
        failures.fetch_add(1);
        continue;
      }
      std::vector<float> res;
      if (w.sample_rate != target_sr) {
        resample_poly(w.mono.data(), (long)w.mono.size(), target_sr,
                      w.sample_rate, &res);
      } else {
        res = std::move(w.mono);
      }
      const long have = (long)res.size();
      const long copy = have < target_len ? have : target_len;
      memcpy(row, res.data(), (size_t)copy * sizeof(float));
      if (copy < target_len)
        memset(row + copy, 0, (size_t)(target_len - copy) * sizeof(float));
      status[i] = have;
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; t++) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
  return failures.load();
}

}  // extern "C"
