"""Audio frontend: file decoding on the host, log-mel spectrogram on the device.

Counterpart of `asr_ttl_mtl_tpu/audio.py` (constants, `_load_audio_ffmpeg`
:52, `_read_wav` :71, `load_audio` :144, `_read_wav_native` :162,
`pad_or_trim` :172, `mel_filters` :218, `_stft_constants` :243,
`log_mel_for_transfer` :302, `finish_transfer_mel` :342,
`log_mel_spectrogram` :391). The spectrogram runs in kernel K4
(`ops/mel.py`) for a CUDA tensor, whatever the frame count, and in its plain
PyTorch version for a CPU tensor. Decoding stays on the host: a `.wav` (or
any file, when ffmpeg is not on PATH) through the native C++ reader
(`runtime/wav.py`, the stdlib `wave` reader where no compiler is present),
every other file through ffmpeg, with the JAX package's command line.
"""

from __future__ import annotations

import shutil
import subprocess
from functools import lru_cache
from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from .ops.mel import log_mel
from .utils import exact_div, resolve_device

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
CHUNK_LENGTH = 30
N_SAMPLES = CHUNK_LENGTH * SAMPLE_RATE  # 480000 samples in a 30-second chunk
N_FRAMES = exact_div(N_SAMPLES, HOP_LENGTH)  # 3000 frames in a mel spectrogram input

N_SAMPLES_PER_TOKEN = HOP_LENGTH * 2  # the initial convolutions have stride 2
FRAMES_PER_SECOND = exact_div(SAMPLE_RATE, HOP_LENGTH)  # 10ms per audio frame
TOKENS_PER_SECOND = exact_div(SAMPLE_RATE, N_SAMPLES_PER_TOKEN)  # 20ms per audio token


def _load_audio_ffmpeg(file: str, sr: int) -> np.ndarray:
    """Decode any file ffmpeg reads to mono 16-bit PCM at `sr`, as float32."""
    cmd = [
        "ffmpeg",
        "-nostdin",
        "-threads", "0",
        "-i", file,
        "-f", "s16le",
        "-ac", "1",
        "-acodec", "pcm_s16le",
        "-ar", str(sr),
        "-",
    ]
    try:
        out = subprocess.run(cmd, capture_output=True, check=True).stdout
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"Failed to load audio: {e.stderr.decode()}") from e
    return np.frombuffer(out, np.int16).flatten().astype(np.float32) / 32768.0


def _read_wav(file: str) -> tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader: PCM 8/16/24/32-bit and IEEE float, plain or
    WAVE_FORMAT_EXTENSIBLE (whose sub-format GUID starts with the format
    code, at byte 24 of the `fmt ` body)."""
    import struct
    import wave

    try:
        with wave.open(file, "rb") as w:
            n_channels = w.getnchannels()
            sampwidth = w.getsampwidth()
            framerate = w.getframerate()
            raw = w.readframes(w.getnframes())
        if sampwidth == 1:
            data = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
        elif sampwidth == 2:
            data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
        elif sampwidth == 3:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            i32 = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            i32 = np.where(i32 >= 1 << 23, i32 - (1 << 24), i32)
            data = i32.astype(np.float32) / float(1 << 23)
        elif sampwidth == 4:
            data = np.frombuffer(raw, np.int32).astype(np.float32) / float(1 << 31)
        else:
            raise RuntimeError(f"unsupported WAV sample width: {sampwidth}")
    except wave.Error:
        # wave does not handle IEEE-float WAVs, extensible ones included;
        # parse the header by hand
        with open(file, "rb") as f:
            blob = f.read()
        if blob[:4] != b"RIFF" or blob[8:12] != b"WAVE":
            raise RuntimeError(f"{file} is not a RIFF/WAVE file")
        pos, fmt, data = 12, None, None
        framerate = n_channels = None
        while pos + 8 <= len(blob):
            cid, size = blob[pos : pos + 4], struct.unpack("<I", blob[pos + 4 : pos + 8])[0]
            body = blob[pos + 8 : pos + 8 + size]
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", body[:16])
                if fmt[0] == 0xFFFE and len(body) >= 26:  # WAVE_FORMAT_EXTENSIBLE
                    fmt = struct.unpack("<H", body[24:26]) + fmt[1:]
                n_channels, framerate = fmt[1], fmt[2]
            elif cid == b"data":
                data = body
            pos += 8 + size + (size & 1)
        if fmt is None or data is None:
            raise RuntimeError(f"malformed WAV file: {file}")
        audio_format, bits = fmt[0], fmt[5]
        if audio_format == 3 and bits == 32:
            data = np.frombuffer(data, np.float32).astype(np.float32)
        elif audio_format == 3 and bits == 64:
            data = np.frombuffer(data, np.float64).astype(np.float32)
        else:
            raise RuntimeError(f"unsupported WAV format code {audio_format}/{bits}bit")
        return data.reshape(-1, n_channels).mean(axis=1), framerate

    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, framerate


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling with a Kaiser-windowed sinc filter."""
    if orig_sr == target_sr:
        return audio.astype(np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g).astype(np.float32)


def load_audio(file: str, sr: int = SAMPLE_RATE) -> np.ndarray:
    """Read an audio file as a mono float32 waveform at `sr` Hz: a `.wav`,
    or any file when ffmpeg is not on PATH, through the native reader;
    anything else, or a `.wav` the reader refuses, through ffmpeg."""
    if file.lower().endswith(".wav") or not shutil.which("ffmpeg"):
        try:
            data, orig_sr = _read_wav_native(file)
            return resample(data, orig_sr, sr)
        except Exception:
            if not shutil.which("ffmpeg"):
                raise
    return _load_audio_ffmpeg(file, sr)


def _read_wav_native(file: str) -> tuple[np.ndarray, int]:
    """WAV decode through the C++ runtime, or the Python reader where it
    cannot be built (no compiler)."""
    from .runtime import wav as native

    try:
        return native.read(file)
    except ImportError:
        return _read_wav(file)


def pad_or_trim(array, length: int = N_SAMPLES, *, axis: int = -1):
    """Pad (with zeros) or trim the array to `length` along `axis`; numpy or torch."""
    if array.shape[axis] > length:
        sl = [slice(None)] * array.ndim
        sl[axis] = slice(0, length)
        array = array[tuple(sl)]
    if array.shape[axis] < length:
        if isinstance(array, torch.Tensor):
            axis = axis % array.ndim
            widths = [0, 0] * (array.ndim - 1 - axis) + [0, length - array.shape[axis]]
            array = F.pad(array, widths)
        else:
            pad_widths = [(0, 0)] * array.ndim
            pad_widths[axis] = (0, length - array.shape[axis])
            array = np.pad(array, pad_widths)
    return array


def _hz_to_mel(freq: np.ndarray) -> np.ndarray:
    """Slaney-style mel scale (linear below 1 kHz, log above)."""
    freq = np.asanyarray(freq, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = freq / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(
        freq >= min_log_hz, min_log_mel + np.log(np.maximum(freq, 1e-10) / min_log_hz) / logstep, mels
    )


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    mel = np.asanyarray(mel, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = f_sp * mel
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(mel >= min_log_mel, min_log_hz * np.exp(logstep * (mel - min_log_mel)), freqs)


@lru_cache(maxsize=None)
def mel_filters(n_mels: int, sr: int = SAMPLE_RATE, n_fft: int = N_FFT) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, shape (n_mels, n_fft//2+1)
    (librosa.filters.mel(sr=16000, n_fft=400, n_mels=n_mels))."""
    assert n_mels in {80, 128}, f"Unsupported n_mels: {n_mels}"
    fftfreqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(sr / 2.0), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@lru_cache(maxsize=None)
def _stft_constants(n_fft: int = N_FFT):
    """Hann window folded into the real-DFT bases: frames @ basis == rDFT(frames * window)."""
    n = np.arange(n_fft)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / n_fft))  # periodic Hann
    k = np.arange(n_fft // 2 + 1)
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft
    cos_basis = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_basis = (-np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_basis, sin_basis


def _log_mel(audio: torch.Tensor, n_mels: int, padding: int) -> torch.Tensor:
    """(..., n) fp32 waveform -> (..., n_mels, (n + padding) // 160): zero
    padding, centered-STFT reflect padding, K4, then the per-clip max-8 clamp
    and (x+4)/4."""
    lead = audio.shape[:-1]
    flat = audio.reshape(-1, audio.shape[-1])
    n_frames = (flat.shape[-1] + padding) // HOP_LENGTH
    if padding > 0:
        flat = F.pad(flat, (0, padding))
    flat = F.pad(flat[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0].contiguous()
    log_spec = log_mel(flat, n_frames, n_mels)
    global_max = log_spec.amax(dim=(-2, -1), keepdim=True)
    log_spec = torch.maximum(log_spec, global_max - 8.0)
    out = (log_spec + 4.0) / 4.0
    return out.reshape(*lead, n_mels, n_frames)


def log_mel_for_transfer(wave: np.ndarray, n_mels: int = 80, full_samples: Optional[int] = None) -> np.ndarray:
    """Host half of the training pipeline's `mel_fp16` transfer: the
    normalized log-mel of bucket-length waveforms (..., L), as fp16.

    For a clip zero-padded to L samples, the frames of the full-window mel
    whose windows reach samples < L are the first L // HOP + 2 (frames L //
    HOP and L // HOP + 1 still reach into the last N_FFT / 2 samples);
    every later frame is padding, whose value after the dynamic-range clip
    the device rebuilds from these (`finish_transfer_mel`). So the mel of
    wave || 0^N_FFT is computed here with the port's plain log-mel on the
    CPU (a CPU tensor never reaches K4), and its first L // HOP + 2 frames
    are kept. A clip that fills the window (L >= full_samples) has no zero
    region: the device's mel reflects its tail, so the full-window mel is
    computed as it is."""
    wave = np.asarray(wave, np.float32)
    lead, length = wave.shape[:-1], wave.shape[-1]
    flat = torch.from_numpy(np.ascontiguousarray(wave.reshape(-1, length)))
    if full_samples is not None and length >= full_samples:
        mel = _log_mel(flat, n_mels, 0)
    else:
        mel = _log_mel(flat, n_mels, N_FFT)[..., : length // HOP_LENGTH + 2]
    mel = mel.numpy().astype(np.float16)
    return mel.reshape(*lead, n_mels, mel.shape[-1])


def finish_transfer_mel(mel: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Device half of `log_mel_for_transfer`, on the tensor's own device:
    fp16 -> fp32, extended to the window's n_samples // HOP frames with each
    sample's dynamic-range floor (its max - 2.0, the normalized max - 8 dB,
    never below the log10 clamp's -1.5), or truncated where a full-window
    clip shipped two frames more."""
    mel = mel.float()
    target = n_samples // HOP_LENGTH
    short = target - mel.shape[-1]
    if short <= 0:
        return mel[..., :target].contiguous()
    floor = torch.clamp(mel.amax(dim=(-2, -1), keepdim=True) - 2.0, min=-1.5)
    return torch.cat([mel, floor.expand(*mel.shape[:-1], short)], dim=-1)


def log_mel_spectrogram(
    audio: Union[str, np.ndarray, torch.Tensor],
    n_mels: int = 80,
    padding: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """Log-mel spectrogram (..., n_mels, n_frames) of 16 kHz audio: a WAV path,
    a numpy array or a tensor. A path or an array runs on the card unless
    `device="cpu"`; a tensor runs on its own device unless `device` names
    another.

    With `padding >= N_FFT` (long-form: 30 s of silence) the waveform is
    zero-extended to a 30 s multiple and the surplus frames sliced off, as in
    the JAX package; every kept frame is unchanged by that."""
    if isinstance(audio, str):
        audio = load_audio(audio)
    if not isinstance(audio, torch.Tensor):
        audio = torch.from_numpy(np.ascontiguousarray(audio, dtype=np.float32))
        device = resolve_device(device)
    if device is not None:
        audio = audio.to(resolve_device(device))
    audio = audio.to(torch.float32)
    n = audio.shape[-1]
    if padding >= N_FFT:
        total = n + padding
        true_frames = total // HOP_LENGTH
        bucket = ((total + N_SAMPLES - 1) // N_SAMPLES) * N_SAMPLES
        return _log_mel(audio, n_mels, padding + (bucket - total))[..., :true_frames]
    return _log_mel(audio, n_mels, padding)
