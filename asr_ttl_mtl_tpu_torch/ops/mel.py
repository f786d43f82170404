"""K4: fused log-mel spectrogram (kernel `csrc/mel.cu`) and its plain version.

Counterpart of `asr_ttl_mtl_tpu/ops/pallas_mel.py` (`log_mel_spectrogram_pallas`
:124, kernel `_mel_kernel` :44). Both functions here take the reflect-padded
waveform and return log10(max(mel, 1e-10)) as (B, n_mels, n_frames); the
per-clip max-8 clamp and (x+4)/4 stay in `audio.log_mel_spectrogram`.

Unlike the TPU kernel, which needs n_frames % 600 == 0 for its VMEM tiles
(`pallas_mel.supports`), the CUDA kernel masks its ragged last tile and
takes any frame count.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import LAUNCHES, _cuda

N_FFT = 400
HOP = 160
_FREQ_PAD = 224  # 201 bins padded to whole 32-bin tiles (zeros)


@lru_cache(maxsize=None)
def _constants(n_mels: int, device: torch.device, padded: bool):
    """(cos, sin, mel_t) on `device`: the bases (400, F) and the transposed
    filterbank (F, n_mels), with F = 201, or 224 zero-padded for the kernel."""
    from ..audio import _stft_constants, mel_filters

    cos_b, sin_b = _stft_constants()
    mel_t = mel_filters(n_mels).T
    if padded:
        n_freq = cos_b.shape[1]
        pad = ((0, 0), (0, _FREQ_PAD - n_freq))
        cos_b, sin_b = np.pad(cos_b, pad), np.pad(sin_b, pad)
        mel_t = np.pad(mel_t, ((0, _FREQ_PAD - n_freq), (0, 0)))
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in (cos_b, sin_b, mel_t)
    )


def log_mel_plain(padded: torch.Tensor, n_frames: int, n_mels: int) -> torch.Tensor:
    """Plain PyTorch K4: padded (B, L) fp32 -> (B, n_mels, n_frames) log10 mel."""
    cos_b, sin_b, mel_t = _constants(n_mels, padded.device, False)
    frames = padded.unfold(-1, N_FFT, HOP)[:, :n_frames]  # (B, T, 400)
    re = frames @ cos_b
    im = frames @ sin_b
    mel = (re * re + im * im) @ mel_t  # (B, T, n_mels)
    return torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)


def log_mel(padded: torch.Tensor, n_frames: int, n_mels: int) -> torch.Tensor:
    """K4 wrapper: the CUDA kernel for a CUDA tensor, the plain version on CPU."""
    if padded.device.type == "cpu":
        return log_mel_plain(padded, n_frames, n_mels)
    if not padded.is_cuda:
        raise ValueError(f"log_mel: unsupported device {padded.device}")
    if padded.dtype != torch.float32 or padded.dim() != 2 or not padded.is_contiguous():
        raise ValueError("log_mel: padded waveform must be a contiguous (B, L) float32 tensor")
    bsz, length = padded.shape
    if n_frames < 1 or (n_frames - 1) * HOP + N_FFT > length or n_mels > 128:
        raise ValueError(f"log_mel: bad geometry n_frames={n_frames} length={length} n_mels={n_mels}")
    cos_b, sin_b, mel_t = _constants(n_mels, padded.device, True)
    out = torch.empty((bsz, n_mels, n_frames), dtype=torch.float32, device=padded.device)
    lib = _cuda.lib("mel")
    code = lib.log_mel_f32(
        padded.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
        bsz, length, n_frames, n_mels, _cuda.stream_handle(padded.device),
    )
    _cuda.check("mel", "log_mel_f32", code)
    LAUNCHES["log_mel"] += 1
    return out
