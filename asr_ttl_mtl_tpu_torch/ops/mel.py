"""K4: fused log-mel spectrogram (kernel `csrc/mel.cu`) and its plain version.

Counterpart of `asr_ttl_mtl_tpu/ops/pallas_mel.py` (`log_mel_spectrogram_pallas`
:124, kernel `_mel_kernel` :44). Both functions here take the reflect-padded
waveform and return log10(max(mel, 1e-10)) as (B, n_mels, n_frames); the
per-clip max-8 clamp and (x+4)/4 stay in `audio.log_mel_spectrogram`.

The plain version is the direct form, as in JAX: frames times the
Hann-folded cos and sin bases, power, times the filterbank. The kernel
computes the same function by a factored DFT (400 = 20 x 20: 20-point DFTs
of the windowed frame over n1, twiddles, 20-point DFTs over n2), with the
constants of `dft_constants`, and sums each mel over its filter's nonzero
bins only (`mel_ranges`).

Unlike the TPU kernel, which needs n_frames % 600 == 0 for its VMEM tiles
(`pallas_mel.supports`), the CUDA kernel masks its ragged last tile and
takes any frame count.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch

from . import LAUNCHES, _cuda

N_FFT = 400
HOP = 160


@lru_cache(maxsize=None)
def _constants(n_mels: int, device: torch.device):
    """(cos, sin, mel_t) on `device`: the Hann-folded bases (400, 201) and the
    transposed filterbank (201, n_mels) of the plain version."""
    from ..audio import _stft_constants, mel_filters

    cos_b, sin_b = _stft_constants()
    return tuple(
        torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device) for a in (cos_b, sin_b, mel_filters(n_mels).T)
    )


@lru_cache(maxsize=None)
def dft_constants() -> np.ndarray:
    """The kernel's constants, fp32 (1222,), laid out as `csrc/mel.cu` reads
    them: the periodic Hann window (400, as `audio._stft_constants` folds it
    into its bases); cos and sin of 2 pi m / 20 for m = 0..10 (11 + 11); the
    twiddles W_400^(n2 k1) = exp(-2 pi i n2 k1 / 400) as re and im at
    [k1 * 20 + n2] for k1, n2 = 0..19 (400 + 400). All from float64."""
    n = np.arange(N_FFT)
    window = 0.5 * (1.0 - np.cos(2.0 * np.pi * n / N_FFT))
    m = np.arange(11)
    k1, n2 = np.meshgrid(np.arange(20), np.arange(20), indexing="ij")
    angle = 2.0 * np.pi * (k1 * n2).ravel() / N_FFT
    parts = (window, np.cos(2.0 * np.pi * m / 20), np.sin(2.0 * np.pi * m / 20), np.cos(angle), -np.sin(angle))
    return np.concatenate([p.astype(np.float32) for p in parts])


@lru_cache(maxsize=None)
def mel_ranges(n_mels: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(lo, hi, offset, weights) of the filterbank `mel_filters(n_mels)`:
    filter m's nonzero weights are bins [lo[m], hi[m]) (lo == hi where the
    filter is empty), stored at weights[offset[m]:offset[m] + hi[m] - lo[m]]
    in bin order. The sum over [lo, hi) in bin order gives the bits of the
    dense sum over all 201 bins in bin order: every other term is 0."""
    from ..audio import mel_filters

    fb = mel_filters(n_mels)
    lo, hi, off, weights = [], [], [], []
    for row in fb:
        nz = np.flatnonzero(row)
        a, b = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        lo.append(a)
        hi.append(b)
        off.append(sum(len(w) for w in weights))
        weights.append(row[a:b])
    return (np.asarray(lo, np.int32), np.asarray(hi, np.int32), np.asarray(off, np.int32),
            np.concatenate(weights).astype(np.float32))


@lru_cache(maxsize=None)
def _kernel_constants(n_mels: int, device: torch.device):
    """(consts, lo, hi, offset, weights) on `device`, for the kernel."""
    return tuple(torch.from_numpy(a).to(device) for a in (dft_constants(), *mel_ranges(n_mels)))


def log_mel_plain(padded: torch.Tensor, n_frames: int, n_mels: int) -> torch.Tensor:
    """Plain PyTorch K4: padded (B, L) fp32 -> (B, n_mels, n_frames) log10 mel."""
    cos_b, sin_b, mel_t = _constants(n_mels, padded.device)
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
    consts, lo, hi, off, weights = _kernel_constants(n_mels, padded.device)
    out = torch.empty((bsz, n_mels, n_frames), dtype=torch.float32, device=padded.device)
    lib = _cuda.lib("mel")
    code = lib.log_mel_f32(
        padded.data_ptr(), consts.data_ptr(), lo.data_ptr(), hi.data_ptr(), off.data_ptr(), weights.data_ptr(),
        out.data_ptr(), bsz, length, n_frames, n_mels, _cuda.stream_handle(padded.device),
    )
    _cuda.check("mel", "log_mel_f32", code)
    LAUNCHES["log_mel"] += 1
    return out
