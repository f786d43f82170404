"""Port audio frontend and K4's plain version against the JAX frontend
(`log_mel_spectrogram_jax`, and the Pallas kernel in interpret mode)."""

import wave

import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.ops.pallas_mel import log_mel_spectrogram_pallas
from asr_ttl_mtl_tpu_torch import audio as PA
from asr_ttl_mtl_tpu_torch.ops import mel as PM

from torch_port_helpers import cuda_device, waveforms  # noqa: F401

ATOL = 1e-5  # fp32 on both sides; DFT and mel sums in another order


def test_constants():
    for name in ("SAMPLE_RATE", "N_FFT", "HOP_LENGTH", "N_SAMPLES", "N_FRAMES", "TOKENS_PER_SECOND"):
        assert getattr(PA, name) == getattr(JA, name)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_filters_and_stft_constants(n_mels):
    np.testing.assert_array_equal(PA.mel_filters(n_mels), JA.mel_filters(n_mels))
    for a, b in zip(PA._stft_constants(), JA._stft_constants()):
        np.testing.assert_array_equal(a, b)


def test_pad_or_trim_numpy_and_torch():
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    for length in (3, 5, 8):
        want = JA.pad_or_trim(x, length)
        np.testing.assert_array_equal(PA.pad_or_trim(x, length), want)
        np.testing.assert_array_equal(PA.pad_or_trim(torch.from_numpy(x), length).numpy(), want)
    np.testing.assert_array_equal(PA.pad_or_trim(x, 1, axis=0), JA.pad_or_trim(x, 1, axis=0))


def test_plain_k4_matches_pallas_kernel_30s():
    """K4's plain version vs the Pallas kernel (interpret) on a 3000-frame clip."""
    audio = waveforms(1, 3000, seed=0)
    want = np.asarray(log_mel_spectrogram_pallas(audio, n_mels=80, interpret=True))
    got = PA.log_mel_spectrogram(audio, device="cpu").numpy()
    assert got.shape == want.shape == (1, 80, 3000)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


# 128 mels: the narrow low bands hold one or two DFT bins, so a bin's fp32
# rounding is not averaged away and reaches ~1.3e-5 after log10
@pytest.mark.parametrize("n_mels,atol", [(80, ATOL), (128, 2 * ATOL)])
def test_log_mel_matches_xla_path_192_frames(n_mels, atol):
    audio = waveforms(2, 192, seed=1)
    want = np.asarray(JA.log_mel_spectrogram_jax(audio, n_mels=n_mels))
    got = PA.log_mel_spectrogram(audio, n_mels=n_mels, device="cpu").numpy()
    assert got.shape == want.shape == (2, n_mels, 192)
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_log_mel_long_form_padding_bucket():
    """padding >= N_FFT: zero-extend to a 30 s multiple, keep the true frames."""
    audio = np.random.RandomState(2).randn(int(PA.N_SAMPLES * 0.37)).astype(np.float32) * 0.1
    want = np.asarray(JA.log_mel_spectrogram(audio, padding=PA.N_SAMPLES, use_pallas=False))
    got = PA.log_mel_spectrogram(audio, padding=PA.N_SAMPLES, device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_log_mel_of_wav_file(tmp_path):
    audio = waveforms(1, 200, seed=3)[0]
    path = str(tmp_path / "clip.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())
    np.testing.assert_array_equal(PA.load_audio(path), JA._read_wav(path)[0])
    want = np.asarray(JA.log_mel_spectrogram_jax(JA._read_wav(path)[0]))
    np.testing.assert_allclose(PA.log_mel_spectrogram(path, device="cpu").numpy(), want, atol=ATOL, rtol=0)


def test_wrapper_on_cpu_is_the_plain_version():
    audio = torch.from_numpy(waveforms(2, 64, seed=4))
    padded = torch.nn.functional.pad(audio[:, None], (200, 200), mode="reflect")[:, 0].contiguous()
    torch.testing.assert_close(PM.log_mel(padded, 64, 80), PM.log_mel_plain(padded, 64, 80), rtol=0, atol=0)


@pytest.mark.cuda
def test_k4_kernel_matches_plain_on_card(cuda_device):  # noqa: F811
    """Ragged frame count (not a multiple of the 32-frame tile)."""
    audio = torch.from_numpy(waveforms(3, 1001, seed=5)).to(cuda_device)
    got = PA.log_mel_spectrogram(audio)
    padded = torch.nn.functional.pad(audio[:, None], (200, 200), mode="reflect")[:, 0].contiguous()
    plain = PM.log_mel_plain(padded, 1001, 80)
    plain = (torch.maximum(plain, plain.amax(dim=(-2, -1), keepdim=True) - 8.0) + 4.0) / 4.0
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-4)
