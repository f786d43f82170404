"""K4's factored DFT: a torch-fp32 emulation of the kernel's order
(`csrc/mel.cu`: the windowed frame's 20-point DFTs over n1, twiddles,
20-point DFTs over n2, then each mel over its filter's nonzero bins) against
the JAX frontend (`log_mel_spectrogram_jax` and the Pallas kernel in
interpret mode), the kernel's constants and mel ranges, and the CUDA kernel
against its plain version on the card (marked `cuda`, skipped without one)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.ops.pallas_mel import log_mel_spectrogram_pallas
from asr_ttl_mtl_tpu_torch import audio as PA
from asr_ttl_mtl_tpu_torch.ops import mel as PM

from torch_port_helpers import cuda_device, waveforms  # noqa: F401

ATOL = 1e-5  # fp32 on both sides; DFT and mel sums in another order (as tests/test_torch_audio.py)
# 128 mels: the narrow low bands hold one or two DFT bins, so a bin's fp32
# rounding is not averaged away (as tests/test_torch_audio.py)
ATOLS = {80: ATOL, 128: 2 * ATOL}


def _roots():
    """cos and sin of 2 pi m / 20 for m = 0..19, from the kernel's 11 + 11."""
    c = PM.dft_constants()
    cos11, sin11 = c[400:411], c[411:422]
    cos20 = np.array([cos11[m] if m <= 10 else cos11[20 - m] for m in range(20)], np.float32)
    sin20 = np.array([sin11[m] if m <= 10 else -sin11[20 - m] for m in range(20)], np.float32)
    return torch.from_numpy(cos20), torch.from_numpy(sin20)


def _power_factored(padded: torch.Tensor, n_frames: int) -> torch.Tensor:
    """(B, L) fp32 -> (B, T, 201) power, in the kernel's order of operations
    (its fused multiply-adds as a product then a sum)."""
    c = torch.from_numpy(PM.dft_constants())
    win, tw_re, tw_im = c[:400], c[422:822].reshape(20, 20), c[822:1222].reshape(20, 20)
    cos20, sin20 = _roots()
    frames = padded.unfold(-1, 400, 160)[:, :n_frames]
    xw = (frames * win).reshape(*frames.shape[:2], 20, 20)  # [..., n1, n2]: sample 20 n1 + n2
    x0, x10 = xw[..., 0, :], xw[..., 10, :]
    a = [None] + [xw[..., n1, :] + xw[..., 20 - n1, :] for n1 in range(1, 10)]
    d = [None] + [xw[..., n1, :] - xw[..., 20 - n1, :] for n1 in range(1, 10)]
    y_re, y_im = [], []  # Y[k1, n2] for k1 = 0..10
    for k1 in range(11):
        re = x0 - x10 if k1 & 1 else x0 + x10
        im = torch.zeros_like(re)
        for n1 in range(1, 10):
            re = re + a[n1] * cos20[n1 * k1 % 20]
        if k1 not in (0, 10):
            for n1 in range(1, 10):
                im = im + (-d[n1]) * sin20[n1 * k1 % 20]
        y_re.append(re)
        y_im.append(im)
    power = torch.empty(*frames.shape[:2], 201)
    for k1 in range(20):
        src, sign = (k1, 1.0) if k1 <= 10 else (20 - k1, -1.0)
        yr, yi = y_re[src], sign * y_im[src]
        zr = yr * tw_re[k1] - yi * tw_im[k1]  # (..., n2)
        zi = yr * tw_im[k1] + yi * tw_re[k1]
        ar = [None] + [zr[..., n2] + zr[..., 20 - n2] for n2 in range(1, 10)]
        ai = [None] + [zi[..., n2] + zi[..., 20 - n2] for n2 in range(1, 10)]
        dr = [None] + [zr[..., n2] - zr[..., 20 - n2] for n2 in range(1, 10)]
        di = [None] + [zi[..., n2] - zi[..., 20 - n2] for n2 in range(1, 10)]
        if k1 == 0:
            nr, ni = zr[..., 0] + zr[..., 10], zi[..., 0] + zi[..., 10]
            for n2 in range(1, 10):
                nr = nr - ar[n2] if n2 & 1 else nr + ar[n2]
                ni = ni - ai[n2] if n2 & 1 else ni + ai[n2]
            power[..., 200] = nr * nr + ni * ni
        for k2 in range(10):
            re = zr[..., 0] - zr[..., 10] if k2 & 1 else zr[..., 0] + zr[..., 10]
            im = zi[..., 0] - zi[..., 10] if k2 & 1 else zi[..., 0] + zi[..., 10]
            for n2 in range(1, 10):
                cc, ss = cos20[n2 * k2 % 20], sin20[n2 * k2 % 20]
                re = re + ar[n2] * cc
                re = re + di[n2] * ss
                im = im + ai[n2] * cc
                im = im + (-dr[n2]) * ss
            power[..., k1 + 20 * k2] = re * re + im * im
    return power


def _mel_sparse(power: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, T, 201) -> (B, T, n_mels): each mel over [lo, hi) in bin order."""
    lo, hi, off, w = PM.mel_ranges(n_mels)
    w = torch.from_numpy(w)
    out = torch.zeros(*power.shape[:2], n_mels)
    for m in range(n_mels):
        acc = torch.zeros(power.shape[:2])
        for k in range(lo[m], hi[m]):
            acc = acc + power[..., k] * w[off[m] + k - lo[m]]
        out[..., m] = acc
    return out


def _mel_dense(power: torch.Tensor, n_mels: int) -> torch.Tensor:
    """(B, T, 201) -> (B, T, n_mels): the dense product summed in bin order."""
    fb = torch.from_numpy(PA.mel_filters(n_mels))  # (n_mels, 201)
    acc = torch.zeros(*power.shape[:2], n_mels)
    for k in range(201):
        acc = acc + power[..., k : k + 1] * fb[:, k]
    return acc


def _emulated_log_mel_spectrogram(audio: np.ndarray, n_mels: int) -> np.ndarray:
    """`audio.log_mel_spectrogram` with K4 replaced by the emulation."""
    x = torch.from_numpy(audio)
    n_frames = x.shape[-1] // 160
    padded = F.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
    mel = _mel_sparse(_power_factored(padded, n_frames), n_mels)
    log_spec = torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).numpy()


def test_dft_constants():
    c = PM.dft_constants()
    assert c.dtype == np.float32 and c.shape == (1222,)
    cos_b, sin_b = PA._stft_constants()
    np.testing.assert_array_equal(c[:400], cos_b[:, 0])  # the window the bases fold in
    np.testing.assert_array_equal(c[[400, 410, 411]], [1.0, -1.0, 0.0])
    np.testing.assert_array_equal(c[422:442], np.ones(20, np.float32))  # k1 = 0: W^0
    k1, n2 = 3, 7
    w = np.exp(-2j * np.pi * k1 * n2 / 400)
    np.testing.assert_allclose([c[422 + k1 * 20 + n2], c[822 + k1 * 20 + n2]], [w.real, w.imag], rtol=0, atol=1e-7)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_mel_ranges_cover_the_filterbank(n_mels):
    """Each filter's nonzero weights lie in [lo, hi), stored in bin order;
    no bin feeds more than two filters."""
    fb = PA.mel_filters(n_mels)
    lo, hi, off, w = PM.mel_ranges(n_mels)
    rebuilt = np.zeros_like(fb)
    for m in range(n_mels):
        rebuilt[m, lo[m] : hi[m]] = w[off[m] : off[m] + hi[m] - lo[m]]
        assert lo[m] <= hi[m] and (hi[m] == lo[m] or (fb[m, lo[m]] != 0 and fb[m, hi[m] - 1] != 0))
    np.testing.assert_array_equal(rebuilt, fb)
    assert off[-1] + hi[-1] - lo[-1] == w.size
    assert ((fb != 0).sum(axis=0) <= 2).all()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_sparse_mel_gives_the_bits_of_the_dense_bin_order_sum(n_mels):
    rng = np.random.RandomState(n_mels)
    power = torch.from_numpy((rng.rand(2, 40, 201) ** 4 * 50).astype(np.float32))
    power[0, 3] = 0.0  # a silent frame
    assert torch.equal(_mel_sparse(power, n_mels), _mel_dense(power, n_mels))


def _exact_log_mel_spectrogram(audio: np.ndarray, n_mels: int) -> np.ndarray:
    """The same function in float64 through torch.fft.rfft: the oracle both
    fp32 orders are measured from."""
    x = torch.from_numpy(audio).double()
    n_frames = x.shape[-1] // 160
    padded = F.pad(x[:, None], (200, 200), mode="reflect")[:, 0]
    window = 0.5 * (1.0 - torch.cos(2.0 * np.pi * torch.arange(400, dtype=torch.float64) / 400))
    power = torch.fft.rfft(padded.unfold(-1, 400, 160)[:, :n_frames] * window, dim=-1).abs() ** 2
    mel = power @ torch.from_numpy(PA.mel_filters(n_mels)).double().T
    log_spec = torch.log10(torch.clamp(mel, min=1e-10)).transpose(1, 2)
    log_spec = torch.maximum(log_spec, log_spec.amax(dim=(-2, -1), keepdim=True) - 8.0)
    return ((log_spec + 4.0) / 4.0).numpy()


def _assert_matches(got, refs, exact, atol):
    """Within `atol` of the float64 value, and of each fp32 reference within
    `atol` plus that reference's own distance from the float64 value (at
    128 mels the single-bin low bands keep a bin's fp32 rounding: the XLA
    path is up to ~5e-5 from the float64 value on some inputs)."""
    np.testing.assert_array_less(np.abs(got - exact), atol)
    for ref in refs:
        np.testing.assert_array_less(np.abs(got - ref), atol + np.abs(ref - exact) + 1e-7)


@pytest.mark.parametrize("n_mels", [80, 128])
@pytest.mark.parametrize("n_frames", [600, 3000])
def test_factored_order_matches_pallas_and_xla(n_frames, n_mels):
    """The kernel's order, after the finish, against the Pallas kernel
    (interpret), the XLA path and the float64 value."""
    audio = waveforms(1, n_frames, seed=n_frames + n_mels)
    got = _emulated_log_mel_spectrogram(audio, n_mels)
    assert got.shape == (1, n_mels, n_frames)
    refs = (np.asarray(JA.log_mel_spectrogram_jax(audio, n_mels=n_mels)),
            np.asarray(log_mel_spectrogram_pallas(audio, n_mels=n_mels, interpret=True)))
    _assert_matches(got, refs, _exact_log_mel_spectrogram(audio, n_mels), ATOLS[n_mels])


@pytest.mark.parametrize("n_mels", [80, 128])
def test_factored_order_matches_xla_ragged_192_frames(n_mels):
    audio = waveforms(2, 192, seed=7)
    got = _emulated_log_mel_spectrogram(audio, n_mels)
    want = np.asarray(JA.log_mel_spectrogram_jax(audio, n_mels=n_mels))
    assert got.shape == want.shape == (2, n_mels, 192)
    _assert_matches(got, (want,), _exact_log_mel_spectrogram(audio, n_mels), ATOLS[n_mels])


def test_factored_power_matches_the_direct_dft():
    """Before the log: the emulated power against the plain version's direct
    products with the Hann-folded bases, relative to each frame's largest bin."""
    audio = torch.from_numpy(waveforms(2, 64, seed=9))
    padded = F.pad(audio[:, None], (200, 200), mode="reflect")[:, 0].contiguous()
    got = _power_factored(padded, 64)
    cos_b, sin_b, _ = PM._constants(80, torch.device("cpu"))
    frames = padded.unfold(-1, 400, 160)[:, :64].double()
    want = (frames @ cos_b.double()) ** 2 + (frames @ sin_b.double()) ** 2
    scale = want.amax(dim=-1, keepdim=True)
    assert float(((got.double() - want).abs() / scale).max()) < 1e-6


# ------------------------------------------------------------ the card ----


@pytest.mark.cuda
@pytest.mark.parametrize(
    "batch,n_frames", [(32, 3000), (1, 12000), (16, 3000)], ids=["32x30s", "cli-120s", "train-16x30s"]
)
def test_k4_kernel_at_the_measured_shapes(cuda_device, batch, n_frames):  # noqa: F811
    """The shapes chip_smoke.py times: 32 x 30 s, the CLI's 70 s WAV bucketed
    to 120 s, the train step's 16 x 30 s; within 1e-4 after the finish at
    80 mels (chip_smoke's tolerance), twice that at 128, where a band of one
    or two bins keeps a bin's fp32 rounding (the CPU tests' convention): on
    white noise either fp32 order reaches ~1e-4 from the float64 value at
    a few single-bin entries of millions. The kernel is also held to the
    float64 value (torch.fft) within the same limits."""
    gen = torch.Generator(device=cuda_device).manual_seed(batch + n_frames)
    wave = torch.randn((batch, n_frames * 160), generator=gen, device=cuda_device) * 0.1
    padded = F.pad(wave[:, None], (200, 200), mode="reflect")[:, 0].contiguous()

    def finish(x):
        return (torch.maximum(x, x.amax(dim=(-2, -1), keepdim=True) - 8.0) + 4.0) / 4.0

    window = torch.hann_window(400, dtype=torch.float64, device=cuda_device)
    power = torch.fft.rfft(padded.unfold(-1, 400, 160)[:, :n_frames].double() * window, dim=-1).abs() ** 2
    for n_mels in (80, 128):
        atol = {80: 1e-4, 128: 2e-4}[n_mels]
        got, want = PM.log_mel(padded, n_frames, n_mels), PM.log_mel_plain(padded, n_frames, n_mels)
        torch.cuda.synchronize()
        torch.testing.assert_close(finish(got), finish(want), rtol=0, atol=atol)
        fb = torch.from_numpy(PA.mel_filters(n_mels)).to(cuda_device).double()
        exact = finish(torch.log10(torch.clamp(power @ fb.T, min=1e-10)).transpose(1, 2))
        torch.testing.assert_close(finish(got).double(), exact, rtol=0, atol=atol)
