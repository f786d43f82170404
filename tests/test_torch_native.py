"""Audio files in: the port's native C++ runtime, ffmpeg routing, the
`mel_fp16` transfer mel and the model registry's names, against the JAX
package on the same inputs.

The native runtime is the same source built with the same flags by the same
compiler, so its outputs are held to the JAX runtime's bit for bit, and both
to scipy's resample_poly within 2e-6. ffmpeg is a stand-in script put first
on PATH, which writes the s16le bytes of a known WAV."""

import os
import stat
import struct
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as jaudio
from asr_ttl_mtl_tpu.models import registry as jregistry
from asr_ttl_mtl_tpu.runtime import wav as jwav

from asr_ttl_mtl_tpu_torch import audio as paudio
from asr_ttl_mtl_tpu_torch.models import registry as pregistry
from asr_ttl_mtl_tpu_torch.runtime import build as pbuild
from asr_ttl_mtl_tpu_torch.runtime import wav as pwav


def write_pcm(path, data, sr, sampwidth=2, channels=1):
    """A PCM WAV of `data` (floats in [-1, 1], interleaved when stereo)."""
    data = np.clip(np.asarray(data, np.float64), -1, 1)
    if sampwidth == 1:
        raw = (data * 127 + 128).astype(np.uint8).tobytes()
    elif sampwidth == 2:
        raw = (data * 32767).astype("<i2").tobytes()
    elif sampwidth == 3:
        i32 = (data * ((1 << 23) - 1)).astype(np.int32)
        raw = np.stack([i32 & 0xFF, (i32 >> 8) & 0xFF, (i32 >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
    else:
        raw = (data * (2**31 - 1)).astype("<i4").tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(sampwidth)
        w.setframerate(sr)
        w.writeframes(raw)


def write_float(path, data, sr, bits=32):
    body = np.asarray(data, np.float32 if bits == 32 else np.float64).tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, 1, sr, sr * bits // 8, bits // 8, bits))
        f.write(b"data" + struct.pack("<I", len(body)) + body)


def tone(n, sr, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(n) / sr
    return (0.4 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.randn(n)).astype(np.float32)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """name -> path: every sample format both readers take, and the broken files."""
    d = tmp_path_factory.mktemp("wavs")
    out = {}
    for width in (1, 2, 3, 4):
        out[f"pcm{8 * width}"] = str(d / f"pcm{8 * width}.wav")
        write_pcm(out[f"pcm{8 * width}"], tone(8000, 16000), 16000, sampwidth=width)
    out["float32"] = str(d / "f32.wav")
    write_float(out["float32"], tone(8000, 16000), 16000)
    out["float64"] = str(d / "f64.wav")
    write_float(out["float64"], tone(8000, 16000), 16000, bits=64)
    out["stereo"] = str(d / "stereo.wav")
    write_pcm(out["stereo"], np.stack([tone(8000, 16000), tone(8000, 16000, 1)], 1).reshape(-1), 16000, channels=2)
    out["sr44100"] = str(d / "cd.wav")
    write_pcm(out["sr44100"], tone(44100 // 2, 44100), 44100)
    out["sr22050"] = str(d / "half.wav")
    write_pcm(out["sr22050"], tone(22050 // 2, 22050), 22050, sampwidth=3)
    with open(out["pcm16"], "rb") as f:
        blob = f.read()
    out["truncated"] = str(d / "truncated.wav")
    with open(out["truncated"], "wb") as f:
        f.write(blob[:44 + 1000])  # the data chunk shorter than its header says
    out["tiny"] = str(d / "tiny.wav")
    with open(out["tiny"], "wb") as f:
        f.write(blob[:30])
    out["not_riff"] = str(d / "not_riff.wav")
    with open(out["not_riff"], "wb") as f:
        f.write(b"this is not audio at all, not even a little bit of it")
    out["missing"] = str(d / "missing.wav")
    return out


READABLE = ("pcm8", "pcm16", "pcm24", "pcm32", "float32", "float64", "stereo", "sr44100", "sr22050", "truncated")


@pytest.mark.parametrize("name", READABLE)
def test_read_bitwise_against_jax_runtime(wavs, name):
    got, sr = pwav.read(wavs[name])
    want, want_sr = jwav.read(wavs[name])
    assert sr == want_sr and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if name != "float64":  # the stdlib reader takes no 64-bit floats
        py, py_sr = paudio._read_wav(wavs[name])
        assert py_sr == sr
        np.testing.assert_allclose(got, py, atol=1e-6)


@pytest.mark.parametrize("name", ("tiny", "not_riff", "missing"))
def test_read_errors_as_jax(wavs, name):
    with pytest.raises(RuntimeError) as got:
        pwav.read(wavs[name])
    with pytest.raises(RuntimeError) as want:
        jwav.read(wavs[name])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("orig", (44100, 22050, 8000, 48000))
def test_resample_bitwise_against_jax_and_scipy(orig):
    x = np.random.RandomState(orig).randn(orig // 2).astype(np.float32) * 0.3
    got = pwav.resample(x, orig, 16000)
    np.testing.assert_array_equal(got, jwav.resample(x, orig, 16000))
    np.testing.assert_allclose(got, paudio.resample(x, orig, 16000), atol=2e-6)
    np.testing.assert_array_equal(pwav.resample(x, 16000, 16000), x)


def test_load_batch_bitwise_against_jax(wavs):
    names = (*READABLE, "tiny", "not_riff", "missing")
    paths = [wavs[n] for n in names]
    before = pwav.CALLS["load_batch"]
    got, status = pwav.load_batch(paths, 16000, 6000, n_threads=3)
    want, want_status = jwav.load_batch(paths, 16000, 6000, n_threads=3)
    assert pwav.CALLS["load_batch"] == before + 1
    assert status == want_status
    np.testing.assert_array_equal(got, want)
    assert [s for s in status if s < 0] == [-2, -4, -1] and not got[-3:].any()


def test_build_is_cached_and_atomic(tmp_path, monkeypatch):
    """The library is named by its source's hash; a second build reuses
    it; no temporary file is left behind."""
    path = pbuild.build_library()
    assert os.path.dirname(path) == pbuild.BUILD_DIR and os.path.basename(path).startswith("libaudio_decoder-")
    assert pbuild.build_library() == path
    assert not [f for f in os.listdir(pbuild.BUILD_DIR) if f.startswith("tmp") and f.endswith(".so")]
    monkeypatch.setattr(pbuild, "compiler", lambda: None)
    monkeypatch.setattr(pbuild, "BUILD_DIR", str(tmp_path))
    with pytest.raises(ImportError):
        pbuild.build_library()


def test_no_compiler_takes_the_python_reader(wavs, monkeypatch):
    """Where the runtime cannot be built, `load_audio` reads WAVs with the
    Python reader (the JAX package's fallback)."""
    monkeypatch.setattr(pwav, "_LIB", None)
    monkeypatch.setattr(pwav, "_open", lambda: (_ for _ in ()).throw(ImportError("no compiler")))
    monkeypatch.setenv("PATH", "")
    got = paudio.load_audio(wavs["pcm16"])
    np.testing.assert_array_equal(got, paudio._read_wav(wavs["pcm16"])[0])


# --- ffmpeg -------------------------------------------------------------------

FAKE_FFMPEG = """#!{python}
import sys, wave
args = sys.argv[1:]
src, rate = args[args.index("-i") + 1], int(args[args.index("-ar") + 1])
if "broken" in src:
    sys.stderr.write("{{}}: Invalid data found when processing input\\n".format(src))
    sys.exit(1)
with wave.open({known!r}, "rb") as w:
    assert w.getframerate() == rate and w.getsampwidth() == 2 and w.getnchannels() == 1
    sys.stdout.buffer.write(w.readframes(w.getnframes()))
"""


@pytest.fixture
def fake_ffmpeg(tmp_path, monkeypatch, wavs):
    """A stand-in `ffmpeg` first on PATH: it writes the s16le bytes of the
    16 kHz pcm16 WAV for any input, and fails with a message on stderr for
    a path containing "broken"."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    exe = bindir / "ffmpeg"
    exe.write_text(FAKE_FFMPEG.format(python=sys.executable, known=wavs["pcm16"]))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ.get('PATH', '')}")
    return tmp_path


def test_load_audio_routes_through_ffmpeg(fake_ffmpeg, wavs):
    flac = str(fake_ffmpeg / "clip.flac")
    with open(flac, "wb") as f:
        f.write(b"fLaC not really")
    got = paudio.load_audio(flac)
    np.testing.assert_array_equal(got, jaudio.load_audio(flac))
    np.testing.assert_array_equal(got, paudio._read_wav(wavs["pcm16"])[0])
    # a .wav stays native; one the native reader refuses goes to ffmpeg
    np.testing.assert_array_equal(paudio.load_audio(wavs["sr44100"]), jaudio.load_audio(wavs["sr44100"]))
    np.testing.assert_array_equal(paudio.load_audio(wavs["not_riff"]), got)


def test_ffmpeg_failure_carries_its_stderr(fake_ffmpeg):
    broken = str(fake_ffmpeg / "broken.mp3")
    open(broken, "wb").close()
    with pytest.raises(RuntimeError, match="Invalid data found when processing input") as got:
        paudio.load_audio(broken)
    with pytest.raises(RuntimeError) as want:
        jaudio.load_audio(broken)
    assert str(got.value) == str(want.value)


def test_without_ffmpeg_a_non_wav_file_raises(wavs, monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    flac = str(tmp_path / "clip.flac")
    with open(flac, "wb") as f:
        f.write(b"fLaC not really")
    with pytest.raises(RuntimeError):
        paudio.load_audio(flac)


# --- the mel_fp16 transfer ----------------------------------------------------

def fp16_steps(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| of two fp16 arrays in fp16 steps: the step of the
    larger of the two, and at least 2^-8's (3.8e-6), since the fp32 mels
    round by ~1e-6 themselves and a value near 0 has finer fp16 steps."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.float16(2.0**-8))
    step = np.spacing(mag).astype(np.float64)
    return float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64)) / step))


TRANSFER_CASES = {
    # a clip shorter than its bucket; energy up to the bucket edge (the last
    # two shipped frames reach into the final N_FFT / 2 samples); a dense
    # clip filling the window, whose device mel reflects its tail
    "short": (11200, 16000),
    "edge": (16000, 16000),
    "dense": (64000, 64000),
}


@pytest.mark.parametrize("case", TRANSFER_CASES)
def test_transfer_mel_against_jax(case):
    n, bucket = TRANSFER_CASES[case]
    clip = np.random.RandomState(7).randn(2, n).astype(np.float32) * 0.2
    wave_b = np.pad(clip, ((0, 0), (0, bucket - n)))
    shipped = paudio.log_mel_for_transfer(wave_b, full_samples=64000)
    want = jaudio.log_mel_for_transfer(wave_b, full_samples=64000)
    assert shipped.dtype == np.float16 and shipped.shape == want.shape
    assert shipped.shape == ((2, 80, 400) if case == "dense" else (2, 80, bucket // 160 + 2))
    assert fp16_steps(shipped, want) <= 1.0
    got = paudio.finish_transfer_mel(torch.from_numpy(shipped), 64000)
    full = np.asarray(jaudio.log_mel_spectrogram_jax(jnp.asarray(np.pad(clip, ((0, 0), (0, 64000 - n))))))
    assert got.dtype == torch.float32 and tuple(got.shape) == full.shape == (2, 80, 400)
    np.testing.assert_allclose(got.numpy(), full, atol=3e-3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jaudio.finish_transfer_mel(jnp.asarray(shipped), 64000)),
                               atol=1e-6)


# --- the registry's names ---------------------------------------------------

def test_available_models_as_jax():
    assert pregistry.available_models() == jregistry.available_models()
    assert {n: pregistry._FILE_NAMES[n] for n in pregistry.available_models()} == {
        n: os.path.basename(u) for n, u in jregistry._CHECKPOINT_URLS.items()}


def test_cached_checkpoint_search_and_refusal(tmp_path, monkeypatch):
    """The JAX search order ($ASRMTL_CHECKPOINT_DIR, the download root,
    ~/.cache/whisper), each file held to its SHA-256; an absent name raises
    the JAX message and fetches nothing."""
    env, root = tmp_path / "env", tmp_path / "root"
    env.mkdir()
    root.mkdir()
    for d, payload in ((env, b"env copy"), (root, b"root copy")):
        (d / "tiny.pt").write_bytes(payload)
    monkeypatch.setenv("ASRMTL_CHECKPOINT_DIR", str(env))
    monkeypatch.setenv("HOME", str(tmp_path))
    import hashlib

    for payload, where in ((b"root copy", root), (b"env copy", env)):
        sha = hashlib.sha256(payload).hexdigest()
        monkeypatch.setitem(pregistry._CHECKPOINT_SHAS, "tiny", sha)
        monkeypatch.setitem(jregistry._CHECKPOINT_SHAS, "tiny", sha)
        got = pregistry._find_cached_checkpoint("tiny", str(root))
        assert got == str(where / "tiny.pt") == jregistry._find_cached_checkpoint("tiny", str(root))
    monkeypatch.setitem(pregistry._CHECKPOINT_SHAS, "tiny", "0" * 64)
    assert pregistry._find_cached_checkpoint("tiny", str(root)) is None
    with pytest.raises(RuntimeError, match=r"Model tiny not found; available models = \['tiny.en', 'tiny'"):
        pregistry.load_model("tiny", device="cpu", download_root=str(root))
    with pytest.raises(RuntimeError, match="Model nope.pt not found"):
        pregistry.load_model("nope.pt", device="cpu")


def test_cli_accepts_the_available_names():
    from asr_ttl_mtl_tpu_torch.cli import build_parser

    parser = build_parser()
    for name in pregistry.available_models():
        assert parser.parse_args(["a.wav", "--model", name]).model == name
    with pytest.raises(SystemExit):
        parser.parse_args(["a.wav", "--model", "no-such-model"])
