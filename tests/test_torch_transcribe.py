"""Long-form transcribe, the writers and the CLI: the port against the JAX
package's `transcribe`, writers and `build_parser` on the same weights,
waveform and results."""

import itertools
import json
import os
import wave

import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu.cli import build_parser as jax_build_parser
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.transcribe import transcribe as jax_transcribe
from asr_ttl_mtl_tpu.utils import writers as JWR
from asr_ttl_mtl_tpu_torch import cli as PC
from asr_ttl_mtl_tpu_torch import transcribe as PT
from asr_ttl_mtl_tpu_torch.models import ModelDimensions as TorchDims
from asr_ttl_mtl_tpu_torch.models import checkpoint_dict, from_random
from asr_ttl_mtl_tpu_torch.utils import writers as PWR

from torch_port_helpers import SMALL, model_pair

LP_TOL = 1e-4
SR = 16000
# 3000-frame windows need the full 1500 audio positions; a 128-token text
# context leaves the prompt room to grow over the windows
DIMS = dict(n_audio_ctx=1500, n_text_ctx=128)
# the ladder's first rung decodes a beam of 2, the second samples 2; the
# logprob gate is off, since random weights score near -10 and would send
# every window to the sampled rung, whose random numbers differ between
# the frameworks
COMMON = dict(temperature=(0.0, 0.4), beam_size=2, best_of=2, sample_len=16, logprob_threshold=None,
              verbose=None, fp16=False)


def _tones(seconds: float, seed: int) -> np.ndarray:
    """Seeded tones with silent gaps, plus a little noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * SR)) / SR
    sound = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 1250 * t * (1 + 0.1 * np.sin(t)))
    gate = np.sin(2 * np.pi * 0.2 * t) > -0.3
    return (sound * gate + 0.02 * rng.randn(t.size)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jmodel, tmodel = model_pair(seed=2, **DIMS)
    return jmodel, tmodel, _tones(45.0, seed=5)


def _compare(jout, tout):
    assert tout["text"] == jout["text"] and tout["language"] == jout["language"]
    assert len(tout["segments"]) == len(jout["segments"])
    for j, t in zip(jout["segments"], tout["segments"]):
        assert set(t) == set(j)
        for key in ("id", "seek", "start", "end", "text", "tokens", "temperature"):
            assert t[key] == j[key], key
        assert abs(t["avg_logprob"] - j["avg_logprob"]) <= LP_TOL
        assert abs(t["no_speech_prob"] - j["no_speech_prob"]) <= LP_TOL
        assert t["compression_ratio"] == pytest.approx(j["compression_ratio"])


@pytest.mark.parametrize(
    "extra",
    [
        dict(),
        # compression gate off too: on these weights the prompted first rung
        # repeats itself and would fall to the sampled rung
        dict(initial_prompt="hello there", carry_initial_prompt=True, compression_ratio_threshold=None),
        dict(clip_timestamps="3,20,25"),
    ],
    ids=["conditioned", "initial-prompt-carried", "clip-timestamps"],
)
def test_transcribe_matches_jax(setup, extra):
    """Identical text and segments over a 45 s waveform (2 windows and more);
    the JAX side takes its plain top-k (tests/test_pallas_topk.py shows the
    kernel gives the same tokens)."""
    jmodel, tmodel, audio = setup
    JW.set_decode_kernel("off")
    try:
        jout = jax_transcribe(jmodel, audio, **COMMON, **extra)
    finally:
        JW.set_decode_kernel("auto")
    tout = PT.transcribe(tmodel, audio, **COMMON, **extra)
    _compare(jout, tout)
    assert len({s["seek"] for s in tout["segments"]}) >= 2


def test_hot_rung_resets_the_prompt(setup, monkeypatch):
    """Every window fails the gates (logprob 0), so each keeps its last,
    sampled rung (t = 0.6 > 0.5): later windows get no prompt."""
    _, tmodel, audio = setup
    prompts, decode = [], tmodel.decode

    def recording(mel, options=None, **kw):
        prompts.append(list(options.prompt or []))
        return decode(mel, options, **kw)

    monkeypatch.setattr(tmodel, "decode", recording)
    kw = dict(COMMON, temperature=(0.0, 0.6), logprob_threshold=0.0, language="en")
    out = PT.transcribe(tmodel, audio[: 35 * SR], **kw)
    assert {s["temperature"] for s in out["segments"]} == {0.6}
    assert len(prompts) >= 4 and all(p == [] for p in prompts)


def test_helpers_match_jax():
    import importlib

    from asr_ttl_mtl_tpu import utils as JU
    from asr_ttl_mtl_tpu_torch import utils as PU

    JT = importlib.import_module("asr_ttl_mtl_tpu.transcribe")  # the package exports a function of that name
    for clips in ("0", "", "3,20,25", [1.5, 4.0], "0,10.5,12"):
        assert PT._parse_clip_ranges(clips, 4500) == JT._parse_clip_ranges(clips, 4500)
    decode_options = dict(beam_size=5, patience=2.0, best_of=5, language="en")
    for t in (0.0, 0.2):
        assert PT.options_at_temperature(decode_options, t).__dict__ == JT.options_at_temperature(
            decode_options, t).__dict__
    for s in ("True", "False", "None", "7", "0.25"):
        for fn in ("str2bool", "optional_int", "optional_float"):
            try:
                want = getattr(JU, fn)(s)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(PU, fn)(s)
                continue
            assert getattr(PU, fn)(s) == want
    segs = [{"start": 1.0, "end": 2.0, "words": []}, {"start": 2.5, "end": 3.0, "words": [{"start": 2.6, "end": 2.9}]}]
    for s in (segs, segs[:1], []):
        assert (PU.get_start(s), PU.get_end(s)) == (JU.get_start(s), JU.get_end(s))
    assert PU.make_safe("héllo") == JU.make_safe("héllo")


# ------------------------------------------------------------- writers ----


def _result(seed: int, with_words: bool = True):
    """A seeded transcription result whose segments carry `words`."""
    r = np.random.RandomState(seed)
    vocab = ["a", "hello", "neuropsychological", "it's", "x", "—", "  ", "ok?", "tab\there", "-->"]
    t, segments = 0.0, []
    for sid in range(r.randint(1, 6)):
        words = []
        for _ in range(r.randint(0, 9)):
            t += float(r.choice([0.05, 0.4, 1.0, 4.5], p=[0.4, 0.3, 0.2, 0.1]))
            dur = float(r.uniform(0.05, 1.2))
            words.append({"word": " " + str(r.choice(vocab)), "start": round(t, 2), "end": round(t + dur, 2),
                          "probability": 0.9})
            t += dur
        text = "".join(w["word"] for w in words)
        seg = {"id": sid, "seek": 0, "start": words[0]["start"] if words else round(t, 2),
               "end": words[-1]["end"] if words else round(t + 1, 2), "text": text, "tokens": [1, 2]}
        if with_words:
            seg["words"] = words
        segments.append(seg)
    return {"text": "".join(s["text"] for s in segments), "language": "en", "segments": segments}


WRITER_OPTIONS = [
    {},
    {"highlight_words": True},
    {"max_line_width": 8},
    {"max_line_width": 12, "max_line_count": 2},
    {"max_line_width": 5, "max_line_count": 3, "highlight_words": True},
    {"max_words_per_line": 1},
    {"max_words_per_line": 3, "max_line_width": 14, "max_line_count": 2},
]


@pytest.mark.parametrize("fmt", ["txt", "vtt", "srt", "tsv", "json", "all"])
def test_writers_match_jax(tmp_path, fmt):
    """Byte-identical files for every option set on seeded results, with and
    without words."""
    for n, (seed, opts) in enumerate(itertools.product(range(6), WRITER_OPTIONS)):
        result = _result(seed, with_words=seed != 5)
        jdir, tdir = tmp_path / f"j{n}", tmp_path / f"t{n}"
        jdir.mkdir()
        tdir.mkdir()
        JWR.get_writer(fmt, str(jdir))(dict(result), "clip.wav", **opts)
        PWR.get_writer(fmt, str(tdir))(dict(result), "clip.wav", **opts)
        names = sorted(os.listdir(jdir))
        assert names == sorted(os.listdir(tdir)) and names
        for name in names:
            assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), (seed, opts, name)


# ----------------------------------------------------------------- CLI ----

NOT_PORTED = {"device"}  # a torch device, "cuda" by default (JAX: its default backend)


def test_parser_matches_jax():
    jax_parser, port_parser = jax_build_parser(), PC.build_parser()
    jdefaults = {a.dest: a.default for a in jax_parser._actions}
    pdefaults = {a.dest: a.default for a in port_parser._actions}
    assert set(jdefaults) == set(pdefaults)
    assert {k: v for k, v in jdefaults.items() if k not in NOT_PORTED} == {
        k: v for k, v in pdefaults.items() if k not in NOT_PORTED}
    jchoices = {a.dest: a.choices for a in jax_parser._actions}
    assert jchoices == {a.dest: a.choices for a in port_parser._actions}
    assert pdefaults["device"] == "cuda"


def _write_wav(path, audio):
    pcm = np.clip(audio * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(pcm.tobytes())


def test_cli_writes_all_five_files(tmp_path, capsys):
    """The CLI on the CPU (beam 5 on the first rung; the logprob gate off so
    that random weights do not climb the whole ladder), once with the
    language given and a checkpoint path, once detecting it with a preset
    name whose `<name>.pt` lies in --model_dir. A 32-token text context
    keeps the decodes at 16 tokens."""
    model = from_random(TorchDims(**{**SMALL, **DIMS, "n_text_ctx": 32}), seed=3, device="cpu")
    ckpt, clip = tmp_path / "small.pt", tmp_path / "clip.wav"
    torch.save(checkpoint_dict(model), ckpt)
    _write_wav(clip, _tones(8.0, seed=9))
    runs = (["--model", str(ckpt), "--language", "en"], ["--model", "small", "--model_dir", str(tmp_path)])
    for n, extra in enumerate(runs):
        out = tmp_path / f"out{n}"
        PC.cli([str(clip), "--device", "cpu", "--output_dir", str(out), "--verbose", "False",
                "--logprob_threshold", "None", *extra])
        assert sorted(os.listdir(out)) == [f"clip.{ext}" for ext in ("json", "srt", "tsv", "txt", "vtt")]
        result = json.loads((out / "clip.json").read_text())
        assert result["segments"] and result["language"] in ("en",) + tuple(PC.LANGUAGES)
    assert "Skipping" not in capsys.readouterr().out


def test_cli_refusals(tmp_path):
    ckpt = tmp_path / "small.pt"
    torch.save(checkpoint_dict(from_random(TorchDims(**{**SMALL, **DIMS}), seed=3, device="cpu")), ckpt)
    for argv in (["a.wav", "--model", "base"],  # a preset name and no checkpoint file
                 # the threshold needs the sequential seek loop, as in JAX
                 ["a.wav", "--model", str(ckpt), "--batch_mode", "True", "--hallucination_silence_threshold", "2"],
                 ["a.wav", "--model", "base", "--dp", "2"]):
        with pytest.raises(SystemExit):
            PC.cli(argv + ["--output_dir", str(tmp_path), "--device", "cpu"])
