"""Word timestamps through the port's `transcribe` and CLI against the JAX
package's `transcribe` and writers, with and without the
hallucination-silence heuristics, on the same weights and waveform."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.models.registry import WhisperModel as JaxWhisperModel
from asr_ttl_mtl_tpu.transcribe import transcribe as jax_transcribe
from asr_ttl_mtl_tpu.utils import writers as JWR
from asr_ttl_mtl_tpu_torch import cli as PC
from asr_ttl_mtl_tpu_torch import models as PMOD
from asr_ttl_mtl_tpu_torch import transcribe as PT
from asr_ttl_mtl_tpu_torch.models import ModelDimensions as TorchDims
from asr_ttl_mtl_tpu_torch.models import WhisperModel, checkpoint_dict, from_random, state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.models.registry import _ALIGNMENT_HEADS
from asr_ttl_mtl_tpu_torch.models.whisper import decode_alignment_heads_dump

from test_torch_transcribe import COMMON, DIMS, SR, _tones, _write_wav
from torch_port_helpers import SMALL, jax_dims, np_tree

PROB_TOL = 1e-4
# random weights score every word far below the 0.15 probability the
# hallucination heuristics trust, so every segment would look hallucinated;
# a token embedding 8x its initial scale makes the logits peaked enough that
# some words pass. The compression gate is off: these weights repeat
# themselves, and the sampled rung draws other numbers in each framework.
EMBED_SCALE = 8.0
WORDS = dict(COMMON, compression_ratio_threshold=None, word_timestamps=True)


@pytest.fixture(scope="module")
def setup():
    dims = jax_dims(**DIMS)
    params = JW.init_params(jax.random.PRNGKey(2), dims)
    params["decoder"]["token_embedding"] = params["decoder"]["token_embedding"] * EMBED_SCALE
    jmodel = JaxWhisperModel(dims=dims, params=params, compute_dtype=jnp.float32)
    tmodel = WhisperModel(TorchDims(**{**SMALL, **DIMS}), compute_dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax_params(np_tree(params), dims))
    return jmodel, tmodel.eval().requires_grad_(False), _tones(45.0, seed=5)


def _jax(jmodel, audio, **kw):
    JW.set_decode_kernel("off")  # the JAX side takes its plain path
    try:
        return jax_transcribe(jmodel, audio, **kw)
    finally:
        JW.set_decode_kernel("auto")


def _compare(jout, tout):
    assert tout["text"] == jout["text"] and tout["language"] == jout["language"]
    assert len(tout["segments"]) == len(jout["segments"])
    n_words = 0
    for j, t in zip(jout["segments"], tout["segments"]):
        for key in ("id", "seek", "start", "end", "text", "tokens", "temperature"):
            assert t[key] == j[key], key
        assert [(w["word"], w["start"], w["end"]) for w in t["words"]] == [
            (w["word"], w["start"], w["end"]) for w in j["words"]]
        for a, b in zip(t["words"], j["words"]):
            assert abs(a["probability"] - b["probability"]) <= PROB_TOL
        n_words += len(t["words"])
    return n_words


@pytest.mark.parametrize("extra", [dict(), dict(hallucination_silence_threshold=2.0)],
                         ids=["words", "hallucination-silence"])
def test_transcribe_words_match_jax(setup, extra, monkeypatch):
    """Identical text, segments, seeks and words, word times equal and
    probabilities within 1e-4 over the 45 s waveform. With the threshold,
    segments that look hallucinated are dropped and the seek moves."""
    jmodel, tmodel, audio = setup
    drops = []
    drop = PT._drop_hallucinated_tail

    def counting(*args, **kw):
        drops.append(drop(*args, **kw))
        return drops[-1]

    monkeypatch.setattr(PT, "_drop_hallucinated_tail", counting)
    jout = _jax(jmodel, audio, **WORDS, **extra)
    tout = PT.transcribe(tmodel, audio, **WORDS, **extra)
    assert _compare(jout, tout) >= 10
    assert len({s["seek"] for s in tout["segments"]}) >= 3
    if extra:
        assert any(d is not None for d in drops) and tout["segments"]


def test_cli_words_write_what_the_jax_writers_write(setup, tmp_path, capsys):
    """The CLI on the CPU with --word_timestamps True --highlight_words True
    --max_line_width 30: the same .srt/.vtt/.txt/.tsv bytes, and the same
    .json up to the probabilities' last bits, as the JAX writers on the JAX
    result."""
    jmodel, tmodel, audio = setup
    ckpt, clip = tmp_path / "m.pt", tmp_path / "clip.wav"
    torch.save(checkpoint_dict(tmodel), ckpt)
    _write_wav(clip, audio[: 20 * SR])
    out = tmp_path / "port"
    PC.cli([str(clip), "--model", str(ckpt), "--device", "cpu", "--output_dir", str(out), "--verbose", "False",
            "--language", "en", "--fp16", "False", "--temperature_increment_on_fallback", "None",
            "--beam_size", "2", "--best_of", "2", "--compression_ratio_threshold", "None",
            "--logprob_threshold", "None", "--word_timestamps", "True", "--highlight_words", "True",
            "--max_line_width", "30"])
    jout = _jax(jmodel, JA._read_wav(str(clip))[0], temperature=[0.0], beam_size=2, best_of=2,
                compression_ratio_threshold=None, logprob_threshold=None, fp16=False, language="en",
                word_timestamps=True, verbose=False)
    want = tmp_path / "jax"
    want.mkdir()
    JWR.get_writer("all", str(want))(jout, str(clip), highlight_words=True, max_line_width=30, max_line_count=None,
                                      max_words_per_line=None)
    for ext in ("srt", "vtt", "txt", "tsv"):
        assert (out / f"clip.{ext}").read_bytes() == (want / f"clip.{ext}").read_bytes(), ext
    got, ref = json.loads((out / "clip.json").read_text()), json.loads((want / "clip.json").read_text())
    assert sum(len(s["words"]) for s in got["segments"]) >= 5
    _compare(ref, got)
    assert "<u>" in (out / "clip.vtt").read_text() and "Skipping" not in capsys.readouterr().out


def test_cli_preset_name_sets_the_preset_alignment_heads(tmp_path, monkeypatch, capsys):
    """`--model tiny --model_dir D` loads D/tiny.pt and sets tiny's heads; the
    same file named by its path keeps the default heads. The model has
    tiny's width and decoder (4 layers x 6 heads) and a 2-layer encoder."""
    dims = TorchDims(**{**SMALL, **DIMS, "n_text_ctx": 32, "n_audio_state": 384, "n_audio_head": 6,
                        "n_text_state": 384, "n_text_head": 6, "n_text_layer": 4})
    ckpt, clip = tmp_path / "tiny.pt", tmp_path / "clip.wav"
    torch.save(checkpoint_dict(from_random(dims, seed=3, device="cpu")), ckpt)
    _write_wav(clip, _tones(3.0, seed=9))
    loaded, load = [], PMOD.load_model

    def recording(*args, **kw):
        loaded.append(load(*args, **kw))
        return loaded[-1]

    monkeypatch.setattr(PMOD, "load_model", recording)
    common = ["--device", "cpu", "--verbose", "False", "--language", "en", "--fp16", "False",
              "--temperature_increment_on_fallback", "None", "--beam_size", "2", "--logprob_threshold", "None",
              "--word_timestamps", "True"]
    PC.cli([str(clip), "--model", "tiny", "--model_dir", str(tmp_path), "--output_dir", str(tmp_path / "a"), *common])
    PC.cli([str(clip), "--model", str(ckpt), "--output_dir", str(tmp_path / "b"), *common])
    tiny = decode_alignment_heads_dump(dims, _ALIGNMENT_HEADS["tiny"])
    np.testing.assert_array_equal(loaded[0].alignment_heads, tiny)
    assert loaded[1].alignment_heads.sum() == 12 and loaded[1].alignment_heads[2:].all()
    for sub in ("a", "b"):
        result = json.loads((tmp_path / sub / "clip.json").read_text())
        assert all("words" in s for s in result["segments"])
    assert not np.array_equal(tiny, loaded[1].alignment_heads)
    assert os.path.exists(tmp_path / "a" / "clip.srt") and "Skipping" not in capsys.readouterr().out
