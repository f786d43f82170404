"""The slice end to end: waveform -> log-mel -> encoder -> greedy decode,
port against the JAX `DecodingTask.run` on the same weights and audio."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.decoding import DecodingOptions as JOptions
from asr_ttl_mtl_tpu.decoding import DecodingTask as JTask
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu_torch import audio as PA
from asr_ttl_mtl_tpu_torch import decoding as PD

from torch_port_helpers import model_pair, waveforms

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LP_TOL = 1e-4  # avg_logprob and no_speech_prob: fp32 both sides

BENCH = dict(language="en", without_timestamps=True, sample_len=12, suppress_tokens="-1,50257", fp16=False)


@pytest.fixture(scope="module")
def setup():
    jmodel, tmodel = model_pair(seed=1)
    audio = waveforms(3, 2 * 96, seed=7)
    return jmodel, tmodel, audio


def _compare(jres, tres, n_tokens=None, lp_tol=LP_TOL):
    assert len(jres) == len(tres)
    for j, t in zip(jres, tres):
        assert t.tokens == j.tokens
        if n_tokens is not None:
            assert len(t.tokens) == n_tokens
        assert t.text == j.text and t.language == j.language
        assert abs(t.avg_logprob - j.avg_logprob) <= lp_tol
        assert abs(t.no_speech_prob - j.no_speech_prob) <= lp_tol
        assert t.compression_ratio == pytest.approx(j.compression_ratio)


@pytest.mark.parametrize(
    "opts,lp_tol",
    [
        # int8 cross and self KV: the decode steps run K1
        (dict(BENCH, kv_quant=True), LP_TOL),
        # the default path: fp32 caches, the decode steps run K2
        (dict(BENCH, kv_quant=False), LP_TOL),
        # bench.py's chip options, adding the W8A8 encoder: an fp32-level
        # difference can round an activation to the other int8 neighbour,
        # moving features by up to ~2e-3 (test_torch_model) and the log-probs
        # by ~1e-4, so the log-prob bound is 1e-3 there
        (dict(BENCH, kv_quant=True, int8_encoder=True), 10 * LP_TOL),
    ],
    ids=["kv_quant", "float-kv", "bench-kv_quant-int8_encoder"],
)
def test_slice_matches_jax(setup, opts, lp_tol):
    """Identical tokens; avg_logprob and no_speech_prob within the bound.
    With kv_quant the JAX side runs its int8 kernel in interpret mode."""
    jmodel, tmodel, audio = setup
    jmel = JA.log_mel_spectrogram(audio, use_pallas=False)
    tmel = PA.log_mel_spectrogram(audio, device="cpu")
    # each side decodes its own log-mel; fp32 bins of these louder tones
    # differ by up to ~1e-5 after log10 (tests/test_torch_audio.py)
    np.testing.assert_allclose(tmel.numpy(), np.asarray(jmel), atol=2e-5, rtol=0)
    if opts.get("kv_quant"):
        JW.set_decode_kernel("interpret")
    try:
        jres = JTask(jmodel, JOptions(**opts)).run(jmel)
    finally:
        JW.set_decode_kernel("auto")
    tres = PD.DecodingTask(tmodel, PD.DecodingOptions(**opts)).run(tmel)
    _compare(jres, tres, n_tokens=opts["sample_len"], lp_tol=lp_tol)


def test_timestamp_rules_and_language_detection(setup):
    """Timestamp filters on, language detected (the split path whose prefill
    reads the dequantized cross store)."""
    jmodel, tmodel, audio = setup
    opts = dict(sample_len=10, fp16=False)
    mel = np.asarray(JA.log_mel_spectrogram(audio, use_pallas=False))
    jres = JTask(jmodel, JOptions(**opts)).run(jnp.asarray(mel))
    tres = PD.DecodingTask(tmodel, PD.DecodingOptions(**opts)).run(torch.from_numpy(mel.copy()))
    _compare(jres, tres)


def test_submit_collect_equals_run(setup):
    _, tmodel, audio = setup
    mel = PA.log_mel_spectrogram(audio, device="cpu")
    task = PD.DecodingTask(tmodel, PD.DecodingOptions(**BENCH))
    first, second = task.submit(mel), task.submit(mel, rng_seed=1)
    a, b = task.collect(first), task.collect(second)
    assert [r.tokens for r in a] == [r.tokens for r in b] == [r.tokens for r in task.run(mel)]


def test_sampling_is_seeded_and_best_of_ranks(setup):
    _, tmodel, audio = setup
    mel = PA.log_mel_spectrogram(audio, device="cpu")
    task = PD.DecodingTask(tmodel, PD.DecodingOptions(**dict(BENCH, temperature=1.0, best_of=2)))
    a, b = task.run(mel, rng_seed=5), task.run(mel, rng_seed=5)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert all(np.isfinite(r.avg_logprob) for r in a)


def test_decode_entry_point_single_window(setup):
    _, tmodel, audio = setup
    mel = PA.log_mel_spectrogram(audio[0], device="cpu")
    one = PD.decode(tmodel, mel, PD.DecodingOptions(**BENCH))
    assert isinstance(one, PD.DecodingResult) and len(one.tokens) == BENCH["sample_len"]


def test_beam_search_is_not_ported(setup):
    _, tmodel, audio = setup
    with pytest.raises(NotImplementedError):
        PD.DecodingTask(tmodel, PD.DecodingOptions(beam_size=2)).run(PA.log_mel_spectrogram(audio, device="cpu"))


def test_filter_config_and_buckets_match(setup):
    jmodel, tmodel, _ = setup
    for opts in (BENCH, dict(sample_len=5), dict(language="de", without_timestamps=False)):
        j, t = JTask(jmodel, JOptions(**opts)), PD.DecodingTask(tmodel, PD.DecodingOptions(**opts))
        assert t.filter_cfg.__dict__ == j.filter_cfg.__dict__
        assert t.initial_tokens == j.initial_tokens and t.sot_index == j.sot_index
    from asr_ttl_mtl_tpu import decoding as JD

    assert [PD._bucket(n) for n in range(1, 300)] == [JD._bucket(n) for n in range(1, 300)]


def test_ranker_and_utils_match():
    from asr_ttl_mtl_tpu import decoding as JD
    from asr_ttl_mtl_tpu import utils as JU
    from asr_ttl_mtl_tpu_torch import utils as PU

    tokens = [[[1, 2, 3], [4, 5]], [[6], [7, 8, 9, 10]]]
    lps = [[-3.0, -2.5], [-0.5, -3.9]]
    for penalty in (None, 0.0, 0.6, 1.0):
        assert PD.MaximumLikelihoodRanker(penalty).rank(tokens, lps) == JD.MaximumLikelihoodRanker(penalty).rank(
            tokens, lps
        )
    for text in ("abc abc abc abc", "The quick brown fox."):
        assert PU.compression_ratio(text) == JU.compression_ratio(text)
    for sec in (0.0, 1.2345, 59.9996, 3601.5):
        for hours in (False, True):
            assert PU.format_timestamp(sec, hours, ",") == JU.format_timestamp(sec, hours, ",")
    assert PU.exact_div(480000, 160) == JU.exact_div(480000, 160) == 3000
    with pytest.raises(AssertionError):
        PU.exact_div(7, 2)


def test_port_imports_without_jax():
    """The package never imports jax (nor the JAX package, which pulls it in)."""
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['asr_ttl_mtl_tpu'] = None\n"
        "import asr_ttl_mtl_tpu_torch, asr_ttl_mtl_tpu_torch.ops.decode_attention, "
        "asr_ttl_mtl_tpu_torch.ops.flash_attention, asr_ttl_mtl_tpu_torch.ops.mel, "
        "asr_ttl_mtl_tpu_torch.ops._cuda, asr_ttl_mtl_tpu_torch.utils, asr_ttl_mtl_tpu_torch.tokenizer\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax():
    pkg = os.path.join(ROOT, "asr_ttl_mtl_tpu_torch")
    for dirpath, dirs, files in os.walk(pkg):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not sources
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as f:
                    src = f.read()
                for bad in ("import jax", "from jax", "import asr_ttl_mtl_tpu\n", "from asr_ttl_mtl_tpu ",
                            "from asr_ttl_mtl_tpu."):
                    assert bad not in src, (name, bad)
