"""Batched transcription: K12's plain version, `find_alignment_batch`,
`transcribe_batch` and the CLI's `--batch_mode`, the port against the JAX
package on the same weights and inputs; and K12 on the card (marked
`cuda`, skipped without one)."""

import functools
import importlib
import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu.decoding import DecodingOptions as JaxDecodingOptions
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.models.registry import WhisperModel as JaxWhisperModel
from asr_ttl_mtl_tpu.ops.pallas_dtw import _dtw_paths_jit, dtw_paths_batch as jax_dtw_paths_batch
from asr_ttl_mtl_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from asr_ttl_mtl_tpu_torch import cli as PC
from asr_ttl_mtl_tpu_torch import timing as PTM
from asr_ttl_mtl_tpu_torch import transcribe as PT
from asr_ttl_mtl_tpu_torch.decoding import DecodingOptions, DecodingTask
from asr_ttl_mtl_tpu_torch.models import ModelDimensions as TorchDims
from asr_ttl_mtl_tpu_torch.models import WhisperModel, checkpoint_dict, from_random, state_dict_from_jax_params
from asr_ttl_mtl_tpu_torch.models.whisper import encoder_apply
from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
from asr_ttl_mtl_tpu_torch.ops import dtw as PD
from asr_ttl_mtl_tpu_torch.tokenizer import get_tokenizer

from test_torch_transcribe import DIMS, SR, _tones, _write_wav
from torch_port_helpers import SMALL, cuda_device, jax_dims, model_pair, np_tree, waveforms  # noqa: F401

JT = importlib.import_module("asr_ttl_mtl_tpu.transcribe")  # the package exports a function of that name
JTM = importlib.import_module("asr_ttl_mtl_tpu.timing")
PROB_TOL = 1e-4
LP_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ K12 ---------

# ragged rows, one of one token, one of one frame, one without frames (a
# window of one mel frame), and a row that fills the whole matrix
NS, MS = [37, 12, 1, 30, 7, 5, 37], [143, 77, 50, 1, 143, 0, 143]


def _k12_costs(kind: str) -> np.ndarray:
    x = np.random.RandomState(len(kind)).randn(len(NS), max(NS), max(MS)).astype(np.float32)
    if kind == "ties":  # integer costs: equal neighbours everywhere
        x = np.round(x * 2)
    if kind == "nan":  # a standardized zero-variance column divides to NaN
        x[0, :, 20:23] = np.nan
        x[3, 5:9, 0] = np.nan
        x[6, 10:, 60] = np.nan
    return x


@pytest.mark.parametrize("kind", ["ragged", "ties", "nan"])
def test_k12_plain_matches_pallas(kind):
    """ti, tj and lens bit for bit (the zeros past each path included), and
    the collected paths equal JAX's and the host walk of each row."""
    x = _k12_costs(kind)
    nm = jnp.asarray(np.stack([NS, MS], 1).astype(np.int32))
    want = [np.asarray(a) for a in _dtw_paths_jit(jnp.asarray(x), nm, interpret=True)]
    got = PD.dtw_paths_dispatch(_t(x), NS, MS)
    assert [g.dtype for g in got] == [torch.int32] * 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    paths = PD.dtw_paths_batch(_t(x), NS, MS)
    for b, ((ti, tj), (jti, jtj)) in enumerate(zip(paths, jax_dtw_paths_batch(x, NS, MS, interpret=True))):
        np.testing.assert_array_equal(ti, jti)
        np.testing.assert_array_equal(tj, jtj)
        host = PD.backtrace(PD.dtw_trace_plain(_t(x[b, : NS[b], : MS[b]])).numpy())
        np.testing.assert_array_equal(np.stack([ti, tj]), host)


def test_k12_refusals_and_empty_rows():
    x = _t(_k12_costs("ragged"))
    with pytest.raises(ValueError):
        PD.dtw_paths_dispatch(x, NS[:-1], MS[:-1])  # one length per row
    with pytest.raises(ValueError):
        PD.dtw_paths_dispatch(x, [38] + NS[1:], MS)  # more tokens than the matrix holds
    ti, tj, lens = PD.dtw_paths_dispatch(x[:, :0, :0], [0] * len(NS), [0] * len(NS))
    assert ti.shape == (len(NS), 0) and lens.tolist() == [0] * len(NS)


# ------------------------------------------------ find_alignment_batch ----

TEXTS = [" hello there how are you", " the quick brown fox", " hi", "", " one two three four five six"]
FRAMES = [160, 192, 100, 120, 150]


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=1)


def _alignment_inputs():
    jtok = jax_get_tokenizer(True, language="en", task="transcribe")
    ptok = get_tokenizer(True, language="en", task="transcribe")
    token_lists = [ptok.encode(t) if t else [] for t in TEXTS]
    assert token_lists == [jtok.encode(t) if t else [] for t in TEXTS]
    mels = np.stack([np.asarray(JA.log_mel_spectrogram(w, use_pallas=False))
                     for w in waveforms(len(TEXTS), 192, seed=13)]).astype(np.float32)
    return jtok, ptok, token_lists, mels


def _same_timings(got, want):
    assert [w.word for w in got] == [w.word for w in want]
    assert [w.tokens for w in got] == [w.tokens for w in want]
    for g, w in zip(got, want):
        assert float(g.start) == float(w.start) and float(g.end) == float(w.end)
        assert abs(g.probability - w.probability) <= PROB_TOL


@pytest.mark.parametrize("device_dtw", [False, True], ids=["host-walk", "k12-plain"])
def test_find_alignment_batch_matches_jax(pair, device_dtw):
    """Chunks of 2 (the last padded by repeating a row) and an empty row:
    words and tokens identical, start and end equal, probabilities within
    1e-4 of JAX's host walk and its interpreted kernel."""
    jmodel, tmodel = pair
    jtok, ptok, token_lists, mels = _alignment_inputs()
    want = JTM.find_alignment_batch(jmodel, jtok, token_lists, mels, FRAMES, batch_size=2,
                                    use_device_dtw="interpret" if device_dtw else False)
    got = PTM.find_alignment_batch(tmodel, ptok, token_lists, _t(mels), FRAMES, batch_size=2,
                                   use_device_dtw=device_dtw)
    assert got[3] == [] and sum(len(g) for g in got) >= 12
    for g, w in zip(got, want):
        _same_timings(g, w)


def test_find_alignment_batch_matches_sequential(pair):
    """The batched alignment against the port's own per-window one: the same
    words, times within one DTW frame (0.02 s)."""
    _, tmodel = pair
    _, ptok, token_lists, mels = _alignment_inputs()
    batched = PTM.find_alignment_batch(tmodel, ptok, token_lists, _t(mels), FRAMES, batch_size=3)
    for tokens, mel, frames, got in zip(token_lists, mels, FRAMES, batched):
        want = PTM.find_alignment(tmodel, ptok, tokens, _t(mel), frames)
        assert [w.word for w in got] == [w.word for w in want]
        for g, w in zip(got, want):
            assert abs(g.start - w.start) <= 0.021 and abs(g.end - w.end) <= 0.021
            assert abs(g.probability - w.probability) <= PROB_TOL


def test_feature_sink_and_the_forward_without_encoder(pair, monkeypatch):
    """`submit(feature_sink=...)` hands over encoder_apply's features when the
    encoder is unfused, and the alignment forward given features runs no
    encoder and gives the same words as from the mels."""
    _, tmodel = model_pair(seed=1, n_audio_ctx=1500)
    mel = _t(np.asarray(JA.log_mel_spectrogram(_tones(30.0, seed=3), use_pallas=False))[None, :, :3000])
    kept = []
    task = DecodingTask(tmodel, DecodingOptions(language="en", fp16=False, sample_len=4, fuse_encoder=False))
    task.collect(task.submit(mel, feature_sink=kept.append))
    assert len(kept) == 1
    torch.testing.assert_close(kept[0], encoder_apply(tmodel.encoder, mel, torch.float32), rtol=0, atol=0)
    fused = DecodingTask(tmodel, DecodingOptions(language="en", fp16=False, sample_len=4))
    fused.collect(fused.submit(mel, feature_sink=kept.append))
    assert len(kept) == 1  # a fused window keeps nothing, as in JAX

    ptok = get_tokenizer(True, language="en", task="transcribe")
    tokens = [ptok.encode(" hello there how are you")]
    from_mels = PTM.find_alignment_batch(tmodel, ptok, tokens, mel, [3000])

    class Features:
        def gather(self, idx, pad_to=None):
            return kept[0][idx]

    def no_encoder(*args, **kw):
        raise AssertionError("the alignment forward ran the encoder")

    monkeypatch.setattr(PTM, "encoder_apply", no_encoder)
    from_features = PTM.find_alignment_batch(tmodel, ptok, tokens, None, [3000], features=Features())
    assert [(w.word, w.start, w.end) for w in from_features[0]] == [(w.word, w.start, w.end) for w in from_mels[0]]


# ---------------------------------------------------- transcribe_batch ----

# tones of 45 s (two windows), 8 s and 3 s; one rung of greedy or beam 2;
# 16 tokens a window
BATCH_COMMON = dict(sample_len=16, fp16=False, batch_size=2, compression_ratio_threshold=None,
                    logprob_threshold=None)
EMBED_SCALE = 8.0  # as tests/test_torch_words.py: peaked logits, so that words pass


@pytest.fixture(scope="module")
def batch_setup():
    dims = jax_dims(**DIMS)
    params = JW.init_params(jax.random.PRNGKey(2), dims)
    params["decoder"]["token_embedding"] = params["decoder"]["token_embedding"] * EMBED_SCALE
    jmodel = JaxWhisperModel(dims=dims, params=params, compute_dtype=jnp.float32)
    tmodel = WhisperModel(TorchDims(**{**SMALL, **DIMS}), compute_dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax_params(np_tree(params), dims))
    audios = [_tones(45.0, seed=5), _tones(8.0, seed=6), _tones(3.0, seed=7)]
    return jmodel, tmodel.eval().requires_grad_(False), audios


def _jax_batch(jmodel, audios, **kw):
    JW.set_decode_kernel("off")  # the JAX side takes its plain path
    try:
        return JT.transcribe_batch(jmodel, audios, **kw)
    finally:
        JW.set_decode_kernel("auto")


def _compare_outputs(jouts, touts, words=False):
    n_words = 0
    for j, t in zip(jouts, touts):
        assert t["text"] == j["text"] and t["language"] == j["language"]
        assert len(t["segments"]) == len(j["segments"])
        for a, b in zip(t["segments"], j["segments"]):
            assert set(a) == set(b)
            for key in ("id", "seek", "start", "end", "text", "tokens", "temperature"):
                assert a[key] == b[key], key
            assert abs(a["avg_logprob"] - b["avg_logprob"]) <= LP_TOL
            assert abs(a["no_speech_prob"] - b["no_speech_prob"]) <= LP_TOL
            assert a["compression_ratio"] == pytest.approx(b["compression_ratio"])
            if words:
                assert [(w["word"], w["start"], w["end"]) for w in a["words"]] == [
                    (w["word"], w["start"], w["end"]) for w in b["words"]]
                for x, y in zip(a["words"], b["words"]):
                    assert abs(x["probability"] - y["probability"]) <= PROB_TOL
                n_words += len(a["words"])
    return n_words


BATCH_CASES = {
    "greedy-host-windows": dict(temperature=0.0, language="en", device_windows=False),
    "beam-device-windows": dict(temperature=0.0, beam_size=2, language="en", device_windows=True),
    "detect-language": dict(temperature=0.0, device_windows=True),
    "initial-prompt": dict(temperature=0.0, language="en", initial_prompt="hello there"),
    "clip-timestamps": dict(temperature=0.0, beam_size=2, language="en", clip_timestamps="1,2.5,2.8"),  # clips inside every input
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_transcribe_batch_matches_jax(batch_setup, case):
    jmodel, tmodel, audios = batch_setup
    kw = dict(BATCH_COMMON, **BATCH_CASES[case])
    jouts = _jax_batch(jmodel, audios, **kw)
    touts = PT.transcribe_batch(tmodel, audios, **kw)
    _compare_outputs(jouts, touts)
    assert sum(len(o["segments"]) for o in touts) >= 3


def test_transcribe_batch_words_from_the_feature_store(batch_setup, monkeypatch):
    """Word timestamps on device windows with a known language: the decode
    keeps its encoder features and the alignment reads them; words equal
    JAX's, and equal the port's own host-window run."""
    jmodel, tmodel, audios = batch_setup
    gathers = []
    gather = PT._FeatureStore.gather

    def spy(self, idx, pad_to=None):
        gathers.append(list(idx))
        return gather(self, idx, pad_to)

    monkeypatch.setattr(PT._FeatureStore, "gather", spy)
    kw = dict(BATCH_COMMON, temperature=0.0, beam_size=2, language="en", word_timestamps=True)
    jouts = _jax_batch(jmodel, audios, device_windows=True, **kw)
    touts = PT.transcribe_batch(tmodel, audios, device_windows=True, **kw)
    assert gathers, "the alignment did not read the decode's features"
    assert _compare_outputs(jouts, touts, words=True) >= 5
    host = PT.transcribe_batch(tmodel, audios, device_windows=False, **kw)
    assert _compare_outputs(host, touts, words=True) >= 5


def test_transcribe_batch_ladder_matches_jax(batch_setup, monkeypatch):
    """The ladder (0.0, 0.2) with a logprob gate between the windows' rung-0
    scores: rung 0 is identical, the same windows are retried (only they are
    decoded again), and the windows that rung 0 accepts are identical. The
    retried windows' tokens differ: the frameworks draw other numbers."""
    jmodel, tmodel, audios = batch_setup
    kw = dict(BATCH_COMMON, language="en", no_speech_threshold=None)
    probe = PT.transcribe_batch(tmodel, audios, temperature=0.0, **kw)
    lps = sorted({s["avg_logprob"] for o in probe for s in o["segments"]})
    gap = int(np.argmax(np.diff(lps)))
    threshold = (lps[gap] + lps[gap + 1]) / 2
    calls = []
    submit = DecodingTask.submit

    def spy(self, mel, rng_seed=0, **k):
        calls.append((self.options.temperature, int(mel.shape[0])))
        return submit(self, mel, rng_seed, **k)

    monkeypatch.setattr(DecodingTask, "submit", spy)
    kw.update(temperature=(0.0, 0.2), logprob_threshold=threshold)
    jouts = _jax_batch(jmodel, audios, **kw)
    touts = PT.transcribe_batch(tmodel, audios, **kw)

    def by_rung(outs):
        return {(i, s["seek"]): s["temperature"] for i, o in enumerate(outs) for s in o["segments"]}

    assert by_rung(touts) == by_rung(jouts)
    assert set(by_rung(touts).values()) == {0.0, 0.2}
    retried = {w for w, t in by_rung(touts).items() if t > 0}
    assert calls[:2] == [(0.0, 2), (0.0, 2)] and [t for t, _ in calls[2:]] == [0.2] * (len(calls) - 2)
    assert len(calls) - 2 == -(-len(retried) // 2)  # only the retried windows, in padded batches of 2
    for i, (j, t) in enumerate(zip(jouts, touts)):
        keep = lambda o: [s for s in o["segments"] if (i, s["seek"]) not in retried]  # noqa: E731
        _compare_outputs([{**j, "text": "", "segments": keep(j)}], [{**t, "text": "", "segments": keep(t)}])


def test_transcribe_batch_refuses_a_mesh(batch_setup):
    """What the mesh path refuses, in a world of one rank: a mesh larger
    than the world, and a mesh decode without a known language (as JAX
    `dispatch_batched_dp`). tests/test_torch_parallel.py drives the mesh
    path itself on 2 ranks."""
    import torch.distributed as dist

    from asr_ttl_mtl_tpu_torch.parallel import create_mesh
    from asr_ttl_mtl_tpu_torch.parallel.serving import decode_batched_dp

    _, tmodel, audios = batch_setup
    try:
        with pytest.raises(ValueError, match="needs 2 ranks, but the world has 1"):
            PT.transcribe_batch(tmodel, audios, mesh=create_mesh((2, 1), device="cpu"))
        mel = torch.zeros(1, 80, 3000)
        with pytest.raises(ValueError, match="needs a known language"):
            decode_batched_dp(tmodel, mel, DecodingOptions(language=None), mesh=create_mesh((1, 1), device="cpu"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# ------------------------------------------------------- --batch_mode -----


@pytest.fixture(scope="module")
def doll(tmp_path_factory):
    """tests/test_cli_batch.py's set-up: a 1-layer doll checkpoint of width 64
    and two 1 s WAVs of noise."""
    tmp = tmp_path_factory.mktemp("port_cli_batch")
    dims = TorchDims(n_mels=80, n_audio_ctx=1500, n_audio_state=64, n_audio_head=1, n_audio_layer=1,
                     n_vocab=51865, n_text_ctx=448, n_text_state=64, n_text_head=1, n_text_layer=1)
    ckpt = tmp / "doll.pt"
    torch.save(checkpoint_dict(from_random(dims, seed=0, device="cpu")), ckpt)
    paths = []
    for seed in (1, 2):
        p = tmp / f"clip{seed}.wav"
        _write_wav(p, np.random.RandomState(seed).randn(SR).astype(np.float32) * 0.1)
        paths.append(str(p))
    return tmp, str(ckpt), paths


def test_batch_mode_routing_matches_jax():
    """The options `--batch_mode` routes and drops are JAX's: routed from the
    signature of transcribe_batch and the DecodingOptions fields (JAX
    cli.py:154-172)."""
    jsupported = (set(inspect.signature(JT.transcribe_batch).parameters)
                  | set(JaxDecodingOptions.__dataclass_fields__)) - {
        "model", "audios", "batch_size", "mesh", "decode_options", "temperature"}
    assert PC.batch_supported() == jsupported - {"mesh"}
    assert PC.BATCH_DROPPED == {"verbose", "condition_on_previous_text", "carry_initial_prompt"}


def test_cli_batch_mode_writes_what_jax_writes(doll, monkeypatch, capsys):
    """`--batch_mode True --word_timestamps True --initial_prompt hi
    --clip_timestamps 0,0.9` on the doll, one rung (beam 5): the same .txt,
    .vtt, .srt and .tsv bytes as JAX's CLI, and the same .json up to the
    word probabilities' last bits."""
    tmp, ckpt, paths = doll
    argv = paths + ["--model", ckpt, "--language", "en", "--batch_mode", "True", "--word_timestamps", "True",
                    "--initial_prompt", "hi", "--clip_timestamps", "0,0.9", "--fp16", "False", "--verbose", "False",
                    "--temperature_increment_on_fallback", "None"]
    PC.cli(argv + ["--output_dir", str(tmp / "port"), "--device", "cpu"])
    assert "failed" not in capsys.readouterr().out
    from asr_ttl_mtl_tpu.cli import cli as jax_cli

    monkeypatch.setattr(sys, "argv", ["asr_ttl_mtl_tpu"] + argv + ["--output_dir", str(tmp / "jax")])
    JW.set_decode_kernel("off")
    try:
        jax_cli()
    finally:
        JW.set_decode_kernel("auto")
    for path in paths:
        stem = os.path.splitext(os.path.basename(path))[0]
        for ext in ("txt", "vtt", "srt", "tsv"):
            assert (tmp / "port" / f"{stem}.{ext}").read_bytes() == (tmp / "jax" / f"{stem}.{ext}").read_bytes()
        got = json.loads((tmp / "port" / f"{stem}.json").read_text())
        want = json.loads((tmp / "jax" / f"{stem}.json").read_text())
        assert got["segments"] and all("words" in s for s in got["segments"])
        _compare_outputs([want], [got], words=True)


def test_cli_batch_mode_refusals(doll, monkeypatch, capsys):
    tmp, ckpt, paths = doll
    base = paths[:1] + ["--model", ckpt, "--batch_mode", "True", "--device", "cpu", "--output_dir", str(tmp / "r")]
    with pytest.raises(SystemExit):  # needs the sequential seek loop, as in JAX
        PC.cli(base + ["--word_timestamps", "True", "--hallucination_silence_threshold", "2"])
    import torch.distributed as dist

    try:
        with pytest.raises(SystemExit):  # a mesh of 2 ranks in a world of 1
            PC.cli(base + ["--dp", "2"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    def narrow(model, audios, batch_size=16, mesh=None, **kw):
        raise AssertionError("not reached")

    # a transcribe_batch without word_timestamps: the option is unroutable
    monkeypatch.setattr(PT, "transcribe_batch", narrow)
    with pytest.raises(SystemExit):
        PC.cli(base + ["--word_timestamps", "True", "--fp16", "False"])
    monkeypatch.undo()

    @functools.wraps(PT.transcribe_batch)  # the same signature: every option routes
    def failing(*args, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(PT, "transcribe_batch", failing)
    PC.cli(base + ["--fp16", "False"])
    assert "Batch transcription failed: RuntimeError: boom" in capsys.readouterr().out


# ------------------------------------------------------- on the card ------


# K12 on the card: (n_max, m_max, ns, ms, kind), x seeded at (len(ns), n_max,
# m_max); n_max picks the plan, so that every (rows a lane, chunk, helpers)
# instance runs, 4095 tokens included; odd m_max with rows short of it;
# rows without tokens or frames; rows short of n_max by more than a compute
# warp's rows (the warps below them idle); ties and NaN
K12_CARD_CASES = [
    (max(NS), max(MS), NS, MS, "ragged"),
    (max(NS), max(MS), NS, MS, "ties"),
    (max(NS), max(MS), NS, MS, "nan"),
    (37, 143, [0, 5, 37, 0, 37, 12, 0], [9, 0, 143, 0, 143, 1, 0], "ragged"),
    (61, 1499, [52, 5, 61, 17, 33], [1499, 250, 1101, 1499, 780], "ragged"),
    (444, 1500, [444, 5, 60, 130, 200, 443], [1500, 1200, 1499, 700, 333, 1], "ties"),
    (444, 1501, [444, 2, 64, 65, 300], [1501, 1501, 900, 1500, 1], "nan"),
    (600, 201, [600, 100, 599], [201, 200, 77], "ragged"),
    (900, 150, [900, 129, 640], [150, 149, 3], "ties"),
    (1100, 99, [1100, 255, 1000], [99, 60, 98], "ragged"),
    (1700, 61, [1700, 256, 1699], [61, 61, 7], "ragged"),
    (2300, 41, [2300, 1000, 2047], [41, 40, 13], "nan"),
    (PD.MAX_TOKENS, 29, [PD.MAX_TOKENS, 2048, 300], [29, 28, 29], "ragged"),
]
K12_CARD_IDS = ["ragged", "ties", "nan", "empty-rows", "run-b-chunk-odd-m", "base-largest-idle-warps",
                "base-largest-nan-odd-m", "4-rows-4-helpers", "4-rows-2-helpers", "8-rows-4-helpers",
                "8-rows-2-helpers", "8-rows-9-warps", "4095-tokens"]


def _k12_card_costs(n_max, m_max, ns, kind):
    rng = np.random.RandomState(n_max + m_max)
    x = rng.randn(len(ns), n_max, m_max).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2)
    if kind == "nan":  # NaN columns and a NaN row inside the rows' bounds
        x[0, :, m_max // 3 : m_max // 3 + 3] = np.nan
        x[-1, ns[-1] // 2] = np.nan
    return x


def test_k12_card_cases_cover_every_instance():
    """K12's plan is K13's at n_max, and each (rows a lane, chunk, helpers)
    it can pick is a template instance of its own: the card test runs every
    one, with rows whose tokens end more than a compute warp's rows short of
    n_max, rows without tokens and rows without frames."""
    def instance(n):
        rows_per_lane, chunk, _, helpers, _, _ = PD.k12_plan(n)
        return rows_per_lane, chunk, helpers

    picked = {instance(n) for n in range(0, PD.MAX_TOKENS + 1)}
    assert {instance(case[0]) for case in K12_CARD_CASES} == picked
    assert len(K12_CARD_CASES) == len(K12_CARD_IDS) == len(set(K12_CARD_IDS))
    for n_max, m_max, ns, ms, _ in K12_CARD_CASES:
        assert len(ns) == len(ms) and max(ns) == n_max and max(ms) <= m_max
        assert all(0 <= n <= n_max for n in ns) and all(0 <= m <= m_max for m in ms)
    short = [(case[0], n) for case in K12_CARD_CASES for n in case[2]
             if n + 1 <= case[0] + 1 - 32 * PD.k12_plan(case[0])[0]]
    assert short and any(0 in case[2] for case in K12_CARD_CASES) and any(0 in case[3] for case in K12_CARD_CASES)
    assert any(case[1] % 2 and min(case[3]) < case[1] for case in K12_CARD_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("n_max,m_max,ns,ms,kind", K12_CARD_CASES, ids=K12_CARD_IDS)
def test_k12_kernel_on_card(cuda_device, n_max, m_max, ns, ms, kind):  # noqa: F811
    """ti, tj and lens identical to the plain version's (the zeros past each
    path included) and the same bits on a second launch; then the batch
    padded by repeating a row, as `find_alignment_batch` pads its last
    chunk."""
    x = _t(_k12_card_costs(n_max, m_max, ns, kind)).to(cuda_device)
    got, want = PD.dtw_paths_dispatch(x, ns, ms), PD.dtw_paths_batch_plain(x, ns, ms)
    for g, w, again in zip(got, want, PD.dtw_paths_dispatch(x, ns, ms)):
        assert torch.equal(g, w) and torch.equal(again, g)
    if kind == "ragged" and n_max <= 444:
        rows = list(range(len(ns) - 1)) + [len(ns) - 2] * 2
        padded, pns, pms = x[rows].contiguous(), [ns[r] for r in rows], [ms[r] for r in rows]
        for g, w in zip(PD.dtw_paths_dispatch(padded, pns, pms), PD.dtw_paths_batch_plain(padded, pns, pms)):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_transcribe_batch_words_on_card_launch_k12(cuda_device):  # noqa: F811
    """Word timestamps through transcribe_batch on the card: one K12 launch
    per alignment chunk, no K13 and no K11, and words in the segments."""
    model = from_random("tiny", seed=0, device=cuda_device, dtype=torch.bfloat16)
    audios = [_tones(45.0, seed=5), _tones(8.0, seed=6), _tones(3.0, seed=7)]
    reset_launch_counts()
    outs = PT.transcribe_batch(model, audios, batch_size=2, temperature=0.0, language="en", sample_len=32,
                               word_timestamps=True, no_speech_threshold=None, logprob_threshold=None)
    counts = dict(LAUNCHES)
    assert 1 <= counts["dtw_paths_batch"] <= 2  # 4 windows: at most 2 chunks of 2 with text
    assert counts["dtw_trace"] == 0 and counts["median_filter"] == 0
    assert all("words" in s for o in outs for s in o["segments"])
