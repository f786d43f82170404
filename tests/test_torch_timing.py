"""The words slice: the median filters (K11's plain version), the DTW fills
(K13's plain version), the cross-attention capture, the alignment heads,
`find_alignment` and `add_word_timestamps`, against the JAX package on the
same inputs and weights; plus K11 and K13 against their plain versions on
the card (marked `cuda`, skipped without one)."""

import copy
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_ttl_mtl_tpu import audio as JA
from asr_ttl_mtl_tpu import timing as JT
from asr_ttl_mtl_tpu.models import whisper as JW
from asr_ttl_mtl_tpu.models.dims import PRESET_DIMS as JAX_PRESETS
from asr_ttl_mtl_tpu.models.registry import _ALIGNMENT_HEADS as JAX_HEADS
from asr_ttl_mtl_tpu.ops.median import median_filter as jax_median_filter
from asr_ttl_mtl_tpu.ops.pallas_dtw import dtw_trace_pallas
from asr_ttl_mtl_tpu.ops.pallas_median import median_filter_pallas
from asr_ttl_mtl_tpu.tokenizer import get_tokenizer as jax_get_tokenizer
from asr_ttl_mtl_tpu_torch import timing as PT
from asr_ttl_mtl_tpu_torch import transcribe as PTR
from asr_ttl_mtl_tpu_torch.models import WhisperModel
from asr_ttl_mtl_tpu_torch.models import whisper as PW
from asr_ttl_mtl_tpu_torch.models.dims import PRESET_DIMS
from asr_ttl_mtl_tpu_torch.models.registry import _ALIGNMENT_HEADS
from asr_ttl_mtl_tpu_torch.ops import dtw as PD
from asr_ttl_mtl_tpu_torch.ops import median as PM
from asr_ttl_mtl_tpu_torch.tokenizer import get_tokenizer

from torch_port_helpers import SMALL, cuda_device, model_pair, waveforms  # noqa: F401

JD = importlib.import_module("asr_ttl_mtl_tpu.ops.dtw")  # the package exports a function of that name
JTR = importlib.import_module("asr_ttl_mtl_tpu.transcribe")
PROB_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ K11 ---------


def _median_inputs(shape, seed, nan_column=True):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x[..., 3 % shape[-1]] = np.round(x[..., 3 % shape[-1]])  # repeated values
    if nan_column:
        x[..., shape[-1] // 2] = np.nan  # a zero-variance column after the standardization
    return x


@pytest.mark.parametrize("width", [3, 5, 7, 9, 11, 13])
@pytest.mark.parametrize("shape", [(13, 40), (3, 5, 37)], ids=["2d-13-rows", "3d-15-rows"])
def test_k11_plain_matches_pallas(width, shape):
    """Bit for bit, NaN columns included: both propagate NaN through min/max."""
    x = _median_inputs(shape, seed=width)
    want = np.asarray(median_filter_pallas(x, width, interpret=True))
    got = PM.median_filter_network(_t(x), width).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # NaN at the same places
    assert np.isnan(got).any()


def test_k11_short_input_and_refusals():
    x = _median_inputs((4, 3), seed=0, nan_column=False)
    for width in (7, 9):  # last axis <= width // 2: unchanged
        np.testing.assert_array_equal(PM.median_filter_network(_t(x), width).numpy(),
                                      np.asarray(median_filter_pallas(x, width, interpret=True)))
        np.testing.assert_array_equal(PM.median_filter(x, width), x)
    np.testing.assert_array_equal(PM.median_filter_network(_t(x), 5).numpy(),
                                  np.asarray(median_filter_pallas(x, 5, interpret=True)))
    for width in (4, 15):
        with pytest.raises(ValueError):
            PM.median_filter_network(_t(x), width)


@pytest.mark.parametrize("width", [3, 7, 13])
def test_host_median_matches_jax(width):
    """The sort median against the JAX host function; with a NaN column too
    (the sort puts NaN last on both sides)."""
    for nan in (False, True):
        x = _median_inputs((2, 9, 41), seed=width, nan_column=nan).astype(np.float64)
        np.testing.assert_array_equal(PM.median_filter(x, width), jax_median_filter(x, width))
    clean = _median_inputs((2, 9, 41), seed=width, nan_column=False)
    np.testing.assert_array_equal(PM.median_filter(clean, width),
                                  PM.median_filter_network(_t(clean), width).numpy())


# ------------------------------------------------------------ K13 ---------


def _cost(shape, seed, ties=False):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.round(x * 2) / 2 if ties else x


DTW_CASES = [((12, 12), False), ((30, 7), False), ((6, 45), False), ((1, 20), False), ((9, 1), False),
             ((10, 30), True), ((16, 16), True)]
DTW_IDS = ["square", "tall", "wide", "one-token", "one-frame", "ties-wide", "ties-square"]


@pytest.mark.parametrize("shape,ties", DTW_CASES, ids=DTW_IDS)
def test_k13_plain_matches_pallas(shape, ties):
    x = _cost(shape, seed=sum(shape), ties=ties)
    want = dtw_trace_pallas(x, interpret=True)
    got = PD.dtw_trace(_t(x))
    assert got.dtype == torch.int8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.float32), want)
    np.testing.assert_array_equal(PD.backtrace(got.numpy()), JD.backtrace(want.copy()))


@pytest.mark.parametrize("shape,ties", DTW_CASES, ids=DTW_IDS)
def test_host_dtw_matches_jax(shape, ties):
    x = _cost(shape, seed=sum(shape) + 1, ties=ties)
    want = JD.dtw_wavefront_numpy(x)
    np.testing.assert_array_equal(PD.dtw_wavefront_numpy(x), want)
    np.testing.assert_array_equal(PD.backtrace(want.copy()), JD.backtrace(want.copy()))
    np.testing.assert_array_equal(PD.dtw(x), JD.dtw(x))
    np.testing.assert_array_equal(PD.dtw(_t(x)), JD.dtw(x))


def test_dtw_of_a_window_without_frames():
    """A window of under two frames leaves an (N, 0) matrix: no cell to
    fill, and the path walks up the first column."""
    x = np.zeros((3, 0), np.float32)
    np.testing.assert_array_equal(PD.dtw_trace(_t(x)).numpy().astype(np.float32), JD.dtw_wavefront_numpy(x))
    np.testing.assert_array_equal(PD.dtw(x), JD.dtw(x))


def test_backtrace_rejects_a_bad_trace():
    trace = np.full((3, 3), 5, dtype=np.int8)
    for fn in (PD.backtrace, JD.backtrace):
        with pytest.raises(ValueError):
            fn(trace.copy())


# ----------------------------------------------------- cross-QK capture ---


@pytest.fixture(scope="module")
def pair():
    return model_pair(seed=4)


def _decoder_inputs(pair, n_tokens=20, seed=0):
    jmodel, _ = pair
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, 50257, size=(1, n_tokens)).astype(np.int32)
    feats = (rng.randn(1, SMALL["n_audio_ctx"], SMALL["n_audio_state"]) * 0.5).astype(np.float32)
    return tokens, feats


@pytest.mark.parametrize(
    "pairs", [None, ((1, 1), (0, 1), (1, 0)), ((0, 0),), ((1, 1),)],
    ids=["all-heads", "out-of-order", "layer-0", "layer-1"],
)
def test_cross_qk_capture_matches_jax(pair, pairs):
    """Same logits and captured pre-softmax logits; pairs come back
    layer-major whatever the order given."""
    jmodel, tmodel = pair
    tokens, feats = _decoder_inputs(pair)
    jlogits, _, jqk = JW.decoder_apply(jmodel.params, jmodel.dims, jnp.asarray(tokens), jnp.asarray(feats),
                                       return_cross_qk=True, cross_qk_pairs=pairs)
    logits, cache, qk = PW.decoder_apply(tmodel.decoder, _t(tokens).long(), _t(feats), return_cross_qk=True,
                                         cross_qk_pairs=pairs)
    assert cache is None and qk.dtype == torch.float32 and qk.shape == jqk.shape
    jqk = np.asarray(jqk)
    np.testing.assert_allclose(qk.numpy(), jqk, rtol=1e-5, atol=1e-5 * np.abs(jqk).max())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=1e-5, atol=1e-4)
    if pairs is not None:
        full = PW.decoder_apply(tmodel.decoder, _t(tokens).long(), _t(feats), return_cross_qk=True)[2]
        for n, (layer, head) in enumerate(sorted(pairs, key=lambda p: p[0])):
            assert torch.equal(qk[n, 0], full[layer, 0, head])


def test_cross_qk_refusals(pair):
    jmodel, tmodel = pair
    tokens, feats = _decoder_inputs(pair)
    with pytest.raises(ValueError):  # an empty selection raises on both sides
        JW.decoder_apply(jmodel.params, jmodel.dims, jnp.asarray(tokens), jnp.asarray(feats),
                         return_cross_qk=True, cross_qk_pairs=())
    with pytest.raises(ValueError, match="selects no head"):
        PW.decoder_apply(tmodel.decoder, _t(tokens).long(), _t(feats), return_cross_qk=True, cross_qk_pairs=())
    two = _t(np.concatenate([tokens, tokens])).long()
    with pytest.raises(ValueError, match="kv_group 1"):  # two token rows over one cross row
        PW.decoder_apply(tmodel.decoder, two, _t(feats), return_cross_qk=True)


def test_qkv_attention_return_qk_takes_the_plain_path():
    """tq >= 16 non-causal would go to K3; with return_qk it stays plain and
    returns JAX's fp32 pre-softmax logits."""
    rng = np.random.RandomState(1)
    q, k, v = (rng.randn(1, t, 128).astype(np.float32) for t in (32, 96, 96))
    out, qk = PW.qkv_attention(_t(q), _t(k), _t(v), 2, return_qk=True)
    jout, jqk = JW.qkv_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2, return_qk=True)
    np.testing.assert_allclose(qk.numpy(), np.asarray(jqk), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(PW.qkv_attention(_t(q), _t(k), _t(v), 2).numpy(), out.numpy(), atol=1e-5)


# ------------------------------------------------------- alignment heads --


def test_alignment_heads_of_every_preset_match_jax():
    assert _ALIGNMENT_HEADS == JAX_HEADS
    for name, dump in _ALIGNMENT_HEADS.items():
        mask = PW.decode_alignment_heads_dump(PRESET_DIMS[name], dump)
        want = JW.decode_alignment_heads_dump(JAX_PRESETS[name], dump)
        assert mask.dtype == bool and mask.shape == want.shape
        np.testing.assert_array_equal(mask, want)
    base = PW.decode_alignment_heads_dump(PRESET_DIMS["base"], _ALIGNMENT_HEADS["base"])
    assert [tuple(p) for p in np.argwhere(base)] == [(3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)]


def test_model_alignment_heads(pair):
    jmodel, tmodel = pair
    np.testing.assert_array_equal(tmodel.alignment_heads, jmodel.alignment_heads)
    np.testing.assert_array_equal(PW.default_alignment_heads(tmodel.dims), JW.default_alignment_heads(jmodel.dims))
    model = WhisperModel(PRESET_DIMS["tiny"])
    model.set_alignment_heads(_ALIGNMENT_HEADS["tiny"])
    np.testing.assert_array_equal(model.alignment_heads,
                                  JW.decode_alignment_heads_dump(JAX_PRESETS["tiny"], JAX_HEADS["tiny"]))


# ------------------------------------------------- find_alignment & words --

TEXT = ' "Hello there," she said. (It\'s 3 o\'clock!) Isn\'t it?'


def _tokenizers(language="en"):
    return (jax_get_tokenizer(True, language=language, task="transcribe"),
            get_tokenizer(True, language=language, task="transcribe"))


def _same_timings(got, want):
    assert [w.word for w in got] == [w.word for w in want]
    assert [w.tokens for w in got] == [w.tokens for w in want]
    for g, w in zip(got, want):
        assert round(g.start, 2) == round(float(w.start), 2) and round(g.end, 2) == round(float(w.end), 2)
        assert abs(g.probability - w.probability) <= PROB_TOL


@pytest.mark.parametrize("heads", ["default", "custom"])
def test_find_alignment_matches_jax(pair, heads):
    jmodel, tmodel = pair
    if heads == "custom":
        jmodel, tmodel = copy.copy(jmodel), copy.copy(tmodel)
        mask = np.array([[False, True], [True, False]])
        jmodel.alignment_heads, tmodel.alignment_heads = mask, mask
    jtok, ptok = _tokenizers()
    text_tokens = ptok.encode(TEXT)
    assert text_tokens == jtok.encode(TEXT)
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(1, 192, seed=7)[0], use_pallas=False))
    for num_frames in (192, 150):
        want = JT.find_alignment(jmodel, jtok, text_tokens, mel, num_frames)
        got = PT.find_alignment(tmodel, ptok, text_tokens, _t(mel), num_frames)
        assert len(got) > 5
        _same_timings(got, want)
    assert PT.find_alignment(tmodel, ptok, [], _t(mel), 192) == []


def test_add_word_timestamps_matches_jax(pair):
    jmodel, tmodel = pair
    jtok, ptok = _tokenizers()
    body = ptok.encode(TEXT)
    stamp = ptok.timestamp_begin
    segments = [
        dict(seek=300, start=3.0, end=3.9, text="", tokens=[stamp, *body[:6], stamp + 45]),
        dict(seek=300, start=3.9, end=4.8, text="", tokens=[stamp + 45, *body[6:], stamp + 90]),
    ]
    mel = np.asarray(JA.log_mel_spectrogram(waveforms(1, 192, seed=8)[0], use_pallas=False))
    for last_speech in (0.0, 3.5):
        want, got = copy.deepcopy(segments), copy.deepcopy(segments)
        JT.add_word_timestamps(segments=want, model=jmodel, tokenizer=jtok, mel=mel, num_frames=180,
                               last_speech_timestamp=last_speech)
        PT.add_word_timestamps(segments=got, model=tmodel, tokenizer=ptok, mel=_t(mel), num_frames=180,
                               last_speech_timestamp=last_speech)
        for g, w in zip(got, want):
            assert (g["start"], g["end"]) == (w["start"], w["end"])
            assert [(x["word"], x["start"], x["end"]) for x in g["words"]] == [
                (x["word"], x["start"], x["end"]) for x in w["words"]]
            for x, y in zip(g["words"], w["words"]):
                assert abs(x["probability"] - y["probability"]) <= PROB_TOL
        assert sum(len(s["words"]) for s in got) > 5


def _timings(words, seed=0):
    rng = np.random.RandomState(seed)
    t, out = 0.0, []
    for n, word in enumerate(words):
        d = float(rng.choice([0.0, 0.1, 0.4, 2.5]))
        out.append((word, [100 + n, 200 + n][: 1 + n % 2], t, t + d, float(rng.uniform())))
        t += d
    return out


MERGE_CASES = [
    [' "', "Hello", ",", " world", ".", ' "'],
    [" (", " (", "it", ")", " is", " ¿", "really", "?", "!"],
    [" “", "quoted", "”", " -", "dash", "、", " x", " "],
    [".", " a", " b"],
]


@pytest.mark.parametrize("words", MERGE_CASES, ids=["quotes", "chains", "cjk-marks", "leading-mark"])
def test_merge_punctuations_matches_jax(words):
    prepend, append = "\"'“¿([{-", "\"'.。,，!！?？:：”)]}、"
    for seed in range(3):
        rows = _timings(words, seed)
        got = [PT.WordTiming(w, list(t), s, e, p) for w, t, s, e, p in rows]
        want = [JT.WordTiming(w, list(t), s, e, p) for w, t, s, e, p in rows]
        PT.merge_punctuations(got, prepend, append)
        JT.merge_punctuations(want, prepend, append)
        assert [(w.word, w.tokens) for w in got] == [(w.word, w.tokens) for w in want]
        assert PT._typical_duration(got) == JT._typical_duration(want)


@pytest.mark.parametrize("language,text", [("en", TEXT), ("zh", "你好，世界。今天天气很好！"), ("ja", "こんにちは、世界")])
def test_split_to_word_tokens_matches_jax(language, text):
    jtok, ptok = _tokenizers(language)
    tokens = ptok.encode(text) + [ptok.eot]
    assert ptok.split_to_word_tokens(tokens) == jtok.split_to_word_tokens(tokens)


# ------------------------------------------------- hallucination helpers --


def _segments(seed):
    rng = np.random.RandomState(seed)
    t, segments = float(rng.uniform(0, 3)), []
    for _ in range(rng.randint(1, 6)):
        t += float(rng.choice([0.1, 0.5, 3.0]))
        words, start = [], t
        for _ in range(rng.randint(0, 5)):
            d = float(rng.choice([0.05, 0.3, 1.0, 2.6]))
            words.append(dict(word=str(rng.choice([" a", " hello", ",", "?", " x"])), start=round(t, 2),
                              end=round(t + d, 2), probability=float(rng.choice([0.05, 0.5, 0.9]))))
            t += d
        segments.append(dict(start=round(start, 2), end=round(t, 2), words=words))
    return segments


@pytest.mark.parametrize("seed", range(8))
def test_hallucination_helpers_match_jax(seed):
    segments = _segments(seed)
    for s in segments:
        assert PTR._is_hallucination(s) == JTR._is_hallucination(s)
        for w in s["words"]:
            assert PTR._anomaly_score(w) == JTR._anomaly_score(w)
    assert PTR._first_with_words(segments) == JTR._first_with_words(segments)
    for threshold in (0.5, 2.0):
        kw = dict(threshold=threshold, time_offset=1.0, window_end_time=31.0, segment_duration=20.0,
                  content_duration=25.0, content_frames=2500, last_speech_timestamp=0.5)
        got, want = copy.deepcopy(segments), copy.deepcopy(segments)
        assert PTR._drop_hallucinated_tail(got, **kw) == JTR._drop_hallucinated_tail(want, **kw)
        assert got == want
    assert PTR._PUNCTUATION == JTR._PUNCTUATION


@pytest.mark.parametrize("lo,hi", [(0, 511), (512, 1023), (1024, 2047), (2048, PD.MAX_TOKENS)],
                         ids=["2-rows-a-lane", "4-rows", "8-rows-8-warps", "8-rows-16-warps"])
def test_k13_plan_covers_the_rows(lo, hi):
    """K13's plan for every token count the wrapper takes: the lanes of the
    compute warps cover the N+1 rows with no idle warp, at most 8 compute
    warps (16 at 8 rows a lane) with 1, 2 or 4 helpers each, within 1024 threads,
    the shared memory fits a block, and a helper's staging and writing
    passes (32 / chunk rows each) tile a warp's rows. K12's plan at each
    n_max (0 included: a batch of rows without tokens) is K13's, and the
    walk's shared memory behind the fill's fits a block too."""
    for n in range(lo, hi + 1):
        rows_per_lane, chunk, warps, helpers, smem = PD.k13_plan(n, 1500)
        assert rows_per_lane in (2, 4, 8) and chunk in (4, 8, 16, 32), n
        assert (warps - 1) * 32 * rows_per_lane < n + 1 <= warps * 32 * rows_per_lane, n
        assert warps <= 8 or (rows_per_lane == 8 and warps <= 16), n
        assert helpers in (1, 2, 4) and warps * (1 + helpers) * 32 <= 1024, n
        assert (rows_per_lane * chunk) % helpers == 0, n  # a helper's passes: a whole number
        assert chunk == PD.k13_chunk(rows_per_lane, warps), n
        assert smem == warps * PD.k13_warp_bytes(rows_per_lane, chunk) <= PD.K13_MAX_SMEM, n
        assert (32 * rows_per_lane) % (32 // chunk) == 0, n
        # K12 takes K13's plan at its n_max, 1024 threads, and the walk's shared memory behind the fill's
        k12 = PD.k12_plan(n)
        assert k12[:4] == (rows_per_lane, chunk, warps, helpers), n
        assert k12[4] == PD.K12_THREADS >= warps * (1 + helpers) * 32, n
        assert k12[5] == smem + PD.K12_WALK_BYTES <= PD.K13_MAX_SMEM, n


# ------------------------------------------------------- on the card ------


def _k11_card_inputs(width: int):
    """K11's card cases at one width: the words path's largest shape with a
    NaN column; t = width // 2 + 1, the least the kernel takes; odd t, not
    a whole number of a thread's two outputs; more than 65535 rows at a
    short t (the grid's loop over rows); a NaN at each position of a window
    (row r holds one at column 9 + r, and the edges' reflections one at
    columns 0 and 1), with +-inf and ties beside them."""
    h = width // 2
    yield "words-largest", _median_inputs((8, 229, 1500), seed=width)
    yield "t-least", _median_inputs((5, h + 1), seed=width, nan_column=False)
    yield "t-odd", _median_inputs((3, 37), seed=width)
    yield "rows-over-65535", _median_inputs((70001, 9), seed=width, nan_column=False)
    x = np.round(np.random.RandomState(width).randn(width + 3, 41).astype(np.float32) * 2)
    for r in range(width + 1):
        x[r, 9 + r] = np.nan
    x[width + 1, 0] = x[width + 2, 1] = np.nan
    x[:, 30], x[:, 33] = np.inf, -np.inf
    yield "nan-at-each-position", x


@pytest.mark.cuda
@pytest.mark.parametrize("width", [3, 5, 7, 9, 11, 13])
def test_k11_kernel_on_card(cuda_device, width):  # noqa: F811
    """Exact: min and max round nothing, and both propagate NaN, so the
    kernel's pruned network gives the plain transposition network's NaN
    mask and values; the same bits on a second launch."""
    for case, x in _k11_card_inputs(width):
        x = _t(x).to(cuda_device)
        got = PM.median_filter_network(x, width)
        want = PM.median_filter_network_plain(x, width)
        assert torch.equal(torch.isnan(got), torch.isnan(want)), case
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)), case
        again = PM.median_filter_network(x, width)
        assert torch.equal(again.view(torch.int32), got.view(torch.int32)), case


K13_CARD_CASES = [(shape, ties, None) for shape, ties in DTW_CASES] + [
    ((225, 1500), False, None), ((300, 700), True, None), ((225, 1499), False, None), ((52, 1500), False, None),
    ((1100, 300), False, None), ((4095, 40), False, None), ((60, 200), False, 17), ((450, 300), False, None),
    ((600, 200), False, None), ((900, 100), False, None), ((1700, 60), False, None), ((2300, 40), False, None)]
K13_CARD_IDS = DTW_IDS + ["base-window", "ties-large", "row-not-16-byte", "words-largest", "over-1024-rows",
                          "4096-rows", "nan-row", "2-rows-2-helpers", "4-rows-4-helpers", "4-rows-2-helpers",
                          "8-rows-2-helpers", "8-rows-9-warps"]


def test_k13_card_cases_cover_every_instance():
    """Each (rows a lane, chunk, helpers) that `k13_plan` picks for some N up
    to 4095 is a template instance of its own in csrc/dtw.cu; the card test
    runs every one of them."""
    def instance(n):
        rows_per_lane, chunk, _, helpers, _ = PD.k13_plan(n, 1)
        return rows_per_lane, chunk, helpers

    picked = {instance(n) for n in range(1, 4096)}
    assert {instance(shape[0]) for shape, _, _ in K13_CARD_CASES} == picked
    assert len(K13_CARD_CASES) == len(K13_CARD_IDS) == len(set(K13_CARD_IDS))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ties,nan_row", K13_CARD_CASES, ids=K13_CARD_IDS)
def test_k13_kernel_on_card(cuda_device, shape, ties, nan_row):  # noqa: F811
    """Bit for bit against the plain version, on a second launch too: a real
    window's shape, a row of x not a multiple of 16 bytes (M 1499), more
    than 1024 rows (8 a lane), 4096 rows (16 warps), ties, a row of NaN
    (t = 2 wherever a NaN cost is compared), and among them every
    (rows a lane, chunk, helpers) instance `k13_plan` picks."""
    x = _cost(shape, seed=sum(shape), ties=ties)
    if nan_row is not None:
        x[nan_row] = np.nan
    x = _t(x).to(cuda_device)
    got = PD.dtw_trace(x)
    assert torch.equal(got, PD.dtw_trace_plain(x))
    assert torch.equal(PD.dtw_trace(x), got)
    assert torch.equal(PD.dtw_trace(x[:, :0]), PD.dtw_trace_plain(x[:, :0]))  # no frames: no launch
    np.testing.assert_array_equal(PD.dtw(x), PD.backtrace(PD.dtw_trace_plain(x).cpu().numpy()))
