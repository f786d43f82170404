"""Port tokenizer (no tiktoken) against the JAX package's tiktoken tokenizer."""

import numpy as np
import pytest

from asr_ttl_mtl_tpu import tokenizer as JT
from asr_ttl_mtl_tpu_torch import tokenizer as PT

LAYOUTS = [
    dict(multilingual=True, language="en", task="transcribe"),
    dict(multilingual=True, language="de", task="translate"),
    dict(multilingual=True, language="en", task="transcribe", include_diseases=True),
    dict(multilingual=False),
    dict(multilingual=False, include_diseases=True),
]
IDS = ["multilingual", "multilingual-de-translate", "multilingual-diseases", "en", "en-diseases"]


def _pair(layout):
    kw = dict(layout)
    multilingual = kw.pop("multilingual")
    return JT.get_tokenizer(multilingual, **kw), PT.get_tokenizer(multilingual, **kw)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_special_token_layout(layout):
    j, p = _pair(layout)
    for name in PT._MARKERS:
        assert getattr(p, name) == getattr(j, name), name
    assert p.special_tokens == j.special_tokens
    assert p.encoding.n_vocab == j.encoding.n_vocab
    assert p.sot_sequence == j.sot_sequence
    assert p.sot_sequence_including_notimestamps == j.sot_sequence_including_notimestamps
    assert p.disease_tokens == j.disease_tokens
    # the JAX tokenizer fills its special-token dict from a set, so only the
    # membership of all_language_tokens is layout-defined
    assert sorted(p.all_language_tokens) == sorted(j.all_language_tokens)


def test_disease_splice_ids():
    p = PT.get_tokenizer(True, language="en", task="transcribe", include_diseases=True)
    assert p.disease_tokens == {"normal": 50359, "dysphonia": 50360, "dysarthria": 50361}
    assert p.encoding.n_vocab == 51869 and p.sot_sequence == (50258, 50259, 50363)
    e = PT.get_tokenizer(False, include_diseases=True)
    assert e.disease_tokens == {"normal": 50358, "dysphonia": 50359, "dysarthria": 50360}
    assert e.encoding.n_vocab == 51868 and e.sot_sequence == (50257,)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_non_speech_tokens(layout):
    j, p = _pair(layout)
    assert p.non_speech_tokens == j.non_speech_tokens


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_decode_random_ids(layout):
    j, p = _pair(layout)
    rng = np.random.RandomState(0)
    for _ in range(20):
        ids = rng.randint(0, p.encoding.n_vocab, size=rng.randint(1, 30)).tolist()
        assert p.decode(ids) == j.decode(ids)
        assert p.decode_with_timestamps(ids) == j.decode_with_timestamps(ids)


@pytest.mark.parametrize("multilingual", [True, False])
def test_decode_of_encoded_text(multilingual):
    j = JT.get_tokenizer(multilingual)
    p = PT.get_tokenizer(multilingual)
    text = " Hello, world! Ünïcödé — 日本語のテキスト ♪♪"
    ids = j.encode(text)
    assert p.decode(ids) == text
    assert p.decode(ids + [p.timestamp_begin + 5]) == text


@pytest.mark.parametrize(
    "text", [" ", "  ", " -", " '", "♪♪♪", " ♪", "<<", " (\"", "「", "_", " @", " ))"]
)
def test_single_pretoken_encode(text):
    for multilingual in (True, False):
        j = JT.get_tokenizer(multilingual)
        p = PT.get_tokenizer(multilingual)
        assert p.encode(text) == j.encode(text)


def test_encode_of_several_pretokens_is_not_ported():
    p = PT.get_tokenizer(True)
    with pytest.raises(NotImplementedError):
        p.encode(" hello world")
