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
    """Formerly not ported; now the full GPT-2 pre-tokenization: equal to tiktoken."""
    p = PT.get_tokenizer(True)
    j = JT.get_tokenizer(True)
    assert p.encode(" hello world") == j.encode(" hello world")


CORPUS = [
    "hello world", " Hello, world!", "it's we're they've I'm you'll he'd don't",
    "IT'S WE'RE", "''s 's' '", "rock'n'roll", "abc123def 4567 8.9e10 ½ ²³ Ⅻ",
    "café naïve Ünïcödé façade", "日本語のテキスト 中文 한국어", "Привет, мир!", "مرحبا بالعالم",
    "!!! ??? ... --- ((( ))) ♪♪ ♪", "a  b   c    d", "line\nbreak\n\nand\r\ncrlf",
    "tabs\tand\t\tmore", "trailing space ", "trailing spaces   ", "trailing newline\n",
    "   leading", "\n\nleading newlines", " \u3000ideographic\u3000space", "nbsp\xa0here",
    "mixed 12ab ab12 a1b2", "emoji 🙂🙂 👍🏽", "$100.00 & 50% off #1 @user", "",
    "x", " ", "\t", " 's", "a's'b", "\u2028sep\u2029", "under_score-dash/slash\\back",
]
_CLASSES = ["abcXYZ", "0123456789", "éüñçßÆ", "日本語中文한국", " ", "  ", "\n", "\t", ".,!?;:'\"()-_/♪",
            "'s", "'re", "'ll", "Ⅻ½²", "\xa0"]


def _random_strings(seed: int, n: int):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(1, 12)):
            cls = _CLASSES[rng.randint(len(_CLASSES))]
            parts.append("".join(cls[rng.randint(len(cls))] for _ in range(rng.randint(1, 4))))
        yield "".join(parts)


@pytest.mark.parametrize("multilingual", [True, False], ids=["multilingual", "en"])
def test_encode_corpus_matches_tiktoken(multilingual):
    j = JT.get_tokenizer(multilingual)
    p = PT.get_tokenizer(multilingual)
    for text in CORPUS:
        assert p.encode(text) == j.encode(text), repr(text)


@pytest.mark.parametrize("multilingual", [True, False], ids=["multilingual", "en"])
def test_encode_random_strings_match_tiktoken(multilingual):
    j = JT.get_tokenizer(multilingual, include_diseases=True)
    p = PT.get_tokenizer(multilingual, include_diseases=True)
    for text in _random_strings(seed=7, n=300):
        assert p.encode(text) == j.encode(text), repr(text)
        assert p.decode(p.encode(text)) == text


def test_encode_rejects_special_token_text():
    p = PT.get_tokenizer(True)
    with pytest.raises(ValueError):
        p.encode("hi <|endoftext|>")
