"""The port's text normalizers against the JAX package's, on the cases of
tests/test_normalizers.py (which compares the JAX package with the
reference when the reference is mounted) and a random word soup; and the
port's grapheme segmentation, which does without the `regex` package,
against `regex`'s `\\X` (installed here), with the differences its
docstring names pinned."""

import random

import pytest
import regex

from asr_ttl_mtl_tpu.normalizers import BasicTextNormalizer as JBasic
from asr_ttl_mtl_tpu.normalizers import EnglishTextNormalizer as JEnglish
from asr_ttl_mtl_tpu.normalizers.english import EnglishNumberNormalizer as JNumber
from asr_ttl_mtl_tpu.normalizers.english import EnglishSpellingNormalizer as JSpelling

from asr_ttl_mtl_tpu_torch.normalizers import BasicTextNormalizer, EnglishTextNormalizer
from asr_ttl_mtl_tpu_torch.normalizers.basic import split_graphemes
from asr_ttl_mtl_tpu_torch.normalizers.english import EnglishNumberNormalizer, EnglishSpellingNormalizer

BASIC_CASES = [
    "Hello, World!",
    "Ünïcödé — tëst «string» with œ, ß, and Łódź",
    "[noise] (laughs) <unk> real words",
    "MULTIPLE    spaces\tand\nnewlines",
    "日本語のテキスト、句読点。",
    "naïve façade coöperate",
    "héllo 世界 test",
    "한국어 텍스트 ᄒᆞᆫ",
    "👨‍👩‍👧 family 🇫🇷🇩🇪 flags 👍🏽",
]

NUMBER_CASES = [
    "one hundred and twenty three", "twenty twenty four", "one oh one", "nineteen sixty",
    "the nineteen sixties", "two hundred and seventy fourth", "thirty second street", "minus five degrees",
    "plus or minus three", "twenty dollars", "twenty dollars and seven cents", "a million dollars",
    "three point one four one five nine", "two and a half hours", "double oh seven", "triple nine",
    "fifty percent", "three per cent", "one ones one", "six sixes sixty sixth",
    "a dozen eggs cost two euros", "he won twenty twenty-two awards", "1,234,567 things",
    "version 2.5.1 released", "1960s music", "32nd and 3rd", "$5 million", "zero zero seven",
    "one thousand and one nights", "seven hundred billion", "twelve thirty", "four score and seven years ago",
    "point five", "oh point five",
    "one million two hundred thirty four thousand five hundred sixty seven",
]

ENGLISH_CASES = [
    "Mr. Brown won't go to Dr. Smith's office.",
    "I'm gonna be there, y'all!",
    "it's been a long day; she'd gone home",
    "Let's meet at 3:30... or maybe 4 o'clock?",
    "colour and flavour vs color and flavor",
    "The programme organised a dialogue about defence.",
    "hmm, uh, I think, um, it works",
    "He paid $20 million for the yacht.",
    "Won't you buy twenty-five apples?",
    "I OWE YOU $1.50!",
    "the metre measured a litre of petrol",
]


@pytest.mark.parametrize("split_letters", [False, True])
@pytest.mark.parametrize("remove_diacritics", [False, True])
def test_basic_normalizer_as_jax(remove_diacritics, split_letters):
    kw = dict(remove_diacritics=remove_diacritics, split_letters=split_letters)
    ours, theirs = BasicTextNormalizer(**kw), JBasic(**kw)
    for case in BASIC_CASES:
        assert ours(case) == theirs(case), case


def test_number_normalizer_as_jax():
    ours, theirs = EnglishNumberNormalizer(), JNumber()
    for case in NUMBER_CASES:
        assert ours(case) == theirs(case), case


def test_english_normalizer_as_jax():
    ours, theirs = EnglishTextNormalizer(), JEnglish()
    for case in ENGLISH_CASES:
        assert ours(case) == theirs(case), case
    assert EnglishSpellingNormalizer().mapping == JSpelling().mapping and len(JSpelling().mapping) > 1000


def test_number_normalizer_word_soup_as_jax():
    ours, theirs = EnglishNumberNormalizer(), JNumber()
    vocab = list(ours.words) + ["cat", "dog", "the", "7", "3.5", "$4", "-2", "."]
    rng = random.Random(0)
    for _ in range(300):
        s = " ".join(rng.choice(vocab) for _ in range(rng.randint(1, 12)))
        try:
            want = theirs(s)
        except Exception:
            with pytest.raises(Exception):
                ours(s)
            continue
        assert ours(s) == want, s


GRAPHEME_CORPUS = [
    "éa", "é̂x", "कि", "นำ", "กิ่",  # combining marks, spacing marks
    "한국어", "한", "ᄀ가", "각x",  # precomposed and L V T jamo
    "👨‍👩‍👧‍👦!", "🏳️‍🌈", "x‍y", "👍🏽👍",  # ZWJ sequences, modifiers
    "🇫🇷🇩🇪🇺", "a🇺🇸b",  # regional-indicator pairs
    "a\r\nb\n\rc", "؀a", "🏴\U000e0067\U000e0062\U000e0073\U000e0063\U000e0074\U000e007f",
]


def test_graphemes_as_regex_X():
    for s in GRAPHEME_CORPUS:
        assert split_graphemes(s) == regex.findall(r"\X", s), s


def test_graphemes_random_strings_as_regex_X():
    """Random strings over the classes the rules tell apart, all equal to
    `\\X`'s clusters. The draw holds no Indic consonant after a virama
    (GB9c) and only pictographs of category So (see the next test)."""
    pools = [range(0x61, 0x7B), range(0x300, 0x370), range(0x1100, 0x1200), range(0xAC00, 0xAC40),
             range(0x1F1E6, 0x1F200), range(0x1F600, 0x1F650), [0x200D, 0x200C, 0xFE0F, 0x0D, 0x0A, 0x0600],
             range(0xE00, 0xE60), range(0x1F3FB, 0x1F400)]
    rng = random.Random(0)
    for _ in range(3000):
        s = "".join(chr(rng.choice(rng.choice(pools))) for _ in range(rng.randint(1, 8)))
        assert split_graphemes(s) == regex.findall(r"\X", s), repr(s)


def test_graphemes_differences_named_in_the_docstring():
    """GB9c (Indic conjuncts) is not applied, and Extended_Pictographic is
    the category So: these inputs split where `\\X` does not."""
    conjunct = "क्षि"  # क्षि
    assert regex.findall(r"\X", conjunct) == [conjunct]
    assert split_graphemes(conjunct) == ["क्", "षि"]
    po_zwj = "‼‍‼"  # two double exclamation marks (Po, yet pictographic) joined by ZWJ
    assert regex.findall(r"\X", po_zwj) == [po_zwj]
    assert split_graphemes(po_zwj) == ["‼‍", "‼"]
