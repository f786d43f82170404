"""English text normalization for WER scoring.

Counterpart of `asr_ttl_mtl_tpu/normalizers/english.py` (itself the
reference's `whisper/normalizers/english.py`): `EnglishNumberNormalizer`
(spelled-out numbers -> arabic numerals, currency / percent / ordinal
handling), `EnglishSpellingNormalizer` (the British->American map of
`english.json`, the port's own copy) and the top-level
`EnglishTextNormalizer` contraction rules. Plain `re` and `fractions`; the
number normalizer is an emitter object (`_Emitter`) with one handler per
token category, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import re
from fractions import Fraction
from typing import List, Optional, Union

from .basic import remove_symbols_and_diacritics

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")

# -- precompiled patterns used by the pre/post-processing passes --------------
_AND_A_HALF_RE = re.compile(r"\band\s+a\s+half\b")
_LETTER_THEN_DIGIT_RE = re.compile(r"([a-z])([0-9])")
_DIGIT_THEN_LETTER_RE = re.compile(r"([0-9])([a-z])")
_DETACHED_ORDINAL_RE = re.compile(r"([0-9])\s+(st|nd|rd|th|s)\b")
_CURRENCY_AND_CENTS_RE = re.compile(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b")
_SUBDOLLAR_RE = re.compile(r"[€£$]0.([0-9]{1,2})\b")
_LITERAL_ONE_RE = re.compile(r"\b1(s?)\b")

_BRACKETED_RE = re.compile(r"[<\[][^>\]]*[>\]]")
_PARENTHESIZED_RE = re.compile(r"\(([^)]+?)\)")
_DETACHED_APOSTROPHE_RE = re.compile(r"\s+'")
_DIGIT_GROUP_COMMA_RE = re.compile(r"(\d),(\d)")
_NON_NUMERIC_PERIOD_RE = re.compile(r"\.([^0-9]|$)")
_DANGLING_SYMBOL_RE = re.compile(r"[.$¢€£]([^0-9])")
_DANGLING_PERCENT_RE = re.compile(r"([^0-9])%")
_WHITESPACE_RE = re.compile(r"\s+")


def _as_fraction(token) -> Optional[Fraction]:
    try:
        value = Fraction(token)
    except ValueError:
        value = None
    return value


def _pluralize(word: str) -> str:
    return "sixes" if word == "six" else word + "s"


def _ordinalize(word: str) -> str:
    return word + ("h" if word.endswith("t") else "th")


class _Emitter:
    """Accumulates the in-progress number (`value`) and sign/currency
    `prefix`, and collects finalized output words."""

    def __init__(self):
        self.prefix: Optional[str] = None
        self.value: Optional[Union[str, int]] = None
        self.out: List[str] = []

    def flush(self, result=None):
        """Finalize `result` (default: the pending value) into the output."""
        if result is None:
            result = self.value
        text = str(result)
        if self.prefix is not None:
            text = self.prefix + text
        self.prefix = None
        self.value = None
        self.out.append(text)

    def flush_pending(self):
        if self.value is not None:
            self.flush()

    def append_digits(self, digits: str):
        self.value = str(self.value or "") + digits


class EnglishNumberNormalizer:
    """Convert spelled-out numbers to arabic numerals: keeps ordinal/plural
    suffixes (`274th`, `1960s`), moves currency symbols in front (`$20
    million` -> spelled `20000000 dollars` -> `$20000000`), reads successive
    single digits as nominal (`one oh one` -> `101`), and leaves bare
    `one`/`ones` alone."""

    def __init__(self):
        self.zeros = {"o", "oh", "zero"}
        one_names = [
            "one", "two", "three", "four", "five", "six", "seven", "eight",
            "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
            "fifteen", "sixteen", "seventeen", "eighteen", "nineteen",
        ]
        self.ones = {name: i + 1 for i, name in enumerate(one_names)}
        self.ones_plural = {
            _pluralize(name): (value, "s") for name, value in self.ones.items()
        }
        irregular_ordinals = {
            "zeroth": (0, "th"), "first": (1, "st"), "second": (2, "nd"),
            "third": (3, "rd"), "fifth": (5, "th"), "twelfth": (12, "th"),
        }
        regular_ordinals = {
            _ordinalize(name): (value, "th")
            for name, value in self.ones.items()
            if value > 3 and value not in (5, 12)
        }
        self.ones_ordinal = dict(irregular_ordinals)
        self.ones_ordinal.update(regular_ordinals)
        self.ones_suffixed = dict(self.ones_plural)
        self.ones_suffixed.update(self.ones_ordinal)

        self.tens = {
            "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
            "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
        }
        self.tens_suffixed = {}
        for name, value in self.tens.items():
            self.tens_suffixed[name.replace("y", "ies")] = (value, "s")
            self.tens_suffixed[name.replace("y", "ieth")] = (value, "th")

        multiplier_names = [
            "hundred", "thousand", "million", "billion", "trillion",
            "quadrillion", "quintillion", "sextillion", "septillion",
            "octillion", "nonillion", "decillion",
        ]
        self.multipliers = {
            name: 100 if name == "hundred" else 10 ** (3 * i)
            for i, name in enumerate(multiplier_names)
        }
        self.multipliers_suffixed = {}
        for name, value in self.multipliers.items():
            self.multipliers_suffixed[name + "s"] = (value, "s")
            self.multipliers_suffixed[name + "th"] = (value, "th")
        self.decimals = set(self.ones) | set(self.tens) | set(self.zeros)

        self.preceding_prefixers = {"minus": "-", "negative": "-", "plus": "+", "positive": "+"}
        self.following_prefixers = {}
        for currency, symbol in (("pound", "£"), ("euro", "€"), ("dollar", "$"), ("cent", "¢")):
            self.following_prefixers[currency] = symbol
            self.following_prefixers[currency + "s"] = symbol
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}

        self.words = set().union(
            self.zeros, self.ones, self.ones_suffixed, self.tens,
            self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials,
        )
        self.literal_words = {"one", "ones"}

        # category dispatch for process_words, checked in this order (the
        # reference's elif chain order; a token in several tables takes the
        # earliest category)
        self._categories = (
            (self.zeros, self._handle_zero),
            (self.ones, self._handle_one),
            (self.ones_suffixed, self._handle_one_suffixed),
            (self.tens, self._handle_ten),
            (self.tens_suffixed, self._handle_ten_suffixed),
            (self.multipliers, self._handle_multiplier),
            (self.multipliers_suffixed, self._handle_multiplier_suffixed),
            (self.preceding_prefixers, self._handle_preceding_prefixer),
            (self.following_prefixers, self._handle_following_prefixer),
            (self.suffixers, self._handle_suffixer),
            (self.specials, self._handle_special),
        )

    # -- per-category handlers (uniform signature; each mirrors one branch of
    # the reference's state machine, flush timing preserved exactly; returns
    # True to consume the following token) -----------------------------------

    def _handle_arabic(self, em: _Emitter, current: str):
        leading = current[0] in self.prefixes
        digits = current[1:] if leading else current
        frac = _as_fraction(digits)
        assert frac is not None
        if em.value is not None:
            if isinstance(em.value, str) and em.value.endswith("."):
                # decimal continuation / dotted sequences like IP addresses
                em.value = str(em.value) + str(current)
                return
            em.flush()
        if leading:
            em.prefix = current[0]
        em.value = frac.numerator if frac.denominator == 1 else digits

    def _handle_zero(self, em, prev, current, nxt, next_is_numeric):
        em.append_digits("0")

    def _handle_one(self, em, prev, current, nxt, next_is_numeric):
        unit = self.ones[current]
        if em.value is None:
            em.value = unit
        elif isinstance(em.value, str) or prev in self.ones:
            if prev in self.tens and unit < 10:
                assert em.value[-1] == "0"
                em.value = em.value[:-1] + str(unit)  # fill the tens slot
            else:
                em.value = str(em.value) + str(unit)
        elif unit < 10:
            if em.value % 10 == 0:
                em.value += unit
            else:
                em.value = str(em.value) + str(unit)
        else:  # eleven..nineteen
            if em.value % 100 == 0:
                em.value += unit
            else:
                em.value = str(em.value) + str(unit)

    def _handle_one_suffixed(self, em, prev, current, nxt, next_is_numeric):
        unit, tail = self.ones_suffixed[current]
        if em.value is None:
            em.flush(str(unit) + tail)
        elif isinstance(em.value, str) or prev in self.ones:
            if prev in self.tens and unit < 10:
                assert em.value[-1] == "0"
                em.flush(em.value[:-1] + str(unit) + tail)
            else:
                em.flush(str(em.value) + str(unit) + tail)
        elif unit < 10:
            if em.value % 10 == 0:
                em.flush(str(em.value + unit) + tail)
            else:
                em.flush(str(em.value) + str(unit) + tail)
        else:
            if em.value % 100 == 0:
                em.flush(str(em.value + unit) + tail)
            else:
                em.flush(str(em.value) + str(unit) + tail)
        em.value = None

    def _handle_ten(self, em, prev, current, nxt, next_is_numeric):
        ten = self.tens[current]
        if em.value is None:
            em.value = ten
        elif isinstance(em.value, str):
            em.value = str(em.value) + str(ten)
        elif em.value % 100 == 0:
            em.value += ten
        else:
            em.value = str(em.value) + str(ten)

    def _handle_ten_suffixed(self, em, prev, current, nxt, next_is_numeric):
        ten, tail = self.tens_suffixed[current]
        if em.value is None:
            em.flush(str(ten) + tail)
        elif isinstance(em.value, str):
            em.flush(str(em.value) + str(ten) + tail)
        elif em.value % 100 == 0:
            em.flush(str(em.value + ten) + tail)
        else:
            em.flush(str(em.value) + str(ten) + tail)

    def _handle_multiplier(self, em, prev, current, nxt, next_is_numeric):
        factor = self.multipliers[current]
        if em.value is None:
            em.value = factor
        elif isinstance(em.value, str) or em.value == 0:
            frac = _as_fraction(em.value)
            scaled = frac * factor if frac is not None else None
            if frac is not None and scaled.denominator == 1:
                em.value = scaled.numerator
            else:
                em.flush()
                em.value = factor
        else:
            head = em.value // 1000 * 1000
            tail = em.value % 1000
            em.value = head + tail * factor

    def _handle_multiplier_suffixed(self, em, prev, current, nxt, next_is_numeric):
        factor, suffix = self.multipliers_suffixed[current]
        if em.value is None:
            em.flush(str(factor) + suffix)
        elif isinstance(em.value, str):
            frac = _as_fraction(em.value)
            scaled = frac * factor if frac is not None else None
            if frac is not None and scaled.denominator == 1:
                em.flush(str(scaled.numerator) + suffix)
            else:
                em.flush()
                em.flush(str(factor) + suffix)
        else:
            head = em.value // 1000 * 1000
            tail = em.value % 1000
            em.value = head + tail * factor
            em.flush(str(em.value) + suffix)
        em.value = None

    def _handle_preceding_prefixer(self, em, prev, current, nxt, next_is_numeric):
        em.flush_pending()
        if (nxt in self.words) or next_is_numeric:
            em.prefix = self.preceding_prefixers[current]
        else:
            em.flush(current)

    def _handle_following_prefixer(self, em, prev, current, nxt, next_is_numeric):
        if em.value is not None:
            em.prefix = self.following_prefixers[current]
            em.flush()
        else:
            em.flush(current)

    def _handle_suffixer(self, em, prev, current, nxt, next_is_numeric):
        if em.value is None:
            em.flush(current)
            return
        tail = self.suffixers[current]
        if isinstance(tail, dict):
            if nxt in tail:
                em.flush(str(em.value) + tail[nxt])
                return True  # consumed the following token
            em.flush()
            em.flush(current)
        else:
            em.flush(str(em.value) + tail)

    def _handle_special(self, em, prev, current, nxt, next_is_numeric):
        if (nxt not in self.words) and not next_is_numeric:
            em.flush_pending()
            em.flush(current)
        elif current == "and":
            # "and" between multiplier groups is dropped
            if prev not in self.multipliers:
                em.flush_pending()
                em.flush(current)
        elif current in ("double", "triple"):
            if nxt in self.ones or nxt in self.zeros:
                count = {"double": 2, "triple": 3}[current]
                em.append_digits(str(self.ones.get(nxt, 0)) * count)
                return True
            em.flush_pending()
            em.flush(current)
        elif current == "point":
            if nxt in self.decimals or next_is_numeric:
                em.append_digits(".")
        else:  # pragma: no cover
            raise ValueError(f"Unexpected token: {current}")

    # -- driver ---------------------------------------------------------------

    def process_words(self, words: List[str]) -> List[str]:
        em = _Emitter()
        consume_next = False
        total = len(words)
        for position, current in enumerate(words):
            if consume_next:
                consume_next = False
                continue
            prev = words[position - 1] if position > 0 else None
            nxt = words[position + 1] if position + 1 < total else None
            next_is_numeric = nxt is not None and _NUMERIC_RE.match(nxt)
            stripped = current[1:] if current[0] in self.prefixes else current

            if _NUMERIC_RE.match(stripped):
                self._handle_arabic(em, current)
                continue
            if current not in self.words:
                em.flush_pending()
                em.flush(current)
                continue
            for table, handler in self._categories:
                if current in table:
                    consume_next = bool(
                        handler(em, prev, current, nxt, next_is_numeric)
                    )
                    break
            else:  # pragma: no cover
                raise ValueError(f"Unexpected token: {current}")

        em.flush_pending()
        return em.out

    def preprocess(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        pieces = _AND_A_HALF_RE.split(s)
        rebuilt: List[str] = []
        last_index = len(pieces) - 1
        for index, piece in enumerate(pieces):
            if not piece.strip():
                continue
            rebuilt.append(piece)
            if index == last_index:
                continue
            tail_word = piece.rsplit(maxsplit=2)[-1]
            if tail_word in self.decimals or tail_word in self.multipliers:
                rebuilt.append("point five")
            else:
                rebuilt.append("and a half")
        s = " ".join(rebuilt)

        # separate digits glued to letters, but keep ordinal/plural suffixes
        s = _LETTER_THEN_DIGIT_RE.sub(r"\1 \2", s)
        s = _DIGIT_THEN_LETTER_RE.sub(r"\1 \2", s)
        return _DETACHED_ORDINAL_RE.sub(r"\1\2", s)

    def postprocess(self, s: str) -> str:
        def join_cents(match: re.Match) -> str:
            try:
                return f"{match.group(1)}{match.group(2)}.{int(match.group(3)):02d}"
            except ValueError:
                return match.string

        def cent_symbol(match: re.Match) -> str:
            try:
                return f"¢{int(match.group(1))}"
            except ValueError:
                return match.string

        # "$2 and ¢7" -> "$2.07"
        s = _CURRENCY_AND_CENTS_RE.sub(join_cents, s)
        s = _SUBDOLLAR_RE.sub(cent_symbol, s)
        # keep "one(s)" literal for readability
        return _LITERAL_ONE_RE.sub(r"one\1", s)

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(w for w in self.process_words(s.split()) if w is not None)
        return self.postprocess(s)


def _find_spelling_mapping() -> dict:
    """The British->American spelling map, `english.json` beside this
    module (the port's copy of the JAX package's asset; nothing is
    fetched)."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "english.json"), encoding="utf-8") as f:
        return json.load(f)


class EnglishSpellingNormalizer:
    """British->American spelling mapping (tysto.com word list)."""

    def __init__(self):
        self.mapping = _find_spelling_mapping()

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


# word-level contractions, replaced whole-word (\b-delimited on both sides)
_CONTRACTION_WORDS = (
    ("won't", "will not"), ("can't", "can not"), ("let's", "let us"),
    ("ain't", "aint"), ("y'all", "you all"), ("wanna", "want to"),
    ("gotta", "got to"), ("gonna", "going to"), ("i'ma", "i am going to"),
    ("imma", "i am going to"), ("woulda", "would have"),
    ("coulda", "could have"), ("shoulda", "should have"), ("ma'am", "madam"),
)

# abbreviated titles/honorifics; expansion keeps a trailing space so a
# following period (already space-separated) cannot glue words together
_TITLE_WORDS = (
    ("mr", "mister"), ("mrs", "missus"), ("st", "saint"), ("dr", "doctor"),
    ("prof", "professor"), ("capt", "captain"), ("gov", "governor"),
    ("ald", "alderman"), ("gen", "general"), ("sen", "senator"),
    ("rep", "representative"), ("pres", "president"), ("rev", "reverend"),
    ("hon", "honorable"), ("asst", "assistant"), ("assoc", "associate"),
    ("lt", "lieutenant"), ("col", "colonel"), ("jr", "junior"),
    ("sr", "senior"), ("esq", "esquire"),
)

# perfect tenses with unambiguous participles: suffix-anchored on the right
# only ("'d been" can start mid-word after its owner), replacement carries
# the leading space the apostrophe displaced
_PERFECT_TENSE_SUFFIXES = (
    ("'d been", "had been"), ("'s been", "has been"), ("'d gone", "had gone"),
    ("'s gone", "has gone"), ("'d done", "had done"), ("'s got", "has got"),
)

# general clitic contractions, right-anchored, replacement space-prefixed
_CLITIC_SUFFIXES = (
    ("n't", "not"), ("'re", "are"), ("'s", "is"), ("'d", "would"),
    ("'ll", "will"), ("'t", "not"), ("'ve", "have"), ("'m", "am"),
)


def _build_replacers() -> dict:
    rules = {}
    for word, expansion in _CONTRACTION_WORDS:
        rules[rf"\b{word}\b"] = expansion
    for abbrev, title in _TITLE_WORDS:
        rules[rf"\b{abbrev}\b"] = title + " "
    for phrase, expansion in _PERFECT_TENSE_SUFFIXES:
        rules[rf"{phrase}\b"] = " " + expansion
    for clitic, expansion in _CLITIC_SUFFIXES:
        rules[rf"{clitic}\b"] = " " + expansion
    return rules


class EnglishTextNormalizer:
    def __init__(self):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = _build_replacers()
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = _BRACKETED_RE.sub("", s)  # drop bracketed annotations
        s = _PARENTHESIZED_RE.sub("", s)  # drop parenthesized asides
        s = re.sub(self.ignore_patterns, "", s)
        s = _DETACHED_APOSTROPHE_RE.sub("'", s)  # re-attach detached apostrophes

        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)

        s = _DIGIT_GROUP_COMMA_RE.sub(r"\1\2", s)  # digit group commas
        s = _NON_NUMERIC_PERIOD_RE.sub(r" \1", s)  # periods not in numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        # strip numeric symbols that ended up unattached to numbers
        s = _DANGLING_SYMBOL_RE.sub(r" \1", s)
        s = _DANGLING_PERCENT_RE.sub(r"\1 ", s)
        return _WHITESPACE_RE.sub(" ", s)
