"""Language-agnostic text normalization for WER scoring.

Counterpart of `asr_ttl_mtl_tpu/normalizers/basic.py` (the reference's
`whisper/normalizers/basic.py`). The JAX package splits letters into
extended grapheme clusters with the `regex` package's `\\X` (:66); the port
does without `regex`, and `split_letters` segments by the rules of UAX #29
(GB3-GB13) over properties taken from `unicodedata`: CR / LF / Control from
the general category (Cc, Cf, Zl, Zp, Cs), Extend from Mn / Me with ZWNJ,
the emoji modifiers and the tag characters, SpacingMark from Mc, Hangul
L / V / T / LV / LVT by code point arithmetic, the regional indicators,
and a short list of Prepend characters. Combining marks, Hangul syllables,
emoji ZWJ sequences and flags cluster as `\\X` clusters them. Not covered:
  * Extended_Pictographic (rule GB11, emoji joined by ZWJ) is taken as
    the general category So and the unassigned code points of the emoji
    planes, so a ZWJ between two pictographs of another category (such as
    U+203C, Po) breaks where `\\X` does not;
  * the Indic conjunct rule GB9c (Unicode 15.1) is not applied: a
    consonant after a virama starts a new cluster;
  * properties follow Python's `unicodedata` version, which can lag the
    `regex` package's.
"""

from __future__ import annotations

import re
import unicodedata
from typing import List

_BRACKETED = re.compile(r"[<\[][^>\]]*[>\]]")
_PARENTHESIZED = re.compile(r"\(([^)]+?)\)")
_WHITESPACE = re.compile(r"\s+")

# non-ASCII letters that NFKD does not decompose to base letters
ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}

# Unicode major categories replaced by a space: Marks, Symbols, Punctuation
_SPACED_CATEGORIES = frozenset("MSP")


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Drop diacritics (Mn) and replace marks/symbols/punctuation with a
    space, after NFKD decomposition."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in ADDITIONAL_DIACRITICS:
            out.append(ADDITIONAL_DIACRITICS[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue
            out.append(" " if cat[0] in _SPACED_CATEGORIES else c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """Replace marks/symbols/punctuation with a space, keeping diacritics."""
    chars = (
        " " if unicodedata.category(c)[0] in _SPACED_CATEGORIES else c
        for c in unicodedata.normalize("NFKC", s)
    )
    return "".join(chars)


# --- extended grapheme clusters (UAX #29) without the regex package --------

_ZWJ, _ZWNJ = 0x200D, 0x200C
# Prepended_Concatenation_Mark and the Indic Prepend characters
_PREPEND = frozenset([0x0600, 0x0601, 0x0602, 0x0603, 0x0604, 0x0605, 0x06DD, 0x070F, 0x0890, 0x0891, 0x08E2,
                      0x0D4E, 0x110BD, 0x110CD, 0x111C2, 0x111C3, 0x1193F, 0x11941, 0x11A3A, 0x11A84, 0x11A85,
                      0x11A86, 0x11A87, 0x11A88, 0x11A89, 0x11D46, 0x11F02])


def _break_class(c: str) -> str:
    """The Grapheme_Cluster_Break class of one character (and "XP" for an
    Extended_Pictographic one), from `unicodedata`."""
    cp = ord(c)
    if c == "\r":
        return "CR"
    if c == "\n":
        return "LF"
    if cp == _ZWJ:
        return "ZWJ"
    if 0x1F1E6 <= cp <= 0x1F1FF:
        return "RI"
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    if cp in _PREPEND:
        return "Prepend"
    if cp == _ZWNJ or 0xFF9E <= cp <= 0xFF9F or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F:
        return "Extend"
    cat = unicodedata.category(c)
    if cat in ("Mn", "Me"):
        return "Extend"
    if cat == "Mc" or cp in (0x0E33, 0x0EB3):
        return "SpacingMark"
    if cat in ("Cc", "Cf", "Zl", "Zp", "Cs"):
        return "Control"
    if cat == "So" or (cat == "Cn" and (0x1F000 <= cp <= 0x1FAFF or 0x1FC00 <= cp <= 0x1FFFD)):
        return "XP"
    return "Other"


def _is_break(prev: str, cur: str, ri_run: int, emoji_zwj: bool) -> bool:
    """Whether a cluster boundary lies between characters of classes `prev`
    and `cur`. `ri_run`: regional indicators ending at prev; `emoji_zwj`:
    the text before cur ends in XP Extend* ZWJ."""
    if prev == "CR" and cur == "LF":  # GB3
        return False
    if prev in ("Control", "CR", "LF") or cur in ("Control", "CR", "LF"):  # GB4, GB5
        return True
    if prev == "L" and cur in ("L", "V", "LV", "LVT"):  # GB6
        return False
    if prev in ("LV", "V") and cur in ("V", "T"):  # GB7
        return False
    if prev in ("LVT", "T") and cur == "T":  # GB8
        return False
    if cur in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":  # GB9, GB9a, GB9b
        return False
    if emoji_zwj and cur == "XP":  # GB11
        return False
    if prev == "RI" and cur == "RI":  # GB12, GB13
        return ri_run % 2 == 0
    return True  # GB999


def split_graphemes(s: str) -> List[str]:
    """`s` split into extended grapheme clusters (UAX #29, see the module docstring)."""
    out: List[str] = []
    prev = None
    ri_run = 0
    xp_extend = False  # the text so far ends in XP Extend*
    emoji_zwj = False  # ... or in XP Extend* ZWJ
    for c in s:
        cur = _break_class(c)
        if prev is None or _is_break(prev, cur, ri_run, emoji_zwj):
            out.append(c)
        else:
            out[-1] += c
        ri_run = ri_run + 1 if cur == "RI" else 0
        emoji_zwj = xp_extend and cur == "ZWJ"
        xp_extend = cur == "XP" or (xp_extend and cur == "Extend")
        prev = cur
    return out


class BasicTextNormalizer:
    def __init__(self, remove_diacritics: bool = False, split_letters: bool = False):
        self.clean = remove_symbols_and_diacritics if remove_diacritics else remove_symbols
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = _BRACKETED.sub("", s.lower())  # drop bracketed annotations
        s = _PARENTHESIZED.sub("", s)  # drop parenthesized asides
        s = self.clean(s).lower()
        if self.split_letters:
            s = " ".join(split_graphemes(s))
        return _WHITESPACE.sub(" ", s)
