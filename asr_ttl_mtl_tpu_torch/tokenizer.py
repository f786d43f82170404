"""Whisper tokenizer with the speech-disorder token splice, without tiktoken.

Counterpart of `asr_ttl_mtl_tpu/tokenizer.py`. The special-token layout is
the same (disease tokens spliced into the language block, SURVEY.md §5
item 3):

* multilingual: EOT=50257, SOT=50258, diseases 50359/50360/50361, vocab 51869
* english-only: EOT=50256, SOT=50257, diseases 50358/50359/50360, vocab 51868

The rank tables are the public Whisper `*.tiktoken` files shipped in
`asr_ttl_mtl_tpu/assets/`, read by path (the JAX package is never imported).

`decode` is a byte lookup. `encode` is a plain rank-table BPE (merge the
adjacent pair whose concatenation has the lowest rank until none merges),
which is exact for a text that is ONE pre-token of the GPT-2 pattern: an
optional space followed by characters that are neither whitespace, letters
nor digits, or a run of whitespace. That covers what the greedy window path
encodes (the blank " " and the `non_speech_tokens` symbols). Pre-tokenizing
arbitrary text (prompts, prefixes) belongs to the long-form slice and raises
`NotImplementedError` here.
"""

from __future__ import annotations

import base64
import os
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from typing import Dict, List, Optional, Tuple

# fmt: off
# ISO language codes recognized by Whisper checkpoints, in vocabulary order
# (order defines the special-token IDs)
LANGUAGES = {
    "en": "english", "zh": "chinese", "de": "german", "es": "spanish",
    "ru": "russian", "ko": "korean", "fr": "french", "ja": "japanese",
    "pt": "portuguese", "tr": "turkish", "pl": "polish", "ca": "catalan",
    "nl": "dutch", "ar": "arabic", "sv": "swedish", "it": "italian",
    "id": "indonesian", "hi": "hindi", "fi": "finnish", "vi": "vietnamese",
    "he": "hebrew", "uk": "ukrainian", "el": "greek", "ms": "malay",
    "cs": "czech", "ro": "romanian", "da": "danish", "hu": "hungarian",
    "ta": "tamil", "no": "norwegian", "th": "thai", "ur": "urdu",
    "hr": "croatian", "bg": "bulgarian", "lt": "lithuanian", "la": "latin",
    "mi": "maori", "ml": "malayalam", "cy": "welsh", "sk": "slovak",
    "te": "telugu", "fa": "persian", "lv": "latvian", "bn": "bengali",
    "sr": "serbian", "az": "azerbaijani", "sl": "slovenian", "kn": "kannada",
    "et": "estonian", "mk": "macedonian", "br": "breton", "eu": "basque",
    "is": "icelandic", "hy": "armenian", "ne": "nepali", "mn": "mongolian",
    "bs": "bosnian", "kk": "kazakh", "sq": "albanian", "sw": "swahili",
    "gl": "galician", "mr": "marathi", "pa": "punjabi", "si": "sinhala",
    "km": "khmer", "sn": "shona", "yo": "yoruba", "so": "somali",
    "af": "afrikaans", "oc": "occitan", "ka": "georgian", "be": "belarusian",
    "tg": "tajik", "sd": "sindhi", "gu": "gujarati", "am": "amharic",
    "yi": "yiddish", "lo": "lao", "uz": "uzbek", "fo": "faroese",
    "ht": "haitian creole", "ps": "pashto", "tk": "turkmen", "nn": "nynorsk",
    "mt": "maltese", "sa": "sanskrit", "lb": "luxembourgish", "my": "myanmar",
    "bo": "tibetan", "tl": "tagalog", "mg": "malagasy", "as": "assamese",
    "tt": "tatar", "haw": "hawaiian", "ln": "lingala", "ha": "hausa",
    "ba": "bashkir", "jw": "javanese", "su": "sundanese", "yue": "cantonese",
}
# fmt: on

# speech-disorder classes; order defines the spliced token IDs
DISEASE_CONDITIONS = {"normal": 0, "dysphonia": 1, "dysarthria": 2}

_ALT_LANGUAGE_NAMES = dict(
    burmese="my", valencian="ca", flemish="nl", haitian="ht",
    letzeburgesch="lb", pushto="ps", panjabi="pa", moldavian="ro",
    moldovan="ro", sinhalese="si", castilian="es", mandarin="zh",
)
TO_LANGUAGE_CODE = {
    **{language: code for code, language in LANGUAGES.items()},
    **_ALT_LANGUAGE_NAMES,
}

ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "asr_ttl_mtl_tpu", "assets"
)

# Tokenizer attribute name -> special-token marker text
_MARKERS = {
    "eot": "<|endoftext|>",
    "sot": "<|startoftranscript|>",
    "translate": "<|translate|>",
    "transcribe": "<|transcribe|>",
    "sot_lm": "<|startoflm|>",
    "sot_prev": "<|startofprev|>",
    "no_speech": "<|nospeech|>",
    "no_timestamps": "<|notimestamps|>",
    "timestamp_begin": "<|0.00|>",
}


def normalize_language(language: Optional[str]) -> Optional[str]:
    """Map a language name or code (any case) to its code, or raise."""
    if language is None:
        return None
    lowered = language.lower()
    if lowered in LANGUAGES:
        return lowered
    code = TO_LANGUAGE_CODE.get(lowered)
    if code is None:
        raise ValueError(f"Unsupported language: {language}")
    return code


def _build_special_tokens(num_languages: int, include_diseases: bool) -> List[str]:
    """The ordered special-token list that follows the BPE ranks; the disease
    tokens close the language block, before `<|translate|>`."""
    lang_block = list(LANGUAGES.keys())[:num_languages]
    if include_diseases:
        lang_block = lang_block + list(DISEASE_CONDITIONS.keys())
    controls = "translate transcribe startoflm startofprev nospeech notimestamps"
    return [
        _MARKERS["eot"],
        _MARKERS["sot"],
        *[f"<|{lang}|>" for lang in lang_block],
        *[f"<|{name}|>" for name in controls.split()],
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]


@lru_cache(maxsize=None)
def load_ranks(name: str) -> Dict[bytes, int]:
    """base64 token -> rank, one pair per line of `<name>.tiktoken`."""
    ranks: Dict[bytes, int] = {}
    with open(os.path.join(ASSET_DIR, f"{name}.tiktoken")) as f:
        for line in f:
            if not line.strip():
                continue
            token_b64, rank = line.split()
            ranks[base64.b64decode(token_b64)] = int(rank)
    return ranks


def _is_single_pretoken(text: str) -> bool:
    """Whether `text` is one pre-token of the GPT-2 pattern that the plain
    BPE below encodes exactly: ` ?[^\\s\\p{L}\\p{N}]+` or a whitespace run."""
    if not text:
        return False
    if text.isspace():
        return True
    body = text[1:] if text[0] == " " else text
    return bool(body) and not any(c.isspace() or c.isalpha() or c.isnumeric() for c in body)


@dataclass(eq=False)
class Encoding:
    """Rank table plus special tokens: the part of a tiktoken Encoding that
    the port uses."""

    ranks: Dict[bytes, int]
    special_tokens: Dict[str, int]

    @cached_property
    def n_vocab(self) -> int:
        return len(self.ranks) + len(self.special_tokens)

    @cached_property
    def _id_to_bytes(self) -> Dict[int, bytes]:
        table = {rank: token for token, rank in self.ranks.items()}
        table.update({i: s.encode("utf-8") for s, i in self.special_tokens.items()})
        return table

    def _bpe(self, piece: bytes) -> List[int]:
        if piece in self.ranks:
            return [self.ranks[piece]]
        parts = [piece[i : i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best, best_rank = -1, None
            for i in range(len(parts) - 1):
                rank = self.ranks.get(parts[i] + parts[i + 1])
                if rank is not None and (best_rank is None or rank < best_rank):
                    best, best_rank = i, rank
            if best < 0:
                break
            parts[best : best + 2] = [parts[best] + parts[best + 1]]
        return [self.ranks[p] for p in parts]

    def encode(self, text: str) -> List[int]:
        if not _is_single_pretoken(text):
            raise NotImplementedError(
                "encode of text with several pre-tokens (prompts, prefixes) is not "
                f"ported yet; got {text!r}"
            )
        return self._bpe(text.encode("utf-8"))

    def decode(self, token_ids) -> str:
        table = self._id_to_bytes
        return b"".join(table[int(t)] for t in token_ids).decode("utf-8", errors="replace")


@lru_cache(maxsize=None)
def get_encoding(
    name: str = "gpt2", num_languages: int = 99, include_diseases: bool = False
) -> Encoding:
    ranks = load_ranks(name)
    special_tokens = {
        tok: len(ranks) + i
        for i, tok in enumerate(_build_special_tokens(num_languages, include_diseases))
    }
    return Encoding(ranks=ranks, special_tokens=special_tokens)


@dataclass
class Tokenizer:
    """Rank-table tokenizer with quick access to Whisper special tokens."""

    encoding: Encoding
    num_languages: int
    language: Optional[str] = None
    task: Optional[str] = None
    sot_sequence: Tuple[int, ...] = ()
    special_tokens: Dict[str, int] = field(default_factory=dict)
    disease_conditions: Optional[Dict[str, int]] = None

    def __post_init__(self):
        self.special_tokens.update(self.encoding.special_tokens)
        sot = self.special_tokens[_MARKERS["sot"]]
        seq = [sot]
        if self.language is not None:
            langs = tuple(LANGUAGES.keys())[: self.num_languages]
            seq.append(sot + 1 + langs.index(self.language))
        if self.task is not None:
            seq.append(self.transcribe if self.task == "transcribe" else self.translate)
        self.sot_sequence = tuple(seq)

    def encode(self, text: str) -> List[int]:
        return self.encoding.encode(text)

    def decode(self, token_ids) -> str:
        # timestamp tokens (and anything above) are dropped; other special
        # tokens decode to their literal "<|...|>" text
        return self.encoding.decode([int(t) for t in token_ids if int(t) < self.timestamp_begin])

    def decode_with_timestamps(self, token_ids) -> str:
        return self.encoding.decode([int(t) for t in token_ids])

    def __getattr__(self, name: str) -> int:
        marker = _MARKERS.get(name)
        if marker is None:
            raise AttributeError(name)
        token_id = self.special_tokens[marker]
        setattr(self, name, token_id)
        return token_id

    @cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("This tokenizer does not have language token configured")
        return self.to_language_token(self.language)

    def to_language_token(self, language: str) -> int:
        token = self.special_tokens.get(f"<|{language}|>")
        if token is None:
            raise KeyError(f"Language {language} not found in tokenizer.")
        return token

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        # insertion order truncated to num_languages, as the JAX tokenizer does
        result = [
            token_id
            for token, token_id in self.special_tokens.items()
            if token.strip("<|>") in LANGUAGES
        ]
        return tuple(result[: self.num_languages])

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(self.decode([t]).strip("<|>") for t in self.all_language_tokens)

    @cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @cached_property
    def disease_tokens(self) -> Dict[str, int]:
        """disease name -> spliced special-token id (empty if not configured)"""
        if not self.disease_conditions:
            return {}
        return {
            disease: self.special_tokens[f"<|{disease}|>"]
            for disease in self.disease_conditions
            if f"<|{disease}|>" in self.special_tokens
        }

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Token ids suppressed to avoid speaker tags / non-speech annotations,
        keeping basic punctuation."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += (
            "<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] {{ }} ♪♪ ♪♪♪".split()
        )
        miscellaneous = set("♩♪♫♬♭♮♯")
        assert all(0x2640 <= ord(c) <= 0x267F for c in miscellaneous)

        # allow hyphens and single quotes between words, but not word-initial
        result = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for tokens in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(tokens) == 1 or symbol in miscellaneous:
                    result.add(tokens[0])
        return tuple(sorted(result))


@lru_cache(maxsize=None)
def get_tokenizer(
    multilingual: bool,
    *,
    num_languages: int = 99,
    language: Optional[str] = None,
    task: Optional[str] = None,
    include_diseases: bool = False,
) -> Tokenizer:
    """Build the Whisper tokenizer; with include_diseases the language block
    holds num_languages + 3 entries, which also pulls `yue` into it."""
    language = normalize_language(language)
    if multilingual:
        encoding_name = "multilingual"
        language = language or "en"
        task = task or "transcribe"
    else:
        encoding_name = "gpt2"
        language = None
        task = None

    total_languages = num_languages + (len(DISEASE_CONDITIONS) if include_diseases else 0)
    encoding = get_encoding(
        name=encoding_name, num_languages=total_languages, include_diseases=include_diseases
    )
    return Tokenizer(
        encoding=encoding,
        num_languages=total_languages,
        language=language,
        task=task,
        disease_conditions=dict(DISEASE_CONDITIONS) if include_diseases else None,
    )
