"""Transcript output writers: txt / vtt / srt / tsv / json.

Counterpart of `asr_ttl_mtl_tpu/utils/writers.py`: the same output bytes
for every format and option (tests/test_torch_transcribe.py holds them to
the JAX package's writers). Three stages:

1. **flatten** — segments are lowered to a flat stream of :class:`_Word`
   records carrying timing, the original text (leading whitespace intact),
   and a ``chunk_head`` flag marking segment / max-words-per-line borders;
2. **layout** — a single pass over the stream packs words into *cues*.
   A cue is a list of lines and a line is a list of words: line breaks are
   structural here, not ``"\\n"`` characters smuggled inside word strings;
3. **render** — each output format serializes the cue list (or the raw
   segment list for the word-less formats) into its file syntax.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, replace
from typing import Callable, Iterable, Iterator, List, Optional, TextIO, Tuple

from . import format_timestamp, get_start

# ---------------------------------------------------------------------------
# stage 1: flatten
# ---------------------------------------------------------------------------


@dataclass
class _Word:
    text: str  # verbatim word text; leading whitespace preserved
    start: float
    end: float
    chunk_head: bool  # first word of a segment (or of a max-words slice)


def _flatten_words(segments: List[dict], words_per_chunk: int) -> Iterator[_Word]:
    """Lower the nested segment/word structure to a flat word stream.

    ``chunk_head`` is set on every word whose in-segment index is a multiple
    of ``words_per_chunk`` — i.e. each segment's first word plus each
    max-words-per-line boundary within it.
    """
    for segment in segments:
        # segment["words"] (not .get): a segment missing its word list is a
        # malformed input — the reference's iterate_subtitles raises KeyError
        # too (utils.py:119); silently skipping would drop transcript text
        # from the subtitle output
        for index, word in enumerate(segment["words"]):
            yield _Word(
                text=word["word"],
                start=word["start"],
                end=word["end"],
                chunk_head=index % words_per_chunk == 0,
            )


# ---------------------------------------------------------------------------
# stage 2: layout
# ---------------------------------------------------------------------------

_Cue = List[List[_Word]]  # a cue is a list of lines; a line is a list of words
_PAUSE_SECONDS = 3.0  # silence between word *starts* that forces a cue break


def _layout_cues(
    segments: List[dict],
    *,
    width: int,
    max_lines: Optional[int],
    words_per_chunk: int,
    keep_segments: bool,
) -> Iterator[_Cue]:
    """Pack the word stream into cues under the width / line-count budget.

    Invariants mirroring the reference engine (``utils.py:142-194``):
    a word opens a new line when the current line is non-empty and the word
    does not fit (its whitespace-inclusive length counted for fitting, its
    stripped length for the new line), when a >3 s gap in word starts occurs
    (only in re-flow mode), or at a chunk head (only in segment-preserving
    mode); a new line becomes a new *cue* instead when the open cue already
    holds ``max_lines`` lines, on the same long pause, or at a chunk head.
    """
    closed: List[List[_Word]] = []  # completed lines of the open cue
    line: List[_Word] = []  # words on the open line
    used = 0  # printable budget consumed on the open line
    prev_start = get_start(segments) or 0.0

    for word in _flatten_words(segments, words_per_chunk):
        pause = not keep_segments and word.start - prev_start > _PAUSE_SECONDS
        fits = used + len(word.text) <= width
        boundary = word.chunk_head and keep_segments and bool(line or closed)

        if used > 0 and fits and not pause and not boundary:
            # word continues the open line, whitespace and all
            line.append(word)
            used += len(word.text)
        else:
            bare = replace(word, text=word.text.strip())
            cue_full = (
                bool(line or closed)
                and max_lines is not None
                and (pause or len(closed) + 1 >= max_lines)
            )
            if cue_full or boundary:
                yield closed + [line]
                closed, line = [], [bare]
            elif used > 0:
                closed.append(line)
                line = [bare]
            else:
                # open line held only whitespace-stripped-to-nothing words
                line.append(bare)
            used = len(bare.text.strip())
        prev_start = word.start

    if line or closed:
        yield closed + [line]


def _cue_text(cue: _Cue, underline: Optional[_Word] = None) -> str:
    """Join a cue back into display text, newline per structural line.

    With ``underline`` set, that word (matched by identity) is wrapped in
    ``<u>`` tags after its leading whitespace, for karaoke-style highlights.
    """

    def show(word: _Word) -> str:
        if word is not underline:
            return word.text
        return re.sub(r"^(\s*)(\S.*)?$", lambda m: f"{m.group(1)}<u>{m.group(2) or ''}</u>", word.text)

    return "\n".join("".join(show(w) for w in line) for line in cue)


# ---------------------------------------------------------------------------
# stage 3: render
# ---------------------------------------------------------------------------


class ResultWriter:
    """Writes one transcription result dict next to the audio file's name."""

    extension: str

    def __init__(self, output_dir: str):
        self.output_dir = output_dir

    def __call__(self, result: dict, audio_path: str, options: Optional[dict] = None, **kwargs):
        stem = os.path.splitext(os.path.basename(audio_path))[0]
        output_path = os.path.join(self.output_dir, f"{stem}.{self.extension}")
        with open(output_path, "w", encoding="utf-8") as f:
            self.write_result(result, file=f, options=options, **kwargs)

    def write_result(self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
        raise NotImplementedError


class WriteTXT(ResultWriter):
    extension = "txt"

    def write_result(self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
        for segment in result["segments"]:
            file.write(segment["text"].strip() + "\n")
            file.flush()


def _resolved(kwargs: dict, options: Optional[dict], key: str, default=None):
    """A keyword argument wins over the writer-options dict, which wins over
    the default — the same precedence the reference's iterate_result gives
    its keyword/option pairs."""
    return kwargs.get(key) or (options or {}).get(key) or default


class SubtitlesWriter(ResultWriter):
    always_include_hours: bool
    decimal_marker: str

    def format_timestamp(self, seconds: float) -> str:
        return format_timestamp(
            seconds=seconds,
            always_include_hours=self.always_include_hours,
            decimal_marker=self.decimal_marker,
        )

    def iterate_result(
        self, result: dict, options: Optional[dict] = None, **kwargs
    ) -> Iterator[Tuple[str, str, str]]:
        """Yield (start, end, text) cue tuples in this format's timestamp style."""
        width = _resolved(kwargs, options, "max_line_width")
        count = _resolved(kwargs, options, "max_line_count")
        karaoke = _resolved(kwargs, options, "highlight_words", False)
        per_line = _resolved(kwargs, options, "max_words_per_line")
        stamp = self.format_timestamp

        segments = result["segments"]
        if not (segments and "words" in segments[0]):
            # no word timings available: one cue per segment, verbatim
            for segment in segments:
                text = segment["text"].strip().replace("-->", "->")
                yield stamp(segment["start"]), stamp(segment["end"]), text
            return

        cues = _layout_cues(
            segments,
            width=width or 1000,
            max_lines=count,
            words_per_chunk=per_line or 1000,
            # re-flow across segment borders only when BOTH budgets are given
            keep_segments=count is None or width is None,
        )
        for cue in cues:
            words = [w for line in cue for w in line]
            if not karaoke:
                yield stamp(words[0].start), stamp(words[-1].end), _cue_text(cue)
                continue
            # karaoke mode: one sub-cue per word, plus gap cues between words
            clock = stamp(words[0].start)
            for word in words:
                w_start, w_end = stamp(word.start), stamp(word.end)
                if clock != w_start:
                    yield clock, w_start, _cue_text(cue)
                yield w_start, w_end, _cue_text(cue, underline=word)
                clock = w_end


class WriteVTT(SubtitlesWriter):
    extension, always_include_hours, decimal_marker = "vtt", False, "."

    def write_result(self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
        file.write("WEBVTT\n\n")
        for start, end, text in self.iterate_result(result, options, **kwargs):
            file.write(f"{start} --> {end}\n{text}\n\n")
            file.flush()


class WriteSRT(SubtitlesWriter):
    extension, always_include_hours, decimal_marker = "srt", True, ","

    def write_result(self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
        for i, (start, end, text) in enumerate(self.iterate_result(result, options, **kwargs), 1):
            file.write(f"{i}\n{start} --> {end}\n{text}\n\n")
            file.flush()


class WriteTSV(ResultWriter):
    """start/end in integer milliseconds + text, one row per segment."""

    extension = "tsv"

    def write_result(self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
        file.write("start\tend\ttext\n")
        for segment in result["segments"]:
            row = (
                str(round(1000 * segment["start"])),
                str(round(1000 * segment["end"])),
                segment["text"].strip().replace("\t", " "),
            )
            file.write("\t".join(row) + "\n")
            file.flush()


class WriteJSON(ResultWriter):
    extension = "json"

    def write_result(self, result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
        json.dump(result, file)


_WRITERS = {cls.extension: cls for cls in (WriteTXT, WriteVTT, WriteSRT, WriteTSV, WriteJSON)}


def get_writer(output_format: str, output_dir: str) -> Callable[[dict, TextIO, dict], None]:
    if output_format == "all":
        all_writers = [cls(output_dir) for cls in _WRITERS.values()]

        def write_all(result: dict, file: TextIO, options: Optional[dict] = None, **kwargs):
            for writer in all_writers:
                writer(result, file, options, **kwargs)

        return write_all

    return _WRITERS[output_format](output_dir)
