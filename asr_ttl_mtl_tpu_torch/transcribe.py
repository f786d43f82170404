"""Long-form transcription: the sequential seek loop over 30 s windows.

Counterpart of `transcribe` in `asr_ttl_mtl_tpu/transcribe.py` (:54-177,
:265-499): 30 s of silence padding, seek-pointer windowing, the
temperature-fallback ladder with `QualityGates`, the no-speech skip,
consecutive-timestamp segment splitting, prompt conditioning
(`condition_on_previous_text`, `carry_initial_prompt`) and
`clip_timestamps` windows. Every window decode is one `DecodingTask` run
(beam search on the t=0 rung with `beam_size`, best-of sampling above).
With `word_timestamps`, each window's segments get their words
(`timing.add_word_timestamps`) and the seek resumes after the last word;
`hallucination_silence_threshold` then skips silences around segments
that look hallucinated (JAX `transcribe.py:188-257, :414-468`).

The mel of the whole file is computed once, on the model's device, and the
windows are cut from it there. `transcribe_batch` belongs to a later slice.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Tuple, Union

import numpy as np
import torch

from .audio import FRAMES_PER_SECOND, HOP_LENGTH, N_FRAMES, N_SAMPLES, SAMPLE_RATE, log_mel_spectrogram, pad_or_trim
from .decoding import DecodingOptions, DecodingResult
from .timing import add_word_timestamps
from .tokenizer import LANGUAGES, get_tokenizer, normalize_language
from .utils import exact_div, format_timestamp, get_end, make_safe

if TYPE_CHECKING:
    from .models.registry import WhisperModel

_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"


def _frames_to_sec(frames) -> float:
    """Mel frames -> seconds (one frame = HOP_LENGTH/SAMPLE_RATE = 10 ms)."""
    return float(frames * HOP_LENGTH / SAMPLE_RATE)


def _sec_to_frames(seconds) -> int:
    return round(seconds * FRAMES_PER_SECOND)


# ---------------------------------------------------------------------------
# quality gates + temperature ladder
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QualityGates:
    """Acceptance thresholds applied to each window's decode result.

    ``None`` disables a gate. A window is *degenerate* (retry hotter) when its
    text compresses too well (repetition loop) or scores too low a mean
    logprob, unless the no-speech detector is confident the window is
    silence, which overrides both. A window is *silent* (skip entirely) when
    no-speech probability clears its threshold and the logprob gate does not
    vouch for the text.
    """

    compression_ratio: Optional[float] = 2.4
    logprob: Optional[float] = -1.0
    no_speech: Optional[float] = 0.6

    def degenerate(self, result: DecodingResult) -> bool:
        repetitive = self.compression_ratio is not None and result.compression_ratio > self.compression_ratio
        improbable = self.logprob is not None and result.avg_logprob < self.logprob
        if improbable and self.no_speech is not None and result.no_speech_prob > self.no_speech:
            return False  # confident silence: accept the window as-is
        return repetitive or improbable

    def silent_window(self, result: DecodingResult) -> bool:
        if self.no_speech is None or result.no_speech_prob <= self.no_speech:
            return False
        # a passing logprob vouches for the decoded text despite no-speech
        return not (self.logprob is not None and result.avg_logprob > self.logprob)


def options_at_temperature(decode_options: dict, t: float) -> DecodingOptions:
    """One rung of the ladder: beam search only at t==0, sampling candidates
    only at t>0."""
    opts = dict(decode_options)
    for key in ("beam_size", "patience") if t > 0 else ("best_of",):
        opts.pop(key, None)
    opts["temperature"] = t
    return DecodingOptions(**opts)


def _as_ladder(temperature: Union[float, Tuple[float, ...]]) -> Tuple[float, ...]:
    if isinstance(temperature, (int, float)):
        return (float(temperature),)
    return tuple(temperature)


# ---------------------------------------------------------------------------
# window token run -> segments
# ---------------------------------------------------------------------------


def _cut_segments(
    tokens: np.ndarray,
    tokenizer,
    *,
    time_offset: float,
    time_precision: float,
    segment_duration: float,
    segment_size: int,
    input_stride: int,
    make,
) -> Tuple[List[dict], int, bool]:
    """Split a window's token run into segments at consecutive-timestamp cuts.

    Returns (segments, frames_to_advance, single_timestamp_ending). ``make``
    builds one segment dict from (start, end, tokens).
    """
    stamp = np.asarray(tokens >= tokenizer.timestamp_begin)
    single_ending = len(tokens) >= 2 and bool(stamp[-1]) and not bool(stamp[-2])
    pos = lambda tok: int(tok) - tokenizer.timestamp_begin  # noqa: E731

    cuts = [i for i in range(1, len(tokens)) if stamp[i] and stamp[i - 1]]
    if cuts:
        bounds = cuts + [len(tokens)] if single_ending else cuts
        segments = [
            make(
                start=time_offset + pos(tokens[lo]) * time_precision,
                end=time_offset + pos(tokens[hi - 1]) * time_precision,
                tokens=tokens[lo:hi],
            )
            for lo, hi in zip([0] + bounds[:-1], bounds)
        ]
        if single_ending:
            advance = segment_size  # trailing silence: skip the whole window
        else:
            advance = pos(tokens[bounds[-1] - 1]) * input_stride
        return segments, advance, single_ending

    # no closed timestamp pair: one segment spanning to the last stamp (if any)
    duration = segment_duration
    stamps = tokens[stamp.nonzero()[0]]
    if len(stamps) and pos(stamps[-1]) != 0:
        duration = pos(stamps[-1]) * time_precision
    only = make(start=time_offset, end=time_offset + duration, tokens=tokens)
    return [only], segment_size, single_ending


def _build_segment(tokenizer, *, seek, start, end, tokens, result) -> dict:
    ids = [int(t) for t in tokens]
    return {
        "seek": seek,
        "start": start,
        "end": end,
        "text": tokenizer.decode([t for t in ids if t < tokenizer.eot]),
        "tokens": ids,
        "temperature": result.temperature,
        "avg_logprob": result.avg_logprob,
        "compression_ratio": result.compression_ratio,
        "no_speech_prob": result.no_speech_prob,
    }


# ---------------------------------------------------------------------------
# hallucination heuristics
# ---------------------------------------------------------------------------


def _anomaly_score(word: dict) -> float:
    """Penalty for an implausible word: low probability, or a duration far
    from the plausible band (too brief weighted 15x, too drawn out 1x)."""
    duration = word["end"] - word["start"]
    return (
        (1.0 if word.get("probability", 0.0) < 0.15 else 0.0)
        + max(0.0, 0.133 - duration) * 15
        + max(0.0, duration - 2.0)
    )


def _is_hallucination(segment: Optional[dict]) -> bool:
    """A segment looks hallucinated when its first (up to 8) words that are
    not punctuation are anomalous together: a total penalty of 3 or more, or
    about one point a word."""
    if segment is None or not segment["words"]:
        return False
    words = [w for w in segment["words"] if w["word"] not in _PUNCTUATION][:8]
    score = sum(_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def _first_with_words(segments: List[dict]) -> Optional[dict]:
    return next((s for s in segments if s["words"]), None)


def _drop_hallucinated_tail(
    segments: List[dict],
    *,
    threshold: float,
    time_offset: float,
    window_end_time: float,
    segment_duration: float,
    content_duration: float,
    content_frames: int,
    last_speech_timestamp: float,
) -> Optional[int]:
    """Find the first segment that looks hallucinated and has silence (or
    more hallucination) on both sides; cut the list there and return the
    frame to seek to. None: nothing dropped."""
    prev_speech_end = last_speech_timestamp
    for index, segment in enumerate(segments):
        if not segment["words"]:
            continue
        if _is_hallucination(segment):
            following = _first_with_words(segments[index + 1 :])
            next_speech_start = (
                following["words"][0]["start"] if following is not None else time_offset + segment_duration
            )
            quiet_before = (
                segment["start"] - prev_speech_end > threshold
                or segment["start"] < threshold
                or segment["start"] - time_offset < 2.0
            )
            quiet_after = (
                next_speech_start - segment["end"] > threshold
                or _is_hallucination(following)
                or window_end_time - segment["end"] < 2.0
            )
            if quiet_before and quiet_after:
                if content_duration - segment["end"] < threshold:
                    resume_at = content_frames  # a hallucinated coda: stop here
                else:
                    resume_at = _sec_to_frames(max(time_offset + 1, segment["start"]))
                del segments[index:]
                return resume_at
        prev_speech_end = segment["end"]
    return None


def _parse_clip_ranges(clip_timestamps: Union[str, List[float]], content_frames: int) -> List[Tuple[int, int]]:
    """`"start,end,start2,end2,..."` seconds -> [(start_frame, end_frame), ...];
    an unpaired final start runs to the end of the audio."""
    if isinstance(clip_timestamps, str):
        clip_timestamps = [float(t) for t in clip_timestamps.split(",")] if clip_timestamps else []
    edges = [_sec_to_frames(t) for t in clip_timestamps] or [0]
    if len(edges) % 2:
        edges = edges + [content_frames]
    return list(zip(edges[::2], edges[1::2]))


# ---------------------------------------------------------------------------
# the long-form pipeline
# ---------------------------------------------------------------------------


def transcribe(
    model: "WhisperModel",
    audio: Union[str, np.ndarray, torch.Tensor],
    *,
    verbose: Optional[bool] = None,
    temperature: Union[float, Tuple[float, ...]] = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
    compression_ratio_threshold: Optional[float] = 2.4,
    logprob_threshold: Optional[float] = -1.0,
    no_speech_threshold: Optional[float] = 0.6,
    condition_on_previous_text: bool = True,
    initial_prompt: Optional[str] = None,
    carry_initial_prompt: bool = False,
    word_timestamps: bool = False,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    clip_timestamps: Union[str, List[float]] = "0",
    hallucination_silence_threshold: Optional[float] = None,
    **decode_options,
):
    """Transcribe an audio file or waveform; returns {"text", "segments",
    "language"} like the reference API, each segment with its `words` under
    `word_timestamps`."""
    # mel of the whole file on the model's device, plus 30 s of trailing
    # silence for the last window
    mel = log_mel_spectrogram(audio, model.dims.n_mels, padding=N_SAMPLES, device=model.device)
    content_frames = mel.shape[-1] - N_FRAMES
    content_duration = _frames_to_sec(content_frames)

    language = normalize_language(decode_options.get("language"))
    decode_options["language"] = language
    if language is None:
        if model.is_multilingual:
            if verbose:
                print("Detecting language using up to the first 30 seconds...")
            _, probs = model.detect_language(pad_or_trim(mel, N_FRAMES, axis=-1))
            language = max(probs, key=probs.get)
            if verbose is not None:
                print(f"Detected language: {LANGUAGES[language].title()}")
        else:
            language = "en"
        decode_options["language"] = language

    task: str = decode_options.get("task", "transcribe")
    tokenizer = get_tokenizer(
        model.is_multilingual,
        num_languages=model.num_languages,
        language=language,
        task=task,
        include_diseases=model.has_disease_tokens,
    )
    if word_timestamps and task == "translate":
        warnings.warn("Word-level timestamps on translations may not be reliable.")
    gates = QualityGates(
        compression_ratio=compression_ratio_threshold, logprob=logprob_threshold, no_speech=no_speech_threshold
    )
    ladder = _as_ladder(temperature)

    def decode_window(segment: torch.Tensor) -> DecodingResult:
        result = None
        for t in ladder:
            result = model.decode(segment, options_at_temperature(decode_options, t))
            if not gates.degenerate(result):
                break
        return result

    input_stride = exact_div(N_FRAMES, model.dims.n_audio_ctx)  # mel frames / token: 2
    time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE  # 0.02 s per token

    prompt_budget = model.dims.n_text_ctx // 2 - 1
    initial_prompt_tokens: List[int] = (
        tokenizer.encode(" " + initial_prompt.strip()) if initial_prompt is not None else []
    )
    prompt_budget -= len(initial_prompt_tokens)

    all_tokens: List[int] = list(initial_prompt_tokens)
    all_segments: List[dict] = []
    prompt_reset_since = 0
    last_speech_timestamp = 0.0

    for clip_start, clip_end in _parse_clip_ranges(clip_timestamps, content_frames):
        seek = clip_start
        while seek < clip_end:
            time_offset = _frames_to_sec(seek)
            window_end_time = _frames_to_sec(seek + N_FRAMES)
            segment_size = min(N_FRAMES, content_frames - seek, clip_end - seek)
            segment_duration = _frames_to_sec(segment_size)
            mel_segment = pad_or_trim(mel[:, seek : seek + segment_size], N_FRAMES, axis=-1)

            if carry_initial_prompt:
                carried = all_tokens[max(len(initial_prompt_tokens), prompt_reset_since) :]
                decode_options["prompt"] = initial_prompt_tokens + carried[-prompt_budget:]
            else:
                decode_options["prompt"] = all_tokens[prompt_reset_since:]

            result = decode_window(mel_segment)

            if no_speech_threshold is not None and gates.silent_window(result):
                seek += segment_size
                continue

            previous_seek = seek
            tokens = np.asarray(result.tokens)

            def make(start, end, tokens):
                return _build_segment(tokenizer, seek=previous_seek, start=start, end=end, tokens=tokens,
                                      result=result)

            current_segments, advance, single_ending = _cut_segments(
                tokens,
                tokenizer,
                time_offset=time_offset,
                time_precision=time_precision,
                segment_duration=segment_duration,
                segment_size=segment_size,
                input_stride=input_stride,
                make=make,
            )
            seek += advance

            if word_timestamps:
                add_word_timestamps(
                    segments=current_segments,
                    model=model,
                    tokenizer=tokenizer,
                    mel=mel_segment,
                    num_frames=segment_size,
                    prepend_punctuations=prepend_punctuations,
                    append_punctuations=append_punctuations,
                    last_speech_timestamp=last_speech_timestamp,
                )

                if not single_ending:
                    spoken_until = get_end(current_segments)
                    if spoken_until is not None and spoken_until > time_offset:
                        seek = _sec_to_frames(spoken_until)  # resume right after the last word

                if hallucination_silence_threshold is not None:
                    threshold = hallucination_silence_threshold
                    if not single_ending:
                        spoken_until = get_end(current_segments)
                        if spoken_until is not None and spoken_until > time_offset:
                            if window_end_time - spoken_until > threshold:
                                seek = _sec_to_frames(spoken_until)
                            else:
                                seek = previous_seek + segment_size

                    # a hallucination-like opener after leading silence:
                    # decode again from where the speech starts
                    leading = _first_with_words(current_segments)
                    if leading is not None and _is_hallucination(leading):
                        gap = leading["start"] - time_offset
                        if gap > threshold:
                            seek = previous_seek + _sec_to_frames(gap)
                            continue

                    resume_at = _drop_hallucinated_tail(
                        current_segments,
                        threshold=threshold,
                        time_offset=time_offset,
                        window_end_time=window_end_time,
                        segment_duration=segment_duration,
                        content_duration=content_duration,
                        content_frames=content_frames,
                        last_speech_timestamp=last_speech_timestamp,
                    )
                    if resume_at is not None:
                        seek = resume_at

                spoken_until = get_end(current_segments)
                if spoken_until is not None:
                    last_speech_timestamp = spoken_until

            if verbose:
                for segment in current_segments:
                    line = (f"[{format_timestamp(segment['start'])} --> {format_timestamp(segment['end'])}] "
                            f"{segment['text']}")
                    print(make_safe(line))

            # blank out instantaneous / textless segments
            for segment in current_segments:
                if segment["start"] == segment["end"] or not segment["text"].strip():
                    segment["text"] = ""
                    segment["tokens"] = []
                    segment["words"] = []

            for segment in current_segments:
                all_segments.append({"id": len(all_segments), **segment})
                all_tokens.extend(segment["tokens"])

            if not condition_on_previous_text or result.temperature > 0.5:
                # hot decodes make unreliable prompts
                prompt_reset_since = len(all_tokens)

            if verbose is False:
                print(f"{min(content_frames, seek)}/{content_frames} frames", flush=True)

    return dict(
        text=tokenizer.decode(all_tokens[len(initial_prompt_tokens) :]),
        segments=all_segments,
        language=language,
    )
