"""Word-level timestamps from the cross-attention alignment.

Counterpart of `asr_ttl_mtl_tpu/timing.py` (`find_alignment` :77-151,
`_word_timings_from_path` :154-191, the punctuation merges and edge
heuristics :467-591, `add_word_timestamps` :592-638). The window's tokens
are teacher-forced through a fresh encoder pass of its mel; the decoder
returns the fp32 pre-softmax cross-attention logits of the alignment heads
(`decoder_apply(return_cross_qk=True)`); the frames past the window's
content are masked before a softmax over audio time; the weights are
standardized across tokens (biased std), median-filtered along frames and
averaged over heads; DTW over the negated matrix gives each token's first
frame.

On the card, as on the TPU in the JAX package, the weights stay on the
device in fp32: standardization, the median filter K11, the head mean and
the DTW fill K13 run there, and only K13's int8 trace leaves the card for
the backtrace. On the CPU the same steps run in float64 on the host with
the sort median and the float64 DTW sweep, as JAX's non-TPU branch does.

`find_alignment_batch` (JAX :189-458) is the words mode of
`transcribe_batch`: one teacher-forced forward over a chunk of windows
(or over the encoder features the decode kept), masked per row, with the
standardization, the median filter and the head mean in fp32 on the
model's device, and the teacher-forced probabilities from the chunked
cross-entropy. On the card K12 fills every row's DTW and walks it there,
and only the (B, L) path indices come back.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np
import torch

from .audio import HOP_LENGTH, SAMPLE_RATE, TOKENS_PER_SECOND
from .models.whisper import decoder_apply, encoder_apply
from .ops.chunked_xent import chunked_softmax_xent
from .ops.dtw import dtw, dtw_paths_collect, dtw_paths_dispatch
from .ops.median import median_filter, median_filter_network
from .tokenizer import Tokenizer

if TYPE_CHECKING:
    from .models.registry import WhisperModel


@dataclass
class WordTiming:
    word: str
    tokens: List[int]
    start: float
    end: float
    probability: float


def _softmax_np(x: np.ndarray) -> np.ndarray:
    x = x - x.max(axis=-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=-1, keepdims=True)


@torch.no_grad()
def alignment_weights(
    model: "WhisperModel", tokens: List[int], mel: torch.Tensor, num_frames: int, qk_scale: float = 1.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Teacher-force `tokens` over a fresh encoder pass of `mel` (n_mels,
    frames) and return (logits (T, n_vocab) fp32, the alignment heads'
    softmax over audio time (heads, T, Ta) fp32), frames at and past
    `num_frames // 2` masked to -inf after the `qk_scale` multiply."""
    dev = model.device
    mel = torch.as_tensor(mel, device=dev)
    if mel.dim() == 2:
        mel = mel[None]
    pairs = tuple((int(l), int(h)) for l, h in np.argwhere(model.alignment_heads))
    feats = encoder_apply(model.encoder, mel, model.compute_dtype)
    logits, _, cross_qk = decoder_apply(
        model.decoder, torch.tensor([tokens], device=dev), feats, compute_dtype=model.compute_dtype,
        return_cross_qk=True, cross_qk_pairs=pairs,
    )
    weights = cross_qk[:, 0]  # (heads, T, Ta)
    frames = torch.arange(weights.shape[-1], device=dev)
    weights = torch.where(frames < num_frames // 2, weights * qk_scale, float("-inf"))
    return logits[0], torch.softmax(weights, dim=-1)


def alignment_path(weights: torch.Tensor, n_frames: int, n_sot: int, medfilt_width: int):
    """(text_indices, time_indices) of the DTW path through the alignment
    heads' weights (heads, T, Ta): cut to `n_frames` frames, standardize
    across tokens, median-filter along frames, average the heads, drop the
    first `n_sot` rows and the last, and align the negated matrix. A CUDA
    tensor stays on the card in fp32 (K11, K13); anything else goes to the
    host in float64."""
    if weights.is_cuda:
        w = weights.float()[:, :, :n_frames]
        mean = w.mean(dim=-2, keepdim=True)
        std = w.std(dim=-2, keepdim=True, correction=0)
        matrix = median_filter_network((w - mean) / std, medfilt_width).mean(dim=0)
        return dtw(-matrix[n_sot:-1])
    w = weights.cpu().numpy().astype(np.float64)[:, :, :n_frames]
    mean = w.mean(axis=-2, keepdims=True)
    std = w.std(axis=-2, keepdims=True)
    # a zero-variance column gives NaN, as the reference's standardization does
    with np.errstate(invalid="ignore", divide="ignore"):
        w = (w - mean) / std
    matrix = median_filter(w, medfilt_width).mean(axis=0)
    return dtw(-matrix[n_sot:-1])


def find_alignment(
    model: "WhisperModel",
    tokenizer: Tokenizer,
    text_tokens: List[int],
    mel: torch.Tensor,
    num_frames: int,
    *,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
) -> List[WordTiming]:
    """Word timings of `text_tokens` in the window `mel` with `num_frames`
    frames of content."""
    if len(text_tokens) == 0:
        return []
    tokens = [*tokenizer.sot_sequence, tokenizer.no_timestamps, *text_tokens, tokenizer.eot]
    logits, weights = alignment_weights(model, tokens, mel, num_frames, qk_scale)

    sampled_logits = logits.cpu().numpy()[len(tokenizer.sot_sequence) :, : tokenizer.eot]
    token_probs = _softmax_np(sampled_logits)
    text_token_probs = token_probs[np.arange(len(text_tokens)), text_tokens].tolist()

    text_indices, time_indices = alignment_path(weights, num_frames // 2, len(tokenizer.sot_sequence), medfilt_width)
    return _word_timings_from_path(tokenizer, list(text_tokens), text_indices, time_indices, text_token_probs)


def _word_timings_from_path(
    tokenizer: Tokenizer,
    text_tokens: List[int],
    text_indices: np.ndarray,
    time_indices: np.ndarray,
    text_token_probs: List[float],
) -> List[WordTiming]:
    """DTW path -> per-word extents."""
    words, word_tokens = tokenizer.split_to_word_tokens(text_tokens + [tokenizer.eot])
    if len(word_tokens) <= 1:
        # a lone EOT "word" leaves nothing to time
        return []

    # first DTW frame of each text token, then word extents from the token
    # count prefix sums ([0, c0, c0+c1, ...]; the EOT pseudo-word closes the
    # last real word)
    entered_token = np.diff(text_indices, prepend=-1).astype(bool)
    token_start_times = time_indices[entered_token] / TOKENS_PER_SECOND
    edges = np.concatenate([[0], np.cumsum([len(t) for t in word_tokens[:-1]])])

    return [
        WordTiming(word, tokens_, start=token_start_times[lo], end=token_start_times[hi],
                   probability=float(np.mean(text_token_probs[lo:hi])))
        for word, tokens_, lo, hi in zip(words, word_tokens, edges[:-1], edges[1:])
    ]


_TOKEN_BUCKETS = (64, 128, 192, 256, 320, 384, 448)


def median_filter_rows(w: torch.Tensor, frame_lens: torch.Tensor, width: int) -> torch.Tensor:
    """Median filter of w (B, T, Ta) along frames, each row b reflecting at 0
    and at its own frame_lens[b] - 1 (the reflect pad `median_filter`
    applies after cropping), by a gather of the `width` window elements and a
    sort, which puts NaN last as `jnp.sort` does (JAX timing.py:259-277). Rows
    with frame_lens <= width // 2 pass through unfiltered."""
    half = width // 2
    n_audio = w.shape[-1]
    dev = w.device
    t = torch.arange(n_audio, device=dev)[None, :, None]
    j = torch.arange(width, device=dev)[None, None, :]
    raw = (t + j - half).abs()  # reflect at 0
    hi = (frame_lens[:, None, None] - 1).clamp(min=0)
    raw = torch.where(raw > hi, 2 * hi - raw, raw)  # reflect at frame_len - 1
    idx = raw.clamp(0, n_audio - 1)  # (B, Ta, width)
    b, n_tok = w.shape[:2]
    idx = idx.reshape(b, 1, n_audio * width).expand(b, n_tok, n_audio * width)
    win = w.gather(-1, idx).reshape(b, n_tok, n_audio, width)
    filt = torch.sort(win, dim=-1).values[..., half]
    return torch.where((frame_lens > half)[:, None, None], filt, w)


@torch.no_grad()
def alignment_forward_batch(
    model: "WhisperModel",
    fwd_input: torch.Tensor,
    tokens: torch.Tensor,
    frame_lens: torch.Tensor,
    row_lens: torch.Tensor,
    *,
    eot: int,
    medfilt_width: int,
    qk_scale: float = 1.0,
    from_features: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched teacher-forced alignment forward (JAX
    `_build_alignment_forward_batch`, timing.py:193-299): window mels (B,
    n_mels, 3000), or with `from_features` the decode's encoder features (B,
    n_audio_ctx, D), and token rows (B, bucket) padded with EOT ->
    (the head-averaged DTW cost matrix before negation (B, bucket, Ta) fp32,
    the probability each position gives its teacher-forced next token over
    the text vocabulary (B, bucket) fp32). Frames at and past frame_lens[b]
    are masked before the softmax; each frame column is standardized over
    the row's row_lens[b] real tokens (a zero-variance column divides to
    NaN, as in the reference); the median filter reflects at each row's
    last frame and runs head by head to bound its (B, T, Ta, width)
    transient."""
    dt = model.compute_dtype
    head_pairs = tuple((int(l), int(h)) for l, h in np.argwhere(model.alignment_heads))
    if from_features:
        feats = fwd_input.to(dt)
    else:
        feats = encoder_apply(model.encoder, fwd_input, dt)
    hidden, _, weights = decoder_apply(
        model.decoder, tokens, feats, compute_dtype=dt, return_cross_qk=True, return_hidden=True,
        cross_qk_pairs=head_pairs,
    )  # weights (n_sel, B, T, Ta) fp32
    dev = weights.device
    n_audio = weights.shape[-1]
    frame_ok = torch.arange(n_audio, device=dev)[None, :] < frame_lens[:, None]
    weights = torch.where(frame_ok[None, :, None, :], weights * qk_scale, float("-inf"))
    weights = torch.softmax(weights, dim=-1)

    tok_ok = (torch.arange(weights.shape[-2], device=dev)[None, :] < row_lens[:, None])[None, :, :, None]
    cnt = row_lens.float()[None, :, None, None]
    mean = torch.where(tok_ok, weights, 0.0).sum(dim=-2, keepdim=True) / cnt
    var = torch.where(tok_ok, (weights - mean) ** 2, 0.0).sum(dim=-2, keepdim=True) / cnt
    w = (weights - mean) / torch.sqrt(var)
    matrix = torch.stack([median_filter_rows(wh, frame_lens, medfilt_width) for wh in w]).mean(dim=0)

    tgt = torch.clamp(torch.roll(tokens, -1, dims=1), max=eot - 1)  # the last column is junk
    nll, _ = chunked_softmax_xent(hidden, model.decoder.token_embedding.weight[:eot], tgt, ignore_index=-1)
    return matrix, torch.exp(-nll)


def find_alignment_batch(
    model: "WhisperModel",
    tokenizer: Tokenizer,
    token_lists: List[List[int]],
    mels,
    num_frames_list: List[int],
    *,
    medfilt_width: int = 7,
    qk_scale: float = 1.0,
    batch_size: Optional[int] = None,
    use_device_dtw: Optional[bool] = None,
    features=None,
) -> List[List[WordTiming]]:
    """Word timings of many 30 s windows at once (JAX timing.py:302-458):
    window i has text tokens token_lists[i], mel mels[i] (n_mels, 3000) and
    num_frames_list[i] frames of content. Token rows share one bucket of
    `_TOKEN_BUCKETS`; windows go through `alignment_forward_batch` in chunks
    of `batch_size`, the last padded by repeating its final row. With
    `features` (an object whose `gather(indices)` returns the decode's
    encoder features of those windows) the forward skips its encoder.

    `use_device_dtw` None: K12 on the card, and on the CPU the host walk of
    the matrices in float64 (JAX's non-TPU branch); True on the CPU takes
    K12's plain version, as JAX's "interpret" does. With K12, chunk c's path
    fetch and word assembly overlap chunk c+1's forward (depth 2). A K12
    failure raises: there is no host walk to fall back to."""
    sot_len = len(tokenizer.sot_sequence)
    rows = [[*tokenizer.sot_sequence, tokenizer.no_timestamps, *txt, tokenizer.eot] for txt in token_lists]
    out: List[List[WordTiming]] = [[] for _ in token_lists]
    live = [i for i, txt in enumerate(token_lists) if len(txt) > 0]
    if not live:
        return out

    longest = max(len(rows[i]) for i in live)
    bucket = next((b for b in _TOKEN_BUCKETS if b >= longest), longest)  # one bucket for every chunk
    chunk = max(1, int(batch_size)) if batch_size else len(live)
    dev = model.device
    if use_device_dtw is None:
        use_device_dtw = dev.type == "cuda"

    def words(i, text_indices, time_indices, picked_row):
        probs = picked_row[sot_len : sot_len + len(token_lists[i])].tolist()
        out[i] = _word_timings_from_path(tokenizer, list(token_lists[i]), text_indices, time_indices, probs)

    pending: List[tuple] = []  # (part, K12's handles or the matrices, picked)

    def drain_one():
        part, handles, picked = pending.pop(0)
        picked = picked.cpu().numpy()
        if use_device_dtw:
            for r, (i, path) in enumerate(zip(part, dtw_paths_collect(handles))):
                words(i, *path, picked[r])
            return
        matrices = handles.cpu().numpy().astype(np.float64)
        for r, i in enumerate(part):
            matrix = matrices[r, : len(rows[i]), : num_frames_list[i] // 2][sot_len:-1]
            words(i, *dtw(-matrix), picked[r])

    for c0 in range(0, len(live), chunk):
        part = live[c0 : c0 + chunk]
        pad = chunk - len(part) if len(live) > chunk else 0
        idx = part + [part[-1]] * pad
        tokens = np.full((len(idx), bucket), tokenizer.eot, np.int64)
        for r, i in enumerate(idx):
            tokens[r, : len(rows[i])] = rows[i]
        frame_lens = [num_frames_list[i] // 2 for i in idx]
        row_lens = [len(rows[i]) for i in idx]
        if features is not None:
            fwd_input = features.gather(idx)
        else:
            fwd_input = torch.as_tensor(mels)[torch.as_tensor(idx)].to(dev)
        matrices, picked = alignment_forward_batch(
            model, fwd_input, torch.from_numpy(tokens).to(dev), torch.tensor(frame_lens, device=dev),
            torch.tensor(row_lens, device=dev), eot=tokenizer.eot, medfilt_width=medfilt_width, qk_scale=qk_scale,
            from_features=features is not None,
        )
        if use_device_dtw:
            # the SOT rows sliced off and the matrices negated on the device;
            # each row's EOT row and the bucket's padding lie below its n
            handles = dtw_paths_dispatch(-matrices[:, sot_len:, :], [n - sot_len - 1 for n in row_lens], frame_lens)
        else:
            handles = matrices
        pending.append((part, handles, picked))
        if len(pending) >= 2:
            drain_one()
    while pending:
        drain_one()
    return out


def _absorb_opening_punct(alignment: List[WordTiming], marks: str) -> None:
    """Right-to-left sweep: a floating opening mark (a word like ' "' whose
    stripped text is in ``marks``) glues onto the word after it. Chains of
    marks gather onto the same anchor; emptied entries stay in place so the
    token accounting per segment holds."""
    anchor: Optional[WordTiming] = None
    for entry in reversed(alignment):
        is_mark = entry.word.startswith(" ") and entry.word.strip() in marks
        if anchor is not None and is_mark:
            anchor.word = entry.word + anchor.word
            anchor.tokens = entry.tokens + anchor.tokens
            entry.word, entry.tokens = "", []
        else:
            anchor = entry


def _absorb_closing_punct(alignment: List[WordTiming], marks: str) -> None:
    """Left-to-right sweep: a closing mark glues onto the word before it,
    unless that word ends with a space (the mark then starts its own word)."""
    anchor: Optional[WordTiming] = None
    for entry in alignment:
        if anchor is not None and entry.word in marks and not anchor.word.endswith(" "):
            anchor.word = anchor.word + entry.word
            anchor.tokens = anchor.tokens + entry.tokens
            entry.word, entry.tokens = "", []
        else:
            anchor = entry


def merge_punctuations(alignment: List[WordTiming], prepended: str, appended: str) -> None:
    _absorb_opening_punct(alignment, prepended)
    _absorb_closing_punct(alignment, appended)


_SENTENCE_ENDS = ".。!！?？"


def _typical_duration(alignment: List[WordTiming]) -> Tuple[float, float, bool]:
    """(median word duration capped at 0.7 s, twice that, whether any word
    has a nonzero duration)."""
    spans = [t.end - t.start for t in alignment if t.end - t.start != 0.0]
    if not spans:
        return 0.0, 0.0, False
    median = min(0.7, float(np.median(spans)))
    return median, median * 2, True


def _shorten_stretched_sentence_ends(alignment: List[WordTiming], ceiling: float) -> None:
    """An overlong word at a sentence boundary usually swallowed silence:
    clip a sentence end to its start side, and the word after one to its
    end side."""
    for before, entry in zip(alignment, alignment[1:]):
        if entry.end - entry.start <= ceiling:
            continue
        if entry.word in _SENTENCE_ENDS:
            entry.end = entry.start + ceiling
        elif before.word in _SENTENCE_ENDS:
            entry.start = entry.end - ceiling


def _pop_segment_words(
    alignment: List[WordTiming], cursor: int, token_budget: int, time_offset: float
) -> Tuple[List[dict], int]:
    """Take the alignment entries covering ``token_budget`` text tokens;
    emptied (merged-away) entries spend their tokens but emit nothing."""
    words: List[dict] = []
    spent = 0
    while cursor < len(alignment) and spent < token_budget:
        entry = alignment[cursor]
        if entry.word:
            words.append(dict(
                word=entry.word,
                start=round(time_offset + entry.start, 2),
                end=round(time_offset + entry.end, 2),
                probability=entry.probability,
            ))
        spent += len(entry.tokens)
        cursor += 1
    return words, cursor


def _snap_segment_edges(
    segment: dict, words: List[dict], *, median: float, ceiling: float, last_speech_timestamp: float
) -> float:
    """Reconcile the word and segment timestamps at the segment's edges;
    returns the new end of speech."""
    first, last = words[0], words[-1]

    # a first word stranded long after the previous speech and stretched
    # past the ceiling is an alignment artefact: pull its start in
    stranded = first["end"] - last_speech_timestamp > median * 4
    stretched = first["end"] - first["start"] > ceiling or (
        len(words) > 1 and words[1]["end"] - first["start"] > ceiling * 2
    )
    if stranded and stretched:
        if len(words) > 1 and words[1]["end"] - words[1]["start"] > ceiling:
            boundary = max(words[1]["end"] / 2, words[1]["end"] - ceiling)
            first["end"] = words[1]["start"] = boundary
        first["start"] = max(0, first["end"] - ceiling)

    # prefer the segment's timestamp where the edge word reaches too far
    # outside the segment; otherwise the word sets the segment's edge
    if segment["start"] < first["end"] and segment["start"] - 0.5 > first["start"]:
        first["start"] = max(0, min(first["end"] - median, segment["start"]))
    else:
        segment["start"] = first["start"]

    if segment["end"] > last["start"] and segment["end"] + 0.5 < last["end"]:
        last["end"] = max(last["start"] + median, segment["end"])
    else:
        segment["end"] = last["end"]

    return segment["end"]


def add_word_timestamps(
    *,
    segments: List[dict],
    model: "WhisperModel",
    tokenizer: Tokenizer,
    mel: torch.Tensor,
    num_frames: int,
    prepend_punctuations: str = "\"'“¿([{-",
    append_punctuations: str = "\"'.。,，!！?？:：”)]}、",
    last_speech_timestamp: float,
    alignment: Optional[List[WordTiming]] = None,
    **kwargs,
) -> None:
    """Give each segment of one window its `words` (and snap its edges to
    them). ``alignment`` replaces the window's forward with one computed
    elsewhere."""
    if len(segments) == 0:
        return

    tokens_per_segment = [[token for token in segment["tokens"] if token < tokenizer.eot] for segment in segments]
    if alignment is None:
        all_text_tokens = list(itertools.chain.from_iterable(tokens_per_segment))
        alignment = find_alignment(model, tokenizer, all_text_tokens, mel, num_frames, **kwargs)

    median, ceiling, have_spans = _typical_duration(alignment)
    if have_spans:
        _shorten_stretched_sentence_ends(alignment, ceiling)
    merge_punctuations(alignment, prepend_punctuations, append_punctuations)

    time_offset = segments[0]["seek"] * HOP_LENGTH / SAMPLE_RATE
    cursor = 0
    for segment, seg_tokens in zip(segments, tokens_per_segment):
        words, cursor = _pop_segment_words(alignment, cursor, len(seg_tokens), time_offset)
        if words:
            last_speech_timestamp = _snap_segment_edges(
                segment, words, median=median, ceiling=ceiling, last_speech_timestamp=last_speech_timestamp,
            )
        segment["words"] = words
