"""Greedy decoding of batched 30-second windows.

Counterpart of `asr_ttl_mtl_tpu/decoding.py`: `DecodingOptions` and
`DecodingResult` (:59-126), the greedy program (:323-452) as a Python loop over steps, language
detection (:524), `MaximumLikelihoodRanker` (:578), and `DecodingTask`
with `run`, `submit` and `collect`. The logit filters and the prompt
buckets, which the beam loop shares, are in `decode_steps.py`.

Errors propagate: there is no retry on the plain paths when a kernel fails.
`submit` enqueues the whole window (encoder, cross-KV, prefill, decode
steps) on the current CUDA stream and returns device tensors; `collect`
brings the results back with one `.cpu()` and assembles them. With
`beam_size` the decode steps are the beam search of `beam.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import partial
from typing import TYPE_CHECKING, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from .audio import CHUNK_LENGTH
from .beam import collect_beam, dispatch_beam
from .decode_steps import (_EXIT_CHECK_EVERY, _PROMPT_BUCKETS, FilterConfig, _apply_filters, _bucket, _fetch,
                           neg_fill)
from .models import whisper as W
from .tokenizer import Tokenizer, get_tokenizer, normalize_language
from .utils import compression_ratio

if TYPE_CHECKING:
    from .models.registry import WhisperModel


@dataclass(frozen=True)
class DecodingOptions:
    """Mirror of the JAX package's options (reference `decoding.py:80-114`)."""

    task: str = "transcribe"
    language: Optional[str] = None

    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None

    length_penalty: Optional[float] = None

    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None

    suppress_tokens: Optional[Union[str, Iterable[int]]] = "-1"
    suppress_blank: bool = True

    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0

    # the model's fast compute dtype (bf16 on the card) vs full fp32
    fp16: bool = True

    # int8 cross- and self-attention K/V with fp32 row scales (kernel K1)
    kv_quant: bool = False

    # W8A8 encoder projections (models/whisper.py linear_i8)
    int8_encoder: bool = False

    return_audio_features: bool = False

    # with kv_quant, whether the prefill reads the pre-quantization float
    # cross K/V (True, the JAX fused window program) or the dequantized int8
    # store (False, the JAX split programs)
    fuse_encoder: bool = True


@dataclass(frozen=True)
class DecodingResult:
    audio_features: Optional[np.ndarray]
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


# ---------------------------------------------------------------------------
# language detection and ranking
# ---------------------------------------------------------------------------


def detect_language(model: "WhisperModel", mel: torch.Tensor, tokenizer: Optional[Tokenizer] = None):
    """Detect the spoken language from mel spectrograms (..., n_mels, 3000)
    or encoder features (..., n_audio_ctx, n_audio_state)."""
    if tokenizer is None:
        tokenizer = get_tokenizer(
            model.is_multilingual, num_languages=model.num_languages, include_diseases=model.has_disease_tokens
        )
    if tokenizer.language is None or tokenizer.language_token not in tokenizer.sot_sequence:
        raise ValueError("This model doesn't have language tokens so it can't perform lang id")

    mel = torch.as_tensor(mel).to(model.device)
    single = mel.ndim == 2
    if single:
        mel = mel[None]
    dims = model.dims
    with torch.no_grad():
        if tuple(mel.shape[-2:]) != (dims.n_audio_ctx, dims.n_audio_state):
            feats = W.encoder_apply(model.encoder, mel, model.compute_dtype)
        else:
            feats = mel.to(model.compute_dtype)
        x = torch.full((feats.shape[0], 1), tokenizer.sot, dtype=torch.long, device=feats.device)
        logits = W.decoder_apply(model.decoder, x, feats, compute_dtype=model.compute_dtype)[0][:, 0]

    mask = torch.ones(logits.shape[-1], dtype=torch.bool)
    mask[list(tokenizer.all_language_tokens)] = False
    logits = logits.masked_fill(mask.to(logits.device)[None, :], neg_fill(logits.dtype))
    language_tokens = logits.argmax(dim=-1).cpu().numpy()
    probs = torch.softmax(logits, dim=-1).cpu().numpy()
    language_probs = [
        {c: float(probs[i, j]) for j, c in zip(tokenizer.all_language_tokens, tokenizer.all_language_codes)}
        for i in range(feats.shape[0])
    ]
    if single:
        return int(language_tokens[0]), language_probs[0]
    return language_tokens, language_probs


class MaximumLikelihoodRanker:
    """Pick the best candidate per audio using length-normalized logprob or
    the Google NMT length penalty (reference decoding.py:190-213)."""

    def __init__(self, length_penalty: Optional[float]):
        self.length_penalty = length_penalty

    def rank(self, tokens: List[List[List[int]]], sum_logprobs: List[List[float]]) -> List[int]:
        def scores(logprobs, lengths):
            result = []
            for logprob, length in zip(logprobs, lengths):
                if self.length_penalty is None:
                    penalty = length
                else:
                    penalty = ((5 + length) / 6) ** self.length_penalty
                result.append(logprob / penalty)
            return result

        lengths = [[len(t) for t in s] for s in tokens]
        return [int(np.argmax(scores(p, l))) for p, l in zip(sum_logprobs, lengths)]


# ---------------------------------------------------------------------------
# the decoding task
# ---------------------------------------------------------------------------


class DecodingTask:
    """One batched 30 s window decode (reference decoding.py:508)."""

    def __init__(self, model: "WhisperModel", options: DecodingOptions):
        self.model = model

        if options.language is not None:
            normalized = normalize_language(options.language)
            if normalized != options.language:
                options = replace(options, language=normalized)
        language = options.language or "en"
        tokenizer = get_tokenizer(
            model.is_multilingual,
            num_languages=model.num_languages,
            language=language,
            task=options.task,
            include_diseases=model.has_disease_tokens,
        )
        self.tokenizer = tokenizer
        self.options = self._verify_options(options)

        self.n_group: int = options.beam_size or options.best_of or 1
        self.n_ctx: int = model.dims.n_text_ctx
        self.sample_len: int = options.sample_len or model.dims.n_text_ctx // 2

        self.sot_sequence = tokenizer.sot_sequence
        if self.options.without_timestamps:
            self.sot_sequence = tokenizer.sot_sequence_including_notimestamps

        self.initial_tokens: Tuple[int, ...] = self._get_initial_tokens()
        self.sot_index: int = self.initial_tokens.index(tokenizer.sot)

        max_initial_timestamp_index = -1
        if not options.without_timestamps and options.max_initial_timestamp:
            precision = CHUNK_LENGTH / model.dims.n_audio_ctx  # 0.02 s
            max_initial_timestamp_index = round(options.max_initial_timestamp / precision)

        self.filter_cfg = FilterConfig(
            n_vocab=model.dims.n_vocab,
            eot=tokenizer.eot,
            timestamp_begin=tokenizer.timestamp_begin,
            no_timestamps=tokenizer.no_timestamps,
            blank_tokens=tuple(tokenizer.encode(" ") + [tokenizer.eot]),
            suppress_tokens=self._get_suppress_tokens(),
            suppress_blank=bool(options.suppress_blank),
            apply_timestamp_rules=not options.without_timestamps,
            max_initial_timestamp_index=max_initial_timestamp_index,
        )
        # the model's dtype (bf16, fp16 or fp32, each with its kernels on the card), or fp32
        self.compute_dtype = model.compute_dtype if options.fp16 else torch.float32
        self.kv_quant = bool(options.kv_quant)
        self.int8_encoder = bool(options.int8_encoder)

    # --- option/initial-token plumbing (reference decoding.py:572-642) -----

    def _verify_options(self, options: DecodingOptions) -> DecodingOptions:
        if options.beam_size is not None and options.beam_size < 1:
            raise ValueError(f"beam_size must be >= 1, got {options.beam_size}")
        if options.best_of is not None and options.best_of < 1:
            raise ValueError(f"best_of must be >= 1, got {options.best_of}")
        if options.patience is not None and options.patience < 1:
            raise ValueError(f"patience must be >= 1.0, got {options.patience}")
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling (T=0) is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        if options.length_penalty is not None and not (0 <= options.length_penalty <= 1):
            raise ValueError("length_penalty (alpha) should be a value between 0 and 1")
        return options

    def _get_initial_tokens(self) -> Tuple[int, ...]:
        tokens = list(self.sot_sequence)
        if prefix := self.options.prefix:
            prefix_tokens = (
                self.tokenizer.encode(" " + prefix.strip()) if isinstance(prefix, str) else list(prefix)
            )
            if self.sample_len is not None:
                max_prefix_len = self.n_ctx // 2 - self.sample_len
                prefix_tokens = prefix_tokens[-max_prefix_len:]
            tokens = tokens + prefix_tokens

        if prompt := self.options.prompt:
            prompt_tokens = (
                self.tokenizer.encode(" " + prompt.strip()) if isinstance(prompt, str) else list(prompt)
            )
            tokens = [self.tokenizer.sot_prev] + prompt_tokens[-(self.n_ctx // 2 - 1):] + tokens

        # trim the leading prompt/prefix context to the largest bucket, never
        # the SOT sequence itself
        limit = _PROMPT_BUCKETS[-1]
        if len(tokens) > limit:
            sot = self.tokenizer.sot
            sot_at = tokens.index(sot)
            tail = tokens[sot_at:]
            if len(tail) > limit:
                raise ValueError(
                    f"prefix too long: {len(tail) - len(self.sot_sequence)} tokens "
                    f"exceed the decoder's {limit}-token prompt budget"
                )
            tokens = tokens[sot_at - (limit - len(tail)):] if limit > len(tail) else tail
            if tokens[0] != self.tokenizer.sot_prev and sot_at > 0:
                tokens = [self.tokenizer.sot_prev] + tokens[1:]
        return tuple(tokens)

    def _get_suppress_tokens(self) -> Tuple[int, ...]:
        suppress_tokens = self.options.suppress_tokens
        if isinstance(suppress_tokens, str):
            suppress_tokens = [int(t) for t in suppress_tokens.split(",")]
        suppress_tokens = [] if suppress_tokens is None else list(suppress_tokens)
        if -1 in suppress_tokens:
            suppress_tokens = [t for t in suppress_tokens if t >= 0]
            suppress_tokens.extend(self.tokenizer.non_speech_tokens)
        suppress_tokens.extend(
            [
                self.tokenizer.transcribe,
                self.tokenizer.translate,
                self.tokenizer.sot,
                self.tokenizer.sot_prev,
                self.tokenizer.sot_lm,
                self.tokenizer.no_speech,
            ]
        )
        return tuple(sorted(set(suppress_tokens)))

    # --- run ----------------------------------------------------------------

    def _fusable(self, mel: torch.Tensor) -> bool:
        """Whether the JAX package can run this window as one fused program
        (its `submit`'s `fused_ok`, decoding.py:967-973); with `fuse_encoder`
        it does, and the prefill reads the float cross K/V (:874-885)."""
        dims = self.model.dims
        return (
            self.options.task != "lang_id"
            and self.options.language is not None
            and not self.options.return_audio_features
            and tuple(mel.shape[-2:]) != (dims.n_audio_ctx, dims.n_audio_state)
        )

    def _encode_audio(self, mel: torch.Tensor, fused: bool):
        """Encoder features, the decode loop's cross-KV and the prefill's."""
        dec = self.model.decoder
        dims = self.model.dims
        if tuple(mel.shape[-2:]) == (dims.n_audio_ctx, dims.n_audio_state):
            feats = mel.to(self.compute_dtype)
        else:
            feats = W.encoder_apply(
                self.model.encoder, mel, self.compute_dtype, int8_linears=self.int8_encoder
            )
        if fused and self.kv_quant:
            cross_f = W.precompute_cross_kv(dec, feats, stack=False)
            return feats, W.quantize_cross_kv(cross_f, W.tp_kv_group(dec, "cross_attn")), cross_f
        cross_kv = W.precompute_cross_kv(dec, feats, quantize=self.kv_quant)
        return feats, cross_kv, cross_kv

    def submit(self, mel, rng_seed: int = 0, feature_sink=None, rows: Optional[Tuple[int, int]] = None):
        """Enqueue one batch of windows on the current stream; returns a
        handle for `collect`.

        `rows` = (first, total): these windows are rows [first, first + B)
        of a batch of `total` windows that data-parallel ranks decode in
        blocks (`parallel/serving.py`); sampling then draws its noise for
        the whole batch and takes these rows, so that every window samples
        what it samples in one process.

        `feature_sink`: with `fuse_encoder=False` and a known language, called
        with this batch's encoder features (B, n_audio_ctx, D) on the device,
        as JAX `submit` does (decoding.py:948-987): the words mode of
        `transcribe_batch` keeps them so that the batched alignment forward
        skips its encoder."""
        mel = torch.as_tensor(mel).to(self.model.device)
        n_audio = mel.shape[0]
        fusable = self._fusable(mel)
        with torch.no_grad():
            feats, cross_kv, cross_prefill = self._encode_audio(mel, fusable and self.options.fuse_encoder)
            if feature_sink is not None and fusable and not self.options.fuse_encoder:
                feature_sink(feats)

            initial = np.tile(np.asarray(self.initial_tokens, np.int64), (n_audio, 1))
            languages = [self.options.language] * n_audio
            language_probs = None
            if self.options.language is None or self.options.task == "lang_id":
                lang_tokens, language_probs = detect_language(self.model, feats, self.tokenizer)
                languages = [max(probs, key=probs.get) for probs in language_probs]
                if self.options.language is None:
                    initial[:, self.sot_index + 1] = np.asarray(lang_tokens)

            if self.options.task == "lang_id":
                feats_np = feats.float().cpu().numpy()
                return [
                    DecodingResult(audio_features=feats_np[i], language=languages[i],
                                   language_probs=language_probs[i])
                    for i in range(n_audio)
                ]

            if self.options.beam_size is not None:
                arrays, meta = dispatch_beam(self, cross_kv, cross_prefill, initial)
                assemble = partial(collect_beam, arrays, meta, self.tokenizer.eot)
            else:
                arrays, meta = self._greedy(cross_kv, cross_prefill, initial, rng_seed, rows)
                assemble = partial(self._assemble_greedy, *arrays, *meta)
        feats_out = feats if self.options.return_audio_features else None
        return (assemble, languages, feats_out)

    def collect(self, pending) -> List[DecodingResult]:
        """Bring a submitted batch's results to the host and assemble them.
        `pending` is `submit`'s handle: (the function that fetches and
        assembles the decode's outputs, languages, features), or the finished
        results of a `lang_id` task."""
        if isinstance(pending, list):
            return pending
        assemble, languages, feats = pending
        tokens, sum_logprobs, no_speech_probs = assemble()
        feats_np = feats.float().cpu().numpy() if feats is not None else None
        return self._finalize(tokens, sum_logprobs, no_speech_probs, languages, feats_np)

    def run(self, mel, rng_seed: int = 0) -> List[DecodingResult]:
        """Decode one batch of 30 s windows."""
        return self.collect(self.submit(mel, rng_seed))

    def _greedy(self, cross_kv, cross_prefill, initial: np.ndarray, rng_seed: int,
                rows: Optional[Tuple[int, int]] = None):
        """Prefill + greedy (or sampled) decode steps; device tensors out.

        The JAX package runs this as a while_loop on the device. Here the
        loop is on the host; it checks "every row finished" every
        `_EXIT_CHECK_EVERY` steps (one sync each) unless EOT is suppressed,
        when no row can finish, and skips the decoder step after the last
        sampled token. Neither changes a result: finished rows only append
        EOT, and the last step's logits are never read. Without the check
        nothing here waits for the device, so `submit` returns while the
        batch still runs.

        A sampled step draws one uniform number per row of the whole batch
        (`rows`, in windows; this batch alone by default) and takes each
        row's token by inverse CDF from its probabilities."""
        model, dims, cfg = self.model, self.model.dims, self.filter_cfg
        dev = model.device
        n_audio = initial.shape[0]
        n_group = self.n_group
        if n_group > 1:  # best-of-N: token rows repeat, cross-KV rows are shared
            initial = np.repeat(initial, n_group, axis=0)
        n_rows, valid_len = initial.shape
        bucket = _bucket(valid_len)
        padded = np.full((n_rows, bucket), self.tokenizer.eot, np.int64)
        padded[:, :valid_len] = initial
        sample_len = min(self.sample_len, self.n_ctx)
        temperature = float(self.options.temperature)

        # cache bounded to the decode horizon, a multiple of 128
        cache_len = min(dims.n_text_ctx, ((bucket + sample_len + 127) // 128) * 128)
        width = W.cache_width(model.decoder)
        if "k_scale" in cross_kv:  # kv_quant: int8 self cache too
            cache = W.init_kv_cache_i8(dims, n_rows, ctx=cache_len, device=dev, width=width)
        else:
            cache = W.init_kv_cache(dims, n_rows, self.compute_dtype, ctx=cache_len, device=dev, width=width)
        first, total = rows if rows is not None else (0, n_audio)
        noise_rows = slice(first * n_group, first * n_group + n_rows)

        tokens = torch.from_numpy(padded)
        if dev.type == "cuda":  # pinned: the copy does not wait for the stream
            tokens = tokens.pin_memory()
        tokens = tokens.to(dev, non_blocking=True)
        prefill_logits, cache = W.decoder_apply(
            model.decoder, tokens, cross_kv=cross_prefill, kv_cache=cache, pos_offset=0,
            compute_dtype=self.compute_dtype,
        )  # (B, bucket, V) fp32
        probs_at_sot = torch.softmax(prefill_logits[:, self.sot_index], dim=-1)
        no_speech_probs = probs_at_sot[:, self.tokenizer.no_speech]
        logits = prefill_logits[:, valid_len - 1].to(self.compute_dtype)

        buf = torch.cat([tokens, torch.full((n_rows, sample_len), cfg.eot, dtype=torch.long, device=dev)], 1)
        sum_lp = torch.zeros(n_rows, dtype=torch.float32, device=dev)
        prev = torch.full((n_rows,), -1, dtype=torch.long, device=dev)
        penult = prev.clone()
        last_ts = prev.clone()
        finished = torch.zeros(n_rows, dtype=torch.bool, device=dev)
        gen = torch.Generator(device=dev).manual_seed(int(rng_seed)) if temperature > 0 else None
        can_finish = cfg.eot not in cfg.suppress_tokens

        i = 0
        while i < sample_len and valid_len + i < dims.n_text_ctx:
            logits = _apply_filters(cfg, logits, i, prev, penult, last_ts)
            if temperature == 0.0:
                next_tok = logits.argmax(dim=-1)
            else:
                probs = torch.softmax(logits.float() / max(temperature, 1e-6), dim=-1)
                u = torch.rand(total * n_group, generator=gen, device=dev)[noise_rows]
                u = torch.cat([u, u.new_zeros(n_rows - u.numel())])  # pad windows past the batch
                next_tok = sample_rows(probs, u)
            # chosen-token logprob: logits[next] - logsumexp(logits)
            lse = torch.logsumexp(logits.float(), dim=-1)
            chosen = logits.gather(1, next_tok[:, None])[:, 0]
            sum_lp = sum_lp + torch.where(finished, 0.0, chosen.float() - lse)
            next_tok = torch.where(finished, cfg.eot, next_tok)
            last_ts = torch.where((next_tok >= cfg.timestamp_begin) & ~finished, next_tok, last_ts)
            finished = finished | (next_tok == cfg.eot)
            pos = valid_len + i
            buf[:, pos] = next_tok
            penult, prev = prev, next_tok
            i += 1
            if i >= sample_len or valid_len + i >= dims.n_text_ctx:
                break
            if can_finish and i % _EXIT_CHECK_EVERY == 0 and bool(finished.all()):
                break
            step_logits, cache = W.decoder_apply(
                model.decoder, next_tok[:, None], cross_kv=cross_kv, kv_cache=cache, pos_offset=pos,
                compute_dtype=self.compute_dtype, logits_dtype=self.compute_dtype,
            )
            logits = step_logits[:, 0]
        return (buf, sum_lp, no_speech_probs, i), (n_audio, n_group, valid_len)

    def _assemble_greedy(self, buf, sum_lp, ns_probs, n_sampled: int, n_audio: int, n_group: int,
                         valid_len: int):
        """Fetch the outputs in one transfer, slice the sampled region and cut
        at the first EOT (reference decoding.py:749-752)."""
        toks, sum_lp, ns_probs = _fetch(buf[:, valid_len : valid_len + n_sampled], sum_lp, ns_probs)
        toks = toks.astype(np.int64)

        tokens: List[List[List[int]]] = []
        sum_logprobs: List[List[float]] = []
        for a in range(n_audio):
            group_toks, group_lps = [], []
            for g in range(n_group):
                row = toks[a * n_group + g]
                eots = np.nonzero(row == self.tokenizer.eot)[0]
                end = int(eots[0]) if len(eots) else len(row)
                group_toks.append([int(t) for t in row[:end]])
                group_lps.append(float(sum_lp[a * n_group + g]))
            tokens.append(group_toks)
            sum_logprobs.append(group_lps)
        no_speech_probs = ns_probs.reshape(n_audio, n_group)[:, 0]
        return tokens, sum_logprobs, no_speech_probs

    def _finalize(self, tokens, sum_logprobs, no_speech_probs, languages, feats_np=None) -> List[DecodingResult]:
        """Rank within each group and assemble results (decoding.py:739-789)."""
        tokenizer = self.tokenizer
        selected = MaximumLikelihoodRanker(self.options.length_penalty).rank(tokens, sum_logprobs)
        final_tokens: List[List[int]] = [t[i] for i, t in zip(selected, tokens)]
        texts = [tokenizer.decode(t).strip() for t in final_tokens]
        final_sum_lp = [lp[i] for i, lp in zip(selected, sum_logprobs)]
        avg_logprobs = [lp / (len(t) + 1) for t, lp in zip(final_tokens, final_sum_lp)]
        return [
            DecodingResult(
                audio_features=feats_np[i] if feats_np is not None else None,
                language=languages[i],
                tokens=final_tokens[i],
                text=texts[i],
                avg_logprob=avg_logprobs[i],
                no_speech_prob=float(no_speech_probs[i]),
                temperature=self.options.temperature,
                compression_ratio=compression_ratio(texts[i]),
            )
            for i in range(len(tokens))
        ]


def sample_rows(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One token per row of probs (B, V) by inverse CDF: the first index
    whose cumulative probability exceeds u * the row's total, u (B,) in
    [0, 1); a token of probability 0 is never taken."""
    cdf = probs.cumsum(dim=-1)
    idx = torch.searchsorted(cdf, (u * cdf[:, -1]).unsqueeze(-1), right=True)[:, 0]
    return idx.clamp(max=probs.shape[-1] - 1)


def decode(
    model: "WhisperModel",
    mel,
    options: Optional[DecodingOptions] = None,
    **kwargs,
) -> Union[DecodingResult, List[DecodingResult]]:
    """Decode 30-second audio segment(s) given as mel spectrogram(s)."""
    if options is None:
        options = DecodingOptions()
    mel = torch.as_tensor(mel)
    single = mel.ndim == 2
    if single:
        mel = mel[None]
    if kwargs:
        options = replace(options, **kwargs)
    result = DecodingTask(model, options).run(mel)
    return result[0] if single else result
