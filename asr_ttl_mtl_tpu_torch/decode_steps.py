"""What the greedy loop (`decoding.py`) and the beam loop (`beam.py`) share:
the prompt buckets (JAX `decoding.py:49-56`), the logit filters as one
vectorized pass (`FilterConfig`, `_apply_filters` :133-224), and the
one-transfer fetch of a batch's outputs to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch

_NEG = -1e9  # effective -inf that keeps softmax finite
_PROMPT_BUCKETS = (8, 16, 32, 64, 128, 256)
_EXIT_CHECK_EVERY = 8  # steps between host checks of "every row finished"


@lru_cache(maxsize=8)
def neg_fill(dtype: torch.dtype) -> float:
    """The value a logit filter fills in a `dtype` row: _NEG as JAX's
    `jnp.where(mask, _NEG, logits)` gives it, the weakly typed -1e9 cast to
    the logits' dtype: -inf in fp16 (past its range), -1e9 rounded in bf16
    (as `masked_fill` rounds it) and -1e9 in fp32."""
    return float(torch.tensor(_NEG, dtype=torch.float32).to(dtype))


def _bucket(n: int) -> int:
    for b in _PROMPT_BUCKETS:
        if n <= b:
            return b
    return _PROMPT_BUCKETS[-1]


# ---------------------------------------------------------------------------
# vectorized logit filters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FilterConfig:
    """Static per-task filter configuration."""

    n_vocab: int
    eot: int
    timestamp_begin: int
    no_timestamps: int
    blank_tokens: Tuple[int, ...]  # tokens suppressed at sample start
    suppress_tokens: Tuple[int, ...]
    suppress_blank: bool
    apply_timestamp_rules: bool
    max_initial_timestamp_index: int  # -1 = unlimited


@lru_cache(maxsize=32)
def _filter_masks(cfg: FilterConfig, device: torch.device):
    """(blank, suppress) boolean (V,) masks on the device."""
    blank = torch.zeros(cfg.n_vocab, dtype=torch.bool)
    blank[list(cfg.blank_tokens)] = True
    sup = torch.zeros(cfg.n_vocab, dtype=torch.bool)
    sup[list(cfg.suppress_tokens)] = True
    return blank.to(device), sup.to(device)


def _apply_filters(
    cfg: FilterConfig,
    logits: torch.Tensor,  # (B, V) in the loop's compute dtype
    step: int,  # number of sampled tokens so far
    prev_tok: torch.Tensor,  # (B,) last sampled token (-1 before any)
    penult_tok: torch.Tensor,  # (B,) second-to-last sampled token (-1)
    last_ts: torch.Tensor,  # (B,) last sampled timestamp token (-1 if none)
) -> torch.Tensor:
    """All reference logit filters as one vectorized masking pass."""
    blank, sup = _filter_masks(cfg, logits.device)
    neg = neg_fill(logits.dtype)
    if cfg.suppress_blank and step == 0:
        logits = logits.masked_fill(blank[None, :], neg)
    if cfg.suppress_tokens:
        logits = logits.masked_fill(sup[None, :], neg)

    if cfg.apply_timestamp_rules:
        ts_begin = cfg.timestamp_begin
        vocab_ids = torch.arange(cfg.n_vocab, device=logits.device)[None, :]
        logits = logits.masked_fill(vocab_ids == cfg.no_timestamps, neg)

        last_was_ts = (prev_tok >= ts_begin) & (step >= 1)
        penult_was_ts = (penult_tok >= ts_begin) | (step < 2)
        force_non_ts = (last_was_ts & penult_was_ts)[:, None]
        force_ts_or_eot = (last_was_ts & ~penult_was_ts)[:, None]
        logits = logits.masked_fill(force_non_ts & (vocab_ids >= ts_begin), neg)
        logits = logits.masked_fill(force_ts_or_eot & (vocab_ids < cfg.eot), neg)

        # non-decreasing timestamps
        has_ts = last_ts >= 0
        ts_floor = torch.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
        ts_mask = has_ts[:, None] & (vocab_ids >= ts_begin) & (vocab_ids < ts_floor[:, None])
        logits = logits.masked_fill(ts_mask, neg)

        # at the first sample: force a timestamp, optionally capped
        if step == 0:
            logits = logits.masked_fill(vocab_ids < ts_begin, neg)
            if cfg.max_initial_timestamp_index >= 0:
                logits = logits.masked_fill(vocab_ids > ts_begin + cfg.max_initial_timestamp_index, neg)

        # sample a timestamp if their total probability beats every text token
        # (compared on raw logits: the log_softmax shift is common to both)
        ts_logprob = torch.logsumexp(logits[:, ts_begin:].float(), dim=-1)
        max_text = logits[:, :ts_begin].float().amax(dim=-1)
        force_ts = (ts_logprob > max_text)[:, None]
        logits = logits.masked_fill(force_ts & (vocab_ids < ts_begin), neg)

    return logits


def _fetch(*tensors: torch.Tensor) -> List[np.ndarray]:
    """The tensors on the host, in one device-to-host transfer: packed as
    fp32 (token ids < 2^24 travel exactly) and unpacked to their shapes."""
    packed = torch.cat([t.float().reshape(-1) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(packed[at : at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out
