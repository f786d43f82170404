"""Beam search with patience (counterpart of `asr_ttl_mtl_tpu/beam.py`).

Behaviour of the JAX program (`_beam_program` :124-341, the reference's
BeamSearchDecoder): per-beam top-(K+1) candidates by kernel K9
(`ops/topk.py`), a stable global re-rank, EOT candidates retired into a
finished set of C = round(K * patience) slots in score order (fill once,
no replacement), completion when every audio holds C finished sequences,
and a top-up of short sets from the live beams on the host.

The JAX package runs the search as one `while_loop` on the device; here it
is a host loop over device tensors, like the greedy loop of
`decoding.py`. The prompt prefills once per audio and its self-cache is
repeated K-fold; the cross K/V stays at one row per audio, shared by the K
beams through the decoder's `kv_group`. Beams 1..K-1 start at -1e9, so the
first step picks K distinct tokens from beam 0. Finished sequences go to
`fin_tokens (B, C+1, L)`; slot C is scratch that catches the overflow and
is reset every step.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .decode_steps import _EXIT_CHECK_EVERY, _NEG, _apply_filters, _bucket, _fetch
from .models import whisper as W
from .ops.topk import topk_logprobs

_INVALID = -0.5e9  # scores below this are dead-beam artifacts, never used


def dispatch_beam(task, cross_kv, cross_prefill, initial: np.ndarray):
    """Enqueue prefill and every beam step on the current stream; returns
    (device outputs, assembly metadata) for `collect_beam`.

    The loop checks "every audio holds C finished sequences" every
    `_EXIT_CHECK_EVERY` steps (one sync each), and not at all when EOT is
    suppressed. The JAX loop stops at the first step where it holds; the
    steps taken here after that change no result: every later retirement
    lands in the scratch slot C (the slot index is capped at C and
    `fin_count` stays C), C >= K means no audio is topped up from the live
    beams, and `slice_sampled` cuts each finished row at its first EOT,
    which lies before the step where the JAX loop stopped."""
    options, model, cfg = task.options, task.model, task.filter_cfg
    dims, dev, dtype = model.dims, model.device, task.compute_dtype
    K = options.beam_size
    patience = options.patience or 1.0
    C = round(K * patience)
    assert C > 0, f"Invalid beam size ({K}) or patience ({patience})"

    B, valid_len = initial.shape
    BK = B * K
    bucket = _bucket(valid_len)
    padded = np.full((B, bucket), cfg.eot, np.int64)
    padded[:, :valid_len] = initial
    sample_len = min(task.sample_len, task.n_ctx)
    buf_len = bucket + sample_len
    cache_len = min(dims.n_text_ctx, ((buf_len + 127) // 128) * 128)

    tokens = torch.from_numpy(padded)
    if dev.type == "cuda":  # pinned: the copy does not wait for the stream
        tokens = tokens.pin_memory()
    tokens = tokens.to(dev, non_blocking=True)
    width = W.cache_width(model.decoder)
    if "k_scale" in cross_kv:  # kv_quant: int8 self cache too
        cache = W.init_kv_cache_i8(dims, B, ctx=cache_len, device=dev, width=width)
    else:
        cache = W.init_kv_cache(dims, B, dtype, ctx=cache_len, device=dev, width=width)
    prefill_logits, cache = W.decoder_apply(
        model.decoder, tokens, cross_kv=cross_prefill, kv_cache=cache, pos_offset=0, compute_dtype=dtype,
    )  # (B, bucket, V) fp32
    cache = {name: t.repeat_interleave(K, dim=1) for name, t in cache.items()}
    no_speech = task.tokenizer.no_speech
    if no_speech is not None:
        no_speech_probs = torch.softmax(prefill_logits[:, task.sot_index], dim=-1)[:, no_speech]
    else:
        no_speech_probs = torch.full((B,), float("nan"), device=dev)
    logits = prefill_logits[:, valid_len - 1].repeat_interleave(K, dim=0).to(dtype)

    buf = torch.cat([tokens.repeat_interleave(K, dim=0),
                     torch.full((BK, sample_len), cfg.eot, dtype=torch.long, device=dev)], dim=1)
    sum_lp = torch.tensor([0.0] + [_NEG] * (K - 1), device=dev).repeat(B)  # only beam 0 is live
    prev = torch.full((BK,), -1, dtype=torch.long, device=dev)
    penult, last_ts = prev.clone(), prev.clone()
    fin_tokens = torch.full((B, C + 1, buf_len), cfg.eot, dtype=torch.long, device=dev)
    fin_scores = torch.full((B, C + 1), float("-inf"), device=dev)
    fin_count = torch.zeros(B, dtype=torch.long, device=dev)

    rows = torch.arange(B, device=dev)[:, None]
    beam_base = rows * K
    n_cand = K * (K + 1)
    parent_of = torch.arange(K, device=dev).repeat_interleave(K + 1)[None, :].expand(B, n_cand)
    can_finish = cfg.eot not in cfg.suppress_tokens

    i = 0
    while i < sample_len and valid_len + i < dims.n_text_ctx:
        pos = valid_len + i
        logits = _apply_filters(cfg, logits, i, prev, penult, last_ts)
        top_lp, top_tok = topk_logprobs(logits, K + 1)  # (BK, K+1)
        cand_scores = (sum_lp[:, None] + top_lp).reshape(B, n_cand)
        cand_tok = top_tok.long().reshape(B, n_cand)

        # global re-rank: descending score, ties kept in candidate order
        order = torch.sort(-cand_scores, dim=1, stable=True).indices
        cand_scores = cand_scores.gather(1, order)
        cand_tok = cand_tok.gather(1, order)
        cand_parent = parent_of.gather(1, order)

        valid = cand_scores > _INVALID
        is_eot = (cand_tok == cfg.eot) & valid
        # the next K live beams: the best non-EOT candidates in score order;
        # EOT candidates ranked below the K-th kept one never retire
        keep = ~is_eot & valid
        keep_cum = keep.long().cumsum(dim=1)
        selected = keep & (keep_cum - 1 < K)
        is_eot = is_eot & (keep_cum < K)
        comp = torch.sort((~selected).int(), dim=1, stable=True).indices[:, :K]  # selected first, in order
        new_scores = cand_scores.gather(1, comp)
        new_tok = cand_tok.gather(1, comp)
        src = (cand_parent.gather(1, comp) + beam_base).reshape(BK)

        # retire EOT candidates: the parent row with EOT at `pos`
        eot_rank = is_eot.long().cumsum(dim=1) - 1
        slot = torch.where(is_eot, fin_count[:, None] + eot_rank, C).clamp(max=C)
        parent_rows = buf.view(B, K, buf_len)[rows, cand_parent]  # (B, K(K+1), L)
        parent_rows[:, :, pos] = cfg.eot
        fin_tokens[rows, slot] = parent_rows
        fin_scores[rows, slot] = cand_scores
        fin_count = (fin_count + is_eot.sum(dim=1)).clamp(max=C)
        fin_tokens[:, C] = cfg.eot  # the scratch slot stays inert
        fin_scores[:, C] = float("-inf")

        # advance the live beams: rows, self-cache and filter state follow src
        buf = buf.index_select(0, src)
        buf[:, pos] = new_tok.reshape(BK)
        cache = {name: t.index_select(1, src) for name, t in cache.items()}
        penult = prev.index_select(0, src)
        prev = new_tok.reshape(BK)
        last_ts = torch.where(prev >= cfg.timestamp_begin, prev, last_ts.index_select(0, src))
        sum_lp = new_scores.reshape(BK)

        i += 1
        if i >= sample_len or valid_len + i >= dims.n_text_ctx:
            break
        if can_finish and i % _EXIT_CHECK_EVERY == 0 and bool((fin_count >= C).all()):
            break
        step_logits, cache = W.decoder_apply(
            model.decoder, prev[:, None], cross_kv=cross_kv, kv_cache=cache, pos_offset=pos,
            compute_dtype=dtype, logits_dtype=dtype,
        )
        logits = step_logits[:, 0]
    arrays = (fin_tokens[:, :C], fin_scores[:, :C], fin_count, buf, sum_lp, no_speech_probs, i)
    return arrays, (B, K, valid_len)


def collect_beam(arrays, meta, eot: int):
    """Bring a dispatched search's outputs to the host in one transfer and
    assemble them."""
    *on_card, n_sampled = arrays
    fin_tokens, fin_scores, fin_count, buf, sum_lp, ns_probs = _fetch(*on_card)
    outs = (fin_tokens.astype(np.int64), fin_scores, fin_count.astype(np.int64), buf.astype(np.int64),
            sum_lp, ns_probs, n_sampled)
    return assemble_beam_results(outs, *meta, eot)


def assemble_beam_results(outs, n_audio: int, K: int, valid_len: int, eot: int):
    """EOT-slice the finished sequences and top up short finished sets from
    the live beams, best first (reference decoding.py:384-395)."""
    fin_tokens, fin_scores, fin_count, live_buf, live_sum_lp, ns_probs, n_sampled = outs
    live_buf = np.asarray(live_buf).reshape(n_audio, K, -1)
    live_sum_lp = np.asarray(live_sum_lp).reshape(n_audio, K)
    n_sampled = int(n_sampled)

    def slice_sampled(row) -> List[int]:
        sampled = row[valid_len : valid_len + n_sampled + 1]
        ends = np.nonzero(sampled == eot)[0]
        end = int(ends[0]) if len(ends) else len(sampled)
        return [int(t) for t in sampled[:end]]

    tokens: List[List[List[int]]] = []
    sum_logprobs: List[List[float]] = []
    for a in range(n_audio):
        seqs = [slice_sampled(fin_tokens[a, c]) for c in range(int(fin_count[a]))]
        scores = [float(fin_scores[a, c]) for c in range(int(fin_count[a]))]
        if len(seqs) < K:
            for j in np.argsort(live_sum_lp[a])[::-1]:
                if len(seqs) >= K:
                    break
                if live_sum_lp[a, j] <= _INVALID:
                    continue
                seqs.append(slice_sampled(live_buf[a, j]))
                scores.append(float(live_sum_lp[a, j]))
        tokens.append(seqs)
        sum_logprobs.append(scores)
    return tokens, sum_logprobs, np.asarray(ns_probs).reshape(n_audio)

