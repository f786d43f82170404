"""Chunked softmax cross-entropy over the tied-embedding projection: the
(B, T, n_vocab) training logits are never materialized.

Counterpart of `asr_ttl_mtl_tpu/ops/chunked_xent.py::chunked_softmax_xent`.
The forward computes per row-chunk logits = x_c W^T (fp32 accumulation),
the per-token logsumexp, the target gather and the argmax; only (N,)
vectors survive. The backward (a `torch.autograd.Function`) recomputes each
chunk's logits, forms dlogits = g (softmax - onehot(target)) with the
forward's logsumexp, and contracts it at once into dx_c = dlogits W and
dW += dlogits^T x_c, all in fp32. These are plain large matrix products
outside any kernel, so they go to `torch.mm`, as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.whisper import mm_f32

_F32 = torch.float32


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embed, targets, ignore_index, row_chunk):
        n = hidden.shape[0]
        w = embed.to(hidden.dtype)  # the same cast as the decoder's logits
        loss = torch.empty(n, dtype=_F32, device=hidden.device)
        preds = torch.empty(n, dtype=torch.long, device=hidden.device)
        lse = torch.empty(n, dtype=_F32, device=hidden.device)
        for r0 in range(0, n, row_chunk):
            sl = slice(r0, r0 + row_chunk)
            logits = mm_f32(hidden[sl], w)  # (R, V) fp32, as the decoder's logits
            lse_c = torch.logsumexp(logits, dim=-1)
            t_c = targets[sl]
            valid = t_c != ignore_index
            tgt = logits.gather(1, torch.where(valid, t_c, 0)[:, None])[:, 0]
            loss[sl] = torch.where(valid, lse_c - tgt, 0.0)
            preds[sl] = logits.argmax(dim=-1)
            lse[sl] = lse_c
        ctx.save_for_backward(hidden, embed, targets, lse)
        ctx.cfg = (ignore_index, row_chunk)
        ctx.mark_non_differentiable(preds)
        return loss, preds

    @staticmethod
    def backward(ctx, g_loss, _g_preds):
        hidden, embed, targets, lse = ctx.saved_tensors
        ignore_index, row_chunk = ctx.cfg
        n = hidden.shape[0]
        w = embed.to(hidden.dtype)
        w32 = embed.float()
        dx = torch.empty_like(hidden)
        dw = torch.zeros(embed.shape, dtype=_F32, device=embed.device)
        for r0 in range(0, n, row_chunk):
            sl = slice(r0, r0 + row_chunk)
            x_c = hidden[sl]
            logits = mm_f32(x_c, w)  # recompute
            p = torch.exp(logits - lse[sl][:, None])  # softmax with the forward's normalizer
            t_c = targets[sl]
            valid = t_c != ignore_index
            coeff = torch.where(valid, g_loss[sl].float(), 0.0)
            dlogits = p * coeff[:, None]
            rows = torch.arange(dlogits.shape[0], device=dlogits.device)
            dlogits[rows, torch.where(valid, t_c, 0)] -= coeff
            dx[sl] = (dlogits @ w32).to(hidden.dtype)
            dw += dlogits.t() @ x_c.float()
        return dx, dw.to(embed.dtype), None, None, None


def chunked_softmax_xent(
    hidden: torch.Tensor,  # (B, T, D)
    embed: torch.Tensor,  # (V, D) tied embedding table
    targets: torch.Tensor,  # (B, T) int
    *,
    ignore_index: int = -100,
    row_chunk: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token cross-entropy -log softmax(x W^T)[target] without the (B, T, V)
    logits. Returns (token_loss (B, T) fp32, 0 at ignored positions;
    pred_tokens (B, T) long, the argmax over the fp32-accumulated logits).
    Rows run in chunks of `row_chunk`; each row's result does not depend on
    the chunking."""
    b, t, d = hidden.shape
    loss, preds = _ChunkedXent.apply(
        hidden.reshape(b * t, d), embed, targets.reshape(b * t).long(), ignore_index, row_chunk
    )
    return loss.reshape(b, t), preds.reshape(b, t)
