"""Whisper encoder-decoder as PyTorch modules.

Counterpart of `asr_ttl_mtl_tpu/models/whisper.py`. The modules carry the
parameters under the reference checkpoint's names (`encoder.conv1.weight`,
`decoder.blocks.0.mlp.0.bias`, ...), kept in fp32 like the JAX masters; the
functions below compute in a caller-chosen dtype with the JAX package's
rounding points:

* `linear` accumulates in fp32 and adds the bias in fp32 before it rounds;
* LayerNorm runs in fp32; GELU is exact erf in fp32 and tanh in bf16/fp16;
* the encoder runs its blocks at T padded once from 1500 to 1536 with the
  key tail masked, so the attention kernel K3 never re-pads;
* decoding uses a static KV cache (bf16, or int8 with fp32 row scales),
  written in place, and dispatches one-token steps to the decode kernels
  K1 (int8) and K2 (bf16/fp32) exactly where the JAX package does;
* attention over 16 or more queries goes to the flash kernels: K3 (K6
  backward) for non-causal shapes `h2_eligible` serves, K7 (K8 backward)
  for causal ones;
* autograd flows through every function here (training), with the flash
  kernels' backward passes as `torch.autograd.Function`s.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from ..ops.decode_attention import (
    decode_attention,
    decode_attention_i8,
    i8_supported,
    int8_step,
    quantize_kv_rows,
)
from ..ops.flash_attention import flash_attention_h2_vjp, flash_attention_vjp, h2_eligible
from .dims import ModelDimensions

F32 = torch.float32
_HALF = (torch.bfloat16, torch.float16)
Cache = Dict[str, torch.Tensor]


def sinusoids(length: int, channels: int, max_timescale: float = 10000) -> np.ndarray:
    """Sinusoidal position embeddings (reference model.py:62-68)."""
    assert channels % 2 == 0
    log_timescale_increment = np.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# modules (parameter containers, reference names)
# ---------------------------------------------------------------------------


class MultiHeadAttention(nn.Module):
    def __init__(self, n_state: int):
        super().__init__()
        self.query = nn.Linear(n_state, n_state)
        self.key = nn.Linear(n_state, n_state, bias=False)
        self.value = nn.Linear(n_state, n_state)
        self.out = nn.Linear(n_state, n_state)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, n_state: int, cross_attention: bool):
        super().__init__()
        self.attn = MultiHeadAttention(n_state)
        self.attn_ln = nn.LayerNorm(n_state)
        if cross_attention:
            self.cross_attn = MultiHeadAttention(n_state)
            self.cross_attn_ln = nn.LayerNorm(n_state)
        self.mlp = nn.Sequential(nn.Linear(n_state, 4 * n_state), nn.GELU(), nn.Linear(4 * n_state, n_state))
        self.mlp_ln = nn.LayerNorm(n_state)


class AudioEncoder(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        self.dims = dims
        n = dims.n_audio_state
        self.conv1 = nn.Conv1d(dims.n_mels, n, kernel_size=3, padding=1)
        self.conv2 = nn.Conv1d(n, n, kernel_size=3, stride=2, padding=1)
        self.register_buffer("positional_embedding", torch.from_numpy(sinusoids(dims.n_audio_ctx, n)))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(n, False) for _ in range(dims.n_audio_layer))
        self.ln_post = nn.LayerNorm(n)

    def forward(self, mel: torch.Tensor, compute_dtype: torch.dtype = F32, *, int8_linears: bool = False):
        return encoder_apply(self, mel, compute_dtype, int8_linears=int8_linears)


class TextDecoder(nn.Module):
    def __init__(self, dims: ModelDimensions):
        super().__init__()
        self.dims = dims
        n = dims.n_text_state
        self.token_embedding = nn.Embedding(dims.n_vocab, n)
        self.positional_embedding = nn.Parameter(torch.empty(dims.n_text_ctx, n))
        self.blocks = nn.ModuleList(ResidualAttentionBlock(n, True) for _ in range(dims.n_text_layer))
        self.ln = nn.LayerNorm(n)

    def forward(self, tokens: torch.Tensor, audio_features: Optional[torch.Tensor] = None, **kw):
        return decoder_apply(self, tokens, audio_features, **kw)


# ---------------------------------------------------------------------------
# primitive layers
# ---------------------------------------------------------------------------


def layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm computed in fp32, cast back to the input dtype."""
    out = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), 1e-5)
    return out.to(x.dtype)


def mm_f32(x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x2 (N, in) @ w (out, in)^T with both operands in x2's dtype, fp32
    accumulation and an fp32 result (the JAX `preferred_element_type=f32`);
    `w` may be the fp32 master, cast here. No backward of its own on the
    card: `_matmul_f32` gives it one, `ops/chunked_xent.py` writes its own."""
    if x2.dtype == F32:
        return F.linear(x2, w.float())
    if x2.is_cuda:
        return torch.mm(x2, w.to(x2.dtype).t(), out_dtype=F32)
    return torch.mm(x2.float(), w.to(x2.dtype).float().t())  # products of bf16 values are exact in fp32


class _MatmulF32(torch.autograd.Function):
    """`mm_f32` of a half-dtype x2 on the card. `torch.mm(...,
    out_dtype=float32)` has no backward, so the backward is written here:
    the incoming fp32 gradient is rounded to x2's dtype (as the TPU's
    default-precision matmuls round their operands), dx comes back in x2's
    dtype and dw in fp32, accumulated in fp32, for the fp32 master weight."""

    @staticmethod
    def forward(ctx, x2, w):
        ctx.save_for_backward(x2, w)
        return mm_f32(x2, w)

    @staticmethod
    def backward(ctx, g):
        x2, w = ctx.saved_tensors
        g = g.to(x2.dtype)
        dx = torch.mm(g, w.to(x2.dtype)) if ctx.needs_input_grad[0] else None
        dw = torch.mm(g.t(), x2, out_dtype=F32).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """`mm_f32` over the last axis of x (..., in), differentiable on every
    device."""
    x2 = x.reshape(-1, x.shape[-1])
    y = _MatmulF32.apply(x2, w) if x.is_cuda and x.dtype != F32 else mm_f32(x2, w)
    return y.reshape(*x.shape[:-1], w.shape[0])


def linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """x @ W^T (+ b): fp32 accumulation, bias added in fp32, then rounded."""
    out = _matmul_f32(x, lin.weight)
    if lin.bias is not None:
        out = out + lin.bias.float()
    return out.to(x.dtype)


def _quant_rowwise_sym(x32: torch.Tensor):
    """Symmetric int8 quantization with one scale per last-dim row."""
    absmax = x32.abs().amax(dim=-1, keepdim=True)
    scale = int8_step(absmax, 1e-30)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def linear_i8(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """W8A8 linear: per-token activation scales, per-output-column weight
    scales, int8 x int8 -> int32 product (`torch._int_mm`; on CUDA it needs
    more than 16 rows and in/out widths that are multiples of 8)."""
    xq, sx = _quant_rowwise_sym(x.float().reshape(-1, x.shape[-1]))
    wq, sw = _quant_rowwise_sym(lin.weight.float())  # (out, in): a scale per output column
    acc = torch._int_mm(xq, wq.t())
    out = acc.float() * (sx * sw.t())
    if lin.bias is not None:
        out = out + lin.bias.float()
    return out.to(x.dtype).reshape(*x.shape[:-1], lin.out_features)


def conv1d(conv: nn.Conv1d, x: torch.Tensor, stride: int) -> torch.Tensor:
    """1-D conv over (B, C, T) in x's dtype, bias added in fp32."""
    out = F.conv1d(x, conv.weight.to(x.dtype), None, stride=stride, padding=1)
    return (out.float() + conv.bias.float()[None, :, None]).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in fp32; the tanh form in half precision."""
    return F.gelu(x, approximate="tanh" if x.dtype in _HALF else "none")


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def qkv_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    n_head: int,
    mask: Optional[torch.Tensor] = None,
    *,
    causal: bool = False,
    q_offset: int = 0,
    kv_valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over (B, T, D) projections.

    Dispatch as in the JAX package (whisper.py:248-286), where every query
    length >= 16 with a structural mask goes to a flash kernel: the
    non-causal `h2_eligible` shapes to K3 (`flash_attention_h2`, backward
    K6), causal ones (`mask` is then the causal / `q_offset` pattern, which
    the kernel applies itself) to K7 (`flash_attention`, backward K8) over
    split heads. The per-head kernel for non-causal h2-ineligible shapes
    (K5) is not ported: on CUDA those shapes raise. Shorter queries (prompt
    prefill, buckets of 8) take the plain path below, which the JAX package
    leaves to XLA too.
    """
    tq, tk, d = q.shape[1], k.shape[1], q.shape[-1]
    d_head = d // n_head
    flash = tq >= 16 and (mask is None or causal)
    if flash and not causal and mask is None and h2_eligible(tq, tk, d, n_head):
        return flash_attention_h2_vjp(q, k, v, n_head, kv_valid_len, float(d_head**-0.5))
    if flash and causal:
        b = q.shape[0]

        def split(x, t):
            return _split_heads(x, n_head).reshape(b * n_head, t, d_head).contiguous()

        out = flash_attention_vjp(
            split(q, tq), split(k, tk), split(v, tk), True, q_offset, kv_valid_len, float(d_head**-0.5)
        )
        return _merge_heads(out.reshape(b, n_head, tq, d_head))
    if flash and q.is_cuda:
        raise NotImplementedError(
            "non-causal attention with tq >= 16 at a shape h2_eligible rejects needs K5 "
            "`flash_attention_mh` (asr_ttl_mtl_tpu/ops/flash_attention.py), which is not ported yet"
        )

    # reference numerics: both sides scaled by d_head**-0.25 in their dtype
    scale = torch.tensor(d_head**-0.25, dtype=q.dtype, device=q.device)
    qh = _split_heads(q, n_head) * scale
    kh = _split_heads(k, n_head) * scale
    vh = _split_heads(v, n_head)
    qk = qh.float() @ kh.float().transpose(-1, -2)
    if mask is not None:
        qk = qk + mask
    if kv_valid_len is not None and kv_valid_len < tk:
        qk = torch.where(torch.arange(tk, device=q.device) < kv_valid_len, qk, float("-inf"))
    w = torch.softmax(qk, dim=-1).to(v.dtype)
    out = (w.float() @ vh.float()).to(v.dtype)
    return _merge_heads(out)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def encoder_apply(
    enc: AudioEncoder, mel: torch.Tensor, compute_dtype: torch.dtype = F32, *, int8_linears: bool = False,
    remat: bool = False,
) -> torch.Tensor:
    """mel (B, n_mels, 2T) -> audio features (B, T, D).

    int8_linears: the six projections of each block run as W8A8 `linear_i8`;
    attention and the conv stem stay in compute_dtype.
    remat: each block is a `torch.utils.checkpoint` (training): the backward
    recomputes its activations from its (B, T, D) input."""
    lin = linear_i8 if int8_linears else linear
    dims = enc.dims
    x = mel.to(compute_dtype)
    x = gelu(conv1d(enc.conv1, x, stride=1))
    x = gelu(conv1d(enc.conv2, x, stride=2))
    x = x.transpose(1, 2)  # (B, T, D)
    x = (x + enc.positional_embedding[: x.shape[1]].to(compute_dtype)).to(compute_dtype)

    # run the blocks at T rounded up to 128 once; padded keys are masked and
    # every other op is row-wise, so padded rows never reach valid ones
    t_valid = x.shape[1]
    t_run = -(-t_valid // 128) * 128
    if t_run != t_valid:
        x = F.pad(x, (0, 0, 0, t_run - t_valid))
    x = x.contiguous()

    def one_block(x, block):
        res = x
        h = layer_norm(block.attn_ln, x)
        q, k, v = lin(block.attn.query, h), lin(block.attn.key, h), lin(block.attn.value, h)
        att = qkv_attention(
            q, k, v, dims.n_audio_head, kv_valid_len=t_valid if t_run != t_valid else None
        )
        x = res + lin(block.attn.out, att)
        res = x
        h = layer_norm(block.mlp_ln, x)
        h = gelu(lin(block.mlp[0], h))
        return res + lin(block.mlp[2], h)

    for block in enc.blocks:
        if remat:
            x = torch.utils.checkpoint.checkpoint(one_block, x, block, use_reentrant=False)
        else:
            x = one_block(x, block)

    if t_run != t_valid:
        x = x[:, :t_valid]
    return layer_norm(enc.ln_post, x)


# ---------------------------------------------------------------------------
# caches and cross-attention K/V
# ---------------------------------------------------------------------------


def init_kv_cache(
    dims: ModelDimensions, batch: int, compute_dtype: torch.dtype = F32,
    ctx: Optional[int] = None, device=None,
) -> Cache:
    """Static self-attention cache (L, B, ctx, D) for all decoder layers;
    `ctx` bounds it to the decode horizon."""
    shape = (dims.n_text_layer, batch, ctx or dims.n_text_ctx, dims.n_text_state)
    return {
        "k": torch.zeros(shape, dtype=compute_dtype, device=device),
        "v": torch.zeros(shape, dtype=compute_dtype, device=device),
    }


def init_kv_cache_i8(dims: ModelDimensions, batch: int, ctx: Optional[int] = None, device=None) -> Cache:
    """int8 self-attention cache with fp32 row scales per (layer, batch, position)."""
    shape = (dims.n_text_layer, batch, ctx or dims.n_text_ctx, dims.n_text_state)
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.ones(shape[:-1], dtype=F32, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "v_scale": torch.ones(shape[:-1], dtype=F32, device=device),
    }


def _quant_rows(x: torch.Tensor):
    """(B, T, D) float -> ((B, T, D) int8, (B, T) fp32) per-row abs-max
    quantization, without the T padding of quantize_kv_rows."""
    m = x.abs().amax(dim=-1).float()
    scale = int8_step(m, 1e-20)
    return torch.round(x.float() / scale[..., None]).to(torch.int8), scale


def precompute_cross_kv(
    dec: TextDecoder, audio_features: torch.Tensor, quantize: bool = False, stack: bool = True
) -> Cache:
    """Cross-attention K/V projected once per audio window: stacked
    (L, B, Ta, D), or per-layer tuples with stack=False (the prefill's float
    K/V under kv_quant), or int8 with fp32 row scales with quantize=True."""
    ks = [linear(block.cross_attn.key, audio_features) for block in dec.blocks]
    vs = [linear(block.cross_attn.value, audio_features) for block in dec.blocks]
    if not stack:
        assert not quantize, "quantize_cross_kv stacks; use stack=True"
        return {"k": tuple(ks), "v": tuple(vs)}
    cross = {"k": torch.stack(ks), "v": torch.stack(vs)}
    return quantize_cross_kv(cross) if quantize else cross


def quantize_cross_kv(cross_kv) -> Cache:
    """Float cross-KV (stacked or per-layer tuples) -> int8 K/V with fp32 row
    scales, T padded to a multiple of 128. Rows quantize independently, so
    both forms give the same values."""
    if isinstance(cross_kv["k"], (tuple, list)):
        kq = [quantize_kv_rows(k) for k in cross_kv["k"]]
        vq = [quantize_kv_rows(v) for v in cross_kv["v"]]
        return {
            "k": torch.stack([q for q, _ in kq]),
            "k_scale": torch.stack([s for _, s in kq]),
            "v": torch.stack([q for q, _ in vq]),
            "v_scale": torch.stack([s for _, s in vq]),
        }
    ki, ksc = quantize_kv_rows(cross_kv["k"])
    vi, vsc = quantize_kv_rows(cross_kv["v"])
    return {"k": ki, "k_scale": ksc, "v": vi, "v_scale": vsc}


def _dequant_cross_layer(cross_kv: Cache, li: int, dtype, valid_len: int):
    """Per-layer cross K/V in float for the plain attention path: the same
    rounded values the int8 kernel reads, the padded tail sliced off."""
    if "k_scale" in cross_kv:
        k = (cross_kv["k"][li].float() * cross_kv["k_scale"][li][..., None]).to(dtype)
        v = (cross_kv["v"][li].float() * cross_kv["v_scale"][li][..., None]).to(dtype)
        return k[:, :valid_len], v[:, :valid_len]
    return cross_kv["k"][li], cross_kv["v"][li]


# ---------------------------------------------------------------------------
# decoder (one code path for full / prefill / step)
# ---------------------------------------------------------------------------


def decoder_apply(
    dec: TextDecoder,
    tokens: torch.Tensor,  # (B, T) int
    audio_features: Optional[torch.Tensor] = None,
    *,
    kv_cache: Optional[Cache] = None,
    cross_kv: Optional[Cache] = None,
    pos_offset: int = 0,
    compute_dtype: torch.dtype = F32,
    logits_dtype: Optional[torch.dtype] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[Cache]]:
    """Run the text decoder over `tokens`.

    kv_cache None: teacher-forced forward with a causal mask. With a cache:
    the K/V of these T positions are written into it in place at
    [pos_offset, pos_offset + T) and attention runs over the cache with
    `key_pos <= query_pos` (prefill for T > 1, a decode step for T == 1).
    Query rows b*G .. b*G+G-1 share cross-KV row b (G = B // cross batch).
    Returns (logits fp32 or `logits_dtype`, the updated cache or None); with
    `return_hidden`, the final LayerNorm's (B, T, D) output instead of the
    logits (training's chunked cross-entropy projects it itself).
    """
    dims = dec.dims
    B, T = tokens.shape
    D = dims.n_text_state
    H = dims.n_text_head
    dev = tokens.device

    x = dec.token_embedding.weight[tokens].to(compute_dtype)
    x = x + dec.positional_embedding[pos_offset : pos_offset + T].to(compute_dtype)

    if cross_kv is None:
        cross_kv = precompute_cross_kv(dec, audio_features)
    stacked = not isinstance(cross_kv["k"], (tuple, list))
    cross_b = cross_kv["k"].shape[1] if stacked else cross_kv["k"][0].shape[0]
    kv_group = B // cross_b
    assert B == kv_group * cross_b, f"token batch {B} not a multiple of cross-KV batch {cross_b}"

    neg = -1e9
    if kv_cache is None:
        mask = torch.triu(torch.full((T, T), neg, device=dev), 1)[None, None]
    else:
        q_pos = pos_offset + torch.arange(T, device=dev)
        key_pos = torch.arange(kv_cache["k"].shape[2], device=dev)
        mask = torch.where(key_pos[None, :] > q_pos[:, None], neg, 0.0)[None, None]

    self_quant = kv_cache is not None and "k_scale" in kv_cache
    fast_step = T == 1 and kv_cache is not None
    kv_quantized = "k_scale" in cross_kv
    # the int8 kernel needs a geometry `_i8_blocks` serves; others dequantize
    # into the plain path, as in the JAX package (part of its semantics)
    i8_cross_ok = fast_step and kv_quantized and i8_supported(cross_b, cross_kv["k"].shape[2], D)
    i8_self_ok = fast_step and self_quant and i8_supported(B, kv_cache["k"].shape[2], D)
    scale = float((D // H) ** -0.5)
    sl = slice(pos_offset, pos_offset + T)

    for li, block in enumerate(dec.blocks):
        # --- causal self-attention ---
        res = x
        h = layer_norm(block.attn_ln, x)
        q, k, v = linear(block.attn.query, h), linear(block.attn.key, h), linear(block.attn.value, h)
        if self_quant:
            ki, ksc = _quant_rows(k)
            vi, vsc = _quant_rows(v)
            kv_cache["k"][li, :, sl] = ki
            kv_cache["k_scale"][li, :, sl] = ksc
            kv_cache["v"][li, :, sl] = vi
            kv_cache["v_scale"][li, :, sl] = vsc
        elif kv_cache is not None:
            kv_cache["k"][li, :, sl] = k
            kv_cache["v"][li, :, sl] = v
        if fast_step and self_quant and i8_self_ok:
            att = decode_attention_i8(
                q, kv_cache["k"], kv_cache["k_scale"], kv_cache["v"], kv_cache["v_scale"], li, H,
                scale=scale, valid_upto=pos_offset,
            )
        elif fast_step and not self_quant:
            att = decode_attention(q, kv_cache["k"], kv_cache["v"], li, H, scale=scale, valid_upto=pos_offset)
        else:
            if self_quant:  # prefill reads the same rounded values the step kernel sees
                k = (kv_cache["k"][li].float() * kv_cache["k_scale"][li][..., None]).to(compute_dtype)
                v = (kv_cache["v"][li].float() * kv_cache["v_scale"][li][..., None]).to(compute_dtype)
            elif kv_cache is not None:
                k, v = kv_cache["k"][li], kv_cache["v"][li]
            att = qkv_attention(q, k, v, H, mask=mask, causal=True, q_offset=pos_offset)
        x = res + linear(block.attn.out, att)

        # --- cross-attention ---
        res = x
        h = layer_norm(block.cross_attn_ln, x)
        qc = linear(block.cross_attn.query, h)
        if fast_step and kv_quantized and i8_cross_ok:
            # the int8 store pads T to 128; mask the padded tail
            att = decode_attention_i8(
                qc, cross_kv["k"], cross_kv["k_scale"], cross_kv["v"], cross_kv["v_scale"], li, H,
                scale=scale, valid_upto=dims.n_audio_ctx - 1, group=kv_group,
            )
        elif fast_step and not kv_quantized:
            att = decode_attention(qc, cross_kv["k"], cross_kv["v"], li, H, scale=scale, group=kv_group)
        else:
            ck, cv = _dequant_cross_layer(cross_kv, li, compute_dtype, dims.n_audio_ctx)
            if kv_group > 1:  # cross-attention has no mask: fold the group into queries
                att = qkv_attention(qc.reshape(cross_b, kv_group * T, D), ck, cv, H).reshape(B, T, D)
            else:
                att = qkv_attention(qc, ck, cv, H)
        x = res + linear(block.cross_attn.out, att)

        # --- mlp ---
        res = x
        h = layer_norm(block.mlp_ln, x)
        h = gelu(linear(block.mlp[0], h))
        x = res + linear(block.mlp[2], h)

    x = layer_norm(dec.ln, x)
    if return_hidden:
        return x, kv_cache
    logits = _matmul_f32(x, dec.token_embedding.weight)  # tied embeddings
    if logits_dtype is not None:
        logits = logits.to(logits_dtype)
    return logits, kv_cache
