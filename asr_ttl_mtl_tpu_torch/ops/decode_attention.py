"""K1 and K2: single-token decode attention over a layer of the stacked
(L, B, Tk, D) KV caches (kernels in `csrc/decode_attention.cu`), their plain
versions, and the int8 cache helpers.

Counterpart of `asr_ttl_mtl_tpu/ops/decode_attention.py`:
`decode_attention` (:94, K2) on bf16 or fp32 caches, `decode_attention_i8`
(:329, K1) on int8 caches with fp32 row scales, `quantize_kv_rows` (:159)
and the int8 block geometry `_i8_blocks` / `i8_supported` (:294-323).

K1's numbers depend on its key-block size: p is quantized to int8 per
(row, block) relative to the running max. The block size `tk_blk` therefore
comes from `_i8_blocks`, as on the TPU, and both the kernel and the plain
version walk the blocks in order.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, _cuda

_NEG_INF = -1e30
MAX_GROUP = 8  # query rows per cache row one K2 launch takes; the wrapper splits larger groups
# K1's p*v_scale/sp within this of a midpoint may round either way under
# another exp (a few fp32 ulps of p, < 1e-4 of a step at 127 steps)
_FLIP_MARGIN = 1e-3


def int8_step(absmax: torch.Tensor, floor: float) -> torch.Tensor:
    """max(absmax, floor) / 127, the int8 step, by true division as in the
    kernels and in XLA. On CUDA, torch divides by a Python number as a
    product with its reciprocal, one ulp off; with bf16 inputs x*127/absmax
    often lands exactly on a rounding midpoint, where that ulp decides the
    int8 value."""
    m = torch.clamp(absmax, min=floor)
    return m / torch.full((), 127.0, device=m.device)


def quantize_kv_rows(x: torch.Tensor):
    """(..., T, D) float -> ((..., T_pad, D) int8, (..., T_pad) fp32 scale),
    per-row abs-max scaling, T padded to a multiple of 128. The padded keys
    must be masked by the consumer (decode_attention_i8's valid_upto)."""
    t = x.shape[-2]
    t_pad = ((t + 127) // 128) * 128
    if t_pad != t:
        x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
    m = x.abs().amax(dim=-1).float()
    scale = int8_step(m, 1e-20)
    xi = torch.round(x.float() / scale[..., None]).to(torch.int8)
    return xi, scale


def _i8_blocks(b: int, tk: int, d: int):
    """(b_blk, tk_blk) of the int8 kernel, or None if unsupported (the TPU
    tiling rule; kept because tk_blk fixes the rounding of p)."""
    if b <= 8:
        b_blk = b
    elif b % 8 == 0:
        b_blk = 8
    elif b * 128 * d <= (1 << 20):
        b_blk = b
    else:
        return None
    tk_blk = None
    for cand in (1024, 512, 256, 128):
        if tk % cand == 0 and b_blk * cand * d <= (1 << 20):
            tk_blk = cand
            break
    if tk_blk is None:
        if tk % 128 == 0 and b_blk * 128 * d <= (2 << 20):
            tk_blk = 128
        else:
            return None
    return b_blk, tk_blk


def i8_supported(b: int, tk: int, d: int) -> bool:
    """Whether decode_attention_i8 serves this cache geometry."""
    return _i8_blocks(b, tk, d) is not None


def _valid(valid_upto: Optional[int]) -> int:
    return -1 if valid_upto is None else int(valid_upto)


# ------------------------------------------------------------------ K2 ----


def decode_attention_plain(
    q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int, n_head: int,
    *, scale: float, valid_upto: Optional[int] = None, group: int = 1,
) -> torch.Tensor:
    """Plain PyTorch K2: q (B*group, 1, D) -> (B*group, 1, D) in q's dtype."""
    _, b, tk, d = cache_k.shape
    dh = d // n_head
    qg = q.reshape(b, group, n_head, dh).float()
    k = cache_k[layer].reshape(b, tk, n_head, dh).float()
    v = cache_v[layer].reshape(b, tk, n_head, dh)
    s = torch.einsum("bghd,bkhd->bghk", qg, k) * scale
    valid = _valid(valid_upto)
    if valid >= 0:
        s = torch.where(torch.arange(tk, device=q.device) > valid, _NEG_INF, s)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = (p / l).to(v.dtype).float()
    out = torch.einsum("bghk,bkhd->bghd", p, v.float())
    return out.to(q.dtype).reshape(b * group, 1, d)


def decode_attention(
    q: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int, n_head: int,
    *, scale: float, valid_upto: Optional[int] = None, group: int = 1,
) -> torch.Tensor:
    """K2 wrapper: softmax(scale q K_layer^T) V_layer for 1-token queries; rows
    [b*group, (b+1)*group) of q attend over cache row b, for any group (one
    launch per MAX_GROUP rows of it). Keys past `valid_upto` are masked
    (None: all valid)."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, cache_k, cache_v, layer, n_head, scale=scale, valid_upto=valid_upto, group=group
        )
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    n_layer, b, tk, d = cache_k.shape
    if q.dtype != cache_k.dtype or cache_k.dtype != cache_v.dtype or q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode_attention kernel takes one of bf16/fp32 for q and caches, got {q.dtype}/{cache_k.dtype}")
    if q.shape != (b * group, 1, d) or cache_v.shape != cache_k.shape or d != n_head * 64 or group < 1:
        raise ValueError(f"decode_attention: bad shapes q={tuple(q.shape)} cache={tuple(cache_k.shape)} group={group}")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("decode_attention: caches must be contiguous")
    if group <= MAX_GROUP:
        return _launch_k2(q.contiguous(), cache_k, cache_v, layer, n_head, scale, valid_upto, group)
    # larger groups go in launches of at most MAX_GROUP query rows per cache
    # row: each chunk's rows are gathered, and their outputs put back in place
    qg = q.reshape(b, group, d)
    out = torch.empty_like(qg)
    for g0 in range(0, group, MAX_GROUP):
        g1 = min(group, g0 + MAX_GROUP)
        chunk = qg[:, g0:g1].reshape(b * (g1 - g0), 1, d).contiguous()
        part = _launch_k2(chunk, cache_k, cache_v, layer, n_head, scale, valid_upto, g1 - g0)
        out[:, g0:g1] = part.reshape(b, g1 - g0, d)
    return out.reshape(b * group, 1, d)


def _launch_k2(q, cache_k, cache_v, layer, n_head, scale, valid_upto, group) -> torch.Tensor:
    n_layer, b, tk, d = cache_k.shape
    out = torch.empty_like(q)
    fn = "decode_attn_bf16" if q.dtype == torch.bfloat16 else "decode_attn_f32"
    code = getattr(_cuda.lib("decode_attention"), fn)(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
        int(layer), n_layer, b, group, tk, d, n_head, _valid(valid_upto), float(scale),
        _cuda.stream_handle(q.device),
    )
    _cuda.check("decode_attention", fn, code)
    LAUNCHES["decode_attention"] += 1
    return out


# ------------------------------------------------------------------ K1 ----


def decode_attention_i8_plain(
    q: torch.Tensor, cache_k: torch.Tensor, k_scale: torch.Tensor, cache_v: torch.Tensor,
    v_scale: torch.Tensor, layer: int, n_head: int,
    *, scale: float, valid_upto: Optional[int] = None, group: int = 1, return_flip_bound: bool = False,
):
    """Plain PyTorch K1, block by block in order like the kernel. The int8
    products are summed in float64, where they are exact.

    With `return_flip_bound`, also returns how far another exp or another
    order of fp32 sums can move each fp32 output: only a key whose
    p*v_scale/sp lies within `_FLIP_MARGIN` of a rounding midpoint can round
    to the other int8 neighbour, and such a flip moves output d by
    sp*|v_int8[key, d]|/l. The bound is the sum of that over those keys."""
    _, b, tk, d = cache_k.shape
    blocks = _i8_blocks(b, tk, d)
    assert blocks is not None, f"unsupported int8 geometry b={b} tk={tk} d={d}"
    tk_blk = blocks[1]
    dh = d // n_head
    valid = _valid(valid_upto)

    qh = q.reshape(b, group, n_head, dh).float()
    sq = int8_step(qh.abs().amax(dim=-1, keepdim=True), 1e-20)
    qi = torch.round(qh / sq).double()  # (b, G, H, dh)
    sq_scale = sq * scale

    m = torch.full((b, group, n_head, 1), _NEG_INF, device=q.device)
    l = torch.zeros((b, group, n_head, 1), device=q.device)
    acc = torch.zeros((b, group, n_head, dh), device=q.device)
    flip = torch.zeros_like(acc)
    for k0 in range(0, tk, tk_blk):
        kb = cache_k[layer, :, k0 : k0 + tk_blk].reshape(b, tk_blk, n_head, dh).double()
        vb = cache_v[layer, :, k0 : k0 + tk_blk].reshape(b, tk_blk, n_head, dh).double()
        ks = k_scale[layer, :, k0 : k0 + tk_blk][:, None, None, :]
        vs = v_scale[layer, :, k0 : k0 + tk_blk][:, None, None, :]
        s32 = torch.einsum("bghd,bkhd->bghk", qi, kb).float()
        sc = s32 * sq_scale * ks
        masked = (valid >= 0) & (torch.arange(k0, k0 + tk_blk, device=q.device) > valid)
        sc = torch.where(masked, _NEG_INF, sc)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        p = torch.where(masked, 0.0, torch.exp(sc - m_new))
        correction = torch.exp(m - m_new)
        l = correction * l + p.sum(dim=-1, keepdim=True)
        m = m_new
        pv = p * vs
        sp = int8_step(pv.amax(dim=-1, keepdim=True), 1e-30)
        x = pv / sp
        pi = torch.round(x).double()
        o32 = torch.einsum("bghk,bkhd->bghd", pi, vb).float()
        acc = acc * correction + o32 * sp
        if return_flip_bound:
            near = ((x - x.floor() - 0.5).abs() < _FLIP_MARGIN).double()
            flip = flip * correction + torch.einsum("bghk,bkhd->bghd", near, vb.abs()).float() * sp
    safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / safe).to(q.dtype).reshape(b * group, 1, d)
    if return_flip_bound:
        return out, (flip / safe).reshape(b * group, 1, d)
    return out


def decode_attention_i8(
    q: torch.Tensor, cache_k: torch.Tensor, k_scale: torch.Tensor, cache_v: torch.Tensor,
    v_scale: torch.Tensor, layer: int, n_head: int,
    *, scale: float, valid_upto: Optional[int] = None, group: int = 1,
) -> torch.Tensor:
    """K1 wrapper: int8-KV variant of decode_attention, same contract."""
    if q.device.type == "cpu":
        return decode_attention_i8_plain(
            q, cache_k, k_scale, cache_v, v_scale, layer, n_head,
            scale=scale, valid_upto=valid_upto, group=group,
        )
    if not q.is_cuda:
        raise ValueError(f"decode_attention_i8: unsupported device {q.device}")
    n_layer, b, tk, d = cache_k.shape
    blocks = _i8_blocks(b, tk, d)
    if blocks is None:
        raise ValueError(f"decode_attention_i8: unsupported int8 geometry b={b} tk={tk} d={d}")
    if q.dtype not in (torch.bfloat16, torch.float32) or cache_k.dtype != torch.int8 or cache_v.dtype != torch.int8:
        raise TypeError(f"decode_attention_i8 kernel takes bf16/fp32 q and int8 caches, got {q.dtype}/{cache_k.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("decode_attention_i8: row scales must be float32")
    if (q.shape != (b * group, 1, d) or cache_v.shape != cache_k.shape or d != n_head * 64
            or k_scale.shape != (n_layer, b, tk) or v_scale.shape != k_scale.shape):
        raise ValueError(f"decode_attention_i8: bad shapes q={tuple(q.shape)} cache={tuple(cache_k.shape)}")
    if not all(t.is_contiguous() for t in (cache_k, cache_v, k_scale, v_scale)):
        raise ValueError("decode_attention_i8: caches and scales must be contiguous")
    q = q.contiguous()
    out = torch.empty_like(q)
    fn = "decode_attn_i8_bf16" if q.dtype == torch.bfloat16 else "decode_attn_i8_f32"
    code = getattr(_cuda.lib("decode_attention"), fn)(
        q.data_ptr(), cache_k.data_ptr(), k_scale.data_ptr(), cache_v.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), int(layer), n_layer, b, group, tk, d, n_head, blocks[1], _valid(valid_upto),
        float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check("decode_attention", fn, code)
    LAUNCHES["decode_attention_i8"] += 1
    return out
