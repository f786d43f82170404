"""K1 and K2: single-token decode attention over a layer of the stacked
(L, B, Tk, D) KV caches (kernels in `csrc/decode_attention.cu`), their plain
versions, and the int8 cache helpers.

Counterpart of `asr_ttl_mtl_tpu/ops/decode_attention.py`:
`decode_attention` (:94, K2) on bf16 or fp32 caches, `decode_attention_i8`
(:329, K1) on int8 caches with fp32 row scales, `quantize_kv_rows` (:159)
and the int8 block geometry `_i8_blocks` / `i8_supported` (:294-323).

K1's numbers depend on its key-block size: p is quantized to int8 per
(row, block) relative to the running max. The block size `tk_blk` therefore
comes from `_i8_blocks`, as on the TPU, and the plain version walks the
blocks in order. The kernel splits the valid blocks of each (cache row,
head) across a thread-block cluster of S CTAs, each walking its chunk in
order from its own running max; `k1_plan` picks S and `k1_chunks` gives
each CTA's keys.

K2 splits the valid keys of each (cache row, head) across a thread-block
cluster of S CTAs; `k2_plan` picks S and `k2_chunks` gives each CTA's keys,
as the kernel cuts them.

Both kernels take every head width dh = d / n_head from 1 to 768, with
bf16, fp16 or fp32 q (and caches of q's dtype for K2): the kernel of width
class `ops.decode_class(dh)` (32, 64, 128, 256, 512 or 768) reads the dh
real columns of a head where they lie in the caches (in pieces of 16 bytes
down to 1, as the head's row bytes allow) and zero-fills the rest in
shared memory. Any other width (0, or above 768) raises on the card. A
launch with fp32 q counts under `<name>_f32`, one with fp16 q under
`<name>_f16` (its entries in the `decode_attention_f16` library).
`k2_smem_bytes` and `k1_smem_bytes` mirror the kernels' shared memory at
each class (the C entries `decode_smem_bytes` and `decode_i8_smem_bytes`
give the same; fp16 takes bf16's, both 2 bytes).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from . import _cuda, count_launch, decode_class, kernel_dtype

_NEG_INF = -1e30
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


def quantize_kv_rows(x: torch.Tensor, group=None):
    """(..., T, D) float -> ((..., T_pad, D) int8, (..., T_pad) fp32 scale),
    per-row abs-max scaling, T padded to a multiple of 128. The padded keys
    must be masked by the consumer (decode_attention_i8's valid_upto). Rows
    split over tp (`group`, a process group) take their absmax over it."""
    from ..parallel.comm import all_reduce_max

    t = x.shape[-2]
    t_pad = ((t + 127) // 128) * 128
    if t_pad != t:
        x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
    m = all_reduce_max(x.abs().amax(dim=-1).float(), group)
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


def _head_width(name: str, d: int, n_head: int) -> int:
    """The width class of d / n_head; raises unless the kernel serves it."""
    if n_head < 1 or d % n_head:
        raise ValueError(f"{name} kernel takes d split into equal heads, got d={d} n_head={n_head}")
    return decode_class(d // n_head, name)


# ------------------------------------------------------------------ K2 ----

# K2's launch plan; the constants mirror `csrc/decode_attention.cu`
_RESIDENT = 2 * 132  # K2 CTAs resident at once: 2 on each of an H100's 132 streaming multiprocessors
K2_SPLITS = (1, 2, 4, 8)  # cluster sizes; 8 is the portable limit
K2_MIN_KEYS = 64  # n_keys // S stays at least this, unless S is 1
_K2_TILE = 128  # keys a staged tile holds
_K2_THREADS = 128
_K2_ROW_CHUNK = 16
_K2_SMEM_LIMIT = 227 * 1024


def k2_n_valid(tk: int, valid_upto: Optional[int]) -> int:
    """Keys the kernel reads: [0, valid_upto] (all tk when None or -1)."""
    v = _valid(valid_upto)
    return tk if v < 0 else min(v + 1, tk)


def k2_cta_rows(group: int, dh: int) -> int:
    """Query rows a K2 CTA takes at width class dh: the whole group up to
    256; above, 16 once the group is larger (a CTA per 16-row chunk)."""
    return _K2_ROW_CHUNK if dh > 256 and group > _K2_ROW_CHUNK else group


def k2_smem_bytes(group: int, chunk: int, itemsize: int, dh: int = 64) -> int:
    """Shared memory of one K2 CTA (`k2_smem_bytes` in the source) of width
    class dh (32-768, `ops.decode_class`): the ring of staged tiles (4 bf16
    tiles at dh 32 and 64, 2 from 128 on, 2 of fp32; 64-key tiles of fp32
    at 256, and above 256 tiles of 32 bf16 keys or 16 fp32 ones), q, the
    chunk's scores, the P.V partials, the row statistics and the reduction
    buffer, for the CTA's `k2_cta_rows` query rows."""
    if dh > 256:
        tile = 32 if itemsize == 2 else 16
    else:
        tile = 64 if itemsize == 4 and dh == 256 else _K2_TILE
    group = k2_cta_rows(group, dh)
    ring = (2 if itemsize != 2 or dh >= 128 else 4) * tile * (dh * itemsize + 16)
    slices = _K2_THREADS // (8 * min(group, _K2_ROW_CHUNK))  # P.V: 8 threads a row, dh / 8 columns each
    stride = (chunk + 3) // 4 * 4
    return ring + 4 * (group * dh + group * stride + slices * group * dh + 4 * group + _K2_THREADS)


@functools.lru_cache(maxsize=4096)  # a decode step asks the same few questions every call
def k2_plan(batch: int, n_head: int, n_keys: int, group: int = 1, itemsize: int = 2, dh: int = 64) -> int:
    """S, the CTAs of K2's cluster for one (cache row, head, row chunk) over
    `n_keys` valid keys: the largest S in K2_SPLITS that keeps the grid
    (batch x n_head x row chunks x S) within the card's resident CTAs (2 a
    streaming multiprocessor), but no larger than keeps n_keys // S >=
    K2_MIN_KEYS; raised further only while the chunk's scores do not fit in
    shared memory. Raises when no S fits (up to the class of 256, a group of
    ~125 rows over 1500 keys). `dh` is the width class
    (`ops.decode_class`)."""
    by_keys = max(s for s in K2_SPLITS if s == 1 or n_keys // s >= K2_MIN_KEYS)
    ctas = batch * n_head * -(-group // k2_cta_rows(group, dh))
    fill = max(s for s in K2_SPLITS if s == 1 or ctas * s <= _RESIDENT)
    split = min(fill, by_keys)
    for s in K2_SPLITS:
        if s >= split and k2_smem_bytes(group, -(-n_keys // s), itemsize, dh) <= _K2_SMEM_LIMIT:
            return s
    raise ValueError(f"decode_attention: group {group} over {n_keys} keys needs more shared memory than a "
                     f"cluster of {K2_SPLITS[-1]} CTAs has")


def k2_chunks(n_keys: int, split: int):
    """[(lo, hi)] of the keys each CTA of the cluster reads, as the kernel cuts them."""
    chunk = -(-n_keys // split)
    return [(min(n_keys, r * chunk), min(n_keys, (r + 1) * chunk)) for r in range(split)]


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
    [b*group, (b+1)*group) of q attend over cache row b, any group in one
    launch. Keys past `valid_upto` are masked (None: all valid)."""
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, cache_k, cache_v, layer, n_head, scale=scale, valid_upto=valid_upto, group=group
        )
    if not q.is_cuda:
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    n_layer, b, tk, d = cache_k.shape
    kernel_dtype("decode_attention", (q, cache_k, cache_v))
    if q.shape != (b * group, 1, d) or cache_v.shape != cache_k.shape or group < 1:
        raise ValueError(f"decode_attention: bad shapes q={tuple(q.shape)} cache={tuple(cache_k.shape)} group={group}")
    _head_width("decode_attention", d, n_head)
    if not (cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("decode_attention: caches must be contiguous")
    return _launch_k2(q.contiguous(), cache_k, cache_v, layer, n_head, scale, valid_upto, group)


def _launch_k2(q, cache_k, cache_v, layer, n_head, scale, valid_upto, group) -> torch.Tensor:
    n_layer, b, tk, d = cache_k.shape
    split = k2_plan(b, n_head, k2_n_valid(tk, valid_upto), group, q.element_size(), decode_class(d // n_head))
    out = torch.empty_like(q)
    sfx = kernel_dtype("decode_attention", (q,))
    fn, lib = f"decode_attn_{sfx}", _cuda.source("decode_attention", sfx)
    code = getattr(_cuda.lib(lib), fn)(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), out.data_ptr(),
        int(layer), n_layer, b, group, tk, d, n_head, _valid(valid_upto), split, float(scale),
        _cuda.stream_handle(q.device),
    )
    _cuda.check(lib, fn, code)
    count_launch("decode_attention", sfx)
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


# K1's launch plan; the constants mirror `csrc/decode_attention.cu`
_K1_RESIDENT = 2 * 132  # K1 CTAs in one wave: 2 on each of an H100's 132 streaming multiprocessors
K1_MAX_SPLIT = 8  # CTAs a cluster: the portable limit
K1_ROWS = 16  # query rows a CTA takes; a larger group takes more clusters
_K1_TILE = 128  # keys a staged tile holds up to the class of 256


def k1_smem_bytes(rows: int, tk_blk: int, dh: int = 64) -> int:
    """Shared memory of one K1 CTA (`k1_smem_bytes` in the source) of width
    class dh (`ops.decode_class`) over `rows` query rows (at most K1_ROWS)
    and key blocks of tk_blk: the ring of staged int8 tiles of 128 keys (32
    above 256) with their k and v scales (4 deep, 2 from 256), the
    transposed V tile, q in int8, a block's fp32 scores and int8 p, its v
    scales and the row statistics."""
    row = dh + 16
    tile = _K1_TILE if dh <= 256 else 32
    ring = 2 if dh >= 256 else 4
    return (ring * (tile * row + 2 * tile * 4) + dh * (tile + 16) + K1_ROWS * row
            + 4 * rows * (tk_blk + 4) + K1_ROWS * (tk_blk + 16) + 4 * tk_blk + 4 * 5 * K1_ROWS)


def k1_n_blocks(tk: int, tk_blk: int, valid_upto: Optional[int]) -> int:
    """Key blocks of `tk_blk` that hold a valid key: the blocks K1 reads."""
    return -(-k2_n_valid(tk, valid_upto) // tk_blk)


@functools.lru_cache(maxsize=4096)
def k1_plan(batch: int, n_head: int, n_blocks: int, group: int = 1) -> int:
    """S, the CTAs of K1's cluster for one (cache row, head, 16 query rows)
    over `n_blocks` valid key blocks: as many as keep the grid within the
    card's resident CTAs, at most K1_MAX_SPLIT and at most one block a CTA;
    then as few as give the same longest chunk (ceil(n_blocks / S) blocks)."""
    ctas = batch * n_head * -(-group // K1_ROWS)
    split = max(1, min(K1_MAX_SPLIT, n_blocks, _K1_RESIDENT // ctas))
    return -(-n_blocks // -(-n_blocks // split))


def k1_chunks(n_keys: int, tk_blk: int, split: int):
    """[(lo, hi)] of the keys each CTA of K1's cluster reads, as the kernel
    cuts them: whole blocks of tk_blk, CTA r taking blocks
    [r * nb // S, (r + 1) * nb // S) of the nb blocks that hold keys < n_keys."""
    nb = -(-n_keys // tk_blk)
    return [(min(n_keys, (r * nb // split) * tk_blk), min(n_keys, ((r + 1) * nb // split) * tk_blk))
            for r in range(split)]


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
    kernel_dtype("decode_attention_i8", (q,))
    if cache_k.dtype != torch.int8 or cache_v.dtype != torch.int8:
        raise TypeError(f"decode_attention_i8 kernel takes int8 caches, got {cache_k.dtype}/{cache_v.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("decode_attention_i8: row scales must be float32")
    if (q.shape != (b * group, 1, d) or cache_v.shape != cache_k.shape
            or k_scale.shape != (n_layer, b, tk) or v_scale.shape != k_scale.shape):
        raise ValueError(f"decode_attention_i8: bad shapes q={tuple(q.shape)} cache={tuple(cache_k.shape)}")
    _head_width("decode_attention_i8", d, n_head)
    if not all(t.is_contiguous() for t in (cache_k, cache_v, k_scale, v_scale)):
        raise ValueError("decode_attention_i8: caches and scales must be contiguous")
    return _launch_k1(q.contiguous(), cache_k, k_scale, cache_v, v_scale, layer, n_head, scale, valid_upto, group,
                      blocks[1])


def _launch_k1(q, cache_k, k_scale, cache_v, v_scale, layer, n_head, scale, valid_upto, group, tk_blk):
    n_layer, b, tk, d = cache_k.shape
    split = k1_plan(b, n_head, k1_n_blocks(tk, tk_blk, valid_upto), group)
    out = torch.empty_like(q)
    sfx = kernel_dtype("decode_attention_i8", (q,))
    fn, lib = f"decode_attn_i8_{sfx}", _cuda.source("decode_attention", sfx)
    code = getattr(_cuda.lib(lib), fn)(
        q.data_ptr(), cache_k.data_ptr(), k_scale.data_ptr(), cache_v.data_ptr(), v_scale.data_ptr(),
        out.data_ptr(), int(layer), n_layer, b, group, tk, d, n_head, tk_blk, _valid(valid_upto), split,
        float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check(lib, fn, code)
    count_launch("decode_attention_i8", sfx)
    return out
