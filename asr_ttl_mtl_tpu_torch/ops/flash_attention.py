"""Flash attention kernels K3, K5, K6, K7 and K8 (`csrc/flash_attention.cu`),
their plain PyTorch versions, and the autograd Functions that train through
them.

Counterparts in `asr_ttl_mtl_tpu/ops/flash_attention.py`:

* K3 `flash_attention_h2` (:562; `_h2_fwd_kernel` :514, `_h2_fwd_kernel_lse`
  :552): non-causal multi-head attention over natural (B, T, D) projections,
  with the logsumexp for training, lse (D//128, B, Tq, hpb) fp32 where head
  h = lane * hpb + j;
* K5 `flash_attention_mh` (:401; `_flash_mh_kernel` :346): non-causal
  attention over the natural layout for the shapes `h2_eligible` rejects
  (`mh_flash_eligible`: d <= 768, a head width that is a multiple of 8,
  at most 2048 keys), without the logsumexp;
* K6 `flash_attention_h2_bwd` (:756): its FA2 backward;
* K7 `flash_attention` (:211) and `flash_attention_bhtd` (:309): head-split
  (BH, T, dh) attention with causal / q_offset / kv_valid_len masks, with
  the logsumexp (BH, Tq, 1) for training;
* K8 `flash_attention_bwd` (:1095): its FA2 backward;
* `FlashAttentionH2Fn` and `FlashAttentionFn`, the autograd Functions of
  K3 and K7: the forward keeps the logsumexp, the backward is the kernel.
  delta = rowsum(dO * O) is plain PyTorch, as the JAX package leaves it to
  XLA;
* `flash_attention_mh_vjp` (:852) and `flash_attention_vjp` (:1181), which
  pick among them as the JAX package does.

The CUDA kernels take bf16 or fp32 (every tensor of a call in one dtype;
`ops.kernel_dtype` picks the C symbol, `_bf16` or `_f32`, and fp32 launches
count under their own keys, e.g. `flash_attention_h2_f32`). The forwards
without the logsumexp (K3, K5, K7: the serving path's) also take fp16,
on the bf16 kernels' fp16 twins (`_f16`, counted as `<name>_f16`); K3-lse,
K6, K7-lse and K8 raise for fp16 until the fp16 training slice. K3 and K6 take
head widths 32, 64 and 128 in bf16 and in fp32 (`ops.WIDTH_CLASSES`, as
the JAX package's `h2_eligible`); K5 every multiple of 8 up to 768 in
both (as `mh_flash_eligible`), and K7, K7-lse and K8 every width from 1 to
768 (`ops.forward_width`): a width off a multiple of 8 is laid out at
`ops.kernel_width(dh)` (dh rounded up to 8) with zero columns, which add
exact zeros to q.k and to dO.v, and the extra columns of the outputs are
dropped. Up to 128 a kernel runs at the width class
`ops.width_class(dh)` with the columns past dh zeros (the bf16 K5 on the
route `k5_plan` gives: K3's forward at 32, 64 and 128 and, over per-head
tensor maps, at the class of the other widths up to 120), and from 136 on
the wide kernels, 128 output columns a CTA (the forwards: bf16 route B,
whose plan `k5_plan` mirrors for K5 and K7 alike, and fp32 `f32_wide_plan`;
K8's backward: `k8_wide_plan` in bf16, `f32_k8_wide_plan` in fp32). The h2
residuals hold 128 // dh heads a lane: hpb 4, 2 and 1.
On the card nothing falls back to a plain version or to a kernel of another
dtype: a shape, width or dtype no kernel serves raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import (WIDE_MAX_HEAD_WIDTH, WIDTH_CLASSES, _cuda, check_class_width, count_launch, dtype_label,
               forward_width, kernel_dtype, kernel_width, on_card, width_class)

_NEG_INF = -1e30
_MH_MAX_D = WIDE_MAX_HEAD_WIDTH  # the widest d (and head width) K5 serves
K5_SMEM_MAX = 232448  # a block's shared memory on the H100 (227 KB)
_BM = 64  # query rows a consumer warpgroup owns
_SLAB = 128  # output columns a route-B CTA owns


def h2_eligible(tq: int, tk: int, d: int, n_head: int) -> bool:
    """Shapes the head-pair kernel serves (same rule as the JAX package)."""
    if n_head <= 0 or d % n_head:
        return False
    dh = d // n_head
    return dh in (32, 64, 128) and d % 128 == 0 and tq >= 16 and tk <= 4096


def mh_flash_eligible(tq: int, tk: int, d: int, n_head: int, causal: bool) -> bool:
    """Shapes the per-head natural-layout kernel K5 serves (same rule as the
    JAX package)."""
    return (
        not causal
        and d <= _MH_MAX_D
        and d % n_head == 0
        and (d // n_head) % 8 == 0
        and tq >= 16
        and tk <= 2048
    )


class K5Plan(NamedTuple):
    route: str  # "class" (K3's forward over its 3-D maps), "A" (K3's at the class, head maps) or "B" (wide)
    width: int  # the width class the forward runs at; route B: the output slabs a head, ceil(dh / 128)
    rows: int  # query rows a CTA
    keys: int  # keys a K / V tile
    stages: int  # K / V stages in the ring
    smem: int  # shared bytes a CTA, the 1024-byte alignment slack included


def _fwd_smem(cls: int, wg: int, stages: int, keys: int) -> int:
    """sizeof(Smem<cls, wg, stages>) + 1024 in `csrc/flash_attention.cu`:
    Q, the K and V stages (each 1024-byte aligned), the mbarriers, the whole
    rounded up to 1024 bytes."""
    raw = wg * _BM * cls * 2 + 2 * stages * keys * cls * 2 + 8 * (1 + 3 * stages)
    return -(-raw // 1024) * 1024 + 1024


def k5_plan(dh: int, tq: int) -> K5Plan:
    """The bf16 (and fp16) K5's route at head width dh and tq queries, as
    `flash_mh_fwd_bf16` takes it (`flash_mh_plan_bf16` in C gives the same;
    the fp16 twin, `flash_mh_plan_f16`, the same again).
    Up to 128: K3's forward at the width class, 64 query rows a CTA where
    tq <= 64 (2 stages) else 128 (4), keys a tile 64 at class 128 else 128;
    over the 3-D maps at a class itself, over the head maps below one
    (route A). From 136 to 768 (route B): the head's Q and K rows in
    64-column boxes, 128 rows a CTA where they fit in 4 boxes and tq > 64
    else 64, 64-key tiles up to 6 boxes else 32 (K7's bf16 forward takes
    the same plan above 128), and as many stages, up to
    4, as K5_SMEM_MAX holds beside Q. Raises for any other width."""
    if dh < 8 or dh > _MH_MAX_D or dh % 8:
        raise ValueError(f"flash_attention_mh kernel takes a head width that is a multiple of 8 up to "
                         f"{_MH_MAX_D}, got {dh}")
    if dh <= WIDTH_CLASSES[-1]:
        cls = width_class(dh)
        wg, stages = (1, 2) if tq <= _BM else (2, 4)
        keys = 64 if cls == 128 else 128
        return K5Plan("class" if cls == dh else "A", cls, wg * _BM, keys, stages, _fwd_smem(cls, wg, stages, keys))
    boxes = -(-dh // 64)
    wg = 2 if boxes <= 4 and tq > _BM else 1
    keys = 64 if boxes <= 6 else 32
    q_bytes, stage = wg * _BM * boxes * 128, keys * (boxes + _SLAB // 64) * 128
    stages = min(4, (K5_SMEM_MAX - 1024 - 8 * (1 + 3 * 4) - q_bytes) // stage)
    return K5Plan("B", -(-dh // _SLAB), wg * _BM, keys, stages, 1024 + q_bytes + stages * stage + 8 * (1 + 3 * stages))


def _check_wide(name: str, dh: int) -> None:
    if dh <= WIDTH_CLASSES[-1] or dh > WIDE_MAX_HEAD_WIDTH or dh % 8:
        raise ValueError(f"{name} takes a head width that is a multiple of 8 from {WIDTH_CLASSES[-1] + 8} to "
                         f"{WIDE_MAX_HEAD_WIDTH}, got {dh}")


class F32WidePlan(NamedTuple):
    rows: int  # query rows a CTA, 16 a warp
    keys: int  # keys a K / V tile
    slabs: int  # output slabs of 128 columns a head
    smem: int  # dynamic shared bytes a CTA


_F32_WIDE_KEYS = 16


def f32_wide_plan(dh: int) -> F32WidePlan:
    """The fp32 wide forward's plan at head width dh (136-768), as
    `flash_wide_plan_f32` in C gives it: Q of the CTA's rows and two stages
    of 16 keys (K over the head's columns, V over the slab's 128) in shared
    memory, rows dh rounded up to 32 plus 8 floats apart (V 132); 64 rows
    where that fits in K5_SMEM_MAX, else 32. Raises for any other width."""
    _check_wide("the fp32 wide forward", dh)
    stride = -(-dh // 32) * 32 + 8
    stages = 2 * _F32_WIDE_KEYS * (stride + _SLAB + 4) * 4
    rows = 64 if 64 * stride * 4 + stages <= K5_SMEM_MAX else 32
    return F32WidePlan(rows, _F32_WIDE_KEYS, -(-dh // _SLAB), rows * stride * 4 + stages)


class K8WidePlan(NamedTuple):
    slabs: int  # output slabs of 128 columns a head
    dq_keys: int  # keys a K / V box of the dq kernel (64 query rows a CTA)
    dq_stages: int  # K / V box stages of the dq kernel
    dq_smem: int  # its shared bytes, the 1024-byte alignment slack included
    dkv_queries: int  # queries a Q / dO box of the dk/dv kernel (64 keys a CTA)
    dkv_stages: int  # Q / dO box stages of the dk/dv kernel
    dkv_smem: int


_WIDE_BWD_STAGES = 4  # the stages the mbarriers are laid out for
_WIDE_BWD_BARS = 8 * (1 + 2 * _WIDE_BWD_STAGES + 2)
_WIDE_DKV_QUERIES = 32
_RES_ROW = 64  # floats of a tile's lse (delta) row in shared memory: 32 queries + 4, rounded up to 32


def k8_wide_plan(dh: int) -> K8WidePlan:
    """K8's bf16 plan at head width dh (136-768), as `flash_wide_bwd_plan_bf16`
    in C gives it: one consumer warpgroup of 64 rows; the own operands (Q and
    dO, or K and V) resident in 64-column boxes, the other side streamed a
    box at a time through the stages, the slab's operand in a buffer of its
    own (dk/dv: with the tile's lse and delta). The dq kernel's K / V boxes
    hold 64 keys where two stages of them fit, else 32; each kernel as many
    stages, up to 4, as K5_SMEM_MAX holds. Raises for any other width."""
    _check_wide("K8's wide backward", dh)
    own = 2 * -(-dh // 64) * _BM * 128

    def smem(stage, stages, slab):
        return 1024 + own + stages * stage + slab + _WIDE_BWD_BARS

    def stages(stage, slab):
        return min(_WIDE_BWD_STAGES, (K5_SMEM_MAX - smem(0, 0, slab)) // stage)

    keys = 64 if stages(2 * 64 * 128, 2 * 64 * 128) >= 2 else 32
    kv = 2 * keys * 128
    qg = 2 * _WIDE_DKV_QUERIES * 128
    slab = 2 * qg + 2 * _RES_ROW * 4
    dq_stages, dkv_stages = stages(kv, kv), stages(qg, slab)
    return K8WidePlan(-(-dh // _SLAB), keys, dq_stages, smem(kv, dq_stages, kv), _WIDE_DKV_QUERIES, dkv_stages,
                      smem(qg, dkv_stages, slab))


class F32K8WidePlan(NamedTuple):
    rows: int  # own rows a CTA (queries in the dq kernel, keys in the dk/dv kernel), 16 a warp
    keys: int  # keys (queries) a streamed tile
    slabs: int  # output slabs of 128 columns a head
    smem: int  # dynamic shared bytes of either kernel


_F32_WIDE_STAGE_F = 2 * _F32_WIDE_KEYS * (64 + 8)  # a stage: two operands' chunks of 64 columns, rows 72 floats


def f32_k8_wide_plan(dh: int) -> F32K8WidePlan:
    """K8's fp32 plan at head width dh (136-768), as `flash_wide_bwd_plan_f32`
    in C gives it: the own operands of the CTA's rows resident, rows dh
    rounded up to 32 plus 8 floats apart, beside two stages of 16 rows x
    (two 64-column chunks, or one 128-column slab) and two tiles' lse and
    delta; 64 rows where that fits in K5_SMEM_MAX, else 32. Raises for any
    other width."""
    _check_wide("K8's fp32 wide backward", dh)
    stride = -(-dh // 32) * 32 + 8
    rest = (2 * _F32_WIDE_STAGE_F + 4 * _F32_WIDE_KEYS) * 4
    rows = 64 if 2 * 64 * stride * 4 + rest <= K5_SMEM_MAX else 32
    return F32K8WidePlan(rows, _F32_WIDE_KEYS, -(-dh // _SLAB), 2 * rows * stride * 4 + rest)


def _kv_len(tk: int, kv_valid_len: Optional[int]) -> int:
    return tk if kv_valid_len is None else min(kv_valid_len, tk)


def _split(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(B, T, D) -> (B, H, T, dh)"""
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """(B, H, T, dh) -> (B, T, D)"""
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _res_to_bht(r: torch.Tensor, n_head: int) -> torch.Tensor:
    """h2 residual (D//128, B, Tq, hpb) -> (B, H, Tq)"""
    n_lane, b, tq, hpb = r.shape
    return r.permute(1, 0, 3, 2).reshape(b, n_lane * hpb, tq)


def _bht_to_res(x: torch.Tensor, d: int) -> torch.Tensor:
    """(B, H, Tq) -> h2 residual (D//128, B, Tq, hpb)"""
    b, h, tq = x.shape
    n_lane = d // 128
    return x.reshape(b, n_lane, h // n_lane, tq).permute(1, 0, 3, 2).contiguous()


def h2_delta(g: torch.Tensor, out: torch.Tensor, n_head: int) -> torch.Tensor:
    """delta_h = rowsum(dO_h * O_h) in the h2 residual layout (D//128, B, Tq, hpb)."""
    b, tq, d = out.shape
    dh = d // n_head
    return (
        (g.float() * out.float())
        .reshape(b, tq, d // 128, 128 // dh, dh)
        .sum(-1)
        .permute(2, 0, 1, 3)
        .contiguous()
    )


def _mask(tq: int, tk: int, kv_len: int, causal: bool, q_offset: int, device) -> torch.Tensor:
    """(Tq, Tk) bool: keys < kv_len and, if causal, key <= q_offset + query."""
    k_pos = torch.arange(tk, device=device)
    mask = (k_pos < kv_len)[None, :].expand(tq, tk)
    if causal:
        q_pos = q_offset + torch.arange(tq, device=device)
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    return mask


def _fwd_plain(q, k, v, mask, scale):
    """(..., Tq, dh) attention in fp32 with p cast to v's dtype for p.V;
    rows with no valid key give 0 and lse -1e30. Returns (out, lse (..., Tq, 1))."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe = torch.where(l == 0.0, 1.0, l)
    out = ((p.to(v.dtype).float() @ v.float()) / safe).to(v.dtype)
    lse = torch.where(l == 0.0, _NEG_INF, m + torch.log(safe))
    return out, lse


def _bwd_plain(q, k, v, g, lse, delta, mask, scale):
    """FA2 backward over (..., T, dh) from lse and delta (..., Tq, 1), with
    the TPU kernels' rounding: dS is cast to k's (q's) dtype before dS.K
    (dS^T.Q), p to dO's dtype before P^T.dO."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse), 0.0)
    dp = g.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta) * scale
    dq = (ds.to(k.dtype).float() @ k.float()).to(q.dtype)
    dk = (ds.to(q.dtype).float().transpose(-1, -2) @ q.float()).to(k.dtype)
    dv = (p.to(g.dtype).float().transpose(-1, -2) @ g.float()).to(v.dtype)
    return dq, dk, dv


def _check(name: str, tensors, shapes) -> str:
    """The CUDA wrappers take contiguous tensors of the given shapes on one
    device, all bf16, all fp32 or (the kernels `ops.F16_KERNELS` names) all
    fp16; returns the symbol suffix. `name` is the kernel as counted."""
    sfx = kernel_dtype(name, tensors)
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
    return sfx


def _h2_width(name: str, d: int, n_head: int, sfx: str, lanes: bool) -> int:
    """The head width of a natural-layout call that K3 / K6 serve: d split
    into equal heads of a width in WIDTH_CLASSES and, with `lanes` (the h2
    residuals), a multiple of 128."""
    if n_head < 1 or d % n_head or (lanes and d % 128):
        raise ValueError(f"{name} kernel takes d split into equal heads{' and a multiple of 128' if lanes else ''}, "
                         f"got d={d} n_head={n_head}")
    check_class_width(name, d // n_head, sfx)
    return d // n_head


def _check_res(name: str, tensors, shape) -> None:
    for t in tensors:
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous fp32 {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


# ---------------------------------------------------------------------------
# K3 / K6: natural (B, T, D) layout, non-causal
# ---------------------------------------------------------------------------


def flash_attention_h2_plain(q, k, v, *, n_head: int, kv_valid_len: Optional[int] = None,
                             scale: float = 1.0, return_lse: bool = False):
    """Plain PyTorch K3: fp32 scores x scale, keys >= kv_valid_len masked,
    p cast to v's dtype for p.V, divided by the fp32 row sum."""
    b, tq, d = q.shape
    tk = k.shape[1]
    mask = _mask(tq, tk, _kv_len(tk, kv_valid_len), False, 0, q.device)
    out, lse = _fwd_plain(_split(q, n_head), _split(k, n_head), _split(v, n_head), mask, scale)
    out = _merge(out)
    return (out, _bht_to_res(lse[..., 0], d)) if return_lse else out


def flash_attention_h2(q, k, v, *, n_head: int, kv_valid_len: Optional[int] = None,
                       scale: float = 1.0, return_lse: bool = False):
    """K3 wrapper: q (B, Tq, D), k and v (B, Tk, D) -> (B, Tq, D) in v's
    dtype (bf16, fp16 or fp32), plus lse (D//128, B, Tq, hpb) fp32 with
    return_lse (bf16 or fp32)."""
    if not on_card("flash_attention_h2", q):
        return flash_attention_h2_plain(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len,
                                        scale=scale, return_lse=return_lse)
    b, tq, d = q.shape
    tk = k.shape[1]
    sfx = _check("flash_attention_h2_lse" if return_lse else "flash_attention_h2", (q, k, v),
                 ((b, tq, d), (b, tk, d), (b, tk, d)))
    dh = _h2_width("flash_attention_h2", d, n_head, sfx, return_lse)
    out = torch.empty_like(q)
    lse = torch.empty((d // 128, b, tq, 128 // dh), dtype=torch.float32, device=q.device) if return_lse else None
    fn, lib = f"flash_h2_fwd_{sfx}", _cuda.source("flash_attention", sfx)
    code = getattr(_cuda.lib(lib), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        b, tq, tk, d, n_head, _kv_len(tk, kv_valid_len), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check(lib, fn, code)
    count_launch("flash_attention_h2_lse" if return_lse else "flash_attention_h2", sfx)
    return (out, lse) if return_lse else out


def flash_attention_h2_bwd_plain(q, k, v, lse, delta, g, *, n_head: int,
                                 kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """Plain PyTorch K6: (dq, dk, dv) from lse and delta (D//128, B, Tq, hpb)."""
    tq, tk = q.shape[1], k.shape[1]
    mask = _mask(tq, tk, _kv_len(tk, kv_valid_len), False, 0, q.device)
    dq, dk, dv = _bwd_plain(
        _split(q, n_head), _split(k, n_head), _split(v, n_head), _split(g, n_head),
        _res_to_bht(lse, n_head)[..., None], _res_to_bht(delta, n_head)[..., None], mask, scale,
    )
    return _merge(dq), _merge(dk), _merge(dv)


def flash_attention_h2_bwd(q, k, v, lse, delta, g, *, n_head: int,
                           kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """K6 wrapper: (dq, dk, dv) of K3, dk and dv zero at keys >= kv_valid_len."""
    if not on_card("flash_attention_h2_bwd", q):
        return flash_attention_h2_bwd_plain(q, k, v, lse, delta, g, n_head=n_head,
                                            kv_valid_len=kv_valid_len, scale=scale)
    b, tq, d = q.shape
    tk = k.shape[1]
    sfx = _check("flash_attention_h2_bwd", (q, k, v, g), ((b, tq, d), (b, tk, d), (b, tk, d), (b, tq, d)))
    dh = _h2_width("flash_attention_h2_bwd", d, n_head, sfx, True)
    _check_res("flash_attention_h2_bwd", (lse, delta), (d // 128, b, tq, 128 // dh))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = f"flash_h2_bwd_{sfx}"
    code = getattr(_cuda.lib("flash_attention"), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, tk, d, n_head, _kv_len(tk, kv_valid_len), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check("flash_attention", fn, code)
    count_launch("flash_attention_h2_bwd", sfx)
    return dq, dk, dv


class FlashAttentionH2Fn(torch.autograd.Function):
    """Differentiable K3: the forward keeps the logsumexp, the backward is K6."""

    @staticmethod
    def forward(ctx, q, k, v, n_head, kv_valid_len, scale):
        out, lse = flash_attention_h2(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len,
                                      scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = (n_head, kv_valid_len, scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        n_head, kv_valid_len, scale = ctx.cfg
        g = g.contiguous()
        dq, dk, dv = flash_attention_h2_bwd(q, k, v, lse, h2_delta(g, out, n_head), g, n_head=n_head,
                                            kv_valid_len=kv_valid_len, scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention_h2_vjp(q, k, v, n_head: int, kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """K3 through autograd when a gradient is wanted, else the plain K3 forward."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionH2Fn.apply(q, k, v, n_head, kv_valid_len, scale)
    return flash_attention_h2(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len, scale=scale)


# ---------------------------------------------------------------------------
# K5: natural (B, T, D) layout, non-causal, any head width K5 serves
# ---------------------------------------------------------------------------


def flash_attention_mh_plain(q, k, v, *, n_head: int, kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """Plain PyTorch K5: per head, fp32 scores x scale, keys >= kv_valid_len
    masked, p cast to v's dtype for p.V, divided by the fp32 row sum."""
    tq, tk = q.shape[1], k.shape[1]
    mask = _mask(tq, tk, _kv_len(tk, kv_valid_len), False, 0, q.device)
    out, _ = _fwd_plain(_split(q, n_head), _split(k, n_head), _split(v, n_head), mask, scale)
    return _merge(out)


def flash_attention_mh(q, k, v, *, n_head: int, kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """K5 wrapper: q (B, Tq, D), k and v (B, Tk, D) -> (B, Tq, D) in v's
    dtype, softmax(scale q_h k_h^T) v_h per head h (columns h*dh ..)."""
    if not on_card("flash_attention_mh", q):
        return flash_attention_mh_plain(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len, scale=scale)
    b, tq, d = q.shape
    tk = k.shape[1]
    sfx = _check("flash_attention_mh", (q, k, v), ((b, tq, d), (b, tk, d), (b, tk, d)))
    if n_head < 1 or d % n_head:
        raise ValueError(f"flash_attention_mh kernel takes d split into equal heads, got d={d} n_head={n_head}")
    if sfx == "f32":  # multiples of 8 up to 768: the class up to 128, the wide forward above
        if (d // n_head) % 8 or not 8 <= d // n_head <= _MH_MAX_D:  # as `mh_flash_eligible`
            raise ValueError(f"flash_attention_mh fp32 kernel takes a head width that is a multiple of 8 from 8 to "
                             f"{_MH_MAX_D}, got {d // n_head}")
    else:
        k5_plan(d // n_head, tq)
    out = torch.empty_like(q)
    fn, lib = f"flash_mh_fwd_{sfx}", _cuda.source("flash_attention", sfx)
    code = getattr(_cuda.lib(lib), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, tq, tk, d, n_head, _kv_len(tk, kv_valid_len), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check(lib, fn, code)
    count_launch("flash_attention_mh", sfx)
    return out


def flash_attention_mh_vjp(q, k, v, n_head: int, kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """Non-causal natural-layout attention, dispatched as JAX
    `flash_attention_mh_vjp` (:852-927): the K3 pair (K3 with lse, K6) for
    the shapes `h2_eligible` serves; otherwise K5 when no gradient is
    wanted, and under autograd K7 with lse and K8 over split heads."""
    b, tq, d = q.shape
    tk = k.shape[1]
    if h2_eligible(tq, tk, d, n_head):
        return flash_attention_h2_vjp(q, k, v, n_head, kv_valid_len, scale)
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        return flash_attention_mh(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len, scale=scale)
    dh = d // n_head

    def split(x, t):
        return _split(x, n_head).reshape(b * n_head, t, dh).contiguous()

    out = FlashAttentionFn.apply(split(q, tq), split(k, tk), split(v, tk), False, 0, kv_valid_len, scale)
    return _merge(out.reshape(b, n_head, tq, dh))


# ---------------------------------------------------------------------------
# K7 / K8: head-split (BH, T, dh), causal / q_offset / kv_valid_len
# ---------------------------------------------------------------------------


def flash_attention_plain(q, k, v, *, causal: bool = False, q_offset: int = 0,
                          kv_valid_len: Optional[int] = None, scale: float = 1.0,
                          return_lse: bool = False):
    """Plain PyTorch K7: (BH, Tq, dh) -> (BH, Tq, dh), plus lse (BH, Tq, 1)."""
    tq, tk = q.shape[1], k.shape[1]
    mask = _mask(tq, tk, _kv_len(tk, kv_valid_len), causal, q_offset, q.device)
    out, lse = _fwd_plain(q, k, v, mask, scale)
    return (out, lse) if return_lse else out


def flash_attention(q, k, v, *, causal: bool = False, q_offset: int = 0,
                    kv_valid_len: Optional[int] = None, scale: float = 1.0, return_lse: bool = False):
    """K7 wrapper: softmax(scale q k^T + mask) v over flattened (batch*heads)
    in bf16, fp16 or fp32, plus lse (BH, Tq, 1) fp32 with return_lse (bf16
    or fp32). Head widths up to 128 run at
    their width class, 129-768 on the wide forward of q's dtype; a width off
    a multiple of 8 is copied out at `kernel_width(dh)` first (`_padded`)."""
    if not on_card("flash_attention", q):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
                                     scale=scale, return_lse=return_lse)
    bh, tq, dh = q.shape
    tk = k.shape[1]
    sfx = _check("flash_attention_lse" if return_lse else "flash_attention", (q, k, v),
                 ((bh, tq, dh), (bh, tk, dh), (bh, tk, dh)))
    forward_width(dh, f"flash_attention {dtype_label(sfx)}")
    q, k, v = _padded((q, k, v))
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device) if return_lse else None
    fn, lib = f"flash_fwd_{sfx}", _cuda.source("flash_attention", sfx)
    code = getattr(_cuda.lib(lib), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        bh, tq, tk, q.shape[2], _kv_len(tk, kv_valid_len), int(causal), int(q_offset), float(scale),
        _cuda.stream_handle(q.device),
    )
    _cuda.check(lib, fn, code)
    count_launch("flash_attention_lse" if return_lse else "flash_attention", sfx)
    out = _unpadded(out, dh)
    return (out, lse) if return_lse else out


def flash_attention_bhtd(q, k, v, **kwargs):
    """K7 over the head-split (B, H, T, dh) layout."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    out = flash_attention(q.reshape(b * h, tq, d), k.reshape(b * h, tk, d), v.reshape(b * h, tk, d), **kwargs)
    return out.reshape(b, h, tq, d)


def flash_attention_bwd_plain(q, k, v, out, lse, g, *, causal: bool = False, q_offset: int = 0,
                              kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """Plain PyTorch K8: (dq, dk, dv) of K7 from its output and lse."""
    tq, tk = q.shape[1], k.shape[1]
    mask = _mask(tq, tk, _kv_len(tk, kv_valid_len), causal, q_offset, q.device)
    delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
    return _bwd_plain(q, k, v, g, lse, delta, mask, scale)


def flash_attention_bwd(q, k, v, out, lse, g, *, causal: bool = False, q_offset: int = 0,
                        kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """K8 wrapper: (dq, dk, dv) of K7; delta = rowsum(dO * O) in PyTorch.
    Head widths up to 128 run at their width class, 129-768 on the wide
    backward of q's dtype; a width off a multiple of 8 is copied out at
    `kernel_width(dh)` first (`_padded`)."""
    if not on_card("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal, q_offset=q_offset,
                                         kv_valid_len=kv_valid_len, scale=scale)
    bh, tq, dh = q.shape
    tk = k.shape[1]
    sfx = _check("flash_attention_bwd", (q, k, v, out, g),
                 ((bh, tq, dh), (bh, tk, dh), (bh, tk, dh), (bh, tq, dh), (bh, tq, dh)))
    forward_width(dh, f"flash_attention_bwd {dtype_label(sfx)}")
    delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
    _check_res("flash_attention_bwd", (lse, delta), (bh, tq, 1))
    q, k, v, g = _padded((q, k, v, g))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fn = f"flash_bwd_{sfx}"
    code = getattr(_cuda.lib("flash_attention"), fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, tq, tk, q.shape[2], _kv_len(tk, kv_valid_len), int(causal), int(q_offset), float(scale),
        _cuda.stream_handle(q.device),
    )
    _cuda.check("flash_attention", fn, code)
    count_launch("flash_attention_bwd", sfx)
    return _unpadded(dq, dh), _unpadded(dk, dh), _unpadded(dv, dh)


def _padded(tensors):
    """(BH, T, dh) tensors laid out at `kernel_width(dh)`, zeros past dh:
    the kernels of K7's range read rows whose width is a multiple of 8. The
    zero columns add exact zeros to q.k and to dO.v, so the dh columns of
    every output are what the kernel gives at a served width; the rest are
    zeros, which `_unpadded` drops."""
    dh = tensors[0].shape[-1]
    width = kernel_width(dh)
    return tuple(t if width == dh else torch.nn.functional.pad(t, (0, width - dh)) for t in tensors)


def _unpadded(x: torch.Tensor, dh: int) -> torch.Tensor:
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable K7: the forward keeps the logsumexp, the backward is K8."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, kv_valid_len, scale):
        out, lse = flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
                                   scale=scale, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.cfg = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g.contiguous(), **ctx.cfg)
        return dq, dk, dv, None, None, None, None


def flash_attention_vjp(q, k, v, causal: bool = False, q_offset: int = 0,
                        kv_valid_len: Optional[int] = None, scale: float = 1.0):
    """K7 through autograd when a gradient is wanted, else the plain K7 forward."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, q_offset, kv_valid_len, scale)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len, scale=scale)
