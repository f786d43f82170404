"""Flash attention kernels K3, K6, K7 and K8 (`csrc/flash_attention.cu`),
their plain PyTorch versions, and the autograd Functions that train through
them.

Counterparts in `asr_ttl_mtl_tpu/ops/flash_attention.py`:

* K3 `flash_attention_h2` (:562; `_h2_fwd_kernel` :514, `_h2_fwd_kernel_lse`
  :552): non-causal multi-head attention over natural (B, T, D) projections,
  with the logsumexp for training, lse (D//128, B, Tq, hpb) fp32 where head
  h = lane * hpb + j;
* K6 `flash_attention_h2_bwd` (:756): its FA2 backward;
* K7 `flash_attention` (:211) and `flash_attention_bhtd` (:309): head-split
  (BH, T, dh) attention with causal / q_offset / kv_valid_len masks, with
  the logsumexp (BH, Tq, 1) for training;
* K8 `flash_attention_bwd` (:1095): its FA2 backward;
* `FlashAttentionH2Fn` and `FlashAttentionFn`, the counterparts of
  `flash_attention_mh_vjp` (:852) and `flash_attention_vjp` (:1181): the
  forward keeps the logsumexp, the backward is the kernel. delta =
  rowsum(dO * O) is plain PyTorch, as the JAX package leaves it to XLA.

The per-head kernel K5 (`flash_attention_mh`, shapes `h2_eligible` rejects)
is not ported. The CUDA kernels take bf16 with a head width of 64.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import LAUNCHES, _cuda

_NEG_INF = -1e30
_DH = 64  # the head width the CUDA kernels serve


def h2_eligible(tq: int, tk: int, d: int, n_head: int) -> bool:
    """Shapes the head-pair kernel serves (same rule as the JAX package)."""
    if n_head <= 0 or d % n_head:
        return False
    dh = d // n_head
    return dh in (32, 64, 128) and d % 128 == 0 and tq >= 16 and tk <= 4096


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


def _check(name: str, tensors, shapes) -> None:
    """The CUDA wrappers take bf16, contiguous tensors of the given shapes on one device."""
    dev = tensors[0].device
    for t, shape in zip(tensors, shapes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} kernel takes bf16, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")


def _check_res(name: str, tensors, shape) -> None:
    for t in tensors:
        if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous fp32 {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (plain version); True for CUDA; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


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
    dtype, plus lse (D//128, B, Tq, hpb) fp32 with return_lse."""
    if not _on_card("flash_attention_h2", q):
        return flash_attention_h2_plain(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len,
                                        scale=scale, return_lse=return_lse)
    b, tq, d = q.shape
    tk = k.shape[1]
    if d != n_head * _DH:
        raise ValueError(f"flash_attention_h2 kernel takes a head width of {_DH}, got d={d} n_head={n_head}")
    _check("flash_attention_h2", (q, k, v), ((b, tq, d), (b, tk, d), (b, tk, d)))
    out = torch.empty_like(q)
    lse = torch.empty((d // 128, b, tq, 128 // _DH), dtype=torch.float32, device=q.device) if return_lse else None
    code = _cuda.lib("flash_attention").flash_h2_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        b, tq, tk, d, n_head, _kv_len(tk, kv_valid_len), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check("flash_attention", "flash_h2_fwd_bf16", code)
    LAUNCHES["flash_attention_h2_lse" if return_lse else "flash_attention_h2"] += 1
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
    if not _on_card("flash_attention_h2_bwd", q):
        return flash_attention_h2_bwd_plain(q, k, v, lse, delta, g, n_head=n_head,
                                            kv_valid_len=kv_valid_len, scale=scale)
    b, tq, d = q.shape
    tk = k.shape[1]
    if d != n_head * _DH:
        raise ValueError(f"flash_attention_h2_bwd kernel takes a head width of {_DH}, got d={d} n_head={n_head}")
    _check("flash_attention_h2_bwd", (q, k, v, g), ((b, tq, d), (b, tk, d), (b, tk, d), (b, tq, d)))
    _check_res("flash_attention_h2_bwd", (lse, delta), (d // 128, b, tq, 128 // _DH))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    code = _cuda.lib("flash_attention").flash_h2_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, tq, tk, d, n_head, _kv_len(tk, kv_valid_len), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check("flash_attention", "flash_h2_bwd_bf16", code)
    LAUNCHES["flash_attention_h2_bwd"] += 1
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
    """K7 wrapper: softmax(scale q k^T + mask) v over flattened (batch*heads),
    plus lse (BH, Tq, 1) fp32 with return_lse."""
    if not _on_card("flash_attention", q):
        return flash_attention_plain(q, k, v, causal=causal, q_offset=q_offset, kv_valid_len=kv_valid_len,
                                     scale=scale, return_lse=return_lse)
    bh, tq, d = q.shape
    tk = k.shape[1]
    _check("flash_attention", (q, k, v), ((bh, tq, _DH), (bh, tk, _DH), (bh, tk, _DH)))
    out = torch.empty_like(q)
    lse = torch.empty((bh, tq, 1), dtype=torch.float32, device=q.device) if return_lse else None
    code = _cuda.lib("flash_attention").flash_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(),
        bh, tq, tk, _kv_len(tk, kv_valid_len), int(causal), int(q_offset), float(scale),
        _cuda.stream_handle(q.device),
    )
    _cuda.check("flash_attention", "flash_fwd_bf16", code)
    LAUNCHES["flash_attention_lse" if return_lse else "flash_attention"] += 1
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
    """K8 wrapper: (dq, dk, dv) of K7; delta = rowsum(dO * O) in PyTorch."""
    if not _on_card("flash_attention_bwd", q):
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal=causal, q_offset=q_offset,
                                         kv_valid_len=kv_valid_len, scale=scale)
    bh, tq, _ = q.shape
    tk = k.shape[1]
    _check("flash_attention_bwd", (q, k, v, out, g),
           ((bh, tq, _DH), (bh, tk, _DH), (bh, tk, _DH), (bh, tq, _DH), (bh, tq, _DH)))
    delta = (g.float() * out.float()).sum(dim=-1, keepdim=True)
    _check_res("flash_attention_bwd", (lse, delta), (bh, tq, 1))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    code = _cuda.lib("flash_attention").flash_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, tq, tk, _kv_len(tk, kv_valid_len), int(causal), int(q_offset), float(scale),
        _cuda.stream_handle(q.device),
    )
    _cuda.check("flash_attention", "flash_bwd_bf16", code)
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


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
