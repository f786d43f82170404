"""K3: non-causal multi-head attention over natural (B, T, D) projections
(kernel `csrc/flash_attention.cu`) and its plain version.

Counterpart of `asr_ttl_mtl_tpu/ops/flash_attention.py::flash_attention_h2`
(:562) with return_lse=False, kernel `_h2_fwd_kernel` (:514): the encoder
self-attention. The other Pallas kernels of that file are not ported yet:
`flash_attention_mh` (K5, only for shapes `h2_eligible` rejects),
`flash_attention` (K7, causal, decoder self-attention at tq >= 16) and the
backward kernels K6 and K8 (training).
"""

from __future__ import annotations

import torch

from . import LAUNCHES, _cuda

_NEG_INF = -1e30


def h2_eligible(tq: int, tk: int, d: int, n_head: int) -> bool:
    """Shapes the head-pair kernel serves (same rule as the JAX package)."""
    if n_head <= 0 or d % n_head:
        return False
    dh = d // n_head
    return dh in (32, 64, 128) and d % 128 == 0 and tq >= 16 and tk <= 4096


def flash_attention_h2_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_head: int,
    kv_valid_len: int | None = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """Plain PyTorch K3: fp32 scores x scale, keys >= kv_valid_len masked,
    p cast to v's dtype for p.V, divided by the fp32 row sum."""
    b, tq, d = q.shape
    tk = k.shape[1]
    dh = d // n_head
    qh = q.reshape(b, tq, n_head, dh).transpose(1, 2).float()
    kh = k.reshape(b, tk, n_head, dh).transpose(1, 2).float()
    vh = v.reshape(b, tk, n_head, dh).transpose(1, 2)
    s = (qh @ kh.transpose(-1, -2)) * scale
    kv_len = tk if kv_valid_len is None else min(kv_valid_len, tk)
    if kv_len < tk:
        s = s + torch.where(torch.arange(tk, device=q.device) < kv_len, 0.0, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = p.to(v.dtype).float() @ vh.float()
    return (acc / l).to(v.dtype).transpose(1, 2).reshape(b, tq, d)


def flash_attention_h2(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    n_head: int,
    kv_valid_len: int | None = None,
    scale: float = 1.0,
) -> torch.Tensor:
    """K3 wrapper: q (B, Tq, D), k and v (B, Tk, D) -> (B, Tq, D) in v's dtype.
    The CUDA kernel takes bf16 with a head width of 64 (every Whisper preset)."""
    if q.device.type == "cpu":
        return flash_attention_h2_plain(q, k, v, n_head=n_head, kv_valid_len=kv_valid_len, scale=scale)
    if not q.is_cuda:
        raise ValueError(f"flash_attention_h2: unsupported device {q.device}")
    b, tq, d = q.shape
    tk = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention_h2 kernel takes bf16 q/k/v, got {q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (b, tk, d) or v.shape != (b, tk, d) or d != n_head * 64:
        raise ValueError(f"flash_attention_h2: bad shapes q={tuple(q.shape)} k={tuple(k.shape)} n_head={n_head}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    kv_len = tk if kv_valid_len is None else min(kv_valid_len, tk)
    out = torch.empty_like(q)
    code = _cuda.lib("flash_attention").flash_h2_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, tq, tk, d, n_head, kv_len, float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check("flash_attention", "flash_h2_fwd_bf16", code)
    LAUNCHES["flash_attention_h2"] += 1
    return out
