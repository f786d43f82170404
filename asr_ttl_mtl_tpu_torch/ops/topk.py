"""K9 and K10: exact small-k top-k of each row (kernel `csrc/topk.cu`) and
their plain versions.

Counterpart of `asr_ttl_mtl_tpu/ops/pallas_topk.py`: `topk_logprobs`
replaces `topk_logprobs_pallas` (:77, kernel `_topk_logprobs_kernel` :51),
the beam step's per-beam pick of the top K+1 log-probabilities, and `topk`
replaces `topk_pallas` (:123, kernel `_topk_kernel` :32), which, as in the
JAX package, no path calls.

Both return (values (rows, k) fp32, indices (rows, k) int32) in
`lax.top_k`'s order: value descending, ties to the lowest index, repeated
values listed as often as they occur. The plain versions rank the raw fp32
values with a stable descending sort (`torch.topk` leaves the order of
ties open). K9's values are (x - max) - log(sum(exp(x - max))) at the
chosen entries; the kernel's sum runs in another order, about 1 ulp apart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import LAUNCHES, _cuda

MAX_K = 32  # the kernel keeps at most 32 (value, index) pairs per thread


def _ranked(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.float()
    top = torch.sort(xf, dim=-1, descending=True, stable=True)
    return top.values[:, :k], top.indices[:, :k].to(torch.int32)


def topk_logprobs_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K9: top-k of log_softmax(x.float()) over the last axis."""
    vals, idx = _ranked(x, k)
    xf = x.float()
    m = xf.amax(dim=-1, keepdim=True)
    log_denom = torch.log(torch.exp(xf - m).sum(dim=-1, keepdim=True))
    return (vals - m) - log_denom, idx


def topk_plain(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K10: top-k of x.float() over the last axis."""
    return _ranked(x, k)


def _launch(kind: str, x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    if not x.is_cuda:
        raise ValueError(f"{kind}: unsupported device {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or x.dim() != 2:
        raise TypeError(f"{kind}: the kernel takes a (rows, V) bf16 or fp32 tensor, got {x.dtype} {tuple(x.shape)}")
    rows, v = x.shape
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"{kind}: k={k} outside 1..{min(MAX_K, v)}")
    x = x.contiguous()
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows == 0:
        return vals, idx
    fn = f"{kind}_{'bf16' if x.dtype == torch.bfloat16 else 'f32'}"
    code = getattr(_cuda.lib("topk"), fn)(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, v, k, _cuda.stream_handle(x.device)
    )
    _cuda.check("topk", fn, code)
    LAUNCHES[kind] += 1
    return vals, idx


def topk_logprobs(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K9 wrapper: the CUDA kernel for a CUDA tensor, the plain version on CPU."""
    if x.device.type == "cpu":
        return topk_logprobs_plain(x, k)
    return _launch("topk_logprobs", x, k)


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10 wrapper: the CUDA kernel for a CUDA tensor, the plain version on CPU."""
    if x.device.type == "cpu":
        return topk_plain(x, k)
    return _launch("topk", x, k)
