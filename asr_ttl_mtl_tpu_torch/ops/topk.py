"""K9 and K10: exact small-k top-k of each row (kernel `csrc/topk.cu`) and
their plain versions.

Counterpart of `asr_ttl_mtl_tpu/ops/pallas_topk.py`: `topk_logprobs`
replaces `topk_logprobs_pallas` (:77, kernel `_topk_logprobs_kernel` :51),
the beam step's per-beam pick of the top K+1 log-probabilities, and `topk`
replaces `topk_pallas` (:123, kernel `_topk_kernel` :32), which, as in the
JAX package, no path calls.

Both take bf16, fp16 or fp32 rows (an fp16 launch counts under
`<name>_f16`) and return (values (rows, k) fp32, indices (rows, k) int32) in
`lax.top_k`'s order: value descending, ties to the lowest index, repeated
values listed as often as they occur. The plain versions rank the raw fp32
values with a stable descending sort (`torch.topk` leaves the order of
ties open). K9's values are (x - max) - log(sum(exp(x - max))) at the
chosen entries; the kernel's sum runs in another order, about 1 ulp apart.

The kernel splits each row across a thread-block cluster of S CTAs, each
reading one contiguous slice of the row (`k9_slices`); `k9_plan` picks S
from the row count and the card's SM count, so that the CLI's 5 rows still
fill the card.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import torch

from . import _cuda, count_launch, kernel_dtype

MAX_K = 32  # the kernel keeps at most 32 (value, index) pairs per thread

# K9's launch plan; the constants mirror `csrc/topk.cu`
K9_MAX_SPLIT = 16  # CTAs a cluster; above 8 the card must allow the non-portable size
K9_MIN_SLICE = 2048  # elements a CTA reads at least (one 16-byte bf16 vector for each of 256 threads)
_SM_COUNT = 132  # an H100 SXM's streaming multiprocessors


@functools.lru_cache(maxsize=4096)  # a decode step asks the same few questions every call
def k9_plan(rows: int, v: int, sm_count: int = _SM_COUNT, max_split: int = K9_MAX_SPLIT) -> int:
    """S, the CTAs of K9's cluster for one row of `v` entries: as many as
    keep rows x S within the card's `sm_count` SMs (S 1 at 80 and 160 rows,
    16 at 5), but at most `max_split` and no more than keeps each slice at
    K9_MIN_SLICE entries or longer. A second CTA on an SM costs more than
    a row split in two saves (80 rows: S 2 measured slower than S 1)."""
    want = sm_count // max(rows, 1)
    return max(1, min(want, max_split, K9_MAX_SPLIT, v // K9_MIN_SLICE))


def k9_slices(v: int, split: int) -> List[Tuple[int, int]]:
    """[(lo, hi)] of the entries each CTA of the cluster reads, as the kernel
    cuts them: contiguous, in rank order, each non-empty under `k9_plan`."""
    chunk = -(-v // split)
    return [(min(v, r * chunk), min(v, (r + 1) * chunk)) for r in range(split)]


@functools.lru_cache(maxsize=None)
def _card_limits(index: int) -> Tuple[int, int]:
    """(SM count, largest cluster the kernel can be launched with) of a card."""
    sm_count = torch.cuda.get_device_properties(index).multi_processor_count
    with torch.cuda.device(index):
        max_split = _cuda.lib("topk").topk_max_split()
    if max_split < 1:
        raise RuntimeError(f"topk: no cluster size is schedulable (CUDA error {-max_split})")
    return sm_count, max_split


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
    sfx = kernel_dtype(kind, (x,))
    if x.dim() != 2:
        raise TypeError(f"{kind}: the kernel takes a (rows, V) tensor, got {tuple(x.shape)}")
    rows, v = x.shape
    if not 1 <= k <= min(MAX_K, v):
        raise ValueError(f"{kind}: k={k} outside 1..{min(MAX_K, v)}")
    x = x.contiguous()
    vals = torch.empty((rows, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((rows, k), dtype=torch.int32, device=x.device)
    if rows == 0:
        return vals, idx
    split = k9_plan(rows, v, *_card_limits(x.device.index if x.device.index is not None else 0))
    fn = f"{kind}_{sfx}"
    code = getattr(_cuda.lib("topk"), fn)(
        x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, v, k, split, _cuda.stream_handle(x.device)
    )
    _cuda.check("topk", fn, code)
    # fp32 rows count under the kernel's name, as bf16 ones do; fp16 under `<name>_f16`
    count_launch(kind, "f16" if sfx == "f16" else "bf16")
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
