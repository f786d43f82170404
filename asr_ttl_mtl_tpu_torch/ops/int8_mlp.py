"""The fused W8A8 encoder MLP, K14 (`csrc/int8_mlp.cu`), and its plain
PyTorch version.

Counterpart of `asr_ttl_mtl_tpu/ops/int8_mlp.py` (`int8_mlp` :88,
`_int8_mlp_kernel` :46): one pass over token rows computes

    per-row int8 quantization of x -> int8 GEMM with w1 -> dequantize + b1
    -> cast to the compute dtype -> tanh GELU -> per-row requantization
    -> int8 GEMM with w2 -> dequantize + b2 -> cast to the compute dtype,

with the (rows, 4D) intermediates kept out of device memory. The tanh GELU
runs whatever the compute dtype, as in the TPU kernel (the unfused
`gelu(linear_i8(...))` of the encoder takes exact erf in fp32).

Weights are in the port's (out, in) layout: w1q (H, D) int8 with one fp32
scale per row (per output column of the JAX (D, H) weight), w2q (D, H).
The CUDA kernel takes bf16, fp16 or fp32 activations (`int8_mlp_bf16` /
`int8_mlp_f16` / `int8_mlp_f32` and the mma.sync route's three; fp16 and
fp32 launches count under `int8_mlp_f16` and `int8_mlp_f32`); any other
dtype raises. `k14_plan` picks its route by
shape: the wgmma kernel on a cluster of 4 CTAs for d up to 1024 (every
shape the gate admits there), else the earlier mma.sync kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _cuda, count_launch, kernel_dtype, on_card
from .decode_attention import int8_step


def int8_mlp_supported(n_tokens: int, d: int, hidden: int) -> bool:
    """Geometry gate, rule for rule as in the JAX package: lane-dim
    multiples of 128 and a hidden width the TPU kernel holds in VMEM."""
    return (
        d % 128 == 0
        and hidden % 128 == 0
        and 2 * d * hidden + 5 * 256 * hidden * 4 <= 14 * (1 << 20)
        and n_tokens >= 8
    )


MAX_SMEM = 232448  # bytes of shared memory a block may take on the H100
K14_TILE = 128  # hidden or output columns of a phase; bytes of a K chunk
K14_ROWS = 64  # token rows a CTA of the wgmma route holds
K14_CLUSTER = 4  # 2 hidden halves x 2 row tiles
K14_MAX_STAGES = 4
K14_MAX_D = 1024  # the wgmma route holds a row's x in 8 pieces a lane


class K14Plan(NamedTuple):
    route: str  # "wgmma" (int8_mlp_<dtype>) or "mma" (the mma.sync kernel, int8_mlp_mma_<dtype>)
    cluster: int  # CTAs a cluster (1: no cluster)
    rows_per_cta: int
    stages: int  # 16 KB weight stages of the ring (0 on the mma route)
    smem: int  # dynamic shared memory a block, bytes
    hidden_per_cta: int  # hidden columns of GEMM1 the CTA computes (the most, where the halves differ)
    out_per_cta: int  # output columns of GEMM2 the CTA computes (the most)


def k14_sm90_smem(d: int, hidden: int, stages: int) -> int:
    """`sm90::smem_bytes` of csrc/int8_mlp.cu: alignment slack, the stages,
    the int8 x tile, the GELU tiles of the larger hidden half (later the
    int8 GELU rows), the mbarriers and the row arrays."""
    tiles = hidden // K14_TILE
    return (1024 + stages * K14_TILE * K14_TILE + (d // K14_TILE) * K14_ROWS * K14_TILE
            + (tiles + 1) // 2 * K14_ROWS * K14_TILE * 2 + 8 * (2 * stages + 3) + 4 * K14_ROWS * 5)


def k14_mma_smem(d: int, hidden: int, act_bytes: int = 2) -> int:
    """The mma.sync kernel: 32 rows of int8 x and of GELU values in the
    activation dtype (`act_bytes` each), padded."""
    return 32 * (d + 32) + 32 * (act_bytes * hidden + 32) + 2 * 32 * 4


def k14_plan(n: int, d: int, hidden: int, act_bytes: int = 2) -> K14Plan:
    """K14's route for (n rows, d, hidden) with activations of `act_bytes`
    (2 bf16 or fp16, 4 fp32): the wgmma kernel with the most stages (2-4) that fit,
    for d up to 1024, else the mma.sync kernel; raises where neither fits.
    The wgmma route's shared memory does not depend on the activation dtype
    (fp32 quantizes GEMM1's output straight into the int8 chunk slots)."""
    if n < 1 or d < K14_TILE or hidden < K14_TILE or d % K14_TILE or hidden % K14_TILE:
        raise ValueError(f"int8_mlp kernel takes n >= 1 and d, hidden in multiples of 128, got {n}, {d}, {hidden}")
    tiles, out_tiles = hidden // K14_TILE, d // K14_TILE
    for stages in range(K14_MAX_STAGES, 1, -1) if d <= K14_MAX_D else ():
        smem = k14_sm90_smem(d, hidden, stages)
        if smem <= MAX_SMEM:
            return K14Plan("wgmma", K14_CLUSTER, K14_ROWS, stages, smem, (tiles + 1) // 2 * K14_TILE,
                           (out_tiles + 1) // 2 * K14_TILE)
    smem = k14_mma_smem(d, hidden, act_bytes)
    if smem <= MAX_SMEM:
        return K14Plan("mma", 1, 32, 0, smem, hidden, d)
    raise ValueError(f"int8_mlp: no kernel route holds d={d}, hidden={hidden} in shared memory")


def k14_slot_tiles(hidden: int, half: int) -> list:
    """The wgmma route's K order for GEMM2 in the CTA of hidden half `half`:
    the hidden tiles of 128 columns whose int8 GELU chunks sit in its slots
    0, 1, ..., its own tiles (half, half + 2, ...) first, then the peer's,
    as the kernel lays them out and its producer loads w2 in that order."""
    tiles = hidden // K14_TILE
    return list(range(half, tiles, 2)) + list(range(1 - half, tiles, 2))


def _quant_rows(x32: torch.Tensor):
    """Per-row symmetric int8: step max(absmax, 1e-30)/127, round half to
    even, clip to +-127."""
    scale = int8_step(x32.abs().amax(dim=-1, keepdim=True), 1e-30)
    return torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8), scale


def int8_mlp_plain(x, w1q, s1, b1, w2q, s2, b2, *, return_int8: bool = False):
    """Plain PyTorch K14, the TPU kernel's body step by step: x (..., D) in
    the compute dtype -> (..., D) in that dtype (`torch._int_mm` on CUDA
    needs more than 16 rows). With `return_int8`, also the two int8
    intermediates and the second one's row scales: (out, qx (n, D),
    qg (n, H), sg (n, 1))."""
    cdt = x.dtype
    d = x.shape[-1]
    h = x.reshape(-1, d).float()
    qx, sx = _quant_rows(h)
    a1 = torch._int_mm(qx, w1q.t())
    f1 = a1.float() * (sx * s1.float()[None, :]) + b1.float()
    g = F.gelu(f1.to(cdt), approximate="tanh").float()
    qg, sg = _quant_rows(g)
    a2 = torch._int_mm(qg, w2q.t())
    out = (a2.float() * (sg * s2.float()[None, :]) + b2.float()).to(cdt).reshape(x.shape)
    return (out, qx, qg, sg) if return_int8 else out


def _check(x, w1q, s1, b1, w2q, s2, b2) -> str:
    d = x.shape[-1]
    hidden = w1q.shape[0]
    sfx = kernel_dtype("int8_mlp", [x])
    if w1q.dtype != torch.int8 or w2q.dtype != torch.int8:
        raise TypeError(f"int8_mlp: weights must be int8, got {w1q.dtype}/{w2q.dtype}")
    if tuple(w1q.shape) != (hidden, d) or tuple(w2q.shape) != (d, hidden):
        raise ValueError(f"int8_mlp: w1q {tuple(w1q.shape)} and w2q {tuple(w2q.shape)} for d={d}")
    for name, t, n in (("s1", s1, hidden), ("b1", b1, hidden), ("s2", s2, d), ("b2", b2, d)):
        if t.dtype != torch.float32 or t.numel() != n or not t.is_contiguous():
            raise ValueError(f"int8_mlp: {name} must be {n} contiguous fp32 values, got {t.dtype} {tuple(t.shape)}")
    for t in (x, w1q, s1, b1, w2q, s2, b2):
        if t.device != x.device:
            raise ValueError(f"int8_mlp: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("int8_mlp: the kernel takes contiguous tensors")
    if d % 128 or hidden % 128:
        raise ValueError(f"int8_mlp kernel takes d and hidden in multiples of 128, got {d}, {hidden}")
    return sfx


def int8_mlp(x, w1q, s1, b1, w2q, s2, b2, *, return_int8: bool = False):
    """K14 wrapper: x (..., D) -> (..., D) in x's dtype. With `return_int8`,
    the kernel also writes its int8 intermediates (a check of the kernel,
    not a path of the model): (out, qx, qg, sg) as `int8_mlp_plain` gives."""
    if not on_card("int8_mlp", x):
        return int8_mlp_plain(x, w1q, s1, b1, w2q, s2, b2, return_int8=return_int8)
    sfx = _check(x, w1q, s1, b1, w2q, s2, b2)
    d, hidden = x.shape[-1], w1q.shape[0]
    n = x.numel() // d
    plan = k14_plan(n, d, hidden, x.element_size())
    out = torch.empty_like(x)
    qx = qg = sg = None
    if return_int8:
        qx = torch.empty((n, d), dtype=torch.int8, device=x.device)
        qg = torch.empty((n, hidden), dtype=torch.int8, device=x.device)
        sg = torch.empty((n, 1), dtype=torch.float32, device=x.device)
    ptr = [0 if t is None else t.data_ptr() for t in (qx, qg, sg)]
    args = (x.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), *ptr, n, d, hidden)
    fn, stages = (f"int8_mlp_{sfx}", (plan.stages,)) if plan.route == "wgmma" else (f"int8_mlp_mma_{sfx}", ())
    code = getattr(_cuda.lib("int8_mlp"), fn)(*args, *stages, _cuda.stream_handle(x.device))
    _cuda.check("int8_mlp", fn, code)
    count_launch("int8_mlp", sfx)
    return (out, qx, qg, sg) if return_int8 else out
