"""Dynamic time warping for the cross-attention word alignment: the host
sweep, the backtrace, and K13, the DTW fill on the card (kernel
`csrc/dtw.cu`), with its plain version.

Counterpart of `asr_ttl_mtl_tpu/ops/dtw.py` (`backtrace` :23,
`dtw_wavefront_numpy` :47, `dtw` :80) and of
`asr_ttl_mtl_tpu/ops/pallas_dtw.py::dtw_trace_pallas` (:105, kernel
`_dtw_kernel` :36). x is the (N text tokens, M frames) cost matrix (callers
pass -attention); a trace is (N+1, M+1) with 0 = diagonal, 1 = up,
2 = left, and -1 outside the filled cells.

The host sweep runs in float64, as the JAX package's does. The fill on the
card runs in fp32, as the TPU kernel does. The tie rule is the same: t=0
only if the diagonal is strictly smallest, t=1 only if the upper neighbour
is strictly smaller than both, else t=2. Unlike the JAX `dtw`, which walks
on the host when its kernel fails, `dtw` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from . import LAUNCHES, _cuda

MAX_TOKENS = 4095  # N + 1 <= 4096: the kernel's shared-memory ring


def backtrace(trace: np.ndarray) -> np.ndarray:
    """Walk the trace from (N, M) to (0, 0); returns (2, path length) of
    (text index, time index). Primes row 0 and column 0 of `trace` in place."""
    i = trace.shape[0] - 1
    j = trace.shape[1] - 1
    trace[0, :] = 2
    trace[:, 0] = 1

    result = []
    while i > 0 or j > 0:
        result.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        elif t == 2:
            j -= 1
        else:
            raise ValueError("Unexpected trace[i, j]")
    return np.array(result)[::-1, :].T


def dtw_wavefront_numpy(x: np.ndarray) -> np.ndarray:
    """The float64 host fill, one anti-diagonal per vector step; returns the
    (N+1, M+1) float32 trace."""
    N, M = x.shape
    x = x.astype(np.float64)
    cost = np.full((N + 1, M + 1), np.inf, dtype=np.float64)
    trace = -np.ones((N + 1, M + 1), dtype=np.float32)
    cost[0, 0] = 0.0
    for d in range(2, N + M + 1):
        i_lo, i_hi = max(1, d - M), min(N, d - 1)
        if i_lo > i_hi:
            continue
        i = np.arange(i_lo, i_hi + 1)
        j = d - i
        c0, c1, c2 = cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1]
        t0 = (c0 < c1) & (c0 < c2)
        t1 = (c1 < c0) & (c1 < c2)
        cost[i, j] = x[i - 1, j - 1] + np.where(t0, c0, np.where(t1, c1, c2))
        trace[i, j] = np.where(t0, 0.0, np.where(t1, 1.0, 2.0))
    return trace


def dtw_trace_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K13: the fp32 fill of the same recurrence, one
    anti-diagonal per step; returns the (N+1, M+1) int8 trace on x's device."""
    n, m = x.shape
    x = x.float()
    cost = torch.full((n + 1, m + 1), float("inf"), device=x.device)
    cost[0, 0] = 0.0
    trace = torch.full((n + 1, m + 1), -1, dtype=torch.int8, device=x.device)
    rows = torch.arange(n + 1, device=x.device)
    for d in range(2, n + m + 1):
        i = rows[max(1, d - m) : min(n, d - 1) + 1]
        j = d - i
        c0, c1, c2 = cost[i - 1, j - 1], cost[i - 1, j], cost[i, j - 1]
        t0 = (c0 < c1) & (c0 < c2)
        t1 = (c1 < c0) & (c1 < c2)
        cost[i, j] = x[i - 1, j - 1] + torch.where(t0, c0, torch.where(t1, c1, c2))
        trace[i, j] = torch.where(t0, 0, torch.where(t1, 1, 2)).to(torch.int8)
    return trace


def dtw_trace(x: torch.Tensor) -> torch.Tensor:
    """K13 wrapper: the int8 trace (N+1, M+1) of the fp32 cost matrix x
    (N, M); the kernel for a CUDA tensor, the plain version for a CPU one."""
    if x.device.type == "cpu":
        return dtw_trace_plain(x)
    if not x.is_cuda:
        raise ValueError(f"dtw_trace: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"dtw_trace: the kernel takes an (N, M) fp32 matrix, got {x.dtype} {tuple(x.shape)}")
    n, m = x.shape
    if n > MAX_TOKENS:
        raise ValueError(f"dtw_trace: {n} tokens, more than the kernel's {MAX_TOKENS}")
    if n == 0 or m == 0:  # no cell to fill (a window of under two frames)
        return torch.full((n + 1, m + 1), -1, dtype=torch.int8, device=x.device)
    x = x.contiguous()
    trace = torch.empty((n + 1, m + 1), dtype=torch.int8, device=x.device)
    code = _cuda.lib("dtw").dtw_trace_f32(x.data_ptr(), trace.data_ptr(), n, m, _cuda.stream_handle(x.device))
    _cuda.check("dtw", "dtw_trace_f32", code)
    LAUNCHES["dtw_trace"] += 1
    return trace


def dtw(x) -> np.ndarray:
    """DTW path (text_indices, time_indices) of a cost matrix: the K13 fill
    for a CUDA tensor (only the int8 trace leaves the card), the float64
    host sweep for anything else. The backtrace walks on the host."""
    if isinstance(x, torch.Tensor) and x.is_cuda:
        return backtrace(dtw_trace(x.float()).cpu().numpy())
    return backtrace(dtw_wavefront_numpy(np.asarray(x)))
