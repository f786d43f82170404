"""Dynamic time warping for the cross-attention word alignment: the host
sweep, the backtrace, K13, the DTW fill on the card, and K12, the batched
fill with the backtrace on the card (kernels in `csrc/dtw.cu`), each with
its plain version.

Counterpart of `asr_ttl_mtl_tpu/ops/dtw.py` (`backtrace` :23,
`dtw_wavefront_numpy` :47, `dtw` :80) and of
`asr_ttl_mtl_tpu/ops/pallas_dtw.py` (`dtw_trace_pallas` :105, kernel
`_dtw_kernel` :36; `dtw_paths_batch`, `dtw_paths_dispatch` and
`dtw_paths_collect` :242-284, kernel `_dtw_kernel_batch` :141 with
`_backtrace_one` :175). x is the (N text tokens, M frames) cost matrix
(callers pass -attention); a trace is (N+1, M+1) with 0 = diagonal, 1 = up,
2 = left, and -1 outside the filled cells.

The host sweep runs in float64, as the JAX package's does. The fill on the
card runs in fp32, as the TPU kernel does. The tie rule is the same: t=0
only if the diagonal is strictly smallest, t=1 only if the upper neighbour
is strictly smaller than both, else t=2. Unlike the JAX `dtw`, which walks
on the host when its kernel fails, `dtw` raises; so do K12's dispatch and
collect, where JAX `find_alignment_batch` falls back to the host walk.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import LAUNCHES, _cuda

MAX_TOKENS = 4095  # N + 1 <= 4096: K13's plan, which K12 shares

# K13's shared-memory plan (csrc/dtw.cu, `wave::warp_bytes`, `wave::chunk_for`)
K13_RING = 4  # chunks of boundary costs between two compute warps
K13_MAX_SMEM = 232448  # bytes a block may take on the H100
# K12's walk behind the fill's shared memory (`wave::kWalkBytes`): a box of
# 4096 cells under a sentinel row of up to 1024, each cell's move (int16) and
# its next four steps (8 bytes), 272 staged groups of four steps and 16
# bytes of control; and its block (`kWalkThreads`)
K12_WALK_BYTES = (4096 + 1024) * (2 + 8) + 272 * 4 + 16
K12_THREADS = 1024


def k13_chunk(rows_per_lane: int, warps: int) -> int:
    """K13's steps a chunk: 32, 16 and 8 at 2, 4 and 8 rows a lane (8
    compute warps' buffers fit a block), 4 for 16 warps of 8 rows."""
    return {2: 32, 4: 16}.get(rows_per_lane, 8 if warps <= 8 else 4)


def k13_warp_bytes(rows_per_lane: int, chunk: int) -> int:
    """Shared memory of one compute warp of K13 and its helpers: 16
    mbarriers, the ring of its last row's costs, x's double buffer (fp32)
    and the trace tile's (int8), each [2][chunk][32 rows_per_lane + 4]."""
    return 16 * 8 + K13_RING * chunk * 4 + 2 * chunk * (32 * rows_per_lane + 4) * 5


def k13_plan(n: int, m: int) -> Tuple[int, int, int, int, int]:
    """(rows a lane, steps a chunk, compute warps, helper warps a compute
    warp, shared-memory bytes) of K13 for an (n, m) cost matrix: a lane
    takes 2, 4 or 8 of the N+1 rows, the fewest that keep to 8 compute warps
    (16 at 8 rows a lane, up to 4096 rows); each compute warp has 4 helper
    warps up to 6 compute warps, 2 up to 10, else 1 (`wave::helpers_for`),
    within 32 warps a block. The fill does not depend on m."""
    rows = n + 1
    rows_per_lane = next((r for r in (2, 4) if -(-rows // (32 * r)) <= 8), 8)
    warps = -(-rows // (32 * rows_per_lane))
    chunk = k13_chunk(rows_per_lane, warps)
    helpers = 4 if warps <= 6 else 2 if warps <= 10 else 1
    return rows_per_lane, chunk, warps, helpers, warps * k13_warp_bytes(rows_per_lane, chunk)


def k12_plan(n_max: int) -> Tuple[int, int, int, int, int, int]:
    """(rows a lane, steps a chunk, compute warps, helper warps a compute
    warp, threads, shared-memory bytes) of K12 for a batch of up to n_max
    tokens, as `dtw_paths_f32` derives it: K13's plan at n_max for every
    row, 1024 threads a block (the warps past the fill's only walk), and
    the walk's shared memory behind the fill's."""
    rows_per_lane, chunk, warps, helpers, smem = k13_plan(n_max, 0)
    return rows_per_lane, chunk, warps, helpers, K12_THREADS, smem + K12_WALK_BYTES


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
    rows_per_lane, _, warps, _, _ = k13_plan(n, m)
    trace = torch.empty((n + 1, m + 1), dtype=torch.int8, device=x.device)
    code = _cuda.lib("dtw").dtw_trace_f32(x.data_ptr(), trace.data_ptr(), n, m, rows_per_lane, warps,
                                          _cuda.stream_handle(x.device))
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


# ---------------------------------------------------------------------------
# K12: the batched fill with the backtrace on the card
# ---------------------------------------------------------------------------


def _walk(trace: np.ndarray, n: int, m: int, ti: np.ndarray, tj: np.ndarray) -> int:
    """`_backtrace_one`'s walk from (n, m) to (0, 0) over one row's trace,
    with i == 0 read as 2 and j == 0 as 1; writes the path into ti, tj in
    reverse order and returns its length."""
    i, j, k = n, m, 0
    while i > 0 or j > 0:
        ti[k], tj[k] = i - 1, j - 1
        k += 1
        t = 2 if i == 0 else 1 if j == 0 else int(trace[i, j])
        i -= int(t != 2)
        j -= int(t != 1)
    return k


def dtw_paths_batch_plain(x: torch.Tensor, n, m):
    """Plain PyTorch K12: `dtw_trace_plain` on each row's x[b, :n, :m] and the
    walk on the host; returns (ti, tj (B, N_max+M_max) int32 in reverse path
    order, 0 past each path; lens (B,) int32) on x's device."""
    b, n_max, m_max = x.shape
    ti = np.zeros((b, n_max + m_max), np.int32)
    tj = np.zeros_like(ti)
    lens = np.zeros(b, np.int32)
    for r in range(b):
        nr, mr = int(n[r]), int(m[r])
        trace = dtw_trace_plain(x[r, :nr, :mr]).cpu().numpy()
        lens[r] = _walk(trace, nr, mr, ti[r], tj[r])
    return tuple(torch.from_numpy(a).to(x.device) for a in (ti, tj, lens))


def k12_trace_scratch(b: int, n_max: int, m_max: int, device) -> torch.Tensor:
    """K12's int8 trace scratch, (b, n_max + 1, m_max + 1) row-major, and 4
    bytes past it: the walk reads the trace as aligned 4-byte words."""
    return torch.empty(b * (n_max + 1) * (m_max + 1) + 4, dtype=torch.int8, device=device)


def dtw_paths_dispatch(x: torch.Tensor, n, m):
    """K12 wrapper: the DTW paths of the rows of x (B, N_max, M_max) fp32,
    each row bounded by its own n[b] <= N_max text tokens and m[b] <= M_max
    frames, as (ti, tj, lens) device tensors (see `dtw_paths_batch_plain`),
    enqueued on the current stream without a sync; the kernel for a CUDA
    tensor, the plain version for a CPU one."""
    b, n_max, m_max = x.shape
    if not (len(n) == len(m) == b) or any(not 0 <= int(v) <= n_max for v in n) or any(
            not 0 <= int(v) <= m_max for v in m):
        raise ValueError(f"dtw_paths: row lengths n={list(n)}, m={list(m)} outside x {tuple(x.shape)}")
    if x.device.type == "cpu":
        return dtw_paths_batch_plain(x, n, m)
    if not x.is_cuda:
        raise ValueError(f"dtw_paths: unsupported device {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"dtw_paths: the kernel takes fp32 cost matrices, got {x.dtype}")
    if n_max > MAX_TOKENS:
        raise ValueError(f"dtw_paths: {n_max} tokens, more than the kernel's {MAX_TOKENS}")
    dev = x.device
    ti = torch.empty((b, n_max + m_max), dtype=torch.int32, device=dev)
    tj = torch.empty_like(ti)
    lens = torch.empty(b, dtype=torch.int32, device=dev)
    if n_max + m_max == 0:  # every row is empty: no path, no launch
        return ti, tj, lens.zero_()
    x = x.contiguous()
    nm = torch.tensor([list(n), list(m)], dtype=torch.int32).pin_memory().to(dev, non_blocking=True)
    trace = k12_trace_scratch(b, n_max, m_max, dev)
    code = _cuda.lib("dtw").dtw_paths_f32(
        x.data_ptr(), trace.data_ptr(), ti.data_ptr(), tj.data_ptr(), lens.data_ptr(), nm[0].data_ptr(),
        nm[1].data_ptr(), b, n_max, m_max, _cuda.stream_handle(dev),
    )
    _cuda.check("dtw", "dtw_paths_f32", code)
    LAUNCHES["dtw_paths_batch"] += 1
    return ti, tj, lens


def dtw_paths_collect(handles) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Bring `dtw_paths_dispatch`'s three tensors to the host; returns each
    row's (text_indices, time_indices) in path order."""
    ti, tj, lens = (h.cpu().numpy() for h in handles)
    return [(ti[r, : lens[r]][::-1].copy(), tj[r, : lens[r]][::-1].copy()) for r in range(len(lens))]


def dtw_paths_batch(x: torch.Tensor, n, m) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Each row's path, equal to `backtrace(dtw_wavefront_numpy(x[b, :n, :m]))`
    up to the fill's fp32 rounding."""
    return dtw_paths_collect(dtw_paths_dispatch(x, n, m))
