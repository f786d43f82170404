"""Median filter along the last axis: the host function and K11, the
sorting-network median (kernel `csrc/median.cu`), with its plain version.

Counterpart of `asr_ttl_mtl_tpu/ops/median.py::median_filter` (:16, the
host's reflect-pad and sort) and of `asr_ttl_mtl_tpu/ops/pallas_median.py`
(`median_filter_pallas` :41, kernel `_median_kernel` :25), which
`find_alignment` runs on the device.

The two agree on every input without NaN. With NaN they differ, as their
JAX counterparts do: the sort puts NaN last, while the network's
jnp.minimum / jnp.maximum (here torch.minimum / torch.maximum, and the
kernel's compare-swap) propagate it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import LAUNCHES, _cuda

WIDTHS = (3, 5, 7, 9, 11, 13)  # the kernel's unrolled networks


def median_filter(x: np.ndarray, filter_width: int) -> np.ndarray:
    """Median of odd `filter_width` along the last axis of a numpy array (any
    leading dims), reflect-padded, by a sort of each window; an input whose
    last axis is at most `filter_width // 2` long comes back unchanged."""
    if filter_width <= 0 or filter_width % 2 == 0:
        raise ValueError("`filter_width` should be an odd number")
    pad = filter_width // 2
    t = x.shape[-1]
    if t <= pad:
        return x
    padded = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="reflect")
    idx = np.arange(t)[:, None] + np.arange(filter_width)[None, :]
    return np.sort(padded[..., idx], axis=-1)[..., pad]


def median_filter_network_plain(x: torch.Tensor, filter_width: int) -> torch.Tensor:
    """Plain PyTorch K11: the TPU kernel's odd-even transposition network of
    NaN-propagating min/max compare-swaps over the `filter_width` shifted
    copies of the reflect-padded rows."""
    pad = filter_width // 2
    t = x.shape[-1]
    if t <= pad:
        return x
    padded = F.pad(x.reshape(-1, 1, t), (pad, pad), mode="reflect").reshape(*x.shape[:-1], t + 2 * pad)
    vals = [padded[..., i : i + t] for i in range(filter_width)]
    for rnd in range(filter_width):
        for i in range(rnd % 2, filter_width - 1, 2):
            vals[i], vals[i + 1] = torch.minimum(vals[i], vals[i + 1]), torch.maximum(vals[i], vals[i + 1])
    return vals[pad]


def median_filter_network(x: torch.Tensor, filter_width: int) -> torch.Tensor:
    """K11 wrapper: the sorting-network median of an fp32 tensor (any leading
    dims) along its last axis; the kernel for a CUDA tensor, the plain version
    for a CPU one."""
    if filter_width not in WIDTHS:
        raise ValueError(f"median_filter_network: width {filter_width} not among {WIDTHS}")
    if x.device.type == "cpu":
        return median_filter_network_plain(x, filter_width)
    if not x.is_cuda:
        raise ValueError(f"median_filter_network: unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() < 1:
        raise TypeError(f"median_filter_network: the kernel takes fp32, got {x.dtype} {tuple(x.shape)}")
    t = x.shape[-1]
    if t <= filter_width // 2 or x.numel() == 0:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    code = _cuda.lib("median").median_filter_f32(
        x.data_ptr(), out.data_ptr(), x.numel() // t, t, filter_width, _cuda.stream_handle(x.device)
    )
    _cuda.check("median", "median_filter_f32", code)
    LAUNCHES["median_filter"] += 1
    return out
