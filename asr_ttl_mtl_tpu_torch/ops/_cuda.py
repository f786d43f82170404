"""Build and load the hand-written Hopper kernels under `csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` for `sm_90a` into its own shared
library with a plain C interface, and loaded with `ctypes`. Nothing here
includes PyTorch's headers, so a build takes seconds. The libraries go to
`asr_ttl_mtl_tpu_torch/_build/`, keyed by a hash of the source and flags,
and are built at first use from the sources in the checkout only.
`build_all()` starts one `nvcc` per source at once. `<name>_f16.cu`
includes `<name>.cu` and builds its fp16 entries alone, so that those
instances compile beside the rest instead of after them (`source`).

Every entry point returns `cudaGetLastError()` as an int after its launch;
`check()` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("mel", "flash_attention", "flash_attention_f16", "decode_attention", "decode_attention_f16", "topk", "median",
           "dtw", "int8_mlp")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures, one table per library: name -> (argtypes)
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "mel": {
        # padded audio, consts (`dft_constants`), mel lo, hi, offsets, weights (`mel_ranges`), out,
        # batch, padded_len, n_frames, n_mels, stream
        "log_mel_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "flash_attention": {
        # q, k, v, out, lse (or null), batch, tq, tk, d, n_head, kv_len, scale, stream
        "flash_h2_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        # q, k, v, dout, lse, delta, dq, dk, dv, batch, tq, tk, d, n_head, kv_len, scale, stream
        "flash_h2_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        # q, k, v, out, lse (or null), bh, tq, tk, dh, kv_len, causal, q_offset, scale, stream
        "flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        # q, k, v, dout, lse, delta, dq, dk, dv, bh, tq, tk, dh, kv_len, causal, q_offset, scale, stream
        "flash_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        # q, k, v, out, batch, tq, tk, d, n_head, kv_len, scale, stream
        "flash_mh_fwd_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        # dh, tq, out (6 int32): the bf16 K5's plan (`flash_attention.k5_plan`)
        "flash_mh_plan_bf16": (_I, _I, _P),
        # dh, out (4 int32): the fp32 wide forward's plan (`flash_attention.f32_wide_plan`)
        "flash_wide_plan_f32": (_I, _P),
        # dh, out (7 int32): K8's wide backward plan (`flash_attention.k8_wide_plan`)
        "flash_wide_bwd_plan_bf16": (_I, _P),
        # dh, out (4 int32): the fp32 wide backward's plan (`flash_attention.f32_k8_wide_plan`)
        "flash_wide_bwd_plan_f32": (_I, _P),
        # the same five at fp32
        "flash_h2_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_h2_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_fwd_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_mh_fwd_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        # the fp16 K5's plan (the bf16 one's)
        "flash_mh_plan_f16": (_I, _I, _P),
    },
    "flash_attention_f16": {
        # the serving forwards at fp16, arguments as their bf16 twins' (K3
        # and K7 without the logsumexp: lse must be null)
        "flash_h2_fwd_f16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_fwd_f16": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "flash_mh_fwd_f16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "decode_attention": {
        # q, cache_k, cache_v, out, layer, n_layer, batch, group, tk, d, n_head,
        # valid_upto, split (the cluster size, `k2_plan`), scale, stream
        "decode_attn_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "decode_attn_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        # q, k, k_scale, v, v_scale, out, layer, n_layer, batch, group, tk, d,
        # n_head, tk_blk, valid_upto, split (the cluster size, `k1_plan`), scale, stream
        "decode_attn_i8_bf16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "decode_attn_i8_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        # itemsize, dh, group, chunk -> K2's shared bytes a CTA (`decode_attention.k2_smem_bytes`), or -1
        "decode_smem_bytes": (_I, _I, _I, _I),
        # dh, rows, tk_blk -> K1's shared bytes a CTA (`decode_attention.k1_smem_bytes`), or -1
        "decode_i8_smem_bytes": (_I, _I, _I),
    },
    "decode_attention_f16": {
        # K2 and K1 at fp16, arguments as their bf16 twins'
        "decode_attn_f16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "decode_attn_i8_f16": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    },
    "topk": {
        # x, values, indices, rows, v, k, split (the cluster size, `k9_plan`), stream
        "topk_logprobs_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
        "topk_logprobs_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
        "topk_bf16": (_P, _P, _P, _I, _I, _I, _I, _P),
        "topk_f32": (_P, _P, _P, _I, _I, _I, _I, _P),
        "topk_logprobs_f16": (_P, _P, _P, _I, _I, _I, _I, _P),
        "topk_f16": (_P, _P, _P, _I, _I, _I, _I, _P),
        # the largest cluster the card schedules (or a negative CUDA error)
        "topk_max_split": (),
    },
    "median": {
        # x, out, rows, t, width, stream
        "median_filter_f32": (_P, _P, _I, _I, _I, _P),
    },
    "dtw": {
        # x, trace, n, m, rows_per_lane, warps (`k13_plan`), stream
        "dtw_trace_f32": (_P, _P, _I, _I, _I, _I, _P),
        # out (32 fp32), iters, stream: K13's chain probe
        "dtw_chain_probe": (_P, _I, _P),
        # x, trace scratch, ti, tj, lens, n, m, batch, n_max, m_max, stream
        "dtw_paths_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
    "int8_mlp": {
        # x, w1, s1, b1, w2, s2, b2, out, qx, qg, sg (the last three may be null), n, d, hidden,
        # stages (`k14_plan`), stream: the wgmma route
        "int8_mlp_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        # the same without the stages: the mma.sync route
        "int8_mlp_mma_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
        # both routes with fp32 x and out
        "int8_mlp_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "int8_mlp_mma_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
        # and with fp16 x and out
        "int8_mlp_f16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        "int8_mlp_mma_f16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def source(name: str, sfx: str) -> str:
    """The library holding kernel source `name`'s entry for symbol suffix
    `sfx`: `<name>_f16` for an fp16 entry where that source exists."""
    return f"{name}_f16" if sfx == "f16" and f"{name}_f16" in SIGNATURES else name


def _lib_path(name: str) -> str:
    """The library's path, keyed by the source, the sources it includes and the flags."""
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        text = f.read()
    for included in re.findall(rb'^#include "([^"]+)"', text, re.M):
        with open(os.path.join(CSRC, included.decode()), "rb") as f:
            text += f.read()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start_build(name: str):
    """Start nvcc for one source unless its library is already built."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    log = open(os.path.join(BUILD_DIR, f"{name}.log"), "w")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    return proc, tmp, out, log


def _finish_build(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out, log = started
    rc = proc.wait()
    log.close()
    if rc != 0:
        with open(log.name) as f:
            raise RuntimeError(f"nvcc failed for csrc/{name}.cu (rc={rc}):\n{f.read()[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Build every library that is missing, one nvcc per source, in parallel."""
    with _LOCK:
        started = {n: _start_build(n) for n in names}
        for n, s in started.items():
            _finish_build(n, s)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built on first use."""
    handle = _LIBS.get(name)
    if handle is not None:
        return handle
    build_all([name])
    with _LOCK:
        if name not in _LIBS:
            handle = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(handle, fn).argtypes = list(argtypes)
                getattr(handle, fn).restype = ctypes.c_int
            handle.kernel_error_string.argtypes = [ctypes.c_int]
            handle.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = handle
    return _LIBS[name]


def check(name: str, fn: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        msg = lib(name).kernel_error_string(code).decode()
        raise RuntimeError(f"{fn} launch failed: CUDA error {code} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def ptxas_report(name: str) -> str:
    """nvcc's `-Xptxas -v` output of the last build (registers, spills)."""
    path = os.path.join(BUILD_DIR, f"{name}.log")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()
