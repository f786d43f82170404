"""K7's and K8's device times on the card against an earlier checkout's.

    python -m asr_ttl_mtl_tpu_torch.scripts.kernels_vs_parent --parent DIR

`DIR` holds an earlier checkout's `asr_ttl_mtl_tpu_torch/csrc`. The parent's
`flash_attention.cu` is built beside the current one and loaded with the same
C signatures (`flash_fwd_bf16`, `flash_bwd_bf16`), so the port's own
wrappers drive both. At each shape below, K7 with the logsumexp, K7 without
it and K8 of both are held to their plain versions (2^-6 of the largest
output, lse 1e-4), then timed in turns (parent, change, change, parent):
device time, one call's share of a CUDA graph of 10 calls. K8 is timed
twice: through its wrapper, which computes delta = rowsum(dO * O) in plain
PyTorch first, and as its C entry alone with delta given, so the kernels'
share and the wrapper's delta read apart. Needs a CUDA device.

- the d=576 train step's encoder self-attention: (72, 1536, 64) x 1536 keys,
  valid to 1500, non-causal;
- its cross-attention: (72, 48, 64) x 1500 keys, non-causal;
- base's decoder at the token bucket: (128, 48, 64), causal;
- the same with q_offset 48 over 96 keys;
- the CLI's prompted prefill: (40, 32, 64) x 256 cached keys, causal.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from ..ops import _cuda
from ..ops import flash_attention as FA
from .card_timing import card_line, graph_ms

# name, (bh, tq, tk), kv_valid_len, causal, q_offset
SHAPES = (
    ("d=576 encoder", (72, 1536, 1536), 1500, False, 0),
    ("d=576 cross", (72, 48, 1500), None, False, 0),
    ("causal token bucket", (128, 48, 48), None, True, 0),
    ("causal q_offset 48", (128, 48, 96), None, True, 48),
    ("prompted prefill", (40, 32, 256), None, True, 0),
)
SOURCE = "flash_attention"


def build_parent(parent: str, name: str) -> ctypes.CDLL:
    """The parent's `csrc/<name>.cu`, built by nvcc into the build directory
    while this tree's builds beside it, and loaded with this tree's C
    signatures."""
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    src = os.path.join(parent, "asr_ttl_mtl_tpu_torch", "csrc", f"{name}.cu")
    out = os.path.join(_cuda.BUILD_DIR, f"parent_{name}.so")
    with open(f"{out}.log", "w") as log:
        proc = subprocess.Popen([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", out, src], stdout=log,
                                stderr=subprocess.STDOUT)
        _cuda.build_all([name])
        rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for the parent's {name}.cu: see {out}.log")
    lib = ctypes.CDLL(out)
    for fn, argtypes in _cuda.SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.kernel_error_string.argtypes = [ctypes.c_int]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def through(lib, fn):
    """`fn` with the port's wrappers launching from `lib` instead of this tree's library."""

    def run():
        own = _cuda.lib(SOURCE)
        _cuda._LIBS[SOURCE] = lib
        try:
            return fn()
        finally:
            _cuda._LIBS[SOURCE] = own

    return run


def k8_kernels(q, k, v, g, lse, delta, kv_len, causal, q_offset, scale):
    """K8's C entry alone, with delta given: (dq, dk, dv)."""
    bh, tq, _ = q.shape
    tk = k.shape[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    code = _cuda.lib(SOURCE).flash_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), bh, tq, tk, tk if kv_len is None else kv_len, int(causal), q_offset, scale,
        _cuda.stream_handle(q.device))
    _cuda.check(SOURCE, "flash_bwd_bf16", code)
    return dq, dk, dv


def close(got, want, tol) -> bool:
    return bool(torch.isfinite(got.float()).all()) and (got.float() - want.float()).abs().max().item() <= tol


def run_shape(parent_lib, card, what, shape, kv_len, causal, q_offset, gen):
    bh, tq, tk = shape
    dev = torch.device("cuda")
    q, k, v, g = (torch.randn(s, generator=gen, device=dev).bfloat16()
                  for s in ((bh, tq, 64), (bh, tk, 64), (bh, tk, 64), (bh, tq, 64)))
    kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv_len, scale=0.125)
    pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    want_bwd = FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw)
    delta = (g.float() * pout.float()).sum(dim=-1, keepdim=True)
    tol = 2.0**-6 * pout.float().abs().max().item()
    fns = {
        "K7-lse": lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
        "K7": lambda: FA.flash_attention(q, k, v, **kw),
        "K8": lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
        "K8 kernels, delta given": lambda: k8_kernels(q, k, v, g, plse, delta, kv_len, causal, q_offset, 0.125),
    }
    routes = {"this tree's": lambda f: f, "the parent's": lambda f: through(parent_lib, f)}
    for who, wrap in routes.items():
        out, lse = wrap(fns["K7-lse"])()
        ok = close(out, pout, tol) and close(lse, plse, 1e-4) and close(wrap(fns["K7"])(), pout, tol)
        ok = ok and all(close(a, c, 2.0**-6 * c.float().abs().max().item())
                        for name in ("K8", "K8 kernels, delta given") for a, c in zip(wrap(fns[name])(), want_bwd))
        if not ok:
            raise AssertionError(f"{who} K7/K8 disagree with their plain versions at {what}")
    mask = "causal" if causal else "non-causal"
    for name, fn in fns.items():
        old, new = through(parent_lib, fn), fn
        turns = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
        print(f"[{name}] {what} ({bh}, {tq}, 64) x {tk} keys, kv_valid_len {kv_len}, {mask}, q_offset {q_offset}: "
              f"parent, change, change, parent {', '.join(f'{t:.4f}' for t in turns)} ms (device time) [{card}]",
              flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout with the earlier kernels' sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels_vs_parent needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    parent_lib = build_parent(args.parent, SOURCE)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(2)
    for what, shape, kv_len, causal, q_offset in SHAPES:
        run_shape(parent_lib, card, what, shape, kv_len, causal, q_offset, gen)


if __name__ == "__main__":
    main()
