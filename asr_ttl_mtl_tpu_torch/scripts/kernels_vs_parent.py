"""K14's and K13's device times on the card against an earlier checkout's.

    python -m asr_ttl_mtl_tpu_torch.scripts.kernels_vs_parent --parent DIR

`DIR` holds an earlier checkout's `asr_ttl_mtl_tpu_torch/csrc`. The parent's
`int8_mlp.cu` and `dtw.cu` are built beside the current ones, each kernel is
checked against its plain version, and both are timed in turns (parent,
change, change, parent): device time, one call's share of a CUDA graph of
10 calls. Needs a CUDA device.

- K14: the parent's entry `int8_mlp_bf16` (x, w1, s1, b1, w2, s2, b2, out,
  qx, qg, sg, n, d, hidden, stream), at phase 17's (49152, 512, 2048) bf16
  with base-like weights; both held to the plain version (qx equal, qg
  within one step, the output within a step per flipped qg and a bf16
  rounding).
- K13: the parent's entry `dtw_trace_f32` (x, trace, n, m, stream), at the
  words runs' largest (52, 1500) and a real window's (225, 1500), seeded;
  both exact against the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..models import whisper as W
from ..ops import _cuda
from ..ops import dtw as DT
from ..ops import int8_mlp as IM
from .card_timing import card_line, graph_ms

K14_SHAPE = (49152, 512, 2048)
K13_SHAPES = ((52, 1500), (225, 1500))
SOURCES = ("int8_mlp", "dtw")
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: str, names) -> dict:
    """The parent's sources `names` (e.g. "dtw"), one nvcc each, in parallel,
    into the build directory: {name: loaded library}."""
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(parent, "asr_ttl_mtl_tpu_torch", "csrc", f"{name}.cu")
        out = os.path.join(_cuda.BUILD_DIR, f"parent_{name}.so")
        log = open(f"{out}.log", "w")
        procs[name] = (subprocess.Popen([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", out, src], stdout=log,
                                        stderr=subprocess.STDOUT), out, log)
    libs = {}
    for name, (proc, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu: see {log.name}")
        libs[name] = ctypes.CDLL(out)
    return libs


def parent_k14(lib, args, return_int8=False):
    x, w1q, s1, b1, w2q, s2, b2 = args
    (n, d), hidden = x.shape, w1q.shape[0]
    out = torch.empty_like(x)
    mid = [torch.empty((n, d), dtype=torch.int8, device=x.device),
           torch.empty((n, hidden), dtype=torch.int8, device=x.device),
           torch.empty((n, 1), device=x.device)] if return_int8 else []
    lib.int8_mlp_bf16.argtypes = [_P] * 11 + [_I, _I, _I, _P]
    code = lib.int8_mlp_bf16(x.data_ptr(), w1q.data_ptr(), s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
                             s2.data_ptr(), b2.data_ptr(), out.data_ptr(), *[t.data_ptr() for t in mid] or
                             [None] * 3, n, d, hidden, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"the parent's K14 failed: CUDA error {code}")
    return (out, *mid) if return_int8 else out


def parent_k13(lib, x):
    n, m = x.shape
    trace = torch.empty((n + 1, m + 1), dtype=torch.int8, device=x.device)
    lib.dtw_trace_f32.argtypes = [_P, _P, _I, _I, _P]
    code = lib.dtw_trace_f32(x.data_ptr(), trace.data_ptr(), n, m, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"the parent's K13 failed: CUDA error {code}")
    return trace


def check_k14(got, want, args):
    """K14's (out, qx, qg, sg) against the plain version's: qx equal, qg
    within one step, the output within one activation step per flipped
    second intermediate and a bf16 rounding."""
    w2q, s2 = args[4], args[5]
    out, pqx, pqg, psg = want
    flips = (got[2].int() - pqg.int()).abs()
    tol = (flips.float() @ w2q.float().abs().t()) * psg * s2.reshape(1, -1) + 2.0**-7 * out.float().abs() + 1e-5
    return (torch.equal(got[1], pqx) and flips.max().item() <= 1
            and bool(((got[0].float() - out.float()).abs() <= tol).all()))


def run_k14(lib, card, gen):
    n, d, hidden = K14_SHAPE
    dev = torch.device("cuda")
    x = torch.randn((n, d), generator=gen, device=dev).bfloat16()
    w1, w2 = (torch.randn(s, generator=gen, device=dev) * 0.05 for s in ((hidden, d), (d, hidden)))
    w1q, s1 = W._quant_rowwise_sym(w1)
    w2q, s2 = W._quant_rowwise_sym(w2)
    args = (x, w1q, s1.reshape(-1), torch.randn(hidden, generator=gen, device=dev) * 0.1, w2q, s2.reshape(-1),
            torch.randn(d, generator=gen, device=dev) * 0.1)
    want = IM.int8_mlp_plain(*args, return_int8=True)
    for who, fn in (("this tree's", lambda: IM.int8_mlp(*args, return_int8=True)),
                    ("the parent's", lambda: parent_k14(lib, args, return_int8=True))):
        if not check_k14(fn(), want, args):
            raise AssertionError(f"{who} K14 disagrees with its plain version")
    old, new = (lambda: parent_k14(lib, args)), (lambda: IM.int8_mlp(*args))
    turns = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
    print(f"[K14] ({n}, {d}, {hidden}) bf16, {IM.k14_plan(n, d, hidden)}: parent, change, change, parent "
          f"{', '.join(f'{t:.4f}' for t in turns)} ms (device time) [{card}]", flush=True)


def run_k13(lib, card):
    dev = torch.device("cuda")
    for shape in K13_SHAPES:
        x = torch.from_numpy(np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)).to(dev)
        want = DT.dtw_trace_plain(x)
        for who, fn in (("this tree's", lambda: DT.dtw_trace(x)), ("the parent's", lambda: parent_k13(lib, x))):
            if not torch.equal(fn(), want):
                raise AssertionError(f"{who} K13 disagrees with its plain version at {shape}")
        old, new = (lambda: parent_k13(lib, x)), (lambda: DT.dtw_trace(x))
        turns = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
        print(f"[K13] {shape} fp32, (rows a lane, chunk, compute warps, helpers a warp, smem) {DT.k13_plan(*shape)}: "
              f"parent, change, change, parent {', '.join(f'{t:.4f}' for t in turns)} ms (device time) [{card}]",
              flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout with the earlier kernels' sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels_vs_parent needs a CUDA device")
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    _cuda.build_all(SOURCES)
    old_libs = build_parent(args.parent, SOURCES)
    run_k14(old_libs["int8_mlp"], card, torch.Generator(device=dev).manual_seed(2))
    run_k13(old_libs["dtw"], card)


if __name__ == "__main__":
    main()
