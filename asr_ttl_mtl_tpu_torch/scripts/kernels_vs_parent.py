"""The bf16 K5's device times on the card against an earlier checkout's.

    python -m asr_ttl_mtl_tpu_torch.scripts.kernels_vs_parent --parent DIR

`DIR` holds an earlier checkout's `asr_ttl_mtl_tpu_torch/csrc`. The parent's
`flash_attention.cu` is built beside the current one and loaded with the
same C signatures; the port's wrappers launch from either library. At
`chip_smoke.py` phase 24's dh96 encoder ((8, 1536, 768), 8 heads, keys to
1500) and phase 19's (2, 200, 300) shapes (4 heads of 8 and of 80, 1 of
768; 2 of 136, 3 of 256, 2 of 384), K5 in bf16 (`flash_mh_fwd_bf16`) from
both libraries is held to its plain version within 2^-6 of its largest
output, their largest difference from each other is printed, and both
are timed in turns (parent, change, change, parent): device time, one
call's share of a CUDA graph of 10 calls; then SDPA over the valid keys on
the same views, and a call of each (CUDA events). Last, ptxas's registers
and spills for the K5 kernels of both builds. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops import flash_attention as FA
from .card_timing import card_line, graph_ms

SOURCES = ("flash_attention",)
FP32_REL = 2e-5  # as chip_smoke.py: a share of the plain version's largest output
BF16_REL = 2.0**-6  # bf16 rounds p and the output at other places (chip_smoke's K5 tolerance)


def build_parent(parent: str, names=SOURCES) -> dict:
    """The parent's `csrc/<name>.cu` for each name, built by nvcc into the
    build directory while this tree's build beside them, and loaded with
    this tree's C signatures."""
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(parent, "asr_ttl_mtl_tpu_torch", "csrc", f"{name}.cu")
        out = os.path.join(_cuda.BUILD_DIR, f"parent_{name}.so")
        log = open(f"{out}.log", "w")
        procs[name] = (subprocess.Popen([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", out, src], stdout=log,
                                        stderr=subprocess.STDOUT), out, log)
    _cuda.build_all(names)
    libs = {}
    for name, (proc, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}.cu: see {out}.log")
        lib = ctypes.CDLL(out)
        for fn, argtypes in _cuda.SIGNATURES[name].items():
            if not hasattr(lib, fn):  # an entry this tree added
                continue
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def through(lib, source, fn):
    """`fn` with the port's wrappers launching from `lib` instead of this tree's library."""

    def run():
        own = _cuda.lib(source)
        _cuda._LIBS[source] = lib
        try:
            return fn()
        finally:
            _cuda._LIBS[source] = own

    return run


def outputs(x):
    return list(x) if isinstance(x, (tuple, list)) else [x]


def turns(card, label, old, new) -> None:
    times = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
    print(f"[{label}]: parent, change, change, parent {', '.join(f'{t:.4f}' for t in times)} ms (device time) "
          f"[{card}]", flush=True)


def compare(label, parent_run, change_run, plain_run, rel: float = FP32_REL) -> None:
    """Both libraries within `rel` of the plain version's largest output, output by output."""
    want = outputs(plain_run())
    got = {who: outputs(run()) for who, run in (("parent", parent_run), ("change", change_run))}
    torch.cuda.synchronize()
    worst = {}
    for who, outs in got.items():
        worst[who] = max(((o.float() - w.float()).abs().max() / (rel * w.float().abs().max())).item()
                         for o, w in zip(outs, want))
        if worst[who] > 1.0:
            raise AssertionError(f"{label}: the {who}'s kernel is {worst[who]:.3f} x its tolerance from the plain version")
    apart = max((a.float() - b.float()).abs().max().item() for a, b in zip(got["parent"], got["change"]))
    print(f"[{label}] worst err / tol: parent {worst['parent']:.4f}, change {worst['change']:.4f}; "
          f"max |parent - change| {apart:.3e}", flush=True)


def call_ms(fn, iters: int = 20) -> float:
    """Median of per-call CUDA-event timings (chip_smoke's `timed_ms`)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cases(dev):
    """(label, K5 call, plain call, SDPA call) at phase 24's dh96 encoder and phase 19's shapes."""
    gen = torch.Generator(device=dev).manual_seed(22)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    out = []
    for b, tq, tk, dh, n_head, kv, what in [(8, 1536, 1536, 96, 8, 1500, "phase 24's dh96 encoder"),
                                            (2, 200, 300, 8, 4, 270, "phase 19"), (2, 200, 300, 80, 4, 270, "phase 19"),
                                            (2, 200, 300, 768, 1, 270, "phase 19"),
                                            (2, 200, 300, 136, 2, 270, "phase 19"),
                                            (2, 200, 300, 256, 3, 270, "phase 19"),
                                            (2, 200, 300, 384, 2, 270, "phase 19")]:
        d = dh * n_head
        q, k, v = rnd(b, tq, d), rnd(b, tk, d), rnd(b, tk, d)
        kw = dict(n_head=n_head, kv_valid_len=kv, scale=dh**-0.5)
        qh, kh, vh = (x[:, :t].reshape(b, t, n_head, dh).transpose(1, 2) for x, t in ((q, tq), (k, kv), (v, kv)))
        plan = FA.k5_plan(dh, tq)
        out.append((f"K5 {what} ({b}, {tq}, {d}) x {tk}, {n_head} heads of {dh}, keys to {kv}, route {plan.route}",
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_mh(q, k, v, **kw),
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_mh_plain(q, k, v, **kw),
                    lambda qh=qh, kh=kh, vh=vh, s=dh**-0.5: F.scaled_dot_product_attention(qh, kh, vh, scale=s)))
    return out


def ptxas_lines(log_text: str, keys) -> None:
    """ptxas's registers and spills of the kernels whose mangled names hold one of `keys`."""
    entry = "?"
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif any(k in entry for k in keys) and ("registers" in line or "spill" in line):
            print(f"[ptxas] {entry}: {line.strip()}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout with the earlier kernels' sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels_vs_parent needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    parent = build_parent(args.parent)["flash_attention"]
    dev = torch.device("cuda")
    for label, run, plain, sdpa in cases(dev):
        old = through(parent, "flash_attention", run)
        compare(label, old, run, plain, BF16_REL)
        turns(card, label, old, run)
        print(f"[{label}] a call: change {call_ms(run):.4f}, parent {call_ms(old):.4f}; SDPA over the valid keys "
              f"{call_ms(sdpa):.4f}, device {graph_ms(sdpa):.4f} ms [{card}]", flush=True)
    # the K5 kernels: route A (the forward's head-map instances, template flag
    # kHeads, `ELb0ELb1E`), route B (`flash_fwd_wide`) and the parent's WMMA kernel
    ptxas_lines(_cuda.ptxas_report("flash_attention"), ("ELb0ELb1E", "flash_fwd_wide"))
    with open(os.path.join(_cuda.BUILD_DIR, "parent_flash_attention.so.log")) as f:
        ptxas_lines(f.read(), ("flash_mh_kernel",))


if __name__ == "__main__":
    main()
