"""The fp32 flash kernels' device times on the card against an earlier checkout's.

    python -m asr_ttl_mtl_tpu_torch.scripts.kernels_vs_parent --parent DIR

`DIR` holds an earlier checkout's `asr_ttl_mtl_tpu_torch/csrc`. The parent's
`flash_attention.cu` is built beside the current one and loaded with the
same C signatures; the port's wrappers launch from either library. At each
of `chip_smoke.py` phase 20's shapes, K3, K3-lse, K5, K6, K7, K7-lse and K8
in fp32 (`flash_h2_fwd_f32`, `flash_mh_fwd_f32`, `flash_h2_bwd_f32`,
`flash_fwd_f32` causal and not, `flash_bwd_f32`) from both libraries are
held to their plain version within 2e-5 of its largest output, output by
output (out, lse, dq, dk, dv), their largest difference from each other is
printed, and both are timed in turns (parent, change, change, parent):
device time, one call's share of a CUDA graph of 10 calls.

Then, at the encoder shapes, `scaled_dot_product_attention` in fp32 and its
backward under `torch.profiler`: the kernels that serve them (the backend
is in their names) and their device time a call; the card's rate of
mma.sync m16n8k8 tf32 (`tf32_mma_probe`); last, the current library's fp32
flash kernels in `cuobjdump -sass`: TF32 HMMA, FFMA and shared-memory load
instructions, and ptxas's registers and spills. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess

import torch
import torch.nn.functional as F

from ..ops import _cuda
from ..ops import flash_attention as FA
from .card_timing import card_line, graph_ms

SOURCES = ("flash_attention",)
FP32_REL = 2e-5  # as chip_smoke.py: a share of the plain version's largest output
SCALE = 0.125


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


def compare(label, parent_run, change_run, plain_run) -> None:
    """Both libraries within FP32_REL of the plain version's largest output, output by output."""
    want = outputs(plain_run())
    got = {who: outputs(run()) for who, run in (("parent", parent_run), ("change", change_run))}
    torch.cuda.synchronize()
    worst = {}
    for who, outs in got.items():
        worst[who] = max(((o - w).abs().max() / (FP32_REL * w.abs().max())).item() for o, w in zip(outs, want))
        if worst[who] > 1.0:
            raise AssertionError(f"{label}: the {who}'s kernel is {worst[who]:.3f} x its tolerance from the plain version")
    apart = max((a - b).abs().max().item() for a, b in zip(got["parent"], got["change"]))
    print(f"[{label}] worst err / tol: parent {worst['parent']:.4f}, change {worst['change']:.4f}; "
          f"max |parent - change| {apart:.3e}", flush=True)


def cases(dev):
    """(label, kernel call, plain call) at phase 20's shapes."""
    gen = torch.Generator(device=dev).manual_seed(6)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = []
    for b, tq, tk, kv, what in [(32, 1536, 1536, 1500, "encoder, the fp32 window path"),
                                (16, 48, 1500, None, "cross, evaluate's token bucket")]:
        q, k, v = rnd(b, tq, 512), rnd(b, tk, 512), rnd(b, tk, 512)
        kw = dict(n_head=8, kv_valid_len=kv, scale=SCALE)
        out.append((f"K3 {what} ({b}, {tq}, 512) x {tk}, keys to {kv}",
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_h2(q, k, v, **kw),
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_h2_plain(q, k, v, **kw)))
    for b, tq, tk, kv, what in [(16, 1536, 1536, 1500, "encoder, the fp32 train step"),
                                (16, 48, 1500, None, "cross, the train step's token bucket")]:
        q, k, v, g = rnd(b, tq, 512), rnd(b, tk, 512), rnd(b, tk, 512), rnd(b, tq, 512)
        kw = dict(n_head=8, kv_valid_len=kv, scale=SCALE)
        pout, plse = FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
        delta = FA.h2_delta(g, pout, 8)
        shape = f"({b}, {tq}, 512) x {tk}, keys to {kv}"
        out.append((f"K3-lse {what} {shape}",
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_h2(q, k, v, return_lse=True, **kw),
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)))
        out.append((f"K6 {what} {shape}",
                    lambda q=q, k=k, v=v, g=g, l=plse, dl=delta, kw=kw: FA.flash_attention_h2_bwd(q, k, v, l, dl, g,
                                                                                                 **kw),
                    lambda q=q, k=k, v=v, g=g, l=plse, dl=delta, kw=kw: FA.flash_attention_h2_bwd_plain(
                        q, k, v, l, dl, g, **kw)))
    for b, kv in [(8, 1500), (1, 1500)]:
        q, k, v = rnd(b, 1536, 576), rnd(b, 1536, 576), rnd(b, 1536, 576)
        kw = dict(n_head=9, kv_valid_len=kv, scale=SCALE)
        out.append((f"K5 d=576 encoder ({b}, 1536, 576), 9 heads, keys to {kv}",
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_mh(q, k, v, **kw),
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_mh_plain(q, k, v, **kw)))
    for bh, tq, tk, causal, kv, what in [(128, 48, 48, True, None, "the token bucket, causal"),
                                         (8, 32, 256, True, None, "the CLI's prompted prefill, causal"),
                                         (72, 1536, 1536, False, 1500, "the d=576 encoder, keys to 1500")]:
        q, k, v, g = rnd(bh, tq, 64), rnd(bh, tk, 64), rnd(bh, tk, 64), rnd(bh, tq, 64)
        kw = dict(causal=causal, kv_valid_len=kv, scale=SCALE)
        shape = f"({bh}, {tq}, 64) x {tk}"
        out.append((f"K7 {what} {shape}",
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention(q, k, v, **kw),
                    lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_plain(q, k, v, **kw)))
        if tq == tk:
            pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
            out.append((f"K7-lse {what} {shape}",
                        lambda q=q, k=k, v=v, kw=kw: FA.flash_attention(q, k, v, return_lse=True, **kw),
                        lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_plain(q, k, v, return_lse=True, **kw)))
            out.append((f"K8 {what} {shape}",
                        lambda q=q, k=k, v=v, g=g, o=pout, l=plse, kw=kw: FA.flash_attention_bwd(q, k, v, o, l, g,
                                                                                                  **kw),
                        lambda q=q, k=k, v=v, g=g, o=pout, l=plse, kw=kw: FA.flash_attention_bwd_plain(
                            q, k, v, o, l, g, **kw)))
    return out


def sdpa_kernels(card, dev) -> None:
    """Which kernels serve SDPA's fp32 forward and backward at the encoder
    shapes, and their device time a call (torch.profiler, 5 calls)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=dev).manual_seed(7)
    for what, b, n_head, dh, tq, n_keys in [("K3 / K6 encoder", 16, 8, 64, 1536, 1500),
                                            ("K7 / K8 d=576 encoder", 8, 9, 64, 1536, 1500)]:
        q = torch.randn((b, n_head, tq, dh), generator=gen, device=dev).requires_grad_(True)
        k, v = (torch.randn((b, n_head, n_keys, dh), generator=gen, device=dev).requires_grad_(True) for _ in "kv")
        g = torch.randn((b, n_head, tq, dh), generator=gen, device=dev)
        for phase in ("forward", "backward"):
            out = F.scaled_dot_product_attention(q, k, v, scale=SCALE)

            def call():
                if phase == "forward":
                    return F.scaled_dot_product_attention(q, k, v, scale=SCALE)
                return torch.autograd.grad(out, (q, k, v), g, retain_graph=True)

            for _ in range(3):
                call()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    call()
                torch.cuda.synchronize()
            for ev in sorted(prof.key_averages(), key=lambda e: -e.device_time_total):
                if ev.device_time_total > 0:
                    print(f"[sdpa fp32 {what} ({b}, {n_head}, {tq}, {dh}) x {n_keys} {phase}] {ev.key}: "
                          f"{ev.count // 5} a call, {ev.device_time_total / 5e3:.4f} ms a call (device) [{card}]",
                          flush=True)


def mma_rate(card) -> None:
    """mma.sync m16n8k8 tf32's rate on the card (`tf32_mma_probe`: two CTAs
    of 8 warps an SM, 8 independent products a warp), timed by CUDA events
    at 20000 and 10000 rounds and differenced, so that the launch cancels;
    the best of three."""
    lib = _cuda.lib("flash_attention")
    ctas = 2 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(ctas * 256, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run_ms(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _cuda.check("flash_attention", "tf32_mma_probe", lib.tf32_mma_probe(out.data_ptr(), ctas, iters, stream))
        start.record()
        _cuda.check("flash_attention", "tf32_mma_probe", lib.tf32_mma_probe(out.data_ptr(), ctas, iters, stream))
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    ms = min(run_ms(20000) - run_ms(10000) for _ in range(3))
    flops = ctas * 8 * 10000 * 8 * (2 * 16 * 8 * 8)
    print(f"[mma.sync m16n8k8 tf32] {flops / ms / 1e9:.1f} TFLOP/s ({ctas} CTAs of 8 warps, 8 independent "
          f"products a warp; dense TF32 peak 495) [{card}]", flush=True)


def sass_counts() -> None:
    """TF32 HMMA, FFMA and LDS instructions of each fp32 flash kernel in the
    current library, and ptxas's registers and spills for them."""
    lib = _cuda._lib_path("flash_attention")
    tool = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_cuda.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True, check=True).stdout
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "3f32" not in name:  # namespace f32
            continue
        lines = block.splitlines()
        hmma = sum("HMMA" in x and "TF32" in x for x in lines)
        print(f"[sass] {name}: {hmma} TF32 HMMA, {sum(' FFMA' in x for x in lines)} FFMA, "
              f"{sum(re.search(r' LDS', x) is not None for x in lines)} LDS", flush=True)
    entry = "?"
    for line in _cuda.ptxas_report("flash_attention").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "3f32" in entry and ("registers" in line or "spill" in line):
            print(f"[ptxas] {entry}: {line.strip()}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout with the earlier kernels' sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels_vs_parent needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true fp32
    card = card_line()
    print(card, flush=True)
    parent = build_parent(args.parent)["flash_attention"]
    dev = torch.device("cuda")
    for label, run, plain in cases(dev):
        old = through(parent, "flash_attention", run)
        compare(label, old, run, plain)
        turns(card, label, old, run)
    sdpa_kernels(card, dev)
    mma_rate(card)
    sass_counts()


if __name__ == "__main__":
    main()
