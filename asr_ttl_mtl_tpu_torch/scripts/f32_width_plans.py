"""The fp32 flash kernels' plan at head width 128 against the plans it was chosen over, on the card.

    python -m asr_ttl_mtl_tpu_torch.scripts.f32_width_plans

`csrc/flash_attention.cu` namespace `f32` keeps, at dh 128, the dk/dv
kernel's K and V raw (`Cfg::kKvRaw`, two CTAs an SM) and scores the forward
32 keys at a time (`kFwdPart`). Two patched copies of the source are built
beside this tree's library and loaded with the same C signatures:
`split_kv` (K and V in split tiles beside 32-query tiles: 224.5 KB, one CTA
an SM, so the check that two fit goes too) and `part16` (16-key forward
parts: less spill). Each is held to the plain version within 2e-5 of its
largest output and timed against this tree's in turns (variant, this
tree, this tree, variant; device time, a call's share of a CUDA graph of
10 calls) at phase 21's shapes: K3 and
K3-lse at the encoder's (8, 1536, 512) keys to 1500 (`part16`), K6 there
and K8 at the train bucket's causal (32, 48, 128) and at q_offset 48
(`split_kv`). Then the dq and dk/dv kernels' device time a call under
torch.profiler for K6 at dh 32, 64 and 128 (and 128 `split_kv`), and
ptxas's registers and spills of the dh 128 instances of each build. Needs
a CUDA device.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from ..ops import _cuda
from ..ops import flash_attention as FA
from .card_timing import card_line
from .kernels_vs_parent import compare, through, turns

# variant -> [(a line of this tree's source, its replacement)]
VARIANTS = {
    "split_kv": [("  static constexpr bool kKvRaw = kDh == 128;", "  static constexpr bool kKvRaw = false;"),
                 ("two_an_sm(kFwdSmem) && two_an_sm(kDqSmem) && two_an_sm(kDkvSmem)",
                  "two_an_sm(kFwdSmem) && two_an_sm(kDqSmem)")],
    "part16": [("constexpr int kFwdPart = 32;", "constexpr int kFwdPart = 16;")],
}


def build_variants() -> dict:
    """Each variant's patched copy of `csrc/flash_attention.cu`, built by
    nvcc into the build directory while this tree's builds, and loaded."""
    with open(os.path.join(_cuda.CSRC, "flash_attention.cu")) as f:
        src = f.read()
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        patched = src
        for old, new in edits:
            if patched.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in flash_attention.cu once")
            patched = patched.replace(old, new)
        path = os.path.join(_cuda.BUILD_DIR, f"variant_{name}.cu")
        with open(path, "w") as f:
            f.write(patched)
        out = path[:-3] + ".so"
        log = open(f"{out}.log", "w")
        procs[name] = (subprocess.Popen([_cuda.nvcc(), *_cuda.NVCC_FLAGS, "-o", out, path], stdout=log,
                                        stderr=subprocess.STDOUT), out, log)
    _cuda.build_all(["flash_attention"])
    rcs = {name: proc.wait() for name, (proc, _, _) in procs.items()}
    libs = {}
    for name, (_, out, log) in procs.items():
        log.close()
        if rcs[name] != 0:
            with open(f"{out}.log") as f:
                raise RuntimeError(f"nvcc failed for variant {name}:\n{f.read()[-3000:]}")
        lib = ctypes.CDLL(out)
        for fn, argtypes in _cuda.SIGNATURES["flash_attention"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def ptxas_dh128(label: str, report: str) -> None:
    """ptxas's registers and spills of a build's fp32 instances at dh 128."""
    entry = "?"
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "3f32" in entry and "ILi128E" in entry and ("registers" in line or "spill" in line):
            print(f"[ptxas {label}] {entry}: {line.strip()}", flush=True)


def cases(dev):
    """{variant: [(label, kernel call, plain call)]} at phase 21's fp32 shapes, and K6 at each width."""
    gen = torch.Generator(device=dev).manual_seed(20)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    out = {"part16": [], "split_kv": [], "widths": []}
    for dh in (128, 64, 32):
        n_head = 512 // dh
        q, k, v, g = rnd(8, 1536, 512), rnd(8, 1536, 512), rnd(8, 1536, 512), rnd(8, 1536, 512)
        kw = dict(n_head=n_head, kv_valid_len=1500, scale=dh**-0.5)
        pout, plse = FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
        delta = FA.h2_delta(g, pout, n_head)
        k6 = (f"K6 fp32 dh {dh} (8, 1536, 512), keys to 1500",
              lambda q=q, k=k, v=v, g=g, l=plse, dl=delta, kw=kw: FA.flash_attention_h2_bwd(q, k, v, l, dl, g, **kw),
              lambda q=q, k=k, v=v, g=g, l=plse, dl=delta, kw=kw: FA.flash_attention_h2_bwd_plain(q, k, v, l, dl, g,
                                                                                                   **kw))
        out["widths"].append(k6)
        if dh != 128:
            continue
        out["split_kv"].append(k6)
        for lse in (False, True):
            out["part16"].append((f"K3{'-lse' if lse else ''} fp32 dh 128 (8, 1536, 512), keys to 1500",
                                  lambda q=q, k=k, v=v, kw=kw, lse=lse: FA.flash_attention_h2(q, k, v, return_lse=lse,
                                                                                              **kw),
                                  lambda q=q, k=k, v=v, kw=kw, lse=lse: FA.flash_attention_h2_plain(
                                      q, k, v, return_lse=lse, **kw)))
    for q_offset in (0, 48):
        tk = 48 + q_offset
        q, k, v, g = rnd(32, 48, 128), rnd(32, tk, 128), rnd(32, tk, 128), rnd(32, 48, 128)
        kw = dict(causal=True, q_offset=q_offset, scale=128**-0.5)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        out["split_kv"].append((f"K8 fp32 dh 128 causal (32, 48, 128) over {tk} keys, q_offset {q_offset}",
                                lambda q=q, k=k, v=v, g=g, o=pout, l=plse, kw=kw: FA.flash_attention_bwd(
                                    q, k, v, o, l, g, **kw),
                                lambda q=q, k=k, v=v, g=g, o=pout, l=plse, kw=kw: FA.flash_attention_bwd_plain(
                                    q, k, v, o, l, g, **kw)))
    return out


def kernel_split(card: str, label: str, run) -> None:
    """The dq and dk/dv kernels' device time a call (torch.profiler, 5 calls)."""
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if "bwd_dq_kernel" in ev.key or "bwd_dkv_kernel" in ev.key:
            total = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            which = "dq" if "bwd_dq_kernel" in ev.key else "dk/dv"
            print(f"[profile] {label}: {which} {total / ev.count / 1e3:.4f} ms a call ({ev.count} calls) [{card}]",
                  flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("f32_width_plans needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions in true fp32
    card = card_line()
    print(card, flush=True)
    libs = build_variants()
    ptxas_dh128("this tree", _cuda.ptxas_report("flash_attention"))
    for name in VARIANTS:
        with open(os.path.join(_cuda.BUILD_DIR, f"variant_{name}.so.log")) as f:
            ptxas_dh128(name, f.read())
    all_cases = cases(torch.device("cuda"))
    for name, lib in libs.items():
        for label, run, plain in all_cases[name]:
            variant = through(lib, "flash_attention", run)
            compare(f"{label}: {name} as 'parent', this tree as 'change'", variant, run, plain)
            turns(card, f"{label}: {name}, this tree, this tree, {name}", variant, run)
    for label, run, _ in all_cases["widths"]:
        kernel_split(card, f"{label}, this tree", run)
        if "dh 128" in label:
            kernel_split(card, f"{label}, split_kv", through(libs["split_kv"], "flash_attention", run))


if __name__ == "__main__":
    main()
