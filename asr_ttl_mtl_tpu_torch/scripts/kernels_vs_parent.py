"""The bf16 K5's, K1's and K2's device times on the card against earlier checkouts'.

    python -m asr_ttl_mtl_tpu_torch.scripts.kernels_vs_parent --parent DIR [--parent DIR2] \
        [--sources flash_attention decode_attention]

Each `DIR` holds an earlier checkout's `asr_ttl_mtl_tpu_torch/csrc`. Its
sources (`--sources`, both by default) are built beside the current ones
and loaded with the same C signatures; the port's wrappers launch from
either library. `flash_attention`: at `chip_smoke.py` phase 24's dh96
encoder ((8, 1536, 768), 8 heads, keys to 1500) and phase 19's (2, 200,
300) shapes (4 heads of 8 and of 80, 1 of 768; 2 of 136, 3 of 256, 2 of
384), K5 in bf16 (`flash_mh_fwd_bf16`). `decode_attention`: at phases 3
and 4's base shapes, K2 over the bf16 cross cache (6, 32, 1500, 512) at
groups 1 and 5 and the self cache (6, 32, 128, 512) to position 70, and
K1 over their int8 stores (the cross to 1499, tk_blk 256) at groups 1 and
5 and the self to 70. Each call from each library is held to its plain
version (K5 within 2^-6 of its largest output, K2 2^-7, K1 2^-6), their
largest difference from each other is printed, and both are timed in
turns (parent, change, change, parent): device time, one call's share of
a CUDA graph of 10 calls; then the library call (SDPA over the valid keys
on the same views; none for K1), and a call of each (CUDA events). Last,
ptxas's registers and spills for the K5 kernels of both builds. Needs a
CUDA device.
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
from ..ops import decode_attention as DA
from ..ops import flash_attention as FA
from .card_timing import card_line, graph_ms

SOURCES = ("flash_attention", "decode_attention")
FP32_REL = 2e-5  # as chip_smoke.py: a share of the plain version's largest output
BF16_REL = 2.0**-6  # bf16 rounds p and the output at other places (chip_smoke's K5 tolerance)
K2_REL = 2.0**-7  # chip_smoke's K2 tolerance: 2 bf16 ulps of the largest output


def build_parent(parent: str, names=SOURCES, tag: str = "parent") -> dict:
    """The parent's `csrc/<name>.cu` for each name, built by nvcc into the
    build directory (as `<tag>_<name>.so`) while this tree's build beside
    them, and loaded with this tree's C signatures."""
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src = os.path.join(parent, "asr_ttl_mtl_tpu_torch", "csrc", f"{name}.cu")
        out = os.path.join(_cuda.BUILD_DIR, f"{tag}_{name}.so")
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


def decode_cases(dev):
    """(label, K1 or K2 call, plain call, SDPA call or None) at phases 3 and 4's base shapes, bf16."""
    gen = torch.Generator(device=dev).manual_seed(25)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    cross_k, cross_v = rnd(6, 32, 1500, 512), rnd(6, 32, 1500, 512)
    self_k, self_v = rnd(6, 32, 128, 512), rnd(6, 32, 128, 512)
    i8 = {"cross": [*DA.quantize_kv_rows(cross_k), *DA.quantize_kv_rows(cross_v)],
          "self": [*DA.quantize_kv_rows(self_k), *DA.quantize_kv_rows(self_v)]}
    scale = 64**-0.5
    out = []
    for what, ck, cv, valid, group in (("cross (6,32,1500,512)", cross_k, cross_v, None, 1),
                                       ("cross (6,32,1500,512)", cross_k, cross_v, None, 5),
                                       ("self (6,32,128,512), valid_upto 70", self_k, self_v, 70, 1)):
        q = rnd(32 * group, 1, 512)
        kw = dict(scale=scale, valid_upto=valid, group=group)
        n_keys = ck.shape[2] if valid is None else valid + 1
        qh = q.reshape(32, group, 8, 64).transpose(1, 2)
        kh, vh = (x[5, :, :n_keys].reshape(32, n_keys, 8, 64).transpose(1, 2) for x in (ck, cv))
        out.append((f"K2 {what} bf16, group {group}", K2_REL,
                    lambda q=q, ck=ck, cv=cv, kw=kw: DA.decode_attention(q, ck, cv, 5, 8, **kw),
                    lambda q=q, ck=ck, cv=cv, kw=kw: DA.decode_attention_plain(q, ck, cv, 5, 8, **kw),
                    lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)))
    for what, valid, group in (("cross (6,32,1536,512) int8, valid_upto 1499", 1499, 1),
                               ("cross (6,32,1536,512) int8, valid_upto 1499", 1499, 5),
                               ("self (6,32,128,512) int8, valid_upto 70", 70, 1)):
        k8, ks, v8, vs = i8["cross" if valid == 1499 else "self"]
        q = rnd(32 * group, 1, 512)
        kw = dict(scale=scale, valid_upto=valid, group=group)
        out.append((f"K1 {what}, group {group}", BF16_REL,
                    lambda q=q, a=(k8, ks, v8, vs), kw=kw: DA.decode_attention_i8(q, *a, 5, 8, **kw),
                    lambda q=q, a=(k8, ks, v8, vs), kw=kw: DA.decode_attention_i8_plain(q, *a, 5, 8, **kw), None))
    return out


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
                    BF16_REL, lambda q=q, k=k, v=v, kw=kw: FA.flash_attention_mh(q, k, v, **kw),
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
    parser.add_argument("--parent", required=True, action="append",
                        help="a checkout with the earlier kernels' sources (repeat for several)")
    parser.add_argument("--sources", nargs="+", choices=SOURCES, default=list(SOURCES))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels_vs_parent needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    case_sets = {"flash_attention": cases, "decode_attention": decode_cases}
    for i, parent_dir in enumerate(args.parent):
        tag = f"parent{i}"
        libs = build_parent(parent_dir, args.sources, tag)
        print(f"[{tag}] {parent_dir}", flush=True)
        for source in args.sources:
            for label, rel, run, plain, library in case_sets[source](dev):
                label = f"{tag} {label}"
                old = through(libs[source], source, run)
                compare(label, old, run, plain, rel)
                turns(card, label, old, run)
                lib_s = f"; library {call_ms(library):.4f}, device {graph_ms(library):.4f}" if library else ""
                print(f"[{label}] a call: change {call_ms(run):.4f}, parent {call_ms(old):.4f}{lib_s} ms [{card}]",
                      flush=True)
        if "flash_attention" in args.sources:
            # the K5 kernels: route A (the forward's head-map instances, template
            # flag kHeads, `ELb0ELb1E`), route B (`flash_fwd_wide`) and a parent's WMMA kernel
            ptxas_lines(_cuda.ptxas_report("flash_attention"), ("ELb0ELb1E", "flash_fwd_wide"))
            with open(os.path.join(_cuda.BUILD_DIR, f"{tag}_flash_attention.so.log")) as f:
                ptxas_lines(f.read(), ("flash_mh_kernel",))


if __name__ == "__main__":
    main()
