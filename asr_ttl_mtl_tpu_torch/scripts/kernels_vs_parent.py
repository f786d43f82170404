"""K12's, K13's and K11's device times on the card against an earlier checkout's.

    python -m asr_ttl_mtl_tpu_torch.scripts.kernels_vs_parent --parent DIR

`DIR` holds an earlier checkout's `asr_ttl_mtl_tpu_torch/csrc`. The parent's
`dtw.cu` and `median.cu` are built beside the current ones and loaded with
the same C signatures (`dtw_paths_f32`, `dtw_trace_f32`,
`median_filter_f32`). At each shape below, both kernels are held exactly to
their plain version (the same NaN mask and values; ti, tj and lens equal),
then timed in turns (parent, change, change, parent): device time, one
call's share of a CUDA graph of 10 calls. K12 is launched through its C
entry on fixed buffers (the wrapper's host-to-device copy of the row
lengths stays outside the graph); K13 and K11 through the port's wrappers.
Needs a CUDA device.

- K12: a seeded chunk like the batched words run's, (16, 61, 1500) with rows
  of 5-52 tokens x 250-1500 frames; base's largest chunk (16, 444, 1500);
  each padded by repeating a row, as `find_alignment_batch` pads its last
  chunk;
- K13: the words runs' largest (52, 1500) and a real window's (225, 1500);
- K11: widths 7 and 13 at (8, 56, 1500) and (8, 229, 1500), fp32 with a
  NaN column.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..ops import _cuda
from ..ops import dtw as DT
from ..ops import median as MD
from .card_timing import card_line, graph_ms

SOURCES = ("dtw", "median")


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


def k12_raw(lib, x, n, m):
    """K12's C entry from `lib` on fixed buffers: a function that launches
    it, and the (ti, tj, lens) it writes."""
    b, n_max, m_max = x.shape
    dev = x.device
    nm = torch.tensor([list(n), list(m)], dtype=torch.int32, device=dev)
    ti = torch.empty((b, n_max + m_max), dtype=torch.int32, device=dev)
    tj, lens = torch.empty_like(ti), torch.empty(b, dtype=torch.int32, device=dev)
    trace = DT.k12_trace_scratch(b, n_max, m_max, dev)

    def run():
        code = lib.dtw_paths_f32(x.data_ptr(), trace.data_ptr(), ti.data_ptr(), tj.data_ptr(), lens.data_ptr(),
                                 nm[0].data_ptr(), nm[1].data_ptr(), b, n_max, m_max, _cuda.stream_handle(dev))
        if code != 0:
            raise RuntimeError(f"dtw_paths_f32: {lib.kernel_error_string(code).decode()}")

    return run, (ti, tj, lens)


def same(got, want) -> bool:
    """The same NaN mask and the same values elsewhere."""
    return (torch.equal(torch.isnan(got.float()), torch.isnan(want.float()))
            and torch.equal(torch.nan_to_num(got.float()), torch.nan_to_num(want.float())))


def turns(card, label, old, new) -> None:
    times = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
    print(f"[{label}]: parent, change, change, parent {', '.join(f'{t:.4f}' for t in times)} ms (device time) "
          f"[{card}]", flush=True)


def k12_chunk(seed, b, n_max, m_max, n_range, m_range):
    """A seeded chunk: row 0 at (n_max, m_max), the others drawn from the
    ranges; costs like a negated, standardized attention matrix."""
    rng = np.random.RandomState(seed)
    ns, ms = rng.randint(*n_range, size=b).tolist(), rng.randint(*m_range, size=b).tolist()
    ns[0], ms[0] = n_max, m_max
    x = torch.from_numpy(rng.randn(b, n_max, m_max).astype(np.float32)).cuda()
    return x, ns, ms


def padded(chunk):
    x, ns, ms = chunk
    keep = x.shape[0] * 2 // 3
    rows = list(range(keep)) + [keep - 1] * (x.shape[0] - keep)
    return x[rows].contiguous(), [ns[r] for r in rows], [ms[r] for r in rows]


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout with the earlier kernels' sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels_vs_parent needs a CUDA device")
    card = card_line()
    print(card, flush=True)
    parent = build_parent(args.parent)

    run_b = k12_chunk(61, 16, 52, 1500, (5, 53), (250, 1501))
    run_b = (torch.nn.functional.pad(run_b[0], (0, 0, 0, 9)), run_b[1], run_b[2])  # (16, 61, 1500), as run (b)
    base = k12_chunk(444, 16, 444, 1500, (2, 445), (1, 1501))
    for what, (x, ns, ms) in (("run (b)'s chunk", run_b), ("run (b)'s chunk padded", padded(run_b)),
                              ("base's largest chunk", base), ("base's largest chunk padded", padded(base))):
        want = DT.dtw_paths_batch_plain(x, ns, ms)
        runs = {}
        for who, lib in (("parent", parent["dtw"]), ("change", _cuda.lib("dtw"))):
            run, outs = k12_raw(lib, x, ns, ms)
            run()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(outs, want)):
                raise AssertionError(f"the {who}'s K12 disagrees with its plain version at {what}")
            runs[who] = run
        turns(card, f"K12 {what} {tuple(x.shape)}, rows of {min(ns)}-{max(ns)} tokens x {min(ms)}-{max(ms)} frames",
              runs["parent"], runs["change"])

    for n, m in ((52, 1500), (225, 1500)):
        x = torch.from_numpy(np.random.RandomState(n).randn(n, m).astype(np.float32)).cuda()
        want = DT.dtw_trace_plain(x)
        fn = lambda x=x: DT.dtw_trace(x)  # noqa: E731
        for who, run in (("parent", through(parent["dtw"], "dtw", fn)), ("change", fn)):
            if not torch.equal(run(), want):
                raise AssertionError(f"the {who}'s K13 disagrees with its plain version at ({n}, {m})")
        turns(card, f"K13 ({n}, {m})", through(parent["dtw"], "dtw", fn), fn)

    for shape in ((8, 56, 1500), (8, 229, 1500)):
        x = torch.from_numpy(np.random.RandomState(shape[1]).randn(*shape).astype(np.float32)).cuda()
        x[..., shape[-1] // 2] = float("nan")  # a zero-variance column after the standardization
        for width in (7, 13):
            want = MD.median_filter_network_plain(x, width)
            fn = lambda x=x, width=width: MD.median_filter_network(x, width)  # noqa: E731
            for who, run in (("parent", through(parent["median"], "median", fn)), ("change", fn)):
                if not same(run(), want):
                    raise AssertionError(f"the {who}'s K11 disagrees with its plain version at {shape}, width {width}")
            turns(card, f"K11 {shape} fp32, width {width}", through(parent["median"], "median", fn), fn)


if __name__ == "__main__":
    main()
