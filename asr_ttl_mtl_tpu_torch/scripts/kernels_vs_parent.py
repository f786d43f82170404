"""K9's and K4's device times on the card against an earlier checkout's
kernels, and K4's distance from a float64 reference.

    python -m asr_ttl_mtl_tpu_torch.scripts.kernels_vs_parent --parent DIR

`DIR` holds an earlier checkout's `asr_ttl_mtl_tpu_torch/csrc/topk.cu` and
`mel.cu`, with their earlier C entry points: top-k without the cluster size
(x, values, indices, rows, v, k, stream) and the direct log-mel (audio, cos,
sin, mel_t, out, batch, padded_len, n_frames, n_mels, stream, with the bases
and the filterbank zero-padded to 224 bins). They are built beside the
current ones, each kernel is checked against its plain version, and both are
timed in turns (parent, change, change, parent): device time, one call's
share of a CUDA graph of 10 calls, at K9's (5 | 80 | 160, 51865) bf16 and
(160, 51865) fp32, k 6, and at K4's 32 x 30 s, 1 x 12000 frames and
16 x 30 s, 80 mels. Then K4's error after the finish (max-8 clamp, (x+4)/4)
against a float64 reference (torch.fft), beside the plain version's, at 80
and 128 mels. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch
import torch.nn.functional as F

from ..audio import HOP_LENGTH, N_FFT, mel_filters
from ..ops import _cuda
from ..ops import mel as M
from ..ops import topk as T
from .card_timing import card_line, graph_ms

V = 51865
K = 6
K9_SHAPES = ((5, torch.bfloat16), (80, torch.bfloat16), (160, torch.bfloat16), (160, torch.float32))
K4_SHAPES = ((32, 3000), (1, 12000), (16, 3000))
_P, _I = ctypes.c_void_p, ctypes.c_int


def build_parent(parent: str) -> dict:
    """The parent's topk.cu and mel.cu, one nvcc each, in parallel, into the
    build directory: {name: loaded library}."""
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    procs = {}
    for name in ("topk", "mel"):
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


def parent_k9(lib, x):
    rows, v = x.shape
    vals = torch.empty(rows, K, device=x.device)
    idx = torch.empty(rows, K, dtype=torch.int32, device=x.device)
    fn = getattr(lib, f"topk_logprobs_{'bf16' if x.dtype == torch.bfloat16 else 'f32'}")
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _P]
    code = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, v, K, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"the parent's K9 failed: CUDA error {code}")
    return vals, idx


def parent_k4(lib, padded, n_frames, consts):
    cos_b, sin_b, mel_t = consts
    out = torch.empty(padded.shape[0], 80, n_frames, device=padded.device)
    lib.log_mel_f32.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
    code = lib.log_mel_f32(padded.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(), mel_t.data_ptr(), out.data_ptr(),
                           padded.shape[0], padded.shape[1], n_frames, 80, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"the parent's K4 failed: CUDA error {code}")
    return out


def finish(x):
    return (torch.maximum(x, x.amax(dim=(-2, -1), keepdim=True) - 8.0) + 4.0) / 4.0


def check_k9(got, x, who):
    pv, pi = T.topk_logprobs_plain(x, K)
    gv, gi = got
    fin = torch.isfinite(pv)
    if not (torch.equal(gi, pi) and bool(((gv - pv).abs() <= 4e-6 * pv.abs().clamp(min=1))[fin].all())):
        raise AssertionError(f"{who} K9 disagrees with its plain version")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout with the earlier K9 and K4 sources")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernels_vs_parent needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    _cuda.build_all(["topk", "mel"])
    old_libs = build_parent(args.parent)
    gen = torch.Generator(device=dev).manual_seed(2)

    for rows, dtype in K9_SHAPES:
        x = (torch.randn((rows, V), generator=gen, device=dev) * 2.0).to(dtype)
        check_k9(T.topk_logprobs(x, K), x, "this tree's")
        check_k9(parent_k9(old_libs["topk"], x), x, "the parent's")
        old, new = (lambda: parent_k9(old_libs["topk"], x)), (lambda: T.topk_logprobs(x, K))
        turns = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
        lib_dev = graph_ms(lambda: torch.topk(x.float().log_softmax(-1), K))
        print(f"[K9] ({rows}, {V}) {str(dtype)[6:]}, cluster of {T.k9_plan(rows, V, *T._card_limits(dev.index or 0))}:"
              f" parent, change, change, parent {', '.join(f'{t:.4f}' for t in turns)} ms; library "
              f"{lib_dev:.4f} ms (device time) [{card}]", flush=True)

    fb = {n: torch.from_numpy(mel_filters(n)).to(dev).double() for n in (80, 128)}
    win = torch.hann_window(N_FFT, dtype=torch.float64, device=dev)
    cos_b, sin_b, mel_t = M._constants(80, dev)
    pad = lambda a, r, c: F.pad(a, (0, c - a.shape[1], 0, r - a.shape[0])).contiguous()  # noqa: E731
    consts = (pad(cos_b, N_FFT, 224), pad(sin_b, N_FFT, 224), pad(mel_t, 224, 80))
    for batch, n_frames in K4_SHAPES:
        wave = torch.randn((batch, n_frames * HOP_LENGTH), generator=gen, device=dev) * 0.1
        padded = F.pad(wave[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0].contiguous()
        old = lambda: parent_k4(old_libs["mel"], padded, n_frames, consts)  # noqa: E731
        new = lambda: M.log_mel(padded, n_frames, 80)  # noqa: E731
        want = finish(M.log_mel_plain(padded, n_frames, 80))
        for who, fn in (("this tree's", new), ("the parent's", old)):
            if (finish(fn()) - want).abs().max().item() > 1e-4:
                raise AssertionError(f"{who} K4 disagrees with its plain version")
        turns = [graph_ms(old), graph_ms(new), graph_ms(new), graph_ms(old)]
        line = f"[K4] ({batch}, {n_frames}): parent, change, change, parent {', '.join(f'{t:.4f}' for t in turns)} ms"
        line += " (device time);"
        power = torch.fft.rfft(padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :n_frames].double() * win, dim=-1).abs() ** 2
        for n_mels in (80, 128):
            exact = finish(torch.log10(torch.clamp(power @ fb[n_mels].T, min=1e-10)).transpose(1, 2))
            errs = [(finish(f(padded, n_frames, n_mels)).double() - exact).abs() for f in (M.log_mel, M.log_mel_plain)]
            line += (f" {n_mels} mels, |x - float64| after the finish: kernel max {errs[0].max().item():.3e} mean "
                     f"{errs[0].mean().item():.3e}, plain max {errs[1].max().item():.3e} mean "
                     f"{errs[1].mean().item():.3e};")
        print(line + f" [{card}]", flush=True)
        del wave, padded, power


if __name__ == "__main__":
    main()
