#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`asr_ttl_mtl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: requires CUDA, prints `nvidia-smi` name and power limit;
  2. builds the kernels from `asr_ttl_mtl_tpu_torch/csrc/` (one nvcc per
     source, in parallel, sm_90a);
  3. holds each kernel of the decode slice against its plain PyTorch
     version on the card at the shapes of `base`, with the tolerance stated
     per kernel, and times the kernel, the plain version and one PyTorch
     call computing the same function (`library_ms`, never called by the
     port), medians of CUDA-event timings, beside the kernel's bound (the
     larger of its bytes over 3.35 TB/s and its operations over the card's
     peak for their type);
  4. drives the greedy window slice end to end at the full width of `base`
     (random weights from a seed): 32 seeded 30 s waveforms ->
     log_mel_spectrogram (K4) -> DecodingTask with bench.py's options (bf16,
     int8 KV, W8A8 encoder, 64 forced tokens) through submit/collect for 3
     batches, with the launch counts reset just before and read just after;
     then one batch with kv_quant=False (K2);
  5. checks the card's decode against the plain path on the CPU (fp32) on a
     2-window input forced to the card's tokens;
  6. drives the training slice at the full width of `base`: 32 seeded WAVs
     of 2-10 s with seeded transcripts, MultiTaskTrainer in bf16 at batch
     16, 4 train steps (K4, K3 with lse + K6, K7 with lse + K8 in every
     step, counted per step), `evaluate` on 16 clips (K3 and K7 without
     lse) and `save_checkpoint`;
  7. checks one train step on the card (bf16) against the same step on the
     CPU (fp32, plain path): loss and every parameter group's gradient;
  8. holds each training kernel against its plain version as phase 3 does,
     at the shapes phase 6 gave it (the token buckets of its batches) and
     a few more.
It prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import wave

ROOT = os.path.dirname(os.path.abspath(__file__))
BASE_OPTIONS = dict(
    language="en", without_timestamps=True, sample_len=64, suppress_tokens="-1,50257",
    fp16=True, kv_quant=True, int8_encoder=True,
)  # bench.py:88-99 on the chip
N_WINDOWS = 32
N_BATCHES = 3
MODEL = "base"
DEVICE = "cuda"
TRAIN_BATCH = 16
TRAIN_STEPS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}  # dense, H100 SXM at 700 W


def bound(flops: float, n_bytes: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_OPS_PER_S[kind], n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timed_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings."""
    import torch

    for _ in range(warmup):
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


def attn_bound(macs: float, n_bytes: float, mults: int = 4):
    """Attention in bf16: `mults` FLOPs per (query, key, channel) triple
    (4 forward: QK^T and PV; 10 backward: S, dP, dV, dQ, dK)."""
    return bound(mults * macs, n_bytes, "bf16")


def heads(x, n_head: int, n_keys=None):
    """(B, T, D) -> (B, H, T, 64) view for the library call, keys sliced to
    the valid length."""
    if n_keys is not None:
        x = x[:, :n_keys]
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def make_recorder(card: str, rows: list):
    """record(name, case, source, replaces, got, want, tol, run_kernel,
    run_plain, bound=(ms, by), library=None, main=True): check and time one
    kernel. `got`/`want`/`tol` may be lists (one per output); a `tol` is
    one number or a tensor of per-output bounds on |kernel - plain|."""
    import torch

    def record(name, case, source, replaces, got, want, tol, run_kernel, run_plain, *, bound, library=None,
               main=True):
        torch.cuda.synchronize()
        gots, wants, tols = (x if isinstance(x, list) else [x] for x in (got, want, tol))
        err, worst, ref, finite = 0.0, 0.0, 0.0, True
        for g, w, t in zip(gots, wants, tols):
            diff = (g.float() - w.float()).abs()
            err = max(err, diff.max().item())
            worst = max(worst, (diff / t).max().item())  # <= 1 passes
            ref = max(ref, w.float().abs().max().item())
            finite = finite and bool(torch.isfinite(g.float()).all())
        tol_s = "; ".join(f"{t:.3e}" if isinstance(t, float) else
                          f"per output, {t.min().item():.3e}..{t.max().item():.3e}" for t in tols)
        ms, plain_ms = timed_ms(run_kernel), timed_ms(run_plain)
        library_ms = timed_ms(library) if library is not None else None
        bound_ms, bound_by = bound
        ok = worst <= 1.0 and finite
        lib_s = f"{library_ms:.4f} ms" if library_ms is not None else "none"
        print(f"[kernel] {name} {case}: max_abs_err={err:.3e} (tol {tol_s}; max|ref| {ref:.3e}), "
              f"worst err/tol {worst:.3f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib_s}, "
              f"bound {bound_ms:.4f} ms ({bound_by}) [{card}] {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {case}: max_abs_err {err}, worst err/tol {worst} (tol {tol_s})")
        rows.append(dict(name=name, case=case, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, err_over_tol=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=library_ms, main=main))

    return record


def check_train_kernels(card: str, train_buckets, val_buckets):
    """Phase 8, training kernels, each against its plain version: K3 with
    lse and K6 at the encoder's shape and at the cross-attention's shape of
    every token bucket phase 6 ran (train and evaluate), K7 (with and without
    lse) and K8 at the decoder's causal shape of those buckets; besides,
    cross tq 64 and 448, causal T 64 and 448, and a causal q_offset case.
    In the `kernels` line, one row per kernel and a shape the slice ran: the
    encoder's for K3 with lse and K6, the first train step's bucket for K7
    with lse and K8, the first eval batch's for K7 without lse."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []
    record = make_recorder(card, rows)
    src, b = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", TRAIN_BATCH

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def rel_tol(x):
        """bf16 rounding at other places (p, dS, the outputs): 2^-6 of the largest output."""
        return 2.0**-6 * x.float().abs().max().item()

    buckets = sorted(set(train_buckets) | set(val_buckets))
    main_t, main_v = train_buckets[0], val_buckets[0]

    # K3 with lse and K6: encoder (16, 1536, 512) keys valid to 1500; cross
    # (16, bucket | 64 | 448, 512) against (16, 1500, 512). Buckets below 64
    # leave the one q tile ragged.
    cross = [(f"cross ({b}, {t}, 512) x ({b}, 1500, 512)" + (", token bucket" if t in buckets else ""), t, 1500,
              None, False) for t in sorted(set(buckets) | {64, 448})]
    for case, tq, tk, kv_len, main in [("encoder (16, 1536, 512), kv_valid_len 1500", 1536, 1536, 1500, True)] + cross:
        q, k, v, g = rnd(b, tq, 512), rnd(b, tk, 512), rnd(b, tk, 512), rnd(b, tq, 512)
        n_keys = kv_len or tk
        kw = dict(n_head=8, kv_valid_len=kv_len, scale=0.125)
        out, lse = FA.flash_attention_h2(q, k, v, return_lse=True, **kw)
        pout, plse = FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
        io = (2 * q.numel() + 2 * b * n_keys * 512) * 2
        qh = heads(q, 8).detach().requires_grad_(True)
        kh, vh = (heads(x, 8, n_keys).detach().requires_grad_(True) for x in (k, v))
        record("flash_attention_h2_lse", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:552",
               [out, lse], [pout, plse], [rel_tol(pout), 1e-4],
               lambda: FA.flash_attention_h2(q, k, v, return_lse=True, **kw),
               lambda: FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw),
               bound=attn_bound(b * tq * n_keys * 512, io + lse.numel() * 4),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=main)
        delta = FA.h2_delta(g, pout, 8)
        got = list(FA.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw))
        want = list(FA.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)
        gh = heads(g, 8)
        record("flash_attention_h2_bwd", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:651,691",
               got, want, [rel_tol(w) for w in want],
               lambda: FA.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw),
               lambda: FA.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw),
               bound=attn_bound(b * tq * n_keys * 512, 2 * io + 2 * lse.numel() * 4, mults=10),
               library=lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True), main=main)
        if tq in val_buckets:  # evaluate's cross-attention: K3 without lse
            record("flash_attention_h2", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:514",
                   FA.flash_attention_h2(q, k, v, **kw), pout, rel_tol(pout),
                   lambda: FA.flash_attention_h2(q, k, v, **kw), lambda: FA.flash_attention_h2_plain(q, k, v, **kw),
                   bound=attn_bound(b * tq * n_keys * 512, io),
                   library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=False)
        del q, k, v, g, out, lse, pout, plse, delta, got, want, lib_out, qh, kh, vh

    # K7 and K8: decoder self-attention, BH = 16 x 8 heads, causal
    causal = [(f"causal (128, {t}, 64)" + (", token bucket" if t in buckets else ""), t, 0)
              for t in sorted(set(buckets) | {64, 448})]
    for case, tq, q_offset in causal + [("causal (128, 48, 64) x 96 keys, q_offset 48", 48, 48)]:
        tk = tq + q_offset
        q, k, v, g = rnd(128, tq, 64), rnd(128, tk, 64), rnd(128, tk, 64), rnd(128, tq, 64)
        kw = dict(causal=True, q_offset=q_offset, scale=0.125)
        train_main = not q_offset and tq == main_t
        pairs = sum(min(tk, q_offset + i + 1) for i in range(tq))  # (query, key) pairs the mask keeps
        io = (2 * q.numel() + 2 * k.numel()) * 2
        if q_offset:
            qpos = q_offset + torch.arange(tq, device=dev)
            mask = torch.arange(tk, device=dev)[None, :] <= qpos[:, None]
            lib = dict(attn_mask=mask)
        else:
            lib = dict(is_causal=True)
        ql, kl, vl = (x.detach().requires_grad_(True) for x in (q, k, v))
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        record("flash_attention_lse", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
               [out, lse], [pout, plse], [rel_tol(pout), 1e-4],
               lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
               lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
               bound=attn_bound(128 * pairs * 64, io + lse.numel() * 4),
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, **lib), main=train_main)
        record("flash_attention", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
               FA.flash_attention(q, k, v, **kw), pout, rel_tol(pout),
               lambda: FA.flash_attention(q, k, v, **kw), lambda: FA.flash_attention_plain(q, k, v, **kw),
               bound=attn_bound(128 * pairs * 64, io),
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, **lib),
               main=not q_offset and tq == main_v)
        got = list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
        want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, **lib)
        record("flash_attention_bwd", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030",
               got, want, [rel_tol(w) for w in want],
               lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
               lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
               bound=attn_bound(128 * pairs * 64, 2 * io + 2 * lse.numel() * 4, mults=10),
               library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g, retain_graph=True), main=train_main)
    return rows


def check_kernels(card: str):
    """Phase 3: every kernel against its plain version at base shapes."""
    import torch

    from asr_ttl_mtl_tpu_torch.audio import N_SAMPLES, N_FFT
    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA
    from asr_ttl_mtl_tpu_torch.ops import mel as M
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    rows = []
    record = make_recorder(card, rows)

    # K4: 32 clips of 30 s, fp32. Compared after the max-8 clamp and (x+4)/4,
    # as the encoder sees it: fp32 sums of 400 products in another order move
    # log10 of a bin by ~1e-6 except near the clamp floor.
    wave = torch.randn((N_WINDOWS, N_SAMPLES), generator=gen, device=dev) * 0.1
    padded = torch.nn.functional.pad(wave[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0].contiguous()

    def finish(x):
        return (torch.maximum(x, x.amax(dim=(-2, -1), keepdim=True) - 8.0) + 4.0) / 4.0

    # bound: the DFT products (cos and sin, 400 x 201 per frame) and the mel
    # projection (201 x 80) in fp32; bytes: the padded audio in, the mels out
    n_fr = N_WINDOWS * 3000
    record("log_mel", "B=32 x 480000 f32 -> (32, 80, 3000)", "asr_ttl_mtl_tpu_torch/csrc/mel.cu",
           "asr_ttl_mtl_tpu/ops/pallas_mel.py:44",
           finish(M.log_mel(padded, 3000, 80)), finish(M.log_mel_plain(padded, 3000, 80)), 1e-4,
           lambda: M.log_mel(padded, 3000, 80), lambda: M.log_mel_plain(padded, 3000, 80),
           bound=bound(n_fr * (400 * 201 * 2 * 2 + 201 * 80 * 2), padded.numel() * 4 + n_fr * 80 * 4, "fp32"))

    # K3: encoder self-attention, bf16. p and the output round to bf16 (2^-8
    # relative); the kernel rounds p against a running max, the plain
    # version against the row max: allow 2^-6 of the largest output.
    q, k, v = (torch.randn((N_WINDOWS, 1536, 512), generator=gen, device=dev).bfloat16() for _ in range(3))
    kw = dict(n_head=8, kv_valid_len=1500, scale=0.125)
    want = FA.flash_attention_h2_plain(q, k, v, **kw)
    qh, kh, vh = (heads(x, 8, 1500 if x is not q else None) for x in (q, k, v))
    record("flash_attention_h2", "q,k,v (32, 1536, 512) bf16, kv_valid_len 1500",
           "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", "asr_ttl_mtl_tpu/ops/flash_attention.py:514",
           FA.flash_attention_h2(q, k, v, **kw), want, 2.0**-6 * want.float().abs().max().item(),
           lambda: FA.flash_attention_h2(q, k, v, **kw), lambda: FA.flash_attention_h2_plain(q, k, v, **kw),
           bound=attn_bound(N_WINDOWS * 1536 * 1500 * 512, (2 * q.numel() + 2 * 32 * 1500 * 512) * 2),
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125))
    del q, k, v, want, qh, kh, vh

    # decode caches at base: cross (6, 32, 1500 | 1536, 512), self (6, 32, 128, 512)
    qd = torch.randn((N_WINDOWS, 1, 512), generator=gen, device=dev).bfloat16()
    cross_k = torch.randn((6, N_WINDOWS, 1500, 512), generator=gen, device=dev).bfloat16()
    cross_v = torch.randn((6, N_WINDOWS, 1500, 512), generator=gen, device=dev).bfloat16()
    self_k = torch.randn((6, N_WINDOWS, 128, 512), generator=gen, device=dev).bfloat16()
    self_v = torch.randn((6, N_WINDOWS, 128, 512), generator=gen, device=dev).bfloat16()
    scale = 64**-0.5

    # K2, bf16: both sides round p / l to bf16 and sum in fp32; the output
    # rounds to bf16. Allow 2 bf16 ulps of the largest output.
    for case, ck, cv, valid, main in (
        ("cross (6,32,1500,512) bf16", cross_k, cross_v, None, True),
        ("self (6,32,128,512) bf16, valid_upto 70", self_k, self_v, 70, False),
    ):
        kw = dict(scale=scale, valid_upto=valid)
        want = DA.decode_attention_plain(qd, ck, cv, 5, 8, **kw)
        got = DA.decode_attention(qd, ck, cv, 5, 8, **kw)
        n_keys = ck.shape[2] if valid is None else valid + 1
        qh = heads(qd, 8)
        kh, vh = heads(ck[5], 8, n_keys), heads(cv[5], 8, n_keys)
        record("decode_attention", case, "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu",
               "asr_ttl_mtl_tpu/ops/decode_attention.py:39", got, want,
               2.0**-7 * want.float().abs().max().item(),
               lambda: DA.decode_attention(qd, ck, cv, 5, 8, **kw),
               lambda: DA.decode_attention_plain(qd, ck, cv, 5, 8, **kw),
               bound=attn_bound(N_WINDOWS * n_keys * 512, 2 * N_WINDOWS * n_keys * 512 * 2),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=main)
    # K2, fp32 (the fp16=False path): only summation order differs
    qf = qd.float()
    ckf, cvf = self_k.float(), self_v.float()
    qh, kh, vh = heads(qf, 8), heads(ckf[5], 8, 71), heads(cvf[5], 8, 71)
    record("decode_attention", "self (6,32,128,512) f32, valid_upto 70",
           "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu", "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
           DA.decode_attention(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70),
           DA.decode_attention_plain(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70), 1e-5,
           lambda: DA.decode_attention(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70),
           lambda: DA.decode_attention_plain(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70),
           bound=bound(4 * N_WINDOWS * 71 * 512, 2 * N_WINDOWS * 71 * 512 * 4, "fp32"),
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=False)

    # K1, int8: exp and the fp32 sums differ in their last bits, which can
    # round a p*v_scale that lies at a rounding midpoint to the other int8
    # neighbour. The plain version bounds, per output, what such flips can
    # move (`return_flip_bound`); beyond that, allow one bf16 rounding
    # (2^-7 |ref|) and fp32 noise (1e-5 of the largest output). A wrong
    # tk_blk, p quantized once instead of per block, or a dropped 1500..1535
    # tail mask each exceed that bound 3-1100x (emulated with the plain
    # version on the CPU at these shapes). The order of the blocks cannot
    # show: the running max cancels in p*v_scale / sp.
    ck8, cks = DA.quantize_kv_rows(cross_k)
    cv8, cvs = DA.quantize_kv_rows(cross_v)
    sk8, sks = DA.quantize_kv_rows(self_k)
    sv8, svs = DA.quantize_kv_rows(self_v)
    for case, args, valid, main in (
        ("cross (6,32,1536,512) int8, valid_upto 1499, tk_blk 256", (ck8, cks, cv8, cvs), 1499, True),
        ("self (6,32,128,512) int8, valid_upto 70, tk_blk 128", (sk8, sks, sv8, svs), 70, False),
    ):
        # bound: one layer's int8 K and V rows up to valid_upto and their fp32
        # row scales; the int8 products are negligible beside the bytes
        n_keys = valid + 1
        i8_bound = bound(4 * N_WINDOWS * n_keys * 512, 2 * N_WINDOWS * n_keys * (512 + 4), "int8")
        kw = dict(scale=scale, valid_upto=valid)
        want, flip = DA.decode_attention_i8_plain(qd, *args, 5, 8, return_flip_bound=True, **kw)
        got = DA.decode_attention_i8(qd, *args, 5, 8, **kw)
        ref = want.float().abs()
        tol = (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        record("decode_attention_i8", case, "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu",
               "asr_ttl_mtl_tpu/ops/decode_attention.py:186", got, want, tol,
               lambda: DA.decode_attention_i8(qd, *args, 5, 8, **kw),
               lambda: DA.decode_attention_i8_plain(qd, *args, 5, 8, **kw), bound=i8_bound, main=main)
    return rows


def make_waves(n: int, seed: int):
    """Seeded 30 s waveforms: two tones with a slow envelope, plus noise."""
    import numpy as np

    from asr_ttl_mtl_tpu_torch.audio import N_SAMPLES, SAMPLE_RATE

    rng = np.random.RandomState(seed)
    t = np.arange(N_SAMPLES, dtype=np.float32) / SAMPLE_RATE
    f = rng.uniform(100.0, 3000.0, size=(n, 2, 1)).astype(np.float32)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.1, 1.0, size=(n, 1)).astype(np.float32) * t)
    tones = (np.sin(2 * np.pi * f[:, 0] * t) + 0.5 * np.sin(2 * np.pi * f[:, 1] * t)) * env
    return (0.1 * tones + 0.01 * rng.randn(n, N_SAMPLES)).astype(np.float32)


def run_slice(card: str):
    """Phase 4: the base slice end to end through the user entry points."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, from_random, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    waves = make_waves(N_WINDOWS, seed=0)
    task = DecodingTask(model, DecodingOptions(**BASE_OPTIONS))

    # warm-up (cuBLAS handles, allocator), not counted
    task.run(log_mel_spectrogram(waves, device=DEVICE))
    sync()

    reset_launch_counts()
    t0 = time.perf_counter()
    mel = log_mel_spectrogram(waves, device=DEVICE)
    sync()
    t_mel = time.perf_counter() - t0
    def pipeline(task):
        """N_BATCHES batches through a depth-2 submit/collect pipeline:
        (results, wall s, s the host spent in collect waiting for the card)."""
        t = time.perf_counter()
        pending = task.submit(mel, rng_seed=0)
        out, wait = [], 0.0
        for i in range(1, N_BATCHES + 1):
            nxt = task.submit(mel, rng_seed=i) if i < N_BATCHES else None
            t_c = time.perf_counter()
            out += task.collect(pending)
            wait += time.perf_counter() - t_c
            pending = nxt
        return out, time.perf_counter() - t, wait

    results, t_dec, t_wait = pipeline(task)
    main_counts = dict(LAUNCHES)

    assert tuple(mel.shape) == (N_WINDOWS, 80, 3000) and bool(torch.isfinite(mel).all())
    assert len(results) == N_WINDOWS * N_BATCHES
    for r in results:
        assert len(r.tokens) == 64, len(r.tokens)
        assert np.isfinite(r.avg_logprob) and np.isfinite(r.no_speech_prob)
    assert main_counts["log_mel"] >= 1, main_counts
    assert main_counts["flash_attention_h2"] == model.dims.n_audio_layer * N_BATCHES, main_counts
    assert main_counts["decode_attention_i8"] > 0, main_counts
    audio_s = N_WINDOWS * N_BATCHES * 30.0
    print(f"[slice] base, {N_BATCHES} batches x {N_WINDOWS} windows, kv_quant + int8_encoder, 64 tokens: "
          f"decode {t_dec:.3f} s = {audio_s / t_dec:.1f} audio-s/s, of which {t_wait * 1e3:.1f} ms in "
          f"collect; log-mel of {N_WINDOWS} clips "
          f"{t_mel * 1e3:.2f} ms [{card}]", flush=True)
    print(f"[slice] launches {json.dumps(main_counts)}; text[0]={results[0].text[:60]!r} "
          f"avg_logprob[0]={results[0].avg_logprob:.4f}", flush=True)
    # the loop is host-bound and the host's cores are shared: repeat to show the spread
    rates = sorted(audio_s / pipeline(task)[1] for _ in range(4))
    print(f"[slice] 4 more runs: {', '.join(f'{r:.1f}' for r in rates)} audio-s/s "
          f"(median {statistics.median(rates):.1f}) [{card}]", flush=True)

    reset_launch_counts()
    plain_task = DecodingTask(model, DecodingOptions(**{**BASE_OPTIONS, "kv_quant": False}))
    t2 = time.perf_counter()
    bf16_results = plain_task.run(mel)
    t_bf16 = time.perf_counter() - t2
    k2_counts = dict(LAUNCHES)
    for r in bf16_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob)
    assert k2_counts["decode_attention"] > 0 and k2_counts["flash_attention_h2"] == model.dims.n_audio_layer, k2_counts
    print(f"[slice] kv_quant=False, 1 batch: {t_bf16:.3f} s = {N_WINDOWS * 30.0 / t_bf16:.1f} audio-s/s "
          f"[{card}]; launches {json.dumps(k2_counts)}", flush=True)
    return model, main_counts, k2_counts


def check_against_cpu(model, waves_seed: int = 1):
    """Phase 5: the card's decode of 2 windows against the plain path on the
    CPU in fp32, forced to the card's tokens (same weights, same options)."""
    import copy

    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.decoding import _apply_filters
    from asr_ttl_mtl_tpu_torch.models import whisper as W

    waves = make_waves(2, seed=waves_seed)
    mel = log_mel_spectrogram(waves, device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**BASE_OPTIONS))
    card = task.run(mel)

    cpu = copy.deepcopy(model).to("cpu")
    cpu.compute_dtype = torch.float32
    mel_cpu = log_mel_spectrogram(waves, device="cpu")
    mel_err = (mel.cpu() - mel_cpu).abs().max().item()
    with torch.no_grad():
        feats = W.encoder_apply(cpu.encoder, mel_cpu, torch.float32, int8_linears=True)
        cross_f = W.precompute_cross_kv(cpu.decoder, feats, stack=False)
        cross = W.quantize_cross_kv(cross_f)
        ref_task = DecodingTask(cpu, DecodingOptions(**{**BASE_OPTIONS, "fp16": False}))
        init = list(ref_task.initial_tokens)
        toks = torch.tensor([r.tokens for r in card])  # (2, 64)
        seq = torch.tensor([init + [ref_task.tokenizer.eot] * (8 - len(init))] * 2)
        cache = W.init_kv_cache_i8(cpu.dims, 2, ctx=128)
        logits, cache = W.decoder_apply(cpu.decoder, seq, cross_kv=cross_f, kv_cache=cache)
        step_logits = logits[:, len(init) - 1]
        prev = penult = last_ts = torch.full((2,), -1)
        sum_lp = torch.zeros(2)
        worst_gap = 0.0
        for i in range(toks.shape[1]):
            lg = _apply_filters(ref_task.filter_cfg, step_logits, i, prev, penult, last_ts)
            tok = toks[:, i]
            chosen = lg.gather(1, tok[:, None])[:, 0]
            worst_gap = max(worst_gap, (lg.amax(-1) - chosen).max().item())
            sum_lp += chosen - torch.logsumexp(lg, -1)
            prev, penult = tok, prev
            if i + 1 < toks.shape[1]:
                step_logits = W.decoder_apply(
                    cpu.decoder, tok[:, None], cross_kv=cross, kv_cache=cache, pos_offset=len(init) + i
                )[0][:, 0]
        avg = sum_lp / (toks.shape[1] + 1)
        lp_err = max(abs(avg[r].item() - card[r].avg_logprob) for r in range(2))
    # bf16 on the card against fp32 here: logits move by ~1e-2, so a chosen
    # token may trail the fp32 argmax by that much, never by 0.5
    ok = mel_err < 1e-3 and worst_gap < 0.5 and lp_err < 0.1
    print(f"[check] card vs CPU fp32 plain path, 2 windows: log-mel max err {mel_err:.2e} (tol 1e-3); "
          f"card tokens trail the fp32 argmax by at most {worst_gap:.3f} (tol 0.5); "
          f"|avg_logprob diff| {lp_err:.4f} (tol 0.1) {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("card decode disagrees with the CPU reference")


TRAIN_WORDS = ("the patient said hello there how are you fine thanks speech voice test one two three "
               "morning evening water bread house garden slowly quickly today tomorrow").split()


def write_clips(directory: str, n: int, seed: int) -> str:
    """n seeded 16 kHz WAVs of 2-10 s (tones plus noise) with seeded
    transcripts of 5-30 words and classes 0-2, and a CSV naming them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    rows = ["file,text,class"]
    for i in range(n):
        path = os.path.join(directory, f"clip{seed}_{i}.wav")
        t = np.arange(int(16000 * rng.uniform(2.0, 10.0)), dtype=np.float32) / 16000
        tone = np.sin(2 * np.pi * rng.uniform(100, 3000) * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
        pcm = (6000 * tone + 600 * rng.randn(t.size)).astype(np.int16)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.tobytes())
        rows.append(f"{path},{' '.join(rng.choice(TRAIN_WORDS, size=rng.randint(5, 31)))},{i % 3}")
    csv_path = os.path.join(directory, f"clips{seed}.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path


def run_training(card: str, workdir: str):
    """Phase 6: the training slice at the full width of base, bf16."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    cfg = TrainingConfig(model_size=MODEL, pretrained="random", batch_size=TRAIN_BATCH, val_batch_size=TRAIN_BATCH,
                         compute_dtype="bfloat16", learning_rate=1e-5, seed=0, num_workers=4, epochs=1,
                         save_dir=os.path.join(workdir, "out"))
    train_ds = MultiTaskSpeechDataset(write_clips(workdir, 32, seed=0), cfg)
    val_ds = MultiTaskSpeechDataset(write_clips(workdir, 16, seed=1), cfg)
    loader = DataLoader(train_ds, TRAIN_BATCH, shuffle=True, num_workers=4, drop_last=True, seed=0,
                        buckets=cfg.token_buckets)
    batches = []  # on the host before the timed steps; each pass over the loader is an epoch
    while len(batches) < TRAIN_STEPS:
        batches.extend(list(loader)[: TRAIN_STEPS - len(batches)])
    val_batches = list(DataLoader(val_ds, TRAIN_BATCH, num_workers=4, buckets=cfg.token_buckets))
    trainer = MultiTaskTrainer(cfg, verbose=False)
    n_params = sum(p.numel() for _, p in trainer.named_trainable())
    print(f"[train] base: {n_params} parameters (vocab {trainer.model.dims.n_vocab}), batch {TRAIN_BATCH}, "
          f"token buckets {[b['input_tokens'].shape[1] for b in batches]}", flush=True)

    per_step = {"log_mel": 1, "flash_attention_h2_lse": 12, "flash_attention_h2_bwd": 12,
                "flash_attention_lse": 6, "flash_attention_bwd": 6}
    torch.cuda.reset_peak_memory_stats()
    step_s, losses, train_counts = [], [], {}
    for i, batch in enumerate(batches):
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, aux = trainer.train_step(batch)
        sync()
        step_s.append(time.perf_counter() - t0)
        counts = dict(LAUNCHES)
        losses.append(float(loss))
        launched = {k: v for k, v in counts.items() if v}
        if launched != per_step:
            raise AssertionError(f"train step {i + 1} launched {launched}, expected {per_step}")
        for k, v in counts.items():
            train_counts[k] = train_counts.get(k, 0) + v
        if i == 0 and not (0.0 < trainer.alpha < 1.0 and abs(trainer.alpha + trainer.beta - 1.0) < 1e-5):
            raise AssertionError(f"alpha/beta not frozen after the first batch: {trainer.alpha}, {trainer.beta}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    steady = statistics.median(step_s[1:])
    print(f"[train] {TRAIN_STEPS} steps: losses {', '.join(f'{x:.4f}' for x in losses)}; alpha {trainer.alpha:.4f} "
          f"beta {trainer.beta:.4f}; step s {', '.join(f'{x:.4f}' for x in step_s)} (first has the set-up); "
          f"steady {steady * 1e3:.1f} ms = {TRAIN_BATCH / steady:.1f} samples/s; peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated) [{card}]", flush=True)
    print(f"[train] launches per step {json.dumps(per_step)}", flush=True)

    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = trainer.evaluate(val_batches)
    sync()
    t_eval = time.perf_counter() - t0
    eval_counts = dict(LAUNCHES)
    n_val = len(val_batches)
    expect = {"log_mel": n_val, "flash_attention_h2": 12 * n_val, "flash_attention": 6 * n_val}
    if {k: v for k, v in eval_counts.items() if v} != expect:
        raise AssertionError(f"evaluate launched {eval_counts}, expected {expect}")
    for key in ("loss", "cls_loss", "trans_loss", "wer", "cer", "disease_acc"):
        if not np.isfinite(metrics[key]):
            raise AssertionError(f"evaluate: {key} = {metrics[key]}")
    print(f"[train] evaluate on {len(val_ds)} clips: {t_eval:.3f} s; loss {metrics['loss']:.4f} "
          f"wer {metrics['wer']:.4f} cer {metrics['cer']:.4f} acc {metrics['disease_acc']:.4f}; "
          f"launches {json.dumps(expect)} [{card}]", flush=True)

    t0 = time.perf_counter()
    trainer.save_checkpoint(epoch=0, best_loss=metrics["loss"], val_metrics=metrics)
    path = trainer.checkpoint_path()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if ckpt["model_state_dict"]["decoder.token_embedding.weight"].shape != (51869, 512):
        raise AssertionError("checkpoint: unexpected embedding shape")
    print(f"[train] save_checkpoint {path}: {os.path.getsize(path) / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    buckets = ([b["input_tokens"].shape[1] for b in batches], [b["input_tokens"].shape[1] for b in val_batches])
    return trainer, batches[0], train_counts, eval_counts, buckets


def check_train_step_against_cpu(card: str, trainer, batch):
    """Phase 7: the same weights, 2-clip batch and dropout mask through one
    bf16 step on the card and one fp32 step on the CPU (plain path): the
    losses within 2% and each group's gradient at cosine >= 0.99."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of

    small = {k: (v[:2] if k in ("audio", "input_tokens", "target_tokens", "classes", "texts", "paths") else v)
             for k, v in batch.items()}
    keep = torch.from_numpy(np.random.RandomState(3).rand(2, trainer.model.dims.n_audio_state // 2) < 0.9)
    model_sd = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    head_sd = {k: v.detach().cpu() for k, v in trainer.classifier.state_dict().items()}
    cpu = MultiTaskTrainer(TrainingConfig(model_size=MODEL, pretrained="random", compute_dtype="float32",
                                          device="cpu", seed=0), verbose=False)
    cpu.load_state(model_sd, head_sd)
    cpu.alpha, cpu.beta = trainer.alpha, trainer.beta

    def grads_by_group(tr):
        out = {}
        for name, p in tr.named_trainable():
            out.setdefault(group_of(name), []).append(p.grad.detach().float().cpu().flatten())
        return {g: torch.cat(v) for g, v in out.items()}

    card_loss, _ = trainer.train_step(small, keep=keep)
    card_g = grads_by_group(trainer)
    t0 = time.perf_counter()
    cpu_loss, _ = cpu.train_step(small, keep=keep)
    t_cpu = time.perf_counter() - t0
    cpu_g = grads_by_group(cpu)
    rel = abs(float(card_loss) - float(cpu_loss)) / abs(float(cpu_loss))
    cos = {g: float(torch.nn.functional.cosine_similarity(card_g[g].double(), cpu_g[g].double(), dim=0))
           for g in cpu_g}
    worst = min(cos, key=cos.get)
    ok = rel <= 0.02 and cos[worst] >= 0.99
    print(f"[check] train step, card bf16 vs CPU fp32 plain path (2 clips, same weights and dropout): loss "
          f"{float(card_loss):.5f} vs {float(cpu_loss):.5f}, rel diff {rel:.2e} (tol 2e-2); gradient cosine "
          f"{', '.join(f'{g} {c:.5f}' for g, c in cos.items())}, worst {worst} {cos[worst]:.5f} (tol 0.99); "
          f"CPU step {t_cpu:.1f} s {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card's train step disagrees with the CPU reference")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "asr_ttl_mtl_tpu_torch", "csrc")):
        raise SystemExit("chip_smoke.py runs from a checkout of the repository (asr_ttl_mtl_tpu_torch/ missing)")
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; torch.cuda.is_available() is False")
    # fp32 comparisons run in true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} devices {torch.cuda.device_count()}",
          flush=True)

    from asr_ttl_mtl_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"[build] {len(_cuda.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _cuda.SOURCES:
        for line in _cuda.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}] {line.strip()}", flush=True)

    rows = check_kernels(card)
    model, main_counts, k2_counts = run_slice(card)
    check_against_cpu(model)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        trainer, batch, train_counts, eval_counts, buckets = run_training(card, workdir)
        check_train_step_against_cpu(card, trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    rows += check_train_kernels(card, *buckets)

    # launches: the sum over the main paths (decode slice, kv_quant=False
    # batch, train steps, evaluate), each counted from 0 just before it ran
    launches = {name: main_counts[name] + k2_counts[name] + train_counts[name] + eval_counts[name]
                for name in main_counts}
    kernels = []
    for r in rows:
        if r.pop("main"):
            kernels.append({**r, "launches": launches[r["name"]]})
    names = [k["name"] for k in kernels]
    if len(set(names)) != len(names) or set(names) != set(launches):
        raise AssertionError(f"the kernels line needs one row per kernel: {names} against {sorted(launches)}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {missing}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
