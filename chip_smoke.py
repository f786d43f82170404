#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`asr_ttl_mtl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: requires CUDA, prints `nvidia-smi` name and power limit;
  2. builds the four kernels from `asr_ttl_mtl_tpu_torch/csrc/` (nvcc, sm_90a);
  3. holds each kernel against its plain PyTorch version on the card at the
     shapes of the `base` slice, with the tolerance stated per kernel, and
     times both (median of CUDA-event timings);
  4. drives the slice end to end at the full width of `base` (random weights
     from a seed): 32 seeded 30 s waveforms -> log_mel_spectrogram (K4) ->
     DecodingTask with bench.py's options (bf16, int8 KV, W8A8 encoder,
     64 forced tokens) through submit/collect for 3 batches, with the launch
     counts reset just before and read just after; then one batch with
     kv_quant=False (K2);
  5. checks the card's decode against the plain path on the CPU (fp32) on a
     2-window input forced to the card's tokens.
It prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BASE_OPTIONS = dict(
    language="en", without_timestamps=True, sample_len=64, suppress_tokens="-1,50257",
    fp16=True, kv_quant=True, int8_encoder=True,
)  # bench.py:88-99 on the chip
N_WINDOWS = 32
N_BATCHES = 3
MODEL = "base"
DEVICE = "cuda"


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


def check_kernels(card: str):
    """Phase 3: every kernel against its plain version at base shapes."""
    import torch

    from asr_ttl_mtl_tpu_torch.audio import N_SAMPLES, N_FFT
    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA
    from asr_ttl_mtl_tpu_torch.ops import mel as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def record(name, case, source, replaces, got, want, tol, run_kernel, run_plain):
        """`tol` bounds |kernel - plain| at every output: one number, or a
        tensor of per-output bounds."""
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        worst = (diff / tol).max().item()  # <= 1 passes
        ref = want.float().abs().max().item()
        tol_s = f"{tol:.3e}" if isinstance(tol, float) else f"per output, {tol.min().item():.3e}..{tol.max().item():.3e}"
        ms, plain_ms = timed_ms(run_kernel), timed_ms(run_plain)
        ok = worst <= 1.0 and bool(torch.isfinite(got.float()).all())
        print(f"[kernel] {name} {case}: max_abs_err={err:.3e} (tol {tol_s}; max|ref| {ref:.3e}), "
              f"worst err/tol {worst:.3f}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"[{card}] {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {case}: max_abs_err {err}, worst err/tol {worst} (tol {tol_s})")
        rows.append(dict(name=name, case=case, route="cuda", source=source, replaces=replaces,
                         max_abs_err=err, err_over_tol=worst, ms=ms, plain_ms=plain_ms))

    # K4: 32 clips of 30 s, fp32. Compared after the max-8 clamp and (x+4)/4,
    # as the encoder sees it: fp32 sums of 400 products in another order move
    # log10 of a bin by ~1e-6 except near the clamp floor.
    wave = torch.randn((N_WINDOWS, N_SAMPLES), generator=gen, device=dev) * 0.1
    padded = torch.nn.functional.pad(wave[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0].contiguous()

    def finish(x):
        return (torch.maximum(x, x.amax(dim=(-2, -1), keepdim=True) - 8.0) + 4.0) / 4.0

    record("log_mel", "B=32 x 480000 f32 -> (32, 80, 3000)", "asr_ttl_mtl_tpu_torch/csrc/mel.cu",
           "asr_ttl_mtl_tpu/ops/pallas_mel.py:44",
           finish(M.log_mel(padded, 3000, 80)), finish(M.log_mel_plain(padded, 3000, 80)), 1e-4,
           lambda: M.log_mel(padded, 3000, 80), lambda: M.log_mel_plain(padded, 3000, 80))

    # K3: encoder self-attention, bf16. p and the output round to bf16 (2^-8
    # relative); the kernel rounds p against a running max, the plain
    # version against the row max: allow 2^-6 of the largest output.
    q, k, v = (torch.randn((N_WINDOWS, 1536, 512), generator=gen, device=dev).bfloat16() for _ in range(3))
    kw = dict(n_head=8, kv_valid_len=1500, scale=0.125)
    want = FA.flash_attention_h2_plain(q, k, v, **kw)
    record("flash_attention_h2", "q,k,v (32, 1536, 512) bf16, kv_valid_len 1500",
           "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", "asr_ttl_mtl_tpu/ops/flash_attention.py:514",
           FA.flash_attention_h2(q, k, v, **kw), want, 2.0**-6 * want.float().abs().max().item(),
           lambda: FA.flash_attention_h2(q, k, v, **kw), lambda: FA.flash_attention_h2_plain(q, k, v, **kw))
    del q, k, v, want

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
        record("decode_attention", case, "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu",
               "asr_ttl_mtl_tpu/ops/decode_attention.py:39", got, want,
               2.0**-7 * want.float().abs().max().item(),
               lambda: DA.decode_attention(qd, ck, cv, 5, 8, **kw),
               lambda: DA.decode_attention_plain(qd, ck, cv, 5, 8, **kw))
        rows[-1]["main"] = main
    # K2, fp32 (the fp16=False path): only summation order differs
    qf = qd.float()
    ckf, cvf = self_k.float(), self_v.float()
    record("decode_attention", "self (6,32,128,512) f32, valid_upto 70",
           "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu", "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
           DA.decode_attention(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70),
           DA.decode_attention_plain(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70), 1e-5,
           lambda: DA.decode_attention(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70),
           lambda: DA.decode_attention_plain(qf, ckf, cvf, 5, 8, scale=scale, valid_upto=70))
    rows[-1]["main"] = False

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
        kw = dict(scale=scale, valid_upto=valid)
        want, flip = DA.decode_attention_i8_plain(qd, *args, 5, 8, return_flip_bound=True, **kw)
        got = DA.decode_attention_i8(qd, *args, 5, 8, **kw)
        ref = want.float().abs()
        tol = (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        record("decode_attention_i8", case, "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu",
               "asr_ttl_mtl_tpu/ops/decode_attention.py:186", got, want, tol,
               lambda: DA.decode_attention_i8(qd, *args, 5, 8, **kw),
               lambda: DA.decode_attention_i8_plain(qd, *args, 5, 8, **kw))
        rows[-1]["main"] = main
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
    mel_cpu = log_mel_spectrogram(waves)
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

    kernels = []
    for r in rows:
        if not r.pop("main", True):
            continue
        counts = k2_counts if r["name"] == "decode_attention" else main_counts
        kernels.append({**r, "launches": counts[r["name"]]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
