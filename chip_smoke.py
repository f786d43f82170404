#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`asr_ttl_mtl_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which raises (exit code != 0) when it fails:
  1. the card: requires CUDA, prints `nvidia-smi` name and power limit;
  2. builds the kernels from `asr_ttl_mtl_tpu_torch/csrc/` (one nvcc per
     source, in parallel, sm_90a) and prints each kernel's registers, shared
     memory and spills from `nvcc -Xptxas -v`;
  3. holds each kernel of the decode slice against its plain PyTorch
     version on the card at the shapes of `base` (K4 at the decode slice's
     32 x 30 s, the CLI's 1 x 9000 frames and a train step's 16 x 30 s,
     with the reference composition torch.stft + |.|^2 + mel matmul + log10
     as its "library" column, bound by its bytes or a real FFT's
     operations, with the operations of its factored DFT and of the direct
     DFT beside it as diagnostics; K1 and K2 also at the
     beam paths' group of 5 query rows per cache row, K2 at groups 9 and 16
     in one launch each, at batch 1, and with `valid_upto` 0 and 37 inside
     the first chunk of a 448-row self cache; K3 also at tq 200 over 150
     valid keys, at tq 32 over 1500 keys and with the logsumexp at the
     encoder shape), with the tolerance
     stated per kernel, and times the kernel, the plain version and one PyTorch
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
     a few more;
  9. holds the top-k kernels K9 (bf16 at 5, 80 and 160 rows: one window's
     5 beams, batch mode's 80, 32 windows x 5 beams; fp32 at 160) and K10
     (fp32, 160 rows) against their plain versions, x 51865, k 6, on seeded
     logits with the real suppress mask at -inf, exact ties, duplicates and
     a row of fewer than k finite values, with a second launch giving the
     same bits, and times each beside the library on the device alone;
 10. drives the beam window path at the full width of `base`: phase 4's
     options plus beam_size=5, 32 windows, 64 forced tokens, submit/collect
     over 3 batches, launch counts reset before and read after;
 11. checks the card's beam against the plain path on the CPU (fp32) on 2
     windows, teacher-forced to the card's best sequences;
 12. writes base's random weights to a `.pt` (and, for this phase's runs,
     base's widths at 2 + 2 layers: CLI_DEPTH) and a seeded 40 s WAV, and
     transcribes it through the CLI in process (`cli.cli`, its defaults:
     beam 5 at t=0, best-of 5 up the fallback ladder), with `--language
     en`, detecting the language, and with a 19-token prompt carried into
     every window (K7 in the prefill); checks the five output files and the
     launch counts, then holds K7 and K3 against their plain versions at
     the prefill shapes those runs gave them;
 13. word timestamps through the CLI on the same 40 s WAV, with `--model
     base --model_dir <tmp>` (the `base.pt` of phase 12, so the preset's 8
     alignment heads are set) and one rung of the ladder: once with
     `--word_timestamps True`, once adding `--hallucination_silence_threshold
     2`, which re-seeks around every segment that looks hallucinated; checks
     the words in the .json, one K11 and one K13 launch per aligned window,
     and K3 and K7 in the alignment forward;
 14. holds K11 (median filter) and K13 (DTW fill) against their plain
     versions, exactly, at the largest and smallest shapes phase 13 gave
     them, K11 also at width 13 and at a seeded (8, 229, 1500), K13 also at
     a seeded (225, 1500), a real window's shape, each on a second launch
     too, with its device time and, beside K13's bound, the
     chain bound: (N+M-1) steps of the dependent step's latency, measured
     here by a one-warp loop; then runs one window's post-forward pipeline
     (standardize, K11, head mean, K13, backtrace) on its captured card
     weights with the kernels and with the plain versions: the paths must
     be identical.
 15. batched transcription at base: nine seeded WAVs of 12-150 s (829 s,
     32 windows) through the CLI with `--batch_mode True` and `--model base
     --model_dir <tmp>`: (a) its defaults, detecting each file's language
     (beam 5 at t=0, best-of 5 up the ladder); (b) `--word_timestamps True
     --language en` at one rung, whose alignment reads the decode's encoder
     features and launches K12 once per alignment chunk; (c)
     `transcribe_batch` over the nine waveforms in one batch of 32 windows,
     greedy at t=0 with phase 4's bf16, kv_quant, int8_encoder and
     without_timestamps; each with wall s, windows, rungs, audio-s/s and
     the launch counts;
 16. holds K12 against its plain version, exactly, at the largest and
     smallest chunks run (b) gave it, at a chunk padded by repeating a row
     and at base's largest chunk (16, 444, 1500), seeded, each on a second
     launch too, times it beside the chain bound of its longest row and
     K13 on that row, and runs one chunk's post-forward step (K12, walk,
     words) with the kernel and with the plain version: the same words.
 17. the K14 window path at base: phase 4's options under
     `set_int8_mlp_kernel("auto")`, 3 batches with the launch counts reset
     before and read after (one K14 per encoder layer and pass), audio-s/s
     with the switch off and on in turns, an encoder pass timed both ways,
     the greedy tokens against the switch-off run; then K14 against its
     plain version at (32 x 1536, 512, 2048), with the share of int8
     intermediates that differ, its device time and the same bits on a
     second launch;
 18. K5 through the CLI and the trainer at a geometry `h2_eligible`
     rejects: random weights at 2 + 2 layers with d 576 and 9 heads (head
     width 64) to a `.pt`, phase 12's 40 s WAV through the CLI with
     `--word_timestamps True` at one rung (K5 in the encoder and the beam
     prefill's cross-attention), and 2 train steps at batch 8 in bf16
     with these dims as `debug_dims` (non-causal K7 with lse and K8 over
     split heads), counts reset and read around each;
 19. K5 against its plain version at (32, 1536, 576), at the CLI's shapes
     and at head widths 8 and 80 (route A: K3's forward at the class over
     head maps) and 768, 136, 256 and 384 (route B: the wide forward in
     slabs of 128 output columns), each row with its `k5_plan`, the route
     B rows bitwise on a second launch, and K7 with lse and K8 at the shapes
     the d=576 train steps gave them (the encoder's (72, 1536, 64) is their
     row of the `kernels` line). Every K7 and K8 row (phases 8, 12, 19)
     gives the same bits on a second launch and prints its device time.
 20. fp32 on the card, with cuDNN's default allow_tf32=True back on (the
     port's conv-stem guard keeps its convolution in fp32): (a) phase 4's
     window path with fp16=False, 3 batches of 32 windows, kv_quant and the
     W8A8 encoder, then the same under `set_int8_mlp_kernel("auto")`, and
     an fp32 model from `load_model(..., compute_dtype=torch.float32)` at
     d 576 (K5), audio-s/s and launch counts, no bf16 flash or K14 launch;
     (b) phase 12's WAV through the CLI with `--fp16 False
     --word_timestamps True` at one rung with the 19-token prompt; (c) 4
     train steps at batch 16 with `compute_dtype="float32"`, then
     `evaluate`; (e) gates: one fp32 step from phase 7's weights, batch and
     dropout mask within 2e-4 of phase 7's CPU loss and gradient norms;
     the conv stem within 1e-5 of float64; the fp32 decode of 2 windows
     against the CPU's fp32 plain path (same tokens, logits within 5e-3);
     (d) each fp32 kernel (K3, K3-lse, K5 at d 576, K6, K7, K7-lse, K8,
     K14) against its plain version at the shapes those runs gave it,
     within 2e-5 of its largest output and bitwise on a second launch,
     timed beside SDPA at fp32 and its fp32 bound.
 21. head widths 128 and 32: base's width, 2 + 2 layers, with 4 heads of
     128 and with 16 heads of 32 (HW_DIMS, random weights from seed 0). At
     each, (a) K3 with and without lse and K6 at the encoder's (8, 1536,
     512) keys valid to 1500, K7, K7-lse and K8 at the train bucket's
     causal (8 x H, 48, dh) and at q_offset 48, K5 on K3's forward, and K2
     and K1 on the 8 windows' cross cache and a 128-row self cache with
     valid_upto 37 at groups 1 and 5, against their plain versions with
     phases 3 and 8's bf16 tolerances, bitwise on a second launch, beside
     their bounds and SDPA; then (b) the greedy window path on 8 windows
     with phase 4's options and one batch with kv_quant=False, (c) beam 5
     on 4 windows, (e) phase 5's check against the CPU on 2 windows, (d) 2
     bf16 train steps at batch 8 and `evaluate` on 8 clips, each path's
     launch counts reset before and read after: K1, K2, K3, K3-lse, K6,
     K7, K7-lse and K8 each launch on them. Then the same in fp32 at the
     same width and depth: (f) the fp32 kernels (K3, K3-lse, K6, K5, K7,
     K7-lse, K8, K2 over fp32 caches, K1 with fp32 queries) at those
     shapes within 2e-5 of their plain versions' largest outputs, bitwise
     on a second launch, beside SDPA at fp32 and their 3xTF32 and FFMA
     bounds; (g) the greedy window path with fp16=False and one batch with
     kv_quant=False, beam 5 with fp16=False, 2 train steps with
     compute_dtype="float32" and `evaluate`, each path's counts reset
     before and read after, no bf16 attention or K14 kernel on any, each
     `_f32` kernel launching; (h) phase 20's gates at this width: the fp32
     decode of 2 windows against the CPU's fp32 plain path (5e-3 logits)
     and one fp32 train step against the CPU's (2e-4).
 22. files in, reports out, at base: (a) phase 6's 32 clips, a 44.1 kHz
     WAV, a 24-bit WAV and a file that ends in `.wav` but is none, in one
     batch through the loader's native route (one `runtime.wav.load_batch`
     call) against the Python route within 2e-6, the broken file a zero
     row and its error line; (b) the same weights and 2 batches at batch
     16 through 2 train steps with int16 waveforms and 2 with `mel_fp16`
     (host fp16 log-mels: phase 6's flash kernels a step and no log_mel),
     the transfer mels within 3e-3 of K4's; (c) that trainer's checkpoint
     through the inference and evaluate twins on phase 6's 16 val clips
     (their files, finite metrics, the same accuracy and corpus WER as
     `evaluate`, K3 and K7 alone launched); (d) one epoch of 2 steps with
     `profile_dir` (the trace file, the step timer's line); (e)
     `resume_dir`: 1 epoch, then a new trainer resumed for a 2nd, against
     one 2-epoch run from the same seed, bit for bit; (f) where ffmpeg is
     on PATH, phase 12's WAV as FLAC through the CLI, the WAV's text; each
     path with the launch counts reset before and read after.
 23. multi-device at base (`asr_ttl_mtl_tpu_torch/parallel/`): (a) phase
     15's `transcribe_batch` run (c) over `create_mesh((1, 1))`, NCCL at
     world size 1, giving phase 15's outputs exactly; (b) the single-process
     runs here, then two ranks spawned on cuda:0 over gloo
     (`parallel.launch.run_ranks`): dp 2 greedy over 32 windows (16 a rank)
     with phase 4's options and `set_int8_mlp_kernel("auto")` (K14 on), dp
     2 beam 5 over 8 windows, tp 2 greedy over 8 windows (K14 off: its
     hidden rows are split; held against one process with the switch off),
     3 train steps at batch 16 over dp 2 with ZeRO-1 and 2 at batch 8 over
     tp 2; each held to its single-device phase's tolerance: the mesh
     run's tokens, forced through the fp32 plain path on the card, trail
     the argmax (beam: the 6th largest logit) by less than 0.5 and its
     avg_logprob lies within 0.1 (phases 5 and 11; how many windows kept
     the single-process tokens is printed); train losses within phase 7's
     2% of one process's and the first step's gradient at cosine >= 0.99
     per group; both ranks the same results and weights. Each rank's launch counts, reset before and read after each
     run, go into the kernels line.
 24. every head width that is a multiple of 8 up to 128 (K1, K2, K7,
     K7-lse, K8 and the fp32 K5 run a width in the smallest of 32, 64 and
     128 above it): (a) at each of 8, 16, 24, 40, 48, 56, 72, 80, 88, 96,
     104, 112 and 120, in bf16 and fp32, K7, K7-lse and K8 (causal,
     q_offset 48, non-causal with keys valid short of tk), K2 and K1 at
     groups 1 and 5 and the fp32 K5 against their plain versions at phase
     21's tolerances, bitwise on a second launch; then at two geometries,
     16 heads of 80 at large-v3's widths (d 1280, 128 mels, vocab 51866)
     and 8 heads of 96 at small's (d 768), 2 + 2 layers, random weights
     from seed 0 (AW_DIMS), each in bf16 and fp32: (b) each kernel at its
     paths' shapes, timed beside its bound at the true head width and SDPA;
     (c) the greedy window path on 8 windows with and without kv_quant,
     beam 5 on 4, 3 train steps at batch 8 and `evaluate`, phase 5's (bf16)
     or phase 20's (fp32) decode check against the CPU, each path's counts
     reset before and read after; (d) the CLI at 16 heads of 80, bf16, on
     a 30 s WAV. K1, K2, K7, K7-lse, K8 (each dtype) and K5 (both) launch
     on (c) and (d); K3 and K6 launch on none.
 25. head widths above 128 (K1 and K2 136-256 in the class of 256; K7,
     K7-lse, K8 and the fp32 K5 136-768 on the wide kernels): (a) at 136,
     200, 256, 384 and 768 (K1 / K2 to 256), in bf16 and fp32, each kernel
     against its plain version, bitwise on a second launch, and K8, K7, K1
     and K2 at 776 refused; then at 5 heads of 256 at
     large-v3's widths and 4 of 192 at small's, 2 + 2 layers, random
     weights from seed 0 (WW_DIMS), each in bf16 and fp32: (c) the greedy
     window path on 8 windows with and without kv_quant, beam 5 on 4, the
     decode gate against the CPU, 3 train steps at batch 8 (K7-lse and K8
     6 times a step) and `evaluate`, then phase 7's (bf16) and phase 20's
     (fp32) train gates; (d) at dh256 the CLI with the 19-token prompt;
     (b) each kernel at its paths' shapes, K8 beside SDPA's backward.
 26. every head width up to 768 (K1 and K2 264-768 in the classes of 512
     and 768, and widths off a multiple of 8 in K1, K2, K7, K7-lse and K8,
     which the flash wrappers lay out at the width rounded up to 8): (a) in
     bf16 and fp32, K2 and K1 at 264, 384, 512, 640 and 768 and at 4, 20,
     75, 100 and 300, groups 1, 5 and 16, and K7, K7-lse and K8 at 3, 20,
     75, 100, 300 and 700 (causal, q_offset, ragged kv_len), each against
     its plain version and bitwise on a second launch, K1 / K2 / K7 / K8
     at 0 refused, and the pad copy timed; then, random weights from seed
     0 (FW_DIMS), each in bf16 and fp32: (b) 2 heads of 640 at large-v3's
     widths, 2 + 2 layers: the greedy window path on 8 windows with and
     without kv_quant, beam 5 on 4 and the decode gate; (c) d 600 at 8
     heads of 75, 80 mels, 2 + 2 layers: the same, 3 train steps at batch
     8, `evaluate` and the train gates, and (bf16) the CLI with the
     19-token prompt; each kernel at those paths' shapes, timed.
 27. fp16 serving, random weights from seed 0 in fp16 (`from_random(...,
     dtype=torch.float16)`): (a) phase 4's window path at base's full
     width and depth, 3 batches of 32 windows, with the K14 switch off and
     then on; (b) one batch with kv_quant=False (K2 over fp16 caches) and
     phase 5's gate against the CPU's fp32 plain path; (c) `transcribe` of
     the 40 s WAV with beam 5 at t=0, the 19-token prompt carried into
     every window (K7, K9) and word timestamps, then `transcribe_batch` of
     it with int8 KV and words (K12 fp32); (d)-(g) one batch of 8
     windows with phase 4's options and the prompt at d 576 (9 heads of
     64: K5 on K3's maps), 8 heads of 96 (K5's route A), 4 of 192 (route
     B) and 5 of 256 (K7 on route B's kernel), 2 + 2 layers; every path's
     launches all fp16 kernels (or the fp32-only K4, K11-K13), each fp16
     kernel of the serving path launched; (h) each fp16 kernel (K1, K2,
     K3, K5, K7, K9, K10, K14) at those paths' shapes against its plain
     version at its bf16 twin's tolerance, bitwise on a second launch,
     timed beside its plain version, SDPA (or torch.topk) and its bound.
Phase 20 (d) also holds K2 at fp32 (the fp32 CLI's beam step) and K1 with
fp32 queries (the fp32 window path's cross) against their plain versions;
their launches count under `decode_attention_f32` and
`decode_attention_i8_f32`, and phase 20 refuses a bf16 K1 or K2 on its
fp32 paths.
It prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
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
BEAM = 5
BEAM_OPTIONS = dict(BASE_OPTIONS, beam_size=BEAM)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# kernels whose calls at small shapes are mostly the host's launch cost: their
# device time alone is measured too, as one call's share of a CUDA graph
DEVICE_TIMED = ("decode_attention", "decode_attention_i8", "decode_attention_f32", "decode_attention_i8_f32",
                "flash_attention_h2", "flash_attention_h2_lse",
                "flash_attention_h2_bwd", "flash_attention_mh", "flash_attention", "flash_attention_lse",
                "flash_attention_bwd", "log_mel", "dtw_trace", "int8_mlp", "median_filter",
                "flash_attention_h2_f32", "flash_attention_h2_lse_f32", "flash_attention_h2_bwd_f32",
                "flash_attention_mh_f32", "flash_attention_f32", "flash_attention_lse_f32", "flash_attention_bwd_f32",
                "int8_mlp_f32", "decode_attention_f16", "decode_attention_i8_f16", "flash_attention_h2_f16",
                "flash_attention_mh_f16", "flash_attention_f16", "int8_mlp_f16")
# dense, H100 SXM at 700 W; "3xtf32": fp32-accurate products as three TF32
# passes on the tensor cores (495 TFLOP/s / 3), "fp32" FFMA on the CUDA cores
PEAK_OPS_PER_S = {"bf16": 989e12, "fp16": 989e12, "int8": 1979e12, "fp32": 67e12, "3xtf32": 495e12 / 3}


def bound(flops: float, n_bytes: float, kind: str):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_ops, t_bytes = flops / PEAK_OPS_PER_S[kind], n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def k4_flops(n_frames: int, n_mels: int) -> dict:
    """fp32 operations of K4's function, a fused multiply-add counted as 2,
    three ways. "least": what the function needs: the window (400
    products), a 400-point real FFT at 2.5 N log2 N (half a complex FFT's
    5 N log2 N), the 201 powers (3 each) and each mel's nonzero weights (a
    product and a sum each). "factored": as `csrc/mel.cu` does them, its
    20-point DFTs as direct sums: the window; 20 real 20-point DFTs over n1
    (9 pair sums and 9 differences; 11 real parts of an add and 9
    multiply-adds; 9 imaginary parts of 9); for each of 20 k1, 20 twiddle
    products (6), 9 x 4 pair sums and differences, 10 bins of 2 adds and 36
    multiply-adds and their powers (3); bin 200 (20 adds and a power); the
    mels. "direct": the earlier kernel's 400 x 201 x 2 products and the
    dense mel product."""
    from asr_ttl_mtl_tpu_torch.ops.mel import mel_ranges

    mels = 2 * mel_ranges(n_mels)[3].size
    step1 = 20 * (18 + 11 * (1 + 9 * 2) + 9 * 9 * 2)
    step2 = 20 * (20 * 6 + 36 + 10 * (2 + 36 * 2) + 10 * 3) + 20 + 3
    return {"least": n_frames * (400 + 2.5 * 400 * math.log2(400) + 3 * 201 + mels),
            "factored": n_frames * (400 + step1 + step2 + mels),
            "direct": n_frames * (400 * 201 * 2 * 2 + 201 * n_mels * 2)}


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


def attn_bound(macs: float, n_bytes: float, mults: int = 4, kind: str = "bf16"):
    """Attention in bf16 (or `kind`): `mults` FLOPs per (query, key,
    channel) triple (4 forward: QK^T and PV; 10 backward: S, dP, dV, dQ, dK)."""
    return bound(mults * macs, n_bytes, kind)


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend PyTorch's dispatcher picks for scaled_dot_product_attention
    on these inputs (flash, efficient, cudnn or math), a label for a library
    column."""
    import torch
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(q, k, v, **kw)).name.lower()


def heads(x, n_head: int, n_keys=None):
    """(B, T, D) -> (B, H, T, 64) view for the library call, keys sliced to
    the valid length."""
    if n_keys is not None:
        x = x[:, :n_keys]
    b, t, d = x.shape
    return x.reshape(b, t, n_head, d // n_head).transpose(1, 2)


def k5_route(dh: int, tq: int) -> str:
    """The bf16 K5's plan at a head width, for its rows' cases."""
    from asr_ttl_mtl_tpu_torch.ops.flash_attention import k5_plan

    p = k5_plan(dh, tq)
    route = {"class": f"K3's forward at {p.width}", "A": f"route A at class {p.width}",
             "B": f"route B in {p.width} slabs"}[p.route]
    return f"{route} ({p.rows} rows a CTA, {p.keys}-key tiles, {p.stages} stages, {p.smem} B shared)"


def make_recorder(card: str, rows: list):
    """record(name, case, source, replaces, got, want, tol, run_kernel,
    run_plain, bound=(ms, by), library=None, main=True, plain_iters=20,
    repeat=False, ffma_bound=None): check and time one kernel (the plain
    version over `plain_iters` calls); `ffma_bound`, (ms, by) on the CUDA
    cores, is printed and kept beside the bound. `got`/`want`/`tol` may be lists (one per output); a `tol` is
    one number or a tensor of per-output bounds on |kernel - plain|. With
    `repeat`, one more launch must give `got` bit for bit."""
    import torch

    from asr_ttl_mtl_tpu_torch.scripts.card_timing import graph_ms

    def bits(t):  # a float tensor's bits, so that a NaN equals itself
        ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}
        return t.view(ints[t.dtype]) if t.dtype in ints else t

    def record(name, case, source, replaces, got, want, tol, run_kernel, run_plain, *, bound, library=None,
               main=True, plain_iters=20, repeat=False, ffma_bound=None):
        torch.cuda.synchronize()
        gots, wants, tols = (x if isinstance(x, list) else [x] for x in (got, want, tol))
        if repeat:
            again = run_kernel()
            again = list(again) if isinstance(again, (tuple, list)) else [again]
            if not all(torch.equal(bits(a), bits(g)) for a, g in zip(again, gots)):
                raise AssertionError(f"{name} {case}: a second launch gave other bits")
        err, worst, ref, finite = 0.0, 0.0, 0.0, True
        for g, w, t in zip(gots, wants, tols):
            if isinstance(t, str):  # "exact": same values, NaN at the same places (min/max and int traces round nothing)
                same = torch.equal(torch.isnan(g.float()), torch.isnan(w.float()))
                diff = (torch.nan_to_num(g.float()) - torch.nan_to_num(w.float())).abs()
                err = max(err, diff.max().item())
                worst = max(worst, 0.0 if same and err == 0.0 else float("inf"))
                ref = max(ref, torch.nan_to_num(w.float()).abs().max().item())
                continue
            diff = (g.float() - w.float()).abs()
            err = max(err, diff.max().item())
            worst = max(worst, (diff / t).max().item())  # <= 1 passes
            ref = max(ref, w.float().abs().max().item())
            finite = finite and bool(torch.isfinite(g.float()).all())
        tol_s = "; ".join(t if isinstance(t, str) else f"{t:.3e}" if isinstance(t, float) else
                          f"per output, {t.min().item():.3e}..{t.max().item():.3e}" for t in tols)
        ms, plain_ms = timed_ms(run_kernel), timed_ms(run_plain, iters=plain_iters, warmup=min(3, plain_iters))
        library_ms = timed_ms(library) if library is not None else None
        device_ms = graph_ms(run_kernel) if name in DEVICE_TIMED else None
        bound_ms, bound_by = bound
        ok = worst <= 1.0 and finite
        lib_s = f"{library_ms:.4f} ms" if library_ms is not None else "none"
        dev_s = f" (device {device_ms:.4f} ms)" if device_ms is not None else ""
        rep_s = ", bitwise on a second launch" if repeat else ""
        ffma_s = f", FFMA bound {ffma_bound[0]:.4f} ms ({ffma_bound[1]})" if ffma_bound is not None else ""
        print(f"[kernel] {name} {case}: max_abs_err={err:.3e} (tol {tol_s}; max|ref| {ref:.3e}), "
              f"worst err/tol {worst:.3f}{rep_s}; kernel {ms:.4f} ms{dev_s}, plain {plain_ms:.4f} ms, library {lib_s}, "
              f"bound {bound_ms:.4f} ms ({bound_by}){ffma_s} [{card}] {'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"{name} {case}: max_abs_err {err}, worst err/tol {worst} (tol {tol_s})")
        row = dict(name=name, case=case, route="cuda", source=source, replaces=replaces, max_abs_err=err,
                   err_over_tol=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                   library_ms=library_ms, main=main)
        if device_ms is not None:
            row["device_ms"] = device_ms
        if ffma_bound is not None:
            row["ffma_bound_ms"] = ffma_bound[0]
        rows.append(row)

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
               library=lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True), main=main,
               repeat=True)
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
        # 4-D (1, BH, T, 64) for the library call: SDPA's fused kernels take no 3-D input
        ql, kl, vl = (x[None].detach().requires_grad_(True) for x in (q, k, v))
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        record("flash_attention_lse", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
               [out, lse], [pout, plse], [rel_tol(pout), 1e-4],
               lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
               lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
               bound=attn_bound(128 * pairs * 64, io + lse.numel() * 4),
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, **lib), main=train_main,
               repeat=True)
        record("flash_attention", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
               FA.flash_attention(q, k, v, **kw), pout, rel_tol(pout),
               lambda: FA.flash_attention(q, k, v, **kw), lambda: FA.flash_attention_plain(q, k, v, **kw),
               bound=attn_bound(128 * pairs * 64, io),
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, **lib),
               main=not q_offset and tq == main_v, repeat=True)
        got = list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
        want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, **lib)
        record("flash_attention_bwd", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030",
               got, want, [rel_tol(w) for w in want],
               lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
               lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
               bound=attn_bound(128 * pairs * 64, 2 * io + 2 * lse.numel() * 4, mults=10),
               library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g[None], retain_graph=True),
               main=train_main, repeat=True)
    return rows


def check_kernels(card: str):
    """Phase 3: every kernel against its plain version at base shapes."""
    import torch

    from asr_ttl_mtl_tpu_torch.audio import HOP_LENGTH, N_FFT, mel_filters
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts
    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA
    from asr_ttl_mtl_tpu_torch.ops import mel as M
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    rows = []
    record = make_recorder(card, rows)

    # K4 at the paths' shapes: 32 clips of 30 s (the decode slice), the CLI's
    # long WAV (LONG_WAV_S + 30 s of padding, bucketed to whole windows:
    # `long_wav_frames`) and the train step's 16 clips of 30 s, fp32. Compared after the max-8
    # clamp and (x+4)/4, as the encoder sees it: the kernel's factored DFT and
    # the plain version's direct products round differently (~1e-6 in log10
    # of a bin, more near the clamp floor).
    def finish(x):
        return (torch.maximum(x, x.amax(dim=(-2, -1), keepdim=True) - 8.0) + 4.0) / 4.0

    fb = torch.from_numpy(mel_filters(80)).to(dev)
    hann = torch.hann_window(N_FFT, device=dev)
    for batch, n_frames, what in ((N_WINDOWS, 3000, "the decode slice's 32 x 30 s"),
                                  (1, long_wav_frames(), f"the CLI's {LONG_WAV_S:.0f} s WAV, bucketed to "
                                   f"{long_wav_frames() // 100} s"),
                                  (TRAIN_BATCH, 3000, "a train step's 16 x 30 s")):
        wave = torch.randn((batch, n_frames * HOP_LENGTH), generator=gen, device=dev) * 0.1
        padded = F.pad(wave[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0].contiguous()
        n_fr = batch * n_frames

        def composition(wave=wave):
            st = torch.stft(wave, N_FFT, HOP_LENGTH, window=hann, center=True, return_complex=True)
            return torch.log10(torch.clamp(fb @ (st[..., :-1].abs() ** 2), min=1e-10))

        # bound: the padded audio in and the mels out, or the function's
        # least fp32 operations (a real FFT), whichever is larger; the
        # operations of the kernel's factored DFT and of the direct form beside it
        n_bytes = padded.numel() * 4 + n_fr * 80 * 4
        flops = k4_flops(n_fr, 80)
        got = M.log_mel(padded, n_frames, 80)
        if not torch.equal(M.log_mel(padded, n_frames, 80), got):
            raise AssertionError(f"log_mel ({batch}, {n_frames}): a second launch gave other bits")
        record("log_mel", f"({batch}, {padded.shape[1]}) f32 -> ({batch}, 80, {n_frames}): {what}",
               "asr_ttl_mtl_tpu_torch/csrc/mel.cu", "asr_ttl_mtl_tpu/ops/pallas_mel.py:44",
               finish(got), finish(M.log_mel_plain(padded, n_frames, 80)), 1e-4,
               lambda: M.log_mel(padded, n_frames, 80), lambda: M.log_mel_plain(padded, n_frames, 80),
               bound=bound(flops["least"], n_bytes, "fp32"), library=composition)
        row = rows[-1]
        row["library_is"] = ("a composition, not one call: torch.stft(n_fft=400, hop_length=160, hann, "
                             "center=True), |.|^2, the mel matmul, log10")
        row["factored_bound_ms"] = bound(flops["factored"], n_bytes, "fp32")[0]
        row["direct_bound_ms"] = bound(flops["direct"], n_bytes, "fp32")[0]
        print(f"[kernel] log_mel ({batch}, {n_frames}): bound {row['bound_ms']:.4f} ms ({row['bound_by']}); "
              f"by the operations of the kernel's factored DFT {row['factored_bound_ms']:.4f} ms, of the direct "
              f"DFT {row['direct_bound_ms']:.4f} ms [{card}]", flush=True)
        del wave, padded, got

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
    # with the logsumexp (the training forward's kernel) at the same shape;
    # lse within 1e-4, as phase 8 holds it
    want, want_lse = FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
    got, got_lse = FA.flash_attention_h2(q, k, v, return_lse=True, **kw)
    record("flash_attention_h2_lse", "q,k,v (32, 1536, 512) bf16, kv_valid_len 1500",
           "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", "asr_ttl_mtl_tpu/ops/flash_attention.py:552",
           [got, got_lse], [want, want_lse], [2.0**-6 * want.float().abs().max().item(), 1e-4],
           lambda: FA.flash_attention_h2(q, k, v, return_lse=True, **kw),
           lambda: FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw),
           bound=attn_bound(N_WINDOWS * 1536 * 1500 * 512,
                            (2 * q.numel() + 2 * 32 * 1500 * 512) * 2 + want_lse.numel() * 4),
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=False)
    del q, k, v, want, qh, kh, vh, got, got_lse, want_lse
    # the edges of the key tiles and of the one-warpgroup CTA (tq <= 64)
    for case, b, tq, tk, kv_len in (("q (2, 200, 512), k,v (2, 200, 512), kv_valid_len 150", 2, 200, 200, 150),
                                    ("q (32, 32, 512), k,v (32, 1500, 512)", N_WINDOWS, 32, 1500, None)):
        q = torch.randn((b, tq, 512), generator=gen, device=dev).bfloat16()
        k, v = (torch.randn((b, tk, 512), generator=gen, device=dev).bfloat16() for _ in range(2))
        kw = dict(n_head=8, kv_valid_len=kv_len, scale=0.125)
        n_keys = kv_len or tk
        want = FA.flash_attention_h2_plain(q, k, v, **kw)
        qh, kh, vh = heads(q, 8), heads(k, 8, n_keys), heads(v, 8, n_keys)
        record("flash_attention_h2", case, "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu",
               "asr_ttl_mtl_tpu/ops/flash_attention.py:514",
               FA.flash_attention_h2(q, k, v, **kw), want, 2.0**-6 * want.float().abs().max().item(),
               lambda: FA.flash_attention_h2(q, k, v, **kw), lambda: FA.flash_attention_h2_plain(q, k, v, **kw),
               bound=attn_bound(b * tq * n_keys * 512, (2 * q.numel() + 2 * b * n_keys * 512) * 2),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=False)
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
    record("decode_attention_f32", "self (6,32,128,512) f32, valid_upto 70",
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
    # show: the running max cancels in p*v_scale / sp; so does the kernel's
    # split of the blocks across a cluster, each CTA from its own running max.
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
               lambda: DA.decode_attention_i8_plain(qd, *args, 5, 8, **kw), bound=i8_bound, main=main, repeat=True)

    # K1 and K2 at group 5, as the beam paths run cross-attention: the 5
    # beams (or best-of candidates) of a window share its cross K/V row.
    # Phase 10 runs K1 with q (160, 1, 512) over the int8 store; the CLI
    # (phase 12, bf16 caches) runs K2 with q (5, 1, 512) over one window's
    # (6, 1, 1500, 512), here also over 32 windows. Same tolerances as above.
    qg = torch.randn((N_WINDOWS * BEAM, 1, 512), generator=gen, device=dev).bfloat16()
    one_k, one_v = cross_k[:, :1].contiguous(), cross_v[:, :1].contiguous()
    for case, q, ck, cv in (
        (f"cross (6,1,1500,512) bf16, q ({BEAM},1,512), group {BEAM} (CLI)", qg[:BEAM], one_k, one_v),
        (f"cross (6,32,1500,512) bf16, q ({N_WINDOWS * BEAM},1,512), group {BEAM}", qg, cross_k, cross_v),
    ):
        b = ck.shape[1]
        kw = dict(scale=scale, group=BEAM)
        want = DA.decode_attention_plain(q, ck, cv, 5, 8, **kw)
        qh = q.reshape(b, BEAM, 8, 64).transpose(1, 2)
        kh, vh = heads(ck[5], 8), heads(cv[5], 8)
        record("decode_attention", case, "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu",
               "asr_ttl_mtl_tpu/ops/decode_attention.py:39", DA.decode_attention(q, ck, cv, 5, 8, **kw), want,
               2.0**-7 * want.float().abs().max().item(),
               lambda: DA.decode_attention(q, ck, cv, 5, 8, **kw),
               lambda: DA.decode_attention_plain(q, ck, cv, 5, 8, **kw),
               bound=attn_bound(b * BEAM * 1500 * 512, 2 * b * 1500 * 512 * 2),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=False)
    # K2 above group 8 (best_of 9 and more) and at batch 1 and group 1: one
    # launch for the whole group, whatever it is
    for group, b in ((9, 1), (16, N_WINDOWS), (1, 1)):
        q = torch.randn((b * group, 1, 512), generator=gen, device=dev).bfloat16()
        ck, cv = (one_k, one_v) if b == 1 else (cross_k, cross_v)
        kw = dict(scale=scale, group=group)
        want = DA.decode_attention_plain(q, ck, cv, 5, 8, **kw)
        reset_launch_counts()
        got = DA.decode_attention(q, ck, cv, 5, 8, **kw)
        if LAUNCHES["decode_attention"] != 1:
            raise AssertionError(f"K2 at group {group}: {LAUNCHES['decode_attention']} launches, expected 1")
        qh = q.reshape(b, group, 8, 64).transpose(1, 2)
        kh, vh = heads(ck[5], 8), heads(cv[5], 8)
        record("decode_attention", f"cross (6,{b},1500,512) bf16, q ({b * group},1,512), group {group}, one launch",
               "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu", "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
               got, want, 2.0**-7 * want.float().abs().max().item(),
               lambda: DA.decode_attention(q, ck, cv, 5, 8, **kw),
               lambda: DA.decode_attention_plain(q, ck, cv, 5, 8, **kw),
               bound=attn_bound(b * group * 1500 * 512, 2 * b * 1500 * 512 * 2),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=False)
    # K2 with valid_upto inside the first chunk of a 448-row self cache (one
    # CTA a head), and a later position that splits it
    long_k = torch.randn((6, N_WINDOWS, 448, 512), generator=gen, device=dev).bfloat16()
    long_v = torch.randn((6, N_WINDOWS, 448, 512), generator=gen, device=dev).bfloat16()
    for b, valid in ((N_WINDOWS, 0), (N_WINDOWS, 37), (1, 300)):
        ck, cv = long_k[:, :b].contiguous(), long_v[:, :b].contiguous()
        q = torch.randn((b, 1, 512), generator=gen, device=dev).bfloat16()
        kw = dict(scale=scale, valid_upto=valid)
        want = DA.decode_attention_plain(q, ck, cv, 5, 8, **kw)
        n_keys = valid + 1
        qh, kh, vh = heads(q, 8), heads(ck[5], 8, n_keys), heads(cv[5], 8, n_keys)
        record("decode_attention", f"self (6,{b},448,512) bf16, valid_upto {valid}",
               "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu", "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
               DA.decode_attention(q, ck, cv, 5, 8, **kw), want, 2.0**-7 * want.float().abs().max().item(),
               lambda: DA.decode_attention(q, ck, cv, 5, 8, **kw),
               lambda: DA.decode_attention_plain(q, ck, cv, 5, 8, **kw),
               bound=attn_bound(b * n_keys * 512, 2 * b * n_keys * 512 * 2),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=False)
    del long_k, long_v
    # K1 at the beam's group 5 and at group 16 over the 32 windows' store,
    # and over one window (tk_blk 512: three blocks, a cluster of 3), each
    # cache byte read once a call whatever the group
    ck1 = [x[:, :1].contiguous() for x in (ck8, cks, cv8, cvs)]
    for b, group, args in ((N_WINDOWS, BEAM, (ck8, cks, cv8, cvs)), (N_WINDOWS, 16, (ck8, cks, cv8, cvs)),
                           (1, 1, ck1), (1, BEAM, ck1)):
        q = qg if group == BEAM and b == N_WINDOWS else torch.randn((b * group, 1, 512), generator=gen,
                                                                    device=dev).bfloat16()
        kw = dict(scale=scale, valid_upto=1499, group=group)
        want, flip = DA.decode_attention_i8_plain(q, *args, 5, 8, return_flip_bound=True, **kw)
        ref = want.float().abs()
        tk_blk = DA._i8_blocks(b, 1536, 512)[1]
        split = DA.k1_plan(b, 8, DA.k1_n_blocks(1536, tk_blk, 1499), group)
        record("decode_attention_i8",
               f"cross (6,{b},1536,512) int8, q ({b * group},1,512), group {group}, valid_upto 1499, "
               f"tk_blk {tk_blk}, cluster {split}",
               "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu", "asr_ttl_mtl_tpu/ops/decode_attention.py:186",
               DA.decode_attention_i8(q, *args, 5, 8, **kw), want,
               (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max(),
               lambda: DA.decode_attention_i8(q, *args, 5, 8, **kw),
               lambda: DA.decode_attention_i8_plain(q, *args, 5, 8, **kw),
               bound=bound(4 * b * group * 1500 * 512, 2 * b * 1500 * (512 + 4), "int8"), main=False, repeat=True)
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


def pipeline(task, mel, n_batches: int = N_BATCHES):
    """n_batches batches of `mel` through a depth-2 submit/collect pipeline:
    (results, wall s, s the host spent in collect waiting for the card)."""
    t = time.perf_counter()
    pending = task.submit(mel, rng_seed=0)
    out, wait = [], 0.0
    for i in range(1, n_batches + 1):
        nxt = task.submit(mel, rng_seed=i) if i < n_batches else None
        t_c = time.perf_counter()
        out += task.collect(pending)
        wait += time.perf_counter() - t_c
        pending = nxt
    return out, time.perf_counter() - t, wait


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
    results, t_dec, t_wait = pipeline(task, mel)
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
    rates = sorted(audio_s / pipeline(task, mel)[1] for _ in range(4))
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
    return model, main_counts, k2_counts, statistics.median(rates)


def forced_steps(model, waves, toks, options, device: str = "cpu"):
    """The plain path in fp32 on `device` (a copy of the model), teacher-
    forced to the card's tokens `toks` (rows, n) under the same options:
    with kv_quant the prefill reads the float cross K/V, as the card's fused
    window does, and the steps the int8 store; without it, float caches.
    Returns (its log-mel, [(filtered logits (rows, V), chosen tokens (rows,))
    per step])."""
    import copy

    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.decode_steps import _apply_filters
    from asr_ttl_mtl_tpu_torch.models import whisper as W

    ref = copy.deepcopy(model).to(device)
    ref.compute_dtype = torch.float32
    mel = log_mel_spectrogram(waves, n_mels=ref.dims.n_mels, device=device)
    rows = toks.shape[0]
    toks = toks.to(device)
    steps = []
    with torch.no_grad():
        feats = W.encoder_apply(ref.encoder, mel, torch.float32, int8_linears=options["int8_encoder"])
        if options["kv_quant"]:
            cross_f = W.precompute_cross_kv(ref.decoder, feats, stack=False)
            cross = W.quantize_cross_kv(cross_f)
            cache = W.init_kv_cache_i8(ref.dims, rows, ctx=128, device=device)
        else:
            cross_f = cross = W.precompute_cross_kv(ref.decoder, feats)
            cache = W.init_kv_cache(ref.dims, rows, torch.float32, ctx=128, device=device)
        ref_task = DecodingTask(ref, DecodingOptions(**{**options, "fp16": False}))
        init = list(ref_task.initial_tokens)
        seq = torch.tensor([init + [ref_task.tokenizer.eot] * (8 - len(init))] * rows, device=device)
        logits, cache = W.decoder_apply(ref.decoder, seq, cross_kv=cross_f, kv_cache=cache)
        step_logits = logits[:, len(init) - 1]
        prev = penult = last_ts = torch.full((rows,), -1, device=device)
        for i in range(toks.shape[1]):
            tok = toks[:, i]
            steps.append((_apply_filters(ref_task.filter_cfg, step_logits, i, prev, penult, last_ts), tok))
            prev, penult = tok, prev
            if i + 1 < toks.shape[1]:
                step_logits = W.decoder_apply(
                    ref.decoder, tok[:, None], cross_kv=cross, kv_cache=cache, pos_offset=len(init) + i
                )[0][:, 0]
    return mel, steps


def forced_on_cpu(model, waves, mel_card, toks, options):
    """`forced_steps` on the CPU: (log-mel max error against `mel_card`,
    its steps)."""
    mel_cpu, steps = forced_steps(model, waves, toks, options)
    return (mel_card.cpu() - mel_cpu).abs().max().item(), steps


def check_against_cpu(model, waves_seed: int = 1):
    """Phase 5: the card's decode of 2 windows against the plain path on the
    CPU in fp32, forced to the card's tokens (same weights, same options)."""
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram

    waves = make_waves(2, seed=waves_seed)
    mel = log_mel_spectrogram(waves, n_mels=model.dims.n_mels, device=DEVICE)
    card = DecodingTask(model, DecodingOptions(**BASE_OPTIONS)).run(mel)
    toks = torch.tensor([r.tokens for r in card])  # (2, 64)
    mel_err, steps = forced_on_cpu(model, waves, mel, toks, BASE_OPTIONS)
    worst_gap = max((lg.amax(-1) - lg.gather(1, tok[:, None])[:, 0]).max().item() for lg, tok in steps)
    sum_lp = sum(lg.gather(1, tok[:, None])[:, 0] - torch.logsumexp(lg, -1) for lg, tok in steps)
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


def run_training(card: str, workdir: str, compute_dtype: str = "bfloat16"):
    """Phase 6: the training slice at the full width of base, bf16; phase
    20 (c) runs it in fp32, where every launch is an fp32 kernel's."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    tag, sfx = ("[train]", "") if compute_dtype == "bfloat16" else ("[train fp32]", "_f32")
    cfg = TrainingConfig(model_size=MODEL, pretrained="random", batch_size=TRAIN_BATCH, val_batch_size=TRAIN_BATCH,
                         compute_dtype=compute_dtype, learning_rate=1e-5, seed=0, num_workers=4, epochs=1,
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
    print(f"{tag} base: {n_params} parameters (vocab {trainer.model.dims.n_vocab}), batch {TRAIN_BATCH}, "
          f"token buckets {[b['input_tokens'].shape[1] for b in batches]}", flush=True)

    # K3 in each encoder layer and each cross-attention, K7 in each causal self-attention
    n_h2, n_k7 = trainer.model.dims.n_audio_layer + trainer.model.dims.n_text_layer, trainer.model.dims.n_text_layer
    per_step = {"log_mel": 1, f"flash_attention_h2_lse{sfx}": n_h2, f"flash_attention_h2_bwd{sfx}": n_h2,
                f"flash_attention_lse{sfx}": n_k7, f"flash_attention_bwd{sfx}": n_k7}
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
    print(f"{tag} {TRAIN_STEPS} steps: losses {', '.join(f'{x:.4f}' for x in losses)}; alpha {trainer.alpha:.4f} "
          f"beta {trainer.beta:.4f}; step s {', '.join(f'{x:.4f}' for x in step_s)} (first has the set-up); "
          f"steady {steady * 1e3:.1f} ms = {TRAIN_BATCH / steady:.1f} samples/s; peak memory "
          f"{peak_gb:.2f} GB (max_memory_allocated) [{card}]", flush=True)
    print(f"{tag} launches per step {json.dumps(per_step)}", flush=True)

    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    metrics = trainer.evaluate(val_batches)
    sync()
    t_eval = time.perf_counter() - t0
    eval_counts = dict(LAUNCHES)
    n_val = len(val_batches)
    expect = {"log_mel": n_val, f"flash_attention_h2{sfx}": n_h2 * n_val, f"flash_attention{sfx}": n_k7 * n_val}
    if {k: v for k, v in eval_counts.items() if v} != expect:
        raise AssertionError(f"evaluate launched {eval_counts}, expected {expect}")
    for key in ("loss", "cls_loss", "trans_loss", "wer", "cer", "disease_acc"):
        if not np.isfinite(metrics[key]):
            raise AssertionError(f"evaluate: {key} = {metrics[key]}")
    print(f"{tag} evaluate on {len(val_ds)} clips: {t_eval:.3f} s; loss {metrics['loss']:.4f} "
          f"wer {metrics['wer']:.4f} cer {metrics['cer']:.4f} acc {metrics['disease_acc']:.4f}; "
          f"launches {json.dumps(expect)} [{card}]", flush=True)

    t0 = time.perf_counter()
    trainer.save_checkpoint(epoch=0, best_loss=metrics["loss"], val_metrics=metrics)
    path = trainer.checkpoint_path()
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if ckpt["model_state_dict"]["decoder.token_embedding.weight"].shape != (51869, trainer.model.dims.n_text_state):
        raise AssertionError("checkpoint: unexpected embedding shape")
    print(f"{tag} save_checkpoint {path}: {os.path.getsize(path) / 1e6:.1f} MB in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    buckets = ([b["input_tokens"].shape[1] for b in batches], [b["input_tokens"].shape[1] for b in val_batches])
    return trainer, batches[0], train_counts, eval_counts, buckets


def grads_by_group(trainer):
    """A trainer's gradients after a step, flattened per optimizer group, fp32 on the CPU."""
    import torch

    from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of

    out = {}
    for name, p in trainer.named_trainable():
        out.setdefault(group_of(name), []).append(p.grad.detach().float().cpu().flatten())
    return {g: torch.cat(v) for g, v in out.items()}


def cpu_reference_step(trainer, batch):
    """The weights of `trainer` (copied: a step updates them in place), the
    first 2 clips of `batch` and a seeded dropout mask through one fp32
    step of the plain path on the CPU, at the trainer's dims (phases 7 and
    21): the step's inputs, the copies, and the CPU's loss, gradients per
    group and seconds."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig

    small = {k: (v[:2] if k in ("audio", "input_tokens", "target_tokens", "classes", "texts", "paths") else v)
             for k, v in batch.items()}
    keep = torch.from_numpy(np.random.RandomState(3).rand(2, trainer.model.dims.n_audio_state // 2) < 0.9)
    model_sd = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
    head_sd = {k: v.detach().cpu().clone() for k, v in trainer.classifier.state_dict().items()}
    cpu = MultiTaskTrainer(TrainingConfig(model_size=MODEL, pretrained="random", debug_dims=trainer.config.debug_dims,
                                          audio_samples=trainer.config.audio_samples, compute_dtype="float32",
                                          device="cpu", seed=0), verbose=False)
    cpu.load_state(model_sd, head_sd)
    cpu.alpha, cpu.beta = trainer.alpha, trainer.beta
    t0 = time.perf_counter()
    cpu_loss, _ = cpu.train_step(small, keep=keep)
    t_cpu = time.perf_counter() - t0
    return dict(batch=small, keep=keep, model_sd=model_sd, head_sd=head_sd, alpha=trainer.alpha, beta=trainer.beta,
                cpu_loss=float(cpu_loss), cpu_grads=grads_by_group(cpu), cpu_s=t_cpu)


def check_train_step_against_cpu(card: str, trainer, batch):
    """Phase 7: the same weights, 2-clip batch and dropout mask through one
    bf16 step on the card and one fp32 step on the CPU (plain path): the
    losses within 2% and each group's gradient at cosine >= 0.99. Returns
    the CPU step's inputs and results for phase 20's fp32 step."""
    import torch

    ref = cpu_reference_step(trainer, batch)
    card_loss, _ = trainer.train_step(ref["batch"], keep=ref["keep"])
    card_g, cpu_g = grads_by_group(trainer), ref["cpu_grads"]
    rel = abs(float(card_loss) - ref["cpu_loss"]) / abs(ref["cpu_loss"])
    cos = {g: float(torch.nn.functional.cosine_similarity(card_g[g].double(), cpu_g[g].double(), dim=0))
           for g in cpu_g}
    worst = min(cos, key=cos.get)
    ok = rel <= 0.02 and cos[worst] >= 0.99
    print(f"[check] train step, card bf16 vs CPU fp32 plain path (2 clips, same weights and dropout): loss "
          f"{float(card_loss):.5f} vs {ref['cpu_loss']:.5f}, rel diff {rel:.2e} (tol 2e-2); gradient cosine "
          f"{', '.join(f'{g} {c:.5f}' for g, c in cos.items())}, worst {worst} {cos[worst]:.5f} (tol 0.99); "
          f"CPU step {ref['cpu_s']:.1f} s {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card's train step disagrees with the CPU reference")
    return ref


def check_topk_kernels(card: str, filter_cfg):
    """Phase 9: K9 (bf16, fp32) and K10 (fp32) against their plain versions
    at the paths' shapes: one window's 5 beams (5 rows, the CLI and the
    words runs), batch mode's 80 and the beam slice's 32 windows x 5 beams
    = 160 rows, of 51865, k 6. Indices exact; K9's values within 4e-6 of
    max(1, |v|) (the row sum runs in another order), K10's exact; a second
    launch gives the same bits (-inf and NaN included)."""
    import torch

    from asr_ttl_mtl_tpu_torch.decode_steps import _filter_masks
    from asr_ttl_mtl_tpu_torch.ops import topk as T
    from asr_ttl_mtl_tpu_torch.scripts.card_timing import graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows_out = []
    record = make_recorder(card, rows_out)
    n_rows, k = N_WINDOWS * BEAM, BEAM + 1
    x = torch.randn((n_rows, filter_cfg.n_vocab), generator=gen, device=dev) * 2.0
    _, suppress = _filter_masks(filter_cfg, dev)
    x = x.masked_fill(suppress[None, :], float("-inf"))
    x[:, [1000, 2000, 3000]] = x.amax(dim=-1, keepdim=True) + 0.5  # an exact tie at the top
    x[:, 4000] = x[:, 5000]  # a duplicate below it
    for r in (2, 7):  # fewer than k finite values (row 2 lies in every shape)
        x[r] = float("-inf")
        x[r, [11, 12, 13]] = 1.0
    src, replaces = "asr_ttl_mtl_tpu_torch/csrc/topk.cu", "asr_ttl_mtl_tpu/ops/pallas_topk.py"

    def finite(v):
        return torch.nan_to_num(v, neginf=-3e38)

    for name, fn, plain, dtype, rows, lib, main in (
        ("topk_logprobs", T.topk_logprobs, T.topk_logprobs_plain, torch.bfloat16, BEAM,
         lambda xt: torch.topk(xt.float().log_softmax(-1), k), True),
        ("topk_logprobs", T.topk_logprobs, T.topk_logprobs_plain, torch.bfloat16, 80,
         lambda xt: torch.topk(xt.float().log_softmax(-1), k), True),
        ("topk_logprobs", T.topk_logprobs, T.topk_logprobs_plain, torch.bfloat16, n_rows,
         lambda xt: torch.topk(xt.float().log_softmax(-1), k), True),
        ("topk_logprobs", T.topk_logprobs, T.topk_logprobs_plain, torch.float32, n_rows,
         lambda xt: torch.topk(xt.float().log_softmax(-1), k), False),
        ("topk", T.topk, T.topk_plain, torch.float32, n_rows, lambda xt: torch.topk(xt, k), True),
    ):
        xt = x[:rows].to(dtype).contiguous()
        (gv, gi), (pv, pi), (av, ai) = fn(xt, k), plain(xt, k), fn(xt, k)
        if not (torch.equal(av.view(torch.int32), gv.view(torch.int32)) and torch.equal(ai, gi)):
            raise AssertionError(f"{name} ({rows}) {dtype}: a second launch gave other bits")
        if not torch.equal(torch.isfinite(gv), torch.isfinite(pv)):
            raise AssertionError(f"{name}: -inf values at other places than the plain version's")
        v_tol = 4e-6 * pv.abs().clamp(min=1.0) if name == "topk_logprobs" else torch.full_like(pv, 1e-30)
        esize = xt.element_size()
        split = T.k9_plan(rows, filter_cfg.n_vocab, *T._card_limits(dev.index or 0))
        record(name, f"({rows}, {filter_cfg.n_vocab}) {str(dtype)[6:]}, k {k}, cluster of {split}", src,
               f"{replaces}:{51 if name == 'topk_logprobs' else 32}",
               [finite(gv), gi], [finite(pv), pi], [v_tol, 0.5],
               lambda: fn(xt, k), lambda: plain(xt, k),
               # bytes: the logits read once, values and indices written once;
               # operations: a compare (and for K9 an exp and an add) an entry
               bound=bound(xt.numel() * (3 if name == "topk_logprobs" else 1),
                           xt.numel() * esize + rows * k * 8, "fp32"),
               library=lambda: lib(xt), main=main)
        # these kernels take microseconds, less than the wrapper's host
        # work: their device time, and the library's, without it
        row = rows_out[-1]
        row["device_ms"], row["library_device_ms"] = graph_ms(lambda: fn(xt, k)), graph_ms(lambda: lib(xt))
        print(f"[kernel] {name} ({rows}) {str(dtype)[6:]}: device time per call (CUDA graph of 10 calls, 5 replays) "
              f"kernel {row['device_ms']:.4f} ms, library {row['library_device_ms']:.4f} ms [{card}]", flush=True)
    return rows_out


def run_beam_slice(card: str, model):
    """Phase 10: the beam window path at base, 3 batches of 32 windows."""
    import numpy as np

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    mel = log_mel_spectrogram(make_waves(N_WINDOWS, seed=0), device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**BEAM_OPTIONS))
    task.run(mel)  # warm-up, not counted
    sync()
    reset_launch_counts()
    results, t_dec, t_wait = pipeline(task, mel)
    counts = dict(LAUNCHES)
    steps = N_BATCHES * BEAM_OPTIONS["sample_len"]  # EOT is suppressed: every search runs to the horizon
    assert len(results) == N_WINDOWS * N_BATCHES
    for r in results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), (len(r.tokens), r.avg_logprob)
    assert counts["topk_logprobs"] == steps, (counts, steps)
    assert counts["decode_attention_i8"] > 0, counts
    assert counts["flash_attention_h2"] == model.dims.n_audio_layer * N_BATCHES, counts
    audio_s = N_WINDOWS * N_BATCHES * 30.0
    per_step = {k: round(v / steps, 2) for k, v in counts.items() if v}
    print(f"[beam] base, {N_BATCHES} batches x {N_WINDOWS} windows x {BEAM} beams, kv_quant + int8_encoder, "
          f"64 tokens: decode {t_dec:.3f} s = {audio_s / t_dec:.1f} audio-s/s, of which {t_wait * 1e3:.1f} ms "
          f"in collect [{card}]", flush=True)
    print(f"[beam] launches {json.dumps(counts)}; per beam step {json.dumps(per_step)}; "
          f"text[0]={results[0].text[:60]!r} avg_logprob[0]={results[0].avg_logprob:.4f}", flush=True)
    rates = sorted(audio_s / pipeline(task, mel)[1] for _ in range(4))
    print(f"[beam] 4 more runs: {', '.join(f'{r:.1f}' for r in rates)} audio-s/s "
          f"(median {statistics.median(rates):.1f}) [{card}]", flush=True)
    return counts


def check_beam_against_cpu(model, waves_seed: int = 1):
    """Phase 11: the card's beam on 2 windows against the plain path on the
    CPU in fp32, forced to the card's best sequences. Each chosen token is
    among its beam's top K+1 on the card, so on the CPU it may trail the
    (K+1)-th largest filtered logit only by the bf16 noise of the logits."""
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram

    waves = make_waves(2, seed=waves_seed)
    mel = log_mel_spectrogram(waves, device=DEVICE)
    card = DecodingTask(model, DecodingOptions(**BEAM_OPTIONS)).run(mel)
    toks = torch.tensor([r.tokens for r in card])  # (2, 64)
    mel_err, steps = forced_on_cpu(model, waves, mel, toks, BEAM_OPTIONS)
    worst_gap = max((lg.topk(BEAM + 1, dim=-1).values[:, -1] - lg.gather(1, tok[:, None])[:, 0]).max().item()
                    for lg, tok in steps)
    sum_lp = sum(lg.gather(1, tok[:, None])[:, 0] - torch.logsumexp(lg, -1) for lg, tok in steps)
    avg = sum_lp / (toks.shape[1] + 1)
    lp_err = max(abs(avg[r].item() - card[r].avg_logprob) for r in range(2))
    ok = mel_err < 1e-3 and worst_gap <= 0.5 and lp_err <= 0.1
    print(f"[check] beam {BEAM}, card vs CPU fp32 plain path, 2 windows: card tokens trail the fp32 "
          f"{BEAM + 1}-th largest filtered logit by at most {worst_gap:.3f} (tol 0.5); |avg_logprob diff| "
          f"{lp_err:.4f} (tol 0.1) {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card's beam disagrees with the CPU reference")


# the CLI phases' long WAV (phases 12, 13, 18, 20, 22): two windows, so that
# the seek loop and words across a window boundary run; its file name is
# kept from when it was 70 s long
LONG_WAV_S = 40.0


def long_wav_frames() -> int:
    """The log-mel frames the CLI runs on the long WAV: LONG_WAV_S plus 30 s
    of padding, bucketed up to a whole number of 30 s windows."""
    return math.ceil((LONG_WAV_S + 30.0) / 30.0) * 3000


def write_long_wav(path: str, seconds: float, seed: int) -> None:
    """A seeded 16 kHz WAV: tones that change every 4-9 s, with 1-3 s of
    silence between them, plus a little noise."""
    import numpy as np

    rng = np.random.RandomState(seed)
    parts, total = [], 0
    while total < seconds * 16000:
        n = int(16000 * rng.uniform(4.0, 9.0))
        t = np.arange(n) / 16000
        f = rng.uniform(150, 2500, size=2)
        parts.append(0.3 * np.sin(2 * np.pi * f[0] * t) + 0.15 * np.sin(2 * np.pi * f[1] * t))
        parts.append(np.zeros(int(16000 * rng.uniform(1.0, 3.0))))
        total += parts[-2].size + parts[-1].size
    audio = np.concatenate(parts)[: int(seconds * 16000)]
    audio = audio + 0.005 * rng.randn(audio.size)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((np.clip(audio, -1, 1) * 32767).astype(np.int16).tobytes())


# phase 12's CLI runs take base's widths at this depth (its host-bound
# decode launches a sequence of kernels a layer); phases 13 and 15 keep
# base's 6 + 6 layers, whose alignment heads the `--model base` preset names
CLI_DEPTH = dict(n_audio_layer=2, n_text_layer=2)
CLI_PROMPT = "The patient reports a dry cough, a mild fever and shortness of breath since Tuesday morning."
CLI_RUNS = (
    ["--language", "en"],
    [],
    # every window's prefill holds the prompt (>= 16 tokens), so its causal
    # self-attention runs K7; without conditioning on the previous text the
    # prompt is exactly CLI_PROMPT, which fixes the shape phase 12 checks
    ["--language", "en", "--initial_prompt", CLI_PROMPT, "--carry_initial_prompt", "True",
     "--condition_on_previous_text", "False"],
)


def run_cli(card: str, model, workdir: str):
    """Phase 12: long-form transcription of a 40 s WAV through the CLI, in
    process, with its defaults: with --language en, detecting the language,
    and with a prompt carried into every window, at base's widths and
    CLI_DEPTH's layers; `model`'s checkpoint is written beside it for
    phases 13 and 15. Returns the summed launch counts and the prompted
    prefill's (bucket, self-cache length)."""
    import contextlib
    import dataclasses
    import io

    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask
    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.decode_steps import _bucket
    from asr_ttl_mtl_tpu_torch.models import checkpoint_dict, from_random
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    # the prompted windows' prefill, as `_greedy` and `dispatch_beam` size it
    task = DecodingTask(model, DecodingOptions(language="en", prompt=CLI_PROMPT))
    n_prompt = len(task.tokenizer.encode(" " + CLI_PROMPT.strip()))
    if n_prompt < 16:
        raise AssertionError(f"the prompt has {n_prompt} tokens, fewer than 16")
    bucket = _bucket(len(task.initial_tokens))
    cache_len = min(task.n_ctx, ((bucket + min(task.sample_len, task.n_ctx) + 127) // 128) * 128)

    ckpt, clip = os.path.join(workdir, "base_cli.pt"), os.path.join(workdir, "clip70.wav")
    torch.save(checkpoint_dict(model), os.path.join(workdir, "base.pt"))
    torch.save(checkpoint_dict(from_random(dataclasses.replace(model.dims, **CLI_DEPTH), seed=0, device=DEVICE,
                                           dtype=torch.bfloat16)), ckpt)
    torch.cuda.empty_cache()
    write_long_wav(clip, LONG_WAV_S, seed=0)
    total = {}
    for n, extra in enumerate(CLI_RUNS):
        out = os.path.join(workdir, f"cli{n}")
        printed = io.StringIO()
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli([clip, "--model", ckpt, "--output_dir", out, *extra])
        sync()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
        text = printed.getvalue()
        if "Skipping" in text:
            raise AssertionError(f"the CLI skipped the file:\n{text[-3000:]}")
        files = sorted(os.listdir(out))
        if files != [f"clip70.{ext}" for ext in ("json", "srt", "tsv", "txt", "vtt")]:
            raise AssertionError(f"the CLI wrote {files}")
        with open(os.path.join(out, "clip70.json")) as f:
            result = json.load(f)
        seeks = sorted({s["seek"] for s in result["segments"]})
        rungs = {s["seek"]: s["temperature"] for s in result["segments"]}
        if len(seeks) < 2:
            raise AssertionError(f"segments from {len(seeks)} window(s) only")
        needed = ("topk_logprobs", "log_mel", "flash_attention_h2", "decode_attention")
        if "--initial_prompt" in extra:
            needed += ("flash_attention",)
        for name in needed:
            if counts[name] <= 0:
                raise AssertionError(f"the CLI run launched no {name}: {counts}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        label = ' '.join(extra).replace(CLI_PROMPT, f"<{n_prompt} tokens>") or "language detected"
        print(f"[cli] {label}, base's widths at {CLI_DEPTH['n_audio_layer']} + {CLI_DEPTH['n_text_layer']} layers: "
              f"{wall:.1f} s wall for {LONG_WAV_S:.0f} s of audio; "
              f"language {result['language']}; {len(result['segments'])} segments from windows at seek "
              f"{seeks}; accepted rung's temperature per window {json.dumps(rungs)}; "
              f"{len(text.splitlines())} lines printed [{card}]", flush=True)
        print(f"[cli] launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    print(f"[cli] prompted prefill: {len(task.initial_tokens)} tokens in bucket {bucket}, self-cache {cache_len}",
          flush=True)
    return total, (bucket, cache_len)


def check_prefill_kernels(card: str, bucket: int, cache_len: int):
    """Phase 12, the CLI's prefill kernels against their plain versions at
    the shapes its runs gave them (one window a decode). K7 on the prompted
    prefill's causal self-attention: (8 | 40, bucket, 64) queries over the
    (8 | 40, cache_len, 64) self-cache (beam: 1 row x 8 heads; best-of: 5
    rows). K3 on the prefill's cross-attention over one window's (1, 1500,
    512): the best-of rows fold into the queries, 5 x bucket, and 5 x 8 in
    the unprompted runs (bucket 8; its self-attention stays plain)."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    rows = []
    record = make_recorder(card, rows)
    src = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    # keys past the last query are masked: the kernel reads the first
    # `bucket`, and the library call gets those alone, causal, in 4-D (SDPA's
    # fused kernels take no 3-D input)
    for n_rows, what in ((1, "beam"), (BEAM, "best-of")):
        bh = n_rows * 8
        q, k, v = rnd(bh, bucket, 64), rnd(bh, cache_len, 64), rnd(bh, cache_len, 64)
        kw = dict(causal=True, scale=0.125)
        want = FA.flash_attention_plain(q, k, v, **kw)
        record("flash_attention", f"causal prefill ({bh}, {bucket}, 64) x ({bh}, {cache_len}, 64), {what}", src,
               "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
               FA.flash_attention(q, k, v, **kw), want, 2.0**-6 * want.float().abs().max().item(),
               lambda: FA.flash_attention(q, k, v, **kw), lambda: FA.flash_attention_plain(q, k, v, **kw),
               bound=attn_bound(bh * bucket * (bucket + 1) // 2 * 64, (2 * q.numel() + 2 * bh * bucket * 64) * 2),
               library=lambda: F.scaled_dot_product_attention(q[None], k[None, :, :bucket], v[None, :, :bucket],
                                                              is_causal=True, scale=0.125), main=False, repeat=True)
    for tq, what in ((bucket, "beam, prompted"), (BEAM * bucket, "best-of, prompted"), (BEAM * 8, "best-of")):
        q, k, v = rnd(1, tq, 512), rnd(1, 1500, 512), rnd(1, 1500, 512)
        kw = dict(n_head=8, scale=0.125)
        want = FA.flash_attention_h2_plain(q, k, v, **kw)
        qh, kh, vh = heads(q, 8), heads(k, 8), heads(v, 8)
        record("flash_attention_h2", f"cross prefill (1, {tq}, 512) x (1, 1500, 512), {what}", src,
               "asr_ttl_mtl_tpu/ops/flash_attention.py:514",
               FA.flash_attention_h2(q, k, v, **kw), want, 2.0**-6 * want.float().abs().max().item(),
               lambda: FA.flash_attention_h2(q, k, v, **kw), lambda: FA.flash_attention_h2_plain(q, k, v, **kw),
               bound=attn_bound(tq * 1500 * 512, (2 * q.numel() + 2 * 1500 * 512) * 2),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=False)
    return rows


WORDS_RUNS = (
    ["--word_timestamps", "True"],
    ["--word_timestamps", "True", "--hallucination_silence_threshold", "2"],
)


class WordsProbe:
    """Wraps the words path's functions for one CLI run, calling through:
    counts the aligned windows, the calls of K11 and K13 at shapes that
    launch them (a window of under 8 frames leaves K11 nothing to filter),
    the K3 and K7 launches inside the alignment forward and the longest
    teacher-forced token row, and keeps the inputs K11 and K13 got (the
    largest and smallest that launch) and the first window's alignment
    weights on the card."""

    def __init__(self):
        from asr_ttl_mtl_tpu_torch import timing
        from asr_ttl_mtl_tpu_torch.ops import LAUNCHES
        from asr_ttl_mtl_tpu_torch.ops import dtw as dtw_ops

        self.windows, self.forward_launches, self.inputs, self.first = 0, {}, {}, None
        self.calls, self.longest = {"median_filter": 0, "dtw_trace": 0}, 0
        self.seconds = {"forward": 0.0, "pipeline": 0.0}  # host clock, each ending in a sync

        def clocked(key, fn, *args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            self.seconds[key] += time.perf_counter() - t0
            return out
        self.patched = []

        def patch(module, name, make):
            self.patched.append((module, name, getattr(module, name)))
            setattr(module, name, make(getattr(module, name)))

        def keep(kind, x):
            self.calls[kind] += 1
            held = self.inputs.setdefault(kind, {})
            for key, better in (("largest", lambda a, b: a.numel() > b.numel()),
                                ("smallest", lambda a, b: a.numel() < b.numel())):
                if key not in held or better(x, held[key]):
                    held[key] = x.detach().clone()

        def weights(fn):
            def run(model, tokens, *args, **kw):
                self.windows += 1
                self.longest = max(self.longest, len(tokens))
                before = dict(LAUNCHES)
                out = clocked("forward", fn, model, tokens, *args, **kw)
                for name in ("flash_attention_h2", "flash_attention"):
                    self.forward_launches[name] = self.forward_launches.get(name, 0) + LAUNCHES[name] - before[name]
                return out
            return run

        def path(fn):
            def run(w, *args):
                if self.first is None:
                    self.first = (w.detach().clone(), *args)
                return clocked("pipeline", fn, w, *args)
            return run

        def median(fn):
            def run(x, width):
                if x.shape[-1] > width // 2:
                    keep("median_filter", x)
                return fn(x, width)
            return run

        def trace(fn):
            def run(x):
                if min(x.shape) >= 1:
                    keep("dtw_trace", x)
                return fn(x)
            return run

        patch(timing, "alignment_weights", weights)
        patch(timing, "alignment_path", path)
        patch(timing, "median_filter_network", median)
        patch(dtw_ops, "dtw_trace", trace)

    def close(self):
        for module, name, original in reversed(self.patched):
            setattr(module, name, original)


def run_words_cli(card: str, workdir: str):
    """Phase 13: word timestamps through the CLI on phase 12's 40 s WAV,
    with `--model base --model_dir <workdir>` (so the preset's alignment
    heads are set), `--language en` and one rung of the ladder (with the
    hallucination threshold, random weights make every window re-seek about
    1 s on: six rungs would take ~10 minutes). Returns the summed launch
    counts and each run's probe."""
    import contextlib
    import io

    import numpy as np

    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    clip = os.path.join(workdir, "clip70.wav")
    total, probes = {}, []
    for n, extra in enumerate(WORDS_RUNS):
        out = os.path.join(workdir, f"words{n}")
        printed = io.StringIO()
        probe = WordsProbe()
        try:
            sync()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                cli([clip, "--model", "base", "--model_dir", workdir, "--output_dir", out, "--language", "en",
                     "--temperature_increment_on_fallback", "None", *extra])
            sync()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
        finally:
            probe.close()
        text = printed.getvalue()
        if "Skipping" in text:
            raise AssertionError(f"the CLI skipped the file:\n{text[-3000:]}")
        with open(os.path.join(out, "clip70.json")) as f:
            result = json.load(f)
        segments = result["segments"]
        words = [w for s in segments for w in s.get("words", [])]
        # a word whose tokens run on into the next segment (no space before
        # them) spends that segment's tokens, which may leave it an empty list
        if not all("words" in s for s in segments if s["text"].strip()):
            raise AssertionError("a segment with text carries no words")
        if not all(w["start"] <= w["end"] for w in words):
            raise AssertionError("a word ends before it starts")
        if n == 0 and not words:
            raise AssertionError("the words run timed no word")
        if (probe.windows < 1 or probe.calls["dtw_trace"] < 1
                or any(counts[k] != probe.calls[k] for k in ("median_filter", "dtw_trace"))):
            raise AssertionError(f"{probe.windows} aligned windows, calls {probe.calls}, launches {counts}")
        if probe.forward_launches.get("flash_attention_h2", 0) <= 0 or probe.forward_launches.get("flash_attention", 0) <= 0:
            raise AssertionError(f"the alignment forward launched {probe.forward_launches}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        seeks = sorted({s["seek"] for s in segments})
        print(f"[words] {' '.join(extra)}: {wall:.1f} s wall for {LONG_WAV_S:.0f} s of audio; {probe.windows} aligned windows "
              f"(the longest {probe.longest} tokens), K11 {counts['median_filter']} and K13 "
              f"{counts['dtw_trace']} launches; {len(segments)} segments "
              f"from windows at seek {seeks}, {len(words)} words, mean probability "
              f"{np.mean([w['probability'] for w in words]) if words else float('nan'):.4f}; alignment forward "
              f"{probe.seconds['forward']:.3f} s (launches {json.dumps(probe.forward_launches)}), standardize + "
              f"K11 + head mean + K13 + backtrace {probe.seconds['pipeline']:.3f} s [{card}]", flush=True)
        print(f"[words] launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
        probes.append(probe)
    return total, probes


def k13_step_ns() -> float:
    """The latency of one dependent step of K13's wavefront, ns: a one-warp
    loop of the recurrence (`dtw_chain_probe`), timed by CUDA events at
    200000 and 100000 steps and differenced, so that the launch cancels;
    the least of three."""
    import torch

    from asr_ttl_mtl_tpu_torch.ops import _cuda

    lib, out = _cuda.lib("dtw"), torch.empty(32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run_ms(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _cuda.check("dtw", "dtw_chain_probe", lib.dtw_chain_probe(out.data_ptr(), iters, stream))
        start.record()
        _cuda.check("dtw", "dtw_chain_probe", lib.dtw_chain_probe(out.data_ptr(), iters, stream))
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    return min((run_ms(200000) - run_ms(100000)) / 100000 * 1e6 for _ in range(3))


def check_words_kernels(card: str, probes):
    """Phase 14: K11 and K13 against their plain versions, exactly, at the
    largest and smallest inputs the words runs gave them, K11 also at width
    13 and at a seeded (8, 229, 1500), K13 also at a seeded (225, 1500),
    each on a second launch too and with its device time, K13's chain bound
    beside the bytes' bound; then one window's post-forward pipeline with
    the kernels and with the plain versions."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import timing
    from asr_ttl_mtl_tpu_torch.ops import dtw as DT
    from asr_ttl_mtl_tpu_torch.ops import median as MD

    rows = []
    record = make_recorder(card, rows)
    inputs = {}
    for kind in ("median_filter", "dtw_trace"):
        held = [x for probe in probes for x in probe.inputs[kind].values()]
        inputs[kind] = {"largest": max(held, key=torch.numel), "smallest": min(held, key=torch.numel)}
    rng = np.random.RandomState(229)
    x_tall = torch.from_numpy(rng.randn(8, 229, 1500).astype(np.float32)).cuda()
    x_tall[..., 750] = float("nan")  # a zero-variance column after the standardization
    k11_cases = [("largest of the words runs", inputs["median_filter"]["largest"], 7),
                 ("smallest of the words runs", inputs["median_filter"]["smallest"], 7),
                 ("largest of the words runs", inputs["median_filter"]["largest"], 13),
                 ("seeded, a window of 229 tokens", x_tall, 7), ("seeded, a window of 229 tokens", x_tall, 13)]
    for n, (where, x, width) in enumerate(k11_cases):
        record("median_filter", f"{where}: {tuple(x.shape)} fp32, width {width}",
               "asr_ttl_mtl_tpu_torch/csrc/median.cu", "asr_ttl_mtl_tpu/ops/pallas_median.py:25",
               MD.median_filter_network(x, width), MD.median_filter_network_plain(x, width), "exact",
               lambda x=x, width=width: MD.median_filter_network(x, width),
               lambda x=x, width=width: MD.median_filter_network_plain(x, width),
               bound=bound(3 * width * x.numel(), 2 * x.numel() * 4, "fp32"), main=n == 0, repeat=True)
    step_ns = k13_step_ns()
    print(f"[kernel] dtw_trace: one dependent step of the wavefront (shuffle, compares, selects, add) "
          f"{step_ns:.2f} ns on one warp [{card}]", flush=True)
    x_window = torch.from_numpy(np.random.RandomState(225).randn(225, 1500).astype(np.float32)).cuda()
    for key, x in (("largest", inputs["dtw_trace"]["largest"]), ("smallest", inputs["dtw_trace"]["smallest"]),
                   ("window", x_window)):
        n, m = x.shape
        where = "a seeded real window's shape" if key == "window" else f"{key} of the words runs"
        record("dtw_trace", f"{where}: ({n}, {m}) fp32, {n + m - 1} dependent diagonals, "
               f"(rows a lane, chunk, compute warps, helpers a warp, smem) {DT.k13_plan(n, m)}",
               "asr_ttl_mtl_tpu_torch/csrc/dtw.cu", "asr_ttl_mtl_tpu/ops/pallas_dtw.py:36",
               DT.dtw_trace(x), DT.dtw_trace_plain(x), "exact",
               lambda: DT.dtw_trace(x), lambda: DT.dtw_trace_plain(x),
               bound=bound(4 * n * m, n * m * 4 + (n + 1) * (m + 1), "fp32"), main=key == "largest", repeat=True,
               plain_iters=20 if key != "window" else 3)
        r = rows[-1]
        r["chain_bound_ms"] = (n + m - 1) * step_ns * 1e-6
        print(f"[kernel] dtw_trace {r['case']}: chain bound {r['chain_bound_ms']:.4f} ms (a diagnostic beside the "
              f"bytes' {r['bound_ms']:.4f}), device {r['device_ms']:.4f} ms [{card}]", flush=True)

    weights, *args = probes[0].first
    kernel_path = timing.alignment_path(weights, *args)
    median, trace = timing.median_filter_network, DT.dtw_trace
    timing.median_filter_network, DT.dtw_trace = MD.median_filter_network_plain, DT.dtw_trace_plain
    try:
        plain_path = timing.alignment_path(weights, *args)
    finally:
        timing.median_filter_network, DT.dtw_trace = median, trace
    same = all(np.array_equal(a, b) for a, b in zip(kernel_path, plain_path))
    print(f"[words] pipeline on one window's card weights {tuple(weights.shape)}: path of "
          f"{len(kernel_path[0])} steps with the kernels, {len(plain_path[0])} with the plain versions, "
          f"{'identical' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise AssertionError("the kernels' alignment path differs from the plain versions'")
    return rows


BATCH_SECONDS = (150, 150, 125, 120, 95, 70, 62, 45, 12)  # 32 windows at 30 s strides
BATCH_RUNS = (
    [],
    ["--word_timestamps", "True", "--language", "en", "--temperature_increment_on_fallback", "None"],
)


class BatchProbe:
    """Wraps the batched path's functions for one run, calling through: the
    decode batches (temperature, rows), the alignment chunks and their
    encoder calls and K3 launches, the windows with text, and the inputs K12
    got and the first chunk's forward outputs (on the card, cloned)."""

    def __init__(self):
        from asr_ttl_mtl_tpu_torch import timing
        from asr_ttl_mtl_tpu_torch import transcribe as T
        from asr_ttl_mtl_tpu_torch.decoding import DecodingTask
        from asr_ttl_mtl_tpu_torch.ops import LAUNCHES

        self.decodes, self.dispatches, self.forwards, self.aligned = [], [], [], []
        self.encoder_calls, self.forward_k3 = 0, 0
        self.patched = []

        def patch(owner, name, make):
            self.patched.append((owner, name, getattr(owner, name)))
            setattr(owner, name, make(getattr(owner, name)))

        def submit(fn):
            def run(task, mel, *args, **kw):
                self.decodes.append((task.options.temperature, int(mel.shape[0])))
                return fn(task, mel, *args, **kw)
            return run

        def align(fn):
            def run(model, tokenizer, token_lists, *args, **kw):
                self.aligned.append((tokenizer, [list(t) for t in token_lists], kw.get("batch_size")))
                return fn(model, tokenizer, token_lists, *args, **kw)
            return run

        def forward(fn):
            def run(*args, **kw):
                before = LAUNCHES["flash_attention_h2"]
                out = fn(*args, **kw)
                self.forward_k3 += LAUNCHES["flash_attention_h2"] - before
                self.forwards.append(tuple(o.detach().clone() for o in out) if not self.forwards else None)
                return out
            return run

        def encoder(fn):
            def run(*args, **kw):
                self.encoder_calls += 1
                return fn(*args, **kw)
            return run

        def dispatch(fn):
            def run(x, n, m):
                self.dispatches.append((x.detach().clone(), list(n), list(m)))
                return fn(x, n, m)
            return run

        patch(DecodingTask, "submit", submit)
        patch(T, "find_alignment_batch", align)
        patch(timing, "alignment_forward_batch", forward)
        patch(timing, "encoder_apply", encoder)
        patch(timing, "dtw_paths_dispatch", dispatch)

    def close(self):
        for owner, name, original in reversed(self.patched):
            setattr(owner, name, original)


def run_batch(card: str, model, workdir: str):
    """Phase 15: batched transcription at base. Runs (a) and (b) through the
    CLI on nine WAVs with phase 12's `base.pt` as `--model base --model_dir
    <workdir>`, (c) through `transcribe_batch` on the same waveforms with
    `model`. Returns the summed launch counts and run (b)'s probe."""
    import contextlib
    import io

    import numpy as np

    from asr_ttl_mtl_tpu_torch import load_audio, transcribe_batch
    from asr_ttl_mtl_tpu_torch import transcribe as T
    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    paths = []
    for n, seconds in enumerate(BATCH_SECONDS):
        paths.append(os.path.join(workdir, f"batch{n}.wav"))
        write_long_wav(paths[-1], float(seconds), seed=100 + n)
    waves = [load_audio(p) for p in paths]
    audio_s = sum(w.shape[-1] for w in waves) / 16000
    n_windows = T._decode_audios(waves)[1]
    if n_windows != 32:
        raise AssertionError(f"{n_windows} windows, not 32")
    total, probe_b = {}, None

    def report(label, wall, outs, probe, counts):
        rungs = sorted({round(float(t), 2) for t, _ in probe.decodes})
        segments = sum(len(o["segments"]) for o in outs)
        words = sum(len(s.get("words", [])) for o in outs for s in o["segments"])
        print(f"[batch] {label}: {wall:.1f} s wall for {audio_s:.1f} s of audio in {n_windows} windows = "
              f"{audio_s / wall:.1f} audio-s/s; {len(probe.decodes)} decode batches of "
              f"{sorted({b for _, b in probe.decodes})} rows at rungs {rungs}; languages "
              f"{sorted({o['language'] for o in outs})}; {segments} segments, {words} words [{card}]", flush=True)
        print(f"[batch] launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)

    for n, extra in enumerate(BATCH_RUNS):
        out = os.path.join(workdir, f"batch_out{n}")
        printed = io.StringIO()
        probe = BatchProbe()
        try:
            sync()
            reset_launch_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                cli([*paths, "--model", "base", "--model_dir", workdir, "--output_dir", out, "--batch_mode", "True",
                     *extra])
            sync()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
        finally:
            probe.close()
        text = printed.getvalue()
        if "failed" in text:
            raise AssertionError(f"the batch CLI failed:\n{text[-3000:]}")
        outs = []
        for p in paths:
            with open(os.path.join(out, os.path.basename(p)[:-4] + ".json")) as f:
                outs.append(json.load(f))
            if not outs[-1]["segments"]:
                raise AssertionError(f"no segments for {p}")
        needed = ("log_mel", "flash_attention_h2", "decode_attention", "topk_logprobs")
        if any(counts[k] <= 0 for k in needed) or counts["log_mel"] != len(paths):
            raise AssertionError(f"batch CLI run {n} launched {counts}")
        if "--word_timestamps" in extra:
            (tokenizer, token_lists, chunk), = probe.aligned
            with_text = sum(1 for t in token_lists if t)
            words = [w for o in outs for s in o["segments"] for w in s.get("words", [])]
            if (counts["dtw_paths_batch"] != -(-with_text // chunk) or len(probe.dispatches) != counts["dtw_paths_batch"]
                    or counts["dtw_trace"] or counts["median_filter"]):
                raise AssertionError(f"{with_text} windows with text in chunks of {chunk}: launches {counts}")
            if probe.encoder_calls or probe.forward_k3:
                raise AssertionError(f"the alignment forward ran its encoder: {probe.encoder_calls} calls, "
                                     f"{probe.forward_k3} K3 launches")
            if not words or not all("words" in s for o in outs for s in o["segments"]):
                raise AssertionError("the words run timed no word")
            print(f"[batch] alignment: {with_text} of {n_windows} windows with text, chunks of {chunk}, "
                  f"{len(probe.forwards)} forwards from the decode's features (encoder calls {probe.encoder_calls}, "
                  f"K3 launches {probe.forward_k3}), K12 at {[tuple(x.shape) for x, _, _ in probe.dispatches]}",
                  flush=True)
            probe_b = probe
        report(f"CLI --batch_mode {' '.join(extra) or '(defaults, language detected)'}", wall, outs, probe, counts)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    options = dict(language="en", fp16=True, kv_quant=True, int8_encoder=True, without_timestamps=True)
    probe = BatchProbe()
    try:
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = transcribe_batch(model, waves, batch_size=32, temperature=0.0, **options)
        sync()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    finally:
        probe.close()
    if not all(o["segments"] for o in outs) or probe.decodes != [(0.0, 32)]:
        raise AssertionError(f"transcribe_batch gave {[len(o['segments']) for o in outs]} segments, "
                             f"decodes {probe.decodes}")
    if any(counts[k] <= 0 for k in ("log_mel", "flash_attention_h2", "decode_attention_i8")):
        raise AssertionError(f"run c launched {counts}")
    lps = [s["avg_logprob"] for o in outs for s in o["segments"]]
    if not np.isfinite(lps).all():
        raise AssertionError("a segment's avg_logprob is not finite")
    report("transcribe_batch(batch_size=32, temperature=0.0, bf16, kv_quant, int8_encoder, without_timestamps)",
           wall, outs, probe, counts)
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total, probe_b, (waves, options, outs)


def k12_raw(x, n, m):
    """K12 alone on fixed buffers, for a CUDA graph: the wrapper's checks,
    allocations and host-to-device copy of n and m stay outside."""
    import torch

    from asr_ttl_mtl_tpu_torch.ops import _cuda
    from asr_ttl_mtl_tpu_torch.ops import dtw as DT

    b, n_max, m_max = x.shape
    dev = x.device
    nm = torch.tensor([list(n), list(m)], dtype=torch.int32, device=dev)
    ti = torch.empty((b, n_max + m_max), dtype=torch.int32, device=dev)
    tj, lens = torch.empty_like(ti), torch.empty(b, dtype=torch.int32, device=dev)
    trace = DT.k12_trace_scratch(b, n_max, m_max, dev)
    lib = _cuda.lib("dtw")

    def run():
        code = lib.dtw_paths_f32(x.data_ptr(), trace.data_ptr(), ti.data_ptr(), tj.data_ptr(), lens.data_ptr(),
                                 nm[0].data_ptr(), nm[1].data_ptr(), b, n_max, m_max, _cuda.stream_handle(dev))
        _cuda.check("dtw", "dtw_paths_f32", code)
    return run


def check_batch_kernels(card: str, probe):
    """Phase 16: K12 against its plain version, exactly, at the largest and
    smallest chunks of run (b), at the largest padded by repeating a row and
    at base's largest chunk, seeded (16, 444, 1500), each on a second launch
    too and with its device time, and with the chain bound of its longest
    row beside the bytes' bound; then one chunk's post-forward step with the
    kernel and with the plain version."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import timing
    from asr_ttl_mtl_tpu_torch.ops import dtw as DT
    from asr_ttl_mtl_tpu_torch.scripts.card_timing import graph_ms

    rows = []
    record = make_recorder(card, rows)
    largest = max(probe.dispatches, key=lambda d: d[0].numel())
    smallest = min(reversed(probe.dispatches), key=lambda d: d[0].numel())  # another chunk where sizes tie
    x, n, m = largest
    keep = max(1, x.shape[0] * 2 // 3)  # the last rows repeat row keep-1, as find_alignment_batch pads
    pad_rows = list(range(keep)) + [keep - 1] * (x.shape[0] - keep)
    padded = (x[pad_rows].clone(), [n[r] for r in pad_rows], [m[r] for r in pad_rows])
    rng = np.random.RandomState(444)
    ns, ms = rng.randint(2, 445, size=16).tolist(), rng.randint(1, 1501, size=16).tolist()
    ns[0], ms[0] = 444, 1500
    base_largest = (torch.from_numpy(rng.randn(16, 444, 1500).astype(np.float32)).cuda(), ns, ms)
    step_ns = k13_step_ns()
    cases = (("largest chunk of the batched words run", largest), ("smallest chunk of the batched words run", smallest),
             ("largest chunk padded", padded), ("base's largest chunk, seeded", base_largest))
    for key, (x, n, m) in cases:
        b, n_max, m_max = x.shape
        cells = sum(a * c for a, c in zip(n, m))
        steps = max(a + c for a, c in zip(n, m))
        record("dtw_paths_batch", f"{key}: ({b}, {n_max}, {m_max}) fp32, rows of {min(n)}-{max(n)} tokens x "
               f"{min(m)}-{max(m)} frames, up to {steps - 1} dependent diagonals + {steps} walk steps, (rows a "
               f"lane, chunk, compute warps, helpers a warp, threads, smem) {DT.k12_plan(n_max)}",
               "asr_ttl_mtl_tpu_torch/csrc/dtw.cu", "asr_ttl_mtl_tpu/ops/pallas_dtw.py:141",
               list(DT.dtw_paths_dispatch(x, n, m)), list(DT.dtw_paths_batch_plain(x, n, m)), ["exact"] * 3,
               lambda x=x, n=n, m=m: DT.dtw_paths_dispatch(x, n, m),
               lambda x=x, n=n, m=m: DT.dtw_paths_batch_plain(x, n, m),
               bound=bound(3 * cells, cells * 4 + 8 * b + 2 * b * (n_max + m_max) * 4 + 4 * b, "fp32"),
               main=key.startswith("largest chunk of"), plain_iters=1 if n_max > 100 else 2, repeat=True)
        r = rows[-1]
        r["device_ms"] = graph_ms(k12_raw(x, n, m))
        r["chain_bound_ms"] = (steps - 1) * step_ns * 1e-6
        # K13 on the chunk's longest row: the fill alone, on its own plan
        longest = max(range(len(n)), key=lambda i: n[i] + m[i])
        row = x[longest, : n[longest], : m[longest]].contiguous()
        r["k13_row_ms"] = graph_ms(lambda: DT.dtw_trace(row))
        print(f"[kernel] {r['name']} {key}: device time per call (CUDA graph of 10 calls, 5 replays) "
              f"{r['device_ms']:.4f} ms; the chain bound of its longest row ({n[longest]}, {m[longest]}), "
              f"{steps - 1} diagonals x {step_ns:.2f} ns, {r['chain_bound_ms']:.4f} ms (a diagnostic beside the "
              f"bytes' {r['bound_ms']:.4f}); K13 on that row {r['k13_row_ms']:.4f} ms [{card}]", flush=True)

    # the first chunk's post-forward step on its card matrices: K12's paths
    # and the plain version's give the same words
    (tokenizer, token_lists, chunk), = probe.aligned
    x, n, m = probe.dispatches[0]
    picked = probe.forwards[0][1].float().cpu().numpy()
    part = [i for i, t in enumerate(token_lists) if t][:chunk]
    sot = len(tokenizer.sot_sequence)

    def words(paths):
        return [[(w.word, w.tokens, w.start, w.end, w.probability) for w in timing._word_timings_from_path(
            tokenizer, token_lists[i], ti, tj, picked[r, sot : sot + len(token_lists[i])].tolist())]
            for r, (i, (ti, tj)) in enumerate(zip(part, paths))]

    with_kernel = words(DT.dtw_paths_collect(DT.dtw_paths_dispatch(x, n, m)))
    with_plain = words(DT.dtw_paths_collect(DT.dtw_paths_batch_plain(x, n, m)))
    same = with_kernel == with_plain
    print(f"[batch] post-forward step of the first chunk ({len(part)} windows, {sum(map(len, with_kernel))} words): "
          f"K12 and the plain version {'identical' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise AssertionError("the words from K12's paths differ from the plain version's")
    return rows


def run_int8_mlp(card: str, model, slice_rate: float):
    """Phase 17: K14 on the window path at the full width of `base`: phase
    4's options under `set_int8_mlp_kernel("auto")`, 3 batches through
    submit/collect with the launch counts reset just before and read just
    after (one K14 launch per encoder layer and pass), audio-s/s with the
    switch off and on in turns, one encoder pass timed both ways, and the
    greedy tokens of one batch against the switch-off run. Returns the
    launch counts."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    mel = log_mel_spectrogram(make_waves(N_WINDOWS, seed=0), device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**BASE_OPTIONS))
    n_layer = model.dims.n_audio_layer
    audio_s = N_WINDOWS * N_BATCHES * 30.0
    try:
        W.set_int8_mlp_kernel("auto")
        task.run(mel)  # warm-up, not counted
        sync()
        reset_launch_counts()
        results, t_dec, t_wait = pipeline(task, mel)
        counts = dict(LAUNCHES)
        on_tokens = [r.tokens for r in task.run(mel)]
    finally:
        W.set_int8_mlp_kernel("off")
    assert len(results) == N_WINDOWS * N_BATCHES
    for r in results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), (len(r.tokens), r.avg_logprob)
    if counts["int8_mlp"] != n_layer * N_BATCHES or counts["flash_attention_h2"] != n_layer * N_BATCHES:
        raise AssertionError(f"the K14 window path launched {counts}, expected {n_layer} K14 and K3 per pass")
    off_tokens = [r.tokens for r in task.run(mel)]
    same_windows = sum(a == b for a, b in zip(on_tokens, off_tokens))
    same_pos = np.mean([np.mean(np.array(a) == np.array(b)) for a, b in zip(on_tokens, off_tokens)])
    print(f"[int8_mlp] base, {N_BATCHES} batches x {N_WINDOWS} windows, phase 4's options with the K14 switch "
          f"on: decode {t_dec:.3f} s = {audio_s / t_dec:.1f} audio-s/s (phase 4: median {slice_rate:.1f}), of "
          f"which {t_wait * 1e3:.1f} ms in collect [{card}]", flush=True)
    print(f"[int8_mlp] launches {json.dumps({k: v for k, v in counts.items() if v})}; greedy tokens against "
          f"the switch off on the same batch: {same_windows}/{N_WINDOWS} windows identical, "
          f"{same_pos:.4f} of token positions equal", flush=True)
    turns = ("off", "auto", "auto", "off")
    label = {"off": "off", "auto": "on"}
    rates = []
    try:
        for mode in turns:
            W.set_int8_mlp_kernel(mode)
            rates.append(audio_s / pipeline(task, mel)[1])
        enc_ms = {}
        with torch.inference_mode():
            for mode in ("off", "auto"):
                W.set_int8_mlp_kernel(mode)
                enc_ms[mode] = timed_ms(lambda: W.encoder_apply(model.encoder, mel, torch.bfloat16,
                                                                int8_linears=True), iters=10, warmup=2)
    finally:
        W.set_int8_mlp_kernel("off")
    print(f"[int8_mlp] runs in the order they ran: "
          f"{', '.join(f'{label[m]} {r:.1f}' for m, r in zip(turns, rates))} "
          f"audio-s/s; one encoder pass of {N_WINDOWS} windows "
          f"(W8A8): switch off {enc_ms['off']:.3f} ms, on {enc_ms['auto']:.3f} ms [{card}]", flush=True)
    return counts


def check_int8_mlp(card: str, model, dtype=None):
    """Phase 17 (and 27 in fp16), K14 against its plain version at the
    window path's shape, (32 x 1536, 512) rows through base's first encoder
    MLP, bf16 (or `dtype`: fp16, the row counted as `int8_mlp_f16`). Both
    quantize the same values with the same divisions and roundings, so the
    first int8 intermediate must be equal; the GELU's tanhf may differ in
    its last bit, which can move a bf16 rounding and flip a second int8
    intermediate by one step. Tolerance per output: one activation step
    (|w2q| sg s2) for each flipped second intermediate of its row, plus
    one bf16 rounding (2^-7 |ref|; fp16 rounds finer) and fp32 noise."""
    import torch

    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.ops import int8_mlp as M

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    record = make_recorder(card, rows)
    fc1, fc2 = model.encoder.blocks[0].mlp[0], model.encoder.blocks[0].mlp[2]
    d, hidden = fc1.in_features, fc1.out_features
    w1q, s1 = W._quant_rowwise_sym(fc1.weight.float())
    w2q, s2 = W._quant_rowwise_sym(fc2.weight.float())
    n = N_WINDOWS * 1536
    dtype = dtype or torch.bfloat16
    name = "int8_mlp" if dtype == torch.bfloat16 else "int8_mlp_f16"
    x = torch.randn((n, d), generator=gen, device=dev).to(dtype)
    args = (x, w1q, s1.reshape(-1), fc1.bias.float(), w2q, s2.reshape(-1), fc2.bias.float())
    want, pqx, pqg, psg = M.int8_mlp_plain(*args, return_int8=True)
    got, qx, qg, sg = M.int8_mlp(*args, return_int8=True)
    sync()
    x_flips = (qx != pqx).float().mean().item()
    flips = (qg.int() - pqg.int()).abs()
    print(f"[{name}] int8 intermediates, kernel vs plain: first (x) {x_flips:.3e} differ, second (GELU) "
          f"{(flips > 0).float().mean().item():.3e} differ, by at most {flips.max().item()}; row scales of the "
          f"second, max relative difference {((sg - psg).abs() / psg).max().item():.3e}", flush=True)
    if x_flips != 0.0 or flips.max().item() > 1:
        raise AssertionError(f"{name}: the kernel's int8 intermediates differ from the plain version's")
    ref = want.float().abs()
    tol = (flips.float() @ w2q.float().abs().t()) * psg * s2.reshape(1, -1) + 2.0**-7 * ref + 1e-5 * ref.max()
    del flips, pqx, pqg, qx, qg
    with torch.inference_mode():
        unfused_ms = timed_ms(lambda: W.linear_i8(fc2, W.gelu(W.linear_i8(fc1, x))))
    print(f"[{name}] the unfused composition linear_i8(fc2, gelu(linear_i8(fc1, x))) at this shape: "
          f"{unfused_ms:.4f} ms [{card}]", flush=True)
    # bound: the two int8 products; bytes: the bf16 (fp16) rows in and
    # out, the int8 weights and the fp32 scales and biases, once each
    n_bytes = 2 * n * d * 2 + 2 * d * hidden + 2 * (d + hidden) * 4
    plan = M.k14_plan(n, d, hidden)
    record(name, f"x ({n}, {d}) {'bf16' if dtype == torch.bfloat16 else 'fp16'}, w1 ({hidden}, {d}) and w2 ({d}, {hidden}) int8, {plan.route} route, "
           f"cluster of {plan.cluster}, {plan.stages} stages",
           "asr_ttl_mtl_tpu_torch/csrc/int8_mlp.cu", "asr_ttl_mtl_tpu/ops/int8_mlp.py:46", got, want, tol,
           lambda: M.int8_mlp(*args), lambda: M.int8_mlp_plain(*args),
           bound=bound(4 * n * d * hidden, n_bytes, "int8"), repeat=True)
    rows[-1]["unfused_ms"] = unfused_ms
    return rows


# 9 heads of 64 at 2 + 2 layers: the depth is cut so that the whole run
# stays well inside its time limit (the CLI's decode is host-bound, a
# launch sequence a layer)
MH_DIMS = dict(n_mels=80, n_audio_ctx=1500, n_audio_state=576, n_audio_head=9, n_audio_layer=2, n_vocab=51865,
               n_text_ctx=448, n_text_state=576, n_text_head=9, n_text_layer=2)
MH_TRAIN_BATCH = 8


class ShapeProbe:
    """Wraps a kernel wrapper of ops/flash_attention.py for one run, calling
    through, and keeps the distinct call shapes (q, k, kv_valid_len, causal),
    of the calls in `dtype` alone if one is given."""

    def __init__(self, name: str, dtype=None):
        from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

        self.name, self.original, self.shapes = name, getattr(FA, name), set()

        def run(q, k, v, *args, **kw):
            if dtype is None or q.dtype == dtype:
                self.shapes.add((tuple(q.shape), tuple(k.shape), kw.get("kv_valid_len"), kw.get("causal", False)))
            return self.original(q, k, v, *args, **kw)

        setattr(FA, name, run)

    def close(self):
        from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

        setattr(FA, self.name, self.original)


def run_mh_cli(card: str, workdir: str):
    """Phase 18 (a): random weights from seed 0 at MH_DIMS (d 576, 9 heads:
    `h2_eligible` rejects it) written to a `.pt`, and phase 12's 40 s WAV
    transcribed through the CLI with word timestamps at one rung. K5 runs in
    the encoder (decode and alignment) and in the beam prefill's folded
    cross-attention (5 x 8 queries). Returns the launch counts and the
    shapes K5 got."""
    import contextlib
    import io

    import torch

    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, checkpoint_dict, from_random
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    ckpt, clip = os.path.join(workdir, "mh576.pt"), os.path.join(workdir, "clip70.wav")
    torch.save(checkpoint_dict(from_random(ModelDimensions(**MH_DIMS), seed=0, device=DEVICE,
                                           dtype=torch.bfloat16)), ckpt)
    torch.cuda.empty_cache()
    out = os.path.join(workdir, "mh_words")
    printed = io.StringIO()
    probe = ShapeProbe("flash_attention_mh")
    try:
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli([clip, "--model", ckpt, "--output_dir", out, "--language", "en",
                 "--temperature_increment_on_fallback", "None", "--word_timestamps", "True"])
        sync()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    finally:
        probe.close()
    text = printed.getvalue()
    if "Skipping" in text:
        raise AssertionError(f"the CLI skipped the file:\n{text[-3000:]}")
    files = sorted(os.listdir(out))
    if files != [f"clip70.{ext}" for ext in ("json", "srt", "tsv", "txt", "vtt")]:
        raise AssertionError(f"the CLI wrote {files}")
    with open(os.path.join(out, "clip70.json")) as f:
        segments = json.load(f)["segments"]
    words = [w for s in segments for w in s.get("words", [])]
    if not words or not all(w["start"] <= w["end"] for w in words):
        raise AssertionError(f"the words run gave {len(words)} words")
    for name in ("flash_attention_mh", "log_mel", "topk_logprobs", "decode_attention", "median_filter", "dtw_trace"):
        if counts[name] <= 0:
            raise AssertionError(f"the d=576 CLI run launched no {name}: {counts}")
    if counts["flash_attention_h2"] or counts["flash_attention_h2_lse"]:
        raise AssertionError(f"the d=576 CLI run launched K3, which h2_eligible rejects there: {counts}")
    print(f"[mh] CLI d=576 9 heads, --word_timestamps True at one rung: {wall:.1f} s wall for {LONG_WAV_S:.0f} s of audio; "
          f"{len(segments)} segments, {len(words)} words; K5 shapes (q, k, kv_valid_len) "
          f"{sorted((q, k, n) for q, k, n, _ in probe.shapes)} [{card}]", flush=True)
    print(f"[mh] launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    return counts, probe.shapes


def run_mh_training(card: str, workdir: str):
    """Phase 18 (b): 2 train steps of MultiTaskTrainer with MH_DIMS as
    `debug_dims`, batch 8, bf16. The non-causal attention (encoder and
    cross) runs K7 with lse and K8 over split heads there, the causal
    self-attention K7 with lse and K8 as at base. Returns the summed launch
    counts and the non-causal K7 shapes."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    cfg = TrainingConfig(model_size=MODEL, pretrained="random", debug_dims=MH_DIMS, batch_size=MH_TRAIN_BATCH,
                         val_batch_size=MH_TRAIN_BATCH, compute_dtype="bfloat16", learning_rate=1e-5, seed=0,
                         num_workers=4, epochs=1, save_dir=os.path.join(workdir, "mh_out"))
    ds = MultiTaskSpeechDataset(write_clips(workdir, 2 * MH_TRAIN_BATCH, seed=2), cfg)
    batches = list(DataLoader(ds, MH_TRAIN_BATCH, shuffle=True, num_workers=4, drop_last=True, seed=0,
                              buckets=cfg.token_buckets))[:2]
    trainer = MultiTaskTrainer(cfg, verbose=False)
    n_layer = MH_DIMS["n_audio_layer"]
    per_step = {"log_mel": 1, "flash_attention_lse": 3 * n_layer, "flash_attention_bwd": 3 * n_layer}
    total, losses, step_s = {}, [], []
    probe = ShapeProbe("flash_attention")
    try:
        for i, batch in enumerate(batches):
            sync()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss, _ = trainer.train_step(batch)
            sync()
            step_s.append(time.perf_counter() - t0)
            counts = dict(LAUNCHES)
            losses.append(float(loss))
            launched = {k: v for k, v in counts.items() if v}
            if launched != per_step:
                raise AssertionError(f"d=576 train step {i + 1} launched {launched}, expected {per_step}")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    finally:
        probe.close()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss: {losses}")
    shapes = {s for s in probe.shapes if not s[3]}
    if len(shapes) < 2:
        raise AssertionError(f"the d=576 train steps ran non-causal K7 at {shapes}")
    print(f"[mh] train d=576 9 heads, batch {MH_TRAIN_BATCH}, bf16, token buckets "
          f"{[b['input_tokens'].shape[1] for b in batches]}: 2 steps, losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"step s {', '.join(f'{x:.4f}' for x in step_s)} (the first has the set-up); launches per step "
          f"{json.dumps(per_step)} ({2 * n_layer} of each non-causal); non-causal K7 shapes (q, k, kv_valid_len) "
          f"{sorted((q, k, n) for q, k, n, _ in shapes)} [{card}]", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return total, shapes


def check_mh_kernels(card: str, cli_shapes, train_shapes):
    """Phase 19: K5 against its plain version at the path's encoder shape
    (32, 1536, 576), 9 heads, keys valid to 1500; at the shapes phase 18's
    CLI run gave it; and at head widths 8, 80 (route A), 768 (one head),
    136, 256 and 384 (route B) with an unaligned Tq and a masked key tail,
    the route B rows bitwise on a second launch. Each case names its
    `k5_plan`. Tolerance as K3's: p and the output
    round to bf16 at other places, 2^-6 of the largest output. Then K7 with
    lse and K8, non-causal, at the shapes phase 18's train steps gave them
    (as phase 8 holds them), each bitwise on a second launch; the encoder's
    self-attention shape is their row of the `kernels` line. The library
    call takes the valid keys alone, without a mask, as phase 8 times K3's."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    rows = []
    record = make_recorder(card, rows)
    src = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    def rel_tol(x):
        return 2.0**-6 * x.float().abs().max().item()

    cases = [(N_WINDOWS, 1536, 1536, 576, 9, 1500, "encoder", True)]
    cases += [(q[0], q[1], k[1], q[2], 9, n, "CLI", False) for q, k, n, _ in sorted(cli_shapes)]
    cases += [(2, 200, 300, 8 * 4, 4, 270, "dh 8", False), (2, 200, 300, 80 * 4, 4, 270, "dh 80", False),
              (2, 200, 300, 768, 1, 270, "dh 768", False), (2, 200, 300, 136 * 2, 2, 270, "dh 136", False),
              (2, 200, 300, 256 * 3, 3, 270, "dh 256", False), (2, 200, 300, 384 * 2, 2, 270, "dh 384", False)]
    for b, tq, tk, d, n_head, kv_len, what, main in cases:
        q, k, v = rnd(b, tq, d), rnd(b, tk, d), rnd(b, tk, d)
        dh = d // n_head
        n_keys = kv_len or tk
        kw = dict(n_head=n_head, kv_valid_len=kv_len, scale=dh**-0.5)
        want = FA.flash_attention_mh_plain(q, k, v, **kw)
        qh, kh, vh = heads(q, n_head), heads(k, n_head, n_keys), heads(v, n_head, n_keys)
        record("flash_attention_mh", f"{what}: q ({b}, {tq}, {d}), k ({b}, {tk}, {d}) bf16, {n_head} heads of {dh}"
               f", kv_valid_len {kv_len}, {k5_route(dh, tq)}", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:346",
               FA.flash_attention_mh(q, k, v, **kw), want, rel_tol(want),
               lambda: FA.flash_attention_mh(q, k, v, **kw), lambda: FA.flash_attention_mh_plain(q, k, v, **kw),
               bound=attn_bound(b * tq * n_keys * d, (2 * q.numel() + 2 * b * n_keys * d) * 2),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=dh**-0.5), main=main,
               repeat=dh > 128)
        del q, k, v, want, qh, kh, vh

    # K7 with lse and K8, non-causal over split heads (B x 9, T, 64)
    for q_shape, k_shape, kv_len, _ in sorted(train_shapes):
        bh, tq, _ = q_shape
        tk = k_shape[1]
        n_keys = kv_len or tk
        q, k, v, g = rnd(bh, tq, 64), rnd(bh, tk, 64), rnd(bh, tk, 64), rnd(bh, tq, 64)
        kw = dict(kv_valid_len=kv_len, scale=0.125)
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        io = (2 * q.numel() + 2 * bh * n_keys * 64) * 2
        # the library call over the valid keys alone, without a mask (as phase 8 times K3's), in 4-D
        ql, kl, vl = (x[None].detach().requires_grad_(True) for x in (q, k[:, :n_keys], v[:, :n_keys]))
        # the encoder's self-attention, where K7 and K8 lose the most, is a row of the kernels line
        main = tq == tk
        case = f"non-causal ({bh}, {tq}, 64) x ({bh}, {tk}, 64), kv_valid_len {kv_len} (d=576 train step)"
        record("flash_attention_lse", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
               [out, lse], [pout, plse], [rel_tol(pout), 1e-4],
               lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
               lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
               bound=attn_bound(bh * tq * n_keys * 64, io + lse.numel() * 4),
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125), main=main, repeat=True)
        got = list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
        want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=0.125)
        record("flash_attention_bwd", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030",
               got, want, [rel_tol(w) for w in want],
               lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
               lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
               bound=attn_bound(bh * tq * n_keys * 64, 2 * io + 2 * lse.numel() * 4, mults=10),
               library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g[None], retain_graph=True), main=main,
               repeat=True)
        del q, k, v, g, out, lse, pout, plse, got, want, lib_out, ql, kl, vl
    return rows


# ------------------------------------------------------------------ phase 20

FP32_REL = 2e-5  # an fp32 kernel against its plain version, a share of the largest output: sum order only
# the fp32 gates: float caches and float linears, so that no int8 rounding
# midpoint, which fp32 sum order moves, stands between card and CPU
FP32_GATE_OPTIONS = dict(BASE_OPTIONS, fp16=False, kv_quant=False, int8_encoder=False)
FP32_LOGIT_TOL = 5e-3  # 100x tighter than the bf16 decode gate's 0.5
FP32_TRAIN_TOL = 2e-4  # 100x tighter than the bf16 train gate's 2%
BF16_KERNELS = ("decode_attention", "decode_attention_i8", "flash_attention_h2", "flash_attention_h2_lse",
                "flash_attention_h2_bwd", "flash_attention_mh", "flash_attention", "flash_attention_lse",
                "flash_attention_bwd", "int8_mlp")


def no_bf16_kernel(counts: dict, what: str) -> None:
    """An fp32 run launches no bf16 K1, K2, flash or K14 kernel."""
    launched = {k: counts[k] for k in BF16_KERNELS if counts[k]}
    if launched:
        raise AssertionError(f"{what} launched bf16 kernels: {launched}")


def run_fp32_slice(card: str, slice_rate: float):
    """Phase 20 (a): phase 4's window path with fp16=False (fp32 compute on
    base's random weights, kv_quant and the W8A8 encoder), 3 batches of 32
    windows with the launch counts reset before and read after, then the
    same under `set_int8_mlp_kernel("auto")`; then an fp32 model from
    `load_model(..., compute_dtype=torch.float32)` at MH_DIMS (d 576, 9
    heads), one batch of 8 windows, whose encoder runs K5 at fp32. Returns
    the summed launch counts and the shapes K5 got."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, from_random, load_model, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, checkpoint_dict
    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    n_layer = model.dims.n_audio_layer
    mel = log_mel_spectrogram(make_waves(N_WINDOWS, seed=0), device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**{**BASE_OPTIONS, "fp16": False}))
    if task.compute_dtype != torch.float32:
        raise AssertionError(f"fp16=False computes in {task.compute_dtype}")
    audio_s = N_WINDOWS * N_BATCHES * 30.0
    total = {}
    try:
        for mode in ("off", "auto"):
            W.set_int8_mlp_kernel(mode)
            task.run(mel)  # warm-up, not counted
            sync()
            reset_launch_counts()
            results, t_dec, t_wait = pipeline(task, mel)
            counts = dict(LAUNCHES)
            assert len(results) == N_WINDOWS * N_BATCHES
            for r in results:
                assert len(r.tokens) == BASE_OPTIONS["sample_len"] and np.isfinite(r.avg_logprob), (len(r.tokens), r.avg_logprob)
            want = {"flash_attention_h2_f32": n_layer * N_BATCHES, "int8_mlp_f32": n_layer * N_BATCHES * (mode == "auto")}
            if any(counts[k] != n for k, n in want.items()) or counts["decode_attention_i8_f32"] <= 0:
                raise AssertionError(f"the fp32 window path (K14 switch {mode}) launched {counts}, expected {want}")
            no_bf16_kernel(counts, f"the fp32 window path (K14 switch {mode})")
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            print(f"[fp32] base, {N_BATCHES} batches x {N_WINDOWS} windows, fp16=False, kv_quant + int8_encoder, "
                  f"K14 switch {mode}: decode {t_dec:.3f} s = {audio_s / t_dec:.1f} audio-s/s (phase 4, bf16: median "
                  f"{slice_rate:.1f}), of which {t_wait * 1e3:.1f} ms in collect; text[0]={results[0].text[:40]!r} "
                  f"[{card}]", flush=True)
            print(f"[fp32] launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    finally:
        W.set_int8_mlp_kernel("off")
    del task, model
    torch.cuda.empty_cache()

    dims = ModelDimensions(**MH_DIMS)
    m576 = load_model(checkpoint_dict(from_random(dims, seed=0, device=DEVICE)), device=DEVICE,
                      compute_dtype=torch.float32)
    task = DecodingTask(m576, DecodingOptions(**BASE_OPTIONS))  # fp16=True: the model's fp32
    if task.compute_dtype != torch.float32:
        raise AssertionError(f"an fp32 model computes in {task.compute_dtype}")
    mel8 = mel[:8].contiguous()
    task.run(mel8)  # warm-up, not counted
    probe = ShapeProbe("flash_attention_mh", torch.float32)
    try:
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        results = task.run(mel8)
        sync()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    finally:
        probe.close()
    for r in results:
        assert len(r.tokens) == BASE_OPTIONS["sample_len"] and np.isfinite(r.avg_logprob), (len(r.tokens), r.avg_logprob)
    if counts["flash_attention_mh_f32"] != dims.n_audio_layer or counts["decode_attention_i8_f32"] <= 0:
        raise AssertionError(f"the fp32 d=576 window path launched {counts}")
    no_bf16_kernel(counts, "the fp32 d=576 window path")
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    print(f"[fp32] d=576 9 heads, an fp32 model from load_model(compute_dtype=float32), 1 batch x 8 windows: "
          f"{wall:.3f} s = {8 * 30.0 / wall:.1f} audio-s/s; K5 shapes {sorted(probe.shapes)}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    del task, m576
    torch.cuda.empty_cache()
    return total, probe.shapes


def run_fp32_cli(card: str, model, workdir: str):
    """Phase 20 (b): phase 12's 40 s WAV through the CLI with `--fp16 False
    --word_timestamps True` at one rung, `--model base --model_dir` (base's
    alignment heads) and the 19-token prompt carried into every window: the
    beam decode and its prompted prefill (K7) in fp32; the alignment forward
    runs in the model's dtype (bf16), as in the JAX package. Returns the
    launch counts and the shapes of the fp32 K7 calls."""
    import contextlib
    import io

    import torch

    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.models import checkpoint_dict
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    torch.save(checkpoint_dict(model), os.path.join(workdir, f"{MODEL}.pt"))
    clip = os.path.join(workdir, "clip70.wav")
    write_long_wav(clip, LONG_WAV_S, seed=0)
    out = os.path.join(workdir, "fp32_words")
    printed = io.StringIO()
    probe = ShapeProbe("flash_attention", torch.float32)
    try:
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli([clip, "--model", MODEL, "--model_dir", workdir, "--device", DEVICE, "--output_dir", out,
                 "--language", "en", "--fp16", "False", "--word_timestamps", "True", "--temperature_increment_on_fallback", "None",
                 "--initial_prompt", CLI_PROMPT, "--carry_initial_prompt", "True",
                 "--condition_on_previous_text", "False"])
        sync()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    finally:
        probe.close()
    text = printed.getvalue()
    if "Skipping" in text:
        raise AssertionError(f"the CLI skipped the file:\n{text[-3000:]}")
    files = sorted(os.listdir(out))
    if files != [f"clip70.{ext}" for ext in ("json", "srt", "tsv", "txt", "vtt")]:
        raise AssertionError(f"the CLI wrote {files}")
    with open(os.path.join(out, "clip70.json")) as f:
        segments = json.load(f)["segments"]
    words = [w for s in segments for w in s.get("words", [])]
    if not words or not all(w["start"] <= w["end"] for w in words):
        raise AssertionError(f"the fp32 words run gave {len(words)} words")
    for name in ("flash_attention_h2_f32", "flash_attention_f32", "topk_logprobs", "decode_attention_f32", "log_mel",
                 "median_filter", "dtw_trace"):
        if counts[name] <= 0:
            raise AssertionError(f"the fp32 CLI run launched no {name}: {counts}")
    if counts["decode_attention"] or counts["decode_attention_i8"]:
        raise AssertionError(f"the fp32 CLI run's decode launched bf16 K1 / K2: {counts}")
    print(f"[fp32] CLI --fp16 False --word_timestamps True, the 19-token prompt, one rung: {wall:.1f} s wall for "
          f"{LONG_WAV_S:.0f} s of audio; {len(segments)} segments, {len(words)} words; fp32 K7 shapes (q, k, kv_valid_len, causal) "
          f"{sorted(probe.shapes)} [{card}]", flush=True)
    print(f"[fp32] launches {json.dumps({k: v for k, v in counts.items() if v})} (the bf16 flash launches are the "
          f"alignment forward's, in the model's dtype)", flush=True)
    return counts, probe.shapes


def check_fp32_kernels(card: str, train_buckets, val_buckets, cli_k7_shapes, k5_shapes, model):
    """Phase 20 (d): each fp32 kernel against its plain version at the
    shapes phase 20's runs gave it, plus the d=576 encoder's K5 at (1, 1536,
    576) and K7-lse/K8 at (72, 1536, 64) over 1536 keys valid to 1500, each
    within FP32_REL of its largest output per output (out, lse, dq, dk, dv)
    and bitwise on a second launch. Timed beside SDPA at fp32 on 4-D views
    (its backward for K6 and K8), the bound at 495 / 3 TFLOP/s (3xTF32 on
    the tensor cores) and the FFMA bound at 67 TFLOP/s. K14 at fp32:
    the first int8 intermediate exact, the second only at rounding
    midpoints of g / sg, each output within one activation step per flip."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA
    from asr_ttl_mtl_tpu_torch.ops import int8_mlp as M

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(6)
    rows = []
    record = make_recorder(card, rows)
    src = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def tol(x):
        return FP32_REL * x.abs().max().item()

    def fbounds(macs, n_bytes, mults=4):
        """The bound on the tensor cores in 3xTF32 and, beside it, on the CUDA cores (FFMA)."""
        return dict(bound=attn_bound(macs, n_bytes, mults, "3xtf32"),
                    ffma_bound=attn_bound(macs, n_bytes, mults, "fp32"))

    main_t, main_v = train_buckets[0], val_buckets[0]
    # K3: the window path's encoder (32, 1536, 512), keys valid to 1500; evaluate's cross
    for b, tq, tk, kv, what, main in [(N_WINDOWS, 1536, 1536, 1500, "encoder, the fp32 window path", True),
                                      (TRAIN_BATCH, main_v, 1500, None, "cross, evaluate's token bucket", False)]:
        q, k, v = rnd(b, tq, 512), rnd(b, tk, 512), rnd(b, tk, 512)
        n_keys = kv or tk
        kw = dict(n_head=8, kv_valid_len=kv, scale=0.125)
        want = FA.flash_attention_h2_plain(q, k, v, **kw)
        qh, kh, vh = heads(q, 8), heads(k, 8, n_keys), heads(v, 8, n_keys)
        record("flash_attention_h2_f32", f"{what}: q ({b}, {tq}, 512), k ({b}, {tk}, 512) fp32, kv_valid_len {kv}",
               src, "asr_ttl_mtl_tpu/ops/flash_attention.py:514", FA.flash_attention_h2(q, k, v, **kw), want,
               tol(want), lambda: FA.flash_attention_h2(q, k, v, **kw),
               lambda: FA.flash_attention_h2_plain(q, k, v, **kw),
               **fbounds(b * tq * n_keys * 512, (2 * q.numel() + 2 * b * n_keys * 512) * 4),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=main, repeat=True)
        del q, k, v, want, qh, kh, vh

    # K3 with lse and K6: the train step's encoder (16, 1536, 512) and cross at its token bucket
    for b, tq, tk, kv, what, main in [(TRAIN_BATCH, 1536, 1536, 1500, "encoder, the fp32 train step", True),
                                      (TRAIN_BATCH, main_t, 1500, None, "cross, the train step's token bucket", False)]:
        q, k, v, g = rnd(b, tq, 512), rnd(b, tk, 512), rnd(b, tk, 512), rnd(b, tq, 512)
        n_keys = kv or tk
        kw = dict(n_head=8, kv_valid_len=kv, scale=0.125)
        case = f"{what}: q ({b}, {tq}, 512), k ({b}, {tk}, 512) fp32, kv_valid_len {kv}"
        out, lse = FA.flash_attention_h2(q, k, v, return_lse=True, **kw)
        pout, plse = FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
        io = (2 * q.numel() + 2 * b * n_keys * 512) * 4
        qh = heads(q, 8).detach().requires_grad_(True)
        kh, vh = (heads(x, 8, n_keys).detach().requires_grad_(True) for x in (k, v))
        record("flash_attention_h2_lse_f32", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:552",
               [out, lse], [pout, plse], [tol(pout), tol(plse)],
               lambda: FA.flash_attention_h2(q, k, v, return_lse=True, **kw),
               lambda: FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw),
               **fbounds(b * tq * n_keys * 512, io + lse.numel() * 4),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=main, repeat=True)
        delta = FA.h2_delta(g, pout, 8)
        got = list(FA.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw))
        want = list(FA.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw))
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=0.125)
        gh = heads(g, 8)
        record("flash_attention_h2_bwd_f32", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:651,691",
               got, want, [tol(w) for w in want],
               lambda: FA.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw),
               lambda: FA.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw),
               **fbounds(b * tq * n_keys * 512, 2 * io + 2 * lse.numel() * 4, mults=10),
               library=lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True), main=main,
               repeat=True)
        del q, k, v, g, out, lse, pout, plse, delta, got, want, lib_out, qh, kh, vh

    # K7 with lse and K8 at the train step's causal (128, bucket, 64), K7 at evaluate's
    for t in sorted({main_t, main_v}):
        q, k, v, g = rnd(128, t, 64), rnd(128, t, 64), rnd(128, t, 64), rnd(128, t, 64)
        kw = dict(causal=True, scale=0.125)
        io = 4 * q.numel() * 4  # q, k, v in, out written
        pairs = t * (t + 1) // 2
        ql, kl, vl = (x[None].detach().requires_grad_(True) for x in (q, k, v))
        case = f"causal (128, {t}, 64) fp32, the token bucket"
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        if t == main_v:
            record("flash_attention_f32", case + " (evaluate)", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
                   FA.flash_attention(q, k, v, **kw), pout, tol(pout), lambda: FA.flash_attention(q, k, v, **kw),
                   lambda: FA.flash_attention_plain(q, k, v, **kw), **fbounds(128 * pairs * 64, io),
                   library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, is_causal=True),
                   main=True, repeat=True)
        if t == main_t:
            record("flash_attention_lse_f32", case + " (train)", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
                   [out, lse], [pout, plse], [tol(pout), tol(plse)],
                   lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
                   lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
                   **fbounds(128 * pairs * 64, io + lse.numel() * 4),
                   library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, is_causal=True),
                   main=True, repeat=True)
            got = list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
            want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=0.125, is_causal=True)
            record("flash_attention_bwd_f32", case + " (train)", src,
                   "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030", got, want, [tol(w) for w in want],
                   lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
                   lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
                   **fbounds(128 * pairs * 64, 2 * io + 2 * lse.numel() * 4, mults=10),
                   library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g[None], retain_graph=True),
                   main=True, repeat=True)
        del q, k, v, g, out, lse, pout, plse, ql, kl, vl

    # K7 at the CLI's prompted prefills: causal queries over the self-cache
    for q_shape, k_shape, kv, causal in sorted(cli_k7_shapes):
        bh, tq, _ = q_shape
        tk = k_shape[1]
        q, k, v = rnd(bh, tq, 64), rnd(bh, tk, 64), rnd(bh, tk, 64)
        kw = dict(causal=causal, kv_valid_len=kv, scale=0.125)
        want = FA.flash_attention_plain(q, k, v, **kw)
        seen = min(tq, kv or tk) if causal else (kv or tk)
        record("flash_attention_f32", f"the CLI's prompted prefill, causal {causal}: ({bh}, {tq}, 64) x ({bh}, {tk}, "
               f"64) fp32", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
               FA.flash_attention(q, k, v, **kw), want, tol(want), lambda: FA.flash_attention(q, k, v, **kw),
               lambda: FA.flash_attention_plain(q, k, v, **kw),
               **fbounds(bh * tq * (tq + 1) // 2 * 64, (2 * q.numel() + 2 * bh * seen * 64) * 4),
               library=lambda: F.scaled_dot_product_attention(q[None], k[None, :, :seen], v[None, :, :seen],
                                                              is_causal=causal, scale=0.125),
               main=False, repeat=True)
        del q, k, v, want

    # K5 at the d=576 window path's shapes and the one-window (1, 1536, 576)
    cases = [(q[0], q[1], k[1], n, True) for q, k, n, _ in sorted(k5_shapes)] + [(1, 1536, 1536, 1500, False)]
    for b, tq, tk, kv, main in cases:
        q, k, v = rnd(b, tq, 576), rnd(b, tk, 576), rnd(b, tk, 576)
        n_keys = kv or tk
        kw = dict(n_head=9, kv_valid_len=kv, scale=0.125)
        want = FA.flash_attention_mh_plain(q, k, v, **kw)
        qh, kh, vh = heads(q, 9), heads(k, 9, n_keys), heads(v, 9, n_keys)
        record("flash_attention_mh_f32", f"d=576 encoder: q ({b}, {tq}, 576), k ({b}, {tk}, 576) fp32, 9 heads of "
               f"64, kv_valid_len {kv}", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:346",
               FA.flash_attention_mh(q, k, v, **kw), want, tol(want), lambda: FA.flash_attention_mh(q, k, v, **kw),
               lambda: FA.flash_attention_mh_plain(q, k, v, **kw),
               **fbounds(b * tq * n_keys * 576, (2 * q.numel() + 2 * b * n_keys * 576) * 4),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), main=main, repeat=True)
        del q, k, v, want, qh, kh, vh

    # K7 with lse and K8, non-causal, at the d=576 train step's encoder (8 x 9, 1536, 64), keys valid to 1500
    bh = MH_TRAIN_BATCH * 9
    q, k, v, g = rnd(bh, 1536, 64), rnd(bh, 1536, 64), rnd(bh, 1536, 64), rnd(bh, 1536, 64)
    kw = dict(kv_valid_len=1500, scale=0.125)
    out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
    pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
    io = (2 * q.numel() + 2 * bh * 1500 * 64) * 4
    ql, kl, vl = (x[None].detach().requires_grad_(True) for x in (q, k[:, :1500], v[:, :1500]))
    case = f"non-causal ({bh}, 1536, 64) x ({bh}, 1536, 64) fp32, kv_valid_len 1500 (the d=576 encoder)"
    record("flash_attention_lse_f32", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
           [out, lse], [pout, plse], [tol(pout), tol(plse)],
           lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
           lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
           **fbounds(bh * 1536 * 1500 * 64, io + lse.numel() * 4),
           library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=0.125), main=False, repeat=True)
    got = list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
    want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=0.125)
    record("flash_attention_bwd_f32", case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030",
           got, want, [tol(w) for w in want],
           lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
           lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
           **fbounds(bh * 1536 * 1500 * 64, 2 * io + 2 * lse.numel() * 4, mults=10),
           library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g[None], retain_graph=True), main=False,
           repeat=True)
    del q, k, v, g, out, lse, pout, plse, got, want, lib_out, ql, kl, vl

    # K2 at fp32: the fp32 words CLI's beam step, q (5, 1, 512) over one
    # window's (6, 1, 1500, 512) fp32 cross cache, group 5
    qf = rnd(BEAM, 1, 512)
    ck, cv = rnd(6, 1, 1500, 512), rnd(6, 1, 1500, 512)
    kw = dict(scale=0.125, group=BEAM)
    want = DA.decode_attention_plain(qf, ck, cv, 5, 8, **kw)
    qh = qf.reshape(1, BEAM, 8, 64).transpose(1, 2)
    kh, vh = heads(ck[5], 8), heads(cv[5], 8)
    record("decode_attention_f32", f"the fp32 CLI's beam step: q ({BEAM}, 1, 512) over one window's (6, 1, 1500, "
           f"512) fp32 cross cache, group {BEAM}", "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu",
           "asr_ttl_mtl_tpu/ops/decode_attention.py:39", DA.decode_attention(qf, ck, cv, 5, 8, **kw), want,
           tol(want), lambda: DA.decode_attention(qf, ck, cv, 5, 8, **kw),
           lambda: DA.decode_attention_plain(qf, ck, cv, 5, 8, **kw),
           bound=attn_bound(BEAM * 1500 * 512, (qf.numel() * 2 + 2 * 1500 * 512) * 4, kind="fp32"),
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), repeat=True)
    del qf, ck, cv, want, qh, kh, vh

    # K1 with fp32 queries: the fp32 window path's cross, q (32, 1, 512) over
    # the int8 store (6, 32, 1536, 512) valid to 1499; the flip bound of the
    # plain version and fp32 noise (no bf16 rounding of the output)
    qf = rnd(N_WINDOWS, 1, 512)
    k8, ks = DA.quantize_kv_rows(rnd(6, N_WINDOWS, 1536, 512))
    v8, vs = DA.quantize_kv_rows(rnd(6, N_WINDOWS, 1536, 512))
    kw = dict(scale=0.125, valid_upto=1499)
    want, flip = DA.decode_attention_i8_plain(qf, k8, ks, v8, vs, 5, 8, return_flip_bound=True, **kw)
    tk_blk = DA._i8_blocks(N_WINDOWS, 1536, 512)[1]
    record("decode_attention_i8_f32", f"the fp32 window path's cross: q ({N_WINDOWS}, 1, 512) fp32 over "
           f"(6, {N_WINDOWS}, 1536, 512) int8, valid_upto 1499, tk_blk {tk_blk}",
           "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu", "asr_ttl_mtl_tpu/ops/decode_attention.py:186",
           DA.decode_attention_i8(qf, k8, ks, v8, vs, 5, 8, **kw), want, flip + tol(want),
           lambda: DA.decode_attention_i8(qf, k8, ks, v8, vs, 5, 8, **kw),
           lambda: DA.decode_attention_i8_plain(qf, k8, ks, v8, vs, 5, 8, **kw),
           bound=bound(4 * N_WINDOWS * 1500 * 512, 2 * N_WINDOWS * 1500 * (512 + 4) + 2 * qf.numel() * 4, "int8"),
           repeat=True)
    del qf, k8, ks, v8, vs, want, flip

    # K14 at fp32 through base's first encoder MLP at the window path's (32 x 1536, 512) rows
    fc1, fc2 = model.encoder.blocks[0].mlp[0], model.encoder.blocks[0].mlp[2]
    d, hidden = fc1.in_features, fc1.out_features
    w1q, s1 = W._quant_rowwise_sym(fc1.weight.float())
    w2q, s2 = W._quant_rowwise_sym(fc2.weight.float())
    n = N_WINDOWS * 1536
    x = rnd(n, d)
    args = (x, w1q, s1.reshape(-1), fc1.bias.float(), w2q, s2.reshape(-1), fc2.bias.float())
    want, pqx, pqg, psg = M.int8_mlp_plain(*args, return_int8=True)
    got, qx, qg, sg = M.int8_mlp(*args, return_int8=True)
    sync()
    flips = (qg.int() - pqg.int()).abs()
    # the plain version's g / sg where the second intermediate flipped: a flip
    # is a GELU value whose last bits (tanhf's) move it across a rounding midpoint
    sx = W.int8_step(x.abs().amax(-1, keepdim=True), 1e-30)
    f1 = torch._int_mm(pqx, w1q.t()).float() * (sx * s1.reshape(1, -1)) + fc1.bias.float()
    ratio = F.gelu(f1, approximate="tanh") / psg
    off_mid = (ratio.abs().frac() - 0.5).abs()[flips > 0]
    worst_mid = off_mid.max().item() if off_mid.numel() else 0.0
    share = (flips > 0).float().mean().item()
    print(f"[fp32] K14 int8 intermediates, kernel vs plain: first (x) {(qx != pqx).float().mean().item():.3e} "
          f"differ; second (GELU) {share:.3e} differ ({int((flips > 0).sum())} of {flips.numel()}), by at most "
          f"{flips.max().item()}, each within {worst_mid:.2e} of a rounding midpoint of g / sg (tol 1e-4); row scales "
          f"of the second, max relative difference {((sg - psg).abs() / psg).max().item():.3e}", flush=True)
    if not torch.equal(qx, pqx) or flips.max().item() > 1 or worst_mid > 1e-4:
        raise AssertionError("int8_mlp fp32: the int8 intermediates differ from the plain version's beyond midpoints")
    ref = want.abs()
    tol14 = (flips.float() @ w2q.float().abs().t()) * psg * s2.reshape(1, -1) + 2e-6 * ref + 1e-6 * ref.max()
    del flips, pqx, pqg, qx, qg, f1, ratio
    n_bytes = 2 * n * d * 4 + 2 * d * hidden + 2 * (d + hidden) * 4
    plan = M.k14_plan(n, d, hidden, 4)
    record("int8_mlp_f32", f"x ({n}, {d}) fp32, w1 ({hidden}, {d}) and w2 ({d}, {hidden}) int8, {plan.route} route, "
           f"cluster of {plan.cluster}, {plan.stages} stages, GEMM1 twice",
           "asr_ttl_mtl_tpu_torch/csrc/int8_mlp.cu", "asr_ttl_mtl_tpu/ops/int8_mlp.py:46", got, want, tol14,
           lambda: M.int8_mlp(*args), lambda: M.int8_mlp_plain(*args),
           bound=bound(4 * n * d * hidden, n_bytes, "int8"), repeat=True)
    rows[-1]["second_int8_flip_share"] = share
    return rows


def check_conv_stem_fp32(card: str, model):
    """Phase 20 (e): the fp32 conv stem on the card under cuDNN's default
    allow_tf32=True: the port's guard runs it in fp32, so `W.conv1d` is
    within 1e-5 of its largest output of a float64 reference on the CPU;
    the same F.conv1d outside the guard, in TF32, printed beside it."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch import log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import whisper as W

    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("phase 20 runs with cuDNN's default allow_tf32=True")
    mel = log_mel_spectrogram(make_waves(2, seed=2), device=DEVICE)
    conv = model.encoder.conv1
    with torch.no_grad():
        got = W.conv1d(conv, mel, stride=1).cpu().double()
        raw = F.conv1d(mel, conv.weight.float(), None, padding=1).cpu().double() + conv.bias.double().cpu()[None, :, None]
        ref = F.conv1d(mel.cpu().double(), conv.weight.cpu().double(), None, padding=1) + \
            conv.bias.cpu().double()[None, :, None]
    scale = ref.abs().max().item()
    err, err_raw = (got - ref).abs().max().item() / scale, (raw - ref).abs().max().item() / scale
    ok = err <= 1e-5
    print(f"[check] fp32 conv stem on the card (conv1 of base over 2 x 30 s), cuDNN allow_tf32 left True: the port's "
          f"max error {err:.2e} of its largest output against float64 (tol 1e-5); F.conv1d outside the guard "
          f"{err_raw:.2e} [{card}] {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the fp32 conv stem is not fp32 on the card")


def check_fp32_decode_against_cpu(card: str, model, waves_seed: int = 1, what: str = "",
                                  encoder_kernel: str = "flash_attention_h2_f32"):
    """Phase 20 (e): the card's fp32 decode of 2 windows (FP32_GATE_OPTIONS)
    against the plain path on the CPU in fp32: teacher-forced to the card's
    tokens on both, the card's tokens are the CPU's argmax (up to ties
    within the tolerance), and every filtered logit of the card's forced run
    is within FP32_LOGIT_TOL of the CPU's. `encoder_kernel` launches once an
    encoder layer."""
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    waves = make_waves(2, seed=waves_seed)
    mel = log_mel_spectrogram(waves, n_mels=model.dims.n_mels, device=DEVICE)
    reset_launch_counts()
    card_res = DecodingTask(model, DecodingOptions(**FP32_GATE_OPTIONS)).run(mel)
    counts = dict(LAUNCHES)
    if counts[encoder_kernel] != model.dims.n_audio_layer or counts["decode_attention_f32"] <= 0:
        raise AssertionError(f"the fp32 gate's decode launched {counts}")
    no_bf16_kernel(counts, "the fp32 gate's decode")
    toks = torch.tensor([r.tokens for r in card_res])
    _, card_steps = forced_steps(model, waves, toks, FP32_GATE_OPTIONS, device=DEVICE)
    t0 = time.perf_counter()
    mel_cpu, cpu_steps = forced_steps(model, waves, toks, FP32_GATE_OPTIONS)
    t_cpu = time.perf_counter() - t0
    mel_err = (mel.cpu() - mel_cpu).abs().max().item()
    worst_gap = max((lg.amax(-1) - lg.gather(1, tok[:, None])[:, 0]).max().item() for lg, tok in cpu_steps)
    not_argmax = sum(int((lg.argmax(-1) != tok).sum()) for lg, tok in cpu_steps)
    logit_err, same_mask = 0.0, True
    for (lc, _), (lp, _) in zip(card_steps, cpu_steps):
        lc, fin = lc.cpu(), torch.isfinite(lp)
        same_mask = same_mask and torch.equal(torch.isfinite(lc), fin)
        logit_err = max(logit_err, (lc - lp)[fin].abs().max().item())
    ok = mel_err < 1e-3 and same_mask and logit_err <= FP32_LOGIT_TOL and worst_gap <= FP32_LOGIT_TOL
    print(f"[check] fp32 decode{what}, card vs CPU fp32 plain path, 2 windows x {toks.shape[1]} tokens (fp16=False, float "
          f"caches and linears): {not_argmax} card tokens are not the CPU's argmax, trailing it by at most "
          f"{worst_gap:.2e} (tol {FP32_LOGIT_TOL}); filtered logits max |card - CPU| {logit_err:.2e} (tol "
          f"{FP32_LOGIT_TOL}, 100x the bf16 gate's 0.5), -inf at the same places {same_mask}; log-mel max err "
          f"{mel_err:.2e}; CPU forced run {t_cpu:.1f} s [{card}] {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the card's fp32 decode disagrees with the CPU reference")


def check_fp32_train_step_against_cpu(card: str, trainer, ref: dict, what: str = "phase 7's weights"):
    """Phase 20 (e): one fp32 train step on the card from phase 7's weights,
    2-clip batch and dropout mask against phase 7's fp32 CPU step: the loss
    and every group's gradient norm within FP32_TRAIN_TOL (relative).
    Phase 21 (h) holds its fp32 trainer to `cpu_reference_step` the same way."""
    import torch

    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    trainer.load_state(ref["model_sd"], ref["head_sd"])
    trainer.alpha, trainer.beta = ref["alpha"], ref["beta"]
    reset_launch_counts()
    loss, _ = trainer.train_step(ref["batch"], keep=ref["keep"])
    sync()
    counts = dict(LAUNCHES)
    no_bf16_kernel(counts, "the fp32 gate's train step")
    card_g, cpu_g = grads_by_group(trainer), ref["cpu_grads"]
    rel = abs(float(loss) - ref["cpu_loss"]) / abs(ref["cpu_loss"])
    norms = {g: (card_g[g].double().norm().item(), cpu_g[g].double().norm().item()) for g in cpu_g}
    norm_rel = {g: abs(a - b) / b for g, (a, b) in norms.items()}
    cos = {g: float(torch.nn.functional.cosine_similarity(card_g[g].double(), cpu_g[g].double(), dim=0))
           for g in cpu_g}
    worst = max(norm_rel, key=norm_rel.get)
    ok = rel <= FP32_TRAIN_TOL and norm_rel[worst] <= FP32_TRAIN_TOL
    print(f"[check] train step, card fp32 vs CPU fp32 plain path ({what}, 2 clips, dropout mask): loss "
          f"{float(loss):.7f} vs {ref['cpu_loss']:.7f}, rel diff {rel:.2e} (tol {FP32_TRAIN_TOL}, 100x tighter than "
          f"the bf16 gate's 2%); gradient norm rel diff {', '.join(f'{g} {r:.2e}' for g, r in norm_rel.items())}, "
          f"worst {worst} (tol {FP32_TRAIN_TOL}); cosine {', '.join(f'{g} {c:.7f}' for g, c in cos.items())}; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})} [{card}] {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the card's fp32 train step disagrees with the CPU reference")


# ------------------------------------------------------------------ phase 21

# base's width with the heads cut to 128 and to 32 columns, in the encoder
# and the decoder alike, and its depth cut to 2 + 2 layers (random weights
# from seed 0)
HW_DIMS = {
    f"dh{dh}": dict(n_mels=80, n_audio_ctx=1500, n_audio_state=512, n_audio_head=512 // dh, n_audio_layer=2,
                    n_vocab=51865, n_text_ctx=448, n_text_state=512, n_text_head=512 // dh, n_text_layer=2)
    for dh in (128, 32)
}
HW_WINDOWS = 8  # the greedy window path's windows
HW_BEAM_WINDOWS = 4
HW_TRAIN_BATCH = 8
HW_KERNELS = ("decode_attention_i8", "decode_attention", "flash_attention_h2", "flash_attention_h2_lse",
              "flash_attention_h2_bwd", "flash_attention", "flash_attention_lse", "flash_attention_bwd")


def check_head_width_kernels(card: str, geometry: str, fp32: bool = False):
    """Phase 21 (a), with `fp32` (f): at one geometry of HW_DIMS (d 512,
    head width dh), each attention kernel of the dtype against its plain
    version at the paths' shapes, bitwise on a second launch, and timed
    beside its bound and SDPA on the same views: K3 with and without lse
    and K6 at the encoder's (8, 1536, 512) with keys valid to 1500; K7, K7
    with lse and K8 at the train bucket's causal (8 x H, 48, dh) and at
    q_offset 48 (48 queries over 96 keys); K5 (the K3 forward, which serves
    dh 32 and 128) where `h2_eligible` would reject the shape; K2 and K1 on
    the cross cache (8 windows x 1500, int8 padded to 1536 with valid_upto
    1499) and on a 128-row self cache with valid_upto 37, at groups 1 and
    5. bf16 at phases 3 and 8's tolerances; fp32 (K2 over fp32 caches, K1
    with fp32 queries) within FP32_REL of the largest output (K1 the flip
    bound beside it), the bound over 3xTF32 and over FFMA."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dims = HW_DIMS[geometry]
    d, n_head = dims["n_audio_state"], dims["n_audio_head"]
    dh = d // n_head
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    rows = []
    record = make_recorder(card, rows)
    src, b = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", HW_TRAIN_BATCH
    tag = f"{geometry} ({n_head} heads of {dh})"
    scale = dh**-0.5
    dtype, dt, sfx, esz = (torch.float32, "fp32", "_f32", 4) if fp32 else (torch.bfloat16, "bf16", "", 2)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rel_tol(x):
        return (FP32_REL if fp32 else 2.0**-6) * x.float().abs().max().item()

    def lse_tol(x):
        return FP32_REL * x.abs().max().item() if fp32 else 1e-4

    def bounds(macs, n_bytes, mults=4):
        if fp32:  # over 3xTF32 on the tensor cores, and FFMA beside it
            return dict(bound=attn_bound(macs, n_bytes, mults, "3xtf32"),
                        ffma_bound=attn_bound(macs, n_bytes, mults, "fp32"))
        return dict(bound=attn_bound(macs, n_bytes, mults))

    # K3 with and without lse, and K6: the encoder's self-attention
    tq = tk = 1536
    q, k, v, g = rnd(b, tq, d), rnd(b, tk, d), rnd(b, tk, d), rnd(b, tq, d)
    kw = dict(n_head=n_head, kv_valid_len=1500, scale=scale)
    case = f"{tag}: encoder q,k,v ({b}, {tq}, {d}) {dt}, kv_valid_len 1500"
    io = (2 * q.numel() + 2 * b * 1500 * d) * esz
    qh = heads(q, n_head).detach().requires_grad_(True)
    kh, vh = (heads(x, n_head, 1500).detach().requires_grad_(True) for x in (k, v))
    pout, plse = FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw)
    record("flash_attention_h2" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:514",
           FA.flash_attention_h2(q, k, v, **kw), pout, rel_tol(pout),
           lambda: FA.flash_attention_h2(q, k, v, **kw), lambda: FA.flash_attention_h2_plain(q, k, v, **kw),
           **bounds(b * tq * 1500 * d, io), plain_iters=5,
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), repeat=True)
    out, lse = FA.flash_attention_h2(q, k, v, return_lse=True, **kw)
    if tuple(lse.shape) != (d // 128, b, tq, 128 // dh):
        raise AssertionError(f"K3 lse at {geometry} {dt}: shape {tuple(lse.shape)}")
    record("flash_attention_h2_lse" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:552",
           [out, lse], [pout, plse], [rel_tol(pout), lse_tol(plse)],
           lambda: FA.flash_attention_h2(q, k, v, return_lse=True, **kw),
           lambda: FA.flash_attention_h2_plain(q, k, v, return_lse=True, **kw),
           **bounds(b * tq * 1500 * d, io + lse.numel() * 4), plain_iters=5,
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), repeat=True)
    delta = FA.h2_delta(g, pout, n_head)
    got = list(FA.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw))
    want = list(FA.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw))
    lib_out = F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    gh = heads(g, n_head)
    record("flash_attention_h2_bwd" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:651,691",
           got, want, [rel_tol(w) for w in want],
           lambda: FA.flash_attention_h2_bwd(q, k, v, plse, delta, g, **kw),
           lambda: FA.flash_attention_h2_bwd_plain(q, k, v, plse, delta, g, **kw),
           **bounds(b * tq * 1500 * d, 2 * io + 2 * lse.numel() * 4, mults=10), plain_iters=5,
           library=lambda: torch.autograd.grad(lib_out, (qh, kh, vh), gh, retain_graph=True), repeat=True)
    del q, k, v, g, out, lse, pout, plse, delta, got, want, lib_out, qh, kh, vh, gh

    # K5 where h2_eligible would not take the shape (d not a multiple of
    # 128 at dh 32; tq below 16 is no flash shape, so one head of 128 over
    # a ragged 200): K3's forward serves both widths
    k5_d, k5_heads = (3 * dh, 3) if dh == 32 else (dh, 1)
    q, k, v = rnd(2, 200, k5_d), rnd(2, 300, k5_d), rnd(2, 300, k5_d)
    kw = dict(n_head=k5_heads, kv_valid_len=270, scale=scale)
    want = FA.flash_attention_mh_plain(q, k, v, **kw)
    qh, kh, vh = heads(q, k5_heads), heads(k, k5_heads, 270), heads(v, k5_heads, 270)
    route = "" if fp32 else f", {k5_route(dh, 200)}"
    record("flash_attention_mh" + sfx, f"{tag}: q (2, 200, {k5_d}), k (2, 300, {k5_d}) {dt}, {k5_heads} heads of "
           f"{dh}, kv_valid_len 270{route}", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:346",
           FA.flash_attention_mh(q, k, v, **kw), want, rel_tol(want),
           lambda: FA.flash_attention_mh(q, k, v, **kw), lambda: FA.flash_attention_mh_plain(q, k, v, **kw),
           **bounds(2 * 200 * 270 * k5_d, (2 * q.numel() + 2 * 2 * 270 * k5_d) * esz),
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=False, repeat=True)
    del q, k, v, want, qh, kh, vh

    # K7 with and without lse and K8: the decoder's causal self-attention at
    # the train bucket (48), and 48 queries at q_offset 48
    bh = b * n_head
    for tq, q_offset in ((48, 0), (48, 48)):
        tk = tq + q_offset
        q, k, v, g = rnd(bh, tq, dh), rnd(bh, tk, dh), rnd(bh, tk, dh), rnd(bh, tq, dh)
        kw = dict(causal=True, q_offset=q_offset, scale=scale)
        pairs = sum(min(tk, q_offset + i + 1) for i in range(tq))
        io = (2 * q.numel() + 2 * k.numel()) * esz
        if q_offset:
            mask = torch.arange(tk, device=dev)[None, :] <= (q_offset + torch.arange(tq, device=dev))[:, None]
            lib = dict(attn_mask=mask)
        else:
            lib = dict(is_causal=True)
        ql, kl, vl = (x[None].detach().requires_grad_(True) for x in (q, k, v))
        case = (f"{tag}: causal ({bh}, {tq}, {dh})" + (f" x {tk} keys, q_offset {q_offset}" if q_offset
                                                        else ", token bucket"))
        main = not q_offset
        out, lse = FA.flash_attention(q, k, v, return_lse=True, **kw)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        record("flash_attention_lse" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
               [out, lse], [pout, plse], [rel_tol(pout), lse_tol(plse)],
               lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
               lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
               **bounds(bh * pairs * dh, io + lse.numel() * 4),
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale, **lib), main=main,
               repeat=True)
        record("flash_attention" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
               FA.flash_attention(q, k, v, **kw), pout, rel_tol(pout),
               lambda: FA.flash_attention(q, k, v, **kw), lambda: FA.flash_attention_plain(q, k, v, **kw),
               **bounds(bh * pairs * dh, io),
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale, **lib), main=main,
               repeat=True)
        got = list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
        want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale, **lib)
        record("flash_attention_bwd" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030",
               got, want, [rel_tol(w) for w in want],
               lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
               lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
               **bounds(bh * pairs * dh, 2 * io + 2 * lse.numel() * 4, mults=10),
               library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g[None], retain_graph=True), main=main,
               repeat=True)
        del q, k, v, g, out, lse, pout, plse, got, want, lib_out, ql, kl, vl

    # K2 and K1: the cross cache of 8 windows and a 128-row self cache, at
    # groups 1 and 5 (the beams of a window share its rows)
    src = "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu"
    n_win = HW_WINDOWS
    cross_k, cross_v = rnd(6, n_win, 1500, d), rnd(6, n_win, 1500, d)
    self_k, self_v = rnd(6, n_win, 128, d), rnd(6, n_win, 128, d)
    quant = {"cross": [DA.quantize_kv_rows(x) for x in (cross_k, cross_v)],
             "self": [DA.quantize_kv_rows(x) for x in (self_k, self_v)]}
    for what, ck, cv, valid in (("cross", cross_k, cross_v, None), ("self", self_k, self_v, 37)):
        for group in (1, BEAM):
            q = rnd(n_win * group, 1, d)
            kw = dict(scale=scale, valid_upto=valid, group=group)
            n_keys = ck.shape[2] if valid is None else valid + 1
            main = what == "cross" and group == 1
            want = DA.decode_attention_plain(q, ck, cv, 5, n_head, **kw)
            qh = q.reshape(n_win, group, n_head, dh).transpose(1, 2)
            kh, vh = heads(ck[5], n_head, n_keys), heads(cv[5], n_head, n_keys)
            record("decode_attention" + sfx, f"{tag}: {what} {tuple(ck.shape)} {dt}, q ({n_win * group}, 1, {d}), "
                   f"group {group}, valid_upto {valid}", src, "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
                   DA.decode_attention(q, ck, cv, 5, n_head, **kw), want,
                   (FP32_REL if fp32 else 2.0**-7) * want.float().abs().max().item(),
                   lambda: DA.decode_attention(q, ck, cv, 5, n_head, **kw),
                   lambda: DA.decode_attention_plain(q, ck, cv, 5, n_head, **kw),
                   bound=attn_bound(n_win * group * n_keys * d, (2 * q.numel() + 2 * n_win * n_keys * d) * esz,
                                    kind="fp32" if fp32 else "bf16"),
                   library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=main, repeat=True)
            (k8, ks), (v8, vs) = quant[what]
            valid8 = 1499 if valid is None else valid
            n_keys8 = valid8 + 1
            kw8 = dict(scale=scale, valid_upto=valid8, group=group)
            want, flip = DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 5, n_head, return_flip_bound=True, **kw8)
            ref = want.float().abs()
            # the plain version's flip bound, and fp32 noise or one bf16 rounding
            tol = flip + FP32_REL * ref.max() if fp32 else (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
            tk_blk = DA._i8_blocks(n_win, k8.shape[2], d)[1]
            record("decode_attention_i8" + sfx, f"{tag}: {what} {tuple(k8.shape)} int8, q ({n_win * group}, 1, "
                   f"{d}) {dt}, group {group}, valid_upto {valid8}, tk_blk {tk_blk}", src,
                   "asr_ttl_mtl_tpu/ops/decode_attention.py:186",
                   DA.decode_attention_i8(q, k8, ks, v8, vs, 5, n_head, **kw8), want, tol,
                   lambda: DA.decode_attention_i8(q, k8, ks, v8, vs, 5, n_head, **kw8),
                   lambda: DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 5, n_head, **kw8),
                   bound=bound(4 * n_win * group * n_keys8 * d, 2 * n_win * n_keys8 * (d + 4) + 2 * q.numel() * esz,
                               "int8"), main=main, repeat=True)
    return rows


def run_head_width(card: str, geometry: str, workdir: str, fp32: bool = False):
    """Phase 21 (b)-(e), with `fp32` (g) and (h), at one geometry of
    HW_DIMS, random weights from seed 0, through the entry points: (b) the
    greedy window path on HW_WINDOWS seeded windows with phase 4's options
    (int8 KV, W8A8 encoder, 64 forced tokens; fp32: fp16=False), then one
    batch with kv_quant=False; (c) beam 5 on HW_BEAM_WINDOWS windows; (d) 2
    train steps of MultiTaskTrainer with these dims as `debug_dims` at
    batch HW_TRAIN_BATCH (fp32: compute_dtype="float32"), then `evaluate`
    on HW_TRAIN_BATCH clips; (e) phase 5's check of the bf16 decode against
    the CPU's fp32 plain path on 2 windows, or (h) phase 20's gates: the
    fp32 decode of 2 windows against the CPU's fp32 plain path and one fp32
    train step against the CPU's from the same weights, clips and dropout
    mask. Each path's launch counts are reset just before it and read just
    after; every kernel of HW_KERNELS (fp32: its `_f32` name) must launch on
    them, and an fp32 path launches no bf16 attention or K14 kernel.
    Returns the counts of each path."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, from_random
    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    dims = HW_DIMS[geometry]
    sfx, dt = ("_f32", "fp32") if fp32 else ("", "bf16")
    tag = f"[hw {geometry}{' fp32' if fp32 else ''}]"
    n_layer = dims["n_audio_layer"]
    model = from_random(ModelDimensions(**dims), seed=0, device=DEVICE, dtype=torch.bfloat16)
    paths = {}

    def counted(name, fn):
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        paths[name] = dict(LAUNCHES)
        if fp32:
            no_bf16_kernel(paths[name], f"{tag} {name}")
        return out, time.perf_counter() - t0

    # (b) the greedy window path, then kv_quant=False
    options = {**BASE_OPTIONS, "fp16": not fp32}
    mel = log_mel_spectrogram(make_waves(HW_WINDOWS, seed=0), device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**options))
    if task.compute_dtype != (torch.float32 if fp32 else torch.bfloat16):
        raise AssertionError(f"fp16={options['fp16']} computes in {task.compute_dtype}")
    task.run(mel)  # warm-up, not counted
    results, t_dec = counted("greedy", lambda: task.run(log_mel_spectrogram(make_waves(HW_WINDOWS, seed=0),
                                                                            device=DEVICE)))
    for r in results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob) and np.isfinite(r.no_speech_prob), r
    c = paths["greedy"]
    assert c["flash_attention_h2" + sfx] == n_layer and c["decode_attention_i8" + sfx] > 0 and c["log_mel"] == 1, c
    plain_task = DecodingTask(model, DecodingOptions(**{**options, "kv_quant": False}))
    float_results, t_float = counted("kv_quant=False", lambda: plain_task.run(mel))
    for r in float_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    c = paths["kv_quant=False"]
    assert c["flash_attention_h2" + sfx] == n_layer and c["decode_attention" + sfx] > 0, c
    print(f"{tag} greedy, {HW_WINDOWS} windows, {'fp16=False, ' if fp32 else ''}kv_quant + int8_encoder, 64 tokens: "
          f"{t_dec:.3f} s = {HW_WINDOWS * 30.0 / t_dec:.1f} audio-s/s (log-mel included); kv_quant=False: "
          f"{t_float:.3f} s [{card}]; text[0]={results[0].text[:40]!r} avg_logprob[0]={results[0].avg_logprob:.4f}",
          flush=True)

    # (c) beam 5
    beam_mel = mel[:HW_BEAM_WINDOWS].contiguous()
    beam_task = DecodingTask(model, DecodingOptions(**{**BEAM_OPTIONS, "fp16": not fp32}))
    beam_results, t_beam = counted("beam", lambda: beam_task.run(beam_mel))
    for r in beam_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    c = paths["beam"]
    assert c["topk_logprobs"] == 64 and c["decode_attention_i8" + sfx] > 0, c
    print(f"{tag} beam {BEAM}, {HW_BEAM_WINDOWS} windows: {t_beam:.3f} s (the first call at this shape) [{card}]",
          flush=True)

    # (e) the bf16 decode against the CPU's fp32 plain path, or (h) phase 20's fp32 gate
    if fp32:
        check_fp32_decode_against_cpu(card, model, what=f" at {geometry}")
    else:
        check_against_cpu(model)
    del task, plain_task, beam_task, mel, beam_mel, model
    torch.cuda.empty_cache()

    # (d) training, then evaluate
    cfg = TrainingConfig(model_size=MODEL, pretrained="random", debug_dims=dims, batch_size=HW_TRAIN_BATCH,
                         val_batch_size=HW_TRAIN_BATCH, compute_dtype="float32" if fp32 else "bfloat16",
                         learning_rate=1e-5, seed=0, num_workers=4, epochs=1,
                         save_dir=os.path.join(workdir, f"{geometry}{sfx}_out"))
    ds = MultiTaskSpeechDataset(write_clips(workdir, 2 * HW_TRAIN_BATCH, seed=21), cfg)
    batches = list(DataLoader(ds, HW_TRAIN_BATCH, shuffle=True, num_workers=4, drop_last=True, seed=0,
                              buckets=cfg.token_buckets))[:2]
    val_batches = batches[:1]
    trainer = MultiTaskTrainer(cfg, verbose=False)
    per_step = {"log_mel": 1, f"flash_attention_h2_lse{sfx}": 2 * n_layer, f"flash_attention_h2_bwd{sfx}": 2 * n_layer,
                f"flash_attention_lse{sfx}": n_layer, f"flash_attention_bwd{sfx}": n_layer}
    losses, step_s = [], []
    for i, batch in enumerate(batches):
        (loss, _), dt_s = counted(f"train step {i + 1}", lambda: trainer.train_step(batch))
        launched = {k: v for k, v in paths[f"train step {i + 1}"].items() if v}
        if launched != per_step:
            raise AssertionError(f"{geometry} {dt} train step {i + 1} launched {launched}, expected {per_step}")
        losses.append(float(loss))
        step_s.append(dt_s)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{geometry}: non-finite {dt} train loss {losses}")
    metrics, t_eval = counted("evaluate", lambda: trainer.evaluate(val_batches))
    expect = {"log_mel": 1, f"flash_attention_h2{sfx}": 2 * n_layer, f"flash_attention{sfx}": n_layer}
    if {k: v for k, v in paths["evaluate"].items() if v} != expect:
        raise AssertionError(f"{geometry} {dt} evaluate launched {paths['evaluate']}, expected {expect}")
    for key in ("loss", "wer", "disease_acc"):
        if not np.isfinite(metrics[key]):
            raise AssertionError(f"{geometry} {dt} evaluate: {key} = {metrics[key]}")
    print(f"{tag} train, batch {HW_TRAIN_BATCH}, {dt}, token buckets "
          f"{[bt['input_tokens'].shape[1] for bt in batches]}: 2 steps, losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; step s {', '.join(f'{x:.4f}' for x in step_s)} (the first has the set-up); evaluate on "
          f"{HW_TRAIN_BATCH} clips {t_eval:.3f} s, loss {metrics['loss']:.4f}; launches per step "
          f"{json.dumps(per_step)} [{card}]", flush=True)
    if fp32:  # (h) one fp32 step against the CPU's from the same weights, clips and dropout mask
        ref = cpu_reference_step(trainer, batches[0])
        check_fp32_train_step_against_cpu(card, trainer, ref,
                                          what=f"{geometry}'s trained weights, CPU step {ref['cpu_s']:.1f} s")
        del ref
    del trainer
    torch.cuda.empty_cache()

    total = {name + sfx: sum(c.get(name + sfx, 0) for c in paths.values()) for name in HW_KERNELS}
    missing = [name for name, n in total.items() if n == 0]
    if missing:
        raise AssertionError(f"{geometry}: no launch of {missing} on phase 21's {dt} paths: {total}")
    print(f"{tag} launches over the paths {json.dumps(total)}", flush=True)
    return list(paths.values())


# ------------------------------------------------------------------ phase 22

FILES_BATCH = 16  # phase 6's batch


def expect_launches(counts: dict, want: dict, what: str) -> None:
    """The kernels a run launched are exactly `want` (name -> launches)."""
    launched = {k: v for k, v in counts.items() if v}
    if launched != want:
        raise AssertionError(f"{what} launched {launched}, expected {want}")


def expect_launched(counts: dict, names, what: str) -> None:
    """A run launched each kernel of `names` at least once."""
    missing = [name for name in names if counts[name] <= 0]
    if missing:
        raise AssertionError(f"{what} launched no {missing}: {counts}")


def counted(fn):
    """(fn(), its launch counts): the counts reset just before and read just after."""
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    sync()
    reset_launch_counts()
    out = fn()
    sync()
    return out, dict(LAUNCHES)


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def write_odd_files(directory: str):
    """A 44.1 kHz WAV, a 24-bit WAV (3-7 s of tones and noise, seeded) and a
    file that ends in `.wav` but holds no RIFF header."""
    import numpy as np

    rng = np.random.RandomState(5)
    paths = []
    for name, sr, width in (("cd44100.wav", 44100, 2), ("pcm24.wav", 16000, 3)):
        t = np.arange(int(sr * rng.uniform(3.0, 7.0))) / sr
        x = np.clip(0.3 * np.sin(2 * np.pi * rng.uniform(100, 3000) * t) + 0.03 * rng.randn(t.size), -1, 1)
        if width == 2:
            raw = (x * 32767).astype("<i2").tobytes()
        else:
            i32 = (x * ((1 << 23) - 1)).astype(np.int32)
            raw = np.stack([i32 & 0xFF, (i32 >> 8) & 0xFF, (i32 >> 16) & 0xFF], 1).astype(np.uint8).tobytes()
        path = os.path.join(directory, name)
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(width)
            w.setframerate(sr)
            w.writeframes(raw)
        paths.append(path)
    broken = os.path.join(directory, "not_audio.wav")
    with open(broken, "wb") as f:
        f.write(b"ID3\x04\x00" + bytes(rng.randint(0, 256, 4096, dtype=np.uint8)))
    return paths + [broken]


def check_file_loading(card: str, workdir: str):
    """Phase 22 (a): phase 6's 32 clips, the 44.1 kHz and 24-bit WAVs and the
    broken file, in one batch through the loader's native route (one
    `runtime.wav.load_batch` call) against the Python route (the stdlib
    reader and scipy's resample_poly) within 2e-6; the broken file gives a
    zero row and the error line."""
    import contextlib
    import io

    import numpy as np

    from asr_ttl_mtl_tpu_torch import audio as A
    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, TrainingConfig
    from asr_ttl_mtl_tpu_torch.runtime import wav as native

    with open(write_clips(workdir, 32, seed=0)) as f:
        rows = f.read().splitlines()
    odd = write_odd_files(workdir)
    csv_path = os.path.join(workdir, "files.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows + [f"{p},the patient said hello,{i}" for i, p in enumerate(odd)]) + "\n")
    cfg = TrainingConfig(model_size=MODEL, pretrained="random", device=DEVICE)
    ds = MultiTaskSpeechDataset(csv_path, cfg)
    before = native.CALLS["load_batch"]
    printed = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        (batch,) = list(DataLoader(ds, len(ds), num_workers=4, buckets=cfg.token_buckets))
    wall = time.perf_counter() - t0
    if native.CALLS["load_batch"] != before + 1:
        raise AssertionError(f"the native route ran {native.CALLS['load_batch'] - before} times, expected once")
    error_line = f"Error loading audio {odd[-1]}: native decode -4"
    if error_line not in printed.getvalue():
        raise AssertionError(f"no error line for the broken file: {printed.getvalue()!r}")
    err = 0.0
    for i, row in enumerate(ds.rows):
        got = batch["audio"][i]
        if row["file"] == odd[-1]:
            if got.any():
                raise AssertionError("the broken file's row is not zero")
            continue
        data, sr = A._read_wav(row["file"])
        want = A.resample(data, sr, A.SAMPLE_RATE)[: cfg.audio_samples]
        err = max(err, float(np.abs(got[: want.size] - want).max()))
        if got[want.size:].any():
            raise AssertionError(f"{row['file']}: samples past its length")
    ok = err <= 2e-6
    print(f"[files] (a) {len(ds)} files (phase 6's 32 clips, 44.1 kHz, 24-bit, one not a WAV) in one native "
          f"load_batch call, {wall:.3f} s; native vs Python route (stdlib reader + scipy resample_poly) max |diff| "
          f"{err:.2e} (tol 2e-6); the broken file: a zero row and {error_line!r} {'OK' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError("the native and Python routes disagree")


def files_config(workdir: str, tag: str, **kw):
    from asr_ttl_mtl_tpu_torch.mtl import TrainingConfig

    return TrainingConfig(**{**dict(model_size=MODEL, pretrained="random", batch_size=FILES_BATCH,
                                    val_batch_size=FILES_BATCH, compute_dtype="bfloat16", learning_rate=1e-5,
                                    seed=0, num_workers=4, epochs=1, device=DEVICE,
                                    save_dir=os.path.join(workdir, tag)), **kw})


def run_transfer_steps(card: str, workdir: str, total: dict):
    """Phase 22 (b): the same seeded weights and the same 2 batches of
    phase 6's clips at batch 16: 2 train steps with int16 waveforms (K4 in
    the step) and 2 with `mel_fp16` (the loader's producer thread computes
    fp16 log-mels on the host; the step extends them to the window with
    `finish_transfer_mel`, no K4). Both launch phase 6's flash kernels per
    step; the transfer mels lie within 3e-3 of K4's mels of the same batch.
    Returns the mel_fp16 trainer."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch.audio import finish_transfer_mel, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer

    csv_path = os.path.join(workdir, "clips0.csv")
    out = {}
    for mode in ("int16", "mel_fp16"):
        cfg = files_config(workdir, mode, audio_transfer_dtype=mode)
        loader = DataLoader(MultiTaskSpeechDataset(csv_path, cfg), FILES_BATCH, shuffle=True, num_workers=4,
                            drop_last=True, seed=0, buckets=cfg.token_buckets)
        batches = list(loader)[:2]
        trainer = MultiTaskTrainer(cfg, verbose=False)
        dims = trainer.model.dims
        n_h2, n_k7 = dims.n_audio_layer + dims.n_text_layer, dims.n_text_layer
        per_step = {"flash_attention_h2_lse": n_h2, "flash_attention_h2_bwd": n_h2, "flash_attention_lse": n_k7,
                    "flash_attention_bwd": n_k7, **({"log_mel": 1} if mode == "int16" else {})}
        losses, step_s = [], []
        for i, batch in enumerate(batches):
            t0 = time.perf_counter()
            (loss, _), counts = counted(lambda: trainer.train_step(batch))
            step_s.append(time.perf_counter() - t0)
            expect_launches(counts, per_step, f"the {mode} train step {i + 1}")
            add_counts(total, counts)
            losses.append(float(loss))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{mode}: non-finite train loss {losses}")
        out[mode] = (batches, losses, step_s, per_step)
        if mode == "int16":
            del trainer
            if DEVICE == "cuda":
                torch.cuda.empty_cache()
    (int_batches, int_losses, int_s, _), (mel_batches, mel_losses, mel_s, per_step) = out["int16"], out["mel_fp16"]
    if [b["paths"] for b in int_batches] != [b["paths"] for b in mel_batches]:
        raise AssertionError("the two loaders gave other batches")
    err = 0.0
    with torch.no_grad():
        for wb, mb in zip(int_batches, mel_batches):
            audio = torch.from_numpy(wb["audio"]).to(DEVICE)
            audio = torch.nn.functional.pad(audio, (0, trainer.config.audio_samples - audio.shape[-1]))
            k4 = log_mel_spectrogram(audio, n_mels=trainer.model.dims.n_mels)
            moved = finish_transfer_mel(torch.from_numpy(mb["audio"]).to(DEVICE), trainer.config.audio_samples)
            err = max(err, (moved - k4).abs().max().item())
    ok = err <= 3e-3

    def fmt(xs, k=1.0):
        return ", ".join(f"{x * k:.4f}" for x in xs)

    print(f"[files] (b) base, batch {FILES_BATCH}, the same weights and 2 batches (mel bytes a batch "
          f"{mel_batches[0]['audio'].nbytes}, int16 waveforms {int_batches[0]['audio'].size * 2}): int16 losses "
          f"{fmt(int_losses)}, step ms {fmt(int_s, 1e3)}; mel_fp16 losses {fmt(mel_losses)}, step ms "
          f"{fmt(mel_s, 1e3)} (the first steps carry the set-up); mel_fp16 launches per step {json.dumps(per_step)}, "
          f"no log_mel; finish_transfer_mel vs K4's mels max |diff| {err:.2e} (tol 3e-3) [{card}] "
          f"{'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("the transfer mels disagree with K4's")
    return trainer, mel_batches


def run_twins(card: str, workdir: str, trainer, total: dict):
    """Phase 22 (c): the mel_fp16 trainer's checkpoint through the
    inference and evaluate twins on phase 6's 16 val clips, in process
    through their `main`: the files appear, every metric is finite, the
    inference twin's accuracy and the corpus WER of its per-sample texts
    equal the evaluate twin's (`trainer.evaluate` on the same batches), and
    the launches are K3 and K7 only (the mels come from the host)."""
    import contextlib
    import io

    import numpy as np

    from asr_ttl_mtl_tpu_torch.mtl import metrics as M
    from asr_ttl_mtl_tpu_torch.scripts import evaluate_disease, inference_disease

    trainer.save_checkpoint(epoch=0, best_loss=1.0)
    ckpt = trainer.checkpoint_path()
    val_csv = write_clips(workdir, FILES_BATCH, seed=1)
    dims = trainer.model.dims
    n_h2, n_k7 = dims.n_audio_layer + dims.n_text_layer, dims.n_text_layer
    want = {"flash_attention_h2": n_h2, "flash_attention": n_k7}
    report_dir = os.path.join(workdir, "report")
    os.makedirs(report_dir)
    printed = io.StringIO()
    runs = {}
    for name, fn in (
        ("inference", lambda: inference_disease.main(["--model_path", ckpt, "--test_csv", val_csv, "--batch_size",
                                                      str(FILES_BATCH), "--device", DEVICE, "--save_results",
                                                      os.path.join(report_dir, "results.csv")])),
        ("evaluate", lambda: evaluate_disease.main(["--model_path", ckpt, "--csv", val_csv, "--batch_size",
                                                    str(FILES_BATCH), "--device", DEVICE, "--output_json",
                                                    os.path.join(report_dir, "report.json")])),
    ):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            result, counts = counted(fn)
        runs[name] = (result, time.perf_counter() - t0)
        expect_launches(counts, want, f"the {name} twin")
        add_counts(total, counts)
    (results, extra), t_inf = runs["inference"]
    metrics, t_eval = runs["evaluate"]
    files = sorted(os.listdir(report_dir))
    if len(files) != 3 or not (files[0] == "report.json" and files[2].endswith("_summary.json")):
        raise AssertionError(f"the twins wrote {files}")
    numbers = [results["overall_wer"], results["overall_cer"], results["disease_accuracy"]]
    numbers += [r[k] for r in results["inference_results"] for k in ("wer", "cer", "disease_confidence")]
    numbers += [v for k, v in extra.items() if not k.startswith("per_class")]
    numbers += [metrics[k] for k in ("loss", "cls_loss", "trans_loss", "wer", "cer", "disease_acc", "macro_f1")]
    if not all(np.isfinite(numbers)):
        raise AssertionError("a twin's metric is not finite")
    data = results["inference_results"]
    corpus_wer = M.wer([r["original_text_normalized"] for r in data], [r["predicted_text_normalized"] for r in data])
    if results["disease_accuracy"] != metrics["disease_acc"] or corpus_wer != metrics["wer"]:
        raise AssertionError(f"inference twin acc {results['disease_accuracy']} wer {corpus_wer} against evaluate's "
                             f"{metrics['disease_acc']} {metrics['wer']}")
    print(f"[files] (c) the inference twin on {results['total_samples']} val clips: {t_inf:.2f} s wall; mean WER "
          f"{results['overall_wer']:.4f} (corpus {corpus_wer:.4f}), CER {results['overall_cer']:.4f}, accuracy "
          f"{results['disease_accuracy']:.4f}, macro F1 {extra['macro_f1']:.4f}; the evaluate twin {t_eval:.2f} s "
          f"wall, loss {metrics['loss']:.4f}, WER {metrics['wer']:.4f}, accuracy {metrics['disease_acc']:.4f}: "
          f"equal; files {files}; launches each {json.dumps(want)} [{card}]", flush=True)


def run_profiled_epoch(card: str, workdir: str, trainer, batches, total: dict):
    """Phase 22 (d): one epoch of the 2 mel_fp16 batches with `profile_dir`:
    a torch.profiler trace written there and the step timer's line."""
    import contextlib
    import io

    prof_dir = os.path.join(workdir, "profile")
    trainer.config.profile_dir = prof_dir
    trainer.verbose = True
    printed = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            _, counts = counted(lambda: trainer.train_epoch(batches, 0))
    finally:
        trainer.config.profile_dir, trainer.verbose = None, False
    wall = time.perf_counter() - t0
    add_counts(total, counts)
    traces = os.listdir(prof_dir) if os.path.isdir(prof_dir) else []
    timer = [line for line in printed.getvalue().splitlines() if line.startswith("  profile: ")]
    if len(traces) != 1 or not timer:
        raise AssertionError(f"profile_dir: traces {traces}, printed {printed.getvalue()!r}")
    size = os.path.getsize(os.path.join(prof_dir, traces[0]))
    print(f"[files] (d) one epoch of {len(batches)} mel_fp16 steps with profile_dir: {wall:.2f} s wall with the "
          f"trace and its export; {traces[0]} ({size / 1e6:.1f} MB); the step timer:{timer[0][len('  profile:'):]} "
          f"[{card}]", flush=True)


def run_resume(card: str, workdir: str, total: dict):
    """Phase 22 (e): `resume_dir` at base, int16 transfer, one shuffled step
    of 16 an epoch and `evaluate` on 16 clips after it: 1 epoch, then a new
    trainer resumed from the directory for the 2nd, against one 2-epoch run
    from the same seed: the weights and the optimizer's moments bit for bit
    (else, printed, within 1e-6 of the largest value)."""
    import torch

    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer

    train_csv = write_clips(workdir, FILES_BATCH, seed=1)  # phase 6's 16 val clips: one step an epoch

    def run(tag, epochs, resume_dir=None):
        cfg = files_config(workdir, tag, epochs=epochs)
        ds = MultiTaskSpeechDataset(train_csv, cfg)
        train = DataLoader(ds, FILES_BATCH, shuffle=True, num_workers=4, drop_last=True, seed=0,
                           buckets=cfg.token_buckets)
        val = DataLoader(ds, FILES_BATCH, num_workers=4, buckets=cfg.token_buckets)
        trainer = MultiTaskTrainer(cfg, verbose=False)
        t0 = time.perf_counter()
        out, counts = counted(lambda: trainer.train(train, val, resume_dir=resume_dir))
        add_counts(total, counts)
        state = {n: p.detach().clone() for n, p in trainer.named_trainable()}
        for g in trainer.optimizer.m:
            for i, (m, v) in enumerate(zip(trainer.optimizer.m[g], trainer.optimizer.v[g])):
                state[f"m.{g}.{i}"], state[f"v.{g}.{i}"] = m.clone(), v.clone()
        result = (state, trainer.optimizer.count, (trainer.alpha, trainer.beta), out, time.perf_counter() - t0)
        del trainer
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        return result

    whole = run("whole", 2)
    resume_dir = os.path.join(workdir, "resume")
    first = run("first", 1, resume_dir)
    second = run("second", 2, resume_dir)
    if (whole[1], second[1]) != (2, 2) or whole[2] != second[2]:
        raise AssertionError(f"steps {whole[1]} / {second[1]}, alpha/beta {whole[2]} / {second[2]}")
    same = [k for k in whole[0] if torch.equal(whole[0][k], second[0][k])]
    worst = max(((whole[0][k].float() - second[0][k].float()).abs().max()
                 / whole[0][k].float().abs().max().clamp(min=1e-30)).item() for k in whole[0])
    if len(same) != len(whole[0]) and worst > 1e-6:
        raise AssertionError(f"resumed run: {len(whole[0]) - len(same)} tensors differ, worst {worst:.3e} relative")
    losses = [h["train_metrics"]["loss"] for h in second[3]["training_history"]]
    print(f"[files] (e) resume_dir at base: 2 epochs of 1 step + evaluate {whole[4]:.2f} s; 1 epoch {first[4]:.2f} s, "
          f"then a new trainer resumed for the 2nd {second[4]:.2f} s; train losses {losses} against "
          f"{[h['train_metrics']['loss'] for h in whole[3]['training_history']]}; {len(same)} of {len(whole[0])} "
          f"weight and moment tensors bit for bit equal"
          + ("" if len(same) == len(whole[0]) else f", the rest within {worst:.3e} of their largest value (tol 1e-6)")
          + f" [{card}]", flush=True)


def run_flac_cli(card: str, workdir: str, total: dict):
    """Phase 22 (f): where ffmpeg is on PATH, phase 12's 40 s WAV converted
    to FLAC with it and transcribed through the CLI at base (one rung,
    `--language en`), as the WAV is with the same options: the same text."""
    import contextlib
    import io
    import shutil
    import subprocess

    import torch

    from asr_ttl_mtl_tpu_torch import from_random
    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.models import checkpoint_dict

    if not shutil.which("ffmpeg"):
        print("[files] (f) ffmpeg: absent on this machine", flush=True)
        return
    clip = os.path.join(workdir, "clip70.wav")
    write_long_wav(clip, LONG_WAV_S, seed=0)
    flac = os.path.join(workdir, "clip70.flac")
    subprocess.run(["ffmpeg", "-nostdin", "-y", "-i", clip, flac], capture_output=True, check=True)
    ckpt = os.path.join(workdir, "base.pt")
    torch.save(checkpoint_dict(from_random(MODEL, seed=0, device="cpu")), ckpt)
    texts = {}
    for path in (clip, flac):
        out = os.path.join(workdir, "cli_" + os.path.splitext(path)[1][1:])
        printed = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            _, counts = counted(lambda: cli([path, "--model", ckpt, "--device", DEVICE, "--output_dir", out,
                                             "--language", "en", "--temperature_increment_on_fallback", "None"]))
        wall = time.perf_counter() - t0
        if "Skipping" in printed.getvalue():
            raise AssertionError(f"the CLI skipped {path}:\n{printed.getvalue()[-3000:]}")
        expect_launched(counts, ("log_mel", "flash_attention_h2", "decode_attention", "topk_logprobs"),
                        f"the CLI on {path}")
        add_counts(total, counts)
        with open(os.path.join(out, "clip70.txt")) as f:
            texts[path] = f.read()
        print(f"[files] (f) the CLI on {os.path.basename(path)} ({'ffmpeg' if path == flac else 'native'} decode), "
              f"one rung: {wall:.1f} s wall; launches {json.dumps({k: v for k, v in counts.items() if v})} [{card}]",
              flush=True)
    if texts[clip] != texts[flac]:
        raise AssertionError("the FLAC's text differs from the WAV's")
    print(f"[files] (f) ffmpeg: the FLAC's text equals the WAV's ({len(texts[clip])} characters)", flush=True)


def run_files(card: str):
    """Phase 22: files in, reports out, at base. Returns the summed launch counts of its paths."""
    total = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        check_file_loading(card, workdir)
        trainer, mel_batches = run_transfer_steps(card, workdir, total)
        run_twins(card, workdir, trainer, total)
        run_profiled_epoch(card, workdir, trainer, mel_batches, total)
        del trainer, mel_batches
        run_resume(card, workdir, total)
        run_flac_cli(card, workdir, total)
    print(f"[files] phase 22: {time.perf_counter() - t0:.1f} s wall; launches over the phase "
          f"{json.dumps({k: v for k, v in total.items() if v})}", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 23: multi-device
# ---------------------------------------------------------------------------

MESH_GREEDY_WINDOWS = 32  # dp 2: 16 a rank
MESH_BEAM_WINDOWS = 8
MESH_TP_WINDOWS = 8
MESH_TRAIN = {  # case -> (mesh_shape, zero1, steps, batch)
    "dp2-zero1": ((2, 1), True, 3, 16),
    "tp2": ((1, 2), False, 2, 8),
}
MESH_GAP_TOL = 0.5  # phases 5 and 11: a chosen token trails the fp32 argmax (beam: the K+1-th) by < 0.5
MESH_LP_TOL = 0.1  # and avg_logprob within 0.1 of the fp32 plain path forced to the tokens
# phase 7's, which holds one step from the same weights: losses within 2%,
# and the first step's gradient (the same weights on both sides) at cosine
# >= 0.99 in every group; later steps start from weights that bf16 sums
# and Adam's normalized updates have moved apart
MESH_LOSS_TOL = 2e-2
MESH_COS_TOL = 0.99


def run_mesh_world1(card: str, waves, options, want):
    """Phase 23 (a): phase 15's `transcribe_batch` over a mesh of one rank,
    NCCL at world size 1, must give phase 15's outputs exactly."""
    import torch
    import torch.distributed as dist

    from asr_ttl_mtl_tpu_torch import from_random, transcribe_batch
    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.parallel import create_mesh

    W.set_int8_mlp_kernel("off")  # as phase 15 ran
    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=torch.device("cuda:0"))
    try:
        mesh = create_mesh((1, 1), device="cuda")
        t0 = time.perf_counter()
        outs, counts = counted(lambda: transcribe_batch(model, waves, batch_size=32, temperature=0.0, mesh=mesh,
                                                        **options))
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    key = [[(s["tokens"], s["start"], s["end"], s["avg_logprob"], s["no_speech_prob"]) for s in o["segments"]]
           for o in outs]
    want_key = [[(s["tokens"], s["start"], s["end"], s["avg_logprob"], s["no_speech_prob"]) for s in o["segments"]]
                for o in want]
    same = key == want_key and [o["text"] for o in outs] == [o["text"] for o in want]
    expect_launched(counts, ("log_mel", "flash_attention_h2", "decode_attention_i8"), "phase 23 (a)")
    print(f"[mesh] (a) transcribe_batch over create_mesh((1, 1)), NCCL world 1, phase 15's nine WAVs (32 windows): "
          f"{wall:.1f} s wall; the same outputs as phase 15, exactly: {same}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})} [{card}] {'OK' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError("transcribe_batch over a mesh of one rank differs from phase 15")
    return counts


def mesh_train_batches(workdir: str, batch: int, steps: int):
    """The training batches of phase 23, the same on every rank: phase 6's
    32 clips through the loader, the first `steps` batches cut to `batch` rows."""
    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, TrainingConfig

    cfg = TrainingConfig(model_size=MODEL, pretrained="random", batch_size=TRAIN_BATCH)
    ds = MultiTaskSpeechDataset(os.path.join(workdir, "clips0.csv"), cfg)
    loader = DataLoader(ds, TRAIN_BATCH, shuffle=True, num_workers=2, drop_last=True, seed=0,
                        buckets=cfg.token_buckets)
    batches = []  # each pass over the loader is an epoch
    while len(batches) < steps:
        batches.extend(list(loader)[: steps - len(batches)])
    rows = ("audio", "input_tokens", "target_tokens", "classes", "texts", "paths")
    return [{k: (v[:batch] if k in rows else v) for k, v in b.items()} for b in batches]


def mesh_trainer(mesh_shape, zero1: bool):
    from asr_ttl_mtl_tpu_torch.mtl import MultiTaskTrainer, TrainingConfig

    cfg = TrainingConfig(model_size=MODEL, pretrained="random", batch_size=TRAIN_BATCH, compute_dtype="bfloat16",
                         learning_rate=1e-5, seed=0, mesh_shape=mesh_shape, zero1=zero1)
    return MultiTaskTrainer(cfg, verbose=False)


def mesh_group_grads(trainer):
    """Each optimizer group's gradient laid end to end, fp32, whole (tp shards gathered)."""
    import torch

    from asr_ttl_mtl_tpu_torch.mtl.fused_optim import group_of

    out = {}
    for name, p in trainer.named_trainable():
        out.setdefault(group_of(name), []).append(trainer._tp_whole(name, p.grad).float().flatten())
    return {g: torch.cat(v) for g, v in out.items()}


def mesh_summary(results):
    return [(r.tokens, r.avg_logprob) for r in results]


def mesh_compare(label: str, got, want, model, n: int, options: dict, card: str) -> None:
    """A mesh run's decode held to the single-process phase's tolerance
    (phases 5 and 11): its tokens, forced through the fp32 plain path on the
    card, each trail the argmax (beam: the K+1-th largest filtered logit) by
    less than 0.5, and its avg_logprob lies within 0.1 of that path's. The
    single-process run at another batch size rounds its bf16 sums
    otherwise, so with random weights' near-tied logits some windows take
    other tokens; how many is printed."""
    import torch

    from asr_ttl_mtl_tpu_torch.models import whisper as W

    same = sum(g[0] == w[0] for g, w in zip(got, want))
    toks = torch.tensor([g[0] for g in got])
    W.set_int8_mlp_kernel("off")
    _, steps = forced_steps(model, make_waves(n, seed=23), toks, options, device=DEVICE)
    k = options.get("beam_size")
    rank = (lambda lg: lg.topk(k + 1, dim=-1).values[:, -1]) if k else (lambda lg: lg.amax(-1))
    gap = max((rank(lg) - lg.gather(1, tok[:, None])[:, 0]).max().item() for lg, tok in steps)
    avg = sum(lg.gather(1, tok[:, None])[:, 0] - torch.logsumexp(lg, -1) for lg, tok in steps) / (toks.shape[1] + 1)
    lp_err = max(abs(avg[r].item() - got[r][1]) for r in range(len(got)))
    ok = len(got) == len(want) and gap < MESH_GAP_TOL and lp_err <= MESH_LP_TOL
    print(f"[mesh] {label}: {same} of {len(want)} windows with the single-process tokens; forced through the fp32 "
          f"plain path on the card, its tokens trail the {'fp32 argmax' if not k else f'{k + 1}-th largest logit'} "
          f"by at most {gap:.3f} (tol {MESH_GAP_TOL}), |avg_logprob diff| {lp_err:.4f} (tol {MESH_LP_TOL}) "
          f"[{card}] {'OK' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label} disagrees with the single-process tolerance")


def mesh_rank(rank: int, payload: dict) -> dict:
    """Phase 23 (b), one rank of two on the card over gloo: the mesh paths,
    each with its launch counts (reset before, read after) and wall time."""
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, from_random, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.parallel import create_mesh
    from asr_ttl_mtl_tpu_torch.parallel.serving import decode_batched_dp

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {"dp": create_mesh((2, 1), device="cuda"), "tp": create_mesh((1, 2), device="cuda")}
    out = {}

    def timed(fn):
        t0 = time.perf_counter()
        res, counts = counted(fn)
        return res, counts, time.perf_counter() - t0

    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    W.set_int8_mlp_kernel("auto")
    runs = (("dp2-greedy", "dp", MESH_GREEDY_WINDOWS, BASE_OPTIONS), ("dp2-beam5", "dp", MESH_BEAM_WINDOWS, BEAM_OPTIONS),
            ("tp2-greedy", "tp", MESH_TP_WINDOWS, BASE_OPTIONS))
    for name, mesh, n, options in runs:
        waves, opts = make_waves(n, seed=23), DecodingOptions(**options)

        def run():  # the windows' log-mel (K4) and the mesh decode
            return decode_batched_dp(model, log_mel_spectrogram(waves, device=DEVICE), opts, mesh=meshes[mesh])

        if name == "dp2-greedy":  # warm-up (cuBLAS handles, allocator), not counted
            run()
        res, counts, wall = timed(run)
        out[name] = dict(results=mesh_summary(res), counts=counts, wall=wall, windows=n)
    W.set_int8_mlp_kernel("off")
    del model
    torch.cuda.empty_cache()

    for name, (shape, zero1, steps, batch) in MESH_TRAIN.items():
        trainer = mesh_trainer(shape, zero1)
        batches = mesh_train_batches(payload["workdir"], batch, steps)
        losses, walls, counts, cos = [], [], {}, None
        for b in batches:
            (loss, _), c, wall = timed(lambda: trainer.train_step(b))
            losses.append(float(loss))
            walls.append(wall)
            add_counts(counts, c)
            if cos is None:  # the first step's gradient, from the same weights as one process
                ref = torch.load(os.path.join(payload["workdir"], f"{name}.pt"), map_location=DEVICE)
                grads = mesh_group_grads(trainer)
                cos = {g: float(torch.nn.functional.cosine_similarity(grads[g].double(), ref[g].double(), dim=0))
                       for g in ref}
                del ref, grads
        checksum = float(sum(v.double().sum() for v in trainer.full_model_state().values()))
        out[name] = dict(losses=losses, walls=walls, counts=counts, cos=cos, checksum=checksum,
                         zero1=trainer.optimizer.zero1, alpha=trainer.alpha)
        del trainer
        torch.cuda.empty_cache()
    return out


def run_multi_device(card: str, workdir: str):
    """Phase 23 (b): the single-process runs here, then two ranks spawned on
    the card over gloo run the same paths over meshes, each held against
    its single-process run; returns each rank's launch counts per path."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, from_random, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.parallel.launch import run_ranks

    write_clips(workdir, 32, seed=0)
    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    want = {}
    for name, n, options, k14 in (("dp2-greedy", MESH_GREEDY_WINDOWS, BASE_OPTIONS, "auto"),
                                  ("dp2-beam5", MESH_BEAM_WINDOWS, BEAM_OPTIONS, "auto"),
                                  # tp runs K14's unfused composition (its hidden rows are split)
                                  ("tp2-greedy", MESH_TP_WINDOWS, BASE_OPTIONS, "off")):
        W.set_int8_mlp_kernel(k14)
        mel = log_mel_spectrogram(make_waves(n, seed=23), device=DEVICE)
        want[name] = mesh_summary(DecodingTask(model, DecodingOptions(**options)).run(mel))
    W.set_int8_mlp_kernel("off")
    del model
    losses = {}
    for name, (_, _, steps, batch) in MESH_TRAIN.items():
        trainer = mesh_trainer((1, 1), False)
        losses[name] = []
        for b in mesh_train_batches(workdir, batch, steps):
            losses[name].append(float(trainer.train_step(b)[0]))
            if len(losses[name]) == 1:
                torch.save({g: v.cpu() for g, v in mesh_group_grads(trainer).items()},
                           os.path.join(workdir, f"{name}.pt"))
        del trainer
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, 2, dict(workdir=workdir), backend="gloo", timeout=900)
    print(f"[mesh] (b) 2 ranks on cuda:0 over gloo: {time.perf_counter() - t0:.1f} s from spawn to the last result "
          f"[{card}]", flush=True)
    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    options = {"dp2-greedy": BASE_OPTIONS, "dp2-beam5": BEAM_OPTIONS, "tp2-greedy": BASE_OPTIONS}
    paths = []
    for name in ("dp2-greedy", "dp2-beam5", "tp2-greedy"):
        r0, r1 = ranks[0][name], ranks[1][name]
        if r0["results"] != r1["results"]:
            raise AssertionError(f"{name}: the ranks' results differ")
        n = r0["windows"]
        print(f"[mesh] {name}: {n} windows, {r0['wall']:.2f} s on rank 0 = {n * 30.0 / r0['wall']:.1f} audio-s/s "
              f"(2 ranks sharing one card); launches rank 0 {json.dumps({k: v for k, v in r0['counts'].items() if v})}, "
              f"rank 1 {json.dumps({k: v for k, v in r1['counts'].items() if v})} [{card}]", flush=True)
        mesh_compare(name, r0["results"], want[name], model, n, options[name], card)
        expect_launched(r0["counts"], ("log_mel", "flash_attention_h2", "decode_attention_i8"), name)
        k14 = r0["counts"]["int8_mlp"] + r1["counts"]["int8_mlp"]
        if (k14 > 0) != name.startswith("dp"):  # K14 on under dp, off under tp (its rows split)
            raise AssertionError(f"{name}: {k14} K14 launches")
        if name == "dp2-beam5":
            expect_launched(r0["counts"], ("topk_logprobs",), name)
        paths += [r0["counts"], r1["counts"]]
    for name, (shape, zero1, steps, batch) in MESH_TRAIN.items():
        r0, r1 = ranks[0][name], ranks[1][name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"], losses[name]))
        worst = min(r0["cos"], key=r0["cos"].get)
        ok = (rel <= MESH_LOSS_TOL and r0["cos"][worst] >= MESH_COS_TOL and r0["losses"] == r1["losses"]
              and r0["checksum"] == r1["checksum"] and r0["zero1"] == zero1)
        print(f"[mesh] {name} train, mesh {shape}{' with ZeRO-1' if zero1 else ''}, {steps} steps at batch {batch}: "
              f"losses {', '.join(f'{x:.5f}' for x in r0['losses'])} vs one process "
              f"{', '.join(f'{x:.5f}' for x in losses[name])}, max rel diff {rel:.2e} (tol {MESH_LOSS_TOL}); first "
              f"step's gradient cosine {', '.join(f'{g} {c:.5f}' for g, c in r0['cos'].items())} (tol "
              f"{MESH_COS_TOL}); step s {', '.join(f'{x:.3f}' for x in r0['walls'])} (the first has the set-up); "
              f"the ranks' weights agree: {r0['checksum'] == r1['checksum']}; launches rank 0 "
              f"{json.dumps({k: v for k, v in r0['counts'].items() if v})} [{card}] {'OK' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise AssertionError(f"{name}: the mesh train steps disagree with one process")
        expect_launched(r0["counts"], ("log_mel", "flash_attention_h2_lse", "flash_attention_h2_bwd",
                                       "flash_attention_lse", "flash_attention_bwd"), name)
        paths += [r0["counts"], r1["counts"]]
    if not np.isfinite([x for r in losses.values() for x in r]).all():
        raise AssertionError("a non-finite loss")
    return paths


class KernelChecks:
    """Phases 24-26 (a): `held` holds a kernel call to its plain version
    (each output of the plain version's shape, finite, within its tolerance,
    and the same bits on a second launch), keeping the worst err/tol by
    kernel and the count of calls; `refused` asserts that a call raises a
    ValueError naming the widths served."""

    def __init__(self):
        self.worst, self.n = {}, 0

    def held(self, name, what, got, want, tol, run):
        import torch

        def listed(x):
            return list(x) if isinstance(x, (tuple, list)) else [x]

        torch.cuda.synchronize()
        for g, w, t in zip(listed(got), listed(want), listed(tol)):
            if g.shape != w.shape:
                raise AssertionError(f"{name} {what}: shape {tuple(g.shape)}, expected {tuple(w.shape)}")
            ratio = ((g.float() - w.float()).abs() / t).max().item()
            if not (ratio <= 1.0 and bool(torch.isfinite(g.float()).all())):
                raise AssertionError(f"{name} {what}: worst err/tol {ratio}")
            self.worst[name] = max(self.worst.get(name, 0.0), ratio)
        if not all(torch.equal(a, b) for a, b in zip(listed(run()), listed(got))):
            raise AssertionError(f"{name} {what}: a second launch gave other bits")
        self.n += 1

    @staticmethod
    def refused(what, fn, served):
        try:
            fn()
        except ValueError as err:
            if served not in str(err):
                raise AssertionError(f"{what} raised without naming the widths served ({served}): {err}")
            return
        raise AssertionError(f"{what} did not raise")


# ------------------------------------------------------------------ phase 24

# every head width that is a multiple of 8 up to 128 and not a class width:
# K1, K2, K7, K7-lse, K8 and the fp32 K5 run it in the smallest class of 32,
# 64 and 128 above it (`ops.width_class`), columns past dh zeros
AW_WIDTHS = (8, 16, 24, 40, 48, 56, 72, 80, 88, 96, 104, 112, 120)
# two published widths at other head counts, depth cut to 2 + 2 layers
# (random weights from seed 0): large-v3's (d 1280, 128 mels, vocab 51866)
# at 16 heads of 80, and small's (d 768) at 8 heads of 96
AW_DIMS = {
    "dh80": dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=16, n_audio_layer=2, n_vocab=51866,
                 n_text_ctx=448, n_text_state=1280, n_text_head=16, n_text_layer=2),
    "dh96": dict(n_mels=80, n_audio_ctx=1500, n_audio_state=768, n_audio_head=8, n_audio_layer=2, n_vocab=51865,
                 n_text_ctx=448, n_text_state=768, n_text_head=8, n_text_layer=2),
}
AW_TRAIN_STEPS = 3
# the kernels every dtype's phase-24 paths must launch (`_f32` in fp32),
# and the fp32 K5, which the dh96 encoder's fp32 passes launch
AW_KERNELS = ("decode_attention_i8", "decode_attention", "flash_attention", "flash_attention_lse",
              "flash_attention_bwd")


def check_any_width_kernels(card: str):
    """Phase 24 (a): at every width of AW_WIDTHS, in bf16 and in fp32, K7
    and K7-lse and K8 (causal (12, 48, dh); 48 queries at q_offset 48 over
    96 keys; non-causal (8, 130, dh) over 300 keys valid to 270), K2 and K1
    (5 heads of dh, so that odd heads start off a 16-byte boundary, over 4
    cache rows of 1536 keys valid to 1499, groups 1 and 5) and the fp32 K5
    (3 heads of dh, (2, 200) over 300 keys valid to 270) against their
    plain versions at phase 21's tolerances, each the same bits on a second
    launch. Not timed: the paths' shapes are timed in (b)."""
    import torch

    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    t0 = time.perf_counter()
    checks = KernelChecks()
    held = checks.held

    for fp32 in (False, True):
        dtype, sfx = (torch.float32, "_f32") if fp32 else (torch.bfloat16, "")
        rel = FP32_REL if fp32 else 2.0**-6

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        for dh in AW_WIDTHS:
            for bh, tq, tk, causal, q_offset, kv in ((12, 48, 48, True, 0, None), (12, 48, 96, True, 48, None),
                                                     (8, 130, 300, False, 0, 270)):
                q, k, v, g = rnd(bh, tq, dh), rnd(bh, tk, dh), rnd(bh, tk, dh), rnd(bh, tq, dh)
                kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv, scale=dh**-0.5)
                what = f"dh {dh} ({bh}, {tq}, {dh}) x {tk} keys, causal {causal}, q_offset {q_offset}, valid {kv}"
                pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
                out_tol = rel * pout.float().abs().max().item()
                lse_tol = FP32_REL * plse.abs().max().item() if fp32 else 1e-4
                held("flash_attention_lse" + sfx, what, FA.flash_attention(q, k, v, return_lse=True, **kw),
                     [pout, plse], [out_tol, lse_tol], lambda: FA.flash_attention(q, k, v, return_lse=True, **kw))
                held("flash_attention" + sfx, what, FA.flash_attention(q, k, v, **kw), pout, out_tol,
                     lambda: FA.flash_attention(q, k, v, **kw))
                want = FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw)
                held("flash_attention_bwd" + sfx, what, FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw), want,
                     [rel * w.float().abs().max().item() for w in want],
                     lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
            n_head, rows = 5, 4
            d = n_head * dh
            ck, cv = rnd(2, rows, 1536, d), rnd(2, rows, 1536, d)
            (k8, ks), (v8, vs) = DA.quantize_kv_rows(ck.float()), DA.quantize_kv_rows(cv.float())
            for group in (1, BEAM):
                q = rnd(rows * group, 1, d)
                kw = dict(scale=dh**-0.5, valid_upto=1499, group=group)
                what = f"dh {dh}, 5 heads, ({rows}, 1536) cache to 1499, group {group}"
                want = DA.decode_attention_plain(q, ck, cv, 1, n_head, **kw)
                held("decode_attention" + sfx, what, DA.decode_attention(q, ck, cv, 1, n_head, **kw), want,
                     (FP32_REL if fp32 else 2.0**-7) * want.float().abs().max().item(),
                     lambda: DA.decode_attention(q, ck, cv, 1, n_head, **kw))
                want, flip = DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 1, n_head, return_flip_bound=True, **kw)
                ref = want.float().abs()
                tol = flip + FP32_REL * ref.max() if fp32 else (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
                held("decode_attention_i8" + sfx, what, DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw),
                     want, tol, lambda: DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw))
            if fp32:
                q, k, v = rnd(2, 200, 3 * dh), rnd(2, 300, 3 * dh), rnd(2, 300, 3 * dh)
                kw = dict(n_head=3, kv_valid_len=270, scale=dh**-0.5)
                want = FA.flash_attention_mh_plain(q, k, v, **kw)
                held("flash_attention_mh_f32", f"dh {dh}, 3 heads, (2, 200) x 300 keys to 270",
                     FA.flash_attention_mh(q, k, v, **kw), want, FP32_REL * want.abs().max().item(),
                     lambda: FA.flash_attention_mh(q, k, v, **kw))
    print(f"[any] (a) {checks.n} kernel calls at head widths {list(AW_WIDTHS)} in bf16 and fp32 against their plain "
          f"versions (phase 21's tolerances), each bitwise on a second launch: worst err/tol "
          f"{json.dumps({k: round(v, 3) for k, v in sorted(checks.worst.items())})}; {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)


def check_any_width_path_kernels(card: str, geometry: str, fp32: bool = False):
    """Phase 24 (b): at one geometry of AW_DIMS and dtype, each attention
    kernel its paths run, at their shapes, against its plain version,
    bitwise on a second launch, timed beside its bound at the true head
    width (bytes and products of dh columns) and SDPA on the same views: K2
    and K1 over the greedy path's cross cache (2 layers x 8 windows x 1500
    keys, int8 padded to 1536 with valid_upto 1499) at group 1 and over the
    beam's 4 windows at group 5; K7-lse and K8 at the train bucket, causal
    (8 x H, 48, dh); K7 at the encoder's (8 x H, 1536, dh) keys valid to
    1500 (dh80: d 1280 is no K5 shape), with lse and K8 there too; K5 at the
    encoder's (8, 1536, 768) (dh96), and K7 at the eval bucket."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dims = AW_DIMS[geometry]
    d, n_head = dims["n_audio_state"], dims["n_audio_head"]
    dh = d // n_head
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    rows = []
    record = make_recorder(card, rows)
    src, b = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", HW_TRAIN_BATCH
    tag = f"{geometry} ({n_head} heads of {dh})"
    scale = dh**-0.5
    dtype, dt, sfx, esz = (torch.float32, "fp32", "_f32", 4) if fp32 else (torch.bfloat16, "bf16", "", 2)
    rel = FP32_REL if fp32 else 2.0**-6

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def bounds(macs, n_bytes, mults=4):
        if fp32:
            return dict(bound=attn_bound(macs, n_bytes, mults, "3xtf32"),
                        ffma_bound=attn_bound(macs, n_bytes, mults, "fp32"))
        return dict(bound=attn_bound(macs, n_bytes, mults))

    def k7_rows(q, k, v, g, kw, lib, case, plain_iters):
        bh, tq, _ = q.shape
        tk = k.shape[1]
        n_keys = kw.get("kv_valid_len") or tk
        if kw.get("causal"):
            pairs = sum(min(n_keys, kw.get("q_offset", 0) + i + 1) for i in range(tq))
        else:
            pairs = tq * n_keys
        io = (2 * q.numel() + 2 * bh * n_keys * dh) * esz
        ql, kl, vl = (x[None].detach().requires_grad_(True) for x in (q, k[:, :n_keys], v[:, :n_keys]))
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        out_tol = rel * pout.float().abs().max().item()
        record("flash_attention" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
               FA.flash_attention(q, k, v, **kw), pout, out_tol,
               lambda: FA.flash_attention(q, k, v, **kw), lambda: FA.flash_attention_plain(q, k, v, **kw),
               **bounds(bh * pairs * dh, io), plain_iters=plain_iters,
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale, **lib), main=False,
               repeat=True)
        record("flash_attention_lse" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
               list(FA.flash_attention(q, k, v, return_lse=True, **kw)), [pout, plse],
               [out_tol, FP32_REL * plse.abs().max().item() if fp32 else 1e-4],
               lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
               lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
               **bounds(bh * pairs * dh, io + plse.numel() * 4), plain_iters=plain_iters,
               library=lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale, **lib), main=False,
               repeat=True)
        want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, scale=scale, **lib)
        record("flash_attention_bwd" + sfx, case, src, "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030",
               list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw)), want,
               [rel * w.float().abs().max().item() for w in want],
               lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
               lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
               **bounds(bh * pairs * dh, 2 * io + 2 * plse.numel() * 4, mults=10), plain_iters=plain_iters,
               library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g[None], retain_graph=True), main=False,
               repeat=True)

    # the decoder's causal self-attention at the train (and eval) bucket 48
    bh = b * n_head
    q, k, v, g = rnd(bh, 48, dh), rnd(bh, 48, dh), rnd(bh, 48, dh), rnd(bh, 48, dh)
    k7_rows(q, k, v, g, dict(causal=True, scale=scale), dict(is_causal=True),
            f"{tag}: causal ({bh}, 48, {dh}) {dt}, the train bucket", 20)
    del q, k, v, g
    # the encoder's self-attention, 8 windows, keys valid to 1500
    if geometry == "dh80":  # d 1280: K7 over split heads (and K7-lse, K8 under autograd)
        q, k, v, g = rnd(bh, 1536, dh), rnd(bh, 1536, dh), rnd(bh, 1536, dh), rnd(bh, 1536, dh)
        k7_rows(q, k, v, g, dict(kv_valid_len=1500, scale=scale), {},
                f"{tag}: encoder ({bh}, 1536, {dh}) {dt}, kv_valid_len 1500", 1)
        del q, k, v, g
    else:  # d 768: K5 over the natural layout
        q, k, v = rnd(b, 1536, d), rnd(b, 1536, d), rnd(b, 1536, d)
        kw = dict(n_head=n_head, kv_valid_len=1500, scale=scale)
        want = FA.flash_attention_mh_plain(q, k, v, **kw)
        qh, kh, vh = heads(q, n_head), heads(k, n_head, 1500), heads(v, n_head, 1500)
        route = "" if fp32 else f", {k5_route(dh, 1536)}"
        record("flash_attention_mh" + sfx, f"{tag}: encoder q,k,v ({b}, 1536, {d}) {dt}, kv_valid_len 1500{route}", src,
               "asr_ttl_mtl_tpu/ops/flash_attention.py:346", FA.flash_attention_mh(q, k, v, **kw), want,
               rel * want.float().abs().max().item(), lambda: FA.flash_attention_mh(q, k, v, **kw),
               lambda: FA.flash_attention_mh_plain(q, k, v, **kw),
               **bounds(b * 1536 * 1500 * d, (2 * q.numel() + 2 * b * 1500 * d) * esz), plain_iters=1,
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=False, repeat=True)
        del q, k, v, want, qh, kh, vh

    # K2 and K1 over the cross cache: 8 windows at group 1, the beam's 4 at group 5
    src = "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu"
    n_layer = dims["n_text_layer"]
    ck, cv = rnd(n_layer, HW_WINDOWS, 1500, d), rnd(n_layer, HW_WINDOWS, 1500, d)
    for n_win, group in ((HW_WINDOWS, 1), (HW_BEAM_WINDOWS, BEAM)):
        ckw, cvw = ck[:, :n_win].contiguous(), cv[:, :n_win].contiguous()
        (k8, ks), (v8, vs) = DA.quantize_kv_rows(ckw.float()), DA.quantize_kv_rows(cvw.float())
        q = rnd(n_win * group, 1, d)
        qh = q.reshape(n_win, group, n_head, dh).transpose(1, 2)
        kh, vh = heads(ckw[1], n_head), heads(cvw[1], n_head)
        kw = dict(scale=scale, group=group)
        want = DA.decode_attention_plain(q, ckw, cvw, 1, n_head, **kw)
        record("decode_attention" + sfx, f"{tag}: cross {tuple(ckw.shape)} {dt}, q ({n_win * group}, 1, {d}), "
               f"group {group}", src, "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
               DA.decode_attention(q, ckw, cvw, 1, n_head, **kw), want,
               (FP32_REL if fp32 else 2.0**-7) * want.float().abs().max().item(),
               lambda: DA.decode_attention(q, ckw, cvw, 1, n_head, **kw),
               lambda: DA.decode_attention_plain(q, ckw, cvw, 1, n_head, **kw),
               bound=attn_bound(n_win * group * 1500 * d, (2 * q.numel() + 2 * n_win * 1500 * d) * esz,
                                kind="fp32" if fp32 else "bf16"),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=False, repeat=True)
        kw8 = dict(scale=scale, valid_upto=1499, group=group)
        want, flip = DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 1, n_head, return_flip_bound=True, **kw8)
        ref = want.float().abs()
        tol = flip + FP32_REL * ref.max() if fp32 else (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        tk_blk = DA._i8_blocks(n_win, k8.shape[2], d)[1]
        record("decode_attention_i8" + sfx, f"{tag}: cross {tuple(k8.shape)} int8, q ({n_win * group}, 1, {d}) "
               f"{dt}, group {group}, valid_upto 1499, tk_blk {tk_blk}", src,
               "asr_ttl_mtl_tpu/ops/decode_attention.py:186",
               DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw8), want, tol,
               lambda: DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw8),
               lambda: DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 1, n_head, **kw8),
               bound=bound(4 * n_win * group * 1500 * d, 2 * n_win * 1500 * (d + 4) + 2 * q.numel() * esz, "int8"),
               main=False, repeat=True)
    del ck, cv
    torch.cuda.empty_cache()
    return rows


def run_any_width(card: str, geometry: str, workdir: str, fp32: bool = False):
    """Phase 24 (c): at one geometry of AW_DIMS, random weights from seed 0,
    through the entry points: the greedy window path on HW_WINDOWS seeded
    windows with phase 4's options (int8 KV: K1; fp32: fp16=False), then
    kv_quant=False (K2); beam 5 on HW_BEAM_WINDOWS windows; AW_TRAIN_STEPS
    train steps at batch HW_TRAIN_BATCH and `evaluate`; then phase 5's
    check of the bf16 decode against the CPU's fp32 plain path on 2
    windows, or phase 20's fp32 decode gate. Each path's launch counts are
    reset just before it and read just after; no K3 or K6 (the h2 kernels
    serve 32, 64 and 128 only), in fp32 no bf16 kernel. Returns the counts
    of each path."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, from_random
    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    dims = AW_DIMS[geometry]
    sfx, dt = ("_f32", "fp32") if fp32 else ("", "bf16")
    tag = f"[any {geometry}{' fp32' if fp32 else ''}]"
    n_layer, n_mels = dims["n_audio_layer"], dims["n_mels"]
    encoder_kernel = ("flash_attention" if geometry == "dh80" else "flash_attention_mh") + sfx
    model = from_random(ModelDimensions(**dims), seed=0, device=DEVICE, dtype=torch.bfloat16)
    paths = {}

    def counted(name, fn):
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        paths[name] = dict(LAUNCHES)
        if fp32:
            no_bf16_kernel(paths[name], f"{tag} {name}")
        h2 = {k: v for k, v in paths[name].items() if k.startswith("flash_attention_h2") and v}
        if h2:
            raise AssertionError(f"{tag} {name} launched the h2 kernels, which serve 32, 64 and 128 only: {h2}")
        return out, time.perf_counter() - t0

    options = {**BASE_OPTIONS, "fp16": not fp32}
    mel = log_mel_spectrogram(make_waves(HW_WINDOWS, seed=0), n_mels=n_mels, device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**options))
    task.run(mel)  # warm-up, not counted
    results, t_dec = counted("greedy", lambda: task.run(log_mel_spectrogram(make_waves(HW_WINDOWS, seed=0),
                                                                            n_mels=n_mels, device=DEVICE)))
    for r in results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob) and np.isfinite(r.no_speech_prob), r
    c = paths["greedy"]
    assert c[encoder_kernel] == n_layer and c["decode_attention_i8" + sfx] > 0 and c["log_mel"] == 1, c
    plain_task = DecodingTask(model, DecodingOptions(**{**options, "kv_quant": False}))
    float_results, t_float = counted("kv_quant=False", lambda: plain_task.run(mel))
    for r in float_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    assert paths["kv_quant=False"]["decode_attention" + sfx] > 0, paths["kv_quant=False"]
    beam_task = DecodingTask(model, DecodingOptions(**{**BEAM_OPTIONS, "fp16": not fp32}))
    beam_results, t_beam = counted("beam", lambda: beam_task.run(mel[:HW_BEAM_WINDOWS].contiguous()))
    for r in beam_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    c = paths["beam"]
    assert c["topk_logprobs"] == 64 and c["decode_attention_i8" + sfx] > 0, c
    print(f"{tag} greedy, {HW_WINDOWS} windows, {'fp16=False, ' if fp32 else ''}kv_quant + int8_encoder, 64 tokens: "
          f"{t_dec:.3f} s = {HW_WINDOWS * 30.0 / t_dec:.1f} audio-s/s (log-mel included); kv_quant=False: "
          f"{t_float:.3f} s; beam {BEAM} on {HW_BEAM_WINDOWS} windows {t_beam:.3f} s (its first call at this shape) "
          f"[{card}]; text[0]={results[0].text[:40]!r} avg_logprob[0]={results[0].avg_logprob:.4f}", flush=True)
    if fp32:
        check_fp32_decode_against_cpu(card, model, what=f" at {geometry}", encoder_kernel=encoder_kernel)
    else:
        check_against_cpu(model)
    del task, plain_task, beam_task, mel, model
    torch.cuda.empty_cache()

    cfg = TrainingConfig(model_size=MODEL, pretrained="random", debug_dims=dims, batch_size=HW_TRAIN_BATCH,
                         val_batch_size=HW_TRAIN_BATCH, compute_dtype="float32" if fp32 else "bfloat16",
                         learning_rate=1e-5, seed=0, num_workers=4, epochs=1,
                         save_dir=os.path.join(workdir, f"{geometry}{sfx}_out"))
    ds = MultiTaskSpeechDataset(write_clips(workdir, AW_TRAIN_STEPS * HW_TRAIN_BATCH, seed=24), cfg)
    batches = list(DataLoader(ds, HW_TRAIN_BATCH, shuffle=True, num_workers=4, drop_last=True, seed=0,
                              buckets=cfg.token_buckets))[:AW_TRAIN_STEPS]
    trainer = MultiTaskTrainer(cfg, verbose=False)
    losses, step_s = [], []
    for i, batch in enumerate(batches):
        (loss, _), dt_s = counted(f"train step {i + 1}", lambda: trainer.train_step(batch))
        c = paths[f"train step {i + 1}"]
        if not (c["log_mel"] == 1 and c["flash_attention_lse" + sfx] > 0 and c["flash_attention_bwd" + sfx] > 0):
            raise AssertionError(f"{tag} train step {i + 1} launched {c}")
        losses.append(float(loss))
        step_s.append(dt_s)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite train loss {losses}")
    metrics, t_eval = counted("evaluate", lambda: trainer.evaluate(batches[:1]))
    if paths["evaluate"]["flash_attention" + sfx] <= 0:
        raise AssertionError(f"{tag} evaluate launched {paths['evaluate']}")
    for key in ("loss", "wer", "disease_acc"):
        if not np.isfinite(metrics[key]):
            raise AssertionError(f"{tag} evaluate: {key} = {metrics[key]}")
    step = {k: v for k, v in paths["train step 2"].items() if v}
    print(f"{tag} train, batch {HW_TRAIN_BATCH}, {dt}, token buckets {[bt['input_tokens'].shape[1] for bt in batches]}: "
          f"{AW_TRAIN_STEPS} steps, losses {', '.join(f'{x:.4f}' for x in losses)}; step s "
          f"{', '.join(f'{x:.4f}' for x in step_s)} (the first has the set-up); evaluate {t_eval:.3f} s, loss "
          f"{metrics['loss']:.4f}; launches in step 2 {json.dumps(step)} [{card}]", flush=True)
    del trainer
    torch.cuda.empty_cache()
    return list(paths.values())


def run_any_width_cli(card: str, workdir: str):
    """Phase 24 (d): random weights from seed 0 at AW_DIMS["dh80"] (bf16)
    written to a `.pt`, and a seeded 30 s WAV through the CLI at one rung
    (beam 5 at t=0): K4 at 128 mels, K7 in the encoder, K2 at group 5 in
    the beam steps, K9. Returns the launch counts."""
    import contextlib
    import io

    import torch

    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, checkpoint_dict, from_random
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    ckpt, clip = os.path.join(workdir, "dh80.pt"), os.path.join(workdir, "clip30.wav")
    torch.save(checkpoint_dict(from_random(ModelDimensions(**AW_DIMS["dh80"]), seed=0, device=DEVICE,
                                           dtype=torch.bfloat16)), ckpt)
    write_long_wav(clip, 30.0, seed=24)
    torch.cuda.empty_cache()
    out = os.path.join(workdir, "dh80_cli")
    printed = io.StringIO()
    sync()
    reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(printed):
        cli([clip, "--model", ckpt, "--output_dir", out, "--language", "en",
             "--temperature_increment_on_fallback", "None"])
    sync()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)
    text = printed.getvalue()
    if "Skipping" in text:
        raise AssertionError(f"the dh80 CLI skipped the file:\n{text[-3000:]}")
    files = sorted(os.listdir(out))
    if files != [f"clip30.{ext}" for ext in ("json", "srt", "tsv", "txt", "vtt")]:
        raise AssertionError(f"the dh80 CLI wrote {files}")
    for name in ("log_mel", "flash_attention", "decode_attention", "topk_logprobs"):
        if counts[name] <= 0:
            raise AssertionError(f"the dh80 CLI run launched no {name}: {counts}")
    print(f"[any] (d) CLI at dh80 (large-v3's widths, 16 heads of 80, 2 + 2 layers), bf16, 30 s WAV at one rung: "
          f"{wall:.1f} s wall; launches {json.dumps({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    return counts


def run_any_widths(card: str):
    """Phase 24: (a), then (b) and (c) at each geometry and dtype, then (d);
    every kernel of AW_KERNELS in each dtype and the fp32 K5 must launch on
    (c) and (d). Returns (the timed rows, the paths' counts)."""
    import torch

    check_any_width_kernels(card)
    rows, paths = [], []
    for geometry in AW_DIMS:
        for fp32 in (False, True):
            rows += check_any_width_path_kernels(card, geometry, fp32)
            with tempfile.TemporaryDirectory() as workdir:
                paths += run_any_width(card, geometry, workdir, fp32)
            torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        paths.append(run_any_width_cli(card, workdir))
    names = [n + s for n in AW_KERNELS for s in ("", "_f32")] + ["flash_attention_mh", "flash_attention_mh_f32"]
    total = {name: sum(c.get(name, 0) for c in paths) for name in names}
    missing = [name for name, n in total.items() if n == 0]
    if missing:
        raise AssertionError(f"no launch of {missing} on phase 24's paths: {total}")
    print(f"[any] launches over phase 24's paths {json.dumps(total)}", flush=True)
    return rows, paths


# ------------------------------------------------------------------ phase 25

# head widths above 128: K1 and K2 run 136-256 in the class of 256
# (`ops.decode_class`), K7, K7-lse, K8 and the fp32 K5 136-768 on the wide
# kernels (`ops.forward_width`), so both serving and training run there
WW_WIDTHS = (136, 200, 256, 384, 768)
WW_DECODE_WIDTHS = (136, 200, 256)
# two published widths at other head counts, depth cut to 2 + 2 layers
# (random weights from seed 0): large-v3's (d 1280, 128 mels, vocab 51866)
# at 5 heads of 256, and small's (d 768) at 4 of 192
WW_DIMS = {
    "dh256": dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=5, n_audio_layer=2, n_vocab=51866,
                  n_text_ctx=448, n_text_state=1280, n_text_head=5, n_text_layer=2),
    "dh192": dict(n_mels=80, n_audio_ctx=1500, n_audio_state=768, n_audio_head=4, n_audio_layer=2, n_vocab=51865,
                  n_text_ctx=448, n_text_state=768, n_text_head=4, n_text_layer=2),
}


def check_wide_kernels(card: str):
    """Phase 25 (a): in bf16 and in fp32, K2 and K1 at head widths 136, 200
    and 256 (5 heads, so that odd heads start off a 16-byte boundary; 2
    cache rows of 1536 keys valid to 1499 at groups 1, 5 and 16, and one row
    at group 1, whose int8 key blocks are 512), K7 and K7-lse at 136, 200,
    256, 384 and 768 (causal (12, 48) at q_offset 0 and over 96 keys at
    q_offset 48, causal (4, 160) (two warpgroups in bf16 up to 256), and
    non-causal (8, 130) over 300 keys valid to 270) and the fp32 K5 at the
    same widths (768 // dh heads, at least one; (2, 200) over 300 keys
    valid to 270) against their plain versions at phase 21's tolerances,
    and K8 (dq, dk, dv from the plain lse at the K7 shapes) within 2^-6 (bf16)
    or FP32_REL (fp32) of its plain version's largest output, each the same
    bits on a second launch; K8, K7, K1 and K2 at 776 must raise naming the
    widths they serve (1-768). Not timed: the paths' shapes are timed in
    (b)."""
    import torch

    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    t0 = time.perf_counter()
    checks = KernelChecks()
    held, refused = checks.held, checks.refused

    for fp32 in (False, True):
        dtype, sfx = (torch.float32, "_f32") if fp32 else (torch.bfloat16, "")
        rel = FP32_REL if fp32 else 2.0**-6

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        for dh in WW_WIDTHS:
            for bh, tq, tk, causal, q_offset, kv in ((12, 48, 48, True, 0, None), (12, 48, 96, True, 48, None),
                                                     (4, 160, 160, True, 0, None), (8, 130, 300, False, 0, 270)):
                q, k, v = rnd(bh, tq, dh), rnd(bh, tk, dh), rnd(bh, tk, dh)
                kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv, scale=dh**-0.5)
                what = f"dh {dh} ({bh}, {tq}, {dh}) x {tk} keys, causal {causal}, q_offset {q_offset}, valid {kv}"
                pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
                out_tol = rel * pout.float().abs().max().item()
                lse_tol = FP32_REL * plse.abs().max().item() if fp32 else 1e-4
                held("flash_attention_lse" + sfx, what, FA.flash_attention(q, k, v, return_lse=True, **kw),
                     [pout, plse], [out_tol, lse_tol], lambda: FA.flash_attention(q, k, v, return_lse=True, **kw))
                held("flash_attention" + sfx, what, FA.flash_attention(q, k, v, **kw), pout, out_tol,
                     lambda: FA.flash_attention(q, k, v, **kw))
                g = rnd(bh, tq, dh)
                want = FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw)
                held("flash_attention_bwd" + sfx, what, FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw), want,
                     [rel * w.float().abs().max().item() for w in want],
                     lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
            n_head = max(1, 768 // dh)
            q, k, v = rnd(2, 200, n_head * dh), rnd(2, 300, n_head * dh), rnd(2, 300, n_head * dh)
            kw = dict(n_head=n_head, kv_valid_len=270, scale=dh**-0.5)
            want = FA.flash_attention_mh_plain(q, k, v, **kw)
            held("flash_attention_mh" + sfx, f"dh {dh}, {n_head} heads, (2, 200) x 300 keys to 270",
                 FA.flash_attention_mh(q, k, v, **kw), want, rel * want.float().abs().max().item(),
                 lambda: FA.flash_attention_mh(q, k, v, **kw))
        n_head = 5
        for dh in WW_DECODE_WIDTHS:
            d = n_head * dh
            for rows, groups in ((2, (1, BEAM, 16)), (1, (1,))):
                ck, cv = rnd(2, rows, 1536, d), rnd(2, rows, 1536, d)
                (k8, ks), (v8, vs) = DA.quantize_kv_rows(ck.float()), DA.quantize_kv_rows(cv.float())
                for group in groups:
                    q = rnd(rows * group, 1, d)
                    kw = dict(scale=dh**-0.5, valid_upto=1499, group=group)
                    what = (f"dh {dh}, 5 heads, ({rows}, 1536) cache to 1499, group {group}, tk_blk "
                            f"{DA._i8_blocks(rows, 1536, d)[1]}")
                    want = DA.decode_attention_plain(q, ck, cv, 1, n_head, **kw)
                    held("decode_attention" + sfx, what, DA.decode_attention(q, ck, cv, 1, n_head, **kw), want,
                         (FP32_REL if fp32 else 2.0**-7) * want.float().abs().max().item(),
                         lambda: DA.decode_attention(q, ck, cv, 1, n_head, **kw))
                    want, flip = DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 1, n_head, return_flip_bound=True,
                                                              **kw)
                    ref = want.float().abs()
                    tol = (flip + FP32_REL * ref.max() if fp32 else
                           (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max())
                    held("decode_attention_i8" + sfx, what,
                         DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw), want, tol,
                         lambda: DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw))
        # the widths past what each kernel serves raise, naming them
        q, k, v = rnd(4, 48, 776), rnd(4, 48, 776), rnd(4, 48, 776)
        lse = torch.zeros((4, 48, 1), device=dev)
        refused(f"K8 {dtype} at 776", lambda: FA.flash_attention_bwd(q, k, v, q, lse, q, causal=True),
                "from 1 to 768")
        refused(f"K7 {dtype} at 776", lambda: FA.flash_attention(q, k, v), "from 1 to 768")
        ck = rnd(1, 1, 1536, 776)
        (k8, ks) = DA.quantize_kv_rows(ck.float())
        q = rnd(1, 1, 776)
        refused(f"K2 {dtype} at 776", lambda: DA.decode_attention(q, ck, ck, 0, 1, scale=1.0), "from 1 to 768")
        refused(f"K1 {dtype} at 776", lambda: DA.decode_attention_i8(q, k8, ks, k8, ks, 0, 1, scale=1.0),
                "from 1 to 768")
    torch.cuda.empty_cache()
    print(f"[wide] (a) {checks.n} kernel calls at head widths {list(WW_WIDTHS)} (K1 / K2 at "
          f"{list(WW_DECODE_WIDTHS)}) in bf16 and fp32 against their plain versions (phase 21's tolerances), each "
          f"bitwise on a second launch, K8, K7, K1 and K2 at 776 refused: worst err/tol "
          f"{json.dumps({k: round(v, 3) for k, v in sorted(checks.worst.items())})}; {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)


def check_wide_path_kernels(card: str, geometry: str, fp32: bool, cli_shapes=(), train_shapes=()):
    """Phase 25 (b): at one geometry of WW_DIMS and dtype, each attention
    kernel its serving paths run, at their shapes, against its plain
    version, bitwise on a second launch, timed beside its bound at the true
    head width and SDPA on the same views (no library call for K1): K7 and
    K7-lse at the dh256 encoder's (8 x 5, 1536, 256) keys valid to 1500 (d
    1280 is no K5 shape), and K7 at the shapes the dh256 CLI run gave it
    (`cli_shapes`: the prompted prefill's causal self-attention and its
    cross-attention over 1500 keys); K5 at the dh192 encoder's (8, 1536,
    768) (bf16: route B; fp32: the fp32 wide forward); K2 and K1 over the
    greedy path's cross cache (2 layers x 8 windows x 1500 keys, int8
    padded to 1536 with valid_upto 1499) at group 1 and over the beam's 4
    windows at group 5; K8 at the shapes the train steps gave it
    (`train_shapes`: the encoder's (8 x H, 1536, dh) keys valid to 1500, the
    train bucket's causal self-attention and its cross over the encoder's
    1500 rows), beside SDPA's backward on the same 4-D views (the backend
    PyTorch picks is named). Rows for the kernels line."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    from asr_ttl_mtl_tpu_torch.ops import decode_class, kernel_width, width_class

    dims = WIDTH_DIMS[geometry]
    d, n_head = dims["n_audio_state"], dims["n_audio_head"]
    dh = d // n_head
    cls = decode_class(dh)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(25)
    rows = []
    record = make_recorder(card, rows)
    src, b = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", HW_WINDOWS
    tag = f"{geometry} ({n_head} heads of {dh})"
    scale = dh**-0.5
    dtype, dt, sfx, esz = (torch.float32, "fp32", "_f32", 4) if fp32 else (torch.bfloat16, "bf16", "", 2)
    rel = FP32_REL if fp32 else 2.0**-6
    width = kernel_width(dh)  # the width K7 and K8 run at: dh rounded up to 8, the extra columns zeros
    if width <= 128:
        fwd = f"width class {width_class(width)}" + (f", laid out at {width}" if width != dh else "")
        bwd_plan = fwd
    else:
        fwd = f"fp32 wide forward {FA.f32_wide_plan(width)}" if fp32 else f"route B {FA.k5_plan(width, 1536)}"
        bwd_plan = f"fp32 wide backward {FA.f32_k8_wide_plan(width)}" if fp32 else f"{FA.k8_wide_plan(width)}"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def bounds(macs, n_bytes, mults=4):
        if fp32:
            return dict(bound=attn_bound(macs, n_bytes, mults, "3xtf32"),
                        ffma_bound=attn_bound(macs, n_bytes, mults, "fp32"))
        return dict(bound=attn_bound(macs, n_bytes, mults))

    def k8_row(q, k, v, g, kw, case, plain_iters):
        bh, tq, _ = q.shape
        n_keys = kw.get("kv_valid_len") or k.shape[1]
        causal = kw.get("causal", False)
        pairs = sum(min(n_keys, i + 1) for i in range(tq)) if causal else tq * n_keys
        io = (2 * q.numel() + 2 * bh * n_keys * dh) * esz
        ql, kl, vl = (x[None].detach().requires_grad_(True) for x in (q, k[:, :n_keys], v[:, :n_keys]))
        lib = dict(scale=scale, is_causal=causal)
        backend = sdpa_backend(ql, kl, vl, **lib)
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, **lib)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        want = list(FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw))
        record("flash_attention_bwd" + sfx, f"{case}, {bwd_plan}; library: SDPA's backward ({backend})", src,
               "asr_ttl_mtl_tpu/ops/flash_attention.py:976,1030",
               list(FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw)), want,
               [rel * w.float().abs().max().item() for w in want],
               lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw),
               lambda: FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw),
               **bounds(bh * pairs * dh, 2 * io + 2 * plse.numel() * 4, mults=10), plain_iters=plain_iters,
               library=lambda: torch.autograd.grad(lib_out, (ql, kl, vl), g[None], retain_graph=True), repeat=True)

    def k7_rows(q, k, v, kw, case, lse, plain_iters):
        bh, tq, _ = q.shape
        n_keys = kw.get("kv_valid_len") or k.shape[1]
        causal = kw.get("causal", False)
        pairs = sum(min(n_keys, i + 1) for i in range(tq)) if causal else tq * n_keys
        seen = min(n_keys, tq) if causal else n_keys
        io = (2 * q.numel() + 2 * bh * seen * dh) * esz
        ql, kl, vl = q[None], k[None, :, :seen], v[None, :, :seen]
        lib = lambda: F.scaled_dot_product_attention(ql, kl, vl, scale=scale, is_causal=causal)
        pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
        out_tol = rel * pout.float().abs().max().item()
        record("flash_attention" + sfx, f"{case}, {fwd}", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:165",
               FA.flash_attention(q, k, v, **kw), pout, out_tol,
               lambda: FA.flash_attention(q, k, v, **kw), lambda: FA.flash_attention_plain(q, k, v, **kw),
               **bounds(bh * pairs * dh, io), plain_iters=plain_iters, library=lib, repeat=True)
        if lse:
            record("flash_attention_lse" + sfx, f"{case}, {fwd}", src, "asr_ttl_mtl_tpu/ops/flash_attention.py:169",
                   list(FA.flash_attention(q, k, v, return_lse=True, **kw)), [pout, plse],
                   [out_tol, FP32_REL * plse.abs().max().item() if fp32 else 1e-4],
                   lambda: FA.flash_attention(q, k, v, return_lse=True, **kw),
                   lambda: FA.flash_attention_plain(q, k, v, return_lse=True, **kw),
                   **bounds(bh * pairs * dh, io + plse.numel() * 4), plain_iters=plain_iters, library=lib,
                   repeat=True)

    if encoder_attention(dims) == "flash_attention":  # no K5 shape: the encoder on K7 over split heads
        bh = b * n_head
        q, k, v = rnd(bh, 1536, dh), rnd(bh, 1536, dh), rnd(bh, 1536, dh)
        k7_rows(q, k, v, dict(kv_valid_len=1500, scale=scale), f"{tag}: encoder ({bh}, 1536, {dh}) {dt}, "
                f"kv_valid_len 1500", True, 1)
        del q, k, v
        for (qs, ks, kv, causal) in sorted(cli_shapes, key=str):
            q, k, v = rnd(*qs), rnd(*ks), rnd(*ks)
            what = "causal self" if causal else "cross"
            k7_rows(q, k, v, dict(causal=causal, kv_valid_len=kv, scale=scale),
                    f"{tag}: the CLI's prompted prefill, {what} {qs} x {ks} {dt}", False, 20)
    else:  # d 768: the encoder on K5 over the natural layout
        q, k, v = rnd(b, 1536, d), rnd(b, 1536, d), rnd(b, 1536, d)
        kw = dict(n_head=n_head, kv_valid_len=1500, scale=scale)
        want = FA.flash_attention_mh_plain(q, k, v, **kw)
        qh, kh, vh = heads(q, n_head), heads(k, n_head, 1500), heads(v, n_head, 1500)
        record("flash_attention_mh" + sfx, f"{tag}: encoder q,k,v ({b}, 1536, {d}) {dt}, kv_valid_len 1500, {fwd}",
               src, "asr_ttl_mtl_tpu/ops/flash_attention.py:346", FA.flash_attention_mh(q, k, v, **kw), want,
               rel * want.float().abs().max().item(), lambda: FA.flash_attention_mh(q, k, v, **kw),
               lambda: FA.flash_attention_mh_plain(q, k, v, **kw),
               **bounds(b * 1536 * 1500 * d, (2 * q.numel() + 2 * b * 1500 * d) * esz), plain_iters=1,
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), repeat=True)
        del q, k, v, want, qh, kh, vh

    # K8 at the train steps' shapes: the encoder, the decoder's causal
    # self-attention and its cross (the largest first)
    for qs, ks, kv, causal in sorted(train_shapes, key=lambda x: (-x[0][1], x[3])):
        q, k, v, g = rnd(*qs), rnd(*ks), rnd(*ks), rnd(*qs)
        what = "causal self" if causal else "encoder" if qs[1] == ks[1] else "cross"
        k8_row(q, k, v, g, dict(causal=causal, kv_valid_len=kv, scale=scale),
               f"{tag}: the train step's {what} {qs} x {ks} {dt}" + (f", kv_valid_len {kv}" if kv else ""),
               1 if qs[1] > 1000 else 20)
        del q, k, v, g

    # K2 and K1 over the cross cache: 8 windows at group 1, the beam's 4 at group 5
    src = "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu"
    n_layer = dims["n_text_layer"]
    ck, cv = rnd(n_layer, HW_WINDOWS, 1500, d), rnd(n_layer, HW_WINDOWS, 1500, d)
    for n_win, group in ((HW_WINDOWS, 1), (HW_BEAM_WINDOWS, BEAM)):
        ckw, cvw = ck[:, :n_win].contiguous(), cv[:, :n_win].contiguous()
        (k8, ks), (v8, vs) = DA.quantize_kv_rows(ckw.float()), DA.quantize_kv_rows(cvw.float())
        q = rnd(n_win * group, 1, d)
        qh = q.reshape(n_win, group, n_head, dh).transpose(1, 2)
        kh, vh = heads(ckw[1], n_head), heads(cvw[1], n_head)
        kw = dict(scale=scale, group=group)
        want = DA.decode_attention_plain(q, ckw, cvw, 1, n_head, **kw)
        split = DA.k2_plan(n_win, n_head, 1500, group, esz, cls)
        record("decode_attention" + sfx, f"{tag}: cross {tuple(ckw.shape)} {dt}, q ({n_win * group}, 1, {d}), "
               f"group {group}, class {cls}, cluster of {split}", src, "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
               DA.decode_attention(q, ckw, cvw, 1, n_head, **kw), want,
               (FP32_REL if fp32 else 2.0**-7) * want.float().abs().max().item(),
               lambda: DA.decode_attention(q, ckw, cvw, 1, n_head, **kw),
               lambda: DA.decode_attention_plain(q, ckw, cvw, 1, n_head, **kw),
               bound=attn_bound(n_win * group * 1500 * d, (2 * q.numel() + 2 * n_win * 1500 * d) * esz,
                                kind="fp32" if fp32 else "bf16"),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), repeat=True)
        kw8 = dict(scale=scale, valid_upto=1499, group=group)
        want, flip = DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 1, n_head, return_flip_bound=True, **kw8)
        ref = want.float().abs()
        tol = flip + FP32_REL * ref.max() if fp32 else (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max()
        tk_blk = DA._i8_blocks(n_win, k8.shape[2], d)[1]
        record("decode_attention_i8" + sfx, f"{tag}: cross {tuple(k8.shape)} int8, q ({n_win * group}, 1, {d}) "
               f"{dt}, group {group}, valid_upto 1499, tk_blk {tk_blk}, class {cls}", src,
               "asr_ttl_mtl_tpu/ops/decode_attention.py:186",
               DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw8), want, tol,
               lambda: DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw8),
               lambda: DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 1, n_head, **kw8),
               bound=bound(4 * n_win * group * 1500 * d, 2 * n_win * 1500 * (d + 4) + 2 * q.numel() * esz, "int8"),
               repeat=True)
    del ck, cv
    torch.cuda.empty_cache()
    return rows


def run_wide_width(card: str, geometry: str, workdir: str, fp32: bool = False):
    """Phase 25 (c): at one geometry of WW_DIMS, random weights from seed 0,
    through the entry points: the greedy window path on HW_WINDOWS seeded
    windows with phase 4's options (int8 KV: K1; fp32: fp16=False), then
    kv_quant=False (K2); beam 5 on HW_BEAM_WINDOWS windows (K1 at group 5);
    then phase 5's check of the bf16 decode against the CPU's fp32 plain
    path on 2 windows, or phase 20's fp32 decode gate. Each path's launch
    counts are reset just before it and read just after; no K3 or K6, in
    fp32 no bf16 kernel. Returns the counts of each path."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, from_random
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    dims = WIDTH_DIMS[geometry]
    sfx = "_f32" if fp32 else ""
    tag = f"[{phase_tag(geometry)} {geometry}{' fp32' if fp32 else ''}]"
    n_layer, n_mels = dims["n_audio_layer"], dims["n_mels"]
    encoder_kernel = encoder_attention(dims) + sfx
    model = from_random(ModelDimensions(**dims), seed=0, device=DEVICE, dtype=torch.bfloat16)
    paths = {}

    def counted(name, fn):
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        paths[name] = dict(LAUNCHES)
        if fp32:
            no_bf16_kernel(paths[name], f"{tag} {name}")
        h2 = {k: v for k, v in paths[name].items() if k.startswith("flash_attention_h2") and v}
        if h2:
            raise AssertionError(f"{tag} {name} launched the h2 kernels, which serve 32, 64 and 128 only: {h2}")
        return out, time.perf_counter() - t0

    options = {**BASE_OPTIONS, "fp16": not fp32}
    mel = log_mel_spectrogram(make_waves(HW_WINDOWS, seed=0), n_mels=n_mels, device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**options))
    task.run(mel)  # warm-up, not counted
    results, t_dec = counted("greedy", lambda: task.run(log_mel_spectrogram(make_waves(HW_WINDOWS, seed=0),
                                                                            n_mels=n_mels, device=DEVICE)))
    for r in results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob) and np.isfinite(r.no_speech_prob), r
    c = paths["greedy"]
    assert c[encoder_kernel] == n_layer and c["decode_attention_i8" + sfx] > 0 and c["log_mel"] == 1, c
    plain_task = DecodingTask(model, DecodingOptions(**{**options, "kv_quant": False}))
    float_results, t_float = counted("kv_quant=False", lambda: plain_task.run(mel))
    for r in float_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    assert paths["kv_quant=False"]["decode_attention" + sfx] > 0, paths["kv_quant=False"]
    beam_task = DecodingTask(model, DecodingOptions(**{**BEAM_OPTIONS, "fp16": not fp32}))
    beam_results, t_beam = counted("beam", lambda: beam_task.run(mel[:HW_BEAM_WINDOWS].contiguous()))
    for r in beam_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    c = paths["beam"]
    assert c["topk_logprobs"] == 64 and c["decode_attention_i8" + sfx] > 0, c
    print(f"{tag} greedy, {HW_WINDOWS} windows, {'fp16=False, ' if fp32 else ''}kv_quant + int8_encoder, 64 tokens: "
          f"{t_dec:.3f} s = {HW_WINDOWS * 30.0 / t_dec:.1f} audio-s/s (log-mel included); kv_quant=False: "
          f"{t_float:.3f} s; beam {BEAM} on {HW_BEAM_WINDOWS} windows {t_beam:.3f} s (its first call at this shape) "
          f"[{card}]; text[0]={results[0].text[:40]!r} avg_logprob[0]={results[0].avg_logprob:.4f}", flush=True)
    if fp32:
        check_fp32_decode_against_cpu(card, model, what=f" at {geometry}", encoder_kernel=encoder_kernel)
    else:
        check_against_cpu(model)
    del task, plain_task, beam_task, mel, model
    torch.cuda.empty_cache()
    return list(paths.values())


def run_wide_training(card: str, geometry: str, workdir: str, fp32: bool = False, ref=None):
    """Phase 25 (c), training: at one geometry of WW_DIMS, MultiTaskTrainer
    with these dims as `debug_dims` (random weights from seed 0), AW_TRAIN_STEPS
    steps at batch HW_TRAIN_BATCH and `evaluate` on the first batch, each
    counted from 0 just before it and read just after: every step launches
    K4 once and K7-lse and K8 once an attention (the encoder's 2 layers, the
    decoder's 2 self and 2 cross: 6), nothing else, so no K3 or K6, and in
    fp32 no bf16 kernel. Then the gates on the 2 clips they take: bf16,
    phase 7's (`check_train_step_against_cpu`, whose CPU step is returned
    as `ref`); fp32, phase 20's against that CPU step. Returns (the counts
    of each path, `ref`, the shapes K8 got in the steps)."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer, TrainingConfig
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    dims = WIDTH_DIMS[geometry]
    sfx, dt, dtype = ("_f32", "fp32", torch.float32) if fp32 else ("", "bf16", torch.bfloat16)
    tag = f"[{phase_tag(geometry)} {geometry}{' fp32' if fp32 else ''}]"
    n_attn = dims["n_audio_layer"] + 2 * dims["n_text_layer"]
    paths = {}

    def counted(name, fn):
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        sync()
        paths[name] = dict(LAUNCHES)
        if fp32:
            no_bf16_kernel(paths[name], f"{tag} {name}")
        h2 = {k: v for k, v in paths[name].items() if k.startswith("flash_attention_h2") and v}
        if h2:
            raise AssertionError(f"{tag} {name} launched the h2 kernels, which serve 32, 64 and 128 only: {h2}")
        return out, time.perf_counter() - t0

    cfg = TrainingConfig(model_size=MODEL, pretrained="random", debug_dims=dims, batch_size=HW_TRAIN_BATCH,
                         val_batch_size=HW_TRAIN_BATCH, compute_dtype="float32" if fp32 else "bfloat16",
                         learning_rate=1e-5, seed=0, num_workers=4, epochs=1,
                         save_dir=os.path.join(workdir, f"{geometry}{sfx}_train"))
    ds = MultiTaskSpeechDataset(write_clips(workdir, AW_TRAIN_STEPS * HW_TRAIN_BATCH, seed=25), cfg)
    batches = list(DataLoader(ds, HW_TRAIN_BATCH, shuffle=True, num_workers=4, drop_last=True, seed=0,
                              buckets=cfg.token_buckets))[:AW_TRAIN_STEPS]
    trainer = MultiTaskTrainer(cfg, verbose=False)
    per_step = {"log_mel": 1, f"flash_attention_lse{sfx}": n_attn, f"flash_attention_bwd{sfx}": n_attn}
    losses, step_s = [], []
    probe = ShapeProbe("flash_attention_bwd", dtype)
    try:
        for i, batch in enumerate(batches):
            (loss, _), dt_s = counted(f"train step {i + 1}", lambda: trainer.train_step(batch))
            launched = {k: v for k, v in paths[f"train step {i + 1}"].items() if v}
            if launched != per_step:
                raise AssertionError(f"{tag} train step {i + 1} launched {launched}, expected {per_step}")
            losses.append(float(loss))
            step_s.append(dt_s)
    finally:
        probe.close()
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite train loss {losses}")
    metrics, t_eval = counted("evaluate", lambda: trainer.evaluate(batches[:1]))
    c = paths["evaluate"]
    if c["flash_attention" + sfx] <= 0 or c["flash_attention_bwd" + sfx] or c["flash_attention_lse" + sfx]:
        raise AssertionError(f"{tag} evaluate launched {c}")
    for key in ("loss", "wer", "disease_acc"):
        if not np.isfinite(metrics[key]):
            raise AssertionError(f"{tag} evaluate: {key} = {metrics[key]}")
    print(f"{tag} train, batch {HW_TRAIN_BATCH}, {dt}, token buckets {[bt['input_tokens'].shape[1] for bt in batches]}: "
          f"{AW_TRAIN_STEPS} steps, losses {', '.join(f'{x:.4f}' for x in losses)}; step s "
          f"{', '.join(f'{x:.4f}' for x in step_s)} (the first has the set-up); evaluate {t_eval:.3f} s, loss "
          f"{metrics['loss']:.4f}, launches {json.dumps({k: v for k, v in c.items() if v})}; launches a step "
          f"{json.dumps(per_step)}; K8 shapes (q, k, kv_valid_len, causal) {sorted(probe.shapes)} [{card}]", flush=True)
    if fp32:  # phase 20's gate against the CPU step of the bf16 trainer's weights
        check_fp32_train_step_against_cpu(card, trainer, ref, what=f"{geometry}, the bf16 trainer's weights, CPU "
                                                                    f"step {ref['cpu_s']:.1f} s")
    else:  # phase 7's gate, whose CPU step the fp32 gate takes too
        ref = check_train_step_against_cpu(card, trainer, batches[0])
    del trainer
    torch.cuda.empty_cache()
    return list(paths.values()), ref, probe.shapes


def run_wide_cli(card: str, workdir: str, fp32: bool, geometry: str = "dh256"):
    """Phase 25 (d) (and phase 26 (c) at dh75): random weights from seed 0
    at WIDTH_DIMS[geometry] (bf16) written to a `.pt`, and a seeded 30 s WAV
    through the CLI at one rung (beam 5 at t=0) with phase 12's 19-token
    prompt carried into every window (fp32: `--fp16 False`): K4, K7 in the
    encoder and the prompted prefill (its causal self-attention and its
    cross over one window), K2 at group 5 in the beam steps, K9. Returns the
    launch counts and the prefill's K7 shapes (q, k, kv_valid_len, causal)
    in the run's dtype, the encoder's taken out."""
    import contextlib
    import io

    import torch

    from asr_ttl_mtl_tpu_torch.cli import cli
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, checkpoint_dict, from_random
    from asr_ttl_mtl_tpu_torch.ops import LAUNCHES, reset_launch_counts

    sfx, dt = ("_f32", torch.float32) if fp32 else ("", torch.bfloat16)
    dims = WIDTH_DIMS[geometry]
    ckpt, clip = os.path.join(workdir, f"{geometry}.pt"), os.path.join(workdir, "clip30.wav")
    if not os.path.exists(ckpt):
        torch.save(checkpoint_dict(from_random(ModelDimensions(**dims), seed=0, device=DEVICE,
                                               dtype=torch.bfloat16)), ckpt)
    if not os.path.exists(clip):
        write_long_wav(clip, 30.0, seed=25)
    torch.cuda.empty_cache()
    out = os.path.join(workdir, f"{geometry}_cli{sfx}")
    label = (f"[{phase_tag(geometry)}] ({'c' if geometry in FW_DIMS else 'd'}) CLI at {geometry} "
             f"({dims['n_text_head']} heads of {dims['n_text_state'] // dims['n_text_head']}, 2 + 2 layers)")
    printed = io.StringIO()
    probe = ShapeProbe("flash_attention", dt)
    try:
        sync()
        reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            cli([clip, "--model", ckpt, "--output_dir", out, "--language", "en", "--fp16", str(not fp32),
                 "--temperature_increment_on_fallback", "None", "--initial_prompt", CLI_PROMPT,
                 "--carry_initial_prompt", "True", "--condition_on_previous_text", "False"])
        sync()
        wall = time.perf_counter() - t0
        counts = dict(LAUNCHES)
    finally:
        probe.close()
    text = printed.getvalue()
    if "Skipping" in text:
        raise AssertionError(f"{label} skipped the file:\n{text[-3000:]}")
    files = sorted(os.listdir(out))
    if files != [f"clip30.{ext}" for ext in ("json", "srt", "tsv", "txt", "vtt")]:
        raise AssertionError(f"{label} wrote {files}")
    if fp32:
        no_bf16_kernel(counts, f"{label} fp32")
    prefill = {s for s in probe.shapes if s[0][1] < 1500}
    if not any(s[3] for s in prefill) or not any(not s[3] for s in prefill):
        raise AssertionError(f"{label}: the prefill ran no causal or no cross K7: {sorted(probe.shapes)}")
    for name in ("log_mel", "flash_attention" + sfx, "decode_attention" + sfx, "topk_logprobs"):
        if counts[name] <= 0:
            raise AssertionError(f"{label} launched no {name}: {counts}")
    print(f"{label}, {'fp32' if fp32 else 'bf16'}, "
          f"30 s WAV at one rung, the 19-token prompt: {wall:.1f} s wall; K7 shapes (q, k, kv_valid_len, causal) "
          f"{sorted(probe.shapes)}; launches {json.dumps({k: v for k, v in counts.items() if v})} [{card}]",
          flush=True)
    return counts, prefill


def run_wide_widths(card: str):
    """Phase 25: (a), then at each geometry and dtype (c) serving and
    training with the gates, at dh256 (d), and (b) at the shapes they ran;
    every kernel of phase 25 must launch on its paths: K1, K2, K7-lse and K8
    at both geometries, K7 at dh256 (the encoder and the CLI's prefill), K5
    at dh192, in both dtypes. Returns (the timed rows, the paths' counts)."""
    import torch

    check_wide_kernels(card)
    rows, paths = [], []
    with tempfile.TemporaryDirectory() as workdir:
        for geometry in WW_DIMS:
            ref = None
            for fp32 in (False, True):
                t0 = time.perf_counter()
                got = run_wide_width(card, geometry, workdir, fp32)
                cli_shapes = ()
                if geometry == "dh256":
                    counts, cli_shapes = run_wide_cli(card, workdir, fp32)
                    got.append(counts)
                torch.cuda.empty_cache()
                trained, ref, train_shapes = run_wide_training(card, geometry, workdir, fp32, ref)
                got += trained
                rows += check_wide_path_kernels(card, geometry, fp32, cli_shapes, train_shapes)
                sfx = "_f32" if fp32 else ""
                names = ["decode_attention_i8" + sfx, "decode_attention" + sfx, "flash_attention_lse" + sfx,
                         "flash_attention_bwd" + sfx,
                         ("flash_attention" if geometry == "dh256" else "flash_attention_mh") + sfx]
                total = {name: sum(c.get(name, 0) for c in got) for name in names}
                if not all(total.values()):
                    raise AssertionError(f"no launch of a phase-25 kernel on the {geometry} "
                                         f"{'fp32' if fp32 else 'bf16'} paths: {total}")
                print(f"[wide] launches over the {geometry} {'fp32' if fp32 else 'bf16'} paths {json.dumps(total)}; "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                paths += got
    return rows, paths


# ------------------------------------------------------------------ phase 26

# every head width up to 768: K1 and K2 from 264 to 768 in the classes of
# 512 and 768 (`ops.decode_class`), and widths off a multiple of 8 in K1 and
# K2 (read in place, in pieces of 8 bytes down to 1) and in K7, K7-lse and K8
# (laid out by the wrappers at `ops.kernel_width(dh)`, zero columns)
FW_DECODE_WIDTHS = (264, 384, 512, 640, 768, 4, 20, 75, 100, 300)
FW_FLASH_WIDTHS = (3, 20, 75, 100, 300, 700)
# two geometries, depth cut to 2 + 2 layers (random weights from seed 0):
# large-v3's widths (d 1280, 128 mels, vocab 51866) at 2 heads of 640, and
# a d of 600 (no preset has it; the JAX package takes it) at 8 heads of 75
FW_DIMS = {
    "dh640": dict(n_mels=128, n_audio_ctx=1500, n_audio_state=1280, n_audio_head=2, n_audio_layer=2, n_vocab=51866,
                  n_text_ctx=448, n_text_state=1280, n_text_head=2, n_text_layer=2),
    "dh75": dict(n_mels=80, n_audio_ctx=1500, n_audio_state=600, n_audio_head=8, n_audio_layer=2, n_vocab=51865,
                 n_text_ctx=448, n_text_state=600, n_text_head=8, n_text_layer=2),
}
# the geometries of phases 25 and 26, which share their path functions
WIDTH_DIMS = {**WW_DIMS, **FW_DIMS}


def phase_tag(geometry: str) -> str:
    return "full" if geometry in FW_DIMS else "wide"


def encoder_attention(dims: dict) -> str:
    """The kernel an encoder of these dims runs its attention on (the bf16
    name): K5 where `mh_flash_eligible` takes the shape, else K7 over split
    heads (d above 768, or a head width off a multiple of 8)."""
    from asr_ttl_mtl_tpu_torch.ops.flash_attention import mh_flash_eligible

    d, n_head, t = dims["n_audio_state"], dims["n_audio_head"], dims["n_audio_ctx"]
    return "flash_attention_mh" if mh_flash_eligible(t, t, d, n_head, False) else "flash_attention"


def check_full_kernels(card: str):
    """Phase 26 (a): in bf16 and in fp32, K2 and K1 at FW_DECODE_WIDTHS (3
    heads, 2 at 640 and 768; 2 cache rows of 1536 keys valid to 1499 at
    groups 1, 5 and 16, and one row at group 1), K7, K7-lse and K8 at
    FW_FLASH_WIDTHS (causal (12, 48) at q_offset 0 and over 96 keys at
    q_offset 48, non-causal (8, 130) over 300 keys valid to 270), each
    against its plain version at phase 21's tolerances (K8 within 2^-6 or
    FP32_REL of its plain version's largest output) and the same bits on a
    second launch; K1, K2, K7 and K8 at a width of 0 must raise naming the
    widths served (1-768). Then the wrappers' pad copy (q, k and v of the
    dh75 encoder, (64, 1536, 75) -> 80 columns) timed alone. Not timed
    otherwise: the paths' shapes are timed in (b) and (c). Returns the pad
    copy's ms."""
    import torch

    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(26)
    t0 = time.perf_counter()
    checks = KernelChecks()
    held, refused = checks.held, checks.refused

    for fp32 in (False, True):
        dtype, sfx = (torch.float32, "_f32") if fp32 else (torch.bfloat16, "")
        rel = FP32_REL if fp32 else 2.0**-6

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)

        for dh in FW_FLASH_WIDTHS:
            for bh, tq, tk, causal, q_offset, kv in ((12, 48, 48, True, 0, None), (12, 48, 96, True, 48, None),
                                                     (8, 130, 300, False, 0, 270)):
                q, k, v = rnd(bh, tq, dh), rnd(bh, tk, dh), rnd(bh, tk, dh)
                kw = dict(causal=causal, q_offset=q_offset, kv_valid_len=kv, scale=dh**-0.5)
                what = f"dh {dh} ({bh}, {tq}, {dh}) x {tk} keys, causal {causal}, q_offset {q_offset}, valid {kv}"
                pout, plse = FA.flash_attention_plain(q, k, v, return_lse=True, **kw)
                out_tol = rel * pout.float().abs().max().item()
                lse_tol = FP32_REL * plse.abs().max().item() if fp32 else 1e-4
                held("flash_attention_lse" + sfx, what, FA.flash_attention(q, k, v, return_lse=True, **kw),
                     [pout, plse], [out_tol, lse_tol], lambda: FA.flash_attention(q, k, v, return_lse=True, **kw))
                held("flash_attention" + sfx, what, FA.flash_attention(q, k, v, **kw), pout, out_tol,
                     lambda: FA.flash_attention(q, k, v, **kw))
                g = rnd(bh, tq, dh)
                want = FA.flash_attention_bwd_plain(q, k, v, pout, plse, g, **kw)
                held("flash_attention_bwd" + sfx, what, FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw), want,
                     [rel * w.float().abs().max().item() for w in want],
                     lambda: FA.flash_attention_bwd(q, k, v, pout, plse, g, **kw))
        for dh in FW_DECODE_WIDTHS:
            n_head = 2 if dh >= 640 else 3
            d = n_head * dh
            for rows, groups in ((2, (1, BEAM, 16)), (1, (1,))):
                ck, cv = rnd(2, rows, 1536, d), rnd(2, rows, 1536, d)
                (k8, ks), (v8, vs) = DA.quantize_kv_rows(ck.float()), DA.quantize_kv_rows(cv.float())
                for group in groups:
                    q = rnd(rows * group, 1, d)
                    kw = dict(scale=dh**-0.5, valid_upto=1499, group=group)
                    what = (f"dh {dh}, {n_head} heads, ({rows}, 1536) cache to 1499, group {group}, tk_blk "
                            f"{DA._i8_blocks(rows, 1536, d)[1]}")
                    want = DA.decode_attention_plain(q, ck, cv, 1, n_head, **kw)
                    held("decode_attention" + sfx, what, DA.decode_attention(q, ck, cv, 1, n_head, **kw), want,
                         (FP32_REL if fp32 else 2.0**-7) * want.float().abs().max().item(),
                         lambda: DA.decode_attention(q, ck, cv, 1, n_head, **kw))
                    want, flip = DA.decode_attention_i8_plain(q, k8, ks, v8, vs, 1, n_head, return_flip_bound=True,
                                                              **kw)
                    ref = want.float().abs()
                    tol = (flip + FP32_REL * ref.max() if fp32 else
                           (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max())
                    held("decode_attention_i8" + sfx, what,
                         DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw), want, tol,
                         lambda: DA.decode_attention_i8(q, k8, ks, v8, vs, 1, n_head, **kw))
        # a width of 0 (d 0 split into 2 heads) raises, naming the widths served
        q, lse = rnd(4, 48, 0), torch.zeros((4, 48, 1), device=dev)
        refused(f"K8 {dtype} at 0", lambda: FA.flash_attention_bwd(q, q, q, q, lse, q, causal=True), "from 1 to 768")
        refused(f"K7 {dtype} at 0", lambda: FA.flash_attention(q, q, q), "from 1 to 768")
        ck, qd = rnd(1, 1, 128, 0), rnd(1, 1, 0)
        sc = torch.ones((1, 1, 128), device=dev)
        refused(f"K2 {dtype} at 0", lambda: DA.decode_attention(qd, ck, ck, 0, 2, scale=1.0), "from 1 to 768")
        refused(f"K1 {dtype} at 0", lambda: DA.decode_attention_i8(qd, ck.to(torch.int8), sc, ck.to(torch.int8), sc,
                                                                   0, 2, scale=1.0), "from 1 to 768")
    # the flash wrappers' copy of a width off a multiple of 8 into rows of
    # kernel_width(dh): q, k and v of the dh75 encoder's K7 call, bf16
    qkv = [torch.randn((HW_WINDOWS * 8, 1536, 75), generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)]
    pad_ms = timed_ms(lambda: FA._padded(qkv))
    del qkv
    torch.cuda.empty_cache()
    print(f"[full] (a) {checks.n} kernel calls, K2 / K1 at {list(FW_DECODE_WIDTHS)} and K7 / K7-lse / K8 at "
          f"{list(FW_FLASH_WIDTHS)}, in bf16 and fp32 against their plain versions (phase 21's tolerances), each "
          f"bitwise on a second launch, K8, K7, K1 and K2 at 0 refused: worst err/tol "
          f"{json.dumps({k: round(v, 3) for k, v in sorted(checks.worst.items())})}; the pad copy of q, k, v "
          f"({HW_WINDOWS * 8}, 1536, 75) bf16 -> 80 columns {pad_ms:.4f} ms; {time.perf_counter() - t0:.1f} s "
          f"[{card}]", flush=True)
    return pad_ms


def run_full_widths(card: str):
    """Phase 26: (a), then at each geometry of FW_DIMS and dtype the serving
    paths with the decode gate (phase 25's `run_wide_width`), at dh75 also
    3 train steps, `evaluate` and the train gates (`run_wide_training`) and
    in bf16 the CLI with the 19-token prompt (`run_wide_cli`), and each
    kernel at the shapes they ran (`check_wide_path_kernels`). The new
    ranges' kernels must launch on the paths: K1 and K2 at both
    geometries, and at dh75 K7, K7-lse and K8, in both dtypes. Returns
    (the timed rows, the paths' counts, the pad copy's ms)."""
    import torch

    pad_ms = check_full_kernels(card)
    rows, paths = [], []
    with tempfile.TemporaryDirectory() as workdir:
        for geometry in FW_DIMS:
            ref = None
            for fp32 in (False, True):
                t0 = time.perf_counter()
                got = run_wide_width(card, geometry, workdir, fp32)
                cli_shapes, train_shapes = (), ()
                if geometry == "dh75":
                    if not fp32:
                        counts, cli_shapes = run_wide_cli(card, workdir, fp32, geometry)
                        got.append(counts)
                    torch.cuda.empty_cache()
                    trained, ref, train_shapes = run_wide_training(card, geometry, workdir, fp32, ref)
                    got += trained
                rows += check_wide_path_kernels(card, geometry, fp32, cli_shapes, train_shapes)
                sfx = "_f32" if fp32 else ""
                names = ["decode_attention_i8" + sfx, "decode_attention" + sfx]
                if geometry == "dh75":
                    names += ["flash_attention" + sfx, "flash_attention_lse" + sfx, "flash_attention_bwd" + sfx]
                total = {name: sum(c.get(name, 0) for c in got) for name in names}
                if not all(total.values()):
                    raise AssertionError(f"no launch of a phase-26 kernel on the {geometry} "
                                         f"{'fp32' if fp32 else 'bf16'} paths: {total}")
                print(f"[full] launches over the {geometry} {'fp32' if fp32 else 'bf16'} paths {json.dumps(total)}; "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
                paths += got
    return rows, paths, pad_ms


# ------------------------------------------------------------------ phase 27

# fp16 serving: an fp16 model (`from_random(..., dtype=torch.float16)`) at
# base's full width and depth, then one batch of FP16_WINDOWS windows at
# each of four geometries, 2 + 2 layers, random weights from seed 0: d 576
# at 9 heads of 64 (K5 over K3's maps at its class), small's d 768 at 8
# heads of 96 (K5's route A) and at 4 of 192 (route B), and large-v3's d
# 1280 at 5 heads of 256 (no K5 shape: K7 on route B's kernel)
FP16_WINDOWS = 8
FP16_DIMS = {"d576": MH_DIMS, "dh96": AW_DIMS["dh96"], "dh192": WW_DIMS["dh192"], "dh256": WW_DIMS["dh256"]}
# the fp16 kernels the serving paths must launch (K10: no path, as in JAX)
FP16_KERNELS = ("decode_attention_i8_f16", "decode_attention_f16", "flash_attention_h2_f16", "flash_attention_mh_f16",
                "flash_attention_f16", "topk_logprobs_f16", "int8_mlp_f16")
# the kernels that stay fp32 whatever the model's dtype, as in JAX: K4, K11, K13, K12
FP32_ONLY = ("log_mel", "median_filter", "dtw_trace", "dtw_paths_batch")


def only_fp16(counts: dict, what: str) -> None:
    """An fp16 model's path launched no bf16 or fp32 kernel but the fp32-only ones."""
    other = {k: v for k, v in counts.items() if v and not k.endswith("_f16") and k not in FP32_ONLY}
    if other:
        raise AssertionError(f"{what} launched kernels of another dtype than fp16: {other}")


def run_fp16_base(card: str, workdir: str):
    """Phase 27 (a)-(c) at base's full width and depth, fp16: (a) phase 4's
    window path (3 batches of 32 windows, int8 KV, W8A8 encoder) with the
    K14 switch off, then on; (b) one batch with kv_quant=False; phase 5's
    gate against the CPU's fp32 plain path; (c) `transcribe` of the 40 s
    WAV with beam 5 at t=0, the 19-token prompt carried into every window
    and word timestamps, then `transcribe_batch` of it with int8 KV, the
    W8A8 encoder and words. Returns (the model, each path's counts, K7's
    fp16 shapes in (c))."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, from_random, log_mel_spectrogram, transcribe_batch
    from asr_ttl_mtl_tpu_torch.models import whisper as W
    from asr_ttl_mtl_tpu_torch.transcribe import transcribe

    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.float16)
    n_layer = model.dims.n_audio_layer
    mel = log_mel_spectrogram(make_waves(N_WINDOWS, seed=0), device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**BASE_OPTIONS))
    assert task.compute_dtype == torch.float16
    audio_s = N_WINDOWS * N_BATCHES * 30.0
    paths, rates = {}, {}
    try:
        for mode in ("off", "auto"):
            W.set_int8_mlp_kernel(mode)
            task.run(mel)  # warm-up, not counted
            (results, t_dec, _), counts = counted(lambda: pipeline(task, mel))
            assert len(results) == N_WINDOWS * N_BATCHES
            for r in results:
                assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob) and np.isfinite(r.no_speech_prob), r
            k14 = n_layer * N_BATCHES if mode == "auto" else 0
            if (counts["flash_attention_h2_f16"] != n_layer * N_BATCHES or counts["decode_attention_i8_f16"] <= 0
                    or counts["int8_mlp_f16"] != k14):
                raise AssertionError(f"[fp16] window path, K14 switch {mode}: launches {counts}")
            only_fp16(counts, f"[fp16] window path, K14 switch {mode}")
            paths[f"window, K14 {mode}"] = counts
            rates[mode] = audio_s / t_dec
            print(f"[fp16] (a) base fp16, {N_BATCHES} batches x {N_WINDOWS} windows, kv_quant + int8_encoder, K14 "
                  f"switch {mode}, 64 tokens: decode {t_dec:.3f} s = {rates[mode]:.1f} audio-s/s [{card}]; launches "
                  f"{json.dumps({k: v for k, v in counts.items() if v})}; text[0]={results[0].text[:40]!r} "
                  f"avg_logprob[0]={results[0].avg_logprob:.4f}", flush=True)
    finally:
        W.set_int8_mlp_kernel("off")
    # the loop is host-bound and the host's cores are shared: repeat to show the spread, as phase 4
    more = sorted(audio_s / pipeline(task, mel)[1] for _ in range(4))
    print(f"[fp16] (a) 4 more runs, K14 switch off: {', '.join(f'{r:.1f}' for r in more)} audio-s/s "
          f"(median {statistics.median(more):.1f}) [{card}]", flush=True)
    plain_task = DecodingTask(model, DecodingOptions(**{**BASE_OPTIONS, "kv_quant": False}))
    plain_task.run(mel)  # warm-up
    t0 = time.perf_counter()
    float_results, counts = counted(lambda: plain_task.run(mel))
    t_float = time.perf_counter() - t0
    for r in float_results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    if counts["decode_attention_f16"] <= 0 or counts["flash_attention_h2_f16"] != n_layer:
        raise AssertionError(f"[fp16] kv_quant=False: launches {counts}")
    only_fp16(counts, "[fp16] kv_quant=False")
    paths["kv_quant=False"] = counts
    print(f"[fp16] (b) kv_quant=False, 1 batch: {t_float:.3f} s = {N_WINDOWS * 30.0 / t_float:.1f} audio-s/s "
          f"[{card}]; launches {json.dumps({k: v for k, v in counts.items() if v})}", flush=True)
    check_against_cpu(model)

    clip = os.path.join(workdir, "clip70.wav")
    write_long_wav(clip, LONG_WAV_S, seed=0)
    probe = ShapeProbe("flash_attention", torch.float16)
    try:
        t0 = time.perf_counter()
        result, counts = counted(lambda: transcribe(
            model, clip, language="en", beam_size=BEAM, temperature=0.0, initial_prompt=CLI_PROMPT,
            carry_initial_prompt=True, condition_on_previous_text=False, word_timestamps=True))
        wall = time.perf_counter() - t0
    finally:
        probe.close()
    segments = result["segments"]
    seeks = sorted({s["seek"] for s in segments})
    words = [w for s in segments for w in s.get("words", [])]
    if len(seeks) < 2 or not words or not all(w["start"] <= w["end"] for w in words):
        raise AssertionError(f"[fp16] transcribe: {len(segments)} segments from windows {seeks}, {len(words)} words")
    expect_launched(counts, ("log_mel", "flash_attention_h2_f16", "flash_attention_f16", "decode_attention_f16",
                             "topk_logprobs_f16", "median_filter", "dtw_trace"), "[fp16] transcribe")
    only_fp16(counts, "[fp16] transcribe")
    paths["transcribe"] = counts
    print(f"[fp16] (c) transcribe, base fp16, {LONG_WAV_S:.0f} s WAV, beam {BEAM} at t=0, the 19-token prompt "
          f"carried, word timestamps: {wall:.1f} s wall; {len(segments)} segments from windows at seek {seeks}, "
          f"{len(words)} words; K7 fp16 shapes (q, k, kv_valid_len, causal) {sorted(probe.shapes)}; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    # the batched entry on the same WAV: windows at fixed strides, int8 KV,
    # the W8A8 encoder, words aligned in a batch (K12)
    t0 = time.perf_counter()
    outs, counts = counted(lambda: transcribe_batch(model, [clip], batch_size=16, temperature=0.0, language="en",
                                                    kv_quant=True, int8_encoder=True, word_timestamps=True))
    wall = time.perf_counter() - t0
    words = [w for s in outs[0]["segments"] for w in s.get("words", [])]
    if not words or not all(w["start"] <= w["end"] for w in words):
        raise AssertionError(f"[fp16] transcribe_batch: {len(outs[0]['segments'])} segments, {len(words)} words")
    expect_launched(counts, ("log_mel", "flash_attention_h2_f16", "decode_attention_i8_f16", "dtw_paths_batch"),
                    "[fp16] transcribe_batch")
    only_fp16(counts, "[fp16] transcribe_batch")
    paths["transcribe_batch"] = counts
    print(f"[fp16] (c) transcribe_batch, the same WAV, batch 16 at t=0, kv_quant + int8_encoder, word timestamps: "
          f"{wall:.1f} s wall; {len(outs[0]['segments'])} segments, {len(words)} words; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    return model, paths, probe.shapes


def run_fp16_geometry(card: str, geometry: str):
    """Phase 27 (d)-(g): one batch of FP16_WINDOWS seeded windows at a
    geometry of FP16_DIMS, fp16, phase 4's options with the 19-token prompt
    (so the prefill's causal self-attention runs K7), the encoder on K5 (or
    K7 where `mh_flash_eligible` rejects the shape). Returns (the counts,
    the fp16 shapes K5 and K7 got)."""
    import numpy as np
    import torch

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, log_mel_spectrogram
    from asr_ttl_mtl_tpu_torch.models import ModelDimensions, from_random

    dims = FP16_DIMS[geometry]
    model = from_random(ModelDimensions(**dims), seed=0, device=DEVICE, dtype=torch.float16)
    mel = log_mel_spectrogram(make_waves(FP16_WINDOWS, seed=0), n_mels=dims["n_mels"], device=DEVICE)
    task = DecodingTask(model, DecodingOptions(**BASE_OPTIONS, prompt=CLI_PROMPT))
    task.run(mel)  # warm-up, not counted
    probes = {name: ShapeProbe(name, torch.float16) for name in ("flash_attention_mh", "flash_attention")}
    try:
        t0 = time.perf_counter()
        results, counts = counted(lambda: task.run(mel))
        wall = time.perf_counter() - t0
    finally:
        for p in probes.values():
            p.close()
    for r in results:
        assert len(r.tokens) == 64 and np.isfinite(r.avg_logprob), r
    encoder = encoder_attention(dims) + "_f16"
    expect_launched(counts, (encoder, "flash_attention_f16", "decode_attention_i8_f16"), f"[fp16] {geometry}")
    only_fp16(counts, f"[fp16] {geometry}")
    print(f"[fp16] {geometry} ({dims['n_audio_head']} heads of {dims['n_audio_state'] // dims['n_audio_head']}, 2 + 2 "
          f"layers), 1 batch of {FP16_WINDOWS} windows, kv_quant + int8_encoder, the 19-token prompt: {wall:.3f} s; "
          f"K5 shapes {sorted(probes['flash_attention_mh'].shapes)}, "
          f"K7 shapes {sorted(probes['flash_attention'].shapes)}; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})} [{card}]", flush=True)
    del task, model
    torch.cuda.empty_cache()
    return counts, {name: p.shapes for name, p in probes.items()}


def check_fp16_kernels(card: str, model, k7_shapes, k5_shapes):
    """Phase 27 (h): each fp16 kernel against its plain version at the
    paths' shapes, at its bf16 twin's tolerance (fp16 rounds finer), the
    same bits on a second launch, timed beside its bound (fp16's dense peak
    is bf16's), the plain version and the library call (SDPA in fp16; for
    K9 torch.topk of log_softmax, for K10 torch.topk): K3 at the encoder's
    (32, 1536, 512), K1 over the window path's int8 cross store and self
    cache, K2 over its fp16 caches (kv_quant=False) and over the beam's one
    window at group 5 (transcribe), K9 and K10 at the beam's 5 rows and the
    beam slice's 160, K7 and K5 at every fp16 shape (c)-(g) gave them, and
    K14 at (32 x 1536, 512) rows through base's first encoder MLP."""
    import torch
    import torch.nn.functional as F

    from asr_ttl_mtl_tpu_torch.ops import decode_attention as DA
    from asr_ttl_mtl_tpu_torch.ops import flash_attention as FA
    from asr_ttl_mtl_tpu_torch.ops import forward_width
    from asr_ttl_mtl_tpu_torch.ops import topk as T
    from asr_ttl_mtl_tpu_torch.scripts.card_timing import graph_ms

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(27)
    rows = []
    record = make_recorder(card, rows)
    fa_src, da_src = "asr_ttl_mtl_tpu_torch/csrc/flash_attention.cu", "asr_ttl_mtl_tpu_torch/csrc/decode_attention.cu"

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).half()

    # K3 at the encoder's shape
    q, k, v = (rnd(N_WINDOWS, 1536, 512) for _ in range(3))
    kw = dict(n_head=8, kv_valid_len=1500, scale=0.125)
    want = FA.flash_attention_h2_plain(q, k, v, **kw)
    qh, kh, vh = (heads(x, 8, 1500 if x is not q else None) for x in (q, k, v))
    record("flash_attention_h2_f16", "q,k,v (32, 1536, 512) fp16, kv_valid_len 1500 (the encoder)", fa_src,
           "asr_ttl_mtl_tpu/ops/flash_attention.py:514", FA.flash_attention_h2(q, k, v, **kw), want,
           2.0**-6 * want.float().abs().max().item(), lambda: FA.flash_attention_h2(q, k, v, **kw),
           lambda: FA.flash_attention_h2_plain(q, k, v, **kw),
           bound=attn_bound(N_WINDOWS * 1536 * 1500 * 512, (2 * q.numel() + 2 * 32 * 1500 * 512) * 2, kind="fp16"),
           library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=0.125), repeat=True)
    del q, k, v, want, qh, kh, vh

    # K5 and K7 at the shapes the paths gave them, natural layout (K5) or
    # head-split (K7), q_offset 0: keys to kv_valid_len, causal keys up to the query
    for name, shapes in (("flash_attention_mh_f16", k5_shapes), ("flash_attention_f16", k7_shapes)):
        main = True
        for geometry, (qs, ks, kv_len, causal) in sorted(shapes, key=lambda x: (x[0] != "base", x[0], str(x[1]))):
            n_keys = kv_len or ks[1]
            q, k, v = rnd(*qs), rnd(*ks), rnd(*ks)
            if name == "flash_attention_mh_f16":
                n_head = FP16_DIMS[geometry]["n_audio_head"]
                dh = qs[2] // n_head
                kw = dict(n_head=n_head, kv_valid_len=kv_len, scale=dh**-0.5)
                run = lambda: FA.flash_attention_mh(q, k, v, **kw)  # noqa: E731
                plain = lambda: FA.flash_attention_mh_plain(q, k, v, **kw)  # noqa: E731
                qh, kh, vh = heads(q, n_head), heads(k, n_head, n_keys), heads(v, n_head, n_keys)
                library = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=dh**-0.5)  # noqa: E731
                macs = qs[0] * qs[1] * n_keys * qs[2]
                case = (f"{geometry}: q {qs} x k {ks}, {n_head} heads of {dh}, keys to {n_keys}, "
                        f"{k5_route(dh, qs[1])}")
                replaces = "asr_ttl_mtl_tpu/ops/flash_attention.py:346"
                n_bytes = (2 * q.numel() + 2 * qs[0] * n_keys * qs[2]) * 2
            else:
                dh = qs[2]
                kw = dict(causal=causal, kv_valid_len=kv_len, scale=dh**-0.5)
                run = lambda: FA.flash_attention(q, k, v, **kw)  # noqa: E731
                plain = lambda: FA.flash_attention_plain(q, k, v, **kw)  # noqa: E731
                seen = qs[1] if causal else n_keys  # causal, q_offset 0: the first tq keys
                library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    q[None], k[None, :, :seen], v[None, :, :seen], is_causal=causal, scale=dh**-0.5)
                macs = qs[0] * (qs[1] * (qs[1] + 1) // 2 if causal else qs[1] * n_keys) * dh
                case = (f"{geometry}: q {qs} x k {ks}, {'causal' if causal else f'keys to {n_keys}'}, "
                        f"{'class ' + str(forward_width(dh)) if dh <= 128 else 'route B'}")
                replaces = "asr_ttl_mtl_tpu/ops/flash_attention.py:165"
                n_bytes = (2 * q.numel() + 2 * qs[0] * seen * dh) * 2
            want = plain()
            record(name, case, fa_src, replaces, run(), want, 2.0**-6 * want.float().abs().max().item(), run, plain,
                   bound=attn_bound(macs, n_bytes, kind="fp16"), library=library, main=main, repeat=True)
            main = False
            del q, k, v, want

    # K1 and K2 at the window path's caches and the beam's one window
    scale = 64**-0.5
    qd = rnd(N_WINDOWS, 1, 512)
    cross_k, cross_v = rnd(6, N_WINDOWS, 1500, 512), rnd(6, N_WINDOWS, 1500, 512)
    self_k, self_v = rnd(6, N_WINDOWS, 128, 512), rnd(6, N_WINDOWS, 128, 512)
    for case, q, ck, cv, valid, group, main in (
        ("cross (6,32,1500,512) fp16 (kv_quant=False)", qd, cross_k, cross_v, None, 1, True),
        ("self (6,32,128,512) fp16, valid_upto 70", qd, self_k, self_v, 70, 1, False),
        (f"cross (6,1,1500,512) fp16, q ({BEAM},1,512), group {BEAM} (transcribe's beam)", rnd(BEAM, 1, 512),
         cross_k[:, :1].contiguous(), cross_v[:, :1].contiguous(), None, BEAM, False),
    ):
        b = ck.shape[1]
        kw = dict(scale=scale, valid_upto=valid, group=group)
        n_keys = ck.shape[2] if valid is None else valid + 1
        want = DA.decode_attention_plain(q, ck, cv, 5, 8, **kw)
        qh = q.reshape(b, group, 8, 64).transpose(1, 2)
        kh, vh = heads(ck[5], 8, n_keys), heads(cv[5], 8, n_keys)
        record("decode_attention_f16", case, da_src, "asr_ttl_mtl_tpu/ops/decode_attention.py:39",
               DA.decode_attention(q, ck, cv, 5, 8, **kw), want, 2.0**-7 * want.float().abs().max().item(),
               lambda: DA.decode_attention(q, ck, cv, 5, 8, **kw),
               lambda: DA.decode_attention_plain(q, ck, cv, 5, 8, **kw),
               bound=attn_bound(b * group * n_keys * 512, 2 * b * n_keys * 512 * 2, kind="fp16"),
               library=lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale), main=main, repeat=True)
    for case, kv, valid, main in (("cross (6,32,1536,512) int8, q (32,1,512) fp16, valid_upto 1499", (cross_k, cross_v),
                                   1499, True),
                                  ("self (6,32,128,512) int8, q (32,1,512) fp16, valid_upto 70", (self_k, self_v), 70,
                                   False)):
        args = (*DA.quantize_kv_rows(kv[0]), *DA.quantize_kv_rows(kv[1]))
        kw = dict(scale=scale, valid_upto=valid)
        want, flip = DA.decode_attention_i8_plain(qd, *args, 5, 8, return_flip_bound=True, **kw)
        ref = want.float().abs()
        record("decode_attention_i8_f16", case, da_src, "asr_ttl_mtl_tpu/ops/decode_attention.py:186",
               DA.decode_attention_i8(qd, *args, 5, 8, **kw), want,
               (1 + 2.0**-7) * flip + 2.0**-7 * ref + 1e-5 * ref.max(),
               lambda: DA.decode_attention_i8(qd, *args, 5, 8, **kw),
               lambda: DA.decode_attention_i8_plain(qd, *args, 5, 8, **kw),
               bound=bound(4 * N_WINDOWS * (valid + 1) * 512, 2 * N_WINDOWS * (valid + 1) * (512 + 4), "int8"),
               main=main, repeat=True)
    del cross_k, cross_v, self_k, self_v

    # K9 and K10 over fp16 rows as the beam step sees them at step 0: the
    # filters' -inf (fp16's fill) on the suppressed and text lanes
    n_vocab = model.dims.n_vocab
    x = (torch.randn((N_WINDOWS * BEAM, n_vocab), generator=gen, device=dev) * 2.0).half()
    x[:, 100:50257] = float("-inf")
    x[:, [50300, 50400]] = x.amax(dim=-1, keepdim=True) + 0.5  # a tie at the top
    x[2] = float("-inf")
    x[2, [11, 12, 13]] = 1.0  # fewer than k finite values
    k = BEAM + 1

    def log_softmax_topk(xt):
        return torch.topk(xt.float().log_softmax(-1), k)

    for name, fn, plain, lib, n_rows, main in (
        ("topk_logprobs_f16", T.topk_logprobs, T.topk_logprobs_plain, log_softmax_topk, BEAM, True),
        ("topk_logprobs_f16", T.topk_logprobs, T.topk_logprobs_plain, log_softmax_topk, N_WINDOWS * BEAM, False),
        ("topk_f16", T.topk, T.topk_plain, lambda xt: torch.topk(xt.float(), k), BEAM, True),
    ):
        xt = x[:n_rows].contiguous()
        (gv, gi), (pv, pi), (av, ai) = fn(xt, k), plain(xt, k), fn(xt, k)
        if not (torch.equal(av.view(torch.int32), gv.view(torch.int32)) and torch.equal(ai, gi)):
            raise AssertionError(f"{name} ({n_rows}): a second launch gave other bits")
        if not torch.equal(torch.isfinite(gv), torch.isfinite(pv)):
            raise AssertionError(f"{name}: -inf values at other places than the plain version's")
        v_tol = 4e-6 * pv.abs().clamp(min=1.0) if name == "topk_logprobs_f16" else torch.full_like(pv, 1e-30)
        split = T.k9_plan(n_rows, n_vocab, *T._card_limits(dev.index or 0))
        record(name, f"({n_rows}, {n_vocab}) fp16 with -inf lanes, k {k}, cluster of {split}",
               "asr_ttl_mtl_tpu_torch/csrc/topk.cu",
               f"asr_ttl_mtl_tpu/ops/pallas_topk.py:{51 if 'logprobs' in name else 32}",
               [torch.nan_to_num(gv, neginf=-3e38), gi], [torch.nan_to_num(pv, neginf=-3e38), pi], [v_tol, 0.5],
               lambda: fn(xt, k), lambda: plain(xt, k),
               bound=bound(xt.numel() * (3 if "logprobs" in name else 1), xt.numel() * 2 + n_rows * k * 8, "fp32"),
               library=lambda: lib(xt), main=main)  # bitwise again: held above, on the values before nan_to_num
        # microseconds, less than the wrapper's host work: the device times too, as phase 9
        rows[-1]["device_ms"], rows[-1]["library_device_ms"] = graph_ms(lambda: fn(xt, k)), graph_ms(lambda: lib(xt))
    del x
    rows += check_int8_mlp(card, model, torch.float16)
    return rows


def run_fp16(card: str):
    """Phase 27: fp16 serving on the card. Returns (kernel rows, each
    path's launch counts)."""
    import torch

    with tempfile.TemporaryDirectory() as workdir:
        model, paths, k7_shapes = run_fp16_base(card, workdir)
    k7 = {("base", s) for s in k7_shapes}
    k5 = set()
    for geometry in FP16_DIMS:
        counts, shapes = run_fp16_geometry(card, geometry)
        paths[geometry] = counts
        k5 |= {(geometry, s) for s in shapes["flash_attention_mh"]}
        k7 |= {(geometry, s) for s in shapes["flash_attention"]}
    total = {}
    for counts in paths.values():
        add_counts(total, counts)
    expect_launched(total, FP16_KERNELS, "phase 27's paths")
    print(f"[fp16] launches over phase 27's paths {json.dumps({k: v for k, v in total.items() if v})}", flush=True)
    rows = check_fp16_kernels(card, model, k7, k5)
    del model
    torch.cuda.empty_cache()
    return rows, list(paths.values())



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

    from asr_ttl_mtl_tpu_torch.scripts.card_timing import card_line

    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        print(f"[time] {what} at {time.perf_counter() - t_start:.1f} s", flush=True)

    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} devices {torch.cuda.device_count()}",
          flush=True)

    from asr_ttl_mtl_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.build_all()
    print(f"[build] {len(_cuda.SOURCES)} sources built in {time.perf_counter() - t0:.1f} s", flush=True)
    for name in _cuda.SOURCES:
        entry = "?"
        for line in _cuda.ptxas_report(name).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line:  # registers and smem, or stack and spills
                print(f"[ptxas {name}] {entry}: {line.strip()}", flush=True)

    rows = check_kernels(card)
    model, main_counts, k2_counts, slice_rate = run_slice(card)
    check_against_cpu(model)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        trainer, batch, train_counts, eval_counts, buckets = run_training(card, workdir)
        ref7 = check_train_step_against_cpu(card, trainer, batch)
    del trainer, batch
    torch.cuda.empty_cache()
    rows += check_train_kernels(card, *buckets)

    from asr_ttl_mtl_tpu_torch import DecodingOptions, DecodingTask, from_random

    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    rows += check_topk_kernels(card, DecodingTask(model, DecodingOptions(**BEAM_OPTIONS)).filter_cfg)
    beam_counts = run_beam_slice(card, model)
    check_beam_against_cpu(model)
    with tempfile.TemporaryDirectory() as workdir:
        cli_counts, prefill = run_cli(card, model, workdir)
        words_counts, probes = run_words_cli(card, workdir)
        batch_counts, batch_probe, batch_c = run_batch(card, model, workdir)
    rows += check_prefill_kernels(card, *prefill)
    rows += check_words_kernels(card, probes)
    rows += check_batch_kernels(card, batch_probe)

    int8_counts = run_int8_mlp(card, model, slice_rate)
    rows += check_int8_mlp(card, model)
    del model
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as workdir:
        write_long_wav(os.path.join(workdir, "clip70.wav"), LONG_WAV_S, seed=0)
        mh_cli_counts, mh_shapes = run_mh_cli(card, workdir)
        mh_train_counts, mh_train_shapes = run_mh_training(card, workdir)
    rows += check_mh_kernels(card, mh_shapes, mh_train_shapes)

    stamp("phase 20 starts")
    # phase 20, fp32 on the card, with cuDNN's default allow_tf32=True back:
    # the conv stem's own guard is what keeps it in fp32
    torch.backends.cudnn.allow_tf32 = True
    fp32_slice_counts, k5_shapes = run_fp32_slice(card, slice_rate)
    model = from_random(MODEL, seed=0, device=DEVICE, dtype=torch.bfloat16)
    with tempfile.TemporaryDirectory() as workdir:
        fp32_cli_counts, cli_k7_shapes = run_fp32_cli(card, model, workdir)
    with tempfile.TemporaryDirectory() as workdir:
        trainer, _, fp32_train_counts, fp32_eval_counts, buckets32 = run_training(card, workdir, "float32")
        check_fp32_train_step_against_cpu(card, trainer, ref7)
    del trainer, ref7
    torch.cuda.empty_cache()
    check_conv_stem_fp32(card, model)
    check_fp32_decode_against_cpu(card, model)
    rows += check_fp32_kernels(card, *buckets32, cli_k7_shapes, k5_shapes, model)
    torch.backends.cudnn.allow_tf32 = False
    del model
    torch.cuda.empty_cache()

    # phase 21: head widths 128 and 32 at base's depth and width, bf16 then fp32
    stamp("phase 21 starts")
    hw_paths = []
    for geometry in HW_DIMS:
        rows += check_head_width_kernels(card, geometry)
        with tempfile.TemporaryDirectory() as workdir:
            hw_paths += run_head_width(card, geometry, workdir)
        rows += check_head_width_kernels(card, geometry, fp32=True)
        with tempfile.TemporaryDirectory() as workdir:
            hw_paths += run_head_width(card, geometry, workdir, fp32=True)

    # phase 22: files in, reports out, at base
    stamp("phase 22 starts")
    files_counts = run_files(card)

    # phase 23: multi-device at base, NCCL at world size 1 and 2 ranks on the card over gloo
    stamp("phase 23 starts")
    mesh_paths = [run_mesh_world1(card, *batch_c)]
    with tempfile.TemporaryDirectory() as workdir:
        mesh_paths += run_multi_device(card, workdir)

    # phase 24: every head width that is a multiple of 8 up to 128, at 16
    # heads of 80 (large-v3's widths) and 8 of 96 (small's), bf16 and fp32
    stamp("phase 24 starts")
    aw_rows, aw_paths = run_any_widths(card)
    rows += aw_rows

    # phase 25: head widths above 128 for serving and training, at 5 heads
    # of 256 (large-v3's widths) and 4 of 192 (small's), bf16 and fp32
    stamp("phase 25 starts")
    ww_rows, ww_paths = run_wide_widths(card)
    rows += ww_rows

    # phase 26: every head width up to 768, at 2 heads of 640 (large-v3's
    # widths) and 8 of 75 (d 600), bf16 and fp32
    stamp("phase 26 starts")
    fw_rows, fw_paths, _ = run_full_widths(card)
    rows += fw_rows

    # phase 27: fp16 serving, at base's full width and depth and at d 576,
    # 8 heads of 96, 4 of 192 and 5 of 256
    stamp("phase 27 starts")
    f16_rows, f16_paths = run_fp16(card)
    rows += f16_rows

    # launches: the sum over the main paths (decode slice, kv_quant=False
    # batch, train steps, evaluate, beam slice, the CLI's runs, the words
    # runs, the batched runs, the K14 window path, the d=576 CLI run and
    # train steps, and phase 20's fp32 window paths, CLI run, train steps
    # and evaluate, and phase 21's greedy, kv_quant=False, beam, train and
    # evaluate runs at head widths 128 and 32 in bf16 and in fp32, and phase 22's train steps,
    # twins, profiled epoch, resumed runs and CLI runs, and phase 23's mesh
    # runs, each rank's counts, and phase 24's runs at 16 heads of 80 and 8
    # of 96 and its CLI run, and phase 25's serving, train and evaluate runs
    # at 5 heads of 256 and 4 of 192 and its CLI runs, and phase 26's
    # serving runs at 2 heads of 640 and 8 of 75 and its train, evaluate and
    # CLI runs at 8 of 75, and phase 27's fp16 window paths, kv_quant=False
    # batch, transcribe run and batches at its four geometries), each
    # counted from 0 just before it ran
    paths = (main_counts, k2_counts, train_counts, eval_counts, beam_counts, cli_counts, words_counts, batch_counts,
             int8_counts, mh_cli_counts, mh_train_counts, fp32_slice_counts, fp32_cli_counts, fp32_train_counts,
             fp32_eval_counts, *hw_paths, files_counts, *mesh_paths, *aw_paths, *ww_paths, *fw_paths, *f16_paths)
    launches = {name: sum(c.get(name, 0) for c in paths) for name in main_counts}
    kernels = []
    for r in rows:
        if r.pop("main"):
            kernels.append({**r, "launches": launches[r["name"]]})
    for k in kernels:
        if k["name"] in ("topk", "topk_f16"):
            k["path"] = "none: as in the JAX package, no path calls topk_pallas (tests only)"
    names = [k["name"] for k in kernels]
    cases = [(k["name"], k["case"]) for k in kernels]
    if len(set(cases)) != len(cases) or set(names) != set(launches):
        raise AssertionError(f"the kernels line needs a row for every kernel: {names} against {sorted(launches)}")
    # K10 is exempt: the JAX package's topk_pallas has no caller on any path
    # either, so no main path can launch it; phases 9 and 27 hold it against
    # its plain version
    missing = [name for name, n in launches.items() if n == 0 and name not in ("topk", "topk_f16")]
    if missing:
        raise AssertionError(f"kernels never launched on a main path: {missing}")
    stamp("the phases end")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
