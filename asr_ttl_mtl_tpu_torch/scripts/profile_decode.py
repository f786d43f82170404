"""Where the time of a batched window decode goes on the card, greedy and beam.

    python -m asr_ttl_mtl_tpu_torch.scripts.profile_decode [--model base] [--batch 32] [--beam_size 5]

Random weights from a seed (bf16), seeded noise windows of 30 s, bench.py's
chip options (int8 cross/self KV, W8A8 encoder, 64 forced tokens). For the
greedy decode and then for `--beam_size` beams: one warm-up batch, then one
batch through submit/collect under `torch.profiler`, and prints the
host-clock batch time, the device's busy share (the union of kernel
intervals over the wall time), the kernels per decode step, the device time
by kernel family and the top kernels. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import DecodingOptions, DecodingTask, from_random, log_mel_spectrogram
from ..audio import N_SAMPLES
from .profile_train_step import FAMILIES, busy_us

DECODE_FAMILIES = (("decode attention (K1/K2)", ("decode_attn",)), ("top-k (K9)", ("topk_rows",))) + FAMILIES
OPTIONS = dict(language="en", without_timestamps=True, sample_len=64, suppress_tokens="-1,50257", fp16=True,
               kv_quant=True, int8_encoder=True)  # bench.py's chip options


def profile_batch(task: DecodingTask, mel: torch.Tensor, label: str) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    task.collect(task.submit(mel))  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        task.collect(task.submit(mel))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = OPTIONS["sample_len"]
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    print(f"[profile] {label}: {wall_ms:.1f} ms a batch (host clock, under the profiler) on "
          f"{torch.cuda.get_device_name(0)}")
    if not kernels:
        print("[profile] the profiler recorded no device events; no breakdown")
        return
    busy = busy_us(kernels) / 1e3
    print(f"[profile] {label}: device busy {busy:.1f} ms = {busy / wall_ms:.1%} of the wall time; "
          f"{len(kernels)} kernels, {len(kernels) / steps:.0f} a decode step")
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    fam = {}
    for name, (us, _) in by_name.items():
        low = name.lower()
        key = next((f for f, subs in DECODE_FAMILIES if any(x in low for x in subs)), "other")
        fam[key] = fam.get(key, 0.0) + us
    total = sum(fam.values())
    for key, us in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {label}: family {key}: {us / 1e3:.2f} ms ({us / total:.1%})")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"[profile] {label}: kernel {us / 1e3:8.3f} ms, {count:6d} launches: {name[:100]}")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="base")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--beam_size", type=int, default=5)
    args = p.parse_args(argv)
    model = from_random(args.model, seed=0, dtype=torch.bfloat16)
    waves = (0.1 * np.random.RandomState(0).randn(args.batch, N_SAMPLES)).astype(np.float32)
    mel = log_mel_spectrogram(waves)
    profile_batch(DecodingTask(model, DecodingOptions(**OPTIONS)), mel, f"greedy, B={args.batch}")
    profile_batch(DecodingTask(model, DecodingOptions(**OPTIONS, beam_size=args.beam_size)), mel,
                  f"beam {args.beam_size}, B={args.batch}")


if __name__ == "__main__":
    main()
