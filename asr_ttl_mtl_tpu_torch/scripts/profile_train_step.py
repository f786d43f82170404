"""Where the time of a train step goes on the card.

    python -m asr_ttl_mtl_tpu_torch.scripts.profile_train_step [--model base] [--batch 16] [--steps 3]
        [--compute_dtype bfloat16|float32]

Builds `MultiTaskTrainer` with random weights from a seed (bf16 compute
unless `--compute_dtype float32`), a seeded
synthetic batch (noise waveforms of 2-10 s, transcripts of 5-30 words,
token bucket 48), runs two warm-up steps, then `--steps` steps under
`torch.profiler` and prints: the host-clock step time, the device's busy
share (the union of kernel intervals over the wall time), the device time
by kernel family and the top kernels. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..mtl import MultiTaskTrainer, TrainingConfig, collate
from ..mtl.dataset import audio_buckets

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("flash attention (K3/K6/K7/K8)", ("flash_fwd", "flash_bwd", "f32::fwd_kernel", "f32::bwd_")),
    ("log-mel (K4)", ("log_mel",)),
    ("GEMM", ("gemm", "cutlass", "xmma", "sm90_", "cublas", "nvjet")),
    ("optimizer foreach", ("foreach", "multi_tensor")),
    ("reduction", ("reduce", "softmax", "norm")),
    ("copy / cast", ("copy", "cast", "convert")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)
WORDS = "the patient said hello there how are you fine thanks speech voice test one two three".split()


def synthetic_batch(trainer: MultiTaskTrainer, batch: int, seed: int = 0):
    rng = np.random.RandomState(seed)
    tok = trainer.tokenizer
    items = []
    for i in range(batch):
        n = int(16000 * rng.uniform(2.0, 10.0))
        text = " ".join(rng.choice(WORDS, size=rng.randint(5, 31)))
        disease = tok.disease_tokens[trainer.class_to_disease[i % 3]]
        head = [tok.sot, disease] if trainer.is_english_only else [tok.sot, tok.language_token, disease,
                                                                  tok.transcribe]
        seq = head + tok.encode(" " + text) + [tok.eot]
        items.append({"audio": (0.1 * rng.randn(n)).astype(np.float32), "input_tokens": seq[:-1],
                      "target_tokens": seq[1:], "class": i % 3, "text": text, "path": f"synthetic{i}"})
    return collate(items, tok, trainer.config.token_buckets, audio_buckets(trainer.config))


def busy_us(events) -> float:
    """Length of the union of the kernels' [start, end] intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="base")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--compute_dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = p.parse_args(argv)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trainer = MultiTaskTrainer(TrainingConfig(model_size=args.model, pretrained="random", compute_dtype=args.compute_dtype,
                                              batch_size=args.batch, seed=0), verbose=False)
    batch = synthetic_batch(trainer, args.batch)
    for _ in range(2):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    n = args.steps
    card = torch.cuda.get_device_name(0)
    print(f"[profile] {args.model} in {args.compute_dtype}, batch {args.batch}, token bucket {batch['input_tokens'].shape[1]}, "
          f"{n} steps on {card}: {wall_s / n * 1e3:.1f} ms a step (host clock, under the profiler)")
    if not kernels:
        print("[profile] the profiler recorded no device events; no breakdown")
        return
    busy = busy_us(kernels) / 1e3 / n
    print(f"[profile] device busy {busy:.1f} ms a step = {busy / (wall_s / n * 1e3):.1%} of the wall time; "
          f"{len(kernels) / n:.0f} kernels a step")
    by_name = {}
    for e in kernels:
        by_name.setdefault(e.name, [0.0, 0])
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    fam = {}
    for name, (us, _) in by_name.items():
        low = name.lower()
        key = next((f for f, subs in FAMILIES if any(x in low for x in subs)), "other")
        fam[key] = fam.get(key, 0.0) + us
    total = sum(fam.values())
    for key, us in sorted(fam.items(), key=lambda kv: -kv[1]):
        print(f"[profile] family {key}: {us / 1e3 / n:.2f} ms a step ({us / total:.1%})")
    for name, (us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"[profile] kernel {us / 1e3 / n:8.3f} ms a step, {count // n:5d} launches: {name[:110]}")


if __name__ == "__main__":
    main()
