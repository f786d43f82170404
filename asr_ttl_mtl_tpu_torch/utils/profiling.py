"""Tracing and step timing: counterpart of `asr_ttl_mtl_tpu/utils/profiling.py:20-101`.

* `trace(logdir)`   - a torch.profiler scope (host and, on a card, CUDA
                      activity) whose Chrome trace is written into `logdir`
* `annotate(name)`  - a named host span inside an active trace
* `StepTimer`       - step times and throughput (samples/s,
                      audio-sec/sec/chip); on a CUDA device each step is
                      timed by CUDA events, so that it ends when the
                      device's work does
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]):
    """torch.profiler over the scope, the trace written to
    `logdir/trace_<pid>_<ns>.json`; nothing when logdir is falsy."""
    if not logdir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named host span, nested inside an active `trace`."""
    import torch

    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Per-step times and the throughput they give.

        timer = StepTimer(device=torch.device("cuda"))
        with timer.step(samples=B, audio_seconds=B * 30.0):
            ... one step ...
        print(timer.summary())

    On a CUDA device a step's time runs from a CUDA event recorded before it
    to one recorded after it, waited for; elsewhere it is the host clock."""

    n_chips: int = 1
    warmup_steps: int = 1  # the first step(s) carry the set-up
    device: Any = None
    _times: List[float] = field(default_factory=list)
    _samples: List[int] = field(default_factory=list)
    _audio_seconds: List[float] = field(default_factory=list)
    _seen: int = 0

    @contextlib.contextmanager
    def step(self, samples: int = 0, audio_seconds: float = 0.0, n_steps: int = 1):
        """Time a call covering `n_steps` optimizer steps; the times kept are per step."""
        cuda = self.device is not None and getattr(self.device, "type", str(self.device)) == "cuda"
        if cuda:
            import torch

            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        else:
            t0 = time.perf_counter()
        yield
        if cuda:
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - t0
        self._seen += 1
        if self._seen <= self.warmup_steps:
            return
        n_steps = max(1, n_steps)
        self._times.extend([dt / n_steps] * n_steps)
        self._samples.append(samples)
        self._audio_seconds.append(audio_seconds)

    @property
    def steps(self) -> int:
        return len(self._times)

    def summary(self) -> Dict[str, float]:
        if not self._times:
            return {"steps": 0}
        total = sum(self._times)
        times = sorted(self._times)
        out = {
            "steps": len(times),
            "mean_step_s": total / len(times),
            "p50_step_s": times[len(times) // 2],
            "p90_step_s": times[int(len(times) * 0.9)],
        }
        if sum(self._samples):
            out["samples_per_s"] = sum(self._samples) / total
        if sum(self._audio_seconds):
            out["audio_sec_per_sec"] = sum(self._audio_seconds) / total
            out["audio_sec_per_sec_per_chip"] = out["audio_sec_per_sec"] / max(1, self.n_chips)
        return out

    def reset(self) -> None:
        self._times.clear()
        self._samples.clear()
        self._audio_seconds.clear()
        self._seen = 0
