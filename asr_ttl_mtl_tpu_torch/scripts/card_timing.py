"""Timing helpers shared by `chip_smoke.py` and the port's measuring
scripts: the card's name and power limit, and a call's device time."""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`, first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def graph_ms(fn, calls: int = 10, replays: int = 5) -> float:
    """Device time of one call of `fn`: `calls` calls captured in one CUDA
    graph, replayed `replays` times between two events, so that the host's
    cost of each call (the Python wrapper, the launch) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream, as capture requires
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)
