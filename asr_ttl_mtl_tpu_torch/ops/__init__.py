"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds a wrapper, the plain version of the same function,
and a launch count in `LAUNCHES`. A wrapper takes the plain version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
A wrapper adds one to its count where it launches its kernel, and nowhere
else, so a run can show that it went through the kernels.
"""

from __future__ import annotations

from typing import Dict

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {
    "decode_attention_i8": 0,  # K1, ops/decode_attention.py
    "decode_attention": 0,  # K2, ops/decode_attention.py
    "flash_attention_h2": 0,  # K3, ops/flash_attention.py
    "flash_attention_h2_lse": 0,  # K3 with the logsumexp (training forward)
    "flash_attention_h2_bwd": 0,  # K6 (dq and dkv kernels, one launch each per call)
    "flash_attention_mh": 0,  # K5, per-head natural layout (shapes h2_eligible rejects)
    "flash_attention": 0,  # K7
    "flash_attention_lse": 0,  # K7 with the logsumexp (training forward)
    "flash_attention_bwd": 0,  # K8 (dq and dkv kernels, one launch each per call)
    "log_mel": 0,  # K4, ops/mel.py
    "topk_logprobs": 0,  # K9, ops/topk.py
    "topk": 0,  # K10, ops/topk.py
    "median_filter": 0,  # K11, ops/median.py
    "dtw_trace": 0,  # K13, ops/dtw.py
    "dtw_paths_batch": 0,  # K12, ops/dtw.py
    "int8_mlp": 0,  # K14, ops/int8_mlp.py
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
