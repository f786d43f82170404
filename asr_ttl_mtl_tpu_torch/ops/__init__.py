"""Hand-written Hopper kernels and their plain PyTorch versions.

Each kernel module holds a wrapper, the plain version of the same function,
and a launch count in `LAUNCHES`. A wrapper takes the plain version only for
a tensor on the CPU; for a CUDA tensor it launches its kernel or raises.
A wrapper adds one to its count where it launches its kernel, and nowhere
else, so a run can show that it went through the kernels.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

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
    # the fp32 kernels (bf16 launches count under the names above)
    "decode_attention_i8_f32": 0,  # K1 with fp32 queries
    "decode_attention_f32": 0,  # K2 at fp32
    "flash_attention_h2_f32": 0,  # K3 at fp32
    "flash_attention_h2_lse_f32": 0,
    "flash_attention_h2_bwd_f32": 0,  # K6 at fp32
    "flash_attention_mh_f32": 0,  # K5 at fp32
    "flash_attention_f32": 0,  # K7 at fp32
    "flash_attention_lse_f32": 0,
    "flash_attention_bwd_f32": 0,  # K8 at fp32
    "int8_mlp_f32": 0,  # K14 with fp32 activations
    # the fp16 kernels: the serving path's (F16_KERNELS)
    "decode_attention_i8_f16": 0,  # K1 with fp16 queries
    "decode_attention_f16": 0,  # K2 at fp16
    "flash_attention_h2_f16": 0,  # K3 at fp16
    "flash_attention_mh_f16": 0,  # K5 at fp16
    "flash_attention_f16": 0,  # K7 at fp16
    "topk_logprobs_f16": 0,  # K9 over fp16 rows
    "topk_f16": 0,  # K10 over fp16 rows
    "int8_mlp_f16": 0,  # K14 with fp16 activations
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# the suffix of a kernel's C symbol for the dtype it computes in
_SUFFIX = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
# the kernels with an fp16 twin: the serving path's. K3-lse, K6, K7-lse and
# K8 (training) raise for fp16 until the fp16 training slice (ROADMAP Queue
# 2a) ports them; K4, K11, K12 and K13 take fp32 alone, as in JAX
F16_KERNELS = frozenset(("decode_attention_i8", "decode_attention", "flash_attention_h2", "flash_attention_mh",
                         "flash_attention", "topk_logprobs", "topk", "int8_mlp"))
F16_TRAINING = "the fp16 training slice (ROADMAP Queue 2a)"


def kernel_dtype(name: str, tensors: Sequence[torch.Tensor]) -> str:
    """The C symbol suffix for the tensors' one dtype: "bf16", "f16" or
    "f32". Mixed dtypes, or any other dtype, raise; so does fp16 for a
    kernel `name` (as counted in LAUNCHES) outside F16_KERNELS."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or tensors[0].dtype not in _SUFFIX:
        raise TypeError(f"{name} kernel takes bf16, fp16 or fp32 tensors of one dtype, got "
                        f"{sorted(str(d) for d in dtypes)}")
    if tensors[0].dtype == torch.float16 and name not in F16_KERNELS:
        raise TypeError(f"{name} kernel has no fp16 twin yet: it comes with {F16_TRAINING}")
    return _SUFFIX[tensors[0].dtype]


# the width classes of the attention kernels: each kernel is built for
# these head widths, and a head width dh runs in the smallest class >= dh,
# its columns [dh, class) zeros that no output column is written from. K3
# and K6 (and K5 on K3's forward) serve the classes themselves, as the JAX
# package's `h2_eligible` does
WIDTH_CLASSES = (32, 64, 128)
# the head widths the width classes serve (K1, K2, K7, K7-lse, K8 and the
# fp32 K5 up to 128): every multiple of 8 from 8 to 128, in bf16 and in fp32
MIN_HEAD_WIDTH, MAX_HEAD_WIDTH = 8, WIDTH_CLASSES[-1]


def width_class(dh: int, name: str = "attention") -> int:
    """The width class (32, 64 or 128) a head width dh runs in: the smallest
    of WIDTH_CLASSES that is >= dh. Raises for a width no kernel serves: 0,
    one that is not a multiple of 8, or one above 128."""
    if dh < MIN_HEAD_WIDTH or dh > MAX_HEAD_WIDTH or dh % 8:
        raise ValueError(f"{name} kernel takes a head width that is a multiple of 8 from {MIN_HEAD_WIDTH} to "
                         f"{MAX_HEAD_WIDTH}, got {dh}")
    return next(c for c in WIDTH_CLASSES if c >= dh)


# the head widths K1, K2, K7, K7-lse and K8 serve: every width from 1 to
# 768, in bf16 and in fp32 (the JAX package takes wider heads still, up to
# the widest model's d of 1280; the port refuses them)
SERVED_MIN_WIDTH, SERVED_MAX_WIDTH = 1, 768
# the width classes of K1 and K2: a head width dh runs in the smallest class
# at or above it, its columns [dh, class) zeros in shared memory
DECODE_CLASSES = WIDTH_CLASSES + (256, 512, 768)
# the head widths of the wide kernels (the bf16 forward of K5, K7 and
# K7-lse, the fp32 one of K5, K7 and K7-lse, and K8's backward in both
# dtypes): every multiple of 8 from 136 to 768
WIDE_MAX_HEAD_WIDTH = 768


def _check_served(dh: int, name: str) -> None:
    if dh < SERVED_MIN_WIDTH or dh > SERVED_MAX_WIDTH:
        raise ValueError(f"{name} kernel takes a head width from {SERVED_MIN_WIDTH} to {SERVED_MAX_WIDTH}, got {dh}")


def kernel_width(dh: int) -> int:
    """The head width the flash kernels (K7, K7-lse, K8) run a head of width
    dh at: dh rounded up to a multiple of 8. A row of a width off a multiple
    of 8 cannot be copied as it is (a TMA map's rows, and the fp32 kernels'
    16-byte copies, need 16-byte strides), so the wrappers lay such heads
    out at this width with zero columns. K1 and K2 read a head's dh columns
    as they lie in the caches and run it in `decode_class(dh)`."""
    return -(-dh // 8) * 8


def decode_class(dh: int, name: str = "decode attention") -> int:
    """The width class (32, 64, 128, 256, 512 or 768) K1 and K2 run a head
    width dh in: the smallest of DECODE_CLASSES that is >= dh. Raises for a
    width they do not serve: 0, or one above 768."""
    _check_served(dh, name)
    return next(c for c in DECODE_CLASSES if c >= dh)


def forward_width(dh: int, name: str = "flash attention") -> int:
    """The width class a flash kernel of K7's range (K7, K7-lse, K8) runs a
    head width dh in: `width_class(kernel_width(dh))` up to 128, and 0 from
    129 to 768 (the wide kernels, which take the head's width). Raises for
    any other width: 0, or one above 768."""
    _check_served(dh, name)
    width = kernel_width(dh)
    return width_class(width, name) if width <= MAX_HEAD_WIDTH else 0


def check_class_width(name: str, dh: int, sfx: str) -> None:
    """Raise unless dh is a width class itself: what K3 and K6 (the h2
    kernels, whose residuals hold 128 // dh heads a lane) serve, in any
    dtype (`sfx`, "bf16", "f16" or "f32")."""
    if dh not in WIDTH_CLASSES:
        raise ValueError(f"{name} {dtype_label(sfx)} kernel takes a head width of "
                         f"{', '.join(map(str, WIDTH_CLASSES))}, got {dh}")


def dtype_label(sfx: str) -> str:
    """How messages name a symbol suffix's dtype: bf16, fp16 or fp32."""
    return {"f32": "fp32", "f16": "fp16"}.get(sfx, sfx)


def count_launch(name: str, sfx: str) -> None:
    """One launch of kernel `name`: an fp32 one counts under `<name>_f32`,
    an fp16 one under `<name>_f16`."""
    LAUNCHES[name if sfx == "bf16" else f"{name}_{sfx}"] += 1


def on_card(name: str, x: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version); True for CUDA; raises otherwise."""
    if x.device.type == "cpu":
        return False
    if not x.is_cuda:
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True
