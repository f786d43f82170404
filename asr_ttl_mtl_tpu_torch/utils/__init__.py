"""Small host-side helpers (counterpart of `asr_ttl_mtl_tpu/utils/__init__.py`):
exact_div, str2bool, optional_int/float, compression_ratio,
format_timestamp, get_start/get_end, make_safe, and the device rule of the
entry points. The writers are in `utils/writers.py`.
"""

from __future__ import annotations

import sys
import zlib
from typing import Callable, List, Optional, TypeVar, Union

system_encoding = sys.getdefaultencoding()

_T = TypeVar("_T")


def resolve_device(device: Union[str, "torch.device", None] = "cuda"):  # noqa: F821
    """The device an entry point runs on: the card unless the caller names
    the CPU. Asking for CUDA where there is none raises; nothing falls back
    to the CPU on its own."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def exact_div(x: int, y: int) -> int:
    """Integer division that insists on divisibility (audio-frame math:
    a remainder means a constant upstream is wrong, not a rounding choice)."""
    quotient, remainder = divmod(x, y)
    assert remainder == 0
    return quotient


def compression_ratio(text: str) -> float:
    """gzip compressibility of the text; >2.4 flags degenerate repetition."""
    raw = text.encode("utf-8")
    return len(raw) / len(zlib.compress(raw))


def format_timestamp(
    seconds: float, always_include_hours: bool = False, decimal_marker: str = "."
) -> str:
    """Render seconds as [HH:]MM:SS<marker>mmm (SRT/VTT cue timestamps)."""
    assert seconds >= 0, "non-negative timestamp expected"
    total_ms = round(seconds * 1000.0)
    ms = total_ms % 1000
    mins, secs = divmod(total_ms // 1000, 60)
    hours, mins = divmod(mins, 60)
    body = f"{mins:02d}:{secs:02d}{decimal_marker}{ms:03d}"
    if always_include_hours or hours:
        return f"{hours:02d}:{body}"
    return body


def make_safe(string: str) -> str:
    """Make `string` printable on the current stdout encoding: a UTF-8
    console passes it through; a narrower one gets unrepresentable
    characters replaced."""
    if system_encoding == "utf-8":
        return string
    return string.encode(system_encoding, errors="replace").decode(system_encoding)


_BOOL_WORDS = {"True": True, "False": False}


def str2bool(string: str) -> bool:
    """argparse bool type: accepts exactly the Python literals True/False."""
    try:
        return _BOOL_WORDS[string]
    except KeyError:
        raise ValueError(f"Expected one of {set(_BOOL_WORDS.keys())}, got {string}") from None


def _none_or(string: str, parse: Callable[[str], _T]) -> Optional[_T]:
    """argparse helper: the literal "None" means None, anything else parses."""
    if string == "None":
        return None
    return parse(string)


def optional_int(string: str) -> Optional[int]:
    return _none_or(string, int)


def optional_float(string: str) -> Optional[float]:
    return _none_or(string, float)


def get_start(segments: List[dict]) -> Optional[float]:
    """Start time of the first aligned word; the first segment's start when
    no segment carries words; None for an empty result."""
    for segment in segments:
        for word in segment["words"]:
            return word["start"]
    if segments:
        return segments[0]["start"]
    return None


def get_end(segments: List[dict]) -> Optional[float]:
    """End time of the last aligned word; the last segment's end when no
    segment carries words; None for an empty result."""
    for segment in reversed(segments):
        for word in reversed(segment["words"]):
            return word["end"]
    if segments:
        return segments[-1]["end"]
    return None
