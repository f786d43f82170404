"""Small host-side helpers (counterpart of `asr_ttl_mtl_tpu/utils/__init__.py`).

Only what the greedy 30 s window path needs. The subtitle writers belong to
the long-form slice and are not ported yet.
"""

from __future__ import annotations

import zlib


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
