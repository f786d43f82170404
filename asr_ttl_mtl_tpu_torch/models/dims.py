"""Model dimension records and the official architecture presets.

Verbatim counterpart of `asr_ttl_mtl_tpu/models/dims.py` (reference
`whisper/model.py:25-37` plus the presets of the published checkpoints).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass(frozen=True)
class ModelDimensions:
    n_mels: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_vocab: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    def replace(self, **kw) -> "ModelDimensions":
        d = asdict(self)
        d.update(kw)
        return ModelDimensions(**d)


def _dims(state, heads, layers, vocab, n_mels=80, text_layers=None):
    return ModelDimensions(
        n_mels=n_mels,
        n_audio_ctx=1500,
        n_audio_state=state,
        n_audio_head=heads,
        n_audio_layer=layers,
        n_vocab=vocab,
        n_text_ctx=448,
        n_text_state=state,
        n_text_head=heads,
        n_text_layer=text_layers if text_layers is not None else layers,
    )


# architecture presets for the official checkpoint family
PRESET_DIMS = {
    "tiny": _dims(384, 6, 4, 51865),
    "tiny.en": _dims(384, 6, 4, 51864),
    "base": _dims(512, 8, 6, 51865),
    "base.en": _dims(512, 8, 6, 51864),
    "small": _dims(768, 12, 12, 51865),
    "small.en": _dims(768, 12, 12, 51864),
    "medium": _dims(1024, 16, 24, 51865),
    "medium.en": _dims(1024, 16, 24, 51864),
    "large-v1": _dims(1280, 20, 32, 51865),
    "large-v2": _dims(1280, 20, 32, 51865),
    "large-v3": _dims(1280, 20, 32, 51866, n_mels=128),
    "large": _dims(1280, 20, 32, 51866, n_mels=128),
    "large-v3-turbo": _dims(1280, 20, 32, 51866, n_mels=128, text_layers=4),
    "turbo": _dims(1280, 20, 32, 51866, n_mels=128, text_layers=4),
}
