"""asr_ttl_mtl_tpu_torch — the PyTorch/CUDA port of `asr_ttl_mtl_tpu`.

The JAX package beside it is the reference. This package imports torch and
never jax, nor the JAX package. Its hot path runs on hand-written Hopper
kernels (`csrc/`, bound in `ops/`), each with a plain PyTorch version that
the CPU takes and the CUDA path is checked against.

Ported so far: the greedy 30 s window path, waveform -> log-mel -> encoder
-> cross-KV -> prefill -> greedy decode -> text; and the single-device
multi-task fine-tune (`mtl/`: dataset, trainer, chunked CE, 4-group AdamW),
whose attention trains through the flash kernels' backward passes.
"""

__version__ = "0.1.0"

from .audio import load_audio, log_mel_spectrogram, pad_or_trim  # noqa: F401
from .decoding import DecodingOptions, DecodingResult, DecodingTask, decode, detect_language  # noqa: F401
from .models import ModelDimensions, WhisperModel, from_random, load_model  # noqa: F401
