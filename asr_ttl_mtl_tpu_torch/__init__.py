"""asr_ttl_mtl_tpu_torch — the PyTorch/CUDA port of `asr_ttl_mtl_tpu`.

The JAX package beside it is the reference. This package imports torch and
never jax, nor the JAX package. Its hot path runs on hand-written Hopper
kernels (`csrc/`, bound in `ops/`), each with a plain PyTorch version that
the CPU takes and the CUDA path is checked against.

Ported so far: the 30 s window path, waveform -> log-mel -> encoder ->
cross-KV -> prefill -> greedy, best-of or beam decode -> text; long-form
`transcribe` with word timestamps, batched `transcribe_batch`, the writers
and the CLI (`python -m asr_ttl_mtl_tpu_torch`, `--batch_mode`);
and the multi-task fine-tune (`mtl/`: dataset, trainer, chunked CE,
4-group AdamW), whose attention trains through the flash kernels'
backward passes, with its report scripts (`scripts/`); file decoding on
the host (the native C++ runtime in `runtime/` and `native/`, ffmpeg) and
the text normalizers (`normalizers/`); and the multi-device paths on
`torch.distributed` (`parallel/`: dp and tp batched decoding, the
trainer's dp, tp and ZeRO-1), one process per rank.
"""

__version__ = "0.1.0"

from .audio import load_audio, log_mel_spectrogram, pad_or_trim  # noqa: F401
from .decoding import DecodingOptions, DecodingResult, DecodingTask, decode, detect_language  # noqa: F401
from .models import ModelDimensions, WhisperModel, from_random, load_model  # noqa: F401
from .transcribe import transcribe_batch  # noqa: F401
