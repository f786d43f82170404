"""Whisper's text normalizers for WER scoring: counterpart of `asr_ttl_mtl_tpu/normalizers/`."""

from .basic import BasicTextNormalizer  # noqa: F401
from .english import EnglishTextNormalizer  # noqa: F401
