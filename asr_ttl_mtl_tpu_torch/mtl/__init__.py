"""The multi-task fine-tune (ASR + speech-disorder classification), on one
device or over a ("dp", "tp") mesh: counterpart of `asr_ttl_mtl_tpu/mtl/`."""

from .config import DISORDER_TYPE, TrainingConfig  # noqa: F401
from .dataset import DataLoader, MultiTaskSpeechDataset, build_mtl_tokenizer, collate  # noqa: F401
from .trainer import MultiTaskTrainer  # noqa: F401
from . import metrics  # noqa: F401
