"""Training configuration for the multi-task (ASR + disorder) fine-tune.

Counterpart of `asr_ttl_mtl_tpu/mtl/config.py`: the same fields and
defaults, so a checkpoint's config moves between the two packages. The
fields for multi-step dispatch and packed state stay for that exchange;
the trainer raises `NotImplementedError` when one of them asks for
something the port does not serve (see `MultiTaskTrainer`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TrainingConfig:
    # model
    model_size: str = "tiny"
    device: str = "auto"  # "auto" (the card) | "cuda" | "cpu"

    mode: str = "multi_task"

    # training hyperparameters (reference defaults)
    epochs: int = 50
    batch_size: int = 16
    val_batch_size: int = 8
    learning_rate: float = 1e-5

    # multi-task loss weights; 0.0 means "dynamic": inverse-loss-normalized
    # weights computed once on the first batch, then frozen (the reference's
    # behaviour, SURVEY.md §5 quirk 2); true_dynamic_weights=True re-weights
    # every step instead
    alpha: float = 0.0
    beta: float = 0.0
    true_dynamic_weights: bool = False

    weight_decay: float = 0.01
    gradient_clip_norm: float = 1.0
    early_stopping_patience: int = 10

    # dataset paths (reference CSV schema: file,text,class)
    train_csv: str = "../data/custom_train.csv"
    val_csv: str = "../data/custom_val.csv"
    test_csv: str = "../data/custom_test.csv"

    freeze_encoder: bool = False
    save_dir: Optional[str] = None

    class_to_disease: Dict[int, str] = field(
        default_factory=lambda: {0: "normal", 1: "dysphonia", 2: "dysarthria"}
    )
    disease_tokens: List[str] = field(
        default_factory=lambda: ["normal", "dysphonia", "dysarthria"]
    )

    # a local `.pt` checkpoint, or "random" (weights from `seed`); the port
    # downloads nothing
    pretrained: Optional[str] = None
    compute_dtype: str = "bfloat16"  # forward/backward compute dtype
    # token sequences are padded up to one of these bucket lengths
    token_buckets: Tuple[int, ...] = (48, 64, 96, 128, 192, 448)
    # (dp, tp) mesh over the world's ranks (dp 0: all the ranks tp leaves);
    # (0, 1) or (1, 1) in a world of one rank trains on one device
    mesh_shape: Tuple[int, int] = (0, 1)
    num_workers: int = 8  # host-side audio decode threads
    mel_on_device: bool = True  # log-mel inside the train step
    seed: int = 0
    # override architecture dims (dict of ModelDimensions fields), with
    # pretrained="random": scaled-down models for tests and smoke runs
    debug_dims: Optional[Dict[str, int]] = None
    # samples per training window (480000 = 30 s; debug_dims pair it with
    # n_audio_ctx = audio_samples / 320)
    audio_samples: int = 480000
    # host -> device waveform length buckets; the step zero-pads to
    # audio_samples on the device. None = (audio_samples // 4, audio_samples)
    audio_length_buckets: Optional[Tuple[int, ...]] = None
    # a torch.profiler trace of epoch 0 goes here, and the step timer's summary is printed
    profile_dir: Optional[str] = None
    steps_per_call: int = 0  # 0 or 1: one optimizer step per call in the port
    # audio transfer: "int16" waveforms (exact for 16-bit PCM), "float32"
    # waveforms, or "mel_fp16" host-computed log-mels (audio.log_mel_for_transfer)
    audio_transfer_dtype: str = "int16"
    packed_dispatch: Optional[bool] = None  # not served by the port
    # the JAX package's dp route (True/"force": shard_map, False: pjit); the
    # port has one per-rank route for all three, and "force" takes it on a
    # mesh of one rank too
    dp_shard_map: object = True
    # checkpoint each encoder block (torch.utils.checkpoint); "auto" keeps
    # the JAX package's rule, which is on only on a TPU
    remat: object = "auto"
    # chunked training cross-entropy (ops/chunked_xent.py): the (B, T, V)
    # logits are never materialized; "auto" = on for one device
    chunked_ce: object = "auto"
    ce_chunk_rows: int = 512  # rows per chunk of the chunked CE
    # the 4-group AdamW is always the hand-written update of
    # mtl/fused_optim.py, in the float order of the JAX fused update (which
    # equals the JAX per-leaf chain); the field stays for the exchange
    fused_optimizer: bool = True
    # storage dtype of the AdamW moments: "float32" or "bfloat16" (the
    # update math runs in fp32 from upcast moments, only the store rounds)
    optimizer_moment_dtype: str = "float32"
    zero1: bool = False  # ZeRO-1: the AdamW moments shared out over dp (needs dp > 1)


DISORDER_TYPE = {0: "Normal", 1: "Dysphonia", 2: "Dysarthria"}
