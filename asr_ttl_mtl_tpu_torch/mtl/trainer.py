"""Multi-task trainer: joint ASR + speech-disorder-classification fine-tune.

Counterpart of the single-device path of `asr_ttl_mtl_tpu/mtl/trainer.py`
(`MultiTaskTrainer.__init__` :144, `_forward` :413, the train step :625,
`train_epoch`'s single-step loop :972, `evaluate` :1110, `train` :1171,
`save_checkpoint` :1282, `load_from_checkpoint` :1451). One step:

  int16 waveforms / 32768, zero-padded to the window on the device ->
  log-mel (K4) -> encoder (self-attention through K3 with lse, backward K6)
  -> mean-pooled features -> classifier (Linear -> ReLU -> Dropout ->
  Linear) -> class CE; teacher-forced decoder (causal self-attention through
  K7 with lse, backward K8; cross-attention through K3/K6) -> chunked
  softmax CE over the tied embedding -> dynamic alpha/beta (frozen after
  the first batch) -> backward -> global-norm clip + 4-group AdamW.

Evaluation is teacher-forced with materialized fp32 logits. Checkpoints are
the reference `.pt` layout, readable by the JAX package's trainer and the
other way round. Not served here, and raising `NotImplementedError` when
asked for: meshes / tp / ZeRO-1, `steps_per_call > 1` and packed dispatch,
the orbax `resume_dir`, `audio_transfer_dtype="mel_fp16"`, `profile_dir`,
and fp32 compute on the card (the attention kernels take bf16).
"""

from __future__ import annotations

import json
import os
import sys
import time
import types
from dataclasses import asdict, fields
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..audio import log_mel_spectrogram
from ..models import whisper as W
from ..models.dims import ModelDimensions
from ..models.registry import WhisperModel, from_random, load_model
from ..ops.chunked_xent import chunked_softmax_xent
from ..tokenizer import Tokenizer
from ..utils import resolve_device
from .config import TrainingConfig
from .dataset import build_mtl_tokenizer
from .fused_optim import MultiGroupAdamW, group_of, optimizer_hparams
from .metrics import detailed_metrics

_F32 = torch.float32
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make_classifier(d_model: int, generator: torch.Generator, n_classes: int = 3) -> nn.Sequential:
    """Linear(d, d/2) -> ReLU -> Dropout(0.1) -> Linear(d/2, n_classes)
    (reference trainer.py:126-137) with the fan-in uniform init; the keys
    of its state dict are the reference's (0.*, 3.*)."""
    h = d_model // 2
    head = nn.Sequential(nn.Linear(d_model, h), nn.ReLU(), nn.Dropout(0.1), nn.Linear(h, n_classes))
    with torch.no_grad():
        for lin, fan_in in ((head[0], d_model), (head[3], h)):
            bound = 1.0 / np.sqrt(fan_in)
            lin.weight.uniform_(-bound, bound, generator=generator)
            lin.bias.uniform_(-bound, bound, generator=generator)
    return head


def classifier_apply(head: nn.Sequential, pooled: torch.Tensor, compute_dtype: torch.dtype,
                     keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX `classifier_apply` (:78): products in the compute dtype with
    fp32 accumulation, biases in fp32; `keep` is the dropout keep-mask
    (True = keep, scaled by 1/0.9), None outside training."""
    x = W._matmul_f32(pooled.to(compute_dtype), head[0].weight)
    x = F.relu(x + head[0].bias.float())
    if keep is not None:
        x = torch.where(keep, x / 0.9, 0.0)
    x = W._matmul_f32(x.to(compute_dtype), head[3].weight)
    return x + head[3].bias.float()


def classifier_state_from_jax(cp: Dict) -> Dict[str, torch.Tensor]:
    """JAX classifier params ({"fc1": {"w", "b"}, "fc2": ...}, numpy leaves)
    -> the reference state dict (0.*, 3.*), as the JAX
    `_classifier_state_dict` (:1249) writes it."""

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32, copy=True, order="C"))

    return {
        "0.weight": t(np.asarray(cp["fc1"]["w"]).T),
        "0.bias": t(cp["fc1"]["b"]),
        "3.weight": t(np.asarray(cp["fc2"]["w"]).T),
        "3.bias": t(cp["fc2"]["b"]),
    }


def cross_entropy_ignore_index(logits: torch.Tensor, targets: torch.Tensor, ignore_index: int = -100):
    """(mean, per-row sum, per-row count) of the token CE with an ignore mask."""
    valid = targets != ignore_index
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    token_lp = logprobs.gather(-1, torch.where(valid, targets, 0)[..., None])[..., 0]
    token_loss = torch.where(valid, -token_lp, 0.0)
    row_sum = token_loss.sum(dim=-1)
    row_cnt = valid.sum(dim=-1)
    return row_sum.sum() / row_cnt.sum().clamp(min=1), row_sum, row_cnt


class MultiTaskTrainer:
    def __init__(self, config: TrainingConfig, verbose: bool = True):
        self.config = config
        self.verbose = verbose
        self._check_supported(config)
        self.device = resolve_device("cuda" if config.device in (None, "auto") else config.device)
        self._log(f"=== Multi-Task Learning Trainer (PyTorch, {self.device}) ===")

        self.is_english_only = ".en" in config.model_size
        self.tokenizer: Tokenizer = build_mtl_tokenizer(config.model_size)
        self.class_to_disease = config.class_to_disease
        self.disease_to_class = {v: k for k, v in config.class_to_disease.items()}
        self.disease_token_ids = dict(self.tokenizer.disease_tokens)
        self.disease_token_position = 1 if self.is_english_only else 2

        self.compute_dtype = _DTYPES[config.compute_dtype]
        if self.device.type == "cuda" and self.compute_dtype != torch.bfloat16:
            raise NotImplementedError(
                "compute_dtype='float32' on CUDA: the attention kernels take bf16 (ROADMAP item 9)"
            )
        self.model = self._load_base_model()
        self._expand_vocabulary()
        self.model.requires_grad_(True)
        gen = torch.Generator().manual_seed(config.seed)
        self.classifier = make_classifier(self.model.dims.n_audio_state, gen).to(self.device)
        self._dropout_gen = torch.Generator(device=self.device).manual_seed(config.seed + 1)
        self.optimizer = self._build_optimizer()
        self.alpha = float(config.alpha)
        self.beta = float(config.beta)
        self._log(f"Trainer ready: dims={self.model.dims}, compute={self.compute_dtype}")

    # --- setup -------------------------------------------------------------

    @staticmethod
    def _check_supported(cfg: TrainingConfig) -> None:
        """Raise for what the port does not serve (single device only)."""
        unsupported = []
        if tuple(cfg.mesh_shape) not in ((0, 1), (1, 1)):
            unsupported.append(f"mesh_shape={tuple(cfg.mesh_shape)} (meshes, dp, tp)")
        if cfg.dp_shard_map == "force":
            unsupported.append("dp_shard_map='force'")
        if cfg.zero1:
            unsupported.append("zero1=True")
        if cfg.steps_per_call and cfg.steps_per_call > 1:
            unsupported.append(f"steps_per_call={cfg.steps_per_call}")
        if cfg.packed_dispatch:
            unsupported.append("packed_dispatch=True")
        if cfg.audio_transfer_dtype == "mel_fp16":
            unsupported.append("audio_transfer_dtype='mel_fp16'")
        if cfg.profile_dir:
            unsupported.append("profile_dir")
        if unsupported:
            raise NotImplementedError(
                "not served by the PyTorch port (see ROADMAP.md): " + ", ".join(unsupported)
            )

    def _log(self, *args):
        if self.verbose:
            print(*args, flush=True)

    def _load_base_model(self) -> WhisperModel:
        cfg = self.config
        if cfg.pretrained == "random":
            spec = ModelDimensions(**cfg.debug_dims) if cfg.debug_dims else cfg.model_size
            return from_random(spec, seed=cfg.seed, device=self.device, dtype=self.compute_dtype)
        name = cfg.pretrained or cfg.model_size
        if not os.path.exists(name):
            raise RuntimeError(
                f"no checkpoint at {name!r}: the port reads local `.pt` files only. Set "
                "TrainingConfig.pretrained to a checkpoint path, or to 'random'."
            )
        return load_model(name, device=self.device, compute_dtype=self.compute_dtype)

    def _expand_vocabulary(self):
        """Grow the embedding to cover the spliced disease tokens."""
        original = self.model.dims.n_vocab
        new_vocab = max(self.tokenizer.special_tokens.values()) + 1
        if new_vocab > original:
            self.model.resize_token_embeddings(new_vocab, torch.Generator().manual_seed(self.config.seed))
            self._log(f"Vocabulary expanded: {original} -> {new_vocab}")

    def named_trainable(self):
        """("model.<name>" | "classifier.<name>", parameter) pairs."""
        for n, p in self.model.named_parameters():
            yield f"model.{n}", p
        for n, p in self.classifier.named_parameters():
            yield f"classifier.{n}", p

    def _build_optimizer(self) -> MultiGroupAdamW:
        cfg = self.config
        groups: Dict[str, List[nn.Parameter]] = {}
        for name, p in self.named_trainable():
            groups.setdefault(group_of(name, cfg.freeze_encoder), []).append(p)
        return MultiGroupAdamW(
            groups, optimizer_hparams(cfg.learning_rate, cfg.weight_decay), cfg.gradient_clip_norm,
            moment_dtype=_DTYPES[cfg.optimizer_moment_dtype],
        )

    def load_state(self, model_state: Dict[str, torch.Tensor], classifier_state: Dict[str, torch.Tensor]):
        """Start from given weights: the model's and the classifier's
        reference state dicts (from a checkpoint, another trainer, or the JAX
        package's parameters through `models.state_dict_from_jax_params` and
        `classifier_state_from_jax`). The optimizer state restarts at zero."""
        n_vocab = int(model_state["decoder.token_embedding.weight"].shape[0])
        if n_vocab != self.model.dims.n_vocab:
            self.model = WhisperModel(self.model.dims.replace(n_vocab=n_vocab), self.compute_dtype,
                                      self.model.name).to(self.device)
        self.model.load_state_dict({k: v.float() for k, v in model_state.items()})
        self.model.requires_grad_(True)
        self.classifier.load_state_dict({k: v.float() for k, v in classifier_state.items()})
        self.optimizer = self._build_optimizer()

    def _use_chunked_ce(self) -> bool:
        mode = self.config.chunked_ce
        return True if mode == "auto" else bool(mode)

    def _use_remat(self) -> bool:
        """"auto" keeps the JAX package's rule, which is on only on a TPU."""
        mode = self.config.remat
        return False if mode == "auto" else bool(mode)

    # --- the step ------------------------------------------------------------

    def _device_batch(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """A host batch on the device; waveforms travel as int16 (exact for
        16-bit PCM) unless audio_transfer_dtype is "float32"."""
        audio = np.asarray(batch["audio"])
        if self.config.audio_transfer_dtype == "int16":
            audio = np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)
        dev = {"audio": torch.from_numpy(audio)}
        for k in ("input_tokens", "target_tokens", "classes"):
            dev[k] = torch.from_numpy(np.asarray(batch[k]).astype(np.int64))
        return {k: v.to(self.device, non_blocking=True) for k, v in dev.items()}

    def _forward(self, dev: Dict[str, torch.Tensor], train: bool, keep: Optional[torch.Tensor] = None):
        dims = self.model.dims
        audio = dev["audio"]
        if audio.dtype == torch.int16:
            audio = audio.float() / 32768.0
        if audio.shape[-1] < self.config.audio_samples:
            audio = F.pad(audio, (0, self.config.audio_samples - audio.shape[-1]))
        mels = log_mel_spectrogram(audio, n_mels=dims.n_mels)
        feats = W.encoder_apply(self.model.encoder, mels, self.compute_dtype,
                                remat=train and self._use_remat())
        pooled = feats.mean(dim=1)
        disease_logits = classifier_apply(self.classifier, pooled, self.compute_dtype, keep if train else None)
        classes = dev["classes"]
        cls_per_row = -torch.log_softmax(disease_logits.float(), dim=-1).gather(1, classes[:, None])[:, 0]
        cls_loss = cls_per_row.sum() / max(cls_per_row.shape[0], 1)

        targets = dev["target_tokens"]
        if train and self._use_chunked_ce():
            hidden, _ = W.decoder_apply(self.model.decoder, dev["input_tokens"], feats,
                                        compute_dtype=self.compute_dtype, return_hidden=True)
            token_loss, pred_tokens = chunked_softmax_xent(
                hidden, self.model.decoder.token_embedding.weight, targets, row_chunk=self.config.ce_chunk_rows
            )
            trans_row_sum = token_loss.sum(dim=-1)
            trans_row_cnt = (targets != -100).sum(dim=-1)
            trans_loss = trans_row_sum.sum() / trans_row_cnt.sum().clamp(min=1)
        else:
            logits_dtype = self.compute_dtype if (train and self.compute_dtype == torch.bfloat16) else None
            logits, _ = W.decoder_apply(self.model.decoder, dev["input_tokens"], feats,
                                        compute_dtype=self.compute_dtype, logits_dtype=logits_dtype)
            trans_loss, trans_row_sum, trans_row_cnt = cross_entropy_ignore_index(logits, targets)
            pred_tokens = logits.argmax(dim=-1)

        aux = {
            "cls_loss": cls_loss,
            "trans_loss": trans_loss,
            "cls_per_row": cls_per_row,
            "trans_row_sum": trans_row_sum,
            "trans_row_count": trans_row_cnt,
            "disease_preds": disease_logits.argmax(dim=-1),
            "disease_probs": torch.softmax(disease_logits.float(), dim=-1),
            "pred_tokens": pred_tokens,
        }
        return cls_loss, trans_loss, aux

    def _effective_weights(self, cls_loss: torch.Tensor, trans_loss: torch.Tensor):
        """Inverse-loss-normalized weights while alpha or beta is 0.0 (dynamic)."""
        if self.alpha != 0.0 and self.beta != 0.0:
            return (torch.tensor(self.alpha, dtype=_F32, device=self.device),
                    torch.tensor(self.beta, dtype=_F32, device=self.device))
        c = cls_loss.detach() + 1e-6
        t = trans_loss.detach() + 1e-6
        return (1.0 / c) / (1.0 / c + 1.0 / t), (1.0 / t) / (1.0 / c + 1.0 / t)

    def draw_keep_mask(self, batch_size: int) -> torch.Tensor:
        """The classifier's dropout keep-mask (p = 0.9), from the trainer's
        own generator on the device."""
        shape = (batch_size, self.model.dims.n_audio_state // 2)
        return torch.rand(shape, generator=self._dropout_gen, device=self.device) < 0.9

    def train_step(self, batch: Dict, keep: Optional[torch.Tensor] = None):
        """One optimizer step on a host batch; `keep` overrides the dropout
        keep-mask. Returns (combined loss, aux) as device tensors; freezes
        alpha/beta after the first batch as the reference does."""
        dev = self._device_batch(batch)
        if keep is None:
            keep = self.draw_keep_mask(dev["classes"].shape[0])
        keep = keep.to(self.device)
        cls_loss, trans_loss, aux = self._forward(dev, train=True, keep=keep)
        a, b = self._effective_weights(cls_loss, trans_loss)
        loss = a * cls_loss + b * trans_loss
        aux.update(alpha_eff=a, beta_eff=b)
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()  # leaves the step's gradients in .grad
        # one-shot dynamic weight freeze (reference trainer.py:412-413)
        if (self.alpha == 0.0 or self.beta == 0.0) and not self.config.true_dynamic_weights:
            self.alpha, self.beta = float(a), float(b)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    # --- prediction decoding -------------------------------------------------

    _SPECIAL_STRINGS = [
        "<|startoftranscript|>", "<|endoftext|>", "<|en|>",
        "<|transcribe|>", "<|notimestamps|>", "<|nospeech|>",
        "<|normal|>", "<|dysphonia|>", "<|dysarthria|>",
    ]

    def decode_predictions(self, pred_tokens: np.ndarray) -> List[str]:
        texts = []
        for row in pred_tokens:
            text = self.tokenizer.decode([int(t) for t in row if t != -100])
            for s in self._SPECIAL_STRINGS:
                text = text.replace(s, "")
            texts.append(text.strip())
        return texts

    # --- epochs --------------------------------------------------------------

    def train_epoch(self, dataloader, epoch: int) -> Dict:
        totals = {"loss": 0.0, "cls_loss": 0.0, "trans_loss": 0.0}
        all_preds, all_labels, all_pred_texts, all_ref_texts = [], [], [], []
        n_batches = 0
        t0 = time.time()
        for batch in dataloader:
            loss, aux = self.train_step(batch)
            n_batches += 1
            totals["loss"] += float(loss)
            totals["cls_loss"] += float(aux["cls_loss"])
            totals["trans_loss"] += float(aux["trans_loss"])
            all_preds.extend(aux["disease_preds"].cpu().numpy())
            all_labels.extend(batch["classes"])
            all_pred_texts.extend(self.decode_predictions(aux["pred_tokens"].cpu().numpy()))
            all_ref_texts.extend(batch["texts"])

        metrics = detailed_metrics(all_pred_texts, all_ref_texts, all_preds, all_labels)
        n_batches = max(n_batches, 1)
        elapsed = time.time() - t0
        metrics.update(
            loss=totals["loss"] / n_batches,
            cls_loss=totals["cls_loss"] / n_batches,
            trans_loss=totals["trans_loss"] / n_batches,
            alpha=self.alpha,
            beta=self.beta,
            epoch_seconds=elapsed,
            samples_per_second=len(all_labels) / max(elapsed, 1e-9),
        )
        self._log(
            f"epoch {epoch+1} train: loss={metrics['loss']:.4f} "
            f"(cls {metrics['cls_loss']:.4f}, trans {metrics['trans_loss']:.4f}) "
            f"alpha={self.alpha:.4f} beta={self.beta:.4f} "
            f"acc={metrics.get('disease_acc', 0):.4f} wer={metrics.get('wer', -1):.4f} "
            f"[{metrics['samples_per_second']:.1f} samples/s]"
        )
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: Dict) -> Dict:
        """Teacher-forced forward with materialized fp32 logits."""
        cls_loss, trans_loss, aux = self._forward(self._device_batch(batch), train=False)
        a, b = self._effective_weights(cls_loss, trans_loss)
        aux.update(alpha_eff=a, beta_eff=b, combined=a * cls_loss + b * trans_loss)
        return aux

    def evaluate(self, dataloader) -> Dict:
        loss_sums = {"combined": 0.0, "cls": 0.0, "trans": 0.0}
        n_batches = 0
        all_preds, all_labels, all_pred_texts, all_ref_texts = [], [], [], []
        for batch in dataloader:
            aux = self.eval_step(batch)
            n_batches += 1
            cls_mean = float(aux["cls_per_row"].mean())
            trans_mean = float(aux["trans_row_sum"].sum() / aux["trans_row_count"].sum().clamp(min=1))
            loss_sums["cls"] += cls_mean
            loss_sums["trans"] += trans_mean
            # the step's effective weights (frozen values, or per batch while dynamic)
            loss_sums["combined"] += float(aux["alpha_eff"]) * cls_mean + float(aux["beta_eff"]) * trans_mean
            all_preds.extend(aux["disease_preds"].cpu().numpy())
            all_labels.extend(batch["classes"])
            all_pred_texts.extend(self.decode_predictions(aux["pred_tokens"].cpu().numpy()))
            all_ref_texts.extend(batch["texts"])

        metrics = detailed_metrics(all_pred_texts, all_ref_texts, all_preds, all_labels)
        n_batches = max(n_batches, 1)
        metrics.update(
            loss=loss_sums["combined"] / n_batches,
            cls_loss=loss_sums["cls"] / n_batches,
            trans_loss=loss_sums["trans"] / n_batches,
        )
        self._log(
            f"  val: loss={metrics['loss']:.4f} acc={metrics.get('disease_acc', 0):.4f} "
            f"wer={metrics.get('wer', -1):.4f} cer={metrics.get('cer', -1):.4f}"
        )
        return metrics

    def train(self, train_loader, val_loader, resume_dir: Optional[str] = None) -> Dict:
        """Best-val-loss checkpointing and early stopping (reference
        trainer.py:541-612); the history JSON goes to save_dir."""
        if resume_dir:
            raise NotImplementedError("resume_dir (orbax full-state resume) is not served by the PyTorch port")
        best_loss = float("inf")
        patience_counter = 0
        training_history = []
        for epoch in range(self.config.epochs):
            train_metrics = self.train_epoch(train_loader, epoch)
            val_metrics = self.evaluate(val_loader)
            current_loss = val_metrics["loss"]
            if current_loss < best_loss:
                best_loss = current_loss
                patience_counter = 0
                self.save_checkpoint(epoch=epoch, best_loss=best_loss, val_metrics=val_metrics,
                                     train_metrics=train_metrics)
            else:
                patience_counter += 1
                self._log(f"  no improvement; patience {patience_counter}/{self.config.early_stopping_patience}")
                if patience_counter >= self.config.early_stopping_patience:
                    self._log("early stopping triggered")
                    break
            training_history.append({"epoch": epoch + 1, "train_metrics": train_metrics,
                                     "val_metrics": val_metrics})

        if self.config.save_dir:
            hist_path = os.path.join(self.config.save_dir, f"training_history_{self.config.model_size}.json")
            with open(hist_path, "w") as f:
                json.dump(_to_jsonable(training_history), f, indent=2)
        self._log(f"training complete; best val loss {best_loss:.4f}")
        return {"best_loss": best_loss, "training_history": training_history}

    # --- checkpointing -------------------------------------------------------

    def checkpoint_path(self) -> str:
        return os.path.join(self.config.save_dir or ".", f"best_multitask_model_{self.config.model_size}.pt")

    def save_checkpoint(self, epoch: int, best_loss: float, val_metrics=None, train_metrics=None):
        """Write the reference `.pt` checkpoint (trainer.py:568-586 keys)."""
        ckpt = {
            "model_state_dict": {k: v.detach().float().cpu() for k, v in self.model.state_dict().items()},
            "disease_classifier_state_dict": {k: v.detach().float().cpu()
                                              for k, v in self.classifier.state_dict().items()},
            "optimizer_state_dict": self.optimizer.state(),
            "config": asdict(self.config),
            "dims": self.model.dims.__dict__,
            "epoch": epoch,
            "best_loss": best_loss,
            "val_metrics": _to_jsonable(val_metrics),
            "train_metrics": _to_jsonable(train_metrics),
            "alpha": self.alpha,
            "beta": self.beta,
            "tokenizer_info": {
                "eot_token": self.tokenizer.eot,
                "sot_token": self.tokenizer.sot,
                "disease_tokens": dict(self.tokenizer.disease_tokens),
                "disease_token_ids": dict(self.disease_token_ids),
                "disease_token_position": self.disease_token_position,
            },
        }
        path = self.checkpoint_path()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(ckpt, path)
        self._log(f"  best model saved: {path}")

    @classmethod
    def load_from_checkpoint(cls, checkpoint_path: str, verbose: bool = True,
                             **config_overrides) -> "MultiTaskTrainer":
        """Restore from a `.pt` checkpoint written by this trainer, the JAX
        package's or the reference's."""
        ckpt = _torch_load_compat(checkpoint_path)
        config = _coerce_config(ckpt["config"], **config_overrides)
        config.pretrained = "random"  # every weight comes from the checkpoint
        trainer = cls(config, verbose=verbose)
        trainer.load_state(ckpt["model_state_dict"], ckpt["disease_classifier_state_dict"])
        trainer.alpha = float(ckpt.get("alpha", 0.5))
        trainer.beta = float(ckpt.get("beta", 0.5))
        if verbose:
            print(f"Model loaded from: {checkpoint_path}")
        return trainer


# ---------------------------------------------------------------------------
# checkpoint helpers
# ---------------------------------------------------------------------------


def _torch_load_compat(path: str):
    """torch.load that also takes checkpoints pickled with the reference's
    `speech_disorder` package (its TrainingConfig class)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=False)
    except ModuleNotFoundError as e:
        if "speech_disorder" not in str(e):
            raise
        shim = types.ModuleType("speech_disorder")
        shim_cfg = types.ModuleType("speech_disorder.config")

        class _RefConfig:  # plain attribute bag for unpickling
            pass

        shim_cfg.TrainingConfig = _RefConfig
        shim.config = shim_cfg
        sys.modules.setdefault("speech_disorder", shim)
        sys.modules.setdefault("speech_disorder.config", shim_cfg)
        return torch.load(path, map_location="cpu", weights_only=False)


def _coerce_config(obj: Any, **overrides) -> TrainingConfig:
    """A TrainingConfig from a dict (either package) or an attribute bag (reference pickle)."""
    if isinstance(obj, TrainingConfig):
        cfg = obj
    else:
        known = {f.name for f in fields(TrainingConfig)}
        if isinstance(obj, dict):
            data = {k: v for k, v in obj.items() if k in known}
        else:
            data = {k: getattr(obj, k) for k in known if hasattr(obj, k) and not k.startswith("_")}
        data.pop("device", None)
        cfg = TrainingConfig(**data)
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg


def _to_jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().tolist()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj
