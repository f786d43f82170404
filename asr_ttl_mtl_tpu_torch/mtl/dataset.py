"""Multi-task dataset and host input pipeline.

Counterpart of `asr_ttl_mtl_tpu/mtl/dataset.py`: the CSV schema
`file,text,class`, disease-token target sequences (the token at position 1
en-only, 2 multilingual), EOT/-100 padding to token buckets, waveforms
carried at their true length and zero-padded to an audio length bucket
(the train step pads the rest on the device), and zero audio for a file
that does not load. The CSV is read with the stdlib `csv` module and the
WAVs with the port's reader (`audio.load_audio`) in worker threads; the JAX
package's native C++ batch decoder is not ported.
"""

from __future__ import annotations

import csv
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..audio import N_SAMPLES, load_audio
from ..tokenizer import Tokenizer, get_tokenizer
from .config import TrainingConfig


def build_mtl_tokenizer(model_size: str) -> Tokenizer:
    """Disease-enabled tokenizer matching the model family."""
    if ".en" in model_size:
        return get_tokenizer(multilingual=False, include_diseases=True)
    return get_tokenizer(multilingual=True, language="en", task="transcribe", include_diseases=True)


class MultiTaskSpeechDataset:
    """CSV-driven dataset of (waveform, disease-conditioned token sequence)."""

    def __init__(self, csv_file: str, config: TrainingConfig, tokenizer: Optional[Tokenizer] = None):
        with open(csv_file, newline="", encoding="utf-8") as f:
            self.rows = list(csv.DictReader(f))
        self.config = config
        self.is_english_only = ".en" in getattr(config, "model_size", "")
        self.tokenizer = tokenizer or build_mtl_tokenizer(config.model_size)
        self.disease_mapping = config.class_to_disease

    def __len__(self) -> int:
        return len(self.rows)

    def get_disease_token_id(self, class_id: int) -> int:
        disease_name = self.disease_mapping.get(class_id, "normal")
        return self.tokenizer.disease_tokens.get(disease_name, self.tokenizer.eot)

    def create_sequence_with_disease_context(self, text: str, class_id: int) -> List[int]:
        """en-only [SOT][DISEASE][text][EOT];
        multilingual [SOT][<|en|>][DISEASE][<|transcribe|>][text][EOT]"""
        tok = self.tokenizer
        sequence = [tok.sot]
        disease_token_id = self.get_disease_token_id(class_id)
        if not self.is_english_only:
            sequence.extend([tok.language_token, disease_token_id, tok.transcribe])
        else:
            sequence.append(disease_token_id)
        sequence.extend(tok.encode(" " + str(text).strip()))
        sequence.append(tok.eot)
        return sequence

    def _load_waveform(self, audio_path: str) -> np.ndarray:
        """True-length waveform, trimmed (not padded) to the training window;
        a file that does not load gives one zero sample."""
        n_samples = getattr(self.config, "audio_samples", N_SAMPLES)
        try:
            return np.asarray(load_audio(audio_path), dtype=np.float32)[:n_samples]
        except Exception as e:
            print(f"Error loading audio {audio_path}: {e}")
            return np.zeros((1,), dtype=np.float32)

    def __getitem__(self, idx: int) -> Dict:
        row = self.rows[idx]
        try:
            audio = self._load_waveform(row["file"])
            text = str(row["text"])
            class_id = int(row["class"])
            seq = self.create_sequence_with_disease_context(text, class_id)
            return {
                "audio": audio,
                "input_tokens": seq[:-1],
                "target_tokens": seq[1:],
                "class": class_id,
                "text": text,
                "path": row["file"],
            }
        except Exception as e:  # a dummy sample, as the reference does
            print(f"Error loading sample {idx}: {e}")
            seq = self.create_sequence_with_disease_context("", 0)
            return {
                "audio": np.zeros((1,), dtype=np.float32),
                "input_tokens": seq[:-1],
                "target_tokens": seq[1:],
                "class": 0,
                "text": "",
                "path": row.get("file", "unknown"),
            }


def bucket_length(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def audio_buckets(config) -> tuple:
    """Waveform length buckets (config.audio_length_buckets; auto =
    quarter window and full window)."""
    n = getattr(config, "audio_samples", N_SAMPLES)
    explicit = getattr(config, "audio_length_buckets", None)
    if explicit:
        return tuple(explicit)
    return (max(1, n // 4), n)


def collate(items: List[Dict], tokenizer: Tokenizer, buckets, audio_len_buckets=(N_SAMPLES,)) -> Dict:
    """Stack a batch: inputs padded with EOT and targets with -100 up to a
    token bucket, waveforms zero-padded to the smallest audio length bucket
    that holds the batch."""
    max_len = max(max(len(it["input_tokens"]), len(it["target_tokens"])) for it in items)
    L = bucket_length(max_len, buckets)
    B = len(items)
    input_tokens = np.full((B, L), tokenizer.eot, np.int32)
    target_tokens = np.full((B, L), -100, np.int32)
    for i, it in enumerate(items):
        inp = it["input_tokens"][:L]
        tgt = it["target_tokens"][:L]
        input_tokens[i, : len(inp)] = inp
        target_tokens[i, : len(tgt)] = tgt

    A = bucket_length(max(len(it["audio"]) for it in items), audio_len_buckets)
    audio = np.zeros((B, A), np.float32)
    for i, it in enumerate(items):
        clip = it["audio"][:A]
        audio[i, : len(clip)] = clip
    return {
        "audio": audio,
        "input_tokens": input_tokens,
        "target_tokens": target_tokens,
        "classes": np.asarray([it["class"] for it in items], np.int32),
        "texts": [it["text"] for it in items],
        "paths": [it["path"] for it in items],
    }


class DataLoader:
    """Thread-pooled, prefetching batch loader (host side): seeded shuffle
    per epoch (the JAX package's order), optional drop_last."""

    def __init__(
        self,
        dataset: MultiTaskSpeechDataset,
        batch_size: int,
        shuffle: bool = False,
        num_workers: int = 8,
        drop_last: bool = False,
        seed: int = 0,
        prefetch_batches: int = 2,
        buckets=(48, 64, 96, 128, 192, 448),
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch_batches = prefetch_batches
        self.buckets = tuple(buckets)
        self.audio_len_buckets = audio_buckets(dataset.config)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        self._epoch += 1
        batches = [order[i : i + self.batch_size] for i in range(0, len(order), self.batch_size)]
        if self.drop_last and batches and len(batches[-1]) < self.batch_size:
            batches.pop()

        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch_batches)
        stop = threading.Event()
        errors: list = []

        def put_or_stop(item) -> bool:
            """A bounded put that gives up when the consumer has stopped."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # always end with the sentinel, so the consumer never hangs; an
            # error is raised again in the consumer's thread
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(self.dataset.__getitem__, idxs))
                        batch = collate(items, self.dataset.tokenizer, self.buckets, self.audio_len_buckets)
                        if not put_or_stop(batch):
                            return
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
            finally:
                put_or_stop(None)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                batch = out_q.get()
                if batch is None:
                    if errors:
                        raise errors[0]
                    return
                yield batch
        finally:
            stop.set()
            producer.join()
