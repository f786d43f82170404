"""Evaluation report of a trained multi-task checkpoint (PyTorch port).

    python -m asr_ttl_mtl_tpu_torch.scripts.evaluate_disease --model_path best.pt \
        --csv val.csv [--output_json report.json] [--device cpu]

Counterpart of the top-level `scripts/evaluate_disease.py`: the trainer's
corpus metrics (`MultiTaskTrainer.evaluate`, `mtl/metrics.py`) on any split,
with the per-class transcription breakdown, printed and optionally written
as JSON. Runs on the card unless `--device cpu`.
"""

import argparse
import json

import numpy as np

from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Multi-Task Model Evaluation (PyTorch port)")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--csv", type=str, required=True, help="split CSV to evaluate")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--output_json", type=str, default=None)
    parser.add_argument("--device", type=str, default="auto", choices=["auto", "cuda", "cpu"],
                        help="where to run: auto (the card) | cuda | cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns the metrics dict."""
    args = parse_args(argv)
    trainer = MultiTaskTrainer.load_from_checkpoint(args.model_path, device=args.device)
    dataset = MultiTaskSpeechDataset(args.csv, trainer.config)
    loader = DataLoader(dataset, args.batch_size, shuffle=False, num_workers=4)
    print(f"Evaluating {len(dataset)} samples from {args.csv}")

    metrics = trainer.evaluate(loader)

    print(f"\n{'=' * 70}\n{'EVALUATION REPORT':^70}\n{'=' * 70}")
    print(f"Loss: {metrics['loss']:.4f} (cls {metrics['cls_loss']:.4f}, trans {metrics['trans_loss']:.4f})")
    if "disease_acc" in metrics:
        print(f"Disease accuracy: {metrics['disease_acc']:.4f}")
        print(f"Macro F1: {metrics['macro_f1']:.4f}  Weighted F1: {metrics['weighted_f1']:.4f}")
    if "wer" in metrics:
        print(f"Corpus WER: {metrics['wer']:.4f}  CER: {metrics['cer']:.4f}")
    if metrics.get("per_class_transcription"):
        print(f"\n{'Class':<12} {'WER':<7} {'CER':<7} {'Samples':<8}")
        print("-" * 36)
        for name, m in metrics["per_class_transcription"].items():
            print(f"{name.capitalize():<12} {m['wer']:<7.4f} {m['cer']:<7.4f} {m['samples']:<8}")

    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(metrics, f, indent=2, default=lambda o: np.asarray(o).tolist())
        print(f"\nReport saved: {args.output_json}")
    return metrics


if __name__ == "__main__":
    main()
