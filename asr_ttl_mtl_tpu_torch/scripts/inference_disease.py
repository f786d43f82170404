"""Held-out report of a trained multi-task checkpoint (PyTorch port).

    python -m asr_ttl_mtl_tpu_torch.scripts.inference_disease --model_path best.pt \
        --test_csv test.csv [--save_results results.csv] [--device cpu]

Counterpart of the top-level `scripts/inference_disease.py`, with the same
report: teacher-forced argmax decoding (one decoder pass over the
ground-truth input tokens, `MultiTaskTrainer.eval_step`), per-sample WER /
CER averaged over samples, the softmax confidences, per-class aggregates,
precision / recall / F1 (`mtl/metrics.py`, no sklearn), the printed report
with its confusion matrix, and the timestamped results CSV and summary
JSON. Reads checkpoints of this port, of the JAX package or of the
reference. Runs on the card unless `--device cpu`.
"""

import argparse
import csv
import json
import os
from datetime import datetime

from asr_ttl_mtl_tpu_torch.mtl import DataLoader, MultiTaskSpeechDataset, MultiTaskTrainer
from asr_ttl_mtl_tpu_torch.mtl import metrics as M

CSV_COLUMNS = ("file_path", "original_text", "predicted_text", "wer", "cer", "true_disease", "predicted_disease",
               "true_class", "predicted_class", "disease_confidence", "disease_correct")


def run_inference(trainer: MultiTaskTrainer, dataloader) -> dict:
    """Per-sample results of the trainer's teacher-forced evaluation forward."""
    class_to_disease = trainer.class_to_disease
    per_class = {d: {"correct": 0, "total": 0, "wer_sum": 0.0, "cer_sum": 0.0} for d in class_to_disease.values()}
    all_results = []
    total_wer = total_cer = 0.0
    total_correct = total = 0

    for batch in dataloader:
        aux = trainer.eval_step(batch)
        pred_texts = trainer.decode_predictions(aux["pred_tokens"].cpu().numpy())
        disease_preds = aux["disease_preds"].cpu().numpy()
        disease_probs = aux["disease_probs"].float().cpu().numpy()

        for i in range(len(batch["classes"])):
            original = batch["texts"][i].strip()
            predicted = pred_texts[i].strip()
            on, pn = original.lower(), predicted.lower()
            if on and pn:
                sample_wer = M.wer([on], [pn])
                sample_cer = M.cer([on], [pn])
            else:
                sample_wer = sample_cer = 1.0

            true_class = int(batch["classes"][i])
            pred_class = int(disease_preds[i])
            true_disease = class_to_disease.get(true_class, "normal")
            predicted_disease = class_to_disease.get(pred_class, "normal")
            correct = true_class == pred_class
            all_probs = {
                name: float(disease_probs[i][cid]) if cid < disease_probs.shape[1] else 0.0
                for cid, name in class_to_disease.items()
            }
            all_results.append({
                "file_path": batch["paths"][i],
                "original_text": original,
                "predicted_text": predicted,
                "original_text_normalized": on,
                "predicted_text_normalized": pn,
                "wer": sample_wer,
                "cer": sample_cer,
                "true_disease": true_disease,
                "predicted_disease": predicted_disease,
                "true_class": true_class,
                "predicted_class": pred_class,
                "disease_confidence": float(disease_probs[i][pred_class]),
                "disease_correct": correct,
                "all_disease_probs": all_probs,
            })
            total_wer += sample_wer
            total_cer += sample_cer
            total_correct += int(correct)
            total += 1
            pc = per_class[true_disease]
            pc["total"] += 1
            pc["wer_sum"] += sample_wer
            pc["cer_sum"] += sample_cer
            pc["correct"] += int(correct)

    per_class_summary = {
        d: ({"samples": m["total"], "accuracy": m["correct"] / m["total"], "wer": m["wer_sum"] / m["total"],
             "cer": m["cer_sum"] / m["total"]}
            if m["total"] else {"samples": 0, "accuracy": 0.0, "wer": 1.0, "cer": 1.0})
        for d, m in per_class.items()
    }
    return {
        "total_samples": total,
        "overall_wer": total_wer / total if total else 1.0,
        "overall_cer": total_cer / total if total else 1.0,
        "disease_accuracy": total_correct / total if total else 0.0,
        "disease_correct": total_correct,
        "per_class_metrics": per_class_summary,
        "inference_results": all_results,
        "model_info": {
            "class_to_disease": class_to_disease,
            "model_size": trainer.config.model_size,
            "is_english_only": trainer.is_english_only,
        },
    }


def calculate_additional_metrics(results: dict) -> dict:
    data = results["inference_results"]
    m = M.classification_metrics([r["true_class"] for r in data], [r["predicted_class"] for r in data])
    keys = ("weighted_precision", "weighted_recall", "weighted_f1", "macro_precision", "macro_recall", "macro_f1",
            "per_class_precision", "per_class_recall", "per_class_f1", "per_class_support")
    return {k: m[k] for k in keys}


def print_results(results: dict, extra: dict):
    print(f"\n{'=' * 80}\n{'INFERENCE RESULTS':^80}\n{'=' * 80}")
    info = results["model_info"]
    print("\nModel Information:")
    print(f"  Model Size: {info['model_size']}")
    print(f"  Model Type: {'English-only' if info['is_english_only'] else 'Multilingual'}")
    print(f"  Disease Classes: {list(info['class_to_disease'].values())}")

    print("\nOverall Performance:")
    print(f"  Total Samples: {results['total_samples']}")
    print(f"  Disease Accuracy: {results['disease_accuracy']:.4f} "
          f"({results['disease_correct']}/{results['total_samples']})")
    print(f"  Overall WER: {results['overall_wer']:.4f}")
    print(f"  Overall CER: {results['overall_cer']:.4f}")

    print("\nClassification Metrics:")
    for k in ("weighted_precision", "weighted_recall", "weighted_f1", "macro_precision", "macro_recall", "macro_f1"):
        print(f"  {k.replace('_', ' ').title()}: {extra[k]:.4f}")

    print("\nPer-Class Performance:")
    print(f"{'Disease':<12} {'Samples':<8} {'Accuracy':<9} {'Precision':<10} "
          f"{'Recall':<8} {'F1-Score':<9} {'WER':<6} {'CER':<6}")
    print("-" * 80)
    for class_id, disease in info["class_to_disease"].items():
        pm = results["per_class_metrics"][disease]
        print(f"{disease.capitalize():<12} {pm['samples']:<8} {pm['accuracy']:<9.4f} "
              f"{extra['per_class_precision'][class_id]:<10.4f} "
              f"{extra['per_class_recall'][class_id]:<8.4f} "
              f"{extra['per_class_f1'][class_id]:<9.4f} "
              f"{pm['wer']:<6.3f} {pm['cer']:<6.3f}")

    data = results["inference_results"]
    cm = M.confusion_matrix([r["true_class"] for r in data], [r["predicted_class"] for r in data])
    names = [d.capitalize() for d in info["class_to_disease"].values()]
    print("\nConfusion Matrix:")
    print(f"{'Actual \\ Predicted':<15} " + " ".join(f"{n:<10}" for n in names))
    print("-" * (15 + 11 * len(names)))
    for i, n in enumerate(names):
        print(f"{n:<15} " + " ".join(f"{cm[i][j]:<10}" for j in range(len(names))))

    print("\nSample Predictions (First 5):")
    print(f"{'File':<20} {'True':<12} {'Pred':<12} {'Conf':<6} {'WER':<6} {'Text':<30}")
    print("-" * 90)
    for s in data[:5]:
        fname = os.path.basename(s["file_path"])[:17] + "..."
        text = s["predicted_text"]
        text = text[:27] + "..." if len(text) > 30 else text
        print(f"{fname:<20} {s['true_disease']:<12} {s['predicted_disease']:<12} "
              f"{s['disease_confidence']:<6.3f} {s['wer']:<6.3f} {text:<30}")


def save_results(results: dict, extra: dict, output_path: str):
    """`<output_path minus .csv>_<timestamp>.csv`, one row a sample (the
    layout pandas' `to_csv(index=False)` gives the JAX script's), and
    `..._summary.json`. Returns the two paths."""
    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    base = output_path.replace(".csv", f"_{timestamp}")

    rows = []
    for s in results["inference_results"]:
        row = {k: s[k] for k in CSV_COLUMNS}
        for disease, prob in s["all_disease_probs"].items():
            row[f"{disease}_prob"] = prob
        rows.append(row)
    csv_path = f"{base}.csv"
    columns = list(dict.fromkeys(k for row in rows for k in row))
    with open(csv_path, "w", newline="", encoding="utf-8") as f:
        writer = csv.DictWriter(f, fieldnames=columns, lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    print(f"Results saved to: {csv_path}")

    json_path = f"{base}_summary.json"
    with open(json_path, "w") as f:
        json.dump(
            {
                "model_info": results["model_info"],
                "overall_metrics": {
                    "total_samples": results["total_samples"],
                    "disease_accuracy": results["disease_accuracy"],
                    "overall_wer": results["overall_wer"],
                    "overall_cer": results["overall_cer"],
                },
                "classification_metrics": extra,
                "per_class_metrics": results["per_class_metrics"],
                "timestamp": timestamp,
            },
            f,
            indent=2,
            default=str,
        )
    print(f"Summary saved to: {json_path}")
    return csv_path, json_path


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Multi-Task Model Inference (PyTorch port)")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--data_dir", type=str, default="../data")
    parser.add_argument("--test_file", type=str, default="custom_test.csv")
    parser.add_argument("--test_csv", type=str, default=None,
                        help="path to the test CSV (overrides --data_dir/--test_file, which resolve relative "
                             "to the scripts directory, as the reference's do)")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--save_results", type=str, default=None)
    parser.add_argument("--device", type=str, default="auto", choices=["auto", "cuda", "cpu"],
                        help="where to run: auto (the card) | cuda | cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Returns (results, extra metrics), or None when an input is missing."""
    args = parse_args(argv)
    if args.test_csv:
        test_csv = args.test_csv
    else:
        script_dir = os.path.dirname(os.path.abspath(__file__))
        test_csv = os.path.normpath(os.path.join(script_dir, args.data_dir, args.test_file))
    if not os.path.exists(test_csv):
        print(f"Error: Test file not found: {test_csv}")
        return None
    if not os.path.exists(args.model_path):
        print(f"Error: Model checkpoint not found: {args.model_path}")
        return None

    print("Loading model...")
    trainer = MultiTaskTrainer.load_from_checkpoint(args.model_path, device=args.device)
    print("Loading dataset...")
    test_ds = MultiTaskSpeechDataset(test_csv, trainer.config)
    test_loader = DataLoader(test_ds, args.batch_size, shuffle=False, num_workers=4)
    print(f"Dataset loaded: {len(test_ds)} samples")

    print("Running inference...")
    results = run_inference(trainer, test_loader)
    extra = calculate_additional_metrics(results)
    print_results(results, extra)
    if args.save_results:
        save_results(results, extra, args.save_results)
    print("\nInference completed successfully!")
    return results, extra


if __name__ == "__main__":
    main()
