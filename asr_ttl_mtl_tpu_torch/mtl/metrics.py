"""Evaluation metrics for the MTL task: WER/CER and classification reports.

Counterpart of `asr_ttl_mtl_tpu/mtl/metrics.py`. WER/CER have jiwer's corpus
semantics (total edits over total reference length; whitespace words for
WER, characters for CER). The classification metrics give what the JAX
package's sklearn calls give (`zero_division=0`, labels = the sorted union
of labels and predictions), computed here with numpy: the card's machine
has no sklearn.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance via Myers' bit-parallel scan (Hyyrö's variant).

    The DP column is carried as positive/negative delta bitvectors in Python
    big ints, so each reference symbol costs O(1) big-int ops instead of an
    O(len(hyp)) inner loop — ~15-100x faster on transcript-length strings,
    which dominates the host side of evaluate() (one WER/CER per sample +
    per class). Fuzz-verified against the classic O(nm) DP.
    """
    m = len(hyp)
    if m == 0:
        return len(ref)
    if len(ref) == 0:
        return m
    peq: Dict = {}
    bit = 1
    for h in hyp:
        peq[h] = peq.get(h, 0) | bit
        bit <<= 1
    mask = (1 << m) - 1
    last = 1 << (m - 1)
    pv, mv, score = mask, 0, m
    for r in ref:
        eq = peq.get(r, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (mask & ~(xh | pv))
        mh = pv & xh
        if ph & last:
            score += 1
        elif mh & last:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        pv = (mh << 1 | (mask & ~(xv | ph))) & mask
        mv = ph & xv
    return score


def _norm_words(text: str) -> List[str]:
    return re.sub(r"\s+", " ", text.strip()).split(" ") if text.strip() else []


def _norm_chars(text: str) -> List[str]:
    return list(re.sub(r"\s+", " ", text.strip()))


def wer(references: List[str], hypotheses: List[str]) -> float:
    """Corpus word error rate: sum(edits) / sum(reference words)."""
    assert len(references) == len(hypotheses)
    edits = total = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = _norm_words(ref), _norm_words(hyp)
        edits += _edit_distance(r, h)
        total += len(r)
    return edits / total if total else 0.0


def cer(references: List[str], hypotheses: List[str]) -> float:
    """Corpus character error rate: sum(edits) / sum(reference chars)."""
    assert len(references) == len(hypotheses)
    edits = total = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = _norm_chars(ref), _norm_chars(hyp)
        edits += _edit_distance(r, h)
        total += len(r)
    return edits / total if total else 0.0


def _prf(labels: Sequence[int], predictions: Sequence[int]):
    """Per-class precision, recall, F1 and support over the sorted union of
    labels and predictions; 0 where a denominator is 0."""
    y, p = np.asarray(labels, np.int64), np.asarray(predictions, np.int64)
    classes = np.union1d(y, p)
    tp = np.array([np.sum((y == c) & (p == c)) for c in classes], np.float64)
    pred_n = np.array([np.sum(p == c) for c in classes], np.float64)
    true_n = np.array([np.sum(y == c) for c in classes], np.float64)

    def div(a, b):
        return np.divide(a, b, out=np.zeros_like(a), where=b > 0)

    prec, rec = div(tp, pred_n), div(tp, true_n)
    f1 = div(2 * tp, pred_n + true_n)
    return prec, rec, f1, true_n.astype(np.int64)


def classification_metrics(labels: Sequence[int], predictions: Sequence[int]) -> Dict:
    """Accuracy + weighted/macro/per-class P/R/F1."""
    labels = list(labels)
    predictions = list(predictions)
    prec, rec, f1, sup = _prf(labels, predictions)
    w = sup / sup.sum() if sup.sum() > 0 else np.zeros(len(sup))
    acc = float(np.mean(np.asarray(labels) == np.asarray(predictions))) if labels else 0.0
    return {
        "disease_acc": acc,
        "weighted_f1": float(np.sum(f1 * w)),
        "macro_f1": float(np.mean(f1)),
        "weighted_precision": float(np.sum(prec * w)),
        "weighted_recall": float(np.sum(rec * w)),
        "macro_precision": float(np.mean(prec)),
        "macro_recall": float(np.mean(rec)),
        "per_class_precision": prec.tolist(),
        "per_class_recall": rec.tolist(),
        "per_class_f1": f1.tolist(),
        "per_class_support": sup.tolist(),
    }


def confusion_matrix(labels: Sequence[int], predictions: Sequence[int], n_classes: int = 3):
    m = np.zeros((n_classes, n_classes), dtype=np.int64)
    for l, p in zip(labels, predictions):
        m[int(l), int(p)] += 1
    return m


def detailed_metrics(
    pred_texts: List[str],
    ref_texts: List[str],
    disease_predictions: Sequence[int],
    disease_labels: Sequence[int],
    disease_names: Tuple[str, ...] = ("normal", "dysphonia", "dysarthria"),
) -> Dict:
    """Full metric block matching reference trainer.compute_detailed_metrics
    (trainer.py:246-324): overall + per-class classification and WER/CER."""
    metrics: Dict = {}
    if len(disease_predictions) > 0:
        metrics.update(classification_metrics(disease_labels, disease_predictions))

    if pred_texts and ref_texts:
        valid = [(p.lower(), r.lower()) for p, r in zip(pred_texts, ref_texts) if r.strip()]
        if valid:
            preds, refs = zip(*valid)
            metrics["wer"] = wer(list(refs), list(preds))
            metrics["cer"] = cer(list(refs), list(preds))

    per_class: Dict[str, Dict] = {}
    if len(pred_texts) == len(ref_texts) == len(disease_labels) and pred_texts:
        for class_id, name in enumerate(disease_names):
            idxs = [i for i, l in enumerate(disease_labels) if l == class_id]
            if not idxs:
                continue
            pairs = [
                (pred_texts[i].lower(), ref_texts[i].lower())
                for i in idxs
                if ref_texts[i].strip()
            ]
            if pairs:
                preds, refs = zip(*pairs)
                per_class[name] = {
                    "wer": wer(list(refs), list(preds)),
                    "cer": cer(list(refs), list(preds)),
                    "samples": len(idxs),
                    "valid_samples": len(pairs),
                }
            else:
                per_class[name] = {
                    "wer": 1.0,
                    "cer": 1.0,
                    "samples": len(idxs),
                    "valid_samples": 0,
                }
    metrics["per_class_transcription"] = per_class
    return metrics
