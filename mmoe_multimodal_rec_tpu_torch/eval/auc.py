"""AUC / ROC computation.

Replaces sklearn's roc_auc_score/roc_curve in the eval scripts
(ref inference_and_auc.py:162-182, infer_auc_HoME:209-233) with a
dependency-light exact implementation (rank-statistic AUC with proper tie
handling) that is verified against sklearn in tests.  Predictions stream in
per batch and accumulate on host — the device part of eval is just the
batched forward (train/step.make_eval_step).

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/eval/auc.py (numpy
only).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def roc_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact AUC == Mann-Whitney U statistic with midrank ties."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    n_pos = int(labels.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("roc_auc needs both classes present")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    ranks = np.empty(labels.size, np.float64)
    i = 0
    while i < labels.size:
        j = i
        while j + 1 < labels.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0  # midrank (1-based)
        i = j + 1
    pos_rank_sum = ranks[labels].sum()
    return float((pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def roc_curve(labels: np.ndarray, scores: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) at every distinct score (descending)."""
    labels = np.asarray(labels).astype(bool)
    scores = np.asarray(scores, np.float64)
    order = np.argsort(-scores, kind="mergesort")
    labels = labels[order]
    scores = scores[order]
    distinct = np.where(np.diff(scores))[0]
    idx = np.r_[distinct, labels.size - 1]
    tps = np.cumsum(labels)[idx].astype(np.float64)
    fps = (idx + 1) - tps
    tpr = np.r_[0.0, tps] / max(tps[-1], 1)
    fpr = np.r_[0.0, fps] / max(fps[-1], 1)
    thresholds = np.r_[scores[0] + 1.0, scores[idx]]
    return fpr, tpr, thresholds


class StreamingPredictions:
    """Accumulates (prob, label) pairs batch by batch, honoring the eval
    loader's `valid` mask (padded final batch)."""

    def __init__(self):
        self._probs: Dict[str, list] = {"good": [], "best": []}
        self._labels: Dict[str, list] = {"good": [], "best": []}
        self.n = 0

    def update(self, outputs: Dict[str, np.ndarray]) -> None:
        valid = np.asarray(outputs["valid"]).astype(bool)
        for task in ("good", "best"):
            self._probs[task].append(
                np.asarray(outputs[f"prob_{task}"])[valid])
            self._labels[task].append(
                np.asarray(outputs[f"label_{task}"])[valid])
        self.n += int(valid.sum())

    def concatenated(self, task: str) -> Tuple[np.ndarray, np.ndarray]:
        if not self._labels[task]:   # zero batches streamed -> empty, not
            return (np.zeros(0, np.float32),  # np.concatenate ValueError
                    np.zeros(0, np.float32))
        return (np.concatenate(self._labels[task]),
                np.concatenate(self._probs[task]))

    def aucs(self) -> Dict[str, float]:
        out = {}
        for task in ("good", "best"):
            labels, probs = self.concatenated(task)
            try:
                out[task] = roc_auc(labels, probs)
            except ValueError:
                out[task] = float("nan")
        return out
