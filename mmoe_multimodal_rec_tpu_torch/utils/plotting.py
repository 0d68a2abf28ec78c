"""Matplotlib artifacts matching the reference's outputs: per-step and
per-epoch loss curves (train.py:372-419; 3-panel HoME variant
train_HoME.py:458-530) and ROC curves (inference_and_auc.py:44-64,
infer_auc_HoME:217-233).

Port of mmoe_multimodal_rec_tpu/utils/plotting.py, drawing the same
figures.  matplotlib is imported inside each function, on the Agg backend,
because a training or serving host need not have it (the card's machine
does not): there each function prints one line on stderr naming the PNG it
did not write and returns None, and the run goes on.  Only the ImportError
of matplotlib itself is caught; any other failure propagates."""
from __future__ import annotations

import os
import sys
from typing import Dict, Optional, Sequence


def _pyplot(path: str):
    """matplotlib.pyplot on the Agg backend, or None (with a line on stderr
    naming `path`) when matplotlib cannot be imported."""
    try:
        import matplotlib
    except ImportError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        print(f"[plot] matplotlib cannot be imported ({e}): {path} not "
              "written", file=sys.stderr, flush=True)
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_loss_curves(steps: Sequence[int], losses: Dict[str, Sequence[float]],
                     output_dir: str, prefix: str = "train") -> Optional[str]:
    """One stacked panel per loss series (total/main/contrastive)."""
    path = os.path.join(output_dir, f"{prefix}_loss_curves.png")
    plt = _pyplot(path)
    if plt is None:
        return None
    os.makedirs(output_dir, exist_ok=True)
    series = {k: v for k, v in losses.items() if len(v)}
    n = max(len(series), 1)
    fig, axes = plt.subplots(n, 1, figsize=(10, 4 * n), squeeze=False)
    for ax, (name, vals) in zip(axes[:, 0], series.items()):
        ax.plot(steps[:len(vals)], vals, lw=1)
        ax.set_title(name)
        ax.set_xlabel("optimizer step")
        ax.set_ylabel("loss")
        ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_epoch_losses(epoch_losses: Dict[str, Sequence[float]],
                      output_dir: str, prefix: str = "train"
                      ) -> Optional[str]:
    path = os.path.join(output_dir, f"{prefix}_epoch_losses.png")
    plt = _pyplot(path)
    if plt is None:
        return None
    os.makedirs(output_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, vals in epoch_losses.items():
        if len(vals):
            ax.plot(range(len(vals)), vals, marker="o", label=name)
    ax.set_xlabel("epoch")
    ax.set_ylabel("avg loss")
    if any(len(v) for v in epoch_losses.values()):
        ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path


def plot_roc(curves: Dict[str, tuple], output_dir: str,
             filename: str = "roc_curve.png") -> Optional[str]:
    """curves: {task: (fpr, tpr, auc)} -> combined ROC plot."""
    path = os.path.join(output_dir, filename)
    plt = _pyplot(path)
    if plt is None:
        return None
    os.makedirs(output_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(8, 6))
    for task, (fpr, tpr, auc) in curves.items():
        ax.plot(fpr, tpr, lw=2, label=f"{task} (AUC={auc:.4f})")
    ax.plot([0, 1], [0, 1], ls="--", lw=1, color="gray",
            label="random (AUC=0.5)")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.05)
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.set_title("ROC curves")
    ax.legend(loc="lower right")
    ax.grid(True, alpha=0.3)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return path
