"""Evaluation entry points: the streamed eval pass, AUC, predictions CSV, and
HoME BatchNorm recalibration.

Port of mmoe_multimodal_rec_tpu/eval/evaluate.py (which replaces the
reference's inference_and_auc.py and infer_auc_HoME).  The forward runs
once per batch on the static shapes of the eval loader, which pads the
trailing batch and sets `valid` instead of letting the shape shrink; the
batches are staged on the model's device ahead of use
(data/loader.device_prefetch), and each batch's probabilities come back to
the host once.

The port's model holds its own weights and BatchNorm statistics, so these
functions take the model (on its device) where JAX takes
(trainable, frozen, batch_stats).  Recalibration (ref
infer_auc_HoME:64-125) streams batches through the full forward with only
the BatchNorm running statistics moving, weights untouched and dropout
off; here the statistics move IN PLACE in the model (JAX returns new
ones).  `total_samples=None` streams one full pass over the shards, as in
JAX (the reference hardcodes 22281, its full valid split).

`output_dir` gets the ROC curves (utils/plotting.plot_roc, roc_curve.png;
where matplotlib cannot be imported, a line on stderr says so instead) and,
with `save_preds`, the predictions CSV.
"""
from __future__ import annotations

import csv
import math
import os
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..config import Config
from ..data.loader import device_prefetch, make_eval_loader
from ..data.packer import TextPacker, packer_from_config
from ..train.step import make_bn_recalibration_step, make_eval_step
from ..utils.plotting import plot_roc
from .auc import StreamingPredictions, roc_curve


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _on_device(loader, device, max_batches: Optional[int]):
    """The loader's batches on `device` (two in flight), at most
    `max_batches` of them."""
    def bounded():
        for i, batch in enumerate(loader):
            if max_batches and i >= max_batches:
                return
            yield batch
    return device_prefetch(bounded(), n=2, device=device)


def recalibrate_bn(cfg: Config, model: torch.nn.Module,
                   shard_paths: Sequence[str], packer: TextPacker,
                   total_samples: Optional[int] = None,
                   bn_batch_size: int = 128) -> Dict[str, torch.Tensor]:
    """Refresh the BatchNorm running statistics of `model`, in place, over
    ceil(total_samples / bn_batch_size) eval batches (None: one full pass
    over the shards); returns the model's buffers by name."""
    recal_step = make_bn_recalibration_step(cfg, model)
    max_batches = (math.ceil(total_samples / bn_batch_size)
                   if total_samples else None)
    loader = make_eval_loader(shard_paths, bn_batch_size, packer,
                              chunk_budget=cfg.model.packer.chunk_budget)
    try:
        for batch in _on_device(loader, _device(model), max_batches):
            recal_step(batch)
    finally:
        loader.close()
    return dict(model.named_buffers())


def evaluate(cfg: Config, model: torch.nn.Module,
             shard_paths: Sequence[str],
             packer: Optional[TextPacker] = None,
             batch_size: Optional[int] = None,
             recalibrate: bool = False,
             recal_total_samples: Optional[int] = None,
             bn_batch_size: int = 128,
             output_dir: Optional[str] = None,
             save_preds: Optional[str] = None,
             max_batches: Optional[int] = None,
             eval_step: Optional[Callable] = None) -> Dict[str, float]:
    """Full eval pass -> {'good': auc, 'best': auc, 'n': count}.

    `max_batches` bounds the streamed pass (mid-training monitoring);
    `eval_step` lets callers reuse one step across repeated evals.  With
    `recalibrate`, the model's BatchNorm statistics are recalibrated first
    (in place).  With `output_dir`, the ROC curves of the tasks that saw
    both labels go to `output_dir/roc_curve.png`, and with `save_preds` the
    predictions to `output_dir/save_preds`, as JAX writes them."""
    packer = packer or packer_from_config(cfg)
    batch_size = batch_size or cfg.train.batch_size
    if recalibrate:
        recalibrate_bn(cfg, model, shard_paths, packer, recal_total_samples,
                       bn_batch_size)
    eval_step = eval_step or make_eval_step(cfg, model)
    preds = StreamingPredictions()
    loader = make_eval_loader(shard_paths, batch_size, packer,
                              chunk_budget=cfg.model.packer.chunk_budget)
    try:
        for batch in _on_device(loader, _device(model), max_batches):
            out = eval_step(batch)
            preds.update({k: v.cpu().numpy() for k, v in out.items()})
    finally:
        loader.close()

    aucs = preds.aucs()
    result = {"good": aucs["good"], "best": aucs["best"], "n": preds.n}
    if not output_dir:
        return result
    os.makedirs(output_dir, exist_ok=True)
    curves = {}
    for task in ("good", "best"):
        labels, probs = preds.concatenated(task)
        if len(np.unique(labels)) == 2:
            fpr, tpr, _ = roc_curve(labels, probs)
            curves[task] = (fpr, tpr, aucs[task])
    if curves:
        plot_roc(curves, output_dir)
    if save_preds:
        lg, pg = preds.concatenated("good")
        lb, pb = preds.concatenated("best")
        with open(os.path.join(output_dir, save_preds), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["prob_good", "label_good", "prob_best", "label_best"])
            for row in zip(pg, lg, pb, lb):
                w.writerow([f"{row[0]:.6f}", int(row[1]),
                            f"{row[2]:.6f}", int(row[3])])
    return result


def evaluate_from_config(cfg: Config, model: torch.nn.Module,
                         recalibrate: bool = False) -> Dict[str, float]:
    """Eval entry over data.valid_pattern for a model (trained, restored
    or converted); writes output_dir/preds.csv."""
    from ..data.io import fs_glob
    shards = fs_glob(cfg.data.valid_pattern)
    if not shards:
        raise FileNotFoundError(f"no shards match {cfg.data.valid_pattern!r}")
    return evaluate(cfg, model, shards, recalibrate=recalibrate,
                    output_dir=cfg.train.output_dir, save_preds="preds.csv")
