"""Loss functions.

Port of mmoe_multimodal_rec_tpu/train/losses.py:
- `weighted_bce_with_logits` == torch BCEWithLogitsLoss(pos_weight=...)
  (ref train.py:189-192), in the numerically stable log-sigmoid form;
- `contrastive_loss` == calculate_contrastive_loss (ref train_HoME.py:43-51):
  L2-normalize, in-batch similarity matrix / temperature, cross-entropy
  against the diagonal;
- `total_loss` assembles the task losses (+ HoME contrastive terms) as the
  trainers do (train.py:253-258, train_HoME.py:358-374).

`data` (the mesh's data axis of a data-parallel step, parallel/mesh.py):
each function returns the rank's share of the global micro-batch's loss,
so the shares sum to it and the sum of the ranks' gradients is its
gradient.  The BCE divides by the global count (or weight sum), the
contrastive logits run against the pool gathered over `data` (with its
gradient), and the replicated top-k balance term counts 1/dp on each.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import LossConfig
from ..parallel.mesh import Axis, gather_over_data, sum_over_data


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             pos_weight: float,
                             valid: Optional[torch.Tensor] = None,
                             data: Optional[Axis] = None) -> torch.Tensor:
    """mean( -[pw*y*log σ(x) + (1-y)*log(1-σ(x))] ), optionally masked."""
    logits = logits.float()
    labels = labels.float()
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    if valid is None:
        if data is None:
            return per.mean()
        return per.sum() / (per.shape[0] * data.size)
    w = valid.float()
    total = w.sum() if data is None else sum_over_data(w.sum(), data)
    return (per * w).sum() / total.clamp_min(1.0)


def contrastive_loss(anchor: torch.Tensor, positive: torch.Tensor,
                     temperature: float = 0.07,
                     data: Optional[Axis] = None) -> torch.Tensor:
    """In-batch InfoNCE with the diagonal as positives."""
    a = anchor.float()
    p = positive.float()
    # rsqrt(sum^2 + eps), not /max(norm, eps): the latter has a NaN
    # gradient at exactly-zero rows
    a = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-12)
    p = p * torch.rsqrt((p * p).sum(1, keepdim=True) + 1e-12)
    if data is None:
        sim = (a @ p.T) / temperature
        return (torch.logsumexp(sim, dim=1) - sim.diagonal()).mean()
    b = a.shape[0]
    sim = (a @ gather_over_data(p, data).T) / temperature
    pos = sim.diagonal(offset=data.rank * b)
    return (torch.logsumexp(sim, dim=1) - pos).sum() / (b * data.size)


class LossParts(NamedTuple):
    total: torch.Tensor
    main: torch.Tensor
    contrastive: torch.Tensor


def total_loss(logit_good, logit_best, labels_good, labels_best,
               cfg: LossConfig, aux: Optional[Dict[str, torch.Tensor]] = None,
               home: bool = False,
               valid: Optional[torch.Tensor] = None,
               data: Optional[Axis] = None) -> LossParts:
    main = (weighted_bce_with_logits(logit_good, labels_good,
                                     cfg.pos_weight_good, valid, data)
            + weighted_bce_with_logits(logit_best, labels_best,
                                       cfg.pos_weight_best, valid, data))
    cl = torch.zeros((), dtype=torch.float32, device=main.device)
    if aux is not None and "gate_balance" in aux:
        # nonzero only under top-k gating; dense gates contribute 0
        balance = aux["gate_balance"]
        if data is not None:
            balance = balance / data.size
        main = main + cfg.lambda_gate_balance * balance
    if home and aux is not None:
        # RAW expert vectors feed the contrastive terms (train_HoME.py:360-364)
        cl = (cfg.lambda_cross
              * contrastive_loss(aux["ui_vec"], aux["i_doc"], cfg.temperature,
                                 data)
              + cfg.lambda_user_img
              * contrastive_loss(aux["u_doc"], aux["projected_img"],
                                 cfg.temperature, data)
              + cfg.lambda_item_img
              * contrastive_loss(aux["i_doc"], aux["projected_img"],
                                 cfg.temperature, data))
    return LossParts(main + cl, main, cl)
