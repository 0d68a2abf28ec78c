"""Loss functions.

Port of mmoe_multimodal_rec_tpu/train/losses.py:
- `weighted_bce_with_logits` == torch BCEWithLogitsLoss(pos_weight=...)
  (ref train.py:189-192), in the numerically stable log-sigmoid form;
- `contrastive_loss` == calculate_contrastive_loss (ref train_HoME.py:43-51):
  L2-normalize, in-batch similarity matrix / temperature, cross-entropy
  against the diagonal;
- `total_loss` assembles the task losses (+ HoME contrastive terms) as the
  trainers do (train.py:253-258, train_HoME.py:358-374).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import LossConfig


def weighted_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                             pos_weight: float,
                             valid: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """mean( -[pw*y*log σ(x) + (1-y)*log(1-σ(x))] ), optionally masked."""
    logits = logits.float()
    labels = labels.float()
    per = -(pos_weight * labels * F.logsigmoid(logits)
            + (1.0 - labels) * F.logsigmoid(-logits))
    if valid is None:
        return per.mean()
    w = valid.float()
    return (per * w).sum() / w.sum().clamp_min(1.0)


def contrastive_loss(anchor: torch.Tensor, positive: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """In-batch InfoNCE with the diagonal as positives."""
    a = anchor.float()
    p = positive.float()
    # rsqrt(sum^2 + eps), not /max(norm, eps): the latter has a NaN
    # gradient at exactly-zero rows
    a = a * torch.rsqrt((a * a).sum(1, keepdim=True) + 1e-12)
    p = p * torch.rsqrt((p * p).sum(1, keepdim=True) + 1e-12)
    sim = (a @ p.T) / temperature
    return (torch.logsumexp(sim, dim=1) - sim.diagonal()).mean()


class LossParts(NamedTuple):
    total: torch.Tensor
    main: torch.Tensor
    contrastive: torch.Tensor


def total_loss(logit_good, logit_best, labels_good, labels_best,
               cfg: LossConfig, aux: Optional[Dict[str, torch.Tensor]] = None,
               home: bool = False,
               valid: Optional[torch.Tensor] = None) -> LossParts:
    main = (weighted_bce_with_logits(logit_good, labels_good,
                                     cfg.pos_weight_good, valid)
            + weighted_bce_with_logits(logit_best, labels_best,
                                       cfg.pos_weight_best, valid))
    cl = torch.zeros((), dtype=torch.float32, device=main.device)
    if aux is not None and "gate_balance" in aux:
        # nonzero only under top-k gating; dense gates contribute 0
        main = main + cfg.lambda_gate_balance * aux["gate_balance"]
    if home and aux is not None:
        # RAW expert vectors feed the contrastive terms (train_HoME.py:360-364)
        cl = (cfg.lambda_cross
              * contrastive_loss(aux["ui_vec"], aux["i_doc"], cfg.temperature)
              + cfg.lambda_user_img
              * contrastive_loss(aux["u_doc"], aux["projected_img"],
                                 cfg.temperature)
              + cfg.lambda_item_img
              * contrastive_loss(aux["i_doc"], aux["projected_img"],
                                 cfg.temperature))
    return LossParts(main + cl, main, cl)
