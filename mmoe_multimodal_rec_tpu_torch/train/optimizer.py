"""Parameter partitioning + AdamW groups + freeze->warmup schedule + clip.

Port of mmoe_multimodal_rec_tpu/train/optimizer.py (ref train.py:150-186):
- params partition into labels {other, lora, img_ft, frozen} by their path
  (the torch parameter name split at '.', which follows the JAX tree);
  `frozen` params get requires_grad=False, so autograd builds no graph
  through them and computes no gradient for them;
- `other` (cross/fuse/head): constant lr; `lora` (and HoME `img_ft`): lr 0
  for `freeze_steps` optimizer steps, linear warmup over `unfreeze_steps`,
  then constant;
- `clip_by_global_norm` is optax's: every gradient is scaled by
  max_norm / norm only when norm >= max_norm (torch's clip_grad_norm_ adds
  1e-6 to the norm, which would break parity);
- torch AdamW == optax.adamw: eps outside the square root, decoupled weight
  decay multiplied by the scheduled lr (so zero while LoRA is frozen), and
  LambdaLR's count starts at 0 on the first update, as optax's does.

Reference quirks kept: the baseline text experts' final LayerNorms and the
whole baseline img_expert are in NO param group (train.py:151-162) and stay
at init.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..config import OptimConfig
from ..parallel.mesh import Axis


def label_param(path: Tuple[str, ...], variant: str,
                vit_layers: int = 12, vit_unfrozen: int = 2) -> str:
    """Map a parameter path to its optimizer group."""
    parts = set(path)
    top = path[0]
    if "lora_a" in parts or "lora_b" in parts:
        return "lora"
    if top in ("cross_ui", "concat_ui", "concat_ti", "head") or \
            top.endswith("_wrapper"):
        return "other"
    if variant == "home" and top == "img_expert":
        if "projection_head" in parts:
            return "img_ft"
        for i in range(vit_layers - vit_unfrozen, vit_layers):
            if f"layer_{i}" in parts:
                return "img_ft"
        return "frozen"
    return "frozen"


def split_trainable(model: nn.Module, variant: str
                    ) -> Tuple[Dict[str, nn.Parameter],
                               Dict[str, nn.Parameter]]:
    """(trainable, frozen) parameters by name; sets requires_grad=False on
    every frozen one."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        if label_param(tuple(name.split(".")), variant) == "frozen":
            p.requires_grad_(False)
            frozen[name] = p
        else:
            trainable[name] = p
    return trainable, frozen


def freeze_warmup_schedule(base_lr: float, freeze_steps: int,
                           unfreeze_steps: int) -> Callable[[int], float]:
    """0 for count <= freeze; linear to base over unfreeze; then base
    (== lr_lora, train.py:173-182; one count per optimizer step)."""
    def schedule(count: int) -> float:
        frac = (count - freeze_steps) / max(unfreeze_steps, 1)
        return base_lr * min(max(frac, 0.0), 1.0)
    return schedule


def make_optimizer(cfg: OptimConfig, variant: str,
                   trainable: Dict[str, nn.Parameter]):
    """AdamW over the trainable params, one group per label, and the
    LambdaLR that drives the scheduled groups.  Returns (optimizer,
    scheduler); step both once per optimizer update, never on a skipped
    one."""
    freeze = cfg.home_freeze_steps if variant == "home" else cfg.freeze_steps
    warm = (cfg.home_unfreeze_steps if variant == "home"
            else cfg.unfreeze_steps)
    sched = freeze_warmup_schedule(1.0, freeze, warm)
    factors = {"other": lambda count: 1.0, "lora": sched, "img_ft": sched}
    by_label: Dict[str, List[nn.Parameter]] = {}
    for name, p in trainable.items():
        by_label.setdefault(label_param(tuple(name.split(".")), variant),
                            []).append(p)
    labels = [k for k in factors if k in by_label]
    opt = torch.optim.AdamW([{"params": by_label[k], "label": k}
                             for k in labels],
                            lr=cfg.lr, betas=(cfg.b1, cfg.b2), eps=cfg.eps,
                            weight_decay=cfg.weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, [factors[k] for k in labels])
    return opt, scheduler


def global_norm(grads: List[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None,
                model: Optional[Axis] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in fp32.  Under tensor
    parallelism (`model`, the mesh's model axis, and `sharded`, which
    gradients are model shards) the shards' squares are summed over the
    axis and the replicated gradients, alike on every rank, count once."""
    squares = [g.float().pow(2).sum() for g in grads]
    if model is None or model.size == 1:
        return torch.stack(squares).sum().sqrt()
    zero = torch.zeros((), device=grads[0].device)
    rep = sum((q for q, s in zip(squares, sharded) if not s), zero)
    part = sum((q for q, s in zip(squares, sharded) if s), zero)
    dist.all_reduce(part, group=model.group)
    return (rep + part).sqrt()


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm where
    norm >= max_norm, g unchanged otherwise (no host sync)."""
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
