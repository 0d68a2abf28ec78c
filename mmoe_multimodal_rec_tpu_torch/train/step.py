"""One optimizer step over `grad_accum` micro-batches.

Port of mmoe_multimodal_rec_tpu/train/step.py `make_train_step`.  PyTorch
runs eagerly, so the JAX step's `lax.scan` is a Python loop over the
micro-batches; the semantics are the same:
- each micro-batch's gradients are added only if its loss is finite (the
  test runs on the card, `torch.where`, no host sync), and the NaN ones
  are counted in `skipped_micro`;
- the model's buffers (HoME's BatchNorm running statistics, which each
  training forward moves in place and which carry from one micro-batch to
  the next in order) keep a NaN micro-batch's move only if its loss is
  finite, as JAX keeps its `batch_stats` (`torch.where`, no host sync);
- the summed gradients are divided by `grad_accum` whatever was skipped
  (the reference divides every micro-loss by ACCUM, train.py:258);
- `grad_norm` is the global norm before the clip;
- when every micro-batch was bad, neither the optimizer nor its schedule
  steps, as JAX keeps `opt_state` and `state.step` then.  Telling that
  apart is the step's one host sync.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from ..config import Config
from .losses import total_loss
from .optimizer import clip_by_global_norm, global_norm


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler
                    ) -> Callable[[Dict[str, torch.Tensor],
                                   Sequence[torch.Generator]],
                                  Dict[str, float]]:
    home = cfg.model.variant == "home"
    loss_cfg = cfg.train.loss
    accum = cfg.train.optim.grad_accum
    max_norm = cfg.train.optim.max_grad_norm
    params: List[torch.nn.Parameter] = [p for p in model.parameters()
                                        if p.requires_grad]
    buffers: List[torch.Tensor] = list(model.buffers())

    def train_step(batch: Dict[str, torch.Tensor],
                   rngs: Sequence[torch.Generator]) -> Dict[str, float]:
        """batch: stacked micro-batches [accum, ...] on the model's device;
        rngs: one dropout generator per micro-batch."""
        acc = [torch.zeros_like(p) for p in params]
        zero = torch.zeros((), device=params[0].device)
        n_good = torch.zeros((), dtype=torch.int32, device=zero.device)
        main_sum, cl_sum = zero.clone(), zero.clone()
        for i in range(accum):
            micro = {k: v[i] for k, v in batch.items()}
            for p in params:
                p.grad = None
            before = [b.clone() for b in buffers]
            out = model(micro, deterministic=False, rng=rngs[i])
            parts = total_loss(out.logit_good, out.logit_best,
                               micro["label_good"], micro["label_best"],
                               loss_cfg, aux=out.aux, home=home)
            parts.total.backward()
            ok = torch.isfinite(parts.total.detach())
            for b, old in zip(buffers, before):
                b.copy_(torch.where(ok, b, old))
            for a, p in zip(acc, params):
                if p.grad is not None:
                    a.add_(torch.where(ok, p.grad, 0.0))
            n_good += ok.to(torch.int32)
            main_sum += torch.where(ok, parts.main.detach(), 0.0)
            cl_sum += torch.where(ok, parts.contrastive.detach(), 0.0)
        grads = [a.div_(accum) for a in acc]
        grad_norm = global_norm(grads)
        n = int(n_good)
        if n > 0:
            clip_by_global_norm(grads, max_norm, grad_norm)
            for p, g in zip(params, grads):
                p.grad = g
            optimizer.step()
            scheduler.step()
        for p in params:
            p.grad = None
        denom = max(n, 1)
        main, cl = main_sum.item() / denom, cl_sum.item() / denom
        return {"loss": main + cl, "main_loss": main,
                "contrastive_loss": cl, "grad_norm": grad_norm.item(),
                "skipped_micro": accum - n}

    return train_step
