"""The train, eval and BatchNorm-recalibration steps.

Port of mmoe_multimodal_rec_tpu/train/step.py.  `make_train_step`: one
optimizer step over `grad_accum` micro-batches.  PyTorch runs eagerly, so
the JAX step's `lax.scan` is a Python loop over the micro-batches; the
semantics are the same:
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
On a mesh (parallel/mesh.py) the batch is the rank's share and each
micro-batch's loss the rank's share of the global one: the losses that
decide a skip and that are logged are summed over `data` first (one small
all-reduce a micro-batch), so every rank skips alike, and the accumulated
gradients are summed over `data` once a step, in a few flat buckets,
before the division by `grad_accum`; `grad_norm` sums the model shards'
squares over `model`.
`make_eval_step`: the deterministic forward to probabilities, with LoRA
unmerged, as JAX's.  `make_bn_recalibration_step`: the same forward with
HoME's BatchNorms on batch statistics, moving only their running
statistics.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence

import torch
import torch.distributed as dist

from ..config import Config
from ..parallel.mesh import Mesh, all_reduce_
from .losses import total_loss
from .optimizer import clip_by_global_norm, global_norm


def make_train_step(cfg: Config, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, scheduler,
                    mesh: Optional[Mesh] = None,
                    shardings: Optional[Mapping[str, Optional[int]]] = None
                    ) -> Callable[[Dict[str, torch.Tensor],
                                   Sequence[torch.Generator]],
                                  Dict[str, float]]:
    """mesh: the rank's mesh, with `shardings` (parallel/mesh.
    param_shardings) saying which parameters are model shards; the step's
    rngs are then parallel/mesh.DataShard's."""
    home = cfg.model.variant == "home"
    loss_cfg = cfg.train.loss
    accum = cfg.train.optim.grad_accum
    max_norm = cfg.train.optim.max_grad_norm
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    params: List[torch.nn.Parameter] = [p for _, p in named]
    sharded = [(shardings or {}).get(n) is not None for n, _ in named]
    data = mesh.data if mesh is not None and mesh.data.size > 1 else None
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
                               loss_cfg, aux=out.aux, home=home, data=data)
            parts.total.backward()
            total, main, cl = (parts.total.detach(), parts.main.detach(),
                               parts.contrastive.detach())
            if data is not None:
                losses = torch.stack([total, main, cl])
                dist.all_reduce(losses, group=data.group)
                total, main, cl = losses.unbind()
            ok = torch.isfinite(total)
            for b, old in zip(buffers, before):
                b.copy_(torch.where(ok, b, old))
            for a, p in zip(acc, params):
                if p.grad is not None:
                    a.add_(torch.where(ok, p.grad, 0.0))
            n_good += ok.to(torch.int32)
            main_sum += torch.where(ok, main, 0.0)
            cl_sum += torch.where(ok, cl, 0.0)
        if mesh is not None:
            all_reduce_(acc, mesh.data)
        grads = [a.div_(accum) for a in acc]
        grad_norm = global_norm(grads, sharded,
                                mesh.model if mesh is not None else None)
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


def make_eval_step(cfg: Config, model: torch.nn.Module
                   ) -> Callable[[Dict[str, torch.Tensor]],
                                 Dict[str, torch.Tensor]]:
    """Deterministic forward -> sigmoid probabilities (ref
    inference_and_auc.py:130-156); the labels and the eval loader's
    `valid` mask pass through.  The batch lies on the model's device."""

    @torch.inference_mode()
    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        out = model(batch, deterministic=True)
        return {"prob_good": torch.sigmoid(out.logit_good),
                "prob_best": torch.sigmoid(out.logit_best),
                "label_good": batch["label_good"],
                "label_best": batch["label_best"],
                "valid": batch["valid"]}

    return eval_step


def make_bn_recalibration_step(cfg: Config, model: torch.nn.Module
                               ) -> Callable[[Dict[str, torch.Tensor]],
                                             Dict[str, torch.Tensor]]:
    """Full forward with ONLY the BatchNorm running statistics updating
    (weights untouched, dropout off) == recalibrate_bn (ref
    infer_auc_HoME:64-125).  The statistics move in place; the step returns
    the model's buffers by name."""

    @torch.no_grad()
    def recal_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        model(batch, deterministic=True, bn_use_running_average=False)
        return dict(model.named_buffers())

    return recal_step
