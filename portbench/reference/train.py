"""Plain reference of the training step, and of the ranking forward.

One optimizer step, as the published recipe defines it: `grad_accum`
micro-batches, each one's loss (the mean of two weighted BCEs, with HoME's
three contrastive terms) differentiated with respect to the trainable
parameters and added only when finite; the sum divided by `grad_accum`;
the global gradient norm clipped to `max_grad_norm` (scaled only when the
norm is at least the limit); AdamW with eps outside the square root and
decoupled weight decay, every group at `lr` times its schedule, the LoRA
(and HoME image) groups' schedule 0 for `freeze_steps` steps, then linear
over `unfreeze_steps`, counted from 0 at the first update.  HoME's
BatchNorm running statistics move in each training forward (momentum,
unbiased batch variance) and keep a micro-batch's move only when its loss
is finite.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .hashing import SeedStream
from .model import Cfg, Reference, is_buffer, label, loss


def to_device(micro: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in micro.items():
        t = torch.as_tensor(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long() if k.endswith("tokens") else t
        out[k] = t.to(device)
    for k in ("label_good", "label_best"):
        if k in out:
            out[k] = out[k].float()
    return out


def schedule(count: int, freeze: int, warm: int) -> float:
    return min(max((count - freeze) / max(warm, 1), 0.0), 1.0)


def trainable_names(port: Dict[str, object], names: Sequence[str]) -> List[str]:
    c = Cfg(port)
    layers = int(c["model.image.num_layers"])
    return [n for n in names if not is_buffer(n)
            and label(n, c["model.variant"], layers) != "frozen"]


def train_steps(port: Dict[str, object], params0: Dict[str, torch.Tensor],
                steps: Sequence[Dict[str, np.ndarray]], train_seed: int,
                precision: str = "fp32",
                loss_hook: Optional[Callable] = None) -> Dict[str, object]:
    """Runs len(steps) optimizer steps from params0 (left untouched).

    Returns {"losses": [...], "first_grads": {name: tensor},
    "params": {name: tensor} (the trainable ones after the last step),
    "stats": {name: tensor} (HoME's running statistics after it)}.
    `loss_hook(micro, good, best, aux) -> loss` replaces the loss (a
    planted fault)."""
    c = Cfg(port)
    home = c["model.variant"] == "home"
    names = trainable_names(port, list(params0))
    p = {k: v.detach().clone() for k, v in params0.items()}
    for n in names:
        p[n].requires_grad_(True)
    stats = {k: v.clone() for k, v in p.items() if is_buffer(k)}
    ref = Reference(port, p, precision)
    opt_lr = float(c["train.optim.lr"])
    b1, b2 = float(c["train.optim.b1"]), float(c["train.optim.b2"])
    eps = float(c["train.optim.eps"])
    wd = float(c["train.optim.weight_decay"])
    max_norm = float(c["train.optim.max_grad_norm"])
    if home:
        freeze = int(c["train.optim.home_freeze_steps"])
        warm = int(c["train.optim.home_unfreeze_steps"])
    else:
        freeze = int(c["train.optim.freeze_steps"])
        warm = int(c["train.optim.unfreeze_steps"])
    groups = {n: label(n, c["model.variant"], int(c["model.image.num_layers"]))
              for n in names}
    m = {n: torch.zeros_like(p[n]) for n in names}
    v = {n: torch.zeros_like(p[n]) for n in names}
    losses, first = [], None
    for t, step in enumerate(steps):
        accum = next(iter(step.values())).shape[0]
        acc = {n: torch.zeros_like(p[n]) for n in names}
        total, good_n = 0.0, 0
        for i in range(accum):
            micro = to_device({k: x[i] for k, x in step.items()},
                              p[names[0]].device)
            seeds = SeedStream(train_seed, t, i)
            before = {k: x.clone() for k, x in stats.items()}
            # the forward reads the running statistics from `stats`
            for k, x in stats.items():
                p[k] = x
            good, best, aux = ref.forward(micro, seeds, recompute=True,
                                          stats=stats if home else None)
            value = (loss_hook(micro, good, best, aux) if loss_hook
                     else loss(port, good, best, aux, micro))
            grads = torch.autograd.grad(value, [p[n] for n in names],
                                        allow_unused=True)
            ok = bool(torch.isfinite(value))
            if ok:
                for n, g in zip(names, grads):
                    if g is not None:
                        acc[n] += g
                total += float(value.detach())
                good_n += 1
            else:
                stats.update(before)
        losses.append(total / max(good_n, 1))
        if good_n == 0:
            continue
        for n in names:
            acc[n] /= accum
        norm = math.sqrt(sum(float(g.double().pow(2).sum()) for g in acc.values()))
        if norm >= max_norm:
            for n in names:
                acc[n] *= max_norm / norm
        if first is None:
            first = {n: acc[n].detach().clone() for n in names}
        k = t + 1
        with torch.no_grad():
            for n in names:
                lr = opt_lr * (1.0 if groups[n] == "other"
                               else schedule(t, freeze, warm))
                g = acc[n]
                p[n].mul_(1.0 - lr * wd)
                m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (v[n].sqrt() / math.sqrt(1.0 - b2 ** k)).add_(eps)
                p[n].addcdiv_(m[n], denom, value=-lr / (1.0 - b1 ** k))
    return {"losses": losses, "first_grads": first or {},
            "params": {n: p[n].detach() for n in names},
            "stats": {k: x.detach() for k, x in stats.items()}}


@torch.no_grad()
def rank_probs(port: Dict[str, object], params: Dict[str, torch.Tensor],
               batch: Dict[str, np.ndarray], device, precision: str = "fp32",
               rows: int = 64) -> np.ndarray:
    """[B, 2] probabilities (good, best) of the deterministic forward,
    `rows` samples at a time (each sample's chunks go with it)."""
    ref = Reference(port, params, precision)
    n = batch["has_image"].shape[0]
    out = []
    for s0 in range(0, n, rows):
        s1 = min(n, s0 + rows)
        micro = {}
        for side in ("user", "item"):
            sc = batch[f"{side}_sent_chunk"][s0:s1]
            used = sc[sc >= 0]
            lo = int(used.min()) if used.size else 0
            hi = int(used.max()) + 1 if used.size else 1
            micro[f"{side}_tokens"] = batch[f"{side}_tokens"][lo:hi]
            micro[f"{side}_sent_chunk"] = np.where(sc >= 0, sc - lo, -1)
            micro[f"{side}_sent_tok"] = batch[f"{side}_sent_tok"][s0:s1]
        micro["patches"] = batch["patches"][s0:s1]
        micro["has_image"] = batch["has_image"][s0:s1]
        good, best, _ = ref.forward(to_device(micro, device))
        out.append(torch.stack([torch.sigmoid(good), torch.sigmoid(best)], 1)
                   .double().cpu().numpy())
    return np.concatenate(out, 0)
