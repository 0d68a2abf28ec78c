"""Seeded weights for both sides of the comparison.

Every parameter the reference lists (reference/model.param_specs) is drawn
from one `torch.Generator` on the device in a single call and scaled, or
set to its constant; the program and the reference are handed the same
tensors.  LoRA's B factor is drawn (not zero) so that the adapters stand
for trained ones and every factor has a gradient from the first step.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.model import param_specs


def make_weights(port: Dict[str, object], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    specs = param_specs(port)
    drawn = sum(math.prod(shape) for _, shape, (kind, _) in specs
                if kind == "normal")
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    flat = torch.randn(drawn, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, (kind, value) in specs:
        if kind == "normal":
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape).mul_(value)
            off += n
        else:
            out[name] = torch.full(shape, float(value), device=device)
    return out


def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy `weights` into the program's model, whose state_dict must hold
    exactly these names and shapes."""
    state = model.state_dict()
    missing = sorted(set(weights) - set(state))
    extra = sorted(set(state) - set(weights))
    if missing or extra:
        raise ValueError(f"the program's parameters differ from the "
                         f"reference's: missing {missing[:5]}, extra {extra[:5]}")
    with torch.no_grad():
        for name, t in state.items():
            if tuple(t.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: program {tuple(t.shape)}, "
                                 f"reference {tuple(weights[name].shape)}")
            t.copy_(weights[name])
