"""Carry weights from the JAX package's param tree into the port's modules.

The port's module names follow the JAX tree, so a flat key maps by rule:
`user_expert/encoder/layer_0/attention/query/kernel` [in, out] becomes
`user_expert.encoder.layer_0.attention.query.weight` [out, in]; `scale` and
`embedding` become `weight`; every other leaf keeps its name and layout.
The JAX `batch_stats` collection (HoME's `<wrapper>/norm/{mean,var}`) maps
the same way onto the BatchNorm buffers of the same names.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .lora import merge_lora as _merge_lora


def params_from_jax(flat: Mapping[str, np.ndarray], model_cfg,
                    merge_lora: bool = True) -> Dict[str, torch.Tensor]:
    """Flat '/'-joined JAX params (numpy) -> a state_dict for the port.
    With merge_lora and LoRA factors present, they are folded in first
    (utils/lora.merge_lora at model_cfg.text.lora_alpha)."""
    if merge_lora and any(k.endswith("/lora_a") for k in flat):
        flat = _merge_lora(flat, model_cfg.text.lora_alpha)
    state = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        arr = np.asarray(value, np.float32)
        if leaf == "kernel":
            arr, leaf = arr.T, "weight"
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        state[".".join(path + [leaf])] = torch.tensor(arr)
    return state


def load_jax_params(module: nn.Module, flat: Mapping[str, np.ndarray],
                    model_cfg, merge_lora: bool = True,
                    batch_stats: Optional[Mapping[str, np.ndarray]] = None
                    ) -> nn.Module:
    """Strict load of JAX params, and of the flat '/'-keyed `batch_stats`
    when the model has any, into `module`: raises listing every parameter
    or buffer the module lacks or the JAX trees do not use, and on any
    shape mismatch."""
    state = params_from_jax(flat, model_cfg, merge_lora)
    for key, value in (batch_stats or {}).items():
        state[key.replace("/", ".")] = torch.tensor(
            np.asarray(value, np.float32))
    own = module.state_dict()
    missing = sorted(set(own) - set(state))
    unused = sorted(set(state) - set(own))
    if missing or unused:
        raise KeyError(f"JAX params do not match the module: missing "
                       f"{missing}, unused {unused}")
    module.load_state_dict(state, strict=True)
    return module
