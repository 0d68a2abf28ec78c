"""Fold trained LoRA deltas into the base kernels for serving.

Port of mmoe_multimodal_rec_tpu/utils/lora.py over a FLAT param mapping:
the JAX `params` tree flattened with '/'-joined keys, numpy arrays in the
JAX layout (kernels [in, out], lora_a [in, r], lora_b [r, out]).  At
inference the adapter is a constant, so W' = W + (alpha/r) A B is exact, and
with the LoRA branch gone the text attention layers take the packed-qkv
kernel (models/layers.Attention needs lora_rank == 0).  A shared-base
mapping (model.shared_text_base: one base, side-stacked LoRA factors) is
expanded to two towers first (utils/shared_base.shared_to_two_tower,
exact): one kernel cannot hold two merged deltas, and the result then has
the layout `merged_model_config` describes.
"""
from __future__ import annotations

import copy
from typing import Mapping

import numpy as np

from .shared_base import is_shared_layout, shared_to_two_tower


def merge_lora(flat: Mapping[str, np.ndarray], alpha: float
               ) -> dict:
    """New flat mapping with every `<p>/{base/{kernel,bias}, lora_a, lora_b}`
    collapsed to `<p>/{kernel, bias}`, kernel = base + (alpha/r) A B.  The
    merge runs in fp32 and casts back to the base kernel's dtype."""
    if is_shared_layout(flat):
        flat = shared_to_two_tower(flat)
    out = {}
    n_merged = 0
    for key, v in flat.items():
        parent, _, leaf = key.rpartition("/")
        if leaf == "lora_a":
            a = np.asarray(v, np.float32)
            b = np.asarray(flat[parent + "/lora_b"], np.float32)
            kernel = np.asarray(flat[parent + "/base/kernel"])
            merged = kernel.astype(np.float32) + (alpha / a.shape[-1]) * (a @ b)
            out[parent + "/kernel"] = merged.astype(kernel.dtype)
            out[parent + "/bias"] = flat[parent + "/base/bias"]
            n_merged += 1
        elif leaf == "lora_b":
            continue
        elif parent.endswith("/base") and parent[:-5] + "/lora_a" in flat:
            continue  # folded above
        else:
            out[key] = v
    if n_merged == 0:
        raise ValueError("no LoRA factors found in the param mapping "
                         "(already merged, or lora_rank == 0?)")
    return out


def merge_lora_state(state: Mapping[str, "torch.Tensor"], alpha: float
                     ) -> dict:
    """New state_dict with every LoRADense `<p>.{base.weight, base.bias,
    lora_a, lora_b}` collapsed to the Dense `<p>.{weight, bias}`, weight =
    base + (alpha/r) (A B)^T, merged in fp32 and cast back to the base
    weight's dtype.  A shared-base state_dict is expanded to two towers
    first."""
    if is_shared_layout(state, sep="."):
        state = shared_to_two_tower(state, sep=".")
    out = {}
    n_merged = 0
    for key, v in state.items():
        parent, _, leaf = key.rpartition(".")
        if leaf == "lora_a":
            a, b = v.float(), state[parent + ".lora_b"].float()
            base = state[parent + ".base.weight"]
            merged = base.float() + (alpha / a.shape[-1]) * (a @ b).t()
            out[parent + ".weight"] = merged.to(base.dtype)
            out[parent + ".bias"] = state[parent + ".base.bias"]
            n_merged += 1
        elif leaf == "lora_b" or (parent.endswith(".base") and
                                  parent[:-5] + ".lora_a" in state):
            continue  # folded above
        else:
            out[key] = v
    if n_merged == 0:
        raise ValueError("no LoRA factors found in the state_dict (already "
                         "merged, or lora_rank == 0?)")
    return out


def merged_model_config(model_cfg):
    """Copy of the model config whose layout matches a merged mapping (text
    lora_rank = 0, which also unlocks the packed-qkv kernel path)."""
    cfg = copy.deepcopy(model_cfg)
    cfg.text.lora_rank = 0
    cfg.shared_text_base = False
    return cfg
