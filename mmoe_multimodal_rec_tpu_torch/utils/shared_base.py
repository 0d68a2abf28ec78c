"""Convert flat param mappings between the two-tower text-expert layout and
the shared-base layout (model.shared_text_base,
models/text_expert.DualTextExpert).

Port of mmoe_multimodal_rec_tpu/utils/shared_base.py over FLAT mappings:
'/'-joined keys in the JAX layout (numpy arrays) or '.'-joined keys of the
port's state_dict (tensors), `sep` telling which.

Two-tower (the reference checkpoint layout):
  user_expert/encoder/** , item_expert/encoder/**   (two full BGE copies)
  user_expert/norm/**    , item_expert/norm/**      (baseline only)
Shared-base:
  text_experts/encoder/**            (ONE base; every lora_a/lora_b leaf
                                      gains a leading [2] side axis:
                                      0 = user, 1 = item)
  text_experts/norm_user|norm_item/** (baseline only)

`two_tower_to_shared` requires the two bases to be EQUAL, the invariant of
the reference workflow (both towers load the same BGE and the base is in no
optimizer group); bases that diverge raise rather than being averaged.
Both directions are exact and inverse to each other, and the walk is
path-generic (unrolled or stacked `encoder/layers/layer` layouts alike).
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

USER, ITEM, SHARED = "user_expert", "item_expert", "text_experts"
_LORA = ("lora_a", "lora_b")


def is_shared_layout(flat: Mapping, sep: str = "/") -> bool:
    return any(k.split(sep, 1)[0] == SHARED for k in flat)


def _equal(u, v, atol: float) -> bool:
    u, v = (np.asarray(t.detach().cpu() if hasattr(t, "detach") else t)
            for t in (u, v))
    if u.shape != v.shape:
        return False
    return (np.array_equal(u, v) if atol == 0.0
            else np.allclose(u, v, atol=atol, rtol=0.0))


def _stack(u, v):
    if hasattr(u, "detach"):
        import torch
        return torch.stack([u, v], dim=0)
    return np.stack([np.asarray(u), np.asarray(v)], axis=0)


def two_tower_to_shared(flat: Mapping, *, atol: float = 0.0,
                        sep: str = "/") -> dict:
    """Merge user_expert/item_expert into text_experts.  `atol` bounds the
    allowed base-weight disagreement (0.0: bit for bit)."""
    out = {}
    consumed = set()
    for k, v in flat.items():
        top, _, rest = k.partition(sep)
        if top == ITEM:
            continue  # handled from the user side
        if top != USER:
            out[k] = v
            continue
        item_key = ITEM + sep + rest
        head, _, tail = rest.partition(sep)
        if head == "encoder":
            if item_key not in flat:
                raise ValueError(f"two-tower layout incomplete: missing "
                                 f"{item_key}")
            consumed.add(item_key)
            iv = flat[item_key]
            if k.rsplit(sep, 1)[-1] in _LORA:
                out[SHARED + sep + rest] = _stack(v, iv)
            elif not _equal(v, iv, atol):
                raise ValueError(
                    f"base weights diverge at {k}: the shared-base layout "
                    "requires equal frozen bases (pass atol= to tolerate "
                    "numeric noise)")
            else:
                out[SHARED + sep + rest] = v
        elif head == "norm":
            out[sep.join((SHARED, "norm_user", tail))] = v
            if item_key in flat:
                consumed.add(item_key)
                out[sep.join((SHARED, "norm_item", tail))] = flat[item_key]
        else:
            raise ValueError(f"unexpected two-tower subtree: {k}")
    leftover = [k for k in flat
                if k.split(sep, 1)[0] == ITEM and k not in consumed]
    if leftover:
        raise ValueError(f"item_expert leaves without user counterpart: "
                         f"{leftover[:3]}")
    return out


def shared_to_two_tower(flat: Mapping, sep: str = "/") -> dict:
    """Expand text_experts back into user_expert/item_expert (the base is
    duplicated; LoRA leaves split their leading side axis)."""
    out = {}
    for k, v in flat.items():
        top, _, rest = k.partition(sep)
        if top != SHARED:
            out[k] = v
            continue
        head, _, tail = rest.partition(sep)
        if head == "encoder":
            lora = k.rsplit(sep, 1)[-1] in _LORA
            out[USER + sep + rest] = v[0] if lora else v
            out[ITEM + sep + rest] = v[1] if lora else v
        elif head in ("norm_user", "norm_item"):
            side = USER if head == "norm_user" else ITEM
            out[sep.join((side, "norm", tail))] = v
        else:
            raise ValueError(f"unexpected shared-base subtree: {k}")
    return out
