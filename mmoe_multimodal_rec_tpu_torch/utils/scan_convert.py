"""Translate flat encoder param mappings between the unrolled layout
(`encoder/layer_{i}/...`, one subtree per layer: the reference checkpoint
shape and the port's own) and the scan layout (`encoder/layers/layer/...`
with a leading [num_layers] axis, what the JAX package's
`model.text.scan_layers=True` trains).

Port of mmoe_multimodal_rec_tpu/utils/scan_convert.py over FLAT '/'-keyed
numpy mappings.  Both directions are exact re-arrangements.  Only scopes
named `encoder` (the text encoders) are touched; the ViT (`backbone`)
stays unrolled.  The port runs its layers unrolled whatever scan_layers
says, so utils/convert.params_from_jax unstacks a scan tree on the way in.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np

_LAYER_RE = re.compile(r"^layer_(\d+)$")


def stack_layers(flat: Mapping[str, np.ndarray], scope: str = "encoder"
                 ) -> dict:
    """unrolled -> scan: stack every `<...>/scope/layer_{i}/<rest>` group
    into `<...>/scope/layers/layer/<rest>` along a new leading axis."""
    groups, out = {}, {}
    for k, v in flat.items():
        parts = k.split("/")
        hit = next(((i, int(m.group(1))) for i, p in enumerate(parts)
                    if i > 0 and parts[i - 1] == scope
                    and (m := _LAYER_RE.match(p))), None)
        if hit is None:
            out[k] = v
            continue
        i, idx = hit
        new_key = "/".join(parts[:i] + ["layers", "layer"] + parts[i + 1:])
        groups.setdefault(new_key, {})[idx] = v
    for new_key, by_idx in groups.items():
        n = len(by_idx)
        if sorted(by_idx) != list(range(n)):
            raise ValueError(f"non-contiguous layer indices for {new_key}: "
                             f"{sorted(by_idx)}")
        out[new_key] = np.stack([np.asarray(by_idx[i]) for i in range(n)])
    return out


def unstack_layers(flat: Mapping[str, np.ndarray], scope: str = "encoder"
                   ) -> dict:
    """scan -> unrolled: split `<...>/scope/layers/layer/<rest>` along the
    leading axis back into `<...>/scope/layer_{i}/<rest>`."""
    out = {}
    for k, v in flat.items():
        parts = k.split("/")
        hit = next((i for i in range(1, len(parts) - 1)
                    if parts[i] == "layers" and parts[i - 1] == scope
                    and parts[i + 1] == "layer"), None)
        if hit is None:
            out[k] = v
            continue
        v = np.asarray(v)
        for idx in range(v.shape[0]):
            out["/".join(parts[:hit] + [f"layer_{idx}"]
                         + parts[hit + 2:])] = v[idx]
    return out


def is_scan_layout(flat: Mapping, scope: str = "encoder") -> bool:
    return any(f"/{scope}/layers/layer/" in "/" + k for k in flat)
