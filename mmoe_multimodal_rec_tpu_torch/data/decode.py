"""Sample decoding: tar member bytes -> training sample.

Mirrors `decode_sample` (ref model.py:127-189) with one TPU-native change:
the image stays in its stored patch-row form [196, 768] uint8 — the reference
reconstructs the 224x224 image on the host per sample (model.py:168-171) only
for ViT to immediately re-patchify it; our ViT consumes patch rows directly
(models/vit.py), and ImageNet normalization happens on device
(models/image_expert.normalize_patches).  `patch_rows_to_image` provides the
reconstruction for parity tests and visual debugging.

All defensive guards are preserved: missing/empty required fields, label
range + NaN/Inf checks via `safe_float`, zero-image fallback on any patch
decode failure (including the reference's 2x-size zero filler for imageless
samples, data4model.py:214-217, which is never read because has_image=0).

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/decode.py.
"""
from __future__ import annotations

import json
import math
from typing import Dict, Optional

import numpy as np

PATCH_ROWS = 196
PATCH_DIM = 768
PATCH_SHAPE = (PATCH_ROWS, PATCH_DIM)


def safe_float(x, default: float = 0.0) -> float:
    """float(x) with NaN/Inf/parse guards (ref model.py:121-125)."""
    try:
        v = float(x)
        return v if math.isfinite(v) else default
    except Exception:
        return default


def decode_sample(sample: Dict[str, bytes]) -> Optional[dict]:
    """Returns {user_text, item_text, patch [196,768] u8, has_image,
    label_good, label_best} or None for malformed samples (dropped upstream,
    ref train.py:54)."""
    try:
        user_bytes = sample.get("user.json", b"")
        item_bytes = sample.get("item.json", b"")
        label_bytes = sample.get("label.json", b"")
        misc_bytes = sample.get("misc.json", b"")
        if not user_bytes or not item_bytes or not label_bytes:
            return None

        user_raw = user_bytes.decode("utf-8").strip()
        item_raw = item_bytes.decode("utf-8").strip()
        label = json.loads(label_bytes)
        misc = json.loads(misc_bytes) if misc_bytes else {}
        if not user_raw or not item_raw:
            return None
        if "label_good" not in label or "label_best" not in label:
            return None

        label_good = safe_float(label["label_good"])
        label_best = safe_float(label["label_best"])
        if not (0 <= label_good <= 1) or not (0 <= label_best <= 1):
            return None

        patch = np.zeros(PATCH_SHAPE, np.uint8)
        has_image = 0
        if misc.get("has_image", 0) and "patch.bin" in sample:
            try:
                shape = misc.get("shape", [196, 3, 16, 16])
                arr = np.frombuffer(sample["patch.bin"], dtype=np.uint8)
                arr = arr.reshape(shape)          # raises on size mismatch
                patch = np.ascontiguousarray(arr.reshape(PATCH_SHAPE))
                has_image = 1
            except Exception:
                patch = np.zeros(PATCH_SHAPE, np.uint8)
                has_image = 0

        out = {
            "user_text": user_raw,
            "item_text": item_raw,
            "patch": patch,
            "has_image": has_image,
            "label_good": label_good,
            "label_best": label_best,
        }
        # optional offline-pretokenization sidecars (data/pretokenize.py);
        # malformed sidecars degrade to the raw-text path, never drop the
        # sample
        if "utok.bin" in sample and "itok.bin" in sample:
            try:
                from .pretokenize import decode_sent_tokens
                u_max, u_vocab, u_sents = decode_sent_tokens(sample["utok.bin"])
                i_max, i_vocab, i_sents = decode_sent_tokens(sample["itok.bin"])
                if u_vocab == i_vocab:
                    out["user_sents"] = u_sents
                    out["item_sents"] = i_sents
                    out["sents_max_len"] = min(u_max, i_max)
                    out["sents_vocab"] = u_vocab
            except ValueError:
                pass
        return out
    except Exception:
        return None


def explain_sample(sample: Dict[str, bytes]) -> Dict[str, object]:
    """Diagnostic twin of `decode_sample` for the `validate` CLI: returns
    {"status": "ok" | "dropped", "reason": str | None, "degraded": [str]}.
    `decode_sample` (and the reference, train.py:54) drops malformed
    samples SILENTLY; production data pipelines need the reasons surfaced.
    Mirrors decode_sample's checks exactly; "degraded" lists conditions
    that keep the sample but lose information (zero-image fallback,
    ignored token sidecars)."""
    degraded = []
    try:
        user_bytes = sample.get("user.json", b"")
        item_bytes = sample.get("item.json", b"")
        label_bytes = sample.get("label.json", b"")
        misc_bytes = sample.get("misc.json", b"")
        if not user_bytes or not item_bytes or not label_bytes:
            missing = [k for k, v in (("user.json", user_bytes),
                                      ("item.json", item_bytes),
                                      ("label.json", label_bytes)) if not v]
            return {"status": "dropped",
                    "reason": f"missing_member:{','.join(missing)}",
                    "degraded": degraded}
        try:
            user_raw = user_bytes.decode("utf-8").strip()
            item_raw = item_bytes.decode("utf-8").strip()
        except UnicodeDecodeError:
            return {"status": "dropped", "reason": "undecodable_text",
                    "degraded": degraded}
        if not user_raw or not item_raw:
            return {"status": "dropped", "reason": "empty_text",
                    "degraded": degraded}
        try:
            label = json.loads(label_bytes)
            misc = json.loads(misc_bytes) if misc_bytes else {}
        except json.JSONDecodeError:
            return {"status": "dropped", "reason": "bad_json",
                    "degraded": degraded}
        if "label_good" not in label or "label_best" not in label:
            return {"status": "dropped", "reason": "missing_label_keys",
                    "degraded": degraded}
        lg, lb = safe_float(label["label_good"]), safe_float(label["label_best"])
        if not (0 <= lg <= 1) or not (0 <= lb <= 1):
            return {"status": "dropped", "reason": "label_out_of_range",
                    "degraded": degraded}
        if misc.get("has_image", 0):
            if "patch.bin" not in sample:
                degraded.append("image_flag_without_patch")
            else:
                try:
                    shape = misc.get("shape", [196, 3, 16, 16])
                    np.frombuffer(sample["patch.bin"],
                                  dtype=np.uint8).reshape(shape)\
                        .reshape(PATCH_SHAPE)
                except Exception:
                    degraded.append("bad_patch_zero_filled")
        if "utok.bin" in sample and "itok.bin" in sample:
            try:
                from .pretokenize import decode_sent_tokens
                decode_sent_tokens(sample["utok.bin"])
                decode_sent_tokens(sample["itok.bin"])
            except ValueError:
                degraded.append("bad_token_sidecar_ignored")
        return {"status": "ok", "reason": None, "degraded": degraded}
    except Exception as e:  # anything unforeseen == decode_sample's None
        return {"status": "dropped", "reason": f"error:{type(e).__name__}",
                "degraded": degraded}


def patch_rows_to_image(rows: np.ndarray, grid: int = 14,
                        patch: int = 16) -> np.ndarray:
    """[grid^2, 3*patch^2] rows -> [3, grid*patch, grid*patch] image
    (inverse of newpatch.py:102-104; equals the reference's reconstruction
    model.py:168-171)."""
    x = rows.reshape(grid, grid, 3, patch, patch).transpose(2, 0, 3, 1, 4)
    return np.ascontiguousarray(x.reshape(3, grid * patch, grid * patch))


def image_to_patch_rows(img: np.ndarray, patch: int = 16) -> np.ndarray:
    """[3, H, W] image -> [H*W/patch^2, 3*patch^2] rows (newpatch.py:102-104)."""
    c, h, w = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(c, gh, patch, gw, patch).transpose(1, 3, 0, 2, 4)
    return np.ascontiguousarray(x.reshape(gh * gw, c * patch * patch))
