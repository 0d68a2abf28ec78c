"""Text normalization + feature-to-text rendering + sample merge/shard write.

Replaces data4model.py: `normalize_text` (:54-92), `build_user_text`
(:95-136), `build_item_text` (:138-181), `merge_patch` (:183-233) and the
WebDataset writer (:239-259).  The rendered strings are byte-compatible with
the reference templates — they are model *inputs*, so parity matters for
reproducing the published AUCs.

The `emoji` package is optional: when present we demojize
exactly like the reference; otherwise emoji are stripped by the
control/symbol filters below (documented deviation — review text containing
emoji renders without the ":name:" expansion).

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/textbuild.py.
"""
from __future__ import annotations

import base64
import html
import json
import re
import unicodedata
import uuid
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

try:
    import emoji as _emoji
except ImportError:          # gated optional dep
    _emoji = None

_TERMINALS = (".", "!", "?", "。", ";", "；", "！", "？")
_ZERO_PATCH_B64 = base64.b64encode(
    b"\x00" * (196 * 3 * 16 * 16 * 2)).decode()   # 2x filler, never read
                                                   # (data4model.py:214-217)


def _clean_one(s: str) -> str:
    if _emoji is not None:
        s = _emoji.demojize(s, delimiters=(" ", " "))
    s = html.unescape(s)
    s = unicodedata.normalize("NFKC", s)
    s = re.sub(r"[‘’‚‛❛❜]", "'", s)
    s = re.sub(r"[“”„‟❝❞]", '"', s)
    s = re.sub(r"[–—―]", "-", s)
    s = re.sub(r"[…]", "...", s)
    s = re.sub(r"[\r\n\t]+", " ", s)
    s = "".join(ch for ch in s if unicodedata.category(ch)[0] != "C")
    s = s.replace(r"\"", '"').replace(r"\'", "'")
    s = s.replace("\\", " ")
    return re.sub(r"\s+", " ", s).strip()


def normalize_text(*args: Union[str, Sequence[str]]
                   ) -> Union[str, List[str]]:
    """One string -> cleaned string; several (or a list) -> list of them."""
    if len(args) == 1 and isinstance(args[0], (list, tuple)):
        texts = list(args[0])
    else:
        texts = list(args)
    cleaned = [_clean_one(t) for t in texts]
    return cleaned[0] if len(cleaned) == 1 else cleaned


def smart_join(pieces: Iterable[str]) -> str:
    """Join feature strings, appending ';' to pieces lacking terminal
    punctuation (data4model.py:39-48)."""
    out = []
    for piece in pieces:
        piece = piece.strip()
        if re.search(r"[。.;；.!?？！]$", piece):
            out.append(piece)
        else:
            out.append(piece + ";")
    return " ".join(out)


def _terminated(s: str) -> str:
    return s if s.endswith(_TERMINALS) else s + "."


def build_user_text(rec: dict) -> str:
    """Render causal user features to the model's user prompt
    (data4model.py:95-136 template, byte-compatible)."""
    uf = rec.get("user_feat", {})

    cat_hist = {k: v for k, v in uf.get("cat_hist", {}).items()
                if v and v > 0}
    cat_hist_str = ("; ".join(f"{cat}: {cnt * 100:.0f}%"
                              for cat, cnt in cat_hist.items())
                    if cat_hist else "No browsing history")

    review_cnt = uf.get("review_cnt", 0)
    review_cnt_str = f"{review_cnt}" if review_cnt > 0 else "No reviews"

    price_mean = uf.get("price_mean")
    price_mean_str = f"{price_mean:.2f}" if price_mean is not None else "N/A"
    price_std = uf.get("price_std", 0.0)
    price_std_str = (f"{price_std:.2f}" if price_std and price_std > 0
                     else "No price variation")

    parts = []
    for h in uf.get("history", []):
        piece = h.get("text") or h.get("title") or ""
        if piece:
            parts.append(normalize_text(piece))
    if parts:
        history_str = _terminated(smart_join(
            f"Review{i + 1}: {p}" for i, p in enumerate(parts)))
    else:
        history_str = "No review history."

    return (f"Category history: {cat_hist_str}. "
            f"Total reviews: {review_cnt_str}. "
            f"Avg price: {price_mean_str}. Price std: {price_std_str}. "
            f"Review history: {history_str}")


def build_item_text(rec: dict) -> str:
    """Render item metadata to the item prompt, byte-identical to
    data4model.py:138-181 INCLUDING its quirks (the JAX package's copy is
    golden-tested against the executed reference; this one is held to it
    in tests/test_torch_data_pipeline.py):

    - only ``title`` is read (data4model.py:142); feature rows carry
      ``product_title``, so items render "Item title: No title" — exactly
      what the published checkpoints were trained on;
    - ``normalize_text`` returns a bare str for ANY single-element input
      (data4model.py:92) and ``smart_join`` then iterates its characters
      (data4model.py:40-48), so single-element feature/description lists
      render e.g. "G; r; e; a; t; ; b; i; k; e;";
    - empty strings inside multi-element lists are kept and render ";".
    """
    category = rec.get("main_category") or "Unknown category"
    title = rec.get("title") or "No title"
    price = rec.get("price")
    price_str = f"{price:.2f}" if price is not None else "N/A"

    clean_feats = normalize_text(rec.get("features", []))
    features_text = (f"Item features: {_terminated(smart_join(clean_feats))}"
                     if clean_feats else "Item features: No features.")

    raw_descs = rec.get("description", []) or []
    if isinstance(raw_descs, str):
        raw_descs = [raw_descs]
    clean_descs = normalize_text(raw_descs)
    desc_text = (f"Item description: {_terminated(smart_join(clean_descs))}"
                 if clean_descs else "Item description: No description.")

    return (f"Item category: {category}. "
            f"Item title: {title}. "
            f"Item price: {price_str}. "
            f"{features_text} "
            f"{desc_text}")


def merge_rows_with_patch(rows: Iterable[dict],
                          patch_obj: Optional[dict]) -> Iterator[dict]:
    """Join train rows for one parent_asin with its (optional) patch record
    (data4model.py:183-233): renders both texts, attaches the patch payload
    or the zero filler with has_image=0."""
    for row in rows:
        user_id = row.get("user_id", "unknown_user")
        parent_asin = row.get("parent_asin", "unknown_item")
        key = f"{user_id}-{parent_asin}-{uuid.uuid4().hex[:6]}"
        if patch_obj:
            patch_b64 = patch_obj.get("patch_b64", "")
            shape = patch_obj.get("shape", [196, 3, 16, 16])
            has_image = 1
        else:
            patch_b64 = _ZERO_PATCH_B64
            shape = [196, 3, 16, 16]
            has_image = 0
        yield {
            "key": key,
            "user_text": build_user_text(row),
            "item_text": build_item_text(row),
            "patch_b64": patch_b64,
            "shape": shape,
            "has_image": has_image,
            "label_good": int(row.get("label_good", 0)),
            "label_best": int(row.get("label_best", 0)),
        }


def record_to_wds_sample(rec: dict) -> Dict[str, bytes]:
    """Merged record -> the 5-member WebDataset sample layout
    (data4model.py:254-258)."""
    return {
        "__key__": rec["key"],
        "user.json": rec["user_text"].encode("utf-8"),
        "item.json": rec["item_text"].encode("utf-8"),
        "patch.bin": base64.b64decode(rec["patch_b64"]),
        "misc.json": json.dumps({"has_image": rec["has_image"],
                                 "shape": rec["shape"]}).encode("utf-8"),
        "label.json": json.dumps({"label_good": rec["label_good"],
                                  "label_best": rec["label_best"]}
                                 ).encode("utf-8"),
    }


def write_dataset(rows_by_asin: Dict[str, List[dict]],
                  patches_by_asin: Dict[str, dict],
                  output_dir: str, samples_per_shard: int = 1024,
                  compress: bool = True) -> List[str]:
    """In-memory equivalent of the data4model.py pipeline tail: cogroup by
    parent_asin, merge, write tar shards."""
    from .tar_io import ShardWriter
    with ShardWriter(output_dir, samples_per_shard, compress) as w:
        for asin, rows in rows_by_asin.items():
            for rec in merge_rows_with_patch(rows,
                                             patches_by_asin.get(asin)):
                w.write(record_to_wds_sample(rec))
    return w.paths
