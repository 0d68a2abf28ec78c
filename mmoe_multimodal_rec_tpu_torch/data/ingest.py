"""HF -> storage ingestion: Amazon-Reviews-2023 meta + review streamers.

Replaces meta2gcs.py / review2gcs.py.  The schema-normalization transforms
(`transform_meta`, `transform_review`) are pure functions, tested offline;
the streaming/upload paths are gated on network + optional deps
(huggingface_hub/datasets for the source, google-cloud-storage for a GCS
sink — local filesystem sink works everywhere).

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/ingest.py.
"""
from __future__ import annotations

import gzip
import json
import os
from .io import fs_makedirs, fs_open
from typing import Callable, Iterable, Iterator, Optional


def transform_meta(ex: dict) -> dict:
    """Normalize meta rows: images dict-of-lists OR list-of-structs ->
    list-of-structs; price -> float|None; details str -> dict
    (meta2gcs.py:25-70 semantics)."""
    raw = ex.get("images", {}) or []
    imgs = []
    if isinstance(raw, dict):
        for var, hi, lg, th in zip(raw.get("variant", []),
                                   raw.get("hi_res", []),
                                   raw.get("large", []),
                                   raw.get("thumb", [])):
            imgs.append({"variant": var, "hi_res": hi, "large": lg,
                         "thumb": th})
    else:
        for it in raw:
            imgs.append({"variant": it.get("variant"),
                         "hi_res": it.get("hi_res"),
                         "large": it.get("large"),
                         "thumb": it.get("thumb")})
    price = None
    rp = ex.get("price")
    if rp not in (None, "", "None"):
        try:
            price = float(rp)
        except (TypeError, ValueError):
            price = None
    details = ex.get("details", {}) or {}
    if isinstance(details, str):
        try:
            details = json.loads(details)
        except json.JSONDecodeError:
            details = {}
    return {
        "parent_asin": ex.get("parent_asin"),
        "asin": ex.get("asin"),
        "main_category": ex.get("main_category"),
        "title": ex.get("title"),
        "average_rating": ex.get("average_rating"),
        "rating_number": ex.get("rating_number"),
        "price": price,
        "store": ex.get("store"),
        "features": ex.get("features", []),
        "description": ex.get("description", []),
        "details": details,
        "images": imgs,
        "bought_together": ex.get("bought_together"),
        "categories": ex.get("categories"),
    }


def transform_review(ex: dict) -> dict:
    """Keep the review fields the pipeline consumes (review2gcs.py:23-34)."""
    return {
        "user_id": ex.get("user_id"),
        "asin": ex.get("asin"),
        "parent_asin": ex.get("parent_asin", ex.get("asin")),
        "rating": ex.get("rating"),
        "title": ex.get("title", ""),
        "text": ex.get("text", ""),
        "sort_timestamp": ex.get("timestamp"),
        "verified_purchase": ex.get("verified_purchase", False),
        "helpful_votes": ex.get("helpful_vote", 0),
    }


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------

def write_jsonl_gzip_shards(rows: Iterable[dict], output_dir: str,
                            prefix: str = "shard",
                            shard_size: int = 100_000,
                            transform: Optional[Callable[[dict], dict]] = None
                            ) -> Iterator[str]:
    """Shard writer mirroring upload_jsonl_gzip_shards (meta2gcs.py:73-103)
    naming: {prefix}-{sid:05d}.jsonl.gz.  output_dir may be local or a
    gs://-style URL (fsspec-routed, data/io.py)."""
    fs_makedirs(output_dir)
    gz = None
    path = None
    for idx, rec in enumerate(rows):
        if idx % shard_size == 0:
            if gz:
                gz.close()
                yield path
            sid = idx // shard_size
            path = os.path.join(output_dir, f"{prefix}-{sid:05d}.jsonl.gz")
            gz = gzip.open(fs_open(path, "wb"), "wt", encoding="utf-8")
        out = transform(rec) if transform else rec
        gz.write(json.dumps(out, ensure_ascii=False) + "\n")
    if gz:
        gz.close()
        yield path


# ---------------------------------------------------------------------------
# Sources (network-gated)
# ---------------------------------------------------------------------------

def stream_meta(split: str = "Sports_and_Outdoors",
                token: Optional[str] = None) -> Iterator[dict]:
    """Stream raw meta JSONL from the HF hub over HTTP, line by line
    (meta2gcs.py:10-23).  Requires network + requests + huggingface_hub."""
    import requests
    from huggingface_hub import hf_hub_url
    token = token or os.environ.get("HF_TOKEN")
    if not token:
        raise RuntimeError("set HF_TOKEN for HF hub access")
    url = hf_hub_url(repo_id="McAuley-Lab/Amazon-Reviews-2023",
                     filename=f"raw/meta_categories/meta_{split}.jsonl",
                     repo_type="dataset")
    resp = requests.get(url, headers={"Authorization": f"Bearer {token}"},
                        stream=True)
    resp.raise_for_status()
    for line in resp.iter_lines(decode_unicode=True):
        if line:
            yield json.loads(line)


def stream_reviews(split: str = "Sports_and_Outdoors",
                   token: Optional[str] = None) -> Iterator[dict]:
    """Stream the raw review split via `datasets` streaming mode
    (review2gcs.py:89-98).  Requires network + datasets."""
    from datasets import load_dataset
    ds = load_dataset("McAuley-Lab/Amazon-Reviews-2023",
                      name=f"raw_review_{split}", split="full",
                      streaming=True, trust_remote_code=True)
    yield from ds.with_format(type="python")


def ingest_meta(output_dir: str, split: str = "Sports_and_Outdoors",
                shard_size: int = 100_000) -> list:
    return list(write_jsonl_gzip_shards(
        stream_meta(split), output_dir, prefix="meta",
        shard_size=shard_size, transform=transform_meta))


def ingest_reviews(output_dir: str, split: str = "Sports_and_Outdoors",
                   shard_size: int = 300_000) -> list:
    return list(write_jsonl_gzip_shards(
        stream_reviews(split), output_dir, prefix="reviews",
        shard_size=shard_size, transform=transform_review))
