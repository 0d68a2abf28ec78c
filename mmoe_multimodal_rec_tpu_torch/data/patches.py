"""Image fetch + 16x16 patchification.

Replaces the Beam image pipeline newpatch.py: concurrent async download
(httpx, 8-way, 10s timeout, :56-73), PIL resize 256 -> center-crop 224
(:88-90), uint8 CHW, patchify to (196, 768) rows (:102-104), base64 JSONL
records (:105-110).  Download failures degrade to "no record" and the join
stage later emits has_image=0 samples (data4model.py:213-218) — the data-level
failure-degradation path (SURVEY §5).

`decode_and_patch` is a pure function (offline-testable); `fetch_patches`
needs network and is gated on httpx availability.  Without PIL,
`decode_and_patch` returns None for every input, as the JAX package's does.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/patches.py.
"""
from __future__ import annotations

import base64
import io
import logging
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

PATCH = 16
MAX_BATCH_SIZE = 64
MAX_CONCURRENT = 8
IMG_SIZE = 224
RESIZE = 256


def decode_and_patch(content: bytes) -> Optional[Dict]:
    """Image bytes -> {"patch_b64", "shape"} or None on any failure."""
    try:
        from PIL import Image
        img = Image.open(io.BytesIO(content)).convert("RGB")
    except Exception as e:
        logging.warning("invalid image: %s", e)
        return None
    img = img.resize((RESIZE, RESIZE), resample=2)  # PIL BILINEAR
    left = (RESIZE - IMG_SIZE) // 2
    img = img.crop((left, left, left + IMG_SIZE, left + IMG_SIZE))
    arr = np.asarray(img, dtype=np.uint8)
    if arr.shape != (IMG_SIZE, IMG_SIZE, 3):
        logging.warning("unexpected image shape %s", arr.shape)
        return None
    arr = arr.transpose(2, 0, 1)  # CHW
    c, h, w = arr.shape
    rows = (arr.reshape(c, h // PATCH, PATCH, w // PATCH, PATCH)
            .transpose(1, 3, 0, 2, 4)
            .reshape(-1, c * PATCH * PATCH))
    return {"patch_b64": base64.b64encode(rows.tobytes()).decode(),
            "shape": [rows.shape[0], c, PATCH, PATCH]}


def patch_record(parent_asin: str, content: bytes) -> Optional[Dict]:
    rec = decode_and_patch(content)
    if rec is None:
        return None
    return {"parent_asin": parent_asin, **rec}


async def _download_all(urls: List[str], timeout: float = 10.0):
    import asyncio
    import httpx
    limits = httpx.Limits(max_connections=MAX_CONCURRENT)
    async with httpx.AsyncClient(timeout=timeout, limits=limits) as client:
        async def fetch(idx, url):
            try:
                r = await client.get(url)
                r.raise_for_status()
                return idx, r.content
            except Exception as e:
                logging.warning("download failed %s: %s", url, e)
                return idx, None
        return await asyncio.gather(*(fetch(i, u) for i, u in
                                      enumerate(urls)))


def fetch_patches(records: Iterable[Dict], timeout: float = 10.0
                  ) -> Iterator[Dict]:
    """records: {"parent_asin", "url"} -> patch records, batched downloads.

    Requires network + httpx; failures are dropped (downstream emits
    has_image=0 for items with no patch record).
    """
    import asyncio
    batch: List[Dict] = []

    def flush(batch):
        urls = [r["url"] for r in batch]
        pids = [r["parent_asin"] for r in batch]
        loop = asyncio.new_event_loop()
        try:
            results = loop.run_until_complete(_download_all(urls, timeout))
        finally:
            loop.close()
        for idx, content in results:
            if content:
                rec = patch_record(pids[idx], content)
                if rec is not None:
                    yield rec

    for r in records:
        if not r.get("url"):
            continue
        batch.append(r)
        if len(batch) >= MAX_BATCH_SIZE:
            yield from flush(batch)
            batch = []
    if batch:
        yield from flush(batch)


def write_patch_jsonl(records: Iterable[Dict], path: str) -> int:
    """gzip JSONL like newpatch's WriteToText(compression=gzip)."""
    import gzip
    import json
    n = 0
    from .io import fs_open
    with gzip.open(fs_open(path, "wb"), "wt") as f:
        for rec in records:
            f.write(json.dumps(rec, ensure_ascii=False) + "\n")
            n += 1
    return n
