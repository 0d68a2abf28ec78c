"""Offline feature engineering: meta x review join, causal per-user features,
time-aligned negative sampling, time split.

Replaces the Beam pipeline data4moe_beam.py with pure-Python streaming
transforms (apache_beam is optional, data/beam_pipeline.py; the functions
are shaped so a Beam DoFn wrapper is a three-liner if a runner is
available).  Semantics are kept 1:1:

- 5-star downsampling keeps `rate_5` of 5* reviews (DownSampleByStar :88-99)
- join meta x review per parent_asin -> enriched positive rows with
  label_good = rating>=4, label_best = rating==5 (Enrich :102-146)
- per-user causal features from PAST rows only: category histogram, review
  count, Welford price mean/std, last-3 review history; k time-aligned
  negatives per positive sampled from a global pid pool, never-seen-so-far,
  reusing the SAME causal user_feat (CausalPosNegByUser :149-266)
- negatives re-attach item meta (AttachMetaNeg :269-291)
- date split train <= train_end < valid <= valid_end < test (SplitByDate
  :294-319)

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/features.py:
the RNG draws and the iteration order are the same, so the split rows and
negatives match the JAX package's row for row
(tests/test_torch_data_pipeline.py).
"""
from __future__ import annotations

import datetime
import json
import random
import zlib
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Row transforms
# ---------------------------------------------------------------------------

def extract_main_image(imgs) -> str:
    """hi_res > large > thumb of the first image entry."""
    if imgs and isinstance(imgs, list):
        im = imgs[0]
        return im.get("hi_res") or im.get("large") or im.get("thumb") or ""
    return ""


def downsample_by_star(rows: Iterable[dict], rate_5: float = 0.2,
                       rng: Optional[random.Random] = None) -> Iterator[dict]:
    rng = rng or random.Random(0)
    for rec in rows:
        if int(rec.get("rating", 0) or 0) == 5:
            if rng.random() < rate_5:
                yield rec
        else:
            yield rec


def enrich(meta_by_pid: Dict[str, dict],
           reviews: Iterable[dict]) -> Iterator[dict]:
    """Join reviews with item meta -> positive rows."""
    for rev in reviews:
        pid = rev.get("parent_asin") or rev.get("asin")
        meta = meta_by_pid.get(pid)
        if not meta:
            continue
        rating = rev.get("rating")
        if rating is None:
            continue
        ts = rev.get("sort_timestamp")
        date_str = (datetime.datetime.fromtimestamp(
            ts / 1000, datetime.timezone.utc).date().isoformat()
            if ts else None)
        yield {
            "user_id": rev["user_id"],
            "parent_asin": pid,
            "asin_child": rev.get("asin"),
            "main_category": meta.get("main_category"),
            "product_title": meta.get("title"),
            "price": meta.get("price"),
            "main_image_url": extract_main_image(meta.get("images", [])),
            "features": meta.get("features", []),
            "description": meta.get("description", []),
            "review_title": rev.get("title", ""),
            "review_text": rev.get("text", ""),
            "sort_timestamp": ts,
            "event_date": date_str,
            "rating": rating,
            "label_good": 1 if rating >= 4 else 0,
            "label_best": 1 if rating == 5 else 0,
            "helpful_votes": rev.get("helpful_votes", 0),
            "_is_neg": 0,
        }


# ---------------------------------------------------------------------------
# Causal per-user features (the hot transform)
# ---------------------------------------------------------------------------

class Welford:
    """Streaming mean/std (CausalPosNegByUser._welford_* :164-177)."""

    def __init__(self):
        self.n, self.mean, self.m2 = 0, 0.0, 0.0

    def update(self, x: float) -> None:
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    @property
    def std(self) -> float:
        if self.n <= 1:
            return 0.0
        return (self.m2 / (self.n - 1)) ** 0.5


def _try_float(x) -> Optional[float]:
    if x in (None, ""):
        return None
    try:
        return float(x)
    except Exception:
        return None


def _sample_unseen(all_pids: Sequence[str], seen: set, k: int,
                   rnd: random.Random) -> List[str]:
    if not all_pids:
        return []
    out: List[str] = []
    tries, max_tries = 0, max(200, k * 50)
    while len(out) < k and tries < max_tries:
        tries += 1
        pid = all_pids[rnd.randrange(0, len(all_pids))]
        if pid in seen or pid in out:
            continue
        out.append(pid)
    return out


def causal_pos_neg_for_user(uid: str, rows: Iterable[dict],
                            all_pids: Sequence[str],
                            neg_k: int = 5) -> Iterator[dict]:
    """Emit positives with only-past user_feat + k time-aligned negatives
    per positive (CausalPosNegByUser.process :194-266).

    Negatives carry the SAME causal user_feat as the positive they align to
    and only minimal fields.  The per-user RNG is seeded from crc32(uid) —
    the reference seeds from python hash(uid) (data4moe_beam.py:210), which
    is salted per process and therefore NOT reproducible across runs; crc32
    keeps the same per-user-deterministic intent and makes it actually hold.
    """
    rows = sorted(rows, key=lambda r: r.get("sort_timestamp")
                  if isinstance(r.get("sort_timestamp"), (int, float)) else -1)
    seen: set = set()
    cat_cnt: Dict[str, int] = {}
    review_cnt = 0
    price = Welford()
    hist: deque = deque(maxlen=3)
    rnd = random.Random(zlib.crc32(uid.encode("utf-8")) & 0xFFFFFFFF)

    for r in rows:
        if review_cnt <= 0:
            user_feat = {"cat_hist": {}, "review_cnt": 0, "price_mean": None,
                         "price_std": 0.0, "history": []}
        else:
            user_feat = {
                "cat_hist": {k: round(v / review_cnt, 4)
                             for k, v in cat_cnt.items()},
                "review_cnt": review_cnt,
                "price_mean": round(price.mean, 4) if price.n > 0 else None,
                "price_std": round(price.std, 4) if price.n > 1 else 0.0,
                "history": list(hist),
            }

        pos = dict(r)
        pos["user_feat"] = user_feat
        pos["_is_neg"] = 0
        yield pos

        pid = r.get("parent_asin")
        if pid:
            seen.add(pid)
        cat = r.get("main_category") or "UNK"
        cat_cnt[cat] = cat_cnt.get(cat, 0) + 1
        review_cnt += 1
        px = _try_float(r.get("price"))
        if px is not None:
            price.update(px)
        hist.append({"title": r.get("review_title", ""),
                     "text": r.get("review_text", "")})

        for n_pid in _sample_unseen(all_pids, seen, neg_k, rnd):
            yield {
                "user_id": uid,
                "parent_asin": n_pid,
                "label_good": 0,
                "label_best": 0,
                "rating": 0,
                "helpful_votes": 0,
                "sort_timestamp": r.get("sort_timestamp"),
                "event_date": r.get("event_date"),
                "user_feat": user_feat,
                "_is_neg": 1,
            }


def attach_meta_to_negatives(neg_rows: Iterable[dict],
                             meta_by_pid: Dict[str, dict]) -> Iterator[dict]:
    """Attach item meta to negatives, preserving event_date/user_feat
    (AttachMetaNeg :269-291)."""
    for n in neg_rows:
        meta = meta_by_pid.get(n.get("parent_asin"))
        if not meta:
            continue
        yield {
            **n,
            "asin_child": None,
            "main_category": meta.get("main_category"),
            "product_title": meta.get("title"),
            "price": meta.get("price"),
            "main_image_url": extract_main_image(meta.get("images", [])),
            "features": meta.get("features", []),
            "description": meta.get("description", []),
        }


def split_by_date(row: dict, train_end: str, valid_end: str) -> str:
    """'train' | 'valid' | 'test' by event_date (SplitByDate :294-319)."""
    t_end = datetime.date.fromisoformat(train_end)
    v_end = datetime.date.fromisoformat(valid_end)
    date_str = row.get("event_date")
    if date_str:
        d = datetime.date.fromisoformat(date_str)
        if d <= t_end:
            return "train"
        if d <= v_end:
            return "valid"
    return "test"


# ---------------------------------------------------------------------------
# End-to-end in-memory pipeline (== data4moe_beam.run DAG :322-435)
# ---------------------------------------------------------------------------

def run_feature_pipeline(meta_rows: Iterable[dict],
                         review_rows: Iterable[dict],
                         train_end: str, valid_end: str,
                         neg_k: int = 5, rate_5: float = 0.2,
                         all_pids_sample: int = 10_000,
                         seed: int = 0
                         ) -> Tuple[Dict[Tuple[str, str], List[dict]],
                                    List[dict]]:
    """Returns (rows by (category, split), image-url records)."""
    rng = random.Random(seed)
    meta_by_pid = {}
    image_urls = []
    for m in meta_rows:
        pid = m.get("parent_asin") or m.get("asin")
        if not pid:
            continue
        meta_by_pid[pid] = m
        image_urls.append({"parent_asin": pid,
                           "url": extract_main_image(m.get("images", [])),
                           "main_category": m.get("main_category", "UNK")})

    reviews = [r for r in review_rows
               if r and (r.get("parent_asin") or r.get("asin"))]
    reviews = list(downsample_by_star(reviews, rate_5, rng))
    positives = list(enrich(meta_by_pid, reviews))

    pid_pool = list(meta_by_pid.keys())
    if len(pid_pool) > all_pids_sample:
        pid_pool = rng.sample(pid_pool, all_pids_sample)

    by_user: Dict[str, List[dict]] = {}
    for row in positives:
        by_user.setdefault(row["user_id"], []).append(row)

    pos_rows: List[dict] = []
    neg_rows: List[dict] = []
    for uid, rows in by_user.items():
        for out in causal_pos_neg_for_user(uid, rows, pid_pool, neg_k):
            (neg_rows if out["_is_neg"] else pos_rows).append(out)

    neg_full = list(attach_meta_to_negatives(neg_rows, meta_by_pid))

    split_rows: Dict[Tuple[str, str], List[dict]] = {}
    for row in pos_rows + neg_full:
        split = split_by_date(row, train_end, valid_end)
        cat = row.get("main_category", "UNK") or "UNK"
        row = {k: v for k, v in row.items() if k != "_is_neg"}
        split_rows.setdefault((cat, split), []).append(row)
    return split_rows, image_urls


def write_split_jsonl(split_rows: Dict[Tuple[str, str], List[dict]],
                      output_dir: str) -> List[str]:
    """Write per-(split/category) JSONL files like WriteToFiles with
    destination=split/category (data4moe_beam.py:424-435)."""
    import os
    paths = []
    for (cat, split), rows in split_rows.items():
        d = os.path.join(output_dir, split)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{cat}.jsonl".replace("/", "_"))
        with open(path, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
        paths.append(path)
    return paths


# ---------------------------------------------------------------------------
# Streaming pipeline: bounded memory over arbitrarily large review corpora
# ---------------------------------------------------------------------------

class SplitWriter:
    """Streaming per-(split, category) JSONL sink (== WriteToFiles with
    dynamic destinations, data4moe_beam.py:424-435).  Keeps one open handle
    per destination (few categories x 3 splits); paths may be gs:// URLs."""

    def __init__(self, output_dir: str):
        import os
        from .io import fs_makedirs, fs_open
        self._os, self._fs_open, self._fs_makedirs = os, fs_open, fs_makedirs
        self.output_dir = output_dir
        self._handles: Dict[Tuple[str, str], object] = {}
        self.paths: List[str] = []

    def write(self, row: dict, split: str) -> None:
        cat = (row.get("main_category") or "UNK").replace("/", "_")
        h = self._handles.get((cat, split))
        if h is None:
            d = self._os.path.join(self.output_dir, split)
            self._fs_makedirs(d)
            path = self._os.path.join(d, f"{cat}.jsonl")
            h = self._fs_open(path, "w")
            self._handles[(cat, split)] = h
            self.paths.append(path)
        payload = json.dumps({k: v for k, v in row.items() if k != "_is_neg"})
        data = payload + "\n"
        h.write(data.encode("utf-8") if "b" in getattr(h, "mode", "w")
                else data)

    def close(self) -> None:
        for h in self._handles.values():
            h.close()
        self._handles.clear()


def run_feature_pipeline_streaming(meta_rows: Iterable[dict],
                                   review_rows: Iterable[dict],
                                   train_end: str, valid_end: str,
                                   output_dir: str, *,
                                   neg_k: int = 5, rate_5: float = 0.2,
                                   all_pids_sample: int = 10_000,
                                   seed: int = 0,
                                   num_partitions: int = 64,
                                   tmp_dir: Optional[str] = None
                                   ) -> Tuple[List[str], List[dict]]:
    """The same DAG as run_feature_pipeline with BOUNDED memory — the
    single-host replacement for the reference's Dataflow scale-out
    (data4moe_beam.py:322-435).

    The only full-corpus shuffle the DAG needs is group-by-user; Beam gets it
    from the Dataflow shuffle service, here it is an external hash shuffle:
    enriched rows spill to `num_partitions` temp JSONL files keyed by
    crc32(user_id), then each partition is grouped and processed
    independently.  Peak RSS = the meta side-input dict (which Beam also
    materializes per worker, as the AsDict side input at
    data4moe_beam.py:355-363) + ONE partition of reviews
    (~corpus/num_partitions rows).

    Returns (output jsonl paths, image-url records).  Row-for-row identical
    to run_feature_pipeline on the same input
    (tests/test_torch_data_pipeline.py).
    """
    import os
    import tempfile

    rng = random.Random(seed)
    meta_by_pid: Dict[str, dict] = {}
    image_urls: List[dict] = []
    for m in meta_rows:
        pid = m.get("parent_asin") or m.get("asin")
        if not pid:
            continue
        meta_by_pid[pid] = m
        image_urls.append({"parent_asin": pid,
                           "url": extract_main_image(m.get("images", [])),
                           "main_category": m.get("main_category", "UNK")})

    own_tmp = tmp_dir is None
    tmp_dir = tmp_dir or tempfile.mkdtemp(prefix="feature_shuffle_")
    os.makedirs(tmp_dir, exist_ok=True)
    parts = [open(os.path.join(tmp_dir, f"part-{i:04d}.jsonl"), "w")
             for i in range(num_partitions)]
    try:
        # pass 1: stream downsample -> enrich -> hash-partition spill
        reviews = (r for r in review_rows
                   if r and (r.get("parent_asin") or r.get("asin")))
        for row in enrich(meta_by_pid, downsample_by_star(reviews, rate_5,
                                                          rng)):
            i = zlib.crc32(row["user_id"].encode("utf-8")) % num_partitions
            parts[i].write(json.dumps(row) + "\n")
        for f in parts:
            f.close()

        # pid pool sampled AFTER the downsample pass so the shared-rng draw
        # order (and thus every sampled id) matches run_feature_pipeline
        pid_pool = list(meta_by_pid.keys())
        if len(pid_pool) > all_pids_sample:
            pid_pool = rng.sample(pid_pool, all_pids_sample)

        # pass 2: per partition, group by user -> causal features ->
        # negatives -> meta attach -> date split -> streaming sink
        writer = SplitWriter(output_dir)
        try:
            for i in range(num_partitions):
                path = os.path.join(tmp_dir, f"part-{i:04d}.jsonl")
                by_user: Dict[str, List[dict]] = {}
                with open(path) as f:
                    for line in f:
                        row = json.loads(line)
                        by_user.setdefault(row["user_id"], []).append(row)
                for uid, rows in by_user.items():
                    for out in causal_pos_neg_for_user(uid, rows, pid_pool,
                                                       neg_k):
                        if out["_is_neg"]:
                            for full in attach_meta_to_negatives([out],
                                                                 meta_by_pid):
                                writer.write(full, split_by_date(
                                    full, train_end, valid_end))
                        else:
                            writer.write(out, split_by_date(out, train_end,
                                                            valid_end))
                os.unlink(path)
        finally:
            writer.close()
        return writer.paths, image_urls
    finally:
        for f in parts:
            if not f.closed:
                f.close()
        if own_tmp:
            import shutil
            shutil.rmtree(tmp_dir, ignore_errors=True)
