"""Optional Apache Beam adapter for the feature pipeline.

The reference runs its feature engineering as a Beam/Dataflow job
(data4moe_beam.py:322-435).  This repo's transforms (data/features.py) are
pure generators, so wrapping them as DoFns is mechanical; use this module
when a Beam runner IS available (apache_beam is optional —
everything here is import-gated, and `run_feature_pipeline_streaming` covers
the single-host case with bounded memory).

DAG parity with the reference run():
  reviews | DownSample | Enrich(meta AsDict side input)
          | GroupBy(user_id) | CausalPosNeg(pid-pool side input)
          | neg branch: AttachMeta(meta side input)
          | SplitByDate -> per-(split, category) JSONL

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/beam_pipeline.py.
"""
from __future__ import annotations

from typing import Iterable

from .features import (attach_meta_to_negatives, causal_pos_neg_for_user,
                       enrich, split_by_date)


def _require_beam(beam_mod=None):
    """Resolve the Beam API module: an explicit override (e.g.
    data.minibeam's eager single-host executor, or a test double) wins,
    otherwise the real apache_beam."""
    if beam_mod is not None:
        return beam_mod
    try:
        import apache_beam as beam
        return beam
    except ImportError as e:
        raise ImportError(
            "apache_beam is not installed; use "
            "features.run_feature_pipeline_streaming for single-host runs, "
            "run_local (data.minibeam eager executor) to execute this exact "
            "DAG in-process, or pip install apache-beam[gcp] for Dataflow "
            "scale-out") from e


def make_dofns(beam_mod=None):
    """Build the DoFn classes lazily (so importing this module never needs
    beam).  Returns a dict of DoFn classes keyed by stage name."""
    beam = _require_beam(beam_mod)

    class DownSampleByStar(beam.DoFn):
        """5-star downsample with a PER-RECORD stable hash keep decision.

        A shared sequential RNG (what the reference's DoFn effectively does,
        data4moe_beam.py:88-99) makes the kept set depend on runner bundling
        — non-reproducible across runs and correlated across bundles.  Here
        keep = crc32(user|asin|timestamp|seed) < rate, so the decision is a
        pure function of the record: identical on every runner, every bundle
        split, and every retry.  Same Bernoulli(rate) marginal semantics.
        """

        def __init__(self, rate_5: float = 0.2, seed: int = 0):
            self.rate_5, self.seed = rate_5, seed

        def process(self, rec):
            import zlib
            if int(rec.get("rating", 0) or 0) == 5:
                key = (f"{rec.get('user_id', '')}|{rec.get('asin', '')}|"
                       f"{rec.get('sort_timestamp', '')}|{self.seed}")
                h = zlib.crc32(key.encode("utf-8")) / 4294967296.0
                if h >= self.rate_5:
                    return
            yield rec

    class Enrich(beam.DoFn):
        def process(self, rev, meta_by_pid):
            yield from enrich(meta_by_pid, [rev])

    class CausalPosNeg(beam.DoFn):
        def __init__(self, neg_k: int = 5):
            self.neg_k = neg_k

        def process(self, kv, all_pids):
            uid, rows = kv
            yield from causal_pos_neg_for_user(uid, list(rows), all_pids,
                                               self.neg_k)

    class AttachMetaNeg(beam.DoFn):
        def process(self, row, meta_by_pid):
            if row.get("_is_neg"):
                yield from attach_meta_to_negatives([row], meta_by_pid)
            else:
                yield row

    class TagSplit(beam.DoFn):
        def __init__(self, train_end: str, valid_end: str):
            self.train_end, self.valid_end = train_end, valid_end

        def process(self, row):
            split = split_by_date(row, self.train_end, self.valid_end)
            cat = (row.get("main_category") or "UNK").replace("/", "_")
            out = {k: v for k, v in row.items() if k != "_is_neg"}
            yield (f"{split}/{cat}", out)

    return {"DownSampleByStar": DownSampleByStar, "Enrich": Enrich,
            "CausalPosNeg": CausalPosNeg, "AttachMetaNeg": AttachMetaNeg,
            "TagSplit": TagSplit}


def build_pipeline(pipeline, meta_pcoll, review_pcoll, output_prefix: str,
                   train_end: str, valid_end: str, *, neg_k: int = 5,
                   rate_5: float = 0.2, all_pids_sample: int = 10_000,
                   seed: int = 0, beam_mod=None):
    """Assemble the full DAG on an existing Pipeline (== data4moe_beam.run).

    meta_pcoll: PCollection of meta dicts; review_pcoll: review dicts.
    Writes {output_prefix}/{split}/{category}-NNNNN.jsonl via beam's sharded
    text sink.  Returns the tagged (dest, row) PCollection for further use.
    """
    beam = _require_beam(beam_mod)
    import json
    dofns = make_dofns(beam)

    meta_kv = (meta_pcoll
               | "MetaKV" >> beam.Map(
                   lambda m: (m.get("parent_asin") or m.get("asin"), m))
               | "DropNoPid" >> beam.Filter(lambda kv: bool(kv[0])))
    meta_dict = beam.pvalue.AsDict(meta_kv)
    pid_pool = beam.pvalue.AsList(
        meta_kv
        | "Pids" >> beam.Keys()
        | "PoolSample" >> beam.combiners.Sample.FixedSizeGlobally(
            all_pids_sample)
        | "PoolFlat" >> beam.FlatMap(lambda xs: sorted(xs)))

    tagged = (
        review_pcoll
        | "HasPid" >> beam.Filter(
            lambda r: bool(r and (r.get("parent_asin") or r.get("asin"))))
        | "DownSample" >> beam.ParDo(dofns["DownSampleByStar"](rate_5, seed))
        | "Enrich" >> beam.ParDo(dofns["Enrich"](), meta_dict)
        | "ByUser" >> beam.WithKeys(lambda row: row["user_id"])
        | "GroupUsers" >> beam.GroupByKey()
        | "CausalPosNeg" >> beam.ParDo(dofns["CausalPosNeg"](neg_k), pid_pool)
        | "AttachMetaNeg" >> beam.ParDo(dofns["AttachMetaNeg"](), meta_dict)
        | "TagSplit" >> beam.ParDo(dofns["TagSplit"](train_end, valid_end)))

    _ = (tagged
         | "Serialize" >> beam.MapTuple(
             lambda dest, row: (dest, json.dumps(row)))
         | "GroupDest" >> beam.GroupByKey()
         | "WriteDest" >> beam.MapTuple(
             lambda dest, lines, prefix=output_prefix:
             _write_dest(prefix, dest, lines)))
    return tagged


def run_local(meta_rows: Iterable[dict], review_rows: Iterable[dict],
              output_prefix: str, train_end: str, valid_end: str, *,
              neg_k: int = 5, rate_5: float = 0.2,
              all_pids_sample: int = 10_000, seed: int = 0):
    """Execute the EXACT Beam DAG in-process via the data.minibeam eager
    executor — no apache_beam required.  Same outputs as a DirectRunner run
    of build_pipeline (tested row-identical to features.run_feature_pipeline
    modulo the documented stable-hash downsample,
    tests/test_torch_data_pipeline.py).
    Returns the tagged (dest, row) pairs."""
    from . import minibeam

    with minibeam.Pipeline() as p:
        meta = p | minibeam.Create(meta_rows)
        reviews = p | minibeam.Create(review_rows)
        tagged = build_pipeline(
            p, meta, reviews, output_prefix, train_end, valid_end,
            neg_k=neg_k, rate_5=rate_5, all_pids_sample=all_pids_sample,
            seed=seed, beam_mod=minibeam)
        p.run().wait_until_finish()
    return tagged.items


def _write_dest(prefix: str, dest: str, lines: Iterable[str]) -> str:
    """One JSONL file per (split, category) destination, fsspec-routed."""
    import os
    from .io import fs_makedirs, fs_open
    path = os.path.join(prefix, f"{dest}.jsonl")
    fs_makedirs(os.path.dirname(path))
    with fs_open(path, "w") as f:
        for line in lines:
            f.write(line + "\n")
    return path
