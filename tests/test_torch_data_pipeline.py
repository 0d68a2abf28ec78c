"""The port's offline data path (mmoe_multimodal_rec_tpu_torch/data/
{ingest,features,minibeam,beam_pipeline,textbuild,patches,pretokenize}.py
and the CLI commands over them) against the JAX package's, on the same
seeded in-memory records.  Every comparison is exact: rows, files and
shard members byte for byte, except a sample's key, whose last six
characters are `uuid.uuid4().hex[:6]` (textbuild.py) and are compared up to
that suffix.

It also holds the repair of the port's silent drop of pretokenized shards:
the port's `decode_sample` imported `.pretokenize`, which the port lacked,
and its blanket `except` turned the ImportError into a dropped sample.  A
shard set that the JAX package pretokenized now decodes, packs through
`pack_encoded` and validates in the port."""
import base64
import datetime
import gzip
import io
import json
import os
import re

import numpy as np
import pytest

from mmoe_multimodal_rec_tpu import cli as jcli
from mmoe_multimodal_rec_tpu.config import tiny_config as j_tiny_config
from mmoe_multimodal_rec_tpu.data import beam_pipeline as jbeam
from mmoe_multimodal_rec_tpu.data import decode as jdecode
from mmoe_multimodal_rec_tpu.data import features as jfeatures
from mmoe_multimodal_rec_tpu.data import ingest as jingest
from mmoe_multimodal_rec_tpu.data import patches as jpatches
from mmoe_multimodal_rec_tpu.data import pretokenize as jpretok
from mmoe_multimodal_rec_tpu.data import textbuild as jtextbuild
from mmoe_multimodal_rec_tpu.data.packer import TextPacker as JPacker
from mmoe_multimodal_rec_tpu.data.synthetic import (
    write_synthetic_shards as j_write_synthetic_shards)
from mmoe_multimodal_rec_tpu.data.wordpiece import (
    HashTokenizer as JHashTokenizer, WordPieceTokenizer as JWordPiece)
from mmoe_multimodal_rec_tpu_torch import cli
from mmoe_multimodal_rec_tpu_torch.config import tiny_config
from mmoe_multimodal_rec_tpu_torch.data import beam_pipeline, decode
from mmoe_multimodal_rec_tpu_torch.data import features, ingest, patches
from mmoe_multimodal_rec_tpu_torch.data import pretokenize, textbuild
from mmoe_multimodal_rec_tpu_torch.data.loader import make_eval_loader
from mmoe_multimodal_rec_tpu_torch.data.packer import TextPacker
from mmoe_multimodal_rec_tpu_torch.data.tar_io import iter_shard
from mmoe_multimodal_rec_tpu_torch.data.wordpiece import (HashTokenizer,
                                                          WordPieceTokenizer)

# review sentences with what the normalizer rewrites: curly quotes, dashes,
# an ellipsis, HTML entities, control characters, an emoji, accents
SENTENCES = (
    "The tent kept us dry through two nights of heavy rain.",
    "Setup took “maybe ten minutes” — even in the dark…",
    "Zippers snag a little &amp; the stakes bent on rocky ground.",
    "Great value for the price!",
    "Would I buy it again?\tYes, without a doubt.",
    "Straps broke after a week 👎 so I returned it.",
    "Naïve me thought the café-style mug was steel; it's aluminium.",
    "Fits true to size and the soles grip well on wet trails.",
    "Light, compact and durable\r\nenough for long hikes.",
    "Not waterproof at all, despite the label.",
)
CATEGORIES = ("Sports & Outdoors", "Camping/Hiking", "Cycling")
TRAIN_END, VALID_END = "2023-01-20", "2023-02-05"


def _ts(day: int) -> int:
    start = datetime.datetime(2023, 1, 1, tzinfo=datetime.timezone.utc)
    return int((start + datetime.timedelta(days=day)).timestamp() * 1000)


def _text(rng, lo: int, hi: int) -> str:
    return " ".join(SENTENCES[i] for i in
                    rng.integers(0, len(SENTENCES), rng.integers(lo, hi)))


def raw_records(seed: int = 0, n_items: int = 24, n_users: int = 10):
    """Meta and review records as HF's Amazon Reviews 2023 dump has them
    (transform_meta / transform_review's input), with the schema's
    variations: images as dict-of-lists or list-of-structs, string and
    missing prices, details as a JSON string, single-element and empty
    feature lists, reviews of unknown items and without a rating.  Item ids
    are zero-padded in insertion order, so a sorted pid pool (the Beam
    adapter's) has the in-memory pipeline's order."""
    rng = np.random.default_rng(seed)
    metas = []
    for i in range(n_items):
        url = f"http://img.example/{i}.jpg"
        images = ({"variant": ["MAIN"], "hi_res": [url], "large": [None],
                   "thumb": [None]} if i % 2 else
                  [{"variant": "MAIN", "hi_res": None, "large": url,
                    "thumb": None}])
        metas.append({
            "parent_asin": f"p{i:03d}", "asin": f"a{i:03d}",
            "main_category": CATEGORIES[i % len(CATEGORIES)],
            "title": f"Product {i}", "average_rating": 4.1,
            "rating_number": int(rng.integers(1, 500)),
            "price": ("None", "", f"{rng.uniform(5, 200):.2f}",
                      float(i) + 0.99)[i % 4],
            "store": "Outfitters", "images": images,
            "features": ([_text(rng, 1, 3)] if i % 3 == 0 else
                         [_text(rng, 1, 3), "", _text(rng, 1, 2)]),
            "description": (_text(rng, 2, 6) if i % 5 == 0 else
                            [_text(rng, 2, 6)]),
            "details": json.dumps({"Weight": f"{i} ounces"}),
            "categories": ["Sports", "Outdoor"]})
    reviews = []
    for u in range(n_users):
        for j in range(int(rng.integers(3, 7))):
            pid = f"p{int(rng.integers(0, n_items + 2)):03d}"  # some unknown
            reviews.append({
                "user_id": f"U{u:04d}", "asin": pid.replace("p", "a"),
                "parent_asin": pid,
                "rating": None if (u + j) % 17 == 0 else
                float(rng.integers(1, 6)),
                "title": _text(rng, 1, 2), "text": _text(rng, 2, 7),
                "timestamp": _ts(int(rng.integers(0, 60))),
                "verified_purchase": bool(j % 2),
                "helpful_vote": int(rng.integers(0, 9))})
    return metas, reviews


def _transformed(seed: int = 0):
    metas, reviews = raw_records(seed)
    return ([ingest.transform_meta(m) for m in metas],
            [ingest.transform_review(r) for r in reviews])


def _vocab(path) -> str:
    """A WordPiece vocab over the records' words, with `##` pieces for
    the rest."""
    words = sorted({w for s in SENTENCES for w in
                    s.lower().replace(".", " ").replace(",", " ").split()})
    vocab = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words[::2] +
             list("abcdefghijklmnopqrstuvwxyz0123456789") +
             [f"##{c}" for c in "abcdefghijklmnopqrstuvwxyz0123456789"] +
             ["##s", "##ed", "##ing", "##er", "##ly", ".", ",", "!", "?",
              "'", '"', "-", ";", ":", "&", "%", "(", ")"])
    path.write_text("\n".join(dict.fromkeys(vocab)) + "\n")
    return str(path)


def _shard_name(path) -> str:
    """A shard's file name without the uuid ShardWriter puts in it."""
    return re.sub(r"-[0-9a-f]{8}(?=\.tar)", "", os.path.basename(path))


def _members(path):
    """A shard's samples as {member: bytes}, the key cut to its fixed
    part."""
    out = []
    for s in iter_shard(path):
        s = dict(s)
        s["__key__"] = s["__key__"][:-6]
        out.append(s)
    return out


def _tree(root):
    """Every file under `root`, by relative path: its bytes, a shard's
    samples as _members (keyed without the shard name's uuid)."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            if f.endswith(".tar.gz"):
                out[os.path.join(os.path.dirname(rel),
                                 _shard_name(f))] = _members(path)
            else:
                out[rel] = open(path, "rb").read()
    return out


@pytest.mark.parametrize("name", ["transform_meta", "transform_review"])
def test_ingest_transforms_match_jax(name):
    metas, reviews = raw_records()
    recs = metas if name == "transform_meta" else reviews
    got = [getattr(ingest, name)(r) for r in recs]
    assert got == [getattr(jingest, name)(r) for r in recs]
    assert len(got) > 20


def test_jsonl_gzip_shards_match_jax(tmp_path):
    metas, _ = raw_records()
    paths = [list(mod.write_jsonl_gzip_shards(
        metas, str(tmp_path / name), prefix="meta", shard_size=10,
        transform=mod.transform_meta))
        for mod, name in ((ingest, "port"), (jingest, "jax"))]
    assert [os.path.basename(p) for p in paths[0]] == \
        ["meta-00000.jsonl.gz", "meta-00001.jsonl.gz", "meta-00002.jsonl.gz"]
    for a, b in zip(*paths):
        assert gzip.open(a).read() == gzip.open(b).read()


@pytest.mark.parametrize("name", ["normalize_text", "smart_join",
                                  "build_user_text", "build_item_text"])
def test_text_rendering_matches_jax(name):
    metas, reviews = _transformed()
    if name == "normalize_text":
        cases = [(s,) for s in SENTENCES] + [(list(SENTENCES[:3]),),
                                             SENTENCES[3:6], ([],)]
    elif name == "smart_join":
        cases = [(SENTENCES,), (["no stop", "a stop.", " spaced "],),
                 ("chars",)]
    else:
        split_rows, _ = features.run_feature_pipeline(
            metas, reviews, TRAIN_END, VALID_END, neg_k=2)
        rows = [r for rows in split_rows.values() for r in rows]
        cases = [(r,) for r in rows] + [(m,) for m in metas] + [({},)]
    got = [getattr(textbuild, name)(*c) for c in cases]
    assert got == [getattr(jtextbuild, name)(*c) for c in cases]


@pytest.mark.parametrize("path", ["in_memory", "streaming", "minibeam"])
def test_feature_pipeline_matches_jax(tmp_path, path):
    """The split rows, negatives and image URLs, row for row; the streaming
    twin writes the JAX one's files byte for byte and the in-memory rows;
    the Beam DAG over minibeam emits the JAX adapter's tagged rows and, at
    rate_5 = 1, the in-memory pipeline's (tests/test_minibeam.py's
    preconditions)."""
    metas, reviews = _transformed()
    kw = dict(train_end=TRAIN_END, valid_end=VALID_END, neg_k=3, seed=5)
    split_rows, urls = features.run_feature_pipeline(metas, reviews, **kw)
    if path == "in_memory":
        want_rows, want_urls = jfeatures.run_feature_pipeline(metas, reviews,
                                                              **kw)
        assert split_rows == want_rows and urls == want_urls
        assert {s for _, s in split_rows} == {"train", "valid", "test"}
        negatives = [r for rows in split_rows.values() for r in rows
                     if r["rating"] == 0]
        assert negatives and all("user_feat" in r for r in negatives)
        paths = [features.write_split_jsonl(split_rows, str(tmp_path / "p")),
                 jfeatures.write_split_jsonl(want_rows, str(tmp_path / "j"))]
        assert [os.path.relpath(p, tmp_path / "p") for p in paths[0]] == \
            [os.path.relpath(p, tmp_path / "j") for p in paths[1]]
        assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
    elif path == "streaming":
        out = {}
        for mod, name in ((features, "p"), (jfeatures, "j")):
            paths, got_urls = mod.run_feature_pipeline_streaming(
                metas, reviews, output_dir=str(tmp_path / name),
                num_partitions=4, tmp_dir=str(tmp_path / f"{name}_tmp"),
                **kw)
            assert got_urls == urls
            out[name] = _tree(tmp_path / name)
        assert out["p"] == out["j"]
        got = {rel: sorted(json.dumps(json.loads(line), sort_keys=True)
                           for line in out["p"][rel].decode().splitlines())
               for rel in out["p"]}
        want = {os.path.join(split, f"{cat.replace('/', '_')}.jsonl"):
                sorted(json.dumps(r, sort_keys=True) for r in rows)
                for (cat, split), rows in split_rows.items()}
        assert got == want
    else:
        tagged = beam_pipeline.run_local(metas, reviews, str(tmp_path / "p"),
                                         rate_5=0.5, **kw)
        assert tagged == jbeam.run_local(metas, reviews, str(tmp_path / "j"),
                                         rate_5=0.5, **kw)
        assert _tree(tmp_path / "p") == _tree(tmp_path / "j")
        every = features.run_feature_pipeline(metas, reviews, rate_5=1.0,
                                              **kw)[0]
        got = {}
        for dest, row in beam_pipeline.run_local(metas, reviews,
                                                 str(tmp_path / "q"),
                                                 rate_5=1.0, **kw):
            got.setdefault(dest, []).append(json.dumps(row, sort_keys=True))
        want = {f"{split}/{cat.replace('/', '_')}":
                sorted(json.dumps(r, sort_keys=True) for r in rows)
                for (cat, split), rows in every.items()}
        assert {k: sorted(v) for k, v in got.items()} == want


def _patch_records(rng, pids):
    return {pid: {"parent_asin": pid,
                  "patch_b64": base64.b64encode(rng.integers(
                      0, 256, 196 * 768, dtype=np.uint8).tobytes()).decode(),
                  "shape": [196, 3, 16, 16]} for pid in pids}


def test_write_dataset_matches_jax(tmp_path):
    """The merged samples and their shards: every member byte for byte,
    the key up to its uuid suffix; half the items carry a patch."""
    metas, reviews = _transformed()
    split_rows, _ = features.run_feature_pipeline(metas, reviews, TRAIN_END,
                                                  VALID_END, neg_k=2)
    rows_by_asin = {}
    for rows in split_rows.values():
        for r in rows:
            rows_by_asin.setdefault(r["parent_asin"], []).append(r)
    pats = _patch_records(np.random.default_rng(1),
                          [m["parent_asin"] for m in metas[::2]])
    rows = max(rows_by_asin.values(), key=len)
    got = [textbuild.record_to_wds_sample(r)
           for r in textbuild.merge_rows_with_patch(rows, None)]
    want = [jtextbuild.record_to_wds_sample(r)
            for r in jtextbuild.merge_rows_with_patch(rows, None)]
    for a, b in zip(got, want):
        assert a.pop("__key__")[:-6] == b.pop("__key__")[:-6]
    assert got == want
    paths = [mod.write_dataset(rows_by_asin, pats, str(tmp_path / name), 16)
             for mod, name in ((textbuild, "p"), (jtextbuild, "j"))]
    assert [_shard_name(p) for p in paths[0]] == \
        [_shard_name(p) for p in paths[1]]
    port, jax_ = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert port == jax_
    samples = [s for shard in port.values() for s in shard]
    assert len(samples) == sum(len(r) for r in rows_by_asin.values())
    has_image = [json.loads(s["misc.json"])["has_image"] for s in samples]
    assert 0 < sum(has_image) < len(samples)


def test_decode_and_patch_matches_jax():
    """A PNG that PIL writes here, resized and cut to 196 patch rows; bytes
    that are no image give None in both."""
    PIL = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(2)
    img = PIL.fromarray(rng.integers(0, 256, (300, 260, 3), dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    got = patches.decode_and_patch(buf.getvalue())
    assert got == jpatches.decode_and_patch(buf.getvalue())
    assert got["shape"] == [196, 3, 16, 16]
    assert len(base64.b64decode(got["patch_b64"])) == 196 * 768
    assert patches.patch_record("p1", buf.getvalue()) == \
        jpatches.patch_record("p1", buf.getvalue())
    assert patches.decode_and_patch(b"not an image") is None
    assert jpatches.decode_and_patch(b"not an image") is None


def _packers(vocab_path, max_tok: int):
    """The port's and the JAX package's TextPacker at the tiny config with
    `max_tok`, on the same WordPiece vocab."""
    out = []
    for cfg, piece, packer in ((tiny_config(), WordPieceTokenizer, TextPacker),
                               (j_tiny_config(), JWordPiece, JPacker)):
        cfg.model.packer.max_tok = max_tok
        out.append(packer(piece.from_vocab_file(vocab_path),
                          cfg.model.packer))
    return out


def test_pretokenize_matches_jax(tmp_path):
    """The sidecar bytes, their decoding and errors, and
    pretokenize_shards over the same shards: every member byte for
    byte."""
    sents = [[1, 2, 3], [7], [], [5, 6]]
    raw = pretokenize.encode_sent_tokens(sents, 21, 30522)
    assert raw == jpretok.encode_sent_tokens(sents, 21, 30522)
    mx, vocab, out = pretokenize.decode_sent_tokens(raw)
    assert (mx, vocab, [list(s) for s in out]) == (21, 30522, sents)
    for bad in (b"\x00" * 8, raw[:-4], raw + b"\x01\x00\x00\x00"):
        for mod in (pretokenize, jpretok):
            with pytest.raises(ValueError):
                mod.decode_sent_tokens(bad)
    port, jax_ = _packers(_vocab(tmp_path / "vocab.txt"), max_tok=48)
    for text in SENTENCES + (" ".join(SENTENCES), ""):
        assert pretokenize.tokenize_text(text, port) == \
            jpretok.tokenize_text(text, jax_)
    shards = j_write_synthetic_shards(str(tmp_path / "raw"), 24, 12, seed=4)
    pattern = str(tmp_path / "raw" / "*.tar.gz")
    for mod, packer, name in ((pretokenize, port, "p"),
                              (jpretok, jax_, "j")):
        paths = mod.pretokenize_shards(pattern, str(tmp_path / name), packer)
        assert [os.path.basename(p) for p in paths] == \
            [os.path.basename(p) for p in shards]
    got, want = _tree(tmp_path / "p"), _tree(tmp_path / "j")
    assert got == want
    assert all("utok.bin" in s and "itok.bin" in s
               for shard in got.values() for s in shard)


def test_port_decodes_jax_pretokenized_shards(tmp_path):
    """The repair.  On shards that the JAX package wrote and pretokenized,
    the port's decode_sample returns what JAX's returns (the same
    user_sents/item_sents, sents_max_len, sents_vocab), explain_sample
    reports ok, the port's BatchLoader packs every batch through
    pack_encoded to the raw-text path's batch, and the port's validate
    exits 0 with every sample pretokenized."""
    raw = j_write_synthetic_shards(str(tmp_path / "raw"), 20, 8, seed=6)
    jcfg = j_tiny_config()
    jpacker = JPacker(JHashTokenizer(jcfg.model.text.vocab_size - 1),
                      jcfg.model.packer)
    pre = jpretok.pretokenize_shards(str(tmp_path / "raw" / "*.tar.gz"),
                                     str(tmp_path / "pre"), jpacker)
    n = 0
    for path in pre:
        for sample in iter_shard(path):
            got, want = (decode.decode_sample(sample),
                         jdecode.decode_sample(sample))
            assert got is not None and want is not None
            assert decode.explain_sample(sample) == \
                jdecode.explain_sample(sample) == \
                {"status": "ok", "reason": None, "degraded": []}
            assert got.keys() == want.keys()
            for side in ("user_sents", "item_sents"):
                assert len(got[side]) == len(want[side]) > 0
                for a, b in zip(got[side], want[side]):
                    np.testing.assert_array_equal(a, b)
            assert got["sents_max_len"] == want["sents_max_len"] == \
                jcfg.model.packer.max_tok - 3
            assert got["sents_vocab"] == want["sents_vocab"] == \
                jcfg.model.text.vocab_size - 1
            for k in ("user_text", "item_text", "has_image", "label_good",
                      "label_best"):
                assert got[k] == want[k]
            np.testing.assert_array_equal(got["patch"], want["patch"])
            n += 1
    assert n == 20

    cfg = tiny_config()
    packer = TextPacker(HashTokenizer(cfg.model.text.vocab_size - 1),
                        cfg.model.packer)
    calls = {"pack": 0, "pack_encoded": 0}

    class Counted(TextPacker):
        def pack(self, *a, **kw):
            calls["pack"] += 1
            return super().pack(*a, **kw)

        def pack_encoded(self, *a, **kw):
            calls["pack_encoded"] += 1
            return super().pack_encoded(*a, **kw)

    counted = Counted(packer.tok, cfg.model.packer)
    batches = []
    for paths, pk in ((pre, counted), (raw, packer)):
        loader = make_eval_loader(paths, 4, pk, num_threads=1)
        try:
            batches.append(list(loader))
        finally:
            loader.close()
    assert len(batches[0]) == len(batches[1]) == 5
    assert calls == {"pack": 0, "pack_encoded": 2 * 5}
    for a, b in zip(*batches):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    rc = cli.main(["validate", f"--input={tmp_path / 'pre' / '*.tar.gz'}"])
    assert rc == 0


def _write_raw_jsonl(tmp_path):
    metas, reviews = raw_records(seed=3, n_items=30, n_users=12)
    raw = tmp_path / "raw"
    raw.mkdir()
    with gzip.open(raw / "meta-00000.jsonl.gz", "wt") as f:
        for m in metas:
            f.write(json.dumps(jingest.transform_meta(m)) + "\n")
    with open(raw / "reviews-00000.jsonl", "w") as f:
        for r in reviews:
            f.write(json.dumps(jingest.transform_review(r)) + "\n")
        f.write("{not json\n")  # skipped, as the JAX CLI skips it
    pats = _patch_records(np.random.default_rng(3),
                          [m["parent_asin"] for m in metas[::2]])
    with gzip.open(raw / "patches.jsonl.gz", "wt") as f:
        for rec in pats.values():
            f.write(json.dumps(rec) + "\n")
    return raw


def test_cli_chain_matches_jax(tmp_path, capsys):
    """features -> build-dataset (train, valid) -> pretokenize -> validate
    through both CLIs on the same raw JSONL: the same printed results, the
    same feature files byte for byte, the same shards (keys up to the uuid
    suffix) and the same validate report and exit code."""
    raw = _write_raw_jsonl(tmp_path)
    vocab = _vocab(tmp_path / "vocab.txt")
    printed = {}
    for main, name in ((cli.main, "p"), (jcli.main, "j")):
        out = tmp_path / name
        lines = []
        for argv in (
                ["features", f"--meta={raw}/meta-*.jsonl.gz",
                 f"--reviews={raw}/reviews-*.jsonl", f"--output={out}/rows",
                 f"--train-end={TRAIN_END}", f"--valid-end={VALID_END}",
                 "--neg-k=2", "--rate-5=0.5"],
                *[["build-dataset", f"--rows={out}/rows/{split}/*.jsonl",
                   f"--patches={raw}/patches.jsonl.gz",
                   f"--output={out}/shards/{split}",
                   "--samples-per-shard=16"]
                  for split in ("train", "valid")],
                ["pretokenize", f"--input={out}/shards/train/*.tar.gz",
                 f"--output={out}/pre", f"--data.vocab_path={vocab}",
                 "--model.packer.max_tok=48"]):
            assert main(argv) == 0, argv
            lines.append(capsys.readouterr().out.strip().splitlines()[-1])
        rc = main(["validate", f"--input={out}/pre/*.tar.gz"])
        lines.append((rc, capsys.readouterr().out.strip().splitlines()[-1]))
        printed[name] = lines
    assert printed["p"] == printed["j"]
    rc, report = printed["p"][-1]
    report = json.loads(report)
    assert rc == 0 and report["dropped"] == 0 and report["samples"] > 16
    assert report["pretokenized_rate"] == 1.0
    assert 0 < report["has_image_rate"] < 1
    assert _tree(tmp_path / "p") == _tree(tmp_path / "j")


def test_ckpt_info_reads_the_ports_checkpoint(tmp_path, capsys):
    """`ckpt-info` over the port's own checkpoint layout
    (train/checkpoint.py) of a tiny trainer: the JAX command's keys, the
    steps and resume position, and the tensor counts and sizes of the
    trainable parameters, the BatchNorm statistics and the optimizer
    state, equal to the trainer's own."""
    from mmoe_multimodal_rec_tpu_torch.train.checkpoint import (
        CheckpointManager)
    from mmoe_multimodal_rec_tpu_torch.train.loop import Trainer, dummy_batch
    cfg = tiny_config(variant="home")
    trainer = Trainer(cfg, device="cpu")
    mngr = CheckpointManager(str(tmp_path / "ckpt"))
    for _ in range(2):
        trainer.run_step(dummy_batch(cfg, accum=cfg.train.optim.grad_accum))
        mngr.save(trainer.host_step, trainer,
                  extra={"epoch": 0, "opt_step_in_epoch": trainer.host_step,
                         "host_step": trainer.host_step})
    assert cli.main(["ckpt-info", f"--checkpoint={tmp_path / 'ckpt'}"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(info) == {"directory", "steps", "latest_step",
                         "frozen_fingerprint", "frozen_once", "resume",
                         "param_counts", "payload_mb"}
    assert info["directory"] == str(tmp_path / "ckpt")
    assert info["steps"] == [1, 2] and info["latest_step"] == 2
    assert info["resume"] == {"epoch": 0, "opt_step_in_epoch": 2,
                              "host_step": 2}
    with open(tmp_path / "ckpt" / "frozen_once.fingerprint.json") as f:
        assert info["frozen_fingerprint"] == json.load(f)["sha256"][:16]
    assert info["frozen_once"] is True
    opt = [t for s in trainer.optimizer.state.values() for t in s.values()]
    want = {"trainable": [p for p in trainer.trainable.values()],
            "batch_stats": [b for _, b in trainer.model.named_buffers()],
            "opt_state": opt}
    assert all(want.values())
    assert info["param_counts"] == {k: sum(t.numel() for t in v)
                                    for k, v in want.items()}
    assert info["payload_mb"] == {
        k: round(sum(t.numel() * t.element_size() for t in v) / 1e6, 1)
        for k, v in want.items()}
    # the JAX command's view of the same kind of directory, key for key
    assert set(info["param_counts"]) == set(info["payload_mb"]) == \
        {"trainable", "batch_stats", "opt_state"}
