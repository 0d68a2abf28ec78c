"""Synthetic corpus + shard generation for tests and benchmarks.

The reference has no test data story at all (SURVEY §4); this module
fabricates review-shaped samples — user/item texts rendered through the same
feature templates as the real pipeline (data/textbuild.py), random patch rows,
bernoulli labels — and writes them as byte-compatible WebDataset shards, so
every layer from tar IO to the train loop can be exercised hermetically.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/synthetic.py.
"""
from __future__ import annotations

import json
from typing import List

import numpy as np

from .tar_io import ShardWriter

_WORDS = (
    "great quality bike helmet tent sleeping bag running shoes light compact "
    "durable waterproof cheap broken zipper fits comfortable warm cold trail "
    "camping fishing rod reel strong recommend return refund size large small "
    "color blue red black straps buckle carry easy setup instructions missing "
    "battery charge lasted works perfectly arrived fast packaging damaged"
).split()


def random_sentence(rng: np.random.Generator, lo: int = 4, hi: int = 14) -> str:
    n = int(rng.integers(lo, hi))
    words = rng.choice(_WORDS, size=n)
    return " ".join(words).capitalize() + "."


def random_text(rng: np.random.Generator, n_sents_lo: int = 1,
                n_sents_hi: int = 8) -> str:
    n = int(rng.integers(n_sents_lo, n_sents_hi + 1))
    return " ".join(random_sentence(rng) for _ in range(n))


# Sentiment cues for `signal=True` corpora: label_good correlates with which
# cue sentence appears in the USER text, so a model that actually reads the
# text can beat the label marginal (demonstrated in the e2e convergence run,
# BENCHMARKS.md) while a broken pipeline cannot.
_POS_CUE = "Great quality highly recommend works perfectly."
_NEG_CUE = "Broken zipper damaged return refund disappointed."


def make_sample(rng: np.random.Generator, idx: int,
                p_image: float = 0.8, signal: bool = False) -> dict:
    has_image = int(rng.random() < p_image)
    if has_image:
        patch = rng.integers(0, 256, (196, 3, 16, 16), dtype=np.uint8)
        patch_bytes = patch.tobytes()
    else:
        # reference zero filler is 2x the real patch size
        # (data4model.py:214-217) — never read because has_image=0.
        patch_bytes = b"\x00" * (196 * 3 * 16 * 16 * 2)
    user_text = random_text(rng, 2, 10)
    if signal:
        # plant a readable cue: 85%-correlated sentiment sentence
        label_good = int(rng.random() < 0.5)
        cue = _POS_CUE if (label_good == (rng.random() < 0.85)) else _NEG_CUE
        sents = [s if s.endswith(".") else s + "."
                 for s in user_text.split(". ") if s]
        k = int(rng.integers(0, len(sents) + 1))
        user_text = " ".join(sents[:k] + [cue] + sents[k:])
    else:
        label_good = int(rng.random() < 0.5)
    label_best = int(label_good and rng.random() < 0.4)
    return {
        "__key__": f"user{idx % 97}-item{idx}-{idx:06x}",
        "user.json": user_text.encode(),
        "item.json": random_text(rng, 2, 10).encode(),
        "patch.bin": patch_bytes,
        "misc.json": json.dumps({"has_image": has_image,
                                 "shape": [196, 3, 16, 16]}).encode(),
        "label.json": json.dumps({"label_good": label_good,
                                  "label_best": label_best}).encode(),
    }


def write_synthetic_shards(output_dir: str, n_samples: int = 256,
                           samples_per_shard: int = 64,
                           seed: int = 0, p_image: float = 0.8,
                           compress: bool = True,
                           signal: bool = False) -> List[str]:
    rng = np.random.default_rng(seed)
    with ShardWriter(output_dir, samples_per_shard, compress=compress) as w:
        for i in range(n_samples):
            w.write(make_sample(rng, i, p_image, signal=signal))
    return w.paths


def synthetic_raw_batch(rng: np.random.Generator, batch_size: int,
                        p_image: float = 0.8) -> List[dict]:
    """Decoded-sample dicts (as produced by data/decode.decode_sample),
    bypassing tar IO — for quick tests/benches of the packing + model path."""
    out = []
    for _ in range(batch_size):
        has_image = int(rng.random() < p_image)
        patch = (rng.integers(0, 256, (196, 768), dtype=np.uint8)
                 if has_image else np.zeros((196, 768), np.uint8))
        good = int(rng.random() < 0.5)
        out.append({
            "user_text": random_text(rng, 2, 10),
            "item_text": random_text(rng, 2, 10),
            "patch": patch,
            "has_image": has_image,
            "label_good": float(good),
            "label_best": float(good and rng.random() < 0.4),
        })
    return out
