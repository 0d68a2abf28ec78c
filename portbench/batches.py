"""Training batches drawn from the seed, with the fill of real text.

Each sample is one review of a user: its user text holds the reviews the
user wrote before it, its item text the item's features and description,
both rendered by the traffic generator (textgen) from the length laws of
the mix named by `lengths_from`.  The texts are split, WordPiece-tokenized
and packed by the benchmark's plain text path (reference/text.py, the
same packing as the program's packer) into at most `chunks_per_sample`
chunks of `max_tok` ids, so the chunks are filled as far as real reviews
fill them and no further.  Patches are random bytes, a share of the
samples carry one, labels are Bernoulli draws at the reference's shares.

Every seed gets the same set of sizes: the samples' users and items and
their lengths come from the mix's fixed `sizes_seed`, and the run's seed
deals them out to the pool's samples in another order and draws
everything else (words, vocab, patches, images, labels), so the work of a
step does not move with the seed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .reference.text import WordPiece, pack
from .textgen import TextMaker, make_vocab, zipf_items


def train_pool(seed: int, mix: Dict, lengths: Dict, port: Dict[str, object]
               ) -> List[Dict[str, np.ndarray]]:
    """`mix["pool_steps"]` optimizer steps' batches, each stacked
    [grad_accum, ...]."""
    rng = np.random.default_rng([seed % (1 << 63), 7])
    sizes = np.random.default_rng([int(mix["sizes_seed"]), 7])
    vocab, words = make_vocab(rng, int(port["model.text.vocab_size"]) - 1)
    tok = WordPiece(vocab)
    maker = TextMaker(seed, words, lengths)
    b = int(mix["batch_size"])
    accum = int(mix["grad_accum"])
    steps = int(mix["pool_steps"])
    n = steps * accum * b
    users = maker.sample_user_sizes(sizes, n, int(lengths["users"]))
    pool_items = int(lengths["items"])
    items = zipf_items(sizes, pool_items, float(lengths["item_zipf"]), n)
    item_sizes = maker.item_sizes(sizes, pool_items)
    order = rng.permutation(n)
    user_text = maker.texts([users[i] for i in order], 1)
    item_text = maker.texts([item_sizes[items[i]] for i in order], 2)
    chunks = int(mix["chunks_per_sample"])
    max_tok = int(port["model.packer.max_tok"])
    max_chunks = int(port["model.packer.max_chunks_per_sample"])
    s = int(port["model.packer.fixed_sent_count"])
    num_patches = int(port["model.image.num_patches"])
    patch_dim = int(port["model.image.patch_dim"])
    pool = []
    for j in range(steps):
        micro = []
        for i in range(accum):
            m = {}
            at = (j * accum + i) * b
            for side, texts in (("user", user_text), ("item", item_text)):
                (m[f"{side}_tokens"], m[f"{side}_sent_chunk"],
                 m[f"{side}_sent_tok"]) = pack(tok, texts[at:at + b], b * chunks,
                                               max_tok, max_chunks, s)
            m["patches"] = rng.integers(0, 256, (b, num_patches, patch_dim),
                                        dtype=np.uint8)
            m["has_image"] = (rng.random(b) < float(mix["image_share"])
                              ).astype(np.int32)
            m["label_good"] = (rng.random(b) < float(mix["label_good"])
                               ).astype(np.float32)
            m["label_best"] = (rng.random(b) < float(mix["label_best"])
                               ).astype(np.float32)
            micro.append(m)
        pool.append({k: np.stack([m[k] for m in micro]) for k in micro[0]})
    return pool
