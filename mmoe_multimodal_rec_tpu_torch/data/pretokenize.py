"""Offline pre-tokenization: bake sentence tokens into the shards.

The reference lists "offline tokenization" as intended future work
(README.md:670) — its trainers re-split and re-tokenize every text on the
host inside the step loop on every epoch (train.py:236-239).  Here the
expensive host stages (sentence split + WordPiece encode) run ONCE,
offline, and are stored next to the sample inside the same tar shard;
the in-loader host work then reduces to the cheap greedy packing loop
(`TextPacker.pack_encoded`), which also keeps the chunk budget a
*training-time* knob (packing depends on chunk_budget/max_chunks, so it
cannot be baked without freezing those).

Sidecar format — two extra members per sample, `utok.bin` / `itok.bin`,
a little-endian int32 array:

    [version=1, max_sent_len, vocab_size, n_sents,
     len_0 .. len_{n-1}, flat ids ...]

`max_sent_len` records the per-sentence truncation the encode stage
applied (max_tok-3).  Packing at a config whose max_tok is <= the stored
one is exact (WordPiece truncation is prefix-take, so re-truncating
shorter recovers the identical ids); packing LONGER than stored would
need tokens that were cut offline.  `vocab_size` fingerprints the
tokenizer the ids came from: token ids are meaningless under a different
vocabulary, and without the check a mismatch would SILENTLY degrade model
inputs (the packer's OOV clamp hides it).  On either incompatibility the
loader falls back to the raw text path — decode keeps the texts either
way, so pretokenized shards can never be worse than plain ones.

Produced shards remain fully backward-compatible: readers that ignore the
sidecar members (including the reference's own webdataset pipeline) see
the original five-member samples unchanged.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/pretokenize.py,
with the same `<i4` sidecar layout and version, so that shards either
package pretokenized decode in the other
(tests/test_torch_data_pipeline.py).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .io import fs_glob, fs_makedirs
from .tar_io import iter_shard, write_shard

_VERSION = 1


def encode_sent_tokens(sents: Sequence[Sequence[int]], max_sent_len: int,
                       vocab_size: int) -> bytes:
    """Serialize pre-encoded sentences (ragged int32) to the sidecar bytes."""
    lens = [len(s) for s in sents]
    flat: List[int] = [i for s in sents for i in s]
    arr = np.asarray(
        [_VERSION, max_sent_len, vocab_size, len(sents)] + lens + flat,
        dtype="<i4")
    return arr.tobytes()


def decode_sent_tokens(raw: bytes) -> Tuple[int, int, List[np.ndarray]]:
    """Sidecar bytes -> (max_sent_len, vocab_size, [int32 ids/sentence]).
    Raises ValueError on malformed payloads (caller drops the sidecar and
    falls back to text)."""
    arr = np.frombuffer(raw, dtype="<i4")
    if arr.size < 4 or arr[0] != _VERSION:
        raise ValueError(f"bad sent-token sidecar (size={arr.size})")
    max_sent_len, vocab_size, n = int(arr[1]), int(arr[2]), int(arr[3])
    if n < 0 or arr.size < 4 + n:
        raise ValueError("truncated sent-token sidecar header")
    lens = arr[4:4 + n]
    if (lens < 0).any():
        raise ValueError("negative sentence length")
    total = int(lens.sum())
    if arr.size != 4 + n + total:
        raise ValueError(
            f"sidecar length mismatch: {arr.size} != {4 + n + total}")
    flat = arr[4 + n:]
    out, pos = [], 0
    for ln in lens:
        out.append(flat[pos:pos + int(ln)])
        pos += int(ln)
    return max_sent_len, vocab_size, out


def tokenize_text(text: str, packer) -> List[Sequence[int]]:
    """Split + encode one text with the packer's splitter/tokenizer at the
    packer's per-sentence truncation (max_tok-3, ref model.py:58-66)."""
    max_len = packer.cfg.max_tok - 3
    sents = packer.split(text)
    tok = packer.tok
    if hasattr(tok, "encode_batch"):
        return tok.encode_batch(sents, max_length=max_len)
    return [tok.encode(s, max_length=max_len) for s in sents]


def pretokenize_samples(samples: Iterable[dict], packer) -> Iterable[dict]:
    """Add utok.bin/itok.bin sidecars to raw tar samples (pass-through for
    samples without both text members)."""
    max_len = packer.cfg.max_tok - 3
    vocab = packer.tok.vocab_size
    for sample in samples:
        user = sample.get("user.json", b"")
        item = sample.get("item.json", b"")
        if user and item:
            try:
                utext = user.decode("utf-8").strip()
                itext = item.decode("utf-8").strip()
            except UnicodeDecodeError:
                # the loaders merely DROP undecodable samples
                # (decode_sample returns None); one such sample must not
                # abort a multi-shard rewrite — pass it through unchanged
                yield sample
                continue
            usents = tokenize_text(utext, packer)
            isents = tokenize_text(itext, packer)
            sample = dict(sample)
            sample["utok.bin"] = encode_sent_tokens(usents, max_len, vocab)
            sample["itok.bin"] = encode_sent_tokens(isents, max_len, vocab)
        yield sample


def pretokenize_shards(pattern: str, output_dir: str, packer) -> List[str]:
    """Rewrite every shard matching `pattern` into `output_dir` with token
    sidecars; shard names (and therefore split/shuffle behavior) are
    preserved.  Returns the written paths."""
    import os
    fs_makedirs(output_dir)
    out_paths = []
    for path in fs_glob(pattern):
        out = os.path.join(output_dir, os.path.basename(path))
        write_shard(out, pretokenize_samples(iter_shard(path), packer))
        out_paths.append(out)
    return out_paths
