"""Static-shape sentence/chunk packer — the keystone host transform (the
PyTorch port's copy of mmoe_multimodal_rec_tpu/data/packer.py).

Reimplements `preprocess_batch` (ref model.py:29-117) with identical packing
semantics but XLA-static outputs (SURVEY §7.2): the reference emits
batch-dependent [N_chunks, max_chunk_len] / [N_chunks, max_sents_per_chunk]
plus a python chunk->sample bucket loop on device (model.py:302-327); under
jit those dynamic shapes would recompile every step.  Here everything pads to
the caps that already exist in the reference — max_tok=384 tokens/chunk,
4 chunks/sample, 64 sentences/sample — and the regroup becomes two small
index tensors consumed by one gather in models/text_expert.py.

Replicated reference quirks (deliberate, for checkpoint parity):
- Per-sentence encode truncates to max_tok-3 tokens, then a <SENT> marker is
  prepended (model.py:58-66).
- A chunk flushes only when the NEXT sentence would overflow; if the flush
  reaches max_chunks, the sentence that triggered it is silently dropped
  (model.py:57-94).
- Out-of-base-vocab ids clamp to [PAD] — *including the <SENT> marker itself*
  (id == vocab_size, model.py:101-109).  The encoder therefore sees [PAD] at
  sentence slots (masked as attention keys) and the sentence vector is the
  hidden state of that slot; the published checkpoints depend on this.
- Sentence positions are +1-shifted for the [CLS] prefix (model.py:73-75).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..config import PackerConfig
from .sentence import make_sentence_splitter


@dataclass
class PackedBatch:
    """Static-shape packed text for one side (user or item)."""
    tokens: np.ndarray      # [N_budget, max_tok] int32, pad rows = pad_id
    sent_chunk: np.ndarray  # [B, S] int32 global chunk row, -1 pad
    sent_tok: np.ndarray    # [B, S] int32 token index of the marker, -1 pad
    n_chunks: int           # real chunks (<= N_budget)


class TextPacker:
    def __init__(self, tokenizer, cfg: Optional[PackerConfig] = None,
                 splitter: Optional[Callable[[str], List[str]]] = None):
        self.tok = tokenizer
        self.cfg = cfg or PackerConfig()
        self.split = splitter or make_sentence_splitter()

    def pack(self, texts: Sequence[str],
             chunk_budget: Optional[int] = None) -> PackedBatch:
        cfg = self.cfg
        tok = self.tok
        max_tok = cfg.max_tok
        pad_limit = max_tok - 2
        budget = chunk_budget or cfg.chunk_budget or \
            len(texts) * cfg.max_chunks_per_sample
        S = cfg.fixed_sent_count

        sents_per_text = [self.split(text) for text in texts]

        # Fast path: the native tokenizer runs the ENTIRE pack stage (encode
        # + greedy chunk packing) in one GIL-released C++ call — identical
        # outputs to the Python loop below (cross-checked in
        # tests/test_torch_native_tokenizer.py), but loader pack threads scale
        # with cores.
        if hasattr(tok, "pack_batch"):
            tokens, sent_chunk, sent_tok, n_chunks = tok.pack_batch(
                sents_per_text, max_tok=max_tok,
                max_chunks_per_sample=cfg.max_chunks_per_sample,
                fixed_sent_count=S, budget=budget)
            return PackedBatch(tokens=tokens, sent_chunk=sent_chunk,
                               sent_tok=sent_tok, n_chunks=n_chunks)

        tokens = np.full((budget, max_tok), tok.pad_id, np.int32)
        sent_chunk = np.full((len(texts), S), -1, np.int32)
        sent_tok = np.full((len(texts), S), -1, np.int32)

        # Encode EVERY sentence of the batch in one tokenizer call when the
        # backend supports it: the native C++ encode_batch releases the GIL
        # for the whole batch, so BatchLoader pack threads genuinely overlap
        # (the per-sentence path holds the GIL between tiny encode calls).
        # Semantics identical: same per-sentence truncation; sentences the
        # packing loop would skip (chunk cap reached) are encoded in vain,
        # which has no observable effect.
        if hasattr(tok, "encode_batch"):
            flat = [s for sents in sents_per_text for s in sents]
            encoded = tok.encode_batch(flat, max_length=pad_limit - 1)
        else:
            encoded = [tok.encode(s, max_length=pad_limit - 1)
                       for sents in sents_per_text for s in sents]
        enc_per_text: List[List[List[int]]] = []
        pos = 0
        for sents in sents_per_text:
            enc_per_text.append(encoded[pos:pos + len(sents)])
            pos += len(sents)
        return self.pack_encoded(enc_per_text, chunk_budget)

    def pack_encoded(self, enc_per_text: Sequence[Sequence[Sequence[int]]],
                     chunk_budget: Optional[int] = None) -> PackedBatch:
        """Greedy chunk packing over PRE-ENCODED sentences (one list of
        base token ids per sentence per text, already truncated to
        <= max_tok-3).  This is the offline-pretokenization entry point
        (the reference lists precomputed tokenization as intended future
        work, README.md:670): with sentence splitting + WordPiece done
        offline (`data/pretokenize.py`), the in-loader host work reduces
        to this cheap packing loop.  Output is bit-identical to
        `pack()` on the same sentences (tests/test_torch_data_pipeline.py,
        tests/test_torch_native_tokenizer.py)."""
        cfg = self.cfg
        tok = self.tok
        max_tok = cfg.max_tok
        pad_limit = max_tok - 2
        budget = chunk_budget or cfg.chunk_budget or \
            len(enc_per_text) * cfg.max_chunks_per_sample
        S = cfg.fixed_sent_count

        # native fast path: greedy pack in one GIL-released C++ call
        # (bit-identical to the loop below,
        # tests/test_torch_native_tokenizer.py)
        if hasattr(tok, "pack_encoded_batch"):
            tokens, sent_chunk, sent_tok, n_chunks = tok.pack_encoded_batch(
                enc_per_text, max_tok=max_tok,
                max_chunks_per_sample=cfg.max_chunks_per_sample,
                fixed_sent_count=S, budget=budget)
            return PackedBatch(tokens=tokens, sent_chunk=sent_chunk,
                               sent_tok=sent_tok, n_chunks=n_chunks)

        tokens = np.full((budget, max_tok), tok.pad_id, np.int32)
        sent_chunk = np.full((len(enc_per_text), S), -1, np.int32)
        sent_tok = np.full((len(enc_per_text), S), -1, np.int32)

        trunc = pad_limit - 1   # per-sentence cap the encode stage applies
        chunk_row = 0
        for si, sents in enumerate(enc_per_text):
            cur: List[int] = []
            sent_pos: List[int] = []
            chunk_count = 0
            n_sents = 0  # sentences recorded for this sample (cap S)

            def emit(cur_ids: List[int], positions: List[int]) -> bool:
                """Write one chunk; record its sentence routing. Returns
                False when the global chunk budget is exhausted."""
                nonlocal chunk_row, n_sents
                if chunk_row >= budget:
                    return False
                row = [tok.cls_id] + cur_ids + [tok.sep_id]
                ids = np.asarray(row, np.int32)
                # OOV clamp incl. <SENT> (model.py:101-109)
                ids[ids >= tok.vocab_size] = tok.pad_id
                tokens[chunk_row, :len(ids)] = ids
                for p in positions:          # +1 shift for [CLS]
                    if n_sents >= S:
                        break
                    sent_chunk[si, n_sents] = chunk_row
                    sent_tok[si, n_sents] = p + 1
                    n_sents += 1
                chunk_row += 1
                return True

            for base_ids in sents:
                if chunk_count >= cfg.max_chunks_per_sample:
                    break
                # re-truncate: a no-op for ids encoded at this max_tok;
                # recovers exact semantics for ids pretokenized at a
                # LARGER max_tok (WordPiece truncation is prefix-take)
                ids = [tok.sent_id] + list(base_ids[:trunc])
                if len(cur) + len(ids) > pad_limit:
                    emit(cur, sent_pos)
                    chunk_count += 1
                    cur, sent_pos = list(ids), [0]
                else:
                    sent_pos.append(len(cur))
                    cur.extend(ids)
            if chunk_count < cfg.max_chunks_per_sample and cur:
                emit(cur, sent_pos)

        return PackedBatch(tokens=tokens, sent_chunk=sent_chunk,
                           sent_tok=sent_tok, n_chunks=chunk_row)


def pack_pair(packer: TextPacker, user_texts: Sequence[str],
              item_texts: Sequence[str],
              chunk_budget: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Pack both text sides into the model's batch-key layout."""
    u = packer.pack(user_texts, chunk_budget)
    i = packer.pack(item_texts, chunk_budget)
    return {
        "user_tokens": u.tokens, "user_sent_chunk": u.sent_chunk,
        "user_sent_tok": u.sent_tok,
        "item_tokens": i.tokens, "item_sent_chunk": i.sent_chunk,
        "item_sent_tok": i.sent_tok,
    }


def packer_from_config(cfg) -> TextPacker:
    """Framework-wide packer factory from the root Config: the WordPiece
    tokenizer over data.vocab_path (the native C++ one,
    data/native_tokenizer.py, when g++ builds it, else the pure-Python
    data/wordpiece.py, which gives the same ids), or the vocab-free
    HashTokenizer when data.allow_hash_tokenizer is set, + the config's
    packing caps.  Every CLI entry point builds its packer here.

    Vocab-less runs ERROR unless data.allow_hash_tokenizer is set: the hash
    stand-in produces deterministic but meaningless ids on real text, where
    the reference would have loaded a real vocab (ref train.py:102-103) —
    a forgotten --data.vocab_path must fail loudly, not degrade silently."""
    from .native_tokenizer import load_best_tokenizer
    if not cfg.data.vocab_path and not cfg.data.allow_hash_tokenizer:
        raise ValueError(
            "data.vocab_path is unset: real text would be tokenized with the "
            "vocab-free HashTokenizer stand-in and produce garbage ids. Set "
            "--data.vocab_path=<BGE/BERT vocab.txt>, or pass "
            "--data.allow_hash_tokenizer=true only for synthetic corpora "
            "(tests/benchmarks).")
    # without a vocab, the hash ids stay inside the embedding table
    # (vocab_size counts the <SENT> row, so the base vocab is one smaller)
    return TextPacker(load_best_tokenizer(cfg.data.vocab_path,
                                          cfg.model.text.vocab_size),
                      cfg.model.packer)

