"""ctypes wrapper for the native C++ WordPiece tokenizer.

Drop-in replacement for data/wordpiece.WordPieceTokenizer (same id-level
behavior on the Amazon-review text domain; the Python implementation remains
the correctness reference and the fallback when g++ or the .so is
unavailable).  Releases the GIL for the whole encode call, so loader threads
overlap with device steps even on single-core hosts.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/native_tokenizer.py
over its own native/wordpiece.cpp, built into build/ (native/__init__.py).
A failed build is reported on stderr, not swallowed.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from ..native import native_library_path
from .wordpiece import WordPieceTokenizer


class NativeWordPieceTokenizer:
    """Same protocol as WordPieceTokenizer: encode / cls_id / sep_id /
    pad_id / sent_id / vocab_size (+ encode_batch fast path)."""

    def __init__(self, vocab_path: str, lower_case: bool = True,
                 so_path: Optional[str] = None):
        so = so_path or native_library_path()
        if so is None:
            raise RuntimeError("native wordpiece library unavailable "
                               "(g++ build failed)")
        self._lib = ctypes.CDLL(so)
        self._lib.wp_create.restype = ctypes.c_void_p
        self._lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                        ctypes.c_int, ctypes.c_int32]
        self._lib.wp_destroy.argtypes = [ctypes.c_void_p]
        self._lib.wp_vocab_size.restype = ctypes.c_int32
        self._lib.wp_vocab_size.argtypes = [ctypes.c_void_p]
        self._lib.wp_encode.restype = ctypes.c_int32
        self._lib.wp_encode.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        self._lib.wp_encode_batch.restype = ctypes.c_int32
        self._lib.wp_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32)]
        self._lib.wp_pack_batch.restype = ctypes.c_int32
        self._lib.wp_pack_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]
        self._lib.wp_pack_encoded_batch.restype = ctypes.c_int32
        self._lib.wp_pack_encoded_batch.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32)]

        # special ids from the vocab via the python reference loader
        ref = WordPieceTokenizer.from_vocab_file(vocab_path,
                                                 lower_case=lower_case)
        self.pad_id = ref.pad_id
        self.unk_id = ref.unk_id
        self.cls_id = ref.cls_id
        self.sep_id = ref.sep_id
        self.vocab_size = ref.vocab_size
        self.sent_id = ref.sent_id

        with open(vocab_path, "rb") as f:
            data = f.read()
        self._handle = self._lib.wp_create(data, len(data),
                                           1 if lower_case else 0,
                                           self.unk_id)
        assert self._lib.wp_vocab_size(self._handle) == self.vocab_size

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.wp_destroy(handle)
            self._handle = None

    def encode(self, text: str, max_length: Optional[int] = None
               ) -> List[int]:
        cap = max_length if max_length else 4096
        out = (ctypes.c_int32 * cap)()
        n = self._lib.wp_encode(self._handle, text.encode("utf-8"),
                                max_length or 0, out, cap)
        return list(out[:n])

    def encode_batch(self, texts: Sequence[str],
                     max_length: Optional[int] = None) -> List[List[int]]:
        """One GIL release for the whole batch."""
        if not texts:
            return []
        cap = max_length if max_length else 4096
        blobs = [t.encode("utf-8") for t in texts]
        offsets = np.zeros(len(blobs), np.int64)
        pos = 0
        buf = bytearray()
        for i, blob in enumerate(blobs):
            offsets[i] = pos
            buf += blob + b"\x00"
            pos += len(blob) + 1
        out = np.zeros((len(blobs), cap), np.int32)
        lens = np.zeros(len(blobs), np.int32)
        self._lib.wp_encode_batch(
            self._handle, bytes(buf),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(blobs), max_length or 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return [out[i, :lens[i]].tolist() for i in range(len(blobs))]

    def pack_batch(self, sents_per_text, *, max_tok: int,
                   max_chunks_per_sample: int, fixed_sent_count: int,
                   budget: int):
        """The ENTIRE pack stage (sentence encode + greedy chunk packing,
        data/packer.py semantics) in one GIL-released native call — the
        BatchLoader's pack threads scale with cores this way.

        sents_per_text: per text, its pre-split sentence list.
        Returns (tokens [budget, max_tok], sent_chunk [B, S],
        sent_tok [B, S], n_chunks).
        """
        counts = np.asarray([len(s) for s in sents_per_text], np.int32)
        flat = [s.encode("utf-8") for sents in sents_per_text for s in sents]
        offsets = np.zeros(max(len(flat), 1), np.int64)
        buf = bytearray()
        pos = 0
        for i, blob in enumerate(flat):
            offsets[i] = pos
            buf += blob + b"\x00"
            pos += len(blob) + 1
        b = len(sents_per_text)
        tokens = np.empty((budget, max_tok), np.int32)
        sent_chunk = np.empty((b, fixed_sent_count), np.int32)
        sent_tok = np.empty((b, fixed_sent_count), np.int32)
        as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n_chunks = self._lib.wp_pack_batch(
            self._handle, bytes(buf),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            as_i32(counts), b, max_tok, max_chunks_per_sample,
            fixed_sent_count, budget, self.cls_id, self.sep_id, self.pad_id,
            self.sent_id, self.vocab_size, as_i32(tokens), as_i32(sent_chunk),
            as_i32(sent_tok))
        return tokens, sent_chunk, sent_tok, int(n_chunks)

    def pack_encoded_batch(self, enc_per_text, *, max_tok: int,
                           max_chunks_per_sample: int, fixed_sent_count: int,
                           budget: int):
        """Greedy packing over PRE-ENCODED sentences (offline
        pretokenization sidecars) in one GIL-released native call —
        wp_pack_batch minus the encode stage.

        enc_per_text: per text, a list of base-token-id sequences (no
        <SENT> marker; any truncation state — the C++ side re-truncates to
        max_tok-3).  Returns (tokens, sent_chunk, sent_tok, n_chunks)."""
        counts = np.asarray([len(s) for s in enc_per_text], np.int32)
        lens_list = [len(s) for sents in enc_per_text for s in sents]
        lens = np.asarray(lens_list or [0], np.int32)
        total = int(sum(lens_list))
        flat = np.empty(max(total, 1), np.int32)
        pos = 0
        for sents in enc_per_text:
            for s in sents:
                n = len(s)
                flat[pos:pos + n] = np.asarray(s, np.int32)
                pos += n
        b = len(enc_per_text)
        tokens = np.empty((budget, max_tok), np.int32)
        sent_chunk = np.empty((b, fixed_sent_count), np.int32)
        sent_tok = np.empty((b, fixed_sent_count), np.int32)
        as_i32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        n_chunks = self._lib.wp_pack_encoded_batch(
            as_i32(flat), as_i32(lens), as_i32(counts), b, max_tok,
            max_chunks_per_sample, fixed_sent_count, budget, self.cls_id,
            self.sep_id, self.pad_id, self.sent_id, self.vocab_size,
            as_i32(tokens), as_i32(sent_chunk), as_i32(sent_tok))
        return tokens, sent_chunk, sent_tok, int(n_chunks)


def load_best_tokenizer(vocab_path: Optional[str],
                        model_vocab_size: Optional[int] = None):
    """Native if buildable, else pure-Python, else hash fallback.

    `model_vocab_size` (embedding rows incl. <SENT>) bounds the hash
    fallback's id range — without it a vocab-less run would emit ids past
    the embedding table (an indexing error in the embedding lookup).

    The native tokenizer and the pure-Python one give the same ids
    (tests/test_torch_native_tokenizer.py); when the native one cannot be
    built or loaded, the reason goes to stderr before the pure-Python one
    takes its place."""
    import sys
    if vocab_path:
        try:
            return NativeWordPieceTokenizer(vocab_path)
        except Exception as e:
            print(f"[tokenizer] native WordPiece unavailable "
                  f"({type(e).__name__}: {e}); using the pure-Python one",
                  file=sys.stderr, flush=True)
            return WordPieceTokenizer.from_vocab_file(vocab_path)
    print("[tokenizer] WARNING: no vocab_path — using the vocab-free "
          "HashTokenizer stand-in (synthetic/benchmark use only; real text "
          "gets meaningless ids)", file=sys.stderr, flush=True)
    from .wordpiece import HashTokenizer
    return HashTokenizer(vocab_size=(model_vocab_size - 1)
                         if model_vocab_size else 30522)
