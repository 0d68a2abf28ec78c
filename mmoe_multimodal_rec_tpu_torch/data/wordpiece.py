"""Self-contained WordPiece tokenizer (BERT/BGE `vocab.txt` format); the
PyTorch port's copy of mmoe_multimodal_rec_tpu/data/wordpiece.py.

Replaces the reference's `AutoTokenizer.from_pretrained("BAAI/bge-base-en-v1.5")`
(ref train.py:102-103) without any network dependency: given the model's
vocab.txt it reproduces HF `BertTokenizer` (uncased) token ids — verified
against `transformers.BertTokenizer` in tests/test_tokenizer.py.

Also ships `HashTokenizer`, a deterministic vocab-free stand-in with the same
interface, used by the synthetic-data tests and benchmarks where the real
vocab file is unavailable (zero-egress environments).

Both expose the protocol the packer needs:
  encode(text) -> List[int]   (no special tokens, like
                               tokenizer.encode(add_special_tokens=False))
  cls_id / sep_id / pad_id / sent_id / vocab_size
where `sent_id` is the "<SENT>" marker appended beyond the base vocab
(ref train.py:103 `tokenizer.add_tokens(["<SENT>"])` => id == vocab_size).
"""
from __future__ import annotations

import hashlib
import unicodedata
from typing import Dict, List, Optional

SENT_TOKEN = "<SENT>"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def basic_tokenize(text: str, lower_case: bool = True) -> List[str]:
    """HF BasicTokenizer equivalent: clean, CJK-space, lowercase+strip
    accents, split on punctuation."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if ch.isspace():
            out_chars.append(" ")
        elif _is_cjk(cp):
            out_chars.extend((" ", ch, " "))
        else:
            out_chars.append(ch)
    tokens = "".join(out_chars).split()

    result: List[str] = []
    for token in tokens:
        if lower_case:
            token = token.lower()
            token = unicodedata.normalize("NFD", token)
            token = "".join(c for c in token
                            if unicodedata.category(c) != "Mn")
        # split on punctuation
        current: List[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    result.append("".join(current))
                    current = []
                result.append(ch)
            else:
                current.append(ch)
        if current:
            result.append("".join(current))
    return result


class WordPieceTokenizer:
    """Greedy longest-match WordPiece over a BERT vocab.txt."""

    def __init__(self, vocab: Dict[str, int], lower_case: bool = True,
                 unk_token: str = "[UNK]", cls_token: str = "[CLS]",
                 sep_token: str = "[SEP]", pad_token: str = "[PAD]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lower_case = lower_case
        self.unk_id = vocab[unk_token]
        self.cls_id = vocab[cls_token]
        self.sep_id = vocab[sep_token]
        self.pad_id = vocab[pad_token]
        self.max_chars_per_word = max_chars_per_word
        # base vocab size EXCLUDES added tokens (HF tokenizer.vocab_size
        # semantics, relied on by the reference's OOV clamp model.py:101-109)
        self.vocab_size = len(vocab)
        self.sent_id = self.vocab_size  # "<SENT>" added beyond base vocab

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    def wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars_per_word:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur: Optional[int] = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """Token ids without special tokens; truncation like
        tokenizer.encode(add_special_tokens=False, max_length, truncation=True)."""
        ids: List[int] = []
        for word in basic_tokenize(text, self.lower_case):
            ids.extend(self.wordpiece(word))
        if max_length is not None:
            ids = ids[:max_length]
        return ids


class HashTokenizer:
    """Deterministic vocab-free tokenizer with the same interface: words map
    to stable hashes in (reserved, vocab_size). Test/bench stand-in only."""

    def __init__(self, vocab_size: int = 30522, lower_case: bool = True):
        self.vocab_size = vocab_size
        self.lower_case = lower_case
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 100, 101, 102
        self.sent_id = vocab_size
        # BERT-like reserved prefix, shrunk for tiny test vocabs — word ids
        # MUST stay < vocab_size or the packer's OOV clamp maps them to PAD.
        self.reserved = 999 if vocab_size >= 2000 else 103
        assert vocab_size > self.reserved + 1

    def _word_id(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return self.reserved + 1 + h % (self.vocab_size - self.reserved - 1)

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [self._word_id(w) for w in basic_tokenize(text, self.lower_case)]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

