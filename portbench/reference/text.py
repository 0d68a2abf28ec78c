"""Plain reference of the host text path: sentence splitting, BERT
WordPiece (uncased) and the static-shape chunk packing.

Written from the reference recommender's `preprocess_batch` semantics
(per-sentence encode truncated to max_tok - 3 tokens, a <SENT> marker in
front of each sentence, greedy chunks of at most max_tok - 2 ids that
flush when the next sentence would overflow, at most
max_chunks_per_sample chunks a sample, the sentence that triggered a
flush at the cap dropped, ids at or past the base vocab (the <SENT>
marker included) clamped to [PAD], sentence positions shifted by one for
[CLS], at most fixed_sent_count sentences a sample, chunks placed in one
budget of rows for the batch) and HF BertTokenizer's basic and WordPiece
steps.  Nothing here is shared with the program.
"""
from __future__ import annotations

import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "inc",
    "ltd", "co", "corp", "dept", "est", "approx", "appt", "apt", "no", "nos",
    "vol", "fig", "sec", "min", "max", "oz", "lb", "lbs", "ft", "in", "cm",
    "mm", "kg", "km", "hr", "hrs", "yr", "yrs", "wk", "wks", "mfg", "gov",
    "edu", "e.g", "i.e", "u.s", "a.m", "p.m", "jan", "feb", "mar", "apr",
    "jun", "jul", "aug", "sep", "sept", "oct", "nov", "dec",
}
_BOUNDARY = re.compile(r"""(?<=[.!?])(?:["'”’\)\]]*)\s+(?=["'“‘\(\[]?\w)""")


def split_sentences(text: str) -> List[str]:
    """Rule-based splitter: a boundary after terminal punctuation and
    whitespace before a word, unless the word before is a known
    abbreviation or a one-letter initial."""
    text = (text or "").strip()
    if not text:
        return []
    pieces, start = [], 0
    for m in _BOUNDARY.finditer(text):
        end = m.start()
        left = text[max(0, end - 24):end]
        w = re.search(r"([\w.]+)[.!?]+$", left)
        if w:
            word = w.group(1).rstrip(".")
            if word.lower() in _ABBREV or (len(word) == 1 and word.isalpha()):
                continue
        while end < len(text) and text[end] in "\"'”’)]":
            end += 1
        seg = text[start:end].strip()
        if seg:
            pieces.append(seg)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        pieces.append(tail)
    return pieces or [text]


def _punct(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


# ASCII control characters but tab, newline and carriage return: dropped
_ASCII_CONTROL = {i: None for i in [*range(32), 127] if i not in (9, 10, 13)}
_PIECES: Dict[str, List[str]] = {}


def _pieces(tok: str) -> List[str]:
    """One whitespace-free token: lower-cased, accents stripped, split at
    punctuation."""
    tok = "".join(c for c in unicodedata.normalize("NFD", tok.lower())
                  if unicodedata.category(c) != "Mn")
    out, cur = [], []
    for ch in tok:
        if _punct(ch):
            if cur:
                out.append("".join(cur))
                cur = []
            out.append(ch)
        else:
            cur.append(ch)
    if cur:
        out.append("".join(cur))
    return out


def basic_tokens(text: str) -> List[str]:
    if text.isascii():
        words = text.translate(_ASCII_CONTROL).split()
    else:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or (ch not in "\t\n\r" and
                                           unicodedata.category(ch).startswith("C")):
                continue
            chars.append(" " if ch.isspace() else ch)
        words = "".join(chars).split()
    out: List[str] = []
    for tok in words:
        hit = _PIECES.get(tok)
        if hit is None:
            hit = _PIECES[tok] = _pieces(tok)
        out.extend(hit)
    return out


class WordPiece:
    """Greedy longest-match WordPiece over a vocab.txt's lines."""

    def __init__(self, vocab_lines: Sequence[str]):
        self.vocab: Dict[str, int] = {w: i for i, w in enumerate(vocab_lines)}
        self.unk = self.vocab["[UNK]"]
        self.cls = self.vocab["[CLS]"]
        self.sep = self.vocab["[SEP]"]
        self.pad = self.vocab["[PAD]"]
        self.size = len(self.vocab)
        self.sent = self.size          # <SENT>, added past the base vocab
        self._cache: Dict[str, List[int]] = {}

    def word(self, w: str) -> List[int]:
        hit = self._cache.get(w)
        if hit is not None:
            return hit
        if len(w) > 100:
            ids = [self.unk]
        else:
            ids, start = [], 0
            while start < len(w):
                end, cur = len(w), None
                while start < end:
                    sub = w[start:end] if start == 0 else "##" + w[start:end]
                    if sub in self.vocab:
                        cur = self.vocab[sub]
                        break
                    end -= 1
                if cur is None:
                    ids = [self.unk]
                    break
                ids.append(cur)
                start = end
        self._cache[w] = ids
        return ids

    def encode(self, text: str, max_length: int) -> List[int]:
        ids: List[int] = []
        for w in basic_tokens(text):
            ids.extend(self.word(w))
            if len(ids) >= max_length:
                break
        return ids[:max_length]


def pack(tok: WordPiece, texts: Sequence[str], budget: int, max_tok: int,
         max_chunks: int, sent_count: int
         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(tokens [budget, max_tok], sent_chunk [B, S], sent_tok [B, S])."""
    limit = max_tok - 2
    trunc = limit - 1
    tokens = np.full((budget, max_tok), tok.pad, np.int32)
    sent_chunk = np.full((len(texts), sent_count), -1, np.int32)
    sent_tok = np.full((len(texts), sent_count), -1, np.int32)
    row = 0
    for si, text in enumerate(texts):
        n_sents = 0
        chunks = 0
        cur: List[int] = []
        pos: List[int] = []

        def emit():
            nonlocal row, n_sents
            if row >= budget:
                return
            ids = np.asarray([tok.cls] + cur + [tok.sep], np.int32)
            ids[ids >= tok.size] = tok.pad
            tokens[row, :len(ids)] = ids
            for p in pos:
                if n_sents >= sent_count:
                    break
                sent_chunk[si, n_sents] = row
                sent_tok[si, n_sents] = p + 1
                n_sents += 1
            row += 1

        for sentence in split_sentences(text):
            if chunks >= max_chunks:
                break
            ids = [tok.sent] + tok.encode(sentence, trunc)
            if len(cur) + len(ids) > limit:
                emit()
                chunks += 1
                cur, pos = list(ids), [0]
            else:
                pos.append(len(cur))
                cur.extend(ids)
        if chunks < max_chunks and cur:
            emit()
    return tokens, sent_chunk, sent_tok
