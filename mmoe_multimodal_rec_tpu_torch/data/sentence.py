"""Fast English sentence splitting (the PyTorch port's copy of
mmoe_multimodal_rec_tpu/data/sentence.py).

Plays the role NLTK punkt plays in the reference (`nltk_sentence_split`,
model.py:20-26; chosen there for a >50x speedup over spaCy, README.md:317).
This implementation is a self-contained rule-based splitter — no model data
download — tuned for the review/product text the pipeline feeds it.  If the
NLTK punkt data happens to be installed, `make_sentence_splitter` returns it
instead so behavior matches the reference exactly.
"""
from __future__ import annotations

import re
from typing import Callable, List

# Abbreviations that a following period does NOT end a sentence after.
_ABBREV = {
    "mr", "mrs", "ms", "dr", "prof", "sr", "jr", "st", "vs", "etc", "inc",
    "ltd", "co", "corp", "dept", "est", "approx", "appt", "apt", "no", "nos",
    "vol", "fig", "sec", "min", "max", "oz", "lb", "lbs", "ft", "in", "cm",
    "mm", "kg", "km", "hr", "hrs", "yr", "yrs", "wk", "wks", "mfg", "gov",
    "edu", "e.g", "i.e", "u.s",
    "a.m", "p.m", "jan", "feb", "mar", "apr", "jun", "jul", "aug", "sep",
    "sept", "oct", "nov", "dec",
}

# Sentence boundary: terminal punctuation run, optional closing quote/paren,
# then whitespace and an upper-case/digit/quote opener.
_BOUNDARY = re.compile(
    r"""(?<=[.!?])            # terminal punct behind us
        (?:["'”’\)\]]*)  # optional closers
        \s+                   # the gap
        (?=["'“‘\(\[]?\w)""",
    re.VERBOSE)


def _protected(left: str) -> bool:
    """Is the token immediately left of the candidate boundary an
    abbreviation / initial / decimal that should NOT split?"""
    m = re.search(r"([\w.]+)[.!?]+$", left)
    if not m:
        return False
    word = m.group(1).rstrip(".")
    lower = word.lower()
    if lower in _ABBREV:
        return True
    if len(word) == 1 and word.isalpha():      # single-letter initial "J."
        return True
    if re.fullmatch(r"\d+", word) and left.rstrip()[-1:] == ".":
        # "4." in enumerations — punkt usually splits here; keep split.
        return False
    return False


def split_sentences(text: str) -> List[str]:
    """Split text into sentences; returns [] for empty input
    (== nltk_sentence_split semantics, ref model.py:20-26)."""
    if not text:
        return []
    text = text.strip()
    if not text:
        return []
    pieces: List[str] = []
    start = 0
    for m in _BOUNDARY.finditer(text):
        end = m.start()  # just after the terminal punct (lookbehind)
        if _protected(text[max(0, end - 24):end]):
            continue
        # include any closing quotes/brackets in this sentence
        while end < len(text) and text[end] in "\"'”’)]":
            end += 1
        seg = text[start:end].strip()
        if seg:
            pieces.append(seg)
        start = m.end()
    tail = text[start:].strip()
    if tail:
        pieces.append(tail)
    return pieces if pieces else [text]


def make_sentence_splitter(prefer_nltk: bool = True
                           ) -> Callable[[str], List[str]]:
    """Return the best available splitter; prefers NLTK punkt when its data
    is installed (exact reference behavior), else the rule-based one."""
    if prefer_nltk:
        try:
            import nltk
            nltk.data.find("tokenizers/punkt_tab")
            from nltk.tokenize import sent_tokenize

            def nltk_split(text: str) -> List[str]:
                if not text:
                    return []
                return sent_tokenize(text)

            return nltk_split
        except Exception:
            pass
    return split_sentences
