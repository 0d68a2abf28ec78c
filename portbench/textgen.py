"""Synthetic review traffic: a WordPiece vocab, user and item texts, and
item popularity, all drawn from the seed.  A frozen generator: a traffic
file gives its parameters; this file never reads the program.

- The vocab: BERT's layout ([PAD], [unused*], [UNK], [CLS], [SEP], [MASK],
  punctuation, digits and letters with their ## pieces), the words of the
  text templates below whole (as BERT's own vocab holds them), then
  made-up lowercase words; every fourth long word is held only as a stem
  and a ## piece, so that WordPiece splits it.  Exactly `vocab_size` lines.
- Words are drawn by a Zipf(1.07) rank law over the made-up words.
- Texts are rendered by a frozen copy of the recommender's templates
  (data4model.py:95-181 of the reference; the feature rows of
  data4moe_beam.py keep a user's last 3 reviews):
  user: "Category history: <cat>: <p>%; .... Total reviews: <n>. Avg price:
  <m>. Price std: <s>. Review history: Review1: <text> Review2: ..." over
  the last `history` of the user's reviews;
  item: "Item category: <cat>. Item title: No title. Item price: <p>. Item
  features: <bullet>; <bullet>; ... Item description: <text>" (the title
  renders "No title" as the reference's feature rows make it).
- Lengths are drawn in tokens, as the source publishes them, from
  lognormal laws given by their mean and sigma, and turned into words by
  the traffic file's `tokens_per_word`; review and description words are
  cut into sentences of 6-18 words, feature bullets hold 8-40 words and no
  sentence end.
- Item popularity: Zipf(s) over a fixed pool, sampled without a rejection
  loop (inverse CDF over the pool's ranks).
"""
from __future__ import annotations

import math
import string
from typing import Dict, List, Sequence, Tuple

import numpy as np

_LETTERS = np.array(list(string.ascii_lowercase))

CATEGORIES = ("Sports & Outdoors", "Amazon Home", "Tools & Home Improvement",
              "Health & Personal Care", "All Electronics", "AMAZON FASHION",
              "Automotive", "Toys & Games")
TEMPLATE_WORDS = sorted(set(
    "category history total reviews avg price std review item title no "
    "features description variation browsing".split()
    + " ".join(CATEGORIES).lower().replace("&", " ").split()))


def make_vocab(rng: np.random.Generator, vocab_size: int
               ) -> Tuple[List[str], List[str]]:
    """(vocab lines, the words texts are drawn from)."""
    head = (["[PAD]"] + [f"[unused{i}]" for i in range(99)]
            + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    chars = string.digits + string.ascii_lowercase
    head += list(string.punctuation) + list(chars) + [f"##{c}" for c in chars]
    head += [w for w in TEMPLATE_WORDS if w not in head]
    seen = set(head)
    room = vocab_size - len(head)
    words: List[str] = []
    pieces: List[str] = []
    lengths = rng.integers(3, 11, size=4 * room)
    letters = rng.integers(0, 26, size=int(lengths.sum()))
    pos = 0
    for n in lengths:
        w = "".join(_LETTERS[letters[pos:pos + n]])
        pos += n
        if w in seen:
            continue
        seen.add(w)
        if len(w) >= 8 and len(words) % 4 == 3:
            parts = [w[:4], "##" + w[4:]]
            if any(p in seen for p in parts):
                continue
            seen.update(parts)
            pieces.extend(parts)
        else:
            pieces.append(w)
        words.append(w)
        if len(head) + len(pieces) >= vocab_size:
            break
    lines = (head + pieces)[:vocab_size]
    kept = set(lines)
    words = [w for w in words if w in kept or
             (w[:4] in kept and "##" + w[4:] in kept)]
    if len(lines) != vocab_size:
        raise ValueError(f"vocab of {len(lines)} lines, wanted {vocab_size}")
    return lines, words


def lognormal(rng, spec: Dict[str, float], size=None, scale: float = 1.0):
    """Whole numbers from a lognormal law given by its `mean` (or `mu`) and
    `sigma`, clipped to [min, max], divided by `scale`."""
    sigma = float(spec["sigma"])
    mu = (float(spec["mu"]) if "mu" in spec
          else math.log(float(spec["mean"])) - sigma * sigma / 2)
    x = np.clip(rng.lognormal(mu, sigma, size=size), spec["min"], spec["max"])
    return np.rint(x / scale).astype(np.int64)


def _smart_join(pieces: Sequence[str]) -> str:
    return " ".join(p if p.endswith((".", "!", "?", ";")) else p + ";"
                    for p in pieces)


def _terminated(s: str) -> str:
    return s if s.endswith((".", "!", "?", ";")) else s + "."


class TextMaker:
    """Sizes of texts from the mix's length laws, and texts of given sizes
    whose words are drawn from the seed.

    A user's sizes: {"reviews": reviews written so far, "cats": [(category,
    percent)], "price": (mean, std) or None, "history": [words of each of
    the last reviews]}.  An item's: {"cat", "price", "features": [words a
    bullet], "description": words}."""

    def __init__(self, seed: int, words: Sequence[str], mix: Dict):
        self.seed = seed
        self.words = np.asarray(list(words) or [""], dtype=object)
        ranks = np.arange(1, len(words) + 1, dtype=np.float64)
        p = ranks ** -1.07
        self.word_cdf = np.cumsum(p / p.sum()) if len(words) else p
        self.mix = mix
        self.tpw = float(mix["tokens_per_word"])

    # sizes, from the mix's fixed sizes_seed

    def _user(self, rng, reviews: int) -> Dict:
        spec = self.mix["user_text"]
        kept = min(reviews, int(spec["history"]))
        history = lognormal(rng, spec["review_tokens"], kept, self.tpw)
        history = np.maximum(history, 1).tolist()
        if reviews == 0:
            return {"reviews": 0, "cats": [], "price": None, "history": []}
        k = int(min(reviews, rng.integers(1, 4)))
        cats = rng.choice(len(CATEGORIES), k, replace=False).tolist()
        share = rng.dirichlet(np.ones(k)) * 100
        price = (float(lognormal(rng, spec["price"])), float(rng.random() * 20))
        return {"reviews": reviews, "cats": list(zip(cats, share.tolist())),
                "price": price, "history": history}

    def user_sizes(self, rng: np.random.Generator, n: int) -> List[Dict]:
        """n users as a ranking request finds them: every review they wrote
        lies in the past."""
        counts = lognormal(rng, self.mix["user_text"]["reviews_per_user"], n)
        return [self._user(rng, int(c)) for c in counts.tolist()]

    def sample_user_sizes(self, rng: np.random.Generator, n: int,
                          pool: int) -> List[Dict]:
        """n training samples' users: a sample is one review of a user drawn
        from a pool (so a user with more reviews gives more samples), and its
        user text holds the reviews written before it."""
        counts = lognormal(rng, self.mix["user_text"]["reviews_per_user"], pool)
        who = rng.choice(pool, n, p=counts / counts.sum())
        at = (rng.random(n) * counts[who]).astype(np.int64)
        return [self._user(rng, int(i)) for i in at.tolist()]

    def item_sizes(self, rng: np.random.Generator, n: int) -> List[Dict]:
        spec = self.mix["item_text"]
        feats = lognormal(rng, spec["features_tokens"], n, self.tpw).tolist()
        desc = lognormal(rng, spec["description_tokens"], n, self.tpw).tolist()
        priced = rng.random(n) < float(spec["priced_share"])
        prices = lognormal(rng, spec["price"], n).tolist()
        cats = rng.integers(0, len(CATEGORIES), n).tolist()
        cuts = rng.integers(8, 41, size=sum(feats) // 8 + n).tolist()
        out, c = [], 0
        for j in range(n):
            bullets, left = [], int(feats[j])
            while left > 0:
                k = min(left, cuts[c])
                c += 1
                bullets.append(k)
                left -= k
            out.append({"cat": cats[j], "features": bullets,
                        "description": int(desc[j]),
                        "price": float(prices[j]) if priced[j] else None})
        return out

    # texts, their words from the run's seed

    def _words(self, rng, n: int) -> List[str]:
        idx = np.searchsorted(self.word_cdf, rng.random(n))
        return self.words[np.minimum(idx, len(self.words) - 1)].tolist()

    def _sentences(self, rng, n: int) -> str:
        words = self._words(rng, n)
        cuts = rng.integers(6, 19, size=n // 6 + 1).tolist()
        out, pos = [], 0
        for k in cuts:
            if pos >= n:
                break
            s = words[pos:pos + k]
            s[0] = s[0].capitalize()
            out.append(" ".join(s) + ".")
            pos += k
        return " ".join(out)

    def user_text(self, rng, u: Dict) -> str:
        if u["reviews"] == 0:
            return ("Category history: No browsing history. Total reviews: "
                    "No reviews. Avg price: N/A. Price std: No price "
                    "variation. Review history: No review history.")
        cats = "; ".join(f"{CATEGORIES[c]}: {p:.0f}%" for c, p in u["cats"])
        mean, std = u["price"]
        std_s = f"{std:.2f}" if u["reviews"] > 1 else "No price variation"
        parts = [f"Review{i + 1}: {self._sentences(rng, n)}"
                 for i, n in enumerate(u["history"])]
        return (f"Category history: {cats}. Total reviews: {u['reviews']}. "
                f"Avg price: {mean:.2f}. Price std: {std_s}. "
                f"Review history: {_terminated(_smart_join(parts))}")

    def item_text(self, rng, it: Dict) -> str:
        price = f"{it['price']:.2f}" if it["price"] is not None else "N/A"
        bullets = [" ".join(self._words(rng, n)) for n in it["features"]]
        feats = (f"Item features: {_terminated(_smart_join(bullets))}"
                 if bullets else "Item features: No features.")
        desc = (f"Item description: {self._sentences(rng, it['description'])}"
                if it["description"] else "Item description: No description.")
        return (f"Item category: {CATEGORIES[it['cat']]}. Item title: No title. "
                f"Item price: {price}. {feats} {desc}")

    def texts(self, sizes: List[Dict], stream: int) -> List[str]:
        """The texts of these sizes (users' or items'), their words drawn
        from the seed."""
        rng = np.random.default_rng([self.seed % (1 << 63), stream])
        return [self.user_text(rng, s) if "history" in s
                else self.item_text(rng, s) for s in sizes]


def zipf_items(rng: np.random.Generator, pool: int, s: float, size: int
               ) -> np.ndarray:
    ranks = np.arange(1, pool + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -s)
    cdf /= cdf[-1]
    return np.minimum(np.searchsorted(cdf, rng.random(size)), pool - 1)
