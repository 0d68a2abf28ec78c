"""Ranking traffic: requests of one user and `pairs_per_request` candidate
items, each pair submitted to the program's `MicroBatcher`, which packs
them on the host and scores them through the `Predictor` in one bucket.

Set-up draws a vocab, the requests (a user uniform over the pool, items by
Zipf popularity) and their texts and images from the seed, writes the vocab for the program's tokenizer, builds the Predictor
on the seeded weights and warms up its bucket.  Then `clients` threads,
each with one request outstanding, submit the next request of the drawn
list as soon as their last one has returned (a closed loop).  After
`lead_in_s` the window opens at a device batch's completion and closes at
the first completion `seconds` later; the rate is every pair returned in
between over the window's length.

Once the window has closed and the Predictor is freed, a seeded sample of
the device batches that completed in it is judged: the plain reference
packs the batch's texts again (the program's packer must have been called
once a side, and the token and sentence arrays must be equal to the
program's, element for element) and scores each pair in fp32
(the largest gap of a probability, good or best, is compared).
"""
from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List

import numpy as np

from ..bench import Run, free_device, now
from ..reference.text import WordPiece, pack
from ..reference.train import rank_probs
from ..spans import Spans
from ..textgen import TextMaker, make_vocab, zipf_items
from ..trace import Trace
from ..weights import make_weights


class Traffic:
    """The requests of one run, all drawn in set-up.  Every seed gets the
    same sizes: the items' sizes and a cycle of `size_cycle` users' sizes
    come from the mix's fixed `sizes_seed` (each cycle of requests takes
    the cycle's users in an order drawn from the run's seed); the seed draws
    the words, the users, the items each request ranks and their images."""

    def __init__(self, seed: int, mix: Dict):
        rng = np.random.default_rng([seed % (1 << 63), 11])
        sizes = np.random.default_rng([int(mix["sizes_seed"]), 11])
        self.vocab, words = make_vocab(rng, int(mix["vocab_size"]))
        self.maker = TextMaker(seed, words, mix)
        n, k = int(mix["requests"]), int(mix["pairs_per_request"])
        cycle = int(mix["size_cycle"])
        histories = self.maker.user_sizes(sizes, cycle)
        item_sizes = self.maker.item_sizes(sizes, int(mix["items"]))
        self.users = rng.choice(int(mix["users"]), n, replace=False)
        order = np.concatenate([rng.permutation(cycle)
                                for _ in range(-(-n // cycle))])[:n]
        self.items = zipf_items(rng, int(mix["items"]), float(mix["item_zipf"]),
                                n * k).reshape(n, k)
        self.has_image = rng.random(int(mix["items"])) < float(mix["image_share"])
        pool = int(mix["patch_pool"])
        self.patches = rng.integers(0, 256, (pool, 196, 768), dtype=np.uint8)
        self.user_text = dict(zip(self.users.tolist(), self.maker.texts(
            [histories[j] for j in order], 1)))
        ids = np.unique(self.items).tolist()
        self.item_text = dict(zip(ids, self.maker.texts(
            [item_sizes[i] for i in ids], 2)))
        self.user_of = {t: u for u, t in self.user_text.items()}
        self.item_of = {t: i for i, t in self.item_text.items()}

    def patch(self, item: int):
        return self.patches[item % len(self.patches)]

    def instances(self, r: int) -> List[dict]:
        u = self.user_text[int(self.users[r])]
        return [{"user_text": u, "item_text": self.item_text[int(i)],
                 "patch": self.patch(int(i)) if self.has_image[i] else None}
                for i in self.items[r]]


class Recorder:
    """The Predictor's calls, timed and kept for the judgement."""

    def __init__(self, spans: Spans, predictor):
        self.spans = spans
        self.batches: List[dict] = []
        self._packs: List = []
        self.cond = threading.Condition()
        pack_fn, predict_fn = predictor.packer.pack, predictor.predict

        self._pack_s = self._forward_s = 0.0

        def packed(*a, **k):
            t = time.perf_counter()
            with spans.span("pb.pack"):
                out = pack_fn(*a, **k)
            self._pack_s += time.perf_counter() - t
            self._packs.append(out)
            return out

        def predict(users, items, patches=None, has_image=None):
            self._packs = []
            self._pack_s = self._forward_s = 0.0
            with spans.span("pb.predict"):
                out = predict_fn(users, items, patches, has_image)
            with self.cond:
                self.batches.append({"t": time.perf_counter(), "n": len(users),
                                     "users": list(users), "items": list(items),
                                     "packs": self._packs, "out": out,
                                     "pack_s": self._pack_s,
                                     "forward_s": self._forward_s})
                self.cond.notify_all()
            return out

        predictor.packer.pack = packed
        predictor.predict = predict
        if hasattr(predictor, "_forward"):
            forward_fn = predictor._forward

            def forward(*a, **k):
                t = time.perf_counter()
                with spans.span("pb.forward"):
                    out = forward_fn(*a, **k)
                self._forward_s += time.perf_counter() - t
                return out
            predictor._forward = forward

    def next_completion(self, after: float, timeout: float = 120.0) -> float:
        """The time of the first batch completion later than `after`."""
        end = time.perf_counter() + timeout
        with self.cond:
            while True:
                for b in self.batches:
                    if b["t"] > after:
                        return b["t"]
                left = end - time.perf_counter()
                if left <= 0:
                    raise RuntimeError("no device batch completed")
                self.cond.wait(left)


def _closed(cell, r: Run, traffic: Traffic, batcher, rec: Recorder):
    mix = cell.mix
    stop = threading.Event()
    nxt = [0]
    lock = threading.Lock()
    errors = []

    def client():
        while not stop.is_set():
            with lock:
                i = nxt[0] % len(traffic.users)
                nxt[0] += 1
            pend = [batcher.submit(x) for x in traffic.instances(i)]
            for p in pend:
                p.event.wait()
                if p.error:
                    errors.append(p.error)

    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(int(mix["clients"]))]
    for t in threads:
        t.start()
    time.sleep(float(mix["lead_in_s"]))
    if cell.trace:
        r.trace = Trace()
        r.trace.start()
    t0 = rec.next_completion(time.perf_counter())
    r.setup_s = t0 - cell.t_start
    if cell.trace:
        span = min(float(mix["trace_seconds"]), cell.seconds)
        time.sleep(max(0.0, t0 + span - time.perf_counter()))
        r.traced_window = (t0, rec.next_completion(t0 + span))
        r.trace.stop(r.spans)
        r.notes.append(f"trace read in {r.trace.read_s:.1f} s")
    time.sleep(max(0.0, t0 + cell.seconds - time.perf_counter()))
    t1 = rec.next_completion(t0 + cell.seconds)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    inside = [b for b in rec.batches if t0 < b["t"] <= t1]
    r.notes.append("window batch ends (s): "
                   + " ".join(f"{b['t'] - t0:.3f}" for b in inside))
    r.window_s = t1 - t0
    r.work = sum(b["n"] for b in inside)
    r.attempted = nxt[0]
    r.failed = len(errors)
    return inside, (t0, t1)


def judge(cell, r: Run, traffic: Traffic, vocab_path: str, batches: List[dict]):
    """The seeded sample of `batches` against the plain reference."""
    port, mix = cell.port, cell.mix
    rng = np.random.default_rng([cell.seed % (1 << 63), 13])
    k = min(int(mix["check_batches"]), len(batches))
    if k == 0:
        r.correct = False
        r.notes.append("no device batch completed in the window")
        return
    pick = sorted(rng.choice(len(batches), size=k, replace=False))
    with open(vocab_path) as f:
        tok = WordPiece(f.read().split("\n")[:-1])
    bucket = int(mix["bucket"])
    budget = bucket * int(mix["chunks_per_sample"])
    max_tok = int(port["model.packer.max_tok"])
    max_chunks = int(port["model.packer.max_chunks_per_sample"])
    s = int(port["model.packer.fixed_sent_count"])
    weights = make_weights(port, cell.seed, cell.device)
    mismatch, gap, pairs = 0, 0.0, 0
    for j in pick:
        b = batches[j]
        n = b["n"]
        users = [traffic.user_of[t] for t in b["users"]]
        items = [traffic.item_of[t] for t in b["items"]]
        sides = {}
        for side, texts in (("user", [traffic.user_text[u] for u in users]),
                            ("item", [traffic.item_text[i] for i in items])):
            texts = texts + [""] * (bucket - n)
            sides[side] = pack(tok, texts, budget, max_tok, max_chunks, s)
        if len(b["packs"]) != len(sides):
            # a side the program did not pack through its packer (or packed
            # twice) has nothing to compare: it counts as all wrong
            r.notes.append(f"a judged batch made {len(b['packs'])} packer "
                           f"calls, not {len(sides)}")
            mismatch = float("inf")
        for (side, ref), got in zip(sides.items(), b["packs"]):
            for a, g in zip(ref, (got.tokens, got.sent_chunk, got.sent_tok)):
                if a.shape != g.shape:
                    mismatch += a.size
                else:
                    mismatch += int((a != g).sum())
        batch = {}
        for side, (t, sc, st) in sides.items():
            batch[f"{side}_tokens"], batch[f"{side}_sent_chunk"], \
                batch[f"{side}_sent_tok"] = t, sc, st
        img = np.asarray([traffic.has_image[i] for i in items] + [False] * (bucket - n))
        batch["has_image"] = img.astype(np.int32)
        batch["patches"] = np.stack(
            [traffic.patch(i) if traffic.has_image[i] else
             np.zeros((196, 768), np.uint8) for i in items]
            + [np.zeros((196, 768), np.uint8)] * (bucket - n))
        want = rank_probs(port, weights, batch, cell.device, cell.precision)[:n]
        got = np.stack([np.asarray(b["out"]["prob_good"], np.float64),
                        np.asarray(b["out"]["prob_best"], np.float64)], 1)
        if got.shape != want.shape:
            gap = float("inf")
        else:
            gap = max(gap, float(np.abs(got - want).max()))
        pairs += n
    r.notes.append(f"judged {k} device batches, {pairs} pairs")
    lim = cell.limits
    ok = [r.judge("pack_mismatch", mismatch, lim["pack_mismatch"]),
          r.judge("prob_gap", gap, lim["prob_gap"])]
    r.correct = all(ok) and r.failed == 0


def run(cell) -> Run:
    import torch
    from mmoe_multimodal_rec_tpu_torch.eval.predict import Predictor
    from mmoe_multimodal_rec_tpu_torch.eval.server import MicroBatcher
    r = Run(cell)
    spans = r.spans = Spans()
    mix = cell.mix
    tmp = tempfile.mkdtemp(prefix="portbench-")
    try:
        with spans.span("pb.traffic"):
            traffic = Traffic(cell.seed, mix)
            vocab_path = os.path.join(tmp, "vocab.txt")
            with open(vocab_path, "w") as f:
                f.write("\n".join(traffic.vocab) + "\n")
        cfg = cell.program_config()
        cfg.data.vocab_path = vocab_path
        with spans.span("pb.init"):
            weights = make_weights(cell.port, cell.seed, cell.device)
            predictor = Predictor(cfg, state=weights, device=cell.device)
            del weights
        if cell.fault is not None:     # a planted fault, below the recorder
            cell.fault(predictor)
        rec = Recorder(spans, predictor)
        with spans.span("pb.warmup"):
            predictor.warmup()
            first = [x for i in range(len(traffic.users))
                     for x in traffic.instances(i)][:int(mix["bucket"])]
            predictor.predict([x["user_text"] for x in first],
                              [x["item_text"] for x in first])
            rec.batches.clear()
        if cell.trace:
            Trace.warm()
        batcher = MicroBatcher(predictor, float(mix["max_wait_ms"]))
        try:
            inside, (t0, t1) = _closed(cell, r, traffic, batcher, rec)
        finally:
            batcher.close()
        r.window = (t0, t1)
        r.batches = inside
        r.traced = []
        a, b_ = getattr(r, "traced_window", (t0, t1))
        r.traced_s = b_ - a
        traced = [x for x in inside if a < x["t"] <= b_] if cell.trace else []
        if any(len(b["packs"]) != 2 for b in traced):
            traced = []     # inputs the readers cannot see: nothing to count
        for b in traced:
            r.traced.append({"user_tokens": b["packs"][0].tokens,
                             "item_tokens": b["packs"][1].tokens,
                             "user_sent_chunk": b["packs"][0].sent_chunk,
                             "user_sent_tok": b["packs"][0].sent_tok,
                             "item_sent_chunk": b["packs"][1].sent_chunk,
                             "item_sent_tok": b["packs"][1].sent_tok,
                             "has_image": np.asarray(
                                 [traffic.has_image[traffic.item_of[t]]
                                  for t in b["items"]], np.int32)})
            r.traced_real.append(b["n"])
        if cell.device != "cpu":
            r.memory_peak_bytes = torch.cuda.max_memory_allocated()
        del predictor, batcher
        rec = None
        free_device()
        t = now()
        judge(cell, r, traffic, vocab_path, inside)
        r.notes.append(f"judged in {now() - t:.1f} s; set-up spans (s): "
                       + ", ".join(f"{k} {sum(b - a for a, b in v):.2f}"
                                   for k, v in spans.times.items()
                                   if k in ("pb.traffic", "pb.init", "pb.warmup")))
        free_device()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return r
