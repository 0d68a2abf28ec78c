"""Streaming train/eval loaders: shards -> decoded samples -> packed device
batches, with host-side tokenization fully overlapped with device steps.

Replaces the reference's WebDataset + torch DataLoader stack (ref
train.py:41-67, inference_and_auc.py:25-42) and fixes its single biggest
throughput sin: tokenization ran *synchronously inside the training step*
(train.py:236-239, SURVEY §7.8).  Here a background thread packs the next
batches while the device crunches the current one, and `device_prefetch`
keeps `num_prefetch` batches in flight.

Sharding semantics match the reference:
- shard-level split across hosts (== wds.split_by_node, train.py:50), by
  round-robin over sorted shard paths;
- shard shuffle + a sample shuffle buffer (.shuffle(512), train.py:52);
- malformed samples decode to None and are dropped (train.py:54);
- infinite repeat for training (train.py:55), single sequential pass for eval.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/loader.py,
with `device_prefetch` staging torch tensors.
"""
from __future__ import annotations

import queue
import random
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .decode import PATCH_SHAPE, decode_sample
from .packer import TextPacker
from .tar_io import iter_shard


def split_shards(paths: Sequence[str], host_index: int,
                 host_count: int) -> List[str]:
    """wds.split_by_node equivalent: round-robin shard assignment."""
    paths = sorted(paths)
    return [p for i, p in enumerate(paths) if i % host_count == host_index]


def _iter_shard_guarded(path: str, on_error: str):
    """iter_shard with shard-granular containment of DETERMINISTIC
    corruption (bad gzip stream, truncated/garbled tar, torn sidecar).
    Transient I/O errors (plain OSError) always raise: skipping on a
    flaky read would desync the replayed stream and break the
    deterministic-resume invariant that skip_batches fast-forward relies
    on — a retry/restart reproduces the stream, a skip would not.

    On REMOTE shards (gs:// etc. via fsspec) the decode-level exception
    types can ALSO be transient — a truncated network read surfaces as
    EOFError/zlib.error, not OSError — so before skipping, the shard is
    re-opened ONCE and fast-forwarded past the samples already yielded;
    only an error that reproduces is treated as corruption (ADVICE r3).
    A successful retry leaves the emitted stream identical to an
    error-free read, preserving deterministic resume."""
    import gzip
    import sys
    import tarfile
    import zlib
    decode_errors = (tarfile.TarError, EOFError, zlib.error,
                     gzip.BadGzipFile, ValueError)
    remote = "://" in path
    yielded = 0
    retried = False
    it = iter_shard(path)
    while True:
        try:
            item = next(it)
        except StopIteration:
            return
        except decode_errors as e:
            if on_error != "skip":
                raise
            if remote and not retried:
                retried = True
                print(f"[loader] WARNING: read error in remote shard "
                      f"{path!r} after {yielded} samples "
                      f"({type(e).__name__}: {e}); retrying once before "
                      f"declaring corruption", file=sys.stderr, flush=True)
                try:
                    it = iter_shard(path)
                    for _ in range(yielded):
                        next(it)
                    continue
                except (StopIteration, OSError, *decode_errors) as e2:
                    e = e2
            print(f"[loader] WARNING: skipping rest of corrupt shard "
                  f"{path!r}: {type(e).__name__}: {e}",
                  file=sys.stderr, flush=True)
            return
        yielded += 1
        yield item


def iter_decoded(paths: Sequence[str], *, shuffle: bool = False,
                 shuffle_buffer: int = 512, repeat: bool = False,
                 seed: int = 0, shard_shuffle: Optional[bool] = None,
                 on_shard_error: str = "raise") -> Iterator[dict]:
    """Stream decoded samples from tar shards.  `shard_shuffle` (default:
    follow `shuffle`) controls shard-ORDER shuffling separately from the
    sample shuffle buffer (== wds shardshuffle, ref train.py:46).

    `on_shard_error="skip"`: a corrupt/truncated shard is logged loudly
    and skipped instead of killing the run — one bad file must not end a
    multi-epoch training job.  Determinism under resume holds: the same
    corrupt file skips identically on replay.  Default "raise" (metrics
    consumers like eval must not silently shrink their denominator)."""
    rng = random.Random(seed)
    epoch = 0
    if shard_shuffle is None:
        shard_shuffle = shuffle
    while True:
        shard_order = list(paths)
        if shard_shuffle:
            rng.shuffle(shard_order)
        buf: List[dict] = []
        for path in shard_order:
            for raw in _iter_shard_guarded(path, on_shard_error):
                sample = decode_sample(raw)
                if sample is None:
                    continue
                if shuffle:
                    buf.append(sample)
                    if len(buf) >= shuffle_buffer:
                        idx = rng.randrange(len(buf))
                        buf[idx], buf[-1] = buf[-1], buf[idx]
                        yield buf.pop()
                else:
                    yield sample
        while buf:
            idx = rng.randrange(len(buf))
            buf[idx], buf[-1] = buf[-1], buf[idx]
            yield buf.pop()
        epoch += 1
        if not repeat:
            return


def assemble_batch(samples: List[dict], packer: TextPacker,
                   chunk_budget: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Decoded samples -> static-shape numpy batch (model + loss inputs).

    When every sample carries offline-pretokenized sentences at a
    compatible truncation (data/pretokenize.py sidecars), the split +
    WordPiece stages are skipped and only the greedy packing runs —
    bit-identical outputs (tests/test_torch_data_pipeline.py)."""
    b = len(samples)
    need = packer.cfg.max_tok - 3
    vocab = packer.tok.vocab_size
    if all(s.get("sents_max_len", -1) >= need and
           s.get("sents_vocab") == vocab for s in samples):
        user = packer.pack_encoded([s["user_sents"] for s in samples],
                                   chunk_budget)
        item = packer.pack_encoded([s["item_sents"] for s in samples],
                                   chunk_budget)
    else:
        user = packer.pack([s["user_text"] for s in samples], chunk_budget)
        item = packer.pack([s["item_text"] for s in samples], chunk_budget)
    patches = np.stack([s["patch"] for s in samples])
    return {
        "user_tokens": user.tokens, "user_sent_chunk": user.sent_chunk,
        "user_sent_tok": user.sent_tok,
        "item_tokens": item.tokens, "item_sent_chunk": item.sent_chunk,
        "item_sent_tok": item.sent_tok,
        "patches": patches.reshape(b, *PATCH_SHAPE),
        "has_image": np.asarray([s["has_image"] for s in samples], np.int32),
        "label_good": np.asarray([s["label_good"] for s in samples],
                                 np.float32),
        "label_best": np.asarray([s["label_best"] for s in samples],
                                 np.float32),
    }


class BatchLoader:
    """Background-threaded sample->batch pipeline with PARALLEL packing.

    A reader thread groups decoded samples into batch-size lists and submits
    each to a thread pool that runs the pack stage (`num_threads` workers —
    the reference's analogue is up to 32 DataLoader worker processes,
    ref train.py:57-62 / README.md:260).  Futures enter the queue in
    submission order, so the emitted batch stream is DETERMINISTIC
    regardless of thread count — required for checkpoint-resume
    reproducibility.  The native C++ WordPiece tokenizer releases the GIL,
    so pack workers genuinely overlap.

    `partial_batches=False` drops the trailing short batch (training);
    eval sets it True and pads the final batch with repeats + a `valid` mask
    so jit never sees a new shape.
    """

    def __init__(self, sample_iter: Iterator[dict], batch_size: int,
                 packer: TextPacker, *, chunk_budget: Optional[int] = None,
                 num_prefetch: int = 4, partial_batches: bool = False,
                 num_threads: int = 2):
        import concurrent.futures as cf
        self.sample_iter = sample_iter
        self.batch_size = batch_size
        self.packer = packer
        self.chunk_budget = chunk_budget
        self.partial_batches = partial_batches
        self._pool = cf.ThreadPoolExecutor(max_workers=max(num_threads, 1),
                                           thread_name_prefix="pack")
        # queue holds futures; pool workers run ahead while the consumer
        # drains in order
        self._q: "queue.Queue" = queue.Queue(
            maxsize=max(num_prefetch, num_threads, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self):
        try:
            batch_samples: List[dict] = []
            for sample in self.sample_iter:
                if self._stop.is_set():
                    return
                batch_samples.append(sample)
                if len(batch_samples) == self.batch_size:
                    if not self._submit(batch_samples, None):
                        return
                    batch_samples = []
            if batch_samples and self.partial_batches:
                n = len(batch_samples)
                while len(batch_samples) < self.batch_size:
                    batch_samples.append(batch_samples[n - 1])
                self._submit(batch_samples, n)
            self._put(None)
        except BaseException as e:  # surface reader errors to the consumer
            if not self._stop.is_set():
                self._put(e)

    def _put(self, item) -> bool:
        """Queue.put that re-checks the stop flag so close() can't leave the
        reader thread blocked forever on a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _submit(self, samples: List[dict], n_valid: Optional[int]) -> bool:
        if self._stop.is_set():
            return False
        try:
            fut = self._pool.submit(self._pack, samples, n_valid)
        except RuntimeError:     # pool shut down by a concurrent close()
            return False
        return self._put(fut)

    def _pack(self, samples: List[dict], n_valid: Optional[int]):
        batch = assemble_batch(samples, self.packer, self.chunk_budget)
        valid = np.zeros(self.batch_size, bool)
        valid[:n_valid if n_valid is not None else self.batch_size] = True
        batch["valid"] = valid
        return batch

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item.result()

    def close(self):
        self._stop.set()
        # drain so a _put blocked on a full queue wakes and sees _stop; the
        # reader then exits and can be joined (repeated create/close cycles
        # in bench sweeps must not leak blocked daemon threads)
        try:
            while True:
                item = self._q.get_nowait()
                if hasattr(item, "cancel"):
                    item.cancel()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        self._pool.shutdown(wait=False, cancel_futures=True)


def make_train_loader(shard_paths: Sequence[str], batch_size: int,
                      packer: TextPacker, *, host_index: int = 0,
                      host_count: int = 1, shuffle_buffer: int = 512,
                      seed: int = 0, chunk_budget: Optional[int] = None,
                      num_prefetch: int = 4, num_threads: int = 2,
                      skip_batches: int = 0,
                      shard_shuffle: bool = True,
                      on_shard_error: str = "skip") -> BatchLoader:
    """`skip_batches`: deterministic resume fast-forward — the decoded
    sample stream is a pure function of (paths, seed), so skipping
    skip_batches * batch_size samples reproduces the loader position of a
    checkpointed run without re-packing the skipped batches.

    `on_shard_error` defaults to "skip" for TRAINING: one corrupt shard
    logs loudly and is skipped rather than killing a multi-epoch run
    (the eval loader stays strict — a silently shrunk denominator would
    corrupt reported metrics)."""
    paths = split_shards(shard_paths, host_index, host_count)
    it = iter_decoded(paths, shuffle=True, shuffle_buffer=shuffle_buffer,
                      repeat=True, seed=seed, shard_shuffle=shard_shuffle,
                      on_shard_error=on_shard_error)
    if skip_batches:
        import itertools
        it = itertools.islice(it, skip_batches * batch_size, None)
    return BatchLoader(it, batch_size, packer, chunk_budget=chunk_budget,
                       num_prefetch=num_prefetch, num_threads=num_threads)


def make_eval_loader(shard_paths: Sequence[str], batch_size: int,
                     packer: TextPacker, *,
                     chunk_budget: Optional[int] = None,
                     num_prefetch: int = 4,
                     num_threads: int = 2) -> BatchLoader:
    it = iter_decoded(sorted(shard_paths), shuffle=False, repeat=False)
    return BatchLoader(it, batch_size, packer, chunk_budget=chunk_budget,
                       num_prefetch=num_prefetch, partial_batches=True,
                       num_threads=num_threads)


def device_prefetch(batch_iter, n: int = 2, device="cuda"):
    """Keep `n` batches in flight to `device` (host->device pipelining;
    replaces DataLoader worker IPC + .to(device) in the step loop,
    ref train.py:219-231).  Each numpy array is pinned and copied with
    non_blocking=True on a CUDA device, so the copy overlaps the step
    running on the card; on the CPU the arrays become tensors as they are."""
    import collections

    import torch
    device = torch.device(device)

    def put(batch):
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if device.type == "cuda":
                t = t.pin_memory().to(device, non_blocking=True)
            out[k] = t
        return out

    buf = collections.deque()
    it = iter(batch_iter)
    try:
        for _ in range(n):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        out = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield out
