"""WebDataset-compatible tar shard IO, dependency-free.

Byte-compatible with the reference's shard layout (data4model.py:239-259:
`.tar.gz` shards of 1024 samples, five members per sample named
`{key}.user.json`, `{key}.item.json`, `{key}.patch.bin`, `{key}.misc.json`,
`{key}.label.json`), so real shards produced by the reference pipeline stream
straight into this framework and vice versa.  Implemented on the stdlib
`tarfile` module — the `webdataset` package is not a dependency.

Paths may carry a scheme (`gs://bucket/...`): IO then routes through fsspec
(data/io.py), matching the reference's GCS-resident shards
(meta2gcs.py:73-103, train.py:41-50 gs URLs).

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/tar_io.py.
"""
from __future__ import annotations

import io
import os
import tarfile
import uuid
from typing import Dict, Iterable, Iterator, List, Optional

from .io import fs_makedirs, fs_open

Sample = Dict[str, bytes]  # field name -> raw bytes, plus "__key__" -> str


def _split_member(name: str):
    """'dir/key.field.ext' -> (key, 'field.ext'): split at the FIRST dot of
    the basename (webdataset base_plus_ext convention)."""
    base = os.path.basename(name)
    if "." not in base:
        return base, ""
    key, _, suffix = base.partition(".")
    return key, suffix


def write_shard(path: str, samples: Iterable[Sample],
                compress: Optional[bool] = None) -> int:
    """Write samples to one tar shard. Returns the number of samples."""
    if compress is None:
        compress = path.endswith(".gz")
    mode = "w:gz" if compress else "w"
    n = 0
    with fs_open(path, "wb") as raw, tarfile.open(fileobj=raw,
                                                  mode=mode) as tar:
        for sample in samples:
            key = sample["__key__"]
            for field, payload in sample.items():
                if field == "__key__":
                    continue
                if isinstance(payload, str):
                    payload = payload.encode("utf-8")
                info = tarfile.TarInfo(name=f"{key}.{field}")
                info.size = len(payload)
                tar.addfile(info, io.BytesIO(payload))
            n += 1
    return n


def iter_shard(path: str) -> Iterator[Sample]:
    """Stream samples from a tar shard, grouping members by key.

    Groups consecutive members that share a key (webdataset semantics); a key
    change flushes the current sample.
    """
    mode = "r:gz" if path.endswith(".gz") else "r:"
    with fs_open(path, "rb") as raw, tarfile.open(fileobj=raw,
                                                  mode=mode) as tar:
        current_key: Optional[str] = None
        current: Sample = {}
        for member in tar:
            if not member.isfile():
                continue
            key, suffix = _split_member(member.name)
            if key != current_key:
                if current_key is not None and current:
                    current["__key__"] = current_key
                    yield current
                current_key, current = key, {}
            f = tar.extractfile(member)
            if f is not None:
                current[suffix] = f.read()
        if current_key is not None and current:
            current["__key__"] = current_key
            yield current


class ShardWriter:
    """Auto-sharding writer mirroring WriteWebDataset (data4model.py:239-259):
    `data-{index:06d}-{uuid8}.tar.gz` files of `samples_per_shard` samples."""

    def __init__(self, output_dir: str, samples_per_shard: int = 1024,
                 compress: bool = True, prefix: str = "data"):
        self.output_dir = output_dir
        self.samples_per_shard = samples_per_shard
        self.compress = compress
        self.prefix = prefix
        self._buffer: List[Sample] = []
        self._shard_index = 0
        self.paths: List[str] = []
        fs_makedirs(output_dir)

    def write(self, sample: Sample) -> None:
        self._buffer.append(sample)
        if len(self._buffer) >= self.samples_per_shard:
            self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        suffix = ".tar.gz" if self.compress else ".tar"
        name = (f"{self.prefix}-{self._shard_index:06d}-"
                f"{uuid.uuid4().hex[:8]}{suffix}")
        path = os.path.join(self.output_dir, name)
        write_shard(path, self._buffer, compress=self.compress)
        self.paths.append(path)
        self._shard_index += 1
        self._buffer = []

    def close(self) -> None:
        self._flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
