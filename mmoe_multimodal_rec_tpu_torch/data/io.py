"""Scheme-aware file IO: local paths use the stdlib, `gs://` / `s3://` etc.
route through fsspec (gcsfs/s3fs if installed).

The reference reads and writes GCS everywhere (meta2gcs.py:73-103 uploads
shards to gs://, data4model.py:272-284 globs + reads gs:// JSONL, train.py
streams webdataset tars via gs URLs).  Giving every loader/ingest/tar entry
point one opener keeps that drop-in: any path or pattern may carry a scheme.

fsspec is import-gated so purely local use never requires it; passing a
remote path without the matching fs backend raises a clear error.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/data/io.py.
"""
from __future__ import annotations

import glob as _glob
import os
import re
from typing import IO, List

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def has_scheme(path: str) -> bool:
    return bool(_SCHEME_RE.match(path))


def _fs_for(path: str):
    try:
        import fsspec
    except ImportError as e:  # pragma: no cover - fsspec is in the image
        raise ImportError(
            f"remote path {path!r} needs fsspec (pip install fsspec"
            " gcsfs/s3fs)") from e
    fs, _ = fsspec.core.url_to_fs(path)
    return fs


def fs_open(path: str, mode: str = "rb") -> IO:
    """open() that also accepts gs://... style URLs."""
    if not has_scheme(path):
        return open(path, mode)
    import fsspec
    return fsspec.open(path, mode).open()


def fs_glob(pattern: str) -> List[str]:
    """glob.glob() that also accepts remote patterns; remote results keep
    their scheme prefix so they round-trip into fs_open."""
    if not has_scheme(pattern):
        return sorted(_glob.glob(pattern))
    scheme = pattern.split("://", 1)[0]
    fs = _fs_for(pattern)
    return sorted(f"{scheme}://{p}" if not has_scheme(p) else p
                  for p in fs.glob(pattern))


def fs_exists(path: str) -> bool:
    if not has_scheme(path):
        return os.path.exists(path)
    return _fs_for(path).exists(path)


def fs_makedirs(path: str) -> None:
    if not has_scheme(path):
        os.makedirs(path, exist_ok=True)
    else:
        _fs_for(path).makedirs(path, exist_ok=True)
