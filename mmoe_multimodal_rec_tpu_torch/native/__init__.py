"""Native (C++) host-path accelerators, consumed via ctypes.

`build_native()` compiles `wordpiece.cpp` with g++ (plain C ABI, no
pybind11) into the package's git-ignored `build/libwordpiece.so`, beside
the CUDA kernels (ops/cuda_lib.py), never into the source directory.  It
builds at first use, and again when the source is newer than the library.
The compiler writes to a temporary name that is then renamed, so processes
building at once never load a torn library.  A failed build returns None
and prints the compiler's output to stderr once a process; the callers
then take the pure-Python tokenizer (data/native_tokenizer.py), which gives
the same ids.

The PyTorch port's own copy of mmoe_multimodal_rec_tpu/native/, built into
build/ rather than beside the source.
"""
from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "wordpiece.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
LIBRARY = os.path.join(BUILD_DIR, "libwordpiece.so")
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_reported = False


def _report(text: str) -> None:
    global _reported
    if not _reported:
        _reported = True
        print(f"[native] building {SOURCE} failed; the pure-Python "
              f"WordPiece tokenizer takes its place:\n{text}",
              file=sys.stderr, flush=True)


def build_native(force: bool = False) -> Optional[str]:
    """Compile build/libwordpiece.so if it is missing or older than its
    source.  Returns its path, or None when the build failed."""
    with _lock:
        if os.path.exists(LIBRARY) and not force and \
                os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE):
            return LIBRARY
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, SOURCE],
                                  capture_output=True, text=True,
                                  timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            _report(f"{type(e).__name__}: {e}")
            return None
        if proc.returncode != 0:
            _report(proc.stderr or proc.stdout)
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
        os.replace(tmp, LIBRARY)
        return LIBRARY


def native_library_path() -> Optional[str]:
    """The built library's path (building it first if needed), or None."""
    return build_native()
