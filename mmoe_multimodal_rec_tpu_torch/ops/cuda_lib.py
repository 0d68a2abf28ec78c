"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exports a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into `build/lib<name>-<hash>.so` inside this package
(git-ignored), then loaded with ctypes.  The build happens at first use, from
the package's own sources only; the hash covers the source and the flags, so
an edited kernel rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: this module imports on a machine with no CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[Tuple[str, str], Callable[..., int]] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "with the CUDA toolkit at first use")
    return path


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to under the current source/flags."""
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless it is built already.  Raises with
    nvcc's output on failure; the compiler's report (registers, shared
    memory, spills) is kept beside the library as `<lib>.log`."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out.with_name(out.name + ".log").write_text(proc.stdout)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _libs[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes) -> Callable[..., int]:
    """The C function `fn_name` of csrc/<lib_name>.cu, returning an int,
    with its argument types set.  Bound at its first use and kept, so a
    launch takes neither `load`'s lock nor a lookup in the library."""
    fn = _fns.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(load(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[(lib_name, fn_name)] = fn
    return fn
