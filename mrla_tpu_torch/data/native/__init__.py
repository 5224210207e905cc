"""ctypes binding of the native C++ JPEG batch loader (``loader.cc``).

The shared library is built at first use, never at import, with ``g++
-O3 -march=native`` against the system libjpeg, into
``mrla_tpu_torch/_build/native-<digest>/`` (the digest covers the source,
the flags and the host's CPU, so a build directory copied to another
machine is not loaded there).  Where it does not build or load (no
libjpeg, no g++), ``available()`` returns False and the loader's callers
decode with PIL; ``build_error()`` keeps the error's text so that a
caller can say why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "loader.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
LINK_FLAGS = ["-ljpeg", "-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _cpu() -> str:
    """The host's CPU as ``-march=native`` sees it: the machine and, on
    Linux, the first processor's model and flags."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f.read().split("\n\n")[0].splitlines()
                     if ln.startswith(("model name", "flags"))]
    except OSError:
        lines = []
    return "\n".join([platform.machine(), *lines])


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_cpu().encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libmrla_loader.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        tmp_lib = Path(tmp) / lib.name
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp_lib), str(SRC), *LINK_FLAGS],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ exited {proc.returncode}:\n"
                               f"{proc.stdout.strip()}")
        os.replace(tmp_lib, lib)  # atomic: concurrent builders agree


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            lib.mrla_decode_batch.restype = ctypes.c_int
            lib.mrla_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_uint64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
            _lib = lib
        except (OSError, RuntimeError) as e:
            _build_error = str(e)
        return _lib


def available() -> bool:
    """Whether the library builds and loads here (built on the first
    call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is not available (None if it is, or before the
    first ``available()``)."""
    _load()
    return _build_error


def decode_batch(paths: list[str], size: int, train: bool, seed: int = 0,
                 num_threads: int = 8) -> np.ndarray:
    """Decode JPEGs into uint8 [N, size, size, 3]; a file that cannot be
    read or decoded leaves a zero-filled slot and a warning.  Raises if the
    library is not available."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_build_error}")
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    ok = lib.mrla_decode_batch(
        c_paths, n, size, 1 if train else 0,
        ctypes.c_uint64(seed & (2 ** 64 - 1)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    if ok != n:
        warnings.warn(f"native loader decoded {ok}/{n} images")
    return out
