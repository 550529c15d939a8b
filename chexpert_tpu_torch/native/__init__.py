"""Native (C++ / libjpeg) JPEG decode of the input pipeline, port of
chexpert_tpu/native/__init__.py.

``decode_gray(path, min_edge_hint)`` -> uint8 (H, W), or None when the
native library is unavailable (no compiler, no libjpeg): callers then decode
with PIL. The library is built at first use, not at import:

    g++ -O3 -shared -fPIC -o chexpert_tpu_torch/_build/decode-<hash>.so \\
        chexpert_tpu_torch/native/decode.cc -ljpeg

into the package's git-ignored build directory, named by a hash of the
source and the command, so an edited source rebuilds. It needs ``g++`` (or
``cc`` / ``gcc``) and libjpeg's ``jpeglib.h``. This is host code: it
decodes on the CPU for the input pipeline.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "decode.cc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CFLAGS = ("-O3", "-shared", "-fPIC")
COMPILERS = ("g++", "cc", "gcc")
_MAX_BUF = 256 * 1024 * 1024

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
_tls = threading.local()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"decode-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    for cc in COMPILERS:
        try:
            r = subprocess.run([cc, *CFLAGS, "-o", str(tmp), str(SOURCE), "-ljpeg"],
                               capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            continue
        if r.returncode == 0:
            os.replace(tmp, out)
            return True
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        path = library_path()
        try:
            if not path.exists() and not _build(path):
                _failed = True
                return None
            lib = ctypes.CDLL(str(path))
        except OSError:
            _failed = True
            return None
        lib.decode_jpeg_gray.restype = ctypes.c_int
        lib.decode_jpeg_gray.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native decoder is built (building it if it can be)."""
    return _load() is not None


def decode_gray(path: str, min_edge_hint: int = 0) -> Optional[np.ndarray]:
    """Decode a JPEG to uint8 (H, W) grayscale; None if the native library
    is unavailable. ``min_edge_hint`` > 0 allows libjpeg's DCT-domain
    downscale by 1/2, 1/4 or 1/8, never below the hint on the shorter edge.
    Raises ValueError if libjpeg refuses the file."""
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        buf = f.read()
    out = getattr(_tls, "buf", None)  # a reusable output buffer per thread
    if out is None:
        out = _tls.buf = np.empty((4 * 1024 * 1024,), np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    while True:
        rc = lib.decode_jpeg_gray(buf, len(buf), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                                  out.size, ctypes.byref(w), ctypes.byref(h), int(min_edge_hint))
        if rc == 2 and out.size < _MAX_BUF:  # the buffer is too small: grow it
            out = _tls.buf = np.empty((out.size * 4,), np.uint8)
            continue
        break
    if rc != 0:
        raise ValueError(f"native JPEG decode failed (rc={rc}) for {path}")
    return out[:w.value * h.value].reshape(h.value, w.value).copy()
