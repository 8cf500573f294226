"""ctypes binding of the native JPEG decoder (``native/datacore``).

The port's counterpart of ``multimodal_learning_tpu/data/native_loader.py``:
it compiles the repository's ``native/datacore/datacore.cpp`` (libjpeg,
OpenMP) with ``g++`` at first use into ``build/native/`` at the repository
root, under a name keyed by a hash of the source and the flags, and decodes
JPEG bytes through it with the interpreter lock released.  Where the
toolchain or libjpeg is missing, ``decode_jpeg`` returns None and the
caller decodes with PIL, as the JAX package does; ``build_error()`` then
says why.  ``decode_crop_batch`` decodes and random-crops a whole batch in
the library's OpenMP loop, as the JAX module's does (the pipeline calls
neither package's).  This is host I/O; no device kernel is involved.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "datacore", "datacore.cpp")
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False
_error: Optional[str] = None


def _library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode())
    return os.path.join(_REPO, "build", "native",
                        f"libdatacore-{digest.hexdigest()[:12]}.so")


def _load() -> Optional[ctypes.CDLL]:
    """The built library with its ctypes signatures, or None (and never
    again tried in this process) when it cannot be built or loaded."""
    global _lib, _failed, _error
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            path = _library_path()
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, _SRC, "-ljpeg", "-o", tmp],
                               check=True, capture_output=True, text=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
        except subprocess.CalledProcessError as exc:
            _failed, _error = True, exc.stderr.strip() or str(exc)
            return None
        except OSError as exc:
            _failed, _error = True, str(exc)
            return None
        lib.dc_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.dc_jpeg_dims.restype = ctypes.c_int
        lib.dc_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8)]
        lib.dc_decode_jpeg.restype = ctypes.c_int
        lib.dc_decode_crop_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long),
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint8)]
        lib.dc_decode_crop_batch.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library could not be built or loaded (g++'s messages), or
    None when it was, or was not yet tried."""
    return _error


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> uint8 [H, W, 3]; None when the decoder is unavailable
    or the bytes do not decode."""
    lib = _load()
    if lib is None:
        return None
    h, w = ctypes.c_int(0), ctypes.c_int(0)
    if lib.dc_jpeg_dims(data, len(data), ctypes.byref(h),
                        ctypes.byref(w)) != 0:
        return None
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.dc_decode_jpeg(
        data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None


def decode_crop_batch(paths: Sequence[str], views: int, crop: int,
                      seeds: Sequence[int]) -> Optional[np.ndarray]:
    """Decode the JPEG files ``paths`` and cut ``views`` random
    ``crop``-square windows of each, the windows drawn by the library's
    xorshift from each file's seed (0 stands for a fixed non-zero seed):
    uint8 [N, views, crop, crop, 3].  None when the library is
    unavailable or a file does not decode or is smaller than the crop."""
    lib = _load()
    if lib is None:
        return None
    blobs: List[bytes] = []
    for p in paths:
        with open(p, "rb") as fh:
            blobs.append(fh.read())
    n = len(blobs)
    out = np.empty((n, views, crop, crop, 3), dtype=np.uint8)
    failures = lib.dc_decode_crop_batch(
        (ctypes.c_char_p * n)(*blobs),
        (ctypes.c_long * n)(*[len(b) for b in blobs]), n, views, crop,
        (ctypes.c_uint64 * n)(*[s & (2 ** 64 - 1) for s in seeds]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if failures == 0 else None
