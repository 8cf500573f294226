"""ctypes binding of the native JPEG decoder (``native/datacore``).

The port's counterpart of ``multimodal_learning_tpu/data/native_loader.py``:
it compiles the repository's ``native/datacore/datacore.cpp`` (libjpeg,
OpenMP) with ``g++`` at first use into ``build/native/`` at the repository
root, under a name keyed by a hash of the source and the flags, and decodes
JPEG bytes through it with the interpreter lock released.  Where the
toolchain or libjpeg is missing, ``decode_jpeg`` returns None and the
caller decodes with PIL, as the JAX package does.  This is host I/O; no
device kernel is involved.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "datacore", "datacore.cpp")
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode())
    return os.path.join(_REPO, "build", "native",
                        f"libdatacore-{digest.hexdigest()[:12]}.so")


def _load() -> Optional[ctypes.CDLL]:
    """The built library with its ctypes signatures, or None (and never
    again tried in this process) when it cannot be built or loaded."""
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            path = _library_path()
            if not os.path.exists(path):
                os.makedirs(os.path.dirname(path), exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, _SRC, "-ljpeg", "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, path)
            lib = ctypes.CDLL(path)
        except (OSError, subprocess.CalledProcessError):
            _failed = True
            return None
        lib.dc_jpeg_dims.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.dc_jpeg_dims.restype = ctypes.c_int
        lib.dc_decode_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_uint8)]
        lib.dc_decode_jpeg.restype = ctypes.c_int
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


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
