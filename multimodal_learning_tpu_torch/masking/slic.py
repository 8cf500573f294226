"""SLIC superpixels (host side): the native C++ kernel, bound with ctypes.

Port of ``multimodal_learning_tpu/masking/slic.py`` (reference
``MIA 2023/stage1.../data_loaders_MT_SP.py:28``:
``Slic(num_components=opt.num_superpixels, compactness=10).iterate(img)``).
The repository's ``native/slic/slic.cpp`` (CIELAB distance, OpenMP) is
compiled with ``g++`` at first use into ``build/native/`` at the repository
root, under a name keyed by a hash of the source and the flags, as
``data/native_loader.py`` builds the JPEG decoder; ``native/slic/`` is
never written.

Documented deviation from the JAX module: when the library cannot be built
or loaded, ``slic_segment`` raises with the compiler's output.  The JAX
module falls back to ``_slic_numpy``, which measures colour in RGB, not
CIELAB, and so gives other labels; here that version is a function of its
own that no caller reaches by accident.  This is host work: no device
kernel is involved.
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
_SRC = os.path.join(_REPO, "native", "slic", "slic.cpp")
_FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode())
    return os.path.join(_REPO, "build", "native",
                        f"libslic-{digest.hexdigest()[:12]}.so")


def load_library() -> ctypes.CDLL:
    """The built library with its ctypes signature; builds it when it is
    missing.  Raises ``RuntimeError`` (with the compiler's output) when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            try:
                subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                               capture_output=True, text=True)
            except FileNotFoundError as exc:
                raise RuntimeError(
                    f"cannot build the SLIC library: {exc}") from exc
            except subprocess.CalledProcessError as exc:
                raise RuntimeError(
                    f"g++ failed to build {_SRC}:\n{exc.stderr}") from exc
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as exc:
            raise RuntimeError(f"cannot load {path}: {exc}") from exc
        lib.slic_segment.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        lib.slic_segment.restype = None
        _lib = lib
    return _lib


def _slic_numpy(img: np.ndarray, num_components: int, compactness: float,
                iterations: int) -> np.ndarray:
    """The JAX module's numpy SLIC (RGB distance instead of CIELAB, no
    connectivity pass): not what ``slic_segment`` computes."""
    H, W = img.shape[:2]
    S = max(1.0, np.sqrt(H * W / num_components))
    f = img.astype(np.float32)
    per_row = max(1, int(round(W / S)))
    rows = (num_components + per_row - 1) // per_row
    ks = np.arange(num_components)
    cx = np.minimum(W - 1, ((ks % per_row + 0.5) * W / per_row)).astype(int)
    cy = np.minimum(H - 1, ((ks // per_row + 0.5) * H / rows)).astype(int)
    centers_c = f[cy, cx]                       # [K, 3]
    centers_xy = np.stack([cx, cy], 1).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    inv_s2 = (compactness ** 2) / (S ** 2)
    labels = np.zeros((H, W), np.int32)
    for _ in range(iterations):
        dist = np.full((H, W), np.inf, np.float32)
        for k in range(num_components):
            x0, x1 = max(0, int(centers_xy[k, 0] - 2 * S)), \
                min(W, int(centers_xy[k, 0] + 2 * S) + 1)
            y0, y1 = max(0, int(centers_xy[k, 1] - 2 * S)), \
                min(H, int(centers_xy[k, 1] + 2 * S) + 1)
            dc = ((f[y0:y1, x0:x1] - centers_c[k]) ** 2).sum(-1)
            dxy = ((xx[y0:y1, x0:x1] - centers_xy[k, 0]) ** 2
                   + (yy[y0:y1, x0:x1] - centers_xy[k, 1]) ** 2)
            d = dc + dxy * inv_s2
            m = d < dist[y0:y1, x0:x1]
            dist[y0:y1, x0:x1][m] = d[m]
            labels[y0:y1, x0:x1][m] = k
        for k in range(num_components):
            mask = labels == k
            if mask.any():
                centers_c[k] = f[mask].mean(0)
                centers_xy[k] = [xx[mask].mean(), yy[mask].mean()]
    return labels


def slic_segment(img: np.ndarray, num_components: int = 100,
                 compactness: float = 10.0,
                 iterations: int = 10) -> np.ndarray:
    """img uint8 [H, W, 3] -> int32 labels [H, W] in [0, num_components),
    by the native library (built at first use; raises if it cannot be)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"slic_segment takes uint8 [H, W, 3], got "
                         f"{img.shape}")
    lib = load_library()
    H, W = img.shape[:2]
    labels = np.zeros((H, W), dtype=np.int32)
    lib.slic_segment(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        num_components, compactness, iterations,
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return labels
