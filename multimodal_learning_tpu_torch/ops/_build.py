"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<hash>.so``
at the repository root; the hash covers the source and the flags, so an
edited source is rebuilt and never loaded stale.  A build writes to a
temporary name and renames it into place, so concurrent builders never load
a partial library.  Nothing is built or imported when this module is
imported: the CPU tests import every module of the port.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (home and os.path.join(home, "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source with "
        "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile every named source (default: all of ``csrc/``) that is not
    built yet, one ``nvcc`` each, all started together.  Returns the
    compiler's output per built source (``-Xptxas -v``: registers, shared
    memory, spills).  Raises with the compiler's output on any failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in sources() if names is None else names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc(), *FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        path = library_path(name)
        if not os.path.exists(path):
            build_all([name])
        _loaded[name] = ctypes.CDLL(path)
    return _loaded[name]
