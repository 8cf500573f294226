"""Device choice for the port's CLI drivers.

``MML_PLATFORM=cpu`` (the variable the JAX package's CLIs read) runs a
driver on the CPU, where the kernels' plain versions stand in.  Otherwise
the drivers run on CUDA, and raise when there is no CUDA device: they never
fall back to the CPU quietly.
"""
import os

import torch


def select_device() -> torch.device:
    plat = os.environ.get("MML_PLATFORM", "").lower()
    if plat == "cpu":
        return torch.device("cpu")
    if plat not in ("", "cuda", "gpu"):
        raise ValueError(f"MML_PLATFORM={plat!r}: the PyTorch port runs on "
                         "'cuda' (the default) or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set MML_PLATFORM=cpu "
                           "to run on the CPU")
    return torch.device("cuda")
