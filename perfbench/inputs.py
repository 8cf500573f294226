"""What a run feeds both sides, made from ``--seed``: seeds, ROIs, omic
vectors, grades and the weights.

Everything is drawn on the device with ``torch.Generator``s seeded from
the run's seed, in a few large calls, and copied to the host where the
program reads it from there (the ROIs, as the pipeline's cache holds them
once a fold's first epoch has decoded them).  The same seed gives the
same bytes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

# the streams a run draws from, each seeded apart from the run's seed
STREAMS = ("rois", "omic", "grades", "weights", "loader", "sampler",
           "augment", "dropout", "teacher", "sample")


def seeds(seed: int) -> Dict[str, int]:
    """One 63-bit seed per stream of :data:`STREAMS`."""
    state = np.random.SeedSequence(int(seed)).generate_state(
        len(STREAMS), dtype=np.uint64)
    return {name: int(s >> np.uint64(1)) for name, s in zip(STREAMS, state)}


def _gen(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def images(seed: int, n: int, size: int, device, chunk: int = 64
           ) -> np.ndarray:
    """``n`` uint8 RGB images [n, size, size, 3] on the host, drawn on
    ``device`` in chunks of ``chunk`` images."""
    out = np.empty((n, size, size, 3), dtype=np.uint8)
    host = torch.from_numpy(out)
    gen = _gen(seed, device)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        block = torch.randint(0, 256, (hi - lo, size, size, 3),
                              generator=gen, device=device,
                              dtype=torch.uint8)
        host[lo:hi].copy_(block)    # straight into the array, one copy
    return out


def tabular(s: Dict[str, int], n: int, omic_dim: int, n_classes: int,
            device) -> Dict[str, np.ndarray]:
    """Omic vectors N(0, 1), grades uniform over the classes, and survival
    times and censoring (which grading never reads), as the split
    pickle's arrays."""
    omic = torch.randn(n, omic_dim, generator=_gen(s["omic"], device),
                       device=device)
    g = torch.randint(0, n_classes, (n,), generator=_gen(s["grades"],
                                                         device),
                      device=device)
    return {"x_omic": omic.cpu().numpy().astype(np.float32),
            "g": g.cpu().numpy().astype(np.int64),
            "e": np.ones(n, dtype=np.float32),
            "t": np.arange(n, dtype=np.float32)}


def _fan_in(shape) -> int:
    return shape[1] * math.prod(shape[2:]) if len(shape) > 1 else shape[0]


def _law(name: str, shape: Tuple[int, ...],
         shapes: Dict[str, Tuple[int, ...]]) -> Tuple[float, float]:
    """(scale, shift) of the standard normal draw for one tensor: kernels
    at their layer's initialisation variance (convolutions Kaiming fan-out,
    linear and bilinear kernels 1/fan-in), biases at 1/(3 fan-in),
    BatchNorm scales near 1 and shifts near 0, running means near 0 and
    running variances spread about 1 (log-normal, taken apart), bank rows
    as the CRD bank's U(+-sqrt(3/D)) variance.

    A transformer's tensors: LayerNorm scales (a 1-D ``weight`` with no
    running statistics beside it) near 1 and its shifts (a 1-D ``bias``
    beside a 1-D ``weight``) near 0, both at 0.1, as BatchNorm's;
    ``pos_embed`` and ``cls_token`` at 0.02 about 0, as timm initialises
    them; LayerScale factors (a 1-D ``gamma``) at 0.1 +- 0.02.  That 0.1
    is assumed: a trained LayerScale sits far above its 1e-5 start, and at
    0.1 each block changes the residual stream measurably, so that a
    comparison of outputs sees every block; at the start value, or at the
    bias law about 0, the blocks all but vanish from the output."""
    prefix, _, leaf = name.rpartition(".")
    is_bn = f"{prefix}.running_mean" in shapes
    if leaf == "num_batches_tracked":
        return 0.0, 0.0
    if leaf == "running_mean":
        return 0.1, 0.0
    if leaf == "running_var":
        return 0.25, 0.0         # exponentiated by make_weights
    if is_bn:
        return (0.1, 1.0) if leaf == "weight" else (0.1, 0.0)
    if leaf in ("pos_embed", "cls_token"):
        return 0.02, 0.0
    sibling = f"{prefix}.weight"
    if len(shape) == 1:
        if leaf == "gamma":
            return 0.02, 0.1
        if leaf == "weight":
            return 0.1, 1.0
        if leaf == "bias" and len(shapes.get(sibling, ())) == 1:
            return 0.1, 0.0
    if leaf.startswith("memory_"):
        return 1.0 / math.sqrt(shape[1]), 0.0
    if len(shape) == 4:
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])), 0.0
    if len(shape) == 3:
        return 1.0 / math.sqrt(3.0 * shape[1]), 0.0
    if len(shape) == 2:
        return 1.0 / math.sqrt(shape[1]), 0.0
    fan = _fan_in(shapes[sibling]) if sibling in shapes else shape[0]
    return 1.0 / math.sqrt(3.0 * fan), 0.0


def make_weights(seed: int, shapes: Dict[str, Tuple[int, ...]], device
                 ) -> Dict[str, torch.Tensor]:
    """Every named tensor of ``shapes`` from one normal draw on
    ``device`` (names sorted), shaped and scaled by :func:`_law`; fp32,
    ``num_batches_tracked`` int64 zeros."""
    names = sorted(shapes)
    total = sum(math.prod(shapes[k]) for k in names)
    z = torch.randn(total, generator=_gen(seed, device), device=device)
    out, lo = {}, 0
    for k in names:
        shape = tuple(shapes[k])
        n = math.prod(shape)
        scale, shift = _law(k, shape, shapes)
        t = z[lo:lo + n].reshape(shape) * scale + shift
        lo += n
        if k.endswith("running_var"):
            t = t.exp()
        if k.endswith("num_batches_tracked"):
            t = torch.zeros(shape, dtype=torch.long, device=device)
        out[k] = t
    return out
