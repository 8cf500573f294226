"""The numbers that decide ``correct``, each against its limit.

Train cells (the first steps of the window's own call and feed, against
the plain reference over the same steps):

- ``grad_gap``: over the trained leaves, the largest gap between the norm
  of the first gradient as the optimizer took it and the reference's,
  over the larger of the reference leaf's norm and the median leaf's;
- ``change_gap``: the same for the norm of each leaf's change over the
  steps (the trained leaves, the EMA's and the contrast banks), leaving
  out leaves whose reference gradient (before the L2 decay) is under a
  thousandth of the median leaf's: they move under Adam by round-off
  alone.

The steps' losses are read too (:func:`explain`) but not compared: after
the first step they swing with Adam's sign-like first updates of elements
whose gradient is round-off, on the fp32 reference's side as much as on
the program's, and the first step's loss reads alike in bf16 and in the
fp8 control (PERF.md).

Serve cells: ``logit_gap``, over the sampled chunks' rows, every branch
and class, the largest |hazard - reference| over the scale of the sum
that makes the reference's hazard, |W| |feature| + |b| of the branch's
last layer: a relative error that does not grow where the hazard is
small by cancellation, nor shrink where the logits are small and the
probabilities flat.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np

NOUGHT = 1e-3     # a leaf's reference gradient below this x the median's


class Readings(NamedTuple):
    loss: List[float]
    grad: Dict[str, float]
    change: Dict[str, float]


def _gap(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    names = [k for k in want if keep(k)]
    if not names:
        return math.inf
    floor = float(np.median([want[k] for k in names]))
    worst = 0.0
    for k in names:
        g = got.get(k)
        if g is None or not math.isfinite(g):
            return math.inf
        worst = max(worst, abs(g - want[k]) / max(want[k], floor, 1e-30))
    return worst


def train_numbers(got, want) -> Dict[str, float]:
    raw = getattr(want, "raw", want.grad)
    median = float(np.median(list(raw.values())))

    def moved(k: str) -> bool:
        src = "model." + k[len("ema."):] if k.startswith("ema.") else k
        return src not in raw or raw[src] >= NOUGHT * median

    return {"grad_gap": _gap(got.grad, want.grad, lambda k: True),
            "change_gap": _gap(got.change, want.change, moved)}


def explain(got, want, top: int = 4) -> Dict:
    """Per-step loss gaps and the leaves that read worst, for the
    calibration's printout."""
    def worst(g: Dict[str, float], w: Dict[str, float]):
        floor = float(np.median(list(w.values())))
        rows = sorted(((abs(g.get(k, math.inf) - v) / max(v, floor, 1e-30),
                        k, g.get(k), v) for k, v in w.items()), reverse=True)
        return [[round(r[0], 5), r[1], r[2], r[3]] for r in rows[:top]]
    def median(g: Dict[str, float], w: Dict[str, float]) -> float:
        return float(np.median([abs(g.get(k, math.inf) - v) / max(v, 1e-30)
                                for k, v in w.items()]))
    return {"loss": [[g, w] for g, w in zip(got.loss, want.loss)],
            "loss_gap": max(abs(g - w) / max(abs(w), 1e-30)
                            for g, w in zip(got.loss, want.loss)),
            "grad": worst(got.grad, want.grad),
            "change": worst(got.change, want.change),
            "median_grad": median(got.grad, want.grad),
            "median_change": median(got.change, want.change)}


def serve_numbers(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray]
                  ) -> Dict[str, float]:
    """``want``: the reference's ``hazard_<branch>`` outputs, beside each
    its ``scale_<branch>``; ``got``: the program's.  Every branch of the
    reference is compared: one the program did not return, or returned in
    another shape or not finite, reads as infinite."""
    branches = [k for k in want if k.startswith("hazard_")]
    if not branches:
        return {"logit_gap": math.inf}
    worst = 0.0
    for k in branches:
        w, g, scale = want[k], got.get(k), want["scale_" + k.split("_", 1)[1]]
        if g is None or g.shape != w.shape or not np.isfinite(g).all():
            return {"logit_gap": math.inf}
        worst = max(worst, float((np.abs(g - w) / scale).max()))
    return {"logit_gap": worst}


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit; a number without one is an error."""
    missing = sorted(set(numbers) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
