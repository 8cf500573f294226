"""Learning-rate schedules, functions of the global step.

Port of ``multimodal_learning_tpu/train/schedules.py`` (reference
``define_scheduler``, ``networks_new.py:111-129``): every policy is a
function of the epoch, ``step // steps_per_epoch``, except ``onecycle``,
a function of the step.  ``plateau`` is the constant base LR, scaled per
epoch by ``PlateauTracker`` through ``ScheduledOptimizer.lr_scale``.
"""
from __future__ import annotations

import math

import numpy as np


def make_lr_schedule(opt, steps_per_epoch: int):
    """``step -> lr`` for ``opt.lr_policy`` in linear, exp, step, cosine,
    plateau, onecycle."""
    base = opt.lr

    if opt.lr_policy == "linear":
        # lr_l = 1 - max(0, epoch + epoch_count - niter) / (niter_decay + 1)
        def sched(step):
            epoch = step // steps_per_epoch
            over = max(0, epoch + opt.epoch_count - opt.niter)
            return base * (1.0 - over / float(opt.niter_decay + 1))
        return sched

    if opt.lr_policy == "exp":
        return lambda step: base * 0.1 ** (step // steps_per_epoch)

    if opt.lr_policy == "step":
        return lambda step: base * 0.1 ** (
            step // steps_per_epoch // opt.lr_decay_iters)

    if opt.lr_policy == "cosine":
        return lambda step: base * 0.5 * (1 + math.cos(
            math.pi * (step // steps_per_epoch) / max(opt.niter, 1)))

    if opt.lr_policy == "plateau":
        # ReduceLROnPlateau (factor 0.2, patience 5, threshold 0.01,
        # networks_new.py:122) is metric-driven: the schedule is the base
        # LR and the loop scales it with PlateauTracker
        return lambda step: base

    if opt.lr_policy == "onecycle":
        # torch OneCycleLR(max_lr=1e-3, epochs=total, ...) as the JAX
        # package has it: optax.cosine_onecycle_schedule over all the steps
        return onecycle_schedule(
            (opt.niter + opt.niter_decay) * steps_per_epoch, peak=1e-3)
    raise NotImplementedError(
        f"learning rate policy [{opt.lr_policy}] is not implemented")


def onecycle_schedule(total_steps: int, peak: float):
    """``optax.cosine_onecycle_schedule(total_steps, peak)`` written out,
    with its ``pct_start`` 0.3, ``div_factor`` 25 and ``final_div_factor``
    1e4: cosine from ``peak / 25`` up to ``peak`` over steps
    [0, int(0.3 T)), cosine down to ``peak / 25 / 1e4`` over
    [int(0.3 T), T), that value from T on.  ``opt.lr`` plays no part.
    (``torch.optim.lr_scheduler.OneCycleLR`` puts its boundaries
    elsewhere.)  Each segment is optax's ``end + (start - end) / 2 *
    (cos(pi * pct) + 1)`` in float32, as optax evaluates it, so the
    cancellation near a segment's end rounds alike."""
    if total_steps <= 0:
        raise ValueError("onecycle needs a positive number of steps")
    f32 = np.float32
    bounds = (0, int(0.3 * total_steps), int(total_steps))
    values = np.cumprod([peak / 25.0, 25.0, 1.0 / (25.0 * 1e4)])

    def sched(step):
        for i in (0, 1):
            if bounds[i] <= step < bounds[i + 1]:
                pct = f32((step - bounds[i]) / (bounds[i + 1] - bounds[i]))
                half = f32((values[i] - values[i + 1]) / 2.0)
                return float(f32(values[i + 1]) + half * (
                    np.cos(f32(math.pi) * pct) + f32(1.0)))
        return float(values[2])

    return sched


class PlateauTracker:
    """Host-side ReduceLROnPlateau state (mode='min', factor=0.2,
    threshold=0.01 relative, patience=5), the JAX package's
    ``train/schedules.py:PlateauTracker``."""

    def __init__(self, factor=0.2, patience=5, threshold=0.01):
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0
        self.scale = 1.0

    def step(self, metric: float) -> float:
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return self.scale

    # snapshotted with the train state so --resume keeps the reduced LR
    def state_dict(self) -> dict:
        return {"best": self.best, "bad_epochs": self.bad_epochs,
                "scale": self.scale}

    def load_state_dict(self, d: dict) -> None:
        self.best = d["best"]
        self.bad_epochs = d["bad_epochs"]
        self.scale = d["scale"]
