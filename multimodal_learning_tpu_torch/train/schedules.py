"""Learning-rate schedules, functions of the global step.

Port of ``multimodal_learning_tpu/train/schedules.py`` (reference
``define_scheduler``, ``networks_new.py:111-129``): every policy is a
function of the epoch, ``step // steps_per_epoch``.  ``plateau`` is the
constant base LR, scaled per epoch by ``PlateauTracker`` through
``ScheduledOptimizer.lr_scale``.
"""
from __future__ import annotations

import math


def make_lr_schedule(opt, steps_per_epoch: int):
    """``step -> lr`` for ``opt.lr_policy`` in linear, exp, step, cosine,
    plateau."""
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
        raise NotImplementedError(
            "learning rate policy [onecycle] is not ported yet: ROADMAP A8")
    raise NotImplementedError(
        f"learning rate policy [{opt.lr_policy}] is not implemented")


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
