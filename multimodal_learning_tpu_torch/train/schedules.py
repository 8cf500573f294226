"""Learning-rate schedules, functions of the global step.

Port of ``multimodal_learning_tpu/train/schedules.py`` (reference
``define_scheduler``, ``networks_new.py:111-129``): every policy is a
function of the epoch, ``step // steps_per_epoch``.
"""
from __future__ import annotations

import math


def make_lr_schedule(opt, steps_per_epoch: int):
    """``step -> lr`` for ``opt.lr_policy`` in linear, exp, step, cosine."""
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

    if opt.lr_policy in ("onecycle", "plateau"):
        raise NotImplementedError(
            f"learning rate policy [{opt.lr_policy}] is not ported yet: "
            "ROADMAP A8 (the plateau tracker comes with the loop, A10)")
    raise NotImplementedError(
        f"learning rate policy [{opt.lr_policy}] is not implemented")
