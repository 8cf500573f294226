"""Optimizer: Adam with the JAX package's law and LR schedule.

Port of ``multimodal_learning_tpu/train/optim.py`` (reference
``define_optimizer``, ``networks_new.py:80-90``).  The JAX chain
``add_decayed_weights(wd) -> scale_by_adam(eps=1e-8) -> lr`` is exactly
``torch.optim.Adam(weight_decay=wd, eps=1e-8)``: L2 decay added to the
gradient before the moments, not decoupled.  The LR is set before each
update from ``lr_schedule(count)``, ``count`` the updates before this one,
as optax counts.
"""
from __future__ import annotations

from typing import Callable, Iterable

import torch


class ScheduledOptimizer:
    """A torch optimizer whose LR follows ``lr_schedule`` of the update
    count.  Parameters without a gradient get a zero one, so the L2 decay
    still moves them, as the JAX chain does."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float]):
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.count = 0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = float(self.lr_schedule(self.count))
        for group in self.optimizer.param_groups:
            group["lr"] = lr
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.count += 1


def make_optimizer(opt, params: Iterable[torch.nn.Parameter],
                   lr_schedule: Callable[[int], float]) -> ScheduledOptimizer:
    if opt.optimizer_type == "adam":
        return ScheduledOptimizer(torch.optim.Adam(
            params, lr=float(lr_schedule(0)), betas=(opt.beta1, opt.beta2),
            eps=1e-8, weight_decay=opt.weight_decay), lr_schedule)
    if opt.optimizer_type in ("adabound", "adagrad"):
        raise NotImplementedError(
            f"optimizer [{opt.optimizer_type}] is not ported yet: ROADMAP A8")
    raise NotImplementedError(
        f"optimizer [{opt.optimizer_type}] is not implemented")
