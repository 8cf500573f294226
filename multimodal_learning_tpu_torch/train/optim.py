"""Optimizers with the JAX package's laws and LR schedule.

Port of ``multimodal_learning_tpu/train/optim.py`` (reference
``define_optimizer``, ``networks_new.py:80-90``):

- ``adam``: the JAX chain ``add_decayed_weights(wd) -> scale_by_adam(eps=
  1e-8) -> lr`` is exactly ``torch.optim.Adam(weight_decay=wd, eps=1e-8)``:
  L2 decay added to the gradient before the moments, not decoupled.
- ``adagrad``: ``add_decayed_weights(wd) -> scale_by_rss(0.1, eps=1e-10)
  -> lr`` as ``torch.optim.Adagrad(weight_decay=wd,
  initial_accumulator_value=0.1, eps=1e-10)``.  optax scales by
  ``rsqrt(sum + eps)``, torch by ``1 / (sqrt(sum) + eps)``; with every sum
  at least 0.1 the two agree to fp32 rounding.  The port uses torch's.
- ``adabound``: :class:`AdaBound`, the JAX package's reconstruction of
  AdaBound (Luo et al., ICLR 2019; the reference's module is absent), with
  the betas (0.9, 0.999), gamma 1e-3 and no weight decay whatever
  ``--weight_decay`` says, as the reference passes only lr and final_lr.

The LR is set before each update from ``lr_schedule``: for Adam and
Adagrad at ``count``, the updates before this one, as optax counts; for
AdaBound at ``count + 1``, as ``scale_by_adabound`` increments its count
first.  ``--lr_policy plateau`` multiplies that LR by ``lr_scale``, which
the train loop sets from ``schedules.PlateauTracker`` after each epoch's
eval, as the JAX chain's trailing ``scale(lr_scale)`` does.  No update
reads a value back from the device.
"""
from __future__ import annotations

from typing import Callable, Iterable

import numpy as np
import torch

from ..parallel.mesh import active, average_grads


class AdaBound(torch.optim.Optimizer):
    """AdaBound with the JAX package's law (``scale_by_adabound``):

      step  = clip(lr_t·√(1−b2ᵗ)/(1−b1ᵗ) / (√v + eps), lo_t, hi_t) · m
      lo_t  = final_lr·(lr_t/lr_0)·(1 − 1/(γ·t + 1))
      hi_t  = final_lr·(lr_t/lr_0)·(1 + 1/(γ·t))

    with ``t`` the 1-based update count, ``lr_t`` the group's ``lr`` and
    ``lr_0 = base_lr``.  The scalars are computed in float32 on the host,
    as JAX computes them on the device.  A plateau scale folded into
    ``lr_t`` scales the step size and both bounds alike, hence the whole
    update, as the JAX chain's ``scale(lr_scale)`` after it."""

    def __init__(self, params, lr: float, base_lr: float,
                 final_lr: float = 0.1, betas=(0.9, 0.999),
                 eps: float = 1e-8, gamma: float = 1e-3):
        super().__init__(params, dict(lr=lr, base_lr=base_lr,
                                      final_lr=final_lr, betas=betas,
                                      eps=eps, gamma=gamma))

    @torch.no_grad()
    def step(self, closure=None):
        f32 = np.float32
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr_t, eps = f32(group["lr"]), group["eps"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = f32(st["step"])
                m, v, g = st["exp_avg"], st["exp_avg_sq"], p.grad
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                step_size = lr_t * np.sqrt(1 - f32(b2) ** t) / (
                    1 - f32(b1) ** t)
                flr = f32(group["final_lr"]) * lr_t / f32(group["base_lr"])
                gamma = f32(group["gamma"])
                lo = flr * (1 - 1 / (gamma * t + 1))
                hi = flr * (1 + 1 / (gamma * t))
                per_el = torch.full_like(v, float(step_size)).div_(
                    v.sqrt().add_(eps)).clamp_(float(lo), float(hi))
                p.sub_(per_el.mul_(m))


class ScheduledOptimizer:
    """A torch optimizer whose LR follows ``lr_schedule`` of the update
    count (plus ``count_offset``), times ``lr_scale`` (the plateau scale, 1
    otherwise).  Parameters without a gradient get a zero one, so the L2
    decay and the moments still move them, as the JAX chain does.  Under a
    data group the gradients are averaged over the ranks first
    (``parallel.average_grads``), so every rank takes the same update."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 lr_schedule: Callable[[int], float], count_offset: int = 0):
        self.optimizer = optimizer
        self.lr_schedule = lr_schedule
        self.count_offset = count_offset
        self.count = 0
        self.lr_scale = 1.0

    def zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)

    def step(self) -> None:
        lr = float(self.lr_schedule(self.count + self.count_offset)) \
            * self.lr_scale
        params = [p for group in self.optimizer.param_groups
                  for p in group["params"]]
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if active() is not None:
            average_grads(params)
        self.optimizer.step()
        self.count += 1


def make_optimizer(opt, params: Iterable[torch.nn.Parameter],
                   lr_schedule: Callable[[int], float]) -> ScheduledOptimizer:
    lr0 = float(lr_schedule(0))
    if opt.optimizer_type == "adam":
        return ScheduledOptimizer(torch.optim.Adam(
            params, lr=lr0, betas=(opt.beta1, opt.beta2),
            eps=1e-8, weight_decay=opt.weight_decay), lr_schedule)
    if opt.optimizer_type == "adabound":
        return ScheduledOptimizer(AdaBound(
            params, lr=lr0, base_lr=lr0, final_lr=opt.final_lr),
            lr_schedule, count_offset=1)
    if opt.optimizer_type == "adagrad":
        return ScheduledOptimizer(torch.optim.Adagrad(
            params, lr=lr0, weight_decay=opt.weight_decay,
            initial_accumulator_value=0.1, eps=1e-10), lr_schedule)
    raise NotImplementedError(
        f"optimizer [{opt.optimizer_type}] is not implemented")
