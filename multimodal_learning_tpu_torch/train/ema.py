"""Mean-teacher EMA update, in place.

Port of ``multimodal_learning_tpu/train/ema.py`` (reference
``update_ema_variables``, ``train_test_MT.py:35-39``):
``alpha = min(1 - 1/(step+1), decay)``, ``ema = alpha*ema + (1-alpha)*p``.
Only parameters are averaged: BatchNorm buffers are never EMA'd; the EMA
model's running statistics advance through its own train-mode forwards.
"""
from __future__ import annotations

import torch
from torch import nn


def ema_alpha(decay: float, step: int) -> float:
    return min(1.0 - 1.0 / (step + 1.0), decay)


@torch.no_grad()
def update_ema(model: nn.Module, ema_model: nn.Module, decay: float,
               step: int) -> None:
    a = ema_alpha(decay, step)
    ema = [p for p in ema_model.parameters()]
    new = [p.to(e.dtype) for p, e in zip(model.parameters(), ema)]
    torch._foreach_mul_(ema, a)
    torch._foreach_add_(ema, new, alpha=1.0 - a)
