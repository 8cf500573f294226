"""Train state of the teacher step.

Port of ``multimodal_learning_tpu/train/state.py``.  Where the JAX state is
an immutable pytree that each step replaces, the port's holds modules and
tensors that the step updates in place: the student model, the CRD
projection heads beside it, the optimizer, the EMA model (its own
parameters and BatchNorm buffers, distinct from the student's), the CRD
banks, and the generator that draws the step's augmentation factors and
Kronecker dropout masks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import torch
from torch import nn

from ..contrast.crd import CRDBank
from .optim import ScheduledOptimizer


@dataclass
class TrainState:
    step: int                      # the EMA warm-up counter (host int)
    model: nn.Module
    embeds: nn.ModuleDict          # "crd_fuse_s"/"crd_fuse_t", or empty
    optimizer: ScheduledOptimizer
    ema_model: nn.Module
    generator: torch.Generator     # on the state's device
    banks: Dict[str, CRDBank] = field(default_factory=dict)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device
