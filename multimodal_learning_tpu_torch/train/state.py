"""Train state of the teacher and student steps.

Port of ``multimodal_learning_tpu/train/state.py``.  Where the JAX state is
an immutable pytree that each step replaces, the port's holds modules and
tensors that the step updates in place: the student model, the CRD or
HKD heads beside it, the optimizer, the EMA model (its own
parameters and BatchNorm buffers, distinct from the student's), the CRD
or HKD banks, and the generator that draws the step's augmentation factors and
Kronecker dropout masks.  ``banks`` also carries, under the JAX
package's names, the t-SVD teacher's ADMM state (``"tsvd"``,
:class:`TsvdAux`) and the student's momentum-AEKD scale (``"aekd_ema"``,
a tensor); a student state also holds the generator of its frozen
teacher's dropout and Kronecker masks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Union

import torch
from torch import nn

from ..contrast.crd import CRDBank
from ..contrast.hkd import HKDBank
from .optim import ScheduledOptimizer


@dataclass
class TsvdAux:
    """ADMM state of the M3LR t-SVD constraint (JAX ``train/steps.py``
    ``TsvdAux``, reference ``MIA 2022/train_test_tSVD.py:376-431``): the
    recovered low-rank tensors of both modalities [V, B, B], the growing
    penalty weight mu, and the latest tensor nuclear norms, all 0-d or
    larger tensors on the state's device."""
    aux1: torch.Tensor
    aux2: torch.Tensor
    mu: torch.Tensor
    tnn1: torch.Tensor
    tnn2: torch.Tensor


@dataclass
class TrainState:
    step: int                      # the EMA warm-up counter (host int)
    model: nn.Module
    embeds: nn.ModuleDict          # CRD or HKD heads, or empty
    optimizer: ScheduledOptimizer
    ema_model: nn.Module
    generator: torch.Generator     # on the state's device
    banks: Dict[str, Union[CRDBank, HKDBank, TsvdAux, torch.Tensor]] = field(
        default_factory=dict)
    teacher_generator: Optional[torch.Generator] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device
