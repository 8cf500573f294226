"""Parameter freezing.

Port of ``multimodal_learning_tpu/train/freeze.py`` (reference
``dfs_freeze/dfs_unfreeze/print_if_frozen``, ``MICCAI-2022/utils.py:
277-347``).  The JAX package masks the optimizer
(``optax.multi_transform`` with ``set_to_zero``): a frozen leaf gets no
update and no Adam moments.  Here a frozen parameter gets
``requires_grad_(False)`` and is left out of the optimizer, which has the
same effect: no gradient, no moments, no weight decay.

The key rule is the JAX package's: a parameter is frozen when any
component of its name equals one of ``frozen_keys``.  The components are
the port's module names, split at the dots, and they equal the flax path's
for the containers (``path_net``, ``omic_net``, ``fusion``,
``classifier``) and for most layers (``conv1``, ``bn1``, ``fc_new1``,
``linear_h1``...).  They differ where a torch name splits a flax one
differently: the flax ResNet block ``layer1_0`` is ``layer1.0`` here,
MaxNet's ``encoder1`` is ``encoder.0.0``, the fusion's ``unit1/linear_h``
is ``linear_h1``, and a flax BatchNorm ``encoder1_bn`` is ``encoder1.1``.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

from torch import nn

from .optim import ScheduledOptimizer, make_optimizer


def freeze_mask(model: nn.Module, frozen_keys: Sequence[str]
                ) -> Dict[str, bool]:
    """``{parameter name: trainable}``: False where a component of the name
    equals one of ``frozen_keys``."""
    keys = set(frozen_keys)
    return {name: keys.isdisjoint(name.split("."))
            for name, _ in model.named_parameters()}


def masked_optimizer(opt, model: nn.Module, lr_schedule: Callable,
                     frozen_keys: Sequence[str]) -> ScheduledOptimizer:
    """Freeze the parameters of ``model`` named by ``frozen_keys`` and
    return ``make_optimizer`` over the others (reference ``dfs_freeze``
    analogue)."""
    mask = freeze_mask(model, frozen_keys)
    trainable = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            trainable.append(p)
    return make_optimizer(opt, trainable, lr_schedule)


def count_frozen(model: nn.Module, frozen_keys: Sequence[str]) -> int:
    """``print_if_frozen`` analogue: the number of frozen parameter
    values."""
    mask = freeze_mask(model, frozen_keys)
    return sum(p.numel() for name, p in model.named_parameters()
               if not mask[name])
