"""Shared model building blocks.

Weight-init distributions mirror the reference and the JAX package
(``multimodal_learning_tpu/models/common.py``):
- conv: Kaiming-normal fan_out (``MICCAI-2022/resnets.py:176-178``)
- "max" init Linear: N(0, 1/sqrt(fan_in)), zero bias
  (``MICCAI-2022/utils.py:239-244``)
- torch-default Linear: U(+-1/sqrt(fan_in)) for both kernel and bias
  (used by the ResNet heads, which the reference never re-initialises)

The init functions take an explicit ``torch.Generator``; the JAX package
draws from the same laws with its own keys, so weights agree in law, not in
bits.  Tests carry weights across with ``models/import_flax.py``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F


def _fan_in(w: torch.Tensor) -> int:
    # torch layout: [out, in, *kernel] -> in * prod(kernel)
    return w.shape[1] * math.prod(w.shape[2:])


@torch.no_grad()
def kaiming_normal_out_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """torch kaiming_normal_(mode='fan_out', nonlinearity='relu')."""
    fan_out = w.shape[0] * math.prod(w.shape[2:])
    return w.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)


@torch.no_grad()
def max_init_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """Reference init_max_weights: N(0, 1/sqrt(fan_in))."""
    return w.normal_(0.0, 1.0 / math.sqrt(_fan_in(w)), generator=generator)


@torch.no_grad()
def torch_linear_default_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """torch nn.Linear default kernel: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(_fan_in(w))
    return w.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def torch_linear_bias_(b: torch.Tensor, fan_in: int,
                       generator=None) -> torch.Tensor:
    """torch Linear bias default U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    return b.uniform_(-bound, bound, generator=generator)


def init_linear_(layer: nn.Linear, max_init: bool,
                 generator: Optional[torch.Generator] = None) -> nn.Linear:
    """"max" init (N(0, 1/sqrt(fan_in)), zero bias) or the torch default."""
    if max_init:
        max_init_(layer.weight, generator)
        nn.init.zeros_(layer.bias)
    else:
        torch_linear_default_(layer.weight, generator)
        torch_linear_bias_(layer.bias, layer.in_features, generator)
    return layer


class _FlaxRunningVar:
    """Train-mode running-variance update of flax's BatchNorm.

    torch's BatchNorm folds the *unbiased* batch variance (n/(n-1) times the
    biased one, n the values per channel) into ``running_var``; flax folds
    the *biased* one (``flax.linen.normalization._compute_stats``), and the
    port is held against the JAX package.  Normalisation itself uses the
    biased variance in both.  torch's kernel updates copies of the running
    statistics (autograd saves the tensors it is given, so the buffers
    themselves must not be rewritten after it); its
    ``r' = (1-m) r + m n/(n-1) v`` is then turned into flax's
    ``(1-m) r + m v = r' (n-1)/n + (1-m) r / n`` from the old ``r``, so no
    second pass over the activations is needed.  The state_dict keys are
    torch's."""

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        n, m = x.numel() // x.shape[1], self.momentum
        mean, var = self.running_mean.clone(), self.running_var.clone()
        y = F.batch_norm(x, mean, var, self.weight, self.bias, True, m,
                         self.eps)
        with torch.no_grad():
            self.running_mean.copy_(mean)
            self.running_var.copy_(var * ((n - 1) / n)
                                   + self.running_var * ((1.0 - m) / n))
            self.num_batches_tracked.add_(1)
        return y


class BatchNorm1d(_FlaxRunningVar, nn.BatchNorm1d):
    """``nn.BatchNorm1d`` with flax's running-variance law."""


class BatchNorm2d(_FlaxRunningVar, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's running-variance law."""


def apply_act(act_type: str, hazard: torch.Tensor) -> torch.Tensor:
    """Output activation (reference ``define_act_layer``,
    ``networks_new.py:132-145``), including the survival range-shift
    ``sigmoid(x)*6-3`` (``resnets.py:249-253``, ``networks_new.py:233-237``)."""
    if act_type == "LSM":
        return torch.log_softmax(hazard, dim=-1)
    if act_type == "Sigmoid":
        return torch.sigmoid(hazard) * 6.0 - 3.0
    if act_type == "Tanh":
        return torch.tanh(hazard)
    if act_type == "ReLU":
        return torch.relu(hazard)
    if act_type == "none":
        return hazard
    raise NotImplementedError(f"activation [{act_type}] is not found")


def autocast(x: torch.Tensor, dtype: torch.dtype):
    """Mixed-precision region for the encoders: with ``dtype=bfloat16`` the
    convolutions and Linears inside run in bf16 while parameters and BN
    statistics stay float32, as the JAX modules' ``dtype`` does."""
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)
