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
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..parallel.mesh import GlobalBatchNorm, active


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
    torch's.

    Under a data group (``parallel.active()``) train mode normalises by
    the global batch's statistics (``parallel.GlobalBatchNorm``) and folds
    them, with n the global count, into the running statistics by the same
    law."""

    def forward(self, x):
        dp = active()
        if dp is not None and self.training:
            return self._global_forward(x, dp)
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

    def _global_forward(self, x, dp):
        self._check_input_dim(x)
        ones = torch.ones(x.shape[1], device=x.device)
        weight = self.weight if self.weight is not None else ones
        bias = self.bias if self.bias is not None else 0.0 * ones
        y, mean, var = GlobalBatchNorm.apply(x, weight, bias, self.eps, dp)
        if self.track_running_stats:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(var, alpha=m)
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


INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
KEEP_INIT = ("max", "none", "normal_default")


def reinit_generator(seed: int) -> torch.Generator:
    """The re-initialisation's own CPU stream, apart from the one the
    model, the CRD heads and the banks draw from (the JAX package splits
    ``k_reinit`` off its init key, ``train/steps.py:150``)."""
    entropy = np.random.SeedSequence((seed, 1)).generate_state(1)[0]
    return torch.Generator().manual_seed(int(entropy))


def _fans(shape):
    """flax ``variance_scaling`` fans: ``in_axis=-2``, ``out_axis=-1``, the
    other axes the receptive field.  On the bilinear ``linear_z`` kernel
    [out, in1, in2] that is fan_in = out*in1, fan_out = out*in2, unlike
    torch's own ``nn.init`` law on the same tensor."""
    rf = math.prod(shape) // (shape[-2] * shape[-1])
    return shape[-2] * rf, shape[-1] * rf


def _truncated_normal(shape, gen) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] (``jax.random.truncated_normal``)
    by the inverse CDF, in float64."""
    lo, hi = (0.5 * (1 + math.erf(v / math.sqrt(2))) for v in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64)
    return math.sqrt(2) * torch.special.erfinv(2 * u - 1)


def _orthogonal(shape, gen) -> torch.Tensor:
    """``jax.nn.initializers.orthogonal(column_axis=-1)``: the kernel as
    [prod(shape[:-1]), shape[-1]] with orthonormal columns (rows when it is
    wide), from the sign-fixed QR of a normal draw, in float64."""
    n_cols = shape[-1]
    n_rows = math.prod(shape) // n_cols
    a = torch.randn((max(n_rows, n_cols), min(n_rows, n_cols)),
                    generator=gen, dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    if n_rows < n_cols:
        q = q.T
    return q.reshape(shape)


def _draw_kernel(shape, init_type: str, gain: float, gen) -> np.ndarray:
    if init_type == "normal":
        w = gain * torch.randn(shape, generator=gen, dtype=torch.float64)
    elif init_type == "xavier":
        # xavier_normal is variance_scaling(1, fan_avg, truncated_normal)
        fan_in, fan_out = _fans(shape)
        std = math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
        w = gain * std * _truncated_normal(shape, gen)
    elif init_type == "kaiming":
        # torch kaiming_normal_(a=0, mode='fan_in'); no gain in the reference
        w = math.sqrt(2.0 / _fans(shape)[0]) * torch.randn(
            shape, generator=gen, dtype=torch.float64)
    else:
        w = gain * _orthogonal(shape, gen)
    return w.numpy().astype(np.float32)


def reinit_tree(params: Dict, init_type: str, init_gain: float,
                gen: torch.Generator) -> Dict:
    """The JAX ``apply_init_type`` rule on a flax param tree (numpy leaves),
    drawing from ``gen`` in sorted-key order: kernels of ndim >= 2 redrawn,
    their biases 0; a BatchNorm (a node with a ``scale`` leaf) scale
    N(1, gain), bias 0.  Leaves of any other name (the LMF ``factor*``,
    ``fusion_weights``, ``fusion_bias``) are kept."""
    is_bn = "scale" in params and not isinstance(params["scale"], dict)
    out = {}
    for name in sorted(params):
        leaf = params[name]
        if isinstance(leaf, dict):
            out[name] = reinit_tree(leaf, init_type, init_gain, gen)
            continue
        leaf = np.asarray(leaf)
        if is_bn and name == "scale":
            leaf = (1.0 + init_gain * torch.randn(
                leaf.shape, generator=gen, dtype=torch.float64)
                ).numpy().astype(leaf.dtype)
        elif name == "bias":
            leaf = np.zeros_like(leaf)
        elif name == "kernel" and leaf.ndim >= 2 and not is_bn:
            leaf = _draw_kernel(leaf.shape, init_type, init_gain,
                                gen).astype(leaf.dtype)
        out[name] = leaf
    return out


@torch.no_grad()
def apply_init_type(model: nn.Module, init_type: str, init_gain: float,
                    generator: torch.Generator) -> nn.Module:
    """Post-init re-initialisation of ``model`` in place, the reference's
    ``init_weights`` (``utils.py:205-233``, applied by ``init_net`` from
    ``define_net``) as the JAX package's ``apply_init_type`` has it:

    - Conv/Linear/Bilinear kernels: normal(0, gain) | xavier_normal x gain |
      kaiming_normal(fan_in) | orthogonal x gain; their biases -> 0
    - BatchNorm scale: N(1, gain), bias -> 0

    ``max`` (the recipes' default), ``none`` and ``normal_default`` leave
    the model as built.  The rule runs on the model's flax tree
    (``import_flax``), so leaves are picked by flax name and fans computed
    on flax shapes, as in JAX; the draws agree with JAX's in law, not in
    bits."""
    if init_type in KEEP_INIT:
        return model
    if init_type not in INIT_TYPES:
        raise NotImplementedError(
            f"initialization method [{init_type}] is not implemented")
    from .import_flax import flax_from_state_dict, state_dict_from_flax
    params, stats = flax_from_state_dict(model.state_dict())
    model.load_state_dict(state_dict_from_flax(
        reinit_tree(params, init_type, init_gain, generator), stats),
        strict=True)
    return model


def autocast(x: torch.Tensor, dtype: torch.dtype):
    """Mixed-precision region for the encoders: with ``dtype=bfloat16`` the
    convolutions and Linears inside run in bf16 while parameters and BN
    statistics stay float32, as the JAX modules' ``dtype`` does."""
    return torch.autocast(x.device.type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)
