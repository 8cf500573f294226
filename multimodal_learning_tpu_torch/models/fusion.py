"""Pofusion: the Kronecker outer-product fusion (PyTorch).

Port of ``BilinearFusion`` from ``multimodal_learning_tpu/models/fusion.py``
(reference ``MICCAI-2022/fusion.py:6-63``) with the reference's module
names, so a reference or converted state_dict loads with ``strict=True``:
``linear_{h,z,o}{1,2}``, ``encoder1 = [Linear, BN1d, ReLU, Dropout]`` and
``encoder2`` alike.

In eval with ``pallas_eval`` the ``encoder1`` contraction goes through
``ops.kron_fusion.kron_matmul`` (differentiable: an eval forward under
autograd, as the saliency pass runs it, reaches the backward kernels); in
training with ``pallas_train`` through ``kron_matmul_dropout``, with the
dropout on the Kronecker vector (``fusion.py:59``) as an explicit mask.
Each takes its CUDA kernel for CUDA tensors and its plain version for CPU
tensors; the (d1+1)(d2+1) Kronecker vector never reaches device memory.
Otherwise the reference einsum runs, with ``nn.Dropout``.  The JAX
package's 15 MB VMEM guard on the train kernel is a TPU limit and has no
counterpart here.

The other fusion types of the JAX module are not ported yet.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.kron_fusion import kron_matmul, kron_matmul_dropout
from .common import BatchNorm1d, init_linear_, max_init_


class Bilinear(nn.Module):
    """``z_k = x1^T W_k x2 + b_k`` with ``weight [out, in1, in2]`` and
    U(+-1/sqrt(in1)) init: ``nn.Bilinear``'s parameters and law, drawn from
    ``generator``.  It contracts with one einsum because ``torch.bilinear``
    on CUDA launches one small GEMM per output feature: at paper width, 256
    launches and 13 ms of device time per serving forward on an H100, where
    the whole forward otherwise takes 2.8 ms (PERF.md)."""

    def __init__(self, in1: int, in2: int, out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in1)
        self.weight = nn.Parameter(torch.empty(out, in1, in2))
        self.bias = nn.Parameter(torch.empty(out))
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x1, x2):
        return torch.einsum("bi,kij,bj->bk", x1, self.weight, x2) + self.bias


def _dense_max(fan_in, width, generator):
    return init_linear_(nn.Linear(fan_in, width), True, generator)


def _append_one(o):
    return torch.cat([o, o.new_ones(o.shape[0], 1)], dim=1)


class _GatedUnit:
    """One gated bimodal unit: ``o = Dropout(ReLU(W_o(sigmoid(z) * h)))``
    with ``h = ReLU(W_h v)`` and ``z = Bilinear(v1, v2)``
    (``fusion.py:41-53``).  It builds the layers in the reference's
    Sequential layout and runs them; ``BilinearFusion`` registers them as
    ``linear_{h,z,o}{1,2}``, so the parameter names are the reference's."""

    def __init__(self, dim_og1, dim_og2, dim, gate=1, use_bilinear=1,
                 dropout_rate=0.25, generator=None):
        self.gate, self.use_bilinear = gate, use_bilinear
        self.linear_h = self.linear_z = None
        if gate:
            self.linear_h = nn.Sequential(
                _dense_max(dim_og1, dim, generator), nn.ReLU())
            self.linear_z = (
                Bilinear(dim_og1, dim_og2, dim, generator) if use_bilinear
                else nn.Sequential(
                    _dense_max(dim_og1 + dim_og2, dim, generator)))
        self.linear_o = nn.Sequential(
            _dense_max(dim if gate else dim_og1, dim, generator), nn.ReLU(),
            nn.Dropout(dropout_rate))

    def __call__(self, vec_self, vec_other, order: Tuple[int, int]):
        if self.gate:
            h = self.linear_h(vec_self)
            pair = ((vec_self, vec_other) if order == (0, 1)
                    else (vec_other, vec_self))
            z = (self.linear_z(*pair) if self.use_bilinear
                 else self.linear_z(torch.cat(pair, dim=1)))
            g = torch.sigmoid(z) * h
        else:
            g = vec_self
        return self.linear_o(g)


class _KronEncoder1(nn.Module):
    """The Linear of ``encoder1``: owns the [mmhid, (d1+1)(d2+1)] weight
    (reference name ``encoder1.0``) and routes the contraction to
    ``kron_matmul`` in eval, to ``kron_matmul_dropout`` in training, or to
    the reference einsum.

    The train path draws its dropout mask Bernoulli(keep)/keep over the
    Kronecker vector, as ``nn.Dropout`` would, from ``self.generator`` (a
    ``torch.Generator`` on the tensors' device, which the train state sets;
    the device's default generator when None), and ones when the rate is 0,
    as the JAX module does."""

    def __init__(self, d1p: int, d2p: int, mmhid: int, dropout_rate: float,
                 pallas_eval: bool, pallas_train: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.pallas_eval, self.pallas_train = pallas_eval, pallas_train
        self.generator: Optional[torch.Generator] = None
        self.weight = nn.Parameter(torch.empty(mmhid, d1p * d2p))
        self.bias = nn.Parameter(torch.zeros(mmhid))
        max_init_(self.weight, generator)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, o1, o2):
        if self.pallas_eval and not self.training:
            return kron_matmul(o1, o2, self.weight, self.bias)
        if self.pallas_train and self.training:
            shape = (o1.shape[0], self.weight.shape[1])
            keep = 1.0 - self.drop.p
            if self.drop.p > 0.0:
                maskf = torch.bernoulli(
                    torch.full(shape, keep, device=o1.device),
                    generator=self.generator) / keep
            else:
                maskf = torch.ones(shape, device=o1.device)
            return kron_matmul_dropout(o1.float(), o2.float(), self.weight,
                                       self.bias, maskf)
        o12 = torch.einsum("bi,bj->bij", o1, o2).reshape(o1.shape[0], -1)
        return F.linear(self.drop(o12), self.weight, self.bias)


class BilinearFusion(nn.Module):
    """Pathomic Kronecker fusion ("pofusion", ``fusion.py:6-63``)."""

    def __init__(self, skip: int = 1, use_bilinear: int = 1, gate1: int = 1,
                 gate2: int = 1, dim1: int = 32, dim2: int = 32,
                 scale_dim1: int = 1, scale_dim2: int = 1, mmhid: int = 64,
                 dropout_rate: float = 0.25, pallas_eval: bool = False,
                 pallas_train: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip = skip
        d1, d2 = dim1 // scale_dim1, dim2 // scale_dim2
        self._units = (
            _GatedUnit(dim1, dim2, d1, gate1, use_bilinear, dropout_rate,
                       generator),
            _GatedUnit(dim2, dim1, d2, gate2, use_bilinear, dropout_rate,
                       generator))
        for i, unit in enumerate(self._units, 1):
            setattr(self, f"linear_h{i}", unit.linear_h)
            setattr(self, f"linear_z{i}", unit.linear_z)
            setattr(self, f"linear_o{i}", unit.linear_o)
        self.encoder1 = nn.Sequential(
            _KronEncoder1(d1 + 1, d2 + 1, mmhid, dropout_rate, pallas_eval,
                          pallas_train, generator),
            BatchNorm1d(mmhid), nn.ReLU(), nn.Dropout(dropout_rate))
        enc2_in = mmhid + (d1 + 1 + d2 + 1 if skip else 0)
        self.encoder2 = nn.Sequential(
            _dense_max(enc2_in, mmhid, generator), BatchNorm1d(mmhid),
            nn.ReLU(), nn.Dropout(dropout_rate))

    def forward(self, vec1, vec2):
        vec1, vec2 = torch.relu(vec1), torch.relu(vec2)
        unit1, unit2 = self._units
        o1 = _append_one(unit1(vec1, vec2, (0, 1)))
        o2 = _append_one(unit2(vec2, vec1, (1, 0)))
        out = self.encoder1[1:](self.encoder1[0](o1, o2))
        if self.skip:
            out = torch.cat([out, o1, o2], dim=1)
        return self.encoder2(out)
