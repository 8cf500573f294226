"""Multimodal fusion modules (PyTorch).

Port of ``multimodal_learning_tpu/models/fusion.py``:

- :class:`BilinearFusion` -- "pofusion", the Kronecker outer-product
  fusion (reference ``MICCAI-2022/fusion.py:6-63``), with the reference's
  module names, so a reference or converted state_dict loads with
  ``strict=True``: ``linear_{h,z,o}{1,2}``, ``encoder1 = [Linear, BN1d,
  ReLU, Dropout]`` and ``encoder2`` alike;
- :class:`PolynomialFusion` -- the 4th-order fusion (stage-2
  ``fusion.py:6-73``), in the same layout with ``encoder3``;
- :class:`TrilinearFusion` -- the 3-modality variants A/B
  (``fusion.py:66-201``): three gated units, no BatchNorm;
- :class:`LMFusion` / :class:`HFBFusion` -- the JAX package's
  reconstructions of the ``LMF``/``HFB`` types the reference constructs but
  never defines (``networks_new.py:157-175``); their parameters carry the
  JAX package's names.

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

Only pofusion's contraction has a kernel, as in the JAX package: the
polynomial and trilinear Kronecker products are an einsum and an
``F.linear``, with their dropout on the Kronecker vector.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.kron_fusion import kron_matmul, kron_matmul_dropout
from ..parallel.mesh import draw_rows
from .common import BatchNorm1d, init_linear_, max_init_


class Bilinear(nn.Module):
    """``z_k = x1^T W_k x2 + b_k`` with ``weight [out, in1, in2]`` and
    U(+-1/sqrt(in1)) init: ``nn.Bilinear``'s parameters and law, drawn from
    ``generator``.  It contracts with one einsum because ``torch.bilinear``
    on CUDA launches one small GEMM per output feature: at paper width, 256
    launches and 13 ms of device time per serving forward on an H100, where
    the whole forward otherwise takes 2.8 ms (PERF.md).  The einsum is
    written as the two pairwise contractions that opt_einsum picks for it
    (the outer product x1 x2^T, then against W), so that the order does not
    depend on sizes a ``torch.export`` with a dynamic batch leaves
    symbolic."""

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
        outer = torch.einsum("bi,bj->bij", x1, x2)
        return torch.einsum("bij,kij->bk", outer, self.weight) + self.bias


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


def _kron(a, b):
    """Row-wise Kronecker product ``vec(a_b b_b^T)``, [B, |a| |b|]."""
    return torch.einsum("bi,bj->bij", a, b).reshape(a.shape[0], -1)


def _encoder(fan_in, mmhid, dropout_rate, generator):
    """``[Linear (max init), BN1d, ReLU, Dropout]``, the reference's
    ``encoderK`` layout."""
    return nn.Sequential(_dense_max(fan_in, mmhid, generator),
                         BatchNorm1d(mmhid), nn.ReLU(),
                         nn.Dropout(dropout_rate))


class _GatedFusion(nn.Module):
    """Registers gated units under the reference's names
    ``linear_{h,z,o}{i}``."""

    def _register_units(self, units):
        self._units = tuple(units)
        for i, unit in enumerate(self._units, 1):
            setattr(self, f"linear_h{i}", unit.linear_h)
            setattr(self, f"linear_z{i}", unit.linear_z)
            setattr(self, f"linear_o{i}", unit.linear_o)


class _KronEncoder1(nn.Module):
    """The Linear of ``encoder1``: owns the [mmhid, (d1+1)(d2+1)] weight
    (reference name ``encoder1.0``) and routes the contraction to
    ``kron_matmul`` in eval, to ``kron_matmul_dropout`` in training, or to
    the reference einsum.

    The train path draws its dropout mask Bernoulli(keep)/keep over the
    Kronecker vector, as ``nn.Dropout`` would, from ``self.generator`` (a
    ``torch.Generator`` on the tensors' device, which the train state sets;
    the device's default generator when None), and ones when the rate is 0,
    as the JAX module does.  Under a data group the mask is drawn for the
    global batch and sliced to the rank's rows (``parallel.draw_rows``),
    as the JAX module draws one mask for the sharded batch."""

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
            width = self.weight.shape[1]
            keep = 1.0 - self.drop.p
            if self.drop.p > 0.0:
                maskf = draw_rows(lambda n: torch.bernoulli(
                    torch.full((n, width), keep, device=o1.device),
                    generator=self.generator) / keep, o1.shape[0])
            else:
                maskf = torch.ones((o1.shape[0], width), device=o1.device)
            return kron_matmul_dropout(o1.float(), o2.float(), self.weight,
                                       self.bias, maskf)
        return F.linear(self.drop(_kron(o1, o2)), self.weight, self.bias)


class BilinearFusion(_GatedFusion):
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
        self._register_units((
            _GatedUnit(dim1, dim2, d1, gate1, use_bilinear, dropout_rate,
                       generator),
            _GatedUnit(dim2, dim1, d2, gate2, use_bilinear, dropout_rate,
                       generator)))
        self.encoder1 = nn.Sequential(
            _KronEncoder1(d1 + 1, d2 + 1, mmhid, dropout_rate, pallas_eval,
                          pallas_train, generator),
            BatchNorm1d(mmhid), nn.ReLU(), nn.Dropout(dropout_rate))
        enc2_in = mmhid + (d1 + 1 + d2 + 1 if skip else 0)
        self.encoder2 = _encoder(enc2_in, mmhid, dropout_rate, generator)

    def forward(self, vec1, vec2):
        vec1, vec2 = torch.relu(vec1), torch.relu(vec2)
        unit1, unit2 = self._units
        o1 = _append_one(unit1(vec1, vec2, (0, 1)))
        o2 = _append_one(unit2(vec2, vec1, (1, 0)))
        out = self.encoder1[1:](self.encoder1[0](o1, o2))
        if self.skip:
            out = torch.cat([out, o1, o2], dim=1)
        return self.encoder2(out)


class PolynomialFusion(_GatedFusion):
    """4th-order fusion (stage-2 ``fusion.py:6-73``): the gated o1, o2 ->
    append 1 -> Kronecker o12 -> ``encoder1`` -> append 1 -> Kronecker
    with itself -> ``encoder2`` -> skip -> ``encoder3``.  Dropout falls on
    both Kronecker vectors before their Linear.  Both units pair their
    inputs as ``(self, other)`` (JAX ``fusion.py:232-237``), so ``unit2``'s
    Bilinear is ``z(vec2, vec1)``, the other way round from pofusion's.
    ``encoder2`` takes (mmhid+1)^2 inputs, what the JAX module infers; the
    reference reuses (dim1+1)(dim2+1), which is equal only at
    ``mmhid == dim1 == dim2``."""

    def __init__(self, skip: int = 1, use_bilinear: int = 1, gate1: int = 1,
                 gate2: int = 1, dim1: int = 32, dim2: int = 32,
                 scale_dim1: int = 1, scale_dim2: int = 1, mmhid: int = 64,
                 dropout_rate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.skip = skip
        d1, d2 = dim1 // scale_dim1, dim2 // scale_dim2
        self._register_units((
            _GatedUnit(dim1, dim2, d1, gate1, use_bilinear, dropout_rate,
                       generator),
            _GatedUnit(dim2, dim1, d2, gate2, use_bilinear, dropout_rate,
                       generator)))
        self.drop = nn.Dropout(dropout_rate)
        self.encoder1 = _encoder((d1 + 1) * (d2 + 1), mmhid, dropout_rate,
                                 generator)
        self.encoder2 = _encoder((mmhid + 1) ** 2, mmhid, dropout_rate,
                                 generator)
        enc3_in = mmhid + (d1 + 1 + d2 + 1 if skip else 0)
        self.encoder3 = _encoder(enc3_in, mmhid, dropout_rate, generator)

    def forward(self, vec1, vec2):
        vec1, vec2 = torch.relu(vec1), torch.relu(vec2)
        unit1, unit2 = self._units
        o1 = _append_one(unit1(vec1, vec2, (0, 1)))
        o2 = _append_one(unit2(vec2, vec1, (0, 1)))
        out12 = _append_one(self.encoder1(self.drop(_kron(o1, o2))))
        out = self.encoder2(self.drop(_kron(out12, out12)))
        if self.skip:
            out = torch.cat([out, o1, o2], dim=1)
        return self.encoder3(out)


class TrilinearFusion(_GatedFusion):
    """3-modality outer-product fusion, variants A/B (``fusion.py:66-201``).
    The gating pairs are A: (1<-3, 2<-3, 3<-1), B: (1<-3, 2<-1, 3<-1);
    unit3 pairs ``(vec1, vec3)``, so it needs ``dim1 == dim3``, as in the
    JAX module.  ``encoder1``/``encoder2`` are ``[Linear]`` (no BatchNorm);
    dropout falls on the Kronecker vector and after each ReLU."""

    def __init__(self, variant: str = "A", skip: int = 1,
                 use_bilinear: int = 1, gate1: int = 1, gate2: int = 1,
                 gate3: int = 1, dim1: int = 32, dim2: int = 32,
                 dim3: int = 32, mmhid: int = 96, dropout_rate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if variant not in ("A", "B"):
            raise ValueError(f"TrilinearFusion variant {variant!r}: A or B")
        self.variant, self.skip = variant, skip
        dim_o2 = dim3 if variant == "A" else dim1
        self._register_units((
            _GatedUnit(dim1, dim3, dim1, gate1, use_bilinear, dropout_rate,
                       generator),
            _GatedUnit(dim2, dim_o2, dim2, gate2, use_bilinear, dropout_rate,
                       generator),
            _GatedUnit(dim3, dim1, dim3, gate3, use_bilinear, dropout_rate,
                       generator)))
        self.drop = nn.Dropout(dropout_rate)
        self.encoder1 = nn.Sequential(_dense_max(
            (dim1 + 1) * (dim2 + 1) * (dim3 + 1), mmhid, generator))
        enc2_in = mmhid + (dim1 + dim2 + dim3 + 3 if skip else 0)
        self.encoder2 = nn.Sequential(_dense_max(enc2_in, mmhid, generator))

    def forward(self, vec1, vec2, vec3):
        unit1, unit2, unit3 = self._units
        other2 = vec3 if self.variant == "A" else vec1
        o1 = _append_one(unit1(vec1, vec3, (0, 1)))
        o2 = _append_one(unit2(vec2, other2, (0, 1)))
        o3 = _append_one(unit3(vec3, vec1, (1, 0)))
        # pairwise, so that a dynamic batch in torch.export contracts in
        # the same order as eager
        o123 = _kron(_kron(o1, o2), o3)
        out = self.drop(torch.relu(self.encoder1(self.drop(o123))))
        if self.skip:
            out = torch.cat([out, o1, o2, o3], dim=1)
        return self.drop(torch.relu(self.encoder2(out)))


@torch.no_grad()
def _flax_xavier_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's ``xavier_normal`` with flax's fans: the last two axes are
    (in, out) and every leading axis is receptive field, so a
    ``[rank, d, k]`` factor has fan_in = rank d and fan_out = rank k
    (``torch.nn.init.xavier_normal_`` reads d k and rank k instead)."""
    receptive = math.prod(w.shape[:-2])
    fan_in, fan_out = w.shape[-2] * receptive, w.shape[-1] * receptive
    return w.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                     generator=generator)


class LMFusion(nn.Module):
    """Low-rank Multimodal Fusion (Liu et al., ACL 2018), the JAX package's
    reconstruction of the missing ``LMF_bifusion``
    (``networks_new.py:157-166``): each modality, ReLU'd, dropped out and
    with a 1 appended, is projected by ``rank`` factors
    (``factor{1,2}`` [rank, d+1, mmhid]); the rank-wise products are
    summed with ``fusion_weights`` [1, rank] plus ``fusion_bias``."""

    def __init__(self, dim1: int = 128, dim2: int = 128, mmhid: int = 128,
                 rank: int = 4, dropout_rate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.drop = nn.Dropout(dropout_rate)
        self.factor1 = nn.Parameter(torch.empty(rank, dim1 + 1, mmhid))
        self.factor2 = nn.Parameter(torch.empty(rank, dim2 + 1, mmhid))
        self.fusion_weights = nn.Parameter(torch.empty(1, rank))
        self.fusion_bias = nn.Parameter(torch.zeros(mmhid))
        for w in (self.factor1, self.factor2, self.fusion_weights):
            _flax_xavier_normal_(w, generator)

    def forward(self, vec1, vec2):
        x1 = _append_one(self.drop(torch.relu(vec1)))
        x2 = _append_one(self.drop(torch.relu(vec2)))
        z1 = torch.einsum("bi,rik->brk", x1, self.factor1)
        z2 = torch.einsum("bi,rik->brk", x2, self.factor2)
        return (torch.einsum("or,brk->bk", self.fusion_weights, z1 * z2)
                + self.fusion_bias)


class HFBFusion(nn.Module):
    """Factorised bilinear pooling with sum-pooled rank expansion
    (MFB-style), the JAX package's stand-in for the missing ``HFB_fusion``
    (``networks_new.py:169-175``): ``proj1``/``proj2`` (max init, zero
    bias) to mmhid x rank, their product dropped out and summed over the
    rank, then the signed square root ``sign(x) sqrt(|x| + 1e-12)`` and
    division by the L2 norm plus 1e-12."""

    def __init__(self, dim1: int = 128, dim2: int = 128, mmhid: int = 128,
                 rank: int = 20, dropout_rate: float = 0.25,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.mmhid, self.rank = mmhid, rank
        self.proj1 = _dense_max(dim1, mmhid * rank, generator)
        self.proj2 = _dense_max(dim2, mmhid * rank, generator)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, vec1, vec2):
        joint = self.drop(self.proj1(torch.relu(vec1))
                          * self.proj2(torch.relu(vec2)))
        joint = joint.reshape(joint.shape[0], self.mmhid, self.rank).sum(-1)
        joint = torch.sign(joint) * torch.sqrt(joint.abs() + 1e-12)
        return joint / (torch.linalg.vector_norm(joint, dim=1, keepdim=True)
                        + 1e-12)
