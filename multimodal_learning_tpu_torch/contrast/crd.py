"""CRD NCE memory bank, classic generation (v1), in PyTorch.

Port of the core of ``multimodal_learning_tpu/contrast/crd.py`` (reference
``MICCAI-2022/CL_utils/CRD_criterion.py:8-216``).  The bank is plain tensors
in the train state (:class:`CRDBank`), updated in place without autograd:

- ``v1`` is the student embedding, ``v2`` the teacher's;
  ``out_v1 = exp(<memory_v2[idx], v1> / T)`` scores the student against
  the teacher bank and vice versa;
- the constants ``Z_v1``/``Z_v2`` are estimated from the first batch
  (``mean(out) * n_data``) and frozen after (``CRD_criterion.py:51-59``);
  a negative value means "not estimated yet", and the test runs on the
  device (``torch.where``), so no step waits on the host;
- the rows at the batch's own indices are momentum-updated and
  L2-renormalised after the scores are taken (``CRD_criterion.py:65-79``).

The discrepancy-selected and weighted generations (``crd_scores_select``,
``weighted_contrast_loss``, ``crd_gate_weights``) serve the students and
are not ported yet.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..models.common import init_linear_

EPS = 1e-7


class Embed(nn.Module):
    """Projection head + L2 normalisation.  ``mlp=True``: Linear -> ReLU ->
    Linear (``CRD_criterion.py:219-233``), ``mlp=False``: one Linear
    (``CRD_loss.py:256-267``); torch-default init, names ``fc1``/``fc2``."""

    def __init__(self, dim_in: int, dim_out: int = 128, mlp: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = init_linear_(nn.Linear(dim_in, dim_out), False, generator)
        self.fc2 = (init_linear_(nn.Linear(dim_out, dim_out), False,
                                 generator) if mlp else None)

    def forward(self, x):
        x = self.fc1(x.reshape(x.shape[0], -1))
        if self.fc2 is not None:
            x = self.fc2(torch.relu(x))
        return x / x.pow(2).sum(dim=1, keepdim=True).sqrt()


@dataclass
class CRDBank:
    memory_v1: torch.Tensor  # [n_data, feat_dim] student-side bank
    memory_v2: torch.Tensor  # [n_data, feat_dim] teacher-side bank
    z_v1: torch.Tensor       # scalar; < 0 means "not estimated yet"
    z_v2: torch.Tensor


def init_bank(n_data: int, feat_dim: int,
              generator: Optional[torch.Generator] = None,
              device=None) -> CRDBank:
    """U(-stdv, stdv), stdv = 1/sqrt(feat_dim/3) (``CRD_criterion.py:21-23``).
    Drawn on the generator's device, then moved to ``device``."""
    stdv = 1.0 / math.sqrt(feat_dim / 3)
    gdev = generator.device if generator is not None else "cpu"
    mk = lambda: (torch.rand(n_data, feat_dim, generator=generator,
                             device=gdev) * (2 * stdv) - stdv).to(device)
    z = lambda: torch.full((), -1.0, device=device)
    return CRDBank(mk(), mk(), z(), z())


@torch.no_grad()
def set_z(bank: CRDBank, out_v1: torch.Tensor, out_v2: torch.Tensor) -> None:
    """Freeze Z on first use (``CRD_criterion.py:51-59``), in place."""
    n = bank.memory_v1.shape[0]
    bank.z_v1.copy_(torch.where(bank.z_v1 < 0, out_v1.mean() * n, bank.z_v1))
    bank.z_v2.copy_(torch.where(bank.z_v2 < 0, out_v2.mean() * n, bank.z_v2))


@torch.no_grad()
def bank_update(bank: CRDBank, v1: torch.Tensor, v2: torch.Tensor,
                y: torch.Tensor, momentum: float) -> None:
    """Momentum + L2 renormalisation of rows ``y`` (dataset indices, unique
    within a batch), in place (``CRD_criterion.py:65-79``)."""
    y = y.long()
    for mem, v in ((bank.memory_v1, v1), (bank.memory_v2, v2)):
        new = mem[y] * momentum + v.detach() * (1.0 - momentum)
        mem.index_copy_(0, y, new / new.pow(2).sum(dim=1, keepdim=True).sqrt())


def crd_scores(bank: CRDBank, v1: torch.Tensor, v2: torch.Tensor,
               y: torch.Tensor, idx: torch.Tensor, T: float = 0.07,
               momentum: float = 0.5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classic CRD memory forward (v1): ``idx[:, 0]`` is the positive.
    Returns ``(out_v1, out_v2)`` [B, S], already divided by Z; sets Z on the
    first call and updates the bank rows ``y`` in place."""
    idx = idx.long()
    w1 = bank.memory_v1[idx]                     # [B, S, D], copies
    w2 = bank.memory_v2[idx]
    out_v2 = torch.exp(torch.einsum("bsd,bd->bs", w1, v2) / T)
    out_v1 = torch.exp(torch.einsum("bsd,bd->bs", w2, v1) / T)
    set_z(bank, out_v1, out_v2)
    out_v1, out_v2 = out_v1 / bank.z_v1, out_v2 / bank.z_v2
    bank_update(bank, v1, v2, y, momentum)
    return out_v1, out_v2


def _for_the_students(name):
    def unported(*args, **kwargs):
        raise NotImplementedError(
            f"{name} (the students' CRD generations: v2/v3/v4, mono and the "
            "loss-gated CRD) is not ported yet: ROADMAP A11")
    unported.__name__ = name
    return unported


crd_scores_select = _for_the_students("crd_scores_select")
weighted_contrast_loss = _for_the_students("weighted_contrast_loss")
crd_gate_weights = _for_the_students("crd_gate_weights")


def contrast_loss(x: torch.Tensor, n_data: int, n_pos: int = 1,
                  per_sample: bool = False) -> torch.Tensor:
    """NCE binary log-loss (``CRD_criterion.py:191-216``; for ``n_pos > 1``
    the positive terms are averaged, ``ContrastLoss_v2``).  ``x[:, :n_pos]``
    are positive scores, the rest negatives; noise density 1/n_data."""
    m = x.shape[1] - n_pos
    mpn = m * (1.0 / float(n_data))
    p_pos = x[:, :n_pos]
    log_d1 = torch.log(p_pos / (p_pos + mpn + EPS))
    log_d0 = torch.log(mpn / (x[:, n_pos:] + mpn + EPS))
    pos_term = log_d1.mean(dim=1) if n_pos > 1 else log_d1[:, 0]
    sample_loss = -(pos_term + log_d0.sum(dim=1))
    if per_sample:
        return sample_loss
    return sample_loss.sum() / x.shape[0]
