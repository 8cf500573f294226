"""CRD NCE memory banks, in PyTorch.

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

The students' generations (``crd_scores_select``: the discrepancy-guided
positive and negative selection of v2/v3 and the soft negative weights of
v4) and the loss-gated CRD (``weighted_contrast_loss``,
``crd_gate_weights``) follow.  ``crd_scores_select`` leaves the bank alone
unless asked to update it: the student step scores with the selected
columns' Z and stores the raw columns' Z after the optimizer step, as the
JAX student does.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..models.common import init_linear_
from ..utils.logging import span

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
    with span("contrast.scores"):
        idx = idx.long()
        w1 = bank.memory_v1[idx]                 # [B, S, D], copies
        w2 = bank.memory_v2[idx]
        out_v2 = torch.exp(torch.einsum("bsd,bd->bs", w1, v2) / T)
        out_v1 = torch.exp(torch.einsum("bsd,bd->bs", w2, v1) / T)
        set_z(bank, out_v1, out_v2)
        out_v1, out_v2 = out_v1 / bank.z_v1, out_v2 / bank.z_v2
    with span("contrast.bank_update"):
        bank_update(bank, v1, v2, y, momentum)
    return out_v1, out_v2


def _cos_rel(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Cosine of each bank row ``w[b, s]`` with the query ``v[b]``: [B, S]."""
    wn = w / torch.linalg.vector_norm(w, dim=2, keepdim=True)
    vn = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    return torch.einsum("bsd,bd->bs", wn, vn)


def draw_pick(select_pos_mode: str, P: int, P2: int,
              generator: Optional[torch.Generator] = None,
              epoch_frac: float = 0.0, device=None) -> Optional[torch.Tensor]:
    """The ranks of the P2 positives kept for every row (``None`` for
    ``hard``, which keeps the first P2): ``mid`` draws P2 distinct ranks
    from [30, min(100, P)) (``memory_new.py:311``), ``random`` P2 ranks of
    [0, P) with repeats, ``curriculum`` P2 of a 50-wide window that moves
    toward the harder ranks as ``epoch_frac`` grows (``:319-322``).  Drawn
    from ``generator`` on its device (``device`` when it is None)."""
    dev = generator.device if generator is not None else device
    if select_pos_mode == "hard":
        return None
    if select_pos_mode == "mid":
        hi = min(100, P)
        if hi - 30 < P2:
            raise ValueError(
                f"select_pos_mode mid draws {P2} distinct ranks from "
                f"[30, {hi}): it needs nce_p >= {30 + P2}, got {P}")
        return 30 + torch.randperm(hi - 30, generator=generator,
                                   device=dev)[:P2]
    if select_pos_mode == "random":
        return torch.randint(0, P, (P2,), generator=generator, device=dev)
    if select_pos_mode == "curriculum":
        # ceil(3 * epoch_frac) in float32, as the JAX step's epoch_frac is
        lo = 50 * (3 - int(torch.tensor(epoch_frac).mul(3).ceil()))
        return lo + torch.randint(0, 50, (P2,), generator=generator,
                                  device=dev)
    raise NotImplementedError(select_pos_mode)


def crd_scores_select(
    bank: CRDBank, v1: torch.Tensor, v2: torch.Tensor, y: torch.Tensor,
    idx: torch.Tensor, *, P: int, K: int, P2: int, K2: int,
    T: float = 0.07, momentum: float = 0.5,
    select_pos_mode: str = "hard", select_pos_pairs: bool = True,
    select_neg_pairs: bool = True, neg_reweight: bool = False,
    epoch_frac: float = 0.0, generator: Optional[torch.Generator] = None,
    pick: Optional[torch.Tensor] = None, update_bank: bool = True,
    pos_sort: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """DC-Distill / DSCD memory forward (v2/v3/v4, ``memory_new.py:103-222,
    249-397``; v4 ``MIA 2022/CL_utils/memory_new.py:398-561``).

    ``idx = [P positives | K negatives]`` per row.  The positive slots are
    ranked by the relation discrepancy, descending, and P2 are kept by
    ``select_pos_mode`` (their ranks ``pick``, or drawn from ``generator``
    by :func:`draw_pick`; slot 0 stays the exact positive); the negatives
    are ranked ascending and the first K2 kept (v3), or, with
    ``neg_reweight``, all K kept with each exp-score multiplied by
    ``rel1 - rel2 + 1`` (v4), folded into the returned scores and into the
    Z estimate as the reference does.  Both sorts are stable, so ties go to
    the lower column, as ``jnp.argsort``'s do.

    Returns ``(out_v1, out_v2, neg_weights)``, the scores divided by Z
    (``neg_weights`` only with ``neg_reweight``, for diagnostics).  Z is
    the bank's, or this batch's estimate while the bank has none; the bank
    is left untouched unless ``update_bank``, which then freezes that Z
    into it and momentum-updates the rows ``y``."""
    idx = idx.long()
    w1, w2 = bank.memory_v1[idx], bank.memory_v2[idx]     # [B, S, D]
    out_v2 = torch.exp(torch.einsum("bsd,bd->bs", w1, v2) / T)
    out_v1 = torch.exp(torch.einsum("bsd,bd->bs", w2, v1) / T)
    with torch.no_grad():
        rel1 = _cos_rel(w1, v1)   # student query vs student bank
        rel2 = _cos_rel(w2, v2)   # teacher query vs teacher bank

    if select_pos_pairs:
        # v2/v3 sort by their misnamed ``t_relation - s_relation`` = rel1 -
        # rel2 (``memory_new.py:148-151``); v4 and mono fixed the naming and
        # sort by rel2 - rel1; ``pos_sort`` overrides ("v23" | "v4")
        if pos_sort is None:
            pos_sort = "v4" if neg_reweight else "v23"
        if pos_sort == "v4":
            diff_pos = rel2[:, :P] - rel1[:, :P]
        elif pos_sort == "v23":
            diff_pos = rel1[:, :P] - rel2[:, :P]
        else:
            raise ValueError(f"pos_sort: {pos_sort!r}")
        order = torch.argsort(-diff_pos, dim=1, stable=True)
        if pick is None and select_pos_mode != "hard":
            pick = draw_pick(select_pos_mode, P, P2, generator, epoch_frac,
                             v1.device)
        sel = order[:, :P2] if pick is None else order[:, pick.long()]
        sel[:, 0] = 0   # pin the exact positive, memory_new.py:325
        pos_v1 = torch.gather(out_v1[:, :P], 1, sel)
        pos_v2 = torch.gather(out_v2[:, :P], 1, sel)
    else:
        pos_v1, pos_v2 = out_v1[:, :P], out_v2[:, :P]

    neg_weights = None
    if neg_reweight:
        # v4: every negative's exp-score times s_relation - t_relation + 1
        # (may dip below 0; reproduced, not clamped)
        neg_weights = rel1[:, P:] - rel2[:, P:] + 1.0
        neg_v1 = out_v1[:, P:] * neg_weights
        neg_v2 = out_v2[:, P:] * neg_weights
    elif select_neg_pairs:
        order = torch.argsort(rel1[:, P:] - rel2[:, P:], dim=1,
                              stable=True)[:, :K2]
        neg_v1 = torch.gather(out_v1[:, P:], 1, order)
        neg_v2 = torch.gather(out_v2[:, P:], 1, order)
    else:
        neg_v1, neg_v2 = out_v1[:, P:], out_v2[:, P:]

    out_v1 = torch.cat([pos_v1, neg_v1], dim=1)
    out_v2 = torch.cat([pos_v2, neg_v2], dim=1)
    n = bank.memory_v1.shape[0]
    z1 = torch.where(bank.z_v1 < 0, out_v1.detach().mean() * n, bank.z_v1)
    z2 = torch.where(bank.z_v2 < 0, out_v2.detach().mean() * n, bank.z_v2)
    if update_bank:
        with torch.no_grad():
            bank.z_v1.copy_(z1)
            bank.z_v2.copy_(z2)
        bank_update(bank, v1, v2, y, momentum)
    return out_v1 / z1, out_v2 / z2, neg_weights


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


def weighted_contrast_loss(x: torch.Tensor, sample_weights: torch.Tensor,
                           n_data: int) -> torch.Tensor:
    """``weighted_ContrastLoss`` (``MICCAI-2022/CL_utils/CRD_loss.py:53-82``):
    the per-sample NCE loss scaled by a 0/1 gate weight, summed and divided
    by the batch size."""
    per = contrast_loss(x, n_data, n_pos=1, per_sample=True)
    return (sample_weights * per).sum() / x.shape[0]


def crd_gate_weights(loss_s: torch.Tensor, loss_t: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``weighted_CRDLoss`` comparison gate (``CRD_loss.py:44-46``): the
    student-anchored side trains only where the student's per-sample loss
    exceeds the teacher's, and vice versa.  Detached."""
    loss_s, loss_t = loss_s.detach(), loss_t.detach()
    return (loss_s > loss_t).float(), (loss_t > loss_s).float()
