"""CLAT stage-2 CRD (v10): class-structured positives from the memory bank.

Port of ``multimodal_learning_tpu/contrast/crd_v10.py`` (reference
``MIA 2023/stage2_unimodal_student/CL_utils/CRD_criterion_v10.py``):

- ``pos_extra='neighbors'``: for each query the ``num_pos`` most
  cosine-similar same-class bank rows become its positives, and its
  positive terms are weighted by those similarities (``:70-80,280-314``);
- ``pos_extra='centers'``: per-class k-means centres of the bank rows are
  extra positives (own class) and extra negatives (other classes)
  (``:81-137``);
- per-query ``sample_weights`` multiply the per-sample NCE loss
  (``:241-276``).

As in the JAX module, the kNN is one [B, n_data] masked matmul and a top-k,
and the k-means is a fixed 10-iteration masked Lloyd's algorithm over the
bank, all on the device with no host read (the reference runs scikit-learn
on the CPU inside the step).  The k-means' Gumbel initialisation
(``draw_gumbel``) is drawn apart from its use, so a test can inject it.
``jax.lax.top_k`` puts the lower index first among equal values, and the
masked similarity rows hold many equal zeros, so the top rows come from a
stable descending sort.  The reference multiplies the similarity row by
the 0/1 class mask before the sort (``:71-74``), so masked-out zeros can
outrank negative same-class similarities; kept.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.nn import functional as F

from ..utils.logging import span
from .crd import EPS, CRDBank, bank_update, set_z


def _l2n(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def draw_gumbel(gen: Optional[torch.Generator], n_classes: int, n: int,
                device) -> torch.Tensor:
    """Standard Gumbel noise [2, n_classes, n] for the k-means
    initialisation of both banks in ``crd_v10_scores`` (one row per class
    and bank), drawn from ``gen`` on ``device``."""
    u = torch.rand(2, n_classes, n, generator=gen, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0)).clamp_min(tiny))


def masked_kmeans(x: torch.Tensor, mask: torch.Tensor, k: int,
                  gumbel: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Lloyd's algorithm over the rows of ``x`` [n, D] where ``mask`` is 1
    (fixed shapes: the other rows carry no weight).  The initial centres
    are the ``k`` masked rows of largest ``gumbel`` noise [n].  Returns
    [k, D]; an empty cluster keeps its centre."""
    scores = torch.where(mask > 0, gumbel, torch.full_like(gumbel,
                                                           -float("inf")))
    init = torch.sort(scores, descending=True, stable=True).indices[:k]
    centers = x[init]
    for _ in range(iters):
        d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)   # [n, k]
        onehot = F.one_hot(d.argmin(dim=1), k).to(x.dtype) * mask[:, None]
        tot = onehot.sum(0)[:, None]
        new = (onehot.t() @ x) / tot.clamp_min(1e-9)
        centers = torch.where(tot > 0, new, centers)
    return centers


def class_centers(memory: torch.Tensor, class_mask: torch.Tensor,
                  num_pos: int, gumbel: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """[C, num_pos - 1, D] per-class centres of the bank rows: the mean
    when ``num_pos == 2``, else k-means from ``gumbel`` [C, n_data]
    (``CRD_criterion_v10.py:84-92``)."""
    mem = memory.detach()
    if num_pos == 2:
        w = class_mask / class_mask.sum(1, keepdim=True).clamp_min(1e-9)
        return (w @ mem)[:, None, :]
    return torch.stack([masked_kmeans(mem, class_mask[c], num_pos - 1,
                                      gumbel[c])
                        for c in range(class_mask.shape[0])])


@torch.no_grad()
def _knn(mem: torch.Tensor, query: torch.Tensor, bmask: torch.Tensor,
         num_pos: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``num_pos`` rows of ``mem`` most similar to each query among its
    class (the mask applied before the sort), and their similarities."""
    sim = bmask * (_l2n(query) @ _l2n(mem).t())           # [B, n_data]
    vals, ids = torch.sort(sim, dim=1, descending=True, stable=True)
    return mem[ids[:, :num_pos]], vals[:, :num_pos]


def crd_v10_scores(
    bank: CRDBank, v1: torch.Tensor, v2: torch.Tensor,
    batch_label: torch.Tensor, y: torch.Tensor, idx: torch.Tensor, *,
    class_mask: torch.Tensor, num_pos: int, pos_extra: str,
    T: float = 0.07, momentum: float = 0.5,
    gumbel: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None, update_bank: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
           Optional[torch.Tensor]]:
    """Returns ``(out_v1, out_v2, sim_for_s, sim_for_t)``, the scores
    divided by Z; sets Z on first use and, with ``update_bank``, updates
    the bank rows ``y`` in place afterwards.

    ``idx`` [B, 1 + K] has the query itself in slot 0; ``class_mask``
    [C, n_data] is 0/1.  ``sim_for_s`` weighs the student-side loss
    (``neighbors``): the similarities from the teacher bank that the
    student queries, and ``sim_for_t`` vice versa.  ``centers`` takes its
    k-means noise from ``gumbel`` [2, C, n_data] (bank v1, bank v2), or
    draws it from ``generator``."""
    with span("contrast.scores"):
        idx = idx.long()
        labels = batch_label.long()
        mem1, mem2 = bank.memory_v1, bank.memory_v2
        w1, w2 = mem1[idx], mem2[idx]                         # [B, 1+K, D]
        sim1 = sim2 = None
        if pos_extra == "neighbors":
            bmask = class_mask[labels]                        # [B, n_data]
            knn1, sim1 = _knn(mem1, w1[:, 0], bmask, num_pos)
            knn2, sim2 = _knn(mem2, w2[:, 0], bmask, num_pos)
            w1 = torch.cat([knn1, w1[:, 1:]], dim=1)
            w2 = torch.cat([knn2, w2[:, 1:]], dim=1)
        elif pos_extra == "centers":
            C = class_mask.shape[0]
            if gumbel is None and num_pos > 2:
                gumbel = draw_gumbel(generator, C, mem1.shape[0], mem1.device)
            c1 = class_centers(mem1, class_mask, num_pos,
                               None if gumbel is None else gumbel[0])
            c2 = class_centers(mem2, class_mask, num_pos,
                               None if gumbel is None else gumbel[1])
            # the other classes of each sample, ascending (``:98-101``): a
            # stable argsort of the one-hot leaves the own class last
            order = torch.argsort(F.one_hot(labels, C), dim=1,
                                  stable=True)[:, :C - 1]
            B, D = v1.shape[0], c1.shape[-1]

            def expand(cc, w):
                return torch.cat([cc[labels], w,
                                  cc[order].reshape(B, -1, D)], dim=1)

            w1, w2 = expand(c1, w1), expand(c2, w2)
        elif pos_extra != "none":
            raise NotImplementedError(pos_extra)

        out_v2 = torch.exp(torch.einsum("bsd,bd->bs", w1, v2) / T)
        out_v1 = torch.exp(torch.einsum("bsd,bd->bs", w2, v1) / T)
        set_z(bank, out_v1, out_v2)
        out_v1, out_v2 = out_v1 / bank.z_v1, out_v2 / bank.z_v2
    if update_bank:
        with span("contrast.bank_update"):
            bank_update(bank, v1, v2, y, momentum)
    # out_v1 scores the student query against the teacher bank: weigh the
    # student's loss by the teacher-bank similarities (sim2), and vice versa
    return out_v1, out_v2, sim2, sim1


def contrast_loss_v10(x: torch.Tensor, n_data: int, num_pos: int,
                      sample_weights: torch.Tensor,
                      pos_sims: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """NCE loss with per-query weights (``CRD_criterion_v10.py:241-276``)
    and optionally similarity-weighted positives (``:280-314``).  Returns
    (mean loss, per-sample loss [B])."""
    m = x.shape[1] - num_pos
    mpn = m * (1.0 / float(n_data))
    p_pos = x[:, :num_pos]
    log_d1 = torch.log(p_pos / (p_pos + mpn + EPS))
    log_d0 = torch.log(mpn / (x[:, num_pos:] + mpn + EPS)).sum(1)
    if pos_sims is not None:
        per_pos = log_d1 + log_d0[:, None]
        sample_loss = -(per_pos * pos_sims).sum(1) / pos_sims.sum(
            1).clamp_min(1e-12)
    else:
        sample_loss = -(log_d1.mean(1) + log_d0)
    sample_loss = sample_weights.reshape(-1) * sample_loss
    return sample_loss.sum() / x.shape[0], sample_loss


@torch.no_grad()
def assign_sample_weights(prob_s: torch.Tensor, prob_t: torch.Tensor,
                          gt: torch.Tensor, max_discrep: float,
                          n_classes: int = 3) -> torch.Tensor:
    """CLAT query-discrepancy weights (``stage2
    train_test_path_multi_distill.py:131-158``): the probabilistic margin
    ``log p(gt) - log max p(other)`` of teacher and student; weight =
    clip(margin_t - margin_s, 0, max_discrep).  Detached."""
    oh = F.one_hot(gt.long(), n_classes).to(prob_s.dtype)

    def conf(p):
        return (torch.log((p * oh).sum(1))
                - torch.log((p * (1 - oh)).max(1).values))

    d = (conf(prob_t) - conf(prob_s)).clamp_min(0.0)
    return d.clamp_max(max_discrep)
