"""Gradient-guided teacher weighting (GK-Refine / AEKD / GKM), PyTorch.

Port of ``multimodal_learning_tpu/gradweight/aekd.py`` (reference
``MICCAI-2022/train_test_path_multi_distill.py:41-141``,
``MIA 2022/train_test_path_multi_distill_v2.py:50-132``,
``MIA 2023/stage2.../train_test_path_multi_distill.py:81-128``).  The
reference back-propagates each candidate loss through the whole network
with ``retain_graph=True`` only to read the gradient at the student feature
``feat_s``.  Every such loss reaches ``feat_s`` through a small head
(``fc_new2``, an embed, the CRD score arithmetic), so
:func:`feature_grads` asks autograd for the gradient with respect to the
feature tensor alone: the engine then walks the heads and never the trunk.
The weights are detached, as the reference reads ``grad.data``.

- ``aekd_scale``: cosine-Gram row sums (``AEKD_loss``, ``:58-70``)
- ``aekd_v2_gate``: cos(KD grad, CE grad) > 0 gate, optionally per sample
  (``AEKD_loss_v2``, ``:74-141``)
- ``momentum_aekd_scale``: thresholded cosine Gram, EMA'd across steps
  (MIA-2022 ``momentum_AEKD_loss``, ``..._v2.py:89-132``)
- ``gk_refine_param_space``: the Gram of parameter gradients
  (``..._v2.py:50-86``), one trunk backward per loss, as the reference
- ``gk_refine_thresh_weights``: per-sample thresholded gradient cosines
  (stage-2 ``GK_refine_thresh``, ``:81-128``)

The one-class-SVM weighting is ``gradweight/svm.py``.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..parallel.mesh import active, all_reduce_


def feature_grads(losses: Sequence[torch.Tensor], feat: torch.Tensor
                  ) -> List[torch.Tensor]:
    """Gradient of each scalar loss with respect to ``feat`` only, detached;
    the graph is kept for the step's own backward."""
    return [torch.autograd.grad(loss, feat, retain_graph=True)[0].detach()
            for loss in losses]


def aekd_scale(grads: Sequence[torch.Tensor], n_kd: int) -> torch.Tensor:
    """``AEKD_loss`` scale (``:58-62``): the gradients stacked (KD losses
    first, CE last), their cosine Gram times ``n_kd``, row sums."""
    G = torch.stack([g.reshape(-1) for g in grads]).detach()
    norms = torch.linalg.vector_norm(G, dim=1, keepdim=True)
    rel = (G @ G.t()) * n_kd / (norms @ norms.t())
    return rel.sum(dim=1)


def aekd_total(scale: torch.Tensor,
               kd_losses: Sequence[torch.Tensor]) -> torch.Tensor:
    """``dot(scale[:k], losses)`` (``:68``): the CE slot's weight drops."""
    return torch.dot(scale[:len(kd_losses)], torch.stack(list(kd_losses)))


def aekd_v2_gate(kd_grads: Sequence[torch.Tensor], ce_grad: torch.Tensor,
                 kd_losses: Sequence[torch.Tensor], per_sample: bool = False,
                 batch_size: int = 0) -> torch.Tensor:
    """``AEKD_loss_v2``: keep a KD loss where its feature gradient points
    the way of the CE gradient (``:123-136``).  ``per_sample``: the gate is
    [B, n_kd] over per-sample losses [B] each, the total
    ``sum(gate * losses) / batch_size``."""
    if per_sample:
        K = torch.stack(list(kd_grads), dim=1).detach()     # [B, n, D]
        c = ce_grad.detach()
        num = torch.einsum("bnd,bd->bn", K, c)
        den = (torch.linalg.vector_norm(K, dim=2)
               * torch.linalg.vector_norm(c, dim=1, keepdim=True))
        gate = (num / den.clamp_min(1e-12) > 0).float()
        return (gate * torch.stack(list(kd_losses), dim=1)).sum() / batch_size
    K = torch.stack([g.reshape(-1) for g in kd_grads]).detach()
    c = ce_grad.reshape(-1).detach()
    sim = (K @ c) / (torch.linalg.vector_norm(K, dim=1)
                     * torch.linalg.vector_norm(c)).clamp_min(1e-12)
    gate = (sim > 0).float()
    return (gate * torch.stack(list(kd_losses))).sum()


def _cos_gram(G: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(G, dim=1, keepdim=True)
    return (G @ G.t()) / (norms @ norms.t()).clamp_min(1e-12)


def momentum_aekd_scale(grads: Sequence[torch.Tensor],
                        ema_scale: torch.Tensor, grads_m: float,
                        thresh: float, use_thresh: bool
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MIA-2022 ``momentum_AEKD_loss`` (``..._v2.py:89-132``): the cosine
    Gram of the gradients (KD first, CE last), binarised by ``thresh`` when
    ``use_thresh``, row-summed, and EMA'd with momentum ``grads_m``.
    Returns (mo_scale, mo_scale): the weights and the carried state."""
    rel = _cos_gram(torch.stack([g.reshape(-1) for g in grads]).detach())
    if use_thresh:
        rel = (rel > thresh).float()
    new_ema = grads_m * ema_scale + (1.0 - grads_m) * rel.sum(dim=1)
    return new_ema, new_ema


def gk_refine_param_space(losses: Sequence[torch.Tensor],
                          params: Sequence[torch.Tensor]) -> torch.Tensor:
    """MIA-2022 parameter-space ``GK_refine`` (``..._v2.py:50-86``): the
    cosine-Gram row sums of each loss's gradient with respect to
    ``params`` (the caller leaves out the classifier head, ``fc_new2``);
    KD losses first, CE last.  A parameter a loss does not reach counts
    as a zero gradient.  Under a data group a rank's gradients are its
    share of the global ones, so they are averaged over the ranks first."""
    flat = []
    for loss in losses:
        gs = torch.autograd.grad(loss, list(params), retain_graph=True,
                                 allow_unused=True)
        flat.append(torch.cat([
            (torch.zeros_like(p) if g is None else g).reshape(-1).float()
            for g, p in zip(gs, params)]))
    grads = torch.stack(flat).detach()
    dp = active()
    if dp is not None:
        grads = all_reduce_(grads) / dp.world
    return _cos_gram(grads).sum(dim=1)


def gk_refine_thresh_weights(all_grads: Sequence[torch.Tensor],
                             grads_thresh: float,
                             use_thresh: bool = True) -> torch.Tensor:
    """Stage-2 ``GK_refine_thresh`` (``stage2 ...distill.py:80-128``): per
    sample, the pairwise cosines of all loss gradients (KD first, CE last);
    each loss's weight is its row sum, of the cosines above
    ``grads_thresh`` when ``use_thresh``, else of their positive parts.
    Returns [B, L]; the caller drops the CE column (``:117``)."""
    G = torch.stack(list(all_grads), dim=1).detach()          # [B, L, D]
    Gn = G / torch.linalg.vector_norm(G, dim=2, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("bld,bmd->blm", Gn, Gn)
    contrib = (sim > grads_thresh).float() if use_thresh else sim.clamp_min(0)
    return contrib.sum(dim=2)
