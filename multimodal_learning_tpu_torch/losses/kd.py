"""Prediction distillation losses.

Port of ``multimodal_learning_tpu/losses/kd.py``: ``pred_KD_loss``
(``MICCAI-2022/CL_utils/KD_losses.py:12-38``), ``DistillKL``
(``MICCAI-2022/KD_loss.py:7-17``) and ``SP_loss``
(``CL_utils/KD_losses.py:41-67``).
"""
from __future__ import annotations

import torch


def _kl_terms(log_p_student: torch.Tensor, p_teacher: torch.Tensor
              ) -> torch.Tensor:
    """Elementwise ``F.kl_div(log_q, p, reduction='none')`` =
    ``p * (log p - log q)`` with the convention ``0 log 0 = 0``."""
    safe_log_p = torch.where(p_teacher > 0,
                             torch.log(p_teacher.clamp_min(1e-38)),
                             torch.zeros_like(p_teacher))
    return p_teacher * safe_log_p - p_teacher * log_p_student


def pred_kd_loss(pred_s: torch.Tensor, pred_t: torch.Tensor,
                 task: str = "grad", per_sample: bool = False
                 ) -> torch.Tensor:
    """Prediction consistency between student and teacher.  grading: both
    are log-probs, the loss is the summed KL terms over the batch size;
    survival: MSE on the hazards."""
    if task == "surv":
        return ((pred_s - pred_t) ** 2).mean()
    terms = _kl_terms(pred_s, torch.exp(pred_t))
    if per_sample:
        return terms.sum(dim=1)
    return terms.sum() / pred_s.shape[0]


def distill_kl(logit_s: torch.Tensor, logit_t: torch.Tensor, T: float,
               per_sample: bool = False) -> torch.Tensor:
    """Hinton KD: ``KL(softmax(t/T) || softmax(s/T)) * T^2`` over the batch."""
    terms = _kl_terms(torch.log_softmax(logit_s / T, dim=1),
                      torch.softmax(logit_t / T, dim=1))
    if per_sample:
        return terms.sum(dim=1) * T ** 2
    return terms.sum() * T ** 2 / logit_s.shape[0]


def sp_loss(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """Similarity preserving: MSE between row-normalised Gram matrices; the
    teacher side gets no gradient."""
    bsz = f_s.shape[0]
    f_s = f_s.reshape(bsz, -1)
    f_t = f_t.detach().reshape(bsz, -1)

    def norm_gram(f):
        g = f @ f.t()
        return g / g.norm(dim=1, keepdim=True).clamp_min(1e-12)

    diff = norm_gram(f_t) - norm_gram(f_s)
    return (diff * diff).sum() / (bsz * bsz)
