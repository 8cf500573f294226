"""Orthogonality (DSN difference) loss.

Port of ``multimodal_learning_tpu/losses/orth.py`` (reference
``MICCAI-2022/CL_utils/orthogonal_loss.py:11-32``): both modality features
L2-normalised per sample (the norms get no gradient), then the mean of the
squared cross-Gram ``(F1^T F2)^2``.
"""
from __future__ import annotations

import torch


def orth_loss(feat1: torch.Tensor, feat2: torch.Tensor) -> torch.Tensor:
    b = feat1.shape[0]
    f1, f2 = feat1.reshape(b, -1), feat2.reshape(b, -1)
    f1 = f1 / (f1.detach().norm(dim=1, keepdim=True) + 1e-6)
    f2 = f2 / (f2.detach().norm(dim=1, keepdim=True) + 1e-6)
    return ((f1.t() @ f2) ** 2).mean()
