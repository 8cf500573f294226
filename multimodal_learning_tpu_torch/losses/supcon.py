"""Supervised contrastive loss (Khosla et al. 2020), in PyTorch.

Port of ``multimodal_learning_tpu/losses/supcon.py`` (reference
``MIA 2022/CL_utils/supcon_loss.py:11-99``): ``features`` [B, V, ...]
(V views), optional integer ``labels`` [B] or an explicit ``mask`` [B, B];
contrast modes ``all`` and ``one``.
"""
from __future__ import annotations

from typing import Optional

import torch


def supcon_loss(features: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None,
                temperature: float = 0.07, base_temperature: float = 0.07,
                contrast_mode: str = "all") -> torch.Tensor:
    if features.dim() < 3:
        raise ValueError("`features` needs to be [bsz, n_views, ...]")
    b, v = features.shape[:2]
    feats = features.reshape(b, v, -1)
    dev = features.device

    if labels is not None and mask is not None:
        raise ValueError("Cannot define both `labels` and `mask`")
    if labels is None and mask is None:
        mask = torch.eye(b, device=dev)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        mask = (labels == labels.t()).float()
    else:
        mask = mask.float()

    contrast = feats.transpose(0, 1).reshape(b * v, -1)
    if contrast_mode == "one":
        anchor, anchor_count = feats[:, 0], 1
    elif contrast_mode == "all":
        anchor, anchor_count = contrast, v
    else:
        raise ValueError(f"Unknown mode: {contrast_mode}")

    logits = anchor @ contrast.t() / temperature
    logits = logits - logits.amax(dim=1, keepdim=True).detach()
    mask = mask.repeat(anchor_count, v)
    logits_mask = 1.0 - torch.eye(b * anchor_count, b * v, device=dev)
    mask = mask * logits_mask

    exp_logits = torch.exp(logits) * logits_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = ((mask * log_prob).sum(dim=1)
                         / mask.sum(dim=1).clamp_min(1e-12))
    loss = -(temperature / base_temperature) * mean_log_prob_pos
    return loss.reshape(anchor_count, b).mean()
