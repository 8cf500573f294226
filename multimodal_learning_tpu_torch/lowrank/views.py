"""Views and adjacencies of the M3LR t-SVD constraint, PyTorch.

Port of ``multimodal_learning_tpu/lowrank/views.py`` (reference
``MIA 2022/train_test_tSVD.py``): per view a row-normalised Gram
(``update_adj_tensor``, ``:57-70``), and the view sets for n_views 2, 4,
6 and 8, which mix the student's, the EMA's, the fused and cross-modal
mixup features (``:300-360``).  The fused view is detached (``:311``); the
EMA features carry no gradient by construction.
"""
from __future__ import annotations

from typing import List, Tuple

import torch


def update_adj_tensor(feats: List[torch.Tensor]) -> torch.Tensor:
    """[V] list of [B, D] -> [V, B, B] row-normalised Grams."""

    def one(f):
        g = f @ f.t()
        return g / torch.linalg.vector_norm(g, dim=1,
                                            keepdim=True).clamp_min(1e-12)

    return torch.stack([one(f) for f in feats])


def build_view_features(n_views: int, fuse, ema_fuse, path, ema_path, omic,
                        ema_omic) -> Tuple[List[torch.Tensor],
                                           List[torch.Tensor]]:
    """(path-modality views, omic-modality views) (``:300-360``)."""
    fuse_d = fuse.detach()
    norm_path = ema_path / ema_path.max()
    norm_omic = ema_omic / ema_omic.max()
    base1 = [fuse_d, ema_fuse, path, ema_path]
    base2 = [fuse_d, ema_fuse, omic, ema_omic]
    if n_views == 2:
        return [path, ema_path], [omic, ema_omic]
    if n_views in (4, 6, 8):
        ws = {4: (), 6: (0.9, 0.8), 8: (0.9, 0.8, 0.7, 0.6)}[n_views]
        return (base1 + [w * norm_path + (1 - w) * norm_omic for w in ws],
                base2 + [w * norm_omic + (1 - w) * norm_path for w in ws])
    raise NotImplementedError(f"n_views={n_views}")
