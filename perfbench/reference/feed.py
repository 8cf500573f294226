"""The reference's own batches: the crops and contrast samples of a
fold's train loader, worked out again from the ROIs and the seeds.

The recipes' loader (reference ``data_loaders_MT.py:47-77``, ``:190-249``
and the MIA-2023 stage-2 ``:218-246``; ``torch.utils.data.DataLoader``
with ``shuffle=True, drop_last=True``): one shuffle of the rows per epoch
from the loader's generator, per batch first the contrast samples of its
rows, then one 63-bit crop seed per row; per row ``n_views`` random
crops, each a top then a left offset.  numpy only.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np


class Sampler:
    """Per row ``[its positive | nce_k negatives]`` (``pos_mode`` exact;
    negatives from all other rows, ``all_others``, or from the other
    classes, ``diff_class``), with replacement when the pool is smaller
    than ``nce_k``."""

    def __init__(self, labels: np.ndarray, n_classes: int, nce_k: int,
                 neg_mode: str, seed: int):
        self.labels = labels.astype(int)
        self.n, self.k, self.neg_mode = len(labels), nce_k, neg_mode
        self.rng = np.random.default_rng(seed)
        self.others = [np.where(self.labels != c)[0]
                       for c in range(n_classes)]

    def row(self, i: int) -> np.ndarray:
        if self.neg_mode == "all_others":
            pool = np.delete(np.arange(self.n), i)
        elif self.neg_mode == "diff_class":
            pool = self.others[self.labels[i]]
        else:
            raise NotImplementedError(self.neg_mode)
        neg = self.rng.choice(pool, self.k, replace=self.k > len(pool))
        return np.concatenate([np.asarray([i]), neg])


def batches(rois: np.ndarray, tab: Dict[str, np.ndarray], batch_size: int,
            n_views: int, crop: int, seed: int,
            sampler: Optional[Sampler] = None) -> Iterator[Dict]:
    """The loader's batches, epoch after epoch."""
    rng = np.random.default_rng(seed)
    n, h, w = rois.shape[:3]
    while True:
        order = np.arange(n)
        rng.shuffle(order)
        for b in range(n // batch_size):
            idx = order[b * batch_size:(b + 1) * batch_size]
            sample = (np.stack([sampler.row(int(i)) for i in idx])
                      if sampler is not None else None)
            row_seeds = rng.integers(0, 2 ** 63, size=len(idx))
            views = np.empty((len(idx), n_views, crop, crop, 3), np.uint8)
            for j, (i, s) in enumerate(zip(idx, row_seeds)):
                r = np.random.default_rng(int(s))
                for v in range(n_views):
                    top = r.integers(0, h - crop + 1)
                    left = r.integers(0, w - crop + 1)
                    views[j, v] = rois[i, top:top + crop, left:left + crop]
            out = {"index": idx.astype(np.int64), "path_views": views,
                   "omic": tab["x_omic"][idx], "g": tab["g"][idx]}
            if sample is not None:
                out["sample_idx"] = sample.astype(np.int64)
            yield out
