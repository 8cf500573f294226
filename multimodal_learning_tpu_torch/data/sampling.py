"""Contrast-pair sampling + omic augmentation (host-side, numpy).

The port's own copy of ``multimodal_learning_tpu/data/sampling.py``: the
same seed gives the same draws in both packages.

Reference ``MICCAI-2022/data_loaders_MT.py``:
- ``Pathomic_InstanceSample`` builds per-class positive/negative index tables
  (``:190-205``) and per item draws ``pos_idx`` by ``pos_mode``
  exact/relax/multi_pos (``:229-241``) plus ``nce_k`` negatives from other
  classes (``:243-244``), emitting ``sample_idx = [pos | neg]``.
- S2 adds ``neg_mode`` all_others/diff_class/both_models
  (``MIA 2023/stage2_unimodal_student/data_loaders_MT.py:218-246``).
- ``omic_transform`` (``:24-43``): Bernoulli-drop or VIME column-shuffle.

Index generation is integer work on tiny tables; it stays on host (inside the
loader workers) and ships with the batch.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def omic_transform(omic: np.ndarray, transform: str = "drop",
                   rate: float = 0.2,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    mask = rng.binomial(1, rate, omic.shape)
    if transform == "drop":
        return (omic * (1.0 - mask)).astype(np.float32)
    if transform == "vime":
        no, dim = omic.shape
        x_bar = np.zeros_like(omic)
        for i in range(dim):
            x_bar[:, i] = omic[rng.permutation(no), i]
        return (omic * (1 - mask) + x_bar * mask).astype(np.float32)
    raise NotImplementedError(transform)


class ContrastSampler:
    """Per-sample positive/negative index draws for the CRD banks."""

    def __init__(self, labels: np.ndarray, n_classes: int, task: str,
                 nce_p: int, nce_k: int, pos_mode: str,
                 neg_mode: str = "diff_class", seed: int = 0,
                 distill: str = "crd"):
        self.task = task
        self.distill = distill
        self.p = nce_p
        self.k = nce_k
        self.pos_mode = pos_mode
        self.neg_mode = neg_mode
        self.n = len(labels)
        self.rng = np.random.default_rng(seed)
        self.labels = labels.astype(int)
        if task == "grad":
            self.cls_positive = [np.where(self.labels == c)[0]
                                 for c in range(n_classes)]
            self.cls_negative = [np.where(self.labels != c)[0]
                                 for c in range(n_classes)]

    @property
    def n_pos(self) -> int:
        if self.task == "surv":
            return 1
        return {"exact": 1, "relax": 1, "multi_pos": self.p}[self.pos_mode]

    @property
    def n_neg(self) -> int:
        return 2 * self.k if self.neg_mode == "both_models" else self.k

    @property
    def sample_width(self) -> int:
        if self.distill == "hkd":
            return self.n_neg  # hkd uses only negatives (stage2 loader :240)
        return self.n_pos + self.n_neg

    def draw(self, index: int) -> np.ndarray:
        """sample_idx for one anchor (``data_loaders_MT.py:222-249``)."""
        if self.task == "surv":
            pos_idx = np.asarray([index])
            all_neg = np.delete(np.arange(self.n), index)
            neg_idx = self.rng.choice(all_neg, self.k,
                                      replace=self.k > len(all_neg))
            return np.concatenate([pos_idx, neg_idx])

        g = self.labels[index]
        if self.pos_mode == "exact":
            pos_idx = np.asarray([index])
        elif self.pos_mode == "relax":
            pos_idx = self.rng.choice(self.cls_positive[g], 1)
        elif self.pos_mode == "multi_pos":
            pool = self.cls_positive[g]
            # the reference crashes when p > class population; sample with
            # replacement instead so small datasets work.
            pos_idx = self.rng.choice(pool, self.p,
                                      replace=self.p > len(pool))
            pos_idx[0] = index  # anchor always included (:239)
        else:
            raise NotImplementedError(self.pos_mode)

        # neg_mode semantics from the S2 loader (stage2
        # data_loaders_MT.py:218-237); the MICCAI/MIA22 loaders hardcode the
        # "diff_class" behaviour (data_loaders_MT.py:243-244).
        def _draw(pool):
            return self.rng.choice(pool, self.k, replace=self.k > len(pool))

        if self.neg_mode == "all_others":
            neg_idx = _draw(np.delete(np.arange(self.n), index))
        elif self.neg_mode == "diff_class":
            neg_idx = _draw(self.cls_negative[g])
        elif self.neg_mode == "both_models":
            neg_idx = np.concatenate([
                _draw(np.delete(np.arange(self.n), index)),
                _draw(self.cls_negative[g])])
        else:
            raise NotImplementedError(self.neg_mode)
        if self.distill == "hkd":
            return neg_idx
        return np.concatenate([pos_idx, neg_idx])

    def draw_batch(self, indices: np.ndarray) -> np.ndarray:
        return np.stack([self.draw(int(i)) for i in indices]).astype(np.int32)
