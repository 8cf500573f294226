"""Feature-space diagnostics — reference S2
``train_test_path_multi_distill.py:160-195``: intra/inter-class cosine
similarity of teacher (fuse) vs student (path) features and the mean
absolute difference between their similarity matrices.

The port's own copy of ``multimodal_learning_tpu/eval/diagnostics.py``
(numpy only)."""
from __future__ import annotations

from typing import Dict

import numpy as np


def _cos_matrix(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    f = f / np.maximum(np.linalg.norm(f, axis=1, keepdims=True), 1e-12)
    return f @ f.T


def intra_inter_similarity(similarity: np.ndarray,
                           labels: np.ndarray):
    """(intra-class mean, inter-class mean) over the full similarity
    matrix (``:160-167``; the diagonal counts as intra, as in the
    reference)."""
    same = np.equal(labels[:, None], labels[None, :])
    return float(similarity[same].mean()), float(similarity[~same].mean())


def evaluate_feature(fuse_features: np.ndarray, path_features: np.ndarray,
                     labels: np.ndarray) -> Dict[str, float]:
    """reference ``evaluate_feature`` (``:170-186``), returned instead of
    printed."""
    fuse_sim = _cos_matrix(fuse_features)
    path_sim = _cos_matrix(path_features)
    t_intra, t_inter = intra_inter_similarity(fuse_sim, labels)
    s_intra, s_inter = intra_inter_similarity(path_sim, labels)
    return {
        "teacher_intra": t_intra, "teacher_inter": t_inter,
        "student_intra": s_intra, "student_inter": s_inter,
        "similarity_diff": float(np.mean(np.abs(fuse_sim - path_sim))),
    }
