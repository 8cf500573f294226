"""Per-fold prediction dumps for offline analysis.

The port's copy of ``save_pred_test``/``load_pred_test`` from
``multimodal_learning_tpu/eval/analysis.py:240-249``; the rest of that
module (patient-level aggregation, percentile log-rank) comes with ROADMAP
A16.
"""
from __future__ import annotations

import pickle


def save_pred_test(path: str, pred_test) -> None:
    """Pickle the per-fold prediction list (layout
    ``train_test_MT.py:452-453``) for offline analysis."""
    with open(path, "wb") as fh:
        pickle.dump(pred_test, fh)


def load_pred_test(path: str):
    with open(path, "rb") as fh:
        return pickle.load(fh)
