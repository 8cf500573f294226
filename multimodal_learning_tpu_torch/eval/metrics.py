"""Evaluation metrics (host-side numpy and scipy).

The port's own copy of ``multimodal_learning_tpu/eval/metrics.py``
(reference grading metrics ``MICCAI-2022/train_test_MT.py:473-486``, the
MIA-2023 extended report, and the survival statistics of
``MICCAI-2022/utils.py:386-425``).  The JAX package takes ROC-AUC, average
precision, F1, recall, precision, Cohen's kappa and MCC from scikit-learn;
the machine that runs the port has no scikit-learn, so they are written
here with scikit-learn's definitions: labels are those present in either
the truth or the prediction, ties in the scores share credit (ROC-AUC) or
one threshold (average precision), and a ratio with a zero denominator is
0.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
from scipy import stats


def one_hot(labels: np.ndarray, n_classes: int) -> np.ndarray:
    out = np.zeros((len(labels), n_classes), dtype=np.float32)
    out[np.arange(len(labels)), labels.astype(int)] = 1.0
    return out


def _roc_auc(y: np.ndarray, s: np.ndarray) -> float:
    """Binary ROC-AUC: the Mann-Whitney statistic, ties counting 1/2 (the
    area under scikit-learn's ROC curve)."""
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        raise ValueError("Only one class present in y_true. ROC AUC score "
                         "is not defined in that case.")
    ranks = stats.rankdata(s)  # average ranks over ties
    return float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _average_precision(y: np.ndarray, s: np.ndarray) -> float:
    """Binary average precision, sum_n (R_n - R_{n-1}) P_n over the
    distinct score thresholds in decreasing order."""
    order = np.argsort(s, kind="mergesort")[::-1]
    s, y = s[order], y[order]
    last = np.r_[np.where(np.diff(s))[0], len(s) - 1]
    tps = np.cumsum(y, dtype=np.float64)[last]
    fps = 1.0 + last - tps
    if tps[-1] == 0:
        return 0.0
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def _counts(gt: np.ndarray, pred: np.ndarray):
    """(labels, confusion matrix [true, predicted]) over the labels present
    in either array."""
    labels = np.unique(np.concatenate([gt, pred]))
    t = np.searchsorted(labels, gt)
    p = np.searchsorted(labels, pred)
    cm = np.zeros((len(labels), len(labels)), dtype=np.int64)
    np.add.at(cm, (t, p), 1)
    return labels, cm


def _ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.divide(num, den, out=np.zeros_like(num), where=den != 0)


def _per_class(gt: np.ndarray, pred: np.ndarray):
    """Per-class (precision, recall, F1) over the labels present."""
    _, cm = _counts(gt, pred)
    tp = np.diag(cm).astype(np.float64)
    n_pred, n_true = cm.sum(axis=0), cm.sum(axis=1)
    return (_ratio(tp, n_pred), _ratio(tp, n_true),
            _ratio(2 * tp, n_pred + n_true))


def _f1_micro(gt: np.ndarray, pred: np.ndarray) -> float:
    _, cm = _counts(gt, pred)
    tp = float(np.trace(cm))
    fp = fn = float(cm.sum()) - tp
    return float(_ratio(2 * tp, 2 * tp + fp + fn))


def cohen_kappa(gt: np.ndarray, pred: np.ndarray) -> float:
    """scikit-learn's ``cohen_kappa_score`` (unweighted)."""
    _, cm = _counts(gt, pred)
    sum0, sum1 = cm.sum(axis=0), cm.sum(axis=1)
    expected = np.outer(sum0, sum1) / np.sum(sum0)
    w = np.ones_like(cm) - np.eye(len(cm), dtype=cm.dtype)
    return float(1 - np.sum(w * cm) / np.sum(w * expected))


def matthews_corrcoef(gt: np.ndarray, pred: np.ndarray) -> float:
    """scikit-learn's multiclass ``matthews_corrcoef``."""
    _, cm = _counts(gt, pred)
    t_sum = cm.sum(axis=1, dtype=np.float64)
    p_sum = cm.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(cm, dtype=np.float64)
    n = p_sum.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n ** 2 - np.dot(t_sum, t_sum)
    if cov_ypyp * cov_ytyt == 0:
        return 0.0
    return float(cov_ytyp / np.sqrt(cov_ytyt * cov_ypyp))


def grading_metrics(y_label: np.ndarray, y_pred: np.ndarray,
                    avg: str = "micro") -> Tuple[float, float, float, float]:
    """(rocauc, ap, f1_micro, f1_gradeIV); ``y_label`` one-hot, ``y_pred``
    (log-)probabilities (``train_test_MT.py:473-486``; monotone transforms
    of the probabilities leave the rank-based metrics unchanged).  Micro
    ROC-AUC and AP pool every (sample, class) score, as scikit-learn's
    ``average="micro"`` does on one-hot labels."""
    if avg != "micro":
        raise NotImplementedError(f"average={avg!r}: only 'micro' is used")
    y = np.asarray(y_label).ravel()
    s = np.asarray(y_pred, dtype=np.float64).ravel()
    gt = np.argmax(y_label, axis=1)
    pred = np.argmax(y_pred, axis=1)
    return (_roc_auc(y, s), _average_precision(y, s), _f1_micro(gt, pred),
            float(_per_class(gt, pred)[2][2]))


def extended_grading_metrics(y_label: np.ndarray, y_pred: np.ndarray):
    """9-metric report of the MIA-2023 code
    (``train_test_path_multi_distill.py:655-672``): micro AUC/AP/F1/F1-IV
    plus macro F1, macro recall, macro precision, Cohen kappa, MCC."""
    rocauc, ap, f1_micro, f1_iv = grading_metrics(y_label, y_pred)
    gt = np.argmax(y_label, axis=1)
    pred = np.argmax(y_pred, axis=1)
    precision, recall, f1 = _per_class(gt, pred)
    return {
        "rocauc": rocauc, "ap": ap, "f1_micro": f1_micro, "f1_gradeIV": f1_iv,
        "f1_macro": float(f1.mean()), "recall_macro": float(recall.mean()),
        "precision_macro": float(precision.mean()),
        "kappa": cohen_kappa(gt, pred), "mcc": matthews_corrcoef(gt, pred),
    }


def concordance_index(event_times: np.ndarray, predicted_scores: np.ndarray,
                      event_observed: np.ndarray) -> float:
    """Harrell's C-index, lifelines semantics
    (``CIndex_lifeline``, ``utils.py:424-425`` calls
    ``concordance_index(survtime, -hazards, censor)``).

    Admissible pairs: (i, j) with t_i < t_j and event_i = 1, plus tied-time
    pairs where exactly one has an event.  Tied predictions get 0.5.
    """
    t = np.asarray(event_times, dtype=float)
    s = np.asarray(predicted_scores, dtype=float)
    e = np.asarray(event_observed, dtype=int)
    n = len(t)
    num, den = 0.0, 0.0
    for i in range(n):
        if e[i] != 1:
            continue
        # pairs where i experienced the event first: concordant when the
        # earlier event has the LOWER predicted score (higher score = longer
        # predicted survival; the caller passes -hazard)
        later = t > t[i]
        den += later.sum()
        num += (s[later] > s[i]).sum() + 0.5 * (s[later] == s[i]).sum()
        # tied times, other is censored: the censored one outlived i
        tied = (t == t[i]) & (e == 0)
        den += tied.sum()
        num += (s[tied] > s[i]).sum() + 0.5 * (s[tied] == s[i]).sum()
        # tied times, both events (counted once per pair): full credit when
        # the predictions are also tied, half otherwise — lifelines' rule.
        tied_ev = (t == t[i]) & (e == 1)
        tied_ev[i] = False
        den += 0.5 * tied_ev.sum()
        num += 0.5 * ((s[tied_ev] == s[i]).sum() * 1.0
                      + (s[tied_ev] != s[i]).sum() * 0.5)
    if den == 0:
        return 0.5
    return num / den


def accuracy_cox(hazards: np.ndarray, censor: np.ndarray) -> float:
    """Median-split hazard dichotomisation accuracy (``utils.py:386-392``)."""
    median = np.median(hazards)
    dichot = (hazards > median).astype(int)
    return float(np.sum(dichot == censor) / len(censor))


def cox_log_rank(hazards: np.ndarray, censor: np.ndarray,
                 survtime: np.ndarray) -> float:
    """Two-group log-rank test p-value after median hazard split
    (``utils.py:395-406``).  Standard Mantel-Haenszel statistic."""
    median = np.median(hazards)
    grp = (hazards > median).astype(int)
    times = np.unique(survtime[censor == 1])
    o_minus_e, var = 0.0, 0.0
    for tt in times:
        at_risk = survtime >= tt
        n = at_risk.sum()
        n1 = (at_risk & (grp == 1)).sum()
        d = ((survtime == tt) & (censor == 1)).sum()
        d1 = ((survtime == tt) & (censor == 1) & (grp == 1)).sum()
        if n <= 1:
            continue
        e1 = d * n1 / n
        v = d * (n1 / n) * (1 - n1 / n) * (n - d) / (n - 1)
        o_minus_e += d1 - e1
        var += v
    if var <= 0:
        return 1.0
    chi2 = o_minus_e ** 2 / var
    return float(stats.chi2.sf(chi2, df=1))


def multivariate_logrank(groups: np.ndarray, censor: np.ndarray,
                         survtime: np.ndarray) -> float:
    """k-group log-rank test p-value (the lifelines
    ``multivariate_logrank_test`` used by the reference's percentile
    stratification plots, ``core/utils_analysis.py:398-419,921-945``).
    Chi-square statistic with k-1 dof from the per-group observed-minus-
    expected event counts and their covariance."""
    groups = np.asarray(groups)
    labels = np.unique(groups)
    k = len(labels)
    if k < 2:
        return 1.0
    gidx = np.searchsorted(labels, groups)
    times = np.unique(survtime[censor == 1])
    z = np.zeros(k)
    V = np.zeros((k, k))
    for tt in times:
        at_risk = survtime >= tt
        n = at_risk.sum()
        if n <= 1:
            continue
        d = ((survtime == tt) & (censor == 1)).sum()
        nj = np.array([(at_risk & (gidx == j)).sum() for j in range(k)],
                      float)
        dj = np.array([((survtime == tt) & (censor == 1)
                        & (gidx == j)).sum() for j in range(k)], float)
        ej = d * nj / n
        z += dj - ej
        frac = nj / n
        V += (d * (n - d) / (n - 1)) * (np.diag(frac) - np.outer(frac, frac))
    # drop one group (covariance is singular by construction)
    z_r, V_r = z[:-1], V[:-1, :-1]
    try:
        chi2 = float(z_r @ np.linalg.solve(V_r, z_r))
    except np.linalg.LinAlgError:
        return 1.0
    return float(stats.chi2.sf(chi2, df=k - 1))
