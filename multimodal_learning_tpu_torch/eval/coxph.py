"""Cox proportional-hazards baseline fitter (offline analysis tier).

The port's own copy of ``multimodal_learning_tpu/eval/coxph.py``, in
numpy (float64 Newton iterations).

Reference ``MICCAI-2022/core/utils_analysis.py:288-343`` (``trainCox_GBMLGG``)
and ``:966-1029`` (``trainCox_KIRC``) fit ``lifelines.CoxPHFitter`` baselines
(cox_omic / cox_grade / cox_moltype / ...) per CV split, report the test
C-index and log-rank p, and pickle per-split hazards.  lifelines is not a
dependency here, so this module implements the fitter directly:

- Efron tie handling (lifelines' default), Newton-Raphson with step-halving,
  optional ridge ``penalizer`` (unscaled: ``-penalizer/2 * ||beta||^2`` added
  to the partial log-likelihood — matches lifelines at penalizer=0, the
  reference's GBMLGG setting; KIRC uses 1e-4 where the scaling difference is
  far below fold noise).
- ``event`` follows the reference's flipped ``censored`` convention
  (``getCleanGBMLGG`` flips censor so 1 = death observed, SURVEY §2.2).
- the reference ranks patients by ``-predict_partial_hazard``; callers here
  use ``-predict_partial_hazard(X, beta)`` the same way.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _efron_loglik_grad_hess(beta: np.ndarray, X: np.ndarray, t: np.ndarray,
                            e: np.ndarray, penalizer: float):
    """Partial log-likelihood with Efron ties + ridge; returns (ll, g, H)."""
    n, d = X.shape
    order = np.argsort(t, kind="stable")
    X, t, e = X[order], t[order], e[order]
    eta = X @ beta
    eta = eta - eta.max()            # stabilise exp; cancels in ratios
    w = np.exp(eta)

    ll = 0.0
    grad = np.zeros(d)
    hess = np.zeros((d, d))
    # accumulate risk-set sums from the largest time down
    S0 = 0.0
    S1 = np.zeros(d)
    S2 = np.zeros((d, d))
    i = n - 1
    while i >= 0:
        # group of tied times [j0, i]
        j0 = i
        while j0 > 0 and t[j0 - 1] == t[i]:
            j0 -= 1
        idx = np.arange(j0, i + 1)
        wx = w[idx, None] * X[idx]
        S0 += w[idx].sum()
        S1 += wx.sum(0)
        S2 += X[idx].T @ wx
        ev = idx[e[idx] > 0]
        m = len(ev)
        if m:
            wD = w[ev].sum()
            s1D = (w[ev, None] * X[ev]).sum(0)
            s2D = X[ev].T @ (w[ev, None] * X[ev])
            ll += eta[ev].sum()
            grad += X[ev].sum(0)
            for l in range(m):
                f = l / m
                phi = S0 - f * wD
                z1 = S1 - f * s1D
                z2 = S2 - f * s2D
                ll -= np.log(phi)
                grad -= z1 / phi
                hess -= z2 / phi - np.outer(z1, z1) / phi ** 2
        i = j0 - 1
    if penalizer:
        ll -= 0.5 * penalizer * float(beta @ beta)
        grad -= penalizer * beta
        hess -= penalizer * np.eye(d)
    return ll, grad, hess


def fit_coxph(X: np.ndarray, time: np.ndarray, event: np.ndarray,
              penalizer: float = 0.0, max_iter: int = 100,
              tol: float = 1e-7) -> np.ndarray:
    """Fit beta by Newton-Raphson with step-halving.  X [n, d] float,
    time [n], event [n] in {0,1} (1 = observed).  Returns beta [d]."""
    X = np.asarray(X, np.float64)
    time = np.asarray(time, np.float64)
    event = np.asarray(event, np.float64)
    d = X.shape[1]
    beta = np.zeros(d)
    ll, grad, hess = _efron_loglik_grad_hess(beta, X, time, event, penalizer)
    for _ in range(max_iter):
        # damped Newton step (ridge-jitter for singular Hessians)
        try:
            step = np.linalg.solve(hess - 1e-9 * np.eye(d), grad)
        except np.linalg.LinAlgError:
            step = np.linalg.lstsq(hess, grad, rcond=None)[0]
        step = -step
        size = 1.0
        improved = False
        for _ in range(30):
            cand = beta + size * step
            ll2, g2, h2 = _efron_loglik_grad_hess(cand, X, time, event,
                                                  penalizer)
            if np.isfinite(ll2) and ll2 >= ll - 1e-12:
                improved = True
                break
            size *= 0.5
        if not improved:
            # no ascent direction found (e.g. collinear covariates with a
            # singular Hessian) — keep the last accepted beta
            break
        beta, delta = cand, abs(ll2 - ll)
        ll, grad, hess = ll2, g2, h2
        if delta < tol and np.linalg.norm(grad) < 1e-4:
            break
    return beta


def predict_partial_hazard(X: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """exp(X beta) — lifelines ``predict_partial_hazard`` semantics."""
    return np.exp(np.asarray(X, np.float64) @ beta)


# feature sets, reference utils_analysis.py:305-310
COX_MODEL_FEATS = {
    "cox_agegender": ["Age", "Gender"],
    "cox_moltype": ["codeletion", "idh mutation"],
    "cox_grade": ["Grade"],
    "cox_molgrade": ["Grade", "codeletion", "idh mutation"],
    "cox_covariates": ["codeletion", "idh mutation", "Grade", "Age",
                       "Gender", "Histology"],
}


def train_cox_cv(df, splits: Dict[str, Tuple[Sequence, Sequence]],
                 model: str = "cox_omic", penalizer: float = 0.0,
                 normalize: bool = False,
                 duration_col: str = "Survival months",
                 event_col: str = "censored"):
    """Reference ``trainCox_GBMLGG`` flow without lifelines: per split fit on
    the train patients, score the test patients.

    ``df``: pandas DataFrame indexed by patient ID with ``duration_col``,
    ``event_col`` (1 = event, the reference's flipped convention) and
    feature columns.  ``splits``: {split_name: (train_ids, test_ids)}.
    ``model``: a key of :data:`COX_MODEL_FEATS`, or ``cox_omic`` = every
    column except duration/event.  Returns
    ``(cv_cindices, cv_pvals, hazards)`` where ``hazards[k]`` is a DataFrame
    copy of the test patients with a leading ``Hazard`` column
    (= ``-partial_hazard``, the reference's ranking direction).
    """
    from .metrics import concordance_index, cox_log_rank

    if model in ("cox_omic", "cox_all"):
        feats = [c for c in df.columns if c not in (duration_col, event_col)]
    else:
        feats = COX_MODEL_FEATS[model]
    cv_cin: List[float] = []
    cv_p: List[float] = []
    hazards = {}
    for k, (tr_ids, te_ids) in splits.items():
        tr = df.loc[[i for i in tr_ids if i in df.index]]
        te = df.loc[[i for i in te_ids if i in df.index]]
        Xtr, Xte = tr[feats].to_numpy(float), te[feats].to_numpy(float)
        if normalize:
            mu, sd = Xtr.mean(0), Xtr.std(0) + 1e-12
            Xtr, Xte = (Xtr - mu) / sd, (Xte - mu) / sd
        beta = fit_coxph(Xtr, tr[duration_col].to_numpy(float),
                         tr[event_col].to_numpy(float), penalizer=penalizer)
        risk = -predict_partial_hazard(Xte, beta)
        cv_cin.append(concordance_index(
            te[duration_col].to_numpy(float), risk,
            te[event_col].to_numpy(float)))
        cv_p.append(cox_log_rank(
            risk, te[event_col].to_numpy(float),
            te[duration_col].to_numpy(float)))
        out = te.copy()
        out.insert(0, "Hazard", risk)
        hazards[k] = out
    return cv_cin, cv_p, hazards
