"""The port's Cox proportional-hazards fitter against the JAX package's.

Efron's partial log-likelihood, its gradient and Hessian, and the fitted
beta on tied survival times, without and with the ridge penalty, at rtol
1e-10 (float64 Newton iterations in both); ``predict_partial_hazard`` and
``train_cox_cv`` on a fabricated patient frame.
"""
import numpy as np
import pandas as pd
import pytest

from multimodal_learning_tpu.eval import coxph as jcoxph
from multimodal_learning_tpu_torch.eval import coxph
from multimodal_learning_tpu_torch.eval import (fit_coxph,
                                                predict_partial_hazard,
                                                train_cox_cv)

TOL = dict(rtol=1e-10, atol=0)


def _data(seed, n=60, d=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d))
    t = rng.integers(1, 12, n).astype(float)        # many tied times
    e = rng.integers(0, 2, n).astype(float)
    return X, t, e


@pytest.mark.parametrize("penalizer", [0.0, 0.1])
def test_efron_loglik_grad_hess_equal_jax(penalizer):
    X, t, e = _data(3)
    beta = np.array([0.3, -0.2, 0.1])
    got = coxph._efron_loglik_grad_hess(beta, X, t, e, penalizer)
    want = jcoxph._efron_loglik_grad_hess(beta, X, t, e, penalizer)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("penalizer", [0.0, 0.1])
def test_fit_coxph_equals_jax(penalizer):
    X, t, e = _data(5)
    beta = fit_coxph(X, t, e, penalizer=penalizer)
    want = jcoxph.fit_coxph(X, t, e, penalizer=penalizer)
    np.testing.assert_allclose(beta, want, **TOL)
    # at the optimum the fitted objective's gradient vanishes
    _, grad, hess = coxph._efron_loglik_grad_hess(beta, X, t, e, penalizer)
    assert np.linalg.norm(grad) < 1e-4
    assert np.all(np.linalg.eigvalsh(hess) < 0)
    np.testing.assert_allclose(predict_partial_hazard(X, beta),
                               jcoxph.predict_partial_hazard(X, want), **TOL)


@pytest.mark.parametrize("model,normalize", [("cox_omic", False),
                                             ("cox_molgrade", True)])
def test_train_cox_cv_equals_jax(model, normalize):
    rng = np.random.default_rng(7)
    n = 40
    ids = [f"TCGA-{i:02d}" for i in range(n)]
    df = pd.DataFrame({
        "Survival months": rng.integers(1, 30, n).astype(float),
        "censored": rng.integers(0, 2, n).astype(float),
        "Grade": rng.integers(0, 3, n).astype(float),
        "codeletion": rng.integers(0, 2, n).astype(float),
        "idh mutation": rng.integers(0, 2, n).astype(float),
        "geneA": rng.normal(size=n)}, index=ids)
    splits = {k: (ids[:k * 8] + ids[k * 8 + 8:], ids[k * 8:k * 8 + 8]
                  + ["TCGA-absent"]) for k in range(1, 4)}
    got = train_cox_cv(df, splits, model=model, normalize=normalize)
    want = jcoxph.train_cox_cv(df, splits, model=model, normalize=normalize)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        pd.testing.assert_frame_equal(got[2][k], want[2][k], check_exact=False,
                                      rtol=1e-10, atol=0)
        assert list(got[2][k].columns)[0] == "Hazard"
