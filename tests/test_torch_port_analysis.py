"""The port's offline patient-level analysis against the JAX package's.

Every function of ``eval/analysis.py`` on the same seeded numpy inputs in
both packages, compared exactly (``np.array_equal``, or
``pd.testing.assert_frame_equal`` with ``check_exact``): several patches per
patient under ``max``/``mean``/``p0.75``, tied hazards under ``p0.25``, a
fold that lacks a class, a single fold (CI zeros), the registration
asserts, and the pooled survival frame with metadata and z-scoring.

``grad_evaluation`` and ``roi_evaluation`` end in the grading metrics,
which the JAX package takes from scikit-learn and the port computes itself
(held to scikit-learn at atol 1e-12 in ``test_torch_port_data.py``).  They
are compared exactly with the JAX package's metric function put into the
port's module, which holds this module's own code bit for bit, and again
with the port's own metrics at that same atol 1e-12.
"""
import numpy as np
import pandas as pd
import pytest

from multimodal_learning_tpu.eval import analysis as janalysis
from multimodal_learning_tpu.eval import metrics as jmetrics
from multimodal_learning_tpu_torch.eval import analysis

METRIC_ATOL = 1e-12


def _folds(seed, n_folds=3, n_pat=12, max_patches=4, lack_class=None):
    """{fold: {"probs", "gt", "patnames"}} with 1..max_patches patches per
    patient (rows shuffled) and probabilities on a coarse grid so that
    patches tie."""
    rng = np.random.default_rng(seed)
    folds = {}
    for k in range(1, n_folds + 1):
        classes = [c for c in range(3) if c != lack_class]
        gt_pat = np.r_[classes, rng.choice(classes, n_pat - len(classes))]
        reps = rng.integers(1, max_patches + 1, n_pat)
        gt = np.repeat(gt_pat, reps)
        pats = np.repeat([f"TCGA-{k}{i:02d}" for i in range(n_pat)], reps)
        probs = rng.integers(0, 6, (len(gt), 3)) / 5.0 + 0.01
        # keep every class among the argmax predictions
        probs[:3] = np.eye(3)
        order = rng.permutation(len(gt))
        folds[k] = {"probs": probs[order].astype(np.float32),
                    "gt": gt[order], "patnames": pats[order]}
    return folds


def _surv_folds(seed, n_folds=3, n_pat=10):
    """{fold: {"hazard", "t", "e", "g", "patnames"}} with tied hazards and
    tied survival times; per-patient t/e/g repeated over its patches."""
    rng = np.random.default_rng(seed)
    folds = {}
    for k in range(1, n_folds + 1):
        reps = rng.integers(1, 4, n_pat)
        t = np.repeat(rng.integers(1, 8, n_pat) * 6.0, reps)
        e = np.repeat(rng.integers(0, 2, n_pat), reps)
        g = np.repeat(rng.integers(0, 3, n_pat), reps)
        pats = np.repeat([f"TCGA-{k}{i:02d}" for i in range(n_pat)], reps)
        hz = rng.integers(0, 5, len(t)) / 4.0 - 0.5
        folds[k] = {"hazard": hz, "t": t, "e": e, "g": g, "patnames": pats}
    return folds


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)


def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=0, atol=METRIC_ATOL)


def test_ci_and_percentile_equal_jax():
    rng = np.random.default_rng(1)
    for vals in (rng.uniform(0.5, 0.9, 5), [0.8, 0.8, 0.8], [0.2, 0.7]):
        assert analysis.ci_pm(vals) == janalysis.ci_pm(vals)
        assert analysis.ci_pm(vals, 0.9) == janalysis.ci_pm(vals, 0.9)
        _same(analysis.ci_interval(vals), janalysis.ci_interval(vals))
    x = rng.normal(size=17)
    for q in (0.25, 0.5, 0.75):
        # the documented q * 100 (PARITY.md): the 75th percentile
        assert analysis.p_percentile(q)(x) == janalysis.p_percentile(q)(x)
    assert analysis.p_percentile(0.75)(x) == np.percentile(x, 75)


@pytest.mark.parametrize("agg", ["max", "mean", "p0.75"])
def test_patient_aggregation_equals_jax(agg):
    d = _folds(3)[1]
    got = analysis.aggregate_patient_predictions(d["probs"], d["patnames"],
                                                 agg)
    want = janalysis.aggregate_patient_predictions(d["probs"], d["patnames"],
                                                   agg)
    _same(got, want)
    assert len(got[1]) == 12          # patients, not patches


@pytest.mark.parametrize("case", ["several_patches", "lacks_class",
                                  "one_fold"])
@pytest.mark.parametrize("agg", ["max", "mean", "p0.75"])
def test_grad_evaluation_equals_jax(monkeypatch, case, agg):
    folds = {"several_patches": lambda: _folds(5),
             "lacks_class": lambda: _folds(6, lack_class=1),
             "one_fold": lambda: _folds(7, n_folds=1)}[case]()
    want = janalysis.grad_evaluation(folds, 3, agg_type=agg)
    own = analysis.grad_evaluation(folds, 3, agg_type=agg)
    _close(own, want)
    monkeypatch.setattr(analysis, "grading_metrics",
                        jmetrics.grading_metrics)
    _same(analysis.grad_evaluation(folds, 3, agg_type=agg), want)
    if case == "one_fold":
        assert want["ci95"] == [0.0] * 4


@pytest.mark.parametrize("n_roi", [8, 3])
def test_roi_evaluation_equals_jax(monkeypatch, n_roi):
    """Three ROIs may leave a class out of the truth."""
    rng = np.random.default_rng(11 + n_roi)
    gt = np.repeat(rng.integers(0, 3, n_roi), 9)
    probs = rng.integers(0, 6, (n_roi * 9 + 4, 3)) / 5.0 + 0.01
    probs[:3] = np.eye(3)
    gt = np.r_[gt, [0, 1, 2, 0]]           # a ragged tail is cut
    want = janalysis.roi_evaluation(probs, gt)
    _close(analysis.roi_evaluation(probs, gt), want)
    monkeypatch.setattr(analysis, "grading_metrics",
                        jmetrics.grading_metrics)
    _same(analysis.roi_evaluation(probs, gt), want)


@pytest.mark.parametrize("agg", ["mean", "median", "max", "p0.25", "p0.75"])
def test_hazard_aggregation_equals_jax(agg):
    d = _surv_folds(13)[1]
    args = (d["hazard"], d["t"], d["e"], d["patnames"], agg)
    _same(analysis.aggregate_patient_hazards(*args),
          janalysis.aggregate_patient_hazards(*args))


@pytest.mark.parametrize("agg", ["Hazard_mean", "Hazard_p0.25", "max"])
def test_agg_hazard_cv_equals_jax(agg):
    folds = _surv_folds(17)
    _same(analysis.get_agg_hazard_cv(folds, agg),
          janalysis.get_agg_hazard_cv(folds, agg))


def test_hazard2grade_and_logrank_equal_jax():
    d = _surv_folds(19, n_folds=1, n_pat=40)[1]
    for h in (-1.0, 0.0, 0.25, 3.0):
        assert (analysis.hazard2grade(h, [0.0, 0.25])
                == janalysis.hazard2grade(h, [0.0, 0.25]))
    events = np.ones_like(d["e"])
    for pct, e in (((50,), events), ((33, 66), d["e"]),
                   ((26, 51, 76), d["e"])):
        got = analysis.surv_logrank_by_percentile(d["hazard"], e, d["t"], pct)
        assert got == janalysis.surv_logrank_by_percentile(d["hazard"], e,
                                                           d["t"], pct)


def _split_and_pred(seed, n=12):
    rng = np.random.default_rng(seed)
    pats = [f"TCGA-{i:02d}" for i in range(n)]
    split = {"test": {"t": rng.integers(1, 50, n).astype(float),
                      "e": rng.integers(0, 2, n), "x_patname": pats,
                      "g": rng.integers(0, 3, n)}}
    d = split["test"]
    pred = [None, None, None, d["t"].astype(np.float32),
            d["e"].astype(np.float32), None, None, None, d["g"]]
    meta = pd.DataFrame({"Survival months": d["t"], "censored": d["e"],
                         "Grade": d["g"],
                         "Histomolecular subtype": rng.choice(
                             ["idhwt_ATC", "idhmut_ATC", "ODG"], n)},
                        index=pd.Index(pats, name="TCGA ID"))
    return split, pred, meta


@pytest.mark.parametrize("fault", [None, "t", "e", "meta_t", "meta_e",
                                   "meta_grade"])
def test_register_predictions_equals_jax(fault):
    split, pred, meta = _split_and_pred(23)
    if fault == "t":
        pred[3] = pred[3] + 1
    elif fault == "e":
        pred[4] = 1 - pred[4]
    elif fault == "meta_t":
        meta["Survival months"] = meta["Survival months"] + 1
    elif fault == "meta_e":
        meta["censored"] = 1 - meta["censored"]
    elif fault == "meta_grade":
        meta["Grade"] = (meta["Grade"] + 1) % 3
    outcomes = []
    for mod in (analysis, janalysis):
        try:
            outcomes.append(("ok", mod.register_predictions(
                pred, split, "test", metadata=meta)))
        except AssertionError as err:
            outcomes.append(("assert", str(err)))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][0] == ("ok" if fault is None else "assert")
    if fault is None:
        assert outcomes[0][1] == split["test"]["x_patname"]


@pytest.mark.parametrize("agg,zscore,with_meta", [
    ("mean", False, False), ("Hazard_p0.25", True, True),
    ("median", True, False), ("p0.75", False, True)])
def test_pool_surv_cv_equals_jax(agg, zscore, with_meta):
    folds = _surv_folds(29)
    meta = None
    if with_meta:
        pats = sorted({p for d in folds.values() for p in d["patnames"]})
        rng = np.random.default_rng(31)
        meta = pd.DataFrame({
            "Survival months": 0.0, "censored": 0.0, "Grade": 0,
            "Histomolecular subtype": rng.choice(["idhwt_ATC", "ODG"],
                                                 len(pats)),
            "Age": rng.integers(20, 80, len(pats))},
            index=pd.Index(pats, name="TCGA ID"))
    got = analysis.pool_surv_cv(folds, agg, zscore=zscore, metadata=meta)
    want = janalysis.pool_surv_cv(folds, agg, zscore=zscore, metadata=meta)
    assert isinstance(got, pd.DataFrame)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    if with_meta:
        assert "Histomolecular subtype" in got.columns
