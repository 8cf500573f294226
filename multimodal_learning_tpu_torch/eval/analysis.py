"""Offline patient-level evaluation and aggregation.

The port's own copy of ``multimodal_learning_tpu/eval/analysis.py`` (numpy,
scipy and pandas; the same calls, so the results are bitwise equal).
Reference ``MICCAI-2022/core/utils_analysis.py`` (1182 LoC) +
``evaluation_GBMLGG.py`` + ``MIA 2022/ROI_evaluation.py``:

- per-fold prediction pickles are registered to TCGA patient IDs and
  aggregated patch -> patient by max / mean / 0.75-percentile
  (``getPredAggGrad_GBMLGG``, ``:79-135``)
- fold metrics with 95% confidence intervals (``calcAggGradMetrics``,
  ``:152-167``; ``CI_pm``, ``utils.py:567-573``)
- ROI-level evaluation: reshape (Nx9, 3) -> (N, 9, 3) and average the 9
  patches per ROI (``ROI_evaluation.py:46-66``)
- survival aggregation (``getAggHazardCV`` analogue) and ``hazard2grade``
  (``utils.py:546-551``)

Our prediction layout keeps arrays aligned with the split arrays end to end,
so the reference's assert-based registration dance reduces to a groupby.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy import stats

from .metrics import grading_metrics, one_hot


def ci_pm(data: Sequence[float], confidence: float = 0.95) -> float:
    """Half-width of the t-distribution CI (``utils.py:567-573``)."""
    a = np.asarray(data, dtype=float)
    se = stats.sem(a)
    return float(se * stats.t.ppf((1 + confidence) / 2.0, len(a) - 1))


def ci_interval(data: Sequence[float], confidence: float = 0.95):
    a = np.asarray(data, dtype=float)
    m = float(np.mean(a))
    h = ci_pm(data, confidence)
    return m - h, m + h


def p_percentile(q: float):
    """Percentile aggregator for ``agg_type='p0.75'`` etc.

    DELIBERATE deviation from the reference: ``utils_analysis.py``'s
    ``p(0.75)`` calls ``np.percentile(x, 0.75)`` — the *0.75th* percentile
    (essentially the min), an apparent q-vs-percent bug.  Here ``q`` is the
    quantile and is scaled by 100, so ``p0.75`` means the 75th percentile.
    Bit-parity comparisons of Hazard_p0.75/Hazard_p0.25 aggregates against
    the reference will therefore differ (see PARITY.md deviations table)."""
    def percentile_(x):
        return np.percentile(x, q * 100)
    return percentile_


def aggregate_patient_predictions(
        probs: np.ndarray, patnames: Sequence[str],
        agg_type: str = "max") -> Tuple[np.ndarray, List[str]]:
    """Aggregate patch/ROI probabilities to patient level.

    probs [N, C] aligned with patnames [N]; agg in {max, mean, p0.75}
    (``utils_analysis.py:121-127``).  Returns ([P, C], patient ids)."""
    import pandas as pd
    df = pd.DataFrame(probs, index=list(patnames))
    if agg_type == "p0.75":
        agg = df.groupby(level=0).quantile(0.75)
    else:
        agg = df.groupby(level=0).agg(agg_type)
    return agg.to_numpy(), list(agg.index)


def grad_evaluation(pred_folds: Dict[int, Dict], n_classes: int = 3,
                    agg_type: str = "max", avg: str = "micro"):
    """Patient-level grading evaluation across folds
    (``evaluation_GBMLGG.grad_evaluation`` + ``calcAggGradMetrics``).

    pred_folds: {fold: {"probs": [N, C], "gt": [N], "patnames": [N]}}.
    Returns dict with per-fold metrics and mean +- 95% CI rows.
    """
    rocs, aps, f1s, f1ivs = [], [], [], []
    for k, d in sorted(pred_folds.items()):
        probs, pats = aggregate_patient_predictions(
            np.asarray(d["probs"]), d["patnames"], agg_type)
        import pandas as pd
        gt_df = pd.Series(np.asarray(d["gt"]), index=list(d["patnames"]))
        gt = gt_df.groupby(level=0).first().loc[pats].to_numpy()
        oh = one_hot(gt, n_classes)
        r, a, f, fi = grading_metrics(oh, probs, avg)
        rocs.append(r)
        aps.append(a)
        f1s.append(f)
        f1ivs.append(fi)
    return {
        "per_fold": {"rocauc": rocs, "ap": aps, "f1_micro": f1s,
                     "f1_gradeIV": f1ivs},
        "mean": [np.mean(rocs), np.mean(aps), np.mean(f1s), np.mean(f1ivs)],
        "ci95": [ci_pm(rocs), ci_pm(aps), ci_pm(f1s), ci_pm(f1ivs)]
        if len(rocs) > 1 else [0.0] * 4,
    }


def roi_evaluation(probs: np.ndarray, gt: np.ndarray,
                   patches_per_roi: int = 9, n_classes: int = 3):
    """Patch -> ROI evaluation: average the 9 patches of each ROI
    (``ROI_evaluation.py:46-66``)."""
    n = probs.shape[0] // patches_per_roi
    roi_probs = probs[:n * patches_per_roi].reshape(
        n, patches_per_roi, -1).mean(1)
    roi_gt = gt[:n * patches_per_roi].reshape(n, patches_per_roi)[:, 0]
    return grading_metrics(one_hot(roi_gt, n_classes), roi_probs)


def aggregate_patient_hazards(hazards: np.ndarray, survtime: np.ndarray,
                              censor: np.ndarray, patnames: Sequence[str],
                              agg_type: str = "mean"):
    """Patch -> patient hazard aggregation for the survival task
    (``poolSurvTestPD`` / ``getAggHazardCV`` analogue,
    ``utils.py:583-653``)."""
    import pandas as pd
    df = pd.DataFrame({"hazard": hazards, "t": survtime, "e": censor},
                      index=list(patnames))
    # percentile agg types ("p0.75" etc., utils.py:644-646) are callables,
    # not pandas method names
    hz_agg = (p_percentile(float(agg_type[1:]))
              if agg_type.startswith("p") else agg_type)
    agg = df.groupby(level=0).agg({"hazard": hz_agg, "t": "first",
                                   "e": "first"})
    return (agg["hazard"].to_numpy(), agg["t"].to_numpy(),
            agg["e"].to_numpy(), list(agg.index))


def hazard2grade(hazard: float, p: Sequence[float]) -> int:
    """Percentile-threshold stratification (``utils.py:546-551``)."""
    for i, pct in enumerate(p):
        if hazard < pct:
            return i
    return len(p)


def register_predictions(pred_test, split: Dict, split_name: str = "test",
                         metadata=None) -> List[str]:
    """The reference's registration-assert dance
    (``core/utils_analysis.py:114-117``, ``utils.py:599-606``): verify the
    prediction pickle is aligned with the CV split arrays (and, when the
    ``data_pd`` metadata frame is given, with the per-patient metadata)
    before any patient-level aggregation.  Returns the aligned patient ids.

    ``pred_test`` layout (``train_test_MT.py:452-453`` parity, see
    ``train/loop.py``): [risk_fuse, risk_path, risk_omic, t, e, probs_fuse,
    probs_path, probs_omic, gt].
    """
    d = split[split_name]
    t, e, g = pred_test[3], pred_test[4], pred_test[8]
    assert np.array_equal(np.asarray(d["t"], dtype=np.asarray(t).dtype), t), \
        "prediction pickle is not registered to the split (survival times)"
    assert np.array_equal(np.asarray(d["e"], dtype=np.asarray(e).dtype), e), \
        "prediction pickle is not registered to the split (censor flags)"
    patnames = list(d["x_patname"])
    if metadata is not None:
        reg = metadata.loc[patnames]
        assert np.all(np.asarray(reg["Survival months"], float)
                      == np.asarray(t, float)), "metadata: survival months"
        assert np.all(np.asarray(reg["censored"], float)
                      == np.asarray(e, float)), "metadata: censor flags"
        if "Grade" in reg:
            assert np.all(np.asarray(reg["Grade"]) == np.asarray(g)), \
                "metadata: grade"
    return patnames


def pool_surv_cv(pred_folds: Dict[int, Dict], agg_type: str = "mean",
                 zscore: bool = False, metadata=None):
    """``poolSurvTestPD`` (``utils.py:583-615``): per-fold patient-level
    hazard aggregation (mean/median/max/p0.25/p0.75 columns, one selected),
    optional per-fold z-scoring, pooled over folds into one DataFrame.

    pred_folds: {fold: {"hazard": [N], "t": [N], "e": [N], "g": [N],
    "patnames": [N]}}; metadata (optional): data_pd indexed by TCGA ID whose
    columns (e.g. 'Histomolecular subtype') are joined in.
    """
    import pandas as pd
    pooled = []
    for k, d in sorted(pred_folds.items()):
        df = pd.DataFrame({"Hazard": np.asarray(d["hazard"], float),
                           "Survival months": np.asarray(d["t"], float),
                           "censored": np.asarray(d["e"], float),
                           "Grade": np.asarray(d["g"])},
                          index=list(d["patnames"]))
        df.index.name = "TCGA ID"
        fns = {"mean": "mean", "median": "median", "max": "max",
               "p0.25": p_percentile(0.25), "p0.75": p_percentile(0.75)}
        agg = df.groupby(level=0).agg(
            {"Hazard": fns[agg_type.replace("Hazard_", "")],
             "Survival months": "first", "censored": "first",
             "Grade": "first"})
        if metadata is not None:
            extra = metadata.loc[agg.index].drop(
                columns=[c for c in ("Survival months", "censored", "Grade")
                         if c in metadata.columns])
            agg = agg.join(extra, how="inner")
        if zscore:
            agg["Hazard"] = stats.zscore(agg["Hazard"].to_numpy())
        agg["fold"] = k
        pooled.append(agg)
    return pd.concat(pooled)


def get_agg_hazard_cv(pred_folds: Dict[int, Dict],
                      agg_type: str = "mean") -> List[float]:
    """``getAggHazardCV`` (``utils.py:620-653``): per-fold patient-level
    C-index after hazard aggregation."""
    from .metrics import concordance_index
    result = []
    for k, d in sorted(pred_folds.items()):
        hz, t, e, _ = aggregate_patient_hazards(
            np.asarray(d["hazard"], float), np.asarray(d["t"], float),
            np.asarray(d["e"], float), d["patnames"],
            agg_type=agg_type.replace("Hazard_", ""))
        result.append(concordance_index(t, -hz, e))
    return result


def surv_logrank_by_percentile(hazards: np.ndarray, survtime: np.ndarray,
                               censor: np.ndarray,
                               percentile: Sequence[float] = (50,)) -> float:
    """Percentile-stratified multivariate log-rank p-value — the common core
    of ``getPValAggSurv_GBMLGG_Binary/Multi`` (``:398-419``, percentiles
    [50] / [33,66]) and the KIRC variants ``getPValAggSurv_KIRC_Binary/
    Multi`` (``:921-945``, [50] / [26,51,76]): the KIRC functions are the
    same machinery with different percentile thresholds, so they are thin
    parameterizations here (PARITY §2.6)."""
    from .metrics import multivariate_logrank
    thresholds = np.percentile(hazards, list(percentile))
    groups = np.array([hazard2grade(h, thresholds) for h in hazards])
    return multivariate_logrank(groups, censor, survtime)


def save_pred_test(path: str, pred_test) -> None:
    """Pickle the per-fold prediction list (layout
    ``train_test_MT.py:452-453``) for offline analysis."""
    with open(path, "wb") as fh:
        pickle.dump(pred_test, fh)


def load_pred_test(path: str):
    with open(path, "rb") as fh:
        return pickle.load(fh)
