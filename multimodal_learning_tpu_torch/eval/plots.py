"""Survival / grading plots — reference ``MICCAI-2022/utils.py:688-909``
(Kaplan-Meier curves, hazard swarm/box plots, AUROC curves).

The port's own copy of ``multimodal_learning_tpu/eval/plots.py``.  It needs
matplotlib (and seaborn for the swarm plot, with a scatter fallback); the
ROC curve is computed here with scikit-learn's definitions, as the port
does not depend on scikit-learn.  ``eval/__init__.py`` does not import
this module.

All plotting uses the Agg backend and writes files; the KM estimator and
log-rank annotation are self-contained (the reference pulls them from
lifelines, which neither package depends on).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .metrics import cox_log_rank  # noqa: E402


def km_curve(survtime: np.ndarray, censor: np.ndarray):
    """Kaplan-Meier estimator: returns (times, survival probability)."""
    order = np.argsort(survtime)
    t, e = np.asarray(survtime)[order], np.asarray(censor)[order]
    times, probs = [0.0], [1.0]
    s = 1.0
    n = len(t)
    at_risk = n
    i = 0
    while i < n:
        tt = t[i]
        d = 0
        c = 0
        while i < n and t[i] == tt:
            d += int(e[i] == 1)
            c += int(e[i] == 0)
            i += 1
        if d > 0 and at_risk > 0:
            s *= 1.0 - d / at_risk
            times.append(tt)
            probs.append(s)
        at_risk -= d + c
    return np.asarray(times), np.asarray(probs)


def make_kaplan_meier_plot(hazards: np.ndarray, survtime: np.ndarray,
                           censor: np.ndarray, out_path: str,
                           percentiles: Sequence[float] = (33, 66),
                           title: str = "Kaplan-Meier") -> None:
    """Stratify patients by hazard percentiles and plot KM curves per
    stratum (``makeKaplanMeierPlot``, ``utils.py:688-744``)."""
    cuts = np.percentile(hazards, percentiles)
    groups = np.digitize(hazards, cuts)
    labels = ["low", "mid", "high"][:len(percentiles) + 1]
    fig, ax = plt.subplots(figsize=(6, 5))
    for g, lab in enumerate(labels):
        m = groups == g
        if m.sum() == 0:
            continue
        t, s = km_curve(survtime[m], censor[m])
        ax.step(t, s, where="post", label=f"{lab} (n={int(m.sum())})")
    p = cox_log_rank(hazards, censor, survtime)
    ax.set_xlabel("time (months)")
    ax.set_ylabel("survival probability")
    ax.set_title(f"{title}  (log-rank p={p:.2e})")
    ax.legend()
    ax.set_ylim(0, 1.02)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def make_hazard_box_plot(hazards: np.ndarray, grades: np.ndarray,
                         out_path: str, title: str = "hazard by grade"):
    """Hazard distribution per histological grade
    (``makeHazardBoxPlot``, ``utils.py:778-819``)."""
    fig, ax = plt.subplots(figsize=(5, 4))
    groups = [hazards[grades == g] for g in np.unique(grades)]
    ax.boxplot(groups, labels=[f"grade {int(g)}" for g in np.unique(grades)])
    ax.set_ylabel("predicted hazard")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def make_hazard_swarm_plot(hazards: np.ndarray, grades: np.ndarray,
                           subtypes: Sequence, out_path: str,
                           grade_names: Optional[dict] = None):
    """Z-scored hazard swarm per histomolecular subtype, hue = grade
    (``makeHazardSwarmPlot``, ``MIA 2022/core/utils_analysis.py:642-674``).
    Drops the reference's missing-label sentinels (-1) before plotting."""
    from scipy import stats
    hazards = np.asarray(hazards, float)
    grades = np.asarray(grades)
    subtypes = np.asarray(subtypes)
    keep = (grades != -1) & (subtypes != -1) & (subtypes != "-1")
    hazards, grades, subtypes = hazards[keep], grades[keep], subtypes[keep]
    hazards = stats.zscore(hazards) if len(hazards) > 1 else hazards
    names = grade_names or {0: "Grade II", 1: "Grade III", 2: "Grade IV"}
    # palette keyed by the (possibly caller-supplied) grade names so custom
    # grade_names don't crash seaborn's hue lookup
    base_colors = ["#AFD275", "#7395AE", "#E7717D", "#5D5C61", "#B1A296"]
    palette = {name: base_colors[i % len(base_colors)]
               for i, name in enumerate(names.values())}
    color_of = {k: palette[v] for k, v in names.items()}

    fig, ax = plt.subplots(figsize=(6, 4), dpi=200)
    ax.set_ylim([-2, 2.5])
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)
    ax.set_yticks(np.arange(-2, 2.001, 1))
    try:
        import pandas as pd
        import seaborn as sns
        df = pd.DataFrame({
            "Hazard": hazards,
            "Grade": [names.get(int(g), str(g)) for g in grades],
            "Histomolecular subtype": subtypes})
        sns.swarmplot(x="Histomolecular subtype", y="Hazard", data=df,
                      hue="Grade", palette=palette, size=4, alpha=0.9, ax=ax)
        ax.legend(prop={"size": 8})
    except ImportError:  # jittered categorical scatter fallback
        cats = list(dict.fromkeys(subtypes))
        rng = np.random.default_rng(0)

        def grade_color(g):
            # int-key lookup first; unknown grades cycle the base palette
            # (mirrors the pre-palette modulo behaviour) instead of
            # collapsing onto the first color
            try:
                gi = int(g)
            except (TypeError, ValueError):
                # stable digest — builtin hash() is salted per process
                import zlib
                return color_of.get(g, base_colors[
                    zlib.crc32(str(g).encode()) % len(base_colors)])
            return color_of.get(gi, base_colors[gi % len(base_colors)])

        for i, c in enumerate(cats):
            m = subtypes == c
            x = i + rng.uniform(-0.25, 0.25, m.sum())
            ax.scatter(x, hazards[m],
                       c=[grade_color(g) for g in grades[m]],
                       s=12, alpha=0.9)
        ax.set_xticks(range(len(cats)))
        ax.set_xticklabels(cats)
    ax.set_xlabel("")
    ax.set_ylabel("")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def roc_curve(y_true: np.ndarray, y_score: np.ndarray):
    """Binary ROC points as ``sklearn.metrics.roc_curve`` gives them with
    its defaults (``drop_intermediate=True``): one point per distinct score
    in decreasing order, collinear points dropped, (0, 0) and an infinite
    threshold prepended.  Returns (fpr, tpr, thresholds)."""
    y_true = np.asarray(y_true) == 1
    y_score = np.asarray(y_score)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    last = np.r_[np.where(np.diff(y_score))[0], y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[last]
    fps = 1 + last.astype(np.float64) - tps
    thresholds = y_score[last]
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    return fps / fps[-1], tps / tps[-1], thresholds


def auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under (x, y), x monotone (``sklearn.metrics.auc``)."""
    dx = np.diff(x)
    direction = -1 if np.any(dx < 0) and np.all(dx <= 0) else 1
    return float(direction * np.trapezoid(y, x))


def make_auroc_plot(y_onehot: np.ndarray, probs_by_model: dict,
                    out_path: str, title: str = "micro-average ROC"):
    """Micro-average ROC overlay for several models
    (``makeAUROCPlot``, ``utils.py:821-909``)."""
    fig, ax = plt.subplots(figsize=(5, 5))
    for name, probs in probs_by_model.items():
        fpr, tpr, _ = roc_curve(y_onehot.ravel(), np.asarray(probs).ravel())
        ax.plot(fpr, tpr, label=f"{name} (AUC={auc(fpr, tpr):.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("false positive rate")
    ax.set_ylabel("true positive rate")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)


def make_hazard_histogram_plot(hazards: np.ndarray, survtime: np.ndarray,
                               event: np.ndarray, out_path: str,
                               cutoff_days: float = 365 * 5,
                               zscore: bool = True, bins: int = 15):
    """Normalised step-filled hazard histograms of short- vs long-surviving
    patients with observed events (``getHazardHistogramPlot_GBMLGG``,
    ``core/utils_analysis.py:570-641``): red = survival <= 5 years,
    blue = survival > 5 years, events only (event == 1, the reference's
    flipped-censor convention)."""
    hazards = np.asarray(hazards, float)
    survtime = np.asarray(survtime, float)
    event = np.asarray(event, float)
    if zscore and len(hazards) > 1 and hazards.std() > 0:
        hazards = (hazards - hazards.mean()) / hazards.std()
    low = hazards[(survtime <= cutoff_days) & (event == 1)]
    high = hazards[(survtime > cutoff_days) & (event == 1)]
    fig, ax = plt.subplots(figsize=(5, 4))
    for arr, color in ((low, "r"), (high, "b")):
        if len(arr):
            ax.hist(arr, bins=bins, density=True, histtype="stepfilled",
                    alpha=0.5, color=color, linewidth=1)
    ax.spines["right"].set_visible(False)
    ax.spines["top"].set_visible(False)
    ax.set_xlabel("")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
