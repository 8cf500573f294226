"""The port's survival and grading plots.

Every plot writes its file; the Kaplan-Meier arrays equal the JAX
package's exactly; the port's ROC points and area (it does not depend on
scikit-learn) equal ``sklearn.metrics.roc_curve`` with its defaults
(``drop_intermediate=True``) and ``sklearn.metrics.auc`` exactly.
"""
import os

import numpy as np
import pytest
from sklearn import metrics as skm

from multimodal_learning_tpu.eval import plots as jplots
from multimodal_learning_tpu_torch.eval import plots


def _surv(seed, n=60):
    rng = np.random.default_rng(seed)
    hz = rng.normal(size=n)
    t = np.ceil(rng.exponential(20, n) * np.exp(-hz))   # tied times
    e = rng.binomial(1, 0.7, n).astype(float)
    return hz, t, e


@pytest.mark.parametrize("seed", [0, 1])
def test_km_curve_equals_jax(seed):
    _, t, e = _surv(seed)
    got, want = plots.km_curve(t, e), jplots.km_curve(t, e)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[1][0] == 1.0 and np.all(np.diff(got[1]) <= 0)


@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_roc_curve_and_auc_equal_sklearn(seed, ties):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 3, 50)
    onehot = np.eye(3)[y]
    probs = rng.dirichlet(np.ones(3), 50).astype(np.float32)
    if ties:
        probs = np.round(probs * 4) / 4
    got = plots.roc_curve(onehot.ravel(), probs.ravel())
    want = skm.roc_curve(onehot.ravel(), probs.ravel())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert plots.auc(got[0], got[1]) == skm.auc(want[0], want[1])
    # the area read the other way round
    assert (plots.auc(got[0][::-1], got[1][::-1])
            == skm.auc(want[0][::-1], want[1][::-1]))


def test_every_plot_writes_its_file(tmp_path):
    hz, t, e = _surv(3)
    rng = np.random.default_rng(3)
    grades = rng.integers(0, 3, len(hz))
    subtypes = rng.choice(["idhwt_ATC", "idhmut_ATC", "ODG"], len(hz))
    subtypes[0], grades[1] = "-1", -1          # dropped sentinels
    y = np.eye(3)[grades.clip(0)]
    probs = rng.dirichlet(np.ones(3), len(hz))
    out = {name: str(tmp_path / f"{name}.png") for name in
           ("km", "box", "swarm", "auroc", "hist")}
    plots.make_kaplan_meier_plot(hz, t, e, out["km"])
    plots.make_hazard_box_plot(hz, grades.clip(0), out["box"])
    plots.make_hazard_swarm_plot(hz, grades, subtypes, out["swarm"])
    plots.make_auroc_plot(y, {"a": probs, "b": probs[::-1]}, out["auroc"])
    plots.make_hazard_histogram_plot(hz, t * 40, e, out["hist"])
    for path in out.values():
        assert os.path.getsize(path) > 1000, path
