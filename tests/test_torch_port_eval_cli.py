"""The port's offline evaluation CLIs against the JAX package's.

Fabricated ``<model>_<k>_pred_test.pkl`` folds (several patches per
patient, 9 patches per ROI, a branch left out) go through both packages'
``evaluation_GBMLGG.main`` and ``ROI_evaluation.main``; a stale fold beyond
the expected count must be ignored by both.  The results end in the
grading metrics, which the JAX package takes from scikit-learn and the port
computes itself (held to scikit-learn at atol 1e-12 in
``test_torch_port_data.py``): they are compared exactly with the JAX
package's metric function put into the port's analysis module, and at that
atol with the port's own.

A pickle written by the port's ``test_cv_MT`` on the CPU at widths 16
holds only numpy and Python objects, so that the JAX package reads it, and
both packages' ``evaluation_GBMLGG`` agree on it.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from multimodal_learning_tpu.cli import ROI_evaluation as j_roi_cli
from multimodal_learning_tpu.cli import evaluation_GBMLGG as j_eval_cli
from multimodal_learning_tpu.eval import metrics as jmetrics
from multimodal_learning_tpu_torch.cli import ROI_evaluation, evaluation_GBMLGG
from multimodal_learning_tpu_torch.eval import analysis

METRIC_ATOL = 1e-12


def _write_folds(root, model, folds, seed, no_omic, n_roi=6):
    """``folds`` pickles of ``n_roi`` ROIs x 9 patches, 2 ROIs per patient,
    every grade among the patients; fold ``no_omic`` has no omic branch."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "grad_15", model)
    os.makedirs(d, exist_ok=True)
    for k in folds:
        gt = np.repeat(np.arange(n_roi) // 2 % 3, 9)
        pats = np.repeat([f"TCGA-{k}-{i // 2:02d}" for i in range(n_roi)], 9)
        probs = {b: (0.6 * np.eye(3)[gt] + 0.4 * rng.dirichlet(
            np.ones(3), len(gt))).astype(np.float32)
            for b in ("fuse", "path", "omic")}
        if k == no_omic:
            probs["omic"] = None
        with open(os.path.join(d, f"{model}_{k}_pred_test.pkl"), "wb") as fh:
            pickle.dump({"pred_test": None, "probs": probs, "gt": gt,
                         "patnames": list(pats)}, fh)


def _close(a, b, exact):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k], exact)
    elif exact:
        assert np.array_equal(np.asarray(a), np.asarray(b)), (a, b)
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=0, atol=METRIC_ATOL)


@pytest.mark.parametrize("metrics", ["jax_metrics", "own_metrics"])
@pytest.mark.parametrize("protocol", ["synthetic", "grading"])
def test_evaluation_gbmlgg_equals_jax(tmp_path, monkeypatch, capsys,
                                      protocol, metrics):
    """``--synthetic_folds 3`` expects folds 1..3, the grading protocol
    1..5; the fold after them is stale and must not be read."""
    n = 3 if protocol == "synthetic" else 5
    _write_folds(tmp_path, "m", list(range(1, n + 2)), seed=n, no_omic=n)
    argv = ["--checkpoints_dir", str(tmp_path), "--model_name", "m",
            "--task", "grad"]
    if protocol == "synthetic":
        argv += ["--synthetic_folds", "3"]
    if metrics == "jax_metrics":
        monkeypatch.setattr(analysis, "grading_metrics",
                            jmetrics.grading_metrics)
    got = evaluation_GBMLGG.main(argv)
    port_out = capsys.readouterr().out
    want = j_eval_cli.main(argv)
    jax_out = capsys.readouterr().out
    assert set(got) == {(b, a) for b in ("fuse", "path", "omic")
                        for a in ("max", "mean")}
    _close(got, want, exact=metrics == "jax_metrics")
    assert len(got["fuse", "max"]["per_fold"]["rocauc"]) == n
    assert len(got["omic", "mean"]["per_fold"]["rocauc"]) == n - 1
    assert f"aggregating folds {list(range(1, n + 1))} of expected" in port_out
    if metrics == "jax_metrics":
        assert port_out == jax_out


def test_evaluation_gbmlgg_without_pickles(tmp_path):
    argv = ["--checkpoints_dir", str(tmp_path), "--model_name", "none"]
    assert evaluation_GBMLGG.main(argv) is None
    assert j_eval_cli.main(argv) is None


@pytest.mark.parametrize("metrics", ["jax_metrics", "own_metrics"])
def test_roi_evaluation_equals_jax(tmp_path, monkeypatch, capsys, metrics):
    """ROI_evaluation reads folds 1..5; fold 6 is stale."""
    _write_folds(tmp_path, "r", list(range(1, 7)), seed=9, no_omic=2)
    argv = ["--checkpoints_dir", str(tmp_path), "--model_name", "r"]
    if metrics == "jax_metrics":
        monkeypatch.setattr(analysis, "grading_metrics",
                            jmetrics.grading_metrics)
    got = ROI_evaluation.main(argv)
    port_out = capsys.readouterr().out
    want = j_roi_cli.main(argv)
    jax_out = capsys.readouterr().out
    assert got.keys() == want.keys()
    for branch in got:
        assert len(got[branch]) == len(want[branch])
        for g, w in zip(got[branch], want[branch]):
            _close(list(g), list(w), exact=metrics == "jax_metrics")
    assert [len(got[b]) for b in ("fuse", "path", "omic")] == [5, 5, 4]
    if metrics == "jax_metrics":
        assert port_out == jax_out


def _plain(obj, where="pickle"):
    """Raise unless ``obj`` is made of numpy and Python objects only."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _plain(k, where)
            _plain(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _plain(v, f"{where}[{i}]")
    elif isinstance(obj, np.ndarray):
        assert obj.dtype != object, where
    else:
        assert obj is None or isinstance(
            obj, (str, bool, int, float, np.generic)), (where, type(obj))


def test_port_test_cv_mt_pickle_reads_in_jax(tmp_path, monkeypatch):
    from multimodal_learning_tpu.eval.analysis import (
        load_pred_test as j_load_pred_test)
    from multimodal_learning_tpu_torch.cli import test_cv_MT, train_cv_MT

    monkeypatch.setenv("MML_PLATFORM", "cpu")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        flags = ("--synthetic_data --synthetic_folds 1 --mode pathomic "
                 "--task grad --niter_decay 1 --batch_size 8 "
                 "--input_size_path 64 --path_dim 16 --omic_dim 16 "
                 "--mmhid 16 --CRD_distill 0 --pred_distill 1 "
                 "--reg_type none --model_name vt --checkpoints_dir "
                 f"{tmp_path}").split()
        train_cv_MT.main(flags)
        tested = test_cv_MT.main(flags)
    finally:
        torch.set_num_threads(n_threads)
    path = os.path.join(tmp_path, "grad_15", "vt", "vt_1_pred_test.pkl")
    with open(path, "rb") as fh:
        raw = fh.read()
    assert b"torch" not in raw
    dumped = j_load_pred_test(path)
    _plain(dumped)
    assert set(dumped["probs"]) == {"fuse", "path", "omic"}
    # one patch per patient: the patient-level rows are the fold's metrics
    got = evaluation_GBMLGG.main(flags)
    for branch in ("fuse", "path", "omic"):
        for agg in ("max", "mean"):
            assert got[branch, agg]["mean"] == [float(v) for v in
                                                tested[branch][0]]
    monkeypatch.setattr(analysis, "grading_metrics",
                        jmetrics.grading_metrics)
    _close(evaluation_GBMLGG.main(flags), j_eval_cli.main(flags), exact=True)
