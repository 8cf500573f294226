"""The port's one-command synthetic sweep against the JAX package's.

Every driver ``main`` of both packages is replaced by a recorder that
returns the same canned metrics; both sweeps over all four groups must call
the same drivers with the same argv in the same order and write the same
report but for its wall-time line.  The port's ``sweep --folds 1 --configs
omic`` also runs end to end on the CPU, as ``tests/test_sweep.py`` runs the
JAX one, and ``_fold_table`` gives equal results on both driver return
shapes.
"""
import importlib
import os
import re

import numpy as np
import pytest

from multimodal_learning_tpu.cli import sweep as j_sweep
from multimodal_learning_tpu_torch.cli import sweep

DRIVERS = ("train_cv_MT", "test_cv_MT", "export_model",
           "train_cv_path_multi_MT", "test_cv_path", "train_cv_MT_SP_Masking",
           "train_cv_path_CLAT", "evaluation_GBMLGG")
ROW = [0.75, 0.5, 0.625, 0.25]
EXT = {"rocauc": 0.8, "ap": 0.7, "f1_micro": 0.6, "f1_macro": 0.5,
       "f1_gradeIV": 0.4, "recall_macro": 0.3, "precision_macro": 0.2,
       "kappa": 0.1, "mcc": 0.05}


def _canned(driver, argv):
    if driver == "test_cv_MT":
        if argv[argv.index("--mode") + 1] == "omic":
            return {"fuse": [], "path": [], "omic": [ROW, ROW[::-1]]}
        return {b: [ROW, ROW[::-1]] for b in ("fuse", "path", "omic")}
    if driver == "test_cv_path":
        return [EXT, dict(EXT, rocauc=0.9)]
    if driver == "evaluation_GBMLGG":
        return {(b, a): {"mean": ROW, "ci95": ROW[::-1]}
                for b in ("fuse", "path", "omic") for a in ("max", "mean")}
    return None


def _record(monkeypatch, cli_package):
    """Every driver's ``main`` replaced by a recorder.  The modules are all
    imported first: ``train_cv_MT_SP_Masking`` binds ``train_cv_MT.main``
    when it is imported, and would keep a recorder after the undo."""
    calls = []
    mods = {d: importlib.import_module(f"{cli_package}.{d}") for d in DRIVERS}
    for driver, mod in mods.items():

        def main(argv=None, driver=driver):
            calls.append((driver, list(argv)))
            return _canned(driver, argv)

        monkeypatch.setattr(mod, "main", main)
    return calls


def test_sweep_drives_the_same_argv_and_report_as_jax(tmp_path, monkeypatch):
    out = str(tmp_path / "ckpt")
    texts, calls, sections = [], [], []
    for mod, pkg in ((sweep, "multimodal_learning_tpu_torch.cli"),
                     (j_sweep, "multimodal_learning_tpu.cli")):
        rec = _record(monkeypatch, pkg)
        report = str(tmp_path / f"{pkg}.md")
        sections.append(mod.main(["--folds", "2", "--out_dir", out,
                                  "--report", report]))
        calls.append(rec)
        with open(report) as fh:
            texts.append(fh.read())
    assert calls[0] == calls[1]
    assert [d for d, _ in calls[0]] == [
        "train_cv_MT", "test_cv_MT",
        "train_cv_MT", "export_model", "test_cv_MT",
        "train_cv_path_multi_MT", "test_cv_path",
        "train_cv_MT", "train_cv_path_multi_MT", "test_cv_path",
        "train_cv_MT_SP_Masking", "train_cv_path_CLAT", "test_cv_path",
        "evaluation_GBMLGG"]
    assert all("--synthetic_folds" in a and a[a.index("--synthetic_folds")
                                               + 1] == "2"
               for _, a in calls[0])
    wall = re.compile(r"\d+s wall\._$", re.M)
    assert wall.search(texts[0]) and wall.search(texts[1])
    assert wall.sub("", texts[0]) == wall.sub("", texts[1])
    assert "patient-level aggregation" in texts[0]
    assert len(sections[0]) == 5
    for (title, rows), (jtitle, jrows) in zip(*sections):
        assert title == jtitle and len(rows) == len(jrows)
        for r, jr in zip(rows, jrows):
            assert r[:2] == jr[:2]
            assert np.array_equal(r[2], jr[2]) and np.array_equal(r[3], jr[3])


@pytest.mark.parametrize("metrics", [
    {"fuse": [[0.5, 0.4, 0.3, 0.2], [0.7, 0.6, 0.5, 0.4]], "path": []},
    [{"rocauc": 0.6, "ap": 0.4}, {"rocauc": 0.8, "ap": 0.6}],
    {}, []], ids=["test_cv_MT", "test_cv_path", "empty_dict", "empty_list"])
def test_fold_table_equals_jax(metrics):
    got, want = sweep._fold_table(metrics), j_sweep._fold_table(metrics)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])


def test_sweep_omic_group_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("MML_PLATFORM", "cpu")
    report = tmp_path / "report.md"
    sections = sweep.main([
        "--folds", "1", "--configs", "omic",
        "--out_dir", str(tmp_path / "ckpt"), "--report", str(report)])
    (title, rows), = sections
    assert "config 2" in title
    (name, header, mean, std), = rows
    assert name == "omic" and header == ("AUC", "AP", "F1", "F1-IV")
    assert np.isfinite(mean).all() and np.isfinite(std).all()
    assert ((0.0 <= mean) & (mean <= 1.0)).all()
    text = report.read_text()
    assert "omic SNN (config 2)" in text
    assert "1 config groups x 1 fold(s)" in text
    assert os.path.exists(
        tmp_path / "ckpt" / "grad_15" / "sw_omic" / "sw_omic_1.pt")
