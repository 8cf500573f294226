"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""
import ast
import json
import os
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


def test_configs():
    assert 1 <= len(MAN["configs"]) <= 24
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) \
            and _line(c["why"])
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        body = harness.load_json(harness.ROOT, c["file"])
        assert body["name"] == c["name"]
        assert body["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(
            harness.BENCH, "reference", body["reference"] + ".py"))


def test_workloads():
    names = [w["name"] for w in MAN["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(names)
    configs = {c["name"] for c in MAN["configs"]}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert _line(w["why"])
        traffic = harness.load_json(harness.BENCH, "traffic",
                                    w["traffic"] + ".json")
        assert traffic["kind"] in ("train", "serve")
        limits = harness.load_json(harness.BENCH, "limits",
                                   w["name"] + ".json")
        assert limits and all(v > 0 for v in limits.values())


def test_metrics():
    e2e = MAN["end_to_end"]
    names = [m["name"] for m in e2e + MAN["per_layer"]]
    assert len(set(names)) == len(names)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in e2e)
    cells = {w["name"] for w in MAN["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {x["name"] for x in e2e}
        assert _line(m["layer"])
        for cell in m.get("workloads", []):
            mover = next(x for x in e2e if x["name"] == m["moves"])
            assert cell in mover.get("workloads", cells)
    for m in e2e + MAN["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        if m["name"].endswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # one reader per metric, found by name
        path = os.path.join(harness.BENCH, "metrics", m["name"] + ".py")
        tree = ast.parse(open(path).read())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read"
                   for n in tree.body)


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    e2e = [m["name"] for m in MAN["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    layer = [m["name"] for m in MAN["per_layer"]
             if cell in m.get("workloads", [cell])]
    assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_a_new_cell_is_data_only(tmp_path, monkeypatch):
    """The harness reaches a cell's configuration, traffic and limits by
    the names in the manifest, so a cell added as files and entries runs
    with no code edited."""
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "pofusion_teacher.serve_copy",
                             "config": "pofusion_teacher",
                             "traffic": "serve_chunks", "chips": 1,
                             "why": "a copy"})
    monkeypatch.setattr(harness, "manifest", lambda: man)
    cell = harness.find_cell(harness.manifest(), "pofusion_teacher.serve_copy")
    assert harness.config_of(man, cell["config"])["name"] == \
        "pofusion_teacher"
    readers = harness._readers(man, "pofusion_teacher.serve_copy", False)
    assert {m["name"] for m, _ in readers} == {"setup_s"}


def test_the_train_entries_the_tests_drive_fit_the_manifest():
    """The train cells, not in ``BENCHMARK.json`` yet, are driven by the
    tests through entries that a later change can add as they are:
    their configurations, traffic, limits and readers exist and the
    entries keep the contract's keys."""
    from perfbench.tests import tiny
    man = tiny.manifest()
    cells = {w["name"] for w in MAN["workloads"]}
    configs = {c["name"] for c in MAN["configs"]}
    added = [w for w in man["workloads"] if w["name"] in tiny.TRAIN_CELLS]
    assert len(added) == len(tiny.TRAIN_CELLS)
    for w in added:
        assert w["name"] not in cells and w["config"] in configs
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert _line(w["why"]) and NAME.match(w["name"])
        harness.load_json(harness.BENCH, "traffic", w["traffic"] + ".json")
        harness.load_json(harness.BENCH, "limits", w["name"] + ".json")
    for m in man["end_to_end"] + man["per_layer"]:
        assert os.path.exists(os.path.join(harness.BENCH, "metrics",
                                           m["name"] + ".py"))


def test_the_references_import_nothing_of_the_program():
    ref_dir = os.path.join(harness.BENCH, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref_dir, name)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] in ("torch", "numpy", "math",
                                             "typing", "contextlib",
                                             "__future__"), (name, mod)
