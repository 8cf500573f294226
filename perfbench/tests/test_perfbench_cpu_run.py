"""Each cell's code path on the CPU at tiny sizes, in a process of its
own: the result line has exactly the contract's keys, and nothing of JAX
or the JAX package was loaded."""
import json
import os
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests import tiny

KEYS = {"correct", "attempted", "failed", "metrics", "device", "check"}
SCRIPT = """
import json, sys
from perfbench import harness
from perfbench.tests import tiny
r = tiny.run(sys.argv[1], traced=sys.argv[2] == "1")
print(json.dumps({"forbidden": harness.loaded_forbidden()}))
print(json.dumps(r))
"""


def _run(cell, traced):
    env = {**os.environ, "PYTHONPATH": harness.ROOT}
    out = subprocess.run([sys.executable, "-c", SCRIPT, cell,
                          "1" if traced else "0"], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    return json.loads(lines[-2])["forbidden"], json.loads(lines[-1])


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_result_line(cell):
    forbidden, r = _run(cell, traced=False)
    assert forbidden == []
    assert set(r) == KEYS and list(r)[-1] == "check"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    man = tiny.manifest()
    want = {m["name"] for m in man["end_to_end"]
            if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for n in r["check"].values():
        assert set(n) == {"value", "limit"} and n["value"] <= n["limit"]


@pytest.mark.parametrize("cell", ["pofusion_teacher.train",
                                  "pofusion_teacher.serve"])
def test_traced_result_line(cell):
    """A traced run: the device's busy and window seconds and the
    breakdown are there; of the per-layer metrics the CPU reads only the
    host's spans."""
    forbidden, r = _run(cell, traced=True)
    assert forbidden == []
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r) <= KEYS | {"breakdown"}
    # host spans are read on the CPU too; device metrics are not
    assert any(k.endswith("_ms.train") or k.endswith("_ms.serve")
               for k in r["metrics"])
    assert not any(k.startswith(("mfu", "device_idle", "kron"))
                   for k in r["metrics"])


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    """On the card: the command as the driver runs it, one short run of
    the cheapest cell, correct, with the device named."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "clat_student.serve", "--seed", "2147483999", "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
