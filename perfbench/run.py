"""Run one cell of the benchmark once and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cells, their configurations and traffic
are in ``BENCHMARK.json`` and under ``perfbench/`` (see ``harness.py``).
With ``--trace 0`` the result carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics read from a profiled block of the
window.  The last line of standard output is the result as one JSON
object; the last lines of standard error are the numbers that decided
``correct``, each beside its limit.  Exits non-zero and prints no result
without enough CUDA devices, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# kernel builds and caches stay in fixed directories of the checkout; so
# does Python's bytecode, which the environment may forbid writing
# (PYTHONDONTWRITEBYTECODE): without it every run compiles torch's
# dynamo and library modules anew, about 10 s of set-up on the card's
# machine, where a deployment would have them compiled once
_CACHE = os.path.join(ROOT, "build", "perfbench")
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = os.path.join(_CACHE, _sub)
sys.pycache_prefix = os.path.join(_CACHE, "pycache")
sys.dont_write_bytecode = False
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _plain(x):
    """Non-finite floats as a large finite number, so the line is JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return 1e300
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_plain(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from perfbench import harness

    start = harness.process_start() or T0
    cell = harness.find_cell(harness.manifest(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    keep = {}
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), device="cuda", t0=start,
                         keep=keep)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    print(json.dumps(_plain(result)))
    sys.stdout.flush()
    print("set-up: " + ", ".join(f"{name} {sec:.2f} s"
                                 for name, sec in keep["stages"]),
          file=sys.stderr)
    win = keep["window"]
    print(f"window: {win['count']} in {win['seconds']:.3f} s; mean ms " +
          ", ".join(f"{k} {v:.3f}" for k, v in win["ms"].items()),
          file=sys.stderr)
    for name, n in result["check"].items():
        print(f"check {name} = {n['value']!r} (limit {n['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
