"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--faults half_batch] [--seconds 1] \
        [--control-seconds 10]

For each seed: the program's numbers from a run of the cell (a short
window: set-up and the check are the run's own) with, for a train cell,
the per-step losses and the worst leaves; for the first ``--control``
seeds, the control's: the plain reference computed in fp8 (e4m3, one
scale per tensor), the precision below the configuration's bf16, put in
the program's place.  In a serve cell that is the run's own ``fp8``
fault, so its line says whether ``correct`` came out false; in a train
cell the fp8 reference's first steps are held against the fp32
reference's on the run's own inputs.  For the first ``--fault-seeds``
seeds, the program's numbers with each of ``--faults`` planted
underneath the timed path.  One JSON object per reading on standard
output, and the same lines in ``chiprun_out/control_<cell>.jsonl``.
Runs on the card; the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def train_control(cell: str, seed: int, keep, device, scale=None,
                  man=None):
    """The fp8 reference's first steps against the fp32 reference's on a
    train run's own inputs (``keep`` from ``harness.run``)."""
    import torch
    from perfbench import check, harness, inputs
    man = harness.manifest() if man is None else man
    w = harness.find_cell(man, cell)
    cfg = harness.config_of(man, w["config"])
    if scale:
        cfg = {**cfg, "options": {**cfg["options"], **scale["options"]}}
    ref = harness._reference(cfg)
    s = inputs.seeds(seed)
    dev = torch.device(device)
    rois, tab, shapes = keep["inputs"]
    inp = {"device": dev, "seeds": s, "rois": rois, "tab": tab,
           "n_data": len(rois), "noise_dtype": harness._noise_dtype(cfg),
           "weights": inputs.make_weights(s["weights"], shapes, dev)}
    low = ref.train(cfg, inp, harness.CHECK_STEPS, quant="fp8")
    return (check.train_numbers(low, keep["want"]),
            check.explain(low, keep["want"]))


def _numbers(r):
    return {k: v["value"] for k, v in r["check"].items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control-seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    from perfbench import check, harness
    seeds = [int(x) for x in args.seeds.split(",")]
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"control_{args.workload}.jsonl")
    with open(path, "a") as fh:
        def emit(row):
            line = json.dumps(row)
            print(line, flush=True)
            fh.write(line + "\n")
            fh.flush()

        for i, seed in enumerate(seeds):
            keep = {}
            r = harness.run(args.workload, seed, args.seconds, False,
                            keep=keep)
            row = {"seed": seed, "side": "program", "numbers": _numbers(r),
                   "correct": r["correct"], "attempted": r["attempted"]}
            serve = not hasattr(keep["got"], "loss")
            if not serve:
                row["explain"] = check.explain(keep["got"], keep["want"])
            emit(row)
            if i < args.control:
                if serve:
                    r = harness.run(args.workload, seed,
                                    args.control_seconds, False,
                                    fault="fp8")
                    emit({"seed": seed, "side": "control_fp8",
                          "numbers": _numbers(r), "correct": r["correct"],
                          "attempted": r["attempted"]})
                else:
                    numbers, why = train_control(args.workload, seed, keep,
                                                 "cuda")
                    emit({"seed": seed, "side": "control_fp8",
                          "numbers": numbers, "explain": why})
            if i < args.fault_seeds:
                for fault in filter(None, args.faults.split(",")):
                    r = harness.run(args.workload, seed, args.seconds,
                                    False, fault=fault)
                    emit({"seed": seed, "side": f"fault_{fault}",
                          "numbers": _numbers(r), "correct": r["correct"]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
