"""Offline patient-level evaluation driver — reference
``MICCAI-2022/evaluation_GBMLGG.py:34-77``: loads the per-fold prediction
pickles dumped by the eval drivers, aggregates patch -> patient (max/mean/
p0.75) and prints AUC/AP/F1/F1-IV mean +- 95% CI per branch.

Port of ``multimodal_learning_tpu/cli/evaluation_GBMLGG.py``: the same fold
set, printout and returned ``{(branch, agg): result}``.  It reads the
pickles of either package's eval drivers and runs on the host (numpy,
scipy and pandas); it needs no device.

    python -m multimodal_learning_tpu_torch.cli.evaluation_GBMLGG \
        --task grad --mode pathomic --model_name stage1_pathomic_teacher
"""
from __future__ import annotations

import os
import sys

from ..config import parse_args
from ..eval.analysis import grad_evaluation, load_pred_test


def main(argv=None):
    opt = parse_args(argv)
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)
    folds = {}
    # Scan exactly the protocol's fold set — grading is 5 folds
    # (reference evaluation_GBMLGG.py:66, range(1,6)), survival 15 (:30),
    # and synthetic sweeps declare their own count — so stale pickles from
    # an earlier higher-fold run under the same model_name can't silently
    # mix into the patient-level aggregation (advisor r4).
    if opt.synthetic_data or opt.synthetic_folds > 1:
        n_expected = opt.synthetic_folds
    else:
        n_expected = 15 if opt.task == "surv" else 5
    for k in range(1, n_expected + 1):
        path = os.path.join(ckpt_dir, f"{opt.model_name}_{k}_pred_test.pkl")
        if os.path.exists(path):
            folds[k] = load_pred_test(path)
    print(f"aggregating folds {sorted(folds)} of expected "
          f"1..{n_expected} under {ckpt_dir}")
    if not folds:
        print(f"no prediction pickles under {ckpt_dir}")
        return None
    results = {}
    for branch in ("fuse", "path", "omic"):
        per_fold = {}
        for k, d in folds.items():
            probs = d["probs"].get(branch)
            if probs is None:
                continue
            per_fold[k] = {"probs": probs, "gt": d["gt"],
                           "patnames": d["patnames"]}
        if not per_fold:
            continue
        for agg in ("max", "mean"):
            res = grad_evaluation(per_fold, opt.label_dim, agg_type=agg)
            results[(branch, agg)] = res
            m, ci = res["mean"], res["ci95"]
            print(f"[{branch}|{agg}] AUC {m[0]:.4f}±{ci[0]:.4f} "
                  f"AP {m[1]:.4f}±{ci[1]:.4f} F1 {m[2]:.4f}±{ci[2]:.4f} "
                  f"F1-IV {m[3]:.4f}±{ci[3]:.4f}")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
