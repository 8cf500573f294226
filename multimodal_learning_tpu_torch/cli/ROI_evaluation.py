"""Patch -> ROI evaluation driver — reference ``MIA 2022/ROI_evaluation.py``:
reshape the (Nx9, 3) patch predictions to (N, 9, 3), average the 9 patches
per ROI and report grading metrics.

Port of ``multimodal_learning_tpu/cli/ROI_evaluation.py``; it reads the
pickles of either package's eval drivers and runs on the host (numpy and
scipy); it needs no device.

    python -m multimodal_learning_tpu_torch.cli.ROI_evaluation \
        --task grad --mode pathomic --model_name stage1_pathomic_teacher
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..config import parse_args
from ..eval.analysis import load_pred_test, roi_evaluation


def main(argv=None):
    opt = parse_args(argv)
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)
    rows = {b: [] for b in ("fuse", "path", "omic")}
    for k in range(1, 6):
        path = os.path.join(ckpt_dir, f"{opt.model_name}_{k}_pred_test.pkl")
        if not os.path.exists(path):
            continue
        d = load_pred_test(path)
        for branch, acc in rows.items():
            probs = d["probs"].get(branch)
            if probs is None:
                continue
            m = roi_evaluation(np.asarray(probs), np.asarray(d["gt"]),
                               patches_per_roi=9, n_classes=opt.label_dim)
            acc.append(m)
            print(f"fold {k} [{branch}] AUC/AP/F1/F1-IV:",
                  np.round(m, 4))
    for branch, acc in rows.items():
        if acc:
            arr = np.array(acc)
            print(f"[{branch}] mean:", arr.mean(0).round(4),
                  "std:", arr.std(0).round(4))
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
