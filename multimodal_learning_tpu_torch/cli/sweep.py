"""One-command synthetic CV sweep over all five BASELINE configs.

Port of ``multimodal_learning_tpu/cli/sweep.py``: the same stages, flags,
fold table and report, driving the port's CLIs; each of them picks its
device itself (CUDA, or the CPU under ``MML_PLATFORM=cpu``).

The reference's "experiment" is a pile of shell recipes run by hand
(``MICCAI-2022/README.md:26-33``, ``MIA 2022/train.sh``, the MIA-2023
``training_script_Masking.sh``/``train_20230805.sh``) whose drivers each
loop folds and print running fold means (``train_cv_MT.py:145-151``).
This driver orchestrates that whole surface as ONE command on fabricated
data, exercising the real CLIs end-to-end — including every checkpoint
handoff the recipes rely on:

  1. omic SNN teacher               (BASELINE config 2, ``train_cv_MT``)
  2. Kronecker-fusion teacher       (config 3) -> ``torch.export``
     artifact -> MICCAI student (``train_cv_path_multi_MT`` on the teacher
     ckpt) -> ``test_cv_path`` -> ``test_cv_MT`` prediction pickles
  3. M3LR t-SVD teacher (config 4)  -> DSCD student -> ``test_cv_path``
  4. CLAT stage-1 masked teacher    (config 5) -> stage-2 CLAT student
     -> ``test_cv_path``
  5. patient-level aggregation over the dumped pickles
     (``evaluation_GBMLGG``)

and writes a fold-mean±std markdown report.  Dims are tiny (the point is
the protocol, not the score); ``--folds 15`` reproduces the reference's
15-fold survival protocol shape, the default 3 keeps CI fast.

    python -m multimodal_learning_tpu_torch.cli.sweep \
        --folds 3 --out_dir /tmp/sweep --report sweep_report.md
"""
from __future__ import annotations

import argparse
import os
import shlex
import sys
import time

import numpy as np

# tiny paper-shaped dims shared by every stage (verify-skill recipe)
_TINY = ("--synthetic_data --task grad --niter_decay 2 --batch_size 8 "
         "--input_size_path 64 --path_dim 16 --omic_dim 16 --mmhid 16 "
         "--feat_dim 8 --reg_type none")


def _args(extra: str, folds: int, out_dir: str) -> list:
    return shlex.split(
        f"{_TINY} --synthetic_folds {folds} --checkpoints_dir {out_dir} "
        + extra)


def _fold_table(metrics) -> list:
    """Normalise either driver return into [(label, header, mean, std)]:

    - ``test_cv_MT`` returns {branch: [fold AUC/AP/F1/F1-IV rows]};
    - ``test_cv_path`` returns [fold {9-metric dict}] (the MIA-2023 report).
    """
    rows = []
    if isinstance(metrics, dict):
        for name, ms in metrics.items():
            if ms:
                arr = np.array(ms)
                rows.append((name, ("AUC", "AP", "F1", "F1-IV"),
                             arr.mean(0), arr.std(0)))
    elif metrics and metrics[0]:
        keys = sorted(metrics[0].keys())
        arr = np.array([[m[k] for k in keys] for m in metrics])
        rows.append(("path", tuple(keys), arr.mean(0), arr.std(0)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        "sweep", description="synthetic CV sweep over the BASELINE configs")
    ap.add_argument("--folds", type=int, default=3,
                    help="CV folds per config (reference protocol: 15)")
    ap.add_argument("--out_dir", default="/tmp/mml_sweep",
                    help="checkpoints/pickles root")
    ap.add_argument("--report", default="",
                    help="write the fold-mean±std report here (markdown)")
    ap.add_argument("--configs", default="omic,teacher,tsvd,clat",
                    help="comma-set of config groups to run")
    args = ap.parse_args(argv)
    want = set(args.configs.split(","))
    folds, out = args.folds, args.out_dir
    os.makedirs(out, exist_ok=True)

    from . import (evaluation_GBMLGG, export_model, test_cv_MT, test_cv_path,
                   train_cv_MT, train_cv_MT_SP_Masking, train_cv_path_CLAT,
                   train_cv_path_multi_MT)

    t0 = time.time()
    report = [f"# Synthetic BASELINE sweep — {folds} fold(s) per config", ""]
    sections = []

    def record(title: str, metrics: dict):
        sections.append((title, _fold_table(metrics)))
        print(f"=== {title}: done ===", flush=True)

    # ---- config 2: unimodal omic SNN teacher ----------------------------
    if "omic" in want:
        train_cv_MT.main(_args(
            "--mode omic --dropout_rate 0.25 --CRD_distill 0 "
            "--pred_distill 0 --model_name sw_omic", folds, out))
        record("omic SNN (config 2)", test_cv_MT.main(_args(
            "--mode omic --model_name sw_omic", folds, out)))

    # ---- config 3: pofusion teacher -> export -> MICCAI student ---------
    if "teacher" in want:
        train_cv_MT.main(_args(
            "--mode pathomic --pred_distill 1 --CRD_distill 0 "
            "--cut_fuse_grad --beta1 0.9 --model_name sw_vt", folds, out))
        # serving handoff: one torch.export artifact per fold
        export_model.main(_args(
            "--mode pathomic --model_name sw_vt --export_batch 4",
            folds, out))
        record("pofusion teacher (config 3)", test_cv_MT.main(_args(
            "--mode pathomic --model_name sw_vt", folds, out)))
        # the recipe's --select_pos_mode mid draws from rank window [30,100)
        # (memory_new.py:311) and so needs nce_p > 30 — infeasible at these
        # tiny dims (the reference crashes identically); "random" is the
        # valid stochastic-window stand-in, "hard" stays with DSCD below
        train_cv_path_multi_MT.main(_args(
            "--mode pathomic --distill crd --num_teachers 2 "
            "--assign_weights True --CE_grads --select_pos_mode random "
            "--pos_mode multi_pos --nce_p 4 --nce_p2 2 --nce_k 8 --nce_k2 4 "
            "-a 1 -b 0.02 --model_name sw_vs --fixed_model sw_vt "
            "--patience 0.0", folds, out))
        record("MICCAI student (config 3)", test_cv_path.main(_args(
            "--mode pathomic --model_name sw_vs", folds, out)))

    # ---- config 4: t-SVD teacher -> DSCD student -------------------------
    if "tsvd" in want:
        train_cv_MT.main(_args(
            "--mode pathomic --pred_distill 1 --CRD_distill 0 "
            "--tSVD_loss True --n_views 4 --tSVD_mode pathomic "
            "--Lambda_global 0.1 --init_type max --beta1 0.5 "
            "--model_name sw_m3lr", folds, out))
        train_cv_path_multi_MT.main(_args(
            "--mode pathomic --distill crd --num_teachers 2 "
            "--assign_weights True --CE_grads --select_pos_mode hard "
            "--pos_mode multi_pos --nce_p 4 --nce_p2 2 --nce_k 8 --nce_k2 4 "
            "-a 1 -b 0.02 --model_name sw_dscd --fixed_model sw_m3lr "
            "--patience 0.0", folds, out))
        record("DSCD student (config 4)", test_cv_path.main(_args(
            "--mode pathomic --model_name sw_dscd", folds, out)))

    # ---- config 5: masked teacher -> CLAT student -------------------------
    if "clat" in want:
        train_cv_MT_SP_Masking.main(_args(
            "--mode pathomic --pred_distill 1 --CRD_distill 0 --masking 1 "
            "--start_epoch 1 --num_superpixels 16 --Path_K 2 --Omic_K 5 "
            "--model_name sw_clat_t", folds, out))
        train_cv_path_CLAT.main(_args(
            "--mode pathomic --distill crd --num_teachers 2 "
            "--assign_weights True --CE_grads --pos_mode multi_pos "
            "--pos_extra neighbors --nce_p 3 --nce_k 8 --max_discrep 1 "
            "--loss_weighting GK_refine --use_grads_thresh True "
            "--grads_thresh 0.25 --start_reweight 2 -a 1 -b 0.02 "
            "--model_name sw_clat_s --fixed_model sw_clat_t "
            "--patience 0.0", folds, out))
        record("CLAT student (config 5)", test_cv_path.main(_args(
            "--mode pathomic --model_name sw_clat_s", folds, out)))

    # ---- patient-level aggregation over the teacher pickles --------------
    agg = None
    if "teacher" in want:
        agg = evaluation_GBMLGG.main(_args(
            "--mode pathomic --model_name sw_vt", folds, out))

    # ---- report ----------------------------------------------------------
    for title, rows in sections:
        report.append(f"## {title}")
        if rows:  # all rows of one section share a header
            header = rows[0][1]
            report.append("| branch | " + " | ".join(header) + " |")
            report.append("|---" * (len(header) + 1) + "|")
            for name, _, m, s in rows:
                report.append(
                    f"| {name} | " + " | ".join(
                        f"{m[i]:.4f}±{s[i]:.4f}"
                        for i in range(len(header))) + " |")
        report.append("")
    if agg:
        report.append("## patient-level aggregation (teacher, "
                      "evaluation_GBMLGG)")
        report.append("| branch/agg | AUC | AP | F1 | F1-IV |")
        report.append("|---|---|---|---|---|")
        for (branch, at), res in agg.items():
            m, ci = res["mean"], res["ci95"]
            report.append(f"| {branch}/{at} | " + " | ".join(
                f"{m[i]:.4f}±{ci[i]:.4f}" for i in range(4)) + " |")
        report.append("")
    report.append(f"_{len(sections)} config groups x {folds} fold(s), "
                  f"{time.time() - t0:.0f}s wall._")
    text = "\n".join(report)
    print(text)
    if args.report:
        with open(args.report, "w") as fh:
            fh.write(text + "\n")
        print("wrote", args.report)
    return sections


if __name__ == "__main__":
    main(sys.argv[1:])
