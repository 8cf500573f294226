"""CLAT stage-2 student driver — reference
``MIA 2023/stage2_unimodal_student/train_cv_path_multi_MT.py``.

Port of ``multimodal_learning_tpu/cli/train_cv_path_CLAT.py``: trains the
adaptive-teaching path-only student of each fold against the frozen
stage-1 teacher named by ``--fixed_model`` (its fold checkpoints, in the
JAX package's layout, from either package), writes the student's fold
checkpoints in the same layout and prints the running mean and std of the
9-metric report.  Canonical recipe (``train_20230805.sh:5-9``):

    python -m multimodal_learning_tpu_torch.cli.train_cv_path_CLAT \
        --mode pathomic --distill crd --num_teachers 2 --assign_weights True \
        --loss_weighting GK_refine --use_grads_thresh True \
        --grads_thresh 0.25 --pos_mode exact --pos_extra neighbors \
        --nce_p 6 --nce_k 4096 --max_discrep 1 --fixed_model clat_teacher \
        --model_name clat_student

Runs on CUDA; ``MML_PLATFORM=cpu`` runs it on the CPU.  ``--data_parallel
N`` (-1: every visible card) trains on N ranks, one per card (NCCL; gloo
on the CPU), which the driver spawns itself; under ``torchrun`` with
``MML_MULTIHOST=1`` the job's processes are the ranks.  Rank 0 alone
prints, writes and returns the results (``parallel/mesh.py``).
"""
from __future__ import annotations

import os
import sys

import numpy as np

from ..config import parse_args, print_options
from ..data.splits import load_cv_splits, split_pickle_path
from ..parallel.mesh import (is_writer, launch_for,
                             maybe_init_distributed, print0)
from ..train.student_clat import train_clat_student
from ._platform import select_device
from .train_cv_MT import load_data


def main(argv=None):
    device = select_device()
    maybe_init_distributed(device)
    argv = sys.argv[1:] if argv is None else argv
    opt = parse_args(argv, save=False)
    launched = launch_for(opt, device, main, (argv,))
    if launched is not None:
        return launched
    if is_writer():
        print_options(opt)
    data = load_data(opt)
    patches = None
    if not opt.synthetic_data:
        patch_path = split_pickle_path(opt, patches=True)
        if os.path.exists(patch_path):
            patches = load_cv_splits(patch_path)

    results, fold_ext = {}, []
    for k in sorted(data["cv_splits"].keys()):
        print0(f"*************** SPLIT ({k}) ***************")
        res, _, ext = train_clat_student(opt, data, k, patches_data=patches,
                                         device=device)
        results[k] = res
        if ext:
            fold_ext.append(ext)
            keys = sorted(ext)
            arr = np.array([[m[kk] for kk in keys] for m in fold_ext])
            print0("9-metric mean:", dict(zip(keys, arr.mean(0).round(4))))
            print0("9-metric std: ", dict(zip(keys, arr.std(0).round(4))))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
