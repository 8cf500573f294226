"""Student distillation CV driver — reference
``MICCAI-2022/train_cv_path_multi_MT.py``.

Port of ``multimodal_learning_tpu/cli/train_cv_path_multi_MT.py``: trains
the path-only student of each fold against the frozen multimodal teacher
named by ``--fixed_model`` (its fold checkpoints, in the JAX package's
layout, from either package), writes the student's fold checkpoints in the
same layout and prints the running mean and std of the path AUC/AP/F1/
F1-IV (``train_cv_path_multi_MT.py:121-124``).

    python -m multimodal_learning_tpu_torch.cli.train_cv_path_multi_MT \
        --mode pathomic --distill crd --num_teachers 2 --assign_weights True \
        --CE_grads True --select_pos_mode hard --pos_mode multi_pos \
        --nce_p 300 --nce_p2 20 --nce_k 1024 --nce_k2 1024 -a 1 -b 0.02 \
        --fixed_model m3lr_teacher --model_name dscd_student

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
from ..train.student import train_student
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

    results, fold_metrics = {}, []
    for k in sorted(data["cv_splits"].keys()):
        print0(f"*************** SPLIT ({k}) ***************")
        res, _, _ = train_student(opt, data, k, patches_data=patches,
                                  device=device)
        results[k] = res
        if res.get("metrics_path") is not None:
            fold_metrics.append(res["metrics_path"])
            arr = np.array(fold_metrics)
            print0("path metrics mean:", arr.mean(0), "std:", arr.std(0))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
