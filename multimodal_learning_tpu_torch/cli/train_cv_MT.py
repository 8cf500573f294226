"""Teacher CV driver — reference ``MICCAI-2022/train_cv_MT.py``.

Port of ``multimodal_learning_tpu/cli/train_cv_MT.py``: loops the folds of
the split pickle (or of ``--synthetic_data``), trains the mean-teacher
multimodal model of each, writes its fold checkpoints (in the JAX
package's layout) and prints running mean metrics per branch
(``train_cv_MT.py:145-151``).

    python -m multimodal_learning_tpu_torch.cli.train_cv_MT --task grad \
        --mode pathomic --pred_distill 1 --CRD_distill 0 --cut_fuse_grad True \
        --model_name stage1_pathomic_teacher --beta1 0.9

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
from ..data.splits import (load_cv_splits, make_synthetic_splits,
                           split_pickle_path)
from ..parallel.mesh import (is_writer, launch_for,
                             maybe_init_distributed, print0)
from ..train.loop import train_teacher
from ._platform import select_device


def load_data(opt, patches: bool = False):
    """The CV splits the drivers train and evaluate on: fabricated from
    ``opt.seed`` with ``--synthetic_data`` (the same split in both
    packages), else the reference's split pickle."""
    if opt.synthetic_data:
        return make_synthetic_splits(n_train=64, n_test=32,
                                     n_folds=opt.synthetic_folds,
                                     roi_size=max(64, opt.input_size_path),
                                     seed=opt.seed)
    return load_cv_splits(split_pickle_path(opt, patches=patches))


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
        patch_path = split_pickle_path(opt, patches=True)   # :48
        if os.path.exists(patch_path):
            patches = load_cv_splits(patch_path)

    results = {}
    branch_metrics = {"fuse": [], "path": [], "omic": []}
    for k in sorted(data["cv_splits"].keys()):
        print0(f"*******************************************\n"
               f"************** SPLIT ({k}) **************\n"
               f"*******************************************")
        res, _ = train_teacher(opt, data, k, patches_data=patches,
                               device=device)
        results[k] = res
        if opt.task == "grad":
            for name in branch_metrics:
                m = res.get(f"metrics_{name}")
                if m is not None:
                    branch_metrics[name].append(m)
                    print0(f"[{name}] running mean AUC/AP/F1/F1-IV:",
                           np.array(branch_metrics[name]).mean(0))
        else:
            print0(f"fold {k} C-index:",
                   {n: res.get(f"cindex_{n}") for n in branch_metrics})
    print0(f"finished {len(results)} folds")
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
