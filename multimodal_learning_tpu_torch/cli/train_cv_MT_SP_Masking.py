"""CLAT stage-1 driver — reference
``MIA 2023/stage1_multi_modal_teacher/train_cv_MT_SP_Masking.py``.

Port of ``multimodal_learning_tpu/cli/train_cv_MT_SP_Masking.py``: the
superpixel-masked comprehensive teacher is ``train_cv_MT`` with
``--masking 1 --Path_K --Omic_K --num_superpixels`` (recipe
``training_script_Masking.sh:1-2``); the fold loop switches to the masked
step once ``epoch > --start_epoch``.

    python -m multimodal_learning_tpu_torch.cli.train_cv_MT_SP_Masking \
        --task grad --mode pathomic --masking 1 --num_superpixels 100 \
        --Path_K 1 --Omic_K 5 --pred_distill 1 --CRD_distill 0 \
        --model_name clat_teacher --beta1 0.9

Runs on CUDA; ``MML_PLATFORM=cpu`` runs it on the CPU.  ``--data_parallel
N`` (-1: every visible card) trains on N ranks, one per card (NCCL; gloo
on the CPU), which the driver spawns itself; under ``torchrun`` with
``MML_MULTIHOST=1`` the job's processes are the ranks.  Rank 0 alone
prints, writes and returns the results (``parallel/mesh.py``).
"""
from __future__ import annotations

import sys

from .train_cv_MT import main

if __name__ == "__main__":
    main(sys.argv[1:])
