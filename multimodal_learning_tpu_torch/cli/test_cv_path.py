"""Unimodal pathology student eval driver — reference
``MIA 2023/stage2_unimodal_student/test_cv_path.py``.

Port of ``multimodal_learning_tpu/cli/test_cv_path.py``: loads each fold's
path-only student checkpoint (``<model>_k_best.pt`` or ``.pt``; either
package's), evaluates it on the fold's test split, prints the per-fold and
aggregate 9-metric report and dumps ``<model>_k_pred_test.pkl``.

    python -m multimodal_learning_tpu_torch.cli.test_cv_path --task grad \
        --mode pathomic --model_name dscd_student

Runs on CUDA; ``MML_PLATFORM=cpu`` runs it on the CPU.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..config import parse_args
from ..data.pipeline import Loader, PathomicDataset
from ..eval.analysis import save_pred_test
from ..eval.metrics import extended_grading_metrics, one_hot
from ..models.factory import define_model
from ..models.import_flax import state_dict_from_flax
from ..train.loop import evaluate
from ..train.steps import build_eval_step
from ..utils.checkpoint import load_checkpoint
from ._platform import select_device
from .train_cv_MT import load_data


def main(argv=None):
    device = select_device()
    opt = parse_args(argv)
    data = load_data(opt, patches=not opt.synthetic_data)
    eval_opt = opt.replace(mode="path")
    eval_step = build_eval_step(eval_opt)
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)

    all_ext = []
    for k in sorted(data["cv_splits"].keys()):
        path = os.path.join(ckpt_dir, f"{opt.model_name}_{k}_best.pt")
        if not os.path.exists(path):
            path = os.path.join(ckpt_dir, f"{opt.model_name}_{k}.pt")
        ckpt = load_checkpoint(path)
        model = define_model(eval_opt, generator=torch.Generator())
        model.load_state_dict(state_dict_from_flax(
            ckpt["model_state_dict"], ckpt.get("batch_stats", {})),
            strict=True)
        split = data["cv_splits"][k]
        loader = Loader(PathomicDataset(eval_opt, split, "test", train=False),
                        opt.batch_size, shuffle=False, drop_last=False,
                        n_views=1, workers=opt.host_workers)
        try:
            res = evaluate(eval_opt, eval_step, model.to(device), loader,
                           device,
                           torch.Generator(device=device).manual_seed(
                               opt.seed))
        finally:
            loader.close()
        ext = (extended_grading_metrics(one_hot(res["gt"], opt.label_dim),
                                        res["probs"]["path"])
               if opt.task == "grad" else {})
        all_ext.append(ext)
        print(f"fold {k}:", {m: round(v, 4) for m, v in ext.items()})
        save_pred_test(
            os.path.join(ckpt_dir, f"{opt.model_name}_{k}_pred_test.pkl"),
            {"pred_test": res["pred_test"], "probs": res["probs"],
             "gt": res["gt"],
             "patnames": list(split["test"].get("x_patname", []))})
    if all_ext and all_ext[0]:
        keys = sorted(all_ext[0].keys())
        arr = np.array([[m[kk] for kk in keys] for m in all_ext])
        print("mean:", dict(zip(keys, arr.mean(0).round(4))))
        print("std: ", dict(zip(keys, arr.std(0).round(4))))
    return all_ext


if __name__ == "__main__":
    main(sys.argv[1:])
