"""Eval-only CV driver — reference ``MICCAI-2022/test_cv_MT.py``.

Port of ``multimodal_learning_tpu/cli/test_cv_MT.py``: loads each fold's
``<model>_k_best.pt`` (or ``.pt``; either package's), evaluates it on the
fold's test split, dumps ``<model>_k_pred_test.pkl`` and aggregates the
branch metrics.

    python -m multimodal_learning_tpu_torch.cli.test_cv_MT --task grad \
        --mode pathomic --model_name stage1_pathomic_teacher

Without a fold checkpoint, ``--pretrained_path`` evaluates weights
converted from the reference's own ``torch.save`` dict
(``cli.convert_torch --arch pathomic``); a ``{k}`` in it names one file
per fold:

    python -m multimodal_learning_tpu_torch.cli.test_cv_MT --task grad \
        --mode pathomic --model_name released \
        --pretrained_path 'released/teacher_{k}.npz'

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
from ..models.factory import define_model
from ..models.import_flax import state_dict_from_flax
from ..models.import_torch import apply_pretrained
from ..train.loop import evaluate
from ..train.steps import build_eval_step
from ..utils.checkpoint import load_checkpoint
from ._platform import select_device
from .train_cv_MT import load_data


def _pretrained_fold_model(opt, k):
    """The released-checkpoint path (JAX ``cli/test_cv_MT.py:27-53``): a
    model drawn from ``opt.seed`` with ``--pretrained_path`` (its ``{k}``
    filled in) merged in.  Only a full pathomic file replaces every leaf;
    the reference always loads its fold checkpoint
    (``test_cv_MT.py:52-65``)."""
    model = define_model(opt, generator=torch.Generator().manual_seed(
        opt.seed))
    return apply_pretrained(
        opt.replace(pretrained_path=opt.pretrained_path.replace("{k}",
                                                                str(k))),
        model, log=print)


def run_fold(opt, data, k, use_best=True, device="cuda"):
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)
    suffix = "_best.pt" if use_best else ".pt"
    path = os.path.join(ckpt_dir, f"{opt.model_name}_{k}{suffix}")
    if not os.path.exists(path):
        path = os.path.join(ckpt_dir, f"{opt.model_name}_{k}.pt")
    if not os.path.exists(path) and getattr(opt, "pretrained_path", ""):
        model = _pretrained_fold_model(opt, k)
    else:
        ckpt = load_checkpoint(path)
        model = define_model(opt)
        model.load_state_dict(state_dict_from_flax(
            ckpt["model_state_dict"], ckpt.get("batch_stats", {})),
            strict=True)
    model.to(device)
    split = data["cv_splits"][k]
    loader = Loader(PathomicDataset(opt, split, "test", train=False),
                    opt.batch_size, shuffle=False, drop_last=False,
                    n_views=1, workers=opt.host_workers)
    try:
        res = evaluate(opt, build_eval_step(opt), model, loader, device,
                       torch.Generator(device=device).manual_seed(opt.seed))
    finally:
        loader.close()
    # dump predictions for offline patient-level analysis
    # (reference pickles pred_test per fold, train_cv_MT.py:134-135); a
    # released checkpoint may have no fold directory yet
    os.makedirs(ckpt_dir, exist_ok=True)
    save_pred_test(os.path.join(ckpt_dir, f"{opt.model_name}_{k}_pred_test.pkl"),
                   {"pred_test": res["pred_test"], "probs": res["probs"],
                    "gt": res["gt"],
                    "patnames": list(split["test"].get("x_patname", []))})
    return res


def main(argv=None):
    device = select_device()
    opt = parse_args(argv)
    data = load_data(opt)
    metrics = {"fuse": [], "path": [], "omic": []}
    for k in sorted(data["cv_splits"].keys()):
        res = run_fold(opt, data, k, device=device)
        for name in metrics:
            m = res.get(f"metrics_{name}")
            if m is not None:
                metrics[name].append(m)
        print(f"fold {k}:",
              {n: res.get(f"acc_{n}") for n in metrics
               if res.get(f"acc_{n}") is not None})
    for name, ms in metrics.items():
        if ms:
            arr = np.array(ms)
            print(f"[{name}] AUC/AP/F1/F1-IV mean:", arr.mean(0),
                  "std:", arr.std(0))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
