"""Teacher training and eval loops (PyTorch).

Port of ``multimodal_learning_tpu/train/loop.py`` (reference
``train_test_MT.py`` train()/test() and the fold driver ``train_cv_MT.py``):
epoch scheduling, the CRD-weight drop at epoch 15
(``train_test_MT.py:118-119``), the patches-loader switch for the last 15
epochs (``:287-289``), best-checkpoint selection by fused test accuracy
after epoch 15 (``:295-307``), the plateau LR, mid-fold snapshots and
resume, and the final fold checkpoint.

The host reads the device only once per epoch: the step's loss sums and
accuracy counts are added up on the device and fetched after the epoch, and
``evaluate`` collects its outputs on the device and fetches them after the
last batch.  Fold checkpoints are written in the JAX package's pickle
layout (``utils/checkpoint.py``), so either package evaluates the other's
folds.

The t-SVD teacher (``--tSVD_loss``) refreshes its ADMM tensors every
``aux_iter`` batches of an epoch, a schedule the host keeps
(``batch_idx % aux_iter == 0``, as the JAX loop does), so no device read
decides it.

The masked CLAT teacher (``--masking 1``, mode pathomic) trains on 4
views with the SLIC label maps of ``--num_superpixels`` segments and
switches to the masked step once ``epoch > --start_epoch``
(``train_test_MT_SP_Masking.py:199``).

``--fusion_type mmdynamics`` trains through
``build_mmdynamics_train_step`` (JAX ``loop.py:180-181``); its metrics are
``loss`` and ``correct_fuse`` and its eval the fused branch alone.

``--data_parallel`` N (or -1, every visible device) trains on N ranks
(``parallel/mesh.py``): called outside a rank, the driver launches them
and returns rank 0's result.  Each rank loads its rows of every global
batch and evaluates the whole test set (so the ``--test_augment``
generator and the plateau tracker stay in step); every rank loads a
``--resume`` snapshot after a barrier; only rank 0 writes snapshots,
checkpoints and ``metrics.jsonl`` and logs.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..data.pipeline import Loader, PathomicDataset, PrefetchLoader
from ..eval.metrics import (accuracy_cox, concordance_index, cox_log_rank,
                            grading_metrics, one_hot)
from ..models.factory import define_model, is_dynamics
from ..models.import_flax import flax_from_state_dict
from ..parallel.mesh import (barrier, is_writer, launch_for,
                             setup_data_parallel)
from ..utils.checkpoint import (resume_train_state, save_checkpoint,
                                save_train_state)
from ..utils.logging import MetricsLogger
from .import_state import param_tree
from .schedules import PlateauTracker, make_lr_schedule
from .steps import (build_eval_step, build_mmdynamics_train_step,
                    build_teacher_train_step, init_teacher_state,
                    resolve_device)

_BRANCHES = ("fuse", "path", "omic")


def _quiet(*args, **kwargs) -> None:
    """The log of a rank that is not rank 0."""


def rank_setup(opt, fold: int, dev, log):
    """A driver's data-parallel set-up in this process (``parallel.
    setup_data_parallel``): ``(device, rank, world, log)``, with the rank's
    device and ``log`` silenced on every rank but 0."""
    dp = setup_data_parallel(opt, opt.seed + fold)
    if dp is None:
        return dev, 0, 1, log
    return dp.device, dp.rank, dp.world, log if is_writer() else _quiet


def _fetch(tensors):
    """A list of per-batch device tensors, concatenated on the device, as
    one numpy array (None for an empty list)."""
    return torch.cat(tensors).cpu().numpy() if tensors else None


def evaluate(opt, eval_step, model, loader, device,
             generator: Optional[torch.Generator] = None) -> Dict:
    """reference ``test()`` (``train_test_MT.py:340-458``): per-branch
    probabilities or risks, losses, metrics and the ``pred_test`` list of
    offline analysis.  A host ``Loader`` is wrapped in a 2-deep
    ``PrefetchLoader`` on ``device``."""
    if isinstance(loader, Loader):
        loader = PrefetchLoader(loader, depth=2, device=device)
    probs = {name: [] for name in _BRANCHES}
    feats = {name: [] for name in _BRANCHES}
    loss_sums: Dict[str, torch.Tensor] = {}
    gts, times, events = [], [], []
    n_batches = 0
    for batch in loader:
        out, parts = eval_step(model, batch, generator)
        n_batches += 1
        for name in _BRANCHES:
            pred = getattr(out, f"pred_{name}")
            if pred is not None:
                probs[name].append(pred)
            feat = getattr(out, f"{name}_feat")
            if feat is not None:
                feats[name].append(feat)
        for k, v in parts.items():
            loss_sums[k] = loss_sums[k] + v if k in loss_sums else v
        gts.append(batch["g"])
        times.append(batch["t"])
        events.append(batch["e"])

    probs = {k: _fetch(v) for k, v in probs.items()}
    feats = {k: _fetch(v) for k, v in feats.items()}
    losses = dict(zip(_BRANCHES, torch.stack(
        [loss_sums[f"loss_{name}"] for name in _BRANCHES]).tolist()
        if loss_sums else [0.0] * len(_BRANCHES)))
    gt, t_all, e_all = _fetch(gts), _fetch(times), _fetch(events)
    res: Dict = {"gt": gt, "n": len(gt), "probs": probs, "feats": feats}
    for name in _BRANCHES:
        res[f"loss_{name}"] = losses[name] / max(n_batches, 1)
    res["loss"] = sum(losses.values()) / max(n_batches, 1)

    if opt.task == "grad":
        oh = one_hot(gt, opt.label_dim)
        for name, p in probs.items():
            if p is None:
                continue
            res[f"acc_{name}"] = float((np.argmax(p, 1) == gt).mean())
            res[f"metrics_{name}"] = grading_metrics(oh, p)
    else:
        for name, p in probs.items():
            if p is None:
                continue
            res[f"cindex_{name}"] = concordance_index(t_all, -p.reshape(-1),
                                                      e_all)
        risk_main = (probs["fuse"] if probs["fuse"] is not None
                     else next(p for p in probs.values() if p is not None))
        risk_main = risk_main.reshape(-1)
        res["pvalue"] = cox_log_rank(risk_main, e_all, t_all)
        res["surv_acc"] = accuracy_cox(risk_main, e_all)
    # pred_test layout parity (train_test_MT.py:452-453)
    risk = {k: (p.reshape(-1) if (p is not None and opt.task == "surv")
                else np.array([])) for k, p in probs.items()}
    res["pred_test"] = [risk["fuse"], risk["path"], risk["omic"], t_all,
                        e_all, probs["fuse"], probs["path"], probs["omic"],
                        gt]
    return res


def fold_payload(opt, fold, epoch, state, metrics, with_crd=False) -> Dict:
    """A fold checkpoint in the JAX package's layout."""
    params, stats = flax_from_state_dict(state.model.state_dict())
    ema_params, ema_stats = flax_from_state_dict(
        state.ema_model.state_dict())
    payload = {"split": fold, "opt": opt, "epoch": epoch,
               "model_state_dict": params, "batch_stats": stats,
               "ema_model_state_dict": ema_params,
               "ema_batch_stats": ema_stats, "metrics": metrics}
    if with_crd:
        payload["crd_params"] = {k: v for k, v in param_tree(state).items()
                                 if k != "model"}
    return payload


def _use_masking(opt) -> bool:
    return bool(opt.masking) and opt.mode == "pathomic"


def train_teacher(opt, data: Dict, fold: int,
                  patches_data: Optional[Dict] = None, log=print,
                  device=None) -> Tuple[Dict, Dict]:
    """One fold of teacher training on ``device`` (CUDA when None).
    Returns ``(final_eval, best_info)``.  Under ``--data_parallel`` outside
    a rank it launches the ranks (``data``, ``patches_data`` and ``log``
    must pickle) and returns rank 0's result."""
    dev = resolve_device(device)
    launched = launch_for(opt, dev, train_teacher,
                          (opt, data, fold, patches_data, log, device))
    if launched is not None:
        return launched
    dev, rank, world, log = rank_setup(opt, fold, dev, log)
    split = data["cv_splits"][fold]
    need_contrast = opt.CRD_distill == 1 or opt.distill == "crd"
    masking = _use_masking(opt)
    train_ds = PathomicDataset(
        opt, split, "train", train=True, contrast=need_contrast,
        superpixels=opt.num_superpixels if masking else 0)
    test_ds = PathomicDataset(opt, split, "test", train=False)
    # the masked teacher's 4 views: the student's, the EMA's and the two
    # the EMA distils the masked forwards on (data_loaders_MT_SP.py:446-453)
    loaders = [Loader(train_ds, opt.batch_size, shuffle=True, drop_last=True,
                      n_views=4 if masking else 2, workers=opt.host_workers,
                      seed=opt.seed + fold, rank=rank, world=world),
               Loader(test_ds, opt.batch_size, shuffle=False,
                      drop_last=False, n_views=1, workers=opt.host_workers,
                      seed=opt.seed)]
    train_loader, test_loader = loaders
    patches_loader = None
    if patches_data is not None:
        patches_ds = PathomicDataset(opt, patches_data["cv_splits"][fold],
                                     "test", train=False)
        patches_loader = Loader(patches_ds, opt.batch_size, shuffle=False,
                                drop_last=False, n_views=1,
                                workers=opt.host_workers, seed=opt.seed)
        loaders.append(patches_loader)
    try:
        return _train_fold(opt, fold, dev, train_loader, test_loader,
                           patches_loader, log)
    finally:
        for loader in loaders:
            loader.close()


def _train_fold(opt, fold, dev, train_loader, test_loader, patches_loader,
                log):
    n_data = len(train_loader.ds)
    opt = opt.replace(n_data=n_data)
    steps_per_epoch = len(train_loader)
    seed = opt.seed + fold
    model = define_model(opt, generator=torch.Generator().manual_seed(seed))
    state = init_teacher_state(opt, model,
                               make_lr_schedule(opt, steps_per_epoch),
                               n_data, seed=seed, device=dev)
    log("Number of Trainable Parameters: %d" % sum(
        p.numel() for m in (state.model, state.embeds)
        for p in m.parameters()))
    train_step = (build_mmdynamics_train_step(opt) if is_dynamics(opt)
                  else build_teacher_train_step(opt))
    masked_step = (build_teacher_train_step(opt, masking=True)
                   if _use_masking(opt) else None)
    eval_step = build_eval_step(opt)

    total_epochs = opt.niter + opt.niter_decay
    best = {"acc": 0.0, "epoch": -1}
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)
    writer = is_writer()
    mlog = MetricsLogger(ckpt_dir, run_name=f"teacher_fold{fold}",
                         enabled=writer)
    final_eval = None

    # mid-fold resume from the latest snapshot (full train state incl.
    # optimizer, EMA and banks)
    snap_path = os.path.join(ckpt_dir, f"{opt.model_name}_{fold}_state.pt")
    start_epoch, snap_extra = opt.epoch_count, None
    if opt.resume:
        if opt.data_parallel:
            barrier()   # rank 0 may still be writing the snapshot
        # the port's .pt, else the JAX package's .snap
        start_epoch, snap_extra = resume_train_state(opt, state, ckpt_dir,
                                                     fold, log)

    plateau = PlateauTracker() if opt.lr_policy == "plateau" else None
    if plateau is not None and snap_extra and "plateau" in snap_extra:
        plateau.load_state_dict(snap_extra["plateau"])

    for epoch in range(start_epoch, total_epochs + 1):
        crd_weight = 0.01 if epoch >= 15 else opt.CRD_weight
        t0 = time.time()
        sums: Dict[str, torch.Tensor] = {}
        n_samples = 0
        step_fn = (masked_step if masked_step is not None
                   and epoch > opt.start_epoch else train_step)
        for batch_idx, batch in enumerate(PrefetchLoader(
                train_loader, depth=opt.prefetch_depth, device=dev)):
            state, metrics = step_fn(
                state, batch, crd_weight,
                tsvd_update=batch_idx % opt.aux_iter == 0)
            n_samples += opt.batch_size
            for k, v in metrics.items():
                if k.startswith(("loss", "correct")):
                    v = v.double()
                    sums[k] = sums[k] + v if k in sums else v
        agg = dict(zip(sums, torch.stack(list(sums.values())).tolist())) \
            if sums else {}
        dt = time.time() - t0
        nb = max(steps_per_epoch, 1)

        loader_for_eval = test_loader
        if patches_loader is not None and epoch > total_epochs - 15:
            loader_for_eval = patches_loader  # train_test_MT.py:287-289
        res = evaluate(opt, eval_step, state.model, loader_for_eval, dev,
                       state.generator)
        final_eval = res

        if plateau is not None:
            # ReduceLROnPlateau on the eval loss (networks_new.py:122)
            state.optimizer.lr_scale = plateau.step(res["loss"])

        if (writer and opt.snapshot_every > 0
                and epoch % opt.snapshot_every == 0):
            save_train_state(snap_path, state, epoch,
                             extra={"plateau": plateau.state_dict()}
                             if plateau else None)

        if opt.task == "grad":
            test_acc = res.get("acc_fuse", res.get("acc_path",
                                                   res.get("acc_omic", 0.0)))
        else:
            test_acc = res.get("cindex_fuse", res.get(
                "cindex_path", res.get("cindex_omic", 0.0)))
        if epoch > 15 and test_acc > best["acc"]:  # :295-307
            best = {"acc": test_acc, "epoch": epoch}
            if writer:
                save_checkpoint(
                    os.path.join(ckpt_dir,
                                 f"{opt.model_name}_{fold}_best.pt"),
                    fold_payload(opt, fold, total_epochs, state,
                                 res.get("metrics_fuse")))

        mlog.log({"epoch": epoch,
                  "train_loss": agg.get("loss", 0) / nb,
                  "samples_per_s": n_samples / max(dt, 1e-9),
                  **{f"test_{k}": v for k, v in res.items()
                     if k.startswith(("acc_", "cindex_", "loss"))
                     and np.isscalar(v)}})
        if opt.verbose:
            msg = (f"[fold {fold}] epoch {epoch}/{total_epochs} "
                   f"loss {agg.get('loss', 0) / nb:.4f} "
                   f"({n_samples / max(dt, 1e-9):.1f} samples/s)")
            for name in _BRANCHES:
                if opt.task == "grad" and f"acc_{name}" in res:
                    msg += f" test_{name}_acc {res[f'acc_{name}']:.4f}"
                elif f"cindex_{name}" in res:
                    msg += f" cindex_{name} {res[f'cindex_{name}']:.4f}"
            log(msg)

    # final fold checkpoint (train_cv_MT.py:119-130)
    if writer:
        save_checkpoint(
            os.path.join(ckpt_dir, f"{opt.model_name}_{fold}.pt"),
            fold_payload(opt, fold, total_epochs, state,
                         final_eval.get("metrics_fuse") if final_eval
                         else None, with_crd=True))
    return final_eval, best
