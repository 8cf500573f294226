"""CLAT stage-2 adaptive-teaching student (PyTorch).

Port of ``multimodal_learning_tpu/train/student_clat.py`` (reference
``MIA 2023/stage2_unimodal_student/train_test_path_multi_distill.py`` and
``train_cv_path_multi_MT.py``, with its 9-metric best tracking).  One step
(reference ``:320-460``):

- the path-only ResNet student's forward on view 1; under ``no_grad`` the
  EMA self-teacher's on view 2 (train mode) and the frozen stage-1 fused
  teacher's on view 1 (``train/student.py:frozen_teacher_forward``);
- per-sample DistillKL from both teachers;
- query-discrepancy sample weights: the probabilistic-margin confidence
  gap of teacher and student, clipped at ``max_discrep`` (``:131-158``);
  1 before ``start_reweight``, the weight + 1 from then on (``:371-377``);
- CRD v10 (``contrast/crd_v10.py``): kNN-neighbour or k-means-centre
  positives from each teacher's bank, the sample weights folded into the
  per-sample NCE loss; each bank takes its Z and the batch's rows in the
  step, from the forward's features, as the JAX step does;
- ``GK_refine``: per-sample pairwise cosines of the loss gradients at the
  student feature, [div1, div2, kd1, kd2, CE], thresholded
  (``gradweight.gk_refine_thresh_weights``, ``:80-128``).  The gradients
  are taken with ``torch.autograd.grad`` with respect to ``path_feat``
  only, so autograd walks the heads and never the trunk; the JAX step
  re-evaluates the loss function per gradient, which is the same function.

The student's state, its frozen teacher and the teacher's checkpoint come
from ``train/student.py`` (``init_student_state``, ``load_teacher``).

Under a data group (``--data_parallel``, ``parallel/mesh.py``) each rank
runs the forwards on its rows of the global batch, then gathers the
features, predictions, labels, indices and contrast samples, and computes
the weights, the losses and the banks' updates on the global batch;
``feature_grads`` differentiates with respect to the gathered feature.
"""
from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..contrast.crd_v10 import (assign_sample_weights, contrast_loss_v10,
                                crd_v10_scores)
from ..data.augment import augment_views
from ..data.pipeline import Loader, PathomicDataset, PrefetchLoader
from ..eval.diagnostics import evaluate_feature
from ..eval.metrics import extended_grading_metrics, one_hot
from ..gradweight import feature_grads, gk_refine_thresh_weights
from ..losses import cox_loss, distill_kl, l1_regularizer, nll_loss
from ..models.common import apply_act
from ..models.factory import _dtype, define_model
from ..parallel.mesh import barrier, is_writer, launch_for
from ..utils.checkpoint import (resume_train_state, save_checkpoint,
                                save_train_state)
from ..utils.logging import MetricsLogger, span
from .ema import update_ema
from .loop import evaluate, fold_payload, rank_setup
from .schedules import PlateauTracker, make_lr_schedule
from .state import TrainState
from .steps import build_eval_step, gather_outputs, resolve_device
from .student import frozen_teacher_forward, init_student_state, load_teacher


def _check_clat_flags(opt) -> None:
    if opt.assign_weights and opt.loss_weighting != "GK_refine":
        raise NotImplementedError(
            f"--loss_weighting {opt.loss_weighting}: the CLAT student only "
            "implements GK_refine, as the reference "
            "(train_test_path_multi_distill.py:421-424 has no other branch)")


def build_clat_student_step(opt, teacher: nn.Module,
                            class_mask: torch.Tensor):
    """``step(state, batch, reweight_on, gumbel=None) -> (state,
    metrics)``.

    ``teacher`` is the frozen multimodal model (``freeze_teacher``);
    ``class_mask`` [C, n_data] marks each class's bank rows (the stage-2
    loader's ``train_class_idx``).  ``batch`` holds device tensors:
    ``path_views`` uint8 [B, 2, H, W, 3], ``omic``, ``g``, and with
    ``--distill crd`` ``index`` [B] and ``sample_idx`` [B, 1 + nce_k].
    ``reweight_on`` is a host bool (``epoch >= start_reweight``);
    ``gumbel`` ({"fuse"|"ema": [2, C, n_data]}) replaces the k-means noise
    the ``centers`` positives would draw from ``state.generator``.
    Metrics keep the JAX names and stay on the device.

    The step's phases are spans of the recorder (``utils/logging``), as
    the teacher step's: ``step.augment``, ``step.forward``,
    ``step.losses`` (in it ``contrast.scores``, ``contrast.bank_update``
    and ``gk_refine``), ``step.backward``, ``step.optimizer``."""
    _check_clat_flags(opt)
    dtype = _dtype(opt)
    cmask = class_mask.float()
    alpha = 1.0 if opt.alpha is None else opt.alpha
    beta = 1.0 if opt.beta is None else opt.beta

    def step(state: TrainState, batch, reweight_on: bool,
             gumbel: Optional[Dict[str, torch.Tensor]] = None):
        model, ema = state.model.train(), state.ema_model.train()
        with span("step.augment"):
            views = augment_views(state.generator, batch["path_views"],
                                  dtype=dtype)
            x1, x2 = views[:, 0], views[:, 1]
        with span("step.forward"):
            with torch.no_grad():
                _, ema_feat, ema_logit, _ = ema(x2)
            t_out = frozen_teacher_forward(opt, teacher, x1, batch["omic"],
                                           state.teacher_generator)

            _, path_feat, _, pred_path = model(x1)
            (rows,), batch = gather_outputs(
                [(path_feat, pred_path, ema_feat, ema_logit, t_out.fuse_feat,
                  t_out.hazard_fuse)], batch)
        path_feat, pred_path, ema_feat, ema_logit, t_fuse_feat, t_hazard = \
            rows
        with span("step.losses"):
            bsz, g = path_feat.shape[0], batch["g"]
            loss_cls = (cox_loss(batch["t"], batch["e"], pred_path)
                        if opt.task == "surv" else nll_loss(pred_path, g))
            fc = model.fc_new2
            logit = F.linear(path_feat, fc.weight, fc.bias)   # float32

            # query-discrepancy sample weights (:359-377)
            prob_s = torch.softmax(logit.detach(), 1)
            ws = {}
            for name, t_logit in (("fuse", t_hazard),
                                  ("ema", ema_logit)):
                w = assign_sample_weights(prob_s, torch.softmax(t_logit, 1),
                                          g, opt.max_discrep, opt.label_dim)
                ws[name] = w + 1.0 if reweight_on else torch.ones_like(w)

            kd = {"div1": alpha * distill_kl(logit, t_hazard,
                                             opt.kd_T, per_sample=True),
                  "div2": alpha * distill_kl(logit, ema_logit, opt.kd_T,
                                             per_sample=True)}
            if opt.distill == "crd":
                t_feats = {"fuse": t_fuse_feat, "ema": ema_feat}
                for i, name in enumerate(("fuse", "ema"), 1):
                    f_s = state.embeds[f"crd_{name}_s"](path_feat)
                    f_t = state.embeds[f"crd_{name}_t"](t_feats[name])
                    out_s, out_t, sim_s, sim_t = crd_v10_scores(
                        state.banks[name], f_s, f_t, g, batch["index"],
                        batch["sample_idx"], class_mask=cmask,
                        num_pos=opt.nce_p, pos_extra=opt.pos_extra,
                        T=opt.nce_t, momentum=opt.nce_m,
                        gumbel=gumbel.get(name) if gumbel else None,
                        generator=state.generator, update_bank=True)
                    _, sl_s = contrast_loss_v10(out_s, opt.n_data, opt.nce_p,
                                                ws[name], sim_s)
                    _, sl_t = contrast_loss_v10(out_t, opt.n_data, opt.nce_p,
                                                ws[name], sim_t)
                    kd[f"kd{i}"] = beta * (sl_s + sl_t)
            kd_vals = [kd[k] for k in sorted(kd)]    # per-sample [B] each

            if opt.assign_weights:
                # each summed per-sample loss's gradient at the feature is
                # the per-sample gradient: loss[b] depends on feat[b] alone
                with span("gk_refine"):
                    grads = feature_grads(
                        [v.sum() / bsz for v in kd_vals]
                        + [nll_loss(apply_act(opt.act_type, logit), g)],
                        path_feat)
                    scale = gk_refine_thresh_weights(
                        grads, opt.grads_thresh,
                        use_thresh=opt.use_grads_thresh)
                # sum_b sum_j scale[b, j] loss_j[b] / B (:117)
                loss_kd = (scale[:, :len(kd_vals)]
                           * torch.stack(kd_vals, dim=1)).sum() / bsz
                mean_scale = scale.mean(dim=0)
            else:
                loss_kd = sum(v.sum() / bsz for v in kd_vals)
                mean_scale = torch.zeros(len(kd_vals) + 1,
                                         device=logit.device)

            loss = (opt.lambda_nll * loss_cls + opt.lambda_reg
                    * l1_regularizer(model, opt.reg_type) + loss_kd)
        with span("step.optimizer"):
            state.optimizer.zero_grad()
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            state.optimizer.step()
            update_ema(model, ema, opt.ema_decay, state.step)
        state.step += 1

        metrics = {"loss": loss, "loss_cls": loss_cls, "loss_KD": loss_kd,
                   "scale": mean_scale, "w1_mean": ws["fuse"].mean(),
                   "w2_mean": ws["ema"].mean()}
        if opt.task == "grad":
            metrics["correct_path"] = (pred_path.argmax(dim=1) == g).sum()
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def train_clat_student(opt, data: Dict, fold: int,
                       patches_data: Optional[Dict] = None, log=print,
                       device=None) -> Tuple[Dict, Dict, Dict]:
    """One fold of CLAT stage-2 training on ``device`` (CUDA when None).
    Returns ``(final_eval, best_info, best_ext_metrics)``."""
    _check_clat_flags(opt)
    dev = resolve_device(device)
    launched = launch_for(opt, dev, train_clat_student,
                          (opt, data, fold, patches_data, log, device))
    if launched is not None:
        return launched
    dev, rank, world, log = rank_setup(opt, fold, dev, log)
    split = data["cv_splits"][fold]
    train_ds = PathomicDataset(opt, split, "train", train=True,
                               contrast=opt.distill in ("crd", "hkd"))
    loaders = [Loader(train_ds, opt.batch_size, shuffle=True, drop_last=True,
                      n_views=2, workers=opt.host_workers,
                      seed=opt.seed + fold, rank=rank, world=world),
               Loader(PathomicDataset(opt, split, "test", train=False),
                      opt.batch_size, shuffle=False, drop_last=False,
                      n_views=1, workers=opt.host_workers, seed=opt.seed)]
    if patches_data is not None:
        loaders.append(Loader(
            PathomicDataset(opt, patches_data["cv_splits"][fold], "test",
                            train=False),
            opt.batch_size, shuffle=False, drop_last=False, n_views=1,
            workers=opt.host_workers, seed=opt.seed))
    try:
        return _train_fold(opt, fold, dev, *loaders[:2],
                           loaders[2] if len(loaders) > 2 else None, log)
    finally:
        for loader in loaders:
            loader.close()


def _train_fold(opt, fold, dev, train_loader, test_loader, patches_loader,
                log):
    n_data = len(train_loader.ds)
    opt = opt.replace(n_data=n_data)
    steps_per_epoch = len(train_loader)
    seed = opt.seed + fold
    class_mask = torch.from_numpy(
        one_hot(train_loader.ds.g, opt.label_dim).T).to(dev)  # [C, n_data]
    teacher = load_teacher(opt, fold, dev)
    model = define_model(opt, path_only=True,
                         generator=torch.Generator().manual_seed(seed))
    state = init_student_state(opt, model,
                               make_lr_schedule(opt, steps_per_epoch),
                               n_data, seed=seed, device=dev)
    log("Number of Trainable Parameters: %d" % sum(
        p.numel() for m in (state.model, state.embeds)
        for p in m.parameters()))
    step = build_clat_student_step(opt, teacher, class_mask)
    eval_opt = opt.replace(mode="path")
    eval_step = build_eval_step(eval_opt)

    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)
    writer = is_writer()
    mlog = MetricsLogger(ckpt_dir, run_name=f"clat_student_fold{fold}",
                         enabled=writer)
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

    total_epochs = opt.niter + opt.niter_decay
    best = {"acc": 0.0, "epoch": -1, "ext": None}
    final_eval = None
    for epoch in range(start_epoch, total_epochs + 1):
        t0 = time.time()
        sums: Dict[str, torch.Tensor] = {}
        reweight_on = epoch >= opt.start_reweight
        for batch in PrefetchLoader(train_loader, depth=opt.prefetch_depth,
                                    device=dev):
            state, metrics = step(state, batch, reweight_on)
            for k, v in metrics.items():
                if k.startswith(("loss", "correct", "w1", "w2")):
                    v = v.double()
                    sums[k] = sums[k] + v if k in sums else v
        agg = dict(zip(sums, torch.stack(list(sums.values())).tolist())) \
            if sums else {}
        dt = time.time() - t0
        nb = max(steps_per_epoch, 1)

        loader_for_eval = test_loader
        if patches_loader is not None and epoch > total_epochs - 10:
            loader_for_eval = patches_loader
        res = evaluate(eval_opt, eval_step, state.model, loader_for_eval,
                       dev, state.generator)
        final_eval = res
        # the 9-metric CLAT report (stage2 ...distill.py:655-672)
        ext = (extended_grading_metrics(one_hot(res["gt"], opt.label_dim),
                                        res["probs"]["path"])
               if opt.task == "grad" else {})
        res["ext_metrics"] = ext
        if plateau is not None:
            state.optimizer.lr_scale = plateau.step(res["loss"])
        if (writer and opt.snapshot_every > 0
                and epoch % opt.snapshot_every == 0):
            save_train_state(snap_path, state, epoch,
                             extra={"plateau": plateau.state_dict()}
                             if plateau else None)

        samples_per_s = opt.batch_size * nb / max(dt, 1e-9)
        mlog.log({"epoch": epoch, "train_loss": agg.get("loss", 0) / nb,
                  "samples_per_s": samples_per_s,
                  "test_acc_path": res.get("acc_path", 0.0),
                  "test_loss": res["loss"]})
        if opt.verbose:
            log(f"[fold {fold}] epoch {epoch}/{total_epochs} "
                f"cls {agg.get('loss_cls', 0) / nb:.4f} "
                f"KD {agg.get('loss_KD', 0) / nb:.4f} "
                f"w1 {agg.get('w1_mean', 0) / nb:.3f} "
                f"test_acc {res.get('acc_path', 0):.4f} "
                f"({samples_per_s:.1f} samples/s)")
        if opt.task == "grad" and agg.get("loss", 0.0) / nb < opt.patience:
            log(f"Early stopping at Epoch {epoch}")
            break
        if epoch > opt.niter_decay - 10 and ext:   # best by the 9 metrics
            avg_metric = float(np.mean(list(ext.values())))
            if avg_metric > best["acc"]:
                best = {"acc": avg_metric, "epoch": epoch, "ext": ext}
                if writer:
                    save_checkpoint(
                        os.path.join(ckpt_dir,
                                     f"{opt.model_name}_{fold}_best.pt"),
                        fold_payload(opt, fold, total_epochs, state, ext))

    # intra/inter-class similarity of the teacher's fused and the
    # student's path features over the test split (reference
    # evaluate_feature, stage2 ...distill.py:170-186)
    if final_eval is not None and opt.task == "grad":
        t_res = evaluate(opt, build_eval_step(opt), teacher, test_loader,
                         dev, state.generator)
        s_feats = final_eval["feats"].get("path")
        t_feats = t_res["feats"].get("fuse")
        if (s_feats is not None and t_feats is not None
                and len(s_feats) == len(t_feats)):
            final_eval["similarity_diagnostics"] = evaluate_feature(
                t_feats, s_feats, final_eval["gt"])
            if opt.verbose:
                log(f"[fold {fold}] similarity diagnostics: "
                    f"{final_eval['similarity_diagnostics']}")

    if writer:
        save_checkpoint(
            os.path.join(ckpt_dir, f"{opt.model_name}_{fold}.pt"),
            fold_payload(opt, fold, total_epochs, state,
                         final_eval.get("ext_metrics") if final_eval
                         else None))
    return final_eval, best, best.get("ext") or {}
