"""Gradient-weighted student distillation (PyTorch).

Port of ``multimodal_learning_tpu/train/student.py`` (reference
``MICCAI-2022/train_test_path_multi_distill.py`` and the MIA-2022
``..._v2.py`` extensions).  One student step:

- the path-only ResNet student's forward on view 1;
- under ``no_grad``: the EMA self-teacher's forward on view 2 in train mode
  (its BatchNorm statistics advance), and the frozen multimodal teacher's
  on view 1 (:func:`frozen_teacher_forward`);
- ``loss_cls`` (NLL or Cox); ``loss_div1/2``, DistillKL from the fused
  teacher and the EMA; ``loss_kd1/2``, CRD v2/v3/v4 from the two teachers,
  each with its own heads and bank; or ``loss_kd1``, one distiller-zoo
  loss of the student feature against the fused teacher feature
  (``--distill similarity|sp|feats_KL|rkd|pkt|hint|correlation``,
  ``losses/distiller_zoo.py``, unscaled by ``beta`` as in JAX), or HKD
  (``--distill hkd``, ``contrast/hkd.py``: two InfoNCE pairs against its
  bank, the second over TAGConv-smoothed embeddings on kNN graphs of the
  student's and the teacher's logits);
- with ``--assign_weights`` and ``--distill crd|kd``: each KD loss's
  gradient at the student feature, taken through the heads only
  (``gradweight.feature_grads``), weighs the KD losses: the cosine-Gram
  ``GK_refine``, ``momentum_AEKD``, the v2 gate (``--student_customize``,
  per sample with ``--sample_KD``), ``GK_refine_param`` over the trunk's
  parameter gradients, or the one-class SVM (``SVM``,
  ``gradweight/svm.py``: one copy of the gradients to the host per step,
  the step's one host synchronisation);
- backward, Adam, EMA; then each CRD bank takes the Z of the raw P+K
  columns (if it has none yet) and the batch's rows, from the features of
  the forward, as the JAX student does after its optimizer step; the HKD
  bank takes the batch's rows from the forward's embeddings likewise.

The KD losses read the student's logits as ``path_feat @ fc_new2`` in
float32, as the JAX student recomputes them, whatever the encoder dtype.

Under a data group (``--data_parallel``, ``parallel/mesh.py``) each rank
runs the three forwards on its rows of the global batch (BatchNorm over
the global batch, the frozen teacher's too under ``--teacher_bn batch``),
then gathers the features and predictions the losses read and computes
them on the global batch: ``feature_grads`` differentiates with respect
to the gathered feature, and ``GK_refine_param`` averages each loss's
parameter gradient over the ranks before its cosine Gram.

Refused: the ``--distill`` values the JAX student wires no loss for
(``attention``, ``vid``, ``kdsvd``, ``fsp``, ``abound``, ``factor``,
``nst``; JAX trains them silently as plain ``kd``: a documented deviation
in ROADMAP's ground rules).
"""
from __future__ import annotations

import contextlib
import copy
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..contrast.crd import (Embed, bank_update, contrast_loss,
                            crd_scores_select, draw_pick, init_bank, set_z)
from ..contrast.hkd import (TAGEncoder, hkd_bank_update, hkd_graph_scores,
                            hkd_scores, init_hkd_bank, knn_adjacency,
                            nce_softmax_loss)
from ..data.augment import augment_views
from ..data.pipeline import Loader, PathomicDataset, PrefetchLoader
from ..gradweight import (aekd_scale, aekd_total, aekd_v2_gate,
                          feature_grads, gk_refine_param_space,
                          momentum_aekd_scale, svm_weights)
from ..losses import (correlation_loss, cox_loss, distill_kl, feats_kl,
                      hint_loss, l1_regularizer, nll_loss, pkt_loss, rkd_loss,
                      sp_loss)
from ..models.common import apply_act
from ..models.factory import _dtype, define_model
from ..models.fusion import _KronEncoder1
from ..models.import_flax import state_dict_from_flax
from ..models.pathomic import PathomicOutput
from ..parallel.mesh import (active, barrier, check_batch, is_writer,
                             launch_for)
from ..utils.checkpoint import (load_checkpoint, resume_train_state,
                                save_checkpoint, save_train_state)
from ..utils.logging import MetricsLogger
from .ema import update_ema
from .loop import evaluate, fold_payload, rank_setup
from .optim import make_optimizer
from .schedules import PlateauTracker, make_lr_schedule
from .state import TrainState
from .steps import (build_eval_step, gather_outputs, init_model,
                    resolve_device)

# the distiller-zoo losses of ``kd1``: the student feature against the
# fused teacher feature (JAX ``train/student.py:219-230``)
ZOO = {"feats_KL": feats_kl, "similarity": sp_loss, "sp": sp_loss,
       "rkd": rkd_loss, "pkt": pkt_loss, "hint": hint_loss,
       "correlation": correlation_loss}
DISTILL_MODES = ("kd", "crd", *ZOO, "hkd")
WEIGHTINGS = ("GK_refine", "momentum_AEKD", "SVM", "GK_refine_param")


def _refuse_unported(opt) -> None:
    if opt.distill not in DISTILL_MODES:
        raise NotImplementedError(
            f"--distill {opt.distill}: the JAX student wires no loss for it "
            "and trains it as plain kd (its KL terms only); the port "
            f"accepts {DISTILL_MODES} (a documented deviation, ROADMAP "
            "ground rules)")
    if opt.data_parallel > 0:
        check_batch(opt.batch_size, opt.data_parallel)


def init_student_state(opt, model: nn.Module, lr_schedule, n_data: int,
                       seed: int = 0, device=None) -> TrainState:
    """The student's state on ``device`` (CUDA when None): the path-only
    ResNet, with ``--distill crd`` the single-Linear CRD heads
    ``crd_{fuse,ema}_{s,t}`` (``CRD_loss.py:256-267``) and two banks drawn
    on the CPU from ``seed``, with ``--distill hkd`` the single-Linear heads
    ``hkd_embed_{s,t}``, the TAGConv encoders ``hkd_gnn_{s,t}``
    (``GNN.py:121-134``) and the bank ``"hkd"``, in the JAX package's
    order, under momentum AEKD a NaN ("unseeded") scale,
    Adam, the EMA model, the step's device generator (``seed``) and the
    frozen teacher's (``seed + 1``).  ``--pretrained_path`` and
    ``--init_type`` apply first (``steps.init_model``), so the EMA starts
    from their weights."""
    _refuse_unported(opt)
    dev = resolve_device(device)
    init_model(opt, model, seed)
    gen = torch.Generator().manual_seed(seed)
    embeds, banks = nn.ModuleDict(), {}
    if opt.distill == "crd":
        # the fused teacher feature is mmhid wide, the EMA's path_dim
        for name, width in (("fuse", opt.mmhid), ("ema", opt.path_dim)):
            embeds[f"crd_{name}_s"] = Embed(opt.path_dim, opt.feat_dim,
                                            mlp=False, generator=gen)
            embeds[f"crd_{name}_t"] = Embed(width, opt.feat_dim, mlp=False,
                                            generator=gen)
            banks[name] = init_bank(n_data, opt.feat_dim, gen, dev)
    elif opt.distill == "hkd":
        embeds["hkd_embed_s"] = Embed(opt.path_dim, opt.feat_dim, mlp=False,
                                      generator=gen)
        embeds["hkd_embed_t"] = Embed(opt.mmhid, opt.feat_dim, mlp=False,
                                      generator=gen)
        for side in ("hkd_gnn_s", "hkd_gnn_t"):
            embeds[side] = TAGEncoder(opt.feat_dim, opt.feat_dim,
                                      generator=gen)
        banks["hkd"] = init_hkd_bank(n_data, opt.feat_dim, gen, dev)
    if opt.assign_weights and opt.loss_weighting == "momentum_AEKD":
        n_losses = (4 if opt.distill == "crd" else 2) + int(opt.CE_grads)
        banks["aekd_ema"] = torch.full((n_losses,), float("nan"), device=dev)
    model.to(dev)
    embeds.to(dev)
    optimizer = make_optimizer(
        opt, [*model.parameters(), *embeds.parameters()], lr_schedule)
    return TrainState(
        step=opt.global_step, model=model, embeds=embeds,
        optimizer=optimizer,
        ema_model=copy.deepcopy(model).requires_grad_(False),
        generator=torch.Generator(device=dev).manual_seed(seed),
        banks=banks,
        teacher_generator=torch.Generator(device=dev).manual_seed(seed + 1))


def freeze_teacher(model: nn.Module, device=None) -> nn.Module:
    """The frozen multimodal teacher on ``device``: no parameter takes a
    gradient, and its BatchNorm statistics never advance (in train mode it
    normalises by the batch, as the JAX student applies it with
    ``mutable=["batch_stats"]`` and discards the update)."""
    model.to(resolve_device(device)).requires_grad_(False)
    for m in model.modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.track_running_stats = False
    return model


@contextlib.contextmanager
def _default_generator_as(gen: Optional[torch.Generator]):
    """Run the block with the device's default generator (which
    ``nn.Dropout`` draws from) in ``gen``'s state; hand the advanced state
    back to ``gen`` and restore the default's."""
    if gen is None:
        yield
        return
    if gen.device.type == "cuda":
        default = torch.cuda.default_generators[
            gen.device.index if gen.device.index is not None
            else torch.cuda.current_device()]
    else:
        default = torch.default_generator
    saved = default.get_state()
    default.set_state(gen.get_state())
    try:
        yield
    finally:
        gen.set_state(default.get_state())
        default.set_state(saved)


@torch.no_grad()
def frozen_teacher_forward(opt, teacher: nn.Module, x_path, x_omic,
                           generator: Optional[torch.Generator] = None
                           ) -> PathomicOutput:
    """The frozen teacher's forward (``train_test_path_multi_distill.py:
    232``).  ``--teacher_bn batch`` (default): train mode, as the
    reference's ``fix_model.train()`` under ``no_grad``: BatchNorm by the
    batch, dropout live, the Kronecker contraction through B1; its dropout
    and mask come from ``generator``.  ``running``: eval mode with the
    saved statistics, the contraction through B2.  ``teacher`` comes from
    :func:`freeze_teacher`.  Under a data group the Kronecker mask is
    drawn from ``generator`` for the global batch, and the dropout masks
    from the rank's own default generator, as every ``nn.Dropout`` of a
    data-parallel run."""
    teacher.train(opt.teacher_bn == "batch")
    for m in teacher.modules():
        if isinstance(m, _KronEncoder1):
            m.generator = generator
    with _default_generator_as(generator if active() is None else None):
        return teacher(x_path=x_path, x_omic=x_omic)


def _kd_count(opt) -> int:
    if opt.distill == "crd" and opt.num_teachers == 2:
        return 4
    return 2 if opt.num_teachers == 2 else 1


def _check_student_flags(opt) -> None:
    """The JAX student's build-time refusals, and the port's own."""
    _refuse_unported(opt)
    if opt.assign_weights and opt.loss_weighting not in WEIGHTINGS:
        raise NotImplementedError(
            f"--loss_weighting {opt.loss_weighting}: supported values are "
            f"{WEIGHTINGS} (the reference's RLW/UW revision options are "
            "unimplemented there too, options_new.py:18-19)")
    if opt.sample_KD and not (opt.assign_weights and opt.student_customize
                              and opt.distill in ("crd", "kd")):
        raise NotImplementedError(
            "--sample_KD is the per-sample AEKD_v2 gate "
            "(train_test_path_multi_distill.py:74-141): it needs "
            "--assign_weights --student_customize and --distill crd|kd")
    if (opt.assign_weights and opt.student_customize and not opt.CE_grads
            and _kd_count(opt) < 2):
        raise NotImplementedError(
            "--student_customize without --CE_grads needs at least two KD "
            "losses (the reference gates on the last KD gradient when the "
            "CE backward is skipped)")


def _crd_teachers(opt) -> Tuple[str, ...]:
    if opt.distill != "crd":
        return ()
    if opt.num_teachers == 2:
        return ("fuse", "ema")
    return ("fuse",) if opt.which_teacher == "fuse" else ("ema",)


def _hkd_loss(state: TrainState, f_es, f_et, logit, t_logit, batch
              ) -> torch.Tensor:
    """HKD (``GNN.py:136-196``): InfoNCE of the embeddings against the
    bank, then of their TAGConv smoothings over the kNN graphs of the
    student's logits (taking no gradient) and of the teacher's."""
    bank, y, cidx = state.banks["hkd"], batch["index"], batch["sample_idx"]
    loss = sum(map(nce_softmax_loss, hkd_scores(bank, f_es, f_et, y, cidx)))
    f_gs = state.embeds["hkd_gnn_s"](knn_adjacency(logit), f_es)
    f_gt = state.embeds["hkd_gnn_t"](knn_adjacency(t_logit), f_et)
    return loss + sum(map(nce_softmax_loss,
                          hkd_graph_scores(bank, f_gs, f_gt, y, cidx)))


def build_student_train_step(opt, teacher: nn.Module):
    """``step(state, batch, epoch_frac, picks=None) -> (state, metrics)``.

    ``teacher`` is the frozen multimodal model (:func:`freeze_teacher`).
    ``batch`` holds device tensors: ``path_views`` uint8 [B, 2, H, W, 3],
    ``omic``, ``g`` (or ``t``/``e``), and for CRD ``index`` [B] and
    ``sample_idx`` [B, P + K] (for HKD [B, K], negatives only).
    ``epoch_frac`` (a host float) drives the curriculum selection;
    ``picks`` ({"fuse"|"ema": ranks}) replaces the positive ranks the step
    would draw from ``state.generator``.  Metrics keep the JAX names and
    stay on the device."""
    _check_student_flags(opt)
    dtype = _dtype(opt)
    crd_names = _crd_teachers(opt)
    alpha = 1.0 if opt.alpha is None else opt.alpha
    beta = 1.0 if opt.beta is None else opt.beta
    n_pos = opt.nce_p2 if opt.select_pos_pairs else opt.nce_p
    weightable = opt.distill in ("crd", "kd")

    def task_loss(batch, pred):
        if opt.task == "surv":
            return cox_loss(batch["t"], batch["e"], pred)
        return nll_loss(pred, batch["g"])

    def step(state: TrainState, batch, epoch_frac: float,
             picks: Optional[Dict[str, torch.Tensor]] = None):
        model, ema = state.model.train(), state.ema_model.train()
        views = augment_views(state.generator, batch["path_views"],
                              dtype=dtype)
        x1, x2 = views[:, 0], views[:, 1]
        with torch.no_grad():
            _, ema_feat, ema_logit, _ = ema(x2)
        t_out = frozen_teacher_forward(opt, teacher, x1, batch["omic"],
                                       state.teacher_generator)
        if picks is None and opt.select_pos_pairs:
            picks = {name: draw_pick(opt.select_pos_mode, opt.nce_p,
                                     opt.nce_p2, state.generator, epoch_frac)
                     for name in crd_names}

        _, path_feat, _, pred_path = model(x1)
        (rows,), batch = gather_outputs(
            [(path_feat, pred_path, ema_feat, ema_logit, t_out.fuse_feat,
              t_out.hazard_fuse)], batch)
        path_feat, pred_path, ema_feat, ema_logit, t_fuse_feat, t_hazard = \
            rows
        loss_cls = task_loss(batch, pred_path)
        fc = model.fc_new2
        logit = F.linear(path_feat, fc.weight, fc.bias)   # float32
        t_feats = {"fuse": t_fuse_feat, "ema": ema_feat}
        emb = {name: (state.embeds[f"crd_{name}_s"](path_feat),
                      state.embeds[f"crd_{name}_t"](t_feats[name]))
               for name in crd_names}
        if opt.distill == "hkd":
            f_es = state.embeds["hkd_embed_s"](path_feat)
            f_et = state.embeds["hkd_embed_t"](t_fuse_feat)

        def kd_losses(per_sample: bool = False) -> Dict[str, torch.Tensor]:
            losses = {}
            div_teachers = (
                [t_hazard, ema_logit] if opt.num_teachers == 2
                else [t_hazard if opt.which_teacher == "fuse"
                      else ema_logit])
            for i, t_logit in enumerate(div_teachers, 1):
                losses[f"div{i}"] = alpha * distill_kl(
                    logit, t_logit, opt.kd_T, per_sample=per_sample)
            if opt.distill in ZOO:
                losses["kd1"] = ZOO[opt.distill](path_feat, t_fuse_feat)
            elif opt.distill == "hkd":
                losses["kd1"] = _hkd_loss(state, f_es, f_et, logit,
                                          t_hazard, batch)
            for i, name in enumerate(crd_names, 1):
                f_s, f_t = emb[name]
                out_s, out_t, _ = crd_scores_select(
                    state.banks[name], f_s, f_t, batch["index"],
                    batch["sample_idx"], P=opt.nce_p, K=opt.nce_k,
                    P2=opt.nce_p2, K2=opt.nce_k2, T=opt.nce_t,
                    momentum=opt.nce_m, select_pos_mode=opt.select_pos_mode,
                    select_pos_pairs=opt.select_pos_pairs,
                    select_neg_pairs=opt.select_neg_pairs,
                    neg_reweight=opt.neg_reweight, epoch_frac=epoch_frac,
                    pick=picks.get(name) if picks else None,
                    update_bank=False)
                losses[f"kd{i}"] = beta * (
                    contrast_loss(out_s, opt.n_data, n_pos=n_pos,
                                  per_sample=per_sample)
                    + contrast_loss(out_t, opt.n_data, n_pos=n_pos,
                                    per_sample=per_sample))
            return losses

        kd = kd_losses()
        kd_keys = sorted(kd)               # [div1, div2, kd1, kd2]
        kd_vals = [kd[k] for k in kd_keys]
        if opt.assign_weights and weightable:
            grads = feature_grads(kd_vals, path_feat)
            if opt.CE_grads:
                ce = (cox_loss(batch["t"], batch["e"], logit)
                      if opt.task == "surv" else
                      nll_loss(apply_act(opt.act_type, logit), batch["g"]))
                grads += feature_grads([ce], path_feat)
            # grads[-1] anchors the v2 gate: the CE gradient with
            # --CE_grads, else the last KD gradient (reference quirk)
            if opt.student_customize:
                if opt.sample_KD:
                    kd_ps = kd_losses(per_sample=True)
                    loss_kd = aekd_v2_gate(
                        grads[:-1], grads[-1], [kd_ps[k] for k in kd_keys],
                        per_sample=True, batch_size=opt.batch_size)
                else:
                    loss_kd = aekd_v2_gate(grads[:-1], grads[-1], kd_vals)
                scale = torch.zeros(len(grads), device=logit.device)
            elif opt.loss_weighting == "SVM":
                # the reference's commented alternative (..._v2.py:156-158,
                # CL_utils/optimization.py:16-57), solved on the host
                scale = svm_weights(grads, nu=0.5, is_norm=opt.svm_norm)
                loss_kd = aekd_total(scale, kd_vals)
            elif opt.loss_weighting == "GK_refine_param":
                params = [p for n, p in model.named_parameters()
                          if "fc_new2" not in n]
                scale = gk_refine_param_space(kd_vals + [loss_cls], params)
                loss_kd = aekd_total(scale, kd_vals)
            elif opt.loss_weighting == "momentum_AEKD":
                prev = state.banks["aekd_ema"]
                unseeded = torch.isnan(prev)
                mo, _ = momentum_aekd_scale(
                    grads, torch.where(unseeded, 0.0, prev), opt.grads_m,
                    opt.thresh, use_thresh=True)
                # unseeded: mo = (1 - m) * scale, so the first step's raw
                # scale is recovered by the division
                scale = torch.where(unseeded,
                                    mo / max(1.0 - opt.grads_m, 1e-9), mo)
                loss_kd = aekd_total(scale, kd_vals)
            else:
                scale = aekd_scale(grads, n_kd=len(kd_vals))
                loss_kd = aekd_total(scale, kd_vals)
        else:
            loss_kd = sum(kd_vals)
            scale = torch.zeros(max(_kd_count(opt) + 1, 2),
                                device=logit.device)

        lam = opt.lambda_cox if opt.task == "surv" else opt.lambda_nll
        loss = (lam * loss_cls + opt.lambda_reg * l1_regularizer(
            model, opt.reg_type) + loss_kd)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        update_ema(model, ema, opt.ema_decay, state.step)
        state.step += 1

        with torch.no_grad():
            if "aekd_ema" in state.banks:
                state.banks["aekd_ema"].copy_(scale)
            # the stored banks: Z of the raw P + K columns from the
            # forward's features (while unset), then the batch's rows
            idx = batch["sample_idx"].long()
            for name, (f_s, f_t) in emb.items():
                bank = state.banks[name]
                set_z(bank,
                      torch.exp(torch.einsum("bsd,bd->bs",
                                             bank.memory_v2[idx], f_s)
                                / opt.nce_t),
                      torch.exp(torch.einsum("bsd,bd->bs",
                                             bank.memory_v1[idx], f_t)
                                / opt.nce_t))
                bank_update(bank, f_s, f_t, batch["index"], opt.nce_m)
            if opt.distill == "hkd":
                hkd_bank_update(state.banks["hkd"], f_es, f_et,
                                batch["index"])

        metrics = {"loss": loss, "loss_cls": loss_cls, "loss_KD": loss_kd,
                   "scale": scale}
        metrics.update({f"loss_{k}": v for k, v in kd.items()})
        if opt.task == "grad":
            metrics["correct_path"] = (pred_path.argmax(dim=1)
                                       == batch["g"]).sum()
        return state, {k: v.detach() for k, v in metrics.items()}

    return step


def load_teacher(opt, fold: int, device=None) -> nn.Module:
    """The frozen multimodal teacher of fold ``fold`` (``:156-173``):
    ``<fixed_model>_<fold>_best.pt`` or else ``.pt`` under the checkpoint
    directory, in the JAX package's layout (either package's)."""
    base = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.fixed_model)
    path = os.path.join(base, f"{opt.fixed_model}_{fold}_best.pt")
    if not os.path.exists(path):
        path = os.path.join(base, f"{opt.fixed_model}_{fold}.pt")
    ckpt = load_checkpoint(path)
    teacher = define_model(opt, generator=torch.Generator())
    teacher.load_state_dict(state_dict_from_flax(
        ckpt["model_state_dict"], ckpt.get("batch_stats", {})), strict=True)
    return freeze_teacher(teacher, device)


def train_student(opt, data: Dict, fold: int,
                  patches_data: Optional[Dict] = None, log=print,
                  device=None) -> Tuple[Dict, Dict, np.ndarray]:
    """One fold of student distillation on ``device`` (CUDA when None),
    driver ``train_cv_path_multi_MT.py`` + ``train()``.  Returns
    ``(final_eval, best_info, avg_all_metrics / 3)``."""
    _check_student_flags(opt)
    dev = resolve_device(device)
    launched = launch_for(opt, dev, train_student,
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
    teacher = load_teacher(opt, fold, dev)
    model = define_model(opt, path_only=True,
                         generator=torch.Generator().manual_seed(seed))
    state = init_student_state(opt, model,
                               make_lr_schedule(opt, steps_per_epoch),
                               n_data, seed=seed, device=dev)
    log("Number of Trainable Parameters: %d" % sum(
        p.numel() for m in (state.model, state.embeds)
        for p in m.parameters()))
    step = build_student_train_step(opt, teacher)
    eval_opt = opt.replace(mode="path")
    eval_step = build_eval_step(eval_opt)

    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)
    writer = is_writer()
    mlog = MetricsLogger(ckpt_dir, run_name=f"student_fold{fold}",
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
    best = {"acc": 0.0, "epoch": -1}
    avg_all_metrics = np.zeros(4)
    final_eval = None
    for epoch in range(start_epoch, total_epochs + 1):
        t0 = time.time()
        sums: Dict[str, torch.Tensor] = {}
        for batch in PrefetchLoader(train_loader, depth=opt.prefetch_depth,
                                    device=dev):
            state, metrics = step(state, batch,
                                  epoch / max(opt.niter_decay, 1))
            for k, v in metrics.items():
                if k.startswith(("loss", "correct")):
                    v = v.double()
                    sums[k] = sums[k] + v if k in sums else v
        agg = dict(zip(sums, torch.stack(list(sums.values())).tolist())) \
            if sums else {}
        dt = time.time() - t0
        nb = max(steps_per_epoch, 1)

        loader_for_eval = test_loader
        if patches_loader is not None and epoch > total_epochs - 10:
            loader_for_eval = patches_loader   # :360-366
        res = evaluate(eval_opt, eval_step, state.model, loader_for_eval,
                       dev, state.generator)
        final_eval = res
        path_metrics = np.array(res.get("metrics_path", np.zeros(4)))
        if plateau is not None:
            state.optimizer.lr_scale = plateau.step(res["loss"])
        if (writer and opt.snapshot_every > 0
                and epoch % opt.snapshot_every == 0):
            save_train_state(snap_path, state, epoch,
                             extra={"plateau": plateau.state_dict()}
                             if plateau else None)
        if epoch > opt.niter_decay - 3:   # :368-369
            avg_all_metrics += path_metrics

        samples_per_s = opt.batch_size * nb / max(dt, 1e-9)
        mlog.log({"epoch": epoch, "train_loss": agg.get("loss", 0) / nb,
                  "samples_per_s": samples_per_s,
                  "test_acc_path": res.get("acc_path", 0.0),
                  "test_loss": res["loss"]})
        if opt.verbose:
            log(f"[fold {fold}] epoch {epoch}/{total_epochs} "
                f"cls {agg.get('loss_cls', 0) / nb:.4f} "
                f"KD {agg.get('loss_KD', 0) / nb:.4f} "
                f"test_acc {res.get('acc_path', 0):.4f} "
                f"({samples_per_s:.1f} samples/s)")
        if opt.task == "grad" and agg.get("loss", 0.0) / nb < opt.patience:
            log(f"Early stopping at Epoch {epoch}")   # :383-385
            break
        if epoch > opt.niter_decay - 10:   # best by mean path metric
            avg_metric = float(np.mean(path_metrics))
            if avg_metric > best["acc"]:
                best = {"acc": avg_metric, "epoch": epoch}
                if writer:
                    save_checkpoint(
                        os.path.join(ckpt_dir,
                                     f"{opt.model_name}_{fold}_best.pt"),
                        fold_payload(opt, fold, total_epochs, state,
                                     res.get("metrics_path")))

    if writer:
        save_checkpoint(
            os.path.join(ckpt_dir, f"{opt.model_name}_{fold}.pt"),
            fold_payload(opt, fold, total_epochs, state,
                         final_eval.get("metrics_path") if final_eval
                         else None))
    return final_eval, best, avg_all_metrics / 3.0
