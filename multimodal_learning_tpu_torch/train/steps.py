"""Train and eval steps of the mean-teacher multimodal flow (PyTorch).

Port of ``multimodal_learning_tpu/train/steps.py`` (reference hot loop
``train_test_MT.py:108-242``).  One teacher step: augmentation of both
views on the device -> the EMA teacher's forward in train mode under
``no_grad`` (its BatchNorm statistics advance, as the reference runs the
EMA model un-eval'd) -> the student forward -> NLL or Cox, L1, CRD
(bank lookup, first-batch Z, bank update), pred-KD, SP and orth -> backward
-> Adam -> EMA update.  The step updates the state in place and returns it
with the metrics, under the JAX package's names, as device tensors (no
host sync).

Branch availability follows ``opt.mode``: pathomic runs all three
branches; path / omic a single branch, with EMA self-distillation.

Not ported yet, and refused: the masked CLAT step (``masking=True``,
ROADMAP A13), the t-SVD constraint (A12), the loss-gated CRD (A11),
SupCon distillation (A15) and the mmdynamics fusion (A17).
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..contrast.crd import Embed, contrast_loss, crd_scores, init_bank
from ..data.augment import augment_view, augment_views
from ..losses import (cox_loss, l1_regularizer, nll_loss, orth_loss,
                      pred_kd_loss, sp_loss)
from ..models.factory import _dtype
from ..models.fusion import _KronEncoder1
from ..models.pathomic import PathomicOutput
from .ema import update_ema
from .optim import make_optimizer
from .state import TrainState


def adapt_output(opt, raw) -> PathomicOutput:
    """Normalise MaxNet/ResNet/Pathomic outputs to PathomicOutput."""
    if isinstance(raw, PathomicOutput):
        return raw
    if opt.mode == "omic" or (isinstance(raw, tuple) and len(raw) == 3):
        feat, hazard, pred = raw
        return PathomicOutput(None, None, feat, None, None, None, hazard,
                              None, None, pred)
    f3, feat, hazard, pred = raw
    return PathomicOutput(None, feat, None, f3, None, hazard, None,
                          None, pred, None)


def _apply(opt, model, batch, x_path):
    if opt.mode == "pathomic":
        return model(x_path=x_path, x_omic=batch["omic"])
    return model(x_path if opt.mode == "path" else batch["omic"])


def task_losses(opt, out: PathomicOutput, batch
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """3-branch NLL (grad) / Cox (surv) (``train_test_MT.py:149-152,
    212-215``); a missing branch adds 0."""
    dev = batch["omic"].device
    parts, total = {}, torch.zeros((), device=dev)
    for name, pred in (("fuse", out.pred_fuse), ("path", out.pred_path),
                       ("omic", out.pred_omic)):
        if pred is None:
            parts[f"loss_{name}"] = torch.zeros((), device=dev)
            continue
        li = (cox_loss(batch["t"], batch["e"], pred) if opt.task == "surv"
              else nll_loss(pred, batch["g"]))
        parts[f"loss_{name}"] = li
        total = total + li
    return total, parts


def pred_kd(opt, out: PathomicOutput, ema: PathomicOutput) -> torch.Tensor:
    """Mean-teacher prediction KD (``train_test_MT.py:177-199``)."""
    t = opt.task
    if opt.mode != "pathomic":
        pred = out.pred_path if opt.mode == "path" else out.pred_omic
        ema_pred = ema.pred_path if opt.mode == "path" else ema.pred_omic
        return pred_kd_loss(pred, ema_pred, t)
    teachers = {1: ("self",), 2: ("self", "fuse"),
                3: ("self", "fuse", "other")}.get(opt.num_teachers)
    if teachers is None:
        raise NotImplementedError(f"num_teachers={opt.num_teachers}")
    ema_of = {"fuse": ema.pred_fuse, "path": ema.pred_path,
              "omic": ema.pred_omic}

    def branch(own: str, other: str) -> torch.Tensor:
        pred = getattr(out, f"pred_{own}")
        names = {"self": own, "fuse": "fuse", "other": other}
        return sum(pred_kd_loss(pred, ema_of[names[w]], t)
                   for w in teachers) / float(len(teachers))

    return (pred_kd_loss(out.pred_fuse, ema.pred_fuse, t)
            + branch("path", "omic") + branch("omic", "path"))


def _branch_feat(opt, out: PathomicOutput):
    if opt.mode == "pathomic":
        return out.fuse_feat
    return out.path_feat if opt.mode == "path" else out.omic_feat


def _refuse_unported(opt, masking: bool = False) -> None:
    for cond, what in (
            (masking, "the masked CLAT stage-1 step (masking=True): "
                      "ROADMAP A13"),
            (opt.tSVD_loss and opt.mode == "pathomic",
             "--tSVD_loss (the M3LR t-SVD constraint): ROADMAP A12"),
            (opt.CRD_gate, "--CRD_gate (the loss-gated CRD): ROADMAP A11"),
            (opt.supcon_distill == 1, "--supcon_distill: ROADMAP A15"),
            (opt.mode == "pathomic" and opt.fusion_type == "mmdynamics",
             "--fusion_type mmdynamics: ROADMAP A17")):
        if cond:
            raise NotImplementedError(f"{what} is not ported yet")


def _resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names a device; no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the card; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def init_teacher_state(opt, model: nn.Module, lr_schedule, n_data: int,
                       seed: int = 0, device=None) -> TrainState:
    """The teacher flow's state on ``device`` (CUDA when None): the model
    (moved there), the CRD heads and bank drawn on the CPU from ``seed``,
    Adam, the EMA model (a copy with its own parameters and buffers), and
    a device generator seeded with ``seed`` for augmentation and the
    Kronecker dropout masks.  ``--global_step`` seeds the step counter
    (reference ``iter_num``, ``train_test_MT.py:104``)."""
    _refuse_unported(opt)
    dev = _resolve_device(device)
    if opt.init_type not in ("max", "none", "normal_default"):
        raise NotImplementedError(
            f"--init_type {opt.init_type} (the post-init re-initialisation) "
            "is not ported yet: ROADMAP A2")
    if getattr(opt, "pretrained_path", ""):
        raise NotImplementedError(
            "--pretrained_path is not ported yet: ROADMAP A18")
    gen = torch.Generator().manual_seed(seed)
    embeds, banks = nn.ModuleDict(), {}
    if opt.CRD_distill == 1:
        width = opt.mmhid if opt.mode == "pathomic" else (
            opt.path_dim if opt.mode == "path" else opt.omic_dim)
        for side in ("crd_fuse_s", "crd_fuse_t"):
            embeds[side] = Embed(width, opt.feat_dim, generator=gen)
        banks["fuse"] = init_bank(n_data, opt.feat_dim, gen, dev)
    model.to(dev)
    embeds.to(dev)
    ema_model = copy.deepcopy(model).requires_grad_(False)
    dev_gen = torch.Generator(device=dev).manual_seed(seed)
    for m in (*model.modules(), *ema_model.modules()):
        if isinstance(m, _KronEncoder1):
            m.generator = dev_gen
    optimizer = make_optimizer(
        opt, [*model.parameters(), *embeds.parameters()], lr_schedule)
    return TrainState(step=opt.global_step, model=model, embeds=embeds,
                      optimizer=optimizer, ema_model=ema_model,
                      generator=dev_gen, banks=banks)


def build_teacher_train_step(opt, masking: bool = False):
    """``train_step(state, batch, crd_weight) -> (state, metrics)``.

    ``batch`` holds device tensors: ``path_views`` uint8 [B, 2, H, W, 3],
    ``omic`` [B, 80], ``g`` (grade) or ``t``/``e`` (survival), and for CRD
    ``index`` [B] and ``sample_idx`` [B, 1 + nce_k] (column 0 the
    positive)."""
    _refuse_unported(opt, masking)
    use_images = opt.mode in ("path", "pathomic")
    dtype = _dtype(opt)
    n_pos = (1 if opt.task == "surv" or opt.pos_mode in ("exact", "relax")
             else opt.nce_p)

    def train_step(state: TrainState, batch, crd_weight: float):
        model, ema = state.model.train(), state.ema_model.train()
        dev = batch["omic"].device
        x1 = x2 = None
        if use_images:
            views = augment_views(state.generator, batch["path_views"],
                                  dtype=dtype)
            x1, x2 = views[:, 0], views[:, 1]
        with torch.no_grad():
            ema_out = adapt_output(opt, _apply(opt, ema, batch, x2))
        out = adapt_output(opt, _apply(opt, model, batch, x1))
        loss_task, metrics = task_losses(opt, out, batch)
        loss = (opt.lambda_nll if opt.task == "grad" else opt.lambda_cox) \
            * loss_task
        loss = loss + opt.lambda_reg * l1_regularizer(model, opt.reg_type)
        zero = torch.zeros((), device=dev)

        metrics["loss_CRD"] = zero
        if opt.CRD_distill == 1:
            f_s = state.embeds["crd_fuse_s"](_branch_feat(opt, out))
            f_t = state.embeds["crd_fuse_t"](_branch_feat(opt, ema_out))
            out_s, out_t = crd_scores(
                state.banks["fuse"], f_s, f_t, batch["index"],
                batch["sample_idx"], T=opt.nce_t, momentum=opt.nce_m)
            metrics["loss_CRD"] = crd_weight * (
                contrast_loss(out_s, opt.n_data, n_pos=n_pos)
                + contrast_loss(out_t, opt.n_data, n_pos=n_pos))
            loss = loss + metrics["loss_CRD"]

        metrics["loss_KD"] = zero
        if opt.pred_distill == 1:
            metrics["loss_KD"] = opt.KD_weight * pred_kd(opt, out, ema_out)
            loss = loss + metrics["loss_KD"]

        metrics["loss_SP"] = zero
        if opt.SP_distill == 1 and opt.mode == "pathomic":
            metrics["loss_SP"] = opt.SP_weight * (
                sp_loss(out.fuse_feat, ema_out.fuse_feat)
                + sp_loss(out.path_feat, ema_out.path_feat)
                + sp_loss(out.omic_feat, ema_out.omic_feat)) / 3.0
            loss = loss + metrics["loss_SP"]

        if opt.orth_loss and opt.mode == "pathomic":
            loss = loss + orth_loss(out.path_feat, out.omic_feat)
        metrics["loss"] = loss

        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        update_ema(model, ema, opt.ema_decay, state.step)
        state.step += 1

        # train accuracy counts (train_test_MT.py:254-260) / risk outputs
        for name in ("fuse", "path", "omic"):
            pred = getattr(out, f"pred_{name}")
            if opt.task == "grad":
                if pred is not None:
                    metrics[f"correct_{name}"] = (
                        pred.argmax(dim=1) == batch["g"]).sum()
            else:
                metrics[f"risk_{name}"] = (pred.detach().reshape(-1)
                                           if pred is not None else zero)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_eval_step(opt):
    """``eval_step(model, batch, generator=None) -> (out, loss parts)``:
    the eval forward of view 0 (reference ``test()``,
    ``train_test_MT.py:340-458``); with ``--test_augment`` the view is
    augmented from ``generator``, else normalised in the compute dtype."""
    _refuse_unported(opt)
    dtype = _dtype(opt)

    @torch.no_grad()
    def eval_step(model: nn.Module, batch,
                  generator: Optional[torch.Generator] = None):
        model.eval()
        x = None
        if opt.mode in ("path", "pathomic"):
            x = batch["path_views"][:, 0]
            x = (augment_view(generator, x, dtype=dtype) if opt.test_augment
                 else x.to(dtype) / 127.5 - 1.0)
        out = adapt_output(opt, _apply(opt, model, batch, x))
        return out, task_losses(opt, out, batch)[1]

    return eval_step
