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

``--CRD_gate`` gates each CRD anchor side by whose per-sample NLL is
larger (``weighted_CRDLoss``).  ``--tSVD_loss`` adds the M3LR low-rank
constraint (``MIA 2022/train_test_tSVD.py:300-431``): the view Grams of
both modalities, an ADMM refresh of the low-rank tensors by t-SVT (when
the host says so, ``tsvd_update``), mu grown by ``pho`` up to ``max_mu``
per refresh, and the Frobenius penalty ``mu/2 ||adj - aux||^2``.

``masking=True`` builds the masked CLAT stage-1 step
(``train_test_MT_SP_Masking.py:190-220``): four views and a SLIC label map;
the saliency masks (``masking/superpixel.py``) from an eval-mode pass with
the pre-step BatchNorm statistics, taken before the train-mode forwards
rewrite them; a masked-path and a masked-omic student forward (the second
reuses the main forward's path trunk, so autograd merges the trunk's
backward into the main one), distilled against two EMA forwards on the
extra views.  ``--masking_bn chain`` leaves the running statistics as the
reference's sequence of forwards would (the trunk's pass that the reuse
skips is replayed in closed form), ``discard`` keeps only the main and
EMA forwards' updates.

``--supcon_distill 1`` adds SupCon (``losses/supcon.py``) over the
L2-normalised branch features of the student and the EMA as two views,
with the class labels (``task grad`` only), times ``supcon_weight``.

Under a data group (``--data_parallel``, ``parallel/mesh.py``) each rank
runs the forwards on its rows of the global batch, with BatchNorm over the
global batch; the step then gathers the outputs and the labels, indices
and contrast samples the losses read (:func:`gather_outputs`), computes
every loss on the global batch, identically on every rank, and the
optimizer averages the gradients over the ranks.  The saliency pass of the
masked step takes this rank's part of the global NLL.

``--fusion_type mmdynamics`` trains through its own step,
:func:`build_mmdynamics_train_step` (``PathomicNet_dynamics``,
``networks_new.py:372-418``): the MMDynamic fusion's composite loss plus
L1, no mean teacher, CRD or pred-KD; its eval forward returns the fused
logits alone.
"""
from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..contrast.crd import (Embed, contrast_loss, crd_gate_weights,
                            crd_scores, init_bank, weighted_contrast_loss)
from ..data.augment import (augment_view, augment_views,
                            augment_views_with_mask)
from ..losses import (cox_loss, l1_regularizer, nll_loss, orth_loss,
                      pred_kd_loss, sp_loss, supcon_loss)
from ..lowrank import build_view_features, update_adj_tensor, update_aux
from ..masking.superpixel import frozen_params, superpixel_attention_mask
from ..models.common import apply_init_type, reinit_generator
from ..models.factory import _dtype, is_dynamics
from ..models.fusion import _KronEncoder1
from ..models.import_torch import apply_pretrained
from ..models.pathomic import PathomicOutput
from ..parallel.mesh import active, gather_rows
from ..utils.logging import span
from .ema import update_ema
from .optim import make_optimizer
from .state import TrainState, TsvdAux


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


# the rows of a batch that the losses read: labels, indices, samples
ROW_KEYS = ("g", "t", "e", "index", "sample_idx")


def gather_outputs(outs, batch):
    """Under a data group, every rank's rows of each output (a
    PathomicOutput or a tuple of tensors; differentiably where they take a
    gradient) and a copy of ``batch`` whose ``ROW_KEYS`` hold the global
    batch's rows, in one call of ``parallel.gather_rows``; without one,
    ``(outs, batch)``."""
    if active() is None:
        return outs, batch
    keys = [k for k in ROW_KEYS if k in batch]
    flat = [t for o in outs for t in o] + [batch[k] for k in keys]
    flat = gather_rows(flat)
    done, i = [], 0
    for o in outs:
        part = flat[i:i + len(o)]
        done.append(type(o)(*part) if hasattr(o, "_fields") else tuple(part))
        i += len(o)
    return done, {**batch, **dict(zip(keys, flat[i:]))}


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


def _branch_pred(opt, out: PathomicOutput):
    if opt.mode == "pathomic":
        return out.pred_fuse
    return out.pred_path if opt.mode == "path" else out.pred_omic


def _use_tsvd(opt) -> bool:
    return bool(opt.tSVD_loss) and opt.mode == "pathomic"


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names a device; no silent CPU fallback."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port trains on the card; "
                           "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def init_model(opt, model: nn.Module, seed: int) -> nn.Module:
    """``--pretrained_path`` then ``--init_type`` on a freshly built model,
    in place, in the reference's order: the pretrained weights load in the
    constructor (``resnets.py:275-284``) and ``init_net -> init_weights``
    runs after it (``utils.py:263-265``), so normal/xavier/kaiming/
    orthogonal clobber the pretrained trunk and only max/none keep it (JAX
    ``train/steps.py:164-176``).  The re-initialisation draws from its own
    generator, so the heads' and banks' draws from ``seed`` stay as they
    are."""
    apply_pretrained(opt, model)
    return apply_init_type(model, opt.init_type, opt.init_gain,
                           reinit_generator(seed))


def init_teacher_state(opt, model: nn.Module, lr_schedule, n_data: int,
                       seed: int = 0, device=None) -> TrainState:
    """The teacher flow's state on ``device`` (CUDA when None): the model
    (moved there), the CRD heads and bank drawn on the CPU from ``seed``,
    Adam, the EMA model (a copy with its own parameters and buffers), and
    a device generator seeded with ``seed`` for augmentation and the
    Kronecker dropout masks.  ``--pretrained_path`` and ``--init_type``
    apply first (:func:`init_model`), so the EMA starts from their
    weights.  ``--global_step`` seeds the step counter
    (reference ``iter_num``, ``train_test_MT.py:104``)."""
    dev = resolve_device(device)
    init_model(opt, model, seed)
    gen = torch.Generator().manual_seed(seed)
    embeds, banks = nn.ModuleDict(), {}
    if opt.CRD_distill == 1:
        width = opt.mmhid if opt.mode == "pathomic" else (
            opt.path_dim if opt.mode == "path" else opt.omic_dim)
        for side in ("crd_fuse_s", "crd_fuse_t"):
            embeds[side] = Embed(width, opt.feat_dim, generator=gen)
        banks["fuse"] = init_bank(n_data, opt.feat_dim, gen, dev)
    if _use_tsvd(opt):
        zeros = lambda: torch.zeros(opt.n_views, opt.batch_size,
                                    opt.batch_size, device=dev)
        scalar = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)
        banks["tsvd"] = TsvdAux(zeros(), zeros(), scalar(opt.mu),
                                scalar(0.0), scalar(0.0))
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


def _tsvd_loss(opt, tsvd: TsvdAux, out: PathomicOutput,
               ema_out: PathomicOutput, refresh: bool
               ) -> Dict[str, torch.Tensor]:
    """The M3LR constraint (``train_test_tSVD.py:300-431``): refreshes
    ``tsvd`` in place when ``refresh`` (a host bool: every ``aux_iter``
    batches, ``:376-413``) and returns the penalty and the TNNs."""
    feats1, feats2 = build_view_features(
        opt.n_views, out.fuse_feat, ema_out.fuse_feat, out.path_feat,
        ema_out.path_feat, out.omic_feat, ema_out.omic_feat)
    adj1, adj2 = update_adj_tensor(feats1), update_adj_tensor(feats2)
    if refresh:
        with torch.no_grad():
            tau = opt.Lambda_global / tsvd.mu
            for aux, tnn, adj in ((tsvd.aux1, tsvd.tnn1, adj1),
                                  (tsvd.aux2, tsvd.tnn2, adj2)):
                a, t = update_aux(adj.permute(1, 2, 0), tau)   # [B, B, V]
                aux.copy_(a.permute(2, 0, 1))
                tnn.copy_(t)
            tsvd.mu.copy_(torch.clamp(tsvd.mu * opt.pho, max=opt.max_mu))
    frob = lambda adj, aux: ((adj - aux) ** 2).sum()
    if opt.tSVD_mode == "path":
        penalty = frob(adj1, tsvd.aux1)
    elif opt.tSVD_mode == "omic":
        penalty = frob(adj2, tsvd.aux2)
    else:
        penalty = frob(adj1, tsvd.aux1) + frob(adj2, tsvd.aux2)
    return {"loss_tsvd": tsvd.mu / 2.0 * penalty,
            "tnn_path": tsvd.tnn1.clone(), "tnn_omic": tsvd.tnn2.clone()}


# BatchNorm momentum of every model BatchNorm in flax's convention
# (running = mom * running + (1 - mom) * batch; JAX models/resnet.py:158)
_BN_MOM = 0.9


def _buffers(module: nn.Module) -> Dict[str, torch.Tensor]:
    return {n: b.clone() for n, b in module.named_buffers()}


@torch.no_grad()
def _restore_buffers(module: nn.Module, saved: Dict[str, torch.Tensor]
                     ) -> None:
    for n, b in module.named_buffers():
        b.copy_(saved[n])


def _saliency_masks(opt, model: nn.Module, x_path, batch, sp_mask):
    """The saliency masks of the masked step (JAX ``train/steps.py:
    396-404``): the fused NLL of ``model`` in eval mode, with its current
    (pre-step) running statistics and its parameters frozen, so that the
    pass takes input gradients only (B2 and B4 once, B3 never).  Under a
    data group the cost is this rank's part of the global batch's NLL
    (its rows' mean over the world size), so each row's input gradient is
    the world-1 one: in eval mode no row sees another."""
    dp = active()
    share = 1.0 / dp.world if dp is not None else 1.0

    def cost_fn(xp, xo):
        return share * nll_loss(model(x_path=xp, x_omic=xo).pred_fuse,
                                batch["g"])

    model.eval()
    try:
        with frozen_params(model):
            return superpixel_attention_mask(
                cost_fn, x_path, batch["omic"], sp_mask,
                opt.num_superpixels, opt.Path_K, opt.Omic_K)
    finally:
        model.train()


def _masking_loss(opt, model: nn.Module, ema: nn.Module, batch,
                  out: PathomicOutput, x1, xm1, xm2, masks,
                  r0: Optional[Dict[str, torch.Tensor]]) -> torch.Tensor:
    """The comprehensive-learning loss (JAX ``train/steps.py:405-500``):
    the pred-KD of a masked-path and a masked-omic student forward against
    EMA forwards on the two extra views.  The second student forward
    reuses the main forward's path outputs (this rank's rows), not
    detached.  Runs after the main forward; ``r0`` holds ``path_net``'s
    buffers from before it (``--masking_bn chain``).  ``batch`` holds this
    rank's rows; the KD terms read the gathered predictions."""
    path_mask, omic_mask = masks
    chain = opt.masking_bn == "chain"
    if chain:
        r1 = _buffers(model.path_net)
    else:
        r1, e1 = _buffers(model), _buffers(ema)
    omic = batch["omic"]
    out_m1 = adapt_output(opt, model(
        x_path=x1 * (1.0 - path_mask[..., None]), x_omic=omic))
    out_m2 = adapt_output(opt, model(
        x_omic=omic * (1.0 - omic_mask),
        path_feats=(out.path_feat_f3, out.path_feat, out.hazard_path,
                    out.pred_path)))
    with torch.no_grad():
        ema_m1 = adapt_output(opt, ema(x_path=xm1, x_omic=omic))
        ema_m2 = adapt_output(opt, ema(x_path=xm2, x_omic=omic))
        if chain:
            # the trunk pass that m2 reused: r3 = mom r2 + (1 - mom) s1,
            # with (1 - mom) s1 = r1 - mom r0 from the main forward
            for n, b in model.path_net.named_buffers():
                if n.endswith("num_batches_tracked"):
                    b.add_(1)
                else:
                    b.copy_(_BN_MOM * b + r1[n] - _BN_MOM * r0[n])
        else:
            _restore_buffers(model, r1)
            _restore_buffers(ema, e1)
    s1, t1, s2, t2 = gather_rows([out_m1.pred_fuse, ema_m1.pred_fuse,
                                  out_m2.pred_fuse, ema_m2.pred_fuse])
    return (pred_kd_loss(s1, t1, opt.task) + pred_kd_loss(s2, t2, opt.task))


def build_teacher_train_step(opt, masking: bool = False):
    """``train_step(state, batch, crd_weight, tsvd_update=True) -> (state,
    metrics)``.

    ``batch`` holds device tensors: ``path_views`` uint8 [B, 2, H, W, 3],
    ``omic`` [B, 80], ``g`` (grade) or ``t``/``e`` (survival), and for CRD
    ``index`` [B] and ``sample_idx`` [B, 1 + nce_k] (column 0 the
    positive).  ``tsvd_update``, a host bool, says whether a
    ``--tSVD_loss`` step refreshes the ADMM tensors.  The masked step
    (``masking=True``) takes 4 views and ``sp_mask`` [B, H, W] int32.

    The step's phases are spans of the recorder (``utils/logging``):
    ``step.augment``, ``step.forward``, ``step.losses``, ``step.backward``
    and ``step.optimizer`` (zero_grad, Adam, the EMA update); the masked
    step's saliency pass lies outside them."""
    if masking and opt.mode != "pathomic":
        raise ValueError("the masked step needs --mode pathomic")
    if masking and opt.masking_bn not in ("chain", "discard"):
        raise ValueError(f"--masking_bn {opt.masking_bn}: chain or discard")
    if opt.supcon_distill == 1 and opt.task != "grad":
        raise NotImplementedError(
            "--supcon_distill needs class labels (task=grad); the flag is "
            "parsed-but-dead in the reference (MICCAI-2022/options.py:98)")
    if opt.CRD_gate and (opt.task != "grad" or opt.pos_mode
                         not in ("exact", "relax")):
        raise NotImplementedError(
            "--CRD_gate implements the single-positive weighted_CRDLoss "
            "(CRD_loss.py:8-50): task=grad with pos_mode exact/relax only")
    use_images = opt.mode in ("path", "pathomic")
    dtype = _dtype(opt)
    n_pos = (1 if opt.task == "surv" or opt.pos_mode in ("exact", "relax")
             else opt.nce_p)

    def train_step(state: TrainState, batch, crd_weight: float,
                   tsvd_update: bool = True):
        model, ema = state.model.train(), state.ema_model.train()
        dev = batch["omic"].device
        x1 = x2 = masks = r0 = None
        if masking:
            with span("step.augment"):
                views, sp_mask = augment_views_with_mask(
                    state.generator, batch["path_views"], batch["sp_mask"],
                    dtype=dtype)
                x1, x2, xm1, xm2 = views.unbind(1)
            masks = _saliency_masks(opt, model, x1, batch, sp_mask)
            if opt.masking_bn == "chain":
                r0 = _buffers(model.path_net)
        elif use_images:
            with span("step.augment"):
                views = augment_views(state.generator, batch["path_views"],
                                      dtype=dtype)
                x1, x2 = views[:, 0], views[:, 1]
        with span("step.forward"):
            with torch.no_grad():
                ema_out = adapt_output(opt, _apply(opt, ema, batch, x2))
            out_rows = adapt_output(opt, _apply(opt, model, batch, x1))
            (out, ema_out), gb = gather_outputs((out_rows, ema_out), batch)
        with span("step.losses"):
            loss_task, metrics = task_losses(opt, out, gb)
            loss = (opt.lambda_nll if opt.task == "grad" else opt.lambda_cox) \
                * loss_task
            loss = loss + opt.lambda_reg * l1_regularizer(model, opt.reg_type)
            zero = torch.zeros((), device=dev)

            metrics["loss_CRD"] = zero
            if opt.CRD_distill == 1:
                f_s = state.embeds["crd_fuse_s"](_branch_feat(opt, out))
                f_t = state.embeds["crd_fuse_t"](_branch_feat(opt, ema_out))
                out_s, out_t = crd_scores(
                    state.banks["fuse"], f_s, f_t, gb["index"],
                    gb["sample_idx"], T=opt.nce_t, momentum=opt.nce_m)
                if opt.CRD_gate:
                    # weighted_CRDLoss (CRD_loss.py:8-50): each anchor side by
                    # whose per-sample NLL is larger
                    g_col = gb["g"].long()[:, None]
                    s_w, t_w = crd_gate_weights(
                        -_branch_pred(opt, out).gather(1, g_col)[:, 0],
                        -_branch_pred(opt, ema_out).gather(1, g_col)[:, 0])
                    loss_crd = (
                        weighted_contrast_loss(out_s, s_w, opt.n_data)
                        + weighted_contrast_loss(out_t, t_w, opt.n_data))
                else:
                    loss_crd = (
                        contrast_loss(out_s, opt.n_data, n_pos=n_pos)
                        + contrast_loss(out_t, opt.n_data, n_pos=n_pos))
                metrics["loss_CRD"] = crd_weight * loss_crd
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

            if opt.supcon_distill == 1:
                # live semantics for a flag the reference parses but never
                # uses (options.py:98-99), as the JAX step gives it
                views = torch.stack([
                    f / torch.linalg.vector_norm(f, dim=1, keepdim=True
                                                 ).clamp_min(1e-12)
                    for f in (_branch_feat(opt, out),
                              _branch_feat(opt, ema_out))
                ], dim=1)
                metrics["loss_supcon"] = opt.supcon_weight * supcon_loss(
                    views, labels=gb["g"])
                loss = loss + metrics["loss_supcon"]

            if masking:
                metrics["loss_masking"] = _masking_loss(
                    opt, model, ema, batch, out_rows, x1, xm1, xm2, masks, r0)
                loss = loss + metrics["loss_masking"]

            if _use_tsvd(opt):
                metrics.update(_tsvd_loss(opt, state.banks["tsvd"], out,
                                          ema_out, tsvd_update))
                loss = loss + metrics["loss_tsvd"]
            metrics["loss"] = loss

        with span("step.optimizer"):
            state.optimizer.zero_grad()
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            state.optimizer.step()
            update_ema(model, ema, opt.ema_decay, state.step)
        state.step += 1

        # train accuracy counts (train_test_MT.py:254-260) / risk outputs
        for name in ("fuse", "path", "omic"):
            pred = getattr(out, f"pred_{name}")
            if opt.task == "grad":
                if pred is not None:
                    metrics[f"correct_{name}"] = (
                        pred.argmax(dim=1) == gb["g"]).sum()
            else:
                metrics[f"risk_{name}"] = (pred.detach().reshape(-1)
                                           if pred is not None else zero)
        return state, {k: v.detach() for k, v in metrics.items()}

    return train_step


def build_mmdynamics_train_step(opt):
    """``train_step(state, batch, crd_weight=0.0, tsvd_update=True) ->
    (state, metrics)`` for ``--fusion_type mmdynamics`` (JAX
    ``train/steps.py:210-247``): view 0 of the augmented pair, one forward
    with the labels, MMDynamic's loss plus ``lambda_reg`` times the L1
    penalty, backward and Adam.  The metrics are ``loss`` and
    ``correct_fuse``, left on the device.  No EMA update, CRD or pred-KD:
    the EMA model and its buffers stay as they are, as the JAX step leaves
    ``ema_params``.  ``crd_weight`` and ``tsvd_update`` are taken and
    ignored, so that the fold loop calls every step alike.  Under a data
    group each rank's loss is its rows' mean (the model computes it), which
    the gradient average turns into the global batch's; the metrics are
    the global ones."""
    dtype = _dtype(opt)

    def train_step(state: TrainState, batch, crd_weight: float = 0.0,
                   tsvd_update: bool = True):
        model = state.model.train()
        x1 = augment_views(state.generator, batch["path_views"],
                           dtype=dtype)[:, 0]
        loss, mm_logit, _ = model(x1, batch["omic"], batch["g"])
        loss = loss + opt.lambda_reg * l1_regularizer(model, opt.reg_type)
        state.optimizer.zero_grad()
        loss.backward()
        state.optimizer.step()
        state.step += 1
        (losses,) = gather_rows([loss.detach()[None]])
        mm_logit, g = gather_rows([mm_logit.detach(), batch["g"]])
        return state, {"loss": losses.mean(), "correct_fuse": (
            mm_logit.argmax(dim=1) == g).sum()}

    return train_step


def build_eval_step(opt):
    """``eval_step(model, batch, generator=None) -> (out, loss parts)``:
    the eval forward of view 0 (reference ``test()``,
    ``train_test_MT.py:340-458``); with ``--test_augment`` the view is
    augmented from ``generator``, else normalised in the compute dtype.
    The mmdynamics model gives the fused branch alone: ``hazard_fuse`` its
    logits, ``pred_fuse`` their log-softmax (JAX ``train/steps.py:
    598-605``)."""
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
        if is_dynamics(opt):
            mm_logit = model(x, batch["omic"], infer=True)
            out = PathomicOutput(None, None, None, None, mm_logit, None, None,
                                 torch.log_softmax(mm_logit, dim=1), None,
                                 None)
        else:
            out = adapt_output(opt, _apply(opt, model, batch, x))
        return out, task_losses(opt, out, batch)[1]

    return eval_step
