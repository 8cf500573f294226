"""Plain reference of ``clat_student``: the MIA-2023 stage-2 adaptive
teaching step (``stage2_unimodal_student/train_test_path_multi_distill.py
:320-460``, ``CL_utils/CRD_criterion_v10.py``; recipe
``train_20230805.sh``) and the student's eval forward.

One step: both views augmented; the EMA student's forward on view 2 and
the frozen multimodal teacher's on view 1 (train mode: BatchNorm by the
batch, dropout live, its masks from the teacher's generator), both
without gradient; the student's forward on view 1; per-sample DistillKL
from both teachers; CRD v10 against each teacher's bank: the ``nce_p``
most similar same-class bank rows as positives (the similarity row
masked by class before a stable descending sort), weighted by their
similarities, ``nce_k`` sampled negatives, Z from the first batch, the
bank rows of the batch momentum-updated; GK-Refine: per sample the
pairwise cosines of the five losses' gradients at the student feature,
thresholded at ``grads_thresh``, each KD loss weighted by its row sum;
NLL; Adam with L2 decay over the student and the four heads; the EMA
update.  Sample reweighting is off (the recipe's 30 epochs never reach
``start_reweight``).  fp32 throughout, TF32 off.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.nn import functional as F

from . import plain
from .feed import Sampler, batches
from .steps import Readings, run_steps, split_weights

EPS = 1e-7


def _l2n(x):
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True
                                        ).clamp_min(1e-12)


def _embed(P, name, x, q):
    y = plain.linear(q, x, P[f"embeds.{name}.fc1.weight"],
                     P[f"embeds.{name}.fc1.bias"])
    return y / y.pow(2).sum(dim=1, keepdim=True).sqrt()


def _scores(banks, name, v1, v2, g, y, idx, class_mask, o):
    """Scores of both sides over [kNN positives | sampled negatives],
    divided by Z (set on first use); the bank rows ``y`` are updated
    after.  Returns (out_v1, out_v2, sim for v1's loss, sim for v2's)."""
    m1, m2 = banks[f"bank.{name}.memory_v1"], banks[f"bank.{name}.memory_v2"]
    P, T, mom = o["nce_p"], o["nce_t"], o["nce_m"]
    w1, w2 = m1[idx], m2[idx]
    bmask = class_mask[g]

    def knn(mem, query):
        sim = bmask * (_l2n(query) @ _l2n(mem).t())
        vals, ids = torch.sort(sim, dim=1, descending=True, stable=True)
        return mem[ids[:, :P]], vals[:, :P]

    k1, s1 = knn(m1, w1[:, 0])
    k2, s2 = knn(m2, w2[:, 0])
    w1 = torch.cat([k1, w1[:, 1:]], dim=1)
    w2 = torch.cat([k2, w2[:, 1:]], dim=1)
    out_v2 = torch.exp(torch.einsum("bsd,bd->bs", w1, v2) / T)
    out_v1 = torch.exp(torch.einsum("bsd,bd->bs", w2, v1) / T)
    n = m1.shape[0]
    with torch.no_grad():
        for side, out in (("z_v1", out_v1), ("z_v2", out_v2)):
            z = banks[f"bank.{name}.{side}"]
            z.copy_(torch.where(z < 0, out.mean() * n, z))
        for mem, v in ((m1, v1), (m2, v2)):
            new = mem[y] * mom + v.detach() * (1.0 - mom)
            mem.index_copy_(0, y, new / new.pow(2).sum(dim=1,
                                                      keepdim=True).sqrt())
    return (out_v1 / banks[f"bank.{name}.z_v1"],
            out_v2 / banks[f"bank.{name}.z_v2"], s2, s1)


def _nce(x, n_data, P, weights, sims):
    m = x.shape[1] - P
    mpn = m / float(n_data)
    pos = x[:, :P]
    log_d1 = torch.log(pos / (pos + mpn + EPS))
    log_d0 = torch.log(mpn / (x[:, P:] + mpn + EPS)).sum(1)
    per = -((log_d1 + log_d0[:, None]) * sims).sum(1) / sims.sum(
        1).clamp_min(1e-12)
    return weights * per


def _distill_kl(ls, lt, T):
    return plain.kl_terms(torch.log_softmax(ls / T, dim=1),
                          torch.softmax(lt / T, dim=1)).sum(1) * T ** 2


def _step(o, W, E, X, batch, gens, q, noise_dtype, class_mask):
    x1, x2 = plain.augment_views(gens["augment"], batch["path_views"])
    rate = o["dropout_rate"]
    with torch.no_grad():
        ema_feat, ema_logit, _ = plain.resnet18(E, "", x2, True, q)
        teacher = {k[len("teacher."):]: v for k, v in X.items()
                   if k.startswith("teacher.")}
        with plain.default_generator_as(gens["teacher"]):
            t_out = plain.pathomic(teacher, "", x1, batch["omic"], True, q,
                                   rate, plain.Drops(gens["teacher"],
                                                     noise_dtype), False)
    feat, _, pred = plain.resnet18(W, "", x1, True, q)
    g = batch["g"].long()
    bsz = feat.shape[0]
    loss_cls = plain.nll(pred, g)
    logit = F.linear(feat, W["fc_new2.weight"], W["fc_new2.bias"])
    ones = torch.ones(bsz, device=feat.device)
    alpha, beta, T = o["alpha"], o["beta"], o["kd_T"]
    kd = {"div1": alpha * _distill_kl(logit, t_out.hazard_fuse, T),
          "div2": alpha * _distill_kl(logit, ema_logit, T)}
    t_feats = {"fuse": t_out.fuse_feat, "ema": ema_feat}
    idx, y = batch["sample_idx"].long(), batch["index"].long()
    for i, name in enumerate(("fuse", "ema"), 1):
        f_s = _embed(X, f"crd_{name}_s", feat, q)
        f_t = _embed(X, f"crd_{name}_t", t_feats[name], q)
        out_s, out_t, sim_s, sim_t = _scores(X, name, f_s, f_t, g, y, idx,
                                             class_mask, o)
        kd[f"kd{i}"] = beta * (_nce(out_s, class_mask.shape[1], o["nce_p"],
                                    ones, sim_s)
                               + _nce(out_t, class_mask.shape[1],
                                      o["nce_p"], ones, sim_t))
    kd_vals = [kd[k] for k in sorted(kd)]
    losses = [v.sum() / bsz for v in kd_vals] + [
        plain.nll(torch.log_softmax(logit, dim=1), g)]
    grads = torch.stack([torch.autograd.grad(v, feat, retain_graph=True)[0]
                         for v in losses], dim=1).detach()
    gn = grads / torch.linalg.vector_norm(grads, dim=2, keepdim=True
                                          ).clamp_min(1e-12)
    cos = torch.einsum("bld,bmd->blm", gn, gn)
    scale = (cos > o["grads_thresh"]).float().sum(dim=2)
    loss_kd = (scale[:, :len(kd_vals)] * torch.stack(kd_vals, dim=1)
               ).sum() / bsz
    return o["lambda_nll"] * loss_cls + loss_kd


def train(cfg: Dict, inp: Dict, n_steps: int, quant: str = "fp32"
          ) -> Readings:
    o = cfg["options"]
    dev = inp["device"]
    W, E, X = split_weights(inp["weights"], dev)
    for k, v in list(X.items()):
        if k.startswith("embeds."):
            v.requires_grad_(True)
        if k.endswith(".memory_v1"):     # Z not estimated yet
            for side in ("z_v1", "z_v2"):
                X[k[:-len("memory_v1")] + side] = torch.full((), -1.0,
                                                             device=dev)
    g_all = torch.as_tensor(inp["tab"]["g"], device=dev).long()
    class_mask = F.one_hot(g_all, o["label_dim"]).t().float()
    sampler = Sampler(inp["tab"]["g"], o["label_dim"], o["nce_k"],
                      o["neg_mode"], inp["seeds"]["sampler"])
    feed = batches(inp["rois"], inp["tab"], o["batch_size"], 2,
                   o["input_size_path"], inp["seeds"]["loader"], sampler)

    def step(t, batch, gens, q):
        return _step(o, W, E, X, batch, gens, q, inp["noise_dtype"],
                     class_mask)

    extra = {k: v for k, v in X.items()
             if k.startswith("embeds.") or ".memory_" in k}
    return run_steps(cfg, inp, W, E, extra, feed, step, n_steps, quant)


@torch.no_grad()
def serve(cfg: Dict, weights: Dict[str, torch.Tensor], x_u8, omic,
          quant: str = "fp32") -> Dict[str, torch.Tensor]:
    """The student's eval forward (``mode path``): its hazards, with the
    scale of the last layer's sum (``plain.scale``)."""
    W = {k[len("model."):]: v.float() for k, v in weights.items()
         if k.startswith("model.")}
    feat, hazard, _ = plain.resnet18(W, "", x_u8.float() / 127.5 - 1.0,
                                     False, plain.QUANTS[quant])
    return {"hazard_path": hazard,
            "scale_path": plain.scale(feat, W["fc_new2.weight"],
                                      W["fc_new2.bias"])}
