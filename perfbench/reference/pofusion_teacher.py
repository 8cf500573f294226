"""Plain reference of ``pofusion_teacher``: the MICCAI-2022 mean-teacher
multimodal step (``train_test_MT.py:108-242``; recipe ``--pred_distill 1
--CRD_distill 0 --cut_fuse_grad --beta1 0.9``) and its eval forward.

One step: both views augmented; the EMA model's forward in train mode on
view 2 without gradient; the model's on view 1; the three branches' NLL,
the L1 penalty of ``reg_type``, the prediction KD of each branch against
the EMA's (one teacher, its own branch); Adam with L2 decay; the EMA
update.  fp32 throughout, TF32 off.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import plain
from .feed import batches
from .steps import Readings, run_steps, split_weights


def _step(o: Dict, W, E, batch, gens, q, noise_dtype):
    x1, x2 = plain.augment_views(gens["augment"], batch["path_views"])
    drops = plain.Drops(gens["augment"], noise_dtype)
    rate, cut = o["dropout_rate"], o["cut_fuse_grad"]
    with torch.no_grad():
        eo = plain.pathomic(E, "", x2, batch["omic"], True, q, rate, drops,
                            cut)
    out = plain.pathomic(W, "", x1, batch["omic"], True, q, rate, drops, cut)
    g = batch["g"]
    loss = o["lambda_nll"] * (plain.nll(out.pred_fuse, g)
                              + plain.nll(out.pred_path, g)
                              + plain.nll(out.pred_omic, g))
    reg = {"omic": ("omic_net.",), "none": ()}[o["reg_type"]]
    if reg:
        loss = loss + o["lambda_reg"] * plain.l1(
            [v for k, v in W.items() if k.startswith(reg) and v.requires_grad])
    if o["pred_distill"] == 1:
        if o["num_teachers"] != 1:
            raise NotImplementedError("the reference holds one teacher")
        loss = loss + o["KD_weight"] * (
            plain.pred_kd(out.pred_fuse, eo.pred_fuse)
            + plain.pred_kd(out.pred_path, eo.pred_path)
            + plain.pred_kd(out.pred_omic, eo.pred_omic))
    return loss


def train(cfg: Dict, inp: Dict, n_steps: int, quant: str = "fp32"
          ) -> Readings:
    """The first ``n_steps`` steps from the run's weights and seeds."""
    o = cfg["options"]
    dev = inp["device"]
    W, E, _ = split_weights(inp["weights"], dev)
    feed = batches(inp["rois"], inp["tab"], o["batch_size"], 2,
                   o["input_size_path"], inp["seeds"]["loader"])

    def step(t, batch, gens, q):
        return _step(o, W, E, batch, gens, q, inp["noise_dtype"])

    return run_steps(cfg, inp, W, E, {}, feed, step, n_steps, quant)


@torch.no_grad()
def serve(cfg: Dict, weights: Dict[str, torch.Tensor], x_u8, omic,
          quant: str = "fp32") -> Dict[str, torch.Tensor]:
    """The eval forward's branch hazards for rows ``x_u8`` [n, S, S, 3],
    each with the scale of its last layer's sum (``plain.scale``)."""
    o = cfg["options"]
    W = {k[len("model."):]: v.float() for k, v in weights.items()
         if k.startswith("model.")}
    out = plain.pathomic(W, "", x_u8.float() / 127.5 - 1.0, omic, False,
                         plain.QUANTS[quant], 0.0, plain.Drops(None),
                         o["cut_fuse_grad"])
    heads = {"fuse": (out.fuse_feat, "classifier.0"),
             "path": (out.path_feat, "path_net.fc_new2"),
             "omic": (out.omic_feat, "omic_net.classifier.0")}
    res = {}
    for name, (feat, layer) in heads.items():
        res[f"hazard_{name}"] = getattr(out, f"hazard_{name}")
        res[f"scale_{name}"] = plain.scale(feat, W[f"{layer}.weight"],
                                           W[f"{layer}.bias"])
    return res
