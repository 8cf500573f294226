"""Model factory — reference ``define_net`` (``networks_new.py:53-77``)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .maxnet import MaxNet
from .pathomic import PathomicDynamicsModel, PathomicModel
from .resnet import ResNet18


def _dtype(opt) -> torch.dtype:
    """Compute dtype of the ResNet and MaxNet encoders; fusion and the
    classifier stay float32, as in the JAX package."""
    return torch.bfloat16 if opt.compute_dtype == "bfloat16" else torch.float32


def is_dynamics(opt) -> bool:
    """The mmdynamics model: its own train step, eval forward and serving
    output (``PathomicDynamicsModel``)."""
    return opt.mode == "pathomic" and opt.fusion_type == "mmdynamics"


def define_model(opt, path_only: bool = False, omic_only: bool = False,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Build the model for ``opt.mode`` in {path, omic, pathomic}; with
    ``path_only``/``omic_only`` the pathomic mode yields the unimodal student
    encoders (``networks_new.py:63-74``).  Weights are drawn on the CPU from
    ``generator`` (the global generator when None)."""
    if opt.mode == "path" or (opt.mode == "pathomic" and path_only):
        return ResNet18(path_dim=opt.path_dim, num_classes=opt.label_dim,
                        act_type=opt.act_type, dtype=_dtype(opt),
                        generator=generator,
                        paired=getattr(opt, "paired_conv", False))
    if opt.mode == "omic" or (opt.mode == "pathomic" and omic_only):
        return MaxNet(input_dim=opt.input_size_omic, omic_dim=opt.omic_dim,
                      dropout_rate=opt.dropout_rate, act_type=opt.act_type,
                      label_dim=opt.label_dim,
                      init_max=(opt.init_type == "max"), dtype=_dtype(opt),
                      generator=generator)
    if is_dynamics(opt):
        return PathomicDynamicsModel(
            path_dim=opt.path_dim, omic_dim=opt.omic_dim, mmhid=opt.mmhid,
            label_dim=opt.label_dim, input_size_omic=opt.input_size_omic,
            dropout_rate=opt.dropout_rate, act_type=opt.act_type,
            init_max=(opt.init_type == "max"), dtype=_dtype(opt),
            paired_conv=getattr(opt, "paired_conv", False),
            generator=generator)
    if opt.mode == "pathomic":
        return PathomicModel(
            path_dim=opt.path_dim, omic_dim=opt.omic_dim, mmhid=opt.mmhid,
            label_dim=opt.label_dim, input_size_omic=opt.input_size_omic,
            dropout_rate=opt.dropout_rate, act_type=opt.act_type,
            fusion_type=opt.fusion_type, skip=opt.skip,
            use_bilinear=opt.use_bilinear, path_gate=opt.path_gate,
            omic_gate=opt.omic_gate, path_scale=opt.path_scale,
            omic_scale=opt.omic_scale, cut_fuse_grad=opt.cut_fuse_grad,
            init_max=(opt.init_type == "max"), dtype=_dtype(opt),
            pallas_fusion=getattr(opt, "pallas_fusion", "off"),
            paired_conv=getattr(opt, "paired_conv", False),
            generator=generator)
    raise NotImplementedError(f"mode [{opt.mode}] is not implemented")
