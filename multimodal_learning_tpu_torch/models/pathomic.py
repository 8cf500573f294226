"""PathomicModel — the multimodal teacher/student container (PyTorch).

Port of ``multimodal_learning_tpu/models/pathomic.py`` (reference
``MICCAI-2022/networks_new.py:267-369``): ``path_net`` (ResNet18) +
``omic_net`` (MaxNet) + fusion + linear classifier (``classifier.0``).
Branch outputs come back as a :class:`PathomicOutput` with the JAX
package's field order; ``cut_fuse_grad`` detaches the unimodal features
before fusion (``networks_new.py:302-311``); ``fusion_type='concat'``
concatenates the features (stage-1 variant, classifier takes
``path_dim+omic_dim``).  Train or eval mode is the module's
``training`` flag.

:class:`PathomicDynamicsModel` is the mmdynamics container (reference
``PathomicNet_dynamics``, ``networks_new.py:372-418``): the same encoders
feed :class:`~.mmdynamic.MMDynamic`, which computes its own loss.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from ..utils.logging import span
from .common import apply_act, init_linear_
from .fusion import BilinearFusion, HFBFusion, LMFusion, PolynomialFusion
from .maxnet import MaxNet
from .mmdynamic import MMDynamic
from .resnet import ResNet18


class PathomicOutput(NamedTuple):
    """Branch outputs (reference return tuple ``networks_new.py:352-353``)."""
    fuse_feat: Optional[torch.Tensor]   # fused feature [B, mmhid]
    path_feat: Optional[torch.Tensor]   # path feature  [B, path_dim]
    omic_feat: Optional[torch.Tensor]   # omic feature  [B, omic_dim]
    path_feat_f3: Optional[torch.Tensor]  # layer-3 GAP feature [B, 256]
    hazard_fuse: Optional[torch.Tensor]
    hazard_path: Optional[torch.Tensor]
    hazard_omic: Optional[torch.Tensor]
    pred_fuse: Optional[torch.Tensor]   # activated (log-probs / range-shifted)
    pred_path: Optional[torch.Tensor]
    pred_omic: Optional[torch.Tensor]


def make_fusion(fusion_type: str, *, skip=0, use_bilinear=1, path_gate=1,
                omic_gate=1, path_dim=128, omic_dim=128, path_scale=1,
                omic_scale=1, mmhid=128, dropout_rate=0.25,
                pallas_fusion="off", generator=None) -> Optional[nn.Module]:
    """reference ``define_bifusion`` (``networks_new.py:148-175``) with the
    JAX package's polynomial, LMF (rank 4) and HFB (rank 20) types.
    ``pallas_fusion`` routes the pofusion Kronecker contraction through the
    CUDA kernel: "eval" for the eval forward, "train" for training too; the
    other types have no kernel and ignore it, as in the JAX package."""
    gated = dict(skip=skip, use_bilinear=use_bilinear, gate1=path_gate,
                 gate2=omic_gate, dim1=path_dim, dim2=omic_dim,
                 scale_dim1=path_scale, scale_dim2=omic_scale, mmhid=mmhid,
                 dropout_rate=dropout_rate, generator=generator)
    if fusion_type == "pofusion":
        return BilinearFusion(
            **gated, pallas_eval=pallas_fusion in ("eval", "train"),
            pallas_train=pallas_fusion == "train")
    if fusion_type == "polynomial_fusion":
        return PolynomialFusion(**gated)
    if fusion_type == "LMF":
        return LMFusion(dim1=path_dim, dim2=omic_dim, mmhid=mmhid, rank=4,
                        dropout_rate=dropout_rate, generator=generator)
    if fusion_type == "HFB":
        return HFBFusion(dim1=path_dim, dim2=omic_dim, mmhid=mmhid, rank=20,
                         dropout_rate=dropout_rate, generator=generator)
    if fusion_type == "concat":
        return None
    raise NotImplementedError(f"fusion type [{fusion_type}] is not found")


class PathomicDynamicsModel(nn.Module):
    """The mmdynamics model: ``path_net`` and ``omic_net`` feed
    ``fusion``, an :class:`MMDynamic` over their features with one hidden
    layer of ``mmhid`` and a dropout of 0.5 whatever ``dropout_rate`` says
    (JAX ``pathomic.py:101-103``; ``dropout_rate`` reaches MaxNet only).
    ``forward(x_path, x_omic, labels)`` returns ``(loss, mm_logit,
    tcp_logits)``; with ``infer=True`` or without labels, ``mm_logit``."""

    def __init__(self, path_dim: int = 128, omic_dim: int = 128,
                 mmhid: int = 128, label_dim: int = 3,
                 input_size_omic: int = 80, dropout_rate: float = 0.25,
                 act_type: str = "LSM", init_max: bool = True,
                 dtype: torch.dtype = torch.float32, paired_conv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.path_net = ResNet18(path_dim=path_dim, num_classes=label_dim,
                                 act_type=act_type, dtype=dtype,
                                 generator=generator, paired=paired_conv)
        self.omic_net = MaxNet(input_dim=input_size_omic, omic_dim=omic_dim,
                               dropout_rate=dropout_rate, act_type=act_type,
                               label_dim=label_dim, init_max=init_max,
                               dtype=dtype, generator=generator)
        self.fusion = MMDynamic((path_dim, omic_dim), hidden_dim=(mmhid,),
                                num_class=label_dim, dropout=0.5,
                                generator=generator)

    def forward(self, x_path, x_omic, labels=None, infer: bool = False):
        path_feat = self.path_net(x_path)[1]
        omic_feat = self.omic_net(x_omic)[0]
        return self.fusion([path_feat, omic_feat], labels=labels,
                           infer=infer)


class PathomicModel(nn.Module):
    """Multimodal model; also runs single-branch when one input is None."""

    def __init__(self, path_dim: int = 128, omic_dim: int = 128,
                 mmhid: int = 128, label_dim: int = 3,
                 input_size_omic: int = 80, dropout_rate: float = 0.25,
                 act_type: str = "LSM", fusion_type: str = "pofusion",
                 skip: int = 0, use_bilinear: int = 1, path_gate: int = 1,
                 omic_gate: int = 1, path_scale: int = 1, omic_scale: int = 1,
                 cut_fuse_grad: bool = False, init_max: bool = True,
                 dtype: torch.dtype = torch.float32,
                 pallas_fusion: str = "off", paired_conv: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_type = act_type
        self.cut_fuse_grad = cut_fuse_grad
        self.path_net = ResNet18(path_dim=path_dim, num_classes=label_dim,
                                 act_type=act_type, dtype=dtype,
                                 generator=generator, paired=paired_conv)
        self.omic_net = MaxNet(input_dim=input_size_omic, omic_dim=omic_dim,
                               dropout_rate=dropout_rate, act_type=act_type,
                               label_dim=label_dim, init_max=init_max,
                               dtype=dtype, generator=generator)
        self.fusion = make_fusion(
            fusion_type, skip=skip, use_bilinear=use_bilinear,
            path_gate=path_gate, omic_gate=omic_gate, path_dim=path_dim,
            omic_dim=omic_dim, path_scale=path_scale, omic_scale=omic_scale,
            mmhid=mmhid, dropout_rate=dropout_rate,
            pallas_fusion=pallas_fusion, generator=generator)
        clf_in = path_dim + omic_dim if self.fusion is None else mmhid
        self.classifier = nn.Sequential(
            init_linear_(nn.Linear(clf_in, label_dim), False, generator))

    def forward(self, x_path=None, x_omic=None,
                path_feats=None) -> PathomicOutput:
        """``path_feats``: precomputed ``(path_feat_f3, path_feat,
        hazard_path, pred_path)`` in place of running ``path_net``.  Each
        part that runs is a span of the recorder (``utils/logging``):
        ``path_net``, ``omic_net``, ``fusion``, ``classifier``."""
        path_feat = omic_feat = path_feat_f3 = None
        hazard_path = hazard_omic = pred_path = pred_omic = None
        if path_feats is not None:
            path_feat_f3, path_feat, hazard_path, pred_path = path_feats
        elif x_path is not None:
            with span("path_net"):
                path_feat_f3, path_feat, hazard_path, pred_path = \
                    self.path_net(x_path)
        if x_omic is not None:
            with span("omic_net"):
                omic_feat, hazard_omic, pred_omic = self.omic_net(x_omic)

        if path_feat is None or x_omic is None:
            return PathomicOutput(None, path_feat, omic_feat, path_feat_f3,
                                  None, hazard_path, hazard_omic,
                                  None, pred_path, pred_omic)

        pv, ov = path_feat, omic_feat
        if self.cut_fuse_grad:  # networks_new.py:302-306
            pv, ov = pv.detach(), ov.detach()
        with span("fusion"):
            if self.fusion is None:  # concat
                fuse_feat = torch.cat([pv, ov], dim=1)
            else:
                fuse_feat = self.fusion(pv, ov)
        with span("classifier"):
            hazard_fuse = self.classifier(fuse_feat)
            pred_fuse = apply_act(self.act_type, hazard_fuse)
        return PathomicOutput(fuse_feat, path_feat, omic_feat, path_feat_f3,
                              hazard_fuse, hazard_path, hazard_omic,
                              pred_fuse, pred_path, pred_omic)
