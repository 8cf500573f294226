"""MaxNet self-normalizing genomic encoder (PyTorch).

Port of ``multimodal_learning_tpu/models/maxnet.py`` with the reference's
module names (``MICCAI-2022/networks_new.py:182-251``): a 4-layer SNN
``80 -> 64 -> 48 -> 32 -> omic_dim`` of [Linear -> ELU -> AlphaDropout]
(``encoder.K``), a ReLU feature head, and a linear classifier
(``classifier.0``).  Returns ``(features, hazard, pred)``; the classifier
runs in float32 on the float32 features, as in the JAX module.

:class:`MaxNetDecoder` is the reverse SNN ``z -> 32 -> 48 -> 64 ->
output_dim`` (CLAT stage-1 dead code in the reference,
``MIA 2023/stage1_multi_modal_teacher/networks_new.py:493-521``,
library-level here), with the JAX module's names ``decoder1..4``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from .common import apply_act, autocast, init_linear_


class MaxNet(nn.Module):
    def __init__(self, input_dim: int = 80, omic_dim: int = 32,
                 dropout_rate: float = 0.25, act_type: str = "LSM",
                 label_dim: int = 3, init_max: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_type = act_type
        self.dtype = dtype
        layers, d = [], input_dim
        for width in (64, 48, 32, omic_dim):
            layers.append(nn.Sequential(
                init_linear_(nn.Linear(d, width), init_max, generator),
                nn.ELU(), nn.AlphaDropout(dropout_rate)))
            d = width
        self.encoder = nn.Sequential(*layers)
        self.classifier = nn.Sequential(
            init_linear_(nn.Linear(omic_dim, label_dim), init_max, generator))

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        with autocast(x, self.dtype):
            h = self.encoder(x.to(self.dtype))
        features = torch.relu(h).float()
        hazard = self.classifier(features)
        return features, hazard, apply_act(self.act_type, hazard)


class MaxNetDecoder(nn.Module):
    """``decoder1..3`` = [Linear (max init, zero bias) -> ELU ->
    AlphaDropout], then the Linear ``decoder4``; float32 output."""

    def __init__(self, omic_dim: int = 32, output_dim: int = 80,
                 dropout_rate: float = 0.25,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        d = omic_dim
        for i, width in enumerate((32, 48, 64, output_dim), 1):
            setattr(self, f"decoder{i}",
                    init_linear_(nn.Linear(d, width), True, generator))
            d = width
        self.act, self.drop = nn.ELU(), nn.AlphaDropout(dropout_rate)

    def forward(self, z) -> torch.Tensor:
        with autocast(z, self.dtype):
            h = z.to(self.dtype)
            for i in (1, 2, 3):
                h = self.drop(self.act(getattr(self, f"decoder{i}")(h)))
        return self.decoder4(h.float()).float()
