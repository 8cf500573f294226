"""ResNet pathology encoder (PyTorch).

Port of ``multimodal_learning_tpu/models/resnet.py`` with the reference's
module names (``MICCAI-2022/resnets.py``): torchvision-style ResNet18 trunk
with the grading heads ``fc_new1 = Linear(512 -> path_dim) + BN + ReLU`` and
``fc_new2 = Linear(path_dim -> num_classes)`` (``resnets.py:165-169``),
returning ``(feat_f3, features, hazard, pred)`` where ``feat_f3`` is the
global-average-pooled layer-3 map (``resnets.py:234``).

The public input is NHWC, as in the JAX module; the trunk runs NCHW (the
permute of a contiguous NHWC tensor is a channels-last view, no copy).
flax BatchNorm ``momentum=0.9`` is torch ``momentum=0.1``; eps is 1e-5 in
both.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from .common import (BatchNorm1d, BatchNorm2d, apply_act, autocast,
                     init_linear_, kaiming_normal_out_)


def _conv(cin, cout, k, stride, pad, generator):
    conv = nn.Conv2d(cin, cout, k, stride, pad, bias=False)
    kaiming_normal_out_(conv.weight, generator)
    return conv


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block (``resnets.py:37-74``)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 3, stride, 1, generator)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, 1, 1, generator)
        self.bn2 = BatchNorm2d(planes)
        self.downsample = None
        if stride != 1 or inplanes != planes:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes, 1, stride, 0, generator),
                BatchNorm2d(planes))

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return torch.relu(y + identity)


class ResNet(nn.Module):
    """ResNet trunk + pathomic heads.

    ``forward(x)`` with ``x: [B, H, W, 3]`` returns
    ``(feat_f3, features, hazard, pred)``, all float32:
      feat_f3  [B, 256]       layer-3 GAP feature (``resnets.py:234``)
      features [B, path_dim]  post-``fc_new1`` feature
      hazard   [B, classes]   raw logits
      pred     [B, classes]   activated output (log-probs for grading)
    """

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 path_dim: int = 32, num_classes: int = 3,
                 act_type: str = "LSM", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.act_type = act_type
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 3, generator)
        self.bn1 = BatchNorm2d(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        for i, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n_blocks):
                stride = 2 if (i > 0 and j == 0) else 1
                blocks.append(BasicBlock(inplanes, planes, stride, generator))
                inplanes = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.fc_new1 = nn.Sequential(
            init_linear_(nn.Linear(inplanes, path_dim), False, generator),
            BatchNorm1d(path_dim), nn.ReLU())
        self.fc_new2 = init_linear_(nn.Linear(path_dim, num_classes), False,
                                    generator)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        with autocast(x, self.dtype):
            x = x.permute(0, 3, 1, 2).to(self.dtype)
            x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
            x = self.layer2(self.layer1(x))
            f3 = self.layer3(x)
            x = self.layer4(f3)
            feat_f3 = f3.mean((2, 3))
            features = self.fc_new1(x.mean((2, 3)))
            hazard = self.fc_new2(features)
        hazard = hazard.float()
        return (feat_f3.float(), features.float(), hazard,
                apply_act(self.act_type, hazard))


def ResNet18(path_dim=32, num_classes=3, act_type="LSM",
             dtype=torch.float32, generator=None):
    """reference ``resnets.py:287-295``."""
    return ResNet((2, 2, 2, 2), path_dim=path_dim, num_classes=num_classes,
                  act_type=act_type, dtype=dtype, generator=generator)
