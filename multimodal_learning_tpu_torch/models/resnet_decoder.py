"""ResnetDecoder: the CLAT stage-1 reconstruction decoder (PyTorch).

Port of ``multimodal_learning_tpu/models/resnet_decoder.py`` (reference
``MIA 2023/stage1_multi_modal_teacher/networks_new.py:432-491``, imported
but never called there, so library-level here): latent ->
``Linear(512*2*2)`` -> 5 x [ConvTranspose(4, stride 2), BN, ReLU] ->
ConvTranspose to 3 channels -> tanh, [B, 128, 128, 3] channels-last as the
JAX module returns it.

flax's ``ConvTranspose(4, strides=2, padding="SAME")`` (no kernel
transpose) correlates the 2x-dilated input, padded by 2 on each side, with
its kernel as stored; ``nn.ConvTranspose2d(4, stride=2, padding=1)`` is the
same map with the kernel flipped in both spatial axes
(``models/import_flax.py`` carries the weights).  Initialisation follows
flax: lecun-normal (truncated) transposed-convolution kernels with zero
biases, a torch-default ``Linear`` kernel with a zero bias.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .common import BatchNorm2d, torch_linear_default_

_WIDTHS = (256, 128, 64, 32, 16)
# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def _lecun_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax ``lecun_normal`` on a transposed-convolution weight
    [in, out, kh, kw]: fan_in = in kh kw, normal truncated at 2 std."""
    std = math.sqrt(1.0 / (w.shape[0] * w.shape[2] * w.shape[3])) / _TRUNC_STD
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def _up(c_in: int, c_out: int, generator) -> nn.ConvTranspose2d:
    conv = nn.ConvTranspose2d(c_in, c_out, 4, stride=2, padding=1)
    _lecun_normal_(conv.weight, generator)
    nn.init.zeros_(conv.bias)
    return conv


class ResnetDecoder(nn.Module):
    def __init__(self, latent_dim: int = 128, out_size: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.out_size = out_size
        self.fc = nn.Linear(latent_dim, 512 * 2 * 2)
        torch_linear_default_(self.fc.weight, generator)
        nn.init.zeros_(self.fc.bias)
        c_in = 512
        for i, width in enumerate(_WIDTHS):
            setattr(self, f"up{i}", _up(c_in, width, generator))
            setattr(self, f"bn{i}", BatchNorm2d(width))
            c_in = width
        self.out = _up(c_in, 3, generator)

    def forward(self, z):
        # the Linear's outputs are (h, w, c) row-major, as flax reshapes them
        h = self.fc(z).reshape(z.shape[0], 2, 2, 512).permute(0, 3, 1, 2)
        for i in range(len(_WIDTHS)):
            h = torch.relu(getattr(self, f"bn{i}")(getattr(self, f"up{i}")(h)))
        return torch.tanh(self.out(h)).permute(0, 2, 3, 1)
