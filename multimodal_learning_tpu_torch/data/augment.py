"""On-device image augmentation (PyTorch).

Port of ``multimodal_learning_tpu/data/augment.py``, which replaces the
reference's torchvision transforms (``data_loaders_MT.py:112-119``):
RandomHorizontalFlip(0.5) -> RandomVerticalFlip(0.5) -> ColorJitter(
brightness=0.1, contrast=0.1, saturation=0.05, hue=0.01) -> ToTensor ->
Normalize(+-0.5), over a uint8 NHWC batch already cropped on the host.  It
keeps the JAX package's documented deviations: a fixed op order
(brightness, contrast, saturation, hue) and the hue as a YIQ rotation.

Drawing the random factors (``draw_flips``, ``draw_jitter``, from a
``torch.Generator`` on the batch's device) is split from applying them
(``apply_flips``, ``apply_color_jitter``, ``augment_view_apply``), so a
test can feed both packages the same flips and factors.  The work runs in
the compute dtype; the contrast mean accumulates in float32.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_GRAY = (0.299, 0.587, 0.114)   # ITU-R 601-2 luma, as PIL's convert("L")
_RGB2YIQ = ((0.299, 0.587, 0.114),
            (0.596, -0.274, -0.322),
            (0.211, -0.523, 0.312))
_YIQ2RGB = ((1.0, 0.956, 0.621),
            (1.0, -0.272, -0.647),
            (1.0, -1.106, 1.703))


class Flips(NamedTuple):
    horizontal: torch.Tensor   # bool [B]
    vertical: torch.Tensor     # bool [B]


class Jitter(NamedTuple):
    brightness: torch.Tensor   # float32 [B]
    contrast: torch.Tensor     # float32 [B]
    saturation: torch.Tensor   # float32 [B]
    hue: torch.Tensor          # float32 [B], in turns


def _uniform(gen, b, lo, hi, device):
    return torch.rand(b, generator=gen, device=device) * (hi - lo) + lo


def draw_flips(gen: Optional[torch.Generator], b: int, device) -> Flips:
    """Independent H/V flips per sample with p = 0.5."""
    return Flips(torch.rand(b, generator=gen, device=device) < 0.5,
                 torch.rand(b, generator=gen, device=device) < 0.5)


def draw_jitter(gen: Optional[torch.Generator], b: int, device,
                brightness: float = 0.1, contrast: float = 0.1,
                saturation: float = 0.05, hue: float = 0.01) -> Jitter:
    """Per-sample jitter factors, uniform in [1-x, 1+x] (hue in [-h, h])."""
    return Jitter(_uniform(gen, b, 1 - brightness, 1 + brightness, device),
                  _uniform(gen, b, 1 - contrast, 1 + contrast, device),
                  _uniform(gen, b, 1 - saturation, 1 + saturation, device),
                  _uniform(gen, b, -hue, hue, device))


def apply_flips(x: torch.Tensor, flips: Flips) -> torch.Tensor:
    """x [B, H, W, C]: flip W where ``horizontal``, then H where
    ``vertical``."""
    x = torch.where(flips.horizontal[:, None, None, None], x.flip(2), x)
    return torch.where(flips.vertical[:, None, None, None], x.flip(1), x)


def random_flips(gen: Optional[torch.Generator], x: torch.Tensor
                 ) -> torch.Tensor:
    return apply_flips(x, draw_flips(gen, x.shape[0], x.device))


def hue_rotation_matrices(theta: torch.Tensor) -> torch.Tensor:
    """Per-sample RGB hue-rotation matrices by a rotation in YIQ space
    (theta [B] radians -> [B, 3, 3], float32), the JAX package's
    ``_hue_rotation_matrices``."""
    kw = dict(dtype=torch.float32, device=theta.device)
    c, s = torch.cos(theta), torch.sin(-theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([ones, zeros, zeros], -1),
                       torch.stack([zeros, c, -s], -1),
                       torch.stack([zeros, s, c], -1)], -2)
    return torch.einsum("ij,bjk,kl->bil", torch.tensor(_YIQ2RGB, **kw), rot,
                        torch.tensor(_RGB2YIQ, **kw))


def apply_color_jitter(x: torch.Tensor, f: Jitter) -> torch.Tensor:
    """x [B, H, W, 3] in [0, 1], in its own dtype: brightness, contrast
    (blend with the mean gray, the mean taken in float32), saturation
    (blend with the gray), hue; each clipped to [0, 1]."""
    dt = x.dtype
    col = lambda t: t.to(dt)[:, None, None, None]
    w = torch.tensor(_GRAY, dtype=dt, device=x.device)

    def gray(y):
        return w[0] * y[..., :1] + w[1] * y[..., 1:2] + w[2] * y[..., 2:3]

    fb, fc, fs = col(f.brightness), col(f.contrast), col(f.saturation)
    hue_m = hue_rotation_matrices(f.hue * 2.0 * math.pi).to(dt)
    y = (x * fb).clamp(0.0, 1.0)
    mean = gray(y).float().mean(dim=(1, 2), keepdim=True).to(dt)
    y = (y * fc + mean * (1.0 - fc)).clamp(0.0, 1.0)
    y = (y * fs + gray(y) * (1.0 - fs)).clamp(0.0, 1.0)
    return torch.einsum("bij,bhwj->bhwi", hue_m, y).clamp(0.0, 1.0)


def color_jitter_batch(gen: Optional[torch.Generator], x: torch.Tensor,
                       brightness: float = 0.1, contrast: float = 0.1,
                       saturation: float = 0.05, hue: float = 0.01
                       ) -> torch.Tensor:
    return apply_color_jitter(x, draw_jitter(
        gen, x.shape[0], x.device, brightness, contrast, saturation, hue))


def normalize_batch(x: torch.Tensor) -> torch.Tensor:
    """ToTensor + Normalize((.5,.5,.5), (.5,.5,.5)): uint8 -> [-1, 1]."""
    return x.float() / 127.5 - 1.0


def augment_view_apply(imgs_u8: torch.Tensor, flips: Flips,
                       jitter: Optional[Jitter],
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One view with given factors: u8 -> [0, 1] in ``dtype`` -> flips ->
    colour jitter (skipped when ``jitter`` is None) -> [-1, 1]."""
    x = apply_flips(imgs_u8.to(dtype) / 255.0, flips)
    if jitter is not None:
        x = apply_color_jitter(x, jitter)
    return x * 2.0 - 1.0


def augment_view(gen: Optional[torch.Generator], imgs_u8: torch.Tensor,
                 jitter: bool = True, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
    """One augmented view of imgs_u8 [B, H, W, 3] uint8."""
    b, dev = imgs_u8.shape[0], imgs_u8.device
    return augment_view_apply(imgs_u8, draw_flips(gen, b, dev),
                              draw_jitter(gen, b, dev) if jitter else None,
                              dtype)


def augment_views(gen: Optional[torch.Generator], views_u8: torch.Tensor,
                  jitter: bool = True, dtype: torch.dtype = torch.float32
                  ) -> torch.Tensor:
    """TransformTwice (``data_loaders_MT.py:263-270``): each of V
    host-cropped views augmented independently.
    views_u8 [B, V, H, W, 3] -> [B, V, H, W, 3] in ``dtype``."""
    return torch.stack([augment_view(gen, views_u8[:, i], jitter, dtype)
                        for i in range(views_u8.shape[1])], dim=1)
