"""The ResNet18 stage-1 convolution under ``--paired_conv``: kernel B5, its
autograd function and its module.

The JAX package's ``--paired_conv True`` computes the 3x3, 64 -> 64,
stride-1, same-pad convolutions of the 64-channel stage through
``ops/paired_conv.py:paired_conv3x3``, a lane-paired reformulation for the
TPU's 128-lane MXU with a custom VJP, and prototyped the same shape as the
Pallas kernel ``tools/pallas_conv_proto.py:_kernel`` (B5).  The card has no
lanes to pair, so the port computes the same function with the same
parameters through its own CUDA kernel (``csrc/conv3x3.cu``):

- ``conv3x3(x, w, transposed=False)``: the kernel for CUDA tensors,
  through the registered op ``mml::conv3x3`` (a CUDA kernel that launches
  B5, a CPU kernel that runs the plain version ``conv3x3_plain``
  (``F.conv2d(x, w, padding=1)``) and makes it channels-last, and a fake
  that gives the shape and the channels-last strides), so that
  ``torch.export`` captures the call, which it cannot trace into ctypes.
  ``transposed`` convolves with ``w`` flipped in (ky, kx) and its in and
  out channels swapped, read in place by the kernel.  ``x``
  is NCHW-shaped with channels-last strides, the memory the port's trunk
  holds (an NHWC tensor), handed to the kernel as NHWC without a copy; the
  result is channels-last too.  bf16 or fp32, any B, H, W, 64 channels in
  and out.  Launches are counted in ``conv3x3.launches``.
- ``paired_conv3x3(x, w)``: differentiable, as ``_pc3_fwd``/``_pc3_bwd``
  are: the forward is ``conv3x3``; the data gradient is ``conv3x3`` again
  on the incoming gradient with ``transposed=True``; the weight gradient is
  ``torch.nn.grad.conv2d_weight`` in the activations' dtype, as the JAX
  weight gradient (``_wgrad3``) is XLA and not Pallas.  An incoming
  gradient that is not channels-last is made so, and counted in
  ``paired_conv3x3.grad_copies``.
- ``PairedConv3x3``: a drop-in for the block's ``nn.Conv2d(64, 64, 3,
  padding=1, bias=False)`` with the same ``weight`` (hence the same
  ``state_dict`` key) and init.

The JAX package also pairs the 7x7 stem (``paired_stem_conv``); no Pallas
kernel stands behind that, and the port keeps the ordinary stem
convolution, which is the same function.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from . import _build

CHANNELS = 64
_typed = False


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  transposed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the oracle)."""
    if transposed:
        w = w.flip(2, 3).transpose(0, 1)
    return F.conv2d(x, w, padding=1)


def _lib():
    global _typed
    lib = _build.load("conv3x3")
    if not _typed:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.conv3x3_fwd.argtypes = [p, p, p, i, i, i, i, i, p]
        lib.conv3x3_fwd.restype = ctypes.c_int
        lib.conv3x3_error_string.argtypes = [i]
        lib.conv3x3_error_string.restype = ctypes.c_char_p
        _typed = True
    return lib


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if w.device != x.device:
        raise ValueError(f"conv3x3: w is on {w.device}, x on {x.device}")
    if x.dtype not in (torch.bfloat16, torch.float32) or w.dtype != x.dtype:
        raise TypeError(f"conv3x3: x is {x.dtype} and w {w.dtype}; the "
                        "kernel takes both bfloat16 or both float32")
    if x.dim() != 4 or x.shape[1] != CHANNELS or tuple(w.shape) != (
            CHANNELS, CHANNELS, 3, 3):
        raise ValueError(f"conv3x3: shapes x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} do not fit [B, 64, H, W], "
                         "[64, 64, 3, 3]")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("conv3x3: x is not channels-last contiguous")
    if not w.is_contiguous():
        raise ValueError("conv3x3: w is not contiguous")


@torch.library.custom_op("mml::conv3x3", mutates_args=(), device_types="cpu")
def conv3x3_op(x: torch.Tensor, w: torch.Tensor,
               transposed: bool) -> torch.Tensor:
    """B5 as a registered op, so that ``torch.export`` captures it: on the
    CPU its plain version, made channels-last as the kernel's output is."""
    return conv3x3_plain(x, w, transposed).contiguous(
        memory_format=torch.channels_last)


@conv3x3_op.register_kernel("cuda")
def _conv3x3_cuda(x, w, transposed):
    """Check, then launch B5 on the caller's stream; the only place its
    launches are counted.  The checks run here, on real tensors, so that a
    dynamic export does not guard on the symbolic batch."""
    _check(x, w)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("conv3x3: x and w must be 16-byte aligned")
    b, _, h, wd = x.shape
    y = torch.empty_like(x, memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.conv3x3_fwd(x.data_ptr(), w.data_ptr(), y.data_ptr(), b, h,
                              wd, int(x.dtype == torch.bfloat16),
                              int(transposed),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("conv3x3: kernel launch failed: "
                           + lib.conv3x3_error_string(err).decode())
    conv3x3.launches += 1
    return y


@conv3x3_op.register_fake
def _conv3x3_fake(x, w, transposed):
    return torch.empty_like(x, memory_format=torch.channels_last)


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            transposed: bool = False) -> torch.Tensor:
    """Same-pad 3x3 stride-1 convolution, 64 -> 64 channels, through the
    registered op ``mml::conv3x3``: kernel B5 on CUDA, the plain version
    (made channels-last) on the CPU.  ``x`` [B, 64, H, W] channels-last,
    ``w`` [64, 64, 3, 3]; returns [B, 64, H, W] channels-last in x's
    dtype.  ``transposed``: convolve with ``w.flip(2, 3).transpose(0, 1)``
    (the data gradient) without forming it."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3: no kernel for device {x.device}")
    return torch.ops.mml.conv3x3(x, w, transposed)


class _PairedConv3x3(torch.autograd.Function):
    """``paired_conv3x3``: the forward and the data gradient through
    ``conv3x3``, the weight gradient through ``conv2d_weight``.  Autocast
    is off inside: the caller casts both inputs to the compute dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        with torch.autocast(x.device.type, enabled=False):
            return conv3x3(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        with torch.autocast(x.device.type, enabled=False):
            if not g.is_contiguous(memory_format=torch.channels_last):
                g = g.contiguous(memory_format=torch.channels_last)
                paired_conv3x3.grad_copies += 1
            if ctx.needs_input_grad[0]:
                dx = conv3x3(g, w, transposed=True)
            if ctx.needs_input_grad[1]:
                dw = torch.nn.grad.conv2d_weight(x, w.shape, g, padding=1)
        return dx, dw


def paired_conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable ``conv3x3`` (``multimodal_learning_tpu/ops/
    paired_conv.py:paired_conv3x3`` with its custom VJP)."""
    return _PairedConv3x3.apply(x, w)


class PairedConv3x3(nn.Module):
    """The stage-1 3x3 convolution under ``--paired_conv``: parameter
    ``weight`` [64, 64, 3, 3] with kaiming-normal fan-out init, as the
    ``nn.Conv2d`` it replaces.  Computes in ``dtype`` (the input and the
    weight are cast to it, as the JAX module does); the weight gradient
    reaches the fp32 parameter rounded to ``dtype``.  An input of odd width
    takes the ordinary convolution: the JAX package pairs only an even
    width (``models/resnet.py:99``)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(CHANNELS, CHANNELS, 3, 3))
        with torch.no_grad():
            self.weight.normal_(0.0, math.sqrt(2.0 / (CHANNELS * 9)),
                                generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[3] % 2:
            return F.conv2d(x, self.weight, padding=1)
        return paired_conv3x3(x.to(self.dtype), self.weight.to(self.dtype))


# Launches of the kernel, and layout copies of incoming gradients, since
# each count was last set to 0.
conv3x3.launches = 0
paired_conv3x3.grad_copies = 0
