"""Kronecker-fusion contraction: the CUDA kernel's wrapper and its plain
version.

The pofusion step ``encoder1(vec(o1 o2^T))`` (reference ``fusion.py:58-60``)
pushes a per-sample outer product, flattened to (d1+1)(d2+1) = 129^2 = 16641
floats at the paper width, through a Linear.  In eval the kernel
(``csrc/kron_fusion.cu``, replacing the JAX package's Pallas ``_fwd_kernel``)
computes the factored contraction

    y[b, k] = sum_i o1[b, i] * sum_j o2[b, j] * W[k, i*d2 + j] + bias[k]

reading the ``encoder1`` Linear weight W in place, in its torch layout
[K, d1*d2]; the Kronecker vector never reaches device memory.

``kron_matmul`` launches the kernel for CUDA tensors and takes the plain
version only for CPU tensors; anything else raises.  The backward kernels
and the masked-dropout train kernel of the JAX package are not ported yet,
so CUDA inputs that would build a graph are refused.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build


def kron_matmul_plain(o1: torch.Tensor, o2: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the CPU path and the test
    oracle): the JAX tests' ``einsum("bi,bj,jik->bk") + b`` with
    W[j, i, k] = weight[k, i*d2 + j]."""
    k, d1, d2 = weight.shape[0], o1.shape[1], o2.shape[1]
    return torch.einsum("bi,bj,kij->bk", o1, o2,
                        weight.view(k, d1, d2)) + bias


def _lib():
    lib = _build.load("kron_fusion")
    if lib.kron_fwd.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kron_fwd.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.kron_fwd.restype = ctypes.c_int
        lib.kron_error_string.argtypes = [ctypes.c_int]
        lib.kron_error_string.restype = ctypes.c_char_p
    return lib


def _check(o1, o2, weight, bias):
    tensors = {"o1": o1, "o2": o2, "weight": weight, "bias": bias}
    for name, t in tensors.items():
        if t.device != o1.device:
            raise ValueError(f"kron_matmul: {name} is on {t.device}, o1 on "
                             f"{o1.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"kron_matmul: {name} is {t.dtype}, the kernel "
                            "takes float32")
        if not t.is_contiguous():
            raise ValueError(f"kron_matmul: {name} is not contiguous")
    if o1.dim() != 2 or o2.dim() != 2 or weight.dim() != 2 or bias.dim() != 1:
        raise ValueError("kron_matmul: want o1 [B, d1], o2 [B, d2], "
                         "weight [K, d1*d2], bias [K]")
    (b, d1), (b2, d2), k = o1.shape, o2.shape, weight.shape[0]
    if b2 != b or weight.shape[1] != d1 * d2 or bias.shape[0] != k:
        raise ValueError(
            f"kron_matmul: shapes o1 {tuple(o1.shape)}, o2 {tuple(o2.shape)}, "
            f"weight {tuple(weight.shape)}, bias {tuple(bias.shape)} do not "
            "fit [B, d1], [B, d2], [K, d1*d2], [K]")
    if max(b, d1, d2, k) >= 2 ** 31:
        raise ValueError("kron_matmul: a dimension exceeds int32")


def kron_matmul(o1: torch.Tensor, o2: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """y[b] = vec(o1[b] o2[b]^T) @ weight.T + bias, the Kronecker vector
    never materialised.  ``weight`` is the torch Linear weight
    [K, d1*d2], row-major over (i, j).  Any B, d1, d2, K."""
    if all(t.device.type == "cpu" for t in (o1, o2, weight, bias)):
        return kron_matmul_plain(o1, o2, weight, bias)
    if o1.device.type != "cuda":
        raise ValueError(f"kron_matmul: no kernel for device {o1.device}")
    _check(o1, o2, weight, bias)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (o1, o2, weight, bias)):
        raise NotImplementedError(
            "kron_matmul: the backward kernels (the JAX package's "
            "_bwd_dw_kernel and _bwd_dvec_kernel) are not ported yet; call "
            "it under torch.no_grad() or torch.inference_mode()")
    b, d1 = o1.shape
    d2, k = o2.shape[1], weight.shape[0]
    y = torch.empty((b, k), device=o1.device, dtype=torch.float32)
    if b == 0 or k == 0:
        return y
    lib = _lib()
    with torch.cuda.device(o1.device):
        err = lib.kron_fwd(o1.data_ptr(), o2.data_ptr(), weight.data_ptr(),
                           bias.data_ptr(), y.data_ptr(), b, d1, d2, k,
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError("kron_matmul: kernel launch failed: "
                           + lib.kron_error_string(err).decode())
    kron_matmul.launches += 1
    return y


# Launches of the kernel since the count was last set to 0.
kron_matmul.launches = 0
