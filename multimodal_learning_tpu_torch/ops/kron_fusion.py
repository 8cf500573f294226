"""Kronecker-fusion contraction: the CUDA kernels' wrappers, their autograd
functions and their plain versions.

The pofusion step ``encoder1(vec(o1 o2^T))`` (reference ``fusion.py:58-60``)
pushes a per-sample outer product, flattened to (d1+1)(d2+1) = 129^2 = 16641
floats at the paper width, through a Linear whose weight W is read in place,
in its torch layout [K, d1*d2].  Four kernels, each replacing a Pallas
kernel of ``multimodal_learning_tpu/ops/kron_fusion.py``:

- ``kron_matmul`` (``csrc/kron_fusion.cu``, ``_fwd_kernel``): the eval
  contraction ``y[b, k] = sum_i o1[b, i] sum_j o2[b, j] W[k, i*d2 + j] +
  bias[k]``, differentiable: its backward runs ``kron_bwd_dw``
  (``csrc/kron_bwd.cu``, ``_bwd_dw_kernel``) for the weight and
  ``kron_bwd_dvec`` (``_bwd_dvec_kernel``) for o1 and o2, as the JAX
  package's custom VJP does; ``db = g.sum(0)`` stays a torch op.
- ``kron_matmul_dropout`` (``csrc/kron_train.cu``, ``_fwd_train_kernel``):
  the train contraction with the dropout mask ``maskf`` on the Kronecker
  vector, ``y = ((o1 (x) o2) * maskf) W^T + bias``.  Its backward is plain
  torch, as the JAX package's ``_kron_dropout_bwd`` is XLA and not Pallas.

Each wrapper launches its kernel for CUDA tensors and takes the plain
version only for CPU tensors; any other device raises.  Each counts its
launches in ``<wrapper>.launches``; a kernel made of a main pass and a
fixed-order reduction pass counts as one launch.
"""
from __future__ import annotations

import ctypes

import torch
from torch.nn import functional as F

from . import _build


def _kron_vec(o1: torch.Tensor, o2: torch.Tensor) -> torch.Tensor:
    """vec(o1[b] o2[b]^T), row-major over (i, j): [B, d1*d2]."""
    return (o1[:, :, None] * o2[:, None, :]).reshape(o1.shape[0], -1)


# ------------------------------------------------------------ plain versions

def kron_matmul_plain(o1: torch.Tensor, o2: torch.Tensor,
                      weight: torch.Tensor, bias: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of the eval kernel (the CPU path and the test
    oracle): the JAX tests' ``einsum("bi,bj,jik->bk") + b`` with
    W[j, i, k] = weight[k, i*d2 + j]."""
    k, d1, d2 = weight.shape[0], o1.shape[1], o2.shape[1]
    return torch.einsum("bi,bj,kij->bk", o1, o2,
                        weight.view(k, d1, d2)) + bias


def kron_bwd_dw_plain(o1: torch.Tensor, o2: torch.Tensor, g: torch.Tensor
                      ) -> torch.Tensor:
    """dW[k, i*d2 + j] = sum_b o1[b, i] o2[b, j] g[b, k]: [K, d1*d2]."""
    return g.t() @ _kron_vec(o1, o2)


def kron_bwd_dvec_plain(o1: torch.Tensor, o2: torch.Tensor,
                        weight: torch.Tensor, g: torch.Tensor):
    """(do1, do2) of the eval contraction: with T = W viewed [K, d1, d2],
    do1[b, i] = sum_kj g[b,k] T[k,i,j] o2[b,j] and
    do2[b, j] = sum_ki g[b,k] o1[b,i] T[k,i,j]."""
    d1, d2 = o1.shape[1], o2.shape[1]
    s = (g @ weight).view(-1, d1, d2)          # sum_k g[b,k] W[k,i,j]
    return (torch.einsum("bij,bj->bi", s, o2),
            torch.einsum("bij,bi->bj", s, o1))


def kron_matmul_dropout_plain(o1: torch.Tensor, o2: torch.Tensor,
                              weight: torch.Tensor, bias: torch.Tensor,
                              maskf: torch.Tensor) -> torch.Tensor:
    """Plain version of the train kernel: the masked Kronecker vector
    formed in memory and pushed through the Linear."""
    return F.linear(_kron_vec(o1, o2) * maskf, weight, bias)


# ------------------------------------------------------------------ kernels

_P, _I = ctypes.c_void_p, ctypes.c_int
# Each library's C functions: pointers and the stream as c_void_p (ctypes
# would cut a bare int to 32 bits), dimensions as c_int; all return int.
_API = {
    "kron_fusion": {"kron_fwd": [_P] * 5 + [_I] * 4 + [_P]},
    "kron_train": {"kron_train_fwd": [_P] * 7 + [_I] * 4 + [_P],
                   "kron_train_chunks": [_I, _I]},
    "kron_bwd": {"kron_bwd_dw": [_P] * 4 + [_I] * 4 + [_P],
                 "kron_bwd_dvec": [_P] * 7 + [_I] * 4 + [_P]},
}
_ERROR_STRING = {"kron_fusion": "kron_error_string",
                 "kron_train": "kron_train_error_string",
                 "kron_bwd": "kron_bwd_error_string"}
_typed = set()


def _lib(name: str):
    """The built library of ``csrc/<name>.cu`` with its ctypes signatures."""
    lib = _build.load(name)
    if name not in _typed:
        for fn, argtypes in _API[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        err_fn = getattr(lib, _ERROR_STRING[name])
        err_fn.argtypes, err_fn.restype = [_I], ctypes.c_char_p
        _typed.add(name)
    return lib


def _raise_on(name: str, lib, err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: kernel launch failed: "
                           + getattr(lib, _ERROR_STRING[name])(err).decode())


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(what: str, tensors: dict, shapes_ok: bool, want: str):
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{what}: {name} is on {t.device}, "
                             f"{next(iter(tensors))} on {first.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, the kernel takes "
                            "float32")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if not shapes_ok:
        raise ValueError(f"{what}: shapes " + ", ".join(
            f"{n} {tuple(t.shape)}" for n, t in tensors.items())
            + f" do not fit {want}")
    if max(max(t.shape) for t in tensors.values()) >= 2 ** 31:
        raise ValueError(f"{what}: a dimension exceeds int32")


def _fits(o1, o2, weight, bias=None, extra=None):
    ok = o1.dim() == 2 and o2.dim() == 2 and weight.dim() == 2 and \
        o1.shape[0] == o2.shape[0] and \
        weight.shape[1] == o1.shape[1] * o2.shape[1]
    if bias is not None:
        ok = ok and bias.dim() == 1 and bias.shape[0] == weight.shape[0]
    if extra is not None:
        ok = ok and extra
    return ok


def _device_of(what: str, *tensors) -> str:
    """"cpu" when every tensor lies on the CPU, "cuda" when the first does;
    anything else has no kernel."""
    if all(t.device.type == "cpu" for t in tensors):
        return "cpu"
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {tensors[0].device}")
    return "cuda"


def _fwd_launch(o1, o2, weight, bias) -> torch.Tensor:
    b, d1 = o1.shape
    d2, k = o2.shape[1], weight.shape[0]
    y = torch.empty((b, k), device=o1.device, dtype=torch.float32)
    if b == 0 or k == 0:
        return y
    lib = _lib("kron_fusion")
    with torch.cuda.device(o1.device):
        err = lib.kron_fwd(o1.data_ptr(), o2.data_ptr(), weight.data_ptr(),
                           bias.data_ptr(), y.data_ptr(), b, d1, d2, k,
                           _stream())
    _raise_on("kron_fusion", lib, err, "kron_matmul")
    kron_matmul.launches += 1
    return y


def kron_bwd_dw(o1: torch.Tensor, o2: torch.Tensor, g: torch.Tensor
                ) -> torch.Tensor:
    """Weight gradient of the eval contraction, [K, d1*d2] in the torch
    Linear layout (kernel B3)."""
    if _device_of("kron_bwd_dw", o1, o2, g) == "cpu":
        return kron_bwd_dw_plain(o1, o2, g)
    _check("kron_bwd_dw", {"o1": o1, "o2": o2, "g": g},
           o1.dim() == 2 and o2.dim() == 2 and g.dim() == 2
           and o1.shape[0] == o2.shape[0] == g.shape[0],
           "[B, d1], [B, d2], [B, K]")
    (b, d1), d2, k = o1.shape, o2.shape[1], g.shape[1]
    dw = torch.empty((k, d1 * d2), device=o1.device, dtype=torch.float32)
    if b == 0:
        return dw.zero_()
    if dw.numel() == 0:
        return dw
    lib = _lib("kron_bwd")
    with torch.cuda.device(o1.device):
        err = lib.kron_bwd_dw(o1.data_ptr(), o2.data_ptr(), g.data_ptr(),
                              dw.data_ptr(), b, d1, d2, k, _stream())
    _raise_on("kron_bwd", lib, err, "kron_bwd_dw")
    kron_bwd_dw.launches += 1
    return dw


def kron_bwd_dvec(o1: torch.Tensor, o2: torch.Tensor, weight: torch.Tensor,
                  g: torch.Tensor):
    """(do1, do2) of the eval contraction (kernel B4): reads W once."""
    if _device_of("kron_bwd_dvec", o1, o2, weight, g) == "cpu":
        return kron_bwd_dvec_plain(o1, o2, weight, g)
    _check("kron_bwd_dvec", {"o1": o1, "o2": o2, "weight": weight, "g": g},
           _fits(o1, o2, weight, extra=g.dim() == 2
                 and tuple(g.shape) == (o1.shape[0], weight.shape[0])),
           "[B, d1], [B, d2], [K, d1*d2], [B, K]")
    (b, d1), d2, k = o1.shape, o2.shape[1], weight.shape[0]
    do1 = torch.empty((b, d1), device=o1.device, dtype=torch.float32)
    do2 = torch.empty((b, d2), device=o1.device, dtype=torch.float32)
    if b == 0 or d1 + d2 == 0:
        return do1, do2
    if k == 0 or d1 * d2 == 0:
        return do1.zero_(), do2.zero_()
    s = torch.empty((b, d1 * d2), device=o1.device, dtype=torch.float32)
    lib = _lib("kron_bwd")
    with torch.cuda.device(o1.device):
        err = lib.kron_bwd_dvec(o1.data_ptr(), o2.data_ptr(),
                                weight.data_ptr(), g.data_ptr(),
                                s.data_ptr(), do1.data_ptr(),
                                do2.data_ptr(), b, d1, d2, k, _stream())
    _raise_on("kron_bwd", lib, err, "kron_bwd_dvec")
    kron_bwd_dvec.launches += 1
    return do1, do2


class _KronMatmul(torch.autograd.Function):
    """``kron_matmul`` on CUDA: forward B2, backward B3 (dW) and B4 (do1,
    do2), each run only where its inputs need a gradient."""

    @staticmethod
    def forward(ctx, o1, o2, weight, bias):
        ctx.save_for_backward(o1, o2, weight)
        return _fwd_launch(o1, o2, weight, bias)

    @staticmethod
    def backward(ctx, g):
        o1, o2, weight = ctx.saved_tensors
        g = g.contiguous()
        need = ctx.needs_input_grad
        do1 = do2 = dw = db = None
        if need[0] or need[1]:
            do1, do2 = kron_bwd_dvec(o1, o2, weight, g)
        if need[2]:
            dw = kron_bwd_dw(o1, o2, g)
        if need[3]:
            db = g.sum(0)
        return do1, do2, dw, db


def kron_matmul(o1: torch.Tensor, o2: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """y[b] = vec(o1[b] o2[b]^T) @ weight.T + bias, the Kronecker vector
    never materialised.  ``weight`` is the torch Linear weight
    [K, d1*d2], row-major over (i, j).  Any B, d1, d2, K.  Differentiable
    in all four inputs."""
    if _device_of("kron_matmul", o1, o2, weight, bias) == "cpu":
        return kron_matmul_plain(o1, o2, weight, bias)
    _check("kron_matmul", {"o1": o1, "o2": o2, "weight": weight,
                           "bias": bias},
           _fits(o1, o2, weight, bias), "[B, d1], [B, d2], [K, d1*d2], [K]")
    return _KronMatmul.apply(o1, o2, weight, bias)


def _train_launch(o1, o2, weight, bias, maskf) -> torch.Tensor:
    b, d1 = o1.shape
    d2, k = o2.shape[1], weight.shape[0]
    y = torch.empty((b, k), device=o1.device, dtype=torch.float32)
    if b == 0 or k == 0:
        return y
    if d1 * d2 == 0:
        return y.copy_(bias.expand(b, k))
    lib = _lib("kron_train")
    part = torch.empty((lib.kron_train_chunks(d1, d2), b, k),
                       device=o1.device, dtype=torch.float32)
    with torch.cuda.device(o1.device):
        err = lib.kron_train_fwd(o1.data_ptr(), o2.data_ptr(),
                                 weight.data_ptr(), bias.data_ptr(),
                                 maskf.data_ptr(), part.data_ptr(),
                                 y.data_ptr(), b, d1, d2, k, _stream())
    _raise_on("kron_train", lib, err, "kron_matmul_dropout")
    kron_matmul_dropout.launches += 1
    return y


class _KronMatmulDropout(torch.autograd.Function):
    """``kron_matmul_dropout`` on CUDA: forward B1; backward in torch ops,
    as ``_kron_dropout_bwd`` of the JAX package is XLA: with
    a = (o1 (x) o2) * maskf, dW = g^T a, and s = (g W) * maskf viewed
    [B, d1, d2] gives do1 = sum_j s o2 and do2 = sum_i s o1.  ``maskf``
    gets no gradient."""

    @staticmethod
    def forward(ctx, o1, o2, weight, bias, maskf):
        ctx.save_for_backward(o1, o2, weight, maskf)
        return _train_launch(o1, o2, weight, bias, maskf)

    @staticmethod
    def backward(ctx, g):
        o1, o2, weight, maskf = ctx.saved_tensors
        need = ctx.needs_input_grad
        d1, d2 = o1.shape[1], o2.shape[1]
        do1 = do2 = dw = db = None
        if need[2]:
            dw = g.t() @ (_kron_vec(o1, o2) * maskf)
        if need[0] or need[1]:
            s = ((g @ weight) * maskf).view(-1, d1, d2)
            do1 = torch.einsum("bij,bj->bi", s, o2)
            do2 = torch.einsum("bij,bi->bj", s, o1)
        if need[3]:
            db = g.sum(0)
        return do1, do2, dw, db, None


def kron_matmul_dropout(o1: torch.Tensor, o2: torch.Tensor,
                        weight: torch.Tensor, bias: torch.Tensor,
                        maskf: torch.Tensor) -> torch.Tensor:
    """y[b] = (vec(o1[b] o2[b]^T) * maskf[b]) @ weight.T + bias, the masked
    Kronecker vector never in device memory.  ``weight`` is the torch
    Linear weight [K, d1*d2]; ``maskf`` [B, d1*d2] is the dropout mask
    pre-scaled by 1/keep (ones for rate 0).  Differentiable in o1, o2,
    weight and bias."""
    if _device_of("kron_matmul_dropout", o1, o2, weight, bias,
                  maskf) == "cpu":
        return kron_matmul_dropout_plain(o1, o2, weight, bias, maskf)
    _check("kron_matmul_dropout", {"o1": o1, "o2": o2, "weight": weight,
                                   "bias": bias, "maskf": maskf},
           _fits(o1, o2, weight, bias, extra=tuple(maskf.shape) == (
               o1.shape[0], weight.shape[1])),
           "[B, d1], [B, d2], [K, d1*d2], [K], [B, d1*d2]")
    return _KronMatmulDropout.apply(o1, o2, weight, bias, maskf)


# Launches of each kernel since its count was last set to 0.
kron_matmul.launches = 0
kron_matmul_dropout.launches = 0
kron_bwd_dw.launches = 0
kron_bwd_dvec.launches = 0
