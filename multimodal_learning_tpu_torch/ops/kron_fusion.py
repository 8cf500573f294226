"""Kronecker-fusion contraction: the CUDA kernels' wrappers, their autograd
functions and their plain versions.

The pofusion step ``encoder1(vec(o1 o2^T))`` (reference ``fusion.py:58-60``)
pushes a per-sample outer product, flattened to (d1+1)(d2+1) = 129^2 = 16641
floats at the paper width, through a Linear whose weight W is read in place,
in its torch layout [K, d1*d2].  Four kernels, each replacing a Pallas
kernel of ``multimodal_learning_tpu/ops/kron_fusion.py``:

- ``kron_matmul`` (``csrc/kron_fusion.cu:kron_fwd``, ``_fwd_kernel``): the eval
  contraction ``y[b, k] = sum_i o1[b, i] sum_j o2[b, j] W[k, i*d2 + j] +
  bias[k]``, launched through the registered op ``mml::kron_fwd`` (a CUDA
  kernel, a CPU kernel that runs the plain version, and a fake), so that a
  ``torch.export`` of the serving forward keeps B2; differentiable: its
  backward runs ``kron_bwd_dw``
  (``csrc/kron_bwd.cu``, ``_bwd_dw_kernel``) for the weight and
  ``kron_bwd_dvec`` (``_bwd_dvec_kernel``) for o1 and o2, as the JAX
  package's custom VJP does; ``db = g.sum(0)`` stays a torch op.
- ``kron_matmul_dropout`` (``csrc/kron_fusion.cu:kron_train_fwd``,
  ``_fwd_train_kernel``): the train contraction with the dropout mask
  ``maskf`` on the Kronecker vector, ``y = ((o1 (x) o2) * maskf) W^T +
  bias``.  Its backward is plain torch, as the JAX package's
  ``_kron_dropout_bwd`` is XLA and not Pallas.

The two forwards are one split-column GEMM kernel, with and without the
mask; ``kron_bwd_dvec`` streams W the same way (``csrc/kron_tma.cuh``).
Their per-block partial sums go to a scratch tensor cached per device and
stream (``_partials``), so a call allocates only its outputs.  The
masked teacher's saliency pass takes input gradients only, with the
parameters frozen, so ``kron_matmul``'s backward runs ``kron_bwd_dvec``
and skips ``kron_bwd_dw``, as XLA drops the unused weight gradient in the
JAX package.

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

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Each library's C functions: pointers and the stream as c_void_p (ctypes
# would cut a bare int to 32 bits), dimensions as c_int; each returns an int
# (a CUDA error, 0 for none) unless its result type is given.
_API = {
    "kron_fusion": {"kron_fwd": [_P] * 6 + [_I] * 4 + [_P],
                    "kron_train_fwd": [_P] * 7 + [_I] * 4 + [_P],
                    "kron_blocks": [_I, _I]},
    "kron_bwd": {"kron_bwd_dw": [_P] * 4 + [_I] * 4 + [_P],
                 "kron_bwd_dvec": [_P] * 7 + [_I] * 4 + [_P],
                 "kron_bwd_dvec_scratch": ([_I] * 3, _L)},
}
_ERROR_STRING = {"kron_fusion": "kron_error_string",
                 "kron_bwd": "kron_bwd_error_string"}
_typed = set()


def _lib(name: str):
    """The built library of ``csrc/<name>.cu`` with its ctypes signatures."""
    lib = _build.load(name)
    if name not in _typed:
        for fn, sig in _API[name].items():
            argtypes, restype = sig if isinstance(sig, tuple) else (sig, _I)
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
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


_scratch: dict = {}
_sizes: dict = {}


def _partials(device: torch.device, stream: int, numel: int
              ) -> torch.Tensor:
    """Scratch for the kernels' per-block partial sums (B1, B2 and B4):
    one tensor per device and stream, grown to the largest call and never
    shrunk, so a call allocates nothing for it.  Calls on one stream run in
    order, and each kernel's reduction pass has read the partials before
    the next kernel on the stream starts, so they may share it."""
    buf = _scratch.get((device, stream))
    if buf is None or buf.numel() < numel:
        buf = _scratch[device, stream] = torch.empty(
            numel, device=device, dtype=torch.float32)
    return buf


def _size(name: str, lib, what: str, fn: str, *args) -> int:
    """``lib.fn(*args)`` on the current device, a size that depends only
    on the device and the arguments, cached; a negative result is minus a
    CUDA error."""
    key = (torch.cuda.current_device(), fn, args)
    if key not in _sizes:
        size = getattr(lib, fn)(*args)
        _raise_on(name, lib, max(-size, 0), what)
        _sizes[key] = size
    return _sizes[key]


def _fwd_launch(o1, o2, weight, bias, maskf=None) -> torch.Tensor:
    """B2 (no mask) or B1 (``maskf``) on the card."""
    b, d1 = o1.shape
    d2, k = o2.shape[1], weight.shape[0]
    y = torch.empty((b, k), device=o1.device, dtype=torch.float32)
    if b == 0 or k == 0:
        return y
    if d1 * d2 == 0:
        return y.copy_(bias.expand(b, k))
    what = "kron_matmul" if maskf is None else "kron_matmul_dropout"
    # the kernel's tensor maps need W and the mask 16-byte aligned: a view
    # that is not is copied (PyTorch's own allocations always are)
    if weight.data_ptr() % 16:
        weight = weight.clone()
    if maskf is not None and maskf.data_ptr() % 16:
        maskf = maskf.clone()
    lib = _lib("kron_fusion")
    with torch.cuda.device(o1.device):
        blocks = _size("kron_fusion", lib, what, "kron_blocks", d1, d2)
        stream = _stream()
        part = _partials(o1.device, stream, blocks * b * k)
        ptrs = [o1.data_ptr(), o2.data_ptr(), weight.data_ptr(),
                bias.data_ptr()]
        if maskf is None:
            err = lib.kron_fwd(*ptrs, part.data_ptr(), y.data_ptr(), b, d1,
                               d2, k, stream)
        else:
            err = lib.kron_train_fwd(*ptrs, maskf.data_ptr(),
                                     part.data_ptr(), y.data_ptr(), b, d1,
                                     d2, k, stream)
    _raise_on("kron_fusion", lib, err, what)
    if maskf is None:
        kron_matmul.launches += 1
    else:
        kron_matmul_dropout.launches += 1
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
    if weight.data_ptr() % 16:   # the tensor maps need W 16-byte aligned
        weight = weight.clone()
    lib = _lib("kron_bwd")
    with torch.cuda.device(o1.device):
        stream = _stream()
        part = _partials(o1.device, stream, _size(
            "kron_bwd", lib, "kron_bwd_dvec", "kron_bwd_dvec_scratch", b, d1,
            d2))
        err = lib.kron_bwd_dvec(o1.data_ptr(), o2.data_ptr(),
                                weight.data_ptr(), g.data_ptr(),
                                part.data_ptr(), do1.data_ptr(),
                                do2.data_ptr(), b, d1, d2, k, stream)
    _raise_on("kron_bwd", lib, err, "kron_bwd_dvec")
    kron_bwd_dvec.launches += 1
    return do1, do2


@torch.library.custom_op("mml::kron_fwd", mutates_args=(),
                         device_types="cpu")
def kron_fwd_op(o1: torch.Tensor, o2: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """B2 as a registered op, so that ``torch.export`` captures the eval
    contraction, which it cannot trace into ctypes: on the CPU its plain
    version."""
    return kron_matmul_plain(o1, o2, weight, bias)


@kron_fwd_op.register_kernel("cuda")
def _kron_fwd_cuda(o1, o2, weight, bias):
    # checked here, on real tensors, and not in the wrapper, whose checks
    # would guard on the symbolic batch of a dynamic export; launches B2
    # and counts it (``_fwd_launch``); the output is a fresh tensor, never
    # the cached partials scratch
    _check("kron_matmul", {"o1": o1, "o2": o2, "weight": weight,
                           "bias": bias},
           _fits(o1, o2, weight, bias), "[B, d1], [B, d2], [K, d1*d2], [K]")
    return _fwd_launch(o1, o2, weight, bias)


@kron_fwd_op.register_fake
def _kron_fwd_fake(o1, o2, weight, bias):
    return o1.new_empty((o1.shape[0], weight.shape[0]))


class _KronMatmul(torch.autograd.Function):
    """``kron_matmul`` on CUDA: forward B2 (through the registered op
    ``mml::kron_fwd``), backward B3 (dW) and B4 (do1, do2), each run only
    where its inputs need a gradient."""

    @staticmethod
    def forward(ctx, o1, o2, weight, bias):
        ctx.save_for_backward(o1, o2, weight)
        return torch.ops.mml.kron_fwd(o1, o2, weight, bias)

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
    in all four inputs.  On CUDA the forward is ``mml::kron_fwd``; on the
    CPU too when no input needs a gradient (the plain version otherwise,
    differentiated by autograd)."""
    if _device_of("kron_matmul", o1, o2, weight, bias) == "cpu":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (o1, o2, weight, bias)):
            return kron_matmul_plain(o1, o2, weight, bias)
        # the op's CPU kernel is the same plain version; through the op, an
        # exported CPU graph keeps it whole
        return torch.ops.mml.kron_fwd(o1, o2, weight, bias)
    return _KronMatmul.apply(o1, o2, weight, bias)


class _KronMatmulDropout(torch.autograd.Function):
    """``kron_matmul_dropout`` on CUDA: forward B1; backward in torch ops,
    as ``_kron_dropout_bwd`` of the JAX package is XLA: with
    a = (o1 (x) o2) * maskf, dW = g^T a, and s = (g W) * maskf viewed
    [B, d1, d2] gives do1 = sum_j s o2 and do2 = sum_i s o1.  ``maskf``
    gets no gradient."""

    @staticmethod
    def forward(ctx, o1, o2, weight, bias, maskf):
        ctx.save_for_backward(o1, o2, weight, maskf)
        return _fwd_launch(o1, o2, weight, bias, maskf)

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
