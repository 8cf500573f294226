"""Plain PyTorch building blocks of the references, in fp32.

Written from the published models (MICCAI-2022 ``resnets.py``,
``networks_new.py``, ``fusion.py``; MIA-2023 stage 2) and the recipes'
semantics, as functions of a flat dict of named tensors that uses the
state_dict names of the system under test.  Nothing here imports the
system under test or any kernel.  Where the system draws random numbers
(augmentation factors, dropout and Kronecker masks), the reference draws
them again by the same calls, in the same order, from generators seeded
with the same seeds, so both sides see the same masks.

Every convolution, linear and bilinear layer passes its operands and its
output through ``q``: the identity for the reference; for the control
that stands for the next lower precision than the configuration's bf16,
fp8 with one scale per tensor, e4m3 forward and e5m2 for the gradients
flowing back.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.nn import functional as F

Params = Dict[str, torch.Tensor]
Quant = Callable[[torch.Tensor], torch.Tensor]

_FP8_MAX = 448.0         # the largest e4m3 value
_E5M2_MAX = 57344.0      # the largest e5m2 value


def fp32(x: torch.Tensor) -> torch.Tensor:
    return x


def _round(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    """x in ``dtype`` under one scale per tensor (its absolute maximum at
    the format's largest value), back in fp32."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _Fp8(torch.autograd.Function):
    """The usual fp8 training recipe: e4m3 forward, e5m2 gradients."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, _FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, _E5M2_MAX)



def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to fp8 on the way forward and its gradient on the way
    back, one scale per tensor."""
    return _Fp8.apply(x)


QUANTS = {"fp32": fp32, "fp8": fp8}


def no_tf32():
    """fp32 matmuls and convolutions in full fp32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def default_generator(device) -> torch.Generator:
    device = torch.device(device)
    if device.type == "cuda":
        idx = device.index if device.index is not None else \
            torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


@contextlib.contextmanager
def default_generator_as(gen: torch.Generator):
    """The device's default generator in ``gen``'s state for the block;
    afterwards ``gen`` takes the advanced state and the default its own
    back (how the frozen teacher's forward draws its dropout)."""
    default = default_generator(gen.device)
    saved = default.get_state()
    default.set_state(gen.get_state())
    try:
        yield
    finally:
        gen.set_state(default.get_state())
        default.set_state(saved)


# --- layers ---------------------------------------------------------------

def linear(q: Quant, x, w, b=None):
    return q(F.linear(q(x), q(w), b))


def conv(q: Quant, x, w, stride: int, pad: int):
    return q(F.conv2d(q(x), q(w), None, stride, pad))


def scale(x, w, b):
    """|x| |W|^T + |b|: the size of the terms a linear layer's output
    sums, the yardstick of its rounding error."""
    return x.abs() @ w.abs().t() + b.abs()


def batch_norm(P: Params, name: str, x, train: bool, eps: float = 1e-5):
    """Train mode normalises by the batch (biased variance); eval mode by
    the running statistics."""
    w, b = P[f"{name}.weight"], P[f"{name}.bias"]
    if train:
        return F.batch_norm(x, None, None, w, b, True, 0.0, eps)
    return F.batch_norm(x, P[f"{name}.running_mean"],
                        P[f"{name}.running_var"], w, b, False, 0.0, eps)


class Drops:
    """Where a forward's random draws come from: ``default``, the device's
    default generator (nn.Dropout's); ``kron``, the generator of the
    Kronecker mask; ``noise_dtype``, the dtype the encoders' dropout noise
    is drawn in (the configuration's compute dtype)."""

    def __init__(self, kron: Optional[torch.Generator],
                 noise_dtype: torch.dtype = torch.float32):
        self.kron = kron
        self.noise_dtype = noise_dtype


def dropout(x, p: float, train: bool):
    return F.dropout(x, p, True) if train and p > 0 else x


def alpha_dropout(x, p: float, train: bool, noise_dtype):
    """``nn.AlphaDropout`` with its noise drawn in ``noise_dtype``."""
    if not train or p == 0:
        return x
    alpha = 1.7580993408473766
    a = 1.0 / math.sqrt((alpha * alpha * p + 1) * (1 - p))
    noise = torch.empty(x.shape, dtype=noise_dtype,
                        device=x.device).bernoulli_(1 - p).float()
    b = (noise - 1) * (alpha * a) + alpha * a * p
    return x * (noise * a) + b


# --- models ---------------------------------------------------------------

class Out(NamedTuple):
    fuse_feat: Optional[torch.Tensor]
    path_feat: Optional[torch.Tensor]
    omic_feat: Optional[torch.Tensor]
    hazard_fuse: Optional[torch.Tensor]
    hazard_path: Optional[torch.Tensor]
    hazard_omic: Optional[torch.Tensor]
    pred_fuse: Optional[torch.Tensor]
    pred_path: Optional[torch.Tensor]
    pred_omic: Optional[torch.Tensor]


def resnet18(P: Params, p: str, x_nhwc, train: bool, q: Quant):
    """ResNet18 trunk with the grading heads (``fc_new1`` = Linear, BN,
    ReLU; ``fc_new2`` = Linear).  Returns (features, hazard, log-probs)."""
    x = x_nhwc.permute(0, 3, 1, 2)
    x = torch.relu(batch_norm(P, f"{p}bn1",
                              conv(q, x, P[f"{p}conv1.weight"], 2, 3), train))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage in range(1, 5):
        for block in range(2):
            b = f"{p}layer{stage}.{block}."
            stride = 2 if stage > 1 and block == 0 else 1
            identity = x
            if f"{b}downsample.0.weight" in P:
                identity = batch_norm(P, f"{b}downsample.1", conv(
                    q, x, P[f"{b}downsample.0.weight"], stride, 0), train)
            y = torch.relu(batch_norm(P, f"{b}bn1", conv(
                q, x, P[f"{b}conv1.weight"], stride, 1), train))
            y = batch_norm(P, f"{b}bn2",
                           conv(q, y, P[f"{b}conv2.weight"], 1, 1), train)
            x = torch.relu(y + identity)
    h = x.mean((2, 3))
    feat = torch.relu(batch_norm(P, f"{p}fc_new1.1", linear(
        q, h, P[f"{p}fc_new1.0.weight"], P[f"{p}fc_new1.0.bias"]), train))
    hazard = linear(q, feat, P[f"{p}fc_new2.weight"], P[f"{p}fc_new2.bias"])
    return feat, hazard, torch.log_softmax(hazard, dim=1)


def maxnet(P: Params, p: str, omic, train: bool, q: Quant, rate: float,
           drops: Drops):
    """MaxNet: four [Linear, ELU, AlphaDropout], a ReLU feature, a linear
    classifier."""
    h = omic
    for k in range(4):
        h = F.elu(linear(q, h, P[f"{p}encoder.{k}.0.weight"],
                         P[f"{p}encoder.{k}.0.bias"]))
        h = alpha_dropout(h, rate, train, drops.noise_dtype)
    feat = torch.relu(h)
    hazard = linear(q, feat, P[f"{p}classifier.0.weight"],
                    P[f"{p}classifier.0.bias"])
    return feat, hazard, torch.log_softmax(hazard, dim=1)


def _bilinear(q: Quant, x1, x2, w, b):
    outer = torch.einsum("bi,bj->bij", q(x1), q(x2))
    return q(torch.einsum("bij,kij->bk", outer, q(w)) + b)


def _append_one(o):
    return torch.cat([o, o.new_ones(o.shape[0], 1)], dim=1)


def pofusion(P: Params, p: str, v1, v2, train: bool, q: Quant, rate: float,
             drops: Drops):
    """The gated Kronecker fusion (MICCAI-2022 ``fusion.py:6-63``, skip
    off): two gated units, the Kronecker product of their outputs with a
    1 appended, its dropout, ``encoder1`` and ``encoder2``."""
    v1, v2 = torch.relu(v1), torch.relu(v2)

    def unit(i, own, pair):
        h = torch.relu(linear(q, own, P[f"{p}linear_h{i}.0.weight"],
                              P[f"{p}linear_h{i}.0.bias"]))
        z = _bilinear(q, *pair, P[f"{p}linear_z{i}.weight"],
                      P[f"{p}linear_z{i}.bias"])
        o = torch.relu(linear(q, torch.sigmoid(z) * h,
                              P[f"{p}linear_o{i}.0.weight"],
                              P[f"{p}linear_o{i}.0.bias"]))
        return dropout(o, rate, train)

    o1 = _append_one(unit(1, v1, (v1, v2)))
    o2 = _append_one(unit(2, v2, (v1, v2)))
    a = torch.einsum("bi,bj->bij", o1, o2).reshape(o1.shape[0], -1)
    if train and rate > 0:
        keep = 1.0 - rate
        mask = torch.bernoulli(torch.full(a.shape, keep, device=a.device),
                               generator=drops.kron) / keep
        a = a * mask
    y = linear(q, a, P[f"{p}encoder1.0.weight"], P[f"{p}encoder1.0.bias"])
    y = dropout(torch.relu(batch_norm(P, f"{p}encoder1.1", y, train)), rate,
                train)
    y = linear(q, y, P[f"{p}encoder2.0.weight"], P[f"{p}encoder2.0.bias"])
    return dropout(torch.relu(batch_norm(P, f"{p}encoder2.1", y, train)),
                   rate, train)


def pathomic(P: Params, p: str, x_path, omic, train: bool, q: Quant,
             rate: float, drops: Drops, cut_fuse_grad: bool) -> Out:
    """ResNet18 + MaxNet + pofusion + the fused classifier."""
    path_feat, hazard_path, pred_path = resnet18(P, f"{p}path_net.", x_path,
                                                 train, q)
    omic_feat, hazard_omic, pred_omic = maxnet(P, f"{p}omic_net.", omic,
                                               train, q, rate, drops)
    pv, ov = path_feat, omic_feat
    if cut_fuse_grad:
        pv, ov = pv.detach(), ov.detach()
    fuse = pofusion(P, f"{p}fusion.", pv, ov, train, q, rate, drops)
    hazard_fuse = linear(q, fuse, P[f"{p}classifier.0.weight"],
                         P[f"{p}classifier.0.bias"])
    return Out(fuse, path_feat, omic_feat, hazard_fuse, hazard_path,
               hazard_omic, torch.log_softmax(hazard_fuse, dim=1), pred_path,
               pred_omic)


# --- augmentation (flips, colour jitter, YIQ hue) ---------------------------

_GRAY = (0.299, 0.587, 0.114)
_RGB2YIQ = ((0.299, 0.587, 0.114), (0.596, -0.274, -0.322),
            (0.211, -0.523, 0.312))
_YIQ2RGB = ((1.0, 0.956, 0.621), (1.0, -0.272, -0.647),
            (1.0, -1.106, 1.703))


def _draws(gen, b, device):
    """Per sample: horizontal and vertical flips (p 0.5), then brightness,
    contrast, saturation factors in 1 +- (0.1, 0.1, 0.05) and a hue shift
    in +-0.01 turns, each drawn uniform in that order."""
    rand = lambda: torch.rand(b, generator=gen, device=device)
    flips = (rand() < 0.5, rand() < 0.5)
    jit = [rand() * (2 * w) + (c - w) for c, w in
           ((1.0, 0.1), (1.0, 0.1), (1.0, 0.05), (0.0, 0.01))]
    return flips, jit


def _augment(x_u8, flips, jit):
    dev = x_u8.device
    x = x_u8.float() / 255.0
    x = torch.where(flips[0][:, None, None, None], x.flip(2), x)
    x = torch.where(flips[1][:, None, None, None], x.flip(1), x)
    fb, fc, fs, hue = jit
    col = lambda t: t[:, None, None, None]
    w = torch.tensor(_GRAY, device=dev)
    gray = lambda y: (y * w).sum(-1, keepdim=True)
    y = (x * col(fb)).clamp(0, 1)
    mean = gray(y).mean(dim=(1, 2), keepdim=True)
    y = (y * col(fc) + mean * (1 - col(fc))).clamp(0, 1)
    y = (y * col(fs) + gray(y) * (1 - col(fs))).clamp(0, 1)
    theta = hue * 2 * math.pi
    c, s = torch.cos(theta), torch.sin(-theta)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([ones, zeros, zeros], -1),
                       torch.stack([zeros, c, -s], -1),
                       torch.stack([zeros, s, c], -1)], -2)
    m = torch.tensor(_YIQ2RGB, device=dev) @ rot @ torch.tensor(
        _RGB2YIQ, device=dev)
    y = torch.einsum("bij,bhwj->bhwi", m, y).clamp(0, 1)
    return y * 2.0 - 1.0


def augment_views(gen, views_u8):
    """Each view [B, V, H, W, 3] uint8 augmented independently, the draws
    of view 0 first -> V tensors [B, H, W, 3] in [-1, 1]."""
    b, v = views_u8.shape[:2]
    draws = [_draws(gen, b, views_u8.device) for _ in range(v)]
    return [_augment(views_u8[:, i], *draws[i]) for i in range(v)]


# --- losses and updates ------------------------------------------------------

def nll(logp, g):
    return -logp.gather(1, g.long()[:, None])[:, 0].mean()


def kl_terms(log_q, p):
    safe = torch.where(p > 0, torch.log(p.clamp_min(1e-38)),
                       torch.zeros_like(p))
    return p * safe - p * log_q


def pred_kd(pred_s, pred_t):
    """sum of KL(teacher || student) terms over the batch, / B."""
    return kl_terms(pred_s, torch.exp(pred_t)).sum() / pred_s.shape[0]


def l1(tensors):
    return sum(torch.where(t >= 0, t, -t).sum() for t in tensors)


def linear_lr(cfg: Dict, step: int, steps_per_epoch: int) -> float:
    """The recipes' ``linear`` policy."""
    epoch = step // steps_per_epoch
    over = max(0, epoch + cfg["epoch_count"] - cfg["niter"])
    return cfg["lr"] * (1.0 - over / float(cfg["niter_decay"] + 1))


class Adam:
    """``torch.optim.Adam`` with L2 decay added to the gradient, in
    plain tensor arithmetic; ``first_grads`` keeps the first update's
    gradient (with the decay) per name, ``first_raw`` the same without
    the decay."""

    def __init__(self, beta1: float, beta2: float, wd: float,
                 eps: float = 1e-8):
        self.b1, self.b2, self.wd, self.eps = beta1, beta2, wd, eps
        self.m: Params = {}
        self.v: Params = {}
        self.t = 0
        self.first_grads: Params = {}
        self.first_raw: Params = {}

    @torch.no_grad()
    def step(self, params: Params, grads: Dict[str, Optional[torch.Tensor]],
             lr: float) -> None:
        self.t += 1
        bc1 = 1 - self.b1 ** self.t
        bc2 = math.sqrt(1 - self.b2 ** self.t)
        for k, p in params.items():
            g = grads.get(k)
            g = torch.zeros_like(p) if g is None else g
            if self.t == 1:
                self.first_raw[k] = g.clone()
            g = g + self.wd * p
            if self.t == 1:
                self.first_grads[k] = g.clone()
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(lr / bc1 * m / (v.sqrt() / bc2 + self.eps))


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float, step: int):
    a = min(1.0 - 1.0 / (step + 1.0), decay)
    for k, p in params.items():
        ema[k].mul_(a).add_(p, alpha=1.0 - a)
