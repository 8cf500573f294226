"""The 14 KD-baseline losses ("distiller zoo"), in PyTorch.

Port of ``multimodal_learning_tpu/losses/distiller_zoo.py`` (reference
``MIA 2022/distiller_zoo/``): DistillKL (``kd.distill_kl``), feats_KL,
HintLoss (FitNet), Attention (AT), Similarity (SP, ``kd.sp_loss``),
Correlation (CC), VID, RKD, PKT, AB, FactorTransfer (FT), KDSVD, FSP, NST.
The student step wires the losses on the 1-D feature vectors
(``feats_kl``, ``hint_loss``, ``correlation_loss``, ``rkd_loss``,
``pkt_loss``, ``sp_loss``); the rest are library-level, as in the JAX
package.

**Layout.** The map-based losses (AT, FT on maps, KDSVD, FSP, NST) take
NCHW feature maps [B, C, H, W], as the port's trunk emits them; the JAX
functions take NHWC.  Every spatial flattening here runs over (H, W) in
the same row-major order, so a map transposed NHWC -> NCHW gives the same
loss.

Teacher inputs are expected detached by the caller, as the reference's
``.detach()`` call sites do; where the JAX function stops a gradient
itself (RKD's teacher distances and angles, KDSVD's teacher basis and
RBF, NST's teacher maps), so does the port.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..models.common import torch_linear_default_

EPS = 1e-7


def feats_kl(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """KL between softmaxed feature vectors (``feats_KL.py:12-20``), with
    ``0 log 0 = 0``."""
    log_p_s = torch.log_softmax(f_s, dim=1)
    p_t = torch.softmax(f_t, dim=1)
    safe_log = torch.where(p_t > 0, torch.log(p_t.clamp_min(1e-38)),
                           torch.zeros_like(p_t))
    return (p_t * (safe_log - log_p_s)).sum() / f_s.shape[0]


def hint_loss(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """FitNet hint: plain MSE (``FitNet.py``)."""
    return ((f_s - f_t) ** 2).mean()


def _l2_rows(a: torch.Tensor) -> torch.Tensor:
    return a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(
        1e-12)


def attention_loss(g_s: Sequence[torch.Tensor], g_t: Sequence[torch.Tensor],
                   p: int = 2) -> List[torch.Tensor]:
    """AT (``AT.py``): the L2 distance of the l2-normalised spatial
    attention maps ``mean_c |A|^p``, one per layer pair.  Maps NCHW."""

    def at(f):
        return _l2_rows(f.abs().pow(p).mean(dim=1).reshape(f.shape[0], -1))

    return [((at(s) - at(t)) ** 2).mean() for s, t in zip(g_s, g_t)]


def correlation_loss(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """CC (``CC.py:14-17``, the version the reference runs): ``delta =
    |f_s - f_t|``, then the mean over consecutive rows of
    ``dot(delta[i], delta[i + 1])``."""
    delta = (f_s - f_t).abs()
    return (delta[:-1] * delta[1:]).sum(dim=1).mean()


class VIDHead(nn.Module):
    """Variational Information Distillation regressor (``VID.py:18-54``):
    predicts the teacher feature's mean from the student feature through
    three bias-free Linears (the reference's 1x1 convolutions on a vector),
    with a learned per-channel variance ``softplus(log_scale) + eps``;
    ``init_pred_var`` 5.0 and ``eps`` 1e-5 as ``VID.py:17``.  Parameters
    are named as the reference's (``regressor.{0,2,4}``, ``log_scale``)."""

    def __init__(self, in_dim: int, out_dim: int, mid_dim: int = 128,
                 init_pred_var: float = 5.0, eps: float = 1e-5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()

        def linear(i, o):
            layer = nn.Linear(i, o, bias=False)
            torch_linear_default_(layer.weight, generator)
            return layer

        self.regressor = nn.Sequential(
            linear(in_dim, mid_dim), nn.ReLU(), linear(mid_dim, mid_dim),
            nn.ReLU(), linear(mid_dim, out_dim))
        self.eps = eps
        init_alpha = math.log(math.exp(init_pred_var - eps) - 1.0)
        self.log_scale = nn.Parameter(torch.full((out_dim,), init_alpha))

    def forward(self, f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
        mean = self.regressor(f_s)
        var = torch.log1p(torch.exp(self.log_scale)) + self.eps
        return (0.5 * (torch.log(var) + (f_t - mean) ** 2 / var)).mean()


def _smooth_l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    d = (x - y).abs()
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean()


def _pdist(e: torch.Tensor) -> torch.Tensor:
    """Pairwise distances with a zero diagonal.  The square root is taken
    of a guarded argument (1 where ``d2 <= 1e-12``): the raw square root's
    gradient at a zero distance is unbounded, and ``torch.where`` over it
    would still carry a NaN back."""
    sq = (e ** 2).sum(dim=1)
    d2 = sq[:, None] + sq[None, :] - 2 * (e @ e.t())
    off = 1.0 - torch.eye(e.shape[0], dtype=e.dtype, device=e.device)
    pos = d2 > 1e-12
    safe = torch.sqrt(torch.where(pos, d2, torch.ones_like(d2)))
    return torch.where(pos, safe, torch.zeros_like(d2)) * off


def _angles(e: torch.Tensor) -> torch.Tensor:
    """Cosines of the angle at each anchor i between every pair (j, k), as
    one vector; the reciprocal square root is guarded as in :func:`_pdist`."""
    diff = e[None, :, :] - e[:, None, :]
    n2 = (diff ** 2).sum(dim=2, keepdim=True)
    pos = n2 > 1e-12
    nd = diff * torch.rsqrt(torch.where(pos, n2, torch.ones_like(n2)))
    nd = torch.where(pos, nd, torch.zeros_like(nd))
    return torch.bmm(nd, nd.transpose(1, 2)).reshape(-1)


def rkd_loss(f_s: torch.Tensor, f_t: torch.Tensor, w_d: float = 25.0,
             w_a: float = 50.0) -> torch.Tensor:
    """Relational KD (``RKD.py:8-58``): distance-wise and angle-wise Huber
    losses; the teacher's distances and angles take no gradient."""
    n_off = f_t.shape[0] * (f_t.shape[0] - 1)
    t_d = _pdist(f_t).detach()
    t_d = t_d / (t_d.sum() / n_off).clamp_min(1e-12)
    s_d = _pdist(f_s)
    s_d = s_d / (s_d.sum() / n_off).clamp_min(1e-12)
    loss_d = _smooth_l1(s_d, t_d)
    loss_a = _smooth_l1(_angles(f_s), _angles(f_t).detach())
    return w_d * loss_d + w_a * loss_a


def pkt_loss(f_s: torch.Tensor, f_t: torch.Tensor,
             eps: float = 1e-7) -> torch.Tensor:
    """Probabilistic Knowledge Transfer (``PKT.py:17-43``): KL between the
    cosine-similarity distributions, ``eps`` inside the norm and the log."""

    def prob(f):
        f = f / (torch.linalg.vector_norm(f, dim=1, keepdim=True) + eps)
        sim = (f @ f.t() + 1.0) / 2.0
        return sim / sim.sum(dim=1, keepdim=True)

    p_s, p_t = prob(f_s), prob(f_t)
    return (p_t * torch.log((p_t + eps) / (p_s + eps))).mean()


def ab_loss(f_s: torch.Tensor, f_t: torch.Tensor,
            margin: float = 1.0) -> torch.Tensor:
    """Activation Boundaries (``AB.py:16-31``): the hinge on pre-activation
    sign agreement, ``sum / bsz / 1000 * 3``; any layout.  The reference's
    per-layer weights ``2^(i-n+1)`` are the caller's."""
    loss = ((f_s + margin) ** 2 * ((f_s > -margin) & (f_t <= 0))
            + (f_s - margin) ** 2 * ((f_s <= margin) & (f_t > 0)))
    return loss.reshape(f_s.shape[0], -1).sum(dim=1).mean() / 1000.0 * 3.0


def factor_transfer_loss(factor_s: torch.Tensor, factor_t: torch.Tensor,
                         p1: int = 2, p2: int = 1) -> torch.Tensor:
    """FT (``FT.py:14-31``): Lp2 between l2-normalised factors.  A 4-D NCHW
    map gets the reference's factor ``mean_c(f^p1)`` first; a 2-D factor is
    used as it is."""

    def factor(f):
        if f.dim() == 4:
            f = f.pow(p1).mean(dim=1)
        return _l2_rows(f.reshape(f.shape[0], -1))

    d = factor(factor_s) - factor(factor_t)
    if p2 == 1:
        return d.abs().mean()
    return d.pow(p2).mean()


def _finite(a: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(a), a, torch.zeros_like(a))


def _kdsvd_basis(f: torch.Tensor, n: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The truncated right-singular basis of the per-sample [HW, C]
    matrices of an NCHW map (``KDSVD.py:47-66``): v [B, C, n] and s [B, n],
    each l2-normalised along dim 1; non-finite entries zeroed.  The sign of
    each singular vector is LAPACK's, and not a contract."""
    b, c = f.shape[:2]
    x = f.reshape(b, c, -1).transpose(1, 2)             # [B, HW, C]
    _, s, vh = torch.linalg.svd(x, full_matrices=False)
    v = _finite(vh.transpose(-2, -1)[:, :, :n])
    s = _finite(s[:, :n])
    return _l2_rows(v), _l2_rows(s)


def _kdsvd_align(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``align_rsv`` (``KDSVD.py:68-75``): the signed column matching of the
    student basis ``a`` onto the teacher's ``b``."""
    cos = torch.einsum("bcm,bcn->bmn", a, b)
    is_max = cos.abs() == cos.abs().amax(dim=1, keepdim=True)
    mask = torch.where(is_max, torch.sign(cos), torch.zeros_like(cos))
    return torch.einsum("bcm,bmn->bcn", a, mask)


def kdsvd_loss(g_s: Sequence[torch.Tensor], g_t: Sequence[torch.Tensor],
               k: int = 1) -> List[torch.Tensor]:
    """KDSVD (``KDSVD.py:17-45``): the truncated right-singular bases of the
    flattened maps (NCHW), RBF-correlated across consecutive layer pairs.
    Student bases take ``k + 3`` columns, sign-aligned onto the teacher's
    ``k`` and scaled by the teacher's singular values; layer i > 0 gives
    the squared difference of the inter-layer RBF affinities, summed and
    divided by the batch size."""
    losses = []
    v_sb = v_tb = None
    for i, (f_s, f_t) in enumerate(zip(g_s, g_t)):
        v_t, s_t = _kdsvd_basis(f_t.detach(), k)
        v_s, _ = _kdsvd_basis(f_s, k + 3)
        v_s = _kdsvd_align(v_s, v_t)
        v_t = v_t * s_t[:, None, :]
        v_s = v_s * s_t[:, None, :]
        if i > 0:
            s_rbf = torch.exp(-(v_s[:, :, None, :] - v_sb[:, None, :, :]) ** 2
                              / 8.0)
            t_rbf = torch.exp(-(v_t[:, :, None, :] - v_tb[:, None, :, :]) ** 2
                              / 8.0)
            losses.append(_finite((s_rbf - t_rbf.detach()) ** 2).sum()
                          / g_s[0].shape[0])
        v_sb, v_tb = v_s, v_t
    return losses


def fsp_loss(g_s: Sequence[torch.Tensor],
             g_t: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """FSP (``FSP.py``): MSE between the Gram ("flow") matrices of
    consecutive layer pairs.  Maps NCHW; the spatial sizes of a pair must
    match (callers pool beforehand)."""

    def flow(a, b):
        am = a.reshape(a.shape[0], a.shape[1], -1)     # [B, C, HW]
        bm = b.reshape(b.shape[0], b.shape[1], -1)
        return am @ bm.transpose(1, 2) / am.shape[2]

    return [((flow(s1, s2) - flow(t1, t2)) ** 2).mean()
            for (s1, s2), (t1, t2) in zip(zip(g_s[:-1], g_s[1:]),
                                          zip(g_t[:-1], g_t[1:]))]


def nst_loss(f_s: torch.Tensor, f_t: torch.Tensor) -> torch.Tensor:
    """Neuron Selectivity Transfer (``NST.py``): the squared MMD with a
    polynomial kernel over l2-normalised spatial activations.  Maps NCHW."""

    def prep(f):
        f = f.reshape(f.shape[0], f.shape[1], -1)      # [B, C, HW]
        return f / torch.linalg.vector_norm(f, dim=2, keepdim=True
                                            ).clamp_min(1e-12)

    s, t = prep(f_s), prep(f_t).detach()

    def poly(a, b):
        return ((a @ b.transpose(1, 2)) ** 2).mean()

    return poly(s, s) + poly(t, t) - 2 * poly(s, t)
