"""Holistic graph knowledge distillation (HKD), in PyTorch.

Port of ``multimodal_learning_tpu/contrast/hkd.py`` (reference
``MIA 2022/distiller_zoo/GNN.py`` = S2 ``CL_utils/HKD_loss.py``).  Per
student step:

1. InfoNCE between the student and teacher embeddings and two momentum
   banks (``NCEAverage``, momentum 0.9): the positives are the *other
   side's* bank rows at the batch indices, the negatives the ``nce_k``
   sampled rows (``GNN.py:136-161``);
2. a kNN graph (k = 8) over the softmaxed logits (softmax-cosine distance,
   each node kept among its own nearest by a -1 diagonal, ``:20-49``), a
   TAGConv(k=1) smoothing of the embeddings, and a second InfoNCE of the
   smoothed features against 0.75-momentum-smoothed bank rows
   (``:163-193``);
3. the banks' momentum update (``:195``), after the optimizer step.

The reference builds the graph with dgl and scipy on the host every step.
A batch is 16 nodes, so here, as in the JAX package, the graph is a dense
[B, B] adjacency and TAGConv is two matrix products on the device.  Bank
reads take no gradient.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from ..models.common import init_linear_
from .crd import init_bank

KNN = 8
EPS = 1e-7


@dataclass
class HKDBank:
    memory_l: torch.Tensor    # [n_data, feat_dim] student side
    memory_ab: torch.Tensor   # teacher side


def init_hkd_bank(n_data: int, feat_dim: int,
                  generator: Optional[torch.Generator] = None,
                  device=None) -> HKDBank:
    """The CRD bank's law (:func:`contrast.crd.init_bank`): U(-stdv, stdv),
    stdv = 1/sqrt(feat_dim/3), drawn on the generator's device, then moved
    to ``device``."""
    bank = init_bank(n_data, feat_dim, generator, device)
    return HKDBank(bank.memory_v1, bank.memory_v2)


def _momentum_rows(memory: torch.Tensor, v: torch.Tensor, y: torch.Tensor,
                   momentum: float) -> torch.Tensor:
    rows = memory[y.long()] * momentum + v * (1 - momentum)
    return rows / rows.pow(2).sum(dim=1, keepdim=True).sqrt()


@torch.no_grad()
def hkd_bank_update(bank: HKDBank, f_es: torch.Tensor, f_et: torch.Tensor,
                    y: torch.Tensor) -> None:
    """Momentum 0.9 and renormalisation of rows ``y`` (unique within a
    batch) of both banks, in place, each from the bank before the update."""
    y = y.long()
    new_l = _momentum_rows(bank.memory_l, f_es.detach(), y, 0.9)
    new_ab = _momentum_rows(bank.memory_ab, f_et.detach(), y, 0.9)
    bank.memory_l.index_copy_(0, y, new_l)
    bank.memory_ab.index_copy_(0, y, new_ab)


@torch.no_grad()
def knn_adjacency(logits: torch.Tensor, k: int = KNN) -> torch.Tensor:
    """Dense kNN adjacency from softmax-cosine distances (``GNN.py:20-49``):
    ``A[dst, src] = 1`` when dst is one of src's k nearest (messages flow
    src -> dst).  The sort is stable, as ``jnp.argsort``'s, so tied
    distances (equal rows) pick the lower index first.  A batch smaller
    than ``k`` keeps all its nodes (the JAX function fails there: it
    repeats each source k times against n neighbour columns)."""
    n = logits.shape[0]
    soft = torch.softmax(logits, dim=1)
    w = torch.linalg.vector_norm(soft, dim=1, keepdim=True)
    cos = (soft @ soft.t()) / (w @ w.t()).clamp_min(EPS)
    eye = torch.eye(n, dtype=cos.dtype, device=cos.device)
    dist = (1.0 - cos) * (1 - eye) - eye
    idx = torch.argsort(dist, dim=1, stable=True)[:, :k]   # [src, dst]
    adj_t = torch.zeros_like(dist).scatter_(1, idx, 1.0)   # [src, dst]
    return adj_t.t().contiguous()


class TAGEncoder(nn.Module):
    """Dense TAGConv(k=1) and an L2 normalisation (``GNN.py:198-207``):
    ``h' = W0 h + W1 (D^-1/2 A D^-1/2 h)`` with ``D`` the IN-degree on both
    sides, as dgl's TAGConv applies one ``in_degrees() ** -0.5`` vector
    before and after the aggregation (not a symmetric normalisation).
    Linears ``w0``/``w1`` with the torch default initialisation."""

    def __init__(self, in_dim: int, feat_dim: int = 128,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w0 = init_linear_(nn.Linear(in_dim, feat_dim), False, generator)
        self.w1 = init_linear_(nn.Linear(in_dim, feat_dim), False, generator)

    def forward(self, adj: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        # rows of adj are destinations: adj.sum(1) is the in-degree
        norm = torch.rsqrt(adj.sum(dim=1, keepdim=True).clamp_min(1.0))
        out = self.w0(h) + self.w1(norm * (adj @ (norm * h)))
        return out / out.pow(2).sum(dim=1, keepdim=True).sqrt()


def nce_softmax_loss(scores: torch.Tensor) -> torch.Tensor:
    """InfoNCE with the positive in slot 0 (``NCESoftmaxLoss``)."""
    return -torch.log_softmax(scores, dim=1)[:, 0].mean()


def _scores(pos_s, pos_t, f_s, f_t, neg_s, neg_t, T):
    out_s = torch.cat([(pos_s * f_s).sum(dim=1, keepdim=True),
                       torch.einsum("bkd,bd->bk", neg_s, f_s)], dim=1) / T
    out_t = torch.cat([(pos_t * f_t).sum(dim=1, keepdim=True),
                       torch.einsum("bkd,bd->bk", neg_t, f_t)], dim=1) / T
    return out_s, out_t


def hkd_scores(bank: HKDBank, f_es: torch.Tensor, f_et: torch.Tensor,
               y: torch.Tensor, contrast_idx: torch.Tensor, T: float = 0.07
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Independent-sample InfoNCE logits (``GNN.py:141-159``): [B, 1 + K]
    each, the positive first."""
    y, cidx = y.long(), contrast_idx.long()
    with torch.no_grad():
        w_t, w_s = bank.memory_l[cidx], bank.memory_ab[cidx]   # [B, K, D]
        f_us, f_ut = bank.memory_l[y], bank.memory_ab[y]
    return _scores(f_ut, f_us, f_es, f_et, w_t, w_s, T)


def hkd_graph_scores(bank: HKDBank, f_gs: torch.Tensor, f_gt: torch.Tensor,
                     y: torch.Tensor, contrast_idx: torch.Tensor,
                     T: float = 0.07) -> Tuple[torch.Tensor, torch.Tensor]:
    """Graph-smoothed InfoNCE logits: the positives are 0.75-momentum
    smoothings of the bank rows (``get_smooth``, ``GNN.py:76-90,
    177-191``)."""
    y, cidx = y.long(), contrast_idx.long()
    with torch.no_grad():
        f_sgs = _momentum_rows(bank.memory_l, f_gs, y, 0.75)
        f_sgt = _momentum_rows(bank.memory_ab, f_gt, y, 0.75)
        w_t, w_s = bank.memory_l[cidx], bank.memory_ab[cidx]
    return _scores(f_sgt, f_sgs, f_gs, f_gt, w_t, w_s, T)
