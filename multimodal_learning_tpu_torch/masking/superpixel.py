"""Superpixel attention masking (CLAT stage-1 "comprehensive learning").

Port of ``multimodal_learning_tpu/masking/superpixel.py`` (reference
``MIA 2023/stage1_multi_modal_teacher/train_test_MT_SP_Masking.py:42-102``):
the input-gradient saliency of the fused NLL with respect to both
modalities, the mean gradient of each superpixel, and masks of the
top-``Path_K`` superpixels and the top-``Omic_K`` omic features.

Differences from the JAX function, none of them in the result:

- The gradient is taken with ``torch.autograd.grad`` with respect to the
  inputs only.  ``jax.grad(argnums=(0, 1))`` lets XLA drop the weight
  gradient of the Kronecker contraction; here the caller runs ``cost_fn``
  with parameters that do not require a gradient (``frozen_params``), so
  ``kron_matmul``'s backward runs its input-gradient kernel (B4) and skips
  the weight-gradient kernel (B3).
- The per-segment sums are a ``scatter_add_`` over the flattened segment
  ids, not the one-hot contraction: that form was made for the TPU's
  matrix unit, where a scatter serialises.  Sums and areas accumulate in
  fp32 whatever the activation dtype, as the JAX comment on bf16 areas
  asks.  Ids outside ``[0, num_superpixels)`` count in no segment and are
  never masked, as ``jax.nn.one_hot`` drops them.
- ``jax.lax.top_k`` puts the lower index first among equal values, and
  ``torch.topk`` promises no order, so the top segments come from a stable
  descending sort.  Ties are common: ids that SLIC leaves empty all have
  mean 0.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Tuple

import torch
from torch import nn


@contextlib.contextmanager
def frozen_params(module: nn.Module) -> Iterator[nn.Module]:
    """Run ``module`` with none of its parameters requiring a gradient;
    each parameter's ``requires_grad`` is restored on exit."""
    params = list(module.parameters())
    before = [p.requires_grad for p in params]
    try:
        for p in params:
            p.requires_grad_(False)
        yield module
    finally:
        for p, flag in zip(params, before):
            p.requires_grad_(flag)


def saliency_grads(
    cost_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_path: torch.Tensor, x_omic: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradients of ``cost_fn(x_path, x_omic)`` with respect to its two
    inputs only (``jax.grad(cost_fn, argnums=(0, 1))``), computed on
    detached copies: no gradient reaches the inputs' own graph."""
    xp = x_path.detach().requires_grad_()
    xo = x_omic.detach().requires_grad_()
    g_path, g_omic = torch.autograd.grad(cost_fn(xp, xo), (xp, xo))
    return g_path, g_omic


def superpixel_attention_mask(
    cost_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x_path: torch.Tensor, x_omic: torch.Tensor, sp_mask: torch.Tensor,
    num_superpixels: int, path_k: int, omic_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (path_mask [B, H, W], omic_mask [B, D]), float32 in {0, 1}.

    ``cost_fn(x_path, x_omic)`` is the scalar fused NLL of the model in eval
    mode (the reference flips the model to ``.eval()`` for this pass, :62).
    It must run the model with parameters that do not require a gradient,
    for example inside ``with frozen_params(model):``; otherwise autograd
    also computes every parameter's gradient, which nothing reads.
    ``x_path`` is [B, H, W, C] and ``sp_mask`` [B, H, W] integer segment
    ids.  Neither input is modified and no gradient flows to them.
    """
    g_path, g_omic = saliency_grads(cost_fn, x_path, x_omic)

    B, H, W = sp_mask.shape
    g_sum = g_path.sum(-1).reshape(B, -1).float()          # [B, HW]
    seg = sp_mask.reshape(B, -1).long()
    valid = (seg >= 0) & (seg < num_superpixels)
    seg = seg.where(valid, 0)
    zeros = g_sum.new_zeros(B, num_superpixels)
    sums = zeros.scatter_add(1, seg, g_sum.where(valid, 0.0))
    area = zeros.scatter_add(1, seg, valid.float())
    seg_mean = sums / (area + 1e-9)                        # [B, N]
    top_ids = torch.sort(seg_mean, dim=1, descending=True,
                         stable=True).indices[:, :path_k]
    chosen = torch.zeros_like(seg_mean, dtype=torch.bool).scatter_(
        1, top_ids, True)
    path_mask = (chosen.gather(1, seg) & valid).reshape(B, H, W).float()

    # omic: features with grad >= k-th largest (:97), ties included
    kth = torch.topk(g_omic, omic_k, dim=1).values[:, -1:]
    omic_mask = (g_omic >= kth).float()
    return path_mask, omic_mask
