"""Tensor singular value thresholding (t-SVT), the M3LR low-rank operator.

Port of ``multimodal_learning_tpu/lowrank/tsvt.py``.  The reference calls a
``TSVD_update_aux.update_aux(adj, Lambda/mu)`` that is missing from its
repository (``MIA 2022/train_test_tSVD.py:387,404``); the JAX package
reconstructs it from the t-SVD-MSC literature as the prox of the tensor
nuclear norm::

    aux = argmin_X  tau * ||X||_TNN + 1/2 ||X - adj||_F^2
        = ifft( SVT_tau( fft(adj, axis=-1) ) )

with the t-SVD-MSC rotation: the stacked [B, B, V] adjacency tensor is
rotated to [B, V, B], so the FFT runs along the sample axis and each of
the B frontal slices is a thin B x V matrix.  The slices go to one batched
complex64 ``torch.linalg.svd`` (cuSOLVER on the card; a library call, as
the JAX package's is XLA's, not a Pallas kernel).  The operator runs under
``no_grad`` on a detached adjacency, as the reference detaches before
``update_aux``; gradients reach the encoders only through the Frobenius
penalty of the train step.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch


def _svt_slices(slices: torch.Tensor, tau) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Batched complex SVT: slices [n, p, q] -> (thresholded, sum of the
    kept singular values)."""
    u, s, vh = torch.linalg.svd(slices, full_matrices=False)
    s_shrunk = torch.clamp(s - tau, min=0.0)
    out = (u * s_shrunk.to(u.dtype)[:, None, :]) @ vh
    return out, s_shrunk.sum()


@torch.no_grad()
def update_aux(adj: torch.Tensor, tau: Union[float, torch.Tensor],
               rotate: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """t-SVT prox of the stacked adjacency tensor ``adj`` [B, B, V] (views
    on dim 2, ``train_test_tSVD.py:385``) at threshold ``tau`` =
    Lambda_global / mu (``:387``), a number or a 0-d tensor on ``adj``'s
    device.  Returns (aux [B, B, V] float32, the tensor nuclear norm of
    the result)."""
    x = adj.detach().float()
    if rotate:
        x = x.permute(0, 2, 1)                     # [B, V, B]
    n3 = x.shape[-1]
    slices = torch.fft.fft(x, dim=-1).movedim(-1, 0)   # [n3, B, V]
    out, tnn = _svt_slices(slices, tau)
    x = torch.fft.ifft(out.movedim(0, -1), dim=-1).real
    if rotate:
        x = x.permute(0, 2, 1)
    return x.float().contiguous(), tnn / n3


@torch.no_grad()
def tensor_nuclear_norm(adj: torch.Tensor, rotate: bool = True
                        ) -> torch.Tensor:
    """TNN of the stacked tensor: the Fourier-domain singular values summed,
    over n3 (reference diagnostic, ``train_test_tSVD.py:91-96``)."""
    x = adj.detach().float()
    x = x.permute(0, 2, 1) if rotate else x
    n3 = x.shape[-1]
    s = torch.linalg.svdvals(torch.fft.fft(x, dim=-1).movedim(-1, 0))
    return s.sum() / n3
