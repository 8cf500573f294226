"""Task losses: grading NLL, Cox partial likelihood, L1 regularisation.

Port of ``multimodal_learning_tpu/losses/task.py`` (reference
``train_test_MT.py:212-215``, ``CoxLoss`` ``MICCAI-2022/utils.py:361-376``,
``regularize_*`` ``utils.py:60-198``).  The Cox loss keeps the JAX
package's broadcast risk matrix and log-sum-exp form.
"""
from __future__ import annotations

import torch
from torch import nn


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``F.nll_loss``: mean negative log-likelihood of already
    log-softmaxed predictions."""
    return -log_probs.gather(1, labels.long()[:, None])[:, 0].mean()


def cox_loss(survtime: torch.Tensor, censor: torch.Tensor,
             hazard_pred: torch.Tensor) -> torch.Tensor:
    """Cox partial likelihood with the at-risk set
    ``R[i, j] = survtime[j] >= survtime[i]``:
    ``-mean((theta_i - log sum_j exp(theta_j) R_ij) * censor_i)``."""
    theta = hazard_pred.reshape(-1)
    risk = survtime[None, :] >= survtime[:, None]
    masked = torch.where(risk, theta[None, :],
                         torch.full_like(theta, float("-inf"))[None, :])
    return -((theta - torch.logsumexp(masked, dim=1)) * censor).mean()


_SUBTREES = {"omic": ("omic_net",),
             "mm": ("omic_net", "fusion", "classifier"),
             "path": ("classifier",)}


def l1_regularizer(model: nn.Module, reg_type: str = "all") -> torch.Tensor:
    """L1 penalty over parameter subsets of ``model`` (``define_reg``,
    ``networks_new.py:93-108``):

    - ``none``: 0
    - ``all``:  every parameter
    - ``omic``: the ``omic_net`` submodule (``regularize_MM_omic``)
    - ``mm``:   omic_net + fusion + classifier (``regularize_MM_weights``)
    - ``path``: the ``classifier`` submodule (``regularize_path_weights``)

    Submodules the model lacks contribute nothing, as in the reference.
    |p| is taken as ``where(p >= 0, p, -p)`` so that its gradient at 0 is
    +1, as ``jnp.abs``'s is in the JAX package (``torch.abs`` gives 0):
    zero-initialised biases get the L1 push on the first step in both."""
    if reg_type == "none":
        return torch.zeros(())
    if reg_type == "all":
        mods = [model]
    elif reg_type in _SUBTREES:
        mods = [m for m in (getattr(model, n, None) for n in _SUBTREES[reg_type])
                if isinstance(m, nn.Module)]
    else:
        raise NotImplementedError(f"reg method [{reg_type}] is not implemented")
    params = [p for m in mods for p in m.parameters()]
    if not params:
        return torch.zeros(())
    return sum(torch.where(p >= 0, p, -p).sum() for p in params)
