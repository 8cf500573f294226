"""MMDynamic: the trustworthy dynamical fusion (PyTorch).

Port of ``multimodal_learning_tpu/models/mmdynamic.py``, the JAX package's
reconstruction of the class the reference constructs but never defines
(``MICCAI-2022/networks_new.py:372-418``), after Han et al., "Multimodal
Dynamics: Dynamical Fusion for Trustworthy Multimodal Classification"
(CVPR 2022):

- per modality ``i``: a feature-informativeness gate (``fi_i``, sigmoid
  elementwise), dropout, a classifier (``clf_i``) and a TCP confidence
  head (``conf_i``, sigmoid);
- fusion: the gated features times their confidence, concatenated, through
  ``mm_j`` (ReLU, dropout) and ``mm_clf``;
- loss: the fused CE plus, per modality, its CE and the squared error of
  its confidence against the (detached) true-class probability.

The reference never defines the class, so its parameter names are the JAX
package's: every layer is a ``Linear`` with the torch-default kernel law
and a zero bias (flax's ``Dense`` default).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from .common import torch_linear_default_


def _dense(fan_in: int, width: int, generator) -> nn.Linear:
    layer = nn.Linear(fan_in, width)
    torch_linear_default_(layer.weight, generator)
    nn.init.zeros_(layer.bias)
    return layer


class MMDynamic(nn.Module):
    def __init__(self, dim_list: Sequence[int],
                 hidden_dim: Sequence[int] = (128,), num_class: int = 3,
                 dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_class = num_class
        self.n_views, self.n_hidden = len(dim_list), len(hidden_dim)
        for i, d in enumerate(dim_list):
            setattr(self, f"fi_{i}", _dense(d, d, generator))
            setattr(self, f"clf_{i}", _dense(d, num_class, generator))
            setattr(self, f"conf_{i}", _dense(d, 1, generator))
        d = sum(dim_list)
        for j, width in enumerate(hidden_dim):
            setattr(self, f"mm_{j}", _dense(d, width, generator))
            d = width
        self.mm_clf = _dense(d, num_class, generator)
        self.drop = nn.Dropout(dropout)

    def forward(self, features, labels=None, infer: bool = False):
        """``features``: one [B, d_i] tensor per modality.  Returns
        ``mm_logit`` with ``infer`` or without ``labels``, else ``(loss,
        mm_logit, tcp_logits)``."""
        gated, tcp_logits, confidences = [], [], []
        for i, f in enumerate(features):
            f = self.drop(f * torch.sigmoid(getattr(self, f"fi_{i}")(f)))
            conf = torch.sigmoid(getattr(self, f"conf_{i}")(f))
            gated.append(f * conf)
            tcp_logits.append(getattr(self, f"clf_{i}")(f))
            confidences.append(conf)
        h = torch.cat(gated, dim=1)
        for j in range(self.n_hidden):
            h = self.drop(torch.relu(getattr(self, f"mm_{j}")(h)))
        mm_logit = self.mm_clf(h)
        if infer or labels is None:
            return mm_logit

        # num_classes given, so that one_hot does not read the labels'
        # maximum on the host
        oh = F.one_hot(labels.long(), self.num_class).to(mm_logit.dtype)

        def ce(logit):
            return -(oh * torch.log_softmax(logit, dim=1)).sum(1).mean()

        loss = ce(mm_logit)
        for logit, conf in zip(tcp_logits, confidences):
            tcp = (torch.softmax(logit, dim=1) * oh).sum(1, keepdim=True)
            loss = loss + ce(logit) + ((conf - tcp.detach()) ** 2).mean()
        return loss, mm_logit, tcp_logits
