"""Fold checkpoints in the JAX package's pickle layout.

Layout parity with ``multimodal_learning_tpu/utils/checkpoint.py`` (and the
reference, ``train_cv_MT.py:119-130``): one pickled dict per fold holding
``{split, opt, epoch, model_state_dict, batch_stats, ema_*, metrics, ...}``
with ``opt`` as a plain dict and the weight trees as nested numpy dicts in
the flax layout (``models/import_flax.py`` converts to and from the port's
``state_dict``).  A fold trained by the JAX package is served by the port,
and a checkpoint the port writes is read by the JAX package.

The unpickler refuses classes of jax, flax and optax: a JAX-written entry
holding a jax array (for example ``metrics``) fails loudly instead of
importing jax or loading half a checkpoint.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict

import numpy as np
import torch

_TREE_KEYS = ("model_state_dict", "ema_model_state_dict",
              "optimizer_state_dict", "banks", "batch_stats",
              "ema_batch_stats", "crd_params")
_REFUSED = ("jax", "jaxlib", "flax", "optax", "orbax")


def _to_host(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if type(tree) in (list, tuple):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, payload: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    host = {}
    for k, v in payload.items():
        if k == "opt" and dataclasses.is_dataclass(v):
            host[k] = dataclasses.asdict(v)
        elif k in _TREE_KEYS:
            host[k] = _to_host(v)
        else:
            host[k] = v
    with open(path, "wb") as fh:
        pickle.dump(host, fh)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _REFUSED:
            raise pickle.UnpicklingError(
                f"checkpoint holds a {module}.{name} object; the PyTorch "
                "port reads numpy/plain-Python checkpoints only (convert "
                "the entry to numpy in the JAX package before saving)")
        return super().find_class(module, name)


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fh:
        return _Unpickler(fh).load()
