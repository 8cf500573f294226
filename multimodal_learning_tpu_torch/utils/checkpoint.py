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

Mid-fold snapshots for ``--resume``/``--snapshot_every``
(``save_train_state``/``load_train_state``) are the port's own format, a
``torch.save`` of the whole train state: the model and the EMA model, the
CRD or HKD heads, the optimizer with its update count and plateau scale,
the banks (CRD, HKD, t-SVD, the momentum-AEKD scale), the device generators'
states (the step's and a student's frozen teacher's), the epoch and an
``extra`` dict.  The
JAX package's snapshots (flax serialisation) and the port's do not read
each other.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Dict, Optional, Tuple

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


def save_train_state(path: str, state, epoch: int,
                     extra: Optional[Dict] = None) -> None:
    """Snapshot a port ``TrainState`` after ``epoch``, written to a
    temporary name and renamed into place."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    opt = state.optimizer
    payload = {
        "epoch": epoch, "step": state.step,
        "model": state.model.state_dict(),
        "ema_model": state.ema_model.state_dict(),
        "embeds": state.embeds.state_dict(),
        "optimizer": opt.optimizer.state_dict(), "count": opt.count,
        "lr_scale": opt.lr_scale,
        "banks": {k: dataclasses.asdict(b) if dataclasses.is_dataclass(b)
                  else b for k, b in state.banks.items()},
        "generator": state.generator.get_state(), "extra": extra}
    if state.teacher_generator is not None:
        payload["teacher_generator"] = state.teacher_generator.get_state()
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, state) -> Tuple[int, Optional[Dict]]:
    """Restore a snapshot into ``state`` (from ``init_teacher_state`` with
    the same options), in place.  Returns ``(epoch, extra)``."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["model"])
    state.ema_model.load_state_dict(payload["ema_model"])
    state.embeds.load_state_dict(payload["embeds"])
    state.optimizer.optimizer.load_state_dict(payload["optimizer"])
    state.optimizer.count = payload["count"]
    state.optimizer.lr_scale = payload["lr_scale"]
    dev = state.device
    for name, bank in payload["banks"].items():
        if isinstance(bank, torch.Tensor):
            state.banks[name].copy_(bank.to(dev))
            continue
        for k, v in bank.items():
            getattr(state.banks[name], k).copy_(v.to(dev))
    state.generator.set_state(payload["generator"])
    if "teacher_generator" in payload:
        state.teacher_generator.set_state(payload["teacher_generator"])
    state.step = payload["step"]
    return payload["epoch"], payload["extra"]
