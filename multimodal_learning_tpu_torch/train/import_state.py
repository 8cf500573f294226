"""Carry a teacher train state between the JAX package and the port.

The JAX package's ``TrainState`` is a pytree; the port never imports JAX,
so the bridge works on that state as nested numpy trees in one plain dict
(``jax_state_tree``'s layout, which the JAX side builds from its
``TrainState`` by taking ``ScaleByAdamState`` out of ``opt_state``)::

    {"step": int,
     "params": {"model": flax params, "crd_fuse_s": {"fc1", "fc2"},
                "crd_fuse_t": {...}},       # heads only with CRD
     "batch_stats": ..., "ema_params": ..., "ema_batch_stats": ...,
     "adam": {"count": int, "mu": <as params>, "nu": <as params>},
     "banks": {"fuse": {"memory_v1", "memory_v2", "z_v1", "z_v2"}}}

Weights and Adam's moments go through the same key maps and transposes
(``models/import_flax.py``); optax's ``count`` becomes torch Adam's
``step`` and the schedule's update count.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from ..contrast.crd import CRDBank
from ..models.import_flax import flax_from_state_dict, state_dict_from_flax
from .state import TrainState


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _embed_sd(tree) -> Dict[str, torch.Tensor]:
    return {f"{fc}.{k}": torch.from_numpy(
        np.array(np.asarray(tree[fc][src]).T if k == "weight"
                 else tree[fc][src], dtype=np.float32))
        for fc in tree for k, src in (("weight", "kernel"), ("bias", "bias"))}


def _embed_tree(sd: Dict[str, torch.Tensor]):
    tree: Dict = {}
    for key, t in sd.items():
        fc, k = key.split(".")
        tree.setdefault(fc, {})["kernel" if k == "weight" else "bias"] = (
            _np(t).T if k == "weight" else _np(t))
    return tree


def _named_params(state: TrainState) -> Dict[str, nn.Parameter]:
    named = {f"model.{n}": p for n, p in state.model.named_parameters()}
    for side, emb in state.embeds.items():
        named.update({f"{side}.{n}": p for n, p in emb.named_parameters()})
    return named


def _param_tree_to_torch(state: TrainState, tree, batch_stats
                         ) -> Dict[str, torch.Tensor]:
    """A tree shaped like ``params`` (the weights, or Adam's mu or nu) ->
    tensors named as ``_named_params``."""
    sd = state_dict_from_flax(tree["model"], batch_stats)
    out = {f"model.{n}": sd[n] for n, _ in state.model.named_parameters()}
    for side in state.embeds:
        out.update({f"{side}.{k}": v for k, v in _embed_sd(tree[side]).items()})
    return out


def _torch_to_param_tree(state: TrainState, tensors):
    sd = dict(state.model.state_dict())
    sd.update({n[len("model."):]: t for n, t in tensors.items()
               if n.startswith("model.")})
    tree = {"model": flax_from_state_dict(sd)[0]}
    for side, emb in state.embeds.items():
        tree[side] = _embed_tree({k: tensors[f"{side}.{k}"]
                                  for k, _ in emb.named_parameters()})
    return tree


def load_jax_state(state: TrainState, tree) -> TrainState:
    """Overwrite a port state (from ``init_teacher_state`` with the same
    options) with a JAX train state given as ``tree``."""
    dev = state.device
    stats = tree["batch_stats"]
    state.model.load_state_dict(
        state_dict_from_flax(tree["params"]["model"], stats), strict=True)
    state.ema_model.load_state_dict(
        state_dict_from_flax(tree["ema_params"], tree["ema_batch_stats"]),
        strict=True)
    for side, emb in state.embeds.items():
        emb.load_state_dict(_embed_sd(tree["params"][side]), strict=True)
    adam, count = tree["adam"], int(tree["adam"]["count"])
    mu = _param_tree_to_torch(state, adam["mu"], stats)
    nu = _param_tree_to_torch(state, adam["nu"], stats)
    torch_opt = state.optimizer.optimizer
    for name, p in _named_params(state).items():
        torch_opt.state[p] = {"step": torch.tensor(float(count)),
                              "exp_avg": mu[name].to(dev),
                              "exp_avg_sq": nu[name].to(dev)}
    state.optimizer.count = count
    state.step = int(tree["step"])
    for name, bank in tree.get("banks", {}).items():
        state.banks[name] = CRDBank(**{
            k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in bank.items()})
    return state


def jax_state_tree(state: TrainState):
    """The port state as the JAX package's train state, in the layout
    above (numpy trees)."""
    _, stats = flax_from_state_dict(state.model.state_dict())
    ema_params, ema_stats = flax_from_state_dict(
        state.ema_model.state_dict())
    named = _named_params(state)
    torch_opt = state.optimizer.optimizer

    def moment(key):
        return _torch_to_param_tree(state, {
            n: torch_opt.state[p][key] if p in torch_opt.state
            else torch.zeros_like(p) for n, p in named.items()})

    return {
        "step": state.step,
        "params": _torch_to_param_tree(state, dict(named)),
        "batch_stats": stats, "ema_params": ema_params,
        "ema_batch_stats": ema_stats,
        "adam": {"count": state.optimizer.count, "mu": moment("exp_avg"),
                 "nu": moment("exp_avg_sq")},
        "banks": {name: {k: _np(getattr(bank, k)) for k in (
            "memory_v1", "memory_v2", "z_v1", "z_v2")}
            for name, bank in state.banks.items()},
    }
