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
``extra`` dict.

The JAX package's snapshots, ``<model>_<k>_state.snap``, are read and
written too (``load_jax_snapshot``/``save_jax_snapshot``): a pickle of
``{"epoch", "state_bytes", "extra"}`` whose ``state_bytes`` is flax's
msgpack encoding of the JAX ``TrainState`` (``utils/flax_msgpack.py``),
its ``opt_state`` laid out as the JAX optimizer chain of the options
(``train/optim.py:make_optimizer`` there).  It carries no random stream:
the JAX loop re-derives its key from ``--seed`` and the fold on resume,
and a port state restored from it keeps the generators it was
initialised with.  The drivers resume from ``<model>_<k>_state.pt`` when
it exists and else from the ``.snap`` (``resume_train_state``).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import flax_msgpack

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


def _jax_opt_state(opt, moments: Dict, count: int, lr_scale: float) -> Dict:
    """The state of the JAX package's ``make_optimizer(opt, ...)`` in
    flax's state-dict layout: ``moments`` are optax's (``mu``/``nu`` or
    ``sum_of_squares``) and every counter is ``count``."""
    c = np.asarray(count, np.int32)
    if opt.optimizer_type == "adabound":
        base = {"count": c, **moments}                    # AdaBoundState
    else:
        # chain(add_decayed_weights, scale_by_adam | scale_by_rss,
        #       scale_by_learning_rate(schedule)); only Adam's state counts
        scale = {"count": c, **moments} if "mu" in moments else moments
        base = {"0": {}, "1": scale, "2": {"count": c}}
    if opt.lr_policy != "plateau":
        return base
    # inject_hyperparams(chain(base, scale(lr_scale)))
    return {"count": c,
            "hyperparams": {"lr_scale": np.asarray(lr_scale, np.float32)},
            "hyperparams_states": {}, "inner_state": {"0": base, "1": {}}}


def jax_snapshot_tree(state, opt) -> Dict:
    """``state`` as the JAX package's ``TrainState`` for ``opt`` in flax's
    state-dict layout (numpy leaves, JAX's dtypes), ready for
    ``flax_msgpack.to_bytes``."""
    # imported here: the train package imports this module
    from ..train.import_state import jax_state_tree
    tree = jax_state_tree(state)
    kind = "rss" if "rss" in tree else "adam"
    moments = {k: v for k, v in tree[kind].items() if k != "count"}
    return {"step": np.asarray(tree["step"], np.int32),
            "params": tree["params"], "batch_stats": tree["batch_stats"],
            "opt_state": _jax_opt_state(opt, moments, tree[kind]["count"],
                                        state.optimizer.lr_scale),
            "ema_params": tree["ema_params"],
            "ema_batch_stats": tree["ema_batch_stats"],
            "banks": tree["banks"] or None}


def _check_layout(got, want, path: str = "") -> None:
    """Raise, naming the key, where the decoded snapshot ``got`` differs
    in structure or shape from ``want``, the port state's own layout."""
    where = path or "the state"
    if isinstance(want, dict):
        if not isinstance(got, dict):
            raise ValueError(f"{where}: the snapshot holds "
                             f"{type(got).__name__}, the port's state a map")
        for key in got:
            if key not in want:
                raise ValueError(
                    f"the snapshot holds {path}/{key}, which the port's "
                    "state for these options cannot take")
        for key in want:
            if key not in got:
                raise ValueError(f"the snapshot lacks {path}/{key}, which "
                                 "the port's state for these options needs")
            _check_layout(got[key], want[key], f"{path}/{key}")
    elif want is None or got is None or isinstance(got, dict):
        if not (want is None and got is None):
            raise ValueError(f"{where}: the snapshot holds "
                             f"{type(got).__name__}, the port's state "
                             f"{type(want).__name__}")
    elif np.shape(got) != np.shape(want):
        raise ValueError(f"{where}: shape {np.shape(got)} in the snapshot, "
                         f"{np.shape(want)} in the port's state")


def _find(tree, key: str, path: str = "opt_state"):
    """(path, map) of every map in ``tree`` that holds ``key``."""
    if not isinstance(tree, dict):
        return []
    found = [(path, tree)] if key in tree else []
    for k, v in tree.items():
        found += _find(v, key, f"{path}/{k}")
    return found


def load_jax_snapshot(path: str, state, opt) -> Tuple[int, Optional[Dict]]:
    """Restore the JAX package's snapshot at ``path`` into ``state`` (from
    the port's ``init_teacher_state`` or ``init_student_state`` with the
    same options), in place; raises naming any key the state cannot take.
    Returns ``(epoch, extra)``, as ``load_train_state``."""
    from ..train.import_state import _MOMENTS, load_jax_state
    with open(path, "rb") as fh:
        payload = _Unpickler(fh).load()
    tree = flax_msgpack.from_bytes(payload["state_bytes"])
    _check_layout(tree, jax_snapshot_tree(state, opt))
    opt_state = tree["opt_state"]
    kind, names = _MOMENTS[type(state.optimizer.optimizer)]
    (_, moments), = _find(opt_state, next(iter(names.values())))
    counts = {p: int(m["count"]) for p, m in _find(opt_state, "count")}
    if len(set(counts.values())) != 1:
        raise ValueError(f"the snapshot's optimizer counts differ: {counts}")
    jtree = {k: tree[k] for k in ("params", "batch_stats", "ema_params",
                                  "ema_batch_stats")}
    jtree.update(step=int(tree["step"]), banks=tree["banks"] or {})
    jtree[kind] = {"count": counts.popitem()[1],
                   **{n: moments[n] for n in names.values()}}
    load_jax_state(state, jtree)
    for _, hp in _find(opt_state, "hyperparams"):
        state.optimizer.lr_scale = float(hp["hyperparams"]["lr_scale"])
    return payload["epoch"], payload.get("extra")


def save_jax_snapshot(path: str, state, opt, epoch: int,
                      extra: Optional[Dict] = None) -> None:
    """Write ``state`` as the JAX package's snapshot after ``epoch``
    (``save_train_state`` there), which its ``load_train_state`` restores
    against a fresh JAX state of the same options."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = flax_msgpack.to_bytes(jax_snapshot_tree(state, opt))
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        pickle.dump({"epoch": epoch, "state_bytes": blob, "extra": extra}, fh)
    os.replace(tmp, path)


def resume_train_state(opt, state, ckpt_dir: str, fold: int,
                       log: Callable = print) -> Tuple[int, Optional[Dict]]:
    """``--resume``: restore ``state`` from ``<model>_<fold>_state.pt`` in
    ``ckpt_dir`` or, where there is none, from the JAX package's
    ``<model>_<fold>_state.snap``, and log which.  Returns the first epoch
    to run and the snapshot's ``extra`` (``opt.epoch_count`` and None when
    neither file exists)."""
    base = os.path.join(ckpt_dir, f"{opt.model_name}_{fold}_state")
    for path, load in ((f"{base}.pt", load_train_state),
                       (f"{base}.snap", lambda p, s: load_jax_snapshot(
                           p, s, opt))):
        if os.path.exists(path):
            done_epoch, extra = load(path, state)
            log(f"[fold {fold}] resumed from epoch {done_epoch} "
                f"({os.path.basename(path)})")
            return done_epoch + 1, extra
    return opt.epoch_count, None
