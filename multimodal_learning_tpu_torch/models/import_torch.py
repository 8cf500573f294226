"""Torch-checkpoint import: reference state_dicts -> the ``--pretrained_path``
``.npz``, and that ``.npz`` into a port model.

Port of ``multimodal_learning_tpu/models/import_torch.py``.  Released
reference checkpoints (``<model>_k_best.pt`` with ``model_state_dict``) and
torchvision ResNet18 ImageNet weights (``MICCAI-2022/resnets.py:275-284``)
are converted once, offline (``cli/convert_torch``), into a flat ``.npz`` of
flax-layout arrays under ``params/...`` and ``batch_stats/...`` keys: the
same file format as the JAX package's, so a file written by either package
loads in the other.  ``convert_state_dict`` converts through the weight
bridge's own key maps (``import_flax``, also those of ResNet34/50 and of
every fusion type); a torchvision file's ``fc.*`` and every
``num_batches_tracked`` are dropped, and any other entry the bridge does
not map raises.

``apply_pretrained(opt, model)`` consumes ``--pretrained_path`` on a freshly
built port model: the model's own flax tree (``import_flax``), the file
merged into it by ``merge_pretrained`` (same path, same shape, cast to the
target's dtype), and the merged *full* tree loaded back with
``load_state_dict(strict=True)``.  A ResNet-only file into a pathomic model
lands under ``path_net``; a file that matches no parameter raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .import_flax import flax_from_state_dict, state_dict_from_flax


def convert_state_dict(sd: Dict, arch: str = "resnet18", prefix: str = ""
                       ) -> Tuple[Dict, Dict]:
    """A reference or torchvision state dict -> flax ``(params,
    batch_stats)`` through the bridge's key maps (``import_flax``).
    ``arch="resnet18"`` converts the ResNet under ``prefix``, with the
    reference's ``fc_new*`` heads when the file has them; a torchvision
    file's ``fc.*`` is dropped.  ``arch="pathomic"`` converts a whole
    model, of any fusion type.  ``num_batches_tracked`` is ignored; any
    other entry the bridge does not map raises."""
    if arch == "pathomic":
        return flax_from_state_dict(sd)
    sd = {k[len(prefix):]: v for k, v in sd.items()
          if k.startswith(prefix) and not k.startswith(prefix + "fc.")}
    if "conv1.weight" not in sd:
        raise ValueError(f"no ResNet under prefix {prefix!r} "
                         f"(keys {sorted(sd)[:8]})")
    return flax_from_state_dict(sd)


def flatten_tree(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dict -> {'a/b/c': array} (npz-friendly)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten_tree(flat: Dict[str, np.ndarray]) -> Dict:
    out: Dict = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def save_pretrained_npz(path: str, params: Dict, batch_stats: Dict) -> None:
    """Write converted weights as a flat .npz with ``params/…`` and
    ``batch_stats/…`` key prefixes (the ``--pretrained_path`` format)."""
    flat = {**flatten_tree({"params": params}),
            **flatten_tree({"batch_stats": batch_stats})}
    np.savez(path, **flat)


def load_pretrained_npz(path: str) -> Tuple[Dict, Dict]:
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    tree = unflatten_tree(flat)
    return tree.get("params", {}), tree.get("batch_stats", {})


def merge_pretrained(target: Dict, source: Dict) -> Tuple[Dict, int]:
    """Recursively overwrite ``target`` leaves with same-path, same-shape
    ``source`` leaves (torch's ``load_state_dict(strict=False)``, which the
    reference relies on to put torchvision ImageNet weights under its custom
    heads, ``MICCAI-2022/resnets.py:275-284``).  Returns (merged,
    n_leaves)."""
    merged: Dict = {}
    n = 0
    for k, v in target.items():
        s = source.get(k)
        if isinstance(v, dict):
            if isinstance(s, dict):
                merged[k], dn = merge_pretrained(v, s)
                n += dn
            else:
                merged[k] = v
        elif s is not None and not isinstance(s, dict) \
                and tuple(np.shape(s)) == tuple(np.shape(v)):
            merged[k] = np.asarray(s, dtype=np.asarray(v).dtype)
            n += 1
        else:
            merged[k] = v
    return merged, n


@torch.no_grad()
def apply_pretrained(opt, model: nn.Module, log=None) -> nn.Module:
    """Consume ``--pretrained_path`` on ``model`` in place (JAX
    ``apply_pretrained`` on the model's flax tree): a ResNet-only file into
    a pathomic model lands under ``path_net``, any other file at the root.
    Heads (``fc_new*``) are merged only when the file has them with
    matching shapes, so a torchvision ImageNet file initialises the trunk
    and leaves the custom heads as drawn.  The merged *full* tree loads
    back strictly.  A no-op without a path; raises when nothing
    matched."""
    path = getattr(opt, "pretrained_path", "")
    if not path:
        return model
    params, batch_stats = flax_from_state_dict(model.state_dict())
    src_params, src_stats = load_pretrained_npz(path)
    if "path_net" in params and "path_net" not in src_params:
        params["path_net"], n_p = merge_pretrained(
            params["path_net"], src_params)
        batch_stats["path_net"], n_s = merge_pretrained(
            batch_stats.get("path_net", {}), src_stats)
    else:
        params, n_p = merge_pretrained(params, src_params)
        batch_stats, n_s = merge_pretrained(batch_stats, src_stats)
    if n_p == 0:
        raise ValueError(
            f"--pretrained_path {path}: no parameter matched the model tree "
            "(wrong architecture or un-converted file? run cli/convert_torch "
            "first)")
    if log:
        log(f"loaded {n_p} param / {n_s} batch-stat tensors from {path}")
    model.load_state_dict(state_dict_from_flax(params, batch_stats),
                          strict=True)
    return model


def load_torch_state_dict(path: str, state_key: str = "model_state_dict"
                          ) -> Dict:
    """Load a .pt/.pth file into {name: numpy} (CPU, no grad).

    Released reference checkpoints are wrapper dicts
    ``{split, opt, epoch, data, model_state_dict, ema_model_state_dict,
    optimizer_state_dict, metrics}`` (``MICCAI-2022/train_cv_MT.py:119-130``);
    ``state_key`` picks which state dict to extract (the reference's own
    eval loads ``model_state_dict``, ``test_cv_MT.py:58``).  A bare
    state_dict file (torchvision ImageNet weights) passes through as-is."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and state_key != "model_state_dict" \
            and state_key not in obj:
        raise KeyError(f"{path}: no {state_key!r} in checkpoint "
                       f"(keys: {sorted(obj)[:12]})")
    sd = obj.get(state_key, obj) if isinstance(obj, dict) else obj
    return {k: v.detach().cpu().numpy() for k, v in sd.items()
            if hasattr(v, "detach")}
