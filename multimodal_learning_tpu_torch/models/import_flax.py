"""Weight bridge between the JAX package's flax trees and the port.

``state_dict_from_flax(params, batch_stats)`` turns the nested numpy trees
that the JAX package initialises and checkpoints into the port's
``state_dict`` (reference torch names, ``strict=True``-loadable);
``flax_from_state_dict(sd)`` is the inverse, the port's own copy of the
JAX package's ``models/import_torch.py`` key maps, so the port can write a
checkpoint in the JAX layout.

Key maps (reference module names):
- ResNet trunk ``conv1/bn1/layerX.Y.*`` incl. ``downsample.{0,1}``; heads
  ``fc_new1.0`` (Linear) / ``fc_new1.1`` (BN1d) / ``fc_new2``
- MaxNet ``encoder.K.0`` (Linear) / ``classifier.0``
- BilinearFusion ``linear_h{1,2}.0 / linear_z{1,2} / linear_o{1,2}.0 /
  encoder{1,2}.0 / encoder{1,2}.1``
- PathomicModel ``path_net.* / omic_net.* / fusion.* / classifier.0``

Layouts: flax conv kernels are [kh, kw, I, O] (torch [O, I, kh, kw]);
flax Dense kernels are [I, O] (torch Linear [O, I]); the Bilinear kernel is
[out, in1, in2] in both.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

Tree = Dict[str, object]


# ----------------------------------------------------------- flax -> torch

def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _put_conv(sd, key, p):
    sd[key + ".weight"] = _tensor(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))


def _put_linear(sd, key, p):
    sd[key + ".weight"] = _tensor(np.asarray(p["kernel"]).T)
    sd[key + ".bias"] = _tensor(p["bias"])


def _put_bn(sd, key, p, s):
    sd[key + ".weight"] = _tensor(p["scale"])
    sd[key + ".bias"] = _tensor(p["bias"])
    sd[key + ".running_mean"] = _tensor(s["mean"])
    sd[key + ".running_var"] = _tensor(s["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _resnet_to(sd, p, s, prefix=""):
    _put_conv(sd, prefix + "conv1", p["conv1"])
    _put_bn(sd, prefix + "bn1", p["bn1"], s["bn1"])
    for name in p:
        if not name.startswith("layer"):
            continue
        i, j = name[len("layer"):].split("_")
        dst, blk, bst = f"{prefix}layer{i}.{j}.", p[name], s[name]
        _put_conv(sd, dst + "conv1", blk["conv1"])
        _put_bn(sd, dst + "bn1", blk["bn1"], bst["bn1"])
        _put_conv(sd, dst + "conv2", blk["conv2"])
        _put_bn(sd, dst + "bn2", blk["bn2"], bst["bn2"])
        if "ds_conv" in blk:
            _put_conv(sd, dst + "downsample.0", blk["ds_conv"])
            _put_bn(sd, dst + "downsample.1", blk["ds_bn"], bst["ds_bn"])
    _put_linear(sd, prefix + "fc_new1.0", p["fc_new1"])
    _put_bn(sd, prefix + "fc_new1.1", p["fc_new1_bn"], s["fc_new1_bn"])
    _put_linear(sd, prefix + "fc_new2", p["fc_new2"])


def _maxnet_to(sd, p, prefix=""):
    for k in range(4):
        _put_linear(sd, f"{prefix}encoder.{k}.0", p[f"encoder{k + 1}"])
    _put_linear(sd, prefix + "classifier.0", p["classifier"])


def _fusion_to(sd, p, s, prefix=""):
    for i in (1, 2):
        unit = p[f"unit{i}"]
        if "linear_h" in unit:
            _put_linear(sd, f"{prefix}linear_h{i}.0", unit["linear_h"])
        z = unit.get("linear_z")
        if z is not None and np.ndim(z["kernel"]) == 3:
            sd[f"{prefix}linear_z{i}.weight"] = _tensor(z["kernel"])
            sd[f"{prefix}linear_z{i}.bias"] = _tensor(z["bias"])
        elif z is not None:
            _put_linear(sd, f"{prefix}linear_z{i}.0", z)
        _put_linear(sd, f"{prefix}linear_o{i}.0", unit["linear_o"])
    for i in (1, 2):
        _put_linear(sd, f"{prefix}encoder{i}.0", p[f"encoder{i}"])
        _put_bn(sd, f"{prefix}encoder{i}.1", p[f"encoder{i}_bn"],
                s[f"encoder{i}_bn"])


def state_dict_from_flax(params: Tree, batch_stats: Tree = None
                         ) -> Dict[str, torch.Tensor]:
    """flax ``(params, batch_stats)`` of a PathomicModel, ResNet, MaxNet or
    BilinearFusion -> the port module's ``state_dict``."""
    s = batch_stats or {}
    sd: Dict[str, torch.Tensor] = {}
    if "path_net" in params:
        _resnet_to(sd, params["path_net"], s["path_net"], "path_net.")
        _maxnet_to(sd, params["omic_net"], "omic_net.")
        if "fusion" in params:
            _fusion_to(sd, params["fusion"], s["fusion"], "fusion.")
        _put_linear(sd, "classifier.0", params["classifier"])
    elif "conv1" in params:
        _resnet_to(sd, params, s)
    elif "unit1" in params:
        _fusion_to(sd, params, s)
    elif "encoder1" in params and "classifier" in params:
        _maxnet_to(sd, params)
    else:
        raise ValueError("not a PathomicModel, ResNet, MaxNet or "
                         f"BilinearFusion tree (keys {sorted(params)[:8]})")
    return sd


# ----------------------------------------------------------- torch -> flax

def _t(w):
    return w.detach().cpu().numpy() if isinstance(w, torch.Tensor) \
        else np.asarray(w)


def _conv(sd, key):
    # torch [O, I, kh, kw] -> flax [kh, kw, I, O]
    return _t(sd[key]).transpose(2, 3, 1, 0)


def _linear(sd, key):
    # torch [O, I] -> flax [I, O]
    return {"kernel": _t(sd[key + ".weight"]).T,
            "bias": _t(sd[key + ".bias"])}


def _bn(sd, key) -> Tuple[Dict, Dict]:
    params = {"scale": _t(sd[key + ".weight"]),
              "bias": _t(sd[key + ".bias"])}
    stats = {"mean": _t(sd[key + ".running_mean"]),
             "var": _t(sd[key + ".running_var"])}
    return params, stats


def _resnet_from(sd, prefix=""):
    p = prefix
    params: Dict = {"conv1": {"kernel": _conv(sd, p + "conv1.weight")}}
    stats: Dict = {}
    params["bn1"], stats["bn1"] = _bn(sd, p + "bn1")
    blocks = sorted({tuple(int(x) for x in k[len(p) + 5:].split(".")[:2])
                     for k in sd if k.startswith(p + "layer")})
    for i, j in blocks:
        src = f"{p}layer{i}.{j}."
        blk: Dict = {"conv1": {"kernel": _conv(sd, src + "conv1.weight")}}
        bstats: Dict = {}
        blk["bn1"], bstats["bn1"] = _bn(sd, src + "bn1")
        blk["conv2"] = {"kernel": _conv(sd, src + "conv2.weight")}
        blk["bn2"], bstats["bn2"] = _bn(sd, src + "bn2")
        if src + "downsample.0.weight" in sd:
            blk["ds_conv"] = {"kernel": _conv(sd, src + "downsample.0.weight")}
            blk["ds_bn"], bstats["ds_bn"] = _bn(sd, src + "downsample.1")
        params[f"layer{i}_{j}"], stats[f"layer{i}_{j}"] = blk, bstats
    params["fc_new1"] = _linear(sd, p + "fc_new1.0")
    params["fc_new1_bn"], stats["fc_new1_bn"] = _bn(sd, p + "fc_new1.1")
    params["fc_new2"] = _linear(sd, p + "fc_new2")
    return params, stats


def _maxnet_from(sd, prefix=""):
    params = {f"encoder{k + 1}": _linear(sd, f"{prefix}encoder.{k}.0")
              for k in range(4)}
    params["classifier"] = _linear(sd, prefix + "classifier.0")
    return params


def _fusion_from(sd, prefix=""):
    p = prefix
    params: Dict = {}
    stats: Dict = {}
    for i in (1, 2):
        unit = {}
        if f"{p}linear_h{i}.0.weight" in sd:
            unit["linear_h"] = _linear(sd, f"{p}linear_h{i}.0")
        zkey = f"{p}linear_z{i}"
        if zkey + ".weight" in sd:
            unit["linear_z"] = {"kernel": _t(sd[zkey + ".weight"]),
                                "bias": _t(sd[zkey + ".bias"])}
        elif zkey + ".0.weight" in sd:
            unit["linear_z"] = _linear(sd, zkey + ".0")
        unit["linear_o"] = _linear(sd, f"{p}linear_o{i}.0")
        params[f"unit{i}"] = unit
    for i in (1, 2):
        params[f"encoder{i}"] = _linear(sd, f"{p}encoder{i}.0")
        params[f"encoder{i}_bn"], stats[f"encoder{i}_bn"] = _bn(
            sd, f"{p}encoder{i}.1")
    return params, stats


def flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """The port module's ``state_dict`` -> flax ``(params, batch_stats)``
    as numpy trees, in the JAX package's layout."""
    if any(k.startswith("path_net.") for k in sd):
        path_p, path_s = _resnet_from(sd, "path_net.")
        params = {"path_net": path_p, "omic_net": _maxnet_from(sd, "omic_net."),
                  "classifier": _linear(sd, "classifier.0")}
        stats = {"path_net": path_s}
        if "fusion.encoder1.0.weight" in sd:
            params["fusion"], stats["fusion"] = _fusion_from(sd, "fusion.")
        return params, stats
    if "conv1.weight" in sd:
        return _resnet_from(sd)
    if "encoder1.0.weight" in sd:
        return _fusion_from(sd)
    if "encoder.0.0.weight" in sd:
        return _maxnet_from(sd), {}
    raise ValueError("not a PathomicModel, ResNet, MaxNet or BilinearFusion "
                     f"state_dict (keys {sorted(sd)[:8]})")
