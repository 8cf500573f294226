"""Weight bridge between the JAX package's flax trees and the port.

``state_dict_from_flax(params, batch_stats)`` turns the nested numpy trees
that the JAX package initialises and checkpoints into the port's
``state_dict`` (reference torch names, ``strict=True``-loadable);
``flax_from_state_dict(sd)`` is the inverse, the port's own copy of the
JAX package's ``models/import_torch.py`` key maps, so the port can write a
checkpoint in the JAX layout.  Both directions raise on any entry that no
mapping consumes (BatchNorm's ``num_batches_tracked`` aside, which flax
does not keep), so a weight is never dropped silently.

Key maps (reference module names where the reference has the module):
- ResNet trunk ``conv1/bn1/layerX.Y.*`` incl. ``downsample.{0,1}`` (and a
  Bottleneck's ``conv3/bn3``), any stage sizes; heads
  ``fc_new1.0`` (Linear) / ``fc_new1.1`` (BN1d) / ``fc_new2``
- MaxNet ``encoder.K.0`` (Linear) / ``classifier.0``
- the gated fusions: BilinearFusion (pofusion) and PolynomialFusion
  ``linear_h{i}.0 / linear_z{i} / linear_o{i}.0 / encoder{j}.0 /
  encoder{j}.1`` <-> flax ``unit{i}/{linear_h,linear_z,linear_o}``,
  ``encoder{j}``, ``encoder{j}_bn``; TrilinearFusion likewise with three
  units and no BatchNorm
- LMFusion ``factor{1,2}``, ``fusion_weights``, ``fusion_bias`` (the same
  arrays in both); HFBFusion ``proj{1,2}`` (Linear); MMDynamic ``fi_i``,
  ``clf_i``, ``conf_i``, ``mm_j``, ``mm_clf`` (Linear; the reference never
  defines these two, so the names are the JAX package's)
- PathomicModel ``path_net.* / omic_net.* / fusion.* / classifier.0``;
  PathomicDynamicsModel the same without ``classifier``
- ResnetDecoder ``fc`` <-> ``Dense_0``, ``up{i}``/``out`` (transposed
  convolutions), ``bn{i}``; MaxNetDecoder ``decoder{1..4}``

Layouts: flax conv kernels are [kh, kw, I, O] (torch [O, I, kh, kw]);
flax Dense kernels are [I, O] (torch Linear [O, I]); the Bilinear kernel is
[out, in1, in2] in both.  A flax ``ConvTranspose`` kernel [kh, kw, I, O]
is torch ``ConvTranspose2d``'s [I, O, kh, kw] flipped in both spatial axes
(``models/resnet_decoder.py``).
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict, Tuple

import numpy as np
import torch

Tree = Dict[str, object]


class _Seen:
    """A read-only view of a nested dict that records the path of every
    leaf read, so the caller can tell what no mapping consumed."""

    def __init__(self, tree, used, path=()):
        self._tree, self._used, self._path = tree, used, path

    def __getitem__(self, key):
        value = self._tree[key]
        if isinstance(value, Mapping):
            return _Seen(value, self._used, self._path + (key,))
        self._used.add(self._path + (key,))
        return value

    def __contains__(self, key):
        return key in self._tree

    def __iter__(self):
        return iter(self._tree)

    def get(self, key, default=None):
        return self[key] if key in self._tree else default


def _leaves(tree, path=()):
    if not isinstance(tree, Mapping):
        return {path}
    return set().union(*(_leaves(v, path + (k,)) for k, v in tree.items()))


def _refuse_unread(what, left):
    if left:
        raise ValueError(f"{what}: no mapping consumes {sorted(left)[:8]} "
                         f"({len(left)} entries)")


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
        if "conv3" in blk:   # a Bottleneck
            _put_conv(sd, dst + "conv3", blk["conv3"])
            _put_bn(sd, dst + "bn3", blk["bn3"], bst["bn3"])
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


def _put_conv_transpose(sd, key, p):
    # flax [kh, kw, I, O], applied unflipped -> torch [I, O, kh, kw] flipped
    k = np.asarray(p["kernel"])[::-1, ::-1]
    sd[key + ".weight"] = _tensor(k.transpose(2, 3, 0, 1))
    sd[key + ".bias"] = _tensor(p["bias"])


def _gated_to(sd, p, s, prefix):
    for i in (1, 2, 3):
        if f"unit{i}" not in p:
            continue
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
    for j in (1, 2, 3):
        if f"encoder{j}" not in p:
            continue
        _put_linear(sd, f"{prefix}encoder{j}.0", p[f"encoder{j}"])
        if f"encoder{j}_bn" in p:
            _put_bn(sd, f"{prefix}encoder{j}.1", p[f"encoder{j}_bn"],
                    s[f"encoder{j}_bn"])


_LMF = ("factor1", "factor2", "fusion_weights", "fusion_bias")
# the Linears of HFBFusion and of MMDynamic
_LINEARS = re.compile(r"proj[12]|(fi|clf|conf|mm)_\d+|mm_clf")


def _fusion_to(sd, p, s, prefix=""):
    """Any fusion tree, told apart by its keys."""
    if "unit1" in p:
        _gated_to(sd, p, s, prefix)
    elif "factor1" in p:
        for name in _LMF:
            sd[prefix + name] = _tensor(p[name])
    else:
        for name in filter(_LINEARS.fullmatch, p):
            _put_linear(sd, prefix + name, p[name])


def _resnet_decoder_to(sd, p, s):
    _put_linear(sd, "fc", p["Dense_0"])
    for name in p:
        if name.startswith("up") or name == "out":
            _put_conv_transpose(sd, name, p[name])
        elif name.startswith("bn"):
            _put_bn(sd, name, p[name], s[name])


def _is_fusion(tree) -> bool:
    return any(k in tree for k in ("unit1", "factor1", "proj1", "fi_0"))


def state_dict_from_flax(params: Tree, batch_stats: Tree = None
                         ) -> Dict[str, torch.Tensor]:
    """flax ``(params, batch_stats)`` of a PathomicModel or
    PathomicDynamicsModel, ResNet, MaxNet, fusion, ResnetDecoder or
    MaxNetDecoder -> the port module's ``state_dict``.  Raises if an entry
    of either tree is left unread."""
    batch_stats = batch_stats or {}
    used_p, used_s = set(), set()
    p, s = _Seen(params, used_p), _Seen(batch_stats, used_s)
    sd: Dict[str, torch.Tensor] = {}
    if "path_net" in p:
        _resnet_to(sd, p["path_net"], s["path_net"], "path_net.")
        _maxnet_to(sd, p["omic_net"], "omic_net.")
        if "fusion" in p:
            _fusion_to(sd, p["fusion"], s.get("fusion", {}), "fusion.")
        if "classifier" in p:
            _put_linear(sd, "classifier.0", p["classifier"])
    elif "conv1" in p:
        _resnet_to(sd, p, s)
    elif "up0" in p:
        _resnet_decoder_to(sd, p, s)
    elif "decoder1" in p:
        for i in range(1, 5):
            _put_linear(sd, f"decoder{i}", p[f"decoder{i}"])
    elif _is_fusion(p):
        _fusion_to(sd, p, s)
    elif "encoder1" in p and "classifier" in p:
        _maxnet_to(sd, p)
    else:
        raise ValueError("not a tree the bridge maps "
                         f"(keys {sorted(params)[:8]})")
    _refuse_unread("state_dict_from_flax params",
                   _leaves(params) - used_p)
    _refuse_unread("state_dict_from_flax batch_stats",
                   _leaves(batch_stats) - used_s)
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
        if src + "conv3.weight" in sd:   # a Bottleneck
            blk["conv3"] = {"kernel": _conv(sd, src + "conv3.weight")}
            blk["bn3"], bstats["bn3"] = _bn(sd, src + "bn3")
        if src + "downsample.0.weight" in sd:
            blk["ds_conv"] = {"kernel": _conv(sd, src + "downsample.0.weight")}
            blk["ds_bn"], bstats["ds_bn"] = _bn(sd, src + "downsample.1")
        params[f"layer{i}_{j}"], stats[f"layer{i}_{j}"] = blk, bstats
    if p + "fc_new1.0.weight" in sd:   # a trunk-only file has no heads
        params["fc_new1"] = _linear(sd, p + "fc_new1.0")
        params["fc_new1_bn"], stats["fc_new1_bn"] = _bn(sd, p + "fc_new1.1")
        params["fc_new2"] = _linear(sd, p + "fc_new2")
    return params, stats


def _maxnet_from(sd, prefix=""):
    params = {f"encoder{k + 1}": _linear(sd, f"{prefix}encoder.{k}.0")
              for k in range(4)}
    params["classifier"] = _linear(sd, prefix + "classifier.0")
    return params


def _gated_from(sd, p):
    params: Dict = {}
    stats: Dict = {}
    for i in (1, 2, 3):
        if f"{p}linear_o{i}.0.weight" not in sd:
            continue
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
    for j in (1, 2, 3):
        if f"{p}encoder{j}.0.weight" not in sd:
            continue
        params[f"encoder{j}"] = _linear(sd, f"{p}encoder{j}.0")
        if f"{p}encoder{j}.1.weight" in sd:
            params[f"encoder{j}_bn"], stats[f"encoder{j}_bn"] = _bn(
                sd, f"{p}encoder{j}.1")
    return params, stats


def _fusion_from(sd, p=""):
    """Any fusion's state_dict, told apart by its keys."""
    if f"{p}linear_o1.0.weight" in sd:
        return _gated_from(sd, p)
    if f"{p}factor1" in sd:
        return {name: _t(sd[p + name]) for name in _LMF}, {}
    names = {k[len(p):].rsplit(".", 1)[0] for k in sd if k.startswith(p)}
    return {name: _linear(sd, p + name)
            for name in filter(_LINEARS.fullmatch, names)}, {}


def _is_fusion_sd(sd, p="") -> bool:
    return any(p + k in sd for k in ("linear_o1.0.weight", "factor1",
                                     "proj1.weight", "fi_0.weight"))


def _resnet_decoder_from(sd):
    params: Dict = {"Dense_0": _linear(sd, "fc")}
    stats: Dict = {}
    for name in {k.split(".")[0] for k in sd}:
        if name.startswith("up") or name == "out":
            # torch [I, O, kh, kw] flipped -> flax [kh, kw, I, O]
            k = _t(sd[name + ".weight"]).transpose(2, 3, 0, 1)[::-1, ::-1]
            params[name] = {"kernel": np.ascontiguousarray(k),
                            "bias": _t(sd[name + ".bias"])}
        elif name.startswith("bn"):
            params[name], stats[name] = _bn(sd, name)
    return params, stats


class _Read(Mapping):
    """A state_dict that records the keys read."""

    def __init__(self, sd):
        self._sd, self.used = sd, set()

    def __getitem__(self, key):
        value = self._sd[key]
        self.used.add(key)
        return value

    def __contains__(self, key):
        return key in self._sd

    def __iter__(self):
        return iter(self._sd)

    def __len__(self):
        return len(self._sd)


def _from(sd) -> Tuple[Tree, Tree]:
    if any(k.startswith("path_net.") for k in sd):
        path_p, path_s = _resnet_from(sd, "path_net.")
        params = {"path_net": path_p,
                  "omic_net": _maxnet_from(sd, "omic_net.")}
        stats = {"path_net": path_s}
        if "classifier.0.weight" in sd:
            params["classifier"] = _linear(sd, "classifier.0")
        if _is_fusion_sd(sd, "fusion."):
            params["fusion"], fusion_s = _fusion_from(sd, "fusion.")
            if fusion_s:
                stats["fusion"] = fusion_s
        return params, stats
    if "conv1.weight" in sd:
        return _resnet_from(sd)
    if "up0.weight" in sd:
        return _resnet_decoder_from(sd)
    if "decoder1.weight" in sd:
        return {f"decoder{i}": _linear(sd, f"decoder{i}")
                for i in range(1, 5)}, {}
    if _is_fusion_sd(sd):
        return _fusion_from(sd)
    if "encoder.0.0.weight" in sd:
        return _maxnet_from(sd), {}
    raise ValueError("not a state_dict the bridge maps "
                     f"(keys {sorted(sd)[:8]})")


def flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Tuple[Tree, Tree]:
    """The port module's ``state_dict`` -> flax ``(params, batch_stats)``
    as numpy trees, in the JAX package's layout.  Raises if a key other
    than a ``num_batches_tracked`` is left unread."""
    reader = _Read(sd)
    out = _from(reader)
    _refuse_unread("flax_from_state_dict", {
        k for k in sd if k not in reader.used
        and not k.endswith("num_batches_tracked")})
    return out
