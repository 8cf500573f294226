"""ResNet34 (with and without ``--paired_conv``) and ResNet50 (Bottleneck)
of the port against the JAX package's, through the weight bridge both
ways.

JAX -> port: flax init with perturbed BatchNorm statistics, scales and
biases, carried by ``state_dict_from_flax`` (``strict=True``); port ->
JAX: the port's own init carried by ``flax_from_state_dict``.  Each way,
the forward at 64^2, batch 4:

- eval mode in fp32, at the trunk's tolerance in
  ``test_torch_port_models.py`` (rtol 1e-3 / atol 2e-4; conv sums differ
  in order between XLA and oneDNN);
- train mode in float64 on both sides (``jax.enable_x64``),
  the outputs and the new running statistics at rtol 1e-9 / atol 1e-9.
  In fp32 the train-mode BatchNorm1d of ``fc_new1`` normalises 4 values
  per channel and turns conv rounding into errors of up to 7e-3 in
  ResNet50's ``features``: measured against a float64 forward, 6.8e-3 for
  the JAX package's fp32 forward and 2.8e-3 for the port's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_learning_tpu import models as jm
from multimodal_learning_tpu_torch import models as pm
from multimodal_learning_tpu_torch.models.import_flax import (
    flax_from_state_dict, state_dict_from_flax)

TOL = dict(rtol=1e-3, atol=2e-4)
TOL64 = dict(rtol=1e-9, atol=1e-9)
ARCHS = {
    "resnet34": (jm.ResNet34, pm.ResNet34, {}),
    "resnet34_paired": (jm.ResNet34, pm.ResNet34, {"paired": True}),
    "resnet50": (jm.ResNet50, pm.ResNet50, {}),
}


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = jax.tree_util.keystr(path[-1:])
        x = np.asarray(x, np.float32)
        if name == "['mean']":
            return rng.uniform(-0.2, 0.2, x.shape).astype(np.float32)
        if name == "['var']":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "['scale']":
            return rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        if name == "['bias']":
            return x + rng.uniform(-0.1, 0.1, x.shape).astype(np.float32)
        return x

    out = jax.tree_util.tree_map_with_path(leaf, dict(variables))
    return out["params"], out["batch_stats"]


def _to64(port, params, stats):
    """The port module and the flax trees in float64."""
    port.double()
    for m in port.modules():
        if hasattr(m, "dtype"):
            m.dtype = torch.float64
    cast = lambda t: jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64), t)
    return port, cast(params), cast(stats)


def _compare(jmod, port, params, stats, x, train):
    """``jmod`` (a constructor of the flax module) against ``port``."""
    variables = {"params": params, "batch_stats": stats}
    if not train:
        want = jmod().apply(variables, jnp.asarray(x), train=False)
        with torch.no_grad():
            got = port.eval()(torch.from_numpy(x))
        for name, g, w in zip(("feat_f3", "features", "hazard", "pred"),
                              got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=name, **TOL)
        return
    port, params, stats = _to64(port, params, stats)
    x = x.astype(np.float64)
    with jax.enable_x64(True):
        want, mut = jmod(dtype=jnp.float64).apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, mutable=["batch_stats"])
        want = [np.asarray(w) for w in want]
        want_stats = jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(np.asarray, mut["batch_stats"]))[0]
    with torch.no_grad():
        got = port.train()(torch.from_numpy(x))
    # the module returns float32 outputs: compare them at fp32 rounding
    for name, g, w in zip(("feat_f3", "features", "hazard", "pred"), got,
                          want):
        np.testing.assert_allclose(g.numpy(), w.astype(np.float32),
                                   err_msg=name, rtol=1e-6, atol=1e-6)
    _, new_stats = flax_from_state_dict(port.state_dict())
    got_flat = dict(jax.tree_util.tree_flatten_with_path(new_stats)[0])
    assert len(got_flat) == len(want_stats)
    for path, w in want_stats:
        np.testing.assert_allclose(got_flat[path], w, **TOL64,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_deep_resnet_matches_jax_both_ways(arch, train):
    jcls, pcls, kw = ARCHS[arch]
    x = np.random.default_rng(1).normal(size=(4, 64, 64, 3)).astype(
        np.float32)
    jmod = lambda **dt: jcls(path_dim=16, num_classes=3, **kw, **dt)
    # JAX -> port
    params, stats = _perturbed(
        jmod().init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 2)
    port = pcls(path_dim=16, num_classes=3, **kw)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    _compare(jmod, port, params, stats, x, train)
    # port -> JAX
    port = pcls(path_dim=16, num_classes=3,
                generator=torch.Generator().manual_seed(3), **kw)
    params, stats = flax_from_state_dict(port.state_dict())
    _compare(jmod, port, params, stats, x, train)
    if arch == "resnet50":
        assert port.layer1[0].conv3.weight.shape == (256, 64, 1, 1)
        assert port.fc_new1[0].in_features == 2048
