"""Port models against the JAX package's flax modules, eval forward.

Weights come from ``flax.init`` (BN statistics, BN affine and biases
perturbed so every term matters) and cross to the port through
``models.import_flax.state_dict_from_flax`` with ``strict=True``; inputs
come from a numpy seed.  Where the JAX module reaches the Pallas kernel it
runs in interpret mode, as ``tests/test_pallas_ops.py`` runs it; the port
takes the kernel's plain version on the CPU.  Everything is fp32.
Tolerances: the ResNet and the whole model follow ``test_torch_import.py``
(rtol 1e-3 / atol 2e-4 for the trunk, rtol 2e-3 / atol 5e-4 for the
pathomic outputs: conv sums differ in order between XLA and oneDNN); the
small MLP and the fusion hold rtol 1e-4 / atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from multimodal_learning_tpu import models as jm
from multimodal_learning_tpu.models.import_torch import convert_pathomic
from multimodal_learning_tpu_torch import models as pm
from multimodal_learning_tpu_torch.models.import_flax import (
    flax_from_state_dict, state_dict_from_flax)

FIELDS = ("fuse_feat", "path_feat", "omic_feat", "path_feat_f3",
          "hazard_fuse", "hazard_path", "hazard_omic", "pred_fuse",
          "pred_path", "pred_omic")


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Let the JAX modules reach the Pallas kernel, in interpret mode."""
    monkeypatch.setenv("MML_PALLAS_FORCE", "1")
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import multimodal_learning_tpu.ops.kron_fusion as kf
    monkeypatch.setattr(kf.pl, "pallas_call", patched)


def _perturbed(variables, seed):
    """flax variables -> numpy (params, batch_stats) with non-trivial BN
    statistics, BN scales and biases."""
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
    return out["params"], out.get("batch_stats", {})


def _port(module, params, stats):
    module.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return module.eval()


def _close(got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_resnet18_eval_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    jmod = jm.ResNet18(path_dim=32, num_classes=3)
    params, stats = _perturbed(
        jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False), 1)
    want = jmod.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=False)
    port = _port(pm.ResNet18(path_dim=32, num_classes=3), params, stats)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):  # feat_f3, features, hazard, pred
        _close(g, w, rtol=1e-3, atol=2e-4)


def test_maxnet_eval_matches_jax():
    x = np.random.default_rng(2).normal(size=(4, 80)).astype(np.float32)
    jmod = jm.MaxNet(omic_dim=16, label_dim=3, act_type="LSM")
    params, stats = _perturbed(
        jmod.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False), 3)
    want = jmod.apply({"params": params}, jnp.asarray(x), train=False)
    port = _port(pm.MaxNet(omic_dim=16, label_dim=3, act_type="LSM"),
                 params, stats)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    for g, w in zip(got, want):  # features, hazard, pred
        _close(g, w, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("skip", [0, 1])
def test_bilinear_fusion_eval_matches_jax(skip, interpret_pallas):
    d, mm = 8, 12
    rng = np.random.default_rng(4 + skip)
    v1, v2 = (rng.normal(size=(4, d)).astype(np.float32) for _ in range(2))
    jmod = jm.BilinearFusion(dim1=d, dim2=d, mmhid=mm, skip=skip,
                             pallas_eval=True)
    variables = jmod.init({"params": jax.random.PRNGKey(skip),
                           "dropout": jax.random.PRNGKey(9)},
                          jnp.asarray(v1), jnp.asarray(v2), train=False)
    params, stats = _perturbed(variables, 5)
    want = jmod.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(v1), jnp.asarray(v2), train=False)
    port = _port(pm.BilinearFusion(dim1=d, dim2=d, mmhid=mm, skip=skip,
                                   pallas_eval=True), params, stats)
    with torch.no_grad():
        got = port(torch.from_numpy(v1), torch.from_numpy(v2))
    _close(got, want, rtol=1e-4, atol=1e-5)


def _pathomic_pair(seed, **kw):
    dims = dict(path_dim=16, omic_dim=16, mmhid=16, label_dim=3, **kw)
    jmod = jm.PathomicModel(**dims)
    variables = jmod.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        x_path=jnp.zeros((1, 64, 64, 3)), x_omic=jnp.zeros((1, 80)),
        train=False)
    params, stats = _perturbed(variables, seed + 2)
    port = _port(pm.PathomicModel(**dims), params, stats)
    return jmod, params, stats, port


def test_pathomic_eval_matches_jax_all_branches(interpret_pallas):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    om = rng.normal(size=(2, 80)).astype(np.float32)
    jmod, params, stats, port = _pathomic_pair(7, pallas_fusion="train",
                                               cut_fuse_grad=True)
    want = jmod.apply({"params": params, "batch_stats": stats},
                      x_path=jnp.asarray(x), x_omic=jnp.asarray(om),
                      train=False)
    with torch.no_grad():
        got = port(x_path=torch.from_numpy(x), x_omic=torch.from_numpy(om))
    assert got._fields == want._fields == FIELDS
    for name in FIELDS:
        _close(getattr(got, name), getattr(want, name), rtol=2e-3,
               atol=5e-4)


def test_concat_fusion_and_unported_types():
    """concat has no fusion module; the polynomial, LMF and HFB types build
    and run (their parity: ``tests/test_torch_port_fusions.py``); an
    unknown type still raises."""
    _, params, stats, port = _pathomic_pair(11, fusion_type="concat")
    assert "fusion" not in params and port.fusion is None
    x, om = torch.zeros(2, 32, 32, 3), torch.zeros(2, 80)
    for fusion_type, cls in (("polynomial_fusion", pm.PolynomialFusion),
                             ("LMF", pm.LMFusion), ("HFB", pm.HFBFusion)):
        model = pm.PathomicModel(path_dim=8, omic_dim=8, mmhid=8,
                                 fusion_type=fusion_type)
        assert isinstance(model.fusion, cls)
        with torch.no_grad():
            assert model.eval()(x_path=x, x_omic=om).pred_fuse.shape == (2, 3)
    with pytest.raises(NotImplementedError, match="not found"):
        pm.PathomicModel(fusion_type="nope")


def _assert_tree_equal(a, b):
    fa = jax.tree_util.tree_flatten_with_path(a)[0]
    fb = jax.tree_util.tree_flatten_with_path(b)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert np.array_equal(np.asarray(x), np.asarray(y)), path


@pytest.mark.parametrize("fusion_type", ["pofusion", "concat",
                                         "polynomial_fusion", "LMF", "HFB"])
def test_weight_bridge_round_trips(fusion_type):
    """flax -> port -> flax is exact, and the JAX package's own torch
    importer reads the port's state_dict back into the same flax tree."""
    _, params, stats, port = _pathomic_pair(13, fusion_type=fusion_type)
    sd = port.state_dict()
    back_p, back_s = flax_from_state_dict(state_dict_from_flax(params, stats))
    _assert_tree_equal(back_p, params)
    _assert_tree_equal(back_s, stats)
    if fusion_type == "pofusion":  # the JAX importer always reads fusion.*
        jp, js = convert_pathomic({k: v.numpy() for k, v in sd.items()})
        _assert_tree_equal(jp, params)
        _assert_tree_equal(js, stats)


def test_weight_bridge_unimodal_trees():
    x = np.zeros((1, 64, 64, 3), np.float32)
    res = jm.ResNet18(path_dim=8)
    p, s = _perturbed(res.init(jax.random.PRNGKey(0), x, train=False), 0)
    _assert_tree_equal(flax_from_state_dict(state_dict_from_flax(p, s)),
                       (p, s))
    mx = jm.MaxNet(omic_dim=8)
    p, _ = _perturbed(mx.init(jax.random.PRNGKey(1), np.zeros((1, 80)),
                              train=False), 1)
    _assert_tree_equal(flax_from_state_dict(state_dict_from_flax(p)), (p, {}))
