"""The port's stage-1 3x3 convolution (``ops/paired_conv.py``, kernel B5 on
the card) against the JAX package's.

On the CPU the port's wrapper takes its plain version (``F.conv2d``); the
autograd function still computes the data gradient by the kernel's route
(the plain convolution of the gradient with the flipped, IO-transposed
weights), so the flip and transposition are what these tests hold.

- ``paired_conv3x3`` forward and both gradients against JAX's
  ``paired_conv3x3`` through ``jax.vjp``, fp32, rtol 1e-5 / atol 1e-5 (the
  same function summed in another order).
- ``conv3x3(g, w, transposed=True)`` (the kernel's data-gradient form, W
  flipped and IO-swapped as it is staged) against JAX's ``_pc3_bwd``, at
  the same tolerance.
- The plain version against the Pallas kernel B5 itself
  (``tools/pallas_conv_proto.py:conv_pallas``, interpret mode) at its one
  shape, bf16, rtol 1e-2 / atol 1e-2: one bf16 ulp at the output's scale
  of about 6.
- ResNet18 with ``paired=True`` against the flax ``ResNet(paired=True)``
  in eval and train mode, at the whole-model tolerance rtol 2e-3 /
  atol 5e-4 (``test_torch_import.py``; conv sums in another order in XLA
  and oneDNN); the ``state_dict`` is the same with and without pairing.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from multimodal_learning_tpu import models as jm
from multimodal_learning_tpu.ops import paired_conv as j_pc
from multimodal_learning_tpu.ops.paired_conv import \
    paired_conv3x3 as j_paired_conv3x3
from multimodal_learning_tpu_torch import models as pm
from multimodal_learning_tpu_torch.models.import_flax import (
    flax_from_state_dict, state_dict_from_flax)
from multimodal_learning_tpu_torch.ops import paired_conv as pc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHOLE = dict(rtol=2e-3, atol=5e-4)


def _nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's NCHW-shaped channels-last tensor."""
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (2, 8, 10, 64)])
def test_paired_conv3x3_forward_and_grads_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 64, 64)) * 0.06).astype(np.float32)  # HWIO
    # the cotangent at 1/sqrt(B*H*W), so dW (a sum over the pixels) is of
    # order 1, where an fp32 sum of its length holds 1e-5 absolute
    g = (rng.normal(size=shape) / np.sqrt(np.prod(shape[:3]))).astype(
        np.float32)
    want, vjp = jax.vjp(j_paired_conv3x3, jnp.asarray(x), jnp.asarray(k))
    want_dx, want_dk = vjp(jnp.asarray(g))

    xt = _nchw(x).requires_grad_()
    wt = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_()
    before = pc.conv3x3.launches
    y = pc.paired_conv3x3(xt, wt)
    dx, dw = torch.autograd.grad(y, (xt, wt), _nchw(g))
    assert pc.conv3x3.launches == before   # the CPU takes the plain version
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), **tol)
    np.testing.assert_allclose(dx.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want_dx), **tol)
    np.testing.assert_allclose(dw.permute(2, 3, 1, 0).numpy(),
                               np.asarray(want_dk), **tol)


@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (1, 7, 10, 64)])
def test_transposed_conv3x3_is_jax_data_gradient(shape):
    """The plain version's ``transposed`` form, and the wrapper's on the CPU,
    against the data gradient of JAX's custom VJP (``_pc3_bwd``)."""
    rng = np.random.default_rng(7 + sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(3, 3, 64, 64)) * 0.06).astype(np.float32)  # HWIO
    g = rng.normal(size=shape).astype(np.float32)
    want_dx, _ = j_pc._pc3_bwd((jnp.asarray(x), jnp.asarray(k)),
                               jnp.asarray(g))
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())   # [Co, Ci, 3, 3]
    before = pc.conv3x3.launches
    for got in (pc.conv3x3_plain(_nchw(g), w, transposed=True),
                pc.conv3x3(_nchw(g), w, transposed=True)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want_dx), rtol=1e-5, atol=1e-5)
    assert pc.conv3x3.launches == before


def test_plain_conv3x3_matches_pallas_b5(monkeypatch):
    """The port's plain version against the TPU kernel it replaces, run in
    interpret mode on the CPU."""
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    spec = importlib.util.spec_from_file_location(
        "pallas_conv_proto", os.path.join(REPO, "tools",
                                          "pallas_conv_proto.py"))
    proto = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(proto)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(1, 128, 128, 64)), jnp.bfloat16)
    w = jnp.asarray(rng.normal(size=(3, 3, 64, 64)) * 0.05, jnp.bfloat16)
    want = np.asarray(proto.conv_pallas(x, proto._pack_w3(np.asarray(w))),
                      np.float32)
    xt = _nchw(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    wt = torch.from_numpy(np.asarray(w.astype(jnp.float32)).transpose(
        3, 2, 0, 1).copy()).to(torch.bfloat16)
    got = pc.conv3x3(xt, wt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-2, atol=1e-2)


def test_conv3x3_refuses_other_devices():
    x = torch.zeros(1, 64, 4, 4, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        pc.conv3x3(x, torch.zeros(64, 64, 3, 3, device="meta"))


def _flax_resnet(seed, size):
    jmod = jm.ResNet18(path_dim=16, num_classes=3, paired=True)
    v = jmod.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                  train=False)
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = jax.tree_util.keystr(path[-1:])
        a = np.asarray(a, np.float32)
        if name == "['mean']":
            return rng.uniform(-0.2, 0.2, a.shape).astype(np.float32)
        if name == "['var']":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    v = jax.tree_util.tree_map_with_path(leaf, dict(v))
    return jmod, v["params"], v["batch_stats"]


@pytest.mark.parametrize("train", [False, True])
def test_paired_resnet18_matches_flax(train):
    size = 32
    jmod, params, stats = _flax_resnet(3, size)
    x = np.random.default_rng(4).normal(size=(4, size, size, 3)).astype(
        np.float32)
    port = pm.ResNet18(path_dim=16, num_classes=3, paired=True)
    assert isinstance(port.layer1[0].conv1, pc.PairedConv3x3)
    assert isinstance(port.layer1[1].conv2, pc.PairedConv3x3)
    assert not isinstance(port.layer2[0].conv1, pc.PairedConv3x3)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train(train)
    if train:
        want, new = jmod.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x), train=True,
                               mutable=["batch_stats"])
        got = port(torch.from_numpy(x))
        _, got_stats = flax_from_state_dict(port.state_dict())
        for (path, a), (_, b) in zip(
                jax.tree_util.tree_flatten_with_path(got_stats)[0],
                jax.tree_util.tree_flatten_with_path(
                    jax.tree_util.tree_map(np.asarray,
                                           new["batch_stats"]))[0]):
            np.testing.assert_allclose(a, b, **WHOLE,
                                       err_msg=jax.tree_util.keystr(path))
    else:
        want = jmod.apply({"params": params, "batch_stats": stats},
                          jnp.asarray(x), train=False)
        with torch.no_grad():
            got = port(torch.from_numpy(x))
    for a, b in zip(got, want):   # feat_f3, features, hazard, pred
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **WHOLE)


def test_pairing_keeps_the_state_dict():
    """Same keys, shapes and (from one generator) values with and without
    pairing, so fold checkpoints and the flax bridge do not change."""
    sd = [pm.ResNet18(path_dim=8, paired=p,
                      generator=torch.Generator().manual_seed(0)).state_dict()
          for p in (False, True)]
    assert list(sd[0]) == list(sd[1])
    for k in sd[0]:
        assert torch.equal(sd[0][k], sd[1][k]), k


def test_pairing_rule_follows_jax(monkeypatch):
    """conv1 at stride 1 and conv2 of the 64-plane blocks only; an odd
    input width takes the ordinary convolution."""
    port = pm.ResNet18(path_dim=8, paired=True)
    paired = {n for n, m in port.named_modules()
              if isinstance(m, pc.PairedConv3x3)}
    assert paired == {"layer1.0.conv1", "layer1.0.conv2", "layer1.1.conv1",
                      "layer1.1.conv2"}
    conv = port.layer1[0].conv1
    x = torch.randn(1, 64, 5, 7)
    calls = []
    orig = pc._PairedConv3x3.apply
    monkeypatch.setattr(pc._PairedConv3x3, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    conv(x)
    assert calls == []
    conv(torch.randn(1, 64, 5, 8))
    assert calls == [1]
