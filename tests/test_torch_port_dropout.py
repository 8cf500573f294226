"""Dropout at a rate above 0 (ROADMAP §C, check 2): the port's fusions and
MaxNet in train mode at rate 0.25 against the JAX package's flax modules,
on the same masks, bridged weights and numpy-seeded inputs.

- ``BilinearFusion`` (pofusion): the two gated units' dropout, the
  Kronecker vector's and the dropout after ``encoder1`` and ``encoder2``,
  with and without the skip, on the reference einsum; and on the train
  contraction ``kron_matmul_dropout`` (B1's plain version here, the
  Pallas kernel in interpret mode on the JAX side), whose mask is handed
  over explicitly.
- ``PolynomialFusion``: the gated units', both Kronecker vectors' and the
  three encoders' dropout.
- ``MaxNet``'s ``AlphaDropout`` after each of its four layers, which the
  JAX package writes out (``models/common.py:43-63``) and the port takes
  from torch (``nn.AlphaDropout``).

The JAX masks are read inside the flax modules' own draws
(``flax.linen.intercept_methods``: each ``nn.Dropout`` call is applied to
ones, which gives its keep mask over the keep probability from the same
key) and fed to the port's ``nn.Dropout`` modules in call order by forward
hooks that apply them as flax does, ``where(mask, x / keep, 0)``.
torch's ``AlphaDropout`` draws inside its kernel, so there the masks go
the other way: read from the port's outputs (a dropped unit takes the one
value ``a * alpha * (p - 1)``) and fed to the JAX module through its
``jax.random.bernoulli``.

Outputs and the gradients of a fixed cotangent with respect to the inputs
are held at rtol 1e-5 / atol 1e-6 in float32.  The fusions' train-mode
BatchNorms normalise by the batch variance, which flax computes in one
pass (``tests/test_torch_port_fusions.py``); the batches here are 16 rows
of unit-scale inputs, where that moves nothing beyond these tolerances.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn
from jax.experimental import pallas as pl

from multimodal_learning_tpu import models as jm
from multimodal_learning_tpu.models import common as jcommon
from multimodal_learning_tpu_torch import models as pm
from multimodal_learning_tpu_torch.models import fusion as pfusion
from multimodal_learning_tpu_torch.models.import_flax import \
    state_dict_from_flax
from test_torch_port_models import _perturbed

RATE, KEEP = 0.25, 0.75
TOL = dict(rtol=1e-5, atol=1e-6)
B = 16


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Let the JAX fusion reach its Pallas train kernel, in interpret
    mode (``tests/test_torch_port_step.py``)."""
    monkeypatch.setenv("MML_PALLAS_FORCE", "1")
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import multimodal_learning_tpu.ops.kron_fusion as kf
    monkeypatch.setattr(kf.pl, "pallas_call", patched)


def _jax_masks(jmod, variables, xs, rngs):
    """The keep masks of every ``nn.Dropout`` call of ``jmod``'s train
    forward under ``rngs``, in call order."""
    masks = []

    def capture(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            kept = next_fun(jnp.ones_like(args[0]), *args[1:], **kwargs)
            masks.append(np.asarray(kept) != 0)
            return jnp.where(kept != 0, args[0] / KEEP, 0)
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(capture):
        jmod.apply(variables, *xs, train=True, rngs=rngs,
                   mutable=["batch_stats"])
    return masks


def _feed_masks(port, masks):
    """Forward hooks on every ``nn.Dropout`` of ``port`` that apply the
    next of ``masks`` as flax does; returns the queue, empty once each
    mask was used."""
    queue = [torch.from_numpy(m) for m in masks]

    def hook(module, inp, out):
        mask = queue.pop(0)
        assert mask.shape == inp[0].shape
        return torch.where(mask, inp[0] / KEEP, 0.0)

    for m in port.modules():
        if isinstance(m, torch.nn.Dropout):
            assert m.p == RATE
            m.register_forward_hook(hook)
    return queue


def _jax_out_and_input_grads(jmod, variables, xs, cot, rngs):
    def loss(*x):
        out = jmod.apply(variables, *x, train=True, rngs=rngs,
                         mutable=["batch_stats"])[0]
        out = out[1] if isinstance(out, tuple) else out
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(xs))), has_aux=True)(
            *map(jnp.asarray, xs))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _port_out_and_input_grads(port, xs, cot):
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    out = port.train()(*txs)
    out = out[1] if isinstance(out, tuple) else out
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in txs]


def _pair(jmod, port, widths, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.normal(size=(B, w)).astype(np.float32) for w in widths]
    variables = jmod.init({"params": jax.random.PRNGKey(seed),
                           "dropout": jax.random.PRNGKey(seed + 1)},
                          *map(jnp.asarray, xs), train=False)
    params, stats = _perturbed(variables, seed + 2)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    variables = {"params": params, "batch_stats": stats}
    return variables, xs, rng


def _assert_close(got, want):
    (out, grads), (j_out, j_grads) = got, want
    np.testing.assert_allclose(out, j_out, **TOL, err_msg="output")
    for i, (g, w) in enumerate(zip(grads, j_grads)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"input {i} grad")


def _fusion_cases():
    """name -> (JAX module, port module, input widths, dropout calls);
    pofusion's gated units pair the inputs both ways, so its widths are
    equal."""
    cases = {}
    for skip in (0, 1):
        kw = dict(skip=skip, dim1=8, dim2=8, mmhid=7, dropout_rate=RATE)
        cases[f"bilinear_skip{skip}"] = (
            jm.BilinearFusion(**kw), pm.BilinearFusion(**kw), (8, 8), 5)
        kw = dict(kw, dim2=6)
        cases[f"polynomial_skip{skip}"] = (
            jm.PolynomialFusion(**kw), pm.PolynomialFusion(**kw), (8, 6), 7)
    return cases


@pytest.mark.parametrize("case", sorted(_fusion_cases()))
def test_fusion_dropout_matches_jax(case):
    """Every dropout of the fusion on the JAX masks: pofusion's 5 calls
    (two gated units, the Kronecker vector, after ``encoder1`` and
    ``encoder2``), the polynomial fusion's 7 (two units, two Kronecker
    vectors, three encoders)."""
    jmod, port, widths, n_calls = _fusion_cases()[case]
    variables, xs, rng = _pair(jmod, port, widths, seed=len(case))
    cot = rng.normal(size=(B, 7)).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(11)}
    masks = _jax_masks(jmod, variables, xs, rngs)
    assert len(masks) == n_calls
    # both laws: about a quarter of each mask dropped
    drop = 1 - np.concatenate([m.ravel() for m in masks]).mean()
    assert 0.2 < drop < 0.3, drop
    want = _jax_out_and_input_grads(jmod, variables, xs, cot, rngs)
    queue = _feed_masks(port, masks)
    _assert_close(_port_out_and_input_grads(port, xs, cot), want)
    assert not queue


def test_pofusion_train_contraction_mask_matches_jax(interpret_pallas,
                                                     monkeypatch):
    """``pallas_fusion="train"``: the Kronecker vector's mask is B1's
    explicit ``maskf`` in both packages (the JAX Pallas kernel in
    interpret mode, the port's plain version), drawn by JAX and handed to
    the port's ``draw_rows``; the other four dropouts on the JAX masks."""
    import multimodal_learning_tpu.ops.kron_fusion as jkf
    kw = dict(dim1=8, dim2=8, mmhid=7, dropout_rate=RATE, pallas_train=True)
    jmod, port = jm.BilinearFusion(**kw), pm.BilinearFusion(**kw)
    variables, xs, rng = _pair(jmod, port, (8, 8), seed=3)
    cot = rng.normal(size=(B, 7)).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(12)}
    maskfs = []
    orig = jkf.kron_matmul_dropout

    def record(o1, o2, w, b, maskf):
        maskfs.append(np.asarray(maskf))
        return orig(o1, o2, w, b, maskf)

    monkeypatch.setattr(jkf, "kron_matmul_dropout", record)
    masks = _jax_masks(jmod, variables, xs, rngs)
    monkeypatch.setattr(jkf, "kron_matmul_dropout", orig)
    assert len(masks) == 4 and len(maskfs) == 1
    maskf = maskfs[0]
    assert maskf.shape == (B, 9 * 9)
    assert set(np.unique(maskf)) == {0.0, np.float32(1 / KEEP)}
    want = _jax_out_and_input_grads(jmod, variables, xs, cot, rngs)
    queue = _feed_masks(port, masks)
    drawn = []

    def draw_rows(fn, n):
        drawn.append(n)
        return torch.from_numpy(maskf)

    monkeypatch.setattr(pfusion, "draw_rows", draw_rows)
    _assert_close(_port_out_and_input_grads(port, xs, cot), want)
    assert not queue and drawn == [B]


def _alpha_masks(inputs, outputs):
    """The keep masks of the port's ``AlphaDropout`` calls, read from their
    outputs: a dropped unit takes ``a * alpha * (p - 1)``."""
    alpha = 1.7580993408473766
    a = ((alpha ** 2 * RATE + 1) * KEEP) ** -0.5
    dropped = a * alpha * (RATE - 1)
    masks = []
    for x, y in zip(inputs, outputs):
        mask = ~np.isclose(y, dropped, rtol=0, atol=1e-6)
        # no kept unit lands on that value: its input would be -alpha
        assert not np.isclose(x[mask], -alpha, rtol=0, atol=1e-4).any()
        masks.append(mask)
    return masks


def test_maxnet_alpha_dropout_matches_jax(monkeypatch):
    """MaxNet in train mode: the port's four ``nn.AlphaDropout`` draws fed
    to the JAX ``AlphaDropout``; features, hazard, prediction and the
    input gradient; each draw's drop rate near 0.25."""
    jmod = jm.MaxNet(omic_dim=16, label_dim=3, dropout_rate=RATE,
                     act_type="LSM")
    port = pm.MaxNet(omic_dim=16, label_dim=3, dropout_rate=RATE,
                     act_type="LSM")
    variables, (x,), rng = _pair(jmod, port, (80,), seed=21)
    cot = rng.normal(size=(B, 3)).astype(np.float32)
    seen = []
    for m in port.modules():
        if isinstance(m, torch.nn.AlphaDropout):
            assert m.p == RATE
            m.register_forward_hook(lambda m, inp, out: seen.append(
                (inp[0].detach().numpy().copy(),
                 out.detach().numpy().copy())))
    torch.manual_seed(5)
    tx = torch.tensor(x, requires_grad=True)
    got = port.train()(tx)
    (got[1] * torch.from_numpy(cot)).sum().backward()
    assert len(seen) == 4
    masks = _alpha_masks(*zip(*seen))
    for m in masks:
        assert 0.1 < 1 - m.mean() < 0.4
    queue = [jnp.asarray(m) for m in masks]

    def bernoulli(key, p, shape):
        assert p == KEEP and tuple(shape) == queue[0].shape
        return queue.pop(0)

    monkeypatch.setattr(jcommon.jax.random, "bernoulli", bernoulli)

    def loss(x):
        out = jmod.apply(variables, x, train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.sum(out[1] * cot), out

    (_, want), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(x))
    assert not queue
    for name, g, w in zip(("features", "hazard", "pred"), got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), grad, **TOL,
                               err_msg="input grad")
