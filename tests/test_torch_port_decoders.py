"""The decoders and parameter freezing of the port against the JAX
package's.

``ResnetDecoder`` in eval and in train mode (batch statistics and the new
running ones), with input and parameter gradients; ``MaxNetDecoder``;
``freeze_mask``/``count_frozen`` against ``train/freeze.py`` of the JAX
package; and two Adam steps of ``masked_optimizer`` with ``omic_net``
frozen, which leave it bitwise unchanged and move every other parameter
as optax's ``multi_transform`` does.

The flax ``ConvTranspose(4, strides=2, padding="SAME")`` of the decoder is
the port's ``ConvTranspose2d(4, stride=2, padding=1)`` with the kernel
flipped in both spatial axes; an unflipped kernel gives the same shapes
and other values, which the eval case would catch.

Tolerances: rtol 1e-5 / atol 1e-6 (fp32) for MaxNetDecoder and the
optimizer steps (which take the same gradients in both packages).  The
decoder's six transposed convolutions sum in another order in XLA and in
torch, so its outputs and gradients are held at rtol 1e-4 / atol 1e-5,
and the gradients per tensor with an atol of 1e-5 of their largest
element; in train mode its five BatchNorms normalise by the batch's
variance, which flax computes as E[x^2] - E[x]^2 and torch in two
passes, so there rtol 1e-3 / atol 1e-4 and the biases of the
convolutions that feed a BatchNorm (exact gradient 0) are held at 0 in
both packages at 1e-4 of their layer's weight gradient.  The decoder's
train mode is also run in float64 on both sides, at rtol 1e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from multimodal_learning_tpu import models as jm
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu.train.freeze import (
    count_frozen as j_count_frozen, freeze_mask as j_freeze_mask,
    masked_optimizer as j_masked_optimizer)
from multimodal_learning_tpu_torch import models as pm
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models.import_flax import (
    flax_from_state_dict, state_dict_from_flax)
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.freeze import (count_frozen,
                                                        freeze_mask,
                                                        masked_optimizer)
from test_torch_port_fusions import _close_trees64, _to64, x64  # noqa: F401
from test_torch_port_models import _assert_tree_equal, _perturbed

TOL = dict(rtol=1e-5, atol=1e-6)
DECODER_TOL = dict(rtol=1e-4, atol=1e-5)
DECODER_BN_TOL = dict(rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_resnet_decoder_matches_jax(train):
    rng = np.random.default_rng(3 + train)
    z = rng.normal(size=(4, 16)).astype(np.float32)
    cot = rng.normal(size=(4, 128, 128, 3)).astype(np.float32)
    jmod = jm.ResnetDecoder(latent_dim=16)
    params, stats = _perturbed(
        jmod.init(jax.random.PRNGKey(1), jnp.asarray(z), train=False), 2)
    port = pm.ResnetDecoder(latent_dim=16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train(train)
    _assert_tree_equal(flax_from_state_dict(port.state_dict()),
                       (params, stats))

    def loss(p, x):
        out, new = jmod.apply({"params": p, "batch_stats": stats}, x,
                              train=train, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new)

    (_, (want, new_vars)), (g_params, g_z) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(z))
    tz = torch.tensor(z, requires_grad=True)
    got = port(tz)
    (got * torch.from_numpy(cot)).sum().backward()
    tol = DECODER_BN_TOL if train else DECODER_TOL
    assert got.shape == (4, 128, 128, 3)
    assert float(got.abs().max()) <= 1.0
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    np.testing.assert_allclose(tz.grad.numpy(), g_z, **tol)
    want_grads = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, g_params), stats)
    for name, p in port.named_parameters():
        want_g = want_grads[name].numpy()
        weight = want_grads[name.replace(".bias", ".weight")].numpy()
        atol = max(tol["atol"], 1e-5 * float(np.abs(weight).max()))
        if train and name.startswith("up") and name.endswith(".bias"):
            for bias in (p.grad.numpy(), want_g):   # feeds a BatchNorm
                np.testing.assert_allclose(bias, 0.0,
                                           atol=max(atol, 1e-4 * float(
                                               np.abs(weight).max())),
                                           err_msg=name)
            continue
        np.testing.assert_allclose(p.grad.numpy(), want_g,
                                   rtol=tol["rtol"], atol=atol,
                                   err_msg=name)
    if train:
        want_sd = state_dict_from_flax(params, new_vars["batch_stats"])
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want_sd[name], **tol,
                                           err_msg=name)



def test_resnet_decoder_train_float64_matches_jax(x64):
    """The train-mode case that ``DECODER_BN_TOL`` loosens, in float64 on
    both sides: the transposed convolutions' summation order and the
    BatchNorm variance formulas leave float64 rounding, held at rtol 1e-10
    (atol 1e-12 of each layer's largest element; see
    ``test_torch_port_fusions._close_trees64``)."""
    rng = np.random.default_rng(4)
    z = rng.normal(size=(4, 16))
    cot = rng.normal(size=(4, 128, 128, 3))
    jmod = jm.ResnetDecoder(latent_dim=16)
    params, stats = _perturbed(
        jmod.init(jax.random.PRNGKey(1), jnp.asarray(z, jnp.float32),
                  train=False), 2)                 # float32 values
    port = pm.ResnetDecoder(latent_dim=16)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.double().train()
    params, stats = _to64(params), _to64(stats)

    def loss(p, x):
        out, new = jmod.apply({"params": p, "batch_stats": stats}, x,
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, new)

    (_, (want, new_vars)), (g_params, g_z) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(z))
    tz = torch.tensor(z, requires_grad=True)
    got = port(tz)
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    (got * torch.from_numpy(cot)).sum().backward()
    _close_trees64({"out": got.detach().numpy(), "z": tz.grad.numpy()},
                   {"out": want, "z": g_z}, "forward")
    grad_sd = dict(port.state_dict())
    grad_sd.update({n: p.grad for n, p in port.named_parameters()})
    _close_trees64(flax_from_state_dict(grad_sd)[0], g_params, "grads")
    _close_trees64(flax_from_state_dict(port.state_dict())[1],
                   new_vars["batch_stats"], "batch_stats")

def test_maxnet_decoder_matches_jax():
    rng = np.random.default_rng(7)
    z = rng.normal(size=(5, 16)).astype(np.float32)
    jmod = jm.MaxNetDecoder(omic_dim=16, output_dim=80)
    params, _ = _perturbed(jmod.init(jax.random.PRNGKey(0), jnp.asarray(z),
                                     train=False), 1)
    port = pm.MaxNetDecoder(omic_dim=16, output_dim=80)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    _assert_tree_equal(flax_from_state_dict(port.state_dict())[0], params)
    want = jmod.apply({"params": params}, jnp.asarray(z), train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(z))
    assert got.dtype == torch.float32 and got.shape == (5, 80)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # train mode draws the AlphaDropout masks; at rate 0 it is the eval map
    port0 = pm.MaxNetDecoder(omic_dim=16, output_dim=80, dropout_rate=0.0)
    port0.load_state_dict(port.state_dict())
    np.testing.assert_allclose(port0.train()(torch.from_numpy(z)).detach()
                               .numpy(), want, **TOL)


DIMS = dict(mode="pathomic", path_dim=8, omic_dim=8, mmhid=8, label_dim=3,
            input_size_path=32, niter_decay=10, lr=1e-2, beta1=0.9)
KEY_SETS = [("omic_net",), ("path_net",), ("fusion", "classifier"),
            ("bn1", "fc_new2", "conv1")]


def _jax_pathomic(seed):
    jmod = jm.PathomicModel(path_dim=8, omic_dim=8, mmhid=8, label_dim=3)
    variables = jmod.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        x_path=jnp.zeros((1, 32, 32, 3)), x_omic=jnp.zeros((1, 80)),
        train=False)
    return _perturbed(variables, seed + 2)


@pytest.mark.parametrize("keys", KEY_SETS, ids="-".join)
def test_freeze_mask_and_count_match_jax(keys):
    params, stats = _jax_pathomic(0)
    port = pm.PathomicModel(path_dim=8, omic_dim=8, mmhid=8, label_dim=3)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    assert count_frozen(port, keys) == j_count_frozen(params, keys) > 0
    mask = freeze_mask(port, keys)
    # the JAX mask as arrays of each leaf's shape, carried to torch names
    want = state_dict_from_flax(jax.tree_util.tree_map(
        lambda trainable, x: np.full(np.shape(x), float(trainable),
                                     np.float32),
        j_freeze_mask(params, keys), params), stats)
    assert set(mask) == {n for n, _ in port.named_parameters()}
    for name, trainable in mask.items():
        assert trainable == bool(want[name].flatten()[0]), name


def test_masked_adam_freezes_omic_net_as_optax_does():
    """Two steps from the same parameters and the same gradients (drawn
    from a seed, one set per step): the port's frozen ``omic_net`` stays
    bitwise, gets no gradient and no Adam state; every other parameter
    lands where optax's masked Adam puts it."""
    params, stats = _jax_pathomic(3)
    keys = ("omic_net",)
    jopt, opt = JOptions(**DIMS), Options(**DIMS)
    tx = j_masked_optimizer(j_optim(jopt, j_sched(jopt, 5)), params, keys)
    opt_state = tx.init(params)
    port = pm.PathomicModel(path_dim=8, omic_dim=8, mmhid=8, label_dim=3)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    frozen_before = {n: p.detach().clone()
                     for n, p in port.named_parameters()
                     if n.startswith("omic_net.")}
    optimizer = masked_optimizer(opt, port, make_lr_schedule(opt, 5), keys)
    rng = np.random.default_rng(8)
    for _ in range(2):
        grads = jax.tree_util.tree_map(
            lambda x: rng.normal(size=np.shape(x)).astype(np.float32),
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        tgrads = state_dict_from_flax(grads, stats)
        optimizer.zero_grad()
        for n, p in port.named_parameters():
            if p.requires_grad:
                p.grad = tgrads[n].clone()
        optimizer.step()
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                stats)
    adam_state = optimizer.optimizer.state
    for n, p in port.named_parameters():
        if n.startswith("omic_net."):
            assert not p.requires_grad and p.grad is None
            assert p not in adam_state
            assert torch.equal(p, frozen_before[n]), n
            assert torch.equal(want[n], frozen_before[n]), n
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                       **TOL, err_msg=n)
