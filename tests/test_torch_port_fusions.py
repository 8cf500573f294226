"""The polynomial, trilinear, LMF and HFB fusions of the port against the
JAX package's flax modules, on the same numpy-seeded inputs and bridged
weights.

Each fusion's forward in eval and in train mode (dropout 0: the RNG
streams of the two packages differ), with the gradients of a fixed
cotangent with respect to the inputs and every parameter, and the new
BatchNorm statistics; ``PathomicModel`` with each type; two teacher
train steps with ``polynomial_fusion`` and with ``LMF`` against the JAX
``build_teacher_train_step``; and the weight bridge, which raises on an
entry it does not consume.

Tolerances: the fusions alone hold rtol 1e-5 / atol 1e-6 (fp32, sums of at
most a few hundred terms), but for the polynomial fusion in train mode,
held at rtol 5e-4 / atol 1e-5: its three BatchNorms normalise by the
batch's variance, which flax computes as E[x^2] - E[x]^2 and torch in two
passes, and over a batch of 6 that moves outputs and gradients by up to
1.3e-4 of their value (4.5e-6 absolute); the weight gradient of a Linear
that feeds such a BatchNorm is the small difference of large terms after
its backward, so each of its tensors also gets an atol of 2e-5 of its
largest element (5.3e-5 measured on elements of up to 6), and its bias,
whose exact gradient is 0 (the batch mean removes it), is held at 0 in
both packages at that same atol.  The whole model and the train
steps hold the tolerances of ``tests/test_torch_port_step.py`` and
``tests/test_torch_port_student.py``: rtol 2e-3 / atol 5e-4 for outputs,
losses and BatchNorm statistics, because the ResNet's convolutions sum in
another order in XLA and in torch; Adam's first moment per tensor at rtol
2e-3 with an atol of 2e-3 of its largest element, but the ResNet trunk's
(all of ``path_net`` but the ``fc_new`` heads) by the norm of the
difference at 1e-1 of the JAX tensor's norm, for the ReLU-kink flips that
the student test's docstring measures.  The polynomial fusion's train
mode is also run in float64 on both sides (``jax.enable_x64``, the port's
``.double()``), where the BatchNorm formulas leave float64 rounding only:
rtol 1e-10.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu_torch.train.steps as psteps
from multimodal_learning_tpu import models as jm
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch import models as pm
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.models.import_flax import (
    flax_from_state_dict, state_dict_from_flax)
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)
from test_torch_port_models import FIELDS, _perturbed
from test_torch_port_step import (DIMS, N_DATA, SIZE, WHOLE, _batch,
                                  _jax_tree, no_onednn_convs)  # noqa: F401

FUSION_TOL = dict(rtol=1e-5, atol=1e-6)
BN_TRAIN_TOL = dict(rtol=5e-4, atol=1e-5)


def _cases():
    """name -> (JAX module, port module, input widths), dropout 0 so the
    train mode is deterministic.  Widths differ between the inputs where
    the module allows it, so a swapped pair fails on shape as well as on
    value."""
    cases = {}
    for skip in (0, 1):
        for bil in (0, 1):
            kw = dict(skip=skip, use_bilinear=bil, dim1=8, dim2=6, mmhid=7,
                      dropout_rate=0.0)
            cases[f"polynomial_skip{skip}_bilinear{bil}"] = (
                jm.PolynomialFusion(**kw), pm.PolynomialFusion(**kw), (8, 6))
    for variant in ("A", "B"):
        kw = dict(variant=variant, dim1=6, dim2=5, dim3=6, mmhid=7,
                  dropout_rate=0.0)
        cases[f"trilinear_{variant}"] = (jm.TrilinearFusion(**kw),
                                         pm.TrilinearFusion(**kw), (6, 5, 6))
    kw = dict(dim1=8, dim2=6, mmhid=7, dropout_rate=0.0)
    cases["lmf"] = (jm.LMFusion(**kw, rank=4), pm.LMFusion(**kw, rank=4),
                    (8, 6))
    cases["hfb"] = (jm.HFBFusion(**kw, rank=5), pm.HFBFusion(**kw, rank=5),
                    (8, 6))
    return cases


CASES = sorted(_cases())


def _named_grads(module):
    return {n: p.grad for n, p in module.named_parameters()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", CASES)
def test_fusion_forward_and_gradients_match_jax(case, train):
    jmod, port, widths = _cases()[case]
    rng = np.random.default_rng(len(case) + 10 * train)
    xs = [rng.normal(size=(6, w)).astype(np.float32) for w in widths]
    cot = rng.normal(size=(6, 7)).astype(np.float32)
    variables = jmod.init({"params": jax.random.PRNGKey(3),
                           "dropout": jax.random.PRNGKey(4)},
                          *map(jnp.asarray, xs), train=False)
    params, stats = _perturbed(variables, 5)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.train(train)

    def loss(p, *x):
        out = jmod.apply({"params": p, "batch_stats": stats}, *x,
                         train=train, mutable=["batch_stats"])
        return jnp.sum(out[0] * cot), out

    (_, (want, new_vars)), grads = jax.value_and_grad(
        loss, argnums=tuple(range(len(xs) + 1)), has_aux=True)(
            params, *map(jnp.asarray, xs))
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    got = port(*txs)
    (got * torch.from_numpy(cot)).sum().backward()

    tol = BN_TRAIN_TOL if train and stats else FUSION_TOL
    np.testing.assert_allclose(got.detach().numpy(), want, **tol)
    for t, g in zip(txs, grads[1:]):
        np.testing.assert_allclose(t.grad.numpy(), g, **tol)
    want_grads = state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, grads[0]), stats)
    for name, g in _named_grads(port).items():
        want_g = want_grads[name].numpy()
        atol = tol["atol"]
        if tol is BN_TRAIN_TOL:
            weight = want_grads[name.replace(".bias", ".weight")].numpy()
            atol = max(atol, 2e-5 * float(np.abs(weight).max()))
            if name.startswith("encoder") and name.endswith(".0.bias"):
                for bias in (g.numpy(), want_g):   # feeds a BatchNorm
                    np.testing.assert_allclose(bias, 0.0, atol=atol,
                                               err_msg=name)
                continue
        np.testing.assert_allclose(g.numpy(), want_g, rtol=tol["rtol"],
                                   atol=atol, err_msg=name)
    if train and stats:
        want_sd = state_dict_from_flax(params, new_vars["batch_stats"])
        for name, buf in port.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(buf.numpy(), want_sd[name],
                                           **tol, err_msg=name)



@pytest.fixture
def x64():
    """JAX in float64 for one test."""
    with jax.enable_x64(True):
        yield


def _to64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def _close_trees64(got, want, what):
    """Two flax-layout trees at rtol 1e-10, each leaf with an atol of 1e-12
    of the largest element of its layer (the biases that feed a BatchNorm
    have an exact gradient of 0, so both sides hold float64 noise)."""
    got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    want = jax.tree_util.tree_flatten_with_path(_to64(want))[0]
    assert len(got) == len(want), what
    layer_max = {}
    for path, w in want:
        layer_max[path[:-1]] = max(layer_max.get(path[:-1], 0.0),
                                   float(np.abs(w).max()))
    for path, w in want:
        g = np.asarray(got[path])
        assert g.dtype == np.float64, (what, path)
        np.testing.assert_allclose(g, w, rtol=1e-10,
                                   atol=1e-12 * layer_max[path[:-1]],
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c.startswith("polynomial")])
def test_polynomial_fusion_train_float64_matches_jax(case, x64):
    """The train-mode case that ``BN_TRAIN_TOL`` loosens, in float64 on
    both sides: what is left of the two packages' BatchNorm variance
    formulas is float64 rounding, held at rtol 1e-10 (atol: see
    ``_close_trees64``).  Gradients and statistics are compared in the
    flax layout, which the bridge fills without a cast to float32."""
    jmod, port, widths = _cases()[case]
    rng = np.random.default_rng(len(case) + 10)
    xs = [rng.normal(size=(6, w)) for w in widths]
    cot = rng.normal(size=(6, 7))
    variables = jmod.init({"params": jax.random.PRNGKey(3),
                           "dropout": jax.random.PRNGKey(4)},
                          *map(jnp.asarray, xs), train=False)
    params, stats = _perturbed(variables, 5)    # float32 values
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.double().train()
    params, stats = _to64(params), _to64(stats)

    def loss(p, *x):
        out = jmod.apply({"params": p, "batch_stats": stats}, *x,
                         train=True, mutable=["batch_stats"])
        return jnp.sum(out[0] * cot), out

    (_, (want, new_vars)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=tuple(range(len(xs) + 1)), has_aux=True))(
            params, *map(jnp.asarray, xs))
    txs = [torch.tensor(x, requires_grad=True) for x in xs]
    got = port(*txs)
    assert got.dtype == torch.float64 and want.dtype == jnp.float64
    (got * torch.from_numpy(cot)).sum().backward()
    _close_trees64({"out": got.detach().numpy(),
                    "inputs": [t.grad.numpy() for t in txs]},
                   {"out": want, "inputs": list(grads[1:])}, "forward")
    grad_sd = dict(port.state_dict())
    grad_sd.update({n: p.grad for n, p in port.named_parameters()})
    _close_trees64(flax_from_state_dict(grad_sd)[0], grads[0], "grads")
    _close_trees64(flax_from_state_dict(port.state_dict())[1],
                   new_vars["batch_stats"], "batch_stats")

def _pathomic_pair(fusion_type, seed):
    dims = dict(path_dim=16, omic_dim=16, mmhid=16, label_dim=3,
                fusion_type=fusion_type)
    jmod = jm.PathomicModel(**dims)
    variables = jmod.init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)},
        x_path=jnp.zeros((1, 64, 64, 3)), x_omic=jnp.zeros((1, 80)),
        train=False)
    params, stats = _perturbed(variables, seed + 2)
    port = pm.PathomicModel(**dims)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jmod, params, stats, port.eval()


@pytest.mark.parametrize("fusion_type", ["polynomial_fusion", "LMF", "HFB"])
def test_pathomic_model_eval_matches_jax(fusion_type):
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    om = rng.normal(size=(2, 80)).astype(np.float32)
    jmod, params, stats, port = _pathomic_pair(fusion_type, 22)
    want = jmod.apply({"params": params, "batch_stats": stats},
                      x_path=jnp.asarray(x), x_omic=jnp.asarray(om),
                      train=False)
    with torch.no_grad():
        got = port(x_path=torch.from_numpy(x), x_omic=torch.from_numpy(om))
    for name in FIELDS:
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), **WHOLE,
                                   err_msg=name)


def _bias_before_bn(tree_path: str) -> bool:
    """Biases that feed a train-mode BatchNorm: their exact gradient is 0,
    so both packages' moments are rounding noise of about 1e-6 (the step
    test holds them at 5e-6)."""
    return tree_path in {
        "['model']['path_net']['fc_new1']['bias']",
        *(f"['model']['fusion']['encoder{j}']['bias']" for j in (1, 2, 3))}


def _assert_moments_close(got, want, what):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        key, a, b = jax.tree_util.keystr(path), np.asarray(a), np.asarray(b)
        if key.startswith("['model']['path_net']") and "fc_new" not in key:
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-1, f"{what}{key}: |diff| / |jax| = {rel:.3e}"
            continue
        atol = max(1e-6, 2e-3 * float(np.abs(b).max(initial=0.0)))
        if _bias_before_bn(key):
            atol = max(atol, 5e-6)
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=atol,
                                   err_msg=f"{what}{key}")


def _assert_stats_close(got, want, what):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), **WHOLE,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("fusion_type", ["polynomial_fusion", "LMF"])
def test_two_teacher_steps_match_jax(fusion_type, no_onednn_convs,
                                     monkeypatch):
    """Two steps of the ``recipes/baseline.py`` teacher (CRD off,
    ``cut_fuse_grad``, pred-KD, beta1 0.9) with ``fusion_type`` in place of
    pofusion.  The JAX state after step 1 is carried over again before
    step 2: Adam's first update is lr * sign(g), and a gradient that is
    rounding noise may flip sign between the frameworks."""
    flags = dict(CRD_distill=0, pred_distill=1, cut_fuse_grad=True,
                 beta1=0.9, fusion_type=fusion_type)
    jopt, opt = JOptions(**DIMS, **flags), Options(**DIMS, **flags)
    jmodel = j_define(jopt)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jsteps.init_teacher_state(
        jopt, jmodel, tx, jax.random.PRNGKey(11), N_DATA,
        {"x_path": jnp.zeros((1, SIZE, SIZE, 3)),
         "x_omic": jnp.zeros((1, 80))})
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 50), N_DATA,
                                      device="cpu")
    # the batches carry the augmented views themselves (a jitted step
    # would bake a closure's views in at its first call)
    monkeypatch.setattr(jsteps, "augment_views", lambda key, v, dtype=None: v)
    monkeypatch.setattr(psteps, "augment_views", lambda gen, v, dtype=None: v)
    jstep = jsteps.build_teacher_train_step(jopt, jmodel, tx)
    step = psteps.build_teacher_train_step(opt)
    for i in range(2):
        load_jax_state(state, _jax_tree(jstate))
        batch, views = _batch(seed=31 + i)
        batch["path_views"] = views
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                 jax.random.PRNGKey(i), jnp.asarray(0.1))
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, 0.1)
        assert set(metrics) == set(jmetrics)
        for k in jmetrics:
            np.testing.assert_allclose(metrics[k].numpy(), jmetrics[k],
                                       **WHOLE, err_msg=f"step {i} {k}")
        got, want = jax_state_tree(state), _jax_tree(jstate)
        assert got["step"] == want["step"] == i + 1
        assert got["adam"]["count"] == want["adam"]["count"] == i + 1
        _assert_stats_close(got["batch_stats"], want["batch_stats"],
                            f"step {i} batch_stats")
        _assert_stats_close(got["ema_batch_stats"], want["ema_batch_stats"],
                            f"step {i} ema_batch_stats")
        _assert_moments_close(got["adam"]["mu"], want["adam"]["mu"],
                              f"step {i} exp_avg")
        assert "fusion" in got["params"]["model"]


@pytest.mark.parametrize("fusion_type",
                         ["polynomial_fusion", "LMF", "HFB", "trilinear"])
def test_bridge_raises_on_what_it_does_not_consume(fusion_type):
    if fusion_type == "trilinear":
        port = pm.TrilinearFusion(dim1=6, dim2=5, dim3=6, mmhid=7)
    else:
        port = pm.PathomicModel(path_dim=8, omic_dim=8, mmhid=8,
                                fusion_type=fusion_type)
    sd = port.state_dict()
    params, stats = flax_from_state_dict(sd)
    kept = lambda keys: {k for k in keys
                         if not k.endswith("num_batches_tracked")}
    assert kept(state_dict_from_flax(params, stats)) == kept(sd)
    fusion = params["fusion"] if "fusion" in params else params
    prefix = "fusion." if "fusion" in params else ""
    with pytest.raises(ValueError, match="no mapping consumes"):
        flax_from_state_dict({**sd, f"{prefix}encoder4.0.weight":
                              torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="no mapping consumes"):
        flax_from_state_dict({**sd, f"{prefix}factor3": torch.zeros(2)})
    fusion["unit9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(ValueError, match="no mapping consumes"):
        state_dict_from_flax(params, stats)
    del fusion["unit9"]
    stats.setdefault("fusion" if prefix else "x", {})["stray_bn"] = {
        "mean": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="no mapping consumes"):
        state_dict_from_flax(params, stats)
