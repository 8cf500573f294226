"""The mmdynamics model of the port against the JAX package's.

``MMDynamic`` (loss, fused logits, TCP logits, gradients), its dropout
law, two mmdynamics train steps against ``build_mmdynamics_train_step``,
the eval step and ``make_infer_fn``, the ``train_cv_MT -> test_cv_MT``
chain with exact reproduction, ``export_model -> predict``, and a fold the
JAX ``train_teacher`` wrote, evaluated by the port's ``test_cv_MT``.

Dropout: the two packages draw from different RNG streams, and
``PathomicDynamicsModel`` fixes MMDynamic's dropout at 0.5 whatever
``--dropout_rate`` says.  The steps are held with dropout 0: in the JAX
package through a test-local subclass whose MMDynamic has ``dropout=0.0``,
in the port by setting the module's ``p``.  The dropout path itself is
held by capturing the JAX masks (``flax.linen.intercept_methods``) and
applying them in the port.

Tolerances: MMDynamic alone at rtol 1e-5 / atol 1e-6 (fp32, short sums);
the whole model, the steps and the CLIs at the tolerances of
``tests/test_torch_port_fusions.py`` (rtol 2e-3 / atol 5e-4 for outputs,
losses and BatchNorm statistics: the ResNet's convolutions sum in another
order; Adam's first moment per tensor at rtol 2e-3 with an atol of 2e-3
of its largest element, the ResNet trunk's by norm at 1e-1).
"""
import os

import numpy as np
import pytest
import torch

import flax.linen as fnn
import jax
import jax.numpy as jnp

import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu_torch.train.steps as psteps
from multimodal_learning_tpu import models as jm
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.serve.export import \
    make_infer_fn as j_make_infer_fn
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch import models as pm
from multimodal_learning_tpu_torch.config import Options, parse_args
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.models.import_flax import (
    flax_from_state_dict, state_dict_from_flax)
from multimodal_learning_tpu_torch.serve import make_infer_fn
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)
from test_torch_port_fusions import (FUSION_TOL, _assert_moments_close,
                                     _assert_stats_close)
from test_torch_port_models import _assert_tree_equal, _perturbed
from test_torch_port_step import (DIMS, N_DATA, SIZE, WHOLE, _batch,
                                  _jax_tree, no_onednn_convs)  # noqa: F401

DYN = dict(fusion_type="mmdynamics", CRD_distill=0, pred_distill=0,
           reg_type="all")


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads (see ``tests/test_torch_port_loop.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _mmdynamic_pair(dropout, seed=0):
    jmod = jm.MMDynamic(dim_list=(8, 6), hidden_dim=(7,), num_class=3,
                        dropout=dropout)
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(10, d)).astype(np.float32) for d in (8, 6)]
    labels = rng.integers(0, 3, 10).astype(np.int32)
    variables = jmod.init({"params": jax.random.PRNGKey(seed),
                           "dropout": jax.random.PRNGKey(seed + 1)},
                          [jnp.asarray(f) for f in feats], train=False,
                          infer=True)
    params, _ = _perturbed(variables, seed + 2)
    port = pm.MMDynamic((8, 6), hidden_dim=(7,), num_class=3,
                        dropout=dropout)
    port.load_state_dict(state_dict_from_flax(params), strict=True)
    return jmod, params, port, feats, labels


def _jax_loss_and_grads(jmod, params, feats, labels, **apply_kw):
    def loss(p, f0, f1):
        out = jmod.apply({"params": p}, [f0, f1], jnp.asarray(labels),
                         train=True, **apply_kw)
        return out[0], out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(
        params, *map(jnp.asarray, feats))
    return out, grads


def _assert_port_matches(port, feats, labels, want, grads, tol):
    tf = [torch.tensor(f, requires_grad=True) for f in feats]
    loss, logit, tcp = port(tf, torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(loss.item(), want[0], **tol)
    np.testing.assert_allclose(logit.detach().numpy(), want[1], **tol)
    assert len(tcp) == len(want[2]) == 2
    for a, b in zip(tcp, want[2]):
        np.testing.assert_allclose(a.detach().numpy(), b, **tol)
    for t, g in zip(tf, grads[1:]):
        np.testing.assert_allclose(t.grad.numpy(), g, **tol)
    want_grads = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                             grads[0]))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(),
                                   **tol, err_msg=name)


def test_mmdynamic_loss_logits_and_gradients_match_jax():
    jmod, params, port, feats, labels = _mmdynamic_pair(dropout=0.0)
    want, grads = _jax_loss_and_grads(jmod, params, feats, labels)
    _assert_port_matches(port.train(), feats, labels, want, grads,
                         FUSION_TOL)
    # infer, or no labels: the fused logits alone
    with torch.no_grad():
        infer = port.eval()([torch.from_numpy(f) for f in feats], infer=True)
        no_labels = port([torch.from_numpy(f) for f in feats])
    j_infer = jmod.apply({"params": params}, [jnp.asarray(f) for f in feats],
                         train=False, infer=True)
    np.testing.assert_allclose(infer.numpy(), j_infer, **FUSION_TOL)
    assert torch.equal(infer, no_labels)


def test_mmdynamic_dropout_masks_from_jax():
    """The JAX module's three dropout masks (one per modality, one after
    the hidden layer), captured and applied in the port, give the same
    loss, logits and gradients; and both packages' masks follow the same
    law: zero with probability 0.5, else 2."""
    jmod, params, port, feats, labels = _mmdynamic_pair(dropout=0.5, seed=4)
    seen = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout):
            seen.append((np.asarray(args[0]), np.asarray(out)))
        return out

    rngs = {"dropout": jax.random.PRNGKey(9)}
    # the masks are a function of the key: captured from a plain forward,
    # they are the ones the differentiated forward draws
    with fnn.intercept_methods(capture):
        jmod.apply({"params": params}, [jnp.asarray(f) for f in feats],
                   jnp.asarray(labels), train=True, rngs=rngs)
    assert len(seen) == 3
    want, grads = _jax_loss_and_grads(jmod, params, feats, labels,
                                      rngs=rngs)
    masks = [np.where(x == 0, 2.0, np.where(y == 0, 0.0, 2.0)).astype(
        np.float32) for x, y in seen]
    for x, y in seen:
        np.testing.assert_allclose(y[x != 0] / x[x != 0] * 0.5,
                                   (y[x != 0] != 0).astype(np.float32),
                                   rtol=1e-6)
    queue = [torch.from_numpy(m) for m in masks]
    port.drop.register_forward_hook(lambda m, inp, out: inp[0] * queue.pop(0))
    _assert_port_matches(port.train(), feats, labels, want, grads,
                         FUSION_TOL)
    assert not queue

    # the port's own law, on a wide input
    drawn = []
    hook = lambda m, inp, out: drawn.append(out / inp[0])   # noqa: E731
    wide = pm.MMDynamic((512, 512), hidden_dim=(256,), dropout=0.5)
    wide.drop.register_forward_hook(hook)
    g = torch.Generator().manual_seed(0)
    wide.train()([torch.rand(64, 512, generator=g) + 0.5] * 2)
    ratios = torch.cat([d[torch.isfinite(d)].flatten() for d in drawn])
    assert set(torch.unique(ratios).tolist()) <= {0.0, 2.0}
    assert abs(float((ratios == 0).float().mean()) - 0.5) < 0.02
    jax_zero = np.mean([np.mean(y[x != 0] == 0) for x, y in seen])
    assert abs(jax_zero - 0.5) < 0.25    # 10 x 8, 10 x 6, 10 x 7 draws


class _NoDropDynamics(jm.PathomicDynamicsModel):
    """The JAX model with MMDynamic's dropout at 0 (test-local: the
    package fixes it at 0.5)."""

    def setup(self):
        from multimodal_learning_tpu.models.maxnet import MaxNet
        from multimodal_learning_tpu.models.resnet import ResNet18
        self.path_net = ResNet18(path_dim=self.path_dim,
                                 num_classes=self.label_dim,
                                 act_type=self.act_type, dtype=self.dtype,
                                 paired=self.paired_conv)
        self.omic_net = MaxNet(input_dim=self.input_size_omic,
                               omic_dim=self.omic_dim,
                               dropout_rate=self.dropout_rate,
                               act_type=self.act_type,
                               label_dim=self.label_dim,
                               init_max=self.init_max, dtype=self.dtype)
        self.fusion = jm.MMDynamic(dim_list=(self.path_dim, self.omic_dim),
                                   hidden_dim=(self.mmhid,),
                                   num_class=self.label_dim, dropout=0.0)


def _jax_dynamics(jopt):
    return _NoDropDynamics(path_dim=jopt.path_dim, omic_dim=jopt.omic_dim,
                           mmhid=jopt.mmhid, label_dim=jopt.label_dim,
                           input_size_omic=jopt.input_size_omic,
                           dropout_rate=jopt.dropout_rate,
                           act_type=jopt.act_type)


def _port_dynamics(opt):
    model = define_model(opt)
    assert isinstance(model, pm.PathomicDynamicsModel)
    assert model.fusion.drop.p == 0.5       # fixed, whatever dropout_rate
    model.fusion.drop.p = 0.0
    return model


def _states(monkeypatch):
    jopt, opt = JOptions(**DIMS, **DYN), Options(**DIMS, **DYN)
    jmodel = _jax_dynamics(jopt)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jsteps.init_teacher_state(
        jopt, jmodel, tx, jax.random.PRNGKey(13), N_DATA,
        {"x_path": jnp.zeros((1, SIZE, SIZE, 3)),
         "x_omic": jnp.zeros((1, 80))})
    state = psteps.init_teacher_state(opt, _port_dynamics(opt),
                                      make_lr_schedule(opt, 50), N_DATA,
                                      device="cpu")
    load_jax_state(state, _jax_tree(jstate))
    # the batches carry the augmented views themselves (a jitted step
    # would bake a closure's views in at its first call)
    monkeypatch.setattr(jsteps, "augment_views", lambda key, v, dtype=None: v)
    monkeypatch.setattr(psteps, "augment_views", lambda gen, v, dtype=None: v)
    return jopt, opt, jmodel, tx, jstate, state


def test_two_mmdynamics_steps_match_jax(no_onednn_convs, monkeypatch):
    """Two steps of ``build_mmdynamics_train_step`` with L1 over the whole
    model; the JAX state after step 1 is carried over again before step 2
    (Adam's first update is lr * sign(g)).  The EMA model is left as it
    was, parameters and buffers, as the JAX step leaves ``ema_params``."""
    jopt, opt, jmodel, tx, jstate, state = _states(monkeypatch)
    jstep = jsteps.build_mmdynamics_train_step(jopt, jmodel, tx)
    step = psteps.build_mmdynamics_train_step(opt)
    for i in range(2):
        load_jax_state(state, _jax_tree(jstate))
        ema_before = {k: v.clone()
                      for k, v in state.ema_model.state_dict().items()}
        batch, views = _batch(seed=41 + i)
        batch["path_views"] = views
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                 jax.random.PRNGKey(i), jnp.asarray(0.1))
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, 0.1)
        assert set(metrics) == set(jmetrics) == {"loss", "correct_fuse"}
        for k in jmetrics:
            np.testing.assert_allclose(metrics[k].numpy(), jmetrics[k],
                                       **WHOLE, err_msg=f"step {i} {k}")
        got, want = jax_state_tree(state), _jax_tree(jstate)
        assert got["step"] == want["step"] == i + 1
        assert got["adam"]["count"] == want["adam"]["count"] == i + 1
        _assert_stats_close(got["batch_stats"], want["batch_stats"],
                            f"step {i} batch_stats")
        _assert_moments_close(got["adam"]["mu"], want["adam"]["mu"],
                              f"step {i} exp_avg")
        for k, v in state.ema_model.state_dict().items():
            assert torch.equal(v, ema_before[k]), k
        _assert_tree_equal(got["ema_params"], want["ema_params"])


def test_eval_step_and_infer_fn_match_jax():
    jopt, opt = JOptions(**DIMS, **DYN), Options(**DIMS, **DYN)
    jmodel = jm.PathomicDynamicsModel(path_dim=16, omic_dim=16, mmhid=16)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(2), "dropout": jax.random.PRNGKey(3)},
        jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1, 80)), train=False,
        infer=True)
    params, stats = _perturbed(variables, 4)
    model = define_model(opt)
    model.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    batch, _ = _batch(seed=5)
    jout, jparts = jsteps.build_eval_step(jopt, jmodel)(
        params, stats, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0))
    out, parts = psteps.build_eval_step(opt)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(parts) == set(jparts)
    for k in jparts:
        np.testing.assert_allclose(parts[k].numpy(), jparts[k], **WHOLE,
                                   err_msg=k)
    for k in out._fields:
        if getattr(jout, k) is None:
            assert getattr(out, k) is None, k
        else:
            np.testing.assert_allclose(getattr(out, k).numpy(),
                                       getattr(jout, k), **WHOLE, err_msg=k)
    x_path, x_omic = batch["path_views"][:, 0], batch["omic"]
    want = jax.jit(j_make_infer_fn(jopt, jmodel, params, stats))(x_path,
                                                                 x_omic)
    got = make_infer_fn(opt, model)(x_path, x_omic)
    assert set(got) == set(want) == {"pred_fuse"}
    assert got["pred_fuse"].dtype == torch.float32
    np.testing.assert_allclose(got["pred_fuse"].numpy(), want["pred_fuse"],
                               **WHOLE)


def test_weight_bridge_round_trips_mmdynamics():
    jmodel = jm.PathomicDynamicsModel(path_dim=8, omic_dim=8, mmhid=8)
    variables = jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 32, 32, 3)), jnp.zeros((1, 80)), train=False,
        infer=True)
    params, stats = _perturbed(variables, 2)
    port = pm.PathomicDynamicsModel(path_dim=8, omic_dim=8, mmhid=8)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    back_p, back_s = flax_from_state_dict(port.state_dict())
    _assert_tree_equal(back_p, params)
    _assert_tree_equal(back_s, stats)
    sd = dict(port.state_dict())
    sd["fusion.mm_clf2.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match="no mapping consumes"):
        flax_from_state_dict(sd)


CLI = ("--synthetic_data --synthetic_folds 1 --mode pathomic --task grad "
       "--batch_size 8 --input_size_path 64 --path_dim 16 --omic_dim 16 "
       "--mmhid 16 --fusion_type mmdynamics --CRD_distill 0 "
       "--pred_distill 0 --model_name md --reg_type none "
       "--paired_conv True").split()


def test_train_test_export_predict_chain(tmp_path, monkeypatch):
    """``train_cv_MT`` (2 epochs) -> ``test_cv_MT``, which reproduces the
    final training eval exactly; the JAX ``test_cv_MT`` on the port's fold
    agrees at the whole-model tolerance; ``export_model`` -> ``predict``
    serve ``{"pred_fuse"}`` equal to the eval's probabilities."""
    from multimodal_learning_tpu.cli import test_cv_MT as j_test_cv
    from multimodal_learning_tpu.config import parse_args as j_parse_args
    from multimodal_learning_tpu.data.splits import \
        make_synthetic_splits as j_make_splits
    from multimodal_learning_tpu_torch.cli import (export_model, predict,
                                                   test_cv_MT, train_cv_MT)
    from test_torch_port_serve import _write_images

    monkeypatch.setenv("MML_PLATFORM", "cpu")
    where = ["--checkpoints_dir", str(tmp_path)]
    trained = train_cv_MT.main(CLI + ["--niter_decay", "2"] + where)[1]
    assert set(trained["probs"]) == {"fuse", "path", "omic"}
    assert trained["probs"]["path"] is None
    assert trained["probs"]["omic"] is None
    tested = test_cv_MT.main(CLI + where)
    assert tested == {"fuse": [trained["metrics_fuse"]], "path": [],
                      "omic": []}
    opt = parse_args(CLI + where, save=False)
    res = test_cv_MT.run_fold(opt, train_cv_MT.load_data(opt), 1,
                              device="cpu")
    np.testing.assert_array_equal(res["probs"]["fuse"],
                                  trained["probs"]["fuse"])

    jopt = j_parse_args(CLI + where, save=False)
    want = j_test_cv.run_fold(jopt, j_make_splits(
        n_train=64, n_test=32, n_folds=1, roi_size=64, seed=jopt.seed), 1)
    np.testing.assert_allclose(res["probs"]["fuse"], want["probs"]["fuse"],
                               **WHOLE)
    assert res["acc_fuse"] == want["acc_fuse"]

    written = export_model.main(where + ["--exp_name", opt.exp_name,
                                         "--model_name", "md",
                                         "--export_batch", "4"])
    files = _write_images(str(tmp_path), 5, 3)
    csv = os.path.join(str(tmp_path), "omic.csv")
    omic = np.random.default_rng(4).normal(size=(5, 80)).astype(np.float32)
    np.savetxt(csv, omic, delimiter=",", comments="",
               header=",".join(f"g{j}" for j in range(80)))
    got = predict.main(["--artifact", written[0], "--images", *files,
                        "--omic_csv", csv, "--quiet"])
    assert set(got) == {"pred_fuse", "prob", "grade"}
    assert got["pred_fuse"].shape == (5, 3)
    np.testing.assert_allclose(got["prob"].sum(1), 1.0, rtol=1e-5)


def test_jax_fold_evaluated_by_port(tmp_path):
    """A fold the JAX ``train_teacher`` wrote (the flags of
    ``tests/test_extra_models.py::test_mmdynamics_training_runs``),
    evaluated by the port's ``test_cv_MT.run_fold``: the JAX final eval's
    metrics exactly, its probabilities at the whole-model tolerance."""
    from multimodal_learning_tpu.data import make_synthetic_splits as j_make
    from multimodal_learning_tpu.train.loop import train_teacher
    from multimodal_learning_tpu_torch.cli import test_cv_MT
    from multimodal_learning_tpu_torch.data.splits import \
        make_synthetic_splits

    flags = dict(mode="pathomic", fusion_type="mmdynamics", task="grad",
                 model_name="mmd", path_dim=16, omic_dim=16, mmhid=16,
                 input_size_path=32, batch_size=8, niter=0, niter_decay=1,
                 lr=1e-3, verbose=0, checkpoints_dir=str(tmp_path),
                 host_workers=2, reg_type="none", CRD_distill=0,
                 pred_distill=0)
    want, _ = train_teacher(JOptions(**flags), j_make(
        n_train=16, n_test=8, roi_size=32, seed=13), fold=1)
    got = test_cv_MT.run_fold(Options(**flags), make_synthetic_splits(
        n_train=16, n_test=8, roi_size=32, seed=13), 1, device="cpu")
    np.testing.assert_allclose(got["probs"]["fuse"], want["probs"]["fuse"],
                               **WHOLE)
    assert got["acc_fuse"] == want["acc_fuse"]
    assert list(got["metrics_fuse"]) == list(want["metrics_fuse"])
