"""One teacher train step, and the eval step, of the port against the JAX
package's, from the same state.

Both packages start from the JAX package's ``init_teacher_state``, carried
to the port by ``train.import_state.load_jax_state``; both get the same
batch and the same two augmented views (``augment_views`` is replaced in
both step modules, in this test only), with ``dropout_rate=0`` so no other
randomness enters.  The JAX side runs its Pallas Kronecker kernels in
interpret mode; the port takes their plain versions on the CPU.  ResNet18
at 64^2, path_dim = omic_dim = mmhid = feat_dim = 16, batch 4, nce_k 8,
n_data 32, ``pallas_fusion="train"``, fp32.

Three configurations: the JAX benchmark's (CRD on, pos_mode exact, two
teachers, L1 on omic_net), the same with ``paired_conv`` (the 64-channel
stage's convolutions through ``ops/paired_conv.py`` in the port and the
lane-paired convolutions in the JAX package), and the
``recipes/baseline.py`` teacher (CRD off, ``cut_fuse_grad``, beta1 0.9).

Tolerances: the loss parts, accuracy counts and the new BatchNorm
statistics at the whole-model rtol 2e-3 / atol 5e-4 (conv sums run in
another order in XLA and oneDNN).  Adam's first moment is linear in the
gradient, and the gradient carries the forward's differences through long
reductions, so an element of a weight's moment can differ by more than
1e-6 while its tensor agrees to 1e-4 of its largest element; each tensor
is held at rtol 2e-3 and an atol of 2e-3 times its largest element (at
least 1e-6).  The updated parameters are not compared elementwise: Adam's
first step is about lr * sign(g), and a gradient near zero may change
sign between the two frameworks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu_torch.train.steps as psteps
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)

SIZE, B, N_DATA, NCE_K = 64, 4, 32, 8
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, feat_dim=16, label_dim=3, batch_size=B,
            nce_k=NCE_K, n_data=N_DATA, pallas_fusion="train",
            dropout_rate=0.0, niter_decay=30)
CONFIGS = {
    "bench": dict(CRD_distill=1, pred_distill=1, num_teachers=2,
                  pos_mode="exact", nce_p=1, reg_type="omic"),
    "recipe_teacher": dict(CRD_distill=0, pred_distill=1, cut_fuse_grad=True,
                           beta1=0.9),
    # the benchmark's step with the 64-channel stage's convs through the
    # port's B5 route (ops/paired_conv.py) and the JAX package's pairing
    "bench_paired": dict(CRD_distill=1, pred_distill=1, num_teachers=2,
                         pos_mode="exact", nce_p=1, reg_type="omic",
                         paired_conv=True),
}
WHOLE = dict(rtol=2e-3, atol=5e-4)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Let the JAX modules reach the Pallas kernels, in interpret mode."""
    monkeypatch.setenv("MML_PALLAS_FORCE", "1")
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import multimodal_learning_tpu.ops.kron_fusion as kf
    monkeypatch.setattr(kf.pl, "pallas_call", patched)


def _batch(seed):
    rng = np.random.default_rng(seed)
    index = rng.choice(N_DATA, B, replace=False).astype(np.int32)
    sample_idx = rng.integers(0, N_DATA, (B, 1 + NCE_K)).astype(np.int32)
    sample_idx[:, 0] = index
    batch = {"omic": rng.normal(size=(B, 80)).astype(np.float32),
             "g": rng.integers(0, 3, B).astype(np.int32),
             "t": rng.exponential(20, B).astype(np.float32),
             "e": np.ones(B, np.float32), "index": index,
             "sample_idx": sample_idx,
             "path_views": rng.integers(0, 256, (B, 2, SIZE, SIZE, 3),
                                        dtype=np.uint8)}
    views = rng.uniform(-1, 1, (B, 2, SIZE, SIZE, 3)).astype(np.float32)
    return batch, views


def _jax_tree(state):
    """The JAX TrainState as ``load_jax_state``'s numpy layout (copies: the
    step donates its input buffers)."""
    cp = lambda t: jax.tree_util.tree_map(lambda x: np.array(x), t)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    tree = {"step": int(state.step), "params": cp(state.params),
            "batch_stats": cp(state.batch_stats),
            "ema_params": cp(state.ema_params),
            "ema_batch_stats": cp(state.ema_batch_stats),
            "adam": {"count": int(adam.count), "mu": cp(adam.mu),
                     "nu": cp(adam.nu)}, "banks": {}}
    if state.banks:
        tree["banks"]["fuse"] = cp(state.banks["fuse"]._asdict())
    return tree


# Biases that feed a train-mode BatchNorm: their exact gradient is 0 (the
# batch mean removes them), so both packages' values are rounding noise of
# about 1e-6; held at an absolute 5e-6.
BIAS_BEFORE_BN = {"['model']['fusion']['encoder1']['bias']",
                  "['model']['fusion']['encoder2']['bias']",
                  "['model']['path_net']['fc_new1']['bias']"}


def _assert_trees_close(got, want, what, rtol, atol, leaf_atol=0.0):
    """Leaf by leaf; ``leaf_atol`` raises each leaf's atol to that share of
    its largest element, and to 5e-6 on ``BIAS_BEFORE_BN``."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        b = np.asarray(b)
        tol = max(atol, leaf_atol * float(np.abs(b).max(initial=0.0)))
        if leaf_atol and jax.tree_util.keystr(path) in BIAS_BEFORE_BN:
            tol = max(tol, 5e-6)
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=rtol, atol=tol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


@pytest.fixture
def no_onednn_convs():
    """oneDNN's fp32 convolution backward on the CPU loses digits: with it,
    the port's first moments of the ResNet's early layers land percents
    away from the JAX package's in the benchmark configuration; without it
    they agree at the tolerances above.  So the port's side of this test
    runs torch's own CPU convolutions."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_teacher_train_and_eval_step_match_jax(config, interpret_pallas,
                                                no_onednn_convs, monkeypatch):
    jopt = JOptions(**DIMS, **CONFIGS[config])
    opt = Options(**DIMS, **CONFIGS[config])
    batch, views = _batch(seed=len(config))
    monkeypatch.setattr(jsteps, "augment_views",
                        lambda key, v, dtype=None: jnp.asarray(views))
    monkeypatch.setattr(psteps, "augment_views",
                        lambda gen, v, dtype=None: torch.from_numpy(views))

    jmodel = j_define(jopt)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jsteps.init_teacher_state(
        jopt, jmodel, tx, jax.random.PRNGKey(7), N_DATA,
        {"x_path": jnp.zeros((1, SIZE, SIZE, 3)),
         "x_omic": jnp.zeros((1, 80))})
    tree = _jax_tree(jstate)
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 50), N_DATA,
                                      device="cpu")
    load_jax_state(state, tree)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    # the eval step, on the initial state
    jout, jparts = jsteps.build_eval_step(jopt, jmodel)(
        jstate.params["model"], jstate.batch_stats, jbatch,
        jax.random.PRNGKey(0))
    out, parts = psteps.build_eval_step(opt)(state.model, tbatch)
    for k in jparts:
        np.testing.assert_allclose(parts[k].numpy(), jparts[k], **WHOLE,
                                   err_msg=k)
    for k in ("hazard_fuse", "pred_fuse", "pred_path", "pred_omic"):
        np.testing.assert_allclose(getattr(out, k).numpy(),
                                   getattr(jout, k), **WHOLE, err_msg=k)

    # one train step
    jnew, jmetrics = jsteps.build_teacher_train_step(jopt, jmodel, tx)(
        jstate, jbatch, jax.random.PRNGKey(1), jnp.asarray(0.1))
    state, metrics = psteps.build_teacher_train_step(opt)(state, tbatch, 0.1)
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].numpy(), jmetrics[k], **WHOLE,
                                   err_msg=k)
    assert float(metrics["loss_CRD"] if config != "recipe_teacher"
                 else 1.0) > 0

    got, want = jax_state_tree(state), _jax_tree(jnew)
    assert got["step"] == want["step"] == 1
    assert got["adam"]["count"] == want["adam"]["count"] == 1
    _assert_trees_close(got["batch_stats"], want["batch_stats"],
                        "batch_stats", **WHOLE)
    _assert_trees_close(got["ema_batch_stats"], want["ema_batch_stats"],
                        "ema_batch_stats", **WHOLE)
    _assert_trees_close(got["banks"], want["banks"], "banks", **WHOLE)
    _assert_trees_close(got["adam"]["mu"], want["adam"]["mu"], "exp_avg",
                        rtol=2e-3, atol=1e-6, leaf_atol=2e-3)
