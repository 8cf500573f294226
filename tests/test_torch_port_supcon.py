"""The port's SupCon loss (``losses/supcon.py``) and the teacher step's
``--supcon_distill 1`` against the JAX package's.

``supcon_loss`` in both contrast modes, with labels, an explicit mask or
neither, in value and in the gradient with respect to the features at fp32
rtol 1e-5 / atol 1e-6.

Two teacher steps with ``--supcon_distill 1`` (and CRD and pred-KD, as the
flagship step), from the same JAX ``init_teacher_state`` carried to the
port, the views in the batch (``augment_views`` the identity in both step
modules), dropout 0, the JAX Kronecker kernels in interpret mode, at the
tolerances of the teacher step's test (``tests/test_torch_port_step.py``):
loss parts, BatchNorm statistics and the bank at rtol 2e-3 / atol 5e-4,
each tensor of Adam's first moment at rtol 2e-3 and an atol of 2e-3 of its
largest element (at least 1e-6), but for two kinds, as the student tests
hold them (``tests/test_torch_port_student.py``): the ResNet trunk's
moments by the norm of the difference at 1e-1 (a ReLU input within fp32
rounding of 0 takes opposite sides in the two frameworks and moves a
channel's gradient), and the biases of the fusion's ``encoder1`` and
``encoder2``, which feed a train-mode BatchNorm, so that their exact
gradient is 0 and each package's moment is rounding noise: at 2e-3 of the
largest moment of their layer's kernel.  Before the second step the port takes
the JAX parameters, moments and EMA parameters again, as the student
tests do (Adam's first update is about lr * sign(g)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_student import (SIZE, WHOLE, _assert_trees_close,
                                     _jax_student_tree,
                                     interpret_pallas,  # noqa: F401
                                     no_onednn_convs)  # noqa: F401

import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu_torch.train.steps as psteps
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.losses.supcon import supcon_loss as j_supcon
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.losses import supcon_loss as p_supcon
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)

FN = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["all", "one"])
@pytest.mark.parametrize("given", ["labels", "mask", "none"])
def test_supcon_loss_matches_jax(mode, given):
    rng = np.random.default_rng(len(mode) + len(given))
    f = rng.normal(size=(8, 2, 12)).astype(np.float32)
    f /= np.linalg.norm(f, axis=2, keepdims=True)
    labels = rng.integers(0, 3, 8).astype(np.int32)
    labels[[5, 6]] = 2
    kw = {"labels": {"labels": labels},
          "mask": {"mask": (labels[:, None] == labels[None]).astype(
              np.float32)},
          "none": {}}[given]
    jval, jgrad = jax.value_and_grad(
        lambda x: j_supcon(x, contrast_mode=mode, **{
            k: jnp.asarray(v) for k, v in kw.items()}))(jnp.asarray(f))
    x = torch.from_numpy(f).requires_grad_()
    val = p_supcon(x, contrast_mode=mode,
                   **{k: torch.from_numpy(v) for k, v in kw.items()})
    val.backward()
    np.testing.assert_allclose(val.detach().numpy(), jval, **FN)
    np.testing.assert_allclose(x.grad.numpy(), jgrad, **FN)


def test_supcon_refusals_match_jax():
    f = torch.zeros(4, 2, 3)
    with pytest.raises(ValueError, match="n_views"):
        p_supcon(torch.zeros(4, 3))
    with pytest.raises(ValueError, match="both"):
        p_supcon(f, labels=torch.zeros(4), mask=torch.eye(4))
    with pytest.raises(ValueError, match="Unknown mode"):
        p_supcon(f, contrast_mode="two")
    opt = Options(path_dim=8, omic_dim=8, mmhid=8, feat_dim=8,
                  supcon_distill=1, task="surv")
    with pytest.raises(NotImplementedError, match="needs class labels"):
        psteps.build_teacher_train_step(opt)


B, N_DATA, NCE_K = 4, 32, 8
CFG = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
           omic_dim=16, mmhid=16, feat_dim=16, label_dim=3, batch_size=B,
           nce_k=NCE_K, n_data=N_DATA, pallas_fusion="train",
           dropout_rate=0.0, niter_decay=30, CRD_distill=1, pred_distill=1,
           num_teachers=2, pos_mode="exact", nce_p=1, supcon_distill=1,
           supcon_weight=0.5)


def _batch(seed):
    rng = np.random.default_rng(seed)
    index = rng.choice(N_DATA, B, replace=False).astype(np.int32)
    sample_idx = rng.integers(0, N_DATA, (B, 1 + NCE_K)).astype(np.int32)
    sample_idx[:, 0] = index
    g = np.array([0, 1, 1, 2], np.int32)   # a shared label: positives
    return {"omic": rng.normal(size=(B, 80)).astype(np.float32), "g": g,
            "t": rng.exponential(20, B).astype(np.float32),
            "e": np.ones(B, np.float32), "index": index,
            "sample_idx": sample_idx,
            "path_views": rng.uniform(-1, 1, (B, 2, SIZE, SIZE, 3)).astype(
                np.float32)}


def test_supcon_teacher_steps_match_jax(interpret_pallas, no_onednn_convs,
                                        monkeypatch):
    jopt, opt = JOptions(**CFG), Options(**CFG)
    monkeypatch.setattr(jsteps, "augment_views",
                        lambda key, v, dtype=None: v)
    monkeypatch.setattr(psteps, "augment_views",
                        lambda gen, v, dtype=None: v)
    jmodel = j_define(jopt)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jsteps.init_teacher_state(
        jopt, jmodel, tx, jax.random.PRNGKey(7), N_DATA,
        {"x_path": jnp.zeros((1, SIZE, SIZE, 3)),
         "x_omic": jnp.zeros((1, 80))})
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 50), N_DATA,
                                      device="cpu")
    load_jax_state(state, _jax_student_tree(jstate))
    jstep = jsteps.build_teacher_train_step(jopt, jmodel, tx)
    pstep = psteps.build_teacher_train_step(opt)
    for i in (1, 2):
        batch = _batch(50 + i)
        if i == 2:
            own, tree = jax_state_tree(state), _jax_student_tree(jstate)
            for k in ("banks", "batch_stats", "ema_batch_stats"):
                tree[k] = own[k]
            load_jax_state(state, tree)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                           jax.random.PRNGKey(i), jnp.asarray(0.1))
        state, m = pstep(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, 0.1)
        assert set(m) == set(jm) and "loss_supcon" in m
        assert float(m["loss_supcon"]) > 0
        for k in jm:
            np.testing.assert_allclose(m[k].numpy(), jm[k], **WHOLE,
                                       err_msg=f"step {i} {k}")
        got, want = jax_state_tree(state), _jax_student_tree(jstate)
        for k in ("batch_stats", "ema_batch_stats", "banks"):
            _assert_trees_close(got[k], want[k], f"step {i} {k}", **WHOLE)
        _assert_moments_close(got["adam"]["mu"], want["adam"]["mu"],
                              f"step {i} exp_avg")


def _assert_moments_close(got, want, what):
    fusion = want["model"]["fusion"]
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        key, a, b = jax.tree_util.keystr(path), np.asarray(a), np.asarray(b)
        if key.startswith("['model']['path_net']"):
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-1, f"{what}{key}: |diff| / |jax| = {rel:.3e}"
            continue
        enc = next((e for e in ("encoder1", "encoder2")
                    if key == f"['model']['fusion']['{e}']['bias']"), None)
        if enc is None:
            rtol, atol = 2e-3, max(1e-6, 2e-3 * float(np.abs(b).max()))
        else:
            rtol, atol = 0, 2e-3 * float(np.abs(fusion[enc]["kernel"]).max())
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what}{key}")
