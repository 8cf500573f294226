"""The M3LR t-SVD constraint of the port against the JAX package's.

Per function, on seeded numpy inputs: ``update_aux`` and
``tensor_nuclear_norm`` at rtol 1e-4 / atol 1e-5 (the complex SVDs run in
different LAPACK builds), ``update_adj_tensor`` and ``build_view_features``
for n_views 2, 4, 6 and 8 at rtol 1e-5 / atol 1e-6.

Two t-SVD teacher steps of each package (the aux refresh on, then off),
from the JAX ``init_teacher_state`` carried to the port, with the same
views in the batch (``augment_views`` the identity in both step modules),
dropout 0, ``pallas_fusion="train"`` (the JAX Kronecker kernels in
interpret mode), ResNet18 at 64^2, widths 16, batch 4, fp32.  mu starts
at 0.5 and Lambda_global is 0.1, so the threshold keeps some singular
values and drops others (the recipe's mu 1e-5 would drop them all).
Before the second step the port takes the JAX parameters and Adam
moments again, as ``tests/test_torch_port_student.py`` explains.  Held at
the teacher step's whole-model tolerance, rtol 2e-3 / atol 5e-4: the loss
parts (``loss_tsvd`` included), the TNNs, ``aux1``/``aux2``, mu, the
BatchNorm statistics; Adam's first moment outside the ResNet trunk at
rtol 2e-3 and an atol of 2e-3 of each tensor's largest element, the trunk
by norm at 1e-1 (the ReLU flips explained there).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import multimodal_learning_tpu.lowrank as jlow
import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu_torch.lowrank as plow
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

SVD = dict(rtol=1e-4, atol=1e-5)
FN = dict(rtol=1e-5, atol=1e-6)
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


def _adj(seed, b=6, v=4):
    rng = np.random.default_rng(seed)
    feats = [rng.normal(size=(b, 5)).astype(np.float32) for _ in range(v)]
    adj = np.stack([f @ f.T for f in feats], axis=-1)          # [B, B, V]
    return adj / np.linalg.norm(adj, axis=1, keepdims=True)


@pytest.mark.parametrize("rotate", [True, False])
@pytest.mark.parametrize("tau", [0.05, 0.3])
def test_update_aux_and_tnn_match_jax(rotate, tau):
    adj = _adj(int(tau * 100) + rotate)
    ja, jt = jlow.update_aux(jnp.asarray(adj), tau, rotate=rotate)
    pa, pt = plow.update_aux(torch.from_numpy(adj), torch.tensor(tau),
                             rotate=rotate)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), **SVD)
    np.testing.assert_allclose(float(pt), float(jt), **SVD)
    assert 0 < float(pt) < float(plow.tensor_nuclear_norm(
        torch.from_numpy(adj), rotate=rotate))   # some values shrink
    assert pa.dtype == torch.float32 and pa.shape == adj.shape
    np.testing.assert_allclose(
        float(plow.tensor_nuclear_norm(torch.from_numpy(adj), rotate)),
        float(jlow.tensor_nuclear_norm(jnp.asarray(adj), rotate)), **SVD)


@pytest.mark.parametrize("n_views", [2, 4, 6, 8])
def test_views_and_adjacency_match_jax(n_views):
    rng = np.random.default_rng(n_views)
    feats = [rng.normal(size=(5, 7)).astype(np.float32) for _ in range(6)]
    jv = jlow.build_view_features(n_views, *map(jnp.asarray, feats))
    pv = plow.build_view_features(n_views, *map(torch.from_numpy, feats))
    for jside, pside in zip(jv, pv):
        assert len(jside) == len(pside) == n_views
        for a, b in zip(pside, jside):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FN)
        np.testing.assert_allclose(
            plow.update_adj_tensor(pside).numpy(),
            np.asarray(jlow.update_adj_tensor(jside)), **FN)
    with pytest.raises(NotImplementedError):
        plow.build_view_features(3, *map(torch.from_numpy, feats))


SIZE, B, N_DATA = 64, 4, 32
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, feat_dim=16, label_dim=3, batch_size=B,
            n_data=N_DATA, pallas_fusion="train", dropout_rate=0.0,
            niter_decay=30, CRD_distill=0, pred_distill=1, tSVD_loss=True,
            Lambda_global=0.1, mu=0.5, pho=1.1, max_mu=1.0, aux_iter=1,
            beta1=0.5)
TSVD_CONFIGS = {"pathomic_4": dict(n_views=4, tSVD_mode="pathomic"),
                "pathomic_8": dict(n_views=8, tSVD_mode="pathomic"),
                "path_2": dict(n_views=2, tSVD_mode="path")}


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"omic": rng.normal(size=(B, 80)).astype(np.float32),
            "g": rng.integers(0, 3, B).astype(np.int32),
            "t": rng.exponential(20, B).astype(np.float32),
            "e": np.ones(B, np.float32),
            "index": rng.choice(N_DATA, B, replace=False).astype(np.int32),
            "path_views": rng.uniform(-1, 1, (B, 2, SIZE, SIZE, 3)).astype(
                np.float32)}


def _jax_tree(state):
    cp = lambda t: jax.tree_util.tree_map(lambda x: np.array(x), t)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    return {"step": int(state.step), "params": cp(state.params),
            "batch_stats": cp(state.batch_stats),
            "ema_params": cp(state.ema_params),
            "ema_batch_stats": cp(state.ema_batch_stats),
            "adam": {"count": int(adam.count), "mu": cp(adam.mu),
                     "nu": cp(adam.nu)},
            "banks": {"tsvd": cp(dataclasses.asdict(state.banks["tsvd"]))}}


def _close_trees(got, want, what, **tol):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol,
                                   err_msg=f"{what}{key}")


def _close_moments(got, want, what):
    flat = jax.tree_util.tree_flatten_with_path
    for (path, a), (_, b) in zip(flat(got)[0], flat(want)[0]):
        key, a, b = jax.tree_util.keystr(path), np.asarray(a), np.asarray(b)
        if key.startswith("['model']['path_net']") and "fc_new" not in key:
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-1, f"{what}{key}: |diff| / |jax| = {rel:.3e}"
            continue
        before_bn = key.endswith(("['encoder1']['bias']",
                                  "['encoder2']['bias']",
                                  "['fc_new1']['bias']"))
        atol = 5e-6 if before_bn else max(
            1e-6, 2e-3 * float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=atol,
                                   err_msg=f"{what}{key}")


@pytest.mark.parametrize("config", sorted(TSVD_CONFIGS))
def test_tsvd_teacher_steps_match_jax(config, interpret_pallas, monkeypatch):
    cfg = dict(DIMS, **TSVD_CONFIGS[config])
    jopt, opt = JOptions(**cfg), Options(**cfg)
    monkeypatch.setattr(jsteps, "augment_views", lambda key, v, dtype=None: v)
    monkeypatch.setattr(psteps, "augment_views", lambda gen, v, dtype=None: v)
    jmodel = j_define(jopt)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jsteps.init_teacher_state(
        jopt, jmodel, tx, jax.random.PRNGKey(7), N_DATA,
        {"x_path": jnp.zeros((1, SIZE, SIZE, 3)),
         "x_omic": jnp.zeros((1, 80))})
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 50), N_DATA,
                                      device="cpu")
    load_jax_state(state, _jax_tree(jstate))
    jstep = jsteps.build_teacher_train_step(jopt, jmodel, tx)
    pstep = psteps.build_teacher_train_step(opt)
    mu = opt.mu
    with torch.backends.mkldnn.flags(enabled=False):
        for i, refresh in enumerate((True, False), 1):
            batch = _batch(len(config) + i)
            if i == 2:
                own, tree = jax_state_tree(state), _jax_tree(jstate)
                for k in ("banks", "batch_stats", "ema_batch_stats"):
                    tree[k] = own[k]
                load_jax_state(state, tree)
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            jb["tsvd_update"] = np.asarray(refresh)
            jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(i),
                               jnp.asarray(0.1))
            state, m = pstep(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()}, 0.1,
                             tsvd_update=refresh)
            assert set(m) == set(jm)
            for k in jm:
                np.testing.assert_allclose(m[k].numpy(), jm[k], **WHOLE,
                                           err_msg=f"step {i} {k}")
            got, want = jax_state_tree(state), _jax_tree(jstate)
            _close_trees(got["banks"], want["banks"], f"step {i} banks",
                         **WHOLE)
            for k in ("batch_stats", "ema_batch_stats"):
                _close_trees(got[k], want[k], f"step {i} {k}", **WHOLE)
            _close_moments(got["adam"]["mu"], want["adam"]["mu"],
                           f"step {i} exp_avg")
            # mu grows by pho on a refresh only; the TNNs are those of the
            # last refresh
            mu = min(mu * opt.pho, opt.max_mu) if refresh else mu
            np.testing.assert_allclose(float(state.banks["tsvd"].mu), mu,
                                       rtol=1e-6)
            assert float(m["loss_tsvd"]) > 0 and float(m["tnn_path"]) > 0
