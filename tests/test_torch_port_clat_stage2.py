"""The CLAT stage-2 student of the port against the JAX package's: every
``crd_v10`` function, ``evaluate_feature`` and two student steps.

Per function: seeded numpy inputs through the JAX function and its port at
fp32 rtol 1e-5 / atol 1e-6.  Where the JAX function draws its k-means
initialisation from a key, the test repeats the key splits and the
``jax.random.gumbel`` calls and hands the noise to the port.  The kNN's
selected rows (ties included: the class mask zeroes most of each
similarity row) and ``evaluate_feature`` (numpy in both packages) must be
exactly equal.

CLAT steps: two steps of each package from the same JAX
``init_student_state`` (``train.import_state.load_jax_state``), with
``pos_extra`` ``neighbors`` and ``centers``, the ``clat_stage2`` recipe's
flags at a small size (``GK_refine`` with the gradient threshold, two
teachers, ``max_discrep`` 1), the query weights off in the first step and
on in the second.  Both get the same views (``augment_views`` is the
identity in both modules, and the batch carries the views), dropout 0,
``pallas_fusion="train"`` (the JAX Kronecker kernels in interpret mode, the
port's plain versions), and for ``centers`` the JAX step's k-means noise.
ResNet18 at 64^2, widths 16, batch 4, nce_p 3, nce_k 8, n_data 32, fp32.
Before the second step the port takes the JAX parameters, Adam moments and
EMA parameters again (``tests/test_torch_port_student.py`` says why).
Held as that test holds the MICCAI student: the step's metrics, both
models' BatchNorm statistics and both banks with their Z at rtol 2e-3 /
atol 5e-4, Adam's first moment of the heads elementwise and of the trunk
by norm, the EMA parameters at the whole-model tolerance plus 2 lr.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import multimodal_learning_tpu.contrast.crd as jcrd
import multimodal_learning_tpu.contrast.crd_v10 as jv10
import multimodal_learning_tpu.eval.diagnostics as jdiag
import multimodal_learning_tpu.train.student as jstudent
import multimodal_learning_tpu.train.student_clat as jclat
import multimodal_learning_tpu_torch.contrast.crd_v10 as pv10
import multimodal_learning_tpu_torch.eval.diagnostics as pdiag
import multimodal_learning_tpu_torch.train.student as pstudent
import multimodal_learning_tpu_torch.train.student_clat as pclat
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.contrast.crd import CRDBank
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.models.import_flax import \
    state_dict_from_flax
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)

FN = dict(rtol=1e-5, atol=1e-6)
WHOLE = dict(rtol=2e-3, atol=5e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **(tol or FN))


def _jax_gumbel(key, n_classes, n):
    """The noise ``jv10.class_centers(key, ...)`` draws, [C, n]."""
    return np.stack([np.asarray(jax.random.gumbel(k, (n,)))
                     for k in jax.random.split(key, n_classes)])


def _jax_bank_gumbel(key, n_classes, n):
    """The noise ``jv10.crd_v10_scores(..., key=key)`` draws, [2, C, n]."""
    k1, k2 = jax.random.split(key)
    return np.stack([_jax_gumbel(k1, n_classes, n),
                     _jax_gumbel(k2, n_classes, n)])


# ------------------------------------------------------------ the functions

N, D, C, B = 40, 8, 3, 5


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _class_mask(rng, n=N):
    labels = np.arange(n) % C
    rng.shuffle(labels)
    return np.eye(C, dtype=np.float32)[labels].T          # [C, n]


def test_masked_kmeans_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    mask = (rng.uniform(size=N) < 0.6).astype(np.float32)
    key = jax.random.PRNGKey(1)
    want = jv10.masked_kmeans(key, jnp.asarray(x), jnp.asarray(mask), 4)
    g = np.asarray(jax.random.gumbel(key, (N,)))
    got = pv10.masked_kmeans(_t(x), _t(mask), 4, _t(g))
    _close(got, want, "centers")


@pytest.mark.parametrize("num_pos", [2, 4])
def test_class_centers_match_jax(num_pos):
    rng = np.random.default_rng(num_pos)
    mem, cmask = _unit(rng, N, D), _class_mask(rng)
    key = jax.random.PRNGKey(num_pos)
    want = jv10.class_centers(key, jnp.asarray(mem), jnp.asarray(cmask),
                              num_pos)
    got = pv10.class_centers(_t(mem), _t(cmask), num_pos,
                             _t(_jax_gumbel(key, C, N)))
    assert got.shape == (C, num_pos - 1, D)
    _close(got, want, "centers")


SCORE_CASES = {
    "neighbors": dict(pos_extra="neighbors", num_pos=4),
    "neighbors_z_set": dict(pos_extra="neighbors", num_pos=4, z=2.5),
    "centers": dict(pos_extra="centers", num_pos=3),
    "centers_mean": dict(pos_extra="centers", num_pos=2),
    "none": dict(pos_extra="none", num_pos=1),
}


@pytest.mark.parametrize("case", sorted(SCORE_CASES))
def test_crd_v10_scores_match_jax(case):
    kw = dict(SCORE_CASES[case])
    z = np.float32(kw.pop("z", -1.0))
    rng = np.random.default_rng(len(case))
    mem1, mem2 = _unit(rng, N, D), _unit(rng, N, D)
    v1, v2 = _unit(rng, B, D), _unit(rng, B, D)
    cmask = _class_mask(rng)
    y = rng.choice(N, B, replace=False).astype(np.int32)
    labels = cmask[:, y].argmax(0).astype(np.int32)
    idx = rng.integers(0, N, (B, 1 + 9)).astype(np.int32)
    idx[:, 0] = y
    key = jax.random.PRNGKey(4)
    jbank = jcrd.CRDBank(jnp.asarray(mem1), jnp.asarray(mem2),
                         jnp.asarray(z), jnp.asarray(z))
    jo1, jo2, js_s, js_t, jnew = jv10.crd_v10_scores(
        jbank, jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(labels),
        jnp.asarray(y), jnp.asarray(idx), class_mask=jnp.asarray(cmask),
        T=0.07, momentum=0.5, key=key, update_bank=True, **kw)
    pbank = CRDBank(_t(mem1), _t(mem2), _t(z), _t(z))
    po1, po2, ps_s, ps_t = pv10.crd_v10_scores(
        pbank, _t(v1), _t(v2), _t(labels), _t(y), _t(idx),
        class_mask=_t(cmask), T=0.07, momentum=0.5,
        gumbel=_t(_jax_bank_gumbel(key, C, N)), update_bank=True, **kw)
    _close(po1, jo1, "out_v1")
    _close(po2, jo2, "out_v2")
    assert (ps_s is None) == (js_s is None)
    if js_s is not None:
        _close(ps_s, js_s, "sim_for_s")
        _close(ps_t, js_t, "sim_for_t")
        # the kNN rows: each positive score is one of the bank's rows
        raw = np.exp(mem2 @ v1.T / 0.07).T / float(pbank.z_v1)
        np.testing.assert_array_equal(
            np.abs(po1.numpy()[:, :4, None] - raw[:, None, :]).argmin(2),
            np.abs(np.asarray(jo1)[:, :4, None] - raw[:, None, :]).argmin(2))
    for k in ("memory_v1", "memory_v2", "z_v1", "z_v2"):
        _close(getattr(pbank, k), getattr(jnew, k), k)


@pytest.mark.parametrize("with_sims", [False, True])
def test_contrast_loss_v10_matches_jax(with_sims):
    rng = np.random.default_rng(7)
    x = rng.uniform(0.01, 2.0, (B, 4 + 12)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, B).astype(np.float32)
    sims = rng.uniform(-0.2, 1.0, (B, 4)).astype(np.float32) \
        if with_sims else None
    want = jv10.contrast_loss_v10(jnp.asarray(x), 64, 4, jnp.asarray(w),
                                  None if sims is None else jnp.asarray(sims))
    got = pv10.contrast_loss_v10(_t(x), 64, 4, _t(w),
                                 None if sims is None else _t(sims))
    _close(got[0], want[0], "mean loss")
    _close(got[1], want[1], "per-sample loss")


def test_assign_sample_weights_match_jax():
    rng = np.random.default_rng(8)
    ps = np.asarray(jax.nn.softmax(rng.normal(size=(12, 3)) * 2, 1))
    pt = np.asarray(jax.nn.softmax(rng.normal(size=(12, 3)) * 2, 1))
    gt = rng.integers(0, 3, 12).astype(np.int32)
    for max_d in (1.0, 0.3):
        want = jv10.assign_sample_weights(jnp.asarray(ps), jnp.asarray(pt),
                                          jnp.asarray(gt), max_d, 3)
        got = pv10.assign_sample_weights(_t(ps), _t(pt), _t(gt), max_d, 3)
        _close(got, want, f"weights at max_discrep {max_d}")
        assert 0 < float(got.max()) <= np.float32(max_d)
        assert float(got.min()) == 0.0


def test_evaluate_feature_matches_jax_exactly():
    rng = np.random.default_rng(9)
    fuse = rng.normal(size=(20, 16)).astype(np.float32)
    path = rng.normal(size=(20, 12)).astype(np.float32)
    labels = rng.integers(0, 3, 20)
    assert pdiag.evaluate_feature(fuse, path, labels) == \
        jdiag.evaluate_feature(fuse, path, labels)


# ---------------------------------------------------------------- CLAT steps

SIZE, SB, N_DATA, P, K = 64, 4, 32, 3, 8
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, feat_dim=16, label_dim=3, batch_size=SB,
            n_data=N_DATA, pallas_fusion="train", dropout_rate=0.0,
            niter_decay=30, distill="crd", num_teachers=2,
            assign_weights=True, CE_grads=True, loss_weighting="GK_refine",
            use_grads_thresh=True, grads_thresh=0.25, pos_mode="exact",
            nce_p=P, nce_k=K, max_discrep=1.0, alpha=1.0, beta=0.02,
            reg_type="none", beta1=0.9)


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


@pytest.fixture
def no_onednn_convs():
    """The port's side without oneDNN, whose fp32 convolution backward on
    the CPU loses digits (``tests/test_torch_port_step.py``)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _clat_batch(seed):
    rng = np.random.default_rng(seed)
    index = rng.choice(N_DATA, SB, replace=False).astype(np.int32)
    sample_idx = rng.integers(0, N_DATA, (SB, 1 + K)).astype(np.int32)
    sample_idx[:, 0] = index
    return {"omic": rng.normal(size=(SB, 80)).astype(np.float32),
            "g": rng.integers(0, 3, SB).astype(np.int32),
            "t": rng.exponential(20, SB).astype(np.float32),
            "e": np.ones(SB, np.float32), "index": index,
            "sample_idx": sample_idx,
            "path_views": rng.uniform(-1, 1, (SB, 2, SIZE, SIZE, 3)).astype(
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
            "banks": {k: cp(b._asdict()) for k, b in state.banks.items()}}


def _assert_trees_close(got, want, what, **tol):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), **tol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_moments_close(got, want, what):
    """The heads elementwise, the trunk by norm
    (``tests/test_torch_port_student.py``)."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        key, a, b = jax.tree_util.keystr(path), np.asarray(a), np.asarray(b)
        if key.startswith("['model']") and "fc_new" not in key:
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-1, f"{what}{key}: |diff| / |jax| = {rel:.3e}"
            continue
        atol = (5e-6 if key == "['model']['fc_new1']['bias']"
                else max(1e-6, 2e-3 * float(np.abs(b).max(initial=0.0))))
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=atol,
                                   err_msg=f"{what}{key}")


def _teacher(jopt, opt, seed=5):
    """A pathomic teacher in both packages (its weights through the
    bridge), frozen on the port's side."""
    jt = j_define(jopt)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    variables = jt.init({"params": k1, "dropout": k2},
                        x_path=jnp.zeros((1, SIZE, SIZE, 3)),
                        x_omic=jnp.zeros((1, 80)), train=True)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    tvars = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    pt = define_model(opt, generator=torch.Generator())
    pt.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jt, tvars, pstudent.freeze_teacher(pt, "cpu")


@pytest.mark.parametrize("pos_extra", ["neighbors", "centers"])
def test_clat_student_steps_match_jax(pos_extra, interpret_pallas,
                                      no_onednn_convs, monkeypatch):
    cfg = dict(DIMS, pos_extra=pos_extra)
    jopt, opt = JOptions(**cfg), Options(**cfg)
    monkeypatch.setattr(jclat, "augment_views",
                        lambda key, v, dtype=None: v)
    monkeypatch.setattr(pclat, "augment_views",
                        lambda gen, v, dtype=None: v)
    cmask = _class_mask(np.random.default_rng(1), N_DATA)

    jteacher, tvars, teacher = _teacher(jopt, opt)
    jmodel = j_define(jopt, path_only=True)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jstudent.init_student_state(jopt, jmodel, tx,
                                         jax.random.PRNGKey(7), N_DATA, SIZE)
    state = pstudent.init_student_state(
        opt, define_model(opt, path_only=True), make_lr_schedule(opt, 50),
        N_DATA, device="cpu")
    load_jax_state(state, _jax_tree(jstate))
    jstep = jclat.build_clat_student_step(jopt, jmodel, jteacher, tvars, tx,
                                          cmask)
    pstep = pclat.build_clat_student_step(opt, teacher, _t(cmask))

    for i, reweight_on in ((1, False), (2, True)):
        if i == 2:   # the JAX parameters, moments and EMA parameters again
            own, tree = jax_state_tree(state), _jax_tree(jstate)
            for k in ("banks", "batch_stats", "ema_batch_stats"):
                tree[k] = own[k]
            load_jax_state(state, tree)
        batch = _clat_batch(seed=len(pos_extra) + i)
        key = jax.random.PRNGKey(10 + i)
        k_c = jax.random.split(key, 6)[4:]
        gumbel = {name: _t(_jax_bank_gumbel(kc, 3, N_DATA))
                  for name, kc in zip(("fuse", "ema"), k_c)}
        jstate, jm = jstep(jstate, {k: jnp.asarray(x)
                                    for k, x in batch.items()}, key,
                           jnp.asarray(reweight_on))
        state, m = pstep(state, {k: _t(x) for k, x in batch.items()},
                         reweight_on, gumbel=gumbel)
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(m[k].numpy(), jm[k], **WHOLE,
                                       err_msg=f"step {i} {k}")
        if reweight_on:
            assert float(m["w1_mean"]) >= 1.0
        else:
            assert float(m["w1_mean"]) == 1.0
        got, want = jax_state_tree(state), _jax_tree(jstate)
        assert got["step"] == want["step"] == i
        for k in ("batch_stats", "ema_batch_stats", "banks"):
            _assert_trees_close(got[k], want[k], f"step {i} {k}", **WHOLE)
        for name in ("fuse", "ema"):
            assert float(got["banks"][name]["z_v1"]) > 0
        _assert_moments_close(got["adam"]["mu"], want["adam"]["mu"],
                              f"step {i} exp_avg")
        _assert_trees_close(got["ema_params"], want["ema_params"],
                            f"step {i} ema_params", rtol=WHOLE["rtol"],
                            atol=WHOLE["atol"] + 2 * opt.lr)
