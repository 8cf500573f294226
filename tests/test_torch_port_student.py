"""The students' CRD generations, the gradient weightings and the student
train step of the port against the JAX package's.

Per function: seeded numpy inputs go through the JAX function and its port
at fp32 rtol 1e-5 / atol 1e-6; the selected columns of
``crd_scores_select`` and every 0/1 gate must be exactly equal.  The JAX
``crd_scores_select`` draws its positive ranks from a key; the test draws
the same ranks with the same ``jax.random`` call and hands them to the
port as ``pick``.

Student steps: two steps of each package from the same JAX
``init_student_state``, carried to the port by
``train.import_state.load_jax_state``; the frozen teacher's weights go
through ``models/import_flax.py``.  Before the second step the port takes
the JAX package's parameters, Adam moments and EMA parameters again (not
its banks or BatchNorm statistics, which stay its own): Adam's first
update is about lr * sign(g) and may flip sign where a gradient is
rounding noise, and the second step would carry that difference.  The
second step reads the Z each bank stored after the first, from the raw
P + K columns, where the first step's loss took it from the selected
columns.  Both packages get the same injected views (``augment_views``
is the identity in both student modules and the batch carries the
views), dropout 0, ``select_pos_mode hard`` and
``pallas_fusion="train"``, the JAX Kronecker kernels in interpret mode.
ResNet18 at 64^2, widths 16, batch 4, P = 6 -> P2 = 3, K = 8 -> K2 = 5,
n_data 32, fp32.  Held at the teacher
step's tolerances (``tests/test_torch_port_step.py``): loss parts, the
AEKD scale, the BatchNorm statistics of the student and the EMA, both
banks with their Z at rtol 2e-3 / atol 5e-4; Adam's first moment of the
heads (``fc_new1``, ``fc_new2``, the CRD embeds) per tensor at rtol 2e-3
and an atol of 2e-3 of its largest element (5e-6 for ``fc_new1``'s bias,
which feeds a train-mode BatchNorm and whose exact gradient is 0).  The
EMA parameters after the first step are the updated parameters (its decay
is 0 at step 0), so for that flip they are held at an atol of 2 lr plus
the whole-model tolerance.

The ResNet trunk's first moments are held by the norm of the difference,
at 1e-1 of the JAX tensor's norm.  A ReLU whose input lies within fp32
rounding of 0 takes opposite sides in the two frameworks (each
framework's forward agrees with a float64 one to about 1e-5; on four
batches the port's agreed no less closely than JAX's).  At 64^2 a
layer-4 channel has 16 positions over the batch, so one such element
moves that channel's gradient, and every layer's beneath it, by
percents: measured up to 6.6e-2 of a tensor's norm and half of its
largest element, in a step whose losses agree to 5e-5.  The trunk's
backward is the teacher's (held elementwise in
``tests/test_torch_port_step.py``), and the heads pin the gradient that
enters it.  For the same reason ``GK_refine_param``, whose scale is the
Gram of the trunk's parameter gradients, holds its losses, scale and
heads' moments (which that scale weighs) at rtol 2e-2.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

import multimodal_learning_tpu.contrast.crd as jcrd
import multimodal_learning_tpu.gradweight.aekd as jaekd
import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu.train.student as jstudent
import multimodal_learning_tpu_torch.contrast.crd as pcrd
import multimodal_learning_tpu_torch.gradweight.aekd as paekd
import multimodal_learning_tpu_torch.train.steps as psteps
import multimodal_learning_tpu_torch.train.student as pstudent
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.models.import_flax import \
    state_dict_from_flax
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)

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


@pytest.fixture
def no_onednn_convs():
    """The port's side without oneDNN, whose fp32 convolution backward on
    the CPU loses digits (``tests/test_torch_port_step.py``)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=what, **(tol or FN))


# --------------------------------------------------------- crd_scores_select

N_BANK, D, B = 64, 16, 5


def _bank_inputs(seed, P, K, z=-1.0):
    rng = np.random.default_rng(seed)
    unit = lambda *s: (lambda x: x / np.linalg.norm(x, axis=-1,
                                                    keepdims=True))(
        rng.normal(size=s).astype(np.float32))
    mem1, mem2 = unit(N_BANK, D), unit(N_BANK, D)
    v1, v2 = unit(B, D), unit(B, D)
    y = rng.choice(N_BANK, B, replace=False).astype(np.int32)
    idx = rng.integers(0, N_BANK, (B, P + K)).astype(np.int32)
    idx[:, 0] = y
    zs = np.float32(z)
    return mem1, mem2, zs, v1, v2, y, idx


def _columns(out, raw, z):
    """The column of ``raw`` each output score came from: the nearest raw
    score (scores of a row differ by far more than rounding)."""
    return np.abs(out[:, :, None] * z - raw[:, None, :]).argmin(axis=2)


CRD_CASES = {
    "hard": dict(select_pos_mode="hard"),
    "mid": dict(select_pos_mode="mid", P=40, P2=6),
    "random": dict(select_pos_mode="random"),
    "curriculum": dict(select_pos_mode="curriculum", P=100, P2=6,
                       epoch_frac=0.5),
    "all_negatives": dict(select_pos_mode="hard", select_neg_pairs=False),
    "all_positives": dict(select_pos_pairs=False),
    "v4_neg_reweight": dict(select_pos_mode="hard", neg_reweight=True),
    "v4_sort": dict(select_pos_mode="hard", pos_sort="v4"),
    "z_set_update_bank": dict(select_pos_mode="hard", z=3.5,
                              update_bank=True),
}


def _jax_pick(mode, key, P, P2, epoch_frac):
    """The ranks ``jcrd.crd_scores_select`` draws from ``key``."""
    if mode == "mid":
        return jax.random.choice(key, jnp.arange(30, min(100, P)), (P2,),
                                 replace=False)
    if mode == "random":
        return jax.random.randint(key, (P2,), 0, P)
    if mode == "curriculum":
        lo = (50 * (4 - jnp.ceil(3 * jnp.asarray(epoch_frac)) - 1)
              ).astype(jnp.int32)
        return lo + jax.random.randint(key, (P2,), 0, 50)
    return None


@pytest.mark.parametrize("case", sorted(CRD_CASES))
def test_crd_scores_select_matches_jax(case):
    kw = dict(P=8, K=10, P2=4, K2=6, select_pos_mode="hard",
              select_pos_pairs=True, select_neg_pairs=True,
              neg_reweight=False, epoch_frac=0.0, pos_sort=None, z=-1.0,
              update_bank=False)
    kw.update(CRD_CASES[case])
    z, update_bank = kw.pop("z"), kw.pop("update_bank")
    P, K = kw["P"], kw["K"]
    mem1, mem2, zs, v1, v2, y, idx = _bank_inputs(len(case), P, K, z)
    key = jax.random.PRNGKey(3)
    pick = _jax_pick(kw["select_pos_mode"], key, P, kw["P2"],
                     kw["epoch_frac"])
    jbank = jcrd.CRDBank(jnp.asarray(mem1), jnp.asarray(mem2),
                         jnp.asarray(zs), jnp.asarray(zs))
    jo1, jo2, jnew, jw = jcrd.crd_scores_select(
        jbank, jnp.asarray(v1), jnp.asarray(v2), jnp.asarray(y),
        jnp.asarray(idx), T=0.07, momentum=0.5, rng=key,
        update_bank=update_bank, **kw)
    pbank = pcrd.CRDBank(_t(mem1), _t(mem2), _t(zs), _t(zs))
    po1, po2, pw = pcrd.crd_scores_select(
        pbank, _t(v1), _t(v2), _t(y), _t(idx), T=0.07, momentum=0.5,
        pick=None if pick is None else _t(pick), update_bank=update_bank,
        **kw)
    _close(po1, jo1, "out_v1")
    _close(po2, jo2, "out_v2")
    assert (pw is None) == (jw is None)
    if jw is not None:
        _close(pw, jw, "neg_weights")
    # the selected columns, exactly; each package's Z recovered from slot
    # 0, the exact positive, which every mode keeps first
    raw1 = np.exp(np.einsum("bsd,bd->bs", mem2[idx], v1) / 0.07)
    n_pos = kw["P2"] if kw["select_pos_pairs"] else P
    cols = {}
    for name, out in (("port", po1.numpy()), ("jax", np.asarray(jo1))):
        z1 = raw1[0, 0] / out[0, 0]
        cols[name] = [_columns(out[:, :n_pos], raw1[:, :P], z1)]
        if not kw["neg_reweight"]:
            cols[name].append(_columns(out[:, n_pos:], raw1[:, P:], z1))
    for got, want in zip(cols["port"], cols["jax"]):
        np.testing.assert_array_equal(got, want)
    if update_bank:
        for k in ("memory_v1", "memory_v2", "z_v1", "z_v2"):
            _close(getattr(pbank, k), getattr(jnew, k), k)
    else:   # the bank is left untouched, its Z too
        assert float(pbank.z_v1) == float(zs) == float(pbank.z_v2)
        np.testing.assert_array_equal(pbank.memory_v1.numpy(), mem1)


def test_draw_pick_ranges_and_refusal():
    gen = torch.Generator().manual_seed(0)
    mid = pcrd.draw_pick("mid", 40, 6, gen)
    assert mid.unique().numel() == 6 and 30 <= int(mid.min())
    assert int(mid.max()) < 40
    assert pcrd.draw_pick("hard", 40, 6, gen) is None
    for frac, lo in ((0.0, 150), (0.3, 100), (0.5, 50), (1.0, 0)):
        cur = pcrd.draw_pick("curriculum", 200, 64, gen, epoch_frac=frac)
        assert lo <= int(cur.min()) and int(cur.max()) < lo + 50, frac
    with pytest.raises(ValueError, match="nce_p >= 36"):
        pcrd.draw_pick("mid", 35, 6, gen)


def test_weighted_contrast_loss_and_gate_match_jax():
    rng = np.random.default_rng(5)
    x = rng.uniform(0.01, 2.0, (6, 9)).astype(np.float32)
    ls, lt = (rng.uniform(0, 2, 6).astype(np.float32) for _ in range(2))
    lt[2] = ls[2]   # a tie: neither side trains
    js, jt = jcrd.crd_gate_weights(jnp.asarray(ls), jnp.asarray(lt))
    ps, pt = pcrd.crd_gate_weights(_t(ls), _t(lt))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(jt))
    assert float(ps[2]) == float(pt[2]) == 0.0
    _close(pcrd.weighted_contrast_loss(_t(x), ps, 32),
           jcrd.weighted_contrast_loss(jnp.asarray(x), js, 32), "loss")


# --------------------------------------------------------------- gradweight

def _grads(seed, n, b=6, d=12, anti=False):
    rng = np.random.default_rng(seed)
    gs = [rng.normal(size=(b, d)).astype(np.float32) for _ in range(n)]
    if anti:   # one gradient against the last and one along it: a closed
        gs[0] = -gs[-1] + 0.1 * gs[0]          # and an open gate
        gs[1] = gs[-1] + 0.1 * gs[1]
    return gs


def test_feature_grads_match_jax():
    rng = np.random.default_rng(1)
    feat = rng.normal(size=(6, 12)).astype(np.float32)
    w = rng.normal(size=(12, 3)).astype(np.float32)
    g = rng.integers(0, 3, 6)
    fns = [lambda f: jnp.sum(jax.nn.log_softmax(f @ w)[jnp.arange(6), g]),
           lambda f: jnp.sum((f @ w) ** 2) / 6.0]
    want = jaekd.feature_grads(fns, jnp.asarray(feat))
    f = _t(feat).requires_grad_()
    logit = f @ _t(w)
    losses = [torch.log_softmax(logit, 1)[torch.arange(6), _t(g)].sum(),
              (logit ** 2).sum() / 6.0]
    got = paekd.feature_grads(losses, f)
    for a, b in zip(got, want):
        _close(a, b, "grad")
    assert not any(t.requires_grad for t in got)


@pytest.mark.parametrize("n_kd", [2, 4])
def test_aekd_scale_and_total_match_jax(n_kd):
    gs = _grads(n_kd, n_kd + 1)
    losses = [np.float32(0.3 * (i + 1)) for i in range(n_kd)]
    js = jaekd.aekd_scale([jnp.asarray(g) for g in gs], n_kd)
    ps = paekd.aekd_scale([_t(g) for g in gs], n_kd)
    _close(ps, js, "scale")
    _close(paekd.aekd_total(ps, [torch.tensor(v) for v in losses]),
           jaekd.aekd_total(js, [jnp.asarray(v) for v in losses]), "total")


@pytest.mark.parametrize("per_sample", [False, True])
def test_aekd_v2_gate_matches_jax(per_sample):
    gs = _grads(7, 4, anti=True)
    rng = np.random.default_rng(8)
    losses = [rng.uniform(0, 1, 6 if per_sample else ()).astype(np.float32)
              for _ in range(3)]
    want = jaekd.aekd_v2_gate([jnp.asarray(g) for g in gs[:-1]],
                              jnp.asarray(gs[-1]),
                              [jnp.asarray(v) for v in losses],
                              per_sample=per_sample, batch_size=6)
    got = paekd.aekd_v2_gate([_t(g) for g in gs[:-1]], _t(gs[-1]),
                             [_t(v) for v in losses], per_sample=per_sample,
                             batch_size=6)
    _close(got, want, "gated total")
    # the gate itself, exactly: cos(KD grad, CE grad) > 0 per loss/row
    if per_sample:
        K = np.stack(gs[:-1], 1)
        sim = np.einsum("bnd,bd->bn", K, gs[-1])
    else:
        sim = np.stack([g.reshape(-1) for g in gs[:-1]]) @ gs[-1].reshape(-1)
    gate = (sim > 0).astype(np.float32)
    assert 0 < gate.sum() < gate.size   # both open and closed gates
    lv = np.stack(losses, -1)
    np.testing.assert_allclose(
        float(got), (gate * lv).sum() / (6 if per_sample else 1), **FN)


def test_momentum_aekd_scale_matches_jax():
    gs = _grads(9, 5, anti=True)
    ema = np.array([0.5, 1.0, 1.5, 2.0, 2.5], np.float32)
    jm, jst = jaekd.momentum_aekd_scale([jnp.asarray(g) for g in gs],
                                        jnp.asarray(ema), 0.7, 0.1, True)
    pm, pst = paekd.momentum_aekd_scale([_t(g) for g in gs], _t(ema), 0.7,
                                        0.1, True)
    _close(pm, jm, "mo_scale")
    _close(pst, jst, "state")
    # the thresholded Gram's row sums (a count) are exact
    np.testing.assert_array_equal(
        np.round((pm.numpy() - 0.7 * ema) / 0.3, 4),
        np.round((np.asarray(jm) - 0.7 * ema) / 0.3, 4))
    jm2, _ = jaekd.momentum_aekd_scale([jnp.asarray(g) for g in gs],
                                       jnp.asarray(ema), 0.7, 0.1, False)
    pm2, _ = paekd.momentum_aekd_scale([_t(g) for g in gs], _t(ema), 0.7,
                                       0.1, False)
    _close(pm2, jm2, "mo_scale without threshold")


def test_gk_refine_param_space_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 5)).astype(np.float32)
    params = {"fc1": {"kernel": rng.normal(size=(5, 4)).astype(np.float32),
                      "bias": rng.normal(size=4).astype(np.float32)},
              "fc_new2": {"kernel": rng.normal(size=(4, 3)).astype(
                  np.float32), "bias": np.zeros(3, np.float32)},
              "unused": {"bias": np.ones(2, np.float32)}}

    def j_losses(p):
        h = jnp.tanh(x @ p["fc1"]["kernel"] + p["fc1"]["bias"])
        out = h @ p["fc_new2"]["kernel"] + p["fc_new2"]["bias"]
        return [jnp.sum(out ** 2), jnp.sum(jnp.sin(out)), jnp.sum(h) * 2.0]

    fns = [lambda p, i=i: j_losses(p)[i] for i in range(3)]
    want = jaekd.gk_refine_param_space(
        fns, jax.tree_util.tree_map(jnp.asarray, params))
    tp = {k: {kk: _t(vv).requires_grad_() for kk, vv in v.items()}
          for k, v in params.items()}
    h = torch.tanh(_t(x) @ tp["fc1"]["kernel"] + tp["fc1"]["bias"])
    out = h @ tp["fc_new2"]["kernel"] + tp["fc_new2"]["bias"]
    losses = [(out ** 2).sum(), torch.sin(out).sum(), h.sum() * 2.0]
    kept = [t for k, v in tp.items() if k != "fc_new2" for t in v.values()]
    _close(paekd.gk_refine_param_space(losses, kept), want, "scale")


@pytest.mark.parametrize("use_thresh", [True, False])
def test_gk_refine_thresh_weights_match_jax(use_thresh):
    gs = _grads(13, 4, anti=True)
    want = jaekd.gk_refine_thresh_weights([jnp.asarray(g) for g in gs], 0.25,
                                          use_thresh)
    got = paekd.gk_refine_thresh_weights([_t(g) for g in gs], 0.25,
                                         use_thresh)
    if use_thresh:   # counts: exactly equal
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _close(got, want, "weights")


# ------------------------------------------------------------ student steps

SIZE, SB, N_DATA, P, P2, K, K2 = 64, 4, 32, 6, 3, 8, 5
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, feat_dim=16, label_dim=3, batch_size=SB,
            n_data=N_DATA, pallas_fusion="train", dropout_rate=0.0,
            niter_decay=30, distill="crd", num_teachers=2,
            pos_mode="multi_pos", nce_p=P, nce_p2=P2, nce_k=K, nce_k2=K2,
            select_pos_mode="hard", alpha=1.0, beta=0.02, reg_type="none",
            beta1=0.9)
AEKD = dict(assign_weights=True, CE_grads=True)
STUDENT_CONFIGS = {
    "GK_refine": dict(AEKD, loss_weighting="GK_refine"),
    "momentum_AEKD": dict(AEKD, loss_weighting="momentum_AEKD"),
    "GK_refine_param": dict(AEKD, loss_weighting="GK_refine_param"),
    "student_customize": dict(AEKD, student_customize=True),
    "sample_KD": dict(AEKD, student_customize=True, sample_KD=True),
    "teacher_bn_running": dict(AEKD, teacher_bn="running"),
    "paired_conv": dict(AEKD, paired_conv=True),
    "distill_kd": dict(AEKD, distill="kd"),
}


def _student_batch(seed):
    """A batch whose ``path_views`` are the two augmented views themselves
    (float32): ``augment_views`` is the identity in both student modules,
    so each step, jitted or not, reads its own batch's views."""
    rng = np.random.default_rng(seed)
    index = rng.choice(N_DATA, SB, replace=False).astype(np.int32)
    sample_idx = rng.integers(0, N_DATA, (SB, P + K)).astype(np.int32)
    sample_idx[:, 0] = index
    return {"omic": rng.normal(size=(SB, 80)).astype(np.float32),
            "g": rng.integers(0, 3, SB).astype(np.int32),
            "t": rng.exponential(20, SB).astype(np.float32),
            "e": np.ones(SB, np.float32), "index": index,
            "sample_idx": sample_idx,
            "path_views": rng.uniform(-1, 1, (SB, 2, SIZE, SIZE, 3)).astype(
                np.float32)}


def _jax_student_tree(state):
    cp = lambda t: jax.tree_util.tree_map(lambda x: np.array(x), t)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    banks = {}
    for name, bank in (state.banks or {}).items():
        banks[name] = cp(bank._asdict() if hasattr(bank, "_asdict")
                         else bank)
    return {"step": int(state.step), "params": cp(state.params),
            "batch_stats": cp(state.batch_stats),
            "ema_params": cp(state.ema_params),
            "ema_batch_stats": cp(state.ema_batch_stats),
            "adam": {"count": int(adam.count), "mu": cp(adam.mu),
                     "nu": cp(adam.nu)}, "banks": banks}


def _assert_trees_close(got, want, what, rtol, atol, leaf_atol=0.0):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        b = np.asarray(b)
        tol = max(atol, leaf_atol * float(np.abs(b).max(initial=0.0)))
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=rtol, atol=tol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


def _assert_moments_close(got, want, what, rtol=2e-3):
    """Adam moments: the heads elementwise, the trunk by norm (above)."""
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
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what}{key}")


def _teacher(jopt, opt, seed=5):
    """A pathomic teacher in both packages, with perturbed BatchNorm
    statistics so that ``--teacher_bn running`` reads non-trivial ones."""
    jt = j_define(jopt)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    variables = jt.init({"params": k1, "dropout": k2},
                        x_path=jnp.zeros((1, SIZE, SIZE, 3)),
                        x_omic=jnp.zeros((1, 80)), train=True)
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (rng.uniform(-0.2, 0.2, a.shape) if a.ndim and
                   float(np.asarray(a).mean()) == 0.0
                   else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
        variables["batch_stats"])
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    tvars = {"params": jax.tree_util.tree_map(jnp.asarray, params),
             "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    pt = define_model(opt, generator=torch.Generator())
    pt.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    return jt, tvars, pstudent.freeze_teacher(pt, "cpu")


@pytest.mark.parametrize("config", sorted(STUDENT_CONFIGS))
def test_student_steps_match_jax(config, interpret_pallas, no_onednn_convs,
                                 monkeypatch):
    cfg = dict(DIMS, **STUDENT_CONFIGS[config])
    jopt, opt = JOptions(**cfg), Options(**cfg)
    batches = [_student_batch(seed=len(config) + i) for i in range(2)]
    monkeypatch.setattr(jstudent, "augment_views",
                        lambda key, v, dtype=None: v)
    monkeypatch.setattr(pstudent, "augment_views",
                        lambda gen, v, dtype=None: v)

    jteacher, tvars, teacher = _teacher(jopt, opt)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    jmodel = j_define(jopt, path_only=True)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jstudent.init_student_state(jopt, jmodel, tx,
                                         jax.random.PRNGKey(7), N_DATA, SIZE)
    state = pstudent.init_student_state(
        opt, define_model(opt, path_only=True), make_lr_schedule(opt, 50),
        N_DATA, device="cpu")
    load_jax_state(state, _jax_student_tree(jstate))
    jstep = jstudent.build_student_train_step(jopt, jmodel, jteacher, tvars,
                                              tx)
    pstep = pstudent.build_student_train_step(opt, teacher)

    lr = opt.lr
    for i, batch in enumerate(batches, 1):
        if i == 2:
            # the parameters, Adam's moments and the EMA's from the JAX
            # step (Adam's first update may flip sign where a gradient is
            # rounding noise); the banks and BatchNorm statistics stay the
            # port's own
            own, tree = jax_state_tree(state), _jax_student_tree(jstate)
            for k in ("banks", "batch_stats", "ema_batch_stats"):
                tree[k] = own[k]
            load_jax_state(state, tree)
        jstate, jmetrics = jstep(
            jstate, {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.PRNGKey(10 + i), jnp.asarray(0.1))
        state, metrics = pstep(
            state, {k: torch.from_numpy(x) for k, x in batch.items()}, 0.1)
        assert set(metrics) == set(jmetrics)
        tol = (dict(WHOLE, rtol=2e-2) if config == "GK_refine_param"
               else WHOLE)
        for k in jmetrics:
            np.testing.assert_allclose(metrics[k].numpy(), jmetrics[k],
                                       **tol, err_msg=f"step {i} {k}")
        got, want = jax_state_tree(state), _jax_student_tree(jstate)
        assert got["step"] == want["step"] == i
        assert set(got["banks"]) == set(want["banks"])
        for k in ("batch_stats", "ema_batch_stats", "banks"):
            _assert_trees_close(got[k], want[k], f"step {i} {k}", **WHOLE)
        if config != "distill_kd":   # the stored Z: set, and the JAX one
            for name in ("fuse", "ema"):
                assert float(got["banks"][name]["z_v1"]) > 0
        _assert_moments_close(got["adam"]["mu"], want["adam"]["mu"],
                              f"step {i} exp_avg", rtol=tol["rtol"])
        _assert_trees_close(got["ema_params"], want["ema_params"],
                            f"step {i} ema_params", rtol=WHOLE["rtol"],
                            atol=WHOLE["atol"] + 2 * lr)
    # the frozen teacher's buffers, bitwise
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, teacher_before[k]), k


def test_teacher_step_with_crd_gate_matches_jax(interpret_pallas,
                                                no_onednn_convs,
                                                monkeypatch):
    """``--CRD_gate`` in the teacher step (JAX ``train/steps.py:329-343``)."""
    cfg = dict(mode="pathomic", task="grad", input_size_path=SIZE,
               path_dim=16, omic_dim=16, mmhid=16, feat_dim=16, label_dim=3,
               batch_size=SB, nce_k=K, n_data=N_DATA, pallas_fusion="train",
               dropout_rate=0.0, niter_decay=30, CRD_distill=1,
               pred_distill=1, num_teachers=2, pos_mode="exact", nce_p=1,
               CRD_gate=True)
    jopt, opt = JOptions(**cfg), Options(**cfg)
    rng = np.random.default_rng(21)
    index = rng.choice(N_DATA, SB, replace=False).astype(np.int32)
    sample_idx = rng.integers(0, N_DATA, (SB, 1 + K)).astype(np.int32)
    sample_idx[:, 0] = index
    batch = {"omic": rng.normal(size=(SB, 80)).astype(np.float32),
             "g": rng.integers(0, 3, SB).astype(np.int32),
             "t": rng.exponential(20, SB).astype(np.float32),
             "e": np.ones(SB, np.float32), "index": index,
             "sample_idx": sample_idx,
             "path_views": np.zeros((SB, 2, SIZE, SIZE, 3), np.uint8)}
    views = rng.uniform(-1, 1, (SB, 2, SIZE, SIZE, 3)).astype(np.float32)
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
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 50), N_DATA,
                                      device="cpu")
    load_jax_state(state, _jax_student_tree(jstate))
    jnew, jm = jsteps.build_teacher_train_step(jopt, jmodel, tx)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(1), jnp.asarray(0.1))
    state, m = psteps.build_teacher_train_step(opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0.1)
    assert set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k].numpy(), jm[k], **WHOLE, err_msg=k)
    assert float(m["loss_CRD"]) > 0
    got, want = jax_state_tree(state), _jax_student_tree(jnew)
    _assert_trees_close(got["banks"], want["banks"], "banks", **WHOLE)
    _assert_trees_close(got["adam"]["mu"], want["adam"]["mu"], "exp_avg",
                        rtol=2e-3, atol=1e-6, leaf_atol=2e-3)


# --------------------------------------------------------------- refusals

REFUSED = {
    # the JAX student wires no loss for --distill vid (nor attention,
    # kdsvd, fsp, abound, factor, nst) and trains it as plain kd
    "distill_vid": (dict(distill="vid"), NotImplementedError,
                    r"ROADMAP ground rules\b"),
    # --data_parallel is ported (tests/test_torch_port_data_parallel.py);
    # a batch the ranks cannot split is the JAX package's ValueError
    "data_parallel": (dict(data_parallel=2, batch_size=3), ValueError,
                      "--batch_size 3 must be divisible by the "
                      "data-parallel mesh size 2"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_student_refusals_name_their_roadmap_item(case):
    flags, exc, match = REFUSED[case]
    opt = Options(**dict(DIMS, **flags))
    for call in (lambda: pstudent.build_student_train_step(opt, None),
                 lambda: pstudent.init_student_state(
                     opt, torch.nn.Linear(2, 2), make_lr_schedule(opt, 5),
                     N_DATA, device="cpu"),
                 lambda: pstudent.train_student(opt, {}, 1, device="cpu")):
        with pytest.raises(exc, match=match):
            call()


ACCEPTED = ("pretrained", "init_type")


@pytest.mark.parametrize("case", ACCEPTED)
def test_student_accepts_pretrained_and_init_type(case, tmp_path,
                                                  monkeypatch):
    """``--pretrained_path`` (a ResNet-only ``.npz`` at the path-only
    student's root) and ``--init_type xavier``: the student initialises,
    its EMA starts from the loaded or redrawn weights, and it takes a
    step with finite losses."""
    from multimodal_learning_tpu_torch.models import flax_from_state_dict
    from multimodal_learning_tpu_torch.models.import_torch import \
        save_pretrained_npz
    flags = dict(init_type="xavier")
    source = define_model(Options(**DIMS), path_only=True,
                          generator=torch.Generator().manual_seed(11))
    if case == "pretrained":
        params, stats = flax_from_state_dict(source.state_dict())
        flags = dict(pretrained_path=str(tmp_path / "trunk.npz"))
        save_pretrained_npz(flags["pretrained_path"],
                            {k: v for k, v in params.items()
                             if not k.startswith("fc_new")},
                            {k: v for k, v in stats.items()
                             if not k.startswith("fc_new")})
    opt = Options(**dict(DIMS, **flags))
    monkeypatch.setattr(pstudent, "augment_views",
                        lambda gen, v, dtype=None: v)
    fresh = define_model(opt, path_only=True,
                         generator=torch.Generator().manual_seed(0))
    drawn = {k: v.clone() for k, v in fresh.state_dict().items()}
    state = pstudent.init_student_state(opt, fresh, make_lr_schedule(opt, 5),
                                        N_DATA, device="cpu")
    got = state.model.state_dict()
    if case == "pretrained":
        assert torch.equal(got["conv1.weight"], source.conv1.weight)
        assert torch.equal(got["layer4.1.bn2.running_var"],
                           source.layer4[1].bn2.running_var)
        assert torch.equal(got["fc_new2.weight"], drawn["fc_new2.weight"])
    else:
        assert not torch.equal(got["conv1.weight"], drawn["conv1.weight"])
        assert not got["fc_new2.bias"].any()
    for k, v in state.ema_model.state_dict().items():
        assert torch.equal(v, got[k]), k
    teacher = pstudent.freeze_teacher(
        define_model(opt, generator=torch.Generator().manual_seed(5)), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _student_batch(3).items()}
    state, metrics = pstudent.build_student_train_step(opt, teacher)(
        state, batch, 1)
    assert state.optimizer.count == 1
    assert all(torch.isfinite(v).all() for k, v in metrics.items()
               if k.startswith("loss")), metrics
