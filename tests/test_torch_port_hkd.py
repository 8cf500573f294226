"""The port's HKD (``contrast/hkd.py``) and the student step's distiller-zoo
and HKD modes against the JAX package's.

Per function: seeded numpy inputs through the JAX function and its port,
values and the gradients with respect to the student-side inputs at fp32
rtol 1e-5 / atol 1e-6.  ``knn_adjacency`` must be exactly equal, also with
tied rows (equal logits, ordered by the stable sort in both packages).  At
a batch of 4, smaller than k = 8, the JAX function fails (it repeats each
source k times against n columns of neighbours); the port takes all n
nodes, which is the JAX function's answer at k = n.  ``TAGEncoder`` takes
its parameters from its flax initialisation.  The banks are drawn from each package's own
generator, so ``init_hkd_bank`` is held to its law and shape.

Student steps, as ``tests/test_torch_port_student.py`` runs them (its
helpers, state bridge and tolerances; the JAX Kronecker kernels in
interpret mode, dropout 0, the same views): two ``--distill hkd`` steps,
holding the losses, the heads, the ``"hkd"`` bank and Adam's moments, and
one step each of ``feats_KL``, ``rkd``, ``pkt``, ``hint`` and
``correlation``.  An HKD batch's ``sample_idx`` holds the K negatives only,
as its loader draws them, and has 8 rows, so that the JAX step's kNN graph
can be built.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_student import (DIMS, K, N_DATA, P, SIZE, WHOLE,
                                     _assert_moments_close,
                                     _assert_trees_close, _jax_student_tree,
                                     _student_batch, _teacher,
                                     interpret_pallas,  # noqa: F401
                                     no_onednn_convs)  # noqa: F401

import multimodal_learning_tpu.contrast.hkd as jhkd
import multimodal_learning_tpu.train.student as jstudent
import multimodal_learning_tpu_torch.contrast.hkd as phkd
import multimodal_learning_tpu_torch.train.student as pstudent
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)

FN = dict(rtol=1e-5, atol=1e-6)
N, D, B, NEG = 40, 12, 10, 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, what):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), err_msg=what, **FN)


def _unit(rng, *shape):
    x = rng.normal(size=shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _bank_inputs(seed):
    rng = np.random.default_rng(seed)
    mem_l, mem_ab = _unit(rng, N, D), _unit(rng, N, D)
    f_s, f_t = _unit(rng, B, D), _unit(rng, B, D)
    y = rng.choice(N, B, replace=False).astype(np.int32)
    cidx = rng.integers(0, N, (B, NEG)).astype(np.int32)
    return mem_l, mem_ab, f_s, f_t, y, cidx


def test_init_hkd_bank_law_and_seed():
    gen = torch.Generator().manual_seed(3)
    bank = phkd.init_hkd_bank(2000, 24, gen, "cpu")
    stdv = 1.0 / math.sqrt(24 / 3)
    jbank = jhkd.init_hkd_bank(jax.random.PRNGKey(0), 2000, 24)
    for got, want in ((bank.memory_l, jbank.memory_l),
                      (bank.memory_ab, jbank.memory_ab)):
        assert got.shape == want.shape and got.dtype == torch.float32
        assert float(got.abs().max()) <= stdv
        # U(-stdv, stdv): mean 0, std stdv / sqrt(3), as the JAX draw
        assert abs(float(got.mean())) < 0.01 * stdv
        np.testing.assert_allclose(float(got.std()), stdv / math.sqrt(3),
                                   rtol=0.01)
        np.testing.assert_allclose(float(got.std()), float(np.std(want)),
                                   rtol=0.02)
    again = phkd.init_hkd_bank(2000, 24, torch.Generator().manual_seed(3))
    assert torch.equal(again.memory_l, bank.memory_l)
    assert not torch.equal(bank.memory_l, bank.memory_ab)


def test_bank_update_and_momentum_rows_match_jax():
    mem_l, mem_ab, f_s, f_t, y, _ = _bank_inputs(1)
    f_s, f_t = f_s * 3.0, f_t * 0.5   # rows of any norm
    for m in (0.9, 0.75):
        _close(phkd._momentum_rows(_t(mem_l), _t(f_s), _t(y), m),
               jhkd._momentum_rows(jnp.asarray(mem_l), jnp.asarray(f_s),
                                   jnp.asarray(y), m), f"rows {m}")
    want = jhkd.hkd_bank_update(jhkd.HKDBank(jnp.asarray(mem_l),
                                             jnp.asarray(mem_ab)),
                                jnp.asarray(f_s), jnp.asarray(f_t),
                                jnp.asarray(y))
    bank = phkd.HKDBank(_t(mem_l), _t(mem_ab))
    phkd.hkd_bank_update(bank, _t(f_s).requires_grad_(), _t(f_t), _t(y))
    _close(bank.memory_l, want.memory_l, "memory_l")
    _close(bank.memory_ab, want.memory_ab, "memory_ab")
    rest = np.setdiff1d(np.arange(N), y)
    assert np.array_equal(bank.memory_l.numpy()[rest], mem_l[rest])
    np.testing.assert_allclose(
        np.linalg.norm(bank.memory_l.numpy()[y], axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("case", ["random", "ties", "batch_below_k",
                                  "k4_b10"])
def test_knn_adjacency_matches_jax_exactly(case):
    rng = np.random.default_rng(len(case))
    b, k = {"random": (16, 8), "ties": (16, 8), "batch_below_k": (4, 8),
            "k4_b10": (10, 4)}[case]
    logits = rng.normal(size=(b, 3)).astype(np.float32)
    if case == "ties":   # equal logits: equal distances to every node
        logits[[3, 7, 11]] = logits[0]
        logits[[5, 9]] = logits[2]
    got = phkd.knn_adjacency(_t(logits), k)
    if b < k:
        with pytest.raises(ValueError, match="broadcast"):
            jhkd.knn_adjacency(jnp.asarray(logits), k)
    want = np.asarray(jhkd.knn_adjacency(jnp.asarray(logits), min(k, b)))
    np.testing.assert_array_equal(got.numpy(), want)
    # each source sends min(k, b) edges, its own among them
    np.testing.assert_array_equal(got.sum(0).numpy(), min(k, b))
    assert (torch.diagonal(got) == 1).all()


def test_tag_encoder_matches_jax():
    rng = np.random.default_rng(5)
    h = rng.normal(size=(B, D)).astype(np.float32)
    adj = np.asarray(jhkd.knn_adjacency(
        jnp.asarray(rng.normal(size=(B, 3)).astype(np.float32)), 4))
    enc = jhkd.TAGEncoder(8)
    params = enc.init(jax.random.PRNGKey(2), jnp.asarray(adj),
                      jnp.asarray(h))["params"]
    jval, jgrad = jax.value_and_grad(
        lambda x: jnp.sum(enc.apply({"params": params}, jnp.asarray(adj), x)
                          * jnp.arange(8.0)))(jnp.asarray(h))
    port = phkd.TAGEncoder(D, 8)
    port.load_state_dict({f"{w}.{k}": _t(np.asarray(params[w][src]).T
                                         if k == "weight" else
                                         params[w][src])
                          for w in ("w0", "w1")
                          for k, src in (("weight", "kernel"),
                                         ("bias", "bias"))})
    x = _t(h).requires_grad_()
    out = port(_t(adj), x)
    np.testing.assert_allclose(out.norm(dim=1).detach().numpy(), 1.0,
                               rtol=1e-6)
    val = (out * torch.arange(8.0)).sum()
    val.backward()
    _close(val, jval, "value")
    _close(x.grad, jgrad, "grad")


@pytest.mark.parametrize("graph", [False, True])
def test_hkd_scores_and_nce_match_jax(graph):
    mem_l, mem_ab, f_s, f_t, y, cidx = _bank_inputs(7 + graph)
    jfn, pfn = ((jhkd.hkd_graph_scores, phkd.hkd_graph_scores) if graph
                else (jhkd.hkd_scores, phkd.hkd_scores))
    jbank = jhkd.HKDBank(jnp.asarray(mem_l), jnp.asarray(mem_ab))

    def jtotal(a, b):
        o_s, o_t = jfn(jbank, a, b, jnp.asarray(y), jnp.asarray(cidx))
        return (jhkd.nce_softmax_loss(o_s) + 0.5 * jhkd.nce_softmax_loss(o_t),
                (o_s, o_t))

    (jval, (jo_s, jo_t)), jgrads = jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True)(jnp.asarray(f_s),
                                              jnp.asarray(f_t))
    bank = phkd.HKDBank(_t(mem_l), _t(mem_ab))
    a, b = _t(f_s).requires_grad_(), _t(f_t).requires_grad_()
    o_s, o_t = pfn(bank, a, b, _t(y), _t(cidx))
    assert o_s.shape == (B, 1 + NEG)
    val = phkd.nce_softmax_loss(o_s) + 0.5 * phkd.nce_softmax_loss(o_t)
    val.backward()
    _close(o_s, jo_s, "out_s")
    _close(o_t, jo_t, "out_t")
    _close(val, jval, "loss")
    _close(a.grad, jgrads[0], "grad f_s")
    _close(b.grad, jgrads[1], "grad f_t")
    # the bank is read, never written, by the scores
    assert np.array_equal(bank.memory_l.numpy(), mem_l)


# ------------------------------------------------------------ student steps

HKD_B = 8


def _hkd_batch(seed):
    """Two of the student test's batches as one of 8 rows, with the K
    negatives only (the HKD loader's ``sample_idx``) and unique indices."""
    a, b = _student_batch(seed), _student_batch(seed + 100)
    batch = {k: np.concatenate([a[k], b[k]]) for k in a}
    batch["index"] = np.random.default_rng(seed).choice(
        N_DATA, HKD_B, replace=False).astype(np.int32)
    batch["sample_idx"] = np.ascontiguousarray(batch["sample_idx"][:, P:])
    assert batch["sample_idx"].shape == (HKD_B, K)
    return batch


def _run_steps(cfg, batches, monkeypatch):
    """Steps of both packages from the same JAX state (the student test's
    protocol); yields the step number, both states and both metrics, first
    (step 0, no metrics) the states before any step."""
    jopt, opt = JOptions(**cfg), Options(**cfg)
    monkeypatch.setattr(jstudent, "augment_views",
                        lambda key, v, dtype=None: v)
    monkeypatch.setattr(pstudent, "augment_views",
                        lambda gen, v, dtype=None: v)
    jteacher, tvars, teacher = _teacher(jopt, opt)
    jmodel = j_define(jopt, path_only=True)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jstate = jstudent.init_student_state(jopt, jmodel, tx,
                                         jax.random.PRNGKey(7), N_DATA, SIZE)
    state = pstudent.init_student_state(
        opt, define_model(opt, path_only=True), make_lr_schedule(opt, 50),
        N_DATA, device="cpu")
    load_jax_state(state, _jax_student_tree(jstate))
    yield 0, state, jstate, None, None
    jstep = jstudent.build_student_train_step(jopt, jmodel, jteacher, tvars,
                                              tx)
    pstep = pstudent.build_student_train_step(opt, teacher)
    for i, batch in enumerate(batches, 1):
        if i > 1:   # re-synced from JAX, but for the banks and statistics
            own, tree = jax_state_tree(state), _jax_student_tree(jstate)
            for k in ("banks", "batch_stats", "ema_batch_stats"):
                tree[k] = own[k]
            load_jax_state(state, tree)
        jstate, jmetrics = jstep(
            jstate, {k: jnp.asarray(x) for k, x in batch.items()},
            jax.random.PRNGKey(10 + i), jnp.asarray(0.1))
        state, metrics = pstep(
            state, {k: torch.from_numpy(x) for k, x in batch.items()}, 0.1)
        yield i, state, jstate, metrics, jmetrics


def _check_step(i, state, jstate, metrics, jmetrics, lr):
    assert set(metrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].numpy(), jmetrics[k], **WHOLE,
                                   err_msg=f"step {i} {k}")
    got, want = jax_state_tree(state), _jax_student_tree(jstate)
    assert got["step"] == want["step"] == i
    assert set(got["banks"]) == set(want["banks"])
    for k in ("batch_stats", "ema_batch_stats", "banks"):
        _assert_trees_close(got[k], want[k], f"step {i} {k}", **WHOLE)
    _assert_moments_close(got["adam"]["mu"], want["adam"]["mu"],
                          f"step {i} exp_avg")
    _assert_trees_close(got["ema_params"], want["ema_params"],
                        f"step {i} ema_params", rtol=WHOLE["rtol"],
                        atol=WHOLE["atol"] + 2 * lr)
    return got, want


def test_hkd_student_steps_match_jax(interpret_pallas, no_onednn_convs,
                                     monkeypatch):
    cfg = dict(DIMS, distill="hkd", batch_size=HKD_B)
    batches = [_hkd_batch(seed=30 + i) for i in range(2)]
    for i, state, jstate, metrics, jmetrics in _run_steps(cfg, batches,
                                                          monkeypatch):
        if i == 0:
            before = jax_state_tree(state)["banks"]["hkd"]
            continue
        got, want = _check_step(i, state, jstate, metrics, jmetrics,
                                Options(**cfg).lr)
        assert float(metrics["loss_kd1"]) > 0
        # the heads' Adam moments, elementwise (_assert_moments_close)
        for side in ("hkd_embed_s", "hkd_embed_t", "hkd_gnn_s",
                     "hkd_gnn_t"):
            assert side in got["adam"]["mu"]
    # the bank's batch rows moved and have norm 1; the others did not move
    bank = jax_state_tree(state)["banks"]["hkd"]
    rows = np.unique(np.concatenate([b["index"] for b in batches]))
    rest = np.setdiff1d(np.arange(N_DATA), rows)
    for k in ("memory_l", "memory_ab"):
        assert np.array_equal(bank[k][rest], before[k][rest])
        np.testing.assert_allclose(np.linalg.norm(bank[k][rows], axis=1),
                                   1.0, rtol=1e-5)


@pytest.mark.parametrize("mode", ["feats_KL", "rkd", "pkt", "hint",
                                  "correlation"])
def test_zoo_student_step_matches_jax(mode, interpret_pallas,
                                      no_onednn_convs, monkeypatch):
    cfg = dict(DIMS, distill=mode)
    for i, state, jstate, metrics, jmetrics in _run_steps(
            cfg, [_student_batch(seed=40 + len(mode))], monkeypatch):
        if i == 0:
            continue
        _check_step(i, state, jstate, metrics, jmetrics, Options(**cfg).lr)
        assert set(metrics) >= {"loss_kd1", "loss_div1", "loss_div2"}
        assert not jax_state_tree(state)["banks"]


def test_hkd_state_crosses_the_bridge_and_the_snapshot(tmp_path):
    """The HKD heads and bank go port -> JAX tree -> port, and through a
    ``--resume`` snapshot, unchanged."""
    from multimodal_learning_tpu_torch.utils.checkpoint import (
        load_train_state, save_train_state)
    opt = Options(**dict(DIMS, distill="hkd"))

    def fresh(seed):
        return pstudent.init_student_state(
            opt, define_model(opt, path_only=True), make_lr_schedule(opt, 5),
            N_DATA, seed=seed, device="cpu")

    state = fresh(1)
    tree = jax_state_tree(state)
    assert set(tree["params"]) == {"model", "hkd_embed_s", "hkd_embed_t",
                                   "hkd_gnn_s", "hkd_gnn_t"}
    assert set(tree["params"]["hkd_gnn_s"]) == {"w0", "w1"}
    assert set(tree["banks"]["hkd"]) == {"memory_l", "memory_ab"}
    copy = load_jax_state(fresh(2), tree)
    path = str(tmp_path / "s_1_state.pt")
    save_train_state(path, state, epoch=1)
    snap = fresh(3)
    load_train_state(path, snap)
    for other in (copy, snap):
        for (n, a), (_, b) in zip(state.embeds.state_dict().items(),
                                  other.embeds.state_dict().items()):
            assert torch.equal(a, b), n
        for k in ("memory_l", "memory_ab"):
            assert torch.equal(getattr(state.banks["hkd"], k),
                               getattr(other.banks["hkd"], k)), k
    assert not torch.equal(fresh(3).banks["hkd"].memory_l,
                           state.banks["hkd"].memory_l)
