"""``--resume`` across packages: the JAX package's ``.snap`` snapshots read
and written by the port (``utils/checkpoint.py``: ``load_jax_snapshot``,
``save_jax_snapshot``, ``resume_train_state``; ``utils/flax_msgpack.py``,
flax's msgpack encoding without flax or msgpack).

- The codec against ``flax.serialization`` on every msgpack form flax
  writes, and on the JAX ``TrainState`` of each family that the JAX
  package snapshots (the pofusion teacher with CRD and pred-KD, the t-SVD
  teacher, the MICCAI student with momentum AEKD, the HKD student, the
  CLAT student; AdaBound, Adagrad and the plateau scale on the omic
  teacher):
  byte-equal output, equal trees after decoding.  The states' arrays are
  filled with seeded random values, so that every moment, bank and counter
  is told apart.
- For each family, a ``.snap`` written by the JAX package's
  ``save_train_state`` restores into a fresh port state equal to the JAX
  state (arrays bitwise, with their dtypes), and the port's
  ``save_jax_snapshot`` of that state is restored by the JAX package's
  ``load_train_state`` against a fresh JAX state, bitwise again.
- The drivers: a JAX fold (the omic teacher under ``--lr_policy
  plateau``, the cheapest fold to compile) run 1 epoch with
  ``--snapshot_every 1`` and resumed by the port's ``train_teacher``
  from the ``.snap``, whose restored state equals the JAX state bitwise;
  and a port fold's state written by ``save_jax_snapshot`` and resumed by
  the JAX ``train_teacher``.
- The pofusion teacher one step after each resume, with the views
  injected (``tests/test_torch_port_step.py``'s pattern and tolerances).
- A ``.snap`` holding a key the port cannot take, or lacking one it needs,
  raises naming it.
"""
import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization, struct

import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu.train.student as jstudent
import multimodal_learning_tpu_torch.train.steps as psteps
import multimodal_learning_tpu_torch.train.student as pstudent
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.data import make_synthetic_splits
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu.train.loop import train_teacher as j_train
from multimodal_learning_tpu.utils.checkpoint import (
    load_train_state as j_load, save_train_state as j_save)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.train import loop as ploop
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.utils import flax_msgpack
from multimodal_learning_tpu_torch.train.import_state import jax_state_tree
from multimodal_learning_tpu_torch.utils.checkpoint import (
    jax_snapshot_tree, load_jax_snapshot, load_train_state,
    resume_train_state, save_jax_snapshot)
from test_torch_port_step import CONFIGS as STEP_CONFIGS
from test_torch_port_step import DIMS as STEP_DIMS
from test_torch_port_step import N_DATA as STEP_N
from test_torch_port_step import SIZE as STEP_SIZE
from test_torch_port_step import WHOLE
from test_torch_port_step import _assert_trees_close as assert_trees_close
from test_torch_port_step import _batch as step_batch
from test_torch_port_step import _jax_tree as step_jax_tree
from test_torch_port_step import (interpret_pallas,  # noqa: F401 (fixtures)
                                  no_onednn_convs)

SIZE, N_DATA = 32, 24
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, feat_dim=8, label_dim=3, batch_size=8,
            nce_k=4, n_data=N_DATA, dropout_rate=0.0, niter_decay=2)
TEACHER = dict(CRD_distill=1, pred_distill=1)
STUDENT = dict(fixed_model="t", num_teachers=2, CRD_distill=0,
               pred_distill=1, alpha=1.0)
# the optimizers' states ride on the omic teacher (MaxNet; the chain's
# layout does not depend on the model), which is cheap to encode
OMIC = dict(mode="omic", CRD_distill=1, pred_distill=0)
FAMILIES = {
    "teacher_adam": ("teacher", TEACHER),
    "omic_teacher_adabound": ("teacher", dict(OMIC,
                                              optimizer_type="adabound")),
    "omic_teacher_adagrad_plateau": ("teacher", dict(
        OMIC, optimizer_type="adagrad", lr_policy="plateau")),
    "omic_teacher_adam_plateau": ("teacher", dict(OMIC,
                                                  lr_policy="plateau")),
    "tsvd_teacher": ("teacher", dict(CRD_distill=0, pred_distill=1,
                                     tSVD_loss=True, n_views=2)),
    "miccai_student_momentum_aekd": ("student", dict(
        STUDENT, distill="crd", assign_weights=True, CE_grads=True,
        loss_weighting="momentum_AEKD")),
    "hkd_student": ("student", dict(STUDENT, distill="hkd")),
    "clat_student": ("student", dict(
        STUDENT, distill="crd", assign_weights=True, CE_grads=True,
        use_grads_thresh=True, grads_thresh=0.25, pos_extra="neighbors",
        max_discrep=1.0)),
}
PLATEAU = {"plateau": {"best": 0.5, "bad_epochs": 2, "scale": 0.2}}


def _jax_state(kind, cfg):
    jopt = JOptions(**{**DIMS, **cfg})
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=3))
    if kind == "teacher":
        state = jsteps.init_teacher_state(
            jopt, j_define(jopt), tx, jax.random.PRNGKey(7), N_DATA,
            {"x_path": jnp.zeros((1, SIZE, SIZE, 3)),
             "x_omic": jnp.zeros((1, 80))})
    else:
        state = jstudent.init_student_state(
            jopt, j_define(jopt, path_only=True), tx, jax.random.PRNGKey(7),
            N_DATA, SIZE)
    return jopt, state


def _port_state(kind, cfg, seed=3):
    opt = Options(**{**DIMS, **cfg})
    sched = make_lr_schedule(opt, 3)
    gen = torch.Generator().manual_seed(seed)
    if kind == "teacher":
        return opt, psteps.init_teacher_state(
            opt, define_model(opt, generator=gen), sched, N_DATA, seed=seed,
            device="cpu")
    return opt, pstudent.init_student_state(
        opt, define_model(opt, path_only=True, generator=gen), sched, N_DATA,
        seed=seed, device="cpu")


def _filled(state, seed):
    """``state`` with every float array drawn from a seeded uniform law,
    every optimizer counter 7 and the step 5 (numpy leaves)."""
    rng = np.random.default_rng(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return np.full(x.shape, 7, x.dtype)
        return rng.random(x.shape, dtype=np.float32).astype(x.dtype)

    return jax.tree_util.tree_map(fill, state).replace(
        step=np.asarray(5, np.int32))


def _assert_same_tree(got, want, path=""):
    """Equal keys, and arrays equal bitwise with equal dtypes."""
    if isinstance(want, dict):
        assert isinstance(got, dict), path
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif want is None:
        assert got is None, path
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (path, got.dtype, want.dtype)
        assert got.shape == want.shape and np.array_equal(got, want), path


def _port_tree_of_jax(jstate):
    return jax.tree_util.tree_map(np.asarray,
                                  serialization.to_state_dict(jstate))


def test_codec_matches_flax_on_every_msgpack_form():
    """Each form flax writes, at each of its length classes: nil, bool,
    ints from fixint to 64 bits both signs, floats, str (fix, 8 and 16
    bits), bin, maps of 16 keys and more, arrays of every dtype flax's
    states hold, numpy scalars, complex numbers, namedtuples, lists and
    dataclasses; forms outside flax's subset raise."""
    import collections
    Pair = collections.namedtuple("Pair", "count mu")

    @struct.dataclass
    class Box:
        a: np.ndarray
        b: tuple

    tree = {"none": None, "t": True, "f": False,
            "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1,
                     -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                     -2 ** 63],
            "floats": [0.0, -1.5, 1e300, float("inf")],
            "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é"],
            "bins": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
            "wide": {str(i): i for i in range(20)}, "empty": {},
            "arrays": [np.zeros((), np.float32), np.arange(6, dtype=np.int32)
                       .reshape(2, 3), np.ones(3, np.float16),
                       np.array([True, False]), np.zeros((0, 4)),
                       np.arange(20000, dtype=np.uint8)],
            "scalars": [np.float32(2.5), np.int64(-3), np.bool_(True)],
            "complex": 1.5 - 2j, "pair": Pair(np.int32(1), {"w": np.ones(2)}),
            "box": Box(np.ones((2, 2)), (1, [2.0, "x"]))}
    want = serialization.to_bytes(tree)
    assert flax_msgpack.to_bytes(tree) == want
    got = flax_msgpack.from_bytes(want)
    assert flax_msgpack.to_bytes(got) == want
    ref = serialization.msgpack_restore(want)
    leaves = jax.tree_util.tree_leaves_with_path(ref)
    assert len(leaves) > 60
    for path, leaf in leaves:
        mine = got
        for key in path:
            mine = mine[key.key]
        assert type(mine) is type(leaf), jax.tree_util.keystr(path)
        np.testing.assert_array_equal(mine, leaf)
        if isinstance(leaf, np.ndarray):
            assert mine.dtype == leaf.dtype and mine.flags.writeable
    for bad in (object(), {1: 2}.keys(), jnp.ones(2)):
        with pytest.raises(TypeError, match="cannot encode"):
            flax_msgpack.to_bytes({"x": bad})
    for blob, match in ((b"\xc1", "outside flax's subset"),
                        (b"\xd4\x05\x00", "ext type 5"),
                        (want + b"\x00", "follow"), (want[:-1], "ends early"),
                        (serialization.to_bytes({"big": {
                            "__msgpack_chunked_array__": True}}), "chunked")):
        with pytest.raises(ValueError, match=match):
            flax_msgpack.from_bytes(blob)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_crosses_both_ways_bitwise(family, tmp_path):
    kind, cfg = FAMILIES[family]
    _, jstate = _jax_state(kind, cfg)
    filled = _filled(jstate, seed=len(family))
    # the codec on this family's JAX state: byte-equal, equal decoded
    flax_bytes = serialization.to_bytes(filled)
    assert flax_msgpack.to_bytes(filled) == flax_bytes
    decoded = flax_msgpack.from_bytes(flax_bytes)
    assert flax_msgpack.to_bytes(decoded) == flax_bytes
    want = serialization.msgpack_restore(flax_bytes)
    _assert_same_tree(decoded, want)

    # JAX .snap -> the port, through the drivers' resume
    opt, state = _port_state(kind, cfg)
    extra = PLATEAU if opt.lr_policy == "plateau" else None
    ckpt = str(tmp_path)
    snap = os.path.join(ckpt, f"{opt.model_name}_1_state.snap")
    j_save(snap, filled, 3, extra=extra)
    logs = []
    start, got_extra = resume_train_state(
        opt.replace(resume=True), state, ckpt, 1, logs.append)
    assert (start, got_extra) == (4, extra)
    assert logs == [f"[fold 1] resumed from epoch 3 "
                    f"({opt.model_name}_1_state.snap)"]
    os.remove(snap)     # a few hundred MB: the ResNet18 trunk four times
    _assert_same_tree(jax_snapshot_tree(state, opt), want)
    assert state.optimizer.count == 7 and state.step == 5

    # the port's .snap -> the JAX package's load_train_state
    path = os.path.join(ckpt, "port.snap")
    save_jax_snapshot(path, state, opt, 3, extra)
    restored, epoch, j_extra = j_load(path, jstate, with_extra=True)
    os.remove(path)
    assert (epoch, j_extra) == (3, extra)
    _assert_same_tree(_port_tree_of_jax(restored), want)


def _raises_on(tmp_path, edit, match):
    cfg = OMIC
    opt, state = _port_state("teacher", cfg)
    path = os.path.join(str(tmp_path), "t.snap")
    save_jax_snapshot(path, state, opt, 1)
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    tree = flax_msgpack.from_bytes(payload["state_bytes"])
    edit(tree)
    payload["state_bytes"] = flax_msgpack.to_bytes(tree)
    with open(path, "wb") as fh:
        pickle.dump(payload, fh)
    with pytest.raises(ValueError, match=match):
        load_jax_snapshot(path, _port_state("teacher", cfg)[1], opt)


EDITS = {
    "extra_head": (lambda t: t["params"].update(hkd_gnn_s={"w0": {}}),
                   "holds /params/hkd_gnn_s, which the port's state"),
    "extra_bank": (lambda t: t["banks"].update(hkd={}),
                   "holds /banks/hkd, which"),
    "missing_moment": (lambda t: t["opt_state"]["1"].pop("nu"),
                       "lacks /opt_state/1/nu, which"),
    "other_chain": (lambda t: t.update(opt_state={
        "count": np.int32(0), "mu": {}, "nu": {}}),
        "holds /opt_state/count, which"),
    "wrong_shape": (lambda t: t["banks"]["fuse"].update(
        memory_v1=np.zeros((3, 8), np.float32)),
        "/banks/fuse/memory_v1: shape"),
}


@pytest.mark.parametrize("edit", sorted(EDITS))
def test_snapshot_the_port_cannot_take_raises_naming_the_key(edit, tmp_path):
    _raises_on(tmp_path, *EDITS[edit])


def _driver_opts(root, **kw):
    common = dict(mode="omic", task="grad", omic_dim=8, input_size_path=32,
                  batch_size=8, lr=1e-3, verbose=0, checkpoints_dir=root,
                  host_workers=2, reg_type="none", CRD_distill=0,
                  pred_distill=0, snapshot_every=1, niter=0,
                  lr_policy="plateau", exp_name="e", **kw)
    return JOptions(**common), Options(**common)


def test_drivers_resume_each_others_snapshots(tmp_path, monkeypatch):
    """A JAX fold stopped after epoch 1 is carried on by the port's
    ``train_teacher`` from its ``.snap`` (the restored state equal to the
    JAX state bitwise, the plateau tracker from the snapshot's ``extra``),
    and a port fold's state written by ``save_jax_snapshot`` is carried on
    by the JAX ``train_teacher``."""
    root = str(tmp_path)
    data = make_synthetic_splits(n_train=24, n_test=8, roi_size=32, seed=12)
    jopt, opt = _driver_opts(root, model_name="j", niter_decay=1)
    j_train(jopt, data, fold=1, log=lambda *a: None)
    snap = os.path.join(root, "e", "j", "j_1_state.snap")
    with open(snap, "rb") as fh:
        payload = pickle.load(fh)
    want = serialization.msgpack_restore(payload["state_bytes"])

    seen = {}

    def spy(opt, state, ckpt_dir, fold, log):
        out = resume_train_state(opt, state, ckpt_dir, fold, log)
        # copies: on the CPU the tree's arrays share the live tensors'
        # memory, which the next epoch updates
        seen["tree"] = jax.tree_util.tree_map(
            np.array, jax_snapshot_tree(state, opt))
        seen["lr_scale"] = state.optimizer.lr_scale
        return out

    monkeypatch.setattr(ploop, "resume_train_state", spy)
    logs = []
    res, _ = ploop.train_teacher(opt.replace(niter_decay=2, resume=True),
                                 data, 1, device="cpu", log=logs.append)
    assert "[fold 1] resumed from epoch 1 (j_1_state.snap)" in logs
    _assert_same_tree(seen["tree"], want)
    assert seen["lr_scale"] == float(
        want["opt_state"]["hyperparams"]["lr_scale"])
    assert res["n"] == 8 and np.isfinite(res["loss"])
    monkeypatch.undo()

    # the other way: a port fold's snapshot, as a .snap, to the JAX driver
    _, opt = _driver_opts(root, model_name="p", niter_decay=1)
    ploop.train_teacher(opt, data, 1, device="cpu", log=lambda *a: None)
    base = os.path.join(root, "e", "p", "p_1_state")
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 3), 24,
                                      device="cpu")
    epoch, extra = load_train_state(f"{base}.pt", state)
    save_jax_snapshot(f"{base}.snap", state, opt, epoch, extra)
    os.remove(f"{base}.pt")
    jopt, _ = _driver_opts(root, model_name="p", niter_decay=2, resume=True)
    template = jsteps.init_teacher_state(
        jopt, j_define(jopt), j_optim(jopt, j_sched(jopt, 3)),
        jax.random.PRNGKey(0), 24, {"x_omic": jnp.zeros((1, 80))})
    restored, j_epoch, j_extra = j_load(f"{base}.snap", template,
                                        with_extra=True)
    assert (j_epoch, j_extra) == (epoch, extra) and "plateau" in extra
    _assert_same_tree(_port_tree_of_jax(restored),
                      jax_snapshot_tree(state, opt))
    logs = []
    j_res, _ = j_train(jopt, data, fold=1, log=logs.append)
    assert "[fold 1] resumed from epoch 1" in logs
    assert np.isfinite(j_res["loss"])


def test_teacher_one_step_after_each_resume(interpret_pallas,
                                            no_onednn_convs, monkeypatch,
                                            tmp_path):
    """The JAX benchmark's teacher (``tests/test_torch_port_step.py``'s
    ``bench`` configuration, views injected, dropout 0), its Adam moments,
    counters and step advanced as by a few steps: through a ``.snap`` into
    the port (bitwise) and one step of each package from it; then the
    port's new state through ``save_jax_snapshot`` into the JAX package
    (bitwise) and one step of each again.  Both steps start the packages
    from the same bytes and are held at that test's tolerances."""
    jopt = JOptions(**STEP_DIMS, **STEP_CONFIGS["bench"])
    opt = Options(**STEP_DIMS, **STEP_CONFIGS["bench"])
    jmodel = j_define(jopt)
    tx = j_optim(jopt, j_sched(jopt, steps_per_epoch=50))
    jinit = jsteps.init_teacher_state(
        jopt, jmodel, tx, jax.random.PRNGKey(7), STEP_N,
        {"x_path": jnp.zeros((1, STEP_SIZE, STEP_SIZE, 3)),
         "x_omic": jnp.zeros((1, 80))})
    rng = np.random.default_rng(0)
    adam = jax.tree_util.tree_map(
        lambda x: (np.full(x.shape, 3, x.dtype) if x.dtype == np.int32
                   else (1e-3 * rng.standard_normal(x.shape, np.float32))),
        jinit.opt_state[1])
    adam = adam._replace(nu=jax.tree_util.tree_map(np.square, adam.nu))
    advanced = jinit.replace(
        step=np.asarray(3, np.int32),
        opt_state=(jinit.opt_state[0], adam,
                   jinit.opt_state[2]._replace(count=np.asarray(3, np.int32))))

    # one pair of views for both steps: the jitted JAX step holds them as
    # a constant
    views = step_batch(seed=20)[1]
    monkeypatch.setattr(jsteps, "augment_views",
                        lambda key, v, dtype=None: jnp.asarray(views))
    monkeypatch.setattr(psteps, "augment_views",
                        lambda gen, v, dtype=None: torch.from_numpy(views))
    jstep = jsteps.build_teacher_train_step(jopt, jmodel, tx)
    pstep = psteps.build_teacher_train_step(opt)

    def both_steps(path, state, i):
        """One step of each package, the JAX one from the snapshot at
        ``path`` (restored by its ``load_train_state``)."""
        jstate, _ = j_load(path, jinit)
        os.remove(path)
        batch = step_batch(seed=20 + i)[0]
        jnew, jmetrics = jstep(jax.tree_util.tree_map(jnp.asarray, jstate),
                               {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(i), jnp.asarray(0.1))
        state, metrics = pstep(state, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}, 0.1)
        for k in jmetrics:
            np.testing.assert_allclose(metrics[k].numpy(), jmetrics[k],
                                       **WHOLE, err_msg=f"step {i} {k}")
        got, want = jax_state_tree(state), step_jax_tree(jnew)
        assert got["step"] == want["step"] == i
        assert got["adam"]["count"] == want["adam"]["count"] == i
        for k in ("batch_stats", "ema_batch_stats", "banks"):
            assert_trees_close(got[k], want[k], f"step {i} {k}", **WHOLE)
        # the moments: the trunk by norm (fp32 ReLU kinks move single
        # elements of its gradient, tests/test_torch_port_student.py),
        # the rest elementwise
        trunk = lambda t: t["model"]["path_net"]
        for k in ("mu", "nu"):
            g, w = got["adam"][k], want["adam"][k]
            a, b = (np.concatenate([np.ravel(x) for n, x in
                                    jax.tree_util.tree_leaves_with_path(
                                        trunk(t)) if "fc_new" not in
                                    jax.tree_util.keystr(n)])
                    for t in (g, w))
            rel = np.linalg.norm(a - b) / np.linalg.norm(b)
            assert rel <= 2e-2, f"step {i} {k} trunk: {rel:.3e}"
            for t in (g, w):
                t["model"]["path_net"] = {
                    n: v for n, v in trunk(t).items() if "fc_new" in n}
            assert_trees_close(g, w, f"step {i} {k}", rtol=2e-3, atol=1e-6,
                               leaf_atol=2e-3)
        return state

    root = str(tmp_path)
    snap = os.path.join(root, f"{opt.model_name}_1_state.snap")
    j_save(snap, advanced, 1)
    with open(snap, "rb") as fh:
        want = serialization.msgpack_restore(pickle.load(fh)["state_bytes"])
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 50), STEP_N,
                                      device="cpu")
    assert resume_train_state(opt.replace(resume=True), state, root, 1,
                              lambda *a: None) == (2, None)
    _assert_same_tree(jax_snapshot_tree(state, opt), want)
    state = both_steps(snap, state, 4)

    path = os.path.join(root, "port.snap")
    save_jax_snapshot(path, state, opt, 2)
    restored, _ = j_load(path, jinit)
    _assert_same_tree(_port_tree_of_jax(restored),
                      jax_snapshot_tree(state, opt))
    both_steps(path, state, 5)
