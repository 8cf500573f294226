"""``--data_parallel`` of the port on the CPU: two ranks over gloo against
the port's single-process step on the global batch, and against the JAX
package's step sharded over 2 of the 8 virtual CPU devices.

One launch of two ranks (``parallel.launch``, one torch thread each, a
60 s collective timeout and a 240 s deadline that kills both ranks) runs
every world-2 side: one step of each of the five families of
``tests/test_sharding.py`` (``tests/_torch_dp_ranks.py``: augmentation
and the Kronecker dropout on, every ``nn.Dropout`` at 0), the teacher
step of ``tests/test_torch_port_step.py``'s benchmark configuration from
the JAX package's state, and the teacher driver on
``tests/test_data_parallel.py``'s synthetic split, with a snapshot per
epoch and a ``--resume``.  The world-1 sides run in this process while
the ranks run.

Tolerances.  The loss parts at rtol 1e-4 / atol 1e-5 (measured: below
2e-6 relative).  The BatchNorm buffers of the model and the EMA and the
banks at rtol 1e-4 / atol 1e-5.  Adam's first moments as
``tests/test_torch_port_step.py`` holds them against JAX (rtol 2e-3, an
atol of 2e-3 times each tensor's largest element; 5e-6 on the biases that
feed a train-mode BatchNorm, whose exact gradient is 0).  The updated
parameters within 2 lr of each other: Adam's first step is about
lr * sign(g), and a gradient near 0 may change sign between two orders of
summation.  The two ranks' states are bitwise equal.  The driver's
per-epoch train loss at rel 1e-4 (measured: below 1e-5; JAX's own test
holds rel 0.01).
"""
import json
import os
import pickle
import threading
from datetime import timedelta

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import _torch_dp_ranks as ranks
import multimodal_learning_tpu.train.steps as jsteps
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.parallel import launch, mesh
from multimodal_learning_tpu_torch.train.loop import train_teacher
from test_torch_port_step import (CONFIGS, DIMS, N_DATA, SIZE, WHOLE,
                                  _assert_trees_close, _batch, _jax_tree)

LAUNCH = dict(device="cpu", threads=1, timeout=timedelta(seconds=60),
              deadline=240)
TIGHT = dict(rtol=1e-4, atol=1e-5)
# the biases that feed a train-mode BatchNorm, by the port's names
BEFORE_BN = ("fusion.encoder1.0.bias", "fusion.encoder2.0.bias",
             "path_net.fc_new1.0.bias", "fc_new1.0.bias")


CLI = ("--synthetic_data --synthetic_folds 1 --mode pathomic --task grad "
       "--niter 0 --niter_decay 1 --batch_size 8 --input_size_path 32 "
       "--path_dim 8 --omic_dim 8 --mmhid 8 --feat_dim 8 --CRD_distill 0 "
       "--pred_distill 1 --reg_type none --model_name vt --data_parallel 2 "
       "--checkpoints_dir").split()


def _in_thread(fn):
    """Runs ``fn()`` in a thread; ``join()`` returns its value or raises
    its error."""
    box = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as exc:   # re-raised by join
            box["error"] = exc

    th = threading.Thread(target=run)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["value"]
    return join


def _jax_step_data_parallel_2(jopt, jstate, batch, views):
    """The JAX teacher step with ``data_parallel=2``: the batch sharded
    over 2 of the 8 virtual CPU devices, the state replicated, the
    Kronecker kernels in interpret mode, ``views`` injected."""
    import multimodal_learning_tpu.ops.kron_fusion as kf
    orig = pl.pallas_call

    def interpret(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MML_PALLAS_FORCE", "1")
        mp.setattr(pl, "pallas_call", interpret)
        mp.setattr(kf.pl, "pallas_call", interpret)
        mp.setattr(jsteps, "augment_views",
                   lambda key, v, dtype=None: jnp.asarray(views))
        devs = Mesh(np.array(jax.devices()[:2]), ("data",))
        state = jax.device_put(jstate, NamedSharding(devs, P()))
        jbatch = {k: jax.device_put(v, NamedSharding(devs, P("data")))
                  for k, v in batch.items()}
        return jsteps.build_teacher_train_step(
            jopt, j_define(jopt), j_optim(jopt, j_sched(jopt, 50)))(
                state, jbatch, jax.random.PRNGKey(1), jnp.asarray(0.1))


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """Everything this file compares, computed at once: the ranks'
    values (:func:`_torch_dp_ranks.run_all`) and the CLI's results (it
    launches its own two ranks), each launch from a thread, while this
    process builds the JAX package's state (which it hands to the ranks
    through a file), and computes the world-1 families, the world-1
    driver runs and the JAX step with ``data_parallel=2``."""
    from multimodal_learning_tpu_torch.cli import train_cv_MT
    root = str(tmp_path_factory.mktemp("dp"))
    bridged = os.path.join(root, "bridged.pkl")
    n = torch.get_num_threads()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MML_PLATFORM", "cpu")
        mp.setattr(mesh, "TIMEOUT", LAUNCH["timeout"])
        mp.setattr(mesh, "DEADLINE", LAUNCH["deadline"])
        torch.set_num_threads(2)   # the CLI's ranks take one thread each
        try:
            ranks_done = _in_thread(lambda: launch(
                ranks.run_all, 2,
                (list(ranks.FAMILIES), bridged, os.path.join(root, "w2")),
                **LAUNCH))
            cli_done = _in_thread(lambda: train_cv_MT.main(
                CLI + [os.path.join(root, "cli")]))
            handed = None
            try:
                jopt = JOptions(**DIMS, **CONFIGS["bench"])
                batch, views = _batch(seed=5)
                jstate = jsteps.init_teacher_state(
                    jopt, j_define(jopt), j_optim(jopt, j_sched(jopt, 50)),
                    jax.random.PRNGKey(7), N_DATA,
                    {"x_path": jnp.zeros((1, SIZE, SIZE, 3)),
                     "x_omic": jnp.zeros((1, 80))})
                handed = (Options(**DIMS, **CONFIGS["bench"]),
                          _jax_tree(jstate), batch, views)
            finally:
                with open(bridged + ".tmp", "wb") as fh:
                    pickle.dump(handed, fh)
                os.replace(bridged + ".tmp", bridged)
            ref = ranks.run_families(list(ranks.FAMILIES))
            ref_driver = ranks.run_driver(os.path.join(root, "w1"), 0)
            jax_out = _jax_step_data_parallel_2(jopt, jstate, batch, views)
        finally:
            values, cli = ranks_done(), cli_done()
            torch.set_num_threads(n)
    return {"values": values, "ref": ref, "root": root, "jax": jax_out,
            "cli": cli, "ref_driver": ref_driver}


def _close_params(got, want, what, lr):
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k], w, **TIGHT,
                                       err_msg=f"{what}.{k}")
        elif not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k], w, rtol=0, atol=2.02 * lr,
                                       err_msg=f"{what}.{k}")
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=f"{what}.{k}")


@pytest.mark.parametrize("family", sorted(ranks.FAMILIES))
def test_world2_step_matches_world1(family, world2):
    values, ref = world2["values"], world2["ref"]
    got, want = values[0]["families"][family], ref[family]
    for k, w in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], w, **TIGHT, err_msg=k)
    lr = ranks.family_opt(family).lr
    _close_params(got["model"], want["model"], "model", lr)
    _close_params(got["ema"], want["ema"], "ema", lr)
    _close_params(got["embeds"], want["embeds"], "embeds", lr)
    for k, w in want["banks"].items():
        np.testing.assert_allclose(got["banks"][k], w, **TIGHT, err_msg=k)
    for k, w in want["exp_avg"].items():
        tol = 5e-6 if k.endswith(BEFORE_BN) else max(
            1e-6, 2e-3 * float(np.abs(w).max(initial=0.0)))
        np.testing.assert_allclose(got["exp_avg"][k], w, rtol=2e-3, atol=tol,
                                   err_msg=k)
    # the state is replicated: both ranks hold the same bits
    other = values[1]["families"][family]
    for part in ("model", "ema", "embeds", "banks", "exp_avg"):
        assert other[part] == ranks.digest(got[part]), part


# Adam's first moments of the ResNet trunk's convolutions and BatchNorms
# are held by the norm of the difference: on this batch the JAX step
# sharded over 2 devices gives them up to 0.9 % of their norm (and 5e-2
# of an element's rule) away from its own single-device step, while the
# port's world-2 step lands within 1e-4 of its world-1 step there.


def _trunk(tree):
    """Removes and returns the trunk's leaves (``path_net`` but its
    ``fc_new*`` heads) of a moment tree."""
    net = tree["model"]["path_net"]
    return {k: net.pop(k) for k in list(net) if not k.startswith("fc_new")}


def test_world2_teacher_step_matches_jax_data_parallel_2(world2):
    """The benchmark configuration's step at world 2 from the JAX
    package's state against the JAX step with ``data_parallel=2``, on the
    same batch and injected views, at ``tests/test_torch_port_step.py``'s
    tolerances; Adam's first moments of the ResNet trunk by the norm of
    the difference, at 2e-2 of the JAX moment's norm, as ``chip_smoke.py``
    holds them between two devices."""
    jnew, jmetrics = world2["jax"]
    got = world2["values"][0]["bridged"]
    assert set(got["metrics"]) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(got["metrics"][k], jmetrics[k], **WHOLE,
                                   err_msg=k)
    want = _jax_tree(jnew)
    for part in ("batch_stats", "ema_batch_stats", "banks"):
        _assert_trees_close(got["tree"][part], want[part], part, **WHOLE)
    mu, jmu = got["tree"]["adam"]["mu"], want["adam"]["mu"]
    trunk, jtrunk = _trunk(mu), _trunk(jmu)
    _assert_trees_close(mu, jmu, "exp_avg", rtol=2e-3, atol=1e-6,
                        leaf_atol=2e-3)
    flat = jax.tree_util.tree_flatten_with_path
    assert len(flat(jtrunk)[0]) > 40
    for (path, a), (_, b) in zip(flat(trunk)[0], flat(jtrunk)[0]):
        diff = np.linalg.norm(np.asarray(a) - np.asarray(b))
        assert diff <= 2e-2 * np.linalg.norm(b), jax.tree_util.keystr(path)


def _series(root, name):
    path = os.path.join(root, "grad_15", name, "metrics.jsonl")
    with open(path) as fh:
        return [json.loads(line)["train_loss"] for line in fh]


def test_teacher_driver_world2_matches_world1_and_resumes(world2):
    """``train_teacher`` at ``--data_parallel`` 2 (in the launched ranks)
    against 0 on ``tests/test_data_parallel.py``'s split, one epoch with a
    snapshot, then ``--resume`` to a second: the per-epoch train loss;
    only rank 0 logs and writes (one metrics line per epoch); both ranks
    load rank 0's snapshot and evaluate alike."""
    values, root = world2["values"], world2["root"]
    s1 = _series(os.path.join(root, "w1"), "dp0")
    s2 = _series(os.path.join(root, "w2"), "dp2")
    assert len(s1) == len(s2) == 2
    np.testing.assert_allclose(s2, s1, rtol=1e-4)
    logs0, logs1 = (v["driver"]["logs"] for v in values)
    assert "[fold 1] resumed from epoch 1 (dp2_1_state.pt)" in logs0
    assert logs1 == []
    want = world2["ref_driver"]["resumed"]
    for v in values:
        got = v["driver"]["resumed"]
        assert got["n"] == want["n"] == 16
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_array_equal(
        values[1]["driver"]["resumed"]["probs"]["fuse"],
        values[0]["driver"]["resumed"]["probs"]["fuse"])


def test_cli_launches_two_ranks_and_returns_rank0(world2):
    """``train_cv_MT --data_parallel 2`` under ``MML_PLATFORM=cpu`` spawns
    its two ranks and returns rank 0's results; only rank 0 writes."""
    out, root = world2["cli"], os.path.join(world2["root"], "cli")
    assert list(out) == [1] and out[1]["n"] == 32
    assert np.isfinite(out[1]["probs"]["fuse"]).all()
    assert os.path.exists(os.path.join(root, "grad_15", "vt", "vt_1.pt"))
    assert len(_series(root, "vt")) == 1


def test_data_parallel_validates_before_it_launches():
    """The JAX package's refusals, raised in the calling process: a batch
    the ranks cannot split, more ranks than CUDA devices."""
    data = ranks.driver_data()
    with pytest.raises(ValueError, match="divisible by the data-parallel"):
        train_teacher(ranks.driver_opt(2, "/nonexistent").replace(
            batch_size=7), data, 1, device="cpu")
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="device\\(s\\) are visible"):
        mesh.world_size(ranks.driver_opt(n + 1, ""), "cuda")
