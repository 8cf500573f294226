"""AdaBound, Adagrad and the onecycle schedule of the port against the JAX
package's (``train/optim.py``, ``train/schedules.py``).

Both optimizers run 20 updates from the same seeded parameters on the same
seeded gradients (a zero gradient on one tensor, as a parameter the loss
does not reach), the parameters held after every update at rtol 1e-5 /
atol 1e-7: AdaBound under ``linear`` (the LR changes within the run),
``onecycle`` and ``plateau`` with a scale of 0.2; Adagrad with L2 weight
decay under ``linear``.  ``onecycle`` is held to
``optax.cosine_onecycle_schedule`` at step 0, both boundaries and the
steps beside them, and T, at rtol 1e-6.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.train import make_lr_schedule as j_sched
from multimodal_learning_tpu.train import make_optimizer as j_make
from multimodal_learning_tpu.train.optim import set_plateau_scale
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.train import (make_lr_schedule,
                                                 make_optimizer)

SHAPES = {"a": (5, 7), "b": (7,), "c": (2, 3, 4), "frozen": (6,)}
STEPS_PER_EPOCH, N_UPDATES = 3, 20


def _run(kw, scale=None):
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = [{k: (np.zeros(s, np.float32) if k == "frozen" else
                  rng.normal(scale=0.1, size=s).astype(np.float32))
              for k, s in SHAPES.items()} for _ in range(N_UPDATES)]

    jopt = JOptions(**kw)
    tx = j_make(jopt, j_sched(jopt, STEPS_PER_EPOCH))
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    if scale is not None:
        jstate = set_plateau_scale(jstate, scale)

    opt = Options(**kw)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in init.items()}
    ptx = make_optimizer(opt, list(params.values()),
                         make_lr_schedule(opt, STEPS_PER_EPOCH))
    if scale is not None:
        ptx.lr_scale = scale
    for i, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        ptx.zero_grad()
        for k, p in params.items():
            if k != "frozen":
                p.grad = torch.from_numpy(g[k])
        ptx.step()
        for k in SHAPES:
            np.testing.assert_allclose(params[k].detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"update {i}: {k}")
    return params


BASE = dict(lr=2e-3, final_lr=0.1, niter=2, niter_decay=5, weight_decay=4e-4)


@pytest.mark.parametrize("policy,scale", [("linear", None),
                                          ("onecycle", None),
                                          ("plateau", 0.2)])
def test_adabound_matches_scale_by_adabound(policy, scale):
    params = _run(dict(BASE, optimizer_type="adabound", lr_policy=policy),
                  scale)
    # no weight decay, whatever --weight_decay says: a zero gradient still
    # moves the parameter only through AdaBound's own momentum (none here)
    rng = np.random.default_rng(0)
    init = {k: rng.normal(size=s).astype(np.float32)
            for k, s in SHAPES.items()}
    np.testing.assert_array_equal(params["frozen"].detach().numpy(),
                                  init["frozen"])


def test_adagrad_matches_the_optax_chain():
    params = _run(dict(BASE, optimizer_type="adagrad", lr_policy="linear"))
    assert torch.isfinite(params["frozen"]).all()


def test_onecycle_matches_optax():
    opt = Options(lr_policy="onecycle", niter=3, niter_decay=5, lr=0.5)
    total = (opt.niter + opt.niter_decay) * 7
    want = optax.cosine_onecycle_schedule(transition_steps=total,
                                          peak_value=1e-3)
    got = make_lr_schedule(opt, 7)
    j_got = j_sched(JOptions(lr_policy="onecycle", niter=3, niter_decay=5,
                             lr=0.5), 7)
    b = int(0.3 * total)
    for step in (0, b - 1, b, b + 1, total - 1, total):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))),
                                   rtol=1e-6, err_msg=str(step))
        np.testing.assert_allclose(got(step), float(j_got(jnp.int32(step))),
                                   rtol=1e-6, err_msg=str(step))
