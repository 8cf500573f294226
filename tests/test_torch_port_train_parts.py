"""The port's training parts against the JAX package's, one function at a
time: augmentation, losses, the CRD bank, BatchNorm's train-mode update,
EMA, LR schedules and Adam.

Inputs come from a numpy seed; where a JAX function draws random numbers,
the test repeats its key splits to recover the draws and feeds them to the
port's *apply* function.  Tolerance rtol 1e-5 / atol 1e-6 (fp32) unless a
test states another and why.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multimodal_learning_tpu import contrast as jc
from multimodal_learning_tpu import losses as jl
from multimodal_learning_tpu.data import augment as ja
from multimodal_learning_tpu_torch import contrast as pc
from multimodal_learning_tpu_torch import losses as pl_
from multimodal_learning_tpu_torch.data import augment as pa

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))   # a writable copy


def _close(got, want, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


# ------------------------------------------------------------- augmentation

def _jax_draws(key, b):
    """The flips and jitter factors ``augment_view(key, ...)`` draws."""
    kf, kj = jax.random.split(key)
    kh, kv = jax.random.split(kf)
    flips = pa.Flips(
        _t(np.asarray(jax.random.bernoulli(kh, 0.5, (b,)))),
        _t(np.asarray(jax.random.bernoulli(kv, 0.5, (b,)))))
    kb, kc, ks, khue = jax.random.split(kj, 4)
    u = lambda k, lo, hi: _t(np.asarray(jax.random.uniform(
        k, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b))
    jitter = pa.Jitter(u(kb, 0.9, 1.1), u(kc, 0.9, 1.1), u(ks, 0.95, 1.05),
                       _t(np.asarray(jax.random.uniform(
                           khue, (b,), minval=-0.01, maxval=0.01))))
    return flips, jitter


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_augment_view_matches_jax_on_its_draws(dtype):
    """fp32 at 2e-6 absolute: the output is x*2-1 of values in [0, 1] whose
    contrast mean sums 1024 pixels, so last-bit differences double.  bf16
    at one bf16 step of the [-1, 1] output (2^-7): XLA and torch round the
    blended intermediates at different places."""
    imgs = np.random.default_rng(0).integers(0, 256, (6, 32, 32, 3),
                                             dtype=np.uint8)
    key = jax.random.PRNGKey(3)
    want = ja.augment_view(key, jnp.asarray(imgs), dtype=getattr(jnp, dtype))
    flips, jitter = _jax_draws(key, 6)
    assert flips.horizontal.any() and not flips.horizontal.all()
    got = pa.augment_view_apply(_t(imgs), flips, jitter,
                                dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    tol = (dict(rtol=0, atol=2e-6) if dtype == "float32"
           else dict(rtol=0, atol=2 ** -7))
    _close(got, np.asarray(want, np.float32), **tol)


def test_flips_normalize_and_views():
    x = np.random.default_rng(1).integers(0, 256, (4, 8, 8, 3),
                                          dtype=np.uint8)
    flips = pa.Flips(torch.tensor([True, False, True, False]),
                     torch.tensor([True, True, False, False]))
    want = np.stack([x[0, ::-1, ::-1], x[1, ::-1], x[2, :, ::-1], x[3]])
    np.testing.assert_array_equal(pa.apply_flips(_t(x), flips).numpy(), want)
    _close(pa.normalize_batch(_t(x)), ja.normalize_batch(jnp.asarray(x)))
    gen = torch.Generator().manual_seed(0)
    views = np.stack([x, x], axis=1)
    out = pa.augment_views(gen, _t(views), dtype=torch.bfloat16)
    assert out.shape == views.shape and out.dtype == torch.bfloat16
    assert float(out.float().abs().max()) <= 1.0
    assert not torch.equal(out[:, 0], out[:, 1])   # independent draws


# --------------------------------------------------------------------- losses

def test_nll_and_cox_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(8, 3)).astype(np.float32)
    logp = np.asarray(jax.nn.log_softmax(logits))
    g = rng.integers(0, 3, 8).astype(np.int32)
    _close(pl_.nll_loss(_t(logp), _t(g)),
           jl.nll_loss(jnp.asarray(logp), jnp.asarray(g)))
    t = np.array([5.0, 3.0, 3.0, 9.0, 1.0, 7.0, 7.0, 2.0], np.float32)
    e = (rng.random(8) < 0.7).astype(np.float32)
    haz = rng.normal(size=(8, 1)).astype(np.float32) * 3
    _close(pl_.cox_loss(_t(t), _t(e), _t(haz)),
           jl.cox_loss(jnp.asarray(t), jnp.asarray(e), jnp.asarray(haz)))


@pytest.mark.parametrize("reg_type", ["none", "all", "omic", "mm", "path"])
def test_l1_regularizer_matches_jax(reg_type):
    from multimodal_learning_tpu.models import PathomicModel as JPathomic
    from multimodal_learning_tpu_torch.models import (PathomicModel,
                                                      state_dict_from_flax)
    dims = dict(path_dim=8, omic_dim=8, mmhid=8)
    v = JPathomic(**dims).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x_path=jnp.zeros((1, 32, 32, 3)), x_omic=jnp.zeros((1, 80)),
        train=False)
    port = PathomicModel(**dims)
    port.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, v["params"]),
        jax.tree_util.tree_map(np.asarray, v["batch_stats"])))
    want, jgrad = jax.value_and_grad(jl.l1_regularizer)(v["params"],
                                                         reg_type)
    got = pl_.l1_regularizer(port, reg_type)
    _close(got, want, rtol=1e-5, atol=1e-4)
    if reg_type == "none":
        return
    got.backward()   # the gradient at the zero-initialised biases is +1
    gsd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jgrad),
                               jax.tree_util.tree_map(np.asarray,
                                                      v["batch_stats"]))
    for name, p in port.named_parameters():
        _close(p.grad if p.grad is not None else torch.zeros_like(p),
               gsd[name], rtol=0, atol=0)


@pytest.mark.parametrize("task", ["grad", "surv"])
def test_pred_kd_loss_matches_jax(task):
    rng = np.random.default_rng(3)
    s = np.array(jax.nn.log_softmax(rng.normal(size=(5, 3)) * 2))
    t = np.array(jax.nn.log_softmax(rng.normal(size=(5, 3)) * 2))
    t[0, 1] = -np.inf                    # a teacher probability of 0
    s, t = s.astype(np.float32), t.astype(np.float32)
    for per_sample in (False, True):
        _close(pl_.pred_kd_loss(_t(s), _t(t), task, per_sample),
               jl.pred_kd_loss(jnp.asarray(s), jnp.asarray(t), task,
                               per_sample))


def test_distill_kl_sp_and_orth_match_jax_with_gradients():
    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(2))
    for per_sample in (False, True):
        _close(pl_.distill_kl(_t(a), _t(b), 4.0, per_sample),
               jl.distill_kl(jnp.asarray(a), jnp.asarray(b), 4.0,
                             per_sample))
    for port_fn, jax_fn in ((pl_.sp_loss, jl.sp_loss),
                            (pl_.orth_loss, jl.orth_loss)):
        ta, tb = _t(a).requires_grad_(), _t(b).requires_grad_()
        loss = port_fn(ta, tb)
        loss.backward()
        want, (ga, gb) = jax.value_and_grad(jax_fn, argnums=(0, 1))(
            jnp.asarray(a), jnp.asarray(b))
        _close(loss, want)
        _close(ta.grad, ga)
        # sp_loss detaches the teacher side: no gradient, zeros in JAX
        _close(tb.grad if tb.grad is not None else torch.zeros_like(tb), gb)


# ------------------------------------------------------------------------ CRD

def test_embed_matches_jax():
    x = np.random.default_rng(5).normal(size=(4, 12)).astype(np.float32)
    for mlp in (True, False):
        jmod = jc.Embed(8, mlp=mlp)
        p = jax.tree_util.tree_map(
            np.asarray, jmod.init(jax.random.PRNGKey(0), x)["params"])
        port = pc.Embed(12, 8, mlp=mlp)
        port.load_state_dict({f"{fc}.{k}": _t(p[fc][src].T if k == "weight"
                                              else p[fc][src])
                              for fc in p for k, src in (("weight", "kernel"),
                                                         ("bias", "bias"))})
        _close(port(_t(x)), jmod.apply({"params": p}, x))


def test_crd_scores_bank_update_and_z_match_jax():
    """Two steps of the classic CRD bank: the first sets Z from its batch,
    the second keeps it; scores, rows and Z after each."""
    rng = np.random.default_rng(6)
    n_data, dim, B, k = 20, 8, 4, 6
    jbank = jc.init_bank(jax.random.PRNGKey(0), n_data, dim)
    pbank = pc.CRDBank(*(_t(np.array(a)) for a in jbank))
    for step in range(2):
        v1, v2 = (rng.normal(size=(B, dim)).astype(np.float32)
                  for _ in range(2))
        v1 /= np.linalg.norm(v1, axis=1, keepdims=True)
        v2 /= np.linalg.norm(v2, axis=1, keepdims=True)
        y = rng.choice(n_data, B, replace=False).astype(np.int32)
        idx = rng.integers(0, n_data, (B, 1 + k)).astype(np.int32)
        idx[:, 0] = y
        ov1, ov2, jbank = jc.crd_scores(jbank, *map(jnp.asarray,
                                                    (v1, v2, y, idx)))
        pv1, pv2 = pc.crd_scores(pbank, _t(v1), _t(v2), _t(y), _t(idx))
        _close(pv1, ov1)
        _close(pv2, ov2)
        for name in ("memory_v1", "memory_v2", "z_v1", "z_v2"):
            _close(getattr(pbank, name), getattr(jbank, name),
                   rtol=1e-5, atol=1e-6)
        for n_pos in (1, 3):
            _close(pc.contrast_loss(pv1, n_data, n_pos),
                   jc.contrast_loss(ov1, n_data, n_pos))
    assert float(pbank.z_v1) > 0


# ----------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("shape", [(16, 12), (4, 6, 5, 5)])
def test_batchnorm_train_update_follows_flax(shape):
    """The port's BatchNorm updates its running variance with the biased
    batch variance, as flax does; torch's own BatchNorm uses the unbiased
    one and misses by n/(n-1) in the new part (16/15 at 16 rows)."""
    from flax import linen as fnn
    from multimodal_learning_tpu_torch.models.common import (BatchNorm1d,
                                                             BatchNorm2d)
    rng = np.random.default_rng(7)
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    c = shape[1]
    xj = x if len(shape) == 2 else x.transpose(0, 2, 3, 1)   # NHWC
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                       epsilon=1e-5)
    v = bn.init(jax.random.PRNGKey(0), xj)
    yj, mut = bn.apply(v, xj, mutable=["batch_stats"])
    want = mut["batch_stats"]
    ported = (BatchNorm1d if len(shape) == 2 else BatchNorm2d)(c).train()
    y = ported(_t(x))
    _close(ported.running_mean, want["mean"])
    _close(ported.running_var, want["var"])
    yt = y if len(shape) == 2 else y.permute(0, 2, 3, 1)
    _close(yt, yj, rtol=1e-4, atol=1e-5)
    torch_bn = (torch.nn.BatchNorm1d if len(shape) == 2
                else torch.nn.BatchNorm2d)(c).train()
    torch_bn(_t(x))
    n = x.size // c
    new_part = (np.asarray(want["var"]) - 0.9) / 0.1
    np.testing.assert_allclose(
        (torch_bn.running_var.numpy() - 0.9) / 0.1, new_part * n / (n - 1),
        rtol=1e-4)
    assert not np.allclose(torch_bn.running_var.numpy(), want["var"],
                           rtol=1e-5, atol=1e-6)


# ------------------------------------------------ EMA, schedules, optimizer

def test_ema_update_matches_jax():
    from multimodal_learning_tpu.train import update_ema as j_update
    from multimodal_learning_tpu_torch.train import update_ema
    model, ema = torch.nn.Linear(5, 3), torch.nn.Linear(5, 3)
    ema.register_buffer("stat", torch.ones(3))
    for step in (0, 3, 500):
        want = j_update([p.detach().numpy() for p in model.parameters()],
                        [p.detach().numpy().copy() for p in ema.parameters()],
                        0.99, step)
        update_ema(model, ema, 0.99, step)
        for got, w in zip(ema.parameters(), want):
            _close(got, w)
    assert torch.equal(ema.stat, torch.ones(3))   # buffers never averaged


@pytest.mark.parametrize("policy",
                         ["linear", "exp", "step", "cosine", "plateau"])
def test_lr_schedules_match_jax(policy):
    from multimodal_learning_tpu.config import Options as JOptions
    from multimodal_learning_tpu.train import make_lr_schedule as j_sched
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    kw = dict(lr_policy=policy, niter=3, niter_decay=5, lr_decay_iters=2)
    js, ps = j_sched(JOptions(**kw), 7), make_lr_schedule(Options(**kw), 7)
    for step in (0, 6, 7, 20, 41, 80):
        np.testing.assert_allclose(ps(step), float(js(step)), rtol=1e-6)


def test_adabound_adagrad_and_onecycle_take_a_step():
    """The optimizers and the schedule that were refused build and update:
    one step each from a seeded gradient moves the parameter to finite
    values, and onecycle ignores ``--lr``."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.train import (make_lr_schedule,
                                                     make_optimizer)
    for name, policy in (("adabound", "linear"), ("adagrad", "linear"),
                         ("adam", "onecycle")):
        opt = Options(optimizer_type=name, lr_policy=policy, lr=0.5)
        sched = make_lr_schedule(opt, 10)
        p = torch.nn.Parameter(torch.ones(3))
        before = p.detach().clone()
        tx = make_optimizer(opt, [p], sched)
        p.grad = torch.tensor([0.5, -1.0, 2.0])
        tx.step()
        assert tx.count == 1
        assert torch.isfinite(p).all() and not torch.equal(p, before), name
    assert make_lr_schedule(Options(lr_policy="onecycle", lr=0.5), 10)(0) \
        == pytest.approx(1e-3 / 25, rel=1e-5)   # optax rounds in fp32


def test_adam_with_schedule_matches_optax_chain():
    """Three updates with L2 decay and a linear schedule that changes LR
    between them: params and both moments against the JAX chain.  The
    gradients are far above eps, so no sign can flip between the two."""
    from multimodal_learning_tpu.config import Options as JOptions
    from multimodal_learning_tpu.train import make_lr_schedule as j_sched
    from multimodal_learning_tpu.train import make_optimizer as j_make
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.train import (make_lr_schedule,
                                                     make_optimizer)
    import optax
    kw = dict(lr=1e-2, weight_decay=4e-4, beta1=0.5, niter=0, niter_decay=2)
    rng = np.random.default_rng(8)
    p0 = rng.normal(size=(4, 3)).astype(np.float32)
    grads = [rng.normal(size=(4, 3)).astype(np.float32) for _ in range(3)]
    tx = j_make(JOptions(**kw), j_sched(JOptions(**kw), 1))
    jp = jnp.asarray(p0)
    js = tx.init(jp)
    p = torch.nn.Parameter(_t(p0.copy()))
    opt = make_optimizer(Options(**kw), [p],
                         make_lr_schedule(Options(**kw), 1))
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        opt.zero_grad()
        p.grad = _t(g.copy())
        opt.step()
        _close(p, jp)
    adam = next(s for s in js if hasattr(s, "mu"))
    _close(opt.optimizer.state[p]["exp_avg"], adam.mu)
    _close(opt.optimizer.state[p]["exp_avg_sq"], adam.nu)
    assert opt.count == int(adam.count) == 3


# ----------------------------------------------- the train path's own laws

def test_kron_encoder1_train_mask_law():
    """With ``pallas_train`` in training, the Kronecker vector is masked by
    Bernoulli(keep)/keep drawn from the module's generator (ones at rate
    0): with W = I the output is the mask times the vector."""
    from multimodal_learning_tpu_torch.models.fusion import _KronEncoder1
    for rate in (0.25, 0.0):
        enc = _KronEncoder1(10, 10, 100, rate, pallas_eval=True,
                            pallas_train=True).train()
        with torch.no_grad():
            enc.weight.copy_(torch.eye(100))
        ones = torch.ones(200, 10)
        enc.generator = torch.Generator().manual_seed(3)
        y = enc(ones, ones).detach()
        enc.generator = torch.Generator().manual_seed(3)
        assert torch.equal(y, enc(ones, ones).detach())   # from the generator
        if rate == 0.0:
            assert torch.equal(y, torch.ones_like(y))
            continue
        keep = 1.0 - rate
        assert set(torch.unique(y).tolist()) <= {0.0, float(
            torch.tensor(1.0 / keep))}
        assert abs(float((y == 0).float().mean()) - rate) < 0.015


def test_train_entry_points_refuse_what_is_not_ported():
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import (
        build_eval_step, build_teacher_train_step, init_teacher_state)
    opt = Options(path_dim=8, omic_dim=8, mmhid=8, feat_dim=8)
    if not torch.cuda.is_available():   # never a silent CPU fallback
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_teacher_state(opt, define_model(opt), make_lr_schedule(
                opt, 10), 16)
    # the masked step (ported) needs both modalities and a known BN mode
    with pytest.raises(ValueError, match="pathomic"):
        build_teacher_train_step(opt.replace(mode="path"), masking=True)
    with pytest.raises(ValueError, match="masking_bn"):
        build_teacher_train_step(opt.replace(masking_bn="keep"),
                                 masking=True)
    # the remaining fusion types are ported: each builds its steps, and an
    # unknown type still raises when its model is built
    for fusion_type in ("polynomial_fusion", "LMF", "HFB", "mmdynamics"):
        build_teacher_train_step(opt.replace(fusion_type=fusion_type))
        build_eval_step(opt.replace(fusion_type=fusion_type))
        define_model(opt.replace(fusion_type=fusion_type))
    with pytest.raises(NotImplementedError, match="not found"):
        define_model(opt.replace(fusion_type="nope"))
    # the loss-gated CRD is the single-positive weighted_CRDLoss, as in the
    # JAX package
    with pytest.raises(NotImplementedError, match="pos_mode exact/relax"):
        build_teacher_train_step(opt.replace(CRD_gate=True,
                                             pos_mode="multi_pos"))
    # --init_type re-initialises before the EMA copy is made
    state = init_teacher_state(opt.replace(init_type="xavier"),
                               define_model(opt), make_lr_schedule(opt, 10),
                               16, device="cpu")
    for k, v in state.ema_model.state_dict().items():
        assert torch.equal(v, state.model.state_dict()[k]), k
