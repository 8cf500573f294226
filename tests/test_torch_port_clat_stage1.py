"""The masked CLAT stage-1 teacher of the port against the JAX package's:
SLIC, the masked augmentation, the loader's label maps and two masked
train steps.

SLIC: both packages build ``native/slic/slic.cpp`` with the same flags, so
the labels must be equal exactly; the numpy versions likewise.

``augment_views_with_mask``: the test repeats the JAX function's key splits
to recover its flips and jitter factors and hands them to the port's apply
function; the views at an absolute 2e-6 (fp32: values x*2-1 of [0, 1]
whose contrast mean sums 1024 pixels, as ``test_torch_port_train_parts``
holds ``augment_view``), the label map exactly.

Masked steps: two steps of each package from the same JAX
``init_teacher_state`` (``train.import_state.load_jax_state``), in both
``--masking_bn`` modes.  Both get the same four views and label map
(``augment_views_with_mask`` is the identity in both packages, and the
batch carries the views), dropout 0 and ``pallas_fusion="train"``: the
port takes its kernels' plain versions, and the JAX step its Kronecker
einsum, as the JAX package's own masked-step tests run it on the CPU.  The
JAX masked step cannot run through its Pallas kernels at all: its loss
differentiates the saliency pass's own ``jax.grad``, and JAX cannot
linearise a ``pallas_call`` (ROADMAP C).  ResNet18
at 64^2, widths 16, batch 4, SLIC maps of 16 segments, Path_K 2, Omic_K 5,
fp32.  Before the second step the port takes the JAX parameters, Adam
moments and EMA parameters again, not its BatchNorm statistics
(``tests/test_torch_port_student.py`` says why).  The saliency masks of
each step, recorded inside the port's step, equal the JAX function's on
the step's inputs exactly; the accuracy counts exactly and the loss parts
at rtol 2e-4 / atol 1e-6 (``LOSSES``); both models' BatchNorm statistics
at rtol 1e-5 / atol
1e-5 (a running mean of about 0.05 after the trunk and the fusion
differs by up to 3.1e-6 between the frameworks' fp32 convolution sums,
measured on this test's inputs); Adam's first
moment of the heads elementwise and of the ResNet trunk by norm, as the
student test holds them.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import multimodal_learning_tpu.data.augment as ja
import multimodal_learning_tpu.masking.slic as jslic
import multimodal_learning_tpu.train.steps as jsteps
import multimodal_learning_tpu_torch.masking.slic as pslic
import multimodal_learning_tpu_torch.train.steps as psteps
from multimodal_learning_tpu.config import Options as JOptions
from multimodal_learning_tpu.data.pipeline import (Loader as JLoader,
                                                   PathomicDataset as JDataset)
from multimodal_learning_tpu.losses.task import nll_loss as j_nll
from multimodal_learning_tpu.masking.superpixel import \
    superpixel_attention_mask as j_mask
from multimodal_learning_tpu.models.factory import define_model as j_define
from multimodal_learning_tpu.train import (make_lr_schedule as j_sched,
                                           make_optimizer as j_optim)
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.data import augment as pa
from multimodal_learning_tpu_torch.data.pipeline import Loader, PathomicDataset
from multimodal_learning_tpu_torch.data.splits import make_synthetic_splits
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.import_state import (jax_state_tree,
                                                              load_jax_state)

# the step's loss parts: the pred-KD terms are small differences of two
# models' near-equal predictions; measured up to 7.6e-5 relative in the
# second step (the total loss within 4e-6)
LOSSES = dict(rtol=2e-4, atol=1e-6)


def _t(a):
    return torch.from_numpy(np.array(a))


def _image(seed, h=48, w=64):
    """A smooth uint8 RGB image with edges, so SLIC has structure to
    follow."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w] / 8.0
    img = np.stack([np.sin(xx + c) * np.cos(yy * (c + 1)) for c in range(3)],
                   -1) * 100 + 128 + rng.normal(0, 8, (h, w, 3))
    img[h // 3:, : w // 2] += 60
    return np.clip(img, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------- SLIC

@pytest.fixture
def jax_slic_private(tmp_path, monkeypatch):
    """The JAX module builds its library in place, not atomically, and
    another test file may build it at the same time in another worker: let
    it build a private copy instead (same source, same flags)."""
    monkeypatch.setattr(jslic, "_LIB_PATH", str(tmp_path / "libslic.so"))
    monkeypatch.setattr(jslic, "_lib", None)
    monkeypatch.setattr(jslic, "_build_failed", False)


@pytest.mark.parametrize("impl", ["native", "numpy"])
def test_slic_matches_jax(impl, jax_slic_private):
    for seed, n in ((0, 16), (1, 24)):
        img = _image(seed)
        if impl == "native":
            got = pslic.slic_segment(img, n, 10.0)
            want = jslic.slic_segment(img, n, 10.0)
            assert jslic._load_lib() is not None
        else:
            got = pslic._slic_numpy(img, n, 10.0, 10)
            want = jslic._slic_numpy(img, n, 10.0, 10)
        assert got.dtype == np.int32 and got.shape == img.shape[:2]
        assert 0 <= got.min() and got.max() < n
        assert len(np.unique(got)) > n // 2
        np.testing.assert_array_equal(got, want)
    assert os.path.dirname(pslic.library_path()).endswith(
        os.path.join("build", "native"))


def test_slic_build_failure_raises_with_the_compiler_output(tmp_path,
                                                            monkeypatch):
    """No quiet fall-back to the numpy version, whose labels differ."""
    bad = tmp_path / "slic.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(pslic, "_SRC", str(bad))
    monkeypatch.setattr(pslic, "_REPO", str(tmp_path))
    monkeypatch.setattr(pslic, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        pslic.slic_segment(_image(0), 16)


# ------------------------------------------------------------- augmentation

def _jax_view_draws(key, b):
    """The flips and jitter factors ``augment_view(key, ...)`` draws."""
    kf, kj = jax.random.split(key)
    return _jax_flips(kf, b), _jax_jitter(kj, b)


def _jax_flips(kf, b):
    kh, kv = jax.random.split(kf)
    return pa.Flips(_t(jax.random.bernoulli(kh, 0.5, (b,))),
                    _t(jax.random.bernoulli(kv, 0.5, (b,))))


def _jax_jitter(kj, b):
    kb, kc, ks, khue = jax.random.split(kj, 4)
    u = lambda k, lo, hi: _t(np.asarray(jax.random.uniform(
        k, (b, 1, 1, 1), minval=lo, maxval=hi)).reshape(b))
    return pa.Jitter(u(kb, 0.9, 1.1), u(kc, 0.9, 1.1), u(ks, 0.95, 1.05),
                     _t(jax.random.uniform(khue, (b,), minval=-0.01,
                                           maxval=0.01)))


def _jax_mask_draws(key, b, v):
    """The draws of ``augment_views_with_mask(key, ...)``, per view."""
    keys = jax.random.split(key, v + 1)
    kf, kj = jax.random.split(keys[0])
    return ([(_jax_flips(kf, b), _jax_jitter(kj, b))]
            + [_jax_view_draws(keys[i], b) for i in range(1, v)])


def test_augment_views_with_mask_matches_jax():
    rng = np.random.default_rng(0)
    b, v, s = 6, 4, 32
    views = rng.integers(0, 256, (b, v, s, s, 3), dtype=np.uint8)
    sp = rng.integers(0, 50, (b, s, s), dtype=np.int32)
    key = jax.random.PRNGKey(5)
    want_x, want_m = ja.augment_views_with_mask(key, jnp.asarray(views),
                                                jnp.asarray(sp))
    draws = _jax_mask_draws(key, b, v)
    f0 = draws[0][0]
    assert f0.horizontal.any() and not f0.vertical.all()
    got_x, got_m = pa.augment_views_with_mask_apply(_t(views), _t(sp), draws)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=2e-6)
    # drawn from a generator: shapes, dtypes, and view 0's flips on the map
    gen = torch.Generator().manual_seed(1)
    x, m = pa.augment_views_with_mask(gen, _t(views), _t(sp),
                                      dtype=torch.bfloat16)
    assert x.shape == views.shape and x.dtype == torch.bfloat16
    assert m.dtype == torch.int32 and m.shape == sp.shape
    assert not torch.equal(m, _t(sp))


# ------------------------------------------------------------------- loader

def test_loader_label_maps_match_jax(jax_slic_private):
    """Four views and ``sp_mask`` aligned to view 0, byte for byte as the
    JAX loader makes them from the same seed."""
    data = make_synthetic_splits(n_train=8, n_test=4, roi_size=48, seed=3)
    cfg = dict(mode="pathomic", task="grad", input_size_path=32,
               batch_size=4, label_dim=3, CRD_distill=0)
    opt, jopt = Options(**cfg), JOptions(**cfg)
    split = data["cv_splits"][1]
    ds = PathomicDataset(opt, split, "train", train=True, superpixels=12)
    jds = JDataset(jopt, split, "train", train=True, superpixels=12)
    loader = Loader(ds, 4, shuffle=True, drop_last=True, n_views=4, seed=7)
    jloader = JLoader(jds, 4, shuffle=True, drop_last=True, n_views=4,
                      seed=7)
    try:
        for got, want in zip(loader, jloader):
            assert got["sp_mask"].dtype == np.int32
            assert got["sp_mask"].shape == (4, 32, 32)
            assert got["path_views"].shape == (4, 4, 32, 32, 3)
            for k in ("path_views", "sp_mask", "index"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        loader.close()
    # the label crop is view 0's: the map of the same crop window
    img, sp = ds.image(0), ds.slic(0)
    views, mask = ds.crops(0, 2, np.random.default_rng(4), with_mask=True)
    top, left = next((t, l) for t in range(17) for l in range(17)
                     if np.array_equal(img[t:t + 32, l:l + 32], views[0]))
    np.testing.assert_array_equal(mask, sp[top:top + 32, left:left + 32])


def test_padded_roi_label_map_stays_aligned():
    """A ROI smaller than the crop is padded on both sides (RandomCrop);
    the label map is padded the same way, so it stays on view 0's
    pixels."""
    data = make_synthetic_splits(n_train=4, n_test=4, roi_size=20, seed=4)
    opt = Options(mode="pathomic", task="grad", input_size_path=32,
                  label_dim=3)
    ds = PathomicDataset(opt, data["cv_splits"][1], "train", train=True,
                         superpixels=6)
    views, mask = ds.crops(1, 1, np.random.default_rng(0), with_mask=True)
    img, sp = ds.image(1), ds.slic(1)
    assert img.shape[:2] == (20, 20) and mask.shape == (32, 32)
    np.testing.assert_array_equal(views[0][6:26, 6:26], img)
    np.testing.assert_array_equal(mask[6:26, 6:26], sp)


# -------------------------------------------------------------- masked steps

SIZE, B, N_DATA, N_SP = 64, 4, 16, 16
DIMS = dict(mode="pathomic", task="grad", input_size_path=SIZE, path_dim=16,
            omic_dim=16, mmhid=16, feat_dim=16, label_dim=3, batch_size=B,
            n_data=N_DATA, pallas_fusion="train", dropout_rate=0.0,
            niter_decay=30, CRD_distill=0, pred_distill=1, masking=1,
            num_superpixels=N_SP, Path_K=2, Omic_K=5, beta1=0.9)


@pytest.fixture
def no_onednn_convs():
    """The port's side without oneDNN, whose fp32 convolution backward on
    the CPU loses digits (``tests/test_torch_port_step.py``)."""
    with torch.backends.mkldnn.flags(enabled=False):
        yield


def _masked_batch(seed):
    """Four float32 views (``augment_views_with_mask`` is the identity in
    both packages) and SLIC label maps of view 0."""
    rng = np.random.default_rng(seed)
    u8 = np.stack([np.stack([_image(seed * 10 + b * 4 + v, SIZE, SIZE)
                             for v in range(4)]) for b in range(B)])
    sp = np.stack([pslic.slic_segment(u8[b, 0], N_SP) for b in range(B)])
    return {"omic": rng.normal(size=(B, 80)).astype(np.float32),
            "g": rng.integers(0, 3, B).astype(np.int32),
            "t": rng.exponential(20, B).astype(np.float32),
            "e": np.ones(B, np.float32),
            "index": rng.choice(N_DATA, B, replace=False).astype(np.int32),
            "path_views": (u8.astype(np.float32) / 127.5 - 1.0),
            "sp_mask": sp.astype(np.int32)}


def _jax_tree(state):
    cp = lambda t: jax.tree_util.tree_map(lambda x: np.array(x), t)
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    return {"step": int(state.step), "params": cp(state.params),
            "batch_stats": cp(state.batch_stats),
            "ema_params": cp(state.ema_params),
            "ema_batch_stats": cp(state.ema_batch_stats),
            "adam": {"count": int(adam.count), "mu": cp(adam.mu),
                     "nu": cp(adam.nu)}, "banks": {}}


def _assert_trees_close(got, want, what, **tol):
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), **tol,
            err_msg=f"{what}{jax.tree_util.keystr(path)}")


# Biases that feed a train-mode BatchNorm: their exact gradient is 0, so
# both packages' moments are rounding noise (tests/test_torch_port_step.py)
BIAS_BEFORE_BN = ("['fusion']['encoder1']['bias']",
                  "['fusion']['encoder2']['bias']",
                  "['path_net']['fc_new1']['bias']")


def _assert_moments_close(got, want, what):
    """Adam's first moment: the heads (everything but the ResNet trunk)
    per tensor at rtol 2e-3 and an atol of 2e-3 of its largest element;
    the trunk by the norm of the difference at 1e-1 of the JAX tensor's
    (ReLU kinks at 64^2, ``tests/test_torch_port_student.py``)."""
    fg = jax.tree_util.tree_flatten_with_path(got)[0]
    fw = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in fg] == [p for p, _ in fw], what
    for (path, a), (_, b) in zip(fg, fw):
        key, a, b = jax.tree_util.keystr(path), np.asarray(a), np.asarray(b)
        if "['path_net']" in key and "fc_new" not in key:
            rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
            assert rel <= 1e-1, f"{what}{key}: |diff| / |jax| = {rel:.3e}"
            continue
        atol = (5e-6 if key.endswith(BIAS_BEFORE_BN)
                else max(1e-6, 2e-3 * float(np.abs(b).max(initial=0.0))))
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=atol,
                                   err_msg=f"{what}{key}")


def _jax_saliency(jmodel, jstate, jbatch, opt):
    """The JAX step's masks (``train/steps.py:396-404``) on its inputs."""
    def cost_fn(xp, xo):
        o = jmodel.apply({"params": jstate.params["model"],
                          "batch_stats": jstate.batch_stats},
                         x_path=xp, x_omic=xo, train=False)
        return j_nll(o.pred_fuse, jbatch["g"])

    pm, om = jax.jit(lambda xp, xo, sp: j_mask(
        cost_fn, xp, xo, sp, opt.num_superpixels, opt.Path_K, opt.Omic_K))(
        jbatch["path_views"][:, 0], jbatch["omic"], jbatch["sp_mask"])
    return np.asarray(pm), np.asarray(om)


@pytest.mark.parametrize("masking_bn", ["chain", "discard"])
def test_masked_steps_match_jax(masking_bn, no_onednn_convs, monkeypatch):
    cfg = dict(DIMS, masking_bn=masking_bn)
    jopt, opt = JOptions(**cfg), Options(**cfg)
    monkeypatch.delenv("MML_PALLAS_FORCE", raising=False)
    monkeypatch.setattr(ja, "augment_views_with_mask",
                        lambda key, v, m, jitter=True, dtype=None: (v, m))
    monkeypatch.setattr(psteps, "augment_views_with_mask",
                        lambda gen, v, m, jitter=True, dtype=None: (v, m))
    recorded = []
    port_mask = psteps.superpixel_attention_mask

    def record(*args):
        out = port_mask(*args)
        recorded.append([m.numpy() for m in out])
        return out

    monkeypatch.setattr(psteps, "superpixel_attention_mask", record)

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
    jstep = jsteps.build_teacher_train_step(jopt, jmodel, tx, masking=True)
    pstep = psteps.build_teacher_train_step(opt, masking=True)

    for i in (1, 2):
        if i == 2:   # the JAX parameters, moments and EMA parameters again
            own, tree = jax_state_tree(state), _jax_tree(jstate)
            for k in ("batch_stats", "ema_batch_stats"):
                tree[k] = own[k]
            load_jax_state(state, tree)
        batch = _masked_batch(seed=i)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        want_masks = _jax_saliency(jmodel, jstate, jbatch, jopt)
        jstate, jm = jstep(jstate, jbatch, jax.random.PRNGKey(10 + i),
                           jnp.asarray(0.1))
        state, m = pstep(state, {k: _t(v) for k, v in batch.items()}, 0.1)
        got_masks = recorded[-1]
        for g, w in zip(got_masks, want_masks):
            np.testing.assert_array_equal(g, w)
        assert (got_masks[0].reshape(B, -1).sum(1) > 0).all()
        assert set(m) == set(jm) and "loss_masking" in m
        for k in jm:
            np.testing.assert_allclose(m[k].numpy(), jm[k], **LOSSES,
                                       err_msg=f"step {i} {k}")
        assert float(m["loss_masking"]) > 0
        got, want = jax_state_tree(state), _jax_tree(jstate)
        assert got["step"] == want["step"] == i
        for k in ("batch_stats", "ema_batch_stats"):
            _assert_trees_close(got[k], want[k], f"step {i} {k}",
                                rtol=1e-5, atol=1e-5)
        _assert_moments_close(got["adam"]["mu"]["model"],
                              want["adam"]["mu"]["model"],
                              f"step {i} exp_avg")
