"""The port's CV drivers end to end on the CPU, against the JAX package's.

``cli.train_cv_MT`` trains one synthetic fold of the tiny teacher recipe
(``.claude/skills/verify/SKILL.md``) with ``--paired_conv True`` and writes
``vt_1.pt`` in the JAX package's layout; ``cli.test_cv_MT`` must then
reproduce the training-time final eval exactly (same device, same weights,
same batches), and the JAX package's ``test_cv_MT.run_fold`` on that same
checkpoint must agree with the port's on the probabilities at the
whole-model tolerance (rtol 2e-3 / atol 5e-4) and on the accuracies.  Also:
the train-state snapshot round trip, resume, and the refusals of what is
not ported.
"""
import os

import numpy as np
import pytest
import torch

from multimodal_learning_tpu_torch.config import Options, parse_args
from multimodal_learning_tpu_torch.data.splits import make_synthetic_splits
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.train import loop, make_lr_schedule
from multimodal_learning_tpu_torch.train.steps import (
    build_teacher_train_step, init_teacher_state)
from multimodal_learning_tpu_torch.utils.checkpoint import (load_train_state,
                                                            save_train_state)

TRAIN = ("--synthetic_data --mode pathomic --task grad --niter_decay 2 "
         "--batch_size 8 --input_size_path 64 --path_dim 16 --omic_dim 16 "
         "--mmhid 16 --feat_dim 8 --pos_mode exact --nce_p 1 --nce_k 8 "
         "--CRD_distill 1 --pred_distill 1 --model_name vt --reg_type none "
         "--paired_conv True --synthetic_folds 1").split()
TEST = ("--synthetic_data --mode pathomic --task grad --batch_size 8 "
        "--input_size_path 64 --path_dim 16 --omic_dim 16 --mmhid 16 "
        "--model_name vt --reg_type none --paired_conv True "
        "--synthetic_folds 1").split()
BRANCHES = ("fuse", "path", "omic")
TORCHRUN_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                 "LOCAL_RANK")


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: with one test process per core the default
    (one thread per core in every process) oversubscribes the CPU, and
    this file's CPU training slows down several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_train_then_test_cv_reproduce_and_match_jax(tmp_path, monkeypatch):
    from multimodal_learning_tpu.cli import test_cv_MT as j_test_cv
    from multimodal_learning_tpu.config import parse_args as j_parse_args
    from multimodal_learning_tpu.data.splits import \
        make_synthetic_splits as j_make_splits
    from multimodal_learning_tpu_torch.cli import test_cv_MT, train_cv_MT

    monkeypatch.setenv("MML_PLATFORM", "cpu")
    where = ["--checkpoints_dir", str(tmp_path)]
    trained = train_cv_MT.main(TRAIN + where)[1]
    ckpt = os.path.join(str(tmp_path), "grad_15", "vt", "vt_1.pt")
    assert os.path.exists(ckpt)

    tested = test_cv_MT.main(TEST + where)
    for name in BRANCHES:
        assert tested[name] == [trained[f"metrics_{name}"]], name

    opt = parse_args(TEST + where, save=False)
    data = train_cv_MT.load_data(opt)
    res = test_cv_MT.run_fold(opt, data, 1, device="cpu")
    for name in BRANCHES:
        np.testing.assert_array_equal(res["probs"][name],
                                      trained["probs"][name])
        assert res[f"acc_{name}"] == trained[f"acc_{name}"]

    jopt = j_parse_args(TEST + where, save=False)
    jdata = j_make_splits(n_train=64, n_test=32, n_folds=1, roi_size=64,
                          seed=jopt.seed)
    want = j_test_cv.run_fold(jopt, jdata, 1)
    for name in BRANCHES:
        np.testing.assert_allclose(res["probs"][name], want["probs"][name],
                                   rtol=2e-3, atol=5e-4, err_msg=name)
        assert res[f"acc_{name}"] == want[f"acc_{name}"], name


def _tiny(**kw):
    base = dict(mode="pathomic", task="grad", input_size_path=32,
                path_dim=8, omic_dim=8, mmhid=8, feat_dim=8, batch_size=4,
                CRD_distill=1, pred_distill=1, nce_k=6, nce_p=1,
                pos_mode="exact", n_data=16, reg_type="none", niter=0,
                niter_decay=1, pallas_fusion="train", paired_conv=True,
                dropout_rate=0.0)
    base.update(kw)
    return Options(**base)


def _state(opt, seed):
    return init_teacher_state(
        opt, define_model(opt, generator=torch.Generator().manual_seed(seed)),
        make_lr_schedule(opt, 4), opt.n_data, seed=seed, device="cpu")


def _batch(opt, seed):
    rng = np.random.default_rng(seed)
    index = rng.permutation(opt.n_data)[:opt.batch_size]
    sample_idx = rng.integers(0, opt.n_data, (opt.batch_size, 1 + opt.nce_k))
    sample_idx[:, 0] = index
    s = opt.input_size_path
    return {k: torch.from_numpy(v) for k, v in {
        "omic": rng.normal(size=(opt.batch_size, 80)).astype(np.float32),
        "g": rng.integers(0, 3, opt.batch_size).astype(np.int32),
        "index": index.astype(np.int32),
        "sample_idx": sample_idx.astype(np.int32),
        "path_views": rng.integers(0, 256, (opt.batch_size, 2, s, s, 3),
                                   dtype=np.uint8)}.items()}


def test_train_state_snapshot_round_trips(tmp_path):
    """A snapshot restores every part of the state into a fresh one, and the
    next step of both is the same (at dropout 0: MaxNet's and the fusion's
    dropout draw from torch's global generator, which no snapshot holds)."""
    opt = _tiny()
    step = build_teacher_train_step(opt)
    a = _state(opt, 1)
    step(a, _batch(opt, 0), 0.1)
    a.optimizer.lr_scale = 0.2
    path = os.path.join(str(tmp_path), "s.pt")
    save_train_state(path, a, epoch=3, extra={"plateau": {"scale": 0.2}})
    b = _state(opt, 2)
    assert load_train_state(path, b) == (3, {"plateau": {"scale": 0.2}})
    assert (b.step, b.optimizer.count, b.optimizer.lr_scale) == (
        a.step, a.optimizer.count, a.optimizer.lr_scale)
    for m in ("model", "ema_model", "embeds"):
        sa, sb = getattr(a, m).state_dict(), getattr(b, m).state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (m, k)
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    batch = _batch(opt, 1)
    ma, mb = step(a, batch, 0.1)[1], step(b, batch, 0.1)[1]
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k in ("memory_v1", "memory_v2", "z_v1", "z_v2"):
        assert torch.equal(getattr(a.banks["fuse"], k),
                           getattr(b.banks["fuse"], k)), k


def test_resume_continues_after_the_snapshot(tmp_path):
    data = make_synthetic_splits(n_train=8, n_test=12, roi_size=32, seed=0)
    common = dict(checkpoints_dir=str(tmp_path), exp_name="e",
                  model_name="m", snapshot_every=1, verbose=False)
    loop.train_teacher(_tiny(**common), data, 1, device="cpu")
    assert os.path.exists(os.path.join(str(tmp_path), "e", "m",
                                       "m_1_state.pt"))
    logs = []
    res, _ = loop.train_teacher(_tiny(niter_decay=2, resume=True, **common),
                                data, 1, device="cpu", log=logs.append)
    assert "[fold 1] resumed from epoch 1 (m_1_state.pt)" in logs
    assert res["n"] == 12


@pytest.mark.parametrize("flags,match", [
    (dict(data_parallel=2, batch_size=3),
     "--batch_size 3 must be divisible by the data-parallel mesh size 2")])
def test_train_teacher_refuses_what_is_not_ported(flags, match):
    """``--data_parallel`` is ported (``tests/test_torch_port_data_parallel
    .py``); what stays refused is the JAX package's ``ValueError`` for a
    batch the ranks cannot split, raised before any rank starts."""
    data = make_synthetic_splits(n_train=8, n_test=4, roi_size=32, seed=0)
    with pytest.raises(ValueError, match=match):
        loop.train_teacher(_tiny(**flags), data, 1, device="cpu")


def test_train_teacher_accepts_init_type(tmp_path):
    """``--init_type xavier`` (the re-initialisation) trains a fold: it
    initialises, takes its steps and evaluates to finite probabilities."""
    data = make_synthetic_splits(n_train=8, n_test=12, roi_size=32, seed=0)
    res, _ = loop.train_teacher(_tiny(init_type="xavier",
                                      checkpoints_dir=str(tmp_path)),
                                data, 1, device="cpu")
    assert res["n"] == 12
    assert np.isfinite(res["probs"]["fuse"]).all()


@pytest.mark.parametrize("optimizer_type", ["adabound", "adagrad"])
def test_train_teacher_checkpoints_with_every_optimizer(tmp_path,
                                                        optimizer_type):
    """A fold trained with AdaBound or Adagrad reaches its final checkpoint,
    which carries the CRD heads (``crd_params``) whatever state the
    optimizer keeps."""
    from multimodal_learning_tpu_torch.utils.checkpoint import \
        load_checkpoint
    data = make_synthetic_splits(n_train=8, n_test=12, roi_size=32, seed=0)
    opt = _tiny(optimizer_type=optimizer_type, checkpoints_dir=str(tmp_path),
                exp_name="e", model_name="m")
    res, _ = loop.train_teacher(opt, data, 1, device="cpu")
    assert np.isfinite(res["probs"]["fuse"]).all()
    payload = load_checkpoint(os.path.join(str(tmp_path), "e", "m",
                                           "m_1.pt"))
    assert sorted(payload["crd_params"]) == ["crd_fuse_s", "crd_fuse_t"]


@pytest.mark.parametrize("optimizer_type", ["adam", "adabound", "adagrad"])
def test_state_tree_round_trips_each_optimizer(optimizer_type):
    """``jax_state_tree`` holds each optimizer's moments in optax's names
    (Adam's and AdaBound's ``mu``/``nu``, Adagrad's ``sum_of_squares``), and
    ``load_jax_state`` puts them back: the next step of both states is the
    same."""
    from multimodal_learning_tpu_torch.train.import_state import (
        jax_state_tree, load_jax_state)
    opt = _tiny(optimizer_type=optimizer_type)
    step = build_teacher_train_step(opt)
    a = _state(opt, 1)
    step(a, _batch(opt, 0), 0.1)
    tree = jax_state_tree(a)
    kind = "rss" if optimizer_type == "adagrad" else "adam"
    assert tree[kind]["count"] == 1
    b = load_jax_state(_state(opt, 2), tree)
    b.generator.set_state(a.generator.get_state())   # not in the JAX tree
    batch = _batch(opt, 1)
    ma, mb = step(a, batch, 0.1)[1], step(b, batch, 0.1)[1]
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k
    for k, v in a.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):   # not in the JAX tree
            assert torch.equal(v, b.model.state_dict()[k]), k


def test_drivers_refuse_multihost_and_pretrained_only(tmp_path, monkeypatch):
    """``MML_MULTIHOST=1`` without torchrun's environment raises naming
    the variables that are missing; ``test_cv_MT --pretrained_path``
    without a fold checkpoint evaluates the converted weights, with a
    ``{k}`` placeholder per fold, and dumps the same predictions as an
    evaluation of a model loaded with them."""
    from multimodal_learning_tpu_torch.cli import test_cv_MT, train_cv_MT
    from multimodal_learning_tpu_torch.eval import load_pred_test
    from multimodal_learning_tpu_torch.models import flax_from_state_dict
    from multimodal_learning_tpu_torch.models.import_torch import \
        save_pretrained_npz
    from multimodal_learning_tpu_torch.train.steps import build_eval_step
    monkeypatch.setenv("MML_PLATFORM", "cpu")
    monkeypatch.setenv("MML_MULTIHOST", "1")
    for var in TORCHRUN_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match=", ".join(TORCHRUN_VARS)):
        train_cv_MT.main(TRAIN + ["--checkpoints_dir", str(tmp_path)])
    opt = parse_args(TEST + ["--checkpoints_dir", str(tmp_path),
                             "--pretrained_path",
                             os.path.join(str(tmp_path), "ref_{k}.npz")],
                     save=False)
    released = define_model(opt, generator=torch.Generator().manual_seed(9))
    save_pretrained_npz(os.path.join(str(tmp_path), "ref_1.npz"),
                        *flax_from_state_dict(released.state_dict()))
    data = make_synthetic_splits(n_train=8, n_test=12, roi_size=64, seed=0)
    res = test_cv_MT.run_fold(opt, data, 1, device="cpu")
    dumped = load_pred_test(os.path.join(str(tmp_path), opt.exp_name, "vt",
                                         "vt_1_pred_test.pkl"))
    from multimodal_learning_tpu_torch.data.pipeline import (Loader,
                                                             PathomicDataset)
    loader = Loader(PathomicDataset(opt, data["cv_splits"][1], "test",
                                    train=False), opt.batch_size,
                    shuffle=False, drop_last=False, n_views=1)
    try:
        want = loop.evaluate(opt, build_eval_step(opt), released, loader,
                             "cpu", torch.Generator().manual_seed(opt.seed))
    finally:
        loader.close()
    for name in BRANCHES:
        np.testing.assert_array_equal(dumped["probs"][name],
                                      want["probs"][name])
        np.testing.assert_array_equal(res["probs"][name], want["probs"][name])


def test_drivers_without_cuda_refuse_to_fall_back(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal needs none")
    from multimodal_learning_tpu_torch.cli import test_cv_MT, train_cv_MT
    monkeypatch.delenv("MML_PLATFORM", raising=False)
    monkeypatch.delenv("MML_MULTIHOST", raising=False)
    for main in (train_cv_MT.main, test_cv_MT.main):
        with pytest.raises(RuntimeError, match="MML_PLATFORM=cpu"):
            main(TEST + ["--checkpoints_dir", str(tmp_path)])
