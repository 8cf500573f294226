"""The MIA-2022 flow through the port's CLIs on the CPU: a teacher fold
(plain, or the t-SVD teacher with ``--tSVD_loss True``), the student
distilled from it (CRD v3 with GK_refine; on the plain teacher also HKD,
``--distill hkd``, and CRD with the one-class-SVM weighting,
``--loss_weighting SVM``), and the student's eval.

One synthetic fold at 64^2 and widths 16, ``--paired_conv True``:
``cli.train_cv_MT`` (2 epochs) -> ``cli.train_cv_path_multi_MT`` (the
``dscd_student`` recipe's flags at a small P and K, 1 epoch, so that the
best checkpoint ``test_cv_path`` reads is the final one) ->
``cli.test_cv_path``, which must reproduce the student's final eval
exactly (same device, weights and batches).  The JAX package's
``load_checkpoint`` must read the port's student checkpoint into the tree
of the JAX path-only ResNet, and the JAX ``test_cv_path`` on it must agree
with the port's probabilities at the whole-model tolerance (rtol 2e-3 /
atol 5e-4).  Also: the student's snapshot, resume and plateau LR, and the
drivers' refusals.
"""
import os

import numpy as np
import pytest
import torch

from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.data.splits import make_synthetic_splits
from multimodal_learning_tpu_torch.eval import load_pred_test
from multimodal_learning_tpu_torch.eval.metrics import (
    extended_grading_metrics, one_hot)
from multimodal_learning_tpu_torch.models import (define_model,
                                                  flax_from_state_dict)
from multimodal_learning_tpu_torch.train import student
from multimodal_learning_tpu_torch.utils import save_checkpoint

COMMON = ("--synthetic_data --synthetic_folds 1 --mode pathomic --task grad "
          "--batch_size 8 --input_size_path 64 --path_dim 16 --omic_dim 16 "
          "--mmhid 16 --reg_type none --paired_conv True "
          "--pallas_fusion train").split()
TEACHER = COMMON + ("--niter_decay 2 --feat_dim 8 --CRD_distill 0 "
                    "--pred_distill 1 --model_name vt").split()
TSVD = ("--tSVD_loss True --n_views 4 --tSVD_mode pathomic "
        "--Lambda_global 0.1 --mu 0.5").split()
STUDENT = COMMON + ("--niter_decay 1 --feat_dim 8 --distill crd "
                    "--num_teachers 2 --assign_weights True --CE_grads True "
                    "--select_pos_mode hard --pos_mode multi_pos --nce_p 6 "
                    "--nce_p2 3 --nce_k 10 --nce_k2 6 -a 1 -b 0.02 "
                    "--model_name vs --fixed_model vt --patience 0.0").split()
TEST = COMMON + ["--model_name", "vs"]
# case: (teacher flags, student flags beyond STUDENT)
CHAINS = {"plain": ([], []), "tsvd": (TSVD, []),
          "hkd": ([], ["--distill", "hkd"]),
          "svm": ([], ["--loss_weighting", "SVM", "--svm_norm", "True"])}


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads, as ``tests/test_torch_port_loop.py`` runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_mia_chain_through_the_clis(case, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from multimodal_learning_tpu.cli import test_cv_path as j_test_cv_path
    from multimodal_learning_tpu.config import parse_args as j_parse_args
    from multimodal_learning_tpu.models.factory import define_model as j_def
    from multimodal_learning_tpu.utils.checkpoint import \
        load_checkpoint as j_load
    from multimodal_learning_tpu_torch.cli import (test_cv_path,
                                                   train_cv_MT,
                                                   train_cv_path_multi_MT)

    monkeypatch.setenv("MML_PLATFORM", "cpu")
    where = ["--checkpoints_dir", str(tmp_path)]
    teacher_flags, student_flags = CHAINS[case]
    teacher_res = train_cv_MT.main(TEACHER + teacher_flags + where)[1]
    assert np.isfinite(teacher_res["probs"]["fuse"]).all()
    final = train_cv_path_multi_MT.main(STUDENT + student_flags + where)[1]
    ckpt_dir = os.path.join(str(tmp_path), "grad_15", "vs")
    ext = test_cv_path.main(TEST + where)
    dumped = load_pred_test(os.path.join(ckpt_dir, "vs_1_pred_test.pkl"))
    np.testing.assert_array_equal(dumped["probs"]["path"],
                                  final["probs"]["path"])
    np.testing.assert_array_equal(dumped["gt"], final["gt"])
    assert ext == [extended_grading_metrics(
        one_hot(final["gt"], 3), final["probs"]["path"])]
    assert list(final["metrics_path"]) == [
        ext[0][k] for k in ("rocauc", "ap", "f1_micro", "f1_gradeIV")]

    # the JAX package reads the student's checkpoint into its path-only
    # ResNet's tree, and evaluates it to the port's probabilities
    jopt = j_parse_args(TEST + where, save=False)
    ckpt = j_load(os.path.join(ckpt_dir, "vs_1_best.pt"))
    assert (ckpt["opt"]["distill"], ckpt["opt"]["loss_weighting"]) == {
        "hkd": ("hkd", "GK_refine"), "svm": ("crd", "SVM")}.get(
        case, ("crd", "GK_refine"))
    variables = j_def(jopt, path_only=True).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 3)), train=True)
    for key in ("params", "batch_stats"):
        src = ckpt["model_state_dict" if key == "params" else "batch_stats"]
        want = jax.tree_util.tree_map(np.shape, variables[key])
        assert jax.tree_util.tree_map(np.shape, src) == want, key
    j_test_cv_path.main(TEST + where)
    by_jax = load_pred_test(os.path.join(ckpt_dir, "vs_1_pred_test.pkl"))
    np.testing.assert_allclose(by_jax["probs"]["path"],
                               final["probs"]["path"], rtol=2e-3, atol=5e-4)


def _tiny(**kw):
    base = dict(mode="pathomic", task="grad", input_size_path=32,
                path_dim=8, omic_dim=8, mmhid=8, feat_dim=8, batch_size=4,
                niter_decay=1, distill="crd", num_teachers=2,
                assign_weights=True, CE_grads=True,
                loss_weighting="momentum_AEKD", select_pos_mode="hard",
                pos_mode="multi_pos", nce_p=3, nce_p2=2, nce_k=4, nce_k2=3,
                fixed_model="t", model_name="s", reg_type="none",
                lr_policy="plateau", verbose=False, host_workers=1)
    base.update(kw)
    return Options(**base)


def test_student_snapshot_resume_and_plateau(tmp_path):
    """A fold snapshot after epoch 1 holds the momentum-AEKD scale and the
    frozen teacher's generator; resuming trains epoch 2 only."""
    opt = _tiny(checkpoints_dir=str(tmp_path), exp_name="e",
                snapshot_every=1)
    teacher = define_model(opt, generator=torch.Generator().manual_seed(0))
    params, stats = flax_from_state_dict(teacher.state_dict())
    save_checkpoint(os.path.join(str(tmp_path), "e", "t", "t_1.pt"),
                    {"split": 1, "opt": opt, "epoch": 1,
                     "model_state_dict": params, "batch_stats": stats})
    data = make_synthetic_splits(n_train=12, n_test=4, roi_size=32, seed=0)
    student.train_student(opt, data, 1, device="cpu")
    snap = os.path.join(str(tmp_path), "e", "s", "s_1_state.pt")
    payload = torch.load(snap, weights_only=True)
    assert payload["epoch"] == 1 and "teacher_generator" in payload
    scale = payload["banks"]["aekd_ema"]
    assert scale.shape == (5,) and torch.isfinite(scale).all()
    assert payload["extra"]["plateau"] is not None
    logs = []
    res, _, _ = student.train_student(
        opt.replace(niter_decay=2, resume=True), data, 1, device="cpu",
        log=logs.append)
    assert "[fold 1] resumed from epoch 1 (s_1_state.pt)" in logs
    assert res["n"] == 4 and np.isfinite(res["probs"]["path"]).all()


def test_student_drivers_refuse_multihost_and_a_missing_card(tmp_path,
                                                             monkeypatch):
    from multimodal_learning_tpu_torch.cli import (test_cv_path,
                                                   train_cv_path_multi_MT)
    monkeypatch.setenv("MML_PLATFORM", "cpu")
    monkeypatch.setenv("MML_MULTIHOST", "1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    # multi-host training joins a torchrun job, and names what is missing
    # of its environment
    with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT"):
        train_cv_path_multi_MT.main(STUDENT + ["--checkpoints_dir",
                                               str(tmp_path)])
    monkeypatch.delenv("MML_MULTIHOST")
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("MML_PLATFORM")
    for main in (train_cv_path_multi_MT.main, test_cv_path.main):
        with pytest.raises(RuntimeError, match="MML_PLATFORM=cpu"):
            main(TEST + ["--checkpoints_dir", str(tmp_path)])
