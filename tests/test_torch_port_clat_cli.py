"""The MIA-2023 CLAT flow through the port's CLIs on the CPU: the masked
stage-1 teacher, the stage-2 student distilled from it, and the student's
eval.

One synthetic fold at 64^2 and widths 16, ``--paired_conv True``:
``cli.train_cv_MT_SP_Masking`` (2 epochs, ``--start_epoch 1``, so that the
second epoch runs the masked step on SLIC label maps) ->
``cli.train_cv_path_CLAT`` (the ``clat_stage2`` recipe's flags at a small
P and K, 1 epoch, so that the best checkpoint ``test_cv_path`` reads is the
final one) -> ``cli.test_cv_path``, which must reproduce the student's
final eval exactly (same device, weights and batches).  The JAX package's
``test_cv_path`` on the port's student checkpoint must agree with the
port's probabilities at the whole-model tolerance (rtol 2e-3 / atol
5e-4).  Also: the CLAT student's snapshot and resume, and the drivers'
refusals.
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
from multimodal_learning_tpu_torch.train import steps, student_clat
from multimodal_learning_tpu_torch.utils import save_checkpoint

COMMON = ("--synthetic_data --synthetic_folds 1 --mode pathomic --task grad "
          "--batch_size 8 --input_size_path 64 --path_dim 16 --omic_dim 16 "
          "--mmhid 16 --reg_type none --paired_conv True "
          "--pallas_fusion train").split()
TEACHER = COMMON + ("--niter_decay 2 --feat_dim 8 --CRD_distill 0 "
                    "--pred_distill 1 --masking 1 --start_epoch 1 "
                    "--num_superpixels 16 --Path_K 1 --Omic_K 5 "
                    "--model_name vt").split()
STUDENT = COMMON + ("--niter_decay 1 --feat_dim 8 --distill crd "
                    "--num_teachers 2 --assign_weights True "
                    "--loss_weighting GK_refine --use_grads_thresh True "
                    "--grads_thresh 0.25 --pos_mode exact "
                    "--pos_extra neighbors --nce_p 4 --nce_k 16 "
                    "--max_discrep 1 --start_reweight 1 -a 1 -b 0.02 "
                    "--model_name vs --fixed_model vt --patience 0.0").split()
TEST = COMMON + ["--model_name", "vs"]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads, as ``tests/test_torch_port_loop.py`` runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_clat_chain_through_the_clis(tmp_path, monkeypatch):
    from multimodal_learning_tpu.cli import test_cv_path as j_test_cv_path
    from multimodal_learning_tpu_torch.cli import (test_cv_path,
                                                   train_cv_MT_SP_Masking,
                                                   train_cv_path_CLAT)

    monkeypatch.setenv("MML_PLATFORM", "cpu")
    masked = []
    saliency = steps._saliency_masks

    def counted(opt, model, x_path, batch, sp_mask):
        masked.append(sp_mask.shape)
        return saliency(opt, model, x_path, batch, sp_mask)

    monkeypatch.setattr(steps, "_saliency_masks", counted)
    where = ["--checkpoints_dir", str(tmp_path)]
    teacher_res = train_cv_MT_SP_Masking.main(TEACHER + where)[1]
    assert np.isfinite(teacher_res["probs"]["fuse"]).all()
    # the masked step runs in epoch 2 only: 64 ROIs in batches of 8
    assert masked == [(8, 64, 64)] * 8
    final = train_cv_path_CLAT.main(STUDENT + where)[1]
    assert set(final["similarity_diagnostics"]) == {
        "teacher_intra", "teacher_inter", "student_intra", "student_inter",
        "similarity_diff"}
    ckpt_dir = os.path.join(str(tmp_path), "grad_15", "vs")
    ext = test_cv_path.main(TEST + where)
    dumped = load_pred_test(os.path.join(ckpt_dir, "vs_1_pred_test.pkl"))
    np.testing.assert_array_equal(dumped["probs"]["path"],
                                  final["probs"]["path"])
    np.testing.assert_array_equal(dumped["gt"], final["gt"])
    want = extended_grading_metrics(one_hot(final["gt"], 3),
                                    final["probs"]["path"])
    assert ext == [want] and final["ext_metrics"] == want

    # the JAX package evaluates the port's CLAT student to the same
    # probabilities
    j_test_cv_path.main(TEST + where)
    by_jax = load_pred_test(os.path.join(ckpt_dir, "vs_1_pred_test.pkl"))
    np.testing.assert_allclose(by_jax["probs"]["path"],
                               final["probs"]["path"], rtol=2e-3, atol=5e-4)


def _tiny(**kw):
    base = dict(mode="pathomic", task="grad", input_size_path=32,
                path_dim=8, omic_dim=8, mmhid=8, feat_dim=8, batch_size=4,
                niter_decay=1, distill="crd", num_teachers=2,
                assign_weights=True, loss_weighting="GK_refine",
                use_grads_thresh=True, pos_mode="exact", pos_extra="centers",
                nce_p=3, nce_k=4, fixed_model="t", model_name="s",
                reg_type="none", verbose=False, host_workers=1)
    base.update(kw)
    return Options(**base)


def test_clat_student_snapshot_and_resume(tmp_path):
    """A fold snapshot after epoch 1 (``centers`` positives, k-means noise
    from the state's generator); resuming trains epoch 2 only."""
    opt = _tiny(checkpoints_dir=str(tmp_path), exp_name="e",
                snapshot_every=1)
    teacher = define_model(opt, generator=torch.Generator().manual_seed(0))
    params, stats = flax_from_state_dict(teacher.state_dict())
    save_checkpoint(os.path.join(str(tmp_path), "e", "t", "t_1.pt"),
                    {"split": 1, "opt": opt, "epoch": 1,
                     "model_state_dict": params, "batch_stats": stats})
    data = make_synthetic_splits(n_train=12, n_test=4, roi_size=32, seed=0)
    res, best, ext = student_clat.train_clat_student(opt, data, 1,
                                                     device="cpu")
    assert np.isfinite(res["probs"]["path"]).all() and best["epoch"] == 1
    assert ext == res["ext_metrics"] and len(ext) == 9
    assert os.path.exists(os.path.join(str(tmp_path), "e", "s",
                                       "s_1_state.pt"))
    logs = []
    res, _, _ = student_clat.train_clat_student(
        opt.replace(niter_decay=2, resume=True), data, 1, device="cpu",
        log=logs.append)
    assert "[fold 1] resumed from epoch 1 (s_1_state.pt)" in logs
    assert res["n"] == 4 and np.isfinite(res["probs"]["path"]).all()


def test_clat_drivers_refuse_multihost_and_a_missing_card(tmp_path,
                                                          monkeypatch):
    from multimodal_learning_tpu_torch.cli import (train_cv_MT_SP_Masking,
                                                   train_cv_path_CLAT)
    monkeypatch.setenv("MML_PLATFORM", "cpu")
    monkeypatch.setenv("MML_MULTIHOST", "1")
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    where = ["--checkpoints_dir", str(tmp_path)]
    for main, flags in ((train_cv_MT_SP_Masking.main, TEACHER),
                        (train_cv_path_CLAT.main, STUDENT)):
        # multi-host training joins a torchrun job, and names what is
        # missing of its environment
        with pytest.raises(RuntimeError, match="MASTER_ADDR, MASTER_PORT"):
            main(flags + where)
    with pytest.raises(NotImplementedError, match="GK_refine"):
        student_clat.build_clat_student_step(
            _tiny(loss_weighting="momentum_AEKD"), None, torch.ones(3, 4))
    monkeypatch.delenv("MML_MULTIHOST")
    if torch.cuda.is_available():
        return
    monkeypatch.delenv("MML_PLATFORM")
    for main, flags in ((train_cv_MT_SP_Masking.main, TEACHER),
                        (train_cv_path_CLAT.main, STUDENT)):
        with pytest.raises(RuntimeError, match="MML_PLATFORM=cpu"):
            main(flags + where)
