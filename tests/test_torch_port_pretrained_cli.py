"""``test_cv_MT --pretrained_path 'f_{k}.npz'`` in the port against the JAX
package: the released-checkpoint path with no fold checkpoint on disk.

One full pathomic ``.npz`` (a seeded port model with perturbed BatchNorm
statistics, in the shared ``--pretrained_path`` format) is evaluated by
both packages' ``cli.test_cv_MT`` on the same synthetic fold, with
``--pallas_fusion train`` (the JAX package's Pallas kernel in interpret
mode, the port's plain version on the CPU).  Only a full file replaces
every randomly drawn leaf, so only it can be compared.  The prediction
pickles must agree: ground truth and patient names exactly, probabilities
at the whole-model tolerance of ``test_torch_import.py`` (rtol 2e-3 /
atol 5e-4).
"""
import os
import pickle

import numpy as np
import torch
from jax.experimental import pallas as pl

from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import (define_model,
                                                  flax_from_state_dict)
from multimodal_learning_tpu_torch.models.import_torch import \
    save_pretrained_npz

FLAGS = ("--synthetic_data --synthetic_folds 1 --mode pathomic --task grad "
         "--batch_size 8 --input_size_path 64 --path_dim 16 --omic_dim 16 "
         "--mmhid 16 --reg_type none --model_name released "
         "--pallas_fusion train").split()


def _released_npz(path):
    opt = Options(mode="pathomic", path_dim=16, omic_dim=16, mmhid=16,
                  input_size_path=64, pallas_fusion="train")
    model = define_model(opt, generator=torch.Generator().manual_seed(7))
    gen = torch.Generator().manual_seed(8)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    save_pretrained_npz(path, *flax_from_state_dict(model.state_dict()))


def test_released_checkpoint_eval_matches_jax(tmp_path, monkeypatch):
    from multimodal_learning_tpu.cli import test_cv_MT as j_test_cv
    from multimodal_learning_tpu_torch.cli import test_cv_MT

    monkeypatch.setenv("MML_PLATFORM", "cpu")
    monkeypatch.setenv("MML_PALLAS_FORCE", "1")
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import multimodal_learning_tpu.ops.kron_fusion as kf
    monkeypatch.setattr(kf.pl, "pallas_call", patched)

    _released_npz(str(tmp_path / "f_1.npz"))
    flags = FLAGS + ["--pretrained_path", str(tmp_path / "f_{k}.npz")]
    pickles = {}
    for name, main in (("port", test_cv_MT.main), ("jax", j_test_cv.main)):
        root = str(tmp_path / name)
        metrics = main(flags + ["--checkpoints_dir", root])
        assert len(metrics["fuse"]) == 1
        with open(os.path.join(root, "grad_15", "released",
                               "released_1_pred_test.pkl"), "rb") as fh:
            pickles[name] = pickle.load(fh)
        assert not os.path.exists(os.path.join(root, "grad_15", "released",
                                               "released_1.pt"))
    got, want = pickles["port"], pickles["jax"]
    np.testing.assert_array_equal(got["gt"], want["gt"])
    assert list(got["patnames"]) == list(want["patnames"])
    assert set(got["probs"]) == set(want["probs"])
    for branch in ("fuse", "path", "omic"):
        np.testing.assert_allclose(got["probs"][branch],
                                   want["probs"][branch], rtol=2e-3,
                                   atol=5e-4, err_msg=branch)
