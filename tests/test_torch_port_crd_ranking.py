"""``chip_smoke.py``'s shared CRD ranking (``_shared_crd_ranking``), on the
CPU.

Phases 16 and 38 compare two fp32 MICCAI student steps (card against CPU;
data parallel at world 1 against plain).  CRD's pair selection
(``contrast/crd.py:crd_scores_select``) sorts the cosines of each bank row
with its query, and a near tie may sort the other way under another order
of summation: the loss then jumps by a swapped pair while every continuous
part agrees.  The helper makes every run after the first rank by the
first run's cosines, and holds each run's own cosines to the first's.

Here the MICCAI student recipe at small widths (ResNet18 at 32^2, widths
16, batch 16, P = 300 -> P2 = 20, K = 700 -> K2 = 512, dropout 0, fp32)
takes its first step on a random teacher twice: without a data group and
at world 1 (gloo, a group of one joined in this process).  Under the
shared ranking the two agree at ``tests/test_torch_port_data_parallel.py``'s
tolerance, rtol 1e-4 / atol 1e-5; each step's own cosines lie within
rtol 2e-3 / atol 5e-4 of the other's, the smoke's tolerance.
"""
import contextlib

import pytest
import torch

import chip_smoke
from multimodal_learning_tpu_torch import parallel
from multimodal_learning_tpu_torch.contrast import crd
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.recipes import get_recipe
from multimodal_learning_tpu_torch.train import make_lr_schedule, student

SEED = 2019
SMALL = dict(path_dim=16, omic_dim=16, mmhid=16, feat_dim=16, s_dim=16,
             t_dim=16, input_size_path=32, compute_dtype="float32",
             dropout_rate=0.0, n_data=256)
TIGHT = dict(rtol=1e-4, atol=1e-5)


def _batch(opt, gen):
    b, n = opt.batch_size, opt.n_data
    index = torch.randperm(n, generator=gen)[:b]
    sample_idx = torch.randint(0, n, (b, opt.nce_p + opt.nce_k),
                               generator=gen)
    sample_idx[:, 0] = index
    return {"omic": torch.randn(b, opt.input_size_omic, generator=gen),
            "g": torch.randint(0, opt.label_dim, (b,), generator=gen),
            "index": index, "sample_idx": sample_idx,
            "path_views": torch.randint(
                0, 256, (b, 2, opt.input_size_path, opt.input_size_path, 3),
                dtype=torch.uint8, generator=gen)}


def _first_step(opt, teacher_sd, batch):
    teacher = define_model(opt, generator=torch.Generator())
    teacher.load_state_dict(teacher_sd)
    state = student.init_student_state(
        opt, define_model(opt, path_only=True,
                          generator=torch.Generator().manual_seed(SEED)),
        make_lr_schedule(opt, steps_per_epoch=50), opt.n_data, seed=SEED,
        device="cpu")
    step = student.build_student_train_step(
        opt, student.freeze_teacher(teacher, "cpu"))
    torch.manual_seed(SEED)
    return step(state, batch, 0.1)[1]


@pytest.mark.parametrize("teacher_seed", [6, 7])
def test_world1_student_step_matches_plain_on_shared_ranking(
        teacher_seed, tmp_path, capsys):
    opt = get_recipe("miccai_student", **SMALL)
    teacher_sd = define_model(
        opt, generator=torch.Generator().manual_seed(teacher_seed)
    ).state_dict()
    batch = _batch(opt, torch.Generator().manual_seed(1000 + teacher_seed))
    runs = []
    with parallel.process_group(0, 1, "cpu",
                                f"file://{tmp_path / 'group'}"):
        with chip_smoke._shared_crd_ranking("world 1 vs plain",
                                            "cpu") as next_run:
            for sharded in (False, True):
                next_run()
                with (contextlib.nullcontext() if sharded
                      else parallel.unsharded()):
                    runs.append(_first_step(opt, teacher_sd, batch))
    assert "4 CRD rankings by the first run's cosines" in capsys.readouterr(
    ).out
    plain, dp = runs
    assert plain.keys() == dp.keys()
    for k, want in plain.items():
        torch.testing.assert_close(dp[k].float(), want.float(), **TIGHT,
                                   msg=k)


def test_shared_ranking_holds_each_runs_own_cosines():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(2, 5, 3, generator=gen)
    v = torch.randn(2, 3, generator=gen)
    with pytest.raises(AssertionError, match="CRD cosines 0"):
        with chip_smoke._shared_crd_ranking("cosines", "cpu") as next_run:
            next_run()
            first = crd._cos_rel(w, v)
            next_run()
            # the second run ranks by the first's cosines, whatever its own
            assert torch.equal(crd._cos_rel(w, -v), first)
    assert crd._cos_rel.__name__ == "_cos_rel"   # restored


def test_shared_ranking_refuses_another_count_of_rankings():
    gen = torch.Generator().manual_seed(0)
    w = torch.randn(2, 5, 3, generator=gen)
    v = torch.randn(2, 3, generator=gen)
    with pytest.raises(AssertionError, match="more CRD rankings"):
        with chip_smoke._shared_crd_ranking("count", "cpu") as next_run:
            next_run()
            crd._cos_rel(w, v)
            next_run()
            crd._cos_rel(w, v)
            crd._cos_rel(w, v)
    with pytest.raises(AssertionError, match="1 CRD rankings against"):
        with chip_smoke._shared_crd_ranking("count", "cpu") as next_run:
            next_run()
            crd._cos_rel(w, v)
            crd._cos_rel(w, v)
            next_run()
            crd._cos_rel(w, v)
