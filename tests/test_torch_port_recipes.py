"""The port's BASELINE recipes against the JAX package's, and the smoke
run's configurations built from them.

Every recipe's fields are equal in both packages (exact); ``get_recipe``
overrides and refuses unknown names the same way.  ``chip_smoke.py`` takes
its configurations from the port's recipes plus named cuts: each is held
here against the literal it replaced, so that the phases that use it
measure what they measured before.
"""
import dataclasses

import pytest

import chip_smoke
from multimodal_learning_tpu.recipes import BASELINE_RECIPES as J_RECIPES
from multimodal_learning_tpu.recipes import get_recipe as j_get_recipe
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.recipes import BASELINE_RECIPES, get_recipe


@pytest.mark.parametrize("name", sorted(J_RECIPES))
def test_recipe_fields_equal_jax(name):
    assert name in BASELINE_RECIPES
    assert isinstance(BASELINE_RECIPES[name], Options)
    assert (dataclasses.asdict(BASELINE_RECIPES[name])
            == dataclasses.asdict(J_RECIPES[name]))


def test_recipe_names_equal_jax():
    assert sorted(BASELINE_RECIPES) == sorted(J_RECIPES)


def test_get_recipe_overrides_and_unknown_name():
    opt = get_recipe("teacher", niter_decay=2, batch_size=4)
    assert (opt.niter_decay, opt.batch_size) == (2, 4)
    # the preset itself is left as it was
    assert BASELINE_RECIPES["teacher"].niter_decay == 30
    assert get_recipe("teacher") is BASELINE_RECIPES["teacher"]
    assert dataclasses.asdict(opt) == dataclasses.asdict(
        j_get_recipe("teacher", niter_decay=2, batch_size=4))
    assert opt.pallas_fusion == "train"     # B1 and B2 on the path
    with pytest.raises(KeyError, match="unknown recipe"):
        get_recipe("no_such_recipe")
    with pytest.raises(KeyError, match="unknown recipe"):
        j_get_recipe("no_such_recipe")


# The literals chip_smoke.py held before it took its configurations from
# the recipes.
PAPER_OLD = dict(mode="pathomic", task="grad", path_dim=128, omic_dim=128,
                 mmhid=128, feat_dim=128, input_size_path=512, batch_size=16,
                 compute_dtype="bfloat16", pallas_fusion="train",
                 niter_decay=30)
SERVE_OLD = dict(mode="pathomic", task="grad", fusion_type="pofusion",
                 model_name="smoke_teacher", exp_name="grad_15",
                 path_dim=128, omic_dim=128, mmhid=128, feat_dim=128,
                 input_size_omic=80, input_size_path=512, label_dim=3,
                 act_type="LSM", skip=0, batch_size=16,
                 compute_dtype="bfloat16", pallas_fusion="train",
                 cut_fuse_grad=True, pred_distill=1, CRD_distill=0,
                 beta1=0.9, niter_decay=30)
STUDENT_OLD = dict(PAPER_OLD, distill="crd", num_teachers=2,
                   assign_weights=True, CE_grads=True,
                   select_pos_mode="mid", pos_mode="multi_pos", nce_p=300,
                   nce_p2=20, nce_k=700, nce_k2=512, alpha=1.0, beta=0.02,
                   reg_type="none", beta1=0.9, n_data=256)
TSVD_OLD = dict(PAPER_OLD, CRD_distill=0, pred_distill=1, tSVD_loss=True,
                n_views=4, tSVD_mode="pathomic", Lambda_global=0.1,
                mu=1e-5, pho=1.1, max_mu=1.0, aux_iter=1, init_type="max",
                beta1=0.5, n_data=256)
DSCD_OLD = dict(distill="crd", num_teachers=2, assign_weights=True,
                CE_grads=True, select_pos_mode="hard",
                pos_mode="multi_pos", nce_p=300, nce_p2=20, nce_k=1024,
                nce_k2=1024, alpha=1.0, beta=0.02, reg_type="none",
                beta1=0.9, kd_T=1.0)
CLAT1_OLD = dict(PAPER_OLD, CRD_distill=0, pred_distill=1, masking=1,
                 num_superpixels=100, Path_K=1, Omic_K=5, start_epoch=1,
                 beta1=0.9, n_data=256)
CLAT2_FLAGS_OLD = dict(distill="crd", num_teachers=2, assign_weights=True,
                       CE_grads=True, loss_weighting="GK_refine",
                       use_grads_thresh=True, grads_thresh=0.25,
                       pos_mode="exact", pos_extra="neighbors", nce_p=6,
                       nce_k=4096, max_discrep=1.0, start_reweight=40,
                       alpha=1.0, beta=0.02, reg_type="none", beta1=0.9)
TEACHER_OLD = dict(PAPER_OLD, pred_distill=1, CRD_distill=0,
                   cut_fuse_grad=True, beta1=0.9, n_data=256)
CHAIN_OLD = dict(PAPER_OLD, paired_conv=True, synthetic_data=True,
                 synthetic_folds=1)
NAMES = {"model_name", "fixed_model"}

# (chip_smoke attribute, recipe, the smoke's cuts, the literal it replaced)
CONFIGS = [
    ("SERVE_CONFIG", "teacher", dict(model_name="smoke_teacher"), SERVE_OLD),
    ("STUDENT_CONFIG", "miccai_student", dict(n_data=256), STUDENT_OLD),
    ("TSVD_CONFIG", "tsvd_teacher", dict(n_data=256), TSVD_OLD),
    ("CLAT1_CONFIG", "clat_stage1", dict(n_data=256), CLAT1_OLD),
    ("CLAT2_CONFIG", "clat_stage2", dict(n_data=8192),
     dict(PAPER_OLD, **CLAT2_FLAGS_OLD, n_data=8192)),
    ("TEACHER_RECIPE", "teacher", dict(n_data=256), TEACHER_OLD),
]


def _differ(a, b):
    return {f.name for f in dataclasses.fields(a)
            if getattr(a, f.name) != getattr(b, f.name)}


@pytest.mark.parametrize("attr,recipe,cuts,old", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_chip_smoke_config_is_its_recipe(attr, recipe, cuts, old):
    """The dict is the recipe's fields plus the listed cuts; against the
    literal it replaced it differs at most in the recipe's model names,
    which the Options-built steps do not read (the CLI phases name their
    models themselves)."""
    new = getattr(chip_smoke, attr)
    assert Options(**new) == get_recipe(recipe, **cuts)
    assert _differ(Options(**new), Options(**old)) <= NAMES
    if attr == "SERVE_CONFIG":
        assert Options(**new) == Options(**old)


@pytest.mark.parametrize("attr,recipe,old,names", [
    ("DSCD_FLAGS", "dscd_student", DSCD_OLD,
     dict(fixed_model="smoke_m3lr", model_name="smoke_dscd")),
    ("CLAT2_FLAGS", "clat_stage2", CLAT2_FLAGS_OLD,
     dict(fixed_model="smoke_clat1", model_name="smoke_clat2")),
], ids=["DSCD_FLAGS", "CLAT2_FLAGS"])
def test_chip_smoke_chain_flags_are_their_recipe(attr, recipe, old, names):
    """The students' CLI flags of phases 17, 22 and 27, merged as the chains
    merge them: the same Options as the literals gave."""
    new = getattr(chip_smoke, attr)
    assert Options(**new) == get_recipe(recipe)
    got = Options(**{**chip_smoke.MIA_CHAIN, **new, "niter_decay": 1,
                     **names})
    assert got == Options(**{**CHAIN_OLD, **old, "niter_decay": 1, **names})


def test_chip_smoke_paper_dims_and_tsvd_chain():
    assert Options(**chip_smoke.PAPER) == Options(**PAPER_OLD)
    assert Options(**chip_smoke.MIA_CHAIN) == Options(**CHAIN_OLD)
    # phase 17's teacher: the t-SVD recipe on the chain's flags
    teacher = {**chip_smoke.TSVD_CONFIG, **chip_smoke.MIA_CHAIN,
               "niter_decay": 2, "model_name": "smoke_m3lr"}
    old = {**TSVD_OLD, **CHAIN_OLD, "niter_decay": 2,
           "model_name": "smoke_m3lr"}
    teacher.pop("n_data")
    old.pop("n_data")
    assert Options(**teacher) == Options(**old)
