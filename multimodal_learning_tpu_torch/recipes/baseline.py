"""The five BASELINE configs as ready-made Options presets.

The port's own copy of ``multimodal_learning_tpu/recipes/baseline.py``: the
same eight recipes with the same fields, on the port's ``Options``.
Sources: BASELINE.json ``configs`` + the reference shell recipes
(``MICCAI-2022/README.md:26-33``, ``MIA 2022/train.sh``,
``MIA 2023/stage1.../training_script_Masking.sh``,
``MIA 2023/stage2.../train_20230805.sh``).
"""
from __future__ import annotations

from ..config import Options

_PAPER_DIMS = dict(path_dim=128, omic_dim=128, mmhid=128, feat_dim=128,
                   s_dim=128, t_dim=128, input_size_omic=80,
                   input_size_path=512, label_dim=3, task="grad",
                   batch_size=16, compute_dtype="bfloat16",
                   # the fused Kronecker contraction, train + eval: the
                   # CUDA kernels of ops/kron_fusion.py (B1 in each
                   # train-mode forward, B2 in each eval forward)
                   pallas_fusion="train")


BASELINE_RECIPES = {
    # 1. Unimodal pathology student eval (test_cv_path)
    "path_eval": Options(mode="pathomic", model_name="path_student",
                         **_PAPER_DIMS),
    # 2. Unimodal omic SNN grading (train_cv_MT omic branch)
    "omic": Options(mode="omic", model_name="omic_snn", omic_dim=32,
                    dropout_rate=0.25, reg_type="omic", niter_decay=30,
                    CRD_distill=0, pred_distill=0,
                    **{k: v for k, v in _PAPER_DIMS.items()
                       if k not in ("omic_dim",)}),
    # 3. Multimodal Kronecker-fusion teacher (MICCAI-2022 recipe:
    #    --pred_distill 1 --CRD_distill 0 --cut_fuse_grad --beta1 0.9)
    "teacher": Options(mode="pathomic", model_name="stage1_pathomic_teacher",
                       fusion_type="pofusion", pred_distill=1, CRD_distill=0,
                       cut_fuse_grad=True, beta1=0.9, niter_decay=30,
                       **_PAPER_DIMS),
    # 4. tSVD low-rank multimodal teacher (MIA 2022/train.sh: --tSVD_loss
    #    True --n_views 4 --tSVD_mode pathomic --Lambda_global 0.1)
    "tsvd_teacher": Options(mode="pathomic", model_name="m3lr_teacher",
                            pred_distill=1, CRD_distill=0, tSVD_loss=True,
                            n_views=4, tSVD_mode="pathomic",
                            Lambda_global=0.1, mu=1e-5, pho=1.1, max_mu=1.0,
                            aux_iter=1, init_type="max", beta1=0.5,
                            niter_decay=30, **_PAPER_DIMS),
    # 4b. DSCD student (MIA 2022/train.sh: hard 20 pos, 1024 neg)
    "dscd_student": Options(mode="pathomic", model_name="dscd_student",
                            fixed_model="m3lr_teacher", distill="crd",
                            num_teachers=2, assign_weights=True,
                            CE_grads=True, select_pos_mode="hard",
                            pos_mode="multi_pos", nce_p=300, nce_p2=20,
                            nce_k=1024, nce_k2=1024, alpha=1.0, beta=0.02,
                            reg_type="none", beta1=0.9, kd_T=1.0,
                            niter_decay=30, **_PAPER_DIMS),
    # 5a. CLAT stage-1 masked teacher (training_script_Masking.sh:
    #     --masking 1 --Path_K 1 --Omic_K 5)
    "clat_stage1": Options(mode="pathomic", model_name="clat_teacher",
                           pred_distill=1, CRD_distill=0, masking=1,
                           num_superpixels=100, Path_K=1, Omic_K=5,
                           start_epoch=1, beta1=0.9, niter_decay=30,
                           **_PAPER_DIMS),
    # 5b. CLAT stage-2 student (train_20230805.sh: --nce_p 6 --nce_k 4096
    #     --pos_mode exact --pos_extra neighbors --max_discrep 1
    #     --grads_thresh 0.25 --use_grads_thresh True --num_teachers 2
    #     --assign_weights True)
    "clat_stage2": Options(mode="pathomic", model_name="clat_student",
                           fixed_model="clat_teacher", distill="crd",
                           num_teachers=2, assign_weights=True,
                           CE_grads=True, loss_weighting="GK_refine",
                           use_grads_thresh=True, grads_thresh=0.25,
                           pos_mode="exact", pos_extra="neighbors",
                           nce_p=6, nce_k=4096, max_discrep=1.0,
                           start_reweight=40, alpha=1.0, beta=0.02,
                           reg_type="none", beta1=0.9, niter_decay=30,
                           **_PAPER_DIMS),
    # MICCAI-2022 student (README: --distill crd -a 1 -b 0.02 --nce_p2 20
    #     --num_teachers 2 --CE_grads --select_pos_mode mid)
    "miccai_student": Options(mode="pathomic", model_name="miccai_student",
                              fixed_model="stage1_pathomic_teacher",
                              distill="crd", num_teachers=2,
                              assign_weights=True, CE_grads=True,
                              select_pos_mode="mid", pos_mode="multi_pos",
                              nce_p=300, nce_p2=20, nce_k=700, nce_k2=512,
                              alpha=1.0, beta=0.02, reg_type="none",
                              beta1=0.9, niter_decay=30, **_PAPER_DIMS),
}


def get_recipe(name: str, **overrides) -> Options:
    if name not in BASELINE_RECIPES:
        raise KeyError(f"unknown recipe {name}; have "
                       f"{sorted(BASELINE_RECIPES)}")
    opt = BASELINE_RECIPES[name]
    return opt.replace(**overrides) if overrides else opt
