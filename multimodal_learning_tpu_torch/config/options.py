"""Typed configuration for the whole framework.

The port's own copy of ``multimodal_learning_tpu/config/options.py``: the
same fields, defaults and argparse shim, so one flag line drives either
package and a checkpoint's saved ``opt`` dict rebuilds the same model here.
``pallas_fusion`` routes the pofusion Kronecker contraction to the CUDA
kernels (``ops/kron_fusion.py``); ``paired_conv`` is accepted and runs the
ordinary convolution, of which it is an exact reformulation.

This is the union of the four reference CLI surfaces:
- ``MICCAI-2022/options.py:8-164``
- ``MIA 2022/options.py`` (adds ``neg_reweight``, ``grads_m``, ``grads_thresh``,
  ``thresh``)
- ``MIA 2023/stage1_multi_modal_teacher/options.py:161-168`` (adds SLIC/masking
  knobs ``num_superpixels``, ``Path_K``, ``Omic_K``, ``start_epoch``, ``masking``)
- ``MIA 2023/stage2_unimodal_student/options_new.py`` (adds ``loss_weighting``,
  ``pos_extra``, ``neg_mode``, ``start_reweight``, ``discrep_scale``,
  ``max_discrep``, ``use_grads_thresh``, ``revision_exp``)

Unlike the reference, booleans are *real* booleans internally; the argparse shim
still accepts the reference's string-typed "True"/"False" values so existing
shell recipes keep working verbatim.  Unknown flags are ignored, mirroring the
reference's ``parser.parse_known_args()[0]`` behaviour
(``MICCAI-2022/options.py:161``).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import List, Optional


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes", "t")


@dataclass
class Options:
    # ------------------------------------------------------------------ t-SVD
    # reference: MICCAI-2022/options.py:10-25
    tSVD_mode: str = "path"                # [path, omic, pathomic]
    tSVD_loss: bool = False
    n_views: int = 4
    Lambda_global: float = 0.05
    mu: float = 1e-5
    max_mu: float = 1.0
    pho: float = 1.1
    aux_iter: int = 1
    proto_beta: float = 0.5

    # --------------------------------------------------- distillation control
    # reference: MICCAI-2022/options.py:27-55
    orth_loss: bool = False
    student_customize: bool = False
    assign_weights: bool = False
    distill: str = "kd"                    # kd|feats_KL|hint|attention|similarity|
    #                                        correlation|vid|crd|kdsvd|fsp|rkd|pkt|
    #                                        abound|factor|nst
    kd_T: float = 1.0
    gamma: float = 1.0                     # -r: weight for classification
    alpha: Optional[float] = None          # -a: weight for KD
    beta: Optional[float] = None           # -b: weight for other losses
    cut_fuse_grad: bool = False
    select_pos_mode: str = "random"        # hard|mid|random|curriculum
    select_pos_pairs: bool = True
    select_neg_pairs: bool = True
    CE_grads: bool = False
    fixed_model: str = "1023_pathomic_MT"
    svm_norm: bool = False
    grad_place: str = "feat"
    omic_transform: str = "drop"           # drop|vime
    return_grad: bool = False

    # ------------------------------------------------------- KD / teachers
    # reference: MICCAI-2022/options.py:63-75
    start_KD: int = 10
    pred_distill: int = 1
    num_teachers: int = 1
    KD_weight: float = 1.0
    KD_type: str = "KD"                    # KD|CRD|CRD_KD
    sample_KD: bool = False
    global_step: int = 0
    ema_decay: float = 0.99
    consistency_rampup: float = 10
    which_teacher: str = "fuse"            # fuse|self_EMA

    # ------------------------------------------------------------- CRD / NCE
    # reference: MICCAI-2022/options.py:76-91
    CRD_distill: int = 1
    CRD_mode: str = "sup"                  # sup|unsup
    CRD_weight: float = 0.1
    s_dim: int = 128
    t_dim: int = 128
    feat_dim: int = 128
    pos_mode: str = "multi_pos"            # exact|relax|multi_pos
    nce_p: int = 300
    nce_p2: int = 10
    nce_k: int = 700
    nce_k2: int = 512
    nce_t: float = 0.07
    nce_m: float = 0.5
    n_data: int = 1024

    # --------------------------------------------------------- SP / SupCon
    SP_distill: int = 0
    SP_weight: float = 1.0
    supcon_distill: int = 0
    supcon_weight: float = 1.0

    # ------------------------------------------------------------- common
    # reference: MICCAI-2022/options.py:101-160
    dataroot: str = "./data/TCGA_GBMLGG"
    checkpoints_dir: str = "./checkpoints/TCGA_GBMLGG"
    exp_name: str = "grad_15"
    gpu_ids: str = "0"                     # kept for CLI parity; ignored on TPU
    mode: str = "pathomic"                 # path|omic|pathomic
    model_name: str = "omic"
    use_vgg_features: int = 0
    use_rnaseq: int = 0
    task: str = "grad"                     # surv|grad
    useRNA: int = 0
    useSN: int = 1
    act_type: str = "LSM"                  # Tanh|ReLU|Sigmoid|LSM|none
    input_size_omic: int = 80
    input_size_path: int = 512
    init_gain: float = 0.02
    save_at: int = 20
    label_dim: int = 3
    measure: int = 1
    verbose: int = 1
    print_every: int = 0

    optimizer_type: str = "adam"           # adam|adagrad|adabound
    beta1: float = 0.5
    beta2: float = 0.999
    lr_policy: str = "linear"              # linear|exp|step|plateau|cosine|onecycle
    lr_decay_iters: int = 10
    finetune: int = 1
    final_lr: float = 0.1
    reg_type: str = "omic"                 # none|path|mm|all|omic
    niter: int = 0
    niter_decay: int = 30
    epoch_count: int = 1
    batch_size: int = 16

    lambda_cox: float = 1.0
    lambda_reg: float = 3e-4
    lambda_nll: float = 1.0

    fusion_type: str = "pofusion"          # concat|pofusion|polynomial_fusion|LMF|HFB
    skip: int = 0
    use_bilinear: int = 1
    path_gate: int = 1
    omic_gate: int = 1
    path_dim: int = 128
    omic_dim: int = 128
    path_scale: int = 1
    omic_scale: int = 1
    mmhid: int = 128

    init_type: str = "max"                 # normal|xavier|kaiming|orthogonal|max|none
    dropout_rate: float = 0.1
    use_edges: float = 1
    pooling_ratio: float = 0.2
    lr: float = 5e-4
    weight_decay: float = 4e-4
    GNN: str = "GCN"
    patience: float = 0.005

    # ------------------------------------------------------ MIA-2022 deltas
    neg_reweight: bool = False             # MIA 2022/options.py:48
    grads_m: float = 0.5                   # MIA 2022/options.py:80
    grads_thresh: float = 0.2              # float in S2; "True"-string in MIA22 —
    #                                        we keep the float and a separate bool:
    use_grads_thresh: bool = False         # S2 options_new.py:41
    thresh: float = 0.1                    # MIA 2022/options.py:82

    # ------------------------------------------- MIA-2023 stage-1 (masking)
    num_superpixels: int = 100             # stage1 options.py:163
    Path_K: int = 5
    Omic_K: int = 5
    start_epoch: int = 1
    masking: int = 0

    # ------------------------------------------- MIA-2023 stage-2 (CLAT)
    revision_exp: int = 1                  # options_new.py:17
    loss_weighting: str = "GK_refine"      # options_new.py:18
    pos_extra: str = "centers"             # centers|neighbors|none
    neg_mode: str = "all_others"           # all_others|diff_class|both_models
    start_reweight: int = 40
    discrep_scale: int = 1
    max_discrep: float = 1.0

    # --------------------------------------------------- TPU-build additions
    seed: int = 2019                       # reference seeds torch/random with 2019
    #                                        (train_test_MT.py:43-46)
    data_parallel: int = 0                 # data-mesh devices: 0 = off
    #                                        (single device), -1 = all
    #                                        devices, N = first N devices;
    #                                        batch_size must divide by N
    compute_dtype: str = "float32"         # float32|bfloat16 activations
    pallas_fusion: str = "off"             # off|eval|train — route the
    #                                        pofusion Kronecker contraction
    #                                        through the fused CUDA kernels
    #                                        (ops/kron_fusion.py); "train"
    #                                        also selects the masked-dropout
    #                                        train kernel, which is not
    #                                        ported yet (training raises)
    paired_conv: bool = False              # lane-paired ResNet convs in the
    #                                        JAX package: an exact
    #                                        reformulation, so the port
    #                                        accepts it and runs the ordinary
    #                                        convolution
    host_workers: int = 4                  # decode threads (ref num_workers=4)
    prefetch_depth: int = 2                # device prefetch buffers
    pretrained_path: str = ""              # path to converted ResNet18 weights
    #                                        (.npz) — replaces the reference's
    #                                        torchvision .pth load (resnets.py:281)
    teacher_bn: str = "batch"              # frozen-teacher forward mode in the
    #                                        student flows: "batch" = reference
    #                                        (fix_model.train() under no_grad,
    #                                        batch-stats BN + live dropout,
    #                                        train_test_path_multi_distill.py:232);
    #                                        "running" = eval-mode with the
    #                                        saved running stats (TPU-build
    #                                        alternative, better behaved at
    #                                        small batch)
    masking_bn: str = "chain"              # S1 masked-forward BN running
    #                                        stats: "chain" = reference (torch
    #                                        advances running stats through
    #                                        every train-mode forward, so the
    #                                        masked student/EMA forwards chain
    #                                        onto the view-1/EMA updates);
    #                                        "discard" keeps only the view-1 /
    #                                        EMA updates.  Loss/grad-invariant
    #                                        either way (train BN normalises
    #                                        by current batch stats).
    CRD_gate: bool = False                 # weighted_CRDLoss loss-comparison
    #                                        gate (CRD_loss.py:8-50, dead in
    #                                        the reference): only the side
    #                                        whose per-sample task loss is
    #                                        currently larger receives the
    #                                        CRD gradient
    synthetic_data: bool = False           # fabricate a miniature dataset (tests)
    synthetic_folds: int = 1               # folds in the fabricated split dict
    #                                        (cli.sweep runs the reference's
    #                                        15-fold protocol synthetically)
    resume: bool = False                   # resume a fold from its latest
    #                                        epoch snapshot (the reference has
    #                                        no mid-fold resume — SURVEY §5)
    snapshot_every: int = 5                # epochs between resumable snapshots
    export_batch: int = 0                  # cli.export_model serving batch
    #                                        size (0 = --batch_size); the
    #                                        StableHLO artifact is fixed-shape
    export_dynamic_batch: bool = False     # export a batch-POLYMORPHIC
    #                                        artifact instead (jax.export
    #                                        symbolic shapes): one blob serves
    #                                        any batch size, one compile per
    #                                        distinct size at serve time
    test_augment: bool = False             # the MICCAI/MIA22 reference applies
    #                                        the full random augmentation at
    #                                        test time too
    #                                        (data_loaders_MT.py:112-119); the
    #                                        S2 fork removed it.  Off by
    #                                        default; enable for bit-faithful
    #                                        MICCAI evaluation noise.

    # ------------------------------------------------------------ derived
    @property
    def total_epochs(self) -> int:
        return self.niter + self.niter_decay

    @property
    def n_classes(self) -> int:
        return self.label_dim

    def replace(self, **kw) -> "Options":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Parsed-but-dead flag registry.  Every Options field must either be consumed
# somewhere in the package or appear here with the reason (enforced by
# tests/test_flag_wiring.py::test_options_closure).  "dead in the reference"
# means the reference parses the flag but never reads it on any live path.
# --------------------------------------------------------------------------
DEAD_FLAGS = {
    # -------- dead in the reference too (parse-only there as well)
    "KD_type": "never read in the reference (train_test_MT.py greps clean)",
    "start_KD": "read only in commented-out code (train_test_MT.py:154)",
    "CRD_mode": "never read in the reference (resnets.py:242 comment only)",
    "proto_beta": "never read in the reference",
    "grad_place": "never read in the reference",
    "return_grad": "never read in the reference",
    "gamma": "parsed (-r alias) but never read in the reference",
    "save_at": "never read in the reference",
    "finetune": "never read in the reference",
    "revision_exp": "RLW/UW revision switch, unimplemented in the reference "
                    "(options_new.py:18-19); fail-fast via loss_weighting",
    "discrep_scale": "passed into assign_sample_weights but its only use is "
                     "commented out (S2 ...distill.py:155)",
    "useRNA": "never read in the reference",
    "useSN": "never read in the reference",
    "consistency_rampup": "get_current_consistency_weight defined but its "
                          "call is commented (train_test_MT.py:154-155); "
                          "sigmoid_rampup implemented in train/schedules.py",
    "omic_transform": "loader call commented in the reference "
                      "(train_test_MT.py:127-128); implementation kept at "
                      "data/sampling.py:omic_transform",
    # -------- graph-modality vestige (mode 'graph' was dropped upstream;
    # PARITY §2.2)
    "use_edges": "torch_geometric graph branch, vestigial in the reference",
    "pooling_ratio": "graph branch, vestigial in the reference",
    "GNN": "graph branch, vestigial in the reference",
    # -------- N/A on this backend / subsumed by the TPU design
    "gpu_ids": "CUDA DataParallel device list; the TPU build shards via "
               "--data_parallel over a jax mesh (parallel/mesh.py)",
    "s_dim": "CRD embed input width; flax infers it from the feature "
             "(contrast/crd.py Embed) so it cannot disagree with the model",
    "t_dim": "CRD teacher embed input width; inferred likewise",
    "measure": "per-epoch train-metric print gate; the TPU build always "
               "logs epoch metrics to JSONL (utils/logging.py)",
    "print_every": "per-batch print cadence; subsumed by per-epoch JSONL "
                   "logging (the hot loop is one jitted step)",
}


_BOOL_STR_FIELDS = {
    # flags the reference types as str "True"/"False"
    "tSVD_loss", "orth_loss", "student_customize", "assign_weights",
    "select_neg_pairs", "return_grad", "sample_KD", "neg_reweight",
    "use_grads_thresh",
}
_STORE_TRUE_FIELDS = {
    # flags the reference defines with action="store_true"
    "cut_fuse_grad", "select_pos_pairs", "CE_grads", "svm_norm",
    "synthetic_data",
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="multimodal_learning_tpu")
    for f in dataclasses.fields(Options):
        name = "--" + f.name
        default = f.default
        if f.name in _BOOL_STR_FIELDS or (isinstance(default, bool)
                                          and f.name not in _STORE_TRUE_FIELDS):
            parser.add_argument(name, type=_str2bool, default=default)
        elif f.name in _STORE_TRUE_FIELDS:
            # accept both bare flag and an optional True/False value, so the
            # reference recipes' `--cut_fuse_grad` and `--select_pos_pairs True`
            # both parse.
            parser.add_argument(name, nargs="?", const=True, type=_str2bool,
                                default=default)
        elif f.type == "Optional[float]":
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=type(default), default=default)
    # reference short aliases (MICCAI-2022/options.py:37-39)
    parser.add_argument("-r", dest="gamma", type=float)
    parser.add_argument("-a", dest="alpha", type=float)
    parser.add_argument("-b", dest="beta", type=float)
    return parser


def parse_args(argv: Optional[List[str]] = None, save: bool = True) -> Options:
    """Parse CLI flags into :class:`Options`.

    Unknown flags are ignored (reference parity: ``options.py:161`` uses
    ``parse_known_args``).  The resolved config is written to
    ``<checkpoints_dir>/<exp_name>/<model_name>/train_opt.txt``
    (``options.py:184-190``).
    """
    parser = build_parser()
    ns, _unknown = parser.parse_known_args(argv)
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(Options)}
    opt = Options(**kw)
    if save:
        print_options(opt)
    return opt


def print_options(opt: Options, save: bool = True) -> str:
    """Format (and save) the resolved options.

    Mirrors ``MICCAI-2022/options.py:167-190``: prints every field sorted,
    marking non-default values, and writes ``train_opt.txt``.
    """
    defaults = Options()
    lines = ["----------------- Options ---------------"]
    for f in sorted(dataclasses.fields(Options), key=lambda f: f.name):
        v = getattr(opt, f.name)
        d = getattr(defaults, f.name)
        comment = "" if v == d else f"\t[default: {d}]"
        lines.append(f"{f.name:>25}: {str(v):<30}{comment}")
    lines.append("----------------- End -------------------")
    message = "\n".join(lines)
    if save:
        expr_dir = os.path.join(opt.checkpoints_dir, opt.exp_name, opt.model_name)
        os.makedirs(expr_dir, exist_ok=True)
        with open(os.path.join(expr_dir, "train_opt.txt"), "w") as fh:
            fh.write(message + "\n")
    return message
