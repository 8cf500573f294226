"""Rank bodies of ``tests/test_torch_port_data_parallel.py``.

Spawned ranks unpickle these functions by module name, so this module
imports the port, torch and numpy only, never ``jax``.  Each function also
runs without a data group, in the test's own process, for the world-1
side of a comparison.

Every family starts from the same seeded state and the same global batch.
Its models are built with a dropout rate of 0.25 and then every
``nn.Dropout`` and ``nn.AlphaDropout`` is set to 0, except the Kronecker
dropout of the fused encoder (``_KronEncoder1``, whose mask the step
draws from ``state.generator`` for the global batch), and the views are
augmented by the step itself: so the slicing of the global draws is
tested, and no rank-local draw enters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import define_model
from multimodal_learning_tpu_torch.models.fusion import _KronEncoder1
from multimodal_learning_tpu_torch.parallel import active, process_slice
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train import steps as psteps
from multimodal_learning_tpu_torch.train import student as pstudent
from multimodal_learning_tpu_torch.train import student_clat

SIZE, B, N_DATA, SEED = 32, 8, 32, 3
BASE = dict(mode="pathomic", task="grad", path_dim=8, omic_dim=8, mmhid=8,
            feat_dim=8, input_size_path=SIZE, batch_size=B, label_dim=3,
            n_data=N_DATA, reg_type="none", niter_decay=2, dropout_rate=0.25,
            pallas_fusion="train", nce_k=8)
# the five families of tests/test_sharding.py, the teacher with CRD and
# pred-KD as the JAX benchmark's
FAMILIES = {
    "teacher": dict(CRD_distill=1, pred_distill=1, num_teachers=2,
                    pos_mode="exact", nce_p=1),
    "tsvd": dict(tSVD_loss=True, tSVD_mode="pathomic", n_views=4,
                 CRD_distill=0, pred_distill=1, Lambda_global=0.1, mu=0.5),
    "masking": dict(masking=1, num_superpixels=8, Path_K=2, Omic_K=4,
                    CRD_distill=0, pred_distill=1),
    "student": dict(distill="crd", num_teachers=2, assign_weights=True,
                    CE_grads=True, select_pos_mode="hard",
                    pos_mode="multi_pos", nce_p=4, nce_p2=2, nce_k2=4,
                    alpha=1.0, beta=0.02),
    "clat": dict(distill="crd", num_teachers=2, assign_weights=True,
                 loss_weighting="GK_refine", use_grads_thresh=True,
                 grads_thresh=0.2, nce_p=2, pos_extra="neighbors",
                 pos_mode="multi_pos"),
}


def family_opt(family: str) -> Options:
    return Options(**BASE, **FAMILIES[family])


def family_batch(family: str) -> Dict[str, np.ndarray]:
    """The global batch of ``family``, from a numpy seed."""
    opt = family_opt(family)
    rng = np.random.default_rng(len(family))
    n_views = 4 if family == "masking" else 2
    cols = {"student": opt.nce_p + opt.nce_k, "teacher": 1 + opt.nce_k,
            "clat": 1 + opt.nce_k}.get(family)
    index = rng.choice(N_DATA, B, replace=False).astype(np.int32)
    batch = {"path_views": rng.integers(0, 256, (B, n_views, SIZE, SIZE, 3),
                                        dtype=np.uint8),
             "omic": rng.normal(size=(B, 80)).astype(np.float32),
             "e": np.ones(B, np.float32),
             "t": rng.exponential(20, B).astype(np.float32),
             "g": rng.integers(0, 3, B).astype(np.int32), "index": index}
    if cols:
        batch["sample_idx"] = rng.integers(0, N_DATA, (B, cols)
                                           ).astype(np.int32)
        batch["sample_idx"][:, 0] = index
    if family == "masking":
        batch["sp_mask"] = rng.integers(0, 8, (B, SIZE, SIZE)
                                        ).astype(np.int32)
    return batch


def _only_kron_dropout(model: nn.Module) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (nn.Dropout, nn.AlphaDropout)):
            m.p = 0.0
    for m in model.modules():
        if isinstance(m, _KronEncoder1):
            m.drop.p = BASE["dropout_rate"]
    return model


def _rows(batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch (all of it without a group)."""
    dp = active()
    world, rank = (dp.world, dp.rank) if dp is not None else (1, 0)
    return {k: torch.from_numpy(np.ascontiguousarray(
        process_slice(v, world, rank))) for k, v in batch.items()}


def _numpy(state) -> Dict[str, Dict[str, np.ndarray]]:
    """The state's model, EMA and BatchNorm buffers, banks and Adam's
    first moments, as numpy."""
    named = {**{f"model.{n}": p for n, p in state.model.named_parameters()},
             **{f"embeds.{n}": p for n, p in state.embeds.named_parameters()}}
    moments = state.optimizer.optimizer.state
    banks = {}
    for name, bank in state.banks.items():
        fields = (dataclasses.asdict(bank) if dataclasses.is_dataclass(bank)
                  else {"value": bank})
        for k, v in fields.items():
            banks[f"{name}.{k}"] = v.detach().cpu().numpy().copy()
    sd = lambda m: {k: v.detach().cpu().numpy().copy()
                    for k, v in m.state_dict().items()}
    return {"model": sd(state.model), "ema": sd(state.ema_model),
            "embeds": sd(state.embeds), "banks": banks,
            "exp_avg": {n: moments[p]["exp_avg"].detach().numpy().copy()
                        for n, p in named.items()}}


def run_family(family: str) -> Dict:
    """One step of ``family`` on this rank's rows of the global batch from
    the seeded state: ``{"metrics": ..., **_numpy(state)}``."""
    opt = family_opt(family)
    torch.manual_seed(SEED)
    batch = _rows(family_batch(family))
    gen = lambda s: torch.Generator().manual_seed(s)
    sched = make_lr_schedule(opt, steps_per_epoch=5)
    if "distill" in FAMILIES[family]:
        teacher = pstudent.freeze_teacher(
            _only_kron_dropout(define_model(opt, generator=gen(SEED + 1))),
            "cpu")
        state = pstudent.init_student_state(
            opt, _only_kron_dropout(define_model(opt, path_only=True,
                                                 generator=gen(SEED))),
            sched, N_DATA, seed=SEED, device="cpu")
        if family != "clat":
            step = pstudent.build_student_train_step(opt, teacher)
            state, metrics = step(state, batch, 0.5)
        else:
            labels = np.random.default_rng(1).integers(0, 3, N_DATA)
            mask = torch.zeros(3, N_DATA)
            mask[labels, np.arange(N_DATA)] = 1.0
            step = student_clat.build_clat_student_step(opt, teacher, mask)
            state, metrics = step(state, batch, True)
    else:
        state = psteps.init_teacher_state(
            opt, _only_kron_dropout(define_model(opt, generator=gen(SEED))),
            sched, N_DATA, seed=SEED, device="cpu")
        step = psteps.build_teacher_train_step(
            opt, masking=family == "masking")
        state, metrics = step(state, batch, 0.1)
    out = _numpy(state)
    out["metrics"] = {k: v.numpy().copy() for k, v in metrics.items()}
    return out


def run_families(families) -> Dict[str, Dict]:
    return {f: run_family(f) for f in families}


def run_bridged(opt: Options, tree: Dict, batch: Dict[str, np.ndarray],
                views: np.ndarray) -> Dict:
    """One teacher step from the JAX package's state ``tree`` (carried by
    ``load_jax_state``) on this rank's rows of ``batch``, with this rank's
    rows of the injected augmented ``views`` and torch's own CPU
    convolutions (no oneDNN)."""
    from multimodal_learning_tpu_torch.train.import_state import (
        jax_state_tree, load_jax_state)
    mine = _rows({"views": views})["views"]
    state = psteps.init_teacher_state(opt, define_model(opt),
                                      make_lr_schedule(opt, 50),
                                      opt.n_data, device="cpu")
    load_jax_state(state, tree)
    augment = psteps.augment_views
    psteps.augment_views = lambda gen, v, dtype=None: mine
    try:
        with torch.backends.mkldnn.flags(enabled=False):
            state, metrics = psteps.build_teacher_train_step(opt)(
                state, _rows(batch), 0.1)
    finally:
        psteps.augment_views = augment
    return {"metrics": {k: v.numpy().copy() for k, v in metrics.items()},
            "tree": jax_state_tree(state)}


def driver_opt(dp: int, root: str, **kw) -> Options:
    """``tests/test_data_parallel.py``'s teacher configuration at lr 1e-5:
    at its lr of 5e-3, Adam's first, sign-like update turns rounding into
    loss differences of 1e-2 by the third step, between two thread counts
    of one process already; at 1e-5 those stay below 1e-5, and a fault of
    the data path (rows, statistics, gathers) shows at first order."""
    return Options(**{**dict(
        mode="pathomic", task="grad", label_dim=3, niter=0, niter_decay=2,
        batch_size=8, input_size_path=32, path_dim=16, omic_dim=16, mmhid=16,
        feat_dim=8, s_dim=16, t_dim=16, CRD_distill=1, pred_distill=1,
        num_teachers=2, pos_mode="exact", nce_p=1, nce_k=8, lr=1e-5,
        verbose=1, checkpoints_dir=root, host_workers=2, seed=0,
        reg_type="none", dropout_rate=0.0, data_parallel=dp,
        model_name=f"dp{dp}"), **kw})


def driver_data():
    from multimodal_learning_tpu_torch.data.splits import \
        make_synthetic_splits
    return make_synthetic_splits(n_train=32, n_test=16, roi_size=32, seed=7)


def run_driver(root: str, dp: int) -> Dict:
    """``train_teacher`` at ``--data_parallel dp`` in this process (a rank
    when ``dp`` > 0): one epoch with a snapshot, then ``--resume`` to a
    second.  Returns both runs' final evals and the log lines."""
    from multimodal_learning_tpu_torch.train.loop import train_teacher
    data, logs = driver_data(), []
    first, _ = train_teacher(driver_opt(dp, root, niter_decay=1,
                                        snapshot_every=1),
                             data, 1, log=logs.append, device="cpu")
    resumed, _ = train_teacher(driver_opt(dp, root, resume=True), data, 1,
                               log=logs.append, device="cpu")
    return {"first": first, "resumed": resumed, "logs": logs}


def digest(tree):
    """Each array of a nested dict replaced by the SHA-1 of its bytes."""
    import hashlib
    if isinstance(tree, dict):
        return {k: digest(v) for k, v in tree.items()}
    return hashlib.sha1(np.ascontiguousarray(tree).tobytes()).hexdigest()


def _wait_for(path: str, seconds: float = 180.0):
    """The object pickled at ``path``, once the test process has written
    it (it renames a finished file into place)."""
    import os
    import pickle
    import time
    end = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError(f"{path} was not written in {seconds} s")
        time.sleep(0.05)
    with open(path, "rb") as fh:
        return pickle.load(fh)


def run_all(families, bridged_path: str, root: str) -> Dict:
    """The world-2 side of the test file in one launch: every family
    (rank 0's arrays; the other ranks' as digests, for the replication
    check), the teacher driver under ``root``, then the bridged teacher
    step on the arguments the test process pickles to ``bridged_path``
    meanwhile (None: skipped)."""
    out = {"families": run_families(families),
           "driver": run_driver(root, active().world)}
    if active().rank:
        out["families"] = digest(out["families"])
    bridged = _wait_for(bridged_path)
    if bridged is not None:
        out["bridged"] = run_bridged(*bridged)
    return out
