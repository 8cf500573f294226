"""Smoke run of the PyTorch port (``multimodal_learning_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. the card: CUDA must be available; prints its name and power limit;
2. builds every CUDA kernel of the port from the sources in this checkout
   and fails if ``ptxas`` reports spills in the Kronecker forward kernels;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving and train paths give it (and a few ragged ones): the
   eval contraction B2 and the masked train contraction B1 (one split-column
   GEMM kernel; also at fewer columns than blocks, N % 4 == 0 and several
   batch and k tiles, and bitwise equal on a second launch), B1's torch
   backward, B3 and B4 through ``kron_matmul(...).backward``, and B3 and B4
   through their wrappers at ``BWD_SHAPES`` (those shapes plus K = 33 at
   the paper width and a batch of 70 at K = 512), bitwise equal on a second
   launch;
4. drives the serving path end to end at the pofusion teacher's full width
   (the ``teacher`` recipe: ResNet18 on 512^2 patches + MaxNet + Kronecker
   fusion, path_dim = omic_dim = mmhid = 128, bf16 encoders, batch 16) with
   seeded random weights: a fold checkpoint in the JAX package's layout ->
   ``cli.export_model`` -> ``cli.predict`` on 20 synthetic 600x600 PNGs and
   an omic CSV, counting the kernels' launches;
5. cross-checks the same weights' float32 forward on the card (kernel path,
   TF32 off) against the CPU (plain path), and the float32 saliency input
   gradients (``masking.saliency_grads``, through B2 and B4 on the card)
   likewise;
6. times an empty launch (the timing floor), B2, its plain version, the
   one PyTorch call that computes the same function and the cuBLAS GEMM of
   the pre-formed Kronecker vector, and the serving forward, and breaks the
   forward's device time down by kernel with torch.profiler;
7. drives the teacher's train path at full width (the JAX benchmark's
   flagship step: CRD with nce_k 512 + pred-KD, bf16 encoders, 512^2, two
   views, batch 16) through ``init_teacher_state`` and
   ``build_teacher_train_step``: 20 timed steps that must launch B1 twice
   each (student and EMA forward) with finite losses, then a profiled
   window of 3 steps that gives B1's time per step;
8. runs the masked teacher's saliency call, the ported
   ``masking.superpixel_attention_mask`` on the trained teacher in eval mode
   with its parameters frozen (NLL on ``pred_fuse``, batch 16, 512^2, 100
   synthetic superpixels with a few ids left empty), which must launch B2
   and B4 once and B3 never, as the JAX pass computes no weight gradient;
   checks the masks and the gradients, and times the call and B4's share;
9. cross-checks one fp32 train step on the card (kernel path, TF32 off)
   against the CPU (plain path) from the same state and views;
10. times B1, B3 and B4 against their plain versions, a PyTorch call where
    one computes the same function, and their bounds, L2-cold with the
    10th-90th percentile spread of the 50 calls; B1 also against the
    cuBLAS GEMM of the pre-formed masked Kronecker vector;
11. the train step of phase 7 again with ``--paired_conv True`` (the
    64-channel stage's convolutions through B5, ``ops/paired_conv.py``):
    20 timed steps that must launch B5 12 times each (4 in the student
    forward, 4 in the EMA forward, 4 data gradients) and B1 twice, then a
    profiled window that gives B5's share of the step;
12. drives the CV drivers at full width with ``--paired_conv True``:
    ``cli.train_cv_MT`` on one synthetic fold (2 epochs of 4 steps, an
    eval of 32 ROIs after each) and ``cli.test_cv_MT`` on its checkpoint,
    which must reproduce the final eval exactly; B5 must launch 12 times per
    step and 4 per eval forward, B1 twice per step, B2 once per eval
    forward;
13. times B5 (bf16 and fp32) against its plain version, ``F.conv2d`` and
    its bound, and prints the share of the bound reached and the ratio to
    ``F.conv2d`` for each dtype;
14. drives the MICCAI student's step at full width (the port's
    ``recipes/baseline.py`` ``miccai_student``: CRD from two teachers,
    nce_p 300 -> 20 by ``mid``, nce_k 700 -> 512, AEKD ``GK_refine`` with
    the CE gradient, bf16, 512^2, batch 16) through ``freeze_teacher`` on
    phase 7's trained teacher, ``init_student_state`` and
    ``build_student_train_step``: 20 timed steps (host ms per step, the
    median of 4 windows of 5) that must launch B1 once each and B2, B3, B4
    never, with finite losses and AEKD scale and the teacher's buffers
    bitwise unchanged; a profiled window (kernel ms per step, busy share,
    B1's share) and the host synchronisations per step; again with
    ``--teacher_bn running`` (B2 once per step, B1 never) and with
    ``--paired_conv True`` (B5 16 times per step: 4 forwards each of the
    student, the EMA and the teacher, 4 data gradients);
15. drives the M3LR t-SVD teacher's step at full width (``tsvd_teacher``:
    n_views 4, Lambda_global 0.1, mu 1e-5, pho 1.1, max_mu 1, aux_iter 1)
    likewise: B1 twice per step, finite ``loss_tsvd`` and TNNs, mu grown by
    pho per refresh; a profiled window, and the host synchronisations per
    step (the complex SVD's);
16. cross-checks one fp32 student step on the card (kernel path, TF32 off)
    against the CPU (plain path) from the same state, views and ranks;
17. drives the MIA-2022 chain through the CLIs on one full-width synthetic
    fold with ``--paired_conv True``: ``cli.train_cv_MT --tSVD_loss True``
    (2 epochs of 4 steps), ``cli.train_cv_path_multi_MT`` with the
    ``dscd_student`` flags on that teacher (1 epoch) and
    ``cli.test_cv_path``, which must reproduce the student's final eval
    exactly; launches checked per step and per eval forward;
18. builds the SLIC library (``masking/slic.py``, g++ from
    ``native/slic/slic.cpp``), checks its labels on 16 synthetic 512^2
    ROIs and times it per ROI on the host;
19. drives the masked CLAT teacher's step at full width (``clat_stage1``:
    100 superpixels, Path_K 1, Omic_K 5, pred-KD, bf16, 512^2, batch 16, 4
    views) on phase 18's ROIs and SLIC labels through
    ``build_teacher_train_step(masking=True)``: ``--masking_bn chain`` (4
    windows of 5 steps), chain with ``--paired_conv`` and discard (a
    window); per step B1 6 times, B2 and B4 once (the saliency pass), B3
    never, B5 36 times when paired; host ms, kernel ms, busy share, the
    kernels' shares and the host synchronisations per step;
20. cross-checks one fp32 masked step on the card against the CPU (batch
    4, dropout 0, the same flips and jitter): saliency masks equal, loss
    parts, heads' moments and BatchNorm buffers at rtol 2e-3 / atol 5e-4,
    the trunk's moments by norm at 2e-2;
21. drives the CLAT student's step at full width (``clat_stage2``: nce_p 6,
    nce_k 4096 over banks of 8192 rows, kNN positives, GK_refine with the
    0.25 threshold, two teachers) on phase 19's teacher: a run of 4
    windows, and a window each with the query weights on, with k-means
    centre positives, with ``--teacher_bn running`` and with
    ``--paired_conv``; per step B1 once (B2 under ``running``), B5 16
    times when paired;
22. drives the MIA-2023 chain through the CLIs on one full-width synthetic
    fold with ``--paired_conv True``: ``cli.train_cv_MT_SP_Masking``
    (``--start_epoch 1``, 2 epochs: the second masked, on the loader's
    SLIC maps), ``cli.train_cv_path_CLAT`` (1 epoch) and
    ``cli.test_cv_path``, which must reproduce the student's final eval
    exactly; launches checked per step and per eval forward;
23. drives the student's step of each distiller-zoo mode and of HKD
    (``--distill feats_KL|rkd|pkt|hint|correlation|hkd`` on the phase 14
    flags) on phase 7's teacher: one window of 5 steps each, B1 once per
    step and no other kernel, finite losses and gradients, 0 host syncs;
    host ms, kernel ms and busy share; HKD's first step must move the
    bank's batch rows to norm 1 and leave every other row bitwise;
24. the student's step under ``--loss_weighting SVM --svm_norm True``
    (CRD from two teachers with the CE gradient: five losses): one window
    of 5 steps, B1 once per step, exactly one host sync per step, in
    ``gradweight/svm.py``, weights summing to 1; and the host solve's time;
25. the flagship teacher step of phase 7 with ``--supcon_distill 1``: one
    window of 5 steps, B1 twice per step, 0 host syncs, ``loss_supcon``
    finite and positive;
26. cross-checks one fp32 ``rkd`` student step (batch 4) and one ``hkd``
    step (batch 10, so that the k = 8 graphs are not complete) on the card
    against the CPU at phase 16's tolerances; the two kNN adjacencies must
    be equal;
27. drives ``cli.train_cv_path_multi_MT --distill hkd`` (the
    ``dscd_student`` flags but for the mode, 1 epoch) on phase 17's
    teacher and ``cli.test_cv_path``, which must reproduce the student's
    final eval exactly;
28. drives the mmdynamics step at full width (``--fusion_type
    mmdynamics``, pred-KD and CRD off, bf16, 512^2, batch 16) through
    ``init_teacher_state`` and ``build_mmdynamics_train_step``, unpaired
    and with ``--paired_conv`` (4 windows of 5 steps each): no Kronecker
    kernel, B5 8 times per step when paired (4 forwards, 4 data
    gradients), finite losses and gradients, 0 host syncs, the EMA
    model's parameters and buffers bitwise unchanged;
29. the teacher step of the ``teacher`` recipe with ``--fusion_type
    polynomial_fusion``, ``LMF`` and ``HFB``: one window of 5 steps each,
    no kernel of the port, 0 host syncs;
30. cross-checks one fp32 mmdynamics step (batch 4, dropout 0) and the
    fp32 serving forward of each new fusion type and of the mmdynamics
    model on the card against the CPU at phase 9's and phase 5's
    tolerances;
31. drives the mmdynamics chain through the CLIs on one full-width
    synthetic fold with ``--paired_conv True``: ``cli.train_cv_MT`` (2
    epochs of 4 steps), ``cli.test_cv_MT``, which must reproduce the
    final eval exactly, ``cli.export_model`` and ``cli.predict``, whose
    outputs are ``{"pred_fuse"}``; then times the exported artifact's
    serving forward per batch of 16;
32. writes a torchvision-style ResNet18 file (the trunk, a 1000-way
    ``fc``, ``num_batches_tracked``) and a released-style wrapper of a
    whole pofusion model, converts both with ``cli.convert_torch``
    (``--arch resnet18``; ``--arch pathomic --state_key
    ema_model_state_dict``); ``init_teacher_state`` with
    ``--pretrained_path`` and ``--init_type max`` must load the trunk and
    its running statistics bitwise, keep ``fc_new*`` as drawn and start
    the EMA equal to the model; then ``cli.train_cv_MT`` with the file on
    one synthetic fold, 1 epoch of 4 steps, ``--paired_conv True``: B1
    twice and B5 12 times per step;
33. ``--init_type normal|xavier|kaiming|orthogonal`` on the same file: the
    trunk clobbered, biases exactly 0, each kernel's std within 5 % of its
    JAX law (orthogonal: Q^T Q = gain^2 I to 1e-4); then one window of 5
    flagship steps each with ``--optimizer_type adabound --lr_policy
    onecycle`` and ``--optimizer_type adagrad``: B1 twice per step, finite
    losses, 0 host syncs, host and kernel ms per step;
34. ``cli.test_cv_MT --pretrained_path '<dir>/teacher_{k}.npz'`` with no
    fold checkpoint: B2 once per eval forward, and its prediction pickle
    bitwise equal to ``train.loop.evaluate`` of the same weights loaded by
    ``load_state_dict``;
35. ``cli.export_model`` of those weights to ``torch.export`` ``.pt2``
    artifacts at batch 16 and with a dynamic batch, unpaired and paired;
    ``cli.predict`` of all four in a fresh ``python3`` that must not import
    the port's ``models``, each output bitwise the eager ``make_infer_fn``;
    the dynamic artifacts serve batches 1, 5 and 16 bitwise; B2 once and
    B5 4 times (paired) per forward; ms per batch of 16, artifact against
    eager, in turns; the host cost of the registered ops' dispatch per
    launch;
36. the ``teacher`` recipe through the offline evaluation chain as a user
    runs it, at full width on two synthetic folds (64 + 32 ROIs each, one
    patch per patient, 2 epochs, seed 2020): ``cli.train_cv_MT`` ->
    ``cli.export_model`` -> ``cli.test_cv_MT`` -> ``cli.evaluation_GBMLGG``
    -> ``cli.ROI_evaluation``; B1 twice per step, B2 once per eval forward
    and once per exported fold's check forward; each fold's patient-level
    ``max`` and ``mean`` rows equal to test_cv_MT's metrics of that fold
    exactly, and ROI_evaluation's rows to ``roi_evaluation`` of the dumped
    probabilities; each driver's wall s;
37. ``cli.sweep --folds 2`` over its four groups (omic, teacher -> MICCAI
    student, t-SVD -> DSCD student, CLAT) at the sweep's own tiny widths,
    where ``pallas_fusion`` is off and no kernel launches: the five
    sections with finite fold means and the patient-level table; its wall
    s;
38. ``--data_parallel`` (``parallel/mesh.py``) at world size 1 on NCCL, a
    group of one joined in this process: the first fp32 flagship teacher
    step (dropout 0.1) and MICCAI student step (dropout 0) against the
    same steps without data parallel at phase 9's tolerances; a window of
    5 bf16 steps of each (B1 twice and once per step), with host and
    kernel ms, busy share and NCCL kernels per step, against the steps
    without data parallel in turns; the global train-mode BatchNorm's
    forward and backward against cuDNN's at the stem's shape; then
    ``cli.train_cv_MT --data_parallel -1`` in ranks started by
    ``parallel.launch`` (one per card) on one synthetic fold, 2 epochs of
    4 steps: B1 16 times and B2 4 times in rank 0, and ``cli.test_cv_MT``
    reproducing its final eval exactly; with two cards or more, the
    world-2 first step against world 1, else a line saying it was not run;
39. the input path users run, at full width: ``make_synthetic_splits``
    writes one fold of 64 + 32 ROIs as 1024^2 JPEGs (quality 90, the
    reference's ``all_st`` ROI size) and the split pickle goes where
    ``split_pickle_path`` looks; prints which decoder serves
    (``native_loader``'s libjpeg build, or PIL with g++'s error), each
    decoder's ms per ROI (median of 20) and, with the native one, fails
    if any ROI's pixels differ from PIL's; the loader's ROIs/s with its
    cache cold; ``cli.train_cv_MT`` on the ``teacher`` recipe at 512^2
    crops with ``--paired_conv True`` and without ``--synthetic_data`` (2
    epochs of 4 steps) and ``cli.test_cv_MT`` (B1, B2 and B5 counted as
    in phase 12): the ROIs are larger than the crop, so the evals crop at
    random (as in the reference and the JAX package) and each draws its
    own crops; the training-time final eval and test_cv_MT must each
    equal exactly an eval of the fold checkpoint on the same draw; then a
    fold of that recipe with ``--lr_policy plateau`` and CRD stopped after
    epoch 1, its ``.pt`` state written as the JAX package's ``.snap``
    (``save_jax_snapshot``) and deleted: the ``.snap``-restored state must
    equal the ``.pt``-restored one tensor for tensor, and ``train_cv_MT
    --resume`` must carry the fold on from the ``.snap``; the ``.snap``'s
    MiB, write and read s, and the phase's wall s.

Phases 4, 14-17, 19-22, 27, 29, 32-36 and 39 take their configurations from
the port's recipes (``recipes/baseline.py``) with the cuts named beside
them (``_recipe``).

Every phase that counts host synchronisations (7, 11, 14, 15, 19, 21,
23, 24, 25, 28, 29, 33) fails if one comes from the augmentation.

Phase 3 also holds B5 against its plain version (TF32 off), in bf16 and
fp32, at the stage-1 shape, ragged ones, one with many tiles per block, one
with fewer tiles than SMs, and one with ragged row and column bands; its
transposed form (the data gradient) likewise; checks that two launches on
the same inputs give the same bits; and holds its autograd function's
gradients against autograd of ``F.conv2d``.

The next-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
CUDA is unavailable or the port's package is not beside this script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.recipes import get_recipe
from multimodal_learning_tpu_torch.recipes.baseline import _PAPER_DIMS

SEED = 2019
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12     # fp32 outside the tensor cores
H100_BF16_FLOP_PER_S = 989e12    # dense bf16 on the tensor cores
# (B, H, W, C); the first is stage 1 at 512^2; (33, ...) gives each block
# 16 tiles, (1, 1, 2) fewer tiles than SMs, (5, 129, 66) a ragged bottom row
# band and a ragged right column band
CONV_SHAPES = [(16, 128, 128, 64), (1, 128, 128, 64), (3, 37, 50, 64),
               (2, 8, 8, 64), (33, 128, 128, 64), (1, 1, 2, 64),
               (5, 129, 66, 64)]
KRON_SHAPES = [(16, 129, 129, 128), (1, 129, 129, 128), (37, 129, 129, 128),
               (4, 9, 9, 16)]
# the forward kernels B2 and B1 also at a ragged K, fewer columns than
# blocks (N = 15), N % 4 == 0 (every row at shift 0), and several batch
# tiles with K beyond one k tile
FWD_SHAPES = KRON_SHAPES + [(3, 200, 170, 33), (2, 3, 5, 7),
                            (16, 128, 128, 128), (64, 129, 129, 256)]
# the backward kernels B3 and B4 also at K = 33 at the paper width, and at
# a batch beyond one staged chunk of B3 and several g chunks of B4
BWD_SHAPES = FWD_SHAPES + [(16, 129, 129, 33), (70, 9, 9, 512)]
N_IMAGES = 20


def _recipe(name, **cuts):
    """The port's ``recipes.get_recipe(name, **cuts)`` as a dict of the
    paper dims and every field it sets away from ``Options``' defaults, so
    that ``Options(**_recipe(...))`` is that recipe and the dict passes as
    CLI flags."""
    opt, base = get_recipe(name, **cuts), Options()
    return {f.name: getattr(opt, f.name) for f in dataclasses.fields(opt)
            if f.name in _PAPER_DIMS or f.name in cuts
            or getattr(opt, f.name) != getattr(base, f.name)}


# the recipes' shared paper width (bf16, 512^2, batch 16, B1/B2 on)
PAPER = dict(_PAPER_DIMS)
# phase 4's serving path: the ``teacher`` recipe under a name of its own
SERVE_CONFIG = _recipe("teacher", model_name="smoke_teacher")


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def _kron_inputs(b, d1, d2, k, gen, dev):
    # post-ReLU gated features with the appended 1, and encoder1 at its
    # max init N(0, 1/sqrt(fan_in)): the scales the serving path feeds it
    o1 = torch.rand(b, d1, generator=gen)
    o2 = torch.rand(b, d2, generator=gen)
    o1[:, -1] = o2[:, -1] = 1.0
    w = torch.randn(k, d1 * d2, generator=gen) / (d1 * d2) ** 0.5
    bias = torch.randn(k, generator=gen)
    return [t.to(dev) for t in (o1, o2, w, bias)]


def _cold_times(fn, n, flush):
    """Device time of each of ``n`` calls of ``fn()`` from CUDA events,
    with the 50 MB L2 flushed before each.  A sleep kernel queued first
    keeps the device busy while the host enqueues, so host launch overhead
    is not timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e5 * n))
    evs = []
    for _ in range(n):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return np.array([s.elapsed_time(e) for s, e in evs])


def _time_ms(fn, n, cold, flush):
    """Device time of ``fn()``: L2-cold, the median of ``_cold_times``;
    warm, the mean over back-to-back calls (CUDA events, the host's
    enqueue hidden behind a sleep kernel as there)."""
    if cold:
        return float(np.median(_cold_times(fn, n, flush)))
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e5 * n))
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


def _time_floor(card, flush):
    """The timing floor of ``_time_ms``: an empty launch
    (``torch.cuda._sleep(0)``), L2-cold and warm."""
    times = {cold: _time_ms(lambda: torch.cuda._sleep(0), 50, cold, flush)
             for cold in (False, True)}
    print(f"timing floor (an empty launch): L2-cold {times[True]:.5f} "
          f"L2-warm {times[False]:.5f} ms ({card})")
    return times


def _check_fwd_kernels(gen, dev, card):
    """B2 and B1 (the one split-column GEMM kernel, without and with the
    mask) against their plain versions at ``FWD_SHAPES``, each launched
    twice on the same inputs, which must give the same bits.  Returns the
    max abs error of each."""
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    errs = {"kron_fwd": 0.0, "kron_train_fwd": 0.0}
    for shape in FWD_SHAPES:
        b, d1, d2, k = shape
        args = _kron_inputs(*shape, gen, dev)
        maskf = ((torch.rand(b, d1 * d2, generator=gen) < 0.9).float()
                 / 0.9).to(dev)
        for name, fn, plain, extra in (
                ("kron_fwd", kf.kron_matmul, kf.kron_matmul_plain, []),
                ("kron_train_fwd", kf.kron_matmul_dropout,
                 kf.kron_matmul_dropout_plain, [maskf])):
            with torch.inference_mode():
                got, again = fn(*args, *extra), fn(*args, *extra)
                want = plain(*args, *extra)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise RuntimeError(f"{name} {shape}: two launches on the "
                                   "same inputs differ")
            err = (got - want).abs().max().item()
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                       msg=f"{name} {shape}")
            errs[name] = max(errs[name], err)
            print(f"{name} {shape} max_abs_err={err:.3e}, bitwise equal on "
                  f"a second launch (rtol 1e-4, atol 1e-5; {card})")
    return errs


def _profile_serve(infer, xb, ob, card, n=5, top=8):
    """Where a serving forward's device time goes: kernel time by name from
    torch.profiler (CUDA activity only), and the device's busy share of the
    same forwards' span on the device clock (CUDA events around them)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            infer(xb, ob)
        e.record()
        torch.cuda.synchronize()
    span_ms = s.elapsed_time(e) / n
    events = prof.key_averages()
    dev_ms = sum(e.self_device_time_total for e in events) / n / 1e3
    if dev_ms == 0:
        print("profile serve: the profiler saw no device time; kernel "
              f"breakdown not measured ({card})")
        return
    print(f"profile serve: {dev_ms:.3f} ms of kernels per forward, device "
          f"busy {100 * dev_ms / span_ms:.1f}% of the same forwards' "
          f"{span_ms:.3f} ms span ({card})")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / n / 1e3
        print(f"  {100 * ms / dev_ms:5.1f}% {ms:.4f} ms x{e.count // n} "
              f"{e.key[:90]}")


def _check_train_kernels(gen, dev, card):
    """B1 (forward, and its torch backward against autograd through the
    plain version), B3 and B4 (through ``kron_matmul(...).backward``)
    against their plain versions on the card.  Returns the max abs error
    of each kernel's outputs."""
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    errs = {"kron_train_fwd": 0.0, "kron_bwd_dw": 0.0, "kron_bwd_dvec": 0.0}

    def check(name, got, want, what):
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5,
                                   msg=f"{name} {what}")
        return err

    for shape in KRON_SHAPES + [(3, 200, 170, 33)]:
        b, d1, d2, k = shape
        args = [t.requires_grad_() for t in _kron_inputs(*shape, gen, dev)]
        keep = 0.9
        maskf = ((torch.rand(b, d1 * d2, generator=gen) < keep).float()
                 / keep).to(dev)
        g = torch.randn(b, k, generator=gen).to(dev)
        # B1 forward, then the train contraction's backward (torch ops)
        y = kf.kron_matmul_dropout(*args, maskf)
        y_ref = kf.kron_matmul_dropout_plain(*args, maskf)
        err = check("kron_train_fwd", y, y_ref, shape)
        for a, r in zip(torch.autograd.grad(y, args, g),
                        torch.autograd.grad(y_ref, args, g)):
            check("kron_matmul_dropout backward", a, r, shape)
        errs["kron_train_fwd"] = max(errs["kron_train_fwd"], err)
        # B3 and B4 as kron_matmul's backward
        n3, n4 = kf.kron_bwd_dw.launches, kf.kron_bwd_dvec.launches
        got = torch.autograd.grad(kf.kron_matmul(*args), args, g)
        torch.cuda.synchronize()
        if (kf.kron_bwd_dw.launches, kf.kron_bwd_dvec.launches) != (n3 + 1,
                                                                    n4 + 1):
            raise RuntimeError("kron_matmul's backward did not launch B3 "
                               "and B4 once each")
        want = torch.autograd.grad(kf.kron_matmul_plain(*args), args, g)
        errs["kron_bwd_dvec"] = max(
            errs["kron_bwd_dvec"], check("kron_bwd_dvec do1", got[0],
                                         want[0], shape),
            check("kron_bwd_dvec do2", got[1], want[1], shape))
        errs["kron_bwd_dw"] = max(errs["kron_bwd_dw"], check(
            "kron_bwd_dw", got[2], want[2], shape))
        check("kron_matmul db", got[3], want[3], shape)
        print(f"train kernels {shape}: B1 / B3 / B4 agree with their plain "
              f"versions (rtol 1e-4, atol 1e-5; {card})")
    for name, err in errs.items():
        print(f"{name} max_abs_err={err:.3e} over {len(KRON_SHAPES) + 1} "
              f"shapes (rtol 1e-4, atol 1e-5; {card})")
    return errs


def _check_bwd_kernels(gen, dev, card):
    """B3 and B4 through their wrappers against their plain versions at
    ``BWD_SHAPES``, each launched twice on the same inputs, which must give
    the same bits.  Returns the max abs error of each and the launches
    these checks made."""
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    errs = {"kron_bwd_dw": 0.0, "kron_bwd_dvec": 0.0}
    n3, n4 = kf.kron_bwd_dw.launches, kf.kron_bwd_dvec.launches
    for shape in BWD_SHAPES:
        b, d1, d2, k = shape
        o1, o2, w, _ = _kron_inputs(*shape, gen, dev)
        g = torch.randn(b, k, generator=gen).to(dev)
        with torch.inference_mode():
            got = {"kron_bwd_dw": [kf.kron_bwd_dw(o1, o2, g)],
                   "kron_bwd_dvec": list(kf.kron_bwd_dvec(o1, o2, w, g))}
            again = {"kron_bwd_dw": [kf.kron_bwd_dw(o1, o2, g)],
                     "kron_bwd_dvec": list(kf.kron_bwd_dvec(o1, o2, w, g))}
            want = {"kron_bwd_dw": [kf.kron_bwd_dw_plain(o1, o2, g)],
                    "kron_bwd_dvec": list(kf.kron_bwd_dvec_plain(o1, o2, w,
                                                                 g))}
        torch.cuda.synchronize()
        for name in errs:
            for a, a2, ref in zip(got[name], again[name], want[name]):
                if not torch.equal(a, a2):
                    raise RuntimeError(f"{name} {shape}: two launches on "
                                       "the same inputs differ")
                torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-5,
                                           msg=f"{name} {shape}")
                errs[name] = max(errs[name], (a - ref).abs().max().item())
        print(f"backward kernels {shape}: B3 / B4 agree with their plain "
              "versions, bitwise equal on a second launch (rtol 1e-4, atol "
              f"1e-5; {card})")
    for name, err in errs.items():
        print(f"{name} max_abs_err={err:.3e} over {len(BWD_SHAPES)} shapes "
              f"(rtol 1e-4, atol 1e-5; {card})")
    return errs, {"kron_bwd_dw": kf.kron_bwd_dw.launches - n3,
                  "kron_bwd_dvec": kf.kron_bwd_dvec.launches - n4}


def _conv_inputs(shape, gen, dev, dtype):
    """x as the trunk holds it ([B, 64, H, W], channels-last) at unit scale
    and W at the stage's kaiming init, both in ``dtype``."""
    x = torch.randn(*shape, generator=gen).to(dev, dtype).permute(0, 3, 1, 2)
    w = (torch.randn(64, 64, 3, 3, generator=gen) * (2 / 576) ** 0.5).to(
        dev, dtype)
    return x, w


def _check_conv_kernel(gen, dev, card):
    """B5 against its plain version on the same inputs computed in fp32
    (TF32 off): bf16 at rtol 1e-2 / atol 1e-2 (about one bf16 ulp at the
    output's scale), fp32 at rtol 1e-4 / atol 1e-5; then the autograd
    function's dx (B5 on the flipped weights) and dW against autograd of
    F.conv2d in fp32.  Both the forward and the transposed form (W flipped
    and IO-swapped as it is staged: the data gradient), and a second launch
    on the same inputs, which must give the same bits.  Returns the max abs
    error per dtype."""
    from torch.nn import functional as F

    from multimodal_learning_tpu_torch.ops import paired_conv as pc
    errs = {}
    for shape in CONV_SHAPES:
        for dtype, tol in ((torch.bfloat16, dict(rtol=1e-2, atol=1e-2)),
                           (torch.float32, dict(rtol=1e-4, atol=1e-5))):
            x, w = _conv_inputs(shape, gen, dev, dtype)
            for transposed in (False, True):
                what = f"conv3x3 {shape} {dtype}" + (
                    " transposed" if transposed else "")
                with torch.inference_mode():
                    got = pc.conv3x3(x, w, transposed)
                    again = pc.conv3x3(x, w, transposed)
                    want = pc.conv3x3_plain(x.float(), w.float(), transposed)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise RuntimeError(f"{what}: two launches on the same "
                                       "inputs differ")
                got = got.float()
                err = (got - want).abs().max().item()
                torch.testing.assert_close(got, want, **tol, msg=what)
                errs[dtype] = max(errs.get(dtype, 0.0), err)
                print(f"{what} max_abs_err={err:.3e}, bitwise equal on a "
                      f"second launch (rtol {tol['rtol']}, atol "
                      f"{tol['atol']}; {card})")
    for shape in ((2, 16, 16, 64), (3, 37, 50, 64)):
        x, w = (t.requires_grad_() for t in _conv_inputs(
            shape, gen, dev, torch.float32))
        g = torch.randn(shape[0], 64, shape[1], shape[2], generator=gen).to(
            dev)
        got = torch.autograd.grad(pc.paired_conv3x3(x, w), (x, w), g)
        want = torch.autograd.grad(F.conv2d(x, w, padding=1), (x, w), g)
        torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=1e-5,
                                   msg=f"paired_conv3x3 dx {shape}")
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4,
                                   msg=f"paired_conv3x3 dW {shape}")
        print(f"paired_conv3x3 {shape} fp32: dx max_abs_err="
              f"{(got[0] - want[0]).abs().max().item():.3e}, dW "
              f"{(got[1] - want[1]).abs().max().item():.3e} ({card})")
    return errs


# The JAX benchmark's flagship train step (``bench.py:196-202``): pofusion
# teacher at the paper width, CRD + pred-KD, bf16 encoders.
TRAIN_CONFIG = dict(mode="pathomic", task="grad", path_dim=128, omic_dim=128,
                    mmhid=128, feat_dim=128, input_size_path=512,
                    batch_size=16, CRD_distill=1, pred_distill=1,
                    num_teachers=2, pos_mode="exact", nce_p=1, nce_k=512,
                    n_data=256, reg_type="omic", niter_decay=30,
                    dropout_rate=0.1, compute_dtype="bfloat16",
                    pallas_fusion="train")


def _train_opt(**kw):
    return Options(**{**TRAIN_CONFIG, **kw})


def _train_batch(opt, gen, dev):
    b, n = opt.batch_size, opt.n_data
    index = torch.randperm(n, generator=gen)[:b]
    sample_idx = torch.randint(0, n, (b, 1 + opt.nce_k), generator=gen)
    sample_idx[:, 0] = index
    batch = {"omic": torch.randn(b, opt.input_size_omic, generator=gen),
             "g": torch.randint(0, opt.label_dim, (b,), generator=gen),
             "index": index, "sample_idx": sample_idx,
             "path_views": torch.randint(
                 0, 256, (b, 2, opt.input_size_path, opt.input_size_path, 3),
                 dtype=torch.uint8, generator=gen)}
    return {k: v.to(dev) for k, v in batch.items()}


def _teacher_state(opt):
    """``init_teacher_state`` from seed 2019 on the card."""
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import init_teacher_state
    return init_teacher_state(
        opt, define_model(opt, generator=torch.Generator().manual_seed(SEED)),
        make_lr_schedule(opt, steps_per_epoch=50), opt.n_data, seed=SEED)


B1_TAG = ("B1 (kron_gemm_kernel<true + kron_reduce_kernel; the step "
          "launches no other kron kernel)", "kron_")


def _profile_steps(step_fn, card, n, top=8, label="train",
                   kernels=(("B5 (conv3x3)", "conv3x3"), B1_TAG)):
    """Kernel time per train step by name (torch.profiler, CUDA activity)
    and the device's busy share of the same steps' span (CUDA events); also
    the time and share of each kernel of ``kernels`` (a label and a tag its
    kernels' names hold).  Returns those numbers (an empty dict when the
    profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            step_fn()
        e.record()
        torch.cuda.synchronize()
    span_ms = s.elapsed_time(e) / n
    events = prof.key_averages()
    dev_ms = sum(ev.self_device_time_total for ev in events) / n / 1e3
    if dev_ms == 0:
        print(f"profile {label}: the profiler saw no device time; kernel "
              f"breakdown not measured ({card})")
        return {}
    out = {"kernel_ms": dev_ms, "span_ms": span_ms,
           "busy": dev_ms / span_ms}
    print(f"profile {label}: {dev_ms:.3f} ms of kernels per step, device "
          f"busy {100 * dev_ms / span_ms:.1f}% of the same steps' "
          f"{span_ms:.3f} ms span ({n} steps; {card})")
    for what, tag in kernels:
        ms = sum(ev.self_device_time_total for ev in events
                 if tag in ev.key) / n / 1e3
        out[tag] = ms
        out[f"{tag} count"] = sum(ev.count for ev in events
                                  if tag in ev.key) / n
        print(f"profile {label}: {what} {ms:.4f} ms per step, "
              f"{100 * ms / dev_ms:.2f}% of kernel time ({card})")
    for ev in sorted(events, key=lambda ev: -ev.self_device_time_total)[:top]:
        ms = ev.self_device_time_total / n / 1e3
        print(f"  {100 * ms / dev_ms:5.1f}% {ms:.4f} ms x{ev.count // n} "
              f"{ev.key[:90]}")
    return out


def _train_path(card, gen, dev, n_steps=20, n_warm=3, n_prof=3,
                paired=False):
    """The teacher's train path at full width through the entry points a
    user calls: ``init_teacher_state`` from seed 2019, then
    ``build_teacher_train_step`` on a device-resident batch; with
    ``paired`` under ``--paired_conv True``.  B1 must launch twice per
    step, B5 12 times per step when paired and never otherwise.  Returns
    the state, the batch, the launches in the timed steps and the step as
    a function of nothing."""
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    from multimodal_learning_tpu_torch.ops import paired_conv as pc
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step)

    opt = _train_opt(paired_conv=paired)
    state = _teacher_state(opt)
    batch = _train_batch(opt, gen, dev)
    train_step = build_teacher_train_step(opt)
    for _ in range(n_warm):
        train_step(state, batch, 0.1)
    torch.cuda.synchronize()
    counters = {"kron_matmul_dropout": kf.kron_matmul_dropout,
                "kron_matmul": kf.kron_matmul, "kron_bwd_dw": kf.kron_bwd_dw,
                "kron_bwd_dvec": kf.kron_bwd_dvec, "conv3x3": pc.conv3x3}
    for fn in counters.values():
        fn.launches = 0
    pc.paired_conv3x3.grad_copies = 0
    history = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        history.append(train_step(state, batch, 0.1)[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    label = "train path (paired_conv)" if paired else "train path"
    print(f"{label}: {n_steps} steps, launches {launches}, incoming "
          "gradients made channels-last by a copy: "
          f"{pc.paired_conv3x3.grad_copies} ({card})")
    if launches["kron_matmul_dropout"] != 2 * n_steps:
        raise RuntimeError(
            f"B1 ran {launches['kron_matmul_dropout']} times in {n_steps} "
            "steps; the student and the EMA forward launch it once each")
    if launches["conv3x3"] != (12 * n_steps if paired else 0):
        raise RuntimeError(
            f"B5 ran {launches['conv3x3']} times in {n_steps} steps with "
            f"paired_conv={paired}; a paired step launches it 12 times (4 "
            "forwards of the student, 4 of the EMA, 4 data gradients)")
    for metrics in history:
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"train metric {k} is not finite")
    print("train metrics, last step:", {k: round(float(v), 5)
                                        for k, v in history[-1].items()},
          f"({card})")
    print(f"timing {label}: {opt.batch_size * n_steps / dt:.1f} patches/s "
          f"({1e3 * dt / n_steps:.3f} ms per step of {opt.batch_size}, bf16, "
          f"512^2, 2 views, CRD nce_k {opt.nce_k}, device-resident batch; "
          f"{card})")
    def step():
        return train_step(state, batch, 0.1)

    _profile_steps(step, card, n_prof, label=label)
    syncs, where = _count_syncs(step, 3)
    print(f"{label}: {syncs:g} host synchronisations per step {where} "
          f"({card})")
    return state, batch, launches, step


def _ab_steps(card, steps, n=10):
    """Host time per train step of two variants in turns (a, b, b, a), n
    steps a window, each window ending in a synchronise: the two compared
    inside one call, as the spread between calls is larger than the
    difference."""
    (name_a, a), (name_b, b) = steps
    for fn in (a, b):
        fn()
    torch.cuda.synchronize()
    ms = {name_a: [], name_b: []}
    for name, fn in ((name_a, a), (name_b, b), (name_b, b), (name_a, a)):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        ms[name].append(1e3 * (time.perf_counter() - t0) / n)
    print("timing train step in turns (ms per step of 16, windows of "
          f"{n}): " + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                                for k, v in ms.items()) + f" ({card})")


def _train_cross_check(card, gen, dev, batch_size=4):
    """One fp32 train step on the card (kernel path, TF32 off for cuDNN and
    matmul) against the CPU (plain path), from the same state and views,
    dropout 0.  Loss parts at rtol 2e-3 / atol 5e-4.  Adam's first moment:
    outside the ResNet trunk (the fusion with B1's backward, MaxNet, the
    heads) at rtol 2e-3 with an atol of 2e-3 times each tensor's largest
    element, as ``tests/test_torch_port_step.py`` holds it.  Left out: the
    three biases that feed a train-mode BatchNorm, whose exact gradient is
    0, so that either device's is rounding noise scaled by the BatchNorm's
    1/sigma over a batch of 4 (the step test holds them at 64^2).  The
    trunk's
    convolutions and BatchNorms by the norm of the difference, at 2e-2 of
    the CPU moment's norm: at 512^2 their fp32 gradient sums long
    reductions through train-mode BatchNorms whose backward cancels most of
    each term, and it lands below a percent apart on two devices that
    agree everywhere else to 1e-4.  The CPU side runs without oneDNN,
    whose fp32 convolution backward loses more digits (that test's
    docstring)."""
    import copy

    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train import steps

    opt = _train_opt(compute_dtype="float32", dropout_rate=0.0,
                     batch_size=batch_size)
    model = define_model(opt, generator=torch.Generator().manual_seed(SEED))
    batch = _train_batch(opt, gen, "cpu")
    views = (torch.rand(batch_size, 2, opt.input_size_path,
                        opt.input_size_path, 3, generator=gen) * 2 - 1)
    augment = steps.augment_views
    steps.augment_views = lambda g, v, dtype: views.to(v.device, dtype)
    results = {}
    try:
        for where in ("cuda", "cpu"):
            state = steps.init_teacher_state(
                opt, copy.deepcopy(model), make_lr_schedule(opt, 50),
                opt.n_data, seed=SEED, device=where)
            b = {k: v.to(where) for k, v in batch.items()}
            with torch.backends.mkldnn.flags(enabled=False):
                _, metrics = steps.build_teacher_train_step(opt)(state, b,
                                                                 0.1)
            adam = state.optimizer.optimizer.state
            results[where] = (
                {k: v.cpu() for k, v in metrics.items()},
                {n: adam[p]["exp_avg"].cpu()
                 for n, p in state.model.named_parameters()})
    finally:
        steps.augment_views = augment
    (m_gpu, mu_gpu), (m_cpu, mu_cpu) = results["cuda"], results["cpu"]
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].float(), m_cpu[k].float(),
                                   rtol=2e-3, atol=5e-4, msg=k)
    print("fp32 train step card vs cpu, loss parts:", {
        k: f"{float(m_gpu[k]):.6f}/{float(m_cpu[k]):.6f}" for k in m_cpu},
          f"({card})")
    before_bn = {"fusion.encoder1.0.bias", "fusion.encoder2.0.bias",
                 "path_net.fc_new1.0.bias"}
    worst_el, worst_norm = 0.0, 0.0
    for n, want in mu_cpu.items():
        diff = mu_gpu[n] - want
        if n.startswith("path_net.") and not n.startswith(
                ("path_net.fc_new1", "path_net.fc_new2")):
            rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
            if rel > 2e-2:
                raise AssertionError(f"exp_avg {n}: |card - cpu| / |cpu| = "
                                     f"{rel:.3e} > 2e-2")
            worst_norm = max(worst_norm, rel)
            continue
        if n in before_bn:
            continue
        atol = max(1e-6, 2e-3 * want.abs().max().item())
        torch.testing.assert_close(mu_gpu[n], want, rtol=2e-3, atol=atol,
                                   msg=f"exp_avg {n}")
        worst_el = max(worst_el, (diff.abs().max()
                                  / want.abs().max()).item())
    print(f"fp32 train step card vs cpu: exp_avg of "
          f"{len(mu_cpu) - len(before_bn)} tensors agree; outside the trunk "
          f"worst max|diff| / max|cpu| = "
          f"{worst_el:.3e}, trunk worst |diff| / |cpu| = {worst_norm:.3e} "
          f"(batch {batch_size}, 512^2; {card})")


def _superpixels(gen, b, size, cells=10, n_empty=3):
    """Synthetic superpixels for phase 8 (phase 19 feeds SLIC's): [b, size,
    size] ids of a cells x cells grid whose cut lines move by up to a
    quarter cell per sample, drawn from ``gen``; ``n_empty`` cells of each
    sample take a neighbour's id, so their own ids are empty, have mean 0
    and tie in the top-k."""
    step = size / cells
    out = []
    for _ in range(b):
        cuts = [torch.searchsorted(
            torch.arange(1, cells) * step
            + (torch.rand(cells - 1, generator=gen) - 0.5) * step / 2,
            torch.arange(size) + 0.5) for _ in range(2)]
        ids = cuts[0][:, None] * cells + cuts[1][None, :]
        for cell in torch.randperm(cells * cells,
                                   generator=gen)[:n_empty].tolist():
            ids[ids == cell] = cell + 1 if cell % cells < cells - 1 \
                else cell - 1
        out.append(ids)
    return torch.stack(out)


def _saliency_pass(state, batch, card, gen, dev, n=5, n_prof=3):
    """Phase 8, the masked teacher's saliency call as the JAX step makes it
    (``train/steps.py:391-404`` of the JAX package): the ported
    ``superpixel_attention_mask`` on the full-width teacher of phase 7 in
    eval mode, its parameters frozen, with ``cost_fn`` the NLL on
    ``pred_fuse``, view 1 of the batch and synthetic superpixels
    (``num_superpixels``, ``Path_K`` and ``Omic_K`` at their defaults).
    It must launch B2 and B4 once each and B3 never (the JAX pass takes
    no weight gradient); the path mask must hold ``Path_K`` whole segments
    per sample, the omic mask at least ``Omic_K`` features, and the input
    gradients must be finite.  Times the call (CUDA events, median of
    ``n``) and, with torch.profiler, B4's share of its kernel time.
    Returns the launches of the counted call, its time, and B4's and all
    kernels' time per call from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from multimodal_learning_tpu_torch.losses import nll_loss
    from multimodal_learning_tpu_torch.masking import (
        frozen_params, saliency_grads, superpixel_attention_mask)
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    opt = _train_opt()
    model = state.model.eval()
    x_path = batch["path_views"][:, 0].to(torch.bfloat16) / 127.5 - 1.0
    x_omic = batch["omic"]
    b, size = x_path.shape[:2]
    sp = _superpixels(gen, b, size).to(dev)

    def cost_fn(xp, xo):
        return nll_loss(model(x_path=xp, x_omic=xo).pred_fuse, batch["g"])

    def call():
        return superpixel_attention_mask(cost_fn, x_path, x_omic, sp,
                                         opt.num_superpixels, opt.Path_K,
                                         opt.Omic_K)

    counters = {"kron_fwd": kf.kron_matmul, "kron_bwd_dw": kf.kron_bwd_dw,
                "kron_bwd_dvec": kf.kron_bwd_dvec}
    with frozen_params(model):
        call()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        path_mask, omic_mask = call()
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        ms = []
        for _ in range(n):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            call()
            e.record()
            torch.cuda.synchronize()
            ms.append(s.elapsed_time(e))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                call()
            torch.cuda.synchronize()
        g_path, g_omic = saliency_grads(cost_fn, x_path, x_omic)
    model.train()
    print(f"saliency pass: superpixel_attention_mask at batch {b}, {size}^2,"
          f" {opt.num_superpixels} superpixels, Path_K {opt.Path_K}, Omic_K "
          f"{opt.Omic_K}: launches {launches} ({card})")
    if launches != {"kron_fwd": 1, "kron_bwd_dw": 0, "kron_bwd_dvec": 1}:
        raise RuntimeError(f"the saliency call launched {launches}; it "
                           "launches B2 and B4 once each and B3 never")
    for s_ in range(b):
        ids = torch.unique(sp[s_][path_mask[s_] == 1])
        whole = torch.isin(sp[s_], ids).float()
        if len(ids) != opt.Path_K or not torch.equal(whole, path_mask[s_]):
            raise RuntimeError(f"sample {s_}: the path mask covers segments "
                               f"{ids.tolist()}, not {opt.Path_K} whole ones")
    if not (omic_mask.sum(1) >= opt.Omic_K).all():
        raise RuntimeError("the omic mask has fewer than Omic_K features")
    for name, grad in (("x_path", g_path), ("x_omic", g_omic)):
        if not torch.isfinite(grad).all():
            raise RuntimeError(f"the saliency gradient to {name} is not "
                               "finite")
    events = prof.key_averages()
    dev_ms = sum(ev.self_device_time_total for ev in events) / n_prof / 1e3
    b4_ms = sum(ev.self_device_time_total for ev in events
                if "kron_dvec" in ev.key) / n_prof / 1e3
    print(f"timing saliency: {np.median(ms):.4f} ms per call on the device "
          f"clock (median of {n}; min {min(ms):.4f}, max {max(ms):.4f}); "
          f"|d/dx_path| max {g_path.abs().max().item():.3e}, |d/dx_omic| max "
          f"{g_omic.abs().max().item():.3e} ({card})")
    if dev_ms == 0:
        print("profile saliency: the profiler saw no device time; B4's share "
              f"not measured ({card})")
    else:
        print(f"profile saliency: {dev_ms:.4f} ms of kernels per call, B4 "
              f"(kron_dvec_kernel + kron_dvec_reduce_kernel) {b4_ms:.5f} ms, "
              f"{100 * b4_ms / dev_ms:.3f}% of kernel time ({card})")
    return launches, float(np.median(ms)), b4_ms, dev_ms


def _saliency_cross_check(opt32, state, gen, card, batch_size=4):
    """The fp32 saliency input gradients of the serving teacher (with
    ``cut_fuse_grad`` off, so that the gradient crosses the fusion and B4)
    on the card (kernel path, TF32 off) against the CPU (plain path,
    oneDNN off), at the whole-model tolerance rtol 2e-3 / atol 5e-4, and
    by the norm of the difference at 2e-3 of the CPU gradient's norm.  The
    masks are not compared: near-ties may flip."""
    from multimodal_learning_tpu_torch.losses import nll_loss
    from multimodal_learning_tpu_torch.masking import (frozen_params,
                                                       saliency_grads)
    from multimodal_learning_tpu_torch.models import define_model
    opt = opt32.replace(cut_fuse_grad=False)
    x_path = torch.rand(batch_size, opt.input_size_path, opt.input_size_path,
                        3, generator=gen) * 2 - 1
    x_omic = torch.randn(batch_size, opt.input_size_omic, generator=gen)
    labels = torch.randint(0, opt.label_dim, (batch_size,), generator=gen)
    grads = {}
    for where in ("cuda", "cpu"):
        m = define_model(opt)
        m.load_state_dict(state)
        m = m.to(where).eval()
        y = labels.to(where)

        def cost_fn(xp, xo):
            return nll_loss(m(x_path=xp, x_omic=xo).pred_fuse, y)

        with frozen_params(m), torch.backends.mkldnn.flags(enabled=False):
            grads[where] = [t.cpu() for t in saliency_grads(
                cost_fn, x_path.to(where), x_omic.to(where))]
    for name, got, want in zip(("x_path", "x_omic"), grads["cuda"],
                               grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-3, atol=5e-4,
                                   msg=f"saliency gradient to {name}")
        rel = ((got - want).norm() / want.norm().clamp_min(1e-30)).item()
        if rel > 2e-3:
            raise AssertionError(f"saliency gradient to {name}: |card - cpu|"
                                 f" / |cpu| = {rel:.3e} > 2e-3")
        print(f"fp32 saliency gradient card vs cpu, {name}: max_abs_err="
              f"{(got - want).abs().max().item():.3e}, max |cpu| "
              f"{want.abs().max().item():.3e}, |diff| / |cpu| = {rel:.3e} "
              f"(batch {batch_size}, {opt.input_size_path}^2; {card})")


def _time_train_kernels(gen, dev, card, flush):
    """Each new kernel, its plain version and, where one PyTorch call
    computes the same function, that call, at (16, 129, 129, 128); B1 also
    against the cuBLAS GEMM ``F.linear(a, w, bias)`` of the masked
    Kronecker vector a formed outside the timed call (TF32 off); and each
    kernel's bound from the bytes it must move and the operations it must
    do.  L2-cold times are medians of 50 calls, with the 10th and 90th
    percentiles of the same calls as their spread.  Returns {name: (times,
    bound_ms, bound_by, spread)}."""
    from torch.nn import functional as F

    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    b, d1, d2, k = KRON_SHAPES[0]
    n = d1 * d2
    o1, o2, w, bias = _kron_inputs(b, d1, d2, k, gen, dev)
    maskf = ((torch.rand(b, n, generator=gen) < 0.9).float() / 0.9).to(dev)
    g = torch.randn(b, k, generator=gen).to(dev)
    a = kf._kron_vec(o1, o2) * maskf
    gemm = {"kron_train_fwd": lambda: F.linear(a, w, bias)}
    cases = {
        # name: (kernel, plain, library or None, bytes, flop)
        "kron_train_fwd": (
            lambda: kf.kron_matmul_dropout(o1, o2, w, bias, maskf),
            lambda: kf.kron_matmul_dropout_plain(o1, o2, w, bias, maskf),
            None, 4 * (b * d1 + b * d2 + b * n + k * n + k + b * k),
            2 * b * n + 2 * b * n * k),
        "kron_bwd_dw": (
            lambda: kf.kron_bwd_dw(o1, o2, g),
            lambda: kf.kron_bwd_dw_plain(o1, o2, g),
            lambda: torch.einsum("bk,bi,bj->kij", g, o1, o2),
            4 * (b * d1 + b * d2 + b * k + k * n), b * n + 2 * b * n * k),
        "kron_bwd_dvec": (
            lambda: kf.kron_bwd_dvec(o1, o2, w, g),
            lambda: kf.kron_bwd_dvec_plain(o1, o2, w, g),
            None, 4 * (2 * b * d1 + 2 * b * d2 + b * k + k * n),
            2 * b * n * k + 4 * b * n),
    }
    out = {}
    with torch.inference_mode():
        for name, (kern, plain, lib, nbytes, flops) in cases.items():
            times, spread = {}, {}
            for which, fn in (("kernel", kern), ("plain", plain),
                              ("library", lib), ("gemm", gemm.get(name))):
                if fn is None:
                    continue
                times[which, False] = _time_ms(fn, 50, False, flush)
                cold = _cold_times(fn, 50, flush)
                times[which, True] = float(np.median(cold))
                spread[which] = tuple(float(v) for v in
                                      np.percentile(cold, [10, 90]))
            t_bytes = nbytes / H100_BYTES_PER_S
            t_ops = flops / H100_FP32_FLOP_PER_S
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            for which in ("kernel", "plain", "library", "gemm"):
                if (which, True) not in times:
                    if which == "library":
                        print(f"timing {name} library_ms: none (no one "
                              "PyTorch call computes it)")
                    continue
                lo, hi = spread[which]
                print(f"timing {name} {which}_ms: L2-cold "
                      f"{times[which, True]:.5f} (p10 {lo:.5f}, p90 "
                      f"{hi:.5f}) L2-warm {times[which, False]:.5f} (B={b}, "
                      f"d1={d1}, d2={d2}, K={k}; {card})")
            print(f"timing {name} bound_ms={bound_ms:.5f} by {bound_by}: "
                  f"{nbytes} bytes at 3.35 TB/s, {flops} flop at 67 TFLOP/s "
                  f"fp32; {bound_ms / times['kernel', True]:.4f} of the "
                  f"bound L2-cold ({card})")
            gap = spread["plain"][0] - spread["kernel"][1]
            print(f"timing {name}: the plain version's p10 minus the "
                  f"kernel's p90, L2-cold: {gap:.5f} ms ({card})")
            out[name] = (times, bound_ms, bound_by, spread)
    return out


def _cv_drivers(card, n_train=64, n_test=32, epochs=2):
    """Phase 12: ``cli.train_cv_MT`` then ``cli.test_cv_MT`` as a user runs
    them, at the flagship step's flags plus ``--paired_conv True
    --synthetic_data --synthetic_folds 1``, in a temporary checkpoint
    directory.  Checks each kernel's launches against the run's steps and
    eval forwards, and that test_cv_MT reproduces the final eval exactly
    (metrics and every probability).  Returns the launches of both
    drivers together."""
    from multimodal_learning_tpu_torch.cli import test_cv_MT, train_cv_MT
    from multimodal_learning_tpu_torch.eval import load_pred_test
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    from multimodal_learning_tpu_torch.ops import paired_conv as pc

    bs = TRAIN_CONFIG["batch_size"]
    steps, forwards = epochs * (n_train // bs), -(-n_test // bs)
    counters = {"conv3x3": pc.conv3x3, "kron_train_fwd":
                kf.kron_matmul_dropout, "kron_fwd": kf.kron_matmul}
    cfg = {**TRAIN_CONFIG, "niter_decay": epochs, "paired_conv": True,
           "synthetic_data": True, "synthetic_folds": 1,
           "model_name": "smoke_cv"}
    total = dict.fromkeys(counters, 0)

    def run(main, flags, want, what):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = main(flags)
        torch.cuda.synchronize()
        got = {name: fn.launches for name, fn in counters.items()}
        print(f"cv drivers: {what} in {time.perf_counter() - t0:.2f} s, "
              f"launches {got} ({card})")
        if got != want:
            raise RuntimeError(f"{what} launched {got}, expected {want}")
        for name in total:
            total[name] += got[name]
        return out

    with tempfile.TemporaryDirectory() as root:
        flags = [a for k, v in cfg.items() for a in (f"--{k}", str(v))]
        flags += ["--checkpoints_dir", root]
        res = run(train_cv_MT.main, flags,
                  {"conv3x3": 12 * steps + 4 * epochs * forwards,
                   "kron_train_fwd": 2 * steps,
                   "kron_fwd": epochs * forwards},
                  f"train_cv_MT ({steps} steps, {epochs} evals of {n_test} "
                  "ROIs)")[1]
        ckpt_dir = os.path.join(root, "grad_15", cfg["model_name"])
        with open(os.path.join(ckpt_dir, "metrics.jsonl")) as fh:
            for line in fh:
                rec = json.loads(line)
                print(f"cv drivers: epoch {rec['epoch']} train "
                      f"{rec['samples_per_s']:.1f} patches/s through the "
                      f"loader and prefetcher, loss {rec['train_loss']:.5f}"
                      f" ({card})")
        tested = run(test_cv_MT.main, flags,
                     {"conv3x3": 4 * forwards, "kron_train_fwd": 0,
                      "kron_fwd": forwards}, "test_cv_MT")
        dumped = load_pred_test(os.path.join(
            ckpt_dir, f"{cfg['model_name']}_1_pred_test.pkl"))
    for name in ("fuse", "path", "omic"):
        if tested[name] != [res[f"metrics_{name}"]]:
            raise RuntimeError(f"test_cv_MT's {name} metrics "
                               f"{tested[name]} differ from the training-"
                               f"time final eval {res[f'metrics_{name}']}")
        if not np.array_equal(dumped["probs"][name], res["probs"][name]):
            raise RuntimeError(f"test_cv_MT's {name} probabilities differ "
                               "from the training-time final eval")
        if not np.isfinite(res["probs"][name]).all():
            raise RuntimeError(f"{name} probabilities are not finite")
    print("cv drivers: test_cv_MT reproduces the final eval exactly; AUC/AP/"
          "F1/F1-IV", {k: [round(float(v), 5) for v in res[f"metrics_{k}"]]
                       for k in ("fuse", "path", "omic")}, f"({card})")
    return total


# The MIA-2022 flow (``recipes/baseline.py``): the MICCAI student
# (``miccai_student``) distilled from a frozen pofusion teacher, and the
# M3LR t-SVD teacher (``tsvd_teacher``), at the paper width; the banks hold
# 256 rows (the cut ``n_data=256``).
STUDENT_CONFIG = _recipe("miccai_student", n_data=256)
TSVD_CONFIG = _recipe("tsvd_teacher", n_data=256)
DSCD_FLAGS = _recipe("dscd_student")
# the flags of phase 17's and 27's CLI chains: one synthetic fold, paired
MIA_CHAIN = dict(PAPER, paired_conv=True, synthetic_data=True,
                 synthetic_folds=1)


def _counters():
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    from multimodal_learning_tpu_torch.ops import paired_conv as pc
    return {"kron_train_fwd": kf.kron_matmul_dropout,
            "kron_fwd": kf.kron_matmul, "kron_bwd_dw": kf.kron_bwd_dw,
            "kron_bwd_dvec": kf.kron_bwd_dvec, "conv3x3": pc.conv3x3}


def _windows(step_fn, n_windows, per_window):
    """Host ms per step of ``n_windows`` windows of ``per_window`` steps,
    each ending in a synchronise; returns (median, all, the steps'
    metrics)."""
    ms, history = [], []
    for _ in range(n_windows):
        t0 = time.perf_counter()
        for _ in range(per_window):
            history.append(step_fn()[1])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0) / per_window)
    return sorted(ms)[len(ms) // 2], ms, history


def _count_syncs(step_fn, n):
    """Host synchronisations per step, as torch.cuda's sync debug mode
    reports them (one warning each, attributed to the Python line that
    called the op); fails if one comes from the augmentation.  Returns
    (syncs per step, {"file:line": count})."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(n):
                step_fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    where = {}
    for w in rec:
        if "called a synchronizing CUDA operation" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            where[key] = where.get(key, 0) + 1
    augment = [k for k in where if "data/augment.py" in k]
    if augment:
        raise RuntimeError("the augmentation synchronises the host: "
                           f"{augment}; its constants stay on the device")
    return sum(where.values()) / n, where


def _student_batch(opt, gen, dev):
    b, n = opt.batch_size, opt.n_data
    index = torch.randperm(n, generator=gen)[:b]
    sample_idx = torch.randint(0, n, (b, opt.nce_p + opt.nce_k),
                               generator=gen)
    sample_idx[:, 0] = index
    batch = {"omic": torch.randn(b, opt.input_size_omic, generator=gen),
             "g": torch.randint(0, opt.label_dim, (b,), generator=gen),
             "index": index, "sample_idx": sample_idx,
             "path_views": torch.randint(
                 0, 256, (b, 2, opt.input_size_path, opt.input_size_path, 3),
                 dtype=torch.uint8, generator=gen)}
    return {k: v.to(dev) for k, v in batch.items()}


def _step_window(card, label, state, fn, per_step, n_warm=2, n_windows=1,
                 per_window=5, n_prof=3, kernels=(
                     ("B1 (kron_gemm_kernel + kron_reduce_kernel)",
                      "kron_"),)):
    """``n_windows`` windows of ``per_window`` steps of ``fn`` after
    ``n_warm``: host ms per step (the median window); the launches, which
    must be ``per_step`` times the steps (absent kernels: 0); finite
    metrics and, after the last window, finite gradients of every
    parameter that has one; then a profiled window (kernel ms, busy share,
    each of ``kernels``' share) and the host synchronisations per step.
    Returns those numbers and the windows' metrics."""
    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    host_ms, windows, history = _windows(fn, n_windows, per_window)
    launches = {name: c.launches for name, c in counters.items()}
    n = n_windows * per_window
    want = {name: n * per_step.get(name, 0) for name in counters}
    print(f"{label}: {n} steps, launches {launches} ({card})")
    if launches != want:
        raise RuntimeError(f"{label} launched {launches}, expected {want}")
    for metrics in history:
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"{label}: metric {k} is not finite")
    named = [*state.model.named_parameters(),
             *state.embeds.named_parameters()]
    if not any(p.grad is not None for _, p in named):
        raise RuntimeError(f"{label}: no parameter has a gradient")
    bad = [n for n, p in named
           if p.grad is not None and not torch.isfinite(p.grad).all()]
    if bad:
        raise RuntimeError(f"{label}: gradients not finite: {bad}")
    print(f"{label} metrics, last step:", {
        k: [round(x, 5) for x in v.flatten().tolist()] if v.numel() > 1
        else round(float(v), 5) for k, v in history[-1].items()},
          f"({card})")
    print(f"timing {label}: host {host_ms:.3f} ms per step of 16 (median of "
          f"{n_windows} windows of {per_window}: "
          f"{', '.join(f'{w:.3f}' for w in windows)}), bf16, 512^2, "
          f"device-resident batch ({card})")
    prof = _profile_steps(fn, card, n_prof, label=label, kernels=kernels)
    syncs, where = _count_syncs(fn, 3)
    print(f"{label}: {syncs:g} host synchronisations per step {where} "
          f"({card})")
    return {"host_ms": host_ms, "launches": launches, "syncs": syncs,
            "where": where, "history": history, **prof}


def _frozen_student(opt, teacher_sd, dev):
    """The student's set-up through the entry points a user calls:
    ``freeze_teacher`` on a teacher with ``teacher_sd``,
    ``init_student_state`` from seed 2019 and ``build_student_train_step``.
    Returns the state, the step and the frozen teacher."""
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train import student

    teacher = define_model(opt, generator=torch.Generator())
    teacher.load_state_dict(teacher_sd)
    teacher = student.freeze_teacher(teacher, dev)
    state = student.init_student_state(
        opt, define_model(opt, path_only=True,
                          generator=torch.Generator().manual_seed(SEED)),
        make_lr_schedule(opt, steps_per_epoch=50), opt.n_data, seed=SEED)
    return state, student.build_student_train_step(opt, teacher), teacher


def _student_path(card, gen, dev, teacher_sd, teacher_bn="batch",
                  paired=False):
    """Phase 14: the MICCAI student's step at full width on phase 7's
    trained teacher (:func:`_frozen_student`), on a device-resident batch:
    4 windows of 5 steps.  Per step: B1 once with ``--teacher_bn batch``,
    B2 once with ``running``, B3 and B4 never, B5 16 times with
    ``--paired_conv`` (4 forwards each of the student, the EMA and the
    teacher, 4 data gradients of the student) and never otherwise; finite
    losses, AEKD scale and gradients; the teacher's buffers bitwise
    unchanged."""

    opt = Options(**STUDENT_CONFIG, teacher_bn=teacher_bn,
                  paired_conv=paired)
    state, step, teacher = _frozen_student(opt, teacher_sd, dev)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    batch = _student_batch(opt, gen, dev)
    label = (f"student step (teacher_bn {teacher_bn}"
             + (", paired_conv)" if paired else ")"))
    kron = "B1" if teacher_bn == "batch" else "B2"
    r = _step_window(
        card, label, state, lambda: step(state, batch, 0.1),
        {"kron_train_fwd" if teacher_bn == "batch" else "kron_fwd": 1,
         "conv3x3": 16 if paired else 0}, n_warm=3, n_windows=4,
        kernels=(("B5 (conv3x3)", "conv3x3"),
                 (f"{kron} (kron_gemm_kernel + kron_reduce_kernel)",
                  "kron_")))
    for k, v in teacher.state_dict().items():
        if not torch.equal(v, before[k]):
            raise RuntimeError(f"{label}: the frozen teacher's {k} changed")
    return r


def _tsvd_path(card, gen, dev):
    """Phase 15: the M3LR t-SVD teacher's step at full width
    (``tsvd_teacher``: n_views 4, Lambda_global 0.1, mu 1e-5, pho 1.1,
    max_mu 1, aux_iter 1) through ``init_teacher_state`` and
    ``build_teacher_train_step``, the refresh flag a host bool per step as
    the fold loop computes it: 4 windows of 5 steps.  B1 twice per step,
    the others never; ``loss_tsvd`` and both TNNs finite; mu grown by pho
    per refresh."""
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step)

    opt = Options(**TSVD_CONFIG)
    state = _teacher_state(opt)
    batch = _train_batch(opt, gen, dev)
    step = build_teacher_train_step(opt)
    done = {"steps": 0, "refreshes": 0}

    def fn():
        refresh = done["steps"] % opt.aux_iter == 0
        done["steps"] += 1
        done["refreshes"] += int(refresh)
        return step(state, batch, 0.1, tsvd_update=refresh)

    r = _step_window(card, "t-SVD teacher step", state, fn,
                     {"kron_train_fwd": 2}, n_warm=3, n_windows=4)
    mu = float(state.banks["tsvd"].mu)
    want_mu = min(opt.mu * opt.pho ** done["refreshes"], opt.max_mu)
    if abs(mu - want_mu) > 1e-5 * want_mu:
        raise RuntimeError(f"mu is {mu} after {done['refreshes']} refreshes;"
                           f" expected {want_mu}")
    print(f"t-SVD teacher step: mu {mu:.6e} after {done['refreshes']} "
          f"refreshes ({card})")
    return r


@contextlib.contextmanager
def _shared_crd_ranking(label, card):
    """CRD's positive and negative selections (``contrast.crd.
    crd_scores_select``) rank each bank row by its cosine with the query
    (``crd._cos_rel``, taking no gradient).  Two orders of summation may
    order a near tie the other way, and the loss then jumps by a swapped
    pair, which no tolerance on a continuous function covers.  Within the
    block every run after the first ranks by the first run's cosines; each
    run calls the yielded function before it starts.  On leaving, each
    run's own cosines are held to the first's at phase 9's tolerances
    (rtol 2e-3 / atol 5e-4), so the ranking stays checked, and the steps
    compared downstream took the same discrete decisions."""
    from multimodal_learning_tpu_torch.contrast import crd
    own, runs = crd._cos_rel, []

    def cos_rel(w, v):
        rel = own(w, v)
        runs[-1].append(rel)
        if len(runs) == 1:
            return rel
        if len(runs[-1]) > len(runs[0]):
            raise AssertionError(f"{label}: more CRD rankings than the "
                                 "first run's")
        return runs[0][len(runs[-1]) - 1].to(rel.device)

    crd._cos_rel = cos_rel
    try:
        yield lambda: runs.append([])
    finally:
        crd._cos_rel = own
    worst = 0.0
    for mine in runs[1:]:
        if len(mine) != len(runs[0]):
            raise AssertionError(f"{label}: {len(mine)} CRD rankings against "
                                 f"the first run's {len(runs[0])}")
        for i, (want, got) in enumerate(zip(runs[0], mine)):
            want, got = want.float().cpu(), got.float().cpu()
            torch.testing.assert_close(got, want, rtol=2e-3, atol=5e-4,
                                       msg=f"{label}: CRD cosines {i}")
            worst = max(worst, (got - want).abs().max().item())
    if runs and runs[0]:
        print(f"{label}: {len(runs[0])} CRD rankings by the first run's "
              f"cosines; each run's own within max|diff| {worst:.3e} of "
              f"them ({card})")


def _student_cross_check(card, gen, teacher_sd, batch_size=4, **flags):
    """Phase 16 (and 26, with ``flags``): one fp32 student step (the phase
    14 flags, dropout 0) on the card (kernel path, TF32 off) against the
    CPU (plain path, oneDNN off), from the same state, views and, for CRD,
    ``mid`` ranks, the CPU ranking CRD's pairs by the card's cosines
    (:func:`_shared_crd_ranking`), at phase 9's tolerances: the loss
    parts, the AEKD scale and the banks (CRD's with their Z, HKD's) at
    rtol 2e-3 / atol 5e-4;
    Adam's first moment of the heads (the CRD or HKD embeds and encoders,
    ``fc_new1`` but its bias, which feeds a train-mode BatchNorm,
    ``fc_new2``) at rtol 2e-3 and an atol of 2e-3 of each tensor's largest
    element, the trunk's by the norm of the difference at 2e-2.  Under
    ``--distill hkd`` the kNN adjacencies the two steps build must be
    equal."""
    import copy
    import dataclasses

    from multimodal_learning_tpu_torch.contrast import draw_pick
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train import student

    opt = Options(**{**STUDENT_CONFIG, **flags, "compute_dtype": "float32",
                     "dropout_rate": 0.0, "batch_size": batch_size})
    label = f"fp32 {opt.distill} student step card vs cpu"
    model = define_model(opt, path_only=True,
                         generator=torch.Generator().manual_seed(SEED))
    teacher = define_model(opt, generator=torch.Generator())
    teacher.load_state_dict(teacher_sd)
    batch = _zoo_batch(opt, gen, "cpu")
    views = (torch.rand(batch_size, 2, opt.input_size_path,
                        opt.input_size_path, 3, generator=gen) * 2 - 1)
    picks = ({name: draw_pick("mid", opt.nce_p, opt.nce_p2, gen)
              for name in ("fuse", "ema")} if opt.distill == "crd" else {})
    augment, knn = student.augment_views, student.knn_adjacency
    graphs = []

    def recorded_knn(logits):
        graphs.append(knn(logits))
        return graphs[-1]

    student.augment_views = lambda g, v, dtype: views.to(v.device, dtype)
    student.knn_adjacency = recorded_knn
    results = {}
    try:
        with _shared_crd_ranking(label, card) as next_run:
            for where in ("cuda", "cpu"):
                next_run()
                state = student.init_student_state(
                    opt, copy.deepcopy(model), make_lr_schedule(opt, 50),
                    opt.n_data, seed=SEED, device=where)
                step = student.build_student_train_step(
                    opt, student.freeze_teacher(copy.deepcopy(teacher),
                                                where))
                with torch.backends.mkldnn.flags(enabled=False):
                    _, metrics = step(state, {k: v.to(where)
                                              for k, v in batch.items()}, 0.1,
                                      picks={k: v.to(where)
                                             for k, v in picks.items()})
                adam = state.optimizer.optimizer.state
                named = {f"model.{n}": p for n, p in
                         state.model.named_parameters()}
                named.update({f"{side}.{n}": p for side, emb in
                              state.embeds.items()
                              for n, p in emb.named_parameters()})
                results[where] = (
                    {k: v.cpu() for k, v in metrics.items()},
                    {n: adam[p]["exp_avg"].cpu() for n, p in named.items()},
                    {f"{name}.{k}": v.cpu()
                     for name, bank in state.banks.items()
                     for k, v in dataclasses.asdict(bank).items()})
    finally:
        student.augment_views, student.knn_adjacency = augment, knn
    (m_gpu, mu_gpu, b_gpu), (m_cpu, mu_cpu, b_cpu) = (results["cuda"],
                                                      results["cpu"])
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].float(), m_cpu[k].float(),
                                   rtol=2e-3, atol=5e-4, msg=k)
    for k in b_cpu:
        torch.testing.assert_close(b_gpu[k], b_cpu[k], rtol=2e-3, atol=5e-4,
                                   msg=f"bank {k}")
    if opt.distill == "hkd":
        # the student's graph and the teacher's, on each device
        gpu, cpu = graphs[:2], graphs[2:]
        if len(cpu) != 2 or any(not torch.equal(a.cpu(), b)
                                for a, b in zip(gpu, cpu)):
            raise AssertionError(f"{label}: the kNN adjacencies differ")
        print(f"{label}: both kNN adjacencies equal, "
              f"{[int(a.sum()) for a in cpu]} edges on {batch_size} nodes "
              f"({card})")
    worst_el, worst_norm = 0.0, 0.0
    for n, want in mu_cpu.items():
        diff = mu_gpu[n] - want
        if n.startswith("model.") and "fc_new" not in n:
            rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
            if rel > 2e-2:
                raise AssertionError(f"student exp_avg {n}: |card - cpu| / "
                                     f"|cpu| = {rel:.3e} > 2e-2")
            worst_norm = max(worst_norm, rel)
            continue
        if n == "model.fc_new1.0.bias":
            continue
        atol = max(1e-6, 2e-3 * want.abs().max().item())
        torch.testing.assert_close(mu_gpu[n], want, rtol=2e-3, atol=atol,
                                   msg=f"student exp_avg {n}")
        worst_el = max(worst_el, (diff.abs().max()
                                  / want.abs().max().clamp_min(1e-30)).item())
    print(f"{label}, loss parts:", {
        k: f"{float(m_gpu[k]):.6f}/{float(m_cpu[k]):.6f}" for k in m_cpu
        if m_cpu[k].numel() == 1}, "scale", m_gpu["scale"].tolist(), "/",
          m_cpu["scale"].tolist(), f"({card})")
    print(f"{label}: banks agree; exp_avg heads worst max|diff| / max|cpu| "
          f"= {worst_el:.3e}, trunk worst |diff| / |cpu| = "
          f"{worst_norm:.3e} (batch {batch_size}, 512^2; {card})")


def _run_cli(main, cfg, root, want, what, card):
    """One CLI driver on ``cfg`` (flags as a dict) under ``root``; its
    launches must equal ``want`` (absent kernels: 0).  Returns its result
    and its launches."""
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    flags = [a for k, v in cfg.items() for a in (f"--{k}", str(v))]
    t0 = time.perf_counter()
    res = main(flags + ["--checkpoints_dir", root])
    torch.cuda.synchronize()
    got = {name: c.launches for name, c in counters.items()}
    print(f"{what} in {time.perf_counter() - t0:.2f} s, launches {got} "
          f"({card})")
    want = {name: want.get(name, 0) for name in counters}
    if got != want:
        raise RuntimeError(f"{what} launched {got}, expected {want}")
    return res, got


def _student_chain(card, root, flags, label, steps, fwd):
    """``cli.train_cv_path_multi_MT`` on ``flags`` (1 epoch, so that the
    best checkpoint is the final one) and ``cli.test_cv_path``, which must
    reproduce the student's final eval exactly.  Returns each driver's
    launches."""
    from multimodal_learning_tpu_torch.cli import (test_cv_path,
                                                   train_cv_path_multi_MT)
    from multimodal_learning_tpu_torch.eval import load_pred_test
    from multimodal_learning_tpu_torch.eval.metrics import (
        extended_grading_metrics, one_hot)

    name = flags["model_name"]
    res, train_launches = _run_cli(
        train_cv_path_multi_MT.main, flags, root,
        {"conv3x3": 16 * steps + 4 * fwd, "kron_train_fwd": steps},
        f"{label}: train_cv_path_multi_MT ({steps} steps, 1 eval of "
        f"{fwd} batches)", card)
    final = res[1]
    ext, test_launches = _run_cli(test_cv_path.main, flags, root,
                                  {"conv3x3": 4 * fwd},
                                  f"{label}: test_cv_path", card)
    ckpt_dir = os.path.join(root, "grad_15", name)
    with open(os.path.join(ckpt_dir, "metrics.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            print(f"{label}: student epoch {rec['epoch']:g} "
                  f"{rec['samples_per_s']:.1f} patches/s through the loader "
                  f"and prefetcher, loss {rec['train_loss']:.5f} ({card})")
    dumped = load_pred_test(os.path.join(ckpt_dir, f"{name}_1_pred_test.pkl"))
    if not np.array_equal(dumped["probs"]["path"], final["probs"]["path"]):
        raise RuntimeError(f"{label}: test_cv_path's probabilities differ "
                           "from the student's training-time final eval")
    if not np.isfinite(final["probs"]["path"]).all():
        raise RuntimeError(f"{label}: the student's probabilities are not "
                           "finite")
    want = extended_grading_metrics(one_hot(final["gt"], 3),
                                    final["probs"]["path"])
    if ext != [want]:
        raise RuntimeError(f"{label}: test_cv_path's metrics {ext} differ "
                           f"from the final eval's {want}")
    print(f"{label}: test_cv_path reproduces the student's final eval "
          "exactly;", {k: round(v, 5) for k, v in want.items()}, f"({card})")
    return {"train_cv_path_multi_MT": train_launches,
            "test_cv_path": test_launches}


def _mia_chain(card, root, n_train=64, n_test=32, teacher_epochs=2):
    """Phase 17: the MIA-2022 chain through the CLIs as a user runs them,
    on one synthetic fold at full width with ``--paired_conv True``, under
    ``root``: ``cli.train_cv_MT --tSVD_loss True`` (the ``tsvd_teacher``
    flags, 2 epochs), ``cli.train_cv_path_multi_MT`` (the ``dscd_student``
    flags, ``--fixed_model`` that teacher, 1 epoch) and ``cli.test_cv_path``
    (:func:`_student_chain`).  Launches are checked per step and per eval
    forward.  Returns each driver's launches."""
    from multimodal_learning_tpu_torch.cli import train_cv_MT

    bs = PAPER["batch_size"]
    steps, fwd = n_train // bs, -(-n_test // bs)
    teacher = {**TSVD_CONFIG, **MIA_CHAIN, "niter_decay": teacher_epochs,
               "model_name": "smoke_m3lr"}
    teacher.pop("n_data")
    e = teacher_epochs
    _, out = _run_cli(
        train_cv_MT.main, teacher, root,
        {"conv3x3": 12 * e * steps + 4 * e * fwd,
         "kron_train_fwd": 2 * e * steps, "kron_fwd": e * fwd},
        f"MIA-2022 chain: train_cv_MT --tSVD_loss True ({e * steps} steps, "
        f"{e} evals of {n_test} ROIs)", card)
    return {"train_cv_MT": out, **_student_chain(
        card, root, {**MIA_CHAIN, **DSCD_FLAGS, "niter_decay": 1,
                     "fixed_model": "smoke_m3lr",
                     "model_name": "smoke_dscd"},
        "MIA-2022 chain", steps, fwd)}


# The distiller-zoo baselines and HKD of the MIA-2022 students (ROADMAP
# A15), each in place of CRD on the ``miccai_student`` flags of phase 14.
ZOO_MODES = ("feats_KL", "rkd", "pkt", "hint", "correlation", "hkd")


def _zoo_batch(opt, gen, dev):
    """Phase 14's batch; under ``--distill hkd`` its ``sample_idx`` holds
    ``nce_k`` negatives only, as the HKD loader draws them."""
    batch = _student_batch(opt, gen, dev)
    if opt.distill == "hkd":
        batch["sample_idx"] = torch.randint(
            0, opt.n_data, (opt.batch_size, opt.nce_k), generator=gen).to(dev)
    return batch


def _zoo_paths(card, gen, dev, teacher_sd):
    """Phase 23: the student's step of each distiller-zoo mode and of HKD
    (``--distill feats_KL|rkd|pkt|hint|correlation|hkd`` on the phase 14
    flags), on phase 7's teacher: one window of 5 steps each, B1 once per
    step (the frozen teacher) and no other kernel, 0 host syncs.  HKD's
    first step must move the bank's batch rows, to norm 1, and no other
    row."""

    out = {}
    for mode in ZOO_MODES:
        opt = Options(**{**STUDENT_CONFIG, "distill": mode})
        state, step, _ = _frozen_student(opt, teacher_sd, dev)
        batch = _zoo_batch(opt, gen, dev)

        def fn():
            return step(state, batch, 0.1)

        if mode == "hkd":
            bank = state.banks["hkd"]
            before = [bank.memory_l.clone(), bank.memory_ab.clone()]
            fn()
            rows = torch.zeros(opt.n_data, dtype=torch.bool, device=dev)
            rows[batch["index"]] = True
            for old, new in zip(before, (bank.memory_l, bank.memory_ab)):
                norms = new[rows].norm(dim=1)
                if (not torch.equal(old[~rows], new[~rows])
                        or (old[rows] == new[rows]).all(dim=1).any()
                        or (norms - 1).abs().max() > 1e-5):
                    raise RuntimeError("HKD bank: a batch row did not move "
                                       "to norm 1, or another row moved")
            print(f"HKD bank: the {int(rows.sum())} batch rows of both "
                  f"sides moved to norm 1 (max |norm - 1| "
                  f"{float((norms - 1).abs().max()):.2e}), the other "
                  f"{int((~rows).sum())} rows bitwise unchanged ({card})")
        r = _step_window(card, f"{mode} student step", state, fn,
                         {"kron_train_fwd": 1})
        if r["syncs"] != 0:
            raise RuntimeError(f"the {mode} student step synchronises the "
                               f"host: {r['where']}")
        out[mode] = r
        del state, step
    return out


def _svm_path(card, gen, dev, teacher_sd):
    """Phase 24: the student's step under ``--loss_weighting SVM
    --svm_norm True`` (CRD from two teachers, AEKD inputs with the CE
    gradient: five losses), on phase 7's teacher: one window of 5 steps, B1
    once per step, exactly one host sync per step, in
    ``gradweight/svm.py`` (the gradients' copy to the host), finite weights
    summing to 1; and the host solve's time on such a stack."""
    from multimodal_learning_tpu_torch.gradweight import find_optimal_svm

    opt = Options(**{**STUDENT_CONFIG, "loss_weighting": "SVM",
                     "svm_norm": True})
    state, step, _ = _frozen_student(opt, teacher_sd, dev)
    batch = _student_batch(opt, gen, dev)
    r = _step_window(card, "SVM-weighted student step", state,
                     lambda: step(state, batch, 0.1),
                     {"kron_train_fwd": 1})
    if r["syncs"] != 1 or not all("gradweight/svm.py" in k
                                  for k in r["where"]):
        raise RuntimeError("the SVM-weighted step must synchronise once, in "
                           f"gradweight/svm.py: {r['where']}")
    for metrics in r["history"]:
        scale = metrics["scale"].double()
        if abs(float(scale.sum()) - 1.0) > 1e-5 or (scale < 0).any():
            raise RuntimeError(f"SVM weights {scale.tolist()} do not sum "
                               "to 1")
    stack = torch.randn(5, opt.batch_size, opt.path_dim, generator=gen)
    find_optimal_svm(stack.numpy(), nu=0.5, is_norm=True)
    t0 = time.perf_counter()
    for _ in range(20):
        find_optimal_svm(stack.numpy(), nu=0.5, is_norm=True)
    r["solve_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    print(f"timing SVM solve on the host: {r['solve_ms']:.3f} ms per "
          f"[5, {opt.batch_size}, {opt.path_dim}] stack (243 active sets; "
          f"{card})")
    return r


def _supcon_path(card, gen, dev):
    """Phase 25: the flagship teacher step of phase 7 with
    ``--supcon_distill 1``: one window of 5 steps, B1 twice per step, 0
    host syncs, ``loss_supcon`` finite and positive."""
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step)

    opt = _train_opt(supcon_distill=1)
    state = _teacher_state(opt)
    batch = _train_batch(opt, gen, dev)
    step = build_teacher_train_step(opt)
    r = _step_window(card, "SupCon teacher step", state,
                     lambda: step(state, batch, 0.1), {"kron_train_fwd": 2})
    if r["syncs"] != 0:
        raise RuntimeError(f"the SupCon teacher step synchronises the host: "
                           f"{r['where']}")
    if not all(float(m["loss_supcon"]) > 0 for m in r["history"]):
        raise RuntimeError("loss_supcon is not positive")
    return r


def _hkd_chain(card, root, n_train=64, n_test=32):
    """Phase 27: ``cli.train_cv_path_multi_MT --distill hkd`` (the
    ``dscd_student`` flags but for the mode, 1 epoch) on phase 17's teacher
    under ``root``, then ``cli.test_cv_path``, which must reproduce the
    student's final eval exactly (:func:`_student_chain`)."""
    bs = PAPER["batch_size"]
    return _student_chain(
        card, root, {**MIA_CHAIN, **DSCD_FLAGS, "distill": "hkd",
                     "niter_decay": 1, "fixed_model": "smoke_m3lr",
                     "model_name": "smoke_hkd"},
        "HKD chain", n_train // bs, -(-n_test // bs))


# The MIA-2023 CLAT flow (``recipes/baseline.py``): the superpixel-masked
# stage-1 teacher (``clat_stage1``) and the stage-2 adaptive-teaching
# student (``clat_stage2``), at the paper width.  The student's banks hold
# 8192 rows, more than nce_k + 1 = 4097, so that no negative is cut.
CLAT1_CONFIG = _recipe("clat_stage1", n_data=256)
CLAT2_FLAGS = _recipe("clat_stage2")
CLAT2_CONFIG = dict(CLAT2_FLAGS, n_data=8192)
# the kernels of a masked step, by a tag their profiler names hold
MASKED_TAGS = (("B1 main pass (kron_gemm_kernel<true>)", "kron_gemm_kernel<true"),
               ("B2 main pass (kron_gemm_kernel<false>)",
                "kron_gemm_kernel<false"),
               ("B1 and B2 reduction passes (kron_reduce_kernel)",
                "kron_reduce"),
               ("B4 (kron_dvec_kernel + kron_dvec_reduce_kernel)",
                "kron_dvec"),
               ("B5 (conv3x3)", "conv3x3"))


def _slic_rois(gen, n, size):
    """Synthetic ROIs with structure for SLIC to follow: a smooth random
    field (a 16 x 16 random image upsampled bilinearly) plus pixel noise,
    uint8 [n, size, size, 3]."""
    from torch.nn import functional as F
    low = torch.rand(n, 3, 16, 16, generator=gen)
    img = F.interpolate(low, size=(size, size), mode="bilinear",
                        align_corners=False) * 200 + 28
    img = img + torch.randn(n, 3, size, size, generator=gen) * 10
    return img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous(
        ).numpy()


def _slic_phase(card, gen, n=16, size=512, n_sp=100):
    """Phase 18: SLIC on the card's machine, through ``masking.slic``: the
    native build from ``native/slic/slic.cpp`` (g++, into ``build/native``)
    and its time, labels valid in [0, ``n_sp``) on ``n`` synthetic ROIs of
    ``size``^2, and the host ms per ROI.  Returns the ROIs, their labels
    and the numbers."""
    from multimodal_learning_tpu_torch.masking import slic
    path = slic.library_path()
    existed = os.path.exists(path)
    t0 = time.perf_counter()
    slic.load_library()
    build_s = time.perf_counter() - t0
    print(f"SLIC: {'found' if existed else 'built'} "
          f"{os.path.relpath(path)} in {build_s:.2f} s (g++ -O3 -fopenmp; "
          f"{card})")
    rois = _slic_rois(gen, n, size)
    slic.slic_segment(rois[0], n_sp)
    ms, labels = [], []
    for roi in rois:
        t0 = time.perf_counter()
        labels.append(slic.slic_segment(roi, n_sp))
        ms.append(1e3 * (time.perf_counter() - t0))
    labels = np.stack(labels)
    if labels.dtype != np.int32 or labels.shape != (n, size, size):
        raise RuntimeError(f"SLIC labels {labels.dtype} {labels.shape}")
    if labels.min() < 0 or labels.max() >= n_sp:
        raise RuntimeError(f"SLIC labels outside [0, {n_sp}): "
                           f"[{labels.min()}, {labels.max()}]")
    distinct = [len(np.unique(lab)) for lab in labels]
    print(f"SLIC: {n} ROIs of {size}^2, {n_sp} superpixels: labels in "
          f"[{labels.min()}, {labels.max()}], {min(distinct)}-"
          f"{max(distinct)} distinct per ROI; host {np.median(ms):.3f} ms "
          f"per ROI (median of {n}; min {min(ms):.3f}, max {max(ms):.3f}; "
          f"{os.cpu_count()} host cores; {card})")
    return rois, labels, {"build_s": build_s, "ms": float(np.median(ms))}


def _masked_batch(opt, gen, dev, rois, labels):
    """A device-resident masked-step batch: each ROI as its 4 views (the
    loader's 4 crops of a ROI as large as the crop) and its SLIC map."""
    b = opt.batch_size
    index = torch.randperm(opt.n_data, generator=gen)[:b]
    views = torch.from_numpy(rois[:b])[:, None].expand(
        -1, 4, -1, -1, -1).contiguous()
    batch = {"omic": torch.randn(b, opt.input_size_omic, generator=gen),
             "g": torch.randint(0, opt.label_dim, (b,), generator=gen),
             "index": index, "path_views": views,
             "sp_mask": torch.from_numpy(labels[:b])}
    return {k: v.to(dev) for k, v in batch.items()}


def _masked_path(card, gen, dev, rois, labels, masking_bn="chain",
                 paired=False, n_windows=4, per_window=5, n_warm=3,
                 n_prof=3):
    """Phase 19: the masked CLAT teacher's step at full width
    (``clat_stage1`` as published, bf16, 512^2, batch 16) through
    ``init_teacher_state`` and ``build_teacher_train_step(masking=True)``
    on phase 18's ROIs and SLIC labels.  Per step: B1 6 times (the
    student's main, masked-path and masked-omic forwards, the EMA's and
    its two masked forwards), B2 and B4 once (the saliency pass), B3
    never, B5 36 times with ``--paired_conv`` (forwards: 4 saliency, 4
    EMA, 4 student, 4 masked student, 8 EMA masked; data gradients: 4
    saliency, 4 student, 4 masked student; the masked-omic forward reuses
    the trunk) and never otherwise.  Host ms per step (median of windows),
    kernel ms, busy share, B1's, B2's, B4's and B5's shares, host syncs.
    Returns those and the state."""
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step)

    opt = Options(**CLAT1_CONFIG, masking_bn=masking_bn, paired_conv=paired)
    state = _teacher_state(opt)
    batch = _masked_batch(opt, gen, dev, rois, labels)
    step = build_teacher_train_step(opt, masking=True)

    def fn():
        return step(state, batch, 0.1)

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    host_ms, windows, history = _windows(fn, n_windows, per_window)
    launches = {name: c.launches for name, c in counters.items()}
    n = n_windows * per_window
    want = {"kron_train_fwd": 6 * n, "kron_fwd": n, "kron_bwd_dw": 0,
            "kron_bwd_dvec": n, "conv3x3": 36 * n if paired else 0}
    label = (f"masked teacher step (masking_bn {masking_bn}"
             + (", paired_conv)" if paired else ")"))
    print(f"{label}: {n} steps, launches {launches} ({card})")
    if launches != want:
        raise RuntimeError(f"{label} launched {launches}, expected {want}")
    for metrics in history:
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"{label}: metric {k} is not finite")
    if not float(history[-1]["loss_masking"]) > 0:
        raise RuntimeError(f"{label}: loss_masking is not positive")
    print(f"{label} metrics, last step:", {
        k: round(float(v), 5) for k, v in history[-1].items()}, f"({card})")
    print(f"timing {label}: host {host_ms:.3f} ms per step of "
          f"{opt.batch_size} (median of {n_windows} windows of {per_window}:"
          f" {', '.join(f'{w:.3f}' for w in windows)}), bf16, 512^2, 4 "
          f"views, {opt.num_superpixels} SLIC superpixels, Path_K "
          f"{opt.Path_K}, Omic_K {opt.Omic_K}, device-resident batch "
          f"({card})")
    out = {"host_ms": host_ms, "launches": launches, "state": state}
    if n_prof:
        out.update(_profile_steps(fn, card, n_prof, label=label,
                                  kernels=MASKED_TAGS))
        out["syncs"], where = _count_syncs(fn, 3)
        print(f"{label}: {out['syncs']:g} host synchronisations per step "
              f"{where} ({card})")
    return out


def _masked_cross_check(card, gen, rois, labels, batch_size=4):
    """Phase 20: one fp32 masked step (``clat_stage1``, ``--masking_bn
    chain``, dropout 0, so that the Kronecker masks are ones) on the card
    (kernel path, TF32 off) against the CPU (plain path, oneDNN off), from
    the same state, views and SLIC labels, with the same flips and jitter
    factors (drawn once, given to both).  The saliency masks of the step
    equal; the loss parts at rtol 2e-3 / atol 5e-4; Adam's first moment of
    the heads (outside the ResNet trunk, but the three biases that feed a
    train-mode BatchNorm, as phase 9) at rtol 2e-3 and an atol of 2e-3 of
    each tensor's largest element, the trunk's by the norm of the
    difference at 2e-2; both models' BatchNorm buffers after the step at
    rtol 2e-3 / atol 5e-4."""
    import copy

    from multimodal_learning_tpu_torch.data import augment
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train import steps

    opt = Options(**{**CLAT1_CONFIG, "compute_dtype": "float32",
                     "dropout_rate": 0.0, "batch_size": batch_size})
    model = define_model(opt, generator=torch.Generator().manual_seed(SEED))
    batch = _masked_batch(opt, gen, "cpu", rois, labels)
    draws = augment.draw_views(gen, batch_size, 4, "cpu")
    orig_aug, orig_mask = (steps.augment_views_with_mask,
                           steps.superpixel_attention_mask)
    masks = {}

    def aug(g, v, m, jitter=True, dtype=torch.float32):
        on = lambda t: type(t)(*(x.to(v.device) for x in t))
        return augment.augment_views_with_mask_apply(
            v, m, [(on(f), on(j)) for f, j in draws], dtype)

    def record(*args):
        out = orig_mask(*args)
        masks[args[1].device.type] = [t.cpu() for t in out]
        return out

    steps.augment_views_with_mask = aug
    steps.superpixel_attention_mask = record
    results = {}
    try:
        for where in ("cuda", "cpu"):
            state = steps.init_teacher_state(
                opt, copy.deepcopy(model), make_lr_schedule(opt, 50),
                opt.n_data, seed=SEED, device=where)
            b = {k: v.to(where) for k, v in batch.items()}
            with torch.backends.mkldnn.flags(enabled=False):
                _, metrics = steps.build_teacher_train_step(
                    opt, masking=True)(state, b, 0.1)
            adam = state.optimizer.optimizer.state
            results[where] = (
                {k: v.cpu() for k, v in metrics.items()},
                {n: adam[p]["exp_avg"].cpu()
                 for n, p in state.model.named_parameters()},
                {f"{side}.{n}": t.cpu() for side, mod in
                 (("model", state.model), ("ema", state.ema_model))
                 for n, t in mod.named_buffers()})
    finally:
        steps.augment_views_with_mask = orig_aug
        steps.superpixel_attention_mask = orig_mask
    for name, got, want in zip(("path", "omic"), masks["cuda"],
                               masks["cpu"]):
        if not torch.equal(got, want):
            raise AssertionError(f"fp32 masked step: the {name} saliency "
                                 "masks differ between card and CPU")
    (m_gpu, mu_gpu, bn_gpu), (m_cpu, mu_cpu, bn_cpu) = (results["cuda"],
                                                        results["cpu"])
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].float(), m_cpu[k].float(),
                                   rtol=2e-3, atol=5e-4, msg=k)
    for k in bn_cpu:
        torch.testing.assert_close(bn_gpu[k], bn_cpu[k], rtol=2e-3,
                                   atol=5e-4, msg=f"buffer {k}")
    before_bn = {"fusion.encoder1.0.bias", "fusion.encoder2.0.bias",
                 "path_net.fc_new1.0.bias"}
    worst_el, worst_norm = 0.0, 0.0
    for n, want in mu_cpu.items():
        diff = mu_gpu[n] - want
        if n.startswith("path_net.") and not n.startswith(
                ("path_net.fc_new1", "path_net.fc_new2")):
            rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
            if rel > 2e-2:
                raise AssertionError(f"masked exp_avg {n}: |card - cpu| / "
                                     f"|cpu| = {rel:.3e} > 2e-2")
            worst_norm = max(worst_norm, rel)
            continue
        if n in before_bn:
            continue
        atol = max(1e-6, 2e-3 * want.abs().max().item())
        torch.testing.assert_close(mu_gpu[n], want, rtol=2e-3, atol=atol,
                                   msg=f"masked exp_avg {n}")
        worst_el = max(worst_el, (diff.abs().max()
                                  / want.abs().max().clamp_min(1e-30)).item())
    print("fp32 masked step card vs cpu, loss parts:", {
        k: f"{float(m_gpu[k]):.6f}/{float(m_cpu[k]):.6f}" for k in m_cpu},
          f"({card})")
    print(f"fp32 masked step card vs cpu: saliency masks equal ("
          f"{int(masks['cpu'][0].sum())} path pixels, "
          f"{int(masks['cpu'][1].sum())} omic features masked); "
          f"{len(bn_cpu)} BatchNorm buffers agree; exp_avg heads worst "
          f"max|diff| / max|cpu| = {worst_el:.3e}, trunk worst |diff| / "
          f"|cpu| = {worst_norm:.3e} (batch {batch_size}, 512^2; {card})")


def _clat_batch(opt, gen, dev):
    b, n = opt.batch_size, opt.n_data
    index = torch.randperm(n, generator=gen)[:b]
    sample_idx = torch.randint(0, n, (b, 1 + opt.nce_k), generator=gen)
    sample_idx[:, 0] = index
    batch = {"omic": torch.randn(b, opt.input_size_omic, generator=gen),
             "g": torch.randint(0, opt.label_dim, (b,), generator=gen),
             "index": index, "sample_idx": sample_idx,
             "path_views": torch.randint(
                 0, 256, (b, 2, opt.input_size_path, opt.input_size_path, 3),
                 dtype=torch.uint8, generator=gen)}
    return {k: v.to(dev) for k, v in batch.items()}


def _clat_path(card, gen, dev, teacher_sd, pos_extra="neighbors",
               reweight_on=False, teacher_bn="batch", paired=False,
               n_windows=1, per_window=5, n_warm=2, n_prof=0):
    """Phase 21: the CLAT student's step at full width (``clat_stage2`` as
    published: nce_p 6, nce_k 4096, GK_refine with the 0.25 threshold, two
    teachers, max_discrep 1; bf16, 512^2, batch 16) through
    ``freeze_teacher`` on phase 19's masked teacher, ``init_student_state``
    (banks of 8192 rows) and ``build_clat_student_step``.  Per step: B1
    once (``--teacher_bn batch``) or B2 once (``running``), B3 and B4
    never, B5 16 times with ``--paired_conv``; finite metrics; the
    teacher's buffers bitwise unchanged."""
    from torch.nn import functional as F

    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import (make_lr_schedule,
                                                     student, student_clat)

    opt = Options(**{**CLAT2_CONFIG, "pos_extra": pos_extra,
                     "teacher_bn": teacher_bn, "paired_conv": paired})
    teacher = define_model(opt, generator=torch.Generator())
    teacher.load_state_dict(teacher_sd)
    teacher = student.freeze_teacher(teacher, dev)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = student.init_student_state(
        opt, define_model(opt, path_only=True,
                          generator=torch.Generator().manual_seed(SEED)),
        make_lr_schedule(opt, steps_per_epoch=50), opt.n_data, seed=SEED)
    class_mask = F.one_hot(torch.randint(0, opt.label_dim, (opt.n_data,),
                                         generator=gen),
                           opt.label_dim).t().float().to(dev)
    batch = _clat_batch(opt, gen, dev)
    step = student_clat.build_clat_student_step(opt, teacher, class_mask)

    def fn():
        return step(state, batch, reweight_on)

    for _ in range(n_warm):
        fn()
    torch.cuda.synchronize()
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    host_ms, windows, history = _windows(fn, n_windows, per_window)
    launches = {name: c.launches for name, c in counters.items()}
    n = n_windows * per_window
    want = {"kron_train_fwd": n if teacher_bn == "batch" else 0,
            "kron_fwd": n if teacher_bn == "running" else 0,
            "kron_bwd_dw": 0, "kron_bwd_dvec": 0,
            "conv3x3": 16 * n if paired else 0}
    label = (f"CLAT student step ({pos_extra}, teacher_bn {teacher_bn}, "
             f"reweight {'on' if reweight_on else 'off'}"
             + (", paired_conv)" if paired else ")"))
    print(f"{label}: {n} steps, launches {launches} ({card})")
    if launches != want:
        raise RuntimeError(f"{label} launched {launches}, expected {want}")
    for metrics in history:
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"{label}: metric {k} is not finite")
    w1 = float(history[-1]["w1_mean"])
    if (w1 < 1.0) if reweight_on else (w1 != 1.0):
        raise RuntimeError(f"{label}: w1_mean {w1} with reweight "
                           f"{reweight_on}")
    for k, v in teacher.state_dict().items():
        if not torch.equal(v, before[k]):
            raise RuntimeError(f"{label}: the frozen teacher's {k} changed")
    print(f"{label} metrics, last step:", {
        k: [round(x, 5) for x in v.flatten().tolist()] if v.numel() > 1
        else round(float(v), 5) for k, v in history[-1].items()},
          f"({card})")
    print(f"timing {label}: host {host_ms:.3f} ms per step of "
          f"{opt.batch_size} (median of {n_windows} windows of {per_window}:"
          f" {', '.join(f'{w:.3f}' for w in windows)}), bf16, 512^2, nce_p "
          f"{opt.nce_p}, nce_k {opt.nce_k}, banks of {opt.n_data} rows, "
          f"device-resident batch ({card})")
    out = {"host_ms": host_ms, "launches": launches}
    if n_prof:
        kron = "B1" if teacher_bn == "batch" else "B2"
        out.update(_profile_steps(fn, card, n_prof, label=label, kernels=(
            ("B5 (conv3x3)", "conv3x3"),
            (f"{kron} (kron_gemm_kernel + kron_reduce_kernel)", "kron_"))))
        out["syncs"], where = _count_syncs(fn, 3)
        print(f"{label}: {out['syncs']:g} host synchronisations per step "
              f"{where} ({card})")
    return out


def _clat_chain(card, n_train=64, n_test=32, teacher_epochs=2):
    """Phase 22: the MIA-2023 chain through the CLIs as a user runs them,
    on one synthetic fold at full width with ``--paired_conv True``:
    ``cli.train_cv_MT_SP_Masking`` (the ``clat_stage1`` flags,
    ``--start_epoch 1``, 2 epochs: the second runs the masked step on the
    loader's SLIC maps), ``cli.train_cv_path_CLAT`` (the ``clat_stage2``
    flags on that teacher, 1 epoch, so that the best checkpoint is the
    final one; its feature diagnostics evaluate the teacher) and
    ``cli.test_cv_path``, which must reproduce the student's final eval
    exactly.  Launches are checked per step and per eval forward.
    Returns each driver's launches and wall seconds."""
    from multimodal_learning_tpu_torch.cli import (test_cv_path,
                                                   train_cv_MT_SP_Masking,
                                                   train_cv_path_CLAT)
    from multimodal_learning_tpu_torch.eval import load_pred_test
    from multimodal_learning_tpu_torch.eval.metrics import (
        extended_grading_metrics, one_hot)

    bs = PAPER["batch_size"]
    steps, fwd = n_train // bs, -(-n_test // bs)
    counters = _counters()
    common = {**PAPER, "paired_conv": True, "synthetic_data": True,
              "synthetic_folds": 1}
    teacher = {**CLAT1_CONFIG, **common, "niter_decay": teacher_epochs,
               "model_name": "smoke_clat1"}
    teacher.pop("n_data")
    student_flags = {**common, **CLAT2_FLAGS, "niter_decay": 1,
                     "fixed_model": "smoke_clat1",
                     "model_name": "smoke_clat2"}
    out = {}

    def run(main, cfg, root, want, what):
        for c in counters.values():
            c.launches = 0
        flags = [a for k, v in cfg.items() for a in (f"--{k}", str(v))]
        t0 = time.perf_counter()
        res = main(flags + ["--checkpoints_dir", root])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {name: c.launches for name, c in counters.items()}
        print(f"MIA-2023 chain: {what} in {wall:.2f} s, launches {got} "
              f"({card})")
        want = {name: want.get(name, 0) for name in counters}
        if got != want:
            raise RuntimeError(f"{what} launched {got}, expected {want}")
        out[what.split(" ")[0]] = {"launches": got, "wall_s": wall}
        return res

    with tempfile.TemporaryDirectory() as root:
        e, plain = teacher_epochs, Options(**teacher).start_epoch
        masked = e - plain
        run(train_cv_MT_SP_Masking.main, teacher, root,
            {"conv3x3": (12 * plain + 36 * masked) * steps + 4 * e * fwd,
             "kron_train_fwd": (2 * plain + 6 * masked) * steps,
             "kron_fwd": masked * steps + e * fwd,
             "kron_bwd_dvec": masked * steps},
            f"train_cv_MT_SP_Masking ({plain * steps} plain and "
            f"{masked * steps} masked steps, {e} evals of {n_test} ROIs)")
        final = run(train_cv_path_CLAT.main, student_flags, root,
                    {"conv3x3": 16 * steps + 4 * fwd + 4 * fwd,
                     "kron_train_fwd": steps, "kron_fwd": fwd},
                    f"train_cv_path_CLAT ({steps} steps, 1 eval of {n_test}"
                    f" ROIs, the teacher's eval for the diagnostics)")[1]
        ext = run(test_cv_path.main, {**student_flags, "niter_decay": 1},
                  root, {"conv3x3": 4 * fwd}, "test_cv_path")
        ckpt_dir = os.path.join(root, "grad_15", "smoke_clat2")
        with open(os.path.join(ckpt_dir, "metrics.jsonl")) as fh:
            for line in fh:
                rec = json.loads(line)
                print(f"MIA-2023 chain: student epoch {rec['epoch']:g} "
                      f"{rec['samples_per_s']:.1f} patches/s through the "
                      f"loader and prefetcher, loss {rec['train_loss']:.5f} "
                      f"({card})")
        dumped = load_pred_test(os.path.join(ckpt_dir,
                                             "smoke_clat2_1_pred_test.pkl"))
    if not np.array_equal(dumped["probs"]["path"], final["probs"]["path"]):
        raise RuntimeError("test_cv_path's probabilities differ from the "
                           "CLAT student's training-time final eval")
    if not np.isfinite(final["probs"]["path"]).all():
        raise RuntimeError("the CLAT student's probabilities are not finite")
    want = extended_grading_metrics(one_hot(final["gt"], 3),
                                    final["probs"]["path"])
    if ext != [want] or final["ext_metrics"] != want:
        raise RuntimeError(f"test_cv_path's metrics {ext} differ from the "
                           f"final eval's {want}")
    print("MIA-2023 chain: test_cv_path reproduces the CLAT student's final "
          "eval exactly;", {k: round(v, 5) for k, v in want.items()},
          "similarity diagnostics", {
              k: round(v, 5) for k, v in
              final["similarity_diagnostics"].items()}, f"({card})")
    return out


def _time_conv(gen, dev, card, flush):
    """B5, its plain version and ``F.conv2d`` (the one PyTorch call that
    computes the same function; the plain version is that call too) at
    stage 1 of the 512^2 trunk, bf16 (the train and serving paths) and
    fp32; the bound from x and y once each plus W, and the convolution's
    operations at the dtype's peak; the share of the bound reached
    (bound / kernel time) and the ratio to ``F.conv2d`` (kernel / library
    time), L2-cold.  Returns {dtype: (times, bound_ms, bound_by)}."""
    from torch.nn import functional as F

    from multimodal_learning_tpu_torch.ops import paired_conv as pc
    b, h, w, c = CONV_SHAPES[0]
    out = {}
    for dtype, peak, what in ((torch.bfloat16, H100_BF16_FLOP_PER_S,
                               "989 TFLOP/s bf16"),
                              (torch.float32, H100_FP32_FLOP_PER_S,
                               "67 TFLOP/s fp32")):
        x, wt = _conv_inputs(CONV_SHAPES[0], gen, dev, dtype)
        fns = {"kernel": lambda: pc.conv3x3(x, wt),
               "plain": lambda: pc.conv3x3_plain(x, wt),
               "library": lambda: F.conv2d(x, wt, padding=1)}
        times = {}
        with torch.inference_mode():
            for which, fn in fns.items():
                for cold in (False, True):
                    times[which, cold] = _time_ms(fn, 50, cold, flush)
        nbytes = x.element_size() * (2 * b * h * w * c + c * c * 9)
        flops = 2 * b * h * w * 9 * c * c
        t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / peak
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        for which in fns:
            print(f"timing conv3x3 {dtype} {which}_ms: L2-cold "
                  f"{times[which, True]:.5f} L2-warm "
                  f"{times[which, False]:.5f} ((B, H, W, C)={CONV_SHAPES[0]},"
                  f" channels-last; {card})")
        print(f"timing conv3x3 {dtype} bound_ms={bound_ms:.5f} by {bound_by}:"
              f" {nbytes} bytes at 3.35 TB/s, {flops} flop at {what} "
              f"({card})")
        print(f"timing conv3x3 {dtype}: {bound_ms / times['kernel', True]:.4f}"
              f" of the bound, {times['kernel', True] / times['library', True]:.4f}"
              f" x F.conv2d's time (L2-cold; {card})")
        out[dtype] = (times, bound_ms, bound_by)
    return out


# The remaining models (ROADMAP A17) at the paper width: the mmdynamics
# model (the flags of the JAX package's ``tests/test_extra_models.py``
# mmdynamics run) and the ``recipes/baseline.py`` "teacher" with only its
# fusion type changed.
DYN_CONFIG = dict(PAPER, fusion_type="mmdynamics", pred_distill=0,
                  CRD_distill=0, n_data=256)
TEACHER_RECIPE = _recipe("teacher", n_data=256)
NEW_FUSIONS = ("polynomial_fusion", "LMF", "HFB")
# launches of B5 per mmdynamics step under --paired_conv: 4 forwards of
# the 64-channel stage and 4 data gradients (one forward, no EMA)
DYN_B5_PER_STEP = 8


def _dynamics_path(card, gen, dev, paired=False):
    """Phase 28: the mmdynamics step at full width through
    ``init_teacher_state`` and ``build_mmdynamics_train_step`` on a
    device-resident batch: 4 windows of 5 steps.  No Kronecker kernel,
    B5 ``DYN_B5_PER_STEP`` times per step under ``--paired_conv``; finite
    losses and gradients; 0 host syncs; the EMA model's parameters and
    buffers bitwise unchanged (the step never updates it)."""
    from multimodal_learning_tpu_torch.train.steps import \
        build_mmdynamics_train_step

    opt = Options(**DYN_CONFIG, paired_conv=paired)
    state = _teacher_state(opt)
    ema = {k: v.clone() for k, v in state.ema_model.state_dict().items()}
    batch = _train_batch(opt, gen, dev)
    step = build_mmdynamics_train_step(opt)
    label = "mmdynamics step" + (" (paired_conv)" if paired else "")
    r = _step_window(card, label, state, lambda: step(state, batch),
                     {"conv3x3": DYN_B5_PER_STEP if paired else 0},
                     n_warm=3, n_windows=4,
                     kernels=(("B5 (conv3x3)", "conv3x3"),))
    if r["syncs"] != 0:
        raise RuntimeError(f"{label} synchronises the host: {r['where']}")
    if set(r["history"][-1]) != {"loss", "correct_fuse"}:
        raise RuntimeError(f"{label} metrics {sorted(r['history'][-1])}")
    for k, v in state.ema_model.state_dict().items():
        if not torch.equal(v, ema[k]):
            raise RuntimeError(f"{label}: the EMA model's {k} changed")
    print(f"{label}: the EMA model's parameters and buffers are bitwise "
          f"unchanged ({card})")
    return r


def _fusion_paths(card, gen, dev):
    """Phase 29: the teacher step of the ``teacher`` recipe with each of
    ``NEW_FUSIONS``: one window of 5 steps each, no kernel of the port
    (their Kronecker products are an einsum, as in the JAX package), 0
    host syncs."""
    from multimodal_learning_tpu_torch.train.steps import \
        build_teacher_train_step

    out = {}
    for fusion_type in NEW_FUSIONS:
        opt = Options(**TEACHER_RECIPE, fusion_type=fusion_type)
        state = _teacher_state(opt)
        batch = _train_batch(opt, gen, dev)
        step = build_teacher_train_step(opt)
        label = f"{fusion_type} teacher step"
        r = _step_window(card, label, state, lambda: step(state, batch, 0.1),
                         {}, kernels=())
        if r["syncs"] != 0:
            raise RuntimeError(f"{label} synchronises the host: "
                               f"{r['where']}")
        out[fusion_type] = r
        del state, step
        torch.cuda.empty_cache()
    return out


def _dynamics_cross_check(card, gen, batch_size=4):
    """Phase 30: one fp32 mmdynamics step on the card (TF32 off) against
    the CPU (oneDNN off) from the same state and views, every dropout 0
    (MMDynamic's fixed 0.5 set to 0 on both sides), at phase 9's
    tolerances: loss and accuracy count at rtol 2e-3 / atol 5e-4; Adam's
    first moment of the heads (the fusion, MaxNet, ``fc_new1`` but its
    bias, which feeds a train-mode BatchNorm, ``fc_new2``) at rtol 2e-3
    with an atol of 2e-3 of each tensor's largest element, the trunk's by
    the norm of the difference at 2e-2."""
    import copy

    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train import steps

    opt = Options(**{**DYN_CONFIG, "compute_dtype": "float32",
                     "dropout_rate": 0.0, "batch_size": batch_size})
    model = define_model(opt, generator=torch.Generator().manual_seed(SEED))
    model.fusion.drop.p = 0.0
    batch = _train_batch(opt, gen, "cpu")
    views = (torch.rand(batch_size, 2, opt.input_size_path,
                        opt.input_size_path, 3, generator=gen) * 2 - 1)
    augment = steps.augment_views
    steps.augment_views = lambda g, v, dtype: views.to(v.device, dtype)
    results = {}
    try:
        for where in ("cuda", "cpu"):
            state = steps.init_teacher_state(
                opt, copy.deepcopy(model), make_lr_schedule(opt, 50),
                opt.n_data, seed=SEED, device=where)
            with torch.backends.mkldnn.flags(enabled=False):
                _, metrics = steps.build_mmdynamics_train_step(opt)(
                    state, {k: v.to(where) for k, v in batch.items()})
            adam = state.optimizer.optimizer.state
            results[where] = (
                {k: v.cpu() for k, v in metrics.items()},
                {n: adam[p]["exp_avg"].cpu()
                 for n, p in state.model.named_parameters()})
    finally:
        steps.augment_views = augment
    (m_gpu, mu_gpu), (m_cpu, mu_cpu) = results["cuda"], results["cpu"]
    for k in m_cpu:
        torch.testing.assert_close(m_gpu[k].float(), m_cpu[k].float(),
                                   rtol=2e-3, atol=5e-4, msg=k)
    worst_el, worst_norm = 0.0, 0.0
    for n, want in mu_cpu.items():
        diff = mu_gpu[n] - want
        if n.startswith("path_net.") and "fc_new" not in n:
            rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
            if rel > 2e-2:
                raise AssertionError(f"mmdynamics exp_avg {n}: |card - cpu|"
                                     f" / |cpu| = {rel:.3e} > 2e-2")
            worst_norm = max(worst_norm, rel)
            continue
        if n == "path_net.fc_new1.0.bias":
            continue
        atol = max(1e-6, 2e-3 * want.abs().max().item())
        torch.testing.assert_close(mu_gpu[n], want, rtol=2e-3, atol=atol,
                                   msg=f"mmdynamics exp_avg {n}")
        worst_el = max(worst_el, (diff.abs().max()
                                  / want.abs().max().clamp_min(1e-30)).item())
    print("fp32 mmdynamics step card vs cpu:", {
        k: f"{float(m_gpu[k]):.6f}/{float(m_cpu[k]):.6f}" for k in m_cpu},
          f"exp_avg heads worst max|diff| / max|cpu| = {worst_el:.3e}, "
          f"trunk worst |diff| / |cpu| = {worst_norm:.3e} (batch "
          f"{batch_size}, 512^2; {card})")


def _fusion_eval_cross_check(card, gen, batch_size=4):
    """Phase 30: the fp32 serving forward (``make_infer_fn``) of each new
    fusion type and of the mmdynamics model at full width, on the card
    (TF32 off) against the CPU from the same weights, every output at rtol
    2e-3 / atol 5e-4 (phase 5's tolerance)."""
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.serve import make_infer_fn

    x = torch.randint(0, 256, (batch_size, 512, 512, 3), dtype=torch.uint8,
                      generator=gen)
    om = torch.randn(batch_size, 80, generator=gen)
    for cfg in [dict(TEACHER_RECIPE, fusion_type=f) for f in NEW_FUSIONS] + [
            DYN_CONFIG]:
        opt = Options(**{**cfg, "compute_dtype": "float32"})
        model = define_model(opt, generator=torch.Generator().manual_seed(
            SEED))
        want = make_infer_fn(opt, model)(x, om)
        got = make_infer_fn(opt, model.to("cuda"))(x, om)
        errs = {}
        for k in want:
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=2e-3,
                                       atol=5e-4, msg=k)
            errs[k] = f"{(got[k].cpu() - want[k]).abs().max().item():.3e}"
        print(f"fp32 {opt.fusion_type} eval forward card vs cpu, "
              f"max_abs_err {errs} (rtol 2e-3, atol 5e-4; {card})")
        del model
    torch.cuda.empty_cache()


def _dynamics_chain(card, gen, n_train=64, n_test=32, epochs=2):
    """Phase 31: the mmdynamics chain through the CLIs as a user runs them,
    on one synthetic fold at full width with ``--paired_conv True``:
    ``cli.train_cv_MT`` (2 epochs of 4 steps), ``cli.test_cv_MT``, which
    must reproduce the final training eval exactly, then
    ``cli.export_model`` and ``cli.predict`` on ``N_IMAGES`` PNGs, whose
    outputs are ``{"pred_fuse"}``; launches checked per step and per
    forward.  Then times the exported artifact's serving forward on a
    device-resident batch of 16."""
    from multimodal_learning_tpu_torch.cli import (export_model, predict,
                                                   test_cv_MT, train_cv_MT)
    from multimodal_learning_tpu_torch.eval import load_pred_test
    from multimodal_learning_tpu_torch.serve import load_exported

    bs = PAPER["batch_size"]
    steps, fwd = epochs * (n_train // bs), -(-n_test // bs)
    name = "smoke_mmd"
    cfg = {**DYN_CONFIG, "paired_conv": True, "synthetic_data": True,
           "synthetic_folds": 1, "niter_decay": epochs, "model_name": name}
    cfg.pop("n_data")
    b5 = DYN_B5_PER_STEP
    out = {}
    with tempfile.TemporaryDirectory() as root:
        results, out["train_cv_MT"] = _run_cli(
            train_cv_MT.main, cfg, root,
            {"conv3x3": b5 * steps + 4 * epochs * fwd},
            f"mmdynamics chain: train_cv_MT ({steps} steps, {epochs} evals "
            f"of {n_test} ROIs)", card)
        res = results[1]
        tested, out["test_cv_MT"] = _run_cli(
            test_cv_MT.main, cfg, root, {"conv3x3": 4 * fwd},
            "mmdynamics chain: test_cv_MT", card)
        ckpt_dir = os.path.join(root, "grad_15", name)
        dumped = load_pred_test(os.path.join(ckpt_dir,
                                             f"{name}_1_pred_test.pkl"))
        if tested != {"fuse": [res["metrics_fuse"]], "path": [],
                      "omic": []}:
            raise RuntimeError(f"mmdynamics test_cv_MT's metrics {tested} "
                               "differ from the training-time final eval "
                               f"{res['metrics_fuse']}")
        if not np.array_equal(dumped["probs"]["fuse"], res["probs"]["fuse"]):
            raise RuntimeError("mmdynamics test_cv_MT's probabilities "
                               "differ from the training-time final eval")
        if not np.isfinite(res["probs"]["fuse"]).all():
            raise RuntimeError("mmdynamics probabilities are not finite")
        print("mmdynamics chain: test_cv_MT reproduces the final eval "
              "exactly; AUC/AP/F1/F1-IV",
              [round(float(v), 5) for v in res["metrics_fuse"]], f"({card})")

        img_dir, csv = _write_inputs(root, 600, 80, gen)
        counters = _counters()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        written = export_model.main(["--checkpoints_dir", root,
                                     "--exp_name", "grad_15",
                                     "--model_name", name,
                                     "--export_batch", str(bs)])
        pred = predict.main(["--artifact", written[0], "--images_dir",
                             img_dir, "--omic_csv", csv, "--batch_size",
                             str(bs), "--quiet"])
        torch.cuda.synchronize()
        got = {k: c.launches for k, c in counters.items()}
        n_fwd = 1 + -(-N_IMAGES // bs)   # export's check + the batches
        want = {k: (4 * n_fwd if k == "conv3x3" else 0) for k in counters}
        print(f"mmdynamics chain: export_model + predict on {N_IMAGES} "
              f"images in {time.perf_counter() - t0:.2f} s, launches {got} "
              f"({card})")
        if got != want:
            raise RuntimeError(f"export_model + predict launched {got}, "
                               f"expected {want}")
        with open(written[0] + ".json") as fh:
            outputs = json.load(fh)["outputs"]
        if outputs != ["pred_fuse"] or set(pred) != {"pred_fuse", "prob",
                                                      "grade"}:
            raise RuntimeError(f"the mmdynamics artifact serves {outputs}, "
                               f"predict returned {sorted(pred)}")
        if pred["pred_fuse"].shape != (N_IMAGES, 3) or not np.isfinite(
                pred["pred_fuse"]).all():
            raise RuntimeError("the mmdynamics predictions are not finite "
                               f"[{N_IMAGES}, 3]")
        np.testing.assert_allclose(pred["prob"].sum(axis=1), 1.0, rtol=1e-4)

        infer = load_exported(written[0], "cuda")
        xb = torch.randint(0, 256, (bs, 512, 512, 3), dtype=torch.uint8,
                           generator=gen).to("cuda")
        ob = torch.randn(bs, 80, generator=gen).to("cuda")
        for _ in range(3):
            infer(xb, ob)
        torch.cuda.synchronize()
        n_iter = 20
        t0 = time.perf_counter()
        for _ in range(n_iter):
            infer(xb, ob)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / n_iter
        out["serve_ms"], out["serve_pps"] = ms, 1e3 * bs / ms
        print(f"timing mmdynamics serve: {ms:.3f} ms per batch of {bs}, "
              f"{out['serve_pps']:.1f} patches/s (bf16, 512^2, paired_conv,"
              f" device-resident input; {card})")
        _profile_serve(infer, xb, ob, card)
    return out


# Phases 32-35: the released-checkpoint and serving slice (ROADMAP A18, A2,
# A8): the ``teacher`` recipe's width, bf16, 512^2, batch 16, weights from
# seed 2019 built in process.  The flagship step of phase 7 carries the
# optimizers and schedules of phase 33.
INIT_TYPES = ("normal", "xavier", "kaiming", "orthogonal")
INIT_GAIN = 0.02


def _perturb_bn(model, gen):
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.num_batches_tracked.fill_(30)
    return model


def _released_files(root, gen):
    """Phase 32's inputs, written with ``torch.save`` and converted by the
    port's ``cli.convert_torch``: a torchvision-style ResNet18 (the port
    trunk without ``fc_new*``, with a 1000-way ``fc`` and
    ``num_batches_tracked``) and a released-style wrapper of a whole
    pofusion model (distinct model and EMA weights).  Returns the ``.npz``
    paths, the trunk's state dict and the EMA's."""
    from multimodal_learning_tpu_torch.cli import convert_torch
    from multimodal_learning_tpu_torch.models import define_model
    opt = Options(**TEACHER_RECIPE)
    trunk = _perturb_bn(define_model(
        opt.replace(mode="path"), generator=torch.Generator().manual_seed(
            SEED + 1)), gen).state_dict()
    tv = {k: v for k, v in trunk.items() if not k.startswith("fc_new")}
    tv["fc.weight"] = torch.randn(1000, 512, generator=gen) * 0.01
    tv["fc.bias"] = torch.zeros(1000)
    model, ema = (_perturb_bn(define_model(
        opt, generator=torch.Generator().manual_seed(SEED + s)), gen)
        for s in (2, 3))
    wrapper = {"split": 1, "opt": {"mode": "pathomic", "task": "grad"},
               "epoch": 30, "data": {}, "model_state_dict": model.state_dict(),
               "ema_model_state_dict": ema.state_dict(),
               "optimizer_state_dict": {"param_groups": [], "state": {}},
               "metrics": None}
    torch.save(tv, os.path.join(root, "resnet18.pth"))
    torch.save(wrapper, os.path.join(root, "released_1.pt"))
    paths = {"trunk": os.path.join(root, "resnet18.npz"),
             "teacher": os.path.join(root, "teacher_1.npz")}
    for args in (["--src", os.path.join(root, "resnet18.pth"), "--dst",
                  paths["trunk"], "--arch", "resnet18"],
                 ["--src", os.path.join(root, "released_1.pt"), "--dst",
                  paths["teacher"], "--arch", "pathomic", "--state_key",
                  "ema_model_state_dict"]):
        if convert_torch.main(args) != 0:
            raise RuntimeError(f"convert_torch {args} failed")
    return paths, trunk, ema.state_dict()


def _pretrained_path(card, root, paths, trunk, n_train=64, n_test=32):
    """Phase 32: ``init_teacher_state`` with ``--pretrained_path`` (the
    converted torchvision-style file) and ``--init_type max`` loads the
    trunk and its running statistics bitwise, keeps ``fc_new*`` as drawn,
    and starts the EMA equal to the model; then ``cli.train_cv_MT`` with
    the file on one synthetic fold, 1 epoch of 4 steps, ``--paired_conv
    True``: B1 twice and B5 12 times per step, B2 once and B5 4 times per
    eval forward."""
    from multimodal_learning_tpu_torch.cli import train_cv_MT
    opt = Options(**TEACHER_RECIPE, pretrained_path=paths["trunk"],
                  init_type="max")
    state = _teacher_state(opt)
    drawn = _teacher_state(opt.replace(pretrained_path=""))
    got = state.model.state_dict()
    n = 0
    for k, v in trunk.items():
        if k.endswith("num_batches_tracked"):
            continue
        key = "path_net." + k
        same = torch.equal(got[key].cpu(), v)
        if k.startswith("fc_new"):
            # the file has no heads: they stay as drawn, and the Linears'
            # random weights are not the source model's
            if not torch.equal(got[key], drawn.model.state_dict()[key]):
                raise RuntimeError(f"{key} is not as drawn")
            if same and k.endswith("0.weight"):
                raise RuntimeError(f"{key} is the source model's")
        elif not same:
            raise RuntimeError(f"{key} differs from --pretrained_path's")
        n += 1
    for k, v in state.ema_model.state_dict().items():
        if not torch.equal(v, got[k]):
            raise RuntimeError(f"the EMA's {k} differs from the model's")
    print(f"pretrained init: {n} trunk tensors and running statistics "
          "bitwise the file's, fc_new* as drawn, EMA equal to the model "
          f"({card})")
    del state, drawn
    bs = PAPER["batch_size"]
    steps, fwd = n_train // bs, -(-n_test // bs)
    cfg = {**TEACHER_RECIPE, "niter_decay": 1, "paired_conv": True,
           "synthetic_data": True, "synthetic_folds": 1,
           "pretrained_path": paths["trunk"], "model_name": "smoke_pre"}
    cfg.pop("n_data")
    res, launches = _run_cli(
        train_cv_MT.main, cfg, root,
        {"kron_train_fwd": 2 * steps, "conv3x3": 12 * steps + 4 * fwd,
         "kron_fwd": fwd},
        f"pretrained train_cv_MT ({steps} steps, 1 eval of {n_test} ROIs)",
        card)
    if not np.isfinite(res[1]["probs"]["fuse"]).all():
        raise RuntimeError("pretrained train_cv_MT probabilities are not "
                           "finite")
    return launches


def _law_std(init_type, shape):
    """The JAX package's law for a flax kernel shape (``variance_scaling``
    fans: in_axis -2, out_axis -1)."""
    rf = int(np.prod(shape)) // (shape[-2] * shape[-1])
    fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    return {"normal": INIT_GAIN,
            "xavier": INIT_GAIN * (2 / (fan_in + fan_out)) ** 0.5,
            "kaiming": (2 / fan_in) ** 0.5}[init_type]


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, prefix + (k,)) if isinstance(v, dict)
                   else {prefix + (k,): v})
    return out


def _reinit_checks(card, paths, trunk):
    """Phase 33a: ``init_teacher_state`` with the same file and each of
    ``--init_type normal|xavier|kaiming|orthogonal``: the trunk is
    clobbered, every bias is exactly 0, every kernel of at least 4096
    elements has the std of its JAX law within 5 % (the estimate's error
    is under 1.2 %), orthogonal kernels have Q^T Q = gain^2 I to 1e-4
    relative to gain^2."""
    from multimodal_learning_tpu_torch.models import flax_from_state_dict
    for init_type in INIT_TYPES:
        opt = Options(**TEACHER_RECIPE, pretrained_path=paths["trunk"],
                      init_type=init_type, init_gain=INIT_GAIN)
        state = _teacher_state(opt)
        conv1 = state.model.path_net.conv1.weight.detach().cpu()
        if torch.equal(conv1, trunk["conv1.weight"]):
            raise RuntimeError(f"--init_type {init_type} kept the trunk")
        params, _ = flax_from_state_dict(state.model.state_dict())
        worst, n_kernels = 0.0, 0
        for path, v in _flat(params).items():
            if path[-1] == "bias" and np.any(v):
                raise RuntimeError(f"{init_type}: {path} is not 0")
            if path[-1] != "kernel" or v.ndim < 2 or v.size < 4096:
                continue
            n_kernels += 1
            if init_type == "orthogonal":
                q = v.reshape(-1, v.shape[-1]).astype(np.float64) / INIT_GAIN
                gram = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
                err = float(np.abs(gram - np.eye(len(gram))).max())
            else:
                err = abs(float(v.std()) / _law_std(init_type, v.shape) - 1)
            worst = max(worst, err)
            if err > (1e-4 if init_type == "orthogonal" else 0.05):
                raise RuntimeError(f"{init_type}: {path} {v.shape} is off "
                                   f"its law by {err:.3e}")
        what = ("|Q^T Q / gain^2 - I|" if init_type == "orthogonal"
                else "relative std")
        print(f"--init_type {init_type}: trunk clobbered, biases 0, "
              f"{n_kernels} kernels within {worst:.3e} of the JAX law "
              f"({what}; {card})")
        del state


def _optimizer_paths(card, gen, dev, root, n_train=64, n_test=32):
    """Phase 33b: one window of 5 flagship steps (phase 7's) with
    ``--optimizer_type adabound --lr_policy onecycle`` and with
    ``--optimizer_type adagrad``: B1 twice per step, finite losses and
    gradients, 0 host syncs.  Then ``cli.train_cv_MT`` at the flagship's
    flags with ``--optimizer_type adagrad`` (1 epoch of 4 steps, one
    synthetic fold) up to its fold checkpoint, which must carry the CRD
    heads."""
    from multimodal_learning_tpu_torch.cli import train_cv_MT
    from multimodal_learning_tpu_torch.utils import load_checkpoint
    from multimodal_learning_tpu_torch.train.steps import \
        build_teacher_train_step
    out = {}
    for label, kw in (("adabound onecycle", dict(optimizer_type="adabound",
                                                 lr_policy="onecycle")),
                      ("adagrad", dict(optimizer_type="adagrad"))):
        opt = _train_opt(**kw)
        state = _teacher_state(opt)
        batch = _train_batch(opt, gen, dev)
        step = build_teacher_train_step(opt)
        r = _step_window(card, f"flagship step, {label}", state,
                         lambda: step(state, batch, 0.1),
                         {"kron_train_fwd": 2})
        if r["syncs"] != 0:
            raise RuntimeError(f"the {label} step synchronises the host: "
                               f"{r['where']}")
        out[label] = r
        del state, step
        torch.cuda.empty_cache()
    bs = TRAIN_CONFIG["batch_size"]
    steps, fwd = n_train // bs, -(-n_test // bs)
    cfg = {**TRAIN_CONFIG, "niter_decay": 1, "synthetic_data": True,
           "synthetic_folds": 1, "optimizer_type": "adagrad",
           "model_name": "smoke_adagrad"}
    cfg.pop("n_data")
    _, out["train_cv_MT"] = _run_cli(
        train_cv_MT.main, cfg, root,
        {"kron_train_fwd": 2 * steps, "kron_fwd": fwd},
        f"adagrad train_cv_MT ({steps} steps, 1 eval of {n_test} ROIs)",
        card)
    heads = load_checkpoint(os.path.join(
        root, "grad_15", "smoke_adagrad", "smoke_adagrad_1.pt"))["crd_params"]
    if sorted(heads) != ["crd_fuse_s", "crd_fuse_t"]:
        raise RuntimeError(f"the adagrad fold checkpoint's CRD heads are "
                           f"{sorted(heads)}")
    print(f"adagrad train_cv_MT: fold checkpoint with its CRD heads ({card})")
    return out


def _released_eval(card, root, paths, ema_sd, dev, n_test=32):
    """Phase 34: ``cli.test_cv_MT --pretrained_path '<dir>/teacher_{k}.npz'``
    with no fold checkpoint and ``pallas_fusion="train"``: B2 once per eval
    forward; its prediction pickle equals, bitwise, ``train.loop.evaluate``
    of the same weights loaded by ``load_state_dict``."""
    from multimodal_learning_tpu_torch.cli import test_cv_MT
    from multimodal_learning_tpu_torch.cli.train_cv_MT import load_data
    from multimodal_learning_tpu_torch.data.pipeline import (Loader,
                                                             PathomicDataset)
    from multimodal_learning_tpu_torch.eval import load_pred_test
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train.loop import evaluate
    from multimodal_learning_tpu_torch.train.steps import build_eval_step
    cfg = {**TEACHER_RECIPE, "synthetic_data": True, "synthetic_folds": 1,
           "model_name": "released", "pretrained_path":
           os.path.join(os.path.dirname(paths["teacher"]),
                        "teacher_{k}.npz")}
    cfg.pop("n_data")
    fwd = -(-n_test // PAPER["batch_size"])
    ckpt_dir = os.path.join(root, "grad_15", "released")
    if os.path.exists(os.path.join(ckpt_dir, "released_1.pt")):
        raise RuntimeError("phase 34 needs no fold checkpoint")
    tested, launches = _run_cli(test_cv_MT.main, cfg, root,
                                {"kron_fwd": fwd},
                                "released test_cv_MT --pretrained_path", card)
    dumped = load_pred_test(os.path.join(ckpt_dir,
                                         "released_1_pred_test.pkl"))
    opt = Options(**{k: v for k, v in cfg.items() if k != "pretrained_path"})
    model = define_model(opt)
    model.load_state_dict(ema_sd, strict=True)
    data = load_data(opt)
    loader = Loader(PathomicDataset(opt, data["cv_splits"][1], "test",
                                    train=False), opt.batch_size,
                    shuffle=False, drop_last=False, n_views=1)
    try:
        want = evaluate(opt, build_eval_step(opt), model.to(dev), loader,
                        dev, torch.Generator(device=dev).manual_seed(
                            opt.seed))
    finally:
        loader.close()
    for name in ("fuse", "path", "omic"):
        if not np.array_equal(dumped["probs"][name], want["probs"][name]):
            raise RuntimeError(f"released test_cv_MT's {name} probabilities "
                               "differ from evaluate() of the same weights")
    if tested["fuse"] != [want["metrics_fuse"]]:
        raise RuntimeError("released test_cv_MT's metrics differ")
    print("released test_cv_MT: its prediction pickle equals evaluate() of "
          "the EMA weights loaded by load_state_dict, bitwise; AUC/AP/F1/"
          f"F1-IV {[round(float(v), 5) for v in want['metrics_fuse']]} "
          f"({card})")
    return launches


def _serve_in_turns(fns, xb, ob, n=10, rounds=5):
    """Host ms per batch of ``xb`` of each of ``fns`` (name, function) in
    turns: ``rounds`` rounds, (a, b, c) then (c, b, a) then (a, b, c) ...,
    windows of ``n`` forwards each ending in a synchronise.  Returns each
    function's windows."""
    for _, fn in fns:
        fn(xb, ob)
    torch.cuda.synchronize()
    ms = {name: [] for name, _ in fns}
    for r in range(rounds):
        for name, fn in fns[::1 if r % 2 == 0 else -1]:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(xb, ob)
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.perf_counter() - t0) / n)
    return ms


def _host_breakdown(fns, xb, ob, card, label, n=10, top=6):
    """Where a serving forward's host time goes, for each of ``fns`` (name,
    function): torch.profiler (CPU and CUDA activity) over ``n`` forwards
    gives, per forward, the ATen ops called, the kernels launched, the
    device ms, the self CPU ms inside ops and the wall ms outside them (the
    Python that drives the ops: module calls, or the exported graph's
    generated code, input checks and autocast regions); then the ops whose
    count or self CPU time differs most between the two.  The profiler
    slows the host, so these are compared with each other, not with the
    windows of ``_serve_in_turns``.  The ops are compared between the
    first two functions."""
    from torch.profiler import ProfilerActivity, profile
    rows, per_op = {}, {}
    for name, fn in fns:
        fn(xb, ob)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn(xb, ob)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / n
        events = prof.key_averages()
        ops = {e.key: (e.count / n, e.self_cpu_time_total / n / 1e3)
               for e in events if e.self_cpu_time_total > 0}
        top_level = sum(e.cpu_time_total for e in prof.events()
                        if e.cpu_parent is None and e.device_type.name
                        == "CPU") / n / 1e3
        rows[name] = {
            "aten_ops": sum(c for k, (c, _) in ops.items()
                            if k.startswith("aten::")),
            "launches": sum(c for k, (c, _) in ops.items()
                            if k in ("cudaLaunchKernel", "cuLaunchKernel",
                                     "cudaLaunchKernelExC", "cuLaunchKernelEx")),
            "device_ms": sum(e.self_device_time_total for e in events)
            / n / 1e3,
            "self_cpu_ms": sum(ms for _, ms in ops.values()),
            "outside_ops_ms": wall - top_level, "wall_ms": wall}
        per_op[name] = ops
        print(f"host breakdown {label}, {name}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in rows[name].items())
              + f" per forward ({n} forwards, under the profiler; {card})")
    (na, a), (nb, b) = list(per_op.items())[:2]
    diff = sorted(set(a) | set(b), key=lambda k: -abs(
        b.get(k, (0, 0))[1] - a.get(k, (0, 0))[1]))
    for k in diff[:top]:
        (ca, ta), (cb, tb) = a.get(k, (0, 0)), b.get(k, (0, 0))
        print(f"  {k[:60]}: {na} x{ca:g} {ta:.4f} ms, {nb} x{cb:g} "
              f"{tb:.4f} ms")
    return rows


def _dispatch_cost(card, gen, dev, n=200):
    """The host cost of the registered ops: ``n`` calls of B2 and of B5
    through ``torch.ops.mml`` and through their CUDA kernels' functions
    directly, in turns, at the serving and stage-1 shapes; the host time
    of the enqueue, synchronised once after.  Returns the op's extra host
    us per call of each."""
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    from multimodal_learning_tpu_torch.ops import paired_conv as pc
    o1, o2, w, bias = _kron_inputs(*KRON_SHAPES[0], gen, dev)
    x = torch.randn(16, 128, 128, 64, generator=gen).to(
        dev, torch.bfloat16).permute(0, 3, 1, 2)
    wc = (torch.randn(64, 64, 3, 3, generator=gen) * 0.06).to(
        dev, torch.bfloat16)
    pairs = {"kron_fwd": (lambda: torch.ops.mml.kron_fwd(o1, o2, w, bias),
                          lambda: kf._kron_fwd_cuda(o1, o2, w, bias)),
             "conv3x3": (lambda: torch.ops.mml.conv3x3(x, wc, False),
                         lambda: pc._conv3x3_cuda(x, wc, False))}
    out = {}
    for name, (op, direct) in pairs.items():
        us = {"op": [], "direct": []}
        for which, fn in (("op", op), ("direct", direct), ("direct", direct),
                          ("op", op)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            us[which].append(1e6 * (time.perf_counter() - t0) / n)
            torch.cuda.synchronize()
        out[name] = min(us["op"]) - min(us["direct"])
        print(f"dispatch {name}: host us per call through torch.ops.mml "
              f"{us['op'][0]:.2f} / {us['op'][1]:.2f}, direct "
              f"{us['direct'][0]:.2f} / {us['direct'][1]:.2f} (in turns, "
              f"{n} calls each; {card})")
    return out


PREDICT_CHILD = """
import json, sys
from multimodal_learning_tpu_torch.cli import predict
from multimodal_learning_tpu_torch.ops import kron_fusion, paired_conv
runs, launches = json.loads(sys.argv[1]), {}
for artifact, out in runs:
    kron_fusion.kron_matmul.launches = paired_conv.conv3x3.launches = 0
    predict.main(["--artifact", artifact, "--images_dir", sys.argv[2],
                  "--omic_csv", sys.argv[3], "--batch_size", "16",
                  "--out", out, "--quiet"])
    launches[artifact] = [kron_fusion.kron_matmul.launches,
                          paired_conv.conv3x3.launches]
print(json.dumps({"launches": launches, "models": [
    m for m in sys.modules if m.startswith(
        ("multimodal_learning_tpu_torch.models", "jax"))]}))
"""


def _exported_artifacts(card, root, ema_sd, gen, dev):
    """Phase 35: ``cli.export_model`` of the released EMA weights to a
    ``.pt2`` at batch 16 and with a dynamic batch, unpaired and paired;
    ``cli.predict`` on ``N_IMAGES`` PNGs in a fresh ``python3`` that must
    not import the port's ``models``; every output equal to the eager
    ``make_infer_fn`` bitwise on the same batches; the dynamic artifacts
    serve batches 1, 5 and 16 in process, bitwise the eager forward; B2
    once and B5 4 times (paired) per forward; then ms per batch of 16,
    artifact against eager, in turns."""
    import pickle
    from multimodal_learning_tpu_torch.cli import export_model, predict
    from multimodal_learning_tpu_torch.models import (define_model,
                                                      flax_from_state_dict)
    from multimodal_learning_tpu_torch.serve import (load_exported,
                                                     make_infer_fn)
    from multimodal_learning_tpu_torch.utils import save_checkpoint
    params, stats = flax_from_state_dict(ema_sd)
    img_dir, csv = _write_inputs(root, 600, 80, gen)
    files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    x_all = predict._load_images(files, TEACHER_RECIPE["input_size_path"])
    o_all = predict._load_omic(csv, files, 80)
    counters = _counters()
    variants, runs, out = {}, [], {}
    for paired in (False, True):
        opt = Options(**{**TEACHER_RECIPE, "paired_conv": paired,
                         "model_name": "export", "exp_name": "grad_15"})
        model = define_model(opt)
        model.load_state_dict(ema_sd, strict=True)
        eager = make_infer_fn(opt, model.to(dev))
        for batch in ("16", "dynamic"):
            name = f"export_{batch}{'_paired' if paired else ''}"
            save_checkpoint(os.path.join(root, "grad_15", name,
                                         f"{name}_1.pt"),
                            {"split": 1, "opt": opt.replace(model_name=name),
                             "epoch": 30, "model_state_dict": params,
                             "batch_stats": stats, "metrics": None})
            flags = (["--export_batch", batch] if batch == "16"
                     else ["--export_dynamic_batch", "True"])
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            (path,) = export_model.main(["--checkpoints_dir", root,
                                         "--exp_name", "grad_15",
                                         "--model_name", name, *flags])
            torch.cuda.synchronize()
            print(f"{name}: export_model in {time.perf_counter() - t0:.2f} s"
                  f", {os.path.getsize(path) / 2 ** 20:.1f} MiB, launches "
                  f"{ {k: c.launches for k, c in counters.items()} } "
                  f"({card})")
            variants[name] = (path, eager, paired, batch)
            runs.append((path, os.path.join(root, f"{name}.pkl")))
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", PREDICT_CHILD, json.dumps(runs), img_dir,
         csv], env=env, capture_output=True, text=True, timeout=600)
    if child.returncode:
        raise RuntimeError(f"cli.predict in a fresh python3 failed:\n"
                           f"{child.stdout[-3000:]}\n{child.stderr[-3000:]}")
    report = json.loads(child.stdout.strip().splitlines()[-1])
    print(f"cli.predict of 4 artifacts on {N_IMAGES} images in a fresh "
          f"python3: {time.perf_counter() - t0:.2f} s, launches (B2, B5) "
          f"{report['launches']}, port models imported: {report['models']} "
          f"({card})")
    if report["models"]:
        raise RuntimeError(f"cli.predict imported {report['models']}")
    n_fwd = -(-N_IMAGES // 16)
    for name, (path, eager, paired, batch) in variants.items():
        if report["launches"][path] != [n_fwd, 4 * n_fwd if paired else 0]:
            raise RuntimeError(f"{name}: predict launched (B2, B5) "
                               f"{report['launches'][path]} in {n_fwd} "
                               "forwards")
        with open(os.path.join(root, f"{name}.pkl"), "rb") as fh:
            got = pickle.load(fh)
        want = predict._batched(
            lambda xp, xo: {k: v.cpu().numpy()
                            for k, v in eager(xp, xo).items()},
            x_all, o_all, 16 if batch == "16" else 0, 16)
        for k, v in want.items():
            if not np.array_equal(got[k], v):
                raise RuntimeError(f"{name}: predict's {k} differs from "
                                   "the eager forward")
        infer = load_exported(path, dev)
        for n in ((16,) if batch == "16" else (1, 5, 16)):
            xb = torch.from_numpy(x_all[:n]).to(dev)
            ob = torch.from_numpy(o_all[:n]).to(dev)
            for c in counters.values():
                c.launches = 0
            got = infer(xb, ob)
            torch.cuda.synchronize()
            launched = {k: c.launches for k, c in counters.items()}
            want_l = {k: 0 for k in counters}
            want_l.update(kron_fwd=1, conv3x3=4 if paired else 0)
            if launched != want_l:
                raise RuntimeError(f"{name} at batch {n} launched "
                                   f"{launched}, expected {want_l}")
            ref = eager(xb, ob)
            if sorted(got) != sorted(ref) or not all(
                    torch.equal(got[k], ref[k]) for k in ref):
                raise RuntimeError(f"{name} at batch {n} differs from the "
                                   "eager forward")
        if batch == "16":
            xb = torch.from_numpy(x_all[:16]).to(dev)
            ob = torch.from_numpy(o_all[:16]).to(dev)
            # ExportedProgram.module(), which load_exported does not use:
            # the cost it avoids
            module = torch.export.load(path).module()

            def via_module(xp, xo, module=module):
                with torch.inference_mode():
                    return module(xp, xo)

            ref = via_module(xb, ob)
            if not all(torch.equal(ref[k], got[k]) for k in got):
                raise RuntimeError(f"{name}: module() differs")
            fns = (("artifact", infer), ("eager", eager),
                   ("module()", via_module))
            ms = _serve_in_turns(fns, xb, ob, n=20, rounds=10)
            out[name] = {k: float(np.median(v)) for k, v in ms.items()}
            print(f"timing {name}: ms per batch of 16 in 10 rounds of "
                  "turns, " + "; ".join(
                      f"{k} " + " / ".join(f"{v:.3f}" for v in ms[k])
                      for k in ms) + "; medians " + ", ".join(
                          f"{k} {v:.3f}" for k, v in out[name].items())
                  + f" (bf16, 512^2, device-resident input; {card})")
            for other in ("eager", "module()"):
                wins = sum(a < b for a, b in zip(ms["artifact"], ms[other]))
                out[name][f"wins_vs_{other}"] = wins
                print(f"timing {name}: the artifact's window is the faster "
                      f"in {wins} of {len(ms[other])} rounds against "
                      f"{other} ({card})")
            out[name]["breakdown"] = _host_breakdown(fns, xb, ob, card,
                                                     name)
    print("exported artifacts: predict and the in-process serves equal the "
          "eager forward bitwise; B2 once and B5 4 times (paired) per "
          f"forward ({card})")
    out["dispatch_us"] = _dispatch_cost(card, gen, dev)
    out["predict_launches"] = {
        "kron_fwd": sum(v[0] for v in report["launches"].values()),
        "conv3x3": sum(v[1] for v in report["launches"].values())}
    return out


# Phase 36: the ``teacher`` recipe through the offline evaluation chain,
# cut to the CLIs' synthetic split (64 train + 32 test ROIs a fold, one
# patch per patient), 2 folds and 2 epochs.  Seed 2020 gives each fold's
# three 9-patch ROIs all three grades, so that ROI_evaluation's F1 of grade
# IV is defined (the metrics raise without it, as scikit-learn's do).
EVAL_CHAIN = _recipe("teacher", synthetic_data=True, synthetic_folds=2,
                     niter_decay=2, seed=2020, model_name="smoke_eval")
METRICS = ("rocauc", "ap", "f1_micro", "f1_gradeIV")


def _eval_chain(card, n_train=64, n_test=32):
    """Phase 36: ``cli.train_cv_MT`` -> ``cli.export_model`` ->
    ``cli.test_cv_MT`` -> ``cli.evaluation_GBMLGG`` -> ``cli.ROI_evaluation``
    on ``EVAL_CHAIN`` as a user runs them, in a temporary directory.  Each
    driver's B1/B2 launches must equal the counts of its steps and
    forwards; each fold's ``max`` and ``mean`` patient-level rows must
    equal test_cv_MT's metrics of that fold exactly (one patch per
    patient); ROI_evaluation's rows must equal ``roi_evaluation`` of the
    dumped probabilities (NaN equal to NaN).  Returns each driver's
    launches."""
    from multimodal_learning_tpu_torch.cli import (ROI_evaluation,
                                                   evaluation_GBMLGG,
                                                   export_model, test_cv_MT,
                                                   train_cv_MT)
    from multimodal_learning_tpu_torch.eval.analysis import (load_pred_test,
                                                             roi_evaluation)

    cfg = EVAL_CHAIN
    folds, epochs, bs = (cfg["synthetic_folds"], cfg["niter_decay"],
                         cfg["batch_size"])
    steps, fwd = n_train // bs, -(-n_test // bs)
    launches = {}
    with tempfile.TemporaryDirectory() as root:
        def drive(main, want, what):
            res, launches[what] = _run_cli(main, cfg, root, want,
                                           f"eval chain: {what}", card)
            return res

        drive(train_cv_MT.main,
              {"kron_train_fwd": 2 * epochs * steps * folds,
               "kron_fwd": epochs * fwd * folds},
              f"train_cv_MT ({folds} folds of {epochs * steps} steps and "
              f"{epochs} evals of {n_test} ROIs)")
        written = drive(export_model.main, {"kron_fwd": folds},
                        "export_model (one check forward a fold)")
        tested = drive(test_cv_MT.main, {"kron_fwd": fwd * folds},
                       f"test_cv_MT ({folds} folds)")
        agg = drive(evaluation_GBMLGG.main, {}, "evaluation_GBMLGG")
        rois = drive(ROI_evaluation.main, {}, "ROI_evaluation")
        if len(written) != folds or not all(map(os.path.exists, written)):
            raise RuntimeError(f"export_model wrote {written}")
        ckpt_dir = os.path.join(root, "grad_15", cfg["model_name"])
        dumped = [load_pred_test(os.path.join(
            ckpt_dir, f"{cfg['model_name']}_{k}_pred_test.pkl"))
            for k in range(1, folds + 1)]
    for branch in ("fuse", "path", "omic"):
        if len(tested[branch]) != folds:
            raise RuntimeError(f"test_cv_MT gave {tested[branch]}")
        for i, want in enumerate(tested[branch]):
            want = [float(v) for v in want]
            if not np.isfinite(want).all():
                raise RuntimeError(f"fold {i + 1} {branch}: {want}")
            for how in ("max", "mean"):
                got = [agg[branch, how]["per_fold"][m][i] for m in METRICS]
                if got != want:
                    raise RuntimeError(
                        f"evaluation_GBMLGG fold {i + 1} {branch}/{how} "
                        f"{got} differs from test_cv_MT's {want}")
            if not np.isfinite(dumped[i]["probs"][branch]).all():
                raise RuntimeError(f"fold {i + 1} {branch} probabilities "
                                   "are not finite")
        for i, got in enumerate(rois[branch]):
            want = roi_evaluation(np.asarray(dumped[i]["probs"][branch]),
                                  np.asarray(dumped[i]["gt"]),
                                  patches_per_roi=9, n_classes=3)
            if not np.array_equal(np.asarray(got), np.asarray(want),
                                  equal_nan=True):
                raise RuntimeError(f"ROI_evaluation fold {i + 1} {branch} "
                                   f"{got} differs from {want}")
    print("eval chain: every fold's max and mean patient rows equal "
          "test_cv_MT's metrics exactly, and ROI_evaluation's rows equal "
          "roi_evaluation of the dumped probabilities; patient-level "
          "AUC/AP/F1/F1-IV mean +- 95% CI " + "; ".join(
              f"{b}/{a} " + " ".join(
                  f"{m:.4f}+-{c:.4f}" for m, c in zip(r["mean"], r["ci95"]))
              for (b, a), r in agg.items()) + f" ({card})")
    return launches


# Phase 37: the sweep's four groups at its own tiny dims (``_TINY``: 64^2,
# widths 16, ``pallas_fusion`` off, so no kernel of the port launches)
SWEEP_GROUPS = {"omic": ("omic SNN (config 2)",),
                "teacher": ("pofusion teacher (config 3)",
                            "MICCAI student (config 3)"),
                "tsvd": ("DSCD student (config 4)",),
                "clat": ("CLAT student (config 5)",)}


def _sweep_phase(card, folds=2):
    """Phase 37: ``cli.sweep --folds 2`` over all four groups with its report
    in a temporary directory; the drivers' own output goes to a file, whose
    tail is printed if the sweep raises.  Every group's sections must hold
    finite fold means in [0, 1] ([-1, 1] for kappa and MCC), and the report
    the patient-level table.
    No kernel may launch.  Returns the wall s."""
    import contextlib
    from multimodal_learning_tpu_torch.cli import sweep

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    with tempfile.TemporaryDirectory() as root:
        report, log = (os.path.join(root, n) for n in ("report.md",
                                                       "drivers.log"))
        t0 = time.perf_counter()
        with open(log, "w") as fh, contextlib.redirect_stdout(fh):
            try:
                sections = sweep.main([
                    "--folds", str(folds), "--configs",
                    ",".join(SWEEP_GROUPS), "--out_dir",
                    os.path.join(root, "ckpt"), "--report", report])
                torch.cuda.synchronize()
            except BaseException:
                fh.flush()
                with open(log) as src:
                    sys.stderr.write(src.read()[-6000:])
                raise
        wall = time.perf_counter() - t0
        with open(report) as fh:
            text = fh.read()
    got = {name: c.launches for name, c in counters.items()}
    print(f"sweep: cli.sweep --folds {folds} over {len(SWEEP_GROUPS)} groups "
          f"in {wall:.2f} s, launches {got} ({card})")
    print(text)
    if any(got.values()):
        raise RuntimeError(f"the sweep at pallas_fusion off launched {got}")
    titles = [t for t, _ in sections]
    want = [t for group in SWEEP_GROUPS.values() for t in group]
    if titles != want:
        raise RuntimeError(f"the sweep's sections are {titles}, not {want}")
    for title, rows in sections:
        if not rows:
            raise RuntimeError(f"{title}: no fold table")
        for name, header, mean, std in rows:
            # Cohen's kappa and the MCC lie in [-1, 1], the rest in [0, 1]
            low = np.array([-1.0 if h in ("kappa", "mcc") else 0.0
                            for h in header])
            if not (np.isfinite(mean).all() and np.isfinite(std).all()
                    and ((low <= mean) & (mean <= 1)).all()):
                raise RuntimeError(f"{title} {name}: means {mean}, std {std}")
    if ("## patient-level aggregation" not in text
            or "| fuse/max |" not in text):
        raise RuntimeError("the sweep's report has no patient-level table")
    return wall


def _write_inputs(root, size, d_omic, gen):
    from PIL import Image
    img_dir = os.path.join(root, "rois")
    os.makedirs(img_dir)
    for i in range(N_IMAGES):
        arr = torch.randint(0, 256, (size, size, 3), dtype=torch.uint8,
                            generator=gen).numpy()
        Image.fromarray(arr).save(os.path.join(img_dir, f"roi_{i:02d}.png"))
    omic = torch.randn(N_IMAGES, d_omic, generator=gen).numpy()
    csv = os.path.join(root, "omic.csv")
    np.savetxt(csv, omic, delimiter=",", comments="",
               header=",".join(f"g{j}" for j in range(d_omic)))
    return img_dir, csv


# Phase 38: data parallel (``parallel/mesh.py``) at world size 1 on NCCL
DP_CLI_STEPS, DP_CLI_EVALS = 8, 4   # 2 epochs of 4 steps; 2 evals of 2


def _dp_states(opt, student_of=None, n=2):
    """``n`` equal ``(state, step)`` pairs from seed 2019 for ``opt``: the
    teacher's (``init_teacher_state``) or, with ``student_of`` (a teacher
    state dict), the MICCAI student's on a frozen teacher
    (``_frozen_student``)."""
    dev = torch.device("cuda")
    if student_of is None:
        from multimodal_learning_tpu_torch.train.steps import (
            build_teacher_train_step)
        step = build_teacher_train_step(opt)
        return [(_teacher_state(opt), step) for _ in range(n)]
    return [_frozen_student(opt, student_of, dev)[:2] for _ in range(n)]


def _dp_moments(state):
    adam = state.optimizer.optimizer.state
    named = {f"model.{n}": p for n, p in state.model.named_parameters()}
    named.update({f"embeds.{n}": p
                  for n, p in state.embeds.named_parameters()})
    return {n: adam[p]["exp_avg"].float().cpu() for n, p in named.items()}


def _dp_hold(card, label, plain, sharded):
    """Phase 9's card tolerances between two first steps (each ``(state,
    metrics)``): the loss parts and the BatchNorm buffers of the model and
    the EMA at rtol 2e-3 / atol 5e-4; Adam's first moments of the ResNet
    trunk by the norm of the difference at 2e-2, the others at rtol 2e-3
    and an atol of 2e-3 of each tensor's largest element, but the biases
    that feed a train-mode BatchNorm (exact gradient 0)."""
    (sa, ma), (sb, mb) = plain, sharded
    for k in ma:
        torch.testing.assert_close(mb[k].float().cpu(), ma[k].float().cpu(),
                                   rtol=2e-3, atol=5e-4, msg=f"{label} {k}")
    for what in ("model", "ema_model"):
        bufs = dict(getattr(sa, what).named_buffers())
        for n, b in getattr(sb, what).named_buffers():
            if n.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(b, bufs[n], rtol=2e-3, atol=5e-4,
                                           msg=f"{label} {what}.{n}")
    mu_a, mu_b = _dp_moments(sa), _dp_moments(sb)
    worst_el = worst_norm = 0.0
    for n, want in mu_a.items():
        diff = mu_b[n] - want
        trunk = n.startswith(("model.path_net.", "model.layer", "model.conv1",
                              "model.bn1")) and "fc_new" not in n
        if trunk:
            rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
            if rel > 2e-2:
                raise AssertionError(f"{label} exp_avg {n}: |dp - plain| / "
                                     f"|plain| = {rel:.3e} > 2e-2")
            worst_norm = max(worst_norm, rel)
        elif not n.endswith(("encoder1.0.bias", "encoder2.0.bias",
                             "fc_new1.0.bias")):
            atol = max(1e-6, 2e-3 * want.abs().max().item())
            torch.testing.assert_close(mu_b[n], want, rtol=2e-3, atol=atol,
                                       msg=f"{label} exp_avg {n}")
            worst_el = max(worst_el, (diff.abs().max() / want.abs().max()
                                      .clamp_min(1e-30)).item())
    print(f"{label}: loss parts " + ", ".join(
        f"{k} {float(mb[k]):.6f}/{float(ma[k]):.6f}" for k in ma
        if ma[k].numel() == 1) + f"; BatchNorm buffers agree; exp_avg "
          f"outside the trunk worst max|diff| / max|plain| = {worst_el:.3e},"
          f" trunk worst |diff| / |plain| = {worst_norm:.3e} ({card})")


def _dp_first_steps(card, gen, init, teacher_sd):
    """The first fp32 step of the flagship teacher (dropout 0.1: the
    default generator reseeded before each step, B1's mask from the state's
    generator) and of the MICCAI student (dropout 0), with and without data
    parallel at world 1 (an NCCL group of one, joined here), the second
    ranking CRD's pairs by the first's cosines (:func:`_shared_crd_ranking`),
    held by :func:`_dp_hold`.  Returns the teacher's batch on the host and its
    metrics at dropout 0, for the world-2 comparison."""
    from multimodal_learning_tpu_torch import parallel
    dev = torch.device("cuda")
    cases = (("teacher", _train_opt(compute_dtype="float32"), None),
             ("MICCAI student", Options(**{
                 **STUDENT_CONFIG, "compute_dtype": "float32",
                 "dropout_rate": 0.0}), teacher_sd))
    with parallel.process_group(0, 1, dev, init):
        for name, opt, sd in cases:
            batch = (_train_batch if sd is None else _student_batch)(
                opt, gen, dev)
            label = f"data parallel world 1 vs plain, fp32 {name} first step"
            runs = []
            with _shared_crd_ranking(label, card) as next_run:
                for (state, step), sharded in zip(_dp_states(opt, sd),
                                                  (False, True)):
                    next_run()
                    torch.cuda.manual_seed(SEED)
                    with (parallel.unsharded() if not sharded
                          else contextlib.nullcontext()):
                        runs.append((state, step(state, batch, 0.1)[1]))
            _dp_hold(card, label, *runs)
            del runs
        opt0 = _train_opt(compute_dtype="float32", dropout_rate=0.0)
        batch = _train_batch(opt0, gen, "cpu")
        (state, step), = _dp_states(opt0, n=1)
        world1 = step(state, {k: v.to(dev) for k, v in batch.items()},
                      0.1)[1]
    torch.cuda.empty_cache()
    return batch, {k: v.cpu() for k, v in world1.items()}


def _dp_world_rank(batch):
    """A rank of phase 38's world-2 check: the fp32 flagship teacher's first
    step (dropout 0) from seed 2019 on this rank's rows of ``batch``."""
    from multimodal_learning_tpu_torch.parallel import active, process_slice
    dp = active()
    opt = _train_opt(compute_dtype="float32", dropout_rate=0.0)
    (state, step), = _dp_states(opt, n=1)
    rows = {k: process_slice(v, dp.world, dp.rank).to(dp.device)
            for k, v in batch.items()}
    return {k: v.cpu() for k, v in step(state, rows, 0.1)[1].items()}


def _dp_cli_rank(argv):
    """A rank of phase 38's CLI run: ``train_cv_MT.main(argv)`` in the
    launched group, and this process's kernel launches."""
    from multimodal_learning_tpu_torch.cli import train_cv_MT
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    res = train_cv_MT.main(argv)
    torch.cuda.synchronize()
    return res, {n: c.launches for n, c in counters.items()}


def _time_bn(card, init):
    """Train-mode BatchNorm forward + backward at the stem's shape (16,
    64, 256, 256) bf16 channels-last, the port's global one (NCCL group of
    one) against cuDNN's, in turns (a, b, b, a; 10 calls each, CUDA
    events).  Returns the two ms."""
    from multimodal_learning_tpu_torch import parallel
    from multimodal_learning_tpu_torch.models.common import BatchNorm2d
    dev = torch.device("cuda")
    bn = BatchNorm2d(64).to(dev)
    x = torch.randn(16, 64, 256, 256, device=dev, dtype=torch.bfloat16
                    ).to(memory_format=torch.channels_last).requires_grad_()
    g = torch.randn_like(x)

    def call():
        bn(x).backward(g)

    ms = {"global": [], "cudnn": []}
    with parallel.process_group(0, 1, dev, init):
        for name in ("global", "cudnn", "cudnn", "global", "global"):
            ctx = (parallel.unsharded() if name == "cudnn"
                   else contextlib.nullcontext())
            with ctx:
                call()
                s, e = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                s.record()
                for _ in range(10):
                    call()
                e.record()
                torch.cuda.synchronize()
            ms[name].append(s.elapsed_time(e) / 10)
    ms = {k: min(v) for k, v in ms.items()}
    print(f"BatchNorm2d train forward + backward at (16, 64, 256, 256) bf16 "
          f"channels-last: global (one all-gather, one all-reduce) "
          f"{ms['global']:.4f} ms, cuDNN {ms['cudnn']:.4f} ms "
          f"({ms['global'] / ms['cudnn']:.2f}x; {card})")
    return ms


def _data_parallel(card, gen, teacher_sd):
    """Phase 38: ``--data_parallel`` on the card.  At world size 1 on NCCL
    (a group of one joined in this process): the first fp32 teacher and
    student steps against the same steps without data parallel
    (:func:`_dp_first_steps`); a window of 5 flagship teacher steps and one
    of the MICCAI student's, bf16, B1 twice and once per step, with host
    and kernel ms, busy share and NCCL launches per step, each against the
    step without data parallel in turns; the global BatchNorm against
    cuDNN's (:func:`_time_bn`).  Then ``train_cv_MT --data_parallel -1``
    (every card, one rank each, launched by ``parallel.launch``) of one
    synthetic fold, 2 epochs of 4 steps: B1 16 times and B2 4 times in
    the ranks; ``test_cv_MT`` must reproduce its final eval exactly.  With
    two cards or more, the world-2 first step against world 1."""
    from multimodal_learning_tpu_torch import parallel
    from multimodal_learning_tpu_torch.cli import test_cv_MT
    from multimodal_learning_tpu_torch.parallel import mesh
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        batch, world1 = _dp_first_steps(
            card, gen, "file://" + os.path.join(root, "s1"), teacher_sd)
        out = {"bn": _time_bn(card, "file://" + os.path.join(root, "s2"))}
        nccl = ("NCCL", "nccl")
        with parallel.process_group(0, 1, dev,
                                    "file://" + os.path.join(root, "s3")):
            for name, opt, sd, per in (
                    ("teacher", _train_opt(), None, 2),
                    ("MICCAI student", Options(**STUDENT_CONFIG), teacher_sd,
                     1)):
                b = (_train_batch if sd is None else _student_batch)(
                    opt, gen, dev)
                (s_plain, step_plain), (s_dp, step_dp) = _dp_states(opt, sd)

                def plain():
                    with parallel.unsharded():
                        return step_plain(s_plain, b, 0.1)

                def sharded():
                    return step_dp(s_dp, b, 0.1)

                label = f"data-parallel {name} step (world 1, NCCL)"
                sharded()
                calls = dict.fromkeys(mesh.CALLS, 0)
                mesh.CALLS.update(calls)
                sharded()
                calls = dict(mesh.CALLS)
                out[name] = _step_window(
                    card, label, s_dp, sharded, {"kron_train_fwd": per},
                    kernels=(B1_TAG, nccl))
                out[name]["collectives"] = calls
                out[name, "plain"] = _profile_steps(
                    plain, card, 3, label=f"{name} step without data "
                    "parallel", kernels=(B1_TAG, nccl))
                _ab_steps(card, ((f"{name} plain", plain),
                                 (f"{name} data parallel", sharded)), n=5)
                print(f"{label}: collectives per step {calls}, "
                      f"{out[name].get('nccl count', 0):g} NCCL kernels "
                      f"per step ({card})")
                del s_plain, s_dp, plain, sharded
                torch.cuda.empty_cache()
        cfg = {**TRAIN_CONFIG, "niter_decay": 2, "synthetic_data": True,
               "synthetic_folds": 1, "model_name": "smoke_dp",
               "checkpoints_dir": root}
        flags = [a for k, v in cfg.items() for a in (f"--{k}", str(v))]
        world = torch.cuda.device_count()
        t0 = time.perf_counter()
        ranks = parallel.launch(_dp_cli_rank, world,
                                (flags + ["--data_parallel", "-1"],),
                                deadline=300)
        cli_s = time.perf_counter() - t0
        res, launches = ranks[0]
        want = {"kron_train_fwd": 2 * DP_CLI_STEPS,
                "kron_fwd": DP_CLI_EVALS}
        print(f"train_cv_MT --data_parallel -1: {world} rank(s) in "
              f"{cli_s:.2f} s, rank 0's launches {launches} ({card})")
        for k, n in want.items():
            if launches[k] != n:
                raise RuntimeError(f"train_cv_MT --data_parallel -1 launched "
                                   f"{k} {launches[k]} times, expected {n}")
        res = res[1]
        counters = _counters()
        counters["kron_fwd"].launches = 0
        tested = test_cv_MT.main(flags)
        if counters["kron_fwd"].launches != DP_CLI_EVALS // 2:
            raise RuntimeError("test_cv_MT did not run its eval through B2")
        for name in ("fuse", "path", "omic"):
            if tested[name] != [res[f"metrics_{name}"]]:
                raise RuntimeError(
                    f"test_cv_MT's {name} metrics {tested[name]} differ from "
                    "the data-parallel run's final eval "
                    f"{res[f'metrics_{name}']}")
        print("train_cv_MT --data_parallel -1: test_cv_MT reproduces the "
              "final eval exactly; AUC/AP/F1/F1-IV", {
                  k: [round(float(v), 5) for v in res[f"metrics_{k}"]]
                  for k in ("fuse", "path", "omic")}, f"({card})")
    if world >= 2:
        got = parallel.launch(_dp_world_rank, 2, (batch,), deadline=300)[0]
        for k, v in world1.items():
            torch.testing.assert_close(got[k].float(), v.float(), rtol=2e-3,
                                       atol=5e-4, msg=f"world 2 {k}")
        print("data parallel world 2 vs world 1, fp32 teacher first step: "
              "loss parts agree at rtol 2e-3 / atol 5e-4", {
                  k: f"{float(got[k]):.6f}/{float(v):.6f}"
                  for k, v in world1.items()}, f"({card})")
    else:
        print(f"data parallel world 2: not run, this machine has {world} "
              f"card ({card})")
    out.update(cli_s=cli_s, cli_launches=launches)
    return out


# Phase 39: the input path users run, at full width (ROADMAP A10): one fold
# of 1024^2 ROI JPEGs (the reference's all_st size) on disk behind the
# reference's split pickle, the ``teacher`` recipe at 512^2 crops with
# ``--paired_conv``; and the same recipe's fold carried across packages by
# a JAX ``.snap``, with ``--lr_policy plateau`` and the flagship step's CRD
# added so that the plateau scale, the CRD heads and a bank cross too.
JPEG_ROI = 1024
JPEG_CHAIN = _recipe("teacher", niter_decay=2, paired_conv=True,
                     model_name="smoke_jpeg")
RESUME_CHAIN = dict(JPEG_CHAIN, niter=1, niter_decay=0, snapshot_every=1,
                    lr_policy="plateau", CRD_distill=1, nce_k=512,
                    model_name="smoke_resume")


def _median_ms(fn, n=20):
    ms = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ms.append(1e3 * (time.perf_counter() - t0))
    return sorted(ms)[n // 2]


def _decoders(card, paths):
    """Which decoder serves the pipeline (``native_loader.available()``,
    with g++'s error when the build failed), each decoder's ms per ROI on
    the first file (median of 20), and, with the native one, its pixels
    against PIL's on every file (raises where one differs)."""
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from multimodal_learning_tpu_torch.data import native_loader

    def pil(blob):
        with Image.open(io.BytesIO(blob)) as im:
            return np.asarray(im.convert("RGB"))

    with open(paths[0], "rb") as fh:
        blob = fh.read()
    out = {"decoder": "native" if native_loader.available() else "pil",
           "pil_ms": _median_ms(lambda: pil(blob)), "native_ms": None}
    if out["decoder"] == "pil":
        print("jpeg chain: the native decoder did not build, so PIL "
              "decodes every ROI, as in the JAX package; g++ said: "
              f"{native_loader.build_error()} ({card})")
        return out
    out["native_ms"] = _median_ms(lambda: native_loader.decode_jpeg(blob))

    def same(path):
        with open(path, "rb") as fh:
            data = fh.read()
        return np.array_equal(native_loader.decode_jpeg(data), pil(data))

    with ThreadPoolExecutor(8) as pool:
        equal = list(pool.map(same, paths))
    if not all(equal):
        raise RuntimeError(
            f"the native decoder's pixels differ from PIL's on "
            f"{equal.count(False)} of {len(paths)} ROIs, first "
            f"{paths[equal.index(False)]}")
    print(f"jpeg chain: native and PIL decode all {len(paths)} ROIs to "
          f"equal pixels ({card})")
    return out


def _state_tensors(state):
    """Every tensor of a port train state that a snapshot carries, by
    name: the models' parameters and buffers (but BatchNorm's
    ``num_batches_tracked``, which no JAX state holds), the heads, the
    optimizer's moments and steps, the banks, the count, the plateau scale
    and the step."""
    out = {}
    for prefix, module in (("model", state.model), ("ema", state.ema_model),
                           ("embeds", state.embeds)):
        out.update({f"{prefix}.{k}": v for k, v in
                    module.state_dict().items()
                    if not k.endswith("num_batches_tracked")})
    named = {f"model.{n}": p for n, p in state.model.named_parameters()}
    named.update({f"embeds.{n}": p
                  for n, p in state.embeds.named_parameters()})
    torch_opt = state.optimizer.optimizer
    for n, p in named.items():
        for k, v in torch_opt.state[p].items():
            out[f"moments.{n}.{k}"] = torch.as_tensor(v)
    for name, bank in state.banks.items():
        fields = (dataclasses.asdict(bank) if dataclasses.is_dataclass(bank)
                  else {"": bank})
        out.update({f"bank.{name}.{k}": v for k, v in fields.items()})
    out.update(count=torch.tensor(state.optimizer.count),
               lr_scale=torch.tensor(state.optimizer.lr_scale),
               step=torch.tensor(state.step))
    return out


def _resume_round_trip(card, root, dataroot, n_train, n_test):
    """A fold of ``RESUME_CHAIN`` stopped after epoch 1 (its ``.pt``), its
    state written as a JAX ``.snap`` by ``save_jax_snapshot``, the ``.pt``
    deleted; the ``.snap`` restored into a fresh state must equal the
    ``.pt``-restored one tensor for tensor, and ``train_cv_MT --resume``
    must carry the fold on from it.  Returns the ``.snap``'s MiB, the
    write and read s, and the two drivers' launches."""
    from multimodal_learning_tpu_torch.cli import train_cv_MT
    from multimodal_learning_tpu_torch.cli._platform import select_device
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import init_teacher_state
    from multimodal_learning_tpu_torch.utils.checkpoint import (
        load_jax_snapshot, load_train_state, save_jax_snapshot)

    cfg = dict(RESUME_CHAIN, dataroot=dataroot)
    steps, fwd = n_train // cfg["batch_size"], -(-n_test // cfg["batch_size"])
    want = {"conv3x3": 12 * steps + 4 * fwd, "kron_train_fwd": 2 * steps,
            "kron_fwd": fwd}
    _, first = _run_cli(train_cv_MT.main, cfg, root, want,
                        "jpeg chain: train_cv_MT, 1 epoch with a snapshot",
                        card)
    name = cfg["model_name"]
    base = os.path.join(root, "grad_15", name, f"{name}_1_state")
    opt = Options(**cfg, checkpoints_dir=root).replace(n_data=n_train)

    def fresh(seed):
        return init_teacher_state(
            opt, define_model(opt, generator=torch.Generator().manual_seed(
                seed)), make_lr_schedule(opt, steps), n_train, seed=seed,
            device=select_device())

    from_pt = fresh(opt.seed + 1)
    epoch, extra = load_train_state(f"{base}.pt", from_pt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    save_jax_snapshot(f"{base}.snap", from_pt, opt, epoch, extra)
    write_s = time.perf_counter() - t0
    mib = os.path.getsize(f"{base}.snap") / 2 ** 20
    os.remove(f"{base}.pt")
    from_snap = fresh(opt.seed + 7)
    t0 = time.perf_counter()
    got = load_jax_snapshot(f"{base}.snap", from_snap, opt)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    if got != (epoch, extra):
        raise RuntimeError(f".snap gave epoch and extra {got}, the .pt "
                           f"{(epoch, extra)}")
    a, b = _state_tensors(from_pt), _state_tensors(from_snap)
    if sorted(a) != sorted(b):
        raise RuntimeError(f"the restored states hold other tensors: "
                           f"{sorted(set(a) ^ set(b))[:5]}")
    differ = [k for k in a if a[k].dtype != b[k].dtype
              or not torch.equal(a[k].cpu(), b[k].cpu())]
    if differ:
        raise RuntimeError(f"{len(differ)} of {len(a)} tensors differ "
                           f"between the .pt- and .snap-restored states, "
                           f"first {differ[:5]}")
    print(f"jpeg chain: the .snap-restored state equals the .pt-restored "
          f"one in all {len(a)} tensors (parameters, EMA, BatchNorm "
          f"buffers, heads, moments, banks {sorted(from_pt.banks)}, count "
          f"{from_pt.optimizer.count}, plateau scale "
          f"{from_pt.optimizer.lr_scale}); .snap {mib:.1f} MiB, written in "
          f"{write_s:.3f} s, read in {read_s:.3f} s ({card})")
    del from_pt, from_snap
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, resumed = _run_cli(train_cv_MT.main,
                              dict(cfg, niter_decay=1, resume=True), root,
                              want, "jpeg chain: train_cv_MT --resume", card)
    sys.stdout.write(buf.getvalue())
    line = f"[fold 1] resumed from epoch 1 ({name}_1_state.snap)"
    if line not in buf.getvalue().splitlines():
        raise RuntimeError(f"train_cv_MT --resume did not log {line!r}")
    return {"snap_mib": mib, "write_s": write_s, "read_s": read_s,
            "launches": {k: first[k] + resumed[k] for k in first}}


def _hold_test_evals(card, opt, split, root, res, tested, dumped, epochs):
    """The test split's crops are random 512^2 windows of the 1024^2 ROIs
    (``RandomCrop`` at test time, as in the reference and the JAX
    package), drawn from the eval loader's generator: the training run's
    loader (seeded ``--seed``) draws anew at each of its ``epochs`` evals,
    and ``test_cv_MT``'s fresh loader (seeded 0, as in the JAX
    ``cli/test_cv_MT.py``) draws its own.  So each is held to an
    evaluation of the fold checkpoint's weights on the same draw: the
    training-time final eval exactly to a loader seeded ``--seed`` after
    ``epochs - 1`` draws, and ``test_cv_MT`` (its metrics and dumped
    probabilities) exactly to a fresh loader seeded 0."""
    from multimodal_learning_tpu_torch.data.pipeline import (Loader,
                                                             PathomicDataset)
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.models.import_flax import \
        state_dict_from_flax
    from multimodal_learning_tpu_torch.cli._platform import select_device
    from multimodal_learning_tpu_torch.train.loop import evaluate
    from multimodal_learning_tpu_torch.train.steps import build_eval_step
    from multimodal_learning_tpu_torch.utils import load_checkpoint

    name = opt.model_name
    ckpt = load_checkpoint(os.path.join(root, "grad_15", name,
                                        f"{name}_1.pt"))
    model = define_model(opt)
    model.load_state_dict(state_dict_from_flax(ckpt["model_state_dict"],
                                               ckpt["batch_stats"]))
    dev = select_device()
    model.to(dev)

    def evaluation(seed, draws):
        loader = Loader(PathomicDataset(opt, split, "test", train=False),
                        opt.batch_size, shuffle=False, drop_last=False,
                        n_views=1, workers=opt.host_workers, seed=seed)
        try:
            for _ in range(draws):
                for _ in loader:
                    pass
            return evaluate(opt, build_eval_step(opt), model, loader, dev,
                            torch.Generator(device=dev).manual_seed(seed))
        finally:
            loader.close()

    for what, got, want in (
            ("the training-time final eval", res,
             evaluation(opt.seed, epochs - 1)),
            ("test_cv_MT", {**{f"metrics_{k}": v[0] for k, v in
                               tested.items()}, "probs": dumped["probs"]},
             evaluation(0, 0))):
        for k in ("fuse", "path", "omic"):
            if list(got[f"metrics_{k}"]) != list(want[f"metrics_{k}"]) or \
                    not np.array_equal(got["probs"][k], want["probs"][k]):
                raise RuntimeError(f"{what}'s {k} eval differs from the "
                                   "fold checkpoint's on the same crops")
            if not np.isfinite(got["probs"][k]).all():
                raise RuntimeError(f"{what}'s {k} probabilities are not "
                                   "finite")
    print("jpeg chain: the training-time final eval and test_cv_MT each "
          "equal the fold checkpoint's eval on their own draw of test "
          "crops exactly; AUC/AP/F1/F1-IV final eval / test_cv_MT", {
              k: [f"{float(a):.5f}/{float(b):.5f}" for a, b in zip(
                  res[f"metrics_{k}"], tested[k][0])]
              for k in ("fuse", "path", "omic")}, f"({card})")


def _jpeg_chain(card, n_train=64, n_test=32):
    """Phase 39: ``make_synthetic_splits`` writes one fold of 1024^2 ROI
    JPEGs (quality 90) and the split pickle goes where
    ``split_pickle_path`` looks; the decoders are compared; the loader's
    ROIs/s with its cache cold; ``cli.train_cv_MT`` on ``JPEG_CHAIN``
    (without ``--synthetic_data``) and ``cli.test_cv_MT``, each eval held
    exactly to the fold checkpoint's on the same crops
    (``_hold_test_evals``); then the cross-package resume
    (``_resume_round_trip``).  Returns the phase's numbers and launches."""
    from multimodal_learning_tpu_torch.cli import test_cv_MT, train_cv_MT
    from multimodal_learning_tpu_torch.data.pipeline import (Loader,
                                                             PathomicDataset)
    from multimodal_learning_tpu_torch.data.splits import (
        make_synthetic_splits, save_splits, split_pickle_path)
    from multimodal_learning_tpu_torch.eval import load_pred_test

    t_phase = time.perf_counter()
    epochs, bs = JPEG_CHAIN["niter_decay"], JPEG_CHAIN["batch_size"]
    steps, fwd = epochs * (n_train // bs), -(-n_test // bs)
    with tempfile.TemporaryDirectory() as root:
        dataroot = os.path.join(root, "data")
        cfg = dict(JPEG_CHAIN, dataroot=dataroot)
        t0 = time.perf_counter()
        data = make_synthetic_splits(
            n_train=n_train, n_test=n_test, roi_size=JPEG_ROI,
            image_dir=os.path.join(dataroot, "rois"), seed=SEED)
        pickle_path = split_pickle_path(Options(**cfg))
        os.makedirs(os.path.dirname(pickle_path), exist_ok=True)
        save_splits(data, pickle_path)
        split = data["cv_splits"][1]
        paths = [str(p) for part in ("train", "test")
                 for p in split[part]["x_path"]]
        mib = sum(os.path.getsize(p) for p in paths) / 2 ** 20
        print(f"jpeg chain: {len(paths)} {JPEG_ROI}^2 ROI JPEGs ({mib:.1f} "
              f"MiB) and {os.path.relpath(pickle_path, root)} written in "
              f"{time.perf_counter() - t0:.2f} s ({card})")
        out = _decoders(card, paths)
        opt = Options(**cfg)
        loader = Loader(PathomicDataset(opt, split, "train", train=True),
                        bs, shuffle=True, drop_last=True, n_views=2,
                        workers=opt.host_workers, seed=opt.seed)
        t0 = time.perf_counter()
        n = sum(len(batch["g"]) for batch in loader)
        out["cold_rois_per_s"] = n / (time.perf_counter() - t0)
        loader.close()
        print(f"jpeg chain: decoder {out['decoder']}: "
              + (f"{out['native_ms']:.2f} ms per {JPEG_ROI}^2 ROI, "
                 if out["native_ms"] is not None else "")
              + f"PIL {out['pil_ms']:.2f} ms (median of 20, one thread); "
              f"the loader, cache cold, {out['cold_rois_per_s']:.1f} ROIs/s "
              f"({opt.host_workers} threads, two {opt.input_size_path}^2 "
              f"crops each) ({card})")
        res, train_l = _run_cli(
            train_cv_MT.main, cfg, root,
            {"conv3x3": 12 * steps + 4 * epochs * fwd,
             "kron_train_fwd": 2 * steps, "kron_fwd": epochs * fwd},
            f"jpeg chain: train_cv_MT ({steps} steps, {epochs} evals of "
            f"{n_test} ROIs)", card)
        res = res[1]
        tested, test_l = _run_cli(
            test_cv_MT.main, cfg, root, {"conv3x3": 4 * fwd, "kron_fwd": fwd},
            "jpeg chain: test_cv_MT", card)
        dumped = load_pred_test(os.path.join(
            root, "grad_15", cfg["model_name"],
            f"{cfg['model_name']}_1_pred_test.pkl"))
        _hold_test_evals(card, opt, split, root, res, tested, dumped, epochs)
        rt = _resume_round_trip(card, os.path.join(root, "resume"),
                                dataroot, n_train, n_test)
    out.update(resume=rt, launches={
        k: train_l[k] + test_l[k] + rt["launches"][k] for k in train_l},
        phase_s=time.perf_counter() - t_phase)
    print(f"jpeg chain: phase 39 in {out['phase_s']:.1f} s ({card})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_learning_tpu_torch.cli import export_model, predict
    from multimodal_learning_tpu_torch.models import (define_model,
                                                      flax_from_state_dict)
    from multimodal_learning_tpu_torch.ops import _build, kron_fusion
    from multimodal_learning_tpu_torch.serve import make_infer_fn
    from multimodal_learning_tpu_torch.utils import save_checkpoint

    dev = torch.device("cuda")
    t_run = time.perf_counter()

    def stamp(phase):
        print(f"[chip_smoke] phase {phase} starts at "
              f"{time.perf_counter() - t_run:.1f} s")

    # 1. the card
    card = _card()
    print(card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "device", torch.cuda.get_device_name(0))

    # 2. build every kernel from this checkout's sources
    t0 = time.time()
    logs = _build.build_all()
    print(f"build_s={time.time() - t0:.2f} built={sorted(logs)} ({card})")
    for name, log in logs.items():
        print(f"[nvcc {name}]", " | ".join(
            ln.strip() for ln in log.splitlines() if "Used" in ln
            or "spill" in ln))
    spills = [ln.strip() for ln in logs.get("kron_fusion", "").splitlines()
              if any(int(v) for v in re.findall(r"(\d+) bytes spill", ln))]
    if spills:
        raise RuntimeError("the Kronecker forward kernels spill: "
                           + " | ".join(spills))

    # 3. each kernel against its plain version on the card
    gen = torch.Generator().manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    torch.backends.cudnn.allow_tf32 = False
    fwd_errs = _check_fwd_kernels(gen, dev, card)
    train_errs = _check_train_kernels(gen, dev, card)
    train_errs["kron_train_fwd"] = max(train_errs["kron_train_fwd"],
                                       fwd_errs["kron_train_fwd"])
    bwd_errs, check_launches = _check_bwd_kernels(gen, dev, card)
    for name, err in bwd_errs.items():
        train_errs[name] = max(train_errs[name], err)
    conv_errs = _check_conv_kernel(gen, dev, card)

    # 4. the serving path end to end at the teacher's full width
    opt = Options(**SERVE_CONFIG)
    model = define_model(opt, generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.running_mean.uniform_(-0.2, 0.2, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    state = model.state_dict()
    params, stats = flax_from_state_dict(state)
    with tempfile.TemporaryDirectory() as root:
        ckpt_dir = os.path.join(root, "ckpt", opt.exp_name, opt.model_name)
        save_checkpoint(os.path.join(ckpt_dir, f"{opt.model_name}_1.pt"),
                        {"split": 1, "opt": opt, "epoch": opt.niter_decay,
                         "model_state_dict": params, "batch_stats": stats,
                         "metrics": None})
        img_dir, csv = _write_inputs(root, 600, opt.input_size_omic, gen)
        t0 = time.time()
        kron_fusion.kron_matmul.launches = 0
        written = export_model.main(
            ["--checkpoints_dir", os.path.join(root, "ckpt"),
             "--exp_name", opt.exp_name, "--model_name", opt.model_name,
             "--export_batch", str(opt.batch_size)])
        res = predict.main(
            ["--artifact", written[0], "--images_dir", img_dir,
             "--omic_csv", csv, "--batch_size", str(opt.batch_size),
             "--out", os.path.join(root, "preds.pkl"), "--quiet"])
        torch.cuda.synchronize()
        kron_launches = kron_fusion.kron_matmul.launches
        e2e_s = time.time() - t0
        files = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
        x_path = predict._load_images(files[:4], opt.input_size_path)
        x_omic = predict._load_omic(csv, files, opt.input_size_omic)[:4]
    print(f"serving path: export_model + predict on {N_IMAGES} images in "
          f"{e2e_s:.2f} s, kron_fwd launches={kron_launches} ({card})")
    if kron_launches == 0:
        raise RuntimeError("the serving path never launched kron_fwd")
    for k in ("hazard_fuse", "hazard_path", "hazard_omic", "pred_fuse",
              "pred_path", "pred_omic"):
        if res[k].shape != (N_IMAGES, opt.label_dim):
            raise RuntimeError(f"{k} has shape {res[k].shape}")
        if not np.isfinite(res[k]).all():
            raise RuntimeError(f"{k} is not finite")
    np.testing.assert_allclose(res["prob"].sum(axis=1), 1.0, rtol=1e-4)
    print("grades", res["grade"].tolist())

    # 5. fp32 cross-check: the card (kernel path, no TF32) against the CPU
    # (plain path), tolerance of tests/test_torch_import.py
    opt32 = opt.replace(compute_dtype="float32")
    outs = {}
    for where in ("cuda", "cpu"):
        m = define_model(opt32)
        m.load_state_dict(state)
        outs[where] = {k: v.cpu().numpy() for k, v in make_infer_fn(
            opt32, m.to(where))(x_path, x_omic).items()}
    for k in ("hazard_fuse", "hazard_path", "hazard_omic"):
        np.testing.assert_allclose(outs["cuda"][k], outs["cpu"][k],
                                   rtol=2e-3, atol=5e-4)
        err = np.abs(outs["cuda"][k] - outs["cpu"][k]).max()
        print(f"fp32 card vs cpu {k} max_abs_err={err:.3e} "
              f"(rtol 2e-3, atol 5e-4; {card})")
    _saliency_cross_check(opt32, state, gen, card)

    # 6. timing, with the card's name and power limit beside each number
    b, d1, d2, k = KRON_SHAPES[0]
    o1, o2, w, bias = _kron_inputs(b, d1, d2, k, gen, dev)
    w3 = w.view(k, d1, d2)   # F.bilinear's A[k, i, j] = W[j, i, k]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    floor = _time_floor(card, flush)
    a = kron_fusion._kron_vec(o1, o2)    # pre-formed for the GEMM
    fns = {
        "kernel": lambda: kron_fusion.kron_matmul(o1, o2, w, bias),
        "plain": lambda: kron_fusion.kron_matmul_plain(o1, o2, w, bias),
        "library": lambda: torch.nn.functional.bilinear(o1, o2, w3, bias),
        "gemm": lambda: torch.nn.functional.linear(a, w, bias),
    }
    times = {}
    with torch.inference_mode():
        for name, fn in fns.items():
            for cold in (False, True):
                times[name, cold] = _time_ms(fn, 50, cold, flush)
    nbytes = 4 * (b * d1 + b * d2 + k * d1 * d2 + k + b * k)
    flops = 2 * b * k * d1 * (d2 + 1)
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_FP32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    for name in fns:
        print(f"timing kron_fwd {name}_ms: L2-cold {times[name, True]:.5f} "
              f"L2-warm {times[name, False]:.5f} (B={b}, d1={d1}, d2={d2}, "
              f"K={k}; {card})")
    print(f"timing kron_fwd bound_ms={bound_ms:.5f} by {bound_by}: "
          f"{nbytes} bytes at 3.35 TB/s, {flops} flop at 67 TFLOP/s fp32; "
          f"W is {4 * k * d1 * d2 / 1e6:.2f} MB, inside the 50 MB L2, so "
          "warm calls read it from L2 and only the L2-cold time is held to "
          f"the HBM bound; {bound_ms / times['kernel', True]:.4f} of the "
          f"bound L2-cold ({card})")

    infer = make_infer_fn(opt, model.to(dev))
    xb = torch.randint(0, 256, (opt.batch_size, 512, 512, 3),
                       dtype=torch.uint8, generator=gen).to(dev)
    ob = torch.randn(opt.batch_size, opt.input_size_omic,
                     generator=gen).to(dev)
    for _ in range(3):
        infer(xb, ob)
    torch.cuda.synchronize()
    kron_fusion.kron_matmul.launches = 0
    n_iter = 20
    t0 = time.perf_counter()
    for _ in range(n_iter):
        infer(xb, ob)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    per_forward = kron_fusion.kron_matmul.launches / n_iter
    print(f"timing serve: launches_per_forward={per_forward:g}, "
          f"{opt.batch_size * n_iter / dt:.1f} patches/s ({1e3 * dt / n_iter:.3f} "
          f"ms per batch of {opt.batch_size}, bf16, 512^2, device-resident "
          f"input; {card})")
    _profile_serve(infer, xb, ob, card)
    del infer, xb, ob

    # 7. the teacher's train path at full width, and 8. the saliency pass
    stamp(7)
    state, tbatch, train_launches, step = _train_path(card, gen, dev)
    b1_launches = train_launches["kron_matmul_dropout"]
    sal_launches, sal_ms, sal_b4_ms, sal_dev_ms = _saliency_pass(
        state, tbatch, card, gen, dev)
    # 9. one fp32 train step, card against CPU
    _train_cross_check(card, gen, dev)
    # 10. the train kernels' timing
    ttimes = _time_train_kernels(gen, dev, card, flush)
    # 11. the train step under --paired_conv (B5 on the path), then both
    # steps in turns
    paired = _train_path(card, gen, dev, paired=True)
    _ab_steps(card, (("paired_conv off", step), ("paired_conv on",
                                                 paired[3])))
    teacher_sd = {k: v.detach().clone()
                  for k, v in state.model.state_dict().items()}
    del state, tbatch, step, paired
    torch.cuda.empty_cache()
    # 12. the CV drivers at full width under --paired_conv
    stamp(12)
    cv_launches = _cv_drivers(card)
    # 13. B5's timing
    ctimes = _time_conv(gen, dev, card, flush)
    # 14. the MICCAI student's step on phase 7's teacher: --teacher_bn batch
    stamp(14)
    # (B1), running (B2), and batch under --paired_conv (B5)
    students = {(bn, paired): _student_path(card, gen, dev, teacher_sd, bn,
                                            paired)
                for bn, paired in (("batch", False), ("running", False),
                                   ("batch", True))}
    torch.cuda.empty_cache()
    # 15. the M3LR t-SVD teacher's step
    tsvd = _tsvd_path(card, gen, dev)
    torch.cuda.empty_cache()
    # 16. one fp32 student step, card against CPU
    _student_cross_check(card, gen, teacher_sd)
    # 17. the MIA-2022 chain through the CLIs; its teacher serves phase 27
    stamp(17)
    mia_root = tempfile.TemporaryDirectory()
    chain = _mia_chain(card, mia_root.name)
    torch.cuda.empty_cache()
    # 18. SLIC on this machine
    stamp(18)
    rois, sp_labels, slic_stats = _slic_phase(card, gen)
    # 19. the masked CLAT teacher's step: chain, chain paired, discard
    masked = {
        ("chain", False): _masked_path(card, gen, dev, rois, sp_labels),
        ("chain", True): _masked_path(card, gen, dev, rois, sp_labels,
                                      paired=True),
        ("discard", False): _masked_path(card, gen, dev, rois, sp_labels,
                                         masking_bn="discard", n_windows=1,
                                         n_prof=0)}
    clat_teacher_sd = {k: v.detach().clone() for k, v in masked[
        "chain", False]["state"].model.state_dict().items()}
    for r in masked.values():
        del r["state"]
    torch.cuda.empty_cache()
    # 20. one fp32 masked step, card against CPU
    stamp(20)
    _masked_cross_check(card, gen, rois, sp_labels)
    # 21. the CLAT student's step on phase 19's teacher
    stamp(21)
    clat = {
        "neighbors": _clat_path(card, gen, dev, clat_teacher_sd,
                                n_windows=4, n_warm=3, n_prof=3),
        "reweight": _clat_path(card, gen, dev, clat_teacher_sd,
                               reweight_on=True),
        "centers": _clat_path(card, gen, dev, clat_teacher_sd,
                              pos_extra="centers", n_prof=3),
        "running": _clat_path(card, gen, dev, clat_teacher_sd,
                              teacher_bn="running"),
        "paired": _clat_path(card, gen, dev, clat_teacher_sd, paired=True,
                             n_prof=3)}
    torch.cuda.empty_cache()
    # 22. the MIA-2023 chain through the CLIs
    stamp(22)
    clat_chain = _clat_chain(card)
    print("MIA-2023 steps per step (bf16, 512^2, batch 16): " + "; ".join(
        f"{name}: host {r['host_ms']:.3f} ms, kernels "
        f"{r.get('kernel_ms', float('nan')):.3f} ms, busy "
        f"{100 * r.get('busy', float('nan')):.1f}%, "
        f"{r.get('syncs', float('nan')):g} syncs"
        for name, r in (("masked chain", masked["chain", False]),
                        ("masked chain paired", masked["chain", True]),
                        ("masked discard", masked["discard", False]),
                        ("CLAT neighbors", clat["neighbors"]),
                        ("CLAT centers", clat["centers"]),
                        ("CLAT paired", clat["paired"]))) + f"; SLIC "
          f"{slic_stats['ms']:.3f} ms per 512^2 ROI on the host ({card})")
    b4_step = masked["chain", False].get("kron_dvec", float("nan"))
    print(f"B4 per masked step: 1 launch, {b4_step:.5f} ms of "
          f"{masked['chain', False].get('kernel_ms', float('nan')):.3f} ms "
          f"of kernels ({card})")
    # 23. the distiller-zoo and HKD student steps on phase 7's teacher
    stamp(23)
    zoo = _zoo_paths(card, gen, dev, teacher_sd)
    torch.cuda.empty_cache()
    # 24. the one-class-SVM weighting
    stamp(24)
    svm = _svm_path(card, gen, dev, teacher_sd)
    torch.cuda.empty_cache()
    # 25. the flagship teacher step with SupCon
    stamp(25)
    supcon = _supcon_path(card, gen, dev)
    torch.cuda.empty_cache()
    # 26. fp32 rkd and hkd student steps, card against CPU; HKD at a batch
    # of 10, so that its k = 8 graphs are not complete
    stamp(26)
    _student_cross_check(card, gen, teacher_sd, distill="rkd")
    _student_cross_check(card, gen, teacher_sd, batch_size=10, distill="hkd")
    # 27. HKD through the CLIs on phase 17's teacher
    stamp(27)
    hkd_chain = _hkd_chain(card, mia_root.name)
    mia_root.cleanup()
    torch.cuda.empty_cache()
    # 28. the mmdynamics step, unpaired and paired
    stamp(28)
    dyn = {paired: _dynamics_path(card, gen, dev, paired)
           for paired in (False, True)}
    torch.cuda.empty_cache()
    # 29. the teacher step with the polynomial, LMF and HFB fusions
    stamp(29)
    fusions = _fusion_paths(card, gen, dev)
    # 30. fp32 card against CPU: one mmdynamics step, the new types' eval
    stamp(30)
    _dynamics_cross_check(card, gen)
    _fusion_eval_cross_check(card, gen)
    # 31. the mmdynamics chain through the CLIs, and its serving forward
    stamp(31)
    dyn_chain = _dynamics_chain(card, gen)
    print("A17 steps per step (bf16, 512^2, batch 16): " + "; ".join(
        f"{name}: host {r['host_ms']:.3f} ms, kernels "
        f"{r.get('kernel_ms', float('nan')):.3f} ms, busy "
        f"{100 * r.get('busy', float('nan')):.1f}%, {r['syncs']:g} syncs"
        for name, r in [("mmdynamics", dyn[False]),
                        ("mmdynamics paired", dyn[True]),
                        *((f"{f} teacher", fusions[f])
                          for f in NEW_FUSIONS)]) + f"; mmdynamics serving "
          f"{dyn_chain['serve_ms']:.3f} ms per batch of 16 ({card})")
    # 32. pretrained training: init_teacher_state and train_cv_MT
    stamp(32)
    released_root = tempfile.TemporaryDirectory()
    paths, trunk, ema_sd = _released_files(released_root.name, gen)
    pre_launches = _pretrained_path(card, released_root.name, paths, trunk)
    torch.cuda.empty_cache()
    # 33. --init_type on the same file, then AdaBound/onecycle and Adagrad
    stamp(33)
    _reinit_checks(card, paths, trunk)
    optims = _optimizer_paths(card, gen, dev, released_root.name)
    adagrad_cli = optims.pop("train_cv_MT")
    # 34. evaluating a released checkpoint with no fold checkpoint
    stamp(34)
    released_launches = _released_eval(card, released_root.name, paths,
                                       ema_sd, dev)
    torch.cuda.empty_cache()
    # 35. the torch.export artifact: export_model, predict in a fresh
    # python3, the in-process serves and their timing
    stamp(35)
    served = _exported_artifacts(card, released_root.name, ema_sd, gen, dev)
    released_root.cleanup()
    torch.cuda.empty_cache()
    # 36. the "teacher" recipe through the offline evaluation chain
    stamp(36)
    eval_chain = _eval_chain(card)
    torch.cuda.empty_cache()
    # 37. the synthetic sweep over the four recipe groups
    stamp(37)
    sweep_s = _sweep_phase(card)
    torch.cuda.empty_cache()
    # 38. data parallel at world size 1 on NCCL, and train_cv_MT
    # --data_parallel -1 in launched ranks
    stamp(38)
    dp = _data_parallel(card, gen, teacher_sd)
    print("A19 steps per step (bf16, 512^2, batch 16), data parallel at "
          "world 1 / without: " + "; ".join(
              f"{name}: host {dp[name]['host_ms']:.3f} ms, kernels "
              f"{dp[name].get('kernel_ms', float('nan')):.3f} / "
              f"{dp[name, 'plain'].get('kernel_ms', float('nan')):.3f} ms,"
              f" busy {100 * dp[name].get('busy', float('nan')):.1f}% / "
              f"{100 * dp[name, 'plain'].get('busy', float('nan')):.1f}%, "
              f"collectives {dp[name]['collectives']}, NCCL kernels "
              f"{dp[name].get('nccl count', float('nan')):g}"
              f" ({dp[name].get('nccl', float('nan')):.3f} ms), "
              f"{dp[name]['syncs']:g} syncs"
              for name in ("teacher", "MICCAI student")) + "; BatchNorm "
          f"fwd+bwd global {dp['bn']['global']:.4f} ms / cuDNN "
          f"{dp['bn']['cudnn']:.4f} ms; train_cv_MT --data_parallel -1 "
          f"{dp['cli_s']:.2f} s ({card})")
    # 39. the real input chain from 1024^2 JPEG ROIs on disk, and the
    # fold carried across packages by a JAX .snap
    stamp(39)
    jpeg = _jpeg_chain(card)
    torch.cuda.empty_cache()
    print("A10 input chain and cross-package resume: decoder "
          f"{jpeg['decoder']}, " + (
              f"{jpeg['native_ms']:.2f} ms per {JPEG_ROI}^2 ROI against "
              if jpeg["native_ms"] is not None else "")
          + f"PIL {jpeg['pil_ms']:.2f} ms; loader cache cold "
          f"{jpeg['cold_rois_per_s']:.1f} ROIs/s; .snap "
          f"{jpeg['resume']['snap_mib']:.1f} MiB, write "
          f"{jpeg['resume']['write_s']:.3f} s, read "
          f"{jpeg['resume']['read_s']:.3f} s; launches {jpeg['launches']}; "
          f"phase {jpeg['phase_s']:.1f} s ({card})")
    print("A18/A8 steps per step (bf16, 512^2, batch 16): " + "; ".join(
        f"{name}: host {r['host_ms']:.3f} ms, kernels "
        f"{r.get('kernel_ms', float('nan')):.3f} ms, busy "
        f"{100 * r.get('busy', float('nan')):.1f}%, {r['syncs']:g} syncs"
        for name, r in optims.items()) + "; serving ms per batch of 16, "
          "artifact / eager: " + ", ".join(
              f"{name} {r['artifact']:.3f} / {r['eager']:.3f}"
              for name, r in served.items() if name.startswith("export_"))
          + "; torch.ops dispatch adds " + ", ".join(
              f"{k} {v:.2f} us" for k, v in served["dispatch_us"].items())
          + f" per launch ({card})")
    print("A15 steps per step (bf16, 512^2, batch 16): " + "; ".join(
        f"{name}: host {r['host_ms']:.3f} ms, kernels "
        f"{r.get('kernel_ms', float('nan')):.3f} ms, busy "
        f"{100 * r.get('busy', float('nan')):.1f}%, {r['syncs']:g} syncs"
        for name, r in [*((f"{m} student", zoo[m]) for m in ZOO_MODES),
                        ("SVM-weighted student", svm),
                        ("SupCon teacher", supcon)]) + f" ({card})")
    print("MIA-2022 steps per step (bf16, 512^2, batch 16): " + "; ".join(
        f"{name}: host {r['host_ms']:.3f} ms, kernels "
        f"{r.get('kernel_ms', float('nan')):.3f} ms, busy "
        f"{100 * r.get('busy', float('nan')):.1f}%, {r['syncs']:g} syncs"
        for name, r in (("student batch", students["batch", False]),
                        ("student running", students["running", False]),
                        ("student paired", students["batch", True]),
                        ("t-SVD teacher", tsvd))) + f" ({card})")
    launched_by = {
        "kron_fwd": {
            "serving (export + predict)": kron_launches,
            "student step, teacher_bn running (20 steps)":
                students["running", False]["launches"]["kron_fwd"],
            "train_cv_MT --tSVD_loss evals": chain["train_cv_MT"]["kron_fwd"],
            "masked teacher step, saliency (20 steps)":
                masked["chain", False]["launches"]["kron_fwd"],
            "CLAT student step, teacher_bn running (5 steps)":
                clat["running"]["launches"]["kron_fwd"],
            "MIA-2023 CLI chain": sum(
                c["launches"]["kron_fwd"] for c in clat_chain.values()),
            "adagrad train_cv_MT eval": adagrad_cli["kron_fwd"],
            "released test_cv_MT --pretrained_path": released_launches[
                "kron_fwd"],
            "exported artifacts, predict in a fresh python3 (4 x 2 "
            "forwards)": served["predict_launches"]["kron_fwd"],
            "offline evaluation chain (train_cv_MT evals, export_model, "
            "test_cv_MT; 2 folds)": sum(
                c["kron_fwd"] for c in eval_chain.values()),
            "train_cv_MT --data_parallel -1 evals (rank 0) and "
            "test_cv_MT": dp["cli_launches"]["kron_fwd"]
            + DP_CLI_EVALS // 2,
            "JPEG input chain (train_cv_MT, test_cv_MT, the resumed "
            "fold)": jpeg["launches"]["kron_fwd"]},
        "kron_train_fwd": {
            "teacher train step (20 steps)": b1_launches,
            "student step, teacher_bn batch (20 steps)":
                students["batch", False]["launches"]["kron_train_fwd"],
            "t-SVD teacher step (20 steps)":
                tsvd["launches"]["kron_train_fwd"],
            "MIA-2022 CLI chain": chain["train_cv_MT"]["kron_train_fwd"]
            + chain["train_cv_path_multi_MT"]["kron_train_fwd"],
            "zoo and HKD student steps (6 modes x 5 steps)": sum(
                r["launches"]["kron_train_fwd"] for r in zoo.values()),
            "SVM-weighted student step (5 steps)":
                svm["launches"]["kron_train_fwd"],
            "SupCon teacher step (5 steps)":
                supcon["launches"]["kron_train_fwd"],
            "HKD CLI chain": hkd_chain["train_cv_path_multi_MT"][
                "kron_train_fwd"],
            "masked teacher step (20 steps)":
                masked["chain", False]["launches"]["kron_train_fwd"],
            "CLAT student step, teacher_bn batch (20 steps)":
                clat["neighbors"]["launches"]["kron_train_fwd"],
            "MIA-2023 CLI chain": sum(
                c["launches"]["kron_train_fwd"]
                for c in clat_chain.values()),
            "pretrained train_cv_MT": pre_launches["kron_train_fwd"],
            "adabound onecycle and adagrad steps (2 x 5 steps)": sum(
                r["launches"]["kron_train_fwd"] for r in optims.values()),
            "adagrad train_cv_MT": adagrad_cli["kron_train_fwd"],
            "offline evaluation chain train_cv_MT (2 folds)": sum(
                c["kron_train_fwd"] for c in eval_chain.values()),
            "data-parallel teacher step, world 1 (5 steps)":
                dp["teacher"]["launches"]["kron_train_fwd"],
            "data-parallel student step, world 1 (5 steps)":
                dp["MICCAI student"]["launches"]["kron_train_fwd"],
            "train_cv_MT --data_parallel -1 (rank 0)":
                dp["cli_launches"]["kron_train_fwd"],
            "JPEG input chain (train_cv_MT, the resumed fold)":
                jpeg["launches"]["kron_train_fwd"]},
        "kron_bwd_dw": {},
        "kron_bwd_dvec": {
            "saliency call": sal_launches["kron_bwd_dvec"],
            "masked teacher step (20 steps)":
                masked["chain", False]["launches"]["kron_bwd_dvec"],
            "MIA-2023 CLI chain": sum(
                c["launches"]["kron_bwd_dvec"] for c in clat_chain.values())},
        "conv3x3": {
            "cv drivers": cv_launches["conv3x3"],
            "student step, paired_conv (20 steps)":
                students["batch", True]["launches"]["conv3x3"],
            "MIA-2022 CLI chain": sum(c["conv3x3"] for c in chain.values()),
            "HKD CLI chain": sum(c["conv3x3"] for c in hkd_chain.values()),
            "masked teacher step, paired_conv (20 steps)":
                masked["chain", True]["launches"]["conv3x3"],
            "CLAT student step, paired_conv (5 steps)":
                clat["paired"]["launches"]["conv3x3"],
            "MIA-2023 CLI chain": sum(
                c["launches"]["conv3x3"] for c in clat_chain.values()),
            "mmdynamics step, paired_conv (20 steps)":
                dyn[True]["launches"]["conv3x3"],
            "mmdynamics CLI chain (train_cv_MT + test_cv_MT)":
                dyn_chain["train_cv_MT"]["conv3x3"]
                + dyn_chain["test_cv_MT"]["conv3x3"],
            "pretrained train_cv_MT": pre_launches["conv3x3"],
            "exported paired artifacts, predict in a fresh python3 (2 x 2 "
            "forwards)": served["predict_launches"]["conv3x3"],
            "JPEG input chain (train_cv_MT, test_cv_MT, the resumed "
            "fold)": jpeg["launches"]["conv3x3"]},
    }

    kernels = [{
        "name": "kron_fwd", "route": "cuda",
        "source": "multimodal_learning_tpu_torch/ops/csrc/kron_fusion.cu",
        "replaces": "multimodal_learning_tpu/ops/kron_fusion.py:46",
        "launches": kron_launches, "max_abs_err": fwd_errs["kron_fwd"],
        "ms": times["kernel", True], "plain_ms": times["plain", True],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": times["library", True],
        "bound_share": bound_ms / times["kernel", True],
        "gemm_ms": times["gemm", True], "warm_ms": times["kernel", False],
        "floor_ms": floor[True]}]
    jax_kron = "multimodal_learning_tpu/ops/kron_fusion.py"
    for name, replaces, launches in (
            ("kron_train_fwd", f"{jax_kron}:164", b1_launches),
            ("kron_bwd_dw", f"{jax_kron}:76", sal_launches["kron_bwd_dw"]),
            ("kron_bwd_dvec", f"{jax_kron}:89",
             sal_launches["kron_bwd_dvec"])):
        t, bound_ms, bound_by, spread = ttimes[name]
        src = ("kron_fusion.cu" if name == "kron_train_fwd"
               else "kron_bwd.cu")
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"multimodal_learning_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": train_errs[name], "ms": t["kernel", True],
            "plain_ms": t["plain", True], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t.get(("library", True))})
        kernels[-1].update(
            bound_share=bound_ms / t["kernel", True],
            warm_ms=t["kernel", False], p10_ms=spread["kernel"][0],
            p90_ms=spread["kernel"][1], plain_p10_ms=spread["plain"][0],
            plain_p90_ms=spread["plain"][1])
        if name == "kron_train_fwd":
            kernels[-1].update(gemm_ms=t["gemm", True], floor_ms=floor[True])
        else:
            kernels[-1]["check_launches"] = check_launches[name]
        if name == "kron_bwd_dw":
            kernels[-1]["note"] = (
                "checks and timing only: the saliency pass takes no weight "
                "gradient (in the JAX package XLA drops the unused dW), and "
                "no gradient reaches the students' frozen teacher")
        if name == "kron_bwd_dvec":
            kernels[-1].update(saliency_ms=sal_ms,
                               saliency_kernel_ms=sal_dev_ms,
                               saliency_b4_ms=sal_b4_ms,
                               masked_step_ms=b4_step)
    t, bound_ms, bound_by = ctimes[torch.bfloat16]
    t32, bound32, _ = ctimes[torch.float32]
    kernels.append({
        "name": "conv3x3", "route": "cuda",
        "source": "multimodal_learning_tpu_torch/ops/csrc/conv3x3.cu",
        "replaces": "tools/pallas_conv_proto.py:54",
        "launches": cv_launches["conv3x3"],
        "max_abs_err": max(conv_errs.values()), "ms": t["kernel", True],
        "plain_ms": t["plain", True], "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": t["library", True],
        "bound_share": bound_ms / t["kernel", True],
        "library_ratio": t["kernel", True] / t["library", True],
        "fp32_ms": t32["kernel", True], "fp32_plain_ms": t32["plain", True],
        "fp32_bound_ms": bound32, "fp32_library_ms": t32["library", True],
        "fp32_bound_share": bound32 / t32["kernel", True],
        "fp32_library_ratio": t32["kernel", True] / t32["library", True],
        "fp32_max_abs_err": conv_errs[torch.float32]})
    for k in kernels:
        k["launched_by"] = launched_by[k["name"]]
    print(f"[chip_smoke] phases 1-39 in {time.perf_counter() - t_run:.1f} s "
          f"(the sweep {sweep_s:.1f} s; {card})")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
