"""Smoke run of the PyTorch port (``multimodal_learning_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. the card: CUDA must be available; prints its name and power limit;
2. builds every CUDA kernel of the port from the sources in this checkout;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving and train paths give it (and a few ragged ones): the
   eval contraction B2, the masked train contraction B1 (forward, and its
   torch backward), and B3 and B4 through ``kron_matmul(...).backward``;
4. drives the serving path end to end at the pofusion teacher's full width
   (ResNet18 on 512^2 patches + MaxNet + Kronecker fusion, path_dim =
   omic_dim = mmhid = 128, bf16 encoders, batch 16) with seeded random
   weights: a fold checkpoint in the JAX package's layout ->
   ``cli.export_model`` -> ``cli.predict`` on 20 synthetic 600x600 PNGs and
   an omic CSV, counting the kernels' launches;
5. cross-checks the same weights' float32 forward on the card (kernel path,
   TF32 off) against the CPU (plain path);
6. times B2, its plain version and the one PyTorch call that computes the
   same function, and the serving forward, and breaks the forward's device
   time down by kernel with torch.profiler;
7. drives the teacher's train path at full width (the JAX benchmark's
   flagship step: CRD with nce_k 512 + pred-KD, bf16 encoders, 512^2, two
   views, batch 16) through ``init_teacher_state`` and
   ``build_teacher_train_step``: 20 timed steps that must launch B1 twice
   each (student and EMA forward) with finite losses, then a profiled
   window of 3 steps;
8. runs the saliency pass of the masked step (eval forward under autograd,
   NLL on ``pred_fuse``, backward to the inputs and the params), which must
   launch B3 and B4;
9. cross-checks one fp32 train step on the card (kernel path, TF32 off)
   against the CPU (plain path) from the same state and views;
10. times B1, B3 and B4 against their plain versions, a PyTorch call where
    one computes the same function, and their bounds.

The next-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
CUDA is unavailable or the port's package is not beside this script.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SEED = 2019
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_FP32_FLOP_PER_S = 67e12     # fp32 outside the tensor cores
KRON_SHAPES = [(16, 129, 129, 128), (1, 129, 129, 128), (37, 129, 129, 128),
               (4, 9, 9, 16)]
N_IMAGES = 20


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


def _time_ms(fn, n, cold, flush):
    """Device time of ``fn()`` from CUDA events.  A sleep kernel queued
    first keeps the device busy while the host enqueues, so host launch
    overhead is not timed.  ``cold`` flushes the 50 MB L2 before each call
    (median of per-call times); warm is the mean over back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(4e5 * n))
    if cold:
        evs = []
        for _ in range(n):
            flush.zero_()
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            fn()
            e.record()
            evs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in evs]))
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(n):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / n


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


def _train_opt(Options, **kw):
    """The JAX benchmark's flagship train step (``bench.py:196-202``):
    pofusion teacher at the paper width, CRD + pred-KD, bf16 encoders."""
    base = dict(mode="pathomic", task="grad", path_dim=128, omic_dim=128,
                mmhid=128, feat_dim=128, input_size_path=512,
                batch_size=16, CRD_distill=1, pred_distill=1,
                num_teachers=2, pos_mode="exact", nce_p=1, nce_k=512,
                n_data=256, reg_type="omic", niter_decay=30,
                dropout_rate=0.1, compute_dtype="bfloat16",
                pallas_fusion="train")
    base.update(kw)
    return Options(**base)


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


def _profile_steps(step_fn, card, n, top=8):
    """Kernel time per train step by name (torch.profiler, CUDA activity)
    and the device's busy share of the same steps' span (CUDA events)."""
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
        print("profile train: the profiler saw no device time; kernel "
              f"breakdown not measured ({card})")
        return
    print(f"profile train: {dev_ms:.3f} ms of kernels per step, device busy "
          f"{100 * dev_ms / span_ms:.1f}% of the same steps' {span_ms:.3f} "
          f"ms span ({n} steps; {card})")
    for ev in sorted(events, key=lambda ev: -ev.self_device_time_total)[:top]:
        ms = ev.self_device_time_total / n / 1e3
        print(f"  {100 * ms / dev_ms:5.1f}% {ms:.4f} ms x{ev.count // n} "
              f"{ev.key[:90]}")


def _train_path(card, gen, dev, n_steps=20, n_warm=3, n_prof=3):
    """The teacher's train path at full width through the entry points a
    user calls: ``init_teacher_state`` from seed 2019, then
    ``build_teacher_train_step`` on a device-resident batch.  Returns the
    state, the batch and B1's launches in the timed steps."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step, init_teacher_state)

    opt = _train_opt(Options)
    state = init_teacher_state(
        opt, define_model(opt, generator=torch.Generator().manual_seed(SEED)),
        make_lr_schedule(opt, steps_per_epoch=50), opt.n_data, seed=SEED)
    batch = _train_batch(opt, gen, dev)
    train_step = build_teacher_train_step(opt)
    for _ in range(n_warm):
        train_step(state, batch, 0.1)
    torch.cuda.synchronize()
    launches = {"kron_matmul_dropout": 0, "kron_matmul": 0,
                "kron_bwd_dw": 0, "kron_bwd_dvec": 0}
    for name in launches:
        getattr(kf, name).launches = 0
    history = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        history.append(train_step(state, batch, 0.1)[1])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name in launches:
        launches[name] = getattr(kf, name).launches
    print(f"train path: {n_steps} steps, launches {launches} ({card})")
    if launches["kron_matmul_dropout"] != 2 * n_steps:
        raise RuntimeError(
            f"B1 ran {launches['kron_matmul_dropout']} times in {n_steps} "
            "steps; the student and the EMA forward launch it once each")
    for metrics in history:
        for k, v in metrics.items():
            if not torch.isfinite(v).all():
                raise RuntimeError(f"train metric {k} is not finite")
    print("train metrics, last step:", {k: round(float(v), 5)
                                        for k, v in history[-1].items()},
          f"({card})")
    print(f"timing train: {opt.batch_size * n_steps / dt:.1f} patches/s "
          f"({1e3 * dt / n_steps:.3f} ms per step of {opt.batch_size}, bf16, "
          f"512^2, 2 views, CRD nce_k {opt.nce_k}, device-resident batch; "
          f"{card})")
    _profile_steps(lambda: train_step(state, batch, 0.1), card, n_prof)
    return state, batch, launches["kron_matmul_dropout"]


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

    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train import steps

    opt = _train_opt(Options, compute_dtype="float32", dropout_rate=0.0,
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


def _saliency_pass(state, batch, card):
    """The masked step's ``cost_fn`` (``train/steps.py:396-403`` of the JAX
    package): the eval forward of the full-width model under autograd, NLL
    on ``pred_fuse``, backward to ``x_path``, ``x_omic`` and the params.
    It must run B3 and B4.  Returns their launches."""
    from multimodal_learning_tpu_torch.losses import nll_loss
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    model = state.model.eval()
    x_path = (batch["path_views"][:, 0].to(torch.bfloat16) / 127.5
              - 1.0).requires_grad_()
    x_omic = batch["omic"].clone().requires_grad_()
    state.optimizer.zero_grad()
    kf.kron_bwd_dw.launches = kf.kron_bwd_dvec.launches = 0
    out = model(x_path=x_path, x_omic=x_omic)
    nll_loss(out.pred_fuse, batch["g"]).backward()
    torch.cuda.synchronize()
    launches = (kf.kron_bwd_dw.launches, kf.kron_bwd_dvec.launches)
    state.optimizer.zero_grad()
    print(f"saliency pass: B3 launches={launches[0]}, B4 launches="
          f"{launches[1]}; |d/dx_path| max {x_path.grad.abs().max():.3e}, "
          f"|d/dx_omic| max {x_omic.grad.abs().max():.3e} ({card})")
    if min(launches) == 0:
        raise RuntimeError("the saliency pass did not launch B3 and B4")
    for name, grad in (("x_path", x_path.grad), ("x_omic", x_omic.grad)):
        if grad is None or not torch.isfinite(grad).all():
            raise RuntimeError(f"the saliency gradient to {name} is not "
                               "finite")
    return launches


def _time_train_kernels(gen, dev, card, flush):
    """Each new kernel, its plain version and, where one PyTorch call
    computes the same function, that call, at (16, 129, 129, 128); and
    each kernel's bound from the bytes it must move and the operations it
    must do.  Returns {name: (times, bound_ms, bound_by)}."""
    from multimodal_learning_tpu_torch.ops import kron_fusion as kf
    b, d1, d2, k = KRON_SHAPES[0]
    n = d1 * d2
    o1, o2, w, bias = _kron_inputs(b, d1, d2, k, gen, dev)
    maskf = ((torch.rand(b, n, generator=gen) < 0.9).float() / 0.9).to(dev)
    g = torch.randn(b, k, generator=gen).to(dev)
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
            4 * (b * d1 + b * d2 + b * k + k * n), b * d1 * k + 2 * b * n * k),
        "kron_bwd_dvec": (
            lambda: kf.kron_bwd_dvec(o1, o2, w, g),
            lambda: kf.kron_bwd_dvec_plain(o1, o2, w, g),
            None, 4 * (2 * b * d1 + 2 * b * d2 + b * k + k * n),
            4 * b * n * k + 2 * b * k * (d1 + d2)),
    }
    out = {}
    with torch.inference_mode():
        for name, (kern, plain, lib, nbytes, flops) in cases.items():
            times = {}
            for which, fn in (("kernel", kern), ("plain", plain),
                              ("library", lib)):
                if fn is None:
                    continue
                for cold in (False, True):
                    times[which, cold] = _time_ms(fn, 50, cold, flush)
            t_bytes = nbytes / H100_BYTES_PER_S
            t_ops = flops / H100_FP32_FLOP_PER_S
            bound_ms = 1e3 * max(t_bytes, t_ops)
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            for which in ("kernel", "plain", "library"):
                if (which, True) not in times:
                    print(f"timing {name} library_ms: none (no one PyTorch "
                          "call computes it)")
                    continue
                print(f"timing {name} {which}_ms: L2-cold "
                      f"{times[which, True]:.5f} L2-warm "
                      f"{times[which, False]:.5f} (B={b}, d1={d1}, d2={d2}, "
                      f"K={k}; {card})")
            print(f"timing {name} bound_ms={bound_ms:.5f} by {bound_by}: "
                  f"{nbytes} bytes at 3.35 TB/s, {flops} flop at 67 TFLOP/s "
                  f"fp32 ({card})")
            out[name] = (times, bound_ms, bound_by)
    return out


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from multimodal_learning_tpu_torch.cli import export_model, predict
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import (define_model,
                                                      flax_from_state_dict)
    from multimodal_learning_tpu_torch.ops import _build, kron_fusion
    from multimodal_learning_tpu_torch.serve import make_infer_fn
    from multimodal_learning_tpu_torch.utils import save_checkpoint

    dev = torch.device("cuda")
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

    # 3. each kernel against its plain version on the card
    gen = torch.Generator().manual_seed(SEED)
    kron_err = 0.0
    for shape in KRON_SHAPES:
        args = _kron_inputs(*shape, gen, dev)
        with torch.inference_mode():
            got = kron_fusion.kron_matmul(*args)
            want = kron_fusion.kron_matmul_plain(*args)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        kron_err = max(kron_err, err)
        print(f"kron_fwd {shape} max_abs_err={err:.3e} (rtol 1e-4, "
              f"atol 1e-5; {card})")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain versions
    train_errs = _check_train_kernels(gen, dev, card)

    # 4. the serving path end to end at the teacher's full width
    # (recipes/baseline.py "teacher" in the JAX package)
    opt = Options(mode="pathomic", task="grad", fusion_type="pofusion",
                  model_name="smoke_teacher", exp_name="grad_15",
                  path_dim=128, omic_dim=128, mmhid=128, feat_dim=128,
                  input_size_omic=80, input_size_path=512, label_dim=3,
                  act_type="LSM", skip=0, batch_size=16,
                  compute_dtype="bfloat16", pallas_fusion="train",
                  cut_fuse_grad=True, pred_distill=1, CRD_distill=0,
                  beta1=0.9, niter_decay=30)
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
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
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

    # 6. timing, with the card's name and power limit beside each number
    b, d1, d2, k = KRON_SHAPES[0]
    o1, o2, w, bias = _kron_inputs(b, d1, d2, k, gen, dev)
    w3 = w.view(k, d1, d2)   # F.bilinear's A[k, i, j] = W[j, i, k]
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    fns = {
        "kernel": lambda: kron_fusion.kron_matmul(o1, o2, w, bias),
        "plain": lambda: kron_fusion.kron_matmul_plain(o1, o2, w, bias),
        "library": lambda: torch.nn.functional.bilinear(o1, o2, w3, bias),
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
          f"the HBM bound ({card})")

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
    state, tbatch, b1_launches = _train_path(card, gen, dev)
    b3_launches, b4_launches = _saliency_pass(state, tbatch, card)
    del state, tbatch
    torch.cuda.empty_cache()
    # 9. one fp32 train step, card against CPU
    _train_cross_check(card, gen, dev)
    # 10. the train kernels' timing
    ttimes = _time_train_kernels(gen, dev, card, flush)

    kernels = [{
        "name": "kron_fwd", "route": "cuda",
        "source": "multimodal_learning_tpu_torch/ops/csrc/kron_fusion.cu",
        "replaces": "multimodal_learning_tpu/ops/kron_fusion.py:46",
        "launches": kron_launches, "max_abs_err": kron_err,
        "ms": times["kernel", True], "plain_ms": times["plain", True],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": times["library", True]}]
    jax_kron = "multimodal_learning_tpu/ops/kron_fusion.py"
    for name, replaces, launches in (
            ("kron_train_fwd", f"{jax_kron}:164", b1_launches),
            ("kron_bwd_dw", f"{jax_kron}:76", b3_launches),
            ("kron_bwd_dvec", f"{jax_kron}:89", b4_launches)):
        t, bound_ms, bound_by = ttimes[name]
        src = "kron_train.cu" if name == "kron_train_fwd" else "kron_bwd.cu"
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"multimodal_learning_tpu_torch/ops/csrc/{src}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": train_errs[name], "ms": t["kernel", True],
            "plain_ms": t["plain", True], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t.get(("library", True))})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
