"""Smoke run of the PyTorch port (``multimodal_learning_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. the card: CUDA must be available; prints its name and power limit;
2. builds every CUDA kernel of the port from the sources in this checkout;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it (and a few ragged ones);
4. drives the serving path end to end at the pofusion teacher's full width
   (ResNet18 on 512^2 patches + MaxNet + Kronecker fusion, path_dim =
   omic_dim = mmhid = 128, bf16 encoders, batch 16) with seeded random
   weights: a fold checkpoint in the JAX package's layout ->
   ``cli.export_model`` -> ``cli.predict`` on 20 synthetic 600x600 PNGs and
   an omic CSV, counting the kernels' launches;
5. cross-checks the same weights' float32 forward on the card (kernel path,
   TF32 off) against the CPU (plain path);
6. times each kernel, its plain version and the one PyTorch call that
   computes the same function, and the serving forward, and breaks the
   forward's device time down by kernel with torch.profiler.

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
    print(f"build_s={time.time() - t0:.2f} built={sorted(logs)}")
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
              "atol 1e-5)")

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
          f"{e2e_s:.2f} s, kron_fwd launches={kron_launches}")
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
              "(rtol 2e-3, atol 5e-4)")

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

    kernels = [{
        "name": "kron_fwd", "route": "cuda",
        "source": "multimodal_learning_tpu_torch/ops/csrc/kron_fusion.cu",
        "replaces": "multimodal_learning_tpu/ops/kron_fusion.py:46",
        "launches": kron_launches, "max_abs_err": kron_err,
        "ms": times["kernel", True], "plain_ms": times["plain", True],
        "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": times["library", True]}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
