"""One run of one cell: set-up, the measured window, the check, the result.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; everything else is found by name:

- ``configs/<config>.json``: the recipe and its options as run, the data
  sizes, which program each kind of traffic drives, and the reference;
- ``traffic/<traffic>.json``: the mix's parameters, read by the one
  generator here (its ``kind``, ``train`` or ``serve``, picks the loop);
- ``metrics/<metric>.py``: one reader per metric, ``read(run)``;
- ``reference/<reference>.py``: the configuration's plain reference;
- ``limits/<cell>.json``: the limit of each number ``correct`` compares.

A traced run (``--trace 1``) also switches on the port's own recorder of
spans and counters before set-up and collects it once the window has
closed: the readers get it as ``run.program`` (``trace.py``), and the
result's breakdown gains ``idle_by_span``.  An untraced run, which gives
the end-to-end metrics, leaves the recorder off.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, inputs
from . import trace as tracing

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "multimodal_learning_tpu")
CHECK_STEPS = 3      # the first steps, which the reference follows
WARM_STEPS = 2       # further warm-up steps before the window
WARM_CHUNKS = 3
TRACE_BLOCK = {"train": 20, "serve": 40}   # steps or chunks traced


def load_json(*parts) -> Dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def manifest() -> Dict:
    return load_json(ROOT, "BENCHMARK.json")


def find_cell(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(ROOT, c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def loaded_forbidden() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX's or the JAX
    package's, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def process_start() -> Optional[float]:
    """This process's start on the ``time.time`` clock, from /proc."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        ticks = os.sysconf("SC_CLK_TCK")
        return time.time() - uptime + int(fields[19]) / ticks
    except (OSError, ValueError, IndexError):
        return None


def options(cfg: Dict, seed: int, n_data: int):
    """The port's Options: the recipe with the configuration's
    overrides; every option the configuration states must hold."""
    from multimodal_learning_tpu_torch.recipes import get_recipe
    opt = get_recipe(cfg["recipe"], **cfg["overrides"], n_data=n_data,
                     seed=seed)
    wrong = {k: (getattr(opt, k), v) for k, v in cfg["options"].items()
             if getattr(opt, k) != v}
    if wrong:
        raise ValueError(f"{cfg['name']}: options differ from the "
                         f"configuration file: {wrong}")
    return opt


def _readers(man: Dict, cell: str, traced: bool):
    """(metric entry, read) of each metric this run reports."""
    e2e = {m["name"] for m in man["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    picked = []
    for m in man["per_layer"] if traced else man["end_to_end"]:
        if "workloads" in m:
            if cell not in m["workloads"]:
                continue
        elif traced and m["moves"] not in e2e:
            continue
        path = os.path.join(BENCH, "metrics", m["name"] + ".py")
        spec = importlib.util.spec_from_file_location(
            "perfbench_metric_" + m["name"].replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        picked.append((m, mod.read))
    return picked


class _Phases:
    """The harness's spans: host seconds per phase for every step or
    chunk of the window; inside the traced block each phase is also a
    ``record_function("pb.<phase>")``."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.traced = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = (torch.profiler.record_function(tracing.PREFIX + name)
               if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            yield
        self.spans.setdefault(name, []).append(time.perf_counter() - t0)


class _Tracer:
    """Starts the profiler at the first step or chunk past 30 % of the
    window and stops it ``block`` steps or chunks later, after a
    synchronise inside the traced block."""

    def __init__(self, on: bool, device, seconds: float, block: int,
                 phases: _Phases):
        self.on, self.device, self.block = on, device, block
        self.seconds, self.phases = seconds, phases
        self.prof = None
        self.done = 0
        self.result: Optional[tracing.Trace] = None

    def tick(self, elapsed: float) -> None:
        if not self.on or self.result is not None:
            return
        if self.prof is None and elapsed >= 0.3 * self.seconds:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self.phases.traced = True
        elif self.prof is not None:
            self.done += 1
            if self.done >= self.block:
                self.stop()

    def stop(self) -> None:
        if self.prof is None or self.result is not None:
            return
        with self.phases("sync"):
            _sync(self.device)
        self.phases.spans["sync"].pop()
        self.prof.stop()
        self.phases.traced = False
        self.result = tracing.parse(self.prof)
        self.prof = None


def _profiler_warm(device) -> None:
    """The profiler's first start in a process initialises its tracing
    library; do it in set-up, not inside the window."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts):
        torch.ones(8, device=device).add_(1)
        _sync(device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def _noise_dtype(cfg: Dict) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["options"]["compute_dtype"]]


def _reference(cfg: Dict):
    return importlib.import_module(f"perfbench.reference.{cfg['reference']}")


# --- train cells ---------------------------------------------------------

def _train(ctx) -> Dict:
    from .drivers.train import TrainProgram
    cfg, dev, s, opt = ctx.cfg, ctx.device, ctx.seeds, ctx.opt
    n, size = cfg["data"]["n_rois"], cfg["data"]["roi_size"]
    rois = inputs.images(s["rois"], n, size, dev)
    tab = inputs.tabular(s, n, opt.input_size_omic, opt.label_dim, dev)
    ctx.mark("inputs")
    prog = TrainProgram(cfg["program"]["train"], opt, rois, tab, s["loader"],
                        dev)
    shapes = {k: tuple(v.shape) for k, v in prog.tensors().items()
              if not k.startswith("ema.")}
    prog.load(inputs.make_weights(s["weights"], shapes, dev))
    prog.seed(s)
    ctx.mark("program")
    step = _faulty_step(prog, ctx.fault)

    # the first steps, through the window's own feed and call
    leaves = prog.leaves()
    start = {k: v.detach().clone() for k, v in leaves.items()}
    losses, grads = [], {}
    for t in range(CHECK_STEPS):
        losses.append(float(step(prog.next_batch())["loss"]))
        if t == 0:
            grads = {k: float(torch.linalg.vector_norm(v))
                     for k, v in prog.first_grads().items()}
    change = {k: float(torch.linalg.vector_norm(v.detach() - start[k]))
              for k, v in leaves.items()}
    del start
    got = check.Readings(losses, grads, change)
    ctx.mark("checked steps")
    for _ in range(WARM_STEPS):
        step(prog.next_batch())
    _sync(dev)
    ctx.mark("warm-up")

    phases = _Phases()
    tracer = _Tracer(ctx.trace, dev, ctx.seconds, TRACE_BLOCK["train"],
                     phases)
    steps = 0
    t_start = time.perf_counter()
    ctx.setup_s = time.time() - ctx.t0
    while True:
        with phases("data_wait"):
            batch = prog.next_batch()
        with phases("step_call"):
            step(batch)
        steps += 1
        elapsed = time.perf_counter() - t_start
        tracer.tick(elapsed)
        if elapsed >= ctx.seconds:
            break
    tracer.stop()
    _sync(dev)
    window_s = time.perf_counter() - t_start
    finite = bool(torch.stack([torch.isfinite(v).all()
                               for v in leaves.values()]).all())
    del leaves
    peak = _peak(dev)
    prog.close()
    del prog, step
    _free(dev)

    inp = _ref_inputs(ctx, rois, tab, shapes)
    want = _reference(cfg).train(cfg, inp, CHECK_STEPS)
    del inp
    _free(dev)
    numbers = check.train_numbers(got, want)
    if ctx.keep is not None:
        ctx.keep.update(got=got, want=want, inputs=(rois, tab, shapes))
    return dict(count=steps, batch=opt.batch_size, window_s=window_s,
                failed=0 if finite else steps, phases=phases, tracer=tracer,
                peak=peak, numbers=numbers)


def _faulty_step(prog, fault: Optional[str]):
    """The program's step, or the same broken underneath for the checks'
    own tests: ``frozen`` returns the state unchanged, ``half_batch``
    leaves out the second half of the batch."""
    if fault is None:
        return prog.step
    if fault == "half_batch":
        return lambda batch: prog.step(
            {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    if fault == "frozen":
        def frozen(batch):
            saved = {k: v.detach().clone() for k, v in prog.leaves().items()}
            out = prog.step(batch)
            with torch.no_grad():
                for k, v in prog.leaves().items():
                    v.copy_(saved[k])
            return out
        return frozen
    raise ValueError(f"no train fault {fault!r}")


def _ref_inputs(ctx, rois, tab, shapes) -> Dict:
    return {"device": ctx.device, "seeds": ctx.seeds, "rois": rois,
            "tab": tab, "n_data": len(rois),
            "noise_dtype": _noise_dtype(ctx.cfg),
            "weights": inputs.make_weights(ctx.seeds["weights"], shapes,
                                           ctx.device)}


def _peak(dev) -> int:
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


# --- serve cells ---------------------------------------------------------

def _serve(ctx) -> Dict:
    from .drivers.serve import ServeProgram
    cfg, dev, s, opt, tr = ctx.cfg, ctx.device, ctx.seeds, ctx.opt, ctx.traffic
    # a chunk is the configuration's batch, as a fold is evaluated at
    # opt.batch_size, unless the mix names its own
    n, b = cfg["data"]["n_rois"], tr.get("chunk", opt.batch_size)
    pool = inputs.images(s["rois"], n, opt.input_size_path, dev)
    tab = inputs.tabular(s, n, opt.input_size_omic, opt.label_dim, dev)
    omic = tab["x_omic"]
    ctx.mark("inputs")
    prog = ServeProgram(cfg["program"]["serve"], opt, dev)
    shapes = {k: tuple(v.shape) for k, v in prog.tensors().items()}
    prog.load(inputs.make_weights(s["weights"], shapes, dev))
    ctx.mark("program")
    infer = _faulty_infer(prog, ctx, shapes)
    starts = [(b * j) % (n - b + 1) for j in range(WARM_CHUNKS)]
    for lo in starts:
        for v in infer(pool[lo:lo + b], omic[lo:lo + b]).values():
            v.cpu()
    _sync(dev)
    ctx.mark("warm-up")

    phases = _Phases()
    tracer = _Tracer(ctx.trace, dev, ctx.seconds, TRACE_BLOCK["serve"],
                     phases)
    served = []
    t_start = time.perf_counter()
    ctx.setup_s = time.time() - ctx.t0
    j = 0
    while True:
        lo = (b * j) % (n - b + 1)
        xp, xo = pool[lo:lo + b], omic[lo:lo + b]
        t0 = time.perf_counter()
        with phases("infer_call"):
            out = infer(xp, xo)
        with phases("readback"):
            res = {k: v.cpu().numpy() for k, v in out.items()}
        phases.spans.setdefault("chunk", []).append(time.perf_counter() - t0)
        served.append((lo, res))
        j += 1
        elapsed = time.perf_counter() - t_start
        tracer.tick(elapsed)
        if elapsed >= ctx.seconds:
            break
    tracer.stop()
    window_s = time.perf_counter() - t_start
    failed = sum(1 for _, res in served
                 if not all(np.isfinite(v).all() for v in res.values()))
    peak = _peak(dev)
    prog.close()
    del prog, infer
    _free(dev)

    rng = np.random.default_rng(s["sample"])
    n_check = max(1, tr["check_rows"] // b)
    pick = rng.choice(len(served), min(n_check, len(served)),
                      replace=False)
    weights = inputs.make_weights(s["weights"], shapes, dev)
    ref = _reference(cfg)
    got, want = {}, {}
    for i in sorted(pick):
        lo, res = served[i]
        r = ref.serve(cfg, weights, torch.as_tensor(pool[lo:lo + b],
                                                    device=dev),
                      torch.as_tensor(omic[lo:lo + b], device=dev))
        for k, v in r.items():
            if k in res:
                got.setdefault(k, []).append(res[k])
            want.setdefault(k, []).append(v.cpu().numpy())
    del weights
    _free(dev)
    got = {k: np.concatenate(v) for k, v in got.items()}
    want = {k: np.concatenate(v) for k, v in want.items()}
    numbers = check.serve_numbers(got, want)
    if ctx.keep is not None:
        ctx.keep.update(got=got, want=want, pool=pool, omic=omic,
                        rows=[served[i][0] for i in sorted(pick)],
                        shapes=shapes)
    return dict(count=j, batch=b, window_s=window_s, failed=failed,
                phases=phases, tracer=tracer, peak=peak, numbers=numbers)


def _faulty_infer(prog, ctx, shapes):
    """The serving call, or the same broken for the checks' own tests and
    the control: ``altered``, the first row's answers altered where they
    are produced; ``dropped``, one branch's answers left out; ``fp8``,
    the plain reference computed in fp8 (the precision below the
    configuration's bf16) in the program's place."""
    fault = ctx.fault
    if fault is None:
        return prog
    if fault == "altered":
        def altered(xp, xo):
            out = prog(xp, xo)
            return {k: torch.cat([v[:1] + 1.0, v[1:]]) for k, v in out.items()}
        return altered
    if fault == "dropped":
        def dropped(xp, xo):
            out = prog(xp, xo)
            gone = min(k for k in out if k.startswith("hazard_"))
            return {k: v for k, v in out.items() if k != gone}
        return dropped
    if fault == "fp8":
        weights = inputs.make_weights(ctx.seeds["weights"], shapes,
                                      ctx.device)
        ref = _reference(ctx.cfg)

        def fp8(xp, xo):
            out = ref.serve(ctx.cfg, weights,
                            torch.as_tensor(xp, device=ctx.device),
                            torch.as_tensor(xo, device=ctx.device),
                            quant="fp8")
            return {k: v for k, v in out.items() if k.startswith("hazard_")}
        return fp8
    raise ValueError(f"no serve fault {fault!r}")


# --- one run ---------------------------------------------------------------

def run(workload: str, seed: int, seconds: float, traced: bool,
        device="cuda", scale: Optional[Dict] = None,
        fault: Optional[str] = None, t0: Optional[float] = None,
        keep: Optional[Dict] = None, man: Optional[Dict] = None) -> Dict:
    """The result of one run as a dict with the contract's keys (and
    ``check`` last).  ``man`` is the manifest that holds the cell and its
    metrics, ``BENCHMARK.json`` unless given (the tests drive cells that
    it does not hold yet); ``scale`` (tests only) merges smaller sizes
    into the configuration: ``{"options": ..., "data": ..., "traffic":
    ...}``; ``fault`` breaks the timed path underneath (the checks' tests
    and the control); ``keep`` collects both sides' raw readings, the
    set-up's stages and the window's spans."""
    man = manifest() if man is None else man
    cell = find_cell(man, workload)
    cfg = config_of(man, cell["config"])
    tr = load_json(BENCH, "traffic", cell["traffic"] + ".json")
    limits = load_json(BENCH, "limits", workload + ".json")
    if scale:
        cfg = {**cfg, "options": {**cfg["options"], **scale["options"]},
               "overrides": {**cfg["overrides"], **scale["options"]},
               "data": {**cfg["data"], **scale.get("data", {})}}
        tr = {**tr, **scale.get("traffic", {})}
    dev = torch.device(device)
    s = inputs.seeds(seed)
    opt = options(cfg, s["sampler"], cfg["data"]["n_rois"])
    ctx = SimpleNamespace(cfg=cfg, traffic=tr, device=dev, seeds=s, opt=opt,
                          seconds=seconds, trace=traced, fault=fault,
                          t0=t0 if t0 is not None else time.time(),
                          setup_s=None, keep=keep, stages=[])
    ctx.mark = lambda name: ctx.stages.append((name, time.time()))
    ctx.mark("imports")
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)
        ctx.mark("cuda context")
    if traced:
        _profiler_warm(dev)
        ctx.mark("profiler")
    kind = tr["kind"]
    from multimodal_learning_tpu_torch.utils import logging as recorder
    if traced:
        recorder.enable()
    try:
        out = {"train": _train, "serve": _serve}[kind](ctx)
    finally:
        program = recorder.collect() if traced else None

    tracer = out["tracer"]
    run_ = SimpleNamespace(
        kind=kind, cell=cell, cfg=cfg, traffic=tr, opt=opt,
        count=out["count"], batch=out["batch"], window_s=out["window_s"],
        setup_s=ctx.setup_s, spans=out["phases"].spans,
        trace=tracer.result, traced_count=tracer.done, device=dev,
        program=program)
    metrics = {}
    for m, read in _readers(man, workload, traced):
        v = read(run_)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    numbers = check.judge(out["numbers"], limits)
    correct = out["failed"] == 0 and all(
        n["value"] <= n["limit"] for n in numbers.values())
    dev_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell["chips"], "memory_peak_bytes": out["peak"]}
    result = {"correct": bool(correct), "attempted": out["count"],
              "failed": out["failed"], "metrics": metrics,
              "device": dev_info}
    if traced:
        t = tracer.result
        dev_info["busy_s"] = tracing.busy_s(t) if t else 0.0
        dev_info["window_s"] = t.window_s if t else 0.0
        if t is not None:
            result["breakdown"] = {"device_ops": tracing.device_ops(t),
                                   "idle_gaps": tracing.idle_gaps(t),
                                   "idle_by_span": tracing.idle_by_span(t)}
    result["check"] = numbers
    if ctx.keep is not None:
        ctx.keep["stages"] = _stages(ctx)
        ctx.keep["window"] = {"count": out["count"],
                              "seconds": out["window_s"],
                              "ms": {k: 1e3 * float(np.mean(v)) for k, v
                                     in out["phases"].spans.items() if v}}
    return result


def _stages(ctx) -> List:
    """Seconds of each stage of set-up, from the process's start."""
    out, t = [], ctx.t0
    for name, at in ctx.stages:
        out.append([name, at - t])
        t = at
    return out

