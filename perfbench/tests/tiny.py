"""Tiny sizes at which the tests drive each cell's code path on the CPU:
every width cut, fp32 encoders, a handful of small ROIs.  The train
cells, built and proven but not yet in ``BENCHMARK.json`` (PERF.md §7),
are driven through the entries below, which ``harness.run`` takes as the
manifest beside the real one."""
from __future__ import annotations

import copy

OPTIONS = {"path_dim": 8, "omic_dim": 8, "mmhid": 8, "feat_dim": 8,
           "input_size_path": 32, "batch_size": 4,
           "compute_dtype": "float32", "host_workers": 2}
CLAT = {"nce_k": 8, "nce_p": 2}
TRAIN_CELLS = ("pofusion_teacher.train", "clat_student.train")
CELLS = TRAIN_CELLS + ("clat_student.serve", "pofusion_teacher.serve")

_WHY = {
    "pofusion_teacher.train": "every teacher fold's main path: batch 64 of "
    "two 512^2 crops from 1024^2 ROIs through the loader's 4 threads; "
    "encoders, B1 twice, EMA",
    "clat_student.train": "the distillation the papers deliver: batch 64 "
    "through the loader, frozen teacher (B1), kNN over 1204-row banks, "
    "4097-row contrast, GK-Refine"}
# (name, unit, better, source, layer) of each train metric
_TRAIN_METRICS = (
    ("data_wait_ms.train", "ms", "lower", "program_span", "input pipeline"),
    ("step_call_ms.train", "ms", "lower", "program_span", "train step"),
    ("launches_per_step.train", "launches", "lower", "device_trace",
     "train step"),
    ("kron_train_fwd_roofline", "%", "higher", "device_trace", "kernels"),
    ("device_idle.train", "%", "lower", "device_trace", "device"),
    ("mfu.train", "%", "higher", "host_clock", "device"),
    # read from the port's recorder, on in traced runs
    ("loader_batch_ms.train", "ms", "lower", "program_span",
     "input pipeline"),
    ("batch_ready.train", "%", "higher", "program_counter",
     "input pipeline"),
    ("forward_dispatch_ms.train", "ms", "lower", "program_span",
     "train step"),
    ("backward_dispatch_ms.train", "ms", "lower", "program_span",
     "train step"),
    ("optimizer_dispatch_ms.train", "ms", "lower", "program_span",
     "train step"))


def manifest():
    """``BENCHMARK.json`` with the train cells and their metrics added as
    a later change would add them."""
    from perfbench import harness
    man = copy.deepcopy(harness.manifest())
    cells = list(TRAIN_CELLS)
    man["workloads"] += [{"name": c, "config": c.split(".")[0],
                          "traffic": "train_loader", "chips": 1,
                          "why": _WHY[c]} for c in cells]
    man["end_to_end"].append({"name": "train_patches_per_s",
                              "unit": "patches/s", "better": "higher",
                              "bound": 0.25, "source": "host_clock",
                              "workloads": cells})
    man["per_layer"] += [{"name": n, "unit": u, "better": b, "source": s,
                          "layer": layer, "moves": "train_patches_per_s",
                          "workloads": cells}
                         for n, u, b, s, layer in _TRAIN_METRICS]
    return man


def scale(cell: str):
    extra = CLAT if cell.startswith("clat_student") else {}
    return {"options": {**OPTIONS, **extra},
            "data": {"n_rois": 16, "roi_size": 40},
            "traffic": {"check_rows": 8}}


def run(cell: str, seed: int = 3000000019, seconds: float = 0.5,
        traced: bool = False, fault=None, keep=None):
    import torch
    from perfbench import harness
    torch.set_num_threads(2)
    return harness.run(cell, seed, seconds, traced, device="cpu",
                       scale=scale(cell), fault=fault, keep=keep,
                       man=manifest())
