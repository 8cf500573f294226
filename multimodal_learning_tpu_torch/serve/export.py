"""The eval forward for serving, and its ``torch.save`` artifact.

Port of ``multimodal_learning_tpu/serve/export.py``.  The serving function
takes ``(x_path: uint8[B,S,S,3], x_omic: float32[B,D])`` and returns the
non-None branch hazards and predictions as float32, with the input
normalisation of the JAX package (``x.astype(dt)/127.5 - 1`` in the compute
dtype).

The artifact is ``torch.save({"state_dict", "manifest"})`` plus the same
``.json`` manifest sidecar as the JAX package's, with
``"format": "torch.save/state_dict"`` and ``"platforms": ["cuda", "cpu"]``.
Unlike the JAX package's StableHLO blob it needs the port's model code to
load: ``load_exported`` rebuilds the model from ``manifest["opt"]``.

Deviation from the JAX package: its ``make_infer_fn`` reroutes a
``pallas_fusion`` model through the einsum path only because its artifact
must also lower for the CPU, where a TPU kernel cannot.  The port keeps the
Kronecker-fusion kernel on the serving path; on the CPU the same model runs
the kernel's plain version.

An mmdynamics model serves its fused branch alone,
``{"pred_fuse": log_softmax(mm_logit)}`` (JAX ``serve/export.py:72-77``).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict

import torch

from ..config import Options
from ..models.factory import _dtype, define_model, is_dynamics
from ..models.pathomic import PathomicOutput

_BRANCHES = ("hazard_fuse", "hazard_path", "hazard_omic",
             "pred_fuse", "pred_path", "pred_omic")


def adapt_output(opt, raw) -> PathomicOutput:
    """Normalise MaxNet/ResNet/Pathomic outputs to PathomicOutput."""
    if isinstance(raw, PathomicOutput):
        return raw
    if opt.mode == "omic" or (isinstance(raw, tuple) and len(raw) == 3):
        feat, hazard, pred = raw
        return PathomicOutput(None, None, feat, None, None, None, hazard,
                              None, None, pred)
    f3, feat, hazard, pred = raw
    return PathomicOutput(None, feat, None, f3, None, hazard, None,
                          None, pred, None)


def _check_servable(opt) -> None:
    if getattr(opt, "test_augment", False):
        # the eval drivers apply the RANDOM train augmentation at test time
        # under this flag (MICCAI quirk); a deterministic serving artifact
        # cannot reproduce it, so refuse rather than silently diverge from
        # the numbers test_cv_* reported.
        raise ValueError(
            "--test_augment configs evaluate through random augmentation "
            "(data_loaders_MT.py:112-119 parity); the exported artifact is "
            "deterministic and would not match the reported eval numbers. "
            "Export with test_augment=False.")


def make_infer_fn(opt, model) -> Callable:
    """Serving forward of ``model`` (put in eval mode) on the device that
    holds its parameters.  Inputs may be numpy arrays or tensors on any
    device; outputs are float32 tensors on the model's device."""
    _check_servable(opt)
    model.eval()
    dev = next(model.parameters()).device
    dt = _dtype(opt)

    def infer(x_path, x_omic) -> Dict[str, torch.Tensor]:
        with torch.inference_mode():
            x_omic = torch.as_tensor(x_omic, dtype=torch.float32, device=dev)
            x = None
            if opt.mode in ("path", "pathomic"):
                x = torch.as_tensor(x_path, device=dev).to(dt) / 127.5 - 1.0
            if is_dynamics(opt):
                mm_logit = model(x, x_omic, infer=True)
                return {"pred_fuse": torch.log_softmax(mm_logit, dim=1)
                        .float()}
            if opt.mode == "pathomic":
                raw = model(x_path=x, x_omic=x_omic)
            else:
                raw = model(x if opt.mode == "path" else x_omic)
            out = adapt_output(opt, raw)
            return {k: getattr(out, k).float() for k in _BRANCHES
                    if getattr(out, k) is not None}

    return infer


def export_infer(opt, model, batch_size):
    """Serve one batch of zeros at ``batch_size`` (an int, or ``"dynamic"``:
    the artifact serves any batch size) on the model's device, to check the
    weights and read the output names from the forward itself.  Returns
    ``(state_dict, output_names)`` with the state_dict on the CPU."""
    infer = make_infer_fn(opt, model)
    b = 1 if batch_size == "dynamic" else int(batch_size)
    s = opt.input_size_path
    out = infer(torch.zeros((b, s, s, 3), dtype=torch.uint8),
                torch.zeros((b, opt.input_size_omic)))
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return state, sorted(out)


def load_exported(path: str, device) -> Callable:
    """Rebuild an artifact's model from its manifest on ``device`` and
    return its serving function."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    saved = blob["manifest"]["opt"]
    fields = {f.name for f in dataclasses.fields(Options)}
    opt = Options(**{k: v for k, v in saved.items() if k in fields})
    model = define_model(opt)
    model.load_state_dict(blob["state_dict"], strict=True)
    return make_infer_fn(opt, model.to(device))


def manifest(opt, batch_size, outputs) -> Dict[str, Any]:
    """Sidecar JSON: calling convention + the config that produced it."""
    b = "b" if batch_size == "dynamic" else batch_size
    return {
        "format": "torch.save/state_dict",
        "platforms": ["cuda", "cpu"],
        "inputs": {
            "x_path": f"uint8[{b},{opt.input_size_path},"
                      f"{opt.input_size_path},3]",
            "x_omic": f"float32[{b},{opt.input_size_omic}]",
        },
        "outputs": sorted(outputs),
        "task": opt.task,
        "mode": opt.mode,
        "opt": dataclasses.asdict(opt),
    }


def write_artifact(path: str, state_dict: Dict[str, torch.Tensor],
                   man: Dict[str, Any]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": state_dict, "manifest": man}, path)
    with open(path + ".json", "w") as fh:
        json.dump(man, fh, indent=1, default=str)
