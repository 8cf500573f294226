"""The eval forward for serving, and its ``torch.export`` artifact.

Port of ``multimodal_learning_tpu/serve/export.py``.  The serving function
takes ``(x_path: uint8[B,S,S,3], x_omic: float32[B,D])`` and returns the
non-None branch hazards and predictions as float32, with the input
normalisation of the JAX package (``x.astype(dt)/127.5 - 1`` in the compute
dtype).  An mmdynamics model serves its fused branch alone,
``{"pred_fuse": log_softmax(mm_logit)}`` (JAX ``serve/export.py:72-77``).

That function is one module, :class:`ServingForward`: ``make_infer_fn``
runs it eagerly and ``export_infer`` exports it with ``torch.export``, so
the two cannot drift.  The artifact (``write_artifact``) is the exported
program written by ``torch.export.save`` (a ``.pt2``) and the same
``.json`` manifest sidecar as the JAX package's, with ``"format":
"torch.export"``.  The batch is fixed, or ``torch.export.Dim("b")`` for
``"dynamic"`` (JAX's symbolic ``b``), 1 to ``MAX_DYNAMIC_BATCH``.  Loading
it (``serve/load.py``) needs torch and the port's ``ops`` modules, which
register the kernels' ops; not the model code.

Deviations from the JAX package:

- one platform per artifact: the JAX artifact lowers for ``cpu`` and
  ``tpu`` at once; a port artifact holds the device it was exported on
  (``"platforms": [device type]``), because the encoders' autocast region
  bakes that device type into the graph (a bf16 graph exported on CUDA and
  moved to the CPU would run its encoders in fp32) and the weights are
  saved on that device.  ``load_exported`` raises on another device type.
- the JAX ``make_infer_fn`` reroutes a ``pallas_fusion`` model through the
  einsum only because its artifact must also lower for the CPU; the port
  keeps the Kronecker-fusion kernel (B2, ``mml::kron_fwd``) and, under
  ``--paired_conv``, the stage-1 convolution (B5, ``mml::conv3x3``) in the
  exported graph; on the CPU the same model runs their plain versions.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict

import torch
from torch import nn

from ..models.factory import _dtype, is_dynamics
from ..models.pathomic import PathomicOutput
from ..utils.logging import count, new_request, span
from .staging import CopyIn

_BRANCHES = ("hazard_fuse", "hazard_path", "hazard_omic",
             "pred_fuse", "pred_path", "pred_omic")
# The largest batch of a dynamic artifact: in fp32 on CUDA, eval-mode
# BatchNorm takes cuDNN only up to a batch of 65535 (ATen's rule), and the
# graph is traced on that side of it.
MAX_DYNAMIC_BATCH = 65535


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


class ServingForward(nn.Module):
    """The serving forward of ``model`` (kept in eval mode): uint8 patches
    and float32 omic vectors on the model's device -> a dict of float32
    branch outputs.  Both inputs are taken whatever the mode, so every
    artifact has the same calling convention."""

    def __init__(self, opt, model: nn.Module):
        super().__init__()
        _check_servable(opt)
        self.opt = opt
        self.dtype = _dtype(opt)
        self.model = model
        self.eval()

    def forward(self, x_path: torch.Tensor, x_omic: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        opt = self.opt
        x = None
        if opt.mode in ("path", "pathomic"):
            x = x_path.to(self.dtype) / 127.5 - 1.0
        if is_dynamics(opt):
            mm_logit = self.model(x, x_omic, infer=True)
            return {"pred_fuse": torch.log_softmax(mm_logit, dim=1).float()}
        if opt.mode == "pathomic":
            raw = self.model(x_path=x, x_omic=x_omic)
        else:
            raw = self.model(x if opt.mode == "path" else x_omic)
        out = adapt_output(opt, raw)
        return {k: getattr(out, k).float() for k in _BRANCHES
                if getattr(out, k) is not None}


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


def make_infer_fn(opt, model) -> Callable:
    """Serving forward of ``model`` (put in eval mode) on the device that
    holds its parameters, run eagerly.  Inputs may be numpy arrays or
    tensors on any device; outputs are float32 tensors on the model's
    device.  Each call is one request of the recorder (``utils/logging``):
    ``serve.infer`` holds ``serve.copy_in``, both inputs onto the device
    (``serve/staging.py``; counter ``serve.copy_in_bytes``, and on the card
    ``serve.copy_in_staged`` and ``serve.copy_in_waits``), and
    ``serve.forward``, enqueued behind the copy without a wait."""
    fwd = ServingForward(opt, model)
    copy_in = CopyIn(_device(model))

    def infer(x_path, x_omic) -> Dict[str, torch.Tensor]:
        new_request()
        with span("serve.infer"), torch.inference_mode():
            with span("serve.copy_in"):
                xp, xo = copy_in(x_path, x_omic)
            count("serve.copy_in_bytes", xp.nbytes + xo.nbytes)
            with span("serve.forward"):
                return fwd(xp, xo)

    return infer


def export_infer(opt, model, batch_size):
    """``torch.export`` of the serving forward on the model's device at
    ``batch_size`` (an int, or ``"dynamic"``: any batch size up to
    ``MAX_DYNAMIC_BATCH``, through ``torch.export.Dim("b")``, traced at a
    batch of 2, since export specialises a dimension traced at 1), then
    one forward of the exported program on zeros, to check it and read
    its output names.  Returns ``(exported_program, output_names)``.  Runs
    outside ``torch.inference_mode``, which export cannot trace."""
    fwd = ServingForward(opt, model)
    dev = _device(model)
    b = 2 if batch_size == "dynamic" else int(batch_size)
    s = opt.input_size_path
    args = (torch.zeros((b, s, s, 3), dtype=torch.uint8, device=dev),
            torch.zeros((b, opt.input_size_omic), device=dev))
    dynamic = None
    if batch_size == "dynamic":
        batch = torch.export.Dim("b", max=MAX_DYNAMIC_BATCH)
        dynamic = {"x_path": {0: batch}, "x_omic": {0: batch}}
    # no_grad: the kernels' registered ops stand in the graph (a CPU
    # Kronecker contraction takes its op, not its differentiable einsum)
    with torch.no_grad():
        ep = torch.export.export(fwd, args, dynamic_shapes=dynamic,
                                 strict=False)
    with torch.inference_mode():
        out = ep.module()(*args)
    return ep, sorted(out)


def manifest(opt, batch_size, outputs, device) -> Dict[str, Any]:
    """Sidecar JSON: calling convention, platform and the config that
    produced it."""
    b = "b" if batch_size == "dynamic" else batch_size
    return {
        "format": "torch.export",
        "platforms": [torch.device(device).type],
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


def write_artifact(path: str, exported, man: Dict[str, Any]) -> None:
    """``path`` (the ``.pt2`` of ``torch.export.save``) and
    ``path + ".json"`` (the manifest)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(exported, path)
    with open(path + ".json", "w") as fh:
        json.dump(man, fh, indent=1, default=str)
