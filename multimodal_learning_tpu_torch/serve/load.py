"""Load a ``torch.export`` serving artifact (``serve/export.py``).

Needs torch and the port's ``ops`` modules, imported here, which register
the ops of the kernels the graph may hold (``mml::kron_fwd``, B2;
``mml::conv3x3``, B5); not the port's model code.  An artifact holds the
one platform it was exported on (its manifest's ``platforms``): loading it
for another device type raises.

The artifact is served through its lifted graph (``graph_module``, which
takes the weights as arguments), called with the weights gathered once at
load, and not through ``ExportedProgram.module()``: that module reads
every weight through nested ``nn.Module`` attribute lookups on every call
(about a thousand for the teacher), which made the served forward slower
on the host than the eager one (PERF.md).  The input shapes are checked
here against the exported ones, as ``module()``'s pre-hook checks them.
"""
from __future__ import annotations

import json
from typing import Callable, Dict

import torch
import torch.utils._pytree as pytree
from torch.export.graph_signature import InputKind, OutputKind

from ..ops import kron_fusion, paired_conv  # noqa: F401  (register ops)
from .staging import CopyIn


def _shape_check(program) -> Callable:
    """``check(*inputs)``: raises unless each user input has its exported
    shape: static dimensions equal, a symbolic one (the dynamic batch)
    within its range and the same in every input."""
    specs = program.graph_signature.input_specs
    nodes = [n for n in program.graph_module.graph.nodes
             if n.op == "placeholder"]
    shapes = [n.meta["val"].shape for n, s in zip(nodes, specs)
              if s.kind == InputKind.USER_INPUT]
    ranges = {str(k): (int(v.lower), int(v.upper))
              for k, v in program.range_constraints.items()}

    def check(*inputs):
        seen = {}
        for x, shape in zip(inputs, shapes):
            ok = x.dim() == len(shape)
            for got, want in zip(x.shape, shape):
                if isinstance(want, torch.SymInt):
                    lo, hi = ranges[str(want)]
                    ok &= lo <= got <= hi and seen.setdefault(str(want),
                                                             got) == got
                else:
                    ok &= got == want
            if not ok:
                raise ValueError(f"input of shape {tuple(x.shape)}: the "
                                 f"artifact takes {tuple(shape)}")

    return check


def load_exported(path: str, device) -> Callable:
    """The serving function of the artifact at ``path`` on ``device``:
    inputs may be numpy arrays or tensors on any device, taken onto it as
    ``make_infer_fn`` takes them (``serve/staging.py``); outputs are
    float32 tensors on ``device``."""
    dev = torch.device(device)
    with open(path + ".json") as fh:
        platforms = json.load(fh)["platforms"]
    if dev.type not in platforms:
        raise ValueError(
            f"{path} was exported for {platforms}, not {dev.type}: an "
            "artifact holds the platform it was exported on (its autocast "
            "regions and weights); export it again on this device type")
    program = torch.export.load(path)
    sig = program.graph_signature
    if any(s.kind != OutputKind.USER_OUTPUT for s in sig.output_specs):
        raise ValueError(f"{path}: the serving graph mutates its state")
    stored = {**program.state_dict, **program.constants}
    args = [None if s.kind == InputKind.USER_INPUT else stored[s.target]
            for s in sig.input_specs]
    user = [i for i, s in enumerate(sig.input_specs)
            if s.kind == InputKind.USER_INPUT]
    graph, out_spec = program.graph_module, program.call_spec.out_spec
    check = _shape_check(program)

    copy_in = CopyIn(dev)

    def infer(x_path, x_omic) -> Dict[str, torch.Tensor]:
        inputs = copy_in(x_path, x_omic)
        check(*inputs)
        call = list(args)
        for i, x in zip(user, inputs):
            call[i] = x
        with torch.inference_mode():
            return pytree.tree_unflatten(list(graph(*call)), out_spec)

    return infer
