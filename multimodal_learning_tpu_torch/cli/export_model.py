"""Export trained fold checkpoints as serving artifacts.

For every fold checkpoint of ``--model_name`` (in the JAX package's pickle
layout, written by either package) this writes ``<model>_<k>.pt2``, the
``torch.export`` program of the serving forward on this device (B2 and,
under ``--paired_conv``, B5 kept as registered ops), and its ``.json``
manifest with the calling convention, after serving one batch of zeros
through the exported program to check it.  ``--export_batch N`` fixes the
batch; ``--export_dynamic_batch True`` exports any batch size.  Serve it
with ``cli.predict``, on the device type it was exported on.

    python -m multimodal_learning_tpu_torch.cli.export_model \
        --model_name stage1_pathomic_teacher --mode pathomic --task grad \
        --export_batch 16

Runs on CUDA; ``MML_PLATFORM=cpu`` runs it on the CPU.
"""
from __future__ import annotations

import dataclasses
import glob
import os
import sys

from ..config import parse_args
from ..models.factory import define_model
from ..models.import_flax import state_dict_from_flax
from ..serve.export import export_infer, manifest, write_artifact
from ..utils.checkpoint import load_checkpoint
from ._platform import select_device


def export_fold(opt, ckpt_path: str, out_path: str, device) -> str:
    ckpt = load_checkpoint(ckpt_path)
    # the checkpoint's saved opt is the source of truth for the forward:
    # CLI flags with shape-invariant arch effects (act_type, skip, gates,
    # compute_dtype, ...) would otherwise export a silently different
    # function from the trained one.  CLI keeps only the export knobs.
    saved = ckpt.get("opt")
    if isinstance(saved, dict):
        cli_export_batch = opt.export_batch
        cli_dynamic = opt.export_dynamic_batch
        fields = {f.name for f in dataclasses.fields(type(opt))}
        opt = type(opt)(**{k: v for k, v in saved.items() if k in fields})
        if cli_export_batch:
            opt = opt.replace(export_batch=cli_export_batch)
        if cli_dynamic:
            opt = opt.replace(export_dynamic_batch=True)
    model = define_model(opt)
    model.load_state_dict(state_dict_from_flax(
        ckpt["model_state_dict"], ckpt.get("batch_stats", {})), strict=True)
    bs = ("dynamic" if opt.export_dynamic_batch
          else (opt.export_batch or opt.batch_size))
    exported, outputs = export_infer(opt, model.to(device), bs)
    write_artifact(out_path, exported, manifest(opt, bs, outputs, device))
    return out_path


def main(argv=None):
    device = select_device()
    opt = parse_args(argv)
    ckpt_dir = os.path.join(opt.checkpoints_dir, opt.exp_name,
                            opt.model_name)
    # prefer each fold's rolling _best checkpoint, like the test drivers
    paths = {}
    for p in sorted(glob.glob(os.path.join(
            ckpt_dir, f"{opt.model_name}_*.pt"))):
        stem = os.path.basename(p)[len(opt.model_name) + 1:-3]
        if stem.endswith("_best"):
            paths[stem[:-5]] = p
        elif stem.isdigit():
            paths.setdefault(stem, p)
    if not paths:
        raise FileNotFoundError(
            f"no fold checkpoints under {ckpt_dir!r} — train with "
            f"cli.train_cv_MT (or friends) first")
    written = []
    for k, p in sorted(paths.items()):
        out = os.path.join(ckpt_dir, f"{opt.model_name}_{k}.pt2")
        written.append(export_fold(opt, p, out, device))
        print("exported", written[-1])
    return written


if __name__ == "__main__":
    main(sys.argv[1:])
