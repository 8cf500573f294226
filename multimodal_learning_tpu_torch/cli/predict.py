"""Serve predictions from an exported artifact.

Port of ``multimodal_learning_tpu/cli/predict.py`` with the same flags:
train -> export (``cli.export_model``) -> predict (this).  ``--artifact``
takes the port's ``<model>_<k>.pt2`` (a ``torch.export`` program); its
``.json`` manifest carries the calling convention and the platform it was
exported on.  Loading it needs torch and the port's ``ops`` modules, not
its model code.

    python -m multimodal_learning_tpu_torch.cli.predict \
        --artifact ckpt/grad_15/vt/vt_1.pt2 \
        --images_dir rois/ --omic_csv omic.csv --out preds.pkl

Images are decoded with PIL and deterministically CENTER-cropped/padded to
the artifact's input size.  The omic CSV is positional (row i pairs with
image i); if its first column is non-numeric it is treated as a filename
key matched against image basenames instead.  Runs on CUDA;
``MML_PLATFORM=cpu`` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import re
import sys

import numpy as np

from ._platform import select_device

_IMG_EXTS = (".jpg", ".jpeg", ".png")


def _parse_spec(spec: str):
    """'uint8[b,64,64,3]' -> (dtype, ['b'|int, ...])."""
    m = re.fullmatch(r"(\w+)\[([\w,]+)\]", spec)
    if not m:
        raise ValueError(f"unparseable manifest input spec: {spec!r}")
    dims = [d if not d.isdigit() else int(d) for d in m.group(2).split(",")]
    return m.group(1), dims


def _center_crop(img: np.ndarray, s: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h < s or w < s:  # pad symmetrically like data/pipeline.py crops()
        ph, pw = max(0, s - h), max(0, s - w)
        img = np.pad(img, ((ph // 2, ph - ph // 2),
                           (pw // 2, pw - pw // 2), (0, 0)))
        h, w = img.shape[:2]
    top, left = (h - s) // 2, (w - s) // 2
    return img[top:top + s, left:left + s]


def _decode(path) -> np.ndarray:
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _load_images(paths, s: int) -> np.ndarray:
    return np.stack([_center_crop(np.asarray(_decode(p), np.uint8), s)
                     for p in paths])


def _load_omic(csv_path: str, files, d: int) -> np.ndarray:
    import pandas as pd
    df = pd.read_csv(csv_path)
    if len(df) == 0:  # header-only CSV (0-row dtypes also defeat key sniff)
        raise ValueError(f"no input rows to predict on: {csv_path} has a "
                         "header but no data rows")
    first = df.columns[0]
    if not pd.api.types.is_numeric_dtype(df[first]):  # filename-keyed
        key = {os.path.basename(str(k)): i
               for i, k in enumerate(df[first].values)}
        vals = df.drop(columns=[first]).to_numpy(np.float32)
        rows = []
        for f in files:
            b = os.path.basename(str(f))
            if b not in key:
                raise KeyError(f"omic csv has no row keyed {b!r}")
            rows.append(vals[key[b]])
        omic = np.stack(rows)
    else:
        omic = df.to_numpy(np.float32)
        if files is not None and len(omic) != len(files):
            # a longer CSV silently truncated would mispair rows with the
            # sorted-basename image order — refuse, point at keyed mode
            raise ValueError(
                f"omic csv has {len(omic)} rows for {len(files)} images; "
                "positional pairing requires an exact match (use a "
                "filename-keyed first column to pair by name)")
    if omic.shape[1] != d:
        raise ValueError(f"omic csv has {omic.shape[1]} feature columns; "
                         f"the artifact expects {d}")
    return np.ascontiguousarray(omic, np.float32)


def _batched(fn, x_path, x_omic, fixed_b, chunk):
    """Run fn over slices; pad the ragged tail for fixed-shape artifacts."""
    n = len(x_path)
    if n == 0:  # e.g. a mode=omic artifact fed a header-only --omic_csv
        raise ValueError("no input rows to predict on (empty image list / "
                         "omic csv)")
    b = fixed_b or chunk
    outs = []
    for lo in range(0, n, b):
        xp, xo = x_path[lo:lo + b], x_omic[lo:lo + b]
        take = len(xp)
        if fixed_b and take < b:  # pad by repeating the first row, trim after
            pad = b - take
            xp = np.concatenate([xp, np.repeat(xp[:1], pad, 0)])
            xo = np.concatenate([xo, np.repeat(xo[:1], pad, 0)])
        res = fn(xp, xo)
        outs.append({k: np.asarray(v)[:take] for k, v in res.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(
        "predict", description="serve an exported .pt2 artifact")
    ap.add_argument("--artifact", required=True,
                    help="path to the .pt2 artifact (manifest at "
                         "+'.json')")
    ap.add_argument("--images", nargs="*", default=None,
                    help="ROI image files (jpg/png), order defines rows")
    ap.add_argument("--images_dir", default=None,
                    help="directory of ROI images (sorted)")
    ap.add_argument("--omic_csv", default=None,
                    help="CSV of omic features (header row required); "
                         "positional rows, or filename-keyed when the "
                         "first column is text")
    ap.add_argument("--batch_size", type=int, default=16,
                    help="chunk size for batch-polymorphic artifacts")
    ap.add_argument("--out", default=None, help="write predictions pickle")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    device = select_device()

    with open(args.artifact + ".json") as fh:
        man = json.load(fh)
    _, path_dims = _parse_spec(man["inputs"]["x_path"])
    _, omic_dims = _parse_spec(man["inputs"]["x_omic"])
    fixed_b = path_dims[0] if isinstance(path_dims[0], int) else 0
    size, d_omic = path_dims[1], omic_dims[1]

    files = list(args.images or [])
    if args.images_dir:
        files += sorted(
            os.path.join(args.images_dir, f)
            for f in os.listdir(args.images_dir)
            if f.lower().endswith(_IMG_EXTS))

    if files:
        x_path = _load_images(files, size)
        n = len(files)
    elif man.get("mode") == "omic" and args.omic_csv:
        # unimodal omic artifact: the (unused) image input is zeros
        x_omic = _load_omic(args.omic_csv, None, d_omic)
        n = len(x_omic)
        x_path = np.zeros((n, size, size, 3), np.uint8)
        files = [f"row{i}" for i in range(n)]
    else:
        ap.error("no inputs: pass --images/--images_dir (or --omic_csv "
                 "for a mode=omic artifact)")
    if args.omic_csv:
        x_omic = _load_omic(args.omic_csv, files if args.images or
                            args.images_dir else None, d_omic)
    elif man.get("mode") != "path":
        print(f"warning: mode={man.get('mode')} artifact with no "
              f"--omic_csv — omic features are zeros", file=sys.stderr)
        x_omic = np.zeros((n, d_omic), np.float32)
    else:
        x_omic = np.zeros((n, d_omic), np.float32)

    from ..serve import load_exported
    infer = load_exported(args.artifact, device)

    def fn(xp, xo):
        return {k: v.cpu().numpy() for k, v in infer(xp, xo).items()}

    res = _batched(fn, x_path, x_omic, fixed_b, args.batch_size)

    task = man.get("task", "grad")
    branch = next((k for k in ("pred_fuse", "pred_path", "pred_omic",
                               "hazard_fuse", "hazard_path", "hazard_omic")
                   if k in res), None)
    if task == "grad" and branch and branch.startswith("pred"):
        res["prob"] = np.exp(res[branch])  # branches are log-softmax
        res["grade"] = res[branch].argmax(axis=1).astype(np.int32)
    if not args.quiet:
        for i, f in enumerate(files[:32]):
            if task == "grad" and "grade" in res:
                p = ", ".join(f"{v:.3f}" for v in res["prob"][i])
                print(f"{f}\tgrade={int(res['grade'][i])}\tprob=[{p}]")
            elif branch:
                print(f"{f}\t{branch}={float(res[branch][i].ravel()[0]):.5f}")
        if len(files) > 32:
            print(f"... ({len(files) - 32} more)")
    if args.out:
        with open(args.out, "wb") as fh:
            pickle.dump({"files": files, **res}, fh)
        print("wrote", args.out)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
