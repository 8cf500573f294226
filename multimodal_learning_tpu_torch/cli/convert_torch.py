"""Convert torch checkpoints to the ``--pretrained_path`` .npz format.

Port of ``multimodal_learning_tpu/cli/convert_torch.py``, with the same
flags and the same output: an ``.npz`` this writes loads in the JAX
package, and the other way round.  Replaces the reference's in-process
torchvision download+load (``MICCAI-2022/resnets.py:275-284``): conversion
happens once, offline, and training consumes a plain .npz.

    python -m multimodal_learning_tpu_torch.cli.convert_torch \
        --src resnet18-f37072fd.pth --dst resnet18_imagenet.npz

    # a released PathomicNet checkpoint's EMA weights
    python -m multimodal_learning_tpu_torch.cli.convert_torch \
        --src pathomic_1_best.pt --dst teacher_1.npz --arch pathomic \
        --state_key ema_model_state_dict

``--arch resnet18`` (default) accepts both torchvision ImageNet files and
the reference's ResNet-with-fc_new-heads state_dicts (``--prefix path_net.``
strips a container prefix); ``--arch pathomic`` converts a whole model
of any fusion type (``--prefix`` unused, as in the JAX package).  Runs on
the CPU.
"""
from __future__ import annotations

import argparse
import sys

from ..models.import_torch import (convert_state_dict, flatten_tree,
                                   load_torch_state_dict, save_pretrained_npz)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", required=True, help=".pth/.pt torch checkpoint")
    ap.add_argument("--dst", required=True, help="output .npz")
    ap.add_argument("--arch", default="resnet18",
                    choices=["resnet18", "pathomic"])
    ap.add_argument("--prefix", default="",
                    help="state_dict key prefix to convert under "
                         "(e.g. 'path_net.')")
    ap.add_argument("--state_key", default="model_state_dict",
                    help="which state dict to extract from a released "
                         "wrapper checkpoint (model_state_dict or "
                         "ema_model_state_dict; train_cv_MT.py:119-130)")
    args = ap.parse_args(argv)

    sd = load_torch_state_dict(args.src, state_key=args.state_key)
    params, stats = convert_state_dict(sd, args.arch, args.prefix)
    save_pretrained_npz(args.dst, params, stats)
    n = len(flatten_tree(params)) + len(flatten_tree(stats))
    print(f"wrote {args.dst}: {n} tensors ({args.arch})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
