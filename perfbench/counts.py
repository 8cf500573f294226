"""Operations and bytes computed from shapes, and the H100's published peaks.

The yardstick of every roofline share and MFU the benchmark reports.  The
peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at
the full 700 W power limit.  Only multiply-accumulates of convolutions,
linear layers, bilinear forms, attention's two products and the contrast
products are counted (one MAC = 2 FLOP); normalisation, activations,
softmax, pooling and the optimizer are left out, as MFU conventionally
does.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

H100_BYTES_PER_S = 3.35e12      # HBM3
H100_FP32_FLOP_PER_S = 67e12     # fp32 outside the tensor cores
H100_BF16_FLOP_PER_S = 989e12    # dense bf16 on the tensor cores


def _out(size: int, k: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - k) // stride + 1


# the trunk of a configuration that names none
RESNET18 = {"kind": "resnet", "stages": (2, 2, 2, 2), "block": "basic"}


def _heads(width: int, path_dim: int, n_classes: int,
           imagenet_head: bool) -> List[Tuple[str, int]]:
    """The port's grading heads on a trunk of ``width`` features
    (``fc_new1`` width -> path_dim, ``fc_new2`` path_dim -> n_classes), or
    with ``imagenet_head`` the published 1000-class classifier."""
    if imagenet_head:
        return [("fc", width * 1000)]
    return [("fc_new1", width * path_dim), ("fc_new2", path_dim * n_classes)]


def resnet_layers(size: int, stages, block: str, path_dim: int = 128,
                  n_classes: int = 3, imagenet_head: bool = False) -> List[Tuple[str, int]]:
    """(name, MACs per image) of each convolution and linear layer of a
    torchvision ResNet trunk at ``size``² with ``stages`` blocks per stage,
    ``basic`` (two 3x3s; ResNet18/34) or ``bottleneck`` (1x1, strided 3x3,
    1x1 at four times the planes; ResNet50 v1.5), and its heads
    (:func:`_heads`)."""
    expansion = {"basic": 1, "bottleneck": 4}[block]
    layers = []
    h = _out(size, 7, 2, 3)
    layers.append(("conv1", 64 * 3 * 49 * h * h))
    h = _out(h, 3, 2, 1)                        # max pool
    cin = 64
    for stage, (planes, n) in enumerate(zip((64, 128, 256, 512), stages), 1):
        cout = planes * expansion
        for blk in range(n):
            stride = 2 if stage > 1 and blk == 0 else 1
            ho = _out(h, 3, stride, 1)
            name = f"layer{stage}.{blk}"
            if block == "basic":
                layers.append((f"{name}.conv1", planes * cin * 9 * ho * ho))
                layers.append((f"{name}.conv2",
                               planes * planes * 9 * ho * ho))
            else:
                layers.append((f"{name}.conv1", planes * cin * h * h))
                layers.append((f"{name}.conv2",
                               planes * planes * 9 * ho * ho))
                layers.append((f"{name}.conv3", cout * planes * ho * ho))
            if stride != 1 or cin != cout:
                layers.append((f"{name}.downsample", cout * cin * ho * ho))
            cin, h = cout, ho
    return layers + _heads(cin, path_dim, n_classes, imagenet_head)


def resnet18_layers(size: int, **kw) -> List[Tuple[str, int]]:
    return resnet_layers(size, (2, 2, 2, 2), "basic", **kw)


def vit_layers(size: int, patch: int, depth: int, width: int, heads: int,
               mlp: int, path_dim: int = 128, n_classes: int = 3,
               imagenet_head: bool = False) -> List[Tuple[str, int]]:
    """(name, MACs per image) of a ViT trunk at ``size``²: the patch
    embedding, then in each of ``depth`` pre-norm blocks over the
    (size / patch)² patch tokens and the class token the qkv projection,
    the two attention products (q k^T and the weights times v, over
    ``heads`` heads of width / heads), the output projection and the MLP's
    two layers; and the heads (:func:`_heads`) on the class token."""
    n_patches = (size // patch) ** 2
    n = n_patches + 1
    d = width // heads
    layers = [("patch_embed", width * 3 * patch * patch * n_patches)]
    for i in range(depth):
        b = f"blocks.{i}"
        layers += [(f"{b}.attn.qkv", n * width * 3 * width),
                   (f"{b}.attn.scores", heads * n * n * d),
                   (f"{b}.attn.values", heads * n * n * d),
                   (f"{b}.attn.proj", n * width * width),
                   (f"{b}.mlp.fc1", n * width * mlp),
                   (f"{b}.mlp.fc2", n * mlp * width)]
    return layers + _heads(width, path_dim, n_classes, imagenet_head)


def trunk_layers(trunk, size: int, path_dim: int = 128,
                 n_classes: int = 3) -> List[Tuple[str, int]]:
    """The layers of the pathology trunk a configuration's ``"trunk"``
    names (``{"kind": "resnet", "stages": ..., "block": ...}`` or
    ``{"kind": "vit", "patch": ..., "depth": ..., "width": ..., "heads":
    ..., "mlp": ...}``); ResNet18 where it names none."""
    args = dict(trunk or RESNET18)
    kind = args.pop("kind")
    build = {"resnet": resnet_layers, "vit": vit_layers}[kind]
    return build(size, path_dim=path_dim, n_classes=n_classes, **args)


def attention_fwd_cost(b: int, heads: int, n: int, d: int) -> Dict:
    """One attention forward over ``b`` images of ``n`` tokens and
    ``heads`` heads of ``d``: the two products in bf16 on the tensor
    cores; reads q, k and v and writes o, in bf16."""
    return {"bytes": 2 * 4 * b * heads * n * d,
            "flop": 4 * b * heads * n * n * d,
            "flop_per_s": H100_BF16_FLOP_PER_S}


def resnet18_macs(size: int, **kw) -> int:
    return sum(m for _, m in resnet18_layers(size, **kw))


def maxnet_macs(input_dim: int = 80, omic_dim: int = 128,
                n_classes: int = 3) -> int:
    dims = (input_dim, 64, 48, 32, omic_dim)
    return (sum(a * b for a, b in zip(dims, dims[1:]))
            + omic_dim * n_classes)


def pofusion_macs(dim1: int = 128, dim2: int = 128, mmhid: int = 128,
                  n_classes: int = 3) -> int:
    """Both gated units (linear_h, the bilinear z, linear_o), the
    Kronecker contraction of ``encoder1`` over (d1+1)(d2+1), ``encoder2``
    and the classifier."""
    units = sum(d_self * d_self + dim1 * dim2 * d_self + d_self * d_self
                for d_self in (dim1, dim2))
    kron = (dim1 + 1) * (dim2 + 1) * mmhid
    return units + kron + mmhid * mmhid + mmhid * n_classes


def pathomic_fwd_macs(size: int, path_dim: int, omic_dim: int, mmhid: int,
                      input_dim: int = 80, n_classes: int = 3,
                      trunk=None) -> int:
    return (sum(m for _, m in trunk_layers(trunk, size, path_dim, n_classes))
            + maxnet_macs(input_dim, omic_dim, n_classes)
            + pofusion_macs(path_dim, omic_dim, mmhid, n_classes))


def resnet18_train_macs(size: int, path_dim: int, n_classes: int = 3
                        ) -> int:
    """Forward, weight gradient and input gradient of every layer, except
    the input gradient of the stem, which nothing asks for."""
    layers = resnet18_layers(size, path_dim=path_dim, n_classes=n_classes)
    fwd = sum(m for _, m in layers)
    return 3 * fwd - layers[0][1]


def teacher_train_flops_per_patch(size: int, path_dim: int, omic_dim: int,
                                  mmhid: int, input_dim: int = 80,
                                  n_classes: int = 3) -> float:
    """The mean-teacher step per patch: the student's forward and backward
    (trunk as :func:`resnet18_train_macs`; MaxNet and fusion three times
    their forward) and the EMA model's forward."""
    head = (maxnet_macs(input_dim, omic_dim, n_classes)
            + pofusion_macs(path_dim, omic_dim, mmhid, n_classes))
    student = resnet18_train_macs(size, path_dim, n_classes) + 3 * head
    ema = pathomic_fwd_macs(size, path_dim, omic_dim, mmhid, input_dim,
                            n_classes)
    return 2.0 * (student + ema)


def clat_student_train_flops_per_patch(size: int, path_dim: int,
                                       omic_dim: int, mmhid: int,
                                       feat_dim: int, n_data: int,
                                       nce_k: int, nce_p: int,
                                       input_dim: int = 80,
                                       n_classes: int = 3) -> float:
    """The CLAT student step per patch: the path-only student's forward
    and backward, its EMA's forward, the frozen multimodal teacher's
    forward, the four CRD heads (forward and backward), and for each of
    the two banks the kNN over its rows and the scores of both sides over
    (nce_p + nce_k) rows, forward and backward."""
    student = resnet18_train_macs(size, path_dim, n_classes)
    ema = resnet18_macs(size, path_dim=path_dim, n_classes=n_classes)
    teacher = pathomic_fwd_macs(size, path_dim, omic_dim, mmhid, input_dim,
                                n_classes)
    # the student-side heads take both gradients, the teacher-side ones
    # their weights' only
    heads = (3 * 2 * path_dim * feat_dim
             + 2 * (mmhid * feat_dim + path_dim * feat_dim))
    # two kNNs over the rows of each of two banks (no gradient), and four
    # score products over the sampled rows, forward and backward
    contrast = 4 * n_data * feat_dim + 8 * (nce_p + nce_k) * feat_dim
    return 2.0 * (student + ema + teacher + heads + contrast)


def serve_flops_per_patch(cfg: Dict, opt) -> float:
    """The eval forward per patch of a configuration (``cfg``, its file)
    run with ``opt``: its pathology trunk (``"trunk"``, ResNet18 where
    absent) and heads, and in ``pathomic`` serving MaxNet and pofusion."""
    o, trunk = opt, cfg.get("trunk")
    if cfg["program"]["serve"] == "path":
        return 2.0 * sum(m for _, m in trunk_layers(
            trunk, o.input_size_path, o.path_dim, o.label_dim))
    return 2.0 * pathomic_fwd_macs(o.input_size_path, o.path_dim, o.omic_dim,
                                   o.mmhid, o.input_size_omic, o.label_dim,
                                   trunk)


def kron_train_fwd_cost(b: int, d1: int, d2: int, k: int) -> Dict:
    """B1 (``kron_matmul_dropout``): reads o1 [b, d1], o2 [b, d2], the fp32
    dropout mask [b, d1 d2], W [k, d1 d2] and the bias, writes y [b, k];
    multiplies the mask in and contracts, in fp32."""
    n = d1 * d2
    return {"bytes": 4 * (b * d1 + b * d2 + b * n + k * n + k + b * k),
            "flop": 2 * b * n + 2 * b * n * k,
            "flop_per_s": H100_FP32_FLOP_PER_S}


def kron_fwd_cost(b: int, d1: int, d2: int, k: int) -> Dict:
    """B2 (``kron_matmul``): reads o1, o2, W and the bias, writes y."""
    return {"bytes": 4 * (b * d1 + b * d2 + k * d1 * d2 + k + b * k),
            "flop": 2 * b * k * d1 * (d2 + 1),
            "flop_per_s": H100_FP32_FLOP_PER_S}


def least_seconds(cost: Dict) -> float:
    """The larger of the bytes at HBM's rate and the operations at the
    dtype's peak."""
    return max(cost["bytes"] / H100_BYTES_PER_S,
               cost["flop"] / cost["flop_per_s"])
