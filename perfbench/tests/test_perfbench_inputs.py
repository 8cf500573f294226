"""The weights a run draws from its seed (``inputs.make_weights``): the
serve configurations' tensors exactly as the laws before the
transformer rules drew them, and the transformer rules on timm's ViT-L/16
names, under which a plain forward sees every block."""
import math

import pytest
import torch
from torch.nn import functional as F

from perfbench import harness, inputs

WIDTH, HEADS, MLP, PATCH = 1024, 16, 4096, 16      # ViT-L/16


def _law_before(name, shape, shapes):
    """``inputs._law`` as it stood before the LayerNorm, LayerScale and
    embedding rules, kept to show that the configurations' draws did not
    move."""
    prefix, _, leaf = name.rpartition(".")
    is_bn = f"{prefix}.running_mean" in shapes
    if leaf == "num_batches_tracked":
        return 0.0, 0.0
    if leaf == "running_mean":
        return 0.1, 0.0
    if leaf == "running_var":
        return 0.25, 0.0
    if is_bn:
        return (0.1, 1.0) if leaf == "weight" else (0.1, 0.0)
    if leaf.startswith("memory_"):
        return 1.0 / math.sqrt(shape[1]), 0.0
    if len(shape) == 4:
        return math.sqrt(2.0 / (shape[0] * shape[2] * shape[3])), 0.0
    if len(shape) == 3:
        return 1.0 / math.sqrt(3.0 * shape[1]), 0.0
    if len(shape) == 2:
        return 1.0 / math.sqrt(shape[1]), 0.0
    sibling = f"{prefix}.weight"
    fan = inputs._fan_in(shapes[sibling]) if sibling in shapes else shape[0]
    return 1.0 / math.sqrt(3.0 * fan), 0.0


def _serve_shapes(name):
    from perfbench.drivers.serve import ServeProgram
    man = harness.manifest()
    cfg = harness.config_of(man, name)
    opt = harness.options(cfg, 1, cfg["data"]["n_rois"])
    prog = ServeProgram(cfg["program"]["serve"], opt, "cpu")
    shapes = {k: tuple(v.shape) for k, v in prog.tensors().items()}
    prog.close()
    return shapes


@pytest.fixture(scope="module")
def serve_shapes():
    return {c: _serve_shapes(c) for c in ("pofusion_teacher", "clat_student")}


@pytest.mark.parametrize("seed", [0, 2147483999, 3000000019])
def test_the_serve_configurations_draw_the_same_bytes(serve_shapes, seed,
                                                      monkeypatch):
    for shapes in serve_shapes.values():
        now = inputs.make_weights(seed, shapes, "cpu")
        monkeypatch.setattr(inputs, "_law", _law_before)
        before = inputs.make_weights(seed, shapes, "cpu")
        monkeypatch.undo()
        assert now.keys() == before.keys()
        for k in now:
            assert now[k].dtype == before[k].dtype
            assert torch.equal(now[k], before[k]), k


def _vit_shapes(depth, size):
    """timm's ``vit_large_patch16_224`` state-dict names and shapes (with
    ``init_values``, so LayerScale), at ``size``² and ``depth`` blocks."""
    n = (size // PATCH) ** 2 + 1
    shapes = {"cls_token": (1, 1, WIDTH), "pos_embed": (1, n, WIDTH),
              "patch_embed.proj.weight": (WIDTH, 3, PATCH, PATCH),
              "patch_embed.proj.bias": (WIDTH,),
              "norm.weight": (WIDTH,), "norm.bias": (WIDTH,)}
    for i in range(depth):
        b = f"blocks.{i}."
        shapes.update({
            b + "norm1.weight": (WIDTH,), b + "norm1.bias": (WIDTH,),
            b + "attn.qkv.weight": (3 * WIDTH, WIDTH),
            b + "attn.qkv.bias": (3 * WIDTH,),
            b + "attn.proj.weight": (WIDTH, WIDTH),
            b + "attn.proj.bias": (WIDTH,), b + "ls1.gamma": (WIDTH,),
            b + "norm2.weight": (WIDTH,), b + "norm2.bias": (WIDTH,),
            b + "mlp.fc1.weight": (MLP, WIDTH), b + "mlp.fc1.bias": (MLP,),
            b + "mlp.fc2.weight": (WIDTH, MLP), b + "mlp.fc2.bias": (WIDTH,),
            b + "ls2.gamma": (WIDTH,)})
    return shapes


def test_the_transformer_laws_on_timms_vit_l16_names():
    shapes = _vit_shapes(4, 512)
    law = {k: inputs._law(k, v, shapes) for k, v in shapes.items()}
    for k, got in law.items():
        leaf = k.rpartition(".")[2]
        if leaf in ("cls_token", "pos_embed"):
            assert got == (0.02, 0.0), k
        elif leaf == "gamma":
            assert got == (0.02, 0.1), k
        elif "norm" in k:
            assert got == ((0.1, 1.0) if leaf == "weight" else (0.1, 0.0)), k
        else:                       # kernels and their biases: as before
            assert got == _law_before(k, shapes[k], shapes), k
    w = inputs.make_weights(5, shapes, "cpu")
    assert abs(float(w["blocks.0.norm1.weight"].mean()) - 1.0) < 0.01
    assert abs(float(w["blocks.0.ls1.gamma"].mean()) - 0.1) < 0.005
    assert abs(float(w["cls_token"].std()) - 0.02) < 0.003


def _plain_vit(P, x, depth):
    """timm's pre-norm ViT blocks with LayerScale, in fp32 (LayerNorm eps
    1e-6, exact GELU); per block the attention's entropy over that of
    uniform weights, and the block's update of the residual stream over
    the stream."""
    B = x.shape[0]
    t = F.conv2d(x, P["patch_embed.proj.weight"], P["patch_embed.proj.bias"],
                 stride=PATCH).flatten(2).transpose(1, 2)
    t = torch.cat([P["cls_token"].expand(B, -1, -1), t], 1) + P["pos_embed"]
    entropy, update = [], []
    for i in range(depth):
        b = f"blocks.{i}."
        before = t
        h = F.layer_norm(t, (WIDTH,), P[b + "norm1.weight"],
                         P[b + "norm1.bias"], 1e-6)
        q, k, v = F.linear(h, P[b + "attn.qkv.weight"],
                           P[b + "attn.qkv.bias"]).reshape(
            B, -1, 3, HEADS, WIDTH // HEADS).permute(2, 0, 3, 1, 4)
        a = torch.softmax(q @ k.transpose(-1, -2)
                          / math.sqrt(WIDTH // HEADS), -1)
        ent = -(a * a.clamp_min(1e-30).log()).sum(-1)
        entropy.append(float(ent.mean()) / math.log(a.shape[-1]))
        o = (a @ v).transpose(1, 2).reshape(B, -1, WIDTH)
        t = t + P[b + "ls1.gamma"] * F.linear(o, P[b + "attn.proj.weight"],
                                              P[b + "attn.proj.bias"])
        h = F.layer_norm(t, (WIDTH,), P[b + "norm2.weight"],
                         P[b + "norm2.bias"], 1e-6)
        h = F.gelu(F.linear(h, P[b + "mlp.fc1.weight"], P[b + "mlp.fc1.bias"]))
        t = t + P[b + "ls2.gamma"] * F.linear(h, P[b + "mlp.fc2.weight"],
                                              P[b + "mlp.fc2.bias"])
        update.append(float((t - before).norm() / before.norm()))
    return entropy, update


def test_a_plain_vit_under_the_laws_sees_every_block():
    """At the published widths and the system's 512² ROI (1,025 tokens),
    4 blocks: the attention is far from uniform and every block moves the
    stream, so a comparison of outputs sees each block.  Under the bias
    law about 0 for the LayerNorms and LayerScales, the attention read
    1.0000 of uniform and each block moved the stream by about 1 %."""
    shapes = _vit_shapes(4, 512)
    P = inputs.make_weights(2147483999, shapes, "cpu")
    x = torch.randint(0, 256, (1, 3, 512, 512),
                      generator=torch.Generator().manual_seed(3))
    entropy, update = _plain_vit(P, x.float() / 127.5 - 1.0, 4)
    assert sum(entropy) / len(entropy) <= 0.99, entropy
    assert min(update) >= 0.05, update
