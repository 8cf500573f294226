"""perfbench/counts.py against hand-worked and published values."""
import pytest

from perfbench import counts


def test_resnet18_at_224_is_the_quoted_1_82_gmac():
    # conv1 118,013,952; layer1 4 x 115,605,504; layers 2-4 411,041,792
    # each (two strided and three plain 3x3s, one 1x1 downsample); fc
    # 512,000: the 1.8 G "FLOPs" (multiply-adds) of the ResNet paper
    macs = counts.resnet18_macs(224, imagenet_head=True)
    assert macs == 1_814_073_344
    assert abs(macs / 1.82e9 - 1) < 0.005


def test_resnet18_at_512_scales_with_the_maps():
    layers = dict(counts.resnet18_layers(512))
    assert layers["conv1"] == 64 * 3 * 49 * 256 * 256
    assert layers["layer4.1.conv2"] == 512 * 512 * 9 * 16 * 16
    assert layers["fc_new1"] == 512 * 128


def test_kron_bytes_match_the_kernel_table():
    # B1 at (16, 129, 129, 128): o1, o2, the fp32 mask, W, bias, y
    b1 = counts.kron_train_fwd_cost(16, 129, 129, 128)
    assert b1["bytes"] == 4 * (16 * 129 * 2 + 16 * 16641 + 128 * 16641
                               + 128 + 16 * 128) == 9_610_432
    b2 = counts.kron_fwd_cost(16, 129, 129, 128)
    assert b2["bytes"] == 8_545_408
    assert abs(b1["bytes"] / 9.61e6 - 1) < 1e-3
    assert abs(b2["bytes"] / 8.55e6 - 1) < 1e-3


def test_least_time_is_bytes_bound_at_batch_16():
    cost = counts.kron_fwd_cost(16, 129, 129, 128)
    assert counts.least_seconds(cost) == cost["bytes"] / 3.35e12


def test_teacher_step_flops_per_patch():
    fwd = counts.pathomic_fwd_macs(512, 128, 128, 128)
    per = counts.teacher_train_flops_per_patch(512, 128, 128, 128)
    # the student's forward and backward (no stem input gradient) and the
    # EMA's forward, about four trunk forwards
    assert 3.9 * 2 * fwd < per < 4.0 * 2 * fwd


def _resnet18_layers_before(size, path_dim=128, n_classes=3,
                            imagenet_head=False):
    """``counts.resnet18_layers`` as it stood before the trunk was a
    parameter."""
    out = counts._out
    layers = []
    h = out(size, 7, 2, 3)
    layers.append(("conv1", 64 * 3 * 49 * h * h))
    h = out(h, 3, 2, 1)
    cin = 64
    for stage, planes in enumerate((64, 128, 256, 512), 1):
        for block in range(2):
            stride = 2 if stage > 1 and block == 0 else 1
            ho = out(h, 3, stride, 1)
            name = f"layer{stage}.{block}"
            layers.append((f"{name}.conv1", planes * cin * 9 * ho * ho))
            layers.append((f"{name}.conv2", planes * planes * 9 * ho * ho))
            if stride != 1 or cin != planes:
                layers.append((f"{name}.downsample", planes * cin * ho * ho))
            cin, h = planes, ho
    if imagenet_head:
        layers.append(("fc", 512 * 1000))
    else:
        layers.append(("fc_new1", 512 * path_dim))
        layers.append(("fc_new2", path_dim * n_classes))
    return layers


@pytest.mark.parametrize("size", [224, 512])
@pytest.mark.parametrize("imagenet_head", [False, True])
def test_resnet_layers_of_resnet18_are_the_counts_before(size,
                                                         imagenet_head):
    want = _resnet18_layers_before(size, imagenet_head=imagenet_head)
    assert counts.resnet_layers(size, (2, 2, 2, 2), "basic",
                                imagenet_head=imagenet_head) == want
    assert counts.resnet18_layers(size, imagenet_head=imagenet_head) == want
    assert counts.trunk_layers(None, size) == \
        _resnet18_layers_before(size)


def test_resnet50_at_224_is_the_quoted_4_1_gmac():
    macs = sum(m for _, m in counts.resnet_layers(
        224, (3, 4, 6, 3), "bottleneck", imagenet_head=True))
    assert macs == 4_089_184_256


def test_vit_l16_at_224_is_timms_61_6_gmac():
    layers = counts.vit_layers(224, 16, 24, 1024, 16, 4096,
                               imagenet_head=True)
    assert abs(sum(m for _, m in layers) / 1e9 - 61.6) <= 0.1


def test_vit_l16_at_512():
    # 1,025 tokens: 15.05 GMAC a block, of it 2.15 in attention's products
    layers = dict(counts.vit_layers(512, 16, 24, 1024, 16, 4096))
    block = sum(v for k, v in layers.items() if k.startswith("blocks.0."))
    attn = layers["blocks.0.attn.scores"] + layers["blocks.0.attn.values"]
    assert attn == 2 * 1025 * 1025 * 1024
    assert abs(block / 1e9 - 15.05) < 0.005 and abs(attn / 1e9 - 2.15) < 0.01
    assert abs(sum(layers.values()) / 1e9 - 362.0) < 0.1
    trunk = {"kind": "vit", "patch": 16, "depth": 24, "width": 1024,
             "heads": 16, "mlp": 4096}
    assert dict(counts.trunk_layers(trunk, 512)) == layers


def test_attention_cost():
    c = counts.attention_fwd_cost(64, 16, 1025, 64)
    assert c["flop"] == 4 * 64 * 16 * 1025 * 1025 * 64
    assert c["bytes"] == 2 * 4 * 64 * 16 * 1025 * 64
    assert c["flop_per_s"] == counts.H100_BF16_FLOP_PER_S
    # compute-bound at these sizes
    assert counts.least_seconds(c) == c["flop"] / 989e12


@pytest.mark.parametrize("name,mode,flops", [
    ("clat_student", "path", 18949997312.0),
    ("pofusion_teacher", "pathomic", 18962839040.0)])
def test_serve_flops_per_patch_are_the_counts_before(name, mode, flops):
    """Both configurations name no trunk: ResNet18, the same FLOPs a patch
    as before the trunk was read from the configuration."""
    from perfbench import harness
    cfg = harness.config_of(harness.manifest(), name)
    assert "trunk" not in cfg and cfg["program"]["serve"] == mode
    opt = harness.options(cfg, 1, cfg["data"]["n_rois"])
    assert counts.serve_flops_per_patch(cfg, opt) == flops
    vit = {**cfg, "trunk": {"kind": "vit", "patch": 16, "depth": 24,
                            "width": 1024, "heads": 16, "mlp": 4096}}
    trunk = sum(m for _, m in counts.vit_layers(512, 16, 24, 1024, 16, 4096))
    r18 = counts.resnet18_macs(512)
    assert counts.serve_flops_per_patch(vit, opt) == flops + 2.0 * (
        trunk - r18)
