"""perfbench/counts.py against hand-worked values."""
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
