"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so they skip
here with a reason.  The file imports no JAX, so it runs on the machine with
the card, where the repository's ``tests/conftest.py`` (which imports JAX)
is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: rtol 1e-4 / atol 1e-5, the JAX Pallas tests' (both sides fp32;
the kernels sum in another order than the plain versions).  The bf16 3x3
convolution (B5) is held at rtol 1e-2 / atol 1e-2, about one bf16 ulp at
its output's scale, against the fp32 convolution of the same bf16 inputs;
TF32 is off, so the fp32 oracles are IEEE fp32.
"""
import numpy as np
import pytest
import torch
from torch.nn import functional as F

from multimodal_learning_tpu_torch.ops import kron_fusion, paired_conv

SHAPES = [(16, 129, 129, 128), (1, 129, 129, 128), (37, 129, 129, 128),
          (4, 9, 9, 16), (3, 200, 170, 33)]
# the forward kernels (B2, B1) also at fewer columns than blocks (N = 15),
# N % 4 == 0 (every row at shift 0), and several batch tiles with K beyond
# one k tile
FWD_SHAPES = SHAPES + [(2, 3, 5, 7), (16, 128, 128, 128),
                       (64, 129, 129, 256)]
# the backward kernels (B3, B4) also at K = 33 at the paper width, and at
# a batch beyond one staged chunk of B3 and several g chunks of B4
BWD_SHAPES = FWD_SHAPES + [(16, 129, 129, 33), (70, 9, 9, 512)]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(B, d1, d2, K, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    o1, o2 = torch.rand(B, d1, generator=g), torch.rand(B, d2, generator=g)
    w = torch.randn(K, d1 * d2, generator=g) / (d1 * d2) ** 0.5
    b = torch.randn(K, generator=g)
    return [t.to(dev) for t in (o1, o2, w, b)]


def _mask(B, n, dev, keep=0.75, seed=1):
    g = torch.Generator().manual_seed(seed)
    return ((torch.rand(B, n, generator=g) < keep).float() / keep).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_kron_kernel_matches_plain(cuda, shape):
    args = _inputs(*shape, cuda)
    before = kron_fusion.kron_matmul.launches
    got = kron_fusion.kron_matmul(*args)
    torch.cuda.synchronize()
    assert kron_fusion.kron_matmul.launches == before + 1
    torch.testing.assert_close(got, kron_fusion.kron_matmul_plain(*args),
                               **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kron_backward_launches_b3_b4_and_matches_plain(cuda, shape):
    """``kron_matmul(...).backward`` runs B3 and B4 once each, and the
    gradients match autograd through the plain version."""
    args = [t.requires_grad_() for t in _inputs(*shape, cuda)]
    g = torch.randn(shape[0], shape[3], device=cuda)
    n3, n4 = kron_fusion.kron_bwd_dw.launches, kron_fusion.kron_bwd_dvec.launches
    kron_fusion.kron_matmul(*args).backward(g)
    torch.cuda.synchronize()
    assert kron_fusion.kron_bwd_dw.launches == n3 + 1
    assert kron_fusion.kron_bwd_dvec.launches == n4 + 1
    got = [t.grad for t in args]
    want = torch.autograd.grad(kron_fusion.kron_matmul_plain(*args), args, g)
    for name, a, b in zip(("o1", "o2", "weight", "bias"), got, want):
        torch.testing.assert_close(a, b, **TOL, msg=name)


@pytest.mark.cuda
def test_kron_backward_skips_b3_without_a_weight_gradient(cuda):
    o1, o2, w, b = _inputs(4, 9, 9, 16, cuda)
    o1.requires_grad_()
    n3, n4 = kron_fusion.kron_bwd_dw.launches, kron_fusion.kron_bwd_dvec.launches
    kron_fusion.kron_matmul(o1, o2, w, b).sum().backward()
    assert kron_fusion.kron_bwd_dw.launches == n3
    assert kron_fusion.kron_bwd_dvec.launches == n4 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FWD_SHAPES)
def test_kron_dropout_kernel_matches_plain(cuda, shape):
    """B1 forward against the plain version, and its torch backward against
    autograd through the plain version, on the same mask."""
    args = [t.requires_grad_() for t in _inputs(*shape, cuda, seed=2)]
    maskf = _mask(shape[0], shape[1] * shape[2], cuda)
    before = kron_fusion.kron_matmul_dropout.launches
    got = kron_fusion.kron_matmul_dropout(*args, maskf)
    torch.cuda.synchronize()
    assert kron_fusion.kron_matmul_dropout.launches == before + 1
    want = kron_fusion.kron_matmul_dropout_plain(*args, maskf)
    torch.testing.assert_close(got, want, **TOL)
    g = torch.randn_like(got)
    for name, a, b in zip(("o1", "o2", "weight", "bias"),
                          torch.autograd.grad(got, args, g),
                          torch.autograd.grad(want, args, g)):
        torch.testing.assert_close(a, b, **TOL, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(16, 129, 129, 128), (2, 3, 5, 7),
                                   (16, 128, 128, 128), (64, 129, 129, 256)])
def test_kron_forward_kernels_are_bitwise_reproducible(cuda, shape, masked):
    """Partial sums added in a fixed order of column ranges, no atomics:
    two launches of B2 (B1 with ``masked``) give the same bits."""
    args = _inputs(*shape, cuda, seed=4)
    if masked:
        args.append(_mask(shape[0], shape[1] * shape[2], cuda))
    fn = (kron_fusion.kron_matmul_dropout if masked
          else kron_fusion.kron_matmul)
    first, second = fn(*args), fn(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_kron_forward_takes_views_that_are_not_16_byte_aligned(cuda, masked):
    """The kernel's tensor maps need W and the mask 16-byte aligned; the
    wrapper copies a view that is not, and the result is the same."""
    B, d1, d2, K = 4, 9, 9, 16
    o1, o2, w, b = _inputs(B, d1, d2, K, cuda, seed=6)
    w_view = torch.empty(K * d1 * d2 + 1, device=cuda)[1:].view(K, d1 * d2)
    w_view.copy_(w)
    args = [o1, o2, w_view, b]
    if masked:
        m = _mask(B, d1 * d2, cuda)
        m_view = torch.empty(m.numel() + 1, device=cuda)[1:].view_as(m)
        args.append(m_view.copy_(m))
    assert w_view.data_ptr() % 16
    fn, plain = ((kron_fusion.kron_matmul_dropout,
                  kron_fusion.kron_matmul_dropout_plain) if masked else
                 (kron_fusion.kron_matmul, kron_fusion.kron_matmul_plain))
    torch.testing.assert_close(fn(*args), plain(*args), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
def test_kron_forward_allocates_only_its_output(cuda, masked):
    """The partials' scratch is cached per device and stream: after the
    first call, a call allocates one tensor, its output."""
    args = _inputs(16, 129, 129, 128, cuda, seed=5)
    if masked:
        args.append(_mask(16, 129 * 129, cuda))
    fn = (kron_fusion.kron_matmul_dropout if masked
          else kron_fusion.kron_matmul)
    with torch.no_grad():
        fn(*args)
        before = torch.cuda.memory_stats()["allocation.all.allocated"]
        y = fn(*args)
        after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after - before == 1 and y.shape == (16, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_kron_bwd_kernels_match_plain(cuda, shape):
    o1, o2, w, _ = _inputs(*shape, cuda, seed=3)
    g = torch.randn(shape[0], shape[3], device=cuda)
    torch.testing.assert_close(kron_fusion.kron_bwd_dw(o1, o2, g),
                               kron_fusion.kron_bwd_dw_plain(o1, o2, g), **TOL)
    for a, b in zip(kron_fusion.kron_bwd_dvec(o1, o2, w, g),
                    kron_fusion.kron_bwd_dvec_plain(o1, o2, w, g)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 129, 129, 128), (2, 3, 5, 7),
                                   (3, 200, 170, 33), (70, 9, 9, 512)])
def test_kron_bwd_kernels_are_bitwise_reproducible(cuda, shape):
    """B3 sums over the batch in order; B4 sums each column over K in
    order and its partials in the order of the blocks: two launches give
    the same bits."""
    o1, o2, w, _ = _inputs(*shape, cuda, seed=7)
    g = torch.randn(shape[0], shape[3], device=cuda)
    assert torch.equal(kron_fusion.kron_bwd_dw(o1, o2, g),
                       kron_fusion.kron_bwd_dw(o1, o2, g))
    for a, b in zip(kron_fusion.kron_bwd_dvec(o1, o2, w, g),
                    kron_fusion.kron_bwd_dvec(o1, o2, w, g)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kron_bwd_dvec_takes_a_weight_view_that_is_not_16_byte_aligned(cuda):
    """B4's tensor maps need W 16-byte aligned; the wrapper copies a view
    that is not, and the result is the same."""
    o1, o2, w, _ = _inputs(4, 9, 9, 16, cuda, seed=10)
    g = torch.randn(4, 16, device=cuda)
    w_view = torch.empty(w.numel() + 1, device=cuda)[1:].view_as(w)
    w_view.copy_(w)
    assert w_view.data_ptr() % 16
    for a, b in zip(kron_fusion.kron_bwd_dvec(o1, o2, w_view, g),
                    kron_fusion.kron_bwd_dvec_plain(o1, o2, w, g)):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_kron_bwd_dvec_allocates_only_its_outputs(cuda):
    """B4's partials go to the cached scratch: after the first call, a
    call allocates two tensors, do1 and do2."""
    o1, o2, w, _ = _inputs(16, 129, 129, 128, cuda, seed=8)
    g = torch.randn(16, 128, device=cuda)
    kron_fusion.kron_bwd_dvec(o1, o2, w, g)
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    do1, do2 = kron_fusion.kron_bwd_dvec(o1, o2, w, g)
    after = torch.cuda.memory_stats()["allocation.all.allocated"]
    assert after - before == 2 and do1.shape == do2.shape == (16, 129)


@pytest.mark.cuda
def test_saliency_launches_b4_once_and_b3_never(cuda):
    """The masked teacher's saliency pass takes input gradients only, with
    the parameters frozen: kron_matmul's backward runs B4 and skips B3, as
    XLA drops the unused weight gradient in the JAX package."""
    from multimodal_learning_tpu_torch.losses import nll_loss
    from multimodal_learning_tpu_torch.masking import (
        frozen_params, superpixel_attention_mask)
    from multimodal_learning_tpu_torch.models import PathomicModel
    gen = torch.Generator().manual_seed(9)
    model = PathomicModel(path_dim=8, omic_dim=8, mmhid=8,
                          pallas_fusion="train", generator=gen).to(cuda)
    model.eval()
    x_path = torch.rand(2, 32, 32, 3, generator=gen).to(cuda)
    x_omic = torch.randn(2, 80, generator=gen).to(cuda)
    labels = torch.tensor([0, 2], device=cuda)
    sp = (torch.arange(32, device=cuda)[:, None] // 8 * 4
          + torch.arange(32, device=cuda)[None, :] // 8).expand(2, 32, 32)

    def cost(xp, xo):
        return nll_loss(model(x_path=xp, x_omic=xo).pred_fuse, labels)

    n2, n3, n4 = (kron_fusion.kron_matmul.launches,
                  kron_fusion.kron_bwd_dw.launches,
                  kron_fusion.kron_bwd_dvec.launches)
    with frozen_params(model):
        pm, om = superpixel_attention_mask(cost, x_path, x_omic, sp, 16, 3, 5)
    torch.cuda.synchronize()
    assert kron_fusion.kron_matmul.launches == n2 + 1
    assert kron_fusion.kron_bwd_dw.launches == n3
    assert kron_fusion.kron_bwd_dvec.launches == n4 + 1
    assert (pm.sum((1, 2)) == 3 * 64).all() and (om.sum(1) >= 5).all()


@pytest.mark.cuda
def test_kron_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    o1, o2, w, b = _inputs(4, 9, 9, 16, cuda)
    with pytest.raises(TypeError, match="float32"):
        kron_fusion.kron_matmul(o1.double(), o2, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        kron_fusion.kron_matmul(o1, o2, w.t().contiguous().t(), b)
    with pytest.raises(ValueError, match="on cpu"):
        kron_fusion.kron_matmul(o1, o2, w.cpu(), b)
    with pytest.raises(ValueError, match="shapes"):
        kron_fusion.kron_matmul(o1, o2[:, :5].contiguous(), w, b)
    with pytest.raises(ValueError, match="shapes"):
        kron_fusion.kron_matmul_dropout(o1, o2, w, b, _mask(4, 80, cuda))
    with pytest.raises(ValueError, match="on cpu"):
        kron_fusion.kron_matmul_dropout(o1, o2, w, b, _mask(4, 81, "cpu"))


# the stage-1 shape, ragged ones, many tiles per block (33 images: 2112
# tiles on 132 SMs), fewer tiles than SMs (1 x 1 x 2), and a ragged bottom
# row band with a ragged right column band (129 x 66)
CONV_SHAPES = [(16, 128, 128, 64), (1, 128, 128, 64), (3, 37, 50, 64),
               (2, 8, 8, 64), (33, 128, 128, 64), (1, 1, 2, 64),
               (5, 129, 66, 64)]


def _conv_inputs(shape, dev, dtype, seed=0):
    """x [B, 64, H, W] channels-last (an NHWC tensor permuted) and W at the
    stage's kaiming init."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g).to(dev, dtype).permute(0, 3, 1, 2)
    w = (torch.randn(64, 64, 3, 3, generator=g) * (2 / 576) ** 0.5).to(
        dev, dtype)
    return x, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(cuda, shape, dtype):
    x, w = _conv_inputs(shape, cuda, dtype)
    before = paired_conv.conv3x3.launches
    got = paired_conv.conv3x3(x, w)
    torch.cuda.synchronize()
    assert paired_conv.conv3x3.launches == before + 1
    assert got.dtype == dtype and got.is_contiguous(
        memory_format=torch.channels_last)
    want = paired_conv.conv3x3_plain(x.float(), w.float())
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 128, 128, 64), (3, 37, 50, 64),
                                   (5, 129, 66, 64)])
def test_conv3x3_transposed_matches_plain(cuda, shape, dtype):
    """The data-gradient form: W flipped and IO-swapped as it is staged."""
    x, w = _conv_inputs(shape, cuda, dtype, seed=2)
    before = paired_conv.conv3x3.launches
    got = paired_conv.conv3x3(x, w, transposed=True)
    torch.cuda.synchronize()
    assert paired_conv.conv3x3.launches == before + 1
    want = paired_conv.conv3x3_plain(x.float(), w.float(), transposed=True)
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    torch.testing.assert_close(got.float(), want, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(16, 128, 128, 64), (33, 128, 128, 64),
                                   (5, 129, 66, 64)])
def test_conv3x3_is_bitwise_reproducible(cuda, shape, dtype):
    """A fixed tile schedule and summation order, no atomics: two launches
    on the same inputs give the same bits."""
    x, w = _conv_inputs(shape, cuda, dtype, seed=3)
    first = paired_conv.conv3x3(x, w)
    second = paired_conv.conv3x3(x, w)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 16, 64), (3, 37, 50, 64)])
def test_paired_conv3x3_grads_match_autograd(cuda, shape):
    """Forward and data gradient through B5 (two launches), weight gradient
    through conv2d_weight, against autograd of F.conv2d, fp32."""
    x, w = (t.requires_grad_() for t in _conv_inputs(shape, cuda,
                                                      torch.float32, 1))
    g = torch.randn(shape[0], 64, shape[1], shape[2], device=cuda)
    before = paired_conv.conv3x3.launches
    got = torch.autograd.grad(paired_conv.paired_conv3x3(x, w), (x, w), g)
    torch.cuda.synchronize()
    assert paired_conv.conv3x3.launches == before + 2
    want = torch.autograd.grad(F.conv2d(x, w, padding=1), (x, w), g)
    torch.testing.assert_close(got[0], want[0], **TOL)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_paired_resnet18_launches_b5(cuda):
    """4 launches per forward (the 64-channel stage) and 4 more in the
    backward (the data gradients); none without pairing."""
    from multimodal_learning_tpu_torch.models import ResNet18
    x = torch.randn(2, 64, 64, 3, device=cuda)
    for paired, fwd, bwd in ((True, 4, 4), (False, 0, 0)):
        model = ResNet18(path_dim=8, dtype=torch.bfloat16,
                         paired=paired).to(cuda)
        before = paired_conv.conv3x3.launches
        with torch.no_grad():
            model.eval()(x)
        assert paired_conv.conv3x3.launches == before + fwd
        model.train()(x)[2].sum().backward()
        torch.cuda.synchronize()
        assert paired_conv.conv3x3.launches == before + 2 * fwd + bwd


@pytest.mark.cuda
def test_conv3x3_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x, w = _conv_inputs((2, 8, 8, 64), cuda, torch.float32)
    with pytest.raises(TypeError, match="float32"):
        paired_conv.conv3x3(x.double(), w.double())
    with pytest.raises(TypeError, match="bfloat16"):
        paired_conv.conv3x3(x, w.bfloat16())
    with pytest.raises(ValueError, match="channels-last"):
        paired_conv.conv3x3(x.contiguous(), w)
    with pytest.raises(ValueError, match="shapes"):
        paired_conv.conv3x3(x[:, :32].contiguous(
            memory_format=torch.channels_last), w[:32, :32].contiguous())
    with pytest.raises(ValueError, match="on cpu"):
        paired_conv.conv3x3(x, w.cpu())


def _launches():
    return {"B1": kron_fusion.kron_matmul_dropout.launches,
            "B2": kron_fusion.kron_matmul.launches,
            "B3": kron_fusion.kron_bwd_dw.launches,
            "B4": kron_fusion.kron_bwd_dvec.launches,
            "B5": paired_conv.conv3x3.launches}


def _small_batch(dev, b=4, size=64, width=14, n_data=32):
    g = torch.Generator().manual_seed(3)
    index = torch.randperm(n_data, generator=g)[:b]
    sample_idx = torch.randint(0, n_data, (b, width), generator=g)
    sample_idx[:, 0] = index
    batch = {"omic": torch.randn(b, 80, generator=g),
             "g": torch.randint(0, 3, (b,), generator=g), "index": index,
             "sample_idx": sample_idx,
             "path_views": torch.randint(0, 256, (b, 2, size, size, 3),
                                         dtype=torch.uint8, generator=g)}
    return {k: v.to(dev) for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("teacher_bn,paired,per_step", [
    ("batch", False, dict(B1=1)), ("running", False, dict(B2=1)),
    ("batch", True, dict(B1=1, B5=16))])
def test_student_step_launches(cuda, teacher_bn, paired, per_step):
    """The student step (``train/student.py``, GK_refine CRD with two
    teachers): the frozen teacher's fusion launches B1 once per step in
    train mode (``--teacher_bn batch``) or B2 once in eval mode
    (``running``); B3 and B4 never, as no gradient reaches the teacher;
    with ``--paired_conv`` B5 16 times (4 forwards each of the student,
    the EMA and the teacher, 4 data gradients of the student).  The
    teacher's buffers stay bitwise unchanged."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule, student
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, feat_dim=16,
                  batch_size=4, n_data=32, pallas_fusion="train",
                  distill="crd", num_teachers=2, assign_weights=True,
                  CE_grads=True, select_pos_mode="hard",
                  pos_mode="multi_pos", nce_p=6, nce_p2=3, nce_k=8,
                  nce_k2=5, compute_dtype="bfloat16", teacher_bn=teacher_bn,
                  paired_conv=paired)
    teacher = student.freeze_teacher(define_model(
        opt, generator=torch.Generator().manual_seed(0)), cuda)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = student.init_student_state(
        opt, define_model(opt, path_only=True,
                          generator=torch.Generator().manual_seed(1)),
        make_lr_schedule(opt, 10), 32, device=cuda)
    step = student.build_student_train_step(opt, teacher)
    batch = _small_batch(cuda)
    start = _launches()
    for _ in range(2):
        state, metrics = step(state, batch, 0.1)
    torch.cuda.synchronize()
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {k: 2 * per_step.get(k, 0) for k in got}
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.cuda
def test_tsvd_teacher_step_launches_b1_twice(cuda):
    """The t-SVD teacher step: B1 in the student and the EMA forward; the
    t-SVT's complex SVD is a cuSOLVER call, not a kernel of the port."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step, init_teacher_state)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, batch_size=4,
                  pallas_fusion="train", CRD_distill=0, pred_distill=1,
                  tSVD_loss=True, n_views=4, tSVD_mode="pathomic",
                  Lambda_global=0.1, mu=0.5, compute_dtype="bfloat16")
    state = init_teacher_state(opt, define_model(
        opt, generator=torch.Generator().manual_seed(0)),
        make_lr_schedule(opt, 10), 32, device=cuda)
    step = build_teacher_train_step(opt)
    batch = _small_batch(cuda)
    start = _launches()
    for refresh in (True, False):
        state, metrics = step(state, batch, 0.1, tsvd_update=refresh)
    torch.cuda.synchronize()
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {"B1": 4, "B2": 0, "B3": 0, "B4": 0, "B5": 0}
    assert float(metrics["loss_tsvd"]) > 0
    assert abs(float(state.banks["tsvd"].mu) - 0.55) < 1e-6


def _masked_batch(dev, b=4, size=64, n_sp=16):
    """Four uint8 views and a label map of 16 vertical stripes."""
    g = torch.Generator().manual_seed(4)
    stripes = (torch.arange(size) * n_sp // size).expand(b, size, size)
    batch = {"omic": torch.randn(b, 80, generator=g),
             "g": torch.randint(0, 3, (b,), generator=g),
             "index": torch.arange(b),
             "path_views": torch.randint(0, 256, (b, 4, size, size, 3),
                                         dtype=torch.uint8, generator=g),
             "sp_mask": stripes.to(torch.int32).contiguous()}
    return {k: v.to(dev) for k, v in batch.items()}


def _masked_state(dev, masking_bn="chain", paired=False):
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step, init_teacher_state)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, batch_size=4,
                  pallas_fusion="train", CRD_distill=0, pred_distill=1,
                  masking=1, num_superpixels=16, Path_K=1, Omic_K=5,
                  masking_bn=masking_bn, paired_conv=paired,
                  compute_dtype="bfloat16")
    state = init_teacher_state(opt, define_model(
        opt, generator=torch.Generator().manual_seed(0)),
        make_lr_schedule(opt, 10), 32, device=dev)
    return state, build_teacher_train_step(opt, masking=True)


@pytest.mark.cuda
@pytest.mark.parametrize("masking_bn,paired,per_step", [
    ("chain", False, dict(B1=6, B2=1, B4=1)),
    ("discard", False, dict(B1=6, B2=1, B4=1)),
    ("chain", True, dict(B1=6, B2=1, B4=1, B5=36))])
def test_masked_teacher_step_launches(cuda, masking_bn, paired, per_step):
    """The masked CLAT teacher's step (``build_teacher_train_step(masking=
    True)``): B1 in the student's main, masked-path and masked-omic
    forwards and the EMA's three; B2 and B4 once in the saliency pass, B3
    never (input gradients only); with ``--paired_conv`` B5 36 times (20
    forwards, 16 data gradients)."""
    state, step = _masked_state(cuda, masking_bn, paired)
    batch = _masked_batch(cuda)
    start = _launches()
    for _ in range(2):
        state, metrics = step(state, batch, 0.1)
    torch.cuda.synchronize()
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {k: 2 * per_step.get(k, 0) for k in got}
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    assert float(metrics["loss_masking"]) > 0


_PLAIN = ((kron_fusion, "kron_matmul_plain"),
          (kron_fusion, "kron_matmul_dropout_plain"),
          (kron_fusion, "kron_bwd_dw_plain"),
          (kron_fusion, "kron_bwd_dvec_plain"),
          (paired_conv, "conv3x3_plain"))


@pytest.mark.cuda
def test_masked_and_clat_steps_reach_the_kernels_not_their_plain_versions(
        cuda, monkeypatch):
    """On CUDA tensors the wrappers launch their kernels: a paired masked
    step and a paired CLAT student step call no plain version."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import (make_lr_schedule,
                                                     student, student_clat)
    calls = {}
    for mod, name in _PLAIN:
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    start = _launches()
    state, step = _masked_state(cuda, paired=True)
    step(state, _masked_batch(cuda), 0.1)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, feat_dim=16,
                  batch_size=4, n_data=32, pallas_fusion="train",
                  distill="crd", num_teachers=2, assign_weights=True,
                  loss_weighting="GK_refine", use_grads_thresh=True,
                  pos_mode="exact", pos_extra="neighbors", nce_p=3,
                  nce_k=13, compute_dtype="bfloat16", paired_conv=True)
    teacher = student.freeze_teacher(state.model, cuda)
    sstate = student.init_student_state(
        opt, define_model(opt, path_only=True,
                          generator=torch.Generator().manual_seed(1)),
        make_lr_schedule(opt, 10), 32, device=cuda)
    cmask = torch.nn.functional.one_hot(torch.arange(32) % 3, 3).t().to(cuda)
    student_clat.build_clat_student_step(opt, teacher, cmask)(
        sstate, _small_batch(cuda), True)
    torch.cuda.synchronize()
    assert calls == {}
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {"B1": 7, "B2": 1, "B3": 0, "B4": 1, "B5": 36 + 16}


@pytest.mark.cuda
@pytest.mark.parametrize("teacher_bn,pos_extra,paired,per_step", [
    ("batch", "neighbors", False, dict(B1=1)),
    ("running", "centers", False, dict(B2=1)),
    ("batch", "neighbors", True, dict(B1=1, B5=16))])
def test_clat_student_step_launches(cuda, teacher_bn, pos_extra, paired,
                                    per_step):
    """The CLAT student step (``train/student_clat.py``, GK_refine, CRD v10
    from two teachers): the frozen teacher's fusion launches B1 once per
    step (``--teacher_bn batch``) or B2 once (``running``), B3 and B4
    never; with ``--paired_conv`` B5 16 times.  The teacher's buffers
    stay bitwise unchanged."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import (make_lr_schedule,
                                                     student, student_clat)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, feat_dim=16,
                  batch_size=4, n_data=32, pallas_fusion="train",
                  distill="crd", num_teachers=2, assign_weights=True,
                  loss_weighting="GK_refine", use_grads_thresh=True,
                  pos_mode="exact", pos_extra=pos_extra, nce_p=3, nce_k=13,
                  compute_dtype="bfloat16", teacher_bn=teacher_bn,
                  paired_conv=paired)
    teacher = student.freeze_teacher(define_model(
        opt, generator=torch.Generator().manual_seed(0)), cuda)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    state = student.init_student_state(
        opt, define_model(opt, path_only=True,
                          generator=torch.Generator().manual_seed(1)),
        make_lr_schedule(opt, 10), 32, device=cuda)
    cmask = torch.nn.functional.one_hot(torch.arange(32) % 3, 3).t().to(cuda)
    step = student_clat.build_clat_student_step(opt, teacher, cmask)
    batch = _small_batch(cuda)
    start = _launches()
    for reweight_on in (False, True):
        state, metrics = step(state, batch, reweight_on)
    torch.cuda.synchronize()
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {k: 2 * per_step.get(k, 0) for k in got}
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    assert float(metrics["w1_mean"]) >= 1.0
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


def _zoo_student(cuda, **flags):
    """A small student of the distiller zoo, HKD or the SVM weighting on a
    frozen teacher: its state, step and batch (HKD's ``sample_idx`` holds
    the K negatives only)."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule, student
    opt = Options(**{**dict(
        mode="pathomic", task="grad", input_size_path=64, path_dim=16,
        omic_dim=16, mmhid=16, feat_dim=16, batch_size=8, n_data=32,
        pallas_fusion="train", num_teachers=2, assign_weights=True,
        CE_grads=True, select_pos_mode="hard", pos_mode="multi_pos",
        nce_p=6, nce_p2=3, nce_k=8, nce_k2=5, compute_dtype="bfloat16"),
        **flags})
    teacher = student.freeze_teacher(define_model(
        opt, generator=torch.Generator().manual_seed(0)), cuda)
    state = student.init_student_state(
        opt, define_model(opt, path_only=True,
                          generator=torch.Generator().manual_seed(1)),
        make_lr_schedule(opt, 10), 32, device=cuda)
    batch = _small_batch(cuda, b=8)
    if opt.distill == "hkd":
        batch["sample_idx"] = batch["sample_idx"][:, 6:].contiguous()
    return state, student.build_student_train_step(opt, teacher), batch


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["feats_KL", "rkd", "pkt", "hint",
                                  "correlation", "hkd"])
def test_zoo_and_hkd_student_steps_launch_b1_once(cuda, mode):
    """A distiller-zoo or HKD student step: the frozen teacher's fusion
    launches B1 once per step and no other kernel runs; HKD's bank rows of
    the batch move to norm 1."""
    state, step, batch = _zoo_student(cuda, distill=mode)
    start = _launches()
    for _ in range(2):
        state, metrics = step(state, batch, 0.1)
    torch.cuda.synchronize()
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {"B1": 2, "B2": 0, "B3": 0, "B4": 0, "B5": 0}
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), k
    if mode == "hkd":
        rows = state.banks["hkd"].memory_l[batch["index"]]
        torch.testing.assert_close(rows.norm(dim=1),
                                   torch.ones(8, device=cuda))


def _syncs(fn):
    """Host synchronisations of ``fn`` by file, as torch.cuda's sync debug
    mode reports them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return [w.filename for w in rec
            if "called a synchronizing CUDA operation" in str(w.message)]


@pytest.mark.cuda
def test_svm_student_step_syncs_once_in_the_solver(cuda):
    """``--loss_weighting SVM``: B1 once per step, and one host
    synchronisation per step, the gradients' copy in ``gradweight/svm.py``;
    the weights sum to 1 under ``--svm_norm``."""
    state, step, batch = _zoo_student(cuda, distill="crd",
                                      loss_weighting="SVM", svm_norm=True)
    step(state, batch, 0.1)
    start = _launches()
    where = _syncs(lambda: step(state, batch, 0.1))
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {"B1": 1, "B2": 0, "B3": 0, "B4": 0, "B5": 0}
    assert len(where) == 1 and where[0].endswith(
        "gradweight/svm.py"), where
    _, metrics = step(state, batch, 0.1)
    torch.testing.assert_close(metrics["scale"].sum().cpu(),
                               torch.tensor(1.0))


@pytest.mark.cuda
def test_supcon_teacher_step_launches_b1_twice_without_syncs(cuda):
    """``--supcon_distill 1`` in the teacher step: B1 in the student and the
    EMA forward, no host synchronisation, a finite positive SupCon term."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import (
        build_teacher_train_step, init_teacher_state)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, feat_dim=16,
                  batch_size=4, n_data=32, pallas_fusion="train",
                  CRD_distill=1, pred_distill=1, pos_mode="exact", nce_p=1,
                  nce_k=13, supcon_distill=1, compute_dtype="bfloat16")
    state = init_teacher_state(
        opt, define_model(opt, generator=torch.Generator().manual_seed(1)),
        make_lr_schedule(opt, 10), 32, device=cuda)
    step = build_teacher_train_step(opt)
    batch = _small_batch(cuda)
    step(state, batch, 0.1)
    start = _launches()
    out = {}
    where = _syncs(lambda: out.update(step(state, batch, 0.1)[1]))
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {"B1": 2, "B2": 0, "B3": 0, "B4": 0, "B5": 0}
    assert where == []
    assert float(out["loss_supcon"]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("paired,per_step", [(False, {}), (True, dict(B5=8))])
def test_mmdynamics_step_launches(cuda, paired, per_step):
    """The mmdynamics step (``build_mmdynamics_train_step``): no Kronecker
    kernel, since its fusion is MMDynamic; with ``--paired_conv`` B5 8
    times per step (4 forwards of the 64-channel stage, 4 data
    gradients); no host synchronisation; the EMA model left bitwise as it
    was."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.train import make_lr_schedule
    from multimodal_learning_tpu_torch.train.steps import (
        build_mmdynamics_train_step, init_teacher_state)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, batch_size=4,
                  fusion_type="mmdynamics", CRD_distill=0, pred_distill=0,
                  compute_dtype="bfloat16", paired_conv=paired)
    state = init_teacher_state(opt, define_model(
        opt, generator=torch.Generator().manual_seed(2)),
        make_lr_schedule(opt, 10), 32, device=cuda)
    ema = {k: v.clone() for k, v in state.ema_model.state_dict().items()}
    step = build_mmdynamics_train_step(opt)
    batch = _small_batch(cuda)
    step(state, batch)
    start = _launches()
    out = {}
    where = _syncs(lambda: out.update(step(state, batch)[1]))
    got = {k: v - start[k] for k, v in _launches().items()}
    assert got == {k: per_step.get(k, 0) for k in got}
    assert where == []
    assert set(out) == {"loss", "correct_fuse"}
    assert torch.isfinite(out["loss"])
    for k, v in state.ema_model.state_dict().items():
        assert torch.equal(v, ema[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("fusion_type",
                         ["polynomial_fusion", "LMF", "HFB", "mmdynamics"])
def test_new_fusions_eval_forward_on_card_matches_cpu(cuda, fusion_type):
    """The fp32 eval forward of a model with each new fusion type on the
    card against the CPU, from the same weights, at the whole-model
    tolerance of the CPU parity tests (rtol 2e-3 / atol 5e-4); no
    Kronecker kernel launches."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.serve import make_infer_fn
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16,
                  fusion_type=fusion_type, pallas_fusion="train")
    model = define_model(opt, generator=torch.Generator().manual_seed(3))
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (4, 64, 64, 3), dtype=torch.uint8, generator=g)
    om = torch.randn(4, 80, generator=g)
    want = make_infer_fn(opt, model)(x, om)
    start = _launches()
    got = make_infer_fn(opt, model.to(cuda))(x, om)
    torch.cuda.synchronize()
    assert {k: v - start[k] for k, v in _launches().items()} == dict.fromkeys(
        start, 0)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=2e-3,
                                   atol=5e-4, msg=k)



def _card_vs_cpu(cuda, make, inputs, train, what):
    """``make(generator)`` twice from one seed, its fp32 forward on the card
    (TF32 off) against the CPU on the same inputs at the whole-model
    tolerance (rtol 2e-3 / atol 5e-4); no kernel of the port launches."""
    cpu = make(torch.Generator().manual_seed(7)).train(train)
    card = make(torch.Generator().manual_seed(7)).train(train).to(cuda)
    start = _launches()
    with torch.no_grad():
        want = cpu(*inputs)
        got = card(*[x.to(cuda) for x in inputs])
    torch.cuda.synchronize()
    assert {k: v - start[k] for k, v in _launches().items()} == dict.fromkeys(
        start, 0)
    assert got.dtype == torch.float32 and got.shape == want.shape
    torch.testing.assert_close(got.cpu(), want, rtol=2e-3, atol=5e-4,
                               msg=what)
    if train:       # the BatchNorms' new running statistics
        for (name, a), b in zip(card.named_buffers(), cpu.buffers()):
            torch.testing.assert_close(a.cpu(), b, rtol=2e-3, atol=5e-4,
                                       msg=f"{what} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("variant", ["A", "B"])
def test_trilinear_fusion_on_card_matches_cpu(cuda, variant, train):
    """``TrilinearFusion``, which no card path runs (no model of the port
    builds it, as in the JAX package), in eval and in train mode (dropout
    0: the two devices draw other masks)."""
    from multimodal_learning_tpu_torch.models import TrilinearFusion
    g = torch.Generator().manual_seed(8)
    xs = [torch.randn(6, w, generator=g) for w in (16, 12, 16)]
    _card_vs_cpu(cuda, lambda gen: TrilinearFusion(
        variant=variant, dim1=16, dim2=12, dim3=16, mmhid=16,
        dropout_rate=0.0, generator=gen), xs, train, f"trilinear {variant}")


@pytest.mark.cuda
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("decoder", ["ResnetDecoder", "MaxNetDecoder"])
def test_decoders_on_card_match_cpu(cuda, decoder, train):
    """The reconstruction decoders, which no card path runs, in eval and in
    train mode (the MaxNet decoder at dropout 0: the two devices draw other
    AlphaDropout masks)."""
    from multimodal_learning_tpu_torch import models
    z = torch.randn(4, 16, generator=torch.Generator().manual_seed(9))
    if decoder == "ResnetDecoder":
        make = lambda gen: models.ResnetDecoder(latent_dim=16, generator=gen)
    else:
        make = lambda gen: models.MaxNetDecoder(omic_dim=16, output_dim=80,
                                                dropout_rate=0.0,
                                                generator=gen)
    _card_vs_cpu(cuda, make, [z], train, decoder)

# ------------------------------------------------ registered ops and export

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 129, 129, 128), (3, 200, 170, 33)])
def test_kron_op_equals_the_direct_launch_and_its_fake(cuda, shape):
    """``mml::kron_fwd`` (B2 through the dispatcher) equals a direct launch
    bitwise and counts one launch; its fake gives the real output's shape,
    strides and dtype."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    args = _inputs(*shape, cuda)
    before = kron_fusion.kron_matmul.launches
    got = torch.ops.mml.kron_fwd(*args)
    want = kron_fusion._fwd_launch(*args)
    torch.cuda.synchronize()
    assert kron_fusion.kron_matmul.launches == before + 2
    assert torch.equal(got, want)
    with FakeTensorMode() as mode:
        fake = torch.ops.mml.kron_fwd(*(mode.from_tensor(t) for t in args))
    assert (fake.shape, fake.stride(), fake.dtype, fake.device) == (
        got.shape, got.stride(), got.dtype, got.device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("transposed", [False, True])
def test_conv3x3_op_equals_the_direct_launch_and_its_fake(cuda, dtype,
                                                          transposed):
    """``mml::conv3x3`` (B5 through the dispatcher) equals a direct launch
    of its CUDA kernel bitwise; its fake gives the real output's shape and
    channels-last strides."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    x, w = _conv_inputs((3, 37, 50, 64), cuda, dtype)
    before = paired_conv.conv3x3.launches
    got = torch.ops.mml.conv3x3(x, w, transposed)
    want = paired_conv._conv3x3_cuda(x, w, transposed)
    torch.cuda.synchronize()
    assert paired_conv.conv3x3.launches == before + 2
    assert torch.equal(got, want)
    assert got.is_contiguous(memory_format=torch.channels_last)
    with FakeTensorMode() as mode:
        fake = torch.ops.mml.conv3x3(mode.from_tensor(x), mode.from_tensor(w),
                                     transposed)
    assert (fake.shape, fake.stride(), fake.dtype) == (
        got.shape, got.stride(), got.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("paired,dtype", [(False, "float32"),
                                          (True, "bfloat16")])
def test_exported_artifact_equals_the_eager_forward_on_card(
        cuda, tmp_path, paired, dtype):
    """A dynamic-batch ``.pt2`` exported on the card serves batches 1, 3
    and 8 bitwise equal to the eager forward, launching B2 once and B5 4
    times (paired) per forward."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.serve import (export_infer,
                                                     load_exported,
                                                     make_infer_fn, manifest,
                                                     write_artifact)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, pallas_fusion="train",
                  paired_conv=paired, compute_dtype=dtype)
    model = define_model(opt, generator=torch.Generator().manual_seed(3))
    model.to(cuda)
    exported, outputs = export_infer(opt, model, "dynamic")
    path = str(tmp_path / "m.pt2")
    write_artifact(path, exported, manifest(opt, "dynamic", outputs, cuda))
    infer, eager = load_exported(path, cuda), make_infer_fn(opt, model)
    g = torch.Generator().manual_seed(4)
    for n in (1, 3, 8):
        x = torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                          generator=g)
        om = torch.randn(n, 80, generator=g)
        start = _launches()
        got = infer(x, om)
        torch.cuda.synchronize()
        launched = {k: v - start[k] for k, v in _launches().items()}
        assert launched == dict(B1=0, B2=1, B3=0, B4=0,
                                B5=4 if paired else 0)
        want = eager(x, om)
        assert sorted(got) == sorted(want) == outputs
        for k in want:
            assert torch.equal(got[k], want[k]), (n, k)
    with pytest.raises(ValueError, match="not cpu"):
        load_exported(path, "cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["ResNet34", "ResNet50"])
def test_deep_resnets_on_card_match_cpu(cuda, arch):
    """The fp32 eval forward of ResNet34 (paired) and ResNet50 on the card
    against the CPU from the same weights, at phase 5's tolerance (rtol
    2e-3 / atol 5e-4); ResNet34 launches B5 6 times per forward (two
    convolutions in each of the 64-channel stage's 3 blocks)."""
    from multimodal_learning_tpu_torch import models
    kw = {"paired": True} if arch == "ResNet34" else {}
    g = torch.Generator().manual_seed(6)
    x = torch.rand(4, 64, 64, 3, generator=g)
    cpu = getattr(models, arch)(path_dim=16, generator=torch.Generator()
                                .manual_seed(5), **kw).eval()
    card = getattr(models, arch)(path_dim=16, **kw).eval()
    card.load_state_dict(cpu.state_dict())
    card.to(cuda)
    with torch.no_grad():
        want = cpu(x)
        before = paired_conv.conv3x3.launches
        got = card(x.to(cuda))
        torch.cuda.synchronize()
    assert paired_conv.conv3x3.launches - before == (6 if kw else 0)
    for name, a, b in zip(("feat_f3", "features", "hazard", "pred"), got,
                          want):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-3, atol=5e-4,
                                   msg=f"{arch} {name}")


# --- the serving copy-in through the pinned staging buffer (serve/staging.py)

def _host_chunk(n, size=512, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (n, size, size, 3), dtype=np.uint8),
            rng.normal(size=(n, 80)).astype(np.float32))


def _as_tensor(xp, xo, dev):
    return (torch.as_tensor(xp, device=dev),
            torch.as_tensor(xo, dtype=torch.float32, device=dev))


@pytest.mark.cuda
def test_staged_copy_in_gives_the_bytes_of_as_tensor(cuda):
    """Chunks of 1, 64 and 27 patches of 512^2 reach the card bitwise as
    ``torch.as_tensor`` takes them, each through the pinned buffer (one
    ``serve.copy_in_staged`` a chunk), the buffer growing at 64 and not
    again at 27; the caller overwrites its arrays as soon as each call
    returns."""
    from multimodal_learning_tpu_torch.serve.staging import CopyIn, layout
    from multimodal_learning_tpu_torch.utils import logging as rec
    copy_in, sizes = CopyIn(cuda), []
    rec.enable()
    try:
        for n in (1, 64, 27):
            xp, xo = _host_chunk(n, seed=n)
            want = _as_tensor(xp, xo, cuda)
            got = copy_in(xp, xo)
            xp[:], xo[:] = 0, 0
            sizes.append(copy_in._buf.numel())
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                assert torch.equal(g, w), n
    finally:
        counts = rec.collect().counts
    assert sum(v for (k, _), v in counts.items()
               if k == "serve.copy_in_staged") == 3
    assert sizes == [layout([n * 512 * 512 * 3, n * 80 * 4])[1]
                     for n in (1, 64, 64)]


@pytest.mark.cuda
def test_staged_copy_in_waits_for_the_ring_between_back_to_back_calls(cuda):
    """Two calls with nothing read back between them, the DMA held back
    by a sleeping kernel ahead of the first: the second waits on the
    buffer's event (``serve.copy_in_waits``) and each call gets its own
    inputs."""
    from multimodal_learning_tpu_torch.serve.staging import CopyIn
    from multimodal_learning_tpu_torch.utils import logging as rec
    copy_in = CopyIn(cuda)
    a, b = _host_chunk(16, seed=1), _host_chunk(16, seed=2)
    want = [_as_tensor(*a, cuda), _as_tensor(*b, cuda)]
    copy_in(*a)
    torch.cuda.synchronize()
    rec.enable()
    try:
        torch.cuda._sleep(200_000_000)
        got = [copy_in(*a), copy_in(*b)]
    finally:
        counts = rec.collect().counts
    torch.cuda.synchronize()
    assert sum(v for (k, _), v in counts.items()
               if k == "serve.copy_in_waits") >= 1
    for g, w in zip(got, want):
        assert all(torch.equal(x, y) for x, y in zip(g, w))


@pytest.mark.cuda
def test_staged_copy_in_takes_views_pinned_and_device_tensors(cuda):
    """A numpy view that is not contiguous, a pageable CPU tensor and a
    pinned CPU tensor go through the buffer (made inside
    ``torch.inference_mode``, written outside it), the pinned one
    overwritten by the caller as soon as the call returns, behind a
    sleeping kernel that holds the copy back; a tensor on the card is used
    as it is."""
    from multimodal_learning_tpu_torch.serve.staging import CopyIn
    from multimodal_learning_tpu_torch.utils import logging as rec
    copy_in = CopyIn(cuda)
    xp, xo = _host_chunk(6, size=64, seed=3)
    with torch.inference_mode():
        copy_in(xp, xo)
    view, oview = xp[::2, 3:40].transpose(0, 2, 1, 3), xo[1::2]
    on_card = _as_tensor(xp, xo, cuda)
    pinned = (torch.from_numpy(xp).pin_memory(),
              torch.from_numpy(xo).pin_memory())
    torch.cuda.synchronize()
    rec.enable()
    try:
        got = copy_in(view, oview)
        got_pageable = copy_in(torch.from_numpy(xp), torch.from_numpy(xo))
        torch.cuda._sleep(200_000_000)
        got_pinned = copy_in(*pinned)
        pinned[0].zero_()
        pinned[1].zero_()
        got_card = copy_in(*on_card)
    finally:
        counts = rec.collect().counts
    torch.cuda.synchronize()
    assert sum(v for (k, _), v in counts.items()
               if k == "serve.copy_in_staged") == 3
    for g, w in zip(got, _as_tensor(view, oview, cuda)):
        assert torch.equal(g, w)
    for g, w in zip(got_pageable + got_pinned, on_card + on_card):
        assert torch.equal(g, w)
    assert got_card[0] is on_card[0] and got_card[1] is on_card[1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_served_outputs_equal_those_of_as_tensor_inputs(cuda, dtype):
    """``make_infer_fn`` on the card serves chunks of 1, 64 and 1500 patches
    of 64^2 (1500: the buffer grows), a view that is not contiguous, and
    two chunks in a row with no read-back between them whose arrays the
    caller overwrites as each call returns, bitwise as the serving forward
    of ``torch.as_tensor`` inputs."""
    from multimodal_learning_tpu_torch.config import Options
    from multimodal_learning_tpu_torch.models import define_model
    from multimodal_learning_tpu_torch.serve import (ServingForward,
                                                     make_infer_fn)
    opt = Options(mode="pathomic", task="grad", input_size_path=64,
                  path_dim=16, omic_dim=16, mmhid=16, pallas_fusion="train",
                  compute_dtype=dtype)
    model = define_model(opt, generator=torch.Generator().manual_seed(3))
    model.to(cuda)
    infer, fwd = make_infer_fn(opt, model), ServingForward(opt, model)

    def want(xp, xo):
        with torch.inference_mode():
            return fwd(*_as_tensor(xp, xo, cuda))

    chunks = [_host_chunk(n, size=64, seed=n) for n in (1, 64, 1500)]
    chunks.append((chunks[2][0][::3], chunks[2][1][::3]))
    for xp, xo in chunks:
        got, ref = infer(xp, xo), want(xp, xo)
        assert sorted(got) == sorted(ref)
        assert all(torch.equal(got[k], ref[k]) for k in ref), len(xp)
    a, b = _host_chunk(64, size=64, seed=5), _host_chunk(64, size=64, seed=6)
    ref = [want(*a), want(*b)]
    got = []
    for xp, xo in (a, b):
        got.append(infer(xp, xo))
        xp[:], xo[:] = 0, 0
    for g, r in zip(got, ref):
        assert all(torch.equal(g[k], r[k]) for k in r)


@pytest.mark.cuda
def test_staged_copy_in_keeps_concurrent_callers_apart(cuda):
    """Twelve threads (more than the card's host has cores) share one
    buffer, with a short switch interval: each call gets its own inputs."""
    import sys
    import threading
    from multimodal_learning_tpu_torch.serve.staging import CopyIn
    copy_in, ok = CopyIn(cuda), []

    def work(t):
        for j in range(5):
            xp, xo = _host_chunk(4, seed=100 * t + j)
            got, want = copy_in(xp, xo), _as_tensor(xp, xo, cuda)
            ok.append(all(torch.equal(g, w) for g, w in zip(got, want)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert len(ok) == 60 and all(ok)
