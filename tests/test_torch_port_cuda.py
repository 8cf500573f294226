"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so they skip
here with a reason.  The file imports no JAX, so it runs on the machine with
the card, where the repository's ``tests/conftest.py`` (which imports JAX)
is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

Tolerance: rtol 1e-4 / atol 1e-5, the JAX Pallas tests' (both sides fp32;
the kernels sum in another order than the plain versions).
"""
import pytest
import torch

from multimodal_learning_tpu_torch.ops import kron_fusion

SHAPES = [(16, 129, 129, 128), (1, 129, 129, 128), (37, 129, 129, 128),
          (4, 9, 9, 16), (3, 200, 170, 33)]
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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
@pytest.mark.parametrize("shape", SHAPES)
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
@pytest.mark.parametrize("shape", SHAPES)
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
@pytest.mark.parametrize("shape", SHAPES)
def test_kron_bwd_kernels_match_plain(cuda, shape):
    o1, o2, w, _ = _inputs(*shape, cuda, seed=3)
    g = torch.randn(shape[0], shape[3], device=cuda)
    torch.testing.assert_close(kron_fusion.kron_bwd_dw(o1, o2, g),
                               kron_fusion.kron_bwd_dw_plain(o1, o2, g), **TOL)
    for a, b in zip(kron_fusion.kron_bwd_dvec(o1, o2, w, g),
                    kron_fusion.kron_bwd_dvec_plain(o1, o2, w, g)):
        torch.testing.assert_close(a, b, **TOL)


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
