"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so they skip
here with a reason.  The file imports no JAX, so it runs on the machine with
the card, where the repository's ``tests/conftest.py`` (which imports JAX)
is left out:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py
"""
import pytest
import torch

from multimodal_learning_tpu_torch.ops import kron_fusion


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _inputs(B, d1, d2, K, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    o1, o2 = torch.rand(B, d1, generator=g), torch.rand(B, d2, generator=g)
    w = torch.randn(K, d1 * d2, generator=g) / (d1 * d2) ** 0.5
    b = torch.randn(K, generator=g)
    return [t.to(dev) for t in (o1, o2, w, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 129, 129, 128), (1, 129, 129, 128),
                                   (37, 129, 129, 128), (4, 9, 9, 16),
                                   (3, 200, 170, 33)])
def test_kron_kernel_matches_plain(cuda, shape):
    args = _inputs(*shape, cuda)
    before = kron_fusion.kron_matmul.launches
    got = kron_fusion.kron_matmul(*args)
    torch.cuda.synchronize()
    assert kron_fusion.kron_matmul.launches == before + 1
    torch.testing.assert_close(got, kron_fusion.kron_matmul_plain(*args),
                               rtol=1e-4, atol=1e-5)


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
    with pytest.raises(NotImplementedError, match="backward"):
        kron_fusion.kron_matmul(o1, o2, w.requires_grad_(), b)
