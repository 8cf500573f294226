"""Port ``ops.kron_fusion.kron_matmul`` against the JAX package's Pallas
``kron_matmul`` (interpret mode, as ``tests/test_pallas_ops.py`` runs it).

On the CPU the port's wrapper takes its plain version; the CUDA kernel is
held against that plain version on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``).  Tolerance: the JAX kernel tests' rtol 1e-4, atol 1e-5,
both sides fp32."""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

from multimodal_learning_tpu_torch.ops import kron_fusion as port_kf


@pytest.fixture(autouse=True)
def _interpret_pallas(monkeypatch):
    """Run pallas_call in interpreter mode on CPU."""
    monkeypatch.setenv("MML_PALLAS_FORCE", "1")
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import multimodal_learning_tpu.ops.kron_fusion as kf
    monkeypatch.setattr(kf.pl, "pallas_call", patched)
    yield


def _inputs(B, d1, d2, K, seed):
    # the serving path's scales: post-ReLU features in [0, 1) and encoder1
    # at its max init N(0, 1/sqrt(fan_in)), so outputs are O(1) and the
    # atol is meaningful at 16641-term sums
    rng = np.random.default_rng(seed)
    o1 = rng.random((B, d1)).astype(np.float32)
    o2 = rng.random((B, d2)).astype(np.float32)
    w = (rng.normal(size=(d2, d1, K)) / np.sqrt(d1 * d2)).astype(np.float32)
    b = rng.normal(size=(K,)).astype(np.float32)
    return o1, o2, w, b


def _linear_layout(w):
    """JAX kernel layout W[j, i, k] -> torch Linear weight [K, d1*d2] with
    weight[k, i*d2 + j] = W[j, i, k]."""
    d2, d1, K = w.shape
    return np.ascontiguousarray(w.transpose(2, 1, 0).reshape(K, d1 * d2))


@pytest.mark.parametrize("B,d1,d2,K", [(4, 9, 9, 16), (3, 129, 129, 128)])
def test_kron_matmul_matches_jax(B, d1, d2, K):
    from multimodal_learning_tpu.ops import kron_matmul
    o1, o2, w, b = _inputs(B, d1, d2, K, seed=B * 1000 + d1)
    want = np.asarray(kron_matmul(jnp.asarray(o1), jnp.asarray(o2),
                                  jnp.asarray(w), jnp.asarray(b)))
    before = port_kf.kron_matmul.launches
    got = port_kf.kron_matmul(torch.from_numpy(o1), torch.from_numpy(o2),
                              torch.from_numpy(_linear_layout(w)),
                              torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # the CPU path is the plain version: no kernel launch is counted
    assert port_kf.kron_matmul.launches == before


def test_kron_matmul_plain_is_the_jax_reference_einsum():
    o1, o2, w, b = _inputs(5, 7, 11, 6, seed=3)
    want = np.einsum("bi,bj,jik->bk", o1, o2, w) + b
    got = port_kf.kron_matmul_plain(
        torch.from_numpy(o1), torch.from_numpy(o2),
        torch.from_numpy(_linear_layout(w)), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)


def test_kron_matmul_refuses_devices_without_a_kernel():
    o1, o2, w, b = (torch.from_numpy(a) for a in _inputs(2, 3, 4, 5, seed=4))
    with pytest.raises(ValueError, match="no kernel"):
        port_kf.kron_matmul(o1.to("meta"), o2.to("meta"), w.to("meta"),
                            b.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        port_kf.kron_matmul(o1.to("meta"), o2, w, b)


def _jnp(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in arrays]


GRAD_SHAPES = [(3, 5, 7, 8), (4, 9, 9, 16), (5, 13, 6, 3)]


@pytest.mark.parametrize("B,d1,d2,K", GRAD_SHAPES)
def test_kron_matmul_grads_match_jax(B, d1, d2, K):
    """Gradients of sum(sin(kron_matmul)) in o1, o2, W and b against
    ``jax.grad`` through the JAX package's custom VJP (its two backward
    kernels in interpret mode); the port's plain backward versions, which
    the CUDA kernels B3 and B4 are held against on the card, give the same
    do1, do2 and dW from the same output gradient."""
    import jax
    from multimodal_learning_tpu.ops import kron_matmul
    o1, o2, w, b = _inputs(B, d1, d2, K, seed=10 * B + d2)
    jo1, jo2, jw, jb = _jnp(o1, o2, w, b)
    y, vjp = jax.vjp(kron_matmul, jo1, jo2, jw, jb)
    g = np.cos(np.asarray(y))            # d sum(sin y) / dy
    want = [np.asarray(a) for a in vjp(jnp.asarray(g))]
    want[2] = _linear_layout(want[2])    # dW [d2, d1, K] -> [K, d1*d2]
    args = _torch(o1, o2, _linear_layout(w), b)
    torch.sin(port_kf.kron_matmul(*args)).sum().backward()
    for arg, ref, name in zip(args, want, ("o1", "o2", "weight", "bias")):
        np.testing.assert_allclose(arg.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    tg = torch.from_numpy(g)
    t1, t2, tw = (torch.from_numpy(a) for a in (o1, o2, _linear_layout(w)))
    np.testing.assert_allclose(port_kf.kron_bwd_dw(t1, t2, tg).numpy(),
                               want[2], rtol=1e-4, atol=1e-5)
    for got, ref in zip(port_kf.kron_bwd_dvec(t1, t2, tw, tg), want[:2]):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("B,d1,d2,K", GRAD_SHAPES + [(16, 17, 17, 16)])
def test_kron_matmul_dropout_matches_jax(B, d1, d2, K):
    """Forward and gradients of the masked train contraction against the
    JAX package's Pallas ``kron_matmul_dropout`` (interpret mode) on the
    same numpy mask; the port reads W as the torch Linear weight, the
    transpose of JAX's ``w2d``."""
    import jax
    from multimodal_learning_tpu.ops import kron_matmul_dropout
    rng = np.random.default_rng(B * d1 + K)
    o1, o2, _, b = _inputs(B, d1, d2, K, seed=B + d1)
    w2d = (rng.normal(size=(d1 * d2, K)) / np.sqrt(d1 * d2)).astype(
        np.float32)
    maskf = ((rng.random((B, d1 * d2)) < 0.75) / 0.75).astype(np.float32)
    loss = lambda *a: jnp.sum(jnp.sin(kron_matmul_dropout(*a, maskf)))
    jargs = _jnp(o1, o2, w2d, b)
    want_y = np.asarray(kron_matmul_dropout(*jargs, jnp.asarray(maskf)))
    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*jargs)
    args = _torch(o1, o2, w2d.T, b)
    before = port_kf.kron_matmul_dropout.launches
    y = port_kf.kron_matmul_dropout(*args, torch.from_numpy(maskf))
    assert port_kf.kron_matmul_dropout.launches == before  # plain on CPU
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=1e-4,
                               atol=1e-5)
    torch.sin(y).sum().backward()
    for arg, ref, name in zip(args, want, ("o1", "o2", "weight", "bias")):
        ref = np.asarray(ref).T if name == "weight" else np.asarray(ref)
        np.testing.assert_allclose(arg.grad.numpy(), ref, rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("B,d1,d2,K", [(2, 3, 5, 7), (4, 9, 9, 16)])
def test_kron_matmul_dropout_plain_with_ones_mask_is_kron_matmul_plain(
        B, d1, d2, K):
    """With an all-ones mask the masked train contraction is the eval
    contraction: the identity that lets one CUDA kernel serve both (B1 with
    the mask, B2 without)."""
    o1, o2, w, b = _inputs(B, d1, d2, K, seed=7 * B + K)
    args = [torch.from_numpy(a) for a in (o1, o2, _linear_layout(w), b)]
    ones = torch.ones(B, d1 * d2)
    torch.testing.assert_close(port_kf.kron_matmul_dropout_plain(*args, ones),
                               port_kf.kron_matmul_plain(*args),
                               rtol=1e-4, atol=1e-5)


def test_partials_scratch_is_cached_per_device_and_stream():
    """The forward kernels' scratch is made once per device and stream and
    grown, never shrunk, so a call allocates only its output."""
    cpu = torch.device("cpu")
    first = port_kf._partials(cpu, -1, 100)
    assert first.numel() == 100 and first.dtype == torch.float32
    assert port_kf._partials(cpu, -1, 60) is first
    grown = port_kf._partials(cpu, -1, 300)
    assert grown.numel() == 300 and port_kf._partials(cpu, -1, 100) is grown
    assert port_kf._partials(cpu, -2, 10) is not grown
    for key in [(cpu, -1), (cpu, -2)]:
        del port_kf._scratch[key]


def test_library_path_covers_shared_headers(tmp_path, monkeypatch):
    """An edited header gives a new library name, so a stale build is never
    loaded; an unrelated source does not."""
    from multimodal_learning_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    (tmp_path / "other.cu").write_text("// other\n")
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "other.cu").write_text("// other, edited\n")
    assert _build.library_path("k") == first
    (tmp_path / "k.cuh").write_text("// v2\n")
    assert _build.library_path("k") != first
    assert os.path.basename(first).startswith("libk-")
