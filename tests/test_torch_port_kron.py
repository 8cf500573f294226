"""Port ``ops.kron_fusion.kron_matmul`` against the JAX package's Pallas
``kron_matmul`` (interpret mode, as ``tests/test_pallas_ops.py`` runs it).

On the CPU the port's wrapper takes its plain version; the CUDA kernel is
held against that plain version on the card (``test_torch_port_cuda.py``,
``chip_smoke.py``).  Tolerance: the JAX kernel tests' rtol 1e-4, atol 1e-5,
both sides fp32."""
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
