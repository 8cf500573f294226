"""Port ``masking.superpixel_attention_mask`` against the JAX package's
function on the same numpy inputs from a seed.

The JAX side runs as its own tests run it on the CPU: where its cost
reaches the Pallas Kronecker kernel, in interpret mode
(``MML_PALLAS_FORCE=1``, as ``tests/test_pallas_ops.py`` does); the port
takes the kernel's plain version on the CPU.  Masks must agree exactly;
the input gradients of the model case at rtol 1e-4 / atol 1e-5, the JAX
kernel tests' tolerance, both sides fp32.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from multimodal_learning_tpu.masking.superpixel import (
    superpixel_attention_mask as jax_mask)
from multimodal_learning_tpu_torch.masking import (
    frozen_params, saliency_grads, superpixel_attention_mask)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Let the JAX model reach the Pallas kernel, in interpret mode."""
    monkeypatch.setenv("MML_PALLAS_FORCE", "1")
    orig = pl.pallas_call

    def patched(*args, **kw):
        kw.setdefault("interpret", True)
        return orig(*args, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    import multimodal_learning_tpu.ops.kron_fusion as kf
    monkeypatch.setattr(kf.pl, "pallas_call", patched)


def jittered_grid(rng, b, h, w, cells, n_empty):
    """[b, h, w] int32 ids of a ``cells`` x ``cells`` grid whose cut lines
    move by up to a quarter cell per sample; ``n_empty`` cells of each
    sample take their right (or left) neighbour's id, so their own ids are
    left empty."""
    out = np.empty((b, h, w), np.int32)
    for s in range(b):
        cuts = []
        for size in (h, w):
            step = size / cells
            inner = np.arange(1, cells) * step + rng.uniform(
                -step / 4, step / 4, cells - 1)
            cuts.append(np.searchsorted(inner, np.arange(size) + 0.5))
        ids = cuts[0][:, None] * cells + cuts[1][None, :]
        for cell in rng.choice(cells * cells, n_empty, replace=False):
            ids[ids == cell] = cell + 1 if cell % cells < cells - 1 \
                else cell - 1
        out[s] = ids
    return out


def _port_masks(cost_fn, x_path, x_omic, sp, n, path_k, omic_k):
    pm, om = superpixel_attention_mask(
        cost_fn, torch.from_numpy(x_path), torch.from_numpy(x_omic),
        torch.from_numpy(sp), n, path_k, omic_k)
    assert pm.dtype == om.dtype == torch.float32
    return pm.numpy(), om.numpy()


def _jax_masks(cost_fn, x_path, x_omic, sp, n, path_k, omic_k):
    pm, om = jax_mask(cost_fn, jnp.asarray(x_path), jnp.asarray(x_omic),
                      jnp.asarray(sp), n, path_k, omic_k)
    return np.asarray(pm), np.asarray(om)


def test_two_segments_match_jax():
    """The JAX test's case (``tests/test_masking.py``): the cost depends
    only on the right half and omic feature 3."""
    B, H, W, D = 2, 16, 16, 8
    sp = np.zeros((B, H, W), np.int32)
    sp[:, :, 8:] = 1
    x_path = np.ones((B, H, W, 3), np.float32)
    x_omic = np.ones((B, D), np.float32)

    def cost(xp, xo):
        return (xp[:, :, 8:, :]).sum() * 0.1 + xo[:, 3].sum() * 2.0

    got = _port_masks(cost, x_path, x_omic, sp, 2, 1, 1)
    want = _jax_masks(cost, x_path, x_omic, sp, 2, 1, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][:, :, 8:], 1.0)
    np.testing.assert_array_equal(got[0][:, :, :8], 0.0)
    assert got[1][:, 3].all() and got[1].sum() == B


def test_ties_and_empty_segments_match_jax():
    """Segments whose gradient is exactly 0 tie with the empty ids (mean
    0); ``path_k`` cuts inside that tied group, so the lower-id-first rule
    of ``jax.lax.top_k`` decides which are masked.  Omic ties at the k-th
    value are all masked."""
    rng = np.random.default_rng(11)
    B, H, W, D, cells = 3, 40, 40, 12, 6
    n = cells * cells + 4             # ids 36..39 are never used
    sp = jittered_grid(rng, B, H, W, cells, n_empty=5)
    x_path = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    x_omic = rng.normal(size=(B, D)).astype(np.float32)
    # per-segment weight: positive on a few ids, 0 on many, negative else
    seg_w = rng.choice([1.0, 0.0, -1.0], size=(B, n), p=[0.15, 0.5, 0.35])
    wmap = (np.take_along_axis(seg_w, sp.reshape(B, -1), 1).reshape(
        B, H, W, 1) * rng.uniform(0.5, 1.5, (B, H, W, 3))).astype(np.float32)
    # omic weights with a three-way tie at the k-th largest (2.0)
    w_omic = np.tile(np.array([3.0, 2.5, 2.0, 2.0, 2.0, 1.0, 0.5, 0.0, -1.0,
                               -2.0, 0.0, 0.0], np.float32), (B, 1))
    path_k = int((seg_w > 0).sum(1).max()) + 6

    def cost_torch(xp, xo):
        return (xp * torch.from_numpy(wmap)).sum() + (
            xo * torch.from_numpy(w_omic)).sum()

    def cost_jax(xp, xo):
        return (xp * wmap).sum() + (xo * w_omic).sum()

    got = _port_masks(cost_torch, x_path, x_omic, sp, n, path_k, 4)
    want = _jax_masks(cost_jax, x_path, x_omic, sp, n, path_k, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1].sum(1) == 5).all()   # 3.0, 2.5 and the three 2.0s
    # some but not all zero-gradient segments are masked: the tie decided
    zero_ids = [np.unique(sp[s][seg_w[s][sp[s]] == 0]) for s in range(B)]
    masked = [np.unique(sp[s][got[0][s] == 1]) for s in range(B)]
    assert any(0 < len(np.intersect1d(z, m)) < len(z)
               for z, m in zip(zero_ids, masked))


def test_segment_ids_outside_the_range_are_never_masked():
    B, H, W = 1, 8, 8
    sp = np.zeros((B, H, W), np.int32)
    sp[:, :4] = 1
    sp[:, :, :2] = 7                  # outside num_superpixels = 2
    x_path = np.ones((B, H, W, 3), np.float32)
    x_omic = np.ones((B, 4), np.float32)

    def cost(xp, xo):
        return xp.sum() + xo[:, 0].sum()

    got = _port_masks(cost, x_path, x_omic, sp, 2, 2, 1)
    want = _jax_masks(cost, x_path, x_omic, sp, 2, 2, 1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][:, :, :2], 0.0)


def test_pathomic_saliency_matches_jax(interpret_pallas):
    """A small pofusion ``PathomicModel`` in eval mode, its weights carried
    from flax to the port by the weight bridge; the cost is the NLL on
    ``pred_fuse`` as the JAX masked step computes it
    (``train/steps.py:396-400``).  Both input gradients and both masks."""
    from multimodal_learning_tpu import models as jm
    from multimodal_learning_tpu.losses.task import nll_loss as jax_nll
    from multimodal_learning_tpu_torch import models as pm
    from multimodal_learning_tpu_torch.losses import nll_loss
    from multimodal_learning_tpu_torch.models.import_flax import (
        state_dict_from_flax)

    rng = np.random.default_rng(5)
    B, S, n = 3, 64, 16
    dims = dict(path_dim=16, omic_dim=16, mmhid=16, label_dim=3,
                pallas_fusion="train")
    jmod = jm.PathomicModel(**dims)
    variables = jmod.init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(4)},
        x_path=jnp.zeros((1, S, S, 3)), x_omic=jnp.zeros((1, 80)),
        train=False)
    params = variables["params"]
    stats = jax.tree_util.tree_map(
        lambda v: np.asarray(v) + rng.uniform(0.0, 0.2, v.shape).astype(
            np.float32), variables["batch_stats"])
    port = pm.PathomicModel(**dims)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()

    x_path = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    x_omic = rng.normal(size=(B, 80)).astype(np.float32)
    labels = rng.integers(0, 3, B).astype(np.int32)
    sp = jittered_grid(rng, B, S, S, 4, n_empty=2)

    def cost_jax(xp, xo):
        o = jmod.apply({"params": params, "batch_stats": stats},
                       x_path=xp, x_omic=xo, train=False)
        return jax_nll(o.pred_fuse, jnp.asarray(labels))

    def cost_torch(xp, xo):
        o = port(x_path=xp, x_omic=xo)
        return nll_loss(o.pred_fuse, torch.from_numpy(labels))

    want_g = jax.grad(cost_jax, argnums=(0, 1))(jnp.asarray(x_path),
                                                jnp.asarray(x_omic))
    with frozen_params(port):
        got_g = saliency_grads(cost_torch, torch.from_numpy(x_path),
                               torch.from_numpy(x_omic))
        got = _port_masks(cost_torch, x_path, x_omic, sp, n, 5, 5)
    assert all(p.requires_grad for p in port.parameters())
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)
    want = _jax_masks(cost_jax, x_path, x_omic, sp, n, 5, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[1].sum(1) >= 5).all()


def test_frozen_params_restores_requires_grad():
    lin = torch.nn.Linear(3, 2)
    lin.bias.requires_grad_(False)
    with frozen_params(lin):
        assert not any(p.requires_grad for p in lin.parameters())
    assert lin.weight.requires_grad and not lin.bias.requires_grad
