"""``--init_type`` re-initialisation (``models/common.py:apply_init_type``)
against the JAX package's ``apply_init_type``.

One initial tree, a port model's, carried to the JAX package by the weight
bridge: the set of leaves each package's rule changes must be the same for
every type, the leaves it keeps must stay bitwise and its zeros must be
exact.  The JAX rule runs on that tree with every leaf cut to its first
two entries along each axis: it picks leaves by name, rank and BatchNorm
sibling, not by size (and zeros stay zeros when cut), while its eager
per-shape draws and QRs of the full ResNet take minutes on a loaded CPU.
The draws agree in law, not in bits, so each redrawn kernel's standard
deviation is held to the JAX law on the flax shape within five
standard errors of the estimate (5 / sqrt(2 n) relative, n its elements),
the 3-D Bilinear ``linear_z`` kernel [out, in1, in2] included, where
torch's own ``nn.init`` law differs; orthogonal kernels are orthogonal to
1e-5 once divided by the gain.  Then the JAX package's own draws at each
distinct full flax shape of the model are held against the port's: their
standard deviations against each other and the law, and their largest
values (xavier truncates, the others do not).  ``max``/``none`` are the identity, and a
re-initialisation leaves the CRD heads' and bank's draws as they were.
"""
import math

import numpy as np
import pytest
import torch

import jax

from multimodal_learning_tpu.models.common import \
    apply_init_type as j_apply_init_type
from multimodal_learning_tpu_torch.config import Options
from multimodal_learning_tpu_torch.models import (define_model,
                                                  flax_from_state_dict)
from multimodal_learning_tpu_torch.models.common import (apply_init_type,
                                                         reinit_generator)
from multimodal_learning_tpu_torch.train import make_lr_schedule
from multimodal_learning_tpu_torch.train.steps import init_teacher_state

GAIN = 0.02
TYPES = ("normal", "xavier", "kaiming", "orthogonal")
# path_dim 16 and omic_dim 8 make linear_z1 [16, 16, 8], whose flax fans
# (256 in, 128 out) differ from torch's (128 in)
DIMS = dict(mode="pathomic", task="grad", path_dim=16, omic_dim=8, mmhid=16,
            feat_dim=8, input_size_path=32, batch_size=4, reg_type="none",
            pallas_fusion="train", init_gain=GAIN)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _model(fusion_type="pofusion", **kw):
    opt = Options(**dict(DIMS, fusion_type=fusion_type, **kw))
    return opt, define_model(opt, generator=torch.Generator().manual_seed(3))


def _law_std(init_type, shape):
    rf = math.prod(shape) // (shape[-2] * shape[-1])
    fan_in, fan_out = shape[-2] * rf, shape[-1] * rf
    return {"normal": GAIN, "xavier": GAIN * math.sqrt(2 / (fan_in + fan_out)),
            "kaiming": math.sqrt(2 / fan_in)}[init_type]


@pytest.mark.parametrize("fusion_type", ["pofusion", "LMF"])
@pytest.mark.parametrize("init_type", TYPES)
def test_apply_init_type_changes_the_leaves_jax_changes(init_type,
                                                        fusion_type):
    opt, model = _model(fusion_type)
    before, _ = flax_from_state_dict(model.state_dict())
    before = {k: v.copy() for k, v in _flat(before).items()}
    cut = {k: v[tuple(slice(0, 2) for _ in v.shape)] for k, v in
           before.items()}
    want = _flat(jax.tree_util.tree_map(np.asarray, j_apply_init_type(
        jax.random.PRNGKey(0), _unflat(cut), init_type, GAIN)))
    apply_init_type(model, init_type, GAIN, reinit_generator(0))
    got = _flat(flax_from_state_dict(model.state_dict())[0])
    assert set(got) == set(want) == set(before)
    changed = {k for k in before if not np.array_equal(got[k], before[k])}
    j_changed = {k for k in cut if not np.array_equal(want[k], cut[k])}
    assert changed == j_changed
    assert not any(k[-1].startswith(("factor", "fusion_")) for k in changed)
    for k, v in got.items():
        if k[-1] == "bias":
            assert not v.any(), k                        # exact zeros
        if k[-1] == "scale":
            assert abs(v.mean() - 1) < 5 * GAIN / math.sqrt(v.size), k
        if k not in changed or k[-1] != "kernel":
            continue
        assert v.dtype == np.float32
        if init_type == "orthogonal":
            q = v.reshape(-1, v.shape[-1]).astype(np.float64) / GAIN
            gram = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
            np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-5,
                                       err_msg=str(k))
            continue
        law = _law_std(init_type, v.shape)
        assert abs(v.std() / law - 1) < 5 / math.sqrt(2 * v.size), (
            k, v.shape, v.std(), law)
    if init_type == "kaiming" and fusion_type == "pofusion":
        z = got[("fusion", "unit1", "linear_z", "kernel")]
        assert z.shape == (16, 16, 8)
        torch_law = math.sqrt(2 / (16 * 8))   # nn.init on [out, in1, in2]
        assert abs(z.std() / torch_law - 1) > 0.2


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


@pytest.mark.parametrize("init_type", TYPES)
def test_kernel_draws_match_jax_draws_at_the_flax_shapes(init_type):
    """Each distinct kernel shape of the model at its full flax shape (the
    3-D ``linear_z`` [16, 16, 8] among them), drawn by the JAX package's
    ``apply_init_type`` on a tree of one zero kernel per shape and by the
    port's re-initialisation of the model.  The two standard deviations
    agree with each other within five standard errors of their difference
    and each lies within five standard errors of the law.  xavier draws a
    normal truncated at two of its sigmas in both packages, the others do
    not truncate: the largest |w| tells them apart.  Orthogonal kernels
    are orthogonal to 1e-5 in both, and their root mean squares agree to
    1e-3."""
    opt, model = _model()
    apply_init_type(model, init_type, GAIN, reinit_generator(0))
    port = {}
    for k, v in _flat(flax_from_state_dict(model.state_dict())[0]).items():
        if k[-1] == "kernel" and v.ndim >= 2 and "_bn" not in k[-2]:
            port.setdefault(v.shape, []).append(v)
    assert (16, 16, 8) in port
    shapes = sorted(port)
    tree = {f"k{i}": {"kernel": np.zeros(shape, np.float32)}
            for i, shape in enumerate(shapes)}
    drawn = j_apply_init_type(jax.random.PRNGKey(1), tree, init_type, GAIN)
    for i, shape in enumerate(shapes):
        w_jax = np.asarray(drawn[f"k{i}"]["kernel"], np.float64)
        w_port = np.concatenate([v.ravel() for v in port[shape]]).astype(
            np.float64)
        s_jax, s_port = w_jax.std(), w_port.std()
        if init_type == "orthogonal":
            # min(rows, cols) unit vectors times the gain: the same root
            # mean square in both, whatever the draw
            rms = [np.sqrt(np.mean(w ** 2)) for w in (w_port, w_jax)]
            assert abs(rms[0] / rms[1] - 1) < 1e-3, (shape, rms)
            q = w_jax.reshape(-1, shape[-1]) / GAIN
            gram = q.T @ q if q.shape[0] >= q.shape[1] else q @ q.T
            np.testing.assert_allclose(gram, np.eye(len(gram)), atol=1e-5)
            continue
        law = _law_std(init_type, shape)
        se = lambda n: 1 / math.sqrt(2 * n)
        assert abs(s_jax / law - 1) < 5 * se(w_jax.size), (shape, s_jax, law)
        assert abs(s_port / law - 1) < 5 * se(w_port.size), (shape, s_port,
                                                             law)
        assert abs(s_port / s_jax - 1) < 5 * math.hypot(
            se(w_jax.size), se(w_port.size)), (shape, s_port, s_jax)
        if min(w_jax.size, w_port.size) < 20000:
            continue   # too few draws to reach the tails
        for w in (w_jax, w_port):
            top = np.abs(w).max() / (law / .87962566103423978)
            if init_type == "xavier":
                assert 1.95 < top <= 2.0 + 1e-5, (shape, top)
            else:
                assert top > 2.5, (shape, top)


@pytest.mark.parametrize("init_type", ["max", "none", "normal_default"])
def test_kept_init_types_are_the_identity(init_type):
    opt, model = _model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    apply_init_type(model, init_type, GAIN, reinit_generator(0))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_unknown_init_type_raises():
    with pytest.raises(NotImplementedError, match="not implemented"):
        apply_init_type(_model()[1], "uniform", GAIN, reinit_generator(0))


def test_reinit_leaves_the_crd_heads_and_bank_draws():
    states = {}
    for init_type in ("max", "xavier"):
        opt, model = _model(init_type=init_type, CRD_distill=1, nce_k=6,
                            n_data=16)
        states[init_type] = init_teacher_state(
            opt, model, make_lr_schedule(opt, 4), 16, seed=5, device="cpu")
    a, b = states["max"], states["xavier"]
    for k, v in a.embeds.state_dict().items():
        assert torch.equal(v, b.embeds.state_dict()[k]), k
    for k in ("memory_v1", "memory_v2"):
        assert torch.equal(getattr(a.banks["fuse"], k),
                           getattr(b.banks["fuse"], k)), k
    assert not torch.equal(a.model.path_net.conv1.weight,
                           b.model.path_net.conv1.weight)
