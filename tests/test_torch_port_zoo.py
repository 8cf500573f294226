"""The port's distiller zoo (``losses/distiller_zoo.py``) against the JAX
package's.

Every function gets the same seeded numpy inputs in both packages, and is
held in value and in its gradient with respect to the student input at
fp32 rtol 1e-5 / atol 1e-6.  The map-based losses take NHWC maps in JAX and
NCHW maps in the port: the test transposes the same array.  ``VIDHead``'s
parameters come from its flax initialisation.  RKD also runs at a batch
with two equal rows, whose zero distance the guarded square root must
carry through without a NaN.

KDSVD rests on singular vectors, whose sign LAPACK does not fix: the two
packages may return a column negated.  ``_kdsvd_basis`` is compared with
each column's sign aligned to the JAX one, and ``kdsvd_loss`` (whose value
depends on the teacher bases' signs; the student's are aligned onto the
teacher's) on inputs where both packages' teacher bases agree in sign: the
first of a fixed list of seeds for which they do.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import multimodal_learning_tpu.losses.distiller_zoo as jzoo
import multimodal_learning_tpu_torch.losses.distiller_zoo as pzoo

FN = dict(rtol=1e-5, atol=1e-6)


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got.detach() if isinstance(
        got, torch.Tensor) else got), np.asarray(want), err_msg=what, **FN)


def _nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def _both(jfn, pfn, s, t, nchw=False):
    """Value and gradient with respect to ``s`` (a list of arrays) of the
    summed outputs in both packages; the port gets NCHW maps when asked."""
    def jtotal(ss):
        out = jfn(ss, [jnp.asarray(x) for x in t])
        return sum(out) if isinstance(out, list) else out

    jval, jgrad = jax.value_and_grad(jtotal)([jnp.asarray(x) for x in s])
    conv = _nchw if nchw else (lambda a: a)
    ps = [torch.from_numpy(conv(x)).requires_grad_() for x in s]
    out = pfn(ps, [torch.from_numpy(conv(x)) for x in t])
    pval = sum(out) if isinstance(out, list) else out
    pval.backward()
    pgrad = [p.grad.numpy() for p in ps]
    if nchw:
        pgrad = [g.transpose(0, 2, 3, 1) for g in pgrad]
    return pval, jval, pgrad, jgrad


def _check(jfn, pfn, s, t, nchw=False):
    pval, jval, pgrad, jgrad = _both(jfn, pfn, s, t, nchw)
    _close(pval, jval, "value")
    for a, b in zip(pgrad, jgrad):
        assert np.isfinite(a).all()
        _close(a, b, "grad")
    return pval


def _vec(seed, b=8, d=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, d)).astype(np.float32),
            rng.normal(size=(b, d)).astype(np.float32))


VECTOR_LOSSES = {
    "feats_kl": "feats_kl", "hint": "hint_loss",
    "correlation": "correlation_loss", "rkd": "rkd_loss", "pkt": "pkt_loss",
    "ab": "ab_loss", "factor_2d": "factor_transfer_loss"}


@pytest.mark.parametrize("case", sorted(VECTOR_LOSSES))
def test_vector_losses_match_jax(case):
    name = VECTOR_LOSSES[case]
    f_s, f_t = _vec(len(case))
    _check(lambda s, t: getattr(jzoo, name)(s[0], t[0]),
           lambda s, t: getattr(pzoo, name)(s[0], t[0]), [f_s], [f_t])


def test_rkd_with_two_equal_rows_matches_jax():
    """A zero off-diagonal distance: the masked square root keeps the value
    and the gradient finite in both packages, and equal.  The entries are
    multiples of 1/4, so that every squared distance is exact in fp32 and
    the equal rows' distance is 0 in both packages (with normal entries it
    is the Gram's rounding noise, which each framework sums its own way)."""
    rng = np.random.default_rng(3)
    f_s, f_t = (rng.integers(-4, 5, (8, 16)).astype(np.float32) / 4
                for _ in range(2))
    f_s[5] = f_s[2]
    f_t[7] = f_t[1]
    val = _check(lambda s, t: jzoo.rkd_loss(s[0], t[0]),
                 lambda s, t: pzoo.rkd_loss(s[0], t[0]), [f_s], [f_t])
    assert torch.isfinite(val)


def _maps(seed, shapes=((4, 8, 8, 6), (4, 8, 8, 10))):
    rng = np.random.default_rng(seed)
    return ([rng.normal(size=s).astype(np.float32) for s in shapes],
            [rng.normal(size=s).astype(np.float32) for s in shapes])


# name: (JAX function, port function, number of layers)
MAP_LOSSES = {
    "attention": (jzoo.attention_loss, pzoo.attention_loss, 2),
    "fsp": (jzoo.fsp_loss, pzoo.fsp_loss, 2),
    "nst": (jzoo.nst_loss, pzoo.nst_loss, 1),
    "factor_maps": (jzoo.factor_transfer_loss, pzoo.factor_transfer_loss, 1),
    "factor_maps_p2": (
        lambda s, t: jzoo.factor_transfer_loss(s, t, p2=2),
        lambda s, t: pzoo.factor_transfer_loss(s, t, p2=2), 1),
    "ab_maps": (jzoo.ab_loss, pzoo.ab_loss, 1),
}


@pytest.mark.parametrize("case", sorted(MAP_LOSSES))
def test_map_losses_match_jax_across_layouts(case):
    jfn, pfn, layers = MAP_LOSSES[case]
    s, t = _maps(len(case))
    if layers == 1:   # a function of one map pair
        def one(f):
            return lambda s, t: f(s[0], t[0])

        s, t, jfn, pfn = s[:1], t[:1], one(jfn), one(pfn)
    _check(jfn, pfn, s, t, nchw=True)


def test_vid_head_matches_jax():
    rng = np.random.default_rng(4)
    f_s = rng.normal(size=(6, 8)).astype(np.float32)
    f_t = rng.normal(size=(6, 12)).astype(np.float32)
    head = jzoo.VIDHead(12, mid_dim=10)
    params = head.init(jax.random.PRNGKey(0), jnp.asarray(f_s),
                       jnp.asarray(f_t))["params"]
    jval, jgrad = jax.value_and_grad(
        lambda x: head.apply({"params": params}, x, jnp.asarray(f_t)))(
        jnp.asarray(f_s))
    port = pzoo.VIDHead(8, 12, mid_dim=10)
    port.load_state_dict({
        **{f"regressor.{2 * i}.weight": torch.from_numpy(
            np.array(params[f"Dense_{i}"]["kernel"]).T) for i in range(3)},
        "log_scale": torch.from_numpy(np.array(params["log_scale"]))})
    np.testing.assert_allclose(port.log_scale.detach().numpy(),
                               np.log(np.exp(5.0 - 1e-5) - 1.0), rtol=1e-6)
    x = torch.from_numpy(f_s).requires_grad_()
    pval = port(x, torch.from_numpy(f_t))
    pval.backward()
    _close(pval, jval, "value")
    _close(x.grad, jgrad, "grad")


def _aligned(v_port, v_jax):
    """``v_port`` with each column's sign set to agree with ``v_jax``."""
    sign = np.sign(np.einsum("bcn,bcn->bn", v_port, v_jax))
    return v_port * sign[:, None, :]


def test_kdsvd_basis_and_align_match_jax_up_to_column_signs():
    s, _ = _maps(9, ((3, 6, 5, 4),))
    jv, js = jzoo._kdsvd_basis(jnp.asarray(s[0]), 3)
    pv, ps = pzoo._kdsvd_basis(torch.from_numpy(_nchw(s[0])), 3)
    _close(ps, js, "singular values")
    _close(_aligned(pv.numpy(), np.asarray(jv)), jv, "basis")
    # the alignment itself, on the same (aligned) bases
    rng = np.random.default_rng(10)
    a = rng.normal(size=(3, 4, 5)).astype(np.float32)
    b = np.array(jv)
    _close(pzoo._kdsvd_align(torch.from_numpy(a), torch.from_numpy(b)),
           jzoo._kdsvd_align(jnp.asarray(a), jnp.asarray(b)), "align")


def test_kdsvd_loss_matches_jax_where_teacher_signs_agree():
    shapes = ((3, 6, 6, 4), (3, 6, 6, 5), (3, 6, 6, 6))
    for seed in range(20):
        s, t = _maps(seed, shapes)
        agree = all(
            np.array_equal(
                np.sign(np.asarray(jzoo._kdsvd_basis(jnp.asarray(x), 1)[0])),
                np.sign(pzoo._kdsvd_basis(torch.from_numpy(_nchw(x)), 1)[0]
                        .numpy()))
            for x in t)
        if agree:
            break
    else:
        pytest.fail("no seed of 20 gave equal teacher basis signs")
    _check(jzoo.kdsvd_loss, pzoo.kdsvd_loss, s, t, nchw=True)
