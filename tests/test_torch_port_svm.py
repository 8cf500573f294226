"""The port's one-class-SVM weighting (``gradweight/svm.py``, a numpy
solver of the one-class dual) against the JAX package's, which calls
scikit-learn's ``OneClassSVM``.

Well-conditioned gradient stacks, m = 2..5 losses, ``is_norm`` both ways:
the weights at rtol 1e-4 / atol 1e-5 (scikit-learn's SMO stops at its
tolerance of 1e-6).  That tolerance is absolute: on a Gram of 1e-6 scale
(unnormalised feature gradients, ``is_norm`` off) scikit-learn stops
early, some percent from the minimiser.  The minimiser does not depend on
the Gram's scale, so on a small stack the port is held against
scikit-learn on the same stack scaled to unit size, and its objective
must not exceed scikit-learn's own.  On a rank-deficient stack (fewer
feature dimensions than losses) the minimiser is not unique, so there the
objective and the combination ``sum_i a_i v_i`` are compared, which are.

Then two student steps with ``--loss_weighting SVM --svm_norm True`` as
``tests/test_torch_port_student.py`` runs its configurations (with
``--svm_norm False`` the JAX step's weights carry scikit-learn's early
stop on the feature gradients' small Gram, above).
"""
import numpy as np
import pytest
import torch
import test_torch_port_student as student_tests
from test_torch_port_student import (AEKD, DIMS, STUDENT_CONFIGS,
                                     interpret_pallas,  # noqa: F401
                                     no_onednn_convs)  # noqa: F401

from multimodal_learning_tpu.gradweight.svm import find_optimal_svm as j_svm
from multimodal_learning_tpu_torch.gradweight import (find_optimal_svm,
                                                      svm_weights)
from multimodal_learning_tpu_torch.gradweight.svm import _one_class_dual


def _stack(seed, m, d=12, b=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(m, b, d)).astype(np.float32)


@pytest.mark.parametrize("is_norm", [True, False])
@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_find_optimal_svm_matches_scikit_learn(m, is_norm):
    for nu in (0.5, -1):
        vecs = _stack(10 * m + is_norm, m)
        got = find_optimal_svm(vecs, nu=nu, is_norm=is_norm)
        want = j_svm(vecs, nu=nu, is_norm=is_norm)
        assert got.dtype == np.float32 and got.shape == (m,)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"nu {nu}")
        assert (got >= 0).all()
        if is_norm:
            np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-6)


def test_find_optimal_svm_on_a_small_gram():
    vecs = _stack(5, 5) * 1e-3
    got = find_optimal_svm(vecs, nu=0.5, is_norm=False)
    np.testing.assert_allclose(
        got, j_svm(vecs * 1e3, nu=0.5, is_norm=False), rtol=1e-4, atol=1e-5)
    means = vecs.astype(np.float64).mean(axis=1)
    G = means @ means.T
    raw = j_svm(vecs, nu=0.5, is_norm=False)
    assert got @ G @ got <= raw @ G @ raw * (1 + 1e-9)


def test_find_optimal_svm_on_a_rank_deficient_stack():
    """Five losses in two dimensions, away from the origin: the objective
    and the combination of the gradient means agree with scikit-learn's,
    the weights need not."""
    vecs = _stack(3, 5, d=2, b=4).astype(np.float64) + [2.0, 0.5]
    means = vecs.mean(axis=1)
    got = find_optimal_svm(vecs, nu=0.5, is_norm=False)
    want = j_svm(vecs, nu=0.5, is_norm=False)
    G = means @ means.T
    np.testing.assert_allclose(got @ G @ got, want @ G @ want, rtol=1e-4)
    np.testing.assert_allclose(got @ means, want @ means, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.sum(), 1.0, rtol=1e-6)   # sum a = nu m


def test_one_class_dual_is_deterministic_and_feasible():
    rng = np.random.default_rng(8)
    v = rng.normal(size=(4, 2))
    G = v @ v.T
    a = _one_class_dual(G, 2.0)
    assert np.array_equal(a, _one_class_dual(G.copy(), 2.0))
    assert (a >= 0).all() and (a <= 1).all()
    np.testing.assert_allclose(a.sum(), 2.0, rtol=1e-12)


def test_svm_weights_of_feature_gradients():
    grads = [torch.from_numpy(g) for g in _stack(4, 3)]
    w = svm_weights(grads, nu=0.5, is_norm=True)
    assert w.dtype == torch.float32 and w.device == grads[0].device
    np.testing.assert_array_equal(
        w.numpy(), find_optimal_svm(np.stack([g.numpy() for g in grads]),
                                    nu=0.5, is_norm=True))


def test_svm_weighted_student_steps_match_jax(interpret_pallas,
                                              no_onednn_convs, monkeypatch):
    name = "SVM"
    monkeypatch.setitem(STUDENT_CONFIGS, name,
                        dict(AEKD, loss_weighting="SVM", svm_norm=True))
    assert DIMS["distill"] == "crd"   # four KD losses and the CE: m = 5
    student_tests.test_student_steps_match_jax(name, None, None, monkeypatch)
