"""One-class-SVM loss weighting (an AEKD alternative), without scikit-learn.

Port of ``multimodal_learning_tpu/gradweight/svm.py`` (reference
``MIA 2022/CL_utils/optimization.py:16-57``): stack the per-loss gradient
vectors, optionally normalise them, fit a one-class SVM on their Gram
matrix, and turn its dual coefficients into per-loss weights.

The JAX module fits scikit-learn's ``OneClassSVM(kernel="precomputed")``.
The port solves the same dual, libsvm's one-class scaling::

    minimise  1/2 a^T G a   subject to  0 <= a_i <= 1,  sum_i a_i = nu m,

so that the weights are ``a / (m nu)``.  Here m is the number of losses (at
most 5: four KD losses and the CE), so the solver enumerates active sets
exactly: every assignment of each a_i to its lower bound, its upper bound
or the free set (3^m <= 243 cases), and for each the KKT system of the
free variables and the equality's multiplier.  A case whose system is
singular is skipped (an optimum is always reached by one that is not:
along a null direction the objective is constant and some a_i reaches a
bound); a case whose solution is feasible and meets the sign conditions
of the bound multipliers is a global optimum of this convex problem.  The
cases run in a fixed order and the first optimum found with the least
objective is kept, so the answer is deterministic.  Where G is singular the
minimiser need not be unique, but the objective and ``sum_i a_i v_i`` are.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch

_TOL = 1e-9


def _one_class_dual(G: np.ndarray, total: float) -> np.ndarray:
    """The minimiser of ``1/2 a^T G a`` over ``0 <= a <= 1``,
    ``sum(a) = total`` by exact active-set enumeration (module docstring).
    Every case with a free variable is one (m + 1)-square system, solved
    in one batch: a fixed a_i has the row ``a_i = 0`` or ``1``, a free one
    ``(G a)_i - lambda = 0``, and the last row is the equality."""
    m = G.shape[0]
    tol = _TOL * max(float(np.abs(G).max()), 1e-300)
    kinds = np.array(list(itertools.product((0, 1, 2), repeat=m)))
    low, up, free = kinds == 0, kinds == 1, kinds == 2   # [N, m]
    eye = np.eye(m)
    A = np.zeros((len(kinds), m + 1, m + 1))
    A[:, :m, :m] = np.where(free[:, :, None], G[None], eye[None])
    A[:, :m, m] = -free.astype(np.float64)
    A[:, m, :m] = 1.0
    rhs = np.concatenate([up, np.full((len(kinds), 1), total)], axis=1)
    # a case with no free variable is singular (lambda is in no row): its
    # a is fixed, and lambda need only lie between the bounds' gradients
    s = np.linalg.svd(A, compute_uv=False)
    solvable = s[:, -1] > s[:, :1].max(axis=1) * (m + 1) * np.finfo(
        np.float64).eps
    a = up.astype(np.float64)
    lam_lo = np.full(len(kinds), -np.inf)
    lam_hi = np.full(len(kinds), np.inf)
    sol = np.linalg.solve(A[solvable], rhs[solvable][..., None])[..., 0]
    a[solvable] = sol[:, :m]
    lam_lo[solvable] = lam_hi[solvable] = sol[:, m]
    g = a @ G                                           # G is symmetric
    lam_lo = np.maximum(lam_lo, np.where(up, g, -np.inf).max(axis=1) - tol)
    lam_hi = np.minimum(lam_hi, np.where(low, g, np.inf).min(axis=1) + tol)
    ok = ((solvable | (np.abs(up.sum(axis=1) - total) <= 1e-12 * max(
        total, 1.0))) & (lam_lo <= lam_hi)
          & ~(free & ((a < -_TOL) | (a > 1 + _TOL))).any(axis=1))
    if not ok.any():
        raise RuntimeError("one-class SVM dual: no KKT point found")
    a = np.clip(a[ok], 0.0, 1.0)
    obj = 0.5 * np.einsum("ni,ij,nj->n", a, G, a)
    return a[np.flatnonzero(obj <= obj.min() + tol)[0]]


def find_optimal_svm(vecs: np.ndarray, nu: float = -1,
                     is_norm: bool = True) -> np.ndarray:
    """``vecs``: [m, B, D] per-loss per-sample gradients (or [m, D]).
    Returns the per-loss weights [m], float32.  ``nu`` -1 means 1/m; it is
    clipped to [1/m, 1].  With ``is_norm`` the gradient means are
    normalised before the Gram, and the weights divided by their norms and
    renormalised to sum 1 (JAX ``gradweight/svm.py:15-39``)."""
    vecs = np.asarray(vecs, dtype=np.float64)
    m = vecs.shape[0]
    vec_mean = vecs.reshape(m, -1) if vecs.ndim == 2 else \
        vecs.reshape(m, vecs.shape[1], -1).mean(axis=1)
    vec_norm = np.linalg.norm(vec_mean, axis=1, keepdims=True)
    if is_norm:
        vec_mean = vec_mean / np.maximum(vec_norm, 1e-12)
    G = vec_mean @ vec_mean.T
    if nu == -1:
        nu = 1.0 / m
    nu = float(np.clip(nu, 1.0 / m, 1.0))
    ret = _one_class_dual(G, nu * m) / (m * nu)
    if is_norm:
        ret = ret / np.maximum(vec_norm.reshape(-1), 1e-12)
        ret = ret / max(ret.sum(), 1e-12)
    return ret.astype(np.float32)


def svm_weights(grads: Sequence[torch.Tensor], nu: float = 0.5,
                is_norm: bool = False) -> torch.Tensor:
    """The student step's ``--loss_weighting SVM``: the per-loss feature
    gradients (each [B, D], on the device) stacked and copied to the host
    in one transfer, which is the one host synchronisation of this
    weighting (the JAX step takes them through ``pure_callback``); the
    weights go back to the gradients' device without blocking."""
    dev = grads[0].device
    host = torch.stack([g.float() for g in grads]).cpu().numpy()
    w = torch.from_numpy(find_optimal_svm(host, nu=nu, is_norm=is_norm))
    if dev.type == "cuda":
        w = w.pin_memory()
    return w.to(dev, non_blocking=True)
