"""Legendre basis machinery.

Replaces the reference's compile-time tables and scalar recurrences with
vectorized JAX ops and numerically generated Gauss-Legendre rules:

  * ``Include/HP/Legendre.h`` (4,173 lines of 300-digit literals) ->
    ``numpy.polynomial.legendre.leggauss`` at import time.
  * ``Include/HP/Utility.h:63-78``   NormalisedLengths   -> ``norm_table()``
  * ``Include/HP/Utility.h:87-106``  LegendreCoeffientCount -> ``consts.coeff_count``
  * ``Include/HP/Utility.h:133-160`` BasisIndexValues    -> ``basis_indices()``
  * ``Source/HP/Octree.cpp:988-1004`` LpX recurrence     -> ``legendre_all()``

All tables are cached host-side as numpy arrays; jitted code closes over them
as constants so XLA folds them into the compiled program.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from .consts import BASIS_MAX_DEGREE, TREE_MAX_DEPTH, coeff_count


# --------------------------------------------------------------------------
# Host-side tables (numpy, f64)
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def leggauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes and weights of the ``n``-point rule on [-1, 1].

    The reference stores rules for n = 1..64 as flattened literal arrays
    (Include/HP/Legendre.h:7,2091); we generate them numerically.
    """
    x, w = np.polynomial.legendre.leggauss(n)
    return x.astype(np.float64), w.astype(np.float64)


def fit_rule_size(degree: int) -> int:
    """Quadrature points per axis used when fitting a degree-``degree`` basis.

    The reference selects the (4d+1)-point rule via SumToN[4d]..SumToN[4d+1]
    (Source/HP/Octree.cpp:1016-1017).
    """
    return 4 * degree + 1


def face_rule_size(max_degree: int) -> int:
    """Rule used for the cross-depth shared-face integral.

    (reference: Source/HP/Octree.cpp:1270-1272 -- the (maxDegree+1)-point rule)
    """
    return max_degree + 1


@functools.lru_cache(maxsize=None)
def basis_indices(degree: int) -> np.ndarray:
    """(C, 3) int32 array of basis exponent triples, ordered exactly as the
    reference's BasisIndexValues (Include/HP/Utility.h:133-160): grouped by
    total degree p ascending, then lexicographic in (i, j, k)."""
    out = []
    for p in range(degree + 1):
        for i in range(p + 1):
            for j in range(p - i + 1):
                k = p - i - j
                out.append((i, j, k))
    arr = np.asarray(out, dtype=np.int32)
    assert arr.shape[0] == coeff_count(degree)
    return arr


@functools.lru_cache(maxsize=None)
def norm_table() -> np.ndarray:
    """norm[p, depth] = sqrt((2p+1) * 2**depth).

    Per-axis normalizer of the scaled Legendre basis on a depth-``depth``
    octree cell (reference: Include/HP/Utility.h:63-78).
    """
    p = np.arange(BASIS_MAX_DEGREE + 1, dtype=np.float64)[:, None]
    d = np.arange(TREE_MAX_DEPTH + 1, dtype=np.float64)[None, :]
    return np.sqrt((2.0 * p + 1.0) * np.exp2(d))


@functools.lru_cache(maxsize=None)
def coeff_norms(degree: int) -> np.ndarray:
    """(TREE_MAX_DEPTH+1, C) table: product over axes of norm_table for each
    basis triple, per depth. Folded into coefficients at evaluation time."""
    idx = basis_indices(degree)                      # (C, 3)
    nt = norm_table()                                # (P+1, D+1)
    return nt[idx[:, 0], :].T * nt[idx[:, 1], :].T * nt[idx[:, 2], :].T


# --------------------------------------------------------------------------
# Device-side evaluation
# --------------------------------------------------------------------------

def legendre_all(x: jax.Array, degree: int) -> jax.Array:
    """Evaluate L_0..L_degree at ``x`` via the three-term recurrence.

    x: any shape; returns shape x.shape + (degree+1,).
    Recurrence constants (2p-1)/p, (p-1)/p as in the reference's
    LegendreCoefficent table (Include/HP/Utility.h:112-127), but the static
    unrolled loop lets XLA fuse the whole chain into one elementwise kernel.
    """
    ones = jnp.ones_like(x)
    vals = [ones]
    if degree >= 1:
        vals.append(x)
    for p in range(2, degree + 1):
        vals.append(((2.0 * p - 1.0) / p) * x * vals[p - 1]
                    - ((p - 1.0) / p) * vals[p - 2])
    return jnp.stack(vals, axis=-1)


def legendre_all_with_derivative(x: jax.Array, degree: int):
    """L_p(x) and L'_p(x) for p = 0..degree.

    Uses the stable derivative recurrence L'_p = L'_{p-2} + (2p-1) L_{p-1};
    replaces the reference's central-difference scheme
    (Source/HP/Octree.cpp:904-985) with exact analytic derivatives.
    """
    L = legendre_all(x, degree)
    zeros = jnp.zeros_like(x)
    dvals = [zeros]
    if degree >= 1:
        dvals.append(jnp.ones_like(x))
    for p in range(2, degree + 1):
        dvals.append(dvals[p - 2] + (2.0 * p - 1.0) * L[..., p - 1])
    return L, jnp.stack(dvals, axis=-1)


def eval_basis(coeffs: jax.Array, unit_pt: jax.Array, depth: jax.Array,
               degree: int) -> jax.Array:
    """Evaluate a batch of node bases at local unit-cube points.

    coeffs : (..., C) padded coefficient rows (C = coeff_count(degree))
    unit_pt: (..., 3) points in the node's [-1, 1]^3 local frame
    depth  : (...,) int32 node depths (for the normalizer lookup)
    Returns (...,) f values.

    Vectorized equivalent of FApprox (Source/HP/Octree.cpp:859-901).
    """
    idx = basis_indices(degree)                                  # (C, 3)
    L = legendre_all(unit_pt, degree)                            # (..., 3, P+1)
    # per-axis gather of the recurrence values for each basis triple
    Lx = L[..., 0, idx[:, 0]]
    Ly = L[..., 1, idx[:, 1]]
    Lz = L[..., 2, idx[:, 2]]
    norms = jnp.asarray(coeff_norms(degree), dtype=coeffs.dtype)  # (D+1, C)
    n = norms[depth]                                             # (..., C)
    return jnp.sum(coeffs * Lx * Ly * Lz * n, axis=-1)


def eval_basis_grad(coeffs: jax.Array, unit_pt: jax.Array, depth: jax.Array,
                    degree: int):
    """Value and *local-frame* gradient of the node basis.

    The gradient is w.r.t. unit_pt; callers rescale by 2**(depth+1) to get the
    world-space gradient. Replaces FApproxWithGradient's central differences
    (Source/HP/Octree.cpp:904-985) with analytic derivatives.
    Returns (value, grad[..., 3]).
    """
    idx = basis_indices(degree)
    L, dL = legendre_all_with_derivative(unit_pt, degree)        # (..., 3, P+1)
    Lx, Ly, Lz = (L[..., a, idx[:, a]] for a in range(3))
    dLx, dLy, dLz = (dL[..., a, idx[:, a]] for a in range(3))
    norms = jnp.asarray(coeff_norms(degree), dtype=coeffs.dtype)
    cn = coeffs * norms[depth]                                   # (..., C)
    val = jnp.sum(cn * Lx * Ly * Lz, axis=-1)
    gx = jnp.sum(cn * dLx * Ly * Lz, axis=-1)
    gy = jnp.sum(cn * Lx * dLy * Lz, axis=-1)
    gz = jnp.sum(cn * Lx * Ly * dLz, axis=-1)
    return val, jnp.stack([gx, gy, gz], axis=-1)


@functools.lru_cache(maxsize=None)
def quadrature_matrix(degree: int) -> np.ndarray:
    """A[p, q] = w_q * L_p(x_q) for the fit rule of ``degree``.

    Contracting F samples against A along each axis performs the separable
    Gauss-Legendre projection (the tensor-product loop of FitPolynomial,
    Source/HP/Octree.cpp:1028-1056) as three small matmuls -- the batched
    formulation of hot loop #1.
    Shape (degree+1, Q) with Q = 4*degree+1.
    """
    x, w = leggauss(fit_rule_size(degree))
    Lv = np.ones((degree + 1, x.size), dtype=np.float64)
    if degree >= 1:
        Lv[1] = x
    for p in range(2, degree + 1):
        Lv[p] = ((2 * p - 1) / p) * x * Lv[p - 1] - ((p - 1) / p) * Lv[p - 2]
    return Lv * w[None, :]


def legendre_all_np(x: np.ndarray, degree: int) -> np.ndarray:
    """Host-side L_0..L_degree evaluation; returns shape (degree+1,) + x.shape."""
    x = np.asarray(x, dtype=np.float64)
    out = np.ones((degree + 1,) + x.shape, dtype=np.float64)
    if degree >= 1:
        out[1] = x
    for p in range(2, degree + 1):
        out[p] = ((2 * p - 1) / p) * x * out[p - 1] - ((p - 1) / p) * out[p - 2]
    return out
