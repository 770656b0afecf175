"""Small dense linear solvers used across the VO pipelines.

Parity surface: /root/reference/tadataka/math.py (weighted lstsq / CG).
The 6x6 normal-equation solve is one (N, 6)^T @ (N, 6) matrix product
followed by a tiny Cholesky.
"""

import jax.numpy as jnp


def weighted_mean(x, w):
    return jnp.sum(x * w) / jnp.sum(w)


def solve_linear_equation(J, r, weights=None, damping=0.0):
    """argmin_x ||sqrt(W) (J x - r)||^2 via normal equations.

    J: (N, d), r: (N,), weights: (N,) or None.  ``damping`` adds
    damping * I for Levenberg-style regularization.  Rows can be masked by
    zero weights — the static-shape replacement for boolean indexing.
    """
    if weights is not None:
        Jw = J * weights[:, None]
    else:
        Jw = J
    JtJ = Jw.T @ J
    Jtr = Jw.T @ r
    d = J.shape[1]
    JtJ = JtJ + damping * jnp.eye(d, dtype=J.dtype)
    return jnp.linalg.solve(JtJ, Jtr)


def solve_lstsq(A, b):
    """Dense least squares (SVD-based), matching np.linalg.lstsq behavior."""
    return jnp.linalg.lstsq(A, b)[0]


def solve_nullspace(A):
    """x minimizing ||Ax|| with ||x|| = 1 (smallest right singular vector).

    Parity: solve_linear (/root/reference/tadataka/matrix.py:95-101).
    """
    _, _, vh = jnp.linalg.svd(A)
    return vh[..., -1, :]
