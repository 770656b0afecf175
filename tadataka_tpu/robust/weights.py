"""Robust M-estimator weights for direct VO.

Parity surface: /root/reference/tadataka/robust/weights.py (student-t nu=5
with iterative variance, Tukey beta=4.6851 on MAD-scaled residuals, Huber
k=1.345 — Kerl ICRA'13).

Design: every function takes an optional validity mask instead of the
reference's boolean compaction; masked lanes get weight 0 and never influence
the statistics.  The data-dependent iteration count of the student-t variance
fit becomes a fixed ``lax.fori_loop``.
"""

import jax
import jax.numpy as jnp


def _masked_median(x, mask):
    """Median over lanes where mask is True (static shape, sort-based)."""
    n_valid = jnp.sum(mask)
    big = jnp.asarray(jnp.inf, dtype=x.dtype)
    vals = jnp.sort(jnp.where(mask, x, big))
    # median of the first n_valid entries
    hi = jnp.clip((n_valid) // 2, 0, x.shape[0] - 1)
    lo = jnp.clip((n_valid - 1) // 2, 0, x.shape[0] - 1)
    return 0.5 * (vals[lo] + vals[hi])


def median_absolute_deviation(x, mask=None):
    if mask is None:
        mask = jnp.ones(x.shape, dtype=bool)
    med = _masked_median(x, mask)
    return _masked_median(jnp.abs(x - med), mask)


def compute_weights_student_t(r, nu=5, n_iter=10, mask=None):
    if mask is None:
        mask = jnp.ones(r.shape, dtype=bool)
    s = r * r
    n_valid = jnp.maximum(jnp.sum(mask), 1)

    def weights(variance):
        return (nu + 1) / (nu + s / variance)

    def body(_, variance):
        w = weights(variance)
        return jnp.sum(jnp.where(mask, s * w, 0.0)) / n_valid

    variance = jax.lax.fori_loop(0, n_iter, body, jnp.asarray(1.0, r.dtype))
    return jnp.where(mask, jnp.sqrt(weights(variance)), 0.0)


def tukey(x, beta):
    inside = jnp.abs(x) <= beta
    u = x / beta
    w = (1.0 - u * u) ** 2
    return jnp.where(inside, w, 0.0)


def compute_weights_tukey(r, beta=4.6851, c=1.4826, mask=None):
    if mask is None:
        mask = jnp.ones(r.shape, dtype=bool)
    sigma_mad = c * median_absolute_deviation(r, mask)
    w = tukey(r / jnp.maximum(sigma_mad, 1e-12), beta)
    return jnp.where(mask, w, 0.0)


def compute_weights_huber(r, k=1.345, mask=None):
    if mask is None:
        mask = jnp.ones(r.shape, dtype=bool)
    abs_r = jnp.abs(r)
    w = jnp.where(abs_r > k, k / jnp.maximum(abs_r, 1e-12), 1.0)
    return jnp.where(mask, w, 0.0)
