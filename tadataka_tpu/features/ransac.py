"""Vmapped fixed-trial RANSAC: fundamental matrix and affine transform.

Parity surface: skimage's ``ransac`` as used by the reference
(/root/reference/tadataka/feature/feature.py:79-94: FundamentalMatrixTransform
min_samples=8, AffineTransform, residual_threshold=1, max_trials=100).

Design: all trials run in parallel under vmap — each trial samples its
minimal set, fits the model (batched SVD / solve), scores every candidate
with a masked residual, and a single argmax picks the consensus winner.  No
data-dependent trial loop, no early exit.
"""

from functools import partial

import jax
import jax.numpy as jnp

from tadataka_tpu.core.solvers import solve_nullspace
from tadataka_tpu.core.transforms import to_homogeneous

DEFAULT_TRIALS = 128


def _sample_valid_indices(key, mask, n_trials, n_samples):
    """(n_trials, n_samples) indices drawn from valid (mask) positions.

    Valid positions are compacted to the front by sorting the mask, then
    uniform floats index into the valid prefix — static shapes throughout.
    """
    order = jnp.argsort(jnp.logical_not(mask))  # valid first
    n_valid = jnp.maximum(jnp.sum(mask), 1)
    r = jax.random.uniform(key, (n_trials, n_samples))
    idx = jnp.floor(r * n_valid).astype(jnp.int32)
    return order[idx]


def _normalize_points(points):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    mean = jnp.mean(points, axis=0)
    centered = points - mean
    scale = jnp.sqrt(2.0) / (jnp.mean(jnp.linalg.norm(centered, axis=1))
                             + 1e-12)
    T = jnp.array([[scale, 0.0, -scale * mean[0]],
                   [0.0, scale, -scale * mean[1]],
                   [0.0, 0.0, 1.0]])
    return centered * scale, T


def _eight_point(kp1, kp2):
    """Normalized 8-point fundamental matrix from (8, 2) + (8, 2)."""
    x1, T1 = _normalize_points(kp1)
    x2, T2 = _normalize_points(kp2)
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    ones = jnp.ones_like(u1)
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                   u1, v1, ones], axis=-1)
    f = solve_nullspace(A)
    F = f.reshape(3, 3)
    # enforce rank 2
    U, s, Vt = jnp.linalg.svd(F)
    F = (U * s.at[2].set(0.0)[None, :]) @ Vt
    F = T2.T @ F @ T1
    return F / (F[2, 2] + jnp.where(jnp.abs(F[2, 2]) < 1e-12, 1e-12, 0.0))


def sampson_distance(F, kp1, kp2):
    """Per-match Sampson distance for fundamental matrix F."""
    x1 = to_homogeneous(kp1)          # (N, 3)
    x2 = to_homogeneous(kp2)
    Fx1 = x1 @ F.T                    # (N, 3) = (F @ x1^T)^T
    Ftx2 = x2 @ F                     # (N, 3) = (F^T @ x2^T)^T
    num = jnp.sum(x2 * Fx1, axis=-1) ** 2
    den = (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2
           + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)
    return num / (den + 1e-12)


@partial(jax.jit, static_argnames=("n_trials",))
def ransac_fundamental(kp1, kp2, mask, key,
                       residual_threshold=1.0, n_trials=DEFAULT_TRIALS):
    """Returns (F_best, inlier_mask).  Residual = sqrt(Sampson) like
    skimage's FundamentalMatrixTransform residuals."""
    samples = _sample_valid_indices(key, mask, n_trials, 8)

    def trial(sample_idx):
        F = _eight_point(kp1[sample_idx], kp2[sample_idx])
        d = jnp.sqrt(sampson_distance(F, kp1, kp2))
        inliers = mask & (d < residual_threshold)
        return F, jnp.sum(inliers)

    Fs, counts = jax.vmap(trial)(samples)
    best = jnp.argmax(counts)
    F_best = Fs[best]
    d = jnp.sqrt(sampson_distance(F_best, kp1, kp2))
    return F_best, mask & (d < residual_threshold)


def _fit_affine(kp1, kp2):
    """Exact affine from 3 correspondences: solve two 3x3 systems."""
    A = to_homogeneous(kp1)           # (3, 3) rows [x, y, 1]
    px = jnp.linalg.solve(A, kp2[:, 0])
    py = jnp.linalg.solve(A, kp2[:, 1])
    M = jnp.eye(3).at[0].set(px).at[1].set(py)
    return M


@partial(jax.jit, static_argnames=("n_trials",))
def ransac_affine(kp1, kp2, mask, key,
                  residual_threshold=1.0, n_trials=DEFAULT_TRIALS):
    """Returns (affine_matrix, inlier_mask)."""
    samples = _sample_valid_indices(key, mask, n_trials, 3)

    def trial(sample_idx):
        M = _fit_affine(kp1[sample_idx], kp2[sample_idx])
        pred = to_homogeneous(kp1) @ M.T
        d = jnp.linalg.norm(pred[:, :2] - kp2, axis=-1)
        inliers = mask & (d < residual_threshold)
        return M, jnp.sum(inliers)

    Ms, counts = jax.vmap(trial)(samples)
    best = jnp.argmax(counts)
    M_best = Ms[best]
    pred = to_homogeneous(kp1) @ M_best.T
    d = jnp.linalg.norm(pred[:, :2] - kp2, axis=-1)
    return M_best, mask & (d < residual_threshold)
